"""Multi-head latent attention (``models/mla.py``), the chunked
(flash-style) attention cores and ``layer_norm`` of the port against the
reference, and reduced deepseek-v2-236b (2 layers, d_model 64, MLA
kv_lora 32 / q_lora 32 / rope 8, 8 experts top-2 and a shared expert)
through the decoder.  Parameters are the reference's (norm gains
randomised), carried across with ``lm_params_from_numpy``; inputs come
from numpy generators with the seeds stated.

What is held, and how closely:
  * ``mla_attention`` cacheless, as a cached prefill into a longer cache
    and as one decode step: under ``f32`` within ``F32_RTOL`` of the
    largest |y|; under the int8 ``lut`` policy within ``QUANT_RTOL``,
    and every quantized projection bit for bit at layer level (the
    reference's input of each call site through the jitted reference
    and the port), ``wuk``/``wuv`` of a cached call over the WHOLE
    cache, zero rows included;
  * ``_mla_core_chunked`` and ``_chunked_grouped_attention`` with a
    ``kv_chunk`` that does not divide T and ``q_pos0 > 0``: 1e-6 of the
    largest |y|; ``layer_norm``: 1e-6 relative;
  * ``forward_prefill`` then two ``forward_decode`` steps, vanilla and
    chunked: ``F32_RTOL`` / ``QUANT_RTOL`` of the largest |logit|; the
    decode runs at the cache's position (``decoder._cache_pos``);
  * the parameter tree and ``probe_layer_tags`` on ``meta``,
    ``layer_mult_counts`` and ``ModuleMap.for_config(validate=True)``
    equal the reference's; the banked module sweep equals the
    sequential one bit for bit under ``pallas`` and ``fused`` with
    ``banked_calls_per_forward`` = 2 x (8 + 3 + 3) = 28 calls (the
    routed experts' 3 projections one call each, all 8 experts at once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.models import common as ref_common
from repro.models import mla as ref_mla
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.models import common, decoder, mla
from repro_torch.models.weights import lm_params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_parity import (F32_RTOL, QUANT_RTOL, cfgs,
                               check_banked_sweep,
                               check_counts_and_module_map,
                               check_prefill_decode, check_trees_and_probe,
                               make_libs, policies, ref_params)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "deepseek-v2-236b"
B, S, T = 2, 5, 9


@pytest.fixture(scope="module")
def libs():
    return make_libs()


def _group0(tree):
    return jax.tree.map(lambda a: a[0], tree)


class _RefRecorder(RefPolicy):
    """The reference's policy, recording each call site's input."""
    def matmul(self, name, x, w, **kw):
        self.seen.append((name, np.asarray(x)))
        return super().matmul(name, x, w, **kw)


class _Recorder(ApproxPolicy):
    def matmul(self, name, x, w, lanes=False):
        self.seen.append((name, x.clone()))
        return super().matmul(name, x, w, lanes)


def _recorders(rpol, ppol):
    r = _RefRecorder(default=rpol.default, overrides=rpol.overrides)
    p = _Recorder(default=ppol.default, overrides=ppol.overrides)
    r.seen, p.seen = [], []
    return r, p


@pytest.mark.parametrize("mode", ["f32", "lut"])
def test_mla_attention_matches_reference(mode, libs):
    ref_cfg, cfg = cfgs(ARCH)
    rp = _group0(ref_params(ref_cfg)["blocks"]["mixer_0"])
    pp = lm_params_from_numpy(rp)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    rpol, ppol = _recorders(*policies(mode, libs))
    rtol = F32_RTOL if mode == "f32" else QUANT_RTOL

    def ref_call(h, pos, cache):     # eager, so the recorder sees values
        return ref_mla.mla_attention(rp, jnp.asarray(h), ref_cfg, rpol,
                                     positions=jnp.asarray(pos),
                                     cache=cache)

    def port_call(h, pos, cache):
        with torch.inference_mode():
            return mla.mla_attention(pp, torch.from_numpy(h), cfg, ppol,
                                     positions=torch.from_numpy(pos),
                                     cache=cache)

    steps = [(x, np.arange(S), None)]
    want, _ = ref_call(*steps[0])
    got, none = port_call(*steps[0])
    assert none is None
    outs = [(got, want)]
    # a cached prefill of S positions into T rows, then one decode step
    rcache = ref_mla.init_mla_cache(ref_cfg, B, T)
    pcache = mla.init_mla_cache(cfg, B, T)
    for h, pos in ((x, np.arange(S)), (x1, np.full((1,), S))):
        want, rcache = ref_call(h, pos, rcache)
        got, pcache = port_call(h, pos, pcache)
        outs.append((got, want))
    assert pcache["pos"] == int(rcache["pos"]) == S + 1
    for g, w in outs + [(pcache["ckv"], rcache["ckv"]),
                        (pcache["kr"], rcache["kr"])]:
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())
    # the call sites, in order, at the reference's shapes: the cached
    # calls expand the whole T-row cache, rows past the written ones 0
    names = ["wdq", "wuq", "wqr", "wdkv", "wkr", "wuk", "wuv", "wo"]
    assert [n for n, _ in ppol.seen] == [n for n, _ in rpol.seen] == [
        f"mla.{n}" for n in names] * 3
    for i, ((name, gx), (_n, wx)) in enumerate(zip(ppol.seen, rpol.seen)):
        assert tuple(gx.shape) == wx.shape, name
        if name in ("mla.wuk", "mla.wuv") and i >= len(names):
            filled = S if i < 2 * len(names) else S + 1
            assert wx.shape[1] == T
            assert not gx[:, filled:].any() and not wx[:, filled:].any()
    if mode == "lut":   # each call site's datapath bit for bit
        for name, wx in rpol.seen:
            w = rp[name.split(".")[1]]
            ref_y = jax.jit(lambda a, b, n=name: policies(mode, libs)[0]
                            .matmul(n, a, b))(jnp.asarray(wx),
                                              jnp.asarray(w))
            with torch.inference_mode():
                y = ppol.matmul(name, torch.from_numpy(np.array(wx)),
                                torch.from_numpy(np.array(w)))
            assert torch.equal(y, torch.from_numpy(np.array(ref_y))), name


@pytest.mark.parametrize("s, t, q_pos0, t_valid, chunk",
                         [(7, 7, 0, 7, 3), (3, 11, 5, 8, 4)])
def test_chunked_cores_match_reference(s, t, q_pos0, t_valid, chunk):
    rng = np.random.default_rng(12)
    h, hk, d = 4, 2, 16
    q = rng.normal(size=(B, s, h, d)).astype(np.float32)
    k = rng.normal(size=(B, t, hk, d)).astype(np.float32)
    v = rng.normal(size=(B, t, hk, d)).astype(np.float32)
    want = jax.jit(lambda a, b, c: ref_common._chunked_grouped_attention(
        a, b, c, jnp.int32(q_pos0), jnp.int32(t_valid), chunk))(q, k, v)
    got = common._chunked_grouped_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos0, t_valid, chunk)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the MLA core: per-head nope keys, one shared rope key
    ref_cfg, cfg = cfgs(ARCH, kv_chunk=chunk)
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_n = rng.normal(size=(B, s, h, dn)).astype(np.float32)
    q_r = rng.normal(size=(B, s, h, dr)).astype(np.float32)
    k_n = rng.normal(size=(B, t, h, dn)).astype(np.float32)
    k_r = rng.normal(size=(B, t, dr)).astype(np.float32)
    vv = rng.normal(size=(B, t, h, dv)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: ref_mla._mla_core_chunked(
        *a, jnp.int32(q_pos0), jnp.int32(t_valid), ref_cfg))(
            q_n, q_r, k_n, k_r, vv))
    got = mla._mla_core_chunked(
        *(torch.from_numpy(a) for a in (q_n, q_r, k_n, k_r, vv)),
        q_pos0, t_valid, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(13)
    x = rng.normal(0.5, 2, (3, 5, 64)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    beta = rng.normal(0, 0.1, 64).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: ref_common.layer_norm(
        *a, 1e-6))(x, g, beta))
    got = common.layer_norm(*(torch.from_numpy(a) for a in (x, g, beta)),
                            1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl, modes", [("vanilla", ("f32", "int8")),
                                         ("chunked", ("f32",))])
def test_prefill_then_decode_matches_reference(impl, modes):
    kw = {} if impl == "vanilla" else {"attn_impl": "chunked",
                                       "kv_chunk": 3}
    ref_cfg, cfg = cfgs(ARCH, **kw)
    assert decoder.block_pattern(cfg) == [("mla", "moe")]
    cache = check_prefill_decode(ref_cfg, cfg, modes=modes)
    # two decode steps after 8 prompt tokens: MLA's rope ran at 8 and 9
    assert decoder._cache_pos(cache, cfg) == cache["mixer_0"]["pos"] == 10


def test_trees_and_probe_tags_match_reference():
    check_trees_and_probe(ARCH)


def test_counts_and_module_map_match_reference():
    check_counts_and_module_map(ARCH)


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_banked_module_sweep_bit_identity_and_calls(variant, libs):
    check_banked_sweep(ARCH, variant, libs[1], 2 * (8 + 3 + 3))
