"""The dense decoder LM of the port against the reference: ``rms_norm``,
RoPE and attention (with and without a KV cache), then prefill logits
and teacher-forced decode logits of whole models under the ``f32``,
``int8`` and ``lowrank`` (``ref`` and ``pallas``; on the CPU the
``pallas`` variant runs K9's plain version) policies.  Two f32 configs:
``qwen1.5-0.5b``'s ``reduced()`` (2 layers, d 64, vocab 512) and
``tests/test_serve.py``'s tiny dense config; the reference's
parameters (biases and norms randomised, so they matter) are carried
across with ``models.weights.lm_params_from_numpy``.

Tolerances (against the jitted reference, teacher-forced so the token
streams cannot diverge):
  * ``F32_RTOL`` = 1e-5 of the largest |logit| for the ``f32`` policy
    (float sums in another order; measured 1e-6).
  * ``QUANT_RTOL`` = 0.025 of the largest |logit| for the quantized
    policies.  Every quantized projection re-calibrates on its input,
    so a last-bit difference can move a code.  The reference's own
    eager and jitted runs agree to 2e-7 here (both use XLA's dot, in
    one summation order), so the spread it shows between two of its
    own correct orders comes from its two lowrank datapaths:
    ``lowrank`` against ``lowrank_pallas`` (interpret mode, rank 4,
    teacher-forced decode) differs by up to 0.0043 at logits up to
    0.53 (reduced, 0.8%) and 0.0042 at 0.34 (tiny, 1.2%).  The port
    against the jitted reference: up to 0.0022 at 0.53 (0.4%).  The
    tolerance is about twice the reference's own spread, relative, so
    that it also holds the full-width model on the card
    (``chip_smoke.py``), whose logits are larger.
  * ``BF16_ATOL`` = 0.04 for ``reduced(dtype=bfloat16)``: XLA keeps
    some bf16 intermediates in f32 inside its fusions, so the
    reference's own eager (``jax.disable_jit``) and jitted prefill
    logits differ by up to 0.019 under int8 and 0.0055 under f32; the
    port: 0.018 and 0.0055.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.configs import get_config as ref_get_config
from repro.core.library import build_default_library as ref_build
from repro.models import common as ref_common
from repro.models.common import LMConfig as RefLMConfig
from repro.models.registry import model_fns as ref_model_fns
from repro_torch.approx.layers import EXACT_POLICY, ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.configs import get_config
from repro_torch.launch.steps import pick_case_multiplier
from repro_torch.models import common, decoder
from repro_torch.models.common import LMConfig
from repro_torch.models.registry import (input_extras, model_fns,
                                         prompt_extra_len)
from repro_torch.models.weights import lm_params_from_numpy

F32_RTOL = 1e-5
QUANT_RTOL = 0.025
BF16_ATOL = 0.04
B, S, N = 4, 8, 6


def _tiny():
    kw = dict(name="tiny-dense", family="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
              remat=False, loss_chunk=16)
    return RefLMConfig(dtype=jnp.float32, **kw), LMConfig(
        dtype=torch.float32, **kw)


def _reduced(dtype="f32"):
    ref, port = (ref_get_config("qwen1.5-0.5b").reduced(),
                 get_config("qwen1.5-0.5b").reduced())
    if dtype == "bf16":
        ref = dataclasses.replace(ref, dtype=jnp.bfloat16)
        port = dataclasses.replace(port, dtype=torch.bfloat16)
    return ref, port


CONFIGS = {"reduced": _reduced, "tiny": _tiny}


def _params(ref_cfg):
    """The reference's parameters with random biases and norm gains."""
    params = jax.tree.map(np.asarray, ref_model_fns(ref_cfg).init_params(
        jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(5)
    blocks = params["blocks"]
    for key in ("bq", "bk", "bv"):
        if key in blocks["mixer_0"]:
            blocks["mixer_0"][key] = rng.normal(
                0, 0.1, blocks["mixer_0"][key].shape).astype(np.float32)
    for key in ("norm1_0", "norm2_0"):
        blocks[key] = rng.uniform(0.8, 1.2, blocks[key].shape).astype(
            np.float32)
    return params


@pytest.fixture(scope="module")
def lib():
    return ref_build("tiny")


def _specs(lib):
    mult = pick_case_multiplier(lib)
    return {
        "f32": (RefSpec(mode="f32"), BackendSpec(mode="f32")),
        "int8": (RefSpec(mode="int8"), BackendSpec(mode="int8")),
        "lowrank_ref": (RefSpec(mode="lowrank", multiplier=mult, rank=4),
                        BackendSpec(mode="lowrank", multiplier=mult,
                                    rank=4)),
        "lowrank_pallas": (
            RefSpec(mode="lowrank", multiplier=mult, rank=4),
            BackendSpec(mode="lowrank", multiplier=mult, rank=4,
                        variant="pallas")),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rope_tables_match_reference():
    for dim in (16, 64, 128):
        want = np.asarray(jax.jit(lambda: 1.0 / (10000.0 ** (jnp.arange(
            0, dim, 2, dtype=jnp.float32) / dim)))())
        np.testing.assert_array_equal(common.rope_inv_freq(dim, 10000.0),
                                      want)
        pos = np.arange(300, dtype=np.int32)
        rc, rs = jax.jit(lambda p: ref_common.rope_tables(
            p, dim, 10000.0))(jnp.asarray(pos))
        pc, ps = common.rope_tables(_t(pos), dim, 10000.0)
        # cos/sin of the same f32 angles: within 2 ulps at 1.0
        np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=0,
                                   atol=2.0 ** -23)
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=0,
                                   atol=2.0 ** -23)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax.jit(lambda a, b: ref_common.rms_norm(
        a, b, 1e-6))(jnp.asarray(x).astype(jdt), jnp.asarray(g)).astype(
            jnp.float32))
    got = common.rms_norm(_t(x).to(tdt), _t(g), 1e-6).float().numpy()
    # f32: sums in another order; bf16: the same f32 value rounded, so
    # at most one bf16 ulp apart
    rtol = 1e-6 if dtype == "f32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("cname", list(CONFIGS))
def test_attention_matches_reference(cname):
    ref_cfg, cfg = CONFIGS[cname]()
    params = _params(ref_cfg)
    ap = jax.tree.map(lambda a: a[0], params["blocks"]["mixer_0"])
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    ref_pol = RefPolicy(default=RefSpec(mode="f32"))

    def ref_attn(p, h, pos, cache):
        return ref_common.attention(p, h, ref_cfg, ref_pol,
                                    positions=pos, cache=cache)

    jattn = jax.jit(ref_attn)
    pp = lm_params_from_numpy(ap)
    scale = 1.0
    # no cache: causal self-attention
    want, _ = jattn(ap, jnp.asarray(x), jnp.arange(5), None)
    got, none = common.attention(pp, _t(x), cfg, EXACT_POLICY,
                                 positions=torch.arange(5))
    assert none is None
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_RTOL * scale)
    # with a cache: prefill 5 positions of 9, then one decode step
    rcache = ref_common.init_attention_cache(ref_cfg, 2, 9)
    pcache = common.init_attention_cache(cfg, 2, 9)
    w0, rcache = jattn(ap, jnp.asarray(x), jnp.arange(5), rcache)
    g0, pcache = common.attention(pp, _t(x), cfg, EXACT_POLICY,
                                  positions=torch.arange(5), cache=pcache)
    w1, rcache = jattn(ap, jnp.asarray(x1), jnp.full((1,), 5), rcache)
    g1, pcache = common.attention(pp, _t(x1), cfg, EXACT_POLICY,
                                  positions=torch.full((1,), 5),
                                  cache=pcache)
    assert pcache["pos"] == int(rcache["pos"]) == 6
    for g, w in ((g0, w0), (g1, w1), (pcache["k"], rcache["k"]),
                 (pcache["v"], rcache["v"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_RTOL * scale)


def _ref_logits(ref_cfg, params, prompts, spec, lib):
    """The jitted reference: prefill, then greedy decode; returns the
    (N, B, V) logits and the (B, N) tokens."""
    fns = ref_model_fns(ref_cfg)
    pol = RefPolicy(default=spec).materialize(lib)
    pre = jax.jit(lambda p, b, c: fns.forward_prefill(p, b, c, ref_cfg,
                                                      pol))
    dec = jax.jit(lambda p, t, c: fns.forward_decode(p, t, c, ref_cfg,
                                                     pol))
    jp = jax.tree.map(jnp.asarray, params)
    cache = fns.init_cache(ref_cfg, prompts.shape[0], S + N)
    logits, cache = pre(jp, {"tokens": jnp.asarray(prompts)}, cache)
    out, toks = [logits], [jnp.argmax(logits, -1).astype(jnp.int32)]
    for _ in range(N - 1):
        logits, cache = dec(jp, toks[-1], cache)
        out.append(logits)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return (np.stack([np.asarray(o, np.float32) for o in out]),
            np.stack([np.asarray(t) for t in toks], 1))


def _port_logits(cfg, params, prompts, tokens, spec, lib):
    """The port teacher-forced on ``tokens``: (N, B, V) logits."""
    fns = model_fns(cfg)
    pol = ApproxPolicy(default=spec).materialize(lib)
    with torch.inference_mode():
        cache = fns.init_cache(cfg, prompts.shape[0], S + N)
        logits, cache = fns.forward_prefill(
            params, {"tokens": _t(prompts)}, cache, cfg, pol)
        out = [logits]
        for i in range(N - 1):
            logits, cache = fns.forward_decode(params, _t(tokens[:, i]),
                                               cache, cfg, pol)
            out.append(logits)
    assert cache["mixer_0"]["pos"] == S + N - 1
    return torch.stack(out).float().numpy()


@pytest.mark.parametrize("policy", ["f32", "int8", "lowrank_ref",
                                    "lowrank_pallas"])
@pytest.mark.parametrize("cname", list(CONFIGS))
def test_prefill_and_teacher_forced_decode_logits(cname, policy, lib):
    ref_cfg, cfg = CONFIGS[cname]()
    params = _params(ref_cfg)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    ref_spec, spec = _specs(lib)[policy]
    want, tokens = _ref_logits(ref_cfg, params, prompts, ref_spec, lib)
    got = _port_logits(cfg, lm_params_from_numpy(params), prompts, tokens,
                       spec, lib)
    assert got.shape == want.shape == (N, B, cfg.vocab)
    atol = (F32_RTOL if policy == "f32" else QUANT_RTOL) * float(
        np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_bf16_activations_within_stated_tolerance(lib):
    ref_cfg, cfg = _reduced("bf16")
    params = _params(ref_cfg)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    for policy in ("int8", "lowrank_pallas"):
        ref_spec, spec = _specs(lib)[policy]
        want, tokens = _ref_logits(ref_cfg, params, prompts, ref_spec, lib)
        got = _port_logits(cfg, lm_params_from_numpy(params), prompts,
                           tokens, spec, lib)
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_parameter_trees_map_one_to_one():
    ref_cfg, cfg = _reduced()
    ref_params = _params(ref_cfg)
    port = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    carried = lm_params_from_numpy(ref_params)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for path, leaf in flat_ref:
        a, b = port, carried
        for p in path:
            a, b = a[p.key], b[p.key]
        assert tuple(a.shape) == leaf.shape == tuple(b.shape), path
        assert a.dtype == b.dtype == torch.float32
    assert port["blocks"]["mixer_0"]["wq"].shape[0] == cfg.n_layers


def test_unported_configs_raise_with_roadmap_item():
    """``forward_train`` now returns a finite scalar loss (its parity
    tests: ``tests/test_torch_forward_train.py``); MLA, the vlm pattern,
    chunked attention, deepseek-v2-236b and the encoder-decoder family
    build and prefill (their parity tests: ``tests/test_torch_mla.py``,
    ``test_torch_encdec.py``, ``test_torch_vlm.py``)."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 5)).astype(np.int32))
    with torch.inference_mode():
        loss = decoder.forward_train(
            params, {"tokens": tokens, "targets": tokens}, cfg)
    assert loss.shape == () and torch.isfinite(loss)
    with torch.inference_mode():
        vanilla, _ = decoder.forward_prefill(params, {"tokens": tokens},
                                             None, cfg)
        # chunked attention over 2-key chunks: the same logits within f32
        chunked, _ = decoder.forward_prefill(
            params, {"tokens": tokens}, None,
            dataclasses.replace(cfg, attn_impl="chunked", kv_chunk=2))
    np.testing.assert_allclose(chunked.numpy(), vanilla.numpy(), rtol=0,
                               atol=F32_RTOL * float(vanilla.abs().max()))
    for bad in (dataclasses.replace(cfg, use_mla=True, kv_lora=32,
                                    q_lora=32, rope_head_dim=8,
                                    v_head_dim=16),
                dataclasses.replace(cfg, family="vlm", n_img_tokens=3),
                get_config("deepseek-v2-236b").reduced(),
                get_config("whisper-large-v3").reduced()):
        fns = model_fns(bad)
        p = fns.init_params(torch.Generator().manual_seed(0), bad)
        extras = {k: torch.from_numpy(v)
                  for k, v in input_extras(bad, 2).items()}
        with torch.inference_mode():
            logits, cache = fns.forward_prefill(
                p, {"tokens": tokens, **extras},
                fns.init_cache(bad, 2, 5 + prompt_extra_len(bad, extras)),
                bad)
        assert logits.shape == (2, bad.vocab)
        assert torch.isfinite(logits).all(), bad.name
