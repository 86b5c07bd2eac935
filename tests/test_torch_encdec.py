"""The encoder-decoder family (``models/encdec.py``) of the port against
the reference at reduced whisper-large-v3 size (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16 over 2 KV heads, gelu FFN of 128, 24
encoder frames, vocab 512).  Parameters are the reference's (norm gains
randomised), carried across with ``lm_params_from_numpy``; frames and
tokens come from numpy generators with the seeds stated.

What is held, and how closely:
  * ``sinusoidal_positions`` with an offset: within one f32 ulp at 1.0
    (torch's and XLA's sin/cos of the same f32 angles);
  * the encoder is causal, as the reference's code runs it (frames past
    row r do not move row r), and ``encode`` equals the reference's
    within ``F32_RTOL`` of the largest |h|;
  * ``encode_cross_kv`` bit for bit under the int8 ``lut`` policy and
    ``cross_attention`` within ``F32_RTOL`` (f32) / ``QUANT_RTOL``;
  * ``forward_prefill`` then three decode steps within ``F32_RTOL`` /
    ``QUANT_RTOL`` of the largest |logit|; the cross-KV is carried
    unchanged;
  * the static ``Engine.generate`` with ``frames`` extras (f32, prompts
    and frames from seed 7): its logits, teacher-forced on the
    reference engine's tokens, within ``F32_RTOL`` of the reference's,
    and its greedy tokens all equal the reference's (token agreement
    1.0);
  * the parameter tree and ``probe_layer_tags`` on ``meta``,
    ``layer_mult_counts`` and ``ModuleMap.for_config(validate=True)``
    equal the reference's; the banked module sweep equals the
    sequential one bit for bit under ``pallas`` and ``fused`` with
    ``banked_calls_per_forward`` = 2 x (4 + 2) + 2 x (4 + 4 + 2) = 32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro.models.registry import model_fns as ref_model_fns
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.approx.layers import EXACT_POLICY
from repro_torch.models import encdec
from repro_torch.models.registry import model_fns
from repro_torch.models.weights import lm_params_from_numpy
from repro_torch.serve import Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_parity import (B, F32_RTOL, QUANT_RTOL, S, cfgs,
                               check_banked_sweep,
                               check_counts_and_module_map,
                               check_prefill_decode, check_trees_and_probe,
                               make_libs, policies, ref_params,
                               random_extras)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def libs():
    return make_libs()


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = cfgs(ARCH)
    rp = ref_params(ref_cfg)
    frames = np.random.default_rng(6).normal(
        size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, rp, lm_params_from_numpy(rp), frames


def _close(got, want, rtol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_sinusoidal_positions_match_reference():
    for seq, dim, offset in ((24, 64, 0), (1, 64, 7), (1500, 1280, 0),
                             (3, 1280, 31)):
        want = jax.jit(lambda: ref_encdec.sinusoidal_positions(
            seq, dim, offset))()
        got = encdec.sinusoidal_positions(seq, dim, offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2.0 ** -23)


def test_encoder_is_causal_as_the_reference_runs_it(model):
    ref_cfg, cfg, rp, pp, frames = model
    rpol, ppol = policies("f32")
    late = frames.copy()
    late[:, 10:] += 1.0                  # frames past row 9 change
    enc = jax.jit(lambda p, f: ref_encdec.encode(p, f, ref_cfg, rpol))
    want, want_late = enc(rp, frames), enc(rp, late)
    with torch.inference_mode():
        got = encdec.encode(pp, torch.from_numpy(frames), cfg, ppol)
        got_late = encdec.encode(pp, torch.from_numpy(late), cfg, ppol)
    _close(got, want, F32_RTOL)
    _close(got_late, want_late, F32_RTOL)
    # rows 0..9 see only frames 0..9 in both packages
    assert torch.equal(got[:, :10], got_late[:, :10])
    np.testing.assert_array_equal(np.asarray(want)[:, :10],
                                  np.asarray(want_late)[:, :10])
    assert not torch.equal(got[:, 10:], got_late[:, 10:])


@pytest.mark.parametrize("mode", ["f32", "lut"])
def test_cross_kv_and_cross_attention_match_reference(model, mode, libs):
    ref_cfg, cfg, rp, pp, frames = model
    rpol, ppol = policies(mode, libs)
    rx, px = rp["dec_blocks"]["xattn"], pp["dec_blocks"]["xattn"]
    rx = jax.tree.map(lambda a: a[1], rx)
    px = {k: v[1] for k, v in px.items()}
    x = np.random.default_rng(8).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    want_kv = jax.jit(lambda p, e: ref_encdec.encode_cross_kv(
        p, e, ref_cfg, rpol))(rx, frames)
    want = jax.jit(lambda p, h, kv: ref_encdec.cross_attention(
        p, h, kv, ref_cfg, rpol))(rx, x, want_kv)
    with torch.inference_mode():
        kv = encdec.encode_cross_kv(px, torch.from_numpy(frames), cfg, ppol)
        got = encdec.cross_attention(px, torch.from_numpy(x), kv, cfg,
                                     ppol)
    for key in ("k", "v"):
        if mode == "lut":    # quantized projections of the same input
            assert torch.equal(kv[key], torch.from_numpy(np.array(
                want_kv[key])))
        _close(kv[key], want_kv[key], F32_RTOL)
    _close(got, want, F32_RTOL if mode == "f32" else QUANT_RTOL)


def test_prefill_then_decode_matches_reference():
    ref_cfg, cfg = cfgs(ARCH)
    cache = check_prefill_decode(ref_cfg, cfg, n_decode=3)
    assert cache["self"]["pos"] == S + 3
    assert cache["cross"]["k"].shape == (cfg.n_layers, B, cfg.enc_frames,
                                         cfg.n_heads, cfg.head_dim)


def test_static_engine_generate_with_frames(model):
    """Greedy tokens of the port's engine against the reference's, and
    the port's logits teacher-forced on the reference's tokens."""
    ref_cfg, cfg, rp, pp, _frames = model
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extras = random_extras(cfg, rng)
    n = 4
    want_tokens = RefEngine(ref_cfg, jax.tree.map(jnp.asarray, rp)).generate(
        prompts, RefServeConfig(max_new_tokens=n), extras=extras)
    tokens = Engine(cfg, pp).generate(prompts, ServeConfig(max_new_tokens=n),
                                      extras=extras)
    assert tokens.shape == (B, n)
    # the reference's logits along its own tokens, and the port's
    rf, pf = ref_model_fns(ref_cfg), model_fns(cfg)
    rpol, _ = policies("f32")
    logits, rcache = rf.forward_prefill(
        rp, {"tokens": prompts, **extras},
        rf.init_cache(ref_cfg, B, S + n), ref_cfg, rpol)
    want = [logits]
    with torch.inference_mode():
        got_l, cache = pf.forward_prefill(
            pp, {"tokens": torch.from_numpy(prompts),
                 **{k: torch.from_numpy(v) for k, v in extras.items()}},
            pf.init_cache(cfg, B, S + n), cfg, EXACT_POLICY)
        got = [got_l]
        for i in range(n - 1):
            logits, rcache = rf.forward_decode(
                rp, jnp.asarray(want_tokens[:, i]), rcache, ref_cfg, rpol)
            want.append(logits)
            got_l, cache = pf.forward_decode(
                pp, torch.from_numpy(want_tokens[:, i].copy()), cache, cfg,
                EXACT_POLICY)
            got.append(got_l)
    _close(torch.stack(got), np.stack([np.asarray(w) for w in want]),
           F32_RTOL)
    agreement = float((tokens == want_tokens).mean())
    assert agreement == 1.0, (tokens, want_tokens)


def test_trees_and_probe_tags_match_reference():
    check_trees_and_probe(ARCH)


def test_counts_and_module_map_match_reference():
    check_counts_and_module_map(ARCH)


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_banked_module_sweep_bit_identity_and_calls(variant, libs):
    check_banked_sweep(ARCH, variant, libs[1], 2 * (4 + 2) + 2 * (8 + 2))
