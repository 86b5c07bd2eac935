"""The VLM family (the decoder's vlm pattern: ``img_proj`` and image
positions prepended to the tokens) of the port against the reference at
reduced llava-next-34b size (2 layers, d_model 64, 4 heads over 2 KV
heads, 8 image tokens, vocab 512).  Parameters are the reference's (norm
gains randomised), carried across with ``lm_params_from_numpy``; image
embeddings and tokens come from numpy generators with the seeds stated.

What is held, and how closely:
  * ``forward_prefill`` with ``img_embeds`` then two decode steps:
    ``F32_RTOL`` / ``QUANT_RTOL`` of the largest |logit|; the cache
    holds the image positions before the tokens;
  * ``prompt_extra_len`` equals the reference's, and the static
    ``Engine`` sizes its cache ``prompt + image tokens + max_new``;
  * the parameter tree (with ``img_proj``) and ``probe_layer_tags`` on
    ``meta``, ``layer_mult_counts`` (``img_proj`` and the image
    positions) and ``ModuleMap.for_config(validate=True)`` equal the
    reference's; the banked module sweep — a banked ``img_proj`` gives
    the image embeddings a bank lane axis, and the token embeddings are
    copied to every lane — equals the sequential one bit for bit under
    ``pallas`` and ``fused`` with ``banked_calls_per_forward`` = 2 x
    (4 + 3) + 1 = 15.
"""
import numpy as np
import pytest
import torch

from repro.models.registry import prompt_extra_len as ref_extra_len
from repro_torch.models import decoder
from repro_torch.models.registry import (input_extras, model_fns,
                                         prompt_extra_len)
from repro_torch.serve import Engine, ServeConfig
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo_parity import (B, S, cfgs, check_banked_sweep,
                               check_counts_and_module_map,
                               check_prefill_decode, check_trees_and_probe,
                               make_libs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "llava-next-34b"


def test_prefill_then_decode_with_img_embeds_matches_reference():
    ref_cfg, cfg = cfgs(ARCH)
    assert decoder.block_pattern(cfg) == [("attn", "ffn")]
    cache = check_prefill_decode(ref_cfg, cfg)
    assert cache["mixer_0"]["pos"] == cfg.n_img_tokens + S + 2


def test_prompt_extra_len_and_engine_max_len():
    ref_cfg, cfg = cfgs(ARCH)
    extras = input_extras(cfg, B)
    assert extras["img_embeds"].shape == (B, cfg.n_img_tokens, cfg.d_model)
    assert prompt_extra_len(cfg, extras) == ref_extra_len(ref_cfg, extras) \
        == cfg.n_img_tokens == 8
    assert prompt_extra_len(cfg, None) == 0
    fns = model_fns(cfg)
    params = fns.init_params(torch.Generator().manual_seed(0), cfg)
    engine = Engine(cfg, params)
    rows = []
    init_cache = fns.init_cache

    def spy(cfg_, batch, max_len, device=None):
        rows.append(max_len)
        return init_cache(cfg_, batch, max_len, device)
    engine.fns = type(fns)(fns.init_params, fns.forward_train, spy,
                           fns.forward_prefill, fns.forward_decode,
                           fns.forward_decode_lanes)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    out = engine.generate(prompts, ServeConfig(max_new_tokens=3),
                          extras=extras)
    assert out.shape == (B, 3) and out.min() >= 0 and out.max() < cfg.vocab
    assert rows == [S + 3 + cfg.n_img_tokens]


def test_trees_and_probe_tags_match_reference():
    check_trees_and_probe(ARCH)


def test_counts_and_module_map_match_reference():
    check_counts_and_module_map(ARCH)


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_banked_module_sweep_bit_identity_and_calls(variant):
    check_banked_sweep(ARCH, variant, make_libs()[1], 2 * (4 + 3) + 1)
