"""Family dispatch (port of ``repro.models.registry``): maps
``LMConfig.family`` to the init/forward functions, plus the serving
hooks the engines use (``input_extras``, ``prompt_extra_len``,
``probe_layer_tags``): the decoder (dense, moe, ssm, hybrid and vlm
patterns, MLA or GQA attention) and the encoder-decoder.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import decoder, encdec
from .common import LMConfig, MetaGenerator


class ModelFns:
    def __init__(self, init_params, forward_train, init_cache,
                 forward_prefill, forward_decode, forward_decode_lanes):
        self.init_params = init_params
        self.forward_train = forward_train
        self.init_cache = init_cache
        self.forward_prefill = forward_prefill
        self.forward_decode = forward_decode
        self.forward_decode_lanes = forward_decode_lanes


_DECODER = ModelFns(decoder.init_params, decoder.forward_train,
                    decoder.init_cache, decoder.forward_prefill,
                    decoder.forward_decode, decoder.forward_decode_lanes)
_ENCDEC = ModelFns(encdec.init_params, encdec.forward_train,
                   encdec.init_cache, encdec.forward_prefill,
                   encdec.forward_decode, encdec.forward_decode_lanes)


def model_fns(cfg: LMConfig) -> ModelFns:
    return _ENCDEC if cfg.family == "encdec" else _DECODER


def input_extras(cfg: LMConfig, batch: int,
                 fill: float = 0.1) -> dict[str, np.ndarray]:
    """The non-token prefill inputs a family needs (stub embeddings):
    encdec audio frames, vlm image embeddings.  Token-only families
    return ``{}``."""
    if cfg.family == "encdec":
        return {"frames": np.full((batch, cfg.enc_frames, cfg.d_model),
                                  fill, np.float32)}
    if cfg.family == "vlm":
        return {"img_embeds": np.full((batch, cfg.n_img_tokens,
                                       cfg.d_model), fill, np.float32)}
    return {}


def prompt_extra_len(cfg: LMConfig, extras: Optional[dict]) -> int:
    """Extra prompt positions the prefill extras occupy in the KV cache
    (vlm image embeddings are prepended to the tokens; encdec frames
    feed the encoder only)."""
    if cfg.family == "vlm" and extras and "img_embeds" in extras:
        return int(extras["img_embeds"].shape[1])
    return 0


def probe_layer_tags(cfg: LMConfig, params) -> tuple[str, ...]:
    """All ``policy.matmul`` call-site names one prefill step of this
    model hits, in first-call order.  The prefill runs on the ``meta``
    device (shapes only, no FLOPs) under a recording policy over an
    ``f32`` spec.  Scanned blocks share tags, so the list is
    per-layer-*type*, not per-depth.  This is the layer axis a serve
    request's ``ApproxPolicy`` is resolved over (``policy_assignment``)."""
    from ..approx.layers import ApproxPolicy
    from ..approx.specs import BackendSpec

    seen: list[str] = []

    class _Recorder(ApproxPolicy):
        def backend_for(self, name: str):
            if name not in seen:
                seen.append(name)
            return super().backend_for(name)

    probe = _Recorder(default=BackendSpec(mode="f32"))
    fns = model_fns(cfg)
    seq = 4
    extras = input_extras(cfg, 1)
    meta = torch.device("meta")
    batch = {"tokens": torch.zeros((1, seq), dtype=torch.int32,
                                   device=meta)}
    batch.update({k: torch.from_numpy(v).to(meta)
                  for k, v in extras.items()})
    on_meta = _to_device(params, meta)
    cache = fns.init_cache(cfg, 1, seq + prompt_extra_len(cfg, extras) + 1,
                           meta)
    with torch.inference_mode():
        fns.forward_prefill(on_meta, batch, cache, cfg, probe)
    return tuple(seen)


def abstract_params(cfg: LMConfig) -> dict:
    """The model's parameter tree on the ``meta`` device: shapes and
    dtypes, no memory (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return model_fns(cfg).init_params(MetaGenerator(), cfg)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
