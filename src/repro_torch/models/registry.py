"""Family dispatch (port of ``repro.models.registry``): maps
``LMConfig.family`` to the init/forward functions, plus the serving
hooks the engine uses (``input_extras``, ``prompt_extra_len``).

The port has the decoder only; ``probe_layer_tags`` waits for the
continuous-batching engine (ROADMAP.md Queue 1, "Continuous-batching
serving").
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import decoder
from .common import ZOO_ITEM, LMConfig


class ModelFns:
    def __init__(self, init_params, forward_train, init_cache,
                 forward_prefill, forward_decode):
        self.init_params = init_params
        self.forward_train = forward_train
        self.init_cache = init_cache
        self.forward_prefill = forward_prefill
        self.forward_decode = forward_decode


_DECODER = ModelFns(decoder.init_params, decoder.forward_train,
                    decoder.init_cache, decoder.forward_prefill,
                    decoder.forward_decode)


def model_fns(cfg: LMConfig) -> ModelFns:
    if cfg.family == "encdec":
        raise NotImplementedError(f"the encoder-decoder family is not "
                                  f"ported yet ({ZOO_ITEM})")
    return _DECODER


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
