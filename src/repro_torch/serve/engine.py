"""Batched serving engine (port of ``repro.serve.engine.Engine``):
prefill + greedy/temperature decode with a static KV cache.  The
approximate-multiplier backend (int8, LUT or low-rank) is selected per
request batch through an ``ApproxPolicy`` — the "accelerator being
emulated" serving path.

Policies are spec-first: a request may carry a serialized policy
(``ServeConfig.policy``, the ``to_json_dict`` form or its JSON string),
which the engine materializes against its library through the cached
``materialize``.  Nothing is compiled — PyTorch runs eagerly — so the
reference's LRU of jitted (prefill, decode) pairs has no counterpart:
switching policy per request costs the materialization cache's lookup.

Greedy decoding equals the reference's token for token wherever the
logits agree.  Temperature sampling draws from a ``torch.Generator``
seeded from ``ServeConfig.seed``: the same semantics (a categorical
draw from ``softmax(logits / T)``), not the same stream as
``jax.random``.

The engine runs on the device its parameters live on; tokens stay on
the device until ``generate`` returns, so the decode loop never waits
for the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..approx.layers import EXACT_POLICY, ApproxPolicy
from ..models.common import LMConfig
from ..models.registry import model_fns, prompt_extra_len


@dataclass
class ServeConfig:
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    # Per-request accelerator selection: a serialized ApproxPolicy (the
    # ``to_json_dict()`` dict or the ``to_json()`` string); None = the
    # engine's default policy.
    policy: Optional[Union[dict, str]] = None


class Engine:
    def __init__(self, cfg: LMConfig, params,
                 policy: ApproxPolicy = EXACT_POLICY, library=None):
        self.cfg = cfg
        self.params = params
        self._library = library
        self.policy = policy.materialize(library)
        self.fns = model_fns(cfg)
        self.device = params["embed"].device

    def _request_policy(self, serve_cfg: ServeConfig) -> ApproxPolicy:
        if serve_cfg.policy is None:
            return self.policy
        return ApproxPolicy.from_json(serve_cfg.policy).materialize(
            self._library)

    def generate(self, prompts: np.ndarray, serve_cfg: ServeConfig,
                 extras: Optional[dict] = None) -> np.ndarray:
        """prompts: (B, S) int32. Returns (B, max_new_tokens) int32."""
        policy = self._request_policy(serve_cfg)
        cfg, fns = self.cfg, self.fns
        b, s = prompts.shape
        max_len = s + serve_cfg.max_new_tokens
        if extras:
            max_len += prompt_extra_len(cfg, extras)
        gen = torch.Generator(device=self.device).manual_seed(
            serve_cfg.seed)
        with torch.inference_mode():
            cache = fns.init_cache(cfg, b, max_len, self.device)
            batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                               device=self.device)}
            if extras:
                batch.update({k: torch.as_tensor(v, device=self.device)
                              for k, v in extras.items()})
            logits, cache = fns.forward_prefill(self.params, batch, cache,
                                                cfg, policy)
            tok = self._sample(logits, serve_cfg, gen)
            out = [tok]
            for _ in range(serve_cfg.max_new_tokens - 1):
                logits, cache = fns.forward_decode(self.params, tok, cache,
                                                   cfg, policy)
                tok = self._sample(logits, serve_cfg, gen)
                out.append(tok)
            return torch.stack(out, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits: torch.Tensor, serve_cfg: ServeConfig,
                gen: torch.Generator) -> torch.Tensor:
        if serve_cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / serve_cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
