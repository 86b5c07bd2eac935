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

``ContinuousEngine`` serves many tenants at once: a request scheduler,
a paged KV cache and a mixed-policy decode step in which every running
request is one lane of a shared LUT bank (DESIGN.md §2.8).
"""
from __future__ import annotations

import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from ..approx.backend import as_backend, backend_matmul
from ..approx.layers import (EXACT_POLICY, ApproxPolicy,
                             bank_assignment_overrides, bank_backend)
from ..approx.specs import BackendSpec, bank_for, policy_assignment
from ..device import device_key, replicate
from ..kernels import ops
from ..models.common import LMConfig
from ..models.registry import (input_extras, model_fns, probe_layer_tags,
                               prompt_extra_len)
from .kv_cache import LaneCaches, PagedKVCache
from .scheduler import Request, RequestState, Scheduler


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


# ----------------------------------------------------------------------
# Continuous batching (DESIGN.md §2.8)
# ----------------------------------------------------------------------
@dataclass
class _Shard:
    """One device's part of a ``ContinuousEngine``: its parameter
    replica and the paged cache of slots ``start`` onward."""
    device: torch.device
    params: dict
    start: int
    kv: PagedKVCache


@dataclass
class _CountedPolicy(ApproxPolicy):
    """An ``ApproxPolicy`` that counts its matmuls in ``calls``:
    ``"banked"`` (one banked datapath call for every lane at once) or
    ``"single"``."""
    calls: Counter = field(default_factory=Counter)

    def matmul(self, name: str, x: torch.Tensor, w: torch.Tensor,
               lanes: bool = False, experts: bool = False) -> torch.Tensor:
        backend = self.backend_for(name)
        self.calls["banked" if as_backend(backend).lanes is not None
                   else "single"] += 1
        return backend_matmul(x, w, backend, lanes=lanes, experts=experts)


class ContinuousEngine:
    """Continuous-batching multi-tenant engine: request scheduler +
    paged KV cache + mixed-policy decode (port of the reference's
    ``ContinuousEngine``).

    Each in-flight request occupies a *slot*; requests join at
    decode-step boundaries (a B=1 prefill on admission) and retire on
    max-tokens.  Per-request ``ServeConfig.policy`` entries are resolved
    against the model's probed layer tags (``policy_assignment``) into
    lanes of a shared ``LutBank``.  A decode step runs the active slots
    as lanes: each projection is ONE banked datapath call through the
    ``bank_assignment_overrides`` of the active slots' assignment rows —
    one K2 (``pallas``) or K4 (``fused``) launch a projection, whatever
    the number of distinct policies — while the norms, attention over
    each slot's paged cache view, the unembedding and sampling run slot
    by slot at B=1 (the family's ``forward_decode_lanes``).  Every
    family of the registry serves so: attention k/v, MLA's latent rows
    and the encoder-decoder's self k/v are paged; a mamba slot's conv
    and SSM state and the encoder-decoder's cross-KV are the slot's
    dense rows (the cross-KV written once at admission, the state after
    each step for the slots that ran); an MoE layer routes each slot's
    token alone, one banked call a projection for all its experts; a
    request's ``extras`` (encoder frames, image embeddings) enter its
    prefill.

    Token streams equal per-request sequential ``Engine.generate`` under
    ``lane_policy(serve)`` token for token: a banked lane's integer sums
    equal the single-table kernel's and its calibration is its own,
    every float reduction sees the shapes the sequential B=1 run gives
    it (a slot's attention runs over exactly ``prefill + max_new`` rows,
    the cache ``generate`` allocates), and each request samples from its
    own ``torch.Generator`` seeded ``serve.seed``, one draw a token, as
    ``generate`` does.

    ``multipliers`` optionally fixes the bank's lane set up front
    (anything outside it is rejected at submit); by default the bank
    grows on first use of a new multiplier (counted in
    ``trace_counts['bank_builds']``).  ``step_log`` holds one record a
    prefill and a decode step: its lanes, its banked and single-table
    matmul calls and the kernel launches it made (none on the CPU); a
    decode step's also its wall (``wall_s``: host clock from its inputs
    to its sampled tokens on the host) and the shards that ran it
    (``shards``).

    ``sharding`` (``launch.mesh.slot_sharding``) splits the slot axis
    across its mesh's devices: each device keeps a replica of the
    parameters (copied once; the bank's tables move to each device on
    first use) and a paged cache of its own slots (``kvs``; ``n_blocks``
    is shared out evenly), the scheduler maps slot i to the shard whose
    range holds it, and a decode step runs each shard's lane step on its
    device — every shard's launches queued before any sampled token is
    read — then gathers the tokens to the host in slot order.  No
    reduction or calibration spans lanes, so a shard's tokens equal the
    whole engine's.  A count the mesh does not divide runs whole on the
    first device.
    """

    #: the most per-active-set lane policies kept (each holds its
    #: layers' gathered tables on the device)
    _POLICIES_MAX = 16

    def __init__(self, cfg: LMConfig, params, *, library=None,
                 multipliers=None, default_policy=None,
                 n_slots: int = 4, capacity: int = 64,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 mode: str = "lut", variant: str = "ref",
                 block_m: int = 512, base: Optional[BackendSpec] = None,
                 sharding=None):
        self.cfg = cfg
        self.params = params
        self.fns = model_fns(cfg)
        self.device = params["embed"].device
        self._library = library
        self.mode, self.variant, self.block_m = mode, variant, block_m
        self.capacity, self.n_slots = int(capacity), int(n_slots)
        self.layers = probe_layer_tags(cfg, params)
        if default_policy is None:
            default_policy = ApproxPolicy(default=BackendSpec(
                mode=mode, multiplier="mul8u_exact", block_m=block_m,
                ste=False, variant=variant))
        elif not isinstance(default_policy, ApproxPolicy):
            default_policy = ApproxPolicy.from_json(default_policy)
        self.default_policy = default_policy
        self.base = (base if base is not None
                     else BackendSpec.golden()).materialize(library)
        ranges = (sharding.shards(self.n_slots) if sharding is not None
                  else [(self.device, 0, self.n_slots)])
        if n_blocks is not None and n_blocks % len(ranges):
            raise ValueError(f"n_blocks {n_blocks} does not divide into "
                             f"{len(ranges)} shards")
        replicas: dict = {device_key(self.device): params}
        self._shards: list[_Shard] = []
        for dev, start, stop in ranges:
            key = device_key(dev)
            if key not in replicas:
                replicas[key] = replicate(params, key)
            self._shards.append(_Shard(
                device=key, params=replicas[key], start=start,
                kv=PagedKVCache(
                    self.fns, cfg, n_slots=stop - start,
                    capacity=self.capacity, block_size=block_size,
                    n_blocks=(None if n_blocks is None
                              else n_blocks // len(ranges)),
                    device=key)))
        #: each shard's paged cache; ``kv`` is the first (the only one
        #: without ``sharding``)
        self.kvs = [sh.kv for sh in self._shards]
        self.kv = self.kvs[0]
        self._shard_of = np.concatenate([
            np.full(sh.kv.n_slots, i) for i, sh in enumerate(self._shards)])
        self.scheduler = Scheduler(self.n_slots)
        n = self.n_slots
        self._tokens = np.zeros(n, np.int64)
        self._lengths = np.zeros(n, np.int64)
        self._active = np.zeros(n, bool)
        self._assign = np.zeros((n, len(self.layers)), np.int64)
        self._gens: list = [None] * n        # per-slot sampler
        # per-slot pool rows (host, device); None without pools (SSM)
        self._phys: list = [None] * n
        self.trace_counts = {"bank_builds": 0}
        self.step_log: list[dict] = []
        self._calls: Counter = Counter()
        self._policies: "OrderedDict[bytes, ApproxPolicy]" = OrderedDict()
        self._fixed_bank = multipliers is not None
        self._names: list[str] = []
        self._bank = None
        self._rid = 0
        self.step_count = 0
        seed_names = list(multipliers) if multipliers else []
        for m in policy_assignment(self.default_policy, self.layers,
                                   mode=mode, block_m=block_m).values():
            if m not in seed_names:
                if self._fixed_bank:
                    raise ValueError(
                        f"default policy needs {m!r}, which is not in "
                        f"the fixed multiplier set {multipliers}")
                seed_names.append(m)
        self._fixed_bank = False        # allow the seed build
        self._grow_bank(seed_names)
        self._fixed_bank = multipliers is not None

    # -- bank assembly --------------------------------------------------
    def _grow_bank(self, new_names) -> None:
        self._names.extend(n for n in new_names if n not in self._names)
        self._bank = bank_for(tuple(self._names), self._library,
                              block_m=self.block_m)
        # one banked backend over the whole bank: its tables move to the
        # device once, and every lane policy gathers its own from them
        self._bank_src = bank_backend(self._bank, self.mode, self.variant)
        self._policies.clear()
        self.trace_counts["bank_builds"] += 1

    def _assignment(self, serve: ServeConfig) -> dict:
        policy = (self.default_policy if serve.policy is None
                  else ApproxPolicy.from_json(serve.policy))
        return policy_assignment(policy, self.layers, mode=self.mode,
                                 block_m=self.block_m)

    def _resolve_policy(self, serve: ServeConfig) -> np.ndarray:
        """Request policy → per-layer bank-lane row, growing the shared
        bank when a (non-fixed) engine first sees a multiplier."""
        assignment = self._assignment(serve)
        new = [m for m in dict.fromkeys(assignment.values())
               if m not in self._names]
        if new:
            if self._fixed_bank:
                raise ValueError(
                    f"request needs multipliers {new} outside the "
                    f"engine's fixed bank {self._names}")
            self._grow_bank(new)
        index = {m: i for i, m in enumerate(self._bank.names)}
        return np.asarray([index[assignment[l]] for l in self.layers],
                          np.int64)

    def lane_policy(self, serve: ServeConfig) -> ApproxPolicy:
        """The sequential (materialized) policy a slot running this
        request emulates — ``base`` everywhere, the request's multiplier
        per probed layer.  Sequential ``Engine.generate`` under this
        policy is the bit-identity reference for the banked lane."""
        overrides = [
            (layer, BackendSpec(mode=self.mode, multiplier=name,
                                block_m=self.block_m, ste=False,
                                variant=self.variant))
            for layer, name in self._assignment(serve).items()]
        return ApproxPolicy(default=self.base,
                            overrides=overrides).materialize(self._library)

    def _where(self, slot: int) -> tuple:
        """(shard, the slot's index in the shard's cache)."""
        sh = self._shards[self._shard_of[slot]]
        return sh, slot - sh.start

    def _policy_for(self, assign: np.ndarray, shard: int = 0
                    ) -> ApproxPolicy:
        """The banked policy of these assignment rows (one lane a row),
        kept for the next steps of ``shard`` with the same running
        set."""
        key = (int(shard).to_bytes(2, "little")
               + assign.shape[0].to_bytes(2, "little") + assign.tobytes())
        policy = self._policies.get(key)
        if policy is None:
            policy = _CountedPolicy(
                default=self.base, calls=self._calls,
                overrides=bank_assignment_overrides(
                    self._bank, assign, self.layers, mode=self.mode,
                    variant=self.variant, source=self._bank_src))
            self._policies[key] = policy
            while len(self._policies) > self._POLICIES_MAX:
                self._policies.popitem(last=False)
        else:
            self._policies.move_to_end(key)
        return policy

    def step_summary(self, start: int = 0) -> dict:
        """``step_log[start:]`` by kind (``prefill``, ``decode``): how
        many, the distinct banked and single-table matmul calls a step
        and the distinct kernel launches a step."""
        out = {}
        for kind in ("prefill", "decode"):
            log = [e for e in self.step_log[start:] if e["kind"] == kind]
            launches = []
            for e in log:
                if e["launches"] not in launches:
                    launches.append(e["launches"])
            out[kind] = {"n": len(log),
                         "banked": sorted({e["banked"] for e in log}),
                         "single": sorted({e["single"] for e in log}),
                         "launches": launches}
        return out

    def _logged(self, kind: str, lanes: int, fn):
        """``fn()``, with its matmul calls and kernel launches appended
        to ``step_log``."""
        self._calls.clear()
        out, launches = ops.launches_during(fn)
        self.step_log.append({"kind": kind, "lanes": lanes,
                              "banked": self._calls["banked"],
                              "single": self._calls["single"],
                              "launches": launches})
        return out

    # -- request lifecycle ----------------------------------------------
    def submit(self, prompt, serve: Optional[ServeConfig] = None,
               extras: Optional[dict] = None,
               rid: Optional[str] = None) -> str:
        """Queue one request.  Policy resolution (and therefore bank
        membership validation) happens here, so a bad policy fails the
        submit, not a later step."""
        serve = serve if serve is not None else ServeConfig()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if rid is None:
            rid = f"r{self._rid}"
            self._rid += 1
        if extras is None:
            extras = input_extras(self.cfg, 1) or None
        assign_row = self._resolve_policy(serve)
        prefill_len = len(prompt) + prompt_extra_len(self.cfg, extras)
        total_len = prefill_len + serve.max_new_tokens
        # decode at the last position still writes row total_len - 1
        if total_len > self.capacity:
            raise ValueError(
                f"request {rid!r} needs {total_len} cache rows "
                f"(prefill {prefill_len} + {serve.max_new_tokens} new); "
                f"engine capacity is {self.capacity}")
        state = RequestState(
            request=Request(rid=rid, prompt=prompt, serve=serve,
                            extras=extras),
            assign_row=assign_row, prefill_len=prefill_len,
            total_len=total_len)
        self.scheduler.submit(state, self.step_count)
        return rid

    def _retire(self) -> list:
        done = [st for st in self.scheduler.running.values() if st.done]
        for st in done:
            slot = st.slot
            sh, local = self._where(slot)
            sh.kv.release(local)
            self._active[slot] = False
            self._gens[slot] = self._phys[slot] = None
            self.scheduler.finish(st, self.step_count)
        return done

    def _prefill(self, st) -> int:
        """B=1 prefill of an admitted request over a ``total_len``-row
        cache (the one ``generate`` allocates), its rows then written
        into the slot's blocks; returns its first token."""
        sh, local = self._where(st.slot)
        dev, cfg, serve = sh.device, self.cfg, st.request.serve
        batch = {"tokens": torch.as_tensor(st.request.prompt[None],
                                           device=dev)}
        if st.request.extras:
            batch.update({k: torch.as_tensor(np.asarray(v), device=dev)
                          for k, v in st.request.extras.items()})
        policy = self._policy_for(st.assign_row[None],
                                  self._shard_of[st.slot])
        cache = self.fns.init_cache(cfg, 1, st.total_len, dev)
        logits, cache = self._logged("prefill", 1, lambda: (
            self.fns.forward_prefill(sh.params, batch, cache, cfg,
                                     policy, lanes=True)))
        gen = torch.Generator(device=dev).manual_seed(serve.seed)
        self._gens[st.slot] = gen
        sh.kv.write_prefill(local, cache, st.prefill_len)
        return int(Engine._sample(logits, serve, gen)[0])

    def _admit(self) -> list:
        admitted = []
        while True:
            st = self.scheduler.head()
            free = self.scheduler.free_slots()
            if st is None or not free:
                break
            # the scheduler admits into the lowest free slot: its shard's
            # cache must hold the request
            kv = self._where(free[0])[0].kv
            if not kv.can_allocate(kv.blocks_needed(st.total_len)):
                break                   # strict FIFO: head blocks queue
            st = self.scheduler.admit(self.step_count)
            slot = st.slot
            local = self._where(slot)[1]
            kv.allocate(local, st.total_len)
            if kv.pools:
                rows = kv.slot_rows(local, st.total_len)
                self._phys[slot] = (rows.cpu().numpy(), rows)
            tok = self._prefill(st)
            st.tokens.append(tok)
            self._tokens[slot] = tok
            self._lengths[slot] = st.prefill_len
            self._assign[slot] = st.assign_row
            self._active[slot] = not st.done    # max_new==1: retire next
            admitted.append(st)
        return admitted

    def _decode_once(self) -> bool:
        slots = [s for s in sorted(self.scheduler.running)
                 if self._active[s]]
        if not slots:
            return False
        t0 = time.perf_counter()
        paged = bool(self.kv.pools)
        # each shard's running slots (slot order), its inputs copied to
        # its device before any shard's step is queued
        steps = []
        for i, sh in enumerate(self._shards):
            mine = [s for s in slots if self._shard_of[s] == i]
            if not mine:
                continue
            pos = self._lengths[mine]
            host = np.stack([self._tokens[mine], pos,
                             [self._phys[s][0][p] if paged else -1
                              for s, p in zip(mine, pos)]])
            tokens, positions, write = torch.from_numpy(host).to(sh.device)
            cache = LaneCaches(sh.kv, [s - sh.start for s in mine], pos,
                               [self._phys[s][1] if paged else None
                                for s in mine], write)
            steps.append((sh, mine, tokens, positions, cache,
                          self._policy_for(self._assign[mine], i)))

        def run() -> list:
            sampled = []
            for sh, mine, tokens, positions, cache, policy in steps:
                logits = self.fns.forward_decode_lanes(
                    sh.params, tokens, positions, cache, self.cfg, policy)
                cache.commit()
                sampled.append(torch.cat([
                    Engine._sample(lg,
                                   self.scheduler.running[s].request.serve,
                                   self._gens[s])
                    for s, lg in zip(mine, logits)]))
            return sampled

        sampled = self._logged("decode", len(slots), run)
        toks = np.concatenate([t.cpu().numpy() for t in sampled])
        self.step_log[-1]["wall_s"] = time.perf_counter() - t0
        self.step_log[-1]["shards"] = len(steps)
        for sh, mine, *_ in steps:
            sh.kv.advance([s - sh.start for s in mine])
        for slot, tok in zip(slots, toks):
            st = self.scheduler.running[slot]
            st.tokens.append(int(tok))
            self._tokens[slot] = tok
            self._lengths[slot] += 1
            if st.done:
                self._active[slot] = False   # retired next step
        return True

    def step(self) -> dict:
        """One decode-step boundary: retire finished requests, admit
        from the queue (prefill + KV block reservation), run one
        mixed-policy decode step over all active slots."""
        self.step_count += 1
        with torch.inference_mode():
            finished = self._retire()
            admitted = self._admit()
            decoded = self._decode_once()
        if not (finished or admitted or decoded) and \
                self.scheduler.pending:
            st = self.scheduler.head()
            raise RuntimeError(
                f"scheduler stalled: request {st.rid!r} needs "
                f"{self.kv.blocks_needed(st.total_len)} blocks / a "
                f"free slot and none can ever free up")
        return {"step": self.step_count, "finished": finished,
                "admitted": admitted, "decoded": decoded,
                "n_active": int(self._active.sum()),
                "n_pending": len(self.scheduler.pending)}

    def run(self) -> dict:
        """Drive steps until the queue and batch drain; returns
        {rid: (max_new_tokens,) int32} in finishing order."""
        while not self.scheduler.idle:
            self.step()
        return {st.rid: np.asarray(st.tokens, np.int32)
                for st in self.scheduler.finished.values()}
