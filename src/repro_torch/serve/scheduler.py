"""Request queue + admission control for continuous batching (port of
``repro.serve.scheduler``, DESIGN.md §2.8).

The scheduler is pure host-side bookkeeping: requests enter a FIFO
queue on ``submit``, join the running batch at a decode-step boundary
when (a) a slot is free and (b) the paged KV cache can reserve every
block the request will EVER need (prefill + max_new_tokens — reserved
up front, so an admitted request can never be evicted or OOM
mid-decode), and retire on completion (max-tokens), freeing their slot
and blocks for the next queued request.  Admission is strict FIFO: a
head request that doesn't fit blocks the queue rather than being
overtaken (no starvation).

The engine owns the device work; the scheduler only decides *who* is
in the batch each step, and records per-request timing for the load
generator's latency percentiles.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:                      # engine imports us at runtime
    from .engine import ServeConfig


@dataclass
class Request:
    """One tenant request: a prompt, a ``ServeConfig`` (which carries
    the per-request serialized ``ApproxPolicy`` — the accelerator this
    tenant selected), and optional prefill extras."""
    rid: str
    prompt: np.ndarray                  # (S,) int32
    serve: ServeConfig
    extras: Optional[dict] = None


@dataclass
class RequestState:
    """Scheduler-side lifecycle record of one request."""
    request: Request
    assign_row: np.ndarray              # (n_layers,) bank lane per layer
    prefill_len: int                    # prompt + prepended extras rows
    total_len: int                      # prefill + max_new (KV budget)
    slot: int = -1
    tokens: list = field(default_factory=list)
    submitted_step: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0

    @property
    def rid(self) -> str:
        return self.request.rid

    @property
    def max_new(self) -> int:
        return self.request.serve.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


class Scheduler:
    def __init__(self, n_slots: int):
        self.n_slots = int(n_slots)
        self.pending: "deque[RequestState]" = deque()
        self.running: dict[int, RequestState] = {}
        self.finished: "OrderedDict[str, RequestState]" = OrderedDict()

    # -- queue ----------------------------------------------------------
    def submit(self, state: RequestState, step: int) -> None:
        state.submitted_step = step
        state.submitted_at = time.monotonic()
        self.pending.append(state)

    def head(self) -> Optional[RequestState]:
        return self.pending[0] if self.pending else None

    def free_slots(self) -> list[int]:
        return sorted(set(range(self.n_slots)) - set(self.running))

    # -- lifecycle ------------------------------------------------------
    def admit(self, step: int) -> RequestState:
        """Pop the FIFO head into the lowest free slot.  The engine
        checks admissibility (free slot + KV blocks) first."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("admit() with no free slot")
        if not self.pending:
            raise RuntimeError("admit() with an empty queue")
        state = self.pending.popleft()
        state.slot = free[0]
        state.admitted_step = step
        state.admitted_at = time.monotonic()
        self.running[state.slot] = state
        return state

    def finish(self, state: RequestState, step: int) -> None:
        if self.running.get(state.slot) is not state:
            raise RuntimeError(f"finish() of a non-running request "
                               f"{state.rid!r}")
        del self.running[state.slot]
        state.finished_step = step
        state.finished_at = time.monotonic()
        self.finished[state.rid] = state
        state.slot = -1

    # -- introspection --------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.pending and not self.running

    def check_invariants(self, cache=None) -> None:
        """Assert the scheduler/cache joint state is consistent (used
        by tests after every step): slots unique and in range, running
        requests neither pending nor finished, and — given the cache —
        block ownership disjoint with the free list complete."""
        slots = list(self.running)
        assert len(slots) == len(set(slots))
        assert all(0 <= s < self.n_slots for s in slots)
        for slot, st in self.running.items():
            assert st.slot == slot
            assert st not in self.pending
            assert st.rid not in self.finished
            assert len(st.tokens) <= st.max_new
        for st in self.pending:
            assert st.slot == -1 and st.admitted_step == -1
        if cache is not None:
            held = []
            for slot in range(cache.n_slots):
                blocks = [int(b) for b in cache.block_tables[slot]
                          if b >= 0]
                if slot not in self.running:
                    assert not blocks, \
                        f"idle slot {slot} holds blocks {blocks}"
                held.extend(blocks)
            assert len(held) == len(set(held)), "block double-ownership"
            assert not set(held) & set(cache._free)
            assert len(held) + cache.n_free_blocks == cache.n_blocks

    def stats(self) -> dict:
        return {"pending": len(self.pending),
                "running": len(self.running),
                "finished": len(self.finished)}
