"""Paged/blocked KV cache for continuous batching (port of
``repro.serve.kv_cache``, DESIGN.md §2.8).

The contiguous per-request caches the model builds
(``init_cache(cfg, batch, max_len)``) don't compose into a multi-tenant
server: a request's cache is sized to ITS max length.  This module
virtualizes the *sequence* axis instead, vLLM-style:

  * ``cache_layout`` probes the cache tree structurally — it
    initializes it on the ``meta`` device (no memory) at two capacities
    and marks, per leaf, the axis whose extent changed as the sequence
    (T) axis.  No per-family code: attention k/v ``(G, B, T, H, D)``,
    MLA's latent ``ckv`` ``(G, B, T, kv_lora)`` and ``kr``, and the
    encoder-decoder's self k/v ``(L, B, T, H, D)`` find their T axis;
    a mamba slot's ``conv``/``state``, the encoder-decoder's cross-KV
    and ``pos`` (a host int in the port) are dense leaves.
  * Sequence leaves live in fixed-size-block *pools* shaped
    ``(n_blocks * block_size, *rest)`` (T axis moved to the front);
    a free-list allocator hands blocks to requests, and a per-slot
    block table maps logical position → physical pool row.  A family
    without sequence leaves (pure SSM) has no pools and takes zero
    blocks a request.
  * Dense leaves live in a slot-major store: ``(n_slots, *shape)``
    tensors at the dtype the model carries (a prefill's), and host int
    leaves in ``(n_slots,)`` numpy arrays.

The engine's decode step sees the running slots through ``LaneCaches``:
each slot's logical view ``pool[block_table[t // bs] * bs + t % bs]``
of a sequence leaf (``slot_rows``, ``read_rows``), the one new row each
running slot writes (``write_rows``), and each slot's dense rows, whose
new values (a mamba slot's conv and SSM state) are written back after
the step for the slots that ran only — the reference's ``keep_active``.
Inactive slots are not run at all, so no write ever carries the
negative row of an unallocated table entry (which would wrap to the
last pool row, in torch as in JAX).

A slot's pool rows are zeroed when its blocks are allocated, so a view
reads zeros past the request's position, as the contiguous cache
``generate`` allocates does, never another request's rows.  Attention
masks those rows with a -1e30 bias (exact zeros after softmax); MLA's
latent expansion takes the whole view into its calibration, where zero
rows leave the range alone (``approx.quant.calibrate`` clamps lo <= 0 <=
hi) and stale ones would not.

Pools are created and written under ``torch.inference_mode()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..models.common import causal_bias


def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    dict order) and its structure (the dict with ``None`` leaves)."""
    if isinstance(tree, dict):
        leaves, struct = [], {}
        for key in sorted(tree):
            sub, struct[key] = tree_flatten(tree[key])
            leaves += sub
        return leaves, struct
    return [tree], None


def tree_unflatten(struct, leaves):
    it = iter(leaves)

    def build(s):
        return next(it) if s is None else {k: build(v)
                                           for k, v in s.items()}

    return build(struct)


def _leaf_paths(struct, prefix: tuple = ()) -> list[tuple]:
    if struct is None:
        return [prefix]
    return [p for k, v in struct.items()
            for p in _leaf_paths(v, prefix + (k,))]


def _shape_dtype(leaf) -> tuple[tuple, Any]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return (), None                     # host int (the port's ``pos``)


@dataclass(frozen=True)
class CacheLayout:
    """Structural description of ONE request's cache tree: structure +
    per-leaf shape/dtype (dtype ``None`` = a host int), with the
    sequence axis identified per leaf (None = non-sequence leaf) and
    each leaf's key path.  ``capacity`` is the probed max_len — every
    slot's logical sequence space."""

    treedef: Any
    shapes: tuple
    dtypes: tuple
    seq_axes: tuple          # per leaf: T-axis index, or None
    capacity: int
    paths: tuple = ()

    @property
    def seq_positions(self) -> tuple:
        return tuple(i for i, t in enumerate(self.seq_axes)
                     if t is not None)

    @property
    def dense_positions(self) -> tuple:
        return tuple(i for i, t in enumerate(self.seq_axes) if t is None)


def cache_layout(fns, cfg, capacity: int) -> CacheLayout:
    """Probe ``fns.init_cache``'s tree for the sequence axes by
    double-initialization at ``capacity`` and ``capacity+1`` on the
    ``meta`` device: the axis whose extent differs is the T axis.  No
    cache is materialized."""
    la, treedef = tree_flatten(fns.init_cache(cfg, 1, capacity, "meta"))
    lb, treedef_b = tree_flatten(fns.init_cache(cfg, 1, capacity + 1,
                                                "meta"))
    if treedef != treedef_b:
        raise ValueError("init_cache structure depends on max_len; "
                         "cannot page this family")
    shapes, dtypes, seq_axes = [], [], []
    for xa, xb in zip(la, lb):
        (sa, da), (sb, _) = _shape_dtype(xa), _shape_dtype(xb)
        diff = [i for i, (p, q) in enumerate(zip(sa, sb)) if p != q]
        if len(diff) > 1:
            raise ValueError(
                f"cache leaf {sa} varies on {len(diff)} axes with "
                "max_len; paging supports exactly one sequence axis")
        shapes.append(sa)
        dtypes.append(da)
        seq_axes.append(diff[0] if diff else None)
    return CacheLayout(treedef=treedef, shapes=tuple(shapes),
                       dtypes=tuple(dtypes), seq_axes=tuple(seq_axes),
                       capacity=capacity,
                       paths=tuple(_leaf_paths(treedef)))


class PagedKVCache:
    """Block pools + dense store + free-list allocator + block tables.

    One instance serves all slots of a ``ContinuousEngine``, on one
    device (the CPU unless ``device`` says otherwise); a family with no
    sequence leaves (pure SSM: conv + state carry, O(1) decode) has
    zero pools and allocates zero blocks a request."""

    def __init__(self, fns, cfg, *, n_slots: int, capacity: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 device=None):
        self.layout = cache_layout(fns, cfg, capacity)
        self.n_slots = int(n_slots)
        self.block_size = int(block_size)
        self.blocks_per_slot = -(-capacity // block_size)   # ceil
        self.n_blocks = (int(n_blocks) if n_blocks is not None
                         else self.n_slots * self.blocks_per_slot)
        self.device = torch.device(device if device is not None
                                   else "cpu")
        rows = self.n_blocks * self.block_size
        lay = self.layout
        with torch.inference_mode():
            # pools: sequence leaves, T axis first, request dims kept
            self.pools = [
                torch.zeros((rows, *[d for i, d in enumerate(lay.shapes[p])
                                     if i != lay.seq_axes[p]]),
                            dtype=lay.dtypes[p], device=self.device)
                for p in lay.seq_positions]
            # dense store: one request-shaped row per slot
            self.dense = [
                np.zeros(self.n_slots, np.int64) if lay.dtypes[p] is None
                else torch.zeros((self.n_slots, *lay.shapes[p]),
                                 dtype=lay.dtypes[p], device=self.device)
                for p in lay.dense_positions]
        self.block_tables = np.full((self.n_slots, self.blocks_per_slot),
                                    -1, np.int32)
        self._free: list[int] = list(range(self.n_blocks))
        # a leaf's path (e.g. ``("mixer_0", "k")``) -> its index into
        # ``pools`` or ``dense``
        self.pool_index = {lay.paths[p]: i
                           for i, p in enumerate(lay.seq_positions)}
        self.dense_index = {lay.paths[p]: i
                            for i, p in enumerate(lay.dense_positions)}

    # -- allocator ------------------------------------------------------
    @property
    def n_free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, total_len: int) -> int:
        """Blocks to reserve for a request whose cache will hold
        ``total_len`` rows (prefill + all generated tokens — reserved
        up front so admission can never OOM mid-decode)."""
        if not self.layout.seq_positions:
            return 0
        if total_len > self.layout.capacity:
            raise ValueError(f"request needs {total_len} cache rows; "
                             f"engine capacity is {self.layout.capacity}")
        return -(-total_len // self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def allocate(self, slot: int, total_len: int) -> list[int]:
        n = self.blocks_needed(total_len)
        if not self.can_allocate(n):
            raise RuntimeError(
                f"paged KV exhausted: need {n} blocks, "
                f"{len(self._free)} free")
        if (self.block_tables[slot] >= 0).any():
            raise RuntimeError(f"slot {slot} already holds blocks")
        blocks = [self._free.pop(0) for _ in range(n)]
        self.block_tables[slot, :n] = blocks
        if blocks:
            # a released block keeps its last request's rows: zero them,
            # so the slot's view past its position reads zeros
            rows = (np.asarray(blocks)[:, None] * self.block_size
                    + np.arange(self.block_size)).reshape(-1)
            idx = torch.from_numpy(rows).to(self.device)
            with torch.inference_mode():
                for pool in self.pools:
                    pool[idx] = 0
        return blocks

    def release(self, slot: int) -> None:
        held = [int(b) for b in self.block_tables[slot] if b >= 0]
        self._free.extend(held)
        self.block_tables[slot] = -1

    def phys_indices(self, slot: int) -> np.ndarray:
        """(capacity,) physical rows for one slot (negative where
        unallocated)."""
        table = self.block_tables[slot]
        logical = np.arange(self.layout.capacity)
        return (table[logical // self.block_size] * self.block_size
                + logical % self.block_size).astype(np.int32)

    def slot_rows(self, slot: int, length: int) -> torch.Tensor:
        """The physical rows of a slot's first ``length`` logical
        positions, on the cache's device; every one must be allocated."""
        phys = self.phys_indices(slot)[:length]
        if length > len(phys) or (phys < 0).any():
            raise ValueError(f"slot {slot} has no allocated rows for "
                             f"positions < {length}")
        return torch.from_numpy(phys.astype(np.int64)).to(self.device)

    # -- data movement --------------------------------------------------
    def write_prefill(self, slot: int, cache, length: int) -> None:
        """Scatter a freshly prefilled request-shaped cache into this
        slot: the first ``length`` rows of each sequence leaf go to the
        slot's allocated pool rows, dense leaves overwrite the slot's
        dense-store row."""
        leaves, treedef = tree_flatten(cache)
        if treedef != self.layout.treedef:
            raise ValueError("prefill cache structure does not match "
                             "the probed layout")
        phys = self.slot_rows(slot, length) if self.pools else None
        pi, di = 0, 0
        with torch.inference_mode():
            for leaf, t in zip(leaves, self.layout.seq_axes):
                if t is None:
                    store = self.dense[di]
                    if (isinstance(leaf, torch.Tensor)
                            and store.dtype != leaf.dtype):
                        # the dtype the model carries: a mamba conv state,
                        # the working dtype in ``init_cache``, comes back
                        # in f32 from a prefill, and its decode carries it
                        # so; rounding it here would change the next step
                        self.dense[di] = store = store.to(leaf.dtype)
                    store[slot] = leaf
                    di += 1
                else:
                    self.pools[pi][phys] = torch.movedim(leaf, t,
                                                         0)[:length]
                    pi += 1

    def write_rows(self, pool: int, rows: torch.Tensor,
                   values: torch.Tensor, at: tuple = ()) -> None:
        """``pools[pool][rows[i]][at] = values[i]`` for every i: one new
        row per running slot (``rows`` from ``slot_rows``, never
        negative)."""
        with torch.inference_mode():
            dest = self.pools[pool]
            dest[(rows, *at)] = values.to(dest.dtype)

    def read_rows(self, pool: int, rows: torch.Tensor, at: tuple = ()
                  ) -> torch.Tensor:
        """``pools[pool][rows][:, *at]``, contiguous: one slot's logical
        view of a sequence leaf (``rows`` from ``slot_rows``)."""
        return self.pools[pool][(rows, *at)]

    def gather_slot(self, slot: int):
        """Eagerly rebuild one slot's full cache tree at ``capacity``
        rows (tests / debugging).  Unallocated rows read the last pool
        row clipped to, as the reference's gather does; attention masks
        them."""
        phys = np.clip(self.phys_indices(slot), 0,
                       self.n_blocks * self.block_size - 1)
        idx = torch.from_numpy(phys.astype(np.int64)).to(self.device)
        leaves, pi, di = [], 0, 0
        for t in self.layout.seq_axes:
            if t is None:
                d = self.dense[di][slot]
                leaves.append(int(d) if isinstance(d, np.integer) else d)
                di += 1
            else:
                leaves.append(torch.movedim(self.pools[pi][idx], 0, t))
                pi += 1
        return tree_unflatten(self.layout.treedef, leaves)

    def advance(self, slots) -> None:
        """One decode step of ``slots``: their host position leaves move
        on by one row (tensor dense leaves are written by the step's
        ``LaneCaches.commit``)."""
        for d in self.dense:
            if isinstance(d, np.ndarray):
                d[list(slots)] += 1

    def stats(self) -> dict:
        used = self.n_blocks - len(self._free)
        return {"n_blocks": self.n_blocks, "used_blocks": used,
                "free_blocks": len(self._free),
                "block_size": self.block_size,
                "n_pools": len(self.pools), "n_dense": len(self.dense)}


class LaneCaches:
    """The running slots' caches as one lane decode step sees them (a
    family's ``forward_decode_lanes``): lane ``i`` is slot ``slots[i]``,
    at position ``pos[i]`` (a host int), whose sequence leaves span
    ``rows[i]`` (``PagedKVCache.slot_rows`` of its ``total_len``, the
    rows of the cache ``generate`` allocates) and whose new rows go to
    pool row ``write[i]``.  A leaf is named by its cache path: a
    ``prefix`` (``("mixer_0",)``, ``("self",)``, ``("cross",)``), a leaf
    name and its layer group ``g``, the leading index of the leaf."""

    def __init__(self, kv: PagedKVCache, slots, pos, rows, write):
        self.kv, self.slots = kv, list(slots)
        self.pos = [int(p) for p in pos]
        self.rows, self.write = rows, write
        self._biases: dict = {}
        self._pending: list = []

    def bias(self, i: int) -> torch.Tensor:
        """Lane i's (1, T_i) causal mask at its position
        (``models.common.causal_bias``), made once a step."""
        if i not in self._biases:
            self._biases[i] = causal_bias(self.pos[i], 1,
                                          self.rows[i].numel(),
                                          self.kv.device)
        return self._biases[i]

    def rows_of(self, prefix: tuple, g: int, new: dict) -> list:
        """Write each lane's new row ``new[name][i, 0]`` (``new[name]``:
        (n, 1, ...)) of the sequence leaves ``prefix + (name,)``, group
        ``g``, at its position; returns each lane's views ``{name: (1,
        T_i, ...)}``, the new row included."""
        kv = self.kv
        pools = {name: kv.pool_index[prefix + (name,)] for name in new}
        for name, p in pools.items():
            kv.write_rows(p, self.write, new[name][:, 0], at=(g, 0))
        return [{name: kv.read_rows(p, r, (g, 0))[None]
                 for name, p in pools.items()} for r in self.rows]

    def state(self, prefix: tuple, g: int, names) -> list:
        """Each lane's dense rows ``{name: (1, ...)}`` of group ``g``
        (views of the dense store)."""
        kv = self.kv
        idx = {name: kv.dense_index[prefix + (name,)] for name in names}
        return [{name: kv.dense[d][slot, g] for name, d in idx.items()}
                for slot in self.slots]

    def update(self, prefix: tuple, g: int, new: list) -> None:
        """Each lane's new dense rows ``new[i] = {name: (1, ...)}`` of
        group ``g``, written by ``commit`` after the step."""
        self._pending.append((prefix, g, new))

    def commit(self) -> None:
        """Write the step's new dense rows into the running slots' rows
        of the dense store; every other slot's rows stay as they are."""
        kv = self.kv
        with torch.inference_mode():
            for prefix, g, new in self._pending:
                for slot, rows in zip(self.slots, new):
                    for name, value in rows.items():
                        kv.dense[kv.dense_index[prefix + (name,)]][
                            slot, g] = value
        self._pending.clear()
