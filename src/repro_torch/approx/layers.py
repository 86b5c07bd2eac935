"""Layer-level integration: injection policy + approx dense/conv (port
of ``repro.approx.layers``).

``ApproxPolicy`` maps layer-name glob patterns to backends — the unit of
the paper's resilience analysis.  Models route every projection through
``policy.matmul(name, x, w)`` and report their multiplication counts
per layer for the power model.  ``to_json``/``from_json`` round-trip the
policy as specs, in the reference's JSON form.

Activations may carry a leading *bank lane* axis (``bank_eval``): an
NHWC activation of rank 5 is ``(n, B, H, W, C)``.  Layers pass
``lanes=True`` to ``policy.matmul`` for such tensors.
"""
from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import device_key
from .backend import (BackendLike, MatmulBackend, as_backend,
                      backend_matmul)
from .registry import get_datapath
from .specs import (BackendSpec, LutBank, MaterializedBackend, PolicyBank,
                    canonicalize)


def spec_of(backend: BackendLike) -> BackendSpec:
    """Serializable spec of any backend handle (legacy backends describe
    themselves via ``MatmulBackend.to_spec``)."""
    if backend is None:
        return BackendSpec()
    if isinstance(backend, BackendSpec):
        return backend
    if isinstance(backend, MaterializedBackend):
        return backend.spec
    if isinstance(backend, MatmulBackend):
        return backend.to_spec()
    raise TypeError(f"not a backend: {type(backend).__name__}")


@dataclass
class ApproxPolicy:
    """default backend + per-layer-pattern overrides (fnmatch globs,
    first match wins)."""
    default: BackendLike = field(default_factory=BackendSpec)
    overrides: list[tuple[str, BackendLike]] = field(default_factory=list)

    def backend_for(self, name: str) -> BackendLike:
        for pat, be in self.overrides:
            if fnmatch.fnmatch(name, pat):
                return be
        return self.default

    def matmul(self, name: str, x: torch.Tensor, w: torch.Tensor,
               lanes: bool = False) -> torch.Tensor:
        return backend_matmul(x, w, self.backend_for(name), lanes=lanes)

    def with_override(self, pattern: str, backend: BackendLike
                      ) -> "ApproxPolicy":
        return ApproxPolicy(default=self.default,
                            overrides=[(pattern, backend)]
                            + list(self.overrides))

    # -- spec-first API -------------------------------------------------
    def materialize(self, library=None) -> "ApproxPolicy":
        """Bind every entry to ``library`` via the materialization cache
        so repeated evals of equal policies share backend objects."""
        def mat(be: BackendLike) -> MaterializedBackend:
            if isinstance(be, MaterializedBackend):
                return be
            if isinstance(be, MatmulBackend):
                # preserve hand-attached arrays instead of rebuilding
                # by multiplier name from the library
                return as_backend(be)
            return spec_of(be).materialize(library)
        return ApproxPolicy(
            default=mat(self.default),
            overrides=[(p, mat(be)) for p, be in self.overrides])

    def cache_key(self) -> tuple:
        """Hashable identity of this policy: spec-level (canonicalized
        per datapath) for specs and canonical backends; other backends
        are salted with the backend object itself."""
        def key_of(be: BackendLike):
            spec = canonicalize(spec_of(be))
            if isinstance(be, MaterializedBackend) and not be.canonical:
                return (spec, be)
            if isinstance(be, MatmulBackend) and (
                    be.lut is not None or be.factors_u is not None):
                return (spec, be)
            return spec
        return (key_of(self.default),
                tuple((p, key_of(be)) for p, be in self.overrides))

    # -- serialization --------------------------------------------------
    def to_json_dict(self) -> dict:
        return {
            "default": spec_of(self.default).to_dict(),
            "overrides": [[p, spec_of(be).to_dict()]
                          for p, be in self.overrides],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @staticmethod
    def from_json_dict(d: dict) -> "ApproxPolicy":
        return ApproxPolicy(
            default=BackendSpec.from_dict(d["default"]),
            overrides=[(p, BackendSpec.from_dict(s))
                       for p, s in d.get("overrides", [])])

    @staticmethod
    def from_json(s: Union[str, dict]) -> "ApproxPolicy":
        if isinstance(s, str):
            s = json.loads(s)
        return ApproxPolicy.from_json_dict(s)


EXACT_POLICY = ApproxPolicy(default=BackendSpec(mode="f32"))


# ----------------------------------------------------------------------
# Banked evaluation — the batched resilience engine's core
# (DESIGN.md §2.4)
# ----------------------------------------------------------------------
def _check_bank_variant(bank: LutBank, variant: str) -> None:
    """A mixed-reduce bank encodes per-lane shift/add trees, which only
    the runtime-tree fused kernels select per lane; the static-tree
    variants would silently run every lane under one tree."""
    if bank.is_mixed_reduce and variant != "fused":
        raise ValueError(
            f"bank mixes reduction trees ({sorted(set(bank.reduces))}); "
            f"the {variant!r} variant runs one static tree — run "
            "mixed-reduce banks under variant='fused'")


def bank_backend(bank: LutBank, mode: str = "lut",
                 variant: str = "ref") -> MaterializedBackend:
    """A banked backend: the ``mode``/``variant`` datapath with every
    LUT of ``bank`` at once (one lane per bank entry).  A bank with
    composed wide lanes also carries each lane's operand width, product
    mask and reduce code (the reference's ``_bank_lane_backend``), so
    one call mixes 8-bit and 12/16-bit lanes.  ``ste=False``: banked
    evaluation is forward-only."""
    _check_bank_variant(bank, variant)
    name = mode if variant == "ref" else f"{mode}_{variant}"
    dp = get_datapath(name)
    if not dp.bankable:
        raise ValueError(f"datapath {name!r} is not bankable")
    spec = BackendSpec(mode=mode, multiplier="<bank>",
                       block_m=bank.block_m, ste=False, variant=variant)
    return MaterializedBackend(spec=spec, datapath=dp,
                               consts=dp.bank_consts(bank))


def bank_eval(fn, bank: LutBank, *, mode: str = "lut",
              variant: str = "ref",
              base: Optional[BackendLike] = None,
              layer_pattern: Optional[str] = None,
              sharding=None) -> dict:
    """Evaluate ``fn(policy)`` for every multiplier in ``bank`` in ONE
    pass of the model, with a lane axis written out (the port of the
    reference's ``jit(vmap(...))`` over the bank).

    ``fn`` is called once, with a policy whose swept entry is a banked
    backend (``bank_backend``): every approximated matmul then runs the
    whole bank through one banked datapath call — one launch of the
    banked CUDA kernel per layer under ``variant="pallas"`` (K2) or
    ``"fused"`` (K4, or K8 for a bank with wide lanes).

      * ``layer_pattern=None`` — the banked backend is the policy
        default (all-layers sweep, Table II);
      * ``layer_pattern='s1_b0_conv1'`` — only that layer is banked and
        the rest run ``base`` (per-layer sweep, Fig. 4; default golden
        int8).  Layers before the banked one carry no lane axis and are
        computed once, as in the reference.

    ``fn`` must return a dict of tensors whose leading axis is the lane
    axis (scalars are broadcast to every lane).  Returns that dict with
    each value of shape ``(n_mult, ...)``; lane ``i`` equals the
    sequential evaluation of ``bank.spec(i, mode, variant)``.

    ``sharding`` (``launch.mesh.bank_sharding``) splits the lanes across
    the devices of its mesh (``sharded_lanes``): each shard runs ``fn``
    once on its device with a banked backend over its slice of the bank
    — the slice's tables and, for a wide bank, its lanes' widths, masks
    and reduce codes (the bank's datapath and static tree stay the whole
    bank's) — so each banked call launches its kernel once a shard with
    that shard's lanes.  A count the mesh does not divide runs whole on
    the first device.
    """
    mb = bank_backend(bank, mode, variant)
    if layer_pattern is not None and base is None:
        base = BackendSpec.golden().materialize()

    def run(f, start: int, stop: int) -> dict:
        sub = (mb if (start, stop) == (0, bank.n_mult)
               else _lane_slice(mb, start, stop))
        if layer_pattern is None:
            policy = ApproxPolicy(default=sub)
        else:
            policy = ApproxPolicy(default=as_backend(base),
                                  overrides=[(layer_pattern, sub)])
        return _lane_outputs(f, policy, stop - start)

    if sharding is None:
        return run(fn, 0, bank.n_mult)
    return sharded_lanes(fn, bank.n_mult, sharding.shards(bank.n_mult),
                         run)


def _lane_slice(mb: MaterializedBackend, start: int,
                stop: int) -> MaterializedBackend:
    """Lanes ``start:stop`` of a banked backend: its per-lane constants
    (``_LANE_CONSTS``) sliced on the host, so only the slice moves to a
    device; everything else (datapath, static tree, block size) is the
    whole bank's."""
    return MaterializedBackend(
        spec=mb.spec, datapath=mb.datapath,
        consts={k: (v[start:stop] if k in _LANE_CONSTS else v)
                for k, v in mb.consts.items()})


def sharded_lanes(fn, n: int, shards, run) -> dict:
    """A lane-split evaluation: ``run(form, start, stop)`` for each
    ``(device, start, stop)`` of ``shards`` (a ``NamedSharding.
    shards(n)``), one process driving every device.  ``form`` is
    ``fn.on_device(device)`` where ``fn`` has a per-device form (a
    ``Workload`` adapter's tensor core, ``workload.DeviceForms``), else
    ``fn`` itself.
    Every shard's launches are queued on its device's current stream
    before any result is read, so distinct cards overlap; then the
    outputs are concatenated on the first shard's device in lane order.
    Raises when a shard's outputs are not on its device (``fn`` read
    tensors of another device and has no per-device form)."""
    per_device = getattr(fn, "on_device", None)
    outs = []
    for dev, start, stop in shards:
        out = run(fn if per_device is None else per_device(dev), start,
                  stop)
        for k, v in out.items():
            if device_key(v.device) != device_key(dev):
                raise RuntimeError(
                    f"shard {start}:{stop} on {dev}: output {k!r} is on "
                    f"{v.device}; fn reads tensors of another device — "
                    "give it a per-device form (on_device), as the "
                    "Workload adapters have")
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    first = shards[0][0]
    return {k: torch.cat([o[k].to(first) for o in outs])
            for k in outs[0]}


def _lane_outputs(fn, policy: ApproxPolicy, n: int) -> dict:
    """``fn(policy)`` without autograd, each output with its leading lane
    axis of ``n`` (scalars broadcast to every lane)."""
    with torch.inference_mode():
        out = fn(policy)
    return {k: (v.expand(n) if v.ndim == 0 else v) for k, v in out.items()}


# ----------------------------------------------------------------------
# Heterogeneous per-layer evaluation (DESIGN.md §2.5)
# ----------------------------------------------------------------------
#: Banked constants with one entry per bank lane (leading axis): a
#: layer of a policy bank gathers them by its assignment column.
_LANE_CONSTS = ("luts", "luts16", "bits", "masks", "reduce_codes")


@dataclass(frozen=True, eq=False)
class AssignedBankBackend(MaterializedBackend):
    """One layer of a policy bank as a banked backend: lane ``p`` runs
    table ``index[p]`` of the banked backend ``source`` over the whole
    bank.  Its per-lane constants (``_LANE_CONSTS``) are gathered on the
    device from ``source``'s, which every layer shares, so the bank moves
    to a device once (``index_select``: contiguous, dtype kept, so the
    kernels read the uint16 tables as ``lut_to_uint16`` packed them)."""

    source: Optional[MaterializedBackend] = None
    index: Optional[np.ndarray] = None          # (n_policies,) int64

    @property
    def lanes(self) -> int:
        return len(self.index)

    def device_consts(self, device: torch.device) -> dict:
        key = str(device)
        out = self._on_device.get(key)
        if out is None:
            idx = torch.from_numpy(self.index).to(device)
            out = {k: (v.index_select(0, idx) if k in _LANE_CONSTS else v)
                   for k, v in self.source.device_consts(device).items()}
            self._on_device[key] = out
        return out


def bank_assignment_overrides(bank: LutBank, assign, layers, *,
                              mode: str = "lut", variant: str = "ref",
                              source: Optional[MaterializedBackend] = None
                              ) -> list[tuple[str, MaterializedBackend]]:
    """Per-layer policy overrides for every policy lane at once: layer
    ``layers[j]`` runs one banked backend whose lane ``p`` is table
    ``assign[p, j]`` of ``bank`` (``assign``: (n_policies, n_layers)
    indices into ``bank.names``).  The port's form of the reference's
    one-vmap-lane-per-policy overrides: each layer is one banked
    datapath call whatever the number of policies — K2 (8-bit) or K6
    (wide lanes) under ``pallas``, K4 or K8 under ``fused``.  The
    datapath choice and the mixed-reduce check are ``bank_backend``'s.
    ``source``: that banked backend, when the caller keeps one (its
    tables then move to a device once for every call that shares it)."""
    src = source if source is not None else bank_backend(bank, mode,
                                                         variant)
    assign = np.asarray(assign, dtype=np.int64)
    return [(layer, AssignedBankBackend(
        spec=src.spec, datapath=src.datapath, consts=src.consts,
        source=src, index=np.ascontiguousarray(assign[:, j])))
        for j, layer in enumerate(layers)]


def policy_for_lane(pbank: PolicyBank, p: int, *, mode: str = "lut",
                    variant: str = "ref",
                    base: Optional[BackendLike] = None) -> ApproxPolicy:
    """The sequential (serializable) policy lane ``p`` of a
    ``policy_bank_eval`` stands for: ``base`` (golden int8 by default)
    everywhere, with layer ``j`` overridden to multiplier
    ``pbank.bank.names[pbank.assign[p, j]]``.  Evaluating it equals lane
    ``p`` of the banked evaluation bit for bit."""
    base = base if base is not None else BackendSpec.golden().materialize()
    return ApproxPolicy(default=base,
                        overrides=pbank.spec_overrides(p, mode=mode,
                                                       variant=variant))


def policy_bank_eval(fn, pbank: PolicyBank, *, mode: str = "lut",
                     variant: str = "ref",
                     base: Optional[BackendLike] = None,
                     sharding=None, assign_sharding=None) -> dict:
    """Evaluate ``fn(policy)`` for every heterogeneous assignment row of
    ``pbank`` in ONE pass of the model — the per-layer generalization of
    ``bank_eval``.  Lane ``p`` runs multiplier
    ``pbank.bank.names[pbank.assign[p, j]]`` in layer ``pbank.layers[j]``
    (``bank_assignment_overrides``: one banked call a layer for all
    lanes); layers not named in ``pbank.layers`` run ``base`` (golden
    int8 by default), on lane-carrying activations after the first
    assigned layer and without a lane axis before it.

    ``fn`` and the result follow ``bank_eval``: a dict of tensors, each
    returned with a leading ``n_policies`` axis, lane ``p`` equal bit for
    bit to the sequential evaluation of ``policy_for_lane(pbank, p)``.

    ``assign_sharding`` (``launch.mesh.policy_sharding``) splits the
    assignment rows across its mesh's devices (``sharded_lanes``): each
    shard runs ``fn`` on its device over its rows, every layer one banked
    call with that shard's lanes.  Any lane may gather any table, so
    every shard holds the whole bank: ``sharding`` (the bank's, the
    reference's placement of its tables) names the mesh, and without
    ``assign_sharding`` the rows run whole on its first device.
    """
    if base is None:
        base = BackendSpec.golden().materialize()
    base = as_backend(base)
    src = bank_backend(pbank.bank, mode, variant)

    def run(f, start: int, stop: int) -> dict:
        policy = ApproxPolicy(
            default=base,
            overrides=bank_assignment_overrides(
                pbank.bank, pbank.assign[start:stop], pbank.layers,
                mode=mode, variant=variant, source=src))
        return _lane_outputs(f, policy, stop - start)

    n = pbank.n_policies
    if assign_sharding is not None:
        shards = assign_sharding.shards(n)
    elif sharding is not None:
        shards = [(sharding.shards(n)[0][0], 0, n)]
    else:
        return run(fn, 0, n)
    return sharded_lanes(fn, n, shards, run)


def per_lane(fn, x: torch.Tensor, lanes: bool) -> torch.Tensor:
    """``fn`` applied to each lane of ``x`` and stacked (``fn(x)`` when
    ``x`` has no lane axis).  Float reductions go through this so each
    lane reduces a tensor of the unbanked shape, in the same order as
    the sequential evaluation: banked and sequential results then agree
    bit for bit."""
    if not lanes:
        return fn(x)
    return torch.stack([fn(x[i]) for i in range(x.shape[0])])


def dense(policy: ApproxPolicy, name: str, x: torch.Tensor,
          w: torch.Tensor, b: Optional[torch.Tensor] = None,
          lanes: bool = False) -> torch.Tensor:
    y = policy.matmul(name, x, w, lanes=lanes)
    if b is not None:
        y = y + b
    return y


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of ``jax.lax``'s SAME convention (the extra
    row/column goes high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(policy: ApproxPolicy, name: str, x: torch.Tensor,
           w: torch.Tensor, stride: int = 1, padding: str = "SAME",
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC conv via im2col + backend matmul, so the multiplier
    emulation covers convolutions exactly as TFApprox's AxConv2D does.

    x: (B,H,W,Cin), or (n,B,H,W,Cin) with a bank lane axis;
    w: (kh,kw,Cin,Cout).  Patch features are ordered (cin, kh, kw) as
    ``jax.lax.conv_general_dilated_patches`` orders them."""
    kh, kw, cin, cout = w.shape
    lanes = x.ndim == 5
    lead = x.shape[:-3]
    h, wd = x.shape[-3], x.shape[-2]
    if padding == "SAME":
        pt, pb = _same_pads(h, kh, stride)
        pl, pr = _same_pads(wd, kw, stride)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"unsupported padding {padding!r}")
    ho = conv_output_size(h, kh, stride, padding)
    wo = conv_output_size(wd, kw, stride, padding)
    feat = cin * kh * kw
    # windows as a strided view (..., ho, wo, cin, kh, kw), copied once
    # into rows of (cin, kh, kw) features
    windows = x.unfold(-3, kh, stride).unfold(-3, kw, stride)
    patches = windows.reshape(*lead[:1 if lanes else 0], -1, feat)
    w2d = w.permute(2, 0, 1, 3).reshape(feat, cout)
    y = policy.matmul(name, patches, w2d, lanes=lanes)
    y = y.reshape(*y.shape[:-2], lead[-1], ho, wo, cout)
    if b is not None:
        y = y + b
    return y


def conv_output_size(size: int, kernel: int, stride: int,
                     padding: str) -> int:
    """Spatial output size matching ``jax.lax`` conv semantics."""
    if padding == "SAME":
        return -(-size // stride)                 # ceil(size / stride)
    if padding == "VALID":
        if size < kernel:
            return 0
        return (size - kernel) // stride + 1
    raise ValueError(f"unsupported padding {padding!r}")


def conv_mult_count(x_shape, w_shape, stride: int = 1,
                    padding: str = "SAME") -> int:
    """Number of scalar multiplications in this conv (power model),
    for the output dims ``conv2d`` actually produces."""
    bsz, h, w_, cin = x_shape
    kh, kw, _, cout = w_shape
    ho = conv_output_size(h, kh, stride, padding)
    wo = conv_output_size(w_, kw, stride, padding)
    return bsz * ho * wo * kh * kw * cin * cout


def dense_mult_count(x_shape, w_shape) -> int:
    m = 1
    for d in x_shape[:-1]:
        m *= d
    k, n = w_shape
    return m * k * n
