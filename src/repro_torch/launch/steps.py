"""The step functions of every (arch x shape) cell, and the
serving and training policies (port of ``repro.launch.steps``).

train_4k builds the train step (bf16 exact compute — the paper trains
in float); prefill/decode shapes build serve steps with the quantized
approximate-multiplier backend (the accelerator being modelled), the
low-rank emulation by default (DESIGN.md §4.2).

Where the reference's ``jax.eval_shape`` gives ``ShapeDtypeStruct``
trees, a cell's ``args_sds`` holds tensors on the ``meta`` device
(shapes and dtypes, no memory): ``registry.abstract_params``,
``init_cache(..., "meta")``, ``shapes.batch_specs(meta=True)``.  The
train step is ``train.loop.make_train_step`` over ``init_opt_state``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..approx.layers import ApproxPolicy
from ..approx.specs import BackendSpec
from ..configs import get_config
from ..configs.shapes import SHAPES, ShapeSpec, batch_specs
from ..models.common import LMConfig
from ..models.registry import abstract_params, model_fns
from ..train.loop import make_train_step, value_and_grad
from ..train.optimizer import OptimizerConfig, adamw_update, init_opt_state
from .mesh import tree_with_paths

META = torch.device("meta")


def train_policy() -> ApproxPolicy:
    return ApproxPolicy(default=BackendSpec(mode="bf16").materialize())


def pick_case_multiplier(library=None) -> str:
    """Deterministic pick: the Pareto(power x MAE) multiplier nearest 75%
    relative power — the paper's 'interesting' regime (Table II).
    Memoized for the default library."""
    if library is None:
        return _pick_default_case_multiplier()
    return _pick_case_multiplier(library)


@functools.lru_cache(maxsize=1)
def _pick_default_case_multiplier() -> str:
    from ..core.library import get_default_library
    return _pick_case_multiplier(get_default_library())


def _pick_case_multiplier(lib) -> str:
    front = lib.pareto_front("multiplier", 8, "mae")
    cands = [e for e in front if e.source != "exact"]
    if not cands:
        return "mul8u_exact"
    return min(cands, key=lambda e: abs(e.rel_power - 0.75)).name


def serve_policy(multiplier: str = "auto", mode: str = "lowrank",
                 rank: Optional[int] = 4,
                 variant: str = "pallas") -> ApproxPolicy:
    """The serve path's policy: every projection on the approximate
    ``multiplier`` (``"auto"``: ``pick_case_multiplier``) under ``mode``,
    rank 4 by default.  ``variant="pallas"`` (the default, as in
    ``case_study.run``) runs the CUDA kernels — K9 for ``lowrank``;
    ``"ref"`` the plain PyTorch datapath.  bf16 and int8 ignore the
    multiplier."""
    if mode in ("bf16", "int8"):
        return ApproxPolicy(default=BackendSpec(mode=mode).materialize())
    name = pick_case_multiplier() if multiplier == "auto" else multiplier
    spec = BackendSpec(mode=mode, multiplier=name, rank=rank,
                       variant=variant)
    return ApproxPolicy(default=spec.materialize())


@dataclass
class CellSpec:
    arch: str
    shape: ShapeSpec
    cfg: LMConfig
    kind: str                  # train | prefill | decode | opt
    step_fn: Callable
    args_sds: tuple            # meta tensors: the step's arguments
    donate: tuple
    microbatches: int = 1
    prepared_with: Any = None  # the lowrank backend of a prepared tree


def _microbatches(cfg: LMConfig, shape: ShapeSpec, dp: int) -> int:
    return max(1, shape.global_batch // dp)


def _mb_specs(specs: dict, n_mb: int) -> dict:
    """Batch leaves (B, ...) -> (n_mb, B / n_mb, ...) on ``meta``."""
    out = {}
    for k, v in specs.items():
        b = v.shape[0]
        assert b % n_mb == 0, (k, tuple(v.shape), n_mb)
        out[k] = torch.empty((n_mb, b // n_mb) + tuple(v.shape[1:]),
                             dtype=v.dtype, device=META)
    return out


def apply_overrides(cfg: LMConfig, overrides) -> LMConfig:
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in (True, "true", "True", "1")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _serve_params(cfg: LMConfig, prepared: bool, serve_mult: str,
                  serve_rank: Optional[int], variant: str) -> tuple:
    """(the parameter tree on ``meta``, the backend it was prepared
    with): with ``prepared`` every projection weight in its ``lowrank``
    prepared form, else the backend is None."""
    params = abstract_params(cfg)
    if not prepared:
        return params, None
    from ..approx.backend import prepare_tree
    be = serve_policy(serve_mult, "lowrank", serve_rank, variant).default
    return prepare_tree(params, be), be


def _cache(cfg: LMConfig, shape: ShapeSpec) -> dict:
    return model_fns(cfg).init_cache(cfg, shape.global_batch,
                                     shape.seq_len, META)


def _serve_step(cfg: LMConfig, kind: str, policy: ApproxPolicy):
    fns = model_fns(cfg)
    if kind == "prefill":
        def prefill_step(params, batch, cache):
            return fns.forward_prefill(params, batch, cache, cfg, policy)
        return prefill_step

    def decode_step(params, token, cache):
        return fns.forward_decode(params, token, cache, cfg, policy)
    return decode_step


def build_cell(arch: str, shape_name: str, dp_size: int,
               serve_mult: str = "auto",
               serve_mode: str = "lowrank",
               overrides=None, serve_rank: Optional[int] = 4,
               variant: str = "pallas") -> CellSpec:
    """The cell's step and its arguments on ``meta``.  ``variant`` is
    the serve policy's (``"pallas"``: K9 for ``lowrank`` on the card;
    on ``meta`` every kernel wrapper takes its shape-only plain
    version)."""
    cfg = apply_overrides(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    fns = model_fns(cfg)
    prepared = serve_mode == "lowrank_prepared"
    if prepared:
        serve_mode = "lowrank"
    params_sds, be = _serve_params(cfg, prepared and shape.kind != "train",
                                   serve_mult, serve_rank, variant)

    if shape.kind == "train":
        policy = train_policy()
        n_mb = _microbatches(cfg, shape, dp_size)

        def loss_fn(params, mb):
            return fns.forward_train(params, mb, cfg, policy)

        step = make_train_step(loss_fn, OptimizerConfig(),
                               microbatches=n_mb)
        opt_sds = init_opt_state(params_sds)
        bspecs = _mb_specs(batch_specs(cfg, shape, meta=True), n_mb)
        return CellSpec(arch, shape, cfg, "train", step,
                        (params_sds, opt_sds, bspecs), donate=(0, 1),
                        microbatches=n_mb)

    policy = serve_policy(serve_mult, serve_mode, serve_rank, variant)
    step = _serve_step(cfg, shape.kind, policy)
    bspecs = batch_specs(cfg, shape, meta=True)
    if shape.kind == "prefill":
        return CellSpec(arch, shape, cfg, "prefill", step,
                        (params_sds, bspecs, _cache(cfg, shape)),
                        donate=(2,), prepared_with=be)
    # decode: one token against a cache of seq_len
    return CellSpec(arch, shape, cfg, "decode", step,
                    (params_sds, bspecs["token"], _cache(cfg, shape)),
                    donate=(2,), prepared_with=be)


# ----------------------------------------------------------------------
# Analysis probes.  The reference's cost analysis does not scale loop
# bodies by trip count, so it compiles unrolled shallow variants at two
# depths (d1 = one block period, d2 = two periods) and extrapolates
# linearly — exact for depth-homogeneous stacks:
#   step(L)    = fixed + per_period * (L / period)
#   per_period = probe(d2) - probe(d1);  fixed = probe(d1) - per_period
#   train      = n_microbatches * step(L) + optimizer_probe
# The port counts the ops a probe runs, which is exact at any depth; it
# keeps the probes so both packages extrapolate the same way, and so a
# probe is small enough to run for real on one card.
# ----------------------------------------------------------------------
@dataclass
class ProbeSpec:
    name: str            # stack_d1 | stack_d2 | opt
    step_fn: Callable
    args_sds: tuple
    cell: "CellSpec"
    depth: int = 0       # layers in this probe (0 = n/a)


def _depth_cfg(cfg: LMConfig, n_layers: int) -> LMConfig:
    updates = dict(n_layers=n_layers, scan_unroll=True)
    if cfg.family == "encdec":
        # scale encoder proportionally so both stacks extrapolate
        frac = n_layers / cfg.n_layers
        updates["n_enc_layers"] = max(1, round(cfg.n_enc_layers * frac))
    return dataclasses.replace(cfg, **updates)


def block_period(cfg: LMConfig) -> int:
    """Layers in one block period (an encdec's stacks extrapolate layer
    by layer)."""
    from ..models.decoder import block_pattern
    return len(block_pattern(cfg)) if cfg.family != "encdec" else 1


def build_probes(arch: str, shape_name: str, dp_size: int,
                 serve_mult: str = "auto",
                 serve_mode: str = "lowrank",
                 overrides=None,
                 serve_rank: Optional[int] = 4,
                 variant: str = "pallas") -> list[ProbeSpec]:
    base_cfg = apply_overrides(get_config(arch), overrides)
    if (base_cfg.first_dense
            or len(base_cfg.held_experts) != base_cfg.n_experts):
        raise NotImplementedError(
            f"{arch}: the probes cut the depth in block periods and hold "
            "every expert, so leading dense layers or a share of the "
            "experts would be extrapolated as another model")
    shape = SHAPES[shape_name]
    period = block_period(base_cfg)
    prepared = serve_mode == "lowrank_prepared"
    if prepared:
        serve_mode = "lowrank"
    probes: list[ProbeSpec] = []

    for name, depth in (("stack_d1", period), ("stack_d2", 2 * period)):
        cfg = _depth_cfg(base_cfg, depth)
        fns = model_fns(cfg)
        params_sds, be = _serve_params(
            cfg, prepared and shape.kind != "train", serve_mult,
            serve_rank, variant)
        if shape.kind == "train":
            policy = train_policy()
            n_mb = _microbatches(cfg, shape, dp_size)

            def fwdbwd(params, mb, _fns=fns, _cfg=cfg, _policy=policy):
                return value_and_grad(
                    lambda p, b: _fns.forward_train(p, b, _cfg, _policy),
                    params, mb)

            mb_specs = {k: torch.empty((v.shape[0] // n_mb,)
                                       + tuple(v.shape[1:]),
                                       dtype=v.dtype, device=META)
                        for k, v in batch_specs(cfg, shape,
                                                meta=True).items()}
            cell = CellSpec(arch, shape, cfg, "train", fwdbwd,
                            (params_sds, mb_specs), donate=(),
                            microbatches=n_mb)
            probes.append(ProbeSpec(name, fwdbwd, (params_sds, mb_specs),
                                    cell, depth))
        else:
            policy = serve_policy(serve_mult, serve_mode, serve_rank,
                                  variant)
            serve_fn = _serve_step(cfg, shape.kind, policy)
            bspecs = batch_specs(cfg, shape, meta=True)
            args = ((params_sds, bspecs, _cache(cfg, shape))
                    if shape.kind == "prefill"
                    else (params_sds, bspecs["token"], _cache(cfg, shape)))
            cell = CellSpec(arch, shape, cfg, shape.kind, serve_fn, args,
                            donate=(), prepared_with=be)
            probes.append(ProbeSpec(name, serve_fn, args, cell, depth))

    if shape.kind == "train":
        # optimizer probe at FULL depth (single cheap pass over params)
        params_sds = abstract_params(base_cfg)
        opt_sds = init_opt_state(params_sds)
        opt_cfg = OptimizerConfig()

        def opt_step(params, grads, opt_state):
            return adamw_update(params, grads, opt_state, opt_cfg)

        grads_sds = _like_f32(params_sds)
        opt_cell = CellSpec(arch, shape, base_cfg, "opt", opt_step,
                            (params_sds, grads_sds, opt_sds), donate=())
        probes.append(ProbeSpec("opt", opt_step,
                                (params_sds, grads_sds, opt_sds),
                                opt_cell, 0))
    return probes


def _like_f32(tree):
    if isinstance(tree, dict):
        return {k: _like_f32(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=torch.float32, device=META)


# ----------------------------------------------------------------------
# Model-FLOPs accounting (roofline "useful compute" numerator)
# ----------------------------------------------------------------------
def param_count(params_sds, cfg: LMConfig) -> tuple[int, int]:
    """(total, active) parameter counts; active scales expert leaves by
    top_k/n_experts and excludes embedding/unembedding tables.
    Prepared-weight trees count the logical (K,N) weight once — the
    R-stacked tables are an emulation artifact, not model parameters."""
    paths, leaves = tree_with_paths(params_sds)
    total = active = 0
    for key, leaf in zip(paths, leaves):
        last = key.split("/")[-1]
        if last in ("colsum", "w_scale", "w_zp"):
            continue
        shape = tuple(leaf.shape)
        if last == "tabs":   # (..., R, K, N) -> logical K*N weight
            n = math.prod(shape[:-3]) * math.prod(shape[-2:])
            key = "/".join(key.split("/")[:-1])  # classify by parent
        else:
            n = math.prod(shape)
        total += n
        if key.split("/")[-1] in ("embed", "unembed"):
            continue
        is_expert = (("ffn_" in key or "moe" in key) and len(shape) >= 3
                     and cfg.n_experts > 0
                     and shape[-3] == len(cfg.held_experts))
        if is_expert:
            active += int(n * cfg.top_k / cfg.n_experts)
        else:
            active += n
    return total, active


def model_flops(cell: CellSpec, params_sds) -> float:
    """6·N_active·tokens for training, 2·N_active·tokens for serving."""
    _, n_active = param_count(params_sds, cell.cfg)
    if cell.kind == "train":
        tokens = cell.shape.global_batch * cell.shape.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.shape.global_batch * cell.shape.seq_len
        return 2.0 * n_active * tokens
    tokens = cell.shape.global_batch * 1
    return 2.0 * n_active * tokens
