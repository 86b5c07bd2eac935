"""Surrogate predict stage for the heterogeneous DSE (port of
``repro.approx.surrogate``, DESIGN.md §2.11).

The exact predict stage of ``explore_heterogeneous`` measures every
candidate circuit against every layer: O(n_layers x n_circuits)
evaluations.  This module replaces that sweep with the autoAx move
(Mrazek et al., 2019) in ApproxGNN's feature style (Vlcek & Mrazek,
2025): train a small model on a SUBSAMPLE of exact sweep rows, predict
per-layer quality for every other circuit from features the library
already carries, and keep the exact batched verification as the safety
net.

Three layers:

  * ``circuit_features`` / ``feature_matrix`` — a fixed-width float64
    vector per ``CircuitEntry``: the six error statistics (log-
    compressed), the cost axes, width/source tags and netlist-structure
    terms (active-gate histogram, logic depth, node count).  The
    structure-only block is the input of the learned COST head.
  * ``fit_surrogate`` — trains a small float32 MLP mapping a circuit's
    standardized features to its standardized per-layer quality-DROP
    vector, on any list of duck-typed per-layer rows
    (``.layer``/``.multiplier``/``.accuracy``).  The fit is full-batch
    Adam with the reference's update (an L2 term on the weight matrices
    added to the loss, eps outside the bias-corrected square root),
    written out by hand around ``torch.autograd.grad``.  On a CUDA
    device one step is captured as a CUDA graph and replayed ``epochs``
    times (the step counter lives on the device); on the CPU the same
    step runs eagerly.  A deterministic held-out split gives per-layer
    Spearman diagnostics and the CALIBRATION band the beam adds to its
    quality threshold.
  * ``surrogate_components`` — the drop-in predict stage: sweep a
    deterministic power-spread subset of the candidates exactly, fit,
    predict the rest, and return ``LayerComponents`` whose measured
    cells stay exact.  Power is the library's exact accounting.

Features, splits, standardization statistics, the initial weights and
the cost head are float64 numpy (the weights drawn from
``np.random.default_rng(seed)`` and cast to float32), equal to the
reference's bit for bit; the trained weights differ from the reference's
by float32 accumulation order only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.gates import N_FUNCS
from ..device import DeviceLike, resolve_device
from .power import auto_rel_power
from .ranking import spearman
from .resilience import LayerComponents, ResilienceRow, per_layer_sweep

# ----------------------------------------------------------------------
# Feature extraction
# ----------------------------------------------------------------------
_SOURCES = ("exact", "evolved", "truncation", "bam", "loa", "composed")

FEATURE_NAMES: tuple[str, ...] = (
    tuple(f"log1p_{m}" for m in
          ("er", "mae", "mse", "mre", "wce", "wcre"))
    + ("rel_power", "log1p_area", "log1p_delay")
    + ("width_over_8",)
    + tuple(f"src_{s}" for s in _SOURCES)
    + tuple(f"gate_frac_{f}" for f in range(N_FUNCS))
    + ("log1p_n_active", "log1p_depth", "n_i_over_16", "n_o_over_16")
)

# structure-only block (width/source/gates/depth/io): everything after
# the error statistics and cost axes — the cost head's input, since for
# an unseen circuit the error and cost reports are what does not exist
STRUCTURE_SLICE = slice(9, None)

# Adam's moment decays and eps (the reference's constants)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def circuit_features(entry) -> np.ndarray:
    """Fixed-width float64 feature vector for one ``CircuitEntry``, in
    ``FEATURE_NAMES`` order."""
    nl = entry.netlist
    n_active = nl.n_active()
    hist = nl.gate_histogram().astype(np.float64)
    frac = hist / max(n_active, 1)
    parts = [
        np.log1p(entry.errors.as_vector()),
        np.array([entry.rel_power,
                  np.log1p(entry.cost.area),
                  np.log1p(entry.cost.delay)]),
        np.array([entry.width / 8.0]),
        np.array([1.0 if entry.source == s else 0.0 for s in _SOURCES]),
        frac,
        np.array([np.log1p(n_active), np.log1p(nl.logic_depth()),
                  nl.n_i / 16.0, nl.n_o / 16.0]),
    ]
    vec = np.concatenate(parts)
    if vec.shape != (len(FEATURE_NAMES),):
        raise ValueError(f"feature vector of {entry.name!r} has shape "
                         f"{vec.shape}, want ({len(FEATURE_NAMES)},)")
    return vec


def feature_matrix(entries: Sequence) -> np.ndarray:
    """(n_entries, n_features) feature matrix."""
    return np.stack([circuit_features(e) for e in entries])


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SurrogateConfig:
    """Hyperparameters of the QoR surrogate: a small full-batch MLP with
    weight decay, sized for tens of training circuits and O(10)
    layers."""

    hidden: tuple[int, ...] = (32, 32)
    epochs: int = 1500
    lr: float = 1e-2
    weight_decay: float = 1e-4
    seed: int = 0
    val_fraction: float = 0.2
    calibration_quantile: float = 0.9
    ridge_lambda: float = 1e-2      # learned cost head regularizer

    def as_dict(self) -> dict:
        return {
            "hidden": list(self.hidden), "epochs": self.epochs,
            "lr": self.lr, "weight_decay": self.weight_decay,
            "seed": self.seed, "val_fraction": self.val_fraction,
            "calibration_quantile": self.calibration_quantile,
            "ridge_lambda": self.ridge_lambda,
        }


def _init_params(rng: np.random.Generator, sizes: Sequence[int],
                 device: DeviceLike = "cpu") -> list:
    """[(w, b), ...] float32 on ``device``: ``w`` drawn in float64 from
    N(0, 1/fan_in) layer by layer in the reference's order, then cast;
    ``b`` zero."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = rng.normal(0.0, 1.0 / np.sqrt(fan_in), (fan_in, fan_out))
        params.append((torch.tensor(w, dtype=torch.float32, device=device),
                       torch.zeros(fan_out, dtype=torch.float32,
                                   device=device)))
    return params


def _apply(params: list, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.tanh(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def _adam_step(params: list, m: list, v: list, t: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor,
               cfg: SurrogateConfig) -> None:
    """One full-batch Adam step on MSE + ``weight_decay`` x the weight
    matrices' squared sum, in place.  ``t`` (a float32 tensor on the
    device) counts the steps for the bias corrections, so the step
    reads no host value and can be captured as a CUDA graph.  The update
    runs as multi-tensor (``_foreach``) ops over the six tensors, one op
    of the reference's expression at a time, in its order:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + ((1 - b2) g) g``,
    ``p -= (lr (m / c1)) / (sqrt(v / c2) + eps)``."""
    flat = [p for wb in params for p in wb]
    pred = _apply(params, x)
    l2 = sum(torch.sum(w * w) for w, _ in params)
    loss = torch.mean((pred - y) ** 2) + cfg.weight_decay * l2
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        t.add_(1.0)
        c1 = 1 - torch.pow(_B1, t)
        c2 = 1 - torch.pow(_B2, t)
        torch._foreach_mul_(m, _B1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - _B1))
        g2 = torch._foreach_mul(grads, 1 - _B2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(v, _B2)
        torch._foreach_add_(v, g2)
        step = torch._foreach_div(m, c1)
        torch._foreach_mul_(step, cfg.lr)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _EPS)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(flat, step)


def _train_mlp(params: list, x: np.ndarray, y: np.ndarray,
               cfg: SurrogateConfig, device: DeviceLike = "cpu",
               capture: Optional[bool] = None) -> list:
    """Full-batch Adam over ``cfg.epochs`` steps from ``params`` (left
    unchanged); returns the trained [(w, b), ...] on ``device``.

    ``capture`` (default: on a CUDA device) captures one step as a CUDA
    graph and replays it ``epochs`` times on static inputs, targets,
    parameters, moments and step counter; the warm-up the capture needs
    runs on the same tensors, which are then restored, so the replays
    start from ``params``.  Otherwise every step runs eagerly."""
    dev = torch.device(device)
    xs = torch.tensor(x, dtype=torch.float32, device=dev)
    ys = torch.tensor(y, dtype=torch.float32, device=dev)
    state = [tuple(p.detach().to(dev).clone().requires_grad_(True)
                   for p in wb) for wb in params]
    flat = [p for wb in state for p in wb]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    t = torch.zeros((), dtype=torch.float32, device=dev)
    capture = dev.type == "cuda" if capture is None else capture

    def step():
        _adam_step(state, m, v, t, xs, ys, cfg)

    if capture and cfg.epochs > 0:
        everything = flat + m + v + [t]
        start = [s.detach().clone() for s in everything]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for s, s0 in zip(everything, start):
                s.copy_(s0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(cfg.epochs):
            graph.replay()
    else:
        for _ in range(cfg.epochs):
            step()
    return [tuple(p.detach() for p in wb) for wb in state]


def warm_up(device: DeviceLike = None) -> None:
    """A two-step captured fit of a tiny MLP on ``device``, so that a
    timed fit after it pays no first-use cost of cuBLAS, the autograd
    engine or CUDA graph capture."""
    dev = resolve_device(device)
    cfg = SurrogateConfig(hidden=(4,), epochs=2)
    params = _init_params(np.random.default_rng(0), [3, 4, 2], dev)
    _train_mlp(params, np.ones((5, 3)), np.ones((5, 2)), cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _standardize(x: np.ndarray, mu: np.ndarray,
                 sigma: np.ndarray) -> np.ndarray:
    return (x - mu) / sigma


def _stats(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = x.mean(axis=0)
    sigma = np.maximum(x.std(axis=0), 1e-8)
    return mu, sigma


# ----------------------------------------------------------------------
# Predictor
# ----------------------------------------------------------------------
@dataclass
class SurrogatePredictor:
    """Trained QoR (+ cost) surrogate over one workload's layers.

    ``predict_drop`` maps circuit names to a (n_layers, n_names) matrix
    of predicted primary-metric DEGRADATIONS (clipped >= 0, the
    ``LayerComponents`` convention), evaluating the float32 MLP on the
    device it was fit on; ``predict_quality`` re-bases onto the baseline
    in the primary's direction.  ``calibration`` is the held-out
    quantile of |total predicted − total measured| drop — the band the
    beam adds to its quality threshold."""

    layers: tuple[str, ...]
    baseline: float
    direction: str
    params: list
    x_mu: np.ndarray
    x_sigma: np.ndarray
    y_mu: np.ndarray
    y_sigma: np.ndarray
    train_names: tuple[str, ...]
    val_names: tuple[str, ...]
    calibration: float
    config: SurrogateConfig
    cost_coef: Optional[np.ndarray] = None
    cost_mean: float = 0.0
    diagnostics: dict = field(default_factory=dict)

    def _features(self, names: Sequence[str], library) -> np.ndarray:
        return feature_matrix([library.entry(n) for n in names])

    def predict_drop(self, names: Sequence[str], library) -> np.ndarray:
        """(n_layers, n_names) predicted per-layer drops, >= 0."""
        x = _standardize(self._features(names, library),
                         self.x_mu, self.x_sigma)
        w0 = self.params[0][0]
        with torch.no_grad():
            pred = _apply(self.params, torch.tensor(
                x, dtype=torch.float32, device=w0.device)).cpu().numpy()
        pred = pred * self.y_sigma + self.y_mu          # (n_names, n_layers)
        return np.maximum(pred.T.astype(np.float64), 0.0)

    def predict_quality(self, names: Sequence[str], library) -> np.ndarray:
        """(n_layers, n_names) predicted primary-metric values (a min
        primary RISES by the drop, a max primary falls)."""
        d = self.predict_drop(names, library)
        return (self.baseline + d if self.direction == "min"
                else self.baseline - d)

    def predict_rel_power(self, names: Sequence[str], library) -> np.ndarray:
        """Learned cost head: relative power from STRUCTURE-ONLY features
        (ridge on log power) — the unseen-circuit estimate; accounting
        everywhere else uses the library's exact values."""
        if self.cost_coef is None:
            raise ValueError("predictor was fit without a cost head")
        x = _standardize(self._features(names, library),
                         self.x_mu, self.x_sigma)[:, STRUCTURE_SLICE]
        return np.exp(x @ self.cost_coef + self.cost_mean)

    def summary(self) -> dict:
        """JSON-able training/fidelity record (rides on
        ``ExploreResult.surrogate``)."""
        return {
            "layers": list(self.layers),
            "n_train": len(self.train_names),
            "n_val": len(self.val_names),
            "train_names": list(self.train_names),
            "val_names": list(self.val_names),
            "calibration": self.calibration,
            "direction": self.direction,
            "config": self.config.as_dict(),
            **self.diagnostics,
        }


def _rows_to_matrix(rows, baseline: float, direction: str):
    """Group duck-typed sweep rows (``.layer``/``.multiplier``/
    ``.accuracy``; per-layer rows only) into (layers, names, drop matrix
    (n_names, n_layers)).  Missing cells mean zero drop."""
    layers = tuple(dict.fromkeys(
        r.layer for r in rows if r.layer not in ("all", "hetero")))
    names = tuple(dict.fromkeys(
        r.multiplier for r in rows if r.layer not in ("all", "hetero")))
    li = {l: j for j, l in enumerate(layers)}
    ni = {n: i for i, n in enumerate(names)}
    drops = np.zeros((len(names), len(layers)), dtype=np.float64)
    for r in rows:
        if r.layer in ("all", "hetero"):
            continue
        d = (r.accuracy - baseline if direction == "min"
             else baseline - r.accuracy)
        drops[ni[r.multiplier], li[r.layer]] = max(float(d), 0.0)
    return layers, names, drops


def _split_indices(names: Sequence[str], library,
                   val_fraction: float) -> tuple[list[int], list[int]]:
    """Deterministic held-out split: order circuits along the power axis
    (name-tiebroken) and hold out every k-th, so the validation set
    spans the cheap-to-accurate range."""
    order = sorted(range(len(names)),
                   key=lambda i: (library.entry(names[i]).rel_power,
                                  names[i]))
    n_val = int(round(val_fraction * len(names)))
    if n_val == 0 or len(names) - n_val < 2:
        return list(order), []
    k = max(2, len(names) // n_val)
    val = [order[i] for i in range(1, len(names), k)][:n_val]
    train = [i for i in order if i not in val]
    return train, val


@dataclass
class _Corpus:
    """The standardized training data ``fit_surrogate`` learns from."""
    layers: tuple[str, ...]
    names: tuple[str, ...]
    drops: np.ndarray           # (n_names, n_layers) measured drops
    x_all: np.ndarray           # (n_names, n_features) raw features
    train: list[int]
    val: list[int]
    x_mu: np.ndarray
    x_sigma: np.ndarray
    y_mu: np.ndarray
    y_sigma: np.ndarray
    xs: np.ndarray              # standardized features
    ys: np.ndarray              # standardized drops

    def initial_params(self, cfg: SurrogateConfig,
                       device: DeviceLike = "cpu") -> list:
        sizes = [self.x_all.shape[1], *cfg.hidden, len(self.layers)]
        return _init_params(np.random.default_rng(cfg.seed), sizes, device)


def _corpus(rows, library, baseline: float, direction: str,
            cfg: SurrogateConfig) -> _Corpus:
    layers, names, drops = _rows_to_matrix(rows, baseline, direction)
    if not layers or len(names) < 3:
        raise ValueError(
            f"fit_surrogate needs per-layer rows over >= 3 circuits; "
            f"got {len(names)} circuits x {len(layers)} layers")
    x_all = feature_matrix([library.entry(n) for n in names])
    tr, va = _split_indices(names, library, cfg.val_fraction)
    x_mu, x_sigma = _stats(x_all[tr])
    y_mu, y_sigma = _stats(drops[tr])
    return _Corpus(layers=layers, names=names, drops=drops, x_all=x_all,
                   train=tr, val=va, x_mu=x_mu, x_sigma=x_sigma,
                   y_mu=y_mu, y_sigma=y_sigma,
                   xs=_standardize(x_all, x_mu, x_sigma),
                   ys=_standardize(drops, y_mu, y_sigma))


def fit_surrogate(rows, library, baseline: float,
                  direction: str = "max",
                  config: Optional[SurrogateConfig] = None,
                  device: DeviceLike = None) -> SurrogatePredictor:
    """Train the QoR surrogate on exact per-layer sweep rows, on
    ``device`` (the GPU unless ``device="cpu"``).

    ``rows`` is any list of ``ResilienceRow`` or ``DesignPoint`` objects
    (duck-typed); "all"/"hetero" rows are ignored.  Quality is learned
    as standardized per-layer DROP vectors from standardized circuit
    features; a deterministic held-out split provides the calibration
    band and per-layer Spearman diagnostics, and a ridge cost head on
    the structure-only feature block learns relative power."""
    cfg = config or SurrogateConfig()
    dev = resolve_device(device)
    c = _corpus(rows, library, baseline, direction, cfg)
    tr, va, names = c.train, c.val, c.names
    params = _train_mlp(c.initial_params(cfg, dev), c.xs[tr], c.ys[tr],
                        cfg, dev)

    pred = SurrogatePredictor(
        layers=c.layers, baseline=float(baseline), direction=direction,
        params=params, x_mu=c.x_mu, x_sigma=c.x_sigma, y_mu=c.y_mu,
        y_sigma=c.y_sigma,
        train_names=tuple(names[i] for i in tr),
        val_names=tuple(names[i] for i in va),
        calibration=0.0, config=cfg)

    # learned cost head (structure-only ridge on log rel power)
    rp = np.array([library.entry(n).rel_power for n in names])
    y_log = np.log(np.maximum(rp, 1e-6))
    xsr = c.xs[tr][:, STRUCTURE_SLICE]
    lam = cfg.ridge_lambda
    pred.cost_mean = float(y_log[tr].mean())
    yc = y_log[tr] - pred.cost_mean
    pred.cost_coef = np.linalg.solve(
        xsr.T @ xsr + lam * np.eye(xsr.shape[1]), xsr.T @ yc)

    # held-out calibration + fidelity diagnostics (the train split for
    # tiny corpora — flagged, since train residuals understate the band)
    hold = va if va else tr
    d_pred = pred.predict_drop([names[i] for i in hold], library)
    d_true = c.drops[hold].T
    total_res = np.abs(d_pred.sum(axis=0) - d_true.sum(axis=0))
    cell_res = np.abs(d_pred - d_true)
    pred.calibration = float(np.quantile(total_res,
                                         cfg.calibration_quantile))
    rp_pred = pred.predict_rel_power([names[i] for i in hold], library)
    pred.diagnostics = {
        "holdout": "val" if va else "train",
        "cell_residual_q": float(np.quantile(
            cell_res, cfg.calibration_quantile)),
        "total_residual_mean": float(total_res.mean()),
        "val_spearman": {
            layer: spearman(d_pred[j], d_true[j])
            for j, layer in enumerate(c.layers)},
        "power_spearman": spearman(rp_pred, rp[hold]),
    }
    return pred


def fit_walls(rows, library, baseline: float, direction: str = "max",
              config: Optional[SurrogateConfig] = None,
              device: DeviceLike = None) -> dict:
    """The MLP fit of ``fit_surrogate`` on the same rows, eager and
    captured as a CUDA graph, timed (host clock, device synchronized):
    ``{"eager_s", "captured_s", "max_abs_diff", "bit_equal"}`` — the
    largest |difference| between the two fits' parameters."""
    cfg = config or SurrogateConfig()
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"fit_walls times a CUDA graph: {dev} is not a "
                         "CUDA device")
    c = _corpus(rows, library, baseline, direction, cfg)
    init = c.initial_params(cfg, dev)
    out, fits = {}, {}
    for label, capture in (("eager", False), ("captured", True)):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fits[label] = _train_mlp(init, c.xs[c.train], c.ys[c.train], cfg,
                                 dev, capture=capture)
        torch.cuda.synchronize(dev)
        out[f"{label}_s"] = time.perf_counter() - t0
    diffs = [float(torch.max(torch.abs(a - b)))
             for wa, wb in zip(fits["eager"], fits["captured"])
             for a, b in zip(wa, wb)]
    out["max_abs_diff"] = max(diffs)
    out["bit_equal"] = all(torch.equal(a, b)
                           for wa, wb in zip(fits["eager"], fits["captured"])
                           for a, b in zip(wa, wb))
    return out


# ----------------------------------------------------------------------
# Predict-stage orchestration
# ----------------------------------------------------------------------
def train_subset(multipliers: Sequence[str], library,
                 train_fraction: float,
                 rel_power: Optional[dict] = None) -> list[str]:
    """Deterministic training subset: candidates sorted along the power
    axis, then evenly spaced indices including both endpoints, so the
    subsample sees the whole cheap-to-exact range.  At least 6 circuits
    (or all of them, below that)."""
    def rp(name: str) -> float:
        if rel_power is not None and name in rel_power:
            return float(rel_power[name])
        return float(library.entry(name).rel_power)

    ordered = sorted(multipliers, key=lambda n: (rp(n), n))
    n = len(ordered)
    n_train = max(6, int(np.ceil(train_fraction * n)))
    if n_train >= n:
        return list(ordered)
    idx = np.unique(np.round(np.linspace(0, n - 1, n_train)).astype(int))
    return [ordered[i] for i in idx]


def surrogate_components(
    eval_fn: Callable,
    layer_counts: dict[str, int],
    multipliers: Sequence[str],
    library,
    baseline: float,
    direction: str = "max",
    train_fraction: float = 0.25,
    mode: str = "lut",
    variant: str = "ref",
    base=None,
    batch: bool = False,
    sharding=None,
    rel_power=None,
    config: Optional[SurrogateConfig] = None,
    device: DeviceLike = None,
    stage_walls: Optional[dict] = None,
) -> tuple[LayerComponents, SurrogatePredictor, list[ResilienceRow]]:
    """The surrogate predict stage as a ``LayerComponents`` factory.

    Runs the exact per-layer sweep ONLY over a deterministic
    power-spread ``train_fraction`` of the candidates, fits the
    surrogate on those rows (on ``device``), and predicts quality for
    the rest: ``quality[j, i]`` holds the exact measurement where one
    exists and the prediction otherwise.  Relative power stays the
    library's exact accounting for every candidate.  Returns
    ``(components, predictor, measured_rows)``.  ``stage_walls``, when
    given, receives the host-clock seconds of the sweep
    (``per_layer_sweep_s``) and of the fit and prediction (``fit_s``);
    both end in values on the host.  ``sharding``
    (``launch.mesh.bank_sharding``) splits the sweep's lanes across
    devices."""
    multipliers = list(multipliers)
    rp_map = (rel_power if rel_power is not None
              else auto_rel_power(library, multipliers))
    names_tr = train_subset(multipliers, library, train_fraction,
                            rel_power=rp_map)
    t0 = time.perf_counter()
    rows = per_layer_sweep(eval_fn, layer_counts, names_tr, library,
                           mode=mode, base=base, variant=variant,
                           batch=batch, sharding=sharding,
                           rel_power=rp_map)
    t1 = time.perf_counter()
    predictor = fit_surrogate(rows, library, baseline,
                              direction=direction, config=config,
                              device=device)

    layers = tuple(layer_counts)
    quality = predictor.predict_quality(multipliers, library)
    if stage_walls is not None:
        stage_walls["per_layer_sweep_s"] = t1 - t0
        stage_walls["fit_s"] = time.perf_counter() - t1
    # exact measurements override their own predictions — the surrogate
    # only speaks for circuits the sweep never touched
    li = {l: j for j, l in enumerate(layers)}
    mi = {m: i for i, m in enumerate(multipliers)}
    for r in rows:
        if r.layer in ("all", "hetero"):
            continue
        quality[li[r.layer], mi[r.multiplier]] = r.accuracy

    rel = np.array([
        rp_map[n] if rp_map is not None else library.entry(n).rel_power
        for n in multipliers])
    components = LayerComponents(
        layers=layers, multipliers=tuple(multipliers), quality=quality,
        rel_power=rel,
        counts=tuple(int(layer_counts[l]) for l in layers),
        total_count=int(sum(layer_counts.values())),
        baseline=float(baseline), direction=direction)
    return components, predictor, rows
