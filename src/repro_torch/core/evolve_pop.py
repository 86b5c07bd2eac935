"""Population-parallel CGP engine on the device bitsim (port of
``repro.core.evolve_pop``, DESIGN.md §2.9).

The legacy ``cgp.evolve`` loop simulates ONE candidate per
``Netlist.eval_words`` call; fitness evaluation dominates the search, so
library generation throughput is capped by per-candidate python
dispatch.  This engine makes the (1+λ) step *generational*: all λ
offspring mutate from the same parent and are scored together —
``engine="device"`` runs the whole population through ONE launch of the
population simulator (kernel K11, ``kernels.ops.bitsim_pop_planes``) and
reduces the search metric on the device (exact integer sums, finished in
float64 on the host, so scores are bit-identical to the numpy engine and
the two engines walk identical search trajectories at a fixed seed).

``evolve_ladder`` fuses a whole ladder of e_max-targeted searches into
one generation-synchronous sweep: every rung contributes λ offspring to
a single fused population per generation, and the population axis can
be split across devices via ``launch.mesh.pop_sharding`` (one K11
launch and one reduction a shard, netlist slices split, input planes
copied to every device, the sums gathered to the host).

Search/verify split: everything here scores candidates on the sampled
search planes; each search's final circuit is re-verified exhaustively
(``PopEvaluator.verify``: ``metrics.evaluate_errors``, or kernel K10 on
the device engine — the same report), exactly like the sequential
engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, device_key, resolve_device
from ..kernels import ops
from .cgp import (CgpParams, EvolvedCircuit, _Score, _score, mutate,
                  search_planes, unpack_values)
from .cost import evaluate_cost
from .metrics import (EXHAUSTIVE_LIMIT_BITS, METRIC_NAMES, ErrorReport,
                      error_report_from_values, evaluate_errors)
from .netlist import Netlist, exhaustive_inputs, stack_netlists, \
    unpack_outputs

# metrics whose reduction runs on the device with EXACT integer
# arithmetic (int64 sums finished in float64 on the host); the rest
# simulate on the device and reduce on the host from the transferred
# values.  (The reference reduces on the device only up to 24 output
# bits, the bound of its int32 chunked sums; int64 sums are exact up to
# the 32-output cap, so the port needs no such bound.)
DEVICE_METRICS = ("er", "mae", "wce")

# a split population is padded up to a multiple of lcm(POP_PAD, mesh
# size), as the reference pads its populations (for its jit cache; a
# CUDA launch has no shape cache, so an unsplit population is not
# padded)
POP_PAD = 8

# values travel as 32-bit words, so the device engine caps at 32 outputs
_DEVICE_MAX_N_O = 32


def _pop_values(out32: torch.Tensor, n_o: int) -> torch.Tensor:
    """(P, n_o, W32) int32 output words -> (P, 32*W32) int64 values.

    Lane L bit k is vector 32*L + k (the ``split_planes64`` layout), so
    a plain reshape restores vector order; output bit b contributes
    2^b (the bits are disjoint, so their sum is their OR)."""
    p, _, w32 = out32.shape
    shifts = torch.arange(32, dtype=torch.int32, device=out32.device)
    bits = (out32[:, :, :, None] >> shifts) & 1          # (P, n_o, W32, 32)
    weights = torch.arange(n_o, dtype=torch.int64,
                           device=out32.device)[None, :, None, None]
    return (bits.to(torch.int64) << weights).sum(dim=1).reshape(
        p, w32 * 32)


def _reduce(vals: torch.Tensor, exact_u32: torch.Tensor,
            num: int) -> torch.Tensor:
    """Population error reduction on the device: (3, P) int64 rows of
    the count of differing vectors, max |diff| and Σ|diff| over the
    ``num`` valid vectors — all exact integers, so the float64 host
    finish reproduces the numpy metric bit for bit."""
    diff = (vals - exact_u32[None, :]).abs()
    diff[:, num:] = 0
    return torch.stack([(diff != 0).sum(dim=1), diff.amax(dim=1),
                        diff.sum(dim=1)])


class PopEvaluator:
    """Scores candidate *populations* against one exact oracle.

    engine='numpy'  — per-candidate ``Netlist.eval_words`` host loop
                      (the sequential baseline).
    engine='device' — ONE K11 launch per call on ``device`` (default:
                      the GPU; ``"cpu"`` runs the kernel's plain
                      version); er/mae/wce reduce on the device
                      (bit-identical floats to the numpy engine), other
                      metrics reduce on the host from device-computed
                      values.

    ``sharding`` (a ``launch.mesh.pop_sharding``) splits the population
    axis across its mesh's devices: the population is padded to a
    multiple of lcm(``POP_PAD``, axis size) and each shard takes one K11
    launch and its own reduction on its device (``device`` defaults to
    the mesh's first); scores equal the unsplit run's.

    Instrumented: ``n_scored`` candidates / ``n_calls`` evaluation
    calls; of the device engine's calls, ``host_s`` (stacking the
    netlists, checking them and copying them to the device) and
    ``device_s`` (from there to the scores on the host: the K11 launch,
    the reduction's PyTorch ops with their dispatch, and the copy back,
    which waits for the device).
    """

    def __init__(self, exact: Netlist, params: CgpParams,
                 engine: str = "numpy", device: DeviceLike = None,
                 sharding=None):
        if engine not in ("numpy", "device"):
            raise ValueError(f"unknown engine {engine!r} "
                             "(expected 'numpy' or 'device')")
        if params.metric not in METRIC_NAMES:
            raise ValueError(f"unknown metric {params.metric}")
        self.engine = engine
        self.metric = params.metric
        self.exact = exact
        self.n_i, self.n_o = exact.n_i, exact.n_o
        rng = np.random.default_rng(params.seed + 7919)
        self.planes64, self.num = search_planes(
            self.n_i, params.search_samples, rng)
        exact_planes = exact.eval_words(self.planes64)
        self.exact_vals = unpack_values(exact_planes, self.n_o, self.num)
        self.sharding = sharding
        self.n_scored = 0
        self.n_calls = 0
        self.host_s = 0.0
        self.device_s = 0.0
        self._verify_cache: Optional[tuple] = None
        if engine == "device":
            if self.n_o > _DEVICE_MAX_N_O:
                raise ValueError(
                    f"device engine caps at {_DEVICE_MAX_N_O} output "
                    f"bits (got {self.n_o}); use engine='numpy' for "
                    "wider circuits")
            if device is None and sharding is not None:
                device = sharding.mesh.devices[0]
            self.device = resolve_device(device)
            self.planes32 = ops.words_to_device(
                ops.split_planes64(self.planes64), self.device)
            numpad = self.planes32.shape[1] * 32
            buf = np.zeros(numpad, dtype=np.int64)
            buf[:self.num] = unpack_outputs(exact_planes, self.n_o,
                                            self.num).astype(np.int64)
            self.exact_u32 = torch.from_numpy(buf).to(self.device)
            # the search planes and exact values on each device a shard
            # runs on, copied once
            self._on_device = {device_key(self.device):
                               (self.planes32, self.exact_u32)}

    # -- scoring --------------------------------------------------------
    def errors_of(self, pop: Sequence[Netlist]) -> np.ndarray:
        """(len(pop),) float64 of ``params.metric`` per candidate —
        identical values from both engines."""
        pop = list(pop)
        self.n_scored += len(pop)
        self.n_calls += 1
        if self.engine == "numpy":
            out = np.empty(len(pop), dtype=np.float64)
            for k, nl in enumerate(pop):
                vals = unpack_values(nl.eval_words(self.planes64),
                                     self.n_o, self.num)
                out[k] = error_report_from_values(
                    vals, self.exact_vals, exhaustive=False
                ).get(self.metric)
            return out
        return self._device_errors(pop)

    def _padded(self, pop: list) -> list:
        """``pop`` padded with copies of its first candidate to a
        multiple of lcm(``POP_PAD``, axis size) when ``sharding`` splits
        the population axis."""
        spec = self.sharding.spec if self.sharding is not None else ()
        if not len(spec) or spec[0] is None:
            return pop
        from ..launch.mesh import axis_size
        pad_to = int(np.lcm(POP_PAD, axis_size(self.sharding.mesh,
                                               spec[0])))
        pp = -(-len(pop) // pad_to) * pad_to
        return pop + [pop[0]] * (pp - len(pop))

    def _state(self, dev: torch.device) -> tuple:
        """(planes32, exact_u32) on ``dev``, copied there once."""
        key = device_key(dev)
        st = self._on_device.get(key)
        if st is None:
            st = self._on_device[key] = (self.planes32.to(key),
                                         self.exact_u32.to(key))
        return st

    def _device_errors(self, pop: list) -> np.ndarray:
        t0 = time.perf_counter()
        p = len(pop)
        pop_p = self._padded(pop)
        arrays = stack_netlists(pop_p)
        shards = (self.sharding.shards(len(pop_p))
                  if self.sharding is not None
                  else [(self.device, 0, p)])
        tens = [(dev, ops.netlist_tensors(
            tuple(a[start:stop] for a in arrays), self.n_i, dev))
            for dev, start, stop in shards]
        t1 = time.perf_counter()
        device_metric = self.metric in DEVICE_METRICS
        parts = []
        for dev, t in tens:
            # every shard queues its launch and reduction before any
            # result is read, so distinct cards overlap
            planes, exact_u32 = self._state(dev)
            vals = _pop_values(ops.bitsim_pop_planes(*t, planes), self.n_o)
            parts.append(_reduce(vals, exact_u32, self.num)
                         if device_metric else vals[:, :self.num])
        host = [t.cpu().numpy() for t in parts]
        if device_metric:
            ne, wce, sums = np.concatenate(host, axis=1)[:, :p]
            if self.metric == "er":
                res = ne.astype(np.float64) / self.num
            elif self.metric == "wce":
                res = wce.astype(np.float64)
            else:   # mae: exact integer total, float64 division
                res = sums.astype(np.float64) / self.num
        else:
            # host-reduced fallback (mse/mre/wcre): the simulation still
            # runs as one launch a shard
            vals = np.concatenate(host)[:p]
            res = np.empty(p, dtype=np.float64)
            for k in range(p):
                res[k] = error_report_from_values(
                    vals[k].astype(np.float64), self.exact_vals,
                    exhaustive=False).get(self.metric)
        self.host_s += t1 - t0
        self.device_s += time.perf_counter() - t1
        return res

    # -- exhaustive re-verification ------------------------------------
    def verify(self, nl: Netlist) -> ErrorReport:
        """The exhaustive ``ErrorReport`` of ``nl`` against the oracle:
        ``metrics.evaluate_errors`` on the numpy engine; on the device
        engine the same report from kernel K10's output planes (equal to
        ``eval_words`` bit for bit) when the input space is exhaustive,
        ``evaluate_errors`` past that."""
        if self.engine == "numpy" or self.n_i > EXHAUSTIVE_LIMIT_BITS:
            return evaluate_errors(nl, self.exact)
        if self._verify_cache is None:
            # the exhaustive planes stay on the device between searches
            planes = exhaustive_inputs(self.n_i)
            num = 1 << self.n_i
            self._verify_cache = (
                ops.words_to_device(ops.split_planes64(planes), self.device),
                num, unpack_outputs(self.exact.eval_words(planes), self.n_o,
                                    num))
        words, num, e_out = self._verify_cache
        out = ops.bitsim_planes(*ops.netlist_tensors(
            (nl.funcs, nl.in0, nl.in1, nl.outputs), nl.n_i, self.device),
            words)
        a_out = unpack_outputs(ops.join_planes32(ops.words_to_host(out)),
                               self.n_o, num)
        return error_report_from_values(a_out, e_out, exhaustive=True)


# ----------------------------------------------------------------------
# Generational (1+λ) search
# ----------------------------------------------------------------------
def _select(scores: list) -> int:
    """Best offspring index; ties resolve to the lowest index so both
    engines (and any future parallel scorer) agree deterministically."""
    return min(range(len(scores)),
               key=lambda i: (scores[i].infeasible, scores[i].primary, i))


def _finish(nl: Netlist, ev: PopEvaluator) -> EvolvedCircuit:
    """Compact and exhaustively re-verify a search's final circuit."""
    final = nl.compact()
    cost = evaluate_cost(final)
    return EvolvedCircuit(netlist=final, errors=ev.verify(final),
                          cost_area=cost.area, cost_power=cost.power)


def evolve_pop(
    seed_netlist: Netlist,
    exact: Netlist,
    params: CgpParams,
    engine: str = "numpy",
    on_candidate: Optional[Callable[[Netlist, float, float], None]] = None,
    evaluator: Optional[PopEvaluator] = None,
    device: DeviceLike = None,
    sharding=None,
) -> EvolvedCircuit:
    """Generational (1+λ) run: all λ offspring mutate from the SAME
    parent and score in one ``PopEvaluator`` call (one K11 launch when
    engine='device').  NOTE the deliberate semantic difference from
    ``cgp.evolve``, whose offspring chain within a generation — the
    generational step is what makes population scoring possible.  Fixed
    seed ⇒ identical result from both engines.  ``sharding``
    (``launch.mesh.pop_sharding``) splits each population across
    devices.
    """
    rng = np.random.default_rng(params.seed)
    ev = evaluator if evaluator is not None else \
        PopEvaluator(exact, params, engine=engine, device=device,
                     sharding=sharding)
    parent = seed_netlist
    p_err = float(ev.errors_of([parent])[0])
    p_score = _score(p_err, evaluate_cost(parent).area,
                     params.e_min, params.e_max)
    best_feasible: Optional[Netlist] = \
        parent if p_score.infeasible == 0 else None

    for _gen in range(params.generations):
        children = [mutate(parent, rng, params.h)
                    for _ in range(params.lam)]
        errs = ev.errors_of(children)
        areas = [evaluate_cost(c).area for c in children]
        scores = [_score(float(errs[k]), areas[k], params.e_min,
                         params.e_max) for k in range(params.lam)]
        k = _select(scores)
        if scores[k] <= p_score:   # allow neutral drift
            improved = scores[k] < p_score
            parent, p_err, p_score = children[k], float(errs[k]), scores[k]
            if p_score.infeasible == 0:
                best_feasible = parent
                if improved and on_candidate is not None:
                    on_candidate(parent, p_err, areas[k])

    return _finish(best_feasible if best_feasible is not None
                   else seed_netlist, ev)


@dataclass
class _Run:
    e_max: float
    rng: np.random.Generator
    parent: Netlist
    p_err: float
    p_score: _Score
    best_feasible: Optional[Netlist]


def evolve_ladder(
    seed_netlist: Netlist,
    exact: Netlist,
    e_max_ladder: Sequence[float],
    params: CgpParams,
    engine: str = "device",
    on_candidate: Optional[
        Callable[[int, Netlist, float, float], None]] = None,
    evaluator: Optional[PopEvaluator] = None,
    device: DeviceLike = None,
    sharding=None,
) -> list:
    """The whole e_max ladder as ONE generation-synchronous sweep.

    Every rung runs an independent generational (1+λ) search from the
    shared seed; per generation all rungs' offspring fuse into a single
    (len(ladder) * λ) population scored in one evaluator call (one K11
    launch on the device engine, one a shard when ``sharding``, a
    ``launch.mesh.pop_sharding``, splits it).  Rung i is
    trajectory-identical to
    ``evolve_pop(seed, exact, replace(params, e_max=ladder[i],
    seed=params.seed + i), evaluator=<shared>)``.

    ``on_candidate(rung_index, netlist, err, area)`` fires for every
    improved feasible parent.  Returns one ``EvolvedCircuit`` per rung
    (ladder sorted ascending), each exhaustively re-verified.
    """
    ladder = sorted(float(e) for e in e_max_ladder)
    ev = evaluator if evaluator is not None else \
        PopEvaluator(exact, params, engine=engine, device=device,
                     sharding=sharding)
    seed_err = float(ev.errors_of([seed_netlist])[0])
    seed_area = evaluate_cost(seed_netlist).area
    runs = []
    for i, e_max in enumerate(ladder):
        sc = _score(seed_err, seed_area, params.e_min, e_max)
        runs.append(_Run(
            e_max=e_max, rng=np.random.default_rng(params.seed + i),
            parent=seed_netlist, p_err=seed_err, p_score=sc,
            best_feasible=seed_netlist if sc.infeasible == 0 else None))

    lam = params.lam
    for _gen in range(params.generations):
        pop = [mutate(r.parent, r.rng, params.h)
               for r in runs for _ in range(lam)]
        errs = ev.errors_of(pop)
        for ri, r in enumerate(runs):
            ch = pop[ri * lam:(ri + 1) * lam]
            es = errs[ri * lam:(ri + 1) * lam]
            areas = [evaluate_cost(c).area for c in ch]
            scores = [_score(float(es[k]), areas[k], params.e_min,
                             r.e_max) for k in range(lam)]
            k = _select(scores)
            if scores[k] <= r.p_score:
                improved = scores[k] < r.p_score
                r.parent, r.p_err, r.p_score = \
                    ch[k], float(es[k]), scores[k]
                if r.p_score.infeasible == 0:
                    r.best_feasible = r.parent
                    if improved and on_candidate is not None:
                        on_candidate(ri, r.parent, r.p_err, areas[k])

    return [_finish(r.best_feasible if r.best_feasible is not None
                    else seed_netlist, ev) for r in runs]
