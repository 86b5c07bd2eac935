"""The bitsim kernels' (K10, K11) schedule and gate encoding, on the CPU.

A block of the CUDA kernels stages each gate as a 32-bit descriptor
(truth table and input indices), computes each gate's level and sorts
the gates by level before it walks them (``csrc/bitsim.cuh``).  The
host mirrors ``kernels.bitsim.level_schedule`` and ``pack_descriptors``
are held here: the order is a permutation, a gate's level passes the
level of every input its arity uses and equals the longest path found
by an independent relaxation, the truth tables equal ``core.gates`` on
random words, and a walk of the descriptors in level order equals
``Netlist.eval_words``.  Also the walk plan the wrappers pass to the
kernels.  No JAX, a few seconds."""
import numpy as np
import pytest

from repro_torch.core import gates
from repro_torch.core.cgp import mutate
from repro_torch.core.netlist import Netlist, stack_netlists
from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
from repro_torch.kernels import bitsim as kb


def _longest_path(funcs, in0, in1, n_i: int) -> np.ndarray:
    """Each gate's level by relaxation over the edge list until nothing
    changes, in reverse index order (independent of the forward pass):
    1 + the largest level of the inputs its arity uses, planes at 0."""
    n = len(funcs)
    lev = np.zeros(n_i + n, dtype=np.int64)
    arity = gates.GATE_ARITY[np.asarray(funcs)]
    changed = True
    while changed:
        changed = False
        for j in reversed(range(n)):
            ins = [s for k, s in ((1, in0[j]), (2, in1[j])) if arity[j] >= k]
            lv = 1 + max((lev[s] for s in ins), default=0)
            if lv != lev[n_i + j]:
                lev[n_i + j] = lv
                changed = True
    return lev[n_i:]


def _check_schedule(funcs, in0, in1, n_i: int) -> np.ndarray:
    levels, order = kb.level_schedule(funcs, in0, in1, n_i)
    n = len(funcs)
    assert sorted(order.tolist()) == list(range(n))
    assert np.all(np.diff(levels[order]) >= 0)
    arity = gates.GATE_ARITY[np.asarray(funcs)]
    for j in range(n):
        for k, s in ((1, in0[j]), (2, in1[j])):
            if arity[j] >= k and s >= n_i:
                assert levels[j] > levels[s - n_i]
    np.testing.assert_array_equal(levels,
                                  _longest_path(funcs, in0, in1, n_i))
    return levels


def _walk_levels(nl, planes32: np.ndarray) -> np.ndarray:
    """The level walk on the host: descriptors in level order, each
    gate from its truth table -> (n_o, W) uint32 words."""
    _, order = kb.level_schedule(nl.funcs, nl.in0, nl.in1, nl.n_i)
    desc = kb.pack_descriptors(nl.funcs, nl.in0, nl.in1)
    mask = (1 << kb.INDEX_BITS) - 1
    sig = np.zeros((nl.n_i + nl.n_nodes, planes32.shape[1]), np.uint32)
    sig[:nl.n_i] = planes32
    for j in order:
        d = int(desc[j])
        sig[nl.n_i + j] = kb.eval_descriptor(d, sig[d & mask],
                                             sig[(d >> kb.INDEX_BITS) & mask])
    return sig[nl.outputs]


def _mutants(seed, k: int, rng) -> list:
    return [mutate(seed, rng, 4) for _ in range(k)]


def test_exact_seeds_depths():
    """The exact 8-bit multiplier is 40 levels deep (320 gates), the
    ripple-carry adder 15 (37 gates)."""
    for nl, depth in ((array_multiplier(8), 40), (ripple_carry_adder(8), 15)):
        levels = _check_schedule(nl.funcs, nl.in0, nl.in1, nl.n_i)
        assert levels.max() == depth


@pytest.mark.parametrize("family", ["mul8", "add8"])
def test_schedule_of_cgp_mutants(family):
    """32 mutants of each seed (the ladder's population) and their
    stacked arrays (mixed node counts padded with const0 gates)."""
    seed = {"mul8": array_multiplier(8), "add8": ripple_carry_adder(8)}[family]
    rng = np.random.default_rng(17)
    pop = _mutants(seed, 32, rng)
    for nl in pop:
        _check_schedule(nl.funcs, nl.in0, nl.in1, nl.n_i)
    mixed = [pop[0].compact(), pop[1], seed]
    funcs, in0, in1, _ = stack_netlists(mixed)
    for p in range(len(mixed)):
        _check_schedule(funcs[p], in0[p], in1[p], seed.n_i)


def test_schedule_compacted_const_and_chain():
    """A compacted netlist (stale indices in unused inputs, past the
    signal count), a netlist of constants only, and a pure chain whose
    depth is its gate count."""
    rng = np.random.default_rng(3)
    m = array_multiplier(4)
    for _ in range(6):
        m = mutate(m, rng, 6)
    small = m.compact()
    _check_schedule(small.funcs, small.in0, small.in1, small.n_i)
    const = Netlist(n_i=2, n_o=2, funcs=np.array([gates.CONST0, gates.CONST1,
                                                  gates.CONST0], np.int32),
                    in0=np.array([1, 40, 3], np.int32),
                    in1=np.array([7, 0, 99], np.int32),
                    outputs=np.array([2, 3], np.int32))
    levels = _check_schedule(const.funcs, const.in0, const.in1, 2)
    assert levels.tolist() == [1, 1, 1]
    n = 300
    chain = Netlist(n_i=2, n_o=1,
                    funcs=np.array([j % 8 for j in range(n)], np.int32),
                    in0=np.array([1 + j for j in range(n)], np.int32),
                    in1=np.array([j // 3 for j in range(n)], np.int32),
                    outputs=np.array([1 + n], np.int32))
    levels = _check_schedule(chain.funcs, chain.in0, chain.in1, 2)
    assert levels.tolist() == list(range(1, n + 1))


def test_descriptor_truth_tables_match_gates():
    """Every gate code's descriptor, evaluated from its truth table on
    random words, equals ``core.gates``; unused inputs point at a used
    one (b = a for identity/not, both 0 for the constants)."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    funcs = np.arange(gates.N_FUNCS)
    desc = kb.pack_descriptors(funcs, np.full(10, 1234), np.full(10, 77))
    mask = (1 << kb.INDEX_BITS) - 1
    for f in range(gates.N_FUNCS):
        want = gates.eval_gate_words(f, a.astype(np.uint64),
                                     b.astype(np.uint64)).astype(np.uint32)
        np.testing.assert_array_equal(kb.eval_descriptor(desc[f], a, b), want)
        d = int(desc[f])
        ia, ib = d & mask, (d >> kb.INDEX_BITS) & mask
        arity = int(gates.GATE_ARITY[f])
        assert (ia, ib) == {0: (0, 0), 1: (1234, 1234), 2: (1234, 77)}[arity]
        assert d >> 28 == kb.TRUTH_TABLES[f]


@pytest.mark.parametrize("which", ["mul8", "add8", "compacted"])
def test_level_order_walk_equals_eval_words(which):
    rng = np.random.default_rng(9)
    nl = {"mul8": lambda: mutate(array_multiplier(8), rng, 4),
          "add8": lambda: mutate(ripple_carry_adder(8), rng, 4),
          "compacted": lambda: mutate(array_multiplier(4), rng, 8).compact()
          }[which]()
    planes64 = rng.integers(0, 2 ** 64, (nl.n_i, 3), dtype=np.uint64)
    from repro_torch.kernels import ops
    got = _walk_levels(nl, ops.split_planes64(planes64))
    np.testing.assert_array_equal(ops.join_planes32(got),
                                  nl.eval_words(planes64))


def test_walk_plan():
    """The walk each netlist takes (``walk_plan``): the 8-bit adder
    serially in 128-word blocks; the 8-bit multiplier in 32-word blocks,
    by level with ``LEVEL_WARPS`` warps where the grid has no more
    blocks than SMs (K10's exhaustive planes, 2048 words: 64 blocks)
    and serially where blocks share SMs (a CGP generation, 32 x 256
    words: 256); the level walk's records fit up to 1438 signals, the
    serial walk's descriptors up to 1761; past that the serial walk
    with the netlist in device memory, and past 1816 signals none."""
    add8, mul8 = ripple_carry_adder(8), array_multiplier(8)
    for p, w in ((1, 2048), (32, 256)):
        assert kb.walk_plan(add8.n_i, add8.n_nodes, p, w) == kb.WalkPlan(
            128, "serial", 1, 53 * 128 * 4 + 4 * (37 + 2))
    level = kb.walk_plan(mul8.n_i, mul8.n_nodes, 1, 2048, sms=132)
    assert level == kb.WalkPlan(32, "level", kb.LEVEL_WARPS,
                                336 * 32 * 4 + 32 * 320 + 644)
    assert level.smem == 53892
    assert kb.walk_plan(mul8.n_i, mul8.n_nodes, 32, 256, sms=132) == \
        kb.WalkPlan(32, "serial", 1, 336 * 32 * 4 + 4 * 322)
    assert kb.walk_plan(mul8.n_i, mul8.n_nodes, 132, 32).walk == "level"
    assert kb.walk_plan(mul8.n_i, mul8.n_nodes, 133, 32).walk == "serial"
    assert kb.walk_plan(mul8.n_i, mul8.n_nodes, 1, 2048, sms=63).walk == \
        "serial"
    mul16 = array_multiplier(16)
    assert mul16.n_i + mul16.n_nodes == 1440
    assert kb.walk_plan(mul16.n_i, mul16.n_nodes).walk == "level"
    assert kb.walk_plan(16, 1422).walk == "level"
    assert kb.walk_plan(16, 1423).walk == "serial"
    assert kb.walk_plan(16, 1745).walk == "serial"
    assert kb.walk_plan(16, 1746) == kb.WalkPlan(32, "serial_global", 1,
                                                 1762 * 128)
    assert kb.walk_plan(5, 0).walk == "serial"
    with pytest.raises(ValueError, match="1817 signals"):
        kb.walk_plan(17, 1800)
    for n_i, n in ((16, 37), (16, 320), (16, 1422), (16, 1745), (16, 1800),
                   (2, 1000)):
        wp = kb.walk_plan(n_i, n)
        assert wp.smem == kb.smem_bytes(n_i, n, wp.wb, wp.walk) <= kb.SMEM_MAX
