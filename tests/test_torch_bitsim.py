"""The gate-netlist simulators (kernels K10, K11) held against the JAX
reference on the CPU.

The port's ``ops.bitsim`` / ``ops.bitsim_pop`` (the plain versions on
the CPU) against the reference's ``bitsim_pallas`` / ``bitsim_pop_pallas``
in interpret mode and ``Netlist.eval_words``, bit for bit: random
netlists with all 10 gate functions, one word and word counts that are
no block multiple, mixed node counts through ``stack_netlists``,
compacted netlists (stale indices in unused inputs), and the word-block
plan of the CUDA kernels, whose wrappers refuse a netlist too large for
shared memory rather than fall back to the plain version.

The CUDA kernels are compared with their plain versions by the
``gpu``-marked tests (and ``chip_smoke.py``) on the card: the CGP
populations, a deep chain, a netlist that takes the serial walk reading
its netlist from device memory, every gate code in both walks and ragged
word counts (``python -m pytest -m gpu tests/test_torch_bitsim.py``; the
card's machine has no JAX, which only the CPU tests use)."""
import numpy as np
import pytest
import torch

from repro.core import gates
from repro.core.netlist import Netlist

try:
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels.bitsim import bitsim_pallas, bitsim_pop_pallas
except ImportError:     # the GPU machine: only the gpu-marked tests run
    jnp = ref_ops = bitsim_pallas = bitsim_pop_pallas = None
from repro_torch.core import netlist as port_netlist
from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
from repro_torch.kernels import bitsim as kbitsim
from repro_torch.kernels import ops, ref

# uint64 plane widths: 1 word, and counts whose uint32 lane totals
# (2, 6, 514) are not multiples of the CUDA word blocks or the
# reference's 512-lane block
PLANE_WORDS = (1, 3, 257)


def random_netlist(rng: np.random.Generator, n_i: int, n_o: int,
                   n_nodes: int) -> Netlist:
    """Random VALID netlist (the reference package's, so both sides see
    one object); the first nodes enumerate every gate function."""
    funcs = rng.integers(0, gates.N_FUNCS, n_nodes)
    k = min(gates.N_FUNCS, n_nodes)
    funcs[:k] = rng.permutation(gates.N_FUNCS)[:k]
    in0 = np.array([rng.integers(0, n_i + j) for j in range(n_nodes)])
    in1 = np.array([rng.integers(0, n_i + j) for j in range(n_nodes)])
    outputs = rng.integers(0, n_i + n_nodes, n_o)
    nl = Netlist(n_i=n_i, n_o=n_o, funcs=funcs.astype(np.int32),
                 in0=in0.astype(np.int32), in1=in1.astype(np.int32),
                 outputs=outputs.astype(np.int32))
    nl.validate()
    return nl


def _ref_bitsim(nl, planes64):
    """The reference's K10 in interpret mode, on uint64 planes."""
    out = bitsim_pallas(
        jnp.asarray(nl.funcs), jnp.asarray(nl.in0), jnp.asarray(nl.in1),
        jnp.asarray(nl.outputs),
        jnp.asarray(ops.split_planes64(planes64)), n_nodes=nl.n_nodes,
        n_i=nl.n_i, n_o=nl.n_o, interpret=True)
    return ops.join_planes32(np.asarray(out))


@pytest.mark.parametrize("w64", PLANE_WORDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitsim_matches_reference_and_eval_words(seed, w64):
    rng = np.random.default_rng(seed)
    n_i = int(rng.integers(1, 12))
    n_o = int(rng.integers(1, 8))
    nl = random_netlist(rng, n_i, n_o, int(rng.integers(gates.N_FUNCS, 60)))
    planes = rng.integers(0, 2 ** 64, (n_i, w64), dtype=np.uint64)
    got = ops.bitsim(nl, planes, "cpu")
    assert got.dtype == np.uint64 and got.shape == (n_o, w64)
    np.testing.assert_array_equal(got, nl.eval_words(planes))
    np.testing.assert_array_equal(got, _ref_bitsim(nl, planes))


@pytest.mark.parametrize("w64", PLANE_WORDS)
@pytest.mark.parametrize("seed", [3, 4])
def test_bitsim_pop_matches_reference_mixed_node_counts(seed, w64):
    """Population row p equals the reference's population kernel and
    ``netlists[p].eval_words``, with node counts mixed (padded with
    inactive const0 nodes)."""
    rng = np.random.default_rng(seed)
    n_i, n_o = int(rng.integers(1, 10)), int(rng.integers(1, 6))
    pop = [random_netlist(rng, n_i, n_o, int(rng.integers(gates.N_FUNCS,
                                                          40)))
           for _ in range(int(rng.integers(2, 7)))]
    planes = rng.integers(0, 2 ** 64, (n_i, w64), dtype=np.uint64)
    got = ops.bitsim_pop(pop, planes, "cpu")
    assert got.shape == (len(pop), n_o, w64)
    funcs, in0, in1, outs = port_netlist.stack_netlists(pop)
    want = bitsim_pop_pallas(
        *(jnp.asarray(a) for a in (funcs, in0, in1, outs)),
        jnp.asarray(ops.split_planes64(planes)), n_nodes=funcs.shape[1],
        n_i=n_i, n_o=n_o, interpret=True)
    np.testing.assert_array_equal(got,
                                  ops.join_planes32(np.asarray(want)))
    for p, nl in enumerate(pop):
        np.testing.assert_array_equal(got[p], nl.eval_words(planes))


def test_plain_versions_on_words_match_reference_oracles():
    """K10/K11's plain versions on int32 words (uint32 bit patterns)
    against the reference kernels on uint32 lanes, W = 1 and W = 10."""
    rng = np.random.default_rng(7)
    pop = [random_netlist(rng, 6, 3, 24) for _ in range(4)]
    arrs = port_netlist.stack_netlists(pop)
    for w in (1, 10):
        planes32 = rng.integers(0, 2 ** 32, (6, w), dtype=np.uint32)
        want = np.asarray(bitsim_pop_pallas(
            *(jnp.asarray(a) for a in arrs), jnp.asarray(planes32),
            n_nodes=24, n_i=6, n_o=3, interpret=True))
        words = ops.words_to_device(planes32, "cpu")
        tens = ops.netlist_tensors(arrs, 6, "cpu")
        got = ops.bitsim_pop_planes(*tens, words)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(ops.words_to_host(got), want)
        one = ops.bitsim_planes(*(t[1] for t in tens), words)
        np.testing.assert_array_equal(ops.words_to_host(one), want[1])


def test_const_only_and_compacted_netlists():
    """const gates read no inputs; a compacted netlist keeps stale
    indices in the inputs its gates do not use (past the signal count),
    which the simulators must not read."""
    zeros = np.zeros(2, dtype=np.int32)
    nl = Netlist(n_i=2, n_o=2, funcs=np.array([gates.CONST0, gates.CONST1],
                                              dtype=np.int32),
                 in0=zeros, in1=zeros, outputs=np.array([2, 3], np.int32))
    planes = np.random.default_rng(0).integers(0, 2 ** 64, (2, 1),
                                               dtype=np.uint64)
    got = ops.bitsim(nl, planes, "cpu")
    assert got[0, 0] == 0 and got[1, 0] == np.uint64(2 ** 64 - 1)
    stale = Netlist(n_i=2, n_o=1, funcs=np.array([gates.NOT], np.int32),
                    in0=np.array([1], np.int32),
                    in1=np.array([57], np.int32),
                    outputs=np.array([2], np.int32))
    np.testing.assert_array_equal(ops.bitsim(stale, planes, "cpu"),
                                  stale.eval_words(planes))
    mult = array_multiplier(4)
    rng = np.random.default_rng(1)
    from repro_torch.core.cgp import mutate
    for _ in range(5):
        mult = mutate(mult, rng, 6)
    small = mult.compact()
    ex = port_netlist.exhaustive_inputs(8)
    np.testing.assert_array_equal(ops.bitsim(small, ex, "cpu"),
                                  small.eval_words(ex))
    bad = Netlist(n_i=2, n_o=1, funcs=np.array([gates.AND], np.int32),
                  in0=np.array([1], np.int32), in1=np.array([5], np.int32),
                  outputs=np.array([2], np.int32))
    with pytest.raises(ValueError, match="feed-forward"):
        ops.bitsim(bad, planes, "cpu")


def test_word_block_plan_raises_past_shared_memory():
    """The CUDA kernels' word block from the signal count: the 8-bit
    adder (53 signals) takes 128-word blocks, the 8-bit multiplier (336)
    32 words (43 KB a block), and past 1816 signals —
    ``array_multiplier(32)``, 5952 — the kernel wrappers raise, naming
    the count, before they allocate or launch.  The plain version (CPU
    tensors through ``ops``) runs every size."""
    add8, mul8, mul32 = (ripple_carry_adder(8), array_multiplier(8),
                         array_multiplier(32))
    assert kbitsim.plan(add8.n_i + add8.n_nodes) == 128
    assert mul8.n_i + mul8.n_nodes == 336
    assert kbitsim.plan(336) == 32
    assert 336 * 32 * 4 <= kbitsim.SMEM_TARGET
    assert kbitsim.plan(1816) == 32
    with pytest.raises(ValueError, match="1817 signals"):
        kbitsim.plan(1817)
    assert mul32.n_i + mul32.n_nodes == 5952
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 2 ** 64, (mul32.n_i, 2), dtype=np.uint64)
    words = ops.words_to_device(ops.split_planes64(planes), "cpu")
    tens = ops.netlist_tensors((mul32.funcs, mul32.in0, mul32.in1,
                                mul32.outputs), mul32.n_i, "cpu")
    before = dict(ops.launch_counts())
    with pytest.raises(ValueError, match="5952 signals"):
        kbitsim.bitsim_words(*tens, words)
    with pytest.raises(ValueError, match="5952 signals"):
        kbitsim.bitsim_pop_words(*(t[None] for t in tens), words)
    assert ops.launch_counts() == before
    np.testing.assert_array_equal(ops.bitsim(mul32, planes, "cpu"),
                                  mul32.eval_words(planes))


def test_split_join_planes_round_trip():
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 2 ** 64, (3, 7), dtype=np.uint64)
    p32 = ops.split_planes64(planes)
    assert p32.shape == (3, 14) and p32.dtype == np.uint32
    np.testing.assert_array_equal(p32, ref_ops.split_planes64(planes))
    np.testing.assert_array_equal(ops.join_planes32(p32), planes)


def test_bitsim_wrappers_reject_bad_operands():
    nl = ripple_carry_adder(2)
    tens = ops.netlist_tensors((nl.funcs, nl.in0, nl.in1, nl.outputs),
                               nl.n_i, "cpu")
    words = torch.zeros((nl.n_i, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="netlist arrays"):
        ops.bitsim_pop_planes(*tens, words)
    with pytest.raises(TypeError, match="int32"):
        ops.bitsim_planes(*tens, words.long())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.bitsim_planes(*(t.to("meta") for t in tens), words.to("meta"))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["add8", "mul8"])
def test_cuda_bitsim_kernels_match_plain(cuda, which):
    """K10 and K11 against their plain versions on the card: the 8-bit
    adder at 128-word blocks, the 8-bit multiplier at 32."""
    seed = {"add8": ripple_carry_adder(8),
            "mul8": array_multiplier(8)}[which]
    rng = np.random.default_rng(3)
    from repro_torch.core.cgp import mutate
    pop = [seed]
    for _ in range(31):
        pop.append(mutate(pop[-1], rng, 4))
    planes = rng.integers(0, 2 ** 64, (seed.n_i, 128), dtype=np.uint64)
    words = ops.words_to_device(ops.split_planes64(planes), cuda)
    tens = ops.netlist_tensors(port_netlist.stack_netlists(pop), seed.n_i,
                               cuda)
    ops.reset_launch_counts()
    got = ops.bitsim_pop_planes(*tens, words)
    one = ops.bitsim_planes(*(t[5].contiguous() for t in tens), words)
    want = ref.bitsim_pop_ref(*tens, words)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(one, want[5])
    assert ops.launch_counts()["bitsim_pop"] == 1
    assert ops.launch_counts()["bitsim"] == 1


def _cuda_equal_plain(cuda, netlists, n_i, w, seed=0):
    """K11 on ``netlists`` and K10 on each one over ``w`` random words,
    each equal to its plain version bit for bit; one launch a call."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2 ** 32, (n_i, w), dtype=np.uint64)
    words = ops.words_to_device(planes.astype(np.uint32), cuda)
    tens = ops.netlist_tensors(port_netlist.stack_netlists(netlists), n_i,
                               cuda)
    ops.reset_launch_counts()
    got = ops.bitsim_pop_planes(*tens, words)
    want = ref.bitsim_pop_ref(*tens, words)
    assert torch.equal(got, want)
    for nl in netlists:
        one = ops.netlist_tensors((nl.funcs, nl.in0, nl.in1, nl.outputs),
                                  n_i, cuda)
        assert torch.equal(ops.bitsim_planes(*one, words),
                           ref.bitsim_ref(*one, words))
    torch.cuda.synchronize()
    assert ops.launch_counts()["bitsim_pop"] == 1
    assert ops.launch_counts()["bitsim"] == len(netlists)


def _chain(n_nodes: int, n_i: int = 2) -> Netlist:
    """Gate j reads gate j - 1 (and an earlier signal): depth n_nodes,
    the gate codes in turn."""
    nl = Netlist(n_i=n_i, n_o=3,
                 funcs=np.array([j % gates.N_FUNCS for j in range(n_nodes)],
                                np.int32),
                 in0=np.array([n_i - 1 + j for j in range(n_nodes)],
                              np.int32),
                 in1=np.array([j // 2 for j in range(n_nodes)], np.int32),
                 outputs=np.array([n_i + n_nodes - 1, n_i + n_nodes // 2,
                                   0], np.int32))
    nl.validate()
    return nl


@pytest.mark.gpu
def test_cuda_bitsim_deep_chain(cuda):
    """A 1000-gate chain (1000 levels, the level walk at its deepest)
    and a 60-gate one (the serial walk)."""
    long, short = _chain(1000), _chain(60)
    assert kbitsim.walk_plan(2, 1000, 1, 100).walk == "level"
    assert kbitsim.walk_plan(2, 60, 2, 300).walk == "serial"
    _cuda_equal_plain(cuda, [long], 2, 100)
    _cuda_equal_plain(cuda, [short, _chain(45)], 2, 300)


@pytest.mark.gpu
def test_cuda_bitsim_serial_walk_from_device_memory(cuda):
    """1806 signals: the scratch and staged descriptors pass 227 KB, so
    the kernel walks serially with the netlist read through __ldg."""
    rng = np.random.default_rng(11)
    pop = [random_netlist(rng, 16, 8, 1790) for _ in range(3)]
    assert kbitsim.walk_plan(16, 1790, 3, 70).walk == "serial_global"
    _cuda_equal_plain(cuda, pop, 16, 70)


@pytest.mark.gpu
@pytest.mark.parametrize("n_nodes", [40, 400])
def test_cuda_bitsim_every_gate_code(cuda, n_nodes):
    """Every gate code on random inputs, in the serial walk (40 gates)
    and the level walk (400)."""
    rng = np.random.default_rng(n_nodes)
    pop = [random_netlist(rng, 6, 12, n_nodes) for _ in range(4)]
    assert {int(f) for nl in pop for f in nl.funcs} == set(range(10))
    assert kbitsim.walk_plan(6, n_nodes, 4, 77).walk == (
        "serial" if n_nodes == 40 else "level")
    _cuda_equal_plain(cuda, pop, 6, 77)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 33, 257, 1000])
@pytest.mark.parametrize("which", ["add8", "mul8"])
def test_cuda_bitsim_ragged_words(cuda, which, w):
    """Word counts that are no multiple of the 128- (add8) or 32-word
    (mul8) block; mul8's population takes the level walk up to 257
    words and the serial walk at 1000 (192 blocks), K10 the level
    walk."""
    from repro_torch.core.cgp import mutate
    seed = {"add8": ripple_carry_adder(8),
            "mul8": array_multiplier(8)}[which]
    rng = np.random.default_rng(w)
    pop = [seed] + [mutate(seed, rng, 4) for _ in range(5)]
    _cuda_equal_plain(cuda, pop, seed.n_i, w)
