"""The kernel wrappers of the port (``repro_torch.kernels.ops``) against
the reference's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) and its ``ref.py`` oracles: int32
sums bit for bit on ragged shapes.  On the CPU the wrappers run the
kernels' plain versions; the CUDA kernels themselves are compared with
those plain versions by the ``gpu``-marked tests (and ``chip_smoke.py``)
on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.library import build_default_library as ref_build
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.approx.registry import MAX_LUT_K
from repro_torch.kernels import build, ops, ref

RNG = np.random.default_rng(7)


def _codes(*shape):
    return RNG.integers(0, 256, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def library_luts():
    lib = ref_build("tiny")
    names = [e.name for e in lib.case_study_selection()][-3:]
    return np.stack([lib.lut(n) for n in names]).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(70, 130, 50), (1, 1, 1), (129, 33, 10)])
def test_lut_matches_reference_kernel(m, k, n):
    qa, qw = _codes(m, k), _codes(k, n)
    lut = RNG.integers(0, 1 << 16, (256, 256)).astype(np.int32)
    lut[0, 0] = 4321                              # K-pad correction case
    want = np.asarray(ref_ops.approx_matmul_lut(
        jnp.asarray(qa), jnp.asarray(qw), jnp.asarray(lut)))
    got = ops.approx_matmul_lut(_t(qa), _t(qw), _t(lut))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_real_multipliers_match_oracle(library_luts):
    qa, qw = _codes(300, 144), _codes(144, 16)
    for lut in library_luts:
        want = np.asarray(ref_ref.approx_matmul_lut_ref(
            jnp.asarray(qa), jnp.asarray(qw), jnp.asarray(lut)))
        for table in (_t(lut), _t(lut.astype(np.uint16))):
            np.testing.assert_array_equal(
                ops.approx_matmul_lut(_t(qa), _t(qw), table).numpy(), want)


@pytest.mark.parametrize("banked", [False, True])
def test_bank_matches_reference_kernel(banked, library_luts):
    m, k, n = 45, 77, 19
    luts = np.concatenate([library_luts,
                           RNG.integers(0, 1 << 16, (1, 256, 256))]
                          ).astype(np.int32)
    luts[-1, 0, 0] = 99
    qa = _codes(len(luts), m, k) if banked else _codes(m, k)
    qw = _codes(k, n)
    want = np.asarray(ref_ops.approx_matmul_lut_bank(
        jnp.asarray(qa), jnp.asarray(qw), jnp.asarray(luts)))
    got = ops.approx_matmul_lut_bank(_t(qa), _t(qw), _t(luts))
    assert tuple(got.shape) == (len(luts), m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(len(luts)):                    # lane b == single LUT
        np.testing.assert_array_equal(
            got[b].numpy(),
            ops.approx_matmul_lut(_t(qa[b] if banked else qa), _t(qw),
                                  _t(luts[b])).numpy())


def test_plain_versions_match_reference_oracles(library_luts):
    qa, qw = _codes(3, 31, 20), _codes(20, 9)
    want = np.asarray(ref_ref.approx_matmul_lut_bank_ref(
        jnp.asarray(qa), jnp.asarray(qw), jnp.asarray(library_luts)))
    np.testing.assert_array_equal(
        ref.approx_matmul_lut_bank_ref(_t(qa), _t(qw),
                                       _t(library_luts)).numpy(), want)


def test_wrapper_rejects_lut_outside_16_bits():
    qa, qw = _t(_codes(4, 5)), _t(_codes(5, 3))
    lut = np.zeros((256, 256), np.int32)
    lut[3, 7] = 1 << 16
    with pytest.raises(ValueError, match="65535"):
        ops.approx_matmul_lut(qa, qw, _t(lut))
    lut[3, 7] = -1
    with pytest.raises(ValueError, match="65535"):
        ops.approx_matmul_lut(qa, qw, _t(lut))
    luts = np.zeros((2, 256, 256), np.int32)
    luts[1, 0, 0] = 70000
    with pytest.raises(ValueError, match="65535"):
        ops.approx_matmul_lut_bank(qa, qw, _t(luts))


def test_wrapper_rejects_bad_operands():
    lut = _t(np.zeros((256, 256), np.int32))
    qa, qw = _t(_codes(4, 5)), _t(_codes(5, 3))
    k = MAX_LUT_K + 1
    with pytest.raises(ValueError, match="int32-safe"):
        ops.approx_matmul_lut(torch.zeros((1, k), dtype=torch.int32),
                              torch.zeros((k, 1), dtype=torch.int32), lut)
    with pytest.raises(TypeError, match="int32"):
        ops.approx_matmul_lut(qa.long(), qw, lut)
    with pytest.raises(ValueError, match="contiguous"):
        ops.approx_matmul_lut(_t(_codes(5, 4)).T, qw, lut)
    with pytest.raises(ValueError, match="contraction"):
        ops.approx_matmul_lut(qa, _t(_codes(6, 3)), lut)
    with pytest.raises(ValueError, match="LUT shape"):
        ops.approx_matmul_lut(qa, qw, lut[:128])
    with pytest.raises(TypeError, match="LUT must be"):
        ops.approx_matmul_lut(qa, qw, lut.float())
    luts = _t(np.zeros((2, 256, 256), np.int32))
    with pytest.raises(ValueError, match="lanes"):
        ops.approx_matmul_lut_bank(_t(_codes(3, 4, 5)), qw, luts)


def test_no_plain_fallback_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version:
    it launches a CUDA kernel or raises."""
    qa = torch.zeros((4, 5), dtype=torch.int32, device="meta")
    qw = torch.zeros((5, 3), dtype=torch.int32, device="meta")
    lut = torch.zeros((256, 256), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.approx_matmul_lut(qa, qw, lut)


def test_launch_counters_untouched_on_cpu():
    ops.reset_launch_counts()
    ops.approx_matmul_lut(_t(_codes(4, 5)), _t(_codes(5, 3)),
                          _t(np.ones((256, 256), np.int32)))
    assert set(ops.launch_counts().values()) == {0}
    assert {"lut_matmul", "lut_matmul_bank"} <= set(ops.launch_counts())


def test_build_names_by_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    path = build.library_path("lut_matmul")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("lut_matmul-") and path.suffix == ".so"
    assert build.library_path("lut_matmul") == path       # stable
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(65536, 27, 16), (4096, 576, 64),
                                   (1000, 37, 10), (129, 577, 65)])
def test_cuda_kernels_match_plain(cuda, m, k, n, library_luts):
    gen = torch.Generator(device=cuda).manual_seed(0)
    qa = torch.randint(0, 256, (m, k), generator=gen, device=cuda,
                       dtype=torch.int32)
    qw = torch.randint(0, 256, (k, n), generator=gen, device=cuda,
                       dtype=torch.int32)
    luts = torch.from_numpy(library_luts).to(cuda)
    ops.reset_launch_counts()
    got = ops.approx_matmul_lut(qa, qw, luts[0])
    assert torch.equal(got, ref.approx_matmul_lut_ref(qa, qw, luts[0]))
    got = ops.approx_matmul_lut_bank(qa, qw, luts)
    assert torch.equal(got, ref.approx_matmul_lut_bank_ref(qa, qw, luts))
    counts = ops.launch_counts()
    assert counts["lut_matmul"] == counts["lut_matmul_bank"] == 1
