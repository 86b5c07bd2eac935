"""The low-rank slice of the port against the reference: the plain
version of kernel K9 (``kernels.ref.lowrank_matmul_ref``, which
``ops.lowrank_matmul`` runs for CPU tensors) against the reference's
``lowrank_matmul_pallas`` in interpret mode and its ``ref.py`` oracle;
``pack_lowrank`` / ``_resolve_rank``; ``backend_matmul`` under the
``lowrank`` and ``lowrank_pallas`` specs; prepared weights.

Tolerance.  The kernel, the plain version and the reference's two
versions sum the same K·R products in different orders, so they are not
bit-equal.  Every result ``y`` is held to the bound of
``kernels.ref.lowrank_bound``: ``|y - y64| <= 2 (K R + 1) 2^-24 S``
elementwise, with ``y64`` the same sum in float64 and ``S = Σ_r
|U_r(qa)| @ |V_r(qw)|`` in float64 (for the reference's Pallas kernel,
which sums a K padded to a multiple of 128 and subtracts the pad's
terms afterwards, the pad's terms join S and the term count).  Through
``backend_matmul`` the difference of two such sums is scaled by ``sa · sw`` and the f32
epilogue adds a few roundings of its own terms: ``_DEQUANT_ULPS``
ulps (2^-24 relative) of their magnitudes.  Factors, rank choices and
prepared tables come from the same numpy SVD and quantization, so they
are equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import backend as ref_backend
from repro.approx import registry as ref_reg
from repro.approx.specs import BackendSpec as RefSpec
from repro.core.library import build_default_library as ref_build
from repro.core.luts import decompose_lut, exact_mul_lut
from repro.kernels import ref as ref_ref
from repro.kernels.lowrank_matmul import lowrank_matmul_pallas
from repro_torch.approx import backend as port_backend
from repro_torch.approx import registry as port_reg
from repro_torch.approx.quant import calibrate, quantize
from repro_torch.approx.specs import BackendSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lowrank_matmul import (MAX_RANK, MIN_MMA_TERMS,
                                                MMA_TILE, STREAM_ROWS,
                                                STREAM_TILE, mma_chunk)
from repro_torch.kernels.lowrank_matmul import plan as lowrank_plan
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


RNG = np.random.default_rng(21)
_DEQUANT_ULPS = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(*shape):
    return RNG.integers(0, 256, shape).astype(np.int32)


def _assert_within_bound(y, qa, qw, u, v, pk=0):
    """``pk``: K padding the reference's Pallas kernel sums and then
    subtracts (``pk·Σ_r U[r,0]V[r,0]``); its pad terms join S and the
    term count, since that kernel sums them."""
    y64, tol = ref.lowrank_bound(_t(qa), _t(qw), _t(u), _t(v))
    if pk:
        k, r = qa.shape[1], u.shape[0]
        corner = float(np.abs(u[:, 0].astype(np.float64)
                              * v[:, 0].astype(np.float64)).sum())
        s = tol / (2.0 * (k * r + 1) * 2.0 ** -24) + pk * corner
        tol = 2.0 * ((k + pk) * r + 2) * 2.0 ** -24 * s
    err = (torch.tensor(np.asarray(y)).double() - y64).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.fixture(scope="module")
def libs():
    lib = ref_build("tiny")
    names = ["mul8u_exact"] + [e.name for e in
                               lib.case_study_selection()][-3:]
    return lib, names


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("m,k,n", [(37, 29, 11), (7, 130, 65),
                                   (130, 257, 129), (1, 1, 1)], ids=str)
def test_plain_matches_reference_kernels(m, k, n, r):
    """K9's plain version, the reference's Pallas kernel (interpret
    mode, K padding corrected) and its oracle all hold the bound on
    ragged shapes, K > 128 included; ``ops.lowrank_matmul`` on CPU
    tensors is the plain version."""
    qa, qw = _codes(m, k), _codes(k, n)
    u = (RNG.normal(size=(r, 256)) * 16).astype(np.float32)
    v = (RNG.normal(size=(r, 256)) * 16).astype(np.float32)
    u[:, 0] = 7.5                        # a K-pad correction that matters
    plain = ref.lowrank_matmul_ref(_t(qa), _t(qw), _t(u), _t(v))
    assert plain.dtype == torch.float32 and plain.shape == (m, n)
    assert torch.equal(ops.lowrank_matmul(_t(qa), _t(qw), _t(u), _t(v)),
                       plain)
    args = tuple(jnp.asarray(a) for a in (qa, qw, u, v))
    for y in (plain, ref_ref.lowrank_matmul_ref(*args)):
        _assert_within_bound(y, qa, qw, u, v)
    _assert_within_bound(lowrank_matmul_pallas(*args, interpret=True), qa,
                         qw, u, v, pk=(-k) % 128)


@pytest.mark.parametrize("rank", [None, 1, 4])
def test_pack_lowrank_and_resolve_rank_equal_reference(libs, rank):
    lib, names = libs
    for name in names:
        lut = np.asarray(lib.lut(name), np.int32)
        want = RefSpec(mode="lowrank", multiplier=name, rank=rank)
        got = BackendSpec(mode="lowrank", multiplier=name, rank=rank)
        assert (port_reg._resolve_rank(got, lib, lut)
                == ref_reg._resolve_rank(want, lib, lut))
        pw, pg = ref_reg.pack_lowrank(want, lib), port_reg.pack_lowrank(
            got, lib)
        for key in ("u", "v"):
            assert pg[key].dtype == np.float32
            np.testing.assert_array_equal(pg[key], pw[key])


def _backend_tol(x, w, consts, k):
    """|port - reference| allowed through ``backend_matmul``: twice the
    raw-sum bound scaled by sa·sw, plus ``_DEQUANT_ULPS`` ulps of the
    epilogue's terms."""
    qp_a, qp_w = calibrate(_t(x)), calibrate(_t(w))
    qa, qw = quantize(_t(x), qp_a), quantize(_t(w), qp_w)
    u, v = _t(consts["u"]), _t(consts["v"])
    y64, tol = ref.lowrank_bound(qa, qw, u, v)
    row = qa.double().sum(1, keepdim=True) * qp_w.zero_point.double()
    col = qw.double().sum(0, keepdim=True) * qp_a.zero_point.double()
    terms = (y64.abs() + tol + row + col
             + k * qp_a.zero_point.double() * qp_w.zero_point.double())
    scale = float(qp_a.scale) * float(qp_w.scale)
    return ((2 * tol + _DEQUANT_ULPS * 2.0 ** -24 * terms) * scale).numpy()


@pytest.mark.parametrize("variant", ["ref", "pallas"])
@pytest.mark.parametrize("shape", [(37, 29, 11), (4, 300, 20),
                                   (33, 130, 65)], ids=str)
def test_backend_matmul_lowrank_matches_reference(libs, shape, variant):
    lib, names = libs
    m, k, n = shape
    x = RNG.normal(0.3, 1.5, (m, k)).astype(np.float32)
    w = RNG.normal(0.0, 0.2, (k, n)).astype(np.float32)
    for name in names[1:]:
        for rank in (None, 4):
            want_mb = RefSpec(mode="lowrank", multiplier=name, rank=rank,
                              variant=variant).materialize(lib)
            want = np.asarray(jax.jit(lambda a, b: ref_backend.backend_matmul(
                a, b, want_mb))(jnp.asarray(x), jnp.asarray(w)))
            mb = BackendSpec(mode="lowrank", multiplier=name, rank=rank,
                             variant=variant).materialize(lib)
            assert mb.datapath.name == ("lowrank" if variant == "ref"
                                        else "lowrank_pallas")
            got = port_backend.backend_matmul(_t(x), _t(w), mb).numpy()
            tol = _backend_tol(x, w, mb.consts, k)
            assert (np.abs(got - want) <= tol).all(), (name, rank)


def test_prepare_weight_equals_reference(libs):
    lib, names = libs
    x = RNG.normal(0.3, 1.5, (24, 96)).astype(np.float32)
    w = RNG.normal(0.0, 0.2, (96, 40)).astype(np.float32)
    want_mb = RefSpec(mode="lowrank", multiplier=names[-1],
                      rank=4).materialize(lib)
    mb = BackendSpec(mode="lowrank", multiplier=names[-1],
                     rank=4).materialize(lib)
    want = jax.jit(lambda a: ref_backend.prepare_weight(a, want_mb))(
        jnp.asarray(w))
    got = port_backend.prepare_weight(_t(w), mb)
    assert port_backend.is_prepared(got)
    assert got["tabs"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["tabs"].float().numpy(),
        np.asarray(want["tabs"].astype(jnp.float32)))
    for key in ("colsum", "w_scale", "w_zp"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    y_want = np.asarray(jax.jit(lambda a: ref_backend.backend_matmul(
        a, want, want_mb))(jnp.asarray(x)))
    y_got = port_backend.backend_matmul(_t(x), got, mb).numpy()
    # the prepared product sums bf16-rounded tables; its own bound
    u16 = _t(mb.consts["u"]).to(torch.bfloat16).float().numpy()
    tabs = got["tabs"].float()
    qa = quantize(_t(x), calibrate(_t(x)))
    s = torch.einsum("rmk,rkn->mn", _t(u16).double()[:, qa.long()].abs(),
                     tabs.double().abs())
    scale = float(calibrate(_t(x)).scale) * float(got["w_scale"])
    tol = (2 * 2 * (96 * 4 + 1) * 2.0 ** -24 * s.numpy()
           + _DEQUANT_ULPS * 2.0 ** -24 * (s.numpy() + 255 * 255 * 96)
           ) * scale
    assert (np.abs(y_got - y_want) <= tol).all()


def test_prepare_tree_on_a_stacked_tree(libs):
    lib, names = libs
    mb = BackendSpec(mode="lowrank", multiplier=names[-1],
                     rank=4).materialize(lib)
    want_mb = RefSpec(mode="lowrank", multiplier=names[-1],
                      rank=4).materialize(lib)
    tree = {"embed": RNG.normal(size=(16, 8)).astype(np.float32),
            "blocks": {"wq": RNG.normal(size=(3, 8, 12)).astype(np.float32),
                       "norm1": np.ones((3, 8), np.float32),
                       "ffn": {"wo": RNG.normal(size=(3, 12, 8)).astype(
                           np.float32)}}}
    port_tree = jax.tree.map(_t, tree)
    got = port_backend.prepare_tree(port_tree, mb)
    want = jax.jit(lambda t: ref_backend.prepare_tree(t, want_mb))(
        jax.tree.map(jnp.asarray, tree))
    assert torch.equal(got["embed"], port_tree["embed"])
    assert torch.equal(got["blocks"]["norm1"], port_tree["blocks"]["norm1"])
    for leaf, path in ((got["blocks"]["wq"], ("blocks", "wq")),
                       (got["blocks"]["ffn"]["wo"], ("blocks", "ffn", "wo"))):
        ref_leaf = want
        for p in path:
            ref_leaf = ref_leaf[p]
        assert leaf["tabs"].shape[0] == 3
        for key in ("tabs", "colsum", "w_scale", "w_zp"):
            np.testing.assert_array_equal(
                leaf[key].float().numpy(),
                np.asarray(ref_leaf[key]).astype(np.float32))
        w = port_tree
        for p in path:
            w = w[p]
        one = port_backend.prepare_weight(w[1], mb)
        assert torch.equal(leaf["tabs"][1], one["tabs"])


def test_rank1_exact_lut_emulates_exact_product():
    """Rank 1 of the exact LUT is the exact integer product (the port of
    tests/test_kernels.py's rank-1 check), and holds the bound."""
    lut = exact_mul_lut(8)
    fac = decompose_lut(lut, 1)
    qa, qw = _codes(32, 64), _codes(64, 16)
    got = ops.lowrank_matmul(_t(qa), _t(qw), _t(fac.u), _t(fac.v)).numpy()
    want = (qa.astype(np.int64) @ qw.astype(np.int64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.0)
    _assert_within_bound(got, qa, qw, fac.u, fac.v)


def test_rank_above_kernel_limit_raises():
    qa, qw = _t(_codes(4, 8)), _t(_codes(8, 4))
    ops.reset_launch_counts()
    for r in (MAX_RANK + 1, 0):
        u = torch.ones((r, 256))
        with pytest.raises(ValueError, match=f"R={r}"):
            ops.lowrank_matmul(qa, qw, u, u)
    ok = torch.ones((MAX_RANK, 256))
    assert ops.lowrank_matmul(qa, qw, ok, ok).shape == (4, 4)
    assert ops.launch_counts()["lowrank_matmul"] == 0    # CPU: no launch
    with pytest.raises(TypeError):
        ops.lowrank_matmul(qa.float(), qw, ok, ok)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


def _cuda_case(cuda, m, k, n, r, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qa = torch.randint(0, 256, (m, k), generator=gen, dtype=torch.int32,
                       device=cuda)
    qw = torch.randint(0, 256, (k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    u = torch.randn((r, 256), generator=gen, device=cuda) * 16
    v = torch.randn((r, 256), generator=gen, device=cuda) * 16
    return qa, qw, u, v


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 4, MAX_RANK])
@pytest.mark.parametrize("n", [1, 65, 1024])
@pytest.mark.parametrize("k", [577, 2816])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 128, 129])
def test_cuda_lowrank_kernel_matches_plain(cuda, m, k, n, r):
    """Both regimes (stream up to ``STREAM_ROWS`` rows, 3xTF32 tensor
    cores above) and their K splits, at ragged K and N: one launch, and
    the kernel and its plain version within the f32 bound."""
    qa, qw, u, v = _cuda_case(cuda, m, k, n, r)
    ops.reset_launch_counts()
    got = ops.lowrank_matmul(qa, qw, u, v)
    plain = ref.lowrank_matmul_ref(qa, qw, u, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lowrank_matmul"] == 1
    y64, tol = ref.lowrank_bound(qa, qw, u, v)
    for y in (got, plain):
        assert y.shape == (m, n)
        assert bool(((y.double() - y64).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2816, 1024), (128, 1024, 1024),
                                   (129, 577, 65)])
def test_cuda_lowrank_kernel_is_deterministic(cuda, m, k, n):
    """The split-K partials are summed in a fixed order inside the
    launch: two calls on the same inputs give the same bits."""
    assert lowrank_plan(m, k, n, 4).splits > 1
    qa, qw, u, v = _cuda_case(cuda, m, k, n, 4, seed=1)
    first = ops.lowrank_matmul(qa, qw, u, v)
    second = ops.lowrank_matmul(qa, qw, u, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


_SERVE_SHAPES = [(128, 1024, 1024), (128, 1024, 2816), (128, 2816, 1024),
                 (4, 1024, 1024), (4, 1024, 2816), (4, 2816, 1024)]


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("shape", _SERVE_SHAPES + [
    (129, 577, 65), (7, 130, 1), (1, 1, 1), (17, 577, 1), (128, 10, 64),
    (40, 0, 3)], ids=str)
def test_lowrank_plan(shape, r):
    """The wrapper's regime and K split: stream up to ``STREAM_ROWS``
    rows or below ``MIN_MMA_TERMS`` terms, tensor cores otherwise; the
    slices cover K exactly, each within its regime's step and limits;
    the serve shapes fill the card."""
    m, k, n = shape
    p = lowrank_plan(m, k, n, r)
    mma = m > STREAM_ROWS and k * r >= MIN_MMA_TERMS
    assert p.regime == ("mma" if mma else "stream")
    bm, bn = MMA_TILE if mma else STREAM_TILE
    rows = m if not mma and m <= STREAM_ROWS else bm
    assert p.tiles == -(-m // rows) * -(-n // bn)
    assert p.splits >= 1 and p.k_per_split >= 1
    assert p.splits * p.k_per_split >= k
    assert p.splits == 1 or (p.splits - 1) * p.k_per_split < k
    if p.splits > 1:
        step = mma_chunk(r) if mma else 8
        assert p.k_per_split % step == 0
        assert (p.k_per_split >= 128) if mma else (p.k_per_split <= 128)
    if shape in _SERVE_SHAPES:
        assert p.blocks >= 2 * 132 - 8
        assert p.regime == ("stream" if m == 4 else "mma")


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 bits: round to 10 mantissa bits, ties
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_tf32(qa, qw, u, v, splits):
    """The tensor-core regime's arithmetic on the CPU: each gathered
    operand split into hi = tf32(x) and lo = tf32(x - hi), every product
    taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (each exact in f32) and
    summed in f32, slice by slice, the slices summed in order."""
    r = u.shape[0]
    m, k = qa.shape
    a = u[:, qa.long()].permute(1, 0, 2)            # (M, R, K)
    b = v[:, qw.long()]                             # (R, K, N)
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    kps = -(-k // splits)
    out = None
    for k0 in range(0, k, kps):
        sl = slice(k0, k0 + kps)
        lhs = torch.cat([t[:, :, sl].reshape(m, -1)
                         for t in (a_lo, a_hi, a_hi)], 1)
        rhs = torch.cat([t[:, sl].reshape(-1, t.shape[-1])
                         for t in (b_hi, b_lo, b_hi)], 0)
        part = lhs @ rhs
        out = part if out is None else out + part
    return out


@pytest.fixture(scope="module")
def served():
    """The multiplier the serve path picks from the default library
    (non-integer factors, unlike the tiny library's truncations)."""
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.steps import pick_case_multiplier
    return get_default_library(), pick_case_multiplier()


@pytest.mark.parametrize("k", [1024, 2816])
def test_three_tf32_split_holds_the_bound(libs, served, k):
    """The numeric argument for the tensor-core regime, before any card:
    the 3xTF32 split of the gathered factor tables (rank 4 and the auto
    rank of the served multiplier and of each of the fixture's) holds
    ``ref.lowrank_bound`` at the serve path's K, with the K split the
    plan gives M = 128, at under 5% of the bound (a single TF32 product
    reaches about half of it on the served factors)."""
    qa, qw = _t(_codes(24, k)), _t(_codes(k, 40))
    splits = lowrank_plan(128, k, 1024, 4).splits
    cases = [(served[0], served[1])] + [(libs[0], n) for n in libs[1]]
    for lib, name in cases:
        for rank in (4, None):
            c = port_reg.pack_lowrank(
                BackendSpec(mode="lowrank", multiplier=name, rank=rank), lib)
            u, v = _t(c["u"]), _t(c["v"])
            assert float(u.abs().max()) > 100         # values reach ~255
            y = _three_tf32(qa, qw, u, v, splits)
            y64, tol = ref.lowrank_bound(qa, qw, u, v)
            err = (y.double() - y64).abs()
            assert bool((err <= tol).all()), (name, rank)
            assert bool((err <= 0.05 * tol).all()), (name, rank)
