"""The expert form of K9 and K5-K8 and of every other mode: an MoE
projection's experts in one datapath call, as the reference's
``jax.vmap`` over experts runs them (``pallas_call``'s batching rule for
K9, the ``qw_b`` branches of the composed ops' ``custom_vmap``).

On the CPU (one torch thread, seeded numpy inputs, reduced widths):
  * K9's expert form (``ops.lowrank_matmul`` with stacked ``(E, K, N)``
    codes: its plain version ``ref.lowrank_matmul_experts_ref``) against
    the reference's ``jax.vmap`` over experts of ``ops.lowrank_matmul``
    (Pallas in interpret mode), every slice within the f32 bound of
    ``ref.lowrank_bound`` (the reference's K pad joining the bound, as in
    ``test_torch_lowrank.py``), a starved expert's all-zero codes and two
    token blocks' buffers among the cases;
  * the composed expert forms (K5 on a 12- and a 16-bit entry, K6 on a
    mixed-width bank with per-lane weight codes, K7 and K8 on floats, K8
    mixing widths and trees) against the reference's nested ``vmap``
    (lanes outside, experts inside) bit for bit;
  * ``models.moe._expert_matmul`` under ``lowrank`` (``ref`` and
    ``pallas``), ``lowrank`` on prepared weights (the fault this slice
    repairs: ``prepare_tree``'s stacked dict reached ``w.shape``),
    composed ``lut`` (``pallas`` and ``fused``, an entry and a
    mixed-width bank), ``int8``, ``f32`` and ``bf16`` against the
    reference's ``_expert_matmul``: ``int8`` and composed bit for bit,
    the others within their stated bounds, in one ``policy.matmul`` call
    and one datapath call a projection (no per-expert call);
  * ``MaterializedBackend.rank`` against the reference's.

On the card (``gpu``-marked, no JAX needed: ``python -m pytest -m gpu
tests/test_torch_moe_experts_rest.py``): K9's expert form against E
launches without the axis within the bound, and K5-K8's bit for bit.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.approx import backend as port_backend
from repro_torch.approx import registry as port_reg
from repro_torch.approx.layers import ApproxPolicy, bank_backend
from repro_torch.approx.quant import calibrate_slices, pair_scalars, quantize
from repro_torch.approx.specs import BackendSpec, bank_for
from repro_torch.kernels import datapaths, ops, ref

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG_SEED = 31
#: |port - reference| of a float-mode product, in units of 2^-24 of
#: K·Σ|x||w|: both sum K exact f32 (or bf16) products in f32, each sum
#: within K·2^-24·Σ|x||w| of the exact one whatever its order
F32_ULPS = 2
#: ulps (2^-24 relative) of its terms the lowrank f32 epilogue adds
#: (``test_torch_lowrank.py``'s ``_DEQUANT_ULPS``)
DEQUANT_ULPS = 8
#: (E experts, token blocks, M, K, N) of the K9 kernel cases: K a
#: multiple of 8 and ragged (the reference pads K to 128 and subtracts
#: the pad's terms), and two blocks' buffers over the same experts
K9_SHAPES = ((3, 1, 4, 64, 24), (2, 1, 5, 130, 9), (2, 2, 3, 33, 7))


def _ref_modules():
    """The reference's modules (JAX on the CPU; imported here, so the
    card's tests run without JAX)."""
    import jax
    import jax.numpy as jnp
    from repro.approx import quant as ref_quant
    from repro.approx import registry as ref_reg
    from repro.kernels import ops as ref_ops
    return jax, jnp, ref_quant, ref_reg, ref_ops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(n: int, seed: int) -> np.ndarray:
    """n random 16-bit tile tables, LUT[0,0] != 0."""
    t = np.random.default_rng(seed).integers(0, 1 << 16, (n, 256, 256))
    t[:, 0, 0] = 4321
    return t.astype(np.int32)


# ----------------------------------------------------------------------
# K9
# ----------------------------------------------------------------------
def _bound(qa, qw, u, v, pk: int = 0):
    """``ref.lowrank_bound`` of each slice s of qa (X,M,K) against qw[s %
    E]; ``pk``: the K pad the reference's Pallas kernel sums and then
    subtracts, whose terms join S and the term count."""
    y64, tol = ref.lowrank_bound_experts(_t(qa), _t(qw), _t(u), _t(v))
    if pk:
        k, r = qa.shape[-1], u.shape[0]
        corner = float(np.abs(u[:, 0].astype(np.float64)
                              * v[:, 0].astype(np.float64)).sum())
        s = tol / (2.0 * (k * r + 1) * 2.0 ** -24) + pk * corner
        tol = 2.0 * ((k + pk) * r + 2) * 2.0 ** -24 * s
    return y64, tol


def _within(y, bound) -> bool:
    y64, tol = bound
    return bool(((torch.as_tensor(np.array(y)).double() - y64).abs()
                 <= tol).all())


@pytest.mark.parametrize("e,blocks,m,k,n", K9_SHAPES)
def test_lowrank_expert_form_matches_reference_vmap(e, blocks, m, k, n):
    """K9's expert form (plain) and the reference's vmap over experts of
    ``lowrank_matmul`` both hold every slice's bound; each slice equals
    the call without the axis bit for bit."""
    jax, jnp, _, _, ref_ops = _ref_modules()
    rng = np.random.default_rng(RNG_SEED)
    qa = rng.integers(0, 256, (blocks * e, m, k)).astype(np.int32)
    qa[1] = 0                                   # a starved expert's codes
    qw = rng.integers(0, 256, (e, k, n)).astype(np.int32)
    u = (rng.normal(size=(4, 256)) * 16).astype(np.float32)
    v = (rng.normal(size=(4, 256)) * 16).astype(np.float32)
    u[:, 0] = 7.5                               # a pad term that matters
    got = ops.lowrank_matmul(_t(qa), _t(qw), _t(u), _t(v))
    assert got.shape == (blocks * e, m, n) and got.dtype == torch.float32
    assert torch.equal(got, ref.lowrank_matmul_experts_ref(
        _t(qa), _t(qw), _t(u), _t(v)))
    for s in range(blocks * e):
        assert torch.equal(got[s], ops.lowrank_matmul(
            _t(qa[s]), _t(qw[s % e]), _t(u), _t(v)))
    over_e = jax.vmap(ref_ops.lowrank_matmul, in_axes=(0, 0, None, None))
    over_b = jax.vmap(over_e, in_axes=(0, None, None, None))
    want = np.asarray(jax.jit(over_b)(
        jnp.asarray(qa.reshape(blocks, e, m, k)), jnp.asarray(qw),
        jnp.asarray(u), jnp.asarray(v))).reshape(blocks * e, m, n)
    assert _within(got, _bound(qa, qw, u, v))
    assert _within(want, _bound(qa, qw, u, v, pk=(-k) % 128))


def test_lowrank_expert_form_checks_its_operands():
    u = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="no multiple"):
        ops.lowrank_matmul(torch.zeros((5, 2, 3), dtype=torch.int32),
                           torch.zeros((2, 3, 4), dtype=torch.int32), u, u)
    with pytest.raises(ValueError, match="expected"):
        ops.lowrank_matmul(torch.zeros((2, 3), dtype=torch.int32),
                           torch.zeros((2, 3, 4), dtype=torch.int32), u, u)


# ----------------------------------------------------------------------
# K5-K8 against the reference's nested vmap
# ----------------------------------------------------------------------
#: a mixed-width bank: widths, one reduce tree for K6 (``pallas`` takes a
#: static tree), and per-lane trees for K8
BANK_WIDTHS = (12, 8, 16)
BANK_REDUCES = (("trunc", 3), ("exact", 0), ("loa", 4))


def _float_operands(lanes: int, e: int, m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 1.3, (lanes, e, m, k)).astype(np.float32)
    x[:, 1] = 0.0                               # a starved expert
    w = rng.normal(0.0, 0.4, (e, k, n)).astype(np.float32)
    return x, w


def _codes_at(x, bits):
    """The datapath's codes of x (..., X, M, K) at ``bits`` (an int or
    per-lane widths): each slice calibrated on its own."""
    xt = _t(x)
    return quantize(xt, calibrate_slices(xt, bits))


@pytest.mark.parametrize("bits", [12, 16])
def test_composed_entry_expert_forms_match_reference_vmap(bits):
    """K5 on codes and K7 on floats, one W-bit entry, against the
    reference's vmap over experts of ``composed_matmul_lut`` /
    ``fused_composed_matmul_lut`` (each expert calibrated on its own)."""
    jax, jnp, ref_quant, ref_reg, ref_ops = _ref_modules()
    e, m, k, n = 3, 5, 40, 9
    x, w = _float_operands(1, e, m, k, n, RNG_SEED + bits)
    x = x[0]
    lut = _tables(1, bits)[0]
    mask = int(port_reg.lane_mask_np(bits))
    red = ("loa", 4)
    qa, qw = _codes_at(x, bits), _codes_at(w, bits)
    got = ops.composed_matmul_lut(qa, qw, _t(lut), mask, red)
    want = jax.jit(jax.vmap(lambda a, b: ref_ops.composed_matmul_lut(
        a, b, jnp.asarray(lut), mask, red)))(jnp.asarray(qa.numpy()),
                                             jnp.asarray(qw.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    code = port_reg.encode_reduce(red)
    sp = pair_scalars(calibrate_slices(_t(x), bits),
                      calibrate_slices(_t(w), bits), 1, e)
    got = ops.fused_composed_matmul_lut(_t(x), _t(w), _t(lut), mask,
                                        torch.tensor(code), *sp)

    def one(xe, we):
        s = ref_quant.scalar_params(ref_quant.calibrate(xe, bits=bits),
                                    ref_quant.calibrate(we, bits=bits))
        return ref_ops.fused_composed_matmul_lut(
            xe, we, jnp.asarray(lut), jnp.uint32(mask),
            jnp.asarray(ref_reg.encode_reduce(red), jnp.int32), *s)
    want = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("banked", [False, True])
def test_composed_bank_expert_forms_match_reference_vmap(banked):
    """K6 (one tree, per-lane codes of both operands at each lane's width)
    and K8 (per-lane widths and trees) over a mixed-width bank, against
    the reference's vmap over lanes (table, mask, width, tree) of its
    vmap over experts, activations per lane or shared."""
    jax, jnp, ref_quant, ref_reg, ref_ops = _ref_modules()
    e, m, k, n, lanes = 3, 4, 36, 10, len(BANK_WIDTHS)
    x, w = _float_operands(lanes, e, m, k, n, RNG_SEED + 2)
    xs = x if banked else x[0]
    luts = _tables(lanes, RNG_SEED + 3)
    widths = np.asarray(BANK_WIDTHS, np.int32)
    masks = port_reg.lane_mask_np(list(BANK_WIDTHS)).astype(np.int64)
    bits = _t(widths)
    qa, qw = _codes_at(xs, bits), _codes_at(w, bits)
    assert qa.shape == (lanes, e, m, k) and qw.shape == (lanes, e, k, n)
    red = ("loa", 4)
    got = ops.composed_matmul_lut_bank(qa, qw, _t(luts), _t(masks), red,
                                       experts=True)
    over_e = jax.vmap(lambda a, b, lut, mk: ref_ops.composed_matmul_lut(
        a, b, lut, mk, red), in_axes=(0, 0, None, None))
    want = jax.jit(jax.vmap(over_e))(
        jnp.asarray(qa.numpy()), jnp.asarray(qw.numpy()), jnp.asarray(luts),
        jnp.asarray(masks, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    codes = np.asarray([port_reg.encode_reduce(r) for r in BANK_REDUCES],
                       np.int32)
    sp = pair_scalars(calibrate_slices(_t(xs), bits),
                      calibrate_slices(_t(w), bits), lanes, e)
    got = ops.fused_composed_matmul_lut_bank(_t(xs), _t(w), _t(luts),
                                             _t(masks), _t(codes), *sp)

    def lane(xl, lut, mk, code, b):
        def one(xe, we):
            s = ref_quant.scalar_params(ref_quant.calibrate(xe, bits=b),
                                        ref_quant.calibrate(we, bits=b))
            return ref_ops.fused_composed_matmul_lut(xe, we, lut, mk, code,
                                                     *s)
        return jax.vmap(one)(xl, jnp.asarray(w))
    want = jax.jit(jax.vmap(lane, in_axes=(0 if banked else None, 0, 0, 0,
                                            0)))(
        jnp.asarray(xs), jnp.asarray(luts), jnp.asarray(masks, jnp.uint32),
        jnp.asarray(codes), jnp.asarray(widths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# models.moe._expert_matmul under every mode
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def libs():
    """The exact and a truncated multiplier and three composed entries
    (12- and 16-bit loa4, 16-bit exact), in both packages."""
    from repro.core.families import truncated_multiplier as ref_trunc
    from repro.core.library import ApproxLibrary as RefLibrary
    from repro.core.seeds import array_multiplier as ref_array
    from repro_torch.core.families import truncated_multiplier
    from repro_torch.core.library import ApproxLibrary
    from repro_torch.core.seeds import array_multiplier
    out = []
    for lib_cls, arr, trunc in ((RefLibrary, ref_array, ref_trunc),
                                (ApproxLibrary, array_multiplier,
                                 truncated_multiplier)):
        lib = lib_cls()
        exact = arr(8)
        lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                        name="mul8u_exact")
        lib.add_netlist(trunc(8, 4), "multiplier", 8, "truncation", exact)
        names = [lib.add_composed(*r, samples=256).name for r in (
            ("mul8u_exact", 12, "loa4"), ("mul8u_trunc4", 16, "loa4"),
            ("mul8u_exact", 16, "exact"))]
        out.append((lib, names))
    assert out[0][1] == out[1][1]
    return out


@pytest.fixture(scope="module")
def buffers():
    """Dispatch buffers of 2 blocks x 3 experts (5 capacity rows, d 24;
    expert 1's all zeros: starved), stacked (3, 24, 16) weights, and 3
    lanes' buffers (lane i: the buffers scaled by 1 + i)."""
    rng = np.random.default_rng(RNG_SEED + 5)
    x = rng.normal(0.1, 1.0, (6, 5, 24)).astype(np.float32)
    x[1] = 0.0
    w = rng.normal(0.0, 0.3, (3, 24, 16)).astype(np.float32)
    return x, w, np.stack([x * (1.0 + i) for i in range(3)])


class _Counting(ApproxPolicy):
    """An ``ApproxPolicy`` counting its ``matmul`` calls."""

    def matmul(self, name, x, w, lanes=False, experts=False):
        self.calls += 1
        return super().matmul(name, x, w, lanes=lanes, experts=experts)


def _port_call(default, x, w):
    """The port's ``_expert_matmul`` in one policy call, and the calls of
    every datapath entry below it: the expert forms, the per-slice forms
    (none may run) and the float modes' and prepared weights' products."""
    from repro_torch.models import moe
    calls = {}
    pol = _Counting(default=default)
    pol.calls = 0
    targets = [(port_backend, "_forward"), (port_backend, "_prepared_matmul"),
               (port_backend, "_prepared_experts")]
    dp = getattr(default, "datapath", None)
    if dp is not None:
        targets += [(type(dp), a) for a in (
            "forward_q", "forward_q_experts", "forward_fused",
            "forward_fused_experts") if hasattr(type(dp), a)]
    mp = pytest.MonkeyPatch()
    for owner, attr in targets:
        orig = getattr(owner, attr)

        def counted(*a, _orig=orig, _attr=attr, **k):
            calls[_attr] = calls.get(_attr, 0) + 1
            return _orig(*a, **k)
        mp.setattr(owner, attr, counted)
    try:
        with torch.inference_mode():
            got = moe._expert_matmul(pol, "moe.wi", x, w)
    finally:
        mp.undo()
    assert pol.calls == 1
    return got, calls


_REF_FNS: dict = {}


def _ref_expert_matmul(spec: dict, ref_lib, x, w, prepared: bool = False):
    """The reference's ``_expert_matmul`` under ``spec`` (jitted once a
    spec), a vmap over experts a token block."""
    jax, jnp, _, _, _ = _ref_modules()
    from repro.approx.backend import prepare_tree
    from repro.approx.layers import ApproxPolicy as RefPolicy
    from repro.approx.specs import BackendSpec as RefSpec
    from repro.models import moe as ref_moe
    be = RefSpec(**spec).materialize(ref_lib)
    wj = jnp.asarray(w)
    if prepared:
        wj = jax.jit(lambda t: prepare_tree(t, be))({"wi": wj})["wi"]
    e = w.shape[0]
    key = (tuple(sorted(spec.items())), id(ref_lib))
    if key not in _REF_FNS:
        rpol = RefPolicy(default=be)
        _REF_FNS[key] = jax.jit(
            lambda b, w_: ref_moe._expert_matmul(rpol, "moe.wi", b, w_))
    fn = _REF_FNS[key]
    # the port's token blocks over the same experts: one vmap over experts
    # a block in the reference
    return np.concatenate([np.asarray(fn(jnp.asarray(x[i:i + e]), wj))
                           for i in range(0, x.shape[0], e)])


def _float_bound(x, w, bf16: bool) -> np.ndarray:
    """``F32_ULPS`` ulps of K·Σ_k |x||w| a slice, on the operands the mode
    multiplies (bf16-rounded under ``bf16``: exact products in f32)."""
    xt, wt = _t(x).double(), _t(w).double()
    if bf16:
        xt = _t(x).to(torch.bfloat16).double()
        wt = _t(w).to(torch.bfloat16).double()
    e = w.shape[0]
    s = torch.stack([xt[j].abs() @ wt[j % e].abs()
                     for j in range(x.shape[0])])
    return (F32_ULPS * x.shape[-1] * 2.0 ** -24 * s).numpy()


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_expert_matmul_exact_modes(libs, buffers, mode):
    """f32/bf16: one batched matmul within ``_float_bound``; int8: one
    batched exact product, bit for bit with the reference."""
    (ref_lib, _), (lib, _) = libs
    x, w, _ = buffers
    got, calls = _port_call(BackendSpec(mode=mode).materialize(lib), _t(x),
                            _t(w))
    want = _ref_expert_matmul({"mode": mode}, ref_lib, x, w)
    assert got.shape == (6, 5, 16)
    if mode == "int8":
        assert calls == {"forward_q_experts": 1}
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert calls == {"_forward": 1}
        assert (np.abs(got.numpy() - want)
                <= _float_bound(x, w, mode == "bf16")).all()


def _lowrank_tol(x, w, u, v) -> np.ndarray:
    """|port - reference| through the lowrank datapath a slice: twice the
    raw-sum bound scaled by sa·sw plus ``DEQUANT_ULPS`` ulps of the
    epilogue's terms (``test_torch_lowrank.py``'s ``_backend_tol``)."""
    e = w.shape[0]
    qp_a, qp_w = calibrate_slices(_t(x)), calibrate_slices(_t(w))
    qa, qw = quantize(_t(x), qp_a), quantize(_t(w), qp_w)
    out = []
    for s in range(x.shape[0]):
        y64, tol = ref.lowrank_bound(qa[s], qw[s % e], _t(u), _t(v))
        za, zw = qp_a.zero_point[s].double(), qp_w.zero_point[s % e].double()
        terms = (y64.abs() + tol + qa[s].double().sum(1, keepdim=True) * zw
                 + qw[s % e].double().sum(0, keepdim=True) * za
                 + x.shape[-1] * za * zw)
        scale = float(qp_a.scale[s]) * float(qp_w.scale[s % e])
        out.append((2 * tol + DEQUANT_ULPS * 2.0 ** -24 * terms) * scale)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("variant", ["ref", "pallas"])
def test_expert_matmul_lowrank(libs, buffers, variant):
    """``lowrank`` (plain or K9): one expert-form call, each slice within
    the bound of the reference's vmap over experts."""
    (ref_lib, _), (lib, _) = libs
    x, w, _ = buffers
    spec = dict(mode="lowrank", multiplier="mul8u_trunc4", rank=4,
                variant=variant)
    mb = BackendSpec(**spec).materialize(lib)
    got, calls = _port_call(mb, _t(x), _t(w))
    assert calls == {"forward_q_experts": 1}
    want = _ref_expert_matmul(spec, ref_lib, x, w)
    tol = _lowrank_tol(x, w, mb.consts["u"], mb.consts["v"])
    assert (np.abs(got.numpy() - want) <= tol).all()


def test_expert_matmul_prepared_lowrank(libs, buffers):
    """The repaired fault: ``_expert_matmul`` on ``prepare_tree``'s
    stacked dict runs one batched product (it raised ``AttributeError``
    on ``w.shape``) and each slice is within the prepared product's bound
    of the reference's vmap over experts on its prepared weights."""
    (ref_lib, _), (lib, _) = libs
    x, w, _ = buffers
    spec = dict(mode="lowrank", multiplier="mul8u_trunc4", rank=4)
    mb = BackendSpec(**spec).materialize(lib)
    pw = port_backend.prepare_tree({"wi": _t(w)}, mb)["wi"]
    assert port_backend.is_prepared(pw) and pw["tabs"].shape[0] == 3
    got, calls = _port_call(mb, _t(x), pw)
    assert calls == {"_prepared_experts": 1}
    assert got.shape == (6, 5, 16) and got.dtype == torch.float32
    want = _ref_expert_matmul(spec, ref_lib, x, w, prepared=True)
    # the prepared product's own bound (test_torch_lowrank.py's): sums of
    # bf16-rounded tables in two orders, then the epilogue
    u16 = _t(mb.consts["u"]).to(torch.bfloat16).double()
    qp_a = calibrate_slices(_t(x))
    qa = quantize(_t(x), qp_a)
    k = x.shape[-1]
    for s in range(6):
        tabs = pw["tabs"][s % 3].double()
        bound = torch.einsum("rmk,rkn->mn", u16[:, qa[s].long()].abs(),
                             tabs.abs()).numpy()
        scale = float(qp_a.scale[s]) * float(pw["w_scale"][s % 3])
        tol = (2 * 2 * (k * 4 + 1) * 2.0 ** -24 * bound + DEQUANT_ULPS
               * 2.0 ** -24 * (bound + 255 * 255 * k)) * scale
        assert (np.abs(got[s].numpy() - want[s]) <= tol).all(), s


@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("entry", [0, 1, 2])
def test_expert_matmul_composed_entry(libs, buffers, variant, entry):
    """A composed 12/16-bit entry: one expert-form call (K5 under
    ``pallas``, K7 under ``fused``; the plain datapath's gathers slice by
    slice inside it), bit for bit with the reference's vmap over
    experts."""
    (ref_lib, names), (lib, _) = libs
    x, w, _ = buffers
    spec = dict(mode="lut", multiplier=names[entry], variant=variant)
    got, calls = _port_call(BackendSpec(**spec).materialize(lib), _t(x),
                            _t(w))
    assert calls == ({"forward_fused_experts": 1} if variant == "fused"
                     else {"forward_q_experts": 1} if variant == "pallas"
                     else {"forward_q_experts": 1, "forward_q": 6})
    np.testing.assert_array_equal(
        got.numpy(), _ref_expert_matmul(spec, ref_lib, x, w))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the datapaths' composed kernel entry points."""
    calls = {}
    for name in ("composed_matmul_lut", "composed_matmul_lut_bank",
                 "fused_composed_matmul_lut",
                 "fused_composed_matmul_lut_bank"):
        orig = getattr(datapaths, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(datapaths, name, counted)
    return calls


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("variant,mixed_reduce", [
    ("pallas", False), ("fused", False), ("fused", True)])
def test_expert_matmul_mixed_width_bank(libs, buffers, kernel_calls,
                                        variant, mixed_reduce, lanes):
    """A bank of 8-, 12- and 16-bit lanes (one tree, or mixed trees under
    ``fused``): one K6 (K8) launch for every lane and expert, each lane
    bit for bit with the reference's ``_expert_matmul`` under its own
    multiplier, with the lanes' own buffers or shared ones."""
    (ref_lib, names), (lib, _) = libs
    x, w, xl = buffers
    bank_names = ["mul8u_trunc4", names[0],
                  names[2] if mixed_reduce else names[1]]
    default = bank_backend(bank_for(bank_names, lib,
                                    mixed_reduce=mixed_reduce),
                           variant=variant)
    got, calls = _port_call(default, _t(xl if lanes else x), _t(w))
    kernel = ("composed_matmul_lut_bank" if variant == "pallas"
              else "fused_composed_matmul_lut_bank")
    assert kernel_calls == {kernel: 1}
    assert calls == {"forward_fused_experts" if variant == "fused"
                     else "forward_q_experts": 1}
    assert got.shape == (3, 6, 5, 16)
    for i, name in enumerate(bank_names):
        want = _ref_expert_matmul(dict(mode="lut", multiplier=name,
                                       variant=variant), ref_lib,
                                  xl[i] if lanes else x, w)
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=name)


@pytest.mark.parametrize("spec", [
    dict(mode="lowrank", multiplier="mul8u_trunc4"),
    dict(mode="lowrank", multiplier="mul8u_trunc4", rank=3),
    dict(mode="lut", multiplier="mul8u_exact"), dict(mode="f32")], ids=str)
def test_materialized_rank_equals_reference(libs, spec):
    from repro.approx.specs import BackendSpec as RefSpec
    (ref_lib, _), (lib, _) = libs
    got = BackendSpec(**spec).materialize(lib).rank
    assert got == RefSpec(**spec).materialize(ref_lib).rank
    assert isinstance(got, int)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run on "
                    "the card only (chip_smoke.py runs this comparison)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("e,blocks,m,k,n", [
    (8, 1, 4, 5120, 1536), (8, 1, 64, 1536, 512), (5, 2, 7, 577, 65),
    (4, 1, 129, 130, 1)])
def test_cuda_lowrank_expert_form_matches_launch_loop(cuda, e, blocks, m, k,
                                                      n):
    """K9's expert form and E launches without the axis, both within
    every slice's bound; two calls of the expert form bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qa = torch.randint(0, 256, (blocks * e, m, k), generator=gen,
                       dtype=torch.int32, device=cuda)
    qw = torch.randint(0, 256, (e, k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    u = torch.randn((4, 256), generator=gen, device=cuda) * 16
    v = torch.randn((4, 256), generator=gen, device=cuda) * 16
    got = ops.lowrank_matmul(qa, qw, u, v)
    loop = torch.stack([ops.lowrank_matmul(qa[s], qw[s % e], u, v)
                        for s in range(blocks * e)])
    y64, tol = ref.lowrank_bound_experts(qa, qw, u, v)
    for y in (got, loop):
        assert bool(((y.double() - y64).abs() <= tol).all())
    assert torch.equal(ops.lowrank_matmul(qa, qw, u, v), got)


@pytest.mark.gpu
@pytest.mark.parametrize("e,m,k,n", [(8, 4, 2048, 768), (3, 7, 577, 65)])
def test_cuda_composed_expert_forms_match_launch_loop(cuda, e, m, k, n):
    """K5-K8's expert form == one launch a slice without the axis, bit
    for bit: a 12-bit entry (K5, K7) and a mixed-width bank (K6 with
    per-lane codes, K8 with per-lane widths and trees)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    luts = torch.randint(0, 1 << 16, (3, 256, 256), generator=gen,
                         dtype=torch.int32, device=cuda).to(torch.uint16)
    widths = torch.tensor(BANK_WIDTHS, device=cuda)
    masks = torch.from_numpy(port_reg.lane_mask_np(
        list(BANK_WIDTHS)).astype(np.int64)).to(cuda)
    codes = torch.tensor([port_reg.encode_reduce(r) for r in BANK_REDUCES],
                         dtype=torch.int32, device=cuda)
    x = torch.randn((e, m, k), generator=gen, device=cuda)
    w = torch.randn((e, k, n), generator=gen, device=cuda) * 0.2
    red = ("loa", 4)

    def same(got, per, dim):
        for g, p in zip(got, zip(*per)):
            assert torch.equal(g, torch.stack(p, dim=dim))

    qa, qw = (quantize(t, calibrate_slices(t, 12)) for t in (x, w))
    same(ops.composed_matmul_lut(qa, qw, luts[0], masks[0], red, raw=True),
         [ops.composed_matmul_lut(qa[s], qw[s], luts[0], masks[0], red,
                                  raw=True) for s in range(e)], 0)
    qa, qw = (quantize(t, calibrate_slices(t, widths)) for t in (x, w))
    same(ops.composed_matmul_lut_bank(qa, qw, luts, masks, red, raw=True,
                                      experts=True),
         [ops.composed_matmul_lut_bank(qa[:, s].contiguous(),
                                       qw[:, s].contiguous(), luts, masks,
                                       red, raw=True) for s in range(e)], 1)
    for lanes, bits, tabs, dim in ((1, 12, luts[0], 0),
                                   (3, widths, luts, 1)):
        sp = pair_scalars(calibrate_slices(x, bits), calibrate_slices(w, bits),
                          lanes, e)
        at = [torch.arange(lanes, device=cuda) * e + s for s in range(e)]
        op = (ops.fused_composed_matmul_lut if lanes == 1
              else ops.fused_composed_matmul_lut_bank)
        mk, cd = (masks[:1], codes[:1]) if lanes == 1 else (masks, codes)
        same(op(x, w, tabs, mk, cd, *sp, raw=True),
             [op(x[s], w[s], tabs, mk, cd, *[
                 v[at[s]] if isinstance(v, torch.Tensor) else v for v in sp],
                 raw=True) for s in range(e)], dim)
