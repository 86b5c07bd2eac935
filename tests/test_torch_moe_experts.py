"""The expert axis of K1-K4: an MoE projection's experts, for every bank
lane, in one datapath call and one kernel launch, as the reference's
``jax.vmap`` over experts hands ``pallas_call`` its batched weights.

On the CPU (one torch thread, seeded numpy inputs, reduced widths):
  * the expert forms' plain versions (``kernels.ref.*_experts_ref``,
    reached through ``kernels.ops`` with stacked weights ``(E, K, N)``)
    equal the reference's ``jax.vmap`` over experts of
    ``repro.kernels.ops.approx_matmul_lut`` / ``fused_matmul_lut``
    (jitted, Pallas in interpret mode) bit for bit: one table, and an
    outer ``vmap`` over a LUT bank of lanes with banked and shared
    activations; a starved expert's all-zero buffer, ragged M/K/N and
    two token blocks' buffers over the same experts among the cases;
  * ``models.moe._expert_matmul`` under ``lut`` with ``variant="pallas"``
    and ``"fused"``, banked or not, with a lane axis or not, equals the
    reference's ``_expert_matmul`` (per lane, the lane's multiplier) bit
    for bit, in exactly one ``policy.matmul`` call and one datapath call
    a projection; ``moe_ffn`` (sequential, lanes, ``moe_blocks`` 2)
    within ``FFN_ATOL`` of the reference's (the combine sums its k slots
    in another order), three routed calls a layer;
  * the call-site formulas ``arch_profiles.banked_calls_per_forward`` and
    ``serve_load.banked_calls_per_step`` equal the banked calls the
    continuous engine's counting policy (``serve.engine._CountedPolicy``)
    sees a prefill and a decode step on reduced qwen3-moe and deepseek.

On the card (``gpu``-marked, no JAX needed: ``python -m pytest -m gpu
tests/test_torch_moe_experts.py``): the expert form of K1-K4 against E
launches of the kernels without the axis, bit for bit.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.approx.layers import ApproxPolicy, bank_backend
from repro_torch.approx.quant import calibrate_slices, pair_scalars
from repro_torch.approx.specs import BackendSpec, bank_for
from repro_torch.kernels import datapaths, ops, ref

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MULTS = ("mul8u_exact", "mul8u_trunc5", "mul8u_trunc3")
#: moe_ffn's outputs: the expert outputs are equal bit for bit; XLA and
#: torch sum the k weighted slots and the router's matmul in other orders
FFN_ATOL = 1e-5
#: (E experts, token blocks, M, K, N): qwen3-moe-like, ragged, and two
#: blocks' buffers over the same experts
SHAPES = ((4, 1, 4, 64, 24), (3, 1, 5, 37, 9), (2, 2, 3, 33, 7))
RNG_SEED = 30


def _ref_modules():
    """The reference's modules (JAX on the CPU; imported here, so the
    card's tests run without JAX)."""
    import jax
    import jax.numpy as jnp
    from repro.approx import quant as ref_quant
    from repro.kernels import ops as ref_ops
    return jax, jnp, ref_quant, ref_ops


def _tables(n: int, seed: int) -> np.ndarray:
    """n random 16-bit product tables, LUT[0,0] != 0 (a zero-padded row
    must still gather it)."""
    t = np.random.default_rng(seed).integers(0, 1 << 16, (n, 256, 256))
    t[:, 0, 0] = 4321
    return t.astype(np.int32)


def _operands(e, blocks, m, k, n, lanes, seed):
    """Codes and floats of ``lanes`` x ``blocks * e`` slices (slice 1 of
    every lane an all-zero buffer: a starved expert) and stacked
    weights."""
    rng = np.random.default_rng(seed)
    x_ = blocks * e
    qa = rng.integers(0, 256, (lanes, x_, m, k)).astype(np.int32)
    qw = rng.integers(0, 256, (e, k, n)).astype(np.int32)
    x = rng.normal(size=(lanes, x_, m, k)).astype(np.float32)
    x[:, 1] = 0.0
    w = (0.2 * rng.normal(size=(e, k, n))).astype(np.float32)
    return qa, qw, x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_lut(qa, qw, lut, blocks):
    """The reference: jit(vmap over blocks of vmap over experts) of
    ``approx_matmul_lut`` on one table; qa (X, M, K)."""
    jax, jnp, _, ref_ops = _ref_modules()
    e = qw.shape[0]
    over_e = jax.vmap(ref_ops.approx_matmul_lut, in_axes=(0, 0, None))
    over_b = jax.vmap(over_e, in_axes=(0, None, None))
    got = jax.jit(over_b)(jnp.asarray(qa.reshape(blocks, e, *qa.shape[1:])),
                          jnp.asarray(qw), jnp.asarray(lut))
    return np.asarray(got).reshape(qa.shape[0], *got.shape[2:])


def _ref_fused(x, w, lut, blocks):
    """The reference's fused expert slices, each calibrated on its own
    (``quant.scalar_params`` of ``calibrate`` under the ``vmap``s)."""
    jax, jnp, ref_quant, ref_ops = _ref_modules()
    e = w.shape[0]

    def one(xe, we):
        sp = ref_quant.scalar_params(ref_quant.calibrate(xe),
                                     ref_quant.calibrate(we))
        return ref_ops.fused_matmul_lut(xe, we, jnp.asarray(lut), *sp)

    over_b = jax.vmap(jax.vmap(one), in_axes=(0, None))
    got = jax.jit(over_b)(jnp.asarray(x.reshape(blocks, e, *x.shape[1:])),
                          jnp.asarray(w))
    return np.asarray(got).reshape(x.shape[0], *got.shape[2:])


def _pair_scalars(x, w, lanes):
    """The port's scalars of every (lane, slice) pair, lane-major, from
    ``calibrate_slices`` (the weights' per expert)."""
    return pair_scalars(calibrate_slices(x), calibrate_slices(w), lanes,
                        x.shape[-3])


@pytest.mark.parametrize("e,blocks,m,k,n", SHAPES)
def test_lut_expert_form_matches_reference_vmap(e, blocks, m, k, n):
    """K1/K2's expert form (plain) == the reference's vmap over experts
    of ``approx_matmul_lut``: one table, and a 3-table bank with banked
    and shared codes (the reference's outer vmap over lanes)."""
    qa, qw, _, _ = _operands(e, blocks, m, k, n, 3, RNG_SEED)
    luts = _tables(3, RNG_SEED + 1)
    got = ops.approx_matmul_lut(_t(qa[0]), _t(qw), _t(luts[0]))
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_lut(qa[0], qw, luts[0], blocks))
    assert torch.equal(got, ref.approx_matmul_lut_experts_ref(
        _t(qa[0]), _t(qw), _t(luts[0])))
    banked = ops.approx_matmul_lut_bank(_t(qa), _t(qw), _t(luts))
    shared = ops.approx_matmul_lut_bank(_t(qa[0]), _t(qw), _t(luts))
    assert banked.shape == (3, blocks * e, m, n)
    for lane in range(3):
        np.testing.assert_array_equal(
            banked[lane].numpy(), _ref_lut(qa[lane], qw, luts[lane], blocks))
        np.testing.assert_array_equal(
            shared[lane].numpy(), _ref_lut(qa[0], qw, luts[lane], blocks))


@pytest.mark.parametrize("e,blocks,m,k,n", SHAPES)
def test_fused_expert_form_matches_reference_vmap(e, blocks, m, k, n):
    """K3/K4's expert form (plain, f32 after the epilogue) == the
    reference's vmap over experts of ``fused_matmul_lut``, each slice
    calibrated on its own — the starved expert's zero buffer included."""
    _, _, x, w = _operands(e, blocks, m, k, n, 2, RNG_SEED + 2)
    luts = _tables(2, RNG_SEED + 3)
    one = ops.fused_matmul_lut(_t(x[0]), _t(w), _t(luts[0]),
                               *_pair_scalars(_t(x[0]), _t(w), 1))
    np.testing.assert_array_equal(one.numpy(),
                                  _ref_fused(x[0], w, luts[0], blocks))
    banked = ops.fused_matmul_lut_bank(_t(x), _t(w), _t(luts),
                                       *_pair_scalars(_t(x), _t(w), 2))
    shared = ops.fused_matmul_lut_bank(_t(x[1]), _t(w), _t(luts),
                                       *_pair_scalars(_t(x[1]), _t(w), 2))
    for lane in range(2):
        np.testing.assert_array_equal(
            banked[lane].numpy(), _ref_fused(x[lane], w, luts[lane], blocks))
        np.testing.assert_array_equal(
            shared[lane].numpy(), _ref_fused(x[1], w, luts[lane], blocks))


def test_expert_form_checks_its_operands():
    qa = torch.zeros((5, 2, 3), dtype=torch.int32)
    qw = torch.zeros((2, 3, 4), dtype=torch.int32)
    lut = torch.zeros((256, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="no multiple"):
        ops.approx_matmul_lut(qa, qw, lut)
    with pytest.raises(ValueError, match="lanes"):
        ops.approx_matmul_lut_bank(torch.zeros((3, 4, 2, 3),
                                               dtype=torch.int32),
                                   qw, torch.zeros((2, 256, 256),
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="dims"):
        ops.fused_matmul_lut(torch.zeros((2, 3)), torch.zeros((2, 3, 4)),
                             lut, 1.0, 0, 1.0, 0, 255.0)


# ----------------------------------------------------------------------
# models.moe._expert_matmul and moe_ffn
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def libs():
    """The exact and two truncated multipliers, in both packages."""
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
        for bits in (5, 3):
            lib.add_netlist(trunc(8, bits), "multiplier", 8, "truncation",
                            exact)
        out.append(lib)
    return out


@pytest.fixture(scope="module")
def moe_case():
    """(ref cfg, port cfg, ref params, port params, x) of the first MoE
    layer of reduced qwen3-moe (8 experts, top 2), one expert starved
    (its router column pushed down)."""
    jax, _, _, _ = _ref_modules()
    from repro.configs import get_config as ref_get_config
    from repro.models.registry import model_fns as ref_model_fns
    from repro_torch.configs import get_config
    from repro_torch.models.weights import lm_params_from_numpy
    ref_cfg = ref_get_config("qwen3-moe-30b-a3b").reduced()
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = jax.tree.map(np.asarray, ref_model_fns(ref_cfg).init_params(
        jax.random.PRNGKey(0), ref_cfg))
    p = jax.tree.map(lambda a: a[0], params["blocks"]["ffn_0"])
    p["router"] = p["router"].copy()
    p["router"][:, 3] = 0.0
    p["router"][0, 3] = -10.0
    x = np.random.default_rng(RNG_SEED).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32)
    x[..., 0] = 5.0
    return ref_cfg, cfg, p, lm_params_from_numpy(p), x


class _Counting(ApproxPolicy):
    """An ``ApproxPolicy`` counting its ``matmul`` calls by name."""

    def matmul(self, name, x, w, lanes=False, experts=False):
        self.calls[name] = self.calls.get(name, 0) + 1
        return super().matmul(name, x, w, lanes=lanes, experts=experts)


def _counting(default):
    pol = _Counting(default=default)
    pol.calls = {}
    return pol


@pytest.fixture
def datapath_calls(monkeypatch):
    """Calls of the datapaths' four kernel entry points."""
    calls = {}
    for name in ("approx_matmul_lut", "approx_matmul_lut_bank",
                 "fused_matmul_lut", "fused_matmul_lut_bank"):
        orig = getattr(datapaths, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(datapaths, name, counted)
    return calls


def _buffers(pp, x, cfg, lanes: int):
    """Dispatch buffers (E, C, d) of each of ``lanes`` token sets (lane
    i's tokens: x scaled by 1 + i)."""
    from repro_torch.models import moe
    out = []
    for i in range(lanes):
        xf = torch.from_numpy(x * (1.0 + i)).reshape(-1, cfg.d_model)
        out.append(moe.dispatch(xf, moe.route(pp, xf, cfg), cfg))
    return torch.stack(out)


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_expert_matmul_matches_reference(moe_case, libs, datapath_calls,
                                         variant, banked, lanes):
    """One ``policy.matmul`` and one datapath call for all 8 experts
    (and every lane), equal bit for bit to the reference's
    ``_expert_matmul`` (jitted) under each lane's multiplier."""
    jax, jnp, _, _ = _ref_modules()
    from repro.approx.layers import ApproxPolicy as RefPolicy
    from repro.approx.specs import BackendSpec as RefSpec
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    _, cfg, rp, pp, x = moe_case
    ref_lib, lib = libs
    n = len(MULTS)
    bufs = _buffers(pp, x, cfg, n if lanes else 1)
    assert not bufs[:, 3].any()                   # the starved expert
    buf = bufs if lanes else bufs[0]
    if banked:
        default = bank_backend(bank_for(list(MULTS), lib), variant=variant)
    else:
        default = BackendSpec(mode="lut", multiplier=MULTS[1],
                              variant=variant).materialize(lib)
    pol = _counting(default)
    with torch.inference_mode():
        got = moe._expert_matmul(pol, "moe.wi", buf, pp["wi"])
    assert pol.calls == {"moe.wi": 1}
    kernel = ("approx_matmul_lut" if variant == "pallas"
              else "fused_matmul_lut")
    assert datapath_calls == {
        kernel + ("_bank" if banked or lanes else ""): 1}
    out_lanes = n if banked or lanes else 1
    assert got.shape == (*((out_lanes,) if banked or lanes else ()),
                         cfg.n_experts, *buf.shape[-2:-1],
                         pp["wi"].shape[-1])
    got = got.reshape(out_lanes, *got.shape[-3:])
    for i in range(out_lanes):
        mult = MULTS[i] if banked else MULTS[1]
        rpol = RefPolicy(default=RefSpec(mode="lut", multiplier=mult,
                                         variant=variant
                                         ).materialize(ref_lib))
        want = jax.jit(lambda b, w: ref_moe._expert_matmul(
            rpol, "moe.wi", b, w))(
            jnp.asarray(bufs[i if lanes else 0].numpy()), rp["wi"])
        assert torch.equal(got[i], torch.from_numpy(np.array(want))), i


@pytest.mark.parametrize("variant", ["pallas", "fused"])
@pytest.mark.parametrize("form", ["sequential", "lanes", "blocks"])
def test_moe_ffn_one_call_a_projection(moe_case, libs, variant, form):
    """``moe_ffn`` makes one datapath call a routed projection (wi, wg,
    wo), whatever the lanes or token blocks, and equals the reference's
    ``moe_ffn`` within ``FFN_ATOL``: sequentially, with a lane axis (each
    lane routing its tokens alone, the reference's vmap over lanes) and
    with block-local dispatch (``moe_blocks`` 2)."""
    import dataclasses
    jax, jnp, _, _ = _ref_modules()
    from repro.approx.layers import ApproxPolicy as RefPolicy
    from repro.approx.specs import BackendSpec as RefSpec
    from repro.models import moe as ref_moe
    from repro_torch.models import moe
    ref_cfg, cfg, rp, pp, x = moe_case
    ref_lib, lib = libs
    if form == "blocks":
        ref_cfg = dataclasses.replace(ref_cfg, moe_blocks=2)
        cfg = dataclasses.replace(cfg, moe_blocks=2)
    spec = dict(mode="lut", multiplier=MULTS[2], variant=variant)
    pol = _counting(BackendSpec(**spec).materialize(lib))
    rpol = RefPolicy(default=RefSpec(**spec).materialize(ref_lib))
    xs = np.stack([x[:1], 1.5 * x[:1]]) if form == "lanes" else x
    with torch.inference_mode():
        got, aux = moe.moe_ffn(pp, torch.from_numpy(
            xs[:, 0] if form == "lanes" else xs), cfg, pol,
            lanes=form == "lanes")
    assert pol.calls == {"moe.wi": 1, "moe.wg": 1, "moe.wo": 1}
    fn = jax.jit(lambda p, x_: ref_moe.moe_ffn(p, x_, ref_cfg, rpol))
    if form == "lanes":                 # each lane a batch of one row
        want = [fn(rp, jnp.asarray(xs[i])) for i in range(2)]
        want_y = np.concatenate([np.asarray(w[0]) for w in want])
        want_aux = np.asarray([float(w[1]) for w in want])
    else:
        want_y, want_aux = (np.asarray(v) for v in fn(rp, jnp.asarray(xs)))
    np.testing.assert_allclose(got.numpy(), want_y, rtol=0, atol=FFN_ATOL)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=1e-6)


# ----------------------------------------------------------------------
# The call-site formulas
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_formulas_equal_counted_policy(arch):
    """``banked_calls_per_forward`` (a prefill) and
    ``banked_calls_per_step`` (a decode step) equal what the continuous
    engine's ``_CountedPolicy`` counts at every step: one banked call a
    projection, a routed-expert projection one for all its experts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_load
    from repro_torch.launch.arch_profiles import banked_calls_per_forward
    cfg = get_config(arch).reduced()
    record = serve_load.run("cpu", arch=arch, reduced=True, levels=[2],
                            n_requests=2, log=lambda s: None)
    per = serve_load.banked_calls_per_step(cfg)
    assert per["prefill"] == banked_calls_per_forward(cfg)
    moe_layers = cfg.n_layers           # reduced: every layer routes
    assert per["decode"] == {"qwen3-moe-30b-a3b": 4 + 3,
                             "deepseek-v2-236b": 8 + 3 + 3}[arch] \
        * moe_layers
    for kind in ("prefill", "decode"):
        assert set(record["steps"][kind]["banked"]) == {per[kind]}
        assert record["steps"][kind]["single"] == [0]
    assert record["bit_identity"]


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
@pytest.mark.parametrize("p,e,blocks,m,k,n", [
    (3, 8, 1, 4, 2048, 768), (2, 6, 2, 5, 577, 65), (1, 4, 1, 513, 31, 8)])
def test_cuda_expert_form_matches_launch_loop(cuda, p, e, blocks, m, k, n):
    """K1-K4's expert form == one launch a slice of the kernels without
    the axis, bit for bit (codes, and the fused kernels' raw outputs)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    luts = torch.randint(0, 1 << 16, (p, 256, 256), generator=gen,
                         dtype=torch.int32, device=cuda).to(torch.uint16)
    x_ = blocks * e
    qa = torch.randint(0, 256, (p, x_, m, k), generator=gen,
                       dtype=torch.int32, device=cuda)
    qw = torch.randint(0, 256, (e, k, n), generator=gen, dtype=torch.int32,
                       device=cuda)
    got = ops.approx_matmul_lut_bank(qa, qw, luts)
    one = ops.approx_matmul_lut(qa[0], qw, luts[0])
    for s in range(x_):
        want = ops.approx_matmul_lut_bank(qa[:, s].contiguous(),
                                          qw[s % e], luts)
        assert torch.equal(got[:, s], want)
        assert torch.equal(one[s], want[0])
    x = torch.randn((p, x_, m, k), generator=gen, device=cuda)
    w = torch.randn((e, k, n), generator=gen, device=cuda) * 0.2
    sa, za, sw, zw, qmax = _pair_scalars(x, w, p)
    got = ops.fused_matmul_lut_bank(x, w, luts, sa, za, sw, zw, qmax,
                                    raw=True)
    one = ops.fused_matmul_lut(x[0], w, luts[0], sa[:x_], za[:x_], sw[:x_],
                               zw[:x_], qmax, raw=True)
    for s in range(x_):
        at = torch.arange(p, device=cuda) * x_ + s
        want = ops.fused_matmul_lut_bank(
            x[:, s].contiguous(), w[s % e], luts, sa[at], za[at], sw[at],
            zw[at], qmax, raw=True)
        for g, o, wt in zip(got, one, want):
            assert torch.equal(g[:, s], wt)
            assert torch.equal(o[s], wt[0])
