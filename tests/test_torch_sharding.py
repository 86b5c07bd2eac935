"""Lane sharding of the port (``launch.mesh`` shardings through
``bank_eval``, ``policy_bank_eval``, the sweeps and DSEs, the module
profiles, the population CGP engine and the continuous engine) on CPU
meshes that list the CPU two or three times, and ``compressed_psum``
over gloo process groups.

What is held:
  * every sharded result equals the port's unsharded one bit for bit:
    sweep lanes (divisible and non-divisible banks, 8-bit and
    mixed-width, under the plain datapath and ``pallas``/``fused``),
    assignment lanes, explore/explore_heterogeneous/profile decisions and
    metrics, population scores and search trajectories (padding
    included), continuous-engine tokens;
  * each shard makes one banked datapath call a layer with its own lanes
    (counted at ``kernels.datapaths``; on the card each is one K2/K4/K6/
    K8 launch), and one K11 call a shard;
  * against the reference's sharded run on its one-device mesh: the toy
    net's lanes bit for bit under the plain datapath (``bank_eval``,
    ``policy_bank_eval``; the port's ``pallas``/``fused`` lanes equal its
    plain ones here and the reference's in
    ``tests/test_torch_heterogeneous.py``), population scores and
    search trajectories equal;
  * ``compressed_psum`` at world size 1 equals the reference's
    ``shard_map`` on a one-device mesh bit for bit, and at world size 2
    (two processes) equals the numpy formula.
"""
import multiprocessing
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.approx.layers import bank_eval as ref_bank_eval
from repro.approx.layers import policy_bank_eval as ref_policy_bank_eval
from repro.approx.specs import PolicyBank as RefPolicyBank
from repro.approx.specs import bank_for as ref_bank_for
from repro.core import evolve_pop as ref_pop
from repro.core.cgp import CgpParams as RefParams
from repro.core.families import truncated_multiplier as ref_trunc
from repro.core.library import ApproxLibrary as RefLibrary
from repro.core.seeds import array_multiplier as ref_array
from repro.launch import mesh as ref_mesh
from repro.train.compression import compressed_psum as ref_psum
from repro_torch.approx import dse
from repro_torch.approx.layers import (ApproxPolicy, bank_eval,
                                       policy_bank_eval)
from repro_torch.approx.modules import ModuleMap
from repro_torch.approx.profiles import profile_architecture
from repro_torch.approx.specs import BackendSpec, PolicyBank, bank_for
from repro_torch.approx.workload import lm_fidelity, logit_fidelity
from repro_torch.configs import get_config
from repro_torch.core import evolve_pop
from repro_torch.core.cgp import CgpParams, pad_nodes
from repro_torch.core.families import truncated_multiplier
from repro_torch.core.library import ApproxLibrary
from repro_torch.core.seeds import array_multiplier
from repro_torch.kernels import datapaths, ops
from repro_torch.launch import mesh
from repro_torch.models.common import LMConfig
from repro_torch.models.registry import model_fns
from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
from repro_torch.train.compression import compressed_psum, quantize_leaf
from tests.test_torch_bitsim import random_netlist
from _torch_dist_worker import psum_worker
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYERS = ("lin_a", "lin_b")
COUNTS = {"lin_a": 100, "lin_b": 300}
#: composed lanes of the mixed-width bank (one tree, so ``pallas`` takes
#: it too)
WIDE = (("mul8u_exact", 12, "loa4"), ("mul8u_trunc4", 16, "loa4"))
#: the banked datapath calls each variant makes, by bank kind
BANKED = {"pallas": ("approx_matmul_lut_bank", "composed_matmul_lut_bank"),
          "fused": ("fused_matmul_lut_bank",
                    "fused_composed_matmul_lut_bank")}


def two():
    return mesh.sweep_mesh(devices=["cpu", "cpu"])


def ref_one():
    return ref_mesh.sweep_mesh()


def _lib(lib_cls, arr, trunc, ks=range(1, 7)):
    """The exact 8-bit multiplier and the truncations ``ks``."""
    lib = lib_cls()
    exact = arr(8)
    lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                    name="mul8u_exact")
    for k in ks:
        lib.add_netlist(trunc(8, k), "multiplier", 8, "truncation", exact)
    return lib


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries of the exact multiplier, truncations 1-6
    and the two composed ``WIDE`` lanes."""
    ref_lib = _lib(RefLibrary, ref_array, ref_trunc)
    port_lib = _lib(ApproxLibrary, array_multiplier, truncated_multiplier)
    wide = [(ref_lib.add_composed(*r).name, port_lib.add_composed(*r).name)
            for r in WIDE]
    assert all(a == b for a, b in wide)
    names = ["mul8u_exact"] + [f"mul8u_trunc{8 - k}" for k in range(1, 7)]
    return ref_lib, port_lib, names, [a for a, _ in wide]


@pytest.fixture(scope="module")
def toy():
    """The reference heterogeneous test's two-matmul toy net in both
    packages on the same seeded inputs, returning the outputs ``y``."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w_a = rng.normal(size=(16, 16)).astype(np.float32)
    w_b = rng.normal(size=(16, 4)).astype(np.float32)
    jx, ja, jb = (jnp.asarray(a) for a in (x, w_a, w_b))
    tx, ta, tb = (torch.from_numpy(a) for a in (x, w_a, w_b))

    def ref_forward(policy, xb=jx):
        y = policy.matmul("lin_a", xb, ja)
        return policy.matmul("lin_b", jax.nn.relu(y), jb)

    def port_forward(policy, xb=tx):
        y = policy.matmul("lin_a", xb, ta)
        return policy.matmul("lin_b", torch.relu(y), tb, lanes=y.ndim == 3)

    return ref_forward, port_forward, jx, tx


def _counting(monkeypatch, names):
    """Wrap ``kernels.datapaths``' banked calls: the lane count of each
    call, by name."""
    seen = {n: [] for n in names}
    for name in names:
        orig = getattr(datapaths, name)

        def counted(qa, qw, luts, *a, _orig=orig, _name=name, **kw):
            seen[_name].append(int(luts.shape[0]))
            return _orig(qa, qw, luts, *a, **kw)

        monkeypatch.setattr(datapaths, name, counted)
    return seen


# ----------------------------------------------------------------------
# bank_eval / policy_bank_eval
# ----------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("kind", ["div", "nondiv", "wide"])
def test_bank_eval_sharded(kind, variant, libs, toy, monkeypatch):
    ref_lib, port_lib, names, wide = libs
    ref_forward, port_forward, _, _ = toy
    mults = {"div": names[:4], "nondiv": names[:5],
             "wide": names[:2] + wide}[kind]
    bank, ref_bank = bank_for(mults, port_lib), ref_bank_for(mults, ref_lib)
    want = bank_eval(lambda p: {"y": port_forward(p)}, bank,
                     variant=variant)["y"]
    seen = _counting(monkeypatch, BANKED.get(variant, ()))
    sh = mesh.bank_sharding(bank.n_mult, two())
    got = bank_eval(lambda p: {"y": port_forward(p)}, bank,
                    variant=variant, sharding=sh)["y"]
    assert torch.equal(got, want)
    if variant == "ref":
        # the port's variants equal the reference's lane for lane
        # (tests/test_torch_heterogeneous.py); the plain one here
        ref = ref_bank_eval(ref_forward, ref_bank, variant=variant,
                            sharding=ref_mesh.bank_sharding(
                                ref_bank.n_mult, ref_one()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        # one banked call a layer a shard, with the shard's lanes
        used = BANKED[variant][kind == "wide"]
        shards = 1 if kind == "nondiv" else 2
        assert seen[used] == [len(mults) // shards] * (shards * len(LAYERS))
        assert not any(v for k, v in seen.items() if k != used)


@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
@pytest.mark.parametrize("n_policies", [6, 7])
def test_policy_bank_eval_assign_sharding(n_policies, variant, libs, toy,
                                          monkeypatch):
    ref_lib, port_lib, names, wide = libs
    ref_forward, port_forward, _, _ = toy
    pool = names[:3] + wide
    rng = np.random.default_rng(n_policies)
    rows = [{l: pool[rng.integers(0, len(pool))] for l in LAYERS}
            for _ in range(n_policies)]
    pb = PolicyBank.from_assignments(rows, port_lib, layers=LAYERS)
    ref_pb = RefPolicyBank.from_assignments(rows, ref_lib, layers=LAYERS)
    want = policy_bank_eval(lambda p: {"y": port_forward(p)}, pb,
                            variant=variant)["y"]
    seen = _counting(monkeypatch, BANKED.get(variant, ()))
    got = policy_bank_eval(
        lambda p: {"y": port_forward(p)}, pb, variant=variant,
        assign_sharding=mesh.policy_sharding(n_policies, two()))["y"]
    assert torch.equal(got, want)
    if variant == "ref":
        ref = ref_policy_bank_eval(
            ref_forward, ref_pb, variant=variant,
            assign_sharding=ref_mesh.policy_sharding(n_policies,
                                                     ref_one()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        per = n_policies // 2 if n_policies % 2 == 0 else n_policies
        calls = seen[BANKED[variant][1]]
        assert calls == [per] * (len(calls))
        assert len(calls) == len(LAYERS) * n_policies // per


def test_shard_output_on_another_device_raises(libs):
    """A shard whose ``fn`` computes on tensors of another device than
    its own (CPU tensors on a mesh of ``meta`` entries) raises instead
    of returning them."""
    _, port_lib, names, _ = libs
    bank = bank_for(names[:4], port_lib)
    held = torch.zeros(4)
    on_meta = mesh.Mesh(("sweep",), (2,), (torch.device("meta"),) * 2)
    with pytest.raises(RuntimeError, match="another device"):
        bank_eval(lambda p: {"y": held + 1}, bank,
                  sharding=mesh.bank_sharding(4, on_meta))


# ----------------------------------------------------------------------
# Sweeps and DSEs
# ----------------------------------------------------------------------
def _toy_workload(toy):
    _, port_forward, _, tx = toy
    return logit_fidelity(port_forward, [tx], layer_counts=COUNTS)


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_explore_sharded(variant, libs, toy):
    _, port_lib, names, _ = libs
    wl = _toy_workload(toy)
    mults = names[:6]
    kw = dict(multipliers=mults, mode="lut", variant=variant,
              quality_bound=0.5, batch=True)
    want = dse.explore(workload=wl, library=port_lib, **kw)
    got = dse.explore(workload=wl, library=port_lib,
                      sharding=mesh.bank_sharding(len(mults), two()), **kw)
    assert got.to_json_dict() == want.to_json_dict()
    assert got.selected is not None and len(got.per_layer) == 12


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_explore_heterogeneous_sharded(variant, libs, toy):
    _, port_lib, names, _ = libs
    wl = _toy_workload(toy)
    mults = names[:6]
    kw = dict(multipliers=mults, mode="lut", variant=variant,
              quality_bound=0.5, top_k=6, beam_width=4)
    want = dse.explore_heterogeneous(wl, COUNTS, port_lib, **kw)
    assert len(want.heterogeneous) % 2 == 0
    got = dse.explore_heterogeneous(
        wl, COUNTS, port_lib,
        sharding=mesh.bank_sharding(len(mults), two()),
        assign_sharding=mesh.policy_sharding(len(want.heterogeneous),
                                             two()), **kw)
    assert got.to_json_dict() == want.to_json_dict()
    assert got.selected is not None


@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_profile_architecture_sharded(variant, libs):
    """Reduced qwen1.5-0.5b, 7 modules x 3 multipliers = 21 rows on a
    three-entry mesh (7 a shard); the verification's shortlist splits
    where it divides by 3 and runs whole otherwise: rows, ranking and
    selection equal the unsharded profile's."""
    _, lib, _, _ = libs
    arch = "qwen1.5-0.5b"
    mults = ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc3"]
    cfg = get_config(arch).reduced()
    wl = lm_fidelity(cfg, batch=1, seq_len=8, n_batches=1, device="cpu")
    mmap = ModuleMap.for_config(cfg, batch=1, seq_len=8)
    n = len(mmap.modules) * len(mults)
    kw = dict(arch=arch, model_family="dense", max_drop=0.1,
              variant=variant)
    want = profile_architecture(wl, mmap, lib, mults, **kw)
    three = mesh.sweep_mesh(devices=["cpu"] * 3)
    got = profile_architecture(
        wl, mmap, lib, mults,
        assign_sharding=mesh.module_sharding(n, three), **kw)
    assert got.to_dict() == want.to_dict()
    assert len(got.rows) == n and got.selected is not None


# ----------------------------------------------------------------------
# Population CGP
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mult6():
    return array_multiplier(6)


@pytest.mark.parametrize("metric", ["mae", "er", "wce", "mse"])
def test_pop_evaluator_sharded(metric, mult6, monkeypatch):
    """11 candidates: padded to 16 on the two-entry mesh (lcm(8, 2)), one
    K11 call of 8 a shard; scores equal the unsharded run's and the
    reference's sharded one (the device-reduced metrics and the
    host-reduced fallback)."""
    p = CgpParams(metric=metric, search_samples=2048, seed=3)
    rng = np.random.default_rng(7)
    pop = [random_netlist(rng, mult6.n_i, mult6.n_o, 80) for _ in range(11)]
    want = evolve_pop.PopEvaluator(mult6, p, engine="device",
                                   device="cpu").errors_of(pop)
    calls = []
    orig = ops.bitsim_pop_planes

    def counted(funcs, *a):
        calls.append(int(funcs.shape[0]))
        return orig(funcs, *a)

    monkeypatch.setattr(ops, "bitsim_pop_planes", counted)
    ev = evolve_pop.PopEvaluator(
        mult6, p, engine="device",
        sharding=mesh.pop_sharding(evolve_pop.POP_PAD, two()))
    got = ev.errors_of(pop)
    np.testing.assert_array_equal(got, want)
    assert calls == [8, 8]
    ref = ref_pop.PopEvaluator(
        mult6, RefParams(**p.__dict__), engine="device",
        sharding=ref_mesh.pop_sharding(ref_pop.POP_PAD, ref_one())
    ).errors_of(pop)
    np.testing.assert_array_equal(got, ref)


def test_evolve_ladder_sharded(mult6):
    """A 3-rung ladder (12 offspring a generation, padded to 16): the
    sharded run walks the unsharded run's trajectory and the
    reference's sharded one's, and ``evolve_pop`` does too."""
    params = CgpParams(metric="mae", e_max=40.0, generations=12, seed=5,
                       search_samples=4096)
    seed_nl = pad_nodes(mult6, mult6.n_nodes + 10, seed=99)
    ladder = [5.0, 10.0, 40.0]
    sh = mesh.pop_sharding(evolve_pop.POP_PAD, two())
    want = evolve_pop.evolve_ladder(seed_nl, mult6, ladder, params,
                                    engine="device", device="cpu")
    got = evolve_pop.evolve_ladder(seed_nl, mult6, ladder, params,
                                   engine="device", sharding=sh)
    ref = ref_pop.evolve_ladder(
        seed_nl, mult6, ladder, RefParams(**params.__dict__),
        engine="device",
        sharding=ref_mesh.pop_sharding(ref_pop.POP_PAD, ref_one()))
    for a, b, r in zip(got, want, ref):
        assert a.netlist.to_dict() == b.netlist.to_dict() \
            == r.netlist.to_dict()
        assert a.errors.as_dict() == b.errors.as_dict() \
            == r.errors.as_dict()
    p0 = replace(params, e_max=ladder[0])
    solo = evolve_pop.evolve_pop(seed_nl, mult6, p0, engine="device",
                                 sharding=sh)
    plain = evolve_pop.evolve_pop(seed_nl, mult6, p0, engine="device",
                                  device="cpu")
    assert solo.netlist.to_dict() == plain.netlist.to_dict()


# ----------------------------------------------------------------------
# Continuous engine
# ----------------------------------------------------------------------
TINY = dict(name="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
            remat=False, loss_chunk=16)


def _uniform(mult):
    return ApproxPolicy(default=BackendSpec(mode="lut", multiplier=mult,
                                            ste=False)).to_json()


@pytest.mark.parametrize("variant", ["ref", "pallas", "fused"])
def test_continuous_engine_sharded(variant, libs):
    """4 slots split 2 + 2; 6 requests of 4 policies, greedy and
    sampled: tokens equal the unsharded engine's and sequential
    ``generate``'s; each shard makes its own banked call a projection."""
    _, lib, _, _ = libs
    cfg = LMConfig(dtype=torch.float32, **TINY)
    params = model_fns(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    rng = np.random.default_rng(1)
    kws = [dict(max_new_tokens=5),
           dict(max_new_tokens=7, temperature=0.8, seed=3,
                policy=_uniform("mul8u_trunc6")),
           dict(max_new_tokens=4, policy=_uniform("mul8u_trunc3")),
           dict(max_new_tokens=6, temperature=1.1, seed=9,
                policy=_uniform("mul8u_trunc5")),
           dict(max_new_tokens=3, policy=_uniform("mul8u_trunc6")),
           dict(max_new_tokens=5, policy=_uniform("mul8u_exact"))]
    prompts = [rng.integers(0, 128, (int(rng.integers(3, 9)),)
                            ).astype(np.int32) for _ in kws]
    runs = []
    for sh in (None, mesh.slot_sharding(4, two())):
        eng = ContinuousEngine(cfg, params, library=lib, n_slots=4,
                               capacity=32, block_size=4, n_blocks=16,
                               variant=variant, sharding=sh)
        rids = [eng.submit(p, ServeConfig(**k)) for p, k in zip(prompts,
                                                                 kws)]
        out = eng.run()
        runs.append((eng, [out[r] for r in rids]))
    (whole, want), (split, got) = runs
    assert len(split.kvs) == 2 and all(kv.n_slots == 2 for kv in split.kvs)
    assert all(kv.n_blocks == 8 for kv in split.kvs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for p, k, toks in zip(prompts, kws, got):
        seq = Engine(cfg, params, policy=split.lane_policy(ServeConfig(
            **k)), library=lib).generate(p[None], ServeConfig(**k))
        np.testing.assert_array_equal(toks, seq[0])
    per_proj = 7 * cfg.n_layers
    banked = split.step_summary()["decode"]["banked"]
    assert set(banked) <= {per_proj, 2 * per_proj} and 2 * per_proj in banked
    assert all(kv.n_free_blocks == kv.n_blocks for kv in split.kvs)


# ----------------------------------------------------------------------
# compressed_psum
# ----------------------------------------------------------------------
GRADS = {"w": np.asarray([0.5, -2.0, 3.0, 1e-3], np.float32),
         "b": {"c": np.linspace(-1, 1, 6, dtype=np.float32)}}


def test_compressed_psum_world_size_one(tmp_path):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    jmesh = jax.make_mesh((1,), ("pod",))
    f = shard_map(lambda t: ref_psum(t, "pod"), mesh=jmesh,
                  in_specs=(P(),), out_specs=P())
    want = f(jax.tree.map(jnp.asarray, GRADS))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = compressed_psum(jax.tree.map(torch.from_numpy, GRADS))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))


def test_compressed_psum_world_size_two(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    path, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=psum_worker,
                         args=(r, path, out, GRADS["w"]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs)
    gs = [GRADS["w"] * (1 + 2 * r) for r in range(2)]
    s_max = np.float32(max(np.max(np.abs(g)) / np.float32(127.0)
                           for g in gs))
    codes = [np.clip(np.round(g / s_max), -127, 127).astype(np.int32)
             for g in gs]
    want = (codes[0] + codes[1]).astype(np.float32) * s_max / np.float32(2)
    for r in range(2):
        np.testing.assert_array_equal(np.load(f"{out}{r}.npy"), want)
    # the scale each participant would take alone is its own
    _q, s = quantize_leaf(torch.from_numpy(gs[1]))
    assert float(s) == s_max
