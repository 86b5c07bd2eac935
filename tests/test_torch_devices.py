"""The kernels on a device that is not the current one (``gpu``; skips
below two cards).

Each of K1-K11 is launched first on ``cuda:0`` and then on ``cuda:1``
while ``cuda:0`` stays current: the wrappers make the operands' device
current for the launch (``kernels.approx_matmul.enter_device``) and the
large shared memory opt-in is set once a device, so the second launch
runs on ``cuda:1`` and equals the kernel's plain version on the same
inputs (K9 within its f32 bound, ``kernels.ref.lowrank_bound``); the
current device is ``cuda:0`` again afterwards.  No JAX is imported, so
``pytest -m gpu tests/test_torch_devices.py`` runs on a machine with the
cards alone."""
import numpy as np
import pytest
import torch

from repro_torch.approx.registry import encode_reduce
from repro_torch.core.netlist import stack_netlists
from repro_torch.core.seeds import array_multiplier
from repro_torch.kernels import ops, ref


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch on a device that is "
                    "not the current one")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _inputs(dev: torch.device) -> dict:
    """Every kernel's operands on ``dev``, from one seed (a fused call's
    activations shared over 3 lanes; K3/K4 at K = 576, whose staging
    takes the large shared memory opt-in)."""
    gen = torch.Generator().manual_seed(0)
    m, k, n, lanes = 96, 576, 64, 3

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    luts = ints((lanes, 256, 256), 1 << 16)
    x = torch.randn((m, k), generator=gen).to(dev)
    w = (torch.randn((k, n), generator=gen) * 0.2).to(dev)
    exact = array_multiplier(8)
    nets = [exact] * 4
    planes = ops.words_to_device(ops.split_planes64(
        np.random.default_rng(0).integers(0, 2 ** 63, (16, 64),
                                          dtype=np.uint64)), dev)
    return {
        "qa": ints((m, k), 256), "qa_bank": ints((lanes, m, k), 256),
        "qw": ints((k, n), 256), "wa": ints((m, k), 1 << 16),
        "ww": ints((k, n), 1 << 16), "luts": luts, "x": x, "w": w,
        "masks": torch.tensor([0xFFFFFFFF] * lanes, dtype=torch.int64,
                              device=dev),
        "u": torch.randn((4, 256), generator=gen).to(dev),
        "v": torch.randn((4, 256), generator=gen).to(dev),
        "net": ops.netlist_tensors((exact.funcs, exact.in0, exact.in1,
                                    exact.outputs), exact.n_i, dev),
        "pop": ops.netlist_tensors(stack_netlists(nets), exact.n_i, dev),
        "planes": planes,
    }


def _calls(t: dict) -> dict:
    """K1-K11 on ``t``'s tensors, each through ``kernels.ops``."""
    sc = (0.05, 3, 0.01, 7, 255)
    rc = ("loa", 4)
    rcodes = torch.tensor([encode_reduce(rc)] * 3, dtype=torch.int32,
                          device=t["x"].device)
    return {
        "K1": lambda: ops.approx_matmul_lut(t["qa"], t["qw"], t["luts"][0]),
        "K2": lambda: ops.approx_matmul_lut_bank(t["qa_bank"], t["qw"],
                                                 t["luts"]),
        "K3": lambda: ops.fused_matmul_lut(t["x"], t["w"], t["luts"][0],
                                           *sc),
        "K4": lambda: ops.fused_matmul_lut_bank(t["x"], t["w"], t["luts"],
                                                *sc),
        "K5": lambda: ops.composed_matmul_lut(t["wa"], t["ww"],
                                              t["luts"][0], 0xFFFFFFFF, rc),
        "K6": lambda: ops.composed_matmul_lut_bank(
            t["wa"], t["ww"], t["luts"], t["masks"], rc),
        "K7": lambda: ops.fused_composed_matmul_lut(
            t["x"], t["w"], t["luts"][0], 0xFFFFFFFF, encode_reduce(rc),
            0.001, 3, 0.0005, 7, 65535),
        "K8": lambda: ops.fused_composed_matmul_lut_bank(
            t["x"], t["w"], t["luts"], t["masks"], rcodes, 0.001, 3,
            0.0005, 7, 65535),
        "K9": lambda: ops.lowrank_matmul(t["qa"], t["qw"], t["u"], t["v"]),
        "K10": lambda: ops.bitsim_planes(*t["net"], t["planes"]),
        "K11": lambda: ops.bitsim_pop_planes(*t["pop"], t["planes"]),
    }


@pytest.mark.gpu
def test_kernels_launch_on_a_device_that_is_not_current(two_cards):
    dev0, dev1 = two_cards
    on0, on1 = _calls(_inputs(dev0)), _calls(_inputs(dev1))
    cpu_in = _inputs(torch.device("cpu"))
    plain = _calls(cpu_in)
    for name in on0:
        on0[name]()                     # the opt-in set on cuda:0 first
        before = ops.launch_counts()
        got = on1[name]()
        torch.cuda.synchronize(dev1)
        assert torch.cuda.current_device() == 0, name
        after = ops.launch_counts()
        assert sum(after.values()) - sum(before.values()) == 1, name
        want = plain[name]()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, v in zip(got, want):
            assert g.device == dev1, name
            if name == "K9":
                y64, tol = ref.lowrank_bound(cpu_in["qa"], cpu_in["qw"],
                                             cpu_in["u"], cpu_in["v"])
                assert bool(((g.cpu().double() - y64).abs() <= tol).all())
            else:
                assert torch.equal(g.cpu(), v), name


def _library():
    from repro_torch.core.families import truncated_multiplier
    from repro_torch.core.library import ApproxLibrary
    lib = ApproxLibrary()
    exact = array_multiplier(8)
    lib.add_netlist(exact, "multiplier", 8, "exact", exact,
                    name="mul8u_exact")
    for k in (2, 3, 5):
        lib.add_netlist(truncated_multiplier(8, k), "multiplier", 8,
                        "truncation", exact)
    return lib


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["pallas", "fused"])
def test_bank_eval_split_across_two_cards(two_cards, variant):
    """A 4-lane bank split 2 + 2 over ``cuda:0`` and ``cuda:1``: each
    shard runs on its card through the workload's per-device form, one
    banked launch a layer a shard, the lanes gathered on ``cuda:0`` equal
    the unsharded run's bit for bit."""
    from repro_torch.approx.layers import bank_eval
    from repro_torch.approx.specs import bank_for
    from repro_torch.approx.workload import DeviceForms
    from repro_torch.launch.mesh import bank_sharding, sweep_mesh
    dev0, dev1 = two_cards
    lib = _library()
    bank = bank_for(["mul8u_exact", "mul8u_trunc6", "mul8u_trunc5",
                     "mul8u_trunc3"], lib)
    gen = torch.Generator().manual_seed(1)
    state = tuple(torch.randn(shape, generator=gen).to(dev0)
                  for shape in ((64, 96), (96, 96), (96, 10)))

    def make(st, _dev):
        x, wa, wb = st

        def fn(policy):
            y = policy.matmul("lin_a", x, wa)
            return {"y": policy.matmul("lin_b", torch.relu(y), wb,
                                       lanes=y.ndim == 3)}
        return fn

    fn = DeviceForms(make, state, dev0)
    kernel = {"pallas": "lut_matmul_bank", "fused": "fused_matmul_bank"}
    ops.reset_launch_counts()
    want = bank_eval(fn, bank, variant=variant)["y"]
    assert ops.launch_counts()[kernel[variant]] == 2
    mesh = sweep_mesh(max_devices=2)
    assert mesh.devices == (dev0, dev1)
    ops.reset_launch_counts()
    got = bank_eval(fn, bank, variant=variant,
                    sharding=bank_sharding(4, mesh))["y"]
    torch.cuda.synchronize(dev1)
    assert ops.launch_counts()[kernel[variant]] == 4
    assert got.device == dev0 and torch.cuda.current_device() == 0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_continuous_engine_split_across_two_cards(two_cards):
    """4 slots split 2 + 2 over two cards: a replica of the parameters
    on ``cuda:1``, tokens equal the one-card engine's."""
    import dataclasses
    from repro_torch.approx.layers import ApproxPolicy
    from repro_torch.approx.specs import BackendSpec
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import slot_sharding, sweep_mesh
    from repro_torch.models.registry import model_fns
    from repro_torch.serve import ContinuousEngine, ServeConfig
    dev0, dev1 = two_cards
    lib = _library()
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              dtype=torch.float32)
    params = model_fns(cfg).init_params(
        torch.Generator(device=dev0).manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab, (6,)).astype(np.int32),
             ServeConfig(max_new_tokens=5, temperature=0.8 * (i % 2),
                         seed=i, policy=ApproxPolicy(default=BackendSpec(
                             mode="lut", multiplier=m, ste=False)).to_json()))
            for i, m in enumerate(["mul8u_exact", "mul8u_trunc6",
                                   "mul8u_trunc5", "mul8u_trunc3"])]
    outs = []
    for sharding in (None, slot_sharding(4, sweep_mesh(max_devices=2))):
        eng = ContinuousEngine(cfg, params, library=lib, n_slots=4,
                               capacity=16, block_size=4, variant="pallas",
                               sharding=sharding)
        rids = [eng.submit(p, s) for p, s in reqs]
        done = eng.run()
        outs.append([done[r].tolist() for r in rids])
        if sharding is not None:
            assert [kv.device for kv in eng.kvs] == [dev0, dev1]
            assert any(e.get("shards") == 2 for e in eng.step_log)
    assert outs[0] == outs[1]
