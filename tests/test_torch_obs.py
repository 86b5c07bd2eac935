"""The port's spans and counters (``repro_torch.obs``): off without the
profiler, one recording a profiling session, and where the banked sweep
records them (a tiny ResNet-8 sweep and a tiny MoE decoder pass, on the
CPU through the kernels' plain versions)."""
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.approx.layers import bank_eval
from repro_torch.approx.specs import LutBank
from repro_torch.approx.workload import classification
from repro_torch.configs import get_config
from repro_torch.launch import case_study
from repro_torch.models import resnet
from repro_torch.models.registry import model_fns
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPANS = ("bank_eval", "bank.pack", "bank.upload", "datapath",
         "datapath.calibrate", "datapath.epilogue", "model.bn",
         "model.moe.route", "model.moe.dispatch", "model.moe.combine")


@pytest.fixture(autouse=True)
def no_recording():
    """Each test starts with no recording left by another."""
    obs._rec = None
    yield
    obs._rec = None


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _bank(n: int = 3) -> LutBank:
    a = np.arange(256)
    exact = np.outer(a, a).astype(np.int32)
    luts = np.stack([(exact >> s) << s for s in range(n)])
    return LutBank(names=tuple(f"t{s}" for s in range(n)), luts=luts)


@pytest.fixture(scope="module")
def tiny_resnet():
    """A random ResNet-8's classification workload: 2 BN batches of 4
    images."""
    cfg = resnet.resnet_config(8)
    model = resnet.ResNet(cfg, generator=torch.Generator().manual_seed(0))
    return classification(cfg, model, eval_n=8, batch=4, device="cpu")


def _sweep(wl, bank, variant):
    return bank_eval(wl.traceable_metrics, bank, mode="lut",
                     variant=variant)


def _names(snap) -> Counter:
    return Counter(s["name"] for s in snap["spans"])


def test_without_the_profiler_nothing_is_recorded(monkeypatch):
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    a, b = obs.span("a"), obs.span("b", layer="x")
    assert a is b                      # one shared do-nothing context
    with a:
        with b:
            obs.count("bytes_to_device", 5)
    assert opened == [] and obs.snapshot() is None


def test_a_tensor_count_is_summed_only_by_the_snapshot():
    kept = torch.tensor([True, False, True])
    rows = torch.tensor([[1, 0], [2, 3]])
    with _cpu_profile() as prof:
        with obs.span("outer"):
            obs.count("slots", kept)
            obs.count("slots", rows)
            obs.count("slots", 4)
    assert not [e.name for e in prof.events()
                if e.name.startswith("aten::")]
    assert obs.total(obs.snapshot(), "slots") == 2 + 6 + 4


def test_parents_self_times_and_counters():
    obs.count("bytes_to_device", 3)              # no open span: dropped
    with _cpu_profile():
        with obs.span("outer", layer="l0"):
            time.sleep(0.002)
            with obs.span("inner"):
                time.sleep(0.004)
                obs.count("bytes_to_device", 7)
                obs.count("bytes_to_device", 4)
            with obs.span("inner"):
                with obs.span("leaf"):
                    time.sleep(0.003)
    snap = obs.snapshot()
    assert snap["clock"] == "host"
    spans = snap["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("outer", None), ("inner", 0), ("inner", 0), ("leaf", 2)]
    assert spans[0]["attrs"] == {"layer": "l0"}
    assert spans[1]["counters"] == {"bytes_to_device": 11}
    assert spans[0]["counters"] == {} and obs.total(snap,
                                                    "bytes_to_device") == 11
    for s in spans:                     # no device: the host duration
        assert s["stream_ms"] == s["host_ms"] > 0
    assert spans[1]["stream_ms"] >= 4.0 and spans[3]["stream_ms"] >= 3.0
    assert spans[0]["self_ms"] == pytest.approx(
        spans[0]["stream_ms"] - spans[1]["stream_ms"]
        - spans[2]["stream_ms"])
    assert spans[2]["self_ms"] == pytest.approx(
        spans[2]["stream_ms"] - spans[3]["stream_ms"])
    assert spans[3]["self_ms"] == spans[3]["stream_ms"]
    assert sum(obs.self_ms(snap).values()) == pytest.approx(
        spans[0]["stream_ms"])
    assert obs.stream_ms_by(snap, "outer", "layer") == {
        "l0": spans[0]["stream_ms"]}


def test_a_recording_holds_one_profiling_session():
    with _cpu_profile():
        with obs.span("first"):
            pass
    assert list(_names(obs.snapshot())) == ["first"]
    with obs.span("between"):           # profiler off: ends the recording
        obs.count("bytes_to_device", 1)
    assert list(_names(obs.snapshot())) == ["first"]
    with _cpu_profile():
        with obs.span("second"):
            pass
        with obs.span("second"):
            pass
    snap = obs.snapshot()
    assert _names(snap) == {"second": 2}
    assert snap["launches"] == {} and snap["builds"] == []


@pytest.mark.parametrize("variant", ["fused", "ref"])
def test_banked_resnet_sweep_records_its_layers(tiny_resnet, variant):
    bank = _bank()
    plain = _sweep(tiny_resnet, bank, variant)
    assert obs.snapshot() is None
    with _cpu_profile() as prof:
        traced = _sweep(tiny_resnet, bank, variant)
    for k in plain:                     # the profiler changes no bit
        assert torch.equal(plain[k], traced[k]), k
    snap = obs.snapshot()
    spans = snap["spans"]
    batches, layers = 2, 10
    assert _names(snap) == {
        "bank_eval": 1, "bank.pack": 1, "bank.upload": 1,
        "datapath": batches * layers, "datapath.calibrate": batches * layers,
        "datapath.epilogue": batches * layers, "model.bn": 7 * batches}
    upload, = (s for s in spans if s["name"] == "bank.upload")
    sixteen = bank.luts.size * 2 if variant == "fused" else 0
    assert upload["counters"] == {
        "bytes_to_device": bank.luts.nbytes + sixteen}
    assert spans[upload["parent"]]["attrs"] == {"layer": "conv_init"}
    for i, s in enumerate(spans):
        parent = None if s["parent"] is None else spans[s["parent"]]["name"]
        want = {"bank_eval": None, "datapath.calibrate": "datapath",
                "datapath.epilogue": "datapath",
                "bank.upload": "datapath"}.get(s["name"], "bank_eval")
        assert parent == want, (i, s["name"])
        if s["name"] == "datapath":
            kids = Counter(c["name"] for c in spans if c["parent"] == i)
            assert kids["datapath.calibrate"] == kids[
                "datapath.epilogue"] == 1
    by_layer = Counter(s["attrs"]["layer"] for s in spans
                       if s["name"] == "datapath")
    assert set(by_layer.values()) == {batches} and len(by_layer) == layers
    root, = (s for s in spans if s["name"] == "bank_eval")
    assert sum(s["self_ms"] for s in spans) == pytest.approx(
        root["stream_ms"])
    # host ranges only: no program span is a device event
    ranges = [e for e in prof.events() if e.name in SPANS]
    assert len(ranges) == len(spans)
    assert all(str(e.device_type).endswith("CPU") for e in ranges)


def test_profile_table_of_a_recording(tiny_resnet):
    bank = _bank(2)
    with _cpu_profile():
        _sweep(tiny_resnet, bank, "fused")
    lines = []
    table = case_study._span_table(obs.snapshot(), lines.append)
    assert set(table["self_ms"]) == {"bank_eval", "bank.pack",
                                     "bank.upload", "datapath",
                                     "datapath.calibrate",
                                     "datapath.epilogue", "model.bn"}
    assert len(table["datapath_ms"]) == 10
    assert table["bytes_to_device"] == bank.luts.nbytes * 3 // 2
    assert table["launches"] == {} and table["builds"] == []
    assert any("conv_init" in line for line in lines)


def test_moe_pass_records_routing_a_layer():
    """Route, dispatch and combine: one span each a MoE layer, around all
    of its lanes' calls."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    fns = model_fns(cfg)
    params = fns.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (1, 9),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    bank = _bank(2)

    def loss(policy):
        return {"loss": fns.forward_train(params, batch, cfg, policy)}
    plain = bank_eval(loss, bank, mode="lut", variant="fused")
    with _cpu_profile():
        traced = bank_eval(loss, bank, mode="lut", variant="fused")
    assert torch.equal(plain["loss"], traced["loss"])
    snap = obs.snapshot()
    names = _names(snap)
    for part in ("route", "dispatch", "combine"):
        assert names[f"model.moe.{part}"] == cfg.n_layers
    assert names["bank_eval"] == 1 and names["bank.upload"] == 1
    spans = snap["spans"]
    for s in spans:
        if s["name"].startswith("model.moe."):
            assert spans[s["parent"]]["name"] == "bank_eval"


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' stream events and K4 "
                    "run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_sweep_spans_are_host_ranges_timed_on_the_stream(cuda):
    """On the card: a span's stream ms comes from its events, every
    program span is a host range and none a device event, the self times
    add up to the sweep's, and the profiler changes no bit."""
    cfg = resnet.resnet_config(8)
    model = resnet.ResNet(cfg, generator=torch.Generator().manual_seed(0))
    wl = classification(cfg, model.to(cuda), eval_n=8, batch=4,
                        device=cuda)
    bank = _bank()
    plain = _sweep(wl, bank, "fused")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = _sweep(wl, bank, "fused")
        torch.cuda.synchronize()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    snap = obs.snapshot()
    assert snap["clock"] == "cuda"
    assert snap["launches"] == {"fused_matmul_bank": 20}
    spans = snap["spans"]
    assert _names(snap)["datapath"] == 20
    root, = (s for s in spans if s["name"] == "bank_eval")
    assert root["stream_ms"] > 0
    assert sum(s["self_ms"] for s in spans) == pytest.approx(
        root["stream_ms"], rel=1e-4)
    events = [e for e in prof.events() if e.name in SPANS]
    assert len(events) == len(spans)
    assert all(str(e.device_type).endswith("CPU") for e in events)
