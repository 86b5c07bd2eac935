"""The port's numpy copies of ``repro.core`` and ``repro.data`` equal the
reference: the tiny circuit library entry for entry (errors, costs,
power, LUTs bit for bit on the case-study set) and the synthetic data
array for array."""
import numpy as np
import pytest

from repro.core import library as ref_library
from repro.data import synthetic as ref_synthetic
from repro_torch.core import library as port_library
from repro_torch.data import synthetic as port_synthetic
from repro_torch.launch.case_study import case_study_names


@pytest.fixture(scope="module")
def libs():
    return (ref_library.build_default_library("tiny"),
            port_library.build_default_library("tiny"))


def test_library_entries_equal(libs):
    ref, port = libs
    assert list(port.entries) == list(ref.entries)
    for name, e in ref.entries.items():
        p = port.entries[name]
        assert (p.kind, p.width, p.source) == (e.kind, e.width, e.source)
        assert p.rel_power == e.rel_power
        assert p.errors.as_dict() == e.errors.as_dict()
        assert p.cost.as_dict() == e.cost.as_dict()
        assert p.netlist.to_dict() == e.netlist.to_dict()


def test_case_study_selection_and_luts_equal(libs):
    ref, port = libs
    ref_sel = [e.name for e in ref.case_study_selection()]
    assert [e.name for e in port.case_study_selection()] == ref_sel
    names = case_study_names(port, 16)
    assert len(names) == 17
    for name in names:
        lut = port.lut(name)
        assert lut.dtype == np.int32 and lut.shape == (256, 256)
        np.testing.assert_array_equal(lut, ref.lut(name))
        assert 0 <= lut.min() and lut.max() <= 0xFFFF   # fits uint16


def test_case_study_names_match_benchmark_rule(libs):
    """Same rule as benchmarks/resilience_common.case_study_names
    (which imports JAX, so the port keeps its own copy)."""
    ref, port = libs
    sel = [e.name for e in ref.case_study_selection(per_metric=10)][:16]
    for extra in ("mul8u_trunc7", "mul8u_trunc6", "mul8u_bam_h0_v4"):
        if extra in ref.entries and extra not in sel:
            sel.append(extra)
    assert case_study_names(port, 16) == sel


def test_population_engines_not_ported():
    """The population engines are ported (``tests/test_torch_evolve_pop
    .py`` holds their builds against the reference); an unknown engine
    still raises, and the device engine runs on the GPU unless the
    caller names the CPU."""
    with pytest.raises(ValueError, match="unknown engine"):
        port_library.build_default_library("tiny", engine="gpu")
    with pytest.raises(ValueError, match="unknown engine"):
        port_library.build_default_library("tiny", engine="gpu",
                                           device="cpu")


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_cifar_equal(split):
    ri, rl = ref_synthetic.synthetic_cifar(split, 12, seed=3)
    pi, pl = port_synthetic.synthetic_cifar(split, 12, seed=3)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pl, rl)


def test_cifar_eval_batches_equal():
    ref = list(ref_synthetic.CifarBatches("test", 32, 8).eval_batches())
    port = list(port_synthetic.CifarBatches("test", 32, 8).eval_batches())
    assert len(port) == len(ref) == 4
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p["images"], r["images"])
        np.testing.assert_array_equal(p["labels"], r["labels"])


def test_token_stream_equal():
    rt, rg = ref_synthetic.token_stream(1000, 2, 16, step=5, seed=1)
    pt, pg = port_synthetic.token_stream(1000, 2, 16, step=5, seed=1)
    np.testing.assert_array_equal(pt, rt)
    np.testing.assert_array_equal(pg, rg)
