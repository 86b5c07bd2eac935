"""The frozen multiplier tables are still the port's library.

The benchmark reads ``data/mult8.npz`` and never builds the library, so
a change to the library shows here, as a failed test, and not as a
moved yardstick (``tools/freeze_mult8.py`` writes the file anew)."""
import json

import numpy as np

from perfbench import tables
from perfbench.tools.freeze_mult8 import digest, library_tables

from perfbench.tests.helpers import ROOT


def test_frozen_tables_equal_the_default_library():
    names, tabs = tables.load(ROOT, "all")
    lib_names, lib_tabs = library_tables()
    assert names == lib_names
    assert np.array_equal(tabs, lib_tabs)


def test_record_matches_the_file():
    record = json.loads((ROOT / "perfbench" / "data" / "mult8.json")
                        .read_text())
    names, tabs = tables.load(ROOT, "all")
    assert record["names"] == names and record["count"] == len(names) == 57
    assert record["sha256_uint16"] == digest(tabs)


def test_a_named_subset_keeps_its_order():
    names, tabs = tables.load(ROOT, ["mul8u_trunc5", "mul8u_exact"])
    all_names, all_tabs = tables.load(ROOT, "all")
    assert names == ["mul8u_trunc5", "mul8u_exact"]
    assert np.array_equal(tabs[1], all_tabs[all_names.index("mul8u_exact")])
    exact = np.outer(np.arange(256), np.arange(256))
    assert np.array_equal(tabs[1], exact)
