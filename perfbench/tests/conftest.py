"""Fixtures of the benchmark's CPU tests: the program (``src/``) and the
checkout's root on the path, and ``tiny_root`` (``helpers.make_tiny_root``)
once a session."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    from perfbench.tests.helpers import make_tiny_root
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
