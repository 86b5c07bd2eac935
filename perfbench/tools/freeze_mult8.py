#!/usr/bin/env python3
"""Write ``perfbench/data/mult8.npz`` and its record ``mult8.json``: the
names and 256 x 256 product tables of every 8-bit multiplier of the
port's default library, in the library's order.

    PYTHONPATH=src python3 perfbench/tools/freeze_mult8.py

The benchmark reads the frozen file and never builds the library, so a
change to the library cannot move the yardstick;
``perfbench/tests/test_perfbench_tables.py`` fails when the two part.
"""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))


def library_tables():
    from repro_torch.core.library import get_default_library
    lib = get_default_library()
    names = [e.name for e in lib.entries.values()
             if e.kind == "multiplier" and e.width == 8]
    return names, np.stack([np.asarray(lib.lut(n)) for n in names])


def digest(tables: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        tables.astype(np.uint16)).tobytes()).hexdigest()


def main() -> None:
    names, tabs = library_tables()
    if tabs.min() < 0 or tabs.max() > 0xFFFF:
        raise SystemExit("a table entry does not fit 16 bits")
    data = ROOT / "perfbench" / "data"
    np.savez_compressed(data / "mult8.npz", names=np.array(names),
                        tables=tabs.astype(np.uint16))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    (data / "mult8.json").write_text(json.dumps({
        "library": "repro_torch.core.library.get_default_library(): the "
                   "tiny build (no library_data artifact), 8-bit "
                   "multipliers in entry order",
        "commit": commit, "count": len(names), "names": names,
        "sha256_uint16": digest(tabs)}, indent=1) + "\n")
    print(f"{len(names)} tables frozen at {commit}")


if __name__ == "__main__":
    main()
