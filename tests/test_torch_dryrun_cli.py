"""The dry run's command line and bookkeeping
(``repro_torch.launch.dryrun``):
  * ``main`` on the production mesh (in a spawned process,
    ``tests/_torch_fake_mesh_worker.main_cases``) writes one record a
    cell, records a failing cell with its error and traceback and goes
    on, dumps the op trace with ``--save-hlo``, honours
    ``--skip-existing``, and ``table`` lists the records;
  * ``_combine_linear`` against hand values;
  * the per-device argument bytes of three production cells equal the
    reference's ``NamedSharding.shard_shape`` sums, computed in a
    subprocess that sets the reference's 512 placeholder devices (the
    reference's stacked int32 ``pos`` left out: the port's is a host
    int).
"""
import json
import os
import subprocess
import sys

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from _torch_fake_mesh_worker import NARROW, main_cases, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_records_failures_and_goes_on(tmp_path):
    out = str(tmp_path)
    spawn(main_cases, out)
    with open(os.path.join(out, "qwen1.5-0.5b_decode_32k_sp.json")) as f:
        ok = json.load(f)
    with open(os.path.join(out, "jamba-v0.1-52b_decode_32k_sp.json")) as f:
        bad = json.load(f)
    assert ok["ok"] and ok["mesh"] == "data=16xmodel=16"
    assert ok["n_chips"] == 256 and ok["card"] == dryrun.CARD
    assert not bad["ok"] and bad["error"].startswith("ValueError")
    assert "traceback" in bad
    ops = open(os.path.join(out, "qwen1.5-0.5b_decode_32k_sp.ops.txt"))
    assert "aten.bmm" in ops.read()
    log = open(os.path.join(out, "log.txt")).read()
    assert "FAIL ValueError" in log and "skip qwen1.5-0.5b" in log
    rows = dryrun.table(out).splitlines()
    assert len(rows) == 4
    assert rows[2].startswith("| jamba-v0.1-52b decode_32k | no: ValueError")
    assert rows[3].startswith("| qwen1.5-0.5b decode_32k | yes |")


def test_combine_linear_hand_values():
    m1 = {"flops": 10.0, "bytes": 7.0, "coll": 3.0}
    m2 = {"flops": 16.0, "bytes": 8.0, "coll": 1.0}
    out = dryrun._combine_linear(m1, m2, 24.0)
    # fixed = 2 m1 - m2, slope = m2 - m1
    assert out == {"flops": 4.0 + 6.0 * 24, "bytes": 6.0 + 24.0,
                   "coll": 0.0}        # 5 - 2*24 < 0: clamped
    assert dryrun._combine_linear(m1, m2, 1.0) == m1
    assert dryrun._combine_linear(m1, m2, 2.0) == m2


REF_CELLS = (("qwen1.5-0.5b", "train_4k"),
             ("qwen3-moe-30b-a3b", "decode_32k"),
             ("mamba2-780m", "long_500k"))

_REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro.launch import dryrun as rd
from repro.launch.mesh import axis_size, data_axes, make_production_mesh
from repro.launch.steps import build_cell
out = {}
for arch, shape in json.loads(sys.argv[1]):
    mesh = make_production_mesh()
    cell = build_cell(arch, shape, axis_size(mesh, data_axes(mesh)))
    in_sh, _ = rd.cell_shardings(cell, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(cell.args_sds)
    shs = jax.tree.leaves(in_sh)
    total = 0
    for (path, s), sh in zip(flat, shs):
        if str(path[-1]) == "['pos']":
            continue            # the port's pos is a host int
        total += int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
    out[f"{arch}/{shape}"] = total
print(json.dumps(out))
"""


def test_argument_bytes_equal_the_reference_shard_shapes():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(REF_CELLS)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = make_production_mesh()
    for arch, shape in REF_CELLS:
        cell = build_cell(arch, shape, 16)
        in_sh, _ = dryrun.cell_shardings(cell, mesh)
        assert dryrun.per_device_bytes(cell.args_sds, in_sh) == \
            ref[f"{arch}/{shape}"], (arch, shape)


def test_narrow_overrides_are_config_fields():
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    assert all(hasattr(cfg, k) for k in NARROW)
