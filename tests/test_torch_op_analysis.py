"""The port's op-stream analysis (``repro_torch.launch.op_analysis``),
the counterpart of the reference's HLO-text analysis
(``repro.launch.hlo_analysis``).

  * the dtype table agrees with the reference's ``_DTYPE_BYTES`` on
    every dtype both name, and covers every torch dtype;
  * on plain tensors: flops of matmuls (``torch.utils.flop_counter``'s
    formulas), bytes accessed (operands + results; views move none),
    the op histogram and bytes by op;
  * on a fake (2, 2) mesh (in a spawned process): the collective bytes
    of known redistributions (the operand bytes each device sends, as
    the reference counts them) and the local flops and the one
    all-gather of an FSDP weight under a 2-D-sharded matmul.
"""
import json

import pytest
import torch

from repro.launch import hlo_analysis as ref
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import (DTYPE_BYTES, XLA_NAMES, OpTrace,
                                            bytes_by_op, collective_bytes,
                                            op_histogram, tensor_bytes)
from _torch_fake_mesh_worker import op_analysis_cases, spawn


def test_dtype_table_agrees_with_the_reference():
    for dt, name in XLA_NAMES.items():
        assert DTYPE_BYTES[dt] == ref._DTYPE_BYTES[name], name
    every = {getattr(torch, n) for n in dir(torch)
             if isinstance(getattr(torch, n), torch.dtype)}
    assert every <= set(DTYPE_BYTES)
    assert tensor_bytes(torch.empty(3, 5, dtype=torch.bfloat16,
                                    device="meta")) == 30
    assert set(op_analysis.COLLECTIVE_OPS) == set(ref.COLLECTIVE_OPS)


def test_plain_trace_counts_flops_bytes_and_ops():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    tr = OpTrace(keep_ops=True)
    with tr:
        c = a @ b                     # 2*8*16*4 flops
        d = c.t()                     # a view: no bytes
        e = (d + 1.0).sum()
    assert tr.flops == 2 * 8 * 16 * 4
    hist = dict(op_histogram(tr))
    assert hist["aten.mm"] == 1 and hist["aten.t"] == 1
    assert hist["aten.add"] == 1 and hist["aten.sum"] == 1
    f32 = 4
    want = ((8 * 16 + 16 * 4 + 8 * 4)      # mm: operands + result
            + (32 + 32)                    # add: operand + result
            + (32 + 1)) * f32              # sum
    assert tr.bytes_accessed == want
    rows = {op: (b_, n) for op, b_, n in bytes_by_op(tr)}
    assert rows["aten.mm"] == (32 * f32, 1)
    assert collective_bytes(tr) == {"total_bytes": 0}
    assert [r[0] for r in tr.rows] == ["aten.mm", "aten.t", "aten.add",
                                       "aten.sum"]
    assert "aten.mm 1 1024" in op_analysis.dump(tr)
    assert float(e) == pytest.approx(float((c.t() + 1).sum()))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("oa") / "cases.json")
    spawn(op_analysis_cases, out)
    with open(out) as f:
        return json.load(f)


def test_collective_bytes_of_known_redistributions(cases):
    f32 = 4
    # Shard(0) over data -> Replicate: all-gather of the local (4, 16)
    assert cases["gather_rows"] == {
        "all-gather": {"bytes": 4 * 16 * f32, "count": 1},
        "total_bytes": 4 * 16 * f32}
    # Partial -> Replicate: all-reduce of the whole (8, 16)
    assert cases["reduce"] == {
        "all-reduce": {"bytes": 8 * 16 * f32, "count": 1},
        "total_bytes": 8 * 16 * f32}
    # Partial -> Shard(0): reduce-scatter, operand the whole (8, 16)
    assert cases["scatter"] == {
        "reduce-scatter": {"bytes": 8 * 16 * f32, "count": 1},
        "total_bytes": 8 * 16 * f32}


def test_two_d_sharded_matmul_counts_local_work(cases):
    """x (64, 64) rows on data @ w (64, 128) K on data, N on model: the
    weight's (32, 64) shard is all-gathered over data (the FSDP
    gather), then each device multiplies (32, 64) @ (64, 64)."""
    mm = cases["matmul"]
    assert mm["flops"] == 2 * 32 * 64 * 64
    assert mm["collectives"] == {"all-gather": {"bytes": 32 * 64 * 4,
                                                "count": 1},
                                 "total_bytes": 32 * 64 * 4}
    assert mm["placements"] == ["S(0)", "S(1)"]
    assert mm["local"] == [32, 64]
