"""Worker processes of the dry-run and op-analysis tests
(``tests/test_torch_dryrun.py``, ``tests/test_torch_op_analysis.py``).

Each function runs in a spawned process, sets up the ``"fake"`` process
groups it needs (``launch.dryrun.fake_mesh``), and writes what it found
to the JSON file ``out``: a fake group never meets another test's group
in the parent's process."""
import json

import torch

#: narrow widths of a dense arch for the tests (the cells' batch and
#: sequence stay those of ``configs.shapes.SHAPES``: the tensors are
#: ``meta``)
NARROW = {"n_layers": "2", "d_model": "64", "n_heads": "4",
          "n_kv_heads": "2", "head_dim": "16", "d_ff": "128",
          "vocab": "256"}


def spawn(target, out: str, timeout: float = 240) -> None:
    """Run ``target(out)`` in a spawned process; it must exit 0."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=target, args=(out,))
    p.start()
    p.join(timeout)
    if p.is_alive():
        p.kill()
    assert p.exitcode == 0, f"worker exited with {p.exitcode}"


def _save(out: str, record) -> None:
    with open(out, "w") as f:
        json.dump(record, f)


def op_analysis_cases(out: str) -> None:
    """Collectives of known redistributions and the local flops of a
    2-D-sharded matmul on a fake (2, 2) mesh."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.mesh import Mesh

    rec = {}

    def dt(local_shape, placements, dm, dtype=torch.float32):
        return DTensor.from_local(
            torch.empty(local_shape, dtype=dtype, device="meta"), dm,
            placements, run_check=False)

    with fake_mesh(Mesh(("data", "model"), (2, 2))) as dm:
        cases = {
            "gather_rows": ((4, 16), [Shard(0), Replicate()],
                            [Replicate(), Replicate()]),
            "reduce": ((8, 16), [Partial(), Replicate()],
                       [Replicate(), Replicate()]),
            "scatter": ((8, 16), [Partial(), Replicate()],
                        [Shard(0), Replicate()]),
        }
        for name, (local, src, dst) in cases.items():
            x = dt(local, src, dm)
            tr = op_analysis.OpTrace()
            with tr:
                x.redistribute(dm, dst)
            rec[name] = op_analysis.collective_bytes(tr)
        # x (B, K) batch on data @ w (K, N): K on data, N on model (an
        # FSDP in-projection): per device B/2 x K @ K x N/2
        x = dt((32, 64), [Shard(0), Replicate()], dm)
        w = dt((32, 64), [Shard(0), Shard(1)], dm)
        tr = op_analysis.OpTrace()
        with tr:
            y = x @ w
        rec["matmul"] = {"flops": tr.flops,
                         "collectives": op_analysis.collective_bytes(tr),
                         "placements": [str(p) for p in y.placements],
                         "local": list(y.to_local().shape)}
    _save(out, rec)


def dryrun_cases(out: str) -> None:
    """The narrow dense arch's cells on fake (2, 2) and (16, 16) meshes
    and on a (1, 1) mesh; then a gloo group in the same process."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    rec = {}
    two, big, one = (Mesh(("data", "model"), (2, 2)),
                     Mesh(("data", "model"), (16, 16)),
                     Mesh(("data", "model"), (1, 1)))
    runs = {"2x2/decode": (two, "decode_32k", "lowrank", {}),
            "16x16/decode": (big, "decode_32k", "lowrank", {}),
            "16x16/decode/full": (big, "decode_32k", "lowrank",
                                  {"probes": False}),
            "16x16/train": (big, "train_4k", "lowrank", {}),
            "1x1/decode": (one, "decode_32k", "lowrank", {}),
            "1x1/decode/bf16": (one, "decode_32k", "bf16", {})}
    for name, (m, shape, mode, kw) in runs.items():
        rec[name] = dryrun.run_cell("qwen1.5-0.5b", shape, mesh=m,
                                    overrides=NARROW, serve_mode=mode,
                                    serve_mult="mul8u_exact", **kw)
        assert not dist.is_initialized()
    # the group is gone: a gloo group of one comes up and goes down
    store = dist.FileStore(out + ".store", 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    t = torch.ones(3)
    dist.all_reduce(t)
    rec["gloo_after"] = t.tolist()
    dist.destroy_process_group()
    _save(out, rec)


def main_cases(out: str) -> None:
    """``dryrun.main`` on the production mesh: one narrow cell that
    lowers and one that fails (a hybrid's depth that does not divide its
    period), then ``--skip-existing``."""
    torch.set_num_threads(1)
    import contextlib
    import io

    from repro_torch.launch import dryrun

    log = io.StringIO()
    narrow = [f"--override={k}={v}" for k, v in NARROW.items()]
    with contextlib.redirect_stdout(log):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--serve-mult", "mul8u_exact", "--save-hlo",
                     "--out", out, *narrow])
        dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "decode_32k",
                     "--override", "n_layers=3", "--out", out])
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--skip-existing", "--out", out])
    with open(out + "/log.txt", "w") as f:
        f.write(log.getvalue())
