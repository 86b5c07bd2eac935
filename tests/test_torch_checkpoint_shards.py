"""Per-host checkpoint shards and the reshard on restore
(``repro_torch.train.checkpoint``) against the reference's
``repro.train.checkpoint``.

Two gloo ranks in spawned processes (``tests/_torch_dist_worker.py``)
save one state: ``shard-00000.npz`` and ``shard-00001.npz`` are written,
each with its share of the leaves, under a manifest with ``n_hosts`` 2;
the reference's ``CheckpointManager.restore`` reads them bit for bit;
each rank's ``restore(shardings=...)`` gives DTensors with the
placements asked for on a (2, 1) mesh, its own rows of a row-sharded
leaf.  The port restores what the reference wrote, and a process with no
group still writes one ``shard-00000``.
"""
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.train.checkpoint import CheckpointManager as RefManager
from repro.train.checkpoint import _flatten as ref_flatten
from repro.train.optimizer import OptState as RefOptState
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptState, tree_leaves
from _torch_dist_worker import ckpt_state, ckpt_worker


def _zeros(tree):
    if isinstance(tree, OptState):
        return OptState(*(_zeros(t) for t in tree))
    if isinstance(tree, tuple):
        return tuple(_zeros(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _ref_template():
    params, opt = ckpt_state()
    p = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32),
                     params)
    return (p, RefOptState(step=jnp.zeros((), jnp.int32), m=p, v=p))


def test_two_ranks_write_shards_the_reference_restores(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    directory = str(tmp_path / "ckpt")
    store, out = str(tmp_path / "store"), str(tmp_path / "out")
    procs = [ctx.Process(target=ckpt_worker,
                         args=(r, store, directory, out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs)

    step = os.path.join(directory, "step-000000005")
    assert sorted(os.listdir(step)) == ["manifest.json", "shard-00000.npz",
                                        "shard-00001.npz"]
    manifest = json.load(open(os.path.join(step, "manifest.json")))
    assert manifest["n_hosts"] == 2
    with np.load(os.path.join(step, "shard-00000.npz")) as a, \
            np.load(os.path.join(step, "shard-00001.npz")) as b:
        k0, k1 = set(a.files), set(b.files)
    assert k0 and k1 and not k0 & k1
    assert k0 | k1 == set(manifest["leaves"])

    params, opt = ckpt_state()
    got, meta = RefManager(directory).restore(_ref_template())
    assert meta == {"rank_saved": 0}
    want = {k: v.numpy() for k, v in tree_leaves((params, opt))}
    have = ref_flatten(got)
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])

    w = params["blocks"]["w"].numpy()
    for r in range(2):
        with np.load(f"{out}{r}.npz") as z:
            assert list(z["placements"]) == [
                "(Shard(dim=0), Replicate())", "(Replicate(), Replicate())",
                "(Replicate(), Shard(dim=1))"]
            np.testing.assert_array_equal(z["w"], w[2 * r:2 * r + 2])
            np.testing.assert_array_equal(z["w_full"], w)
            np.testing.assert_array_equal(z["b"], params["b"].numpy())
            np.testing.assert_array_equal(z["emb"], params["emb"].numpy())


def test_port_restores_a_reference_checkpoint(tmp_path):
    params, opt = ckpt_state()
    state = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
             RefOptState(step=jnp.asarray(3, jnp.int32),
                         m=jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                        opt.m),
                         v=jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                        opt.v)))
    RefManager(str(tmp_path)).save(2, state, metadata={"by": "reference"})
    template = _zeros((params, opt))
    got, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta == {"by": "reference"}
    assert torch.equal(got[0]["blocks"]["w"], params["blocks"]["w"])
    assert torch.equal(got[1].v["emb"], params["emb"])
    assert int(got[1].step) == 3


def test_one_process_writes_one_shard(tmp_path):
    CheckpointManager(str(tmp_path)).save(1, ckpt_state())
    step = os.path.join(str(tmp_path), "step-000000001")
    assert sorted(os.listdir(step)) == ["manifest.json", "shard-00000.npz"]
    assert json.load(open(os.path.join(step, "manifest.json")))[
        "n_hosts"] == 1
