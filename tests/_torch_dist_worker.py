"""Worker processes of the two-process tests: ``compressed_psum``
(``tests/test_torch_sharding.py``) and the per-host checkpoint shards
(``tests/test_torch_checkpoint_shards.py``).  They import torch and the
port's modules only, so a spawned process starts quickly."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.compression import compressed_psum


def psum_worker(rank: int, store_path: str, out: str, grad) -> None:
    """Join a gloo group of two through the ``FileStore`` at
    ``store_path``, all-reduce ``{"w": grad * (1 + 2 * rank)}`` and save
    the result to ``{out}{rank}.npy``."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        g = {"w": torch.from_numpy(np.asarray(grad) * (1 + 2 * rank))}
        np.save(f"{out}{rank}.npy", compressed_psum(g)["w"].numpy())
    finally:
        dist.destroy_process_group()


def ckpt_state():
    """The (params, opt_state) both ranks save: deterministic values."""
    from repro_torch.train.optimizer import OptState
    g = torch.Generator().manual_seed(7)
    params = {"blocks": {"w": torch.randn(4, 6, generator=g)},
              "b": torch.randn(6, generator=g),
              "emb": torch.randn(8, 2, generator=g)}
    opt = OptState(step=torch.tensor(3, dtype=torch.int32),
                   m={k: v for k, v in params.items()},
                   v={k: v for k, v in params.items()})
    return params, opt


def ckpt_worker(rank: int, store_path: str, directory: str,
                out: str) -> None:
    """Join a gloo group of two, save ``ckpt_state()`` at step 5 (each
    rank its shard), then restore the parameters onto a (2, 1)
    ``("data", "model")`` DeviceMesh: ``blocks/w`` rows on data, the
    rest replicated.  Writes each leaf's placements and local shard to
    ``{out}{rank}.npz``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.train.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        CheckpointManager(directory).save(5, ckpt_state(),
                                          metadata={"rank_saved": rank})
        dm = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                        mesh_dim_names=("data", "model"))
        template = {"blocks": {"w": torch.zeros(4, 6)},
                    "b": torch.zeros(6), "emb": torch.zeros(8, 2)}
        shardings = {"blocks": {"w": NamedSharding(dm, ("data", None))},
                     "b": NamedSharding(dm, ()),
                     "emb": NamedSharding(dm, (None, "model"))}
        got, meta = CheckpointManager(directory).restore(
            {"0": template}, shardings={"0": shardings})
        got = got["0"]
        np.savez(f"{out}{rank}.npz",
                 w=got["blocks"]["w"].to_local().numpy(),
                 b=got["b"].to_local().numpy(),
                 emb=got["emb"].to_local().numpy(),
                 w_full=got["blocks"]["w"].full_tensor().numpy(),
                 placements=np.array([str(got["blocks"]["w"].placements),
                                      str(got["b"].placements),
                                      str(got["emb"].placements)]),
                 meta=np.array(str(meta)))
    finally:
        dist.destroy_process_group()
