"""A worker process of the two-process ``compressed_psum`` test
(``tests/test_torch_sharding.py``): it imports torch and the port's
compression module only, so a spawned process starts quickly."""
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
