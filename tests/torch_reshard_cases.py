"""The dry run's data-keeping reshard on real values.

``port_worker`` is one gloo rank of four spawned ranks on a (2, 2)
("data", "model") mesh: the training step's microbatch split (its
``reshape((k, B // k) + rest)``) of a (12, 5) batch sharded over
``data`` into k = 3 microbatches, an unflatten of the sharded dim that
DTensor refuses (3 rows over 2), under ``launch.mesh.sharded``.  It
writes its local shard, the gathered tensor, the result's placements and
the repairs that ran to an ``.npz``.
"""
from __future__ import annotations

import datetime
import json

import numpy as np

SHAPE, VIEW = (12, 5), (3, 4, 5)


def batch() -> np.ndarray:
    return np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)


def port_worker(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh, sharded
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        x = distribute_tensor(torch.from_numpy(batch()), mesh,
                              [Shard(0), Replicate()])
        with sharded(mesh) as rs:
            y = x.reshape(VIEW)
        np.savez(f"{out_dir}/rank{rank}.npz", local=y.to_local().numpy(),
                 full=y.full_tensor().numpy(),
                 placements=str(tuple(y.placements)),
                 ops=json.dumps(rs.ops))
    finally:
        dist.destroy_process_group()
