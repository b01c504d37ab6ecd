"""The pipeline schedule's case, run through both packages.

``weights`` gives the stack of ``tests/test_pipeline.py`` (L 8 tanh
layers of width 16, a batch of 12) from a NumPy seed; ``port_worker`` is
one gloo rank of a spawned group running the port's ``pipeline_forward``
at every microbatch count, and ``jax_main`` one JAX process (4 host
devices, ``XLA_FLAGS`` set by the caller) running the reference's.  Each
writes its outputs to an ``.npz``; neither imports the other package.
"""
from __future__ import annotations

import datetime

import numpy as np

L, B, D = 8, 12, 16
MICROBATCHES = (2, 3, 6)


def weights():
    """``(w (L, D, D), b (L, D), x (B, D))``, float32."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return w, b, x


def port_worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank: the pipeline at every microbatch count, the serial stack
    on the whole batch and microbatch by microbatch, to
    ``rank{r}.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.runtime.pipeline import pipeline_forward
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        w, b, x = (torch.from_numpy(a) for a in weights())
        params = {"w": w, "b": b}

        def layer_apply(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        def serial(h):
            for i in range(L):
                h = layer_apply({"w": w[i], "b": b[i]}, h)
            return h

        out = {"serial": serial(x).numpy()}
        for m in MICROBATCHES:
            out[f"pipe{m}"] = pipeline_forward(
                params, x, layer_apply, n_microbatches=m).numpy()
            out[f"serial_mb{m}"] = torch.cat(
                [serial(c) for c in x.chunk(m)]).numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def jax_main(out_path: str) -> None:
    """The reference's ``pipeline_forward`` on 4 host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.runtime.pipeline import AXIS, pipeline_forward
    w, b, x = weights()
    mesh = Mesh(np.array(jax.devices()), (AXIS,))

    def layer_apply(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    np.savez(out_path, **{
        f"pipe{m}": np.asarray(pipeline_forward(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            layer_apply, mesh=mesh, n_microbatches=m))
        for m in MICROBATCHES})
