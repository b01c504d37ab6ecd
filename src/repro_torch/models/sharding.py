"""Activation sharding constraints (logical-axis indirection).

The port of the JAX package's ``models/sharding.py``.  Models call
``constrain(x, "dp", None, "tp")`` with *logical* axis names; the
mapping to mesh axes is resolved against the ambient mesh that
``launch.mesh.mesh_context`` installs:

    "dp"    → ("pod", "data")  (whichever exist)   — batch / fsdp dim
    "tp"    → "model"                               — heads / ffn / vocab
    "sp"    → "data"                                — sequence
    "tpseq" → "model"                               — Megatron-style
                                                      sequence parallelism

Outside any mesh (unit tests, one-card runs) ``constrain`` returns its
input, so model code never depends on launch topology.  Under a mesh it
redistributes a ``DTensor`` to the resolved placements (what
``with_sharding_constraint`` asks of GSPMD) and returns a plain tensor
as it is; a dimension whose size does not divide its axes' product is
left replicated (the rule of ``launch.partition.sanitize``).
"""
from __future__ import annotations

import contextlib
import os

_AMBIENT: list = []


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None, a
    mesh axis name, or a tuple of names (major to minor); the port's
    ``jax.sharding.PartitionSpec``, which also writes a tuple of one name
    as the name and an empty tuple as None.  Missing trailing entries
    are None."""

    def __new__(cls, *dims):
        return super().__new__(cls, (
            (d[0] if len(d) == 1 else d or None) if isinstance(d, tuple)
            else d for d in dims))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` with dim names, or of any
    object with ``axis_names`` and a ``devices`` array (the shape the
    reference's tests fake a mesh with)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def sanitize(mesh, spec, shape) -> P:
    """Drop axis names whose size does not divide the dimension (2 KV
    heads cannot shard over a 16-way 'model' axis: such dims fall back to
    replicated, the Megatron convention for kv_heads < tp).  The result
    has one entry per dimension."""
    sizes = axis_sizes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, n in zip(dims, shape):
        if d is None:
            out.append(None)
            continue
        total = 1
        for a in (d if isinstance(d, tuple) else (d,)):
            total *= sizes[a]
        out.append(d if n % total == 0 else None)
    return P(*out)


def placements(mesh, spec) -> tuple:
    """DTensor placements of a spec on a ``DeviceMesh``: tensor dim i
    named by an axis (or a tuple of axes) is ``Shard(i)`` on those mesh
    dims, every other mesh dim ``Replicate()``.  The axes of a tuple must
    come in the mesh's order (major to minor), the only order a
    ``Shard`` on several mesh dims splits in.  A mesh dim of size 1
    splits nothing, so it replicates (DTensor would otherwise copy or
    refuse ops across it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, d in enumerate(spec):
        if d is None:
            continue
        axes = d if isinstance(d, tuple) else (d,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {i} are not in the mesh's "
                             f"order {tuple(names)}")
        for j in idx:
            if mesh.shape[j] > 1:
                out[j] = Shard(i)
    return tuple(out)


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` (a ``DeviceMesh`` with dim names) as the ambient
    mesh for the block; ``launch.mesh`` re-exports it."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def _ambient_mesh():
    return _AMBIENT[-1] if _AMBIENT else None


def _resolve(name, axis_names):
    if name is None:
        return None
    if name == "dp":
        axes = tuple(a for a in ("pod", "data") if a in axis_names)
        return axes if axes else None
    if name == "tp":
        return "model" if "model" in axis_names else None
    if name == "sp":
        return "data" if "data" in axis_names else None
    if name == "tpseq":   # Megatron-style sequence parallelism: the
        # residual stream's seq dim shards over the tensor axis between
        # layers; TP regions gather/scatter at entry/exit.
        return "model" if "model" in axis_names else None
    return name if name in axis_names else None


def _disabled(logical) -> bool:
    """``REPRO_DISABLE_CONSTRAINTS`` (comma list of logical names, or
    "all") turns selected constraints off, as in the reference."""
    disabled = os.environ.get("REPRO_DISABLE_CONSTRAINTS", "")
    if not disabled:
        return False
    names = set(disabled.split(","))
    return "all" in names or any(n in names for n in logical if n)


def constrain(x, *logical):
    """Place ``x`` by logical axis names under the ambient mesh (or
    return it unchanged)."""
    mesh = _ambient_mesh()
    if mesh is None or _disabled(logical):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = mesh.mesh_dim_names
    spec = sanitize(mesh, P(*(_resolve(n, names) for n in logical)),
                    x.shape)
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
