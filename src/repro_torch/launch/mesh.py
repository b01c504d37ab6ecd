"""Production mesh construction (the JAX package's ``launch/mesh.py``).

Meshes are ``torch.distributed`` ``DeviceMesh``es with the reference's
axis names, built with ``init_device_mesh`` over the default process
group:

  * a dry run (``launch.dryrun``) builds them over the fake process group
    (``FakeStore``): one process stands for rank 0 of a world of any
    size, and its collectives do nothing;
  * real ranks build them over the group the caller started (NCCL on
    the card, gloo on the CPU), whose world size must be the mesh's.

The mesh's device type is the device the run is for: ``cuda`` unless
the caller asks for the CPU (``device="cpu"``), and asking for ``cuda``
on a host without a card raises, fake group or not.  Kept as functions
(never module-level constants), so importing this module starts no
process group.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.regions import resolve_device
from ..models.sharding import mesh_context


def init_fake_world(world_size: int) -> None:
    """Start the fake process group of ``world_size`` ranks in this
    process, as its rank 0: kept if it runs at that size, restarted at
    another.  Raises if a real group is running.  ``destroy_fake_world``
    ends it."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} group is running; the dry run "
                f"needs a fake group of {world_size} ranks")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_fake_world() -> None:
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_mesh(shape, axes, *, device="cuda", fake: bool = False):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device``'s type.

    ``fake``: over the fake process group (``init_fake_world``);
    otherwise over the running group, whose world size must be
    ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = math.prod(shape)
    if fake:
        init_fake_world(n)
    elif not dist.is_initialized():
        raise RuntimeError("start a process group (NCCL or gloo) of "
                           f"{n} ranks before building a real mesh")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} devices needs a group of {n} "
                           f"ranks, not {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """16×16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         fake: bool = True):
    """The production mesh, over the fake group unless ``fake=False``."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device=device, fake=fake)


def make_local_mesh(model_axis: int = 1, device="cuda"):
    """(data, model) over this host's devices: the cards (one a rank of
    the running group), or one CPU rank."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into model axis "
                         f"{model_axis}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device=device)


@contextlib.contextmanager
def sharded(mesh):
    """Run model code on DTensors placed on ``mesh`` as GSPMD would:
    ``mesh_context`` (the models' ``constrain`` calls redistribute),
    constants made inside a call taken as replicated
    (``implicit_replication``), and the ops DTensor refuses repaired by a
    redistribution (``Reshard``, yielded: its ``ops`` count them)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_missing_strategies()
    reshard = Reshard()
    with implicit_replication(), mesh_context(mesh), reshard:
        yield reshard


def _register_missing_strategies() -> None:
    """Sharding strategies for the ops the models reach (through autograd)
    that some torch versions' DTensor lacks: ``aten.flip`` (``cumsum``'s
    backward), shardable on every dim it does not flip.  Registered only
    where DTensor has none."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.flip.default
    if op in prop.op_strategy_funcs or op in getattr(
            prop, "op_single_dim_strategy_funcs", {}):
        return

    @register_sharding(op)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
            if d not in flipped]


class Reshard(TorchDispatchMode):
    """Sees the DTensor-level ops.  An op whose sharding DTensor refuses,
    or a view that would leave a strided shard (a flatten of two dims
    sharded over two mesh dims, whose redistributions DTensor plans by a
    graph search that takes minutes on a 3-D mesh), is retried:

      * with its DTensor operands made contiguous (a view of a local
        shard that a redistribution left strided);
      * then, for each mesh dim from the minor one (``model``, then
        ``data``, then ``pod``), with every minor one replicated: first
        the operands replicated over it too (``model``, the innermost,
        has nothing inside it to move to), or for ``data`` and ``pod``
        first kept sharded over it but on another tensor dim, a dim for
        every operand sharded over it, the dims in order of the bytes
        they move (the operands' local bytes that change place; the
        first that DTensor accepts moves the fewest), and the result's
        shard then moved to its leading dim that the mesh dims sharding
        it divide (the batch dim that the reference's ``dp`` rule
        shards); only then replicated over it.

    An op that DTensor has no strategy for raises, as does one that no
    retry repairs.  ``ops`` counts the retries that ran, as
    "op@contiguous", "op@move:<mesh dim>" or "op@<replicated dims>"."""

    _ERRORS = (RuntimeError, ValueError, NotImplementedError,
               AssertionError)

    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten, tree_map
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            out = func(*args, **kwargs)
            if not _strided(out):
                return out
            err = f"{func}: a strided shard at every replication"
        except self._ERRORS as e:
            if not _sharding_refusal(e):
                raise
            # the message only: the exception's traceback holds this frame
            # (its tensors) in a cycle that only the collector breaks
            err = f"{type(e).__name__}: {e}"
        operands = [x for x in tree_flatten((args, kwargs))[0]
                    if isinstance(x, DTensor)]
        mesh = operands[0].device_mesh
        names = mesh.mesh_dim_names

        def contiguous(x):
            return x.contiguous() if isinstance(x, DTensor) else x
        tries = [("contiguous", contiguous, None)]
        for k in range(mesh.ndim - 1, -1, -1):
            if k < mesh.ndim - 1:
                tries += [(f"move:{names[k]}", _placed(k + 1, k, d), k)
                          for d in _move_dims(operands, k)]
            tries.append((",".join(names[k:]), _placed(k, None, None),
                          None))
        for how, fix, moved in tries:
            try:
                out = func(*tree_map(fix, args), **tree_map(fix, kwargs))
            except self._ERRORS as e:
                if not _sharding_refusal(e):
                    raise
                continue
            if _strided(out):
                continue
            if moved is not None:
                out = _to_leading_dim(out, moved)
            name = f"{func}@{how}"
            self.ops[name] = self.ops.get(name, 0) + 1
            return out
        raise RuntimeError(err)


def _placed(k: int, moved: int | None, dim: int | None):
    """An operand's redistribution for a retry: replicated over mesh dims
    ``k`` and on; and, given ``moved``, its shard over that mesh dim put
    on tensor dim ``dim``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def fix(x):
        if not isinstance(x, DTensor):
            return x
        want = [Replicate() if i >= k else p
                for i, p in enumerate(x.placements)]
        if moved is not None and isinstance(want[moved], Shard) \
                and dim < x.ndim:
            want[moved] = Shard(dim)
        return (x if want == list(x.placements)
                else x.redistribute(x.device_mesh, want))
    return fix


def _move_dims(operands, k: int) -> list[int]:
    """The tensor dims to which a retry may move mesh dim ``k``'s shards,
    cheapest first: each dim that moves a shard of some operand, by the
    local bytes of the operands whose shard it moves."""
    from torch.distributed.tensor import Shard
    sharded = [x for x in operands if isinstance(x.placements[k], Shard)]
    cost = {}
    for d in range(max((x.ndim for x in sharded), default=0)):
        moves = [x for x in sharded
                 if d < x.ndim and x.placements[k].dim != d]
        if moves:
            cost[d] = sum(x.to_local().numel() * x.element_size()
                          for x in moves)
    return sorted(cost, key=lambda d: (cost[d], d))


def _to_leading_dim(out, k: int):
    """``out`` with its shard over mesh dim ``k`` on its leading dim whose
    size the mesh dims sharding it, ``k`` included, divide (left where it
    is if there is none)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(out, DTensor) or not isinstance(out.placements[k],
                                                      Shard):
        return out
    mesh = out.device_mesh

    def ways(j):
        return mesh.size(k) * math.prod(
            mesh.size(i) for i, p in enumerate(out.placements)
            if i != k and isinstance(p, Shard) and p.dim == j)
    lead = next((j for j, size in enumerate(out.shape)
                 if size % ways(j) == 0), None)
    if lead is None or lead == out.placements[k].dim:
        return out
    want = list(out.placements)
    want[k] = Shard(lead)
    return out.redistribute(out.device_mesh, want)


def _strided(out) -> bool:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(out, DTensor) and any(
        isinstance(p, _StridedShard) for p in out.placements)


def _sharding_refusal(e: Exception) -> bool:
    msg = str(e)
    return any(s in msg for s in (
        "Sharding propagation failed", "unevenly sharded",
        "Cannot unflatten", "Cannot view"))
