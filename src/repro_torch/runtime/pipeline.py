"""GPipe-style pipeline parallelism (the JAX package's
``runtime/pipeline.py``).

The layer stack is split into ``n_stages`` contiguous stage groups, one
a rank of the pipeline group.  Microbatches stream through on a clock:
at tick t stage s applies its L/S layers to microbatch t − s and sends
the activations to stage s + 1 (point-to-point ``isend``/``irecv``), so
M microbatches take M + S − 1 ticks (the classic bubble schedule, bubble
fraction (S−1)/(M+S−1)).  The reference's stages compute on zeros in
their bubble ticks and drop the result; here a stage with no microbatch
at a tick does nothing.  At the end the last stage's outputs go to every
rank by an ``all_reduce(SUM)`` of the buffer that only the last stage
filled (the reference's masked ``psum``: the other ranks add zeros, so
the bits are the last stage's).

This is the forward pipeline used to validate the schedule and its
communication against the single-device stack (bit for bit in float32);
it runs over any ``torch.distributed`` group (NCCL on cards, gloo on the
CPU).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

AXIS = "stage"


def _stage_group(group, mesh):
    if mesh is not None:
        if group is not None:
            raise ValueError("pass a group or a mesh, not both")
        if mesh.ndim != 1:
            raise ValueError(f"the pipeline mesh is 1-D ({AXIS!r}), not "
                             f"{mesh.ndim}-D")
        return mesh.get_group()
    return group if group is not None else dist.group.WORLD


def pipeline_forward(stacked_params, x, layer_apply, *, group=None,
                     mesh=None, n_microbatches: int):
    """Run x through L stacked layers split across the pipeline group.

    stacked_params: dict of tensors with a leading layer axis L
      (L % n_stages == 0); every rank passes the whole stack and uses its
      stage's L/S layers.
    x: (B, ...) activations, B % n_microbatches == 0 (stage 0's are
      used; every rank passes a tensor of the same shape and dtype).
    layer_apply(p_layer, x_mb) -> x_mb, shape and dtype kept.
    group / mesh: the pipeline's process group (default: the world) or a
      1-D ``DeviceMesh``; the stages are its ranks in order.
    Returns the (B, ...) output on every rank.
    """
    group = _stage_group(group, mesh)
    n_stages = dist.get_world_size(group)
    me = dist.get_rank(group)
    L = next(iter(stacked_params.values())).shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} "
                         "microbatches")
    M = n_microbatches
    per = L // n_stages
    mine = {k: v[me * per:(me + 1) * per] for k, v in stacked_params.items()}
    xmb = x.reshape((M, B // M) + x.shape[1:])

    def apply_stage(h):
        for i in range(per):
            h = layer_apply({k: v[i] for k, v in mine.items()}, h)
        return h

    def peer(s):
        return dist.get_global_rank(group, s) if group is not \
            dist.group.WORLD else s

    outs = torch.zeros_like(xmb)
    buf = torch.empty_like(xmb[0])
    for t in range(M + n_stages - 1):
        m = t - me                      # this stage's microbatch
        if 0 <= m < M:
            if me > 0:                  # sent by stage me − 1 at tick t − 1
                dist.recv(buf, src=peer(me - 1), group=group)
            y = apply_stage(xmb[m] if me == 0 else buf)
            if me < n_stages - 1:
                dist.send(y.contiguous(), dst=peer(me + 1), group=group)
            else:
                outs[m] = y
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs.reshape((B,) + x.shape[1:])
