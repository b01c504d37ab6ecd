"""Carry DDM state between the JAX package and the port.

DDM has no weights: its state is the region sets (and the interval
trees built on them), and its result is a pair buffer.  These helpers
take the JAX package's region arrays and trees as numpy (what
``np.asarray`` gives for a ``repro`` region batch or ``ITree`` field)
into the port, and bring port state and results back to numpy, so one
seed's data can go through both packages and the outputs can be compared
bit for bit.

The LM stack's state is its parameters and decode caches:
``lm_params_from_numpy`` carries the JAX package's parameter tree (as
numpy) into the port's model, and ``lm_cache_to_numpy`` restacks the
port's cache in the reference's layout, so both packages can run the
same weights and their caches can be compared.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

import torch

from .core.itm import ITree
from .core.pairs import PairsResult, to_numpy
from .core.regions import Regions, make_regions, resolve_device

if TYPE_CHECKING:              # the LM stack loads only where it is used
    from .models.config import ModelConfig


def regions_from_numpy(lo, hi, device="cuda") -> Regions:
    """Port regions from ``(N, d)`` (or ``(N,)``) float32 numpy arrays."""
    return make_regions(np.asarray(lo, np.float32),
                        np.asarray(hi, np.float32), device)


def regions_to_numpy(R: Regions) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)`` as host float32 ``(N, d)`` arrays."""
    return to_numpy(R.lo), to_numpy(R.hi)


def pairs_to_numpy(result) -> np.ndarray:
    """Host int32 ``(cap, 2)`` buffer of a ``PairsResult`` or tensor."""
    if isinstance(result, PairsResult):
        return np.asarray(result)
    return to_numpy(result)


def itree_from_numpy(lo, hi, minlower, maxupper, ids,
                     device="cuda") -> ITree:
    """Port ``ITree`` from the five arrays of an interval tree (the JAX
    package's ``ITree`` fields as numpy, in that order): float32 bounds
    and int32 ids, each of length 2^h."""
    dev = resolve_device(device)
    f32 = [torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
           for a in (lo, hi, minlower, maxupper)]
    return ITree(*f32, torch.from_numpy(np.array(ids, dtype=np.int32))
                 .to(dev))


def itree_to_numpy(tree: ITree) -> tuple[np.ndarray, ...]:
    """The five arrays of a port ``ITree`` as host numpy, field order."""
    return tuple(to_numpy(t) for t in tree)


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda"):
    """The port's model holding the reference's parameters.

    ``tree`` is the JAX package's ``init_params`` tree with numpy leaves.
    Each port parameter is found by name: its dotted name's words walk
    the tree and its integer parts index the stacked leading axes (the L
    axis of ``layers``, ``dense_layers``, ``moe_layers``, ``enc_layers``
    and ``dec_layers``, the (groups, per) axes of ``mamba_groups``);
    what is left is the leaf itself, so an (L, E, d, f) expert stack
    gives each layer its (E, d, f) tensor and the top-level ``enc_pos``
    is taken whole.  Every leaf of the tree must land in exactly one
    parameter.
    """
    from .models.transformer import LM
    model = LM(cfg, generator=None, device=resolve_device(device))
    used = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = name.split(".")
            node = tree
            for key in (p for p in parts if not p.isdigit()):
                node = node[key]
            arr = np.asarray(node, dtype=np.float32)[
                tuple(int(p) for p in parts if p.isdigit())]
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, port "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr)))
            used += arr.size
    total = sum(np.asarray(a).size for a in _leaves(tree))
    if used != total:
        raise ValueError(f"the port's model took {used} of the tree's "
                         f"{total} parameters")
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def lm_cache_to_numpy(cfg: ModelConfig, cache: dict) -> dict:
    """The port's decode cache in the reference's layout: per-layer lists
    stacked along leading axes, host float32 arrays (bfloat16 widens
    exactly)."""
    want = {"hybrid": {"mamba_groups", "attn"},
            "moe": {"moe_layers"} | ({"dense_layers"}
                                     if cfg.first_dense_layers else set()),
            "audio": {"dec_layers", "enc_out"}}.get(cfg.family, {"layers"})
    if set(cache) != want:
        raise ValueError(f"a {cfg.family} cache has keys {sorted(want)}, "
                         f"got {sorted(cache)}")

    def restack(node):
        if isinstance(node, list):
            items = [restack(n) for n in node]
            return {k: np.stack([it[k] for it in items]) for k in items[0]}
        if isinstance(node, dict):
            return {k: restack(v) for k, v in node.items()}
        return node.detach().float().cpu().numpy()
    return restack(cache)
