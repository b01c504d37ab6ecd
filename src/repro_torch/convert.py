"""Carry DDM state between the JAX package and the port.

DDM has no weights: its state is the region sets (and the interval
trees built on them), and its result is a pair buffer.  These helpers
take the JAX package's region arrays and trees as numpy (what
``np.asarray`` gives for a ``repro`` region batch or ``ITree`` field)
into the port, and bring port state and results back to numpy, so one
seed's data can go through both packages and the outputs can be compared
bit for bit.

The LM stack's state is its parameters, its optimizer state and its
decode caches: ``lm_params_from_numpy`` carries the JAX package's
parameter tree (as numpy) into the port's model and
``lm_params_to_numpy`` takes it back, ``opt_state_from_numpy`` and
``opt_state_to_numpy`` do the same for AdamW's ``{m, v, step}``, and
``lm_cache_to_numpy`` restacks the port's cache in the reference's
layout, so both packages can run the same weights, compare their
caches, and read each other's checkpoints.

The port names a parameter by its dotted module path
(``mamba_groups.3.1.mixer.in_proj.w``); the reference's tree holds the
same tensor at the path of its words (``mamba_groups/mixer/in_proj/w``),
stacked along leading axes indexed by the name's integer parts (the L
axis of ``layers``, ``dense_layers``, ``moe_layers``, ``enc_layers`` and
``dec_layers``, the (groups, per) axes of ``mamba_groups``); a name with
no integer part (``embed.table``, the top-level ``enc_pos``) is the leaf
itself.
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


def _split_name(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def named_to_tree(named) -> dict:
    """The reference's tree from per-layer named leaves (numpy arrays or
    tensors), stacked along the names' integer parts.  Numpy leaves come
    back as new arrays (never views of the inputs); tensor leaves as
    tensors on their device (the ``meta`` device gives a template)."""
    groups: dict = {}
    for name, leaf in named.items():
        keys, idx = _split_name(name)
        groups.setdefault(keys, {})[idx] = leaf
    tree: dict = {}
    for keys, items in groups.items():
        first = next(iter(items.values()))
        dims = tuple(max(i[a] for i in items) + 1
                     for a in range(len(next(iter(items)))))
        if len(items) != int(np.prod(dims, dtype=np.int64)):
            raise ValueError(f"{'/'.join(keys)}: {len(items)} leaves do not "
                             f"fill the stacked axes {dims}")
        shape = dims + tuple(first.shape)
        if isinstance(first, torch.Tensor):
            leaf = torch.empty(shape, dtype=first.dtype, device=first.device)
        else:
            leaf = np.empty(shape, dtype=np.asarray(first).dtype)
        for i, a in items.items():
            leaf[i] = a
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _load_named(targets, tree: dict) -> None:
    """Copy ``tree``'s leaves into the named tensors ``targets`` in place;
    every leaf of the tree must land in exactly one target."""
    used = 0
    with torch.no_grad():
        for name, t in targets.items():
            keys, idx = _split_name(name)
            node = tree
            for key in keys:
                node = node[key]
            arr = np.asarray(node)[idx]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{name}: reference shape {arr.shape}, port "
                                 f"{tuple(t.shape)}")
            arr = np.ascontiguousarray(arr, np.float32)
            if not arr.flags.writeable:   # from_numpy warns on read-only input
                arr = arr.copy()
            t.copy_(torch.from_numpy(arr))
            used += arr.size
    total = sum(np.asarray(a).size for a in _leaves(tree))
    if used != total:
        raise ValueError(f"the port took {used} of the tree's {total} "
                         f"entries")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda"):
    """The port's model holding the reference's parameters.

    ``tree`` is the JAX package's ``init_params`` tree with numpy leaves
    (or the tree ``lm_params_to_numpy`` gives).  An (L, E, d, f) expert
    stack gives each layer its (E, d, f) tensor.
    """
    from .models.transformer import LM
    model = LM(cfg, generator=None, device=resolve_device(device))
    load_lm_params(model, tree)
    return model


def load_lm_params(model, tree: dict):
    """Copy the reference-layout parameter tree into ``model``, in place."""
    _load_named(dict(model.named_parameters()), tree)
    return model


def lm_params_to_numpy(cfg: ModelConfig, model) -> dict:
    """The reference's ``init_params`` tree (float32 numpy leaves, new
    arrays) of the port's model: the exact inverse of
    ``lm_params_from_numpy``."""
    if model.cfg != cfg:
        raise ValueError(f"the model is a {model.cfg.name}, not {cfg.name}")
    return named_to_tree({n: _host(p) for n, p in model.named_parameters()})


def opt_state_to_numpy(state: dict) -> dict:
    """AdamW's state ``{"m", "v", "step"}`` in the reference's layout:
    the moments as parameter trees, the step an int32 0-d array."""
    return {"m": named_to_tree({n: _host(t) for n, t in state["m"].items()}),
            "v": named_to_tree({n: _host(t) for n, t in state["v"].items()}),
            "step": np.asarray(state["step"].cpu(), dtype=np.int32)}


def opt_state_from_numpy(tree: dict, params) -> dict:
    """The port's AdamW state from the reference's ``{m, v, step}`` tree,
    keyed by the names of ``params`` (``dict(model.named_parameters())``)
    and on their device."""
    state = {k: {n: torch.empty(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
             for k in ("m", "v")}
    _load_named(state["m"], tree["m"])
    _load_named(state["v"], tree["v"])
    dev = next(iter(params.values())).device
    state["step"] = torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)
    return state


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
