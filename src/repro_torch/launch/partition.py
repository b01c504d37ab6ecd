"""Sharding rules: param/optimizer/batch/cache partition specs.

The port of the JAX package's ``launch/partition.py``, for the
production mesh:

  batch        → ('pod','data')  (DP across pods + in-pod data axis)
  d_model dim  → 'data'          (FSDP / ZeRO-3)
  heads / d_ff / vocab / experts → 'model'  (TP / EP)
  KV-cache sequence (long_500k, batch=1) → 'data'  (SP)

Specs are data (``P``: one entry per dimension, None, an axis name or a
tuple of names).  Parameter rules are matched, in the reference's order,
on the path tokens of the reference's tree: a port parameter name such
as ``layers.3.attn.wq.w`` has the tokens ``(layers, attn, wq, w)`` and
the reference's tree holds it stacked along one leading axis per integer
part (``convert.named_to_tree``).  The first rule whose suffix matches
wins and a rule longer than the stacked tensor is skipped; the spec of
the port's per-layer tensor is the reference's with its leading stacked
Nones dropped.  Optimizer state mirrors the parameter specs.  ``named``
turns specs into DTensor placements, and ``distribute_params`` /
``distribute_tree`` place a model's parameters or a tree of tensors.
"""
from __future__ import annotations

from ..convert import _split_name
from ..models.sharding import P, axis_sizes, placements, sanitize

__all__ = ["P", "batch_dims", "batch_specs", "cache_specs", "distribute",
           "distribute_params", "distribute_tree", "named", "opt_specs",
           "param_specs", "sanitize", "sanitize_tree", "spec_for_param"]


def _rule_table():
    """(path-suffix tokens, spec for trailing dims).  DP = FSDP axis
    ('data'); MP = tensor axis ('model')."""
    MP, DP = "model", "data"
    return [
        # embeddings / unembeddings
        (("embed", "table"), (MP, DP)),
        (("lm_head", "w"), (DP, MP)),
        (("enc_pos",), (None, DP)),
        # attention projections (d, heads*dh) / (heads*dh, d)
        (("attn", "wq", "w"), (DP, MP)),
        (("attn", "wk", "w"), (DP, MP)),
        (("attn", "wv", "w"), (DP, MP)),
        (("attn", "wo", "w"), (MP, DP)),
        (("xattn", "wq", "w"), (DP, MP)),
        (("xattn", "wk", "w"), (DP, MP)),
        (("xattn", "wv", "w"), (DP, MP)),
        (("xattn", "wo", "w"), (MP, DP)),
        (("wq", "b"), (MP,)),
        (("wk", "b"), (MP,)),
        (("wv", "b"), (MP,)),
        # MLA
        (("w_dkv", "w"), (DP, None)),
        (("w_ukv", "w"), (None, MP)),
        (("w_dq", "w"), (DP, None)),
        (("w_uq", "w"), (None, MP)),
        (("attn", "wq", "w"), (DP, MP)),
        # dense mlp
        (("w_gate", "w"), (DP, MP)),
        (("w_up", "w"), (DP, MP)),
        (("w_down", "w"), (MP, DP)),
        # moe experts (E, d, f) / (E, f, d); router small -> replicated
        (("moe", "w_gate"), (MP, DP, None)),
        (("moe", "w_up"), (MP, DP, None)),
        (("moe", "w_down"), (MP, None, DP)),
        (("router", "w"), (DP, None)),
        # mamba2
        (("in_proj", "w"), (DP, MP)),
        (("out_proj", "w"), (MP, DP)),
        (("conv_w",), (None, MP)),
        (("conv_b",), (MP,)),
        (("mixer", "norm", "scale"), (MP,)),
    ]


def spec_for_param(name: str, shape) -> P:
    """The spec of the port's parameter ``name`` of ``shape``."""
    toks, idx = _split_name(name)
    stacked = len(idx) + len(shape)
    for suffix, dims in _rule_table():
        if toks[-len(suffix):] == tuple(suffix):
            pad = stacked - len(dims)
            if pad < 0:
                continue
            full = (None,) * pad + tuple(dims)
            assert all(d is None for d in full[:len(idx)]), (name, full)
            return P(*full[len(idx):])
    return P()  # replicate (norm scales, small vectors, A_log, ...)


def param_specs(params) -> dict:
    """{name: spec} of a model (``named_parameters``) or a name→tensor
    dict."""
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else params)
    return {n: spec_for_param(n, t.shape) for n, t in named.items()}


def opt_specs(opt_state, pspecs) -> dict:
    return {"m": pspecs, "v": pspecs, "step": P()}


def batch_dims(mesh) -> tuple:
    """Data-parallel mesh axes for the batch dim."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` holds
    the dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def batch_specs(mesh, batch_example: dict, *, shard_batch=True) -> dict:
    dp = batch_dims(mesh) if shard_batch else ()

    def one(path, leaf):
        if getattr(leaf, "ndim", 0) == 0:
            return P()
        lead = dp if (dp and leaf.shape[0] > 1) else None
        return P(lead, *((None,) * (leaf.ndim - 1)))

    return _map(one, batch_example)


def cache_specs(mesh, cache_example, *, batch: int, seq_shard: bool):
    """KV/SSM cache specs of the port's per-layer cache tree.

    Normal decode/prefill: batch over ('pod','data'); KV heads over
    'model' when divisible, otherwise the cache *sequence* shards over
    'model' (the serving-stack convention for kv_heads < tp).
    long_500k (batch=1): sequence over 'data' (SP), heads over 'model'.
    """
    dp = batch_dims(mesh)
    msz = axis_sizes(mesh).get("model", 1)

    def one(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        name = keys[-1] if keys else ""
        if name in ("k", "v"):          # (B, Smax, H, dh)
            if seq_shard:
                return P(None, "data", "model", None)
            if leaf.shape[-2] % msz == 0:
                return P(dp, None, "model", None)
            return P(dp, "model", None, None)   # seq over tp
        if name in ("ckv", "krope"):    # (B, Smax, feat)
            tp_feat = "model" if leaf.shape[-1] % msz == 0 else None
            if seq_shard:
                return P(None, "data", tp_feat)
            if tp_feat:
                return P(dp, None, tp_feat)
            return P(dp, "model", None)
        if name == "ssm":               # (B, nh, hd, ns)
            tp_h = "model" if leaf.shape[-3] % msz == 0 else None
            return P(None if seq_shard else dp, tp_h, None, None)
        if name == "conv":              # (B, W-1, C)
            tp_c = "model" if leaf.shape[-1] % msz == 0 else None
            return P(None if seq_shard else dp, None, tp_c)
        if name == "enc_out":           # (B, F, d)
            tp_d = "model" if leaf.shape[-1] % msz == 0 else None
            return P(None if seq_shard else dp, None, tp_d)
        return P()

    return _map(one, cache_example)


def _zip_map(fn, specs, structs):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, v, structs[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_zip_map(fn, s, x) for s, x in zip(specs, structs)]
    return fn(specs, structs)


def sanitize_tree(mesh, spec_tree, struct_tree):
    """``sanitize`` of every spec against its tensor's shape."""
    return _zip_map(lambda s, x: sanitize(mesh, s, x.shape), spec_tree,
                    struct_tree)


def named(mesh, spec_tree):
    """The tree of DTensor placements (tuples, one entry per mesh dim) of
    a tree of specs on a ``DeviceMesh``."""
    return _map(lambda _, s: placements(mesh, s), spec_tree)


def distribute(t, spec, mesh):
    """``t`` as a DTensor placed by ``spec`` on ``mesh``; every rank keeps
    its own chunk of its own ``t`` (no communication: the ranks must hold
    the same tensor, or it is fake)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def distribute_tree(tree, specs, mesh):
    """A tree of dicts and lists of tensors placed leaf by leaf."""
    return _zip_map(lambda s, t: distribute(t, s, mesh), specs, tree)


def distribute_params(model, mesh) -> dict:
    """Replace every parameter of ``model`` by a DTensor placed by its
    sanitized spec, in place; returns {name: spec}."""
    from torch import nn
    named = dict(model.named_parameters())
    specs = sanitize_tree(mesh, param_specs(named), named)
    for name, p in named.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad)
    return specs
