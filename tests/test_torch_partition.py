"""The port's partition rules, mesh placements and sharding constraints
(``repro_torch.launch.partition``, ``launch.mesh``, ``models.sharding``)
against the JAX package's.

* Specs: for all ten full configs, every parameter, optimizer, batch and
  cache spec at both production meshes' sizes (a ``SimpleNamespace``
  mesh, as ``tests/test_configs_and_partition.py`` fakes one), after
  ``sanitize``, equals the reference's with the leading Nones of its
  stacked layer axes dropped.  The reference's own two partition cases
  run against the port.
* Placements: ``named`` of hand-picked specs, and every smoke config's
  parameters distributed on a 16-rank fake (4, 4) mesh, whose local
  shapes are the spec's (the fake group is started and destroyed by a
  fixture: a process has one default group).
* ``_resolve`` for every logical name and axis set, ``constrain`` as the
  identity without a mesh and with constraints disabled.
* Call sites: a forward of each smoke config makes the same list of
  ``constrain`` calls, (shape, logical axes) in order, in both packages.
  The reference is traced (``make_jaxpr``) with ``unroll_layers`` (its cost-probe mode: the
  layer scans unrolled, one call a layer, as the port's loops make
  them) and its ``constrain`` patched where each of its modules
  imported it; the port's MoE runs in its dense form (the reference's
  dispatch).  S is one 128-row query chunk: the reference's chunk scan
  traces its body once whatever the number of chunks, the port's loop
  calls once a chunk.  ``jax.checkpoint`` is the identity for the
  reference's forward (remat changes what is stored, not what is
  computed): JAX traces a rematted function once for all calls with the
  same shapes, so the MoE's k slots would show one slot's calls.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import partition as rpt  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import sharding as rsh  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import _split_name  # noqa: E402
from repro_torch.launch import partition as pt  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (destroy_fake_world, make_mesh,  # noqa
                                     mesh_context, production_shape)
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import sharding as psh  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402


def fake_mesh(multi: bool):
    shape, axes = production_shape(multi)
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _check(port_spec, ref_spec, n_lead: int, where: str):
    ref = tuple(ref_spec)
    assert all(d is None for d in ref[:n_lead]), (where, ref)
    assert tuple(port_spec) == ref[n_lead:], (where, port_spec, ref)


def _ref_flat(tree):
    return {tuple(str(getattr(e, "key", e)) for e in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _compare_tree(port_specs, ref_specs, where):
    """Every port leaf (a path of keys and list indices) against the
    reference leaf at its keys, less one lead entry per index."""
    ref = _ref_flat(ref_specs)
    seen = set()
    for path, spec in _port_leaves(port_specs):
        keys = tuple(k for k in path if isinstance(k, str))
        n_idx = sum(isinstance(k, int) for k in path)
        _check(spec, ref[keys], n_idx, f"{where}:{path}")
        seen.add(keys)
    assert seen == set(ref), (where, set(ref) ^ seen)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, multi):
    mesh = fake_mesh(multi)
    rcfg, cfg = ref_config(arch), get_config(arch)
    # parameters and optimizer state
    rstruct = rsteps.abstract_params(rcfg)
    rspecs = rpt.sanitize_tree(mesh, rpt.param_specs(rstruct), rstruct)
    model = steps.abstract_params(cfg)
    named = dict(model.named_parameters())
    pspecs = pt.sanitize_tree(mesh, pt.param_specs(model), named)
    assert len(pspecs) == len(named)
    for name, spec in pspecs.items():
        keys, idx = _split_name(name)
        _check(spec, _ref_leaf(rspecs, keys), len(idx), name)
    ropt = rpt.opt_specs(None, rspecs)
    popt = pt.opt_specs(None, pspecs)
    assert tuple(popt["step"]) == tuple(ropt["step"]) == ()
    for k in ("m", "v"):
        for name, spec in popt[k].items():
            keys, idx = _split_name(name)
            _check(spec, _ref_leaf(ropt[k], keys), len(idx), f"{k}:{name}")
    # batches and caches of every shape
    for sname, spec in SHAPES.items():
        rb = rsteps.input_structs(rcfg, spec)
        pb = steps.input_structs(cfg, spec)
        _compare_tree(
            pt.sanitize_tree(mesh, pt.batch_specs(mesh, pb), pb),
            rpt.sanitize_tree(mesh, rpt.batch_specs(mesh, rb), rb),
            f"batch:{sname}")
        if spec.kind == "train":
            continue
        seq = spec.global_batch == 1
        rc = rsteps.abstract_cache(rcfg, spec)
        pc = steps.abstract_cache(cfg, spec)
        _compare_tree(
            pt.sanitize_tree(mesh, pt.cache_specs(
                mesh, pc, batch=spec.global_batch, seq_shard=seq), pc),
            rpt.sanitize_tree(mesh, rpt.cache_specs(
                mesh, rc, batch=spec.global_batch, seq_shard=seq), rc),
            f"cache:{sname}")


def test_sanitize_drops_nondivisible_axes():
    # the reference's case (tests/test_configs_and_partition.py:70)
    m = types.SimpleNamespace(axis_names=("data", "model"),
                              devices=np.empty((16, 16)))
    spec = pt.sanitize(m, pt.P("data", "model"), (32, 30))
    assert spec == pt.P("data", None)          # 30 % 16 != 0
    spec = pt.sanitize(m, pt.P(("data", "model"),), (256,))
    assert spec == pt.P(("data", "model"))
    spec = pt.sanitize(m, pt.P(("data", "model"),), (100,))
    assert spec == pt.P(None)
    assert tuple(spec) == tuple(rpt.sanitize(m, JP(("data", "model"),),
                                             (100,)))


def test_param_specs_rules():
    # the reference's case (tests/test_configs_and_partition.py:85), on
    # the port's per-layer names (the stacked None dropped)
    cfg = get_smoke_config("llama3_2_3b")
    specs = pt.param_specs(steps.abstract_params(cfg))
    assert specs["embed.table"] == pt.P("model", "data")
    assert specs["layers.0.attn.wq.w"] == pt.P("data", "model")
    assert specs["layers.1.attn.wo.w"] == pt.P("model", "data")
    assert specs["layers.0.mlp.w_down.w"] == pt.P("model", "data")
    assert specs["lm_head.w"] == pt.P("data", "model")
    # norm scales replicate
    assert specs["layers.0.ln1.scale"] == pt.P()


LOGICAL = (None, "dp", "tp", "sp", "tpseq", "data", "model", "pod",
           "other")
AXIS_SETS = ((), ("data",), ("model",), ("data", "model"),
             ("pod", "data", "model"), ("pod", "model"), ("stage",))


@pytest.mark.parametrize("axes", AXIS_SETS, ids=lambda a: "-".join(a) or "none")
def test_resolve_equals_reference(axes):
    for name in LOGICAL:
        assert psh._resolve(name, axes) == rsh._resolve(name, axes), name


def test_constrain_is_the_identity_without_a_mesh(monkeypatch):
    x = torch.randn(4, 6, 8)
    assert psh.constrain(x, "dp", None, "tp") is x
    monkeypatch.setenv("REPRO_DISABLE_CONSTRAINTS", "all")
    assert psh.constrain(x, "dp", None, "tp") is x
    assert psh._disabled(("dp",))
    monkeypatch.setenv("REPRO_DISABLE_CONSTRAINTS", "tp,sp")
    assert psh._disabled(("dp", None, "tp"))
    assert not psh._disabled(("dp", None, None))


@pytest.fixture
def fake16():
    """A fake process group of 16 ranks, destroyed after the test."""
    destroy_fake_world()
    try:
        yield
    finally:
        destroy_fake_world()


def test_named_placements(fake16):
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), device="cpu",
                     fake=True)
    assert pt.named(mesh, {"a": pt.P(("pod", "data"), None, "model")}) == {
        "a": (Shard(0), Shard(0), Shard(2))}
    assert pt.named(mesh, [pt.P(), pt.P(None, "data")]) == [
        (Replicate(),) * 3, (Replicate(), Shard(1), Replicate())]
    with pytest.raises(ValueError, match="mesh's order"):
        pt.named(mesh, pt.P(("data", "pod")))


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_local_shapes_are_the_specs(arch, fake16):
    from torch.distributed.tensor import distribute_tensor
    mesh = make_mesh((4, 4), ("data", "model"), device="cpu", fake=True)
    sizes = {"data": 4, "model": 4}
    cfg = get_smoke_config(arch)
    model = PT.init_params(cfg, None, "cpu")
    named = dict(model.named_parameters())
    specs = pt.sanitize_tree(mesh, pt.param_specs(model), named)
    places = pt.named(mesh, specs)
    sharded = 0
    for name, p in named.items():
        d = distribute_tensor(p.detach(), mesh, places[name],
                              src_data_rank=None)
        want = []
        for n, ax in zip(p.shape, specs[name]):
            div = 1
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                div *= sizes[a]
            want.append(n // div)
        assert tuple(d.to_local().shape) == tuple(want), name
        sharded += tuple(want) != tuple(p.shape)
    assert sharded > 0


def _record_ref(monkeypatch, calls):
    from repro.models import attention, mlp, moe, ssm, transformer

    def rec(x, *logical):
        calls.append((tuple(x.shape), logical))
        return x
    for mod in (attention, mlp, moe, ssm, transformer):
        monkeypatch.setattr(mod, "constrain", rec)


def _record_port(monkeypatch, calls):
    from repro_torch.models import attention, mlp, moe, ssm, transformer

    def rec(x, *logical):
        calls.append((tuple(x.shape), logical))
        return x
    for mod in (attention, mlp, moe, ssm, transformer):
        monkeypatch.setattr(mod, "constrain", rec)


@pytest.mark.parametrize("arch", ARCHS)
def test_constrain_call_sites_match_the_reference(arch, monkeypatch):
    from repro.models import transformer as RT
    B, S = 2, 128
    rcfg = dataclasses.replace(ref_smoke(arch), unroll_layers=True)
    cfg = get_smoke_config(arch)
    assert cfg.q_chunk == S
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.enc_frames, cfg.d_model))
              .astype(np.float32) if cfg.family == "audio" else None)
    ref_calls, port_calls = [], []
    _record_ref(monkeypatch, ref_calls)
    _record_port(monkeypatch, port_calls)
    monkeypatch.setattr(jax, "checkpoint", lambda f, **kw: f)
    jax.make_jaxpr(lambda p, t, f: RT.forward(p, t, rcfg, frames=f))(
        rsteps.abstract_params(rcfg), jnp.asarray(tokens),
        None if frames is None else jnp.asarray(frames))
    model = PT.init_params(cfg, None, "cpu")
    with torch.no_grad(), PM.use_form("dense"):
        PT.forward(model, torch.from_numpy(tokens), cfg,
                   frames=None if frames is None
                   else torch.from_numpy(frames))
    assert len(ref_calls) > 4
    assert port_calls == ref_calls


def test_mesh_context_installs_the_ambient_mesh():
    sentinel = types.SimpleNamespace(mesh_dim_names=("data",))
    assert psh._ambient_mesh() is None
    with mesh_context(sentinel):
        assert psh._ambient_mesh() is sentinel
    assert psh._ambient_mesh() is None
