"""The port's dry run (``repro_torch.launch.dryrun``) and
``launch.probe_buffers``.

* The reference's smoke criterion, on the port's CLI as a subprocess
  with ``--device cpu``: ``mamba2-780m`` at ``long_500k`` on both smoke
  meshes, ``status`` ok, a ``dominant`` term, ``peak_estimate > 0`` and
  16 devices on the multi mesh.
* The counts of hand-built sharded products on a 16-rank fake (4, 4)
  mesh equal their closed forms: one device's FLOPs and bytes of a
  product on its local shards, its parameter memory, and the link bytes
  of the all-reduce that a partial product needs (the reference's
  formula, the group the mesh dim's 4).
* ``argument_bytes`` of the ``mamba2-780m`` ``train_4k`` smoke cell
  equals the reference's ``memory.argument_bytes`` (one reference
  ``_compile_cell`` at the smoke mesh in a JAX subprocess with 16 host
  devices, about 12 s, started with the module), and for all ten smoke
  configs it equals the closed-form sum over the reference's sanitized
  specs (parameters, AdamW moments and step, batch).
* ``probe_buffers``' largest tensor of the ``mamba2-780m`` ``long_500k``
  smoke cell is in_proj's local weight in bf16, (d/4) × (proj/4) × 2
  bytes.
* ``launch.mesh.sharded`` repairs the training step's microbatch split
  (a batch sharded over ``data`` unflattened into k microbatches, fewer
  than the ``data`` axis) by moving the shard, not by replicating it:
  on the 16-rank fake mesh the split's microbatch keeps its batch rows
  sharded over ``data``; on four spawned gloo ranks, a (2, 2) mesh
  (``tests/torch_reshard_cases.py``, about 8 s), each rank's local shard
  is its slice of the unsharded view's result, and the gathered result
  is that result.

In-process tests start the fake process group of 16 ranks in a fixture
and destroy it after (a process has one default group).
"""
import json
import math
import multiprocessing
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import partition as rpt  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import probe_buffers  # noqa: E402
from repro_torch.launch.mesh import destroy_fake_world, make_mesh  # noqa

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
REF_ARGS = """
import json
from repro.launch import dryrun as D
from repro.configs import get_smoke_config, SHAPES
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((4, 4), ("data", "model"))
c = D._compile_cell(get_smoke_config("mamba2_780m"), SHAPES["train_4k"],
                    mesh)
print(json.dumps(c.memory_analysis().argument_size_in_bytes))
"""


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **kw)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def ref_argument_bytes():
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_ARGS], text=True,
        env=_env(REPRO_DRYRUN_DEVICES="16", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def fake16():
    destroy_fake_world()
    try:
        yield make_mesh((4, 4), ("data", "model"), device="cpu", fake=True)
    finally:
        destroy_fake_world()


def test_smoke_cells_meet_the_reference_criterion(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "mamba2-780m", "--shape", "long_500k", "--mesh", "both",
         "--device", "cpu", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    for mesh in ("single", "multi"):
        rec = json.loads(
            (tmp_path / f"mamba2_780m_long_500k_{mesh}.json").read_text())
        assert rec["status"] == "ok", rec
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        assert rec["memory"]["peak_estimate"] > 0
        assert rec["n_devices"] == 16 and rec["device"] == "cpu"
        assert rec["cur_len"] == SHAPES["long_500k"].seq_len - 1
        assert rec["cost"]["flops_per_device"] > 0
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes",
                                      "peak_estimate"}
        if mesh == "multi":
            assert rec["mesh_shape"] == [2, 2, 4]


def test_sharded_products_have_closed_form_counts(fake16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake16
    M, K, N = 64, 128, 256
    with FakeTensorMode():
        def dt(shape, places):
            return distribute_tensor(torch.empty(shape), mesh, places,
                                     src_data_rank=None)
        # batch rows over data, the weight's columns over model: no
        # collective, one device multiplies (M/4, K) by (K, N/4)
        x = dt((M, K), [Shard(0), Replicate()])
        w = dt((K, N), [Replicate(), Shard(1)])
        tr = D.Tracker()
        assert tr.add_arguments([w]) == K * (N // 4) * 4
        with D.counting(mesh, tr):
            y = x @ w
        assert tuple(y.to_local().shape) == (M // 4, N // 4)
        assert tr.flops == 2 * (M // 4) * K * (N // 4)
        assert tr.bytes == 4 * ((M // 4) * K + K * (N // 4)
                                + (M // 4) * (N // 4))
        assert tr.colls == []
        # the contraction over model: a partial product, all-reduced
        x2 = dt((M, K), [Replicate(), Shard(1)])
        w2 = dt((K, N), [Replicate(), Shard(0)])
        tr2 = D.Tracker()
        with D.counting(mesh, tr2):
            y2 = (x2 @ w2).redistribute(mesh, [Replicate(), Replicate()])
        assert tuple(y2.to_local().shape) == (M, N)
        assert tr2.flops == 2 * M * (K // 4) * N
        (coll,) = tr2.colls
        rb = M * N * 4
        assert coll == {"op": "all-reduce", "result_bytes": rb, "group": 4,
                        "link_bytes": 2 * rb * 3 / 4}


def _closed_form_argument_bytes(arch: str) -> int:
    """Sum over the reference's sanitized train specs at the smoke mesh of
    each leaf's bytes over its axes' sizes."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((4, 4)))
    sizes = {"data": 4, "model": 4}
    cfg, spec = ref_smoke(arch), SHAPES["train_4k"]
    pstruct = rsteps.abstract_params(cfg)
    pspecs = rpt.sanitize_tree(mesh, rpt.param_specs(pstruct), pstruct)
    ostruct = rsteps.abstract_opt(cfg)
    ospecs = rpt.opt_specs(ostruct, pspecs)
    bstruct = rsteps.input_structs(cfg, spec)
    bspecs = rpt.sanitize_tree(mesh, rpt.batch_specs(mesh, bstruct),
                               bstruct)
    total = 0
    for structs, specs in ((pstruct, pspecs), (ostruct, ospecs),
                           (bstruct, bspecs)):
        leaves = jax.tree.leaves(structs)
        specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(specs)
        for leaf, s in zip(leaves, specs):
            div = math.prod(sizes[a] for d in s if d is not None
                            for a in (d if isinstance(d, tuple) else (d,)))
            total += leaf.size * leaf.dtype.itemsize // div
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_train_argument_bytes_equal_the_closed_form(arch, fake16):
    got = D.cell_argument_bytes(get_smoke_config(arch), SHAPES["train_4k"],
                                fake16, CPU)
    assert got == _closed_form_argument_bytes(arch)


def test_train_argument_bytes_equal_the_reference(ref_argument_bytes,
                                                  fake16):
    got = D.cell_argument_bytes(get_smoke_config("mamba2_780m"),
                                SHAPES["train_4k"], fake16, CPU)
    assert got == ref_argument_bytes == _closed_form_argument_bytes(
        "mamba2_780m")


def test_probe_buffers_largest_tensor(fake16, capsys):
    rec = probe_buffers.main(["--arch", "mamba2-780m", "--shape",
                              "long_500k", "--smoke", "--device", "cpu"])
    cfg = get_smoke_config("mamba2_780m")
    proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads
    (key, n), = probe_buffers.largest(rec, 1)
    assert key == f"bfloat16[{cfg.d_model // 4}, {proj // 4}]"
    assert n == cfg.d_model // 4 * (proj // 4) * 2
    out = capsys.readouterr().out
    assert out.startswith("peak ~ ") and key in out


def test_layer_units_and_model_flops():
    cfg = get_smoke_config("zamba2_2_7b")
    one, units = D.layer_units(cfg)
    assert one.n_layers == cfg.attn_every
    assert units == cfg.n_layers // cfg.attn_every
    moe = get_smoke_config("deepseek_v2_236b")
    spec = SHAPES["train_4k"]
    dead = ((moe.n_experts - moe.top_k) * 3 * moe.d_model * moe.moe_d_ff
            * (moe.n_layers - moe.first_dense_layers))
    assert D.model_flops(moe, spec, 16) == (
        6 * (moe.n_params() - dead) * spec.global_batch * spec.seq_len / 16)
    assert D.link_bytes("reduce-scatter", 100, 4) == 300
    assert D.link_bytes("collective-permute", 100, 4) == 100


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        D.main(["--smoke", "--arch", "mamba2-780m", "--shape", "long_500k",
                "--out", str(tmp_path)])


def test_sharded_repairs_the_ops_dtensor_refuses(fake16):
    # launch.mesh.sharded: a reshape that unflattens a dim sharded 4 ways
    # into 2 heads is retried with the model axis replicated (GSPMD's
    # repair); a flip (cumsum's backward) keeps the shard of a dim it
    # does not flip, with no repair; the results are the plain ops' shapes
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import sharded
    mesh = fake16
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 6, 2 * 12), mesh,
                              [Replicate(), Shard(2)], src_data_rank=None)
        with sharded(mesh) as rs:
            y = x.reshape(8, 6, 2, 12)
        assert tuple(y.shape) == (8, 6, 2, 12)
        assert rs.ops == {"aten.view.default@model": 1}
        with rs:
            z = torch.flip(x, [0])
        assert tuple(z.placements) == (Replicate(), Shard(2))
        assert tuple(z.to_local().shape) == (8, 6, 6)
        assert rs.ops == {"aten.view.default@model": 1}


def test_sharded_raises_on_an_op_with_no_strategy(fake16):
    # an op that DTensor has no sharding strategy for is not run some
    # other way: it raises, and the dry run records the cell as an error
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import Reshard
    prop = DTensor._op_dispatcher.sharding_propagator
    flip = torch.ops.aten.flip.default
    tables = [prop.op_strategy_funcs,
              getattr(prop, "op_single_dim_strategy_funcs", {})]
    saved = [t.pop(flip, None) for t in tables]
    prop.propagate_op_sharding.cache_clear()
    try:
        with FakeTensorMode():
            # a shape and dims of its own: DTensor caches the sharding of
            # an op on inputs it has seen
            x = distribute_tensor(torch.empty(4, 10, 8), fake16,
                                  [Shard(0), Shard(2)], src_data_rank=None)
            rs = Reshard()
            with pytest.raises((NotImplementedError, RuntimeError),
                               match="sharding strategy"), rs:
                torch.flip(x, [1])
        assert rs.ops == {}
    finally:
        for t, f in zip(tables, saved):
            if f is not None:
                t[flip] = f
        prop.propagate_op_sharding.cache_clear()


def test_sharded_moves_the_data_shard_of_the_microbatch_split(fake16):
    # the training step's split of a batch sharded over data (4 ways)
    # into 2 microbatches: DTensor refuses the unflatten (2 rows over 4);
    # the retry moves the data shard to another dim, runs the view, and
    # puts the shard on the microbatch's batch rows, which the split's
    # select then keeps: no replication over data
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import sharded
    k, Bt, S1 = 2, 8, 9
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(Bt, S1, dtype=torch.int32),
                              fake16, [Shard(0), Replicate()],
                              src_data_rank=None)
        with sharded(fake16) as rs:
            split = x.reshape((k, Bt // k) + tuple(x.shape[1:]))
            mb = split[1]
        assert rs.ops == {"aten.view.default@move:data": 1}
        assert tuple(split.placements) == (Shard(1), Replicate())
        assert tuple(split.to_local().shape) == (k, Bt // k // 4, S1)
        assert tuple(mb.placements) == (Shard(0), Replicate())
        assert tuple(mb.to_local().shape) == (Bt // k // 4, S1)


@pytest.fixture(scope="module")
def reshard_runs(tmp_path_factory):
    sys.path.insert(0, str(REPO / "tests"))
    import torch_reshard_cases as cases
    out = tmp_path_factory.mktemp("reshard")
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=cases.port_worker,
                         args=(r, 4, str(out / "store"), str(out)))
             for r in range(4)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(240)
    alive = [p.pid for p in ranks if p.is_alive()]
    for p in ranks:
        if p.is_alive():
            p.kill()
    assert not alive and [p.exitcode for p in ranks] == [0] * 4, (
        alive, [p.exitcode for p in ranks])
    return cases, [np.load(out / f"rank{r}.npz") for r in range(4)]


def test_moved_data_shard_holds_the_unsharded_views_values(reshard_runs):
    cases, runs = reshard_runs
    want = cases.batch().reshape(cases.VIEW)
    rows = cases.VIEW[1] // 2
    for rank, got in enumerate(runs):
        data = rank // 2                  # (2, 2) mesh: rank = 2·data + model
        assert json.loads(str(got["ops"])) == {
            "aten.view.default@move:data": 1}
        assert str(got["placements"]) == "(Shard(dim=1), Replicate())"
        np.testing.assert_array_equal(
            got["local"], want[:, data * rows:(data + 1) * rows])
        np.testing.assert_array_equal(got["full"], want)
