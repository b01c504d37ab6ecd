"""The port's sharded checkpoints (``repro_torch.checkpoint.sharded``)
against the JAX package's ``repro.checkpoint.sharded``.

The reference's own cases on the port (round trip; elastic reshard
4→3, 3→4, 1→5, 5→1, 2→2; async; ``latest_step`` ignoring ``.tmp``);
``_reshard_plan`` through the port's engine (``device="cpu"``: the
plain pass 2 of kernel K2) equal to the reference's over a grid of
(rows, old shards, new shards), zero-row shards included; a checkpoint
written by either package restored by the other bit for bit, at the same
and at another shard count, with the two manifests JSON-equal for the
same tree; and the ``AsyncSaver`` snapshot, which an in-place update
made right after ``save`` must not reach.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import sharded as R  # noqa: E402

from repro_torch.checkpoint import sharded as P  # noqa: E402


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((13, 5)).astype(np.float32),
            "nested": {"b": np.arange(7, dtype=np.int32),
                       "c": rng.standard_normal((4, 3, 2)).astype(
                           np.float32)},
            "scalar": np.float32(3.25),
            "list": [np.ones((2, 2), np.float32),
                     np.int32(-4) * np.ones((5,), np.int32)]}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_tree_equal(got, want):
    fg, tg = jax.tree.flatten(got)
    fw, tw = jax.tree.flatten(want)
    assert tg == tw
    for g, w in zip(fg, fw):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_save_restore_roundtrip(tmp_path):
    tree = _torch_tree(_np_tree())
    P.save(tmp_path, 3, tree, n_shards=1)
    assert P.latest_step(tmp_path) == 3
    out = P.restore(tmp_path, 3, tree, device="cpu")
    _assert_tree_equal(out, _np_tree())


@pytest.mark.parametrize("p_old,p_new", [(4, 3), (3, 4), (1, 5), (5, 1),
                                         (2, 2)])
def test_elastic_reshard_roundtrip(tmp_path, p_old, p_new):
    tree = _torch_tree(_np_tree())
    P.save(tmp_path, 1, tree, n_shards=p_old)
    out = P.restore(tmp_path, 1, tree, n_shards_new=p_new, device="cpu")
    _assert_tree_equal(out, _np_tree())


def test_async_saver(tmp_path):
    tree = _torch_tree(_np_tree())
    s = P.AsyncSaver()
    s.save(tmp_path, 7, tree)
    s.wait()
    _assert_tree_equal(P.restore(tmp_path, 7, tree, device="cpu"),
                       _np_tree())


def test_async_snapshot_is_not_reached_by_a_later_update(tmp_path):
    tree = _torch_tree(_np_tree())
    want = _np_tree()
    s = P.AsyncSaver()
    s.save(tmp_path, 1, tree, n_shards=2)
    # the optimizer's next step updates the live tensors in place
    for t in (tree["a"], tree["nested"]["c"], tree["list"][0]):
        t.add_(1.0)
    s.wait()
    _assert_tree_equal(P.restore(tmp_path, 1, tree, device="cpu"), want)


def test_async_snapshot_copies_tensors_and_hands_numpy_over(tmp_path):
    arr = np.arange(6, dtype=np.float32)
    t = torch.arange(6, dtype=torch.float32)
    assert P._snapshot(arr) is arr
    assert not np.shares_memory(P._snapshot(t), t.numpy())
    s = P.AsyncSaver()
    s.save(tmp_path, 2, _np_tree(), n_shards=2)
    s.wait()
    _assert_tree_equal(P.restore(tmp_path, 2, _np_tree(), device="cpu"),
                       _np_tree())


def test_async_saver_reraises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    s = P.AsyncSaver()
    s.save(blocker, 1, _torch_tree(_np_tree()))
    with pytest.raises(OSError):
        s.wait()
    s.wait()                                  # reported once


def test_latest_step_ignores_tmp(tmp_path):
    assert P.latest_step(tmp_path / "none") is None
    assert P.latest_step(tmp_path) is None
    P.save(tmp_path, 2, _torch_tree(_np_tree()))
    (tmp_path / "step_0000009.tmp").mkdir()
    assert P.latest_step(tmp_path) == 2
    P.save(tmp_path, 4, _torch_tree(_np_tree()))
    assert P.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob("step_0000004.tmp"))


GRID = [(rows, old, new) for rows in (1, 2, 3, 7, 13, 100)
        for old in (1, 2, 3, 5) for new in (1, 2, 3, 4, 6, 8)]


def test_reshard_plans_match_reference():
    for rows, old, new in GRID:
        o = R._split_ranges(rows, old)
        n = R._split_ranges(rows, new)
        assert P._split_ranges(rows, old) == o
        assert P._reshard_plan(o, n, device="cpu") == R._reshard_plan(o, n)


@pytest.mark.parametrize("n_save,n_restore", [(1, 1), (3, 3), (2, 5),
                                              (4, 1)])
def test_reference_checkpoint_restores_in_the_port(tmp_path, n_save,
                                                   n_restore):
    ref_tree = jax.tree.map(jnp.asarray, _np_tree())
    R.save(tmp_path, 5, ref_tree, n_shards=n_save)
    out = P.restore(tmp_path, 5, _torch_tree(_np_tree()),
                    n_shards_new=n_restore, device="cpu")
    _assert_tree_equal(out, _np_tree())


@pytest.mark.parametrize("n_save,n_restore", [(1, 1), (3, 3), (2, 5),
                                              (4, 1)])
def test_port_checkpoint_restores_in_the_reference(tmp_path, n_save,
                                                   n_restore):
    P.save(tmp_path / "port", 5, _torch_tree(_np_tree()), n_shards=n_save)
    ref_tree = jax.tree.map(jnp.asarray, _np_tree())
    out = R.restore(tmp_path / "port", 5, ref_tree, n_shards_new=n_restore)
    _assert_tree_equal(out, _np_tree())
    R.save(tmp_path / "ref", 5, ref_tree, n_shards=n_save)
    manifests = [json.loads((tmp_path / d / "step_0000005" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    for si in range(n_save):
        a = np.load(tmp_path / "port" / "step_0000005" / f"shard_{si:03d}.npz")
        b = np.load(tmp_path / "ref" / "step_0000005" / f"shard_{si:03d}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


def test_restore_checks_the_template_shapes(tmp_path):
    P.save(tmp_path, 1, _torch_tree(_np_tree()))
    bad = _torch_tree(_np_tree())
    bad["a"] = torch.zeros((12, 5))
    with pytest.raises(ValueError, match="^a: checkpoint shape"):
        P.restore(tmp_path, 1, bad, device="cpu")
    meta = {k: v for k, v in _torch_tree(_np_tree()).items()}
    meta["a"] = torch.empty((13, 5), device="meta")
    assert P.restore(tmp_path, 1, meta, device="cpu")["a"].shape == (13, 5)
