"""Sharded, atomic, async-capable checkpointing: the port of the JAX
package's ``checkpoint/sharded.py``, with its on-disk format.

Layout (one directory per step)::

    <dir>/step_0000010/
        manifest.json          # leaf paths, shapes, dtypes, shard ranges
        shard_000.npz ...      # leaves split along axis 0 into n_shards

A tree is nested dicts (lists and tuples too) of tensors or numpy arrays;
its leaves are named ``"a/b/c"`` and stored in JAX's flatten order (dict
keys sorted, sequence items ``[i]``), so either package restores the
other's checkpoints.  Writes go to ``<name>.tmp`` then ``os.rename``: a
torn write can never be mistaken for a valid checkpoint.  Async mode
copies the tree's tensors to the host on the caller's thread, then a
daemon thread serializes: the copy is a snapshot (a host view of a CPU
tensor would see the optimizer's next in-place update while the thread
writes).  Numpy leaves are handed over as they are, not copied again.

Restoring to a different shard count is elastic resharding: each new
shard's row range is intersected with the old ranges, a 1-D interval
matching problem solved by the port's engine
(``build_plan(MatchSpec(algo="sbm", capacity="fixed"))``; on the card
its pass 2 is kernel K2): the paper's algorithm planning the framework's
own data movement.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..convert import pairs_to_numpy
from ..core import MatchSpec, build_plan, make_regions


def _flatten(tree, prefix=()):
    """(path, leaf) in JAX's flatten order; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (f"[{i}]",))
    elif tree is not None:
        yield prefix, tree


def _leaf_paths(tree):
    return [("/".join(path), leaf) for path, leaf in _flatten(tree)]


def _map(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(prefix), tree)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A tensor leaf as a host copy that shares no memory with it; a numpy
    leaf as it is (handed over, as the reference's ``device_get`` hands
    over host arrays)."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach()
        return (host.clone() if host.device.type == "cpu"
                else host.cpu()).numpy()
    return np.asarray(leaf)


def _split_ranges(n_rows: int, n_shards: int):
    cuts = np.linspace(0, n_rows, n_shards + 1).astype(np.int64)
    return [(int(cuts[i]), int(cuts[i + 1])) for i in range(n_shards)]


def save(ckpt_dir: str | os.PathLike, step: int, tree, *,
         n_shards: int = 1) -> Path:
    """Write a checkpoint synchronously; returns the final directory."""
    base = Path(ckpt_dir)
    final = base / f"step_{step:07d}"
    tmp = base / f"step_{step:07d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "n_shards": n_shards, "leaves": []}
    shards: list[dict] = [{} for _ in range(n_shards)]
    for li, (name, leaf) in enumerate(_leaf_paths(tree)):
        arr = _to_numpy(leaf)
        key = f"leaf_{li}"
        rows = arr.shape[0] if arr.ndim else 1
        ranges = _split_ranges(rows, n_shards)
        manifest["leaves"].append({
            "name": name, "key": key, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "ranges": ranges})
        flat = arr.reshape(rows, -1) if arr.ndim else arr.reshape(1, 1)
        for si, (lo, hi) in enumerate(ranges):
            shards[si][key] = flat[lo:hi]
    # one writer a shard: each is its own file, and zlib's CRC and the
    # writes release the interpreter lock
    with ThreadPoolExecutor(n_shards) as pool:
        list(pool.map(lambda si: np.savez(tmp / f"shard_{si:03d}.npz",
                                          **shards[si]), range(n_shards)))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncSaver:
    """Snapshot on the caller's thread, serialize on a daemon thread."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_error: BaseException | None = None

    def save(self, ckpt_dir, step, tree, *, n_shards: int = 1):
        self.wait()
        host_tree = _map(lambda _, leaf: _snapshot(leaf), tree)

        def work():
            try:
                save(ckpt_dir, step, host_tree, n_shards=n_shards)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir) -> int | None:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _reshard_plan(old_ranges, new_ranges, device="cuda"):
    """Which old shards overlap each new shard's row range, computed by
    the port's interval matcher on ``device`` (half-open row intervals as
    float32 bounds, as the reference's).

    Zero-row ranges (lo == hi, when n_shards > n_rows) hold no data and
    would violate the matcher's non-empty-interval precondition: they
    are dropped before matching and appear in no plan entry."""
    new_ids = [i for i, (lo, hi) in enumerate(new_ranges) if lo < hi]
    old_ids = [i for i, (lo, hi) in enumerate(old_ranges) if lo < hi]
    if not new_ids or not old_ids:
        return {}

    def regions(ranges, ids):
        return make_regions(
            np.asarray([[ranges[i][0]] for i in ids], np.float32),
            np.asarray([[ranges[i][1]] for i in ids], np.float32),
            device)
    S, U = regions(new_ranges, new_ids), regions(old_ranges, old_ids)
    cap = (len(new_ids) + len(old_ids)) * 2 + 8
    match_plan = build_plan(MatchSpec(algo="sbm", capacity="fixed",
                                      max_pairs=cap, device=str(device)),
                            S.n, U.n, 1)
    pairs, _ = match_plan.pairs(S, U)
    pairs = pairs_to_numpy(pairs)
    pairs = pairs[pairs[:, 0] >= 0]
    plan: dict[int, list[int]] = {}
    for new_i, old_i in pairs:
        plan.setdefault(new_ids[int(new_i)], []).append(old_ids[int(old_i)])
    for v in plan.values():
        v.sort()
    return plan


def restore(ckpt_dir, step: int, template, *, n_shards_new: int = 1,
            device="cuda"):
    """Restore a checkpoint into ``template``'s structure (any tree whose
    leaves have ``.shape``; ``meta`` tensors will do), resharding from
    the stored shard count to ``n_shards_new`` by the engine's plan on
    ``device``.  The leaves come back as numpy arrays."""
    final = Path(ckpt_dir) / f"step_{step:07d}"
    manifest = json.loads((final / "manifest.json").read_text())
    files = {si: np.load(final / f"shard_{si:03d}.npz")
             for si in range(manifest["n_shards"])}
    pool = ThreadPoolExecutor(max(len(files), 1))
    try:
        arrays = {}
        for rec in manifest["leaves"]:
            rows = rec["shape"][0] if rec["shape"] else 1
            new_ranges = _split_ranges(rows, n_shards_new)
            old_ranges = [tuple(r) for r in rec["ranges"]]
            plan = _reshard_plan(old_ranges, new_ranges, device)
            # each old shard the plan names is read once, the shards'
            # files in parallel
            need = sorted({oi for v in plan.values() for oi in v})
            old = dict(zip(need, pool.map(
                lambda oi: files[oi][rec["key"]], need)))
            pieces = []
            for ni, (nlo, nhi) in enumerate(new_ranges):
                if nlo == nhi:
                    continue
                for oi in plan.get(ni, []):
                    olo, ohi = old_ranges[oi]
                    lo, hi = max(nlo, olo), min(nhi, ohi)
                    if lo < hi:
                        pieces.append(old[oi][lo - olo: hi - olo])
            full = np.concatenate(pieces, axis=0) if pieces else \
                files[0][rec["key"]]
            arrays[rec["name"]] = full.reshape(rec["shape"]).astype(
                rec["dtype"], copy=False)
    finally:
        pool.shutdown()
        for f in files.values():
            f.close()

    def take(name, leaf):
        arr = arrays[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                             f"template {tuple(leaf.shape)}")
        return arr
    return _map(take, template)
