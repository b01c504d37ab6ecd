"""Multi-device dry run: trace every (arch × shape × mesh) cell.

The port of the JAX package's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell for 512 faked host devices and reads XLA's
analyses, this traces the cell's step eagerly on fake tensors:

  * the mesh is a ``DeviceMesh`` over the fake process group (one
    process is rank 0 of 16, 256 or 512; its collectives do nothing);
  * the parameters, the AdamW state, the batch and the cache are
    ``DTensor``s placed by ``launch.partition`` on that mesh, their local
    shards ``FakeTensor``s (shapes and dtypes, no storage);
  * the step of ``launch.steps`` runs under ``mesh_context`` (so the
    models' ``constrain`` calls redistribute as the reference's
    ``with_sharding_constraint`` asks GSPMD to), with the MoE in its
    dense form (``moe.use_form("dense")``: its shapes are static);
  * a dispatch mode *below* DTensor sees the local ops each rank runs
    and counts them: FLOPs (``torch.utils.flop_counter``'s formulas),
    bytes read and written by every op that is not a view, the live
    bytes of the storages the step makes (their peak), and every
    collective with its result bytes and group.

Every byte and FLOP is therefore one device's, on its local shards (a
mode above DTensor, as ``FlopCounterMode`` or ``MemTracker`` are, sees
global shapes).  The per-cell JSON keeps the reference's keys:

  memory      argument_bytes (the local shards of the step's inputs),
              output_bytes, alias_bytes (outputs that are inputs updated
              in place: parameters, moments, KV cache), temp_bytes, and
              peak_estimate = argument + temp + output − alias, which is
              the arguments plus the peak of the storages the step made
  cost        flops_per_device, bytes_accessed_per_device (the sum over
              ops of their operands' and results' bytes: no fusion, so an
              upper bound of what a fused kernel moves), flops_per_layer
  collectives count, by_op, link_bytes_per_device, link_bytes_per_layer,
              schedule_sample (the first 40), with link bytes from the
              reference's ``parse_collectives`` formulas, the group the
              size of the mesh dims the collective spans
  roofline    compute_s, memory_s, collective_s, model_flops_per_device
              (the reference's 6·N·tokens (train) or 2·N·tokens, N with
              only the MoE's active experts), useful_flops_ratio, dominant

Per-layer costs are the difference between the full trace and a trace
of the same cell with one variable layer unit (one layer; one hybrid
group; one encoder + decoder layer pair), over the units between them.

Dropped from the reference's record, and why:
  ``_probe_layers`` / ``probe_s`` / ``raw_scan_flops_per_device``: XLA's
  cost analysis counts a ``while`` body once, so the reference compiles
  unrolled 1- and 2-layer probes and extrapolates; an eager trace runs
  and counts every layer, so the totals need no probe;
  ``cpu_bf16_ghost_bytes`` / ``peak_tpu_estimate``: XLA-CPU's f32 copies
  of bf16 buffers, an artifact of compiling for host devices that a
  trace on fake tensors does not have.

The step runs under ``launch.mesh.sharded``: where DTensor refuses an op
that GSPMD would partition (a reshape that unflattens an unevenly
sharded dim: 2 heads over a 4-way axis), the op is retried after its
DTensor operands are redistributed (replicated over the minor mesh
dims; a ``data`` or ``pod`` shard first moved to another tensor dim, so
the training step's microbatch split keeps its batch sharded), and the
record lists each such op and its count under ``reshards``; constants
that a model makes inside a call (positions, masks) take part as
replicated.  A cell that still fails is ``status: "error"`` with its
first failing op, and the exit code is 1.

Roofline constants are datasheet figures of one NVIDIA H100 SXM5 80 GB:
989e12 dense bf16 FLOP/s, 3.35e12 B/s HBM3, and 450e9 B/s of NVLink 4 a
direction (its 900 GB/s total).  A node holds 8 such cards, so the 256-
and 512-device meshes span nodes, whose links (InfiniBand) are slower
than NVLink: their ``collective_s`` is a lower bound.

Decode cells take ``cur_len = seq_len − 1`` as a host int (the record's
``cur_len``), where the reference's step takes a traced scalar.

    python -m repro_torch.launch.dryrun --smoke --arch mamba2-780m \\
        --shape long_500k --mesh both --device cpu --out /tmp/d

The device is ``cuda`` unless ``--device cpu`` is given; then the mesh
and the fake tensors are the CPU's (and an all-to-all, which DTensor
lowers to an all-gather on a CPU mesh, is run and counted as the
card's all-to-all).  Asking for ``cuda`` without a card raises.

Every record carries ``torch.__version__`` under ``torch``.  The
collectives come from the redistributions that DTensor plans, which
differ between torch versions (and the count reaches two of DTensor's
private functions), so collective counts and link bytes compare only
between records of one version; FLOPs and memory do not depend on it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import (ALIASES, ARCHS, SHAPES, get_config, get_smoke_config,
                       shape_applicable)
from ..core.regions import resolve_device
from ..models import moe, transformer as T
from ..optim import AdamWConfig
from . import partition as pt
from .mesh import make_mesh, production_shape, sharded
from .steps import input_structs, make_decode_step, make_prefill_step, \
    make_train_step

# --- H100 SXM5 80 GB roofline constants (datasheet, per card) --------------
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # B/s
LINK_BW = 450e9          # B/s, NVLink 4 per direction

SMOKE_MESHES = {False: ((4, 4), ("data", "model")),
                True: ((2, 2, 4), ("pod", "data", "model"))}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def link_bytes(op: str, result_bytes: int, group: int) -> float:
    """Estimated bytes one device sends for a collective (the reference's
    ``parse_collectives`` formulas)."""
    p = max(group, 2)
    if op == "all-gather":
        return result_bytes * (p - 1) / p
    if op == "reduce-scatter":
        return result_bytes * (p - 1)      # result is the scattered shape
    if op == "all-reduce":
        return 2 * result_bytes * (p - 1) / p
    if op == "all-to-all":
        return result_bytes * (p - 1) / p
    return result_bytes                    # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class Tracker(TorchDispatchMode):
    """Counts the local ops under DTensor: FLOPs, bytes accessed, live
    storage bytes and their peak, the largest tensors made, and the
    collectives.  Ops with DTensor operands are left to DTensor (whose
    local ops come back here); the global-shape ops DTensor runs to
    propagate shapes are not counted (``shape_propagation``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.colls: list[dict] = []
        self.largest: dict = {}
        self._seen = weakref.WeakKeyDictionary()
        self._args: set[int] = set()
        self._quiet = 0

    def add_arguments(self, tensors) -> int:
        """Mark the storages of ``tensors`` (local shards) as the step's
        arguments; returns their bytes."""
        total = 0
        for t in tensors:
            st = _local(t).untyped_storage()
            if id(st) not in self._args:
                self._args.add(id(st))
                self._seen[st] = True
                total += st.nbytes()
        return total

    def is_argument(self, t: torch.Tensor) -> bool:
        return id(_local(t).untyped_storage()) in self._args

    def _free(self, n):
        self.live -= n

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen[st] = True
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)
        key = f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
        self.largest[key] = max(self.largest.get(key, 0), n)

    @contextlib.contextmanager
    def shape_propagation(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        pk = func._overloadpacket
        name = pk.__name__
        if func.namespace in ("_c10d_functional", "_dtensor") \
                and name in _COLLECTIVES:
            res = next(_tensors(out))
            rb = _nbytes(res)
            group = _group_size(args[-1])
            op = _COLLECTIVES[name]
            self.colls.append({"op": op, "result_bytes": rb, "group": group,
                               "link_bytes": link_bytes(op, rb, group)})
        elif pk in self._flop:
            self.flops += self._flop[pk](*args, **kwargs, out_val=out)
        outs = list(_tensors(out))
        if not func.is_view and func.namespace == "aten":
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


_GROUP_SIZES: dict = {}


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    if group_name not in _GROUP_SIZES:
        _GROUP_SIZES[group_name] = _resolve_process_group(group_name).size()
    return _GROUP_SIZES[group_name]


@contextlib.contextmanager
def _dtensor_hooks(tracker: Tracker, device_type: str):
    """Keep DTensor's shape-propagation ops out of the counts and, on a
    CPU mesh, run the all-to-all that DTensor would replace by an
    all-gather there."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types
    import torch.distributed._functional_collectives as funcol
    prop = DTensor._op_dispatcher.sharding_propagator
    orig_prop = prop._propagate_tensor_meta_non_cached
    orig_a2a = placement_types.shard_dim_alltoall

    def quiet_prop(op_schema):
        with tracker.shape_propagation():
            return orig_prop(op_schema)

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    prop._propagate_tensor_meta_non_cached = quiet_prop
    if device_type == "cpu":
        placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        prop._propagate_tensor_meta_non_cached = orig_prop
        placement_types.shard_dim_alltoall = orig_a2a


def build_cell(cfg, spec, mesh, device: torch.device):
    """(step function, its arguments) of one cell, placed on ``mesh``;
    call under the fake mode it was built in."""
    model = T.init_params(cfg, None, device)
    pspecs = pt.distribute_params(model, mesh)
    bstruct = input_structs(cfg, spec)
    if spec.kind == "decode":
        bstruct = {"tokens": bstruct["tokens"]}
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in bstruct.items()}
    bspecs = pt.sanitize_tree(mesh, pt.batch_specs(mesh, batch), batch)
    batch = pt.distribute_tree(batch, bspecs, mesh)
    if spec.kind == "train":
        named = dict(model.named_parameters())
        zeros = {k: {n: pt.distribute(
            torch.zeros(p.shape, dtype=torch.float32, device=device),
            pspecs[n], mesh) for n, p in named.items()} for k in ("m", "v")}
        opt = {**zeros, "step": torch.zeros((), dtype=torch.int32,
                                            device=device)}
        return make_train_step(cfg, AdamWConfig()), (model, opt, batch)
    cache = T.init_cache(cfg, spec.global_batch, spec.seq_len, device)
    cspecs = pt.sanitize_tree(
        mesh, pt.cache_specs(mesh, cache, batch=spec.global_batch,
                             seq_shard=spec.global_batch == 1), cache)
    cache = pt.distribute_tree(cache, cspecs, mesh)
    if spec.kind == "prefill":
        return make_prefill_step(cfg), (model, cache, batch)
    batch["cur_len"] = spec.seq_len - 1
    return make_decode_step(cfg), (model, cache, batch)


def _step_tensors(args):
    model, state, batch = args
    return (list(model.parameters()) + list(_tensors(state))
            + list(_tensors(batch)))


@contextlib.contextmanager
def counting(mesh, tracker: Tracker | None = None):
    """Count the local ops of the block (DTensor code on ``mesh``, under a
    fake mode the caller entered): yields (``Tracker``, ``Reshard``)."""
    tracker = tracker or Tracker()
    with _dtensor_hooks(tracker, mesh.device_type), moe.use_form("dense"), \
            tracker, sharded(mesh) as reshard:
        yield tracker, reshard


def cell_argument_bytes(cfg, spec, mesh, device: torch.device) -> int:
    """One device's bytes of a cell's arguments (their local shards),
    without running its step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        _, args = build_cell(cfg, spec, mesh, device)
        return Tracker().add_arguments(_step_tensors(args))


def trace_cell(cfg, spec, mesh, device: torch.device) -> dict:
    """Trace one cell's step on fake tensors; the counts of one device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
    tracker = Tracker()
    _GROUP_SIZES.clear()            # group names repeat across worlds
    gc.collect()                    # no garbage of an earlier trace
    with fake_mode:
        fn, args = build_cell(cfg, spec, mesh, device)
        arg_bytes = tracker.add_arguments(_step_tensors(args))
        with counting(mesh, tracker) as (_, reshard):
            out = fn(*args)
        outs = [t for t in _tensors(_outputs(out)) if t is not None]
        out_bytes = sum(_nbytes(_local(t)) for t in outs)
        alias = sum(_nbytes(_local(t)) for t in outs
                    if tracker.is_argument(t))
        del out, outs, args, fn
    temp = max(tracker.peak - (out_bytes - alias), 0)
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "alias_bytes": alias, "temp_bytes": temp,
            "peak_estimate": arg_bytes + temp + out_bytes - alias,
            "flops": tracker.flops, "bytes": tracker.bytes,
            "colls": tracker.colls, "largest": tracker.largest,
            "reshards": dict(reshard.ops)}


def _outputs(out):
    """The tensors a step returns: a train step's (model, state,
    metrics), a serving step's (logits, cache)."""
    first, *rest = out
    if isinstance(first, nn.Module):
        first = list(first.parameters())
    return [first] + rest


def layer_units(cfg):
    """(the config with one variable layer unit, the full config's
    units), the units of the reference's ``_probe_layers``."""
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return dataclasses.replace(cfg, n_layers=nd + 1), cfg.n_layers - nd
    if cfg.family == "hybrid":
        per = cfg.attn_every
        return dataclasses.replace(cfg, n_layers=per), cfg.n_layers // per
    if cfg.family == "audio":
        return (dataclasses.replace(cfg, n_layers=1, enc_layers=1),
                cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=1), cfg.n_layers


def model_flops(cfg, spec, n_dev: int) -> float:
    """The reference's useful FLOPs a device: 6·N·tokens for a train
    step, else 2·N·tokens, N with only the MoE's active experts."""
    active = cfg.n_params()
    if cfg.family == "moe":
        active -= ((cfg.n_experts - cfg.top_k) * 3 * cfg.d_model
                   * cfg.moe_d_ff * (cfg.n_layers - cfg.first_dense_layers))
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    mult = 6 if spec.kind == "train" else 2
    return mult * active * tokens / n_dev


def cell_mesh(multi_pod: bool, smoke: bool, device):
    shape, axes = SMOKE_MESHES[multi_pod] if smoke \
        else production_shape(multi_pod)
    return make_mesh(shape, axes, device=device, fake=True)


def run_cell(arch: str, shape: str, multi_pod: bool, smoke: bool = False,
             overrides: dict | None = None, device="cuda",
             mesh=None) -> dict:
    """One cell's record (``status`` ok or skipped; a failure raises).
    ``mesh``: a mesh to use in place of the cell's own."""
    spec = SHAPES[shape]
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why,
                "torch": torch.__version__}
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else cell_mesh(multi_pod, smoke, dev)
    n_dev = mesh.size()
    t0 = time.time()
    main = trace_cell(cfg, spec, mesh, dev)
    t_trace = time.time() - t0
    one_cfg, units = layer_units(cfg)
    one = trace_cell(one_cfg, spec, mesh, dev) if units > 1 else None

    def per_layer(key):
        if one is None:
            return main[key]
        return (main[key] - one[key]) / (units - 1)

    colls = main["colls"]
    coll_bytes = float(sum(c["link_bytes"] for c in colls))
    one_coll = (float(sum(c["link_bytes"] for c in one["colls"]))
                if one else 0.0)
    flops, bytes_acc = float(main["flops"]), float(main["bytes"])
    mflops = model_flops(cfg, spec, n_dev)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "n_devices": n_dev, "status": "ok", "device": dev.type,
        "torch": torch.__version__,
        "mesh_shape": list(mesh.shape),
        "trace_s": round(t_trace, 1),
        "memory": {k: main[k] for k in (
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_estimate")},
        "cost": {
            "flops_per_device": flops,
            "bytes_accessed_per_device": bytes_acc,
            "flops_per_layer": float(per_layer("flops")),
        },
        "collectives": {
            "count": len(colls),
            "by_op": {op: sum(1 for c in colls if c["op"] == op)
                      for op in sorted({c["op"] for c in colls})},
            "link_bytes_per_device": coll_bytes,
            "link_bytes_per_layer": ((coll_bytes - one_coll) / (units - 1)
                                     if one else coll_bytes),
            "schedule_sample": colls[:40],
        },
        "roofline": {
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll_bytes / LINK_BW,
            "model_flops_per_device": mflops,
            "useful_flops_ratio": (mflops / flops) if flops else None,
        },
        "reshards": main["reshards"],
    }
    if spec.kind == "decode":
        rec["cur_len"] = spec.seq_len - 1
    rec["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"),
        key=lambda k: rec["roofline"][k])
    return rec


def first_failing_op(tb: str) -> str:
    """Where a traceback failed: the innermost frame in the port's models
    (else in the port), as file:line: code, and the error's last line."""
    lines = tb.strip().splitlines()
    where = {}
    for i, line in enumerate(lines):
        if "repro_torch/" in line and line.strip().startswith("File"):
            path = line.strip().split('"')[1].split("repro_torch/")[-1]
            code = lines[i + 1].strip() if i + 1 < len(lines) else ""
            site = f"{path}:{line.split('line ')[-1].split(',')[0]}: {code}"
            where["models" if path.startswith("models/") else "any"] = site
    site = where.get("models") or where.get("any", "")
    return f"{site} ({lines[-1] if lines else ''})"


def parse_overrides(items) -> dict:
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        out[k] = {"True": True, "False": False}.get(
            v, int(v) if v.lstrip("-").isdigit() else v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs on 16-device meshes "
                         "(selftest)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (perf variants), "
                         "e.g. --override mla_absorb=False")
    ap.add_argument("--tag", default="",
                    help="suffix for output filenames (variants)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    dev = resolve_device(args.device)

    archs = ARCHS if args.arch == "all" else [
        ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                if args.tag:
                    tag += f"_{args.tag}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[skip existing] {tag}")
                    continue
                print(f"[run] {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, smoke=args.smoke,
                                   overrides=overrides, device=dev)
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    tb = traceback.format_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "device": dev.type, "torch": torch.__version__,
                           "status": "error",
                           "error": repr(e)[:2000],
                           "first_failing_op": first_failing_op(tb),
                           "trace": tb[-4000:]}
                path.write_text(json.dumps(rec, indent=1))
                st = rec.get("status")
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']}"
                             f" c={r['compute_s']:.2e}"
                             f" m={r['memory_s']:.2e}"
                             f" n={r['collective_s']:.2e}"
                             f" peak={rec['memory']['peak_estimate']:.3e}"
                             f" trace={rec['trace_s']}s")
                elif st == "error":
                    extra = f" at {rec['first_failing_op']}"
                print(f"[done] {tag}: {st}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
