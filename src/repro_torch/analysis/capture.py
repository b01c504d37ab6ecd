"""Capture hooks: record what the plans and the kernel wrappers really run.

The port's counterpart of the JAX package's ``analysis/capture.py``.  The
auditor never re-implements dispatch: it records the real thing at two
choke points, and the checks read the records.

``capture_launches(records, gate=None)``
    Wraps ``kernels._build.launch``, the one function through which
    every wrapper calls a kernel's C entry point.  Each call appends a
    ``LaunchRecord``: the library and entry point (looked up by the
    entry's name in ``_build.SIGNATURES``), every argument as the
    wrapper passed it, before ctypes converts it, and each argument's
    ctypes type.  ``gate(record)``, when given, runs before the real
    launch and may raise ``LaunchBlocked``: the launch then never runs
    (a launch the kernel audit refuses is flagged before it runs).

``capture_dispatch(records, device=...)``
    A ``TorchDispatchMode`` that appends a ``DispatchRecord`` for every
    aten op on a plan method's path: the op, its output dtypes and
    shapes, an ``arange``'s end, and whether the op forces a host sync
    on the card: a host read (``_local_scalar_dense``, ``equal``), an op
    whose output shape depends on the data (``nonzero``, ``unique``,
    ``masked_select``, ``repeat_interleave`` without ``output_size``, a
    boolean-mask ``index``/``index_put``), or a copy between the host and
    the card (``_to_copy``/``copy_`` across devices, ``lift_fresh`` of a
    tensor built from host data on ``device``).  ``Tensor.tolist`` and
    ``Tensor.cpu`` are wrapped too (on the CPU they reach no aten op): a
    call on a tensor on ``device`` is one host read, and the ops inside
    it are not counted again.

Neither hook sees inside a ctypes kernel or host NumPy (hsbm's float64
geometry, ``sample_splitters``, the service's ledger), as the reference's
jaxpr audit does not see host NumPy either.  Both hooks restore what they
replaced on exit and on an exception.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _build


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

class LaunchBlocked(RuntimeError):
    """A launch gate refused a launch before it ran."""


@dataclasses.dataclass
class LaunchRecord:
    """One call of ``_build.launch``."""

    lib: str | None          # csrc/<lib>.cu, None if no SIGNATURES entry
    entry: str               # the C entry point's name
    args: tuple              # arguments before the stream, as passed
    argtypes: tuple | None   # their ctypes types (SIGNATURES), stream last

    @property
    def target(self) -> str:
        return f"{self.lib}.{self.entry}"


def lookup_entry(entry: str):
    """``(lib, argtypes)`` of the entry point named ``entry``."""
    for lib, entries in _build.SIGNATURES.items():
        if entry in entries:
            return lib, tuple(entries[entry][0])
    return None, None


@contextlib.contextmanager
def capture_launches(records: list, gate: Callable | None = None):
    """Record every ``_build.launch`` call made while the context is live.

    The wrapped call still launches the kernel (unless ``gate`` raises);
    it is only observed.
    """
    real = _build.launch

    def patched(device, fn, *args):
        entry = getattr(fn, "__name__", None) or str(fn)
        lib, argtypes = lookup_entry(entry)
        rec = LaunchRecord(lib, entry, tuple(args), argtypes)
        records.append(rec)
        if gate is not None:
            gate(rec)
        return real(device, fn, *args)

    _build.launch = patched
    try:
        yield records
    finally:
        _build.launch = real


# ---------------------------------------------------------------------------
# aten ops on a plan method's path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DispatchRecord:
    """One aten op (or one wrapped host read) under ``capture_dispatch``."""

    op: str                         # "aten.nonzero.default", "Tensor.tolist"
    dtypes: tuple                   # output dtypes (torch.dtype)
    shapes: tuple                   # output shapes (tuples of ints)
    sync: str | None = None         # why it syncs on the card, or None
    arange_end: int | None = None   # an arange's end


HOST_READS = frozenset({"aten._local_scalar_dense", "aten.equal",
                        "aten.is_nonzero"})
DATA_SHAPED = frozenset({"aten.nonzero", "aten._unique", "aten._unique2",
                         "aten.unique_dim", "aten.unique_consecutive",
                         "aten.masked_select"})
MASK_INDEXED = frozenset({"aten.index", "aten.index_put",
                          "aten.index_put_", "aten._index_put_impl_"})
COPIES = frozenset({"aten._to_copy", "aten.copy_", "aten.copy"})


def _packet(func) -> str:
    return str(func.overloadpacket)       # "aten.nonzero"


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _sync_reason(func, args, kwargs, outs, device) -> str | None:
    name = _packet(func)
    if name in HOST_READS:
        return "host read"
    if name in DATA_SHAPED:
        return "data-dependent shape"
    if (name == "aten.repeat_interleave"
            and kwargs.get("output_size") is None
            and any(isinstance(a, torch.Tensor) for a in args)):
        return "data-dependent shape"
    if name in MASK_INDEXED and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(t, torch.Tensor)
               and t.dtype in (torch.bool, torch.uint8) for t in idx):
            return "data-dependent shape (boolean mask index)"
    if name in COPIES and not kwargs.get("non_blocking", False):
        devs = {t.device.type for t in _tensors((args, outs))}
        if len(devs) > 1:
            return "copy between host and card"
    if name == "aten.lift_fresh" and any(
            t.device.type == device.type for t in _tensors(outs)):
        return "tensor built from host data"
    return None


_HOST_READ_DEPTH = threading.local()


class _Recorder(TorchDispatchMode):
    def __init__(self, records: list, device: torch.device):
        super().__init__()
        self.records = records
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        outs = func(*args, **kwargs)
        ts = _tensors(outs)
        sync = None
        if not getattr(_HOST_READ_DEPTH, "n", 0):
            sync = _sync_reason(func, args, kwargs, outs, self.device)
        end = None
        if _packet(func) == "aten.arange":
            nums = [a for a in args if isinstance(a, (int, float))]
            end = int(nums[1] if len(nums) > 1 else nums[0]) if nums else None
        self.records.append(DispatchRecord(
            op=str(func), dtypes=tuple(t.dtype for t in ts),
            shapes=tuple(tuple(int(s) for s in t.shape) for t in ts),
            sync=sync, arange_end=end))
        return outs


_WRAPPED = ("tolist", "cpu")


@contextlib.contextmanager
def capture_dispatch(records: list, device="cpu"):
    """Record every aten op, and each host read, made while live."""
    device = torch.device(device)
    real = {m: getattr(torch.Tensor, m) for m in _WRAPPED}

    def wrap(method):
        orig = real[method]

        def host_read(self, *a, **kw):
            if self.device.type != device.type:
                return orig(self, *a, **kw)
            _HOST_READ_DEPTH.n = getattr(_HOST_READ_DEPTH, "n", 0) + 1
            try:
                out = orig(self, *a, **kw)
            finally:
                _HOST_READ_DEPTH.n -= 1
            records.append(DispatchRecord(
                op=f"Tensor.{method}", dtypes=(self.dtype,),
                shapes=(tuple(int(s) for s in self.shape),),
                sync="host read"))
            return out
        return host_read

    for m in _WRAPPED:
        setattr(torch.Tensor, m, wrap(m))
    try:
        with _Recorder(records, device):
            yield records
    finally:
        for m, fn in real.items():
            setattr(torch.Tensor, m, fn)
