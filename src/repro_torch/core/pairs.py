"""One result contract for pair enumeration — ``PairsResult``.

The port's counterpart of the JAX package's ``core/pairs.py``.
``MatchPlan.pairs()`` returns a ``PairsResult``:

* ``count`` — the exact total K (python int), even when the buffer
  capacity truncates;
* ``cap`` / ``shape`` / ``dtype`` / ``__len__`` — the static buffer
  geometry (``(cap, 2)`` int32);
* ``decode(start, stop)`` — the dense slice of slots ``[start, stop)``:
  real pairs in slot order below ``min(count, cap)``, −1 pads above;
* ``windows(chunk)`` — ``(start, np.ndarray)`` chunks in slot order;
* ``to_dense()`` — the full dense device tensor;
* ``__array__`` — the full dense host buffer (NumPy protocol);
* ``nbytes`` — device bytes actually held.

``DensePairs`` wraps an in-memory dense ``(cap, 2)`` int32 tensor; the
lazy CSR view is ``kernels.ops.CSRPairs``; ``ShardedPairs`` holds the
distributed backend's per-rank buffers, gathered to every rank.
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class PairsResult:
    """Abstract pair-enumeration result (see module docstring).

    Subclasses must set ``cap`` and ``count`` (ints) and implement
    ``decode`` and ``nbytes``; everything else derives from those.
    """

    cap: int
    count: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.cap, 2)

    @property
    def dtype(self):
        return np.int32

    def __len__(self) -> int:
        return self.cap

    @property
    def nbytes(self) -> int:
        """Device bytes actually held by this result."""
        raise NotImplementedError

    @property
    def dense_nbytes(self) -> int:
        """Bytes a dense (cap, 2) int32 buffer would occupy."""
        return self.cap * 2 * 4

    def _check_window(self, start: int, stop: int | None) -> int:
        stop = self.cap if stop is None else stop
        if not 0 <= start <= stop <= self.cap:
            raise ValueError(
                f"decode window [{start}, {stop}) outside [0, {self.cap}]")
        return stop

    def decode(self, start: int = 0, stop: int | None = None):
        """Dense int32 (stop−start, 2) device slice of slots
        [start, stop) — real pairs below ``min(count, cap)``, −1 pads
        above."""
        raise NotImplementedError

    def windows(self, chunk: int = 1 << 16):
        """Yield ``(start, np.ndarray)`` dense chunks in slot order."""
        for w0 in range(0, self.cap, chunk):
            yield w0, to_numpy(self.decode(w0, min(w0 + chunk, self.cap)))

    def to_dense(self):
        """Full dense (cap, 2) device tensor."""
        return self.decode(0, self.cap)

    def __array__(self, dtype=None, copy=None):
        out = np.full((self.cap, 2), -1, np.int32)
        for w0, w in self.windows():
            out[w0:w0 + w.shape[0]] = w
        return out if dtype is None else out.astype(dtype)


class DensePairs(PairsResult):
    """``PairsResult`` over an in-memory dense ``(cap, 2)`` tensor.

    ``data`` is the int32 −1-padded buffer the emit paths produce, on
    the device it was emitted on; ``count`` is the exact K.  ``decode``
    is a plain slice and ``__getitem__`` delegates to the tensor.
    """

    def __init__(self, data: torch.Tensor, count: int):
        self.data = data
        self.cap = int(data.shape[0])
        self.count = int(count)

    @property
    def nbytes(self) -> int:
        return self.cap * 2 * 4

    def decode(self, start: int = 0, stop: int | None = None):
        stop = self._check_window(start, stop)
        return self.data[start:stop]

    def __getitem__(self, idx):
        return self.data[idx]

    def __array__(self, dtype=None, copy=None):
        out = to_numpy(self.data)
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"DensePairs(cap={self.cap}, count={self.count}, "
                f"nbytes={self.nbytes})")


class ShardedPairs(PairsResult):
    """``PairsResult`` over the distributed backend's per-rank buffers.

    ``data`` is the gathered ``(nshards * cap_dev, 2)`` int32 stack of the
    ranks' slot-bound emit buffers: rank p's pairs are the −1-padded
    prefix of rows ``[p * cap_dev, (p+1) * cap_dev)``, and
    ``dev_counts[p]`` is that prefix's length.  Rank chunks are disjoint
    and in global emitter order, so the valid prefixes concatenated in
    rank order *are* the dense emission-order buffer.  ``MatchPlan.pairs``
    gathers ``data`` and ``dev_counts`` inside the call, with every rank
    taking part; after that nothing here is a collective.  The dense
    ``(cap, 2)`` view is assembled on ``data``'s device on the first
    ``decode``/``__array__`` and cached.  ``nbytes`` is the footprint held
    on a rank, ``cap_dev`` rows per rank, not the dense ``cap``.
    """

    def __init__(self, data: torch.Tensor, dev_counts, cap: int, count: int):
        self.data = data
        self.dev_counts = np.asarray(dev_counts, dtype=np.int64)
        self.nshards = int(self.dev_counts.shape[0])
        self.cap_dev = int(data.shape[0]) // self.nshards
        self.cap = int(cap)
        self.count = int(count)
        self._dense_cache: torch.Tensor | None = None

    @property
    def nbytes(self) -> int:
        return int(self.data.shape[0]) * 2 * 4

    def _dense(self) -> torch.Tensor:
        if self._dense_cache is None:
            out = torch.full((self.cap, 2), -1, dtype=torch.int32,
                             device=self.data.device)
            pos = 0
            for p in range(self.nshards):
                take = min(int(self.dev_counts[p]), self.cap - pos)
                if take > 0:
                    base = p * self.cap_dev
                    out[pos:pos + take] = self.data[base:base + take]
                    pos += take
                if pos >= self.cap:
                    break
            self._dense_cache = out
        return self._dense_cache

    def decode(self, start: int = 0, stop: int | None = None):
        stop = self._check_window(start, stop)
        return self._dense()[start:stop]

    def __array__(self, dtype=None, copy=None):
        out = to_numpy(self._dense())
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedPairs(cap={self.cap}, count={self.count}, "
                f"nshards={self.nshards}, cap_dev={self.cap_dev}, "
                f"nbytes={self.nbytes})")
