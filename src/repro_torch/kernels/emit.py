"""Two-pass emit, pass 2, as hand-written CUDA kernels: K2, K5 and K6.

All three write the pass-2 slots of the exact pair enumeration from
pass 1's tables: slot ``t`` belongs to the last emitter ``e`` with
``offs[e] <= t`` (a binary search), its rank is ``t − offs[e]``, and the
partner is read from ``perm_u`` (class A, ``e < n``) or ``perm_s``
(class B).  Ranks past the emitter's count give the −1 pad, so every
output is bit-identical to the plain pass 2 (``core.sbm``).

``twopass_emit`` (K2, ``csrc/emit.cu``, the ``resident`` route)
    Replaces ``kernels/emit.py:_emit_kernel``.  One thread per slot
    binary-searches the uncompacted offsets in device memory; the five
    tables (16 B per emitter) are served by the 50 MB L2.  Bound: bytes,
    8 B written per slot (fig. 9, K ≈ 5e7: 400 MB, ≈0.12 ms).

``twopass_emit_streaming`` (K5, ``csrc/emit_stream.cu``, ``streaming``)
    Replaces ``_emit_stream_kernel``.  Reads the compacted packed table
    (``pack_emitter_tables``): a tile of ``bl`` slots selects at most
    ``bl + 1`` consecutive entries, so one CTA stages a
    ``stream_window(bl)``-entry window of it in shared memory and
    searches there; only the two permutations are gathered from device
    memory.  Window bases come from one library searchsorted of the
    tiles' first slots, as the reference computes them.  Same bound.

``csr_decode_window`` (K6, ``csrc/csr_decode.cu``, ``csr``)
    Replaces ``_csr_decode_kernel``.  Slots ``[w0, w0 + nslots)`` of
    the same buffer, decoded on demand from the packed table and the
    permutations (the ``CSRPairs`` view holds nothing else).  One CTA
    per tile of ``CSR_TILE`` slots: two warps find the tile's first and
    last entries by 32-ary searches of the offsets; a tile that selects
    at most ``CSR_WMAX`` entries (every tile below saturation) stages
    them in shared memory, scatters each entry's first slot into an
    owner array and max-scans it, so every slot finds its entry in
    O(1); a tile that selects more (offsets repeated past ``max_pairs``)
    binary-searches per slot between the two.  The TPU's fixed-length
    run copies and their padded permutations are not needed.  Bound:
    bytes, 8 B written and a 4-byte partner read per slot.

The packed table's pad entries carry offset ``PAD_OFF = INT32_MAX``, not
the reference's ``1 << 30``: pass 1 saturates offsets at ``max_pairs``,
which may reach INT32_MAX, and above 2³⁰ slots pads at ``1 << 30`` would
sit below real offsets and break the search (ROADMAP Queue 3).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version (``ref``) for CPU tensors; ``max_pairs == 0`` /
``nslots == 0`` return an empty ``(0, 2)`` buffer without a launch.
``.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build, ref

_INT32_MAX = 2 ** 31 - 1
PAD_OFF = _INT32_MAX   # > every slot id: pad entries are never selected
DEF_BLOCK = 512        # K5 slots per CTA tile
# a tile of B slots selects <= B + 1 consecutive compacted entries; +128
# covers aligning the window base down to a multiple of 128
STREAM_WIN_EXTRA = 256
# K6's slots per CTA tile and the most table entries a tile stages
# (``csrc/csr_decode.cu``: TILE, WMAX)
CSR_TILE = 2048
CSR_WMAX = CSR_TILE + 1


def lane_pad(x: int, mult: int = 128) -> int:
    """Round ``x`` up to a multiple of 128 (the packed table's width)."""
    return -(-x // mult) * mult


def stream_window(block: int) -> int:
    """K5's window length, in table entries, for a tile of ``block`` slots.

    The one definition of the window: K5 stages ``stream_window(bl)``
    entries per CTA, and the table must be packed at least that wide.
    """
    return lane_pad(block) + STREAM_WIN_EXTRA


def _empty_pairs(device) -> torch.Tensor:
    return torch.empty((0, 2), dtype=torch.int32, device=device)


def _check_int32(device, **arrays) -> None:
    for name, (x, shape) in arrays.items():
        if (x.dtype != torch.int32 or not x.is_contiguous()
                or tuple(x.shape) != shape or x.device != device):
            raise ValueError(
                f"{name} must be a contiguous int32 {shape} tensor on "
                f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def pack_emitter_tables(offs, counts, starts, *, n: int, m: int,
                        min_len: int = 0) -> torch.Tensor:
    """Compact and pack pass 1's emitter tables: int32 (4, E_pad).

    Zero-count emitters are dropped (they share their offset with a
    successor, so the slot lookup never selects them), which leaves the
    compacted offsets strictly increasing below saturation.  Rows:
    saturated offsets, counts, input starts, original emitter id.  The
    width is ``max(lane_pad(n + m), min_len)``; pad entries carry offset
    ``PAD_OFF``, count 0, start 0 and emitter id ``n + m``.  The
    reference packs the same four rows into an (8, E_pad) table whose
    rows 4–7 are TPU sublane padding; they are left out here.
    """
    E = n + m
    sel = torch.nonzero(counts > 0).flatten()
    e_pad = max(lane_pad(E), min_len)
    tab = torch.zeros((4, e_pad), dtype=torch.int32, device=counts.device)
    tab[0] = PAD_OFF
    tab[3] = E
    k = sel.shape[0]
    tab[0, :k] = offs[sel]
    tab[1, :k] = counts[sel]
    tab[2, :k] = starts[sel]
    tab[3, :k] = sel.to(torch.int32)
    return tab


def _check_tables(offs, counts, starts, perm_s, perm_u) -> None:
    n, m = perm_s.shape[0], perm_u.shape[0]
    E = n + m
    _check_int32(offs.device, offs=(offs, (E + 1,)),
                 counts=(counts, (E,)), starts=(starts, (E,)),
                 perm_s=(perm_s, (n,)), perm_u=(perm_u, (m,)))
    if n == 0 or m == 0:
        raise ValueError("twopass_emit needs n >= 1 and m >= 1 emitters")


def _check_slots(nslots: int) -> None:
    if not 0 < nslots <= _INT32_MAX:
        raise ValueError(f"max_pairs must be in [0, {_INT32_MAX}] (int32 "
                         f"slot ids), got {nslots}")


def _check_packed(tab, perm_s, perm_u) -> None:
    n, m = perm_s.shape[0], perm_u.shape[0]
    if tab.ndim != 2 or tab.shape[0] != 4:
        raise ValueError(f"tab must be the packed (4, E_pad) table, got "
                         f"{tuple(tab.shape)}")
    _check_int32(tab.device, tab=(tab, tuple(tab.shape)),
                 perm_s=(perm_s, (n,)), perm_u=(perm_u, (m,)))
    if n == 0 or m == 0:
        raise ValueError("the packed table needs n >= 1 and m >= 1 emitters")


def twopass_emit(offs, counts, starts, perm_s, perm_u, *,
                 max_pairs: int) -> torch.Tensor:
    """K2: pass-2 pair write, ``(max_pairs, 2)`` int32, −1 padded."""
    if max_pairs == 0:
        return _empty_pairs(offs.device)
    if offs.device.type == "cpu":
        return ref.twopass_emit(offs, counts, starts, perm_s, perm_u,
                                max_pairs=max_pairs)
    if offs.device.type != "cuda":
        raise ValueError(f"twopass_emit: unsupported device {offs.device}")
    _check_slots(max_pairs)
    _check_tables(offs, counts, starts, perm_s, perm_u)
    out = torch.empty((max_pairs, 2), dtype=torch.int32, device=offs.device)
    lib = _build.load("emit")
    rc = _build.launch(
        offs.device, lib.twopass_emit_launch, offs.data_ptr(),
        counts.data_ptr(), starts.data_ptr(), perm_s.data_ptr(),
        perm_u.data_ptr(), perm_s.shape[0], perm_u.shape[0], max_pairs,
        out.data_ptr())
    _build.check(lib, "twopass_emit", rc)
    twopass_emit.launches += 1
    return out


def twopass_emit_streaming(tab, perm_s, perm_u, *, max_pairs: int,
                           block: int = DEF_BLOCK) -> torch.Tensor:
    """K5: the K2 buffer from the packed table, ``(max_pairs, 2)`` int32.

    ``tab`` comes from ``pack_emitter_tables`` with ``min_len >=
    stream_window(lane_pad(block))``.
    """
    if max_pairs == 0:
        return _empty_pairs(tab.device)
    if tab.device.type == "cpu":
        return ref.twopass_emit_streaming(tab, perm_s, perm_u,
                                          max_pairs=max_pairs)
    if tab.device.type != "cuda":
        raise ValueError(f"twopass_emit_streaming: unsupported device "
                         f"{tab.device}")
    _check_slots(max_pairs)
    _check_packed(tab, perm_s, perm_u)
    bl = lane_pad(block)
    win = stream_window(bl)
    e_pad = tab.shape[1]
    if e_pad < win:
        raise ValueError(f"packed table width {e_pad} is narrower than the "
                         f"window {win}; pack with min_len >= "
                         f"stream_window(lane_pad({block}))")
    tiles = -(-max_pairs // bl)
    t0 = torch.arange(tiles, dtype=torch.int32, device=tab.device) * bl
    k0 = torch.searchsorted(tab[0], t0, right=True) - 1
    base = (k0.clamp_(min=0) // 128 * 128).clamp_(max=e_pad - win)
    base = base.to(torch.int32)
    out = torch.empty((max_pairs, 2), dtype=torch.int32, device=tab.device)
    lib = _build.load("emit_stream")
    rc = _build.launch(
        tab.device, lib.emit_stream_launch, tab.data_ptr(), e_pad,
        base.data_ptr(), perm_s.data_ptr(), perm_u.data_ptr(),
        perm_s.shape[0], perm_u.shape[0], max_pairs, bl, win,
        out.data_ptr())
    _build.check(lib, "emit_stream", rc)
    twopass_emit_streaming.launches += 1
    return out


def csr_decode_window(tab, perm_s, perm_u, w0: int,
                      nslots: int) -> torch.Tensor:
    """K6: slots ``[w0, w0 + nslots)`` of the pass-2 buffer, ``(nslots, 2)``.

    ``w0`` and ``nslots`` are runtime arguments; ``w0 + nslots`` must
    stay within int32 slot ids.
    """
    if nslots == 0:
        return _empty_pairs(tab.device)
    if w0 < 0 or nslots < 0 or w0 + nslots > _INT32_MAX:
        raise ValueError(f"decode window [{w0}, {w0 + nslots}) outside the "
                         f"int32 slot ids [0, {_INT32_MAX}]")
    if tab.device.type == "cpu":
        return ref.csr_decode_window(tab, perm_s, perm_u, w0, nslots)
    if tab.device.type != "cuda":
        raise ValueError(f"csr_decode_window: unsupported device "
                         f"{tab.device}")
    _check_packed(tab, perm_s, perm_u)
    out = torch.empty((nslots, 2), dtype=torch.int32, device=tab.device)
    lib = _build.load("csr_decode")
    rc = _build.launch(
        tab.device, lib.csr_decode_launch, tab.data_ptr(), tab.shape[1],
        perm_s.data_ptr(), perm_u.data_ptr(), perm_s.shape[0],
        perm_u.shape[0], w0, nslots, out.data_ptr())
    _build.check(lib, "csr_decode", rc)
    csr_decode_window.launches += 1
    return out


twopass_emit.launches = 0
twopass_emit_streaming.launches = 0
csr_decode_window.launches = 0
