"""Two-pass emit, pass 2, as hand-written CUDA kernels: K2, K5 and K6.

All three write the pass-2 slots of the exact pair enumeration from
pass 1's tables: slot ``t`` belongs to the last emitter ``e`` with
``offs[e] <= t`` (a binary search), its rank is ``t − offs[e]``, and the
partner is read from ``perm_u`` (class A, ``e < n``) or ``perm_s``
(class B).  Ranks past the emitter's count give the −1 pad, so every
output is bit-identical to the plain pass 2 (``core.sbm``).

``twopass_emit`` (K2, ``csrc/emit.cu``, the ``resident`` route)
    Replaces ``kernels/emit.py:_emit_kernel``.  Reads the uncompacted
    pass-1 tables in device memory by the tile decode of
    ``csrc/emit_tile.cuh``, one CTA per tile of slots: two warps find
    the tile's first and last owners by 32-ary searches of the offsets;
    the tile's offsets are read once, and the last entry of each run of
    equal offsets (zero-count emitters share their successor's) marks
    its first slot in an owner array, which a max-scan fills in, so
    every slot finds its emitter in O(1).  A tile that spans at most
    ``EMIT_WMAX`` entries (every tile at fig. 9 and on Koln) reads the
    owners' fields from a staged window, a larger one through L1, and
    one that spans more than ``EMIT_PERSLOT_SPAN`` tiles' worth (long
    zero-count runs, as at overlap degree 0.01) binary-searches per
    slot.  The tile is the largest of ``EMIT_TILE_MAX``, /2, ...,
    ``EMIT_TILE_MIN`` slots whose grid still gives every SM
    ``EMIT_CTAS_PER_SM`` CTAs: 4096 at fig. 9, 512 at overlap degree 1
    (K = 489,667), 256 for the planner's few thousand block pairs.
    Bound: bytes, 8 B written per slot (fig. 9, K ≈ 5e7: 400 MB,
    ≈0.12 ms).

``twopass_emit_streaming`` (K5, ``csrc/emit_stream.cu``, ``streaming``)
    Replaces ``_emit_stream_kernel``.  The same tile decode over the
    compacted packed table (``pack_emitter_tables``), in tiles of
    ``lane_pad(block)`` slots (``DEF_BLOCK`` = 4096, the fastest tile
    at fig. 9): a tile selects at most that many + 1 consecutive
    entries.  Each CTA searches its own tile's entries; there are no
    window bases.  Same bound.

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

The hybrid grid+SBM (``algo="hsbm"``) runs all three kernels unchanged
on its emitter-slot tables: the flattened per-cell emitter rows take the
place of the n and m emitters and the shifted id tables ``sid + n_a`` /
``uid + n_b`` the place of the permutations; ``remap_slot_pairs`` then
maps the slot-space halves back to region ids (plain tensor code, as the
reference's is ``jnp``).

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
DEF_BLOCK = 4096       # K5 slots per CTA tile
# the tile decode of K2 and K5 (``csrc/emit_tile.cuh``: WMAX,
# PERSLOT_SPAN): the most entries a tile stages, and the span, in tiles,
# past which it searches per slot; K2's tile rule (``csrc/emit.cu``:
# TILE_MAX, TILE_MIN, CTAS_PER_SM)
EMIT_WMAX = 257
EMIT_PERSLOT_SPAN = 16
EMIT_TILE_MAX, EMIT_TILE_MIN, EMIT_CTAS_PER_SM = 4096, 256, 4
# a tile of B slots selects <= B + 1 consecutive compacted entries; +128
# covers aligning a window base down to a multiple of 128 (the
# reference's windows; the packed table stays at least this wide)
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
    """K2: pass-2 pair write, ``(max_pairs, 2)`` int32, −1 padded.

    A CTA of 256 threads a tile of T slots (``EMIT_TILE_MIN`` to
    ``EMIT_TILE_MAX``, by the tile rule above), at ``4·T + 3084`` bytes
    of shared memory: the owner array and a 3 × 257-entry window.
    """
    _build.check_c_int("twopass_emit", n=perm_s.shape[0], m=perm_u.shape[0])
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
    stream_window(lane_pad(block))``.  ``block`` is rounded up to a
    multiple of 128, ``bl``: the slots of one CTA tile, at ``4·bl +
    4112`` bytes of shared memory (``bl`` up to 56,960; a larger tile is
    refused at the launch).
    """
    _build.check_c_int("twopass_emit_streaming", n=perm_s.shape[0],
                       m=perm_u.shape[0], bl=lane_pad(block))
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
    out = torch.empty((max_pairs, 2), dtype=torch.int32, device=tab.device)
    lib = _build.load("emit_stream")
    rc = _build.launch(
        tab.device, lib.emit_stream_launch, tab.data_ptr(), e_pad,
        perm_s.data_ptr(), perm_u.data_ptr(), perm_s.shape[0],
        perm_u.shape[0], max_pairs, bl, out.data_ptr())
    _build.check(lib, "emit_stream", rc)
    twopass_emit_streaming.launches += 1
    return out


def csr_decode_window(tab, perm_s, perm_u, w0: int,
                      nslots: int) -> torch.Tensor:
    """K6: slots ``[w0, w0 + nslots)`` of the pass-2 buffer, ``(nslots, 2)``.

    ``w0`` and ``nslots`` are runtime arguments; ``w0 + nslots`` must
    stay within int32 slot ids.  A CTA of 256 threads a ``CSR_TILE``-slot
    tile, static shared memory only (its window and owner array).
    """
    _build.check_c_int("csr_decode_window", n=perm_s.shape[0],
                       m=perm_u.shape[0])
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


def remap_slot_pairs(pairs, sid, uid) -> torch.Tensor:
    """Map slot-space pair halves back to region ids (hsbm).

    ``sid``/``uid`` are the hybrid's id tables, one entry per emitter row
    (``n_a``/``n_b`` of them).  A kernel-written half is either an
    own-emitter slot (a class-A s half ``< n_a``, a class-B u half
    ``< n_b``), read through ``sid``/``uid``, or a gathered shifted id
    (``>= n_a`` / ``>= n_b``), which loses its shift.  -1 pads pass
    through.  Valid slots never gather a pad row of
    the id tables (windows cover real natives only), so the result is the
    buffer of the plain hybrid pass 2 (``core.sbm._hsbm_emit``).
    """
    n_a, n_b = sid.shape[0], uid.shape[0]
    c0, c1 = pairs[:, 0], pairs[:, 1]
    s_idx = torch.where(c0 < n_a, sid[c0.clamp(0, n_a - 1)], c0 - n_a)
    u_idx = torch.where(c1 < n_b, uid[c1.clamp(0, n_b - 1)], c1 - n_b)
    return torch.stack([torch.where(c0 < 0, -1, s_idx),
                        torch.where(c1 < 0, -1, u_idx)], 1)


twopass_emit.launches = 0
twopass_emit_streaming.launches = 0
csr_decode_window.launches = 0
