"""Kernel pass — the port's C entry points, launches and compiled functions.

The port's counterpart of the JAX package's ``analysis/kernel_audit.py``.
The reference read grids and BlockSpecs from its ``pallas_call`` traces;
a CUDA kernel's grid, block and shared memory are set inside its C entry
point, so the audit holds each entry point to a model of them (the
``GEOMETRY`` table, from ``csrc/*.cu`` and the wrappers' docstrings) and
checks the models on the launches ``capture.capture_launches`` records.

On the CPU (no launch runs there):

``K_SIGNATURE``
    ``_build.SIGNATURES`` against each ``csrc/<lib>.cu`` ``extern "C"``
    prototype: every entry point present, its argument count, each
    argument's kind (pointer, signed or unsigned integer, float) and
    width, and its return type (``check_signatures``).  A mismatch hands
    the kernel corrupt arguments without an error.
``K_ROUTE_DRIFT``
    ``kernels.ops.emit_route_bytes`` against the bytes of the tensors the
    ``resident`` and ``streaming`` routes hand K2 and K5 for random access
    (K2: the five pass-1 tables; K5: the two permutations), captured from
    real calls at ``(n, m)`` (``audit_emit_route_parity``).
``K_INT32_ARG``, ``K_SMEM_BUDGET``, ``K_LAUNCH_LIMIT``
    On a ``LaunchRecord`` (``audit_launch``): an argument typed ``c_int``
    outside int32 (ctypes wraps it: 2³¹ arrives as −2³¹, 2³² + 5 as 5);
    the model's dynamic shared memory plus the kernel's static shared
    memory above the card's opt-in limit a block; a grid past
    (2³¹ − 1, 65535, 65535) or a block past the card's threads a block.
    The CPU runs them on the corpus's synthetic records.

On the card:

* the same three checks on the real launches of the kernel matrix,
  each before its launch runs (``launch_gate``), and ``K_NO_CAPTURE``
  for an entry that ran and launched nothing;
* the limits from ``torch.cuda.get_device_properties``;
* each compiled function's registers, stack, static shared and local
  (spill) bytes, read with ``cuobjdump`` from the built libraries
  (``kernel_code``); local bytes are ``K_SPILL``, a warning.
"""
from __future__ import annotations

import ctypes
import functools
import inspect
import re
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from .capture import LaunchBlocked
from .report import Report

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

# an H100 SXM's limits, used where no card is present to ask
H100_LIMITS = {"smem_optin": 232_448, "threads_per_block": 1024,
               "sm_count": 132, "grid": (2 ** 31 - 1, 65535, 65535)}


def device_limits(device=None) -> dict:
    """The launch limits of ``device`` (a CUDA device), or the H100's."""
    if device is None or torch.device(device).type != "cuda":
        return dict(H100_LIMITS)
    props = torch.cuda.get_device_properties(torch.device(device))
    return {
        "smem_optin": int(getattr(props, "shared_memory_per_block_optin",
                                  H100_LIMITS["smem_optin"])),
        "threads_per_block": int(getattr(props, "max_threads_per_block",
                                         H100_LIMITS["threads_per_block"])),
        "sm_count": int(props.multi_processor_count),
        "grid": H100_LIMITS["grid"],   # sm_90's grid limits
    }


# ---------------------------------------------------------------------------
# K_SIGNATURE: SIGNATURES against the extern "C" prototypes
# ---------------------------------------------------------------------------

# (kind, bytes) of the C types the entry points use, and of their ctypes
_C_TYPES = {
    "int": ("int", 4), "unsigned": ("uint", 4), "unsigned int": ("uint", 4),
    "long long": ("int", 8), "unsigned long long": ("uint", 8),
    "float": ("float", 4), "double": ("float", 8),
    "cudaStream_t": ("pointer", 8),
}
_CTYPES = {
    ctypes.c_int: ("int", 4), ctypes.c_uint: ("uint", 4),
    ctypes.c_longlong: ("int", 8), ctypes.c_ulonglong: ("uint", 8),
    ctypes.c_float: ("float", 4), ctypes.c_double: ("float", 8),
    ctypes.c_void_p: ("pointer", 8), ctypes.c_char_p: ("pointer", 8),
}


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def _c_type(decl: str) -> tuple:
    """(kind, bytes) of a C type (a parameter without its name, or a
    return type)."""
    decl = re.sub(r"\b(const|volatile|__restrict__|restrict)\b", " ", decl)
    if "*" in decl:
        return ("pointer", 8)
    key = " ".join(decl.split())
    if key not in _C_TYPES:
        raise ValueError(f"unknown C type {decl.strip()!r}")
    return _C_TYPES[key]


def _param_type(param: str) -> tuple:
    param = param.strip()
    if param in ("", "void"):
        raise ValueError("no parameter")
    if "*" in param:
        return ("pointer", 8)
    words = param.split()
    return _c_type(" ".join(words[:-1]) if len(words) > 1 else param)


def parse_prototypes(src: str) -> dict:
    """The functions defined in ``src``'s ``extern "C" { ... }`` blocks:
    {name: (param types, return type)}, each type as (kind, bytes)."""
    src = _strip_comments(src)
    out = {}
    for head in re.finditer(r'extern\s+"C"\s*\{', src):
        i, depth, start = head.end(), 0, head.end()
        while i < len(src):
            c = src[i]
            if c == "{":
                if depth == 0:
                    sig = re.search(r"([\w\s\*]+?)\b(\w+)\s*\(([^()]*)\)\s*$",
                                    src[start:i])
                    if sig:
                        params = [p for p in sig.group(3).split(",")
                                  if p.strip() not in ("", "void")]
                        out[sig.group(2)] = (
                            tuple(_param_type(p) for p in params),
                            _c_type(sig.group(1)))
                depth += 1
            elif c == "}":
                if depth == 0:
                    break
                depth -= 1
                if depth == 0:
                    start = i + 1
            elif c == ";" and depth == 0:
                start = i + 1
            i += 1
    return out


def _ctype(t) -> tuple:
    return _CTYPES.get(t, (getattr(t, "__name__", str(t)), None))


def check_signatures(report: Report, *, signatures=None) -> None:
    """``K_SIGNATURE`` for every library of ``signatures`` (default
    ``_build.SIGNATURES``) against ``csrc/<lib>.cu``."""
    for lib, entries in (signatures or _build.SIGNATURES).items():
        protos = parse_prototypes((_build.CSRC / f"{lib}.cu").read_text())
        for entry, (argtypes, restype) in entries.items():
            target = f"{lib}.{entry}"
            report.note_audit("kernel", f"signature {target}")
            if entry not in protos:
                report.add("kernel", "K_SIGNATURE", target,
                           f"SIGNATURES names {entry} but csrc/{lib}.cu "
                           "defines no such extern \"C\" function")
                continue
            c_args, c_ret = protos[entry]
            py_args = tuple(_ctype(t) for t in argtypes)
            if len(py_args) != len(c_args):
                report.add("kernel", "K_SIGNATURE", target,
                           f"SIGNATURES gives {len(py_args)} argument(s), "
                           f"the prototype takes {len(c_args)}: every "
                           "argument from the first missing one on "
                           "arrives in the wrong register")
                continue
            for k, (py, c) in enumerate(zip(py_args, c_args)):
                if py != c:
                    report.add("kernel", "K_SIGNATURE", target,
                               f"argument {k}: SIGNATURES passes {py[0]} "
                               f"of {py[1]} bytes, the prototype takes "
                               f"{c[0]} of {c[1]} bytes")
            if _ctype(restype) != c_ret:
                report.add("kernel", "K_SIGNATURE", target,
                           f"return type: SIGNATURES reads "
                           f"{_ctype(restype)}, the prototype returns "
                           f"{c_ret}")


# ---------------------------------------------------------------------------
# launch geometry: the grid, block and dynamic shared memory of each
# entry point, as its C code sets them (csrc/*.cu)
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _emit_tile(max_pairs: int, sm_count: int) -> int:
    """K2's tile (``csrc/emit.cu:pick_tile``)."""
    from ..kernels import emit
    t = emit.EMIT_TILE_MAX
    while (t > emit.EMIT_TILE_MIN
           and _cdiv(max_pairs, t) < emit.EMIT_CTAS_PER_SM * sm_count):
        t //= 2
    return t


# Each model returns (grid, threads a block, dynamic shared bytes, a
# fragment of the mangled name of the instance the launch runs).

def _geo_sbm_sweep(a, lim):
    # K1: a CTA of 256 threads a 4096-endpoint tile, no dynamic shared
    # memory (kernels/sbm_sweep.py); the vector instance when the flags
    # and the counts start on 16 bytes
    vec = int(((a[0] | a[1] | a[2]) & 15) == 0)
    return (_cdiv(a[4], 4096), 1, 1), 256, 0, f"sbm_sweep_kernelILb{vec}E"


def _geo_twopass_emit(a, lim):
    # K2: a CTA a tile of T slots, 4·T + 3084 bytes (kernels/emit.py)
    t = _emit_tile(a[7], lim["sm_count"])
    return ((_cdiv(a[7], t), 1, 1), 256, 4 * t + 4 * 3 * 257,
            "emit_tiles_kernel")


def _geo_emit_stream(a, lim):
    # K5: a CTA a tile of bl slots, 4·bl + 4112 bytes (kernels/emit.py)
    return ((_cdiv(a[6], a[7]), 1, 1), 256, 4 * a[7] + 4 * 4 * 257,
            "emit_tiles_kernel")


def _geo_csr_decode(a, lim):
    # K6: a CTA a 2048-slot tile, static shared memory only
    return (_cdiv(a[7], 2048), 1, 1), 256, 0, "csr_decode_kernel"


def _geo_bfm_tile_counts(a, lim):
    # K3 (kernels/bfm.py): the d1 path 16·ts bytes on persistent CTAs,
    # else 8·d·(ts + tu) bytes, a CTA a tile, at most 2^22 CTAs
    n, m, d, ts, tu = a[4], a[5], a[6], a[7], a[8]
    group = tu // 16 if tu % 16 == 0 else 0
    if (d == 1 and 1 <= ts <= 4096 and 1 <= group <= 32
            and group & (group - 1) == 0):
        items = (n // ts) * _cdiv(m, 4096)
        return ((min(items, 8 * lim["sm_count"]), 1, 1), 256, 16 * ts,
                f"bfm_tile_counts_d1_kernelILb{int(a[10] != 0)}E")
    tiles = (n // ts) * (m // tu)
    return ((min(tiles, 1 << 22), 1, 1), 256, 8 * d * (ts + tu),
            "bfm_tile_counts_kernel")


def _geo_bfm_mask(a, lim):
    # K4: persistent CTAs over 32-row tiles, static shared memory only;
    # the instance by the widest store that divides m and by d
    n, m, d = a[4], a[5], a[6]
    items = _cdiv(m, 4096) * _cdiv(n, 32)
    v = next(v for v in (16, 8, 4, 2, 1) if m % v == 0)
    return ((min(items, 8 * lim["sm_count"]), 1, 1), 256, 0,
            f"bfm_mask_kernelILi{v}ELi{1 if d == 1 else 2}E")


def _geo_sparse_attn(a, lim):
    # K7 (kernels/sparse_attn.py): grid (Sq/bq·ceil(bq/64), BH); bf16
    # 128 threads and 2·(64 + 4·64)·(ceil(dh/16)·16 + 8) bytes, float32
    # 256 threads and 4·((64 + 2·64)·(dh + 4) + 64·80) bytes
    dtype, bh, sq, dh, bq = a[6], a[7], a[8], a[10], a[11]
    grid = ((sq // bq) * _cdiv(bq, 64) if bq > 0 else 0, bh, 1)
    if dtype == 1:
        d16 = _cdiv(dh, 16) * 16
        return (grid, 128, 2 * (64 + 4 * 64) * (d16 + 8),
                f"sparse_attn_tc_kernelILi{d16}E")
    return (grid, 256, 4 * ((64 + 2 * 64) * (dh + 4) + 64 * 80),
            f"sparse_attn_kernelIfLi{_cdiv(dh, 16)}E")


def _geo_itm_walk(a, lim):
    # K8 (kernels/itm.py): the CTA regime a CTA of 512 threads a query at
    # 12,288·13 + 17·4 = 159,812 bytes; the thread regime 256 queries a
    # CTA, static shared memory only
    b, pairs, per_cta = a[10], int(bool(a[12])), a[14]
    if per_cta:
        return ((b, 1, 1), 512, 12_288 * 13 + 17 * 4,
                f"walk_per_ctaILb{pairs}E")
    return (_cdiv(b, 256), 1, 1), 256, 0, f"walk_per_threadILb{pairs}E"


def _geo_chase(a, lim):
    return (1, 1, 1), 1, 0, "chase_kernel"


GEOMETRY = {
    "sbm_sweep_launch": _geo_sbm_sweep,
    "twopass_emit_launch": _geo_twopass_emit,
    "emit_stream_launch": _geo_emit_stream,
    "csr_decode_launch": _geo_csr_decode,
    "bfm_tile_counts_launch": _geo_bfm_tile_counts,
    "bfm_mask_launch": _geo_bfm_mask,
    "sparse_attn_launch": _geo_sparse_attn,
    "itm_walk_launch": _geo_itm_walk,
    "itm_walk_chase_launch": _geo_chase,
}

def static_shared(resources: dict | None, lib: str, kernel: str) -> int:
    """The largest static shared bytes of ``lib``'s compiled functions
    whose names hold ``kernel`` (``audit_resources``' readings; 0 where
    none were read)."""
    funcs = (resources or {}).get(lib, {})
    return max((fn.get("shared", 0) for name, fn in funcs.items()
                if kernel in name), default=0)


def audit_launch(rec, *, report: Report, limits: dict | None = None,
                 resources: dict | None = None) -> dict | None:
    """``K_INT32_ARG``, ``K_SMEM_BUDGET`` and ``K_LAUNCH_LIMIT`` on one
    ``LaunchRecord``; returns its geometry ``{grid, block, smem,
    kernel}`` (``smem`` dynamic bytes, ``kernel`` a fragment of the
    launched functions' names), or None when no model covers the entry.
    ``resources`` ({lib: functions}, read on the card) gives the static
    shared bytes."""
    limits = limits or H100_LIMITS
    target = rec.target
    for k, (v, t) in enumerate(zip(rec.args, rec.argtypes or ())):
        if t is ctypes.c_int and isinstance(v, int) and not (
                INT32_MIN <= v <= INT32_MAX):
            wrapped = ctypes.c_int(v).value
            report.add("kernel", "K_INT32_ARG", target,
                       f"argument {k} is {v}, typed c_int: ctypes passes "
                       f"{wrapped} without an error")
    model = GEOMETRY.get(rec.entry)
    if model is None:
        return None
    grid, block, smem, kernel = model(rec.args, limits)
    static = static_shared(resources, rec.lib, kernel)
    if smem + static > limits["smem_optin"]:
        report.add("kernel", "K_SMEM_BUDGET", target,
                   f"{smem} B of dynamic shared memory + {static} B static "
                   f"= {smem + static} B a block, above the card's opt-in "
                   f"limit of {limits['smem_optin']} B")
    for axis, (g, cap) in enumerate(zip(grid, limits["grid"])):
        if g > cap:
            report.add("kernel", "K_LAUNCH_LIMIT", target,
                       f"grid {'xyz'[axis]} of {g} CTAs, past the limit "
                       f"{cap}")
    if block > limits["threads_per_block"]:
        report.add("kernel", "K_LAUNCH_LIMIT", target,
                   f"{block} threads a block, past the card's "
                   f"{limits['threads_per_block']}")
    return {"grid": grid, "block": block, "smem": smem, "kernel": kernel}


def launch_gate(report: Report, *, limits=None, resources=None,
                geometries: list | None = None):
    """A ``capture_launches`` gate: audits each launch before it runs and
    raises ``LaunchBlocked`` when the audit added an error finding."""
    def gate(rec):
        n0 = len(report.errors())
        geo = audit_launch(rec, report=report, limits=limits,
                           resources=resources)
        if geometries is not None:
            geometries.append((rec, geo))
        if len(report.errors()) > n0:
            raise LaunchBlocked(
                f"{rec.target} refused before it ran: "
                + "; ".join(f.message for f in report.errors()[n0:]))
    return gate


# ---------------------------------------------------------------------------
# K_ROUTE_DRIFT: the route model against the tensors the routes hand over
# ---------------------------------------------------------------------------

# the operands each dense pass-2 kernel reads at random
RANDOM_ACCESS = {
    "twopass_emit": ("offs", "counts", "starts", "perm_s", "perm_u"),
    "twopass_emit_streaming": ("perm_s", "perm_u"),
}
ROUTE_KERNEL = {"resident": "twopass_emit",
                "streaming": "twopass_emit_streaming"}


def audit_emit_route_parity(report: Report, *, n: int = 4000,
                            m: int = 3000, max_pairs: int = 8192,
                            model=None) -> None:
    """``emit_route_bytes`` must equal the bytes of the tensors each route
    hands its kernel for random access, captured on a real call (the
    plain path on the CPU; the same tensors reach the kernel on the
    card)."""
    from ..kernels import emit, ops
    from .matrix import probe_regions
    model = model or ops.emit_route_bytes
    want = model(n, m)
    S, U = probe_regions(n, seed=11), probe_regions(m, seed=12)
    for route, kname in ROUTE_KERNEL.items():
        target = f"emit_route_parity:{route}"
        seen = []
        real = getattr(emit, kname)
        sig = inspect.signature(real)

        @functools.wraps(real)
        def spy(*args, __real=real, __sig=sig, **kwargs):
            seen.append(__sig.bind(*args, **kwargs).arguments)
            return __real(*args, **kwargs)

        setattr(emit, kname, spy)
        try:
            ops.twopass_pairs_cuda(S, U, max_pairs, route=route)
        finally:
            setattr(emit, kname, real)
        if len(seen) != 1:
            report.add("kernel", "K_ROUTE_DRIFT", target,
                       f"expected one call of emit.{kname} on the {route} "
                       f"route, saw {len(seen)}")
            continue
        derived = sum(seen[0][a].numel() * seen[0][a].element_size()
                      for a in RANDOM_ACCESS[kname])
        if derived != want[route]:
            report.add(
                "kernel", "K_ROUTE_DRIFT", target,
                f"emit_route_bytes models {want[route]} B for the {route} "
                f"route, but the tensors it hands {kname} for random "
                f"access ({', '.join(RANDOM_ACCESS[kname])}) hold "
                f"{derived} B at (n={n}, m={m}) — the policy and the "
                "kernels have drifted apart")
        report.note_audit("kernel", target)


# ---------------------------------------------------------------------------
# compiled functions (card): cuobjdump's view of the built libraries
# ---------------------------------------------------------------------------

def kernel_code(lib: str, path: Path | None = None) -> dict:
    """The kernels of the built library ``lib`` (or of the library file
    ``path``) as ``cuobjdump`` reads them: {mangled name: {"sass":
    [instruction lines], "regs", "stack", "local", "shared"}} (the last
    four in registers and bytes)."""
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    path = str(path or _build._target(lib))

    def dump(flag):
        return subprocess.run([tool, flag, path], capture_output=True,
                              text=True, timeout=600, check=True).stdout

    funcs: dict = {}
    cur = None
    for line in dump("-sass").splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), {"sass": []})
        elif cur is not None:
            cur["sass"].append(line)
    cur = None
    for line in dump("-res-usage").splitlines():
        head = re.match(r"\s*Function (\S+?):?\s*$", line)
        use = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                        line)
        if head:
            cur = funcs.setdefault(head.group(1), {"sass": []})
        elif use and cur is not None:
            cur.update(zip(("regs", "stack", "shared", "local"),
                           map(int, use.groups())))
    return funcs


def pick(funcs: dict, *parts: str) -> tuple[str, dict]:
    """The one kernel whose mangled name holds every string in ``parts``."""
    hits = [k for k in funcs if all(x in k for x in parts)]
    if len(hits) != 1:
        raise ValueError(f"kernels named {parts}: {hits}")
    return hits[0], funcs[hits[0]]


def resources(fn: dict) -> str:
    return (f"{fn.get('regs', 'not read')} registers, stack "
            f"{fn.get('stack', 'not read')} B, local (spills) "
            f"{fn.get('local', 'not read')} B")


def audit_resources(report: Report) -> dict:
    """Read every built library's functions (``kernel_code``); a function
    with local bytes is ``K_SPILL`` (a warning).  Returns {lib: funcs}."""
    out = {}
    for lib in _build.SIGNATURES:
        funcs = kernel_code(lib)
        out[lib] = funcs
        for name, fn in sorted(funcs.items()):
            report.note_audit("kernel", f"resources {lib}:{name}")
            if fn.get("local", 0) > 0:
                report.add("kernel", "K_SPILL", f"{lib}:{name}",
                           f"{fn['local']} B of local memory a thread "
                           f"(spills), {fn.get('regs')} registers",
                           severity="warning")
    return out
