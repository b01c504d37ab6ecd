"""Build the port's CUDA kernels with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch/lib<name>-<hash>.so`` at the repository root
(the hash covers the source, the headers it includes (``HEADERS``) and
the flags, so an edited source or header builds anew).  Builds happen
at first use, never at import: the CPU tests import every module on
hosts with no ``nvcc`` and no card.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
An entry point that takes no arguments is a constant of its library
(a tile size): ``_open`` reads each once, into ``lib.const``.
``load_log`` names every library this process has built or loaded, in
order (``repro_torch.analysis.steady`` watches it).

A missing card, a missing ``nvcc``, a failed compile or a failed load
raises ``RuntimeError``; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

INT32_MAX = 2 ** 31 - 1
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of each library's entry points: name -> (argtypes, restype)
SIGNATURES = {
    "sbm_sweep": {
        "sbm_sweep_tile": ((), _I),
        "sbm_sweep_strerror": ((_I,), ctypes.c_char_p),
        "sbm_sweep_launch": ((_P, _P, _P, _P, _L, _P), _I),
    },
    "emit": {
        "twopass_emit_strerror": ((_I,), ctypes.c_char_p),
        "twopass_emit_tile": ((_L,), _I),
        "twopass_emit_launch": ((_P, _P, _P, _P, _P, _I, _I, _L, _P, _P),
                                _I),
    },
    "bfm": {
        "bfm_strerror": ((_I,), ctypes.c_char_p),
        "bfm_tile_counts_smem": ((_I, _I, _I), _L),
        "bfm_tile_counts_d1_path": ((_I, _I, _I), _I),
        "bfm_tile_counts_launch": ((_P, _P, _P, _P, _L, _L, _I, _I, _I, _P,
                                    ctypes.c_float, _P), _I),
    },
    "bfm_mask": {
        "bfm_mask_strerror": ((_I,), ctypes.c_char_p),
        "bfm_mask_launch": ((_P, _P, _P, _P, _L, _L, _I, _P, _P), _I),
    },
    "emit_stream": {
        "emit_stream_strerror": ((_I,), ctypes.c_char_p),
        "emit_stream_launch": ((_P, _L, _P, _P, _I, _I, _L, _I, _P, _P), _I),
    },
    "csr_decode": {
        "csr_decode_strerror": ((_I,), ctypes.c_char_p),
        "csr_decode_tile": ((), _I),
        "csr_decode_wmax": ((), _I),
        "csr_decode_launch": ((_P, _L, _P, _P, _I, _I, _L, _L, _P, _P), _I),
    },
    "itm_walk": {
        "itm_walk_strerror": ((_I,), ctypes.c_char_p),
        "itm_walk_launch": ((_P, _P, _P, _P, _P, _L, _P, _P, _L, _P, _L, _I,
                             _P, _P, _I, _P), _I),
        "itm_walk_chase_launch": ((_P, _L, _P, _P), _I),
    },
    "sparse_attn": {
        "sparse_attn_strerror": ((_I,), ctypes.c_char_p),
        "sparse_attn_launch": ((_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _I,
                                _I, _I, _I, ctypes.c_float, _P), _I),
    },
}

# headers each source includes, hashed with it
HEADERS = {"emit": ("emit_tile.cuh",), "emit_stream": ("emit_tile.cuh",)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
load_log: list[str] = []


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes()
                   for f in (f"{name}.cu", *HEADERS.get(name, ())))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str, nvcc: str):
    """Start compiling ``name`` unless its library exists: (target, proc)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)   # atomic: no process loads a half-written .so


def _open(name: str, target: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        raise RuntimeError(f"cannot load {target}: {e}") from e
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    lib.const = {fn: getattr(lib, fn)()
                 for fn, (argtypes, _) in SIGNATURES[name].items()
                 if not argtypes}
    return lib


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device; "
                           "torch.cuda.is_available() is False")


def build_all(names=tuple(SIGNATURES)) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load every named kernel library."""
    _require_card()
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            nvcc = _nvcc()
            jobs = {n: _start(n, nvcc) for n in todo}
            try:
                for n, (target, job) in jobs.items():
                    _finish(n, target, job)
            finally:
                for _, job in jobs.values():   # never leave nvcc running
                    if job is not None and job[0].poll() is None:
                        job[0].kill()
                        job[0].wait()
            for n, (target, _) in jobs.items():
                _libs[n] = _open(n, target)
                load_log.append(n)
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]


def launch(device, fn, *args) -> int:
    """Call the launch function ``fn(*args, stream)`` on ``device``'s
    current stream; returns the CUDA error code.

    ``device`` is made current only when it is not already, and
    ``current_stream`` is given its index: on an H100 host, entering
    ``torch.cuda.device`` took 3.4 µs against 0.6 µs for the compare,
    and ``current_stream()`` 6.9 µs against 1.9 µs with the index
    (``chip_smoke.py``'s ``[host]`` lines).  PyTorch has no public call
    that reads the raw stream without building a ``Stream`` object.
    """
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    with torch.cuda.device(idx):
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)


def check_c_int(what: str, **values: int) -> None:
    """Refuse, on every device, a value past INT32_MAX meant for a C
    ``int`` argument: ctypes wraps it silently (2^32 arrives as 0)."""
    big = [f"{k} = {v}" for k, v in values.items() if v > INT32_MAX]
    if big:
        raise ValueError(f"{what}: {', '.join(big)} must be <= {INT32_MAX} "
                         "(a C int argument)")


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{prefix}_strerror")(code).decode()
        raise RuntimeError(f"{prefix} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
