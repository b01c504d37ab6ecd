"""Hillclimb tool: trace one cell and print its peak and the largest
per-device tensors (who is eating the memory budget).

The port of the JAX package's ``launch/probe_buffers.py``: where the
reference compiles the cell and reads the tensor shapes of its HLO, this
runs the dry run's trace (``launch.dryrun.trace_cell``: DTensors over a
fake process group, fake local shards) and lists the local tensors the
step made, by dtype and shape, with the bytes of one device.

    python -m repro_torch.launch.probe_buffers --arch zamba2-2.7b \\
        --shape train_4k [--multi] [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..configs import ALIASES, SHAPES, get_config, get_smoke_config
from ..core.regions import resolve_device
from .dryrun import cell_mesh, trace_cell


def probe(arch: str, shape: str, *, multi: bool = False,
          smoke: bool = False, device="cuda") -> dict:
    """The dry run's counts of one cell (``trace_cell``'s dict)."""
    arch = ALIASES.get(arch, arch)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    return trace_cell(cfg, SHAPES[shape], cell_mesh(multi, smoke, dev), dev)


def largest(rec: dict, top: int) -> list[tuple[str, int]]:
    """The ``top`` largest tensors made, (dtype[shape], bytes), largest
    first."""
    return sorted(rec["largest"].items(), key=lambda kv: -kv[1])[:top]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    rec = probe(args.arch, args.shape, multi=args.multi, smoke=args.smoke,
                device=args.device)
    print(f"peak ~ {rec['peak_estimate'] / 1e9:.2f} GB "
          f"(args {rec['argument_bytes'] / 1e9:.2f} temp "
          f"{rec['temp_bytes'] / 1e9:.2f} out "
          f"{rec['output_bytes'] / 1e9:.2f} alias "
          f"{rec['alias_bytes'] / 1e9:.2f})")
    for key, n in largest(rec, args.top):
        print(f"{n / 1e9:9.2f} GB {n:>15d} B  {key}")
    return rec


if __name__ == "__main__":
    main()
