"""From the first statement of ``ddmbench/run.py`` to the first timed
tick: torch and the CUDA context, the kernels' libraries (built or
loaded from ``build/repro_torch/``), the regions and move pool from the
seed, the plan and the warm-up ticks."""
UNIT = "s"


def read(win):
    return win.setup_s
