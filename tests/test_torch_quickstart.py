"""``examples/quickstart_torch.py --device cpu`` against the reference's
``examples/quickstart.py``.

Both scripts run as subprocesses (the reference's about 18 s here, the
twin's about 10 s, side by side).  Their outputs are the same lines with
the same numbers, but for step 2's backend check (the reference's Pallas
kernels in interpret mode, the twin's ``cuda`` backend against
``torch``) and the twin's last line, which on the CPU says that no
kernel ran.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def _start(script, *args, **env):
    return subprocess.Popen(
        [sys.executable, str(REPO / "examples" / script), *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"), **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lines(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return [line for line in out.splitlines() if line.strip()]


def test_quickstart_twin_prints_the_reference_numbers():
    ref = _start("quickstart.py", JAX_PLATFORMS="cpu")
    port = _start("quickstart_torch.py", "--device", "cpu")
    ref_lines, port_lines = _lines(ref), _lines(port)
    assert ref_lines.pop(6) == "   pallas backend agrees (interpret mode)"
    assert port_lines.pop(6) == ("   cuda backend agrees with the torch "
                                 "backend")
    assert port_lines.pop() == ("no kernel ran: the kernels' plain "
                                "versions stood in on cpu")
    assert port_lines == ref_lines
    assert any("K = 4954" in line for line in port_lines)
