"""Import hygiene of the port: no JAX and nothing of the JAX package.

``repro_torch`` and ``chip_smoke.py`` must run on a host that has no
JAX, so neither may import ``jax`` (or ``jaxlib``) nor any ``repro``
module — not even one that happens not to import JAX itself.  An AST
scan checks every source file, and a fresh interpreter checks that
importing the whole package leaves ``jax`` out of ``sys.modules``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py"]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_import_no_jax_and_no_reference_package():
    assert len(SOURCES) > 10
    bad = [f"{p.relative_to(REPO)}:{line}: import {name}"
           for p in SOURCES for line, name in _imports(p) if _forbidden(name)]
    assert not bad, "\n".join(bad)


def test_scan_flags_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.sbm")
    assert _forbidden("repro") and _forbidden("jaxlib")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_importing_the_port_loads_no_jax():
    # kernels first: the order in which a core <-> kernels cycle shows
    code = ("import sys, repro_torch.kernels, repro_torch.core, "
            "repro_torch.convert, repro_torch.sparse, "
            "repro_torch.serve.harness, repro_torch.analysis.steady, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.lm_serve, repro_torch.launch.serve, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.optim.compress, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.sharded, repro_torch.runtime.trainer, "
            "repro_torch.runtime.pipeline, repro_torch.launch.mesh, "
            "repro_torch.launch.partition, repro_torch.launch.dryrun, "
            "repro_torch.launch.probe_buffers, "
            "repro_torch.models.sharding\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
