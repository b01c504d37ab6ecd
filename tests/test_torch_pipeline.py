"""The port's GPipe schedule (``repro_torch.runtime.pipeline``) against
the serial layer stack and against the JAX package's pipeline.

Four spawned gloo ranks (``mp.get_context("spawn")``, a ``file://``
store under ``tmp_path``, one thread each) are the four stages; each
runs ``tests/torch_pipeline_cases.port_worker``: the stack of
``tests/test_pipeline.py`` (8 tanh layers of width 16, a batch of 12,
NumPy-seeded) at 2, 3 and 6 microbatches.  Every rank's output is held
to the serial stack at ``rtol = atol = 2e-5`` (the reference's test),
and is bit for bit the serial stack run microbatch by microbatch (the
same ops on the same shapes) on every rank (the final all-reduce adds
zeros to the last stage's buffer).  A JAX subprocess with 4 host devices
runs the reference's ``pipeline_forward`` on the same weights, held to
the port at the same tolerance.  Both start together; about 15 s.
"""
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

import torch_pipeline_cases as cases  # noqa: E402

WORLD = 4
JOIN_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(TESTS.parent / "src"), str(TESTS)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import torch_pipeline_cases as c; "
         f"c.jax_main({str(out / 'jax.npz')!r})"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=cases.port_worker,
                         args=(r, WORLD, str(out / "store"), str(out)))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    try:
        for p in ranks:
            p.join(JOIN_S)
        alive = [p.pid for p in ranks if p.is_alive()]
        assert not alive and [p.exitcode for p in ranks] == [0] * WORLD, (
            alive, [p.exitcode for p in ranks])
        try:
            err = jax_proc.communicate(timeout=JOIN_S)[1]
        except subprocess.TimeoutExpired:
            jax_proc.kill()
            err = jax_proc.communicate()[1] + "\n(timed out)"
        assert jax_proc.returncode == 0, err[-3000:]
        yield ([dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)],
               dict(np.load(out / "jax.npz")))
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
            p.join(10)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()


@pytest.mark.parametrize("m", cases.MICROBATCHES)
def test_pipeline_matches_serial(runs, m):
    port, _ = runs
    for rank, res in enumerate(port):
        np.testing.assert_allclose(res[f"pipe{m}"], res["serial"],
                                   rtol=2e-5, atol=2e-5, err_msg=str(rank))
        np.testing.assert_array_equal(res[f"pipe{m}"], res[f"serial_mb{m}"])
        np.testing.assert_array_equal(res[f"pipe{m}"], port[0][f"pipe{m}"])


@pytest.mark.parametrize("m", cases.MICROBATCHES)
def test_pipeline_matches_reference(runs, m):
    port, ref = runs
    assert ref[f"pipe{m}"].shape == (cases.B, cases.D)
    np.testing.assert_allclose(port[0][f"pipe{m}"], ref[f"pipe{m}"],
                               rtol=2e-5, atol=2e-5)


def test_one_stage_and_the_checks(tmp_path):
    # a gloo group of one rank in process: the pipeline is the serial
    # stack microbatch by microbatch, bit for bit; bad splits raise
    import torch
    import torch.distributed as dist
    from repro_torch.runtime.pipeline import pipeline_forward
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            world_size=1, rank=0)
    try:
        w, b, x = (torch.from_numpy(a) for a in cases.weights())

        def layer_apply(p, h):
            return torch.tanh(h @ p["w"] + p["b"])
        got = pipeline_forward({"w": w, "b": b}, x, layer_apply,
                               n_microbatches=3)
        want = x.clone()
        for i in range(cases.L):
            want = torch.cat([layer_apply({"w": w[i], "b": b[i]}, c)
                              for c in want.chunk(3)])
        assert torch.equal(got, want)
        # the same on a 1-D mesh of the group, and this host's mesh
        from repro_torch.launch.mesh import make_local_mesh, make_mesh
        stage = make_mesh((1,), ("stage",), device="cpu")
        assert torch.equal(pipeline_forward({"w": w, "b": b}, x, layer_apply,
                                            mesh=stage, n_microbatches=3),
                           want)
        local = make_local_mesh(device="cpu")
        assert local.mesh_dim_names == ("data", "model")
        assert tuple(local.shape) == (1, 1)
        with pytest.raises(ValueError, match="1-D"):
            pipeline_forward({"w": w}, x, layer_apply, mesh=local,
                             n_microbatches=1)
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_forward({"w": w}, x, layer_apply, n_microbatches=5)
        with pytest.raises(ValueError, match="group or a mesh"):
            pipeline_forward({"w": w}, x, layer_apply, group=object(),
                             mesh=object(), n_microbatches=1)
    finally:
        dist.destroy_process_group()
