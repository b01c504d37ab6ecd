"""The port's fault-tolerant training runtime (``repro_torch.runtime``)
and its launchers, against the JAX package's.

Three ``Trainer`` steps against the reference ``Trainer`` from the same
parameters (each test replaces ``init_state``, so both start from the
reference's ``init_params`` tree), in float32: losses within 1e-4,
parameters within lr/10 absolute (AdamW's first steps divide by
|g| + eps; in bf16 the forward's rounding moves 0.6 % of them by up to
1.9e-3).  The
reference's Trainer ignores ``grad_accum`` (ROADMAP Queue 3 item P): so
does the port's, pinned on a ``grad_accum = 2`` config.  Restarted runs
(one and two injected failures, sync and async checkpoints, 2 shards)
are bit for bit the uninterrupted run, as the reference asserts for its
own; a checkpoint of the port's trainer is the reference's layout (the
reference's ``restore`` reads it into its own state).  Also the launcher
``python -m repro_torch.launch.train --smoke --device cpu`` and its
refusal to fall back to the CPU, the ``launch.serve`` forwarder's
warning, and ``examples/train_tiny_lm_torch.py`` at a few steps.
"""
import dataclasses
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.sharded import restore as ref_restore  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.optim import AdamWConfig as RAdamW  # noqa: E402
from repro.optim import adamw_init as r_adamw_init  # noqa: E402
from repro.runtime.trainer import Trainer as RTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as RTrainerConfig  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.convert import lm_params_to_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.trainer import (SimulatedFailure,  # noqa: E402
                                         Trainer, TrainerConfig)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_smoke(arch), remat=False, **over),
            dataclasses.replace(get_smoke_config(arch), remat=False, **over))


def _ref_params(rc):
    return jax.tree.map(np.asarray, T.init_params(rc, jax.random.PRNGKey(0)))


def _port_trainer(tmp, pc, ckpt_every=2, **tkw):
    return Trainer(pc, AdamWConfig(**OPT),
                   TrainerConfig(ckpt_dir=str(tmp), ckpt_every=ckpt_every,
                                 **tkw),
                   DataConfig(vocab=pc.vocab, seq_len=16, global_batch=4),
                   device="cpu")


def _ref_trainer(tmp, rc, ckpt_every=2):
    return RTrainer(rc, RAdamW(**OPT),
                    RTrainerConfig(ckpt_dir=str(tmp), ckpt_every=ckpt_every),
                    RDataConfig(vocab=rc.vocab, seq_len=16, global_batch=4))


def _from_reference(trainer, pc, tree):
    def init_state():
        model = lm_params_from_numpy(pc, tree, "cpu")
        return model, adamw_init(dict(model.named_parameters()))
    trainer.init_state = init_state
    return trainer


def _run_pair(tmp_path, arch, n_steps, **over):
    rc, pc = _cfgs(arch, dtype="float32", **over)
    tree = _ref_params(rc)
    rtr = _ref_trainer(tmp_path / "ref", rc)
    rtr.init_state = lambda: (tree, r_adamw_init(tree))
    rl, pl = [], []
    rp, _, _ = rtr.run(n_steps, on_step=lambda s, m: rl.append(
        float(m["loss"])))
    ptr = _from_reference(_port_trainer(tmp_path / "port", pc), pc, tree)
    model, _, _ = ptr.run(n_steps, on_step=lambda s, m: pl.append(
        float(m["loss"])))
    return rl, pl, rp, lm_params_to_numpy(pc, model)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "zamba2_2_7b"])
def test_three_trainer_steps_match_reference(tmp_path, arch):
    rl, pl, rp, pp = _run_pair(tmp_path, arch, 3)
    np.testing.assert_allclose(pl, rl, rtol=TOL, atol=TOL)
    for w, g in zip(jax.tree.leaves(rp), jax.tree.leaves(pp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=OPT["lr"] / 10)


def test_trainer_ignores_grad_accum_as_the_reference(tmp_path):
    """ROADMAP Queue 3 item P: both Trainers take one monolithic step on
    a ``grad_accum = 2`` config."""
    rl, pl, rp, pp = _run_pair(tmp_path, "qwen2_0_5b", 1, grad_accum=2)
    np.testing.assert_allclose(pl, rl, rtol=TOL, atol=TOL)
    for w, g in zip(jax.tree.leaves(rp), jax.tree.leaves(pp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=OPT["lr"] / 10)
    mono = _run_pair(tmp_path / "mono", "qwen2_0_5b", 1)
    assert pl == mono[1]
    for a, b in zip(jax.tree.leaves(pp), jax.tree.leaves(mono[3])):
        np.testing.assert_array_equal(a, b)


def test_trainer_loss_decreases(tmp_path):
    _, pc = _cfgs("qwen2_0_5b")
    losses = []
    _port_trainer(tmp_path, pc).run(
        8, on_step=lambda s, m: losses.append(float(m["loss"])))
    assert losses[-1] < losses[0]


def _assert_states_equal(a, b):
    (pa, oa, ma), (pb, ob, mb) = a, b
    for (n, x), (_, y) in zip(pa.named_parameters(), pb.named_parameters()):
        assert torch.equal(x, y), n
    for k in ("m", "v"):
        assert all(torch.equal(oa[k][n], ob[k][n]) for n in oa[k])
    assert torch.equal(oa["step"], ob["step"])
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("arch,n,every,failures,tkw", [
    ("qwen2_0_5b", 7, 2, (5,), {}),
    ("qwen2_0_5b", 9, 3, (4, 8), {}),
    ("zamba2_2_7b", 5, 2, (3,), {"n_ckpt_shards": 2, "async_ckpt": True}),
    ("deepseek_v2_236b", 4, 2, (3,), {"n_ckpt_shards": 3}),
], ids=["one-failure", "two-failures", "hybrid-async-2-shards",
        "moe-3-shards"])
def test_failure_restart_is_bit_identical(tmp_path, arch, n, every,
                                          failures, tkw):
    _, pc = _cfgs(arch)
    straight = _port_trainer(tmp_path / "a", pc, every, **tkw).run(n)
    restarted = _port_trainer(tmp_path / "b", pc, every,
                              **tkw).run_resilient(n, failures=failures)
    _assert_states_equal(straight, restarted)


def test_injected_failure_raises_and_leaves_a_checkpoint(tmp_path):
    _, pc = _cfgs("qwen2_0_5b")
    tr = _port_trainer(tmp_path, pc, 2)
    with pytest.raises(SimulatedFailure, match="step 3"):
        tr.run(5, failure_at=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000002"]


def test_port_trainer_checkpoint_is_the_reference_layout(tmp_path):
    rc, pc = _cfgs("zamba2_2_7b")
    model, opt, _ = _port_trainer(tmp_path, pc, 2).run(2)
    tree = _ref_params(rc)
    got = ref_restore(tmp_path, 2, {"params": tree,
                                    "opt": r_adamw_init(tree)})
    want = lm_params_to_numpy(pc, model)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert int(got["opt"]["step"]) == 2


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_train_cli_smoke_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--smoke", "--steps", "12", "--batch", "4",
         "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
         "--fail-at", "7", "--device", "cpu"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    steps = re.findall(r"^step +(\d+) loss ([\d.]+) lr \S+ gnorm [\d.]+ "
                       r"\(\d+ tok/s\)$", out.stdout, re.M)
    assert [int(s) for s, _ in steps] == [0, 10, 11]
    assert re.search(r"^final loss [\d.]+ wall [\d.]+s$", out.stdout, re.M)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000005", "step_0000010", "step_0000012"]


def test_train_cli_does_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "1", "--ckpt-dir",
         str(tmp_path)], env=_env(), cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_lm_serve_rename_stub_warns_and_forwards():
    import repro_torch.launch.lm_serve as lm
    sys.modules.pop("repro_torch.launch.serve", None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        import repro_torch.launch.serve as stub
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)
           and "lm_serve" in str(x.message)]
    assert dep and all(x.filename == __file__ for x in dep)
    assert stub.main is lm.main


def test_train_tiny_lm_example_on_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_tiny_lm_torch.py"),
         "--device", "cpu", "--steps", "25", "--seq", "32",
         "--fail-at", "21"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "survived injected failure + restart" in out.stdout
