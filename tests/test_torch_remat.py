"""The port's remat inside a layer: ``chunked_sdpa`` checkpoints each
query chunk, and the MoE's dense form each top-k slot, as the JAX
package's ``jax.checkpoint`` of ``one_chunk_body``
(``models/attention.py``) and of ``one_slot`` (``models/moe.py``) do.

* ``chunked_sdpa``'s gradients are bit for bit those of the
  un-checkpointed loop of its chunk function (``remat_call`` replaced by
  a direct call, which is the loop as it was before the checkpoint) on the
  arguments that four sites pass it in a smoke model's forward at
  ``q_chunk`` 8 < S 24: GQA (qwen3, two query heads a kv head), MLA's
  expanded read (DeepSeek-V2), the audio cross attention (Whisper, 32
  frames) and Zamba2's shared block (a window of 12 and a sink of 4),
  in float32 and bfloat16.  (The loss and every gradient of all ten
  smoke configs at that ``q_chunk`` against ``jax.value_and_grad``:
  ``tests/test_torch_lm_train.py``.)
* The dense MoE's gradients with and without the per-slot checkpoint
  (``_dense_slots`` with ``remat_call`` replaced the same way) are
  bit-equal, and through ``moe_apply`` they are within the float32
  tolerance of ``tests/test_torch_lm_moe.py`` (1e-5) of the index form's
  and of ``jax.grad`` of the reference's ``moe_apply``.
* What one call leaves for its backward (the bytes of the tensors
  autograd saves, by storage, besides the call's inputs), read with
  ``saved_tensors_hooks``: at 8 query chunks at most one chunk's (B, H,
  G, q_chunk, Skv) float32 block, where the un-checkpointed loop keeps
  at least 8; for the MoE at most one slot's (G, gt, E, C) dispatch,
  where the loop keeps at least k.  And inside an outer checkpoint (the
  forward's per-layer remat), the peak of the live storages that the
  dry run's ``Tracker`` counts on fake tensors over the forward and
  backward stays below 8 chunks' blocks, which the loop reaches.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as RM  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.dryrun import Tracker  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

B, S, Q_CHUNK = 2, 24, 8
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def _remat(on: bool):
    """As the port runs (a checkpoint a query chunk and a slot), or, with
    ``on`` False, with ``remat_call`` replaced in ``attention`` and
    ``moe`` by a direct call: the un-checkpointed loops."""
    with pytest.MonkeyPatch.context() as mp:
        if not on:
            for mod in (PA, PM):
                mp.setattr(mod, "remat_call", lambda fn, *args: fn(*args))
        yield

# site: (arch, config overrides, which of the forward's chunked_sdpa
# calls is the site's)
SITES = {
    "gqa": ("qwen3_14b", {}, lambda q, k, kw: True),
    "mla_expanded": ("deepseek_v2_236b", {}, lambda q, k, kw: True),
    "audio_cross": ("whisper_medium", {},
                    lambda q, k, kw: q.shape[1] != k.shape[1]),
    "zamba2_shared": ("zamba2_2_7b", {"window": 12, "n_sink_blocks": 1,
                                      "block_kv": 4},
                      lambda q, k, kw: kw.get("window", 0) > 0),
}


def _site_call(site, dtype):
    """The arguments of the first ``chunked_sdpa`` call of the site in a
    smoke model's forward at ``q_chunk`` 8 over S 24 tokens."""
    arch, over, pick = SITES[site]
    cfg = dataclasses.replace(get_smoke_config(arch), q_chunk=Q_CHUNK,
                              dtype=dtype, **over)
    model = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    frames = None
    if cfg.family == "audio":
        frames = torch.from_numpy(0.1 * rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    calls = []
    orig = PA.chunked_sdpa

    def record(q, k, v, *args, **kw):
        calls.append((q, k, v, args, kw))
        return orig(q, k, v, *args, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(PA, "chunked_sdpa", record)
    mp.setattr(PT, "chunked_sdpa", record)
    try:
        with torch.no_grad():
            PT.forward(model, tokens, cfg, frames=frames)
    finally:
        mp.undo()
    return next(c for c in calls if pick(c[0], c[1], c[4]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("site", SITES)
def test_chunked_sdpa_remat_gradients_are_bit_equal(site, dtype):
    q0, k0, v0, args, kw = _site_call(site, dtype)
    assert q0.shape[1] == S and q0.dtype == DTYPES[dtype]
    assert kw["q_chunk"] == Q_CHUNK
    if site == "audio_cross":
        assert k0.shape[1] == 32 and kw["causal"] is False
    if site == "zamba2_shared":
        assert (kw["window"], kw["sink"]) == (12, 4)
    if site == "mla_expanded":
        assert q0.shape[3] == 1 and q0.shape[-1] != v0.shape[-1]
    rng = np.random.default_rng(6)
    outs = []
    for remat in (True, False):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q0, k0, v0))
        with _remat(remat):
            out = PA.chunked_sdpa(q, k, v, *args, **kw)
            cot = torch.from_numpy(rng.standard_normal(out.shape).astype(
                np.float32)).to(out.dtype) if not outs else outs[0][1]
            grads = torch.autograd.grad((out * cot).sum(), (q, k, v))
        outs.append((out, cot, grads))
    (o1, _, g1), (o0, _, g0) = outs
    assert torch.equal(o1, o0)
    for a, b in zip(g1, g0):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert bool(a.abs().sum() > 0)


# --- the MoE's dense form ----------------------------------------------------

MOE_CASES = {"shared": ("deepseek_v2_236b", 1024, {}),
             "drops": ("phi3_5_moe_42b", 8, {"capacity_factor": 1.0})}


def _moe(case, **extra):
    arch, gt, over = MOE_CASES[case]
    over = {**over, **extra}
    ref_cfg = dataclasses.replace(ref_smoke(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    tree = jax.tree.map(np.asarray, RM.moe_init(jax.random.PRNGKey(3),
                                                ref_cfg))
    p = PM.moe_init(cfg, generator=None, device="cpu")
    with torch.no_grad():
        for name, param in p.named_parameters():
            node = tree
            for key in name.split("."):
                node = node[key]
            param.copy_(torch.from_numpy(np.array(node, np.float32)))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, tree, p, x, cot, gt


def _slot_inputs(p, cfg, x, gt):
    """(xg, vals, idx, C) as ``moe_apply`` hands them to ``_dense_slots``."""
    gt = PM.group_size(S, gt)
    xg = x.reshape(-1, gt, cfg.d_model)
    vals, idx, _ = PM._route(p, xg, cfg)
    C = max(4, int(np.ceil(gt / cfg.n_experts * cfg.capacity_factor)))
    return xg, vals, idx, C


@pytest.mark.parametrize("case", MOE_CASES)
def test_dense_slots_remat_gradients_are_bit_equal(case):
    _, cfg, _, p, x, cot, gt = _moe(case)
    res = []
    for remat in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        xg, vals, idx, C = _slot_inputs(p, cfg, xt, gt)
        wrt = (xt, p.w_gate, p.w_up, p.w_down, p.router.w)
        with _remat(remat):
            out = PM._dense_slots(p, xg, vals, idx, cfg.n_experts, C,
                                  torch.float32)
            grads = torch.autograd.grad(
                (out.reshape(x.shape) * torch.from_numpy(cot)).sum(), wrt)
        res.append((out, grads))
    (o1, g1), (o0, g0) = res
    assert torch.equal(o1, o0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("case", MOE_CASES)
def test_dense_moe_gradients_match_index_form_and_reference(case):
    ref_cfg, cfg, tree, p, x, cot, gt = _moe(case)
    tol = 1e-5

    def ref_loss(tree, x):
        y, aux = RM.moe_apply(tree, x, ref_cfg, group_tokens=gt)
        return jnp.sum(y * cot) + aux
    want_gx, want_gt = jax.grad(ref_loss, argnums=(1, 0))(tree, jnp.asarray(x))
    want_gt = jax.tree.map(np.asarray, want_gt)
    names = ("w_gate", "w_up", "w_down", "router.w")
    got = {}
    for form in ("dense", "index"):
        xt = torch.from_numpy(x).requires_grad_()
        with PM.use_form(form):
            y, aux = PM.moe_apply(p, xt, cfg, group_tokens=gt)
        params = [p.get_parameter(n) for n in names]
        grads = torch.autograd.grad(
            (y * torch.from_numpy(cot)).sum() + aux, [xt, *params])
        got[form] = dict(zip(("x",) + names, grads))
    for name in ("x",) + names:
        want = (np.asarray(want_gx) if name == "x" else
                want_gt["router"]["w"] if name == "router.w"
                else want_gt[name])
        for form in ("dense", "index"):
            np.testing.assert_allclose(got[form][name].numpy(), want,
                                       rtol=tol, atol=tol,
                                       err_msg=f"{form} {name}")
        np.testing.assert_allclose(got["dense"][name].numpy(),
                                   got["index"][name].numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


# --- what a call leaves for its backward -------------------------------------

def _saved_bytes(fn, inputs, remat: bool) -> int:
    """Bytes of the distinct storages that autograd saves while ``fn``
    runs under ``_remat(remat)``, besides those of ``inputs``."""
    skip = {t.untyped_storage().data_ptr() for t in inputs}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t
    with _remat(remat), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = fn()
    del out
    return sum(seen.values())


def _attn_inputs(Sq=64, Skv=64, H=2, G=2, dh=2):
    rng = np.random.default_rng(7)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()
    q, k, v = leaf(1, Sq, H, G, dh), leaf(1, Skv, H, dh), leaf(1, Skv, H, dh)
    block = 1 * H * G * Q_CHUNK * Skv * 4
    return q, k, v, torch.arange(Sq), block


def test_chunked_sdpa_saves_at_most_one_chunk_block():
    q, k, v, pos, block = _attn_inputs()
    assert q.shape[1] // Q_CHUNK == 8
    got = {remat: _saved_bytes(lambda: PA.chunked_sdpa(
        q, k, v, pos, 64, q_chunk=Q_CHUNK), (q, k, v, pos), remat)
        for remat in (True, False)}
    assert got[True] <= block
    assert got[False] >= 8 * block


def test_dense_slots_save_at_most_one_slot_dispatch():
    _, cfg, _, p, x, _, gt = _moe("drops", top_k=4)
    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        xg, vals, idx, C = _slot_inputs(p, cfg, xt, gt)
    xg, vals = xg.detach().requires_grad_(), vals.detach().requires_grad_()
    G, k, E = xg.shape[0], idx.shape[-1], cfg.n_experts
    dispatch = G * xg.shape[1] * E * C * 4
    assert k == 4
    inputs = (xg, vals, idx, *p.parameters())
    got = {remat: _saved_bytes(lambda: PM._dense_slots(
        p, xg, vals, idx, E, C, torch.float32), inputs, remat)
        for remat in (True, False)}
    assert got[True] <= dispatch
    assert got[False] >= k * dispatch


def test_nested_remat_peak_stays_below_the_loops():
    # chunked_sdpa inside an outer checkpoint, on fake tensors: the
    # outer recompute in the backward keeps one chunk's blocks at a time
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.layers import remat_call
    peaks = {}
    for remat in (True, False):
        with FakeTensorMode():
            q, k, v = (torch.empty(s, requires_grad=True) for s in
                       ((1, 64, 2, 2, 2), (1, 64, 2, 2), (1, 64, 2, 2)))
            pos = torch.arange(64)
            tracker = Tracker()
            tracker.add_arguments([q, k, v, pos])
            with tracker, _remat(remat):
                out = remat_call(lambda q, k, v: PA.chunked_sdpa(
                    q, k, v, pos, 64, q_chunk=Q_CHUNK), q, k, v)
                torch.autograd.grad(out.sum(), (q, k, v))
            peaks[remat] = tracker.peak
    block = 2 * 2 * Q_CHUNK * 64 * 4
    assert peaks[True] < 8 * block <= peaks[False]
