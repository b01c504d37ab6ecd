"""The port's MLA attention (``repro_torch.models.attention``) against the
JAX package's ``mla_apply``.

DeepSeek-V2's smoke config (kv_lora 32, rope 16, nope 16, v 16, q_lora
48) and the same with ``q_lora = 0`` (a plain ``wq``), on the
reference's parameters (``repro.models.attention.mla_init``) copied by
name and the same NumPy-seeded activations, in float32 and bfloat16: the
read without a cache (the expanded per-head K/V through
``chunked_sdpa``), a prefill that fills ``ckv`` (after ``kv_norm``) and
``krope`` (rotated as one head), then single-token decode steps through
the absorbed read (``mla_absorb``, the default: ``w_ukv``'s key half in
float32, its value half in the model dtype) and through the expanded
read, also under a window and sink.  The reference runs op by op, so it
rounds every bf16 intermediate where its code says.  Tolerances: float32
1e-5, bfloat16 the reference's 5e-2.  The absorbed decode is another
association of the expanded one's products; the reference's
``tests/test_models.py`` bounds their bf16 difference at 0.1, and so
does this file, with float32 at 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import attention as RA  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, S, N_PRE, MAX_LEN = 2, 16, 10, 20


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _configs(q_lora=48, **over):
    over["q_lora"] = q_lora
    return (dataclasses.replace(ref_smoke("deepseek_v2_236b"), **over),
            dataclasses.replace(get_smoke_config("deepseek_v2_236b"), **over))


def _port_mla(cfg, tree) -> PA.MLA:
    p = PA.mla_init(cfg, generator=None, device="cpu")
    for name, param in p.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        param.copy_(torch.from_numpy(np.array(node, np.float32)))
    assert sum(t.numel() for t in p.parameters()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(tree))
    return p


def _inputs(cfg):
    rng = np.random.default_rng(21)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _both(ref_cfg, cfg):
    tree = jax.tree.map(np.asarray, RA.mla_init(jax.random.PRNGKey(4),
                                                ref_cfg))
    return tree, _port_mla(cfg, tree)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("q_lora", [48, 0], ids=["q_lora", "wq"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_without_cache_matches_reference(dtype, q_lora):
    ref_cfg, cfg = _configs(q_lora)
    tree, p = _both(ref_cfg, cfg)
    assert (p.wq is None) == bool(q_lora) and p.w_ukv.compute == ()
    jd, td, _ = DTYPES[dtype]
    x = _inputs(cfg)
    want, _ = RA.mla_apply(tree, jnp.asarray(x).astype(jd), ref_cfg,
                           positions=jnp.arange(S))
    got, cache = PA.mla_apply(p, torch.from_numpy(x).to(td), cfg,
                              positions=torch.arange(S))
    assert cache is None and got.dtype == td
    _close(got, want, dtype)


def _decode_run(apply, p, x, cfg, cache, positions_of, frm):
    """Prefill x[:, :N_PRE] into ``cache``, then decode one token a step;
    the outputs stacked along S."""
    y, cache = apply(p, frm(x[:, :N_PRE]), cfg,
                     positions=positions_of(N_PRE, 0), cache=cache,
                     cur_len=0)
    outs = [y]
    for i in range(N_PRE, S):
        y, cache = apply(p, frm(x[:, i:i + 1]), cfg,
                         positions=positions_of(1, i), cache=cache,
                         cur_len=i)
        outs.append(y)
    return outs, cache


DECODE_CASES = {"absorbed": dict(mla_absorb=True),
                "expanded": dict(mla_absorb=False),
                "absorbed_window": dict(mla_absorb=True, window=6, sink=2),
                "expanded_window": dict(mla_absorb=False, window=6, sink=2)}


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_and_decode_match_reference(dtype, case):
    over = dict(DECODE_CASES[case])
    sparse = {k: over.pop(k) for k in ("window", "sink") if k in over}
    ref_cfg, cfg = _configs(**over)
    tree, p = _both(ref_cfg, cfg)
    jd, td, _ = DTYPES[dtype]
    x = _inputs(cfg)

    def ref_apply(pp, xx, c, **kw):
        return RA.mla_apply(pp, xx, c, **kw, **sparse)

    def port_apply(pp, xx, c, **kw):
        return PA.mla_apply(pp, xx, c, **kw, **sparse)
    want, want_cache = _decode_run(
        ref_apply, tree, x, ref_cfg,
        RA.mla_cache_init(ref_cfg, B, MAX_LEN, jd),
        lambda n, s: s + jnp.arange(n), lambda a: jnp.asarray(a).astype(jd))
    got, got_cache = _decode_run(
        port_apply, p, x, cfg, PA.mla_cache_init(cfg, B, MAX_LEN, td, "cpu"),
        lambda n, s: s + torch.arange(n), lambda a: torch.from_numpy(a).to(td))
    for g, w in zip(got, want):
        _close(g, w, dtype)
    assert set(got_cache) == {"ckv", "krope"}
    for key in ("ckv", "krope"):
        assert got_cache[key].dtype == td
        assert got_cache[key].shape == tuple(want_cache[key].shape)
        _close(got_cache[key], want_cache[key], dtype)
    assert not got_cache["ckv"][:, S:].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_absorbed_decode_against_expanded_decode(dtype):
    ref_cfg, absorbed = _configs()
    assert absorbed.mla_absorb
    expanded = dataclasses.replace(absorbed, mla_absorb=False)
    _, p = _both(ref_cfg, absorbed)
    td = DTYPES[dtype][1]
    x = _inputs(absorbed)
    outs = {}
    for name, c in (("absorbed", absorbed), ("expanded", expanded)):
        outs[name], _ = _decode_run(
            PA.mla_apply, p, x, c, PA.mla_cache_init(c, B, MAX_LEN, td, "cpu"),
            lambda n, s: s + torch.arange(n),
            lambda a: torch.from_numpy(a).to(td))
    bound = 0.1 if dtype == "bfloat16" else 1e-5
    for a, e in zip(outs["absorbed"][1:], outs["expanded"][1:]):
        assert float((a.float() - e.float()).abs().max()) < bound
    # the prefill is the expanded read in both
    assert torch.equal(outs["absorbed"][0], outs["expanded"][0])
