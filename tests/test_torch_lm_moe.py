"""The port's MoE sublayer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe.moe_apply``.

The reference's parameters (``repro.models.moe.moe_init``) are copied
into the port's ``MoE`` by name, and the same NumPy-seeded activations
go through both, in float32 and bfloat16.  Cases: DeepSeek-V2's smoke
router with a shared expert, Phi-3.5-MoE's without; capacity_factor 1.0
with groups of 8 tokens on S 24, where tokens drop (the smoke configs'
16.0 never drops), with the inputs pulled toward one expert so that some
slot of some group overflows; a prime S above ``group_tokens``, which
the divisor rule splits into groups of one token; and a router with
duplicated columns, whose probabilities tie exactly, where the port must
pick ``jax.lax.top_k``'s experts (the lower index first).  Each case
checks the output, the aux loss, and the routing the port logs
(``MoE.route_log``) against the reference's own top-k and the ranks its
one-hot cumsum gives: the same experts and the same dropped (token,
slot) assignments.  The reference runs op by op (not jitted), so it
rounds every bf16 intermediate where its code says.  Tolerances: float32
1e-5, bfloat16 the reference's 5e-2 (the experts' products sum in
another order); the aux loss 1e-6.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as RM  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B = 2

# name: (arch, S, group_tokens, config overrides, input kind)
CASES = {
    "shared": ("deepseek_v2_236b", 24, 1024, {}, "plain"),
    "no_shared": ("phi3_5_moe_42b", 24, 1024, {}, "plain"),
    "drops": ("deepseek_v2_236b", 24, 8, {"capacity_factor": 1.0},
              "skewed"),
    "prime_s": ("phi3_5_moe_42b", 11, 8, {"capacity_factor": 1.0}, "plain"),
    "ties": ("deepseek_v2_236b", 24, 1024, {}, "tied"),
}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def port_moe(cfg, tree) -> PM.MoE:
    """The port's MoE holding the reference's parameter tree."""
    p = PM.moe_init(cfg, generator=None, device="cpu")
    for name, param in p.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        arr = np.array(node, np.float32)
        assert arr.shape == tuple(param.shape), name
        param.copy_(torch.from_numpy(arr))
    assert sum(t.numel() for t in p.parameters()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(tree))
    return p


def _setup(case):
    arch, S, gt, over, kind = CASES[case]
    ref_cfg = dataclasses.replace(ref_smoke(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    tree = jax.tree.map(np.asarray, RM.moe_init(jax.random.PRNGKey(3),
                                                ref_cfg))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if kind == "skewed":
        # every token leans toward one router column: its expert is the
        # first choice of most tokens, more than C = 4 of a group's 8
        w = tree["router"]["w"]
        u = w[:, 0] / np.linalg.norm(w[:, 0])
        x = x + 4.0 * u[None, None, :].astype(np.float32)
    if kind == "tied":
        # experts 2j and 2j+1 share a router column: equal probabilities
        w = tree["router"]["w"].copy()
        w[:, 1::2] = w[:, 0::2]
        tree["router"]["w"] = w
    return ref_cfg, cfg, tree, x, gt


def _ref_routing(tree, xg, cfg, dt):
    """The reference's top-k (``jax.lax.top_k``) and, per slot, its
    capacity rule: (idx (G,gt,k), keep (G,gt,k))."""
    logits = (xg @ jnp.asarray(tree["router"]["w"]).astype(dt)).astype(
        jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    idx = np.asarray(idx)
    gt = idx.shape[1]
    C = max(4, math.ceil(gt / cfg.n_experts * cfg.capacity_factor))
    one = idx[..., None] == np.arange(cfg.n_experts)
    rank = np.cumsum(one, axis=1) - 1
    return idx, (rank * one).sum(-1) < C


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_reference(case, dtype):
    ref_cfg, cfg, tree, x, gt = _setup(case)
    jd, td, tol = DTYPES[dtype]
    want, want_aux = RM.moe_apply(tree, jnp.asarray(x).astype(jd), ref_cfg,
                                  group_tokens=gt)
    p = port_moe(cfg, tree)
    assert (p.shared is None) == (cfg.n_shared_experts == 0)
    p.route_log = []
    got, got_aux = PM.moe_apply(p, torch.from_numpy(x).to(td), cfg,
                                group_tokens=gt)
    assert got.dtype == td and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    (log,) = p.route_log
    G = log["idx"].shape[0]
    xg = jnp.asarray(x).astype(jd).reshape(G, -1, cfg.d_model)
    idx, keep = _ref_routing(tree, xg, cfg, jd)
    np.testing.assert_array_equal(log["idx"].numpy(), idx)
    np.testing.assert_array_equal(log["keep"].numpy(), keep)
    S = x.shape[1]
    if case == "drops":
        assert G == B * 3 and not keep.all()
    elif case == "prime_s":
        assert log["idx"].shape == (B * S, 1, cfg.top_k) and keep.all()
    elif case == "ties":
        # every token's two picks are a tied pair, lower index first
        assert (idx[..., 1] == idx[..., 0] + 1).all()
        assert (idx[..., 0] % 2 == 0).all()


def test_dropped_assignments_contribute_zero():
    # a token dropped from every slot gets exactly the shared expert's
    # output; every other token gets something from its routed experts
    _, cfg, tree, x, gt = _setup("drops")
    p = port_moe(cfg, tree)
    p.route_log = []
    y, _ = PM.moe_apply(p, torch.from_numpy(x), cfg, group_tokens=gt)
    keep = p.route_log[0]["keep"].reshape(B, -1, cfg.top_k)
    shared = PM.mlp_apply(p.shared, torch.from_numpy(x), torch.float32)
    gone = ~keep.any(dim=-1)
    moe_part = y - shared
    assert gone.any()
    assert bool((moe_part[gone] == 0).all())
    assert bool((moe_part[~gone].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("S,gt,want", [(24, 1024, 24), (24, 8, 8),
                                       (11, 8, 1), (1040, 1024, 520),
                                       (1031, 1024, 1), (1, 1024, 1)])
def test_group_size_is_the_reference_divisor_rule(S, gt, want):
    assert PM.group_size(S, gt) == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_dense_form_matches_index_form_and_reference(case, dtype):
    # the reference's one-hot capacity dispatch (``form="dense"``, what
    # the dry run traces) against the index form and the reference, at
    # the same tolerances; the dense form logs the same routing
    ref_cfg, cfg, tree, x, gt = _setup(case)
    jd, td, tol = DTYPES[dtype]
    want, want_aux = RM.moe_apply(tree, jnp.asarray(x).astype(jd), ref_cfg,
                                  group_tokens=gt)
    p = port_moe(cfg, tree)
    xt = torch.from_numpy(x).to(td)
    p.route_log = []
    idx_y, idx_aux = PM.moe_apply(p, xt, cfg, group_tokens=gt)
    with PM.use_form("dense"):
        dense_y, dense_aux = PM.moe_apply(p, xt, cfg, group_tokens=gt)
    assert dense_y.dtype == td and dense_y.shape == x.shape
    for got in (dense_y, idx_y):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(dense_y.float().numpy(),
                               idx_y.float().numpy(), rtol=tol, atol=tol)
    assert float(dense_aux) == float(idx_aux)
    np.testing.assert_allclose(float(dense_aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)
    index_log, dense_log = p.route_log
    for k in ("idx", "keep"):
        assert torch.equal(index_log[k], dense_log[k])


def test_moe_form_is_checked():
    _, cfg, tree, x, gt = _setup("shared")
    p = port_moe(cfg, tree)
    with pytest.raises(ValueError, match="MoE form"):
        with PM.use_form("sparse"):
            PM.moe_apply(p, torch.from_numpy(x), cfg)
