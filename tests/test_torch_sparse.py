"""Port parity for the DDM-planned block-sparse attention path.

The port's planner (``repro_torch.sparse.planner``) is held bit for bit
against the JAX package's on the same plans, and the plain version of
kernel K7 (``repro_torch.kernels.ref.sparse_attn_bh``, which the
wrappers take for CPU tensors) against the float64 dense masked
attention under the token mask of the JAX planner's windows.  The JAX
Pallas kernel cannot be the oracle: on JAX 0.9.0 it raises on
``pl.load`` before it runs.  A numpy transcription of that kernel's
loop pins the rows that meet no allowed key ("mean of v").
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sparse import planner as jplanner  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import sparse_attn as tsa  # noqa: E402
from repro_torch.sparse import planner as tplanner  # noqa: E402

NEG_INF = np.float32(-1e30)

# (seq, window, bq, bkv, sink) of tests/test_sparse_attention.py:44,63
# and its batched plan (:89), Zamba2-2.7B's SMOKE attention at S = 256
# (configs/zamba2_2_7b.py), and a window narrower than a q block
# without a sink, where rows meet no allowed key
PLANS = [
    (256, 64, 32, 32, 1),
    (512, 128, 64, 32, 2),
    (128, 512, 32, 32, 0),
    (256, 96, 64, 32, 0),
    (128, 1024, 32, 32, 1),
    (128, 64, 32, 32, 1),
    (256, 64, 16, 16, 1),
    (128, 32, 64, 32, 0),
]


def _plans(case):
    seq, window, bq, bkv, sink = case
    return (jplanner.BlockPlan(seq, bq, bkv, window, sink),
            tplanner.BlockPlan(seq, bq, bkv, window, sink))


# -- the two oracle functions below are copied from the JAX package's
# -- tests/test_sparse_attention.py (dense_masked_attention, :17, and
# -- token_mask_from_plan, :28), the latter on the JAX planner's windows

def dense_masked_attention(q, k, v, allowed):
    scores = (q.astype(np.float64) @ k.astype(np.float64).T
              ) / np.sqrt(q.shape[-1])
    scores = np.where(allowed, scores, -np.inf)
    w = np.exp(scores - scores.max(axis=-1, keepdims=True))
    w = np.where(np.isfinite(scores), w, 0.0)
    denom = w.sum(axis=-1, keepdims=True)
    denom = np.where(denom > 0, denom, 1.0)
    return (w / denom) @ v.astype(np.float64)


def token_mask_from_plan(plan) -> np.ndarray:
    """(S, S) token-level mask implied by the plan (window+sink+causal)."""
    S = plan.seq_len
    qp = np.arange(S)[:, None]
    kp = np.arange(S)[None, :]
    causal = kp <= qp
    starts, ends = jplanner.block_windows(plan)
    qb = np.arange(S) // plan.block_q
    win = (kp >= starts[qb][:, None]) & (kp < ends[qb][:, None])
    sink = kp < plan.sink_end
    return causal & (win | sink)


def reference_loop(q, k, v, starts, ends, *, bq, bkv, sink_end, tile=None,
                   round_p=False):
    """numpy transcription of the JAX package's K7 body
    (``kernels/sparse_attn.py:31-81``) for one head, in float32.  Keys
    at or past Skv are not there (the port's rule at the ragged edge,
    where the TPU kernel's clamped slice would shift its keys).

    ``tile`` walks the sink range and the window range in key tiles of
    that size instead of ``bkv`` blocks, as the CUDA kernel does (64);
    ``round_p`` rounds the weights P to bfloat16 before P·V while the row
    sums stay unrounded, as its bfloat16 tensor-core path does."""
    Sq, dh = q.shape
    Skv = k.shape[0]
    out = np.zeros((Sq, dh), np.float32)
    scale = np.float32(dh ** -0.5)
    for i in range(Sq // bq):
        qi = q[i * bq:(i + 1) * bq].astype(np.float32) * scale
        q_pos = i * bq + np.arange(bq)
        end = int(ends[i])
        acc = np.zeros((bq, dh), np.float32)
        m = np.full(bq, NEG_INF, np.float32)
        l = np.zeros(bq, np.float32)

        def attend(kv_off, width, top, acc, m, l):
            kv_pos = kv_off + np.arange(width)
            there = kv_pos < top
            kb = np.zeros((width, dh), np.float32)
            vb = np.zeros((width, dh), np.float32)
            kb[there] = k[kv_pos[there]]
            vb[there] = v[kv_pos[there]]
            s = qi @ kb.T
            ok = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] < end)
            s = np.where(ok, s, NEG_INF)
            m2 = np.maximum(m, s.max(axis=1))
            alpha = np.exp(m - m2)
            p = np.exp(s - m2[:, None]) * there[None, :]
            pv = _bf16(p) if round_p else p
            return acc * alpha[:, None] + pv @ vb, m2, l * alpha + p.sum(1)

        start_blk = max(int(starts[i]), sink_end) // bkv
        nblk = max((end - start_blk * bkv + bkv - 1) // bkv, 0)
        for lo, hi in ((0, sink_end // bkv * bkv),
                       (start_blk * bkv, (start_blk + nblk) * bkv)):
            top = min(hi, Skv)
            step = tile or bkv
            for off in range(lo, top, step):
                acc, m, l = attend(off, step, top, acc, m, l)
        safe_l = np.where(l > 0, l, 1.0).astype(np.float32)
        out[i * bq:(i + 1) * bq] = acc / safe_l[:, None]
    return out


def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _qkv(seed, *shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# -- planner ----------------------------------------------------------------

@pytest.mark.parametrize("case", PLANS)
def test_block_plan_properties_match(case):
    jplan, tplan = _plans(case)
    assert (tplan.nq, tplan.nkv, tplan.sink_end) == \
        (jplan.nq, jplan.nkv, jplan.sink_end)


@pytest.mark.parametrize("case", PLANS)
def test_block_windows_bit_equal(case):
    jplan, tplan = _plans(case)
    js, je = jplanner.block_windows(jplan)
    ts, te = tplanner.block_windows(tplan, device="cpu")
    assert ts.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(te.numpy(), je)


@pytest.mark.parametrize("case", PLANS)
def test_block_bitmask_equal(case):
    jplan, tplan = _plans(case)
    got = tplanner.block_bitmask(tplan, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), jplanner.block_bitmask(jplan))


def test_block_windows_are_the_arithmetic_hull_at_zamba2_width():
    # Zamba2-2.7B: window 4096, 128-token blocks, one sink block; S cut
    # from 32,768 to 8,192 for the CPU
    plan = tplanner.BlockPlan(8192, 128, 128, 4096, 1)
    starts, ends = tplanner.block_windows(plan, device="cpu")
    end = (np.arange(plan.nq) + 1) * 128
    np.testing.assert_array_equal(ends.numpy(), end)
    np.testing.assert_array_equal(starts.numpy(),
                                  np.maximum(0, end - 4096) // 128 * 128)


def test_decode_window_matches_reference():
    jplan, tplan = _plans((4096, 512, 128, 128, 1))
    for pos in (0, 100, 511, 512, 4000):
        assert tplanner.decode_window(pos, tplan) == \
            jplanner.decode_window(pos, jplan)


# -- K7's plain version against the dense masked oracle -----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,window,bq,bkv,sink", [
    (256, 64, 32, 32, 1),
    (256, 96, 64, 32, 0),
    (128, 1024, 32, 32, 1),
])
def test_sparse_attn_1h_matches_dense_masked(dtype, seq, window, bq, bkv,
                                             sink):
    jplan = jplanner.BlockPlan(seq, bq, bkv, window, sink)
    starts, ends = jplanner.block_windows(jplan)
    q, k, v = _qkv(3, seq, 64)
    got = tsa.sparse_attn_1h(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             torch.from_numpy(starts), torch.from_numpy(ends),
                             bq=bq, bkv=bkv, sink_end=jplan.sink_end)
    assert got.dtype == dtype and got.shape == (seq, 64)
    want = dense_masked_attention(q, k, v, token_mask_from_plan(jplan))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_attn_batched_heads_matches_dense_masked(dtype):
    jplan = jplanner.BlockPlan(128, 32, 32, 64, 1)
    starts, ends = jplanner.block_windows(jplan)
    B, H, dh = 2, 3, 32
    q, k, v = _qkv(5, B, 128, H, dh)
    out = tsa.sparse_attn(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          torch.from_numpy(starts), torch.from_numpy(ends),
                          bq=32, bkv=32, sink_end=jplan.sink_end)
    assert out.shape == (B, 128, H, dh) and out.dtype == dtype
    allowed = token_mask_from_plan(jplan)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for b in range(B):
        for h in range(H):
            want = dense_masked_attention(q[b, :, h], k[b, :, h],
                                          v[b, :, h], allowed)
            np.testing.assert_allclose(out[b, :, h].double().numpy(), want,
                                       rtol=tol, atol=tol)


def test_zamba2_smoke_attention_matches_dense_masked():
    # Zamba2-2.7B's SMOKE attention: 4 heads of 16, window 64, blocks of 16
    jplan, tplan = _plans((256, 64, 16, 16, 1))
    starts, ends = tplanner.block_windows(tplan, device="cpu")
    q, k, v = _qkv(11, 1, 256, 4, 16)
    out = tsa.sparse_attn(_t(q), _t(k), _t(v), starts, ends, bq=16, bkv=16,
                          sink_end=tplan.sink_end)
    allowed = token_mask_from_plan(jplan)
    for h in range(4):
        want = dense_masked_attention(q[0, :, h], k[0, :, h], v[0, :, h],
                                      allowed)
        np.testing.assert_allclose(out[0, :, h].double().numpy(), want,
                                   rtol=2e-5, atol=2e-5)


# -- K7's plain version against the transcribed reference loop ----------------

@pytest.mark.parametrize("seq,bq,bkv,window,sink_end,skv", [
    (128, 64, 32, 32, 0, 128),      # rows that meet no allowed key
    (256, 32, 32, 64, 32, 256),
    (224, 32, 64, 96, 100, 224),    # S % bkv != 0, sink_end % bkv != 0
    (240, 48, 32, 80, 40, 240),     # bq not a power of two
    (192, 64, 128, 128, 128, 200),  # Skv > Sq, bkv > bq
])
@pytest.mark.parametrize("chunk", [None, 1])
def test_plain_matches_reference_loop(monkeypatch, seq, bq, bkv, window,
                                      sink_end, skv, chunk):
    if chunk is not None:               # one q block per chunk
        monkeypatch.setattr(ref, "_ATTN_CHUNK", chunk)
    plan = tplanner.BlockPlan(seq, bq, bkv, window, 0)
    starts, ends = tplanner.block_windows(plan, device="cpu")
    rng = np.random.default_rng(seq + bq)
    q = rng.normal(size=(seq, 24)).astype(np.float32)
    k = rng.normal(size=(skv, 24)).astype(np.float32)
    v = rng.normal(size=(skv, 24)).astype(np.float32)
    got = tsa.sparse_attn_1h(_t(q), _t(k), _t(v), starts, ends, bq=bq,
                             bkv=bkv, sink_end=sink_end)
    want = reference_loop(q, k, v, starts.numpy(), ends.numpy(), bq=bq,
                          bkv=bkv, sink_end=sink_end)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# K7's bfloat16 arithmetic on the CPU: the kernel's 64-key tiles and P
# rounded to bf16 before P·V, on bf16 inputs, against the float32 plain
# version.  Without the rounding the tiles change nothing (2e-5); with
# it, and the output rounded to bf16 as the kernel writes it, every
# element stays within sparse_attn.BF16_TOL's bound
# atol + ptol·plain(|v|) + rtol·|want| and the relative RMS within rms.
@pytest.mark.parametrize("seq,bq,bkv,window,sink_end,skv", [
    (128, 64, 32, 32, 0, 128),      # the "mean of v" rows
    (256, 32, 32, 64, 32, 256),
    (224, 32, 64, 96, 100, 224),    # S % bkv != 0, sink_end % bkv != 0
    (512, 128, 128, 256, 128, 512),  # Zamba2's blocks, cut
    (192, 64, 128, 128, 128, 200),  # Skv > Sq, bkv > bq
])
@pytest.mark.parametrize("round_p", [False, True])
def test_bf16_kernel_arithmetic_within_the_stated_tolerance(
        seq, bq, bkv, window, sink_end, skv, round_p):
    plan = tplanner.BlockPlan(seq, bq, bkv, window, 0)
    starts, ends = tplanner.block_windows(plan, device="cpu")
    rng = np.random.default_rng(seq + skv)
    q = _bf16(rng.normal(size=(seq, 40)))
    k = _bf16(rng.normal(size=(skv, 40)))
    v = _bf16(rng.normal(size=(skv, 40)))
    kw = dict(bq=bq, bkv=bkv, sink_end=sink_end)
    want = tsa.sparse_attn_1h(_t(q), _t(k), _t(v), starts, ends,
                              **kw).numpy()
    got = reference_loop(q, k, v, starts.numpy(), ends.numpy(), tile=64,
                         round_p=round_p, **kw)
    if not round_p:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    got = _bf16(got)
    want_abs_v = tsa.sparse_attn_1h(_t(q), _t(k), _t(np.abs(v)), starts,
                                    ends, **kw).numpy()
    tol = tsa.BF16_TOL
    diff = np.abs(got - want)
    lim = tol["atol"] + tol["ptol"] * want_abs_v + tol["rtol"] * np.abs(want)
    assert (diff <= lim).all(), (diff - lim).max()
    assert np.linalg.norm(diff) <= tol["rms"] * np.linalg.norm(want)
    # the rounding of P alone stays within the ptol term: bf16's unit
    # roundoff 2^-8 times sum(p·|v|) / l
    unrounded = reference_loop(q, k, v, starts.numpy(), ends.numpy(),
                               tile=64, **kw)
    p_only = np.abs(reference_loop(q, k, v, starts.numpy(), ends.numpy(),
                                   tile=64, round_p=True, **kw) - unrounded)
    assert (p_only <= 1e-6 + tol["ptol"] * want_abs_v).all()


def test_rows_without_an_allowed_key_get_the_mean_of_v():
    # windows [32, 64) and [96, 128): queries 0..31 and 64..95 walk one
    # kv block whose keys all lie after them
    plan = tplanner.BlockPlan(128, 64, 32, 32, 0)
    starts, ends = tplanner.block_windows(plan, device="cpu")
    np.testing.assert_array_equal(starts.numpy(), [32, 96])
    np.testing.assert_array_equal(ends.numpy(), [64, 128])
    q, k, v = _qkv(7, 128, 16)
    got = tsa.sparse_attn_1h(_t(q), _t(k), _t(v), starts, ends, bq=64,
                             bkv=32).numpy()
    want = reference_loop(q, k, v, starts.numpy(), ends.numpy(), bq=64,
                          bkv=32, sink_end=0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:32], np.broadcast_to(
        v[32:64].mean(0), (32, 16)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[64:96], np.broadcast_to(
        v[96:128].mean(0), (32, 16)), rtol=2e-5, atol=2e-5)
    # the dense oracle gives those rows 0: the reference's K7 and its
    # oracle differ there, and the port follows the kernel
    jplan = jplanner.BlockPlan(128, 64, 32, 32, 0)
    with np.errstate(invalid="ignore"):     # the oracle's all -inf rows
        dense = dense_masked_attention(q, k, v, token_mask_from_plan(jplan))
    assert np.abs(dense[:32]).max() == 0.0
    np.testing.assert_allclose(got[32:64], dense[32:64], rtol=2e-5,
                               atol=2e-5)


def test_sink_keys_past_the_last_whole_sink_block_are_dropped():
    # sink_end 100 with bkv 64: the walk takes 100 // 64 = 1 sink block
    # (keys 0..63), and the window walk starts at max(start, 100) // 64.
    # Q blocks 2 and 3 have the windows [128, 192) and [192, 256), so no
    # walk reads the sink keys 64..99 for them: the reference's K7 drops
    # them there, and the port follows it (ROADMAP Queue 3 item B)
    S, bq, sink_end = 256, 64, 100
    plan = tplanner.BlockPlan(S, bq, bq, 64, 0)
    starts, ends = tplanner.block_windows(plan, device="cpu")
    np.testing.assert_array_equal(starts.numpy(), [0, 64, 128, 192])
    np.testing.assert_array_equal(ends.numpy(), [64, 128, 192, 256])
    q, k, v = _qkv(9, S, 16)
    got = tsa.sparse_attn_1h(_t(q), _t(k), _t(v), starts, ends, bq=bq,
                             bkv=bq, sink_end=sink_end).numpy()
    want = reference_loop(q, k, v, starts.numpy(), ends.numpy(), bq=bq,
                          bkv=bq, sink_end=sink_end)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    qb = np.arange(S) // bq
    win = ((kp >= starts.numpy()[qb][:, None])
           & (kp < ends.numpy()[qb][:, None]))

    def dense(sink):
        allowed = (kp <= qp) & (win | (kp < sink))
        return dense_masked_attention(q, k, v, allowed)

    whole, dropped = dense(sink_end), dense(sink_end // bq * bq)
    # q blocks 0 and 1 see every allowed key: keys 64..99 lie after
    # block 0's queries and inside block 1's window
    np.testing.assert_allclose(got[:128], whole[:128], rtol=2e-5, atol=2e-5)
    # q blocks 2 and 3 match the oracle without keys 64..99, and miss the
    # oracle with the whole sink [0, 100)
    np.testing.assert_allclose(got[128:], dropped[128:], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(got[128:] - whole[128:]).max() > 0.1


# -- wrapper checks -----------------------------------------------------------

def _ok_args(S=64, dh=16, bq=32):
    q, k, v = (_t(x) for x in _qkv(1, S, dh))
    nq = S // bq
    starts = torch.zeros(nq, dtype=torch.int32)
    ends = torch.arange(1, nq + 1, dtype=torch.int32) * bq
    return q, k, v, starts, ends


def test_wrapper_accepts_the_good_arguments():
    q, k, v, starts, ends = _ok_args()
    assert tsa.sparse_attn_1h(q, k, v, starts, ends, bq=32, bkv=32).shape \
        == (64, 16)


@pytest.mark.parametrize("bad,match", [
    ("sq_bq", "Sq % bq"),
    ("starts_shape", "starts must be"),
    ("ends_shape", "ends must be"),
    ("ends_dtype", "int32"),
    ("mixed_types", "float32 or all"),
    ("int_type", "float32 or all"),
    ("dh_8", "multiple of 8"),
    ("dh_264", "multiple of 8"),
    ("ends_past_s", "ends must be <="),
    ("kv_shape", "k and v must be"),
    ("noncontiguous", "contiguous"),
    ("bkv", "bkv >= 1"),
])
def test_wrapper_rejects(bad, match):
    q, k, v, starts, ends = _ok_args()
    kw = dict(bq=32, bkv=32)
    if bad == "sq_bq":
        kw["bq"] = 24
    elif bad == "starts_shape":
        starts = starts[:1]
    elif bad == "ends_shape":
        ends = torch.cat([ends, ends])
    elif bad == "ends_dtype":
        ends = ends.long()
    elif bad == "mixed_types":
        k = k.to(torch.bfloat16)
    elif bad == "int_type":
        q, k, v = (x.to(torch.float16) for x in (q, k, v))
    elif bad == "dh_8":
        q, k, v = (_t(x) for x in _qkv(1, 64, 12))
    elif bad == "dh_264":
        q, k, v = (_t(x) for x in _qkv(1, 64, 264))
    elif bad == "ends_past_s":
        ends = ends.clone()
        ends[-1] = 65
    elif bad == "kv_shape":
        v = v[:32].contiguous()
    elif bad == "noncontiguous":
        q = _t(_qkv(1, 16, 64)[0]).t()
    elif bad == "bkv":
        kw["bkv"] = 0
    with pytest.raises(ValueError, match=match):
        tsa.sparse_attn_1h(q, k, v, starts, ends, **kw)


def test_wrapper_reads_ends_again_after_an_edit_or_a_shorter_skv():
    # ends <= Skv is read once per windows tensor: an edit in place, or
    # the same windows against shorter keys, is read again and refused
    q, k, v, starts, ends = _ok_args()
    kw = dict(bq=32, bkv=32)
    tsa.sparse_attn_1h(q, k, v, starts, ends, **kw)
    tsa.sparse_attn_1h(q, k, v, starts, ends, **kw)
    with pytest.raises(ValueError, match="ends must be <="):
        tsa.sparse_attn_1h(q, k[:48].contiguous(), v[:48].contiguous(),
                           starts, ends, **kw)
    ends[-1] = 65
    with pytest.raises(ValueError, match="ends must be <="):
        tsa.sparse_attn_1h(q, k, v, starts, ends, **kw)


def test_batched_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="one \\(B, S, H, dh\\) shape"):
        tsa.sparse_attn(q, q[:, :32].contiguous(), q,
                        torch.zeros(2, dtype=torch.int32),
                        torch.full((2,), 32, dtype=torch.int32), bq=32)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-card error cannot occur")
    plan = tplanner.BlockPlan(256, 32, 32, 64, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.block_windows(plan)
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.block_bitmask(plan)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("sparse_attn")
    # a tensor off the CPU never takes the plain version
    q = torch.zeros(64, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.sparse_attn_1h(q, q, q, torch.zeros(2, dtype=torch.int32,
                                                device="meta"),
                           torch.zeros(2, dtype=torch.int32, device="meta"),
                           bq=32, bkv=32)
    before = tsa.sparse_attn_bh.launches
    q, k, v, starts, ends = _ok_args()
    tsa.sparse_attn_1h(q, k, v, starts, ends, bq=32, bkv=32)
    assert tsa.sparse_attn_bh.launches == before
