"""K1's single-pass scan, transcribed to numpy and held to the plain sweep.

``csrc/sbm_sweep.cu`` computes the SBM sweep in one launch: each CTA
takes the next tile index from a counter; each warp loads a contiguous
span of the tile, lane l's vector q holding the four endpoints at
``128·q + 4·l`` (int4 loads, or one by one when the arrays do not start
on 16 bytes), each endpoint kept as a 3-bit code; the two deltas ride
packed in one int32 (``upd + sub·2^16``) through a warp scan of the
vectors' sums and the warp totals; warp 0 publishes the tile's
aggregate and looks back over the predecessors' three 64-bit descriptor
words 32 tiles a step, adding aggregates until it meets a published
inclusive prefix; then it publishes its own prefix and every thread
writes its counts.

The card cannot be reached here, so ``Launch`` below follows the kernel
step by step, each CTA a generator that yields wherever another CTA may
run in between, and a scheduler runs the CTAs in chosen completion
orders: one after another, all aggregates first and the look-backs from
the last tile down (every window then steps over 32 aggregates), and
random interleavings in which some predecessors have published only an
aggregate, some an inclusive prefix and some nothing yet (a spin).  The
result is held to ``ref.sbm_sweep`` (the port's plain version) and to
the JAX package's K1 (``repro.kernels.sbm_sweep.sbm_sweep`` in
interpret mode, fed the sub-lo sentinel padding as
``tests/test_torch_kernels.py`` does).  A small tile (2 warps of 4
endpoints) keeps it cheap and reaches the deep look-backs; the kernel's
own tile, read from the source, runs the paper stream.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import sbm_sweep as jsweep  # noqa: E402

from repro_torch.core import make_regions, paper_workload  # noqa: E402
from repro_torch.core import sbm as tsbm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

WARP = 32
VALID = 1 << 32                        # csrc/sbm_sweep.cu's descriptor flag
SMALL = (64, 4)                        # (threads a CTA, endpoints a thread)
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "sbm_sweep.cu")


def kernel_shape():
    """(default SBM_SWEEP_BLOCK, SBM_SWEEP_ITEMS) of csrc/sbm_sweep.cu."""
    src = SOURCE.read_text()
    block = int(re.search(r"#define SBM_SWEEP_BLOCK (\d+)", src).group(1))
    items = int(re.search(r"#define SBM_SWEEP_ITEMS (\d+)", src).group(1))
    return block, items


def short(v):
    """The low 16 bits of ``v`` as a signed value (``static_cast<short>``)."""
    return ((v & 0xffff) ^ 0x8000) - 0x8000


def int32(v):
    """The low 32 bits of ``v`` as a signed value."""
    return ((v & 0xffffffff) ^ 0x80000000) - 0x80000000


def unpack(v):
    """(upd, sub) of a packed ``upd + sub·2^16``."""
    upd = short(v)
    return upd, (v - upd) >> 16


def packed_delta(c):
    """The packed (d_upd, d_sub) of an endpoint code (bit 0 is_lo, bit 1
    is_upd, bit 2 inside n)."""
    sign = 2 * (c & 1) - 1
    return (sign if c & 2 else sign * 65536) if c & 4 else 0


def warp_inclusive(v):
    """The shuffle scan: ``__shfl_up_sync`` by 1, 2, 4, 8 and 16."""
    o = 1
    while o < WARP:
        v = [a + v[i - o] if i >= o else a for i, a in enumerate(v)]
        o <<= 1
    return v


class Launch:
    """One launch of K1 on ``x[offset:]`` for the flag buffers ``lo_buf``
    and ``up_buf``: the zeroed scratch (counter and descriptor words), the
    output and counts of what the look-backs met."""

    def __init__(self, lo_buf, up_buf, offset, block, items):
        self.lo, self.up = lo_buf.tolist(), up_buf.tolist()
        self.off = offset
        self.n = len(self.lo) - offset
        self.block, self.items = block, items
        self.tile = block * items
        ntiles = -(-self.n // self.tile)
        self.ntiles = ntiles
        # the C entry's instance: int4 loads when every array starts on
        # 16 bytes (the output always does: the wrapper places it so)
        self.vec = offset % 4 == 0
        self.counter = 0                       # the memset zeroes all
        self.agg = [0] * ntiles
        self.pre_upd = [0] * ntiles
        self.pre_sub = [0] * ntiles
        self.out = [None] * self.n
        self.seen = dict(spins=0, steps=0, mixed=0, prefix_first=0)

    def load4(self, i):
        """The four endpoint codes at ``i``: an int4 pair for a whole
        vector of the vector instance, else one by one, masked past n."""
        b = self.off + i
        if self.vec and i + 4 <= self.n:
            lo, up, inside = self.lo[b:b + 4], self.up[b:b + 4], [1] * 4
        else:
            inside = [int(i + e < self.n) for e in range(4)]
            lo = [self.lo[b + e] if inside[e] else 0 for e in range(4)]
            up = [self.up[b + e] if inside[e] else 0 for e in range(4)]
        return [lo[e] | up[e] << 1 | inside[e] << 2 for e in range(4)]

    def cta(self):
        """One CTA, yielding where another CTA may run in between."""
        tile = self.counter                    # atomicAdd(scratch, 1)
        self.counter += 1
        yield
        vecs = self.items // 4
        warps = self.block // WARP
        at = [[tile * self.tile + w * WARP * self.items + 4 * lane
               for lane in range(WARP)] for w in range(warps)]
        code = [[[self.load4(at[w][lane] + 128 * q) for q in range(vecs)]
                 for lane in range(WARP)] for w in range(warps)]
        part = [[[sum(map(packed_delta, code[w][lane][q]))
                  for q in range(vecs)] for lane in range(WARP)]
                for w in range(warps)]
        warp_total = [0] * warps
        for w in range(warps):
            for q in range(vecs):
                incl = warp_inclusive([part[w][lane][q]
                                       for lane in range(WARP)])
                for lane in range(WARP):
                    part[w][lane][q] = (warp_total[w] + incl[lane]
                                        - part[w][lane][q])
                warp_total[w] += incl[WARP - 1]
        agg = unpack(sum(warp_total))

        prefix = (0, 0)
        if tile > 0:
            self.agg[tile] = (VALID | (agg[0] & 0xffff) << 16
                              | agg[1] & 0xffff)
            yield
            base = tile - 1
            while True:                        # look_back, warp 0
                p = [base - lane for lane in range(WARP)]
                is_pre = [q < 0 or bool(self.pre_upd[q] & self.pre_sub[q]
                                        & VALID) for q in p]
                is_agg = [q >= 0 and bool(self.agg[q] & VALID) for q in p]
                if not all(a or b for a, b in zip(is_pre, is_agg)):
                    self.seen["spins"] += 1    # __any_sync: spin
                    yield
                    continue
                stop = is_pre.index(True) if any(is_pre) else WARP
                for lane in range(min(stop + 1, WARP)):
                    q = p[lane]
                    if q < 0:
                        continue
                    v = ((int32(self.pre_upd[q]), int32(self.pre_sub[q]))
                         if is_pre[lane] else (short(self.agg[q] >> 16),
                                               short(self.agg[q])))
                    prefix = (prefix[0] + v[0], prefix[1] + v[1])
                if any(is_pre):
                    self.seen["mixed" if stop else "prefix_first"] += 1
                    break
                self.seen["steps"] += 1
                base -= WARP
                yield
        inc = (prefix[0] + agg[0], prefix[1] + agg[1])
        self.pre_upd[tile] = VALID | inc[0] & 0xffffffff
        self.pre_sub[tile] = VALID | inc[1] & 0xffffffff
        yield
        for w in range(warps):
            before = sum(warp_total[:w])
            for lane in range(WARP):
                for q in range(vecs):
                    off = unpack(before + part[w][lane][q])
                    run = [prefix[0] + off[0], prefix[1] + off[1]]
                    i = at[w][lane] + 128 * q
                    for e, c in enumerate(code[w][lane][q]):
                        d = unpack(packed_delta(c))
                        run = [run[0] + d[0], run[1] + d[1]]
                        if i + e < self.n:         # masked store
                            self.out[i + e] = (0 if c & 1 else
                                               run[1] if c & 2 else run[0])

    def result(self):
        assert None not in self.out
        assert self.counter == self.ntiles
        return np.array(self.out, np.int64)


def run(launch, order):
    """Run every CTA of ``launch`` to its end in ``order``: ``in_order``,
    ``reverse`` (all aggregates first, then the look-backs from the last
    tile down) or ``random<seed>``; returns the counts."""
    ctas = []
    if order == "in_order":
        for _ in range(launch.ntiles):
            for _ in launch.cta():
                pass
    elif order == "reverse":
        for _ in range(launch.ntiles):
            g = launch.cta()
            next(g)                            # the tile index
            next(g, None)                      # aggregate (tile 0: prefix)
            ctas.append(g)
        for g in reversed(ctas):
            for _ in g:
                pass
    else:
        rng = np.random.default_rng(int(order[6:]))
        resident, started = [], 0
        while resident or started < launch.ntiles:
            if started < launch.ntiles and (len(resident) < 24
                                            and rng.random() < 0.3
                                            or not resident):
                resident.append(launch.cta())
                started += 1
                continue
            g = resident[rng.integers(len(resident))]
            if next(g, StopIteration) is StopIteration:
                resident.remove(g)
    return launch.result()


def _sub_lo_padded_jax_k1(is_lo, is_upd, block=8192):
    """The JAX package's K1 in interpret mode on the stream, padded with
    sub-lo sentinels (is_lo = 1, is_upd = 0) to a whole block."""
    pad = (-is_lo.size) % block
    out = jsweep.sbm_sweep(
        jnp.pad(jnp.asarray(is_lo), (0, pad), constant_values=1),
        jnp.pad(jnp.asarray(is_upd), (0, pad)), block=block, interpret=True)
    return np.asarray(out)[:is_lo.size]


def _stream(case):
    """(is_lo, is_upd) int32 numpy flags of a named case."""
    tile = SMALL[0] * SMALL[1]
    sizes = {"T1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
             "3tile+5": 3 * tile + 5, "random": 5000}
    if case in sizes:                  # arbitrary 0/1 flags: prefixes < 0
        rng = np.random.default_rng(sizes[case])
        return (rng.integers(0, 2, sizes[case]).astype(np.int32),
                rng.integers(0, 2, sizes[case]).astype(np.int32))
    if case == "paper20k":
        S, U = paper_workload(3, 20_000, 100.0, device="cpu")
    else:                              # all subscriptions, no update
        rng = np.random.default_rng(17)
        lo = rng.uniform(0, 1e4, 3000).astype(np.float32)
        S = make_regions(lo, lo + rng.uniform(0, 50, 3000).astype(
            np.float32), "cpu")
        U = make_regions(np.zeros(0, np.float32),
                              np.zeros(0, np.float32), "cpu")
    is_lo, is_upd = tsbm._endpoint_stream(S.lo[:, 0], S.hi[:, 0],
                                          U.lo[:, 0], U.hi[:, 0])
    return is_lo.numpy(), is_upd.numpy()


@functools.lru_cache(maxsize=None)
def _case(case):
    """The case's flags, the plain sweep and the JAX package's K1."""
    is_lo, is_upd = _stream(case)
    plain = ref.sbm_sweep(torch.from_numpy(is_lo),
                          torch.from_numpy(is_upd)).numpy()
    jax_k1 = _sub_lo_padded_jax_k1(is_lo, is_upd)
    np.testing.assert_array_equal(plain, jax_k1)
    return is_lo, is_upd, plain


CASES = ["T1", "tile-1", "tile", "tile+1", "3tile+5", "paper20k", "random",
         "all_sub"]
ORDERS = ["in_order", "reverse", "random0", "random1"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", CASES)
def test_transcribed_scan_matches_plain_and_jax_k1(case, order):
    is_lo, is_upd, plain = _case(case)
    # offset 0: the int4 instance; offset 1: a view off 16 bytes, the
    # scalar instance (the random orders take it, the others the vector)
    offset = 1 if order.startswith("random") else 0
    head = np.zeros(offset, np.int32)
    launch = Launch(np.concatenate([head, is_lo]),
                    np.concatenate([head, is_upd]), offset, *SMALL)
    got = run(launch, order)
    assert launch.vec == (offset == 0)
    np.testing.assert_array_equal(got, plain)
    if case == "all_sub":
        assert (is_upd == 0).all() and (plain == 0).all()
    if case == "random":
        sub = np.cumsum((1 - is_upd) * (2 * is_lo - 1))
        assert sub.min() < 0        # the prefixes go negative


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_scalar_and_vector_instances_agree_at_every_head(offset):
    # a ragged tail too: the last tile's chunks are partly masked
    is_lo, is_upd, plain = _case("3tile+5")
    head = np.ones(offset, np.int32)
    launch = Launch(np.concatenate([head, is_lo]),
                    np.concatenate([head, is_upd]), offset, *SMALL)
    np.testing.assert_array_equal(run(launch, "random2"), plain)


@pytest.mark.parametrize("order", ["in_order", "random3"])
def test_kernel_tile_on_the_paper_stream(order):
    block, items = kernel_shape()
    assert block % WARP == 0 and items % 4 == 0 and block * items <= 1 << 14
    is_lo, is_upd, plain = _case("paper20k")
    launch = Launch(is_lo, is_upd, 0, block, items)
    assert launch.ntiles == -(-is_lo.size // (block * items))
    np.testing.assert_array_equal(run(launch, order), plain)


def test_orders_reach_every_look_back_case():
    is_lo, is_upd, plain = _case("paper20k")
    seen = {}
    for order in ORDERS:
        launch = Launch(is_lo, is_upd, 0, *SMALL)
        np.testing.assert_array_equal(run(launch, order), plain)
        seen[order] = launch.seen
    # one after another: every look-back meets its predecessor's prefix
    assert seen["in_order"]["prefix_first"] == launch.ntiles - 1
    assert seen["in_order"]["mixed"] == seen["in_order"]["spins"] == 0
    # all aggregates first: the windows step over 32 aggregates at a time
    assert seen["reverse"]["steps"] > 0 and seen["reverse"]["spins"] == 0
    # interleaved: waits on unpublished tiles, windows that add
    # aggregates before the prefix they stop at
    for order in ("random0", "random1"):
        assert seen[order]["spins"] > 0 and seen[order]["mixed"] > 0
