"""Quickstart on the PyTorch/CUDA port: the DDM matching service in five
minutes.

The port's twin of ``examples/quickstart.py``: the same steps and the
same printed numbers.  On the card (the default) the engine's ``cuda``
backend runs them through the hand-written kernels: bfm's tile counts
(K3), sbm's ``count()`` sweep (K1), ``pairs()``'s emit (K2), and the
interval-tree walk (K8) of itm and of the dynamic service.  Step 2 holds
the ``cuda`` backend's K to the plain ``torch`` backend's (the reference
holds its Pallas kernels in interpret mode).  With ``--device cpu`` the
kernels' plain versions stand in, and the last line says that no kernel
ran.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core import (DDMService, MatchSpec, build_plan,
                              make_regions, paper_workload, pairs_to_set)
from repro_torch.kernels import bfm, emit, itm, sbm_sweep
from repro_torch.sparse.planner import BlockPlan, block_windows

WRAPPERS = {"K1": sbm_sweep.sbm_sweep, "K2": emit.twopass_emit,
            "K3": bfm.bfm_tile_counts, "K8": itm.itm_walk}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the regions and plans live (default: cuda)")
    dev = ap.parse_args(argv).device
    for w in WRAPPERS.values():
        w.launches = 0

    # --- 1. the region matching problem (paper Fig. 3) ---------------------
    S = make_regions([[1.0, 1.0], [4.0, 0.5], [2.5, 2.0]],
                     [[3.0, 3.0], [6.0, 2.5], [5.0, 4.0]], dev)  # 3 subs
    U = make_regions([[2.0, 2.0], [4.5, 1.0]],
                     [[4.0, 4.0], [5.5, 3.0]], dev)              # 2 updates

    print("== 2-D matching: one engine, interchangeable algorithms ==")
    for algo in ("bfm", "sbm", "itm"):
        plan = build_plan(MatchSpec(algo=algo, device=dev), S.n, U.n, S.d)
        print(f"  {algo}: K = {plan.count(S, U)}")

    # plan once, call many: the plan is reusable
    plan = build_plan(MatchSpec(algo="sbm", capacity="exact", device=dev),
                      S.n, U.n, S.d)
    pairs, count = plan.pairs(S, U)
    print("  pairs:", sorted(pairs_to_set(pairs, U.n, S.n)),
          "(ids = s_idx *", U.n, "+ u_idx)")

    # --- 2. the paper's synthetic benchmark at small scale -----------------
    S1, U1 = paper_workload(seed=0, n_total=10_000, alpha=1.0, device=dev)
    plan1 = build_plan(MatchSpec(algo="sbm", device=dev), S1.n, U1.n, S1.d)
    k = plan1.count(S1, U1)
    print(f"\n== paper workload N=1e4 alpha=1: K = {k} "
          f"(E[K] ~ alpha*N/2 = {1.0 * 10_000 / 2:.0f}) ==")

    # backend is a config value: the same spec on the plain torch ops
    tplan = build_plan(MatchSpec(algo="sbm", backend="torch", device=dev),
                       S1.n, U1.n, S1.d)
    assert tplan.count(S1, U1) == k
    print("   cuda backend agrees with the torch backend")

    # --- 3. dynamic DDM (paper §3): move a region, get pair deltas ---------
    svc = DDMService(S1, U1, spec=MatchSpec(algo="itm", capacity="grow",
                                            max_pairs=64, device=dev))
    svc.connect()
    added, removed = svc.update_region("upd", 0, 100.0, 400.0)
    print(f"\n== dynamic update of one region: +{len(added)} / "
          f"-{len(removed)} overlap pairs ==")

    # --- 4. the same matcher planning block-sparse attention ---------------
    bplan = BlockPlan(seq_len=4096, block_q=128, block_kv=128, window=1024,
                      sink_blocks=1)
    starts, ends = block_windows(bplan, dev)
    print(f"\n== DDM as attention planner: {bplan.nq} query blocks, "
          f"window rows like q-block 16 -> "
          f"kv[{int(starts[16])}:{int(ends[16])}) ==")

    launches = {k: w.launches for k, w in WRAPPERS.items()}
    if any(launches.values()):
        print("\nkernel launches: " + " ".join(
            f"{k}={n}" for k, n in launches.items()))
    else:
        print("\nno kernel ran: the kernels' plain versions stood in "
              f"on {dev}")
    return launches


if __name__ == "__main__":
    main()
