"""HLA-style road-traffic pub/sub simulation on the PyTorch/CUDA port.

The port's twin of ``examples/ddm_simulation.py`` (paper §1, Fig. 1):
vehicles move along a 2-D ring road (dimension 0 the position, dimension
1 the lane).  Each vehicle owns an update region around its position in
its own lane and a subscription region skewed toward its direction of
motion over its lane and the next; traffic lights own update regions
across every lane.  Every tick ALL vehicles move, and the DDM service
recomputes the overlap deltas with one batched ``update_regions`` call
per region kind, each one interval-tree query (kernel K8 on the card).

    PYTHONPATH=src python examples/ddm_simulation_torch.py            # card
    PYTHONPATH=src python examples/ddm_simulation_torch.py --device cpu

It ends by checking the incremental ledger against a from-scratch SBM
match of the final regions.
"""
import argparse

import numpy as np

from repro_torch.core import DDMService, MatchSpec, build_plan, make_regions

ROAD = 10_000.0
N_LANES = 4
N_VEHICLES = 120
N_LIGHTS = 12
TICKS = 20


def _vehicle_regions(pos, lane):
    """(sub_lo, sub_hi, upd_lo, upd_hi), each (n, 2), for vehicle state."""
    sub_lo = np.stack([pos - 10.0, lane - 1.0], axis=1)
    sub_hi = np.stack([pos + 80.0, lane + 2.0], axis=1)
    upd_lo = np.stack([pos - 15.0, lane + 0.0], axis=1)
    upd_hi = np.stack([pos + 15.0, lane + 1.0], axis=1)
    return sub_lo, sub_hi, upd_lo, upd_hi


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the regions, trees and queries live "
                         "(default: cuda)")
    ap.add_argument("--ticks", type=int, default=TICKS)
    args = ap.parse_args(argv)
    dev = args.device

    rng = np.random.default_rng(0)
    pos = rng.uniform(0, ROAD, N_VEHICLES)
    lane = rng.integers(0, N_LANES, N_VEHICLES).astype(np.float64)
    speed = rng.uniform(5.0, 25.0, N_VEHICLES)

    sub_lo, sub_hi, upd_lo, upd_hi = _vehicle_regions(pos, lane)
    # traffic lights: fixed 60 m bands across all lanes
    light_x = np.linspace(0, ROAD, N_LIGHTS)
    light_lo = np.stack([light_x - 30.0, np.zeros(N_LIGHTS)], axis=1)
    light_hi = np.stack([light_x + 30.0,
                         np.full(N_LIGHTS, float(N_LANES))], axis=1)

    spec = MatchSpec(algo="itm", capacity="grow", device=dev)
    svc = DDMService(make_regions(sub_lo, sub_hi, dev),
                     make_regions(np.concatenate([upd_lo, light_lo]),
                                  np.concatenate([upd_hi, light_hi]), dev),
                     spec=spec)
    pairs = svc.connect()
    print(f"tick  0: {len(pairs):4d} active (subscriber, publisher) "
          f"routes on {svc.device}")

    vehicle_ids = np.arange(N_VEHICLES)
    total_events = len(pairs)
    for tick in range(1, args.ticks + 1):
        pos = (pos + speed) % ROAD
        # occasional lane changes keep dimension 1 dynamic too
        switch = rng.random(N_VEHICLES) < 0.05
        lane = np.where(switch,
                        np.clip(lane + rng.choice([-1.0, 1.0],
                                                  N_VEHICLES), 0,
                                N_LANES - 1),
                        lane)
        sub_lo, sub_hi, upd_lo, upd_hi = _vehicle_regions(pos, lane)
        # one batched update per region kind — the whole tick's churn
        a1, r1 = svc.update_regions("sub", vehicle_ids, sub_lo, sub_hi)
        a2, r2 = svc.update_regions("upd", vehicle_ids, upd_lo, upd_hi)
        delta_add = len(a1) + len(a2)
        delta_rm = len(r1) + len(r2)
        total_events += delta_add
        print(f"tick {tick:2d}: {len(svc.pairs):4d} routes "
              f"(+{delta_add:3d}/-{delta_rm:3d} this tick)")

    # cross-check the incremental ledger against a from-scratch match
    S = make_regions(svc.s_lo, svc.s_hi, dev)
    U = make_regions(svc.u_lo, svc.u_hi, dev)
    k = build_plan(MatchSpec(algo="sbm", device=dev), S.n, U.n,
                   S.d).count(S, U)
    assert k == len(svc.pairs), (k, len(svc.pairs))
    print(f"\nledger == from-scratch SBM match ({k} routes); "
          f"{total_events} route-creation events delivered total")


if __name__ == "__main__":
    main()
