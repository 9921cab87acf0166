#!/usr/bin/env python3
"""The distributed global BA at the flagship map's capacity on the card:
the port of tools/scaling_bench.py.

    python3 tools/torch_scaling_bench.py [--mesh 1 2 4 8] [--iters 4]
                                         [--device cpu] [--small]

Runs graft_entry_torch.make_gba_problem(256, 20000, 16) (256 000 point
edges; --small: K=34, L=300, M=2, the CG branch still) through
parallel/dist_ba.distributed_ba_solve on meshes of each --mesh size: the
real cards where torch.cuda.device_count() has that many, else cuda:0
repeated (one card: the cost of sharding, not scaling; ["cpu"] * n on the
CPU). For each mesh: one warm-up solve, then a timed one (every device of
the mesh synchronized before each clock read), its LM iterations per
second and chi2, and the host edge partition (partition_edges_by_point)
timed on its own. At this problem the CG stops before its first step
(its preconditioned residual starts below 1e-8 of the right-hand side's
square: camera blocks up to 2e18), so an LM iteration is the Schur
build, the back-substitution and the chi2, not a CG solve.

JAX's latency / bandwidth model (scaling_bench.py:59-100) is not carried
over: its constants are TPU interconnect figures and a TPU iteration time.
Prints the card's name and power limit first and one JSON object last.
Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import time

from torch_prof_common import parser, report, start, sync

SMALL = (34, 300, 2)


def mesh_devices(dev, n):
    """n entries: the first n cards where there are that many, else the
    device repeated."""
    import torch

    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return [str(dev)] * n


def main(argv=None) -> dict:
    import torch

    import graft_entry_torch as tg
    from orb_slam2_aruco_tpu_torch.parallel import dist_ba

    ap = parser(__doc__)
    ap.add_argument("--mesh", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    dev, card = start(args.device)
    K, L, M = SMALL if args.small else (tg.GBA_K, tg.GBA_L, tg.GBA_M)
    prob, cam = tg.make_gba_problem(K, L, M, device=dev)
    E = int(prob.e_kf.shape[0])
    print(f"problem: K={K} L={L} M={M} E={E}", flush=True)
    rows, out = {}, []
    for n in args.mesh:
        mesh = dist_ba.make_mesh(devices=mesh_devices(dev, n))
        devs = {torch.device(d) for d in mesh}

        def solve():
            res = dist_ba.distributed_ba_solve(prob, cam, mesh,
                                               iters=args.iters)
            for d in devs:
                sync(d)
            return res

        solve()
        t0 = time.perf_counter()
        res = solve()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist_ba.partition_edges_by_point(prob, n)
        part_ms = (time.perf_counter() - t0) * 1e3
        rate = args.iters / seconds
        rows[f"mesh={n} ({len(devs)} device(s)) ms per LM iteration"] = (
            1e3 / rate)
        out.append(dict(n=n, devices=[str(d) for d in mesh],
                        iters_per_s=rate, ms_per_iter=1e3 / rate,
                        chi2=float(res.chi2), partition_ms=part_ms))
        print(f"mesh={n:2d}: {rate:7.2f} LM iters/s (chi2 "
              f"{float(res.chi2):.6g}), partition {part_ms:.1f} ms on the "
              f"host", flush=True)
    return report(rows, {"card": card, "small": args.small,
                         "problem": dict(K=K, L=L, M=M, E=E),
                         "iters": args.iters, "meshes": out}, width=46)


if __name__ == "__main__":
    main()
