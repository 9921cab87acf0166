#!/usr/bin/env python3
"""localize_stream under tracking variants on the card against the bench
map: the port of tools/prof_loc_variants.py.

    python3 tools/torch_prof_loc_variants.py [--map BASE] [--reps R]
                                             [--n N] [--device cpu]
                                             [--small]

For each variant (prof_loc_variants.py:38-45: scan, chunk 16; extrapolate
with 2 passes, chunk 16; extrapolate with 1 pass, chunks 16 and 32): a
SlamSystem loads the map (data/ref_full.npz, or BASE.npz and the frames
of BASE_frames.npz from tools/torch_build_bench_map.py), enters
localization mode and tracks frame 0 (the prime); a warm-up stream of
min(chunk, N) frames; then R timed streams (4; 1 with --small) of N
frames (96; frame k = map frame k % the frames), each
localize_stream(StagedSource(batch=chunk), chunk=chunk) with two chunks
in flight (bench_torch.serve), its clock ending in a synchronize.
Reports ms per frame and fps of the best stream and the frames tracked
OK. A variant whose prime does not localize is reported with
"primed": false and not timed (the JAX tool skips it).

Prints the card's name and power limit first and one JSON object last.
Needs a CUDA GPU unless given --device cpu.
"""

from __future__ import annotations

import dataclasses

from torch_prof_common import parser, primed_system, report, scene, start

N, REPS = 96, 4
VARIANTS = (
    ("scan/16", {}, 16),
    ("extrap p2/16", dict(loc_seed_mode="extrapolate"), 16),
    ("extrap p1/16", dict(loc_seed_mode="extrapolate", loc_extrap_passes=1),
     16),
    ("extrap p1/32", dict(loc_seed_mode="extrapolate", loc_extrap_passes=1),
     32),
)


def main(argv=None) -> dict:
    import bench_torch

    ap = parser(__doc__, map_arg=True)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args(argv)
    dev, card = start(args.device)
    cfg0, frames, path = scene(dev, args.small, args.map)
    reps = args.reps or (1 if args.small else REPS)
    variants = {}
    for name, tweaks, chunk in VARIANTS:
        cfg = cfg0.replace(tracking=dataclasses.replace(cfg0.tracking,
                                                        **tweaks))
        system, pose = primed_system(cfg, frames, path, dev)
        if pose is None:
            print(f"{name}: the prime did not localize: not timed",
                  flush=True)
            variants[name] = {"primed": False, "chunk": chunk}
            continue
        bench_torch.serve(system, frames, min(chunk, args.n), chunk)
        best, ok = float("inf"), 0
        for _ in range(reps):
            run = bench_torch.serve(system, frames, args.n, chunk)
            if len(run["out"]) != args.n:
                raise RuntimeError(f"{name}: {len(run['out'])} of {args.n} "
                                   f"frames emitted")
            if run["seconds"] < best:
                best = run["seconds"]
                ok = sum(p is not None for _, p in run["out"])
        ms = best * 1e3 / args.n
        variants[name] = {"primed": True, "chunk": chunk,
                          "ms_per_frame": ms, "fps": args.n / best, "ok": ok,
                          "n": args.n}
        print(f"{name:28s}: {ms:8.2f} ms/frame "
              f"({args.n / best:6.1f} fps, {ok}/{args.n} ok)", flush=True)
    return report({}, {"card": card, "small": args.small, "n": args.n,
                       "reps": reps, "variants": variants})


if __name__ == "__main__":
    main()
