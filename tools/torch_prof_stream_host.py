#!/usr/bin/env python3
"""Host-side timing of localize_stream's chunk loop on the card: the port of
tools/prof_stream_host.py.

    python3 tools/torch_prof_stream_host.py [--device cpu] [--small]

On the bench map (data/ref_full.npz) in bench.py's serving form
(bench_torch.serving_mode: localization, extrapolate seeds, one pass),
after one relocalizing track_monocular, replays the port's
SlamSystem.localize_stream loop over N_CHUNKS chunks of CHUNK frames of the
bench sweep, one chunk in flight while the next is dispatched, with a
host clock around each of its sections, named after the port's code:

  staging    next(StagedSource.batches()): the producer thread's pinned
             host stack and its copy to the card on a side stream
  dispatch   SlamSystem._run_chunk (tracking.track_batch: every frame's
             make_frame and cascade queued) and _commit_chunk
  read prev  SlamSystem._read_chunk of the chunk before: the chunk's one
             control read, where the host waits for the device
  total      the loop's wall time per chunk (ending in a synchronize)

then chained chunks (prof_stream_host.py:103-160): each chunk dispatched
only after the previous one's control read, its wall time per chunk and
per frame, the least of N_CHUNKS. Prints the card's name and power limit
first and one JSON object last. Needs a CUDA GPU unless given --device
cpu.
"""

from __future__ import annotations

import time

from torch_prof_common import parser, report, scene, start, sync, warm_system

CHUNK, N_CHUNKS = 64, 6


def main(argv=None) -> dict:
    import bench_torch
    from orb_slam2_aruco_tpu_torch.io.ingest import StagedSource

    args = parser(__doc__).parse_args(argv)
    dev, card = start(args.device)
    cfg, frames, path = scene(dev, args.small)
    chunk, n_chunks = (2, 2) if args.small else (CHUNK, N_CHUNKS)
    system = warm_system(cfg, frames, path, dev)
    bench_torch.serving_mode(system)
    nf = len(frames)

    def source(n):
        return StagedSource([(frames[k % nf], 0.0) for k in range(n)],
                            batch=chunk, device=dev).batches()

    def metas():
        fid = system.frame_id
        system.frame_id += chunk
        return [(fid + j, 0.0) for j in range(chunk)]

    def dispatch(stack):
        ctrls, carry = system._run_chunk(stack)
        system._commit_chunk(carry)
        return ctrls

    def read(pending):
        """The chunk's control read; every frame must stay tracked."""
        _, lost = system._read_chunk(*pending)
        if lost is not None:
            raise RuntimeError(f"the stream lost frame {lost} of a chunk")

    # warm-up: one chunk through every section
    stack, _ = next(source(chunk))
    read((dispatch(stack), metas()))
    sync(dev)

    t_stage = t_disp = t_read = 0.0
    batches = source(n_chunks * chunk)
    pending = None
    t_all = time.perf_counter()
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        stack, _ = next(batches)
        t1 = time.perf_counter()
        ctrls = dispatch(stack)
        meta = metas()
        t2 = time.perf_counter()
        if pending is not None:
            read(pending)
        t3 = time.perf_counter()
        pending = (ctrls, meta)
        t_stage += t1 - t0
        t_disp += t2 - t1
        t_read += t3 - t2
    read(pending)
    sync(dev)
    total = time.perf_counter() - t_all

    chained = []
    stack, _ = next(source(chunk))
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        read((dispatch(stack), metas()))
        chained.append((time.perf_counter() - t0) * 1e3)
    per = {"staging (StagedSource)": 1e3 * t_stage / n_chunks,
           "dispatch (_run_chunk)": 1e3 * t_disp / n_chunks,
           "read prev (_read_chunk)": 1e3 * t_read / n_chunks,
           "total per chunk": 1e3 * total / n_chunks,
           "chained chunk (least)": min(chained)}
    n = n_chunks * chunk
    print(f"{n_chunks} chunks of {chunk}: {1e3 * total / n:.2f} ms per frame "
          f"({n / total:.2f} fps); chained {min(chained) / chunk:.2f} ms per "
          f"frame at best", flush=True)
    return report(per, {"card": card, "small": args.small, "chunk": chunk,
                        "n_chunks": n_chunks, "ms_per_chunk": per,
                        "fps": n / total,
                        "chained_ms": chained})


if __name__ == "__main__":
    main()
