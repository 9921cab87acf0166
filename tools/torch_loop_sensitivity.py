#!/usr/bin/env python3
"""Is a loop scene chaotic in the JAX package itself? The JAX SlamSystem
over a loop scene of tests/test_torch_slice.py (LOOP_SETUPS: the pan with
the injected drift, the global BA drained, the extra frames), once as
recorded and once with every frame's keypoint coordinates (`Frame.kp_uv`,
float32) moved up by one ulp, compared step by step (CPU).

    JAX_PLATFORMS=cpu python3 tools/torch_loop_sensitivity.py [small|full ...]
        [--extra=K,K,...]

Prints, for each scene, whether the two runs agree in every state, insert,
keyframe count, loop (step, keyframe pair, marker or BoW) and
relocalization, and how far apart their keyframe poses after the drain,
valid points and seam errors are. A scene whose discrete decisions move
with one ulp cannot hold a port to them; the recorded scenes are chosen
where they do not. About 4 min (small) and 12 min (full) on 6 CPU threads.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(name, a, b):
    from test_torch_slice import _rot_err_deg

    same = {k: np.array_equal(a[k], b[k]) for k in
            ("state", "kf_insert", "n_kf", "loops", "reloc_marker", "kf_fid")}
    print(f"{name}: equal under one ulp: {same}", flush=True)
    if same["kf_fid"]:
        dr = max(_rot_err_deg(x, y) for x, y in zip(a["kf_R"], b["kf_R"]))
        dt = max(float(np.linalg.norm(x - y))
                 for x, y in zip(a["kf_t"], b["kf_t"]))
        print(f"{name}: keyframe poses after the drain {dr:.5f} deg / "
              f"{dt * 100:.5f} cm apart", flush=True)
    if same["loops"]:
        dr = max(_rot_err_deg(x, y) for x, y in zip(a["loop_R"], b["loop_R"]))
        dt = max(np.linalg.norm(a["loop_t"] - b["loop_t"], axis=-1))
        print(f"{name}: loop Sim3s {dr:.5f} deg / {dt * 100:.5f} cm apart",
              flush=True)
    if np.array_equal(a["corr_kf_fid"], b["corr_kf_fid"]):
        dr = max(_rot_err_deg(x, y)
                 for x, y in zip(a["corr_kf_R"], b["corr_kf_R"]))
        dt = max(float(np.linalg.norm(x - y))
                 for x, y in zip(a["corr_kf_t"], b["corr_kf_t"]))
        print(f"{name}: keyframe poses after the loop correction "
              f"{dr:.5f} deg / {dt * 100:.5f} cm apart", flush=True)
    both = np.flatnonzero((a["reloc_marker"] >= 0) & (b["reloc_marker"] >= 0))
    for i in both:
        print(f"{name}: relocalized step {i} (marker "
              f"{int(a['reloc_marker'][i])}): "
              f"{_rot_err_deg(a['R'][i], b['R'][i]):.5f} deg / "
              f"{np.linalg.norm(a['t'][i] - b['t'][i]) * 100:.5f} cm apart",
              flush=True)
    n = len(a["params"])
    print(f"{name}: states {a['state'][n:].tolist()} vs "
          f"{b['state'][n:].tolist()} after the pan (extra "
          f"{a['extra'].tolist()})", flush=True)
    first = (None if same["state"]
             else int(np.argmax(a["state"] != b["state"])))
    print(f"{name}: loops {a['loops'].tolist()} vs {b['loops'].tolist()}; "
          f"valid points {int(a['n_valid'])} vs {int(b['n_valid'])}; seam "
          f"{float(a['seam']) * 1000:.3f} vs {float(b['seam']) * 1000:.3f} "
          f"mm; first differing state at step {first}", flush=True)
    return all(same.values())


def main() -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import test_torch_slice

    def up_one_ulp(frame):
        return frame._replace(kp_uv=jnp.nextafter(frame.kp_uv, jnp.inf))

    names = [a for a in sys.argv[1:] if a in test_torch_slice.LOOP_SETUPS]
    extra = [int(v) for a in sys.argv[1:] if a.startswith("--extra=")
             for v in a[len("--extra="):].split(",")] or None
    stable = True
    for name in names or ["small", "full"]:
        a = test_torch_slice.jax_loop_run(name, extra=extra)
        b = test_torch_slice.jax_loop_run(name, nudge=up_one_ulp,
                                          extra=extra)
        stable &= compare(name, a, b)
    return 0 if stable else 1


if __name__ == "__main__":
    sys.exit(main())
