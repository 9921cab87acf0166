#!/usr/bin/env python3
"""Generate and pack the ARUCO_MIP_25h7 regeneration: the port of
tools/gen_mip25h7.py.

    python3 tools/torch_gen_mip25h7.py --out PATH

Runs the port's dictionary._generate_mip_style with the JAX tool's
arguments ("ARUCO_MIP_25h7", grid 5, 100 ids, tau 7, seed 25; ~4 s) and
writes PATH in the layout of the package's tables (packed bits, grid,
num_ids, max_correction). The regeneration is bit-equal to the JAX
package's (data/ref_dicts.npz's MIP_25h7_*). The port's committed
ops/aruco/data/aruco_mip_25h7.npz is the published table, not this
regeneration, so PATH has no default: the tool never writes over it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> str:
    from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    d = dictionary._generate_mip_style("ARUCO_MIP_25h7", 5, 100, 7, seed=25)
    np.savez_compressed(args.out, grid=5, num_ids=d.num_ids,
                        max_correction=d.max_correction,
                        packed=np.packbits(d.codes, axis=1))
    print(f"{args.out}: {d.num_ids} ids, max_correction={d.max_correction}")
    return args.out


if __name__ == "__main__":
    main()
