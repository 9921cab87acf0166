#!/usr/bin/env python3
"""Regenerate the port's ARUCO_MIP_36h12 table from OpenCV's public
cv2.aruco data: the port of tools/extract_cv2_dicts.py.

    python3 tools/torch_extract_cv2_dicts.py [--out DIR]

The true ARUCO_MIP_36h12 bit table ships with OpenCV (public data, the
dictionary the reference's vendored aruco lib uses for samsung7 footage,
reference Thirdparty/aruco/dictionary.h:53-140). Codes are extracted by
rendering each marker and reading its cells (robust to bytesList packing)
and written as DIR/aruco_mip_36h12.npz (packed bits, grid, num_ids,
max_correction). DIR defaults to the port's own data directory
(orb_slam2_aruco_tpu_torch/ops/aruco/data, dictionary._DATA_DIR). Needs
cv2 (opencv-python).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def extract(dict_id, n, grid):
    """(codes [n, grid*grid] uint8, maxCorrectionBits) of a cv2.aruco
    dictionary, read from its rendered markers."""
    import cv2.aruco as ar

    d = ar.getPredefinedDictionary(dict_id)
    codes = np.zeros((n, grid * grid), np.uint8)
    for i in range(n):
        img = ar.generateImageMarker(d, i, 8 * (grid + 2))
        inner = img[8:-8, 8:-8]
        cells = inner.reshape(grid, 8, grid, 8).mean(axis=(1, 3)) > 127
        codes[i] = cells.reshape(-1).astype(np.uint8)
    return codes, int(d.maxCorrectionBits)


def main(argv=None) -> str:
    import cv2.aruco as ar

    from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=dictionary._DATA_DIR)
    args = ap.parse_args(argv)
    mip, mc = extract(ar.DICT_ARUCO_MIP_36H12, 250, 6)
    if len({c.tobytes() for c in mip}) != 250:
        raise RuntimeError("ARUCO_MIP_36h12: the 250 extracted codes are "
                           "not distinct")
    path = os.path.join(args.out, "aruco_mip_36h12.npz")
    np.savez_compressed(path, packed=np.packbits(mip, axis=1), grid=6,
                        num_ids=250, max_correction=mc)
    print(f"wrote {path}  maxCorrection = {mc}")
    return path


if __name__ == "__main__":
    main()
