"""The port's data tools on the CPU against the JAX side's:
tools/torch_independent_seq.py renders the fly-by byte for byte as
tools/independent_seq.py does and writes the same dataset files, and
raises cv2's ImportError without cv2; tools/torch_extract_cv2_dicts.py
gives the port's committed ARUCO_MIP_36h12 table and writes into the
port's data directory by default; tools/torch_gen_mip25h7.py gives the
JAX package's recorded 25h7 regeneration (data/ref_dicts.npz). No test
writes into either package's data directory.
"""

import os
import sys

import numpy as np
import pytest

from test_torch_slice import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))

import independent_seq  # noqa: E402
import torch_extract_cv2_dicts  # noqa: E402
import torch_gen_mip25h7  # noqa: E402
import torch_independent_seq  # noqa: E402
from orb_slam2_aruco_tpu_torch.ops.aruco import dictionary  # noqa: E402

PORT_DATA = os.path.join(REPO, "orb_slam2_aruco_tpu_torch", "ops", "aruco",
                         "data")
REF_DICTS = os.path.join(REPO, "orb_slam2_aruco_tpu_torch", "data",
                         "ref_dicts.npz")
# a short, small fly-by: enough frames for the exposure ramp and the tilt
SEQ = dict(n_frames=4, width=320, height=240)


def _codes(z, prefix=""):
    """(codes [n, grid*grid], grid, num_ids, max_correction) of a packed
    table."""
    grid, n = int(z[prefix + "grid"]), int(z[prefix + "num_ids"])
    codes = np.unpackbits(z[prefix + "packed"], axis=1)[:n, :grid * grid]
    return codes, grid, n, int(z[prefix + "max_correction"])


@pytest.mark.parametrize("dict_name", ["ARUCO_MIP_25h7",
                                       "DICT_ARUCO_ORIGINAL"])
def test_render_sequence_is_the_jax_tools(dict_name):
    mine = torch_independent_seq.render_sequence(dict_name=dict_name, **SEQ)
    theirs = independent_seq.render_sequence(dict_name=dict_name, **SEQ)
    for a, b in zip(mine[0], theirs[0]):
        assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
    assert len(mine[0]) == len(theirs[0]) == SEQ["n_frames"]
    for (Ra, ta), (Rb, tb) in zip(mine[1], theirs[1]):
        assert Ra.tobytes() == Rb.tobytes() and ta.tobytes() == tb.tobytes()
    assert np.array_equal(mine[2], theirs[2]) and mine[3] == theirs[3]


def test_write_dataset_writes_the_jax_tools_files(tmp_path):
    frames, poses, K, _ = torch_independent_seq.render_sequence(**SEQ)
    a, b = tmp_path / "port", tmp_path / "jax"
    torch_independent_seq.write_dataset(str(a), frames, poses, K)
    independent_seq.write_dataset(str(b), frames, poses, K)
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert {"times.txt", "calib.yml", "gt.tum"} <= set(names)
    assert len([n for n in names if n.endswith(".png")]) == SEQ["n_frames"]
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_render_sequence_without_cv2_raises_its_import_error(monkeypatch):
    for m in [m for m in sys.modules if m == "cv2" or m.startswith("cv2.")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        torch_independent_seq.render_sequence(**SEQ)


def test_extract_cv2_dicts_gives_the_committed_36h12_table(tmp_path):
    path = torch_extract_cv2_dicts.main(["--out", str(tmp_path)])
    assert path == str(tmp_path / "aruco_mip_36h12.npz")
    with np.load(path) as got, np.load(os.path.join(
            PORT_DATA, "aruco_mip_36h12.npz")) as want:
        g, w = _codes(got), _codes(want)
    assert np.array_equal(g[0], w[0]) and g[1:] == w[1:] == (6, 250, 5)


def test_extract_cv2_dicts_writes_into_the_ports_data_by_default(
        monkeypatch):
    written = []
    monkeypatch.setattr(torch_extract_cv2_dicts.np, "savez_compressed",
                        lambda path, **kw: written.append(path))
    path = torch_extract_cv2_dicts.main([])
    assert written == [path]
    assert os.path.dirname(path) == dictionary._DATA_DIR
    assert os.path.realpath(dictionary._DATA_DIR) == os.path.realpath(
        PORT_DATA)


def test_gen_mip25h7_gives_the_jax_packages_regeneration(tmp_path):
    out = str(tmp_path / "mip25h7.npz")
    assert torch_gen_mip25h7.main(["--out", out]) == out
    with np.load(out) as got, np.load(REF_DICTS) as ref:
        g, w = _codes(got), _codes(ref, "MIP_25h7_")
    assert np.array_equal(g[0], w[0]) and g[1:] == w[1:] == (5, 100, 3)
