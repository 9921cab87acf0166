"""The port's measurement tools on the CPU at ref_small's size: each of
tools/torch_scaling_bench.py, torch_profile_mapping.py,
torch_prof_stream_host.py and torch_profile_chunk.py runs its main with
--device cpu --small, prints the card line first ("cpu" here) and, as its
last line, one JSON object with its keys and finite numbers; without a
card and without --device cpu each raises before it measures anything.
The numbers are the CPU's: the tools' readings are taken on the card.
"""

import json
import math
import os
import sys

import pytest
import torch

from test_torch_slice import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_prof_stream_host  # noqa: E402
import torch_profile_chunk  # noqa: E402
import torch_profile_mapping  # noqa: E402
import torch_scaling_bench  # noqa: E402

TOOLS = {
    "scaling_bench": (torch_scaling_bench, ["--mesh", "1", "2", "--iters",
                                            "2"], ("problem", "meshes")),
    "profile_mapping": (torch_profile_mapping, [], ("ms", "keyframes")),
    "prof_stream_host": (torch_prof_stream_host, [],
                         ("ms_per_chunk", "fps", "chained_ms")),
    "profile_chunk": (torch_profile_chunk, [], ("ms_per_frame", "null_ms")),
}
MAPPING_STAGES = ("triangulate_vs_covisible", "cull_points",
                  "fuse_duplicates", "update_point_stats",
                  "distinctive_descriptors[kf]", "aruco_plane_update",
                  "local BA (window)", "cull_keyframes", "detect_loops",
                  "TOTAL per insert")


def _numbers(x):
    """Every number in a JSON value."""
    if isinstance(x, dict):
        return [n for v in x.values() for n in _numbers(v)]
    if isinstance(x, list):
        return [n for v in x for n in _numbers(v)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) \
        else []


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_and_prints_its_json_last(name, capsys):
    mod, extra, keys = TOOLS[name]
    ret = mod.main(["--device", "cpu", "--small"] + extra)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(ret))
    assert last["card"] == "cpu" and last["small"] is True
    for k in keys:
        assert k in last, k
    nums = _numbers(last)
    assert nums and all(math.isfinite(n) for n in nums)
    if name == "profile_mapping":
        assert all(s in last["ms"] for s in MAPPING_STAGES)
        assert len(last["ms"]) == len(MAPPING_STAGES) + 2
    if name == "scaling_bench":
        assert [m["n"] for m in last["meshes"]] == [1, 2]
        assert last["problem"]["K"] > 32      # the CG branch
        assert all(m["iters_per_s"] > 0 for m in last["meshes"])
    if name == "profile_chunk":
        assert len(last["ms_per_frame"]) == 7


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_card_raises(name, monkeypatch):
    mod, extra, _ = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main(["--small"] + extra)
