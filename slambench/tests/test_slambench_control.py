"""The control on the card at the cell's own size: the program told the
upstream marker size (0.165 m) for the stated 0.187 m, which breaks the
metric scale the configuration guarantees, comes out not correct on three
seeds. Run on the card:

    python -m pytest slambench/tests/test_slambench_control.py -q
"""

import json

import pytest

import run

CONTROL = json.dumps({"aruco": {"marker_size": 0.165}})


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_control_is_not_correct(seed, cuda_device, capsys):
    rc = run.main(["--workload", "tum1.loc-frame", "--seed", str(seed),
                   "--seconds", "20", "--trace", "0", "--control", CONTROL])
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
