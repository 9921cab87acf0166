"""`correct` comes out false for the control and for each fault the cell
can have, on the CPU at a tiny size: the run goes through the harness as a
cell run does, past its look for a card, with the timed path broken
underneath.

  control          the configuration's stated marker size broken (the
                   program told 0.165 m, the upstream default, for 0.187 m):
                   the metric scale the configuration guarantees
  state unchanged  the tracking cascade returns the pose it was given
  answer altered   the pose the cascade hands back is moved by 25 cm
"""

import json

import pytest

from orb_slam2_aruco_tpu_torch.pipeline import tracking
from test_slambench_harness import tiny

CONTROL = json.dumps({"aruco": {"marker_size": 0.165}})


def stuck(real):
    def track_full(state, frame, R_pred, t_pred, R_last, t_last, *rest):
        out = real(state, frame, R_pred, t_pred, R_last, t_last, *rest)
        ctrl = out.ctrl.clone()
        ctrl[5:14] = R_last.reshape(-1)
        ctrl[14:17] = t_last
        return out._replace(Rcw=R_last, tcw=t_last, ctrl=ctrl)
    return track_full


def altered(real):
    def track_full(*args):
        out = real(*args)
        ctrl = out.ctrl.clone()
        ctrl[14:17] = ctrl[14:17] + 0.25
        return out._replace(ctrl=ctrl)
    return track_full


@pytest.mark.parametrize("fault", ["control", "state unchanged",
                                   "answer altered"])
def test_fault_is_not_correct(fault, capsys, monkeypatch):
    if fault == "control":
        import run
        real_parse = run.parse
        monkeypatch.setattr(run, "parse", lambda argv: real_parse(
            argv + ["--control", CONTROL]))
    else:
        wrap = stuck if fault == "state unchanged" else altered
        monkeypatch.setattr(tracking, "track_full",
                            wrap(tracking.track_full))
    rc, line, err = tiny("tiny.loc", 0, capsys, seconds=4.0)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
