"""cascade_graph_share: the share of the window's tracking cascades
(pipeline/tracking.py `track_full`) that replayed their captured CUDA
graphs: the program's counter `tracking.GRAPH` by route, replays over
replays and eager calls, in %. 100 on the card in localization mode once
set-up has captured the cell's map and shapes; 0 on the CPU."""

try:
    from orb_slam2_aruco_tpu_torch.pipeline import tracking
except ImportError:
    tracking = None

ROUTES = ("replay", "eager")
# a program that keeps no count of its cascades by route has nothing to
# read, and the metric is left out
COUNTERS = ({"cascade_graph." + r: (tracking.__name__, "GRAPH", r)
             for r in ROUTES}
            if hasattr(tracking, "GRAPH") else {})


def read(t):
    calls = [t.counters.get("cascade_graph." + r) for r in ROUTES]
    if None in calls or not sum(calls):
        return None
    return 100.0 * calls[0] / sum(calls)
