"""frontend_graph_share: the share of the window's frames whose frontend
(pipeline/frontend.py `make_frame`) replayed its captured CUDA graphs: the
program's counter `frontend.GRAPH` by route, replays over replays and eager
calls, in %. 100 on the card once set-up has captured the cell's camera and
shape; 0 on the CPU."""

try:
    from orb_slam2_aruco_tpu_torch.pipeline import frontend
except ImportError:
    frontend = None

ROUTES = ("replay", "eager")
# a program that keeps no count of its frames by route has nothing to read,
# and the metric is left out
COUNTERS = ({"frontend_graph." + r: (frontend.__name__, "GRAPH", r)
             for r in ROUTES}
            if hasattr(frontend, "GRAPH") else {})


def read(t):
    calls = [t.counters.get("frontend_graph." + r) for r in ROUTES]
    if None in calls or not sum(calls):
        return None
    return 100.0 * calls[0] / sum(calls)
