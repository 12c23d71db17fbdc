"""Device idle milliseconds a frame while the host is inside the program's
frame call: the parts of the gaps between the traced frames' device
operations that overlap the union of the program's host ranges
`graph.load` (the copies into its frame graph's static camera) and
`graph.replay` (the replay's launch), summed over the window, over the
frames. Every traced frame is a replay, so no other range of the program
runs in the window. (A frame's one gap runs from its last kernel through
the sync's return, the harness's loop and the program's call to the next
frame's first copy: giving a whole gap to the range around its midpoint
would swing with the sync's wake-up.) The profiler's own cost lengthens
these ranges. None where the trace holds neither range."""

from gsbench.trace import union_s

PROGRAM_RANGES = ("graph.load", "graph.replay")


def read(ctx):
    win = ctx["window"]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in win.events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") in PROGRAM_RANGES
            and e["ts"] + e["dur"] >= win.start and e["ts"] <= win.end]
    if not host:
        return None
    gaps, busy_to = [], win.start
    for e in win.ops:
        if e["ts"] > busy_to:
            gaps.append((busy_to, e["ts"]))
        busy_to = max(busy_to, e["ts"] + e["dur"])
    inside = [(max(a, c), min(b, d)) for a, b in gaps for c, d in host
              if max(a, c) < min(b, d)]
    return 1e3 * union_s(inside) / ctx["steps"]
