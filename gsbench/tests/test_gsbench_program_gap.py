"""`program_gap_ms.view`'s reader on hand-made trace events: the idle gaps
between device operations count where they overlap the program's
`graph.load` and `graph.replay` host ranges, never under another range, and
None where the trace holds neither range."""

import pytest

from gsbench import harness, trace

MARKER = "gsbench.window"


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _ctx(events, steps=1):
    events = [_host(MARKER, 0, 1000), *events]
    return {"window": trace.Window(events, MARKER), "steps": steps}


OPS = [_kernel("a", 0, 10), _kernel("b", 30, 10), _kernel("c", 60, 10),
       _kernel("d", 100, 10)]


def test_gaps_count_only_while_the_host_is_in_the_frame_call():
    read = harness.reader("program_gap_ms.view")
    host = [_host("graph.load", 15, 10), _host("gsbench.frame", 45, 10),
            _host("graph.replay", 72, 26), _host("graph.load", 95, 10),
            _host("graph.capture", 42, 6), _host("render.pack", 62, 6)]
    # Gaps 10-30 (graph.load 15-25 inside it: 10 us), 40-60 (only the
    # harness's range and a capture, which no replayed frame runs: 0) and
    # 70-100 (graph.replay 72-98 and graph.load 95-100, overlapping: 28
    # us); render.pack lies over device work.
    assert read(_ctx(OPS + host, steps=2)) == pytest.approx(0.019)


def test_without_the_program_ranges_nothing_is_read():
    read = harness.reader("program_gap_ms.view")
    assert read(_ctx(OPS)) is None
    assert read(_ctx(OPS + [_host("render.prep", 12, 10),
                            _host("graph.eager", 42, 10)])) is None
