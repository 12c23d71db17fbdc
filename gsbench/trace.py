"""Reading the device's work from a `torch.profiler` trace: the device
operations after a marker range, the union of their intervals (the busy
time), the idle gaps and what the host was doing in them, and the device
time of the kernels launched inside a named host range or by the autograd
nodes made inside it. The arithmetic is the program's `diag/profile_step.py`
(`_union_ms`, `_device_events`, `summarize`), copied so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import collections
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def profiled(fn, marker: str, out_dir: str) -> list:
    """Run fn() under `torch.profiler` inside the host range `marker`,
    synchronise, and return the trace's events."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(marker):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{marker}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def union_s(intervals) -> float:
    """The length of the union of (start, end) intervals in us, in s."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    or parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip()[:64] or name[:64]


class Window:
    """The device operations traced after the host range `marker` began.
    The window runs from the first of them (the host's start-up before it
    is paid once a process, not once a step) to the end of the last, or of
    the marker."""

    def __init__(self, events: list, marker: str):
        (mark,) = [e for e in events if e.get("name") == marker
                   and e.get("cat") == "user_annotation"]
        self.events = events
        self.ops = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                           and e["ts"] >= mark["ts"]), key=lambda e: e["ts"])
        self.start = self.ops[0]["ts"] if self.ops else mark["ts"]
        self.end = max([e["ts"] + e["dur"] for e in self.ops]
                       + [mark["ts"] + mark["dur"]])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_s((e["ts"], e["ts"] + e["dur"]) for e in self.ops)

    def count(self, pattern: str) -> int:
        """Kernels whose name holds `pattern`."""
        return sum(1 for e in self.ops
                   if e["cat"] == "kernel" and pattern in e["name"])

    def seconds(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds one of
        `patterns`."""
        return union_s((e["ts"], e["ts"] + e["dur"]) for e in self.ops
                       if any(p in e["name"] for p in patterns))

    def device_ops(self) -> list:
        """The TOP device operations by total seconds, [name, seconds]."""
        total = collections.Counter()
        for e in self.ops:
            total[short_name(e["name"])] += e["dur"] / 1e6
        return [[k, v] for k, v in total.most_common(TOP)]

    def idle_gaps(self) -> list:
        """The device's idle time in the window, summed by what the host
        was doing in each gap (the innermost host range or runtime call
        around its middle, else 'host'), the TOP largest, [name, s]."""
        host = [e for e in self.events if e.get("ph") == "X"
                and e.get("cat") in ("cpu_op", "user_annotation",
                                     *LAUNCH_CATS)]
        gaps, busy_to = [], self.start
        for e in self.ops:
            if e["ts"] > busy_to:
                gaps.append((busy_to, e["ts"]))
            busy_to = max(busy_to, e["ts"] + e["dur"])
        if self.end > busy_to:
            gaps.append((busy_to, self.end))
        total = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            around = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = (min(around, key=lambda e: e["dur"])["name"][:64]
                    if around else "host")
            total[name] += (b - a) / 1e6
        return [[k, v] for k, v in total.most_common(TOP)]


def _inside(ranges, tid, ts):
    for rtid, a, b, e in ranges:
        if rtid == tid and a <= ts <= b:
            return e
    return None


def range_seconds(events: list, marker: str, stage: str) -> float:
    """Device seconds, after `marker` began, of the kernels launched inside
    the host range `stage` or by the backward of an autograd node made
    inside it (the node's forward op carries its sequence number)."""
    window = Window(events, marker)
    stage_ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"], e) for e in events
                    if e.get("ph") == "X" and e.get("name") == stage]
    owned_seq = set()
    for e in sorted(events, key=lambda e: e.get("ts", 0.0)):
        args = e.get("args", {})
        seq = args.get("Sequence number")
        if e.get("cat") == "cpu_op" and seq is not None and (
                args.get("Fwd thread id", 0) == 0):
            if _inside(stage_ranges, e["tid"], e["ts"]) is not None:
                owned_seq.add(seq)
            else:
                owned_seq.discard(seq)
    backward = [(e["tid"], e["ts"], e["ts"] + e["dur"], e) for e in events
                if e.get("ph") == "X"
                and "evaluate_function" in e.get("name", "")]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    mine = []
    for k in window.ops:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        if _inside(stage_ranges, launch["tid"], launch["ts"]) is not None:
            mine.append(k)
            continue
        node = _inside(backward, launch["tid"], launch["ts"])
        if node is not None and node["args"].get(
                "Sequence number") in owned_seq:
            mine.append(k)
    return union_s((e["ts"], e["ts"] + e["dur"]) for e in mine)
