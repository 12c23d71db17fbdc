"""Tracing and profiling on the card.

  * `trace(logdir)`: a `torch.profiler` trace of a block (host and, where a
    card is present, device activity), written as a Chrome trace to
    `<logdir>/trace.json`;
  * `StageTimer`: wall-clock stage timing, fenced by
    `torch.cuda.synchronize` on a CUDA device;
  * `throughput_report`: Mpixels/s overall and per card;
  * `device_memory_report`: allocated, peak and reserved bytes per card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "gsrast_trace"):
    """Profile the block; yields the `torch.profiler.profile` (for
    `key_averages()`) and writes `<logdir>/trace.json` at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Named wall-clock timers. On a CUDA `device` every stage starts and
    ends with `torch.cuda.synchronize`, so a stage's time is its device
    work's.

        with timer.stage("plan"): plan = plan_tiers(...)
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: Dict[str, List[float]] = {}

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._fence()
        t0 = time.perf_counter()
        yield
        self._fence()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timeit(self, name: str, fn: Callable, *args, iters: int = 5, **kw):
        """One untimed warm-up call, then the mean of `iters` calls between
        two fences."""
        out = fn(*args, **kw)
        self._fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kw)
        self._fence()
        self.times.setdefault(name, []).append(
            (time.perf_counter() - t0) / iters)
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_ms": 1e3 * sum(ts) / len(ts),
                       "min_ms": 1e3 * min(ts), "count": len(ts)}
                for name, ts in self.times.items()}


def throughput_report(pixels: int, seconds: float,
                      n_chips: Optional[int] = None) -> Dict[str, float]:
    """Mpixels/s, per card too; `n_chips` defaults to the visible CUDA
    devices, or 1 without any."""
    n_chips = n_chips or torch.cuda.device_count() or 1
    mpix = pixels / seconds / 1e6
    return {
        "mpixels_per_s": mpix,
        "mpixels_per_s_per_chip": mpix / n_chips,
        "fps_equivalent": 1.0 / seconds if seconds > 0 else float("inf"),
        "n_chips": n_chips,
    }


def device_memory_report() -> List[Dict]:
    """Per CUDA device: the caching allocator's allocated bytes now and at
    peak, its reserved bytes, and the device's total memory. Without a
    card, one entry for the CPU."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
