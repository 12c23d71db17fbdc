"""The harness: finds a cell's files by name, runs it once and prints the
result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its configuration is
`gsbench/configs/<config>.json`, its traffic mix `gsbench/traffic/
<traffic>.json` (whose `loop` names the driver in `gsbench/loops/`), its
own settings `gsbench/cells/<cell>.json` (the render plan it states and
the limits of its correctness check), and each per-layer metric a reader
`gsbench/layer_metrics/<metric>.py` with `read(ctx)`. Nothing here names a
cell, a configuration or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

from . import ROOT

HERE = os.path.join(ROOT, "gsbench")
CACHE = os.path.join(HERE, "_cache")
OUT = os.path.join(HERE, "_out")
FORBIDDEN = ("jax", "jaxlib", "flax", "gsrast_tpu")


def set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The program's kernel library builds into its own `_build/`, which is
    inside the checkout too."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict   # the BENCHMARK.json entry
    config: dict     # gsbench/configs/<config>.json
    traffic: dict    # gsbench/traffic/<traffic>.json
    settings: dict   # gsbench/cells/<name>.json
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load(name: str, benchmark: dict | None = None) -> Cell:
    bench = benchmark or _json(os.path.join(ROOT, "BENCHMARK.json"))
    (workload,) = [w for w in bench["workloads"] if w["name"] == name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, workload,
                _json(os.path.join(HERE, "configs",
                                   f"{workload['config']}.json")),
                _json(os.path.join(HERE, "traffic",
                                   f"{workload['traffic']}.json")),
                _json(os.path.join(HERE, "cells", f"{name}.json")),
                e2e, layer)


def loop_class(cell: Cell):
    """The driver of the cell's loop: `gsbench/loops/<loop>.py`'s `Loop`."""
    return importlib.import_module(
        f"gsbench.loops.{cell.traffic['loop']}").Loop


def reader(metric: str):
    """`gsbench/layer_metrics/<metric>.py`'s `read`."""
    path = os.path.join(HERE, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"gsbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", chips: int = 1) -> dict:
    """One run of `cell`: set-up, the measured window, with `trace` the
    traced readings, then the correctness check. Returns the result."""
    import torch

    loop = loop_class(cell)(cell, seed, device)
    loop.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    window = loop.window(seconds)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": chips,
           "memory_peak_bytes": window.pop("memory_peak_bytes")}
    attempted, failed = window.pop("attempted"), window.pop("failed")
    breakdown = None
    if trace:
        ctx = loop.trace(OUT)
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        breakdown = ctx.pop("breakdown")
    loop.release()
    t_check = time.perf_counter()
    checked = loop.check()
    print(f"gsbench: set-up {setup_s:.3f} s, of it {json.dumps(loop.parts)}; "
          f"check {time.perf_counter() - t_check:.3f} s; window "
          f"{json.dumps(loop.window_stats)}; "
          f"{json.dumps(checked['diagnostics'])}", file=sys.stderr)
    if trace:
        ctx.update(loop.work(ctx))
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        window["setup_s"] = setup_s
        metrics = {m["name"]: {"value": window[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": checked["correct"], "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = checked["compared"]
    return out
