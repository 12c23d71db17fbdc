"""The program's tracing (`utils/profiling.py`, `csrc/trace.cu`): with
GSRAST_TORCH_TRACE off, a train step and a frame launch, capture and insert
nothing the untraced program does not; with it on, the spans open with
their names, nested as listed, the backward spans between their identity
nodes, the gradients are those of the untraced step, the tile plan's
counters sum each render's stats (a plan that drops pairs included), the
mark kernel's source launches on the host, and `cli.py train` prints
them.
The `cuda` cases hold a captured train step's and frame's replays to the
marks of every span, in order, and to none with tracing off."""

import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels, cli
from gsrast_tpu_torch import config as cfg
from gsrast_tpu_torch.render import pipeline
from gsrast_tpu_torch.render.api import render
from gsrast_tpu_torch.render.frame import FrameGraph
from gsrast_tpu_torch.scene.gaussians import random_scene
from gsrast_tpu_torch.train.trainer import (TrainConfig, TrainGraph,
                                            init_train_state,
                                            make_train_step)
from gsrast_tpu_torch.utils import profiling

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
TRAINED_SMALL = os.path.join(HERE, "fixtures", "trained_small.ply")
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "trace.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
MARK = re.compile(r"gsrast_span_mark<(\d+), ?(\d+)>")
W, H = 64, 48
PLAN = cfg.RenderConfig(tile_h=16, tile_w=32, tiers=((4, 1.0), (64, 0.5)),
                        backend="torch")
# A plan whose one tier takes a single tile: a splat on more drops the rest.
DROPPING = PLAN.replace(tiers=((1, 1.0),))
# The spans of one train step in the order they open (the forward's and the
# step's, then inside `train.backward` the backward spans, back to front).
FORWARD = ("train.stats", "scene.activate", "render.prep", "render.binning",
           "render.pack", "render.blend", "render.untile", "train.loss")
BACKWARD = ("train.loss.bwd", "render.untile.bwd", "render.blend.bwd",
            "render.pack.bwd", "render.prep.bwd", "scene.activate.bwd")
# The kernels one train step on the card launches, each once.
STEP_KERNELS = ("preprocess_forward", "plan_tiers", "tile_order",
                "blend_forward", "blend_backward", "preprocess_backward",
                "loss_forward", "loss_backward", "adam")


@pytest.fixture
def tracing(monkeypatch):
    """Turn tracing on or off for the test (the switch is read once, at
    import), with the counters at zero."""

    def set_to(on: bool):
        monkeypatch.setattr(profiling, "_TRACING", on)
        profiling.counters(reset=True)

    return set_to


def _scene(device="cpu", n=400, seed=0):
    return random_scene(n, np.random.default_rng(seed), sh_degree=1,
                        scale_range=(0.02, 0.08), device=device)


def _camera(scene, device="cpu", width=W, height=H):
    mn, mx = scene.bbox()
    return gt.auto_frame(mn, mx, width, height, device=device)


def _granted(n, plan):
    """The slots a render of n splats on `plan` grants: the tier plan's,
    padded to 128 (`plan_layout`); the legacy binning's capacity."""
    from gsrast_tpu_torch.ops.binning import tier_dims

    if plan.tiers:
        return -(-tier_dims(n, plan.tiers)[1] // 128) * 128
    return plan.capacity(n)


def _step(scene, plan=PLAN):
    """A train step of its own state over `scene`, and a target."""
    cam = _camera(scene, scene.means.device)
    with torch.no_grad():
        target = render(scene, cam, plan).image.clone()
    tc = TrainConfig()
    state = init_train_state(scene, tc, 2.0)
    return state, make_train_step(plan, tc, 2.0), cam, target


def _graph_nodes(root) -> list:
    """The names of every node of an autograd graph from `root`."""
    seen, stack, names = set(), [root], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def _annotations(events) -> list:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in profiling.SPANS]


def _profiled(fn, tmp_path) -> list:
    with profiling.trace(str(tmp_path)):
        fn()
    with open(tmp_path / "trace.json") as f:
        return json.load(f)["traceEvents"]


def test_tracing_off_launches_and_inserts_nothing(tracing):
    """Off: a span is nothing but a profiler range, a train step's autograd
    graph holds no boundary node, nothing launches or counts, and the graph
    with tracing on differs only by its boundary nodes."""
    tracing(False)
    assert not profiling.tracing()
    dev = torch.device("cuda")  # named, never touched
    assert isinstance(profiling.span("prep", device=dev),
                      contextlib.nullcontext)
    with torch.profiler.profile():
        assert isinstance(profiling.span("prep", device=dev),
                          torch.profiler.record_function)
    graphs = {}
    for on in (False, True):
        tracing(on)
        state, _, cam, target = _step(_scene())
        profiling.counters(reset=True)
        _kernels.reset_launch_counts()
        out = render(state.scene, cam, PLAN,
                     mean2d_delta=torch.zeros((400, 2), requires_grad=True))
        loss = torch.mean(torch.abs(out.image - target))
        graphs[on] = _graph_nodes(loss.grad_fn)
        assert not any(_kernels.launch_counts.values())
        counts = profiling.counters()
        assert counts["plan.granted"] == (_granted(400, PLAN) if on else 0), \
            counts
    assert "_BoundaryBackward" not in graphs[False]
    bounds = [n for n in graphs[True] if n == "_BoundaryBackward"]
    assert len(bounds) == 2 * 5  # activate, prep, pack, blend, untile
    assert sorted(n for n in graphs[True] if n != "_BoundaryBackward") == \
        sorted(graphs[False])


def test_a_frame_with_tracing_off_equals_one_with_it_on(tracing):
    """The viewer's frame (inference mode: no boundary node) draws the same
    image either way, and counts only with tracing on."""
    scene = _scene(seed=3)
    cam = _camera(scene)
    with torch.no_grad():
        act = scene.activated()
    images = []
    for on in (False, True):
        tracing(on)
        frame = FrameGraph(
            lambda c: render(act, c, PLAN).image, "gaussians", "torch")
        with torch.inference_mode():
            images.append(frame(cam).clone())
        assert profiling.counters()["plan.granted"] == \
            int(on) * _granted(400, PLAN)
    assert torch.equal(images[0], images[1])


def test_traced_step_equals_the_untraced_one(tracing):
    """Identity nodes change no gradient: two steps with tracing on leave
    the loss and every state tensor bit for bit as two steps without."""
    runs = []
    for on in (False, True):
        tracing(on)
        state, step, cam, target = _step(_scene(seed=1))
        losses = [step(state, cam, target)["loss"].clone() for _ in range(2)]
        runs.append((losses, {k: v.clone() for k, v in
                              state.tensors().items()}))
    (l0, t0), (l1, t1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert t0.keys() == t1.keys()
    for k in t0:
        assert torch.equal(t0[k], t1[k]), k


def test_traced_spans_open_nested_and_in_order(tracing, tmp_path):
    """On, under the profiler, one train step opens every span of the step
    with its name: the forward's one after another, then `train.backward`
    holding the backward spans back to front, `train.adam` and
    `train.stats` last; on the CPU the backward runs on the caller's
    thread, so the backward spans nest inside `train.backward`."""
    tracing(True)
    state, step, cam, target = _step(_scene(seed=2))
    step(state, cam, target)  # Adam's state made outside the trace
    spans = _annotations(_profiled(lambda: step(state, cam, target),
                                   tmp_path))
    spans.sort(key=lambda e: e["ts"])
    names = [e["name"] for e in spans]
    want = (*FORWARD, "train.backward", *BACKWARD, "train.adam",
            "train.stats")
    assert names == list(want), names
    outer = spans[names.index("train.backward")]
    inner = [e for e in spans if e["name"].endswith(".bwd")]
    for e in inner:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    siblings = [e for e in spans if e not in inner]
    for run in (siblings, inner):
        for a, b in zip(run, run[1:]):
            assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])


def test_counters_sum_each_render_of_the_plan(tracing):
    """`counters()` is the sum over renders of the stats: one call each,
    `num_intersections`, the granted slots, `overflow_tile_cap` (and the
    legacy binning's `overflow_capacity`); a plan that drops pairs counts
    them; `reset` zeroes the counters after the read."""
    tracing(True)
    scene = _scene(seed=4, n=600)
    cam = _camera(scene)
    legacy = cfg.RenderConfig(backend="torch", tile_h=16, tile_w=32)
    want = dict.fromkeys(profiling.COUNTERS, 0)
    with torch.no_grad():
        act = scene.activated()
        for plan in (PLAN, DROPPING, PLAN, legacy):
            stats = render(act, cam, plan).stats
            want["plan.live"] += int(stats["num_intersections"])
            want["plan.granted"] += _granted(600, plan)
            want["plan.dropped"] += int(stats["overflow_tile_cap"]) + int(
                stats["overflow_capacity"])
            if plan is DROPPING:
                assert int(stats["overflow_tile_cap"]) > 0
    assert profiling.counters(reset=True) == want
    assert profiling.counters() == dict.fromkeys(profiling.COUNTERS, 0)


def test_cli_train_prints_the_plan_counters(tracing, tmp_path, capsys):
    """With tracing on, each metrics line of `train` adds the dropped pairs
    and the slot fill since the line before (the counters read and reset
    there); off, the line is as it was."""
    argv = ["train", "--scene", TRAINED_SMALL, "--steps", "3", "--width",
            "64", "--height", "48", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ckpts")]
    tracing(False)
    cli.main(argv)
    assert "dropped=" not in capsys.readouterr().out
    tracing(True)
    cli.main([*argv[:-1], str(tmp_path / "traced")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2  # steps 0 and 2
    for line in lines:
        m = re.search(r" dropped=(\d+) fill=([0-9.]+)%$", line)
        assert m, line
        assert 0.0 < float(m.group(2)) <= 100.0
    # The second line holds steps 1 and 2 only: the first line's read
    # reset the counters.
    assert profiling.counters() == dict.fromkeys(profiling.COUNTERS, 0)


def _k_spans() -> int:
    """`csrc/trace.cu`'s kSpans: the marks it has."""
    with open(SOURCE) as f:
        return int(re.search(r"kSpans = (\d+);", f.read()).group(1))


def test_the_span_table_fits_the_mark_kernel():
    """Every span has a mark, the names are unique, and no mark's kernel
    name holds a name another reading of the trace matches kernels by."""
    assert len(profiling.SPANS) <= _k_spans()
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert profiling.SPAN_IDS == {s: i for i, s in
                                  enumerate(profiling.SPANS)}
    assert set(FORWARD + BACKWARD) <= set(profiling.SPANS)
    assert pipeline.span is profiling.span
    name = "void gsrast_span_mark<5, 1>()"
    assert MARK.search(name).groups() == ("5", "1")
    for taken in ("blend_forward_kernel", "blend_backward_kernel",
                  "preprocess_", "loss_", "adam_update_kernel",
                  "tile_order", "plan", "rank_kernel", "slots_kernel"):
        assert taken not in name


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`trace.cu` built for the host against `tests/cuda_host/`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("trace_host")
    with open(SOURCE) as f:
        # A launch with no arguments leaves a trailing comma to drop.
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read()).replace(", )",
                                                                  ")")
    cpp, so = out / "trace_host.cpp", out / "libtrace_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-I", os.path.join(HERE, "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    _kernels.set_trace_argtypes(lib)
    return lib


def test_the_mark_kernel_adds_the_counts_on_the_host(host_lib):
    """The kernel's source on the host: every span's mark launches at both
    edges, and a span or edge out of range is refused. A mark adds no
    counts: the plan's counters are plain tensor adds
    (`test_counters_sum_each_render_of_the_plan`)."""
    mark = host_lib.gsrast_trace_mark
    for span in range(_k_spans()):
        assert mark(span, profiling.START, None) == 0
        assert mark(span, profiling.END, None) == 0
    for bad in ((_k_spans(), 0), (-1, 0), (0, 2), (0, -1)):
        assert mark(*bad, None) != 0


def _marks(events) -> list:
    """The marks of a trace, in device order: (span name, edge)."""
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    out = []
    for e in kernels:
        m = MARK.search(e["name"])
        if m:
            out.append((profiling.SPANS[int(m.group(1))], int(m.group(2))))
    return out


def _pairs(*names):
    return [(n, edge) for n in names for edge in (profiling.START,
                                                  profiling.END)]


@pytest.mark.cuda
def test_cuda_replays_carry_every_mark_in_order(tracing, tmp_path):
    """On the card: a train step and a frame captured with tracing off
    capture the step's kernels, each once, and no mark, and their replays
    show none; captured with tracing on, a profiled replay shows the marks
    of every span in order (`graph.load`'s outside the graph), and the
    counters sum the stats of every render, the replays' included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    plan = PLAN.replace(backend="cuda")
    want_step = [*_pairs("graph.load", "train.stats", *FORWARD[1:]),
                 ("train.backward", profiling.START),
                 *_pairs(*BACKWARD), ("train.backward", profiling.END),
                 *_pairs("train.adam", "train.stats")]
    want_frame = _pairs("graph.load", "render.prep", "render.binning",
                        "render.pack", "render.blend", "render.untile")
    for on in (False, True):
        tracing(on)
        scene = _scene(dev, n=3000, seed=5)
        state, step, cam, target = _step(scene, plan)
        graph = TrainGraph(step)
        for _ in range(3):  # eager, capture + replay, replay
            graph(state, cam, target)
        captured = {k: v for k, v in graph.captured.items() if v}
        want = dict.fromkeys(STEP_KERNELS, 1)
        if on:
            want["trace_mark"] = len(want_step) - 2
        assert captured == want, captured
        events = _profiled(lambda: graph(state, cam, target), tmp_path)
        torch.cuda.synchronize()
        assert _marks(events) == (want_step if on else [])
        with torch.no_grad():
            act = scene.activated()
        frame = FrameGraph(lambda c: render(act, c, plan).image, "gaussians",
                           "cuda")
        torch.cuda.synchronize()
        profiling.counters(reset=True)
        with torch.inference_mode():
            for _ in range(3):
                frame(cam)
            events = _profiled(lambda: frame(cam), tmp_path)
        assert _marks(events) == (want_frame if on else [])
        assert frame.captured.get("trace_mark", 0) == (
            len(want_frame) - 2 if on else 0)
        with torch.no_grad():
            stats = render(act, cam, plan).stats
        got = profiling.counters()
        calls = 4 + 1  # the frames (eager, replayed three times), a render
        assert got["plan.granted"] == (calls * _granted(3000, plan)
                                       if on else 0)
        if on:
            assert got["plan.live"] == calls * int(stats["num_intersections"])
            assert got["plan.dropped"] == 0


def _device_op(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _device_mark(span, edge, ts):
    return _device_op(f"void gsrast_span_mark<{profiling.SPAN_IDS[span]}, "
                      f"{edge}>()", ts, 1)


def test_profile_step_splits_replays_by_their_marks():
    """`diag/profile_step.py::span_split` on hand-made device events: each
    operation takes its innermost span (a nested backward span wins over
    its parent), work between spans is outside, an end mark closes the
    spans left open inside it, times are per step, and the cover leaves
    the marks out; without marks there is no split."""
    from gsrast_tpu_torch.diag import profile_step

    step = [_device_mark("render.binning", 0, 10),
            _device_op("rank_kernel", 12, 10),
            _device_mark("render.binning", 1, 23),
            _device_op("elementwise", 25, 4),
            _device_mark("render.pack", 0, 30), _device_op("sort", 32, 20),
            _device_mark("train.backward", 0, 53),
            _device_mark("render.pack.bwd", 0, 55),
            _device_op("index_add", 57, 5),
            _device_mark("render.pack", 1, 63),  # closes both left open
            _device_op("after", 66, 2)]
    two = step + [dict(e, ts=e["ts"] + 100) for e in step]
    got = profile_step.span_split(two, steps=2)
    assert got["spans_ms"] == {"render.binning": pytest.approx(0.010),
                               "render.pack": pytest.approx(0.020),
                               "render.pack.bwd": pytest.approx(0.005)}
    assert got["outside_ms"] == pytest.approx(0.006)
    assert got["marks_ms"] == pytest.approx(0.006)
    assert got["cover_pct"] == pytest.approx(100.0 * 35 / 41)
    assert profile_step.span_split(
        [_device_op("sort", 0, 5)]) is None
    events = [{"ph": "X", "cat": "user_annotation", "name": "profile.x",
               "ts": 0, "dur": 1}, *two]
    assert profile_step.summarize(events, "profile.x", 2, split=False)[
        "spans"] == got


def test_profile_step_reads_the_counters_with_tracing_on(tracing, tmp_path,
                                                         monkeypatch):
    """With tracing on, a cell of `diag/profile_step.py` reports the tile
    plan's counters over its calls (on the CPU: no device events, so no
    split); off, it reports none."""
    from gsrast_tpu_torch.diag import profile_step

    monkeypatch.setitem(profile_step.CELLS, "tiny", (600, 64, 48, None))
    monkeypatch.setattr(profile_step, "CHAIN", 2)
    monkeypatch.setattr(profile_step, "TIMED", 1)
    for on in (False, True):
        tracing(on)
        res = profile_step.profile_cell("tiny", str(tmp_path),
                                        torch.device("cpu"))
        assert ("counters" in res) == on
        assert "spans" not in res["frame"]
    got = res["counters"]
    assert 0 < got["plan.live"] <= got["plan.granted"]
    assert got["plan.dropped"] >= 0
    assert profiling.counters() == dict.fromkeys(profiling.COUNTERS, 0)
