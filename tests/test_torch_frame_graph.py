"""The viewer's frame in a CUDA graph (`render/frame.py::FrameGraph`) and
the graph-per-shape helper it shares with the train step
(`_kernels.ShapeGraphs`, `trainer.TrainGraph`).

On the CPU: a FrameGraph is the draw itself; a backend that a capture
cannot enter is refused on a CUDA camera (a stand-in camera: no card
here) before any frame; the helper's sequence (a warm-up, a capture
replayed once, then replays; a graph per image shape; the given camera
copied into the shape's static one) with the capture and replay stood in
for; `render_app --device cpu` writes each mode's eager frames. The
`cuda` case holds replayed frames to eager ones bit for bit on the card
(phase 23 of `chip_smoke.py` does so at 1080p); it imports only the
port."""

import os
import types

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.apps import render_app
from gsrast_tpu_torch.render.api import auto_render_config, render
from gsrast_tpu_torch.render.frame import FrameGraph, frame_refusal
from gsrast_tpu_torch.train.trainer import TrainGraph
from gsrast_tpu_torch.utils.image import load_png, to_uint8
from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids
from gsrast_tpu_torch.viz.pointcloud import render_pointcloud

HERE = os.path.dirname(os.path.abspath(__file__))
TRAINED_SMALL = os.path.join(HERE, "fixtures", "trained_small.ply")
MODES = ("gaussians", "ellipsoids", "pointcloud")

torch.set_num_threads(2)


def _draws(scene, base):
    act = scene.activated()
    rcfg = auto_render_config(scene, base)
    return {"gaussians": lambda cam: render(act, cam, rcfg).image,
            "ellipsoids": lambda cam: render_ellipsoids(act, cam),
            "pointcloud": lambda cam: render_pointcloud(act, cam)}


@pytest.mark.parametrize("mode", MODES)
def test_frame_graph_on_cpu_is_the_draw(mode):
    """On the CPU every call is draw(camera): the draw's own tensor, for
    the camera given; no graph, no slot."""
    scene = gt.load_ply(TRAINED_SMALL)
    base = gt.auto_frame(*scene.bbox(), 40, 24)
    draw = _draws(scene, base)[mode]
    seen = []

    def spy(cam):
        seen.append(cam)
        return draw(cam)

    graph = FrameGraph(spy, mode, "torch")
    views = [base, base.replace(view=gt.look_at([0.4, -0.3, -2.0],
                                                [0.0, 0.0, 0.0]))]
    with torch.inference_mode():
        for cam in views:
            img = graph(cam)
            assert torch.equal(img, draw(cam))
    assert seen == views
    assert graph.captures == graph.replays == 0 and not graph.slots


@pytest.mark.parametrize("mode,backend", [
    ("gaussians", "torch"), ("gaussians", "autograd"),
    ("ellipsoids", "torch"), ("ellipsoids", "dense")])
def test_frame_graph_refuses_what_a_capture_cannot_enter(mode, backend):
    """A CUDA camera (stood in for) with a backend a capture cannot enter
    raises before any frame is drawn."""
    def draw(cam):
        raise AssertionError("a frame was drawn")

    cam = types.SimpleNamespace(device=torch.device("cuda"), height=8,
                                width=8)
    with pytest.raises(ValueError, match=f"backend {backend!r}"):
        FrameGraph(draw, mode, backend)(cam)


def test_frame_refusal():
    assert frame_refusal("gaussians", "cuda") is None
    assert frame_refusal("ellipsoids", "cuda") is None
    for backend in ("cuda", "torch", "autograd", "dense"):
        assert frame_refusal("pointcloud", backend) is None
    assert "host" in frame_refusal("gaussians", "torch")
    assert "host" in frame_refusal("ellipsoids", "torch")
    with pytest.raises(ValueError, match="unknown mode"):
        frame_refusal("splats", "cuda")


class _Graph:
    """A captured fn stood in for on the CPU: a replay runs fn again into
    the capture's output tensor."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        self.out.copy_(self.fn())


def test_shape_graphs_sequence(monkeypatch):
    """Per image shape: the first call runs fn eagerly (on the side stream)
    on the static camera, the second captures it and replays it once, later
    calls replay; each call's camera (view and intrinsics) is copied into
    the shape's static camera, and another shape gets its own graph."""
    log = []

    def capture(fn, what):
        log.append(("capture", what))
        out = fn()
        return _Graph(fn, out), out, {"ellipsoids": 1}

    monkeypatch.setattr(_kernels, "on_side_stream",
                        lambda fn, dev: log.append(("warm",)) or fn())
    monkeypatch.setattr(_kernels, "capture", capture)
    _kernels.reset_launch_counts()
    graphs = _kernels.ShapeGraphs("the test frame")
    base = gt.make_camera(gt.look_at([0.0, 0.0, -2.0], [0.0, 0.0, 0.0]),
                          1.0, 0.8, 8, 6)
    cams = [base.replace(view=gt.look_at([0.1 * i, 0.0, -2.0],
                                         [0.0, 0.0, 0.0]),
                         fov_x=torch.tensor(1.0 + 0.1 * i)) for i in range(4)]

    def fn(cam, scale):
        return cam.view * scale + cam.fov_x

    scale = torch.tensor(2.0)
    outs = [graphs.run(fn, cam, scale).clone() for cam in cams]
    assert log == [("warm",), ("capture", "the test frame (6 x 8)")]
    for cam, out in zip(cams, outs):
        assert torch.equal(out, fn(cam, scale))
    slot = graphs.slots[(6, 8)]
    assert torch.equal(slot.camera.view, cams[-1].view)
    assert slot.camera.view is not cams[-1].view
    assert (graphs.captures, graphs.replays) == (1, 3)
    assert graphs.captured["ellipsoids"] == 1
    assert _kernels.replayed_counts["ellipsoids"] == 3
    assert graphs.replays_next(cams[0])
    wide = base.replace(width=10)
    assert not graphs.replays_next(wide)
    graphs.run(fn, wide, scale)
    assert set(graphs.slots) == {(6, 8), (6, 10)}
    _kernels.reset_launch_counts()


def test_train_graph_is_a_shape_graph():
    """The train step's graph is the same helper with the step's host
    count; on the CPU it is the step itself."""
    calls = []
    graph = TrainGraph(lambda state, cam, target: calls.append(1) or "m")
    assert isinstance(graph, _kernels.ShapeGraphs)
    cam = gt.make_camera(np.eye(4), 1.0, 1.0, 4, 4)
    assert graph(None, cam, torch.zeros(4, 4, 3)) == "m" and calls == [1]
    assert graph.what == "the train step" and not graph.slots


@pytest.mark.parametrize("mode", MODES)
def test_render_app_cpu_frames(mode, tmp_path, capsys):
    """`render_app --device cpu` draws each orbit view eagerly: every PNG
    is the draw of its view, and the `frames:` line reports them."""
    out = tmp_path / "frames"
    report = render_app.main([TRAINED_SMALL, "--mode", mode, "--frames", "2",
                              "--width", "40", "--height", "24", "--outdir",
                              str(out), "--device", "cpu"])
    assert report["frames"] == 2
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "frames: {'frames': 2")
    scene = gt.load_ply(TRAINED_SMALL)
    mn, mx = (x.numpy() for x in scene.bbox())
    base = gt.auto_frame(mn, mx, 40, 24)
    draw = _draws(scene, base)[mode]
    center, radius = 0.5 * (mn + mx), float(np.linalg.norm(mx - mn))
    with torch.inference_mode():
        for i in range(2):
            view = render_app.orbit_view(center, max(radius, 1e-3),
                                         np.pi * i)
            img = draw(base.replace(view=view))
            png = load_png(str(out / f"frame_{i:03d}.png"))
            np.testing.assert_array_equal(
                np.round(png * 255).astype(np.uint8), to_uint8(img))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_replays_equal_eager_frames(mode):
    """On the card: an orbit of 4 views twice through a FrameGraph, each
    frame bitwise equal to the same view drawn eagerly; one capture, 7
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = gt.load_ply(TRAINED_SMALL, device=dev)
    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    base = gt.auto_frame(mn, mx, 128, 96, device=dev)
    center, radius = 0.5 * (mn + mx), float(np.linalg.norm(mx - mn))
    views = [base.replace(view=render_app.orbit_view(
        center, radius, np.pi * i / 2, device=dev)) for i in range(4)]
    with torch.inference_mode():
        draw = _draws(scene, base)[mode]
        eager = [draw(cam).clone() for cam in views]
        graph = FrameGraph(draw, mode, "cuda")
        equal = [torch.equal(graph(cam), ref) for _ in range(2)
                 for cam, ref in zip(views, eager)]
    assert all(equal), equal
    assert (graph.captures, graph.replays) == (1, 7)
