"""The L1 + D-SSIM loss as one autograd node (`train.loss.LossFunction`)
and its plain pair: the Function with `LOSS_TORCH` against autograd through
`rgb_loss_torch`, the plain VJP against `jax.grad` of the reference's
`rgb_loss`, the dispatch, the kernel wrappers' checks, the train step's
`loss` profile stage, and (`-m cuda`, on the card) the kernels of
`csrc/loss.cu` against the plain pair.

`gsrast_tpu` and JAX are imported inside the tests that need them, so that
the `cuda` cases run where only the port imports."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.diag import profile_step
from gsrast_tpu_torch.train import loss as L
from gsrast_tpu_torch.train.loss import (LOSS_CUDA, LOSS_TORCH, LossFunction,
                                         loss_pair, rgb_loss, rgb_loss_torch,
                                         rgb_loss_vjp_torch)

from torch_parity import TRAINED_SMALL

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

# (H, W, C) of the CPU cases: ragged against both kernels' tiles, smaller
# than the 11x11 window, and a multiple of both tiles.
SHAPES = [(37, 53, 3), (5, 7, 3), (32, 64, 3)]
WEIGHTS = [0.0, 0.2, 1.0]


def _pair(shape, seed=0, equal_rows=None):
    """A seeded (pred, target) in [0, 1]: target pred plus noise, clipped,
    its first third of rows equal to pred's (ties, where the L1 term's
    gradient takes abs'(0))."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0.0, 1.0)
    b = b.astype(np.float32)
    rows = shape[0] // 3 if equal_rows is None else equal_rows
    b[:rows] = a[:rows]
    return a, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_function_torch_pair_matches_autograd(shape, weight):
    """`LossFunction` with the plain pair: the value and d_pred bit-equal
    to autograd through `rgb_loss_torch`, as the train step ran it."""
    a, b = _pair(shape)
    assert (a == b).any()
    target = torch.from_numpy(b)
    ref_pred = torch.from_numpy(a).requires_grad_()
    ref = rgb_loss_torch(ref_pred, target, weight)
    ref.backward()
    pred = torch.from_numpy(a).requires_grad_()
    got = LossFunction.apply(LOSS_TORCH, weight, pred, target)
    got.backward()
    assert got.shape == () and torch.equal(got, ref)
    assert torch.equal(pred.grad, ref_pred.grad)


def test_plain_rgb_loss_differentiates_the_target():
    """`rgb_loss` on the plain path differentiates both inputs, as it
    always has; the Function gives the target no gradient and refuses a
    target that requires grad, with either pair."""
    a, b = _pair((37, 53, 3), seed=3)
    pred, target = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    rgb_loss(pred, target, 0.2).backward()
    assert target.grad is not None and float(target.grad.abs().max()) > 0
    for pair in (LOSS_TORCH, LOSS_CUDA):
        with pytest.raises(ValueError, match="no gradient"):
            LossFunction.apply(pair, 0.2, pred, target)


def _jax_loss_and_grad(a, b, weight):
    import jax
    import jax.numpy as jnp

    from gsrast_tpu.train import loss as jax_loss

    x, y = jnp.asarray(a), jnp.asarray(b)
    return (float(jax_loss.rgb_loss(x, y, weight)),
            np.asarray(jax.grad(jax_loss.rgb_loss)(x, y, weight)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_vjp_matches_jax(shape):
    """The plain VJP against `jax.grad` of the reference's `rgb_loss`, on
    a pair with no pixel where pred equals target (see the next test): the
    value within 1e-6 of max(1, |ref|), d_pred within 1e-5 of the largest
    reference magnitude."""
    a, b = _pair(shape, seed=1, equal_rows=0)
    assert not (a == b).any()
    ref, ref_grad = _jax_loss_and_grad(a, b, 0.2)
    pred, target = torch.from_numpy(a), torch.from_numpy(b)
    value = float(rgb_loss_torch(pred, target, 0.2))
    d_pred = rgb_loss_vjp_torch(pred, target, 0.2, torch.ones(()))
    assert not pred.requires_grad
    assert abs(value - ref) <= 1e-6 * max(1.0, abs(ref)), (value, ref)
    scale = float(np.abs(ref_grad).max())
    assert scale > 0
    assert float(np.abs(d_pred.numpy() - ref_grad).max()) <= 1e-5 * scale


def test_plain_vjp_at_ties_takes_pytorch_abs_gradient():
    """At ties, where pred equals target, the plain VJP no longer takes
    PyTorch's abs'(0) = 0 but the reference's: `jax.grad` of `jnp.abs` is
    1 there, and `train.loss.l1` differentiates as it does. On a pair with
    ties (a third of its rows) and without (the rest), d_pred equals the
    reference's within 1e-5 of its largest magnitude everywhere, ties
    included."""
    shape, weight = (37, 53, 3), 0.2
    a, b = _pair(shape, seed=1)
    ties = a == b
    assert ties.any() and not ties.all()
    ref, ref_grad = _jax_loss_and_grad(a, b, weight)
    d_pred = rgb_loss_vjp_torch(torch.from_numpy(a), torch.from_numpy(b),
                                weight, torch.ones(())).numpy()
    scale = float(np.abs(ref_grad).max())
    gap = np.abs(ref_grad - d_pred)
    assert float(gap.max()) <= 1e-5 * scale
    assert float(gap[ties].max()) <= 1e-5 * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_l1_value_equals_torch_abs_form(shape):
    """`rgb_loss_torch`'s value, with the L1 term differentiated as the
    reference's, is bit-equal to the form through `torch.abs` on a pair
    with ties."""
    a, b = _pair(shape, seed=1)
    assert (a == b).any()
    pred, target = torch.from_numpy(a), torch.from_numpy(b)
    for weight in WEIGHTS:
        old = (1.0 - weight) * torch.mean(torch.abs(pred - target)) + (
            weight * (1.0 - L.ssim(pred, target)))
        assert torch.equal(rgb_loss_torch(pred, target, weight), old)


@pytest.mark.parametrize("backend", ["cuda", "torch", "autograd", "dense"])
def test_dispatch(backend, monkeypatch):
    """CPU tensors, whatever the backend, and the backends 'torch',
    'autograd' and 'dense' on any device take the plain version with no
    Function; only 'cuda' on a CUDA device names the kernels."""
    assert loss_pair(backend, torch.device("cpu")) is None
    assert loss_pair(backend, torch.device("cuda")) is (
        LOSS_CUDA if backend == "cuda" else None)

    def refuse(*args):
        raise AssertionError("the Function was reached")

    monkeypatch.setattr(LossFunction, "apply", refuse)
    a, b = _pair((20, 24, 3))
    pred = torch.from_numpy(a).requires_grad_()
    out = rgb_loss(pred, torch.from_numpy(b), 0.2, backend=backend)
    assert out.grad_fn is not None  # autograd through the plain ops
    assert torch.equal(out, rgb_loss_torch(pred, torch.from_numpy(b), 0.2))


def test_kernel_wrappers_check_before_any_launch(monkeypatch):
    """The wrappers refuse CPU tensors, mismatched or non-(H, W, C) shapes,
    other dtypes and an empty image before building or launching
    anything."""
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_kernels, "load", no_build)
    _kernels.reset_launch_counts()
    a, b = (torch.from_numpy(x) for x in _pair((16, 20, 3)))
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA device"):
        L.loss_forward_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA device"):
        L.loss_backward_cuda(a, b, 0.2, one)
    for bad in (b[:, :10], b[..., 0], b.double()):
        with pytest.raises(ValueError, match="one \\(H, W, C\\) shape"):
            L.loss_forward_cuda(a, bad)
    # Any strides pass the layout check (the render's channel planes, a
    # crop of longer rows, an expanded target); the device stops them.
    planar = b.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    rows = torch.zeros((16, 27, 3))[:, :20]
    flat = torch.zeros(3).expand(16, 20, 3)
    for x, y in ((planar, b), (rows, b), (a, flat)):
        assert L._check_layout(x, "pred") == (16, 20, 3)
        with pytest.raises(ValueError, match="CUDA device"):
            L.loss_forward_cuda(x, y)
    with pytest.raises(ValueError, match="nonempty"):
        L._check_layout(torch.zeros((0, 4, 3)), "pred")
    assert not any(_kernels.launch_counts.values())


def test_gaussian_taps():
    """The kernels' taps are float32(g), g the reference window's float64
    factor: their products are within 1.2 ulps a tap of the window the
    plain version filters with (1.18 at the largest), and they sum to 1
    within float32 rounding."""
    taps = L._gaussian_taps(torch.device("cpu")).double()
    window = L._gaussian_window(torch.device("cpu")).double()
    assert taps.shape == (11,) and torch.equal(taps, taps.flip(0))
    outer = taps[:, None] * taps[None, :]
    ulp = torch.from_numpy(np.spacing(window.numpy().astype(np.float32))
                           .astype(np.float64))
    assert bool(((outer - window).abs() <= 1.2 * ulp).all())
    assert abs(float(taps.sum()) - 1.0) <= 1e-6


def test_loss_work_counts():
    """`chip_smoke.loss_work`: bytes of the inputs read once and the output
    written once, operations per value, and the larger bound."""
    work = chip_smoke.loss_work(1080, 1920, 3)
    n = 1080 * 1920 * 3
    assert work["forward"]["bytes"] == 8 * n + 4
    assert work["backward"]["bytes"] == 12 * n + 4
    assert work["forward"]["flops"] == n * chip_smoke.LOSS_FWD_FLOPS
    for kind in ("forward", "backward"):
        w = work[kind]
        assert w["bound_by"] == "operations"
        assert w["bound_ms"] == pytest.approx(
            w["flops"] / chip_smoke.FP32_FLOPS * 1e3)


@pytest.mark.parametrize("backend", ["torch", "autograd"])
def test_cli_train_takes_the_backend_to_the_loss(backend, monkeypatch,
                                                 tmp_path):
    """`train --backend B` scores every step with B's loss: on the CPU
    and under a plain backend, the plain version."""
    from gsrast_tpu_torch import cli

    seen = []

    def spy(name, device):
        seen.append((name, device.type))
        return loss_pair(name, device)

    monkeypatch.setattr(L, "loss_pair", spy)
    cli.main(["train", "--scene", TRAINED_SMALL, "--backend", backend,
              "--steps", "2", "--width", "32", "--height", "24", "--device",
              "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert seen and set(seen) == {(backend, "cpu")}, seen


def test_profile_summary_splits_the_loss():
    """`diag.profile_step.summarize` with the train step's ranges: the
    node made inside `train.loss` takes its backward's launch to the
    `loss` stage; a render stage and `other` keep theirs."""
    def ev(name, cat, tid, ts, dur, **args):
        return {"name": name, "cat": cat, "ph": "X", "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    fwd, bwd = {"Sequence number": 3, "Fwd thread id": 0}, {
        "Sequence number": 3, "Fwd thread id": 1}
    events = [
        ev("profile.eager", "user_annotation", 1, 0.0, 60.0),
        ev("render.blend", "user_annotation", 1, 1.0, 5.0),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 2.0, 1.0, correlation=1),
        ev("train.loss", "user_annotation", 1, 10.0, 8.0),
        ev("LossFunction", "cpu_op", 1, 11.0, 5.0, **fwd),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 12.0, 1.0, correlation=2),
        ev("autograd::engine::evaluate_function: LossFunctionBackward",
           "cpu_op", 2, 20.0, 10.0, **bwd),
        ev("cudaLaunchKernel", "cuda_runtime", 2, 21.0, 1.0, correlation=3),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 40.0, 1.0, correlation=4),
        ev("k1", "kernel", 9, 5.0, 5.0, correlation=1),
        ev("k2", "kernel", 9, 15.0, 5.0, correlation=2),
        ev("k3", "kernel", 9, 25.0, 10.0, correlation=3),
        ev("k4", "kernel", 9, 45.0, 5.0, correlation=4),
    ]
    stages = profile_step.summarize(events, "profile.eager",
                                    ranges=profile_step.TRAIN_RANGES)[
        "stages"]
    assert stages["loss"] == {"kernels": 2, "busy_ms": pytest.approx(0.015)}
    assert stages["blend"] == {"kernels": 1, "busy_ms": pytest.approx(0.005)}
    assert stages["other"] == {"kernels": 1, "busy_ms": pytest.approx(0.005)}
    assert "loss" not in profile_step.summarize(events, "profile.eager")[
        "stages"]


def test_profile_train_cell_has_a_loss_stage(tmp_path, monkeypatch):
    """`diag/profile_step.py`'s train cell at a CPU size splits its eager
    step with a `loss` stage, and the trace holds the `train.loss` range."""
    monkeypatch.setattr(profile_step, "TIMED", 1)
    monkeypatch.setattr(profile_step, "TRAIN_CELLS",
                        {"train_default": (400, 48, 32, None)})
    res = profile_step.profile_train_cell(
        "train_default", str(tmp_path), torch.device("cpu"))
    assert set(res["eager"]["stages"]) == {"prep", "binning", "pack",
                                           "blend", "loss", "other"}
    with open(tmp_path / "train_default_eager" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train.loss" in names


def test_profile_colmap_train_cell(monkeypatch):
    """`train_colmap`: the SfM init of the scene's points (one Gaussian a
    point, SH 3), COLMAP_VIEWS views, each photo the scene's own render."""
    monkeypatch.setattr(profile_step, "COLMAP_VIEWS", 2)
    monkeypatch.setitem(profile_step.TRAIN_CELLS, "train_colmap",
                        (0, 48, 32, TRAINED_SMALL))
    cell = profile_step.train_cell("train_colmap", torch.device("cpu"))
    base = gt.load_ply(TRAINED_SMALL)
    assert cell.scene.capacity == base.capacity
    assert cell.scene.sh.shape[1] == 16
    assert len(cell.views) == len(cell.targets) == 2
    assert cell.targets[0].shape == (32, 48, 3)
    assert not torch.equal(cell.targets[0], cell.targets[1])
    assert cell.extent > 0 and cell.tc == profile_step.TrainConfig()


def test_loss_timing_refuses_trees_outside_the_checkout(tmp_path, capsys):
    """`diag.loss_timing` builds and runs each tree it times in place, so
    it takes only trees inside this checkout."""
    from gsrast_tpu_torch.diag import loss_timing

    assert loss_timing.main(["--tree", str(tmp_path)]) == 2
    assert "outside" in capsys.readouterr().err


def test_loss_timing_summary(tmp_path, monkeypatch, capsys):
    """`loss_timing.summarise` on two trees' saved outputs and readings:
    each tree's ms of every run, its share of the bound at its best run,
    and each output against the first tree's."""
    from gsrast_tpu_torch.diag import loss_timing as lt

    monkeypatch.setattr(lt, "HERE", tmp_path)
    monkeypatch.setattr(lt, "OUT", tmp_path / "out")
    lt.OUT.mkdir()
    trees = [tmp_path, tmp_path / "_archive" / "parent"]
    grad = torch.tensor([[[1.0, -2.0, 3.0]]])
    for tree, shift, ms in zip(trees, (0.0, 0.25), ([0.2, 0.3], [0.8, 0.9])):
        torch.save({"edge": {"forward": torch.tensor(0.5),
                             "backward": grad + torch.tensor([0.0, 0.0,
                                                              shift])}},
                   lt.OUT / f"{lt.tag(tree)}.pt")
        (lt.OUT / f"{lt.tag(tree)}.jsonl").write_text("".join(
            json.dumps({"ms": {"edge": {"forward": 0.1, "backward": t}}})
            + "\n" for t in ms))
    info = {"edge": {"label": "edge", "shape": [1, 1, 3],
                     "bounds": {"forward": (0.05, "operations"),
                                "backward": (0.1, "operations")}}}
    lt.summarise(trees, info)
    line = json.loads(capsys.readouterr().out)
    assert line["cell"] == "edge" and line["shape"] == [1, 1, 3]
    assert "bounds" not in line
    bwd = line["backward"]
    assert bwd["bound_ms"] == 0.1 and bwd["bound_by"] == "operations"
    here, parent = bwd["trees"]["."], bwd["trees"]["_archive/parent"]
    assert here["ms"] == [0.2, 0.3] and parent["ms"] == [0.8, 0.9]
    assert here["share"] == pytest.approx(0.5)
    assert parent["share"] == pytest.approx(0.125)
    assert here["against_first"] == {"differ": 0, "max_abs_diff": 0.0}
    assert parent["against_first"] == {"differ": 1, "max_abs_diff": 0.25}
    assert line["forward"]["trees"]["_archive/parent"]["against_first"] == {
        "differ": 0, "max_abs_diff": 0.0}


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_pair(dev, shape, seed=0, layout="rows"):
    """`_pair` on the card, pred laid out as `layout`: "rows", (H, W, C)
    rows 5 pixels longer than W (a crop's view); "planar", channel planes
    seen as (H, W, C) (the render's image)."""
    a, b = _pair(shape, seed)
    h, w, c = shape
    if layout == "planar":
        pred = torch.from_numpy(a).to(dev).permute(2, 0, 1).contiguous()
        pred = pred.permute(1, 2, 0)
    else:
        rows = torch.empty((h, w + 5, c), device=dev)
        pred = rows[:, :w].copy_(torch.from_numpy(a))
    return pred, torch.from_numpy(b).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [
    ((1080, 1920, 3), "planar"), ((1081, 1919, 3), "rows"),
    ((37, 53, 3), "rows"), ((37, 53, 3), "planar"), ((5, 7, 3), "rows"),
    ((32, 64, 3), "planar"), ((245, 383, 3), "rows"),
    ((300, 236, 3), "planar")])
def test_cuda_kernels_match_plain(shape, layout):
    """The kernels against the plain pair on the same card inputs, both
    held to the plain version in float64 (`chip_smoke.compare_loss`), and
    two launches bit-equal; d_pred laid out as a dense pred. Every pair has
    a third of its rows tied, where d_pred holds too; 245x383 is ragged
    against both kernels' strips (128 and 118 columns) and segments, and
    300x236 is two backward strips wide."""
    dev = _card()
    pred, target = _card_pair(dev, shape, layout=layout)
    _kernels.reset_launch_counts()
    res = chip_smoke.compare_loss(pred, target, 0.2)
    assert _kernels.launch_counts["loss_forward"] == 2
    assert _kernels.launch_counts["loss_backward"] == 2
    assert res["finite"] and res["same_bits_twice"], res
    assert res["loss_err"] <= res["loss_tol"], res
    assert res["grad_err"] <= res["grad_tol"], res
    assert res["ties"] > 0 and res["tie_grad_err"] <= res["grad_tol"], res
    d_pred = L.loss_backward_cuda(pred, target, 0.2,
                                  torch.ones((), device=dev))
    assert d_pred.stride() == (pred.stride() if layout == "planar"
                               else target.stride())


@pytest.mark.cuda
def test_cuda_function_matches_plain_through_autograd():
    """`rgb_loss` on CUDA tensors goes through the kernels: one launch each
    way, and d_pred within the float64-anchored tolerance of the plain
    version's."""
    dev = _card()
    pred, target = _card_pair(dev, (64, 80, 3))
    leaf = pred.detach().clone().requires_grad_()
    _kernels.reset_launch_counts()
    rgb_loss(leaf, target, 0.2).backward()
    assert _kernels.launch_counts["loss_forward"] == 1
    assert _kernels.launch_counts["loss_backward"] == 1
    ref = rgb_loss_vjp_torch(pred, target, 0.2, torch.ones((), device=dev))
    scale = float(ref.abs().max())
    assert float((leaf.grad - ref).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError, match="no gradient"):
        rgb_loss(leaf, target.clone().requires_grad_(), 0.2)


@pytest.mark.cuda
def test_cuda_capture_replays_eager():
    """Both kernels captured once and replayed on a second image copied in
    equal eager calls on it (`chip_smoke.loss_capture`)."""
    dev = _card()
    pred, target = _card_pair(dev, (96, 128, 3), seed=2)
    cap = chip_smoke.loss_capture(pred, target, 0.2)
    assert cap["replay_equals_eager"] and cap["moved"] > 0, cap
    assert cap["recorded"] == {"loss_forward": 1, "loss_backward": 1}, cap


@pytest.mark.cuda
@pytest.mark.parametrize("command", ["render", "train"])
def test_cuda_torch_backend_launches_no_loss_kernel(command, tmp_path):
    """`render` and `train --backend torch` on the card launch no kernel,
    the loss's included."""
    from gsrast_tpu_torch import cli

    _card()
    argv = [command, TRAINED_SMALL, "--backend", "torch", "--width", "64",
            "--height", "48"]
    if command == "train":
        argv = ["train", "--scene", TRAINED_SMALL, "--backend", "torch",
                "--steps", "2", "--width", "64", "--height", "48",
                "--ckpt-dir", str(tmp_path / "ckpt")]
    else:
        argv += ["--out", str(tmp_path / "out.png")]
    _kernels.reset_launch_counts()
    cli.main(argv)
    torch.cuda.synchronize()
    assert not any(_kernels.launch_counts.values()), _kernels.launch_counts
