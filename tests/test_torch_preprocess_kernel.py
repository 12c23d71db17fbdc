"""The preprocess as one autograd node (`ops.preprocess.PreprocessFunction`)
and its plain pair: the Function with `PREPROCESS_TORCH` against autograd
through `preprocess_torch`, the plain VJP against `jax.vjp` of the
reference's preprocess, a whole render's gradients through the Function
against the reference's, the dispatch, and (`-m cuda`, on the card) the
kernels of `csrc/preprocess.cu` against the plain pair.

`gsrast_tpu` and JAX are imported inside the tests that need them, so that
the `cuda` cases run where only the port imports."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.camera import CAMERA_FLOATS, CAMERA_TENSORS, device_camera
from gsrast_tpu_torch.ops import preprocess as pp
from gsrast_tpu_torch.ops.preprocess import (
    PREPROCESS_CUDA, PREPROCESS_TORCH, Cotangents, PreprocessFunction,
    preprocess, preprocess_pair, preprocess_torch, preprocess_vjp_torch)
from gsrast_tpu_torch.scene.gaussians import ActivatedGaussians

from torch_parity import (SCENE_FIELDS, TRAINED_SMALL, port_front_camera,
                          seeded_arrays, t2n)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

OUTPUTS = ("mean2d", "depth", "conic", "color", "opacity")
SHAPES = {"mean2d": (2,), "depth": (), "conic": (3,), "color": (3,),
          "opacity": ()}
# The plain VJP against jax.vjp of the reference, per gradient group:
# |port - reference| <= RTOL |reference| + ATOL_REL max |reference| of the
# group. Both differentiate the same float32 ops, but XLA fuses and
# reassociates its elementwise chains (and takes sqrt's and the divisions'
# derivatives in other forms), so each term moves by a few ulps of the
# largest one summed into the same gradient.
RTOL, ATOL_REL = 1e-5, 1e-5
# The kernels against the plain pair on the card: float outputs within
# rtol 1e-5 / atol 1e-6 (the forward rounds op by op as the plain version
# does, but a short sum may run in another order), gradients within 1e-5
# of each group's largest magnitude (the backward's own products contract
# into FMAs and take the derivatives in closed form).
CUDA_RTOL, CUDA_ATOL, CUDA_GRAD_RTOL = 1e-5, 1e-6, 1e-5


def _culled_scene(seed: int, n: int, sh_degree: int) -> dict:
    """Arrays of a scene that the front camera (4 units back on -z) sees in
    part: some Gaussians behind it, some beyond the NDC margin."""
    return seeded_arrays(seed, n, sh_degree=sh_degree, extent=6.0)


def _cotangents(n: int, seed: int, missing=()) -> Cotangents:
    rng = np.random.default_rng(seed)
    return Cotangents(**{
        name: None if name in missing else torch.from_numpy(
            rng.standard_normal((n, *SHAPES[name])).astype(np.float32))
        for name in OUTPUTS})


def _inputs(arrays: dict, device="cpu"):
    """(scene, activated leaves requiring grad) of the arrays."""
    scene = gt.from_numpy(arrays, device=device)
    act = scene.activated()
    leaves = {f: getattr(act, f).detach().clone().requires_grad_()
              for f in pp.INPUT_FIELDS}
    return scene, ActivatedGaussians(**leaves, mask=act.mask), leaves


def _through(pair, inputs, camera, rcfg, delta=None):
    outs = PreprocessFunction.apply(
        pair, camera, rcfg, delta,
        *(getattr(inputs, f) for f in pp.INPUT_FIELDS), inputs.mask)
    return pp.Preprocessed(*outs[:6], pp.projection.TileRect(*outs[6:]))


def _pullback(out, cot: Cotangents, wrt: list) -> list:
    pairs = [(getattr(out, name), c) for name, c in zip(OUTPUTS, cot)
             if c is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(w) if g is None else g
            for g, w in zip(grads, wrt)]


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("missing", [(), ("depth", "opacity")])
def test_function_torch_pair_matches_autograd(sh_degree, with_delta,
                                              missing):
    """The Function with the plain pair is autograd through
    `preprocess_torch`, bit for bit: outputs, and the gradients of every
    group for seeded cotangents on every Gaussian, culled ones included
    (None where `missing`)."""
    n = 300
    arrays = _culled_scene(20 + sh_degree, n, sh_degree)
    cam = port_front_camera(128, 96)
    rcfg = gt.RenderConfig(tile_h=16, tile_w=32)
    _, inputs, leaves = _inputs(arrays)
    wrt = list(leaves.values())
    delta = None
    if with_delta:
        delta = torch.zeros((n, 2), requires_grad=True)
        wrt.append(delta)
    cot = _cotangents(n, 7, missing)

    ref = preprocess_torch(inputs, cam, rcfg, delta)
    got = _through(PREPROCESS_TORCH, inputs, cam, rcfg, delta)
    for name in pp.Preprocessed._fields[:6]:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for a, b in zip(got.rect, ref.rect):
        assert torch.equal(a, b)
    depth = t2n(ref.depth)
    radius = t2n(ref.radius)
    assert (depth < 0).any() and (radius == 0).any() and (radius > 0).any()
    assert ((depth > 0) & (radius == 0)).any()  # beyond the NDC margin

    g_ref = _pullback(ref, cot, wrt)
    g_got = _pullback(got, cot, wrt)
    for name, a, b in zip([*pp.INPUT_FIELDS, "mean2d_delta"], g_got, g_ref):
        assert torch.equal(a, b), name
        reached = not (name == "opacities" and "opacity" in missing)
        assert (float(b.abs().max()) > 0) == reached, name
    if with_delta:
        assert torch.equal(g_got[-1], cot.mean2d)


@pytest.mark.parametrize("sh_degree,config_degree",
                         [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)])
def test_function_torch_pair_below_scene_degree(sh_degree, config_degree):
    """The Function with the plain pair under a config of lower SH degree
    than the scene's: outputs and every group's gradients bit-equal to
    autograd through `preprocess_torch`, and the SH rows past the
    (config_degree + 1)^2 evaluated ones zero gradients, the evaluated ones
    reached."""
    n = 300
    arrays = _culled_scene(40 + sh_degree, n, sh_degree)
    cam = port_front_camera(128, 96)
    rcfg = gt.RenderConfig(tile_h=16, tile_w=32, sh_degree=config_degree)
    _, inputs, leaves = _inputs(arrays)
    wrt = list(leaves.values())
    cot = _cotangents(n, 9)
    ref = preprocess_torch(inputs, cam, rcfg)
    got = _through(PREPROCESS_TORCH, inputs, cam, rcfg)
    for name in pp.Preprocessed._fields[:6]:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    g_got = _pullback(got, cot, wrt)
    for name, a, b in zip(pp.INPUT_FIELDS, g_got, _pullback(ref, cot, wrt)):
        assert torch.equal(a, b), name
    used = (config_degree + 1) ** 2
    g_sh = g_got[pp.INPUT_FIELDS.index("sh")]
    assert g_sh.shape[1] == (sh_degree + 1) ** 2
    assert not g_sh[:, used:].any()
    assert bool((g_sh[:, :used].abs().amax(0) > 0).all())


def _jax_vjp(arrays: dict, jcam, jcfg, cot: Cotangents) -> dict:
    """jax.vjp of the reference's preprocess over the activated inputs."""
    import jax
    import jax.numpy as jnp
    from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
    from gsrast_tpu.scene.gaussians import ActivatedGaussians, from_arrays

    act = from_arrays(*(arrays[f] for f in SCENE_FIELDS)).activated()

    def fn(means, scales, quats, opacities, sh):
        p = jax_preprocess(ActivatedGaussians(means, scales, quats, opacities,
                                              sh, act.mask), jcam, jcfg)
        return tuple(getattr(p, name) for name in OUTPUTS)

    _, vjp = jax.vjp(fn, *(getattr(act, f) for f in pp.INPUT_FIELDS))
    grads = vjp(tuple(jnp.asarray(t2n(c)) for c in cot))
    return dict(zip(pp.INPUT_FIELDS, (np.asarray(g) for g in grads)))


@pytest.mark.parametrize("case", ["sh3_aniso", "trained_small",
                                  "sh3_at_degree1", "sh3_at_degree0",
                                  "sh3_at_degree2", "sh2_at_degree1"])
def test_plain_vjp_matches_jax(case):
    """`preprocess_vjp_torch` against jax.vjp of the reference's
    preprocess, the cases of test_torch_preprocess.py with seeded
    cotangents on every output and Gaussian; and scenes of SH degree d
    under a config of degree c < d (`shd_at_degreec`), whose SH rows past
    the (c + 1)^2 evaluated get zero gradients in both."""
    import gsrast_tpu as gs
    from torch_parity import camera_to_torch, front_camera, jax_scene_arrays

    scene_degree, degree = 3, 3
    if "_at_degree" in case:
        scene_degree, degree = int(case[2]), int(case[-1])
    if case == "trained_small":
        ref_scene = gs.load_ply(TRAINED_SMALL)
        arrays = jax_scene_arrays(ref_scene)
        jcam = gs.auto_frame(*ref_scene.bbox(), 128, 128)
        cam = camera_to_torch(jcam)
    else:
        arrays = seeded_arrays(11, 200, sh_degree=scene_degree, extent=2.5)
        jcam, cam = front_camera(128, 96)
    jcfg = gs.RenderConfig(tile_h=16, tile_w=32, sh_degree=degree)
    rcfg = gt.RenderConfig(tile_h=16, tile_w=32, sh_degree=degree)
    scene = gt.from_numpy(arrays)
    n = scene.capacity
    cot = _cotangents(n, 3)
    got = preprocess_vjp_torch(scene.activated(), cam, rcfg, cot)
    ref = _jax_vjp(arrays, jcam, jcfg, cot)
    for name in pp.INPUT_FIELDS:
        a, b = t2n(getattr(got, name)), ref[name]
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_REL * scale,
                                   err_msg=name)
    if degree < scene_degree:
        used = (degree + 1) ** 2
        assert got.sh.shape[1] == (scene_degree + 1) ** 2
        assert not np.any(t2n(got.sh)[:, used:])
        assert not np.any(ref["sh"][:, used:])
    assert got.mean2d_delta is None


class _Counted:
    """PREPROCESS_TORCH with its forward and backward calls counted."""

    def __init__(self):
        self.calls = {"forward": 0, "backward": 0}

        def counted(kind):
            def fn(*args):
                self.calls[kind] += 1
                return getattr(PREPROCESS_TORCH, kind)(*args)
            return fn

        self.pair = pp.PreprocessPair(PREPROCESS_TORCH.camera,
                                      counted("forward"), counted("backward"))


def test_render_gradients_through_function_match_jax(monkeypatch):
    """A render and its loss's gradients with the preprocess routed through
    `PreprocessFunction` (the plain pair forced by the dispatch) against
    `jax.grad` through the reference's `render_tiled_pallas` (interpret
    mode), the five groups and mean2d_delta, as test_torch_grad.py holds
    the autograd route: per group within 1e-4 of its largest |g|."""
    import jax
    import jax.numpy as jnp
    from gsrast_tpu.render.api import auto_render_config as jax_auto_config
    from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
    from gsrast_tpu.scene.gaussians import merge_params, split_params
    from torch_parity import front_camera, scenes

    counted = _Counted()
    monkeypatch.setattr(pp, "preprocess_pair",
                        lambda rcfg, device: counted.pair)
    ref_scene, port_scene = scenes(seeded_arrays(5, 60, sh_degree=2))
    jcam, cam = front_camera(256, 32)
    background = (0.1, 0.2, 0.3)
    jcfg = jax_auto_config(ref_scene, jcam, backend="pallas").replace(
        background=background)
    pcfg = gt.auto_render_config(port_scene, cam).replace(
        background=background)
    counted.calls.update(forward=0, backward=0)  # the config's tile counts
    params, mask = split_params(ref_scene)
    n = ref_scene.capacity

    def jax_loss(p, delta):
        out = render_tiled_pallas(merge_params(p, mask).activated(), jcam,
                                  jcfg, mean2d_delta=delta)
        return jnp.mean((out.image - 0.25) ** 2) + 0.1 * jnp.mean(out.final_t)

    ref_grads, ref_delta = jax.grad(jax_loss, argnums=(0, 1))(
        params, jnp.zeros((n, 2), jnp.float32))
    delta = torch.zeros((n, 2), requires_grad=True)
    out = gt.render(port_scene, cam, pcfg, mean2d_delta=delta)
    (torch.mean((out.image - 0.25) ** 2)
     + 0.1 * torch.mean(out.final_t)).backward()
    assert counted.calls == {"forward": 1, "backward": 1}
    port = {f: getattr(port_scene, f).grad for f in SCENE_FIELDS}
    port["mean2d_delta"] = delta.grad
    ref = dict(ref_grads, mean2d_delta=ref_delta)
    for name, g in port.items():
        r = np.asarray(ref[name]).reshape(t2n(g).shape)
        scale = float(np.abs(r).max())
        assert scale > 0, name
        assert float(np.abs(t2n(g) - r).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("backend", ["cuda", "torch", "autograd", "dense"])
def test_dispatch(backend, monkeypatch):
    """CPU tensors, whatever the backend, and the backends 'torch',
    'autograd' and 'dense' on any device take the plain version with no
    Function; only 'cuda' on a CUDA device names the kernels."""
    rcfg = gt.RenderConfig(tile_h=16, tile_w=32, backend=backend)
    assert preprocess_pair(rcfg, torch.device("cpu")) is None
    assert preprocess_pair(rcfg, torch.device("cuda")) is (
        PREPROCESS_CUDA if backend == "cuda" else None)

    def refuse(*args):
        raise AssertionError("the Function was reached")

    monkeypatch.setattr(PreprocessFunction, "apply", refuse)
    scene = gt.from_numpy(seeded_arrays(2, 40, sh_degree=1))
    cam = port_front_camera(64, 32)
    prep = preprocess(scene.activated(), cam, rcfg)
    assert prep.mean2d.grad_fn is not None  # autograd through the plain ops
    if backend != "cuda":  # the blend kernels take only CUDA tensors
        assert gt.render(scene, cam, rcfg).image.shape == (32, 64, 3)


@pytest.mark.parametrize("backend", ["torch", "autograd"])
def test_cli_backend_takes_every_preprocess(backend, monkeypatch, tmp_path):
    """`render --backend B` runs every preprocess of the command on B, the
    config's tile counts included: on the card a plain backend launches no
    kernel."""
    from gsrast_tpu_torch import cli

    seen = []

    def spy(rcfg, device):
        seen.append(rcfg.backend)
        return preprocess_pair(rcfg, device)

    monkeypatch.setattr(pp, "preprocess_pair", spy)
    cli.main(["render", TRAINED_SMALL, "--backend", backend, "--width", "64",
              "--height", "48", "--device", "cpu", "--out",
              str(tmp_path / "out.png")])
    assert seen and set(seen) == {backend}, seen


def test_function_refuses_camera_grad():
    """The camera gets no gradient: a camera tensor that requires one makes
    the Function raise."""
    _, inputs, _ = _inputs(seeded_arrays(4, 20, sh_degree=0))
    cam = port_front_camera(64, 32)
    cam = cam.replace(view=cam.view.clone().requires_grad_())
    with pytest.raises(ValueError, match="camera no gradient"):
        _through(PREPROCESS_TORCH, inputs, cam, gt.RenderConfig())


def test_device_camera_block():
    """The camera block holds the floats the plain version computes, at the
    offsets csrc/preprocess.cu reads."""
    cam = port_front_camera(160, 96)
    dcam = device_camera(cam)
    block = dcam.block
    assert block.shape == (CAMERA_FLOATS,) and block.dtype == torch.float32
    assert (dcam.width, dcam.height) == (160, 96)
    assert torch.equal(block[:16], cam.view.reshape(16))
    assert torch.equal(block[16:32], cam.full_projection().reshape(16))
    assert torch.equal(block[32:35], cam.position)
    assert torch.equal(block[35:], torch.stack(
        [cam.focal_x, cam.focal_y, cam.tan_fov_x, cam.tan_fov_y]))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers check their inputs before any build: CPU tensors raise,
    and a cotangent of the wrong shape is named."""
    scene = gt.from_numpy(seeded_arrays(4, 20, sh_degree=1))
    act = scene.activated()
    dcam = device_camera(port_front_camera(64, 32))
    rcfg = gt.RenderConfig()
    with pytest.raises(ValueError, match="CUDA device"):
        pp.preprocess_forward_cuda(act, dcam, rcfg)
    with pytest.raises(ValueError, match="CUDA device"):
        pp.preprocess_backward_cuda(act, dcam, rcfg, _cotangents(20, 1))
    with pytest.raises(ValueError, match="conic cotangent"):
        pp._cotangent_args(_cotangents(20, 1)._replace(
            conic=torch.zeros(20, 2)), 20, torch.device("cpu"))


def test_cotangent_strides():
    """The cotangents reach the kernel with their strides: the transposed
    rows of render/pipeline.py's feature rows, and null pointers with zero
    strides where absent."""
    n = 10
    rows = torch.zeros((9, n))
    cot = Cotangents(rows[0:2].T, None, rows[2:5].T, rows[6:9].T, rows[5])
    args = pp._cotangent_args(cot, n, torch.device("cpu"))
    assert args[1:3] == [1, n] and args[3:5] == [None, 0]
    assert args[6:8] == [1, n] and args[9:11] == [1, n] and args[12] == 1


def _staged_shared(k: int) -> int:
    """The backward's dynamic shared bytes a block at K SH rows, as
    csrc/preprocess.cu stages them: 4 warps of 32 rows, 3K | 1 floats a
    row."""
    return 4 * 32 * ((3 * k) | 1) * 4


def test_preprocess_timing_refuses_trees_outside_the_checkout(tmp_path,
                                                            capsys):
    """`diag.preprocess_timing` builds and runs each tree it times in
    place, so it takes only trees inside this checkout."""
    from gsrast_tpu_torch.diag import preprocess_timing

    assert preprocess_timing.main(["--tree", str(tmp_path)]) == 2
    assert "outside" in capsys.readouterr().err


def test_preprocess_timing_summary(tmp_path, monkeypatch, capsys):
    """`preprocess_timing.summarise` on two trees' saved outputs and
    readings: each tree's ms of every run, its share of the bound at its
    best run, and each output against the first tree's (NaN equal to NaN)."""
    import json

    from gsrast_tpu_torch.diag import preprocess_timing as pt

    monkeypatch.setattr(pt, "HERE", tmp_path)
    monkeypatch.setattr(pt, "OUT", tmp_path / "out")
    pt.OUT.mkdir()
    trees = [tmp_path, tmp_path / "_archive" / "parent"]
    grads = torch.tensor([1.0, float("nan"), 3.0])
    for tree, shift, ms in zip(trees, (0.0, 0.25), ([0.2, 0.3], [0.8, 0.9])):
        torch.save({"1M": {"forward": {"depth": grads.clone()},
                           "backward": {"sh": grads + torch.tensor(
                               [0.0, 0.0, shift])}}},
                   pt.OUT / f"{pt.tag(tree)}.pt")
        (pt.OUT / f"{pt.tag(tree)}.jsonl").write_text("".join(
            json.dumps({"ms": {"1M": {"forward": 0.1, "backward": t}}}) + "\n"
            for t in ms))
    info = {"1M": {"label": "1M SH3", "gaussians": 3,
                   "bounds": {"forward": (0.05, "bytes"),
                              "backward": (0.1, "bytes")}}}
    pt.summarise(trees, info)
    line = json.loads(capsys.readouterr().out)
    assert line["cell"] == "1M" and line["gaussians"] == 3
    assert "bounds" not in line
    bwd = line["backward"]
    assert bwd["bound_ms"] == 0.1 and bwd["bound_by"] == "bytes"
    here, parent = bwd["trees"]["."], bwd["trees"]["_archive/parent"]
    assert here["ms"] == [0.2, 0.3] and parent["ms"] == [0.8, 0.9]
    assert here["share"] == pytest.approx(0.5)
    assert parent["share"] == pytest.approx(0.125)
    assert here["against_first"]["sh"] == {"differ": 0, "max_abs_diff": 0.0}
    assert parent["against_first"]["sh"] == {"differ": 1,
                                             "max_abs_diff": 0.25}
    assert line["forward"]["trees"]["_archive/parent"]["against_first"] == {
        "depth": {"differ": 0, "max_abs_diff": 0.0}}


def test_preprocess_timing_summary_cold(tmp_path, monkeypatch, capsys):
    """Runs that hold the forward's cold ms, the launch floor and the
    forward's launch: the summary gives per tree the cold ms of every run,
    the cold share at the best, each run's floor and the last run's launch
    (None for a tree that does not report it)."""
    import json

    from gsrast_tpu_torch.diag import preprocess_timing as pt

    monkeypatch.setattr(pt, "HERE", tmp_path)
    monkeypatch.setattr(pt, "OUT", tmp_path / "out")
    pt.OUT.mkdir()
    trees = [tmp_path / "_archive" / "parent", tmp_path]
    launch = {"registers": 96, "resident_warps": 12}
    for tree, cold, reported in zip(trees, ([0.2, 0.25], [0.1, 0.125]),
                                    (None, {"1M": launch})):
        torch.save({"1M": {"forward": {"depth": torch.ones(2)},
                           "backward": {"sh": torch.ones(2)}}},
                   pt.OUT / f"{pt.tag(tree)}.pt")
        (pt.OUT / f"{pt.tag(tree)}.jsonl").write_text("".join(
            json.dumps({"ms": {"1M": {"forward": 0.1, "backward": 0.2}},
                        "cold_ms": {"1M": c},
                        "launch_floor": {"ms": 0.005, "warm_ms": 0.002},
                        "launch": reported}) + "\n" for c in cold))
    info = {"1M": {"label": "1M SH3", "gaussians": 2,
                   "bounds": {"forward": (0.05, "bytes"),
                              "backward": (0.1, "bytes")}}}
    pt.summarise(trees, info)
    fwd = json.loads(capsys.readouterr().out)["forward"]["trees"]
    parent, here = fwd["_archive/parent"], fwd["."]
    assert parent["cold_ms"] == [0.2, 0.25] and here["cold_ms"] == [0.1,
                                                                      0.125]
    assert parent["cold_share"] == pytest.approx(0.25)
    assert here["cold_share"] == pytest.approx(0.5)
    assert here["launch_floor"] == [{"ms": 0.005, "warm_ms": 0.002}] * 2
    assert parent["launch"] is None and here["launch"] == launch
    assert here["against_first"]["depth"]["differ"] == 0


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_case(dev, sh_degree=3, n=3000, config_degree=3, sh_offset=0):
    """A culled scene's inputs on the card, the front camera and a config
    of `config_degree`; the SH rows a view `sh_offset` floats into their
    storage."""
    arrays = _culled_scene(31, n, sh_degree)
    _, inputs, _ = _inputs(arrays, device=dev)
    if sh_offset:
        sh = inputs.sh.detach()
        shifted = torch.empty(sh.numel() + sh_offset, device=dev)
        shifted = shifted[sh_offset:].view_as(sh).copy_(sh)
        inputs = dataclasses.replace(inputs, sh=shifted)
    cam = port_front_camera(256, 128, device=dev)
    return inputs, cam, gt.RenderConfig(tile_h=16, tile_w=32,
                                        sh_degree=config_degree)


def _close_or_tie(got, ref):
    """Float outputs within CUDA_RTOL/CUDA_ATOL; integer outputs equal but
    at Gaussians whose plain float outputs sit where a ceil or a cull
    threshold could flip within rounding (counted, at most 0.1%)."""
    for name in ("mean2d", "depth", "conic", "color", "opacity"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=CUDA_RTOL, atol=CUDA_ATOL)
    bad = got.radius != ref.radius
    for a, b in zip(got.rect, ref.rect):
        bad |= a != b
    assert int(bad.sum()) <= max(1, bad.numel() // 1000), int(bad.sum())


# (scene SH degree, config SH degree, N, SH rows' offset in floats) of the
# card cases: every degree, a config below the scene's (rows past the ones
# evaluated), a count that leaves one warp of the backward 31 lanes, one
# that leaves it 1, and rows that start 4 bytes past a 16-byte boundary.
CARD_CASES = [(*degrees, n, 0)
              for degrees in ((0, 0), (1, 1), (2, 2), (3, 3), (3, 1))
              for n in (31, 257, 3000)] + [(3, 1, 257, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("sh_degree,config_degree,n,sh_offset", CARD_CASES)
def test_cuda_kernels_match_plain(sh_degree, config_degree, n, sh_offset):
    """The forward kernel against `preprocess_torch` and the backward
    against `preprocess_vjp_torch` on the same card inputs, seeded
    cotangents on every Gaussian; the backward's two launches bit-equal."""
    dev = _card()
    inputs, cam, rcfg = _card_case(dev, sh_degree, n, config_degree,
                                   sh_offset)
    assert inputs.sh.data_ptr() % 16 == 4 * sh_offset
    delta = torch.zeros((inputs.means.shape[0], 2), device=dev)
    _kernels.reset_launch_counts()
    got = PREPROCESS_CUDA.forward(inputs, device_camera(cam), rcfg, delta)
    _close_or_tie(got, preprocess_torch(inputs, cam, rcfg, delta))
    cot = Cotangents(*(None if c is None else c.to(dev)
                       for c in _cotangents(inputs.means.shape[0], 5)))
    first = PREPROCESS_CUDA.backward(inputs, device_camera(cam), rcfg, cot,
                                     delta)
    second = PREPROCESS_CUDA.backward(inputs, device_camera(cam), rcfg, cot,
                                      delta)
    ref = preprocess_vjp_torch(inputs, cam, rcfg, cot, delta)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["preprocess_forward"] == 1
    assert _kernels.launch_counts["preprocess_backward"] == 2
    for name in pp.INPUT_FIELDS:
        a, b = getattr(first, name), getattr(ref, name)
        assert torch.equal(a, getattr(second, name)), name
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= (
            CUDA_GRAD_RTOL * scale), name
    assert torch.equal(first.mean2d_delta, cot.mean2d)


@pytest.mark.cuda
def test_cuda_capture_follows_camera():
    """The kernels captured once in a CUDA graph, then replayed with a
    second camera copied into the captured camera's tensors: the replay's
    outputs and gradients equal an eager call on the second camera."""
    dev = _card()
    inputs, cam, rcfg = _card_case(dev)
    other = gt.make_camera(gt.look_at([0.5, -0.3, -3.5], [0.1, 0.0, 0.0],
                                      device=dev), 1.1, 0.9, cam.width,
                           cam.height, device=dev)
    static = cam.replace(**{f: getattr(cam, f).clone()
                            for f in CAMERA_TENSORS})
    cot = Cotangents(*(None if c is None else c.to(dev)
                       for c in _cotangents(inputs.means.shape[0], 6)))

    def run():
        dcam = device_camera(static)
        return (PREPROCESS_CUDA.forward(inputs, dcam, rcfg),
                PREPROCESS_CUDA.backward(inputs, dcam, rcfg, cot))

    _kernels.on_side_stream(run, dev)
    graph, (fwd, bwd), _ = _kernels.capture(run, "the preprocess")
    for f in CAMERA_TENSORS:
        getattr(static, f).copy_(getattr(other, f))
    graph.replay()
    dcam = device_camera(other)
    eager_fwd = PREPROCESS_CUDA.forward(inputs, dcam, rcfg)
    eager_bwd = PREPROCESS_CUDA.backward(inputs, dcam, rcfg, cot)
    torch.cuda.synchronize()
    for a, b in zip(fwd[:6], eager_fwd[:6]):
        assert torch.equal(a, b)
    for a, b in zip(fwd.rect, eager_fwd.rect):
        assert torch.equal(a, b)
    for a, b in zip(bwd[:5], eager_bwd[:5]):
        assert torch.equal(a, b)
    assert not torch.equal(fwd.mean2d, PREPROCESS_CUDA.forward(
        inputs, device_camera(cam), rcfg).mean2d)


@pytest.mark.cuda
def test_cuda_backward_occupancy():
    """The backward's launch as the library reports it for K = 1..16 and
    each degree whose rows fit: 128 threads and `_staged_shared(k)`
    dynamic bytes a block, the camera's 39 floats of static shared memory
    (padded to 16 bytes before the dynamic rows), registers within the 255
    a thread, and at least one block an SM."""
    _card()
    for k in range(1, 17):
        for degree in range(4):
            if (degree + 1) ** 2 > k:
                continue
            launch = chip_smoke.backward_occupancy(k, degree)
            assert launch["threads"] == 128, launch
            assert launch["dynamic_shared"] == _staged_shared(k), launch
            camera = 4 * CAMERA_FLOATS
            assert camera <= launch["static_shared"] < camera + 16, launch
            assert 0 < launch["registers"] <= 255, launch
            assert launch["resident_warps"] >= 4, launch


@pytest.mark.cuda
def test_cuda_forward_occupancy():
    """The forward's launch as the library reports it for each degree: 128
    threads; per warp two stages of its chunk's inputs and its outputs in
    dynamic shared memory; the camera's 39 floats of static shared memory;
    registers within the 255 a thread, no spills; at least one block an
    SM, a grid of one wave at 1M and of the chunks' blocks at 200
    Gaussians (7 chunks: 2 blocks of 4 warps)."""
    _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for degree in range(4):
        launch = chip_smoke.forward_occupancy(1_000_000, 16, degree)
        assert launch["threads"] == 128, launch
        assert launch["dynamic_shared"] % (4 * 16) == 0, launch
        camera = 4 * CAMERA_FLOATS
        assert camera <= launch["static_shared"] < camera + 16, launch
        assert 0 < launch["registers"] <= 255, launch
        assert launch["local_bytes"] == 0, launch
        assert launch["blocks_per_sm"] >= 1, launch
        assert launch["grid"] == sms * launch["blocks_per_sm"], launch
        assert chip_smoke.forward_occupancy(200, 16, degree)["grid"] == 2
