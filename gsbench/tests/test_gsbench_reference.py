"""On the CPU at a tiny size: the reference agrees with the program, the
lower-precision control and each planted fault fail the cell's limits,
and a run whose timed path is broken underneath comes out not correct."""

import time

import pytest
import torch

from gsbench import calibrate, harness
from gsbench.loops import common

TRAIN, VIEW = "train-1m-sh3", "view-1m-sh3"


def _run(cell, seed=11, trace=False):
    return harness.run(cell, seed, 0.2, trace, time.perf_counter(),
                       device="cpu")


def _checked_loop(cell, seed=5):
    loop = harness.loop_class(cell)(cell, seed, "cpu")
    loop.setup()
    if loop.kind == "view":
        loop.window(0.2)
    loop.release()
    return loop


@pytest.mark.parametrize("name", [TRAIN, VIEW, "view-116k-sh0"])
def test_the_program_agrees_with_the_reference(tiny_cell, name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "compared"}
    assert list(out)[-1] == "compared"


def test_a_traced_run_reads_its_layers(tiny_cell):
    out = _run(tiny_cell(TRAIN), trace=True)
    assert out["correct"]
    assert {"host_ms.train", "train_mfu", "idle_pct.train",
            "sortpack_ms.train", "peak_mem_gib.train"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,kinds", [
    (TRAIN, ("control", "half_batch")), (VIEW, ("control", "stale_frame"))])
def test_the_control_and_the_planted_faults_fail(tiny_cell, name, kinds):
    cell = tiny_cell(name)
    loop = _checked_loop(cell)
    read = (calibrate.train_readings if loop.kind == "train"
            else calibrate.view_readings)
    got = read(loop, control=True)
    limits = cell.settings["limits"]
    for kind in kinds:
        numbers = {k: v for k, v in got[kind].items()
                   if not k.startswith("_")}
        verdict = common.judged(numbers, {k: v for k, v in limits.items()
                                          if k in numbers})
        assert not verdict["correct"], (kind, got[kind])


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        tiny_cell, monkeypatch):
    from gsrast_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "apply_gradients",
                        lambda *args, **kw: None)
    out = _run(tiny_cell(TRAIN))
    assert not out["correct"]
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_step_that_leaves_out_half_the_batch_is_not_correct(
        tiny_cell, monkeypatch):
    from gsrast_tpu_torch.train import trainer

    whole = trainer.rgb_loss

    def half(pred, target, *args, **kw):
        h = pred.shape[0] // 2
        return whole(pred[:h], target[:h], *args, **kw)

    monkeypatch.setattr(trainer, "rgb_loss", half)
    assert not _run(tiny_cell(TRAIN))["correct"]


def test_an_altered_frame_is_not_correct(tiny_cell, monkeypatch):
    from gsrast_tpu_torch.render import api

    render = api.render

    def altered(*args, **kw):
        out = render(*args, **kw)
        image = out.image.clone()
        image[:16] += 0.05
        return out._replace(image=image)

    monkeypatch.setattr(api, "render", altered)
    assert not _run(tiny_cell(VIEW))["correct"]


@pytest.mark.cuda
def test_the_reference_on_the_card_matches_the_cpu(card, tiny_cell):
    from gsbench.reference import splat

    cell = tiny_cell(VIEW)
    out = {}
    for dev in ("cpu", card):
        loop = harness.loop_class(cell)(cell, 3, dev)
        loop.setup()
        with common.exact_float32():
            out[dev] = splat.render(loop.params, loop.ref_cams[0],
                                    loop.sh_degree, *loop.plan)[0].image
        loop.release()
    assert torch.allclose(out["cpu"], out[card].cpu(), atol=1e-5)


@pytest.mark.parametrize("name", [TRAIN, VIEW])
def test_a_plan_that_drops_a_pair_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    cell.settings["render"]["tiers"] = [[1, 1.0], [2, 0.05]]
    out = _run(cell)
    assert not out["correct"]
    assert out["compared"]["dropped"]["value"] > 0


def _scene_and_camera(n=6000, width=160, height=112):
    from gsbench import poses, scenes
    from gsbench.reference import splat

    params = scenes.make({"kind": "random_cube", "n": n, "sh_degree": 3,
                          "extent": 1.0, "scale_range": [0.005, 0.05],
                          "opacity_logit_range": [-1.0, 3.0],
                          "sh_rest_sigma": 0.1}, 7, "cpu")
    view = poses.look_at(poses.orbit_eye([0.0, 0.0, 0.0], 2.5, 0.3, 0.2),
                         [0.0, 0.0, 0.0])
    return params, splat.camera(view, 1.2, 1.0, 0.01, 100.0, width, height,
                                "cpu")


@pytest.mark.parametrize("tiers,drops", [
    ([[1, 1.0], [2, 0.02]], True),            # a budget too small
    ([[1, 1.0], [4, 0.3], [30, 0.01]], True),
    ([[4, 1.0], [5, 1.0]], True),             # a last bound too small
    ([[2, 1.0], [8, 0.2]], False),
    ([[4, 1.0], [200, 1.0]], False)])
def test_the_per_splat_drop_count_matches_the_pairs(tiers, drops):
    from gsbench.reference import splat

    params, cam = _scene_and_camera()
    _, _, pr = splat.render(params, cam, 3, 16, 32, tiers)
    assert splat.view_drops(params, [cam], 16, 32, tiers) == pr.dropped
    assert (pr.dropped > 0) == drops


def test_cameras_at_once_count_as_one_at_a_time():
    """`project` over a batch of cameras gives each camera's features and
    tile rectangles, and `view_drops` the worst camera's drops."""
    from gsbench import poses
    from gsbench.reference import splat

    params, cam = _scene_and_camera()
    views = [poses.look_at(poses.orbit_eye([0.0, 0.0, 0.0], d, az, el),
                           [0.0, 0.0, 0.0])
             for d, az, el in ((2.5, 0.3, 0.2), (1.6, 2.0, -0.4),
                               (3.0, 4.0, 0.9))]
    cams = [splat.camera(v, 1.2, 1.0, 0.01, 100.0, cam.width, cam.height,
                         "cpu") for v in views]
    act = splat.activate(params)
    both = splat.project(act, splat.cameras(cams), 3, 16, 32)
    tiers = [[1, 1.0], [4, 0.3], [30, 0.01]]
    drops = []
    for i, c in enumerate(cams):
        one = splat.project(act, c, 3, 16, 32)
        for a, b in zip(one, both):
            assert torch.equal(a, b[i])
        drops.append(splat.render(params, c, 3, 16, 32, tiers)[2].dropped)
    assert splat.view_drops(params, cams, 16, 32, tiers, batch=2) == max(
        drops) > 0
