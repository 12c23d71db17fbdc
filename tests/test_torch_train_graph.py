"""The whole train step of `gsrast_tpu_torch` against `jax.jit` of the
reference's `gsrast_tpu.train.trainer.make_train_step`, and the state the
step keeps in place so that `trainer.TrainGraph` can capture it once into a
CUDA graph and replay it: the parameters, Adam's counts and moments and the
densify statistics keep their storage across steps, densify, the opacity
reset and checkpoint restores; the means' rate computed on the device
equals the host's and optax's schedule; on the CPU a `TrainGraph` is the
step itself. The `cuda` cases hold the graphed step against eager steps on
the card. The reference is imported inside the tests that use it: the
card's machine has no flax."""

import dataclasses

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.render.api import auto_render_config, render
from gsrast_tpu_torch.scene.gaussians import pad_to_capacity
from gsrast_tpu_torch.train import checkpoint as ckpt
from gsrast_tpu_torch.train import densify
from gsrast_tpu_torch.train.trainer import (TrainConfig, TrainGraph,
                                            init_train_state,
                                            make_train_step, maybe_densify,
                                            means_lr, means_lr_tensor,
                                            step_generator)

from torch_parity import (SCENE_FIELDS, adam_state_arrays, jax_scene_arrays,
                          seeded_arrays, t2n)

torch.set_num_threads(2)

EXTENT = 2.5
STEPS = 3
# Reference against port: float32 sums over pixels and intersections taken
# in other orders (the reference's XLA oracle against the port's autograd
# oracle or its plain blend), which agree to about 1e-6 of their largest
# term here. The loss (about 0.02, a mean of L1 and SSIM terms) within
# LOSS_ATOL; the PSNR (about 30 dB) within METRIC_RTOL of its value; the
# densify signal (sums of |d mean2d|) within RTOL of its largest entry;
# Adam's moments after the first update (0.1 g and 0.001 g^2) within RTOL
# (and twice that for the squares) of the group's largest.
LOSS_ATOL = 1e-6
METRIC_RTOL = 1e-6
RTOL = 1e-5
# A parameter component moves by lr * m / (sqrt(v) + eps) an update. Where
# its gradient is at noise level the ratio is +-1 whichever sign the noise
# has (eps 1e-15 is no floor), so only components whose first moment is
# above SIGNIFICANT of the group's largest are compared. There the ratio
# moves by at most about RTOL / SIGNIFICANT = 0.01 an update: PARAM_TOL of
# the rate over the three steps, and the float32 rounding of the sums
# (PARAM_RTOL, two ulps of the value).
SIGNIFICANT = 1e-3
PARAM_TOL = STEPS * RTOL / SIGNIFICANT
PARAM_RTOL = 2.4e-7


def _parity_inputs():
    """24 live Gaussians (SH degree 1, drawn with numpy) in 32 slots at
    64x64: the reference renders the target from them; training starts
    from them with means moved by N(0, 0.03^2) and opacity logits - 0.5,
    as the reference's training test does."""
    from gsrast_tpu.render.api import render as jax_render
    from gsrast_tpu.scene.gaussians import from_arrays

    from torch_parity import front_camera

    arrays = seeded_arrays(11, 24, sh_degree=1, scale_range=(0.05, 0.15))
    jcam, cam = front_camera(64, 64, dist=3.0)
    truth = from_arrays(*(arrays[f] for f in SCENE_FIELDS))
    target = np.asarray(jax_render(truth.activated(), jcam).image)
    rng = np.random.default_rng(2)
    start = dict(arrays)
    start["means"] = (arrays["means"] + 0.03 * rng.standard_normal(
        arrays["means"].shape)).astype(np.float32)
    start["opacity_logits"] = arrays["opacity_logits"] - 0.5
    ref_scene = from_arrays(*(start[f] for f in SCENE_FIELDS), capacity=32)
    return ref_scene, jcam, cam, target


def _group_scale_close(got, want, rtol, name):
    scale = float(np.abs(want).max())
    assert scale > 0, name
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol,
                               err_msg=name)


@pytest.mark.parametrize("backend", ["autograd", "torch"])
def test_train_step_matches_jitted_reference(backend):
    """Three steps of the port's `make_train_step` against
    `jax.jit(make_train_step)` of the reference (backend 'xla', whose
    counterpart is the port's 'autograd'; 'torch' is the plain blend), from
    the same scene, target and camera, with the means' rate decaying over
    lr_decay_steps = 4: loss, psnr, num_active and the densify statistics
    at every step, Adam's moments after the first (which compare the
    gradients), and the parameters where the update is not noise (see
    SIGNIFICANT)."""
    import jax
    import jax.numpy as jnp

    from gsrast_tpu.render.api import auto_render_config as jax_auto_config
    from gsrast_tpu.train import trainer as jax_trainer

    ref_scene, jcam, cam, target = _parity_inputs()
    jcfg = jax_auto_config(ref_scene, jcam, backend="xla", margin=1.5)
    port_scene = gt.from_numpy(jax_scene_arrays(ref_scene))
    pcfg = auto_render_config(port_scene, cam, margin=1.5).replace(
        backend=backend)
    assert (pcfg.tile_h, pcfg.tile_w, pcfg.tiers) == (
        jcfg.tile_h, jcfg.tile_w, jcfg.tiers)
    tc = TrainConfig(lr_decay_steps=4)
    jtc = jax_trainer.TrainConfig(lr_decay_steps=4)
    optimizer = jax_trainer.make_optimizer(jtc, EXTENT)
    jstate = jax_trainer.init_train_state(ref_scene, optimizer)
    jstep = jax.jit(jax_trainer.make_train_step(jcfg, jtc, optimizer))
    state = init_train_state(port_scene, tc, EXTENT)
    step = make_train_step(pcfg, tc, EXTENT)
    live = np.asarray(ref_scene.mask)

    for i in range(STEPS):
        jstate, jm = jstep(jstate, jcam, jnp.asarray(target))
        m = step(state, cam, torch.from_numpy(target.copy()))
        for key, tol in (("loss", LOSS_ATOL),
                         ("psnr", METRIC_RTOL * abs(float(jm["psnr"])))):
            assert abs(float(m[key]) - float(jm[key])) <= tol, (
                i, key, float(m[key]), float(jm[key]))
        assert int(m["num_active"]) == int(jm["num_active"]) == 24
        ref_stats = jstate.densify_state
        _group_scale_close(t2n(state.densify_state.grad_accum),
                           np.asarray(ref_stats.grad_accum), RTOL,
                           f"step {i} grad_accum")
        for name in ("denom", "max_radii"):
            np.testing.assert_array_equal(
                t2n(getattr(state.densify_state, name)),
                np.asarray(getattr(ref_stats, name)), err_msg=name)
        adam = adam_state_arrays(jstate.opt_state)
        for group in state.optimizer.param_groups:
            (param,) = group["params"]
            name = group["name"]
            count, mu, nu = adam[name]
            st = state.optimizer.state[param]
            assert int(st["step"]) == count == i + 1
            if i == 0:  # mu = 0.1 g, nu = 0.001 g^2
                _group_scale_close(t2n(st["exp_avg"]), mu, RTOL,
                                   f"{name} exp_avg")
                _group_scale_close(t2n(st["exp_avg_sq"]), nu, 2 * RTOL,
                                   f"{name} exp_avg_sq")
            lr = float(group["lr"])
            ref_p = np.asarray(getattr(jstate.scene, name))
            got = t2n(param)
            sig = np.abs(mu) > SIGNIFICANT * np.abs(mu).max()
            assert sig.sum() > 0, name
            np.testing.assert_allclose(got[sig], ref_p[sig],
                                       rtol=PARAM_RTOL, atol=PARAM_TOL * lr,
                                       err_msg=name)
            # Dead slots stay frozen on both sides.
            np.testing.assert_array_equal(got[~live], ref_p[~live],
                                          err_msg=name)


def _small_run(capacity=64, **tc_kw):
    """The port's training setup of tests/test_torch_train.py at 32x32:
    48 Gaussians render the target, training starts from them with means
    moved by N(0, 0.03^2) and opacity logits - 0.5, in `capacity` slots.
    Returns (state, step, camera, target, tc)."""
    truth = gt.random_scene(48, np.random.default_rng(1),
                            scale_range=(0.05, 0.15))
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
                         1.0, 1.0, 32, 32)
    rcfg = auto_render_config(truth, cam, margin=1.5)
    with torch.no_grad():
        target = render(truth, cam, rcfg).image
    arrays = {f: t2n(p) for f, p in truth.param_groups().items()}
    arrays["means"] = arrays["means"] + 0.03 * np.random.default_rng(
        2).standard_normal(arrays["means"].shape)
    arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
    scene = pad_to_capacity(gt.from_numpy(arrays), capacity)
    tc = TrainConfig(**tc_kw)
    return (init_train_state(scene, tc, 1.0), make_train_step(rcfg, tc, 1.0),
            cam, target, tc)


def _values(state) -> dict:
    return {k: v.detach().clone() for k, v in state.tensors().items()}


def _assert_values_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_state_keeps_its_storage(tmp_path):
    """The addresses of the five parameters, the mask, every Adam count and
    moment and the three densify statistics stay the same over steps,
    densify (forced at every step), the opacity reset and restores of the
    step-0 checkpoint (saved before the first update: no Adam state) and of
    a later one; each restore gives the values of the run it came from
    (the step-0 one those of a freshly built state, Adam's zeroed), and
    the next step from it equals that run's next step."""
    kw = dict(densify_from=1, densify_until=100, densify_every=1,
              grad_threshold=1e-7, opacity_reset_every=2)
    state, step, cam, target, tc = _small_run(**kw)
    d = str(tmp_path)
    ckpt.save(d, state)  # step 0, no Adam state yet

    def one(st):
        i = st.step
        metrics = step(st, cam, target)
        info = maybe_densify(st, tc, step_generator("cpu", i), 1.0)
        return metrics, info

    _, info = one(state)
    assert info is not None  # densify ran after step 1
    ptrs = {k: v.data_ptr() for k, v in state.tensors().items()}
    assert len([k for k in ptrs if k.startswith("adam.")]) == 15
    for _ in range(2):
        one(state)
    assert state.step == 3 and int(state.scene.num_active()) > 48
    assert {k: v.data_ptr() for k, v in state.tensors().items()} == ptrs
    ckpt.save(d, state)
    at3 = _values(state)
    after3, _ = one(state)

    assert ckpt.restore(d, state, step=0) is state and state.step == 0
    assert {k: v.data_ptr() for k, v in state.tensors().items()} == ptrs
    fresh, fresh_step, _, _, _ = _small_run(**kw)
    want = _values(fresh)
    got = _values(state)
    for k in [k for k in got if k.startswith("adam.")]:
        assert not bool(got.pop(k).any()), k  # zeroed: a fresh optimizer
    _assert_values_equal(got, want)
    m_restored, _ = one(state)
    m_fresh = fresh_step(fresh, cam, target)
    maybe_densify(fresh, tc, step_generator("cpu", 0), 1.0)
    assert torch.equal(m_restored["loss"], m_fresh["loss"])
    _assert_values_equal(_values(state), _values(fresh))

    assert ckpt.restore(d, state, step=3) is state and state.step == 3
    assert {k: v.data_ptr() for k, v in state.tensors().items()} == ptrs
    _assert_values_equal(_values(state), at3)
    again, _ = one(state)
    assert torch.equal(again["loss"], after3["loss"])


def test_restore_into_a_state_that_has_not_stepped(tmp_path):
    """A resumed run restores before its first step: Adam's state is made
    then, as its lazy initialization makes it, and filled from the
    checkpoint; the next step equals the saved run's."""
    state, step, cam, target, _ = _small_run()
    for _ in range(2):
        step(state, cam, target)
    ckpt.save(str(tmp_path), state)
    want = _values(state)
    nxt = step(state, cam, target)
    resumed, step2, _, _, _ = _small_run()
    assert not resumed.optimizer.state
    ckpt.restore(str(tmp_path), resumed)
    _assert_values_equal(_values(resumed), want)
    assert torch.equal(step2(resumed, cam, target)["loss"], nxt["loss"])


@pytest.mark.parametrize("count", [0, 1, 2, 100, 29_999, 30_000, 30_001,
                                   100_000])
def test_device_learning_rate_matches_schedule(count):
    """The means' rate computed from Adam's float32 count tensor (the
    card's path, here on CPU tensors) within 1 ulp of the host's
    `means_lr` and of the reference's optax schedule: a float32 power may
    round either way."""
    import jax.numpy as jnp
    import optax

    tc = TrainConfig()
    extent = 3.7
    got = means_lr_tensor(tc, extent, torch.tensor(float(count)))
    assert got.dtype == torch.float32 and got.dim() == 0
    host = np.float32(means_lr(tc, extent, count))
    schedule = optax.exponential_decay(
        init_value=tc.lr_means * extent, transition_steps=tc.lr_decay_steps,
        decay_rate=max(tc.lr_means_final / tc.lr_means, 1e-8),
        end_value=tc.lr_means_final * extent)
    ref = np.float32(schedule(jnp.int32(count)))
    np.testing.assert_array_max_ulp(t2n(got), host, maxulp=1)
    np.testing.assert_array_max_ulp(t2n(got), ref, maxulp=1)
    if count >= tc.lr_decay_steps:
        assert float(got) == np.float32(tc.lr_means_final * extent)


def _two_views(cam):
    """`cam` and a second view of its size with other intrinsics."""
    dev = cam.device
    other = gt.make_camera(gt.look_at([0.4, -0.2, -2.9], [0.0, 0.0, 0.0],
                                      device=dev), 1.1, 0.9, cam.width,
                           cam.height, device=dev)
    return [cam, other]


def test_train_graph_on_cpu_is_the_step():
    """On the CPU a TrainGraph calls the step itself: over two views (each
    with its own intrinsics) in round robin, with densify between steps, it
    equals direct calls bit for bit, and captures nothing."""
    kw = dict(densify_from=2, densify_until=4, densify_every=2,
              grad_threshold=1e-7)
    runs = []
    for graphed in (False, True):
        state, step, cam, target, tc = _small_run(**kw)
        views = _two_views(cam)
        fn = TrainGraph(step) if graphed else step
        losses = []
        for i in range(5):
            m = fn(state, views[i % 2], target)
            losses.append(m["loss"].clone())
            maybe_densify(state, tc, step_generator("cpu", i), 1.0)
        runs.append((losses, _values(state), fn))
    (eager_losses, eager_vals, _), (losses, vals, graph) = runs
    assert all(torch.equal(a, b) for a, b in zip(losses, eager_losses))
    _assert_values_equal(vals, eager_vals)
    assert graph.captures == graph.replays == 0 and not graph.slots


def test_densify_statistics_accumulate_in_place():
    """accumulate_stats adds into the given tensors and densify_and_prune
    zeroes them in place, both returning the same object."""
    st = densify.init_densify_state(4)
    ptrs = [getattr(st, f.name).data_ptr() for f in dataclasses.fields(st)]
    grad = torch.tensor([[3.0, 4.0], [1.0, 0.0], [0.0, 0.0], [6.0, 8.0]])
    radii = torch.tensor([2, 0, 1, 5], dtype=torch.int32)
    for _ in range(2):
        assert densify.accumulate_stats(st, grad, radii) is st
    assert st.grad_accum.tolist() == [10.0, 0.0, 0.0, 20.0]
    assert st.denom.tolist() == [2.0, 0.0, 2.0, 2.0]
    assert st.max_radii.tolist() == [2.0, 0.0, 1.0, 5.0]
    scene = pad_to_capacity(gt.random_scene(2, np.random.default_rng(0)), 4)
    _, out, _ = densify.densify_and_prune(scene, st, torch.Generator())
    assert out is st and not any(bool(getattr(st, f.name).any())
                                 for f in dataclasses.fields(st))
    assert [getattr(st, f.name).data_ptr()
            for f in dataclasses.fields(st)] == ptrs


def test_profile_train_cell_on_cpu(tmp_path, monkeypatch):
    """`diag/profile_step.py`'s train cell at a CPU size: its control flow
    and keys (on the CPU no device events exist: every device number is
    0), the graphed part a direct step there."""
    from gsrast_tpu_torch.diag import profile_step

    monkeypatch.setattr(profile_step, "TIMED", 1)
    monkeypatch.setattr(profile_step, "TRAIN_CELLS",
                        {"train_default": (800, 64, 32, None)})
    res = profile_step.profile_train_cell(
        "train_default", str(tmp_path), torch.device("cpu"))
    assert res["gaussians"] == 800 and not res["captured"]
    assert res["eager"]["kernels"] == res["graphed"]["kernels"] == 0
    assert res["kernel_diff"] == {}
    assert "stages" in res["eager"] and "stages" not in res["graphed"]
    assert len(res["eager"]["ms"]) == len(res["graphed"]["idle_share"]) == 2
    assert (tmp_path / "train_default_graphed" / "trace.json").exists()


# -- on the card ------------------------------------------------------------


def _cuda_run(dev):
    """`_small_run` on the card at 128x128 with the kernels' backend."""
    truth = gt.random_scene(400, np.random.default_rng(1),
                            scale_range=(0.03, 0.1), device=dev)
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                                    device=dev), 1.0, 1.0, 128, 128,
                         device=dev)
    rcfg = auto_render_config(truth, cam, margin=1.5)
    assert rcfg.backend == "cuda"
    with torch.no_grad():
        target = render(truth, cam, rcfg).image
    arrays = {f: t2n(p) for f, p in truth.param_groups().items()}
    arrays["means"] = arrays["means"] + 0.03 * np.random.default_rng(
        2).standard_normal(arrays["means"].shape)
    arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
    scene = pad_to_capacity(gt.from_numpy(arrays, device=dev), 512)
    tc = TrainConfig(densify_from=3, densify_until=3, densify_every=3,
                     grad_threshold=1e-7)
    return (init_train_state(scene, tc, 1.0), make_train_step(rcfg, tc, 1.0),
            cam, target, tc)


@pytest.mark.cuda
def test_cuda_graphed_step_equals_eager_bit_for_bit():
    """On the card, under deterministic algorithms: 5 graphed steps over
    two views, densify between replays, equal 5 eager steps bit for bit
    (each loss and every state tensor), the state keeps its addresses,
    replays launch no wrapper, and each replay adds its capture's launches
    to `_kernels.replayed_counts`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for graphed in (False, True):
            state, step, cam, target, tc = _cuda_run(dev)
            views = _two_views(cam)
            fn = TrainGraph(step) if graphed else step
            _kernels.reset_launch_counts()
            losses, ptrs, replay_launches = [], None, 0
            for i in range(5):
                counts = dict(_kernels.launch_counts)
                m = fn(state, views[i % 2], target)
                if graphed and i >= 2:
                    replay_launches += sum(_kernels.launch_counts.values()) \
                        - sum(counts.values())
                losses.append(m["loss"].clone())
                maybe_densify(state, tc, step_generator(dev, i), 1.0)
                if i == 1:
                    ptrs = {k: v.data_ptr()
                            for k, v in state.tensors().items()}
            assert ptrs == {k: v.data_ptr()
                            for k, v in state.tensors().items()}
            runs.append((losses, _values(state), fn, replay_launches))
    finally:
        torch.use_deterministic_algorithms(before)
    (eager_losses, eager_vals, _, _), (losses, vals, graph, launched) = runs
    assert graph.captures == 1 and graph.replays == 4
    assert graph.captured["blend_forward"] == 1
    assert graph.captured["blend_backward"] == 1
    assert launched == 0
    assert _kernels.replayed_counts == {
        k: 4 * n for k, n in graph.captured.items()}
    assert all(torch.equal(a, b) for a, b in zip(losses, eager_losses))
    _assert_values_equal(vals, eager_vals)
