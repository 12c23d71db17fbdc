"""The training path of `gsrast_tpu_torch` against the reference's
`gsrast_tpu.train`: losses, the Adam update on identical gradients, densify
decisions on identical statistics, moment surgery; and, on the port alone,
that a few CPU steps lower the loss with dead slots frozen, and that a
checkpoint resumes exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu.scene.gaussians import from_arrays, split_params
from gsrast_tpu.train import densify as jax_densify
from gsrast_tpu.train import loss as jax_loss
from gsrast_tpu.train import trainer as jax_trainer
from gsrast_tpu_torch.ops.covariance import quat_to_rotmat
from gsrast_tpu_torch.render.api import auto_render_config, render
from gsrast_tpu_torch.scene.gaussians import pad_to_capacity
from gsrast_tpu_torch.train import checkpoint as ckpt
from gsrast_tpu_torch.train import densify, loss
from gsrast_tpu_torch.train.trainer import (TrainConfig, apply_gradients,
                                            init_train_state, make_train_step,
                                            maybe_densify, step_generator,
                                            surgery_opt_state)

from torch_parity import (SCENE_FIELDS, adam_state_arrays,
                          densify_state_to_torch, jax_scene_arrays,
                          load_adam_state, seeded_arrays, t2n)

torch.set_num_threads(2)


def _images(seed=0, shape=(40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0.0, 1.0)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("name", ["l1", "ssim", "rgb_loss", "psnr"])
def test_loss_matches_reference(name):
    """Within 1e-6 of the reference, relative to the value where it exceeds
    1 (psnr is ~20 dB: a float32 ulp there is 2e-6)."""
    a, b = _images()
    ref = float(getattr(jax_loss, name)(jnp.asarray(a), jnp.asarray(b)))
    port = float(getattr(loss, name)(torch.from_numpy(a),
                                     torch.from_numpy(b)))
    assert abs(port - ref) <= 1e-6 * max(1.0, abs(ref)), (port, ref)


def test_rgb_loss_gradient_matches_reference():
    """The SSIM filter's hand-written backward (the same window filter)
    against jax.grad, scaled by the largest reference magnitude."""
    a, b = _images(1)
    ref = np.asarray(jax.grad(jax_loss.rgb_loss)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    pred = torch.from_numpy(a).requires_grad_(True)
    loss.rgb_loss(pred, torch.from_numpy(b)).backward()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(t2n(pred.grad) / scale, ref / scale,
                               atol=1e-5)


def test_train_config_equals_reference():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        jax_trainer.TrainConfig())


def _padded_scenes(seed, n, capacity, sh_degree=1, **kw):
    """(reference scene, port scene) with `capacity - n` dead slots."""
    arrays = seeded_arrays(seed, n, sh_degree=sh_degree, **kw)
    ref = from_arrays(*(arrays[f] for f in SCENE_FIELDS), capacity=capacity)
    return ref, gt.from_numpy(jax_scene_arrays(ref))


def test_adam_matches_optax():
    """Identical gradients, and the reference's optimizer state after two
    updates carried in: three more updates (SH-rest scaling, live mask,
    means LR decaying to its floor within lr_decay_steps=4) give the same
    parameters."""
    tc = TrainConfig(lr_decay_steps=4)
    extent = 2.5
    ref_scene, port_scene = _padded_scenes(3, 24, 32)
    optimizer = jax_trainer.make_optimizer(tc, extent)
    params, mask = split_params(ref_scene)
    live = mask.astype(jnp.float32)
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(4)

    def draw():
        return {f: rng.standard_normal(params[f].shape).astype(np.float32)
                for f in SCENE_FIELDS}

    def ref_update(params, opt_state, grads):
        g = jax_trainer._scale_sh_rest(
            {f: jnp.asarray(v) for f, v in grads.items()},
            tc.lr_sh_rest_div)
        g = {f: v * live.reshape((-1,) + (1,) * (v.ndim - 1))
             for f, v in g.items()}
        updates, opt_state = optimizer.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(2):
        params, opt_state = ref_update(params, opt_state, draw())
    with torch.no_grad():
        for f, p in port_scene.param_groups().items():
            p.copy_(torch.from_numpy(np.array(params[f])))
    state = init_train_state(port_scene, tc, extent)
    load_adam_state(state.optimizer, adam_state_arrays(opt_state))
    dead = {f: t2n(p)[~np.asarray(mask)].copy()
            for f, p in port_scene.param_groups().items()}
    lrs = []
    for _ in range(3):
        grads = draw()
        params, opt_state = ref_update(params, opt_state, grads)
        for f, p in port_scene.param_groups().items():
            p.grad = torch.from_numpy(grads[f].copy())
        apply_gradients(state, tc, extent)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        # The port's update takes optax's float32 operations in its order
        # (its bias corrections 1 - b^t in float32 too), and at these t
        # both take the same float32 b^t and rate: bit for bit.
        for f, p in port_scene.param_groups().items():
            np.testing.assert_array_equal(t2n(p), np.asarray(params[f]),
                                          err_msg=f)
            np.testing.assert_array_equal(t2n(p)[~np.asarray(mask)],
                                          dead[f])
    assert lrs[0] > lrs[1] > lrs[2] == pytest.approx(
        tc.lr_means_final * extent)


def _densify_inputs():
    """Reference and port scenes (64 slots, 40 live; four live with opacity
    0.0025 and no gradient, to prune) and identical statistics."""
    ref, _ = _padded_scenes(6, 40, 64, scale_range=(0.01, 0.3))
    logits = np.array(ref.opacity_logits)
    logits[[3, 11, 20, 33]] = -6.0
    ref = ref.replace(opacity_logits=jnp.asarray(logits))
    rng = np.random.default_rng(7)
    grad_accum = rng.uniform(0.0, 1e-3, 64).astype(np.float32)
    grad_accum[[3, 11, 20, 33]] = 0.0
    denom = rng.integers(0, 4, 64).astype(np.float32)
    stats = jax_densify.DensifyState(
        grad_accum=jnp.asarray(grad_accum), denom=jnp.asarray(denom),
        max_radii=jnp.zeros(64, jnp.float32))
    return ref, gt.from_numpy(jax_scene_arrays(ref)), stats


@pytest.mark.parametrize("max_new", [16, 64])
def test_densify_matches_reference(max_new):
    """On identical statistics: the same counts, mask, changed slots and
    every written row (clones and children), except the children's means,
    which come from each package's own noise; those are checked against
    the parent plus the port's noise."""
    ref, port, stats = _densify_inputs()
    kw = dict(grad_threshold=2e-4, scene_extent=10.0, max_new=max_new)
    ref_new, _, ref_info = jax_densify.densify_and_prune(
        ref, stats, jax.random.PRNGKey(0), **kw)
    live_before = t2n(port.mask).copy()
    before = {f: t2n(p).copy() for f, p in port.param_groups().items()}
    _, new_stats, info = densify.densify_and_prune(
        port, densify_state_to_torch(stats),
        torch.Generator().manual_seed(5), **kw)

    for key in ("num_cloned", "num_split", "num_pruned", "densify_overflow",
                "num_active"):
        assert info[key] == int(ref_info[key]), key
    assert info["num_cloned"] > 0 and info["num_split"] > 0
    assert info["num_pruned"] == 4
    np.testing.assert_array_equal(t2n(port.mask), np.asarray(ref_new.mask))
    changed = t2n(info["changed_slots"])
    np.testing.assert_array_equal(changed,
                                  np.asarray(ref_info["changed_slots"]))
    assert float(new_stats.grad_accum.abs().sum()) == 0.0

    mask = t2n(port.mask)
    new_slots = np.flatnonzero(changed & mask)  # clones, then children
    children = new_slots[info["num_cloned"]:]
    others = np.setdiff1d(np.arange(64), children)
    for f, p in port.param_groups().items():
        got, want = t2n(p), np.asarray(getattr(ref_new, f))
        rows = others if f in ("means", "log_scales") else np.arange(64)
        np.testing.assert_array_equal(got[rows], want[rows], err_msg=f)
    # The children's log-scales are the parent's minus log(1.6), which the
    # reference's float32 log (XLA on the CPU) rounds one ulp above the
    # correctly rounded value the port uses.
    np.testing.assert_array_max_ulp(t2n(port.log_scales)[children],
                                    np.asarray(ref_new.log_scales)[children],
                                    maxulp=1)

    opac = 1.0 / (1.0 + np.exp(-before["opacity_logits"]))
    parents = np.flatnonzero(live_before & ~mask & (opac >= 0.005))
    assert len(parents) == info["num_split"] == len(children) // 2
    p_means = torch.from_numpy(before["means"][parents])
    q = torch.from_numpy(before["quats"][parents])
    rot = quat_to_rotmat(q / (q.norm(dim=-1, keepdim=True) + 1e-12))
    noise = torch.randn((len(parents), 2, 3),
                        generator=torch.Generator().manual_seed(5))
    noise = noise * torch.exp(torch.from_numpy(before["log_scales"][parents])
                              )[:, None]
    want = p_means[:, None] + (rot[:, None] * noise[:, :, None]).sum(-1)
    np.testing.assert_allclose(t2n(port.means)[children],
                               t2n(want).reshape(-1, 3), atol=1e-6)


def test_moment_surgery_matches_reference():
    """Zeroing the moments of changed slots, then of every opacity slot on
    an opacity reset, from the same carried Adam state: only those moments
    change, and the update counts stay."""
    tc = TrainConfig()
    ref_scene, port_scene = _padded_scenes(8, 20, 32)
    optimizer = jax_trainer.make_optimizer(tc, 1.0)
    params, _ = split_params(ref_scene)
    rng = np.random.default_rng(9)
    opt_state = optimizer.init(params)
    for _ in range(2):
        grads = {f: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                 for f, v in params.items()}
        _, opt_state = optimizer.update(grads, opt_state, params)
    state = init_train_state(port_scene, tc, 1.0)
    load_adam_state(state.optimizer, adam_state_arrays(opt_state))
    changed = np.zeros(32, bool)
    changed[[1, 5, 21, 30]] = True

    opt_state = jax_trainer.surgery_opt_state(opt_state, jnp.asarray(changed))
    surgery_opt_state(state.optimizer, changed=torch.from_numpy(changed))
    _assert_adam_equal(state.optimizer, opt_state)
    opt_state = jax_trainer.surgery_opt_state(
        opt_state, reset_opacity_moments=True, capacity=32)
    surgery_opt_state(state.optimizer, reset_opacity_moments=True)
    _assert_adam_equal(state.optimizer, opt_state)
    moments = adam_state_arrays(opt_state)
    assert np.abs(moments["opacity_logits"][1]).max() == 0.0
    assert np.abs(moments["means"][1][~changed]).min() > 0.0


def _assert_adam_equal(optimizer, opt_state):
    ref = adam_state_arrays(opt_state)
    for group in optimizer.param_groups:
        (param,) = group["params"]
        st = optimizer.state[param]
        count, mu, nu = ref[group["name"]]
        assert int(st["step"]) == count
        np.testing.assert_array_equal(t2n(st["exp_avg"]), mu)
        np.testing.assert_array_equal(t2n(st["exp_avg_sq"]), nu)


def _training_setup(capacity=64):
    """The reference's training test, in the port: 48 Gaussians render the
    target; training starts from them with means moved by N(0, 0.03^2) and
    opacity logits - 0.5, padded to `capacity` slots."""
    target_scene = gt.random_scene(48, np.random.default_rng(1),
                                   scale_range=(0.05, 0.15))
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
                         1.0, 1.0, 64, 64)
    rcfg = auto_render_config(target_scene, cam, margin=1.5)
    with torch.no_grad():
        target = render(target_scene, cam, rcfg).image
        arrays = {f: t2n(p) for f, p in target_scene.param_groups().items()}
    noise = np.random.default_rng(2).standard_normal(arrays["means"].shape)
    arrays["means"] = arrays["means"] + 0.03 * noise
    arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
    scene = pad_to_capacity(gt.from_numpy(arrays), capacity)
    return scene, cam, rcfg, target


def test_loss_falls_and_dead_slots_stay_frozen():
    scene, cam, rcfg, target = _training_setup()
    dead = {f: t2n(p)[48:].copy() for f, p in scene.param_groups().items()}
    tc = TrainConfig()
    state = init_train_state(scene, tc, 1.0)
    step = make_train_step(rcfg, tc, 1.0)
    first = step(state, cam, target)
    for _ in range(9):
        last = step(state, cam, target)
    assert state.step == 10
    assert float(last["loss"]) < 0.9 * float(first["loss"])
    assert float(last["psnr"]) > float(first["psnr"])
    assert int(last["num_active"]) == 48
    for f, p in scene.param_groups().items():
        np.testing.assert_array_equal(t2n(p)[48:], dead[f], err_msg=f)
    assert float(state.densify_state.denom[:48].max()) == 10.0
    assert float(state.densify_state.grad_accum[:48].max()) > 0.0


def test_checkpoint_resume_is_exact(tmp_path):
    """k steps, save, restore into a fresh state and m more steps equal
    k + m uninterrupted steps, densify (with its per-step noise) included."""
    tc = TrainConfig(densify_from=2, densify_until=4, densify_every=2,
                     grad_threshold=1e-7)

    def run(state, to, step, cam, target):
        while state.step < to:
            i = state.step
            step(state, cam, target)
            maybe_densify(state, tc, step_generator("cpu", i), 1.0)
        return state

    def fresh():
        scene, cam, rcfg, target = _training_setup()
        return init_train_state(scene, tc, 1.0), make_train_step(
            rcfg, tc, 1.0), cam, target

    state, step, cam, target = fresh()
    straight = run(state, 5, step, cam, target)
    assert int(straight.scene.num_active()) > 48  # densify ran

    state, step, cam, target = fresh()
    run(state, 3, step, cam, target)
    ckpt.save(str(tmp_path), state)
    assert ckpt.latest_step(str(tmp_path)) == 3
    resumed, step, cam, target = fresh()
    assert ckpt.restore(str(tmp_path), resumed) is resumed
    assert resumed.step == 3
    run(resumed, 5, step, cam, target)

    for f, p in straight.scene.param_groups().items():
        assert torch.equal(p, resumed.scene.param_groups()[f]), f
    assert torch.equal(straight.scene.mask, resumed.scene.mask)
    for a, b in zip(dataclasses.astuple(straight.densify_state),
                    dataclasses.astuple(resumed.densify_state)):
        assert torch.equal(a, b)
    sa = straight.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for k in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][key], sb[k][key]), (k, key)


def test_checkpoint_keeps_newest_three(tmp_path):
    scene, _, _, _ = _training_setup()
    state = init_train_state(scene, TrainConfig(), 1.0)
    assert ckpt.restore(str(tmp_path), state) is None
    for step in (2, 4, 6, 8):
        state.step = step
        ckpt.save(str(tmp_path), state)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000006", "step_00000008"]
    assert ckpt.latest_step(str(tmp_path)) == 8
