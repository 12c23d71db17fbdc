"""The optimizer update of `gsrast_tpu_torch.train.adam` against the
reference's: the plain version (`adam_update_torch`, through the train
step's `apply_gradients`) against `jax_trainer.make_optimizer` with
`_scale_sh_rest`, the live mask and `optax.apply_updates`, on identical
gradients and optimizer state, over SH degrees 0, 1 and 3, capacities 1, 3
and 1,025, dead slots with zero and nonzero moments, counts that cross the
means' decay floor, and an update after moment surgery; the dispatch and
the kernel wrapper's checks; and (`-m cuda`, on the card) the kernel of
`csrc/adam.cu` against the plain version.

Tolerance: none. Both sides take the same float32 operations in the same
order, the bias corrections 1 - b^t in float32 (torch's powf of the count
against XLA's power of the int32 count, equal at every count here, and
past 0.9^828 both 1), the means' rate `trainer.means_lr` against
`optax.exponential_decay` (equal at these counts; a float32 power may
round apart elsewhere, `test_torch_train_graph.py` allows it an ulp), and
a correctly rounded square root: moments, counts and parameters are held
bit for bit.

`gsrast_tpu` and JAX are imported inside the tests that need them, so that
the `cuda` cases run where only the port imports."""

import os
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.train import adam
from gsrast_tpu_torch.train.trainer import (TrainConfig, apply_gradients,
                                            init_train_state,
                                            surgery_opt_state)

from torch_parity import (OPTAX_LABELS, SCENE_FIELDS, adam_state_arrays,
                          jax_scene_arrays, load_adam_state, seeded_arrays,
                          t2n)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

EXTENT = 2.5


class _Run:
    """The reference's optimizer and the port's TrainState on one scene of
    `capacity` slots (`live` of them live, SH `degree`), from the same
    optimizer state: each group's (count, mu, nu), with moments drawn from
    numpy where `moments` (dead slots' too, unless `dead_moments` is
    False), else zero."""

    def __init__(self, degree, capacity, live, count=0, moments=False,
                 dead_moments=True, tc=None, seed=0):
        import jax.numpy as jnp
        from gsrast_tpu.scene.gaussians import from_arrays, split_params
        from gsrast_tpu.train import trainer as jax_trainer

        self.tc = tc or TrainConfig()
        arrays = seeded_arrays(seed, live, sh_degree=degree)
        ref_scene = from_arrays(*(arrays[f] for f in SCENE_FIELDS),
                                capacity=capacity)
        self.params, mask = split_params(ref_scene)
        self.mask = np.asarray(mask)
        self.live = mask.astype(jnp.float32)
        self.optimizer = jax_trainer.make_optimizer(self.tc, EXTENT)
        self.rng = np.random.default_rng(seed + 1)
        state = {}
        for f in SCENE_FIELDS:
            shape = self.params[f].shape
            mu, nu = (np.zeros(shape, np.float32) for _ in range(2))
            if moments:
                mu = 0.1 * self.rng.standard_normal(shape).astype(np.float32)
                nu = 1e-3 * self.rng.uniform(0.0, 1.0, shape).astype(
                    np.float32)
                if not dead_moments:
                    mu[~self.mask] = nu[~self.mask] = 0.0
            state[f] = (count, mu, nu)
        self.opt_state = _reference_state(self.optimizer, self.params, state)
        self.port = init_train_state(
            gt.from_numpy(jax_scene_arrays(ref_scene)), self.tc, EXTENT)
        load_adam_state(self.port.optimizer, state)

    def draw(self) -> dict:
        return {f: self.rng.standard_normal(self.params[f].shape).astype(
            np.float32) for f in SCENE_FIELDS}

    def step(self, grads: dict) -> None:
        """One update on both sides from `grads`; holds the port to the
        reference (module docstring)."""
        import jax.numpy as jnp
        import optax
        from gsrast_tpu.train import trainer as jax_trainer

        count = adam_state_arrays(self.opt_state)["means"][0]
        g = jax_trainer._scale_sh_rest(
            {f: jnp.asarray(v) for f, v in grads.items()},
            self.tc.lr_sh_rest_div)
        g = {f: v * self.live.reshape((-1,) + (1,) * (v.ndim - 1))
             for f, v in g.items()}
        updates, self.opt_state = self.optimizer.update(
            g, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, updates)
        for f, p in self.port.scene.param_groups().items():
            p.grad = torch.from_numpy(grads[f].copy())
        apply_gradients(self.port, self.tc, EXTENT)

        ref_state = adam_state_arrays(self.opt_state)
        for group in self.port.optimizer.param_groups:
            name = group["name"]
            (param,) = group["params"]
            st = self.port.optimizer.state[param]
            r_count, mu, nu = ref_state[name]
            assert int(st["step"]) == r_count == count + 1, name
            assert float(np.float32(float(group["lr"]))) == _reference_lr(
                self.tc, name, count), name
            np.testing.assert_array_equal(t2n(st["exp_avg"]), mu, name)
            np.testing.assert_array_equal(t2n(st["exp_avg_sq"]), nu, name)
            np.testing.assert_array_equal(
                t2n(param), np.asarray(self.params[name]), name)

    def assert_dead_frozen(self, before: dict) -> None:
        for f, p in self.port.scene.param_groups().items():
            np.testing.assert_array_equal(t2n(p)[~self.mask], before[f], f)

    def dead(self) -> dict:
        return {f: t2n(p)[~self.mask].copy()
                for f, p in self.port.scene.param_groups().items()}


def _reference_state(optimizer, params, state: dict):
    """`optimizer.init(params)` with each group's Adam count, mu and nu
    (and the means' schedule count) set from `state`: {field: (count, mu,
    nu)}."""
    import jax
    import jax.numpy as jnp
    import optax

    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    opt_state = optimizer.init(params)
    inner = dict(opt_state.inner_states)
    for field, label in OPTAX_LABELS.items():
        count, mu, nu = state[field]

        def swap(s, field=field, count=count, mu=mu, nu=nu):
            if isinstance(s, optax.ScaleByAdamState):
                return s._replace(count=jnp.int32(count),
                                  mu={**s.mu, field: jnp.asarray(mu)},
                                  nu={**s.nu, field: jnp.asarray(nu)})
            if isinstance(s, optax.ScaleByScheduleState):
                return s._replace(count=jnp.int32(count))
            return s

        inner[label] = jax.tree_util.tree_map(
            swap, inner[label], is_leaf=lambda x: isinstance(x, kinds))
    return opt_state._replace(inner_states=inner)


def _reference_lr(tc, name: str, count: int) -> float:
    """The reference's rate for group `name` at update count `count`, in
    float32 (the means' from its optax schedule)."""
    import jax.numpy as jnp
    import optax

    if name != "means":
        return float(np.float32({"log_scales": tc.lr_scales,
                                 "quats": tc.lr_quats,
                                 "opacity_logits": tc.lr_opacity,
                                 "sh": tc.lr_sh}[name]))
    schedule = optax.exponential_decay(
        init_value=tc.lr_means * EXTENT, transition_steps=tc.lr_decay_steps,
        decay_rate=max(tc.lr_means_final / tc.lr_means, 1e-8),
        end_value=tc.lr_means_final * EXTENT)
    return float(np.float32(schedule(jnp.int32(count))))


def _live(capacity: int) -> int:
    return max(1, (3 * capacity + 3) // 4)


@pytest.mark.parametrize("capacity", [1, 3, 1_025])
@pytest.mark.parametrize("degree", [0, 1, 3])
def test_plain_update_matches_optax(degree, capacity):
    """Three updates from a fresh optimizer (SH 0: no rest bands; 1: 3; 3:
    15), on a capacity whose float counts are not all multiples of 4, a
    quarter of its slots dead (none at capacity 1): moments and counts bit
    for bit, parameters within the module's tolerance, dead slots frozen."""
    run = _Run(degree, capacity, _live(capacity))
    dead = run.dead()
    for _ in range(3):
        run.step(run.draw())
    run.assert_dead_frozen(dead)


@pytest.mark.parametrize("dead_moments", [False, True])
def test_plain_update_dead_slots(dead_moments):
    """Moments drawn for every slot at count 7, dead ones zeroed or not:
    dead slots take the same arithmetic as on the reference, so with zero
    moments they stay frozen, and with nonzero ones they move as there."""
    run = _Run(3, 1_025, 700, count=7, moments=True,
               dead_moments=dead_moments, seed=3)
    dead = run.dead()
    for _ in range(2):
        run.step(run.draw())
    if dead_moments:
        moved = [f for f, p in run.port.scene.param_groups().items()
                 if not np.array_equal(t2n(p)[~run.mask], dead[f])]
        assert moved == list(SCENE_FIELDS), moved
    else:
        run.assert_dead_frozen(dead)


@pytest.mark.parametrize("count,steps", [(2, 4), (29_998, 30_000)])
def test_plain_update_crosses_decay_floor(count, steps):
    """Counts that cross the means' decay floor (lr_decay_steps = `steps`):
    three updates from `count`, with moments, the last at the floor."""
    tc = TrainConfig(lr_decay_steps=steps)
    run = _Run(1, 67, 50, count=count, moments=True, tc=tc, seed=5)
    lrs = []
    for _ in range(3):
        run.step(run.draw())
        lrs.append(float(run.port.optimizer.param_groups[0]["lr"]))
    floor = float(np.float32(tc.lr_means_final * EXTENT))
    assert lrs[0] > floor and lrs[-1] == floor, lrs


def test_plain_update_where_the_power_underflows():
    """From count 828: from t = 829 on, 0.9^t is below float32's normal
    range, where torch's powf gives a subnormal and XLA zero; 1 - b^t is 1
    on both, and the update bit for bit."""
    import jax
    import jax.numpy as jnp

    assert float(jax.jit(lambda c: 0.9**c)(jnp.int32(829))) == 0.0
    assert 0.0 < float(torch.pow(0.9, torch.tensor(829.0))) < 1.2e-38
    run = _Run(3, 130, 100, count=828, moments=True, seed=9)
    for _ in range(2):
        run.step(run.draw())


def test_plain_update_after_moment_surgery():
    """Two updates, then the moment surgery of densify (changed slots) and
    of the opacity reset on both sides, then two more updates."""
    from gsrast_tpu.train import trainer as jax_trainer
    import jax.numpy as jnp

    run = _Run(3, 130, 100, seed=7)
    for _ in range(2):
        run.step(run.draw())
    changed = np.zeros(130, bool)
    changed[[0, 17, 99, 100, 129]] = True
    run.opt_state = jax_trainer.surgery_opt_state(
        run.opt_state, jnp.asarray(changed))
    run.opt_state = jax_trainer.surgery_opt_state(
        run.opt_state, reset_opacity_moments=True, capacity=130)
    surgery_opt_state(run.port.optimizer, changed=torch.from_numpy(changed))
    surgery_opt_state(run.port.optimizer, reset_opacity_moments=True)
    for _ in range(2):
        run.step(run.draw())


def _port_state(degree=1, capacity=9, live=6, device="cpu"):
    arrays = seeded_arrays(2, live, sh_degree=degree)
    scene = gt.from_numpy(arrays, device=device)
    from gsrast_tpu_torch.scene.gaussians import pad_to_capacity

    state = init_train_state(pad_to_capacity(scene, capacity), TrainConfig(),
                             EXTENT)
    gen = torch.Generator(device=device).manual_seed(4)
    for p in state.scene.param_groups().values():
        p.grad = torch.randn(p.shape, generator=gen, device=device)
    return state


def test_apply_gradients_reads_gradients_unchanged():
    """`apply_gradients` leaves `.grad` as it was (the rest-band scale and
    the mask are applied to copies), makes Adam's state on the first
    update, and on CPU tensors launches no kernel under backend 'cuda'."""
    state = _port_state()
    grads = {k: p.grad.clone()
             for k, p in state.scene.param_groups().items()}
    assert not state.optimizer.state
    _kernels.reset_launch_counts()
    apply_gradients(state, TrainConfig(), EXTENT)
    assert not any(_kernels.launch_counts.values())
    for k, p in state.scene.param_groups().items():
        assert torch.equal(p.grad, grads[k]), k
        st = state.optimizer.state[p]
        assert float(st["step"]) == 1.0 and st["exp_avg"].shape == p.shape


def test_checkpoint_of_torch_adam_restores(tmp_path):
    """A checkpoint whose Adam state `torch.optim.Adam.step()` wrote (as
    the train step did before `adam.update`) restores into a fresh state
    (same keys, counts and moments), and the next update runs from it."""
    from gsrast_tpu_torch.train import checkpoint as ckpt

    state = _port_state()
    state.optimizer.step()
    ckpt.save(str(tmp_path), state)
    fresh = _port_state()
    assert not fresh.optimizer.state
    ckpt.restore(str(tmp_path), fresh)
    want = {k: v for k, v in state.tensors().items() if k.startswith("adam.")}
    got = {k: v for k, v in fresh.tensors().items() if k.startswith("adam.")}
    assert got.keys() == want.keys() and len(got) == 15
    assert all(torch.equal(got[k], want[k]) for k in want)
    apply_gradients(fresh, TrainConfig(), EXTENT)
    assert all(float(v) == 2.0 for k, v in fresh.tensors().items()
               if k.endswith(".step"))


@pytest.mark.parametrize("backend", ["cuda", "torch", "autograd"])
def test_update_on_cpu_is_the_plain_version(backend):
    """`adam.update` on CPU tensors is `adam_update_torch`, bit for bit,
    whatever the backend."""
    a, b = _port_state(), _port_state()
    tc = TrainConfig()
    for st in (a, b):
        adam.make_state(st.optimizer)
        st.optimizer.param_groups[0]["lr"] = 1e-3
    adam.update(a.optimizer, a.scene.mask, 1.0 / tc.lr_sh_rest_div, backend)
    adam.adam_update_torch(adam.groups_of(b.optimizer), b.scene.mask,
                           1.0 / tc.lr_sh_rest_div)
    for (k, p), q in zip(a.tensors().items(), b.tensors().values()):
        assert torch.equal(p, q), k


def test_kernel_wrapper_checks():
    """The kernel's wrapper raises on CPU tensors and names what it needs;
    the plain version's table (row widths, first rest-band float) is the
    reference's band layout."""
    state = _port_state(degree=3)
    adam.make_state(state.optimizer)
    groups = adam.groups_of(state.optimizer)
    assert [(g.name, g.row, g.rest) for g in groups] == [
        ("means", 3, 3), ("log_scales", 3, 3), ("quats", 4, 4),
        ("opacity_logits", 1, 1), ("sh", 48, 3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        adam.adam_update_cuda(groups, state.scene.mask, 0.05)
    state.scene.means.grad = None
    with pytest.raises(ValueError, match="'means' has no gradient"):
        adam.groups_of(state.optimizer)
    assert not any(_kernels.launch_counts.values())


def test_profile_summary_lists_other_by_name():
    """`diag.profile_step.summarize` lists `other`'s device work by name,
    busiest first, per step: here one Adam kernel and two launches of a
    glue kernel outside every range, beside a render stage's kernel."""
    from gsrast_tpu_torch.diag import profile_step

    def ev(name, cat, tid, ts, dur, **args):
        return {"name": name, "cat": cat, "ph": "X", "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    events = [
        ev("profile.eager", "user_annotation", 1, 0.0, 60.0),
        ev("render.blend", "user_annotation", 1, 1.0, 5.0),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 2.0, 1.0, correlation=1),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 30.0, 1.0, correlation=2),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 32.0, 1.0, correlation=3),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 34.0, 1.0, correlation=4),
        ev("blend", "kernel", 9, 5.0, 5.0, correlation=1),
        ev("glue", "kernel", 9, 31.0, 2.0, correlation=2),
        ev("adam_update_kernel", "kernel", 9, 33.0, 20.0, correlation=3),
        ev("glue", "kernel", 9, 54.0, 4.0, correlation=4),
    ]
    out = profile_step.summarize(events, "profile.eager",
                                 ranges=profile_step.TRAIN_RANGES)
    assert out["stages"]["other"]["kernels"] == 3
    assert out["other_by_name"] == [
        ["adam_update_kernel", 1, pytest.approx(0.02)],
        ["glue", 2, pytest.approx(0.006)]]


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("degree,capacity,offset", [
    (3, 1, 0), (3, 3, 0), (3, 1_025, 0), (0, 1_025, 0), (1, 4_099, 1),
    (3, 100_003, 0)])
def test_cuda_kernel_matches_plain(degree, capacity, offset):
    """The kernel against the plain version on the same card inputs
    (`chip_smoke.compare_adam`), bit for bit (each operation rounded alone
    on both), on ragged capacities and unaligned arrays; two launches from
    the same state equal; one launch a call; the gradients untouched."""
    dev = _card()
    groups, live = chip_smoke.adam_edge_groups(dev, degree, capacity,
                                               offset)
    _kernels.reset_launch_counts()
    res = chip_smoke.compare_adam(groups, live)
    assert _kernels.launch_counts["adam"] == 2
    assert res["bit_equal"] and res["same_bits_twice"], res
    assert res["grads_untouched"] and res["finite"], res


@pytest.mark.cuda
@pytest.mark.parametrize("degree,capacity", [(3, 1), (3, 100_003)])
def test_cuda_counts_rise_once_an_update(degree, capacity):
    """Three updates in a row, eager and as replays of one captured
    update (`chip_smoke.adam_counts`): each count rises by three in both,
    the replays equal the eager updates bit for bit, and the captured
    update is one device operation."""
    dev = _card()
    groups, live = chip_smoke.adam_edge_groups(dev, degree, capacity)
    chip_smoke.compare_adam(groups, live)  # the device's ticket, eagerly
    res = chip_smoke.adam_counts(groups, live)
    assert res["graph_nodes"] == 1, res
    assert res["count_rise_eager"] == res["count_rise_replayed"] == [
        float(chip_smoke.ADAM_UPDATES)] * len(groups), res
    assert res["replays_equal_eager"], res


@pytest.mark.cuda
def test_cuda_train_step_launches_adam_once():
    """On the card a train step (backend 'cuda') launches the kernel once,
    eagerly and in a `TrainGraph` capture (a replay: none), and steps no
    `torch.optim.Adam`."""
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.train.trainer import TrainGraph, make_train_step

    dev = _card()
    scene = gt.random_scene(48, np.random.default_rng(1), device=dev)
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                                    device=dev), 1.0, 1.0, 32, 32,
                         device=dev)
    rcfg = auto_render_config(scene, cam, margin=1.5)
    with torch.no_grad():
        target = render(scene, cam, rcfg).image.clone()
    state = init_train_state(scene, TrainConfig(), 1.0)
    state.optimizer.step = None  # a call would raise
    step = make_train_step(rcfg, TrainConfig(), 1.0)
    graph = TrainGraph(step)
    for expected in (1, 1, 0):  # warm-up, capture, replay
        _kernels.reset_launch_counts()
        graph(state, cam, target)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["adam"] == expected
    assert graph.captured["adam"] == 1
    assert float(state.optimizer.state[scene.means]["step"]) == 3.0
