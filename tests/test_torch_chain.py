"""The benchmark's chained timing (`benchmark.StepChain`, `run_bench(chain=)`,
`bench --chain K`), the counterpart of the reference's `run_bench(chain=K)`
(`gsrast_tpu/benchmark.py:106-181`) and the root `bench.py`'s two timing
bases: on the CPU the chain runs eagerly, leaves the parameters as they
were and ends on the step's own gradients, which equal `jax.grad` of the
reference's bench step on the same arrays; the command's JSON carries
`bench.py`'s keys. The `cuda` case captures the chain in one CUDA graph
and holds its replays against eager steps."""

import contextlib
import json

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels, benchmark, cli
from gsrast_tpu_torch.diag import profile_step
from gsrast_tpu_torch.render import pipeline
from gsrast_tpu_torch.render.tiled import background_rgb

from torch_parity import jax_scene_arrays, t2n

torch.set_num_threads(2)

N, W, H = 1500, 96, 64
CHAIN = 3
# Per group, |port - reference| <= RTOL * max |reference| of that group, as
# in tests/test_torch_bench.py: sums over pixels and intersections taken in
# other orders.
RTOL = 1e-4
# The bench's JSON keys with one step a call, and those `bench.py` adds to
# a chained run (`bench.py:75-82`).
BENCH_KEYS = {"metric", "n", "width", "height", "scene", "backend",
              "best_ms", "value", "unit", "median_ms", "iters", "mode",
              "device", "chain"}
CHAIN_KEYS = {"chained_ms", "per_dispatch_ms", "per_dispatch_mpix_s"}
# Card against eager on the card: the gather's backward sums by atomics
# (`index_add_`) in no fixed order, so a group's gradient moves within
# rounding of its largest magnitude (chip_smoke.py phase 16's bound).
CARD_GRAD_RTOL = 1e-6


def bits(params: dict) -> dict:
    """Each tensor's bits, for comparisons that tell -0.0 from 0.0."""
    return {k: v.detach().clone().view(torch.int32) for k, v in
            params.items()}


def assert_bits_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.fixture(scope="module")
def case():
    """The reference's bench scene at N, W x H and its auto config on the
    reference's CPU backend ('xla', as `bench.py` picks off the TPU), and
    the port's scene from its arrays with the port's bench camera and
    config. The reference is imported here, not at the top: the card's
    host, which runs the `cuda` case, has no `gsrast_tpu`."""
    from gsrast_tpu import benchmark as jax_bench
    from gsrast_tpu.render.api import auto_render_config as jax_auto_config

    ref_scene, jcam = jax_bench.bench_scene_camera(N, W, H)
    jrc = jax_auto_config(ref_scene, jcam, backend="xla",
                          base=jax_bench.bench_config("xla"))
    scene = gt.from_numpy(jax_scene_arrays(ref_scene))
    _, cam = benchmark.bench_scene_camera(N, W, H, device="cpu")
    rcfg = benchmark.bench_render_config(scene, cam, "torch")
    assert (rcfg.tile_h, rcfg.tile_w, rcfg.tiers) == (
        jrc.tile_h, jrc.tile_w, jrc.tiers)
    return ref_scene, jcam, jrc, scene, cam, rcfg


@pytest.mark.parametrize("fwd_only", [False, True])
def test_run_bench_chain_keeps_parameters_and_ends_on_step(case, fwd_only):
    """`run_bench(chain=3)`: the zero updates leave every parameter group
    bit for bit as it was, and the last chained step's output (its grads,
    or its image) is bit for bit one `bench_step`'s."""
    _, _, _, scene, cam, rcfg = case
    before = bits(scene.param_groups())
    best, median, mpix = benchmark.run_bench(scene, cam, rcfg, fwd_only,
                                             iters=1, chain=CHAIN)
    assert 0 < best <= median and mpix == pytest.approx(W * H / best / 1e3)
    assert_bits_equal(bits(scene.param_groups()), before)
    steps = benchmark.StepChain(scene, cam, rcfg, fwd_only, CHAIN)
    assert (steps.chain, steps.captures, steps.graph) == (CHAIN, 0, None)
    out = steps()
    assert_bits_equal(bits(scene.param_groups()), before)
    eager = benchmark.bench_step(scene, cam, rcfg, fwd_only)
    if fwd_only:
        assert torch.equal(out, eager) and float(out.max()) > 0.05
    else:
        assert_bits_equal(bits(out), bits(eager))
        assert all(float(g.abs().max()) > 0 for g in out.values())


def test_chained_grads_match_jax_grad(case):
    """The last chained step's five gradients against `jax.grad` of the
    reference's bench step (`run_bench`'s `one`: mean(img^2) through
    `render`) on the same arrays, at RTOL of each group's scale."""
    import jax
    import jax.numpy as jnp
    from gsrast_tpu.render.api import render as jax_render
    from gsrast_tpu.scene.gaussians import merge_params, split_params

    ref_scene, jcam, jrc, scene, cam, rcfg = case
    params, mask = split_params(ref_scene)

    def loss(p):
        img = jax_render(merge_params(p, mask).activated(), jcam, jrc).image
        return jnp.mean(img * img)

    ref_grads = jax.jit(jax.grad(loss))(params)
    grads = benchmark.StepChain(scene, cam, rcfg, chain=CHAIN)()
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        expected = np.asarray(ref_grads[name])
        scale = float(np.abs(expected).max())
        assert scale > 0, f"{name}: reference gradient is zero"
        np.testing.assert_allclose(t2n(g) / scale, expected / scale,
                                   atol=RTOL, err_msg=name)


def _bench(capsys, *extra):
    result = cli.main(["bench", "--device", "cpu", "--n", "600", "--width",
                       "64", "--height", "64", "--iters", "2", "--no-stages",
                       *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    return result, lines


def test_cli_bench_chain_has_bench_py_keys(capsys):
    """`bench --chain 2`: the root `bench.py`'s keys, `value` and `best_ms`
    from the chained best per step, the per-dispatch pair from one step a
    call; the chain's line says it ran eagerly on the CPU."""
    result, lines = _bench(capsys, "--chain", "2")
    assert set(result) == BENCH_KEYS | CHAIN_KEYS
    assert result["chain"] == 2
    assert result["chained_ms"] == result["best_ms"] > 0
    assert result["value"] == pytest.approx(64 * 64 / result["chained_ms"]
                                            / 1e3)
    assert result["per_dispatch_mpix_s"] == pytest.approx(
        64 * 64 / result["per_dispatch_ms"] / 1e3)
    assert lines[-2] == "chain: 2 steps a call, eagerly on cpu"


@pytest.mark.parametrize("chain", ["1", "0"])
def test_cli_bench_chain_one_or_less_keeps_the_per_call_keys(chain, capsys):
    """`--chain 1` (the default) and `--chain 0` (the reference's
    max(chain, 1)) time one step a call: today's keys, `chain` 1, and no
    chain line."""
    result, lines = _bench(capsys, "--chain", chain)
    assert set(result) == BENCH_KEYS and result["chain"] == 1
    assert len(lines) == 2 and lines[0].startswith("scene stats: ")
    default, _ = _bench(capsys)
    assert set(default) == BENCH_KEYS and default["chain"] == 1


def test_check_chain_refuses_what_a_card_cannot_capture():
    """On a card a chain takes only the kernels' path; one step a call, or
    the CPU, takes every backend. Nothing here touches a card."""
    for backend in ("torch", "autograd"):
        with pytest.raises(ValueError, match="CUDA graph"):
            benchmark.check_chain(backend, "cuda", 8)
        benchmark.check_chain(backend, "cuda", 1)
        benchmark.check_chain(backend, "cpu", 8)
    benchmark.check_chain("cuda", "cuda", 8)


def test_background_rgb_is_the_configs_float32_values():
    rcfg = gt.RenderConfig(background=(0.1, 0.2, 0.3))
    got = background_rgb(rcfg, "cpu")
    want = torch.tensor(rcfg.background, dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fwd_only", [False, True])
def test_cuda_chain_captured_and_replays_follow_inputs(fwd_only):
    """On the card: one capture recording 3x one eager step's kernel
    launches; replays launch no wrapper, leave the parameters bit for bit,
    and give an eager step's output (gradients within CARD_GRAD_RTOL of
    each group's scale, bit for bit under deterministic algorithms; the
    image bit for bit); after an in-place change
    of the opacities, the next replay follows it, so the hand kernels'
    launches are in the graph; `--backend torch` refuses to be chained."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    scene, cam = benchmark.bench_scene_camera(20_000, 256, 256, device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda")
    _kernels.reset_launch_counts()
    benchmark.bench_step(scene, cam, rcfg, fwd_only)
    eager_counts = dict(_kernels.launch_counts)
    assert eager_counts["blend_forward"] == 1
    before = bits(scene.param_groups())
    steps = benchmark.StepChain(scene, cam, rcfg, fwd_only, CHAIN)
    assert steps.captures == 1 and steps.captured == {
        k: CHAIN * v for k, v in eager_counts.items()}

    def check_against_eager():
        counts = dict(_kernels.launch_counts)
        out = steps()
        torch.cuda.synchronize()
        assert _kernels.launch_counts == counts  # a replay runs no wrapper
        eager = benchmark.bench_step(scene, cam, rcfg, fwd_only)
        if fwd_only:
            assert torch.equal(out, eager)
            return out.clone()
        for name, g in eager.items():
            scale = float(g.abs().max())
            assert scale > 0, name
            assert float((out[name] - g).abs().max()) <= (
                CARD_GRAD_RTOL * scale), name
        return {k: v.clone() for k, v in out.items()}

    first = check_against_eager()
    assert_bits_equal(bits(scene.param_groups()), before)
    with torch.no_grad():
        scene.opacity_logits.sub_(1.0)
    second = check_against_eager()
    if not fwd_only:
        first, second = first["opacity_logits"], second["opacity_logits"]
    # The replay's output moved by far more than the atomics' rounding.
    assert float((second - first).abs().max()) > 1e-3 * float(
        first.abs().max())
    if not fwd_only:
        # Deterministic algorithms sum without atomics: a chain captured
        # under them replays an eager step's gradients bit for bit.
        torch.use_deterministic_algorithms(True)
        try:
            det_eager = benchmark.bench_step(scene, cam, rcfg)
            det = benchmark.StepChain(scene, cam, rcfg, chain=CHAIN)()
            assert_bits_equal(bits(det), bits(det_eager))
        finally:
            torch.use_deterministic_algorithms(False)
    with pytest.raises(ValueError, match="CUDA graph"):
        benchmark.StepChain(scene, cam, rcfg.replace(backend="torch"),
                            fwd_only, CHAIN)


def test_profile_summary_splits_kernels_by_stage():
    """`diag.profile_step.summarize` on a hand-made trace: the prep range
    holds a launch and an op that peeks sequence number 7, the blend range
    the op that makes node 7 and a launch, node 7's backward (on another
    thread) a third launch; a fourth lies outside every range. The
    kernels overlap on the device."""
    def ev(name, cat, tid, ts, dur, **args):
        return {"name": name, "cat": cat, "ph": "X", "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    fwd, bwd = {"Sequence number": 7, "Fwd thread id": 0}, {
        "Sequence number": 7, "Fwd thread id": 1}
    events = [
        ev("profile.eager", "user_annotation", 1, 0.0, 50.0),
        ev("render.prep", "user_annotation", 1, 1.0, 10.0),
        ev("aten::add", "cpu_op", 1, 2.0, 3.0, **fwd),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 3.0, 1.0, correlation=1),
        ev("render.blend", "user_annotation", 1, 12.0, 6.0),
        ev("BlendFunction", "cpu_op", 1, 13.0, 3.0, **fwd),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 14.0, 1.0, correlation=4),
        ev("autograd::engine::evaluate_function: BlendFunctionBackward",
           "cpu_op", 2, 20.0, 10.0, **bwd),
        ev("cudaLaunchKernel", "cuda_runtime", 2, 21.0, 1.0, correlation=2),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 40.0, 1.0, correlation=3),
        ev("k1", "kernel", 9, 10.0, 20.0, correlation=1),
        ev("k2", "kernel", 9, 25.0, 15.0, correlation=2),
        ev("k4", "kernel", 9, 45.0, 5.0, correlation=4),
        ev("k3", "kernel", 9, 60.0, 40.0, correlation=3),
    ]
    out = profile_step.summarize(events, "profile.eager")
    # Busy: [10, 40], [45, 50] and [60, 100] us; window: 0 to 100 us.
    assert out["kernels"] == 4 and out["busy_ms"] == pytest.approx(0.075)
    assert out["traced_window_ms"] == pytest.approx(0.1)
    assert out["traced_idle_share"] == pytest.approx(0.25)
    stages = out["stages"]
    assert stages["prep"] == {"kernels": 1, "busy_ms": pytest.approx(0.02)}
    assert stages["blend"] == {"kernels": 2, "busy_ms": pytest.approx(0.02)}
    assert stages["other"] == {"kernels": 1, "busy_ms": pytest.approx(0.04)}
    assert stages["pack"] == {"kernels": 0, "busy_ms": 0.0}
    halves = profile_step.summarize(events, "profile.eager", steps=2,
                                    split=False)
    assert halves["kernels"] == 2 and "stages" not in halves


def test_render_stage_spans_open_only_under_a_profiler():
    """`render.pipeline.span` opens its `render.<stage>` range only while a
    profiler runs: an unprofiled render pays no dispatcher calls for it."""
    assert isinstance(pipeline.span("prep"), contextlib.nullcontext)
    with torch.profiler.profile():
        assert isinstance(pipeline.span("prep"),
                          torch.profiler.record_function)
    assert isinstance(pipeline.span("blend"), contextlib.nullcontext)


def test_profile_step_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The script's control flow on a tiny cell: a trace per part, the
    forward's stage ranges in the eager one, and no device work."""
    monkeypatch.setitem(profile_step.CELLS, "tiny", (600, 64, 48, None))
    monkeypatch.setattr(profile_step, "CHAIN", 2)
    monkeypatch.setattr(profile_step, "TIMED", 2)
    out = profile_step.main(["--cells", "tiny", "--out", str(tmp_path),
                             "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == out["tiny"]
    res = out["tiny"]
    assert (res["chain"], res["captured"], res["gaussians"]) == (2, False,
                                                                 600)
    assert res["eager"]["kernels"] == 0 and res["chained"]["busy_ms"] == 0
    for part in ("eager", "chained"):
        best, median = res[part]["ms"]
        assert 0 < best <= median and res[part]["idle_share"] == [1.0, 1.0]
    assert set(res["eager"]["stages"]) == {"prep", "binning", "pack",
                                           "blend", "other"}
    with open(tmp_path / "tiny_eager" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"render.prep", "render.binning", "render.pack",
            "render.blend"} <= names
