#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``sheeprl_tpu_torch``) on one
NVIDIA Hopper GPU. Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel under ``sheeprl_tpu_torch/csrc`` with ``nvcc``, one
   process per source, all at once;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the shapes the serving and training paths give it, timed with
   CUDA events around CUDA-graph replays; the two-hot kernels' gradients
   against the plain chain's;
4. model: the DreamerV3-S session step on the card against the same weights
   on the CPU, TF32 off, on one small batch;
5. step: one engine dispatch per bucket timed on the host clock, the device
   time inside it from ``torch.profiler``, and the host cost of one frame's
   JSON round trip;
6. train step: one DreamerV3-S gradient step (full width, batch 4 x
   sequence 16, horizon 15) on the card against the same step on the CPU:
   same seeded weights, batch and injected noise, TF32 off;
7. run: ``python -m sheeprl_tpu_torch run preset=dreamer_v3_100k_atari_dummy``'s
   entry point on the card at the full recipe (batch 16 x sequence 64,
   horizon 15, 255 bins) with ``learning_starts`` 128, for 9 gradient
   steps, ending in a checkpoint; the launch counters are zeroed just
   before and checked against the path's exact counts just after; then one
   gradient step from that checkpoint under ``torch.profiler``;
8. serve: the run's checkpoint (Atari-protocol shape: 64x64x3 pixels, 18
   actions, full width) through the port's ``serve`` entry point on an
   ephemeral socket: 8 concurrent sessions x 16 steps, one client reset, a
   health probe, one session replayed alone; the launch counters are
   zeroed just before and read just after.

The last three lines: the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_training_agent, sample_stochastic
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, draw_noise, make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import act, posterior_step, serve_policy_dreamer_v3
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.config import apply_overrides, load_config, preset
from sheeprl_tpu_torch.ops import kernels
from sheeprl_tpu_torch.ops.kernels import _build
from sheeprl_tpu_torch.utils.checkpoint import find_run_config, load_checkpoint

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
GRU_OPS_PER_ELEMENT = 10  # 2 sigmoid + tanh + 7 multiply/add, counted as one op each
# the loss, per row: symlog (~10), the bracket's guess and two checks (~8),
# the weights (~8) and the two-term dot (3); the decode, per logit: a max, a
# subtraction, an exp, an add and a multiply-add
TWO_HOT_LOSS_OPS_PER_ROW = 30
TWO_HOT_DECODE_OPS_PER_LOGIT = 6
N_SESSIONS, N_STEPS, RESET_AT = 8, 16, 8
RUN_PRESET = "dreamer_v3_100k_atari_dummy"
RUN_LEARNING_STARTS, RUN_GRADIENT_STEPS = 128, 9


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# -- 1. device --------------------------------------------------------------


def device_phase() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {out}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return out.splitlines()[0]


# -- 2. build -----------------------------------------------------------------


def build_phase() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(_build.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {name}: {line.strip()}")


# -- 3. kernels ---------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events, so the host's launch
    cost drops out. Inputs stay where the calls leave them: a shape below the
    50 MB L2 is timed with its operands in L2, as a caller that has just
    produced them would find them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def gru_gates_phase(main_batch: int) -> dict:
    """The kernel against its plain version (computed in f32, cast to the IO
    dtype) at each shape: f32 within atol 1e-6 rtol 1e-5, bf16 within atol
    1e-2 rtol 1e-2 (one bf16 rounding). ``ms``/``plain_ms`` are device time
    per call (:func:`_graph_ms`); ``call_ms``/``plain_call_ms`` are eager
    calls back to back, which the host's launch cost bounds at small
    shapes."""
    shapes = [(1, 512, "float32"), (8, 512, "float32"), (16, 512, "float32"), (32, 512, "float32"),
              (1024, 512, "float32"), (1, 512, "bfloat16"), (32, 512, "bfloat16"), (1024, 512, "bfloat16"),
              (1024, 4096, "float32")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, H, dtype in shapes:
        dt = getattr(torch, dtype)
        fused = (torch.randn((B, 3 * H), generator=gen, device="cuda") * 2).to(dt)
        h = torch.randn((B, H), generator=gen, device="cuda").to(dt)
        out = kernels.gru_gates(fused, h)
        torch.cuda.synchronize()
        want = kernels.gru_gates_reference(fused.float(), h.float()).to(dt)
        f32 = dtype == "float32"
        torch.testing.assert_close(out, want, atol=1e-6 if f32 else 1e-2, rtol=1e-5 if f32 else 1e-2)
        err = float((out.float() - want.float()).abs().max())
        iters = 200 if B * H < 1 << 20 else 100
        call_ms = _time_ms(lambda: kernels.gru_gates(fused, h), iters)
        plain_call_ms = _time_ms(lambda: kernels.gru_gates_reference(fused, h), iters)
        ms = _graph_ms(lambda: kernels.gru_gates(fused, h))
        plain_ms = _graph_ms(lambda: kernels.gru_gates_reference(fused, h))
        nbytes = 5 * B * H * h.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = GRU_OPS_PER_ELEMENT * B * H / F32_FLOPS * 1e3
        rows.append({
            "shape": [B, 3 * H], "dtype": dtype, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        log(f"gru_gates {dtype} fused ({B},{3 * H}): err {err:.3g} kernel {ms * 1e3:.2f} us "
            f"(call {call_ms * 1e3:.2f} us) plain {plain_ms * 1e3:.2f} us (call {plain_call_ms * 1e3:.2f} us) "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us")
    main = next(r for r in rows if r["shape"] == [main_batch, 3 * 512] and r["dtype"] == "float32")
    return {
        "name": "gru_gates",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/csrc/gru_gates.cu",
        "replaces": "sheeprl_tpu/ops/kernels/gru.py:59",
        "launches": None,  # filled from the run phase
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this gate chain
        "shapes": rows,
    }


def _two_hot_inputs(gen, n: int, k: int, scale: float):
    logits = torch.log_softmax(torch.randn((n, k), generator=gen, device="cuda") * scale, dim=-1)
    value = torch.randn((n, 1), generator=gen, device="cuda") * 30
    # zero, negatives, beyond +-20 in symlog space, exactly on the top bin,
    # then one target on each bin
    value[:5, 0] = torch.tensor([0.0, -1.0, 1e10, -1e10, float(np.expm1(20.0))], device="cuda")
    bins = torch.linspace(-20.0, 20.0, k, device="cuda")
    value[5:5 + k, 0] = torch.sign(bins) * torch.expm1(bins.abs())
    return logits, value


def two_hot_phase() -> list:
    """Both two-hot kernels against their plain versions computed in f32 on
    the same (rounded) inputs, at the training path's shapes: f32 within
    atol 1e-4 rtol 1e-5 (the in-kernel bins ``low + i * step`` and
    ``torch.linspace`` differ by an ulp of 20, which moves a two-hot weight
    by ~1e-5 against logits down to ~-25), bf16 within atol 2e-2 rtol 1e-2
    (one bf16 rounding of the output). Each ``autograd.Function``'s gradient
    on the card against the plain chain's, within atol and rtol 1e-4."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    # loss logits spread wide (down to ~-25); decode logits spread as a head's
    # do, so decoded values stay in the range a critic or reward head gives
    for name, main_n, scale in (("two_hot_symlog_loss", 15360, 3.0), ("two_hot_symexp_decode", 16384, 1.0)):
        kernel, plain_fn = getattr(kernels, name), getattr(kernels, f"{name}_reference")
        rows = []
        for n in (1024, 15360, 16384):
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                logits, value = _two_hot_inputs(gen, n, 255, scale)
                logits = logits.to(dt)
                args = (logits, value) if name == "two_hot_symlog_loss" else (logits,)
                plain_args = (logits.float(), value) if name == "two_hot_symlog_loss" else (logits.float(),)
                got = kernel(*args)
                torch.cuda.synchronize()
                want = plain_fn(*plain_args)
                f32 = dtype == "float32"
                tol = dict(atol=1e-4, rtol=1e-5) if f32 else dict(atol=2e-2, rtol=1e-2)
                torch.testing.assert_close(got.float(), want, **tol)
                if got.dtype != dt:
                    raise AssertionError(f"{name} returned {got.dtype} for {dt} logits")
                err = float((got.float() - want).abs().max())
                call_ms = _time_ms(lambda: kernel(*args), 200)
                plain_call_ms = _time_ms(lambda: plain_fn(*args), 200)
                ms = _graph_ms(lambda: kernel(*args))
                plain_ms = _graph_ms(lambda: plain_fn(*args))
                size = logits.element_size()
                if name == "two_hot_symlog_loss":  # per row: the target, two logits, the output
                    nbytes, ops = n * (4 + 3 * size), TWO_HOT_LOSS_OPS_PER_ROW * n
                else:  # per row: every logit, the output
                    nbytes, ops = n * 255 * size + n * size, TWO_HOT_DECODE_OPS_PER_LOGIT * n * 255
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / F32_FLOPS * 1e3
                rows.append({
                    "shape": [n, 255], "dtype": dtype, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                    "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                })
                log(f"{name} {dtype} ({n},255): err {err:.3g} kernel {ms * 1e3:.2f} us (call {call_ms * 1e3:.2f} us) "
                    f"plain {plain_ms * 1e3:.2f} us (call {plain_call_ms * 1e3:.2f} us) "
                    f"bound {max(bytes_ms, ops_ms) * 1e3:.4f} us")
        # the gradient through the autograd.Function against the plain chain's
        logits, value = _two_hot_inputs(gen, 512, 255, scale)
        value[8:] = value[8:] / 8  # most targets inside the support, where d/dvalue != 0
        weight = torch.rand((512,), generator=gen, device="cuda")
        grads = []
        for fn in (kernel, plain_fn):
            lg = logits.clone().requires_grad_(True)
            v = value.clone().requires_grad_(True)
            out_ = fn(lg, v) if name == "two_hot_symlog_loss" else fn(lg)[..., 0]
            (out_ * weight).sum().backward()
            grads.append([t.grad for t in ((lg, v) if name == "two_hot_symlog_loss" else (lg,))])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        grad_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
        log(f"{name} backward: max err {grad_err:.3g} against the plain chain")
        main = next(r for r in rows if r["shape"] == [main_n, 255] and r["dtype"] == "float32")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/two_hot.cu",
            "replaces": "sheeprl_tpu/ops/kernels/twohot.py:133" if name == "two_hot_symlog_loss"
            else "sheeprl_tpu/ops/kernels/twohot.py:158",
            "launches": None,  # filled from the run phase
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the two-hot loss or decode
            "grad_max_abs_err": grad_err,
            "shapes": rows,
        })
    return out


# -- 4. model on the card against the CPU --------------------------------------


def model_phase(cfg) -> dict:
    """The session step's pieces on the card against the same seeded weights
    on the CPU, full float32 (TF32 off for cuDNN and cuBLAS): recurrent state
    and representation logits within atol 1e-3 (float32 sums over 4096-wide
    inputs in another order), greedy actions on the same posterior equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = serve_policy_dreamer_v3(cfg, None, "cuda")
    cpu = serve_policy_dreamer_v3(cfg, None, "cpu")
    rng = np.random.default_rng(1)
    B = 8
    raw = {"rgb": rng.integers(0, 256, size=(B, 64, 64, 3), dtype=np.uint8)}
    obs = gpu.prepare(raw, B)
    init = cpu.init_fn(cpu.params, B)
    stoch_logits = torch.from_numpy(rng.normal(size=tuple(init["stochastic"].shape)).astype(np.float32))
    stoch = sample_stochastic(stoch_logits, cpu.params.world_model.discrete, sample=False)
    actions = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 9, size=B)), 9).float()
    rec0 = torch.from_numpy(rng.normal(size=tuple(init["recurrent"].shape)).astype(np.float32)).tanh()
    out = {}
    with torch.no_grad():
        for name, pol, dev in (("gpu", gpu, "cuda"), ("cpu", cpu, "cpu")):
            o = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            rec, logits = posterior_step(pol.params, o, actions.to(dev), rec0.to(dev), stoch.to(dev))
            greedy = act(pol.params, stoch.to(dev), rec, greedy=True)
            out[name] = (rec.cpu(), logits.cpu(), torch.cat(greedy, -1).cpu())
    torch.cuda.synchronize()
    rec_err = float((out["gpu"][0] - out["cpu"][0]).abs().max())
    logit_err = float((out["gpu"][1] - out["cpu"][1]).abs().max())
    log(f"model: recurrent max err {rec_err:.3g}, logits max err {logit_err:.3g} (card vs CPU)")
    if not (rec_err <= 1e-3 and logit_err <= 1e-3 and torch.isfinite(out["gpu"][1]).all()):
        raise AssertionError(f"DreamerV3-S step on the card disagrees with the CPU: {rec_err}, {logit_err}")
    if not torch.equal(out["gpu"][2], out["cpu"][2]):
        raise AssertionError("greedy actions on the card differ from the CPU on the same posterior")
    return {"recurrent_max_abs_err": rec_err, "logits_max_abs_err": logit_err}


def _device_kernels(prof) -> list:
    """The profile's device-side events, without user annotations (the
    optimizer's ``Optimizer.step#Adam.step`` range spans kernels that are
    counted on their own)."""
    return [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]


def step_phase(cfg) -> dict:
    """Where a request's time goes, below the socket: one engine dispatch per
    bucket (host clock, ending in the actions' copy to the host), the device
    time inside it (``torch.profiler``, summed over kernels), and the host
    cost of one frame's JSON round trip."""
    from sheeprl_tpu_torch.serve.sessions import SessionEngine

    policy = serve_policy_dreamer_v3(cfg, None, "cuda")
    engine = SessionEngine(policy, buckets=(1, 8, 32), max_sessions=64)
    rng = np.random.default_rng(3)
    out = {}
    for b in engine.buckets:
        obs = policy.prepare({"rgb": rng.integers(0, 256, size=(b, 64, 64, 3), dtype=np.uint8)}, b)
        ids = [f"p{i}" for i in range(b)]
        for _ in range(5):
            engine.step_sessions(policy.params, obs, ids)
        t0 = time.perf_counter()
        n = 30
        for _ in range(n):
            engine.step_sessions(policy.params, obs, ids)
        host_ms = (time.perf_counter() - t0) / n * 1e3
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            for _ in range(10):
                engine.step_sessions(policy.params, obs, ids)
        events = _device_kernels(prof)
        device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 10
        kernels_per_step = sum(e.count for e in events) / 10
        out[f"bucket_{b}"] = {
            "dispatch_ms": host_ms,
            "device_ms": device_us / 1e3 if device_us > 0 else None,
            "device_busy_share": device_us / 1e3 / host_ms if device_us > 0 else None,
            "device_ops_per_step": kernels_per_step,
        }
        log(f"step bucket {b}: {json.dumps(out[f'bucket_{b}'])}")
    frame = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(20):
        msg = json.dumps({"obs": {"rgb": frame.tolist()}, "session_id": "x"})
        np.asarray(json.loads(msg)["obs"]["rgb"])
    out["json_frame_round_trip_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    log(f"host JSON encode + decode of one 64x64x3 frame: {out['json_frame_round_trip_ms']:.3f} ms")
    return out


# -- 6. one gradient step on the card against the CPU -----------------------------


def _batch(rng, T: int, B: int, n_actions: int) -> dict:
    data = {
        "rgb": rng.integers(0, 256, (1, T, B, 64, 64, 3)).astype(np.float32),
        "actions": np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (1, T, B))],
        "rewards": (rng.random((1, T, B, 1)) < 0.1).astype(np.float32) * 10,
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }
    data["terminated"][0, T // 2, 0] = 1.0
    data["is_first"][0, T // 2 + 1, 0] = 1.0
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _run_cfg(extra=()):
    cfg = apply_overrides(preset(RUN_PRESET), list(extra))
    cfg["spaces"] = {"obs": {"rgb": {"shape": [64, 64, 3], "dtype": "uint8"}}, "actions": {"n": [18], "continuous": False}}
    return apply_overrides(cfg, [])


def train_step_phase() -> dict:
    """One DreamerV3-S gradient step (full width, B 4 x T 16, H 15) on the
    card against the same step on the CPU, TF32 off: the same seeded
    weights, batch and injected noise. Tolerances:

    - the ten losses within rtol 1e-4: float32 sums of the same terms in
      another order (cuDNN's convolutions, cuBLAS's matmuls);
    - the updated parameters: Adam's first step moves each element by about
      its learning rate times the sign of its gradient, so an element whose
      gradient is within float32 noise of zero can move either way on the
      two machines, by up to twice the learning rate (2e-4). So every
      element within 2 * lr + 1e-6 of the CPU's, and at least 99.9% of each
      module's elements within 1e-6."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B = 16, 4
    cfg = _run_cfg([f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}"])
    data = _batch(np.random.default_rng(4), T, B, 18)
    noise = draw_noise(cfg, T, B, [18], torch.Generator().manual_seed(5), "cpu")
    results = {}
    for dev in ("cpu", "cuda"):
        modules = build_training_agent(cfg, dev)
        optimizers = make_optimizers(cfg, *modules[:3])
        train = make_train_step(*modules, optimizers, cfg)
        dev_noise = {
            "posterior": noise["posterior"].to(dev), "imagined_prior": noise["imagined_prior"].to(dev),
            "actions": [u.to(dev) for u in noise["actions"]],
        }
        t0 = time.perf_counter()
        moments, metrics = train({k: v.to(dev) for k, v in data.items()}, init_moments(dev), 0, noise=[dev_noise])
        metrics = metrics.cpu()
        seconds = time.perf_counter() - t0
        params = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                  for name, m in zip(("world_model", "actor", "critic"), modules)}
        results[dev] = (metrics[0], params, seconds)
    out = {"cpu_s": results["cpu"][2], "cuda_s": results["cuda"][2]}
    if not torch.isfinite(results["cuda"][0]).all():
        raise AssertionError(f"non-finite losses on the card: {results['cuda'][0].tolist()}")
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-4, atol=1e-5)
    out["loss_abs_err"] = dict(zip(METRIC_NAMES, (results["cuda"][0] - results["cpu"][0]).abs().tolist()))
    out["losses_cpu"] = dict(zip(METRIC_NAMES, results["cpu"][0].tolist()))
    lrs = {"world_model": 1e-4, "actor": 8e-5, "critic": 8e-5}
    for name, lr in lrs.items():
        diffs = torch.cat([(results["cuda"][1][name][k] - results["cpu"][1][name][k]).abs().reshape(-1)
                           for k in results["cpu"][1][name]])
        close = float((diffs <= 1e-6).float().mean())
        out[name] = {"max_abs_err": float(diffs.max()), "share_within_1e-6": close}
        if float(diffs.max()) > 2 * lr + 1e-6 or close < 0.999:
            raise AssertionError(f"{name} after one step on the card differs from the CPU: {out[name]}")
    log("train step (card vs CPU): " + json.dumps(out))
    return out


# -- 7. run -------------------------------------------------------------------------


def _profile_gradient_step(checkpoint: str) -> dict:
    """One full-recipe gradient step (B 16 x T 64, H 15) from the run's
    checkpoint, after two warm-up steps: host time around the step (ending
    in a synchronize), and device time and device operations from
    ``torch.profiler``, with the two-hot kernels' and ``gru_gates``' share."""
    cfg = load_config(find_run_config(checkpoint))
    state = load_checkpoint(checkpoint)
    modules = build_training_agent(cfg, "cuda", state)
    optimizers = make_optimizers(cfg, *modules[:3])
    train = make_train_step(*modules, optimizers, cfg)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    data = {k: v.cuda() for k, v in _batch(np.random.default_rng(6), T, B, 18).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    moments = init_moments("cuda")
    for _ in range(2):
        moments, _ = train(data, moments, 1, gen)
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        moments, _ = train(data, moments, 1, gen)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    acts = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
        moments, _ = train(data, moments, 1, gen)
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    ops = sum(e.count for e in events)
    share = {}
    for kernel, needle in (("two_hot", "two_hot_"), ("gru_gates", "gru_gates_")):
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in events if needle in e.key)
        share[kernel] = {"device_ms": us / 1e3, "share": us / device_us if device_us > 0 else None,
                         "ops": sum(e.count for e in events if needle in e.key)}
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return {
        "host_ms": float(np.median(host) * 1e3),
        "host_ms_all": [h * 1e3 for h in host],
        "device_ms": device_us / 1e3 if device_us > 0 else None,
        "device_busy_share": device_us / 1e3 / (np.median(host) * 1e3) if device_us > 0 else None,
        "device_ops": ops,
        "kernels": share,
        "top": [{"name": e.key[:80], "device_ms": getattr(e, "self_device_time_total", 0.0) / 1e3, "count": e.count}
                for e in top],
    }


def run_phase(workdir: str) -> dict:
    """DreamerV3-S coupled training through ``run``'s entry point at the
    full recipe, ``learning_starts`` 128 and 9 gradient steps. Every loss
    finite; the launch counts exactly those of the path: per gradient step
    3 two-hot losses (reward, critic against the lambda-returns and against
    the target critic), 3 decodes (critic values, imagined rewards, target
    values) and T + H GRU steps (dynamic rollout, imagination), plus one GRU
    step per player step after ``learning_starts``."""
    total = RUN_LEARNING_STARTS + RUN_GRADIENT_STEPS - 1
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = cli.run([
        f"preset={RUN_PRESET}",
        f"algo.learning_starts={RUN_LEARNING_STARTS}",
        f"algo.total_steps={total}",
        "checkpoint.save_last=true",
        "checkpoint.every=0",
        "metric.log_level=0",  # the losses are logged below
        f"log_root={workdir}",
    ])
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    G = summary["gradient_steps"]
    cfg = load_config(find_run_config(summary["checkpoint"]))
    T, H = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.horizon)
    if G < 8 or summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"run took {G} gradient steps on {summary['device']}")
    if not np.isfinite(np.asarray(summary["metrics"])).all() or len(summary["metrics"]) != G:
        raise AssertionError(f"non-finite or missing losses: {summary['metrics']}")
    want = {
        "two_hot_symlog_loss": 3 * G,
        "two_hot_symexp_decode": 3 * G,
        "gru_gates": G * (T + H) + summary["player_steps"],
    }
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for {G} gradient steps")
    per_step = [s / g * 1e3 for s, g in summary["train_host_s"]]
    out = {
        "gradient_steps": G,
        "policy_steps": summary["policy_steps"],
        "player_steps": summary["player_steps"],
        "launches": launches,
        "wall_s": wall,
        "host_ms_per_gradient_step": per_step,
        "env_steps_per_s": summary["env_steps_per_s"],
        "losses": [dict(zip(METRIC_NAMES, row)) for row in summary["metrics"]],
        "checkpoint": summary["checkpoint"],
    }
    for i, row in enumerate(summary["metrics"]):
        log(f"run gradient step {i}: " + " ".join(f"{n.split('/')[-1]}={v:.5g}" for n, v in zip(METRIC_NAMES, row)))
    log(f"run: {G} gradient steps, host ms per gradient step {[round(x, 1) for x in per_step]}, "
        f"env steps/s {summary['env_steps_per_s']:.1f}, launches {launches}")
    out["profile"] = _profile_gradient_step(summary["checkpoint"])
    log("gradient step profile: " + json.dumps(out["profile"]))
    return out


# -- 8. serve -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Conn:
    """One persistent JSON-lines connection."""

    def __init__(self, port: int, deadline: float) -> None:
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self.rfile = self.sock.makefile("rb")

    def ask(self, payload: dict) -> dict:
        self.sock.sendall((json.dumps(payload) + "\n").encode())
        line = self.rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


def _drive(port: int, frames, result: dict) -> None:
    """The client side: runs on a thread while ``serve`` holds the main
    thread, then asks the server to drain with SIGTERM."""
    try:
        deadline = time.monotonic() + 300
        probe = _Conn(port, deadline)
        result["health_start"] = probe.ask({"health": True})
        actions = [[None] * N_STEPS for _ in range(N_SESSIONS)]
        latencies = []
        errors = []

        def session(i: int) -> None:
            try:
                conn = _Conn(port, deadline)
                for t in range(N_STEPS):
                    msg = {"obs": {"rgb": frames[i][t].tolist()}, "session_id": f"s{i}"}
                    if i == 1 and t == RESET_AT:
                        msg["reset"] = True
                    t0 = time.perf_counter()
                    resp = conn.ask(msg)
                    latencies.append(time.perf_counter() - t0)
                    if "actions" not in resp:
                        raise AssertionError(f"session s{i} step {t}: {resp}")
                    actions[i][t] = resp["actions"]
                conn.close()
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=session, args=(i,), daemon=True) for i in range(N_SESSIONS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a session client did not finish")
        result["health_batched"] = probe.ask({"health": True})
        result["actions"], result["latencies"], result["wall_s"] = actions, latencies, wall
        # session s0's frames again, alone: the same actions
        solo = [probe.ask({"obs": {"rgb": frames[0][t].tolist()}, "session_id": "solo"})["actions"] for t in range(N_STEPS)]
        result["solo"] = solo
        result["health_end"] = probe.ask({"health": True})
        probe.close()
    except BaseException as e:
        result["error"] = e
    finally:
        os.kill(os.getpid(), signal.SIGTERM)  # graceful drain of the server


def serve_phase(ckpt: str, accelerator: str = "cuda") -> dict:
    n_actions = int(load_config(find_run_config(ckpt)).spaces.actions.n[0])
    rng = np.random.default_rng(2)
    frames = [[rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(N_STEPS)] for _ in range(N_SESSIONS)]
    port = _free_port()
    result: dict = {}
    kernels.reset_launches()
    driver = threading.Thread(target=_drive, args=(port, frames, result), daemon=True)
    driver.start()
    cli.serve([
        f"checkpoint_path={ckpt}",
        f"fabric.accelerator={accelerator}",
        f"serve.port={port}",
        "serve.session.buckets=[1,8,32]",
        "serve.max_wait_ms=2.0",
        "serve.log_every_s=600",
    ])
    launches = dict(kernels.LAUNCHES)
    driver.join(timeout=60)
    if "error" in result:
        raise result["error"]
    if driver.is_alive():
        raise TimeoutError("the serve driver did not finish")

    for i in range(N_SESSIONS):
        for t, a in enumerate(result["actions"][i]):
            if not (len(a) == 1 and len(a[0]) == 1 and 0 <= a[0][0] < n_actions):
                raise AssertionError(f"session s{i} step {t}: bad action {a}")
    hb = result["health_batched"]
    if hb["sessions"]["live"] != N_SESSIONS or hb["sessions"]["client_resets"] != 1:
        raise AssertionError(f"sessions after the batched phase: {hb['sessions']}")
    if result["solo"] != result["actions"][0]:
        raise AssertionError(f"session alone {result['solo']} != batched {result['actions'][0]}")
    end = result["health_end"]["engine"]
    dispatches = end["dispatches"] + end["warmup_dispatches"]
    if launches["gru_gates"] < 1 or launches["gru_gates"] != dispatches:
        raise AssertionError(f"gru_gates launched {launches['gru_gates']} times for {dispatches} dispatches")
    lat = np.asarray(result["latencies"]) * 1e3
    phase_dispatches = hb["engine"]["dispatches"] - result["health_start"]["engine"]["dispatches"]
    stats = {
        "sessions": N_SESSIONS,
        "steps": N_STEPS,
        "requests": int(lat.size),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "dispatches": int(phase_dispatches),
        "dispatches_per_s": phase_dispatches / result["wall_s"],
        "rows_per_dispatch": lat.size / max(phase_dispatches, 1),
        "requests_per_s": lat.size / result["wall_s"],
        "launches": launches,
        "engine_end": end,
    }
    log("serve: " + json.dumps(stats))
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = device_phase()
    build_phase()
    gru = gru_gates_phase(main_batch=16)
    two_hot = two_hot_phase()
    cfg = preset("dreamer_v3_S_atari100k")
    model = model_phase(cfg)
    step = step_phase(cfg)
    train_step = train_step_phase()
    with tempfile.TemporaryDirectory() as workdir:
        run = run_phase(workdir)
        serve = serve_phase(run["checkpoint"])
    for row in [gru] + two_hot:
        row["launches"] = run["launches"][row["name"]]
        row["launches_by_path"] = {"run": run["launches"][row["name"]], "serve": serve["launches"][row["name"]]}
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"model": model, "step": step, "train_step": train_step, "run": run, "serve": serve}))
    print(json.dumps({"kernels": [gru] + two_hot}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
