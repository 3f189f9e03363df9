#!/usr/bin/env python3
"""Drives gpflow_tpu_torch's main paths once on one NVIDIA GPU and checks them.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

The paths are those of ``bench.py``'s flagship model at full width (SVGP,
D = 8, M = 2048 inducing points, batches and requests of B = 8192 points,
float32, Gaussian likelihood, whitened full q_sqrt), with values made from a
numpy seed: serving (slice 1) and training (slice 2). Phases:

1. card: name and power limit; TF32 must be off for matmul and cuDNN;
2. build: kernels K1 and K2 from the sources in the checkout, one nvcc each,
   started together;
3. K1 against its plain PyTorch version on the card, six families, float32
   and bfloat16 inputs, at the paths' shapes and at ragged ones;
4. K2 against its plain version likewise, for its four families;
5. the serving slice (SquaredExponential): ``model.posterior()`` with the
   TENSOR cache, requests through ``predict_f`` and ``predict_mean``, and
   ``model.predict_f`` and ``model.predict_y`` on the solve and INV_SOLVE
   routes; outputs finite with var > 0, K1's launch count exactly as the path
   implies, and one request of each entry point against the same model in
   float64 on the CPU;
6. the gradients of ``stationary_kernel_matrix`` (rbf from the saved K,
   matern52 through K2) at the Kuu and Kuf shapes, against plain PyTorch
   autograd in float64;
7. the training slice: for SquaredExponential and Matern52 on the solve and
   INV_SOLVE routes, ``run_steps_sampled`` on data made as ``bench.py`` makes
   it, with CUDA's sync debug mode set to error; losses finite and falling,
   launch counts exactly as the path implies; then the first three steps of
   Matern52 on INV_SOLVE against the same model in float64 on the CPU;
8. serving from the trained Matern52 model;
9. timings with CUDA events: per request, training steps per second for each
   kernel and route, a ``torch.profiler`` breakdown of one step, and K1 and
   K2 against their plain versions.

Every failure raises, and the script then exits non-zero without the result
line. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
N_DATA, M, D, B = 1_000_000, 2048, 8, 8192  # bench.py:51
N_REQUESTS = 5
NOISE = 0.1

# K1 against its plain version evaluated in float64 on the same inputs. K1
# forms d2 as a sum of squared differences (relative error <= (D + 1) * 2^-24)
# and evaluates the tail in float32 (a few ulp): every entry lies within
# 1e-5 * var of the float64 value.
K1_ATOL_F64 = 1e-5
# K1 against the plain version in float32. The plain version's norm expansion
# loses about 2^-24 * (|x|^2 + |z|^2) of d2, which the r-based families turn
# into an error of that over 2r near r = 0: allow 1e-3 * var.
K1_ATOL_F32 = 1e-3
K1_SHAPES = [(2048, 2048, 8), (2048, 8192, 8), (1000, 777, 3), (1, 1, 1), (300, 129, 37)]

# The float32 slice on the card against the same model in float64 on the CPU,
# both with the float32 jitter 1e-4, as a fraction of the largest float64
# entry of each output. The fused routes solve with an f32 Cholesky of the
# jittered M = 2048 Gram matrix (error ~ cond(Kuu) * eps32); the cached route
# multiplies by an explicit inverse of it (~ cond(Kuu)^2 * eps32). Inducing
# points drawn from uniform data on [0, 4]^8 lie about one lengthscale apart,
# so cond(Kuu) stays near 1e2 (37 at M = 1024).
SLICE_RTOL = {"fused": 1e-4, "cached": 1e-3}

# K2 against its plain version evaluated in float64 on the same inputs, as a
# fraction of the largest |W|. K2 forms d2 as K1 does (relative error
# <= (D + 1) * 2^-24) and h' in float32 (a few ulp), so each entry lies within
# about 1e-6 of its own value. bfloat16 inputs reach both sides rounded alike.
K2_RTOL_F64 = 1e-5
# K2 against the plain version in float32: the plain norm expansion loses
# about 2^-24 * (|x|^2 + |z|^2) of d2, which h' of the r-based families
# divides by about 2 d2 near r = 0; as K1's float32 tolerance.
K2_RTOL_F32 = 1e-3
K2_SHAPES = K1_SHAPES

# Gradients of stationary_kernel_matrix in float32 on the card against plain
# autograd in float64, as a fraction of the largest float64 entry: dXs and
# dZs contract [N, M] weights in float32 matmuls over up to 8192 terms, and
# dvar and dlengthscales sum over all N * M entries.
GRAD_RTOL = 1e-4

TRAIN_KERNELS = ("SquaredExponential", "Matern52")
TRAIN_ROUTES = (("solve", False), ("inv_solve", True))
TRAIN_CALLS, TRAIN_STEPS_PER_CALL = 3, 10
TIMED_STEPS = 20
# The float32 steps on the card against float64 on the CPU, from the same
# values on the same batches. The loss is a sum over the batch scaled by
# N / B plus the KL, both in float32: 1e-5 of it. Adam moves each element by
# about lr = 1e-2 per step whatever its gradient's size, so an element whose
# gradient float32 cannot resolve may step either way: the hyperparameters
# (large, well-resolved gradients) must agree within 1e-4, and in q_mu,
# q_sqrt and Z at most 1% of the elements may differ by more than 1e-3.
F64_STEPS = 3
F64_LOSS_RTOL = 1e-5
F64_HYPER_ATOL = 1e-4
F64_ELEMENT_ATOL, F64_ELEMENT_SHARE = 1e-3, 1e-2


def log(*args):
    print(*args, flush=True)


def card_check():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import gpflow_tpu_torch  # noqa: F401  (sets the exact-fp32 matmul tier)

    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on for matmul"
    assert torch.backends.cudnn.allow_tf32 is False, "TF32 is on for cuDNN"
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.cuda.get_device_name(0), smi


def build_kernels():
    """Phase 2: K1 and K2, one nvcc each, started together. Returns
    {name: (seconds until loaded, nvcc seconds)}."""
    from gpflow_tpu_torch.ops import cuda_build
    from gpflow_tpu_torch.ops.pallas_distance import k1_library, k2_library

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {"K1": pool.submit(timed, k1_library), "K2": pool.submit(timed, k2_library)}
        seconds = {k: f.result() for k, f in futures.items()}
    return {k: (seconds[k], cuda_build.build_seconds[lib])
            for k, lib in (("K1", "gpflow_k1"), ("K2", "gpflow_k2"))}


def request_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of ``fn()`` called back to back, by CUDA
    events: the latency a stream of requests sees, host work included."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of ``fn()``, which must not
    synchronise: its launches queue behind a ~30 ms GPU sleep, so the events
    time the kernels and not the Python that enqueues them."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k1():
    """Phase 3: K1 against the plain version, every family, f32 and bf16."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 1)
    var = torch.tensor([1.7], device="cuda")
    alpha = torch.tensor([1.3], device="cuda")
    worst = 0.0
    for n, m, d in K1_SHAPES:
        scale = 4.0 if d == 8 else 1.0  # the slice's inputs at D = 8, unit cube else
        Xs = torch.from_numpy((rng.rand(n, d) * scale).astype(np.float32)).cuda()
        Zs = torch.from_numpy((rng.rand(m, d) * scale).astype(np.float32)).cuda()
        for family in pd.PALLAS_FAMILIES:
            for dtype in (torch.float32, torch.bfloat16):
                x, z = Xs.to(dtype), Zs.to(dtype)
                K = pd.stationary_forward_cuda(family, x, z, var, alpha)
                plain32 = pd.stationary_forward_plain(family, x, z, var, alpha)
                plain64 = pd.stationary_forward_plain(family, x.double(), z.double(), var.double(), alpha.double())
                torch.cuda.synchronize()
                assert K.shape == (n, m) and K.dtype == torch.float32
                err64 = float((K.double() - plain64).abs().max())
                err32 = float((K - plain32).abs().max())
                rel64 = err64 / max(float(plain64.abs().max()), 1e-30)
                log(f"K1 {family:11s} {str(dtype):14s} ({n}, {m}, {d}): max abs err {err64:.3e} "
                    f"(rel {rel64:.3e}) vs plain f64, tol {K1_ATOL_F64 * 1.7:.1e}; "
                    f"{err32:.3e} vs plain f32, tol {K1_ATOL_F32 * 1.7:.1e}")
                if not err64 <= K1_ATOL_F64 * 1.7 or not err32 <= K1_ATOL_F32 * 1.7:
                    raise AssertionError(f"K1 disagrees with its plain version: {family} {dtype} {(n, m, d)}")
                worst = max(worst, err64)
    return worst


def check_k2():
    """Phase 4: K2 against the plain version, its four families, f32 and bf16
    inputs. Exponential and Matern 1/2 carry 1/r: their Zs sit 0.1 of the
    input scale apart from Xs in every dimension, away from r = 0; Matern
    3/2 and 5/2 take overlapping inputs, as the path's Kuu and Kuf do.
    Returns the largest absolute error against float64."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 4)
    var = torch.tensor([1.7], device="cuda")
    worst = 0.0
    for n, m, d in K2_SHAPES:
        scale = 4.0 if d == 8 else 1.0
        Xs = torch.from_numpy((rng.rand(n, d) * scale).astype(np.float32)).cuda()
        Zs = torch.from_numpy((rng.rand(m, d) * scale).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).cuda()
        for family in pd.WGRAD_FAMILIES:
            z0 = Zs + 1.1 * scale if family in ("exponential", "matern12") else Zs
            for dtype in (torch.float32, torch.bfloat16):
                x, z = Xs.to(dtype), z0.to(dtype)
                W = pd.stationary_wgrad_cuda(family, x, z, var, g)
                plain32 = pd.stationary_wgrad_plain(family, x, z, var, g)
                plain64 = pd.stationary_wgrad_plain(family, x.double(), z.double(), var.double(), g.double())
                torch.cuda.synchronize()
                assert W.shape == (n, m) and W.dtype == torch.float32
                top = max(float(plain64.abs().max()), 1e-30)
                err64 = float((W.double() - plain64).abs().max())
                err32 = float((W - plain32).abs().max())
                log(f"K2 {family:11s} {str(dtype):14s} ({n}, {m}, {d}): max abs err {err64:.3e} "
                    f"(rel {err64 / top:.3e}, tol {K2_RTOL_F64:.0e}) vs plain f64; "
                    f"rel {err32 / top:.3e} (tol {K2_RTOL_F32:.0e}) vs plain f32")
                if not err64 <= K2_RTOL_F64 * top or not err32 <= K2_RTOL_F32 * top:
                    raise AssertionError(f"K2 disagrees with its plain version: {family} {dtype} {(n, m, d)}")
                worst = max(worst, err64)
    return worst


def check_grads():
    """Phase 6: dX, dZ, dlengthscales and dvariance of
    ``stationary_kernel_matrix`` on the card against plain autograd through
    ``stationary_forward_plain`` in float64, at the path's Kuu and Kuf."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 3)
    Z = rng.rand(M, D) * 4
    Xb = rng.rand(B, D) * 4
    ls = 0.8 + 0.4 * rng.rand(D)
    for family in ("rbf", "matern52"):
        for which, other in (("Kuu", None), ("Kuf", Xb)):
            g = rng.randn(M, M if other is None else B)
            grads = {}
            for dtype in (torch.float32, torch.float64):
                leaves = [torch.tensor(v, dtype=dtype, device="cuda", requires_grad=True)
                          for v in (Z, Z if other is None else other, ls, 1.3)]
                A, Bm, l, v = leaves
                Bm = A if other is None else Bm
                if dtype == torch.float32:
                    K = pd.stationary_kernel_matrix(A, Bm, l, v, family)
                else:
                    K = pd.stationary_forward_plain(family, A / l, Bm / l, v)
                K.backward(torch.from_numpy(g).to(device="cuda", dtype=K.dtype))
                grads[dtype] = {name: t.grad for name, t in zip(("dZ", "dX", "dls", "dvar"), leaves)
                                if t.grad is not None}
            for name, want in grads[torch.float64].items():
                got = grads[torch.float32][name].double()
                err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                log(f"grad {family} {which} {name}: max abs err {err:.3e} of the f64 max, tol {GRAD_RTOL:.0e}")
                if not err <= GRAD_RTOL:
                    raise AssertionError(f"gradient {name} of {family} {which} disagrees with plain autograd")


def make_training_data(seed):
    """X, Y and Z as ``bench.py:121-126`` makes them."""
    rng = np.random.RandomState(seed)
    X = rng.rand(N_DATA, D).astype(np.float32) * 4.0
    w = rng.randn(D, 1).astype(np.float32)
    Y = np.sin(X @ w) + 0.1 * rng.randn(N_DATA, 1).astype(np.float32)
    Z = X[rng.choice(N_DATA, M, replace=False)].copy()
    return X, Y, Z


def training_model(kernel, Z, dtype, device):
    """The flagship SVGP before training: lengthscales 1, noise 0.1,
    ``num_data`` = N, whitened full q_sqrt (identity), q_mu zeros."""
    from gpflow_tpu_torch import kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP

    from gpflow_tpu_torch import config

    with config.as_context(config.Config(float=dtype)):
        model = SVGP(
            kernel=getattr(kernels, kernel)(lengthscales=np.ones(D)),
            likelihood=likelihoods.Gaussian(NOISE),
            inducing_variable=Z,
            num_data=N_DATA,
        )
    return model.to(device=device, dtype=dtype)


def train(kernel, route, flag, data, Z):
    """Phase 7 for one kernel and route: TRAIN_CALLS calls of
    ``run_steps_sampled`` with sync debug mode "error"; returns the trainer
    and the launch counts of the run."""
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.ops import pallas_distance as pd
    from gpflow_tpu_torch.parallel import DataParallelTrainer

    trainer = DataParallelTrainer(training_model(kernel, Z, torch.float32, "cuda"))
    trainer.stage_data(data)
    with inv_solve(flag):
        pd.launch_counts.update(K1=0, K2=0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [trainer.run_steps_sampled(
                TRAIN_STEPS_PER_CALL, B, generator=torch.Generator(device="cuda").manual_seed(SEED + i))
                for i in range(TRAIN_CALLS)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts = dict(pd.launch_counts)
    losses = torch.cat(losses).cpu()
    steps = TRAIN_CALLS * TRAIN_STEPS_PER_CALL
    expected = {"K1": 2 * steps, "K2": 2 * steps if kernel == "Matern52" else 0}
    log(f"train {kernel} {route}: {steps} steps, loss {float(losses[0]):.6e} -> "
        f"{float(losses[-5:].mean()):.6e} (mean of the last 5); launches {counts}, expected {expected}")
    assert losses.shape == (steps,) and bool(torch.isfinite(losses).all()), f"{kernel} {route}: non-finite loss"
    assert float(losses[-5:].mean()) < float(losses[0]), f"{kernel} {route}: the loss did not fall"
    assert counts == expected, f"{kernel} {route}: launch counts {counts} != {expected}"
    return trainer, counts


def compare_f64(X, Y, Z):
    """Phase 7, last part: the first F64_STEPS steps of Matern52 on INV_SOLVE
    in float32 on the card against float64 on the CPU, from the same values
    on the same batches (both with the float32 jitter, 1e-4)."""
    from gpflow_tpu_torch import config
    from gpflow_tpu_torch.conditionals import inv_solve
    from gpflow_tpu_torch.parallel import DataParallelTrainer
    from gpflow_tpu_torch.utilities import load_jax_values, read_values

    idx = np.random.RandomState(SEED + 5).randint(0, N_DATA, (F64_STEPS, B))
    batches = (X[idx], Y[idx])
    card = training_model("Matern52", Z, torch.float32, "cuda")
    start = read_values(card)
    with inv_solve(True):
        losses32 = DataParallelTrainer(card).run_steps(tuple(torch.from_numpy(a).cuda() for a in batches))
        with config.as_context(config.Config(float=torch.float64, jitter=1e-4)):
            cpu = training_model("Matern52", Z, torch.float64, "cpu")
            load_jax_values(cpu, {k: v.astype(np.float64) for k, v in start.items()})
            t0 = time.perf_counter()
            losses64 = DataParallelTrainer(cpu).run_steps(tuple(torch.from_numpy(a).double() for a in batches))
            cpu_s = time.perf_counter() - t0
    losses32 = losses32.cpu().double()
    loss_err = float(((losses32 - losses64) / losses64).abs().max())
    log(f"f64: {F64_STEPS} Matern52 INV_SOLVE steps at M={M}, B={B} on the CPU in float64 took {cpu_s:.1f} s; "
        f"losses card {losses32.tolist()} cpu {losses64.tolist()}: max rel err {loss_err:.3e}, tol {F64_LOSS_RTOL:.0e}")
    assert loss_err <= F64_LOSS_RTOL, "float32 losses disagree with the float64 CPU model"
    got, want = read_values(card), read_values(cpu)
    for path in sorted(want):
        diff = np.abs(got[path].astype(np.float64) - want[path])
        if path.startswith((".kernel", ".likelihood")):
            log(f"f64: {path}: max abs diff {diff.max():.3e}, tol {F64_HYPER_ATOL:.0e}")
            assert diff.max() <= F64_HYPER_ATOL, f"{path} disagrees with the float64 CPU model"
        else:
            moved = want[path] != start[path]
            share = float(np.mean(diff[moved] > F64_ELEMENT_ATOL)) if moved.any() else 0.0
            log(f"f64: {path}: {int(moved.sum())} elements moved, share off by > {F64_ELEMENT_ATOL:.0e}: "
                f"{share:.3e} (tol {F64_ELEMENT_SHARE:.0e}); max abs diff {diff.max():.3e}")
            assert share <= F64_ELEMENT_SHARE, f"{path} disagrees with the float64 CPU model"


def serve_trained(model, X):
    """Phase 8: cached-posterior requests from the trained Matern52 model."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    requests = [torch.from_numpy(X[i * B:(i + 1) * B]).cuda() for i in range(N_REQUESTS)]
    with torch.no_grad():
        pd.launch_counts.update(K1=0, K2=0)
        post = model.posterior()
        outputs = [post.predict_f(Xb) for Xb in requests]
        torch.cuda.synchronize()
        counts = dict(pd.launch_counts)
    expected = {"K1": 1 + N_REQUESTS, "K2": 0}
    for mean, var in outputs:
        assert mean.shape == var.shape == (B, 1)
        assert bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "trained serving: non-finite output"
        assert bool((var > 0).all()), "trained serving: variance not positive"
    log(f"trained serving: {N_REQUESTS} Matern52 requests finite with var > 0; launches {counts}, expected {expected}")
    assert counts == expected, f"trained serving launch counts {counts} != {expected}"
    return counts


def time_training(trainers):
    """Phase 9: steps per second of each kernel and route, by CUDA events
    around one ``run_steps_sampled`` call, in two rounds of opposite order."""
    from gpflow_tpu_torch.conditionals import inv_solve

    got = {key: [] for key in trainers}
    for order in (list(trainers), list(reversed(trainers))):
        for key in order:
            with inv_solve(key[1] == "inv_solve"):
                ms = request_ms(lambda: trainers[key].run_steps_sampled(TIMED_STEPS, B), 1, warmup=1)
            got[key].append(TIMED_STEPS / ms * 1e3)
    for (kernel, route), rates in got.items():
        log(f"time: train {kernel} {route} at B={B}: {max(rates):.2f} steps/s "
            f"({1e3 / max(rates):.3f} ms per step); rounds {[round(r, 2) for r in rates]}")
    return got


def profile_step(trainer, kernel, route, top=8):
    """Phase 9: device time of one training step by kernel, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from gpflow_tpu_torch.conditionals import inv_solve

    with inv_solve(route == "inv_solve"):
        trainer.run_steps_sampled(1, B)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.run_steps_sampled(1, B)
            end.record()
            torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    device = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    if not device:
        log(f"profile: train {kernel} {route}: the profiler recorded no device time")
        return
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in device) / 1e3
    log(f"profile: train {kernel} {route}: one step {step_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / step_ms:.0f}%), {sum(e.count for e in device)} kernels; largest:")
    for e in device[:top]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} {e.key[:110]}")


def time_k2(n, m):
    """Phase 9: K2 against the plain version, matern52, device time, interleaved."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 6)
    Xs = torch.from_numpy((rng.rand(n, D) * 4).astype(np.float32)).cuda()
    Zs = torch.from_numpy((rng.rand(m, D) * 4).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).cuda()
    var = torch.tensor([1.0], device="cuda")
    fns = {"plain": pd.stationary_wgrad_plain, "k2": pd.stationary_wgrad_cuda}
    got = {"plain": [], "k2": []}
    for which in ("plain", "k2", "k2", "plain"):
        got[which].append(device_ms(lambda: fns[which]("matern52", Xs, Zs, var, g), 50))
    k2, plain = min(got["k2"]), min(got["plain"])
    gbs = n * m * 8 / (k2 * 1e-3) / 1e9
    log(f"time: K2 matern52 ({n}, {m}, {D}): {k2:.4f} ms ({gbs:.0f} GB/s of g read and W written), "
        f"plain {plain:.4f} ms; runs k2 {got['k2']}, plain {got['plain']}")
    return k2, plain


def make_values(seed):
    """Model values in ``load_jax_values`` format, and the data X."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(N_DATA, D) * 4.0).astype(np.float32)
    Z = X[rng.choice(N_DATA, M, replace=False)]
    q_sqrt = np.tril(rng.randn(1, M, M) * (0.1 / np.sqrt(M)), k=-1)
    q_sqrt[0, np.arange(M), np.arange(M)] = 0.1 + 0.9 * rng.rand(M)
    values = {
        ".inducing_variable.Z": Z,
        ".kernel.lengthscales": np.ones(D, np.float32),
        ".kernel.variance": np.asarray(1.0, np.float32),
        ".likelihood.variance": np.asarray(NOISE, np.float32),
        ".q_mu": rng.randn(M, 1).astype(np.float32),
        ".q_sqrt": q_sqrt.astype(np.float32),
    }
    return values, X


def build_model(values, dtype):
    from gpflow_tpu_torch import config, kernels, likelihoods
    from gpflow_tpu_torch.models import SVGP
    from gpflow_tpu_torch.utilities import load_jax_values

    with config.as_context(config.Config(float=dtype)):
        model = SVGP(
            kernel=kernels.SquaredExponential(lengthscales=np.ones(D)),
            likelihood=likelihoods.Gaussian(1.0),
            inducing_variable=np.zeros((M, D)),
        ).to(dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    load_jax_values(model, {k: v.astype(np_dtype) for k, v in values.items()})
    return model


def serve(model, requests):
    """Phase 4's requests; returns the outputs of the first request of each
    entry point, keyed by route."""
    from gpflow_tpu_torch.conditionals import inv_solve

    out = {}
    post = model.posterior()
    for Xb in requests:
        out.setdefault("cached predict_f", post.predict_f(Xb))
    for Xb in requests:
        out.setdefault("cached predict_mean", (post.predict_mean(Xb),))
    for route, flag in (("solve", False), ("inv_solve", True)):
        with inv_solve(flag):
            out[f"fused predict_f ({route})"] = model.predict_f(requests[0])
            out[f"predict_y ({route})"] = model.predict_y(requests[0])
    return out


def check_slice(outputs, reference):
    """Phase 4's checks on the outputs of ``serve``."""
    for key, tensors in outputs.items():
        for t in tensors:
            assert t.shape == (B, 1) and t.dtype == torch.float32, (key, t.shape, t.dtype)
            assert bool(torch.isfinite(t).all()), f"{key}: non-finite output"
        if len(tensors) == 2:
            assert bool((tensors[1] > 0).all()), f"{key}: variance not positive"
        tol = SLICE_RTOL["cached" if key.startswith("cached") else "fused"]
        for what, got, want in zip(("mean", "var"), tensors, reference[key]):
            err = float((got.double().cpu() - want).abs().max()) / float(want.abs().max())
            log(f"slice: {key} {what}: max abs err {err:.3e} of the f64 CPU max, tol {tol:.0e}")
            assert err <= tol, f"{key} {what} disagrees with the float64 reference"


def time_requests(model, Xb):
    """Phase 5: milliseconds per request of each entry point."""
    from gpflow_tpu_torch.conditionals import inv_solve

    post = model.posterior()
    times = {
        "cached predict_f": request_ms(lambda: post.predict_f(Xb), 20),
        "cached predict_mean": request_ms(lambda: post.predict_mean(Xb), 20),
    }
    for route, flag in (("solve", False), ("inv_solve", True)):
        with inv_solve(flag):
            times[f"fused predict_f ({route})"] = request_ms(lambda: model.predict_f(Xb), 10)
            times[f"predict_y ({route})"] = request_ms(lambda: model.predict_y(Xb), 10)
    for key, ms in times.items():
        log(f"time: {key} at B={B}: {ms:.4f} ms per request ({B / ms * 1e3:.0f} points/s)")


def time_k1(n, m):
    """Phase 5: K1 against the plain version, rbf, device time, interleaved."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    rng = np.random.RandomState(SEED + 2)
    Xs = torch.from_numpy((rng.rand(n, D) * 4).astype(np.float32)).cuda()
    Zs = torch.from_numpy((rng.rand(m, D) * 4).astype(np.float32)).cuda()
    var = torch.tensor([1.0], device="cuda")
    fns = {"plain": pd.stationary_forward_plain, "k1": pd.stationary_forward_cuda}
    got = {"plain": [], "k1": []}
    for which in ("plain", "k1", "k1", "plain"):
        got[which].append(device_ms(lambda: fns[which]("rbf", Xs, Zs, var), 50))
    k1, plain = min(got["k1"]), min(got["plain"])
    gbs = n * m * 4 / (k1 * 1e-3) / 1e9
    log(f"time: K1 rbf ({n}, {m}, {D}): {k1:.4f} ms ({gbs:.0f} GB/s of output), plain {plain:.4f} ms; "
        f"runs k1 {got['k1']}, plain {got['plain']}")
    return k1, plain


def main():
    name, smi = card_check()
    log(smi)
    from gpflow_tpu_torch import config
    from gpflow_tpu_torch.ops import pallas_distance as pd

    for kernel, (ready_s, nvcc_s) in build_kernels().items():
        log(f"build: {kernel} library ready in {ready_s:.2f} s (nvcc {nvcc_s:.2f} s; 0 means built earlier)")

    k1_err = check_k1()
    k2_err = check_k2()

    config.set_default_float(torch.float32)  # and with it the float32 jitter, 1e-4
    launches = {}  # path -> launch counts of its run
    values, X = make_values(SEED)
    model = build_model(values, torch.float32).to("cuda")
    requests = [torch.from_numpy(X[i * B:(i + 1) * B]).to("cuda") for i in range(N_REQUESTS)]
    with torch.no_grad():
        pd.launch_counts.update(K1=0, K2=0)
        outputs = serve(model, requests)
        torch.cuda.synchronize()
        launches["serving"] = dict(pd.launch_counts)
    # cache: Kuu once; cached requests: Kuf each; fused requests: Kuu + Kuf
    expected = {"K1": 1 + 2 * N_REQUESTS + 2 * 2 * 2, "K2": 0}
    log(f"slice: launches {launches['serving']}, expected {expected}")
    assert launches["serving"] == expected, f"serving launch counts {launches['serving']} != {expected}"
    with config.as_context(config.Config(float=torch.float64, jitter=1e-4)), torch.no_grad():
        reference = serve(build_model(values, torch.float64), [torch.from_numpy(X[:B]).double()])
    check_slice(outputs, reference)

    check_grads()

    X, Y, Z = make_training_data(SEED)
    data = (torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda())
    trainers = {}
    for kernel in TRAIN_KERNELS:
        for route, flag in TRAIN_ROUTES:
            trainers[kernel, route], launches[f"training {kernel} {route}"] = train(kernel, route, flag, data, Z)
    compare_f64(X, Y, Z)
    launches["trained serving"] = serve_trained(trainers["Matern52", "inv_solve"].model, X)

    with torch.no_grad():
        time_requests(model, requests[0])
    time_training(trainers)
    for (kernel, route), trainer in trainers.items():
        profile_step(trainer, kernel, route)
    with torch.no_grad():
        time_k1(M, M)
        k1_ms, k1_plain_ms = time_k1(M, B)
        time_k2(M, M)
        k2_ms, k2_plain_ms = time_k2(M, B)

    total = {k: sum(c[k] for c in launches.values()) for k in ("K1", "K2")}
    log(f"launches by path: {launches}")
    log(json.dumps({"kernels": [
        {
            "name": "K1 stationary covariance (rbf and matern52 on the paths)",
            "route": "cuda",
            "source": "gpflow_tpu_torch/csrc/stationary_k1.cu",
            "replaces": "gpflow_tpu/ops/pallas_distance.py:136",
            "launches": total["K1"],
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
        },
        {
            "name": "K2 stationary VJP weight (matern52 on the training path)",
            "route": "cuda",
            "source": "gpflow_tpu_torch/csrc/stationary_k2.cu",
            "replaces": "gpflow_tpu/ops/pallas_distance.py:142",
            "launches": total["K2"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
