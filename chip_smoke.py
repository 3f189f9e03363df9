#!/usr/bin/env python3
"""Drives gpflow_tpu_torch's main path once on one NVIDIA GPU and checks it.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

The path is SVGP serving at the width of ``bench.py``'s flagship model
(SquaredExponential with ARD lengthscales, D = 8, M = 2048 inducing points,
requests of B = 8192 points, float32, Gaussian likelihood, whitened full
q_sqrt), with random values made from a numpy seed. Phases:

1. card: name and power limit; TF32 must be off for matmul and cuDNN;
2. build: kernel K1 from the sources in the checkout (nvcc, first use);
3. K1 against its plain PyTorch version on the card, six families, float32
   and bfloat16 inputs, at the path's shapes and at ragged ones;
4. the slice: ``model.posterior()`` with the TENSOR cache, requests through
   ``predict_f`` and ``predict_mean``, and ``model.predict_f`` and
   ``model.predict_y`` on the solve and INV_SOLVE routes; outputs finite with
   var > 0, K1's launch count exactly as the path implies, and one request of
   each entry point against the same model in float64 on the CPU;
5. timings with CUDA events: per request, and K1 against the plain version.

Every failure raises, and the script then exits non-zero without the result
line. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import time

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


def build_k1():
    from gpflow_tpu_torch.ops import cuda_build
    from gpflow_tpu_torch.ops.pallas_distance import k1_library

    t0 = time.perf_counter()
    k1_library()
    return time.perf_counter() - t0, cuda_build.build_seconds["gpflow_k1"]


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

    build_s, nvcc_s = build_k1()
    log(f"build: K1 library ready in {build_s:.2f} s (nvcc {nvcc_s:.2f} s; 0 means built earlier)")

    k1_err = check_k1()

    config.set_default_float(torch.float32)  # and with it the float32 jitter, 1e-4
    values, X = make_values(SEED)
    model = build_model(values, torch.float32).to("cuda")
    requests = [torch.from_numpy(X[i * B:(i + 1) * B]).to("cuda") for i in range(N_REQUESTS)]
    with torch.no_grad():
        pd.launch_counts["K1"] = 0
        outputs = serve(model, requests)
        torch.cuda.synchronize()
        launches = pd.launch_counts["K1"]
    # cache: Kuu once; cached requests: Kuf each; fused requests: Kuu + Kuf
    expected = 1 + 2 * N_REQUESTS + 2 * 2 * 2
    log(f"slice: K1 launched {launches} times, expected {expected}")
    assert launches == expected, f"K1 launch count {launches} != {expected}"
    with config.as_context(config.Config(float=torch.float64, jitter=1e-4)), torch.no_grad():
        reference = serve(build_model(values, torch.float64), [torch.from_numpy(X[:B]).double()])
    check_slice(outputs, reference)

    with torch.no_grad():
        time_requests(model, requests[0])
        time_k1(M, M)
        k1_ms, plain_ms = time_k1(M, B)

    log(json.dumps({"kernels": [{
        "name": "K1 stationary covariance (rbf on the path)",
        "route": "cuda",
        "source": "gpflow_tpu_torch/csrc/stationary_k1.cu",
        "replaces": "gpflow_tpu/ops/pallas_distance.py:136",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
