#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (metrics_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card, nvcc and the
PyTorch build for CUDA. It exits non-zero, and prints no result, when any
check fails, when no CUDA device is present, or when the package beside it
is missing. Phases:

1. Environment: torch and CUDA versions, the card's name and power limit.
2. Every kernel built from the sources in the checkout (one nvcc each, all
   started together), then held bit for bit against its plain PyTorch
   version on the card, at the main path's shapes and on the edge cases.
3. The main path at ImageNet-1k validation size (50,000 samples, 1,000
   classes, batches of 1,024): a MetricCollection of Accuracy (micro) and
   F1/Precision/Recall (macro) plus BinnedAveragePrecision (100 thresholds),
   updated per batch and computed, then the same stream again with the binned
   counts forced onto the plain version; every state must match bit for bit,
   every kernel must have launched on the main path, and a small input must
   agree with a numpy oracle.
4. Timing with CUDA events (median after warm-up): each kernel beside its
   plain version and its bound, one whole update step, and compute.

The line before the last is the card's name and power limit as nvidia-smi
reports them; before it, one JSON line ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 20261016
N_SAMPLES, N_CLASSES, BATCH, N_THRESHOLDS = 50_000, 1000, 1024, 100
# HBM rate by card (NVIDIA data sheets); the H100 SXM part is the default
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_HBM = 3.35e12
FP32_PEAK = 67e12  # H100 SXM, outside the tensor cores


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {message}")


def check(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return H100_SXM_HBM


def time_ms(torch, fn, warmup: int = 5, reps: int = 30) -> float:
    """Median of per-call CUDA-event times, in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_window(torch, fn, reps: int) -> dict:
    """Per-call device time of each kernel, device busy time and wall time,
    and the host ops that took longest, over ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    device_us, host_us = {}, {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0)
        if dev > 0 and not evt.key.startswith(("aten::", "cuda")):
            device_us[evt.key] = dev / reps
        elif evt.key.startswith("aten::") or evt.key.startswith("cuda"):
            host_us[evt.key] = evt.self_cpu_time_total / reps
    return {"wall_us": wall_us, "device_us": device_us, "host_us": host_us}


def report_profile(label: str, prof: dict) -> None:
    busy = sum(prof["device_us"].values())
    if not prof["device_us"]:
        print(f"  profile [{label}]: wall {prof['wall_us']:.1f} us/call; device time not measured (no device events)")
        return
    idle = max(0.0, 1.0 - busy / prof["wall_us"])
    print(f"  profile [{label}]: wall {prof['wall_us']:.1f} us/call, device busy {busy:.1f} us/call, idle share {idle:.3f}")
    for key, us in sorted(prof["device_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device {us:9.2f} us  {key[:110]}")
    for key, us in sorted(prof["host_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    host   {us:9.2f} us  {key[:110]}")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def binned_cases(torch):
    """(label, preds, target, thresholds) on the card, made from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def uniform(n, c):
        return torch.rand((n, c), generator=gen, device=dev)

    def coin(n, c):
        return torch.rand((n, c), generator=gen, device=dev) < 0.5

    cases = []
    for n, c, t in ((1024, 1000, 100), (257, 7, 21), (1, 3, 5), (4096, 1, 100)):
        cases.append((f"random {n}x{c}x{t}", uniform(n, c), coin(n, c), torch.linspace(0, 1, t, device=dev)))
    p = uniform(300, 5)
    p[::7, 0] = float("nan")
    p[3, :] = float("nan")
    cases.append(("nan scores", p, coin(300, 5), torch.linspace(0, 1, 13, device=dev)))
    grid = torch.tensor([0.5, 0.0, 1.0, 0.5, 0.25, 0.75, 0.25], device=dev)
    on_grid = grid[torch.randint(0, 7, (513, 4), generator=gen, device=dev)]
    cases.append(("unsorted tied thresholds, scores on them", on_grid, coin(513, 4), grid))
    wild = torch.tensor([-math.inf, -0.5, 0.5, 1.5, math.inf], device=dev)
    cases.append(("out-of-range thresholds", uniform(700, 9), coin(700, 9), wild))
    cases.append(("large T: global-atomic path", uniform(600, 3), coin(600, 3), torch.rand(7000, generator=gen, device=dev)))
    cases.append(("empty batch", uniform(0, 6), coin(0, 6), torch.linspace(0, 1, 11, device=dev)))
    return cases


def check_binned_kernel(torch, kernels_mod, binned):
    kernel = kernels_mod.KERNELS["binned_counts"]
    lib = kernel.lib()
    check(lib.binned_counts_class_block(3, 7000) == 0, "T=7000 should take the global-atomic path")
    check(lib.binned_counts_class_block(1000, 100) == 32, "T=100 should take the shared-memory path, 32 classes a block")
    worst = 0.0
    for label, preds, target, thresholds in binned_cases(torch):
        grid = binned.sort_thresholds(thresholds)
        before = kernel.launches
        got = binned.binned_counts(preds, target, grid)
        torch.cuda.synchronize()
        want = binned.binned_counts(preds, target, grid, plain=True)
        torch.cuda.synchronize()
        expected_launches = 0 if preds.shape[0] == 0 else 1
        check(kernel.launches - before == expected_launches, f"binned_counts [{label}]: launches {kernel.launches - before}")
        for g, w, name in zip(got, want, ("TP", "FP", "FN")):
            check(g.shape == w.shape and g.dtype == w.dtype, f"binned_counts [{label}] {name}: shape/dtype")
            err = float((g - w).abs().max()) if g.numel() else 0.0
            check(torch.equal(g, w), f"binned_counts [{label}] {name}: kernel differs from plain, max abs err {err}")
            worst = max(worst, err)
        print(f"  binned_counts [{label}] shape {tuple(preds.shape)} T={thresholds.numel()}: bitwise equal")
    return worst


# --------------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------------- #
def batches(torch):
    """The seeded ImageNet-size stream: (logits, probs, target) per batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for start in range(0, N_SAMPLES, BATCH):
        b = min(BATCH, N_SAMPLES - start)
        target = torch.randint(0, N_CLASSES, (b,), generator=gen, device="cuda")
        logits = torch.randn((b, N_CLASSES), generator=gen, device="cuda")
        logits[torch.arange(b, device="cuda"), target] += 3.0  # a classifier with some skill
        yield logits, torch.softmax(logits, dim=1), target


def build_slice(mt, plain_counts: bool = False):
    coll = mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="micro"),
            "f1": mt.F1Score(num_classes=N_CLASSES, average="macro"),
            "precision": mt.Precision(num_classes=N_CLASSES, average="macro"),
            "recall": mt.Recall(num_classes=N_CLASSES, average="macro"),
        }
    )
    binned = mt.BinnedAveragePrecision(num_classes=N_CLASSES)
    binned._plain_counts = plain_counts
    return coll, binned


def run_slice(torch, mt, plain_counts: bool):
    coll, binned = build_slice(mt, plain_counts)
    n_batches = 0
    for logits, probs, target in batches(torch):
        coll.update(logits, target)
        binned.update(probs, target)
        n_batches += 1
    torch.cuda.synchronize()
    results = coll.compute()
    ap = binned.compute()
    torch.cuda.synchronize()
    states = {f"{k}.{s}": v for k, m in coll.items(keep_base=True) for s, v in m.get_state().items()}
    states.update({f"binned.{s}": v for s, v in binned.get_state().items()})
    return n_batches, states, results, torch.stack(ap)


def check_small_input_against_numpy(torch, mt, np):
    """A 257 x 7 input through the port on the card against a numpy oracle."""
    rng = np.random.default_rng(SEED)
    n, c, t = 257, 7, 21
    logits = rng.normal(size=(n, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    target = rng.integers(0, c, size=n)
    coll = mt.MetricCollection(
        {"acc": mt.Accuracy(num_classes=c, average="micro"), "precision": mt.Precision(num_classes=c, average="macro"),
         "recall": mt.Recall(num_classes=c, average="macro"), "f1": mt.F1Score(num_classes=c, average="macro")}
    )
    binned = mt.BinnedPrecisionRecallCurve(num_classes=c, thresholds=t)
    coll.update(torch.from_numpy(logits).cuda(), torch.from_numpy(target).cuda())
    binned.update(torch.from_numpy(probs).cuda(), torch.from_numpy(target).cuda())
    got = {k: float(v) for k, v in coll.compute().items()}

    pred = logits.argmax(1)
    onehot_t = np.eye(c, dtype=bool)[target]
    onehot_p = np.eye(c, dtype=bool)[pred]
    tp = (onehot_t & onehot_p).sum(0)
    fp = (~onehot_t & onehot_p).sum(0)
    fn = (onehot_t & ~onehot_p).sum(0)
    prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.where(prec + rec > 0, prec + rec, 1), 0.0)
    present = (tp + fp + fn) > 0
    want = {"acc": (pred == target).mean(), "precision": prec[present].mean(), "recall": rec[present].mean(),
            "f1": f1[present].mean()}
    for k, w in want.items():
        check(abs(got[k] - w) <= 1e-6 + 1e-5 * abs(w), f"small input {k}: port {got[k]} vs numpy {w}")

    thr = binned.thresholds.cpu().numpy()
    predicted = probs[:, :, None] >= thr[None, None, :]
    truth = onehot_t[:, :, None]
    for name, oracle in (("TPs", truth & predicted), ("FPs", ~truth & predicted), ("FNs", truth & ~predicted)):
        check(np.array_equal(getattr(binned, name).cpu().numpy(), oracle.sum(0).astype(np.float32)),
              f"small input binned {name} differs from the numpy broadcast")
    print("  small input (257 x 7, T=21): collection and binned counts agree with numpy")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; this smoke run needs the card")
    try:
        import metrics_tpu_torch as mt
        from metrics_tpu_torch.ops import kernels as kernels_mod
        from metrics_tpu_torch.ops.classification import binned_counts as binned
    except ImportError as exc:
        fail(f"the metrics_tpu_torch package is not importable here ({exc})")
    check(not any(m == "jax" or m.startswith(("jax.", "metrics_tpu.")) or m == "metrics_tpu" for m in sys.modules),
          "the port imported JAX or the JAX package")

    # ---- phase 1: environment
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"  card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build every kernel, hold each against its plain version
    t0 = time.perf_counter()
    kernels_mod.build_all()
    print(f"phase 2: built {sorted(kernels_mod.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for kernel in kernels_mod.KERNELS.values():
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kernel.name}: {line.strip()}")
    worst_err = check_binned_kernel(torch, kernels_mod, binned)

    # ---- phase 3: the main path, kernel against plain
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n_batches, states, results, ap = run_slice(torch, mt, plain_counts=False)
    launches = kernels_mod.launch_counts()
    slice_s = time.perf_counter() - t0
    print(f"phase 3: {n_batches} batches of up to {BATCH} ({N_SAMPLES} x {N_CLASSES}) in {slice_s:.2f} s; launches {launches}")
    for kname, count in launches.items():
        check(count > 0, f"kernel {kname} was never launched on the main path")
    check(launches["binned_counts"] == n_batches, f"binned_counts launched {launches['binned_counts']} times for {n_batches} updates")
    _, states_plain, results_plain, ap_plain = run_slice(torch, mt, plain_counts=True)
    for key, value in states.items():
        other = states_plain[key]
        check(value.dtype == other.dtype and torch.equal(value, other), f"state {key} differs from the plain-path run")
    check(states["acc.tp"].dtype == torch.int32 and states["binned.TPs"].dtype == torch.float32, "state dtypes")
    for key, value in results.items():
        check(value.shape == () and bool(torch.isfinite(value)), f"result {key} is not a finite scalar")
        check(torch.equal(value, results_plain[key]), f"result {key} differs from the plain-path run")
    check(ap.shape == (N_CLASSES,) and bool(torch.isfinite(ap).all()), "binned AP is not 1000 finite values")
    check(torch.equal(ap, ap_plain), "binned AP differs from the plain-path run")
    print("  states bitwise equal to the plain-path run; results: "
          + ", ".join(f"{k}={float(v):.6f}" for k, v in results.items()) + f", mean AP={float(ap.mean()):.6f}")
    scores_mb = BATCH * N_CLASSES * 4 / 1e6
    print(f"  per batch: {scores_mb:.1f} MB of scores, {BATCH * N_CLASSES / 1e6:.1f} MB of targets (bool);"
          f" binned state {3 * N_CLASSES * N_THRESHOLDS * 4 / 1e6:.1f} MB")
    check_small_input_against_numpy(torch, mt, np)

    # ---- phase 4: timing
    logits, probs, target = next(batches(torch))
    target_bool = torch.nn.functional.one_hot(target, N_CLASSES) == 1
    grid = binned.sort_thresholds(mt.BinnedAveragePrecision(num_classes=N_CLASSES).thresholds)
    kernel_ms = time_ms(torch, lambda: binned.binned_counts(probs, target_bool, grid))
    plain_ms = time_ms(torch, lambda: binned.binned_counts(probs, target_bool, grid, plain=True))
    n, c, t = BATCH, N_CLASSES, N_THRESHOLDS
    bytes_moved = n * c * (4 + 1) + t * 4 + 3 * c * t * 4
    ops = n * c * math.ceil(math.log2(t + 1))  # one compare per binary-search step
    bound_ms = max(bytes_moved / hbm_rate(name), ops / FP32_PEAK) * 1e3
    bound_by = "bytes" if bytes_moved / hbm_rate(name) >= ops / FP32_PEAK else "operations"

    coll, metric = build_slice(mt)
    stream = list(batches(torch))
    for lg, pb, tg in stream[:3]:  # warm-up
        coll.update(lg, tg)
        metric.update(pb, tg)
    step_times = []
    for lg, pb, tg in stream[3:-1]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        coll.update(lg, tg)
        metric.update(pb, tg)
        end.record()
        end.synchronize()
        step_times.append(start.elapsed_time(end))
    step_ms = statistics.median(step_times)

    def compute_all():
        for m in (*coll.values(), metric):
            m._computed = None
        coll.compute()
        metric.compute()

    compute_ms = time_ms(torch, compute_all, warmup=2, reps=20)
    print(f"phase 4 ({smi}): binned_counts {kernel_ms * 1e3:.1f} us/call, plain {plain_ms * 1e3:.1f} us,"
          f" bound {bound_ms * 1e3:.2f} us ({bound_by}); update step {step_ms * 1e3:.1f} us; compute {compute_ms:.2f} ms")

    # where the time goes, from the profiler's device trace
    kernel_prof = profile_window(torch, lambda: binned.binned_counts(probs, target_bool, grid), reps=20)
    report_profile("binned_counts wrapper", kernel_prof)
    steps = iter(stream[3:-1])

    def one_step():
        lg, pb, tg = next(steps)
        coll.update(lg, tg)
        metric.update(pb, tg)

    report_profile("update step (collection + binned AP)", profile_window(torch, one_step, reps=10))
    report_profile("compute (collection + binned AP)", profile_window(torch, compute_all, reps=5))
    kernel_device_us = sum(us for k, us in kernel_prof["device_us"].items() if "binned_" in k)

    record = {
        "name": "binned_counts",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/binned_counts.cu",
        "replaces": kernels_mod.KERNELS["binned_counts"].replaces,
        "launches": launches["binned_counts"],
        "max_abs_err": worst_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes per-class counts at every threshold",
        "ok": True,
        "us": kernel_ms * 1e3,
        "bound_us": bound_ms * 1e3,
        "plain_us": plain_ms * 1e3,
        "shape": [n, c, t],
        "device_us": kernel_device_us or None,
        "update_step_us": step_ms * 1e3,
        "compute_ms": compute_ms,
    }
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
