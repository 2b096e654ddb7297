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
   version on the card, at the main path's shapes and on the edge cases:
   binned_counts with dense targets and with int32/int64 class labels (out
   of range ones too), on the cluster path (also C = 1 at N = 1,000,000) and
   the beyond-shared-memory workspace path (run twice, so that a workspace
   left unclean would show), unaligned rows and an empty batch; pairwise_iou
   with and without per-image counts (zero, full, mixed, beyond D and G,
   scalar stores, several tiles, 5,000 images, NaN boxes).
3. The classification path at ImageNet-1k validation size (50,000 samples,
   1,000 classes, batches of 1,024): a MetricCollection of Accuracy (micro)
   and F1/Precision/Recall (macro) plus BinnedAveragePrecision (100
   thresholds, fed the (N,) class labels, which its kernel reads as they
   are), updated per batch and computed, then the same stream again with the
   binned counts forced onto the plain version; every state must match bit
   for bit, the binned-counts kernel must have launched once per update, and
   a small input must agree with a numpy oracle.
3b. The detection path at COCO val2017 evaluation size (5,000 images of
   640x480, 80 classes, 100 detections and about 7.4 ground truths per
   image), generated on the card from a seed: MeanAveragePrecision updated
   16 images at a time with no synchronisation allowed, then computed with
   per-class values; then the same stream with the IoU and matcher kernels
   forced onto their plain versions. Every result must match bit for bit,
   each kernel must have launched once per 256-image chunk, and the
   metric's docstring example must give its documented values on the card.
3c. The text path: BERTScore at roberta-large width (an encoder with
   roberta-large's published configuration and seeded random weights, passed
   as the user's model) over 2,000 sentence pairs, the size of WMT19 de-en
   newstest2019, made on the card from a seed and padded to 512 tokens. The
   tensor-core maxsim kernel (3xTF32) must have launched once for the one
   compute, on the operands as they are; it is then held against its plain
   version on that very compute's (2000, 1, 512, 1024) embeddings. Every
   score must be finite, identical pairs must score 1, and the metric's
   docstring example must give its documented values.
4. Timing with CUDA events (median after warm-up): each kernel beside its
   plain version, its bound and, where one exists, a PyTorch call computing
   the same function; one whole update step of each path, compute, and the
   device's idle share from the profiler. binned_counts is timed with class
   labels and with a dense target, and the profiler lists the device
   operations of one call and of one binned update; pairwise_iou with the
   chunk's counts beside the IoU-then-mask step it replaces. maxsim is timed at the compute's
   full shape and at one 64-pair chunk beside the plain version and
   torch.bmm + two amax, with its bound (3xTF32 at the TF32 tensor-core
   peak); the matcher at the COCO compute's (256, 4, 10, 128, 32) and at
   G = 64.

Phases 3, 4 and 5 build their metrics with ``compiled_update=False,
compiled_compute=False``, so their numbers stay those of the eager path.
Phase 6 runs the same stream through the compiled engines.

5. Sync on the card (one card, so a world of one rank: NCCL refuses two
   ranks on one device; several ranks are tested on the CPU with gloo).
   (b) entry() and (c) dryrun_multichip(1) on the card against the same
   calls on the CPU port: int32 states and entry's results bitwise, the
   dry-run's loss, weight and AP within 1e-6, B1 launched once. (e) Each
   binned class built on the CPU and moved to the card, and back, counts
   and computes bit for bit as a twin built in place. Then, in a world of
   one NCCL rank under sync_axes: (a) phase 3's stream again, compute()
   synced, one all_reduce per (reduction, dtype) bucket per compute group,
   B1 launched once per update, every result and state bitwise equal to
   phase 3; (d) mAP on 512 of phase 3b's images and BERTScore on its
   docstring example and one 64-pair chunk of phase 3c, each synced compute
   bitwise equal to its unsynced one; (f) the synced and unsynced
   ImageNet-size compute timed by events (median of 30).

6. The compiled main path (``core/engine.py``: CUDA-graph capture) on phase
   3's ImageNet-size stream, held against phase 3's eager run. (a) With the
   engines at their defaults, then with ``batch_buckets=True`` on every
   metric, every state and three computes (warmup, capture, replay) equal the
   eager run bit for bit. (b) Each engine's eager calls, captures and replays
   are those of its signatures (the first call of each eager, the second
   captured, every later one replayed); every member is on the fused path
   (bucketed under ``batch_buckets``) for update and compute, nothing fell
   back, every step holds a graph; the in-place (donated) calls are those the
   alias guard allows. (c) B1 launched once per binned update and per pow2
   chunk of the ragged batch, replays counted. (d) The steady-state updates
   run under ``torch.cuda.set_sync_debug_mode("error")``. (e) At the
   defaults ``torch.cuda.memory_allocated()`` is the same before every
   steady-state step. (f) The update step by CUDA events (median of the
   steady state) and its device-idle share by the profiler, then the compute
   the same way, eager, compiled, compiled, eager. (g) A binned update at
   T = 20,000 (B1's workspace path) captured and replayed, bitwise equal to
   eager.

Phase 2 holds the integer and IoU kernels bit for bit against their plain
versions, the matcher also on every staging path (D in double-buffered slabs,
bulk copies and plain loads) and argmax path up to G = 38,741; the 3xTF32
maxsim kernel (2c, on shapes TMA describes as they are and on padded copies
of the others) sums in another order than the plain version's matrix
product, so it is held within 1e-5 of it and of a float64 recomputation.

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
# COCO val2017: 5,000 images, 80 classes, maxDets=100, 36,781 instances
COCO_IMAGES, COCO_CLASSES, COCO_DETS, COCO_BATCH = 5000, 80, 100, 16
COCO_W, COCO_H, COCO_GT_RATE, COCO_MAX_GT = 640.0, 480.0, 6.4, 64
# WMT19 de-en newstest2019: 2,000 sentence pairs; 8 of them identical (controls)
BERT_PAIRS, BERT_BATCH, BERT_MAX_LEN, BERT_CONTROLS = 2000, 64, 512, 8
# roberta-large's published configuration (Hugging Face roberta-large config.json)
ROBERTA_LARGE = dict(vocab=50265, hidden=1024, layers=24, heads=16, ffn=4096, positions=514, eps=1e-5,
                     pad=1, bos=0, eos=2)
MAXSIM_ATOL, PRF_RTOL = 1e-5, 1e-4
CLASSIFICATION_KERNELS = ("binned_counts",)
DETECTION_KERNELS = ("pairwise_iou", "greedy_match")
TEXT_KERNELS = ("maxsim_tf32x3",)
# HBM rate, float32 rate outside the tensor cores and dense TF32 tensor-core
# rate by card (NVIDIA data sheets); the H100 SXM part (named "H100 80GB
# HBM3") is the default
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
FP32_FLOP_PER_S = {"H100 PCIe": 51e12, "H100 NVL": 60e12}
TF32_FLOP_PER_S = {"H100 PCIe": 378e12, "H100 NVL": 417.5e12}
H100_SXM_HBM = 3.35e12
H100_SXM_FP32 = 67e12
H100_SXM_TF32 = 495e12


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


def card_rate(table: dict, default: float, name: str) -> float:
    for key, rate in table.items():
        if key in name:
            return rate
    return default


def bound(bytes_moved: float, ops: float, name: str, tf32: bool = False):
    """The least time in ms for the work (the larger of bytes over the memory
    rate and operations over the peak rate: float32 outside the tensor cores,
    or TF32 on them) and which one bounds it."""
    t_bytes = bytes_moved / card_rate(HBM_BYTES_PER_S, H100_SXM_HBM, name)
    if tf32:
        t_ops = ops / card_rate(TF32_FLOP_PER_S, H100_SXM_TF32, name)
    else:
        t_ops = ops / card_rate(FP32_FLOP_PER_S, H100_SXM_FP32, name)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
        lead_in(torch)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    return {"wall_us": wall_us, **split_profile(prof, reps)}


def lead_in(torch) -> None:
    """A few short spin kernels at the start of a profiler window: the
    profiler has been seen to drop the first five device records of a window
    on the card, and these take their place (split_profile leaves them out)."""
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def split_profile(prof, reps: int = 1) -> dict:
    """Device time by kernel and host time by op, per call of ``reps``, and
    the device time per recorded launch of each kernel. A run of the
    profiler may miss some launches' records, so a kernel's own time is
    taken per recorded launch; CUPTI's "Activity Buffer Request" is its own
    bookkeeping, not device work, and the lead-in's spin kernels are not
    the work measured."""
    device_us, per_launch_us, recorded, host_us = {}, {}, {}, {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0)
        if evt.key.startswith(("aten::", "cuda")):
            host_us[evt.key] = evt.self_cpu_time_total / reps
        elif dev > 0 and evt.key != "Activity Buffer Request" and "spin_kernel" not in evt.key:
            device_us[evt.key] = dev / reps
            per_launch_us[evt.key] = dev / evt.count
            recorded[evt.key] = evt.count
    return {"device_us": device_us, "per_launch_us": per_launch_us, "recorded": recorded, "host_us": host_us}


def report_profile(label: str, prof: dict) -> None:
    busy = sum(prof["device_us"].values())
    if not prof["device_us"]:
        print(f"  profile [{label}]: wall {prof['wall_us']:.1f} us/call; device time not measured (no device events)")
        return
    idle = max(0.0, 1.0 - busy / prof["wall_us"])
    print(f"  profile [{label}]: wall {prof['wall_us']:.1f} us/call, device busy {busy:.1f} us/call, idle share {idle:.3f}")
    for key, us in sorted(prof["device_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device {us:9.2f} us  ({prof['recorded'][key]} launches recorded, {prof['per_launch_us'][key]:.2f} us each)"
              f"  {key[:110]}")
    for key, us in sorted(prof["host_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    host   {us:9.2f} us  {key[:110]}")


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def binned_cases(torch, max_shared_t):
    """(label, preds, target, thresholds, calls) on the card, made from a seed:
    the dense (N, C) form, then the label form; ``calls`` is how many times in
    a row the case runs (twice where a workspace left unclean would show)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def uniform(n, c):
        return torch.rand((n, c), generator=gen, device=dev)

    def coin(n, c):
        return torch.rand((n, c), generator=gen, device=dev) < 0.5

    def labels(n, c, dtype=torch.int64, low=0, high=None):
        return torch.randint(low, c if high is None else high, (n,), generator=gen, device=dev, dtype=dtype)

    def lin(t):
        return torch.linspace(0, 1, t, device=dev)

    def odd_offset(x):  # the same values at a storage offset of one element: no vector loads
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    cases = []
    for n, c, t in ((1024, 1000, 100), (257, 7, 21), (1, 3, 5), (4096, 1, 100)):
        cases.append((f"dense random {n}x{c}x{t}", uniform(n, c), coin(n, c), lin(t), 1))
    p = uniform(300, 5)
    p[::7, 0] = float("nan")
    p[3, :] = float("nan")
    cases.append(("dense nan scores", p, coin(300, 5), lin(13), 1))
    grid = torch.tensor([0.5, 0.0, 1.0, 0.5, 0.25, 0.75, 0.25], device=dev)
    on_grid = grid[torch.randint(0, 7, (513, 4), generator=gen, device=dev)]
    cases.append(("dense unsorted tied thresholds, scores on them", on_grid, coin(513, 4), grid, 1))
    wild = torch.tensor([-math.inf, -0.5, 0.5, 1.5, math.inf], device=dev)
    cases.append(("dense out-of-range thresholds", uniform(700, 9), coin(700, 9), wild, 1))
    cases.append(("dense T=7000, shared path", uniform(600, 3), coin(600, 3), torch.rand(7000, generator=gen, device=dev), 1))
    cases.append(("dense C=1 N=1e6, one cluster", uniform(1_000_000, 1), coin(1_000_000, 1), lin(100), 2))
    cases.append(("dense odd storage offset", odd_offset(uniform(777, 12)), odd_offset(coin(777, 12)), lin(50), 1))
    cases.append(("dense empty batch", uniform(0, 6), coin(0, 6), lin(11), 1))

    cases.append(("labels int64 in range 1024x1000x100", uniform(1024, 1000), labels(1024, 1000), lin(100), 1))
    cases.append(("labels int32 in range 1024x1000x100", uniform(1024, 1000), labels(1024, 1000, torch.int32), lin(100), 1))
    cases.append(("labels int64 at -1 and C", uniform(513, 12), labels(513, 12, low=-1, high=13), lin(21), 1))
    cases.append(("labels int32 at -1 and C", uniform(513, 12), labels(513, 12, torch.int32, low=-1, high=13), lin(21), 1))
    big = labels(300, 8, low=-1, high=9)
    big[::5] += 2**32  # C + 2**32 and the like must not match class C mod 2**32
    cases.append(("labels int64 beyond int32", uniform(300, 8), big, lin(17), 1))
    cases.append(("labels C=7, unaligned rows", uniform(257, 7), labels(257, 7), lin(21), 1))
    cases.append(("labels C=1 N=1e6 int64, one cluster", uniform(1_000_000, 1), labels(1_000_000, 1, high=2), lin(100), 2))
    cases.append(("labels C=1 N=1e6 int32, one cluster", uniform(1_000_000, 1), labels(1_000_000, 1, torch.int32, high=2), lin(100), 2))
    cases.append(("labels C=4 N=200000, one cluster, vector loads", uniform(200_000, 4), labels(200_000, 4), lin(100), 2))
    cases.append(("labels odd storage offset", odd_offset(uniform(777, 12)), labels(777, 12), lin(50), 1))
    p = uniform(300, 5)
    p[::7, 0] = float("nan")
    cases.append(("labels nan scores", p, labels(300, 5), lin(13), 1))
    cases.append(("labels T=7000, shared path", uniform(600, 3), labels(600, 3), torch.rand(7000, generator=gen, device=dev), 1))
    beyond = max_shared_t + 1000
    cases.append((f"labels T={beyond}, beyond shared memory", uniform(600, 3), labels(600, 3),
                  torch.rand(beyond, generator=gen, device=dev), 2))
    cases.append((f"dense T={beyond}, beyond shared memory", uniform(600, 3), coin(600, 3),
                  torch.rand(beyond, generator=gen, device=dev), 2))
    cases.append(("labels empty batch", uniform(0, 6), labels(0, 6), lin(11), 1))
    return cases


def check_binned_kernel(torch, kernels_mod, binned):
    kernel = kernels_mod.KERNELS["binned_counts"]
    lib = kernel.lib()
    max_t = lib.binned_counts_max_shared_t()
    check(lib.binned_counts_class_block(1000, 100) >= 4, "T=100 should take the cluster path, at least 4 classes a block")
    check(lib.binned_counts_class_block(3, 7000) == 2, "T=7000 should take the cluster path, 2 classes a block")
    check(lib.binned_counts_class_block(1, max_t) == 1 and lib.binned_counts_class_block(1, max_t + 1) == 0,
          f"the cluster path should end at T={max_t}")
    check(lib.binned_counts_workspace_len(1000, 100) == 0 and lib.binned_counts_workspace_len(1, max_t) == 0,
          "the cluster path should need no workspace")
    check(lib.binned_counts_workspace_len(3, max_t + 1) == 3 + 2 * 3 * (max_t + 2),
          "the global path's workspace should hold a ticket per class and the (2, C, T + 1) histogram")
    print(f"  binned_counts: the cluster path takes T up to {max_t}; beyond, the global-workspace path")
    worst = 0.0
    for label, preds, target, thresholds, calls in binned_cases(torch, max_t):
        grid = binned.sort_thresholds(thresholds)
        want = binned.binned_counts(preds, target, grid, plain=True)
        torch.cuda.synchronize()
        for call in range(calls):
            before = kernel.launches
            got = binned.binned_counts(preds, target, grid)
            torch.cuda.synchronize()
            expected_launches = 0 if preds.shape[0] == 0 else 1
            check(kernel.launches - before == expected_launches, f"binned_counts [{label}]: launches {kernel.launches - before}")
            for g, w, name in zip(got, want, ("TP", "FP", "FN")):
                check(g.shape == w.shape and g.dtype == w.dtype, f"binned_counts [{label}] {name}: shape/dtype")
                err = float((g - w).abs().max()) if g.numel() else 0.0
                check(torch.equal(g, w), f"binned_counts [{label}] call {call + 1} {name}: kernel differs from plain,"
                                         f" max abs err {err}")
                worst = max(worst, err)
        print(f"  binned_counts [{label}] shape {tuple(preds.shape)} target {tuple(target.shape)} {target.dtype}"
              f" T={thresholds.numel()}: bitwise equal" + (f" in {calls} calls in a row" if calls > 1 else ""))
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


def build_slice(mt, plain_counts: bool = False, compiled: bool = False, buckets: bool = False):
    """The slice's collection and binned metric: eager (``compiled=False``,
    phases 3-5) or with the compiled engines at their defaults (phase 6),
    optionally with ``batch_buckets=True`` on every metric."""
    flags = {} if compiled else {"compiled_update": False, "compiled_compute": False}
    kw = dict(flags, batch_buckets=buckets)
    coll = mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="micro", **kw),
            "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", **kw),
            "precision": mt.Precision(num_classes=N_CLASSES, average="macro", **kw),
            "recall": mt.Recall(num_classes=N_CLASSES, average="macro", **kw),
        },
        **flags,
    )
    binned = mt.BinnedAveragePrecision(num_classes=N_CLASSES, **kw)
    binned._plain_counts = plain_counts
    return coll, binned


def slice_states(coll, binned) -> dict:
    states = {f"{k}.{s}": v for k, m in coll.items(keep_base=True) for s, v in m.get_state().items()}
    states.update({f"binned.{s}": v for s, v in binned.get_state().items()})
    return states


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
    return n_batches, slice_states(coll, binned), results, torch.stack(ap)


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


# --------------------------------------------------------------------------- #
# phase 2: the detection kernels against their plain versions
# --------------------------------------------------------------------------- #
def random_boxes(torch, gen, shape, low=0.0, high=500.0, side=(1.0, 200.0)):
    xy = low + torch.rand((*shape, 2), generator=gen, device="cuda") * (high - low)
    wh = side[0] + torch.rand((*shape, 2), generator=gen, device="cuda") * (side[1] - side[0])
    return torch.cat([xy, xy + wh], dim=-1).contiguous()


def iou_cases(torch):
    """(label, det (B, D, 4), gt (B, G, 4), det_counts, gt_counts) on the card,
    made from a seed; counts are None for the count-free cases."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [(f"random {b}x{d}x{g}", random_boxes(torch, gen, (b, d)), random_boxes(torch, gen, (b, g)), None, None)
             for b, d, g in ((256, 128, 64), (1, 1, 1), (3, 7, 5))]
    det = torch.tensor([[[0, 0, 0, 5], [5, 0, 0, 5], [10, 10, 20, 20], [0, 0, 2, 2], [3, 3, 3, 3]]],
                       dtype=torch.float32, device="cuda")
    gt = torch.tensor([[[20, 10, 30, 20], [0, 0, 2, 2], [10, 20, 20, 30], [5, 0, 0, 5]]],
                      dtype=torch.float32, device="cuda")
    cases.append(("degenerate, touching and identical boxes", det, gt, None, None))
    cases.append(("coordinates near 1e6", random_boxes(torch, gen, (4, 32), 1e6, 1e6 + 300.0, (0.5, 40.0)),
                  random_boxes(torch, gen, (4, 16), 1e6, 1e6 + 300.0, (0.5, 40.0)), None, None))
    same = random_boxes(torch, gen, (8, 16))
    cases.append(("identical box sets", same, same.clone(), None, None))

    def counts(b, top, low=0):
        return torch.randint(low, top + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)

    def with_counts(label, b, d, g, det_counts, gt_counts):
        cases.append((label, random_boxes(torch, gen, (b, d)), random_boxes(torch, gen, (b, g)), det_counts, gt_counts))

    zeros = torch.zeros(256, dtype=torch.int32, device="cuda")
    with_counts("counts all zero 256x128x32", 256, 128, 32, zeros, zeros)
    with_counts("counts all full 256x128x32", 256, 128, 32, torch.full_like(zeros, 128), torch.full_like(zeros, 32))
    with_counts("counts mixed 256x128x32", 256, 128, 32, counts(256, 128), counts(256, 32))
    with_counts("counts beyond D and G 64x100x40", 64, 100, 40, counts(64, 130), counts(64, 50))
    with_counts("counts mixed G=5, scalar stores", 37, 100, 5, counts(37, 100), counts(37, 5))
    with_counts("counts mixed G=33, scalar stores", 37, 100, 33, counts(37, 100), counts(37, 33))
    with_counts("counts mixed D=300 G=100, several tiles", 9, 300, 100, counts(9, 300), counts(9, 100))
    with_counts("counts mixed B=5000 (one call for the whole compute)", 5000, 128, 32, counts(5000, 100), counts(5000, 32, 1))
    flat_d = torch.zeros(64 * 128 * 4 + 1, device="cuda")
    flat_d[1:] = random_boxes(torch, gen, (64, 128)).reshape(-1)
    flat_g = torch.zeros(64 * 32 * 4 + 1, device="cuda")
    flat_g[1:] = random_boxes(torch, gen, (64, 32)).reshape(-1)
    cases.append(("counts mixed, boxes at an odd storage offset", flat_d[1:].view(64, 128, 4), flat_g[1:].view(64, 32, 4),
                  counts(64, 128), counts(64, 32)))
    det, gt = random_boxes(torch, gen, (32, 64)), random_boxes(torch, gen, (32, 16))
    det_counts, gt_counts = counts(32, 64, 1), counts(32, 16, 1)
    det[:, ::3, 0] = float("nan")  # inside and outside the valid rows
    gt[:, ::4, 3] = float("nan")
    det[:, 63, :] = float("nan")  # every pad row NaN
    cases.append(("counts mixed, NaN boxes inside and outside the valid region", det, gt, det_counts, gt_counts))
    return cases


def check_iou_kernel(torch, kernels_mod, im):
    kernel = kernels_mod.KERNELS["pairwise_iou"]
    worst = 0.0
    for label, det, gt, det_counts, gt_counts in iou_cases(torch):
        before = kernel.launches
        got = im.pairwise_iou(det, gt, det_counts, gt_counts)
        torch.cuda.synchronize()
        want = im.pairwise_iou(det, gt, det_counts, gt_counts, plain=True)
        torch.cuda.synchronize()
        check(kernel.launches - before == 1, f"pairwise_iou [{label}]: launches {kernel.launches - before}")
        check(got.shape == want.shape and got.dtype == want.dtype, f"pairwise_iou [{label}]: shape/dtype")
        err = float(torch.nan_to_num(got - want, nan=math.inf).abs().max())
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"pairwise_iou [{label}]: kernel differs from plain in its bits, max abs err {err}")
        worst = max(worst, err)
        print(f"  pairwise_iou [{label}] det {tuple(det.shape)} gt {tuple(gt.shape)}"
              f"{'' if det_counts is None else ' with counts'}: bitwise equal")
    return worst


def match_case(torch, im, gen, b, a, t, d, g, n_labels=3, ties=False, det_ok_p=0.8, gt_ok_p=0.85):
    """Matcher inputs: IoUs of random boxes (or drawn from a few values, so
    that rows tie), random labels, validity and area-ignore flags."""
    if ties:
        values = torch.tensor([0.0, 0.3, 0.6, 0.6, 0.9, 1.0], device="cuda")
        ious = values[torch.randint(0, 6, (b, d, g), generator=gen, device="cuda")].contiguous()
    else:
        ious = im.pairwise_iou(random_boxes(torch, gen, (b, d), high=200.0, side=(5.0, 100.0)),
                               random_boxes(torch, gen, (b, g), high=200.0, side=(5.0, 100.0)))
    return (
        ious,
        torch.rand((b, d), generator=gen, device="cuda") < det_ok_p,
        torch.randint(0, n_labels, (b, d), generator=gen, device="cuda", dtype=torch.int32),
        torch.randint(0, n_labels, (b, g), generator=gen, device="cuda", dtype=torch.int32),
        torch.rand((b, g), generator=gen, device="cuda") < gt_ok_p,
        torch.rand((b, a, g), generator=gen, device="cuda") < 0.2,
        torch.linspace(0.5, 0.95, t, device="cuda"),
    )


def threshold_tie_case(torch, gen, b=16, a=4, t=10, d=8, g=32):
    """Image i's first detection has one candidate, ground truth 0, whose IoU
    is thresholds[i % T] to the bit: it matches below that threshold and not
    at it, since the test is strictly greater."""
    thresholds = torch.linspace(0.5, 0.95, t, device="cuda")
    ious = torch.rand((b, d, g), generator=gen, device="cuda")
    ious[:, 0, 0] = thresholds[torch.arange(b, device="cuda") % t]
    det_labels = torch.ones((b, d), dtype=torch.int32, device="cuda")
    gt_labels = torch.ones((b, g), dtype=torch.int32, device="cuda")
    det_labels[:, 0], gt_labels[:, 0] = 0, 0  # the only ground truth of label 0
    return (ious, torch.ones((b, d), dtype=torch.bool, device="cuda"), det_labels, gt_labels,
            torch.ones((b, g), dtype=torch.bool, device="cuda"), torch.zeros((b, a, g), dtype=torch.bool, device="cuda"),
            thresholds)


def check_match_kernel(torch, kernels_mod, im):
    kernel = kernels_mod.KERNELS["greedy_match"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [
        ("COCO chunk B=256 A=4 T=10 D=128 G=64", match_case(torch, im, gen, 256, 4, 10, 128, 64)),
        ("COCO compute's shape B=256 A=4 T=10 D=128 G=32", match_case(torch, im, gen, 256, 4, 10, 128, 32)),
        ("G=33, the first strided case", match_case(torch, im, gen, 64, 4, 10, 128, 33)),
        ("80 labels: most detections without a candidate", match_case(torch, im, gen, 64, 4, 10, 128, 32, n_labels=80)),
        ("80 labels, G=64", match_case(torch, im, gen, 64, 4, 10, 128, 64, n_labels=80)),
        ("only candidate's IoU equal to a threshold", threshold_tie_case(torch, gen)),
        ("G=128", match_case(torch, im, gen, 32, 4, 10, 128, 128)),
        ("G=256", match_case(torch, im, gen, 16, 4, 10, 64, 256)),
        ("D=1", match_case(torch, im, gen, 8, 4, 10, 1, 64, ties=True)),
        ("all-invalid rows", match_case(torch, im, gen, 8, 4, 10, 32, 16, det_ok_p=0.0, gt_ok_p=0.0)),
        # D staged in double-buffered slabs (D * (4G + 5) > 128 KB): bulk copies
        # of every operand over 2 and over 11 slabs (both mbarrier parities),
        # then plain loads where rows are not 16-byte multiples
        ("slabs, bulk copies: D=512 G=64", match_case(torch, im, gen, 8, 4, 10, 512, 64)),
        ("11 slabs, bulk copies: D=2048 G=100", match_case(torch, im, gen, 3, 4, 10, 2048, 100)),
        ("slabs, plain loads: D=1001 G=33", match_case(torch, im, gen, 4, 4, 10, 1001, 33)),
        ("G=300, the 32-slot path", match_case(torch, im, gen, 8, 4, 10, 128, 300, n_labels=2)),
        ("G=1500, the word-mask path", match_case(torch, im, gen, 4, 4, 10, 96, 1500, n_labels=2)),
        ("G=32768, the word-mask path", match_case(torch, im, gen, 2, 4, 10, 24, 32768, n_labels=2)),
        ("G=38741", match_case(torch, im, gen, 1, 4, 10, 16, 38741, n_labels=2)),
        ("duplicate ground truths, tied IoUs", match_case(torch, im, gen, 64, 4, 10, 48, 24, n_labels=2, ties=True)),
    ]
    check(kernel.lib().greedy_match_max_g() >= 38741, f"greedy_match takes G up to {kernel.lib().greedy_match_max_g()} only")
    # exact duplicates: ground truth 1 repeats ground truth 0 in every row
    ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thr = cases[-1][1]
    ious[:, :, 1], gt_labels[:, 1], gt_ok[:, 1], gt_ignore[:, :, 1] = ious[:, :, 0], gt_labels[:, 0], gt_ok[:, 0], gt_ignore[:, :, 0]
    for label, args in cases:
        before = kernel.launches
        got = im.greedy_match(*args)
        torch.cuda.synchronize()
        want = im.greedy_match(*args, plain=True)
        torch.cuda.synchronize()
        check(kernel.launches - before == 1, f"greedy_match [{label}]: launches {kernel.launches - before}")
        check(got.shape == want.shape and got.dtype == want.dtype, f"greedy_match [{label}]: shape/dtype")
        differ = int((got != want).sum())
        check(differ == 0, f"greedy_match [{label}]: kernel differs from plain in {differ} flags")
        print(f"  greedy_match [{label}] out {tuple(got.shape)}, {int(got.sum())} matches: bitwise equal")
    # the tie case, by its construction: detection 0 of image i matches at threshold index t < i % T only
    got = im.greedy_match(*dict(cases)["only candidate's IoU equal to a threshold"])[:, :, :, 0]
    t = got.shape[2]
    want = torch.arange(t, device="cuda")[None, :] < (torch.arange(got.shape[0], device="cuda") % t)[:, None]
    check(torch.equal(got, want[:, None, :].expand_as(got)), "greedy_match: an IoU equal to its threshold matched")
    return 0.0


# --------------------------------------------------------------------------- #
# phase 3b: the detection path at COCO val2017 size
# --------------------------------------------------------------------------- #
def coco_stream(torch):
    """The seeded COCO-size stream on the card: a list of updates, each a
    (preds, targets) pair of lists of per-image dicts (views of a few large
    tensors). Ground truths per image 1 + Poisson(6.4), at most 64, sides
    log-uniform in 4-400 px; 100 detections per image, first up to three
    jittered copies of each ground truth (corner noise 10% of the side,
    label kept with probability 0.9, score U(0.3, 1)), then random boxes
    (score U(0, 0.6))."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n, g_max, d = COCO_IMAGES, COCO_MAX_GT, COCO_DETS

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def labels(*shape):
        return torch.randint(0, COCO_CLASSES, shape, generator=gen, device="cuda", dtype=torch.int32)

    def place(*shape):
        w = torch.exp(math.log(4.0) + rand(*shape) * math.log(100.0))
        h = torch.exp(math.log(4.0) + rand(*shape) * math.log(100.0))
        x1, y1 = rand(*shape) * (COCO_W - w), rand(*shape) * (COCO_H - h)
        return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)

    n_gt = (1 + torch.poisson(torch.full((n,), COCO_GT_RATE, device="cuda"), generator=gen)).clamp(max=g_max)
    n_gt = n_gt.to(torch.int64)
    gt_boxes, gt_labels = place(n, g_max), labels(n, g_max)
    # candidate copies: copy k of ground truth j exists when j < n_gt and k < copies_j
    copies = torch.randint(0, 4, (n, g_max), generator=gen, device="cuda")
    slots = torch.arange(g_max, device="cuda")
    exists = (slots[None, :, None] < n_gt[:, None, None]) & (torch.arange(3, device="cuda") < copies[..., None])
    side = (gt_boxes[..., 2:] - gt_boxes[..., :2]).repeat(1, 1, 2)[:, :, None, :]
    cand_boxes = gt_boxes[:, :, None, :] + torch.randn((n, g_max, 3, 4), generator=gen, device="cuda") * 0.1 * side
    cand_labels = torch.where(rand(n, g_max, 3) < 0.9, gt_labels[:, :, None], labels(n, g_max, 3))
    cand_scores = 0.3 + 0.7 * rand(n, g_max, 3)
    exists = exists.reshape(n, -1)
    first = torch.argsort((~exists).to(torch.int8), dim=1, stable=True)[:, :d]  # existing copies first
    n_copy = exists.sum(dim=1).clamp(max=d)
    is_copy = torch.arange(d, device="cuda")[None, :] < n_copy[:, None]
    det_boxes = torch.where(is_copy[..., None], torch.gather(cand_boxes.reshape(n, -1, 4), 1, first[..., None].expand(n, d, 4)), place(n, d))
    det_labels = torch.where(is_copy, torch.gather(cand_labels.reshape(n, -1), 1, first), labels(n, d))
    det_scores = torch.where(is_copy, torch.gather(cand_scores.reshape(n, -1), 1, first), 0.6 * rand(n, d))
    counts = n_gt.tolist()  # set-up: the host needs each image's count to cut its view
    images = [
        ({"boxes": det_boxes[i], "scores": det_scores[i], "labels": det_labels[i]},
         {"boxes": gt_boxes[i, : counts[i]], "labels": gt_labels[i, : counts[i]]})
        for i in range(n)
    ]
    torch.cuda.synchronize()
    stream = []
    for start in range(0, n, COCO_BATCH):
        part = images[start : start + COCO_BATCH]
        stream.append(([p for p, _ in part], [t for _, t in part]))
    return stream, sum(counts)


def run_coco(torch, mt, stream, plain: bool):
    """Update 16 images at a time with synchronisation forbidden, then compute."""
    metric = mt.MeanAveragePrecision(class_metrics=True)
    metric._plain_kernels = plain
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for preds, targets in stream:
            metric.update(preds, targets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    results = metric.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    peak_extra = torch.cuda.max_memory_allocated() - base
    return metric, results, update_s, compute_s, peak_extra


def check_map_docstring_example(torch, mt):
    preds = [dict(boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]], device="cuda"),
                  scores=torch.tensor([0.536], device="cuda"), labels=torch.tensor([0], device="cuda"))]
    target = [dict(boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]], device="cuda"),
                   labels=torch.tensor([0], device="cuda"))]
    metric = mt.MeanAveragePrecision()
    metric.update(preds, target)
    result = metric.compute()
    got = (round(float(result["map"]), 2), round(float(result["map_50"]), 2))
    check(got == (0.6, 1.0), f"MeanAveragePrecision docstring example gives {got}, documented (0.6, 1.0)")
    print(f"  docstring example on the card: map {got[0]}, map_50 {got[1]}, as documented")


def chunk_inputs(torch, metric, im):
    """The first 256-image chunk of a filled metric, as compute() hands it to
    the two kernels: (sorted det boxes, gt boxes, det counts, gt counts) and
    the matcher's inputs."""
    arrays, (cid, cmask, area_ranges, thresholds, max_det), _, _ = metric._evaluation_inputs(metric._get_classes())
    det_boxes, det_scores, det_labels, det_counts, gt_boxes, gt_labels, gt_counts = (x[:256].contiguous() for x in arrays)
    prep = im.match_inputs(det_boxes, det_scores, det_labels, det_counts, gt_boxes, gt_labels, gt_counts,
                           cid, cmask, area_ranges, max_det)
    boxes_sorted = prep["boxes_sorted"].contiguous()
    ious = im.pairwise_iou(boxes_sorted, gt_boxes, det_counts, gt_counts)
    match_args = (ious, prep["det_class_valid"].any(dim=1), prep["labels_sorted"].contiguous(), gt_labels,
                  prep["gt_class_valid"].any(dim=1), prep["gt_area_ignore"].contiguous(), thresholds)
    return (boxes_sorted, gt_boxes, det_counts, gt_counts), match_args


def profile_compute(torch, metric) -> dict:
    """Device busy time and wall time of one compute() under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        t0 = time.perf_counter()
        metric.compute()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"wall_us": wall_us, **split_profile(prof)}


def detection_phase(torch, mt, kernels_mod):
    """Phase 3b: the COCO-size detection path, kernel against plain."""
    t0 = time.perf_counter()
    stream, n_instances = coco_stream(torch)
    print(f"phase 3b: COCO-size stream generated on the card in {time.perf_counter() - t0:.1f} s: {COCO_IMAGES} images,"
          f" {n_instances} ground truths ({n_instances / COCO_IMAGES:.2f} per image), {COCO_DETS} detections each,"
          f" {len(stream)} updates of up to {COCO_BATCH}")
    kernels_mod.reset_launch_counts()
    metric, results, update_s, compute_s, peak_extra = run_coco(torch, mt, stream, plain=False)
    launches = kernels_mod.launch_counts()
    n_chunks = math.ceil(COCO_IMAGES / 256)
    print(f"  kernel run: {len(stream)} updates in {update_s:.2f} s with synchronisation forbidden;"
          f" compute {compute_s:.2f} s; launches {launches}")
    for kname in DETECTION_KERNELS:
        check(launches[kname] == n_chunks, f"{kname} launched {launches[kname]} times for {n_chunks} chunks of 256 images")
    _, results_plain, _, compute_plain_s, _ = run_coco(torch, mt, stream, plain=True)
    check(set(results) == set(results_plain), "result keys differ from the plain-kernel run")
    for key, value in results.items():
        check(bool(torch.isfinite(value).all()), f"result {key} is not finite")
        check(value.dtype == torch.float32 and torch.equal(value, results_plain[key]),
              f"result {key} differs from the plain-kernel run")
    check(results["map_per_class"].shape == (COCO_CLASSES,), f"map_per_class has shape {tuple(results['map_per_class'].shape)}")
    check(0.0 < float(results["map"]) < 1.0, f"map {float(results['map'])} is not in (0, 1)")
    for key in ("map_small", "map_medium", "map_large"):
        check(float(results[key]) >= 0.0, f"{key} is {float(results[key])}: an area range is empty")
    state_bytes = sum(v.data.numel() * v.data.element_size() for v in metric.get_state().values())
    print(f"  results bitwise equal to the plain-kernel run (compute {compute_plain_s:.2f} s there): "
          + ", ".join(f"{k}={float(v):.6f}" for k, v in results.items() if v.ndim == 0))
    print(f"  state: {state_bytes / 1e6:.1f} MB at capacity {metric.det_counts.capacity} images;"
          f" compute's peak device memory above the state: {peak_extra / 1e6:.1f} MB")
    check_map_docstring_example(torch, mt)
    return metric, stream, launches


def detection_timing(torch, mt, im, metric, stream, name, smi):
    """Phase 4 for the detection path: kernels at the COCO chunk shape, one
    update, and compute split into device evaluation and host curves."""
    (det_sorted, gt, det_counts, gt_counts), match_args = chunk_inputs(torch, metric, im)
    b, d, _ = det_sorted.shape
    g = gt.shape[1]
    iou_ms = time_ms(torch, lambda: im.pairwise_iou(det_sorted, gt, det_counts, gt_counts))
    iou_plain_ms = time_ms(torch, lambda: im.pairwise_iou(det_sorted, gt, det_counts, gt_counts, plain=True))
    # the step as evaluate_matches formed it while the mask was separate: the
    # IoU of every pair, the (B, D, G) valid-pair mask, torch.where
    arange_d, arange_g = torch.arange(d, device="cuda"), torch.arange(g, device="cuda")

    def unfused_step():
        valid = (arange_d[None, :] < det_counts[:, None])[:, :, None] & (arange_g[None, :] < gt_counts[:, None])[:, None, :]
        return torch.where(valid, im.pairwise_iou(det_sorted, gt), 0.0)

    check(torch.equal(unfused_step(), im.pairwise_iou(det_sorted, gt, det_counts, gt_counts)),
          "the fused IoU differs from the IoU-then-mask step")
    unfused_ms = time_ms(torch, unfused_step)
    count_free_ms = time_ms(torch, lambda: im.pairwise_iou(det_sorted, gt))
    # boxes and counts read once, the IoU written once
    iou_bound_ms, iou_by = bound(b * (d + g) * 16 + b * 8 + b * d * g * 4, 12 * b * d * g, name)
    ious, _, _, _, _, gt_ignore, thresholds = match_args
    a, t = gt_ignore.shape[1], thresholds.numel()
    match_ms = time_ms(torch, lambda: im.greedy_match(*match_args))
    match_plain_ms = time_ms(torch, lambda: im.greedy_match(*match_args, plain=True), warmup=2, reps=20)
    # each input read once, the flags written once; a multiply and a compare per (b, a, t, d, g)
    match_bytes = b * d * g * 4 + b * d * (1 + 4) + b * g * (4 + 1) + b * a * g + t * 4 + b * a * t * d
    match_bound_ms, match_by = bound(match_bytes, 2 * b * a * t * d * g, name)
    iou_prof = profile_window(torch, lambda: im.pairwise_iou(det_sorted, gt, det_counts, gt_counts), reps=20)
    unfused_prof = profile_window(torch, unfused_step, reps=20)
    match_prof = profile_window(torch, lambda: im.greedy_match(*match_args), reps=20)
    report_profile("pairwise_iou wrapper, with counts", iou_prof)
    report_profile("IoU, then mask and torch.where", unfused_prof)
    report_profile("greedy_match wrapper", match_prof)
    iou_device_us = sum(us for k, us in iou_prof["per_launch_us"].items() if "pairwise_iou" in k) or None
    unfused_device_us = sum(unfused_prof["device_us"].values()) or None
    match_device_us = sum(us for k, us in match_prof["per_launch_us"].items() if "greedy_match" in k) or None
    # the matcher at G=64, the padded width of images with 33-64 ground truths
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    wide_args = match_case(torch, im, gen, b, a, t, d, 64)
    wide_ms = time_ms(torch, lambda: im.greedy_match(*wide_args))
    wide_prof = profile_window(torch, lambda: im.greedy_match(*wide_args), reps=20)
    wide_device_us = sum(us for k, us in wide_prof["per_launch_us"].items() if "greedy_match" in k) or None
    wide_bytes = b * d * 64 * 4 + b * d * (1 + 4) + b * 64 * (4 + 1) + b * a * 64 + t * 4 + b * a * t * d
    wide_bound_ms, wide_by = bound(wide_bytes, 2 * b * a * t * d * 64, name)

    fresh = mt.MeanAveragePrecision(class_metrics=True)
    times, host = [], []
    for i, (preds, targets) in enumerate(stream[:80]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        fresh.update(preds, targets)
        end.record()
        h1 = time.perf_counter()
        end.synchronize()
        if i >= 10:
            times.append(start.elapsed_time(end))
            host.append((h1 - h0) * 1e3)
    update_ms, update_host_ms = statistics.median(times), statistics.median(host)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    classes = metric._get_classes()
    evals = metric._evaluate_images(classes)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metric._calculate(classes, evals)
    calc_s = time.perf_counter() - t0
    prof = profile_compute(torch, metric)
    busy = sum(prof["device_us"].values())
    idle = max(0.0, 1.0 - busy / prof["wall_us"]) if prof["device_us"] else None
    print(f"phase 4 detection ({smi}): pairwise_iou with counts at {(b, d, g)} {iou_ms * 1e3:.1f} us/call"
          f" (device {iou_device_us} us), plain {iou_plain_ms * 1e3:.1f} us, bound {iou_bound_ms * 1e3:.2f} us ({iou_by});"
          f" without counts {count_free_ms * 1e3:.1f} us/call; IoU then mask and where {unfused_ms * 1e3:.1f} us/call"
          f" (device {unfused_device_us} us in all);"
          f" greedy_match {match_ms * 1e3:.1f} us/call (device {match_device_us} us), plain {match_plain_ms * 1e3:.1f} us,"
          f" bound {match_bound_ms * 1e3:.2f} us ({match_by}); at G=64 {wide_ms * 1e3:.1f} us/call (device"
          f" {wide_device_us} us), bound {wide_bound_ms * 1e3:.2f} us ({wide_by})")
    print(f"  update of {COCO_BATCH} images: {update_ms * 1e3:.1f} us by events, {update_host_ms * 1e3:.1f} us of host time;"
          f" compute: device evaluation {eval_s:.3f} s + host curves {calc_s:.3f} s;"
          f" profiled compute {prof['wall_us'] / 1e6:.3f} s, device busy {busy / 1e3:.1f} ms,"
          f" idle share {'not measured' if idle is None else f'{idle:.4f}'}")
    for key, us in sorted(prof["device_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device {us:11.1f} us  {key[:110]}")
    shapes = {"pairwise_iou": [b, d, g], "greedy_match": [b, a, t, d, g]}
    return {
        "pairwise_iou": dict(ms=iou_ms, plain_ms=iou_plain_ms, bound_ms=iou_bound_ms, bound_by=iou_by,
                             device_us=iou_device_us, shape=shapes["pairwise_iou"], count_free_ms=count_free_ms,
                             unfused_step_ms=unfused_ms, unfused_step_device_us=unfused_device_us),
        "greedy_match": dict(ms=match_ms, plain_ms=match_plain_ms, bound_ms=match_bound_ms, bound_by=match_by,
                             device_us=match_device_us, shape=shapes["greedy_match"],
                             g64=dict(ms=wide_ms, device_us=wide_device_us, bound_ms=wide_bound_ms, bound_by=wide_by,
                                      shape=[b, a, t, d, 64])),
        "map_update_us": update_ms * 1e3,
        "map_update_host_us": update_host_ms * 1e3,
        "map_compute_eval_s": eval_s,
        "map_compute_calc_s": calc_s,
        "map_compute_idle_share": idle,
    }


# --------------------------------------------------------------------------- #
# phase 2c: the maxsim kernel against its plain version
# --------------------------------------------------------------------------- #
def unit_vectors(torch, gen, *shape):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def maxsim_cases(torch):
    """(label, preds (B, L, P, D), target (B, L, R, D)) of unit vectors on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [(f"random {b}x{l}x{p}x{r}x{d}", unit_vectors(torch, gen, b, l, p, d), unit_vectors(torch, gen, b, l, r, d))
             for b, l, p, r, d in ((3, 1, 7, 5, 16), (4, 3, 33, 65, 48), (2, 25, 40, 37, 64), (5, 1, 129, 257, 7),
                                   (64, 1, 512, 512, 1024))]
    pe, te = unit_vectors(torch, gen, 3, 1, 7, 16), unit_vectors(torch, gen, 3, 1, 5, 16)
    pe[1, 0, 2, 5] = float("nan")
    te[2, 0, 4, 0] = float("nan")
    cases.append(("NaN in both operands", pe, te))
    pe, te = unit_vectors(torch, gen, 4, 1, 130, 40), unit_vectors(torch, gen, 4, 1, 70, 40)
    pe[:, :, 0], pe[:, :, 100:], te[:, :, -1] = 0.0, 0.0, 0.0
    pe[3], te[3] = 0.0, 0.0
    cases.append(("all-zero rows and an all-zero pair", pe, te))
    flat = torch.zeros(2 * 20 * 32 + 1, device="cuda")
    flat[1:] = unit_vectors(torch, gen, 2, 1, 20, 32).reshape(-1)
    cases.append(("rows not 16-byte aligned", flat[1:].view(2, 1, 20, 32), unit_vectors(torch, gen, 2, 1, 9, 32)))
    # every product positive and each row's maximum its own norm, 1: the sum a
    # truncating accumulator would pull furthest below the bound
    same = unit_vectors(torch, gen, 16, 1, 200, 1024).abs()
    cases.append(("identical all-positive unit vectors, D=1024", same, same.clone()))
    # every similarity negative, P and R not multiples of the 128 tile: a
    # zero-filled row or column that leaked into a maximum would show as 0
    cases.append(("every maximum negative, P=130 R=200", unit_vectors(torch, gen, 3, 1, 130, 64).abs(),
                  -unit_vectors(torch, gen, 3, 1, 200, 64).abs()))
    return cases


def maxsim_errors(torch, got, want):
    """Largest absolute difference over non-NaN entries; NaN where the other has none is a failure."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(torch.isnan(g), torch.isnan(w)):
            return math.inf
    return max(float(torch.nan_to_num(g - w, nan=0.0).abs().max()) for g, w in zip(got, want))


def check_maxsim_pair(torch, cm, label, pe, te, gen):
    """maxsim against its plain version and, on the first 8 pairs, a float64
    recomputation; P/R/F1 through both against each other. Returns the
    maxima and the larger error."""
    got = cm.maxsim(pe, te)
    torch.cuda.synchronize()
    want = cm.maxsim(pe, te, plain=True)
    torch.cuda.synchronize()
    err = maxsim_errors(torch, got, want)
    check(err <= MAXSIM_ATOL, f"maxsim [{label}]: kernel differs from plain by {err}")
    sim64 = torch.einsum("blpd,blrd->blpr", pe[:8].double(), te[:8].double())
    err64 = maxsim_errors(torch, [g[:8].double() for g in got], [sim64.amax(dim=3), sim64.amax(dim=2)])
    check(err64 <= MAXSIM_ATOL, f"maxsim [{label}]: kernel differs from float64 by {err64}")
    b, _, p, _ = pe.shape
    pw = 0.1 + 0.9 * torch.rand((b, p), generator=gen, device="cuda")
    tw = 0.1 + 0.9 * torch.rand((b, te.shape[2]), generator=gen, device="cuda")
    for g, w, name in zip(cm.pairwise_cosine_pr(pe, te, pw, tw), cm._pr_f1_reference(pe, te, pw, tw),
                          ("precision", "recall", "f1")):
        check(torch.allclose(g, w, rtol=PRF_RTOL, atol=0.0, equal_nan=True), f"maxsim [{label}]: {name} outside rtol {PRF_RTOL}")
    return got, max(err, err64)


def check_maxsim_kernel(torch, kernels_mod, cm):
    """The 3xTF32 kernel on every case: operands TMA describes as they are,
    and padded copies of the others (D = 7, a base not 16-byte aligned).
    Returns the worst error."""
    kernel = kernels_mod.KERNELS["maxsim_tf32x3"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for label, pe, te in maxsim_cases(torch):
        operands = "as they are" if cm._tma_route(pe, te) else "padded copies"
        before = kernel.launches
        got, err = check_maxsim_pair(torch, cm, label, pe, te, gen)
        check(kernel.launches - before == 2, f"maxsim [{label}]: launches {kernel.launches - before} for 2 calls")
        worst = max(worst, err)
        line = f"max abs err {err:.3g}"
        if label.startswith("identical"):
            off = max(float((g - 1.0).abs().max()) for g in got)
            check(off <= MAXSIM_ATOL, f"maxsim [{label}]: identical rows off 1.0 by {off}")
            line += f", off 1.0 by {off:.3g}"
        print(f"  maxsim [{label}] preds {tuple(pe.shape)} target {tuple(te.shape)}: operands {operands}, {line}"
              f" (bound {MAXSIM_ATOL}); P/R/F1 within rtol {PRF_RTOL}")
    return worst


# --------------------------------------------------------------------------- #
# phase 3c: BERTScore at roberta-large width
# --------------------------------------------------------------------------- #
def roberta_large_encoder(torch, seed: int):
    """An encoder with roberta-large's widths, post-LN, GELU, attention that
    honours the mask; float32 weights normal(0, 0.02) from a seed (the
    user's model of the own-model route: plain matmul and softmax)."""
    nn, cfg = torch.nn, ROBERTA_LARGE
    hidden, heads = cfg["hidden"], cfg["heads"]

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.out = nn.Linear(hidden, hidden)
            self.ln1 = nn.LayerNorm(hidden, eps=cfg["eps"])
            self.ffn_in = nn.Linear(hidden, cfg["ffn"])
            self.ffn_out = nn.Linear(cfg["ffn"], hidden)
            self.ln2 = nn.LayerNorm(hidden, eps=cfg["eps"])

        def forward(self, x, bias):
            b, s, _ = x.shape
            q, k, v = self.qkv(x).view(b, s, 3, heads, hidden // heads).permute(2, 0, 3, 1, 4)
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hidden // heads) + bias
            ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(b, s, hidden)
            x = self.ln1(x + self.out(ctx))
            return self.ln2(x + self.ffn_out(torch.nn.functional.gelu(self.ffn_in(x))))

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(cfg["vocab"], hidden)
            self.position = nn.Embedding(cfg["positions"], hidden)
            self.token_type = nn.Parameter(torch.zeros(hidden))
            self.ln = nn.LayerNorm(hidden, eps=cfg["eps"])
            self.layers = nn.ModuleList(Layer() for _ in range(cfg["layers"]))

        def forward(self, input_ids, attention_mask):
            mask = attention_mask.to(torch.int64)
            positions = torch.cumsum(mask, dim=1) * mask + cfg["pad"]  # roberta's position ids
            x = self.ln(self.word(input_ids) + self.position(positions) + self.token_type)
            bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min
            for layer in self.layers:
                x = layer(x, bias)
            return x

    with torch.device("cuda"):
        encoder = Encoder()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, param in encoder.named_parameters():
            if name.endswith("weight") and param.ndim == 2:
                param.normal_(0.0, 0.02, generator=gen)
            elif name.startswith("token_type"):
                param.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("bias"):
                param.zero_()
            else:
                param.fill_(1.0)  # LayerNorm scales
        encoder.word.weight[cfg["pad"]] = 0.0
    return encoder.eval()


class IdTokenizer:
    """A sentence is its content token ids, space-separated; adds <s> and
    </s> and pads with <pad> to max_length, taking transformers' keywords."""

    def __call__(self, text, padding="max_length", max_length=512, truncation=True, return_tensors="np"):
        import numpy as np

        cfg = ROBERTA_LARGE
        ids = np.full((len(text), max_length), cfg["pad"], dtype=np.int64)
        mask = np.zeros((len(text), max_length), dtype=np.int64)
        for row, sentence in enumerate(text):
            tokens = [cfg["bos"]] + [int(t) for t in sentence.split()][: max_length - 2] + [cfg["eos"]]
            ids[row, : len(tokens)] = tokens
            mask[row, : len(tokens)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def wmt_sized_pairs(torch):
    """2,000 (pred, target) sentence pairs made on the card from a seed:
    targets of 8-80 content tokens, preds with 30% of them (and at least the
    first) replaced by other random ids; the first BERT_CONTROLS pairs are
    identical."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    n, longest, vocab = BERT_PAIRS, 80, ROBERTA_LARGE["vocab"]
    lengths = torch.randint(8, longest + 1, (n,), generator=gen, device="cuda")
    target = torch.randint(3, vocab, (n, longest), generator=gen, device="cuda")  # ids 0-2 are special
    replace = torch.rand((n, longest), generator=gen, device="cuda") < 0.3
    replace[:, 0] = True  # every pair but the controls differs
    replace[:BERT_CONTROLS] = False
    shift = torch.randint(1, vocab - 3, (n, longest), generator=gen, device="cuda")  # a different content id
    preds = torch.where(replace, 3 + (target - 3 + shift) % (vocab - 3), target)
    lengths, target, preds = lengths.tolist(), target.tolist(), preds.tolist()  # set-up: sentences are host strings
    return ([" ".join(map(str, preds[i][: lengths[i]])) for i in range(n)],
            [" ".join(map(str, target[i][: lengths[i]])) for i in range(n)])


def run_bert(torch, mt, bert_ops, encoder, preds, target):
    """The main text path: BERTScore updated 64 pairs at a time, then one
    compute under the profiler. CUDA events around the encoder, the
    embedding finalisation and the matching split the compute without
    synchronising; the matching's inputs are kept for the checks."""
    from torch.profiler import ProfilerActivity, profile

    spans = {"encoder": [], "finalize": [], "matching": []}
    captured = {}

    def timed(label, fn, keep=False):
        def wrapper(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[label].append((start, end))
            if keep:
                captured["args"] = args
            return out
        return wrapper

    metric = mt.BERTScore(model=encoder, user_tokenizer=IdTokenizer(), max_length=BERT_MAX_LEN,
                          batch_size=BERT_BATCH, idf=False,
                          user_forward_fn=timed("encoder", lambda model, batch: model(batch["input_ids"], batch["attention_mask"])))
    t0 = time.perf_counter()
    for start in range(0, len(preds), BERT_BATCH):
        metric.update(preds[start:start + BERT_BATCH], target[start:start + BERT_BATCH])
    update_s = time.perf_counter() - t0
    saved = bert_ops._finalize_embeddings, bert_ops._precision_recall_f1
    bert_ops._finalize_embeddings = timed("finalize", saved[0])
    bert_ops._precision_recall_f1 = timed("matching", saved[1], keep=True)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            result = metric.compute()
            torch.cuda.synchronize()
            compute_s = time.perf_counter() - t0
    finally:
        bert_ops._finalize_embeddings, bert_ops._precision_recall_f1 = saved
    split_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    return metric, result, update_s, compute_s, split_ms, split_profile(prof)["device_us"], captured["args"]


def bert_docstring_metric(torch, mt):
    """BERTScore's docstring example on the card, updated."""
    import numpy as np

    vocab = ["[CLS]", "[SEP]", "[PAD]", "hello", "there", "master", "kenobi"]
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(len(vocab), 8)).astype(np.float32)).cuda()

    def tokenizer(sentences):
        ids = np.full((len(sentences), 6), vocab.index("[PAD]"), dtype=np.int32)
        mask = np.zeros((len(sentences), 6), dtype=np.int32)
        for row, sent in enumerate(sentences):
            for col, word in enumerate(["[CLS]"] + sent.split()[:4] + ["[SEP]"]):
                ids[row, col] = vocab.index(word)
                mask[row, col] = 1
        return {"input_ids": ids, "attention_mask": mask}

    score = mt.BERTScore(model=object(), user_tokenizer=tokenizer, max_length=6,
                         user_forward_fn=lambda model, batch: table[batch["input_ids"]])
    score.update(["hello there", "master kenobi"], ["hello there", "hello kenobi"])
    return score


def check_bert_docstring_example(torch, mt):
    got = {key: [round(float(v), 4) for v in values] for key, values in bert_docstring_metric(torch, mt).compute().items()}
    want = {"precision": [1.0, 0.5], "recall": [1.0, 0.8545], "f1": [1.0, 0.6309]}
    check(got == want, f"BERTScore docstring example gives {got}, documented {want}")
    print(f"  docstring example on the card: {got}, as documented")


def text_phase(torch, mt, kernels_mod, cm, bert_ops):
    """Phase 3c: BERTScore at roberta-large width over 2,000 pairs, the kernel
    held against its plain version on the compute's own embeddings."""
    t0 = time.perf_counter()
    encoder = roberta_large_encoder(torch, SEED + 9)
    preds, target = wmt_sized_pairs(torch)
    n_params = sum(p.numel() for p in encoder.parameters())
    print(f"phase 3c: encoder of roberta-large width ({n_params / 1e6:.1f} M float32 parameters) and {len(preds)}"
          f" pairs made on the card in {time.perf_counter() - t0:.1f} s")
    kernels_mod.reset_launch_counts()
    metric, result, update_s, compute_s, split_ms, device_us, args = run_bert(torch, mt, bert_ops, encoder, preds, target)
    launches = kernels_mod.launch_counts()
    pe, te, pw, tw = args
    busy_us = sum(device_us.values())
    idle = max(0.0, 1.0 - busy_us / (compute_s * 1e6)) if device_us else None
    print(f"  {len(metric.preds_input_ids)} updates in {update_s:.2f} s; compute {compute_s:.2f} s under the profiler"
          f" (encoder {split_ms['encoder']:.1f} ms, finalize {split_ms['finalize']:.1f} ms,"
          f" matching {split_ms['matching']:.1f} ms by events), device busy {busy_us / 1e3:.1f} ms,"
          f" idle share {'not measured' if idle is None else f'{idle:.4f}'}; launches {launches}")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device {us:12.1f} us  {key[:110]}")
    check(launches["maxsim_tf32x3"] == 1, f"the compute launched maxsim_tf32x3 {launches['maxsim_tf32x3']} times, expected once")
    check(tuple(pe.shape) == (BERT_PAIRS, 1, BERT_MAX_LEN, ROBERTA_LARGE["hidden"]) and pe.shape == te.shape,
          f"matching ran at {tuple(pe.shape)} x {tuple(te.shape)}")
    scores = {key: torch.tensor(result[key], dtype=torch.float64) for key in ("precision", "recall", "f1")}
    for key, value in scores.items():
        check(value.shape == (BERT_PAIRS,) and bool(torch.isfinite(value).all()), f"{key} is not {BERT_PAIRS} finite values")
        control = float((value[:BERT_CONTROLS] - 1.0).abs().max())
        check(control <= MAXSIM_ATOL, f"identical pairs score {key} off 1.0 by {control}")
    noisy = scores["f1"][BERT_CONTROLS:]
    check(bool(((noisy > 0) & (noisy < 1)).all()),
          f"a pair that differs has F1 outside (0, 1): F1 from {float(noisy.min())!r} to {float(noisy.max())!r}")

    # the kernel against its plain version on this compute's embeddings
    check(cm._tma_route(pe, te), "the compute's embeddings need a padded copy for TMA")
    got = cm.maxsim(pe, te)
    want = cm.maxsim(pe, te, plain=True)
    err = maxsim_errors(torch, got, want)
    check(err <= MAXSIM_ATOL, f"maxsim on the compute's embeddings differs from plain by {err}")
    sim64 = torch.einsum("blpd,blrd->blpr", pe[:8].double(), te[:8].double())
    err64 = maxsim_errors(torch, [g[:8].double() for g in got], [sim64.amax(dim=3), sim64.amax(dim=2)])
    check(err64 <= MAXSIM_ATOL, f"maxsim on the compute's embeddings differs from float64 by {err64}")
    del got, want, sim64
    for (key, value), ref in zip(scores.items(), cm._pr_f1_reference(pe, te, pw, tw)):
        check(torch.allclose(value, ref.double().cpu(), rtol=PRF_RTOL, atol=0.0), f"{key} outside rtol {PRF_RTOL} of the plain version")
    print(f"  maxsim on the compute's {tuple(pe.shape)} embeddings: max abs err {err:.3g} against plain,"
          f" {err64:.3g} against float64 (first 8 pairs); P/R/F1 within rtol {PRF_RTOL}; identical pairs score 1;"
          f" mean P {float(scores['precision'].mean()):.6f}, R {float(scores['recall'].mean()):.6f},"
          f" F1 {float(scores['f1'].mean()):.6f} (pairs that differ: F1 {float(noisy.min()):.6f} to {float(noisy.max()):.6f})")
    check_bert_docstring_example(torch, mt)
    return {"launches": launches, "max_abs_err": max(err, err64), "embeddings": (pe, te), "update_s": update_s,
            "compute_s": compute_s, "split_ms": split_ms, "device_busy_ms": busy_us / 1e3, "idle_share": idle,
            "encoder": encoder, "pairs": (preds, target)}


def text_timing(torch, cm, pe, te, name, smi):
    """Phase 4 for the text path: maxsim at the full and at one 64-pair
    chunk's shape, beside its plain version, its bound (3xTF32 at the TF32
    tensor-core peak) and bmm + amax."""
    out = {}
    for label, (p_emb, t_emb) in (("full", (pe, te)), ("chunk", (pe[:BERT_BATCH], te[:BERT_BATCH]))):
        b, l, p, d = p_emb.shape
        r = t_emb.shape[2]

        def library(p_emb=p_emb, t_emb=t_emb, b=b, l=l, p=p, r=r, d=d):
            sim = torch.bmm(p_emb.view(b * l, p, d), t_emb.view(b * l, r, d).transpose(1, 2))
            return sim.amax(dim=2), sim.amax(dim=1)

        reps = 30
        ms = time_ms(torch, lambda: cm.maxsim(p_emb, t_emb), reps=reps)
        plain_ms = time_ms(torch, lambda: cm.maxsim(p_emb, t_emb, plain=True), reps=reps)
        library_ms = time_ms(torch, library, reps=reps)
        prof = profile_window(torch, lambda: cm.maxsim(p_emb, t_emb), reps=5 if label == "full" else 20)
        device_us = sum(us for k, us in prof["per_launch_us"].items() if "maxsim" in k or "decode_kernel" in k) or None
        bytes_moved = (b * l * (p + r) * d + b * l * (p + r)) * 4  # both operands read, both maxima written
        bound_ms, bound_by = bound(bytes_moved, 3 * 2 * b * l * p * r * d, name, tf32=True)
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                          device_us=device_us, shape=[b, l, p, r, d])
        print(f"phase 4 text ({smi}): maxsim at {(b, l, p, r, d)}: {ms * 1e3:.1f} us/call (device {device_us} us),"
              f" plain {plain_ms * 1e3:.1f} us, bmm + amax {library_ms * 1e3:.1f} us,"
              f" bound {bound_ms * 1e3:.1f} us ({bound_by}, 3xTF32 at the TF32 peak)")
        report_profile(f"maxsim wrapper, {label}", prof)
    return out

# --------------------------------------------------------------------------- #
# phase 5: sync on the card, in a world of one rank
# --------------------------------------------------------------------------- #
def entry_twins(torch, entry_mod, kernels_mod):
    """5(b) and (c): entry() and dryrun_multichip(1) on the card against the
    same calls on the CPU port. Each makes and ends its own world."""
    fn, args = entry_mod.entry()
    states, results = fn(*args)
    fn_cpu, args_cpu = entry_mod.entry(device="cpu")
    states_cpu, results_cpu = fn_cpu(*args_cpu)
    for leader, state in states_cpu.items():
        for key, value in state.items():
            got = states[leader][key]
            check(got.is_cuda and got.dtype == value.dtype == torch.int32 and torch.equal(got.cpu(), value),
                  f"entry() state {leader}.{key} differs from the CPU port's")
    for key, value in results_cpu.items():
        check(torch.equal(results[key].cpu(), value), f"entry() result {key} differs from the CPU port's")
    print("phase 5b: entry() on the card bitwise equal to the CPU port (int32 states and results): "
          + ", ".join(f"{k}={float(v):.6f}" for k, v in results.items()))

    kernels_mod.reset_launch_counts()
    out = entry_mod.dryrun_multichip(1)
    launches = kernels_mod.launch_counts()
    check(launches["binned_counts"] == 1, f"the dry-run launched binned_counts {launches['binned_counts']} times, expected once")
    out_cpu = entry_mod.dryrun_multichip(1, device="cpu")
    for leader, state in out_cpu["states"].items():
        for key, value in state.items():
            got = out["states"][leader][key]
            check(got.dtype == torch.int32 and torch.equal(got.cpu(), value), f"dry-run state {leader}.{key} differs from the CPU run's")
    for key, value in out_cpu["seq_state"].items():
        check(torch.equal(out["seq_state"][key].cpu(), value), f"dry-run sequence state {key} differs from the CPU run's")
    errs = {key: float((out[key].cpu() - out_cpu[key]).abs().max()) for key in ("loss", "w_new", "ap")}
    for key, err in errs.items():
        check(err <= 1e-6, f"dry-run {key} differs from the CPU run's by {err}")
    print(f"phase 5c: dryrun_multichip(1) on the card: loss {float(out['loss']):.6f}, mean AP {float(out['ap'].mean()):.6f},"
          f" sequence accuracy {float(out['seq_acc']):.6f}; int32 states bitwise equal to the CPU run, max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; launches {launches}")
    return launches["binned_counts"]


def check_moves(torch, mt, kernels_mod, logits, probs, target):
    """5(e): every binned class built on one device and moved to the other
    counts bit for bit as a twin built there."""
    makers = {
        "BinnedPrecisionRecallCurve": lambda d: mt.BinnedPrecisionRecallCurve(num_classes=N_CLASSES, device=d),
        "BinnedAveragePrecision": lambda d: mt.BinnedAveragePrecision(num_classes=N_CLASSES, device=d),
        "BinnedRecallAtFixedPrecision": lambda d: mt.BinnedRecallAtFixedPrecision(num_classes=N_CLASSES, min_precision=0.5, device=d),
    }
    leaves = torch.utils._pytree.tree_leaves
    for cls, make in makers.items():
        for src, dst in (("cpu", "cuda"), ("cuda", "cpu")):
            moved, twin = make(src).to(dst), make(dst)
            inputs = (probs, target) if dst == "cuda" else (probs.cpu(), target.cpu())
            kernels_mod.reset_launch_counts()
            moved.update(*inputs)
            launched = kernels_mod.launch_counts()["binned_counts"]
            check(launched == (1 if dst == "cuda" else 0), f"{cls} moved {src} -> {dst} launched binned_counts {launched} times")
            twin.update(*inputs)
            for key, value in twin.get_state().items():
                check(torch.equal(moved.get_state()[key], value), f"{cls} moved {src} -> {dst}: state {key} differs from a twin built there")
            got, want = leaves(moved.compute()), leaves(twin.compute())
            check(len(got) == len(want) and all(g.device == w.device and torch.equal(g, w) for g, w in zip(got, want)),
                  f"{cls} moved {src} -> {dst}: compute differs from a twin built there")
    print(f"phase 5e: the three binned classes moved CPU -> CUDA and CUDA -> CPU count and compute bit for bit as twins built in place")


def sync_phase(torch, mt, kernels_mod, sync, reference, coco, text, smi):
    """5(a), (d), (f) in a world of one NCCL rank, under sync_axes so that
    the collectives run: phase 3's stream with compute synced, mAP and
    BERTScore at reduced depth synced against unsynced, and the cost of the
    sync."""
    import torch.distributed as dist

    _, states_ref, results_ref, ap_ref = reference
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        world = dist.group.WORLD
        coll, binned = build_slice(mt)
        kernels_mod.reset_launch_counts()
        n_batches = 0
        for logits, probs, target in batches(torch):
            coll.update(logits, target)
            binned.update(probs, target)
            n_batches += 1
        launches = kernels_mod.launch_counts()
        check(launches["binned_counts"] == n_batches, f"binned_counts launched {launches['binned_counts']} times for {n_batches} updates")
        leaders = [group[0] for group in coll.compute_groups.values()]
        expected = {"all_reduce": len(leaders) + 1}  # one (sum, int32) bucket per group, one (sum, float32) bucket
        with sync.count_collectives() as box, sync.sync_axes(world):
            results = coll.compute()
            ap = torch.stack(binned.compute())
        check(box["by_kind"] == expected, f"synced compute ran {box['by_kind']}, expected {expected}")
        for key, value in results_ref.items():
            check(torch.equal(results[key], value), f"synced result {key} differs from phase 3")
        check(torch.equal(ap, ap_ref), "synced binned AP differs from phase 3")
        synced = {f"{k}.{s}": v for k, st in coll.sync_states({k: coll[k].get_state() for k in leaders}, world).items()
                  for s, v in st.items()}
        synced.update({f"binned.{s}": v for s, v in binned.sync_states(binned.get_state(), world).items()})
        for key, value in synced.items():
            check(value.dtype == states_ref[key].dtype and torch.equal(value, states_ref[key]), f"synced state {key} differs from phase 3")
        for key, value in states_ref.items():
            mine = coll[key.split(".")[0]].get_state() if not key.startswith("binned.") else binned.get_state()
            check(torch.equal(mine[key.split(".")[1]], value), f"local state {key} after the synced compute differs from phase 3")
        print(f"phase 5a: {n_batches} updates, B1 launched {launches['binned_counts']} times; synced compute ran"
              f" {box['by_kind']} ({box['bytes']} bytes), expected {expected}: one all_reduce per (reduction, dtype)"
              " bucket per compute group; results, synced and local states bitwise equal to phase 3")

        def compute_all():
            for m in (*coll.values(), binned):
                m._computed = None
            coll.compute()
            binned.compute()

        def compute_synced():
            with sync.sync_axes(world):
                compute_all()

        unsynced_ms = time_ms(torch, compute_all, warmup=3, reps=30)
        synced_ms = time_ms(torch, compute_synced, warmup=3, reps=30)
        unsynced_ms2 = time_ms(torch, compute_all, warmup=3, reps=30)
        synced_ms2 = time_ms(torch, compute_synced, warmup=3, reps=30)
        print(f"phase 5f ({smi}): ImageNet-size compute, median of 30 by events: unsynced {unsynced_ms:.3f}, {unsynced_ms2:.3f} ms;"
              f" synced (world of one, NCCL) {synced_ms:.3f}, {synced_ms2:.3f} ms")

        # mAP on 512 of phase 3b's images, BERTScore on its docstring example and one 64-pair chunk
        det = mt.MeanAveragePrecision(class_metrics=True)
        for preds, targets in coco[: 512 // COCO_BATCH]:
            det.update(preds, targets)
        bert_example = bert_docstring_metric(torch, mt)
        preds, target = text["pairs"]
        encoder = text["encoder"]
        bert_chunk = mt.BERTScore(model=encoder, user_tokenizer=IdTokenizer(), max_length=BERT_MAX_LEN, batch_size=BERT_BATCH,
                                  idf=False, user_forward_fn=lambda model, batch: model(batch["input_ids"], batch["attention_mask"]))
        bert_chunk.update(preds[:BERT_BATCH], target[:BERT_BATCH])
        expected_kinds = {"MeanAveragePrecision": {"all_gather": 3}, "BERTScore example": {"size_exchange": 1, "all_gather": 1},
                          "BERTScore chunk": {"size_exchange": 1, "all_gather": 1}}
        for label, metric in (("MeanAveragePrecision", det), ("BERTScore example", bert_example), ("BERTScore chunk", bert_chunk)):
            t0 = time.perf_counter()
            local = metric.compute()
            local_s = time.perf_counter() - t0
            metric._computed = None
            t0 = time.perf_counter()
            with sync.count_collectives() as box, sync.sync_axes(world):
                synced = metric.compute()
            synced_s = time.perf_counter() - t0
            check(box["by_kind"] == expected_kinds[label], f"{label}: synced compute ran {box['by_kind']}")
            got, want = torch.utils._pytree.tree_leaves(synced), torch.utils._pytree.tree_leaves(local)
            check(len(got) == len(want) and all(g == w if not torch.is_tensor(w) else torch.equal(g, w) for g, w in zip(got, want)),
                  f"{label}: synced compute differs from the unsynced one")
            print(f"phase 5d: {label} synced compute bitwise equal to the unsynced one ({box['by_kind']});"
                  f" {local_s:.2f} s unsynced, {synced_s:.2f} s synced")
    finally:
        dist.destroy_process_group()
    return {"launches": launches["binned_counts"], "unsynced_ms": [unsynced_ms, unsynced_ms2], "synced_ms": [synced_ms, synced_ms2],
            "collectives": expected}


# --------------------------------------------------------------------------- #
# phase 6: the compiled main path (CUDA-graph capture, B1 inside the graph)
# --------------------------------------------------------------------------- #
def expected_engine_counts(signatures) -> dict:
    """eager calls, captures and replays an engine makes for a sequence of
    signatures: the first call of each runs eager, the second probes and
    captures, every later one replays."""
    seen, out = {}, {"eager_calls": 0, "cache_misses": 0, "cache_hits": 0}
    for sig in signatures:
        count = seen.get(sig, 0)
        seen[sig] = count + 1
        out[("eager_calls", "cache_misses")[count] if count < 2 else "cache_hits"] += 1
    return out


def pow2_chunks(n: int):
    return [1 << bit for bit in reversed(range(n.bit_length())) if n >> bit & 1]


def check_engine(label: str, stats, want: dict, donated=None) -> None:
    got = {k: getattr(stats, k) for k in want}
    check(got == want, f"{label}: engine counts {got}, expected {want}")
    if donated is not None:
        check(stats.donated_calls == donated, f"{label}: {stats.donated_calls} in-place calls, expected {donated}")
    check(not stats.fallback_reasons, f"{label}: fell back to eager: {stats.fallback_reasons}")


def compiled_slice(torch, mt, kernels_mod, stream, reference, buckets: bool) -> dict:
    """6(a)-(e): the ImageNet-size stream through the engines at their
    defaults (or with batch_buckets=True on every metric), against phase 3's
    eager run. The steady-state steps run under
    torch.cuda.set_sync_debug_mode("error")."""
    _, states_ref, results_ref, ap_ref = reference
    coll, binned = build_slice(mt, compiled=True, buckets=buckets)
    sizes = [int(target.shape[0]) for _, _, target in stream]
    steady = range(2, len(stream) - 1)  # past the warmup and the capture, before the ragged batch
    kernels_mod.reset_launch_counts()
    mem = []
    for i, (logits, probs, target) in enumerate(stream):
        if i >= steady.start:  # before each steady step, and after the last one
            mem.append(torch.cuda.memory_allocated())
        if i in steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            coll.update(logits, target)
            binned.update(probs, target)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = kernels_mod.launch_counts()["binned_counts"]
    label = "batch_buckets=True" if buckets else "defaults"
    chunked = [c for n in sizes for c in pow2_chunks(n)] if buckets else sizes
    check(launches == len(chunked), f"6(c) [{label}]: B1 launched {launches} times for {len(chunked)} binned updates")

    computes = []
    for _ in range(3):  # warmup, capture, replay
        for m in (*coll.values(), binned):
            m._computed = None
        computes.append((coll.compute(), torch.stack(binned.compute())))
    torch.cuda.synchronize()
    for key, value in slice_states(coll, binned).items():
        check(value.dtype == states_ref[key].dtype and torch.equal(value, states_ref[key]),
              f"6(a) [{label}]: state {key} differs from phase 3's eager run")
    for n, (results, ap) in enumerate(computes):
        for key, value in results_ref.items():
            check(torch.equal(results[key], value), f"6(a) [{label}]: compute {n + 1} result {key} differs from phase 3")
        check(torch.equal(ap, ap_ref), f"6(a) [{label}]: compute {n + 1} binned AP differs from phase 3")

    stats = coll.engine_stats()
    view = stats["partition"]
    bview = binned.engine_stats()["partition"]
    update_path = "bucketed" if buckets else "fused"
    for name, info in view["update"].items():
        check(info["path"] == update_path, f"6(b) [{label}]: member {name} update path {info}")
    for name, info in view["compute"].items():
        check(info["path"] == "fused", f"6(b) [{label}]: member {name} compute path {info}")
    check(bview["update"]["path"] == update_path and bview["compute"]["path"] == "fused",
          f"6(b) [{label}]: binned partition {bview}")
    check(view["migrations"] == 0 and view["builds"] == 1, f"6(b) [{label}]: partition {view}")
    n_computes = expected_engine_counts([0, 0, 0])
    check_engine(f"6(b) [{label}] collection compute", stats["compute"], n_computes)
    check_engine(f"6(b) [{label}] binned compute", binned._compute_engine.stats, n_computes)
    if buckets:
        check(coll._update_engine is None, "6(b) [batch_buckets=True]: no fused collection update expected")
        masked = expected_engine_counts([1 << (n - 1).bit_length() for n in sizes])
        check_engine("6(b) [batch_buckets=True] acc", coll["acc"]._update_engine.stats,
                     dict(masked, bucketed_calls=len(sizes)), donated=masked["cache_hits"])
        # the group's members hold the leader's state: replays never write it in place
        check_engine("6(b) [batch_buckets=True] f1 (group leader)", coll["f1"]._update_engine.stats,
                     dict(masked, bucketed_calls=len(sizes)), donated=0)
        chunks = expected_engine_counts(chunked)
        check_engine("6(b) [batch_buckets=True] binned", binned._update_engine.stats,
                     dict(chunks, bucketed_calls=len(sizes)), donated=chunks["cache_hits"])
        engines = {"acc": coll["acc"]._update_engine, "f1": coll["f1"]._update_engine, "binned": binned._update_engine}
    else:
        plain = expected_engine_counts(sizes)
        check_engine("6(b) [defaults] collection update", stats["update"], plain, donated=plain["cache_hits"])
        check_engine("6(b) [defaults] binned update", binned._update_engine.stats, plain, donated=plain["cache_hits"])
        engines = {"collection": coll._update_engine, "binned": binned._update_engine}
        check(len(set(mem)) == 1, f"6(e): memory_allocated moved across the steady-state steps: {sorted(set(mem))}")
    for name, engine in engines.items():
        check(engine.broken is None and all(step.graph is not None for step in engine._steps.values()),
              f"6(b) [{label}]: {name} engine broken ({engine.broken}) or a step without a graph")
    replays = {name: e.stats.cache_hits for name, e in engines.items()}
    print(f"phase 6 [{label}]: {len(stream)} updates, states and 3 computes bitwise equal to phase 3's eager run;"
          f" B1 launched {launches} times for {len(chunked)} binned updates{' (pow2 chunks)' if buckets else ''};"
          f" replays {replays}; partition update {update_path}, compute fused, no fallback;"
          f" steady state with sync debug mode 'error'; memory_allocated {'flat at ' + str(mem[0]) + ' bytes' if len(set(mem)) == 1 else 'moved: ' + str(sorted(set(mem)))}")
    return {"launches": launches, "updates": len(chunked), "replays": replays, "memory_flat": len(set(mem)) == 1}


def idle_share(prof: dict):
    busy = sum(prof["device_us"].values())
    return None if not prof["device_us"] else max(0.0, 1.0 - busy / prof["wall_us"])


def slice_timing(torch, mt, stream, compiled: bool, show: bool = False) -> dict:
    """6(f): the update step by CUDA events (median of the steady state) and
    its device-idle share by the profiler, then the compute the same way;
    ``show`` prints the profiles."""
    coll, metric = build_slice(mt, compiled=compiled)
    for lg, pb, tg in stream[:3]:  # warmup and capture
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
    steps = iter(stream[3:-1])

    def one_step():
        lg, pb, tg = next(steps)
        coll.update(lg, tg)
        metric.update(pb, tg)

    step_prof = profile_window(torch, one_step, reps=10)
    label = "compiled" if compiled else "eager"
    if show:
        report_profile(f"6(f) {label} update step (collection + binned AP)", step_prof)

    def compute_all():
        for m in (*coll.values(), metric):
            m._computed = None
        coll.compute()
        metric.compute()

    compute_ms = time_ms(torch, compute_all, warmup=2, reps=20)
    compute_prof = profile_window(torch, compute_all, reps=5)
    if show:
        report_profile(f"6(f) {label} compute (collection + binned AP)", compute_prof)
    return {"step_us": statistics.median(step_times) * 1e3, "step_idle": idle_share(step_prof),
            "step_busy_us": sum(step_prof["device_us"].values()), "compute_ms": compute_ms,
            "compute_idle": idle_share(compute_prof), "compute_busy_us": sum(compute_prof["device_us"].values())}


def large_t_capture(torch, mt, kernels_mod) -> None:
    """6(g): a binned update at T = 20,000, past B1's shared-memory path, so
    that the kernel takes its per-stream workspace: captured and replayed,
    bitwise against eager."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    t = 20_000
    inputs = [(torch.rand((600, 3), generator=gen, device="cuda"), torch.randint(0, 3, (600,), generator=gen, device="cuda"))
              for _ in range(4)]
    compiled = mt.BinnedPrecisionRecallCurve(num_classes=3, thresholds=t)
    eager = mt.BinnedPrecisionRecallCurve(num_classes=3, thresholds=t, compiled_update=False, compiled_compute=False)
    check(kernels_mod.KERNELS["binned_counts"].lib().binned_counts_workspace_len(3, t) > 0,
          f"T={t} should take B1's workspace path")
    kernels_mod.reset_launch_counts()
    for preds, labels in inputs:
        compiled.update(preds, labels)
    launches = kernels_mod.launch_counts()["binned_counts"]
    for preds, labels in inputs:
        eager.update(preds, labels)
    torch.cuda.synchronize()
    engine = compiled._update_engine
    check_engine(f"6(g) T={t}", engine.stats, {"eager_calls": 1, "cache_misses": 1, "cache_hits": 2})
    check(all(step.graph is not None for step in engine._steps.values()), f"6(g): T={t} update not captured")
    check(launches == len(inputs), f"6(g): B1 launched {launches} times for {len(inputs)} updates")
    for key, value in eager.get_state().items():
        check(torch.equal(compiled.get_state()[key], value), f"6(g): T={t} state {key} differs from eager")
    print(f"phase 6(g): binned update at T={t} (B1's workspace path) captured and replayed twice,"
          f" states bitwise equal to eager, B1 launched {launches} times for {len(inputs)} updates")


def compiled_phase(torch, mt, kernels_mod, reference, smi) -> dict:
    stream = list(batches(torch))
    torch.cuda.synchronize()
    runs = {"defaults": compiled_slice(torch, mt, kernels_mod, stream, reference, buckets=False),
            "batch_buckets": compiled_slice(torch, mt, kernels_mod, stream, reference, buckets=True)}
    large_t_capture(torch, mt, kernels_mod)
    timings = {"eager": [], "compiled": []}
    for n, compiled in enumerate((False, True, True, False)):  # eager, compiled, compiled, eager in one run
        timings["compiled" if compiled else "eager"].append(slice_timing(torch, mt, stream, compiled, show=n < 2))
    for label, runs_ in timings.items():
        print(f"phase 6(f) ({smi}): {label}: update step "
              + ", ".join(f"{r['step_us']:.1f} us (idle {r['step_idle']}, device busy {r['step_busy_us']:.1f} us)" for r in runs_)
              + "; compute " + ", ".join(f"{r['compute_ms']:.3f} ms (idle {r['compute_idle']}, device busy"
                                         f" {r['compute_busy_us']:.1f} us)" for r in runs_))
    del stream
    return {"runs": runs, "timings": timings}



def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; this smoke run needs the card")
    try:
        import metrics_tpu_torch as mt
        from metrics_tpu_torch import entry as entry_mod
        from metrics_tpu_torch.ops import kernels as kernels_mod
        from metrics_tpu_torch.parallel import sync
        from metrics_tpu_torch.ops.classification import binned_counts as binned
        from metrics_tpu_torch.ops.kernels import cosine_matching as cm
        from metrics_tpu_torch.ops.kernels import iou_matching as im
        from metrics_tpu_torch.ops.text import bert as bert_ops
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
            if "registers" in line or "spill" in line or "wgmma" in line or "arning" in line:
                print(f"  ptxas {kernel.name}: {line.strip()}")
    worst_err = {
        "binned_counts": check_binned_kernel(torch, kernels_mod, binned),
        "pairwise_iou": check_iou_kernel(torch, kernels_mod, im),
        "greedy_match": check_match_kernel(torch, kernels_mod, im),
        "maxsim_tf32x3": check_maxsim_kernel(torch, kernels_mod, cm),
    }

    # ---- phase 3: the classification path, kernel against plain
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    n_batches, states, results, ap = run_slice(torch, mt, plain_counts=False)
    launches = kernels_mod.launch_counts()
    slice_s = time.perf_counter() - t0
    print(f"phase 3: {n_batches} batches of up to {BATCH} ({N_SAMPLES} x {N_CLASSES}) in {slice_s:.2f} s; launches {launches}")
    for kname in CLASSIFICATION_KERNELS:
        check(launches[kname] > 0, f"kernel {kname} was never launched on the classification path")
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

    # ---- phase 3b: the detection path, kernels against plain
    map_metric, coco, det_launches = detection_phase(torch, mt, kernels_mod)
    launches.update({k: det_launches[k] for k in DETECTION_KERNELS})

    # ---- phase 3c: the text path at roberta-large width, kernel against plain
    text = text_phase(torch, mt, kernels_mod, cm, bert_ops)
    launches.update({k: text["launches"][k] for k in TEXT_KERNELS})
    worst_err["maxsim_tf32x3"] = max(worst_err["maxsim_tf32x3"], text["max_abs_err"])

    # ---- phase 4: timing
    logits, probs, target = next(batches(torch))
    target_bool = torch.nn.functional.one_hot(target, N_CLASSES) == 1
    grid = binned.sort_thresholds(mt.BinnedAveragePrecision(num_classes=N_CLASSES).thresholds)
    n, c, t = BATCH, N_CLASSES, N_THRESHOLDS
    ops = n * c * math.ceil(math.log2(t + 1))  # one compare per binary-search step
    forms = {}
    for form, tgt, target_bytes in (("labels", target, n * target.element_size()), ("dense", target_bool, n * c)):
        # scores and target read once, thresholds and order once, the counts written once
        bytes_moved = n * c * 4 + target_bytes + t * 8 + 3 * c * t * 4
        f_bound_ms, f_bound_by = bound(bytes_moved, ops, name)
        f_ms = time_ms(torch, lambda tgt=tgt: binned.binned_counts(probs, tgt, grid))
        f_plain_ms = time_ms(torch, lambda tgt=tgt: binned.binned_counts(probs, tgt, grid, plain=True))
        f_prof = profile_window(torch, lambda tgt=tgt: binned.binned_counts(probs, tgt, grid), reps=20)
        report_profile(f"binned_counts wrapper, {form}", f_prof)
        check(all("binned_" in k for k in f_prof["recorded"]),
              f"binned_counts ({form}) ran other device operations: {sorted(f_prof['recorded'])}")
        device_ops = sum(f_prof["recorded"].values()) / 20
        forms[form] = dict(ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound_ms, bound_by=f_bound_by,
                           device_us=sum(us for k, us in f_prof["per_launch_us"].items() if "binned_" in k) or None,
                           device_ops_per_call=device_ops, target=f"{tuple(tgt.shape)} {tgt.dtype}")
        print(f"phase 4 ({smi}): binned_counts, {form} target {tuple(tgt.shape)} {tgt.dtype}: {f_ms * 1e3:.1f} us/call"
              f" (device {forms[form]['device_us']} us, {device_ops:.2f} device operations recorded per call),"
              f" plain {f_plain_ms * 1e3:.1f} us, bound {f_bound_ms * 1e3:.2f} us ({f_bound_by})")
    # one class, many rows: a single cluster of 8 blocks takes every row
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    few_n = 1_000_000
    few_preds = torch.rand((few_n, 1), generator=gen, device="cuda")
    few_labels = torch.randint(0, 2, (few_n,), generator=gen, device="cuda")
    few_ms = time_ms(torch, lambda: binned.binned_counts(few_preds, few_labels, grid))
    few_prof = profile_window(torch, lambda: binned.binned_counts(few_preds, few_labels, grid), reps=20)
    few_bound_ms, few_by = bound(few_n * (4 + 8) + t * 8 + 3 * t * 4, few_n * math.ceil(math.log2(t + 1)), name)
    few = dict(shape=[few_n, 1, t], ms=few_ms, bound_ms=few_bound_ms, bound_by=few_by,
               device_us=sum(us for k, us in few_prof["per_launch_us"].items() if "binned_" in k) or None)
    print(f"phase 4 ({smi}): binned_counts, labels at {tuple(few['shape'])}: {few_ms * 1e3:.1f} us/call"
          f" (device {few['device_us']} us), bound {few_bound_ms * 1e3:.2f} us ({few_by})")

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
    print(f"phase 4 ({smi}): update step {step_ms * 1e3:.1f} us; compute {compute_ms:.2f} ms")

    # where the time goes, from the profiler's device trace
    steps = iter(stream[3:-1])

    def one_step():
        lg, pb, tg = next(steps)
        coll.update(lg, tg)
        metric.update(pb, tg)

    report_profile("update step (collection + binned AP)", profile_window(torch, one_step, reps=10))
    binned_updates = iter(stream[3:-1])

    def one_binned_update():
        _, pb, tg = next(binned_updates)
        metric.update(pb, tg)

    binned_prof = profile_window(torch, one_binned_update, reps=10)
    report_profile("one BinnedAveragePrecision.update", binned_prof)
    launches_per_update = sum(binned_prof["recorded"].values()) / 10
    check(all("binned_" in k or "CUDAFunctor_add" in k for k in binned_prof["recorded"]),
          f"a binned update ran more than its kernel and the state adds: {sorted(binned_prof['recorded'])}")
    check(launches_per_update <= 4.0, f"a binned update made {launches_per_update} device operations, at most 4 expected"
                                      " (the kernel and three state adds)")
    print(f"  device operations recorded per binned update: {launches_per_update:.1f}"
          f" ({', '.join(f'{k[:40]} x{v / 10:g}' for k, v in binned_prof['recorded'].items())})")
    report_profile("compute (collection + binned AP)", profile_window(torch, compute_all, reps=5))

    det = detection_timing(torch, mt, im, map_metric, coco, name, smi)
    txt = text_timing(torch, cm, *text["embeddings"], name, smi)

    # ---- phase 5: sync on the card, entry() and the dry-run, Metric.to
    dryrun_launches = entry_twins(torch, entry_mod, kernels_mod)
    check_moves(torch, mt, kernels_mod, logits, probs, target)
    synced = sync_phase(torch, mt, kernels_mod, sync, (n_batches, states, results, ap), coco, text, smi)

    # ---- phase 6: the compiled main path against phase 3's eager run
    compiled = compiled_phase(torch, mt, kernels_mod, (n_batches, states, results, ap), smi)
    timings = compiled["timings"]

    def record(kname, timing, **extra):
        us = {"us": timing["ms"] * 1e3, "plain_us": timing["plain_ms"] * 1e3, "bound_us": timing["bound_ms"] * 1e3}
        return {
            "name": kname,
            "route": "cuda",
            "source": f"metrics_tpu_torch/csrc/{kernels_mod.KERNELS[kname].source}",
            "replaces": kernels_mod.KERNELS[kname].replaces,
            "launches": launches[kname],
            "max_abs_err": worst_err[kname],
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing.get("library_ms"),
            "ok": True,
            **us,
            **extra,
        }

    kernels = [
        record("binned_counts", {k: forms["labels"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes per-class counts at every threshold",
               shape=[n, c, t], target=forms["labels"]["target"], device_us=forms["labels"]["device_us"],
               device_ops_per_call=forms["labels"]["device_ops_per_call"], dense=forms["dense"], one_class=few,
               device_ops_per_binned_update=launches_per_update, update_step_us=step_ms * 1e3, compute_ms=compute_ms,
               synced_path_launches=synced["launches"], dryrun_launches=dryrun_launches,
               synced_compute_ms=synced["synced_ms"], unsynced_compute_ms=synced["unsynced_ms"],
               synced_compute_collectives=synced["collectives"],
               compiled_path_launches={k: r["launches"] for k, r in compiled["runs"].items()},
               compiled_path_binned_updates={k: r["updates"] for k, r in compiled["runs"].items()},
               compiled_update_step_us=[r["step_us"] for r in timings["compiled"]],
               compiled_update_idle_share=[r["step_idle"] for r in timings["compiled"]],
               compiled_compute_ms=[r["compute_ms"] for r in timings["compiled"]],
               compiled_compute_idle_share=[r["compute_idle"] for r in timings["compiled"]],
               eager_update_step_us=[r["step_us"] for r in timings["eager"]],
               eager_update_idle_share=[r["step_idle"] for r in timings["eager"]],
               eager_compute_ms=[r["compute_ms"] for r in timings["eager"]],
               eager_compute_idle_share=[r["compute_idle"] for r in timings["eager"]]),
        record("pairwise_iou", {k: v for k, v in det["pairwise_iou"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes batched pairwise IoU",
               **{k: det["pairwise_iou"][k] for k in ("shape", "device_us", "count_free_ms", "unfused_step_ms",
                                                      "unfused_step_device_us")}),
        record("greedy_match", {k: v for k, v in det["greedy_match"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes the greedy COCO matching",
               shape=det["greedy_match"]["shape"], device_us=det["greedy_match"]["device_us"],
               g64=det["greedy_match"]["g64"], map_update_us=det["map_update_us"], map_update_host_us=det["map_update_host_us"],
               map_compute_eval_s=det["map_compute_eval_s"], map_compute_calc_s=det["map_compute_calc_s"],
               map_compute_idle_share=det["map_compute_idle_share"]),
        record("maxsim_tf32x3", {k: v for k, v in txt["full"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
               library_note="torch.bmm then two amax, TF32 off (three calls; the port never calls them)",
               shape=txt["full"]["shape"], device_us=txt["full"]["device_us"],
               chunk={k: v for k, v in txt["chunk"].items()},
               bert_update_s=text["update_s"], bert_compute_s=text["compute_s"],
               bert_compute_split_ms=text["split_ms"], bert_compute_device_busy_ms=text["device_busy_ms"],
               bert_compute_idle_share=text["idle_share"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
