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
3. The classification path at ImageNet-1k validation size (50,000 samples,
   1,000 classes, batches of 1,024): a MetricCollection of Accuracy (micro)
   and F1/Precision/Recall (macro) plus BinnedAveragePrecision (100
   thresholds), updated per batch and computed, then the same stream again
   with the binned counts forced onto the plain version; every state must
   match bit for bit, the binned-counts kernel must have launched on this
   path, and a small input must agree with a numpy oracle.
3b. The detection path at COCO val2017 evaluation size (5,000 images of
   640x480, 80 classes, 100 detections and about 7.4 ground truths per
   image), generated on the card from a seed: MeanAveragePrecision updated
   16 images at a time with no synchronisation allowed, then computed with
   per-class values; then the same stream with the IoU and matcher kernels
   forced onto their plain versions. Every result must match bit for bit,
   each kernel must have launched once per 256-image chunk, and the
   metric's docstring example must give its documented values on the card.
4. Timing with CUDA events (median after warm-up): each kernel beside its
   plain version and its bound, one whole update step of each path, compute,
   and the device's idle share from the profiler.

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
CLASSIFICATION_KERNELS = ("binned_counts",)
DETECTION_KERNELS = ("pairwise_iou", "greedy_match")
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


def bound(bytes_moved: float, ops: float, name: str):
    """The least time in ms for the work (the larger of bytes over the memory
    rate and float32 operations over the peak rate) and which one bounds it."""
    t_bytes, t_ops = bytes_moved / hbm_rate(name), ops / FP32_PEAK
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


# --------------------------------------------------------------------------- #
# phase 2: the detection kernels against their plain versions
# --------------------------------------------------------------------------- #
def random_boxes(torch, gen, shape, low=0.0, high=500.0, side=(1.0, 200.0)):
    xy = low + torch.rand((*shape, 2), generator=gen, device="cuda") * (high - low)
    wh = side[0] + torch.rand((*shape, 2), generator=gen, device="cuda") * (side[1] - side[0])
    return torch.cat([xy, xy + wh], dim=-1).contiguous()


def iou_cases(torch):
    """(label, det (B, D, 4), gt (B, G, 4)) on the card, made from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [(f"random {b}x{d}x{g}", random_boxes(torch, gen, (b, d)), random_boxes(torch, gen, (b, g)))
             for b, d, g in ((256, 128, 64), (1, 1, 1), (3, 7, 5))]
    det = torch.tensor([[[0, 0, 0, 5], [5, 0, 0, 5], [10, 10, 20, 20], [0, 0, 2, 2], [3, 3, 3, 3]]],
                       dtype=torch.float32, device="cuda")
    gt = torch.tensor([[[20, 10, 30, 20], [0, 0, 2, 2], [10, 20, 20, 30], [5, 0, 0, 5]]],
                      dtype=torch.float32, device="cuda")
    cases.append(("degenerate, touching and identical boxes", det, gt))
    cases.append(("coordinates near 1e6", random_boxes(torch, gen, (4, 32), 1e6, 1e6 + 300.0, (0.5, 40.0)),
                  random_boxes(torch, gen, (4, 16), 1e6, 1e6 + 300.0, (0.5, 40.0))))
    same = random_boxes(torch, gen, (8, 16))
    cases.append(("identical box sets", same, same.clone()))
    return cases


def check_iou_kernel(torch, kernels_mod, im):
    kernel = kernels_mod.KERNELS["pairwise_iou"]
    worst = 0.0
    for label, det, gt in iou_cases(torch):
        before = kernel.launches
        got = im.pairwise_iou(det, gt)
        torch.cuda.synchronize()
        want = im.pairwise_iou(det, gt, plain=True)
        torch.cuda.synchronize()
        check(kernel.launches - before == 1, f"pairwise_iou [{label}]: launches {kernel.launches - before}")
        check(got.shape == want.shape and got.dtype == want.dtype, f"pairwise_iou [{label}]: shape/dtype")
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"pairwise_iou [{label}]: kernel differs from plain, max abs err {err}")
        worst = max(worst, err)
        print(f"  pairwise_iou [{label}] det {tuple(det.shape)} gt {tuple(gt.shape)}: bitwise equal")
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


def check_match_kernel(torch, kernels_mod, im):
    kernel = kernels_mod.KERNELS["greedy_match"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [
        ("COCO chunk B=256 A=4 T=10 D=128 G=64", match_case(torch, im, gen, 256, 4, 10, 128, 64)),
        ("G=128", match_case(torch, im, gen, 32, 4, 10, 128, 128)),
        ("G=256", match_case(torch, im, gen, 16, 4, 10, 64, 256)),
        ("D=1", match_case(torch, im, gen, 8, 4, 10, 1, 64, ties=True)),
        ("all-invalid rows", match_case(torch, im, gen, 8, 4, 10, 32, 16, det_ok_p=0.0, gt_ok_p=0.0)),
        ("duplicate ground truths, tied IoUs", match_case(torch, im, gen, 64, 4, 10, 48, 24, n_labels=2, ties=True)),
    ]
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
    the two kernels: (sorted det boxes, gt boxes) and the matcher's inputs."""
    arrays, (cid, cmask, area_ranges, thresholds, max_det), _, _ = metric._evaluation_inputs(metric._get_classes())
    det_boxes, det_scores, det_labels, det_counts, gt_boxes, gt_labels, gt_counts = (x[:256].contiguous() for x in arrays)
    prep = im.match_inputs(det_boxes, det_scores, det_labels, det_counts, gt_boxes, gt_labels, gt_counts,
                           cid, cmask, area_ranges, max_det)
    boxes_sorted = prep["boxes_sorted"].contiguous()
    ious = torch.where(prep["valid_pairs"], im.pairwise_iou(boxes_sorted, gt_boxes), 0.0)
    match_args = (ious, prep["det_class_valid"].any(dim=1), prep["labels_sorted"].contiguous(), gt_labels,
                  prep["gt_class_valid"].any(dim=1), prep["gt_area_ignore"].contiguous(), thresholds)
    return (boxes_sorted, gt_boxes), match_args


def profile_compute(torch, metric) -> dict:
    """Device busy time and wall time of one compute() under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metric.compute()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us, host_us = {}, {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0)
        if dev > 0 and not evt.key.startswith(("aten::", "cuda")):
            device_us[evt.key] = dev
        elif evt.key.startswith("aten::") or evt.key.startswith("cuda"):
            host_us[evt.key] = evt.self_cpu_time_total
    return {"wall_us": wall_us, "device_us": device_us, "host_us": host_us}


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
    (det_sorted, gt), match_args = chunk_inputs(torch, metric, im)
    b, d, _ = det_sorted.shape
    g = gt.shape[1]
    iou_ms = time_ms(torch, lambda: im.pairwise_iou(det_sorted, gt))
    iou_plain_ms = time_ms(torch, lambda: im.pairwise_iou(det_sorted, gt, plain=True))
    iou_bound_ms, iou_by = bound(b * (d + g) * 16 + b * d * g * 4, 12 * b * d * g, name)
    ious, _, _, _, _, gt_ignore, thresholds = match_args
    a, t = gt_ignore.shape[1], thresholds.numel()
    match_ms = time_ms(torch, lambda: im.greedy_match(*match_args))
    match_plain_ms = time_ms(torch, lambda: im.greedy_match(*match_args, plain=True), warmup=2, reps=20)
    # each input read once, the flags written once; a multiply and a compare per (b, a, t, d, g)
    match_bytes = b * d * g * 4 + b * d * (1 + 4) + b * g * (4 + 1) + b * a * g + t * 4 + b * a * t * d
    match_bound_ms, match_by = bound(match_bytes, 2 * b * a * t * d * g, name)
    iou_prof = profile_window(torch, lambda: im.pairwise_iou(det_sorted, gt), reps=20)
    match_prof = profile_window(torch, lambda: im.greedy_match(*match_args), reps=20)
    report_profile("pairwise_iou wrapper", iou_prof)
    report_profile("greedy_match wrapper", match_prof)
    iou_device_us = sum(us for k, us in iou_prof["device_us"].items() if "pairwise_iou" in k) or None
    match_device_us = sum(us for k, us in match_prof["device_us"].items() if "greedy_match" in k) or None

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
    print(f"phase 4 detection ({smi}): pairwise_iou {iou_ms * 1e3:.1f} us/call (device {iou_device_us} us),"
          f" plain {iou_plain_ms * 1e3:.1f} us, bound {iou_bound_ms * 1e3:.2f} us ({iou_by});"
          f" greedy_match {match_ms * 1e3:.1f} us/call (device {match_device_us} us), plain {match_plain_ms * 1e3:.1f} us,"
          f" bound {match_bound_ms * 1e3:.2f} us ({match_by})")
    print(f"  update of {COCO_BATCH} images: {update_ms * 1e3:.1f} us by events, {update_host_ms * 1e3:.1f} us of host time;"
          f" compute: device evaluation {eval_s:.3f} s + host curves {calc_s:.3f} s;"
          f" profiled compute {prof['wall_us'] / 1e6:.3f} s, device busy {busy / 1e3:.1f} ms,"
          f" idle share {'not measured' if idle is None else f'{idle:.4f}'}")
    for key, us in sorted(prof["device_us"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"    device {us:11.1f} us  {key[:110]}")
    shapes = {"pairwise_iou": [b, d, g], "greedy_match": [b, a, t, d, g]}
    return {
        "pairwise_iou": dict(ms=iou_ms, plain_ms=iou_plain_ms, bound_ms=iou_bound_ms, bound_by=iou_by,
                             device_us=iou_device_us, shape=shapes["pairwise_iou"]),
        "greedy_match": dict(ms=match_ms, plain_ms=match_plain_ms, bound_ms=match_bound_ms, bound_by=match_by,
                             device_us=match_device_us, shape=shapes["greedy_match"]),
        "map_update_us": update_ms * 1e3,
        "map_update_host_us": update_host_ms * 1e3,
        "map_compute_eval_s": eval_s,
        "map_compute_calc_s": calc_s,
        "map_compute_idle_share": idle,
    }


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; this smoke run needs the card")
    try:
        import metrics_tpu_torch as mt
        from metrics_tpu_torch.ops import kernels as kernels_mod
        from metrics_tpu_torch.ops.classification import binned_counts as binned
        from metrics_tpu_torch.ops.kernels import iou_matching as im
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
    worst_err = {
        "binned_counts": check_binned_kernel(torch, kernels_mod, binned),
        "pairwise_iou": check_iou_kernel(torch, kernels_mod, im),
        "greedy_match": check_match_kernel(torch, kernels_mod, im),
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

    # ---- phase 4: timing
    logits, probs, target = next(batches(torch))
    target_bool = torch.nn.functional.one_hot(target, N_CLASSES) == 1
    grid = binned.sort_thresholds(mt.BinnedAveragePrecision(num_classes=N_CLASSES).thresholds)
    kernel_ms = time_ms(torch, lambda: binned.binned_counts(probs, target_bool, grid))
    plain_ms = time_ms(torch, lambda: binned.binned_counts(probs, target_bool, grid, plain=True))
    n, c, t = BATCH, N_CLASSES, N_THRESHOLDS
    bytes_moved = n * c * (4 + 1) + t * 4 + 3 * c * t * 4
    ops = n * c * math.ceil(math.log2(t + 1))  # one compare per binary-search step
    bound_ms, bound_by = bound(bytes_moved, ops, name)

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

    det = detection_timing(torch, mt, im, map_metric, coco, name, smi)

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
            "library_ms": None,
            "ok": True,
            **us,
            **extra,
        }

    kernels = [
        record("binned_counts", dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by),
               library_note="no single PyTorch call computes per-class counts at every threshold",
               shape=[n, c, t], device_us=kernel_device_us or None, update_step_us=step_ms * 1e3,
               compute_ms=compute_ms),
        record("pairwise_iou", {k: v for k, v in det["pairwise_iou"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes batched pairwise IoU",
               shape=det["pairwise_iou"]["shape"], device_us=det["pairwise_iou"]["device_us"]),
        record("greedy_match", {k: v for k, v in det["greedy_match"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes the greedy COCO matching",
               shape=det["greedy_match"]["shape"], device_us=det["greedy_match"]["device_us"],
               map_update_us=det["map_update_us"], map_update_host_us=det["map_update_host_us"],
               map_compute_eval_s=det["map_compute_eval_s"], map_compute_calc_s=det["map_compute_calc_s"],
               map_compute_idle_share=det["map_compute_idle_share"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
