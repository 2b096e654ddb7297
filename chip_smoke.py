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
   per-class values; then every image's evaluation again with the IoU and
   matcher kernels forced onto their plain versions, which must match bit
   for bit (the host curves are a deterministic function of them), each
   kernel must have launched once per 256-image chunk, and the
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
compiled_compute=False`` (mAP: ``compiled_update=False``), so their numbers
stay those of the eager path. Phases 6 and 7 run the compiled engines.

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

7. The curve family and the compiled mAP update (``core/buffers.py``'s
   captured appends). (a) Phase 3's stream (probabilities and labels)
   through one MetricCollection of AUROC (macro), AveragePrecision and
   CalibrationError (15 bins), each with ``buffer_capacity=50_000``: eager,
   then with the engines at their defaults. The buffer states (rows, counts,
   overflow flags, host mirrors) and two computes are bitwise equal; the
   fused update has 1 eager call and 1 capture per signature (the first call
   materializes the buffers) and replays the rest, in place; the steady
   state runs under ``set_sync_debug_mode("error")`` with
   ``memory_allocated`` flat; compute goes back to eager at its probe, as in
   the JAX package; AUROC/AP/ECE are within 1e-5 of a float64 numpy oracle.
   Each compute is timed by events and its reads to the host counted; the
   update step compiled and eager, by events and the profiler. ROC and
   PrecisionRecallCurve run once each over unbounded list states (engines
   off for the update); their curves give AUROC's and AP's values bit for
   bit. (c) An AUROC at capacity 8,192 fed 16,384 rows: the warning fires at
   the update that overflows, with no synchronisation; the count keeps the
   true total; compute() raises the overflow error. (b) Phase 3b's stream
   through ``MeanAveragePrecision(class_metrics=True, buffer_capacity=5_000)``
   at its defaults (pow2-bucketed captured update, eager compute): the steady
   state under sync debug mode "error" with flat memory, buffers and results
   bitwise equal to phase 3b, B2 and the matcher once per 256-image chunk.

8. The rest of classification and the aggregators, which run no kernel of
   B1-B3 (their launch counts stay 0 through the phase). Each run goes eager,
   then with the engines at their defaults, in one call: states and two
   computes bitwise, each engine's eager calls, captures and replays those of
   its signatures, the steady state under ``set_sync_debug_mode("error")``
   with ``memory_allocated`` flat. (a) Phase 3's stream through one
   MetricCollection of ConfusionMatrix, JaccardIndex, MatthewsCorrCoef and
   CohenKappa (one compute group) with Specificity and Dice (macro): the
   (1000, 1000) int32 matrix bitwise equal to numpy's ``add.at`` over the
   host copy of the stream, the five scores within 1e-5 of float64, and one
   synced compute in a world of one NCCL rank bitwise equal to the unsynced
   one with one ``all_reduce`` per compute group. (b) HingeLoss
   (Crammer-Singer) on the logits, KLDivergence of the softmax against a
   seeded teacher's at temperature 2, MeanMetric of the per-batch mean
   cross-entropy weighted by batch size, Sum/Max/Min/CatMetric
   (``buffer_capacity=50_000``) of the per-sample cross-entropy: CatMetric's
   rows, the max and the min bitwise equal to the losses, the rest within
   1e-5 of float64. (c) Multilabel scores at MS-COCO 2014 val size (40,504
   images, 80 labels, about 2.9 per image, sigmoid scores rounded through
   float16) through HammingDistance, CoverageError,
   LabelRankingAveragePrecision and LabelRankingLoss, within 1e-5 of a
   float64 numpy oracle (sklearn's max-tie ranks; ties in the ranking loss
   ordered by label index, as the stable sort orders them; sklearn's count
   of tied pairs is printed beside it). (d) A MeanMetric and a buffered
   CatMetric fed a NaN: eager warns once each and drops the row, compiled
   masks it and keeps 0.0, as the JAX package does. Update steps and
   computes timed eager and compiled by events and the profiler; the phase
   stays under 120 s.

9. Regression, pairwise and retrieval, which run no kernel of B1-B3 (their
   launch counts stay 0 through the phase). (a) Retrieval at MS MARCO
   passage-ranking dev (small) width: 1,745 queries (a quarter of its 6,980,
   cut for time) x 1,000 re-ranked candidates (1,745,000 rows) fed
   query-major, 64 queries an update, about
   1.07 relevant passages a query and none for 14.3% of them, seeded scores
   rounded through float16 (ties), through MRR, MAP, nDCG@10, P@10, R@100,
   HitRate@10, R-precision, FallOut@10, the precision-recall curve and recall
   at precision 0.1 (max_k = 100) over list states and the per-query host
   loop (route i), and the eight scalar metrics with ``buffer_capacity=
   7_000_000, max_queries=8_192, max_docs_per_query=1_024`` (route ii: one
   captured update of the eight, one captured compute). Route (ii)'s buffer
   rows are bitwise equal to route (i)'s appends, its steady-state update
   runs under ``set_sync_debug_mode("error")`` with ``memory_allocated``
   flat, its replayed compute reads nothing back; the routes agree within
   1e-5 and each metric is within 1e-5 of a float64 numpy oracle; bounds set
   too small raise eager and give NaN captured. (b) Per-pixel depth
   regression at NYU Depth v2 test size (654 images of 480 x 640, 8 an
   update, mm-quantised targets in 0.5-10 m, log-normal predictions) through
   MSE, RMSE, MAE, MSLE, MAPE, SMAPE, WMAPE, R2, explained variance, Pearson
   and Tweedie (power 1.5) in one collection, eager then compiled, bitwise,
   each within 1e-5 relative of a float64 oracle summed on the host (Tweedie
   1e-4), and one synced compute in a world of one NCCL rank bitwise equal
   to the unsynced one (Pearson's moments stacked on a rank axis of one). (c) Spearman over the first 16 images (heavy ties), list and
   buffered, against scipy within 1e-5; CosineSimilarity over 2,000 x 1,024
   embedding pairs, list and buffered. (d) The pairwise matrices with TF32
   off against float64. Update steps, computes and readbacks timed; the
   phase stays under 420 s.

10. The wrappers and the text metrics other than BERTScore, which run no
   kernel of B1-B3 (their launch counts stay 0 through the phase). (a) On
   phase 3's stream: BootStrapper(Accuracy, 100 replicas, quantiles 0.025
   and 0.975, raw) with poisson and then multinomial resampling, each
   replica's counts bitwise against a numpy redraw of the same seed and its
   statistics within 1e-6 of float64, the update step by events and its
   device operations by the profiler; ClasswiseWrapper's 1,000 values
   bitwise against Accuracy(average=None); MinMaxMetric's forward per batch
   bitwise against a plain Accuracy's batch values and their running min
   and max; MetricTracker over five epochs with a seeded 1-10% of noisy
   rows, its best values and steps equal to five separate collections';
   MultioutputWrapper(MSE, 3 outputs) on per-pixel surface normals at NYU
   Depth v2 test size with 5% NaN holes, states bitwise against three MSEs
   fed the NaN-filtered columns, within 1e-5 relative of float64, its reads
   to the host counted. (b) Text from seeded Zipf corpora (no dataset is
   read), each metric's states on the card bitwise equal to a CPU twin's
   and its results within 1e-6: WER, CER, MER, WIL and WIP at LibriSpeech
   test-clean size (2,620 utterances, 52,576 words, 5% word edits), the
   batched edit-distance scan bitwise against the pure-Python DP and timed
   by events with its device operations; BLEU, SacreBLEU (13a), chrF++, TER
   and EED at WMT19 newstest2019 size (2,000 segments, 30% word edits);
   ROUGE-1/2/L/Lsum at CNN/DailyMail test size (11,490 summaries of 3-4
   sentences, the regex sentence splitter); SQuAD at v1.1 dev size (10,570
   questions). The phase stays under 300 s.

11. The rest of detection and the sketches. (a) Phase 3b's stream through
   ``MeanAveragePrecision(device_state=False, class_metrics=True)``, the
   host-list route, updated with no synchronisation allowed: every result
   bitwise equal to phase 3b's device-state results; B2 and the matcher
   launched once per (pd, pg) bucket chunk of at most 256 images; every
   image's evaluation bitwise equal to the plain-kernel run's; the compute
   split into host prep, device evaluation, fetch and ``_calculate``.
   (b) 500 images at LVIS's 300 detections: the list route bitwise equal to
   ``device_state=True, detections_capacity=512`` and different from the
   default capacity of 128, which warns once per image. (c) segm at COCO
   val2017 image size (480 x 640) on 500 images, cut from 5,000 because 100
   dense bool masks an image hold 31 MB on the card: seeded ellipse masks,
   detections dense on the card, ground truths compressed RLE strings made
   by the port's ``rle_encode``; results bitwise equal to the plain-matcher
   run, the matcher once per chunk, ``mask_iou`` on 8 images equal to
   float32(intersection) / float32(union) of exact counts, the peak
   ``memory_allocated`` and the compute split. (d) Quantile (0.5, 0.9, 0.99,
   0.999) and Median on 100,000,000 lognormal values (1% zeros, 0.1%
   NaN/+inf/-inf), DistinctCount (precision 12 and 18) on int32 keys from
   10,000,000 distinct values, HeavyHitters (threshold 0.001, 64 hitters,
   16 domain bits) on Zipf(1.1) token ids over GPT-2's 50,257 ids, in
   batches of 2**20, and AUROC(approx="sketch") on 10,000,000 binary scores:
   eager then compiled, states bitwise, the steady state under
   ``set_sync_debug_mode("error")`` with ``memory_allocated`` flat; each
   value against numpy's float64 nearest rank (within ``relative_accuracy``),
   ``torch.unique`` (4 sigma), the true counts (every key at or above the
   threshold found by the descent, within [true, true + 2N/width]) and the
   exact AUROC (5e-3); after 8 batches every state bitwise equal to a
   ``device="cpu"`` twin's, but for the quantile counts of values within
   four float32 ulps of a bucket boundary, which are counted; update steps
   and computes timed eager and compiled. (e) Every phase-11 metric's
   synced compute in a world of one NCCL rank bitwise equal to its unsynced
   one: the list-route mAPs on their first 64 images run the count exchange
   and one gather round per image and list state (masks padded to the
   largest (H, W) first); the sketches add no collective beyond their
   (reduction, dtype) buckets. The phase stays under 240 s.

12. Image, which runs no kernel of B1-B3 (their launch counts stay 0), every
   net with seeded random weights (no checkpoint is in the repository), TF32
   off. (a) FID (2048), KID (100 subsets of 1,000) and IS (logits_unbiased,
   10 splits) at CIFAR-10 size, 10,000 seeded uint8 32 x 32 images a side
   (FID's protocol takes 50,000) in updates of 100 through the port's
   InceptionV3: FID's Welford mean within 1e-5 and M2 within 1e-4 of a
   float64 two-pass, FID within 1e-3 of float64 scipy, KID within rtol 1e-4
   / atol 1e-5 of float64 on the same subsets, IS's mean within 1e-4 and
   its std within 1e-3, on the same features; the card's features against a CPU twin of the net on 16
   images a side and across batch sizes (alone, 100, padded to 128) within
   rtol 1e-3 / atol 1e-3 x scale; the forward's time, images/s, idle share
   and operations bound; FID's compute partition (eager on the card: eigh
   reads cusolver's status). (b) LPIPS alex and squeeze on 5,000 pairs and
   vgg on 1,000 at 256 x 256 in updates of 50, against a CPU twin on 8 and
   bfloat16 against float32 (2e-2). (c) PSNR, SSIM, MS-SSIM and UQI at DIV2K
   validation size (100 RGB images of 1356 x 2040 in updates of 4), eager
   against ``buffer_capacity=100`` (captured appends) bit for bit, the card
   against CPU twins on 4 images within 1e-5, image_gradients bitwise
   against numpy, each compute's time and peak ``memory_allocated``. (d)
   ERGAS, SAM and D-lambda on 200 tiles of 8 bands at 256 x 256 (ratio 4)
   the same way. (e) After each part its synced computes in a world of one
   NCCL rank, bitwise equal to the unsynced ones (FID: a gather of each of
   its six states). The feature bucketing's forwards and widths are printed
   as a JSON line. The phase stays under 180 s.

13. Audio, which runs no kernel of B1-B3 (their launch counts stay 0),
   on seeded speech-like signals (the JAX test's generator with its pitch,
   formants and syllable rate drawn per source; no corpus is in the
   repository), TF32 off. (a) Separation at WSJ0-2mix test size (3,000
   two-speaker mixtures at 8 kHz, 3-10 s each, updates of 8): PIT over
   SI-SNR, then SI-SDR, SNR and SDR (filter 512, direct solve) on the
   estimates in PIT's order; every permutation equal to the data's and, on
   the first 256 mixtures, to scipy's ``linear_sum_assignment`` of the
   float64 matrix; PIT, SI-SDR and SNR within rtol 1e-4 and SDR within rtol
   1e-2 / atol 5e-3 of float64 (scipy's Toeplitz solver); a CPU twin on 64;
   the four compiled (engine defaults) against eager on 4 s crops of 1,000,
   bitwise, with each engine's partition. (b) Enhancement at
   VoiceBank-DEMAND test size (824 utterances at 16 kHz, 1.5-5 s, noisy at
   2.5-17.5 dB): STOI and ESTOI (host resample to 10 kHz), native PESQ wb
   and nb (on an 8 kHz copy), SI-SDR, per SNR group: every group mean
   rises with SNR, STOI/ESTOI within 2e-3 of a float64 oracle on 64, the
   card against the CPU port on 16 (PESQ's delays and active frames equal),
   the pinned PESQ goldens within 2e-2. (c) PIT with 3 speakers (500
   mixtures) and 8 (64, eager: scipy's Hungarian route; the 8! table on
   the card chooses the same) against an exhaustive float64 search. Update
   steps eager and compiled with device busy and idle share, SDR's FFTs and
   solve apart, STOI's host resample apart, computes, the peak
   ``memory_allocated``. The phase stays under 120 s.

14. Sync variants in a world of one NCCL rank (several ranks are tested on
   the CPU with gloo), B1 inside the captured incremental step. (a) Phase
   3's stream through config2 and the binned AP, synced under each of exact,
   bf16, int8 and sparse_count (set globally; the gate routes what a
   transport cannot carry to exact): exact bit for bit the unsynced state,
   every transport bit for bit a ``device="cpu"`` twin's sync through a
   gloo group of one and within ``transport_error_bound(t, 1)`` of exact,
   relative to the bucket's largest value; collectives, wire and logical
   bytes and the sync's time by events. (b) A 4,096-class ConfusionMatrix
   (64 MiB int32) the same way, once on 2**20 samples whose nonzeros fit
   sparse_count's slots (the gather branch) and once on 16 x 2**20 uniform
   pairs that do not (the dense branch), with the peak
   ``max_memory_allocated``. (c) An incremental streak of config2 and the
   binned AP over phase 3's stream at K = 1 and 4 through
   ``CompiledIncrementalStep`` (the update, B1 and the emission's
   all_reduces in one graph) and eagerly: each finalize bit for bit the
   ``sync_states`` of the final states, one emission every K steps and the
   tail paid at finalize, B1 once a step with replays counted, one graph per
   emitting and quiet signature; step times captured and eager. (d) Synced
   computes through the compiled compute engine, eager, captured and
   replayed, bitwise equal, the EngineStats collective fields printed; then
   under sparse_count, whose nonzero count is a host read that the probe
   refuses: the int32 groups eager with that reason, the binned AP captured,
   the results unchanged. The phase stays under 90 s.

15. Sharded state in a world of one NCCL rank: a mesh of one shows the
   capture, the results and the memory, not the links' cost. (a) A
   4,096-class ConfusionMatrix (64 MiB int32) placed with ``shard_state``,
   fed phase 14's 16 x 2**20 pairs: the update eager, then captured (the
   delta's zeroing, the update, its ``reduce_scatter`` and the add in one
   graph), one ``reduce_scatter`` an update, no host sync and a flat
   ``memory_allocated`` in the steady state, the block bit for bit a
   replicated twin's; ``compute()`` through the sharded-compute protocol
   (eager, captured, replayed: one result ``all_gather``, no reshard), and
   ``unshard_state`` (one reshard), both bitwise; ``forward`` of a placed
   metric built with ``sync_on_compute=False`` (it still syncs), bitwise
   against a replicated twin; the peak
   ``max_memory_allocated`` over an eager update (the transient delta) and the
   update's time, captured and eager, by events. (b) A sharded
   BinnedPrecisionRecallCurve and BinnedAveragePrecision at 1,000 classes
   and 100 thresholds over phase 3's stream: B1 once an update, the blocks
   bit for bit the plain version's on the card and a replicated twin's, the
   protocol's results bitwise. (c) A collection of micro Accuracy, macro
   Precision and the ConfusionMatrix, sharded and replicated members fused,
   bitwise equal to an unsharded collection. (d) A class x threshold grid of
   B1's counts declared ``shard_axis=(0, 1)`` on a [1, 1] mesh: two
   ``reduce_scatter``s an update, two reshards at compute, bitwise. (e) A
   sample-sharded CatMetric buffer: its updates eager with the reason
   recorded, bitwise against a replicated twin; an overflowed buffer's flag
   through the placement, a captured step (a CUDA graph over its leaves,
   built by hand: no entry point captures such a buffer's update, so this
   checks the engine's flattener only) and ``unshard_state``. The phase
   stays under 60 s.

17. Checkpoint and tenancy, in a world of one NCCL rank. (a) The config2
   collection (10 classes, 64-row batches) beside the dry run's
   BinnedAveragePrecision (8 classes, 21 thresholds) on captured engines: a
   blocking save after 10 batches, an ``overlap_copy`` async save after 15
   while 5 more captured steps replay, the objects dropped, a restore into
   fresh metrics on the card and the rest of the 40 batches: states of each
   snapshot and final results bitwise those of an uninterrupted run, B1
   once an update after the restore; a snapshot written by the port on the
   CPU at the same seed restores onto the card, bitwise. (b) The 4,096-class
   ConfusionMatrix (64 MiB int32), plain and placed: save, verify and
   restore under a temporary directory with their bytes and seconds, then a
   4 -> 1 ``merge_shards`` of four explicit shards (their sum, bitwise).
   (c) A chaos plan on ``storage/write`` and ``ckpt/commit`` under a
   RetryPolicy: the save commits, the restore is bitwise; a corrupt newest
   step falls back to the older one with a ``checkpoint/restore/fallback``
   event. (d) 1,024-slot TenantSets of config2 and of the binned AP, 1,024
   tenants x 64 rows: every tenant bitwise its own stream, one batched B1
   launch (``binned_counts_batched``) a stacked update, bitwise a set on B1's
   plain version; ragged occupancy (37, 38, 5 of 1,024) keeps one captured
   step a bucket width with none new across admit, evict and reset; a
   TenantSet save and restore, bitwise; the stacked sync's collectives the
   same at N = 1,024 and N = 16; the per-tenant microseconds of one stacked
   update against N independent dispatches at N = 16, 256, 1,024. The
   launch counts are set to 0 before (a) and read after (d). Then the
   batched B1 launch at (1,024, 64, 8, 21) beside its plain version and its
   bound, its device time by the profiler and by CUDA events around a
   captured graph of 20 launches; and the unbatched B1 wrapper at phase 3's
   shape by its two routes, the direct launch and the
   ``metrics_tpu::binned_counts`` operator. The phase stays under 60 s.

18. Serve and cluster, B1's tenant-batched launch under HTTP ingest, every
   input made on the host with numpy (it crosses HTTP). The template is
   config2's collection (10 classes) plus BinnedAveragePrecision (10 classes,
   21 thresholds), fed 64-row batches of probabilities and labels. (a) An
   IngestServer on 127.0.0.1 over a 1,024-slot TenantSet; 1,024 tenants of 4
   steps (every fourth 8), half as single-step npz bodies and half as bodies
   of 4 steps, posted by 8 client threads in a seeded order: after the drain
   the ledger's admitted equal its applied with no dead letter, every
   tenant's staleness-0 read is bitwise the offline replay of the admitted
   log through plain (eager) metrics on the card, the batched B1 launched
   once a stacked update, the set's captured steps are those of the bucket
   widths it met (observed, not assumed) and nothing fell back; a 4-slot
   queue answers 429 queue_full with Retry-After. (b) Two replicas, each an
   IngestServer over its own 1,024-slot set, behind a ClusterCoordinator and
   ClusterClients over HTTP: both dispatchers warm up at once; 256 tenants
   posted through the clients, 8 of them moved r0 -> r1 while their posts go
   on (fenced, then redirected by 307); a checkpoint of both, a step applied
   on r1 after it, r1 lost, posts to it refused, r1 recovered from its
   checkpoint and the client's replay of every step past the restored
   watermark; every read bitwise its replay, the moved tenants' snapshots
   byte for byte those of a CPU twin fed the same steps, the batched B1
   launches equal the three sets' stacked updates, the ``cluster/*`` events
   and ``metrics_tpu_cluster_*`` series present. Throughput, POST and read
   latencies, dispatch widths, fence windows and the recovery time are
   printed. The phase stays under 60 s.

19. Self-tuning sync and the heavy-kernel registry, in a world of one NCCL
   rank with a gloo group of one for the CPU twins. (a) ``set_autotune(True)``
   on phase 18's template (config2 + BinnedAveragePrecision, 10 classes, 21
   thresholds, engines at their defaults), 16 rounds of 4 updates of 64
   seeded rows and one synced compute: every bucket commits through
   gate-admissible transports, the ``sync/tune_decision`` events are the
   decisions, 16 more rounds make no decision, leave the epoch, the
   partition and the captures as they were, B1 launched once an update
   (replays counted), the tuned synced states lie within
   ``transport_error_bound(t, 1)`` of exact relative to each bucket's
   largest value, and a ``device="cpu"`` twin through gloo, from a fresh
   controller, makes the same decisions and bitwise the same computes.
   (b) The exported plan saved as JSON and pinned from the file: all 32
   rounds again with no decision, a constant epoch, one build and one
   capture each, the post-commit rounds bitwise (a)'s; the captured synced
   compute timed under the committed transports and under exact.
   (c) ``sync_state`` of the JAX package's autotune test state (8,192
   float32 and 1,000 int32 sum elements, a 2-element float32 max), 12 times
   on the card and on its twin: equal decisions, both sum buckets on int8
   with cadence 4, the max bucket exact, int8 within its bound, the synced
   values bitwise the twin's. (d) Under the tracer, ``evaluate_matches`` on
   three COCO chunks at (256, 4, 10, 128, 32), two of one shape, one of 64
   images; ``pairwise_cosine_pr`` on two (64, 1, 512, 512, 1024) chunks; one
   bucketed feature forward of 48 rows: ``heavy_kernel_calls`` (``cuda`` for
   the kernels, ``torch`` for the forward), the launch counters, the
   bucket-width histogram (128, 512, 64), the ``kernel/dispatch`` events, no
   fallback and the trace counts (2 and 1). The phase stays under 60 s.

Phase 2 holds the integer and IoU kernels bit for bit against their plain
versions (B1's tenant-batched launch also against B unbatched launches, at
the tenancy shape, unaligned rows, labels out of range, one tenant, the
beyond-shared-memory path, empty rows, and 70,000 tenants in two launches),
the matcher also on every staging path (D in double-buffered slabs,
bulk copies and plain loads) and argmax path up to G = 38,741; the 3xTF32
maxsim kernel (2c, on shapes TMA describes as they are and on padded copies
of the others) sums in another order than the plain version's matrix
product, so it is held within 1e-5 of it and of a float64 recomputation.

The line before the last is the card's name and power limit as nvidia-smi
reports them; before it, one JSON line ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
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


def profile_window(torch, fn, reps: int, warmup: bool = True) -> dict:
    """Per-call device time of each kernel, device busy time and wall time,
    and the host ops that took longest, over ``reps`` calls of ``fn`` (after
    one call outside the window unless ``warmup`` is False)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
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
    kernel = kernels_mod.CUDA_KERNELS["binned_counts"]
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


def check_batched_binned_kernel(torch, kernels_mod, binned):
    """B1's tenant-batched launch: one launch for B tenants, bitwise equal to
    the batched plain version and to B unbatched launches."""
    kernel = kernels_mod.CUDA_KERNELS["binned_counts_batched"]
    lib = kernel.lib()
    max_t = lib.binned_counts_max_shared_t()
    check(lib.binned_counts_batched_workspace_len(5, 3, max_t + 1) == 5 * lib.binned_counts_workspace_len(3, max_t + 1),
          "the batched global path should take one workspace slice a tenant")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 171)
    dev = "cuda"

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def labels(b, n, c, dtype=torch.int64, low=0, high=None):
        return torch.randint(low, c if high is None else high, (b, n), generator=gen, device=dev, dtype=dtype)

    lin = lambda t: torch.linspace(0, 1, t, device=dev)  # noqa: E731
    cases = [
        (f"labels the tenancy shape {TENANTS}x{TENANT_ROWS}x{DRY_CLASSES}x{DRY_THRESHOLDS}",
         uniform(TENANTS, TENANT_ROWS, DRY_CLASSES), labels(TENANTS, TENANT_ROWS, DRY_CLASSES), lin(DRY_THRESHOLDS)),
        ("dense 16x257x7x21, unaligned rows", uniform(16, 257, 7), uniform(16, 257, 7) < 0.5, lin(21)),
        ("labels int32 4x1024x1000x100", uniform(4, 1024, 1000), labels(4, 1024, 1000, torch.int32), lin(100)),
        ("labels at -1 and C 3x513x12x21", uniform(3, 513, 12), labels(3, 513, 12, low=-1, high=13), lin(21)),
        ("labels one tenant 1x300x5x13", uniform(1, 300, 5), labels(1, 300, 5), lin(13)),
        (f"labels T={max_t + 1000}, beyond shared memory, 5 tenants", uniform(5, 600, 3), labels(5, 600, 3),
         torch.rand(max_t + 1000, generator=gen, device=dev)),
        ("labels empty rows 7x0x6x11", uniform(7, 0, 6), labels(7, 0, 6), lin(11)),
        # more tenants than the grid's z dimension holds: one launch a slice
        ("labels 70000x4x3x5, two slices of tenants", uniform(70000, 4, 3), labels(70000, 4, 3), lin(5)),
    ]
    worst = 0.0
    for label, preds, target, thresholds in cases:
        b, n = preds.shape[:2]
        grid = binned.sort_thresholds(thresholds)
        want = binned.binned_counts_batched(preds, target, grid, plain=True)
        # B unbatched launches where B is small enough to loop over
        unbatched = torch.stack([torch.stack(binned.binned_counts(p, y, grid)) for p, y in zip(preds, target)]) \
            if b <= TENANTS else None
        torch.cuda.synchronize()
        expected = 0 if n == 0 else -(-b // binned.MAX_TENANTS_PER_LAUNCH)  # one launch a slice of tenants
        for call in range(2):  # twice: a workspace left unclean would show
            before = kernel.launches
            got = binned.binned_counts_batched(preds, target, grid)
            torch.cuda.synchronize()
            check(kernel.launches - before == expected, f"binned_counts_batched [{label}]: launches {kernel.launches - before}")
            check(got.shape == want.shape and got.dtype == want.dtype, f"binned_counts_batched [{label}]: shape/dtype")
            err = float((got - want).abs().max()) if got.numel() else 0.0
            check(torch.equal(got, want), f"binned_counts_batched [{label}] call {call + 1}: kernel differs from plain,"
                                          f" max abs err {err}")
            check(unbatched is None or torch.equal(got, unbatched),
                  f"binned_counts_batched [{label}]: differs from unbatched launches")
            worst = max(worst, err)
        print(f"  binned_counts_batched [{label}]: bitwise equal to the plain version"
              + (f" and to {b} unbatched launches" if unbatched is not None else "")
              + f", {expected} launch{'' if expected == 1 else 'es'} a call")
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


def build_slice(mt, plain_counts: bool = False, compiled: bool = False, buckets: bool = False, device=None):
    """The slice's collection and binned metric: eager (``compiled=False``,
    phases 3-5) or with the compiled engines at their defaults (phase 6),
    optionally with ``batch_buckets=True`` on every metric; on the card
    unless ``device`` names another (phase 14's CPU twins)."""
    flags = {} if compiled else {"compiled_update": False, "compiled_compute": False}
    kw = dict(flags, batch_buckets=buckets, device=device)
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
    kernel = kernels_mod.CUDA_KERNELS["pairwise_iou"]
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
    kernel = kernels_mod.CUDA_KERNELS["greedy_match"]
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
def coco_stream(torch, n=COCO_IMAGES, d=COCO_DETS, seed=SEED + 2):
    """The seeded COCO-size stream on the card: a list of updates, each a
    (preds, targets) pair of lists of per-image dicts (views of a few large
    tensors). Ground truths per image 1 + Poisson(6.4), at most 64, sides
    log-uniform in 4-400 px; ``d`` (100) detections per image, first up to
    three jittered copies of each ground truth (corner noise 10% of the side,
    label kept with probability 0.9, score U(0.3, 1)), then random boxes
    (score U(0, 0.6)). ``n`` images (5,000) from generator ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_max = COCO_MAX_GT

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
    if first.shape[1] < d:  # more detections than candidate copies: the rest are random boxes
        first = torch.nn.functional.pad(first, (0, d - first.shape[1]))
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
    metric = mt.MeanAveragePrecision(class_metrics=True, compiled_update=False)
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


def profile_evaluation(torch, metric, classes) -> dict:
    """Device time of compute()'s device half, the per-image evaluation,
    under the profiler: its other half, the curves (``_calculate``), is numpy
    on the host and runs no device work, so it is timed alone and not run a
    second time here."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in(torch)
        metric._evaluate_images(classes)
        torch.cuda.synchronize()
    return split_profile(prof)


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
    # the plain-kernel run's evaluations: _calculate is a deterministic function
    # of them, so equal evaluations give equal results (its host curve loop,
    # 25-40 s, stays unspent; the update launches no kernel)
    import numpy as np

    classes = metric._get_classes()
    t0 = time.perf_counter()
    evals = metric._evaluate_images(classes)
    metric._plain_kernels = True
    before = kernels_mod.launch_counts()
    evals_plain = metric._evaluate_images(classes)
    torch.cuda.synchronize()
    eval_plain_s = time.perf_counter() - t0
    check(kernels_mod.launch_counts() == before, "the plain-kernel evaluation launched a kernel")
    metric._plain_kernels = False
    same_evals(np, "3b kernels against their plain versions", evals_plain, evals)
    for key, value in results.items():
        check(value.dtype == torch.float32 and bool(torch.isfinite(value).all()), f"result {key} is not finite float32")
    check(results["map_per_class"].shape == (COCO_CLASSES,), f"map_per_class has shape {tuple(results['map_per_class'].shape)}")
    check(0.0 < float(results["map"]) < 1.0, f"map {float(results['map'])} is not in (0, 1)")
    for key in ("map_small", "map_medium", "map_large"):
        check(float(results[key]) >= 0.0, f"{key} is {float(results[key])}: an area range is empty")
    state_bytes = sum(v.data.numel() * v.data.element_size() for v in metric.get_state().values())
    print(f"  every image's evaluation (what _calculate reads) bitwise equal to the plain-kernel run's (both"
          f" evaluations {eval_plain_s:.2f} s): " + ", ".join(f"{k}={float(v):.6f}" for k, v in results.items() if v.ndim == 0))
    print(f"  state: {state_bytes / 1e6:.1f} MB at capacity {metric.det_counts.capacity} images;"
          f" compute's peak device memory above the state: {peak_extra / 1e6:.1f} MB")
    check_map_docstring_example(torch, mt)
    return metric, stream, launches, results


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

    fresh = mt.MeanAveragePrecision(class_metrics=True, compiled_update=False)
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
    prof = profile_evaluation(torch, metric, classes)
    busy = sum(prof["device_us"].values())
    idle = max(0.0, 1.0 - busy / ((eval_s + calc_s) * 1e6)) if prof["device_us"] else None
    print(f"phase 4 detection ({smi}): pairwise_iou with counts at {(b, d, g)} {iou_ms * 1e3:.1f} us/call"
          f" (device {iou_device_us} us), plain {iou_plain_ms * 1e3:.1f} us, bound {iou_bound_ms * 1e3:.2f} us ({iou_by});"
          f" without counts {count_free_ms * 1e3:.1f} us/call; IoU then mask and where {unfused_ms * 1e3:.1f} us/call"
          f" (device {unfused_device_us} us in all);"
          f" greedy_match {match_ms * 1e3:.1f} us/call (device {match_device_us} us), plain {match_plain_ms * 1e3:.1f} us,"
          f" bound {match_bound_ms * 1e3:.2f} us ({match_by}); at G=64 {wide_ms * 1e3:.1f} us/call (device"
          f" {wide_device_us} us), bound {wide_bound_ms * 1e3:.2f} us ({wide_by})")
    print(f"  update of {COCO_BATCH} images: {update_ms * 1e3:.1f} us by events, {update_host_ms * 1e3:.1f} us of host time;"
          f" compute: device evaluation {eval_s:.3f} s + host curves {calc_s:.3f} s;"
          f" device busy {busy / 1e3:.1f} ms (the evaluation profiled again; the curves run none),"
          f" idle share {'not measured' if idle is None else f'{idle:.4f}'} of the compute")
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
    kernel = kernels_mod.CUDA_KERNELS["maxsim_tf32x3"]
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
        det = mt.MeanAveragePrecision(class_metrics=True, compiled_update=False)
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
    gc.collect()  # garbage of earlier phases would otherwise be freed inside the window
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
    check(kernels_mod.CUDA_KERNELS["binned_counts"].lib().binned_counts_workspace_len(3, t) > 0,
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



# --------------------------------------------------------------------------- #
# phase 7: the curve family and the compiled mAP update
# --------------------------------------------------------------------------- #
ECE_BINS = 15
CURVE_ATOL = 1e-5
OVERFLOW_CAPACITY, OVERFLOW_BATCHES = 8192, 16


def curve_collection(mt, compiled: bool):
    """AUROC (macro), AveragePrecision and CalibrationError over the
    ImageNet-size stream, each buffered to the stream's 50,000 rows."""
    flags = {} if compiled else {"compiled_update": False, "compiled_compute": False}
    return mt.MetricCollection(
        {
            "auroc": mt.AUROC(num_classes=N_CLASSES, average="macro", buffer_capacity=N_SAMPLES, **flags),
            "ap": mt.AveragePrecision(num_classes=N_CLASSES, buffer_capacity=N_SAMPLES, **flags),
            "ece": mt.CalibrationError(n_bins=ECE_BINS, buffer_capacity=N_SAMPLES, **flags),
        },
        **flags,
    )


def buffer_states(coll) -> dict:
    """Every buffer state's valid rows, count and overflow flag, by name."""
    out = {}
    for key, m in coll.items(keep_base=True):
        for s, buf in m.get_state().items():
            out[f"{key}.{s}.rows"] = buf.data[: min(len(buf), buf.capacity)]
            out[f"{key}.{s}.count"] = buf.count
            out[f"{key}.{s}.overflowed"] = buf.overflowed
            out[f"{key}.{s}.mirror"] = (len(buf), buf.overflow_seen)
    return out


def same_states(torch, label: str, got: dict, want: dict) -> None:
    check(set(got) == set(want), f"{label}: state names differ")
    for key, value in want.items():
        if isinstance(value, tuple):
            check(got[key] == value, f"{label}: {key} {got[key]} differs from {value}")
        else:
            check(value.dtype == got[key].dtype and torch.equal(got[key], value), f"{label}: state {key} differs")


class ReadbackCounter:
    """Counts the reads of a device value to the host (``.item()``,
    ``bool()``, ``int()``, ``nonzero`` sizes, copies to the CPU) while active."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        aten = torch.ops.aten
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                packet = func._overloadpacket
                if packet is aten._local_scalar_dense:
                    counter.n += 1
                elif packet in (aten._to_copy, aten.copy_):
                    src = args[1] if packet is aten.copy_ else args[0]
                    dst = args[0].device if packet is aten.copy_ else kwargs.get("device")
                    if getattr(src, "is_cuda", False) and dst is not None and torch.device(dst).type == "cpu":
                        counter.n += 1
                elif packet in (aten.nonzero, aten.masked_select):
                    counter.n += 1  # the output size is read back
                return func(*args, **kwargs)

        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def curve_oracle(np, probs, target):
    """float64 numpy AUROC (macro), AP (macro) and ECE (l1, 15 bins) of the
    stream: per class a stable sort of the scores, distinct thresholds,
    cumulative counts; the trapezoid of the ROC, the step sum of the PR
    curve; the ECE bins over the float32 grid the metric uses."""
    n, c = probs.shape
    aurocs, aps = np.empty(c), np.empty(c)
    for k in range(c):
        s = probs[:, k]
        order = np.argsort(-s, kind="stable")
        s, y = s[order].astype(np.float64), (target[order] == k).astype(np.float64)
        last = np.r_[np.nonzero(np.diff(s))[0], n - 1]
        tps = np.cumsum(y)[last]
        fps = (last + 1) - tps
        fpr, tpr = np.r_[0.0, fps / fps[-1]], np.r_[0.0, tps / tps[-1]]
        aurocs[k] = np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2)
        precision, recall = tps / (tps + fps), tps / tps[-1]
        aps[k] = np.sum(np.diff(np.r_[0.0, recall]) * precision)
    conf = probs.max(axis=1)
    acc = (probs.argmax(axis=1) == target).astype(np.float64)
    grid = (np.arange(ECE_BINS, dtype=np.float32) * np.float32(1.0 / ECE_BINS)).tolist() + [1.0]
    bins = np.clip(np.searchsorted(np.asarray(grid, np.float32), conf, side="left") - 1, 0, ECE_BINS - 1)
    ece = 0.0
    for b in range(ECE_BINS):
        sel = bins == b
        if sel.any():
            ece += abs(acc[sel].mean() - conf[sel].astype(np.float64).mean()) * sel.mean()
    return {"auroc": aurocs.mean(), "ap": aps.mean(), "ece": ece}


def curve_step_timing(torch, mt, stream, compiled: bool) -> dict:
    """7(a): the update step of the curve collection by CUDA events (median
    of the steady state) and its device-idle share by the profiler."""
    coll = curve_collection(mt, compiled)
    for _, pb, tg in stream[:3]:
        coll.update(pb, tg)
    times = []
    for _, pb, tg in stream[3:-11]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        coll.update(pb, tg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    steps = iter(stream[-11:-1])

    def one_step():
        _, pb, tg = next(steps)
        coll.update(pb, tg)

    prof = profile_window(torch, one_step, reps=9)
    return {"step_us": statistics.median(times) * 1e3, "idle": idle_share(prof), "busy_us": sum(prof["device_us"].values()),
            "prof": prof}


def curve_phase(torch, mt, np, stream, smi) -> dict:
    """7(a): the ImageNet-size stream through the buffered AUROC/AP/ECE
    collection, eager and then compiled, bitwise; the unbounded-list ROC and
    PrecisionRecallCurve once each; a float64 numpy oracle."""
    from metrics_tpu_torch.ops.classification.auc import _auc_compute_without_check
    from metrics_tpu_torch.ops.classification.average_precision import _average_precision_compute_with_precision_recall

    sizes = [int(tg.shape[0]) for _, _, tg in stream]

    eager = curve_collection(mt, compiled=False)
    for _, pb, tg in stream:
        eager.update(pb, tg)
    torch.cuda.synchronize()
    want_states = buffer_states(eager)
    t0 = time.perf_counter()
    want = eager.compute()
    torch.cuda.synchronize()
    eager_compute_s = time.perf_counter() - t0

    coll = curve_collection(mt, compiled=True)
    steady = range(2, len(stream) - 1)  # past the two warmups and the capture, before the ragged batch
    gc.collect()  # garbage of earlier phases would otherwise be freed inside the window
    mem = []
    for i, (_, pb, tg) in enumerate(stream):
        if i > steady.start:
            mem.append(torch.cuda.memory_allocated())
        if i in steady and i > steady.start:
            torch.cuda.set_sync_debug_mode("error")
        try:
            coll.update(pb, tg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same_states(torch, "7(a) compiled", buffer_states(coll), want_states)
    for name, m in coll.items(keep_base=True):
        for s, buf in m.get_state().items():
            check(len(buf) == N_SAMPLES and int(buf.count) == N_SAMPLES and not bool(buf.overflowed),
                  f"7(a): {name}.{s} count {len(buf)}/{int(buf.count)}, expected {N_SAMPLES}")
    # the update engine before compute: a compute that migrates to eager rebuilds the partition
    sigs = [(i > 0, s) for i, s in enumerate(sizes)]  # the first update materializes the buffers
    engine = coll._update_engine
    check_engine("7(a) curve collection update", engine.stats, expected_engine_counts(sigs),
                 donated=expected_engine_counts(sigs)["cache_hits"])
    check(engine.broken is None and all(step.graph is not None for step in engine._steps.values()),
          f"7(a): fused update broken ({engine.broken}) or a step without a graph")
    update_view = coll.engine_stats()["partition"]["update"]
    computes = []
    for _ in range(2):  # the warmup, then the probe that sends compute back to eager
        for m in coll.values():
            m._computed = None
        computes.append(coll.compute())
    for n, got in enumerate(computes):
        for key, value in want.items():
            check(torch.equal(got[key], value), f"7(a): compiled-path compute {n + 1} {key} differs from eager")
    compute_view = coll.engine_stats()["partition"]["compute"]
    for name in ("auroc", "ap", "ece"):
        check(update_view[name]["path"] == "fused", f"7(a): {name} update path {update_view[name]}")
        check(compute_view[name]["path"] == "eager" and "data-dependent shape" in compute_view[name]["reason"],
              f"7(a): {name} compute path {compute_view[name]}")
    check(len(set(mem)) == 1, f"7(a): memory_allocated moved across the steady-state steps: {sorted(set(mem))}")

    probs = torch.cat([pb for _, pb, _ in stream]).cpu().numpy()
    target = torch.cat([tg for _, _, tg in stream]).cpu().numpy()
    t0 = time.perf_counter()
    oracle = curve_oracle(np, probs, target)
    oracle_s = time.perf_counter() - t0
    for key, value in oracle.items():
        err = abs(float(want[key]) - value)
        check(math.isfinite(float(want[key])) and err <= CURVE_ATOL, f"7(a): {key} {float(want[key])} vs float64 {value}")
    del probs

    # each member's compute by CUDA events, and its readbacks
    compute_ms, readbacks = {}, {}
    for key, m in eager.items(keep_base=True):
        def one(m=m):
            m._computed = None
            m.compute()
        compute_ms[key] = time_ms(torch, one, warmup=1, reps=3)
        with ReadbackCounter(torch) as counter:
            one()
        readbacks[key] = counter.n
    compute_prof = {}
    for key, m in eager.items(keep_base=True):
        compute_prof[key] = profile_window(torch, lambda m=m: (setattr(m, "_computed", None), m.compute()), reps=1)

    # the unbounded-list route: ROC and PrecisionRecallCurve once each
    curves = {}
    for label, cls in (("roc", mt.ROC), ("prc", mt.PrecisionRecallCurve)):
        metric = cls(num_classes=N_CLASSES, compiled_update=False)
        for _, pb, tg in stream:
            metric.update(pb, tg)
        check(isinstance(metric.preds, list) and len(metric.preds) == len(stream), f"7(a): {label} keeps list states")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, b, thresholds = metric.compute()
        torch.cuda.synchronize()
        curves[label] = time.perf_counter() - t0
        check(len(a) == len(b) == len(thresholds) == N_CLASSES, f"7(a): {label} gives {len(a)} curves")
        check(all(bool(torch.isfinite(x).all()) for x in a + b), f"7(a): {label} curve points are not finite")
        if label == "roc":
            area = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(a, b)]).mean()
            check(torch.equal(area, want["auroc"]), "7(a): the ROC curves' mean area differs from AUROC")
        else:
            ap = _average_precision_compute_with_precision_recall(a, b, N_CLASSES, "macro")
            check(torch.equal(ap, want["ap"]), "7(a): the PR curves' macro AP differs from AveragePrecision")
        del metric, a, b, thresholds

    timing = {"eager": [], "compiled": []}
    for compiled in (False, True, True, False):
        timing["compiled" if compiled else "eager"].append(curve_step_timing(torch, mt, stream, compiled))
    for label in ("eager", "compiled"):
        report_profile(f"7(a) {label} curve update step (AUROC + AP + ECE)", timing[label][0]["prof"])
    for key in compute_ms:
        report_profile(f"7(a) {key} compute", compute_prof[key])
    print(f"phase 7(a): {len(stream)} updates of the buffered AUROC/AP/ECE collection ({N_SAMPLES} x {N_CLASSES});"
          f" compiled states (rows, counts, flags) and 2 computes bitwise equal to eager; update engine"
          f" {expected_engine_counts(sigs)}, steady state with sync debug mode 'error', memory_allocated flat at"
          f" {mem[0]} bytes; AUROC {float(want['auroc']):.7f}, AP {float(want['ap']):.7f}, ECE {float(want['ece']):.7f}"
          f" against float64 {oracle['auroc']:.7f}, {oracle['ap']:.7f}, {oracle['ece']:.7f} (oracle {oracle_s:.1f} s)")
    print(f"phase 7(a) ({smi}): update step compiled "
          + ", ".join(f"{r['step_us']:.1f} us (idle {r['idle']}, device busy {r['busy_us']:.1f} us)" for r in timing["compiled"])
          + "; eager " + ", ".join(f"{r['step_us']:.1f} us (idle {r['idle']}, device busy {r['busy_us']:.1f} us)"
                                   for r in timing["eager"]))
    print(f"phase 7(a) ({smi}): compute by events " + ", ".join(f"{k} {v:.1f} ms" for k, v in compute_ms.items())
          + f" (first eager compute of all three {eager_compute_s:.2f} s); readbacks per compute "
          + ", ".join(f"{k} {v}" for k, v in readbacks.items())
          + f"; list route compute ROC {curves['roc']:.2f} s, PrecisionRecallCurve {curves['prc']:.2f} s")
    return {"compute_ms": compute_ms, "readbacks": readbacks, "timing": timing, "list_compute_s": curves,
            "oracle": oracle, "values": {k: float(v) for k, v in want.items()}}


def overflow_phase(torch, mt, stream) -> dict:
    """7(c): a buffered AUROC whose capacity is half the stream it gets: the
    warning fires at the update that overflows, with no synchronisation; the
    count keeps the true total; compute() raises the overflow error."""
    import warnings

    metric = mt.AUROC(num_classes=N_CLASSES, buffer_capacity=OVERFLOW_CAPACITY)
    warned = []
    for i, (_, pb, tg) in enumerate(stream[:OVERFLOW_BATCHES]):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if i >= 3:
                torch.cuda.set_sync_debug_mode("error")
            try:
                metric.update(pb, tg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        warned.append(any("overflowed its capacity" in str(w.message) for w in rec))
    total = OVERFLOW_BATCHES * BATCH
    first = next(i for i in range(OVERFLOW_BATCHES) if (i + 1) * BATCH > OVERFLOW_CAPACITY)
    check(warned == [i == first for i in range(OVERFLOW_BATCHES)], f"7(c): overflow warnings at {warned}, expected update {first}")
    for s in ("preds", "target"):
        buf = getattr(metric, s)
        check(len(buf) == total and int(buf.count) == total and bool(buf.overflowed) and buf.overflow_seen,
              f"7(c): {s} count {len(buf)}/{int(buf.count)} flag {bool(buf.overflowed)}, expected {total} and set")
    try:
        metric.compute()
        fail("7(c): compute() of an overflowed buffer did not raise")
    except Exception as err:  # the port's MetricsUserError
        text = str(err)
        check(text.startswith(f"CatBuffer overflow: more samples were appended (count={total}) than its capacity "
                              f"({OVERFLOW_CAPACITY}) held at the time"), f"7(c): compute raised {text[:200]}")
    print(f"phase 7(c): AUROC at capacity {OVERFLOW_CAPACITY} fed {total} rows: warned once, at update {first + 1}"
          f" (no synchronisation from update 4 on); count {total}, flag set; compute raises the overflow error")
    return {"first_overflowing_update": first + 1}


def map_compiled_phase(torch, mt, kernels_mod, stream, map_reference, results_reference) -> dict:
    """7(b): phase 3b's stream through MeanAveragePrecision with the engines
    at its defaults (pow2-bucketed captured update, eager compute)."""
    metric = mt.MeanAveragePrecision(class_metrics=True, buffer_capacity=COCO_IMAGES)
    steady = range(2, len(stream) - 1)
    gc.collect()  # garbage of earlier phases would otherwise be freed inside the window
    mem, times = [], []
    for i, (preds, targets) in enumerate(stream):
        if i > steady.start:
            mem.append(torch.cuda.memory_allocated())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if i in steady:
            torch.cuda.set_sync_debug_mode("error")
        try:
            metric.update(preds, targets)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.record()
        if i in steady:
            end.synchronize()
            times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    for name in map_reference._defaults:
        got, want = getattr(metric, name), getattr(map_reference, name)
        check(len(got) == len(want) == COCO_IMAGES and torch.equal(got.to_array(), want.to_array()),
              f"7(b): buffer {name} differs from phase 3b's eager run")
    sizes = [len(p) for p, _ in stream]
    chunks = [c for n in sizes for c in pow2_chunks(n)]
    want_counts = expected_engine_counts(chunks)
    check_engine("7(b) mAP update", metric._update_engine.stats, dict(want_counts, bucketed_calls=len(sizes)),
                 donated=want_counts["cache_hits"])
    view = metric.engine_stats()["partition"]
    check(view["update"]["path"] == "bucketed" and view["compute"]["path"] == "eager", f"7(b): partition {view}")
    check(all(step.graph is not None for step in metric._update_engine._steps.values()), "7(b): a step without a graph")
    check(len(set(mem)) == 1, f"7(b): memory_allocated moved across the steady-state updates: {sorted(set(mem))}")
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    results = metric.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    n_chunks = math.ceil(COCO_IMAGES / 256)
    for kname in DETECTION_KERNELS:
        check(launches[kname] == n_chunks, f"7(b): {kname} launched {launches[kname]} times for {n_chunks} chunks")
    check(set(results) == set(results_reference), "7(b): result keys differ from phase 3b")
    for key, value in results_reference.items():
        check(torch.equal(results[key], value), f"7(b): result {key} differs from phase 3b's eager run")
    step_us = statistics.median(times) * 1e3
    print(f"phase 7(b): {len(stream)} mAP updates through the engine ({want_counts}, {len(chunks)} pow2 chunks),"
          f" buffers and results bitwise equal to phase 3b; steady state with sync debug mode 'error',"
          f" memory_allocated flat at {mem[0]} bytes; update {step_us:.1f} us (median by events); compute"
          f" {compute_s:.2f} s with B2 and the matcher launched {launches['pairwise_iou']}, {launches['greedy_match']} times")
    return {"launches": {k: launches[k] for k in DETECTION_KERNELS}, "update_us": step_us, "compute_s": compute_s,
            "engine": want_counts}


def phase_seven(torch, mt, np, kernels_mod, coco, map_reference, map_results, smi) -> dict:
    stream = [(None, pb, tg) for _, pb, tg in batches(torch)]  # the probabilities and labels of phase 3's stream
    torch.cuda.synchronize()
    curves = curve_phase(torch, mt, np, stream, smi)
    overflow = overflow_phase(torch, mt, stream)
    del stream
    detection = map_compiled_phase(torch, mt, kernels_mod, coco, map_reference, map_results)
    return {"curves": curves, "overflow": overflow, "map": detection}


# --------------------------------------------------------------------------- #
# phase 8: the rest of classification and the aggregators
# --------------------------------------------------------------------------- #
FLOAT64_ATOL = 1e-5
# MS-COCO 2014 val as a multilabel classification benchmark: 40,504 images,
# 80 labels, about 2.9 labels per image
COCO14_IMAGES, COCO14_LABELS, COCO14_POSITIVES = 40_504, 80, 2.9
KD_TEMPERATURE = 2.0
NAN_CAPACITY, NAN_BATCHES, NAN_WIDTH, NAN_AT = 64, 5, 4, 2
PHASE8_LIMIT_S = 120.0


def engine_flags(compiled: bool) -> dict:
    return {} if compiled else {"compiled_update": False, "compiled_compute": False}


def confmat_collection(mt, compiled: bool):
    """8(a): ConfusionMatrix, JaccardIndex, MatthewsCorrCoef and CohenKappa
    (one compute group: they share one confmat) with Specificity and Dice."""
    flags = engine_flags(compiled)
    return mt.MetricCollection(
        {
            "confmat": mt.ConfusionMatrix(num_classes=N_CLASSES, **flags),
            "jaccard": mt.JaccardIndex(num_classes=N_CLASSES, **flags),
            "mcc": mt.MatthewsCorrCoef(num_classes=N_CLASSES, **flags),
            "kappa": mt.CohenKappa(num_classes=N_CLASSES, **flags),
            "specificity": mt.Specificity(num_classes=N_CLASSES, average="macro", **flags),
            "dice": mt.Dice(num_classes=N_CLASSES, average="macro", **flags),
        },
        **flags,
    )


def loss_metrics(mt, compiled: bool) -> dict:
    """8(b): the loss side of an ImageNet eval loop with a teacher."""
    flags = engine_flags(compiled)
    return {
        "hinge": mt.HingeLoss(multiclass_mode="crammer-singer", **flags),
        "kl": mt.KLDivergence(**flags),
        "mean_ce": mt.MeanMetric(**flags),
        "sum_ce": mt.SumMetric(**flags),
        "max_ce": mt.MaxMetric(**flags),
        "min_ce": mt.MinMetric(**flags),
        "cat_ce": mt.CatMetric(buffer_capacity=N_SAMPLES, **flags),
    }


def feed_losses(metrics: dict, batch) -> None:
    logits, probs, target, teacher, ce = batch
    metrics["hinge"].update(logits, target)
    metrics["kl"].update(probs, teacher)
    metrics["mean_ce"].update(ce.mean(), weight=float(ce.shape[0]))
    for key in ("sum_ce", "max_ce", "min_ce", "cat_ce"):
        metrics[key].update(ce)


def ranking_collection(mt, compiled: bool):
    """8(c): the multilabel metrics over COCO-2014-size scores."""
    flags = engine_flags(compiled)
    return mt.MetricCollection(
        {
            "hamming": mt.HammingDistance(**flags),
            "coverage": mt.CoverageError(**flags),
            "lrap": mt.LabelRankingAveragePrecision(**flags),
            "lrl": mt.LabelRankingLoss(**flags),
        },
        **flags,
    )


def feed_pair(coll, batch) -> None:
    coll.update(*batch)


def members(metrics):
    return metrics.items(keep_base=True) if hasattr(metrics, "compute_groups") else metrics.items()


def set_states(metrics) -> dict:
    """Every state tensor of a collection or a dict of metrics; a buffer as
    its valid rows, count, flag and host mirrors; a sketch as its components."""
    out = {}
    for key, m in members(metrics):
        for s, v in m.get_state().items():
            if getattr(v, "_is_mergeable_sketch", False):
                out.update((f"{key}.{s}.{f}", c) for f, c in v.components().items())
            elif hasattr(v, "to_array"):
                out[f"{key}.{s}.rows"] = v.data[: min(len(v), v.capacity)]
                out[f"{key}.{s}.count"] = v.count
                out[f"{key}.{s}.overflowed"] = v.overflowed
                out[f"{key}.{s}.mirror"] = (len(v), v.overflow_seen)
            else:
                out[f"{key}.{s}"] = v
    return out


def compute_set(metrics) -> dict:
    for _, m in members(metrics):
        m._computed = None
    if hasattr(metrics, "compute_groups"):
        return dict(metrics.compute())
    return {k: m.compute() for k, m in metrics.items()}


def same_results(torch, label: str, got: dict, want: dict) -> None:
    check(set(got) == set(want), f"{label}: result names differ")
    for key, value in want.items():
        if isinstance(value, dict):  # a metric that returns a dict (HeavyHitters)
            same_results(torch, f"{label} {key}", got[key], value)
            continue
        check(value.dtype == got[key].dtype and value.shape == got[key].shape and torch.equal(got[key], value),
              f"{label}: result {key} differs")


def engines_of(metrics) -> dict:
    if hasattr(metrics, "compute_groups"):
        return {"collection": metrics._update_engine}
    return {k: m._update_engine for k, m in metrics.items()}


def eager_then_compiled(torch, label: str, make, feed, stream, buffered=()) -> dict:
    """The stream through ``make(False)`` and then ``make(True)``: states and
    two computes bit for bit; each update engine's eager calls, captures and
    replays those of its signatures, every call past the capture in place;
    the steady state (past the capture, before the ragged batch) under
    ``set_sync_debug_mode("error")`` with ``memory_allocated`` flat."""
    eager = make(False)
    for batch in stream:
        feed(eager, batch)
    torch.cuda.synchronize()
    want_states = set_states(eager)
    want = [compute_set(eager) for _ in range(2)]

    compiled = make(True)
    steady = range(2, len(stream) - 1)
    gc.collect()  # garbage of earlier phases would otherwise be freed inside the window
    mem = []
    for i, batch in enumerate(stream):
        if i > steady.start:
            mem.append(torch.cuda.memory_allocated())
        if i in steady and i > steady.start:
            torch.cuda.set_sync_debug_mode("error")
        try:
            feed(compiled, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same_states(torch, f"{label} compiled", set_states(compiled), want_states)
    sizes = [int(batch[-1].shape[0]) for batch in stream]
    engines = {}
    for key, engine in engines_of(compiled).items():
        sigs = [(i > 0, s) for i, s in enumerate(sizes)] if key in buffered else sizes  # a first append materializes
        counts = expected_engine_counts(sigs)
        check(engine is not None, f"{label}: {key} has no update engine")
        check_engine(f"{label} {key} update", engine.stats, counts, donated=counts["cache_hits"])
        check(engine.broken is None and all(step.graph is not None for step in engine._steps.values()),
              f"{label}: {key} update broken ({engine.broken}) or a step without a graph")
        engines[key] = counts
    got = [compute_set(compiled) for _ in range(2)]  # the warmup, then the capture or the revert to eager
    for n, (g, w) in enumerate(zip(got, want)):
        same_results(torch, f"{label} compiled compute {n + 1}", g, w)
    check(len(set(mem)) == 1, f"{label}: memory_allocated moved across the steady-state steps: {sorted(set(mem))}")
    return {"eager": eager, "compiled": compiled, "results": want[0], "engines": engines, "memory": mem[0]}


def step_timing(torch, make, feed, stream, compiled: bool) -> dict:
    """An update step by CUDA events (median of the steady state), its
    device-idle share and device operations by the profiler; each compute
    by events and the profiler."""
    metrics = make(compiled)
    for batch in stream[:3]:
        feed(metrics, batch)
    times = []
    for batch in stream[3:-11]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        feed(metrics, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    steps = iter(stream[-11:-1])
    prof = profile_window(torch, lambda: feed(metrics, next(steps)), reps=9)
    compute_ms = time_ms(torch, lambda: compute_set(metrics), warmup=2, reps=10)
    compute_prof = profile_window(torch, lambda: compute_set(metrics), reps=3)
    return {"step_us": statistics.median(times) * 1e3, "idle": idle_share(prof), "busy_us": sum(prof["device_us"].values()),
            "device_ops": sum(prof["recorded"].values()) / 9, "prof": prof, "compute_ms": compute_ms,
            "compute_idle": idle_share(compute_prof), "compute_prof": compute_prof}


def timing_pairs(torch, make, feed, stream) -> dict:
    out = {"eager": [], "compiled": []}
    for compiled in (False, True, True, False):  # eager, compiled, compiled, eager in one run
        out["compiled" if compiled else "eager"].append(step_timing(torch, make, feed, stream, compiled))
    return out


def print_timing(label: str, timing: dict, smi: str, ops: bool) -> None:
    for kind in ("eager", "compiled"):
        report_profile(f"{label} {kind} update step", timing[kind][0]["prof"])
        report_profile(f"{label} {kind} compute", timing[kind][0]["compute_prof"])
        runs = timing[kind]
        print(f"phase {label} ({smi}): {kind} update step "
              + ", ".join(f"{r['step_us']:.1f} us (idle {r['idle']}, device busy {r['busy_us']:.1f} us"
                          + (f", {r['device_ops']:.1f} device operations" if ops else "") + ")" for r in runs)
              + "; compute " + ", ".join(f"{r['compute_ms']:.3f} ms (idle {r['compute_idle']})" for r in runs))


def timing_summary(timing: dict) -> dict:
    return {kind: [{k: r[k] for k in ("step_us", "idle", "busy_us", "device_ops", "compute_ms", "compute_idle")}
                   for r in runs] for kind, runs in timing.items()}


def confmat_oracle(np, cm) -> dict:
    """float64 Jaccard (macro), MCC, kappa, specificity (macro) and Dice
    (macro) from an integer confusion matrix."""
    cm = cm.astype(np.float64)
    tp = np.diag(cm)
    rows, cols, total = cm.sum(1), cm.sum(0), cm.sum()
    fp, fn = cols - tp, rows - tp
    tn = total - tp - fp - fn
    union = rows + cols - tp
    jaccard = np.where(union > 0, tp / np.where(union > 0, union, 1), 0.0).mean()
    cov_tp = tp.sum() * total - (rows * cols).sum()
    denom = (total**2 - (cols * cols).sum()) * (total**2 - (rows * rows).sum())
    mcc = cov_tp / np.sqrt(denom) if denom else 0.0
    expected = np.outer(rows, cols) / total
    weights = 1.0 - np.eye(len(tp))
    kappa = 1.0 - (weights * cm).sum() / (weights * expected).sum()
    spec = np.where(tn + fp > 0, tn / np.where(tn + fp > 0, tn + fp, 1), 0.0).mean()
    present = (tp + fp + fn) > 0
    dice = (2 * tp / np.where(present, 2 * tp + fp + fn, 1))[present].mean()
    return {"jaccard": jaccard, "mcc": mcc, "kappa": kappa, "specificity": spec, "dice": dice}


def phase_eight_a(torch, mt, np, sync, stream, smi) -> dict:
    """8(a): the confusion-matrix family at ImageNet-1k validation size."""
    import torch.distributed as dist

    pairs = [(pb, tg) for _, pb, tg, _, _ in stream]
    run = eager_then_compiled(torch, "8(a)", lambda c: confmat_collection(mt, c), feed_pair, pairs)
    eager, results = run["eager"], run["results"]
    groups = sorted(sorted(g) for g in eager.compute_groups.values())
    check(groups == [["confmat", "jaccard", "kappa", "mcc"], ["dice"], ["specificity"]],
          f"8(a): compute groups {groups}")
    view = run["compiled"].engine_stats()["partition"]
    for kind in ("update", "compute"):
        for key, entry in view[kind].items():
            check(entry["path"] == "fused", f"8(a): {key} {kind} path {entry}")

    # the matrix against numpy's add.at over the host copy of the stream
    pred = torch.cat([pb.argmax(dim=1) for pb, _ in pairs]).cpu().numpy()
    true = torch.cat([tg for _, tg in pairs]).cpu().numpy()
    cm = np.zeros((N_CLASSES, N_CLASSES), np.int64)
    np.add.at(cm, (true, pred), 1)
    confmat = results["confmat"]
    check(confmat.dtype == torch.int32 and np.array_equal(confmat.cpu().numpy(), cm.astype(np.int32)),
          "8(a): the confusion matrix differs from numpy's add.at")
    spec_state = eager["specificity"].get_state()
    tp = torch.from_numpy(np.diag(cm).astype(np.int32)).cuda()
    check(torch.equal(spec_state["tp"], tp), "8(a): the stat-score tp differs from the matrix diagonal")
    oracle = confmat_oracle(np, cm)
    errors = {}
    for key, value in oracle.items():
        got = float(results[key])
        errors[key] = abs(got - value)
        check(math.isfinite(got) and errors[key] <= FLOAT64_ATOL, f"8(a): {key} {got} vs float64 {value}")

    # synced in a world of one NCCL rank: bitwise, one all_reduce per (reduction, dtype) bucket per group
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        expected = {"all_reduce": len(eager.compute_groups)}  # each group: one (sum, int32) bucket
        for m in eager.values():
            m._computed = None
        t0 = time.perf_counter()
        with sync.count_collectives() as box, sync.sync_axes(dist.group.WORLD):
            synced = dict(eager.compute())
        torch.cuda.synchronize()
        synced_s = time.perf_counter() - t0
        check(box["by_kind"] == expected, f"8(a): synced compute ran {box['by_kind']}, expected {expected}")
        same_results(torch, "8(a) synced", synced, results)
    finally:
        dist.destroy_process_group()

    timing = timing_pairs(torch, lambda c: confmat_collection(mt, c), feed_pair, pairs)
    print_timing("8(a)", timing, smi, ops=True)
    print(f"phase 8(a): {len(pairs)} updates of ConfusionMatrix/JaccardIndex/MatthewsCorrCoef/CohenKappa + Specificity +"
          f" Dice ({N_SAMPLES} x {N_CLASSES}), groups {groups}; compiled states and 2 computes bitwise equal to eager;"
          f" update engine {run['engines']['collection']}, steady state with sync debug mode 'error', memory_allocated"
          f" flat at {run['memory']} bytes; the ({N_CLASSES}, {N_CLASSES}) int32 matrix bitwise equal to numpy; "
          + ", ".join(f"{k} {float(results[k]):.7f} (float64 {oracle[k]:.7f}, error {errors[k]:.2e})" for k in oracle)
          + f"; synced (world of one NCCL rank) {box['by_kind']} ({box['bytes']} bytes), bitwise, {synced_s * 1e3:.1f} ms")
    return {"engines": run["engines"], "errors": errors, "values": {k: float(results[k]) for k in oracle},
            "collectives": box["by_kind"], "timing": timing_summary(timing)}


def loss_oracle(torch, stream) -> dict:
    """float64 hinge (Crammer-Singer), KL(student || teacher), mean and sum
    of the per-sample cross-entropy, on the card."""
    hinge = kl = ce_sum = 0.0
    n = 0
    for logits, probs, target, teacher, ce in stream:
        lg = logits.double()
        rows = torch.arange(lg.shape[0], device=lg.device)
        true = lg[rows, target]
        other = lg.clone()
        other[rows, target] = -math.inf
        hinge += float((1.0 - (true - other.amax(dim=1))).clamp(min=0).sum())
        p, q = probs.double(), teacher.double()
        p, q = p / p.sum(1, keepdim=True), q / q.sum(1, keepdim=True)
        kl += float(torch.where(p == 0, 0.0, p * torch.log(p / q)).sum())
        ce_sum += float(torch.nn.functional.cross_entropy(lg, target, reduction="sum"))
        n += lg.shape[0]
    return {"hinge": hinge / n, "kl": kl / n, "mean_ce": ce_sum / n, "sum_ce": ce_sum}


def phase_eight_b(torch, mt, stream, smi) -> dict:
    """8(b): hinge, KL against a teacher and the aggregators of the
    cross-entropy, on phase 3's stream."""
    make = lambda c: loss_metrics(mt, c)  # noqa: E731
    run = eager_then_compiled(torch, "8(b)", make, feed_losses, stream, buffered=("cat_ce",))
    results = run["results"]
    ce_all = torch.cat([ce for *_, ce in stream])
    check(torch.equal(results["cat_ce"], ce_all), "8(b): CatMetric rows differ from the per-sample losses")
    check(torch.equal(results["max_ce"], ce_all.max()) and torch.equal(results["min_ce"], ce_all.min()),
          "8(b): MaxMetric/MinMetric differ from the per-sample losses' max/min")
    oracle = loss_oracle(torch, stream)
    errors = {}
    for key, value in oracle.items():
        got = float(results[key])
        errors[key] = abs(got - value) / max(1.0, abs(value))  # relative for the sum of 50,000 losses
        check(math.isfinite(got) and errors[key] <= FLOAT64_ATOL, f"8(b): {key} {got} vs float64 {value}")
    timing = timing_pairs(torch, make, feed_losses, stream)
    print_timing("8(b)", timing, smi, ops=False)
    print(f"phase 8(b): {len(stream)} updates of HingeLoss (crammer-singer), KLDivergence (student vs teacher at"
          f" temperature {KD_TEMPERATURE}), Mean/Sum/Max/Min/CatMetric of the cross-entropy; compiled states and"
          f" 2 computes bitwise equal to eager; engines {run['engines']}; memory_allocated flat at {run['memory']} bytes;"
          f" CatMetric rows, max and min bitwise equal to the per-sample losses; "
          + ", ".join(f"{k} {float(results[k]):.7f} (float64 {oracle[k]:.7f}, error {errors[k]:.2e})" for k in oracle))
    return {"engines": run["engines"], "errors": errors, "values": {k: float(results[k]) for k in oracle},
            "timing": timing_summary(timing)}


def coco14_stream(torch):
    """Multilabel scores at MS-COCO 2014 val size: Bernoulli targets at COCO's
    label density, sigmoid scores of a model with some skill rounded through
    float16 (ties remain), batches of 1,024 and a ragged last batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    out = []
    for start in range(0, COCO14_IMAGES, BATCH):
        b = min(BATCH, COCO14_IMAGES - start)
        target = (torch.rand((b, COCO14_LABELS), generator=gen, device="cuda") < COCO14_POSITIVES / COCO14_LABELS)
        logits = torch.randn((b, COCO14_LABELS), generator=gen, device="cuda") + 3.0 * target - 2.0
        scores = torch.sigmoid(logits).half().float()
        out.append((scores, target.to(torch.int32)))
    return out


def ranking_oracle(np, scores, target) -> dict:
    """float64 numpy Hamming distance, coverage error and LRAP (sklearn's
    definitions: max-tie ranks) and the ranking loss with tied pairs ordered
    by label index (the stable sort the JAX package and the port use); also
    sklearn's ranking loss, which counts every tied pair as misordered."""
    n, labels = scores.shape
    rel = target == 1
    hamming = 1.0 - ((scores >= 0.5) == rel).mean()
    coverage = lrap = lrl = lrl_sklearn = 0.0
    tied_rows = 0
    idx = np.arange(labels)
    for lo in range(0, n, 2048):
        s, r = scores[lo:lo + 2048].astype(np.float64), rel[lo:lo + 2048]
        ge = s[:, None, :] >= s[:, :, None]  # ge[i, a, b]: label b scores at least label a
        n_rel = r.sum(1)
        min_rel = np.where(r, s, np.inf).min(1)
        coverage += np.where(n_rel > 0, (s >= min_rel[:, None]).sum(1), 0).sum()
        rank_all = ge.sum(2)
        rank_rel = (ge & r[:, None, :]).sum(2)
        per = np.where(r, rank_rel / rank_all, 0.0).sum(1) / np.maximum(n_rel, 1)
        lrap += np.where((n_rel == 0) | (n_rel == labels), 1.0, per).sum()
        above = (s[:, None, :] > s[:, :, None]) | ((s[:, None, :] == s[:, :, None]) & (idx[None, None, :] > idx[None, :, None]))
        pair = r[:, :, None] & ~r[:, None, :]  # (relevant a, irrelevant b)
        valid = (n_rel > 0) & (n_rel < labels)
        denom = np.where(valid, n_rel * (labels - n_rel), 1)
        lrl += np.where(valid, (pair & above).sum((1, 2)) / denom, 0.0).sum()
        lrl_sklearn += np.where(valid, (pair & ge).sum((1, 2)) / denom, 0.0).sum()
        tied_rows += int((pair & (s[:, None, :] == s[:, :, None])).any((1, 2)).sum())
    return {"hamming": hamming, "coverage": coverage / n, "lrap": lrap / n, "lrl": lrl / n,
            "lrl_sklearn": lrl_sklearn / n, "tied_rows": tied_rows}


def phase_eight_c(torch, mt, np, smi) -> dict:
    """8(c): the multilabel and ranking path at MS-COCO 2014 val size."""
    stream = coco14_stream(torch)
    make = lambda c: ranking_collection(mt, c)  # noqa: E731
    run = eager_then_compiled(torch, "8(c)", make, feed_pair, stream)
    results = run["results"]
    view = run["compiled"].engine_stats()["partition"]
    for kind in ("update", "compute"):
        for key, entry in view[kind].items():
            check(entry["path"] == "fused", f"8(c): {key} {kind} path {entry}")
    scores = torch.cat([s for s, _ in stream]).cpu().numpy()
    target = torch.cat([t for _, t in stream]).cpu().numpy()
    oracle = ranking_oracle(np, scores, target)
    errors = {}
    for key in ("hamming", "coverage", "lrap", "lrl"):
        got = float(results[key])
        errors[key] = abs(got - oracle[key])
        check(math.isfinite(got) and errors[key] <= FLOAT64_ATOL, f"8(c): {key} {got} vs float64 {oracle[key]}")
    timing = timing_pairs(torch, make, feed_pair, stream)
    print_timing("8(c)", timing, smi, ops=True)
    print(f"phase 8(c): {len(stream)} updates ({COCO14_IMAGES} x {COCO14_LABELS}, {float(target.mean()) * COCO14_LABELS:.2f}"
          f" labels per image) of HammingDistance/CoverageError/LabelRankingAveragePrecision/LabelRankingLoss;"
          f" compiled states and 2 computes bitwise equal to eager (the ragged batch too); engine"
          f" {run['engines']['collection']}; "
          + ", ".join(f"{k} {float(results[k]):.7f} (float64 {oracle[k]:.7f}, error {errors[k]:.2e})" for k in errors)
          + f"; {oracle['tied_rows']} rows tie a relevant with an irrelevant label, where sklearn's ranking loss"
          f" counts the pair as misordered: {oracle['lrl_sklearn']:.7f}")
    return {"engines": run["engines"], "errors": errors, "values": {k: float(results[k]) for k in errors},
            "tied_rows": oracle["tied_rows"], "lrl_sklearn": oracle["lrl_sklearn"], "timing": timing_summary(timing)}


def phase_eight_d(torch, mt) -> dict:
    """8(d): a MeanMetric and a buffered CatMetric fed one batch with a NaN
    (the third, a replay when compiled): eager warns once and drops it,
    compiled masks it and CatMetric keeps 0.0, as in the JAX package."""
    import warnings

    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    stream = [torch.randn(NAN_WIDTH, generator=gen, device="cuda") for _ in range(NAN_BATCHES)]
    stream[NAN_AT][1] = float("nan")
    clean = torch.cat(stream)
    out = {}
    for compiled in (False, True):
        flags = engine_flags(compiled)
        mean, cat = mt.MeanMetric(**flags), mt.CatMetric(buffer_capacity=NAN_CAPACITY, **flags)
        warned = 0
        for x in stream:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                mean.update(x)
                cat.update(x)
            warned += sum("nan" in str(w.message) for w in rec)
        rows, value = cat.compute(), mean.compute()
        label = "compiled" if compiled else "eager"
        if compiled:
            want = torch.where(torch.isnan(clean), 0.0, clean)
            check(warned == 0 and torch.equal(rows, want), f"8(d) compiled: {warned} warnings, rows {rows.tolist()}")
            check(torch.equal(value, out["eager"]["mean"]), "8(d): the compiled mean differs from the eager one")
        else:
            check(warned == 2 and torch.equal(rows, clean[~torch.isnan(clean)]),
                  f"8(d) eager: {warned} warnings (one per metric expected), rows {rows.tolist()}")
        out[label] = {"mean": value, "rows": rows.numel(), "warnings": warned}
    print(f"phase 8(d): NaN in batch {NAN_AT + 1} of {NAN_BATCHES}: eager warned {out['eager']['warnings']} times"
          f" (once per metric) and CatMetric kept {out['eager']['rows']} rows; compiled warned"
          f" {out['compiled']['warnings']} times and kept {out['compiled']['rows']} rows with 0.0 for the NaN;"
          f" MeanMetric {float(out['eager']['mean']):.7f} both ways")
    return {k: {"rows": v["rows"], "warnings": v["warnings"]} for k, v in out.items()}


def imagenet_loss_stream(torch):
    """Phase 3's stream with a teacher's probabilities (a second seeded logit
    set at temperature 2) and the per-sample cross-entropy."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    out = []
    for logits, probs, target in batches(torch):
        teacher = torch.softmax(torch.randn(logits.shape, generator=gen, device="cuda") / KD_TEMPERATURE, dim=1)
        ce = torch.nn.functional.cross_entropy(logits, target, reduction="none")
        out.append((logits, probs, target, teacher, ce))
    return out


def phase_eight(torch, mt, np, kernels_mod, sync, smi) -> dict:
    t0 = time.perf_counter()
    stream = imagenet_loss_stream(torch)
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    out = {"a": phase_eight_a(torch, mt, np, sync, stream, smi), "b": phase_eight_b(torch, mt, stream, smi)}
    del stream
    out["c"] = phase_eight_c(torch, mt, np, smi)
    out["d"] = phase_eight_d(torch, mt)
    launches = kernels_mod.launch_counts()
    check(not any(launches.values()), f"phase 8 launched a kernel of B1-B3: {launches}")
    out["launches"] = launches
    elapsed = time.perf_counter() - t0
    print(f"phase 8 ({smi}): {elapsed:.1f} s in all (limit {PHASE8_LIMIT_S:.0f} s); kernel launches {launches}")
    check(elapsed < PHASE8_LIMIT_S, f"phase 8 took {elapsed:.1f} s, over its {PHASE8_LIMIT_S:.0f} s")
    out["seconds"] = elapsed
    return out


# --------------------------------------------------------------------------- #
# phase 9: regression, pairwise and retrieval (no kernel of B1-B3 on its path)
# --------------------------------------------------------------------------- #
# MS MARCO passage ranking, dev (small): 6,980 queries, 1,000 BM25 candidates
# each, about 1.07 relevant passages a query, BM25's recall@1000 0.857; the
# stream takes 1,745 of the queries (a quarter: route (i)'s per-query host
# loop over 6,980 took 19.9-33.5 s, cut so that phase 14 fits the script's
# limit)
MSMARCO_QUERIES, MSMARCO_CANDIDATES, MSMARCO_QUERIES_PER_UPDATE = 1_745, 1_000, 64
MSMARCO_RELEVANT, MSMARCO_RECALL_AT_1000, MSMARCO_RELEVANT_SCORE_SHIFT = 1.07, 0.857, 3.5
MSMARCO_MAX_QUERIES, MSMARCO_MAX_DOCS, MSMARCO_CAPACITY = 8_192, 1_024, 7_000_000
# NYU Depth v2 test split: 654 images of 480 x 640 depths, 0.5-10 m, stored in mm
NYU_IMAGES, NYU_HEIGHT, NYU_WIDTH, NYU_IMAGES_PER_UPDATE = 654, 480, 640, 8
NYU_NOISE = 0.1  # log-normal sigma of the predicted depth
SPEARMAN_IMAGES, SPEARMAN_IMAGES_PER_UPDATE = 16, 4
EMBEDDING_PAIRS, EMBEDDING_DIM, EMBEDDING_BATCH = 2_000, 1_024, 64  # phase 3c's WMT19 size
PAIRWISE_ROWS, PAIRWISE_DIM, MANHATTAN_ROWS, MANHATTAN_DIM = 4_096, 1_024, 1_024, 256
RETRIEVAL_ATOL = 1e-5  # tests/retrieval/test_option_grid.py:202
REGRESSION_RTOL = 1e-5
TWEEDIE_RTOL = 1e-4  # tests/regression/test_regression.py:103
PAIRWISE_ATOL = 1e-5  # tests/regression/test_pairwise.py:36
PHASE9_LIMIT_S = 420.0


def msmarco_stream(torch):
    """MS MARCO dev (small) size, query-major, 64 queries (64,000 rows) an
    update and a ragged last one: sparse query ids, 0 relevant passages
    for 14.3% of queries and 1 + Poisson(0.249) for the rest (1.07 on
    average), seeded scores with the relevant ones raised, rounded through
    float16 so that scores tie; the target is bool."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    q, c = MSMARCO_QUERIES, MSMARCO_CANDIDATES
    ids = torch.randperm(1_000_000, generator=gen, device="cuda")[:q].to(torch.int64)
    found = torch.rand(q, generator=gen, device="cuda") < MSMARCO_RECALL_AT_1000
    extra = torch.poisson(torch.full((q,), MSMARCO_RELEVANT / MSMARCO_RECALL_AT_1000 - 1.0, device="cuda"), generator=gen)
    n_rel = torch.where(found, 1 + extra.to(torch.int64), 0)
    # the first n_rel of a random order of the candidates are the relevant ones
    order = torch.argsort(torch.rand((q, c), generator=gen, device="cuda"), dim=1)
    relevant = torch.zeros((q, c), dtype=torch.bool, device="cuda")
    relevant.scatter_(1, order, torch.arange(c, device="cuda")[None, :].expand(q, c) < n_rel[:, None])
    scores = torch.randn((q, c), generator=gen, device="cuda") + MSMARCO_RELEVANT_SCORE_SHIFT * relevant
    scores = scores.half().float()
    out = []
    for lo in range(0, q, MSMARCO_QUERIES_PER_UPDATE):
        hi = min(q, lo + MSMARCO_QUERIES_PER_UPDATE)
        out.append((scores[lo:hi].reshape(-1), relevant[lo:hi].reshape(-1),
                    ids[lo:hi, None].expand(hi - lo, c).reshape(-1).contiguous()))
    return out, (scores, relevant)


def retrieval_metrics(mt, compiled_route: bool) -> dict:
    """The eight scalar retrieval metrics; the compiled route gives them
    static bounds and buffers."""
    kw = dict(max_queries=MSMARCO_MAX_QUERIES, max_docs_per_query=MSMARCO_MAX_DOCS,
              buffer_capacity=MSMARCO_CAPACITY) if compiled_route else {}
    return {
        "mrr": mt.RetrievalMRR(**kw),
        "map": mt.RetrievalMAP(**kw),
        "ndcg@10": mt.RetrievalNormalizedDCG(k=10, **kw),
        "p@10": mt.RetrievalPrecision(k=10, **kw),
        "r@100": mt.RetrievalRecall(k=100, **kw),
        "hit@10": mt.RetrievalHitRate(k=10, **kw),
        "r_precision": mt.RetrievalRPrecision(**kw),
        "fall_out@10": mt.RetrievalFallOut(k=10, **kw),
    }


def retrieval_oracle(np, scores, relevant) -> dict:
    """float64 numpy scores of every query (each has 1,000 candidates):
    the stable sort of the negated scores, as both packages rank; an empty
    query (no relevant passage) scores 0 ("neg"); none lacks a negative."""
    s, rel = scores.astype(np.float64), relevant.astype(np.float64)
    order = np.argsort(-s, axis=1, kind="stable")
    tt = np.take_along_axis(rel, order, axis=1)
    n_pos = tt.sum(1)
    has = n_pos > 0
    safe = np.maximum(n_pos, 1)
    pos = np.arange(1, tt.shape[1] + 1, dtype=np.float64)
    cs = np.cumsum(tt, axis=1)
    first = np.argmax(tt > 0, axis=1)
    gain = 1.0 / np.log2(np.arange(tt.shape[1], dtype=np.float64) + 2.0)
    ideal = -np.sort(-rel, axis=1)
    dcg, idcg = (tt[:, :10] * gain[:10]).sum(1), (ideal[:, :10] * gain[:10]).sum(1)
    in_r = np.arange(tt.shape[1])[None, :] < n_pos[:, None]
    n_neg = tt.shape[1] - n_pos
    per = {
        "mrr": np.where(has, 1.0 / (first + 1.0), 0.0),
        "map": np.where(has, (cs / pos * tt).sum(1) / safe, 0.0),
        "ndcg@10": np.where(has & (idcg > 0), dcg / np.where(idcg > 0, idcg, 1.0), 0.0),
        "p@10": np.where(has, tt[:, :10].sum(1) / 10.0, 0.0),
        "r@100": np.where(has, tt[:, :100].sum(1) / safe, 0.0),
        "hit@10": np.where(has, (tt[:, :10].sum(1) > 0).astype(np.float64), 0.0),
        "r_precision": np.where(has, (tt * in_r).sum(1) / safe, 0.0),
        "fall_out@10": (1.0 - tt[:, :10]).sum(1) / n_neg,
    }
    out = {k: float(v.mean()) for k, v in per.items()}
    k = np.arange(1, 101, dtype=np.float64)
    out["curve_precision"] = np.where(has[:, None], cs[:, :100] / k, 0.0).mean(0)
    out["curve_recall"] = np.where(has[:, None], cs[:, :100] / safe[:, None], 0.0).mean(0)
    out["n_empty"] = int((~has).sum())
    out["relevant_per_query"] = float(n_pos.mean())
    return out


def count_readbacks(torch, fn):
    """``fn()``'s result and the reads of device values to the host it made."""
    with ReadbackCounter(torch) as counter:
        out = fn()
    return out, counter.n


def _feed_retrieval(metrics, batch) -> None:
    preds, target, indexes = batch
    metrics.update(preds, target, indexes=indexes)


def phase_nine_a(torch, mt, np, smi) -> dict:
    """9(a): retrieval at MS MARCO dev (small) size, route (i) eager over
    list states, route (ii) compiled over buffers with static bounds."""
    stream, (scores, relevant) = msmarco_stream(torch)
    torch.cuda.synchronize()
    rows = MSMARCO_QUERIES * MSMARCO_CANDIDATES

    # route (i): list states, the per-query host loop
    route1 = mt.MetricCollection({
        **retrieval_metrics(mt, False),
        "curve": mt.RetrievalPrecisionRecallCurve(max_k=100),
        "r@p0.1": mt.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100),
    })
    step1 = []
    for preds, target, indexes in stream:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _feed_retrieval(route1, (preds, target, indexes))
        end.record()
        end.synchronize()
        step1.append(start.elapsed_time(end))
    view = route1.engine_stats()["partition"]
    for key, entry in view["update"].items():
        check(entry["path"] == "eager" and "unbounded list" in entry["reason"], f"9(a) route (i): {key} update {entry}")
    compute1_s, results1 = {}, {}
    for key, m in route1.items(keep_base=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results1[key] = m.compute()
        torch.cuda.synchronize()
        compute1_s[key] = time.perf_counter() - t0
    # the loop is the same in every member: MRR's readbacks, and its profile
    _, readbacks1 = count_readbacks(torch, lambda: compute_set({"mrr": route1["mrr"]}))
    mrr_prof = profile_window(torch, lambda: compute_set({"mrr": route1["mrr"]}), reps=1, warmup=False)
    report_profile("9(a) route (i) RetrievalMRR compute (the per-query host loop)", mrr_prof)
    from metrics_tpu_torch.utils.data import get_group_indexes

    _, grouping = count_readbacks(torch, lambda: get_group_indexes(torch.cat(route1["mrr"].indexes)))
    n_empty = int((relevant.sum(1) == 0).sum())
    # each query's target sum is read back, and a non-empty query's binary check
    per_query = MSMARCO_QUERIES + (MSMARCO_QUERIES - n_empty)
    check(readbacks1 >= per_query, f"9(a) route (i): {readbacks1} readbacks, fewer than the loop's {per_query}")

    # route (ii): buffers and static bounds, captured update and compute
    route2 = mt.MetricCollection(retrieval_metrics(mt, True))
    profiled = range(len(stream) - 12, len(stream) - 2)  # the profiler's warm-up and nine steps
    gc.collect()
    mem, step2 = [], []
    for i, (preds, target, indexes) in enumerate(stream):
        if i == profiled.start:
            batches = iter(stream[profiled.start:profiled.stop])
            update_prof = profile_window(torch, lambda: _feed_retrieval(route2, next(batches)), reps=len(profiled) - 1)
        if i in profiled:
            continue
        steady = 3 <= i < profiled.start
        if steady:
            mem.append(torch.cuda.memory_allocated())
            torch.cuda.set_sync_debug_mode("error")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        try:
            start.record()
            _feed_retrieval(route2, (preds, target, indexes))
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.synchronize()
        step2.append(start.elapsed_time(end))
    report_profile("9(a) route (ii) captured update step (eight metrics, one graph)", update_prof)
    check(len(set(mem)) == 1, f"9(a) route (ii): memory_allocated moved across the steady-state steps: {sorted(set(mem))}")
    sizes = [int(p.shape[0]) for p, _, _ in stream]
    sigs = [(i > 0, s) for i, s in enumerate(sizes)]  # the first update materializes the buffers
    engine = route2._update_engine
    counts = expected_engine_counts(sigs)
    check_engine("9(a) route (ii) update", engine.stats, counts, donated=counts["cache_hits"])
    check(engine.broken is None and all(step.graph is not None for step in engine._steps.values()),
          f"9(a) route (ii): update broken ({engine.broken}) or a step without a graph")
    # the buffers hold, bit for bit, what route (i)'s eager appends hold
    for key, m in route2.items(keep_base=True):
        for s in ("indexes", "preds", "target"):
            buf, lst = getattr(m, s), torch.cat(getattr(route1[key], s))
            check(len(buf) == rows and not buf.overflow_seen and buf.data.dtype == lst.dtype
                  and torch.equal(buf.data[:rows], lst), f"9(a): route (ii) {key}.{s} differs from route (i)'s appends")
    computes2, compute2_ms = [], []
    for n in range(6):  # the warmup (eager), the capture, four replays
        for m in route2.values():
            m._computed = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if n == 0:
            got, readbacks_eager2 = count_readbacks(torch, lambda: dict(route2.compute()))
        elif n == 5:
            got, readbacks_replay2 = count_readbacks(torch, lambda: dict(route2.compute()))
        else:
            got = dict(route2.compute())
        torch.cuda.synchronize()
        compute2_ms.append((time.perf_counter() - t0) * 1e3)
        computes2.append(got)
    stats = route2._compute_engine.stats if route2._compute_engine is not None else None
    check(stats is not None and stats.eager_calls == 1 and stats.cache_misses == 1 and stats.cache_hits == 4
          and not stats.fallback_reasons, f"9(a) route (ii): compute engine {stats}")
    for key, entry in route2.engine_stats()["partition"]["compute"].items():
        check(entry["path"] == "fused", f"9(a) route (ii): {key} compute {entry}")
    for n, got in enumerate(computes2[1:], start=2):
        for key, value in computes2[0].items():
            check(torch.equal(got[key], value), f"9(a) route (ii): compute {n} {key} differs from the eager warmup")
    check(readbacks_replay2 == 0, f"9(a) route (ii): a replayed compute read back {readbacks_replay2} values")
    compute_prof = profile_window(torch, lambda: compute_set(route2), reps=3)
    report_profile("9(a) route (ii) compute (eight metrics, one graph)", compute_prof)
    # each member alone, through its own compute engine: warmup, capture, then replays by events
    compute2_member_ms = {}
    for key, m in route2.items(keep_base=True):
        for _ in range(2):
            compute_set({key: m})
        compute2_member_ms[key] = time_ms(torch, lambda key=key, m=m: compute_set({key: m}), warmup=1, reps=5)
        check(m._compute_engine.stats.cache_misses == 1 and m._compute_engine.broken is None,
              f"9(a) route (ii): {key}'s own compute was not captured")

    # the float64 oracle, on the host
    t0 = time.perf_counter()
    oracle = retrieval_oracle(np, scores.cpu().numpy(), relevant.cpu().numpy())
    oracle_s = time.perf_counter() - t0
    check(oracle["n_empty"] == n_empty, "9(a): the oracle's empty queries differ")
    errors = {}
    for key in computes2[0]:
        a, b = float(results1[key]), float(computes2[0][key])
        errors[key] = max(abs(a - oracle[key]), abs(b - oracle[key]))
        check(math.isfinite(a) and math.isfinite(b) and abs(a - b) <= RETRIEVAL_ATOL,
              f"9(a): {key} route (i) {a} against route (ii) {b}")
        check(errors[key] <= RETRIEVAL_ATOL, f"9(a): {key} {a}, {b} against float64 {oracle[key]}")
    precision, recall, top_k = results1["curve"]
    curve_err = max(float(np.abs(precision.double().cpu().numpy() - oracle["curve_precision"]).max()),
                    float(np.abs(recall.double().cpu().numpy() - oracle["curve_recall"]).max()))
    check(curve_err <= RETRIEVAL_ATOL and torch.equal(top_k.cpu(), torch.arange(1, 101, dtype=torch.int32)),
          f"9(a): the precision-recall curve is {curve_err:.2e} from float64")
    best_recall, best_k = results1["r@p0.1"]
    qualify = oracle["curve_precision"] >= 0.1
    want_recall = float(oracle["curve_recall"][qualify].max()) if qualify.any() else 0.0
    check(abs(float(best_recall) - want_recall) <= RETRIEVAL_ATOL, f"9(a): recall at precision 0.1 {float(best_recall)}"
          f" against float64 {want_recall}")
    near = np.abs(oracle["curve_precision"] - 0.1) <= RETRIEVAL_ATOL  # where one rounding decides the k
    if not near.any():
        ties = np.flatnonzero(qualify & (oracle["curve_recall"] == want_recall)) + 1
        check(int(best_k) in ties.tolist() or int(best_k) == int(ties.max()), f"9(a): best k {int(best_k)}, float64 {ties}")

    # the bounds set too small: eager compute raises, a captured compute gives NaN
    small = mt.RetrievalMAP(max_queries=8, max_docs_per_query=512, buffer_capacity=4 * 64 * 1000)
    for preds, target, indexes in stream[:4]:  # 64 queries of 1,000 documents an update
        small.update(preds, target, indexes=indexes)
    try:
        small.compute()
        fail("9(a): compute() over too small bounds did not raise")
    except Exception as err:  # the port's MetricsUserError
        check("overflowed its static bounds" in str(err), f"9(a): compute over too small bounds raised {str(err)[:200]}")
    small._computed = None
    nan = small.compute()  # the engine's probe and capture: nothing read back, NaN
    check(bool(torch.isnan(nan)), f"9(a): the captured compute over too small bounds gave {float(nan)}, not NaN")
    del small

    step1_us = statistics.median(step1[3:-1]) * 1e3
    step2_us = statistics.median(step2[3:-1]) * 1e3
    print(f"phase 9(a) ({smi}): {len(stream)} updates ({MSMARCO_QUERIES} queries x {MSMARCO_CANDIDATES} candidates, "
          f"{oracle['relevant_per_query']:.3f} relevant a query, {n_empty} queries without one); update step route (i)"
          f" eager {step1_us:.1f} us, route (ii) captured {step2_us:.1f} us; route (ii) buffers bitwise equal to route"
          f" (i)'s appends, update engine {counts}, steady state with sync debug mode 'error', memory_allocated flat at"
          f" {mem[0]} bytes")
    print(f"phase 9(a) ({smi}): compute route (i) " + ", ".join(f"{k} {v:.2f} s" for k, v in compute1_s.items())
          + f" ({sum(compute1_s.values()):.1f} s in all); readbacks of MRR's compute {readbacks1} (the grouping alone"
          f" {grouping}, the loop {per_query}: 1 a query, 1 a non-empty query); route (ii) eight metrics in one graph:"
          f" eager warmup"
          f" {compute2_ms[0]:.1f} ms ({readbacks_eager2} readbacks), capture {compute2_ms[1]:.1f} ms, replays "
          + ", ".join(f"{v:.1f}" for v in compute2_ms[2:]) + f" ms ({readbacks_replay2} readbacks); each alone, replayed: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in compute2_member_ms.items())
          + f"; idle share route (ii) update {idle_share(update_prof)}, compute {idle_share(compute_prof)},"
          f" route (i) MRR compute {idle_share(mrr_prof)}")
    print("phase 9(a): " + ", ".join(f"{k} {float(results1[k]):.7f} / {float(computes2[0][k]):.7f} (float64"
                                     f" {oracle[k]:.7f}, error {errors[k]:.2e})" for k in errors)
          + f"; curve error {curve_err:.2e}; recall at precision 0.1 {float(best_recall):.7f} at k {int(best_k)};"
          f" too small bounds raise eager and give NaN captured; oracle {oracle_s:.1f} s")
    return {"update_step_us": {"route_i_eager": step1_us, "route_ii_captured": step2_us},
            "compute_s_route_i": compute1_s, "readbacks_route_i": readbacks1,
            "compute_ms_route_ii": compute2_ms, "readbacks_route_ii": {"eager": readbacks_eager2, "replay": readbacks_replay2},
            "compute_idle_route_ii": idle_share(compute_prof), "update_idle_route_ii": idle_share(update_prof),
            "compute_idle_route_i_mrr": idle_share(mrr_prof), "compute_ms_route_ii_members": compute2_member_ms, "errors": errors, "curve_error": curve_err,
            "values": {k: float(computes2[0][k]) for k in errors}, "engine": counts}


def nyu_stream(torch):
    """NYU Depth v2 test size as flat per-pixel vectors, 8 images (2,457,600
    depths) an update and a ragged last one of 6: targets in metres, uniform
    in 0.5-10 m and quantised to 1 mm as the dataset stores them;
    predictions the target times log-normal noise."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 110)
    pixels = NYU_HEIGHT * NYU_WIDTH
    out = []
    for lo in range(0, NYU_IMAGES, NYU_IMAGES_PER_UPDATE):
        n = min(NYU_IMAGES_PER_UPDATE, NYU_IMAGES - lo) * pixels
        target = torch.round((0.5 + 9.5 * torch.rand(n, generator=gen, device="cuda")) * 1000.0) / 1000.0
        preds = target * torch.exp(NYU_NOISE * torch.randn(n, generator=gen, device="cuda"))
        out.append((preds, target))
    return out


def depth_metrics(mt, compiled: bool):
    flags = engine_flags(compiled)
    return mt.MetricCollection(
        {
            "mse": mt.MeanSquaredError(**flags),
            "rmse": mt.MeanSquaredError(squared=False, **flags),
            "mae": mt.MeanAbsoluteError(**flags),
            "msle": mt.MeanSquaredLogError(**flags),
            "mape": mt.MeanAbsolutePercentageError(**flags),
            "smape": mt.SymmetricMeanAbsolutePercentageError(**flags),
            "wmape": mt.WeightedMeanAbsolutePercentageError(**flags),
            "r2": mt.R2Score(**flags),
            "explained_variance": mt.ExplainedVariance(**flags),
            "pearson": mt.PearsonCorrCoef(**flags),
            "tweedie": mt.TweedieDevianceScore(power=1.5, **flags),
        },
        **flags,
    )


def depth_oracle(np, stream) -> dict:
    """float64 results, summed chunk by chunk on the host."""
    eps = 1.17e-06
    acc = dict.fromkeys(("n", "se", "ae", "sle", "ape", "sape", "st", "stt", "sp", "spp", "spt", "sd", "sdd", "tw"), 0.0)
    for preds, target in stream:
        p, t = preds.cpu().numpy().astype(np.float64), target.cpu().numpy().astype(np.float64)
        d = t - p
        acc["n"] += p.size
        acc["se"] += (d * d).sum()
        acc["ae"] += np.abs(d).sum()
        acc["sle"] += ((np.log1p(p) - np.log1p(t)) ** 2).sum()
        acc["ape"] += (np.abs(d) / np.maximum(np.abs(t), eps)).sum()
        acc["sape"] += (np.abs(d) / np.maximum(np.abs(t) + np.abs(p), eps)).sum()
        acc["st"] += t.sum()
        acc["stt"] += (t * t).sum()
        acc["sp"] += p.sum()
        acc["spp"] += (p * p).sum()
        acc["spt"] += (p * t).sum()
        acc["sd"] += d.sum()
        acc["sdd"] += (d * d).sum()
        acc["tw"] += (2 * (np.maximum(t, 0) ** 0.5 / (-0.5 * 0.5) - t * p ** -0.5 / -0.5 + p ** 0.5 / 0.5)).sum()
    n = acc["n"]
    tss = acc["stt"] - acc["st"] ** 2 / n
    var_d = acc["sdd"] / n - (acc["sd"] / n) ** 2
    var_t = acc["stt"] / n - (acc["st"] / n) ** 2
    cov = acc["spt"] - acc["sp"] * acc["st"] / n
    return {
        "mse": acc["se"] / n, "rmse": math.sqrt(acc["se"] / n), "mae": acc["ae"] / n, "msle": acc["sle"] / n,
        "mape": acc["ape"] / n, "smape": 2 * acc["sape"] / n, "wmape": acc["ae"] / acc["st"],
        "r2": 1 - acc["se"] / tss, "explained_variance": 1 - var_d / var_t,
        "pearson": cov / math.sqrt((acc["spp"] - acc["sp"] ** 2 / n) * tss), "tweedie": acc["tw"] / n,
    }


def phase_nine_b(torch, mt, np, sync, stream, smi) -> dict:
    """9(b): per-pixel depth regression at NYU Depth v2 test size, eager then
    compiled, bitwise, against a float64 oracle."""
    make = lambda c: depth_metrics(mt, c)  # noqa: E731
    run = eager_then_compiled(torch, "9(b)", make, feed_pair, stream)
    results = run["results"]
    view = run["compiled"].engine_stats()["partition"]
    for kind in ("update", "compute"):
        for key, entry in view[kind].items():
            check(entry["path"] == "fused", f"9(b): {key} {kind} path {entry}")
    t0 = time.perf_counter()
    oracle = depth_oracle(np, stream)
    oracle_s = time.perf_counter() - t0
    errors = {}
    for key, value in oracle.items():
        got = float(results[key])
        errors[key] = abs(got - value) / abs(value)
        bound_ = TWEEDIE_RTOL if key == "tweedie" else REGRESSION_RTOL
        check(math.isfinite(got) and errors[key] <= bound_, f"9(b): {key} {got} vs float64 {value}")
    # synced in a world of one NCCL rank: Pearson's moments arrive stacked on a
    # rank axis of one, so compute() keeps the single-rank branch; bitwise
    import torch.distributed as dist

    eager = run["eager"]
    expected = {"all_reduce": 0, "all_gather": 0}
    for m in eager.values():
        reds = {(m._reductions[k], v.dtype) for k, v in m.get_state().items()}
        expected["all_reduce"] += sum(r in ("sum", "mean", "max", "min") for r, _ in reds)
        expected["all_gather"] += sum(r is None for r, _ in reds)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        for m in eager.values():
            m._computed = None
        with sync.count_collectives() as box, sync.sync_axes(dist.group.WORLD):
            synced = dict(eager.compute())
        check(box["by_kind"] == expected, f"9(b): synced compute ran {box['by_kind']}, expected {expected}")
        same_results(torch, "9(b) synced", synced, results)
    finally:
        dist.destroy_process_group()
    timing = timing_pairs(torch, make, feed_pair, stream)
    print_timing("9(b)", timing, smi, ops=True)
    print(f"phase 9(b): {len(stream)} updates ({NYU_IMAGES} x {NYU_HEIGHT} x {NYU_WIDTH} depths) of MSE, RMSE, MAE, MSLE,"
          f" MAPE, SMAPE, WMAPE, R2, explained variance, Pearson and Tweedie (power 1.5) in one collection; compiled"
          f" states and 2 computes bitwise equal to eager; update engine {run['engines']['collection']};"
          f" memory_allocated flat at {run['memory']} bytes; synced (world of one NCCL rank) {box['by_kind']}, bitwise; "
          + ", ".join(f"{k} {float(results[k]):.7f} (float64 {oracle[k]:.7f}, relative error {errors[k]:.2e})" for k in oracle)
          + f"; oracle {oracle_s:.1f} s")
    return {"engines": run["engines"], "errors": errors, "values": {k: float(results[k]) for k in oracle},
            "collectives": box["by_kind"], "timing": timing_summary(timing)}


def phase_nine_c(torch, mt, np, stream) -> dict:
    """9(c): Spearman over the first 16 images of 9(b) (mm-quantised targets
    tie heavily), list and buffered (captured appends), against scipy; the
    buffered CosineSimilarity over 2,000 x 1,024 embedding pairs."""
    from scipy.stats import spearmanr

    pixels = NYU_HEIGHT * NYU_WIDTH
    per = SPEARMAN_IMAGES_PER_UPDATE * pixels
    head = stream[: SPEARMAN_IMAGES // NYU_IMAGES_PER_UPDATE]
    preds, target = torch.cat([p for p, _ in head]), torch.cat([t for _, t in head])
    chunks = [(preds[lo:lo + per], target[lo:lo + per]) for lo in range(0, preds.numel(), per)]
    lists = mt.SpearmanCorrCoef(compiled_update=False)
    buffered = mt.SpearmanCorrCoef(buffer_capacity=SPEARMAN_IMAGES * pixels)
    for i, (p, t) in enumerate(chunks):
        lists.update(p, t)
        if i >= 3:
            torch.cuda.set_sync_debug_mode("error")
        try:
            buffered.update(p, t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check_engine("9(c) buffered Spearman update", buffered._update_engine.stats,
                 expected_engine_counts([(i > 0, per) for i in range(len(chunks))]))
    for s in ("preds", "target"):
        check(torch.equal(getattr(buffered, s).to_array(), torch.cat(getattr(lists, s))),
              f"9(c): the buffered Spearman {s} rows differ from the list's")
    got_list, got_buf = lists.compute(), buffered.compute()
    check(torch.equal(got_list, got_buf), "9(c): buffered and list Spearman differ")
    t0 = time.perf_counter()
    want = float(spearmanr(preds.cpu().numpy(), target.cpu().numpy())[0])
    scipy_s = time.perf_counter() - t0
    spearman_err = abs(float(got_list) - want)
    check(spearman_err <= REGRESSION_RTOL, f"9(c): Spearman {float(got_list)} against scipy {want}")
    distinct = int(torch.unique(target).numel())

    gen = torch.Generator(device="cuda").manual_seed(SEED + 120)
    a = torch.randn((EMBEDDING_PAIRS, EMBEDDING_DIM), generator=gen, device="cuda")
    b = a + 0.75 * torch.randn((EMBEDDING_PAIRS, EMBEDDING_DIM), generator=gen, device="cuda")
    cos_list = mt.CosineSimilarity(reduction="mean", compiled_update=False)
    cos_buf = mt.CosineSimilarity(reduction="mean", buffer_capacity=EMBEDDING_PAIRS)
    for lo in range(0, EMBEDDING_PAIRS, EMBEDDING_BATCH):
        for m in (cos_list, cos_buf):
            m.update(a[lo:lo + EMBEDDING_BATCH], b[lo:lo + EMBEDDING_BATCH])
    sizes = [min(EMBEDDING_BATCH, EMBEDDING_PAIRS - lo) for lo in range(0, EMBEDDING_PAIRS, EMBEDDING_BATCH)]
    check_engine("9(c) buffered CosineSimilarity update", cos_buf._update_engine.stats,
                 expected_engine_counts([(i > 0, s) for i, s in enumerate(sizes)]))
    cos_value = cos_buf.compute()
    check(torch.equal(cos_value, cos_list.compute()), "9(c): buffered and list CosineSimilarity differ")
    ad, bd = a.double(), b.double()
    cos_want = float(((ad * bd).sum(1) / (ad.norm(dim=1) * bd.norm(dim=1))).mean())
    cos_err = abs(float(cos_value) - cos_want)
    check(cos_err <= REGRESSION_RTOL, f"9(c): CosineSimilarity {float(cos_value)} against float64 {cos_want}")
    print(f"phase 9(c): Spearman over {SPEARMAN_IMAGES} images ({preds.numel()} depths, {distinct} distinct targets),"
          f" list and buffered (captured appends, rows bitwise equal) {float(got_list):.7f}, scipy {want:.7f}"
          f" (error {spearman_err:.2e}, scipy {scipy_s:.1f} s); CosineSimilarity (mean) over {EMBEDDING_PAIRS} x"
          f" {EMBEDDING_DIM} pairs, list and buffered bitwise, {float(cos_value):.7f}, float64 {cos_want:.7f}"
          f" (error {cos_err:.2e})")
    return {"spearman": float(got_list), "spearman_error": spearman_err, "distinct_targets": distinct,
            "cosine": float(cos_value), "cosine_error": cos_err}


def phase_nine_d(torch, mt, smi) -> dict:
    """9(d): the pairwise matrices with TF32 off against float64 on the card:
    unit-normalised embeddings (cosine, linear, euclidean at 4,096 x 4,096,
    D = 1,024), within 1e-5; Manhattan's (N, M, D) broadcast at 1,024 x
    1,024, D = 256, whose distances are about 18, within 1e-5 of each
    value's magnitude."""
    from metrics_tpu_torch import ops

    check(not torch.backends.cuda.matmul.allow_tf32, "9(d): TF32 is on")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 130)
    out = {}
    for name, rows, dim in (("cosine", PAIRWISE_ROWS, PAIRWISE_DIM), ("linear", PAIRWISE_ROWS, PAIRWISE_DIM),
                            ("euclidean", PAIRWISE_ROWS, PAIRWISE_DIM), ("manhattan", MANHATTAN_ROWS, MANHATTAN_DIM)):
        x = torch.nn.functional.normalize(torch.randn((rows, dim), generator=gen, device="cuda"), dim=1)
        y = torch.nn.functional.normalize(torch.randn((rows, dim), generator=gen, device="cuda"), dim=1)
        fn = getattr(ops, f"pairwise_{name}_{'similarity' if name in ('cosine', 'linear') else 'distance'}")
        got = fn(x, y)
        xd, yd = x.double(), y.double()
        if name == "manhattan":
            want = (xd[:, None, :] - yd[None, :, :]).abs().sum(-1)
        elif name == "euclidean":
            want = torch.cdist(xd, yd)
        else:
            want = xd @ yd.T
            if name == "cosine":
                want = want / (xd.norm(dim=1)[:, None] * yd.norm(dim=1)[None, :])
        err = (got.double() - want).abs()
        scale = want.abs().clamp(min=1.0) if name == "manhattan" else 1.0
        worst = float((err / scale).max())
        check(got.shape == (rows, rows) and bool(torch.isfinite(got).all()) and worst <= PAIRWISE_ATOL,
              f"9(d): pairwise {name} is {worst:.2e} from float64")
        ms = time_ms(torch, lambda: fn(x, y), warmup=2, reps=5)
        out[name] = {"max_err": worst, "ms": ms, "shape": [rows, rows, dim]}
        del got, want, err
    print(f"phase 9(d) ({smi}): TF32 off; " + ", ".join(
        f"{k} {tuple(v['shape'])} {v['ms']:.3f} ms, {'relative ' if k == 'manhattan' else ''}error {v['max_err']:.2e}"
        for k, v in out.items()))
    return out


def phase_nine(torch, mt, np, kernels_mod, sync, smi) -> dict:
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    out = {"a": phase_nine_a(torch, mt, np, smi)}
    gc.collect()
    stream = nyu_stream(torch)
    out["b"] = phase_nine_b(torch, mt, np, sync, stream, smi)
    out["c"] = phase_nine_c(torch, mt, np, stream)
    del stream
    gc.collect()
    out["d"] = phase_nine_d(torch, mt, smi)
    launches = kernels_mod.launch_counts()
    check(not any(launches.values()), f"phase 9 launched a kernel of B1-B3: {launches}")
    out["launches"] = launches
    elapsed = time.perf_counter() - t0
    print(f"phase 9 ({smi}): {elapsed:.1f} s in all (limit {PHASE9_LIMIT_S:.0f} s); kernel launches {launches}")
    check(elapsed < PHASE9_LIMIT_S, f"phase 9 took {elapsed:.1f} s, over its {PHASE9_LIMIT_S:.0f} s")
    out["seconds"] = elapsed
    return out


# --------------------------------------------------------------------------- #
# phase 10: the wrappers and the text metrics other than BERTScore
# --------------------------------------------------------------------------- #
BOOT_REPLICAS = 100
BOOT_QUANTILES = (0.025, 0.975)
WRAPPER_ATOL = 1e-6
TRACKER_EPOCHS = 5
NORMALS_HOLES = 0.05  # share of NaN pixels in the target normals
TEXT_ATOL = 1e-6
VOCAB_SIZE, ZIPF_S = 20_000, 1.1
# LibriSpeech test-clean: 2,620 utterances, 52,576 words
LIBRI_UTTERANCES, LIBRI_WORDS, ASR_EDIT_RATE, ASR_PER_UPDATE = 2620, 52_576, 0.05, 64
ASR_CHAR_CHECK = 256
# WMT19 de-en newstest2019: 2,000 segments, one reference each
WMT_SEGMENTS, WMT_MEAN_WORDS, MT_EDIT_RATE, MT_PER_UPDATE = 2000, 22, 0.30, 64
# CNN/DailyMail test: 11,490 summaries of 3-4 sentences
CNNDM_SUMMARIES, SUMMARY_PER_UPDATE = 11_490, 64
# SQuAD v1.1 dev: 10,570 questions with 1-3 gold answers
SQUAD_QUESTIONS, SQUAD_PER_UPDATE = 10_570, 256
PHASE10_LIMIT_S = 300.0


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bits (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.is_floating_point():
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(width), b.view(width))
    return torch.equal(a, b)


def event_ms(torch, fn):
    """``fn()``'s result and its time by CUDA events, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def imagenet_probs(torch, np):
    """Phase 3's stream as (probs, target) on the card, and each batch's
    argmax and labels on the host (from the same float32 probabilities)."""
    stream, host = [], []
    for _, probs, target in batches(torch):
        stream.append((probs, target))
        host.append((probs.cpu().numpy().argmax(axis=1), target.cpu().numpy()))
    return stream, host


def boot_oracle(np, host, seed: int, strategy: str):
    """Each replica's correct and seen rows, redrawn in numpy from the seed
    with the calls, in the order, that both packages make."""
    rng = np.random.default_rng(seed)
    correct = np.zeros(BOOT_REPLICAS, dtype=np.int64)
    seen = np.zeros(BOOT_REPLICAS, dtype=np.int64)
    for argmax, label in host:
        size = len(label)
        for r in range(BOOT_REPLICAS):
            if strategy == "poisson":
                rows = np.repeat(np.arange(size), rng.poisson(1, size=size))
            else:
                rows = rng.integers(0, size, size=size)
            correct[r] += int(np.sum(argmax[rows] == label[rows]))
            seen[r] += len(rows)
    return correct, seen


def bootstrap_run(torch, mt, np, stream, host, strategy: str, smi: str) -> dict:
    """10(a): BootStrapper(Accuracy(1000 classes), 100 replicas) over the
    ImageNet-size stream: each replica's counts against the numpy redraw,
    bit for bit; mean, std and quantiles within 1e-6 of float64 from ``raw``;
    the update step by events, its device operations by the profiler."""
    seed = SEED + 210
    boot = mt.BootStrapper(mt.Accuracy(num_classes=N_CLASSES), num_bootstraps=BOOT_REPLICAS,
                           quantile=list(BOOT_QUANTILES), raw=True, seed=seed, sampling_strategy=strategy)
    times = []
    for probs, target in stream[:-4]:
        times.append(event_ms(torch, lambda: boot.update(probs, target))[1])
    steps = iter(stream[-4:])
    prof = profile_window(torch, lambda: boot.update(*next(steps)), reps=3)  # the first call is the warm-up
    torch.cuda.synchronize()
    correct, seen = boot_oracle(np, host, seed, strategy)
    tp = boot.tp.cpu().numpy()
    check(boot._vmapped and boot._vmap_update is True, f"10(a) bootstrap {strategy}: the replicas did not advance by vmap")
    check(np.array_equal(tp, correct), f"10(a) bootstrap {strategy}: replica counts differ from the numpy redraw")
    check(np.array_equal(tp + boot.fn.cpu().numpy(), seen), f"10(a) bootstrap {strategy}: replica row counts differ")
    out, compute_ms = event_ms(torch, boot.compute)
    raw = out["raw"].double().cpu().numpy()
    check(np.max(np.abs(raw - correct / seen)) <= WRAPPER_ATOL, f"10(a) bootstrap {strategy}: raw values")
    want = {"mean": raw.mean(), "std": raw.std(ddof=1), "quantile": np.quantile(raw, BOOT_QUANTILES)}
    errs = {k: float(np.max(np.abs(out[k].double().cpu().numpy() - v))) for k, v in want.items()}
    check(all(e <= WRAPPER_ATOL for e in errs.values()), f"10(a) bootstrap {strategy}: {errs} against float64")
    device_ops = sum(prof["recorded"].values()) / 3
    step_ms = statistics.median(times)
    print(f"phase 10(a) ({smi}): BootStrapper(Accuracy, {BOOT_REPLICAS} replicas, {strategy}) counts bitwise against the"
          f" numpy redraw; mean {float(out['mean']):.6f} std {float(out['std']):.6f} quantiles"
          f" {[round(float(q), 6) for q in out['quantile']]}, errors {errs}; update step {step_ms:.3f} ms"
          f" (median of {len(times)}), {device_ops:.1f} device operations per update, compute {compute_ms:.3f} ms")
    report_profile(f"BootStrapper {strategy} update", prof)
    return {"update_ms": step_ms, "device_ops": device_ops, "compute_ms": compute_ms, "errors": errs,
            "idle": idle_share(prof)}


def classwise_run(torch, mt, stream, smi: str) -> dict:
    wrapped = mt.ClasswiseWrapper(mt.Accuracy(num_classes=N_CLASSES, average=None))
    plain = mt.Accuracy(num_classes=N_CLASSES, average=None)
    for probs, target in stream:
        wrapped.update(probs, target)
        plain.update(probs, target)
    got, want = wrapped.compute(), plain.compute()
    check(list(got) == [f"accuracy_{i}" for i in range(N_CLASSES)], "10(a) ClasswiseWrapper: keys")
    check(same_bits(torch, torch.stack(list(got.values())), want), "10(a) ClasswiseWrapper: values differ from Accuracy's")
    print(f"phase 10(a) ({smi}): ClasswiseWrapper(Accuracy(average=None)): {len(got)} values bitwise equal to Accuracy's")
    return {"classes": len(got)}


def minmax_run(torch, mt, stream, smi: str) -> dict:
    wrapped = mt.MinMaxMetric(mt.Accuracy(num_classes=N_CLASSES))
    plain = mt.Accuracy(num_classes=N_CLASSES)
    lo = hi = None
    for probs, target in stream:
        out = wrapped(probs, target)
        value = plain(probs, target)
        lo = value if lo is None else torch.minimum(lo, value)
        hi = value if hi is None else torch.maximum(hi, value)
        check(same_bits(torch, out["raw"], value) and same_bits(torch, out["min"], lo) and same_bits(torch, out["max"], hi),
              "10(a) MinMaxMetric: a forward's raw, min or max differs from the plain Accuracy's")
    print(f"phase 10(a) ({smi}): MinMaxMetric(Accuracy) forward per batch bitwise: min {float(lo):.6f}, max {float(hi):.6f}")
    return {"min": float(lo), "max": float(hi)}


def tracker_collection(mt):
    return mt.MetricCollection([mt.Accuracy(num_classes=N_CLASSES), mt.F1Score(num_classes=N_CLASSES, average="macro")])


def tracker_run(torch, mt, np, stream, smi: str) -> dict:
    """Five epochs of the stream, each with a seeded share (1-10%) of its rows
    replaced by noise, through a MetricTracker and five separate collections."""
    shares = np.random.default_rng(SEED + 220).uniform(0.01, 0.10, TRACKER_EPOCHS)
    tracker = mt.MetricTracker(tracker_collection(mt), maximize=True)
    separate = []
    for epoch, share in enumerate(shares):
        tracker.increment()
        separate.append(tracker_collection(mt))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 221 + epoch)
        for probs, target in stream:
            b = probs.shape[0]
            noisy = torch.rand(b, generator=gen, device="cuda") < float(share)
            noise = torch.softmax(torch.randn((b, N_CLASSES), generator=gen, device="cuda"), dim=1)
            batch = torch.where(noisy[:, None], noise, probs)
            tracker.update(batch, target)
            separate[-1].update(batch, target)
    best, step = tracker.best_metric(return_step=True)
    results = [c.compute() for c in separate]
    every = tracker.compute_all()
    for key in results[0]:
        values = np.asarray([float(r[key]) for r in results])
        i = int(np.nanargmax(values))
        check(best[key] == float(values[i]) and step[key] == i, f"10(a) MetricTracker: best {key} differs")
        check(same_bits(torch, every[key], torch.stack([r[key] for r in results])), f"10(a) MetricTracker: {key} per epoch")
    print(f"phase 10(a) ({smi}): MetricTracker over {TRACKER_EPOCHS} epochs (noise shares "
          f"{[round(float(s), 4) for s in shares]}): best {best} at steps {step}, equal to five separate collections")
    return {"best": best, "step": step}


def normals_stream(torch):
    """Per-pixel surface normals at NYU Depth v2 test size (654 images of
    480 x 640, 8 an update): unit target normals with NaN holes in about 5%
    of the pixels, predictions the target plus noise, renormalised."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 230)
    pixels = NYU_HEIGHT * NYU_WIDTH
    out = []
    for lo in range(0, NYU_IMAGES, NYU_IMAGES_PER_UPDATE):
        n = min(NYU_IMAGES_PER_UPDATE, NYU_IMAGES - lo) * pixels
        target = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device="cuda"), dim=1)
        preds = torch.nn.functional.normalize(target + 0.2 * torch.randn((n, 3), generator=gen, device="cuda"), dim=1)
        holes = torch.rand(n, generator=gen, device="cuda") < NORMALS_HOLES
        target[holes] = float("nan")
        out.append((preds, target))
    return out


def multioutput_run(torch, mt, np, smi: str) -> dict:
    """MultioutputWrapper(MeanSquaredError(), 3 outputs) on the normals:
    states bitwise equal to three MSE metrics fed the NaN-filtered columns,
    results within 1e-5 relative of float64, reads to the host counted."""
    stream = normals_stream(torch)
    wrapped = mt.MultioutputWrapper(mt.MeanSquaredError(), num_outputs=3)
    times, readbacks = [], 0
    for preds, target in stream:
        with ReadbackCounter(torch) as counter:
            times.append(event_ms(torch, lambda: wrapped.update(preds, target))[1])
        readbacks += counter.n
    plain = [mt.MeanSquaredError() for _ in range(3)]
    sums, counts = np.zeros(3), np.zeros(3)
    for preds, target in stream:
        keep = torch.nonzero(~(torch.isnan(preds).any(1) | torch.isnan(target).any(1))).squeeze(1)
        for i, metric in enumerate(plain):
            p, t = preds[keep, i], target[keep, i]
            metric.update(p, t)
            sums[i] += float(((p.double() - t.double()) ** 2).sum())
            counts[i] += p.numel()
    for i, (child, metric) in enumerate(zip(wrapped.metrics, plain)):
        for key, value in metric.get_state().items():
            check(same_bits(torch, child.get_state()[key], value), f"10(a) MultioutputWrapper: output {i} state {key}")
    got, compute_ms = event_ms(torch, wrapped.compute)
    want = sums / counts
    rel = float(np.max(np.abs(got.double().cpu().numpy() - want) / want))
    check(rel <= REGRESSION_RTOL, f"10(a) MultioutputWrapper: {rel:.2e} relative from float64")
    check(readbacks == 3 * len(stream), f"10(a) MultioutputWrapper: {readbacks} reads to the host for {len(stream)} updates")
    step_ms = statistics.median(times)
    print(f"phase 10(a) ({smi}): MultioutputWrapper(MSE, 3 outputs) over {len(stream)} updates of up to"
          f" {NYU_IMAGES_PER_UPDATE * NYU_HEIGHT * NYU_WIDTH:,} normals: states bitwise, {rel:.2e} relative from float64,"
          f" {readbacks} reads to the host ({readbacks / len(stream):.0f} an update); update {step_ms:.3f} ms, compute"
          f" {compute_ms:.3f} ms")
    return {"update_ms": step_ms, "compute_ms": compute_ms, "readbacks": readbacks, "rel_err": rel}


def phase_ten_a(torch, mt, np, smi: str) -> dict:
    stream, host = imagenet_probs(torch, np)
    out = {f"bootstrap_{s}": bootstrap_run(torch, mt, np, stream, host, s, smi) for s in ("poisson", "multinomial")}
    out["classwise"] = classwise_run(torch, mt, stream, smi)
    out["minmax"] = minmax_run(torch, mt, stream, smi)
    out["tracker"] = tracker_run(torch, mt, np, stream, smi)
    del stream, host
    gc.collect()
    out["multioutput"] = multioutput_run(torch, mt, np, smi)
    gc.collect()
    return out


# ---- 10(b): text
def zipf_words(np, rng):
    """A seeded vocabulary of letter strings and its Zipf rank probabilities."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < VOCAB_SIZE:
        words.add("".join(rng.choice(letters, int(rng.integers(2, 11)))))
    words = sorted(words)
    rng.shuffle(words)
    p = 1.0 / np.arange(1, VOCAB_SIZE + 1) ** ZIPF_S
    return words, p / p.sum()


def lengths_with_total(np, rng, n: int, total: int):
    lens = np.maximum(1, rng.poisson(total / n, n))
    while lens.sum() != total:
        i = int(rng.integers(0, n))
        if lens.sum() < total:
            lens[i] += 1
        elif lens[i] > 1:
            lens[i] -= 1
    return lens


class Corpus:
    """Seeded references from a Zipf vocabulary, and hypotheses made from them
    by seeded substitutions, deletions and insertions (3:1:1)."""

    def __init__(self, np, seed: int):
        self.np = np
        self.rng = np.random.default_rng(seed)
        self.words, self.p = zipf_words(np, self.rng)

    def draw(self, n: int):
        return [self.words[i] for i in self.rng.choice(VOCAB_SIZE, size=n, p=self.p)]

    def perturb(self, words, rate: float):
        out = []
        u = self.rng.random(len(words))
        fresh = iter(self.draw(len(words)))
        for w, x in zip(words, u):
            if x < rate * 0.6:
                out.append(next(fresh))
            elif x < rate * 0.8:
                continue
            elif x < rate:
                out.extend([w, next(fresh)])
            else:
                out.append(w)
        return out

    def pairs(self, lengths, rate: float):
        hyps, refs = [], []
        for n in lengths:
            ref = self.draw(int(n))
            refs.append(" ".join(ref))
            hyps.append(" ".join(self.perturb(ref, rate)))
        return hyps, refs


def text_states(torch, metric) -> dict:
    """A text metric's states on the host, a list state stacked."""
    out = {}
    for key, value in metric.get_state().items():
        if isinstance(value, list):
            value = torch.stack(value) if value else torch.zeros(0)
        out[key] = value.detach().cpu()
    return out


def leaves_of(torch, result) -> list:
    if isinstance(result, dict):
        return [x for k in sorted(result) for x in leaves_of(torch, result[k])]
    if isinstance(result, (list, tuple)):
        return [x for v in result for x in leaves_of(torch, v)]
    return [result.detach().double().cpu()]


def card_against_cpu(torch, label: str, make, feed, chunks, smi: str) -> dict:
    """One metric (or collection) on the card and its twin on the CPU fed the
    same chunks: states bit for bit, results within 1e-6; the card's update
    time per chunk (host clock, the work being on the host) and compute."""
    card, cpu = make(None), make("cpu")
    times = []
    for chunk in chunks:
        t0 = time.perf_counter()
        feed(card, chunk)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        feed(cpu, chunk)
    members = card.items(keep_base=True) if hasattr(card, "compute_groups") else [(label, card)]
    twins = dict(cpu.items(keep_base=True)) if hasattr(cpu, "compute_groups") else {label: cpu}
    for key, metric in members:
        got, want = text_states(torch, metric), text_states(torch, twins[key])
        check(set(got) == set(want), f"10(b) {label}: state names")
        for s, v in want.items():
            check(same_bits(torch, got[s], v), f"10(b) {label}: {key} state {s} differs from the CPU twin's")
    t0 = time.perf_counter()
    result = card.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    got, want = leaves_of(torch, result), leaves_of(torch, cpu.compute())
    err = max(float((g - w).abs().max()) if g.numel() else 0.0 for g, w in zip(got, want))
    check(len(got) == len(want) and err <= TEXT_ATOL and all(bool(torch.isfinite(g).all()) for g in got),
          f"10(b) {label}: results {err:.2e} from the CPU twin's")
    shown = result if not isinstance(result, dict) else {k: round(float(v), 6) for k, v in result.items()}
    print(f"phase 10(b) ({smi}): {label}: states bitwise equal to the CPU twin's, results within {err:.1e};"
          f" update {statistics.median(times):.3f} ms per chunk (median of {len(times)}), compute {compute_ms:.3f} ms;"
          f" {shown if isinstance(shown, dict) else round(float(shown), 6)}")
    return {"update_ms": statistics.median(times), "compute_ms": compute_ms, "err": err}


def chunked(seq, size: int):
    return [seq[i : i + size] for i in range(0, len(seq), size)]


def asr_phase(torch, mt, np, smi: str) -> dict:
    """LibriSpeech test-clean size: 2,620 utterances, 52,576 words, about 5%
    word edits, 64 utterances an update through WER, CER, MER, WIL and WIP."""
    from metrics_tpu_torch.ops.text import helper

    corpus = Corpus(np, SEED + 300)
    lengths = lengths_with_total(np, corpus.rng, LIBRI_UTTERANCES, LIBRI_WORDS)
    hyps, refs = corpus.pairs(lengths, ASR_EDIT_RATE)
    chunks = list(zip(chunked(hyps, ASR_PER_UPDATE), chunked(refs, ASR_PER_UPDATE)))

    # the scan on the card against the pure-Python DP: every utterance's words, the first 256's characters
    word_dist, char_dist = [], []
    for h, r in chunks:
        word_dist.append(helper.batch_edit_distances([x.split() for x in h], [x.split() for x in r], "cuda").cpu())
    for h, r in zip(chunked(hyps[:ASR_CHAR_CHECK], ASR_PER_UPDATE), chunked(refs[:ASR_CHAR_CHECK], ASR_PER_UPDATE)):
        char_dist.append(helper.batch_edit_distances([list(x) for x in h], [list(x) for x in r], "cuda").cpu())
    want_words = [helper._edit_distance_host(h.split(), r.split()) for h, r in zip(hyps, refs)]
    want_chars = [helper._edit_distance_host(list(h), list(r)) for h, r in zip(hyps[:ASR_CHAR_CHECK], refs[:ASR_CHAR_CHECK])]
    check(torch.cat(word_dist).tolist() == want_words, "10(b) edit distance (words) differs from the pure-Python DP")
    check(torch.cat(char_dist).tolist() == want_chars, "10(b) edit distance (characters) differs from the pure-Python DP")
    word_edits = sum(want_words) / LIBRI_WORDS

    def make(device):
        kw = {} if device is None else {"device": device}
        return mt.MetricCollection({"wer": mt.WordErrorRate(**kw), "cer": mt.CharErrorRate(**kw),
                                    "mer": mt.MatchErrorRate(**kw), "wil": mt.WordInfoLost(**kw),
                                    "wip": mt.WordInfoPreserved(**kw)})

    run = card_against_cpu(torch, "ASR collection (WER, CER, MER, WIL, WIP)", make,
                           lambda m, c: m.update(*c), chunks, smi)

    # the scan alone, per 64-utterance batch: events, device operations, bound
    h, r = chunks[0]
    name = torch.cuda.get_device_name(0)
    scan = {}
    for form, split in (("words", str.split), ("characters", list)):
        enc = helper.encode_token_batch([split(x) for x in h], [split(x) for x in r], torch.device("cuda"))
        b, p = enc[0].shape
        width = enc[2].shape[1]
        ms = time_ms(torch, lambda enc=enc: helper.edit_distance_batch(*enc))
        cpu_enc = [t.cpu() for t in enc]
        plain_ms = host_ms(lambda: helper.edit_distance_batch(*cpu_enc), reps=5)
        prof = profile_window(torch, lambda enc=enc: helper.edit_distance_batch(*enc), reps=5)
        bound_ms, bound_by = bound(b * (p + 1) * (width + 1) * 4, 0, name)
        scan[form] = {"shape": [b, p, width], "ms": ms, "plain_cpu_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "device_ops": sum(prof["recorded"].values()) / 5,
                      "device_us": sum(prof["device_us"].values()), "idle": idle_share(prof),
                      "cummin_us": sum(us for k, us in prof["device_us"].items() if "cummin" in k.lower() or "scan" in k.lower())}
        print(f"phase 10(b) ({smi}): edit_distance_batch, {form}, (B, P, R) = {(b, p, width)}: {ms * 1e3:.1f} us/call"
              f" (device busy {scan[form]['device_us']:.1f} us, of it the cummin scans {scan[form]['cummin_us']:.1f} us;"
              f" {scan[form]['device_ops']:.0f} device operations per call), the same code on the host CPU"
              f" {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by})")
        report_profile(f"edit_distance_batch {form}", prof)
    print(f"  ASR corpus: {LIBRI_UTTERANCES} utterances, {LIBRI_WORDS} words, word edit distance {word_edits:.4f} a word;"
          f" scan bitwise against the pure-Python DP on every utterance (words) and the first {ASR_CHAR_CHECK} (characters)")
    return {**run, "scan": scan, "word_edit_share": word_edits}


def mt_phase(torch, mt, np, smi: str) -> dict:
    """WMT19 de-en newstest2019 size: 2,000 segments, one reference each,
    about 30% word edits, through BLEU, SacreBLEU (13a), chrF++, TER and EED."""
    corpus = Corpus(np, SEED + 310)
    lengths = np.maximum(1, corpus.rng.poisson(WMT_MEAN_WORDS, WMT_SEGMENTS))
    hyps, refs = corpus.pairs(lengths, MT_EDIT_RATE)
    hyps = [h[:1].upper() + h[1:] + "." for h in hyps]  # a capital and a full stop for the tokenizers
    refs = [r[:1].upper() + r[1:] + "." for r in refs]
    targets = [[r] for r in refs]
    out = {}
    chunks = list(zip(chunked(hyps, MT_PER_UPDATE), chunked(targets, MT_PER_UPDATE)))
    for label, cls, kw in (("BLEUScore", mt.BLEUScore, {}), ("SacreBLEUScore", mt.SacreBLEUScore, {"tokenize": "13a"}),
                           ("CHRFScore", mt.CHRFScore, {}), ("TranslationEditRate", mt.TranslationEditRate, {}),
                           ("ExtendedEditDistance", mt.ExtendedEditDistance, {})):
        out[label] = card_against_cpu(torch, label, lambda d, cls=cls, kw=kw: cls(**kw) if d is None else cls(device=d, **kw),
                                      lambda m, c: m.update(*c), chunks, smi)
    return out


def rouge_phase(torch, mt, np, smi: str) -> dict:
    """CNN/DailyMail test size: 3-4 sentence summaries with about 30% word
    edits, ROUGE-1/2/L/Lsum with the regex sentence splitter."""
    from metrics_tpu_torch.ops.text import rouge as rouge_ops

    check(not rouge_ops._punkt_available(), "10(b) ROUGE: expected the regex splitter (no punkt data on the card's host)")
    corpus = Corpus(np, SEED + 320)
    hyps, refs = [], []
    for _ in range(CNNDM_SUMMARIES):
        sentences = int(corpus.rng.integers(3, 5))
        h, r = corpus.pairs(corpus.rng.integers(8, 22, sentences), MT_EDIT_RATE)
        hyps.append(" ".join(s.capitalize() + "." for s in h))
        refs.append(" ".join(s.capitalize() + "." for s in r))
    chunks = list(zip(chunked(hyps, SUMMARY_PER_UPDATE), chunked(refs, SUMMARY_PER_UPDATE)))
    return card_against_cpu(torch, "ROUGEScore", lambda d: mt.ROUGEScore() if d is None else mt.ROUGEScore(device=d),
                            lambda m, c: m.update(*c), chunks, smi)


def squad_phase(torch, mt, np, smi: str) -> dict:
    """SQuAD v1.1 dev size: 10,570 questions with 1-3 gold answers; the
    predictions copy a gold answer (with case, punctuation and article
    noise), overlap one, or miss."""
    corpus = Corpus(np, SEED + 330)
    rng = corpus.rng
    preds, targets = [], []
    for q in range(SQUAD_QUESTIONS):
        answers = [" ".join(corpus.draw(int(rng.integers(1, 6)))) for _ in range(int(rng.integers(1, 4)))]
        u = rng.random()
        if u < 0.6:
            pred = "The " + answers[0].title() + "."
        elif u < 0.85:
            pred = " ".join(answers[-1].split()[:1] + corpus.draw(2))
        else:
            pred = " ".join(corpus.draw(int(rng.integers(1, 6))))
        qid = f"q{q:05d}"
        preds.append({"prediction_text": pred, "id": qid})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": qid})
    chunks = list(zip(chunked(preds, SQUAD_PER_UPDATE), chunked(targets, SQUAD_PER_UPDATE)))
    return card_against_cpu(torch, "SQuAD", lambda d: mt.SQuAD() if d is None else mt.SQuAD(device=d),
                            lambda m, c: m.update(*c), chunks, smi)


def phase_ten(torch, mt, np, kernels_mod, smi) -> dict:
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    out = {"a": phase_ten_a(torch, mt, np, smi)}
    out["seconds_a"] = time.perf_counter() - t0
    out["asr"] = asr_phase(torch, mt, np, smi)
    out["mt"] = mt_phase(torch, mt, np, smi)
    out["rouge"] = rouge_phase(torch, mt, np, smi)
    out["squad"] = squad_phase(torch, mt, np, smi)
    launches = kernels_mod.launch_counts()
    check(not any(launches.values()), f"phase 10 launched a kernel of B1-B3: {launches}")
    out["launches"] = launches
    elapsed = time.perf_counter() - t0
    print(f"phase 10 ({smi}): {elapsed:.1f} s in all (wrappers {out['seconds_a']:.1f} s; limit {PHASE10_LIMIT_S:.0f} s);"
          f" kernel launches {launches}")
    check(elapsed < PHASE10_LIMIT_S, f"phase 10 took {elapsed:.1f} s, over its {PHASE10_LIMIT_S:.0f} s")
    out["seconds"] = elapsed
    return out


# --------------------------------------------------------------------------- #
# phase 11: the rest of detection (host lists, segm) and the sketches
# --------------------------------------------------------------------------- #
PHASE11_LIMIT_S = 240.0
# LVIS v1 evaluates up to 300 detections an image (its maxDets)
LVIS_DETS, LVIS_IMAGES = 300, 500
# COCO val2017 images are 640 x 480; 500 of its 5,000 images, since 100
# dense 480 x 640 bool masks an image hold 31 MB on the card (16.5 GB for 500)
SEGM_IMAGES = 500
SEGM_CHECK_IMAGES = 8
SYNC_MAP_IMAGES = 64  # images of each list-route mAP synced in 11(e): five gather rounds an image
SKETCH_ITEMS, SKETCH_BATCH, SKETCH_CPU_BATCHES, SKETCH_TIMED_BATCHES = 100_000_000, 1 << 20, 8, 24
SKETCH_QUANTILES = (0.5, 0.9, 0.99, 0.999)
DISTINCT_KEYS = 10_000_000
GPT2_VOCAB, ZIPF_S = 50_257, 1.1  # GPT-2's vocabulary; Zipf's exponent of token frequencies
HEAVY = dict(threshold=0.001, max_hitters=64, domain_bits=16)
AUROC_SKETCH_SCORES = 10_000_000
AUROC_SKETCH_ATOL = 5e-3  # tests/sketches/test_sketch_metrics.py:111
# a quantile-sketch bucket index is float32 arithmetic on log(|x|): two
# correct float32 pipelines (the card's, the CPU's) may put a value one
# bucket apart only where its exact position lies within a few float32 ulps
# of an integer; 2**-21 relative is four of them
BOUNDARY_RTOL = 2.0 ** -21


def map_chunks(sizes) -> int:
    """Chunks the list routes hand to the kernels: images with a detection
    or a ground truth grouped by their (pd, pg) bucket (a count of 0 takes
    the smallest, 8), 256 at a time."""
    def bucket(n):
        size = 8
        while size < n:
            size *= 2
        return size

    buckets = {}
    for n_det, n_gt in sizes:
        if n_det or n_gt:
            key = (bucket(n_det), bucket(n_gt))
            buckets[key] = buckets.get(key, 0) + 1
    return sum(math.ceil(v / 256) for v in buckets.values())


def stream_sizes(stream):
    return [(len(p["scores"]), len(t["labels"])) for preds, targets in stream for p, t in zip(preds, targets)]


def timed_compute(torch, metric, map_mod, chunk_attr: str):
    """compute() with its split: the chunk evaluations (kernels, synchronised
    after each), the fetches to the host, the rest of the evaluation (host
    prep) and the curve math (``_calculate``), in seconds; and the per-image
    evaluations ``_calculate`` read."""
    split = {"chunks_s": 0.0, "fetch_s": 0.0, "eval_s": 0.0}
    evals = []
    chunk_fn, fetch_fn, eval_fn = getattr(metric, chunk_attr), map_mod._fetch_chunk, metric._evaluate_images

    def chunk(*args, **kwargs):
        t0 = time.perf_counter()
        out = chunk_fn(*args, **kwargs)
        torch.cuda.synchronize()
        split["chunks_s"] += time.perf_counter() - t0
        return out

    def fetch(*args, **kwargs):
        t0 = time.perf_counter()
        fetch_fn(*args, **kwargs)
        split["fetch_s"] += time.perf_counter() - t0

    def evaluate(*args, **kwargs):
        t0 = time.perf_counter()
        out = eval_fn(*args, **kwargs)
        split["eval_s"] += time.perf_counter() - t0
        evals.append(out)
        return out

    setattr(metric, chunk_attr, chunk)
    metric._evaluate_images = evaluate
    map_mod._fetch_chunk = fetch
    try:
        metric._computed = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = metric.compute()
        torch.cuda.synchronize()
        split["compute_s"] = time.perf_counter() - t0
    finally:
        map_mod._fetch_chunk = fetch_fn
        del metric._evaluate_images
        delattr(metric, chunk_attr)
    split["host_prep_s"] = split["eval_s"] - split["chunks_s"] - split["fetch_s"]
    split["calculate_s"] = split["compute_s"] - split["eval_s"]
    return results, split, evals[0]


def same_evals(np, label: str, got: list, want: list) -> None:
    """Per-image evaluations (what ``_calculate`` reads) bit for bit."""
    check(len(got) == len(want), f"{label}: {len(got)} images against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{label}: image {i} evaluated on one side only")
        if w is not None:
            for key, value in w.items():
                check(g[key].dtype == value.dtype and g[key].shape == value.shape
                      and np.array_equal(g[key].view(np.uint8), value.view(np.uint8)), f"{label}: image {i} {key} differs")


def same_map_results(torch, label: str, got: dict, want: dict) -> None:
    check(set(got) == set(want), f"{label}: result keys differ")
    for key, value in want.items():
        check(got[key].dtype == value.dtype and got[key].shape == value.shape and torch.equal(got[key], value),
              f"{label}: result {key} differs")


def phase_eleven_a(torch, mt, np, kernels_mod, coco, map_results, smi) -> dict:
    """11(a): phase 3b's stream through the host-list bbox route."""
    from metrics_tpu_torch.detection import mean_ap as map_mod

    metric = mt.MeanAveragePrecision(device_state=False, class_metrics=True)
    check(not metric.supports_compiled_update, "11(a): the list route must not capture its update")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for preds, targets in coco:
            metric.update(preds, targets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    n_chunks = map_chunks(stream_sizes(coco))
    kernels_mod.reset_launch_counts()
    results, split, evals = timed_compute(torch, metric, map_mod, "_evaluate_bbox_chunk")
    launches = kernels_mod.launch_counts()
    for kname in DETECTION_KERNELS:
        check(launches[kname] == n_chunks, f"11(a): {kname} launched {launches[kname]} times for {n_chunks} bucket chunks")
    same_map_results(torch, "11(a) host-list route against phase 3b's device-state route", results, map_results)
    # the plain run's evaluations: _calculate is a deterministic function of
    # them, so equal evaluations give equal results (its 20 s stay unspent)
    metric._plain_kernels = True
    kernels_mod.reset_launch_counts()
    evals_plain = metric._evaluate_images(metric._get_classes())
    check(not any(kernels_mod.launch_counts().values()), "11(a): the plain run launched a kernel")
    same_evals(np, "11(a) kernels against their plain versions", evals_plain, evals)
    metric._plain_kernels = False
    print(f"phase 11(a) ({smi}): host-list bbox route, {COCO_IMAGES} images in {len(coco)} updates of {COCO_BATCH}"
          f" with synchronisation forbidden: {update_s:.2f} s; compute {split['compute_s']:.2f} s (host prep"
          f" {split['host_prep_s']:.2f} s, device evaluation {split['chunks_s']:.2f} s in {n_chunks} bucket chunks,"
          f" fetch {split['fetch_s']:.2f} s, _calculate {split['calculate_s']:.2f} s); launches {launches} (one of each"
          " per chunk); every result bitwise equal to phase 3b's device-state route; every image's evaluation (what"
          " _calculate reads) bitwise equal to the plain-kernel run's")
    return {"metric": metric, "results": results, "update_s": update_s, "split": split, "chunks": n_chunks,
            "launches": launches}


def phase_eleven_b(torch, mt, kernels_mod, smi) -> dict:
    """11(b): 300 detections an image: the list route keeps them all."""
    import warnings

    stream, _ = coco_stream(torch, n=LVIS_IMAGES, d=LVIS_DETS, seed=SEED + 31)
    routes = {
        "list": mt.MeanAveragePrecision(device_state=False, class_metrics=True),
        "device_512": mt.MeanAveragePrecision(class_metrics=True, detections_capacity=512, compiled_update=False),
        "device_128": mt.MeanAveragePrecision(class_metrics=True, compiled_update=False),
    }
    caught = {}
    for key, metric in routes.items():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for preds, targets in stream:
                metric.update(preds, targets)
        caught[key] = sum("detections_capacity" in str(w.message) for w in seen)
    check(caught == {"list": 0, "device_512": 0, "device_128": LVIS_IMAGES},
          f"11(b): capacity warnings {caught}, expected one per image of the default device route only")
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    results = {key: metric.compute() for key, metric in routes.items()}
    compute_s = time.perf_counter() - t0
    launches = kernels_mod.launch_counts()
    n_chunks = map_chunks(stream_sizes(stream)) + 2 * math.ceil(LVIS_IMAGES / 256)
    for kname in DETECTION_KERNELS:
        check(launches[kname] == n_chunks, f"11(b): {kname} launched {launches[kname]} times, expected {n_chunks}")
    same_map_results(torch, "11(b) list route against device_state with detections_capacity=512", results["list"],
                     results["device_512"])
    differs = [k for k, v in results["list"].items() if not torch.equal(v, results["device_128"][k])]
    check(differs, "11(b): the list route equals the default capacity of 128, which keeps only 128 detections")
    print(f"phase 11(b) ({smi}): {LVIS_IMAGES} images at {LVIS_DETS} detections (LVIS maxDets): list route bitwise equal"
          f" to device_state=True with detections_capacity=512; the default capacity of 128 warned {caught['device_128']}"
          f" times and differs in {len(differs)} results ({', '.join(differs[:4])}...); three computes {compute_s:.2f} s;"
          f" launches {launches}")
    return {"metric": routes["list"], "results": results["list"], "launches": launches, "compute_s": compute_s}


def ellipse_masks(torch, boxes):
    """(n, 480, 640) bool: the ellipse inscribed in each xyxy box, as a mask
    head would draw an object, on the card."""
    ys = torch.arange(int(COCO_H), device=boxes.device, dtype=torch.float32)[None, :, None] + 0.5
    xs = torch.arange(int(COCO_W), device=boxes.device, dtype=torch.float32)[None, None, :] + 0.5
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    rx = ((x2 - x1) / 2).clamp(min=0.5)
    ry = ((y2 - y1) / 2).clamp(min=0.5)
    return ((xs - (x1 + x2) / 2) / rx) ** 2 + ((ys - (y1 + y2) / 2) / ry) ** 2 <= 1.0


def segm_stream(torch, np, rle):
    """500 COCO-size images with masks: detections dense bool on the card,
    ground truths compressed RLE strings made by the port's rle_encode from
    the seeded masks (COCO annotations' format)."""
    boxes_stream, _ = coco_stream(torch, n=SEGM_IMAGES, seed=SEED + 37)
    stream, gt_dense, encode_s = [], [], 0.0
    for preds, targets in boxes_stream:
        sp, st = [], []
        for p, t in zip(preds, targets):
            sp.append({"masks": ellipse_masks(torch, p["boxes"]), "scores": p["scores"], "labels": p["labels"]})
            gt = ellipse_masks(torch, t["boxes"])
            host = gt.cpu().numpy()
            t0 = time.perf_counter()
            st.append({"masks": [rle.rle_encode(m) for m in host], "labels": t["labels"]})
            encode_s += time.perf_counter() - t0
            if len(gt_dense) < SEGM_CHECK_IMAGES:
                gt_dense.append(gt)
        stream.append((sp, st))
    return stream, gt_dense, encode_s


def phase_eleven_c(torch, mt, np, kernels_mod, smi) -> dict:
    """11(c): segm at COCO val2017 image size, 500 images."""
    from metrics_tpu_torch.detection import mean_ap as map_mod
    from metrics_tpu_torch.ops.detection import boxes as box_ops
    from metrics_tpu_torch.ops.detection import rle

    t0 = time.perf_counter()
    stream, gt_dense, encode_s = segm_stream(torch, np, rle)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    n_gt = sum(len(t["labels"]) for _, targets in stream for t in targets)
    metric = mt.MeanAveragePrecision(iou_type="segm", class_metrics=True)
    check(not metric.device_state, "11(c): segm must be host-listed")
    decode = {"s": 0.0}
    decode_fn = map_mod.masks_from_rle_list

    def timed_decode(*args, **kwargs):
        t1 = time.perf_counter()
        out = decode_fn(*args, **kwargs)
        decode["s"] += time.perf_counter() - t1
        return out

    map_mod.masks_from_rle_list = timed_decode
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for preds, targets in stream:
            metric.update(preds, targets)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    finally:
        map_mod.masks_from_rle_list = decode_fn
    # mask_iou on the first images against float64 numpy, counts exact
    worst = 0.0
    for i in range(SEGM_CHECK_IMAGES):
        det, gt = metric.detections[i], metric.groundtruths[i]
        check(torch.equal(gt, gt_dense[i]), f"11(c): image {i}'s RLE ground truths do not decode to their masks")
        got = box_ops.mask_iou(det, gt).cpu().numpy()
        d64 = det.reshape(det.shape[0], -1).cpu().numpy().astype(np.float64)
        g64 = gt.reshape(gt.shape[0], -1).cpu().numpy().astype(np.float64)
        inter = d64 @ g64.T
        union = d64.sum(1)[:, None] + g64.sum(1)[None, :] - inter
        want32 = np.where(union > 0, inter.astype(np.float32) / np.where(union > 0, union, 1).astype(np.float32), 0)
        check(np.array_equal(got.view(np.uint32), want32.astype(np.float32).view(np.uint32)),
              f"11(c): image {i}: mask_iou is not float32(intersection) / float32(union) of the exact counts")
        worst = max(worst, float(np.abs(got - np.where(union > 0, inter / np.where(union > 0, union, 1), 0)).max()))
    # compute, with its split: mask IoU, the matcher, the curve math
    split = {"mask_iou_s": 0.0, "matcher_s": 0.0}
    iou_fn, match_fn = map_mod.mask_iou, map_mod.evaluate_given_ious

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t1
            return out
        return wrapped

    map_mod.mask_iou, map_mod.evaluate_given_ious = timed(iou_fn, "mask_iou_s"), timed(match_fn, "matcher_s")
    n_chunks = map_chunks([(len(p["scores"]), len(t["labels"])) for preds, targets in stream
                           for p, t in zip(preds, targets)])
    try:
        kernels_mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        results, csplit, _ = timed_compute(torch, metric, map_mod, "_evaluate_segm_chunk")
        peak = torch.cuda.max_memory_allocated()
    finally:
        map_mod.mask_iou, map_mod.evaluate_given_ious = iou_fn, match_fn
    launches = kernels_mod.launch_counts()
    check(launches["greedy_match"] == n_chunks and launches["pairwise_iou"] == 0,
          f"11(c): launches {launches}, expected the matcher once per each of {n_chunks} chunks and no box IoU")
    for key, value in results.items():
        check(bool(torch.isfinite(value).all()), f"11(c): result {key} is not finite")
    check(0.0 < float(results["map"]) < 1.0, f"11(c): map {float(results['map'])} is not in (0, 1)")
    metric._plain_kernels = True
    metric._computed = None
    plain = metric.compute()
    metric._plain_kernels = False
    same_map_results(torch, "11(c) matcher kernel against its plain version", plain, results)
    state_gb = sum(x.numel() for x in metric.detections + metric.groundtruths) / 1e9
    print(f"phase 11(c) ({smi}): segm, {SEGM_IMAGES} images of 480 x 640 (cut from COCO val2017's 5,000 for device memory),"
          f" {n_gt} RLE ground truths: made in {make_s:.1f} s (RLE encode {encode_s:.1f} s); update {update_s:.2f} s"
          f" (RLE decode {decode['s']:.2f} s); state {state_gb:.2f} GB of masks on the card; compute"
          f" {csplit['compute_s']:.2f} s (host prep {csplit['host_prep_s']:.2f} s; {n_chunks} chunks"
          f" {csplit['chunks_s']:.2f} s: mask IoU {split['mask_iou_s']:.2f} s, sort, flags and matcher"
          f" {split['matcher_s']:.2f} s, padding the rest; fetch {csplit['fetch_s']:.2f} s; _calculate"
          f" {csplit['calculate_s']:.2f} s); peak memory_allocated"
          f" {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the state); launches {launches};"
          f" results bitwise equal to the plain-matcher run; mask_iou on {SEGM_CHECK_IMAGES} images exact"
          f" (within {worst:.1e} of float64); map {float(results['map']):.6f}")
    return {"metric": metric, "results": results, "launches": launches, "update_s": update_s, "decode_s": decode["s"],
            "split": {**csplit, **split}, "peak_gb": peak / 1e9, "chunks": n_chunks}


def sketch_streams(torch):
    """The sketches' streams on the card, in batches of 2**20: lognormal
    float32 values with 1% zeros and 0.1% NaN/+inf/-inf; int32 keys drawn
    from 10,000,000 distinct values; Zipf(1.1) token ids over GPT-2's
    vocabulary (ranks mapped to ids by a seeded permutation); and 10,000,000
    binary scores for AUROC (40% positives, scores N(0.35, 0.15) shifted by
    0.25 for positives, clipped to [1e-4, 1])."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    n = SKETCH_ITEMS
    values = torch.empty(n, device="cuda").log_normal_(0.0, 1.0, generator=gen)
    u = torch.rand(n, generator=gen, device="cuda")
    values = torch.where(u < 0.01, torch.zeros((), device="cuda"), values)
    for lo, special in ((0.01, math.nan), (0.01 + 1e-3 / 3, math.inf), (0.01 + 2e-3 / 3, -math.inf)):
        values = torch.where((u >= lo) & (u < lo + 1e-3 / 3), torch.full((), special, device="cuda"), values)
    del u
    draw = torch.randint(0, DISTINCT_KEYS, (n,), generator=gen, device="cuda", dtype=torch.int32)
    keys = (draw.to(torch.int64) * 2654435761) & 0xFFFFFFFF  # a bijection of the 32-bit words
    keys = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)
    del draw
    ranks = torch.arange(1, GPT2_VOCAB + 1, device="cuda", dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -ZIPF_S, dim=0)
    cdf = cdf / cdf[-1]
    perm = torch.randperm(GPT2_VOCAB, generator=gen, device="cuda")
    tokens = torch.empty(n, device="cuda", dtype=torch.int32)
    for start in range(0, n, 1 << 24):  # float64 draws in slices, to bound the temporaries
        u64 = torch.rand(min(1 << 24, n - start), generator=gen, device="cuda", dtype=torch.float64)
        tokens[start : start + u64.numel()] = perm[torch.searchsorted(cdf, u64).clamp(max=GPT2_VOCAB - 1)].to(torch.int32)
    m = AUROC_SKETCH_SCORES
    target = (torch.rand(m, generator=gen, device="cuda") < 0.4).to(torch.int32)
    scores = (0.35 + 0.15 * torch.randn(m, generator=gen, device="cuda") + 0.25 * target).clamp(1e-4, 1.0)
    cut = lambda x: list(torch.split(x, SKETCH_BATCH))  # noqa: E731
    stream = list(zip(cut(values), cut(keys), cut(tokens)))
    return stream, list(zip(cut(scores), cut(target))), (values, keys, tokens, scores, target)


def sketch_metrics(mt, compiled: bool, device=None) -> dict:
    flags = dict(compiled_update=compiled, compiled_compute=compiled) if not compiled else {}
    return {
        "quantile": mt.Quantile(q=list(SKETCH_QUANTILES), device=device, **flags),
        "median": mt.Median(device=device, **flags),
        "distinct_p12": mt.DistinctCount(precision=12, device=device, **flags),
        "distinct_p18": mt.DistinctCount(precision=18, device=device, **flags),
        "heavy": mt.HeavyHitters(**HEAVY, device=device, **flags),
    }


def feed_sketches(metrics: dict, batch) -> None:
    values, keys, tokens = batch
    for name, metric in metrics.items():
        metric.update(values if name in ("quantile", "median") else keys if name.startswith("distinct") else tokens)


def feed_auroc(metrics: dict, batch) -> None:
    metrics["auroc"].update(*batch)


def exact_auroc(torch, scores, target) -> float:
    """The exact AUROC in float64 on the card: the Mann-Whitney statistic
    with mid-ranks for ties."""
    order = torch.argsort(scores)
    s, t = scores[order], target[order]
    _, inverse, counts = torch.unique_consecutive(s, return_inverse=True, return_counts=True)
    ends = torch.cumsum(counts, dim=0).to(torch.float64)
    ranks = ((ends - counts + 1 + ends) / 2)[inverse]
    n_pos = float(t.sum())
    n_neg = t.numel() - n_pos
    return float((ranks[t == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def boundary_check(torch, np, card_sketch, cpu_sketch, values_card, values_cpu, label: str) -> dict:
    """A quantile sketch on the card against its CPU twin: the values whose
    bucket differs, each within BOUNDARY_RTOL of a boundary in float64, and
    the count differences exactly theirs."""
    idx_card = card_sketch.bucket_index(values_card).cpu()
    idx_cpu = cpu_sketch.bucket_index(values_cpu)
    x = values_cpu
    counted = torch.isfinite(x) & (torch.abs(x) >= card_sketch.min_magnitude)
    differ = (idx_card != idx_cpu) & counted
    diff_vals = x[differ].to(torch.float64).numpy()
    pos = np.log(np.abs(diff_vals) / card_sketch.min_magnitude) / card_sketch._log_ratio
    dist = np.abs(pos - np.round(pos))
    limit = BOUNDARY_RTOL * np.maximum(np.abs(pos), 1.0)
    worst = float(dist.max()) if dist.size else 0.0
    check(bool((dist <= limit).all()), f"{label}: a value one bucket over lies {worst:.2e} from a boundary")
    for comp, sign in (("pos", x > 0), ("neg", x < 0)):
        sel = differ & sign
        b = card_sketch.num_buckets
        want = (torch.bincount(idx_card[sel], minlength=b) - torch.bincount(idx_cpu[sel], minlength=b)).to(torch.int64)
        got = getattr(card_sketch, comp).cpu().to(torch.int64) - getattr(cpu_sketch, comp).to(torch.int64)
        check(torch.equal(got, want), f"{label}: the {comp} counts differ by more than the boundary values")
    return {"values": int(differ.sum()), "max_distance": worst}


def sketch_vs_cpu(torch, np, mt, stream, auroc_stream) -> dict:
    """11(d): the states after the first 8 batches on the card against a
    device="cpu" twin's: bitwise, the quantile counts by the boundary rule."""
    card, cpu = sketch_metrics(mt, False), sketch_metrics(mt, False, device="cpu")
    card["auroc"] = mt.AUROC(approx="sketch", compiled_update=False, compiled_compute=False)
    cpu["auroc"] = mt.AUROC(approx="sketch", compiled_update=False, compiled_compute=False, device="cpu")
    part, apart = stream[:SKETCH_CPU_BATCHES], auroc_stream[:SKETCH_CPU_BATCHES]
    for batch in part:
        feed_sketches({k: v for k, v in card.items() if k != "auroc"}, batch)
        feed_sketches({k: v for k, v in cpu.items() if k != "auroc"}, tuple(x.cpu() for x in batch))
    for batch in apart:
        feed_auroc(card, batch)
        feed_auroc(cpu, tuple(x.cpu() for x in batch))
    values_card = torch.cat([b[0] for b in part])
    values_cpu = values_card.cpu()
    scores_card = torch.cat([s for s, _ in apart])
    target_cpu = torch.cat([t for _, t in apart]).cpu()
    report = {}
    for name, metric in card.items():
        for state, sk in metric.get_state().items():
            twin = cpu[name].get_state()[state]
            for comp, value in sk.components().items():
                other = getattr(twin, comp)
                if comp in ("pos", "neg") and not torch.equal(value.cpu(), other):
                    continue  # the boundary rule, below
                check(same_bits(torch, value, other), f"11(d): {name}.{state}.{comp} differs from the CPU twin's")
            if hasattr(sk, "bucket_index"):
                if name == "auroc":
                    is_pos = (target_cpu == 1) if state == "pos_scores" else (target_cpu != 1)
                    vc = torch.where(is_pos.to(scores_card.device), scores_card, math.nan)
                    report[f"{name}.{state}"] = boundary_check(torch, np, sk, twin, vc, vc.cpu(), f"11(d) {name}.{state}")
                else:
                    report[f"{name}.{state}"] = boundary_check(torch, np, sk, twin, values_card, values_cpu,
                                                               f"11(d) {name}.{state}")
    return report


def phase_eleven_d(torch, mt, np, kernels_mod, smi) -> dict:
    """11(d): the sketches over 100,000,000 items, compiled against eager."""
    t0 = time.perf_counter()
    stream, auroc_stream, (values, keys, tokens, scores, target) = sketch_streams(torch)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    run = eager_then_compiled(torch, "11(d) sketches", lambda c: sketch_metrics(mt, c), feed_sketches, stream)
    arun = eager_then_compiled(torch, "11(d) AUROC sketch",
                               lambda c: {"auroc": mt.AUROC(approx="sketch", **({} if c else dict(
                                   compiled_update=False, compiled_compute=False)))},
                               feed_auroc, auroc_stream)
    res, eager = run["results"], run["eager"]
    # oracles over the whole stream
    host = values.cpu().numpy()
    finite = host[np.isfinite(host)].astype(np.float64)
    exact_q = np.quantile(finite, SKETCH_QUANTILES, method="inverted_cdf")
    got_q = res["quantile"].cpu().numpy().astype(np.float64)
    rel = np.abs(got_q - exact_q) / np.abs(exact_q)
    check(bool((rel <= eager["quantile"].sketch.relative_accuracy).all()), f"11(d): quantiles {got_q} vs {exact_q}")
    check(same_bits(torch, res["median"], res["quantile"][0]), "11(d): Median differs from Quantile(q=0.5)")
    distinct = int(torch.unique(keys).numel())
    for p in (12, 18):
        est = float(res[f"distinct_p{p}"])
        sigma = 1.04 / math.sqrt(1 << p)
        check(abs(est - distinct) <= 4 * sigma * distinct, f"11(d): DistinctCount(p={p}) {est} vs {distinct}")
    true_counts = torch.bincount(tokens, minlength=GPT2_VOCAB).cpu().numpy().astype(np.int64)
    n = SKETCH_ITEMS
    cut = math.ceil(HEAVY["threshold"] * n)
    heavy_keys = set(np.flatnonzero(true_counts >= cut).tolist())
    sk = eager["heavy"].sketch
    all_keys, all_counts = sk.heavy_hitters(HEAVY["threshold"], max_hitters=4096)
    found = {int(k): int(c) for k, c in zip(all_keys, all_counts) if k >= 0}
    slack = 2 * n / sk.width
    check(heavy_keys <= set(found), f"11(d): true heavy hitters missed: {sorted(heavy_keys - set(found))[:8]}")
    check(all(true_counts[k] <= c <= true_counts[k] + slack for k, c in found.items()),
          "11(d): a heavy-hitter estimate is below its true count or above it by more than 2N/width")
    top = res["heavy"]
    check(top["keys"].tolist() == all_keys[: HEAVY["max_hitters"]].tolist(), "11(d): compute() is not the descent's top 64")
    auroc_exact = exact_auroc(torch, scores, target)
    auroc_got = float(arun["results"]["auroc"])
    check(abs(auroc_got - auroc_exact) <= AUROC_SKETCH_ATOL, f"11(d): sketch AUROC {auroc_got} vs exact {auroc_exact}")
    boundary = sketch_vs_cpu(torch, np, mt, stream, auroc_stream)
    # the update step and compute, per metric, by events and the profiler
    timing = {}
    for name in ("quantile", "distinct_p12", "distinct_p18", "heavy"):
        make = lambda c, name=name: {name: sketch_metrics(mt, c)[name]}  # noqa: E731
        timing[name] = timing_summary(timing_pairs(torch, make, feed_sketches, stream[:SKETCH_TIMED_BATCHES]))
    timing["auroc"] = timing_summary(timing_pairs(  # the full batches twice: the timing needs 15 steps
        torch, lambda c: {"auroc": mt.AUROC(approx="sketch", **({} if c else dict(compiled_update=False, compiled_compute=False)))},
        feed_auroc, auroc_stream[:-1] * 2))
    print(f"phase 11(d) ({smi}): {SKETCH_ITEMS:,} items in {len(stream)} batches of up to {SKETCH_BATCH:,} (made in"
          f" {made_s:.1f} s); compiled states bitwise equal to eager, steady state with no synchronisation and flat"
          f" memory_allocated; engines {run['engines']}")
    print(f"  quantiles {dict(zip(SKETCH_QUANTILES, got_q.tolist()))} within {rel.max():.2e} relative of numpy's"
          f" float64 nearest rank; DistinctCount p12 {float(res['distinct_p12']):.0f}, p18 {float(res['distinct_p18']):.0f}"
          f" against {distinct} distinct keys; HeavyHitters: {len(heavy_keys)} true keys at or above {HEAVY['threshold']}"
          f" of the stream (more than max_hitters={HEAVY['max_hitters']}), all found by the descent among {len(found)},"
          f" each within [true, true + 2N/width = +{slack:.0f}]; sketch AUROC {auroc_got:.6f} vs exact {auroc_exact:.6f}")
    print(f"  after {SKETCH_CPU_BATCHES} batches, states bitwise equal to a CPU twin's but for quantile bucket counts"
          f" of values on a bucket boundary (float64 position within {BOUNDARY_RTOL:.1e} relative of an integer): {boundary}")
    for name, t in timing.items():
        print(f"phase 11(d) ({smi}): {name}: update step eager "
              + ", ".join(f"{r['step_us']:.1f} us (idle {r['idle']}, busy {r['busy_us']:.1f} us)" for r in t["eager"])
              + "; compiled " + ", ".join(f"{r['step_us']:.1f} us (idle {r['idle']}, busy {r['busy_us']:.1f} us)" for r in t["compiled"])
              + "; compute eager " + ", ".join(f"{r['compute_ms']:.3f} ms" for r in t["eager"])
              + ", compiled " + ", ".join(f"{r['compute_ms']:.3f} ms" for r in t["compiled"]))
    out = {"metrics": {**run["eager"], "auroc": arun["eager"]["auroc"]}, "timing": timing, "boundary": boundary,
           "quantile_rel_err": float(rel.max()), "distinct": distinct, "auroc": [auroc_got, auroc_exact],
           "heavy_true": len(heavy_keys)}
    del values, keys, tokens, scores, target, stream, auroc_stream
    return out


def sketch_buckets(metric) -> int:
    """The (reduction, dtype) buckets a metric's sketch states fill."""
    return len({(red, c.dtype) for sk in metric.get_state().values() for (f, red), c in
                zip(sk.component_reductions(), sk.components().values())})


def map_subset(mt, metric, n: int):
    """A list-route mAP holding the first ``n`` images of ``metric`` (the
    same tensors): the sync runs one gather round per image and state."""
    from metrics_tpu_torch.detection.mean_ap import _LIST_STATES

    sub = mt.MeanAveragePrecision(iou_type=metric.iou_type, device_state=False, class_metrics=metric.class_metrics)
    sub.set_state({name: list(getattr(metric, name)[:n]) for name in _LIST_STATES})
    sub._update_count = 1
    return sub


def phase_eleven_e(torch, sync, metrics: dict, smi) -> dict:
    """11(e): each phase-11 metric's synced compute in a world of one NCCL
    rank, bitwise equal to its unsynced one (``metrics``: label -> (metric,
    its unsynced result, or None to compute it here)). The list-route mAPs
    run every gather round: the count exchange, one round per image and
    list state, and the (H, W) exchange for masks."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    out = {}
    try:
        world = dist.group.WORLD
        for label, (metric, local) in metrics.items():
            if local is None:
                metric._computed = None
                local = metric.compute()
            metric._computed = None
            with sync.count_collectives() as box, sync.sync_axes(world):
                synced = metric.compute()
            got, want = torch.utils._pytree.tree_leaves(synced), torch.utils._pytree.tree_leaves(local)
            check(len(got) == len(want) and all(same_bits(torch, g, w) for g, w in zip(got, want)),
                  f"11(e) {label}: synced compute differs from the unsynced one")
            if type(metric).__name__ == "MeanAveragePrecision":
                rounds = 1 + 5 * len(metric.detections) + (metric.iou_type == "segm")
                expected = {"size_exchange": rounds, "all_gather": rounds}
            else:
                expected = {"all_reduce": sketch_buckets(metric)}
            check(box["by_kind"] == expected, f"11(e) {label}: synced compute ran {box['by_kind']}, expected {expected}")
            out[label] = box["by_kind"]
    finally:
        dist.destroy_process_group()
    print(f"phase 11(e) ({smi}): synced computes in a world of one NCCL rank bitwise equal to the unsynced ones; collectives {out}"
          f" (the mAPs on their first {SYNC_MAP_IMAGES} images: the count exchange, one gather round per image and list"
          " state, the (H, W) exchange for masks; the sketches: one all_reduce per (reduction, dtype) bucket of their"
          " components, none of their own)")
    return out


def phase_eleven(torch, mt, np, kernels_mod, sync, coco, map_results, smi) -> dict:
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    total = {k: 0 for k in kernels_mod.launch_counts()}

    def tally(part):
        for k, v in part.items():
            total[k] += v

    a = phase_eleven_a(torch, mt, np, kernels_mod, coco, map_results, smi)
    tally(a["launches"])
    b = phase_eleven_b(torch, mt, kernels_mod, smi)
    tally(b["launches"])
    c = phase_eleven_c(torch, mt, np, kernels_mod, smi)
    tally(c["launches"])
    kernels_mod.reset_launch_counts()
    d = phase_eleven_d(torch, mt, np, kernels_mod, smi)
    check(not any(kernels_mod.launch_counts().values()), "11(d): the sketches launched a kernel of B1-B3")
    e = phase_eleven_e(torch, sync, {**{label: (map_subset(mt, m, SYNC_MAP_IMAGES), None) for label, m in (
        ("map_host_list_bbox", a["metric"]), ("map_300_dets", b["metric"]), ("map_segm", c["metric"]))},
        **{k: (m, None) for k, m in d["metrics"].items()}}, smi)
    del c["metric"]
    elapsed = time.perf_counter() - t0
    print(f"phase 11 ({smi}): {elapsed:.1f} s in all (limit {PHASE11_LIMIT_S:.0f} s); kernel launches {total}"
          " (11(a)-(c), without the plain runs)")
    check(elapsed < PHASE11_LIMIT_S, f"phase 11 took {elapsed:.1f} s, over its {PHASE11_LIMIT_S:.0f} s")
    return {"launches": total, "a": {k: a[k] for k in ("update_s", "split", "chunks")},
            "c": {k: c[k] for k in ("update_s", "decode_s", "split", "peak_gb", "chunks")},
            "d": {k: d[k] for k in ("timing", "boundary", "quantile_rel_err", "distinct", "auroc", "heavy_true")},
            "e": e, "seconds": elapsed}


# --------------------------------------------------------------------------- #
# phase 12: image (no kernel of B1-B3 on its path)
# --------------------------------------------------------------------------- #
PHASE12_LIMIT_S = 180.0
# CIFAR-10: 10,000 test images a side (FID's protocol takes 50,000: cut for the time limit)
CIFAR_IMAGES, CIFAR_BATCH, CIFAR_SIDE = 10_000, 100, 32
KID_SUBSETS, KID_SUBSET_SIZE, IS_SPLITS = 100, 1000, 10  # the torchmetrics defaults
TWIN_IMAGES, ROW_ALONE = 16, 8
NET_RTOL = 1e-3  # the JAX package's torch-against-flax bound, also atol 1e-3 x the tap's scale
FID_RTOL, WELFORD_MEAN_RTOL, WELFORD_M2_RTOL = 1e-3, 1e-5, 1e-4
# IS's std within the JAX package's own bound for it (tests/image/test_generative.py:267)
KID_RTOL, KID_ATOL, IS_RTOL, IS_STD_RTOL = 1e-4, 1e-5, 1e-4, 1e-3
# LPIPS image-to-image evaluation at 256 x 256 in updates of 50 (padded to 64)
LPIPS_PAIRS = {"alex": 5000, "squeeze": 5000, "vgg": 1000}
LPIPS_SIDE, LPIPS_BATCH, LPIPS_TWIN, LPIPS_BF16_PAIRS, LPIPS_BF16_RTOL = 256, 50, 8, 200, 2e-2
# DIV2K validation: 100 RGB images, cut to one common size of 1356 x 2040
DIV2K_IMAGES, DIV2K_H, DIV2K_W, DIV2K_BATCH, DIV2K_NOISE, DIV2K_TWIN = 100, 1356, 2040, 4, 0.05, 4
# pansharpening at reduced resolution: 200 tiles of 8 bands, 256 x 256, WorldView-3's ratio 4
MS_TILES, MS_BANDS, MS_SIDE, MS_RATIO, MS_BATCH, MS_TWIN = 200, 8, 256, 4, 8, 4
QUALITY_ATOL = 1e-5


def within(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| - (atol + rtol |want|) (<= 0 when within)."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def inception_macs(torch, extractor, imgs) -> int:
    """Multiply-adds of the convolutions in one forward of ``extractor``'s
    module on ``imgs``, counted from the shapes. At the 2048 tap the forward
    returns before the classifier, so that is all of its multiply-adds."""
    total = [0]

    def hook(mod, inputs, out):
        total[0] += out.numel() * (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in extractor.module.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        extractor(imgs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def cifar_stream(torch):
    """10,000 'real' and 10,000 'fake' seeded uint8 images a side, on the card:
    each image a brightness plus a contrast times gaussian noise, drawn per
    image (real: brightness in [30, 225), contrast in [10, 80); fake: [60,
    190) and [5, 40)), so the features spread and the two sides differ."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 120)
    shape = (CIFAR_BATCH, 3, CIFAR_SIDE, CIFAR_SIDE)

    def batch(lo, hi, c_lo, c_hi):
        level = torch.rand((CIFAR_BATCH, 1, 1, 1), generator=gen, device="cuda") * (hi - lo) + lo
        contrast = torch.rand((CIFAR_BATCH, 1, 1, 1), generator=gen, device="cuda") * (c_hi - c_lo) + c_lo
        x = level + contrast * torch.randn(shape, generator=gen, device="cuda")
        return x.round().clamp(0, 255).to(torch.uint8)

    n = CIFAR_IMAGES // CIFAR_BATCH
    return [batch(30, 225, 10, 80) for _ in range(n)], [batch(60, 190, 5, 40) for _ in range(n)]


def timed_updates(torch, feed, batches) -> dict:
    """Each ``feed(batch)`` timed by CUDA events: the median of the steady
    state (the first two calls, warmup and capture, left out) and the total."""
    times = []
    t0 = time.perf_counter()
    for b in batches:
        _, ms = event_ms(torch, lambda b=b: feed(b))
        times.append(ms)
    return {"median_ms": statistics.median(times[2:] or times), "first_ms": times[:2], "total_s": time.perf_counter() - t0}


def np_fid64(np, real, fake) -> float:
    import scipy.linalg

    mu1, mu2 = real.mean(0), fake.mean(0)
    s1, s2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    return float((mu1 - mu2) @ (mu1 - mu2) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean.real))


def kid64(torch, np, real, fake, seed: int):
    """KID in float64 on the same features and the same subsets (numpy's
    generator, as the metric draws them); the kernel products in float64 on
    the card (cuBLAS DGEMM), the host being too slow for 100 subsets of
    (1000 x 2048)."""
    rng = np.random.default_rng(seed)
    n_r, n_f = real.shape[0], fake.shape[0]
    real_idx = np.stack([rng.permutation(n_r)[:KID_SUBSET_SIZE] for _ in range(KID_SUBSETS)])
    fake_idx = np.stack([rng.permutation(n_f)[:KID_SUBSET_SIZE] for _ in range(KID_SUBSETS)])
    r = real.to(torch.float64)[torch.as_tensor(real_idx, device=real.device)]
    f = fake.to(torch.float64)[torch.as_tensor(fake_idx, device=fake.device)]
    gamma, m = 1.0 / r.shape[-1], KID_SUBSET_SIZE

    def k(a, b):
        return (torch.bmm(a, b.transpose(1, 2)) * gamma + 1.0) ** 3

    def off_diagonal_sum(x):
        return x.sum((1, 2)) - x.diagonal(dim1=1, dim2=2).sum(-1)

    scores = (off_diagonal_sum(k(r, r)) + off_diagonal_sum(k(f, f))) / (m * (m - 1)) - 2 * k(r, f).sum((1, 2)) / m ** 2
    return float(scores.mean()), float(scores.std(correction=0))


def is64(np, logits, seed: int):
    x = logits[np.random.default_rng(seed).permutation(logits.shape[0])].astype(np.float64)
    x = x - x.max(1, keepdims=True)
    log_p = x - np.log(np.exp(x).sum(1, keepdims=True))
    p = np.exp(log_p)
    chunk = -(-p.shape[0] // IS_SPLITS)
    scores = []
    for i in range(0, p.shape[0], chunk):
        pc, lpc = p[i: i + chunk], log_p[i: i + chunk]
        scores.append(np.exp((pc * (lpc - np.log(pc.mean(0, keepdims=True)))).sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores, ddof=1))


def phase_twelve_a(torch, mt, np, smi) -> dict:
    """12(a): FID, KID and IS at CIFAR-10 size through the port's InceptionV3
    (seeded random weights), against float64 oracles on the same features."""
    from metrics_tpu_torch.nets.inception import InceptionV3, load_inception_torch_state_dict

    real, fake = cifar_stream(torch)
    fid = mt.FrechetInceptionDistance(feature=2048)
    kid = mt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, seed=SEED)
    inception_score = mt.InceptionScore(splits=IS_SPLITS, seed=SEED)
    fid_real = timed_updates(torch, lambda b: fid.update(b, real=True), real)
    fid_fake = timed_updates(torch, lambda b: fid.update(b, real=False), fake)
    kid_t = timed_updates(torch, lambda b: (kid.update(b[0], real=True), kid.update(b[1], real=False)), list(zip(real, fake)))
    is_t = timed_updates(torch, lambda b: inception_score.update(b), fake)
    stats = fid.engine_stats()["update"]
    check(stats.cache_misses == 2 and stats.cache_hits == 2 * len(real) - 4,
          f"12(a): FID's update captured {stats.cache_misses}, replayed {stats.cache_hits} (expected 2 and {2 * len(real) - 4})")

    # the features on the side: KID's states (its net has the same seeded weights)
    real_f = torch.cat(kid.real_features)
    fake_f = torch.cat(kid.fake_features)
    logits = torch.cat(inception_score.features)
    check(real_f.shape == (CIFAR_IMAGES, 2048) and logits.shape == (CIFAR_IMAGES, 1008), "12(a): feature shapes")
    check(all(bool(torch.isfinite(x).all()) for x in (real_f, fake_f, logits)), "12(a): features are not finite")

    # the streaming Welford triple against a float64 two-pass mean and M2
    worst = {}
    for side, feats in (("real", real_f), ("fake", fake_f)):
        x64 = feats.to(torch.float64)
        mean64 = x64.mean(0)
        m2_64 = (x64 - mean64).T @ (x64 - mean64)
        n = getattr(fid, f"{side}_n")
        mean_err = float((getattr(fid, f"{side}_mean").to(torch.float64) - mean64).norm() / mean64.norm())
        m2_err = float((getattr(fid, f"{side}_m2").to(torch.float64) - m2_64).norm() / m2_64.norm())
        check(n.dtype == torch.float32 and float(n) == CIFAR_IMAGES, f"12(a): FID {side}_n is {n}")
        check(mean_err <= WELFORD_MEAN_RTOL, f"12(a): FID {side} mean {mean_err:.2e} from the float64 two-pass mean")
        check(m2_err <= WELFORD_M2_RTOL, f"12(a): FID {side} M2 {m2_err:.2e} from float64")
        worst[side] = {"mean_rel": mean_err, "m2_rel": m2_err}

    # computes: FID twice (the second at the engine's decision), eigh split out
    fid_value, fid_ms = event_ms(torch, fid.compute)
    fid._computed = None
    fid_value2, fid_ms2 = event_ms(torch, fid.compute)
    check(same_bits(torch, fid_value, fid_value2), "12(a): FID's two computes differ")
    partition = fid.engine_stats()["partition"]["compute"]
    reasons = fid.engine_stats()["fallback_reasons"]
    # eigh reads cusolver's status on the host: the probe reverts the compute to eager
    check(any("solver's status" in why for why in reasons.values()), f"12(a): FID's compute did not revert at its probe: {reasons}")
    cov = (fid.real_m2 / (fid.real_n - 1)).to(torch.float64)  # the compute's dtype (ops/image/fid._compute_fid)
    _, eigh_ms = event_ms(torch, lambda: torch.linalg.eigh(cov))
    _, eigvalsh_ms = event_ms(torch, lambda: torch.linalg.eigvalsh(cov))
    t_oracle = time.perf_counter()
    want_fid = np_fid64(np, real_f.double().cpu().numpy(), fake_f.double().cpu().numpy())
    fid_rel = abs(float(fid_value) - want_fid) / abs(want_fid)
    check(fid_rel <= FID_RTOL, f"12(a): FID {float(fid_value)} is {fid_rel:.2e} from float64 scipy {want_fid}")

    (kid_mean, kid_std), kid_ms = event_ms(torch, kid.compute)
    want_kid = kid64(torch, np, real_f, fake_f, SEED)
    for got, want, what in ((kid_mean, want_kid[0], "mean"), (kid_std, want_kid[1], "std")):
        check(abs(float(got) - want) <= KID_ATOL + KID_RTOL * abs(want), f"12(a): KID {what} {float(got)} against float64 {want}")
    (is_mean, is_std), is_ms = event_ms(torch, inception_score.compute)
    want_is = is64(np, logits.cpu().numpy(), SEED)
    check(abs(float(is_mean) - want_is[0]) <= IS_RTOL * abs(want_is[0]), f"12(a): IS mean {float(is_mean)} against {want_is[0]}")
    is_std_rel = abs(float(is_std) - want_is[1]) / abs(want_is[1])
    check(is_std_rel <= IS_STD_RTOL, f"12(a): IS std {float(is_std)} is {is_std_rel:.2e} from float64 {want_is[1]}")
    oracle_s = time.perf_counter() - t_oracle
    t_twin = time.perf_counter()

    # the card against a CPU twin of the net on the first images of each side
    ext = fid.inception.__wrapped__
    cpu_net = InceptionV3(features_list=("2048", "logits_unbiased"))
    cpu_net.load_state_dict(load_inception_torch_state_dict({k: v.cpu() for k, v in ext.module.state_dict().items()}))
    cpu_net.eval()
    imgs = torch.cat([real[0][:TWIN_IMAGES], fake[0][:TWIN_IMAGES]])
    from metrics_tpu_torch.nets.inception import resize_bilinear_tf1

    with torch.no_grad():
        cpu_out = cpu_net((resize_bilinear_tf1(imgs.cpu().to(torch.float32), 299, 299) - 128.0) / 128.0)
    twin_err = {}
    for tap, card in (("2048", ext(imgs)), ("logits_unbiased", inception_score.inception.__wrapped__(imgs))):
        want = cpu_out[tap]
        excess = within(card.cpu(), want, NET_RTOL, NET_RTOL * float(want.abs().max()))
        twin_err[tap] = float((card.cpu() - want).abs().max() / want.abs().max())
        check(excess <= 0, f"12(a): the card's {tap} features differ from the CPU twin's beyond the net bound")

    twin_s = time.perf_counter() - t_twin

    # row independence: the same images alone, in their batch of 100, padded to 128
    batch = real[0]
    with torch.no_grad():
        f100 = ext(batch)
        f128 = ext(torch.cat([batch, batch.new_zeros((28, *batch.shape[1:]))]))[:CIFAR_BATCH]
        alone = torch.cat([ext(batch[i: i + 1]) for i in range(ROW_ALONE)])
    scale = float(f100.abs().max())
    row = {"pad128_max_abs": float((f128 - f100).abs().max()), "alone_max_abs": float((alone - f100[:ROW_ALONE]).abs().max()),
           "pad128_bitwise": same_bits(torch, f128, f100), "alone_bitwise": same_bits(torch, alone, f100[:ROW_ALONE]),
           "scale": scale}
    check(within(f128, f100, NET_RTOL, NET_RTOL * scale) <= 0 and within(alone, f100[:ROW_ALONE], NET_RTOL, NET_RTOL * scale) <= 0,
          "12(a): zero-padding or batching changed features beyond the net bound")

    # the forward: images/s, device busy and idle, against its operations bound
    macs = inception_macs(torch, ext, batch)
    fwd_ms = time_ms(torch, lambda: ext(batch), warmup=2, reps=10)
    prof = profile_window(torch, lambda: ext(batch), reps=3)
    busy_us = sum(prof["device_us"].values())
    idle = max(0.0, 1.0 - busy_us / prof["wall_us"]) if prof["device_us"] else None
    fwd_bound_ms = 2 * macs / H100_SXM_FP32 * 1e3
    print(f"phase 12(a) ({smi}): FID/KID/IS at CIFAR-10 size, {CIFAR_IMAGES} images a side in updates of {CIFAR_BATCH},"
          f" seeded random InceptionV3 weights, TF32 off: FID {float(fid_value):.6f} (float64 scipy {want_fid:.6f},"
          f" rel {fid_rel:.2e}); KID {float(kid_mean):.6e} +- {float(kid_std):.6e} (float64 {want_kid[0]:.6e} +- {want_kid[1]:.6e});"
          f" IS {float(is_mean):.6f} +- {float(is_std):.6e} (float64 {want_is[0]:.6f} +- {want_is[1]:.6e}, std rel {is_std_rel:.2e})")
    print(f"  Welford against float64 two-pass: {worst}; the card against the CPU twin (max |diff| / tap scale): {twin_err}")
    print(f"  row independence ({ROW_ALONE} images alone, the batch of 100, padded to 128): {row}")
    print(f"  Inception forward at 100 images: {fwd_ms:.2f} ms ({CIFAR_BATCH / fwd_ms * 1e3:.0f} images/s), device busy"
          f" {busy_us / 1e3:.2f} ms, idle share {idle if idle is None else round(idle, 3)}; {macs / CIFAR_BATCH / 1e9:.3f} GMAC an"
          f" image, operations bound {fwd_bound_ms:.2f} ms at {H100_SXM_FP32 / 1e12:.0f} TFLOP/s float32")
    print(f"  update per 100 images (median by events): FID real {fid_real['median_ms']:.2f} ms, fake {fid_fake['median_ms']:.2f} ms"
          f" (captured; first two {fid_real['first_ms']}), KID {kid_t['median_ms'] / 2:.2f} ms, IS {is_t['median_ms']:.2f} ms (eager,"
          f" lists); compute: FID {fid_ms:.1f}, {fid_ms2:.1f} ms (float64 eigh of a 2048 x 2048 covariance {eigh_ms:.1f} ms, eigvalsh"
          f" {eigvalsh_ms:.1f} ms), KID {kid_ms:.1f} ms, IS {is_ms:.1f} ms")
    print(f"  FID compute partition {partition}; fallback reasons {reasons}; host time: the float64 oracles"
          f" {oracle_s:.1f} s (compute times included), the CPU twin's forward of {2 * TWIN_IMAGES} images {twin_s:.1f} s;"
          f" updates FID {fid_real['total_s'] + fid_fake['total_s']:.1f} s (captures {fid_real['first_ms'][1] / 1e3:.1f},"
          f" {fid_fake['first_ms'][1] / 1e3:.1f} s), KID {kid_t['total_s']:.1f} s, IS {is_t['total_s']:.1f} s")
    return {"fid": [float(fid_value), want_fid], "kid": [float(kid_mean), float(kid_std), *want_kid],
            "is": [float(is_mean), float(is_std), *want_is], "welford": worst, "twin": twin_err, "rows": row,
            "forward_ms": fwd_ms, "forward_busy_ms": busy_us / 1e3, "forward_idle": idle, "forward_bound_ms": fwd_bound_ms,
            "gmac_per_image": macs / CIFAR_BATCH / 1e9,
            "update_ms": {"fid_real": fid_real["median_ms"], "fid_fake": fid_fake["median_ms"], "kid": kid_t["median_ms"] / 2,
                          "is": is_t["median_ms"]},
            "compute_ms": {"fid": [fid_ms, fid_ms2], "eigh": eigh_ms, "eigvalsh": eigvalsh_ms, "kid": kid_ms, "is": is_ms},
            "partition": partition, "reasons": reasons, "metrics": {"fid": fid, "kid": kid, "is": inception_score}}


def lpips_pairs(torch, gen, n: int):
    a = torch.rand((n, 3, LPIPS_SIDE, LPIPS_SIDE), generator=gen, device="cuda") * 2 - 1
    b = (a + 0.2 * torch.randn(a.shape, generator=gen, device="cuda")).clamp(-1, 1)
    return a, b


def phase_twelve_b(torch, mt, smi) -> dict:
    """12(b): LPIPS image-to-image evaluation at 256 x 256 for the three
    trunks (seeded random weights), updates of 50 padded to 64 at eager calls."""
    from metrics_tpu_torch.nets import LPIPSNet

    out = {}
    for k, (net_type, pairs) in enumerate(LPIPS_PAIRS.items()):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 130 + k)
        metric = mt.LearnedPerceptualImagePatchSimilarity(net_type=net_type)
        first = lpips_pairs(torch, gen, LPIPS_BATCH)
        # pairs made on the card just before each update (outside its timing)
        stream = (first if i == 0 else lpips_pairs(torch, gen, LPIPS_BATCH) for i in range(pairs // LPIPS_BATCH))
        t = timed_updates(torch, lambda b, metric=metric: metric.update(*b), stream)
        value = metric.compute()
        check(bool(torch.isfinite(value)) and float(metric.total) == pairs, f"12(b) {net_type}: {value}, total {metric.total}")
        prof = profile_window(torch, lambda: metric.update(*first), reps=3)
        busy = sum(prof["device_us"].values())
        idle = max(0.0, 1.0 - busy / prof["wall_us"]) if prof["device_us"] else None
        # the card against a CPU twin on the first pairs; bfloat16 against float32
        net = metric.net.__wrapped__
        a, c = first[0][:LPIPS_TWIN], first[1][:LPIPS_TWIN]
        card = net(a, c)
        cpu = LPIPSNet(net_type, device="cpu")(a.cpu(), c.cpu())
        twin_err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
        check(within(card.cpu(), cpu, NET_RTOL, NET_RTOL * float(cpu.abs().max())) <= 0, f"12(b) {net_type}: card against CPU twin")
        half = LPIPSNet(net_type, compute_dtype=torch.bfloat16, device="cuda")
        rel = 0.0
        for i in range(LPIPS_BF16_PAIRS // LPIPS_BATCH):
            a, c = first if i == 0 else lpips_pairs(torch, gen, LPIPS_BATCH)
            d32, d16 = net(a, c), half(a, c)
            rel = max(rel, float(((d16 - d32).abs() / d32.abs()).max()))
        check(rel <= LPIPS_BF16_RTOL, f"12(b) {net_type}: bfloat16 {rel:.2e} from float32")
        stats = metric.engine_stats()["update"]
        out[net_type] = {"value": float(value), "ms_per_update": t["median_ms"], "ms_per_pair": t["median_ms"] / LPIPS_BATCH,
                         "total_s": t["total_s"], "idle_share": idle, "device_busy_ms": busy / 1e3, "twin_rel": twin_err,
                         "bf16_rel": rel, "captures": stats.cache_misses, "replays": stats.cache_hits, "metric": metric}
        print(f"phase 12(b) ({smi}): LPIPS {net_type}, {pairs} pairs at {LPIPS_SIDE} x {LPIPS_SIDE}: {float(value):.6f};"
              f" {t['median_ms']:.2f} ms an update of {LPIPS_BATCH} ({t['median_ms'] / LPIPS_BATCH:.3f} ms a pair), idle share"
              f" {idle if idle is None else round(idle, 3)}; captured {stats.cache_misses}, replayed {stats.cache_hits};"
              f" the card within {twin_err:.1e} of a CPU twin (max |diff| / scale), bfloat16 within {rel:.1e} of float32")
    return out


def quality_stream(torch, n: int, batch: int, shape, noise: float, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n // batch):
        target = torch.rand((batch, *shape), generator=gen, device="cuda")
        preds = (target + noise * torch.randn(target.shape, generator=gen, device="cuda")).clamp(0.0, 1.0)
        out.append((preds, target))
    return out


def eager_against_buffered(torch, label: str, make, stream, capacity: int, smi) -> dict:
    """One metric eager (lists, engines off), then buffered at the engine
    defaults (captured appends) on the same stream: results bitwise equal;
    each compute timed by events with its peak ``memory_allocated``."""
    out = {}
    results = {}
    for mode in ("eager", "buffered"):
        kw = dict(compiled_update=False, compiled_compute=False) if mode == "eager" else dict(buffer_capacity=capacity)
        metric = make(**kw)
        for p, t in stream:
            metric.update(p, t)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        value, ms = event_ms(torch, metric.compute)
        peak = torch.cuda.max_memory_allocated()
        results[mode] = value
        stats = metric.engine_stats()["update"]
        out[mode] = {"compute_ms": ms, "peak_gb": peak / 1e9, "above_state_gb": (peak - base) / 1e9,
                     "captures": None if stats is None else stats.cache_misses,
                     "replays": None if stats is None else stats.cache_hits}
        del metric
        gc.collect()
    check(all(bool(torch.isfinite(v).all()) for v in torch.utils._pytree.tree_leaves(results["eager"])), f"{label}: not finite")
    got, want = torch.utils._pytree.tree_leaves(results["buffered"]), torch.utils._pytree.tree_leaves(results["eager"])
    check(all(same_bits(torch, g, w) for g, w in zip(got, want)), f"{label}: buffered result differs from eager")
    out["value"] = [float(v) for v in want]
    print(f"  {label}: {out['value']}; buffered bitwise equal to eager; compute eager {out['eager']['compute_ms']:.1f} ms"
          f" (peak {out['eager']['peak_gb']:.2f} GB, {out['eager']['above_state_gb']:.2f} GB above what it held),"
          f" buffered {out['buffered']['compute_ms']:.1f} ms (peak {out['buffered']['peak_gb']:.2f} GB); buffered update"
          f" captured {out['buffered']['captures']}, replayed {out['buffered']['replays']}")
    return out


def card_against_cpu_quality(torch, label: str, make, batch, relative: bool) -> float:
    card, cpu = make(None), make("cpu")
    card.update(*batch)
    cpu.update(*(x.cpu() for x in batch))
    got, want = card.compute().cpu(), cpu.compute()
    err = float(((got - want).abs() / (want.abs() if relative else 1.0)).max())
    check(err <= QUALITY_ATOL, f"{label}: the card {err:.2e} from the CPU twin")
    return err


def phase_twelve_c(torch, mt, np, smi) -> dict:
    """12(c): PSNR, SSIM, MS-SSIM and UQI at DIV2K validation size, eager
    and buffered; image gradients bitwise against numpy."""
    stream = quality_stream(torch, DIV2K_IMAGES, DIV2K_BATCH, (3, DIV2K_H, DIV2K_W), DIV2K_NOISE, SEED + 140)
    print(f"phase 12(c) ({smi}): DIV2K validation size, {DIV2K_IMAGES} RGB images of {DIV2K_H} x {DIV2K_W} in updates of"
          f" {DIV2K_BATCH} (predictions: the target plus N(0, {DIV2K_NOISE}) clipped to [0, 1])")
    makers = {
        "PSNR": lambda **kw: mt.PeakSignalNoiseRatio(**kw),  # data_range=None: min/max states on the card
        "SSIM": lambda **kw: mt.StructuralSimilarityIndexMeasure(**kw),  # data_range=None: a device max - min
        "MS-SSIM": lambda **kw: mt.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "UQI": lambda **kw: mt.UniversalImageQualityIndex(**kw),
    }
    out = {}
    for label, make in makers.items():
        if label == "PSNR":  # no list state: the compiled path at the defaults against eager
            eager, compiled = make(compiled_update=False, compiled_compute=False), make()
            for p, t in stream:
                eager.update(p, t)
                compiled.update(p, t)
            (value, ms), got = event_ms(torch, eager.compute), compiled.compute()
            check(same_bits(torch, got, value), "12(c) PSNR: compiled differs from eager")
            out[label] = {"value": [float(value)], "eager": {"compute_ms": ms}}
            print(f"  PSNR: {float(value):.6f} dB; compiled (captured update) bitwise equal to eager; compute {ms:.2f} ms")
            continue
        out[label] = eager_against_buffered(torch, f"12(c) {label}", make, stream, DIV2K_IMAGES, smi)
    twin = {label: card_against_cpu_quality(torch, f"12(c) {label}", lambda device, make=make: make(device=device),
                                            (stream[0][0][:DIV2K_TWIN], stream[0][1][:DIV2K_TWIN]), label == "PSNR")
            for label, make in makers.items()}
    imgs = stream[0][1][:DIV2K_TWIN]
    dy, dx = mt.functional.image_gradients(imgs)
    host = imgs.cpu().numpy()
    want_dy, want_dx = np.zeros_like(host), np.zeros_like(host)
    want_dy[..., :-1, :] = host[..., 1:, :] - host[..., :-1, :]
    want_dx[..., :, :-1] = host[..., :, 1:] - host[..., :, :-1]
    check(np.array_equal(dy.cpu().numpy().view(np.int32), want_dy.view(np.int32))
          and np.array_equal(dx.cpu().numpy().view(np.int32), want_dx.view(np.int32)), "12(c): image gradients differ from numpy")
    print(f"  the card against CPU twins on {DIV2K_TWIN} images: {twin} (relative for PSNR); image_gradients on"
          f" {DIV2K_TWIN} images bitwise equal to numpy")
    small = {"PSNR": makers["PSNR"](), "SSIM": makers["SSIM"]()}
    for metric in small.values():
        metric.update(stream[0][0][:DIV2K_TWIN], stream[0][1][:DIV2K_TWIN])
    del stream
    return {**out, "twin": twin, "sync_metrics": small}


def phase_twelve_d(torch, mt, smi) -> dict:
    """12(d): ERGAS, SAM and D-lambda (p = 1) on multispectral tiles, eager
    and buffered, and the card against a CPU twin."""
    stream = quality_stream(torch, MS_TILES, MS_BATCH, (MS_BANDS, MS_SIDE, MS_SIDE), DIV2K_NOISE, SEED + 150)
    print(f"phase 12(d) ({smi}): {MS_TILES} tiles of {MS_BANDS} bands at {MS_SIDE} x {MS_SIDE}, ratio {MS_RATIO}, updates of"
          f" {MS_BATCH}")
    makers = {
        "ERGAS": lambda **kw: mt.ErrorRelativeGlobalDimensionlessSynthesis(ratio=MS_RATIO, **kw),
        "SAM": lambda **kw: mt.SpectralAngleMapper(**kw),
        "D-lambda": lambda **kw: mt.SpectralDistortionIndex(p=1, **kw),
    }
    out = {label: eager_against_buffered(torch, f"12(d) {label}", make, stream, MS_TILES, smi) for label, make in makers.items()}
    twin = {label: card_against_cpu_quality(torch, f"12(d) {label}", lambda device, make=make: make(device=device),
                                            (stream[0][0][:MS_TWIN], stream[0][1][:MS_TWIN]), label == "ERGAS")
            for label, make in makers.items()}
    print(f"  the card against CPU twins on {MS_TWIN} tiles: {twin} (relative for ERGAS)")
    return {**out, "twin": twin}


def synced_equals_unsynced(torch, sync, world, label: str, metrics: dict) -> dict:
    """12(e): each metric's synced compute in ``world`` (one NCCL rank),
    bitwise equal to its unsynced one; the collectives each ran."""
    out = {}
    for name, metric in metrics.items():
        metric._computed = None
        local = metric.compute()
        metric._computed = None
        with sync.count_collectives() as box, sync.sync_axes(world):
            synced = metric.compute()
        got, want = torch.utils._pytree.tree_leaves(synced), torch.utils._pytree.tree_leaves(local)
        check(len(got) == len(want) and all(same_bits(torch, g, w) for g, w in zip(got, want)),
              f"12(e) {name}: synced compute differs from the unsynced one")
        out[name] = box["by_kind"]
    if "FID" in out:  # a gather of each of the 6 states, folded by Chan's combine in rank order
        check(out["FID"] == {"size_exchange": 6, "all_gather": 6}, f"12(e): FID's sync ran {out['FID']}")
    print(f"phase 12(e) after {label}: synced computes in a world of one NCCL rank bitwise equal to the unsynced ones;"
          f" collectives {out}")
    return out


def release(torch, *objects) -> None:
    """Drop a part's metrics (their captured graphs hold private memory
    pools) before the next part allocates."""
    for obj in objects:
        obj.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_twelve(torch, mt, np, kernels_mod, sync, smi) -> dict:
    import torch.distributed as dist

    from metrics_tpu_torch.ops.kernels import features as feats

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    feats.reset_feature_extract_counts()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        world = dist.group.WORLD
        a = phase_twelve_a(torch, mt, np, smi)
        forwards = {"a": feats.feature_extract_counts()}
        feats.reset_feature_extract_counts()
        e = {"a": synced_equals_unsynced(torch, sync, world, "12(a)", {
            "FID": a["metrics"]["fid"], "KID": a["metrics"]["kid"], "IS": a["metrics"]["is"]})}
        release(torch, a.pop("metrics"))
        b = phase_twelve_b(torch, mt, smi)
        forwards["b"] = feats.feature_extract_counts()
        e["b"] = synced_equals_unsynced(torch, sync, world, "12(b)", {"LPIPS": b["alex"]["metric"]})
        release(torch, [v.pop("metric") for v in b.values()])
        c = phase_twelve_c(torch, mt, np, smi)
        e["c"] = synced_equals_unsynced(torch, sync, world, "12(c)", c["sync_metrics"])
        release(torch, c.pop("sync_metrics"))
        d = phase_twelve_d(torch, mt, smi)
    finally:
        dist.destroy_process_group()
    launches = kernels_mod.launch_counts()
    check(not any(launches.values()), f"phase 12 launched a kernel of B1-B3: {launches}")
    elapsed = time.perf_counter() - t0
    print(json.dumps({"feature_extract": forwards}))
    print(f"phase 12 ({smi}): {elapsed:.1f} s in all (limit {PHASE12_LIMIT_S:.0f} s); kernel launches {launches};"
          f" feature_extract forwards (bucketed eager dispatches and their widths) {forwards}")
    check(elapsed < PHASE12_LIMIT_S, f"phase 12 took {elapsed:.1f} s, over its {PHASE12_LIMIT_S:.0f} s")
    return {"launches": launches, "forwards": forwards, "a": a, "b": b, "c": c, "d": d, "e": e, "seconds": elapsed}


# --------------------------------------------------------------------------- #
# phase 13: audio (no kernel of B1-B3 on its path)
# --------------------------------------------------------------------------- #
PHASE13_LIMIT_S = 120.0
# WSJ0-2mix's test set (tt): 3,000 two-speaker mixtures at 8 kHz, 3-10 s each
WSJ_MIXTURES, WSJ_BATCH, WSJ_FS, WSJ_SECONDS = 3000, 8, 8000, (3.0, 10.0)
WSJ_ORACLE, WSJ_TWIN = 256, 64  # mixtures checked against float64 (host time) and against a CPU twin
WSJ_CROP, WSJ_COMPILED = 32_000, 1000  # the compiled path: 4 s crops of the first 1,000 mixtures
WSJ3_MIXTURES, WSJ3_SPEAKERS, WSJ3_SAMPLES = 500, 3, 32_000  # WSJ0-3mix: cut from 3,000 for time
MANY_MIXTURES, MANY_SPEAKERS, MANY_SAMPLES = 64, 8, 16_000  # the eager Hungarian route
# VoiceBank-DEMAND's test set: 824 utterances at 16 kHz, noisy at four SNRs
VB_UTTERANCES, VB_BATCH, VB_FS, VB_SECONDS, VB_SNRS = 824, 8, 16000, (1.5, 5.0), (2.5, 7.5, 12.5, 17.5)
VB_ORACLE, VB_TWIN = 64, 16
# bounds: the JAX tests' own against float64 (tests/audio/test_audio.py:145-163, 242;
# tests/audio/test_pesq_native.py:173-178); an atol of 1e-5 dB beside SNR's rtol
# for values near 0 dB, where the float32 sums' 1e-7 relative error is 4e-7 dB
AUDIO_RTOL, AUDIO_DB_ATOL, SDR_RTOL, SDR_ATOL, STOI_ORACLE_ATOL, GOLDEN_ATOL = 1e-4, 1e-5, 1e-2, 5e-3, 2e-3, 2e-2
# the card against a CPU twin of the port: dB values relative, STOI and MOS absolute
# (cuFFT against pocketfft, cuSOLVER against LAPACK, sums in another order)
TWIN_DB_RTOL, TWIN_SDR_RTOL, TWIN_STOI_ATOL, TWIN_MOS_ATOL = 1e-5, 1e-3, 1e-5, 1e-4
PIT_RTOL = 1e-6  # the best mean against numpy's float64 search over the same matrix
PIT_TIE_DB = 1e-3  # permutations are compared where the two best differ by more than this
# the pinned MOS of tests/audio/test_pesq_native.py:153-158 on its golden degradations
GOLDEN_SNRS = (30, 20, 15, 10, 5, 0)
GOLDEN_MOS = {
    (8000, "nb"): [4.500000, 4.494661, 4.449308, 4.305016, 3.921289, 3.275458, 2.588635],
    (16000, "wb"): [4.640000, 4.640000, 4.640000, 4.640000, 4.625756, 4.538018, 4.195332],
}


def golden_speech(np, n: int, fs: int):
    """The JAX test's speech-like signal (tests/audio/test_pesq_native.py:28-40):
    a pitch train, three formants and a syllabic envelope, in float64 numpy."""
    t = np.arange(n) / fs
    f0 = 120 + 20 * np.sin(2 * np.pi * 2.1 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    sig = np.zeros(n)
    for k, amp in ((1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25)):
        sig += amp * np.sin(k * phase)
    for fc, bw, amp in ((500, 80, 0.8), (1500, 120, 0.5), (2500, 160, 0.3)):
        sig += amp * np.sin(2 * np.pi * fc * t) * np.exp(-((np.sin(2 * np.pi * 1.3 * t)) ** 2) * bw / 100)
    envelope = 0.2 + 0.8 * (np.sin(2 * np.pi * 3.7 * t) > -0.3)
    return (sig * envelope).astype(np.float32)


def golden_degradations(np, fs: int):
    """The JAX test's golden fixtures: the reference, then it plus noise at
    each of GOLDEN_SNRS from its own seed (tests/audio/test_pesq_native.py:161-170)."""
    ref = golden_speech(np, 4 * fs, fs)
    degs = [ref]
    for i, snr_db in enumerate(GOLDEN_SNRS):
        noise = np.random.default_rng(1000 + i).normal(size=ref.shape).astype(np.float32)
        noise *= np.linalg.norm(ref) / np.linalg.norm(noise) * 10 ** (-snr_db / 20)
        degs.append(ref + noise)
    return ref, degs


def speech_sources(torch, gen, k: int, n: int, fs: int):
    """k speech-like sources of n samples on the card: the JAX test's
    generator with its pitch (90-220 Hz, vibrato), formant centres and
    syllable rate drawn per source, plus an aspiration floor 30 dB down
    (real speech has one; without it a 512-lag autocorrelation of a few
    spectral lines is singular). Float64, returned as float32."""
    f64 = dict(device="cuda", dtype=torch.float64)

    def u(lo, hi):
        return torch.rand((k, 1), generator=gen, **f64) * (hi - lo) + lo

    two_pi = 2 * math.pi
    t = torch.arange(n, **f64)[None] / fs
    f0 = u(90.0, 220.0) + u(10.0, 30.0) * torch.sin(two_pi * u(1.5, 3.0) * t)
    phase = two_pi * torch.cumsum(f0, dim=1) / fs
    sig = sum(amp * torch.sin(h * phase) for h, amp in ((1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25)))
    for lo, hi, bw, amp in ((300.0, 800.0, 80, 0.8), (900.0, 2000.0, 120, 0.5), (2000.0, 3000.0, 160, 0.3)):
        sig = sig + amp * torch.sin(two_pi * u(lo, hi) * t) * torch.exp(-torch.sin(two_pi * u(0.8, 1.8) * t) ** 2 * bw / 100)
    sig = sig + 0.03 * torch.randn((k, n), generator=gen, **f64)
    envelope = 0.2 + 0.8 * (torch.sin(two_pi * u(2.5, 5.0) * t + u(0.0, two_pi)) > -0.3).to(torch.float64)
    return (sig * envelope).to(torch.float32)


def at_snr(torch, gen, clean, snr_db):
    """White noise scaled to ``snr_db`` (per row, a tensor or a float) against each row of ``clean``."""
    noise = torch.randn(clean.shape, generator=gen, device="cuda")
    scale = clean.norm(dim=-1, keepdim=True) / noise.norm(dim=-1, keepdim=True)
    return noise * scale * 10 ** (-torch.as_tensor(snr_db, device="cuda") / 20)


def separation_batch(torch, gen, b: int, s: int, n: int, fs: int):
    """b mixtures of s seeded sources (relative levels 0-5 dB, as WSJ0-2mix
    mixes) and their estimates: each a per-mixture permutation of the
    sources plus a 0.1-0.3 leak of the others plus white noise at 0-20 dB.
    Returns (target (b, s, n), estimate (b, s, n), the permutation (b, s))."""
    src = speech_sources(torch, gen, b * s, n, fs).reshape(b, s, n)
    src = src / src.norm(dim=-1, keepdim=True) * 10 ** (torch.rand((b, s, 1), generator=gen, device="cuda") * 5 / 20)
    leak = torch.rand((b, s, 1), generator=gen, device="cuda") * 0.2 + 0.1
    others = (src.sum(dim=1, keepdim=True) - src) / max(s - 1, 1)
    snr = torch.rand((b, s, 1), generator=gen, device="cuda") * 20
    est = src + leak * others + at_snr(torch, gen, src, snr)
    perm = torch.argsort(torch.rand((b, s), generator=gen, device="cuda"), dim=1)
    shuffled = torch.empty_like(est).scatter_(1, perm[..., None].expand(-1, -1, n), est)
    return src, shuffled, perm.to(torch.int32)


def draw_lengths(torch, gen, updates: int, fs: int, seconds):
    lo, hi = int(seconds[0] * fs), int(seconds[1] * fs)
    return torch.randint(lo, hi + 1, (updates,), generator=gen, device="cpu").tolist()


def np_snr64(np, preds, target, zero_mean=False):
    p, t = preds.astype(np.float64), target.astype(np.float64)
    if zero_mean:
        p = p - p.mean(-1, keepdims=True)
        t = t - t.mean(-1, keepdims=True)
    return 10 * np.log10(np.sum(t ** 2, -1) / np.sum((t - p) ** 2, -1))


def np_si_sdr64(np, preds, target, zero_mean=False):
    p, t = preds.astype(np.float64), target.astype(np.float64)
    if zero_mean:
        p = p - p.mean(-1, keepdims=True)
        t = t - t.mean(-1, keepdims=True)
    alpha = np.sum(p * t, -1, keepdims=True) / np.sum(t ** 2, -1, keepdims=True)
    ts = alpha * t
    return 10 * np.log10(np.sum(ts ** 2, -1) / np.sum((ts - p) ** 2, -1))


def np_sdr64(np, preds, target, filter_length=512):
    """Projection SDR in float64 with scipy's Levinson solver (an independent solver)."""
    from scipy.linalg import solve_toeplitz

    out = []
    for p, t in zip(preds.reshape(-1, preds.shape[-1]).astype(np.float64), target.reshape(-1, target.shape[-1]).astype(np.float64)):
        t = t / max(np.linalg.norm(t), 1e-6)
        p = p / max(np.linalg.norm(p), 1e-6)
        n_fft = 2 ** int(np.ceil(np.log2(2 * p.shape[-1] - 1)))
        t_fft = np.fft.rfft(t, n=n_fft)
        r = np.fft.irfft(np.abs(t_fft) ** 2, n=n_fft)[:filter_length]
        b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(p, n=n_fft), n=n_fft)[:filter_length]
        coh = b @ solve_toeplitz(r, b)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.asarray(out).reshape(preds.shape[:-1])


def np_stoi64(np, x, y, extended=False):
    """Dynamic-shape float64 STOI (the published algorithm with pystoi's
    constants; tests/audio/test_audio.py:81-140) of clean x against y at 10 kHz."""
    fs, nf, nfft, j, min_f, n_seg, beta, dyn = 10000, 256, 512, 15, 150, 30, -15.0, 40.0
    eps = np.finfo(np.float64).eps
    x, y = x.astype(np.float64), y.astype(np.float64)
    w = np.hanning(nf + 2)[1:-1]
    hop = nf // 2
    starts = range(0, len(x) - nf, hop)
    x_frames = np.array([w * x[i: i + nf] for i in starts])
    y_frames = np.array([w * y[i: i + nf] for i in starts])
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + eps)
    mask = (np.max(energies) - dyn - energies) < 0
    x_frames, y_frames = x_frames[mask], y_frames[mask]

    def ola(frames):
        buf = np.zeros((len(frames) - 1) * hop + nf)
        for i, f in enumerate(frames):
            buf[i * hop: i * hop + nf] += f
        return buf

    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    k = np.arange(j)
    obm = np.zeros((j, len(f)))
    for i in range(j):
        obm[i, np.argmin((f - min_f * 2.0 ** ((2 * k[i] - 1) / 6.0)) ** 2): np.argmin((f - min_f * 2.0 ** ((2 * k[i] + 1) / 6.0)) ** 2)] = 1

    def bands(sig):
        frames = np.array([w * sig[i: i + nf] for i in range(0, len(sig) - nf, hop)])
        return np.sqrt((np.abs(np.fft.rfft(frames, n=nfft, axis=-1)) ** 2) @ obm.T).T

    xb, yb = bands(ola(x_frames)), bands(ola(y_frames))
    xs = np.lib.stride_tricks.sliding_window_view(xb, n_seg, axis=1)  # (J, S, N)
    ys = np.lib.stride_tricks.sliding_window_view(yb, n_seg, axis=1)
    if extended:
        def rcnorm(a):
            a = a - a.mean(-1, keepdims=True)
            a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + eps)
            a = a - a.mean(0, keepdims=True)
            return a / (np.linalg.norm(a, axis=0, keepdims=True) + eps)
        return float(np.mean(np.sum(rcnorm(xs) * rcnorm(ys), axis=(0, 2)) / n_seg))
    alpha = np.linalg.norm(xs, axis=-1, keepdims=True) / (np.linalg.norm(ys, axis=-1, keepdims=True) + eps)
    yp = np.minimum(alpha * ys, xs * (1 + 10 ** (-beta / 20)))
    xn = xs - xs.mean(-1, keepdims=True)
    yn = yp - yp.mean(-1, keepdims=True)
    corr = np.sum(xn * yn, -1) / (np.linalg.norm(xn, axis=-1) * np.linalg.norm(yn, axis=-1) + eps)
    return float(np.mean(corr.mean(axis=0)))


def np_best_perms(np, mtx, eval_max: bool = True):
    """Exhaustive float64 search: per row of mtx (B, S, S), the best mean of
    mtx[b, t, perm[t]] over every permutation, that permutation, and the gap
    to the second best (in the metric's unit)."""
    import itertools

    s = mtx.shape[-1]
    table = np.asarray(list(itertools.permutations(range(s))))
    vals = mtx.astype(np.float64)[:, np.arange(s)[None, :], table].mean(-1)  # (B, P)
    order = np.argsort(-vals if eval_max else vals, axis=1, kind="stable")
    best = np.take_along_axis(vals, order[:, :1], 1)[:, 0]
    second = np.take_along_axis(vals, order[:, 1:2], 1)[:, 0] if vals.shape[1] > 1 else np.full_like(best, np.inf)
    return best, table[order[:, 0]], np.abs(best - second)


def rel_gap(np, got, want, rtol: float, atol: float = 0.0) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 when within the bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def audio_engines(metrics: dict) -> dict:
    out = {}
    for name, metric in metrics.items():
        stats = metric.engine_stats()
        out[name] = {"partition": stats["partition"], "reasons": stats["fallback_reasons"],
                     "update": None if stats["update"] is None else [stats["update"].cache_misses, stats["update"].cache_hits]}
    return out


def separation_metrics(mt, compiled: bool, device=None) -> dict:
    flags = {"device": device} if compiled else dict(device=device, compiled_update=False, compiled_compute=False)
    return {
        "PIT": mt.PermutationInvariantTraining(mt.functional.scale_invariant_signal_noise_ratio, eval_func="max", **flags),
        "SI-SDR": mt.ScaleInvariantSignalDistortionRatio(**flags),
        "SNR": mt.SignalNoiseRatio(**flags),
        "SDR": mt.SignalDistortionRatio(**flags),
    }


def feed_separation(mt, metrics: dict, src, est):
    """PIT on the estimates, then the other three on the estimates put in
    PIT's order (``pit_permutate``); returns the permutation."""
    metrics["PIT"].update(est, src)
    _, perm = mt.functional.permutation_invariant_training(est, src, mt.functional.scale_invariant_signal_noise_ratio)
    ordered = mt.functional.pit_permutate(est, perm)
    for name in ("SI-SDR", "SNR", "SDR"):
        metrics[name].update(ordered, src)
    return perm, ordered


def metric_states(metric) -> list:
    return [metric.sum_metric, metric.total]


def phase_thirteen_a(torch, mt, np, smi) -> dict:
    """13(a): separation at WSJ0-2mix test size: PIT (SI-SNR), then SI-SDR,
    SNR and SDR (filter 512, direct solve) on PIT's order; float64 oracles
    on the first mixtures, a CPU twin, and the compiled path on 4 s crops."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    lengths = draw_lengths(torch, torch.Generator().manual_seed(SEED + 161), WSJ_MIXTURES // WSJ_BATCH, WSJ_FS, WSJ_SECONDS)
    metrics = separation_metrics(mt, compiled=False)
    twins = separation_metrics(mt, compiled=False, device="cpu")
    oracle = {"PIT": [], "SI-SDR": [], "SNR": [], "SDR": [], "perm_ok": 0, "perm_checked": 0}
    card_vals = {"PIT": [], "SI-SDR": [], "SNR": [], "SDR": []}
    wrong_perms, seen, host_s, gen_s, crops = 0, 0, 0.0, 0.0, []
    upd_times = []
    t0 = time.perf_counter()
    for i, n in enumerate(lengths):
        tg = time.perf_counter()
        src, est, true_perm = separation_batch(torch, gen, WSJ_BATCH, 2, n, WSJ_FS)
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - tg
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        perm, ordered = feed_separation(mt, metrics, src, est)
        end.record()
        wrong_perms += int((perm != true_perm).any(dim=1).sum())
        seen += WSJ_BATCH
        if seen <= WSJ_COMPILED:
            crops.append((src[..., :WSJ_CROP].clone(), est[..., :WSJ_CROP].clone()))
        if seen <= WSJ_ORACLE:
            # the card's per-mixture values, then float64 numpy on the host
            best, _ = mt.functional.permutation_invariant_training(est, src, mt.functional.scale_invariant_signal_noise_ratio)
            card_vals["PIT"].append(best.cpu().numpy())
            card_vals["SI-SDR"].append(mt.functional.scale_invariant_signal_distortion_ratio(ordered, src).cpu().numpy())
            card_vals["SNR"].append(mt.functional.signal_noise_ratio(ordered, src).cpu().numpy())
            card_vals["SDR"].append(mt.functional.signal_distortion_ratio(ordered, src).cpu().numpy())
            th = time.perf_counter()
            s64, e64 = src.cpu().numpy(), est.cpu().numpy()
            mtx = np.stack([np_si_sdr64(np, e64[:, p], s64[:, t], zero_mean=True) for t in range(2) for p in range(2)],
                           axis=1).reshape(WSJ_BATCH, 2, 2)
            from scipy.optimize import linear_sum_assignment

            gap = np.abs(mtx[:, 0, 0] + mtx[:, 1, 1] - mtx[:, 0, 1] - mtx[:, 1, 0]) / 2
            for b in range(WSJ_BATCH):
                rows, cols = linear_sum_assignment(mtx[b], maximize=True)
                oracle["PIT"].append(mtx[b][rows, cols].mean())
                if gap[b] > PIT_TIE_DB:
                    oracle["perm_checked"] += 1
                    oracle["perm_ok"] += int(np.array_equal(cols, perm[b].cpu().numpy()))
            o64 = ordered.cpu().numpy()
            oracle["SI-SDR"].append(np_si_sdr64(np, o64, s64))
            oracle["SNR"].append(np_snr64(np, o64, s64))
            oracle["SDR"].append(np_sdr64(np, o64, s64))
            host_s += time.perf_counter() - th
        if seen <= WSJ_TWIN:
            feed_separation(mt, twins, src.cpu(), est.cpu())
            if seen == WSJ_TWIN:
                twin_cmp = {name: (metrics[name].compute().cpu(), twins[name].compute()) for name in metrics}
        end.synchronize()
        upd_times.append(start.elapsed_time(end))
    stream_s = time.perf_counter() - t0
    results = {name: m.compute() for name, m in metrics.items()}
    check(all(bool(torch.isfinite(v)) for v in results.values()), f"13(a): results not finite: {results}")
    check(all(int(m.total) == WSJ_MIXTURES * (1 if name == "PIT" else 2) for name, m in metrics.items()), "13(a): totals")
    check(wrong_perms == 0, f"13(a): PIT chose another permutation than the data's for {wrong_perms} mixtures")
    check(oracle["perm_ok"] == oracle["perm_checked"], f"13(a): {oracle['perm_checked'] - oracle['perm_ok']} permutations"
          " differ from scipy's linear_sum_assignment on the float64 matrix")
    gaps = {}
    for name in ("PIT", "SI-SDR", "SNR", "SDR"):
        got = np.concatenate([np.asarray(v).reshape(-1) for v in card_vals[name]])
        want = np.concatenate([np.asarray(v).reshape(-1) for v in oracle[name]])
        check(got.shape == want.shape and np.isfinite(got).all(), f"13(a): {name} values")
        if name == "SDR":
            gaps[name] = rel_gap(np, got, want, SDR_RTOL, SDR_ATOL)
            gaps["SDR_max_abs_db"] = float(np.max(np.abs(got - want)))
        else:
            gaps[name] = rel_gap(np, got, want, AUDIO_RTOL, AUDIO_DB_ATOL)
        check(gaps[name] <= 1.0, f"13(a): {name} {gaps[name]:.3f} of its bound from float64")
    twin_err = {}
    for name, (card, cpu) in twin_cmp.items():
        bound = TWIN_SDR_RTOL if name == "SDR" else TWIN_DB_RTOL
        twin_err[name] = float((card - cpu).abs() / cpu.abs())
        check(twin_err[name] <= bound, f"13(a): {name} on the card {twin_err[name]:.2e} (relative) from the CPU twin")
    print(f"phase 13(a) ({smi}): WSJ0-2mix test size, {WSJ_MIXTURES} two-speaker mixtures at 8 kHz in updates of"
          f" {WSJ_BATCH}, 3-10 s each ({sum(lengths) * WSJ_BATCH / WSJ_FS / 3600:.2f} h): "
          + ", ".join(f"{k} {float(v):.6f} dB" for k, v in results.items()))
    print(f"  every permutation equal to the data's; {oracle['perm_checked']} of the first {WSJ_ORACLE} equal to scipy's"
          f" linear_sum_assignment on the float64 matrix; against float64 on the first {WSJ_ORACLE} (share of each bound):"
          f" {gaps} (SDR bound rtol {SDR_RTOL} / atol {SDR_ATOL}); the card against a CPU twin after {WSJ_TWIN} mixtures"
          f" (relative): {twin_err}")
    print(f"  update of the four (median by events) {statistics.median(upd_times):.2f} ms per 8 mixtures; stream"
          f" {stream_s:.1f} s (data on the card {gen_s:.1f} s, float64 oracles {host_s:.1f} s of host time)")

    # the compiled path on 4 s crops: engines at their defaults against eager, bitwise
    eager, compiled = separation_metrics(mt, compiled=False), separation_metrics(mt, compiled=True)
    for src, est in crops:
        feed_separation(mt, eager, src, est)
        feed_separation(mt, compiled, src, est)
    engines = audio_engines(compiled)
    for name, engine in engines.items():
        update = engine["partition"]["update"]
        if name == "SDR":  # the probe refuses the batched LU solve on CUDA
            check(update["path"] == "eager" and "_linalg_solve_ex" in update["reason"],
                  f"13(a): SDR's compiled update did not revert at the solve: {update}")
        else:
            check(update == {"path": "fused", "reason": "compilable"}, f"13(a): {name}'s update is not captured: {update}")
    for name in eager:
        for a, b in zip(metric_states(eager[name]), metric_states(compiled[name])):
            check(same_bits(torch, a, b), f"13(a): {name}'s compiled state differs from eager")
        check(same_bits(torch, eager[name].compute(), compiled[name].compute()), f"13(a): {name}'s compiled result differs")
    print(f"  compiled path on {len(crops) * WSJ_BATCH} crops of {WSJ_CROP} samples: states and results bitwise equal to"
          f" eager; engines (partition, fallback reasons, [captures, replays]): {engines}")
    return {"results": {k: float(v) for k, v in results.items()}, "gaps": gaps, "twin": twin_err, "engines": engines,
            "update_ms": statistics.median(upd_times), "stream_s": stream_s, "host_s": host_s, "crops": crops[:1]}


def enhancement_metrics(mt) -> dict:
    flags = dict(compiled_update=False, compiled_compute=False)
    return {
        "STOI": mt.ShortTimeObjectiveIntelligibility(VB_FS, **flags),
        "ESTOI": mt.ShortTimeObjectiveIntelligibility(VB_FS, extended=True, **flags),
        "PESQ-wb": mt.PerceptualEvaluationSpeechQuality(VB_FS, "wb", implementation="native", **flags),
        "PESQ-nb": mt.PerceptualEvaluationSpeechQuality(8000, "nb", implementation="native", **flags),
        "SI-SDR": mt.ScaleInvariantSignalDistortionRatio(**flags),
    }


def to_8k(torch, np, x):
    """A 16 kHz batch resampled to 8 kHz on the host (scipy, float64), back on x's device."""
    from scipy.signal import resample_poly

    return torch.from_numpy(resample_poly(x.double().cpu().numpy(), 1, 2, axis=-1).astype(np.float32)).to(x.device)


def feed_enhancement(torch, np, metrics: dict, noisy, clean):
    noisy8, clean8 = to_8k(torch, np, noisy), to_8k(torch, np, clean)
    for name, metric in metrics.items():
        if name == "PESQ-nb":
            metric.update(noisy8, clean8)
        else:
            metric.update(noisy, clean)
    return noisy8, clean8


def phase_thirteen_b(torch, mt, np, smi) -> dict:
    """13(b): enhancement at VoiceBank-DEMAND test size: STOI, ESTOI, PESQ
    (wb, and nb on an 8 kHz copy) and SI-SDR per SNR group."""
    from scipy.signal import resample_poly

    from metrics_tpu_torch.ops.audio import pesq_native

    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
    lengths = draw_lengths(torch, torch.Generator().manual_seed(SEED + 171), VB_UTTERANCES // VB_BATCH, VB_FS, VB_SECONDS)
    groups = [enhancement_metrics(mt) for _ in VB_SNRS]
    stoi_oracle, stoi_card, twin_err, delays_equal = [], [], {}, True
    host_s, upd_times = 0.0, []
    t0 = time.perf_counter()
    for i, n in enumerate(lengths):
        g = i % len(VB_SNRS)
        clean = speech_sources(torch, gen, VB_BATCH, n, VB_FS)
        noisy = clean + at_snr(torch, gen, clean, VB_SNRS[g])
        start = time.perf_counter()
        noisy8, clean8 = feed_enhancement(torch, np, groups[g], noisy, clean)
        torch.cuda.synchronize()
        upd_times.append((time.perf_counter() - start) * 1e3)
        first = i * VB_BATCH
        if first < VB_ORACLE:
            th = time.perf_counter()
            p10 = resample_poly(noisy.double().cpu().numpy(), 10000, VB_FS, axis=-1)
            c10 = resample_poly(clean.double().cpu().numpy(), 10000, VB_FS, axis=-1)
            for ext in (False, True):
                card = mt.functional.short_time_objective_intelligibility(noisy, clean, VB_FS, extended=ext).cpu().numpy()
                stoi_card.append(card)
                stoi_oracle.append(np.asarray([np_stoi64(np, c10[b], p10[b], extended=ext) for b in range(VB_BATCH)]))
            host_s += time.perf_counter() - th
        if first < VB_TWIN:
            # the card against the CPU port on the same utterances
            for ext in (False, True):
                a = mt.functional.short_time_objective_intelligibility(noisy, clean, VB_FS, extended=ext).cpu()
                b = mt.functional.short_time_objective_intelligibility(noisy.cpu(), clean.cpu(), VB_FS, extended=ext)
                key = "ESTOI" if ext else "STOI"
                twin_err[key] = max(twin_err.get(key, 0.0), float((a - b).abs().max()))
            for key, (p, t, fs, mode) in {"PESQ-wb": (noisy, clean, VB_FS, "wb"), "PESQ-nb": (noisy8, clean8, 8000, "nb")}.items():
                card = pesq_native._pesq_parts(t, p, fs, mode)
                cpu = pesq_native._pesq_parts(t.cpu(), p.cpu(), fs, mode)
                twin_err[key] = max(twin_err.get(key, 0.0), float((card[0].cpu() - cpu[0]).abs().max()))
                delays_equal &= all(torch.equal(x.cpu(), y) for x, y in zip(card[1:], cpu[1:]))
            a = mt.functional.scale_invariant_signal_distortion_ratio(noisy, clean).cpu()
            b = mt.functional.scale_invariant_signal_distortion_ratio(noisy.cpu(), clean.cpu())
            twin_err["SI-SDR"] = max(twin_err.get("SI-SDR", 0.0), float(((a - b).abs() / b.abs()).max()))
    stream_s = time.perf_counter() - t0
    # the groups' means, and the whole set's from their (sum, total) states
    means = {name: [float(grp[name].compute()) for grp in groups] for name in groups[0]}
    overall = {name: float(sum(grp[name].sum_metric for grp in groups) / sum(int(grp[name].total) for grp in groups))
               for name in groups[0]}
    check(all(math.isfinite(v) for v in overall.values()), f"13(b): results not finite: {overall}")
    check(sum(int(grp["STOI"].total) for grp in groups) == VB_UTTERANCES, "13(b): STOI's total")
    for name in ("STOI", "ESTOI", "PESQ-wb", "PESQ-nb", "SI-SDR"):
        check(all(a < b for a, b in zip(means[name], means[name][1:])), f"13(b): {name}'s group means do not rise with SNR: {means[name]}")
    got, want = np.concatenate(stoi_card), np.concatenate(stoi_oracle)
    stoi_gap = float(np.max(np.abs(got - want)))
    check(stoi_gap <= STOI_ORACLE_ATOL, f"13(b): STOI/ESTOI {stoi_gap:.2e} from the float64 oracle")
    bounds = {"STOI": TWIN_STOI_ATOL, "ESTOI": TWIN_STOI_ATOL, "PESQ-wb": TWIN_MOS_ATOL, "PESQ-nb": TWIN_MOS_ATOL,
              "SI-SDR": TWIN_DB_RTOL}
    for key, err in twin_err.items():
        check(err <= bounds[key], f"13(b): {key} on the card {err:.2e} from the CPU port")
    check(delays_equal, "13(b): PESQ's chosen delays or active-frame counts differ between the card and the CPU")

    # the pinned goldens of both modes
    golden = {}
    for fs, mode in ((8000, "nb"), (16000, "wb")):
        ref, degs = golden_degradations(np, fs)
        refs = torch.from_numpy(np.stack([ref] * len(degs))).cuda()
        scores = mt.functional.perceptual_evaluation_speech_quality(torch.from_numpy(np.stack(degs)).cuda(), refs, fs, mode,
                                                                    implementation="native").cpu().numpy()
        golden[mode] = float(np.max(np.abs(scores - np.asarray(GOLDEN_MOS[(fs, mode)]))))
        check(golden[mode] <= GOLDEN_ATOL, f"13(b): PESQ {mode} goldens {golden[mode]:.2e} from the pinned MOS: {scores}")
    print(f"phase 13(b) ({smi}): VoiceBank-DEMAND test size, {VB_UTTERANCES} utterances at 16 kHz in updates of {VB_BATCH},"
          f" 1.5-5 s each, noisy at {VB_SNRS} dB in turn: overall {overall}; by SNR group {means} (each rises with SNR)")
    print(f"  STOI/ESTOI on the first {VB_ORACLE} within {stoi_gap:.2e} of the float64 oracle (bound {STOI_ORACLE_ATOL});"
          f" the card against the CPU port on the first {VB_TWIN}: {twin_err}, PESQ's delays and active frames equal;"
          f" PESQ goldens within {golden} of the pinned MOS (bound {GOLDEN_ATOL})")
    print(f"  update of the five (host clock, resamples included) {statistics.median(upd_times):.2f} ms per 8 utterances;"
          f" stream {stream_s:.1f} s (float64 STOI oracle {host_s:.1f} s of host time)")
    return {"overall": overall, "means": means, "stoi_gap": stoi_gap, "twin": twin_err, "golden": golden,
            "update_ms": statistics.median(upd_times), "stream_s": stream_s, "host_s": host_s}


def phase_thirteen_c(torch, mt, np, smi) -> dict:
    """13(c): more speakers: WSJ0-3mix-like mixtures (exhaustive table of 3!)
    and 8 speakers (eager: scipy's Hungarian route), each against an
    exhaustive float64 search in numpy over the card's own metric matrix."""
    from metrics_tpu_torch.ops.audio import pit as pit_ops
    from metrics_tpu_torch.utils.checks import _checks_off

    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    si_snr = mt.functional.scale_invariant_signal_noise_ratio
    out = {}
    for label, n_mix, s, n in (("3 speakers", WSJ3_MIXTURES, WSJ3_SPEAKERS, WSJ3_SAMPLES),
                               ("8 speakers", MANY_MIXTURES, MANY_SPEAKERS, MANY_SAMPLES)):
        metric = mt.PermutationInvariantTraining(si_snr, compiled_update=False, compiled_compute=False)
        worst, wrong, table_same, t0 = 0.0, 0, True, time.perf_counter()
        for _ in range(math.ceil(n_mix / WSJ_BATCH)):
            src, est, true_perm = separation_batch(torch, gen, WSJ_BATCH, s, n, WSJ_FS)
            metric.update(est, src)
            best, perm = mt.functional.permutation_invariant_training(est, src, si_snr)
            mtx = pit_ops._metric_matrix(est, src, si_snr).cpu().numpy()
            want_best, want_perm, _ = np_best_perms(np, mtx)
            wrong += int((perm.cpu().numpy() != want_perm).any(axis=1).sum()) + int((perm != true_perm).any(dim=1).sum())
            worst = max(worst, float(np.max(np.abs(best.cpu().numpy() - want_best) / np.abs(want_best))))
            if s > pit_ops._HUNGARIAN_CUTOVER:
                with _checks_off():  # the route a captured step takes: the exhaustive table on the card
                    _, table_perm = mt.functional.permutation_invariant_training(est, src, si_snr)
                table_same &= torch.equal(table_perm, perm)
        elapsed = time.perf_counter() - t0
        check(wrong == 0, f"13(c) {label}: {wrong} permutations differ from the exhaustive float64 search or the data's")
        check(worst <= PIT_RTOL, f"13(c) {label}: best metric {worst:.2e} (relative) from the float64 search")
        check(table_same, f"13(c) {label}: the exhaustive table on the card chose other permutations than the Hungarian route")
        out[label] = {"value": float(metric.compute()), "best_rel": worst, "seconds": elapsed}
    print(f"phase 13(c) ({smi}): {WSJ3_MIXTURES} mixtures of {WSJ3_SPEAKERS} speakers at {WSJ3_SAMPLES} samples and"
          f" {MANY_MIXTURES} of {MANY_SPEAKERS} at {MANY_SAMPLES} (eager: scipy's Hungarian route; the 8! table on the card"
          f" chose the same): every permutation equal to the exhaustive float64 search and to the data's; {out}")
    return out


def audio_bytes_bound(name: str, rows: int, n: int, fs_rate: int) -> float:
    """Bytes the FFT-bound metrics must move: the float32 samples read once
    (preds and target) and the complex64 spectra written once."""
    samples = 2 * rows * n * 4
    if name == "SDR":
        n_fft = 2 ** math.ceil(math.log2(2 * n - 1))
        return samples + 2 * rows * (n_fft // 2 + 1) * 8
    if name in ("STOI", "ESTOI"):
        n10 = n * 10000 // fs_rate
        frames = max((n10 - 257) // 128 + 1, 0)
        return 2 * rows * n10 * 4 + 2 * rows * frames * 257 * 8
    frame = {8000: 256, 16000: 512}[fs_rate]
    frames = (n - frame) // (frame // 2) + 1
    return samples + 2 * rows * frames * (frame // 2 + 1) * 8


def phase_thirteen_timing(torch, mt, np, crop, smi) -> dict:
    """Update step of every audio metric, eager and compiled, on one batch
    each: events (median), device busy and idle share (profile); SDR's FFTs
    and solve apart; STOI's host resample apart from its device time; each
    compute; beside the bytes bound of the FFT-bound metrics."""
    from metrics_tpu_torch.ops.audio import sdr as sdr_ops, stoi as stoi_ops

    name = torch.cuda.get_device_name(0)
    src, est = crop
    gen = torch.Generator(device="cuda").manual_seed(SEED + 190)
    clean = speech_sources(torch, gen, VB_BATCH, 3 * VB_FS, VB_FS)
    noisy = clean + at_snr(torch, gen, clean, 7.5)
    clean8, noisy8 = to_8k(torch, np, clean), to_8k(torch, np, noisy)
    si_snr = mt.functional.scale_invariant_signal_noise_ratio
    cases = {
        "PIT": (lambda **kw: mt.PermutationInvariantTraining(si_snr, **kw), (est, src), WSJ_BATCH * 4, WSJ_CROP, WSJ_FS),
        "SI-SDR": (lambda **kw: mt.ScaleInvariantSignalDistortionRatio(**kw), (est, src), WSJ_BATCH * 2, WSJ_CROP, WSJ_FS),
        "SNR": (lambda **kw: mt.SignalNoiseRatio(**kw), (est, src), WSJ_BATCH * 2, WSJ_CROP, WSJ_FS),
        "SDR": (lambda **kw: mt.SignalDistortionRatio(**kw), (est, src), WSJ_BATCH * 2, WSJ_CROP, WSJ_FS),
        "STOI": (lambda **kw: mt.ShortTimeObjectiveIntelligibility(VB_FS, **kw), (noisy, clean), VB_BATCH, 3 * VB_FS, VB_FS),
        "ESTOI": (lambda **kw: mt.ShortTimeObjectiveIntelligibility(VB_FS, extended=True, **kw), (noisy, clean), VB_BATCH,
                  3 * VB_FS, VB_FS),
        "PESQ-wb": (lambda **kw: mt.PerceptualEvaluationSpeechQuality(VB_FS, "wb", implementation="native", **kw),
                    (noisy, clean), VB_BATCH, 3 * VB_FS, VB_FS),
        "PESQ-nb": (lambda **kw: mt.PerceptualEvaluationSpeechQuality(8000, "nb", implementation="native", **kw),
                    (noisy8, clean8), VB_BATCH, 3 * 8000, 8000),
    }
    hbm = card_rate(HBM_BYTES_PER_S, H100_SXM_HBM, name)
    out = {}
    for label, (make, args, rows, n, fs_rate) in cases.items():
        row = {}
        for mode in ("eager", "compiled"):
            metric = make() if mode == "compiled" else make(compiled_update=False, compiled_compute=False)
            ms = time_ms(torch, lambda: metric.update(*args), warmup=3, reps=15)
            prof = profile_window(torch, lambda: metric.update(*args), reps=5)
            _, compute_ms = event_ms(torch, metric.compute)
            stats = metric.engine_stats()
            row[mode] = {"update_ms": ms, "busy_ms": sum(prof["device_us"].values()) / 1e3, "idle": idle_share(prof),
                         "compute_ms": compute_ms, "partition": stats["partition"]["update"]}
        if label in ("SDR", "STOI", "ESTOI", "PESQ-wb", "PESQ-nb"):
            row["bytes_bound_ms"] = audio_bytes_bound(label, rows, n, fs_rate) / hbm * 1e3
        out[label] = row
        print(f"phase 13 timing ({smi}): {label}, {rows} rows of {n} samples: update eager {row['eager']['update_ms']:.3f} ms"
              f" (busy {row['eager']['busy_ms']:.3f} ms, idle {row['eager']['idle']}), compiled {row['compiled']['update_ms']:.3f}"
              f" ms (busy {row['compiled']['busy_ms']:.3f} ms, idle {row['compiled']['idle']}, {row['compiled']['partition']});"
              f" compute {row['eager']['compute_ms']:.3f} / {row['compiled']['compute_ms']:.3f} ms"
              + (f"; bytes bound {row['bytes_bound_ms']:.4f} ms" if "bytes_bound_ms" in row else ""))

    # SDR's FFTs and solve apart, on the crop batch's (16, 32000) rows
    p = est.reshape(-1, WSJ_CROP)
    t = src.reshape(-1, WSJ_CROP)
    tn, pn = t / t.norm(dim=-1, keepdim=True), p / p.norm(dim=-1, keepdim=True)
    r0, b = sdr_ops._compute_autocorr_crosscorr(tn, pn, 512)
    toeplitz = sdr_ops._symmetric_toeplitz(r0)
    fft_ms = time_ms(torch, lambda: sdr_ops._compute_autocorr_crosscorr(tn, pn, 512), warmup=3, reps=20)
    toeplitz_ms = time_ms(torch, lambda: sdr_ops._symmetric_toeplitz(r0), warmup=3, reps=20)
    solve_ms = time_ms(torch, lambda: torch.linalg.solve_ex(toeplitz, b[..., None], check_errors=False), warmup=3, reps=20)
    # does the solve wait for the card? (the sync debug mode sees torch's own synchronisations)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.linalg.solve_ex(toeplitz, b[..., None], check_errors=False)
        solve_sync = "none seen"
    except RuntimeError as err:
        solve_sync = str(err).splitlines()[0][:160]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # STOI: the host resample against the device work on the resampled rows
    resample_ms = host_ms(lambda: to_10k(torch, np, noisy), reps=5)
    n10, c10 = to_10k(torch, np, noisy), to_10k(torch, np, clean)
    device_ms = time_ms(torch, lambda: stoi_ops._stoi_batch(c10, n10, False), warmup=3, reps=15)
    out["split"] = {"sdr_fft_ms": fft_ms, "sdr_toeplitz_ms": toeplitz_ms, "sdr_solve_ms": solve_ms, "sdr_solve_sync": solve_sync,
                    "stoi_resample_ms_per_signal_batch": resample_ms, "stoi_device_ms": device_ms}
    print(f"phase 13 timing ({smi}): SDR on {tuple(p.shape)}: FFT correlations {fft_ms:.3f} ms, Toeplitz gather"
          f" {toeplitz_ms:.3f} ms, solve_ex of 16 (512, 512) systems {solve_ms:.3f} ms (synchronisation under the sync"
          f" debug mode: {solve_sync}); STOI on (8, 48000) at 16 kHz:"
          f" host resample {resample_ms:.3f} ms a batch (two per update), device {device_ms:.3f} ms")
    return out


def to_10k(torch, np, x):
    """A 16 kHz batch resampled to 10 kHz on the host, as STOI's update does."""
    from scipy.signal import resample_poly

    return torch.from_numpy(resample_poly(x.double().cpu().numpy(), 10000, VB_FS, axis=-1).astype(np.float32)).to(x.device)


def phase_thirteen(torch, mt, np, kernels_mod, smi) -> dict:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels_mod.reset_launch_counts()
    a = phase_thirteen_a(torch, mt, np, smi)
    b = phase_thirteen_b(torch, mt, np, smi)
    c = phase_thirteen_c(torch, mt, np, smi)
    timing = phase_thirteen_timing(torch, mt, np, a.pop("crops")[0], smi)
    launches = kernels_mod.launch_counts()
    check(not any(launches.values()), f"phase 13 launched a kernel of B1-B3: {launches}")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    elapsed = time.perf_counter() - t0
    print(f"phase 13 ({smi}): {elapsed:.1f} s in all (limit {PHASE13_LIMIT_S:.0f} s); kernel launches {launches};"
          f" peak memory_allocated {peak_gb:.2f} GB above what earlier phases held")
    check(elapsed < PHASE13_LIMIT_S, f"phase 13 took {elapsed:.1f} s, over its {PHASE13_LIMIT_S:.0f} s")
    return {"launches": launches, "a": a, "b": b, "c": c, "timing": timing, "peak_gb": peak_gb, "seconds": elapsed}


# --------------------------------------------------------------------------- #
# phase 14: sync variants (quantized transports, incremental sync, collectives
# inside captured steps), in a world of one NCCL rank
# --------------------------------------------------------------------------- #
PHASE14_LIMIT_S = 90.0
CONFMAT_CLASSES = 4096  # the headline case of docs/quantized_sync.md: a 64 MiB int32 sum state
CONFMAT_BATCH = 1 << 20
CONFMAT_SPARSE_SKILL = 0.9  # share of correct predictions in the stream whose nonzeros fit the density
CONFMAT_DENSE_BATCHES = 16  # 16 x 2**20 uniform pairs: about 63% of the 16.8M cells nonzero, past the density
INCR_CADENCES = (1, 4)


def sum_buckets(torch, metric, state: dict) -> dict:
    """A metric's sum states grouped by dtype, each flattened into one
    tensor: the buckets a transport quantizes and its bound speaks of."""
    out = {}
    for name, value in state.items():
        if metric._reductions.get(name) == "sum":
            out.setdefault(str(value.dtype), []).append(value.reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def bucket_error(torch, metric, got: dict, want: dict) -> float:
    """The largest error of a synced state against the exact one, relative
    to its bucket's largest exact magnitude (transport_error_bound's frame)."""
    worst = 0.0
    g, w = sum_buckets(torch, metric, got), sum_buckets(torch, metric, want)
    for key, exact in w.items():
        exact64, got64 = exact.double(), g[key].double()
        scale = float(exact64.abs().max())
        if scale > 0:
            worst = max(worst, float((got64 - exact64).abs().max()) / scale)
    return worst


def sync_units(torch, units: dict, group) -> dict:
    """Each unit's ``sync_states`` over ``group``: ``{label: synced state}``."""
    return {label: metric.sync_states(state, group) for label, (metric, state) in units.items()}


def transports_check(torch, sync, label: str, units: dict, twins: dict, world, gloo, smi, reps: int = 10) -> dict:
    """14(a)/(b): ``units`` (``{label: (metric, state)}`` on the card) synced
    under each transport, set globally (the gate routes a transport that
    cannot carry a bucket to exact): exact equal to the unsynced state bit for
    bit; every transport bit for bit equal to the CPU twins' sync through a
    gloo group of one; within ``transport_error_bound(t, 1)`` of exact. The
    collectives' kinds and bytes, and the sync's time by CUDA events."""
    out = {}
    exact = None
    for transport in sync.TRANSPORTS:
        sync.set_sync_transport(transport)
        try:
            with sync.count_collectives() as box:
                synced = sync_units(torch, units, world)
            with sync.count_collectives() as twin_box:
                twin_synced = sync_units(torch, twins, gloo)
            ms = time_ms(torch, lambda: sync_units(torch, units, world), warmup=2, reps=reps)
        finally:
            sync.set_sync_transport(None)
        if transport == "exact":
            exact = synced
            for unit, (metric, state) in units.items():
                for name, value in state.items():
                    check(same_bits(torch, synced[unit][name], value), f"14 {label}: exact sync of {unit}.{name} differs from the unsynced state")
        worst = 0.0
        for unit, (metric, state) in units.items():
            for name, value in synced[unit].items():
                check(same_bits(torch, value, twin_synced[unit][name]),
                      f"14 {label}: {transport} sync of {unit}.{name} differs from the CPU twin's through gloo")
            worst = max(worst, bucket_error(torch, metric, synced[unit], exact[unit]))
        bound_rel = sync.transport_error_bound(transport, 1)
        check(worst <= bound_rel, f"14 {label}: {transport} error {worst:.3e} past its bound {bound_rel:.3e}")
        check(box["by_kind"] == twin_box["by_kind"] and box["bytes_by_transport"] == twin_box["bytes_by_transport"],
              f"14 {label}: {transport}: the card ran {box['by_kind']}, the CPU twin {twin_box['by_kind']}")
        out[transport] = {"ms": ms, "by_kind": dict(box["by_kind"]), "bytes": box["bytes"],
                          "bytes_by_transport": {k: dict(v) for k, v in box["bytes_by_transport"].items()},
                          "refusals": len(box["refusals"]), "max_rel_err": worst, "bound": bound_rel}
        print(f"phase 14{label} ({smi}): {transport}: sync {ms:.3f} ms (median of {reps}, CUDA events); {dict(box['by_kind'])};"
              f" bytes {out[transport]['bytes_by_transport']}; refusals {len(box['refusals'])}; error {worst:.3e}"
              f" (bound {bound_rel:.3e}); bitwise equal to the CPU twin through gloo")
    return out


def phase_fourteen_a(torch, mt, sync, world, gloo, smi) -> dict:
    """14(a): config2 at 1,000 classes and the binned AP, phase 3's stream."""
    coll, binned = build_slice(mt)
    cpu_coll, cpu_binned = build_slice(mt, device="cpu")
    for logits, probs, target in batches(torch):
        coll.update(logits, target)
        binned.update(probs, target)
    leaders = [group[0] for group in coll.compute_groups.values()]
    units = {**{k: (coll[k], coll[k].get_state()) for k in leaders}, "binned": (binned, binned.get_state())}
    twins = {k: ((cpu_coll[k] if k != "binned" else cpu_binned), {s: v.cpu() for s, v in st.items()})
             for k, (_, st) in units.items()}
    return transports_check(torch, sync, "(a) config2 + binned AP", units, twins, world, gloo, smi)


def confmat_stream(torch, dense: bool):
    """2**20 samples, 90% correct (nonzeros fit sparse_count's slots), or 16
    batches of 2**20 uniform pairs (they do not)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140 + int(dense))
    for _ in range(CONFMAT_DENSE_BATCHES if dense else 1):
        target = torch.randint(0, CONFMAT_CLASSES, (CONFMAT_BATCH,), generator=gen, device="cuda")
        if dense:
            preds = torch.randint(0, CONFMAT_CLASSES, (CONFMAT_BATCH,), generator=gen, device="cuda")
        else:
            wrong = torch.rand((CONFMAT_BATCH,), generator=gen, device="cuda") >= CONFMAT_SPARSE_SKILL
            preds = torch.where(wrong, torch.randint(0, CONFMAT_CLASSES, (CONFMAT_BATCH,), generator=gen, device="cuda"), target)
        yield preds, target


def phase_fourteen_b(torch, mt, sync, world, gloo, smi) -> dict:
    """14(b): a 4,096-class ConfusionMatrix (64 MiB int32) in both regimes."""
    out = {}
    for regime, dense in (("sparse", False), ("dense", True)):
        metric = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES, compiled_update=False, compiled_compute=False)
        for preds, target in confmat_stream(torch, dense):
            metric.update(preds, target)
        state = metric.get_state()
        nnz = int((state["confmat"] != 0).sum())
        slots = sync._sparse_slots(CONFMAT_CLASSES ** 2)
        check((nnz > slots) == dense, f"14(b) {regime}: {nnz} nonzeros against {slots} slots")
        twin = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES, device="cpu")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res = transports_check(torch, sync, f"(b) ConfusionMatrix {CONFMAT_CLASSES} {regime} ({nnz} nonzeros, {slots} slots)",
                               {"confmat": (metric, state)}, {"confmat": (twin, {"confmat": state["confmat"].cpu()})},
                               world, gloo, smi, reps=5)
        branch = res["sparse_count"]["by_kind"]
        check(branch == ({"all_reduce": 2} if dense else {"all_reduce": 1, "all_gather": 1}),
              f"14(b) {regime}: sparse_count ran {branch}")
        peak = torch.cuda.max_memory_allocated() - held
        print(f"phase 14(b) ({smi}): {regime}: torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB above the"
              f" {held / 2**20:.1f} MiB held before the four syncs (state {CONFMAT_CLASSES ** 2 * 4 / 2**20:.0f} MiB)")
        out[regime] = {"nnz": nnz, "slots": slots, "peak_mib": peak / 2**20, **res}
        del metric, state
    return out


def incremental_slice(mt, compiled: bool):
    """config2 and the binned AP in one collection, fed probabilities (the
    argmax of which is the logits'), every state incremental."""
    coll, binned = build_slice(mt, compiled=compiled)
    coll.add_metrics({"binned": binned})
    return coll


def phase_fourteen_c(torch, mt, kernels_mod, sync, engine, world, smi) -> dict:
    """14(c): the incremental streak over phase 3's stream at K = 1 and 4,
    captured (``CompiledIncrementalStep``: B1 and the emission's all_reduces
    in one graph) and eager, each finalize against ``sync_state`` of the
    final state."""
    out = {}
    stream = [(probs, target) for _, probs, target in batches(torch)]
    sync.set_sync_mode("incremental")
    try:
        for k in INCR_CADENCES:
            coll = incremental_slice(mt, compiled=False)
            paths = {name: engine.classify_incremental_member(m) for name, m in coll.items(keep_base=True)}
            check(all(p == "incremental" for p, _ in paths.values()), f"14(c): incremental paths {paths}")
            step = engine.CompiledIncrementalStep(coll, world)
            runs = {}
            for mode in ("eager", "captured"):
                carries = coll.init_incremental(coll.init_state(), sync_every=k)
                kernels_mod.reset_launch_counts()
                times, emitting = [], 0
                for probs, target in stream:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    if mode == "captured":
                        carries = step(carries, probs, target)
                    else:
                        carries = coll.update_state_incremental(carries, probs, target, group=world)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                    emitting += next(iter(carries.values())).pending == 0
                launches = kernels_mod.launch_counts()["binned_counts"]
                with sync.count_collectives() as fin:
                    final = coll.finalize_incremental(carries, world)
                deferred = coll.sync_states({name: c.state for name, c in carries.items()}, world)
                for leader, states in deferred.items():
                    for name, value in states.items():
                        check(same_bits(torch, final[leader][name], value),
                              f"14(c) K={k} {mode}: finalize of {leader}.{name} differs from sync_state of the final state")
                check(emitting == len(stream) // k, f"14(c) K={k} {mode}: {emitting} emissions for {len(stream)} steps")
                tail = len(stream) % k
                check((fin["count"] > 0) == (tail > 0), f"14(c) K={k} {mode}: finalize ran {fin['by_kind']} with a tail of {tail}")
                check(launches == len(stream), f"14(c) K={k} {mode}: B1 launched {launches} times for {len(stream)} steps")
                runs[mode] = {"final": final, "step_ms": statistics.median(times[3:]), "emissions": emitting, "tail": tail,
                              "finalize": dict(fin["by_kind"]), "launches": launches}
            for leader, states in runs["eager"]["final"].items():
                for name, value in states.items():
                    check(same_bits(torch, runs["captured"]["final"][leader][name], value),
                          f"14(c) K={k}: captured finalize of {leader}.{name} differs from the eager one")
            stats = step.stats
            check(step.broken is None, f"14(c) K={k}: the captured step fell back to eager: {step.broken}")
            graphs = [s for s in step._steps.values() if s.graph is not None]
            check(len(graphs) == len(step._steps) == (1 if k == 1 else 2), f"14(c) K={k}: {len(graphs)} graphs")
            print(f"phase 14(c) ({smi}): K={k}: {len(stream)} steps, {runs['captured']['emissions']} emissions and a tail of"
                  f" {runs['captured']['tail']} (finalize ran {runs['captured']['finalize']}); step median"
                  f" {runs['captured']['step_ms']:.3f} ms captured, {runs['eager']['step_ms']:.3f} ms eager (CUDA events);"
                  f" B1 launched {runs['captured']['launches']} times captured ({stats.cache_hits} replays of {len(graphs)}"
                  f" graphs, {stats.eager_calls} eager calls); collectives at capture {stats.collective_counts}; members"
                  f" {{{', '.join(f'{n}: {p}' for n, (p, _) in paths.items())}}}; finalize bitwise equal to sync_state")
            out[k] = {key: v for key, v in runs["captured"].items() if key != "final"}
            out[k].update(eager_step_ms=runs["eager"]["step_ms"], replays=stats.cache_hits, graphs=len(graphs),
                          collective_counts=dict(stats.collective_counts))
            del step, coll
    finally:
        sync.set_sync_mode(None)
    return out


def same_tree(torch, a, b) -> bool:
    got, want = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(got) == len(want) and all(same_bits(torch, g, w) for g, w in zip(got, want))


def synced_computes(torch, sync, coll, world, calls: int = 3):
    results, boxes, times = [], [], []
    with sync.sync_axes(world):
        for _ in range(calls):
            for m in coll.values():
                m._computed = None
            with sync.count_collectives() as box:
                res, ms = event_ms(torch, coll.compute)
            results.append(res)
            boxes.append(dict(box["by_kind"]))
            times.append(ms)
    return results, boxes, times


def phase_fourteen_d(torch, mt, sync, world, smi) -> dict:
    """14(d): synced computes through the compiled compute engine: the
    bucketed all_reduces inside the graph; then under sparse_count, whose
    host read the probe refuses."""
    coll = incremental_slice(mt, compiled=True)
    for _, probs, target in batches(torch):
        coll.update(probs, target)
    results, boxes, times = synced_computes(torch, sync, coll, world)
    for res in results[1:]:
        for key, value in results[0].items():
            check(same_tree(torch, res[key], value), f"14(d): captured synced compute {key} differs from the eager one")
    stats = coll.engine_stats()
    compute = stats["compute"]
    engine = coll._compute_engine
    graphs = [s.graph for s in engine._steps.values()] if engine is not None else []
    check(not stats["fallback_reasons"], f"14(d): fallbacks {stats['fallback_reasons']}")
    check((compute.eager_calls, compute.cache_misses, compute.cache_hits) == (1, 1, 1) and all(g is not None for g in graphs),
          f"14(d): compute engine calls {(compute.eager_calls, compute.cache_misses, compute.cache_hits)}, graphs {graphs}")
    check(boxes == [{"all_reduce": 3}] * 3, f"14(d): synced computes ran {boxes}")
    paths = {k: v["path"] for k, v in stats["partition"]["compute"].items()}
    check(set(paths.values()) == {"fused"}, f"14(d): compute paths {paths}")
    fields = {"collective_counts": dict(compute.collective_counts), "collective_bytes": dict(compute.collective_bytes),
              "collective_bytes_by_transport": {k: dict(v) for k, v in compute.collective_bytes_by_transport.items()},
              "transport_refusals": compute.transport_refusals}
    print(f"phase 14(d) ({smi}): synced compute eager, captured, replayed: bitwise equal, {boxes[0]} each, the replay's"
          f" inside the graph; {times[0]:.3f} / {times[1]:.3f} / {times[2]:.3f} ms (CUDA events); EngineStats {fields};"
          f" paths {paths}")
    sync.set_sync_transport("sparse_count")
    try:
        sparse = incremental_slice(mt, compiled=True)
        for _, probs, target in batches(torch):
            sparse.update(probs, target)
        s_results, s_boxes, s_times = synced_computes(torch, sync, sparse, world)
    finally:
        sync.set_sync_transport(None)
    for res in s_results:
        for key, value in results[0].items():
            check(same_tree(torch, res[key], value), f"14(d) sparse_count: synced compute {key} differs from exact")
    s_stats = sparse.engine_stats()
    s_paths = {k: (v["path"], v["reason"]) for k, v in s_stats["partition"]["compute"].items()}
    want = {k: ("fused" if k == "binned" else "eager") for k in s_paths}
    check({k: p for k, (p, _) in s_paths.items()} == want, f"14(d) sparse_count: paths {s_paths}")
    check(all("sparse_count" in r and "host" in r for k, (p, r) in s_paths.items() if k == "acc"),
          f"14(d) sparse_count: reasons {s_paths}")
    print(f"phase 14(d) ({smi}): under sparse_count the probe refused the int32 groups (their sync reads the nonzero"
          f" count to the host): {s_paths}; fallback_reasons {s_stats['fallback_reasons']}; results bitwise equal to"
          f" exact; {s_times[0]:.3f} / {s_times[1]:.3f} / {s_times[2]:.3f} ms")
    return {"eager_ms": times[0], "captured_ms": times[1:], "fields": fields, "paths": paths,
            "sparse_paths": {k: p for k, (p, _) in s_paths.items()}, "sparse_ms": s_times}


def phase_fourteen(torch, mt, np, kernels_mod, sync, smi) -> dict:
    import torch.distributed as dist
    from metrics_tpu_torch.core import engine

    t0 = time.perf_counter()
    kernels_mod.reset_launch_counts()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        world = dist.group.WORLD
        gloo = dist.new_group(ranks=[0], backend="gloo")
        a = phase_fourteen_a(torch, mt, sync, world, gloo, smi)
        b = phase_fourteen_b(torch, mt, sync, world, gloo, smi)
        kernels_mod.reset_launch_counts()
        c = phase_fourteen_c(torch, mt, kernels_mod, sync, engine, world, smi)
        kernels_mod.reset_launch_counts()
        d = phase_fourteen_d(torch, mt, sync, world, smi)
        launches = kernels_mod.launch_counts()
    finally:
        dist.destroy_process_group()
    elapsed = time.perf_counter() - t0
    b1 = sum(c[k]["launches"] for k in c)
    check(launches["pairwise_iou"] == launches["greedy_match"] == launches["maxsim_tf32x3"] == 0,
          f"phase 14 launched a detection or text kernel: {launches}")
    print(f"phase 14 ({smi}): {elapsed:.1f} s in all (limit {PHASE14_LIMIT_S:.0f} s); B1 launched {b1} times in 14(c)'s"
          f" streaks, {launches['binned_counts']} in 14(d)")
    check(elapsed < PHASE14_LIMIT_S, f"phase 14 took {elapsed:.1f} s, over its {PHASE14_LIMIT_S:.0f} s")
    return {"a": a, "b": b, "c": c, "d": d, "seconds": elapsed, "launches": {**launches, "binned_counts": b1}}


# --------------------------------------------------------------------------- #
# phase 15: sharded state (shard_state, the sharded update, the sharded-compute
# protocol, unshard_state), in a world of one NCCL rank
# --------------------------------------------------------------------------- #
PHASE15_LIMIT_S = 60.0
SHARD_NOTE = "a world of one shows capture, correctness and memory, not link cost"
GRID_SHAPE = (N_CLASSES, N_THRESHOLDS)
CAT_CAPACITY = 1 << 16


def updates_timed(torch, sync, metric, stream) -> tuple:
    """Each update's CUDA-event time and collectives."""
    times, boxes = [], []
    for args in stream:
        with sync.count_collectives() as box:
            _, ms = event_ms(torch, lambda: metric.update(*args))
        times.append(ms)
        boxes.append(dict(box["by_kind"]))
    return times, boxes


def computes(torch, sync, metric, calls: int = 3) -> tuple:
    """``calls`` computes (eager, captured, replayed): results and collectives."""
    results, boxes = [], []
    for _ in range(calls):
        metric._computed = None
        with sync.count_collectives() as box:
            results.append(metric.compute())
        boxes.append(dict(box["by_kind"]))
    return results, boxes


def phase_fifteen_a(torch, mt, sync, mesh, smi) -> dict:
    """15(a): the 4,096-class ConfusionMatrix, placed, eager then captured."""
    stream = list(confmat_stream(torch, dense=True))
    twin = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES)
    for preds, target in stream:
        twin.update(preds, target)
    metric = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES).shard_state(mesh)
    check(metric.active_shard_axes == {"confmat": 0}, f"15(a): active {metric.active_shard_axes}")
    times, boxes = updates_timed(torch, sync, metric, stream[:3])  # eager, probe + capture, first replay
    engine = metric._update_engine
    graphs = [s for s in engine._steps.values() if s.graph is not None]
    check(len(graphs) == 1 and engine.broken is None, f"15(a): {len(graphs)} graphs, broken {engine.broken}")
    check(engine.stats.collective_counts == {"reduce_scatter": 1},
          f"15(a): the captured step's collectives {engine.stats.collective_counts}")
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in stream[3:10]:
            with sync.count_collectives() as box:
                metric.update(*args)
            boxes.append(dict(box["by_kind"]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    gc.collect()
    torch.cuda.synchronize()
    drift = torch.cuda.memory_allocated() - held
    check(drift == 0, f"15(a): memory_allocated moved by {drift} bytes over 7 replayed updates")
    steady, steady_boxes = updates_timed(torch, sync, metric, stream[10:])
    boxes += steady_boxes
    check(boxes == [{"reduce_scatter": 1}] * len(stream), f"15(a): update collectives {boxes}")
    check(engine.stats.cache_hits == len(stream) - 2, f"15(a): {engine.stats.cache_hits} replays")
    check(same_bits(torch, metric.confmat, twin.confmat), "15(a): the block differs from the replicated twin's state")
    # the transient delta: the peak over one eager update (a captured step
    # draws from its graph's pool, allocated at capture, so it shows no peak)
    eager = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES, compiled_update=False).shard_state(mesh)
    eager_times, eager_boxes = updates_timed(torch, sync, eager, stream[:6])
    check(eager_boxes == [{"reduce_scatter": 1}] * 6, f"15(a): eager update collectives {eager_boxes}")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager.update(*stream[0])
    peak_eager = torch.cuda.max_memory_allocated() - base
    del eager
    metric.reset()
    for preds, target in stream:
        metric.update(preds, target)
    results, cboxes = computes(torch, sync, metric)
    want = twin.compute()
    for res in results:
        check(same_bits(torch, res, want), "15(a): the protocol's compute differs from the replicated twin's")
    check(cboxes == [{"all_gather": 1}] * 3, f"15(a): protocol computes ran {cboxes}")
    cstats = metric.engine_stats()["compute"]
    check((cstats.eager_calls, cstats.cache_misses, cstats.cache_hits) == (1, 1, 1),
          f"15(a): compute engine {(cstats.eager_calls, cstats.cache_misses, cstats.cache_hits)}")
    with sync.count_collectives() as ubox:
        metric.unshard_state()
    check(ubox["by_kind"] == {"reshard": 1} and ubox["bytes_by_kind"]["reshard"] == CONFMAT_CLASSES ** 2 * 4,
          f"15(a): unshard_state ticked {ubox['by_kind']} {ubox['bytes_by_kind']}")
    check(same_bits(torch, metric.confmat, twin.confmat) and same_bits(torch, metric.compute(), want),
          "15(a): the unsharded state differs from the replicated twin's")
    # forward, and sync_on_compute=False: a placed metric still syncs over its
    # placement (its blocks are not its value), through the engines
    fwd = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES, sync_on_compute=False).shard_state(mesh)
    fwd_twin = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES)
    fboxes = []
    for args in stream[:3]:
        want_batch = fwd_twin(*args)
        with sync.count_collectives() as box:
            got_batch = fwd(*args)
        fboxes.append(dict(box["by_kind"]))
        check(same_bits(torch, got_batch, want_batch), "15(a): the placed metric's forward differs from the twin's")
    check(all(b.get("reduce_scatter") == 1 and b.get("all_gather") == 1 and "reshard" not in b for b in fboxes),
          f"15(a): the placed metric's forward ran {fboxes}")
    check(same_bits(torch, fwd.compute(), fwd_twin.compute()) and same_bits(torch, fwd.confmat, fwd_twin.confmat),
          "15(a): after forward the placed metric differs from the twin")
    del fwd, fwd_twin
    state_mib = CONFMAT_CLASSES ** 2 * 4 / 2**20
    out = {"captured_ms": statistics.median(steady), "eager_ms": statistics.median(eager_times[1:]),
           "first_calls_ms": times, "peak_eager_mib": peak_eager / 2**20,
           "state_mib": state_mib, "memory_drift": drift}
    print(f"phase 15(a) ({smi}): ConfusionMatrix {CONFMAT_CLASSES} ({state_mib:.0f} MiB int32) placed on a mesh of one"
          f" ({SHARD_NOTE}): {len(stream)} updates of {CONFMAT_BATCH} pairs, one reduce_scatter each, the first eager, then"
          f" one graph ({engine.stats.cache_hits} replays, no host sync, memory_allocated flat); update median"
          f" {out['captured_ms']:.3f} ms captured, {out['eager_ms']:.3f} ms eager (CUDA events); peak"
          f" max_memory_allocated over one eager update {out['peak_eager_mib']:.1f} MiB (the whole-size delta; state"
          f" {state_mib:.0f} MiB); compute through the"
          f" protocol {cboxes[0]} (no reshard), eager/captured/replayed bitwise; unshard_state {dict(ubox['by_kind'])};"
          f" block and values bitwise equal to the replicated twin; forward with sync_on_compute=False {fboxes[-1]},"
          " bitwise")
    return out


def phase_fifteen_b(torch, mt, kernels_mod, sync, mesh, smi) -> dict:
    """15(b): the sharded binned curve and AP over phase 3's stream, B1 on
    their path, against the plain counts and a replicated twin."""
    stream = [(probs, target) for _, probs, target in batches(torch)]
    out = {}
    for cls in (mt.BinnedPrecisionRecallCurve, mt.BinnedAveragePrecision):
        label = cls.__name__
        twin = cls(num_classes=N_CLASSES, thresholds=N_THRESHOLDS)
        plain = cls(num_classes=N_CLASSES, thresholds=N_THRESHOLDS, compiled_update=False).shard_state(mesh)
        plain._plain_counts = True
        for probs, target in stream:
            twin.update(probs, target)
            plain.update(probs, target)
        metric = cls(num_classes=N_CLASSES, thresholds=N_THRESHOLDS).shard_state(mesh)
        kernels_mod.reset_launch_counts()
        times, boxes = updates_timed(torch, sync, metric, stream)
        launches = kernels_mod.launch_counts()["binned_counts"]
        check(launches == len(stream), f"15(b) {label}: B1 launched {launches} times for {len(stream)} updates")
        engine = metric._update_engine
        graphs = sum(s.graph is not None for s in engine._steps.values())
        ragged = len({probs.shape for probs, _ in stream}) - 1  # the last batch's signature runs eager once
        check(engine.broken is None and graphs == 1 and engine.stats.cache_hits == len(stream) - 2 - ragged,
              f"15(b) {label}: {graphs} graphs, {engine.stats.cache_hits} replays, broken {engine.broken}")
        check(boxes == [{"reduce_scatter": 1}] * len(stream), f"15(b) {label}: update collectives {set(map(str, boxes))}")
        for name in ("TPs", "FPs", "FNs"):
            check(same_bits(torch, getattr(metric, name), getattr(plain, name)),
                  f"15(b) {label}: block {name} differs from the plain counts' run")
            check(same_bits(torch, getattr(metric, name), getattr(twin, name)),
                  f"15(b) {label}: block {name} differs from the replicated twin's")
        with sync.count_collectives() as cbox:
            got = metric.compute()
        check(same_tree(torch, got, twin.compute()), f"15(b) {label}: the protocol's result differs from the twin's")
        check(cbox["by_kind"].get("reshard", 0) == 0, f"15(b) {label}: compute ran {cbox['by_kind']}")
        out[label] = {"launches": launches, "update_ms": statistics.median(times[3:]), "compute": dict(cbox["by_kind"])}
        print(f"phase 15(b) ({smi}): {label} {N_CLASSES} x {N_THRESHOLDS} placed ({SHARD_NOTE}): {len(stream)} updates, B1"
              f" launched {launches} times ({engine.stats.cache_hits} of them in replays of {graphs} graph), one"
              f" reduce_scatter each, update median {out[label]['update_ms']:.3f} ms"
              f" (CUDA events); blocks bitwise equal to the plain counts' run and the replicated twin's; compute"
              f" {dict(cbox['by_kind'])}, bitwise")
    return out


def phase_fifteen_c(torch, mt, sync, mesh, smi) -> dict:
    """15(c): micro Accuracy, macro Precision and a ConfusionMatrix, sharded
    and replicated members fused, against an unsharded collection."""

    def make():
        return mt.MetricCollection({
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="micro"),
            "prec": mt.Precision(num_classes=N_CLASSES, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=N_CLASSES),
        })

    ref, coll = make(), make().shard_state(mesh)
    for logits, _, target in batches(torch):
        ref.update(logits, target)
        coll.update(logits, target)
    got, want = coll.compute(), ref.compute()
    for key, value in want.items():
        check(same_bits(torch, got[key], value), f"15(c): {key} differs from the unsharded collection's")
    stats = coll.engine_stats()
    update = stats["update"]
    paths = {k: v["path"] for k, v in stats["partition"]["update"].items()}
    check(update is not None and update.cache_hits > 0 and paths == {"acc": "fused", "prec": "fused", "confmat": "fused"},
          f"15(c): update paths {paths}, stats {update}")
    check(update.collective_counts == {"reduce_scatter": 2}, f"15(c): fused step collectives {update.collective_counts}")
    print(f"phase 15(c) ({smi}): micro Accuracy, macro Precision and ConfusionMatrix {N_CLASSES}, the last two placed"
          f" ({SHARD_NOTE}), fused in one captured step ({update.cache_hits} replays, collectives {update.collective_counts});"
          f" results bitwise equal to the unsharded collection")
    return {"replays": update.cache_hits, "collectives": dict(update.collective_counts)}


def grid_metric_class(torch, mt, binned):
    class GridCounts(mt.Metric):
        """B1's true-positive counts as a class x threshold grid, split along
        both axes."""

        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.grid_t = binned.sort_thresholds(torch.linspace(0, 1, N_THRESHOLDS, device=self.device))
            self.add_state("grid", torch.zeros(GRID_SHAPE, dtype=torch.int32), dist_reduce_fx="sum", shard_axis=(0, 1))

        def update(self, probs, target):
            tp, _, _ = binned.binned_counts(probs, target, self.grid_t)
            self.grid = self.grid + tp.to(torch.int32)

        def compute(self):
            return self.grid.sum(dim=1, dtype=torch.int32)

    return GridCounts


def phase_fifteen_d(torch, mt, kernels_mod, sync, binned, smi) -> dict:
    """15(d): a grid leaf on a [1, 1] mesh."""
    import metrics_tpu_torch.parallel as par

    mesh = par.make_mesh([1, 1], ["cls", "thr"])
    grid_cls = grid_metric_class(torch, mt, binned)
    twin, metric = grid_cls(), grid_cls().shard_state(mesh, axis_name=("cls", "thr"))
    stream = [(probs, target) for _, probs, target in batches(torch)][:12]
    kernels_mod.reset_launch_counts()
    times, boxes = updates_timed(torch, sync, metric, stream)
    launches = kernels_mod.launch_counts()["binned_counts"]
    for args in stream:
        twin.update(*args)
    check(launches == len(stream), f"15(d): B1 launched {launches} times for {len(stream)} updates")
    check(boxes == [{"reduce_scatter": 2}] * len(stream), f"15(d): grid update collectives {boxes}")
    check(same_bits(torch, metric.grid, twin.grid), "15(d): the grid differs from the replicated twin's")
    with sync.count_collectives() as cbox:
        got = metric.compute()
    check(cbox["by_kind"] == {"reshard": 2} and same_bits(torch, got, twin.compute()),
          f"15(d): compute ran {cbox['by_kind']} or differs")
    with sync.count_collectives() as ubox:
        metric.unshard_state()
    check(ubox["by_kind"] == {"reshard": 1} and same_bits(torch, metric.grid, twin.grid),
          f"15(d): unshard_state ran {ubox['by_kind']} or differs")
    print(f"phase 15(d) ({smi}): a {GRID_SHAPE} grid of B1's counts placed over a [1, 1] mesh ({SHARD_NOTE}):"
          f" {len(stream)} updates, B1 launched {launches} times, two reduce_scatters each; compute"
          f" {dict(cbox['by_kind'])}, unshard {dict(ubox['by_kind'])}; bitwise equal to the replicated twin")
    return {"launches": launches, "update_ms": statistics.median(times[2:])}


def _copied(buf):
    """A buffer over copies of ``buf``'s tensors: a step with work to capture."""
    out = buf._alias()
    out.data, out.count, out.overflowed = buf.data.clone(), buf.count.clone(), buf.overflowed.clone()
    return out


def phase_fifteen_e(torch, mt, sync, mesh, smi) -> dict:
    """15(e): a sample-sharded CatMetric buffer, and the overflow flag.

    Its updates read sizes on the host, so they never run captured, and no
    entry point captures a step over such a buffer. The captured step here
    is built by hand around a copy of the state: it checks only that the
    engine's flattener takes the sharded buffer's leaves apart and rebuilds
    it, flag and host mirror included, not a metric's update."""
    from metrics_tpu_torch.core.buffers import CatBuffer, ShardedCatBuffer
    from metrics_tpu_torch.core.engine import CapturedStep, _carry_mirrors

    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    stream = [torch.randn((4096,), generator=gen, device="cuda") for _ in range(8)]
    twin, metric = mt.CatMetric(buffer_capacity=CAT_CAPACITY), mt.CatMetric(buffer_capacity=CAT_CAPACITY).shard_state(mesh)
    for x in stream:
        twin.update(x)
        metric.update(x)
    reasons = metric.engine_stats()["fallback_reasons"]
    check("host" in reasons.get("update:CatMetric", ""), f"15(e): fallback reasons {reasons}")
    with sync.count_collectives() as cbox:
        got = metric.compute()
    check(same_bits(torch, got, twin.compute()) and cbox["by_kind"] == {"all_gather": 1},
          f"15(e): the sharded buffer's compute ran {cbox['by_kind']} or differs")
    over = mt.CatMetric(buffer_capacity=CAT_CAPACITY)
    over.value = CatBuffer(torch.zeros(CAT_CAPACITY, device="cuda"), CAT_CAPACITY + 2, overflowed=True)
    over.shard_state(mesh)
    placed = over.value
    check(isinstance(placed, ShardedCatBuffer) and bool(placed.overflowed) and placed.overflow_seen,
          "15(e): the overflow flag did not survive the placement")
    step = CapturedStep(lambda state, args, kwargs: {k: _copied(v) for k, v in state.items()}, writes_state=True)
    step.probe({"value": placed}, (), {})
    check(step.graph is not None, "15(e): no CUDA graph was captured over the buffer's leaves")
    leaves = [placed.data, placed.count, placed.overflowed]
    result = step.run_update({"value": placed}, leaves, (), {}, [], False, [False, False, False])
    _carry_mirrors({"value": placed}, result, step.buffer_rows)
    through = result["value"]
    check(isinstance(through, ShardedCatBuffer) and bool(through.overflowed) and through.overflow_seen,
          "15(e): the overflow flag did not survive the captured step")
    over.value = through
    over.unshard_state()
    check(bool(over.value.overflowed) and over.value.overflow_seen and len(over.value) == CAT_CAPACITY + 2,
          "15(e): the overflow flag did not survive unshard_state")
    print(f"phase 15(e) ({smi}): CatMetric buffer of {CAT_CAPACITY} rows placed ({SHARD_NOTE}): {len(stream)} eager"
          f" updates (reason: {reasons['update:CatMetric']}); compute {dict(cbox['by_kind'])}, bitwise equal to the"
          " replicated twin; an overflowed buffer's flag survived the placement, a captured step and unshard_state")
    return {"compute": dict(cbox["by_kind"])}


def phase_fifteen(torch, mt, np, kernels_mod, sync, binned, smi) -> dict:
    import torch.distributed as dist

    import metrics_tpu_torch.parallel as par

    t0 = time.perf_counter()
    kernels_mod.reset_launch_counts()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = par.make_mesh([1], ["data"])
        a = phase_fifteen_a(torch, mt, sync, mesh, smi)
        b = phase_fifteen_b(torch, mt, kernels_mod, sync, mesh, smi)
        kernels_mod.reset_launch_counts()
        c = phase_fifteen_c(torch, mt, sync, mesh, smi)
        d = phase_fifteen_d(torch, mt, kernels_mod, sync, binned, smi)
        e = phase_fifteen_e(torch, mt, sync, mesh, smi)
        launches = kernels_mod.launch_counts()
    finally:
        dist.destroy_process_group()
    elapsed = time.perf_counter() - t0
    check(launches["pairwise_iou"] == launches["greedy_match"] == launches["maxsim_tf32x3"] == 0,
          f"phase 15 launched a detection or text kernel: {launches}")
    b1 = sum(r["launches"] for r in b.values()) + d["launches"]
    print(f"phase 15 ({smi}): {elapsed:.1f} s in all (limit {PHASE15_LIMIT_S:.0f} s); B1 launched {b1} times on the"
          " sharded binned and grid paths")
    check(elapsed < PHASE15_LIMIT_S, f"phase 15 took {elapsed:.1f} s, over its {PHASE15_LIMIT_S:.0f} s")
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "seconds": elapsed,
            "launches": {**{k: 0 for k in launches}, "binned_counts": b1}}


# --------------------------------------------------------------------------- #
# phase 16: observability and resilience on the captured main path
# --------------------------------------------------------------------------- #
PHASE16_LIMIT_S = 60.0
PHASE16_BATCHES = 8  # of phase 3's stream: the traced, profiled, faulted and scraped runs
PHASE16_REPLAYS = 200
# one steady-state update fault (a replay) and one at a synced compute's probe
CHAOS_SPECS = (("engine/dispatch", 3), ("sync/bucket_build", 3))
DISPATCH_EVENTS = ("dispatch/eager", "dispatch/compile", "dispatch/cached", "dispatch/fallback")


def slice_run(torch, mt, stream, device=None) -> tuple:
    """The slice at the engine defaults (config2 and the binned AP) over
    ``stream``, then three computes (eager, captured, replayed)."""
    coll, binned = build_slice(mt, compiled=True, device=device)
    for logits, probs, target in stream:
        coll.update(logits, target)
        binned.update(probs, target)
    results = []
    for _ in range(3):
        for m in (*coll.values(), binned):
            m._computed = None
        results.append((coll.compute(), torch.stack(binned.compute())))
    return coll, binned, results


def event_counts(events) -> tuple:
    """(name, category) multiset and the dispatch events' counts of a run."""
    pairs = {}
    for e in events:
        pairs[(e.name, e.cat)] = pairs.get((e.name, e.cat), 0) + 1
    return pairs, {name: sum(n for (k, _), n in pairs.items() if k == name) for name in DISPATCH_EVENTS}


def same_slice_results(torch, label: str, got: list, want: list) -> None:
    for n, ((res, ap), (res_w, ap_w)) in enumerate(zip(got, want)):
        for key, value in res_w.items():
            check(same_bits(torch, res[key], value), f"{label}: compute {n + 1} result {key} differs")
        check(same_bits(torch, ap, ap_w), f"{label}: compute {n + 1} binned AP differs")


def captured_everywhere(label: str, coll, binned) -> None:
    for name, engine in (("collection update", coll._update_engine), ("collection compute", coll._compute_engine),
                         ("binned update", binned._update_engine), ("binned compute", binned._compute_engine)):
        check(engine is not None and engine.broken is None and engine.stats.cache_hits >= 1
              and all(step.graph is not None for step in engine._steps.values()),
              f"{label}: the {name} engine is not replaying graphs ({getattr(engine, 'broken', None)})")


def phase_sixteen_a(torch, mt, obs, kernels_mod, stream, out_dir, smi) -> dict:
    """16(a): the captured slice under the tracer: the events of the CPU's
    run of the same calls, a valid Chrome export, B1's untraced launches, the
    untraced results bit for bit, the tracer-on replays under
    set_sync_debug_mode("error")."""
    kernels_mod.reset_launch_counts()
    _, _, plain = slice_run(torch, mt, stream)
    torch.cuda.synchronize()
    untraced = kernels_mod.launch_counts()["binned_counts"]
    kernels_mod.reset_launch_counts()
    coll, binned = build_slice(mt, compiled=True)
    with obs.trace() as tracer:
        for i, (logits, probs, target) in enumerate(stream):
            if i >= 2:  # the replays: no device sync with the tracer on either
                torch.cuda.set_sync_debug_mode("error")
            try:
                coll.update(logits, target)
                binned.update(probs, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        results = []
        for _ in range(3):
            for m in (*coll.values(), binned):
                m._computed = None
            results.append((coll.compute(), torch.stack(binned.compute())))
        torch.cuda.synchronize()
    traced = kernels_mod.launch_counts()["binned_counts"]
    card_pairs, card_dispatch = event_counts(tracer.events())
    with obs.trace() as cpu_tracer:
        slice_run(torch, mt, [tuple(x.cpu() for x in batch) for batch in stream], device="cpu")
    cpu_pairs, cpu_dispatch = event_counts(cpu_tracer.events())
    check(card_pairs == cpu_pairs and card_dispatch == cpu_dispatch,
          f"16(a): the card's events {card_pairs} differ from the CPU's {cpu_pairs}")
    check(traced == untraced == len(stream), f"16(a): B1 launched {traced} times traced, {untraced} untraced, for"
                                             f" {len(stream)} binned updates")
    same_slice_results(torch, "16(a) traced", results, plain)
    captured_everywhere("16(a)", coll, binned)
    doc = obs.to_chrome_trace(tracer)
    problems = obs.validate_chrome_trace(doc)
    check(not problems, f"16(a): the Chrome export is invalid: {problems[:3]}")
    path = obs.write_chrome_trace(f"{out_dir}/host.trace.json", tracer)
    print(f"phase 16(a) ({smi}): {len(stream)} captured slice updates and 3 computes under the tracer: events"
          f" {dict(sorted((f'{k}/{c}', n) for (k, c), n in card_pairs.items()))} equal to the CPU run's; dispatch"
          f" {card_dispatch}; B1 launched {traced} times traced and {untraced} untraced; results bitwise equal to the"
          f" untraced run; replays under sync debug mode 'error'; Chrome export valid ({obs.load_trace(path)['otherData']['producer']})")
    return {"events": {f"{k}|{c}": n for (k, c), n in card_pairs.items()}, "dispatch": card_dispatch,
            "launches": traced, "untraced_launches": untraced, "results": results}


def phase_sixteen_b(torch, mt, obs, stream, reference, out_dir, smi) -> dict:
    """16(b): the same run under torch.profiler, correlated with the host
    spans through the record_function names."""
    from torch.profiler import ProfilerActivity, profile

    with obs.trace() as tracer, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coll, binned, results = slice_run(torch, mt, stream)
        torch.cuda.synchronize()
    same_slice_results(torch, "16(b) profiled", results, reference)
    captured_everywhere("16(b)", coll, binned)
    path = f"{out_dir}/device.trace.json"
    prof.export_chrome_trace(path)
    device_doc = obs.load_trace(path)
    annotations = {}
    for rec in device_doc.get("traceEvents", []):
        if isinstance(rec, dict) and obs.parse_dispatch_annotation(str(rec.get("name", ""))) is not None:
            annotations[rec.get("cat")] = annotations.get(rec.get("cat"), 0) + 1
    combined = obs.correlate_device_trace(obs.to_chrome_trace(tracer), device_doc)
    corr = combined["otherData"]["correlation"]
    problems = obs.validate_chrome_trace(combined)
    check(not problems, f"16(b): the correlated trace is invalid: {problems[:3]}")
    check(corr["host_dispatches"] > 0, "16(b): no host dispatch span to correlate")
    by_kind = {}
    for rec in combined["traceEvents"]:
        if rec.get("ph") == "X" and str(rec.get("name", "")).startswith("dispatch/"):
            key = rec["name"]
            hit = "annotation" in rec.get("args", {})
            by_kind.setdefault(key, [0, 0])[0 if hit else 1] += 1
    print(f"phase 16(b) ({smi}): torch.profiler over the same run: bridge annotations by category {annotations};"
          f" {corr['matched']} of {corr['host_dispatches']} host dispatch spans matched,"
          f" {corr['host_dispatches'] - corr['matched']} unmatched (matched, unmatched by event: {by_kind}); offset"
          f" {corr['offset_us']:.1f} us; {corr['device_events']} device events; results bitwise equal to 16(a)'s")
    return {"matched": corr["matched"], "unmatched": corr["host_dispatches"] - corr["matched"],
            "host_dispatches": corr["host_dispatches"], "annotations": annotations, "by_event": by_kind}


def chaos_run(torch, mt, obs, chaos, sync, stream, group, specs, device=None) -> tuple:
    """16(c): config2 at the engine defaults over ``stream``, then five
    synced computes over ``group``, under ``specs`` (none: fault-free) and
    the tracer, with a probation cooldown of one dispatch."""
    import contextlib

    mt.set_probation(1)
    try:
        coll, _ = build_slice(mt, compiled=True, device=device)
        plan_ctx = chaos.plan([chaos.FaultSpec(site, nth=n) for site, n in specs], seed=SEED) if specs else \
            contextlib.nullcontext()
        with obs.trace() as tracer, plan_ctx as plan, sync.sync_axes(group):
            for logits, _, target in stream:
                coll.update(logits, target)
            results = []
            for _ in range(5):
                for m in coll.values():
                    m._computed = None
                results.append(dict(coll.compute()))
    finally:
        mt.set_probation(None)
    log = [(e.site, e.kind, e.call, e.spec_index) for e in plan.log] if specs else []
    return coll, results, log, tracer.events()


def replays_after_faults(events) -> dict:
    """Per kind, the collection's replays after the last fault at its site."""
    sites = {"update": "engine/dispatch", "compute": "sync/bucket_build"}
    out = {}
    for kind, site in sites.items():
        last = max((i for i, e in enumerate(events) if e.name == "chaos/fault" and e.args["site"] == site), default=-1)
        out[kind] = sum(1 for e in events[last + 1:] if e.name == "dispatch/cached"
                        and e.args["owner"] == "MetricCollection" and e.args["kind"] == kind)
    return out


def phase_sixteen_c(torch, mt, obs, stream, sync, smi) -> dict:
    """16(c): a chaos plan in a world of one NCCL rank (the CPU twin's sync
    over a gloo group of the same rank): the same FaultEvent list, computes
    bitwise equal to the fault-free card run, graphs replaying after the
    faults and no capture left open."""
    import torch.distributed as dist

    from metrics_tpu_torch.resilience import chaos

    world = dist.group.WORLD
    gloo = dist.new_group(ranks=[0], backend="gloo")
    cpu_stream = [tuple(x.cpu() for x in batch) for batch in stream]
    _, clean, _, _ = chaos_run(torch, mt, obs, chaos, sync, stream, world, ())
    coll, faulted, log, events = chaos_run(torch, mt, obs, chaos, sync, stream, world, CHAOS_SPECS)
    torch.cuda.synchronize()
    check(not torch.cuda.is_current_stream_capturing(), "16(c): a capture was left open")
    cpu_coll, cpu_results, cpu_log, cpu_events = chaos_run(torch, mt, obs, chaos, sync, cpu_stream, gloo, CHAOS_SPECS,
                                                           device="cpu")
    check(log == cpu_log and len(log) == len(CHAOS_SPECS), f"16(c): the card's faults {log} differ from the CPU's {cpu_log}")
    check(event_counts(events) == event_counts(cpu_events), "16(c): the card's events differ from the CPU's")
    for n, res in enumerate(faulted):
        for key, value in clean[-1].items():
            check(same_bits(torch, res[key], value), f"16(c): compute {n + 1} {key} differs from the fault-free run")
            # the card's and the CPU's float arithmetic may differ in the last place
            check(torch.allclose(res[key].cpu(), cpu_results[n][key], rtol=1e-6, atol=0.0),
                  f"16(c): compute {n + 1} {key} is not within 1e-6 of the CPU's")
    stats = coll._dispatcher.stats
    check(vars(stats) == vars(cpu_coll._dispatcher.stats), f"16(c): partition {stats} differs from the CPU's")
    after = replays_after_faults(events)
    engine = coll._compute_engine
    check(min(after.values()) >= 1 and engine is not None and engine.broken is None
          and all(step.graph is not None for step in engine._steps.values()),
          f"16(c): graph replays after the faults {after}, compute engine {engine}")
    print(f"phase 16(c) ({smi}): chaos plan {list(CHAOS_SPECS)} over {len(stream)} config2 updates and 5 synced"
          f" computes in a world of one NCCL rank: faults {log}, and the events, equal to the CPU twin's; partition"
          f" {vars(stats)}; every compute bitwise equal to the fault-free card run; collection replays after the"
          f" faults {after}; no capture left open")
    return {"log": log, "partition": vars(stats), "replays_after_faults": after}


def warned(torch, fn) -> list:
    """The warnings ``fn`` raises, with each device sync it makes as one
    (``set_sync_debug_mode("warn")``)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught]


def phase_sixteen_d(torch, mt, stream, smi) -> dict:
    """16(d): the guard's quarantine on a NaN batch of a captured
    MeanSquaredError: the state bit for bit the clean run's, one device sync
    per guarded update and none in the unguarded replays."""
    from metrics_tpu_torch.resilience import guard

    pairs = [(probs.max(dim=1).values, (target == probs.argmax(dim=1)).float()) for _, probs, target in stream]
    poisoned = pairs[4][0].clone()
    poisoned[7] = float("nan")
    clean = mt.MeanSquaredError()
    for i, (p, t) in enumerate(pairs):
        if i != 4:
            clean.update(p, t)
    guarded = mt.MeanSquaredError()
    syncs, quarantined = [], 0
    with guard.guarded("quarantine"):
        for i, (p, t) in enumerate(pairs):
            messages = warned(torch, lambda p=poisoned if i == 4 else p, t=t: guarded.update(p, t))
            syncs.append(sum("synchronizing" in m for m in messages))
            quarantined += sum("quarantined" in m for m in messages)
    unguarded = mt.MeanSquaredError()
    plain_syncs = [sum("synchronizing" in m for m in warned(torch, lambda p=p, t=t: unguarded.update(p, t)))
                   for p, t in pairs]
    torch.cuda.synchronize()
    for key, value in clean.get_state().items():
        check(same_bits(torch, guarded.get_state()[key], value), f"16(d): state {key} differs from the clean run")
    check(quarantined == 1 and guarded._update_count == len(pairs) - 1, f"16(d): {quarantined} quarantines")
    # the replays (from the third call): one read of the guard's flags each, none unguarded
    check(all(n == 1 for n in syncs[2:]) and all(n == 0 for n in plain_syncs[2:]),
          f"16(d): guarded updates made {syncs} device syncs, unguarded {plain_syncs}")
    stats = guarded._update_engine.stats
    print(f"phase 16(d) ({smi}): the guard quarantined the NaN batch of a captured MeanSquaredError: state bitwise"
          f" equal to the run without it; device syncs per guarded update {syncs} (unguarded {plain_syncs});"
          f" engine eager/captures/replays {stats.eager_calls}/{stats.cache_misses}/{stats.cache_hits},"
          f" in place {stats.donated_calls} (the guard's snapshot turns in-place updates off)")
    return {"syncs": syncs, "unguarded_syncs": plain_syncs}


_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"


def strict_prometheus(text: str) -> dict:
    """An unforgiving reader of the text exposition format: every line a
    HELP/TYPE header or a sample, families contiguous, labels well formed.
    Returns ``{family: [(name, labels, value), ...]}``."""
    import re

    sample_re = re.compile(rf"^(?P<name>{_PROM_NAME})(?:\{{(?P<labels>.*)\}})? (?P<value>[^ ]+)$")
    label_re = re.compile(rf'(?P<key>{_PROM_NAME})="(?P<value>(?:[^"\\]|\\.)*)"(?:,|$)')
    header_re = re.compile(rf"^# (?P<kw>HELP|TYPE) (?P<name>{_PROM_NAME}) (?P<rest>.+)$")
    check(text.endswith("\n"), "16(e): the exposition must end with a newline")
    families, current, closed, types = {}, None, set(), {}
    for n, line in enumerate(text.splitlines(), start=1):
        header = header_re.match(line)
        if header:
            fam = header.group("name")
            check(fam not in closed, f"16(e): line {n}: family {fam} reopened")
            if header.group("kw") == "HELP":
                if current is not None:
                    closed.add(current)
                current = fam
                families[fam] = []
            else:
                check(fam == current and header.group("rest") in ("counter", "gauge", "histogram"),
                      f"16(e): line {n}: {line!r}")
                types[fam] = header.group("rest")
            continue
        m = sample_re.match(line)
        check(m is not None and current is not None, f"16(e): line {n}: unparseable {line!r}")
        name = m.group("name")
        check(name == current or (types.get(current) == "histogram" and name in (
            f"{current}_bucket", f"{current}_sum", f"{current}_count")), f"16(e): line {n}: {name} outside {current}")
        labels, consumed = {}, 0
        for lm in label_re.finditer(m.group("labels") or ""):
            labels[lm.group("key")] = lm.group("value")
            consumed = lm.end()
        check(consumed == len(m.group("labels") or ""), f"16(e): line {n}: trailing label junk")
        families[current].append((name, labels, float(m.group("value").replace("Inf", "inf"))))
    return families


def phase_sixteen_e(torch, mt, obs, stream, smi) -> dict:
    """16(e): ``/metrics`` scraped from 127.0.0.1 after every update of a
    captured streak, each body parsed strictly; the streak goes on."""
    import urllib.request

    server = obs.serve(port=0)
    try:
        check(server.kind == "http" and server.host == "127.0.0.1", f"16(e): the server is {server.kind} on {server.host}")
        coll, binned = build_slice(mt, compiled=True)
        hits, scrape_ms = [], []
        for i, (logits, probs, target) in enumerate(stream):
            if i >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                coll.update(logits, target)
                binned.update(probs, target)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            t0 = time.perf_counter()
            with urllib.request.urlopen(server.url + "/metrics", timeout=30) as resp:
                check(resp.status == 200, f"16(e): /metrics answered {resp.status}")
                body = resp.read().decode()
            scrape_ms.append((time.perf_counter() - t0) * 1e3)
            families = strict_prometheus(body)
            seen = [v for _, labels, v in families["metrics_tpu_engine_cache_hits"]
                    if labels == {"kind": "update", "owner": "MetricCollection"}]
            replays = coll._update_engine.stats.cache_hits
            check(replays in seen, f"16(e): scrape {i + 1} shows collection replays {seen}, not {replays}")
            hits.append(replays)
        check(coll._members_stale and hits[-1] == len(stream) - 2, f"16(e): the streak broke or replays {hits}")
    finally:
        obs.shutdown()
    print(f"phase 16(e) ({smi}): /metrics scraped from 127.0.0.1 after each of {len(stream)} captured updates, every"
          f" body strictly parsed ({len(families)} families); collection replays seen {hits}; scrape"
          f" {statistics.median(scrape_ms):.2f} ms median (host clock); the streak kept its detached members")
    return {"families": len(families), "scrape_ms": statistics.median(scrape_ms)}


def replay_ms(torch, coll, binned, stream, steps: int) -> float:
    """Median CUDA-event time of one captured slice update step over ``steps`` replays."""
    times = []
    for i in range(steps):
        logits, probs, target = stream[i % len(stream)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        coll.update(logits, target)
        binned.update(probs, target)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_sixteen_f(torch, mt, obs, stream, smi) -> dict:
    """16(f): the captured slice update step, tracer off, on, on, off, over
    PHASE16_REPLAYS replays each."""
    coll, binned = build_slice(mt, compiled=True)
    for logits, probs, target in stream[:3]:  # eager, capture, replay
        coll.update(logits, target)
        binned.update(probs, target)
    full = [b for b in stream if b[2].shape[0] == BATCH]
    times = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        if label == "on":
            with obs.trace():
                times[label].append(replay_ms(torch, coll, binned, full, PHASE16_REPLAYS))
        else:
            times[label].append(replay_ms(torch, coll, binned, full, PHASE16_REPLAYS))
    check(coll._update_engine.stats.cache_hits == 4 * PHASE16_REPLAYS + 1, "16(f): a timed step did not replay")
    print(f"phase 16(f) ({smi}): captured slice update step (config2 + binned AP), median of {PHASE16_REPLAYS}"
          f" replays by CUDA events: tracer off {times['off'][0] * 1e3:.1f}, {times['off'][1] * 1e3:.1f} us; on"
          f" {times['on'][0] * 1e3:.1f}, {times['on'][1] * 1e3:.1f} us (order off, on, on, off)")
    return {"off_us": [t * 1e3 for t in times["off"]], "on_us": [t * 1e3 for t in times["on"]]}


def phase_sixteen(torch, mt, np, kernels_mod, sync, smi) -> dict:
    import tempfile

    import torch.distributed as dist

    from metrics_tpu_torch import observability as obs

    t0 = time.perf_counter()
    stream = list(batches(torch))
    head = stream[:PHASE16_BATCHES]
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase16_") as out_dir:  # the two traces
        a = phase_sixteen_a(torch, mt, obs, kernels_mod, head, out_dir, smi)
        b = phase_sixteen_b(torch, mt, obs, head, a["results"], out_dir, smi)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        c = phase_sixteen_c(torch, mt, obs, head, sync, smi)
    finally:
        dist.destroy_process_group()
    d = phase_sixteen_d(torch, mt, head, smi)
    gc.collect()  # the registry then lists only the live engines
    e = phase_sixteen_e(torch, mt, obs, head, smi)
    f = phase_sixteen_f(torch, mt, obs, stream, smi)
    launches = kernels_mod.launch_counts()
    elapsed = time.perf_counter() - t0
    check(launches["pairwise_iou"] == launches["greedy_match"] == launches["maxsim_tf32x3"] == 0,
          f"phase 16 launched a detection or text kernel: {launches}")
    check(launches["binned_counts"] > 0, "phase 16: B1 was never launched")
    check(not obs.enabled(), "phase 16 left the tracer on")
    print(f"phase 16 ({smi}): {elapsed:.1f} s in all (limit {PHASE16_LIMIT_S:.0f} s); B1 launched"
          f" {launches['binned_counts']} times on the traced, profiled, scraped and timed slice runs")
    check(elapsed < PHASE16_LIMIT_S, f"phase 16 took {elapsed:.1f} s, over its {PHASE16_LIMIT_S:.0f} s")
    del stream
    return {"a": {k: v for k, v in a.items() if k != "results"}, "b": b, "c": c, "d": d, "e": e, "f": f,
            "seconds": elapsed, "launches": launches}


# --------------------------------------------------------------------------- #
# phase 17: checkpoint and tenancy (B1's tenant-batched launch on the path)
# --------------------------------------------------------------------------- #
PHASE17_LIMIT_S = 60.0
# config2 (bench.py's collection: 10 classes, 64-row batches) beside the dry
# run's BinnedAveragePrecision(num_classes=8, thresholds=21)
CKPT_CLASSES, CKPT_ROWS, CKPT_BATCHES = 10, 64, 40
CKPT_BLOCKING_AT, CKPT_OVERLAP_AT, CKPT_CRASH_AT = 10, 15, 20
DRY_CLASSES, DRY_THRESHOLDS = 8, 21
TENANTS, TENANT_ROWS, TENANT_STEPS = 1024, 64, 3
RAGGED = (37, 38, 5)  # active tenants of 1,024 in three dispatches
TENANCY_SWEEP, TENANCY_TIMED_STEPS = (16, 256, 1024), 3
MERGE_SHARDS = 4


def config2_pair(mt, device=None):
    """The config2 collection and the dry run's binned AP, with the engines at
    their defaults (captured on the card)."""
    coll = mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=CKPT_CLASSES, average="micro", device=device),
        "f1": mt.F1Score(num_classes=CKPT_CLASSES, average="macro", device=device),
        "precision": mt.Precision(num_classes=CKPT_CLASSES, average="macro", device=device),
        "recall": mt.Recall(num_classes=CKPT_CLASSES, average="macro", device=device),
    })
    return coll, mt.BinnedAveragePrecision(num_classes=DRY_CLASSES, thresholds=DRY_THRESHOLDS, device=device)


def ckpt_stream(torch):
    """CKPT_BATCHES seeded (logits, target, scores, labels) batches on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
    out = []
    for _ in range(CKPT_BATCHES):
        target = torch.randint(0, CKPT_CLASSES, (CKPT_ROWS,), generator=gen, device="cuda")
        logits = torch.randn((CKPT_ROWS, CKPT_CLASSES), generator=gen, device="cuda")
        logits[torch.arange(CKPT_ROWS, device="cuda"), target] += 1.0
        scores = torch.rand((CKPT_ROWS, DRY_CLASSES), generator=gen, device="cuda")
        labels = torch.randint(0, DRY_CLASSES, (CKPT_ROWS,), generator=gen, device="cuda")
        out.append((logits, target, scores, labels))
    return out


def feed_ckpt(coll, binned, batches) -> None:
    for logits, target, scores, labels in batches:
        coll.update(logits, target)
        binned.update(scores, labels)


def pair_states(torch, coll, binned) -> dict:
    """Copies of every state leaf (on the card)."""
    states = slice_states(coll, binned)
    return {k: v.clone() for k, v in states.items()}


def coll_states(coll) -> dict:
    """Copies of a collection's state leaves."""
    return {f"{k}.{s}": v.clone() for k, m in coll.items(keep_base=True) for s, v in m.get_state().items()}


def pair_results(torch, coll, binned) -> dict:
    return {**coll.compute(), "binned": torch.stack(binned.compute())}


def same_dicts(torch, label: str, got: dict, want: dict) -> None:
    check(got.keys() == want.keys(), f"{label}: keys {sorted(got)} != {sorted(want)}")
    for k in want:
        check(got[k].device == want[k].device and same_bits(torch, got[k], want[k]), f"{label}: {k} differs")


def save_pair(ckpt, coll, binned, root: str, **kw) -> list:
    return [ckpt.save_checkpoint(coll, f"{root}/coll", **kw), ckpt.save_checkpoint(binned, f"{root}/binned", **kw)]


def restore_pair(ckpt, mt, root: str, step=None) -> tuple:
    coll, binned = config2_pair(mt)
    infos = [ckpt.restore_checkpoint(coll, f"{root}/coll", step), ckpt.restore_checkpoint(binned, f"{root}/binned", step)]
    return coll, binned, infos


def phase_seventeen_a(torch, mt, ckpt, kernels_mod, stream, tmp, smi) -> dict:
    """17(a): save, crash and restore on the captured main path."""
    ref_coll, ref_bin = config2_pair(mt)
    before = kernels_mod.launch_counts()["binned_counts"]
    feed_ckpt(ref_coll, ref_bin, stream[:CKPT_BLOCKING_AT])
    at_blocking = pair_states(torch, ref_coll, ref_bin)
    feed_ckpt(ref_coll, ref_bin, stream[CKPT_BLOCKING_AT:CKPT_OVERLAP_AT])
    at_overlap = pair_states(torch, ref_coll, ref_bin)
    feed_ckpt(ref_coll, ref_bin, stream[CKPT_OVERLAP_AT:])
    want = pair_results(torch, ref_coll, ref_bin)
    ref_launches = kernels_mod.launch_counts()["binned_counts"] - before
    check(ref_launches == CKPT_BATCHES, f"17(a): the uninterrupted run launched B1 {ref_launches} times")
    check(ref_bin._update_engine is not None and ref_bin._update_engine.broken is None, "17(a): the binned update fell back")

    root = f"{tmp}/main"
    coll, binned = config2_pair(mt)
    feed_ckpt(coll, binned, stream[:CKPT_BLOCKING_AT])
    blocking = save_pair(ckpt, coll, binned, root)
    check(all(h.committed for h in blocking), "17(a): the blocking save did not commit")
    feed_ckpt(coll, binned, stream[CKPT_BLOCKING_AT:CKPT_OVERLAP_AT])
    overlap = save_pair(ckpt, coll, binned, root, blocking=False, overlap_copy=True)
    feed_ckpt(coll, binned, stream[CKPT_OVERLAP_AT:CKPT_CRASH_AT])  # captured replays while the copies drain
    for h in overlap:
        h.wait()
    check(all(h.committed for h in overlap), "17(a): the overlapped save did not commit")
    engines = [m._update_engine for m in (binned,)] + [coll._update_engine]
    check(all(e is not None and e.broken is None and e.stats.cache_hits > 0 for e in engines),
          "17(a): the saved run's updates were not replays of captured steps")
    del coll, binned, engines  # the crash
    gc.collect()

    early_c, early_b, _ = restore_pair(ckpt, mt, root, step=0)
    same_dicts(torch, "17(a) blocking snapshot", pair_states(torch, early_c, early_b), at_blocking)
    coll, binned, infos = restore_pair(ckpt, mt, root)
    check(all(i.step == 1 and i.fallback_from is None for i in infos), f"17(a): restored steps {[i.step for i in infos]}")
    same_dicts(torch, "17(a) overlapped snapshot", pair_states(torch, coll, binned), at_overlap)
    check(all(v.device.type == "cuda" for v in pair_states(torch, coll, binned).values()), "17(a): a leaf left the card")
    before = kernels_mod.launch_counts()["binned_counts"]
    feed_ckpt(coll, binned, stream[CKPT_OVERLAP_AT:])
    launches = kernels_mod.launch_counts()["binned_counts"] - before
    check(launches == CKPT_BATCHES - CKPT_OVERLAP_AT, f"17(a): the restored run launched B1 {launches} times")
    same_dicts(torch, "17(a) results after restore", pair_results(torch, coll, binned), want)

    # a snapshot written by the port on the CPU, at the same seed, onto the card
    cpu_coll, cpu_bin = config2_pair(mt, device="cpu")
    feed_ckpt(cpu_coll, cpu_bin, [tuple(x.cpu() for x in b) for b in stream[:CKPT_OVERLAP_AT]])
    save_pair(ckpt, cpu_coll, cpu_bin, f"{tmp}/cpu")
    card_c, card_b, _ = restore_pair(ckpt, mt, f"{tmp}/cpu")
    same_dicts(torch, "17(a) CPU snapshot on the card", pair_states(torch, card_c, card_b), at_overlap)
    feed_ckpt(card_c, card_b, stream[CKPT_OVERLAP_AT:])
    same_dicts(torch, "17(a) results from the CPU snapshot", pair_results(torch, card_c, card_b), want)
    timings = {"blocking": blocking[0].timings, "overlap": overlap[0].timings, "restore": infos[0].timings}
    for label, t in timings.items():
        print(f"phase 17(a) ({smi}): config2 {label}: " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in t.items()))
    print(f"phase 17(a) ({smi}): save at {CKPT_BLOCKING_AT}, overlapped save at {CKPT_OVERLAP_AT} while {CKPT_CRASH_AT - CKPT_OVERLAP_AT}"
          f" captured steps replayed, crash at {CKPT_CRASH_AT}, restore, {CKPT_BATCHES - CKPT_OVERLAP_AT} more: results bitwise"
          f" equal to the uninterrupted run; B1 launched {launches} times after the restore; the CPU snapshot restores"
          " onto the card bitwise")
    return {"timings": timings, "launches_after_restore": launches}


def ckpt_bytes(ckpt, root: str) -> int:
    from metrics_tpu_torch.checkpoint import io as ckpt_io

    manifest = ckpt_io.read_manifest(root, ckpt_io.latest_step(root))
    return sum(int(s["bytes"]) for s in manifest["shards"])


def phase_seventeen_b(torch, mt, ckpt, mesh, tmp, smi) -> dict:
    """17(b): the 4,096-class ConfusionMatrix (a 64 MiB int32 state), plain and
    placed, through save, verify and restore; then a 4 -> 1 merge."""
    stream = list(itertools.islice(confmat_stream(torch, dense=True), 2))
    out = {}
    for label, make in (("plain", lambda: mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES)),
                        ("placed", lambda: mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES).shard_state(mesh))):
        metric = make()
        for preds, target in stream:
            metric.update(preds, target)
        torch.cuda.synchronize()
        root = f"{tmp}/confmat_{label}"
        handle = ckpt.save_checkpoint(metric, root)
        t0 = time.perf_counter()
        report = ckpt.verify_checkpoint(root)
        verify_s = time.perf_counter() - t0
        check(handle.committed and report.ok, f"17(b) {label}: committed {handle.committed}, verify {report.issues}")
        fresh = make()
        info = ckpt.restore_checkpoint(fresh, root)
        torch.cuda.synchronize()
        check(fresh.confmat.device.type == "cuda" and same_bits(torch, fresh.confmat, metric.confmat),
              f"17(b) {label}: the restored state differs")
        check(same_bits(torch, fresh.compute(), metric.compute()), f"17(b) {label}: the restored compute differs")
        nbytes = ckpt_bytes(ckpt, root)
        out[label] = {"bytes": nbytes, "save": handle.timings, "verify_s": verify_s, "restore": info.timings}
        print(f"phase 17(b) ({smi}): confmat {CONFMAT_CLASSES} classes, {label}: {nbytes} bytes on disk; save "
              + ", ".join(f"{k} {v:.4f} s" for k, v in handle.timings.items())
              + f"; verify {verify_s:.4f} s; restore " + ", ".join(f"{k} {v:.4f} s" for k, v in info.timings.items()))
    plain = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES)
    for preds, target in stream:
        plain.update(preds, target)
    root4, merged = f"{tmp}/four", f"{tmp}/merged"
    handles = [ckpt.save_checkpoint(plain, root4, step=0, shard_index=i, world_size=MERGE_SHARDS)
               for i in range(MERGE_SHARDS)]
    check([h.committed for h in handles] == [False] * (MERGE_SHARDS - 1) + [True],
          f"17(b): commits {[h.committed for h in handles]} (only the last shard commits)")
    t0 = time.perf_counter()
    ckpt.merge_shards(root4, merged)
    merge_s = time.perf_counter() - t0
    fresh = mt.ConfusionMatrix(num_classes=CONFMAT_CLASSES)
    ckpt.restore_checkpoint(fresh, merged)
    check(same_bits(torch, fresh.confmat, plain.confmat * MERGE_SHARDS), "17(b): the merged state is not the shards' sum")
    out["merge"] = {"shards": MERGE_SHARDS, "bytes_in": ckpt_bytes(ckpt, root4), "bytes_out": ckpt_bytes(ckpt, merged),
                    "seconds": merge_s}
    print(f"phase 17(b) ({smi}): merge_shards {MERGE_SHARDS} -> 1: {out['merge']['bytes_in']} bytes in,"
          f" {out['merge']['bytes_out']} out, {merge_s:.4f} s; the merged state is the shards' sum, bitwise")
    return out


def phase_seventeen_c(torch, mt, ckpt, stream, tmp, smi) -> dict:
    """17(c): storage and commit faults under a RetryPolicy, then a corrupt
    newest step that the restore falls back from."""
    import warnings

    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.resilience import FaultSpec, RetryPolicy, call_with_retry, chaos

    root = f"{tmp}/faults"
    coll, _ = config2_pair(mt)
    for logits, target, _, _ in stream[:CKPT_BLOCKING_AT]:
        coll.update(logits, target)
    want = coll_states(coll)
    policy = RetryPolicy(backoff_base_s=0.0, backoff_max_s=0.0, jitter=0.0, seed=0)
    specs = [FaultSpec("storage/write", every=3, times=4), FaultSpec("ckpt/commit", nth=1, times=1)]
    with ckpt.use_retry_policy(policy), chaos.plan(specs, seed=0) as plan:
        handle = call_with_retry(lambda: ckpt.save_checkpoint(coll, root, step=0), policy, op="save")
        fired = {site: plan.fired(site) for site in ("storage/write", "ckpt/commit")}
    check(handle.committed and fired["storage/write"] >= 1 and fired["ckpt/commit"] == 1,
          f"17(c): committed {handle.committed}, faults fired {fired}")
    fresh, _ = config2_pair(mt)
    ckpt.restore_checkpoint(fresh, root)
    same_dicts(torch, "17(c) restore after faults", coll_states(fresh), want)

    for logits, target, _, _ in stream[CKPT_BLOCKING_AT:CKPT_OVERLAP_AT]:
        coll.update(logits, target)
    ckpt.save_checkpoint(coll, root, step=1)
    from metrics_tpu_torch.checkpoint import io as ckpt_io

    step_dir = ckpt_io.step_dir(root, 1)
    npz = next(n for n in sorted(os.listdir(step_dir)) if n.endswith(".npz"))
    with open(os.path.join(step_dir, npz), "r+b") as fh:
        data = bytearray(fh.read())
        data[len(data) // 2] ^= 0xFF
        fh.seek(0)
        fh.write(bytes(data))
    fallback, _ = config2_pair(mt)
    with obs.trace() as tracer, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        info = ckpt.restore_checkpoint(fallback, root)
        events = tracer.counts_by_name()
    check(info.fallback_from == 1 and info.step == 0, f"17(c): fallback_from {info.fallback_from}, step {info.step}")
    check(events.get("checkpoint/restore/fallback") == 1, f"17(c): fallback events {events.get('checkpoint/restore/fallback')}")
    same_dicts(torch, "17(c) fallback restore", coll_states(fallback), want)
    print(f"phase 17(c) ({smi}): faults fired {fired}; the save committed through retries, the restore bitwise;"
          " a corrupt newest step fell back to step 0 with one checkpoint/restore/fallback event")
    return {"fired": fired, "fallback_from": info.fallback_from}


def tenant_batches(torch, n: int, gen):
    logits = torch.randn((n, TENANT_ROWS, CKPT_CLASSES), generator=gen, device="cuda")
    target = torch.randint(0, CKPT_CLASSES, (n, TENANT_ROWS), generator=gen, device="cuda")
    scores = torch.rand((n, TENANT_ROWS, DRY_CLASSES), generator=gen, device="cuda")
    labels = torch.randint(0, DRY_CLASSES, (n, TENANT_ROWS), generator=gen, device="cuda")
    return logits, target, scores, labels


def stacked_rows_equal(torch, label: str, ts, states: list) -> None:
    """Every tenant's stacked rows against its own reference state, bitwise."""
    for lname, st in ts.stacked_states.items():
        for k, leaf in st.items():
            ref = torch.stack([s[lname][k] if lname in s else s[k] for s in states])
            check(same_bits(torch, leaf[: len(states)], ref), f"{label}: stacked {lname}.{k} differs from the tenants' own")


def tenancy_timing(torch, mt, gen, smi) -> dict:
    """Per-tenant microseconds of one stacked update against N independent
    dispatches of one shared captured step of the same collection (a state
    copied in, the graph replayed, the state copied out, per tenant), at
    each N: the pair the JAX package's bench_tenancy measures, with its one
    shared jitted program. Both end at the same states, bitwise."""
    from metrics_tpu_torch.core import engine

    out = {}
    for n in TENANCY_SWEEP:
        logits, target, _, _ = tenant_batches(torch, n, gen)
        coll, _ = config2_pair(mt)
        ts = mt.TenantSet(coll, capacity=n, name=f"sweep-{n}")
        ids = [f"t{i}" for i in range(n)]
        for tid in ids:
            ts.admit(tid)
        for _ in range(2):  # the probe and capture, then a replay
            ts.update(ids, logits, target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TENANCY_TIMED_STEPS):
            ts.update(ids, logits, target)
        torch.cuda.synchronize()
        stacked_us = (time.perf_counter() - t0) / TENANCY_TIMED_STEPS * 1e6

        ref, _ = config2_pair(mt)
        step = engine.CapturedStep(lambda st, a, kw: ref.update_state(st, *a), writes_state=True,
                                   pool=torch.cuda.graph_pool_handle())
        states = [ref.init_state() for _ in range(n)]

        def dispatch(i):
            leaves = engine.tree_leaves(states[i])
            states[i] = step.run_update(states[i], leaves, (logits[i], target[i]), {}, [logits[i], target[i]],
                                        False, [True] * len(leaves))

        states[0] = step.probe(states[0], (logits[0], target[0]), {})
        dispatch(0)
        for i in range(1, n):  # every state through the shared step twice, as the stacked warm-up
            dispatch(i)
            dispatch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TENANCY_TIMED_STEPS):
            for i in range(n):
                dispatch(i)
        torch.cuda.synchronize()
        loop_us = (time.perf_counter() - t0) / TENANCY_TIMED_STEPS * 1e6
        stacked_rows_equal(torch, f"17(d) timing at N={n}", ts, states)
        out[n] = {"stacked_us_per_tenant": stacked_us / n, "loop_us_per_tenant": loop_us / n,
                  "stacked_us_per_step": stacked_us, "loop_us_per_step": loop_us}
        print(f"phase 17(d) ({smi}): config2 at N={n} tenants x {TENANT_ROWS} rows: stacked update"
              f" {stacked_us / n:.3f} us/tenant ({stacked_us:.1f} us a step), {n} dispatches of one shared"
              f" captured step {loop_us / n:.3f} us/tenant ({loop_us:.1f} us a step), {loop_us / stacked_us:.1f}x;"
              " the states bitwise equal")
    return out


def phase_seventeen_d(torch, mt, kernels_mod, sync, binned_mod, world, tmp, smi) -> dict:
    """17(d): 1,024-slot TenantSets of config2 and of the dry run's binned AP."""
    from metrics_tpu_torch import checkpoint as ckpt

    gen = torch.Generator(device="cuda").manual_seed(SEED + 172)
    template_c, template_b = config2_pair(mt)
    ts_c = mt.TenantSet(template_c, capacity=TENANTS, name="config2")
    ts_b = mt.TenantSet(template_b, capacity=TENANTS, name="dryrun-binned")
    plain_template = config2_pair(mt)[1]
    plain_template._plain_counts = True
    ts_p = mt.TenantSet(plain_template, capacity=TENANTS, name="dryrun-binned-plain")
    for ts in (ts_c, ts_b, ts_p):
        paths = {info["path"] for info in ts.partition_view()["tenant"].values()}
        check(paths == {"tenant_stacked"}, f"17(d): {ts.name} members {paths}")
    ids = [f"t{i}" for i in range(TENANTS)]
    for ts in (ts_c, ts_b, ts_p):
        for tid in ids:
            ts.admit(tid)
    ref_c, ref_b = config2_pair(mt)
    states_c = [ref_c.init_state() for _ in ids]
    states_b = [ref_b.init_state() for _ in ids]
    stacked_launches = []
    main_launches = 0
    for _ in range(TENANT_STEPS):
        logits, target, scores, labels = tenant_batches(torch, TENANTS, gen)
        torch.cuda.synchronize()
        before = kernels_mod.launch_counts()
        ts_c.update(ids, logits, target)
        ts_b.update(ids, scores, labels)
        launches = {k: v - before[k] for k, v in kernels_mod.launch_counts().items()}
        main_launches += launches["binned_counts_batched"]
        stacked_launches.append(dict(launches))
        check(launches["binned_counts_batched"] == 1 and launches["binned_counts"] == 0,
              f"17(d): a stacked update of {TENANTS} tenants launched {launches}")
        ts_p.update(ids, scores, labels)
        for i in range(TENANTS):
            states_c[i] = ref_c.update_state(states_c[i], logits[i], target[i])
            states_b[i] = ref_b.update_state(states_b[i], scores[i], labels[i])
    torch.cuda.synchronize()
    stacked_rows_equal(torch, "17(d) config2", ts_c, states_c)
    stacked_rows_equal(torch, "17(d) binned", ts_b, states_b)
    same_dicts(torch, "17(d) batched B1 against its plain version", ts_b.stacked_states[ts_b.template._groups[0][0]],
               ts_p.stacked_states[ts_p.template._groups[0][0]])
    out_c, out_b = ts_c.compute(), ts_b.compute()
    for i, tid in enumerate(ids):
        want = ref_c.compute_state(states_c[i])
        for name, value in want.items():
            check(same_bits(torch, out_c[tid][name], value), f"17(d): tenant {tid} {name} differs from its own stream")
        check(same_bits(torch, torch.stack(out_b[tid]["BinnedAveragePrecision"]), torch.stack(ref_b.compute_state(states_b[i]))),
              f"17(d): tenant {tid} binned AP differs from its own stream")
    step_graphs = {ts.name: [k[:2] for k, st in ts._steps.items() if st.graph is not None] for ts in (ts_c, ts_b)}
    check(all(len(v) == 2 for v in step_graphs.values()), f"17(d): captured steps {step_graphs}")

    # ragged occupancy: one captured step per bucket width, none new across admit, evict and reset
    def ragged_round(offset: int) -> None:
        for r, k in enumerate(RAGGED):
            start = (offset + 211 * r) % (TENANTS - k)
            sel = ids[start:start + k]
            logits, target, scores, labels = tenant_batches(torch, k, gen)
            before = {ln: {n: v.clone() for n, v in st.items()} for ln, st in ts_b.stacked_states.items()}
            ts_c.update(sel, logits, target)
            ts_b.update(sel, scores, labels)
            slots = {ts_b._slot_of[t] for t in sel}
            rest = torch.tensor([s for s in range(TENANTS) if s not in slots], device="cuda")
            for ln, st in ts_b.stacked_states.items():
                for n, v in st.items():
                    check(same_bits(torch, v[rest], before[ln][n][rest]), f"17(d): an inactive tenant's {ln}.{n} moved")
        ts_c.reset(ids[10:15])
        ts_b.reset(ids[10:15])
        for ts in (ts_c, ts_b):
            ts.evict(ids[3])
            ts.admit(ids[3])

    ragged_round(0)
    warm = {ts.name: (ts.stats.compiles, len(ts._steps)) for ts in (ts_c, ts_b)}
    for offset in (101, 500):
        ragged_round(offset)
    after = {ts.name: (ts.stats.compiles, len(ts._steps)) for ts in (ts_c, ts_b)}
    check(after == warm, f"17(d): ragged rounds captured anew: {warm} -> {after}")
    check(ts_c._dispatcher.stats.builds == 1 and ts_c._dispatcher.stats.repartitions == 0, "17(d): the partition was rebuilt")
    widths = sorted({k[1] for k in ts_c._steps if k[0] == "update"})
    check(widths == [8, 64, TENANTS], f"17(d): update widths {widths}")

    # a TenantSet save and restore, bitwise
    root = f"{tmp}/tenants"
    handle = ckpt.save_checkpoint(ts_c, root)
    fresh = mt.TenantSet(config2_pair(mt)[0], capacity=TENANTS, name="config2-restored")
    info = ckpt.restore_checkpoint(fresh, root)
    check(handle.committed and fresh.tenant_ids() == ts_c.tenant_ids()
          and fresh.tenant_update_counts() == ts_c.tenant_update_counts(), "17(d): the restored slot table differs")
    for ln, st in ts_c.stacked_states.items():
        for n, v in st.items():
            check(same_bits(torch, fresh.stacked_states[ln][n], v), f"17(d): restored {ln}.{n} differs")

    # stacked sync in a world of one NCCL rank: one collective a bucket, whatever N
    small = mt.TenantSet(config2_pair(mt)[0], capacity=16, name="config2-16")
    counts = {}
    for ts in (ts_c, small):
        with sync.count_collectives() as box:
            synced = ts.sync_states(ts.stacked_states, world)
        torch.cuda.synchronize()
        counts[ts.capacity] = dict(box["by_kind"])
        for ln, st in ts.stacked_states.items():
            for n, v in st.items():
                check(same_bits(torch, synced[ln][n], v), f"17(d): synced {ln}.{n} of a world of one differs")
    check(counts[TENANTS] == counts[16] and sum(counts[16].values()) >= 1, f"17(d): stacked sync collectives {counts}")
    timing = tenancy_timing(torch, mt, gen, smi)
    print(f"phase 17(d) ({smi}): {TENANTS} tenants x {TENANT_ROWS} rows, {TENANT_STEPS} stacked updates: every tenant"
          f" bitwise its own stream; B1 batched launches {main_launches} (one a stacked update), bitwise its plain"
          f" version; ragged {RAGGED} reuse widths {widths}; save/restore bitwise ({info.timings['total_s']:.3f} s);"
          f" stacked sync collectives {counts[TENANTS]} at N={TENANTS} and N=16")
    return {"main_launches": main_launches, "widths": widths, "sync_collectives": counts[TENANTS], "timing": timing,
            "save_s": handle.timings["total_s"], "restore_s": info.timings["total_s"]}


def graph_device_us(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the replay timed by CUDA events, so no host work sits between
    the launches (median of ``rounds`` replays, in microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # anything made on first use is made outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    del graph
    return statistics.median(times)


def batched_kernel_timing(torch, binned_mod, name: str, smi) -> dict:
    """The batched B1 launch at the tenancy shape: kernel, plain version, bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 173)
    b, n, c, t = TENANTS, TENANT_ROWS, DRY_CLASSES, DRY_THRESHOLDS
    scores = torch.rand((b, n, c), generator=gen, device="cuda")
    labels = torch.randint(0, c, (b, n), generator=gen, device="cuda")
    grid = binned_mod.sort_thresholds(torch.linspace(0, 1, t, device="cuda"))
    call = lambda: binned_mod.binned_counts_batched(scores, labels, grid)  # noqa: E731
    ms = time_ms(torch, call)
    plain_ms = time_ms(torch, lambda: binned_mod.binned_counts_batched(scores, labels, grid, plain=True))
    prof = profile_window(torch, call, reps=20)
    device_us = sum(us for k, us in prof["per_launch_us"].items() if "binned_" in k) or None
    if device_us is None:  # say what the window did record
        print(f"  profile [binned_counts_batched]: no binned_* record; {len(prof['device_us'])} device kernels recorded"
              f" {sorted(prof['recorded'].items())[:6]}")
    graph_us = graph_device_us(torch, call)
    # scores and labels read once, thresholds and order once, the counts written once
    bytes_moved = b * n * c * 4 + b * n * labels.element_size() + t * 8 + b * 3 * c * t * 4
    ops = b * n * c * math.ceil(math.log2(t + 1))  # one compare per binary-search step
    bound_ms, bound_by = bound(bytes_moved, ops, name)
    print(f"phase 17 ({smi}): binned_counts_batched at ({b}, {n}, {c}, {t}): {ms * 1e3:.2f} us/call (device"
          f" {device_us} us by the profiler, {graph_us:.2f} us a launch in a captured graph of 20), plain"
          f" {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {bytes_moved} bytes)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_us": device_us, "graph_device_us": graph_us, "shape": [b, n, c, t], "bytes": bytes_moved}


def b1_route_timing(torch, binned_mod, smi, rounds: int = 4) -> dict:
    """The unbatched B1 wrapper at phase 3's shape (labels), by its two
    routes on the card: the direct launch it takes outside ``vmap``, and the
    ``metrics_tpu::binned_counts`` operator it takes inside. Microseconds a
    call, the median of 30 calls by CUDA events, in the order direct, op,
    op, direct, ``rounds`` times."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 174)
    preds = torch.rand((BATCH, N_CLASSES), generator=gen, device="cuda")
    labels = torch.randint(0, N_CLASSES, (BATCH,), generator=gen, device="cuda")
    grid = binned_mod.sort_thresholds(torch.linspace(0, 1, N_THRESHOLDS, device="cuda"))
    want = binned_mod.binned_counts(preds, labels, grid)
    via_op = torch.ops.metrics_tpu.binned_counts(preds, labels, grid.values, grid.order)
    check(all(torch.equal(g, w) for g, w in zip(via_op.unbind(0), want)), "B1 routes: the operator's counts differ")
    routes = {
        "direct": lambda: binned_mod.binned_counts(preds, labels, grid),
        "op": lambda: torch.ops.metrics_tpu.binned_counts(preds, labels, grid.values, grid.order),
    }
    us = {k: [] for k in routes}
    for _ in range(rounds):
        for key in ("direct", "op", "op", "direct"):
            us[key].append(time_ms(torch, routes[key]) * 1e3)
    med = {k: statistics.median(v) for k, v in us.items()}
    print(f"phase 17 ({smi}): B1 wrapper at ({BATCH}, {N_CLASSES}, {N_THRESHOLDS}) labels, us a call by route"
          f" (direct, op, op, direct x {rounds}): direct {[round(x, 2) for x in us['direct']]}, op"
          f" {[round(x, 2) for x in us['op']]}; medians {med['direct']:.2f} / {med['op']:.2f} us")
    return {"us": us, "median_us": med, "shape": [BATCH, N_CLASSES, N_THRESHOLDS]}


def phase_seventeen(torch, mt, np, kernels_mod, sync, binned_mod, smi) -> dict:
    import tempfile

    import torch.distributed as dist

    import metrics_tpu_torch.parallel as par
    from metrics_tpu_torch import checkpoint as ckpt

    t0 = time.perf_counter()
    stream = ckpt_stream(torch)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    kernels_mod.reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_phase17_") as tmp:
            a = phase_seventeen_a(torch, mt, ckpt, kernels_mod, stream, tmp, smi)
            mesh = par.make_mesh([1], ["data"])
            b = phase_seventeen_b(torch, mt, ckpt, mesh, tmp, smi)
            c = phase_seventeen_c(torch, mt, ckpt, stream, tmp, smi)
            d = phase_seventeen_d(torch, mt, kernels_mod, sync, binned_mod, dist.group.WORLD, tmp, smi)
    finally:
        dist.destroy_process_group()
    # every launch of 17(a)-(d), the per-tenant reference streams of 17(d) included
    launches = kernels_mod.launch_counts()
    kernel = batched_kernel_timing(torch, binned_mod, torch.cuda.get_device_name(0), smi)
    routes = b1_route_timing(torch, binned_mod, smi)
    elapsed = time.perf_counter() - t0
    print(f"phase 17 ({smi}): {elapsed:.1f} s in all (limit {PHASE17_LIMIT_S:.0f} s); kernel launches {launches};"
          f" the batched B1 launch ran {d['main_launches']} times on the stacked updates, B1 {a['launches_after_restore']}"
          " times on the restored run")
    check(d["main_launches"] == TENANT_STEPS, f"phase 17: batched launches {d['main_launches']}")
    check(launches["binned_counts_batched"] >= d["main_launches"] and launches["binned_counts"] > 0,
          f"phase 17: kernel launches {launches}")
    check(elapsed < PHASE17_LIMIT_S, f"phase 17 took {elapsed:.1f} s, over its {PHASE17_LIMIT_S:.0f} s")
    return {"a": a, "b": b, "c": c, "d": d, "kernel": kernel, "routes": routes, "seconds": elapsed,
            "launches": launches}


# --------------------------------------------------------------------------- #
# phase 18: serve and cluster (B1's tenant-batched launch under HTTP ingest)
# --------------------------------------------------------------------------- #
PHASE18_LIMIT_S = 60.0
# config2's collection (10 classes) plus BinnedAveragePrecision(10 classes,
# 21 thresholds), fed entry()'s 64-row batches of probabilities and labels
SERVE_CLASSES, SERVE_THRESHOLDS, SERVE_ROWS = 10, 21, 64
SERVE_TENANTS, SERVE_STEPS, SERVE_CLIENTS = 1024, 4, 8
SMALL_QUEUE = 4
ORACLE_PROCS = 6  # worker processes of the offline replay (the card machine has 8 cores)
CLUSTER_TENANTS, CLUSTER_STEPS, CLUSTER_MOVES, CLUSTER_CLIENTS = 256, 4, 8, 4


def serve_template(mt, device=None, compiled: bool = True):
    """The served template: config2's collection and the binned AP. The
    offline oracle builds it with the engines off (plain eager metrics)."""
    flags = {} if compiled else dict(compiled_update=False, compiled_compute=False)
    c, kw = SERVE_CLASSES, dict(device=device, **flags)
    return mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=c, average="micro", **kw),
        "f1": mt.F1Score(num_classes=c, average="macro", **kw),
        "precision": mt.Precision(num_classes=c, average="macro", **kw),
        "recall": mt.Recall(num_classes=c, average="macro", **kw),
        "binned_ap": mt.BinnedAveragePrecision(num_classes=c, thresholds=SERVE_THRESHOLDS, **kw),
    }, **flags)


def oracle_init(device: str) -> None:
    """A replay worker: the port imported and the device's context made while
    the phase's ingest runs."""
    import torch

    import metrics_tpu_torch as mt

    serve_template(mt, device, compiled=False)
    if device == "cuda":
        torch.cuda.synchronize()


def oracle_replay(job):
    """``offline_replay`` of one share of the tenants' logs, in a worker."""
    device, log = job
    import metrics_tpu_torch as mt
    from metrics_tpu_torch import serve as msv

    return msv.offline_replay(lambda: serve_template(mt, device, compiled=False), log)


def parallel_replay(pool, device: str, log: list):
    """The offline replay of an admitted log through plain metrics, its
    tenants dealt to the pool's worker processes (one tenant's observations
    stay together and in order): what ``offline_replay`` of the whole log
    gives, made by ORACLE_PROCS processes instead of one interpreter. Returns
    a function that waits for it and merges the shares."""
    tenants = sorted({tid for tid, _, _ in log}, key=str)
    share = {tid: i % ORACLE_PROCS for i, tid in enumerate(tenants)}
    jobs = [(device, [e for e in log if share[e[0]] == k]) for k in range(ORACLE_PROCS)]
    pending = pool.map_async(oracle_replay, [j for j in jobs if j[1]])

    def result() -> dict:
        out = {}
        for part in pending.get():
            out.update(part)
        return out

    return result


def serve_rows(np, rng, n: int):
    """n steps of (64, 10) float32 probabilities and (64,) int32 labels,
    made on the host: they cross HTTP."""
    raw = rng.random((n, SERVE_ROWS, SERVE_CLASSES), dtype=np.float32) + np.float32(1e-3)
    probs = (raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    return probs, rng.integers(0, SERVE_CLASSES, (n, SERVE_ROWS), dtype=np.int32)


def pct(values, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))] if s else float("nan")


def host_bits_equal(np, got, want) -> bool:
    """A read's JSON values against the oracle's array: dtype, shape, bits."""
    got = np.asarray(got, dtype=want.dtype)
    return got.shape == want.shape and np.array_equal(
        got.reshape(-1).view(np.uint8), np.ascontiguousarray(want).reshape(-1).view(np.uint8))


def take_reads(label: str, read, tenants) -> tuple:
    """Every tenant's staleness-0 read, and each read's latency in ms."""
    docs, lat = {}, []
    for tid in tenants:
        t0 = time.perf_counter()
        doc = docs[tid] = read(tid)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(doc.get("status") == 200 and doc.get("staleness_steps") == 0, f"{label}: read of {tid}: {doc}")
    return docs, lat


def compare_reads(np, label: str, docs: dict, oracle: dict) -> None:
    """Every read bitwise its tenant's offline replay."""
    check(docs.keys() == oracle.keys(), f"{label}: {len(docs)} reads for {len(oracle)} replayed tenants")
    for tid, want in oracle.items():
        check(docs[tid]["values"].keys() == want.keys(), f"{label}: {tid} reads {sorted(docs[tid]['values'])}")
        for name, value in want.items():
            check(host_bits_equal(np, docs[tid]["values"][name], value), f"{label}: {tid} {name} differs from its replay")


def recording_widths(ts) -> list:
    """Record the width of every stacked update the set dispatches."""
    widths, apply = [], ts.apply_batch

    def record(ids, *args, **kwargs):
        widths.append(len(ids))
        return apply(ids, *args, **kwargs)

    ts.apply_batch = record
    return widths


def check_set(label: str, ts, widths: list, kernels_mod) -> dict:
    """The set's captured steps are those of the widths it met, each built
    once, every one a graph; nothing fell back; every dispatch recorded."""
    update_widths = sorted({kernels_mod.next_pow2(k) for k in widths})
    built = sorted(k[1] for k in ts._steps if k[0] == "update")
    check(built == update_widths, f"{label}: update steps at widths {built}, dispatched {update_widths}")
    check(ts.stats.compiles == len(ts._steps), f"{label}: {ts.stats.compiles} compiles for {len(ts._steps)} steps")
    check(all(step.graph is not None for step in ts._steps.values()), f"{label}: a step holds no graph")
    paths = {info["path"] for info in ts.partition_view()["tenant"].values()}
    check(paths == {"tenant_stacked"}, f"{label}: members {paths}")
    reasons = ts.template.engine_stats()["fallback_reasons"]
    check(not reasons, f"{label}: fallback reasons {reasons}")
    check(ts.stats.dispatches == len(widths), f"{label}: {ts.stats.dispatches} dispatches, {len(widths)} recorded")
    return {"update_widths": update_widths, "compiles": ts.stats.compiles, "dispatches": ts.stats.dispatches,
            "mean_width": sum(widths) / max(1, len(widths))}


class KeepAlive:
    """One persistent HTTP/1.1 connection (a client thread's): the server's
    handler thread then serves the whole stream instead of one thread a
    request."""

    def __init__(self, url: str) -> None:
        import http.client
        import socket
        import urllib.parse

        parts = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=120)
        self.conn.connect()
        # a body past one segment goes out after the headers: no Nagle wait
        self.conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def request(self, path: str, body=None, ctype: str = "application/x-npz"):
        headers = {"Content-Type": ctype} if body is not None else {}
        self.conn.request("POST" if body is not None else "GET", path, body=body, headers=headers)
        resp = self.conn.getresponse()
        doc = json.loads(resp.read().decode())
        doc["status"] = resp.status
        if resp.getheader("Retry-After") is not None:
            doc["retry_after_s"] = float(resp.getheader("Retry-After"))
        return doc

    def close(self) -> None:
        self.conn.close()


def post_requests(msv, url, requests, probs, labels, ready):
    """One client thread's requests over one connection, each body encoded
    before the clock starts, a rejected remainder re-posted until every step
    is admitted; returns the admitted (seq, tenant, step), each POST's
    latency in ms and the rejections."""
    bodies = [msv.encode_npz(probs[s[0]], labels[s[0]]) if len(s) == 1 else msv.encode_npz_steps(probs[s], labels[s])
              for _, s in requests]
    ready.wait()
    conn = KeepAlive(url)
    admitted, lat, rejected = [], [], 0
    for (tid, steps), body in zip(requests, bodies):
        k = 0
        while k < len(steps):
            t0 = time.perf_counter()
            doc = conn.request(f"/ingest/{tid}", body)
            lat.append((time.perf_counter() - t0) * 1e3)
            seqs = doc.get("seqs", [doc["seq"]] if doc.get("admitted") else [])
            admitted.extend((seq, tid, s) for seq, s in zip(seqs, steps[k:]))
            k += len(seqs)
            if k < len(steps):
                check(doc["status"] in (429, 503), f"18(a): post of {tid}: {doc}")
                rejected += 1
                rest = steps[k:]
                body = msv.encode_npz_steps(probs[rest], labels[rest]) if len(steps) > 1 else body
                time.sleep(min(doc.get("retry_after_s", 0.05), 0.02))
    conn.close()
    return admitted, lat, rejected


def phase_eighteen_a(torch, mt, np, kernels_mod, pool, smi, device="cuda"):
    """18(a): 1,024 tenants over HTTP into one 1,024-slot TenantSet. Returns
    the function that holds the reads against the replay, made meanwhile in
    the workers, and reports (phase 18 calls it after 18(b))."""
    import threading

    from metrics_tpu_torch import serve as msv

    rng = np.random.default_rng(SEED + 180)
    # every fourth tenant posts twice as often; even tenants one step a body,
    # odd ones a body of SERVE_STEPS steps
    counts = [2 * SERVE_STEPS if i % 4 == 0 else SERVE_STEPS for i in range(SERVE_TENANTS)]
    probs, labels = serve_rows(np, rng, sum(counts))
    requests, offset = [], 0
    for i, n in enumerate(counts):
        steps = list(range(offset, offset + n))
        offset += n
        size = 1 if i % 2 == 0 else SERVE_STEPS
        requests += [(f"t{i}", steps[j:j + size]) for j in range(0, n, size)]
    order = rng.permutation(len(requests))
    per_thread = [[requests[j] for j in order[t::SERVE_CLIENTS]] for t in range(SERVE_CLIENTS)]
    total = sum(counts)

    ts = mt.TenantSet(serve_template(mt, device), name="serve-18a")
    check(ts.capacity == SERVE_TENANTS, f"18(a): default capacity {ts.capacity}")
    widths = recording_widths(ts)
    # a queue that holds the whole stream: backpressure is 429'd by the small
    # server below, not paid for in retries here
    server = msv.IngestServer(ts, name="phase18", queue_capacity=2 * total).start()
    check(server.host == "127.0.0.1", f"18(a): bound to {server.host}")
    kernels_mod.reset_launch_counts()
    results = [None] * SERVE_CLIENTS
    timings = {}
    try:
        ready = threading.Event()

        def run(t):
            results[t] = post_requests(msv, server.url, per_thread[t], probs, labels, ready)

        threads = [threading.Thread(target=run, args=(t,)) for t in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        time.sleep(0.5)  # the bodies are encoded
        t0 = time.perf_counter()
        ready.set()
        for th in threads:
            th.join()
        timings["posted_s"] = time.perf_counter() - t0
        check(all(r is not None for r in results), "18(a): a client thread failed")
        check(server.drain(120.0), "18(a): the drain timed out")
        timings["ingest_s"] = ingest_s = time.perf_counter() - t0
        stats = server.stats()
        check(stats["ledger"]["admitted"] == stats["ledger"]["applied"] == total,
              f"18(a): ledger {stats['ledger']['admitted']} admitted, {stats['ledger']['applied']} applied of {total}")
        check(stats["ledger"]["dead_lettered"] == 0 and stats["dispatcher"]["dead_letters"] == 0,
              f"18(a): dead letters {stats['dispatcher']}")
        log = sorted(entry for r in results for entry in r[0])
        check(len(log) == total and len({seq for seq, _, _ in log}) == total, f"18(a): {len(log)} admitted of {total}")
        launches = kernels_mod.launch_counts()

        # the replay runs in the workers while the reads, 18(a)'s other checks
        # and 18(b) run here; the reads are held against it at the end
        replay = parallel_replay(pool, device, [(tid, (probs[s], labels[s]), {}) for _, tid, s in log])
        t1 = time.perf_counter()
        reader = KeepAlive(server.url)
        reads, read_lat = take_reads("18(a)", lambda tid: reader.request(f"/read/{tid}?max_staleness_steps=0"),
                                     [f"t{i}" for i in range(SERVE_TENANTS)])
        reader.close()
        timings["reads_s"] = time.perf_counter() - t1
        set_info = check_set("18(a)", ts, widths, kernels_mod)
        check(launches["binned_counts_batched"] == ts.stats.dispatches and launches["binned_counts"] == 0,
              f"18(a): kernel launches {launches} for {ts.stats.dispatches} stacked updates")
        check(ts.stats.compiles == len(set_info["update_widths"]) + 1,
              f"18(a): {ts.stats.compiles} compiles for widths {set_info['update_widths']} and the reads' width 1")
    finally:
        server.stop(drain=False, timeout=10.0)

    # backpressure: a 4-slot queue whose dispatcher is held answers 429
    t1 = time.perf_counter()
    small = msv.IngestServer(mt.TenantSet(serve_template(mt, device), capacity=128, name="serve-18a-small"),
                             queue_capacity=SMALL_QUEUE, name="phase18-small").start()
    try:
        client = msv.IngestClient(small.url, timeout=60.0)
        full = None
        with small.pipeline.apply_lock:
            for i in range(100):
                doc = client.post(f"q{i}", probs[i], labels[i])
                if not doc["admitted"]:
                    full = doc
                    break
        check(full is not None and full["status"] == 429 and full["reason"] == "queue_full"
              and full.get("retry_after_s", 0) >= 1, f"18(a): a full {SMALL_QUEUE}-slot queue answered {full}")
        check(small.drain(60.0), "18(a): the small server's drain timed out")
    finally:
        small.stop(drain=False, timeout=10.0)
    timings["small_s"] = time.perf_counter() - t1

    post_lat = [x for r in results for x in r[1]]
    out = {"observations": total, "requests": len(requests), "ingest_s": ingest_s,
           "obs_per_s": total / ingest_s, "post_p50_ms": pct(post_lat, 0.5), "post_p99_ms": pct(post_lat, 0.99),
           "read_p50_ms": pct(read_lat, 0.5), "read_p99_ms": pct(read_lat, 0.99),
           "rejected": sum(r[2] for r in results), "launches": launches, "timings": timings, **set_info}

    def finish() -> dict:
        t1 = time.perf_counter()
        compare_reads(np, "18(a)", reads, replay())
        timings["replay_wait_s"] = time.perf_counter() - t1
        report_eighteen_a(out, full, smi)
        return out

    return finish


def report_eighteen_a(out: dict, full: dict, smi: str) -> None:
    print(f"phase 18(a) ({smi}): {out['observations']} observations of {SERVE_TENANTS} tenants in {out['requests']}"
          f" POSTs from {SERVE_CLIENTS} threads: {out['obs_per_s']:.0f} observations/s through HTTP"
          f" ({out['ingest_s']:.2f} s to drained); POST p50 {out['post_p50_ms']:.2f} ms, p99 {out['post_p99_ms']:.2f} ms;"
          f" read p50 {out['read_p50_ms']:.2f} ms, p99 {out['read_p99_ms']:.2f} ms; {out['dispatches']} dispatches of"
          f" mean width {out['mean_width']:.1f} (buckets {out['update_widths']}, {out['compiles']} captured steps);"
          f" {out['rejected']} retried on backpressure; the batched B1 launched"
          f" {out['launches']['binned_counts_batched']} times; every read bitwise its replay; a {SMALL_QUEUE}-slot"
          f" queue answered 429 queue_full with Retry-After {full['retry_after_s']:g}; seconds"
          f" {json.dumps({k: round(v, 3) for k, v in out['timings'].items()})}")


def phase_eighteen_b(torch, mt, np, kernels_mod, pool, tmp, smi, device="cuda") -> dict:
    """18(b): two replicas on one card behind a coordinator and the client."""
    import threading

    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch import serve as msv
    from metrics_tpu_torch.cluster import ClusterClient, ClusterCoordinator, encode_tenant_snapshot

    rng = np.random.default_rng(SEED + 181)
    probs, labels = serve_rows(np, rng, CLUSTER_TENANTS * (CLUSTER_STEPS + 2))
    fresh = iter(range(len(probs)))
    tenants = [f"c{i}" for i in range(CLUSTER_TENANTS)]
    steps = {tid: [] for tid in tenants}  # the client's own log, in posting order
    lock = threading.Lock()

    def stack(rid):
        ts = mt.TenantSet(serve_template(mt, device), name=f"cluster-18b-{rid}")
        sets.append((ts, recording_widths(ts)))
        return msv.IngestServer(ts, name=f"phase18-{rid}")

    def post(client, tid):
        with lock:
            s = next(fresh)
        doc = client.post_with_retry(tid, probs[s], labels[s], max_attempts=200, max_backoff_s=0.02)
        check(doc.get("admitted"), f"18(b): post of {tid}: {doc}")
        with lock:
            steps[tid].append(s)

    sets = []
    timings = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        timings[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kernels_mod.reset_launch_counts()
    with obs.trace(capacity=1 << 18) as tracer:
        servers = {rid: stack(rid) for rid in ("r0", "r1")}
        coordinator = ClusterCoordinator(servers, checkpoint_root=f"{tmp}/cluster", name="phase18").start()
        try:
            urls = {rid: srv.url for rid, srv in servers.items()}
            owner0 = {rid: next(t for t in tenants if coordinator.owner(t) == rid) for rid in urls}
            # both dispatchers probe and capture at once
            barrier = threading.Barrier(2)

            def warm(rid):
                client = ClusterClient(dict(urls), coordinator)
                barrier.wait()
                post(client, owner0[rid])

            threads = [threading.Thread(target=warm, args=(rid,)) for rid in urls]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            lap("warm_s")
            moving = [t for t in tenants if coordinator.owner(t) == "r0"][:CLUSTER_MOVES]
            others = [t for t in tenants if t not in moving]

            def post_round(rounds, group, pause=0.0):
                client = ClusterClient(dict(urls), coordinator)
                for _ in range(rounds):
                    for tid in group:
                        post(client, tid)
                        time.sleep(pause)
                return client

            clients = []
            for tid in moving:  # the moving tenants' first step lands on r0
                post(ClusterClient(dict(urls), coordinator), tid)
            workers = [threading.Thread(target=lambda g=g: clients.append(post_round(CLUSTER_STEPS, g)))
                       for g in (others[k::CLUSTER_CLIENTS - 1] for k in range(CLUSTER_CLIENTS - 1))]
            for th in workers:
                th.start()
            # the moves start once half the other posts are in (the buckets
            # warm), while the moved tenants' own posts go on
            while sum(map(len, steps.values())) < len(others) * CLUSTER_STEPS // 2 and any(
                    th.is_alive() for th in workers):
                time.sleep(0.005)
            workers.append(threading.Thread(
                target=lambda: clients.append(post_round(CLUSTER_STEPS - 1, moving, pause=0.002))))
            workers[-1].start()
            records = [coordinator.migrate(tid, "r1") for tid in moving]
            for th in workers:
                th.join()
            check(all(r.outcome == "committed" for r in records), f"18(b): migrations {[r.to_dict() for r in records]}")
            check(all(coordinator.owner(t) == "r1" for t in moving), "18(b): a moved tenant is not routed to r1")
            check(all(len(steps[t]) == CLUSTER_STEPS + (t == owner0["r0"] or t == owner0["r1"]) for t in tenants),
                  "18(b): a tenant's posts are missing")
            for replica in coordinator.replicas.values():
                check(replica.pipeline.drain(60.0), f"18(b): {replica.replica_id} did not drain")
            lap("posts_and_moves_s")

            # checkpoint, one more step applied on r1 after it, then r1 dies
            coordinator.checkpoint_all(step=1)
            lap("checkpoint_s")
            on_r1 = [t for t in tenants if coordinator.owner(t) == "r1"]
            client = ClusterClient(dict(urls), coordinator)
            for tid in on_r1:
                post(client, tid)
            check(coordinator.replicas["r1"].pipeline.drain(60.0), "18(b): r1 did not drain")
            lap("post_after_checkpoint_s")
            coordinator.mark_lost("r1")
            check(coordinator.status()["degraded"], "18(b): losing r1 left the cluster healthy")
            lap("loss_s")
            unacked, refused_ms = 0, []
            # never acknowledged: the replica is gone (a client that knows it
            # waits a second at most for a connection)
            refusing = ClusterClient(dict(urls), coordinator, timeout=1.0)
            for tid in on_r1:
                s = next(fresh)
                t1 = time.perf_counter()
                try:
                    doc = refusing.post(tid, probs[s], labels[s])
                except OSError:
                    doc = {}
                refused_ms.append((time.perf_counter() - t1) * 1e3)
                check(not doc.get("admitted"), f"18(b): a post to the lost r1 was admitted: {doc}")
                with lock:
                    steps[tid].append(s)
                unacked += 1
            lap("refused_posts_s")
            t_rec = time.perf_counter()
            coordinator.recover_replica("r1", stack("r1-recovered"))
            recovery_s = time.perf_counter() - t_rec
            check(not coordinator.status()["degraded"], "18(b): the recovered cluster is degraded")
            urls["r1"] = coordinator.replicas["r1"].url
            client.add_target("r1", urls["r1"])
            # the client replays every step past the restored watermark
            replayed = 0
            for tid in on_r1:
                applied = client.read(tid)["last_applied_step"]
                check(applied == len(steps[tid]) - 2, f"18(b): {tid} restored at step {applied} of {len(steps[tid])}")
                for s in steps[tid][applied:]:
                    doc = client.post_with_retry(tid, probs[s], labels[s], max_attempts=200, max_backoff_s=0.02)
                    check(doc.get("admitted"), f"18(b): replay of {tid}: {doc}")
                    replayed += 1
            for replica in coordinator.replicas.values():
                check(replica.pipeline.drain(60.0), f"18(b): {replica.replica_id} did not drain after recovery")
            lap("recovery_and_replay_s")

            launches = kernels_mod.launch_counts()
            dispatches = sum(ts.stats.dispatches for ts, _ in sets)
            check(launches["binned_counts_batched"] == dispatches and launches["binned_counts"] == 0,
                  f"18(b): kernel launches {launches} for {dispatches} stacked updates of three sets")
            for ts, widths in sets:
                check_set(f"18(b) {ts.name}", ts, widths, kernels_mod)
            log = [(tid, (probs[s], labels[s]), {}) for tid in tenants for s in steps[tid]]
            replay = parallel_replay(pool, device, log)
            reads, read_lat = take_reads("18(b)", lambda tid: client.read(tid, max_staleness_steps=0, timeout_s=60.0),
                                         tenants)
            lap("reads_s")
            compare_reads(np, "18(b)", reads, replay())
            lap("replay_wait_s")
            # a moved tenant's snapshot on the card, byte for byte a CPU twin's
            for tid in moving:
                twin = mt.TenantSet(serve_template(mt, "cpu"), capacity=8, name="cluster-18b-twin")
                for s in steps[tid]:
                    twin.apply_batch([tid], probs[s][None], labels[s][None], auto_admit=True)
                blob = encode_tenant_snapshot(coordinator.replicas["r1"].export_tenant(tid))
                check(blob == encode_tenant_snapshot(twin.export_tenant(tid)),
                      f"18(b): the card's snapshot of {tid} differs from the CPU twin's")
            redirects = sum(c.redirects_followed for c in clients)
            lap("twins_s")
        finally:
            coordinator.stop(drain=False, timeout=10.0)
        events = {e.name for e in tracer.events()}
    wanted = {f"cluster/{p}" for p in ("fence", "drain", "export", "transfer", "import", "cutover",
                                       "replica_lost", "replica_restored")}
    check(wanted <= events, f"18(b): events missing: {sorted(wanted - events)}")
    prom = obs.to_prometheus_text()
    series = ("metrics_tpu_cluster_epoch", "metrics_tpu_cluster_migrations_total", "metrics_tpu_cluster_fence_seconds",
              "metrics_tpu_cluster_replica_losses_total", "metrics_tpu_ingest_dispatch_dispatches_total")
    check(all(s in prom for s in series), f"18(b): series missing: {[s for s in series if s not in prom]}")
    fence_ms = [r.downtime_s * 1e3 for r in records]
    timings["refused_post_max_ms"] = max(refused_ms)
    out = {"fence_ms": fence_ms, "recovery_s": recovery_s, "replayed": replayed, "unacked": unacked, "timings": timings,
           "dispatches": dispatches, "launches": launches, "redirects": redirects,
           "read_p50_ms": pct(read_lat, 0.5), "read_p99_ms": pct(read_lat, 0.99)}
    print(f"phase 18(b) ({smi}): {CLUSTER_TENANTS} tenants over 2 replicas through the client; {CLUSTER_MOVES}"
          f" migrations r0 -> r1 under posts, fence {statistics.median(fence_ms):.2f} ms median,"
          f" {max(fence_ms):.2f} ms max ({redirects} redirects followed); r1 lost and recovered from its checkpoint in"
          f" {recovery_s:.3f} s, {replayed} steps replayed past the watermark ({unacked} never acknowledged);"
          f" {dispatches} stacked updates over three sets, the batched B1 launched"
          f" {launches['binned_counts_batched']} times; every read bitwise its replay, the moved tenants' snapshots"
          f" byte for byte a CPU twin's; fences ms {[round(x, 2) for x in fence_ms]}; seconds"
          f" {json.dumps({k: round(v, 3) for k, v in timings.items()})}")
    return out


def phase_eighteen(torch, mt, np, kernels_mod, smi, device="cuda") -> dict:
    import multiprocessing
    import tempfile

    t0 = time.perf_counter()
    # the replay workers start with the phase and are ready by its first replay
    with multiprocessing.get_context("spawn").Pool(ORACLE_PROCS, oracle_init, (device,)) as pool:
        finish_a = phase_eighteen_a(torch, mt, np, kernels_mod, pool, smi, device)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_phase18_") as tmp:
            b = phase_eighteen_b(torch, mt, np, kernels_mod, pool, tmp, smi, device)
        a = finish_a()
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    elapsed = time.perf_counter() - t0
    print(f"phase 18 ({smi}): {elapsed:.1f} s in all (limit {PHASE18_LIMIT_S:.0f} s); kernel launches {launches}")
    check(elapsed < PHASE18_LIMIT_S, f"phase 18 took {elapsed:.1f} s, over its {PHASE18_LIMIT_S:.0f} s")
    return {"a": a, "b": b, "seconds": elapsed, "launches": launches}


# --------------------------------------------------------------------------- #
# phase 19: self-tuning sync and the heavy-kernel registry's telemetry (A20b)
# --------------------------------------------------------------------------- #
PHASE19_LIMIT_S = 60.0
TUNE_ROUNDS, TUNE_UPDATES = 16, 4  # rounds of 4 updates and one synced compute
TUNE_SYNCS = 12  # tests/autotune/test_sync_integration.py's state, synced 12 times
COCO_CHUNK = (256, 4, 10, 128, 32)  # images, area ranges, IoU thresholds, detections, ground truths
COCO_SMALL_CHUNK = 64  # images of the third chunk (the same D and G)
BERT_CHUNK = (64, 1, 512, 512, 1024)  # pairs, layers, P, R, D
FEATURE_ROWS, FEATURE_BUCKET = 48, 64


def tune_stream(torch, np, device: str) -> list:
    """2 x TUNE_ROUNDS x TUNE_UPDATES seeded batches of (64, 10) float32
    probabilities and (64,) int32 labels (made on the host, so the card and
    its CPU twin see the same bits)."""
    probs, labels = serve_rows(np, np.random.default_rng(SEED + 190), 2 * TUNE_ROUNDS * TUNE_UPDATES)
    return [(torch.from_numpy(p).to(device), torch.from_numpy(l).to(device)) for p, l in zip(probs, labels)]


def tune_rounds(torch, sync, coll, stream, group, first: int, rounds: int, synced=None) -> list:
    """``rounds`` rounds from round ``first``: TUNE_UPDATES updates, then one
    synced compute each. Returns the computes; appends to ``synced``, if
    given, each round's states synced after its compute under the tuner's
    transports of the moment (quiet: they observe and decide nothing)."""
    out = []
    for r in range(first, first + rounds):
        for probs, labels in stream[r * TUNE_UPDATES:(r + 1) * TUNE_UPDATES]:
            coll.update(probs, labels)
        with sync.sync_axes(group):
            for m in coll.values():
                m._computed = None
            out.append(coll.compute())
        if synced is not None:
            with sync._quiet():
                synced.append({names[0]: coll[names[0]].sync_states(coll[names[0]].get_state(), group)
                               for names in coll.compute_groups.values()})
    return out


def tune_snapshot(coll) -> dict:
    """What must not move once the tuner has committed: the partition's
    builds, the engines in use and their captures."""
    stats = coll.engine_stats()
    return {"builds": coll._dispatcher.stats.builds,
            "engines": (id(coll._update_engine), id(coll._compute_engine)),
            "captures": tuple(None if stats[k] is None else stats[k].cache_misses for k in ("update", "compute"))}


def same_computes(torch, label: str, got: list, want: list, atol: dict = None) -> dict:
    """Each round's computes bitwise, or, for the keys of ``atol``, within
    its absolute tolerance; returns the largest difference of those keys."""
    atol = atol or {}
    worst = {key: 0.0 for key in atol}
    check(len(got) == len(want), f"{label}: {len(got)} computes for {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.keys() == w.keys(), f"{label}: round {i} keys {sorted(g)}")
        for key in w:
            if key in atol:
                gl, wl = torch.utils._pytree.tree_leaves(g[key]), torch.utils._pytree.tree_leaves(w[key])
                diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(gl, wl))
                check(len(gl) == len(wl) and diff <= atol[key], f"{label}: round {i} {key} differs by {diff:.3e}")
                worst[key] = max(worst[key], diff)
            else:
                check(same_tree(torch, g[key], w[key]), f"{label}: round {i} {key} differs")
    return worst


def tuned_bucket_error(torch, sync, coll, group) -> dict:
    """Each leader's sum buckets synced under the tuner's current transports
    (quiet: no observation, no decision), against the local state, which is
    the exact sync in a world of one: the error relative to each bucket's
    largest value, as phase 14 holds it."""
    out = {}
    for group_names in coll.compute_groups.values():
        leader = coll[group_names[0]]
        state = leader.get_state()
        with sync._quiet():
            synced = leader.sync_states(state, group)
        out[group_names[0]] = bucket_error(torch, leader, synced, state)
    return out


def phase_nineteen_a(torch, mt, np, kernels_mod, sync, obs, world, twin_group, device, smi) -> dict:
    """19(a): live tuning on config2 + binned AP, the card against its CPU twin;
    then 19(b), the exported plan pinned and replayed."""
    import tempfile

    at = mt.autotune
    stream, twin_stream = tune_stream(torch, np, device), tune_stream(torch, np, "cpu")
    kernels_mod.reset_launch_counts()
    mt.set_autotune(True)
    coll = serve_template(mt, device)
    synced = []
    with obs.trace() as tracer:
        explore = tune_rounds(torch, sync, coll, stream, world, 0, TUNE_ROUNDS, synced)
    ctl = at.get_controller()
    decisions = [dict(d) for d in ctl.decisions]
    events = [e.args for e in tracer.events() if e.name == "sync/tune_decision"]
    check(events == decisions, f"19(a): {len(events)} sync/tune_decision events for {len(decisions)} decisions")
    check(decisions and all(t.phase == "committed" for t in ctl.buckets.values()),
          f"19(a): buckets {[(k, t.phase, t.current) for k, t in ctl.buckets.items()]} after {TUNE_ROUNDS} rounds")
    for d in decisions:  # every transport the tuner chose passes the gate at its bucket's parameters
        tuner = ctl.buckets[d["bucket"]]
        final, refusal = sync._gate_transport(d["to"], tuner.red, tuner.dtype, tuner.nelems, tuner.world,
                                              tuner.tolerance_for(d["to"]) if d["to"] != "exact" else None,
                                              error_scale=tuner.max_error_scale)
        check(final == d["to"] and refusal is None, f"19(a): decision {d} is not admissible: {refusal}")
    committed = {k: (t.current, t.cadence) for k, t in ctl.buckets.items()}
    epoch, before = at.decision_epoch(), tune_snapshot(coll)
    post = tune_rounds(torch, sync, coll, stream, world, TUNE_ROUNDS, TUNE_ROUNDS, synced)
    after = tune_snapshot(coll)
    check(ctl.decisions == decisions and at.decision_epoch() == epoch,
          f"19(a): {len(ctl.decisions) - len(decisions)} decisions after the commit, epoch {epoch} -> {at.decision_epoch()}")
    check(after == before, f"19(a): the post-commit rounds rebuilt or captured: {before} -> {after}")
    errors = tuned_bucket_error(torch, sync, coll, world)
    worst_bound = max(sync.transport_error_bound(t, 1) for t, _ in committed.values())
    check(max(errors.values()) <= worst_bound, f"19(a): synced-state errors {errors} past the bound {worst_bound:.3e}")
    updates = 2 * TUNE_ROUNDS * TUNE_UPDATES
    launches = kernels_mod.launch_counts()
    check(launches["binned_counts"] == updates, f"19(a): B1 launched {launches['binned_counts']} times for {updates} updates")
    stats = coll.engine_stats()
    check(not stats["fallback_reasons"], f"19(a): fallbacks {stats['fallback_reasons']}")
    plan = at.export_plan()

    # the CPU twin, from a fresh controller, through gloo
    mt.set_autotune(True)
    twin = serve_template(mt, "cpu")
    twin_synced = []
    twin_results = tune_rounds(torch, sync, twin, twin_stream, twin_group, 0, 2 * TUNE_ROUNDS, twin_synced)
    twin_ctl = at.get_controller()
    check(json.dumps(twin_ctl.decisions, sort_keys=True) == json.dumps(decisions, sort_keys=True),
          f"19(a): the CPU twin decided {twin_ctl.decisions}, the card {decisions}")
    for i, (mine, theirs) in enumerate(zip(synced, twin_synced)):
        check(same_tree(torch, mine, theirs), f"19(a): round {i}'s tuned synced states differ from the CPU twin's")
    # the macro averages and the binned AP reduce over classes and thresholds
    # in another order on the card than on the CPU (their synced states are
    # bitwise the twin's, above); micro accuracy is bitwise
    twin_diff = same_computes(torch, "19(a) card against its CPU twin",
                              [torch.utils._pytree.tree_map(lambda x: x.cpu(), r) for r in explore + post],
                              twin_results, atol={k: CURVE_ATOL for k in ("f1", "precision", "recall", "binned_ap")})
    print(f"phase 19(a) ({smi}): {len(decisions)} decisions in {TUNE_ROUNDS} rounds, committed {committed};"
          f" synced-state error {errors} (bound {worst_bound:.3e}); {TUNE_ROUNDS} more rounds: no decision, epoch"
          f" {epoch}, no rebuild or capture ({after}); B1 launched {launches['binned_counts']} times for {updates}"
          f" updates; decisions, synced states and accuracy bitwise equal to the CPU twin's; the other computes within"
          f" {twin_diff} (tolerance {CURVE_ATOL:g})")

    # 19(b): the plan saved, pinned from its file, replayed on a fresh collection
    with tempfile.TemporaryDirectory(prefix="chip_smoke_phase19_") as tmp:
        path = os.path.join(tmp, "tuned_plan.json")
        plan.save(path)
        mt.set_autotune(path)
        pinned_epoch = at.decision_epoch()
        pinned = serve_template(mt, device)
        replay = tune_rounds(torch, sync, pinned, stream, world, 0, 2 * TUNE_ROUNDS)
    pin_ctl = at.get_controller()
    check(pin_ctl.pinned is not None and pin_ctl.decisions == [] and at.decision_epoch() == pinned_epoch,
          f"19(b): the pinned run decided {pin_ctl.decisions}, epoch {pinned_epoch} -> {at.decision_epoch()}")
    snap = tune_snapshot(pinned)
    check(snap["builds"] == 1 and snap["captures"] == (1, 1), f"19(b): the pinned run rebuilt or recaptured: {snap}")
    same_computes(torch, "19(b) pinned replay against 19(a)'s post-commit rounds", replay[TUNE_ROUNDS:], post)
    # the synced compute's time, captured, under the committed transports and under exact
    times = {}
    for label in ("committed", "exact"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_phase19_") as tmp:
            if label == "committed":
                path = os.path.join(tmp, "tuned_plan.json")
                plan.save(path)
                mt.set_autotune(path)
            else:
                mt.set_autotune(False)
            timed = serve_template(mt, device)
            tune_rounds(torch, sync, timed, stream, world, 0, 3)
            samples = []
            with sync.sync_axes(world):
                for _ in range(20):
                    for m in timed.values():
                        m._computed = None
                    samples.append(event_ms(torch, timed.compute)[1])
        times[label] = statistics.median(samples)
    mt.set_autotune(None)
    print(f"phase 19(b) ({smi}): the plan pinned from its JSON: no decision, epoch {pinned_epoch} unmoved, one build and"
          f" one capture each for update and compute; rounds {TUNE_ROUNDS + 1}-{2 * TUNE_ROUNDS} bitwise equal to 19(a)'s;"
          f" synced compute (captured, median of 20 by CUDA events) {times['committed']:.3f} ms under the committed"
          f" transports, {times['exact']:.3f} ms exact (a world of one moves nothing over a link)")
    return {"decisions": len(decisions), "committed": committed, "errors": errors, "launches": launches,
            "compute_ms": times, "plan": plan.to_dict()}


def phase_nineteen_c(torch, mt, sync, world, twin_group, device, smi) -> dict:
    """19(c): sync_state of tests/autotune/test_sync_integration.py's state,
    12 times, on the card and on its CPU twin."""
    at = mt.autotune
    base = {"big": torch.linspace(0.1, 40.0, 8192, dtype=torch.float32),
            "counts": torch.arange(1000, dtype=torch.int32) % 7,
            "mx": torch.tensor([7.0, 1.0], dtype=torch.float32)}
    reds = {"big": "sum", "counts": "sum", "mx": "max"}
    runs = {}
    for label, dev, group in (("card", device, world), ("twin", "cpu", twin_group)):
        state = {k: v.to(dev) for k, v in base.items()}
        mt.set_autotune(True)
        outs = [sync.sync_state(state, reds, group, bucketed=True) for _ in range(TUNE_SYNCS)]
        ctl = at.get_controller()
        runs[label] = (ctl, outs, state)
    ctl, outs, state = runs["card"]
    twin_ctl, twin_outs, _ = runs["twin"]
    check(json.dumps(ctl.decisions, sort_keys=True) == json.dumps(twin_ctl.decisions, sort_keys=True),
          f"19(c): the card decided {ctl.decisions}, the CPU twin {twin_ctl.decisions}")
    got = {k: (t.current, t.cadence, t.phase) for k, t in ctl.buckets.items()}
    want = {"sum|float32|psum": ("int8", 4, "committed"), "sum|int32|psum": ("int8", 4, "committed"),
            "max|float32|psum": ("exact", ctl.config.max_cadence, "committed")}
    check(got == want, f"19(c): buckets {got}, expected {want}")
    check(all(d["to"] == "exact" for d in ctl.decisions if d["bucket"] == "max|float32|psum"),
          f"19(c): the max bucket left exact: {ctl.decisions}")
    for out, twin_out in zip(outs, twin_outs):
        for k in base:
            check(same_bits(torch, out[k], twin_out[k]), f"19(c): synced {k} differs from the CPU twin's")
    worst = {}
    for k in ("big", "counts"):
        exact64, got64 = state[k].double(), outs[-1][k].double()
        worst[k] = float((got64 - exact64).abs().max()) / float(exact64.abs().max())
    bound_rel = sync.transport_error_bound("int8", 1)
    check(max(worst.values()) <= bound_rel, f"19(c): int8 errors {worst} past the bound {bound_rel:.3e}")
    check(same_bits(torch, outs[-1]["mx"], state["mx"]), "19(c): the max bucket is not exact")
    print(f"phase 19(c) ({smi}): {len(ctl.decisions)} decisions in {TUNE_SYNCS} syncs, equal to the CPU twin's; committed"
          f" {got}; int8 error {worst} (bound {bound_rel:.3e}); max exact; synced values bitwise equal to the twin's")
    mt.set_autotune(None)
    return {"decisions": len(ctl.decisions), "committed": got, "errors": worst}


def coco_chunk(torch, b: int, d: int, g: int, a: int, t: int, device: str, seed: int) -> tuple:
    """evaluate_matches' inputs for ``b`` padded COCO images (80 classes padded
    to 128, the four area ranges, ``t`` IoU thresholds from 0.5)."""
    gen = torch.Generator().manual_seed(seed)

    def boxes(n):
        xy = torch.rand((b, n, 2), generator=gen) * 500.0
        wh = 1.0 + torch.rand((b, n, 2), generator=gen) * 199.0
        return torch.cat([xy, xy + wh], dim=-1)

    areas = torch.tensor([[0.0, 1e10], [0.0, 32.0 ** 2], [32.0 ** 2, 96.0 ** 2], [96.0 ** 2, 1e10]])[:a]
    args = (boxes(d), torch.rand((b, d), generator=gen), torch.randint(0, 80, (b, d), generator=gen, dtype=torch.int32),
            torch.randint(0, d + 1, (b,), generator=gen, dtype=torch.int32), boxes(g),
            torch.randint(0, 80, (b, g), generator=gen, dtype=torch.int32),
            torch.randint(0, g + 1, (b,), generator=gen, dtype=torch.int32), torch.arange(128, dtype=torch.int32),
            torch.arange(128) < 80, areas, 0.5 + 0.05 * torch.arange(t, dtype=torch.float32))
    return tuple(x.to(device).contiguous() for x in args)


def heavy_series(registry) -> dict:
    """The heavy-kernel series: calls by (kernel, impl), bucket-width
    histogram counts by kernel, fallbacks by kernel."""
    out = {"calls": {}, "widths": {}, "fallbacks": {}}
    for sample in registry.samples():
        labels = sample.labels
        if sample.name == "metrics_tpu_heavy_kernel_calls":
            out["calls"][(labels["kernel"], labels["impl"])] = sample.value
        elif sample.name == "metrics_tpu_heavy_kernel_bucket_width_bucket":
            out["widths"][(labels["kernel"], labels["le"])] = sample.value
        elif sample.name == "metrics_tpu_heavy_kernel_fallbacks":
            out["fallbacks"][labels["kernel"]] = sample.value
    return out


def series_delta(after: dict, before: dict) -> dict:
    return {part: {k: v - before[part].get(k, 0.0) for k, v in after[part].items() if v != before[part].get(k, 0.0)}
            for part in after}


def phase_nineteen_d(torch, mt, kernels_mod, obs, device, smi) -> dict:
    """19(d): evaluate_matches, pairwise_cosine_pr and a bucketed feature
    forward under the tracer: the registry's series, events and trace counts
    against the calls and the launch counters."""
    from metrics_tpu_torch.observability.instruments import REGISTRY
    from metrics_tpu_torch.ops.kernels import features as feats

    b, a, t, d, g = COCO_CHUNK
    chunks = [coco_chunk(torch, b, d, g, a, t, device, SEED + 191), coco_chunk(torch, b, d, g, a, t, device, SEED + 192),
              coco_chunk(torch, COCO_SMALL_CHUNK, d, g, a, t, device, SEED + 193)]
    pb, pl, pp, pr, pd = BERT_CHUNK
    gen = torch.Generator().manual_seed(SEED + 194)

    def unit(*shape):
        x = torch.randn(shape, generator=gen)
        return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).to(device)

    texts = [(unit(pb, pl, pp, pd), unit(pb, pl, pr, pd), torch.full((pb, pp), 1.0 / pp, device=device),
              torch.full((pb, pr), 1.0 / pr, device=device)) for _ in range(2)]
    conv = torch.nn.Conv2d(3, 8, 3).to(device)
    extractor = mt.ops.kernels.BucketedFeatureExtractor(lambda x: conv(x).mean(dim=(2, 3)))
    images = torch.randn((FEATURE_ROWS, 3, 32, 32), generator=gen).to(device)
    if device == "cuda":
        torch.cuda.synchronize()
    kernels_mod.reset_trace_counts()
    kernels_mod.reset_launch_counts()
    before = heavy_series(REGISTRY)
    with obs.trace() as tracer, torch.no_grad():
        for chunk in chunks:
            kernels_mod.evaluate_matches(*chunk, max_det=100)
        for text in texts:
            kernels_mod.pairwise_cosine_pr(*text)
        feats_out = extractor(images)
    if device == "cuda":
        torch.cuda.synchronize()
    delta = series_delta(heavy_series(REGISTRY), before)
    launches = kernels_mod.launch_counts()
    traces = kernels_mod.trace_counts()
    impl = "cuda" if device == "cuda" else "torch"
    check(feats_out.shape == (FEATURE_ROWS, 8), f"19(d): the bucketed forward returned {tuple(feats_out.shape)}")
    check(delta["calls"] == {("iou_matching", impl): 3.0, ("cosine_matching", impl): 2.0,
                             ("feature_extract", "torch"): 1.0}, f"19(d): heavy_kernel_calls moved by {delta['calls']}")
    want_launches = {"pairwise_iou": 3, "greedy_match": 3, "maxsim_tf32x3": 2} if device == "cuda" else {}
    moved = {k: n for k, n in launches.items() if n}
    check(moved == want_launches, f"19(d): launches {moved}, expected {want_launches}")
    widths = {}
    for (kernel, le), n in delta["widths"].items():  # cumulative buckets: the smallest le that moved
        if le != "+Inf" and (kernel not in widths or float(le) < widths[kernel][0]):
            widths[kernel] = (float(le), n)
    check(widths == {"iou_matching": (float(d), 3.0), "cosine_matching": (float(pp), 2.0),
                     "feature_extract": (float(FEATURE_BUCKET), 1.0)}, f"19(d): bucket widths {widths}")
    events = [e.args for e in tracer.events() if e.name == "kernel/dispatch"]
    want_events = ([{"kernel": "iou_matching", "impl": impl, "bucket_width": d}] * 3
                   + [{"kernel": "cosine_matching", "impl": impl, "bucket_width": pp}] * 2
                   + [{"kernel": "feature_extract", "impl": "torch", "bucket_width": FEATURE_BUCKET}])
    check(events == want_events, f"19(d): kernel/dispatch events {events}")
    check(not delta["fallbacks"] and not any(e.name == "kernel/fallback" for e in tracer.events()),
          f"19(d): fallbacks recorded: {delta['fallbacks']}")
    check(traces == {"iou_matching": 2, "cosine_matching": 1}, f"19(d): trace counts {traces}")
    print(f"phase 19(d) ({smi}): heavy_kernel_calls moved by {delta['calls']}; launches {moved}; bucket widths {widths};"
          f" {len(events)} kernel/dispatch events; no fallback; trace counts {traces} (the repeated shapes counted once)")
    return {"launches": launches, "calls": {f"{k}/{i}": n for (k, i), n in delta["calls"].items()}, "traces": traces}


def phase_nineteen(torch, mt, np, kernels_mod, sync, smi, device="cuda") -> dict:
    import torch.distributed as dist

    from metrics_tpu_torch import observability as obs

    t0 = time.perf_counter()
    if device == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        world = dist.group.WORLD
        twin_group = dist.new_group(ranks=[0], backend="gloo")
        a = phase_nineteen_a(torch, mt, np, kernels_mod, sync, obs, world, twin_group, device, smi)
        c = phase_nineteen_c(torch, mt, sync, world, twin_group, device, smi)
    finally:
        mt.set_autotune(None)
        dist.destroy_process_group()
    d = phase_nineteen_d(torch, mt, kernels_mod, obs, device, smi)
    launches = {k: a["launches"][k] + d["launches"][k] for k in a["launches"]}
    elapsed = time.perf_counter() - t0
    print(f"phase 19 ({smi}): {elapsed:.1f} s in all (limit {PHASE19_LIMIT_S:.0f} s); kernel launches {launches}")
    check(elapsed < PHASE19_LIMIT_S, f"phase 19 took {elapsed:.1f} s, over its {PHASE19_LIMIT_S:.0f} s")
    return {"a": a, "c": c, "d": d, "seconds": elapsed, "launches": launches}


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
    print(f"phase 2: built {sorted(kernels_mod.CUDA_KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for kernel in kernels_mod.CUDA_KERNELS.values():
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line or "arning" in line:
                print(f"  ptxas {kernel.name}: {line.strip()}")
    worst_err = {
        "binned_counts": check_binned_kernel(torch, kernels_mod, binned),
        "pairwise_iou": check_iou_kernel(torch, kernels_mod, im),
        "greedy_match": check_match_kernel(torch, kernels_mod, im),
        "maxsim_tf32x3": check_maxsim_kernel(torch, kernels_mod, cm),
        "binned_counts_batched": check_batched_binned_kernel(torch, kernels_mod, binned),
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
    map_metric, coco, det_launches, map_results = detection_phase(torch, mt, kernels_mod)
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

    # ---- phase 7: the curve family and the compiled mAP update
    seven = phase_seven(torch, mt, np, kernels_mod, coco, map_metric, map_results, smi)

    # ---- phase 8: the rest of classification and the aggregators (no kernel of B1-B3 on its path)
    eight = phase_eight(torch, mt, np, kernels_mod, sync, smi)

    # ---- phase 9: regression, pairwise and retrieval (no kernel of B1-B3 on its path)
    nine = phase_nine(torch, mt, np, kernels_mod, sync, smi)

    # ---- phase 10: the wrappers and the text metrics other than BERTScore (no kernel of B1-B3 on its path)
    ten = phase_ten(torch, mt, np, kernels_mod, smi)

    # ---- phase 11: the rest of detection (host lists, segm, 300 detections) and the sketches
    eleven = phase_eleven(torch, mt, np, kernels_mod, sync, coco, map_results, smi)

    # ---- phase 12: image (no kernel of B1-B3 on its path)
    twelve = phase_twelve(torch, mt, np, kernels_mod, sync, smi)

    # ---- phase 13: audio (no kernel of B1-B3 on its path)
    thirteen = phase_thirteen(torch, mt, np, kernels_mod, smi)

    # ---- phase 14: sync variants (B1 inside the captured incremental step)
    fourteen = phase_fourteen(torch, mt, np, kernels_mod, sync, smi)

    # ---- phase 15: sharded state (B1 on the sharded binned and grid paths)
    fifteen = phase_fifteen(torch, mt, np, kernels_mod, sync, binned, smi)

    # ---- phase 16: observability and resilience on the captured main path (B1 traced, profiled, timed)
    sixteen = phase_sixteen(torch, mt, np, kernels_mod, sync, smi)

    # ---- phase 17: checkpoint and tenancy (B1's tenant-batched launch on the stacked updates)
    seventeen = phase_seventeen(torch, mt, np, kernels_mod, sync, binned, smi)

    # ---- phase 18: serve and cluster (the batched B1 launch under HTTP ingest, two replicas)
    eighteen = phase_eighteen(torch, mt, np, kernels_mod, smi)

    # ---- phase 19: self-tuning sync (B1 on the tuned main path) and the heavy-kernel registry's telemetry
    # (B2 + the matcher and B3 dispatched under it)
    nineteen = phase_nineteen(torch, mt, np, kernels_mod, sync, smi)

    def record(kname, timing, **extra):
        us = {"us": timing["ms"] * 1e3, "plain_us": timing["plain_ms"] * 1e3, "bound_us": timing["bound_ms"] * 1e3}
        return {
            "name": kname,
            "route": "cuda",
            "source": f"metrics_tpu_torch/csrc/{kernels_mod.CUDA_KERNELS[kname].source}",
            "replaces": kernels_mod.CUDA_KERNELS[kname].replaces,
            "launches": launches[kname],
            "max_abs_err": worst_err[kname],
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing.get("library_ms"),
            "ok": True,
            "phase8_launches": eight["launches"][kname],
            "phase9_launches": nine["launches"][kname],
            "phase10_launches": ten["launches"][kname],
            "phase11_launches": eleven["launches"][kname],
            "phase12_launches": twelve["launches"][kname],
            "phase13_launches": thirteen["launches"][kname],
            "phase14_launches": fourteen["launches"][kname],
            "phase15_launches": fifteen["launches"][kname],
            "phase16_launches": sixteen["launches"][kname],
            "phase17_launches": seventeen["launches"][kname],
            "phase18_launches": eighteen["launches"][kname],
            "phase19_launches": nineteen["launches"][kname],
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
               eager_compute_idle_share=[r["compute_idle"] for r in timings["eager"]],
               phase14_sync_ms={"config2": {t: fourteen["a"][t]["ms"] for t in sync.TRANSPORTS},
                                **{f"confmat_{regime}": {t: fourteen["b"][regime][t]["ms"] for t in sync.TRANSPORTS}
                                   for regime in ("sparse", "dense")}},
               phase14_incremental_step_ms={k: {"captured": r["step_ms"], "eager": r["eager_step_ms"]}
                                            for k, r in fourteen["c"].items()},
               phase14_synced_compute_ms={"eager": fourteen["d"]["eager_ms"], "captured": fourteen["d"]["captured_ms"]},
               phase15_confmat_update_ms={"captured": fifteen["a"]["captured_ms"], "eager": fifteen["a"]["eager_ms"]},
               phase15_confmat_eager_update_peak_mib=fifteen["a"]["peak_eager_mib"],
               phase15_binned_update_ms={k: r["update_ms"] for k, r in fifteen["b"].items()},
               phase15_grid_update_ms=fifteen["d"]["update_ms"],
               phase16_step_us={"tracer_off": sixteen["f"]["off_us"], "tracer_on": sixteen["f"]["on_us"]},
               phase16_correlation={k: sixteen["b"][k] for k in ("matched", "unmatched", "host_dispatches")},
               phase17_restored_run_launches=seventeen["a"]["launches_after_restore"],
               phase17_route_us=seventeen["routes"],
               phase19_tuned={"decisions": nineteen["a"]["decisions"], "committed": nineteen["a"]["committed"],
                              "synced_compute_ms": nineteen["a"]["compute_ms"]}),
        record("pairwise_iou", {k: v for k, v in det["pairwise_iou"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes batched pairwise IoU",
               compiled_map_compute_launches=seven["map"]["launches"]["pairwise_iou"],
               host_list_map_chunks=eleven["a"]["chunks"], host_list_map_update_s=eleven["a"]["update_s"],
               host_list_map_compute_split_s=eleven["a"]["split"],
               **{k: det["pairwise_iou"][k] for k in ("shape", "device_us", "count_free_ms", "unfused_step_ms",
                                                      "unfused_step_device_us")}),
        record("greedy_match", {k: v for k, v in det["greedy_match"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_note="no single PyTorch call computes the greedy COCO matching",
               shape=det["greedy_match"]["shape"], device_us=det["greedy_match"]["device_us"],
               g64=det["greedy_match"]["g64"], map_update_us=det["map_update_us"], map_update_host_us=det["map_update_host_us"],
               map_compute_eval_s=det["map_compute_eval_s"], map_compute_calc_s=det["map_compute_calc_s"],
               map_compute_idle_share=det["map_compute_idle_share"],
               compiled_map_compute_launches=seven["map"]["launches"]["greedy_match"],
               compiled_map_update_us=seven["map"]["update_us"], compiled_map_compute_s=seven["map"]["compute_s"],
               segm_map=eleven["c"]),
        record("maxsim_tf32x3", {k: v for k, v in txt["full"].items() if k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
               library_note="torch.bmm then two amax, TF32 off (three calls; the port never calls them)",
               shape=txt["full"]["shape"], device_us=txt["full"]["device_us"],
               chunk={k: v for k, v in txt["chunk"].items()},
               bert_update_s=text["update_s"], bert_compute_s=text["compute_s"],
               bert_compute_split_ms=text["split_ms"], bert_compute_device_busy_ms=text["device_busy_ms"],
               bert_compute_idle_share=text["idle_share"]),
    ]
    batched = seventeen["kernel"]
    kernels.append({
        "name": "binned_counts_batched",
        "route": "cuda",
        "source": f"metrics_tpu_torch/csrc/{kernels_mod.CUDA_KERNELS['binned_counts_batched'].source}",
        "replaces": kernels_mod.CUDA_KERNELS["binned_counts_batched"].replaces,
        "launches": seventeen["launches"]["binned_counts_batched"],
        "max_abs_err": worst_err["binned_counts_batched"],
        **{k: batched[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "ok": True,
        "library_note": "none: no single PyTorch call computes per-class counts at every threshold, batched or not",
        "entry": "binned_counts_batched_launch, B1's tenant-batched launch (one launch for every tenant)",
        "shape": batched["shape"], "device_us": batched["device_us"], "graph_device_us": batched["graph_device_us"],
        **{f"phase{p}_launches": r["launches"].get("binned_counts_batched", 0)
           for p, r in ((8, eight), (9, nine), (10, ten), (11, eleven), (12, twelve), (13, thirteen), (14, fourteen),
                        (15, fifteen), (16, sixteen), (17, seventeen), (18, eighteen), (19, nineteen))},
        "phase17_stacked_update_launches": seventeen["d"]["main_launches"],
        "phase18_serve": {k: eighteen["a"][k] for k in ("observations", "obs_per_s", "post_p50_ms", "post_p99_ms",
                                                         "read_p50_ms", "read_p99_ms", "dispatches", "mean_width",
                                                         "update_widths")},
        "phase18_cluster": {k: eighteen["b"][k] for k in ("fence_ms", "recovery_s", "replayed", "dispatches")},
        "phase17_checkpoint": {"a": seventeen["a"]["timings"], "b": seventeen["b"]},
        "phase17_tenancy_us": {str(n): r for n, r in seventeen["d"]["timing"].items()},
        "us": batched["ms"] * 1e3, "plain_us": batched["plain_ms"] * 1e3, "bound_us": batched["bound_ms"] * 1e3,
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
