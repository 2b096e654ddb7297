"""The generative side of the image slice in the port against the JAX
package on the CPU: the FID and KID ops, FID, KID, IS and LPIPS beyond the
A1 harness's ``INVENTORY`` cases, the pow2 feature bucketing, FID's
list-free sync in a gloo world of 4 ranks, and FID state carried from JAX.

Inputs come from seeded numpy generators. Tolerances, each with its reason:

- the FID and KID ops within 1e-5 relative of JAX at D = 64 (two eigh
  implementations agree to a few float32 ulps there; an MMD, a difference
  of kernel sums of order 1, within 1e-5 absolute), and within the JAX
  package's float64 bounds at D = 256: FID 1e-3 relative, the trace term
  5e-3 (``tests/image/test_fid_numerics.py:38,50``), KID rtol 1e-4 / atol
  1e-5 (``tests/image/test_generative.py:206``);
- FID's float32 moment sums within 1e-6 of each state's largest entry, its
  value within 1e-4 relative; KID within rtol 1e-4 / atol 1e-6; IS within
  rtol 1e-5 / atol 1e-6;
- bit for bit where nothing is summed: the bucketing's slices, the captured
  update against eager, the synced Welford fold against the same fold in
  one process, FID state carried from JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu.ops.image import fid as jfid
from metrics_tpu.ops.image import kid as jkid
from metrics_tpu_torch import convert
from metrics_tpu_torch.image.fid import fold_triples
from metrics_tpu_torch.ops.image import fid as tfid
from metrics_tpu_torch.ops.image import kid as tkid
from metrics_tpu_torch.ops.kernels import features as feats
from metrics_tpu_torch.utils.checks import _checks_off
from tests.helpers import torch_dist as td
from tests.helpers.fid_fixtures import inception_like, oracle_fid
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

ATOL = 1e-5
RTOL = 1e-5
WORLD = 4
# the JAX references run eagerly: their engines would compile each stream's steps
JAX_EAGER = dict(compiled_update=False, compiled_compute=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _pair(seed, shape, noise=0.25):
    rng = np.random.default_rng(seed)
    t = rng.random(shape).astype(np.float32)
    p = np.clip(t + noise * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return p, t


def _both(fn_jax, fn_torch, *arrays, **kwargs):
    want = fn_jax(*[jnp.asarray(a) for a in arrays], **kwargs)
    got = fn_torch(*[torch.from_numpy(a) for a in arrays], **kwargs)
    return got, want


def _close(got, want, rtol=0.0, atol=ATOL, msg=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), msg
        for g, w in zip(got, want):
            _close(g, w, rtol, atol, msg)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, f"{msg}: {g.dtype} != {w.dtype}"
    assert_close(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=atol, msg=msg)


# --------------------------------------------------------------------------- #
# the FID and KID ops
# --------------------------------------------------------------------------- #
def _features(seed, n, d, shift=0.0):
    return inception_like(np.random.default_rng(seed), n, d, shift=shift, rank=16).astype(np.float32)


def test_fid_ops_match_jax_at_d64():
    fr, ff = _features(20, 300, 64), _features(21, 300, 64, shift=0.05)
    got, want = _both(jfid.frechet_distance, tfid.frechet_distance, fr, ff)
    _close(got, want, rtol=1e-5, atol=0.0)
    s1, s2 = np.cov(fr, rowvar=False).astype(np.float32), np.cov(ff, rowvar=False).astype(np.float32)
    got, want = _both(jfid.trace_sqrtm_product, tfid.trace_sqrtm_product, s1, s2)
    _close(got, want, rtol=1e-5, atol=0.0)
    got, want = _both(jfid.sqrtm_psd, tfid.sqrtm_psd, s1)
    _close(got, want, atol=1e-6)


def test_welford_matches_jax_and_two_pass_moments():
    x = _features(22, 96, 64)
    state = (np.float32(0.0), np.zeros(64, np.float32), np.zeros((64, 64), np.float32))
    tstate = tuple(torch.from_numpy(np.asarray(a)) for a in state)
    jstate = tuple(jnp.asarray(a) for a in state)
    for chunk in np.split(x, [10, 37, 64]):
        tstate = tfid.welford_update(*tstate, torch.from_numpy(chunk))
        jstate = jfid.welford_update(*jstate, jnp.asarray(chunk))
    for g, w in zip(tstate, jstate):
        _close(g, w, rtol=1e-5, atol=1e-6)
    assert tstate[0].dtype == torch.float32 and float(tstate[0]) == 96.0
    mean64 = x.astype(np.float64).mean(0)
    assert_close(tstate[1].numpy(), mean64, rtol=0, atol=1e-6)
    m2_64 = (x - mean64).T @ (x - mean64)
    assert_close(tstate[2].numpy(), m2_64, rtol=0, atol=1e-5 * np.abs(m2_64).max())


def test_fid_against_float64_at_d256():
    fr, ff = _features(23, 100, 256), _features(24, 100, 256, shift=0.05)
    with threadpool_limits(1):  # scipy's sqrtm: its BLAS threads contend with the other test workers' otherwise
        want = oracle_fid(fr.astype(np.float64), ff.astype(np.float64))
    got = float(tfid.frechet_distance(torch.from_numpy(fr), torch.from_numpy(ff)))
    assert abs(got - want) / abs(want) < 1e-3
    s1, s2 = np.cov(fr.astype(np.float64), rowvar=False), np.cov(ff.astype(np.float64), rowvar=False)
    with threadpool_limits(1):
        want_tr = float(np.trace(scipy.linalg.sqrtm(s1 @ s2).real))
    got_tr = float(tfid.trace_sqrtm_product(torch.from_numpy(s1.astype(np.float32)), torch.from_numpy(s2.astype(np.float32))))
    assert abs(got_tr - want_tr) / abs(want_tr) < 5e-3


def _np_poly_mmd(fr, ff, degree=3, coef=1.0):
    gamma = 1.0 / fr.shape[1]
    k = lambda a, b: (a @ b.T * gamma + coef) ** degree  # noqa: E731
    kxx, kyy, kxy = k(fr, fr), k(ff, ff), k(fr, ff)
    m = fr.shape[0]
    return ((kxx.sum() - np.trace(kxx)) + (kyy.sum() - np.trace(kyy))) / (m * (m - 1)) - 2 * kxy.sum() / m ** 2


@pytest.mark.parametrize("d", [64, 256])
def test_kid_ops_match_jax_and_float64(d):
    fr = _features(25, 3 * 40, d).reshape(3, 40, d)
    ff = _features(26, 3 * 40, d, shift=0.02).reshape(3, 40, d)
    got, want = _both(jkid.batched_poly_mmd, tkid.batched_poly_mmd, fr, ff)
    # an MMD is a difference of kernel sums of order 1: its float32 error is absolute
    _close(got, want, rtol=1e-5, atol=1e-5)
    oracle = np.array([_np_poly_mmd(a.astype(np.float64), b.astype(np.float64)) for a, b in zip(fr, ff)])
    assert_close(got.numpy().astype(np.float64), oracle, rtol=1e-4, atol=1e-5)
    single = tkid.poly_mmd(torch.from_numpy(fr[0]), torch.from_numpy(ff[0]), degree=2, gamma=0.5, coef=2.0)
    scale = float(((fr[0] @ ff[0].T) * 0.5 + 2.0).max() ** 2)  # the largest kernel entry
    _close(single, jkid.poly_mmd(jnp.asarray(fr[0]), jnp.asarray(ff[0]), degree=2, gamma=0.5, coef=2.0),
           atol=1e-6 * scale)


# --------------------------------------------------------------------------- #
# the generative metric classes beyond the harness's INVENTORY cases
# --------------------------------------------------------------------------- #
class _Project:
    """A row-independent linear feature extractor for the metric tests."""

    def __init__(self, in_dim, d, seed, lib):
        w = (np.random.default_rng(seed).normal(size=(in_dim, d)) / np.sqrt(in_dim)).astype(np.float32)
        self.w = jnp.asarray(w) if lib == "jax" else torch.from_numpy(w)
        self.num_features = d

    def __call__(self, imgs):
        flat = imgs.reshape(imgs.shape[0], -1)
        if isinstance(self.w, torch.Tensor):
            return flat.to(torch.float32) @ self.w
        return flat.astype(jnp.float32) @ self.w


def _imgs(seed, n, shape=(3, 6, 6)):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape)).astype(np.uint8)


def test_fid_metric_matches_jax_and_keeps_real_features():
    ref = mj.FrechetInceptionDistance(feature=_Project(108, 8, 1, "jax"), reset_real_features=False, **JAX_EAGER)
    port = mt.FrechetInceptionDistance(feature=_Project(108, 8, 1, "torch"), reset_real_features=False, device="cpu")
    for i, n in enumerate((5, 8, 11)):  # ragged batches: 5 and 11 go through the pow2 bucketing
        for real in (True, False):
            imgs = _imgs(50 + 2 * i + real, n)
            ref.update(jnp.asarray(imgs), real=real)
            port.update(torch.from_numpy(imgs), real=real)
    for name in port._defaults:  # float32 sums of uint8-scale features: within 1e-6 of each state's largest entry
        assert getattr(port, name).dtype == torch.float32
        want = np.asarray(getattr(ref, name))
        _close(getattr(port, name), want, atol=1e-6 * float(np.abs(want).max()), msg=name)
    _close(port.compute(), ref.compute(), rtol=1e-4, atol=0.0)
    port.reset()
    assert float(port.real_n) == 24.0 and float(port.fake_n) == 0.0


def test_fid_state_carried_from_jax_continues_the_stream():
    ref = mj.FrechetInceptionDistance(feature=_Project(108, 8, 2, "jax"), **JAX_EAGER)
    port = mt.FrechetInceptionDistance(feature=_Project(108, 8, 2, "torch"), device="cpu")
    for real in (True, False):
        ref.update(jnp.asarray(_imgs(60 + real, 8)), real=real)
    state = {k: np.asarray(v) for k, v in ref.get_state().items()}
    convert.state_from_numpy(port, state)
    for name in port._defaults:
        assert_bitwise(getattr(port, name), state[name], name)
    for real in (True, False):
        ref.update(jnp.asarray(_imgs(62 + real, 8)), real=real)
        port.update(torch.from_numpy(_imgs(62 + real, 8)), real=real)
    _close(port.compute(), ref.compute(), rtol=1e-4, atol=0.0)
    with pytest.raises(ValueError, match="expected float32"):
        convert.state_from_numpy(port, {**state, "real_n": np.float64(8.0)})


@pytest.mark.parametrize("buffered", [False, True], ids=["lists", "buffers"])
def test_kid_metric_matches_jax_with_the_same_host_subsets(buffered):
    extra = dict(buffer_capacity=64) if buffered else {}
    kw = dict(subsets=5, subset_size=12, seed=3, reset_real_features=False)
    ref = mj.KernelInceptionDistance(feature=_Project(108, 8, 4, "jax"), **kw, **extra, **JAX_EAGER)
    port = mt.KernelInceptionDistance(feature=_Project(108, 8, 4, "torch"), device="cpu", **kw, **extra)
    for i in range(2):
        for real in (True, False):
            imgs = _imgs(70 + 2 * i + real, 9)
            ref.update(jnp.asarray(imgs), real=real)
            port.update(torch.from_numpy(imgs), real=real)
    _close(port.compute(), ref.compute(), rtol=1e-4, atol=1e-6)
    port.reset()
    assert len(port.real_features) == (18 if buffered else 2) and len(port.fake_features) == 0
    small = mt.KernelInceptionDistance(feature=_Project(108, 8, 4, "torch"), subset_size=100, device="cpu")
    small.update(torch.from_numpy(_imgs(1, 4)), real=True)
    small.update(torch.from_numpy(_imgs(2, 4)), real=False)
    with pytest.raises(ValueError, match="subset_size"):
        small.compute()


@pytest.mark.parametrize("n,splits", [(25, 10), (40, 4), (7, 3)])
def test_inception_score_matches_jax_with_torch_chunk_groups(n, splits):
    ref = mj.InceptionScore(feature=_Project(108, 10, 5, "jax"), splits=splits, seed=11, **JAX_EAGER)
    port = mt.InceptionScore(feature=_Project(108, 10, 5, "torch"), splits=splits, seed=11, device="cpu")
    imgs = _imgs(80, n)
    ref.update(jnp.asarray(imgs))
    port.update(torch.from_numpy(imgs))
    _close(port.compute(), ref.compute(), rtol=1e-5, atol=1e-6)


def test_lpips_metric_range_check_and_reductions():
    net = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))  # noqa: E731
    with pytest.raises(ValueError, match="normalized tensors"):
        mt.LearnedPerceptualImagePatchSimilarity(net=net, device="cpu").update(torch.full((2, 3, 4, 4), 1.5),
                                                                                  torch.zeros(2, 3, 4, 4))
    with pytest.raises(ValueError, match="normalized tensors"):
        mt.LearnedPerceptualImagePatchSimilarity(net=net, device="cpu").update(torch.zeros(2, 1, 4, 4),
                                                                                  torch.zeros(2, 1, 4, 4))
    with _checks_off():  # under an engine's probe the range is not read
        assert mt.image.lpip._valid_img(torch.full((2, 3, 4, 4), 1.5))
    metric = mt.LearnedPerceptualImagePatchSimilarity(net=net, reduction="sum", device="cpu")
    metric.update(torch.zeros(3, 3, 4, 4), torch.full((3, 3, 4, 4), 0.5))
    assert float(metric.compute()) == 0.75 and metric.total.dtype == torch.float32


# --------------------------------------------------------------------------- #
# the pow2 feature bucketing
# --------------------------------------------------------------------------- #
class _RowSum:
    row_independent = True
    num_features = 1

    def __init__(self):
        self.widths = []

    def __call__(self, a, b=None):
        self.widths.append(a.shape[0])
        out = a.reshape(a.shape[0], -1).sum(1)
        return out if b is None else (out, b.reshape(b.shape[0], -1).sum(1), torch.tensor(7.0))


def test_bucketing_pads_to_pow2_and_slices_back():
    feats.reset_feature_extract_counts()
    inner = _RowSum()
    fn = feats.maybe_bucketed(inner, True)
    assert isinstance(fn, feats.BucketedFeatureExtractor) and fn.num_features == 1
    x = torch.arange(5 * 4, dtype=torch.float32).reshape(5, 4)
    assert_bitwise(fn(x), x.sum(1))
    a, b, scalar = fn(x, x + 1)  # both positional batches padded, a 0-d output left alone
    assert_bitwise(a, x.sum(1))
    assert_bitwise(b, (x + 1).sum(1))
    assert float(scalar) == 7.0
    assert_bitwise(fn(x[:4]), x[:4].sum(1))  # a power of two passes as it is
    assert inner.widths == [8, 8, 4]
    assert feats.feature_extract_counts() == {"forwards": 3, "widths": {4: 1, 8: 2}}
    assert mt.ops.kernels.next_pow2(0) == 1 and mt.ops.kernels.next_pow2(100) == 128
    assert feats.maybe_bucketed(fn, True) is fn and feats.maybe_bucketed(inner, False) is inner


def test_bucketing_opt_out_and_passthrough_under_the_engine():
    feats.reset_feature_extract_counts()
    inner = _RowSum()
    inner.row_independent = False
    assert feats.maybe_bucketed(inner, True) is inner
    inner.row_independent = True
    fn = feats.maybe_bucketed(inner, True)
    with _checks_off():  # an engine's probe or steady-state step: the engine owns the shapes
        fn(torch.ones(3, 2))
    assert inner.widths == [3] and feats.feature_extract_counts()["forwards"] == 0


def test_bucketed_fid_update_is_captured_and_matches_eager():
    def make(**kw):
        return mt.FrechetInceptionDistance(feature=_Project(108, 8, 6, "torch"), device="cpu", **kw)

    compiled, eager = make(), make(compiled_update=False, compiled_compute=False)
    for i in range(4):
        for real in (True, False):
            imgs = torch.from_numpy(_imgs(90 + 2 * i + real, 6))
            compiled.update(imgs, real=real)
            eager.update(imgs, real=real)
    stats = compiled.engine_stats()["update"]
    assert stats.cache_misses == 2 and stats.cache_hits == 4  # one capture per value of `real`
    for name in eager._defaults:
        assert_bitwise(getattr(compiled, name), getattr(eager, name).numpy(), name)


# --------------------------------------------------------------------------- #
# FID's list-free sync in a gloo world of 4
# --------------------------------------------------------------------------- #
def test_fid_sync_folds_the_ranks_in_rank_order(world):
    rng = np.random.default_rng(100)
    per_rank = [[(rng.normal(size=(n, 5)).astype(np.float32) + r, bool(k % 2)) for k, n in enumerate((3, 4, 6, 2))]
                for r in range(WORLD)]
    results = world.run(td.fid_synced, [(calls,) for calls in per_rank])
    locals_ = [res["local"] for res in results]
    want = fold_triples({k: [torch.from_numpy(loc[k]) for loc in locals_] for k in locals_[0]})
    for rank, res in enumerate(results):
        for k, v in want.items():
            assert_bitwise(res["synced"][k], v.numpy(), f"rank {rank} {k}")
        # three gathers a triple, each with its size exchange
        assert res["counts"] == {"all_gather": 6, "size_exchange": 6}, res["counts"]
        assert_close(res["fid"], float(tfid._compute_fid(
            *tfid._mean_cov_from_moments(want["real_n"], want["real_mean"], want["real_m2"]),
            *tfid._mean_cov_from_moments(want["fake_n"], want["fake_mean"], want["fake_m2"]))), rtol=0, atol=0)
