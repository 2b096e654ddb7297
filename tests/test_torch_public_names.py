"""The public names of the port against the JAX package's (ROADMAP queue C, C2).

For each package and subpackage, the names its ``__init__`` exposes in the
JAX package and not in the port must be exactly those listed in ``MISSING``,
each with the unported item it belongs to (ROADMAP queue A). A name counts
when it is public and defined by the package itself (not a typing alias or a
JAX/numpy object re-exported by accident). The names are read in a fresh
interpreter: in a test process, modules that other tests import add
themselves to their packages' namespaces. The helpers C2 added are held
against the JAX package's on the same seeded inputs.
"""
import importlib
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch

pytestmark = pytest.mark.filterwarnings("ignore")

ITEMS = {
    "A19": "serve and cluster (A19b), checkpoint (A18) and tenancy (A19a): all ported; none may be missing",
    "A20": "autotune and the kernel registry's telemetry (A20b; observability and resilience, A20a, are ported)",
    "A21": "analysis (ANALYSIS_SPECS and the analyzer surfaces)",
    "B1": "the Pallas module of B1, whose port is ops/classification/binned_counts.py",
}

def _items(item, names):
    return {name: item for name in names}


MISSING = {
    "": {
        **_items("A20", ["PolicyConfig", "TunedPlan", "autotune", "autotune_enabled", "export_tuned_plan",
                         "set_autotune"]),
    },
    "core": {},
    "utils": {},
    "observability": {"ANALYSIS_MODULE_SPECS": "A21"},
    "resilience": {},
    "checkpoint": {},
    "tenancy": {"ANALYSIS_MODULE_SPECS": "A21"},
    "serve": {"ANALYSIS_MODULE_SPECS": "A21"},
    "cluster": {"ANALYSIS_MODULE_SPECS": "A21"},
    "parallel": {"ANALYSIS_MODULE_SPECS": "A21"},
    "functional": {},
    "ops": {},
    "ops.audio": {},
    "ops.text": {},
    "ops.classification": {"binned_pallas": "B1"},
    "ops.regression": {},
    "ops.retrieval": {},
    "ops.pairwise": {},
    "ops.detection": {},
    "ops.kernels": {
        **_items("A20", ["KernelSpec", "bump_trace_count", "record_dispatch", "record_fallback", "reset_trace_counts",
                         "resolve_use_pallas", "trace_counts"]),
    },
    "aggregation": {"ANALYSIS_SPECS": "A21"},
    **{sub: {"ANALYSIS_SPECS": "A21"} for sub in ("audio", "text", "wrappers", "classification", "regression", "retrieval",
                                                  "detection")},
}


def _own(name, value, package):
    """A public name the package defines: its own modules, classes,
    functions and constants; not typing aliases or JAX/numpy objects."""
    if name.startswith("_"):
        return False
    if isinstance(value, types.ModuleType):
        return value.__name__.startswith(package)
    origin = getattr(value, "__module__", None)
    if origin is None or isinstance(value, (dict, tuple, frozenset, str, int, float)):
        return True
    return origin.startswith(package)


def _public(module, package):
    return {name for name in dir(module) if _own(name, getattr(module, name), package)}


def _modules(sub):
    suffix = f".{sub}" if sub else ""
    return importlib.import_module(f"metrics_tpu{suffix}"), importlib.import_module(f"metrics_tpu_torch{suffix}")


def public_names():
    """Each subpackage's public names in both packages, imported in sorted
    order after the two top-level packages (run in a fresh interpreter)."""
    out = {}
    for sub in sorted(MISSING):
        jax_mod, port_mod = _modules(sub)
        out[sub] = [sorted(_public(jax_mod, "metrics_tpu")), sorted(_public(port_mod, "metrics_tpu"))]
    return out


@pytest.fixture(scope="module")
def fresh_names():
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); import json; "
            "from tests.test_torch_public_names import public_names; print(json.dumps(public_names()))")
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", sorted(MISSING))
def test_missing_names_are_the_unported_items(sub, fresh_names):
    jax_names, port_names = map(set, fresh_names[sub])
    missing = jax_names - port_names
    assert missing == set(MISSING[sub]), sorted(missing ^ set(MISSING[sub]))
    assert set(MISSING[sub].values()) <= set(ITEMS)


def test_every_listed_item_is_unported():
    # the wrappers (A11b), text (A13), the rest of detection (A12), image
    # (A14), audio (A15), the sketches (A16), sharded state (A17b),
    # checkpoint (A18), tenancy (A19a), serve and cluster (A19b) are ported:
    # none of their names may be missing
    for sub, names in MISSING.items():
        assert not {"A11b", "A12", "A13", "A14", "A15", "A16", "A17b", "A18", "A19"} & set(names.values()), sub
    for name in ("BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper",
                 "BLEUScore", "SacreBLEUScore", "CHRFScore", "TranslationEditRate", "ExtendedEditDistance",
                 "CharErrorRate", "WordErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved",
                 "ROUGEScore", "SQuAD", "CatBuffer", "functional", "__version__",
                 "Quantile", "Median", "DistinctCount", "HeavyHitters", "sketches",
                 "FrechetInceptionDistance", "PeakSignalNoiseRatio", "image", "nets",
                 "SignalNoiseRatio", "PermutationInvariantTraining", "PerceptualEvaluationSpeechQuality", "audio",
                 "observability", "resilience", "checkpoint", "save_checkpoint", "restore_checkpoint",
                 "verify_checkpoint", "tenancy", "TenantSet", "serve"):
        assert hasattr(mt_torch, name), name


def test_the_c2_names_resolve():
    import metrics_tpu_torch.functional as functional

    assert functional.word_error_rate is mt_torch.ops.word_error_rate
    assert mt_torch.functional is functional
    assert mt_torch.core.Metric is mt_torch.Metric
    assert mt_torch.core.CatBuffer is mt_torch.CatBuffer
    assert mt_torch.utils.dim_zero_cat([torch.ones(2), torch.zeros(1)]).tolist() == [1.0, 1.0, 0.0]
    assert mt_torch.__version__ == mt_jax.__version__
    assert set(mt_torch.ops.__all__) <= set(dir(functional))


def _probs(seed, n=32, c=5):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(c), size=n).astype(np.float32)


@pytest.mark.parametrize("argmax_dim", [0, 1])
def test_to_categorical_matches_jax(argmax_dim):
    x = _probs(1)
    got = mt_torch.utils.to_categorical(torch.from_numpy(x), argmax_dim=argmax_dim)
    want = mt_jax.utils.to_categorical(jnp.asarray(x), argmax_dim=argmax_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shift,shape_b,kwargs", [
    (0.0, (32, 5), {}), (1e-7, (32, 5), {}), (1e-3, (32, 5), {}), (1e-3, (32, 5), {"atol": 1e-2}),
    (0.0, (5, 32), {}),
])
def test_allclose_matches_jax(shift, shape_b, kwargs):
    a = _probs(2)
    b = (a + shift).reshape(shape_b) if shape_b == a.shape else _probs(2).T.copy()
    got = mt_torch.utils.allclose(torch.from_numpy(a), torch.from_numpy(b), **kwargs)
    want = mt_jax.utils.data.allclose(jnp.asarray(a), jnp.asarray(b), **kwargs)
    assert got is want


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce_matches_jax(reduction):
    x = _probs(3)
    got = mt_torch.parallel.reduce(torch.from_numpy(x), reduction)
    want = mt_jax.parallel.reduce(jnp.asarray(x), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_matches_jax(class_reduction):
    rng = np.random.default_rng(4)
    num = rng.integers(0, 10, 7).astype(np.float32)
    denom = rng.integers(0, 12, 7).astype(np.float32)  # zeros give NaN fractions, set to 0
    weights = rng.integers(1, 5, 7).astype(np.float32)
    got = mt_torch.parallel.class_reduce(*map(torch.from_numpy, (num, denom, weights)), class_reduction=class_reduction)
    want = mt_jax.parallel.class_reduce(*map(jnp.asarray, (num, denom, weights)), class_reduction=class_reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_reduce_and_class_reduce_refuse_unknown_reductions():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="Reduction parameter unknown"):
        mt_torch.parallel.reduce(x, "max")
    with pytest.raises(ValueError, match="Reduction parameter max unknown"):
        mt_torch.parallel.class_reduce(x, x, x, "max")


class _Sum(mt_torch.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


class _Decay(_Sum):
    """An update that reads the state: merging batch states by their sum is
    not what it computes, so the partial-state path differs."""

    def update(self, x):
        self.total = 0.5 * self.total + x.sum()


def test_check_forward_full_state_property():
    inputs = {"x": torch.arange(4, dtype=torch.float32)}
    small = dict(num_update_to_compare=(2, 3), reps=1)
    assert isinstance(mt_torch.utils.check_forward_full_state_property(_Sum, input_args=inputs, **small), bool)
    assert mt_torch.utils.check_forward_full_state_property(_Decay, input_args=inputs, **small) is False
