"""The port's InceptionV3 against the JAX package's on the CPU (LPIPS:
``tests/test_torch_image_lpips.py``).

- Seeded torch weights (``tests/helpers/torch_nets.py``) go to JAX through
  the JAX package's own loader; ONE jitted JAX forward with all six taps on
  2 images is held against the port's forward on the same weights, each tap
  within rtol 1e-3 and atol 1e-3 x the tap's largest value (the JAX
  package's own torch-against-flax bound,
  ``tests/image/test_generative.py:387-388``); the TF1 resize bit for bit.
- ``convert.inception_state_dict_from_jax`` round-trips those JAX variables
  bit for bit, after a check that they have the tree, shapes and dtypes of
  the JAX net's own ``module.init`` (``jax.eval_shape``: compiling the
  init's 472 random draws takes about 15 s on the CPU, and a round trip of
  a renaming and transposing converter does not depend on the values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu.nets import inception as jinc
from metrics_tpu_torch import convert
from metrics_tpu_torch.nets import inception as tinc
from metrics_tpu_torch.nets import lpips as tlp
from tests.helpers.torch_nets import (
    TorchFIDInception,
    randomize_inception_,
)
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]

TAPS = jinc.VALID_FEATURES


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --------------------------------------------------------------------------- #
# InceptionV3
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def inception():
    net = TorchFIDInception()
    randomize_inception_(net, seed=3)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    imgs = np.random.default_rng(0).integers(0, 256, (2, 3, 40, 40)).astype(np.uint8)
    variables = jinc.load_inception_torch_state_dict({k: v.numpy() for k, v in state.items()}, features_list=TAPS)
    variables = jax.tree.map(np.asarray, variables)
    module = jinc.InceptionV3(features_list=TAPS)

    @jax.jit
    def forward(v, x):
        x = jnp.transpose(x.astype(jnp.float32), (0, 2, 3, 1))
        x = (jinc._resize_bilinear_tf1(x, 299, 299) - 128.0) / 128.0
        return module.apply(v, x)

    taps = {k: np.asarray(v) for k, v in forward(variables, jnp.asarray(imgs)).items()}
    return state, variables, imgs, taps


def test_inception_taps_match_jax_on_the_same_weights(inception):
    state, _, imgs, want = inception
    module = tinc.InceptionV3(features_list=TAPS)
    module.load_state_dict(tinc.load_inception_torch_state_dict(state))
    x = (tinc.resize_bilinear_tf1(torch.from_numpy(imgs).to(torch.float32), 299, 299) - 128.0) / 128.0
    with torch.no_grad():
        got = module.eval()(x)
    assert set(got) == set(TAPS)
    for tap in TAPS:
        w = want[tap]
        assert got[tap].shape == w.shape and got[tap].dtype == torch.float32, tap
        assert_close(got[tap].numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max(), msg=f"tap {tap}")
    # the extractor (uint8 in, one tap out) is the module's forward
    for tap in ("64", "logits_unbiased"):
        ext = tinc.InceptionV3FeatureExtractor(tap, variables=state, device="cpu")
        assert ext.num_features == got[tap].shape[1]
        assert_bitwise(ext(torch.from_numpy(imgs)), got[tap].numpy(), tap)


def test_inception_converter_round_trips_jax_variables_bitwise(inception):
    state, variables, _, _ = inception
    init = jax.eval_shape(jinc.InceptionV3(features_list=TAPS).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 75, 75, 3), jnp.float32))
    want = dict(_leaves(variables))
    layout = {path: (tuple(leaf.shape), np.dtype(leaf.dtype)) for path, leaf in _leaves(init)}
    assert {path: (leaf.shape, leaf.dtype) for path, leaf in want.items()} == layout
    converted = convert.inception_state_dict_from_jax(variables)
    port = tinc.InceptionV3(features_list=TAPS)
    port.load_state_dict(converted)  # loads as it is
    for key, value in state.items():  # the torch weights the JAX loader was given, back
        assert_bitwise(converted[key], value.numpy(), key)
    back = jinc.load_inception_torch_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, TAPS)
    got = dict(_leaves(back))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for path in want:
        assert_bitwise(np.asarray(got[path]), want[path], "/".join(path))


def test_inception_early_return_stops_at_the_last_tap():
    module = tinc.InceptionV3(features_list=("64",))
    calls = []
    module.Conv2d_3b_1x1.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        out = module(torch.zeros(1, 3, 80, 80))
    assert set(out) == {"64"} and not calls


def test_tf1_resize_matches_jax_bitwise():
    # the function as written, run op by op (jitted, XLA may fuse the lerps into FMAs)
    x = np.random.default_rng(1).random((2, 3, 17, 29)).astype(np.float32) * 255
    for out_h, out_w in ((299, 299), (8, 40)):
        got = tinc.resize_bilinear_tf1(torch.from_numpy(x), out_h, out_w)
        want = jinc._resize_bilinear_tf1(jnp.transpose(jnp.asarray(x), (0, 2, 3, 1)), out_h, out_w)
        assert_bitwise(got, np.transpose(np.asarray(want), (0, 3, 1, 2)))


def test_inception_loader_checks_keys_and_shapes():
    net = TorchFIDInception()
    state = net.state_dict()
    loaded = tinc.load_inception_torch_state_dict({k: v for k, v in state.items() if "num_batches" not in k})
    assert int(loaded["Mixed_5b.branch1x1.bn.num_batches_tracked"]) == 0
    without_fc = tinc.load_inception_torch_state_dict({k: v for k, v in state.items() if not k.startswith("fc.")})
    assert without_fc["fc.weight"].shape == (1008, 2048)
    with pytest.raises(KeyError, match="does not have"):
        tinc.load_inception_torch_state_dict({**state, "Mixed_9z.conv.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="missing"):
        tinc.load_inception_torch_state_dict({k: v for k, v in state.items() if "Mixed_7c.branch_pool.conv" not in k})
    with pytest.raises(ValueError, match="expected shape"):
        tinc.load_inception_torch_state_dict({**state, "fc.bias": torch.zeros(1000)})


def test_seeded_nets_are_deterministic_and_warn_at_the_metric():
    a = tinc.InceptionV3FeatureExtractor("64", device="cpu")
    b = tinc.InceptionV3FeatureExtractor("64", device="cpu")
    for (k, va), vb in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(va, vb), k
    with pytest.warns(UserWarning, match="randomly initialized InceptionV3"):
        metric = mt.FrechetInceptionDistance(feature=64, device="cpu")
    assert metric.inception.num_features == 64


@pytest.mark.parametrize("build", [
    lambda **kw: tinc.InceptionV3FeatureExtractor("64", **kw),
    lambda **kw: tlp.LPIPSNet("squeeze", **kw),
], ids=["inception", "lpips"])
def test_nets_default_to_cuda_and_never_fall_back(build, monkeypatch):
    if torch.cuda.is_available():
        assert next(build().module.parameters()).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    assert next(build(device="cpu").module.parameters()).device.type == "cpu"
