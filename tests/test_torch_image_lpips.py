"""The port's LPIPS net (alex, vgg, squeeze) against the JAX package's on
the CPU, and its weight converter in both directions.

- The port against JAX on the same weights at 64 x 64 within rtol 1e-4 and
  atol 1e-5 (the JAX package's bound against its torch oracle,
  ``tests/image/test_generative.py:435``): seeded torch trunks and heads
  (``tests/helpers/torch_nets.py``) through the JAX package's loader for
  alex and vgg, seeded values in the JAX net's own variable tree for
  squeeze (which the torch helper does not build).
  ``compute_dtype=torch.bfloat16`` within 2e-2 relative of float32
  (``:316``).
- ``convert.lpips_state_dict_from_jax`` round-trips those JAX variables bit
  for bit: JAX -> the port's state dict -> the port's module -> the JAX
  package's loader -> the same variables. Each tree is first checked to
  have the tree, shapes and dtypes of the JAX net's own ``module.init``
  (``jax.eval_shape``: compiling the init's random draws costs seconds a
  net, and a round trip of a renaming and transposing converter does not
  depend on the values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu.nets import lpips as jlp
from metrics_tpu_torch import convert
from metrics_tpu_torch.nets import lpips as tlp
from tests.helpers.torch_nets import (
    make_lpips_backbone_state_dict,
    make_lpips_lin_state_dict,
)
from tests.helpers.torch_port import assert_bitwise, assert_close, one_torch_thread

pytestmark = [pytest.mark.filterwarnings("ignore"), pytest.mark.usefixtures("one_torch_thread")]


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _same_tree(got, want):
    g, w = {p: np.asarray(v) for p, v in _leaves(got)}, {p: np.asarray(v) for p, v in _leaves(want)}
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:8]
    for path in w:
        assert_bitwise(g[path], w[path], "/".join(path))


# --------------------------------------------------------------------------- #
# LPIPS
# --------------------------------------------------------------------------- #
def _init_shapes(net_type):
    """The JAX net's ``module.init`` variables as shapes and dtypes, traced
    by ``jax.eval_shape`` without compiling the init."""
    dummy = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(jlp.LPIPS(net_type=net_type).init, jax.random.PRNGKey(0), dummy, dummy)


def _layout(tree):
    return {path: (tuple(leaf.shape), np.dtype(leaf.dtype)) for path, leaf in _leaves(tree)}


def _jax_lpips_variables(net_type):
    """Seeded torch trunk and heads through the JAX loader (alex, vgg), or
    seeded values in the init's tree (squeeze, which the torch helper does
    not build): kernels He-normal, biases normal(0, 0.1), heads uniform in
    [0, 1) as lpips's non-negative heads."""
    if net_type == "squeeze":
        rng = np.random.default_rng(6)

        def fill(path, leaf):
            name = path[-1].key
            if name == "kernel":
                value = rng.standard_normal(leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            else:
                value = rng.standard_normal(leaf.shape) * 0.1 if name == "bias" else rng.random(leaf.shape)
            return value.astype(leaf.dtype)

        return jax.tree_util.tree_map_with_path(fill, _init_shapes(net_type))
    backbone = make_lpips_backbone_state_dict(net_type, seed=5)
    lin = make_lpips_lin_state_dict(jlp.NET_CHANNELS[net_type], seed=6)
    return jax.tree.map(np.asarray, jlp.load_lpips_torch_state_dict(backbone, lin, net_type))


def _round_trip(variables, net_type):
    """JAX variables -> the port's state dict -> the port's module -> the JAX
    package's own loader: the same variables, bit for bit."""
    port = tlp.LPIPS(net_type)
    port.load_state_dict(convert.lpips_state_dict_from_jax(variables, net_type))  # loads as it is
    backbone = {k[len("net."):]: v.numpy() for k, v in port.state_dict().items() if k.startswith("net.")}
    lin = {k: v.numpy() for k, v in port.state_dict().items() if k.startswith("lin")}
    _same_tree(jax.tree.map(np.asarray, jlp.load_lpips_torch_state_dict(backbone, lin, net_type)), variables)


def _pairs(seed, n=3, size=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax_and_converters_round_trip(net_type):
    variables = _jax_lpips_variables(net_type)
    assert _layout(variables) == _layout(_init_shapes(net_type))
    _round_trip(variables, net_type)
    state = convert.lpips_state_dict_from_jax(variables, net_type)
    a, b = _pairs(7)
    want = np.asarray(jlp.LPIPSNet(net_type, variables=jax.tree.map(jnp.asarray, variables))(jnp.asarray(a), jnp.asarray(b)))
    net = tlp.LPIPSNet(net_type, variables=state, device="cpu")
    got = net(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3,) and got.dtype == torch.float32
    assert_close(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # bfloat16 trunk: opt-in, within 2e-2 relative
    half = tlp.LPIPSNet(net_type, variables=state, compute_dtype=torch.bfloat16, device="cpu")
    assert_close(half(torch.from_numpy(a), torch.from_numpy(b)).numpy(), got.numpy(), rtol=2e-2, atol=0)


def test_lpips_metric_warns_without_weights():
    with pytest.warns(UserWarning, match="randomly initialized"):
        mt.LearnedPerceptualImagePatchSimilarity(net_type="squeeze", device="cpu")


def test_lpips_torch_checkpoints_load_as_they_are():
    backbone = make_lpips_backbone_state_dict("alex", seed=1)
    lin = make_lpips_lin_state_dict(tlp.NET_CHANNELS["alex"], seed=2)
    state = tlp.load_lpips_torch_state_dict(backbone, lin, "alex")
    assert torch.equal(state["net.features.3.weight"], backbone["features.3.weight"])
    with pytest.raises(KeyError, match="keys differ"):
        tlp.load_lpips_torch_state_dict(backbone, {}, "alex")
    with pytest.raises(ValueError, match="net_type"):
        tlp.LPIPSNet("resnet", device="cpu")


def test_lpips_metric_over_the_port_net_pads_and_matches_the_net():
    state = convert.lpips_state_dict_from_jax(_jax_lpips_variables("alex"), "alex")
    metric = mt.LearnedPerceptualImagePatchSimilarity(variables=state, device="cpu", compiled_update=False)
    net = tlp.LPIPSNet("alex", variables=state, device="cpu")
    a, b = _pairs(8, n=5, size=48)  # 5 pairs: bucketed to 8
    metric.update(torch.from_numpy(a), torch.from_numpy(b))
    want = net(torch.from_numpy(a), torch.from_numpy(b))
    assert_close(metric.compute().numpy(), want.mean().numpy(), rtol=1e-6, atol=0)
