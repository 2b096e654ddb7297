"""The port's entry points against ``__graft_entry__``, on the CPU.

``entry()``: the same collection step on the same seeded rows; states are
bitwise, results within rtol 1e-6.

``dryrun_multichip(4, device="cpu")`` runs in a 2 x 2 gloo world (data x
model, ``tests/helpers/torch_dist.py``, with its watchdog) and is held
against a single-process oracle on the full batch: the collection states
and the sequence accuracy bitwise, the AP equal to one
``BinnedAveragePrecision`` on the full batch, the loss and the updated
weight within 1e-6 of one SGD step on the full batch's mean loss, its
gradient from ``jax.grad`` on one device.

Two tests pin what the JAX dry-run does, so that the port's choices stay
visible: its gradient is ``tp`` times the gradient of its loss, and its
threshold split over ``model`` never applies at its shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import __graft_entry__
import metrics_tpu as mt_jax
import metrics_tpu_torch as mt_torch
from metrics_tpu_torch.utils.data import linspace_thresholds
from metrics_tpu_torch.entry import LR, N_THRESHOLDS, NUM_CLASSES, dryrun_inputs, dryrun_multichip, entry
from tests.helpers import torch_dist as td
from tests.helpers.torch_port import assert_bitwise, assert_close

try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(4, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_entry_matches_the_jax_entry():
    jax_fn, jax_args = __graft_entry__.entry()
    jax_states, jax_results = _np(jax.jit(jax_fn)(*jax_args))
    fn, args = entry(device="cpu")
    assert_bitwise(args[1], jax_args[1], msg="logits")
    assert_bitwise(args[2], jax_args[2], msg="target")
    states, results = fn(*args)
    assert set(states) == set(jax_states)
    for leader, state in jax_states.items():
        for name, value in state.items():
            assert_bitwise(states[leader][name], value, msg=f"{leader}.{name}")
    assert set(results) == set(jax_results)
    for key, value in jax_results.items():
        assert_close(results[key], value, msg=key)


def test_entry_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, lambda: dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_dryrun_on_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        dryrun_multichip(4, device="cuda:0")


def _oracle(n_devices):
    """The dry-run's legs in one process on the full batch."""
    inp = dryrun_inputs(n_devices)
    x, y, w = (torch.from_numpy(inp[k]) for k in ("x", "y", "w"))
    logits = x @ w
    coll = td.make_collection(NUM_CLASSES)
    coll.update(logits, y)
    binned = mt_torch.BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=linspace_thresholds(inp["n_th_pad"]), device="cpu")
    binned.update(torch.softmax(logits, dim=-1), y)
    seq = mt_torch.Accuracy(num_classes=NUM_CLASSES, average="micro", mdmc_average="global", device="cpu")
    seq.update(torch.from_numpy(inp["tok_logits"]), torch.from_numpy(inp["y_tok"]))

    def loss_fn(w_full):
        logp = jax.nn.log_softmax(jnp.asarray(inp["x"]) @ w_full, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(inp["y"])[:, None], axis=1))

    loss, grads = jax.value_and_grad(loss_fn)(jnp.asarray(inp["w"]))
    return dict(
        states={k: td.to_numpy(m.get_state()) for k, m in coll.items(keep_base=True)},
        results=td.to_numpy(coll.compute()),
        binned=td.to_numpy(binned.get_state()),
        ap=np.stack(td.to_numpy(binned.compute())),
        seq_acc=td.to_numpy(seq.compute()),
        loss=np.asarray(loss),
        w_new=np.asarray(jnp.asarray(inp["w"]) - LR * grads),
    )


def _assert_matches_oracle(out, want):
    for leader, state in out["states"].items():
        for name, value in state.items():
            assert_bitwise(value, want["states"][leader][name], msg=f"{leader}.{name}")
    for key, value in want["results"].items():
        assert_bitwise(out["results"][key], value, msg=key)
    for name, value in want["binned"].items():
        assert_bitwise(out["binned_state"][name], value, msg=name)
    assert_bitwise(out["ap"], want["ap"], msg="ap")
    assert_bitwise(out["seq_acc"], want["seq_acc"], msg="seq_acc")
    assert_close(out["loss"], want["loss"], rtol=1e-6, atol=1e-6, msg="loss")
    assert_close(out["w_new"], want["w_new"], rtol=1e-6, atol=1e-6, msg="w_new")


def test_dryrun_in_a_2x2_gloo_world_matches_the_oracle(world):
    reports = world.run_all(td.dryrun, 4)
    want = _oracle(4)
    for rank, out in enumerate(reports):
        _assert_matches_oracle(out, want)
        for key in ("loss", "w_new", "ap", "seq_acc"):
            assert_bitwise(out[key], reports[0][key], msg=f"rank {rank} {key}")


def test_dryrun_makes_its_own_world():
    """One rank in this process; four spawned gloo ranks (rank 0's outputs)."""
    _assert_matches_oracle(td.to_numpy(dryrun_multichip(1, device="cpu")), _oracle(1))
    _assert_matches_oracle(td.to_numpy(dryrun_multichip(4, device="cpu")), _oracle(4))
    assert not torch.distributed.is_initialized()


def test_the_jax_dryrun_gradient_is_tp_times_its_loss_gradient():
    """The JAX dry-run's loss/grad step, rebuilt here on a 2 x 2 CPU mesh, gives
    ``tp`` times ``jax.grad`` of the same mean loss on one device."""
    inp = dryrun_inputs(4)
    dp, tp = inp["dp"], inp["tp"]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(dp, tp), ("data", "model"))

    def step(x_local, y_local, w_local):
        def loss_fn(w_shard):
            full = jax.lax.all_gather(x_local @ w_shard, "model", axis=1, tiled=True)
            logp = jax.nn.log_softmax(full, axis=-1)
            return -jnp.mean(jnp.take_along_axis(logp, y_local[:, None], axis=1))

        return jax.lax.pmean(jax.grad(loss_fn)(w_local), "data")

    kwargs = dict(mesh=mesh, in_specs=(P("data", None), P("data"), P(None, "model")), out_specs=P(None, "model"))
    try:
        smapped = shard_map(step, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover - pre-0.8 jax spells the flag check_rep
        smapped = shard_map(step, check_rep=False, **kwargs)
    grads = np.asarray(jax.jit(smapped)(jnp.asarray(inp["x"]), jnp.asarray(inp["y"]), jnp.asarray(inp["w"])))
    want = (np.asarray(inp["w"]) - _oracle(4)["w_new"]) / LR
    assert tp == 2
    np.testing.assert_allclose(grads, tp * want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_the_jax_dryrun_threshold_split_never_applies(n_devices):
    """The binned states are (num_classes, T): neither the slice (first axis
    == n_th_pad) nor the gather (first axis == n_th_pad // tp) fires."""
    inp = dryrun_inputs(n_devices)
    n_th_pad, tp = inp["n_th_pad"], inp["tp"]
    assert n_th_pad == ((N_THRESHOLDS + tp - 1) // tp) * tp
    jax_state = mt_jax.BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=jnp.linspace(0.0, 1.0, n_th_pad)).init_state()
    port_state = mt_torch.BinnedAveragePrecision(
        num_classes=NUM_CLASSES, thresholds=linspace_thresholds(n_th_pad), device="cpu"
    ).init_state()
    for state in (jax_state, port_state):
        for value in state.values():
            assert tuple(value.shape) == (NUM_CLASSES, n_th_pad)
            assert value.shape[0] not in (n_th_pad, n_th_pad // tp)
