"""The port's checkpoint package against the JAX package's.

Ports the cases of ``tests/core/test_checkpoint.py``, ``_faults.py``,
``_reshard.py`` and ``tests/resilience/test_storage.py`` to
``metrics_tpu_torch.checkpoint``, with the checkpoint cases of the sharded
state tests (``tests/core/test_sharded_state.py:311``, ``:334``, ``:343``;
``tests/core/test_multi_axis_sharding.py:209``, ``:231``) in one gloo world
of 4 CPU ranks (rank bodies in ``tests/helpers/torch_tenancy.py``). Then the
cross-package gate: a snapshot written by either package restores in the
other, bitwise for integer leaves and within the JAX package's stated bound
(``tests/helpers/torch_parity.py``'s RTOL/ATOL) elsewhere, with manifests
that agree apart from the payload checksums and sizes; and the fingerprint
of every ``INVENTORY`` entry equal in both packages. The JAX references run
with their engines off (``compiled_update=False, compiled_compute=False``)
where the engines are not under test.
"""
from __future__ import annotations

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as M
import metrics_tpu_torch as mt
from metrics_tpu import checkpoint as jck
from metrics_tpu.checkpoint import io as jio
from metrics_tpu.checkpoint.format import object_fingerprint as jax_fingerprint
from metrics_tpu_torch import checkpoint as ck
from metrics_tpu_torch.checkpoint import io as ckio
from metrics_tpu_torch.checkpoint.__main__ import main as ckpt_cli
from metrics_tpu_torch.checkpoint.format import (
    build_shard,
    fingerprint_diff,
    metric_fingerprint,
    metric_leaves,
    object_fingerprint,
)
from metrics_tpu_torch.resilience import ChaosError, FaultSpec, RetryPolicy, chaos
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.helpers import torch_dist as td
from tests.helpers import torch_shard as tsh
from tests.helpers import torch_tenancy as tt
from tests.helpers.torch_parity import RTOL, ATOL, reference, twin
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)
from tests.helpers.torch_twins import TWINS

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

CPU = dict(device="cpu")
JAX_EAGER = dict(compiled_update=False, compiled_compute=False)
FAST = RetryPolicy(backoff_base_s=0.0, backoff_max_s=0.0, jitter=0.0, seed=0)
N = 8  # ranks that wrote a resharded checkpoint
WORLD = 4


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0, 1, (n,)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (n,)).astype(np.int32)))


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
        return
    assert_bitwise(a, b)


def _collection(**kw):
    return mt.MetricCollection([mt.Accuracy(**CPU, **kw), mt.F1Score(**CPU, **kw), mt.Precision(**CPU, **kw),
                                mt.Recall(**CPU, **kw)])


# --------------------------------------------------------------- roundtrips --
def test_metric_roundtrip_with_aux(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=1))
    m.update(*_batch(seed=2))
    ref = m.compute()
    handle = ck.save_checkpoint(m, str(tmp_path))
    assert handle.committed and handle.done
    fresh = mt.Accuracy(**CPU)
    info = ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    assert info.world_size == 1 and info.shards_loaded == (0,)
    assert fresh.mode == m.mode and fresh._update_count == m._update_count
    _equal(ref, fresh.compute())


def test_collection_roundtrip(tmp_path):
    coll = _collection()
    for seed in (3, 4):
        coll.update(*_batch(seed=seed))
    ref = coll.compute()
    ck.save_checkpoint(coll, str(tmp_path))
    fresh = _collection()
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    _equal(ref, fresh.compute())


def test_catbuffer_roundtrip_grows_capacity(tmp_path):
    m = mt.AUROC(buffer_capacity=64, **CPU)
    m.update(*_batch(seed=5))
    ck.save_checkpoint(m, str(tmp_path))
    small = mt.AUROC(buffer_capacity=64, **CPU)
    ck.restore_checkpoint(small, str(tmp_path), host_index=0, host_count=1)
    _equal(m.compute(), small.compute())


def test_list_state_roundtrip(tmp_path):
    m = mt.CatMetric(**CPU)
    m.update(torch.tensor([1.0, 2.0]))
    m.update(torch.tensor([3.0]))
    ck.save_checkpoint(m, str(tmp_path))
    fresh = mt.CatMetric(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    assert fresh.compute().tolist() == [1.0, 2.0, 3.0]


def test_multiple_steps_latest_wins(tmp_path):
    m = mt.MeanMetric(**CPU)
    m.update(torch.tensor(1.0))
    ck.save_checkpoint(m, str(tmp_path))
    m.update(torch.tensor(5.0))
    ck.save_checkpoint(m, str(tmp_path))
    assert len(ck.available_steps(str(tmp_path))) == 2
    fresh = mt.MeanMetric(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    assert float(fresh.compute()) == 3.0
    first = mt.MeanMetric(**CPU)
    ck.restore_checkpoint(first, str(tmp_path), step=ck.available_steps(str(tmp_path))[0], host_index=0, host_count=1)
    assert float(first.compute()) == 1.0


def test_restore_missing_raises(tmp_path):
    with pytest.raises(ck.CheckpointNotFoundError):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path / "nope"), host_index=0, host_count=1)


def test_restore_puts_leaves_on_the_live_metrics_device(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=30))
    ck.save_checkpoint(m, str(tmp_path))
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path))
    assert all(v.device == fresh.device for v in fresh.get_state().values())


# --------------------------------------------------------------- async save --
def test_async_save_commits(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=6))
    ref = m.compute()
    handle = ck.save_checkpoint(m, str(tmp_path), blocking=False)
    handle.wait()
    assert handle.committed
    m.update(*_batch(seed=7))
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    _equal(ref, fresh.compute())


def test_async_save_error_surfaces_on_wait(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the checkpoint root should go")
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=8))
    handle = ck.save_checkpoint(m, str(target), blocking=False)
    with pytest.raises(Exception):
        handle.wait()


def test_overlap_copy_save_commits_and_times_both_phases(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=20))
    ref = m.compute()
    handle = ck.save_checkpoint(m, str(tmp_path), blocking=False, overlap_copy=True)
    m.update(*_batch(seed=21))  # writes the state while the save drains
    handle.wait()
    assert handle.committed
    assert handle.timings["copy_enqueue_s"] >= 0.0 and handle.timings["host_copy_s"] >= 0.0
    assert {"snapshot_s", "write_s", "commit_s", "total_s"} <= set(handle.timings)
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    _equal(ref, fresh.compute())


def test_overlap_copy_requires_async(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=22))
    with pytest.raises(ValueError, match="overlap_copy"):
        ck.save_checkpoint(m, str(tmp_path), blocking=True, overlap_copy=True)


def test_overlap_copy_survives_in_place_updates_of_captured_steps(tmp_path):
    """The engines write the state tensors in place from the third call on:
    the overlapped save holds copies, not the live tensors."""
    m = mt.Accuracy(**CPU)
    for seed in range(4):  # eager, probe, then steady in-place steps
        m.update(*_batch(seed=40 + seed))
    snapshot = {k: v.clone() for k, v in m.get_state().items()}
    handle = ck.save_checkpoint(m, str(tmp_path), blocking=False, overlap_copy=True)
    for seed in range(3):
        m.update(*_batch(seed=50 + seed))
    handle.wait()
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path))
    _equal(fresh.get_state(), snapshot)


# ---------------------------------------------------- engine/streak interop --
def test_save_during_fused_streak_realizes_members(tmp_path):
    coll = mt.MetricCollection([mt.Precision(**CPU), mt.Recall(**CPU)])
    for seed in (9, 10, 11):
        coll.update(*_batch(seed=seed))
    ck.save_checkpoint(coll, str(tmp_path))
    ref = coll.compute()
    fresh = mt.MetricCollection([mt.Precision(**CPU), mt.Recall(**CPU)])
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    _equal(ref, fresh.compute())
    # the group's members share their leader's restored tensors again
    leader, member = (fresh[k] for k in fresh.keys(keep_base=True))
    assert all(leader.get_state()[k] is member.get_state()[k] for k in leader._defaults)


def test_restore_invalidates_compute_memo(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=11))
    ck.save_checkpoint(m, str(tmp_path))
    m.update(*_batch(seed=12))
    stale = m.compute()
    ck.restore_checkpoint(m, str(tmp_path), host_index=0, host_count=1)
    restored = m.compute()
    assert m._update_count == 1
    assert not torch.allclose(stale, restored)


def test_restore_into_captured_engine_replays_the_restored_state(tmp_path):
    """A metric whose update is a steady captured step restores and goes on
    from the restored state, as an uninterrupted run does."""
    src, ref = mt.Accuracy(**CPU), mt.Accuracy(**CPU)
    for seed in range(3):
        src.update(*_batch(seed=60 + seed))
        ref.update(*_batch(seed=60 + seed))
    ck.save_checkpoint(src, str(tmp_path))
    live = mt.Accuracy(**CPU)
    for seed in range(5):
        live.update(*_batch(seed=70 + seed))  # warm its engine on other data
    ck.restore_checkpoint(live, str(tmp_path))
    for seed in range(3):
        live.update(*_batch(seed=80 + seed))
        ref.update(*_batch(seed=80 + seed))
    _equal(live.get_state(), ref.get_state())
    assert live._update_engine.stats.cache_hits > 0


def test_load_state_dict_clears_compute_memo():
    m = mt.MeanMetric(**CPU)
    m.persistent(True)
    m.update(torch.tensor(2.0))
    sd = m.state_dict()
    m.update(torch.tensor(10.0))
    assert float(m.compute()) == 6.0
    m.load_state_dict(sd)
    assert float(m.compute()) == 2.0


# ------------------------------------------------------------------ refusals --
def test_mismatch_refused_with_diff(tmp_path):
    m = mt.AUROC(buffer_capacity=64, **CPU)
    m.update(*_batch(seed=13))
    ck.save_checkpoint(m, str(tmp_path))
    with pytest.raises(ck.CheckpointMismatchError, match="class"):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)


def test_aux_num_classes_roundtrip(tmp_path):
    m = mt.ROC(buffer_capacity=64, **CPU)
    m.update(*_batch(seed=14))
    assert m.num_classes is not None
    ck.save_checkpoint(m, str(tmp_path))
    fresh = mt.ROC(buffer_capacity=64, **CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    assert fresh.num_classes == m.num_classes and fresh.pos_label == m.pos_label
    _equal(m.compute(), fresh.compute())


# ----------------------------------------------------------------------- CLI --
def test_cli_inspect_verify(tmp_path, capsys):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=15))
    ck.save_checkpoint(m, str(tmp_path))
    assert ckpt_cli(["inspect", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Accuracy" in out and "world_size" in out
    assert ckpt_cli(["verify", str(tmp_path)]) == 0
    assert ckpt_cli(["verify", str(tmp_path), "--all"]) == 0


def test_cli_verify_fails_on_corruption(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=16))
    ck.save_checkpoint(m, str(tmp_path))
    step_dir = ckio.step_dir(str(tmp_path), ck.latest_step(str(tmp_path)))
    npz = next(f for f in os.listdir(step_dir) if f.endswith(".npz"))
    with open(os.path.join(step_dir, npz), "r+b") as f:
        f.write(b"\x00" * 16)
    assert ckpt_cli(["verify", str(tmp_path)]) != 0
    report = ck.verify_checkpoint(str(tmp_path))
    assert not report.ok and report.issues


def test_cli_merge_and_clean(tmp_path, capsys):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=17))
    ck.save_checkpoint(m, str(tmp_path / "in"))
    assert ckpt_cli(["merge", str(tmp_path / "in"), str(tmp_path / "out")]) == 0
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path / "out"), host_index=0, host_count=1)
    _equal(m.compute(), fresh.compute())
    os.makedirs(ckio.pending_dir(str(tmp_path / "in"), 7))
    assert ckpt_cli(["clean", str(tmp_path / "in"), "--dry-run"]) == 0
    assert os.path.exists(ckio.pending_dir(str(tmp_path / "in"), 7))
    assert ckpt_cli(["clean", str(tmp_path / "in")]) == 0
    assert not os.path.exists(ckio.pending_dir(str(tmp_path / "in"), 7))
    assert "1 pending dir(s) reaped" in capsys.readouterr().out


# -------------------------------------------------------------------- faults --
def _committed_accuracy(root, seed=1):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=seed))
    ck.save_checkpoint(m, str(root))
    return m


def _npz_path(root):
    step_dir = ckio.step_dir(str(root), ck.latest_step(str(root)))
    return step_dir, os.path.join(step_dir, next(f for f in os.listdir(step_dir) if f.endswith(".npz")))


def test_kill_before_commit_leaves_old_snapshot_intact(tmp_path):
    m = _committed_accuracy(tmp_path, seed=1)
    ref = m.compute()
    m.update(*_batch(seed=2))
    payload, shard_meta = build_shard(m)
    step2 = ckio.next_step(str(tmp_path))
    pending = ckio.pending_dir(str(tmp_path), step2)
    ckio.write_shard(pending, 0, 2, {k: v.numpy() for k, v in payload.items()}, shard_meta)
    assert not ckio.try_commit(str(tmp_path), step2, 2)
    assert ck.available_steps(str(tmp_path)) == [0]
    fresh = mt.Accuracy(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path), host_index=0, host_count=1)
    _equal(ref, fresh.compute())
    removed = ck.clean_pending(str(tmp_path))
    assert removed and not os.path.exists(pending)


def test_commit_requires_every_shard(tmp_path):
    m = mt.Accuracy(**CPU)
    m.update(*_batch(seed=3))
    payload, shard_meta = build_shard(m)
    payload = {k: v.numpy() for k, v in payload.items()}
    pending = ckio.pending_dir(str(tmp_path), 0)
    ckio.write_shard(pending, 0, 2, payload, shard_meta)
    assert not ckio.try_commit(str(tmp_path), 0, 2)
    ckio.write_shard(pending, 1, 2, payload, shard_meta)
    assert ckio.try_commit(str(tmp_path), 0, 2)
    assert ck.available_steps(str(tmp_path)) == [0]


def test_uncommitted_dir_is_invisible(tmp_path):
    os.makedirs(tmp_path / "step_0000000000")
    assert ck.available_steps(str(tmp_path)) == []
    with pytest.raises(ck.CheckpointNotFoundError):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)


def test_truncated_shard_raises_corrupt(tmp_path):
    _committed_accuracy(tmp_path, seed=4)
    _, path = _npz_path(tmp_path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(ck.CheckpointCorruptError, match="size|sha|bytes"):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)
    assert not ck.verify_checkpoint(str(tmp_path)).ok


def test_bitflipped_shard_raises_corrupt(tmp_path):
    _committed_accuracy(tmp_path, seed=5)
    _, path = _npz_path(tmp_path)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ck.CheckpointCorruptError, match="checksum"):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)


def test_tampered_manifest_raises(tmp_path):
    _committed_accuracy(tmp_path, seed=6)
    step_dir, _ = _npz_path(tmp_path)
    mpath = os.path.join(step_dir, "MANIFEST.json")
    manifest = json.load(open(mpath))
    manifest["world_size"] = 99
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ck.CheckpointCorruptError, match="MANIFEST"):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)


def test_future_format_version_refused(tmp_path):
    _committed_accuracy(tmp_path, seed=7)
    step_dir, _ = _npz_path(tmp_path)
    cpath = os.path.join(step_dir, "COMMIT")
    commit = json.load(open(cpath))
    commit["format_version"] = 999
    json.dump(commit, open(cpath, "w"))
    with pytest.raises(ck.CheckpointMismatchError, match="format version"):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1)


def test_wrong_class_refused_before_state_touched(tmp_path):
    _committed_accuracy(tmp_path, seed=8)
    other = mt.MeanMetric(**CPU)
    other.update(torch.tensor(41.0))
    with pytest.raises(ck.CheckpointMismatchError, match="class"):
        ck.restore_checkpoint(other, str(tmp_path), host_index=0, host_count=1)
    assert float(other.compute()) == 41.0


def test_verify_payload_checks_checksums(tmp_path):
    _committed_accuracy(tmp_path, seed=9)
    _, path = _npz_path(tmp_path)
    data = bytearray(open(path, "rb").read())
    data[len(data) - 1] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=0, host_count=1, verify_payload=True)


def test_restore_falls_back_to_an_older_verifiable_step(tmp_path):
    from metrics_tpu_torch import observability as obs

    m = _committed_accuracy(tmp_path, seed=31)
    ref = m.compute()
    m.update(*_batch(seed=32))
    ck.save_checkpoint(m, str(tmp_path))
    _, path = _npz_path(tmp_path)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    fresh = mt.Accuracy(**CPU)
    with obs.trace() as tracer:
        info = ck.restore_checkpoint(fresh, str(tmp_path))
        counts = tracer.counts_by_name()
    assert info.fallback_from == 1 and info.step == 0
    assert counts["checkpoint/restore/fallback"] == 1
    _equal(ref, fresh.compute())
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), step=1)


# ------------------------------------------------------------ storage/retry --
def _mean(value):
    m = mt.MeanMetric(**CPU)
    m.update(torch.tensor(value, dtype=torch.float32))
    return m


def test_inmemory_roundtrip():
    store = ck.InMemoryStorage()
    m = _mean(3.5)
    with ck.use_storage(store):
        ck.save_checkpoint(m, "mem/ckpt", world_size=1, shard_index=0)
        assert len(store) > 0
        fresh = mt.MeanMetric(**CPU)
        ck.restore_checkpoint(fresh, "mem/ckpt", host_count=1)
    assert float(fresh.compute()) == float(m.compute())


def test_local_storage_primitives(tmp_path):
    import hashlib

    st = ck.LocalStorage()
    d, p = str(tmp_path / "a"), str(tmp_path / "a" / "b.bin")
    st.makedirs(d)
    st.write_atomic(p, b"hello")
    assert st.read_bytes(p) == b"hello" and st.exists(p) and not st.isdir(p) and st.isdir(d)
    assert st.size(p) == 5 and st.sha256(p) == hashlib.sha256(b"hello").hexdigest()
    st.rename(p, str(tmp_path / "a" / "c.bin"))
    assert not st.exists(p) and st.listdir(d) == ["c.bin"]
    st.delete(str(tmp_path / "a" / "c.bin"))
    assert st.listdir(d) == []


def test_object_storage_emulates_directories():
    store = ck.InMemoryStorage()
    store.write_atomic("root/step_0/x.npz", b"payload")
    assert store.isdir("root") and store.isdir("root/step_0")
    assert store.listdir("root") == ["step_0"] and store.listdir("root/step_0") == ["x.npz"]
    store.rename("root/step_0", "root/step_1")
    assert store.read_bytes("root/step_1/x.npz") == b"payload" and not store.exists("root/step_0/x.npz")


@pytest.mark.parametrize("site,spec", [
    ("storage/write", FaultSpec("storage/write", every=3, times=4)),
    ("storage/read", FaultSpec("storage/read", every=2, times=4)),
])
def test_transient_faults_are_retried_to_success(site, spec):
    store = ck.InMemoryStorage()
    m = _mean(1.0 if site == "storage/write" else 2.0)
    with ck.use_storage(store), ck.use_retry_policy(FAST):
        if site == "storage/write":
            with chaos.plan([spec]) as p:
                ck.save_checkpoint(m, "mem/ckpt", world_size=1, shard_index=0)
        else:
            ck.save_checkpoint(m, "mem/ckpt", world_size=1, shard_index=0)
        fresh = mt.MeanMetric(**CPU)
        if site == "storage/read":
            with chaos.plan([spec]) as p:
                ck.restore_checkpoint(fresh, "mem/ckpt", host_count=1)
        else:
            ck.restore_checkpoint(fresh, "mem/ckpt", host_count=1)
    assert p.fired(site) >= 1
    assert float(fresh.compute()) == float(m.compute())


def test_fatal_fault_gives_up_without_retrying():
    with ck.use_storage(ck.InMemoryStorage()), ck.use_retry_policy(FAST):
        with chaos.plan([FaultSpec("storage/write", transient=False)]) as p:
            with pytest.raises(ChaosError):
                ck.save_checkpoint(_mean(1.0), "mem/ckpt", world_size=1, shard_index=0)
        assert p.fired("storage/write") == 1


def test_exhausted_retries_reraise():
    pol = RetryPolicy(max_attempts=2, backoff_base_s=0.0, backoff_max_s=0.0, jitter=0.0, seed=0)
    with ck.use_storage(ck.InMemoryStorage()), ck.use_retry_policy(pol):
        with chaos.plan([FaultSpec("storage/write", every=1)]):
            with pytest.raises(ChaosError):
                ck.save_checkpoint(_mean(1.0), "mem/ckpt", world_size=1, shard_index=0)


def test_torn_write_is_caught_as_corruption(tmp_path):
    root = str(tmp_path / "ckpt")
    with chaos.plan([FaultSpec("ckpt/write", kind="partial_write", nth=1, fraction=0.5)]):
        ck.save_checkpoint(_mean(2.0), root, world_size=1, shard_index=0)
    report = ck.verify_checkpoint(root)
    assert not report.ok
    assert any("unreadable" in issue or "checksum" in issue for issue in report.issues)


def test_commit_fault_under_call_with_retry_still_commits(tmp_path):
    from metrics_tpu_torch.resilience import call_with_retry

    m = _mean(4.0)
    specs = [FaultSpec("storage/write", every=3, times=4), FaultSpec("ckpt/commit", nth=1, times=1)]
    with ck.use_retry_policy(FAST), chaos.plan(specs, seed=0) as p:
        handle = call_with_retry(lambda: ck.save_checkpoint(m, str(tmp_path), step=0), FAST, op="save")
    assert handle.committed and p.fired("ckpt/commit") == 1 and p.fired("storage/write") >= 1
    fresh = mt.MeanMetric(**CPU)
    ck.restore_checkpoint(fresh, str(tmp_path))
    assert float(fresh.compute()) == 4.0


# ------------------------------------------------------------------- reshard --
def _host_batch(i, n=16):
    rng = np.random.default_rng(1000 + i)
    return (torch.from_numpy(rng.uniform(0, 1, (n,)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (n,)).astype(np.int32)))


def _save_world(make, root, world=N, updates_for=lambda i: 1):
    for i in range(world):
        m = make()
        for u in range(updates_for(i)):
            m.update(*_host_batch(i * 100 + u))
        ck.save_checkpoint(m, root, step=0, shard_index=i, world_size=world)


def _reference(make, world=N, updates_for=lambda i: 1):
    ref = make()
    for i in range(world):
        for u in range(updates_for(i)):
            ref.update(*_host_batch(i * 100 + u))
    return ref


def test_assign_shards_round_robin():
    assert ck.assign_shards(8, 0, 4) == (0, 4) and ck.assign_shards(8, 3, 4) == (3, 7)
    assert ck.assign_shards(8, 0, 1) == tuple(range(8)) and ck.assign_shards(2, 5, 8) == ()
    with pytest.raises(Exception):
        ck.assign_shards(8, 4, 4)


@pytest.mark.parametrize("m_hosts", [1, 4])
def test_accuracy_folds_bitwise(tmp_path, m_hosts):
    make = lambda: mt.Accuracy(**CPU)  # noqa: E731
    _save_world(make, str(tmp_path))
    ref = _reference(make)
    total_state, total_count, carrier = None, 0, make()
    for host in range(m_hosts):
        m = make()
        info = ck.restore_checkpoint(m, str(tmp_path), host_index=host, host_count=m_hosts)
        assert info.shards_loaded == ck.assign_shards(N, host, m_hosts)
        if total_state is None:
            total_state, total_count = m.get_state(), m._update_count
        else:
            total_state = carrier.merge_states(total_state, m.get_state(), (total_count, m._update_count))
            total_count += m._update_count
    carrier.set_state(total_state)
    carrier.mode = ref.mode
    carrier._update_count = total_count
    _equal(ref.compute(), carrier.compute())
    assert total_count == ref._update_count


def test_catbuffer_folds_bitwise(tmp_path):
    make = lambda: mt.AUROC(buffer_capacity=512, **CPU)  # noqa: E731
    _save_world(make, str(tmp_path))
    m = make()
    ck.restore_checkpoint(m, str(tmp_path), host_index=0, host_count=1)
    _equal(_reference(make).compute(), m.compute())


def test_mean_fold_recomputed_from_counts(tmp_path):
    for i in range(4):
        m = mt.MeanMetric(**CPU)
        for u in range(i + 1):
            m.update(torch.tensor(float(10 * i + u)))
        ck.save_checkpoint(m, str(tmp_path), step=0, shard_index=i, world_size=4)
    ref = mt.MeanMetric(**CPU)
    for i in range(4):
        for u in range(i + 1):
            ref.update(torch.tensor(float(10 * i + u)))
    folded = mt.MeanMetric(**CPU)
    ck.restore_checkpoint(folded, str(tmp_path), host_index=0, host_count=1)
    np.testing.assert_allclose(folded.compute().numpy(), ref.compute().numpy(), rtol=1e-6)


def test_more_hosts_than_shards_get_defaults(tmp_path):
    _save_world(lambda: mt.Accuracy(**CPU), str(tmp_path), world=2)
    m = mt.Accuracy(**CPU)
    info = ck.restore_checkpoint(m, str(tmp_path), host_index=5, host_count=8)
    assert info.shards_loaded == () and m._update_count == 0
    assert all(int(v) == 0 for v in m.get_state().values())


def test_preemption_cycle_save_kill_restore_continue(tmp_path):
    make = lambda: mt.Accuracy(**CPU)  # noqa: E731
    _save_world(make, str(tmp_path))
    ref = _reference(make)
    resumed = make()
    ck.restore_checkpoint(resumed, str(tmp_path), host_index=0, host_count=1)
    extra = _host_batch(999)
    resumed.update(*extra)
    ref.update(*extra)
    _equal(ref.compute(), resumed.compute())
    assert resumed._update_count == ref._update_count


def test_offline_merge_matches_live_fold(tmp_path):
    make = lambda: mt.Accuracy(**CPU)  # noqa: E731
    _save_world(make, str(tmp_path / "in"))
    ck.merge_shards(str(tmp_path / "in"), str(tmp_path / "out"))
    assert ck.verify_checkpoint(str(tmp_path / "out")).ok
    m = make()
    ck.restore_checkpoint(m, str(tmp_path / "out"), host_index=0, host_count=1)
    ref = _reference(make)
    _equal(ref.compute(), m.compute())
    assert m._update_count == ref._update_count


class _CallableReduce(mt.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("acc", default=torch.tensor(0.0), dist_reduce_fx=lambda stacked: torch.sum(stacked, dim=0))

    def update(self, x):
        self.acc = self.acc + x.sum()

    def compute(self):
        return self.acc


def test_callable_reduction_refuses_fold_but_allows_same_world(tmp_path):
    for i in range(2):
        m = _CallableReduce(**CPU)
        m.update(torch.tensor([float(i + 1)]))
        ck.save_checkpoint(m, str(tmp_path), step=0, shard_index=i, world_size=2)
    m = _CallableReduce(**CPU)
    ck.restore_checkpoint(m, str(tmp_path), host_index=1, host_count=2)
    assert float(m.compute()) == 2.0
    with pytest.raises(ck.CheckpointMismatchError, match="folded|reduction"):
        ck.restore_checkpoint(_CallableReduce(**CPU), str(tmp_path), host_index=0, host_count=1)


def _confmat_world(root, make):
    ref = make()
    for i in range(N):
        m = make()
        rng = np.random.default_rng(i)
        batch = (torch.from_numpy(rng.integers(0, 64, (128,))), torch.from_numpy(rng.integers(0, 64, (128,))))
        m.update(*batch)
        ref.update(*batch)
        ck.save_checkpoint(m, root, step=0, shard_index=i, world_size=N)
    return ref


def test_reshard_plan_structure_and_peaks(tmp_path):
    _confmat_world(str(tmp_path), lambda: mt.ConfusionMatrix(num_classes=64, **CPU))
    manifest = ckio.read_manifest(str(tmp_path), 0)
    plan = ck.build_reshard_plan(manifest, ck.assign_shards(N, 0, 1))
    assert plan.world_size == N and plan.shards == tuple(range(N))
    assert [s["op"] for s in plan.steps] == ["load", "fold", "free"] * N
    state_bytes = 64 * 64 * 4
    assert all(s["bytes"] == state_bytes for s in plan.steps if s["op"] == "fold")
    largest = max(int(s["bytes"]) for s in manifest["shards"])
    assert plan.plan_peak_bytes <= state_bytes + largest < plan.gather_peak_bytes
    assert plan.gather_peak_bytes == sum(int(s["bytes"]) for s in manifest["shards"]) + state_bytes


def test_streaming_restore_n_to_m_peak_below_gather(tmp_path):
    make = lambda: mt.ConfusionMatrix(num_classes=64, **CPU)  # noqa: E731
    ref = _confmat_world(str(tmp_path), make)
    total = torch.zeros((64, 64), dtype=torch.int64)
    for host in range(3):
        m = make()
        info = ck.restore_checkpoint(m, str(tmp_path), host_index=host, host_count=3)
        assert info.reshard_plan.shards == ck.assign_shards(N, host, 3)
        assert info.plan_peak_bytes == info.reshard_plan.plan_peak_bytes
        assert info.gather_peak_bytes == info.reshard_plan.gather_peak_bytes
        if len(info.shards_loaded) > 1:
            assert info.measured_peak_bytes < info.gather_peak_bytes
            assert info.plan_peak_bytes < info.gather_peak_bytes
        assert info.measured_peak_bytes > 0
        total += m.confmat.to(torch.int64)
    assert torch.equal(ref.confmat.to(torch.int64), total)


def test_single_shard_plan_degenerates(tmp_path):
    _save_world(lambda: mt.Accuracy(**CPU), str(tmp_path), world=2)
    info = ck.restore_checkpoint(mt.Accuracy(**CPU), str(tmp_path), host_index=1, host_count=2)
    plan = info.reshard_plan
    assert plan.shards == (1,) and [s["op"] for s in plan.steps] == ["load", "fold", "free"]
    assert plan.plan_peak_bytes == plan.gather_peak_bytes


def test_catbuffer_plan_accumulates_concat_bytes(tmp_path):
    _save_world(lambda: mt.AUROC(buffer_capacity=512, **CPU), str(tmp_path), world=4)
    plan = ck.build_reshard_plan(ckio.read_manifest(str(tmp_path), 0), ck.assign_shards(4, 0, 1))
    fold_bytes = [s["bytes"] for s in plan.steps if s["op"] == "fold"]
    assert fold_bytes == sorted(fold_bytes) and fold_bytes[-1] > fold_bytes[0]


# -------------------------------------------------- sharded state (4 ranks) --
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


def _quarters(batches):
    return [[tuple(np.array_split(x, WORLD)[r] for x in b) for b in batches] for r in range(WORLD)]


def test_checkpoint_roundtrip_sharded(world, tmp_path):
    """tests/core/test_sharded_state.py:311: placed -> placed (each rank keeps
    its block) and placed -> replicated (the payload is placement-free)."""
    rng = np.random.default_rng(0)
    preds, target = rng.integers(0, 64, size=(128,)), rng.integers(0, 64, size=(128,))
    expect = np.asarray(M.ConfusionMatrix(num_classes=64, **JAX_EAGER)(jnp.asarray(preds), jnp.asarray(target)))
    spec = ("ConfusionMatrix", {"num_classes": 64})
    root = str(tmp_path / "ckpt")
    saved = world.run(tt.save_placed, [(spec, q, root) for q in _quarters([(preds, target)])])
    for r in saved:
        np.testing.assert_array_equal(r["compute"], expect)
    # the four ranks saved at once: the first to publish committed, and every
    # rank that found the snapshot published reports it committed
    assert any(r["committed"] for r in saved) and ck.verify_checkpoint(root).ok
    assert ck.available_steps(root) == [1] and not ck.clean_pending(root, dry_run=True)
    placed = world.run_all(tt.restore_into, spec, root, True)
    flat = world.run_all(tt.restore_into, spec, root, False)
    for r in placed:
        assert r["shapes"]["confmat"] == (64 // WORLD, 64)
        np.testing.assert_array_equal(r["compute"], expect)
    for r in flat:
        assert r["shapes"]["confmat"] == (64, 64)
        np.testing.assert_array_equal(r["compute"], expect)


def test_checkpoint_fingerprint_includes_shard_axis():
    """tests/core/test_sharded_state.py:334."""
    fp = metric_fingerprint(mt.ConfusionMatrix(num_classes=8, **CPU))
    assert fp["states"]["confmat"]["shard_axis"] == 0
    assert "shard_axis" not in metric_fingerprint(mt.Accuracy(num_classes=8, average="micro", **CPU))["states"]["tp"]


def test_checkpoint_fingerprint_shard_axis_back_compat():
    """tests/core/test_sharded_state.py:343."""
    live = metric_fingerprint(mt.ConfusionMatrix(num_classes=8, **CPU))
    pre = copy.deepcopy(live)
    del pre["states"]["confmat"]["shard_axis"]
    assert fingerprint_diff(pre, live) == [] and fingerprint_diff(live, pre) == []
    conflicting = copy.deepcopy(live)
    conflicting["states"]["confmat"]["shard_axis"] = 1
    assert fingerprint_diff(conflicting, live)


def test_multi_axis_checkpoint_roundtrip(world, tmp_path):
    """tests/core/test_multi_axis_sharding.py:209, on a 2 x 2 grid."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, size=(16, 8)).astype(np.int32)
    want = x.sum(axis=1).astype(np.int32)
    spec = ("GridMetric", {})
    root = str(tmp_path / "grid")
    grid = ((2, 2), ("cls", "thr"))
    # every rank adds its share: rank 0 the whole grid, the others zeros
    args = [(spec, [(x if r == 0 else np.zeros_like(x),)], root, *grid) for r in range(WORLD)]
    for r in world.run(tt.save_placed, args):
        np.testing.assert_array_equal(r["compute"], want)
    for r in world.run_all(tt.restore_into, spec, root, True, *grid):
        assert r["shapes"]["grid"] == (8, 4)
        np.testing.assert_array_equal(r["compute"], want)
    for r in world.run_all(tt.restore_into, spec, root, False, *grid):
        assert r["shapes"]["grid"] == (16, 8)
        np.testing.assert_array_equal(r["compute"], want)


def test_multi_axis_leaf_meta_and_fingerprint():
    """tests/core/test_multi_axis_sharding.py:231."""
    m = tsh.GridMetric(device="cpu")
    fp = metric_fingerprint(m)
    assert fp["states"]["grid"]["shard_axis"] == [0, 1]
    _, meta = metric_leaves(m, "")
    assert meta["grid"]["shard_axis"] == [0, 1]
    old = copy.deepcopy(fp)
    del old["states"]["grid"]["shard_axis"]
    assert fingerprint_diff(old, fp) == []
    conflicting = copy.deepcopy(fp)
    conflicting["states"]["grid"]["shard_axis"] = [1, 0]
    assert fingerprint_diff(conflicting, fp)


# ----------------------------------------------------- the cross-package gate --
def _config2(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=10, average="micro", **kw),
        "f1": pkg.F1Score(num_classes=10, average="macro", **kw),
        "precision": pkg.Precision(num_classes=10, average="macro", **kw),
        "recall": pkg.Recall(num_classes=10, average="macro", **kw),
    })


def _config2_calls():
    rng = np.random.default_rng(7)
    return [((rng.normal(size=(64, 10)).astype(np.float32), rng.integers(0, 10, 64).astype(np.int32)), {})
            for _ in range(3)]


def _auroc_calls():
    rng = np.random.default_rng(8)
    return [((rng.uniform(0, 1, 48).astype(np.float32), rng.integers(0, 2, 48).astype(np.int32)), {}) for _ in range(2)]


def _quantile_calls():
    rng = np.random.default_rng(9)
    return [((rng.lognormal(size=256).astype(np.float32),), {}) for _ in range(2)]


def _cat_calls():
    return [((np.array([1.0, 2.0], np.float32),), {}), ((np.array([3.0], np.float32),), {})]


GATE = {
    # name: (jax maker, port maker, calls, integer states only)
    "config2": (lambda: _config2(M, **JAX_EAGER), lambda: _config2(mt, **CPU), _config2_calls, True),
    "catbuffer": (lambda: M.AUROC(buffer_capacity=128, **JAX_EAGER), lambda: mt.AUROC(buffer_capacity=128, **CPU),
                  _auroc_calls, False),
    "sketch": (lambda: M.Quantile(q=0.9, **JAX_EAGER), lambda: mt.Quantile(q=0.9, **CPU), _quantile_calls, False),
    "list": (lambda: M.CatMetric(**JAX_EAGER), lambda: mt.CatMetric(**CPU), _cat_calls, False),
}


def _manifest_without_checksums(root, read):
    manifest = read(root)
    for shard in manifest["shards"]:
        shard.pop("sha256")
        shard.pop("bytes")
    return manifest


def _results(value):
    if isinstance(value, dict):
        return {k: _results(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_results(v) for v in value]
    return np.asarray(value.numpy() if isinstance(value, torch.Tensor) else value)


def _same(got, want, exact):
    if isinstance(want, dict):
        for k in want:
            _same(got[k], want[k], exact)
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _same(g, w, exact)
    elif exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(GATE))
def test_snapshots_restore_across_packages(case, tmp_path):
    make_jax, make_port, calls, integer = GATE[case]
    jax_m, port_m = make_jax(), make_port()
    for args, kw in calls():
        jax_m.update(*(jnp.asarray(a) for a in args), **kw)
        port_m.update(*(torch.from_numpy(a) for a in args), **kw)
    jck.save_checkpoint(jax_m, str(tmp_path / "jax"), world_size=1, shard_index=0)
    ck.save_checkpoint(port_m, str(tmp_path / "port"), world_size=1, shard_index=0)
    read = lambda root: jio.read_manifest(root, 0)  # noqa: E731
    assert _manifest_without_checksums(str(tmp_path / "jax"), read) == \
        _manifest_without_checksums(str(tmp_path / "port"), read)
    want, want_port = _results(jax_m.compute()), _results(port_m.compute())
    # JAX -> port: the port restores the JAX package's snapshot; its results
    # are its own (bitwise where the states are integer counts) and the JAX
    # package's within the stated bound
    from_jax = make_port()
    ck.restore_checkpoint(from_jax, str(tmp_path / "jax"), host_index=0, host_count=1)
    _same(_results(from_jax.compute()), want_port, integer)
    _same(_results(from_jax.compute()), want, False)
    # port -> JAX
    from_port = make_jax()
    jck.restore_checkpoint(from_port, str(tmp_path / "port"), host_index=0, host_count=1)
    _same(_results(from_port.compute()), want, integer)
    if integer:
        payload_j = jio.load_npz(os.path.join(jio.step_dir(str(tmp_path / "jax"), 0), "shard_00000-of-00001.npz"))
        payload_p = ckio.load_npz(os.path.join(ckio.step_dir(str(tmp_path / "port"), 0), "shard_00000-of-00001.npz"))
        assert payload_j.keys() == payload_p.keys()
        for k in payload_j:
            assert payload_j[k].dtype == payload_p[k].dtype
            np.testing.assert_array_equal(payload_j[k], payload_p[k])


def test_placed_snapshots_restore_across_packages(world, tmp_path):
    """A placed metric's snapshot: the port's, written by 4 ranks, folds in
    the JAX package onto one host; the JAX package's (one host) restores
    into the port's placement over 4 ranks (rank 0 takes the shard, each
    rank keeps its block)."""
    rng = np.random.default_rng(11)
    preds, target = rng.integers(0, 32, size=(256,)), rng.integers(0, 32, size=(256,))
    jax_m = M.ConfusionMatrix(num_classes=32, **JAX_EAGER)
    jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    expect = np.asarray(jax_m.compute())
    spec = ("ConfusionMatrix", {"num_classes": 32})
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    world.run(tt.save_placed, [(spec, q, port_root) for q in _quarters([(preds, target)])])
    folded = M.ConfusionMatrix(num_classes=32, **JAX_EAGER)
    jck.restore_checkpoint(folded, port_root, host_index=0, host_count=1)
    np.testing.assert_array_equal(np.asarray(folded.compute()), expect)
    jck.save_checkpoint(jax_m, jax_root, world_size=1, shard_index=0)
    for r in world.run_all(tt.restore_into, spec, jax_root, True):
        assert r["shapes"]["confmat"] == (32 // WORLD, 32)
        np.testing.assert_array_equal(r["compute"], expect)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_object_fingerprint_matches_jax(name):
    """The JSON fingerprint of every INVENTORY entry is the JAX package's, so
    a restore across the packages is never refused for a format reason."""
    got = json.dumps(object_fingerprint(twin(name)), sort_keys=True)
    want = json.dumps(jax_fingerprint(reference(name)), sort_keys=True)
    assert got == want


def test_tenant_set_fingerprint_matches_jax():
    port = mt.TenantSet(_config2(mt, **CPU), capacity=8)
    ref = M.TenantSet(_config2(M, **JAX_EAGER), capacity=8)
    assert json.dumps(object_fingerprint(port), sort_keys=True) == json.dumps(jax_fingerprint(ref), sort_keys=True)


def test_unsupported_object_is_refused(tmp_path):
    with pytest.raises(MetricsUserError, match="Metric and MetricCollection"):
        ck.save_checkpoint({"not": "a metric"}, str(tmp_path))
