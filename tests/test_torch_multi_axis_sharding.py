"""The port's grid placements (a tuple ``shard_axis``) against the JAX package's.

Mirrors ``tests/core/test_multi_axis_sharding.py`` case for case, apart from
the checkpoint and fingerprint cases, which wait for the port's checkpoint
module. The port's side runs in one gloo world of 4 CPU ranks laid out as a
2 x 2 ``("cls", "thr")`` mesh; the JAX side, once for the module, places the
same grid metric over a 2 x 2 mesh of 4 of the 8 CPU devices. Rank ``r``
updates with the ``r``-th of four seeded integer batches, which the JAX
metric takes in turn. Integer grids compare bit for bit: blocks against the
JAX package's ``addressable_shards``, values against its replicated
compute. Each update runs one ``reduce_scatter`` per mesh axis.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import metrics_tpu as mt_jax
from metrics_tpu.parallel import grid_sharded as jax_grid_sharded
from metrics_tpu.parallel import make_mesh as jax_make_mesh
from metrics_tpu_torch.parallel import grid_sharded as port_grid_sharded
from tests.helpers import torch_dist as td
from tests.helpers import torch_shard as ts
from tests.helpers.torch_port import assert_bitwise, one_torch_thread  # noqa: F401  (the module fixture)

pytestmark = [pytest.mark.usefixtures("one_torch_thread"), pytest.mark.filterwarnings("ignore")]

WORLD = 4
SHAPE = (16, 8)
LAYOUT = ((2, 2), ("cls", "thr"))
AXES = ("cls", "thr")
GRID = ("GridMetric", {"shape": SHAPE})


class JaxGridMetric(mt_jax.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("grid", default=jnp.zeros(SHAPE, jnp.int32), dist_reduce_fx="sum", shard_axis=(0, 1))

    def update(self, x):
        self.grid = self.grid + x

    def compute(self):
        return self.grid.sum(axis=1)


XS = np.random.default_rng(0).integers(0, 100, (WORLD, *SHAPE)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_refs():
    mesh = jax_make_mesh([2, 2], list(AXES), jax.devices()[:WORLD])
    ref, placed = JaxGridMetric(), JaxGridMetric().shard_state(mesh, axis_name=AXES)
    for x in XS:
        ref.update(jnp.asarray(x))
        placed.update(jnp.asarray(x))
    # device (i, j) of the mesh holds block (i, j); rank 2 i + j of the port's
    blocks = {(s.index[0].start or 0, s.index[1].start or 0): np.asarray(s.data) for s in placed.grid.addressable_shards}
    return {"value": np.asarray(ref.compute()), "spec": tuple(placed.grid.sharding.spec),
            "blocks": [blocks[(8 * (r // 2), 4 * (r % 2))] for r in range(WORLD)]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = td.GlooWorld(WORLD, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


# --------------------------------------------------------------------------- #
# declaration + placement surface
# --------------------------------------------------------------------------- #
def test_add_state_tuple_validation():
    import torch

    import metrics_tpu_torch as mt

    class Bad(mt.Metric):
        def __init__(self, default, shard_axis, **kw):
            super().__init__(device="cpu", **kw)
            self.add_state("s", default=default, dist_reduce_fx="sum", shard_axis=shard_axis)

        def update(self):
            pass

        def compute(self):
            return self.s

    with pytest.raises(ValueError, match="non-empty ints"):
        Bad(torch.zeros((4, 4)), (0, "1"))
    with pytest.raises(ValueError, match="out of range"):
        Bad(torch.zeros((4, 4)), (0, 2))
    with pytest.raises(ValueError, match="same array axis twice"):
        Bad(torch.zeros((4, 4)), (1, -1))
    with pytest.raises(ValueError):
        Bad(torch.zeros((4, 4)), ())
    assert Bad(torch.zeros((4, 4)), (0, -1)).shard_axes == {"s": (0, -1)}


def test_grid_sharded_spec():
    jmesh = jax_make_mesh([1, 1], list(AXES), jax.devices()[:1])
    for args in [(AXES, (0, 1), 2), (AXES, (1, 0), 3)]:
        assert port_grid_sharded(object(), *args).spec == tuple(jax_grid_sharded(jmesh, *args).spec)
    assert port_grid_sharded(object(), AXES, (0, 1), 2).spec == tuple(P("cls", "thr"))
    with pytest.raises(ValueError):
        port_grid_sharded(object(), ("cls",), (0, 1), 2)


@pytest.fixture(scope="module")
def placement_errors(world):
    return world.run_all(ts.placement_errors, LAYOUT)


def test_shard_state_multi_axis_requirements(placement_errors):
    for report in placement_errors:
        assert report["no_mesh"].startswith("ValueError") and "mesh" in report["no_mesh"]
        assert "axis" in report["unknown_axis"]
        assert report["too_few_names"].startswith("ValueError")  # a rank-2 declaration needs two mesh axes


@pytest.fixture(scope="module")
def streams(world):
    return world.run(ts.stream, [(GRID, [(x,), (x,)], True, LAYOUT, AXES) for x in XS])


def test_multi_axis_placement(streams):
    for report in streams:
        assert report["active"] == {"grid": (0, 1)}
        assert report["block_nbytes"]["grid"] * WORLD == int(np.prod(SHAPE)) * 4
        assert report["blocks"]["grid"].shape == (SHAPE[0] // 2, SHAPE[1] // 2)


# --------------------------------------------------------------------------- #
# parity + sync routing
# --------------------------------------------------------------------------- #
def test_multi_axis_parity_bitwise(streams, jax_refs):
    """Each rank updates twice with its batch: the blocks and the value are
    twice the JAX package's, bit for bit; the placement survives the
    compiled update; each update is one reduce_scatter per mesh axis."""
    assert jax_refs["spec"] == AXES
    for rank, report in enumerate(streams):
        assert_bitwise(report["blocks"]["grid"], 2 * jax_refs["blocks"][rank], msg=f"rank {rank}")
        assert_bitwise(report["value"], 2 * jax_refs["value"])
        assert all(u["by_kind"] == {"reduce_scatter": 2} for u in report["updates"])
        assert report["engine"]["compiled_calls"] > 0


def test_multi_axis_sync_reshards_per_mesh_axis(world):
    for report in world.run_all(ts.sync_counts, GRID, True, LAYOUT, AXES):
        # one tiled gather per mesh axis, both billed as reshard: the (8, 4)
        # block gathers to (16, 4) over cls, then to (16, 8) over thr
        assert report["box"]["by_kind"] == {"reshard": 2}
        assert report["box"]["bytes_by_kind"]["reshard"] == 8 * 4 * 4 + 16 * 4 * 4


def test_multi_axis_never_routes_sharded_compute(world):
    """A mesh of several axes always reshards, even for a class that declares
    the protocol (its combine helpers address one group)."""
    spec = ("GridWithProtocol", {"shape": SHAPE})
    for report in world.run_all(ts.sync_counts, spec, True, LAYOUT, AXES, True, True):
        assert report["supports"]
        assert report["box"]["by_kind"].get("reshard", 0) == 2


# --------------------------------------------------------------------------- #
# lifecycle: reset / state_dict / unshard
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lifecycle(world):
    return world.run(ts.lifecycle, [(GRID, (x,), LAYOUT, AXES) for x in XS])


def test_multi_axis_reset_keeps_placement(lifecycle):
    for report in lifecycle:
        assert report["reset_shapes"] == {"grid": (8, 4)} and report["reset_sums"] == {"grid": 0.0}
        assert report["reset_active"] == {"grid": (0, 1)}


def test_multi_axis_state_dict_roundtrip(lifecycle, jax_refs):
    for report in lifecycle:
        assert report["loaded_shapes"] == report["block_shapes"] == {"grid": (8, 4)}
        assert_bitwise(report["before"], jax_refs["value"])
        assert_bitwise(report["loaded"], jax_refs["value"])


def test_multi_axis_unshard(lifecycle, jax_refs):
    for report in lifecycle:
        # the compute before it reshards twice (a mesh of two axes); the
        # unshard ticks one reshard at the whole grid's bytes
        assert report["compute_unshard"]["by_kind"] == {"reshard": 3}
        assert report["compute_unshard"]["bytes_by_kind"]["reshard"] == 8 * 4 * 4 + 16 * 4 * 4 + 16 * 8 * 4
        assert report["unsharded_active"] == {} and report["unsharded_shapes"] == {"grid": SHAPE}
        assert_bitwise(report["after_unshard"], 2 * jax_refs["value"])
