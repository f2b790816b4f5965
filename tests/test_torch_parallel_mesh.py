"""The port's mesh arithmetic (``parallel/mesh.py``, ``fused_shard.supports``)
against the JAX package's, and the rank launcher (``parallel/launch.py``).

The rank order, ``supports`` and ``param_specs`` are pure arithmetic and
need no process group. The launcher's checks start small CPU worlds: the
ranks' backend, device and thread count, a failing rank, and a world that
outlives its timeout, each of which must raise in the parent with every
rank gone.
"""

import multiprocessing
import time

import jax
import numpy as np
import pytest
import torch
import torch_parallel_checks as checks
from jax.sharding import PartitionSpec as P

from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.parallel import fused_shard as jshard
from animal_vision_tpu.parallel import make_mesh as jmake_mesh
from animal_vision_tpu.parallel import shard_batch as jshard_batch
from animal_vision_tpu.parallel.mesh import param_specs as jparam_specs
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, from_jax_params
from animal_vision_tpu_torch.parallel import comm, fused_shard, launch
from animal_vision_tpu_torch.parallel.mesh import Mesh, param_specs, rank_grid, shard_batch, tp_slice

MESHES = [(1, 2, 2), (2, 2, 1), (1, 4, 1), (2, 1, 2), (1, 1, 1), (4, 2, 1), (1, 8, 1), (2, 2, 2), (1, 1, 4)]


@pytest.mark.parametrize("dims", MESHES)
def test_rank_order_is_the_jax_reshape(dims):
    dp, sp, tp = dims
    devices = jax.devices()[:dp * sp * tp]
    mesh = jmake_mesh(devices, dp=dp, sp=sp, tp=tp)
    ids = np.vectorize(lambda d: devices.index(d))(mesh.devices)
    assert np.array_equal(rank_grid(dp, sp, tp), ids)
    # the band path's spatial axis: JAX reshapes to (dp, sp * tp) in the same order
    assert np.array_equal(rank_grid(dp, sp, tp).reshape(dp, sp * tp),
                          np.vectorize(lambda d: devices.index(d))(jshard.spatial_mesh(mesh).devices))


@pytest.mark.parametrize("dims", MESHES)
def test_supports_equals_the_jax_rule(dims):
    dp, sp, tp = dims
    mesh = jmake_mesh(jax.devices()[:dp * sp * tp], dp=dp, sp=sp, tp=tp)
    assert fused_shard.spatial_mesh(dims) == (dp, sp * tp)
    for b in (1, 2, 3, 4, 6, 8):
        for h in (1, 8, 16, 20, 24, 25, 32, 36, 64, 100, 104, 270, 272, 540, 544, 1080):
            for w in (17, 48):
                assert fused_shard.supports(dims, b, h, w) == jshard.supports(mesh, b, h, w), (b, h, w)


@pytest.mark.parametrize("dims", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
def test_shard_batch_is_the_jax_placement(dims):
    """Every rank's block of a batch, as the JAX ``shard_batch`` places it
    on the mesh's devices (frames over dp, rows over sp, replicated over tp)."""
    dp, sp, tp = dims
    devices = jax.devices()[:dp * sp * tp]
    batch = np.arange(4 * 8 * 3 * 2, dtype=np.float32).reshape(4, 8, 3, 2)
    placed = jshard_batch(jmake_mesh(devices, dp=dp, sp=sp, tp=tp), batch)
    for shard in placed.addressable_shards:
        mesh = Mesh(dp, sp, tp, devices.index(shard.device), {})
        assert np.array_equal(shard_batch(mesh, torch.from_numpy(batch)).numpy(), np.asarray(shard.data))


def test_param_specs_are_the_jax_tp_axes():
    """Each JAX kernel marked along its tp axis (the others zero), carried
    across by ``from_jax_params``: the port's tensor varies along exactly
    the dimension ``param_specs`` names."""
    params = jax.eval_shape(lambda k: JMSTPlusPlus(stage=1).init(k, None, weights_only=True),
                            jax.random.PRNGKey(0))["params"]  # shapes only
    specs = jparam_specs({"params": params})["params"]

    def mark(spec, leaf):
        axes = [i for i, name in enumerate(spec) if name == "tp"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * len(leaf.shape)
        shape[axes[0]] = leaf.shape[axes[0]]
        return np.broadcast_to(np.arange(1, leaf.shape[axes[0]] + 1).reshape(shape), leaf.shape).astype(np.float32)

    marked = jax.tree_util.tree_map(mark, specs, params, is_leaf=lambda x: isinstance(x, P))
    sd = from_jax_params(marked)
    ours = param_specs(MSTPlusPlus(stage=1))
    assert sorted(sd) == sorted(ours)
    n_split = 0
    for name, t in sd.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and not bool((t.diff(dim=d) == 0).all())]
        assert ours[name] == (("tp", varying[0]) if varying else ()), name
        n_split += bool(varying)
    assert n_split == 3 * 5  # net_0, net_2, net_4 of each of the 5 MSAB blocks of a stage


def test_tp_slice_splits_the_hidden_channels():
    assert [tp_slice(124, 2, t) for t in range(2)] == [slice(0, 62), slice(62, 124)]
    assert [tp_slice(496, 4, t) for t in range(4)][3] == slice(372, 496)
    with pytest.raises(ValueError, match="do not split"):
        tp_slice(124, 3, 0)


def test_halo_plan_pieces():
    """Bands of 8 rows, a margin of 12: every member's extended band is
    made of its neighbours' rows, two owners deep."""
    own = [(8 * q, 8 * q + 8) for q in range(4)]
    need = [(max(0, s - 12), min(32, e + 12)) for s, e in own]
    plan = comm.HaloPlan(own, need, [10, 11, 12, 13], 1)
    assert plan.pieces == [(0, (0, 8)), (1, (8, 16)), (2, (16, 24)), (3, (24, 28))]
    assert plan.outgoing == [(0, (8, 16)), (2, (8, 16)), (3, (12, 16))]
    with pytest.raises(ValueError, match="must contain"):
        comm.HaloPlan(own, [(0, 8)] * 4, [0, 1, 2, 3], 1)


def test_launch_ranks_and_backend():
    res = launch.spawn(checks.rank_info, 2, "cpu", timeout=120)
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" and r["device"] == "cpu" for r in res)
    assert all(r["threads"] == 1 for r in res)
    assert comm.choose_backend(4, "cpu") == "gloo"


def test_launch_raises_when_a_rank_fails():
    before = set(multiprocessing.active_children())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*on purpose"):
        launch.spawn(checks.fail_on_rank_one, 2, "cpu", timeout=120)
    assert time.monotonic() - t0 < 60  # not held until the collective's timeout
    assert not set(multiprocessing.active_children()) - before


def test_launch_times_out_and_kills_the_ranks():
    before = set(multiprocessing.active_children())
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done within"):
        launch.spawn(checks.sleep_forever, 2, "cpu", timeout=8)
    assert time.monotonic() - t0 < 60
    assert not set(multiprocessing.active_children()) - before


def test_launch_defaults_to_the_card(monkeypatch):
    """With no device a world runs on the card; without one it raises
    before any rank starts, and never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(checks.rank_info, 2, timeout=120)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(checks.rank_info, 2, "cuda", timeout=120)
    assert not set(multiprocessing.active_children()) - before
