"""The pp pipeline (``parallel/pipeline.py``) on a world of 4 CPU ranks,
against the JAX ``pipeline_apply`` and ``mst_plus_plus_pp_forward`` and the
port's unsharded forward.

One spawned world (``torch_parallel_checks.pipeline_checks``): the toy stage
x * a + b over 2 slots and 5 microbatches (out = 2x + 3), then MST++ with
the shipped weights, its 3 stages over 4 slots (one identity slot) on
4 x 16x16 frames in 4 microbatches. Bars: the toy within 1e-6 of JAX; MST++
< 5e-4 of the JAX pipeline and within 1e-5 of the port's unsharded forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parallel_checks as checks

from animal_vision_tpu.models import quality
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.parallel.pipeline import make_pp_mesh, mst_plus_plus_pp_forward, pipeline_apply
from animal_vision_tpu_torch.parallel.launch import spawn
from animal_vision_tpu_torch.parallel.pipeline import bubble_share

TIMEOUT_S = 240


@pytest.fixture(scope="module")
def inputs():
    micro = np.random.default_rng(0).normal(0, 1, (5, 3, 4)).astype(np.float32)
    x = np.random.default_rng(1).uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    return micro, x


@pytest.fixture(scope="module")
def world(inputs):
    micro, x = inputs
    return spawn(checks.pipeline_checks, 4, "cpu", timeout=TIMEOUT_S, micro=micro, x=x)


def test_toy_pipeline_matches_jax(world, inputs):
    micro, _ = inputs
    stacked = {"a": jnp.asarray([2.0, 1.0]), "b": jnp.asarray([0.0, 3.0])}
    want = np.asarray(pipeline_apply(lambda p, t: t * p["a"] + p["b"], stacked, np.ones(2, np.float32),
                                     jnp.asarray(micro), make_pp_mesh(2)))
    for r in world[:2]:
        assert np.abs(r["toy"] - want).max() <= 1e-6
        assert np.abs(r["toy"] - (micro * 2.0 + 3.0)).max() <= 1e-6
    assert "toy" not in world[2] and "toy" not in world[3]  # outside the 2-slot pipeline


def test_mst_pipeline_matches_unsharded(world):
    for r in world:
        assert r["mst_err"] <= 1e-5, (r["rank"], r["mst_err"])
        assert np.array_equal(r["mst"], world[0]["mst"])  # the last slot's outputs, broadcast


def test_mst_pipeline_matches_jax(world, inputs):
    _, x = inputs
    variables = jax.tree_util.tree_map(np.asarray, quality.load_pretrained()[1])  # uncommitted, for the mesh
    want = np.asarray(mst_plus_plus_pp_forward(JMSTPlusPlus(), variables, make_pp_mesh(4), jnp.asarray(x),
                                               n_micro=4))
    assert world[0]["mst"].shape == want.shape
    assert np.abs(world[0]["mst"] - want).max() < 5e-4


def test_bubble_share():
    assert bubble_share(4, 4) == 3 / 7
    assert bubble_share(1, 8) == 0.0
