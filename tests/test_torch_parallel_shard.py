"""MST++ on halo bands (``parallel/fused_shard.py``, ``mesh.sharded_inference_fn``)
on a world of 4 CPU ranks, against the port's unsharded forward and the JAX
module.

One spawned world carries every check (``torch_parallel_checks.shard_checks``):
the synth_v1 forward on 2 x 32x48 frames with sp 2 x tp 2 (four bands of
8 rows, each gathering its 48-row halo from several owners) and with
dp 2 x sp 2; shapes that do not band-split, which run whole; the halo
exchange's autograd under ``torch.autograd.gradcheck`` (float64, bands of 4
rows, margins 6 and 2); and a band-sum loss whose gradients, summed over
the ranks, equal the unsharded ones. The JAX side is ``module.apply`` under
``no_fused_ffn`` in this process (the JAX ``fused_sharded_forward`` in
interpret mode costs minutes, and ``tests/test_parallel.py`` holds it
against the same ``module.apply``).

Bars: the port's unsharded plain forward within 1e-5, the JAX module
< 5e-4 (README's MST++ bar), gradients within 1e-5 of each tensor's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_parallel_checks as checks

from animal_vision_tpu.models import quality
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.models.mst_plus_plus import no_fused_ffn
from animal_vision_tpu_torch.parallel import fused_shard
from animal_vision_tpu_torch.parallel.launch import spawn

SHAPE = (2, 32, 48, 3)
FALLBACK = [(2, 20, 24, 3), (1, 36, 40, 3)]  # padded rows 24 and 40 split into 4 bands of 6 and 10
PORT_TOL = 1e-5
JAX_TOL = 5e-4
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(2).uniform(0, 1, SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def world(x):
    grad_x = np.random.default_rng(3).normal(0, 1, (1, 8, 3, 2))
    return spawn(checks.shard_checks, 4, "cpu", timeout=TIMEOUT_S, x=x, fallback_shapes=FALLBACK, grad_x=grad_x)


@pytest.fixture(scope="module")
def jax_want(x):
    variables = quality.load_pretrained()[1]
    with no_fused_ffn():
        return np.asarray(jax.jit(JMSTPlusPlus().apply)(variables, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["sp2tp2", "dp2sp2"])
def test_band_forward_matches_unsharded(world, name):
    for r in world:
        assert r[f"{name}_err"] <= PORT_TOL, (r["rank"], r[f"{name}_err"])
        assert np.array_equal(r[name], world[0][name])  # every rank returns the whole output


@pytest.mark.parametrize("name", ["sp2tp2", "dp2sp2"])
def test_band_forward_matches_jax(world, jax_want, name):
    got = world[0][name]
    assert got.shape == jax_want.shape
    assert np.abs(got - jax_want).max() < JAX_TOL


@pytest.mark.parametrize("shape", FALLBACK)
def test_frames_that_do_not_band_split_run_whole(world, shape):
    assert not fused_shard.supports((1, 2, 2), *shape[:3])
    for r in world:
        took_bands, err = r[f"fallback{tuple(shape)}"]
        assert not took_bands
        assert err == 0.0  # the same forward on every rank


def test_halo_exchange_gradcheck(world):
    assert all(all(r["gradcheck"]) for r in world)


def test_band_sum_loss_gradient_equals_unsharded(world):
    for r in world:
        assert r["band_grad_rel"] <= PORT_TOL, (r["rank"], r["band_grad_rel"])

