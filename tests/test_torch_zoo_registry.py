"""The port's zoo registry, weights, parameter counts, metrics, tiling,
self-ensemble and summary against the JAX package, on the CPU.

Bars: parameter counts equal; metrics within 1e-6 relative (PSNR: see
``test_metrics_vs_jax``); tiling within
1e-5 absolute of the JAX stitching with a fixed linear map (float32 sums
of the Hann weights in another order) and within 1e-4 with a zoo model
(the model bar of ``tests/torch_zoo_checks.py``); the self-ensemble within
1e-4 (the same model bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import ensemble as j_ensemble
from animal_vision_tpu.models import metrics as j_metrics
from animal_vision_tpu.models import tiling as j_tiling
from animal_vision_tpu.models import zoo as j_zoo
from animal_vision_tpu_torch.models import ensemble, metrics, summary, tiling, zoo
from torch_zoo_checks import CASES, frames, numpy_state, one_torch_thread, seeded

_ = one_torch_thread
NINE = ["awan", "edsr", "hdnet", "hinet", "hrnet", "hscnn_plus", "mirnet", "mprnet", "restormer"]


def test_registry_lists_the_jax_methods():
    assert zoo.available_models() == j_zoo.available_models()
    assert sorted(NINE + ["mst", "mst_plus_plus"]) == zoo.available_models()


@pytest.mark.parametrize("method", NINE)
def test_param_count_equals_jax(method):
    """The registry configuration built on the CPU holds as many values as
    the JAX module's parameters (``jax.eval_shape`` of its ``init``)."""
    model = zoo.model_generator(method, device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    build, _ = j_zoo._REGISTRY[method]
    module = build()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert summary.param_count(model) == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_init_weights_new_kinds():
    """PReLU slopes 0.25, norm scales and temperatures 1, BatchNorm
    statistics drawn (variance in [0.5, 1.5)); the same seed gives the same
    weights and statistics, another seed others."""
    a, b, c = (zoo.init_weights(CASES["hdnet"][0](), torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["body.33.subspaces.0.bn_dws.running_mean"], sc["body.33.subspaces.0.bn_dws.running_mean"])
    var = sa["body.33.subspaces.1.bn_point.running_var"]
    assert ((var >= 0.5) & (var < 1.5)).all()
    assert torch.equal(sa["body.33.subspaces.1.bn_dws.weight"], torch.ones(12))
    awan = seeded("awan").state_dict()
    assert torch.equal(awan["backbone.0.se.fc.1.weight"], torch.full((1,), 0.25))
    restormer = seeded("restormer").state_dict()
    assert torch.equal(restormer["latent.0.attn.temperature"], torch.ones(8, 1, 1))
    assert torch.equal(restormer["latent.0.norm1.body.weight"], torch.ones(384))
    hinet = seeded("hinet").state_dict()
    assert torch.equal(hinet["down_path_1.0.norm.weight"], torch.ones(16))
    w = hinet["conv_01.weight"]
    assert 0.4 < w.std().item() * np.sqrt(3 * w[0].numel()) < 1.6


@pytest.mark.parametrize("method", NINE)
def test_model_generator_device_and_checkpoint(method, tmp_path, monkeypatch):
    """A reference checkpoint (``module.`` prefixes) loads; the default
    device without a card raises."""
    src = zoo.model_generator(method, device="cpu", seed=3)
    path = tmp_path / f"{method}.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.state_dict().items()}}, path)
    got = zoo.model_generator(method, path, device="cpu")
    assert all(torch.equal(got.state_dict()[k], v) for k, v in src.state_dict().items())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.model_generator(method)
    with pytest.raises(ValueError, match="unknown method"):
        zoo.model_generator("unet", device="cpu")


def test_metrics_vs_jax():
    """Within 1e-6 relative of JAX, except PSNR: JAX's float32 mean of the
    squared errors (values up to 255^2) lands 1.3e-6 from the float64 value
    of the same formula, the port's 1e-9, so PSNR is held within 1e-7 of
    that float64 value and 2e-6 of JAX."""
    rng = np.random.default_rng(4)
    pred = rng.uniform(-0.1, 1.1, (2, 16, 20, 31)).astype(np.float32)
    target = rng.uniform(0.05, 1.0, (2, 16, 20, 31)).astype(np.float32)
    for name, bar in (("mrae", 1e-6), ("rmse", 1e-6), ("psnr", 2e-6)):
        got = getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(target)).item()
        want = float(getattr(j_metrics, name)(jnp.asarray(pred), jnp.asarray(target)))
        assert abs(got - want) <= bar * abs(want), name
    p, t = (np.clip(a.astype(np.float64), 0.0, 1.0) * 255.0 for a in (pred, target))
    exact = np.mean(10.0 * np.log10(255.0 ** 2 / ((p - t) ** 2).mean(axis=(1, 2, 3))))
    assert abs(metrics.psnr(torch.from_numpy(pred), torch.from_numpy(target)).item() - exact) <= 1e-7 * exact
    assert metrics.psnr(torch.from_numpy(pred), torch.from_numpy(pred), data_range=1.0).item() == float("inf")


def test_tiling_helpers_equal_jax():
    for size in (1, 2, 64, 256):
        np.testing.assert_array_equal(tiling.hann2d(size), j_tiling.hann2d(size))
    for extent, tile, stride in ((100, 64, 48), (64, 64, 48), (40, 64, 48), (1080, 256, 192), (1920, 256, 192)):
        assert tiling._tile_starts(extent, tile, stride) == j_tiling._tile_starts(extent, tile, stride)


def _linear(tiles, lib):
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    if lib is torch:
        return torch.einsum("nhwc,cd->nhwd", tiles, torch.from_numpy(m))
    return jnp.einsum("nhwc,cd->nhwd", tiles, jnp.asarray(m))


@pytest.mark.parametrize("hw", [(100, 140), (40, 50), (64, 64)])
def test_predict_tiled_linear_vs_jax(hw):
    """A fixed linear map: the stitched output equals the JAX stitching and
    the map itself (the frame smaller than the tile is reflect-padded)."""
    frame = np.random.default_rng(0).uniform(0, 1, (*hw, 3)).astype(np.float32)
    got = tiling.predict_tiled(lambda t: _linear(t, torch), torch.from_numpy(frame), tile=64, overlap=16,
                               out_channels=4).numpy()
    want = j_tiling.predict_tiled(lambda t: _linear(t, jnp), frame, tile=64, overlap=16, out_channels=4)
    assert got.shape == want.shape == (*hw, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, frame @ np.arange(12, dtype=np.float32).reshape(3, 4), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(40, 56), (20, 28)])
def test_predict_tiled_model_vs_jax(hw):
    """HSCNN+ (4 blocks, the same weights on both sides) over 32x32 tiles:
    several tiles, and a frame smaller than the tile."""
    model = seeded("hscnn_plus")
    _, _, jax_module, convert = CASES["hscnn_plus"]
    module, variables = jax_module(), convert(numpy_state(model))
    frame = frames((*hw, 3), seed=6)
    with torch.no_grad():
        got = tiling.predict_tiled(model, torch.from_numpy(frame), tile=32, overlap=8).numpy()
    want = j_tiling.predict_tiled(lambda t: module.apply(variables, t), frame, tile=32, overlap=8)
    assert got.shape == (*hw, 31)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["mean", "median"])
def test_forward_ensemble_vs_jax(mode):
    """The 8-view self-ensemble of SGN (the same weights on both sides) on
    a non-square batch, which the transposed views turn over."""
    model = seeded("hrnet")
    _, _, jax_module, convert = CASES["hrnet"]
    module, variables = jax_module(), convert(numpy_state(model))
    x = frames((2, 16, 24, 3), seed=7)
    with torch.no_grad():
        got = ensemble.forward_ensemble(model, torch.from_numpy(x), mode).numpy()
    want = np.asarray(j_ensemble.forward_ensemble(lambda t: module.apply(variables, t), jnp.asarray(x), mode))
    assert got.shape == want.shape == (2, 16, 24, 31)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_ensemble_median_takes_the_lower_middle():
    """Eight views of constant outputs 0..7: the median is 3, as
    ``torch.median`` gives (not 3.5)."""
    calls = []

    def fn(t):
        calls.append(1)
        return torch.full((*t.shape[:3], 1), float(len(calls) - 1))

    assert ensemble.forward_ensemble(fn, torch.zeros(1, 4, 4, 3), "median").unique().item() == 3.0
    with pytest.raises(ValueError):
        ensemble.forward_ensemble(fn, torch.zeros(1, 4, 4, 3), "max")


def test_summarize_counts():
    """Parameters as ``param_count``; FLOPs of the convolutions only: the
    MIRNet forward at 32x40 holds every convolution's 2 x MACs."""
    s = summary.summarize("mirnet", 32, 40, device="cpu")
    assert s["method"] == "mirnet" and s["params"] == 2251464
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=False)
    assert summary.count_flops(conv, torch.zeros(1, 3, 8, 10)) == 2 * 3 * 5 * 9 * 8 * 10
    assert s["flops"] > 0
