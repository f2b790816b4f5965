"""The port's quality report and single-image tool (``models/quality.py``,
``ensemble.predict_image`` and ``main``) against the JAX package's, on the
CPU (cv2 and h5py are imported here; the port imports them only inside the
functions that use them).

Bars: ``predict_image`` within 5e-4 of JAX; ``load_pretrained`` the JAX
checkpoint bit for bit; ``fused_vs_f32_psnr`` equal to JAX's on the CPU;
``eval_protocol_fixtures`` within 1e-4 relative of JAX with the same
``apply_fn``; the quality report equal to JAX's at its rounding.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import ensemble as jensemble
from animal_vision_tpu.models import quality as jquality
from animal_vision_tpu.models import train as jtrain
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu_torch.models import ensemble, quality, train, zoo
from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, from_jax_params


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got: dict, want: dict, rel: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= rel * max(abs(float(want[k])), 1e-12), (k, got[k], want[k])


@pytest.mark.parametrize("method,mode", [("edsr", "mean"), ("hscnn_plus", "median")])
def test_predict_image_matches_jax(tmp_path, method, mode):
    """The JAX ``predict_image`` jits the 8-view ensemble: two small models
    keep its compile short (MST++'s forward is held against JAX in
    ``tests/test_torch_mst_model.py``)."""
    img = str(tmp_path / "demo.jpg")
    cv2.imwrite(img, np.random.default_rng(3).integers(0, 255, (24, 40, 3), dtype=np.uint8))
    sd = zoo.model_generator(method, device="cpu").state_dict()
    ckpt = str(tmp_path / "m.pth")
    torch.save({"state_dict": sd}, ckpt)
    got = ensemble.predict_image(img, method, ckpt, str(tmp_path / "out"), mode, device="cpu")
    want = jensemble.predict_image(img, method, ckpt, None, mode)
    assert got.shape == want.shape == (24, 40, 31)
    assert 0.1 < float(((got > 0) & (got < 1)).mean())  # not all clipped
    assert np.abs(got - want).max() <= 5e-4
    assert np.array_equal(meval.load_mat_cube(str(tmp_path / "out" / "demo.mat")), got)


def test_ensemble_main(tmp_path, capsys):
    img = str(tmp_path / "demo.jpg")
    cv2.imwrite(img, np.random.default_rng(4).integers(0, 255, (16, 24, 3), dtype=np.uint8))
    ensemble.main(["--rgb-path", img, "--method", "edsr", "--ensemble-mode", "median", "--device", "cpu"])
    assert "edsr median-ensemble cube: (16, 24, 31)" in capsys.readouterr().out


def test_load_pretrained_is_the_jax_checkpoint():
    got = quality.load_pretrained("cpu")
    want = from_jax_params(jquality.load_pretrained()[1]["params"])
    assert not any(p.requires_grad for p in got.parameters())
    assert sorted(got.state_dict()) == sorted(want)
    assert all(torch.equal(got.state_dict()[k], v) for k, v in want.items())


def test_fused_vs_f32_psnr_on_the_cpu_matches_jax():
    """On the CPU both packages run one path twice: 120 dB, the cap of an
    MSE of 0 (the card's number comes from ``chip_smoke.py``)."""
    cfg = train.make_optimizer(total_steps=10, warmup=1)
    got = quality.fused_vs_f32_psnr(train.init_state(MSTPlusPlus(stage=1), cfg, device="cpu").model, hw=(24, 40))
    assert got == 120.0
    module = JMSTPlusPlus(stage=1)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    assert jquality.fused_vs_f32_psnr(module, params, hw=(24, 40)) == got


def _linear_apply(rgb):
    """A fixed RGB -> 31-band map, the same on both sides."""
    m = np.linspace(0.1, 1.0, 93, dtype=np.float32).reshape(3, 31)
    return np.asarray(rgb, np.float32) @ m / 3.0 + 0.02


@pytest.mark.parametrize("family", ["synthetic", "xgen"])
def test_eval_protocol_fixtures_match_jax(tmp_path, family):
    port_fn, jax_fn = ((train.synthetic_scenes, jtrain.synthetic_scenes) if family == "synthetic"
                       else (train.xgen_scenes, jtrain.xgen_scenes))
    got = quality.eval_protocol_fixtures(_linear_apply, scene_fn=port_fn, seed=5, device="cpu",
                                         data_root=str(tmp_path / "port"))
    want = jquality.eval_protocol_fixtures(_linear_apply, scene_fn=jax_fn, seed=5, data_root=str(tmp_path / "jax"))
    _close(got, want, rel=1e-4)
    assert sorted(os.listdir(tmp_path / "port" / "Valid_Spec")) == ["ARAD_1K_0000.mat", "ARAD_1K_0001.mat"]


def test_quality_eval_report_matches_jax():
    """The shipped weights through the protocol on both scene families: the
    JAX report's numbers at its rounding (the card's fused-vs-plain number
    is not reported on the CPU, as JAX reports it only off the CPU)."""
    got = quality.quality_eval_report(device="cpu")
    want = jquality.quality_eval_report()
    assert sorted(got) == sorted(want) and got["eval_protocol_weights"] == "pretrained/synth_v1"
    for k, v in want.items():
        if k != "eval_protocol_weights":
            assert abs(got[k] - v) <= (0.0101 if "psnr" in k else 1.01e-4), (k, got[k], v)


def test_quality_reports_compose(monkeypatch):
    """``quality_convergence_report`` and ``quality_report`` put the demo's
    and the checkpoint's numbers together as the JAX reports do (both fed
    the same stub results)."""
    demo = dict(psnr_init=6.2712, psnr_final=15.31888, mrae_init=7.2, mrae_final=0.98, loss_first=1.2,
                loss_last=0.15, steps=40, resumed_step=40)
    evals = {"eval_protocol_weights": "pretrained/synth_v1", "eval_protocol_psnr": 39.08}
    monkeypatch.setattr(train, "convergence_demo", lambda steps, device=None: dict(demo, steps=steps))
    monkeypatch.setattr(jtrain, "convergence_demo", lambda steps: dict(demo, steps=steps))
    monkeypatch.setattr(quality, "quality_eval_report", lambda device=None: dict(evals))
    monkeypatch.setattr(jquality, "quality_eval_report", lambda: dict(evals))
    assert quality.quality_convergence_report(device="cpu") == jquality.quality_convergence_report()
    got = quality.quality_report(device="cpu")
    assert got == jquality.quality_report()
    assert got["convergence_psnr_gain_db"] == round(15.31888 - 6.2712, 2)
