"""The port's evaluation, data loading, checkpoints and export
(``models/{eval,data,export}.py``) against the JAX package's, on the CPU
(cv2 and h5py are imported here; the port imports them only inside the
functions that use them). The quality report and ``predict_image`` are in
``tests/test_torch_quality.py``.

Bars: ``validate`` within 1e-5 relative of JAX on the same predictions;
``.mat`` files written by either package read equal by the other; the
checkpoint round trip and the resumed run exact; the exported program
within 1e-5 of max |y| of the model at 32x32; ``--to-torch`` within 1e-7 of
the JAX ``export_torch_state``; the entry points need a card by default.
"""

import os

import cv2
import h5py
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import data as jdata
from animal_vision_tpu.models import eval as jeval
from animal_vision_tpu.models import quality as jquality
from animal_vision_tpu.models.mst_plus_plus import export_torch_state
from animal_vision_tpu_torch.models import data, ensemble, export, quality, train, zoo
from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_shipped

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got: dict, want: dict, rel: float = REL) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= rel * max(abs(float(want[k])), 1e-12), (k, got[k], want[k])


def _scenes(rng, n, h, w):
    return [(rng.uniform(0, 1, (h, w, 3)).astype(np.float32), rng.uniform(0.05, 1, (h, w, 31)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("crop,hw", [(0, (40, 52)), (128, (300, 310)), (128, (40, 52)), (8, (40, 52))])
def test_validate_matches_jax(crop, hw):
    rng = np.random.default_rng(crop + hw[0])
    scenes = _scenes(rng, 3, *hw)
    preds = [np.clip(gt + rng.normal(0, 0.05, gt.shape).astype(np.float32), 0, 1.2) for _, gt in scenes]
    got = meval.validate(lambda rgb, it=iter(preds): torch.from_numpy(next(it)), scenes, crop=crop)
    want = jeval.validate(lambda rgb, it=iter(preds): next(it), scenes, crop=crop)
    _close(got, want)


def test_validate_awan_protocol_matches_jax():
    rng = np.random.default_rng(2)
    scenes = _scenes(rng, 2, 300, 300)
    preds = [gt[118:-118, 118:-118] + rng.normal(0, 0.02, (64, 64, 31)).astype(np.float32) for _, gt in scenes]

    def apply(it):
        def fn(rgb):
            assert rgb.shape == (64, 64, 3)  # 300 - 2 * 118
            return next(it)
        return fn

    got = meval.validate(apply(iter(preds)), scenes, crop=128, awan_protocol=True)
    want = jeval.validate(apply(iter(preds)), scenes, crop=128, awan_protocol=True)
    _close(got, want)
    perfect = meval.validate(lambda rgb, it=iter([g[118:-118, 118:-118] for _, g in scenes]): next(it), scenes,
                             crop=128, awan_protocol=True)
    assert perfect["mrae"] == 0.0 and perfect["rmse"] == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mat_files_cross_read(tmp_path, dtype):
    cube = np.random.default_rng(0).uniform(0, 1, (17, 23, 31)).astype(dtype)
    for writer, reader, name in ((meval.save_mat_cube, jeval.load_mat_cube, "port.mat"),
                                 (jeval.save_mat_cube, meval.load_mat_cube, "jax.mat")):
        path = str(tmp_path / name)
        writer(path, cube)
        assert np.array_equal(reader(path), cube.astype(np.float32))
        with open(path, "rb") as f:
            head = f.read(512)
        assert head.startswith(b"MATLAB 7.3 MAT-file") and head[124:128] == b"\x00\x02IM"
        with h5py.File(path, "r") as f:
            assert bytes(f["cube"].attrs["MATLAB_class"]) == (b"single" if dtype == np.float32 else b"double")
    with open(tmp_path / "port.mat", "rb") as a, open(tmp_path / "jax.mat", "rb") as b:
        assert a.read(512) == b.read(512)


def _arad_tree(root, rng, stems=("scene_a", "scene_b"), hw=(40, 48)):
    for sub in ("split_txt", "Train_RGB", "Train_Spec", "Valid_RGB", "Valid_Spec"):
        (root / sub).mkdir(exist_ok=True)
    for stem in stems:
        img = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
        cube = rng.uniform(0.05, 1, (*hw, 31)).astype(np.float32)
        for kind in ("Train", "Valid"):
            cv2.imwrite(str(root / f"{kind}_RGB" / f"{stem}.jpg"), img)
            meval.save_mat_cube(str(root / f"{kind}_Spec" / f"{stem}.mat"), cube)
    (root / "split_txt" / "train_list.txt").write_text("\n".join(reversed(stems)) + "\n")


def test_loaders_equal_jax(tmp_path):
    _arad_tree(tmp_path, np.random.default_rng(1))
    got = list(data.iter_scenes(str(tmp_path), "train"))
    want = list(jdata.iter_scenes(str(tmp_path), "train"))
    assert [s for s, _ in got] == [s for s, _ in want] == ["scene_a", "scene_b"]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a.rgb, b.rgb) and np.array_equal(a.hsi, b.hsi)
    got = list(meval.iter_dataset(str(tmp_path)))
    want = list(jeval.iter_dataset(str(tmp_path)))
    for (n, r, g), (jn, jr, jg) in zip(got, want, strict=True):
        assert n == jn and np.array_equal(r, jr) and np.array_equal(g, jg)
    assert 0.0 == got[0][1].min() and got[0][1].max() == 1.0


def test_eval_main_matches_jax(tmp_path, capsys):
    """``python -m ...models.eval`` on an ARAD tree with a reference
    checkpoint: the same scores as the JAX command, and the saved
    predictions clipped to [0, 1]."""
    _arad_tree(tmp_path, np.random.default_rng(2), hw=(24, 32))
    ckpt = str(tmp_path / "m.pth")
    torch.save({"state_dict": zoo.model_generator("hscnn_plus", device="cpu").state_dict()}, ckpt)
    meval.main(["--data-root", str(tmp_path), "--method", "hscnn_plus", "--ckpt", ckpt,
                "--save-dir", str(tmp_path / "out"), "--device", "cpu"])
    got = capsys.readouterr().out.split()
    jeval.main(["--data-root", str(tmp_path), "--method", "hscnn_plus", "--ckpt", ckpt])
    want = capsys.readouterr().out.split()
    assert got[0] == want[0] == "hscnn_plus:" and got[-2:] == want[-2:] == ["2", "scenes"]
    for i in (2, 4, 6):  # MRAE, RMSE, PSNR at the printed rounding
        assert abs(float(got[i]) - float(want[i])) <= 1.01e-4 * (100 if i == 6 else 1), (got, want)
    cube = meval.load_mat_cube(str(tmp_path / "out" / "scene_a.mat"))
    assert cube.shape == (24, 32, 31) and 0.0 <= cube.min() and cube.max() <= 1.0


def _trained(steps=3, seed=0):
    cfg = train.make_optimizer(lr=2e-3, total_steps=12, warmup=1)
    state = train.init_state(MSTPlusPlus(stage=1), cfg, seed=seed, device="cpu")
    scenes = train.synthetic_scenes(2, 48, 48, seed, device="cpu")
    rng = np.random.default_rng(seed)
    batches = [train.sample_patches(rng, *scenes[i % 2], 16, 2) for i in range(8)]
    step = train.make_train_step("l1")
    for rgb, hsi in batches[:steps]:
        state, _ = step(state, rgb, hsi)
    return state, cfg, batches, step


def test_checkpoint_round_trip_and_resume_exact(tmp_path):
    state, cfg, batches, step = _trained()
    path = str(tmp_path / "ckpt" / "mid.pt")
    export.save_checkpoint(path, state)
    assert os.listdir(tmp_path / "ckpt") == ["mid.pt"]  # the temporary file was renamed
    fresh = MSTPlusPlus(stage=1)
    back = export.load_checkpoint(path, train.TrainState(fresh, *cfg.build(fresh.parameters())))
    assert back.step == state.step == 3
    assert back.scheduler.state_dict() == state.scheduler.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), back.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        assert all(torch.equal(s[k], b["state"][i][k]) for k in s)
    for rgb, hsi in batches[3:6]:
        state, ma = step(state, rgb, hsi)
        back, mb = step(back, rgb, hsi)
        assert torch.equal(ma["loss"], mb["loss"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_model_checkpoint_round_trip(tmp_path):
    model = load_shipped("cpu")
    path = str(tmp_path / "m.pt")
    export.save_checkpoint(path, model)
    back = export.load_checkpoint(path, MSTPlusPlus())
    assert all(torch.equal(back.state_dict()[k], v) for k, v in model.state_dict().items())
    cfg = train.make_optimizer(total_steps=10, warmup=1)
    with pytest.raises(ValueError, match="model's state only"):
        export.load_checkpoint(path, train.TrainState(MSTPlusPlus(), *cfg.build(MSTPlusPlus().parameters())))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``python -m ...models.export --to-torch`` of the shipped weights (whose
    four up-conv bias copies have diverged) at 1 x 32x32, once: (output
    folder, printed line, the model, the model's forward at 32x32 before
    the export, its input)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("export")
    model = load_shipped("cpu")
    ckpt = str(root / "synth_v1.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        before = model(x)  # fills the eager forward's weight cache
    out, printed = root / "out", io.StringIO()
    with contextlib.redirect_stdout(printed):
        export.main(["--out", str(out), "--ckpt", ckpt, "--height", "32", "--width", "32", "--to-torch",
                     "--device", "cpu"])
    return out, printed.getvalue(), model, before, x


def test_exported_program_matches_the_model(exported):
    """The ``torch.export`` program traces the plain versions on the live
    parameters, not the weight cache: loaded back, it is within 1e-5 of
    max |y| of the model, and the model's own forward, whose cache was
    filled before the export, is unchanged after."""
    out, printed, model, want, x = exported
    blob = (out / "mst_plus_plus_32x32.pt2").read_bytes()
    assert f"{len(blob)} bytes torch.export program" in printed
    fn = export.load_program(blob)
    with torch.no_grad():
        got = fn(x)
        assert torch.equal(model(x), want)
    assert got.shape == want.shape == (1, 32, 32, 31)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    back = export.load_checkpoint(str(out / "mst_plus_plus.ckpt.pt"), MSTPlusPlus())
    assert all(torch.equal(back.state_dict()[k], v) for k, v in model.state_dict().items())


def test_export_main_to_torch_matches_jax(exported):
    """``--to-torch``: the reference layout with each up-conv's four bias
    copies averaged, as the JAX ``export_torch_state`` of the same weights."""
    got = torch.load(exported[0] / "mst_plus_plus.pth", weights_only=True)["state_dict"]
    with pytest.warns(UserWarning, match="diverged"):
        want = export_torch_state(jquality.load_pretrained()[1])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert float(np.abs(got[k].numpy() - v).max()) <= 1e-7, k


def test_entry_points_need_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = str(tmp_path / "demo.jpg")
    cv2.imwrite(img, np.zeros((8, 8, 3), np.uint8))
    for fn in (quality.load_pretrained, lambda: ensemble.predict_image(img),
               lambda: quality.quality_convergence_report(steps=4),
               lambda: export.main(["--out", str(tmp_path / "x")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
