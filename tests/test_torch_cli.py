"""The port's CLI (``python -m animal_vision_tpu_torch.cli``) on the CPU
against the JAX package's: ``image`` within 1 LSB, ``video`` >= 40 dB frame
by frame (both are mp4v encodes), ``gallery`` writes its grid, the menus
and fuzzy filter equal JAX's, ``--morpho-gate`` reaches the port's morpho,
and without ``--device`` and a card the command raises."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from animal_vision_tpu import cli as jcli
from animal_vision_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def tmp_image(tmp_path, img_u8):
    p = tmp_path / "in.png"
    cv2.imwrite(str(p), cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
    return str(p)


@pytest.fixture()
def tmp_video(tmp_path, img_u8):
    p = tmp_path / "in.mp4"
    w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    for i in range(8):
        w.write(cv2.cvtColor(np.roll(img_u8, i * 3, axis=1), cv2.COLOR_RGB2BGR))
    w.release()
    return str(p)


def _read_video(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.mark.parametrize("animal", ["dog", "cat"])
def test_cli_image_vs_jax(tmp_image, tmp_path, animal):
    got, want = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    cli.main(["--device", "cpu", "image", "--input", tmp_image, "--output", got, "--animal", animal, "--no-show"])
    jcli.main(["image", "--input", tmp_image, "--output", want, "--animal", animal, "--no-show"])
    a, b = cv2.imread(got), cv2.imread(want)
    assert a.shape == b.shape == (64, 96, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("full_frame", [False, True])
def test_cli_video_vs_jax(tmp_video, tmp_path, psnr_fn, full_frame):
    got, want = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    extra = ["--full-frame"] if full_frame else []
    cli.main(["--device", "cpu", "video", "--input", tmp_video, "--output", got, "--animal", "rat", "--no-show",
              "--batch", "3", *extra])
    jcli.main(["video", "--input", tmp_video, "--output", want, "--animal", "rat", "--no-show", "--batch", "3",
               *extra])
    a, b = _read_video(got), _read_video(want)
    assert len(a) == len(b) == 8
    for i, (fa, fb) in enumerate(zip(a, b)):
        assert psnr_fn(fa / 255.0, fb / 255.0) >= 40.0, i


def test_cli_gallery(tmp_image, tmp_path, monkeypatch):
    from animal_vision_tpu_torch.species import NON_UV_NAMES

    monkeypatch.chdir(tmp_path)
    cli.main(["--device", "cpu", "gallery", "--input", tmp_image, "--group", "nonuv", "--tile-height", "48",
              "--max-side", "64"])
    grid = cv2.imread(str(tmp_path / "output" / "gallery_NonUV.png"))
    # 20 tiles, 5 per row: the 64x96 frame cut to 42x64, each tile resized to
    # 48x73 above a 28-row label strip
    assert len(NON_UV_NAMES) == 20
    assert grid.shape == (4 * (48 + 28), 5 * 73, 3)
    assert not (tmp_path / "output" / "gallery_UV.png").exists()


def test_fuzzy_filter_and_menu_equal_jax(monkeypatch, capsys):
    opts = ["dog", "goldfish", "dragonfly", "jumping_spider", "goat", "Mantis Shrimp", "rat_uv", "rat"]
    for q in ["dg", "gf", "zzz", "", "d", "RAT", "ms", "r_u", "tt"]:
        assert cli.fuzzy_filter(q, opts) == jcli.fuzzy_filter(q, opts), q
    for feed in (["dgf"], ["gf", "2"], ["goat"], ["zzz", "9", "1"], ["", "rat"], ["ra", "x", "rat_"]):
        picks = []
        for menu in (cli._menu, jcli._menu):
            it = iter(feed)
            monkeypatch.setattr("builtins.input", lambda *a, it=it: next(it))
            picks.append(menu("t", opts))
        out = capsys.readouterr().out
        assert picks[0] == picks[1], (feed, picks)
        half = len(out) // 2
        assert out[:half] == out[half:]  # the same prompts and lists, printed twice


def test_cli_morpho_gate_reaches_morpho(tmp_image, tmp_path, monkeypatch):
    import animal_vision_tpu_torch.species as sp

    monkeypatch.setenv("ANIMAL_VISION_MORPHO_GATE", "")  # restored (unset) after the test
    monkeypatch.delitem(sp._CACHE, ("morpho", "cpu"), raising=False)
    out = str(tmp_path / "morpho.png")
    cli.main(["--morpho-gate", "1e-2", "--device", "cpu", "image", "--input", tmp_image, "--output", out,
              "--animal", "morpho", "--no-show"])
    assert os.path.exists(out)
    assert sp._CACHE[("morpho", "cpu")].orientation_gate == pytest.approx(1e-2)
    flat = np.full((40, 64, 3), 128, np.uint8)
    _, a = sp._CACHE[("morpho", "cpu")].visualize(flat)
    _, b = sp._CACHE[("morpho", "cpu")].visualize(flat + 0)
    assert np.array_equal(a, b)
    sp._CACHE.pop(("morpho", "cpu"))


@pytest.mark.parametrize("command", ["image", "video", "gallery"])
def test_default_device_without_card_raises(tmp_image, tmp_video, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_video if command == "video" else tmp_image
    args = [command, "--input", src] + (["--animal", "dog", "--output", src + ".out", "--no-show"]
                                        if command != "gallery" else [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(args)


def test_module_entry_point_without_card(tmp_image):
    out = subprocess.run([sys.executable, "-m", "animal_vision_tpu_torch.cli", "image", "--input", tmp_image,
                          "--animal", "dog", "--output", tmp_image + ".out.png", "--no-show"], cwd=REPO,
                         capture_output=True, text=True, timeout=240, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "device='cpu'" in out.stderr
