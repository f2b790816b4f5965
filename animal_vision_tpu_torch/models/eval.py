"""ARAD_1K evaluation harness: MRAE / RMSE / PSNR over validation scenes.

Counterpart of ``animal_vision_tpu/models/eval.py`` (the reference's
``test_develop_code/test.py:46-86``): per scene, RGB -> model -> compare
with the ground-truth ``cube`` on the 128-pixel centre crop, averaged over
the scenes; RGB frames min-max normalized per scene, float32
(``hsi_dataset.py:68-122``). ``.mat`` cubes are read with h5py (MATLAB
v7.3, the ARAD format) or scipy.io for older files, and written as v7.3.
h5py and cv2 are imported inside the functions that use them; a missing
one raises an ImportError that names it.

Usage (the card unless ``--device cpu``):
    python -m animal_vision_tpu_torch.models.eval --data-root <dir> \\
        [--method mst_plus_plus] [--ckpt model.pth] [--split-txt valid_list.txt] \\
        [--save-dir <dir>] [--device cpu]

Expects <dir>/Valid_RGB/*.jpg and <dir>/Valid_Spec/*.mat (ARAD layout).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from animal_vision_tpu_torch.io.renderer import require_cv2
from animal_vision_tpu_torch.models import metrics


def require_h5py():
    """The h5py module, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError("h5py is required to read and write MATLAB v7.3 .mat cubes; it is not installed") from err
    return h5py


def load_mat_cube(path: str, key: str = "cube") -> np.ndarray:
    """(H, W, B) float32 cube from a MATLAB file (v7.3 via h5py, stored
    transposed as (B, W, H); a legacy file via scipy.io)."""
    h5py = require_h5py()
    try:
        with h5py.File(path, "r") as f:
            arr = np.asarray(f[key])
        return np.transpose(arr, (2, 1, 0)).astype(np.float32)
    except OSError:
        from scipy.io import loadmat

        return np.asarray(loadmat(path)[key], dtype=np.float32)


def save_mat_cube(path: str, cube: np.ndarray, key: str = "cube") -> None:
    """Save (H, W, B) as a MATLAB v7.3 file, as the reference saves its
    outputs (``save_matv73``, test.py:80-85): HDF5 with a 512-byte user
    block whose bytes 124-127 are the version and endian marker
    ``\\x00\\x02IM`` and a ``MATLAB_class`` attribute on the dataset, both of
    which MATLAB's ``load`` needs."""
    h5py = require_h5py()
    data = np.transpose(cube, (2, 1, 0))
    mat_class = {"float32": b"single", "float64": b"double"}.get(str(data.dtype), b"double")
    with h5py.File(path, "w", userblock_size=512) as f:
        ds = f.create_dataset(key, data=data)
        ds.attrs.create("MATLAB_class", np.bytes_(mat_class))
    header = (
        b"MATLAB 7.3 MAT-file, Platform: posix, "
        b"Created by: animal_vision_tpu "
        b"HDF5 schema 1.00 ."
    )[:116].ljust(116) + b" " * 8 + b"\x00\x02IM"
    with open(path, "r+b") as f:
        f.write(header.ljust(512, b"\x00"))


def load_rgb_minmax(path: str) -> np.ndarray:
    """A scene's RGB, min-max normalized per scene, float32
    (``hsi_dataset.py:96-104``)."""
    cv2 = require_cv2()
    bgr = cv2.imread(path)
    if bgr is None:
        raise FileNotFoundError(path)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32)
    return (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-8)


def _scores(p: np.ndarray, g: np.ndarray) -> dict:
    pt, gt = torch.tensor(p[None], dtype=torch.float32), torch.tensor(g[None], dtype=torch.float32)
    return {"mrae": float(metrics.mrae(pt, gt)), "rmse": float(metrics.rmse(pt, gt)),
            "psnr": float(metrics.psnr(pt, gt, data_range=255.0))}


def _to_numpy(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y, dtype=np.float32)


def validate(apply_fn, scenes: list[tuple[np.ndarray, np.ndarray]], crop: int = 128,
             awan_protocol: bool = False) -> dict:
    """Average MRAE / RMSE / PSNR of ``apply_fn(rgb) -> cube`` (a tensor on
    any device, or an array) over (rgb, gt) scenes with the reference's
    centre-crop protocol, scored on the CPU by ``models/metrics.py``.
    ``crop=0``, or a crop that would leave nothing, compares whole scenes.
    ``awan_protocol`` reproduces test.py:56-60: the input is cropped
    [118:-118] and the output a further [10:-10], against gt[128:-128]."""
    sums = {"mrae": 0.0, "rmse": 0.0, "psnr": 0.0}
    for rgb, gt in scenes:
        if awan_protocol and min(rgb.shape[:2]) > 2 * crop:
            pred = _to_numpy(apply_fn(rgb[118:-118, 118:-118]))
            scores = _scores(pred[10:-10, 10:-10], gt[crop:-crop, crop:-crop])
        else:
            pred = _to_numpy(apply_fn(rgb))
            # crop=0 means no crop ([0:-0] would slice to nothing)
            p = pred[crop:-crop, crop:-crop] if 0 < 2 * crop < min(pred.shape[:2]) else pred
            g = gt[crop:-crop, crop:-crop] if 0 < 2 * crop < min(gt.shape[:2]) else gt
            scores = _scores(p, g)
        for k in sums:
            sums[k] += scores[k]
    n = max(1, len(scenes))
    return {k: v / n for k, v in sums.items()}


def iter_dataset(data_root: str, split_txt: str | None = None):
    """Yield (name, rgb, gt) per validation scene (ARAD layout)."""
    rgb_dir = os.path.join(data_root, "Valid_RGB")
    spec_dir = os.path.join(data_root, "Valid_Spec")
    if split_txt and os.path.exists(split_txt):
        with open(split_txt) as fin:
            names = [line.strip() for line in fin if line.strip()]
    else:
        names = sorted(os.path.splitext(f)[0] for f in os.listdir(spec_dir) if f.endswith(".mat"))
    for name in names:
        rgb = load_rgb_minmax(os.path.join(rgb_dir, name + ".jpg"))
        gt = load_mat_cube(os.path.join(spec_dir, name + ".mat"))
        yield name, rgb, gt


def model_apply_fn(model: torch.nn.Module):
    """``rgb (H, W, 3) array -> (H, W, C) tensor`` of one inference forward
    on the model's device (on the card: the kernels)."""
    device = next(model.parameters()).device

    def apply_fn(rgb):
        with torch.no_grad():
            return model(torch.tensor(np.asarray(rgb), dtype=torch.float32, device=device)[None])[0]

    return apply_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ARAD_1K HSI reconstruction eval")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--method", default="mst_plus_plus")
    ap.add_argument("--ckpt", default=None, help="reference-layout .pth, else seeded weights")
    ap.add_argument("--split-txt", default=None)
    ap.add_argument("--save-dir", default=None, help="save predictions as v7.3 .mat")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from animal_vision_tpu_torch.models.zoo import model_generator

    apply_fn = model_apply_fn(model_generator(args.method, args.ckpt, device=args.device))
    named = list(iter_dataset(args.data_root, args.split_txt))
    if args.save_dir:
        # test.py:80-85: every scene's prediction saved as v7.3 .mat, clipped to [0, 1]
        os.makedirs(args.save_dir, exist_ok=True)
        for name, rgb, _ in named:
            pred = np.clip(_to_numpy(apply_fn(rgb)), 0.0, 1.0)
            save_mat_cube(os.path.join(args.save_dir, name + ".mat"), pred)
    scenes = [(rgb, gt) for _, rgb, gt in named]
    result = validate(apply_fn, scenes, awan_protocol=(args.method == "awan"))
    print(
        f"{args.method}: MRAE {result['mrae']:.4f}  RMSE {result['rmse']:.4f}  "
        f"PSNR {result['psnr']:.2f} dB over {len(scenes)} scenes"
    )


if __name__ == "__main__":
    main()
