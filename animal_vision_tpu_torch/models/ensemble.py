"""8-way self-ensemble inference and the single-image tool.

Counterpart of ``animal_vision_tpu/models/ensemble.py`` (the reference's
``predict_code/test.py``): ``forward_ensemble`` runs the model on every
combination of a horizontal flip, a vertical flip and a transpose of the
frames, takes each output back through its transform, and reduces the
eight by their mean or median. For "median" ``torch.median`` takes the
lower of the two middle values of the eight, as the reference does and the
JAX package reproduces (``ensemble.py:8-10``). ``predict_image`` reconstructs
one image file and saves the clamped cube as a v7.3 ``.mat`` (cv2 and h5py).

Usage (the card unless ``--device cpu``):
    python -m animal_vision_tpu_torch.models.ensemble --rgb-path img.jpg \
        [--method mst_plus_plus] [--ckpt model.pth] [--outf dir] [--ensemble-mode mean] [--device cpu]
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch


def _transform(data: torch.Tensor, xflip: bool, yflip: bool, transpose: bool, reverse: bool = False) -> torch.Tensor:
    """(B, H, W, C) through the flips and the transpose, or back."""
    if not reverse:
        if xflip:
            data = data.flip(2)
        if yflip:
            data = data.flip(1)
        if transpose:
            data = data.transpose(1, 2)
    else:
        if transpose:
            data = data.transpose(1, 2)
        if yflip:
            data = data.flip(1)
        if xflip:
            data = data.flip(2)
    return data


def forward_ensemble(apply_fn, x: torch.Tensor, ensemble_mode: str = "mean") -> torch.Tensor:
    """x: (B, H, W, 3). Returns the 8-view ensemble (B, H, W, C) of
    ``apply_fn``."""
    if ensemble_mode not in ("mean", "median"):
        raise ValueError(f"ensemble_mode must be 'mean' or 'median', got {ensemble_mode!r}")
    outputs = []
    for xflip, yflip, transpose in itertools.product((False, True), repeat=3):
        y = apply_fn(_transform(x, xflip, yflip, transpose).contiguous())
        outputs.append(_transform(y, xflip, yflip, transpose, reverse=True))
    stack = torch.stack(outputs)
    if ensemble_mode == "mean":
        return stack.mean(dim=0)
    return stack.median(dim=0).values


def predict_image(
    rgb_path: str,
    method: str = "mst_plus_plus",
    pretrained_model_path: str | None = None,
    outf: str | None = None,
    ensemble_mode: str = "mean",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Reconstruct one RGB image (min-max normalized) with the self-ensemble
    on ``device`` (the card when None) and return the cube clamped to
    [0, 1]; with ``outf``, also save it there as ``<stem>.mat``
    (predict_code/test.py:30-49)."""
    from animal_vision_tpu_torch.models.eval import load_rgb_minmax, save_mat_cube
    from animal_vision_tpu_torch.models.zoo import model_generator

    model = model_generator(method, pretrained_model_path, device=device)
    dev = next(model.parameters()).device
    rgb = torch.from_numpy(load_rgb_minmax(rgb_path)).to(dev)[None]
    with torch.no_grad():
        cube = forward_ensemble(model, rgb, ensemble_mode)[0]
    cube = np.clip(cube.cpu().numpy(), 0.0, 1.0)
    if outf:
        os.makedirs(outf, exist_ok=True)
        stem = os.path.splitext(os.path.basename(rgb_path))[0]
        save_mat_cube(os.path.join(outf, stem + ".mat"), cube)
    return cube


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="self-ensemble HSI reconstruction")
    ap.add_argument("--rgb-path", required=True)
    ap.add_argument("--method", default="mst_plus_plus")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--outf", default=None)
    ap.add_argument("--ensemble-mode", default="mean", choices=("mean", "median"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cube = predict_image(args.rgb_path, args.method, args.ckpt, args.outf, args.ensemble_mode, args.device)
    print(f"{args.method} {args.ensemble_mode}-ensemble cube: {cube.shape} "
          f"range [{cube.min():.4f}, {cube.max():.4f}]")


if __name__ == "__main__":
    main()
