"""ARAD_1K / NTIRE-2022 dataset access with the reference harness's
semantics.

Counterpart of ``animal_vision_tpu/models/data.py`` (the reference's
``test_develop_code/hsi_dataset.py``), NumPy only, with the same random
draws, so that both packages cut the same patches bit for bit:

- training patches lie on a deterministic strided grid over each scene
  (stride 8, ``patch_per_line = (W - crop) // stride + 1``; :7-18), each
  taken through random rot90 / vertical-flip / horizontal-flip counts
  (:52-63, drawn as in :72-75);
- RGB frames are min-max normalized per image (:43) and ``.mat`` cubes are
  loaded from the v7.3 ``cube`` variable transposed (:33-35);
- ``patch_batches`` yields (B, P, P, C) float32 batches, one epoch of the
  grid, for one train step each.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from animal_vision_tpu_torch.models.eval import load_mat_cube, load_rgb_minmax


def _read_split(data_root: str, name: str) -> list[str]:
    path = os.path.join(data_root, "split_txt", f"{name}_list.txt")
    with open(path) as fin:
        stems = [line.strip() for line in fin if line.strip()]
    return sorted(stems)


@dataclass
class Scene:
    rgb: np.ndarray  # (H, W, 3) float32, min-max normalized
    hsi: np.ndarray  # (H, W, 31) float32


def load_scene(data_root: str, stem: str) -> Scene:
    """Both splits load from the Train_* folders (the valid scenes live
    there too; hsi_dataset.py:87-88)."""
    rgb = load_rgb_minmax(os.path.join(data_root, "Train_RGB", stem + ".jpg"))
    hsi = load_mat_cube(os.path.join(data_root, "Train_Spec", stem + ".mat"))
    return Scene(rgb=np.float32(rgb), hsi=np.float32(hsi))


def iter_scenes(data_root: str, split: str = "train"):
    for stem in _read_split(data_root, split):
        yield stem, load_scene(data_root, stem)


def patch_grid(h: int, w: int, crop: int, stride: int = 8):
    """The reference's deterministic patch lattice (hsi_dataset.py:14-18):
    one (y, x) origin per (row, col) of the stride grid."""
    per_line = (w - crop) // stride + 1
    per_col = (h - crop) // stride + 1
    for hi in range(per_col):
        for wi in range(per_line):
            yield hi * stride, wi * stride


def augment(rgb: np.ndarray, hsi: np.ndarray, rng: np.random.Generator):
    """arguement() parity: up to three rot90s (``randint(0, 3)`` is
    inclusive), then a vertical and a horizontal flip, each drawn
    (hsi_dataset.py:52-63, 72-78)."""
    rot = int(rng.integers(0, 4))
    vflip = int(rng.integers(0, 2))
    hflip = int(rng.integers(0, 2))
    for _ in range(rot):
        rgb, hsi = np.rot90(rgb), np.rot90(hsi)
    if vflip:
        rgb, hsi = rgb[:, ::-1], hsi[:, ::-1]
    if hflip:
        rgb, hsi = rgb[::-1], hsi[::-1]
    return np.ascontiguousarray(rgb), np.ascontiguousarray(hsi)


def patch_batches(
    scenes: list[Scene],
    crop: int = 128,
    stride: int = 8,
    batch: int = 20,
    seed: int = 0,
    shuffle: bool = True,
):
    """Yield (rgb, hsi) batches of augmented patches covering the
    reference's strided grid over every scene (one epoch). The last batch
    may be smaller, so that the epoch covers the whole grid."""
    rng = np.random.default_rng(seed)
    index = []
    for si, sc in enumerate(scenes):
        h, w = sc.rgb.shape[:2]
        index.extend((si, y, x) for y, x in patch_grid(h, w, crop, stride))
    order = np.arange(len(index))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch):
        rs, hs = [], []
        for oi in order[start : start + batch]:
            si, y, x = index[oi]
            sc = scenes[si]
            r, s = augment(sc.rgb[y : y + crop, x : x + crop], sc.hsi[y : y + crop, x : x + crop], rng)
            rs.append(r)
            hs.append(s)
        yield np.stack(rs), np.stack(hs)
