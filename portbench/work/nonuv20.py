"""Work of one call of a non-UV species: the least time the card could
take.

Bytes are each input frame read once and each output frame written once
(a baseline that is the input frame is not written), plus the tables.
Operations follow the species' parameters, per pixel: decode and the 3x3
matrix (18), the separable blur's taps (12 per tap of the kernel size),
the streak's per-row taps (3 (1 + 3 r) for a row of radius r) and channel
mix, the chroma lerp (9), the S-cone gain row (1) and the encode (6); the
arithmetic of ``chip_smoke.py:kernel_cases``, frozen here. The cat's
geometry counts the taps its warp needs: two bilinear taps per axis for
the zoom of the centre crop, and the warp matrix's nonzeros per output
column (each eye's two bilinear taps under its blend), not the dense
products the port runs. The least time is max(bytes / 3.35 TB/s,
operations / 67 TFLOP/s).
"""

from __future__ import annotations

import functools

import numpy as np

from portbench import peaks
from portbench.reference import common as c


@functools.lru_cache(maxsize=None)
def _warp_nnz(w: int, cat: tuple) -> int:
    fov, half, overlap = cat
    return int(np.count_nonzero(c.binocular_warp(w, fov, half, overlap)))


def counts(species: str, n: int, h: int, w: int, config: dict) -> dict:
    """``{"bytes": ..., "ops": ...}`` of one call on ``n`` (h, w) uint8 frames."""
    px = n * h * w
    io = px * 3 * 2
    if species == "cat":
        cat = config["cat"]
        nnz = _warp_nnz(w, (cat["camera_hfov_deg"], cat["per_eye_half_fov_deg"], cat["overlap_deg"]))
        k = c.cv2_auto_ksize(cat["blur_sigma"])
        cw = max(1, int(np.round(w / c.zoom_scale(cat["camera_hfov_deg"], cat["per_eye_half_fov_deg"],
                                                  cat["cat_to_human_ratio"]))))
        zoom = n * 3 * (h * cw * 2 * 2 + h * w * 2 * 2 + h * w * 2)  # H pass on the crop, W pass, round and clip
        warp = n * 3 * (h * nnz * 2 + h * w * 3)  # the warp's taps, the 1/255 and the clip
        iso = px * (18 + 12 * k + 6)
        tables = 8 * (2 * h + 2 * w + nnz) + 4 * (9 + k)
        return {"bytes": px * 3 * 3 + tables, "ops": zoom + warp + iso}
    _, _, effects = config["params"][species]
    active = [(kind, p) for kind, p, enabled in effects if enabled]
    kinds = tuple(kind for kind, _ in active)
    if kinds in ((), ("scone",)):
        scone = bool(kinds)
        return {"bytes": io + 36 + (h * 4 if scone else 0), "ops": px * (18 + (1 if scone else 0) + 6)}
    if kinds == ("blur",):
        k = c.cv2_auto_ksize(active[0][1][0])
        return {"bytes": io + (9 + k) * 4, "ops": px * (18 + 12 * k + 6)}
    if kinds in (("streak",), ("streak", "chroma")):
        sx, sy = c.streak_sigma_map(h, *active[0][1])
        radii = np.array([c.cv2_auto_ksize(float(a)) // 2 + c.cv2_auto_ksize(float(b)) // 2
                          for a, b in zip(sx, sy)])
        row_ops = 3 * (1 + 3 * radii) + 18 + (9 if len(kinds) == 2 else 0) + 6
        return {"bytes": io + (h * (int(radii.max()) + 1) + h * 9) * 4, "ops": int(n * w * row_ops.sum())}
    raise ValueError(f"no work count for the effects {kinds} of {species}")


def per_call(species: str, n: int, h: int, w: int, config: dict) -> dict:
    k = counts(species, n, h, w, config)
    return {"least_s": max(k["bytes"] / peaks.HBM_BYTES_PER_S, k["ops"] / peaks.F32_FLOPS)}
