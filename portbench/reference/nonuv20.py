"""Plain reference of the 20 non-UV species (configuration ``nonuv20``).

Each program maps (N, H, W, 3) uint8 frames on a device to (baseline,
transformed) uint8 frames, as the reference application's
``animals/*.py`` compose them: normalise -> sRGB->linear -> the
dichromat matrix -> the species' effects -> encode; the baseline is the
input frame. The cat: the centre-zoomed human baseline, and normalise ->
binocular warp -> linear -> the explicit-LMS merge (alpha 0.5) -> a
sigma-1 blur -> encode. Every table (matrices, taps, streak rows, gain
rows, resize and warp matrices) is worked out here from the parameters in
the configuration's file. float32 throughout; the caller sets the
products' precision (``common.precision``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common as c


def _effect(img: torch.Tensor, kind: str, params, enabled: bool) -> torch.Tensor:
    if not enabled:
        return img
    if kind == "blur":
        return c.gaussian_blur_hwc(img, params[0])
    if kind == "streak":
        return c.streak_blur(img, params)
    if kind == "chroma":
        return c.chroma_compression(img, params[0])
    if kind == "scone":
        return c.s_cone_gain(img, params)
    raise ValueError(f"unknown effect kind {kind!r}")


def species_program(params, device):
    alpha, s_scale, effects = params
    m = c.table(c.collapse_lms_matrix(alpha, s_scale), device)

    def fn(image: torch.Tensor):
        out = c.apply_color_matrix(c.srgb_to_linear(c.normalize_image(image)), m)
        for kind, p, enabled in effects:
            out = _effect(out, kind, p, enabled)
        return image, c.encode_u8(out)

    return fn


def cat_program(cat: dict, h: int, w: int, device):
    zoom = c.zoom_scale(cat["camera_hfov_deg"], cat["per_eye_half_fov_deg"], cat["cat_to_human_ratio"])
    cw, ch = max(1, int(np.round(w / zoom))), max(1, int(np.round(h / zoom)))
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    rows = c.table(c.linear_resize_matrix(ch, h).T, device)  # (H, ch)
    cols = c.table(c.linear_resize_matrix(cw, w), device)  # (cw, W)
    warp = c.table(c.binocular_warp(w, cat["camera_hfov_deg"], cat["per_eye_half_fov_deg"], cat["overlap_deg"]),
                   device)
    d = np.array(cat["merge"], dtype=np.float32)
    merge = c.table(c.M_LMS_TO_RGB @ d @ c.M_RGB_TO_LMS, device)

    def fn(image: torch.Tensor):
        crop = image.to(torch.float32)[..., y0:y0 + ch, x0:x0 + cw, :]
        zoomed = torch.einsum("...wc,wo->...oc", torch.einsum("...hwc,oh->...owc", crop, rows), cols)
        human = torch.clamp(zoomed + 0.5, 0, 255).to(torch.uint8)
        srgb01 = torch.clamp(torch.einsum("...wc,wo->...oc", c.normalize_image(image), warp), 0.0, 1.0)
        out = c.gaussian_blur_hwc(c.apply_color_matrix(c.srgb_to_linear(srgb01), merge), cat["blur_sigma"])
        return human, c.encode_u8(out)

    return fn


def make(config: dict, h: int, w: int, device, state=None) -> dict:
    """``{species: program}`` for frames of (h, w)."""
    progs = {name: species_program(p, device) for name, p in config["params"].items()}
    progs["cat"] = cat_program(config["cat"], h, w, device)
    return {name: progs[name] for name in config["species"]}
