"""The 20 non-UV dichromat mammals: 19 declarative specs plus the cat.

Counterpart of ``animal_vision_tpu/species/nonuv.py``. Each species is a
``NonUVSpec`` row; its chain is normalize -> sRGB->linear -> 3x3 dichromat
matrix -> post-effects -> encode -> dtype restore. uint8 frames run the
chain as one fused kernel (``ops/fused_nonuv.py``); float frames, and
effect stacks without a kernel, compose it from the core ops.

Parity decisions kept from the reference:
- the pig discards its streak-blur and chroma results, so its effects are
  ``enabled=False`` rows and it is matrix-only;
- the cat is the centre-zoomed human baseline plus the binocular FOV warp
  and an explicit-LMS alpha=0.5 merge (not the collapse matrix) and a
  sigma=1.0 blur.

No shape buckets. The JAX package pads odd frame shapes into 64-px buckets
so that XLA compiles one static-shape program per bucket. Here H and W are
run-time arguments of the kernels and the per-row streak and S-cone tables
are run-time operands, so every shape runs as it is. Nor does the streak
kernel need a minimum width: it takes any W >= 1 with general reflect-101.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, color, effects, geometry, linalg
from animal_vision_tpu_torch.ops import fused_nonuv as _fused
from animal_vision_tpu_torch.species.base import Animal, Program


@dataclass(frozen=True)
class Effect:
    kind: str  # 'blur' | 'streak' | 'chroma' | 'scone'
    params: tuple
    enabled: bool = True  # False = present in the reference but a no-op there


@dataclass(frozen=True)
class NonUVSpec:
    name: str
    alpha: float
    s_scale: float
    effects: tuple[Effect, ...] = field(default_factory=tuple)


def specs_from_plain(rows: dict) -> dict[str, NonUVSpec]:
    """Species specs from plain values:
    ``{name: (alpha, s_scale, ((kind, params, enabled), ...))}`` with Python
    or NumPy scalars."""
    return {
        name: NonUVSpec(
            str(name),
            float(alpha),
            float(s_scale),
            tuple(
                Effect(str(kind), tuple(float(p) for p in params), bool(enabled))
                for kind, params, enabled in effs
            ),
        )
        for name, (alpha, s_scale, effs) in rows.items()
    }


# Per-species parameters; each row cites its reference file.
NONUV_SPECS: dict[str, NonUVSpec] = specs_from_plain(
    {
        "dog": (0.58, 0.65, (("blur", (3.5,), True),)),  # animals/dog.py:46,51
        "sheep": (0.74, 1.06, (("streak", (0.48, 0.8, 2.2, 6.0), True),)),  # sheep.py:30,35
        # animals/pig.py:30,35,38 — both effects unassigned in the reference
        "pig": (
            0.89,
            1.32,
            (("streak", (0.5, 1.2, 2.5, 3.0), False), ("chroma", (0.55,), False)),
        ),
        "goat": (0.75, 1.06, (("streak", (0.5, 0.8, 2.4, 8.0), True),)),  # goat.py:29,34
        "cow": (0.84, 1.07, (("streak", (0.5, 0.9, 2.3, 6.5), True),)),  # cow.py:29,34
        "horse": (0.30, 1.02, (("streak", (0.5, 0.8, 2.2, 6.0), True),)),  # horse.py:29,34
        # animals/rabbit.py:29,34,37
        "rabbit": (0.20, 1.01, (("streak", (0.52, 0.9, 2.5, 5.0), True), ("chroma", (0.06,), True))),
        # animals/panda.py:29,34,37
        "panda": (0.58, 0.74, (("streak", (0.52, 1.0, 2.1, 4.5), True), ("chroma", (0.06,), True))),
        "squirrel": (0.55, 1.05, (("blur", (0.7,), True),)),  # squirrel.py:29,34
        "elephant": (0.6, 0.95, (("blur", (1.8,), True),)),  # elephant.py:29,34
        "lion": (0.6, 0.95, (("blur", (1.2,), True),)),  # lion.py:29,34
        "wolf": (0.65, 0.95, (("blur", (1.4,), True),)),  # wolf.py:29,34
        "fox": (0.65, 0.98, (("blur", (1.3,), True),)),  # fox.py:29,34
        "bear": (0.6, 0.95, (("blur", (1.6,), True),)),  # bear.py:29,34
        "raccoon": (0.6, 0.98, (("blur", (2.0,), True),)),  # raccoon.py:29,34
        "deer": (0.6, 0.95, (("streak", (0.5, 0.8, 2.6, 8.0), True),)),  # deer.py:29,34
        "kangaroo": (0.6, 0.98, (("streak", (0.55, 0.8, 2.3, 8.0), True),)),  # kangaroo.py:29,34
        "tiger": (0.6, 0.95, (("blur", (1.2,), True),)),  # tiger.py:29,34
        "rat": (0.05, 0.86, (("scone", (1.3, 0.5, 1.4, 0.25), True),)),  # rat.py:29,34
    }
)


def _apply_effect(img: torch.Tensor, e: Effect) -> torch.Tensor:
    if not e.enabled:
        return img
    if e.kind == "blur":
        return blur.gaussian_blur_hwc(img, e.params[0])
    if e.kind == "streak":
        return blur.streak_blur(img, *e.params)
    if e.kind == "chroma":
        return effects.chroma_compression(img, e.params[0])
    if e.kind == "scone":
        s_top, s_bottom, power, extra = e.params
        return effects.s_cone_vertical_gain(
            img, s_top=s_top, s_bottom=s_bottom, power=power, extra_boost=extra
        )
    raise ValueError(f"unknown effect kind {e.kind!r}")


class NonUVAnimal(Animal):
    """A spec-driven dichromat mammal; the program returns (input frame,
    transformed frame)."""

    def __init__(self, spec: NonUVSpec, device: str | torch.device = "cuda"):
        super().__init__(device)
        self.spec = spec
        self.name = spec.name

    def _fused_program(self, h: int) -> Program | None:
        """The uint8 program through one fused kernel, or None when the
        effect stack has no kernel."""
        spec = self.spec
        active = [e for e in spec.effects if e.enabled]
        kinds = tuple(e.kind for e in active)
        mat = color.collapse_lms_matrix(spec.alpha, spec.s_scale)
        if kinds in ((), ("scone",)):
            mat9 = self._table(mat.reshape(9))
            gain = self._table(_fused.scone_gain(h, active[0].params)) if kinds else None
            return lambda img: (img, _fused.pointwise_u8(img, _fused.scale_of(img), mat9, gain))
        if kinds == ("blur",):
            params = self._table(_fused.iso_params(mat, active[0].params[0]))
            return lambda img: (img, _fused.iso_u8(img, _fused.scale_of(img), params))
        if kinds in (("streak",), ("streak", "chroma")):
            tab, mix, _ = _fused.streak_tables(h, active[0].params, spec.alpha, spec.s_scale)
            tab, mix = self._table(tab), self._table(mix)
            chroma = active[1].params[0] if len(active) == 2 else None
            return lambda img: (img, _fused.streak_u8(img, _fused.scale_of(img), tab, mix, chroma))
        return None

    def _build_program(self, shape, dtype, kernels):
        if kernels and dtype == torch.uint8:
            fused = self._fused_program(shape[0])
            if fused is not None:
                return fused

        spec = self.spec
        matrix = self._table(color.collapse_lms_matrix(spec.alpha, spec.s_scale))

        def fn(image):
            lin = color.srgb_to_linear(color.normalize_image(image))
            out = color.apply_color_matrix(lin, matrix)
            for e in spec.effects:
                out = _apply_effect(out, e)
            return image, color.encode_output(out, dtype)

        return fn


class Cat(Animal):
    """Cat: centre-zoomed human baseline + wide binocular cat view.

    The human branch is center_zoom(original) with the zoom scale from the
    FOV ratio; the cat branch is normalize -> binocular warp (in sRGB 0..1)
    -> linear -> explicit LMS merge alpha=0.5 -> LMS->RGB -> blur sigma=1.0
    -> encode. Both geometry stages are per-axis matrices (the warp's source
    columns and weights depend only on x), applied as float32 products.
    """

    CAMERA_HFOV_DEG = 100.0
    PER_EYE_HALF_FOV_DEG = 105.0
    OVERLAP_DEG = 40.0
    CAT_TO_HUMAN_RATIO = 1.30
    ENABLE_FOV_WARP = True
    BLUR_SIGMA = 1.0

    @staticmethod
    def _merge_matrix() -> np.ndarray:
        """The explicit-LMS merge as one 3x3: pixels @ (A.T Dm.T B.T) ==
        pixels @ M.T with M = B @ Dm @ A (A=RGB->LMS float32, B=LMS->RGB
        float64, the reference's dtypes)."""
        d_merge = np.array(
            [[0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32
        )
        return color.M_LMS_TO_RGB @ d_merge @ color.M_RGB_TO_LMS

    def _build_program(self, shape, dtype, kernels):
        h, w = shape[0], shape[1]
        zoom = geometry.zoom_scale_from_fov_ratio(
            self.CAMERA_HFOV_DEG, self.PER_EYE_HALF_FOV_DEG, self.CAT_TO_HUMAN_RATIO
        )
        is_int = not dtype.is_floating_point
        cw = max(1, int(np.round(w / zoom)))
        ch = max(1, int(np.round(h / zoom)))
        x0, y0 = (w - cw) // 2, (h - ch) // 2
        zoom_rows = self._table(geometry.resize_matrix(ch, h).T)  # (H_out, ch)
        zoom_cols = self._table(geometry.resize_matrix(cw, w))  # (cw, W_out)
        warp_l, warp_r = geometry.binocular_warp_matrices(
            w, w, self.CAMERA_HFOV_DEG, self.PER_EYE_HALF_FOV_DEG, self.OVERLAP_DEG
        )
        warp = self._table(warp_l + warp_r)
        merge = self._merge_matrix().astype(np.float32)
        merge_t = self._table(merge)
        iso_params = self._table(_fused.iso_params(merge, self.BLUR_SIGMA))
        use_kernel = kernels and dtype == torch.uint8

        def fn(image):
            f = image.to(torch.float32)
            crop = f[..., y0 : y0 + ch, x0 : x0 + cw, :]
            zoomed = linalg.apply_w_matrix(linalg.apply_h_matrix(crop, zoom_rows), zoom_cols)
            human = torch.clamp(zoomed + 0.5, 0, 255).to(dtype) if is_int else zoomed.to(dtype)

            if is_int and self.ENABLE_FOV_WARP:
                # The data-dependent 1/255 commutes past the linear warp:
                # warp the raw integers, scale after.
                scale = _fused.scale_of(image).reshape(*image.shape[:-3], 1, 1, 1)
                srgb01 = torch.clamp(linalg.apply_w_matrix(f, warp) * scale, 0.0, 1.0)
            else:
                srgb01 = color.normalize_image(image)
                if self.ENABLE_FOV_WARP:
                    srgb01 = torch.clamp(linalg.apply_w_matrix(srgb01, warp), 0.0, 1.0)

            if use_kernel:
                frames = srgb01.reshape(-1, h, w, 3)
                ones = torch.ones(frames.shape[0], dtype=torch.float32, device=frames.device)
                return human, _fused.iso_u8(frames, ones, iso_params).reshape(image.shape)

            lin = color.srgb_to_linear(srgb01)
            out = blur.gaussian_blur_hwc(color.apply_color_matrix(lin, merge_t), self.BLUR_SIGMA)
            return human, color.encode_output(out, dtype)

        return fn
