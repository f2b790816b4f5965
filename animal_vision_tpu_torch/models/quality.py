"""Quality metrics of the trained MST++.

Counterpart of ``animal_vision_tpu/models/quality.py``:

1. ``convergence_psnr_gain_db``: the held-out PSNR gain of the train ->
   checkpoint -> resume -> eval demo (``train.convergence_demo``);
2. ``fused_vs_f32_psnr_db``: PSNR of the kernel forward against the plain
   forward at the same weights (JAX: the fused Pallas path against the
   float32 XLA path), at 544x960; reported only where a card runs the
   kernels, as the JAX package reports it only off the CPU;
3. ``eval_protocol_{mrae,rmse,psnr}``: the ARAD eval protocol end to end
   (Valid_RGB jpg -> min-max normalize -> model -> 128-pixel centre crop
   against the Valid_Spec ``.mat`` cube) over synthetic fixtures written by
   the ``.mat`` writer and cv2, scored with the shipped ``synth_v1``
   weights; then the same on the held-out ``xgen_scenes`` family. It needs
   cv2 and h5py.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED, MSTPlusPlus, load_state
from animal_vision_tpu_torch.species import resolve_device


def fused_vs_f32_psnr(model: MSTPlusPlus, hw: tuple[int, int] = (544, 960), seed: int = 3) -> float:
    """PSNR (dB, data range 1) of ``model``'s kernel forward (on the CPU:
    its plain versions, so the two are equal and this gives 120) against
    its plain forward, at the same weights, on one ``synthetic_scenes``
    frame on the model's device."""
    from animal_vision_tpu_torch.models.train import synthetic_scenes

    device = next(model.parameters()).device
    rgb, _ = synthetic_scenes(1, hw[0], hw[1], seed, device)[0]
    x = torch.from_numpy(rgb).to(device)[None]
    with torch.no_grad():
        ref = model(x, plain=True).double()
        got = model(x).double()
    mse = float(torch.mean((got - ref) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def eval_protocol_fixtures(
    apply_fn,
    n_scenes: int = 2,
    hw: tuple[int, int] = (288, 320),
    seed: int = 7,
    data_root: str | None = None,
    scene_fn=None,
    device: str | torch.device | None = None,
) -> dict:
    """Write ARAD-layout fixtures (Valid_RGB/*.jpg at quality 97 and
    Valid_Spec/*.mat) of ``scene_fn(n, h, w, seed, device)``'s scenes
    (``train.synthetic_scenes`` by default; ``train.xgen_scenes`` for the
    held-out family) and score ``apply_fn`` through ``iter_dataset`` and
    ``validate`` with the 128-pixel centre crop."""
    from animal_vision_tpu_torch.io.renderer import require_cv2
    from animal_vision_tpu_torch.models import eval as meval

    cv2 = require_cv2()
    if scene_fn is None:
        from animal_vision_tpu_torch.models.train import synthetic_scenes as scene_fn

    with tempfile.TemporaryDirectory(prefix="avt_arad_") as tmp:
        root = data_root or tmp
        os.makedirs(os.path.join(root, "Valid_RGB"), exist_ok=True)
        os.makedirs(os.path.join(root, "Valid_Spec"), exist_ok=True)
        for i, (rgb, hsi) in enumerate(scene_fn(n_scenes, hw[0], hw[1], seed, device)):
            name = f"ARAD_1K_{i:04d}"
            bgr = cv2.cvtColor((rgb * 255.0).round().astype(np.uint8), cv2.COLOR_RGB2BGR)
            cv2.imwrite(os.path.join(root, "Valid_RGB", name + ".jpg"), bgr, [cv2.IMWRITE_JPEG_QUALITY, 97])
            meval.save_mat_cube(os.path.join(root, "Valid_Spec", name + ".mat"), hsi)
        scenes = [(rgb, gt) for _, rgb, gt in meval.iter_dataset(root)]
    return meval.validate(apply_fn, scenes, crop=128)


def load_pretrained(device: str | torch.device | None = None) -> MSTPlusPlus | None:
    """The full 3-stage MST++ with the shipped synthetic-curriculum weights
    (``pretrained/synth_v1.pt``) on ``device`` (the card when None), for
    inference; None if the file is absent."""
    device = resolve_device(device)
    if not SHIPPED.is_file():
        return None
    model = MSTPlusPlus()
    model.load_state_dict(load_state(SHIPPED))
    return model.requires_grad_(False).eval().to(device)


def quality_eval_report(emit=None, device: str | torch.device | None = None) -> dict:
    """The checkpoint's quality numbers, ordered so that a deadline loses
    the least important last: the eval protocol on the shipped weights
    (without them, on a 40-step ``convergence_demo``), then on the held-out
    scene family, then, on the card, the kernel forward against the plain
    one. ``emit(partial_dict)``, when given, is called after each."""
    from animal_vision_tpu_torch.models import eval as meval
    from animal_vision_tpu_torch.models.train import convergence_demo, xgen_scenes

    device = resolve_device(device)
    out: dict = {}

    def _emit():
        if emit is not None:
            emit(dict(out))

    model = load_pretrained(device)
    if model is None:
        model = convergence_demo(steps=40, return_state=True, device=device)["module"].requires_grad_(False)
        out["eval_protocol_weights"] = "convergence_demo_40step"
    else:
        out["eval_protocol_weights"] = "pretrained/synth_v1"
    apply_fn = meval.model_apply_fn(model)

    proto = eval_protocol_fixtures(apply_fn, device=device)
    out.update({"eval_protocol_mrae": round(proto["mrae"], 4), "eval_protocol_rmse": round(proto["rmse"], 4),
                "eval_protocol_psnr": round(proto["psnr"], 2)})
    _emit()

    xg = eval_protocol_fixtures(apply_fn, scene_fn=xgen_scenes, seed=11, device=device)
    out.update({"eval_protocol_mrae_xgen": round(xg["mrae"], 4), "eval_protocol_rmse_xgen": round(xg["rmse"], 4),
                "eval_protocol_psnr_xgen": round(xg["psnr"], 2)})
    _emit()

    if device.type == "cuda":
        out["fused_vs_f32_psnr_db"] = round(fused_vs_f32_psnr(model), 2)
        _emit()
    return out


def quality_convergence_report(steps: int = 40, device: str | torch.device | None = None) -> dict:
    """The train -> checkpoint -> resume -> eval demo's held-out PSNR."""
    from animal_vision_tpu_torch.models.train import convergence_demo

    demo = convergence_demo(steps=steps, device=device)
    return {
        "convergence_psnr_init_db": round(demo["psnr_init"], 2),
        "convergence_psnr_final_db": round(demo["psnr_final"], 2),
        "convergence_psnr_gain_db": round(demo["psnr_final"] - demo["psnr_init"], 2),
    }


def quality_report(steps: int = 40, device: str | torch.device | None = None) -> dict:
    """All the quality numbers, the checkpoint's first."""
    out = quality_eval_report(device=device)
    out.update(quality_convergence_report(steps=steps, device=device))
    return out
