"""Model packaging: checkpoints and a portable compiled artifact.

Counterpart of ``animal_vision_tpu/models/export.py``:

- **checkpoints**: ``torch.save`` of a ``train.TrainState`` (the model's,
  the optimizer's and the schedule's state and the step) or of a model's
  state alone, written to a temporary file and renamed into place, and
  restored into a template exactly (the JAX package's Orbax checkpoints);
- **the compiled artifact**: ``torch.export`` of the forward at a fixed
  input shape with the weights in it, saved with ``torch.export.save`` (the
  JAX package's StableHLO export). It holds the plain versions of the
  kernels (a traced forward cannot launch them); MST++ is traced on its
  live parameters, not through the kernels' weight cache;
- **``--to-torch``**: a reference-layout ``.pth`` of MST++, each
  up-convolution's four bias copies collapsed to their mean, as the JAX
  ``export_torch_state`` writes it (the reference's ONNX tooling reads it;
  there is no ONNX here: the onnx package is absent).

Usage (the card unless ``--device cpu``):
    python -m animal_vision_tpu_torch.models.export --out dir \\
        [--method mst_plus_plus] [--ckpt model.pth] [--height 256 --width 256] [--to-torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import os
import tempfile

import torch
from torch import nn

from animal_vision_tpu_torch.models.train import TrainState


def save_checkpoint(path: str, state) -> None:
    """Write a ``TrainState`` (or an ``nn.Module``'s state alone) to
    ``path``: ``torch.save`` into a temporary file beside it, then an
    atomic rename, so a reader never sees half a checkpoint."""
    if isinstance(state, TrainState):
        blob = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(), "step": int(state.step)}
    else:
        blob = {"model": state.state_dict()}
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(blob, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, template):
    """Restore ``path`` into ``template`` (a ``TrainState`` with a model,
    optimizer and schedule over the same parameters, or an ``nn.Module``)
    and return it. Tensors load onto the template model's device."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(template, TrainState):
        template.load_state_dict(blob["model"])
        return template
    if "optimizer" not in blob:
        raise ValueError(f"{path} holds a model's state only, not a training state")
    template.model.load_state_dict(blob["model"])
    template.optimizer.load_state_dict(blob["optimizer"])
    template.scheduler.load_state_dict(blob["scheduler"])
    template.step = int(blob["step"])
    return template


class _PlainForward(nn.Module):
    """``model(x, plain=True)``: the zoo's forwards with the kernels' plain
    versions, which tracing can follow (a kernel launch it cannot)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, plain=True)


def export_program(model: nn.Module, shape=(1, 256, 256, 3)) -> bytes:
    """The bytes of ``torch.export`` of a zoo model's plain forward at one
    (N, H, W, 3) float32 input shape on the model's device, weights
    included (non-strict tracing, ``torch.export.save``)."""
    device = next(model.parameters()).device
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    buf = io.BytesIO()
    torch.export.save(torch.export.export(_PlainForward(model), (x,), strict=False), buf)
    return buf.getvalue()


def load_program(data: bytes):
    """An exported program's bytes back as a callable ``x -> y``."""
    return torch.export.load(io.BytesIO(data)).module()


def to_reference_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """MST++'s state in the reference layout: each up-convolution's
    (half, 2, 2) bias becomes (half,), the mean of its four copies (exact
    when the copies are equal, as at a fresh init or after loading a
    reference checkpoint)."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith(".0.bias") and ".decoder_layers." in k and v.dim() == 3:
            sd[k] = v.mean(dim=(1, 2))
    return sd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="export checkpoints / torch.export programs")
    ap.add_argument("--out", required=True)
    ap.add_argument("--method", default="mst_plus_plus")
    ap.add_argument("--ckpt", default=None, help="reference-layout .pth to load first")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--to-torch", action="store_true",
                    help="also save a reference-layout .pth (mst_plus_plus only), up-conv biases averaged")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from animal_vision_tpu_torch.models.zoo import model_generator

    if args.to_torch and args.method != "mst_plus_plus":
        ap.error("--to-torch writes MST++'s reference layout only")
    model = model_generator(args.method, args.ckpt, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, f"{args.method}.ckpt.pt"), model)
    blob = export_program(model, (1, args.height, args.width, 3))
    with open(os.path.join(args.out, f"{args.method}_{args.height}x{args.width}.pt2"), "wb") as f:
        f.write(blob)
    extra = ""
    if args.to_torch:
        pth = os.path.join(args.out, f"{args.method}.pth")
        torch.save({"state_dict": to_reference_state(model)}, pth)
        extra = f" + reference state_dict {pth}"
    print(f"saved checkpoint + {len(blob)} bytes torch.export program -> {args.out}{extra}")


if __name__ == "__main__":
    main()
