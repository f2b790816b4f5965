"""Parameter and FLOP counts of the zoo's models.

Counterpart of ``animal_vision_tpu/models/summary.py`` (the reference's
``my_summary``). The parameter count is the JAX package's: see
``param_count``. The FLOPs come from ``torch.utils.flop_counter.
FlopCounterMode`` over one forward of the model's plain composition
(``model(x, plain=True)``): the operations of the matrix products and
convolutions only (two per multiply-add), none of the elementwise work,
the norms, the softmaxes or the resizes. The plain composition runs the
same products and convolutions on every device, so the card counts what
the CPU counts: the CUDA kernels of MST++ and MST-L launch through ctypes,
outside aten, where ``FlopCounterMode`` cannot see them. The counts are
not XLA's ``cost_analysis`` count, which the JAX ``summarize`` reports, and
are never compared with it.

Usage (the card unless ``--device cpu``):
    python -m animal_vision_tpu_torch.models.summary [--method M] [--size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
import sys

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from animal_vision_tpu_torch.models import zoo
from animal_vision_tpu_torch.species import resolve_device


def param_count(model: nn.Module) -> int:
    """The values the JAX package counts as parameters: every learned
    weight once per site where the reference shares one module between
    sites (the JAX modules hold a copy per site), BatchNorm's running mean
    and variance (the JAX inference BatchNorm holds them as parameters), a
    transposed convolution's bias once per kernel tap (the JAX modules
    write HINet's 2x2 stride-2 up-convolution as a 1x1 convolution to
    (dy, dx, out) channels, each with its bias), and not the weights the
    forward never reads (``idle_keys``)."""
    idle = set(model.idle_keys()) if hasattr(model, "idle_keys") else set()
    n = sum(p.numel() for k, p in model.named_parameters(remove_duplicate=False) if k not in idle)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            n += m.running_mean.numel() + m.running_var.numel()
        elif isinstance(m, nn.ConvTranspose2d) and m.bias is not None:
            n += m.bias.numel() * (m.kernel_size[0] * m.kernel_size[1] - 1)
    return n


def count_flops(fn, *args) -> int:
    """Matrix-product and convolution FLOPs of one call of ``fn(*args)``
    under ``torch.no_grad()``. A zoo model (a module whose ``forward``
    takes ``plain``) runs ``fn(*args, plain=True)``, its plain composition,
    so the count is the same on every device."""
    takes_plain = isinstance(fn, nn.Module) and "plain" in inspect.signature(fn.forward).parameters
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        if takes_plain:
            fn(*args, plain=True)
        else:
            fn(*args)
    return counter.get_total_flops()


def summarize(method: str, h: int = 256, w: int = 256, device: str | torch.device | None = None) -> dict:
    """The zoo's ``method`` with seeded weights on ``device`` (the CUDA card
    when None): its parameter count and the FLOPs of one plain forward of
    a (1, h, w, 3) frame."""
    model = zoo.model_generator(method, device=device)
    x = torch.zeros(1, h, w, 3, device=next(model.parameters()).device)
    return {"method": method, "params": param_count(model), "flops": count_flops(model, x)}


def main(argv=None) -> int:
    """Print each zoo model's parameters and FLOPs at ``--size`` in the JAX
    ``main``'s line format; a method that raises prints ``FAILED`` and the
    rest go on. Returns 1 if any method failed, else 0."""
    ap = argparse.ArgumentParser(description="params/FLOPs per zoo model")
    ap.add_argument("--method", default=None, help="default: all")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    methods = [args.method] if args.method else zoo.available_models()
    print("flops: matrix-product and convolution FLOPs of the plain forward (torch FlopCounterMode, "
          "not XLA's cost_analysis); GMac = flops / 2 / 1024^3", flush=True)
    failed = 0
    for m in methods:
        try:
            s = summarize(m, args.size, args.size, device)
            gmac = s["flops"] / 2 / (1024**3)
            print(f"{m:16s} params {s['params']/1e6:8.2f} M   "
                  f"flops {s['flops']/1e9:10.2f} G ({gmac:.2f} GMac) @ {args.size}x{args.size}", flush=True)
        except Exception as e:  # one model's failure does not stop the others
            failed += 1
            print(f"{m:16s} FAILED: {type(e).__name__}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
