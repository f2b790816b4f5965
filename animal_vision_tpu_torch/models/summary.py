"""Parameter and FLOP counts of the zoo's models.

Counterpart of ``animal_vision_tpu/models/summary.py`` (the reference's
``my_summary``). The parameter count is the JAX package's: see
``param_count``. The FLOPs come from ``torch.utils.flop_counter.
FlopCounterMode`` over one forward: the operations of the matrix products
and convolutions only (two per multiply-add), none of the elementwise
work, the norms, the softmaxes or the resizes. They are therefore not
XLA's ``cost_analysis`` count, which the JAX ``summarize`` reports, and
are never compared with it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from animal_vision_tpu_torch.models import zoo


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
    """Matrix-product and convolution FLOPs of ``fn(*args)``, run once."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def summarize(method: str, h: int = 256, w: int = 256, device: str | torch.device | None = None) -> dict:
    """The zoo's ``method`` with seeded weights on ``device`` (the CUDA card
    when None): its parameter count and the FLOPs of one forward of a
    (1, h, w, 3) frame."""
    model = zoo.model_generator(method, device=device)
    x = torch.zeros(1, h, w, 3, device=next(model.parameters()).device)
    return {"method": method, "params": param_count(model), "flops": count_flops(model, x)}
