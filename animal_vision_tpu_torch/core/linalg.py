"""Per-axis matrix products over (..., H, W, C) images, in full float32.

Counterpart of ``apply_w_matrix`` / ``apply_h_matrix`` in
``animal_vision_tpu/core/linalg.py``. Plain ``torch.einsum``: callers that
need full float32 on the card keep ``torch.backends.cuda.matmul.allow_tf32``
off (PyTorch's default).
"""

from __future__ import annotations

import torch


def apply_w_matrix(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Contract the W axis of (..., H, W, C) with a (W, W_out) matrix."""
    return torch.einsum("...wc,wo->...oc", img, m)


def apply_h_matrix(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Contract the H axis of (..., H, W, C) with an (H_out, H) matrix."""
    return torch.einsum("...hwc,oh->...owc", img, m)
