"""Matrix products over (..., H, W, C) images, in full float32.

Counterpart of ``apply_w_matrix`` / ``apply_h_matrix`` in
``animal_vision_tpu/core/linalg.py``, plus ``frame_matmul`` for the UV
path's per-pixel channel contractions. Plain ``torch.einsum`` and
``torch.bmm``: callers that need full float32 on the card keep
``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default).
"""

from __future__ import annotations

import torch


def apply_w_matrix(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Contract the W axis of (..., H, W, C) with a (W, W_out) matrix."""
    return torch.einsum("...wc,wo->...oc", img, m)


def apply_h_matrix(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Contract the H axis of (..., H, W, C) with an (H_out, H) matrix."""
    return torch.einsum("...hwc,oh->...owc", img, m)


def frame_matmul(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Contract the channel axis of (..., H, W, K) with a (K, P) matrix.

    One ``torch.bmm`` with a product per frame, so that a frame of a batch
    gets the same bits as the frame alone."""
    h, w, k = img.shape[-3:]
    frames = img.reshape(-1, h * w, k)
    out = torch.bmm(frames, m.expand(frames.shape[0], *m.shape))
    return out.reshape(*img.shape[:-1], m.shape[-1])
