"""The frozen work counts: MST++'s FLOPs against ``models/summary.py``'s
count, and the non-UV counts against the species' parameters."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, peaks

ROOT = Path(__file__).resolve().parents[2]
NONUV = json.loads((ROOT / "portbench/configs/nonuv20.json").read_text())
HONEYBEE = json.loads((ROOT / "portbench/configs/honeybee_mstpp.json").read_text())
WORK_NONUV = harness.load_module(harness.HERE / "work" / "nonuv20.py")
WORK_HB = harness.load_module(harness.HERE / "work" / "honeybee_mstpp.py")
#: the one-time composition of the up-fuse weights that a model's first
#: forward runs (``MSTPlusPlus.weights``), independent of the frame size
LAYOUT_FLOPS = 12_985_032


@pytest.mark.parametrize("size", [64, 256])
def test_mstpp_flops_equal_the_summary_count(size):
    from animal_vision_tpu_torch.models import summary
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus

    model = MSTPlusPlus().eval()
    x = torch.zeros(1, size, size, 3)
    first = summary.count_flops(model, x)
    warm = summary.count_flops(model, x)
    assert WORK_HB.mstpp_flops(size, size)["products"] == warm == first - LAYOUT_FLOPS


def test_mstpp_flops_at_the_cell_size():
    f = WORK_HB.mstpp_flops(1080, 1920)["products"]
    assert 1.30e12 < f < 1.34e12
    call = WORK_HB.per_call("honeybee", 4, 1080, 1920, HONEYBEE)
    assert call["mstpp_flops"] == 4 * f
    # the products bound it: MST++ and the catches' contraction at one TF32 pass
    assert call["least_s"] == pytest.approx((4 * f + 4 * 1080 * 1920 * 186) / peaks.TF32_FLOPS)


def test_weight_bytes_are_the_published_parameters():
    sd = harness.load_state(HONEYBEE["provider"])
    assert WORK_HB.WEIGHT_BYTES == 4 * sum(v.numel() for v in sd.values()) == 4 * HONEYBEE["provider"]["params"]


@pytest.mark.parametrize("species", NONUV["species"])
def test_nonuv_counts(species):
    n, h, w = 4, 1080, 1920
    k = WORK_NONUV.counts(species, n, h, w, NONUV)
    px = n * h * w
    assert k["bytes"] >= px * 6 and k["ops"] >= px * 24
    least = WORK_NONUV.per_call(species, n, h, w, NONUV)["least_s"]
    assert least == max(k["bytes"] / peaks.HBM_BYTES_PER_S, k["ops"] / peaks.F32_FLOPS)
    assert 1e-5 < least < 1e-3


def test_nonuv_counts_follow_the_parameters():
    n, h, w = 1, 1080, 1920
    px = h * w
    assert WORK_NONUV.counts("dog", n, h, w, NONUV)["ops"] == px * (18 + 12 * 29 + 6)  # sigma 3.5: 29 taps
    assert WORK_NONUV.counts("pig", n, h, w, NONUV) == {"bytes": px * 6 + 36, "ops": px * 24}
    assert WORK_NONUV.counts("rat", n, h, w, NONUV) == {"bytes": px * 6 + 36 + 4 * h, "ops": px * 25}
    assert WORK_NONUV.counts("rabbit", n, h, w, NONUV)["ops"] > WORK_NONUV.counts("sheep", n, h, w, NONUV)["ops"]
    cat = WORK_NONUV.counts("cat", n, h, w, NONUV)
    assert cat["bytes"] > px * 9 and cat["ops"] < px * 300  # taps, not the dense W x W products
