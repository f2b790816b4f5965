"""The configurations' frozen parameters against the port's, and the plain
references against the port's plain path at tiny sizes on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, traffic
from portbench.reference import common, mst_plus_plus

ROOT = Path(__file__).resolve().parents[2]
NONUV = json.loads((ROOT / "portbench/configs/nonuv20.json").read_text())
HONEYBEE = json.loads((ROOT / "portbench/configs/honeybee_mstpp.json").read_text())


def test_nonuv_parameters_equal_the_ports():
    from animal_vision_tpu_torch.species import NON_UV_NAMES
    from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat

    assert NONUV["species"] == NON_UV_NAMES and len(NONUV["species"]) == 20
    assert set(NONUV["params"]) == set(NONUV_SPECS)
    for name, (alpha, s_scale, effects) in NONUV["params"].items():
        spec = NONUV_SPECS[name]
        assert (alpha, s_scale) == (spec.alpha, spec.s_scale)
        assert [(k, tuple(p), e) for k, p, e in effects] == [(e.kind, e.params, e.enabled) for e in spec.effects]
    cat = NONUV["cat"]
    assert (cat["camera_hfov_deg"], cat["per_eye_half_fov_deg"], cat["overlap_deg"], cat["cat_to_human_ratio"],
            cat["blur_sigma"]) == (Cat.CAMERA_HFOV_DEG, Cat.PER_EYE_HALF_FOV_DEG, Cat.OVERLAP_DEG,
                                   Cat.CAT_TO_HUMAN_RATIO, Cat.BLUR_SIGMA)
    d = np.array(cat["merge"], dtype=np.float32)
    assert np.array_equal((common.M_LMS_TO_RGB @ d @ common.M_RGB_TO_LMS).astype(np.float32),
                          Cat._merge_matrix().astype(np.float32))


def test_honeybee_parameters_equal_the_ports():
    from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee, honeybee_cone_curves

    from portbench.reference import honeybee_mstpp as ref

    hb, hc = HoneyBee(device="cpu"), HONEYBEE["honeybee"]
    assert (hb.adaptation, hb.mapping_mode, hb.blur_sigma_px) == (hc["adaptation"], hc["mapping_mode"],
                                                                  hc["blur_sigma_px"])
    assert np.array_equal(ref.catch_columns(hc), hb._catch_columns())
    assert len(honeybee_cone_curves(hb.lambdas)) == len(hc["cones"]) and hb.lambdas.size == hc["bands"]


def _frames(n, h, w, seed=3):
    return traffic.make_frames(seed, n, h, w, "cpu")


@pytest.mark.parametrize("species", NONUV["species"])
@pytest.mark.parametrize("hw", [(24, 40), (33, 57)])
def test_nonuv_reference_equals_the_ports_plain_path(species, hw):
    from animal_vision_tpu_torch.species import get_animal

    x = _frames(2, *hw)
    want_b, want = get_animal(species, "cpu").plain_transform(hw)(x)
    got_b, got = harness.reference(NONUV, *hw, "cpu", None)[species](x)
    assert torch.equal(got_b, want_b)
    assert int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) <= 1
    assert float((got != want).float().mean()) < 1e-3


def test_mstpp_reference_equals_the_ports_plain_forward():
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus

    sd = harness.load_state(HONEYBEE["provider"])
    model = MSTPlusPlus()
    model.load_state_dict(sd)
    model.requires_grad_(False).eval()
    x = torch.rand(2, 20, 28, 3, generator=torch.Generator().manual_seed(5))  # padded to 24 x 32
    with torch.no_grad():
        want = model(x, plain=True)
        got = mst_plus_plus.forward(x, {k: v.float() for k, v in sd.items()})
    assert got.shape == want.shape == (2, 20, 28, 31)
    assert float((got - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))


def test_honeybee_reference_equals_the_ports_plain_path():
    sd = harness.load_state(HONEYBEE["provider"])
    hw = (24, 40)
    x = _frames(2, *hw)
    animal = harness.build_program(HONEYBEE, sd, "cpu")["honeybee"]
    want_b, want = animal.plain_transform(hw)(x)
    got_b, got = harness.reference(HONEYBEE, *hw, "cpu", sd)["honeybee"](x)
    assert torch.equal(got_b, want_b)
    assert int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) <= 1


def test_the_provider_is_built_from_the_configurations_fields():
    # the method named is the method built: MST-L has other parameters than
    # the configuration states, so building it from MST++'s file is refused
    with pytest.raises((ValueError, RuntimeError), match="parameters|size mismatch|Missing|Unexpected"):
        harness.build_program(dict(HONEYBEE, provider=dict(HONEYBEE["provider"], method="mst")), None, "cpu")
    with pytest.raises(ValueError, match="do not take"):
        harness.build_program(dict(HONEYBEE, provider=dict(HONEYBEE["provider"], stage=2)), None, "cpu")
