"""MST-L on the MSAB functions and the benchmark configuration
``mantis_mstl``, on the CPU.

- The port's plain MST-L (``models/mst.py``: ``attn_stats``, ``attn_matrix``
  without the Wv fold, the masked ``msab_pos``) against the plain reference
  ``portbench/reference/mst_l.py`` at the published widths, with the seeded
  weights of the configuration's file.
- The masked plain pass B against the formula ``MaskedMSMSA.forward`` had
  before it moved onto those functions (``_old_masked_msmsa`` below).
- Mantis shrimp with the MST-L provider against
  ``portbench/reference/mantis_mstl.py``, by the configuration's limits.
- The weights file, the configuration's frozen parameters, the work
  counts, the ``model.forward`` span and the new metric readers.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from animal_vision_tpu_torch.models import summary, zoo
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, make_mst_hsi_provider
from animal_vision_tpu_torch.ops import fused_msab as M
from animal_vision_tpu_torch.species.uv.mantis_shrimp import BANDS, MantisShrimp
from animal_vision_tpu_torch.utils import profiling as P
from portbench import compare, harness, traffic
from portbench.reference import mantis_mstl as ref_mantis
from portbench.reference import mst_l as ref_mst_l

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/mantis_mstl.json").read_text())
WORK = harness.load_module(harness.HERE / "work" / "mantis_mstl.py")
#: Max-abs bar of the plain port against the reference. The seeded model's
#: output reaches about 200; the two sum the same float32 products in
#: another order over 27 blocks and read 3.5e-4 apart. One TF32 rounding
#: of the input frame alone moves the reference by 0.088, of the weights by
#: 0.37 (``test_the_bar_breaks_on_one_tf32_rounding``), so a TF32 product
#: anywhere fails it.
MAX_ABS = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return harness.load_state(CONFIG["provider"])


@pytest.fixture(scope="module")
def model():
    return zoo.model_generator("mst", ROOT / CONFIG["provider"]["weights"], device="cpu")


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, to nearest), as one tensor
    core pass reads an operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("shape", [(1, 24, 40, 3), (1, 21, 35, 3)])
def test_plain_mst_l_vs_reference(model, state, shape):
    """21 x 35 takes the reflect pad to 24 x 40 and the crop."""
    x = _x(shape, sum(shape))
    with torch.no_grad():
        got = model(x, plain=True)
        want = ref_mst_l.forward(x, state)
    assert got.shape == want.shape == (*shape[:3], 31)
    assert want.abs().max().item() > 50.0
    assert (got - want).abs().max().item() <= MAX_ABS


def test_the_bar_breaks_on_one_tf32_rounding(state):
    x = _x((1, 24, 40, 3), 64)
    with torch.no_grad():
        want = ref_mst_l.forward(x, state)
        assert (ref_mst_l.forward(_tf32(x), state) - want).abs().max().item() > 10 * MAX_ABS
        assert (ref_mst_l.forward(x, {k: _tf32(v) for k, v in state.items()}) - want).abs().max().item() > 10 * MAX_ABS


def _old_masked_msmsa(attn, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``MaskedMSMSA.forward`` as it read before the masked pass B: a Gram by
    ``bmm`` per image row, norms, softmax, the product with the gated v, the
    projection and the positional branch."""
    n, h, w, c = x.shape
    heads, d = attn.heads, c // attn.heads
    flat = x.reshape(n, h * w, c)
    q, k, v = (F.linear(flat, m.weight) for m in (attn.to_q, attn.to_k, attn.to_v))
    vm = v * attn.mm(mask).reshape(1, h * w, c)
    rows = torch.bmm(k.view(n * h, w, c).transpose(1, 2), q.view(n * h, w, c))
    gram = rows.view(n, h, c, c).sum(dim=1)
    g = torch.stack([gram[:, i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(heads)], dim=1)
    qn = torch.clamp(torch.sqrt((q * q).sum(dim=1)), min=1e-12).view(n, heads, 1, d)
    kn = torch.clamp(torch.sqrt((k * k).sum(dim=1)), min=1e-12).view(n, heads, d, 1)
    a = torch.softmax(g / (kn * qn) * attn.rescale.view(1, heads, 1, 1), dim=-1)
    out = torch.matmul(vm.view(n, h * w, heads, d).transpose(1, 2), a.transpose(-1, -2))
    out_c = F.linear(out.transpose(1, 2).reshape(n, h * w, c), attn.proj.weight, attn.proj.bias)
    pos = attn.pos_emb[2](F.gelu(attn.pos_emb[0](v.view(n, h, w, c).permute(0, 3, 1, 2))))
    return out_c.view(n, h, w, c) + pos.permute(0, 2, 3, 1)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_masked_pass_b_keeps_the_formula(model, level):
    """At 31, 62 and 124 channels: ``msab_pos_plain`` with the gate and M'
    equals the old formula plus the residual, a batch of 2 on frame 0's
    mask."""
    msab = [model.encoder_layers[0][0], model.encoder_layers[1][0], model.bottleneck][level]
    c = 31 << level
    (attn, _), blk = msab.blocks[0], msab.weights()[0]
    x, mask = _x((2, 9, 13, c), level) - 0.5, _x((1, 9, 13, c), level + 10) - 0.5
    with torch.no_grad():
        want = _old_masked_msmsa(attn, x, mask) + x
        m = M.attn_matrix(*M.attn_stats_plain(x, blk.wq, blk.wk, blk.heads), blk.rescale, None, blk.wproj)
        got = M.msab_pos_plain(x, m, blk, attn.mm(mask))
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_weights_file_is_the_seeded_model(state):
    data = (ROOT / CONFIG["provider"]["weights"]).read_bytes()
    assert hashlib.sha256(data).hexdigest() == CONFIG["provider"]["sha256"]
    want = zoo.model_generator("mst", device="cpu", seed=0).state_dict()
    assert list(state) == list(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert sum(v.numel() for v in state.values()) == CONFIG["provider"]["params"] == 2_451_257


def test_configuration_equals_the_ports_parameters():
    ms = CONFIG["mantis_shrimp"]
    animal = MantisShrimp(device="cpu")
    assert [tuple(b) for b in ms["bands"]] == list(BANDS)
    for key, value in ms.items():
        if key != "bands":
            assert np.array_equal(np.asarray(getattr(animal, key), np.float32), np.asarray(value, np.float32)), key
    assert np.array_equal(ref_mantis.LAMBDAS, MST_LAMBDAS)
    assert CONFIG["model"] == {"stage": 2, "dim": 31, "num_blocks": [4, 7, 5], "bands": 31}


def test_mantis_with_mst_l_vs_reference(model, state):
    """2 x 64 x 96 frames of the benchmark's generator through the port's
    mantis shrimp with the MST-L provider (the normal path:
    ``make_mst_hsi_provider`` -> ``use_hsi_provider``) and through the plain
    reference, judged by the configuration's limits (``out_lsb`` is left
    out of them: barcode argmax flips at near-ties set it in either
    precision)."""
    frames = traffic.make_frames(2**31 + 5, 2, 64, 96, "cpu")
    animal = MantisShrimp(device="cpu").use_hsi_provider(
        make_mst_hsi_provider(model, input_encoding="linear", device="cpu"), lambdas=MST_LAMBDAS)
    with torch.no_grad():
        base, out = animal.visualize_batch_device(frames)
        rb, ro = ref_mantis.make(CONFIG, 64, 96, "cpu", state)["mantis_shrimp"](frames)
    acc = compare.Accumulator()
    acc.add("mantis_shrimp", base, rb, out, ro)
    judged = acc.judge(CONFIG["check"]["numbers"])
    assert set(judged) == {"base_lsb", "out_off_pct", "out_psnr_db"}
    assert all(v["ok"] for v in judged.values()), judged


@pytest.mark.parametrize("hw", [(16, 24), (21, 35)])
def test_work_flops_equal_the_flop_counter(model, hw):
    """``work/mantis_mstl.py``'s products equal ``torch.utils.flop_counter``'s
    count of the port's plain forward; the gated product is 2 C^2 per pixel
    and block more than MST++'s fold would spend."""
    assert WORK.mstl_flops(*hw)["products"] == summary.count_flops(model, torch.zeros(1, *hw, 3))
    levels = WORK.levels(*hw)
    assert [(c, b) for _, c, b in levels] == [(31, 4), (62, 7), (124, 5), (62, 7), (31, 4)]
    call = WORK.per_call("mantis_shrimp", 4, 1080, 1920, CONFIG)
    assert call["mstl_flops"] == 4 * WORK.mstl_flops(270, 480)["products"]
    assert sorted(k for k in call if k.startswith("msab_masked_least_s.")) == [
        "msab_masked_least_s.124", "msab_masked_least_s.31", "msab_masked_least_s.62"]


def test_model_forward_spans():
    """One ``model.forward`` span per frame for MST-L, one per batch for MST++."""
    frames = _x((2, 16, 24, 3), 7)
    mst_l = make_mst_hsi_provider(zoo.model_generator("mst", device="cpu"), input_encoding="linear", device="cpu")
    mst_pp = make_mst_hsi_provider(MSTPlusPlus(stage=1).eval(), input_encoding="linear", device="cpu")
    P.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        mst_l(frames)
        mst_pp(frames)
    got = [s.attrs for s in P.spans() if s.name == "model.forward"]
    P.clear()
    assert got == [{"method": "mst", "frames": 1, "h": 16, "w": 24}] * 2 + [
        {"method": "mst_plus_plus", "frames": 2, "h": 16, "w": 24}]


def _span(name, t0_ms, t1_ms, id_, parent=None, **attrs):
    return P.Span(name, int(t0_ms * 1e6), int(t1_ms * 1e6), id_, parent, 1, attrs)


def test_new_readers(monkeypatch):
    """The host ms per frame of the outermost ``model.forward`` spans, by the
    arithmetic of the accepted ``species.host_ms_per_frame``; the masked
    kernel's roofline over its fixed set, ``<31>`` and ``<62>``; None where
    the program keeps no such span or the trace lacks one of the set (the
    parent)."""
    spans = [_span("model.forward", 0, 4, 1, frames=1), _span("model.forward", 1, 2, 2, parent=1, frames=1),
             _span("model.forward", 10, 16, 3, frames=2)]
    monkeypatch.setattr(P, "spans", lambda: spans)
    assert harness.reader("model.host_ms_per_frame.mstl").read(harness.Reading()) == pytest.approx(10.0 / 3)
    renamed = [P.Span("species.program", s.t0_ns, s.t1_ns, s.id, s.parent, s.tid, s.attrs) for s in spans]
    monkeypatch.setattr(P, "spans", lambda: renamed)
    assert harness.reader("species.host_ms_per_frame").read(harness.Reading()) == pytest.approx(10.0 / 3)
    monkeypatch.setattr(P, "spans", lambda: [])
    assert harness.reader("model.host_ms_per_frame.mstl").read(harness.Reading()) is None

    roof = harness.reader("msab_masked_roofline")
    work = {"msab_masked_least_s.31": 0.5, "msab_masked_least_s.62": 0.25, "msab_masked_least_s.124": 0.125}
    ops = [["void (anonymous namespace)::ffn_kernel<31, 8, 16>(float const*)", 9.0],
           ["void (anonymous namespace)::msab_pos_masked_kernel<31>(float const*, float*)", 2.0],
           ["void (anonymous namespace)::msab_pos_masked_kernel<62>(float const*, float*)", 1.0],
           ["void (anonymous namespace)::msab_pos_kernel<124>(float const*, float*)", 1.0],
           ["void (anonymous namespace)::msab_pos_masked_kernel<124>(float const*, float*)", 4.0]]
    r = harness.Reading(work=work, trace={"device_ops": ops})
    assert roof.read(r) == pytest.approx(100.0 * 0.75 / 3.0)
    assert roof.read(harness.Reading(work=work, trace={"device_ops": ops[:2] + ops[3:]})) is None
    assert roof.read(harness.Reading(work=work, trace={"device_ops": ops[:1]})) is None
    assert harness.reader("mstl.mfu_pct").read(harness.Reading(work={"mstl_flops": 4.95e12}, window_s=10.0)) == \
        pytest.approx(100.0 * 4.95e11 / 495e12)


def test_the_cell_resolves_its_files_and_metrics():
    cell = harness.resolve("mantis_mstl.device_1080p_b4", True)
    assert cell.config["name"] == "mantis_mstl" and cell.config["reduced"] == []
    assert {n for n, _ in cell.metrics} == {"program_ms_per_frame.mstl", "device.idle_pct.mstl",
                                           "kernels_roofline.mstl", "mstl.mfu_pct", "model.host_ms_per_frame.mstl",
                                           "msab_masked_roofline", "setup.program_s",
                                           "species.host_ms_per_frame"}
    assert {n for n, _ in harness.resolve("mantis_mstl.device_1080p_b4", False).metrics} == {"fps", "setup_s"}
