"""The port's multi-device dry run (``parallel/dryrun.py``, the counterpart
of the JAX ``__graft_entry__.dryrun_multichip``) on 4 CPU ranks: every
parallel path once, each reading within the JAX dry run's bars, and its
summary line. About 30 s alone."""

import numpy as np
import torch

from animal_vision_tpu_torch.parallel import dryrun


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    line = dryrun.dryrun_multichip(4, "cpu", timeout=400)
    assert line.startswith("dryrun_multichip ok: 4 ranks on cpu, mesh dp=1 sp=2 tp=2, step=1")
    assert "pp=4-slot pipeline" in line and "ep fleet=4 species" in line
    assert "provider 32x32 bands" in line  # the stream exercised the band path
    assert line in capsys.readouterr().out


def test_entry_runs_the_forward():
    fn, (example,) = dryrun.entry("cpu")
    out = fn(example)
    assert out.shape == (1, 128, 128, 31) and out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
