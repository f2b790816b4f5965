"""A tiny ``train_synth`` run on the CPU (``animal_vision_tpu_torch/tools/
train_synth.py``): 100 real train steps, about 25 s alone, in a file of
its own so that ``tests/test_torch_tools.py`` stays under a minute."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models import export, quality
from animal_vision_tpu_torch.models import train as T
from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED, MSTPlusPlus
from animal_vision_tpu_torch.tools import train_synth

TINY = ["--patch", "16", "--batch", "2", "--scenes", "4", "--scene-hw", "32", "--device", "cpu"]
TINY_PROTOCOL = (1, (40, 48))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the steps are tiny, and the test workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def test_train_synth_tiny_run(tmp_path, monkeypatch):
    """A tiny run: 100 steps of 2 x 16x16 patches from 4 scenes
    of 32x32, the ``.jpg``/``.mat`` protocol on small scenes; the saved
    checkpoint reloads through ``quality.load_pretrained`` and scores the
    held-out scenes exactly as the run did."""
    monkeypatch.setattr(train_synth, "PROTOCOL", TINY_PROTOCOL)
    out = tmp_path / "trained.pt"
    shipped = sha256(SHIPPED)
    r = train_synth.main(["--steps", "100", *TINY, "--out", str(out)])
    assert r["steps"] == 100 and len(r["losses"]) == 100 and np.isfinite(r["losses"]).all()
    assert r["protocol"] == "files" and set(r["eval_protocol"]) == {"synth", "xgen"}
    assert all(np.isfinite(list(s.values())).all() for s in r["eval_protocol"].values())
    log = r["held_out_log"]
    assert [e["step"] for e in log] == [0, 100]
    assert all(log[1][f]["psnr"] > log[0][f]["psnr"] for f in ("synth", "xgen"))
    assert log[1]["synth"] == r["held_out"]["synth"] and log[1]["xgen"] == r["held_out"]["xgen"]

    reloaded = quality.load_pretrained("cpu", path=out)
    _, held = train_synth.split_scenes("mixed", 4, 32, "cpu")
    for family, scene in held:
        assert meval.validate(meval.model_apply_fn(reloaded), [scene], crop=0) == r["held_out"][family]
    cfg = T.make_optimizer(lr=1e-3, total_steps=100, warmup=10)
    fresh = MSTPlusPlus()
    state = export.load_checkpoint(str(out), T.TrainState(fresh, *cfg.build(fresh.parameters())))
    assert state.step == 100 and state.scheduler.last_epoch == 100
    assert sha256(SHIPPED) == shipped
