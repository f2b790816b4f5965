"""The port's native SPSC frame ring (``animal_vision_tpu_torch/native``):
FIFO order and wraparound, variable shapes, a threaded stream, slots filled
in place and copied straight into a tensor's buffer, and the build: into
``build/native/framering-<hash>.so``, by several processes at once, and a failed
build that raises. No test skips: g++ is required."""

import hashlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.native import FrameRing
from animal_vision_tpu_torch.native import ring as R

REPO = Path(__file__).resolve().parents[1]


def test_ring_fifo_and_wraparound():
    ring = FrameRing(slot_bytes=4 * 16, n_slots=4)
    for wave in range(5):  # wraps several times
        for i in range(3):
            ring.put(np.full((4,), wave * 10 + i, dtype=np.int32))
        assert len(ring) == 3
        for i in range(3):
            np.testing.assert_array_equal(ring.get(), np.full((4,), wave * 10 + i, np.int32))
    ring.close()
    assert ring.get() is None
    assert ring.reads == 15


def test_ring_variable_shapes():
    ring = FrameRing(slot_bytes=1024, n_slots=4)
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    b = np.arange(6, dtype=np.float32).reshape(2, 3)
    ring.put(a)
    ring.put(b)
    got_a, got_b = ring.get(), ring.get()
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b)
    assert got_a.dtype == np.uint8 and got_b.dtype == np.float32


def test_ring_threaded_stream():
    ring = FrameRing(slot_bytes=64 * 96 * 3, n_slots=4)
    frames = [np.random.default_rng(i).integers(0, 256, (64, 96, 3), dtype=np.uint8) for i in range(50)]

    def producer():
        for f in frames:
            ring.put(f)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while (f := ring.get()) is not None:
        got.append(f)
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(got) == 50
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a, b)


def test_acquire_commit_and_read_into_tensor():
    """A batch stacked in place into a slot (a short one: 2 of 3 frames)
    arrives in a tensor's buffer by one copy; a buffer too small raises and
    leaves the slot readable."""
    ring = FrameRing(slot_bytes=3 * 5 * 7 * 3, n_slots=3)
    frames = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    slot = ring.acquire((3, 5, 7, 3), np.uint8)
    slot[0], slot[1] = frames
    ring.commit((2, 5, 7, 3))
    ring.close()
    assert ring.wait_readable()
    small = torch.zeros((1, 5, 7, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not fit"):
        ring.read_into(small.data_ptr(), small.numel())
    dst = torch.zeros((3, 5, 7, 3), dtype=torch.uint8)
    shape, dtype = ring.read_into(dst.data_ptr(), dst.numel())
    assert shape == (2, 5, 7, 3) and dtype == np.uint8
    np.testing.assert_array_equal(dst[:2].numpy(), frames)
    assert not dst[2].any()
    assert not ring.wait_readable()  # closed and drained
    assert ring.acquire((1,), np.uint8) is None  # a closed ring takes no more


def test_library_path_carries_source_hash():
    lib = R.load()
    h = hashlib.sha256(" ".join(R.GXX_FLAGS).encode())
    h.update(R.SOURCE.read_bytes())
    assert Path(lib.path) == REPO / "build" / "native" / f"framering-{h.hexdigest()[:16]}.so"
    assert FrameRing(8, 2).library == lib.path


def test_library_path_changes_with_source(tmp_path, monkeypatch):
    src = tmp_path / "framering.cpp"
    src.write_bytes(R.SOURCE.read_bytes())
    monkeypatch.setattr(R, "SOURCE", src)
    before = R.library_path()
    src.write_bytes(R.SOURCE.read_bytes() + b"\n// edited\n")
    assert R.library_path() != before


_BUILD_AT_ONCE = r"""
import sys, time
from pathlib import Path
from animal_vision_tpu_torch.native import ring
ring.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
r = ring.FrameRing(16, 2)
r.put(__import__("numpy").arange(4, dtype="int32"))
print(r.library, int(r.get().sum()))
"""


@pytest.mark.parametrize("n_procs", [2, 6])
def test_processes_build_at_once(tmp_path, n_procs):
    """Processes that find no library load it at nearly the same moment
    (six, as many as the test workers), 40 ms apart, so that later ones
    look while an earlier one builds; each loads a whole library. A build
    written in place, as the JAX loader does, fails here ("file too
    short")."""
    start = time.time() + 5.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AT_ONCE, str(tmp_path), repr(start + 0.04 * i)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(n_procs)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * n_procs, [err for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1
    path, total = lines.pop().rsplit(" ", 1)
    assert total == "6" and Path(path).parent == tmp_path and Path(path).exists()
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".lock", ".so"]  # no half-written file left


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "framering.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(R, "SOURCE", bad)
    monkeypatch.setattr(R, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(R, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        FrameRing(16, 2)
    assert "error" in str(e.value)
    assert not list((tmp_path / "native").glob("*.so"))
