"""The port's streaming executor (``animal_vision_tpu_torch/pipeline``) on
the CPU against the JAX package's on the same frames: dog, pig and kestrel
at batch 3 on 7 frames (batches of 3, 3 and 1), split both ways. Every
emitted frame within 1 LSB of JAX (kestrel, a UV species: >= 40 dB PSNR),
in order; the frames go through the native ring; a sink that keeps every
frame gets frames of its own; under a producer slower than the consumer
each frame reaches the sink before the next is yielded."""

import time

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch  # noqa: F401

from animal_vision_tpu.pipeline import StreamingExecutor as JaxExecutor
from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu_torch.io.renderer import compose_split
from animal_vision_tpu_torch.native import ring as R
from animal_vision_tpu_torch.pipeline import StreamingExecutor
from animal_vision_tpu_torch.species import get_animal

N_FRAMES = 7
BATCH = 3


def _frames(img_u8):
    return [np.roll(img_u8, 5 * i, axis=1) for i in range(N_FRAMES)]


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", ["dog", "pig", "kestrel"])
def test_executor_vs_jax(name, split, img_u8, psnr_fn):
    frames = _frames(img_u8)
    want = []
    assert JaxExecutor(jax_animal(name), batch=BATCH, split=split).run(iter(frames), want.append) == N_FRAMES
    got = []
    ex = StreamingExecutor(get_animal(name, device="cpu"), batch=BATCH, split=split)
    assert ex.run(iter(frames), got.append) == N_FRAMES
    assert len(got) == N_FRAMES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == img_u8.shape and g.dtype == np.uint8
        if name == "kestrel":
            assert psnr_fn(g / 255.0, w / 255.0) >= 40.0, i
        else:
            assert _lsb(g, w) <= 1, i
    # the frames went through the native ring, one slot per batch
    assert ex.ring.library == str(R.library_path()) and ex.ring.reads == 3
    assert {"ring put", "ring to pinned", "compute", "sink"} <= set(ex.timer.counts)
    assert ex.timer.counts["ring put"] == N_FRAMES


@pytest.mark.parametrize("split", [False, True])
def test_keeping_sink_gets_frames_of_its_own(split, img_u8):
    """A sink that keeps every frame across 3 batches: each kept frame still
    equals ``visualize`` of its input after the run, and no two share
    memory (no view of a buffer that a later batch overwrote)."""
    frames = _frames(img_u8)
    animal = get_animal("rat", device="cpu")
    outs = []
    assert StreamingExecutor(animal, batch=BATCH, split=split).run(iter(frames), outs.append) == N_FRAMES
    for f, o in zip(frames, outs):
        base, out = animal.visualize(f)
        np.testing.assert_array_equal(o, compose_split(base, out) if split else out)
    assert all(o.flags.owndata for o in outs)  # no view into a buffer of the executor
    for i in range(N_FRAMES):
        for j in range(i + 1, N_FRAMES):
            assert not np.shares_memory(outs[i], outs[j])
    assert len({o.tobytes() for o in outs}) == N_FRAMES


def test_short_and_empty_streams(img_u8):
    animal = get_animal("dog", device="cpu")
    outs = []
    ex = StreamingExecutor(animal, batch=4, split=False)
    assert ex.run(iter([img_u8]), outs.append) == 1 and ex.ring.reads == 1
    np.testing.assert_array_equal(outs[0], animal.visualize(img_u8)[1])
    assert ex.run(iter([]), outs.append) == 0 and len(outs) == 1


def test_mixed_shapes_raise_after_the_good_frames(img_u8):
    outs = []
    frames = [img_u8, img_u8, img_u8[:32]]
    with pytest.raises(ValueError, match="stream of"):
        StreamingExecutor(get_animal("pig", device="cpu"), batch=2, split=False).run(iter(frames), outs.append)
    assert len(outs) == 2


def test_failing_sink_stops_the_producer(img_u8):
    """A sink that raises ends the run; the producer, waiting for a slot,
    stops too (the run returns instead of hanging)."""
    def sink(_):
        raise KeyboardInterrupt

    frames = (np.roll(img_u8, i, axis=0) for i in range(40))
    with pytest.raises(KeyboardInterrupt):
        StreamingExecutor(get_animal("pig", device="cpu"), batch=1, split=False, prefetch=1).run(frames, sink)


def test_paced_producer_gets_each_frame_back_before_the_next(img_u8):
    """A producer slower than the consumer (a live camera): with no next
    batch readable, each batch is emitted at once, so frame k reaches the
    sink before frame k+1 is even yielded, and the run counts those
    batches as emitted early; the frames are still ``visualize``'s, in
    order."""
    gap_s = 0.1
    frames = [np.roll(img_u8, 7 * i, axis=0) for i in range(5)]
    animal = get_animal("pig", device="cpu")
    want = [animal.visualize(f)[1] for f in frames]  # also builds the program before the clock
    yielded, reached, outs = [], [], []

    def paced():
        for i, f in enumerate(frames):
            if i:
                time.sleep(gap_s)
            yielded.append(time.perf_counter())
            yield f

    def sink(frame):
        reached.append(time.perf_counter())
        outs.append(frame)

    ex = StreamingExecutor(animal, batch=1, split=False)
    assert ex.run(paced(), sink) == len(frames)
    assert all(reached[k] < yielded[k + 1] for k in range(len(frames) - 1)), (yielded, reached)
    assert ex.emitted_early >= len(frames) - 1
    for o, w in zip(outs, want, strict=True):
        np.testing.assert_array_equal(o, w)
