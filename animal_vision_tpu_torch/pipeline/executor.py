"""Batched, double-buffered streaming executor on pinned memory and CUDA
streams.

Counterpart of ``animal_vision_tpu/pipeline/executor.py``, with the same
contract: ``run(frames, sink) -> n`` passes every frame through the
species' batched program and gives ``sink`` the split frame (``split=True``)
or the transformed frame, in order; a short last batch is handled. Every
array passed to ``sink`` is its own: it stays valid after the sink returns.

The flow of one run:

- a producer thread stacks the frames of each batch straight into a slot of
  the native SPSC ring (``native/ring.py``), the only channel: a ring that
  does not build makes ``run`` raise;
- the consumer copies each slot into one of two staging buffers (one
  ``memcpy`` in C), pinned on the card. A staging buffer is refilled only
  after the event of its last H2D copy has completed;
- on the card, the H2D copy runs ``non_blocking`` on a stream of its own;
  the compute stream waits on its event and runs ``animal.transform``; the
  D2H copy of the outputs into pinned buffers runs on a third stream after
  an event of the compute stream. Each device tensor that a stream other
  than its allocating one reads is ``record_stream``-ed, so the caching
  allocator gives its block to no later batch while a copy still reads it.
  When batch i is already readable in the ring, it is dispatched before
  batch i-1 is emitted, so the card copies and computes while the host runs
  the sink. When the ring holds no readable slot (a producer slower than
  the consumer: a live camera, a slow decoder), batch i-1 is emitted at
  once, before the consumer waits: waiting first would hold it a whole
  producer period for no overlap. The choice rests only on the ring's
  occupancy at that moment; ``emitted_early`` counts the last run's batches
  emitted that way (the last batch always is);
- a baseline that is the input frame never goes through the device: it is
  read from the staging buffer, which is refilled only after the batch is
  emitted.

On a CPU animal the same code runs without streams or pinned memory.
``timer`` holds the last run's stages: ``ring put`` (frames into a slot),
``ring to pinned``, ``h2d``, ``compute``, ``d2h`` (CUDA events, on the card)
and ``sink`` (the copies out and the caller's sink); ``ring`` is the last
run's ring (its ``library`` path and ``reads``). The host stages are
``utils/profiling.span``s booked into ``timer``; under ``torch.profiler``
each batch also has ``executor.wait`` (for a readable slot),
``executor.dispatch``, ``executor.ready`` (its D2H done) spans and an
``executor.held`` record, from the end of its dispatch to the start of its
emit, whose ``early`` says which of the two orders emitted it. The ring
and the buffers of a run are ``executor.setup``, booked into
``profiling.SETUP``.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from animal_vision_tpu_torch.io.renderer import compose_split
from animal_vision_tpu_torch.native.ring import FrameRing
from animal_vision_tpu_torch.species.base import torch_dtype
from animal_vision_tpu_torch.utils.profiling import SETUP, Span, record, span, stage_timer

#: the device stages, each timed between a pair of CUDA events of a batch
DEVICE_STAGES = ("h2d", "compute", "d2h")


def _species(animal) -> str:
    """The label of ``animal``'s spans: its ``name``, else its class's."""
    return getattr(animal, "name", type(animal).__name__)


@dataclass
class _Batch:
    """A dispatched batch: host views of its baselines (None when they are
    not emitted) and outputs, and on the card its six timing events (start
    and end of H2D, compute, D2H; the last one marks the outputs ready);
    its number in the run and, while tracing, its dispatch span."""

    n: int
    base: np.ndarray | None
    out: np.ndarray
    events: list | None
    id: int = 0
    dispatched: Span | None = None


class StreamingExecutor:
    def __init__(
        self,
        animal,
        batch: int = 8,
        split: bool = True,
        right_label: str = "Transformed",
        prefetch: int = 2,
    ):
        self.animal = animal
        self.batch = max(1, batch)
        self.split = split
        self.right_label = right_label
        self.prefetch = prefetch
        self.timer = stage_timer()
        self.ring: FrameRing | None = None
        self.emitted_early = 0
        self._streams = None

    def run(self, frames: Iterable[np.ndarray], sink: Callable[[np.ndarray], None]) -> int:
        """Pump ``frames`` (uniform (H, W, 3) arrays) through the device;
        returns the number of frames given to ``sink``."""
        src = iter(frames)
        try:
            first = np.asarray(next(src))
        except StopIteration:
            return 0
        self.timer = stage_timer()
        self.emitted_early = 0
        with span("executor.setup", into=SETUP):
            ring = FrameRing(first.nbytes * self.batch, n_slots=self.prefetch + 2)
        self.ring = ring
        errors: list[BaseException] = []
        producer = threading.Thread(
            target=self._produce, args=(ring, itertools.chain([first], src), first.shape, first.dtype, errors),
            daemon=True,
        )
        producer.start()
        try:
            n = self._consume(ring, first.shape, first.dtype, sink)
        finally:
            ring.close()  # a producer still waiting for a slot stops
            producer.join()
            ring.free()
        if errors:
            raise errors[0]
        return n

    def _produce(self, ring: FrameRing, frames, shape, dtype, errors: list) -> None:
        """Stack the frames of each batch into a ring slot; close the ring
        at the end, or after the first error (kept for ``run`` to raise)."""
        try:
            slot, k, b = None, 0, 0
            for frame in frames:
                frame = np.asarray(frame)
                if frame.shape != shape or frame.dtype != dtype:
                    raise ValueError(f"frame of {frame.shape} {frame.dtype} in a stream of {shape} {dtype}")
                if slot is None:
                    slot = ring.acquire((self.batch, *shape), dtype)
                    if slot is None:  # the consumer stopped
                        return
                with span("executor.put", into=self.timer, stage="ring put", batch=b):
                    slot[k] = frame
                k += 1
                if k == self.batch:
                    ring.commit(slot.shape)
                    slot, k, b = None, 0, b + 1
            if k:
                ring.commit((k, *shape))
        except Exception as e:  # noqa: BLE001  (raised again by run, in the caller's thread)
            errors.append(e)
        finally:
            ring.close()

    def _consume(self, ring: FrameRing, shape, dtype, sink) -> int:
        device = self.animal.device
        on_card = device.type == "cuda"
        program = self.animal.transform(shape, dtype)
        full = (self.batch, *shape)
        tdtype = torch_dtype(dtype)
        with span("executor.setup", into=SETUP):
            if on_card and self._streams is None:
                self._streams = tuple(torch.cuda.Stream(device) for _ in range(3))
            staging = [torch.empty(full, dtype=tdtype, pin_memory=on_card) for _ in range(2)]
            outs = [torch.empty(full, dtype=tdtype, pin_memory=on_card) for _ in range(2)] if on_card else None
        bases = [None, None]
        h2d_done = [None, None]
        n, pending = 0, None
        for i in itertools.count():
            if pending is not None and not len(ring):
                # nothing to overlap with: emit now rather than after the wait
                n += self._emit(pending, sink, early=True)
                pending = None
            with span("executor.wait", batch=i):
                readable = ring.wait_readable()
            if not readable:
                break
            s = i % 2
            if h2d_done[s] is not None:
                h2d_done[s].synchronize()
            buf = staging[s]
            with span("executor.to_pinned", into=self.timer, stage="ring to pinned", batch=i):
                got, _ = ring.read_into(buf.data_ptr(), buf.numel() * buf.element_size())
            host = buf[: got[0]]
            with span("executor.dispatch", batch=i) as dispatched:
                if on_card:
                    batch = self._dispatch_card(program, host, outs[s], bases, s)
                    h2d_done[s] = batch.events[1]
                else:
                    with span("species.program", into=self.timer, stage="compute", species=_species(self.animal),
                              frames=host.shape[0]):
                        base, out = program(host)
                    emit_base = None if not self.split else (host if base is host else base).numpy()
                    batch = _Batch(host.shape[0], emit_base, out.numpy(), None)
            batch.id, batch.dispatched = i, dispatched
            if pending is not None:
                n += self._emit(pending, sink, early=False)
            pending = batch
        return n  # the ring ends closed and empty, so the last batch left early

    def _dispatch_card(self, program, host: torch.Tensor, out_buf: torch.Tensor, bases: list, s: int) -> _Batch:
        """Queue H2D, compute and D2H of one batch on the three streams."""
        h2d, compute, d2h = self._streams
        device = self.animal.device
        k = host.shape[0]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.cuda.stream(h2d):
            ev[0].record(h2d)
            x = torch.empty(host.shape, dtype=host.dtype, device=device)
            x.copy_(host, non_blocking=True)
            ev[1].record(h2d)
        compute.wait_event(ev[1])
        with torch.cuda.stream(compute):
            x.record_stream(compute)
            ev[2].record(compute)
            with span("species.program", species=_species(self.animal), frames=k):
                base, out = program(x)
            ev[3].record(compute)
        d2h.wait_event(ev[3])
        with torch.cuda.stream(d2h):
            ev[4].record(d2h)
            out.record_stream(d2h)
            out_host = out_buf[:k]
            out_host.copy_(out, non_blocking=True)
            emit_base = None
            if self.split and base is x:
                emit_base = host
            elif self.split:
                if bases[s] is None:
                    bases[s] = torch.empty(out_buf.shape, dtype=base.dtype, pin_memory=True)
                base.record_stream(d2h)
                emit_base = bases[s][:k]
                emit_base.copy_(base, non_blocking=True)
            ev[5].record(d2h)
        return _Batch(k, None if emit_base is None else emit_base.numpy(), out_host.numpy(), ev)

    def _emit(self, batch: _Batch, sink, early: bool) -> int:
        self.emitted_early += early
        with span("executor.ready", batch=batch.id) as ready:
            if batch.events is not None:
                batch.events[5].synchronize()
        if ready is not None and batch.dispatched is not None:
            record("executor.held", batch.dispatched.t1_ns, ready.t0_ns, batch=batch.id, frames=batch.n,
                   early=early)
        if batch.events is not None:
            ev = batch.events
            for j, name in enumerate(DEVICE_STAGES):
                self.timer.add(name, ev[2 * j].elapsed_time(ev[2 * j + 1]) / 1e3)
        with span("executor.sink", into=self.timer, stage="sink", batch=batch.id):
            for i in range(batch.n):
                if self.split:
                    sink(compose_split(batch.base[i], batch.out[i], right_label=self.right_label))
                else:
                    sink(batch.out[i].copy())
        return batch.n
