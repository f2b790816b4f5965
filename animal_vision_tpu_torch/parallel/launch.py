"""Ranks as processes: start a world of ``torch.distributed`` ranks on one host.

The JAX package runs its multi-device paths as one SPMD program over a mesh
of chips. The port runs them as one process per rank. ``spawn(fn, world,
device, **kw)`` starts ``world`` processes with the ``spawn`` start method
(CUDA cannot be forked), joins them in one process group and calls
``fn(device, **kw)`` in each; it returns the ranks' results in rank order.

- Rendezvous goes through a file in a fresh temporary directory
  (``init_method="file://..."``), so concurrent worlds on one host never
  race for a TCP port.
- Backend (``comm.choose_backend``): NCCL when every rank has a card of
  its own (rank r on ``cuda:r``); otherwise gloo, with every rank on the
  device it was given (on a host with one card, all ranks share
  ``cuda:0``). Each rank logs its backend and device on stderr.
- Every wait is bounded. The ranks start through
  ``torch.multiprocessing.start_processes``, whose join kills every rank
  and re-raises with the failing rank's traceback. The process group's
  collectives time out after ``timeout`` seconds, and the parent kills
  every rank and raises when the world is not done by then: a hung
  collective fails its caller instead of hanging it.
- ``device`` defaults to the card; a world on the CPU needs
  ``device="cpu"``. On the CPU each rank runs one intra-op thread: several
  worlds may share the host's cores. On the card the parent builds every
  kernel library first (``ops/_build.build_all``), so the ranks load them
  and do not run one ``nvcc`` each per source.

``fn`` must be importable by name (a module-level function), and its
result picklable host data (numbers, strings, NumPy arrays, CPU tensors):
it is pickled whole, so it does not depend on the rank staying alive.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
from torch.multiprocessing.spawn import ProcessException

from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.parallel import comm
from animal_vision_tpu_torch.species import resolve_device

#: seconds a world may take, start-up included, unless the caller says
DEFAULT_TIMEOUT_S = 300.0
#: seconds the parent waits for a result after every rank exited
EXIT_GRACE_S = 30.0


def _rank_main(rank: int, world: int, init: str, device: str, timeout: float, fn, kw: dict, results) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        backend = comm.choose_backend(world, dev)
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        print(f"[rank {rank}/{world}] backend {backend}, device {dev}", file=sys.stderr, flush=True)
        results.put((rank, True, pickle.dumps(fn(dev, **kw))))
    except BaseException:  # sent at once: a peer's failure that it causes comes later
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _drain(results, got: dict, world: int, wait: float = 0.0) -> None:
    """Move the results that have arrived into ``got``; wait up to ``wait``
    seconds for the first. Raises on the first failure sent."""
    with contextlib.suppress(queue.Empty):
        while True:
            rank, ok, value = results.get(timeout=wait) if wait else results.get_nowait()
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = pickle.loads(value)
            wait = 0.0


def spawn(fn, world: int, device: str | torch.device | None = None, timeout: float = DEFAULT_TIMEOUT_S,
          **kw) -> list:
    """Run ``fn(device, **kw)`` on ``world`` ranks, one process each, on the
    card unless ``device`` says otherwise; return their results in rank
    order. Raises ``RuntimeError`` naming the rank and its traceback when a
    rank fails or exits without a result, and ``TimeoutError`` when the
    world is not done within ``timeout`` seconds; either way every rank is
    gone first."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    device = resolve_device(device)
    if device.type == "cuda":
        _build.build_all()
    tmp = tempfile.mkdtemp(prefix="avt_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = mp.get_context("spawn").Queue()
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    ctx = None
    try:
        ctx = torch_mp.start_processes(_rank_main, args=(world, init, str(device), timeout, fn, kw, results),
                                     nprocs=world, join=False, daemon=True, start_method="spawn")
        done = False
        while not done:  # results are read as they come: a rank exits only once its result is sent
            _drain(results, got, world)
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                raise TimeoutError(f"ranks {alive} of {world} not done within {timeout} s")
            try:
                done = ctx.join(timeout=0.5)
            except ProcessException as e:
                _drain(results, got, world, wait=1.0)  # the failure that came first, with its traceback
                raise RuntimeError(f"rank {e.error_index} of {world} failed:\n{e.msg}") from None
        while len(got) < world:
            before = len(got)
            _drain(results, got, world, wait=EXIT_GRACE_S)
            if len(got) == before:
                missing = sorted(set(range(world)) - set(got))
                raise RuntimeError(f"ranks {missing} of {world} exited without a result")
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=EXIT_GRACE_S)
            for f in ctx.error_files:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(f)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
