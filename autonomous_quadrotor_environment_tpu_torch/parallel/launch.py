"""Start data-parallel ranks as processes and collect what they return.

`spawn(fn, devices, backend, args)` runs ``fn(mesh, *args)`` in one
process per entry of ``devices``, each a rank of a fresh process group:

* the processes start with the ``spawn`` method, never ``fork``: the
  parent may already hold a CUDA context, which a forked child cannot use;
* they meet at a ``file://`` rendezvous in a temporary directory of the
  caller's (``TMPDIR``), so that concurrent worlds never contend for a
  port;
* every collective waits at most ``timeout`` seconds, and the whole run
  ends by ``deadline`` seconds when one is given;
* a rank that raises sends its traceback to the parent, which kills every
  other rank at once (none is left waiting in an ``all_reduce``) and
  raises `RankError`; a rank that dies without a word is found by its exit
  code and fails the run the same way.

``fn`` must be a module-level function (the child imports it by name) of a
module that imports no JAX, and return a picklable value with no CUDA
tensor in it.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_JOIN_SECONDS = 60.0  # a rank that has sent its result must exit within this


class RankError(RuntimeError):
    """A rank of a `spawn` run failed."""


def rank_devices(world: int, device=None) -> tuple[list, str]:
    """The devices and backend of a ``world``-rank run: on the CPU
    (``device="cpu"``) every rank on it over gloo; else one CUDA card per
    rank over NCCL, which needs ``world`` cards."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * world, "gloo"
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > have:
        raise ValueError(f"--dp {world} needs {world} CUDA cards, one per rank; "
                         f"this machine has {have}")
    return [f"cuda:{r}" for r in range(world)], "nccl"


def _rank_main(rank: int, devices: list, backend: str, init: str, timeout: float,
               threads: Optional[int], fn: Callable, args: tuple, out) -> None:
    from .dp import make_dp_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=len(devices),
                                timeout=datetime.timedelta(seconds=timeout))
        result = fn(make_dp_mesh(device), *args)
        dist.destroy_process_group()
    except BaseException:  # every failure goes to the parent, which ends the run
        out.put((rank, False, traceback.format_exc()))
        out.close()
        out.join_thread()
        os._exit(1)  # no exit handler may wait on a peer that is gone
    out.put((rank, True, result))


def spawn(fn: Callable, devices: Sequence, backend: str, args: tuple = (), *,
          timeout: float = 1800.0, deadline: Optional[float] = None,
          threads: Optional[int] = None) -> list:
    """``fn(mesh, *args)`` on ``len(devices)`` ranks, rank r on
    ``devices[r]``, over ``backend`` ("gloo" or "nccl"); returns each rank's
    value in rank order. ``timeout`` bounds each collective's wait,
    ``deadline`` (seconds, None for none) the whole run; ``threads`` pins
    each rank's torch threads. Raises `RankError` with the failing rank's
    traceback, or `TimeoutError`; no rank outlives the call."""
    ctx = mp.get_context("spawn")
    world = len(devices)
    end = None if deadline is None else time.monotonic() + deadline
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, list(map(str, devices)), backend, init, timeout, threads,
                                   fn, tuple(args), out))
                 for r in range(world)]
        results: dict = {}
        gone: set = set()  # ranks seen exited without a result (it may still be in the pipe)
        try:
            for p in procs:
                p.start()
            while len(results) < world:
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f"the {world} ranks did not finish in {deadline} s")
                try:
                    rank, ok, payload = out.get(timeout=1.0)
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if r in gone and r not in results:
                            raise RankError(f"rank {r} exited with code {p.exitcode} and "
                                            "sent no result")
                        if p.exitcode is not None:
                            gone.add(r)
                    continue
                if not ok:
                    dead = [f"rank {r} exited with code {p.exitcode}" for r, p in enumerate(procs)
                            if r != rank and p.exitcode not in (None, 0)]
                    raise RankError(f"rank {rank} of {world} failed"
                                    + (f" ({'; '.join(dead)} before it)" if dead else "")
                                    + f":\n{payload}")
                results[rank] = payload
            for p in procs:
                p.join(_JOIN_SECONDS)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(_JOIN_SECONDS)
    return [results[r] for r in range(world)]
