"""The ``("data", "model")`` mesh over ``torch.distributed`` and the rank
launcher.

:func:`make_local_mesh` is the counterpart of the JAX package's
``launch/mesh.py:make_local_mesh``: after
``torch.distributed.init_process_group`` it describes this process's
place on a ``("data", "model")`` mesh of ``world // model_parallel``
data replicas of ``model_parallel`` model ranks, global rank ``d *
model_parallel + m`` at data index ``d`` and model index ``m`` (the
reference's device grid, data-major). Each axis has its process group:
the model axis's for tensor-parallel serving (the engine takes one data
replica) and training, the data axis's for data-parallel training
(``launch.steps.make_train_step(mesh=...)`` takes both: data replicas
of model ranks).

:func:`spawn` starts ``world`` ranks of one function and returns rank
0's result; :func:`spawn_tp` is its tensor-parallel form (every rank on
the model axis). They use the ``spawn`` start method (CUDA cannot fork)
and a ``file://`` rendezvous in a fresh temporary directory (no port to
collide with other runs on the machine). The caller names the backend:
``nccl`` where each rank has its own card, ``gloo`` on the CPU and where
ranks share a card (NCCL refuses two ranks of a communicator on one
device). Nothing switches backends after a failure. A rank that fails
or exits (``SystemExit``, a crash) fails the whole launch at once, with
its exit code: the other ranks, blocked in a collective, are killed
rather than left to the process group's timeout.
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Dict, Tuple

import torch

BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    """One rank's view of the ``("data", "model")`` mesh. A group is None
    where its axis has one rank (no collective runs over it)."""
    shape: Dict[str, int]
    rank: int                            # this process's rank on "model"
    device: torch.device
    group: Any = None                    # the model axis's process group
    backend: str = "gloo"
    axis_names: Tuple[str, ...] = field(default=("data", "model"))
    data_rank: int = 0                   # this process's rank on "data"
    data_group: Any = None               # the data axis's process group


def _axis_groups(dist, n: int, model_parallel: int, rank: int):
    """(model group, data group) of global ``rank``. Every rank creates
    every group, in the same order (``new_group`` is collective); an
    axis spanning the world is the default group, an axis of one rank
    has none."""
    data = n // model_parallel
    mine = {}
    for axis, count, size in (("model", data, model_parallel),
                              ("data", model_parallel, data)):
        if size == 1:
            mine[axis] = None
        elif size == n:
            mine[axis] = dist.group.WORLD
        else:
            for i in range(count):
                ranks = ([i * model_parallel + m for m in range(size)]
                         if axis == "model" else
                         [d * model_parallel + i for d in range(size)])
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[axis] = g
    return mine["model"], mine["data"]


def make_local_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """This process's mesh over the initialised default process group:
    ``world // model_parallel`` data replicas of ``model_parallel``
    ranks. Raises ValueError when ``model_parallel`` does not divide the
    world size."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide the world size "
            f"({n} processes) — start a multiple of {model_parallel} "
            "ranks or pick a TP degree that divides the world")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = torch.device("cpu") if device is None else torch.device(device)
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    group, data_group = (_axis_groups(dist, n, model_parallel, rank)
                         if dist.is_initialized() else (None, None))
    return Mesh(shape={"data": n // model_parallel, "model": model_parallel},
                rank=rank % model_parallel, device=dev, group=group,
                backend=backend, data_rank=rank // model_parallel,
                data_group=data_group)


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or ``cuda:{rank % device_count}``
    (ranks beyond the cards share them round-robin)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_backend(backend: str, device: str, world: int) -> None:
    """Refuse a backend that cannot run: NCCL off CUDA, or NCCL with two
    ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend is one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA ranks; pass "
                             "backend='gloo' on the CPU")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"{world} ranks on {n} CUDA device(s) would share a card, "
                "which NCCL refuses; pass backend='gloo' (it moves the "
                "tensors through host memory)")


def _worker(rank: int, world: int, model_parallel: int, call: str,
            init: str, backend: str, device: str, timeout_s: float,
            out) -> None:
    import torch.distributed as dist
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_local_mesh(model_parallel, device=dev)
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result if rank == 0 else None))
    except SystemExit as e:
        # a rank that exits on purpose (run_qat's simulated failure)
        # says so before it goes; its exit code is the process's
        out.put((rank, False, f"SystemExit: exit code {e.code}\n"
                 + traceback.format_exc()))
        raise
    except Exception:                    # noqa: BLE001 - report every fault
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, *args, model_parallel: int = 1,
          device: str = "cuda", backend: str = "nccl",
          timeout_s: float = 600.0, deadline: bool = True) -> Any:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, a mesh of ``world //
    model_parallel`` data replicas of ``model_parallel`` model ranks,
    and return rank 0's result. ``fn`` and ``args`` must pickle (a
    module-level function); every rank gets the same arguments. Raises
    RuntimeError with each failed rank's traceback and the exit code of
    every rank that died if any rank fails, and kills every rank and
    raises TimeoutError once ``timeout_s`` has passed, unless
    ``deadline`` is False (a server that runs until it is stopped).
    ``timeout_s`` is also the process group's: a collective that waits
    longer for a rank fails."""
    import multiprocessing as mp
    check_backend(backend, device, world)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    # the function and its arguments go through a file each rank reads
    # once it has started: a process's own arguments travel through a
    # pipe the parent fills before it starts the next rank, so arguments
    # larger than the pipe's buffer would start the ranks one after the
    # other, each waiting for the last to finish its imports
    call = os.path.join(tmp, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, model_parallel, call, init,
                               backend, device, timeout_s, out),
                         daemon=True)
             for r in range(world)]
    results: Dict[int, Tuple[bool, Any]] = {}

    def exited():
        return {r: p.exitcode for r, p in enumerate(procs)
                if p.exitcode is not None and p.exitcode != 0}

    try:
        for p in procs:
            p.start()
        until = time.monotonic() + timeout_s if deadline else math.inf
        while len(results) < world:
            left = until - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world - len(results)} of {world} ranks did "
                    f"not finish within {timeout_s} s (ranks done: "
                    f"{sorted(results)})")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a rank that died without reporting (a crash in C)
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]} and no "
                            "result")
                continue
            results[rank] = (ok, val)
            if not ok:
                break
        failed = {r: v for r, (ok, v) in results.items() if not ok}
        if failed:
            # give the other ranks a moment to report their own faults
            # and a rank that is exiting time to give its exit code
            end = time.monotonic() + 2.0
            while time.monotonic() < end and len(results) < world:
                try:
                    rank, ok, val = out.get(timeout=0.2)
                    results[rank] = (ok, val)
                    if not ok:
                        failed[rank] = val
                except queue_mod.Empty:
                    pass
            codes = "".join(f"; rank {r}: exit code {c}"
                            for r, c in sorted(exited().items()))
            raise RuntimeError(
                "spawn: rank(s) failed" + codes + ":\n"
                + "\n".join(f"--- rank {r} ---\n{tb}"
                            for r, tb in sorted(failed.items())))
        return results[0][1]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)


def spawn_tp(fn: Callable, tp: int, *args, device: str = "cuda",
             backend: str = "nccl", timeout_s: float = 600.0,
             deadline: bool = True) -> Any:
    """:func:`spawn` of ``tp`` ranks on the model axis (one data
    replica): tensor-parallel serving's launcher."""
    return spawn(fn, tp, *args, model_parallel=tp, device=device,
                 backend=backend, timeout_s=timeout_s, deadline=deadline)
