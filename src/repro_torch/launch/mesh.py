"""Meshes and the process worlds under them.

Port of the JAX package's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over the ranks
of an initialised world (row-major: rank ``r`` sits at the mixed-radix
coordinates of ``r``, the first dim most major, as ``jax.make_mesh`` lays
out devices).  The spec functions of :mod:`repro_torch.sharding` and
:mod:`repro_torch.partition` read only a mesh's dim names and sizes, so
they also take a :class:`~repro_torch.sharding.MeshShape`, which needs no
process group.

Worlds: :func:`init_world` joins one (NCCL for a CUDA device, gloo for the
CPU, unless told otherwise), from ``torchrun``'s environment or from a
``FileStore``; :func:`spawn_host_world` starts ``world`` local processes
over a ``FileStore`` and runs a function on each rank, the port's stand-in
for the reference's ``--xla_force_host_platform_device_count``.  A run on
several cards starts one process a card with ``torchrun`` and NCCL.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_WORLD: dict = {}        # "device": the device type of the current world
_PG_TIMEOUT_S = 60.0     # a spawned world's collectives
_CONNECT_TRIES = 2       # a spawned world's starts when its ranks cannot connect


def init_world(rank: int | None = None, world: int | None = None, *,
               device: str | torch.device = "cuda",
               backend: str | None = None, store_path: str | None = None,
               timeout_s: float = 60.0) -> torch.device:
    """Join a process world; returns this rank's device.

    With ``store_path`` the ranks meet in a ``FileStore`` there (``rank``
    and ``world`` given); without it they read ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  The
    backend is NCCL for a CUDA device and gloo for the CPU; a CUDA world
    of several processes on one card passes ``backend="gloo"`` (NCCL
    refuses two ranks on one device)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device is visible")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    kw: dict = dict(backend=backend, timeout=timeout)
    if device.type == "cuda" and backend == "nccl":
        kw["device_id"] = device
    if store_path is not None:
        if rank is None or world is None:
            raise ValueError("init_world: a FileStore needs rank and world")
        store = dist.FileStore(store_path, world)
        dist.init_process_group(store=store, rank=rank, world_size=world,
                                **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    _WORLD["device"] = device.type
    return device


def world_device() -> torch.device:
    """This rank's device in the current world (the CPU without one)."""
    if _WORLD.get("device") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def close_world() -> None:
    """Leave the world and forget the groups built on it."""
    from repro_torch import collectives
    collectives.forget_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()


def make_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` with dim names ``axes`` over every rank of the
    world (its size must be the product of ``shape``).  The mesh builds no
    process group: :mod:`repro_torch.collectives` builds one per group of
    mesh dims it reduces over."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process world (init_world)")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"make_mesh: {shape} needs {math.prod(shape)} "
                         f"ranks, the world has {n}")
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(_WORLD.get("device", "cpu"), ranks,
                      mesh_dim_names=axes, _init_backend=False)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: it needs a world of 256 or 512 ranks
    and raises on any other, as the reference raises without its
    devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    return make_mesh(shape, axes)


def make_host_mesh(*, data: int | None = None, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks that exist."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data if data is not None else max(1, n // model)
    return make_mesh((data, model), ("data", "model"))


def _rank_main(fn, rank, world, backend, device, store_path, timeout_s,
               args, queue):
    try:
        init_world(rank, world, device=device, backend=backend,
                   store_path=store_path, timeout_s=timeout_s)
    except Exception:
        queue.put((rank, "connect", traceback.format_exc()))
        return
    try:
        try:
            out = fn(rank, *args)
        finally:
            close_world()
        queue.put((rank, "ok", pickle.dumps(out)))
    except Exception:
        queue.put((rank, "failed", traceback.format_exc()))


class _ConnectFailed(RuntimeError):
    """A rank could not join the world (gloo's TCP mesh)."""


def _other_failures(queue, procs, wait_s: float = 5.0) -> str:
    """What the other ranks reported, or how they exited, within
    ``wait_s`` of a first failure."""
    out = []
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            rank, status, payload = queue.get(timeout=0.2)
        except Exception:
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if status != "ok":
            out.append(f"\nrank {rank} ({status}):\n{payload}")
    codes = {r: p.exitcode for r, p in enumerate(procs)}
    return "".join(out) + f"\nexit codes: {codes}"


def _run_world(fn, world, backend, device, timeout_s, args) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, store_path,
                                   _PG_TIMEOUT_S, args, queue), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        results: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn_host_world: {world - len(results)} of "
                        f"{world} ranks still running after {timeout_s} s")
                try:
                    rank, status, payload = queue.get(
                        timeout=min(left, 1.0))
                except Exception:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(
                            f"spawn_host_world: rank {dead[0]} exited "
                            f"with code {procs[dead[0]].exitcode}")
                    continue
                if status != "ok":
                    err = _ConnectFailed if status == "connect" \
                        else RuntimeError
                    raise err(f"spawn_host_world: rank {rank} {status}:\n"
                              f"{payload}" + _other_failures(queue, procs))
                results[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
            queue.close()
    return [results[r] for r in range(world)]


def spawn_host_world(fn: Callable, world: int, *, backend: str = "gloo",
                     device: str = "cpu", timeout_s: float = 180.0,
                     args: tuple = ()) -> list:
    """``[fn(rank, *args) for each rank]``, each rank a process of its own
    in a world of ``world`` over a ``FileStore``.

    ``fn`` must be importable by name (a module-level function).  The
    ranks are joined under ``timeout_s`` of wall time and killed when it
    runs out (``TimeoutError``); a rank's exception is raised here with
    its traceback and what the other ranks reported.  A world whose ranks
    could not connect (gloo's TCP mesh has lost that race on a loaded
    host) is started again, once; ``fn`` has run on no rank then.  Each
    collective times out after 60 s.  Results travel pickled, so keep
    them small."""
    for attempt in range(_CONNECT_TRIES):
        try:
            return _run_world(fn, world, backend, device, timeout_s, args)
        except _ConnectFailed:
            if attempt == _CONNECT_TRIES - 1:
                raise
    raise AssertionError("unreachable")
