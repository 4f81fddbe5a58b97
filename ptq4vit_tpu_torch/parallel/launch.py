"""Ranks of a device mesh: one process per rank over ``torch.distributed``.

The JAX package drives every device from one controller; the port runs
one process per rank instead, each executing the same user code on the
same full host inputs (``parallel/mesh.py`` then gives each rank its
rows).  ``spawn`` starts the ranks itself; ``run_from_env`` is one rank
started by ``torchrun``.

The backend follows the rank -> device map: "nccl" when every rank has a
card of its own, "gloo" when the ranks run on the CPU or share a card
(NCCL refuses two ranks on one GPU; gloo carries CUDA tensors).  It is
printed, and never switched after a failure.  A rank's exception ends the
whole launch with that error, and a collective that waits longer than
``timeout`` fails, so no rank hangs.

The ranks run on the card unless the caller asks for the CPU, as every
entry point of the port does (``models/registry.resolve_device``): without
a card, ``default_devices``, ``spawn``, ``run_from_env`` and
``rank_device`` raise, unless given ``devices=["cpu"] * world``,
``device="cpu"``, or (a rank started outside them) ``bind_device("cpu")``.
"""
from __future__ import annotations

import datetime
import glob
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from ..models.registry import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

_DEVICE: Optional[torch.device] = None      # this rank's device


def bind_device(device) -> torch.device:
    """Make ``device`` this rank's device (``spawn`` and ``run_from_env``
    do it for the ranks they start; a rank started otherwise calls it
    itself, ``"cpu"`` to run on the CPU); the card is made current."""
    global _DEVICE
    _DEVICE = resolve_device(device)
    if _DEVICE.type == "cuda":
        torch.cuda.set_device(_DEVICE)
    return _DEVICE


def rank_device() -> torch.device:
    """The device this rank was bound to (``bind_device``); for a rank
    that was not, the card, and without one an error."""
    if _DEVICE is not None:
        return _DEVICE
    return resolve_device(None)


def default_devices(world: int, device=None):
    """One card a rank while there are enough, the ranks sharing them
    round-robin otherwise; ``device="cpu"``: every rank on the CPU.
    Without a card and without ``device="cpu"`` it raises."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * world
    resolve_device(device)
    n = torch.cuda.device_count()
    return [f"cuda:{r % n}" for r in range(world)]


def choose_backend(devices: Sequence) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index or 0 for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def describe(backend: str, devices: Sequence) -> str:
    return (f"[launch] {len(devices)} ranks, backend {backend}, ranks -> "
            "devices " + ", ".join(f"{r}: {torch.device(d)}"
                                   for r, d in enumerate(devices)))


def _run_rank(rank: int, fn: Callable, world: int, device, backend: str,
              init_method: str, timeout: datetime.timedelta, args,
              err_file: Optional[str] = None) -> None:
    """Initialize the rank's process group, run ``fn(rank, *args)``, end
    the group.  ``err_file`` gets the time and traceback of an exception
    before the group ends (the peers' collectives fail after it)."""
    dev = bind_device(device)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout,
                            **kw)
    try:
        fn(rank, *args)
    except BaseException:
        if err_file is not None:
            with open(err_file, "w") as f:
                f.write(f"{time.time()!r} {rank}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _spawned(rank, fn, world, devices, backend, init_method, timeout, args,
             err_dir):
    _run_rank(rank, fn, world, devices[rank], backend, init_method, timeout,
              args, os.path.join(err_dir, f"rank{rank}.err"))


def spawn(fn: Callable, world: int, *, devices: Optional[Sequence] = None,
          backend: Optional[str] = None, init_method: Optional[str] = None,
          args: tuple = (), timeout: datetime.timedelta = DEFAULT_TIMEOUT
          ) -> None:
    """Run ``fn(rank, *args)`` on ``world`` ranks, each in a process of its
    own (start method ``spawn``), rank r on ``devices[r]`` (default:
    ``default_devices``, the cards; ``["cpu"] * world`` runs them on the
    CPU), and wait for all of them.  ``init_method``
    defaults to a rendezvous file in a fresh temporary directory.  A rank
    that raises makes this raise the first failing rank's error (the other
    ranks are terminated)."""
    devices = [str(d) for d in (devices or default_devices(world))]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    chosen = choose_backend(devices)
    if backend is None:
        backend = chosen
    elif backend == "nccl" and chosen != "nccl":
        raise ValueError("nccl needs a card of its own for every rank: "
                         f"{devices}")
    print(describe(backend, devices), flush=True)
    tmp = tempfile.mkdtemp(prefix="ptq4vit_launch_")
    if init_method is None:
        init_method = "file://" + os.path.join(tmp, "store")
    try:
        mp.start_processes(_spawned, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, devices, backend, init_method,
                                 timeout, tuple(args), tmp))
    except ProcessException as e:
        # the first rank to fail is the cause; the others failed in a
        # collective with it
        errs = []
        for p in glob.glob(os.path.join(tmp, "rank*.err")):
            with open(p) as f:
                stamp, _, text = f.read().partition(" ")
            errs.append((float(stamp), text))
        if not errs:
            raise
        rank, _, tb = min(errs)[1].partition("\n")
        raise RuntimeError(f"rank {rank} failed first:\n{tb}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_from_env(fn: Callable, *args, device=None,
                 timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """One rank started by ``torchrun`` (``env://``): the host's local
    ranks take their devices as ``default_devices`` deals them (the cards;
    ``device="cpu"``: the CPU), the backend is ``choose_backend``'s for
    that map; then ``fn(rank, *args)``, then the process group's end."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    devices = default_devices(int(os.environ.get("LOCAL_WORLD_SIZE",
                                                 world)), device)
    backend = choose_backend(devices)
    if rank == 0:
        print(f"{describe(backend, devices)} (torchrun: this host's "
              f"ranks of {world})", flush=True)
    _run_rank(rank, fn, world, devices[int(os.environ.get("LOCAL_RANK", 0))],
              backend, "env://", timeout, args)
