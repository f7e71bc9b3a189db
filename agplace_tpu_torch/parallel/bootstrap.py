"""Process bootstrap (``agplace_tpu/parallel/bootstrap.py``): join the
process group of a multi-process run, one process per card.

    torchrun --nproc_per_node 4 -m agplace_tpu_torch.train \\
        --data_parallel -1 ...

Each rank runs the same program; ``initialize_distributed`` reads its rank
from torchrun's environment (or JAX's spellings of it) and is a no-op in a
process launched alone.  Then ``parallel.mesh`` builds meshes over the
group's ranks.

One departure from JAX: with a coordinator configured, a failed join
raises.  JAX logs a warning and carries on as one process, which would
train N independent copies, each believing it runs alone.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from agplace_tpu_torch.parallel.mesh import Mesh, world_size

log = logging.getLogger("bootstrap")


def _env(*names: str) -> Optional[str]:
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA device without
    an index, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(_env("LOCAL_RANK") or 0))
    return dev


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the process group when running multi-process.

    Resolution order: explicit arguments, then the environment:
    ``COORDINATOR_ADDRESS`` / ``JAX_COORDINATOR_ADDRESS`` (``host:port``
    or an ``init_method`` URL such as ``file://...``), else torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``; ``NUM_PROCESSES`` /
    ``JAX_NUM_PROCESSES`` / ``WORLD_SIZE``; ``PROCESS_ID`` /
    ``JAX_PROCESS_ID`` / ``RANK``.  With no coordinator this is a no-op
    that returns False.  Returns True when the group is (already) up.

    ``backend``: ``nccl`` for a CUDA ``device``, ``gloo`` for the CPU, by
    default; a caller may pass ``gloo`` with CUDA tensors (several ranks
    sharing one card).  ``device``: this rank's device (``rank_device``),
    made current for CUDA.  A configured coordinator that fails raises."""
    if dist.is_initialized():
        return True
    addr = coordinator_address or _env("COORDINATOR_ADDRESS",
                                       "JAX_COORDINATOR_ADDRESS")
    if addr is None and _env("MASTER_ADDR"):
        addr = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or 29500}"
    if addr is None:
        log.debug("single-process run (no coordinator configured)")
        return False
    if num_processes is None:
        num_processes = int(_env("NUM_PROCESSES", "JAX_NUM_PROCESSES",
                                 "WORLD_SIZE") or 1)
    if process_id is None:
        process_id = int(_env("PROCESS_ID", "JAX_PROCESS_ID", "RANK") or 0)
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id,
        **({} if timeout is None else {"timeout": timeout}))
    log.info("process group up: rank %d/%d (%s on %s)", dist.get_rank(),
             dist.get_world_size(), backend, dev)
    return True


def make_hybrid_mesh(data_axis: str = "data", gallery_axis: str = "gallery",
                     gallery_parallel: int = 1,
                     devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ``(data, gallery)`` mesh over all ``devices`` (every rank by
    default) with ``data * gallery == n``, laid out host-major: torchrun
    numbers ranks by host (host = rank // ``LOCAL_WORLD_SIZE``), so in
    rank order a gallery row of consecutive ranks stays inside one host
    whenever the gallery width divides the ranks per host, and the data
    axis crosses hosts."""
    devices = list(devices if devices is not None else range(world_size()))
    n = len(devices)
    gp = max(gallery_parallel, 1)
    dp = n // gp
    if dp * gp != n:
        raise ValueError(f"mesh {dp}x{gp} != {n} ranks")
    return Mesh(np.array(sorted(devices)).reshape(dp, gp),
                (data_axis, gallery_axis))
