"""Joining a ``torchrun`` launch: the one place the train CLI
(``--multi_device``) and the campaign (``--mesh``) read the world, the
rank and the backend.

torchrun gives every process ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; the process group is initialized
from them (``init_method="env://"``). Without torchrun the world is one
process and no group is made: the caller runs its single-process step.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(requested: bool, flag: str, lanes: int, what: str,
                     device: str,
                     backend: Optional[str] = None) -> tuple[int, int, str]:
    """``(rank, world, device)`` of this process.

    One process (``WORLD_SIZE`` unset or 1): ``(0, 1, device)``, and a note
    when ``flag`` asked for data parallelism. Under torchrun: raises
    ``ValueError`` unless ``requested`` (the caller's ``flag``) and unless
    the world divides the ``lanes`` of a step (``what`` names them);
    then ``device`` "cuda" becomes this rank's card ``cuda:LOCAL_RANK``
    (made the current one), and the default process group is initialized
    with ``backend``: by default NCCL on the cards and gloo on the CPU
    (gloo also runs ranks that share one card, which NCCL refuses)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if requested:
            print(f"{flag}: one process, so the single-device train step "
                  f"(launch with torchrun for data parallelism)")
        return 0, 1, device
    if not requested:
        raise ValueError(f"launched as {world} processes (WORLD_SIZE): pass "
                         f"{flag} to train data parallel")
    if lanes % world:
        raise ValueError(f"{what} {lanes} does not divide over the {world} "
                         f"ranks")
    import torch
    import torch.distributed as dist

    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if device != "cpu":
        # NCCL's communicator and every op without a device land here
        torch.cuda.set_device(device)
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), world, device
