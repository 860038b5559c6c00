"""Process-group start-up on torch.distributed (the counterpart of
cadre_tpu.parallel.multihost, which starts jax.distributed).

Under `torchrun` each process finds its place in the environment: RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. A lone process (no
RANK / WORLD_SIZE) starts nothing. Each rank's card is cuda:LOCAL_RANK.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# every collective of a group fails after this long instead of hanging
PG_TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(backend: Optional[str] = None,
                         device="cuda") -> bool:
    """Join the process group that `torchrun` describes in the
    environment (`backend` by default NCCL for a CUDA `device`, gloo for
    the CPU). Returns True when a group is (or already was) initialised,
    False, doing nothing, for a lone process."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(backend or default_backend(device),
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=PG_TIMEOUT)
    return True


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_chief() -> bool:
    """Rank 0 (or a lone process) owns logging and checkpoints (the
    reference's rank == 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0
