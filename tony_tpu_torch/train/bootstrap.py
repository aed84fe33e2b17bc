"""Worker-side bootstrap (port of the JAX package's train/bootstrap.py).

The executor exports TONY_COORDINATOR_ADDRESS (host:port of rank 0's
pre-bound port), TONY_PROCESS_ID and TONY_NUM_PROCESSES, and training code
calls ``init()`` to join the job. Where the JAX package calls
``jax.distributed.initialize``, the port calls
``torch.distributed.init_process_group`` with that address as its TCP store.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch

from .. import constants as c

log = logging.getLogger(__name__)


def init(device=None, timeout_s: int = 300) -> dict:
    """Join the job described by the env contract -> {process_id,
    num_processes, coordinator, num_devices, backend, device}.

    One process takes one device: rank ``r`` takes card ``r % N`` of the N
    cards it sees (a host's ranks are consecutive, so its processes take
    its cards in order). ``device`` is the caller's device: None or a CUDA
    device means the card and the NCCL backend; ``"cpu"`` (tests, CPU
    runs) means gloo. A CUDA job never drops to gloo or to the CPU: a
    missing card or a failed NCCL init raises.

    No-op (a single process, no process group) when the contract is
    absent, so a script runs the same standalone. Unlike the JAX package,
    which skips ``jax.distributed.initialize`` for one process, the port
    joins a group whenever the contract names a coordinator, a world of
    one included: the mesh (parallel/mesh.py) is a ``DeviceMesh`` over
    that group, so a one-process job under the orchestrator runs the same
    NCCL bootstrap and sharded step as a wider one."""
    import torch.distributed as dist

    coordinator = os.environ.get(c.ENV_COORDINATOR_ADDRESS, "")
    num_processes = int(os.environ.get(c.ENV_NUM_PROCESSES, "1"))
    process_id = int(os.environ.get(c.ENV_PROCESS_ID, "0"))
    info = {"process_id": process_id, "num_processes": num_processes,
            "coordinator": coordinator, "backend": None}
    cpu = device is not None and torch.device(device).type == "cpu"
    if not coordinator:
        if num_processes > 1:
            raise RuntimeError(
                f"{c.ENV_NUM_PROCESSES}={num_processes} without "
                f"{c.ENV_COORDINATOR_ADDRESS}: no rendezvous to join")
        info["num_devices"] = (torch.cuda.device_count()
                               if torch.cuda.is_available() and not cpu
                               else 1)
        return info
    if cpu:
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA job needs a card: none is visible "
                               "(pass device='cpu' for a gloo job)")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes, timeout=timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        # one collective now, so a broken transport fails here, not at the
        # first step
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        if int(probe.item()) != num_processes:
            raise RuntimeError(f"{backend} all_reduce over {num_processes} "
                               f"processes gave {probe.item()}")
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a {dist.get_backend()} process group exists; "
                           f"this job needs {backend}")
    log.info("joined job: process %d/%d over %s, coordinator %s, %s",
             process_id, num_processes, backend, coordinator, dev)
    info.update(backend=backend, device=str(dev),
                num_devices=num_processes,
                device_rule="process_id % visible devices" if not cpu
                else "cpu")
    return info


def num_slices() -> int:
    """Slice count from the multislice env contract (1 = one node). Feed to
    ``parallel.build_hybrid_mesh(num_slices=...)`` to lay DCN-safe axes
    across nodes and bandwidth-hungry axes within them."""
    return int(os.environ.get(c.ENV_NUM_SLICES, "1") or 1)


def slice_id() -> int:
    """This host's slice index from the multislice env contract."""
    return int(os.environ.get(c.ENV_SLICE_ID, "0") or 0)


def task_info() -> dict:
    """This task's identity from the executor env contract."""
    env = os.environ
    return {
        "job_name": env.get(c.ENV_JOB_NAME, ""),
        "task_index": int(env.get(c.ENV_TASK_INDEX, "0")),
        "is_chief": env.get(c.ENV_IS_CHIEF, "false") == "true",
        "app_id": env.get(c.ENV_APP_ID, ""),
        "job_dir": env.get(c.ENV_JOB_DIR, ""),
    }


__all__ = ["init", "task_info", "num_slices", "slice_id"]
