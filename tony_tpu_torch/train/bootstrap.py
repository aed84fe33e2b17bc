"""Worker-side bootstrap (port of the JAX package's train/bootstrap.py).

The executor exports TONY_COORDINATOR_ADDRESS / TONY_PROCESS_ID /
TONY_NUM_PROCESSES, and training code calls ``init()`` to join the job. This
slice runs one process on one device: ``init`` is a no-op for one process
and raises for more, until the mesh slice brings ``torch.distributed``.
"""

from __future__ import annotations

import os

import torch

from .. import constants as c


def init() -> dict:
    """Join the job described by the env contract -> {process_id,
    num_processes, coordinator, num_devices}. No-op (single process) when
    the contract is absent, so a script runs the same standalone."""
    coordinator = os.environ.get(c.ENV_COORDINATOR_ADDRESS, "")
    num_processes = int(os.environ.get(c.ENV_NUM_PROCESSES, "1"))
    process_id = int(os.environ.get(c.ENV_PROCESS_ID, "0"))
    if num_processes > 1:
        raise NotImplementedError(
            f"{c.ENV_NUM_PROCESSES}={num_processes}: multi-process jobs are "
            "not ported yet (ROADMAP queue 1, mesh/TP item)")
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "coordinator": coordinator,
        "num_devices": (torch.cuda.device_count()
                        if torch.cuda.is_available() else 1),
    }


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


__all__ = ["init", "task_info"]
