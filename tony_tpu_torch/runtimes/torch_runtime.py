"""The torch runtime: the port's primary runtime and default framework.

The counterpart of the JAX package's runtimes/jax_runtime.py, with the same
one contract: the driver collects worker registrations, ranks them by real
task identity (roles in sorted order, then task index), elects rank 0's
registered address as the coordinator, and every executor exports

    TONY_COORDINATOR_ADDRESS  host:port of rank 0's pre-bound port
    TONY_PROCESS_ID           this process's global rank
    TONY_NUM_PROCESSES        world size

which ``tony_tpu_torch.train.init()`` (train/bootstrap.py) reads to join
the job: ``torch.distributed.init_process_group`` with that address as its
TCP store, NCCL on the card (rank r on card r % visible cards) and gloo
for a CPU job. The executor isolates no cards, as the JAX executor isolates
no chips. There is no multislice (MEGASCALE_*) branch: that env comes from
the JAX package's TPU provisioner, which the port does not have.
"""

from __future__ import annotations

from typing import Any

from .. import constants as c
from .base import TaskContext
from .generic import GenericDriverAdapter, GenericTaskAdapter


class TorchDriverAdapter(GenericDriverAdapter):
    def cluster_spec_payload(self, task_id: str) -> dict[str, Any]:
        assert self.session is not None
        spec = self.session.cluster_spec()
        payload: dict[str, Any] = {"cluster": spec}
        ranks: dict[str, int] = {}
        rank = 0
        coordinator = None
        # rank by REAL task identity, not list position: registered_tasks()
        # walks the index order cluster_spec() used, so rank i is address i
        for role in sorted(spec):
            for t in self.session.registered_tasks(role):
                ranks[t.task_id] = rank
                if rank == 0:
                    coordinator = t.address
                rank += 1
        payload["ranks"] = ranks
        payload["num_processes"] = rank
        payload["coordinator_address"] = coordinator
        payload["gang_generation"] = self.session.gang_generation
        return payload


class TorchTaskAdapter(GenericTaskAdapter):
    def build_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_env(ctx)
        payload = ctx.cluster_payload
        task_id = f"{ctx.job_name}:{ctx.task_index}"
        rank = payload.get("ranks", {}).get(task_id, ctx.global_rank())
        env.update({
            c.ENV_COORDINATOR_ADDRESS:
                str(payload.get("coordinator_address") or ""),
            c.ENV_PROCESS_ID: str(rank),
            c.ENV_NUM_PROCESSES:
                str(payload.get("num_processes", ctx.world_size())),
        })
        return env
