"""Control-plane RPC (the port's own copy of the JAX package's rpc/: the
same wire format and HMAC signing, so either package's client talks to the
other's server).

The service contract mirrors the reference's 8-method TonyClusterService
(src/main/proto/tony_cluster_service_protos.proto:11-20) plus the MetricsRpc
service (rpc/MetricsRpc.java), carried as framed JSON over TCP:

  register_worker(task_id, host, port, attempt=-1)
                                       -> cluster_spec | None   (gang barrier;
                                          `attempt` echoes the launch env's
                                          TONY_TASK_ATTEMPT so a recovered
                                          driver's fence can refuse a
                                          superseded attempt's zombie; -1
                                          skips the fence)
  get_cluster_spec(task_id)            -> cluster_spec | None
  get_task_infos()                     -> [TaskInfo]
  heartbeat(task_id)                   -> True | {"profile": {...}}
                                          (a one-shot command for the task)
  register_execution_result(task_id, exit_code) -> str
  register_tensorboard_url(url)        -> bool
  register_callback_info(task_id, payload) -> bool   (runtime rendezvous data)
  finish_application()                 -> bool       (client lets driver exit)
  update_metrics(task_id, metrics, spans=None) -> bool
  get_metrics(task_id)                 -> [MetricSample]
  publish_ports(task_id, ports)        -> bool (named service ports)
  request_task_profile(task_id, seconds=5.0) -> bool (client only under
                                          token auth: queue an on-demand
                                          profiler capture)
  preempt_task, notify_preemption, roll_task
                                       -> refused by the port's driver, each
                                          naming its ROADMAP.md item

The driver piggybacks its commands on the heartbeat RESPONSE, as the JAX
package's does: ``{"profile": {"seconds": N}}`` in place of ``True``, which
the executor's Heartbeater relays to the training child (the JAX driver's
``"preempt"`` command waits for the elastic item).

``update_metrics`` additionally carries executor-side lifecycle spans
([name, unix_ts] pairs: work_dir_ready, child_spawned, child_exited) that
the driver merges into the task's lifecycle trace (observability.
TaskTrace) — the enrichment channel for the gang-launch waterfall.
"""

from .client import RpcClient
from .protocol import RpcError
from .server import RpcServer

__all__ = ["RpcClient", "RpcServer", "RpcError"]
