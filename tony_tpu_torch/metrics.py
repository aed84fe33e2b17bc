"""Serving metric names and the max/average accumulator (the port's own
copies of the JAX package's metrics.py constants and
``MetricsAccumulator``).

The names are one contract between ``serve``'s /stats ``metrics``
snapshot, its GET /metrics families and the tests. The *_total names are
cumulative counters sampled as gauges: their max_ snapshot is the running
total.
"""

from __future__ import annotations

from typing import Any

# serving-load gauges, fed by cli/serve.ServeApp once a scheduling turn
SERVING_ACTIVE_SLOTS = "serving_active_slots"
SERVING_QUEUE_DEPTH = "serving_queue_depth"
SERVING_PREFILL_REUSED_FRAC = "serving_prefill_reused_frac"
SERVING_SHED_TOTAL = "serving_shed_total"
SERVING_CANCELLED_TOTAL = "serving_cancelled_total"
SERVING_EXPIRED_TOTAL = "serving_expired_total"
SERVING_LOOP_RESTARTS = "serving_loop_restarts"
# latency quantiles sampled from the observability histograms (host
# monotonic spans); the histograms themselves are on GET /metrics
SERVING_TTFT_P50_S = "serving_ttft_p50_s"
SERVING_TTFT_P99_S = "serving_ttft_p99_s"
SERVING_TPOT_P50_S = "serving_tpot_p50_s"
SERVING_TPOT_P99_S = "serving_tpot_p99_s"
SERVING_RETRY_AFTER_S = "serving_retry_after_s"
# request durability: admissions resumed from a journaled prefix, and the
# emitted tokens carried across the failure
SERVING_REPLAYS_TOTAL = "serving_replays_total"
SERVING_REPLAYED_TOKENS_TOTAL = "serving_replayed_tokens_total"
# streaming delivery: live SSE streams, streams ever opened, feeds that
# found a stream's chunk queue full (coalesced, never dropped), clients
# that vanished mid-stream
SERVING_STREAMS_ACTIVE = "serving_streams_active"
SERVING_STREAMS_OPENED_TOTAL = "serving_streams_opened_total"
SERVING_STREAM_STALLS_TOTAL = "serving_stream_backpressure_stalls_total"
SERVING_STREAM_DISCONNECTS_TOTAL = "serving_stream_disconnects_total"
# the paged pool's blocks by owner {state=free|slot|trie|shared}, and KV
# block transfer (which reads 0 until disaggregated roles are ported)
SERVING_KV_POOL_BLOCKS = "serving_kv_pool_blocks"
SERVING_KV_EXPORTS_TOTAL = "serving_kv_exports_total"
SERVING_KV_IMPORTS_TOTAL = "serving_kv_imports_total"
SERVING_KV_IMPORT_REJECTS_TOTAL = "serving_kv_import_rejects_total"
# multi-model serving (models/registry.py): the info gauge, one series a
# registered serving model (value 1); the serving families repeat with a
# {model="..."} label beside the unlabeled process aggregates
SERVING_MODELS = "serving_models"
# speculative serving (models/serving.py _spec_block), per model: verify
# rounds, draft proposals verified and accepted (host-observed, behind
# the pipeline), the next round's gamma, and the acceptance-rate and
# verify-rounds-per-request histograms
SERVING_SPEC_ROUNDS_TOTAL = "serving_spec_rounds_total"
SERVING_SPEC_PROPOSED_TOKENS_TOTAL = "serving_spec_proposed_tokens_total"
SERVING_SPEC_ACCEPTED_TOKENS_TOTAL = "serving_spec_accepted_tokens_total"
SERVING_SPEC_GAMMA = "serving_spec_gamma"
SERVING_SPEC_ACCEPTANCE_RATE = "serving_spec_acceptance_rate"
SERVING_SPEC_VERIFY_ROUNDS = "serving_spec_verify_rounds"


class MetricsAccumulator:
    """Max and running average per metric."""

    def __init__(self) -> None:
        self._count: dict[str, int] = {}
        self._avg: dict[str, float] = {}
        self._max: dict[str, float] = {}

    def observe(self, name: str, value: float) -> None:
        n = self._count.get(name, 0)
        self._avg[name] = (self._avg.get(name, 0.0) * n + value) / (n + 1)
        self._count[name] = n + 1
        self._max[name] = max(self._max.get(name, float("-inf")), value)

    def set(self, name: str, value: float) -> None:
        """Overwrite, for cumulative counters: averaging a monotone
        total's successive values means nothing, so both snapshots report
        the latest total."""
        self._count[name] = 1
        self._avg[name] = value
        self._max[name] = value

    def snapshot(self) -> list[dict[str, Any]]:
        out = []
        for name in sorted(self._count):
            out.append({"name": f"max_{name}", "value": self._max[name]})
            out.append({"name": f"avg_{name}",
                        "value": round(self._avg[name], 3)})
        return out
