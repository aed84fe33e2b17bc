"""Configuration key constants and per-role key accessors.

Mirrors the reference's key registry (tony-core/.../TonyConfigurationKeys.java:1-339):
every global key has an entry in conf/defaults.json (cross-checked by
tests/test_config.py, the way TestTonyConfigurationFields.java cross-checks
tony-default.xml), and per-role keys are generated from templates so that new
roles (ps/worker/chief/evaluator/scheduler/head/driver/...) need no code change
(reference discovers roles by regex, TonyConfigurationKeys.java:189-191).
"""

from __future__ import annotations

import re

PREFIX = "tony."

# ---------------------------------------------------------------- application
APPLICATION_NAME = "tony.application.name"
APPLICATION_FRAMEWORK = "tony.application.framework"  # torch|serving|standalone|generic
APPLICATION_DISTRIBUTED_MODE = "tony.application.distributed-mode"  # GANG|FCFS
APPLICATION_TIMEOUT_MS = "tony.application.timeout-ms"  # 0 = no timeout
APPLICATION_TAGS = "tony.application.tags"
APPLICATION_PREPARE_STAGE = "tony.application.prepare-stage"
APPLICATION_TRAINING_STAGE = "tony.application.training-stage"
APPLICATION_UNTRACKED_JOBTYPES = "tony.application.untracked.jobtypes"
APPLICATION_STOP_ON_FAILURE_JOBTYPES = "tony.application.stop-on-failure-jobtypes"
APPLICATION_FAIL_ON_WORKER_FAILURE = "tony.application.fail-on-worker-failure-enabled"
APPLICATION_ENABLE_PREPROCESS = "tony.application.enable-preprocess"
APPLICATION_NODE_LABEL = "tony.application.node-label"

# --------------------------------------------------------------------- driver
AM_RETRY_COUNT = "tony.am.retry-count"
AM_MONITOR_INTERVAL_MS = "tony.am.monitor-interval-ms"
AM_RPC_HOST = "tony.am.rpc-host"
AM_REGISTRATION_TIMEOUT_MS = "tony.am.registration-timeout-ms"
AM_ALLOCATION_TIMEOUT_MS = "tony.am.allocation-timeout-ms"  # gang-deadlock breaker
# driver GET /metrics (Prometheus text): 0 = ephemeral port (advertised in
# driver.json next to the RPC endpoint), -1 = disabled
AM_METRICS_PORT = "tony.am.metrics-port"

# ---------------------------------------------------------------------- tasks
TASK_HEARTBEAT_INTERVAL_MS = "tony.task.heartbeat-interval-ms"
TASK_MAX_MISSED_HEARTBEATS = "tony.task.max-missed-heartbeats"
TASK_METRICS_INTERVAL_MS = "tony.task.metrics-interval-ms"
TASK_REGISTRATION_POLL_MS = "tony.task.registration-poll-interval-ms"
TASK_EXECUTOR_EXECUTION_TIMEOUT_MS = "tony.task.executor.execution-timeout-ms"
TASK_PORT_REUSE_ENABLED = "tony.task.port-reuse-enabled"      # SO_REUSEPORT rendezvous port
TASK_TB_PORT_REUSE_ENABLED = "tony.task.tb-port-reuse-enabled"  # SO_REUSEPORT TB port
TASK_MAX_TOTAL_INSTANCES = "tony.task.max-total-instances"
# drain grace for a preemption notice (heartbeat "preempting" command or
# an executor-received SIGTERM): how long the executor gives the training
# child to checkpoint at a step boundary before killing it
TASK_PREEMPT_GRACE_MS = "tony.task.preempt-grace-ms"
# driver-outage window (docs/training-robustness.md "Control-plane
# recovery"): how long an executor whose heartbeat RPCs fail at the
# TRANSPORT level keeps its training child stepping — re-resolving the
# driver endpoint from the rewritten driver.json each beat — before it
# gives up, checkpoint-drains the child, and exits. Warm-pool standbys
# honor the same window before self-reaping on a dead watched driver
# pid. In-contact refusals (the driver answered and said no) stay on
# the max-missed-heartbeats budget.
TASK_DRIVER_OUTAGE_GRACE_MS = "tony.task.driver-outage-grace-ms"
TASK_MAX_TOTAL_MEMORY_MB = "tony.task.max-total-memory-mb"
TASK_MAX_TOTAL_CHIPS = "tony.task.max-total-chips"

# -------------------------------------------------------------------- staging
STAGING_DIR = "tony.staging.dir"
HISTORY_DIR = "tony.history.location"
HISTORY_INTERMEDIATE = "tony.history.intermediate"
HISTORY_FINISHED = "tony.history.finished"
# bearer token gating every portal route ("" = open); the analogue of the
# reference portal living behind Hadoop-secured infra
# (tony-portal/app/hadoop/Requirements.java)
PORTAL_TOKEN = "tony.portal.token"
HISTORY_RETENTION_SEC = "tony.history.retention-sec"
HISTORY_MOVER_INTERVAL_MS = "tony.history.mover-interval-ms"
SRC_DIR = "tony.application.src-dir"
# job-archive shipping to remote executor hosts (reference HDFS staging,
# TonyClient.java:232-315): URI executors fetch the archive from, an optional
# client-side upload command template ({archive}, {uri}), and a per-task
# switch forcing fetch+unpack even when the path looks shared
APPLICATION_ARCHIVE_URI = "tony.application.archive-uri"
APPLICATION_ARCHIVE_UPLOAD_CMD = "tony.application.archive-upload-cmd"
# sha256 of the built archive, frozen at submit time and verified by every
# executor before unpack — the integrity role of the reference's token-secured
# HDFS staging (TonyClient.java:981-1030) on untrusted transports (http, gs)
APPLICATION_ARCHIVE_SHA256 = "tony.application.archive-sha256"
TASK_LOCALIZE = "tony.task.localize"
PYTHON_VENV = "tony.application.python-venv"
PYTHON_BINARY_PATH = "tony.application.python-binary-path"
EXECUTION_ENV = "tony.execution.env"  # list of K=V propagated to every task

# containerized task launch (reference Docker-on-YARN support: key names from
# TonyConfigurationKeys.java:245-290, wrapping from HadoopCompatibleAdapter
# .java:45-159; here the executor wraps the command itself)
DOCKER_ENABLED = "tony.docker.enabled"
DOCKER_IMAGE = "tony.docker.containers.image"   # image for all task processes
DOCKER_MOUNTS = "tony.docker.containers.mount"  # list of src:dst[:ro]
DOCKER_RUN_ARGS = "tony.docker.extra-args"      # list of extra docker-run flags


def docker_image_key(role: str) -> str:
    """Per-role image override (reference getDockerImageKey)."""
    return f"tony.docker.{role}.image"

# -------------------------------------------------------------------- secrets
SECURITY_TOKEN_ENABLED = "tony.security.token-enabled"

# ------------------------------------------------------------------- cluster
CLUSTER_PROVISIONER = "tony.cluster.provisioner"  # local|static (tpu-pod refused)
CLUSTER_STATIC_HOSTS = "tony.cluster.static-hosts"
# {host}/{env} command template for static-host launches ("" = default ssh)
CLUSTER_LAUNCH_TEMPLATE = "tony.cluster.launch-template"
TPU_TOPOLOGY = "tony.tpu.topology"  # e.g. v5e-8; "" = discover
TPU_ACCELERATOR_TYPE = "tony.tpu.accelerator-type"
TPU_DISCOVER_COMMAND = "tony.tpu.discover-command"  # prints one worker host per line
# slice lifecycle (the RM capacity-allocation half, reference
# TonyClient.submitApplication:317-353 + async container grants,
# ApplicationMaster.java:1100-1119): command templates keep cloud CLIs out
# of core. create-command materializes the slice (e.g. `gcloud compute tpus
# tpu-vm create ...` or a queued-resources request); the driver then polls
# discover-command until the slice reports its full host complement
# (await-READY). delete-command tears down what the driver created — run at
# job end only for driver-created slices, and before re-creation when a
# preempted slice must be replaced.
TPU_CREATE_COMMAND = "tony.tpu.create-command"
TPU_DELETE_COMMAND = "tony.tpu.delete-command"
# >1 = the job spans N slices (multislice): each lifecycle/discover command
# template is instantiated once per slice with `{slice}` replaced by the
# slice index (0..N-1) — one cloud resource per slice — and executors get
# TONY_SLICE_ID / TONY_NUM_SLICES / TONY_SLICE0_HOST so the JAX runtime can
# bring up cross-slice (DCN) transport. Reference analogue: the RM granting
# containers across racks (ApplicationMaster.java:1100-1119).
TPU_NUM_SLICES = "tony.tpu.num-slices"
TPU_CREATE_TIMEOUT_S = "tony.tpu.create-timeout-s"  # await-READY deadline
TPU_CREATE_POLL_S = "tony.tpu.create-poll-interval-s"
# discovery attempts before the lifecycle path declares the slice gone and
# deletes+recreates — armor against one transient describe flake destroying
# healthy capacity
TPU_DISCOVER_RETRIES = "tony.tpu.discover-retries"
# regex matched against a failed discover-command's stderr: a match is
# positive "the cloud says the slice does not exist" evidence; only then
# (or on a successful-but-partial describe) may the lifecycle path
# delete+recreate. A nonzero exit that does NOT match (API 5xx, auth
# outage, timeout) aborts instead of destroying possibly-healthy capacity.
TPU_NOT_FOUND_PATTERN = "tony.tpu.not-found-pattern"
# consecutive identical host lists required to declare READY when no
# accelerator-type gives an exact host count (stalled partial endpoint
# lists can look stable briefly; more polls = stronger evidence)
TPU_READY_STABLE_POLLS = "tony.tpu.ready-stable-polls"

# ------------------------------------------------------------------ serving
# serving job type (tony.application.framework = serving): the executor-side
# adapter watches each replica child's /healthz and converts a terminally
# down serving loop into a container failure the driver's restart budget
# handles (runtimes/serving.py)
SERVING_HEALTHZ_INTERVAL_MS = "tony.serving.healthz-interval-ms"
# consecutive bad post-ready polls (503 down / unreachable) before the
# adapter kills the child and exits nonzero
SERVING_HEALTHZ_DOWN_POLLS = "tony.serving.healthz-down-polls"
# how long a replica gets from spawn to its first healthy /healthz before
# the adapter gives up (model load + first compile can dominate)
SERVING_READY_TIMEOUT_MS = "tony.serving.ready-timeout-ms"
# paged-KV serving (serve --paged-kv family; docs/serving.md "Paged KV &
# admission tiers"): replica launch commands templated from conf pick
# these up instead of hard-coding flags per job file
SERVING_PAGED_KV = "tony.serving.paged-kv"
SERVING_KV_BLOCK = "tony.serving.kv-block"
SERVING_KV_POOL_BLOCKS = "tony.serving.kv-pool-blocks"
SERVING_PREFILL_INTERLEAVE = "tony.serving.prefill-interleave"
SERVING_CLASS_BUDGET_INTERACTIVE = \
    "tony.serving.class-budget-interactive"
SERVING_CLASS_BUDGET_BATCH = "tony.serving.class-budget-batch"
SERVING_BATCH_QUEUE_FRAC = "tony.serving.batch-queue-frac"
# disaggregated prefill/decode serving (docs/serving.md "Disaggregated
# serving"): carve the replica gang into phase tiers by task index —
# the first P replicas launch with --role prefill (forcing --paged-kv:
# the KV block is the transfer unit), the next D with --role decode,
# the remainder --role both. 0/0 (default) = a uniform "both" fleet.
SERVING_PREFILL_INSTANCES = "tony.serving.prefill-instances"
SERVING_DECODE_INSTANCES = "tony.serving.decode-instances"

# ------------------------------------------------------------------ training
# elastic, preemption-tolerant training (docs/training-robustness.md):
# with elastic enabled, a worker lost beyond its restart budget detaches
# from the gang instead of failing the job — the driver bumps the gang
# generation, survivors drain (checkpoint) and re-register at the new
# world size, and the detached slot is retried every rescale-retry-ms
# until capacity returns (then the gang resizes back up).
TRAIN_ELASTIC_ENABLED = "tony.train.elastic-enabled"
# floor on the surviving world size: a resize that would drop the role
# below this (or lose the chief) fails the job like before
TRAIN_ELASTIC_MIN_INSTANCES = "tony.train.elastic-min-instances"
TRAIN_RESCALE_RETRY_MS = "tony.train.rescale-retry-ms"
# straggler action: a worker whose pushed step-time p50 exceeds
# factor x the role median gets a budget-charged restart through the
# normal _try_restart_task path. 0 disables (observation-only, the PR 5
# behavior); sane values start around 2-3.
TRAIN_STRAGGLER_RESTART_FACTOR = "tony.train.straggler-restart-factor"
# consecutive monitor checks a task must look slow before the restart
# fires (one noisy push must not cost a budget unit)
TRAIN_STRAGGLER_GRACE_CHECKS = "tony.train.straggler-grace-checks"

# ---------------------------------------------------------------- autoscaling
# closed-loop serving autoscaler (the JAX package's autoscale.py, docs/
# autoscaling.md): a driver-resident controller watches the serving
# fleet's merged telemetry (per-replica /metrics TTFT buckets + /stats
# queue depths, optionally a router /stats) and scales the serving role
# between min and max replicas — scale-up launches a parked slot via the
# normal (warm-pool-adopting) launch path, scale-down SIGTERM-drains the
# least-loaded replica and parks its slot. Decisions are journaled so a
# recovered driver resumes mid-cooldown instead of flapping.
AUTOSCALE_ENABLED = "tony.autoscale.enabled"
# the serving role the controller scales ("" = the job's single role;
# multi-role jobs must name it)
AUTOSCALE_ROLE = "tony.autoscale.role"
# scale-up SLOs: windowed fleet TTFT p99 (seconds; 0 = ignore) and total
# queued requests across replicas (0 = ignore). Breaching EITHER for
# breach-ticks consecutive controller ticks triggers a scale-up.
AUTOSCALE_TTFT_P99_SLO_S = "tony.autoscale.ttft-p99-slo-s"
AUTOSCALE_QUEUE_DEPTH_SLO = "tony.autoscale.queue-depth-slo"
# decode-tier SLO for disaggregated fleets (docs/autoscaling.md
# "Two-tier scaling"): windowed fleet TPOT p99 in seconds/token (0 =
# ignore). On a fleet with role specialists, a queue breach scales the
# PREFILL tier while a TTFT/TPOT breach scales the DECODE tier.
AUTOSCALE_TPOT_P99_SLO_S = "tony.autoscale.tpot-p99-slo-s"
# replica-count bounds: min is the steady-state floor (the slots above
# it start PARKED — detached, unlaunched); max 0 = the role's instances
AUTOSCALE_MIN = "tony.autoscale.min"
AUTOSCALE_MAX = "tony.autoscale.max"
# hysteresis: no two scale decisions inside the cooldown, and scale-down
# additionally needs the signals CLEAR (below half the SLO) for a full
# cooldown — flapping costs drains, so the loop is deliberately sticky
AUTOSCALE_COOLDOWN_S = "tony.autoscale.cooldown-s"
# controller tick cadence (telemetry poll + decision)
AUTOSCALE_INTERVAL_S = "tony.autoscale.interval-s"
# consecutive breaching ticks before a scale-up fires (one noisy window
# must not launch capacity)
AUTOSCALE_BREACH_TICKS = "tony.autoscale.breach-ticks"
# optional fleet-router /stats URL merged into the controller's view
# (the router sees posted-but-unadmitted traffic the replicas' own
# stats lag on; the two views OVERLAP, so the control law takes their
# max, never the sum)
AUTOSCALE_ROUTER_STATS_URL = "tony.autoscale.router-stats-url"
# router-TIER scaling (docs/autoscaling.md "Three-tier scaling"): the
# role whose tasks are fleet routers ("" = auto-detect the role whose
# framework is "router"; the tier is scaled only when such a role
# exists), the per-router relay-inflight SLO that breaches it (mean of
# router_relay_inflight across live front doors; 0 = never scale the
# tier), and its steady-state floor (slots above the floor start
# parked, exactly like the serving role's)
AUTOSCALE_ROUTER_ROLE = "tony.autoscale.router-role"
AUTOSCALE_ROUTER_RELAY_SLO = "tony.autoscale.router-relay-slo"
AUTOSCALE_ROUTER_MIN = "tony.autoscale.router-min"

# ------------------------------------------------------- metrics hub / SLO
# fleet metrics pipeline (the JAX package's metricshub.py) + SLO
# burn-rate alerting (its slo.py, docs/observability.md "Metrics pipeline &
# SLO alerting"). Objectives are DECLARATIVE, one per name:
#
#   tony.slo.<name>.objective    availability | ttft-p99 | tpot-p99
#   tony.slo.<name>.target       good/total promised (e.g. 0.99)
#   tony.slo.<name>.window-s     SLO horizon; the four alert windows
#                                derive from it (fast W/6+W/60, slow
#                                W+W/6) — bench/test clocks shrink it
#   tony.slo.<name>.threshold-s  latency objectives: the "good" bound
#   tony.slo.<name>.fast-burn    fast-pair burn threshold (14.4)
#   tony.slo.<name>.slow-burn    slow-pair burn threshold (6.0)
#
# <name> may not contain dots. The keys below tune the shared pipeline:
# the hub's own scrape cadence (used when no autoscaler tick is already
# driving the scrapes), its ring retention horizon, and the per-series
# point bound.
SLO_PREFIX = "tony.slo."
SLO_SCRAPE_INTERVAL_S = "tony.slo.scrape-interval-s"
SLO_HUB_RETENTION_S = "tony.slo.hub-retention-s"
SLO_HUB_MAX_POINTS = "tony.slo.hub-max-points"

# ------------------------------------------------------------------- quota
# multi-tenant arbitration (the JAX package's ResourceArbiter): all
# roles share one device/slot pool; per-role quotas cap what each may
# hold, and priority classes decide who yields when the pool is
# exhausted — `interactive` (serving) capacity demands preempt `batch`
# (training) workers via the budget-free preempt drain, and batch
# reclaims the slots when the interactive tier scales back down.
# 0 = the sum of configured role instances (no oversubscription).
QUOTA_POOL_SLOTS = "tony.quota.pool-slots"

# ------------------------------------------------------------------ training
# checkpoint directory of the (elastic) training role, used by the
# checkpoint-aware rescale placement: a worker relaunched on the
# capacity-return path gets TONY_PRESTAGE_CKPT so its executor restores
# (pre-reads) the newest checkpoint BEFORE registering — the gang
# barrier opens onto a worker whose checkpoint bytes are already local.
# May reference task env vars (e.g. .../ckpt_$TONY_TASK_INDEX).
TRAIN_CKPT_DIR = "tony.train.checkpoint-dir"

# ----------------------------------------------------------------- warm pool
# warm executor pool (the JAX package's warmpool.py, docs/performance.md "Launch
# path"): N standby python children per host that have already imported
# jax + initialized the backend; a task launch ADOPTS one instead of
# cold-spawning, cutting submit->first-step, relaunch, resize, and roll
# latency by the prepaid bill (BENCH r05: 23.6s of a 29.3s cold start).
# 0 disables (every launch spawns cold).
WARMPOOL_SIZE = "tony.warmpool.size"
# optional dotted module imported during standby warmup; its warmup()
# (if defined) runs after the default jax warmup — the hook for
# pre-staging data / prepaying heavyweight imports the role command needs
WARMPOOL_WARMUP_MODULE = "tony.warmpool.warmup-module"
# where the pool lives; "" = <job dir>/warmpool (per-job pool). Point
# several jobs at one host-level dir to share standbys across submits.
WARMPOOL_DIR = "tony.warmpool.dir"

# ------------------------------------------------------------------ horovod
HOROVOD_TEST_MODE = "tony.horovod.mode.test"              # stub rendezvous server
HOROVOD_FAST_FAIL = "tony.horovod.driver.fast-fail"       # driver exits 1 at once
HOROVOD_DEBUG_COMMAND = "tony.horovod.driver.debug-command"  # user-supplied driver
HOROVOD_DRIVER_START_TIMEOUT_MS = "tony.horovod.driver.start-timeout-ms"

# ----------------------------------------------------------- per-role templates
# reference: tony.<job>.{instances,memory,vcores,gpus,command,resources,
# node-label,depends-on,max-instances} (TonyConfigurationKeys.java getInstancesKey etc.)
ROLE_KEY_TEMPLATES = (
    "instances",
    "memory-mb",
    "vcores",
    "chips",       # cards per task (the reference's 'gpus')
    "command",
    "resources",
    "node-label",
    "depends-on",
    "max-instances",
    "env",
    "max-restarts",  # per-task restart budget — exceeds the reference, which
                     # only supports whole-job AM retry (SURVEY.md §5)
    "framework",     # per-role runtime override (multi-tenant jobs mix
                     # serving replicas with training workers; "" = the
                     # app-level tony.application.framework)
    "priority-class",  # arbiter tier: "interactive" (default) or "batch"
                       # — batch roles donate capacity to interactive
                       # ones under pool pressure (docs/autoscaling.md)
    "quota",         # max pool slots this role may hold (-1 = instances)
)

_ROLE_KEY_RE = re.compile(r"^tony\.([A-Za-z][A-Za-z0-9_\-]*)\.instances$")
_RESERVED_NON_ROLES = frozenset(
    # "router" is deliberately NOT reserved: the router tier is an
    # ordinary role (tony.router.instances, framework "router" —
    # docs/serving.md "Router tier HA"), and no global tony.router.*
    # keys exist to collide with it
    {"application", "am", "task", "staging", "history", "cluster", "tpu",
     "security", "execution", "horovod", "version", "serving",
     "train", "warmpool", "autoscale", "quota"}
)


def role_key(role: str, template: str) -> str:
    """tony.<role>.<template> — e.g. role_key('worker', 'instances')."""
    if template not in ROLE_KEY_TEMPLATES:
        raise KeyError(f"unknown role key template: {template}")
    return f"tony.{role}.{template}"


def instances_key(role: str) -> str:
    return role_key(role, "instances")


def command_key(role: str) -> str:
    return role_key(role, "command")


def depends_on_key(role: str) -> str:
    return role_key(role, "depends-on")


def discover_roles(conf_dict: dict) -> list[str]:
    """Find roles by scanning for tony.<role>.instances keys.

    Mirrors the reference's regex discovery (util/Utils.java:451-460) so
    arbitrary role names (ps, worker, chief, evaluator, scheduler, head,
    driver, tensorboard, notebook, ...) work without code changes.
    """
    roles = []
    for key in conf_dict:
        m = _ROLE_KEY_RE.match(key)
        if m and m.group(1) not in _RESERVED_NON_ROLES:
            roles.append(m.group(1))
    return sorted(roles)
