"""Process-boundary contracts: environment variables, well-known files,
the fault-injection hooks and the exit codes (the port's own copy of the
JAX package's constants.py, which the port does not import).

The driver -> executor -> user-process env contract is the JAX package's
name for name, so a training script reads the same variables under either
package's launcher.
"""

# ---- driver -> executor env contract
ENV_JOB_NAME = "TONY_JOB_NAME"            # role, e.g. "worker"
ENV_TASK_INDEX = "TONY_TASK_INDEX"
ENV_TASK_NUM = "TONY_TASK_NUM"            # instances of this role
ENV_NUM_TOTAL_TASKS = "TONY_NUM_TOTAL_TASKS"
ENV_IS_CHIEF = "TONY_IS_CHIEF"
ENV_SESSION_ID = "TONY_SESSION_ID"
ENV_DISTRIBUTED_MODE = "TONY_DISTRIBUTED_MODE"
ENV_DRIVER_HOST = "TONY_DRIVER_HOST"
ENV_DRIVER_PORT = "TONY_DRIVER_PORT"
ENV_APP_ID = "TONY_APP_ID"
ENV_JOB_DIR = "TONY_JOB_DIR"              # holds tony-final.json
ENV_TOKEN = "TONY_SECRET_TOKEN"           # HMAC key: the ROOT job secret in
                                          # the client->driver env, the
                                          # derived EXECUTOR-role key in
                                          # driver->executor envs
ENV_TASK_COMMAND = "TONY_TASK_COMMAND"    # user command for this role
ENV_JOB_ARCHIVE = "TONY_JOB_ARCHIVE"      # fetchable job-archive URI
ENV_JOB_ARCHIVE_SHA256 = "TONY_JOB_ARCHIVE_SHA256"  # its expected digest
ENV_LOCALIZE = "TONY_LOCALIZE"            # "true" => always fetch+unpack
ENV_GANG_GENERATION = "TONY_GANG_GENERATION"  # which gang formation this is
ENV_TASK_ATTEMPT = "TONY_TASK_ATTEMPT"    # launch ordinal of this attempt,
                                          # echoed on register_worker so a
                                          # superseded attempt is refused
ENV_DRIVER_GENERATION = "TONY_DRIVER_GENERATION"  # the driver incarnation

# ---- executor -> user-process env
ENV_CLUSTER_SPEC = "CLUSTER_SPEC"         # JSON role -> [host:port]
ENV_TB_PORT = "TB_PORT"
ENV_TASK_PORT = "TONY_TASK_PORT"          # the port this task advertised
# where the training child's StepTimer writes its JSONL step records; the
# executor's TaskMonitor samples the newest one
ENV_STEP_LOG = "TONY_STEP_LOG"
ENV_SERVE_PORT = "TONY_SERVE_PORT"        # serving job type: the HTTP port a
                                          # replica binds (= the task port)
ENV_SERVE_EXTRA_FLAGS = "TONY_SERVE_EXTRA_FLAGS"  # conf-templated serve
                                          # flags (tony.serving.* keys);
                                          # cli/serve.py prepends them
ENV_PRESTAGE_CKPT = "TONY_PRESTAGE_CKPT"  # set on an elastic rejoin: the
                                          # executor reads the newest
                                          # checkpoint under this dir
                                          # ($VARS expanded) before it
                                          # registers (utils/prestage.py)

# ---- the distributed runtime contract (runtimes/torch_runtime.py exports
# it; train/bootstrap.py init() reads it)
ENV_COORDINATOR_ADDRESS = "TONY_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "TONY_PROCESS_ID"
ENV_NUM_PROCESSES = "TONY_NUM_PROCESSES"

# multi-slice contract: which slice this task's host belongs to and how many
# slices the job spans (a "slice" is a node of cards for the port:
# parallel/mesh.py build_hybrid_mesh)
ENV_SLICE_ID = "TONY_SLICE_ID"
ENV_NUM_SLICES = "TONY_NUM_SLICES"

# ---- well-known files in the job dir
DRIVER_INFO_FILE = "driver.json"          # the driver's RPC endpoint
DRIVER_JOURNAL_FILE = "driver.journal.jsonl"  # the control-plane journal

# preemption-drain flag file: `$TONY_STEP_LOG<suffix>`; the StepTimer polls
# for it and the training loop exits EXIT_PREEMPTED at the next step
# boundary
PREEMPT_REQUEST_SUFFIX = ".preempt"
# on-demand profiler capture: the executor writes `$TONY_STEP_LOG<suffix>`
# (JSON {"seconds": N, "out_dir": path}, through a temporary file and a
# rename, so the child never reads a torn request) when the driver relays
# a profile command on a heartbeat's answer; the training child's
# StepTimer polls for it at record cadence, captures a torch.profiler
# trace for N seconds into out_dir and deletes the flag
PROFILE_REQUEST_SUFFIX = ".profile"
# serve's GET /debug/profile writes its captures under
# <trace-dir>/<PROFILE_DIR_NAME>/, a job's under logs/<PROFILE_DIR_NAME>/
PROFILE_DIR_NAME = "profiles"

# ---- fault-injection hooks (production code paths keyed off env vars)
TEST_DRIVER_CRASH = "TONY_TEST_DRIVER_CRASH"                # driver exits mid-run
TEST_EXECUTOR_NUM_HB_MISS = "TONY_TEST_EXECUTOR_NUM_HB_MISS"  # skip N heartbeats
TEST_EXECUTOR_SKEW = "TONY_TEST_EXECUTOR_SKEW"              # "job#idx#ms" straggler
TEST_TASK_EXECUTOR_CRASH = "TONY_TEST_TASK_EXECUTOR_CRASH"  # executor dies pre-register
TEST_WORKER_TERMINATION = "TONY_TEST_WORKER_TERMINATION"    # task ids the driver kills
                                                            # once the chief registers
TEST_COMPLETION_DELAY_MS = "TONY_TEST_COMPLETION_NOTIFICATION_DELAY_MS"
TEST_ALLOCATION_HOLD = "TONY_TEST_ALLOCATION_HOLD"          # "role#idx" never gets
                                                            # capacity (the allocation
                                                            # timeout's deadlock breaker)
# seeded driver chaos, read once by the driver: the chance a monitor tick
# SIGKILLs a running container, one preemption drain once the gang's
# pushed train step reaches N, the chance a heartbeat is dropped, and the
# seed. The driver's SIGKILL of itself at a step is refused (ROADMAP.md
# queue 1, driver recovery: it needs `driver --recover`)
TEST_DRIVER_KILL_RATE = "TONY_TEST_DRIVER_KILL_RATE"
TEST_DRIVER_PREEMPT_AT_STEP = "TONY_TEST_DRIVER_PREEMPT_AT_STEP"
TEST_DRIVER_HEARTBEAT_DROP_RATE = "TONY_TEST_DRIVER_HEARTBEAT_DROP_RATE"
TEST_DRIVER_CHAOS_SEED = "TONY_TEST_DRIVER_CHAOS_SEED"
TEST_DRIVER_SIGKILL_AT_STEP = "TONY_TEST_DRIVER_SIGKILL_AT_STEP"

# serving-side chaos hooks (models/serving.py SlotServer; read once at
# construction, seeded so a chaos run's fault sequence is reproducible):
TEST_SERVING_DISPATCH_FAIL_RATE = "TONY_TEST_SERVING_DISPATCH_FAIL_RATE"
#   probability in [0,1] that a scheduling turn raises like a real
#   dispatch failure (device loss) — exercises the serve loop's
#   reset/restart recovery path
TEST_SERVING_STEP_DELAY_MS = "TONY_TEST_SERVING_STEP_DELAY_MS"
#   added latency per scheduling turn: makes a fast test backend behave
#   like a slow device so overload/shedding paths actually engage
TEST_SERVING_CHAOS_SEED = "TONY_TEST_SERVING_CHAOS_SEED"
TEST_SERVING_CRASH_AT_BLOCKS = "TONY_TEST_SERVING_CRASH_AT_BLOCKS"
#   comma/space-separated decode-block ordinals at which the serving
#   loop raises (each fires once) — a DETERMINISTIC mid-decode crash,
#   the injection point behind the replay checks: in-flight requests
#   must survive via journal replay
TEST_SERVING_SIGKILL_AT_BLOCK = "TONY_TEST_SERVING_SIGKILL_AT_BLOCK"
#   the serving PROCESS SIGKILLs itself at that decode block — the
#   replica-death injection point for journal-recovery e2e tests
#   (0/unset = off)

# ---- exit codes
EXIT_KILLED = 137
# a training child that drained on a preemption notice; the orchestrator
# relaunches it without spending restart budget
EXIT_PREEMPTED = 79
