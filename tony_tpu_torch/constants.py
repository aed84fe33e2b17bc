"""The env contract and exit codes the port's training path reads, the
serving chaos hooks and serve's profile directory (its own copy of the
JAX package's constants.py entries, which the port does not import)."""

# ---- executor -> user-process env
ENV_JOB_NAME = "TONY_JOB_NAME"            # role, e.g. "worker"
ENV_TASK_INDEX = "TONY_TASK_INDEX"
ENV_IS_CHIEF = "TONY_IS_CHIEF"
ENV_APP_ID = "TONY_APP_ID"
ENV_JOB_DIR = "TONY_JOB_DIR"
ENV_GANG_GENERATION = "TONY_GANG_GENERATION"  # which gang formation this is
# where the training child's StepTimer writes its JSONL step records
ENV_STEP_LOG = "TONY_STEP_LOG"

# ---- the distributed runtime contract (multi-process jobs)
ENV_COORDINATOR_ADDRESS = "TONY_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "TONY_PROCESS_ID"
ENV_NUM_PROCESSES = "TONY_NUM_PROCESSES"

# multi-slice contract: which slice this task's host belongs to and how many
# slices the job spans (a "slice" is a node of cards for the port:
# parallel/mesh.py build_hybrid_mesh)
ENV_SLICE_ID = "TONY_SLICE_ID"
ENV_NUM_SLICES = "TONY_NUM_SLICES"

# preemption-drain flag file: the executor writes `$TONY_STEP_LOG<suffix>`
# when the job is being preempted; the StepTimer polls for it and the
# training loop exits EXIT_PREEMPTED at the next step boundary
PREEMPT_REQUEST_SUFFIX = ".preempt"

# ---- exit codes
# a training child that drained on a preemption notice; the orchestrator
# relaunches it without spending restart budget
EXIT_PREEMPTED = 79

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

# serve's GET /debug/profile writes its captures under
# <trace-dir>/<PROFILE_DIR_NAME>/
PROFILE_DIR_NAME = "profiles"
