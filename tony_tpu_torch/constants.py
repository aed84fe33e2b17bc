"""The env contract and exit codes the port's training path reads (its own
copy of the JAX package's constants.py entries, which the port does not
import)."""

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

# preemption-drain flag file: the executor writes `$TONY_STEP_LOG<suffix>`
# when the job is being preempted; the StepTimer polls for it and the
# training loop exits EXIT_PREEMPTED at the next step boundary
PREEMPT_REQUEST_SUFFIX = ".preempt"

# ---- exit codes
# a training child that drained on a preemption notice; the orchestrator
# relaunches it without spending restart budget
EXIT_PREEMPTED = 79
