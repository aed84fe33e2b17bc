"""Containerized task launch: wrap the user command in `docker run`.

The port's own copy of the JAX package's utils/containers.py: the
stand-in for the reference's Docker-on-YARN support, where the
client injects `YARN_CONTAINER_RUNTIME_TYPE=docker`, the image, and mount
list into the container env and the NodeManager does the wrapping
(HadoopCompatibleAdapter.java:45-159; key names from
TonyConfigurationKeys.java:245-290). Here there is no NodeManager, so the
executor builds the `docker run` line itself:

- `--network host` keeps the rendezvous contract identical to a bare process
  (ports advertised to the driver remain reachable);
- `--user <uid>:<gid>` of the executor, so files written under the mounted
  job dir stay owned by the submitting user and an SO_REUSEPORT child rebind
  stays in the executor's reuseport group (Linux requires matching EUID);
  override with a later --user in `tony.docker.extra-args` if the image
  needs root;
- the job dir is bind-mounted at the same path, so TONY_JOB_DIR and the
  localized workdir resolve inside the container;
- the env contract is passed through explicitly with `-e` flags — the
  executor's own environment is host-specific and stays outside;
- `--name` is the task id, so the kill cascade can `docker rm -f` it (the
  docker CLI process does not forward SIGKILL to the container).
"""

from __future__ import annotations

import os
import subprocess
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..conf import TonyConf

from ..conf import keys as K


def container_enabled(conf: "TonyConf | None") -> bool:
    return bool(conf is not None and conf.get_bool(K.DOCKER_ENABLED, False))


def container_name(app_id: str, role: str, index: int) -> str:
    safe = "".join(c if c.isalnum() or c in "_.-" else "-" for c in app_id)
    return f"tony-{safe}-{role}-{index}"


def passthrough_env(conf: "TonyConf", role: str) -> dict[str, str]:
    """Vars the driver injects into the *executor's* environment that must
    follow the task into the container: `tony.execution.env` K=V pairs and
    the role's per-spec env (driver.py _task_env). In non-container mode the
    task inherits these via os.environ."""
    out: dict[str, str] = {}
    for kv in conf.get_list(K.EXECUTION_ENV):
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k] = v
    for spec in conf.role_specs():
        if spec.name == role:
            out.update(spec.env)
    return out


def build_container_command(
    command: str,
    env: dict[str, str],
    conf: "TonyConf",
    work_dir: str | None = None,
    role: str | None = None,
    job_dir: str | None = None,
    name: str | None = None,
) -> list[str]:
    """argv for running `command` inside the configured image.

    Mount entries are `src:dst[:ro]` strings. The job dir (which contains
    the per-task work dir) is bind-mounted so the TONY_JOB_DIR contract —
    frozen config, logs, checkpoints — holds inside; a per-role image
    (`tony.docker.<role>.image`) overrides the global one (reference
    getDockerImageKey, TonyConfigurationKeys.java:246-248).
    """
    image = conf.get(K.DOCKER_IMAGE, "")
    if role:
        image = conf.get(K.docker_image_key(role), image)
    if not image:
        raise ValueError(f"{K.DOCKER_ENABLED} is set but {K.DOCKER_IMAGE} is empty")
    argv = ["docker", "run", "--rm", "--network", "host",
            "--user", f"{os.getuid()}:{os.getgid()}"]
    if name:
        argv += ["--name", name]
    mount_root = job_dir or work_dir
    if mount_root:
        argv += ["-v", f"{mount_root}:{mount_root}"]
    if work_dir:
        argv += ["-w", work_dir]
    for mount in conf.get_list(K.DOCKER_MOUNTS):
        argv += ["-v", mount]
    for kv in sorted(env.items()):
        argv += ["-e", "=".join(kv)]
    argv += conf.get_list(K.DOCKER_RUN_ARGS)
    argv += [image, "bash", "-c", command]
    return argv


def remove_container(name: str) -> None:
    """Force-remove a (possibly already gone) container; the kill-cascade
    complement to --name. Never raises."""
    try:
        subprocess.run(
            ["docker", "rm", "-f", name],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=30, check=False,
        )
    except Exception:
        pass
