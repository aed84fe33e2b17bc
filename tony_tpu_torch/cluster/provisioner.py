"""Capacity provisioners: how the driver obtains processes on hosts (the
port's own copy of the JAX package's cluster/provisioner.py).

The reference's equivalent layer is YARN: the AM asks the RM for containers
(TaskScheduler.java:100-102) and launches them through NodeManagers
(ApplicationMaster.ContainerLauncher:1158-1227).

Provisioners implemented:
- LocalProvisioner: subprocesses on this host — the mini-cluster backend used
  by tests and `cli.main local` (reference tony-mini MiniCluster role).
- StaticHostProvisioner: a fixed host list (one GPU node per worker),
  launch via a configurable command template (ssh/agent).

The JAX package's ``tpu-pod`` provisioner (cluster/tpu.py: create, await
and delete TPU slices) has no counterpart yet: ``create_provisioner``
refuses it, naming ROADMAP.md queue 1's GPU-node provisioner item.
"""

from __future__ import annotations

import logging
import os
import shlex
import signal
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from ..conf import RoleSpec, TonyConf, keys

log = logging.getLogger(__name__)


@dataclass
class ContainerHandle:
    """An allocated unit of capacity running one executor."""

    container_id: str
    host: str
    role: str
    index: int
    process: subprocess.Popen | None = None
    extra: dict = field(default_factory=dict)


class Provisioner:
    """SPI. `on_completion(handle, exit_code)` is invoked from a watcher
    thread when a container exits — the analogue of the RM completion
    callback (ApplicationMaster.processFinishedContainer:1238-1274)."""

    def __init__(self) -> None:
        self.on_completion: Callable[[ContainerHandle, int], None] | None = None

    def launch(
        self, spec: RoleSpec, index: int, env: dict[str, str], log_dir: Path
    ) -> ContainerHandle:
        raise NotImplementedError

    def stop_container(self, handle: ContainerHandle) -> None:
        raise NotImplementedError

    def kill_container(self, handle: ContainerHandle) -> None:
        """Hard-kill one container with no drain grace: the driver's chaos
        kill and the tests model abrupt host death (SIGKILL), unlike
        stop_container's SIGTERM-then-escalate. The default falls back to
        the graceful stop for provisioners without a harder hammer."""
        self.stop_container(handle)

    def stop_all(self) -> None:
        raise NotImplementedError


class LocalProvisioner(Provisioner):
    """Executors as local subprocesses; per-task stdout/stderr files mirror
    YARN container log dirs."""

    # how long stop_container waits for the SIGTERM'd executor before
    # escalating to a group SIGKILL
    stop_wait_s = 5.0

    def __init__(self) -> None:
        super().__init__()
        self._handles: dict[str, ContainerHandle] = {}
        self._lock = threading.Lock()
        self._next_id = 0

    def launch(
        self, spec: RoleSpec, index: int, env: dict[str, str], log_dir: Path
    ) -> ContainerHandle:
        with self._lock:
            cid = f"container_{self._next_id:06d}"
            self._next_id += 1
        log_dir.mkdir(parents=True, exist_ok=True)
        stdout_path = log_dir / f"{spec.name}_{index}.stdout"
        stdout = open(stdout_path, "ab")
        stderr = open(log_dir / f"{spec.name}_{index}.stderr", "ab")
        full_env = {**os.environ, **env}
        # -S skips site-packages: the executor agent is pure stdlib and
        # must never import torch (no CUDA context outside the user
        # process); the user process it forks gets a normal interpreter
        proc = subprocess.Popen(
            [sys.executable, "-S", "-m", "tony_tpu_torch.executor"],
            env=full_env,
            stdout=stdout,
            stderr=stderr,
            start_new_session=True,  # own process group => clean kill of user children
        )
        handle = ContainerHandle(
            container_id=cid, host="127.0.0.1", role=spec.name, index=index, process=proc
        )
        # the log location the driver should advertise for this task — owned
        # by the provisioner that opened the file, not re-derived elsewhere
        handle.extra["log_path"] = str(stdout_path)
        with self._lock:
            self._handles[cid] = handle
        threading.Thread(
            target=self._watch, args=(handle, stdout, stderr),
            name=f"watch-{cid}", daemon=True,
        ).start()
        return handle

    def _watch(self, handle: ContainerHandle, *files) -> None:
        code = handle.process.wait()
        for f in files:
            try:
                f.close()
            except Exception:
                pass
        cb = self.on_completion
        if cb is not None:
            try:
                cb(handle, code)
            except Exception:
                log.exception("completion callback failed for %s", handle.container_id)

    @staticmethod
    def _group_pid(handle: ContainerHandle) -> int:
        """The process-group id to signal: the spawned child's pid (0 =
        nothing to signal). It was started with start_new_session, so pid
        == pgid."""
        if handle.process is not None:
            return handle.process.pid if handle.process.poll() is None else 0
        return 0

    def stop_container(self, handle: ContainerHandle) -> None:
        pid = self._group_pid(handle)
        if not pid:
            return
        try:
            os.killpg(pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        try:
            handle.process.wait(timeout=self.stop_wait_s)
            return
        except subprocess.TimeoutExpired:
            pass
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def kill_container(self, handle: ContainerHandle) -> None:
        """SIGKILL the whole process group at once (abrupt host death);
        the watcher thread reports the completion like any crash."""
        pid = self._group_pid(handle)
        if not pid:
            return
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def stop_all(self) -> None:
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            self.stop_container(h)


class StaticHostProvisioner(Provisioner):
    """Fixed host list; each task launched by substituting into a command
    template (default: ssh). Round-robins tasks over hosts, so 4 nodes with
    tony.worker.instances=4 put one executor on each node."""

    def __init__(self, hosts: list[str], launch_template: str | None = None) -> None:
        # _local must exist before super().__init__ touches the
        # on_completion property this class redirects to it
        self._local = LocalProvisioner()
        super().__init__()
        if not hosts:
            raise ValueError("StaticHostProvisioner needs at least one host")
        self.hosts = hosts
        self.launch_template = launch_template or (
            "ssh -o BatchMode=yes {host} {env} " + sys.executable
            + " -S -m tony_tpu_torch.executor"
        )
        self._count = 0
        self._lock = threading.Lock()

    @property
    def on_completion(self):  # delegate watcher callback to inner provisioner
        return self._local.on_completion

    @on_completion.setter
    def on_completion(self, cb):
        self._local.on_completion = cb

    def launch(
        self, spec: RoleSpec, index: int, env: dict[str, str], log_dir: Path
    ) -> ContainerHandle:
        with self._lock:
            host = self.hosts[self._count % len(self.hosts)]
            self._count += 1
        env_str = " ".join(f"{k}={shlex.quote(str(v))}" for k, v in env.items())
        # token replace, not str.format: the template is arbitrary shell
        # where literal braces (${VAR}, awk '{...}') are ordinary syntax
        cmd = self.launch_template.replace("{host}", host).replace("{env}", env_str)
        log_dir.mkdir(parents=True, exist_ok=True)
        stdout_path = log_dir / f"{spec.name}_{index}.stdout"
        stdout = open(stdout_path, "ab")
        stderr = open(log_dir / f"{spec.name}_{index}.stderr", "ab")
        proc = subprocess.Popen(
            cmd, shell=True, stdout=stdout, stderr=stderr, start_new_session=True
        )
        handle = ContainerHandle(
            container_id=f"static_{host}_{spec.name}_{index}",
            host=host, role=spec.name, index=index, process=proc,
        )
        handle.extra["log_path"] = str(stdout_path)
        # register with the inner provisioner so stop_all() reaps the ssh
        # client processes (sshd then tears down the remote session, taking
        # the remote executor with it)
        with self._local._lock:
            self._local._handles[handle.container_id] = handle
        threading.Thread(
            target=self._local._watch, args=(handle, stdout, stderr), daemon=True
        ).start()
        return handle

    def stop_container(self, handle: ContainerHandle) -> None:
        self._local.stop_container(handle)

    def stop_all(self) -> None:
        self._local.stop_all()


def _pid_alive(pid: int) -> bool:
    """Liveness that treats a ZOMBIE as dead (a kill(pid, 0) would call
    an unreaped corpse alive): the JAX package's warmpool.py helper, kept
    as the port's own copy to check that a stopped job left no process
    behind."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            # field 3 is the state letter; the comm field before it may
            # itself contain spaces/parens, so split after the LAST ')'
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def create_provisioner(conf: TonyConf) -> Provisioner:
    """The provisioner ``tony.cluster.provisioner`` names: ``local`` or
    ``static``."""
    kind = str(conf.get(keys.CLUSTER_PROVISIONER, "local")).lower()
    if kind == "local":
        return LocalProvisioner()
    if kind == "static":
        hosts = conf.get_list(keys.CLUSTER_STATIC_HOSTS)
        template = str(conf.get(keys.CLUSTER_LAUNCH_TEMPLATE, "") or "") or None
        return StaticHostProvisioner(hosts, launch_template=template)
    if kind in ("tpu-pod", "tpu"):
        raise NotImplementedError(
            f"{keys.CLUSTER_PROVISIONER}={kind} creates TPU slices; the "
            "port's counterpart, a provisioner of GPU nodes, waits for "
            "ROADMAP.md queue 1's item 'a GPU-node provisioner'")
    raise ValueError(f"unknown provisioner: {kind}")
