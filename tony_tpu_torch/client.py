"""Submission client (the port's own copy of the JAX package's client.py).

Mirrors the reference TonyClient (tony-core/.../TonyClient.java): resolves the
layered config (:666-700), validates caps (:796-866), stages the job dir +
frozen final config (:232-315), launches the driver (submitApplication:317-353
— locally a subprocess), then polls
application state + task infos, firing listeners (monitorApplication:
1039-1107, updateTaskInfoAndReturn:1196-1214), and finally signals the driver
to exit (signalAMToFinish:1109-1119). The programmatic callback API mirrors
client/CallbackHandler.java + client/TaskUpdateListener.java.

The driver starts as ``python -S -m tony_tpu_torch.driver``: without
site-packages, so it cannot import torch and never holds a CUDA context
(the package's control plane is stdlib only). A conf that turns on a
feature the port does not have yet is refused here, before anything is
staged, with the driver's own check (``driver.check_ported``).
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import shutil
import subprocess
import sys
import time
import uuid
from pathlib import Path
from typing import Callable, Protocol

from . import constants as c
from .api import JobStatus, TaskInfo
from .conf import TonyConf, keys
from .rpc import RpcClient

log = logging.getLogger(__name__)


class CallbackHandler(Protocol):
    def on_application_id_received(self, app_id: str) -> None: ...


TaskUpdateListener = Callable[[list[TaskInfo]], None]


def new_app_id() -> str:
    return f"tony_{int(time.time())}_{uuid.uuid4().hex[:8]}"


class TonyClient:
    def __init__(
        self,
        conf: TonyConf,
        callback_handler: CallbackHandler | None = None,
        poll_interval_s: float = 0.2,
    ):
        self.conf = conf
        self.callback_handler = callback_handler
        self.poll_interval_s = poll_interval_s
        self._listeners: list[TaskUpdateListener] = []
        self.app_id: str = ""
        self.job_dir: Path | None = None
        self.token: str = ""
        self.final_state: dict = {}
        self.task_infos: list[TaskInfo] = []
        self._driver_proc: subprocess.Popen | None = None
        self._rpc: RpcClient | None = None

    def add_listener(self, listener: TaskUpdateListener) -> None:
        self._listeners.append(listener)

    # ------------------------------------------------------------ submission
    def submit(self) -> str:
        """Stage and launch the driver; returns the app id."""
        self.conf.validate()
        from .driver import check_ported

        check_ported(self.conf)
        self.app_id = new_app_id()
        if self.callback_handler is not None:
            self.callback_handler.on_application_id_received(self.app_id)

        staging = Path(str(self.conf.get(keys.STAGING_DIR)))
        self.job_dir = staging / self.app_id
        self.job_dir.mkdir(parents=True, exist_ok=True)
        self._stage_resources()
        self.token = (
            secrets.token_hex(16)
            if self.conf.get_bool(keys.SECURITY_TOKEN_ENABLED, True) else ""
        )
        # stamp framework build identity into the frozen config (reference
        # VersionInfo injection, TonyClient.java:195)
        from .utils import version

        version.inject(self.conf)
        self.conf.write_final(self.job_dir)
        self._ship_archive()

        env = {**os.environ, c.ENV_TOKEN: self.token}
        # make this package importable in the driver/executor processes no
        # matter their cwd (the local analogue of shipping the fat jar,
        # ClusterSubmitter.java:49-84)
        pkg_parent = str(Path(__file__).resolve().parent.parent)
        existing = env.get("PYTHONPATH", "")
        if pkg_parent not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_parent + (os.pathsep + existing if existing else "")
            )
        driver_log = open(self.job_dir / "driver.log", "ab")
        self._driver_proc = subprocess.Popen(
            [
                # -S: no site-packages, so no torch: the driver must never
                # hold a card (reference warns the same for AM-with-GPU,
                # TonyClient.java:528-531)
                sys.executable, "-S", "-m", "tony_tpu_torch.driver",
                "--job-dir", str(self.job_dir), "--app-id", self.app_id,
            ],
            env=env,
            stdout=driver_log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        log.info("submitted %s (driver pid %d)", self.app_id, self._driver_proc.pid)
        return self.app_id

    def _stage_resources(self) -> None:
        """Copy src dir / per-role resources into the job dir — the local
        analogue of the HDFS .tony/<appId> staging upload
        (TonyClient.processFinalTonyConf:232-315)."""
        src = str(self.conf.get(keys.SRC_DIR, "") or "")
        if src and Path(src).is_dir():
            dest = self.job_dir / "src"
            if not dest.exists():
                shutil.copytree(src, dest)
            self.conf.set(keys.SRC_DIR, str(dest))
        # per-role resources: path[#alias][::archive] (reference
        # LocalizableResource.java)
        from .utils import localization as loc

        for spec in self.conf.role_specs():
            if not spec.resources:
                continue
            staged = loc.stage_resources(
                loc.parse_resources(spec.resources), self.job_dir
            )
            self.conf.set(
                keys.role_key(spec.name, "resources"), loc.serialize(staged)
            )

    def _ship_archive(self) -> None:
        """Build (and optionally upload) the job archive so executors on
        hosts without the staging FS can fetch the job — the reference's
        HDFS staging upload (TonyClient.java:232-315). Runs when an
        archive URI is configured, localization is forced, or the
        provisioner launches on remote hosts."""
        from .utils import shipping

        template_uri = str(self.conf.get(keys.APPLICATION_ARCHIVE_URI, "") or "")
        # {app} placeholder -> per-application path, so one static config
        # serves many submissions without archives clobbering each other
        uri = template_uri.replace("{app}", self.app_id)
        localize = self.conf.get_bool(keys.TASK_LOCALIZE, False)
        prov = str(self.conf.get(keys.CLUSTER_PROVISIONER, "local")).lower()
        if not uri and not localize and prov == "local":
            return
        archive = shipping.build_job_archive(self.job_dir)
        digest = shipping.sha256_file(archive)
        if not uri:
            # shared/local FS default; real fleets set an uploadable URI
            # (gs://... + upload-cmd) or scp://<client-host>:<archive>
            uri = str(archive)
        upload_cmd = str(
            self.conf.get(keys.APPLICATION_ARCHIVE_UPLOAD_CMD, "") or ""
        )
        if (prov != "local" and not upload_cmd
                and not uri.startswith(("scp://", "gs://", "http://",
                                        "https://"))):
            # a client-local filesystem path frozen as the URI is only
            # fetchable from remote hosts over a shared FS; without one the
            # executors die in localization with a raw FileNotFoundError,
            # so name the misconfiguration here where it is actionable
            log.warning(
                "provisioner %r launches on remote hosts but the job-archive "
                "URI %r is a local filesystem path and no %s is set — "
                "executors will fail localization unless %s is on a shared "
                "filesystem", prov, uri,
                keys.APPLICATION_ARCHIVE_UPLOAD_CMD, uri,
            )
        # freeze the RESOLVED uri + digest for the driver, but restore the
        # template in the in-memory conf — a caller reusing one conf object
        # for several submissions must not inherit this job's resolved path
        # or hash (executors read the archive copy of the conf, where both
        # are irrelevant: the digest cannot live inside the bytes it hashes,
        # so it reaches executors via launch env, not the archive)
        prior_sha = str(self.conf.get(keys.APPLICATION_ARCHIVE_SHA256, "") or "")
        self.conf.set(keys.APPLICATION_ARCHIVE_URI, uri)
        self.conf.set(keys.APPLICATION_ARCHIVE_SHA256, digest)
        try:
            self.conf.write_final(self.job_dir)
        finally:
            self.conf.set(keys.APPLICATION_ARCHIVE_URI, template_uri)
            self.conf.set(keys.APPLICATION_ARCHIVE_SHA256, prior_sha)
        if upload_cmd:
            shipping.upload_archive(archive, uri, upload_cmd)

    # ------------------------------------------------------------ monitoring
    def _connect(self, timeout_s: float = 60.0) -> RpcClient:
        """Poll for the driver's advertised endpoint (plays the reference's
        poll-app-report-for-AM-host-port role, TonyClient.java:1216-1237)."""
        deadline = time.time() + timeout_s
        info_path = self.job_dir / c.DRIVER_INFO_FILE
        while time.time() < deadline:
            if self._driver_proc is not None and self._driver_proc.poll() is not None:
                raise RuntimeError(
                    f"driver exited early with code {self._driver_proc.returncode}; "
                    f"see {self.job_dir / 'driver.log'}"
                )
            if info_path.exists():
                info = json.loads(info_path.read_text())
                from .rpc.protocol import derive_role_key
                # the client signs with its derived client-role key —
                # executors (who hold only the executor key) cannot forge
                # these calls (driver-side ACL on finish_application)
                return RpcClient(
                    info["host"], info["port"],
                    token=derive_role_key(self.token, "client"),
                    role="client" if self.token else "",
                )
            time.sleep(0.05)
        raise TimeoutError("driver did not advertise its endpoint in time")

    def monitor(self) -> JobStatus:
        """Poll until terminal; fire listeners on task-info changes; ack with
        finish_application so the driver can exit."""
        self._rpc = self._connect()
        last_infos_json = ""
        status = JobStatus.RUNNING
        while True:
            try:
                state = self._rpc.call("get_application_state")
                infos = self._rpc.call("get_task_infos")
            except (ConnectionError, OSError):
                if self._driver_proc is not None and self._driver_proc.poll() is not None:
                    # driver died; a non-terminal last-seen state means the
                    # job did not finish — report failure (reference: client
                    # keeps polling RM across AM attempts; with no external
                    # RM, a dead driver IS the terminal signal)
                    log.error("driver process exited (code %s)",
                              self._driver_proc.returncode)
                    last = self.final_state.get("status", "")
                    status = (
                        JobStatus(last)
                        if last in JobStatus.__members__ and JobStatus(last).is_terminal()
                        else JobStatus.FAILED
                    )
                    self.final_state.setdefault(
                        "message", f"driver exited (code {self._driver_proc.returncode})"
                    )
                    return status
                time.sleep(self.poll_interval_s)
                continue
            self.final_state = state
            infos_json = json.dumps(infos, sort_keys=True)
            if infos_json != last_infos_json:
                last_infos_json = infos_json
                self.task_infos = [TaskInfo.from_dict(d) for d in infos]
                for listener in self._listeners:
                    try:
                        listener(self.task_infos)
                    except Exception:
                        log.exception("task update listener failed")
            status = JobStatus(state["status"])
            if status.is_terminal():
                break
            time.sleep(self.poll_interval_s)
        try:
            self._rpc.call("finish_application")
        except Exception:
            pass
        if self._driver_proc is not None:
            try:
                self._driver_proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                log.warning("driver slow to exit; killing")
                self._driver_proc.kill()
        if status != JobStatus.SUCCEEDED:
            log.error("job %s finished %s: %s", self.app_id, status.value,
                      self.final_state.get("message", ""))
        return status

    def run(self) -> int:
        """submit + monitor; returns a shell exit code."""
        self.submit()
        status = self.monitor()
        return 0 if status == JobStatus.SUCCEEDED else 1

    def request_profile(self, task_id: str, seconds: float = 5.0) -> bool:
        """Ask the driver for an on-demand profiler capture of ``task_id``
        (the client-signed ``request_task_profile`` RPC) -> whether it was
        queued: False while the task has no container yet or is over. The
        trace lands under the job's ``logs/profiles/``."""
        rpc = self._connect()
        try:
            return bool(rpc.call("request_task_profile", task_id=task_id,
                                 seconds=float(seconds)))
        finally:
            rpc.close()

    def stop(self) -> None:
        """Force-kill the application (reference forceKillApplication via the
        shutdown hook in ClusterSubmitter.java:49-84): the driver's SIGTERM
        handler stops every container (each executor's process group, its
        user process included) before the driver exits."""
        if self._driver_proc is not None and self._driver_proc.poll() is None:
            import signal as _signal

            try:
                os.killpg(self._driver_proc.pid, _signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
