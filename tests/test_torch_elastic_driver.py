"""Elastic training through the port's launcher (tony_tpu_torch/driver.py,
executor.py, session.py, utils/prestage.py) against the JAX package's.

The counterparts of tests/test_elastic.py:144-790 run against the port's
driver with the port's own copy of the scripted provisioner (stub
executors on threads speaking the real framed-JSON RPC): a preemption
notice rides the heartbeat answer once and relaunches budget-free; a
self-reported or uncommanded drain is budget-free too; a preempt's exit
racing heartbeat expiry spends at most once; a worker lost past its budget
detaches and the gang re-forms smaller, then rejoins; without capacity the
job finishes smaller; the chief's loss stays fatal; a straggler is
restarted on the budget; the chaos knobs. Beyond them: the same session
sequence and ranks payload through both packages, the JAX ``load_state``
reading the port driver's journal of a scripted resize as it reads the
JAX driver's, the two prestage walks on one directory, and one job of two
tiny ``lm_train --device cpu`` workers through the port's client: a
SIGKILL, the resize, the resume and the rejoin, against a straight run."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import tony_tpu.constants as jc
import tony_tpu.conf as jconf
import tony_tpu.driver as jdriver
from tony_tpu.cluster.provisioner import ContainerHandle as JHandle
from tony_tpu.cluster.provisioner import Provisioner as JProvisioner
from tony_tpu.events.driver_journal import load_state
from tony_tpu.runtimes.jax_runtime import JaxDriverAdapter
from tony_tpu.session import Session as JSession
from tony_tpu.utils.prestage import prestage_checkpoint as jprestage
from tony_tpu_torch import constants as c
from tony_tpu_torch.api import JobStatus
from tony_tpu_torch.cluster.provisioner import ContainerHandle, Provisioner
from tony_tpu_torch.conf import TonyConf
from tony_tpu_torch.driver import Driver, DriverService, check_ported
from tony_tpu_torch.events.trace import TASK_TRACE_FILE, read_traces
from tony_tpu_torch.rpc import RpcClient
from tony_tpu_torch.rpc.protocol import RpcError, derive_role_key
from tony_tpu_torch.runtimes.torch_runtime import TorchDriverAdapter
from tony_tpu_torch.session import Session
from tony_tpu_torch.tools.elastic_cost import parse_child
from tony_tpu_torch.utils.prestage import prestage_checkpoint

REPO = Path(__file__).resolve().parent.parent
SECRET = "elastic-secret"


def _conf(dirs, conf_cls=TonyConf, **extra):
    return conf_cls({
        "tony.staging.dir": dirs["staging"],
        "tony.history.location": dirs["history"],
        "tony.history.intermediate": dirs["history"] + "/intermediate",
        "tony.history.finished": dirs["history"] + "/finished",
        "tony.am.monitor-interval-ms": 50,
        "tony.task.registration-poll-interval-ms": 50,
        **extra,
    })


def _span_names(rec):
    return [n for n, _ in rec["spans"]]


def _scripted(base, handle_cls):
    """The scripted provisioner over a package's ``Provisioner``:
    launch() runs ``script(spec, index, env, handle, attempt)`` on a
    thread (``attempt`` counts launches a task); stop_container() and
    kill_container() set ``handle.extra["stop"]`` so a script can model
    a draining child."""

    class Scripted(base):
        def __init__(self, script):
            super().__init__()
            self._script = script
            self._attempts: dict[str, int] = {}
            self._lock = threading.Lock()
            self.launches: list[str] = []
            self.stops: list[str] = []

        def launch(self, spec, index, env, log_dir):
            task_id = f"{spec.name}:{index}"
            with self._lock:
                attempt = self._attempts.get(task_id, 0)
                self._attempts[task_id] = attempt + 1
                self.launches.append(task_id)
            handle = handle_cls(container_id=f"stub_{task_id}_{attempt}",
                                host="127.0.0.1", role=spec.name,
                                index=index)
            handle.extra["stop"] = threading.Event()
            threading.Thread(target=self._run,
                             args=(spec, index, env, handle, attempt),
                             daemon=True).start()
            return handle

        def _run(self, spec, index, env, handle, attempt):
            try:
                code = self._script(spec, index, env, handle, attempt)
            except Exception as e:              # pragma: no cover
                print(f"stub executor failed: {type(e).__name__}: {e}",
                      flush=True)
                code = 1
            if code is not None and self.on_completion:
                self.on_completion(handle, code)

        def stop_container(self, handle):
            with self._lock:
                self.stops.append(handle.container_id)
            handle.extra["stop"].set()

        def stop_all(self):
            pass

    return Scripted


ScriptedProvisioner = _scripted(Provisioner, ContainerHandle)
JScriptedProvisioner = _scripted(JProvisioner, JHandle)


def _driver(dirs, tmp_path, script, name="elastic_test", jax=False,
            **conf_extra):
    conf = _conf(dirs, jconf.TonyConf if jax else TonyConf, **conf_extra)
    job_dir = tmp_path / f"job_{name}"
    job_dir.mkdir(exist_ok=True)
    conf.write_final(job_dir)
    cls, prov = ((jdriver.Driver, JScriptedProvisioner) if jax
                 else (Driver, ScriptedProvisioner))
    driver = cls(conf, app_id=name, job_dir=str(job_dir), token=SECRET,
                 provisioner=prov(script))
    driver.client_signal.set()      # no client: don't wait for the ack
    return driver


def _rpc_for(env):
    return RpcClient(env[c.ENV_DRIVER_HOST], int(env[c.ENV_DRIVER_PORT]),
                     token=env.get(c.ENV_TOKEN, ""), role="executor")


def _client_rpc(driver):
    return RpcClient("127.0.0.1", driver.rpc_server.port,
                     token=derive_role_key(SECRET, "client"), role="client")


def _trace_records(dirs, app_id):
    inter = Path(dirs["history"]) / "intermediate" / app_id
    return read_traces(inter / TASK_TRACE_FILE)


def _register_and_barrier(rpc, task_id, port):
    payload = rpc.call("register_worker", task_id=task_id,
                       host="127.0.0.1", port=port)
    while payload is None:
        rpc.call("heartbeat", task_id=task_id)
        time.sleep(0.03)
        payload = rpc.call("get_cluster_spec", task_id=task_id)
    return payload


def _preempt_until_accepted(driver, task_id="worker:0"):
    """preempt_task until True: a registration can race the driver's
    launch bookkeeping by a few ms (False = not preemptible yet)."""
    cl = _client_rpc(driver)
    try:
        deadline = time.time() + 5
        ok = cl.call("preempt_task", task_id=task_id)
        while ok is not True and time.time() < deadline:
            time.sleep(0.05)
            ok = cl.call("preempt_task", task_id=task_id)
        return ok
    finally:
        cl.close()


def _beat_until(rpc, task_id, handle, release, seconds=30):
    """Beat until the driver stops the container (-> EXIT_PREEMPTED, a
    drain) or ``release`` is set (-> 0, the result reported)."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        if handle.extra["stop"].is_set():
            rpc.close()
            return c.EXIT_PREEMPTED
        if release.is_set():
            rpc.call("register_execution_result", task_id=task_id,
                     exit_code=0)
            rpc.close()
            return 0
        try:
            rpc.call("heartbeat", task_id=task_id)
        except Exception:
            pass
        time.sleep(0.05)
    rpc.close()
    return 1


# --------------------------------------------------------------------------
# preemption drain: heartbeat command -> drained exit -> budget-free relaunch
# --------------------------------------------------------------------------

def test_preempt_drain_budget_free(tmp_job_dirs, tmp_path):
    """tests/test_elastic.py:144: the client preempts worker:0; the notice
    rides the heartbeat answer exactly once, the drained stub exits
    EXIT_PREEMPTED, and the relaunch spends no budget. The trace carries
    preempting -> preempted and a fresh attempt chain; an executor key
    may not call preempt_task."""
    registered = threading.Event()
    got: dict = {}

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25000 + index)
        if attempt == 0:
            try:
                rpc.call("preempt_task", task_id=task_id)
                got["acl"] = "allowed"
            except RpcError as e:
                got["acl"] = str(e)
            registered.set()
            deadline = time.time() + 20
            while time.time() < deadline:
                res = rpc.call("heartbeat", task_id=task_id)
                if isinstance(res, dict) and res.get("preempt"):
                    got["cmd"] = res["preempt"]
                    break
                time.sleep(0.03)
            got["again"] = rpc.call("heartbeat", task_id=task_id)
            rpc.call("register_execution_result", task_id=task_id,
                     exit_code=c.EXIT_PREEMPTED)
            rpc.close()
            return c.EXIT_PREEMPTED
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    driver = _driver(tmp_job_dirs, tmp_path, script, name="preempt",
                     **{"tony.worker.instances": 1,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 1,
                        "tony.task.heartbeat-interval-ms": 100})
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    try:
        assert registered.wait(20), "worker never registered"
        cl = _client_rpc(driver)
        try:
            assert cl.call("preempt_task", task_id="worker:9") is False
        finally:
            cl.close()
        assert _preempt_until_accepted(driver) is True
    finally:
        registered.set()
    t.join(timeout=30)
    assert not t.is_alive(), "driver did not finish"
    assert driver.session.status == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert "authorization" in got["acl"], got["acl"]
    assert got["cmd"]["grace_ms"] == 3000       # the conf default
    assert got["again"] is True, "the preempt command is one-shot"
    assert driver.provisioner.launches == ["worker:0"] * 2
    text = driver.render_metrics()
    assert "driver_preemptions_total 1" in text
    assert "driver_task_restarts_total 0" in text
    (rec,) = _trace_records(tmp_job_dirs, "preempt")
    names = _span_names(rec)
    assert "preempting" in names and "preempted" in names
    assert names.count("requested") == 2, names
    assert names[-1] == "finished"
    assert rec["attrs"]["restarts"] == 0


def test_self_reported_preemption_and_uncommanded_drain(tmp_job_dirs,
                                                        tmp_path):
    """tests/test_elastic.py:217: worker:0 calls notify_preemption (the
    SIGTERM relay) and dies 137; worker:1 exits EXIT_PREEMPTED (its child
    saw a notice first). Both relaunch budget-free; the job succeeds."""

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25100 + index)
        if attempt == 0:
            if index == 0:
                rpc.call("notify_preemption", task_id=task_id)
                rpc.close()
                return c.EXIT_KILLED
            rpc.close()
            return c.EXIT_PREEMPTED
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    driver = _driver(tmp_job_dirs, tmp_path, script, name="selfpreempt",
                     **{"tony.worker.instances": 2,
                        "tony.worker.command": "stub",
                        "tony.task.heartbeat-interval-ms": 100})
    status = driver.run()
    assert status == JobStatus.SUCCEEDED, driver.session.failure_message
    assert sorted(driver.provisioner.launches) == (
        ["worker:0"] * 2 + ["worker:1"] * 2)
    text = driver.render_metrics()
    assert "driver_preemptions_total 2" in text
    assert "driver_task_restarts_total 0" in text
    for rec in _trace_records(tmp_job_dirs, "selfpreempt"):
        names = _span_names(rec)
        assert "preempted" in names, names
        assert names[-1] == "finished"
        assert rec["attrs"]["restarts"] == 0


def test_preempt_expiry_race_single_spend(tmp_job_dirs, tmp_path,
                                          monkeypatch):
    """tests/test_elastic.py:270: the preempted task goes silent and its
    completion is held 700 ms, so heartbeat expiry fires first. Exactly
    one relaunch, at most one budget unit: the delayed completion reads
    as superseded."""
    preempt_seen = threading.Event()
    registered = threading.Event()

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25200 + index)
        if attempt == 0:
            registered.set()
            deadline = time.time() + 20
            while time.time() < deadline:
                res = rpc.call("heartbeat", task_id=task_id)
                if isinstance(res, dict) and res.get("preempt"):
                    preempt_seen.set()
                    break
                time.sleep(0.03)
            rpc.close()
            return c.EXIT_PREEMPTED
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    monkeypatch.setenv(c.TEST_COMPLETION_DELAY_MS, "700")
    driver = _driver(tmp_job_dirs, tmp_path, script, name="preemptrace",
                     **{"tony.worker.instances": 1,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 2,
                        "tony.task.heartbeat-interval-ms": 100,
                        "tony.task.max-missed-heartbeats": 3})
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    try:
        assert registered.wait(20)
        assert _preempt_until_accepted(driver) is True
        assert preempt_seen.wait(20), "notice never delivered"
    finally:
        registered.set()
    t.join(timeout=30)
    assert not t.is_alive(), "driver did not finish"
    assert driver.session.status == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert driver.provisioner.launches == ["worker:0"] * 2
    (rec,) = _trace_records(tmp_job_dirs, "preemptrace")
    assert rec["attrs"]["restarts"] <= 1
    names = _span_names(rec)
    assert names[-1] == "finished"
    assert names.count("requested") == 2, names


# --------------------------------------------------------------------------
# elastic gang resize: down on loss past budget, up when capacity returns
# --------------------------------------------------------------------------

def _resize_script(payloads, release, port0):
    """worker:1 crashes on its first attempt once worker:0 cleared the
    barrier (budget 0 -> a resize, not a failure); everyone else beats
    until drained (EXIT_PREEMPTED) or released (0)."""

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        payloads[(index, attempt)] = _register_and_barrier(
            rpc, task_id, port0 + index)
        if index == 1 and attempt == 0:
            deadline = time.time() + 10
            while (0, 0) not in payloads and time.time() < deadline:
                time.sleep(0.02)
            rpc.close()
            return 1
        return _beat_until(rpc, task_id, handle, release)

    return script


RESIZE_CONF = {"tony.worker.instances": 2, "tony.worker.command": "stub",
               "tony.worker.max-restarts": 0,
               "tony.train.elastic-enabled": True,
               "tony.train.elastic-min-instances": 1,
               "tony.train.rescale-retry-ms": 500,
               "tony.train.checkpoint-dir": "/ckpt/w$TONY_TASK_INDEX",
               "tony.task.heartbeat-interval-ms": 100}


def _run_resize(dirs, tmp_path, name, port0, jax=False):
    """The down-then-up script on one package's driver -> (driver, the
    barrier payloads by (index, attempt), the launch envs)."""
    release = threading.Event()
    payloads: dict = {}
    envs: dict = {}
    script = _resize_script(payloads, release, port0)

    def recording(spec, index, env, handle, attempt):
        envs[(index, attempt)] = dict(env)
        return script(spec, index, env, handle, attempt)

    driver = _driver(dirs, tmp_path, recording, name=name, jax=jax,
                     **RESIZE_CONF)
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    try:
        deadline = time.time() + 25
        while time.time() < deadline:
            if (1, 1) in payloads and (0, 2) in payloads:
                break
            time.sleep(0.05)
        assert (0, 1) in payloads, f"no resize-down relaunch: {payloads}"
        assert (1, 1) in payloads and (0, 2) in payloads, (
            f"the rescale up never completed: {sorted(payloads)}")
    finally:
        release.set()
    t.join(timeout=30)
    assert not t.is_alive(), "driver did not finish"
    return driver, payloads, envs


def test_resize_down_then_up(tmp_job_dirs, tmp_path):
    """tests/test_elastic.py:348: worker:1 crashes with no budget: the
    driver detaches it, drains worker:0 and re-forms the gang at world 1
    (generation 1); the rescale timer brings the slot back (generation 2,
    world 2, its executor told to prestage the checkpoint directory) and
    the job finishes: two resizes, no budget spent."""
    driver, payloads, envs = _run_resize(tmp_job_dirs, tmp_path, "resize",
                                         25300)
    assert driver.session.status == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert len(payloads[(0, 0)]["cluster"]["worker"]) == 2
    assert payloads[(0, 0)]["gang_generation"] == 0
    assert len(payloads[(0, 1)]["cluster"]["worker"]) == 1
    assert payloads[(0, 1)]["gang_generation"] == 1
    assert payloads[(0, 1)]["num_processes"] == 1
    assert len(payloads[(0, 2)]["cluster"]["worker"]) == 2
    assert payloads[(0, 2)]["gang_generation"] == 2
    assert payloads[(1, 1)]["gang_generation"] == 2
    assert envs[(1, 1)][c.ENV_PRESTAGE_CKPT] == "/ckpt/w$TONY_TASK_INDEX"
    assert envs[(1, 1)][c.ENV_GANG_GENERATION] == "2"
    assert c.ENV_PRESTAGE_CKPT not in envs[(0, 1)]
    text = driver.render_metrics()
    assert "driver_gang_resizes_total 2" in text
    assert "driver_task_restarts_total 0" in text
    assert 'driver_tasks{state="detached"} 0' in text
    recs = {r["id"]: r for r in _trace_records(tmp_job_dirs, "resize")}
    assert set(recs) == {"worker:0", "worker:1"}
    for rec in recs.values():
        names = _span_names(rec)
        assert "resized" in names, names
        assert names[-1] == "finished"
        assert rec["attrs"]["restarts"] == 0
    assert _span_names(recs["worker:0"]).count("requested") == 3


def _elastic_records(job_dir):
    """The journal's elastic records in order, without their times."""
    recs = [json.loads(ln) for ln in
            (Path(job_dir) / c.DRIVER_JOURNAL_FILE).read_text().splitlines()]
    return [r for r in recs if r["op"] in ("detach", "reattach",
                                           "generation", "ledger")]


def _formation(state):
    return dict(gang_generation=state.gang_generation,
                detached=sorted(state.detached),
                preempts=sorted(state.preempts),
                preempt_cmds=sorted(state.preempt_cmds),
                resizes=sorted(state.resizes),
                restarts={t: r.restarts for t, r in state.tasks.items()},
                attempts={t: r.attempt for t, r in state.tasks.items()},
                status={t: r.status for t, r in state.tasks.items()})


def test_journal_of_a_resize_reads_as_the_jax_drivers(tmp_job_dirs,
                                                      tmp_path):
    """The JAX package's load_state replays the port driver's journal of
    the down-then-up script into the formation the JAX driver's journal
    of the same script gives: the generation, the detached set, the
    preempt and resize ledgers, the budgets, the attempts and the
    terminal states; the elastic records (detach, reattach, generation,
    ledger) are the same, in the same order."""
    port, _, _ = _run_resize(tmp_job_dirs, tmp_path, "jr_port", 25320)
    jax, _, _ = _run_resize(tmp_job_dirs, tmp_path, "jr_jax", 25340,
                            jax=True)
    assert port.session.status == JobStatus.SUCCEEDED
    assert jax.session.status.value == "SUCCEEDED"
    got = _formation(load_state(port.job_dir / c.DRIVER_JOURNAL_FILE))
    want = _formation(load_state(jax.job_dir / c.DRIVER_JOURNAL_FILE))
    assert got == want
    assert got["gang_generation"] == 2 and got["detached"] == []
    assert _elastic_records(port.job_dir) == _elastic_records(jax.job_dir)
    assert [r["op"] for r in _elastic_records(port.job_dir)] == [
        "detach", "generation", "ledger", "reattach", "generation",
        "ledger"]


def test_resize_down_stays_down_without_capacity(tmp_job_dirs, tmp_path):
    """tests/test_elastic.py:437: with a rescale timer that never fires in
    the test, the job finishes at the smaller world size: the detached
    task is not tracked, the survivor's success ends the job, and the
    detached trace seals 'killed' at stop. The journal replays to
    generation 1 with worker:1 detached."""
    barrier_cleared = threading.Event()

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        payload = _register_and_barrier(rpc, task_id, 25400 + index)
        if index == 0 and attempt == 0:
            barrier_cleared.set()
        if index == 1:
            barrier_cleared.wait(10)
            rpc.close()
            return 1
        if attempt == 0:
            return _beat_until(rpc, task_id, handle, threading.Event(), 20)
        assert len(payload["cluster"]["worker"]) == 1
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    driver = _driver(tmp_job_dirs, tmp_path, script, name="resizedown",
                     **{"tony.worker.instances": 2,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 0,
                        "tony.train.elastic-enabled": True,
                        "tony.train.rescale-retry-ms": 600000,
                        "tony.task.heartbeat-interval-ms": 100})
    status = driver.run()
    assert status == JobStatus.SUCCEEDED, driver.session.failure_message
    assert driver.provisioner.launches.count("worker:1") == 1
    recs = {r["id"]: r for r in _trace_records(tmp_job_dirs, "resizedown")}
    assert _span_names(recs["worker:0"])[-1] == "finished"
    assert "resized" in _span_names(recs["worker:1"])
    assert _span_names(recs["worker:1"])[-1] == "killed"
    assert "driver_gang_resizes_total 1" in driver.render_metrics()
    state = load_state(driver.job_dir / c.DRIVER_JOURNAL_FILE)
    assert state.gang_generation == 1 and state.detached == {"worker:1"}


def test_chief_loss_is_still_fatal(tmp_job_dirs, tmp_path):
    """tests/test_elastic.py:484: worker:0 (the chief) crashing past its
    budget fails the job, elastic or not."""
    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25500 + index)
        if index == 0:
            rpc.close()
            return 1
        return _beat_until(rpc, task_id, handle, threading.Event(), 20)

    driver = _driver(tmp_job_dirs, tmp_path, script, name="chiefloss",
                     **{"tony.worker.instances": 2,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 0,
                        "tony.train.elastic-enabled": True,
                        "tony.application.fail-on-worker-failure-enabled":
                            True,
                        "tony.task.heartbeat-interval-ms": 100})
    assert driver.run() == JobStatus.FAILED
    assert "worker:0" in driver.session.failure_message
    assert "driver_gang_resizes_total 0" in driver.render_metrics()


# --------------------------------------------------------------------------
# stragglers and chaos
# --------------------------------------------------------------------------

def test_straggler_restart_budget_charged(tmp_job_dirs, tmp_path):
    """tests/test_elastic.py:520: three workers push step-time p50s;
    worker:2 reports 10x the median and is restarted on the normal budget
    with a 'straggler' cause; its fast replacement finishes."""
    release = threading.Event()

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25600 + index)
        p50 = 1.0 if (index == 2 and attempt == 0) else 0.1
        rpc.call("update_metrics", task_id=task_id,
                 metrics=[{"name": "max_step_time_p50_s", "value": p50}])
        code = _beat_until(rpc, task_id, handle, release)
        return c.EXIT_KILLED if code == c.EXIT_PREEMPTED else code

    driver = _driver(tmp_job_dirs, tmp_path, script, name="straggler",
                     **{"tony.worker.instances": 3,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 1,
                        "tony.train.straggler-restart-factor": 3,
                        "tony.train.straggler-grace-checks": 1,
                        "tony.task.heartbeat-interval-ms": 100})
    t = threading.Thread(target=driver.run, daemon=True)
    t.start()
    try:
        deadline = time.time() + 20
        while (time.time() < deadline
               and driver.provisioner.launches.count("worker:2") < 2):
            time.sleep(0.05)
        assert driver.provisioner.launches.count("worker:2") == 2, (
            "the straggler was never restarted")
    finally:
        release.set()
    t.join(timeout=30)
    assert not t.is_alive(), "driver did not finish"
    assert driver.session.status == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert driver.provisioner.launches.count("worker:0") == 1
    assert driver.provisioner.launches.count("worker:1") == 1
    assert "driver_task_restarts_total 1" in driver.render_metrics()
    recs = {r["id"]: r for r in _trace_records(tmp_job_dirs, "straggler")}
    names = _span_names(recs["worker:2"])
    assert names.count("restarted") == 1
    assert "straggler" in recs["worker:2"]["attrs"]["last_cause"]
    assert names[-1] == "finished"


def test_chaos_heartbeat_drop_knob(tmp_job_dirs, tmp_path, monkeypatch):
    """tests/test_elastic.py:583: at drop rate 1.0 every heartbeat RPC
    errors and records nothing; the knob is read once at construction."""
    monkeypatch.setenv(c.TEST_DRIVER_HEARTBEAT_DROP_RATE, "1.0")
    driver = _driver(tmp_job_dirs, tmp_path, lambda *a: 0, name="hbdrop",
                     **{"tony.worker.instances": 1,
                        "tony.worker.command": "stub"})
    monkeypatch.delenv(c.TEST_DRIVER_HEARTBEAT_DROP_RATE)
    svc = DriverService(driver)
    with pytest.raises(RuntimeError, match="chaos"):
        svc.heartbeat("worker:0")
    assert "worker:0" not in driver.heartbeats, "a dropped beat records"
    driver.rpc_server.stop()


def test_chaos_preempt_at_step(tmp_job_dirs, tmp_path, monkeypatch):
    """tests/test_elastic.py:601: once the gang's pushed train_step
    reaches TONY_TEST_DRIVER_PREEMPT_AT_STEP, exactly one seeded drain
    fires; the drained stub relaunches budget-free and finishes."""
    monkeypatch.setenv(c.TEST_DRIVER_PREEMPT_AT_STEP, "5")
    monkeypatch.setenv(c.TEST_DRIVER_CHAOS_SEED, "7")

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25700 + index)
        if attempt == 0:
            rpc.call("update_metrics", task_id=task_id,
                     metrics=[{"name": "max_train_step", "value": 9}])
            deadline = time.time() + 20
            while time.time() < deadline:
                res = rpc.call("heartbeat", task_id=task_id)
                if isinstance(res, dict) and res.get("preempt"):
                    rpc.close()
                    return c.EXIT_PREEMPTED
                time.sleep(0.03)
            rpc.close()
            return 1
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    driver = _driver(tmp_job_dirs, tmp_path, script, name="chaospreempt",
                     **{"tony.worker.instances": 1,
                        "tony.worker.command": "stub",
                        "tony.task.heartbeat-interval-ms": 100})
    assert driver.run() == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert driver.provisioner.launches == ["worker:0"] * 2
    assert driver._chaos_preempt_fired is True
    text = driver.render_metrics()
    assert "driver_preemptions_total 1" in text
    assert "driver_task_restarts_total 0" in text


def test_chaos_kill_rate_sigkills_through_the_provisioner(tmp_job_dirs,
                                                          tmp_path,
                                                          monkeypatch):
    """TONY_TEST_DRIVER_KILL_RATE=1: the first monitor tick after the
    worker runs kills its container with ``kill_container`` (the scripted
    one records it as a stop); the crash spends the restart budget and
    the relaunch finishes the job."""
    monkeypatch.setenv(c.TEST_DRIVER_KILL_RATE, "1.0")
    killed = []

    def script(spec, index, env, handle, attempt):
        rpc = _rpc_for(env)
        task_id = f"{spec.name}:{index}"
        _register_and_barrier(rpc, task_id, 25800 + index)
        if attempt == 0:
            code = _beat_until(rpc, task_id, handle, threading.Event(), 20)
            killed.append(code == c.EXIT_PREEMPTED)
            return -signal.SIGKILL
        rpc.call("register_execution_result", task_id=task_id, exit_code=0)
        rpc.close()
        return 0

    driver = _driver(tmp_job_dirs, tmp_path, script, name="chaoskill",
                     **{"tony.worker.instances": 1,
                        "tony.worker.command": "stub",
                        "tony.worker.max-restarts": 1,
                        "tony.task.heartbeat-interval-ms": 100})
    monkeypatch.delenv(c.TEST_DRIVER_KILL_RATE)
    real = driver._chaos_tick

    def once():     # one kill: the relaunch must be left alone
        real()
        if driver.provisioner.stops:
            driver._chaos_kill_rate = 0.0

    driver._chaos_tick = once
    assert driver.run() == JobStatus.SUCCEEDED, (
        driver.session.failure_message)
    assert killed == [True]
    assert driver.provisioner.launches == ["worker:0"] * 2
    assert "driver_task_restarts_total 1" in driver.render_metrics()


def test_local_provisioner_kill_container_sigkills_the_group():
    """LocalProvisioner.kill_container: the container's whole process
    group (an executor and the child it forked) dies by SIGKILL at once,
    with no SIGTERM for a relay to drain on; a finished container is left
    alone."""
    from tony_tpu_torch.cluster.provisioner import LocalProvisioner

    proc = subprocess.Popen(
        ["bash", "-c", "trap '' TERM; sleep 60 & wait"],
        start_new_session=True)
    time.sleep(0.2)
    (grandchild,) = [int(p) for p in Path(
        f"/proc/{proc.pid}/task/{proc.pid}/children").read_text().split()]
    handle = ContainerHandle(container_id="c", host="127.0.0.1",
                             role="worker", index=0, process=proc)
    LocalProvisioner().kill_container(handle)
    assert proc.wait(timeout=10) == -signal.SIGKILL
    deadline = time.time() + 10
    while Path(f"/proc/{grandchild}").exists() and time.time() < deadline:
        time.sleep(0.02)
    assert not Path(f"/proc/{grandchild}").exists()
    LocalProvisioner().kill_container(handle)       # gone: a no-op


# --------------------------------------------------------------------------
# executor and child: the flag file, the StepTimer poll, the relay
# --------------------------------------------------------------------------

def test_write_preempt_flag_and_steptimer_poll(tmp_path):
    """tests/test_elastic.py:645: the executor's drain relay meets the
    training child's poll: the renamed flag makes preempt_requested stick
    and is consumed; the JAX executor writes the same flag."""
    from tony_tpu.executor import write_preempt_flag as jwrite
    from tony_tpu_torch.executor import write_preempt_flag
    from tony_tpu_torch.train.profiling import StepTimer

    assert write_preempt_flag(None, {"grace_ms": 10}) is None
    step_log = tmp_path / "w0.steps.jsonl"
    timer = StepTimer(step_log, window=2)
    timer.tick()
    assert timer.preempt_requested is False
    flag = write_preempt_flag(str(step_log), {"grace_ms": 1500})
    assert flag == str(step_log) + c.PREEMPT_REQUEST_SUFFIX
    req = json.loads(Path(flag).read_text())
    jflag = jwrite(str(tmp_path / "j.steps.jsonl"), {"grace_ms": 1500})
    assert sorted(req) == sorted(json.loads(Path(jflag).read_text()))
    assert req["grace_ms"] == 1500.0
    time.sleep(0.3)     # the poll is time-gated at ~0.25 s
    timer.tick()
    assert timer.preempt_requested is True
    assert not Path(flag).exists(), "the notice is consumed"


def test_heartbeater_relays_preempt_command():
    """tests/test_elastic.py:668: a dict heartbeat answer carrying
    'preempt' reaches on_preempt exactly once, beside a 'profile' that
    reaches on_command."""
    from tony_tpu_torch.executor import Heartbeater

    class _Client:
        def __init__(self):
            self.beats = 0

        def call(self, method, **params):
            self.beats += 1
            if self.beats == 1:
                return {"preempt": {"grace_ms": 700}}
            if self.beats == 2:
                return {"profile": {"seconds": 1.0}}
            return True

    pre, prof = [], []
    client = _Client()
    hb = Heartbeater(client, "worker:0", interval_s=0.01,
                     on_command=prof.append, on_preempt=pre.append)
    hb.start()
    deadline = time.time() + 5
    while client.beats < 4 and time.time() < deadline:
        time.sleep(0.01)
    hb.stop_event.set()
    hb.join(timeout=5)
    assert pre == [{"grace_ms": 700}]
    assert prof == [{"seconds": 1.0}]


def test_executor_drain_watchdog_and_notice(tmp_path, monkeypatch):
    """_on_preempt_notice drops the flag, arms one watchdog an attempt
    (a repeated notice stacks no timer) that terminates a child which
    never drains, and with notify_driver reports notify_preemption on a
    client of its own; a flag no child read is removed before the next
    attempt registers."""
    from tony_tpu_torch import executor as E
    from tony_tpu_torch.rpc import RpcServer

    seen = []

    class Svc:
        def notify_preemption(self, task_id):
            seen.append(task_id)
            return True

    server = RpcServer(host="127.0.0.1", port=0)
    server.register_service(Svc())
    server.start()
    try:
        ex = E.Executor.__new__(E.Executor)
        ex._drain_armed = False
        ex.job_dir = str(tmp_path)
        ex.job_name, ex.task_index, ex.task_id = "worker", 0, "worker:0"
        ex.driver_host, ex.driver_port = "127.0.0.1", server.port
        (tmp_path / "logs").mkdir()
        child = subprocess.Popen(["sleep", "30"])

        class Ctx:
            child_process = child

        holder = {"ctx": Ctx()}
        monkeypatch.delenv(c.ENV_TOKEN, raising=False)
        ex._on_preempt_notice(holder, {"grace_ms": 200}, notify_driver=True)
        ex._on_preempt_notice(holder, {"grace_ms": 200})
        assert Path(ex._step_log_path() + c.PREEMPT_REQUEST_SUFFIX).exists()
        assert child.wait(timeout=10) == -signal.SIGTERM
        deadline = time.time() + 10
        while not seen and time.time() < deadline:
            time.sleep(0.02)
        assert seen == ["worker:0"]
        # the child never polled: the next attempt's executor removes the
        # notice before it registers, or it would drain that attempt
        flag = Path(ex._step_log_path() + c.PREEMPT_REQUEST_SUFFIX)
        assert flag.exists()
        ex._clear_stale_preempt_flag()
        assert not flag.exists()
        ex._clear_stale_preempt_flag()      # none left: a no-op
    finally:
        server.stop()


# --------------------------------------------------------------------------
# the session, the ranks payload, the prestage walk: both packages
# --------------------------------------------------------------------------

def _session_sequence(session_cls, conf_cls):
    """The reference's detach sequence (tests/test_elastic.py:756) ->
    every answer along it."""
    s = session_cls(conf_cls({"tony.worker.instances": 2,
                              "tony.worker.command": "stub"}))
    out = [s.register_task("worker:0", "h", 1) is not None,
           s.register_task("worker:1", "h", 2) is not None,
           s.all_registered(), s.detach_task("worker:1"),
           s.all_registered(), s.cluster_spec(),
           [t.task_id for t in s.tracked_tasks()],
           [t.task_id for t in s.active_tasks()],
           s.register_task("worker:1", "h", 3) is None,
           s.begin_generation(), s.all_registered(),
           s.reattach_task("worker:1"), s.reattach_task("worker:1"),
           s.register_task("worker:1", "h", 4) is not None,
           s.all_registered(),
           s.register_task("worker:0", "h", 1) is not None,
           s.all_registered(), s.cluster_spec(), s.gang_generation,
           sorted(s.detached), s.detach_task("worker:7")]
    s.detach_task("worker:1")
    s.on_task_completed("worker", 1, 1)    # a detached slot's late exit
    out += [s.status.value, s.update_status().value,
            [t.task_id for t in s.tracked_tasks()]]
    return out


def test_session_detach_semantics_match_jax():
    """The session's resize contract, the same sequence through both
    packages' Session: a detached slot leaves the barrier predicate, the
    cluster spec, registration and the tracked set; a generation bump
    forces every task to register again; a detached slot's failure fails
    nothing."""
    got = _session_sequence(Session, TonyConf)
    assert got == _session_sequence(JSession, jconf.TonyConf)
    assert got[4] is True and got[5] == {"worker": ["h:1"]}
    assert got[9] == 1 and got[10] is False and got[14] is False
    assert got[16] is True


def test_ranks_follow_real_task_identity_after_resize_match_jax():
    """tests/test_elastic.py:732 for the torch runtime: worker:1 of 3 is
    detached, the survivors register into generation 1, and the compacted
    cluster spec ranks worker:2 as 1, with the world, the coordinator and
    the generation of the current formation; the JAX adapter gives the
    same payload for the same sequence."""
    payloads = []
    for session_cls, conf_cls, adapter_cls in (
            (Session, TonyConf, TorchDriverAdapter),
            (JSession, jconf.TonyConf, JaxDriverAdapter)):
        s = session_cls(conf_cls({"tony.worker.instances": 3,
                                  "tony.worker.command": "stub"}))
        for i in range(3):
            assert s.register_task(f"worker:{i}", "h", 100 + i) is not None
        adapter = adapter_cls()
        adapter.set_session(s)
        full = adapter.cluster_spec_payload("worker:0")
        assert full["ranks"] == {"worker:0": 0, "worker:1": 1,
                                 "worker:2": 2}
        s.detach_task("worker:1")
        s.begin_generation()
        assert s.register_task("worker:0", "h", 100) is not None
        assert s.register_task("worker:2", "h", 102) is not None
        payloads.append(adapter.cluster_spec_payload("worker:2"))
    got, want = payloads
    assert got["ranks"] == {"worker:0": 0, "worker:2": 1}, got
    assert got["num_processes"] == 2
    assert got["coordinator_address"] == "h:100"
    assert got["cluster"]["worker"] == ["h:100", "h:102"]
    assert got["gang_generation"] == 1
    assert {k: got[k] for k in ("ranks", "num_processes",
                                "coordinator_address", "cluster",
                                "gang_generation")} == \
        {k: want[k] for k in ("ranks", "num_processes",
                              "coordinator_address", "cluster",
                              "gang_generation")}


def test_prestage_matches_jax_and_skips_inflight_saves(tmp_path):
    """Both packages' prestage walks read the same newest step of one
    directory in the port's layout (<step>/state.pt), and skip an
    in-flight <step>.tmp-<pid> save even when it is the newest."""
    import torch

    from tony_tpu_torch.train.checkpoint import CheckpointManager

    root = tmp_path / "ckpt"
    assert prestage_checkpoint(str(root)) is None      # no directory yet
    mgr = CheckpointManager(str(root), save_interval=4)
    for step in (4, 8):
        mgr.save(step, {"w": torch.arange(1000.0) * step})
    mgr.close()
    inflight = root / f"12.tmp-{os.getpid()}"
    inflight.mkdir()
    (inflight / "state.pt").write_bytes(b"\0" * 4096)
    want_bytes = (root / "8" / "state.pt").stat().st_size
    got = prestage_checkpoint(str(root))
    assert got == {"step": 8, "files": 1, "bytes": want_bytes}
    assert jprestage(str(root)) == got
    (root / "notes").mkdir()        # a non-step directory is ignored too
    assert prestage_checkpoint(str(root)) == got


# --------------------------------------------------------------------------
# what check_ported still refuses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key,value", [
    ("tony.train.elastic-enabled", True),
    ("tony.train.straggler-restart-factor", 2.5),
    ("tony.train.checkpoint-dir", "/ckpt"),
])
def test_elastic_conf_keys_are_ported(key, value):
    check_ported(TonyConf({"tony.worker.instances": 1, key: value}),
                 environ={})


def test_chaos_env_ported_but_driver_sigkill_waits_for_recovery():
    conf = TonyConf({"tony.worker.instances": 1})
    check_ported(conf, environ={c.TEST_DRIVER_KILL_RATE: "0.1",
                               c.TEST_DRIVER_PREEMPT_AT_STEP: "6",
                               c.TEST_DRIVER_HEARTBEAT_DROP_RATE: "0.2",
                               c.TEST_DRIVER_CHAOS_SEED: "3"})
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1: driver recovery"):
        check_ported(conf, environ={c.TEST_DRIVER_SIGKILL_AT_STEP: "5"})
    assert jc.TEST_DRIVER_SIGKILL_AT_STEP == c.TEST_DRIVER_SIGKILL_AT_STEP


# --------------------------------------------------------------------------
# one job through the port's launcher: SIGKILL -> resize -> resume -> rejoin
# --------------------------------------------------------------------------

E2E_STEPS = 16
E2E_EVERY = 4
TINY_TRAIN = ["--batch-size", "2", "--seq-len", "16", "--d-model", "32",
              "--n-layers", "1", "--n-heads", "2", "--d-ff", "64",
              "--vocab", "64", "--dtype", "float32", "--device", "cpu",
              "--step-log-every", "1"]


def _steps_and_losses(stdout: str) -> list:
    """The child wrapper's [step, loss, unix time] lines, in order."""
    return [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
            if ln.startswith("elastic_step ")]


def _continuity(steps: list[int]) -> int:
    """tests/test_elastic.py:795: recomputed steps over a multi-attempt
    sequence; never a silent skip."""
    recomputed = 0
    for prev, cur in zip(steps, steps[1:]):
        if cur <= prev:
            recomputed += prev - cur + 1
        else:
            assert cur == prev + 1, f"silent step skip: {prev} -> {cur}"
    return recomputed


def test_e2e_sigkill_resize_resume_rejoin(tmp_job_dirs, tmp_path):
    """Two tiny lm_train workers through the port's client, each with its
    own checkpoint directory: worker:1's child is SIGKILLed at step 6
    (budget 0): worker:1 detaches, worker:0 drains on the SIGTERM relay
    and re-forms at generation 1; after the retry worker:1 rejoins
    (generation 2, prestaged) and worker:0 drains again; the job
    SUCCEEDS. From the kill until the rejoin is launched worker:0 waits at
    its step boundary (the wrapper's hold file), so that it cannot finish
    before the rejoin on a slow host. No log skips a step, and every
    recomputed step's loss is the first attempt's, as in a straight run
    of the same steps (run beside the job, one thread each)."""
    from tony_tpu_torch.client import TonyClient

    ckpt = tmp_path / "ckpt"
    one_thread = "OMP_NUM_THREADS=1"
    # the straight run: the longest attempt resumes at most 3 * E2E_EVERY
    # steps in and trains E2E_STEPS
    top = E2E_STEPS + 3 * E2E_EVERY
    straight = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.tools.elastic_cost",
         "--child", "--", *TINY_TRAIN, "--steps", str(top)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    hold = tmp_path / "hold_0"
    child = (f"{sys.executable} -m tony_tpu_torch.tools.elastic_cost "
             f"--child --step-delay-ms 150 --hold-file {tmp_path}/hold_"
             "$TONY_TASK_INDEX -- "
             + " ".join(TINY_TRAIN)
             + f" --steps {E2E_STEPS} --checkpoint-every {E2E_EVERY}"
             " --checkpoint-dir " + str(ckpt) + "/w$TONY_TASK_INDEX")
    conf = _conf(tmp_job_dirs, **{
        "tony.worker.instances": 2,
        "tony.worker.command": child,
        "tony.application.framework": "generic",
        "tony.worker.max-restarts": 0,
        "tony.train.elastic-enabled": True,
        "tony.train.elastic-min-instances": 1,
        # long enough for worker:0's generation-1 attempt to be running
        # (and held) when the rejoin drains it, on a loaded host too
        "tony.train.rescale-retry-ms": 8000,
        "tony.train.checkpoint-dir": str(ckpt) + "/w$TONY_TASK_INDEX",
        "tony.task.preempt-grace-ms": 4000,
        "tony.task.heartbeat-interval-ms": 250,
        "tony.task.metrics-interval-ms": 500,
        "tony.application.timeout-ms": 150000,
        "tony.execution.env": f"PYTHONPATH={REPO} JAX_PLATFORMS=cpu "
                              f"PYTHONUNBUFFERED=1 {one_thread}",
    })
    client = TonyClient(conf, poll_interval_s=0.2)
    client.submit()
    logs = Path(client.job_dir) / "logs"
    journal = Path(client.job_dir) / c.DRIVER_JOURNAL_FILE
    killed = False
    done = threading.Event()
    result: dict = {}

    def monitor():
        result["status"] = client.monitor()
        done.set()

    threading.Thread(target=monitor, daemon=True).start()
    held = False
    deadline = time.time() + 120
    try:
        while not done.is_set() and time.time() < deadline:
            out = (logs / "worker_1.stdout")
            if not killed and out.exists():
                seen = _steps_and_losses(out.read_text())
                if seen and seen[-1][0] >= 6:
                    os.kill(parse_child(out.read_text())[-1]["pid"],
                            signal.SIGKILL)
                    killed = True
            rejoined = journal.exists() and sum(
                '"launch"' in ln and '"worker:1"' in ln
                for ln in journal.read_text().splitlines()) > 1
            # worker:0's generation-1 attempt waits at its step boundary
            # until the rejoin is launched
            if (killed and not held and not rejoined and len(parse_child(
                    (logs / "worker_0.stdout").read_text())) > 1):
                hold.write_text("")
                held = True
            if rejoined:
                hold.unlink(missing_ok=True)
            time.sleep(0.05)
        assert done.wait(60), "the job did not end"
    finally:
        hold.unlink(missing_ok=True)
        s_out, s_err = straight.communicate(timeout=120)
    text = {p.name: p.read_text() for p in logs.glob("*.std*")}
    assert killed, text
    assert result["status"] == JobStatus.SUCCEEDED, text

    inter = Path(tmp_job_dirs["history"]) / "intermediate" / client.app_id
    recs = {r["id"]: r for r in read_traces(inter / TASK_TRACE_FILE)}
    w0, w1 = _span_names(recs["worker:0"]), _span_names(recs["worker:1"])
    assert w0.count("resized") == 2 and w1.count("resized") == 2, (w0, w1)
    assert "ckpt_prestaged" in w1, w1
    assert recs["worker:1"]["attrs"]["prestage_bytes"] > 0
    assert recs["worker:0"]["attrs"]["restarts"] == 0
    # a drain notice its child never read (a SIGTERM during its start-up)
    # must not drain the next attempt: no preemption in this job
    assert "preempted" not in w0 and "preempting" not in w0, w0
    assert w0[-1] == w1[-1] == "finished"
    state = load_state(journal)
    assert state.gang_generation == 2 and not state.detached

    # every attempt of every worker repeats the straight run's losses to
    # the bit
    want = {s: loss for s, loss, _ in _steps_and_losses(s_out)}
    assert sorted(want) == list(range(top)), s_err[-2000:]
    for w in ("worker_0", "worker_1"):
        seq = _steps_and_losses(text[f"{w}.stdout"])
        steps = [s for s, _, _ in seq]
        assert steps[0] == 0, steps
        assert _continuity(steps) <= 3 * E2E_EVERY, steps
        assert [loss for s, loss, _ in seq] == [want[s] for s in steps], w
        assert steps[-1] >= E2E_STEPS - 1, steps
