"""The port's launch path end to end on the CPU: its TonyClient starts its
driver (``python -S -m tony_tpu_torch.driver``), which launches its
executors, which fork fixture scripts under the torch runtime — the
counterparts of tests/test_e2e_local.py's scenarios, plus one conf run
through both packages' clients and held equal."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tony_tpu.client import TonyClient as JaxClient
from tony_tpu.conf import TonyConf as JaxConf
from tony_tpu_torch.api import JobStatus
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.cluster.provisioner import _pid_alive
from tony_tpu_torch.conf import TonyConf

PY = sys.executable
REPO = Path(__file__).resolve().parent.parent


def base_conf(dirs, conf_cls=TonyConf, **extra):
    return conf_cls({
        "tony.staging.dir": dirs["staging"],
        "tony.history.location": dirs["history"],
        "tony.history.intermediate": dirs["history"] + "/intermediate",
        "tony.history.finished": dirs["history"] + "/finished",
        "tony.am.monitor-interval-ms": 100,
        "tony.task.registration-poll-interval-ms": 100,
        **extra,
    })


def run_job(dirs, client_cls=TonyClient, conf_cls=TonyConf, **extra):
    client = client_cls(base_conf(dirs, conf_cls, **extra),
                        poll_interval_s=0.1)
    client.submit()
    return client.monitor(), client


def dump_logs(client):
    out = []
    for p in sorted(Path(client.job_dir).rglob("*.log")) + sorted(
            Path(client.job_dir).rglob("*.std*")):
        out.append(f"==== {p} ====\n{p.read_text()[-3000:]}")
    return "\n".join(out)


def history_events(dirs, app_id) -> list:
    inter = Path(dirs["history"]) / "intermediate" / app_id
    (jhist,) = list(inter.glob("*.jhist"))
    return jhist, [json.loads(ln) for ln in jhist.read_text().splitlines()]


# --------------------------------------------------------------- happy paths

def test_single_worker_passes(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 1,
                         "tony.worker.command":
                             f"{PY} {fixture_script('exit_0.py')}"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    (info,) = client.task_infos
    assert info.status == "SUCCEEDED" and info.launch_path == "cold"
    assert info.url.endswith("worker_0.stdout") and Path(info.url).exists()
    # the driver never imported torch: it ran under python -S
    log = (Path(client.job_dir) / "driver.log").read_text()
    assert "driver exiting with job status SUCCEEDED" in log


def test_gang_of_three_gets_the_runtime_contract(tmp_job_dirs, fixture_script,
                                                 tmp_path):
    """check_jax_env.py (the JAX runtime's contract check) passes unchanged
    under the torch runtime, and the three ranks are distinct."""
    rank_dir = tmp_path / "ranks"
    rank_dir.mkdir()
    cmd = (f"{PY} {fixture_script('check_jax_env.py')} && "
           f"{PY} {fixture_script('write_rank_file.py')}")
    status, client = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 3,
                         "tony.worker.command": f"bash -c '{cmd}'",
                         "tony.execution.env": f"RANK_OUT_DIR={rank_dir}"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    ranks = {p.name: p.read_text() for p in rank_dir.iterdir()}
    assert ranks == {"rank_0": "worker:0", "rank_1": "worker:1",
                     "rank_2": "worker:2"}


# ------------------------------------------------------------ failure policy

def test_worker_failure_fails_job(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 1,
                         "tony.worker.command":
                             f"{PY} {fixture_script('exit_1.py')}"})
    assert status == JobStatus.FAILED
    assert client.task_infos[0].exit_code == 1


def test_non_chief_failure_tolerated(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.chief.instances": 1,
           "tony.chief.command": f"{PY} {fixture_script('exit_0.py')}",
           "tony.worker.instances": 2,
           "tony.worker.command":
               "bash -c 'if [ \"$TONY_TASK_INDEX\" = 1 ]; then exit 1; "
               "else exit 0; fi'"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    by_id = {t.task_id: t for t in client.task_infos}
    assert by_id["worker:1"].status == "FAILED"


def test_chief_failure_fails_job(tmp_job_dirs):
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 2,
           "tony.worker.command":
               "bash -c 'if [ \"$TONY_TASK_INDEX\" = 0 ]; then exit 1; "
               "else sleep 60; fi'"})
    assert status == JobStatus.FAILED
    assert "chief" in client.final_state.get("message", "")


def test_standalone_mode(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs, **{"tony.application.framework": "standalone",
                         "tony.worker.instances": 1,
                         "tony.worker.command":
                             f"{PY} {fixture_script('exit_0.py')}"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    client = TonyClient(base_conf(
        tmp_job_dirs, **{"tony.application.framework": "standalone",
                         "tony.worker.instances": 2,
                         "tony.worker.command": "true"}),
        poll_interval_s=0.1)
    client.submit()
    with pytest.raises((RuntimeError, TimeoutError)):
        client.monitor()


# -------------------------------------------------------------- dag + events

def test_dag_scheduling(tmp_job_dirs, tmp_path):
    marker = tmp_path / "order.txt"
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.prep.instances": 1,
           "tony.prep.command": f"bash -c 'sleep 0.3; echo prep >> {marker}'",
           "tony.worker.instances": 1,
           "tony.worker.command": f"bash -c 'echo worker >> {marker}'",
           "tony.worker.depends-on": "prep",
           "tony.application.distributed-mode": "FCFS"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    assert marker.read_text().splitlines() == ["prep", "worker"]


def test_history_events_traces_and_journal_written(tmp_job_dirs,
                                                   fixture_script):
    from tony_tpu.events.driver_journal import load_state

    # a child that outlives a few beats and a metrics push
    status, client = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 1,
                         "tony.worker.command":
                             f"bash -c 'sleep 0.6 && {PY} "
                             f"{fixture_script('exit_0.py')}'",
                         "tony.task.metrics-interval-ms": 200,
                         "tony.task.heartbeat-interval-ms": 100})
    assert status == JobStatus.SUCCEEDED
    jhist, events = history_events(tmp_job_dirs, client.app_id)
    assert "SUCCEEDED" in jhist.name
    types = [e["type"] for e in events]
    assert types[0] == "APPLICATION_INITED"
    assert types[-1] == "APPLICATION_FINISHED"
    assert "TASK_STARTED" in types and "TASK_TRACE" in types
    (fin,) = [e for e in events if e["type"] == "TASK_FINISHED"]
    names = {m["name"] for m in fin["payload"]["metrics"]}
    assert {"max_memory_rss_mb", "max_heartbeat_rtt_ms"} <= names
    traces = [json.loads(ln) for ln in (jhist.parent / "tasks.trace.jsonl")
              .read_text().splitlines()]
    spans = [s[0] for s in traces[0]["spans"]]
    for a, b in zip(["requested", "allocated", "launched", "registered",
                     "running", "child_spawned"], ["allocated", "launched",
                                                   "registered", "running",
                                                   "child_exited", "finished"]):
        assert spans.index(a) < spans.index(b), spans
    # the JAX package's recovery reads the port's journal
    state = load_state(Path(client.job_dir) / "driver.journal.jsonl")
    rec = state.tasks["worker:0"]
    assert state.app_id == client.app_id
    assert (rec.attempt, rec.registered, rec.status) == (1, True, "SUCCEEDED")


# ---------------------------------------------------------- fault injection

def test_executor_crash_before_register_fails_job(tmp_job_dirs,
                                                  fixture_script):
    status, _ = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 1,
                         "tony.worker.command":
                             f"{PY} {fixture_script('exit_0.py')}",
                         "tony.worker.env": "TONY_TEST_TASK_EXECUTOR_CRASH=1"})
    assert status == JobStatus.FAILED


def test_missed_heartbeats_fail_job(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 1,
           "tony.worker.command": f"{PY} {fixture_script('sleep_long.py')}",
           "tony.task.heartbeat-interval-ms": 100,
           "tony.task.max-missed-heartbeats": 3,
           "tony.worker.env": "TONY_TEST_EXECUTOR_NUM_HB_MISS=1000"})
    assert status == JobStatus.FAILED
    assert "heartbeat" in client.final_state.get("message", "")


def test_execution_timeout_kills_user_process(tmp_job_dirs, fixture_script):
    t0 = time.monotonic()
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 1,
           "tony.worker.command": f"{PY} {fixture_script('sleep_long.py')}",
           "tony.task.executor.execution-timeout-ms": 1500})
    assert status == JobStatus.FAILED
    # the executor exits with the SIGKILLed child's code, -9 & 0xff
    assert client.task_infos[0].exit_code == 256 - 9
    assert time.monotonic() - t0 < 60


def test_restart_within_session(tmp_job_dirs, tmp_path):
    marker = tmp_path / "attempt"
    cmd = (f"bash -c 'if [ \"$TONY_TASK_INDEX\" = 1 ] && [ ! -f {marker} ]; "
           f"then touch {marker}; exit 7; fi; exit 0'")
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 2, "tony.worker.command": cmd,
           "tony.worker.max-restarts": 2,
           "tony.application.fail-on-worker-failure-enabled": True})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    assert marker.exists()
    traces = [json.loads(ln) for ln in (
        Path(tmp_job_dirs["history"]) / "intermediate" / client.app_id
        / "tasks.trace.jsonl").read_text().splitlines()]
    (w1,) = [t for t in traces if t["id"] == "worker:1"]
    assert [s[0] for s in w1["spans"]].count("registered") == 2
    assert w1["attrs"]["restarts"] == 1


def test_am_retry_count_reruns_the_session(tmp_job_dirs, tmp_path):
    marker = tmp_path / "attempted"
    cmd = (f"bash -c 'if [ -f {marker} ]; then exit 0; "
           f"else touch {marker}; exit 1; fi'")
    status, client = run_job(
        tmp_job_dirs, **{"tony.worker.instances": 1,
                         "tony.worker.command": cmd,
                         "tony.am.retry-count": 1})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    assert client.final_state["session_id"] == 1


def test_registration_timeout(tmp_job_dirs, fixture_script):
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 2,
           "tony.worker.command": f"{PY} {fixture_script('exit_0.py')}",
           "tony.worker.env": "TONY_TEST_EXECUTOR_SKEW=worker#1#600000",
           "tony.am.registration-timeout-ms": 1500})
    assert status == JobStatus.FAILED
    assert "register" in client.final_state.get("message", "")


# ------------------------------------------------------------------ serving

_REPLICA = r"""
import http.server, os, sys, threading, time
port = int(os.environ["TONY_SERVE_PORT"])
assert os.environ["TONY_SERVE_PORT"] == os.environ["TONY_TASK_PORT"]
class H(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass
    def do_GET(self):
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")
srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), H)
threading.Thread(target=srv.serve_forever, daemon=True).start()
time.sleep(float(sys.argv[1]))
"""


def test_serving_role_binds_its_port_and_publishes_it(tmp_job_dirs,
                                                      tmp_path):
    script = tmp_path / "replica.py"
    script.write_text(_REPLICA)
    seen = []
    client = TonyClient(base_conf(
        tmp_job_dirs, **{"tony.application.framework": "serving",
                         "tony.replica.instances": 2,
                         "tony.replica.command": f"{PY} {script} 2.5",
                         "tony.serving.healthz-interval-ms": 100}),
        poll_interval_s=0.1)
    client.add_listener(lambda infos: seen.append(
        {i.task_id: (i.port, dict(i.ports)) for i in infos}))
    client.submit()
    status = client.monitor()
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    published = {}
    for snap in seen:
        for tid, (port, ports) in snap.items():
            if ports:
                published[tid] = (port, ports)
    assert sorted(published) == ["replica:0", "replica:1"]
    for port, ports in published.values():
        assert ports == {"serve_port": port, "metrics_port": port}


# ------------------------------------------------- parity with the JAX client

@pytest.mark.parametrize("command", ["exit_0.py", "exit_1.py"])
def test_same_conf_through_both_clients(tmp_path, fixture_script, command):
    out = {}
    for name, client_cls, conf_cls in (("jax", JaxClient, JaxConf),
                                       ("port", TonyClient, TonyConf)):
        dirs = {"staging": str(tmp_path / name / "staging"),
                "history": str(tmp_path / name / "history")}
        # the framework both packages run the same contract under: the JAX
        # package's default ("jax") and the port's ("torch")
        status, client = run_job(
            dirs, client_cls, conf_cls,
            **{"tony.worker.instances": 1,
               "tony.worker.command": f"{PY} {fixture_script(command)}"})
        _, events = history_events(dirs, client.app_id)
        out[name] = (status.value,
                     [(t.task_id, t.status, t.exit_code)
                      for t in client.task_infos],
                     [e["type"] for e in events])
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("SUCCEEDED" if command == "exit_0.py"
                              else "FAILED")


def test_static_host_provisioner(tmp_job_dirs, fixture_script):
    """tony.cluster.provisioner=static: executors launched through the
    launch template on each host in turn (here a local shell, standing in
    for ssh), the job archive built for remote hosts."""
    template = "{env} " + PY + " -S -m tony_tpu_torch.executor"
    status, client = run_job(
        tmp_job_dirs,
        **{"tony.worker.instances": 2,
           "tony.worker.command": f"{PY} {fixture_script('check_jax_env.py')}",
           "tony.cluster.provisioner": "static",
           "tony.cluster.static-hosts": "127.0.0.1",
           "tony.cluster.launch-template": template,
           "tony.execution.env": f"PYTHONPATH={REPO}"})
    assert status == JobStatus.SUCCEEDED, dump_logs(client)
    assert (Path(client.job_dir) / "job_archive.tar.gz").exists()
    final = json.loads((Path(client.job_dir) / "tony-final.json").read_text())
    assert final["tony.application.archive-sha256"]


# ----------------------------------------------------------------- the CLI

def test_cli_local_and_submit(tmp_job_dirs, fixture_script, tmp_path):
    common = ["-D", f"tony.staging.dir={tmp_job_dirs['staging']}",
              "-D", "tony.history.intermediate="
                    f"{tmp_job_dirs['history']}/intermediate",
              "-D", "tony.am.monitor-interval-ms=100"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    local = subprocess.run(
        [PY, "-m", "tony_tpu_torch.cli.main", "local", "--instances", "2",
         "--command", f"{PY} {fixture_script('check_jax_env.py')}"] + common,
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert local.returncode == 0, local.stderr
    assert "worker:1: SUCCEEDED" in local.stderr
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"tony.worker.instances": 1,
                               "tony.worker.command":
                                   f"{PY} {fixture_script('exit_1.py')}"}))
    submit = subprocess.run(
        [PY, "-m", "tony_tpu_torch.cli.main", "submit", "--conf", str(job)]
        + common, cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert submit.returncode == 1
    assert "worker:0: FAILED" in submit.stderr


def test_stop_leaves_no_process_behind(tmp_job_dirs, fixture_script):
    """client.stop() ends the driver, its executors and their children; a
    task with restarts left is not relaunched by the stop (the JAX driver
    would relaunch it into a driver that is exiting)."""
    client = TonyClient(base_conf(
        tmp_job_dirs, **{"tony.worker.instances": 2,
                         "tony.worker.max-restarts": 2,
                         "tony.worker.command":
                             f"{PY} {fixture_script('sleep_long.py')}"}),
        poll_interval_s=0.1)
    client.submit()
    deadline = time.monotonic() + 60
    running = []
    while time.monotonic() < deadline and len(running) < 2:
        infos = client._connect().call("get_task_infos")
        running = [i for i in infos if i["status"] == "RUNNING"]
        time.sleep(0.1)
    assert len(running) == 2
    info = json.loads((Path(client.job_dir) / "driver.json").read_text())
    journal = [json.loads(ln) for ln in (Path(client.job_dir)
               / "driver.journal.jsonl").read_text().splitlines()]
    pids = [info["pid"]] + [r["pid"] for r in journal if r["op"] == "launch"]
    children = []
    for pid in pids[1:]:
        kids = Path(f"/proc/{pid}/task/{pid}/children")
        if kids.exists():
            children += [int(p) for p in kids.read_text().split()]
    client.stop()
    client._driver_proc.wait(timeout=30)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and any(
            _pid_alive(p) for p in pids + children):
        time.sleep(0.1)
    assert not [p for p in pids + children if _pid_alive(p)]
    journal = [json.loads(ln) for ln in (Path(client.job_dir)
               / "driver.journal.jsonl").read_text().splitlines()]
    assert [r["pid"] for r in journal if r["op"] == "launch"] == pids[1:]
