"""The port's control plane (conf, session, scheduler, runtimes, rpc,
events, metrics, provisioners) held against the JAX package's on the same
inputs, and the features the port does not have yet refused by name."""

import json
import os
import stat
from dataclasses import asdict
from pathlib import Path

import pytest

import tony_tpu.conf as jconf
import tony_tpu.events.driver_journal as jjournal
import tony_tpu.events.history as jhistory
import tony_tpu.rpc as jrpc
import tony_tpu.rpc.protocol as jprotocol
import tony_tpu.scheduler as jscheduler
import tony_tpu.session as jsession
import tony_tpu.utils.containers as jcontainers
import tony_tpu.utils.localization as jlocalization
from tony_tpu.runtimes.base import TaskContext as JTaskContext
from tony_tpu.runtimes.jax_runtime import JaxDriverAdapter, JaxTaskAdapter
from tony_tpu_torch import conf as pconf
from tony_tpu_torch import driver as pdriver
from tony_tpu_torch import metrics as pmetrics
from tony_tpu_torch import rpc as prpc
from tony_tpu_torch import runtimes as pruntimes
from tony_tpu_torch import scheduler as pscheduler
from tony_tpu_torch import session as psession
from tony_tpu_torch.cli import main as pcli
from tony_tpu_torch.cluster import create_provisioner
from tony_tpu_torch.events import driver_journal as pjournal
from tony_tpu_torch.events import history as phistory
from tony_tpu_torch.rpc import protocol as pprotocol
from tony_tpu_torch.runtimes.base import TaskContext as PTaskContext
from tony_tpu_torch.runtimes.torch_runtime import (
    TorchDriverAdapter, TorchTaskAdapter,
)
from tony_tpu_torch.utils import containers as pcontainers
from tony_tpu_torch.utils import localization as plocalization

REPO = Path(__file__).resolve().parent.parent

# job configs that exercise roles, env parsing, the DAG keys and the caps
CONFS = {
    "gang": {"tony.worker.instances": 3, "tony.worker.command": "python t.py",
             "tony.worker.chips": 1, "tony.ps.instances": 2,
             "tony.ps.memory-mb": 4096,
             "tony.worker.env": "A=1, B=two;C=x=y"},
    "dag": {"tony.prep.instances": 1, "tony.prep.command": "echo prep",
            "tony.worker.instances": 2, "tony.worker.depends-on": "prep",
            "tony.eval.instances": 1, "tony.eval.depends-on": "worker,prep",
            "tony.application.distributed-mode": "FCFS"},
    "stages": {"tony.a.instances": 1, "tony.b.instances": 2,
               "tony.c.instances": 1,
               "tony.application.prepare-stage": "a",
               "tony.application.training-stage": "b,c",
               "tony.b.max-restarts": 2, "tony.c.framework": "serving",
               "tony.b.resources": "/tmp/x.zip::archive,/tmp/y#z"},
    "chief": {"tony.chief.instances": 1, "tony.worker.instances": 4,
              "tony.application.untracked.jobtypes": "ps",
              "tony.ps.instances": 1,
              "tony.application.stop-on-failure-jobtypes": "chief"},
}
OVERRIDES = ["tony.worker.instances=5", "tony.am.retry-count=2",
             "tony.task.heartbeat-interval-ms=250",
             "tony.application.fail-on-worker-failure-enabled=true",
             "tony.x.ratio=0.5", "tony.execution.env=K=V,L=W"]
# the defaults the port sets differently: its own framework, names and dirs
PORT_DEFAULTS = {"tony.application.framework", "tony.application.name",
                 "tony.staging.dir", "tony.history.location",
                 "tony.history.intermediate", "tony.history.finished"}


def _write(tmp_path, name, data) -> str:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_conf_resolve_and_role_specs_match_jax(tmp_path, monkeypatch, name):
    monkeypatch.delenv("TONY_CONF_DIR", raising=False)
    files = [_write(tmp_path, name, CONFS[name])]
    overrides = OVERRIDES if name == "gang" else []
    j = jconf.TonyConf.resolve(files, overrides)
    p = pconf.TonyConf.resolve(files, overrides)
    jd, pd = j.as_dict(), p.as_dict()
    assert set(jd) == set(pd)
    assert {k for k in jd if jd[k] != pd[k]} <= PORT_DEFAULTS
    assert [asdict(s) for s in p.role_specs()] == \
        [asdict(s) for s in j.role_specs()]
    assert p.untracked_roles() == j.untracked_roles()
    j.validate()
    p.validate()


def test_key_table_and_defaults_match_jax():
    assert pconf.keys.ROLE_KEY_TEMPLATES == jconf.keys.ROLE_KEY_TEMPLATES
    jd, pd = jconf.load_defaults(), pconf.load_defaults()
    assert set(jd) == set(pd)
    assert {k for k in jd if jd[k] != pd[k]} == PORT_DEFAULTS
    assert pd["tony.application.framework"] == "torch"
    names = {n: getattr(jconf.keys, n) for n in dir(jconf.keys)
             if n.isupper()}
    assert {n: getattr(pconf.keys, n) for n in names} == names


@pytest.mark.parametrize("bad", [
    {"tony.worker.instances": 2, "tony.worker.chips": 1,
     "tony.task.max-total-chips": 1},
    {"tony.worker.instances": 3, "tony.task.max-total-instances": 2},
    {"tony.worker.instances": 2, "tony.worker.max-instances": 1},
    {"tony.worker.instances": 1,
     "tony.application.distributed-mode": "ROUNDROBIN"},
    {"tony.worker.instances": 1, "tony.worker.priority-class": "bulk"},
    {},
])
def test_validation_errors_match_jax(bad):
    with pytest.raises(ValueError) as je:
        jconf.TonyConf(bad).validate()
    with pytest.raises(ValueError) as pe:
        pconf.TonyConf(bad).validate()
    assert str(pe.value) == str(je.value)


def test_jax_example_configs_parse_the_same(monkeypatch):
    monkeypatch.delenv("TONY_CONF_DIR", raising=False)
    for path in sorted((REPO / "tony_tpu" / "examples" / "configs").glob(
            "*.json")):
        j = jconf.TonyConf.resolve([path])
        p = pconf.TonyConf.resolve([path])
        assert [asdict(s) for s in p.role_specs()] == \
            [asdict(s) for s in j.role_specs()], path.name


def test_port_configs_validate_and_count_cards():
    cfgs = REPO / "tony_tpu_torch" / "examples" / "configs"
    want = {"mnist_cuda.json": ("torch", 1, 1),
            "lm_train_cuda.json": ("torch", 4, 1),
            "serve_cuda.json": ("serving", 1, 1)}
    assert sorted(p.name for p in cfgs.glob("*.json")) == sorted(want)
    for name, (fw, n, chips) in want.items():
        conf = pconf.TonyConf.resolve([cfgs / name], include_site=False)
        conf.validate()
        pdriver.check_ported(conf, environ={})
        (spec,) = conf.role_specs()
        assert (conf.get("tony.application.framework"), spec.instances,
                spec.chips) == (fw, n, chips)
        assert "tony_tpu_torch" in spec.command
    lm = pconf.TonyConf.resolve([cfgs / "lm_train_cuda.json"],
                                include_site=False)
    assert "--mesh fsdp=4" in lm.role_specs()[0].command
    lm.set("tony.worker.instances", 5)
    with pytest.raises(ValueError, match="max-total-chips=4"):
        lm.validate()


# ------------------------------------------------------- session, scheduler

REGISTRATIONS = [("worker:2", "10.0.0.3", 4002), ("ps:0", "10.0.0.9", 5000),
                 ("worker:0", "10.0.0.1", 4000), ("chief:0", "10.0.0.7", 6000),
                 ("worker:1", "10.0.0.2", 4001), ("ps:1", "10.0.0.8", 5001)]
ROLES = {"tony.worker.instances": 3, "tony.ps.instances": 2,
         "tony.chief.instances": 1}


def _sessions(conf_dict):
    return (jsession.Session(jconf.TonyConf(conf_dict)),
            psession.Session(pconf.TonyConf(conf_dict)))


def test_session_cluster_spec_and_completion_match_jax():
    js, ps = _sessions(ROLES)
    for k, (task, host, port) in enumerate(REGISTRATIONS):
        for s in (js, ps):
            s.register_task(task, host, port)
        assert ps.cluster_spec() == js.cluster_spec()
        assert ps.all_registered() == js.all_registered()
        assert ps.unregistered_tasks() == js.unregistered_tasks()
    for role in ROLES:
        name = role.split(".")[1]
        assert [t.task_id for t in ps.registered_tasks(name)] == \
            [t.task_id for t in js.registered_tasks(name)]
        for i in range(3):
            assert ps.is_chief(name, i) == js.is_chief(name, i)
    for name, idx, code in [("worker", 1, 1), ("ps", 0, 0), ("worker", 0, 0),
                            ("ps", 1, 0), ("worker", 2, 0), ("chief", 0, 0)]:
        for s in (js, ps):
            s.on_task_completed(name, idx, code)
        assert ps.update_status().value == js.update_status().value
        assert [i.to_dict() for i in ps.task_infos()] == \
            [i.to_dict() for i in js.task_infos()]
    js2, ps2 = _sessions(ROLES)
    for s in (js2, ps2):
        s.on_task_completed("chief", 0, 3)
    assert (ps2.status.value, ps2.failure_message) == \
        (js2.status.value, js2.failure_message)


@pytest.mark.parametrize("name", ["dag", "stages", "gang"])
def test_dag_release_order_matches_jax(name):
    order = {"jax": [], "port": []}
    conf_j, conf_p = jconf.TonyConf(CONFS[name]), pconf.TonyConf(CONFS[name])
    js = jscheduler.TaskScheduler(conf_j, conf_j.role_specs(),
                                  lambda s: order["jax"].append(s.name))
    ps = pscheduler.TaskScheduler(conf_p, conf_p.role_specs(),
                                  lambda s: order["port"].append(s.name))
    for s in (js, ps):
        s.schedule()
    assert order["port"] == order["jax"]
    # complete every task of every scheduled role, in release order
    done = 0
    while done < len(order["jax"]):
        role = order["jax"][done]
        done += 1
        n = conf_j.get(f"tony.{role}.instances")
        for _ in range(n):
            for s in (js, ps):
                s.on_task_completed(role, True)
            assert order["port"] == order["jax"]
            assert ps.unscheduled_roles() == js.unscheduled_roles()
    assert not ps.unscheduled_roles()


def test_dependency_errors_match_jax():
    cyc = {"tony.a.instances": 1, "tony.b.instances": 1,
           "tony.a.depends-on": "b", "tony.b.depends-on": "a"}
    unknown = {"tony.a.instances": 1, "tony.a.depends-on": "zz"}
    for bad, exc in ((cyc, pscheduler.DependencyCycleError),
                     (unknown, ValueError)):
        with pytest.raises(ValueError) as je:
            c = jconf.TonyConf(bad)
            jscheduler.TaskScheduler(c, c.role_specs(), print)
        with pytest.raises(exc) as pe:
            c = pconf.TonyConf(bad)
            pscheduler.TaskScheduler(c, c.role_specs(), print)
        assert str(pe.value) == str(je.value)


# ----------------------------------------------------------------- runtimes

@pytest.mark.parametrize("order", [REGISTRATIONS, REGISTRATIONS[::-1]])
def test_torch_runtime_payload_matches_jax_adapter(order):
    js, ps = _sessions(ROLES)
    ja, pa = JaxDriverAdapter(), TorchDriverAdapter()
    ja.set_session(js)
    pa.set_session(ps)
    for task, host, port in order:
        js.register_task(task, host, port)
        ps.register_task(task, host, port)
        jp, pp = ja.cluster_spec_payload(task), pa.cluster_spec_payload(task)
        assert pp == jp
    assert pp["num_processes"] == 6
    assert pp["coordinator_address"] == "10.0.0.7:6000"   # chief:0, rank 0
    assert sorted(pp["ranks"].values()) == list(range(6))
    from tony_tpu.api import DistributedMode as JMode
    from tony_tpu_torch.api import DistributedMode as PMode

    assert pa.can_start_task(PMode.GANG, "ps:0") == \
        ja.can_start_task(JMode.GANG, "ps:0") is True


def _contexts(payload, role, index):
    base = {"TONY_TASK_PORT": "4000", "TONY_JOB_NAME": role}
    kw = dict(job_name=role, task_index=index, task_num=3,
              num_total_tasks=6, is_chief=False, command="x",
              cluster_payload=payload, base_child_env=base)
    return JTaskContext(**kw), PTaskContext(**kw)


def test_build_env_exports_the_jax_runtimes_contract(monkeypatch):
    monkeypatch.delenv("TONY_NUM_SLICES", raising=False)
    js, ps = _sessions(ROLES)
    ja, pa = JaxDriverAdapter(), TorchDriverAdapter()
    ja.set_session(js)
    pa.set_session(ps)
    for task, host, port in REGISTRATIONS:
        js.register_task(task, host, port)
        ps.register_task(task, host, port)
    payload = pa.cluster_spec_payload("worker:0")
    seen = set()
    for task, _, _ in REGISTRATIONS:
        role, _, idx = task.partition(":")
        jctx, pctx = _contexts(payload, role, int(idx))
        env = TorchTaskAdapter().build_env(pctx)
        assert env == JaxTaskAdapter().build_env(jctx)
        assert env["TONY_COORDINATOR_ADDRESS"] == "10.0.0.7:6000"
        assert env["TONY_NUM_PROCESSES"] == "6"
        assert json.loads(env["CLUSTER_SPEC"]) == ps.cluster_spec()
        seen.add(env["TONY_PROCESS_ID"])
    assert seen == {str(r) for r in range(6)}
    # without ranks (an empty payload) both fall back to the same rank
    jctx, pctx = _contexts({"cluster": ps.cluster_spec()}, "worker", 2)
    assert TorchTaskAdapter().build_env(pctx) == \
        JaxTaskAdapter().build_env(jctx)


@pytest.mark.parametrize("name", sorted(pruntimes.NOT_PORTED))
def test_other_framework_runtimes_are_refused_by_name(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        pruntimes.get_runtime(name)
    with pytest.raises(ValueError, match="unknown framework"):
        pruntimes.get_runtime("nonesuch")
    assert pruntimes.get_runtime("torch").name == "torch"


def test_serving_adapter_exports_the_serve_port_and_conf_flags():
    from tony_tpu.runtimes.serving import ServingTaskAdapter as J
    from tony_tpu_torch.runtimes.serving import ServingTaskAdapter as P

    data = {"tony.serving.paged-kv": True, "tony.serving.kv-block": 16,
            "tony.serving.prefill-instances": 1,
            "tony.serving.batch-queue-frac": "0.5"}
    for idx in (0, 1):
        jctx, pctx = _contexts({"cluster": {"replica": ["h:1"]}},
                               "replica", idx)
        jctx.conf, pctx.conf = jconf.TonyConf(data), pconf.TonyConf(data)
        env = P().build_env(pctx)
        assert env == J().build_env(jctx)
        assert env["TONY_SERVE_PORT"] == "4000"
    assert "--paged-kv" in env["TONY_SERVE_EXTRA_FLAGS"]


# ---------------------------------------------------------------------- rpc

def _server(mod, token, roles=None, acl=None):
    server = mod.RpcServer(token=token, roles=roles, acl=acl)
    server.register("add", lambda a, b: a + b)
    server.register("finish_application", lambda: True)
    server.start()
    return server


@pytest.mark.parametrize("direction", ["port_client_jax_server",
                                       "jax_client_port_server"])
def test_rpc_frames_cross_between_the_packages(direction):
    client_mod, server_mod = ((prpc, jrpc) if direction.startswith("port")
                              else (jrpc, prpc))
    assert pprotocol.derive_role_key("s", "client") == \
        jprotocol.derive_role_key("s", "client")
    assert pprotocol.sign("k", "m", {"a": [1, 2]}, "executor") == \
        jprotocol.sign("k", "m", {"a": [1, 2]}, "executor")
    secret = "s3cret"
    keys_ = {r: jprotocol.derive_role_key(secret, r)
             for r in ("client", "executor")}
    server = _server(server_mod, secret, roles=keys_,
                     acl={"finish_application": {"client"}})
    try:
        cli = client_mod.RpcClient("127.0.0.1", server.port,
                                   token=keys_["client"], role="client")
        exe = client_mod.RpcClient("127.0.0.1", server.port,
                                   token=keys_["executor"], role="executor",
                                   max_retries=1)
        assert cli.call("add", a=2, b=3) == 5
        assert exe.call("add", a={"x": 1}.get("x"), b=1) == 2
        assert cli.call("finish_application") is True
        with pytest.raises(client_mod.RpcError, match="authorization failed"):
            exe.call("finish_application")
        with pytest.raises(client_mod.RpcError, match="unknown method"):
            cli.call("nope")
        forged = client_mod.RpcClient("127.0.0.1", server.port,
                                      token=keys_["executor"], role="client",
                                      max_retries=1)
        with pytest.raises(client_mod.RpcError, match="authentication"):
            forged.call("add", a=1, b=1)
        for c in (cli, exe, forged):
            c.close()
    finally:
        server.stop()


# --------------------------------------------------------- events, journal

def test_history_names_events_and_journal_read_by_the_jax_package(tmp_path):
    for args in [("app_1", 5, None, "", ""), ("a-b", 5, 9, "me", "failed")]:
        name = phistory.history_file_name(*args)
        assert name == jhistory.history_file_name(*args)
        assert asdict(phistory.parse_history_file_name(name)) == \
            asdict(jhistory.parse_history_file_name(name))
    path = tmp_path / "driver.journal.jsonl"
    j = pjournal.DriverJournal(path)
    j.record("meta", app_id="app", token="t", session_id=0, rpc_port=7,
             driver_generation=0)
    j.record("launch", task="worker:0", attempt=1, container_id="c0",
             pid=11, host="h", t=1.0, log_path="/l")
    j.record("register", task="worker:0", host="h", port=9)
    j.record("restarts", task="worker:0", used=1)
    j.record("ports", task="worker:0", ports={"serve_port": 9})
    j.record("terminal", task="worker:0", status="SUCCEEDED", exit_code=0)
    j.close()
    st = jjournal.load_state(path)
    assert (st.app_id, st.rpc_port) == ("app", 7)
    rec = st.tasks["worker:0"]
    assert (rec.attempt, rec.pid, rec.registered, rec.reg_port, rec.restarts,
            rec.ports, rec.status, rec.exit_code) == \
        (1, 11, True, 9, 1, {"serve_port": 9}, "SUCCEEDED", 0)


# ------------------------------------------------------------------ metrics

def _fake_nvidia_smi(tmp_path, monkeypatch, rows: str, rc: int = 0):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    tool = bin_dir / "nvidia-smi"
    tool.write_text(f"#!/bin/sh\necho \"$@\" > {tmp_path}/args\n"
                    f"printf '{rows}'\nexit {rc}\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")


def test_gpu_sampler_reads_the_tasks_card(tmp_path, monkeypatch):
    _fake_nvidia_smi(tmp_path, monkeypatch,
                     "0, 97, 40000, 81559\\n1, 3, 500, 81559\\n"
                     "2, 0, 4, 81559\\n3, [N/A], 4, 81559\\n")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    m, why = pmetrics.sample_gpu_metrics(rank=1, explain=True)
    assert why is None
    assert m == {"gpu_utilization_pct": 3.0, "gpu_memory_used_mb": 500.0,
                 "gpu_memory_total_mb": 81559.0, "gpu_index": 1.0}
    assert (tmp_path / "args").read_text().split() == \
        pmetrics._NVIDIA_SMI_QUERY[1:]
    # rank r takes card r % visible, in CUDA_VISIBLE_DEVICES's order
    assert pmetrics.sample_gpu_metrics(rank=5)["gpu_index"] == 1.0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,2")
    m = pmetrics.sample_gpu_metrics(rank=0)
    assert m == {"gpu_memory_used_mb": 4.0, "gpu_memory_total_mb": 81559.0,
                 "gpu_index": 3.0}
    assert pmetrics.sample_gpu_metrics(rank=1)["gpu_index"] == 2.0


def test_gpu_sampler_says_why_it_is_empty(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    m, why = pmetrics.sample_gpu_metrics(explain=True)
    assert m == {} and "nvidia-smi not runnable" in why
    assert pmetrics.sample_gpu_metrics() == {}
    failing = tmp_path / "failing"
    failing.mkdir()
    _fake_nvidia_smi(failing, monkeypatch, "", rc=9)
    m, why = pmetrics.sample_gpu_metrics(explain=True)
    assert m == {} and "exited 9" in why


def test_task_monitor_pushes_rss_heartbeats_and_step_records(tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))       # no nvidia-smi here
    pushes = []

    class Rpc:
        def call(self, method, **kw):
            pushes.append((method, kw))

    step_log = tmp_path / "steps.jsonl"
    step_log.write_text(json.dumps({"step": 50, "p50_s": 0.25,
                                    "steps_per_sec": 4.0,
                                    "train_step": 49}) + "\n{torn")
    mon = pmetrics.TaskMonitor(Rpc(), "worker:0", interval_s=60)
    mon.set_step_log(str(step_log))
    mon.note(pmetrics.HEARTBEAT_RTT_MS, 2.0)
    mon.note(pmetrics.HEARTBEAT_RTT_MS, 4.0)
    mon.note(pmetrics.HEARTBEATS_MISSED, 1.0)
    mon.note(pmetrics.HEARTBEATS_MISSED, 2.0)
    mon.add_span("work_dir_ready", 5.0)
    mon.stop()
    method, kw = pushes[-1]
    got = {e["name"]: e["value"] for e in kw["metrics"]}
    assert method == "update_metrics" and kw["task_id"] == "worker:0"
    assert got["max_heartbeat_rtt_ms"] == 4.0
    assert got["avg_heartbeat_rtt_ms"] == 3.0
    assert got["max_heartbeats_missed"] == got["avg_heartbeats_missed"] == 2
    assert got["max_step_time_p50_s"] == 0.25
    assert got["max_train_step"] == 49 and got["max_memory_rss_mb"] > 0
    assert kw["spans"] == [["work_dir_ready", 5.0]]


# ------------------------------------------------------ refused by name

@pytest.mark.parametrize("key,value,item", [
    ("tony.warmpool.size", 2, "the warm pool"),
    ("tony.autoscale.enabled", True, "autoscaler"),
    ("tony.quota.pool-slots", 4, "autoscaler"),
    ("tony.slo.avail.objective", "availability", "metrics hub/SLOs"),
    ("tony.worker.priority-class", "batch", "arbiter"),
    ("tony.application.enable-preprocess", True, "the portal"),
])
def test_unported_driver_features_raise_naming_their_item(tmp_path, key,
                                                          value, item):
    conf = pconf.TonyConf({"tony.worker.instances": 1, key: value,
                           "tony.staging.dir": str(tmp_path),
                           "tony.history.intermediate": str(tmp_path)})
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1: .*{item}"):
        pdriver.check_ported(conf, environ={})
    d = pdriver.Driver(conf, app_id="a", job_dir=str(tmp_path))
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            d.prepare()
        assert not (tmp_path / "driver.json").exists()
    finally:
        d.rpc_server.stop()
    from tony_tpu_torch.client import TonyClient

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TonyClient(conf).submit()
    assert list(tmp_path.iterdir()) == []     # nothing was staged


def test_unported_driver_chaos_rpc_and_provisioner_raise(tmp_path):
    conf = pconf.TonyConf({"tony.worker.instances": 1})
    with pytest.raises(NotImplementedError,
                       match="driver chaos.*queue 1: driver recovery"):
        pdriver.check_ported(conf, environ={
            "TONY_TEST_DRIVER_SIGKILL_AT_STEP": "5"})
    svc = pdriver.DriverService(None)
    with pytest.raises(NotImplementedError, match="router"):
        svc.roll_task("worker:0")
    conf.set("tony.cluster.provisioner", "tpu-pod")
    with pytest.raises(NotImplementedError, match="GPU-node provisioner"):
        create_provisioner(conf)
    with pytest.raises(NotImplementedError, match="driver recovery"):
        pdriver.main(["--job-dir", str(tmp_path), "--app-id", "a",
                      "--recover"])


@pytest.mark.parametrize("cmd", sorted(pcli.NOT_PORTED))
def test_cli_refuses_unported_subcommands(cmd, capsys):
    assert pcli.main([cmd, "--port", "1"]) == 2
    assert "ROADMAP.md queue 1" in capsys.readouterr().err


# ------------------------------------------------------------------- utils

def test_resources_and_container_command_match_jax(tmp_path):
    raws = ["/a/b.zip::archive", "/c/d#e", "/f/g.txt"]
    assert [asdict(s) for s in plocalization.parse_resources(raws)] == \
        [asdict(s) for s in jlocalization.parse_resources(raws)]
    data = {"tony.docker.enabled": True, "tony.docker.containers.image": "i",
            "tony.docker.worker.image": "w", "tony.worker.instances": 1,
            "tony.docker.containers.mount": "/x:/x:ro",
            "tony.docker.extra-args": "--gpus all",
            "tony.execution.env": "A=1", "tony.worker.env": "B=2"}
    jc, pc = jconf.TonyConf(data), pconf.TonyConf(data)
    args = ("python t.py", {"TONY_X": "1"})
    kw = dict(work_dir=str(tmp_path), role="worker", job_dir="/j", name="n")
    assert pcontainers.build_container_command(*args, pc, **kw) == \
        jcontainers.build_container_command(*args, jc, **kw)
    assert pcontainers.passthrough_env(pc, "worker") == \
        jcontainers.passthrough_env(jc, "worker") == {"A": "1", "B": "2"}
