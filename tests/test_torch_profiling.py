"""The port's observability hooks on the CPU: the kernel-build counters
(observability.py ``CompileTelemetry``, fed by ops/_build.py), the
StepTimer's warm-up line, build snapshot, device-memory peak and
on-demand ``torch.profiler`` capture (train/profiling.py), the executor's
``write_profile_flag`` and Heartbeater relay, the driver's
``request_task_profile`` / heartbeat command / ``/profile`` route, the
TaskMonitor's push and serve's build families.

The counterparts of tests/test_device_time.py:200-425 (compile counting
and the storm warning, warm gating, the profile flag contract, a torn
flag, the relay and the Heartbeater) and tests/test_task_trace.py:329
and :444 (the command riding a heartbeat, the ACL, /profile with and
without token auth), held where they can be against the JAX package's
own classes; plus a profile command through a real job on the local
provisioner, captured by ``torch.profiler`` on the CPU."""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tony_tpu import observability as jobs
from tony_tpu_torch import constants as c
from tony_tpu_torch import metrics as pmetrics
from tony_tpu_torch import observability as pobs
from tony_tpu_torch.api import JobStatus
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.conf import TonyConf
from tony_tpu_torch.executor import Heartbeater, write_profile_flag
from tony_tpu_torch.observability import CompileTelemetry
from tony_tpu_torch.ops import _build
from tony_tpu_torch.train import profiling

REPO = Path(__file__).resolve().parent.parent


class _FakeWarm:
    def __init__(self):
        self.warm = 0

    def mark_warm(self):
        self.warm += 1

    def snapshot(self):
        return {"kernel_builds": 0, "kernel_build_time_s": 0.0,
                "kernel_builds_post_warm": 0}


# --------------------------------------------------------------------------
# CompileTelemetry and ops/_build.py's hook
# --------------------------------------------------------------------------

def test_compile_telemetry_counts_and_storm_warning(caplog):
    """tests/test_device_time.py:199 on kernel libraries: only builds and
    loads count, the warm-up line is drawn once, post-warm builds are
    counted and warn exactly once past the threshold, and the render copy
    is independent of the live histogram, whose bounds are the JAX
    package's."""
    ct = CompileTelemetry(storm_threshold=3)
    ct.note("link", 9.0)                        # not a library event
    assert ct.builds == 0
    ct.note("build", 0.5)
    ct.note("load", 1.5)
    snap = ct.snapshot()
    assert snap["kernel_builds"] == 2 and snap["kernel_nvcc_builds"] == 1
    assert not snap["warm"]
    assert snap["kernel_build_time_s"] == pytest.approx(2.0)
    assert snap["kernel_builds_post_warm"] == 0, "pre-warm builds are free"
    ct.mark_warm()
    ct.mark_warm()                              # idempotent
    with caplog.at_level("WARNING", logger="tony_tpu_torch.observability"):
        for _ in range(3):
            ct.note("load", 0.1)
    assert ct.recompiles_post_warm == 3
    assert ct.snapshot()["kernel_builds_post_warm"] == 3
    assert len([r for r in caplog.records
                if "kernel build storm" in r.message]) == 1
    h = ct.hist_copy()
    assert h.count == 5
    h.observe(1.0)
    assert ct.hist.count == 5
    ref = jobs.CompileTelemetry()
    assert ct.hist.bounds == ref.hist.bounds


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """ops/_build.py over an empty build directory, a fresh telemetry and
    nothing noted or loaded yet."""
    ct = CompileTelemetry()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "COMPILE_TELEMETRY", ct)
    monkeypatch.setattr(_build, "_noted", set())
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    return ct


def test_build_hook_notes_each_library_once(fresh_build, tmp_path,
                                            monkeypatch):
    """A stubbed nvcc: build_all notes one build a source with its
    seconds; a second build_all, with every library on disk, notes
    nothing. A library an earlier process built is noted as a load when
    ``kernel`` first opens it (a real shared library from the C
    compiler), and only once; after the warm-up line it counts as a
    post-warm build."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'not a library')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    assert _build.build_all() >= 0
    snap = fresh_build.snapshot()
    assert snap["kernel_builds"] == snap["kernel_nvcc_builds"] == 3
    assert snap["kernel_build_time_s"] > 0
    assert _build.noted() == sorted(_build.SOURCES)
    _build.build_all()
    assert fresh_build.builds == 3

    # a fresh process over a directory holding a real library
    ct = CompileTelemetry()
    monkeypatch.setattr(_build, "COMPILE_TELEMETRY", ct)
    monkeypatch.setattr(_build, "_noted", set())
    src = tmp_path / "geometry.c"
    src.write_text("int tony_flash_decode_geometry(int a, int b, int c, "
                   "int *out) { out[0] = a + b + c; return 0; }\n")
    lib = _build._lib_path("flash_decode")
    lib.unlink()
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    ct.mark_warm()
    fn = _build.kernel("tony_flash_decode_geometry")
    import ctypes

    out = (ctypes.c_int * 4)()
    assert fn(1, 2, 3, out) == 0 and out[0] == 6
    _build.kernel("tony_flash_decode_geometry")
    snap = ct.snapshot()
    assert snap["kernel_builds"] == 1 and snap["kernel_nvcc_builds"] == 0
    assert snap["kernel_builds_post_warm"] == 1
    assert _build.noted() == ["flash_decode"]


# --------------------------------------------------------------------------
# the StepTimer: warm line, records, the memory peak
# --------------------------------------------------------------------------

def test_step_timer_compile_warm_gating_and_records(tmp_path):
    """tests/test_device_time.py:244: a training StepTimer draws the
    warm-up line at its first measured step, serve's turn timer never.
    Records carry the build snapshot under the port's keys and, on the
    CPU, no ``gpu_memory_peak_mb`` (left out, never 0)."""
    from tony_tpu.train.profiling import StepTimer as JStepTimer

    log = tmp_path / "w0.steps.jsonl"
    train = profiling.StepTimer(log, window=2, device="cpu")
    train._compile = fake = _FakeWarm()
    train.tick()
    assert fake.warm == 0
    train.tick()
    assert fake.warm >= 1
    turn = profiling.StepTimer(window=2, compile_warm_on_step=False)
    turn._compile = turn_fake = _FakeWarm()
    for _ in range(3):
        turn.tick()
    assert turn_fake.warm == 0
    (rec,) = [json.loads(ln) for ln in log.read_text().splitlines()]
    for key in ("kernel_builds", "kernel_build_time_s",
                "kernel_builds_post_warm"):
        assert key in rec
    assert "gpu_memory_peak_mb" not in rec
    # the JAX package's record carries the same fields under its names
    jlog = tmp_path / "j.steps.jsonl"
    jt = JStepTimer(jlog, window=2)
    jt.tick()
    jt.tick()
    (jrec,) = [json.loads(ln) for ln in jlog.read_text().splitlines()]
    ours = {k.replace("kernel_builds_post_warm", "xla_recompiles_post_warm")
            .replace("kernel_builds", "xla_compiles")
            .replace("kernel_build_time_s", "xla_compile_time_s")
            for k in rec}
    assert ours == set(jrec)


def test_serve_marks_warm_at_its_first_delivery(monkeypatch):
    """The serve loop's turns never draw the line; its first delivered
    completion does, and /metrics and /stats carry the build families."""
    from tony_tpu_torch.cli import serve

    args = serve.build_argparser().parse_args([
        "--device", "cpu", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--dtype",
        "float32", "--slots", "2", "--max-len", "32", "--block-size", "4",
        "--prefill-chunk", "8"])
    ct = CompileTelemetry()
    monkeypatch.setattr(pobs, "COMPILE_TELEMETRY", ct)
    app = serve.ServeApp(serve.build_server(args))
    assert app.compile_telemetry is ct
    app._turn_timer._compile = ct
    for _ in range(3):
        app._turn_timer.tick()
    assert not ct.snapshot()["warm"]
    app.start()
    try:
        comp = app.generate([1, 2, 3], 4)
        assert len(comp.tokens) == 4
        assert ct.snapshot()["warm"]
        assert app.stats()["compile"] == ct.snapshot()
        text = app.prometheus_metrics()
    finally:
        app.shutdown()
    for line in ("serving_kernel_builds_total 0",
                 "serving_kernel_builds_post_warm_total 0",
                 "serving_kernel_build_seconds_count 0"):
        assert line in text.splitlines(), line


# --------------------------------------------------------------------------
# the on-demand capture: flag file, stubbed profiler, torn flags
# --------------------------------------------------------------------------

@pytest.fixture
def stub_profiler(monkeypatch):
    calls = {"start": [], "stop": 0}

    def _start(log_dir):
        calls["start"].append(str(log_dir))
        Path(log_dir).mkdir(parents=True, exist_ok=True)

    monkeypatch.setattr(profiling, "_start_profiler", _start)
    monkeypatch.setattr(profiling, "_stop_profiler",
                        lambda: calls.__setitem__("stop", calls["stop"] + 1))
    return calls


def test_step_timer_profile_flag_contract(tmp_path, stub_profiler):
    """tests/test_device_time.py:291: the executor's relay writes the
    flag, the StepTimer takes it at a record, captures for the window and
    deletes it; a window outliving the loop is stopped by close()."""
    step_log = tmp_path / "logs" / "w0.steps.jsonl"
    step_log.parent.mkdir()
    timer = profiling.StepTimer(step_log, window=2)
    timer.tick()
    timer.tick()
    assert stub_profiler["start"] == []
    flag = write_profile_flag(str(step_log), {"seconds": 0.0})
    assert flag == str(step_log) + c.PROFILE_REQUEST_SUFFIX
    req = json.loads(Path(flag).read_text())
    assert req["seconds"] == 0.0
    assert f"/{c.PROFILE_DIR_NAME}/" in req["out_dir"]
    timer.tick()
    timer.tick()
    assert stub_profiler["start"] == [req["out_dir"]]
    assert not Path(flag).exists(), "a consumed flag is deleted"
    timer.tick()
    assert stub_profiler["stop"] == 1
    assert (tmp_path / "logs" / c.PROFILE_DIR_NAME).is_dir()
    write_profile_flag(str(step_log), {"seconds": 60})
    timer.tick()
    assert len(stub_profiler["start"]) == 2
    timer.close()
    assert stub_profiler["stop"] == 2
    timer.close()                               # idempotent
    assert stub_profiler["stop"] == 2


@pytest.mark.parametrize("body", ['{"seconds": 1.', "[1, 2]",
                                  '{"seconds": "soon"}'],
                         ids=["torn", "not_a_dict", "bad_seconds"])
def test_step_timer_drops_a_bad_profile_flag(tmp_path, stub_profiler, body):
    """A torn, non-dict or non-numeric request never captures, never
    stops training and is cleared so it cannot wedge the next."""
    step_log = tmp_path / "w0.steps.jsonl"
    timer = profiling.StepTimer(step_log, window=2)
    flag = step_log.with_name(step_log.name + c.PROFILE_REQUEST_SUFFIX)
    flag.write_text(body)
    timer.tick()
    timer.tick()
    assert stub_profiler["start"] == []
    assert not flag.exists()
    timer.tick()
    timer.tick()
    assert timer.step == 4


def test_write_profile_flag_requires_step_log():
    assert write_profile_flag(None, {"seconds": 2}) is None
    assert write_profile_flag("", {"seconds": 2}) is None


def test_heartbeater_relays_a_command_and_ignores_true():
    """A dict answer's command reaches on_command once; a plain True is
    no command; a raising callback does not stop the beat."""

    class _Client:
        def __init__(self):
            self.beats = 0

        def call(self, method, **params):
            self.beats += 1
            return {"profile": {"seconds": 2.5}} if self.beats == 2 else True

    got = []

    def on_command(cmd):
        got.append(cmd)
        raise RuntimeError("relay blew up")

    client = _Client()
    hb = Heartbeater(client, "worker:0", interval_s=0.01,
                     on_command=on_command)
    hb.start()
    deadline = time.time() + 5
    while client.beats < 5 and time.time() < deadline:
        time.sleep(0.01)
    hb.stop_event.set()
    hb.join(timeout=5)
    assert client.beats >= 5
    assert got == [{"seconds": 2.5}]


# --------------------------------------------------------------------------
# the driver: the RPC, its ACL, the heartbeat's answer, /profile
# --------------------------------------------------------------------------

def _driver(tmp_path, token):
    from tony_tpu_torch.cluster import Provisioner
    from tony_tpu_torch.driver import Driver

    class _Idle(Provisioner):
        def launch(self, spec, index, env, log_dir):
            raise AssertionError("nothing launches here")

        def stop_container(self, handle):
            pass

        def stop_all(self):
            pass

    conf = TonyConf({"tony.worker.instances": 1,
                     "tony.worker.command": "stub"})
    job = tmp_path / f"job_{bool(token)}"
    job.mkdir()
    return Driver(conf, app_id="profile_test", job_dir=str(job), token=token,
                  provisioner=_Idle())


def test_driver_profile_rpc_acl_heartbeat_and_http_route(tmp_path):
    """tests/test_task_trace.py:329 and :444: with token auth the
    executor key cannot aim the profiler and /profile answers 403; the
    client key queues a command for a running task (False for a NEW one,
    an error out of (0, 120]), a newer request replaces an unread one, and
    it rides one heartbeat answer. Without auth /profile queues it too:
    404 for a task with no container, 400 for a bad window."""
    from tony_tpu_torch.api import TaskStatus
    from tony_tpu_torch.rpc import RpcClient, RpcError
    from tony_tpu_torch.rpc.protocol import derive_role_key

    d = _driver(tmp_path, "s3cret")
    d.rpc_server.start()
    d._start_metrics_server()
    try:
        port = d.rpc_server.port
        exe = RpcClient("127.0.0.1", port, max_retries=1, role="executor",
                        token=derive_role_key("s3cret", "executor"))
        cl = RpcClient("127.0.0.1", port, max_retries=1, role="client",
                       token=derive_role_key("s3cret", "client"))
        with pytest.raises(RpcError, match="authoriz"):
            exe.call("request_task_profile", task_id="worker:0", seconds=1)
        assert cl.call("request_task_profile", task_id="worker:0",
                       seconds=2) is False, "a NEW task has no heartbeat"
        d.session.get_task_by_id("worker:0").status = TaskStatus.RUNNING
        with pytest.raises(RpcError, match="seconds"):
            cl.call("request_task_profile", task_id="worker:0",
                    seconds=9999)
        assert cl.call("request_task_profile", task_id="worker:9",
                       seconds=2) is False
        assert cl.call("request_task_profile", task_id="worker:0",
                       seconds=2) is True
        assert cl.call("request_task_profile", task_id="worker:0",
                       seconds=3) is True
        assert exe.call("heartbeat", task_id="worker:0") == {
            "profile": {"seconds": 3.0}}
        assert exe.call("heartbeat", task_id="worker:0") is True
        url = f"http://127.0.0.1:{d.metrics_port}/profile?task=worker:0"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "&seconds=5", timeout=10)
        assert e.value.code == 403
        exe.close()
        cl.close()
    finally:
        d._metrics_httpd.shutdown()
        d._metrics_httpd.server_close()
        d.rpc_server.stop()

    d = _driver(tmp_path, "")
    d._start_metrics_server()
    try:
        base = f"http://127.0.0.1:{d.metrics_port}/profile?task=worker:0"
        for query, code in (("&seconds=5", 404), ("&seconds=9999", 400),
                            ("&seconds=bogus", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + query, timeout=10)
            assert e.value.code == code, query
        d.session.get_task_by_id("worker:0").status = TaskStatus.RUNNING
        with urllib.request.urlopen(base + "&seconds=4", timeout=10) as r:
            assert json.loads(r.read()) == {"queued": True,
                                            "task": "worker:0"}
        assert d.take_profile_command("worker:0") == {"seconds": 4.0}
        assert d.take_profile_command("worker:0") is None
    finally:
        d._metrics_httpd.shutdown()
        d._metrics_httpd.server_close()
        d.rpc_server.stop()


# --------------------------------------------------------------------------
# a job on the local provisioner: the command rides a heartbeat to a real
# torch.profiler capture in the training child
# --------------------------------------------------------------------------

_CHILD = r"""
import os, sys, time
import torch
from tony_tpu_torch.train.profiling import StepTimer

timer = StepTimer(os.environ["TONY_STEP_LOG"], window=1, device="cpu")
a = torch.randn(64, 64)
started = False
deadline = time.monotonic() + 60
while time.monotonic() < deadline:
    b = torch.mm(a, a).relu_()
    timer.tick(train_step=timer.step)
    time.sleep(0.02)
    if timer._profile_stop_t is not None:
        started = True
    elif started:
        break
timer.close()
print("capture", "done" if started else "never started", flush=True)
sys.exit(0 if started else 3)
"""


def test_profile_command_reaches_a_capture_through_a_local_job(
        tmp_job_dirs, tmp_path):
    """The client's RPC queues a 0.5 s capture once the worker runs; the
    driver sends it on a heartbeat answer, the executor writes the flag
    and the child's StepTimer captures with torch.profiler on the CPU:
    the trace under logs/profiles/ names the step's operators, the flag
    is gone, and the executor's push carries the build counters and no
    device-memory peak."""
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    conf = TonyConf({
        "tony.staging.dir": tmp_job_dirs["staging"],
        "tony.history.location": tmp_job_dirs["history"],
        "tony.history.intermediate": tmp_job_dirs["history"]
        + "/intermediate",
        "tony.history.finished": tmp_job_dirs["history"] + "/finished",
        "tony.am.monitor-interval-ms": 100,
        "tony.task.registration-poll-interval-ms": 100,
        "tony.task.heartbeat-interval-ms": 100,
        "tony.task.metrics-interval-ms": 200,
        "tony.worker.instances": 1,
        "tony.worker.command": f"{sys.executable} {child}",
        "tony.execution.env": f"PYTHONPATH={REPO}",
    })
    client = TonyClient(conf, poll_interval_s=0.1)
    client.submit()
    box = {}
    monitor = threading.Thread(
        target=lambda: box.update(status=client.monitor()))
    monitor.start()
    deadline = time.time() + 60
    queued = False
    while not queued and time.time() < deadline and monitor.is_alive():
        queued = client.request_profile("worker:0", 0.5)
        time.sleep(0.1)
    monitor.join(timeout=120)
    logs = Path(client.job_dir) / "logs"
    assert queued and box.get("status") == JobStatus.SUCCEEDED, \
        (logs / "worker_0.stdout").read_text()[-2000:] + \
        (logs / "worker_0.stderr").read_text()[-2000:]
    assert not (logs / ("worker_0.steps.jsonl"
                        + c.PROFILE_REQUEST_SUFFIX)).exists()
    (trace,) = (logs / c.PROFILE_DIR_NAME).glob("worker_0_*/trace.*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    (jhist,) = (Path(tmp_job_dirs["history"]) / "intermediate"
                / client.app_id).glob("*.jhist")
    pushed = {}
    for ln in jhist.read_text().splitlines():
        e = json.loads(ln)
        if e["type"] == "TASK_FINISHED":
            pushed = {m["name"]: m["value"] for m in e["payload"]["metrics"]}
    assert pushed[f"max_{pmetrics.KERNEL_BUILDS}"] == 0
    assert f"max_{pmetrics.GPU_MEMORY_PEAK}" not in pushed
    assert "profile command relayed" in (logs / "worker_0.stderr").read_text()


def test_task_monitor_pushes_builds_and_the_memory_peak(tmp_path,
                                                        monkeypatch):
    """tests/test_task_trace.py:444's step-log mapping: the newest record's
    build counters are latest totals and its device-memory peak a max,
    both in the push under the JAX package's shape (max_/avg_)."""
    monkeypatch.setenv("PATH", str(tmp_path))       # no nvidia-smi here
    pushes = []

    class Rpc:
        def call(self, method, **kw):
            pushes.append(kw)

    step_log = tmp_path / "steps.jsonl"
    mon = pmetrics.TaskMonitor(Rpc(), "worker:0", interval_s=60)
    mon.set_step_log(str(step_log))
    for builds, peak in ((2, 900.5), (3, 1024.25)):
        with open(step_log, "a") as f:
            f.write(json.dumps({"step": 2, "kernel_builds": builds,
                                "kernel_build_time_s": 0.5 * builds,
                                "kernel_builds_post_warm": builds - 2,
                                "gpu_memory_peak_mb": peak}) + "\n")
        mon.refresh()
    got = {e["name"]: e["value"] for e in pushes[-1]["metrics"]}
    assert got["max_kernel_builds"] == got["avg_kernel_builds"] == 3
    assert got["max_kernel_build_time_s"] == 1.5
    assert got["max_kernel_builds_post_warm"] == 1
    assert got["max_gpu_memory_peak_mb"] == 1024.25
