"""Jobs that run the port, launched by the port's own client, driver and
executors on the CPU (gloo, ``--device cpu``, TINY shapes): lm_train as two
workers against the same run started by hand under the env contract, to the
bit; examples/mnist.py as two workers against one process on the whole
batch; a serve replica as a serving role, discovered through the port's
driver and held behind the JAX package's FleetRouter; and a CUDA worker
with no card, which fails its job."""

import json
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from tony_tpu.router import DriverDiscovery, FleetRouter
from tony_tpu_torch.api import JobStatus
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.cluster.provisioner import _pid_alive
from tony_tpu_torch.conf import TonyConf

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_worker import run_ranks  # noqa: E402

PY = sys.executable
TINY = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--d-ff", "128", "--vocab", "256",
        "--dtype", "float32"]


def job(dirs, **extra) -> TonyClient:
    return TonyClient(TonyConf({
        "tony.staging.dir": dirs["staging"],
        "tony.history.intermediate": dirs["history"] + "/intermediate",
        "tony.am.monitor-interval-ms": 100,
        "tony.task.registration-poll-interval-ms": 100,
        # one intra-op thread, as tests/torch_dist_worker.py's ranks
        "tony.execution.env": "OMP_NUM_THREADS=1,PYTHONUNBUFFERED=1",
        **extra,
    }), poll_interval_s=0.1)


def run(client: TonyClient) -> JobStatus:
    client.submit()
    status = client.monitor()
    if status != JobStatus.SUCCEEDED:
        logs = "\n".join(f"==== {p.name}\n{p.read_text()[-3000:]}"
                         for p in sorted(Path(client.job_dir).rglob("*.std*")))
        raise AssertionError(f"job {status}: {logs}")
    return status


def test_lm_train_two_workers_match_the_hand_started_ranks(tmp_job_dirs,
                                                          tmp_path):
    argv = TINY + ["--steps", "3", "--batch-size", "4", "--seq-len", "32",
                   "--mesh", "fsdp=2"]
    launched = tmp_path / "launched.json"
    client = job(tmp_job_dirs, **{
        "tony.worker.instances": 2,
        "tony.worker.command": " ".join(
            [PY, "-m", "tony_tpu_torch.examples.lm_train"] + argv
            + ["--metrics-out", str(launched)])})
    run(client)
    by_hand = tmp_path / "by_hand.json"
    run_ranks("lm_train", 2, {"argv": argv + ["--metrics-out",
                                              str(by_hand)]},
              tmp_path / "ranks")
    got = json.loads(launched.read_text())
    want = json.loads(by_hand.read_text())
    assert got["mesh"]["fsdp"] == 2 and len(got["losses"]) == 3
    assert got["losses"] == want["losses"]
    # both ranks joined the gloo group of two the runtime handed out
    out = (Path(client.job_dir) / "logs" / "worker_0.stdout").read_text()
    assert "process 0/2: gloo on cpu" in out


def test_mnist_two_workers_match_one_process(tmp_job_dirs, tmp_path):
    from tony_tpu_torch.examples import mnist

    argv = ["--device", "cpu", "--steps", "4", "--steps-per-call", "2",
            "--batch-size", "64", "--lr", "1e-4"]
    one = tmp_path / "one.json"
    assert mnist.main(argv + ["--metrics-out", str(one)]) == 0
    two = tmp_path / "two.json"
    client = job(tmp_job_dirs, **{
        "tony.worker.instances": 2,
        "tony.worker.command": " ".join(
            [PY, "-m", "tony_tpu_torch.examples.mnist"] + argv
            + ["--metrics-out", str(two)])})
    run(client)
    a, b = json.loads(one.read_text()), json.loads(two.read_text())
    assert b["process"]["num_processes"] == 2 and b["num_devices"] == 2
    assert b["process"]["backend"] == "gloo"
    assert abs(a["final_loss"] - b["final_loss"]) < 1e-5, (a, b)
    assert a["final_loss"] > 0.1        # still learning: the check has teeth
    assert abs(a["accuracy"] - b["accuracy"]) < 1e-5


def _wait_running(client, n, timeout_s=90) -> list:
    deadline = time.monotonic() + timeout_s
    rpc = client._connect()
    while time.monotonic() < deadline:
        infos = rpc.call("get_task_infos")
        if sum(bool(i["ports"]) for i in infos) >= n:
            return infos
        time.sleep(0.2)
    raise AssertionError(f"no published serve_port in {timeout_s} s: "
                         f"{infos}")


def test_serve_replica_behind_the_jax_fleet_router(tmp_job_dirs):
    """ROADMAP item 2's e2e: a port ``serve`` replica started as a serving
    role (TONY_SERVE_PORT), found by the JAX package's DriverDiscovery over
    the port's RPC, and served through the JAX FleetRouter, which reads the
    replica's /stats."""
    serve = [PY, "-m", "tony_tpu_torch.cli.serve", "--host", "127.0.0.1",
             "--port", "$TONY_SERVE_PORT", "--slots", "2", "--max-len",
             "128", "--block-size", "8", "--prefill-chunk", "16"] + TINY
    client = job(tmp_job_dirs, **{
        "tony.application.framework": "serving",
        "tony.replica.instances": 1,
        "tony.replica.command": " ".join(serve),
        "tony.serving.healthz-interval-ms": 200})
    client.submit()
    router = None
    try:
        (info,) = _wait_running(client, 1)
        port = info["ports"]["serve_port"]
        assert info["port"] == port and info["status"] == "RUNNING"
        discovery = DriverDiscovery(str(client.job_dir), role="replica",
                                    token=client.token)
        assert discovery() == [("replica:0", info["host"], port)]
        router = FleetRouter(discover=discovery, prefill_chunk=16,
                             health_interval_s=0.1, stats_every=1)
        router.health_tick()
        rep = router.replicas["replica:0"]
        assert rep.up and rep.port == port
        # the /stats keys the router reads (router.py:601-618)
        assert (rep.slots, rep.queued, rep.active, rep.role) == \
            (2, 0, 0, "both")
        prompt = [5, 17, 42, 9, 8, 7, 6, 5, 4, 3, 2, 1, 33, 44, 55, 66, 77]
        routed = router.generate(prompt, max_new_tokens=8)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": prompt,
                             "max_new_tokens": 8}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            direct = json.loads(resp.read())
        assert routed["tokens"] == direct["tokens"]
        assert len(routed["tokens"]) == 8 and routed["replica"] == \
            "replica:0"
        journal = [json.loads(ln) for ln in (Path(client.job_dir)
                   / "driver.journal.jsonl").read_text().splitlines()]
        pids = [r["pid"] for r in journal if r["op"] == "launch"]
    finally:
        if router is not None:
            router.shutdown()
        client.stop()
    client._driver_proc.wait(timeout=30)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(map(_pid_alive, pids)):
        time.sleep(0.1)
    assert not [p for p in pids if _pid_alive(p)]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)


def test_cuda_worker_without_a_card_fails_its_job(tmp_job_dirs):
    client = job(tmp_job_dirs, **{
        "tony.worker.instances": 1,
        "tony.worker.command":
            f"{PY} -c 'from tony_tpu_torch import train; train.init()'",
        "tony.worker.env": "CUDA_VISIBLE_DEVICES="})
    client.submit()
    assert client.monitor() == JobStatus.FAILED
    err = (Path(client.job_dir) / "logs" / "worker_0.stderr").read_text()
    assert "a CUDA job needs a card" in err
