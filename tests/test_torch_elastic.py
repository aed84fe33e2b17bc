"""Port parity: the elastic-training drill (tony_tpu_torch.examples.
elastic_train) against the JAX package's (tony_tpu.examples.elastic_train)
on the CPU, each drill in its own process as an executor runs it.

The drill's contract (the JAX package's docstring): a preemption notice
(the ``$TONY_STEP_LOG.preempt`` flag, or SIGTERM) checkpoints at the next
step boundary and exits EXIT_PREEMPTED; the relaunch resumes at
``latest_step() + 1``; the per-step JSONL has no gap, and at most
``--save-interval`` steps are computed twice. The update is deterministic,
so the final ``w[0]`` proves continuity; the two frameworks' float32 sin
and multiply-add agree to 1e-6 over the run."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tony_tpu_torch.constants import EXIT_PREEMPTED

REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--steps", "24", "--save-interval", "5", "--dim", "8"]


def _launch(module, ckpt, log, extra_env=None, steps_flags=FLAGS):
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "TONY_STEP_LOG": str(log), **(extra_env or {})}
    argv = [sys.executable, "-m", module, "--ckpt-dir", str(ckpt),
            *steps_flags]
    if module.startswith("tony_tpu_torch"):
        argv += ["--device", "cpu"]
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _result(out):
    return json.loads(out.strip().splitlines()[-1])


def _train_steps(log):
    return [json.loads(x)["train_step"] for x in log.read_text().splitlines()
            if "train_step" in json.loads(x)]


def _kept(ckpt):
    return sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())


def _drain_then_relaunch(module, tmp):
    """Launch with the .preempt flag dropped before the first step (so its
    boundary drains) -> (the process, its checkpoint dir, its step log)."""
    ckpt, log = tmp / "ckpt", tmp / "steps.jsonl"
    tmp.mkdir()
    Path(str(log) + ".preempt").write_text("{}")
    return _launch(module, ckpt, log), ckpt, log


def test_drain_and_relaunch_matches_the_jax_drill(tmp_path):
    """Both drills drain at the same step (0: the flag is there before the
    first step), keep the same checkpoints, resume at the same step, log
    every step once, and end with the same final_step and final_w0."""
    runs = {}
    for side, module in (("jax", "tony_tpu.examples.elastic_train"),
                         ("port", "tony_tpu_torch.examples.elastic_train")):
        runs[side] = _drain_then_relaunch(module, tmp_path / side)
    out = {}
    for side, (proc, ckpt, log) in runs.items():
        rc, stdout, err = _finish(proc)
        assert rc == EXIT_PREEMPTED, err
        assert "preempted: checkpointed step 0" in stdout
        assert not Path(str(log) + ".preempt").exists()
        kept_after_drain = _kept(ckpt)
        runs[side] = _launch(
            "tony_tpu.examples.elastic_train" if side == "jax"
            else "tony_tpu_torch.examples.elastic_train", ckpt, log)
        out[side] = [kept_after_drain, ckpt, log]
    for side, proc in runs.items():
        rc, stdout, err = _finish(proc)
        assert rc == 0, err
        assert "resumed from checkpoint step 0" in stdout
        kept_after_drain, ckpt, log = out[side]
        out[side] = (kept_after_drain, _kept(ckpt), _result(stdout),
                     _train_steps(log))
    jax_run, port_run = out["jax"], out["port"]
    assert port_run[0] == jax_run[0] == [0]
    # the final save at step 23 is off the interval: dropped by both
    assert port_run[1] == jax_run[1] == [10, 15, 20]
    assert port_run[3] == jax_run[3] == list(range(24))
    assert port_run[2]["final_step"] == jax_run[2]["final_step"] == 24
    assert abs(port_run[2]["final_w0"] - jax_run[2]["final_w0"]) <= 1e-6


def test_sigterm_and_sigkill_drills_keep_the_trajectory(tmp_path):
    """A SIGTERM mid-run drains at the next step boundary; a relaunch
    resumes at latest_step() + 1 with no step skipped and at most
    --save-interval steps recomputed. ELASTIC_TRAIN_KILL SIGKILLs the
    first attempt once (ELASTIC_TRAIN_KILL_ONCE), and the relaunch
    recovers from the last kept checkpoint. Both end at the
    uninterrupted run's final_w0, exactly."""
    module = "tony_tpu_torch.examples.elastic_train"
    # the signal lands about step 8; 16 more steps of 50 ms leave the
    # drill running long after it
    slow = {"ELASTIC_TRAIN_STEP_MS": "50"}
    straight = _launch(module, tmp_path / "c0", tmp_path / "s0.jsonl")
    term_log = tmp_path / "s1.jsonl"
    term = _launch(module, tmp_path / "c1", term_log, slow)
    kill_env = {"ELASTIC_TRAIN_KILL": "0:12",
                "ELASTIC_TRAIN_KILL_ONCE": str(tmp_path / "killed"), **slow}
    kill_log = tmp_path / "s2.jsonl"
    kill = _launch(module, tmp_path / "c2", kill_log, kill_env)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if term_log.exists() and any(s >= 8 for s in _train_steps(term_log)):
            break
        time.sleep(0.01)
    term.send_signal(signal.SIGTERM)
    rc, stdout, err = _finish(term)
    assert rc == EXIT_PREEMPTED, err
    drained = int(stdout.split("checkpointed step ")[1].split(",")[0])
    assert 8 <= drained < 24
    rc, _, err = _finish(kill)
    assert rc == -signal.SIGKILL and "SIGKILLing self at step 12" in err
    # a save still in the writer's hands dies with the process
    assert set(_kept(tmp_path / "c2")) <= {5, 10}
    rc, stdout, err = _finish(straight)
    assert rc == 0, err
    want = _result(stdout)
    for ckpt, log, env in ((tmp_path / "c1", term_log, slow),
                           (tmp_path / "c2", kill_log, kill_env)):
        kept = _kept(ckpt)
        rc, stdout, err = _finish(_launch(module, ckpt, log, env))
        assert rc == 0, err
        assert not kept or f"resumed from checkpoint step {kept[-1]}" in \
            stdout
        assert _result(stdout)["final_w0"] == want["final_w0"]
        assert _result(stdout)["final_step"] == 24
        steps = _train_steps(log)
        assert sorted(set(steps)) == list(range(24))
        if kept:                        # at most save_interval recomputed
            assert len(steps) - 24 <= 5


def test_elastic_train_needs_a_card_unless_told_otherwise(tmp_path,
                                                          monkeypatch):
    import torch

    from tony_tpu_torch.examples import elastic_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_train.main(["--ckpt-dir", str(tmp_path / "c")])
