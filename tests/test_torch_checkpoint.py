"""Port parity: checkpoints (tony_tpu_torch.train.checkpoint, lm_train's
resume and drain, lm_generate's and serve's ``--checkpoint-dir``,
``convert.from_jax_opt_state``) against the JAX package on the CPU.

- The same sequences of saves leave the same step directories under the
  port's manager as under the JAX package's orbax one, so both resume at
  the same ``latest_step() + 1``.
- A save and restore round trip is bit-equal; a resumed float32 run
  repeats the uninterrupted run's losses digit for digit (the JAX
  package's exact-stream contract, tests/test_e2e_local.py:900).
- A JAX lm_train checkpoint carried into the port takes one step that
  matches one JAX step from the same state, at the tolerances of
  tests/test_torch_train.py's ``test_one_train_step_matches_jax``."""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from tony_tpu.utils.prestage import prestage_checkpoint
from tony_tpu_torch import train as ptrain
from tony_tpu_torch.cli import serve
from tony_tpu_torch.examples import lm_generate, lm_train
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.convert import (
    config_from_fields, from_jax_opt_state, from_jax_params,
)
from tony_tpu_torch.train import checkpoint as C
from tony_tpu_torch.train.step import _leaves

DIMS = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4", "--d-ff",
        "64", "--vocab", "64", "--dtype", "float32"]
TRAIN = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16"] + DIMS


def _tree_equal(a, b):
    """Same structure, same leaf types, tensors equal bit for bit."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_roundtrip_is_bit_equal(tmp_path):
    """float32 and bf16 leaves and a Python int survive save and restore
    bit for bit (tests/test_models.py:188), with and without a template;
    the template puts each leaf on its dtype, and a misshapen or missing
    leaf raises naming it."""
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, d_ff=64)
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"params": params,
             "half": {"w": params["embed"].to(torch.bfloat16)},
             "count": 7, "lr": 0.5, "pair": (torch.arange(3), 2)}
    mgr = C.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None and mgr.restore() is None
    assert mgr.save(0, state) is True
    mgr.wait()
    assert mgr.latest_step() == 0 == mgr.last_saved_step
    _tree_equal(mgr.restore(), state)
    _tree_equal(mgr.restore(template=state), state)
    # the template's dtype wins
    as_f32 = mgr.restore(template={**state, "half": {
        "w": torch.zeros(64, 32)}})
    assert as_f32["half"]["w"].dtype == torch.float32
    assert torch.equal(as_f32["half"]["w"],
                       state["half"]["w"].float())
    bad = {**state, "params": {**params, "embed": torch.zeros(3, 3)}}
    with pytest.raises(ValueError, match="params.embed: shape"):
        mgr.restore(template=bad)
    with pytest.raises(ValueError, match="keys at the root"):
        mgr.restore(template={"params": params})
    with pytest.raises(TypeError, match="cannot checkpoint"):
        mgr.save(1, {"x": object()})
    assert mgr.saves[0]["bytes"] == (tmp_path / "ck" / "0" /
                                     C.STATE_FILE).stat().st_size
    mgr.close()


def test_save_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """save_async returns after the host snapshot; an in-place update of
    the saved tensors right after it (AdamW's) must not reach the file:
    the writer is held until the update is done, so a snapshot that
    aliased the live tensors (``Tensor.cpu()`` of a CPU tensor) would
    save the updated values. Also the JAX package's overlapped-save
    contract (tests/test_elastic.py:710): the newest step wins and
    restore round-trips."""
    updated = threading.Event()
    real_save = torch.save

    def held_save(obj, f):
        assert updated.wait(30)
        real_save(obj, f)

    monkeypatch.setattr(C.torch, "save", held_save)
    mgr = C.CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    assert mgr.last_saved_step is None
    w = torch.arange(4.0)
    n = torch.tensor(1.0)
    assert mgr.save_async(2, {"w": w, "n": n}) is True
    w.add_(100.0)                   # the next step's in-place update
    n.mul_(9.0)
    updated.set()
    mgr.save_async(4, {"w": w * 3, "n": n})
    mgr.wait()
    assert mgr.last_saved_step == 4 == mgr.latest_step()
    first = mgr.restore(step=2)
    assert torch.equal(first["w"], torch.arange(4.0))
    assert float(first["n"]) == 1.0
    last = mgr.restore(template={"w": torch.zeros(4), "n": torch.zeros(())})
    assert float(last["n"]) == 9.0 and float(last["w"][2]) == 306.0
    mgr.close()


def test_writer_error_is_raised_by_the_next_call(tmp_path, monkeypatch):
    def failing_save(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(C.torch, "save", failing_save)
    mgr = C.CheckpointManager(str(tmp_path / "ck"))
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # raised once
    assert mgr.last_saved_step is None
    assert not [p for p in (tmp_path / "ck").iterdir() if p.name.isdigit()]
    mgr.close()


# (save calls per manager opened on the directory, save_interval,
# max_to_keep): the JAX package's orbax manager decides which are kept
SEQUENCES = {
    "fresh_off_interval_first": ([[5, 7, 10, 12]], 5, 3),
    "fresh_first_save_kept": ([[7, 9, 10, 11]], 5, 3),
    "reopened_non_empty": ([[3], [4, 5, 8, 10]], 5, 3),
    "drain_off_interval": ([[5, 10], [13]], 5, 3),
    "duplicate_and_lower_steps": ([[5, 5, 10, 10, 5, 15]], 5, 3),
    "max_to_keep": ([[1, 2, 3, 4, 5, 6]], 1, 3),
    "max_to_keep_two_reopened": ([[0, 5], [10, 15, 20]], 5, 2),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_keep_rules_match_the_jax_manager(tmp_path, name):
    seqs, interval, keep = SEQUENCES[name]
    out = {}
    for side, cls, make in (
            ("jax", JCheckpointManager,
             lambda s: {"w": jnp.full((3,), float(s))}),
            ("port", C.CheckpointManager,
             lambda s: {"w": torch.full((3,), float(s))})):
        d = tmp_path / side
        latest = []
        for seq in seqs:
            mgr = cls(str(d), max_to_keep=keep, save_interval=interval)
            for step in seq:
                mgr.save_async(step, make(step))
            mgr.wait()
            latest.append((mgr.latest_step(), mgr.last_saved_step))
            mgr.close()
        steps = sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())
        out[side] = (steps, latest)
    assert out["port"] == out["jax"]
    # the values are the saved step's
    mgr = C.CheckpointManager(str(tmp_path / "port"))
    assert float(mgr.restore()["w"][0]) == out["port"][0][-1]


def test_torn_save_is_skipped_by_latest_step_and_prestage(tmp_path):
    """A leftover ``<step>.tmp-<pid>`` (a save killed mid-write) is
    invisible to latest_step and to the JAX package's prestage walk,
    which stages the port's newest complete step."""
    d = tmp_path / "ck"
    mgr = C.CheckpointManager(str(d), save_interval=5)
    mgr.save(10, {"w": torch.ones(8)})
    mgr.close()
    torn = d / "15.tmp-4242"
    torn.mkdir()
    (torn / C.STATE_FILE).write_bytes(b"half a file")
    mgr = C.CheckpointManager(str(d), save_interval=5)
    assert mgr.latest_step() == 10
    staged = prestage_checkpoint(str(d))
    assert staged == {"step": 10, "files": 1, "bytes": (
        d / "10" / C.STATE_FILE).stat().st_size}
    # a new save of the torn step replaces the leftover
    assert mgr.save(15, {"w": torch.zeros(8)})
    assert not torn.exists() and mgr.latest_step() == 15
    mgr.close()


def _losses(argv):
    out = argv[argv.index("--metrics-out") + 1]
    assert lm_train.main(argv) == 0
    with open(out) as f:
        return json.load(f)["losses"]


@pytest.mark.parametrize("data", [False, True], ids=["synthetic", "data"])
def test_resumed_run_repeats_the_uninterrupted_losses(tmp_path, data):
    """2k steps straight against k steps, then k resumed steps from the
    checkpoint: the same losses digit for digit (float32 on the CPU), on
    synthetic batches and on --data (the loader's start_step)."""
    extra = []
    if data:
        from tony_tpu_torch.data import write_tokens

        path = tmp_path / "toks.bin"
        write_tokens(path, np.random.default_rng(3).integers(0, 64, 3000))
        extra = ["--data", str(path)]
    m = str(tmp_path / "m.json")
    k = 3
    straight = _losses(TRAIN + extra + ["--steps", str(2 * k),
                                        "--metrics-out", m])
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
          str(k)]
    first = _losses(TRAIN + extra + ck + ["--steps", str(k),
                                          "--metrics-out", m])
    resumed = _losses(TRAIN + extra + ck + ["--steps", str(k),
                                            "--metrics-out", m])
    assert first == straight[:k]
    assert resumed == straight[k:]
    # kept: step k-1 (the fresh directory's first save) and step k (on the
    # interval); the final save at 2k-1 is off the interval and dropped
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        [str(k - 1), str(k)]


def _jax_lm_train_saves(start, steps, drain, every):
    """The save calls the JAX package's lm_train makes for one run of
    ``range(start, start + steps)``, drained at ``drain`` (None: runs to
    its end), as its code reads."""
    calls = []
    for step in range(start, start + steps):
        if drain is not None and step == drain:
            return calls + [step]
        if step % every == 0 and step > 0:
            calls.append(step)
    return calls + [start + steps - 1]


def test_lm_train_drain_checkpoints_like_the_jax_lm_train(tmp_path,
                                                          monkeypatch):
    """The .preempt flag drains at the next step boundary: the port's
    lm_train saves there and exits EXIT_PREEMPTED, and the relaunch
    resumes at latest_step() + 1. After each run the step directories are
    those the JAX package's lm_train leaves for the same save calls (its
    manager under the same keep rules): a drain on the interval is kept,
    one off it is dropped and recomputed."""
    from tony_tpu_torch.constants import EXIT_PREEMPTED

    log = tmp_path / "steps.jsonl"
    flag = tmp_path / "steps.jsonl.preempt"
    monkeypatch.setenv("TONY_STEP_LOG", str(log))
    ck = tmp_path / "ck"
    ref = tmp_path / "ref"
    argv = TRAIN + ["--checkpoint-dir", str(ck), "--checkpoint-every", "2"]
    # (steps, flag dropped?, start step, drain step, next start step)
    runs = [(2, False, 0, None, 2), (3, True, 2, 2, 3), (3, True, 3, 3, 3),
            (2, False, 3, None, 5)]
    for steps, drop, start, drain, next_start in runs:
        if drop:
            flag.write_text("{}")
        rc = lm_train.main(argv + ["--steps", str(steps)])
        assert rc == (EXIT_PREEMPTED if drop else 0)
        assert not flag.exists()
        jmgr = JCheckpointManager(str(ref), save_interval=2)
        for step in _jax_lm_train_saves(start, steps, drain, 2):
            jmgr.save_async(step, {"w": jnp.zeros(2)})
        jmgr.wait()
        jmgr.close()
        got = sorted(int(p.name) for p in ck.iterdir())
        want = sorted(int(p.name) for p in ref.iterdir() if p.name.isdigit())
        assert got == want, (steps, drop)
        assert C.CheckpointManager(str(ck)).latest_step() + 1 == next_start
    assert got == [1, 2, 4]


def test_jax_checkpoint_carries_into_the_port(tmp_path):
    """A JAX lm_train checkpoint (orbax), restored here and carried over
    by from_jax_params and from_jax_opt_state, takes one port step that
    matches one JAX step from the same state: loss within 1e-4, grad norm
    within 1e-5 relative, the moments as in test_one_train_step_matches_jax,
    and the same count."""
    from tony_tpu.examples import lm_train as jlm_train
    from tony_tpu.parallel.mesh import single_device_mesh
    from tony_tpu.train import create_train_step as jax_create

    d = tmp_path / "jax_ck"
    # the test process's JAX has 8 CPU devices: the job's mesh spans them
    assert jlm_train.main(["--steps", "2", "--checkpoint-dir", str(d),
                           "--checkpoint-every", "1", "--batch-size", "8",
                           "--seq-len", "16", "--mesh", "fsdp=-1"]
                          + DIMS) == 0
    # lm_train's config for these flags
    jcfg = jT.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=4, n_kv_heads=4, d_ff=64,
                                max_seq_len=16, dtype=jnp.float32)
    jb = jax_create(jcfg, single_device_mesh())
    jmgr = JCheckpointManager(str(d))
    assert jmgr.latest_step() == 1
    template = {"params": jb.params, "opt_state": jb.opt_state}
    restored = jax.device_put(jmgr.restore(template=template),
                              jax.tree.map(lambda x: x.sharding, template))
    jmgr.close()
    host = jax.device_get(restored)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    bundle = ptrain.create_train_step(
        cfg, device="cpu", params=from_jax_params(host["params"], cfg, "cpu"))
    bundle.opt_state.update(from_jax_opt_state(host["opt_state"], cfg, "cpu"))
    assert bundle.opt_state["count"] == 2
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (2, 16), dtype=np.int32)
    targets = rng.integers(0, 64, (2, 16), dtype=np.int32)
    _, jopt, jm = jb.step_fn(restored["params"], restored["opt_state"],
                             jnp.asarray(tokens), jnp.asarray(targets))
    _, opt, m = bundle.step_fn(bundle.params, bundle.opt_state,
                               torch.from_numpy(tokens).long(),
                               torch.from_numpy(targets).long())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    jadam = from_jax_opt_state(jax.device_get(jopt), cfg, "cpu")
    assert opt["count"] == jadam["count"] == 3
    for key, atol in (("mu", 1e-6), ("nu", 1e-8)):
        want = dict(_leaves(jadam[key]))
        for name, x in _leaves(opt[key]):
            np.testing.assert_allclose(x.numpy(), want[name].numpy(),
                                       atol=atol, err_msg=name)
    with pytest.raises(ValueError, match="optax chain"):
        from_jax_opt_state(host["opt_state"][1], cfg, "cpu")


def test_generate_and_serve_restore_the_trained_weights(tmp_path):
    """lm_generate --checkpoint-dir and serve --checkpoint-dir decode the
    greedy tokens of generate on the checkpoint's parameters (its latest
    step: a trained state whose parameters are then replaced by another
    seed's, so the checkpoint and the random init decode differently); an
    empty directory answers "no checkpoint found"."""
    ck = tmp_path / "ck"
    assert lm_train.main(TRAIN + ["--steps", "3", "--checkpoint-dir",
                                  str(ck), "--checkpoint-every", "2"]) == 0
    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=4, d_ff=64,
                              dtype=torch.float32)
    mgr = C.CheckpointManager(str(ck), save_interval=2)
    saved = mgr.restore()
    assert saved["opt_state"]["count"] == 3 and mgr.latest_step() == 2
    saved["params"] = T.init(cfg, torch.Generator().manual_seed(5), "cpu")
    assert mgr.save(4, saved)
    mgr.close()
    prompt = [1, 2, 3, 4, 5]
    want = G.generate(saved["params"], cfg, torch.tensor([prompt]),
                      6)[0].tolist()
    random_init = G.generate(T.init(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), cfg, torch.tensor([prompt]),
                             6)[0].tolist()
    assert want != random_init
    out = tmp_path / "gen.json"
    assert lm_generate.main(["--device", "cpu", "--checkpoint-dir", str(ck),
                             "--prompt", "1 2 3 4 5", "--max-new", "6",
                             "--metrics-out", str(out)] + DIMS) == 0
    assert json.loads(out.read_text())["tokens"] == want
    args = serve.build_argparser().parse_args(
        ["--device", "cpu", "--checkpoint-dir", str(ck), "--slots", "2",
         "--max-len", "32", "--block-size", "4", "--prefill-chunk", "8"]
        + DIMS)
    app = serve.build_app(args)
    app.start()
    try:
        assert app.generate(prompt, 6, timeout=60).tokens == want
    finally:
        app.shutdown()
    empty = tmp_path / "empty"
    with pytest.raises(SystemExit, match="no checkpoint found"):
        lm_generate.main(["--device", "cpu", "--checkpoint-dir", str(empty)]
                         + DIMS)
    args.checkpoint_dir = str(empty)
    with pytest.raises(SystemExit, match="no checkpoint found"):
        serve.build_app(args)


def test_step_timer_carries_checkpoint_recency(tmp_path):
    from tony_tpu_torch.train.profiling import StepTimer

    log = tmp_path / "steps.jsonl"
    timer = StepTimer(log, window=1)
    timer.tick()
    timer.tick(train_step=0)
    timer.note_checkpoint(0)
    timer.tick(train_step=1)
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert "last_ckpt_step" not in recs[0]
    assert recs[1]["last_ckpt_step"] == 0
    assert recs[1]["last_ckpt_ts"] <= recs[1]["ts"]
