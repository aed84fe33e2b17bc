"""Multi-process helpers for the port's tests: ``run_ranks`` starts one
process a rank under the TonY env contract (gloo on the CPU, a free
localhost port, a time limit of its own) and collects each rank's result.
Run as a script, this file is one rank: it joins the job through
``tony_tpu_torch.train.init(device="cpu")`` and runs one task. It imports
torch and the port only, never JAX."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, inputs: dict, tmp_path: Path,
              timeout: float = 120.0, env: dict | None = None) -> list:
    """Run ``task`` on ``world`` gloo ranks -> each rank's result (rank
    order). Raises with the ranks' stderr on a failure; kills every rank
    when the time limit passes, so a hang fails instead of stalling."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp_path / "inputs.pt")
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=str(REPO),
                 TONY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 TONY_PROCESS_ID=str(r), TONY_NUM_PROCESSES=str(world),
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, task, str(tmp_path)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{task} on {world} ranks passed {timeout} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{task} rank {r} exited {p.returncode}:\n"
                               f"{errs[r][-4000:]}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def in_background(fn):
    """Run ``fn`` in a thread (a launch of ranks while the caller computes
    its references) -> a callable that joins it and returns its result,
    or raises its error."""
    import threading

    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as e:        # re-raised in the joiner
            box["err"] = e

    th = threading.Thread(target=body)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


# ------------------------------------------------------------------ tasks

def _attention(inp: dict, rank: int, world: int) -> dict:
    """Each case of ``inp["cases"]`` ((kind, causal) with kind "xla",
    "flash" or "ulysses") on this rank's sequence block of q, k, v; the
    output block and the gradients of sum(out * g)."""
    from tony_tpu_torch.parallel import (
        make_ring_attention, make_ulysses_attention, mesh_from_string,
    )

    mesh = mesh_from_string(f"seq={world}", "cpu")
    out = {}
    for kind, causal in inp["cases"]:
        if kind == "ulysses":
            fn = make_ulysses_attention(mesh, causal=causal)
        else:
            fn = make_ring_attention(mesh, causal=causal, impl=kind)
        q, k, v = (x.chunk(world, 1)[rank].clone().requires_grad_(True)
                   for x in (inp["q"], inp["k"], inp["v"]))
        o = fn(q, k, v)
        (o * inp["g"].chunk(world, 1)[rank]).sum().backward()
        out[(kind, causal)] = {"out": o.detach(), "dq": q.grad,
                               "dk": k.grad, "dv": v.grad}
    bad = torch.zeros(1, 2, world + 1, 8)
    try:
        make_ulysses_attention(mesh)(bad, bad, bad)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _train(inp: dict, rank: int, world: int) -> dict:
    """``create_train_step`` on ``inp["mesh"]`` from the converted JAX
    parameters; each step on this rank's block of the global batch."""
    from tony_tpu_torch import train
    from tony_tpu_torch.data import loader_shard_info, seq_shard_info
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.parallel import mesh_from_string

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    bundle = train.create_train_step(cfg, mesh, rules=inp.get("rules"),
                                     params=inp["params"], device="cpu",
                                     sp_impl=inp.get("sp_impl"))
    pi, pc = loader_shard_info(mesh, rank, world, rules=bundle.rules)
    si, sc = seq_shard_info(mesh, rank, rules=bundle.rules)
    params, opt, metrics = bundle.params, bundle.opt_state, []
    for tokens, targets in inp["batches"]:
        seq = tokens.shape[1] // sc
        cols = slice(si * seq, (si + 1) * seq)
        params, opt, m = bundle.step_fn(params, opt, tokens[pi::pc, cols],
                                        targets[pi::pc, cols])
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "rules": bundle.rules, "pc": pc, "sc": sc}


def _restore_step(inp: dict, rank: int, world: int) -> dict:
    """Bundle a steps once on ``inp["mesh"]`` and is checkpointed; bundle b
    (other parameters) restores that state with its own trees as the
    template and is given the restored trees: its eval and next step
    against a's on the same batch, and the restored parameters after the
    step against a's."""
    import torch.distributed as dist

    from tony_tpu_torch import train
    from tony_tpu_torch.data import loader_shard_info
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.parallel import mesh_from_string
    from tony_tpu_torch.train.checkpoint import CheckpointManager

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    a = train.create_train_step(cfg, mesh, device="cpu")
    pi, pc = loader_shard_info(mesh, rank, world, rules=a.rules)
    (t0, y0), (t1, y1) = [(t[pi::pc], y[pi::pc]) for t, y in inp["batches"]]
    pa, oa, _ = a.step_fn(a.params, a.opt_state, t0, y0)
    mgr = CheckpointManager(inp["dir"])
    mgr.save(0, {"params": pa, "opt_state": oa})
    mgr.close()
    dist.barrier()   # rank 0's write is on disk
    b = train.create_train_step(
        cfg, mesh, generator=torch.Generator().manual_seed(5), device="cpu")
    got = CheckpointManager(inp["dir"]).restore(
        template={"params": b.params, "opt_state": b.opt_state})
    evals = (float(a.eval_fn(pa, t1, y1)),
             float(b.eval_fn(got["params"], t1, y1)))
    _, _, ma = a.step_fn(pa, oa, t1, y1)
    _, _, mb = b.step_fn(got["params"], got["opt_state"], t1, y1)
    diff = max(float((x.to_local() - y.to_local()).abs().max())
               for (_, x), (_, y) in zip(train.step._leaves(pa),
                                         train.step._leaves(got["params"])))
    return {"evals": evals, "params_diff": diff,
            "metrics": [(float(m["loss"]), float(m["grad_norm"]))
                        for m in (ma, mb)]}


def _lm_train(inp: dict, rank: int, world: int) -> dict:
    """examples/lm_train.py's main with ``inp["argv"]`` (each rank writes
    its own --metrics-out; rank 0 alone writes one); ``inp["step_log"]``,
    formatted with the rank, is the rank's TONY_STEP_LOG."""
    from tony_tpu_torch.examples import lm_train

    if "step_log" in inp:
        os.environ["TONY_STEP_LOG"] = inp["step_log"].format(rank=rank)
    return {"rc": lm_train.main(inp["argv"])}


def _tp_generate(inp: dict, rank: int, world: int) -> dict:
    """models/generate.py on ``inp["mesh"]`` from the converted parameters:
    each case of ``inp["cases"]`` (name -> generate's keyword arguments,
    "prepared" for weights from prepare_decode on the mesh, "seed" for a
    sampling generator, "continue" for a second turn on the returned
    cache) -> its tokens (and steps). ``inp["rules"]`` replaces
    TP_DECODE_RULES."""
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.models.generate import generate, prepare_decode
    from tony_tpu_torch.parallel import TP_DECODE_RULES, mesh_from_string

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    prep = prepare_decode(inp["params"], cfg, mesh=mesh,
                          rules=inp.get("rules", TP_DECODE_RULES))
    out = {"unfused": prep.fused is None}
    for name in ("wk", "w_in"):
        if name in prep.params["layers"]:
            w = prep.params["layers"][name]
            out[name] = str(w.placements)
            out[name + "_local"] = tuple(w.to_local().shape)
    for name, kw in inp["cases"].items():
        kw = dict(kw)
        params = prep if kw.pop("prepared", False) else inp["params"]
        seed = kw.pop("seed", None)
        if seed is not None:
            kw["generator"] = torch.Generator().manual_seed(seed)
        turn2 = kw.pop("continue", None)
        res = generate(params, cfg, inp["prompt"], kw.pop("n"), mesh=mesh,
                       **kw)
        if turn2 is not None:
            toks, cache = res
            out[name + "_cache"] = tuple(cache.k.shape)
            res = (toks, generate(params, cfg, turn2, kw.get("n2", 4),
                                  mesh=mesh, cache=cache,
                                  return_cache=True)[0])
        out[name] = res
    return out


def _tp_serve(inp: dict, rank: int, world: int) -> dict:
    """SlotServer on ``inp["mesh"]`` for each run of ``inp["runs"]`` (name
    -> {"kw": SlotServer keyword arguments, "raw": pass the converted
    parameters with ``mesh=`` instead of weights from prepare_decode on the
    mesh, "prompts", "budgets"}) through ``run_until_drained`` -> each
    run's tokens in request order, stats and host digest; and the errors of
    the mesh's rejections (``rejections``). ``inp["rules"]`` replaces
    TP_DECODE_RULES."""
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.models.generate import prepare_decode
    from tony_tpu_torch.models.serving import Request, SlotServer
    from tony_tpu_torch.parallel import mesh_from_string

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    prep = prepare_decode(inp["params"], cfg, mesh=mesh,
                          rules=inp.get("rules"))
    out = {"fused": prep.fused}
    for name, run in inp["runs"].items():
        if run.get("raw"):
            srv = SlotServer(inp["params"], cfg, device="cpu", mesh=mesh,
                             rules=inp.get("rules"), **run["kw"])
        else:
            srv = SlotServer(prep, cfg, device="cpu", **run["kw"])
        reqs = [Request(prompt=p, max_new_tokens=b)
                for p, b in zip(run["prompts"], run["budgets"])]
        for r in reqs:
            srv.submit(r)
        done = srv.run_until_drained()
        if srv._paged:
            srv._allocator.check()
        out[name] = {"tokens": [done[r.id].tokens for r in reqs],
                     "stats": srv.stats(), "digest": srv.host_digest()}
    errors = {}
    for name, make in (
            ("slots", lambda: SlotServer(prep, cfg, slots=3, max_len=64,
                                         device="cpu")),
            ("meshless", lambda: SlotServer(prepare_decode(inp["params"],
                                                           cfg),
                                            cfg, slots=4, max_len=64,
                                            device="cpu", mesh=mesh)),
            ("draft", lambda: SlotServer(prep, cfg, slots=4, max_len=64,
                                         device="cpu", draft=inp["params"],
                                         draft_cfg=cfg)),
            ("int8", lambda: SlotServer(inp["params"], cfg, slots=4,
                                        max_len=64, device="cpu", mesh=mesh,
                                        weight_dtype="int8"))):
        try:
            make()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["rejections"] = errors
    return out


def http_requests(url: str, reqs: list) -> list:
    """Each of ``reqs`` ((kind, body): "generate" buffered, "sse" streamed
    on /generate, "v1" on /v1/completions) posted at once, one thread a
    request -> each answer's tokens (the /v1 text's ids), in order."""
    import json
    import threading
    import urllib.request

    out = [None] * len(reqs)

    def post(i, kind, body):
        path = {"generate": "/generate", "sse": "/generate?stream=true",
                "v1": "/v1/completions"}[kind]
        req = urllib.request.Request(url + path,
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                raw = r.read().decode()
        except Exception as e:
            out[i] = f"{type(e).__name__}: {e}"
            return
        if kind == "generate":
            out[i] = json.loads(raw)["tokens"]
        elif kind == "v1":
            out[i] = [int(t) for t in
                      json.loads(raw)["choices"][0]["text"].split()]
        else:
            toks = []
            for line in raw.splitlines():
                if line.startswith("data: ") and '"tokens"' in line:
                    toks += json.loads(line[6:])["tokens"]
            out[i] = toks

    threads = [threading.Thread(target=post, args=(i, k, b))
               for i, (k, b) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def serve_and_ask(argv: list, reqs: list) -> dict:
    """``serve``'s app from ``argv`` on an ephemeral port in this process:
    ``reqs`` answered (``http_requests``), then /stats -> both."""
    import json
    import threading
    import urllib.request

    from tony_tpu_torch.api.openai import TokenCodec
    from tony_tpu_torch.cli import serve

    args = serve.build_argparser().parse_args(argv)
    app = serve.build_app(args)
    if isinstance(app, serve.Follower):
        return {"reason": app.run()}
    app.start()
    httpd = serve.make_httpd(app, "127.0.0.1", 0, TokenCodec(
        args.text_codec, vocab_size=app.server.cfg.vocab_size))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        answers = http_requests(url, reqs)
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        app.shutdown()
        httpd.shutdown()
        httpd.server_close()
    return {"answers": answers, "stats": stats, "status": app.status,
            "error": app.error}


def _serve_mesh(inp: dict, rank: int, world: int) -> dict:
    """``serve --mesh`` on every rank (``inp["argv"]``): rank 0 answers
    ``inp["reqs"]`` over HTTP; the others follow. ``inp["env"]`` [rank]
    sets a rank's environment first (a chaos hook); ``inp["tamper"]``
    makes rank 1's host digest lie. Each rank also reports the sockets its
    Python code bound."""
    import socket

    for k, v in inp.get("env", {}).get(rank, {}).items():
        os.environ[k] = v
    binds = []
    bind = socket.socket.bind

    def counting_bind(self, addr):
        binds.append(addr)
        return bind(self, addr)

    socket.socket.bind = counting_bind
    if rank and inp.get("tamper"):
        from tony_tpu_torch.models.serving import SlotServer

        real = SlotServer.host_digest
        SlotServer.host_digest = lambda self: dict(real(self), queued=-1)
    try:
        out = serve_and_ask(inp["argv"], inp["reqs"])
    except Exception as e:
        out = {"raised": f"{type(e).__name__}: {e}"}
    out["binds"] = len(binds)
    return out


def shed_under_deadlines(argv: list, prompts: list) -> dict:
    """``serve``'s app from ``argv`` (with ``--max-queue 4``) fed before
    its loop starts: request 0 already past its queue deadline, 1 and 2
    interactive, 3 of the batch tier. The batch tier's limit (2) is full,
    so 3's submit sweeps 0 out as expired and is shed all the same. Then
    the loop serves 1 and 2, and request 4 after them -> each request's
    outcome (tokens, or the error's name), the app's status and the
    engine's host digest at the end. On a mesh's other ranks: the
    follower's reason and digest."""
    from tony_tpu_torch.cli import serve

    args = serve.build_argparser().parse_args(argv)
    app = serve.build_app(args)
    if isinstance(app, serve.Follower):
        reason = app.run()
        return {"reason": reason, "digest": app.server.host_digest()}
    out, waits = [], []
    for i, (timeout, prio) in enumerate(((-1.0, "interactive"),
                                         (60.0, "interactive"),
                                         (60.0, "interactive"),
                                         (60.0, "batch"))):
        try:
            waits.append(app.submit_async(prompts[i], 6, timeout=timeout,
                                          priority=prio))
        except Exception as e:
            out.append(type(e).__name__)
            waits.append(None)
    app.start()
    try:
        waits.append(app.submit_async(prompts[4], 6))
        for w in waits:
            if w is None:
                continue
            rid, ev = w
            assert ev.wait(60), f"request {rid} was not answered"
            try:
                out.append(app.take_result(rid).tokens)
            except Exception as e:
                out.append(type(e).__name__)
    finally:
        app.shutdown()
    return {"outcomes": out, "status": app.status, "error": app.error,
            "shed": app.server.shed_requests,
            "expired": app.server.expired_requests,
            "digest": app.server.host_digest()}


def _serve_mesh_shed(inp: dict, rank: int, world: int) -> dict:
    return shed_under_deadlines(inp["argv"], inp["prompts"])


def _lm_generate(inp: dict, rank: int, world: int) -> dict:
    """examples/lm_generate.py's main with ``inp["argv"]`` on every rank."""
    from tony_tpu_torch.examples import lm_generate

    return {"rc": lm_generate.main(inp["argv"])}


def _stack_fn(stack, x):
    """The schedule tests' stage: tanh(x @ w + b) over the stage's run of
    layers, with sum(y * y) as each layer's aux."""
    aux = torch.zeros(())
    for i in range(stack["w"].shape[0]):
        x = torch.tanh(x @ stack["w"][i] + stack["b"][i])
        aux = aux + (x * x).sum()
    return x, aux


def _pipeline_fns(inp: dict, rank: int, world: int) -> dict:
    """parallel/pipeline.py's schedules on this rank's block: GPipe on
    ``pipe=4`` and ``pipe=1``, circular at each M of ``inp["circular"]``
    (the whole stack in; its gradient's sum over ranks is the stack's),
    1F1B's loss and gradients."""
    from tony_tpu_torch.parallel import (
        make_pipeline, make_pipeline_1f1b, make_pipeline_circular,
        mesh_from_string,
    )

    mesh4 = mesh_from_string("pipe=4", "cpu")
    g = inp["gpipe"]
    out = {"gpipe": make_pipeline(
        mesh4, lambda p, x: torch.tanh(x @ p["w"] + p["b"]), 4)(
        {k: v[rank:rank + 1] for k, v in g["stacked"].items()}, g["batch"])}
    mesh1 = mesh_from_string("pipe=1,data=4", "cpu")
    out["single"] = make_pipeline(mesh1, lambda p, x: x * p["s"], 2)(
        {"s": torch.full((1,), 3.0)}, torch.ones(4, 2))
    for m, c in inp["circular"].items():
        stacked = {k: v.clone().requires_grad_(True)
                   for k, v in c["stacked"].items()}
        fn = make_pipeline_circular(mesh4, lambda p, x: _stack_fn(p, x)[0],
                                    m, 2)
        y = fn(stacked, c["batch"])
        (y ** 2).sum().backward()
        out[f"circular{m}"] = {"out": y.detach(),
                               "grads": {k: v.grad for k, v in
                                         stacked.items()}}
    f = inp["1f1b"]
    fn = make_pipeline_1f1b(
        mesh4, _stack_fn, lambda hp, y, t: ((y @ hp["wo"] - t) ** 2).mean(),
        8, aux_weight=f["aux_w"])
    loss, ds, dh, dx = fn({k: v[rank:rank + 1] for k, v in
                           f["stacked"].items()}, f["hp"], f["batch"],
                          f["targets"])
    out["1f1b"] = {"loss": float(loss), "ds": ds, "dh": dh, "dx": dx}
    return out


def _pipeline_step(inp: dict, rank: int, world: int) -> dict:
    """train/pipeline_step.py on each case of ``inp["cases"]`` (name ->
    mesh, cfg fields, schedule, chunks, M, steps): the bundle's loss before
    any step, each step's loss and grad norm, and this rank's parameters
    after the first step."""
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.parallel import mesh_from_string
    from tony_tpu_torch.train.pipeline_step import create_pipeline_train_step

    out = {}
    for name, c in inp["cases"].items():
        cfg = config_from_fields(c["cfg"])
        mesh = mesh_from_string(c["mesh"], "cpu")
        bundle = create_pipeline_train_step(
            cfg, mesh, c["m"], schedule=c["schedule"],
            num_chunks=c.get("chunks", 2), device="cpu",
            params=c["params"])
        tokens, targets = c["tokens"], c["targets"]
        res = {"loss": float(bundle.loss_fn(bundle.params, tokens, targets)),
               "metrics": []}
        params, opt = bundle.params, bundle.opt_state
        for i in range(c["steps"]):
            params, opt, m = bundle.step_fn(params, opt, tokens, targets)
            res["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                res["params"] = {k: (v.clone() if not isinstance(v, dict)
                                     else {n: w.clone()
                                           for n, w in v.items()})
                                 for k, v in params.items()}
        out[name] = res
    return out


def _moe_ffn(inp: dict, rank: int, world: int) -> dict:
    """parallel/expert.py's moe_ffn with the experts over ``inp["mesh"]``'s
    ``expert`` axis: this rank's experts, every token."""
    from tony_tpu_torch.parallel import EP_RULES, mesh_from_string
    from tony_tpu_torch.parallel.expert import moe_ffn
    from tony_tpu_torch.parallel.spmd import Plan

    mesh = mesh_from_string(inp["mesh"], "cpu")
    plan = Plan(mesh, EP_RULES)
    ep = plan.shape["expert"]
    e = inp["w_in"].shape[0] // ep
    lo = plan.ep_rank * e
    out = moe_ffn(inp["x"], inp["router"], inp["w_in"][lo:lo + e],
                  inp["w_out"][lo:lo + e], k=2, capacity_factor=4.0,
                  plan=plan, shape=(1, inp["x"].shape[0]))
    return {"out": out, "experts": e}


def _multi(inp: dict, rank: int, world: int) -> dict:
    """Several tasks in one launch: ``inp["tasks"]`` name -> (task, its
    inputs)."""
    return {name: TASKS[task](sub, rank, world)
            for name, (task, sub) in inp["tasks"].items()}


TASKS = {"attention": _attention, "train": _train,
         "restore_step": _restore_step, "lm_train": _lm_train,
         "tp_generate": _tp_generate, "tp_serve": _tp_serve,
         "serve_mesh": _serve_mesh, "serve_mesh_shed": _serve_mesh_shed,
         "lm_generate": _lm_generate, "pipeline_fns": _pipeline_fns,
         "pipeline_step": _pipeline_step, "moe_ffn": _moe_ffn,
         "multi": _multi}


def main() -> int:
    import warnings

    from tony_tpu_torch import train

    warnings.simplefilter("ignore", FutureWarning)
    task, where = sys.argv[1], Path(sys.argv[2])
    info = train.init(device="cpu", timeout_s=60)
    rank, world = info["process_id"], info["num_processes"]
    inp = torch.load(where / "inputs.pt", weights_only=False)
    out = TASKS[task](inp, rank, world)
    torch.save(out, where / f"rank{rank}.pt")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
