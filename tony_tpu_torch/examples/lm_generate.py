"""Generate with the flagship model on the GPU (port of
the JAX package's examples/lm_generate.py, single-device paths).

    python -m tony_tpu_torch.examples.lm_generate \
        --vocab 32768 --d-model 1024 --n-layers 12 --n-heads 8 --d-ff 4096 \
        --batch 8 --prompt-len 1024 --max-new 64

Weights are random, drawn from ``--seed`` through a ``torch.Generator``,
restored from an lm_train checkpoint (``--checkpoint-dir``: its latest
step's ``params``; the optimizer state is dropped), or imported from a
HuggingFace Llama or Mistral checkpoint directory (``--hf-checkpoint``,
read without ``transformers``: models/hf_import.py; its config sets the
model's dims and vocabulary). ``--weight-dtype int8`` decodes on int8
weights (w8a16, models/generate.py). A draft model (``--draft-checkpoint-dir``,
an lm_train checkpoint shaped by the ``--draft-*`` flags, or
``--draft-hf-checkpoint``) decodes speculatively: greedy, batch 1, the
same tokens as the plain decode (models/speculative.py); the metrics then
carry the rounds and the acceptance. The default draft dims (d_model 128,
4 heads) give head_dim 32, which the flash kernels take. Prompts are
whitespace-separated token ids (``--prompt``), or ``--batch`` x
``--prompt-len`` random ids from the same seed. Prints the first row's
tokens and the decode throughput; ``--metrics-out`` also gets the prefill
time and the rates as JSON.

Timing: one untimed warm-up run, then the timed full run, then a timed
prefill-only run (``max_new_tokens=1``). So a call launches the flash
forward kernel 3 x n_layers times and the flash-decode kernel
2 x n_layers x (max_new - 1) times (fewer with stop tokens); a
speculative call prefills target and draft (3 x (n_layers +
draft_n_layers) flash forwards) and runs (gamma + 1) draft steps a round
(flash-decode launches: draft_n_layers each).

``--n-experts`` builds (or restores) the Mixture-of-Experts model; it
must match the training run's. With ``--weight-dtype int8`` every expert's
weights decode as int8.

``--tensor-parallel N`` decodes tensor-parallel over a job of N
processes under the TONY_* contract (``train.init``: NCCL on the cards,
gloo with ``--device cpu``), as ``lm_train --mesh`` trains: the mesh is
``fsdp=1,tensor=N`` over the job, a checkpoint is restored into DTensor
templates placed by ``TP_DECODE_RULES`` (each rank keeps its block of
each leaf as it is drawn, so the whole model is never on one card), and
every rank runs generate on its heads (models/generate.py). Rank 0 alone
prints and writes ``--metrics-out``. Under the contract, N = 1 runs the
same path on a one-process group. Without the flag no job is joined.
"""

from __future__ import annotations

import argparse
import json
import time


SPEC_GAMMA = 4          # drafts a round (speculative_generate's default)


def _load_draft(args, dtype, device, gen):
    """The draft model -> (DecodeWeights, cfg): an HF checkpoint (its
    config sets the dims), or an lm_train checkpoint shaped by the
    ``--draft-*`` flags on the target's vocabulary (the draft proposes the
    target's token ids)."""
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.models.generate import prepare_decode

    if args.draft_hf_checkpoint:
        from tony_tpu_torch.models.hf_import import load_hf

        d_params, d_cfg = load_hf(args.draft_hf_checkpoint, dtype, device)
    else:
        from tony_tpu_torch.train.checkpoint import restore_lm_params

        d_cfg = transformer.TransformerConfig(
            vocab_size=args.vocab, d_model=args.draft_d_model,
            n_layers=args.draft_n_layers, n_heads=args.draft_n_heads,
            n_kv_heads=args.draft_n_heads, d_ff=args.draft_d_ff, dtype=dtype)
        d_params = restore_lm_params(args.draft_checkpoint_dir,
                                     transformer.init(d_cfg, gen, device))
    return prepare_decode(d_params, d_cfg), d_cfg


def _tp_mesh(args):
    """``--tensor-parallel``: join the job and build its ``fsdp=1,tensor=N``
    mesh -> (mesh or None, whether this rank reports). ``args.device``
    becomes this rank's device."""
    from tony_tpu_torch import train
    from tony_tpu_torch.parallel import MeshSpec, build_mesh

    info = train.init(device=args.device)
    if info["backend"] is None:
        if args.tensor_parallel > 1:
            raise SystemExit(
                f"--tensor-parallel {args.tensor_parallel} needs a job of as "
                "many processes under the TONY_* env contract "
                "(TONY_COORDINATOR_ADDRESS, TONY_PROCESS_ID, "
                "TONY_NUM_PROCESSES)")
        return None, True
    if info["num_processes"] != args.tensor_parallel:
        raise SystemExit(
            f"--tensor-parallel {args.tensor_parallel} over a job of "
            f"{info['num_processes']} processes: give one process a rank")
    args.device = info["device"]
    mesh = build_mesh(MeshSpec(fsdp=1, tensor=args.tensor_parallel),
                      "cpu" if info["backend"] == "gloo" else "cuda")
    return mesh, info["process_id"] == 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", default="",
                        help="lm_train checkpoint directory; empty = random "
                             "init")
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--vocab", type=int, default=4096)
    parser.add_argument("--n-experts", type=int, default=0,
                        help="must match the training run's --n-experts")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--prompt", default="1 2 3 4 5 6 7 8",
                        help="whitespace-separated token ids")
    parser.add_argument("--batch", type=int, default=1,
                        help="rows; more than 1 needs --prompt-len")
    parser.add_argument("--prompt-len", type=int, default=0,
                        help=">0: random prompts of this length from --seed "
                             "instead of --prompt")
    parser.add_argument("--max-new", type=int, default=64)
    parser.add_argument("--max-len", type=int, default=0,
                        help="cache capacity (0 = prompt + max-new)")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kv-dtype", default="native",
                        choices=("native", "int8"))
    parser.add_argument("--weight-dtype", default="native",
                        choices=("native", "int8"))
    parser.add_argument("--stop-tokens", default="",
                        help="whitespace-separated token ids that end a "
                             "sequence (EOS)")
    parser.add_argument("--pad-id", type=int, default=0)
    parser.add_argument("--tensor-parallel", type=int, default=None,
                        help="N: decode over a job of N processes under "
                             "the TONY_* contract (default: no job, one "
                             "device)")
    parser.add_argument("--hf-checkpoint", default="")
    parser.add_argument("--draft-hf-checkpoint", default="")
    parser.add_argument("--draft-checkpoint-dir", default="")
    parser.add_argument("--draft-d-model", type=int, default=128)
    parser.add_argument("--draft-n-layers", type=int, default=2)
    parser.add_argument("--draft-n-heads", type=int, default=4)
    parser.add_argument("--draft-d-ff", type=int, default=512)
    parser.add_argument("--device", default=None,
                        help="default: the GPU (raises without one)")
    parser.add_argument("--metrics-out", default="")
    args = parser.parse_args(argv)

    if args.hf_checkpoint and args.checkpoint_dir:
        raise SystemExit("--hf-checkpoint and --checkpoint-dir are exclusive")
    if args.draft_hf_checkpoint and args.draft_checkpoint_dir:
        raise SystemExit("--draft-hf-checkpoint and --draft-checkpoint-dir "
                         "are exclusive")
    speculative = bool(args.draft_hf_checkpoint or args.draft_checkpoint_dir)
    if speculative and (args.temperature > 0
                        or (args.tensor_parallel or 1) > 1):
        raise SystemExit("speculative decode is single-device greedy "
                         "(drop --tensor-parallel / --temperature)")

    import torch

    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.models.convert import torch_dtype
    from tony_tpu_torch.models.generate import generate, prepare_decode

    mesh, chief = ((None, True) if args.tensor_parallel is None
                   or speculative else _tp_mesh(args))
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    hf_load_s = None
    if args.hf_checkpoint:
        from tony_tpu_torch.models.hf_import import load_hf, weight_files

        t0 = time.perf_counter()
        params, cfg = load_hf(args.hf_checkpoint, torch_dtype(args.dtype),
                              device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        hf_load_s = time.perf_counter() - t0
        hf_bytes = sum(f.stat().st_size
                       for f in weight_files(args.hf_checkpoint))
        args.vocab = cfg.vocab_size
        print(f"imported HF checkpoint: {cfg.n_layers}L d{cfg.d_model} "
              f"{cfg.n_heads}h/{cfg.n_kv_heads}kv vocab {cfg.vocab_size} in "
              f"{hf_load_s:.2f} s ({hf_bytes / hf_load_s / 1e9:.2f} GB/s)")
    else:
        cfg = transformer.TransformerConfig(
            vocab_size=args.vocab, d_model=args.d_model,
            n_layers=args.n_layers, n_heads=args.n_heads,
            n_kv_heads=args.n_heads, d_ff=args.d_ff,
            n_experts=args.n_experts, dtype=torch_dtype(args.dtype))
        place = None
        if mesh is not None:
            from tony_tpu_torch.parallel import TP_DECODE_RULES, block_placer

            # each rank keeps its block of each leaf as it is drawn: the
            # templates a checkpoint restores into, or the random init
            place = block_placer(mesh, TP_DECODE_RULES)
        params = transformer.init(cfg, gen, device, place=place)
    if args.checkpoint_dir:
        from tony_tpu_torch.train.checkpoint import restore_lm_params

        params = restore_lm_params(args.checkpoint_dir, params)

    if args.prompt_len > 0:
        prompt = torch.randint(0, args.vocab, (args.batch, args.prompt_len),
                               generator=gen, device=device,
                               dtype=torch.int64)
    else:
        if args.batch != 1:
            raise SystemExit("--batch > 1 needs --prompt-len")
        prompt_ids = [int(t) for t in args.prompt.split()]
        bad = [t for t in prompt_ids if not 0 <= t < args.vocab]
        if bad:
            raise SystemExit(f"prompt ids out of vocab range: {bad}")
        prompt = torch.tensor([prompt_ids], dtype=torch.int64, device=device)
    stop_tokens = tuple(int(t) for t in args.stop_tokens.split())
    prepared = prepare_decode(params, cfg, weight_dtype=args.weight_dtype,
                              mesh=mesh)
    del params
    draft = None
    if speculative:
        draft = _load_draft(args, torch_dtype(args.dtype), device, gen)
        d_cfg = draft[1]
        print(f"speculative draft: {d_cfg.n_layers}L d{d_cfg.d_model} "
              f"{d_cfg.n_heads}h (head_dim {d_cfg.head_dim})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(max_new):
        if draft is not None:
            from tony_tpu_torch.models.speculative import speculative_generate

            out, stats = speculative_generate(
                prepared, cfg, draft[0], draft[1], prompt, max_new,
                kv_dtype=args.kv_dtype, stop_tokens=stop_tokens,
                pad_id=args.pad_id, return_stats=True)
            sync()
            spec_stats.update(stats)
            # rounds = verify forwards; emitted = accepted + rounds (+ 1)
            return out, stats["accepted"] + stats["rounds"]
        sample_gen = torch.Generator(device=device).manual_seed(args.seed)
        out, steps = generate(
            prepared, cfg, prompt, max_new, temperature=args.temperature,
            top_k=args.top_k, generator=sample_gen, kv_dtype=args.kv_dtype,
            max_len=args.max_len or None, stop_tokens=stop_tokens,
            pad_id=args.pad_id, return_steps=True, mesh=mesh)
        sync()
        return out, steps

    spec_stats: dict = {}
    run(args.max_new)                   # warm-up, untimed
    t0 = time.perf_counter()
    out, steps = run(args.max_new)
    wall = time.perf_counter() - t0
    timed_stats = dict(spec_stats)
    t0 = time.perf_counter()
    run(1)                              # prefill only
    prefill_s = time.perf_counter() - t0

    tokens = [int(t) for t in out[0].tolist()]
    if stop_tokens:
        # trim the pad tail (the stop token itself stays)
        for i, t in enumerate(tokens):
            if t in stop_tokens:
                tokens = tokens[:i + 1]
                break
    if draft is not None:
        # rounds can overshoot max_new and draft past a stop: count the
        # tokens delivered
        n_generated = len(tokens)
    else:
        # prefill emitted 1 token + `steps` decode forwards
        n_generated = int(steps) + 1
    decode_s = max(wall - prefill_s, 1e-9)
    result = {
        "tokens": tokens,
        "decode_tokens_per_sec": n_generated / wall,
        "generated_tokens": n_generated,
        "batch": int(prompt.shape[0]),
        "prompt_len": int(prompt.shape[1]),
        "wall_s": wall,
        "prefill_ms": prefill_s * 1e3,
        "decode_steps": int(steps),
        "decode_step_ms": decode_s * 1e3 / max(int(steps), 1),
        "batch_decode_tokens_per_sec": prompt.shape[0] * int(steps) / decode_s,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "kv_dtype": args.kv_dtype,
        "weight_dtype": args.weight_dtype,
        "stop_tokens": list(stop_tokens),
        "hf_load_s": hf_load_s,
        "tensor_parallel": args.tensor_parallel or 1,
    }
    if draft is not None:
        d_cfg = draft[1]
        result["speculative"] = {
            **timed_stats, "gamma": SPEC_GAMMA,
            "target_forwards": timed_stats["rounds"] + 1,
            "draft": {"d_model": d_cfg.d_model, "n_layers": d_cfg.n_layers,
                      "n_heads": d_cfg.n_heads, "d_ff": d_cfg.d_ff,
                      "head_dim": d_cfg.head_dim}}
    if not chief:
        return 0
    print(" ".join(str(t) for t in tokens))
    print(f"# {n_generated} tokens in {wall:.2f}s "
          f"({result['decode_tokens_per_sec']:.1f} tok/s), prefill "
          f"{result['prefill_ms']:.1f} ms")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
