"""Batched serving driver: prefill by decode, then greedy generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke --batch 4 --prompt-len 32 --gen 32 --device cpu

Counterpart of ``repro/launch/serve.py``, with its flags and defaults
and ``--device`` (the card unless ``cpu``): random weights from
``--seed``, a random prompt from ``numpy``'s ``RandomState(seed)``, the
KV cache filled by one decode step per prompt token (as the reference
does; ``make_prefill`` is the separate full-forward entry), then
``--gen`` timed greedy steps, and the reference's print line.  On the
card a dense model's step runs the decode-attention kernel in every
layer; an SSM model's step (``--arch falcon-mamba-7b``) runs no
hand-written kernel, as the reference's ``ssm_block_step`` is plain
jnp.  As the reference's CLI, the embeddings frontend (``--arch
qwen2-vl-2b``) feeds every step ``embeds`` of zeros ``[B, 1, d]``
(bf16), and the enc-dec family (``--arch whisper-large-v3``) serves
from the cross K/V of a zero encoder output (``init_cache`` without
``enc_out``); ``generate`` also takes real embeds or encoder states.
The index stays a host int and the tokens stay on the device until the
end, so a step does not wait for the card.  ``--tp`` above 1 (sharded
serving) is a later slice and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.registry import get_api

TP_LATER = ("--tp {tp} is not ported yet: sharded serving belongs to "
            "ROADMAP queue 1, item 11 of the PyTorch port (one process "
            "serves on one card)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def generate(cfg, params, prompt, gen: int, *, device="cuda",
             observe=None, embeds=None, enc_out=None) -> dict:
    """The reference's serve loop: one decode step per prompt token
    (filling the cache), then ``gen`` greedy steps, timed.

    ``params``: the model's ``params()`` tree; ``prompt``: ``[B, P]``
    token ids (numpy or a tensor).  ``observe`` is handed to the step
    (``ServeStep.observe``).  Under the embeddings frontend step ``t`` is
    fed ``embeds[:, t:t + 1]`` (``embeds``: ``[B, P + gen, d]`` on the
    step's device), or zeros ``[B, 1, d]`` (bf16) without it, as the
    reference's CLI; the prompt's tokens are not read then.  An enc-dec
    model's cache takes the cross K/V of ``enc_out`` ``[B, enc_seq, d]``
    (zeros without it).  Returns ``tokens``
    (numpy int32 ``[B, gen]``: the tokens of the timed steps, as the
    reference collects them), ``prompt_s`` and ``gen_s`` (host seconds up
    to a synchronize) and the ``cache``.
    """
    b, plen = prompt.shape
    kv_len = plen + gen
    step = make_serve_step(cfg, kv_len, b, device=device)
    step.observe = observe
    extra = {"enc_out": enc_out} if cfg.enc_dec else {}
    cache = get_api(cfg).init_cache(params, cfg, b, kv_len,
                                    device=step.device, **extra)
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                               device=step.device)
    if cfg.frontend == "embeddings":
        zeros = torch.zeros((b, 1, cfg.d_model), dtype=torch.bfloat16,
                            device=step.device)

        def inputs(tok, t):
            return {"embeds": zeros if embeds is None
                    else embeds[:, t:t + 1], "index": t}
    else:
        def inputs(tok, t):
            return {"tokens": tok, "index": t}

    def sync():
        if step.device.type == "cuda":
            torch.cuda.synchronize(step.device)

    sync()
    t0 = time.perf_counter()
    tok = prompt_t[:, :1]
    for t in range(plen):
        nxt, cache = step(params, cache, inputs(tok, t))
        tok = prompt_t[:, t + 1:t + 2] if t + 1 < plen else nxt[:, None]
    sync()
    t1 = time.perf_counter()
    out = []
    for t in range(plen, kv_len):
        nxt, cache = step(params, cache, inputs(tok, t))
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, 1) if out else torch.empty(
        (b, 0), dtype=torch.int32, device=step.device)
    sync()
    t2 = time.perf_counter()
    return {"tokens": toks.cpu().numpy(), "prompt_s": t1 - t0,
            "gen_s": t2 - t1, "cache": cache}


def run(args) -> dict:
    """Serve as ``args`` say; prints the reference's line and returns
    ``generate``'s result with the prompt and the model."""
    if args.tp != 1:
        raise NotImplementedError(TP_LATER.format(tp=args.tp))
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    b = args.batch
    model = api.init(cfg, seed=args.seed, device=args.device)
    prompt = np.random.RandomState(args.seed).randint(
        0, cfg.vocab, size=(b, args.prompt_len))
    res = generate(cfg, model.params(), prompt, args.gen,
                   device=args.device)
    toks, dt = res["tokens"], res["gen_s"]
    print(f"generated {toks.shape} tokens; "
          f"{b * args.gen / max(dt, 1e-9):.1f} tok/s; "
          f"sample row: {toks[0][:16]}", flush=True)
    return {**res, "prompt": prompt, "model": model}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
