"""End-to-end federated LM trainer (the command-line entry point).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 50 --protocol two_phase
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen1.5-0.5b --smoke --steps 10 --device cpu

Counterpart of ``repro/launch/train.py``, with its flags and defaults:
per-party fwd/bwd -> two-phase MPC gradient aggregation -> AdamW, on
the card unless ``--device cpu``.  The parties are the ranks that
``torchrun`` starts (a world of one without it); each rank trains on its
rows of the global batch.  The backend follows the rule of
``launch.mesh.choose_backend`` and is printed.  The reference's
defaults include ``--arch tinyllama-1.1b``, whose fp32 state takes the
MPC-FSDP layout, a later slice: the port raises for it, and runs
qwen1.5-0.5b (and the smoke configs) in the replicated layout.
``--spec`` takes an ``ExperimentSpec`` (``repro_torch.api``) as a JSON
file or inline JSON and sets the protocol, scheme, committee, seed,
compress-topk and chunk-elems from it, as the reference does; the model
and loop flags stay on the command line.  Checkpointing
(``--ckpt-dir``), ``--production-mesh``, ``--tp`` above 1 and
``--compress-topk`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.launch.mesh import init_from_env
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import get_api
from repro_torch.optim import AdamWConfig, adamw_init

CKPT_LATER = ("--ckpt-dir is not ported yet: checkpointing belongs to "
              "ROADMAP queue 1, item 6 of the PyTorch port")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--protocol", default="two_phase",
                    choices=["two_phase", "p2p", "plain"])
    ap.add_argument("--scheme", default="additive",
                    choices=["additive", "shamir"])
    ap.add_argument("--agg-mode", default="psum",
                    choices=["psum", "reduce_scatter"])
    ap.add_argument("--committee", type=int, default=3)
    ap.add_argument("--compress-topk", type=float, default=0.0,
                    help="top-k gradient sparsification ratio (a later "
                         "slice of the port: any value but 0 raises)")
    ap.add_argument("--chunk-elems", type=int, default=0,
                    help="element-chunk cap for the per-leaf secure "
                         "aggregation share stack (0 = whole leaf)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--spec", default="",
                    help="ExperimentSpec JSON (file path or inline JSON): "
                         "sets protocol/scheme/committee/seed/"
                         "compress-topk/chunk-elems from the spec; model "
                         "and training-loop flags stay on the CLI")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def apply_spec(args) -> None:
    """Overwrite the aggregation flags of ``args`` from ``--spec``."""
    import json

    from repro_torch.api import ExperimentSpec
    if args.spec.lstrip().startswith("{"):
        spec = ExperimentSpec.from_json(json.loads(args.spec))
    else:
        with open(args.spec) as fh:
            spec = ExperimentSpec.from_json(json.load(fh))
    args.protocol = spec.protocol
    args.scheme = spec.scheme
    args.committee = spec.m
    args.seed = spec.seed
    args.compress_topk = spec.compress_topk or 0.0
    args.chunk_elems = spec.chunk_elems or 0


def run(args, observe=None) -> dict:
    """Train as ``args`` say.  Returns the losses, each step's host wall
    seconds (up to its loss on the host), the model, the optimizer
    state, the party facts and the step.

    ``observe`` is handed to the step (``TrainStep.observe``).
    """
    if args.ckpt_dir:
        raise NotImplementedError(CKPT_LATER)
    if args.spec:
        apply_spec(args)
    if args.production_mesh or args.tp != 1:
        raise NotImplementedError(
            "the port has no tensor parallelism and no pod mesh: each party "
            "is one process (--tp 1)")
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    step_fn = make_train_step(
        cfg, protocol=args.protocol, scheme=args.scheme, m=args.committee,
        agg_mode=args.agg_mode, seed=args.seed, opt=AdamWConfig(lr=args.lr),
        compress_topk=args.compress_topk or None,
        chunk_elems=args.chunk_elems or None, device=args.device)
    party = init_from_env(step_fn.device)
    step_fn.device = party["device"]
    step_fn.observe = observe
    n_party = step_fn.n_party
    # every party runs this loop; the first one reports
    say = print if party["rank"] == 0 else (lambda *a, **k: None)
    say(f"parties={n_party} backend={party['backend'] or 'none'} "
        f"device={party['device']} arch={cfg.name} "
        f"protocol={args.protocol}", flush=True)

    b, s = args.batch, args.seq
    if b % n_party:
        raise ValueError(f"--batch {b} does not split among {n_party} "
                         "parties")
    model = api.init(cfg, seed=args.seed, device=party["device"])
    opt_state = adamw_init(model.params())

    losses, walls = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        toks, labels = lm_batch(cfg.vocab, b, s, seed=args.seed, party=0,
                                step=i)
        t_step = time.perf_counter()
        model, opt_state, loss = step_fn(model, opt_state, i,
                                         {"tokens": toks, "labels": labels})
        # reading the loss waits for the step's last kernel
        losses.append(float(loss))
        walls.append(time.perf_counter() - t_step)
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = b * s * (i + 1) / max(dt, 1e-9)
            say(f"step {i:5d} loss {losses[-1]:.4f} "
                f"({tput_fmt(tput)} tok/s)", flush=True)
    if losses:
        say("done; final loss", losses[-1])
    return {"losses": losses, "step_wall_s": walls, "model": model,
            "opt_state": opt_state, "party": party, "step_fn": step_fn}


def tput_fmt(x: float) -> str:
    return f"{x/1e3:.1f}k" if x > 1e3 else f"{x:.0f}"


def main(argv=None) -> int:
    run(parse_args(argv))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
