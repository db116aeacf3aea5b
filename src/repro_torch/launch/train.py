"""End-to-end federated LM trainer (the command-line entry point).

    PYTHONPATH=src python -m repro_torch.launch.train --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --steps 10 --device cpu --compress-topk 0.01 \
        --ckpt-dir ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen1.5-0.5b --smoke --steps 10 --device cpu

Counterpart of ``repro/launch/train.py``, with its flags and defaults:
per-party fwd/bwd -> two-phase MPC gradient aggregation -> AdamW, on
the card unless ``--device cpu``, with checkpoint/restart.  The parties
are the ranks that ``torchrun`` starts (a world of one without it);
each rank trains on its rows of the global batch.  The backend follows
the rule of ``launch.mesh.choose_backend`` and is printed.  The layout
is the reference's rule (``launch.sharding.needs_fsdp``): the default
``--arch tinyllama-1.1b`` takes MPC-FSDP, qwen1.5-0.5b and the smoke
configs the replicated layout.  ``--compress-topk`` sparsifies each
party's gradient with error feedback (residuals in the optimizer state,
saved with it).  ``--ckpt-dir`` saves every ``--ckpt-every`` steps and
at the end, in the reference's layout, and resumes from the newest
checkpoint there.  ``--spec`` takes an ``ExperimentSpec``
(``repro_torch.api``) as a JSON file or inline JSON and sets the
protocol, scheme, committee, seed, compress-topk and chunk-elems from
it, as the reference does; the model and loop flags stay on the command
line.  ``--tp`` above 1 and ``--production-mesh`` raise
``NotImplementedError``: the port has no model axis (ROADMAP queue 1,
item 11), and the pod meshes are TPU meshes.  whisper-large-v3,
qwen2-vl-2b and starcoder2-3b serve but do not train yet: the step
refuses them (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.tree import flatten_with_path, tree_map
from repro_torch.data import lm_batch
from repro_torch.fl.spmd import party_index
from repro_torch.launch.fsdp import all_gather_dim, shard_tree
from repro_torch.launch.mesh import init_from_env
from repro_torch.launch.steps import (ef_row, init_error_feedback,
                                      make_train_step)
from repro_torch.models.registry import get_api
from repro_torch.optim import AdamWConfig, adamw_init

TP_LATER = ("--tp {tp} is not ported yet: the port has no model axis, and "
            "tensor parallelism belongs to ROADMAP queue 1, item 11")
POD_MESH = ("--production-mesh builds the reference's TPU pod meshes "
            "(16x16, 2x16x16), which have no counterpart on the port's "
            "cards: each party is one process (ROADMAP queue 1, item 11)")


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
                    help="top-k gradient sparsification ratio before "
                         "secure aggregation (0 = off, dense baseline); "
                         "error-feedback residuals ride in the opt state")
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


def _state(step_fn, model, opt_state) -> dict:
    """The checkpoint tree, as the reference saves it: whole parameters
    and moments, and every party's residual row (``[n_party, *leaf]``),
    gathered from the parties."""
    opt = {k: step_fn.full_params(opt_state[k]) for k in ("m", "v")}
    if "ef" in opt_state:
        opt["ef"] = tree_map(lambda e: all_gather_dim(e, 0, step_fn.group),
                            opt_state["ef"])
    return {"params": step_fn.full_params(model.params()), "opt": opt}


def _load_state(step_fn, model, opt_state, state) -> None:
    """Copy a restored checkpoint tree into this party's parameters,
    moments and residual row (in place)."""
    pid = party_index(step_fn.group)
    dims = step_fn.dims if step_fn.fsdp else None

    def mine(tree):
        return shard_tree(tree, dims, step_fn.group) if dims else tree

    pairs = [(model.params(), mine(state["params"]))]
    pairs += [(opt_state[k], mine(state["opt"][k])) for k in ("m", "v")]
    if "ef" in opt_state:
        pairs.append((opt_state["ef"], ef_row(state["opt"]["ef"], pid)))
    with torch.no_grad():
        for dst, src in pairs:
            got = dict(flatten_with_path(src))
            for path, leaf in flatten_with_path(dst):
                leaf.copy_(got[path])


def run(args, observe=None) -> dict:
    """Train as ``args`` say.  Returns the losses, each step's host wall
    seconds (up to its loss on the host), the model (this party's shards
    under MPC-FSDP), the optimizer state, the party facts, the step and
    the first step run (after a resume, the one after the checkpoint).

    ``observe`` is handed to the step (``TrainStep.observe``).
    """
    if args.spec:
        apply_spec(args)
    if args.tp != 1:
        raise NotImplementedError(TP_LATER.format(tp=args.tp))
    if args.production_mesh:
        raise NotImplementedError(POD_MESH)
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
        f"protocol={args.protocol} "
        f"layout={'mpc_fsdp' if step_fn.fsdp else 'replicated'}",
        flush=True)

    b, s = args.batch, args.seq
    if b % n_party:
        raise ValueError(f"--batch {b} does not split among {n_party} "
                         "parties")
    model = api.init(cfg, seed=args.seed, device=party["device"])
    if step_fn.fsdp:
        model = step_fn.shard_model(model)
    opt_state = adamw_init(model.params())
    if args.compress_topk:
        # this party's row of the reference's [n_party, *leaf] residuals
        opt_state["ef"] = init_error_feedback(model.params(), 1)
    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        state, start = ck.restore(_state(step_fn, model, opt_state))
        _load_state(step_fn, model, opt_state, state)
        del state
        start += 1
        say(f"resumed from step {start - 1}", flush=True)

    def save(i):
        state = _state(step_fn, model, opt_state)
        if party["rank"] == 0:
            ck.save(i, state)

    losses, walls = [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
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
            tput = b * s * (i - start + 1) / max(dt, 1e-9)
            say(f"step {i:5d} loss {losses[-1]:.4f} "
                f"({tput_fmt(tput)} tok/s)", flush=True)
        if ck and args.ckpt_every and i and i % args.ckpt_every == 0:
            save(i)
    if ck:
        save(args.steps - 1)
    if losses:
        say("done; final loss", losses[-1])
    return {"losses": losses, "step_wall_s": walls, "model": model,
            "opt_state": opt_state, "party": party, "step_fn": step_fn,
            "start": start}


def tput_fmt(x: float) -> str:
    return f"{x/1e3:.1f}k" if x > 1e3 else f"{x:.0f}"


def main(argv=None) -> int:
    run(parse_args(argv))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
