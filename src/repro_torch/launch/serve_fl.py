"""Coordinator/party launch entry points for the port's wire transport.

Counterpart of ``repro/launch/serve_fl.py``.  Deploy the paper's
two-phase protocol as real OS processes — one coordinator, ``n``
parties — over TCP (DESIGN.md §9), each party's math on its device (the
card unless ``--device cpu``):

    # terminal 1: coordinator (spawns nothing; waits for n parties)
    PYTHONPATH=src python -m repro_torch.launch.serve_fl coordinator \
        --port 7788 --n 4 --rounds 2 --model-dim 242

    # terminals 2..5: one party worker each (can be other machines)
    PYTHONPATH=src python -m repro_torch.launch.serve_fl party \
        --host 127.0.0.1 --port 7788 --party-id 0

    # or everything on one machine in one command:
    PYTHONPATH=src python -m repro_torch.launch.serve_fl coordinator \
        --port 0 --n 4 --rounds 2 --spawn-local

The coordinator runs Phase I election, then ``--rounds`` aggregation
rounds over synthetic per-party updates (the driver owns the
federation's data in this reproduction), prints the per-phase wire
counters, and cross-checks them against the paper's closed forms
(Eqs. 3–6) — the same assertion the test-suite and the benchmark gate
run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.costmodel import CostParams


def _load_spec(arg: str):
    """``--spec``: a path to an ExperimentSpec JSON file, or the JSON
    itself (starts with ``{``)."""
    from repro_torch.api import ExperimentSpec
    if arg.lstrip().startswith("{"):
        return ExperimentSpec.from_json(json.loads(arg))
    with open(arg) as fh:
        return ExperimentSpec.from_json(json.load(fh))


def _coordinator(args) -> int:
    from repro_torch.net import WireTransport
    if args.spec:
        spec = _load_spec(args.spec)
        kw = spec.wire_transport_kwargs()
        # deployment knobs stay on the CLI; the spec owns the protocol
        args.n, args.m, args.b = spec.n, spec.m, spec.vote_batch
        args.seed, args.scheme = spec.seed, spec.scheme
        tr = WireTransport(
            kw.pop("n"), host=args.host, port=args.port,
            spawn=args.spawn_local, log_dir=args.log_dir, start=False,
            device=args.device, **kw)
    else:
        tr = WireTransport(
            args.n, m=args.m, scheme=args.scheme, seed=args.seed,
            b=args.b, shamir_degree=args.shamir_degree, host=args.host,
            port=args.port, spawn=args.spawn_local,
            deadline_s=args.deadline_s, log_dir=args.log_dir,
            start=False, device=args.device)
    tr.start()
    print(f"coordinator on {args.host}:{tr.port} — federation of "
          f"{args.n} parties, committee size {args.m}")
    try:
        committee = tr.elect()
        print(f"Phase I committee: {committee}")
        cohort = getattr(tr, "cohort", None)
        rng = np.random.RandomState(args.seed)
        for r in range(args.rounds):
            flats = rng.randn(args.n, args.model_dim).astype(np.float32)
            if cohort:
                if r:
                    tr.elect(r)         # per-round cohort election
                cids = sorted(tr.cohort_ids)
                print(f"round {r} cohort: {cids}")
                mean = tr.aggregate(flats[cids], party_ids=cids,
                                    round_index=r).cpu().numpy()
                base = flats[cids].mean(0)
            else:
                mean = tr.aggregate(flats, round_index=r).cpu().numpy()
                base = flats.mean(0)
            err = float(np.abs(mean - base).max())
            print(f"round {r}: |G|={np.linalg.norm(mean):.4f} "
                  f"max|G - plain mean|={err:.2e} "
                  f"outcome={tr.last_outcome}")
        p = CostParams(n=args.n, e=args.rounds, s=args.model_dim,
                       m=args.m, b=args.b)
        st1 = tr.net.stats("phase1")
        p2_num = sum(tr.net.stats(ph).msg_num for ph in
                     ("phase2_upload", "phase2_exchange",
                      "phase2_broadcast"))
        p2_size = sum(tr.net.stats(ph).msg_size for ph in
                      ("phase2_upload", "phase2_exchange",
                       "phase2_broadcast"))
        if cohort:
            exp1n = costmodel.phase1_cohort_msg_num(p, cohort)
            exp1s = costmodel.phase1_cohort_msg_size(p, cohort)
            exp2n = costmodel.phase2_cohort_msg_num(p, cohort)
            exp2s = costmodel.phase2_cohort_msg_size(p, cohort)
        else:
            exp1n, exp1s = (costmodel.phase1_msg_num(p),
                            costmodel.phase1_msg_size(p))
            exp2n, exp2s = (costmodel.phase2_msg_num(p),
                            costmodel.phase2_msg_size(p))
        print(f"phase1 wire: {st1.msg_num} msgs / {st1.msg_size} elems "
              f"(Eqs. 3-4: {exp1n} / {exp1s})")
        print(f"phase2 wire: {p2_num} msgs / {p2_size} elems "
              f"(Eqs. 5-6: {exp2n} / {exp2s})")
        print(f"raw socket bytes: in={tr.coordinator.raw_bytes_in} "
              f"out={tr.coordinator.raw_bytes_out} "
              "(frame headers + relay transit; see DESIGN.md §9)")
    finally:
        tr.close()
    return 0


def _party(args) -> int:
    from repro_torch.net.party import main as party_main
    argv = ["--host", args.host, "--port", str(args.port),
            "--party-id", str(args.party_id), "--device", args.device]
    if args.log_file:
        argv += ["--log-file", args.log_file]
    return party_main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="two-phase MPC FL over real sockets")
    sub = ap.add_subparsers(dest="role", required=True)

    co = sub.add_parser("coordinator", help="run the aggregation hub")
    co.add_argument("--host", default="127.0.0.1")
    co.add_argument("--port", type=int, default=7788,
                    help="0 picks an ephemeral port")
    co.add_argument("--n", type=int, default=4)
    co.add_argument("--m", type=int, default=3)
    co.add_argument("--b", type=int, default=10)
    co.add_argument("--seed", type=int, default=1)
    co.add_argument("--rounds", type=int, default=2)
    co.add_argument("--model-dim", type=int, default=242)
    co.add_argument("--scheme", choices=("additive", "shamir"),
                    default="additive")
    co.add_argument("--shamir-degree", type=int, default=None)
    co.add_argument("--deadline-s", type=float, default=30.0)
    co.add_argument("--spawn-local", action="store_true",
                    help="spawn the n party workers as local "
                         "subprocesses instead of waiting for them")
    co.add_argument("--log-dir", default=None)
    co.add_argument("--device", default="cuda",
                    help="the spawned workers' device and the mean's: "
                         "cuda (the default) or cpu")
    co.add_argument("--spec", default=None,
                    help="repro_torch.api.ExperimentSpec JSON (a file path "
                         "or inline JSON); overrides the per-field "
                         "protocol flags above — only host/port/"
                         "spawn/log/round knobs stay on the CLI")

    pa = sub.add_parser("party", help="run one party worker")
    pa.add_argument("--host", default="127.0.0.1")
    pa.add_argument("--port", type=int, required=True)
    pa.add_argument("--party-id", type=int, required=True)
    pa.add_argument("--log-file", default=None)
    pa.add_argument("--device", default="cuda",
                    help="where the party's math runs: cuda (the "
                         "default; raises without a card) or cpu")

    args = ap.parse_args(argv)
    if args.role == "coordinator":
        return _coordinator(args)
    return _party(args)


if __name__ == "__main__":
    sys.exit(main())
