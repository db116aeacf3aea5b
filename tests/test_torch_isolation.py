"""The port stands alone: no JAX, no ``repro``, the card by default.

* no module of ``repro_torch`` and no line of ``chip_smoke.py`` imports
  ``jax``, ``jaxlib`` or ``repro`` (an ``ast`` scan);
* importing every module of ``repro_torch`` leaves ``jax`` out of
  ``sys.modules`` (a fresh interpreter);
* every entry point defaults to the CUDA device and raises
  ``RuntimeError`` when there is none, instead of falling back to the CPU;
* every knob of a later slice raises ``NotImplementedError`` naming its
  ROADMAP item, and the knobs of the slices already ported reach the
  transport (the wire backend among them since slice 10); since slice
  11 MPC-FSDP, top-k compression and checkpoints run, and top-k on the
  wire raises the reference's ``ValueError``; since slice 12 the MoE
  family builds the reference's tree.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                  .parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core import committee
    from repro_torch.core.aggregation import SecureAggregator
    from repro_torch.fl import FLSimulation, FedAvgConfig, make_transport
    from repro_torch.fl import run_fedavg, spmd
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import simple_nn, transformer
    from repro_torch.net import WireTransport
    from repro_torch.net import party
    smoke = get_config("qwen1.5-0.5b", smoke=True)
    ssm_smoke = get_config("falcon-mamba-7b", smoke=True)
    hybrid_smoke = get_config("recurrentgemma-9b", smoke=True)
    moe_smoke = get_config("qwen3-moe-235b-a22b", smoke=True)
    return {
        "transformer_moe": lambda: transformer.init(moe_smoke),
        "make_prefill_moe": lambda: steps.make_prefill(moe_smoke),
        "make_serve_step_moe": lambda: steps.make_serve_step(moe_smoke, 8,
                                                             2),
        "serve_moe": lambda: serve.run(serve.parse_args(
            ["--arch", "grok-1-314b", "--smoke"])),
        "transformer_hybrid": lambda: transformer.init(hybrid_smoke),
        "init_cache_hybrid": lambda: transformer.init_cache(hybrid_smoke, 2,
                                                            8),
        "make_prefill_hybrid": lambda: steps.make_prefill(hybrid_smoke),
        "make_serve_step_hybrid": lambda: steps.make_serve_step(
            hybrid_smoke, 8, 2),
        "serve_hybrid": lambda: serve.run(serve.parse_args(
            ["--arch", "recurrentgemma-9b", "--smoke"])),
        "make_prefill": lambda: steps.make_prefill(smoke),
        "make_prefill_ssm": lambda: steps.make_prefill(ssm_smoke),
        "init_cache_ssm": lambda: transformer.init_cache(ssm_smoke, 2, 8),
        "make_serve_step": lambda: steps.make_serve_step(smoke, 8, 2),
        "init_cache": lambda: transformer.init_cache(smoke, 2, 8),
        "serve": lambda: serve.run(serve.parse_args(["--smoke"])),
        "make_transport_spmd": lambda: make_transport("two_phase", 4,
                                                      backend="spmd"),
        "make_train_step": lambda: steps.make_train_step(smoke),
        "transformer": lambda: transformer.init(smoke),
        "train": lambda: train.run(train.parse_args(
            ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"])),
        "elect": lambda: committee.elect(4, 3, 10, 0),
        "elect_committee_spmd": lambda: spmd.elect_committee_spmd(4, 3, 10,
                                                                  0),
        "SecureAggregator": lambda: SecureAggregator(),
        "make_transport": lambda: make_transport("two_phase", 4),
        "FLSimulation": lambda: FLSimulation(4),
        "run_fedavg": lambda: run_fedavg(
            FedAvgConfig(n_parties=4, epochs=1), {"w": torch.zeros(2)},
            lambda p, b: p, lambda i, e, it: None),
        "SimpleNN": lambda: simple_nn.SimpleNN(),
        "ComplexNN": lambda: simple_nn.ComplexNN(),
        # both raise before binding a port or spawning a worker
        "WireTransport": lambda: WireTransport(4),
        "party_main": lambda: party.main(["--port", "1", "--party-id",
                                          "0"]),
    }


@pytest.mark.parametrize("name", ["elect", "SecureAggregator",
                                  "make_transport",
                                  "FLSimulation", "run_fedavg", "SimpleNN",
                                  "ComplexNN", "make_transport_spmd",
                                  "make_train_step", "transformer",
                                  "train", "elect_committee_spmd",
                                  "make_prefill", "make_serve_step",
                                  "init_cache", "serve", "make_prefill_ssm",
                                  "init_cache_ssm", "transformer_hybrid",
                                  "init_cache_hybrid", "make_prefill_hybrid",
                                  "make_serve_step_hybrid", "serve_hybrid",
                                  "WireTransport", "party_main",
                                  "transformer_moe", "make_prefill_moe",
                                  "make_serve_step_moe", "serve_moe"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("capability: a CUDA device is present, so the default "
                    "device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_spmd_transport_elects_on_its_own_device(monkeypatch):
    """``SPMDTransport.elect`` draws and sums the votes where the
    transport runs (the card by default), not on the host."""
    from repro_torch.fl import make_transport, spmd
    seen = []
    real = spmd.elect_committee_spmd

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(spmd, "elect_committee_spmd", spy)
    tr = make_transport("two_phase", 4, backend="spmd", device="cpu")
    committee = tr.elect(0)
    assert seen == [tr.device] and committee.device == tr.device
    assert committee.shape == (3,)


#: model and train-path knobs of slices 11 to 13, which run now
#: (``_train_knob`` returns a check of what each builds)
PORTED_KNOBS = ("fsdp", "fsdp_none", "compress_topk", "ckpt_dir", "moe",
                "enc_dec", "starcoder2", "layernorm", "window", "prefill")


def _same_tree_as_reference(cfg, model, holds="['moe']/['router']") -> bool:
    """``model``'s leaf paths and shapes are those the reference's
    ``init`` (its registry's, by ``cfg.enc_dec``) builds for ``cfg``
    (shapes only, through ``eval_shape``), one of them holding
    ``holds``."""
    import dataclasses

    import jax

    from repro.models import common as j_common
    from repro.models import registry as j_registry
    from repro_torch.core.tree import flatten_with_path, path_str
    j_cfg = j_common.ArchConfig(**dataclasses.asdict(cfg))
    abstract = jax.eval_shape(
        lambda: j_registry.get_api(j_cfg).init(jax.random.PRNGKey(0), j_cfg))
    want = {"/".join(str(p) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                abstract)[0]}
    got = {path_str(p): tuple(leaf.shape)
           for p, leaf in flatten_with_path(model.params())}
    return got == want and any(holds in p for p in got)


def _trainer_refuses_the_serving_only_archs():
    """The trainer refuses whisper-large-v3, qwen2-vl-2b and starcoder2-3b
    (they serve; their training is ROADMAP queue 1, item 15): each
    through ``make_train_step``, then starcoder2-3b through the CLI,
    whose refusal this raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    for arch in ("whisper-large-v3", "qwen2-vl-2b", "starcoder2-3b"):
        with pytest.raises(NotImplementedError,
                           match=r"not ported yet.*ROADMAP queue 1, item 15"):
            steps.make_train_step(get_config(arch, smoke=True), device="cpu")
    train.run(train.parse_args(["--arch", "starcoder2-3b", "--smoke",
                                "--device", "cpu"]))


def _train_knob(name, tmp_path=None):
    """A later-slice option of the train path, as a call that must raise;
    for the knobs of ``PORTED_KNOBS``, a call that checks what it builds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import attention, encdec, transformer
    smoke = get_config("qwen1.5-0.5b", smoke=True)

    def cli(*argv):
        return lambda: train.run(train.parse_args(
            ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
             *argv]))

    # the flash kernel has no backward: "pallas" while autograd records
    q = torch.zeros((1, 1, 8, 4), requires_grad=True)
    def ported(build, check):
        return lambda: check(build())

    return {
        "fsdp": ported(lambda: steps.make_train_step(smoke, fsdp=True,
                                                     device="cpu"),
                       lambda st: st.fsdp and st.dims),
        # tinyllama-1.1b's fp32 state takes the MPC-FSDP layout
        "fsdp_none": ported(lambda: steps.make_train_step(
            get_config("tinyllama-1.1b"), device="cpu"),
            lambda st: st.fsdp),
        "compress_topk": ported(lambda: steps.make_train_step(
            smoke, compress_topk=0.1, device="cpu"),
            lambda st: st.compress_topk == 0.1 and not st.fsdp),
        "pallas": lambda: attention.attention(q, q, q, smoke, impl="pallas"),
        "moe": ported(lambda: transformer.init(dataclasses.replace(
            smoke, n_experts=4, top_k=2, d_ff_expert=32), device="cpu"),
            lambda model: _same_tree_as_reference(model.cfg, model)),
        "enc_dec": ported(lambda: encdec.init(get_config(
            "whisper-large-v3"), device="meta"),
            lambda model: _same_tree_as_reference(
                model.cfg, model, "['dec_layers']/['cross']/['wk']")),
        "starcoder2": ported(lambda: transformer.init(get_config(
            "starcoder2-3b"), device="meta"),
            lambda model: _same_tree_as_reference(
                model.cfg, model, "['mlp']/['b_up']")),
        "layernorm": ported(lambda: transformer.init(dataclasses.replace(
            smoke, norm="layernorm"), device="cpu"),
            lambda model: _same_tree_as_reference(
                model.cfg, model, "['ln1']/['bias']")),
        # the window's cache is a ring of min(kv_len, window) slots
        "window": ported(lambda: transformer.init(dataclasses.replace(
            smoke, window=8), device="cpu"),
            lambda model: _same_tree_as_reference(
                model.cfg, model, "['attn']/['wq']")
            and transformer.cache_batch_and_length(transformer.init_cache(
                model.cfg, 2, 32, device="cpu")) == (2, 8)),
        # the embeddings frontend's prefill reads embeds [B, S, d]
        "prefill": ported(lambda: transformer.init(dataclasses.replace(
            smoke, frontend="embeddings"), device="cpu"),
            lambda model: _same_tree_as_reference(
                model.cfg, model, "['embed']/['table']")
            and transformer.prefill(model.params(), {"embeds": torch.zeros(
                (2, 8, smoke.d_model))}, model.cfg).shape == (2, smoke.vocab)),
        "train_item15": _trainer_refuses_the_serving_only_archs,
        "serve_tp": lambda: serve.run(serve.parse_args(
            ["--smoke", "--tp", "2", "--device", "cpu"])),
        "ckpt_dir": ported(cli("--ckpt-dir", str(tmp_path), "--steps", "1",
                               "--batch", "2", "--seq", "8"),
                           lambda out: out["start"] == 0 and len(
                               os.listdir(tmp_path)) == 1),
    }[name]


@pytest.mark.parametrize("knob", [
    # the wire backend is ported (slice 10) and top-k (slice 11); top-k
    # on the wire raises the reference's ValueError
    dict(compress_topk=0.1), dict(compress_topk=0.1, backend="wire"),
    "fsdp", "fsdp_none", "compress_topk", "pallas", "moe", "enc_dec",
    "prefill", "ckpt_dir", "starcoder2", "layernorm", "window", "serve_tp",
    "train_item15",
])
def test_later_slice_knobs_raise_not_implemented(knob, monkeypatch,
                                                 tmp_path):
    if knob in PORTED_KNOBS:
        # slices 11 to 13 ported these: each builds what the reference
        # builds
        assert _train_knob(knob, tmp_path)()
        return
    if isinstance(knob, str):
        with pytest.raises(NotImplementedError,
                           match=r"not ported yet.*ROADMAP queue"):
            _train_knob(knob)()
        return
    if knob.get("backend") == "wire":
        # a wire spec with top-k raises the reference's FLSimulation
        # ValueError from the spec's transport factory, before a port is
        # bound or a worker spawned
        from repro_torch import api
        from repro_torch.net import WireTransport

        def start(self):
            pytest.fail("the wire transport started")
        monkeypatch.setattr(WireTransport, "start", start)
        with pytest.raises(ValueError, match="not implemented on the wire"):
            api.make_transport(api.ExperimentSpec(n=4, **knob),
                               device="cpu")
        return
    # top-k in FedAvg (slice 11): the config carries the compression
    from repro_torch.fl import FedAvgConfig
    cfg = FedAvgConfig(n_parties=4, **knob)
    assert cfg.compression().top_k_ratio == knob["compress_topk"]


def test_falcon_mamba_is_ported_and_its_training_needs_mpc_fsdp():
    """The SSM family serves (falcon-mamba-7b loads at full size); its
    7.26 B parameters take the MPC-FSDP layout, which the step resolves
    to (slice 11)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_config("falcon-mamba-7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner,
            cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv, cfg.vocab,
            cfg.tie_embeddings) == ("ssm", 64, 4096, 8192, 16, 256, 4,
                                    65024, False)
    assert cfg.param_count() == 7_263_748_096
    transformer.check_family(cfg)
    assert transformer.stack_plan(cfg) == (("ssm",), 64, ())
    assert steps.needs_fsdp(cfg)
    step = steps.make_train_step(cfg, device="cpu")
    assert step.fsdp and step.dims[("layers", "b0_ssm", "ssm",
                                    "in_proj")] is not None


def test_recurrentgemma_is_ported_and_its_training_needs_mpc_fsdp():
    """The hybrid family serves (recurrentgemma-9b loads at full size);
    its 10.4 B float32 parameters and their Adam moments take the
    MPC-FSDP layout, which the step resolves to (slice 11).  A dense
    block with a window serves (starcoder2-3b's) and the trainer refuses
    it (ROADMAP queue 1, item 15)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_config("recurrentgemma-9b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.lru_width, cfg.window,
            cfg.vocab, cfg.act, cfg.tie_embeddings) == (
        "hybrid", 38, 4096, 16, 1, 256, 12288, 4096, 2048, 256000, "geglu",
        False)
    assert cfg.param_count() == 10_444_873_728
    transformer.check_family(cfg)
    assert transformer.stack_plan(cfg) == (("rec", "rec", "attn"), 12,
                                           ("rec", "rec"))
    assert steps.needs_fsdp(cfg)
    step = steps.make_train_step(cfg, device="cpu")
    assert step.fsdp and step.dims[("tail", 0, "rec", "w_x")] is not None
    with pytest.raises(NotImplementedError, match="not ported yet.*ROADMAP"):
        steps.make_train_step(dataclasses.replace(cfg, family="dense"),
                              device="cpu")


def test_later_slice_transport_options_raise_not_implemented():
    from repro_torch.fl import SPMDTransport, make_transport
    from repro_torch.net import WireTransport
    # the SPMD backend is ported (a world of one without a process
    # group), and so is the wire (slice 10): unstarted, it has bound no
    # port and spawned no worker; it deploys only two_phase
    tr = make_transport("two_phase", 4, backend="spmd", device="cpu")
    assert isinstance(tr, SPMDTransport) and tr.mode == "psum"
    tr = make_transport("two_phase", 4, backend="wire", device="cpu",
                        start=False)
    assert isinstance(tr, WireTransport) and tr.port is None
    assert tr.device.type == "cpu" and tr.cfg.n == 4
    tr.close()
    with pytest.raises(ValueError, match="two_phase"):
        make_transport("p2p", 4, backend="wire", device="cpu")
    # the cohort slice's options are ported: eligible= restricts the
    # pool in cohort mode and is ignored outside it
    tr = make_transport("two_phase", 4, device="cpu")
    mean = tr.aggregate(torch.zeros(4, 8), eligible={0, 1, 2})
    assert mean.shape == (8,) and tr.cohort is None
    tr = make_transport("two_phase", 4, scheme="shamir", vss=True, cohort=3,
                        device="cpu")
    mean = tr.aggregate(torch.zeros(3, 8), eligible={0, 1, 2, 3})
    assert mean.shape == (8,) and len(tr.cohort_ids) == 3
    assert set(tr.committee) <= set(tr.cohort_ids)


@pytest.mark.parametrize("knob", [
    dict(vss=True), dict(reelect_each_round=True),
    dict(vss=True, norm_bound=1.0),
    dict(vss=True, dealer_tamper={0: ("scale", 0)}),
])
def test_malicious_security_knobs_are_ported(knob):
    from repro_torch.fl import FedAvgConfig, FLSimulation
    cfg = FedAvgConfig(n_parties=4, scheme="shamir", **knob)
    sim = FLSimulation(4, scheme="shamir", device="cpu", **knob)
    tr = sim.transports["two_phase"]
    assert tr.vss == cfg.vss
    assert tr.reelect_each_round == cfg.reelect_each_round


@pytest.mark.parametrize("knob", [
    dict(vss=True, cohort=3), dict(cohort=3),
    dict(reelect_each_round=True, cohort=3),
    dict(norm_bound=1.0, agg_kwargs={"vss": True}),
])
def test_cohort_slice_knobs_are_ported(knob):
    from repro_torch.deprecation import ReproDeprecationWarning
    from repro_torch.fl import FedAvgConfig, FLSimulation
    cfg = FedAvgConfig(n_parties=4, scheme="shamir", **knob)
    if cfg.agg_kwargs:
        with pytest.warns(ReproDeprecationWarning, match="agg_kwargs"):
            kw = cfg.simulation_kwargs()
    else:
        kw = cfg.simulation_kwargs()
    sim = FLSimulation(4, scheme="shamir", device="cpu", **kw)
    tr = sim.transports["two_phase"]
    assert tr.cohort == knob.get("cohort")
    assert tr.vss == (cfg.vss or bool((cfg.agg_kwargs or {}).get("vss")))
    assert tr.norm_bound == cfg.norm_bound
    assert tr.reelect_each_round == cfg.reelect_each_round
