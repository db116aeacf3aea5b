"""The port's typed experiment API against the JAX package.

* ``ExperimentSpec`` has the reference's fields, in its order and with
  its defaults, validates as it does, and rejects unknown keys (and
  ``FLSimulation`` unknown keywords) with a did-you-mean hint;
* a spec written by either package's ``to_json`` loads in the other's
  ``from_json``, a nested scenario included;
* ``fedavg_config()`` and ``flsim_kwargs()`` equal the reference's field
  by field; every entry point of the port takes a spec;
* the deprecated ``FedAvgConfig.agg_kwargs`` warns
  ``ReproDeprecationWarning`` and gives the typed path's bits;
* top-k compression (item 6, part A, ported in slice 11) reaches the
  transports as the reference's ``CompressionConfig``; the wire backend
  (item 8, ported in slice 10) builds the reference's ``WireConfig`` and
  transport keywords and constructs;
* ``launch.train --spec`` (inline JSON and a file) at smoke size on the
  CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.fl import scenarios as j_scenarios
from repro_torch import api
from repro_torch.deprecation import ReproDeprecationWarning
from repro_torch.fl import FedAvgConfig, FLSimulation, run_fedavg
from repro_torch.fl import scenarios
from repro_torch.fl.transport import TwoPhaseTransport


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("pair", [
    (api.ExperimentSpec, j_api.ExperimentSpec),
    (scenarios.ScenarioConfig, j_scenarios.ScenarioConfig),
    (scenarios.ChurnConfig, j_scenarios.ChurnConfig),
    (scenarios.StragglerConfig, j_scenarios.StragglerConfig),
    (scenarios.DealerConfig, j_scenarios.DealerConfig),
])
def test_configs_have_the_reference_fields(pair):
    assert _fields(pair[0]) == _fields(pair[1])


def test_spec_validates_and_rejects_unknown_keys_with_a_hint():
    spec = api.ExperimentSpec(n=8, cohort=4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.n = 9
    for kw, match in ((dict(pipeline=True), "pipeline"),
                      (dict(cohort=9), "cohort"),
                      (dict(backend="carrier-pigeon"), "backend"),
                      (dict(frac_bits=12), "pair"),
                      (dict(relay="ring"), "relay"),
                      (dict(kernel_backend="ref"), "device")):
        with pytest.raises(ValueError, match=match):
            api.ExperimentSpec(n=8, **kw)
    with pytest.raises(ValueError, match="did you mean 'cohort'"):
        api.ExperimentSpec.from_json({"n": 4, "cohrot": 2})
    with pytest.raises(ValueError, match="scenario"):
        api.ExperimentSpec.from_json(
            {"n": 4, "scenario": {"name": "x", "epochz": 3}})
    with pytest.raises(TypeError, match="did you mean 'chunk_elems'"):
        FLSimulation(4, chunk_elms=8, device="cpu")
    with pytest.raises(TypeError, match="ExperimentSpec"):
        api.make_transport({"backend": "sim"})


PACKAGES = {"port": (api, scenarios), "reference": (j_api, j_scenarios)}


def _spec(package):
    module, s = PACKAGES[package]
    return module.ExperimentSpec(
        n=16, m=3, scheme="shamir", shamir_degree=1, vss=True,
        norm_bound=5.0, cohort=6, pipeline=True, backend="wire",
        frac_bits=14, clip=32.0, dealer_tamper={3: ("scale", 1)},
        scenario=s.ScenarioConfig(
            name="t", alpha=0.5, churn=s.ChurnConfig(seed=2),
            straggler=s.StragglerConfig(seed=7),
            dealers=(s.DealerConfig(party=1, mode="sign_flip"),)))


@pytest.mark.parametrize("src,dst", [("reference", "port"),
                                     ("port", "reference")])
def test_spec_json_loads_in_the_other_package(src, dst):
    text = json.dumps(_spec(src).to_json())
    back = PACKAGES[dst][0].ExperimentSpec.from_json(json.loads(text))
    assert back == _spec(dst)
    assert json.dumps(back.to_json()) == text
    assert back.scenario.dealers[0].mode == "sign_flip"


def _plain(obj):
    """A config value as plain data (dataclasses as dicts)."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return obj


@pytest.mark.parametrize("kw", [
    dict(n=10, m=3, scheme="shamir", shamir_degree=1, vss=True, cohort=5,
         norm_bound=4.0, frac_bits=15, clip=32.0, deadline_s=2.0),
    dict(n=7, protocol="p2p", chunk_elems=64, seed=9, epochs=2,
         reelect_each_round=True, dealer_tamper={1: ("scale", 0)}),
])
def test_conversions_match_the_reference_field_by_field(kw):
    got, want = api.ExperimentSpec(**kw), j_api.ExperimentSpec(**kw)
    fa, j_fa = got.fedavg_config(), want.fedavg_config()
    assert [f.name for f in dataclasses.fields(fa)] == \
        [f.name for f in dataclasses.fields(j_fa)]
    for f in dataclasses.fields(fa):
        assert _plain(getattr(fa, f.name)) == \
            _plain(getattr(j_fa, f.name)), f.name
    sim_kw, j_sim_kw = got.flsim_kwargs(), want.flsim_kwargs()
    assert list(sim_kw) == list(j_sim_kw)
    for k in sim_kw:
        assert _plain(sim_kw[k]) == _plain(j_sim_kw[k]), k


def test_every_entry_point_takes_a_spec():
    spec = api.ExperimentSpec(n=6, m=3, seed=5, cohort=4)
    tr = api.make_transport(spec, device="cpu")
    assert isinstance(tr, TwoPhaseTransport)
    assert (tr.cohort, tr.seed, tr.device.type) == (4, 5, "cpu")
    sim = FLSimulation(spec, device="cpu")
    assert (sim.n, sim.m, sim.seed) == (6, 3, 5)
    sim.elect_committee()
    assert set(sim.committee) <= set(sim.transports["two_phase"].cohort_ids)
    assert spec.simulation(device="cpu").transports["two_phase"].cohort == 4
    scn_spec = api.ExperimentSpec(
        n=4, m=3, epochs=2, local_steps=1, scheme="shamir",
        shamir_degree=1, vss=True, seed=1,
        scenario=scenarios.ScenarioConfig(name="spec-smoke", batch_size=16,
                                          samples_per_party=40))
    rec = scenarios.run_scenario(scn_spec, device="cpu")
    assert rec["name"] == "spec-smoke" and not rec["aborted"]
    assert rec["counters_match"]
    # the spec's shared fields won over the scenario's defaults
    assert (rec["n"], rec["m"], rec["epochs"], rec["seed"]) == (4, 3, 2, 1)


def _tiny_fedavg(cfg):
    d = 5

    def step(params, batch):
        return {"w": params["w"] - 0.1 * batch}

    def batches(i, epoch, it):
        return torch.full((d,), 0.02 * (i + 1))

    return run_fedavg(cfg, {"w": torch.zeros(d)}, step, batches,
                      device="cpu")


def test_agg_kwargs_shim_warns_and_matches_the_typed_path_bitwise():
    typed = _tiny_fedavg(FedAvgConfig(n_parties=5, epochs=2, local_steps=1,
                                      seed=7, scheme="shamir", cohort=4,
                                      reelect_each_round=True))
    with pytest.warns(ReproDeprecationWarning, match="agg_kwargs"):
        old = _tiny_fedavg(FedAvgConfig(
            n_parties=5, epochs=2, local_steps=1, seed=7, scheme="shamir",
            agg_kwargs={"cohort": 4, "reelect_each_round": True}))
    assert torch.equal(old.params["w"].view(torch.int32),
                       typed.params["w"].view(torch.int32))
    assert old.phases == typed.phases
    via_spec = _tiny_fedavg(api.ExperimentSpec(
        n=5, epochs=2, local_steps=1, seed=7, scheme="shamir", cohort=4,
        reelect_each_round=True))
    assert torch.equal(via_spec.params["w"], typed.params["w"])
    with pytest.warns(ReproDeprecationWarning):
        with pytest.raises(TypeError, match="did you mean"):
            _tiny_fedavg(FedAvgConfig(n_parties=4, epochs=1,
                                      agg_kwargs={"chunk_elms": 8}))


@pytest.mark.parametrize("case", [
    "wire_config", "wire_transport_kwargs", "make_transport_wire",
    "flsim_wire", "fedavg_wire", "scenario_wire", "fedavg_topk",
    "flsim_topk", "make_transport_topk",
])
def test_wire_and_topk_paths_raise_naming_their_items(case):
    """The wire cases check the ported wire path (item 8, slice 10) and
    the top-k cases the ported compression (item 6, part A, slice 11):
    each builds what the reference's builds, and none raises naming its
    item."""
    if case.endswith("wire") or case.startswith("wire"):
        _check_wire_case(case)
        return
    kw = dict(n=4, compress_topk=0.1, error_feedback=False)
    topk, ref = api.ExperimentSpec(**kw), j_api.ExperimentSpec(**kw)
    want = dataclasses.astuple(ref.compression())
    if case == "fedavg_topk":
        cfg = topk.fedavg_config()
        assert dataclasses.astuple(cfg.compression()) == want
        return
    if case == "flsim_topk":
        transports = FLSimulation(topk, device="cpu").transports.values()
    else:
        transports = [api.make_transport(topk, device="cpu")]
    for tr in transports:
        assert dataclasses.astuple(tr.compression) == want
        tr.aggregate(torch.ones((4, 40)))
        assert tr.net.stats().msg_size > 0


def _check_wire_case(case):
    from repro_torch.net import WireTransport
    kw = dict(n=6, m=3, scheme="shamir", shamir_degree=1, vss=True,
              seed=3, cohort=5, relay="tree", lease_s=12.0,
              frac_bits=14, clip=16.0, backend="wire")
    wire, ref = api.ExperimentSpec(**kw), j_api.ExperimentSpec(**kw)
    if case == "wire_config":
        assert wire.wire_config().to_json() == ref.wire_config().to_json()
    elif case == "wire_transport_kwargs":
        ours, theirs = wire.wire_transport_kwargs(), \
            ref.wire_transport_kwargs()
        assert dataclasses.astuple(ours.pop("fp")) == \
            dataclasses.astuple(theirs.pop("fp")) == (14, 16.0, "field")
        assert ours == theirs
    elif case == "make_transport_wire":
        tr = api.make_transport(wire, device="cpu", start=False)
        try:
            assert isinstance(tr, WireTransport) and tr.port is None
            assert tr.cfg == wire.wire_config()
            assert tr.device.type == "cpu"
        finally:
            tr.close()
    elif case == "flsim_wire":
        spec = dataclasses.replace(wire, wire_kwargs={"start": False})
        with FLSimulation(spec, device="cpu") as sim:
            tr = sim.transports["two_phase"]
            assert isinstance(tr, WireTransport) and tr.port is None
            assert tr.net is sim.net and tr.cfg.relay == "tree"
    elif case == "fedavg_wire":
        cfg, want = wire.fedavg_config(), ref.fedavg_config()
        assert cfg.backend == "wire"
        assert cfg.wire_kwargs == want.wire_kwargs == {
            "pipeline": False, "lease_s": 12.0, "relay": "tree"}
    else:
        scn = scenarios.ScenarioConfig(name="w", backend="wire")
        assert scn.backend == "wire"
        assert FedAvgConfig(n_parties=4, backend="wire").backend == "wire"


def test_train_takes_a_spec(tmp_path):
    from repro_torch.launch import train
    spec = api.ExperimentSpec(n=1, m=3, scheme="shamir", seed=4,
                              chunk_elems=4096)
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    args = train.parse_args(argv + ["--spec", json.dumps(spec.to_json())])
    out = train.run(args)
    assert (args.protocol, args.scheme, args.committee, args.seed,
            args.chunk_elems) == ("two_phase", "shamir", 3, 4, 4096)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(dataclasses.replace(
        spec, protocol="plain").to_json()))
    args = train.parse_args(argv + ["--spec", str(path)])
    train.apply_spec(args)
    assert (args.protocol, args.scheme) == ("plain", "shamir")
