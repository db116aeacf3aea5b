"""The port stands alone: no JAX, no ``repro``, the card by default.

* no module of ``repro_torch`` and no line of ``chip_smoke.py`` imports
  ``jax``, ``jaxlib`` or ``repro`` (an ``ast`` scan);
* importing every module of ``repro_torch`` leaves ``jax`` out of
  ``sys.modules`` (a fresh interpreter);
* every entry point defaults to the CUDA device and raises
  ``RuntimeError`` when there is none, instead of falling back to the CPU.
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
    from repro_torch.core import committee
    from repro_torch.core.aggregation import SecureAggregator
    from repro_torch.fl import FLSimulation, FedAvgConfig, make_transport
    from repro_torch.fl import run_fedavg
    from repro_torch.models import simple_nn
    return {
        "elect": lambda: committee.elect(4, 3, 10, 0),
        "SecureAggregator": lambda: SecureAggregator(),
        "make_transport": lambda: make_transport("two_phase", 4),
        "FLSimulation": lambda: FLSimulation(4),
        "run_fedavg": lambda: run_fedavg(
            FedAvgConfig(n_parties=4, epochs=1), {"w": torch.zeros(2)},
            lambda p, b: p, lambda i, e, it: None),
        "SimpleNN": lambda: simple_nn.SimpleNN(),
        "ComplexNN": lambda: simple_nn.ComplexNN(),
    }


@pytest.mark.parametrize("name", ["elect", "SecureAggregator",
                                  "make_transport",
                                  "FLSimulation", "run_fedavg", "SimpleNN",
                                  "ComplexNN"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("capability: a CUDA device is present, so the default "
                    "device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


@pytest.mark.parametrize("knob", [
    dict(vss=True, cohort=3), dict(cohort=3),
    dict(reelect_each_round=True, cohort=3), dict(compress_topk=0.1),
    dict(backend="wire"), dict(norm_bound=1.0, agg_kwargs={"vss": True}),
])
def test_later_slice_knobs_raise_not_implemented(knob):
    from repro_torch.fl import FedAvgConfig
    with pytest.raises(NotImplementedError, match="later|not ported"):
        FedAvgConfig(n_parties=4, **knob)


def test_later_slice_transport_options_raise_not_implemented():
    from repro_torch.fl import make_transport
    with pytest.raises(NotImplementedError, match="wire"):
        make_transport("two_phase", 4, backend="spmd", device="cpu")
    tr = make_transport("two_phase", 4, device="cpu")
    with pytest.raises(NotImplementedError, match="cohort slice"):
        tr.aggregate(torch.zeros(4, 8), eligible={0, 1, 2})
    with pytest.raises(NotImplementedError, match="cohort slice"):
        make_transport("two_phase", 4, scheme="shamir", vss=True, cohort=3,
                       device="cpu")


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
