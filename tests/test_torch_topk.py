"""The port's top-k compression with error feedback against the JAX
package's.

Same numpy inputs (quantized, so magnitudes tie, with ``-0.0`` among
them) into ``repro`` (JAX on the CPU) and ``repro_torch``
(``device="cpu"``); every comparison is bit for bit unless stated:

* ``compress_topk`` (values, indices in ``jax.lax.top_k``'s order: the
  lowest index first among equal magnitudes), ``decompress_topk`` and
  ``compress_topk_batch`` (densified updates and residuals), with and
  without error feedback; ``compressed_size``;
* the top-k closed forms of ``core.costmodel``;
* three rounds each of the plain, P2P and two-phase (additive and
  Shamir) transports, and of a cohort-mode two-phase round, with
  compression: means (the plain transport's float32 mean to 1e-6, as
  ``tests/test_torch_round.py`` holds it), each party's residual and
  every phase counter equal to the reference's, and the counters to the top-k closed forms;
  a round refused by a check leaves the residuals as they were;
* the refusals the reference keeps: VSS with top-k, top-k on the wire
  (``FLSimulation`` and ``api.make_transport``, before a port is bound);
* one train step with ``compress_topk`` at a world of one: the loss to
  1e-5 relative and each parameter's update to 1e-6 absolute (the
  tolerances of ``tests/test_torch_train.py``, and its exemption of
  gradient elements within one fixed-point quantum of 0), and the
  error-feedback residuals to 1e-6 absolute (the same float32 gradients
  to 1e-4 of their max-abs; every residual element is a gradient
  element, or 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as j_get_config
from repro.core import compression as jc
from repro.core import costmodel as j_costmodel
from repro.fl import FLSimulation as JFLSimulation
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import init_error_feedback as j_init_ef
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.steps import place
from repro.models import transformer as j_transformer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import compression as tc
from repro_torch.core import costmodel
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data import lm_batch
from repro_torch.fl import FLSimulation
from repro_torch.launch.steps import (ef_row, init_error_feedback,
                                      join_ef_rows, make_train_step)
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, adamw_init

N, M, S, RATIO, ROUNDS = 6, 3, 257, 0.05, 3
QUANTUM = 2.0 ** -16
TIE_ROW = [1, 3, 2, 3, 2, 2, 0.5, 2]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _tied(rng, shape, step=0.25):
    """Values on a coarse grid (many equal magnitudes) with -0.0 mixed
    in."""
    x = (rng.randint(-6, 7, size=shape) * step).astype(np.float32)
    x[x == 0] = np.where(rng.rand(int((x == 0).sum())) < 0.5, -0.0, 0.0)
    return x


def _cfgs(ratio, ef=True):
    return (jc.CompressionConfig(enabled=True, top_k_ratio=ratio,
                                 error_feedback=ef),
            tc.CompressionConfig(enabled=True, top_k_ratio=ratio,
                                 error_feedback=ef))


@pytest.mark.parametrize("case", ["tie_row", "tie_row_carried", "random",
                                  "no_ef", "all", "one"])
def test_compress_topk_matches_reference(case):
    rng = np.random.RandomState(3)
    if case.startswith("tie_row"):
        flat = np.array(TIE_ROW, np.float32)
        err = (np.zeros(8, np.float32) if case == "tie_row"
               else np.array([1, -1, 0, 0, 1, 0, 2.5, -0.0], np.float32))
        ratio = 3 / 8
    else:
        flat, err = _tied(rng, 301), _tied(rng, 301, 0.125)
        ratio = {"random": 0.1, "no_ef": 0.1, "all": 1.0,
                 "one": 0.001}[case]
    j_cfg, t_cfg = _cfgs(ratio, ef=case != "no_ef")
    vj, ij, ej = jc.compress_topk(jnp.asarray(flat), j_cfg,
                                  jnp.asarray(err))
    vt, it, et = tc.compress_topk(torch.from_numpy(flat), t_cfg,
                                  torch.from_numpy(err))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(et), _bits(ej))
    dj = jc.decompress_topk(vj, ij, flat.shape[0])
    dt = tc.decompress_topk(vt, it, flat.shape[0])
    np.testing.assert_array_equal(_bits(dt), _bits(dj))
    if case == "tie_row":
        # the lowest index wins among the three 2's
        assert it.tolist() == [1, 3, 2]
    assert tc.compressed_size(flat.shape[0], t_cfg) == \
        jc.compressed_size(flat.shape[0], j_cfg)


@pytest.mark.parametrize("ratio,ef", [(0.05, True), (0.05, False),
                                      (0.5, True), (1.0, True),
                                      (0.001, True)])
def test_compress_topk_batch_matches_reference(ratio, ef):
    rng = np.random.RandomState(5)
    flats, errs = _tied(rng, (7, 263)), _tied(rng, (7, 263), 0.125)
    flats[0, :8] = TIE_ROW
    j_cfg, t_cfg = _cfgs(ratio, ef)
    dj, nj = jc.compress_topk_batch(flats, j_cfg, errs)
    dt, nt = tc.compress_topk_batch(torch.from_numpy(flats), t_cfg,
                                    torch.from_numpy(errs))
    np.testing.assert_array_equal(_bits(dt), _bits(dj))
    np.testing.assert_array_equal(_bits(nt), _bits(nj))
    # sent + kept is what was carried, exactly
    carried = flats + errs if ef else flats
    if ef:
        np.testing.assert_array_equal((dt + nt).numpy(), carried)


@pytest.mark.parametrize("n,m,s,e,ratio", [(6, 3, 257, 3, 0.05),
                                           (10_000, 3, 10_000, 1, 0.01),
                                           (4, 4, 10, 2, 0.001)])
def test_topk_closed_forms_match_reference(n, m, s, e, ratio):
    p = costmodel.CostParams(n=n, e=e, s=s, m=m)
    jp = j_costmodel.CostParams(n=n, e=e, s=s, m=m)
    assert costmodel.summary_topk(p, ratio) == \
        j_costmodel.summary_topk(jp, ratio)
    assert costmodel.phase1_msg_size_topk(p, ratio) == \
        j_costmodel.phase1_msg_size_topk(jp, ratio)


ROUND_CASES = [("plain", "additive", None), ("p2p", "additive", None),
               ("two_phase", "additive", None), ("two_phase", "shamir", None),
               ("two_phase", "additive", 4)]


def _round_flats(r, rows):
    return _tied(np.random.RandomState(100 + r), (rows, S), 0.0625)


@pytest.mark.parametrize("protocol,scheme,cohort", ROUND_CASES)
def test_compressed_rounds_match_reference(protocol, scheme, cohort):
    j_cfg, t_cfg = _cfgs(RATIO)
    kw = dict(m=M, scheme=scheme, seed=2, cohort=cohort)
    ref = JFLSimulation(N, compression=j_cfg, **kw)
    sim = FLSimulation(N, compression=t_cfg, device="cpu", **kw)
    rows = cohort or N
    for r in range(ROUNDS):
        flats = _round_flats(r, rows)
        ids = None
        if protocol != "two_phase":
            # the baselines run over the parties 1..N-1 in round 1
            ids = list(range(1, N)) if r == 1 else None
            flats = flats[1:] if r == 1 else flats
        mj, _ = ref.aggregate(protocol, jnp.asarray(flats), party_ids=ids)
        mt, _ = sim.aggregate(protocol, torch.from_numpy(flats),
                              party_ids=ids)
        if protocol == "plain":
            # a float32 mean of the same densified rows: the summation
            # order may differ by a few ulp
            np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(_bits(mt), _bits(mj))
    tj, tt = ref.transports[protocol], sim.transports[protocol]
    assert sorted(tj._err_state) == sorted(tt._err_slot)
    ids = sorted(tj._err_state)
    np.testing.assert_array_equal(
        _bits(tt.error_states(ids)),
        _bits(np.stack([tj._err_state[i] for i in ids])))
    for phase in ref.net.phases:
        assert dataclasses.astuple(sim.net.stats(phase)) == \
            dataclasses.astuple(ref.net.stats(phase)), phase
    # the counters against the top-k closed forms
    if protocol == "two_phase":
        e_rounds = ROUNDS
        p = costmodel.CostParams(n=N, e=e_rounds, s=S, m=M)
        if cohort is None:
            phase2 = sum(sim.net.stats(ph).msg_size for ph in (
                "phase2_upload", "phase2_exchange", "phase2_broadcast"))
            assert phase2 == costmodel.phase2_msg_size_topk(p, RATIO)
        else:
            k2 = costmodel.sparsified_s(p, RATIO)
            assert sim.net.stats("phase2_upload").msg_size == \
                ROUNDS * cohort * M * k2
    else:
        # rounds over N, N - 1 and N parties
        p = costmodel.CostParams(n=N, s=S)
        sizes = [N, N - 1, N]
        if protocol == "p2p":
            assert sim.net.stats("p2p").msg_size == sum(
                costmodel.p2p_msg_size_topk(dataclasses.replace(
                    p, n=l, e=1), RATIO) for l in sizes)
        else:
            assert sim.net.stats("plain").msg_size == sum(
                l * (l - 1) for l in sizes) * costmodel.sparsified_s(
                    p, RATIO)


def test_a_refused_round_leaves_the_residuals():
    _, t_cfg = _cfgs(RATIO)
    sim = FLSimulation(N, m=M, seed=2, compression=t_cfg, device="cpu")
    sim.aggregate("two_phase", torch.from_numpy(_round_flats(0, N)))
    tr = sim.transports["two_phase"]
    before = tr.error_states(range(N)).clone()
    stats = dataclasses.astuple(sim.net.stats())
    with pytest.raises(ValueError, match="additive sharing cannot"):
        tr.aggregate(torch.from_numpy(_round_flats(1, N)), round_index=1,
                     committee_dropout=[tr.committee[0]])
    assert torch.equal(tr.error_states(range(N)), before)
    assert dataclasses.astuple(sim.net.stats()) == stats


@pytest.mark.parametrize("where", ["vss", "flsim_wire", "api_wire",
                                   "flsim_wire_vss"])
def test_refusals_of_the_reference_are_kept(where, monkeypatch):
    from repro_torch.net import WireTransport

    def start(self):
        pytest.fail("the wire transport started")
    monkeypatch.setattr(WireTransport, "start", start)
    _, t_cfg = _cfgs(0.1)
    if where == "vss":
        with pytest.raises(ValueError, match="vss=True with top-k"):
            FLSimulation(4, scheme="shamir", vss=True, compression=t_cfg,
                         device="cpu")
    elif where == "flsim_wire":
        with pytest.raises(ValueError, match="not implemented on the wire"):
            FLSimulation(4, backend="wire", compression=t_cfg, device="cpu")
    elif where == "flsim_wire_vss":
        # the sim transport's refusal comes first, as in the reference
        with pytest.raises(ValueError, match="vss=True with top-k"):
            FLSimulation(4, scheme="shamir", vss=True, backend="wire",
                         compression=t_cfg, device="cpu")
    else:
        spec = api.ExperimentSpec(n=4, backend="wire", compress_topk=0.1)
        with pytest.raises(ValueError, match="not implemented on the wire"):
            api.make_transport(spec, device="cpu")


def test_one_train_step_with_compress_topk_matches_reference():
    """One two_phase additive step with ``compress_topk=0.1`` from the
    same perturbed smoke weights, a (1, 1) mesh against a world of
    one."""
    j_cfg = dataclasses.replace(j_get_config("qwen1.5-0.5b", smoke=True),
                                compute_dtype="float32")
    t_cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                                compute_dtype="float32")
    params = j_transformer.init(jax.random.PRNGKey(0), j_cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.RandomState(0)
    arrays = {"/".join(str(p) for p in path): np.asarray(leaf)
              + rng.randn(*leaf.shape).astype(np.float32) * 0.05
              for path, leaf in flat}
    tree = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays["/".join(str(p) for p in path)])
                  for path, _ in flat])
    toks, labels = lm_batch(256, 8, 16, seed=0, party=0, step=0)
    j_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    mesh = make_host_mesh(1, 1)
    wrap, _, _ = j_make_train_step(j_cfg, mesh, seed=0, fsdp=False,
                                   donate=False, compress_topk=0.1,
                                   opt=JAdamWConfig(lr=3e-4))
    step, sh = wrap({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in j_batch.items()})
    params = place(tree, sh["params"])
    opt = dict(j_adamw_init(params))
    opt["ef"] = j_init_ef(params, 1)
    with compat.set_mesh(mesh):
        p_j, o_j, loss_j = step(params, place(opt, sh["opt"]), jnp.int32(0),
                                j_batch)

    model = transformer.from_reference(t_cfg, arrays, device="cpu")
    t_step = make_train_step(t_cfg, seed=0, compress_topk=0.1,
                             opt=AdamWConfig(lr=3e-4), device="cpu")
    raw = {}

    def observe(dense, agg):
        raw.update((path_str(p), g.numpy()) for p, g in
                   flatten_with_path(dense))
    t_step.observe = observe
    t_opt = adamw_init(model.params())
    t_opt["ef"] = ef_row(join_ef_rows(
        [init_error_feedback(model.params(), 1)]), 0)
    model, t_opt, loss_t = t_step(model, t_opt, 0,
                                  {"tokens": toks, "labels": labels})
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = transformer.to_reference(model)
    exempt = total = 0
    ef_t = {path_str(p): e.numpy() for p, e in
            flatten_with_path(t_opt["ef"])}
    for path, w in jax.tree_util.tree_flatten_with_path(p_j)[0]:
        key = "/".join(str(p) for p in path)
        want = np.asarray(w, np.float64) - arrays[key]
        upd = np.asarray(got[key], np.float64) - arrays[key]
        # unsent elements are 0 on both sides and held like the rest
        near0 = (np.abs(raw[key]) < QUANTUM) & (raw[key] != 0)
        np.testing.assert_allclose(upd[~near0], want[~near0], rtol=0,
                                   atol=1e-6, err_msg=key)
        exempt += int(near0.sum())
        total += near0.size
    for path, e in jax.tree_util.tree_flatten_with_path(o_j["ef"])[0]:
        key = "/".join(str(p) for p in path)
        np.testing.assert_allclose(ef_t[key], np.asarray(e), rtol=0,
                                   atol=1e-6, err_msg=key)
        assert ef_t[key].shape == (1,) + arrays[key].shape
    assert exempt < 0.01 * total, (exempt, total)


def test_train_cli_runs_compress_topk_on_the_cpu():
    from repro_torch.launch import train
    out = train.run(train.parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "2", "--batch", "4",
         "--seq", "16", "--device", "cpu", "--compress-topk", "0.01"]))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    ef = dict(flatten_with_path(out["opt_state"]["ef"]))
    for path, p in flatten_with_path(out["model"].params()):
        assert ef[path].shape == (1,) + tuple(p.shape)
        assert bool(ef[path].abs().sum() > 0)
