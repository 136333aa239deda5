"""Bounded-staleness async rounds of the port against the reference's, on
the CPU.

* The dense quadratic problem (the reference's
  ``make_quadratic_problem(n_agents=6, dim=8, seed=3)``, gd, 3 epochs,
  gamma 0.05, participation 0.6, damping 0.7), 10 rounds: the reference's
  ``run_recorded`` (tree layout, xla backend) at ``max_staleness`` 0 and
  3 under each compressor (none, topk, int8), its realised schedule fed
  to the port row by row as ``arrival=`` under both layouts and both
  backends (fused = the plain versions here).  A realised row holds its
  forced arrivals, so the port realises it exactly: the arrival rows and
  the staleness counters are equal, ``x``, ``z``, ``t``, ``y_tag`` and
  the criterion agree to 1e-5 relative (1e-6 absolute).  The
  reference's own K = 0 rounds are not held to its synchronous ones bit
  for bit (its XLA fuses the two differently); the port's are, in every
  case, with generator draws.
* Reduced gemma2-2b (fp32, 2 KV heads, N 4, 2 sequences of 16 tokens an
  agent, K 2, participation 0.5): 4 rounds of the reference's
  ``ModelTrainer.step`` from its seeded parameters (tree layout; its
  packed layout is the same trajectory per realisation), its realised
  arrival rows given to the port's ``step(arrival=)`` in the packed
  (fused) and the tree (torch) layout; states 1e-4, losses 1e-6
  relative, rows and counters equal.
* Schedules: ``effective_counts`` / ``validate_schedule`` equal to the
  reference's on seeded schedules with and without a live matrix, the
  same errors; ``effective_privacy_report`` field for field.
* ``run_recorded`` then ``replay`` bit for bit (noisy GD: the replay
  consumes the recording's participation draws).
* Async checkpoints across the packages (float32, packed and tree):
  ``.y_tag`` and ``.staleness`` restored bit for bit both ways.
* The CLI: ``--async-mode stale --max-staleness 2`` through ``run_fed``
  with a checkpoint and a resume, bit for bit with the arrival rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jax_get_config
from repro.core.problem import make_quadratic_problem
from repro.fed import api as japi
from repro.fed import async_engine as jasync
from repro.fed import compress as jcompress
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, quadratic_from_arrays
from repro_torch.fed import api as tapi
from repro_torch.fed import async_engine as tasync
from repro_torch.fed import compress as tcompress
from repro_torch.models.model import build_model

N, ROUNDS = 6, 10
BACKENDS = {"torch": "xla", "fused": "pallas"}
DENSE = dict(n_epochs=3, gamma=0.05, participation=0.6, damping=0.7)
CASES = [(layout, backend, comp) for layout in ("tree", "packed")
         for backend in ("torch", "fused")
         for comp in ("none", "topk", "int8")]
IDS = ["-".join(c) for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quad():
    jq = make_quadratic_problem(n_agents=N, dim=8, seed=3)
    return jq, quadratic_from_arrays(np.asarray(jq.Q), np.asarray(jq.c))


@pytest.fixture(scope="module")
def reference_runs(quad):
    """The reference's recorded runs, one per (compressor, K)."""
    return {}


def _reference_run(reference_runs, quad, comp, K):
    if (comp, K) not in reference_runs:
        tr = japi.build_trainer(quad[0], japi.FedSpec(
            **DENSE, compression=japi.CompressionSpec(comp),
            async_mode="stale", max_staleness=K))
        st, crit, sched = tr.run_recorded(jax.random.PRNGKey(42), ROUNDS)
        reference_runs[comp, K] = dict(
            x=st.x, z=st.z, t=st.t, y_tag=st.y_tag, staleness=st.staleness,
            crit=crit, sched=np.asarray(sched, np.float32))
    return reference_runs[comp, K]


def _dense_spec(layout, backend, comp, K=None):
    kw = {} if K is None else dict(async_mode="stale", max_staleness=K)
    return tapi.FedSpec(**DENSE, state_layout=layout, engine_backend=backend,
                        compression=tapi.CompressionSpec(comp), **kw)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("K", [0, 3])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_async_matches_reference(reference_runs, quad, case, K):
    ref = _reference_run(reference_runs, quad, case[2], K)
    tr = tapi.build_trainer(quad[1], _dense_spec(*case, K), "cpu")
    state = tr.init(0)
    crit = []
    for row in ref["sched"]:
        state, u = tr.round_with_faults(state, arrival=torch.from_numpy(row))
        np.testing.assert_array_equal(u.numpy(), row)
        crit.append(float(tr.algo.criterion(state)))
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(ref["staleness"]))
    for var in ("x", "z", "y_tag") + (("t",) if case[2] != "none" else ()):
        _close(getattr(state, var), ref[var])
    _close(crit, ref["crit"])
    if K:   # the stale path ran: an agent arrived with work 1+ rounds old
        arrivals, released = tasync.effective_counts(ref["sched"], K)
        assert (released > arrivals).any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k0_async_is_the_synchronous_round_bit_for_bit(quad, case):
    sync = tapi.build_trainer(quad[1], _dense_spec(*case), "cpu")
    asy = tapi.build_trainer(quad[1], _dense_spec(*case, 0), "cpu")
    s_state, s_crit = sync.run(42, ROUNDS)
    a_state, a_crit, sched = asy.run_recorded(42, ROUNDS)
    for var in ("x", "z", "t", "y"):
        a, b = getattr(s_state, var), getattr(a_state, var)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), var
    assert torch.equal(s_crit, a_crit)
    assert 0 < float(sched.sum()) < ROUNDS * N
    assert not a_state.staleness.any()


def test_recorded_run_replays_bit_for_bit(quad):
    """noisy GD: the noise comes from the generator after each round's
    participation draw, which the replay consumes too."""
    spec = dataclasses.replace(
        _dense_spec("packed", "fused", "none", 2),
        privacy=tapi.PrivacySpec(tau=0.05))
    tr = tapi.build_trainer(quad[1], spec, "cpu")
    state, crit, sched = tr.run_recorded(5, ROUNDS)
    back, crit2 = tr.replay(5, sched)
    for var in ("x", "z", "y_tag", "staleness"):
        assert torch.equal(getattr(state, var), getattr(back, var)), var
    assert torch.equal(crit, crit2)
    assert state.staleness.any() or (sched.sum(1) < N).any()
    with pytest.raises(ValueError, match="async_mode='stale'"):
        tapi.build_trainer(quad[1], _dense_spec("tree", "torch", "none"),
                           "cpu").replay(0, sched)
    with pytest.raises(ValueError, match="async_mode='stale'"):
        tapi.build_trainer(quad[1], _dense_spec("tree", "torch", "none"),
                           "cpu").round_with_faults(state, arrival=sched[0])


# ---------------------------------------------------------------------------
# Schedules and the effective privacy report
# ---------------------------------------------------------------------------

def _schedules():
    rng = np.random.default_rng(11)
    out = []
    for K in (0, 1, 3):
        sched = (rng.random((12, 5)) < 0.5).astype(np.float32)
        out.append((sched, K, None))
        live = np.ones_like(sched)
        live[4:8, 2] = 0.0
        out.append((sched * live, K, live))
    return out


@pytest.mark.parametrize("i", range(6))
def test_schedule_analysis_matches_reference(i):
    sched, K, live = _schedules()[i]
    for a, b in zip(jasync.effective_counts(sched, K, live),
                    tasync.effective_counts(sched, K, live)):
        np.testing.assert_array_equal(a, b)

    def outcome(fn, *args):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return None

    for s, lv in ((sched, live), (np.ones_like(sched), live),
                  (np.zeros_like(sched), None), (sched[0], None)):
        assert outcome(jasync.validate_schedule, s, K, lv) == outcome(
            tasync.validate_schedule, s, K, lv)
    with pytest.raises(ValueError, match="live matrix shape"):
        tasync.effective_counts(sched, K, np.ones((2, 2)))


@pytest.mark.parametrize("q", [100, [50, 60, 70, 80, 90]])
def test_effective_privacy_report_matches_reference(q):
    sched, K, _ = _schedules()[4]
    kw = dict(n_agents=5, gamma=0.05, n_epochs=3, async_mode="stale",
              max_staleness=K)
    want = japi.effective_privacy_report(
        japi.FedSpec(**kw, privacy=japi.PrivacySpec(tau=0.1, clip=1.0)),
        sched, q)
    got = tapi.effective_privacy_report(
        tapi.FedSpec(**kw, privacy=tapi.PrivacySpec(tau=0.1, clip=1.0)),
        sched, q)
    assert len(got.per_agent) == len(want.per_agent) == 5
    for a, b in zip(got.per_agent, want.per_agent):
        assert dataclasses.asdict(a) == pytest.approx(dataclasses.asdict(b))
    for f in ("adp_eps", "adp_delta", "K", "n_epochs", "rdp_order",
              "eps_ceiling"):
        assert getattr(got, f) == pytest.approx(getattr(want, f)), f
    with pytest.raises(ValueError, match="tau > 0"):
        tapi.effective_privacy_report(tapi.FedSpec(**kw), sched, 100)


# ---------------------------------------------------------------------------
# Reduced gemma2-2b through ModelTrainer.step(arrival=)
# ---------------------------------------------------------------------------

MODEL_N, MODEL_ROUNDS = 4, 4
MODEL = dict(n_agents=MODEL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
             participation=0.5, async_mode="stale", max_staleness=2)


def _configs():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    return jcfg, tcfg


def _model_batches(vocab):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(MODEL_ROUNDS):
        tok = rng.integers(0, vocab, (MODEL_N, 2, 16))
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=-1)})
    return out


def _port_tree(ttr, buf):
    return (dict(tcompress.unpack_leaves(buf, ttr.packed_meta))
            if ttr.packed_meta is not None else dict(buf))


@pytest.fixture(scope="module")
def reference_model_run():
    """4 rounds of the reference's ``ModelTrainer.step`` (tree layout,
    xla: its packed layout is the same trajectory per realisation), from
    its seeded parameters: the start, the realised rows, the losses and
    the final ``x``, ``z``, ``y_tag`` (as port-named arrays) and
    counters."""
    jcfg, tcfg = _configs()
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        **MODEL, state_layout="tree"))
    key = jax.random.PRNGKey(0)
    jstate = jtr.init(key)
    rows, losses = [], []
    for r, b in enumerate(_model_batches(tcfg.vocab)):
        jstate, m = jtr.step(jstate, {k: jnp.asarray(v.astype(np.int32))
                                      for k, v in b.items()},
                             jax.random.fold_in(key, r))
        rows.append(np.asarray(m["arrivals"], np.float32))
        losses.append(float(m["loss"]))
    x0 = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(key))
    out = {var: params_from_jax(jax.tree_util.tree_map(
        np.asarray, getattr(jstate, var)), tcfg)
        for var in ("x", "z", "y_tag")}
    return dict(out, start=params_from_jax(x0, tcfg), rows=rows,
                losses=losses, staleness=np.asarray(jstate.staleness))


@pytest.mark.parametrize("layout", ["packed", "tree"])
def test_model_async_rounds_match_reference(reference_model_run, layout):
    ref = reference_model_run
    rows = np.stack(ref["rows"])
    arrivals, released = tasync.effective_counts(rows, 2)
    assert (released > arrivals).any(), "no stale arrival in the schedule"
    _, tcfg = _configs()
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(
        **MODEL, state_layout=layout,
        engine_backend="fused" if layout == "packed" else "torch",
        use_fused_update=layout == "packed"), "cpu")
    state, gen = ttr.init(0, params=ref["start"])
    for r, b in enumerate(_model_batches(tcfg.vocab)):
        state, m = ttr.step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, gen,
                            arrival=torch.from_numpy(rows[r]))
        np.testing.assert_array_equal(m["arrivals"].numpy(), rows[r])
        np.testing.assert_allclose(float(m["loss"]), ref["losses"][r],
                                   rtol=1e-6)
    np.testing.assert_array_equal(state.staleness.numpy(), ref["staleness"])
    for var in ("x", "z", "y_tag"):
        got = _port_tree(ttr, getattr(state, var))
        for n, want in ref[var].items():
            np.testing.assert_allclose(got[n].numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=n)


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _ckpt_trainers(layout):
    common = dict(n_agents=2, n_epochs=1, gamma=0.05, state_layout=layout,
                  async_mode="stale", max_staleness=2)
    jcfg = jax_get_config("gemma2-2b").reduced()
    tcfg = get_config("gemma2-2b").reduced()
    return (japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**common)),
            tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common),
                               device="cpu"))


def _named(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def _same(jtr, ttr, jbuf, tbuf):
    if jtr.packed_meta is not None:
        jbuf = jcompress.unpack_leaves(jbuf, jtr.packed_meta)
    want, got = _named(jbuf), _port_tree(ttr, tbuf)
    assert set(want) == set(got)
    for n in want:
        assert np.array_equal(want[n].view(np.uint32),
                              got[n].numpy().view(np.uint32)), n


@pytest.mark.parametrize("layout", ["packed", "tree"])
def test_async_checkpoints_across_packages(tmp_path, layout):
    jtr, ttr = _ckpt_trainers(layout)
    like, gen = ttr.init(0)
    g = torch.Generator().manual_seed(1)
    fields = {}
    for var in ("x", "z", "y_tag"):
        tree = {n: torch.randn(l.shape, generator=g)
                for n, l in _port_tree(ttr, getattr(like, var)).items()}
        fields[var] = (tcompress.pack_leaves(tree, ttr.packed_meta)[0]
                       if layout == "packed" else tree)
    tstate = like._replace(step=3, staleness=torch.tensor(
        [2, 0], dtype=torch.int32), **fields)
    path = str(tmp_path / "port")
    ttr.save_state(path, tstate, gen, extra={"round": 3,
                                             "arrivals": [[1.0, 0.0]]})
    jlike = jax.eval_shape(jtr.init, jax.random.PRNGKey(0))
    jstate = jio.restore_checkpoint(path, jlike)
    np.testing.assert_array_equal(np.asarray(jstate.staleness), [2, 0])
    for var in ("x", "z", "y_tag"):
        _same(jtr, ttr, getattr(jstate, var), getattr(tstate, var))

    # and back: the reference's file in the port
    jstate = jstate._replace(staleness=jnp.asarray([1, 2], jnp.int32),
                             y_tag=jax.tree_util.tree_map(
                                 lambda l: l * 2.0, jstate.y_tag))
    path = str(tmp_path / "ref")
    jio.save_checkpoint(path, jstate, step=3, extra={"round": 3})
    back, extra = ttr.restore_state(path, ttr.init(1)[0])
    assert back.staleness.tolist() == [1, 2] and extra["round"] == 3
    for var in ("x", "z", "y_tag"):
        _same(jtr, ttr, getattr(jstate, var), getattr(back, var))


# ---------------------------------------------------------------------------
# The CLI and run_fed's resume
# ---------------------------------------------------------------------------

def test_async_cli_resume_bit_for_bit(tmp_path):
    from repro_torch.checkpoint import checkpoint_extra
    from repro_torch.launch.train import run_fed

    spec = tapi.spec_from_args(["--async-mode", "stale", "--max-staleness",
                                "2", "--n-agents", "2", "--participation",
                                "0.5", "--n-epochs", "1",
                                "--state-layout", "packed"])
    assert spec.staleness_config() == tapi.engine.StalenessConfig("stale", 2)
    cfg = get_config("gemma2-2b").reduced()
    lines = []
    kw = dict(seq_len=16, batch=2, device="cpu", checkpoint_every=2,
              log=lines.append)
    _, whole, hist = run_fed(cfg, spec, steps=4,
                             checkpoint=str(tmp_path / "whole"), **kw)
    run_fed(cfg, spec, steps=2, checkpoint=str(tmp_path / "split"), **kw)
    _, split, _ = run_fed(cfg, spec, steps=4, resume=True,
                          checkpoint=str(tmp_path / "split"), **kw)
    for var in ("x", "z", "y_tag", "staleness"):
        assert torch.equal(getattr(whole, var), getattr(split, var)), var
    rows = [checkpoint_extra(str(tmp_path / leg / "rounds" / "step-000004"))[
        "arrivals"] for leg in ("whole", "split")]
    assert rows[0] == rows[1] == [h["arrivals"] for h in hist]
    assert len(rows[0]) == 4
    assert any("stale=" in line for line in lines)
