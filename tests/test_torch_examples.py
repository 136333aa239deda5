"""The seven ``examples/*_torch.py`` twins against the reference's examples,
on the CPU.

Each twin takes the problem or the model's parameters and the draws, so
the reference's go in:

* quickstart: the reference's problem (``convert.problem_from_arrays``),
  its 50% run's realised participation rows (``run_recorded``) and its
  ``x*`` (``solve()``): the same hitting rounds (200 / 400 rounds) and
  ``||x_bar - x*||`` within 1e-5 of the reference's; FedAvg (cut to 100
  rounds) never reaches the threshold.
* private: tau and both reports' eps to 1e-12; the 300 rounds of noisy GD
  on the reference's initial models (``dp_init``) and noise, derived from
  its keys as ``tests/test_torch_rounds_dense.py`` derives them (the
  round key split 3 ways, ``split(k_solve, N)[i]`` split into one key an
  epoch, ``normal(split(k_e)[1], (n,))``): every round's criterion within
  1e-4 relative (noisy GD settles at a floor near 0.01, set by the noise,
  where float32 rounding is a few ulps of the iterates).
* compressed: each row's hitting round equal.  The horizon is cut from
  600 rounds to 50 (the rows hit at 27-44; 600 rounds of six rows in both
  packages cost about 40 s, most of this file's budget).
* async: the reference's broker run and its recorded schedule; the
  twin's replay of that schedule with the reference's noise equals the
  reference's replay to 1e-5 (x, z, y_tag; the staleness counters
  exactly).
* ``train_lm_federated_torch`` shrunk (2 layers, d 64, vocab 512, 4 / 2
  heads of 16, d_ff 128): the reference's parameters
  (``convert.params_from_jax``), two numpy batches and the reference's
  participation rows: the 2 rounds' losses within 1e-6 relative and the
  states within 1e-4.
* ``serve_lm_torch`` at temperature 0 and ``serve_stream`` on the same
  shrunk parameters and ragged prompts give the tokens of the
  reference's greedy ``repro.launch.serve.generate``; every
  continuous-batching request equals itself served alone.
* Each twin's ``main(["--device", "cpu", ...small sizes])`` returns
  finite numbers; without ``--device cpu`` on a machine without a card
  each raises.

About 56 s in one process.
"""

import argparse
import dataclasses
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import metrics as jmetrics
from repro.core import privacy as jprivacy
from repro.core import theory as jtheory
from repro.core.problem import make_logreg_problem as jax_logreg
from repro.fed import api as japi
from repro.fed.broker import IncrementBroker as JaxBroker
from repro.fed.broker import replay as jax_replay
from repro.launch.serve import generate as jax_generate
from repro.models.model import build_model as jax_build_model
from repro_torch.convert import params_from_jax, problem_from_arrays
from repro_torch.fed import api as tapi
from repro_torch.launch.serve import generate
from repro_torch.models.model import build_model

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart", "private_training", "compressed_training",
         "async_training", "train_lm_federated", "serve_lm",
         "continuous_batching")


def twin(name: str):
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(*a):
    pass


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The dense problems are tiny: one intra-op thread runs their many
    small ops faster than a thread pool does.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_port(jp):
    return problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b))


@pytest.fixture(scope="module")
def paper():
    jp = jax_logreg(n_agents=100, q=250, dim=5, seed=0)
    return jp, _as_port(jp)


def noise_chain(key, n_rounds, n_agents, n_epochs, dim):
    """The reference's noisy-GD draws ``(n_rounds, N_e, N, n)`` of the
    rounds that start from the state key ``key``."""
    def body(k, _):
        k, _, k_solve = jax.random.split(k, 3)
        epochs = jax.vmap(lambda a: jax.random.split(a, n_epochs))(
            jax.random.split(k_solve, n_agents))
        z = jax.vmap(jax.vmap(lambda e: jax.random.normal(
            jax.random.split(e)[1], (dim,))))(epochs)
        return k, jnp.swapaxes(z, 0, 1)

    return np.asarray(jax.lax.scan(jax.jit(body), key, None,
                                   length=n_rounds)[1])


# ---------------------------------------------------------------------------
# The dense twins
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference(paper):
    jp, tp = paper
    key = jax.random.PRNGKey(0)
    jtr = japi.build_trainer(jp, japi.FedSpec(rho=1.0, n_epochs=5))
    jstate, jcrit = jtr.run(key, 200)
    _, jcrit_pp, sched = japi.build_trainer(jp, japi.FedSpec(
        rho=1.0, n_epochs=5, participation=0.5)).run_recorded(key, 400)
    x_star = np.asarray(jp.solve())
    ref_err = float(np.linalg.norm(np.asarray(jtr.consensus(jstate))
                                   - x_star))
    got = twin("quickstart").run(tp, "cpu", (200, 400, 100),
                                 u=np.array(sched), x_star=x_star,
                                 log=quiet)
    assert got["hit"] == jmetrics.hitting_round(np.asarray(jcrit)) == 10
    assert got["hit_pp"] == jmetrics.hitting_round(np.asarray(jcrit_pp))
    assert got["hit_pp"] is not None
    assert abs(got["x_bar_err"] - ref_err) <= 1e-5
    assert jmetrics.hitting_round(got["crit_avg"]) is None  # FedAvg drifts


def test_private_matches_reference(paper):
    jp, tp = paper
    K, delta = 300, 1e-5
    mu, L = jp.strong_convexity(), jp.smoothness()
    stab = jtheory.stabilize(mu, L, n_epochs_grid=(5,))
    tau = jprivacy.calibrate_noise(2.0, delta, sensitivity=1.0, mu=mu,
                                   q=jp.q, gamma=stab.gamma, K=K,
                                   n_epochs=stab.n_epochs)
    jtr = japi.build_trainer(jp, japi.FedSpec(
        rho=stab.rho, gamma=stab.gamma, n_epochs=stab.n_epochs,
        privacy=japi.PrivacySpec(tau=tau, dp_init=True, delta=delta)))
    rep = jtr.privacy_report(K)
    qs = [50] * 5 + [jp.q] * (jp.n_agents - 5)
    rep_i = jtr.privacy_report(K, local_dataset_size=qs)
    key = jax.random.PRNGKey(0)
    s0 = jtr.init(key)
    noise = noise_chain(s0.key, K, jp.n_agents, stab.n_epochs, jp.dim)
    _, jcrit = jtr.run(key, K)
    got = twin("private_training").run(tp, "cpu", K, x0=np.asarray(s0.x),
                                       noise=noise, log=quiet)
    assert (got["stabilizer"].rho, got["stabilizer"].gamma,
            got["stabilizer"].n_epochs) == pytest.approx(
                (stab.rho, stab.gamma, stab.n_epochs), rel=1e-12)
    assert got["tau"] == pytest.approx(tau, rel=1e-12)
    for mine, ref in ((got["report"], rep),
                      (got["report_per_agent"], rep_i)):
        assert mine.adp_eps == pytest.approx(ref.adp_eps, rel=1e-12)
        assert mine.eps_ceiling == pytest.approx(ref.eps_ceiling, rel=1e-12)
    assert got["report_per_agent"].per_agent[-1].adp_eps == pytest.approx(
        rep_i.per_agent[-1].adp_eps, rel=1e-12)
    np.testing.assert_allclose(got["crit"], np.asarray(jcrit), rtol=1e-4)


COMPRESSED_ROUNDS = 50


def test_compressed_rows_match_reference():
    jp = jax_logreg(n_agents=100, q=250, dim=20, seed=0)
    tp = _as_port(jp)
    cp = twin("compressed_training")
    ref_rows = {
        "exact": japi.CompressionSpec(),
        "int8": japi.CompressionSpec(name="int8"),
        "topk 25%": japi.CompressionSpec(name="topk", ratio=0.25),
        "topk 10%": japi.CompressionSpec(name="topk", ratio=0.1),
        "adaptive": japi.CompressionSpec(name="adaptive_topk", ratio=0.1,
                                         energy=0.9),
        "adaptive/fused": japi.CompressionSpec(
            name="adaptive_topk", ratio=0.1, energy=0.9, backend="pallas"),
    }
    got = cp.run(tp, "cpu", COMPRESSED_ROUNDS, log=quiet)
    assert list(got) == list(ref_rows)
    for name, comp in ref_rows.items():
        _, crit = japi.build_trainer(jp, japi.FedSpec(
            rho=1.0, n_epochs=5, compression=comp)).run(
                jax.random.PRNGKey(0), COMPRESSED_ROUNDS)
        want = jmetrics.hitting_round(np.asarray(crit))
        assert want is not None
        assert got[name]["rounds"] == want, name


def test_async_replay_of_the_reference_schedule():
    asy = twin("async_training")
    jp = jax_logreg(n_agents=asy.N_AGENTS, q=200, dim=5, seed=0)
    jspec = japi.FedSpec(rho=5.0, gamma=0.05, n_epochs=5, damping=0.5,
                         participation=0.8, async_mode="stale",
                         max_staleness=asy.MAX_STALENESS,
                         privacy=japi.PrivacySpec(tau=0.3, clip=1.0,
                                                  delta=1e-5))
    jtr = japi.build_trainer(jp, jspec)
    key = jax.random.PRNGKey(0)
    step = lambda s, u: jtr.algo.round_with_arrival(s, u)[0]  # noqa: E731
    broker = JaxBroker(asy.N_AGENTS, asy.MAX_STALENESS,
                       latency_fn=asy.straggler_latency, grace=0.003)
    _, sched = broker.run(step, jtr.init(key), asy.ROUNDS)
    want = jax_replay(step, jtr.init(key), sched)
    noise = noise_chain(jtr.init(key).key, asy.ROUNDS, asy.N_AGENTS, 5, 5)
    ttr = tapi.build_trainer(_as_port(jp), asy.SPEC, device="cpu")
    got = asy.replay_run(ttr, sched.arrivals, noise=noise)
    for var in ("x", "z", "y_tag"):
        np.testing.assert_allclose(getattr(got, var).numpy(),
                                   np.asarray(getattr(want, var)),
                                   rtol=1e-5, atol=1e-5, err_msg=var)
    np.testing.assert_array_equal(got.staleness.numpy(),
                                  np.asarray(want.staleness))
    # the stale-aware table of the realised schedule, field for field
    for a, b in zip(ttr.effective_privacy_report(sched.arrivals).per_agent,
                    jtr.effective_privacy_report(sched.arrivals).per_agent):
        assert (a.arrivals, a.K) == (b.arrivals, b.K)
        assert a.adp_eps == pytest.approx(b.adp_eps, rel=1e-12)


# ---------------------------------------------------------------------------
# The model twins (one shrunk gemma2-family model for all three)
# ---------------------------------------------------------------------------

SHRUNK = dict(n_layers=2, d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128)
N_AGENTS, ROUNDS = 4, 2


@pytest.fixture(scope="module")
def shrunk():
    lm = twin("train_lm_federated")
    tcfg = lm.lm_config(**SHRUNK)
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b"), window=64,
                               dtype="float32", **SHRUNK)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    return dict(lm=lm, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                tmodel=build_model(tcfg), tree=tree,
                params=params_from_jax(tree, tcfg))


def test_lm_twin_rounds_match_reference(shrunk):
    lm = shrunk["lm"]
    args = argparse.Namespace(n_agents=N_AGENTS, n_epochs=3, tau=0.0,
                              participation=0.75, agent_groups=None)
    jtr = japi.build_trainer(shrunk["jmodel"], japi.FedSpec(
        n_agents=N_AGENTS, rho=1.0, gamma=0.1, n_epochs=3,
        participation=0.75, privacy=japi.PrivacySpec(tau=0.0, clip=None)))
    ttr = lm.make_trainer(shrunk["tmodel"], args, "cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 512, (N_AGENTS, 2, 16)).astype(np.int32)
            for _ in range(ROUNDS)]
    jstate = jtr.init(jax.random.PRNGKey(0))
    jlosses, u_rows = [], []
    for i, tok in enumerate(toks):
        k = jax.random.PRNGKey(i)
        _, k_part, _ = jax.random.split(jax.random.fold_in(k, i), 3)
        u_rows.append(torch.from_numpy(np.asarray(
            jax.random.bernoulli(k_part, 0.75, (N_AGENTS,)), np.float32)))
        jstate, m = jtr.step(jstate, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.roll(jnp.asarray(tok),
                                                         -1, axis=-1)}, k)
        jlosses.append(float(m["loss"]))
    tstate, gen = ttr.init(0, params=shrunk["params"])
    batches = iter([{"tokens": torch.from_numpy(t).long(),
                     "labels": torch.from_numpy(np.roll(t, -1, -1)).long()}
                    for t in toks])
    tstate, hist = lm.train(ttr, tstate, batches, ROUNDS, gen,
                            u_rows=u_rows, log=quiet)
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, rtol=1e-6)
    assert [h["participation"] for h in hist] == [
        float(u.mean()) for u in u_rows]
    for var in ("x", "z"):
        # params_from_jax keeps the leading agent axis of a stacked state
        want = params_from_jax(jax.tree_util.tree_map(
            np.asarray, getattr(jstate, var)), shrunk["tcfg"])
        for name, leaf in getattr(tstate, var).items():
            np.testing.assert_allclose(leaf.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{var} {name}")


PROMPT_LENS = (4, 7, 4, 7, 7, 4)
GEN_LEN, SLOTS = 5, 3


def test_serving_twins_give_the_reference_tokens(shrunk):
    rng = np.random.default_rng(1)
    queue = [rng.integers(0, 512, n).tolist() for n in PROMPT_LENS]
    cache_len = max(PROMPT_LENS) + GEN_LEN
    want = {}
    for n in sorted(set(PROMPT_LENS)):
        ids = [i for i, q in enumerate(queue) if len(q) == n]
        out = np.asarray(jax_generate(
            shrunk["jmodel"], jax.tree_util.tree_map(jnp.asarray,
                                                     shrunk["tree"]),
            jnp.asarray([queue[i] for i in ids], jnp.int32), GEN_LEN,
            cache_len))
        want.update({i: out[j].tolist() for j, i in enumerate(ids)})
    model, params = shrunk["tmodel"], shrunk["params"]
    # serve_lm_torch: one batched call at temperature 0
    sv = twin("serve_lm")
    for n in sorted(set(PROMPT_LENS)):
        ids = [i for i, q in enumerate(queue) if len(q) == n]
        out, _ = sv.serve(model, params,
                          torch.tensor([queue[i] for i in ids]), GEN_LEN,
                          temperature=0.0)
        assert [out[j].tolist() for j in range(len(ids))] == \
            [want[i] for i in ids]
    # continuous_batching_torch: the ragged stream through 3 slots
    res = twin("continuous_batching").serve_stream(
        model, params, queue, SLOTS, GEN_LEN, "cpu", cache_len=cache_len)
    assert res["steps"] < res["naive_steps"]
    for i, prompt in enumerate(queue):
        alone = generate(model, params, torch.tensor([prompt]), GEN_LEN,
                         cache_len)[0].tolist()
        assert res["done"][i] == alone == want[i], i


# ---------------------------------------------------------------------------
# Each twin's main
# ---------------------------------------------------------------------------

SMALL = {
    "quickstart": ["--n-agents", "10", "--rounds", "20", "20", "20",
                   "--solve-iters", "200"],
    "private_training": ["--n-agents", "10", "--rounds", "20"],
    "compressed_training": ["--n-agents", "10", "--rounds", "40"],
    "async_training": ["--rounds", "6"],
    "train_lm_federated": ["--rounds", "2", "--seq-len", "16", "--batch",
                           "8"],
    "serve_lm": ["--requests", "2", "--prompt-len", "4", "--gen-len", "3"],
    "continuous_batching": ["--requests", "3", "--max-prompt", "5",
                            "--gen-len", "2"],
}


def _numbers(res):
    """The finite-checkable numbers a main returns."""
    if isinstance(res, dict):
        for v in res.values():
            yield from _numbers(v)
    elif isinstance(res, (list, tuple)):
        for v in res:
            yield from _numbers(v)
    elif isinstance(res, (int, float)) and not isinstance(res, bool):
        yield float(res)
    elif isinstance(res, np.ndarray):
        yield from (float(v) for v in res.ravel())
    elif isinstance(res, torch.Tensor) and res.is_floating_point():
        yield from (float(v) for v in res.detach().ravel()[:1000])


@pytest.mark.parametrize("name", TWINS)
def test_main_runs_on_the_cpu_and_returns_finite_numbers(name):
    mod = twin(name)
    if name == "train_lm_federated":     # the shrunk model, not ~100M
        mod.lm_config = functools.partial(mod.lm_config, **SHRUNK)
    res = mod.main(["--device", "cpu"] + SMALL[name], log=quiet)
    nums = list(_numbers(res))
    assert nums and all(math.isfinite(v) for v in nums), name


def test_lm_twin_groups_privacy_and_checkpoint(tmp_path):
    """``--agent-groups``, ``--tau`` and ``--checkpoint``: the per-agent
    privacy table, the groups' participation, the consensus saved through
    the port's ``save_checkpoint`` and restored equal."""
    from repro_torch.checkpoint import restore_checkpoint

    mod = twin("train_lm_federated")
    mod.lm_config = functools.partial(mod.lm_config, **SHRUNK)
    lines = []
    path = str(tmp_path / "ckpt")
    res = mod.main(["--device", "cpu", "--rounds", "2", "--seq-len", "16",
                    "--tau", "0.01", "--agent-groups",
                    "2*gd,2*gd:n_epochs=1:participation=0.5",
                    "--checkpoint", path],
                   log=lambda *a: lines.append(" ".join(map(str, a))))
    assert sum(line.startswith("  agent ") for line in lines) == N_AGENTS
    assert any(line.startswith("checkpoint saved:") for line in lines)
    like = {k: torch.zeros_like(v) for k, v in res["consensus"].items()}
    back = restore_checkpoint(path, like, "cpu")
    for k, v in res["consensus"].items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", TWINS)
def test_main_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the twin would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        twin(name).main(SMALL[name], log=quiet)
