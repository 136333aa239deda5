"""Whole Fed-PLT rounds of the port against ``repro.fed.api.build_trainer``.

Reduced gemma2-2b (fp32, 2 KV heads), 2 agents with 2 sequences of 64
tokens each, N_e = 2, gamma = 0.05, participation 1, 3 rounds; the same
parameters (the reference's init, converted) and the same numpy batch go
into both trainers.  Three configurations: the port's main path (packed +
fused edges + fused update, weight decay) against the reference's
packed + pallas + fused update; the tree layout with the fused edges
(leaves packed around each kernel); and both packages' defaults (tree
layout, unfused edges).  After 3 rounds the agent states and the consensus agree
to 1e-4 absolute and the loss metrics to 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.models.model import build_model

N, ROUNDS = 2, 3
CONFIGS = {
    "packed-fused": (dict(state_layout="packed", engine_backend="pallas",
                          use_pallas=True, weight_decay=0.01),
                     dict(state_layout="packed", engine_backend="fused",
                          use_fused_update=True, weight_decay=0.01)),
    "tree-fused": (dict(engine_backend="pallas", use_pallas=True),
                   dict(engine_backend="fused", use_fused_update=True)),
    "defaults": ({}, {}),
}


def _run(name):
    jkw, tkw = CONFIGS[name]
    common = dict(n_agents=N, n_epochs=2, gamma=0.05)
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    jtr = japi.build_trainer(jmodel, japi.FedSpec(**common, **jkw))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common, **tkw),
                             device="cpu")
    key = jax.random.PRNGKey(0)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    jstate = jtr.init(key)
    tstate, gen = ttr.init(0, params=params_from_jax(tree, tcfg))
    rng = np.random.default_rng(0)
    jm, tm = [], []
    kernels.reset_launch_counts()
    for i in range(ROUNDS):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 64)).astype(np.int32)
        lab = np.roll(tok, -1, axis=-1)
        jstate, m = jtr.step(jstate, {"tokens": jnp.asarray(tok),
                                      "labels": jnp.asarray(lab)},
                             jax.random.fold_in(key, i))
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = ttr.step(tstate, {"tokens": torch.from_numpy(tok).long(),
                                      "labels": torch.from_numpy(lab).long()},
                             gen)
        tm.append({k: float(v) for k, v in m.items()})
    return dict(jtr=jtr, ttr=ttr, jstate=jstate, tstate=tstate, jm=jm, tm=tm,
                counts=kernels.launch_counts())


@pytest.fixture(scope="module", params=list(CONFIGS))
def rounds(request):
    return _run(request.param)


def _jax_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = jcompress.unpack_leaves(x, trainer.packed_meta)
    return jax.tree_util.tree_map(np.asarray, x)


def _port_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = tcompress.unpack_leaves(x, trainer.packed_meta)
    return params_to_jax(x)


def _assert_trees_close(a, b, atol=1e-4):
    jax.tree_util.tree_map(
        lambda p, q: np.testing.assert_allclose(q, p, atol=atol, rtol=0), a, b)


def test_loss_metrics_match(rounds):
    for jm, tm in zip(rounds["jm"], rounds["tm"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        assert tm["participation"] == jm["participation"] == 1.0
    assert rounds["tm"][-1]["loss"] < rounds["tm"][0]["loss"]


@pytest.mark.parametrize("var", ["x", "z"])
def test_agent_states_match(rounds, var):
    _assert_trees_close(
        _jax_tree(rounds["jtr"], getattr(rounds["jstate"], var)),
        _port_tree(rounds["ttr"], getattr(rounds["tstate"], var)))


def test_consensus_matches(rounds):
    jc = jax.tree_util.tree_map(np.asarray,
                                rounds["jtr"].consensus(rounds["jstate"]))
    _assert_trees_close(jc, params_to_jax(
        rounds["ttr"].consensus(rounds["tstate"])))


def test_cpu_rounds_launch_no_kernel(rounds):
    """On the CPU every op takes its plain version: no kernel launches."""
    assert set(rounds["counts"].values()) == {0}
