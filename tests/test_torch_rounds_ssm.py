"""Whole Fed-PLT rounds of the port on the SSM and RG-LRU model kinds
against ``repro.fed.api.build_trainer``.

Reduced falcon-mamba-7b (2 ``ssm`` layers) and recurrentgemma-2b with 3
layers (``rec, rec, local``), 4 agents with 2 sequences of 32 tokens
each, N_e = 2, gamma = 0.05, participation 1; the same parameters (the
reference's init, converted) and the same numpy batches go into both
trainers.

* float32, 3 rounds, two configurations: the packed layout with the
  fused edges and the fused update (weight decay 0.01) against the
  reference's packed + pallas + fused update, and the tree layout with
  the fused backend against the reference's tree + pallas.  The agent
  states and the consensus agree to 1e-4 absolute, the losses to 1e-6
  relative.
* bfloat16 (the published dtype: a mixed tree, since ``dt_bias``,
  ``A_log``, ``D`` and ``lam`` stay float32), 2 rounds in the tree
  layout: the round edges run per leaf in plain code (the fused edge
  needs one dtype) and the fused update once per leaf, in both packages.
  bf16 rounds at other places in the two frameworks (XLA fuses the
  elementwise chains of a layer and rounds once where PyTorch rounds each
  op), and the trajectories part at that level: each leaf is held to
  four bf16 ulps of its largest entry (2^-5 of it) elementwise and to 2%
  relative in norm, the losses to 1e-3 relative (measured after 2
  rounds: at most 1.6% of a leaf's largest entry, 1.4% in norm, both in
  an RG-LRU ``conv_b`` of ``z``; losses 1.9e-4).
* float32, 3 rounds of falcon-mamba with the fused output
  (``ssm_fused_output=True``: the reference's associative ``ssm_mix_fused``
  in both packages on the CPU; the selective-scan kernels on the card),
  tree layout with the fused backend: the same tolerances.
* both packages refuse the packed layout on the bf16 tree.
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

N = 4
MODELS = {"falcon-mamba-7b": 2, "recurrentgemma-2b": 3}
CONFIGS = {
    "packed-fused": (dict(state_layout="packed", engine_backend="pallas",
                          use_pallas=True, weight_decay=0.01),
                     dict(state_layout="packed", engine_backend="fused",
                          use_fused_update=True, weight_decay=0.01)),
    "tree-fused": (dict(engine_backend="pallas", use_pallas=True),
                   dict(engine_backend="fused", use_fused_update=True)),
}
# (arch, config, dtype, rounds, model config changes) per run
RUNS = {f"{arch}-{name}": (arch, name, "float32", 3, {})
        for arch in MODELS for name in CONFIGS}
RUNS.update({f"{arch}-tree-fused-bf16": (arch, "tree-fused", "bfloat16", 2,
                                         {})
             for arch in MODELS})
RUNS["falcon-mamba-7b-tree-fused-ssm_fused_output"] = (
    "falcon-mamba-7b", "tree-fused", "float32", 3, dict(ssm_fused_output=True))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype, **kw):
    n = MODELS[arch]
    return (dataclasses.replace(jax_get_config(arch).reduced(n_layers=n),
                                dtype=dtype, **kw),
            dataclasses.replace(get_config(arch).reduced(n_layers=n),
                                dtype=dtype, **kw))


def _run(arch, name, dtype, rounds, cfg_kw):
    jkw, tkw = CONFIGS[name]
    common = dict(n_agents=N, n_epochs=2, gamma=0.05)
    jcfg, tcfg = _cfgs(arch, dtype, **cfg_kw)
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
    for i in range(rounds):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 32)).astype(np.int32)
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
                dtype=dtype, counts=kernels.launch_counts())


@pytest.fixture(scope="module", params=list(RUNS))
def rounds(request):
    return _run(*RUNS[request.param])


def _jax_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = jcompress.unpack_leaves(x, trainer.packed_meta)
    return jax.tree_util.tree_map(lambda l: np.asarray(l, np.float32), x)


def _port_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = tcompress.unpack_leaves(x, trainer.packed_meta)
    return params_to_jax(x)


def _assert_trees_close(ref, port, dtype):
    def check(p, q):
        if dtype == "float32":
            np.testing.assert_allclose(q, p, atol=1e-4, rtol=0)
            return
        d = np.abs(q - p)
        assert d.max() <= 2.0 ** -5 * np.abs(p).max(), d.max()
        assert np.linalg.norm(d) <= 2e-2 * np.linalg.norm(p)
    jax.tree_util.tree_map(check, ref, port)


def test_loss_metrics_match(rounds):
    rtol = 1e-6 if rounds["dtype"] == "float32" else 1e-3
    for jm, tm in zip(rounds["jm"], rounds["tm"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=rtol)
        assert tm["participation"] == jm["participation"] == 1.0
    assert rounds["tm"][-1]["loss"] < rounds["tm"][0]["loss"]


@pytest.mark.parametrize("var", ["x", "z"])
def test_agent_states_match(rounds, var):
    _assert_trees_close(
        _jax_tree(rounds["jtr"], getattr(rounds["jstate"], var)),
        _port_tree(rounds["ttr"], getattr(rounds["tstate"], var)),
        rounds["dtype"])


def test_consensus_matches(rounds):
    jc = jax.tree_util.tree_map(lambda l: np.asarray(l, np.float32),
                                rounds["jtr"].consensus(rounds["jstate"]))
    _assert_trees_close(jc, params_to_jax(
        rounds["ttr"].consensus(rounds["tstate"])), rounds["dtype"])


def test_cpu_rounds_launch_no_kernel(rounds):
    """On the CPU every op takes its plain version: no kernel launches."""
    assert set(rounds["counts"].values()) == {0}


@pytest.mark.parametrize("arch", list(MODELS))
def test_both_packages_refuse_packed_layout_on_the_bf16_tree(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    kw = dict(n_agents=N, gamma=0.05, state_layout="packed")
    with pytest.raises(ValueError, match="uniform agent axis and dtype"):
        jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**kw))
        jtr.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="uniform agent axis and dtype"):
        tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**kw),
                           device="cpu")
