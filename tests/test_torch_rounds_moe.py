"""Whole Fed-PLT rounds of the port on the MoE models against
``repro.fed.api.build_trainer``, and MoE checkpoints across the packages.

Reduced qwen2-moe-a2.7b and grok-1-314b (2 layers, 4 experts of 256,
top-2), 4 agents with 2 sequences of 16 tokens each (capacity 21 of the
64 contributions of an agent's batch: a busy expert drops some), N_e = 2,
gamma = 0.05, participation 1; the same parameters (the reference's
init, converted) and the same numpy batches go into both trainers.

* float32, 3 rounds: qwen2-moe in the packed layout with the fused edges
  and the fused update (weight decay 0.01) against the reference's
  packed round, and grok-1 in the tree layout with the fused backend
  against the reference's tree round.  The agent states and the
  consensus agree to 1e-4 absolute, the losses (``ce + 0.01 aux``) to
  1e-6 relative.
* At bfloat16 the float32 router makes the tree mixed-dtype: both
  packages refuse the packed layout with the reference's message.
* Checkpoints: a reduced qwen2-moe packed round state written by each
  package is restored by the other bit for bit (the ``moe`` leaves in
  the reference's columns: ``experts < router < shared``, JAX's sorted
  keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jax_get_config
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.models.model import build_model

N = 4
RUNS = {
    "qwen2-moe-a2.7b-packed-fused": (
        "qwen2-moe-a2.7b", dict(state_layout="packed", weight_decay=0.01),
        dict(state_layout="packed", engine_backend="fused",
             use_fused_update=True, weight_decay=0.01)),
    "grok-1-314b-tree-fused": (
        "grok-1-314b", dict(), dict(engine_backend="fused",
                                    use_fused_update=True)),
}
ROUNDS = 3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@pytest.fixture(scope="module", params=list(RUNS))
def rounds(request):
    arch, jkw, tkw = RUNS[request.param]
    common = dict(n_agents=N, n_epochs=2, gamma=0.05)
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jtr = japi.build_trainer(jmodel, japi.FedSpec(**common, **jkw))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common, **tkw),
                             device="cpu")
    key = jax.random.PRNGKey(0)
    jstate = jtr.init(key)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    tstate, gen = ttr.init(0, params=params_from_jax(tree, tcfg))
    rng = np.random.default_rng(0)
    jm, tm = [], []
    kernels.reset_launch_counts()
    for i in range(ROUNDS):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 16)).astype(np.int32)
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


def _jax_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = jcompress.unpack_leaves(x, trainer.packed_meta)
    return jax.tree_util.tree_map(np.asarray, x)


def _port_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = tcompress.unpack_leaves(x, trainer.packed_meta)
    return params_to_jax(x)


def _assert_trees_close(ref, port):
    jax.tree_util.tree_map(
        lambda p, q: np.testing.assert_allclose(q, p, atol=1e-4, rtol=0),
        ref, port)


def test_loss_metrics_match(rounds):
    for jm, tm in zip(rounds["jm"], rounds["tm"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-6)
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


def test_moe_leaves_in_the_state(rounds):
    """The state holds the MoE's leaves (stacked over units and agents),
    and on the CPU no kernel launches."""
    x = _port_tree(rounds["ttr"], rounds["tstate"].x)
    moe = x["stages"][0]["0"]["moe"]
    assert moe["router"].shape == (N, 2, 256, 4)
    assert moe["experts"]["wi"].shape == (N, 2, 4, 256, 512)
    assert set(rounds["counts"].values()) == {0}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_both_packages_refuse_packed_layout_on_the_bf16_tree(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    kw = dict(n_agents=N, gamma=0.05, state_layout="packed")
    with pytest.raises(ValueError, match="uniform agent axis and dtype"):
        jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**kw))
        jtr.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="uniform agent axis and dtype"):
        tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**kw),
                           device="cpu")


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    return a.view(np.uint32)


def _named(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def ckpt_trainers():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    common = dict(n_agents=2, n_epochs=1, gamma=0.05, state_layout="packed")
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**common))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common),
                             device="cpu")
    return jtr, ttr, jax.eval_shape(jtr.init, jax.random.PRNGKey(0))


def test_port_restores_reference_moe_checkpoint_bit_for_bit(tmp_path,
                                                           ckpt_trainers):
    jtr, ttr, like = ckpt_trainers
    meta = jtr.packed_meta
    assert any("moe" in str(p) for p in
               jax.tree_util.tree_flatten_with_path(
                   jax.tree_util.tree_unflatten(
                       meta.treedef, list(range(len(meta.shapes)))))[0])
    rng = np.random.default_rng(0)
    fields = {v: rng.standard_normal(getattr(like, v).shape,
                                     np.float32) for v in ("x", "z")}
    jstate = like._replace(step=np.asarray(2, np.int32), **fields)
    path = str(tmp_path / "ck")
    jio.save_checkpoint(path, jstate, step=2)
    tstate, _ = ttr.restore_state(path, ttr.init(1)[0])
    assert tstate.step == 2
    for v in ("x", "z"):
        ref = _named(jax.tree_util.tree_map(
            np.asarray, jcompress.unpack_leaves(fields[v], meta)))
        got = tcompress.unpack_leaves(getattr(tstate, v), ttr.packed_meta)
        assert set(ref) == set(got)
        for n in ref:
            assert np.array_equal(_bits(ref[n]), _bits(got[n])), n


def test_reference_restores_port_moe_checkpoint_bit_for_bit(tmp_path,
                                                           ckpt_trainers):
    jtr, ttr, like = ckpt_trainers
    tlike, gen = ttr.init(0)
    g = torch.Generator().manual_seed(1)
    fields = {v: torch.randn(getattr(tlike, v).shape, generator=g)
              for v in ("x", "z")}
    path = str(tmp_path / "ck")
    ttr.save_state(path, tlike._replace(step=5, **fields), gen,
                   extra={"round": 5, "arrivals": []})
    jstate = jio.restore_checkpoint(path, like)
    assert int(jstate.step) == 5
    for v in ("x", "z"):
        ref = _named(jax.tree_util.tree_map(
            np.asarray, jcompress.unpack_leaves(getattr(jstate, v),
                                                jtr.packed_meta)))
        got = tcompress.unpack_leaves(fields[v], ttr.packed_meta)
        assert set(ref) == set(got)
        for n in ref:
            assert np.array_equal(_bits(ref[n]), _bits(got[n])), n
