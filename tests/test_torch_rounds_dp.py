"""Partial participation and DP rounds of the port against the reference.

The reference draws participation and DP noise from JAX's threefry; the
port cannot reproduce those bits, so these tests replay the reference's
own draws into the port: the ``(N,)`` participation row
``bernoulli(split(fold_in(key, step), 3)[1], p)``, and the per-leaf
noisy-GD draws of ``repro.core.solvers._leaf_noise`` under the keys the
reference's round derives.  Reduced gemma2-2b (fp32, 2 KV heads),
2 agents, one round; states agree to 1e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import solvers as jsolvers
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.models.model import build_model

N, EPOCHS, GAMMA = 2, 2, 0.05
COMMON = dict(n_agents=N, n_epochs=EPOCHS, gamma=GAMMA, weight_decay=0.01,
              state_layout="packed")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jcfg.vocab, (N, 2, 64)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    return dict(jmodel=jmodel, tmodel=build_model(tcfg), tcfg=tcfg,
                params=params_from_jax(tree, tcfg),
                jbatch={"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
                tbatch={"tokens": torch.from_numpy(tok).long(),
                        "labels": torch.from_numpy(lab).long()})


def _trainers(models, jkw, tkw):
    jtr = japi.build_trainer(models["jmodel"], japi.FedSpec(**COMMON, **jkw))
    ttr = tapi.build_trainer(models["tmodel"], tapi.FedSpec(**COMMON, **tkw),
                             device="cpu")
    return jtr, ttr


def _compare(jtr, jstate, ttr, tstate, atol=1e-4):
    for var in ("x", "z"):
        j = jcompress.unpack_leaves(getattr(jstate, var), jtr.packed_meta)
        t = params_to_jax(tcompress.unpack_leaves(getattr(tstate, var),
                                                  ttr.packed_meta))
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                    atol=atol, rtol=0), j, t)


def _round_keys(key, step):
    """The reference round's (participation, solver) keys."""
    _, k_part, k_solve = jax.random.split(jax.random.fold_in(key, step), 3)
    return k_part, k_solve


def test_half_participation_round_replays_reference_draw(models):
    jtr, ttr = _trainers(
        models, dict(participation=0.5, engine_backend="pallas",
                     use_pallas=True),
        dict(participation=0.5, engine_backend="fused",
             use_fused_update=True))
    # first key whose realized row mixes active and inactive agents
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.bernoulli(_round_keys(key, 0)[0], 0.5, (N,)),
                       np.float32)
        if 0 < u.sum() < N:
            break
    jstate, jm = jtr.step(jtr.init(jax.random.PRNGKey(0)), models["jbatch"],
                          key)
    t0, _ = ttr.init(0, params=models["params"])
    tstate, tm = ttr.step(t0, models["tbatch"], u=torch.from_numpy(u))
    assert float(tm["participation"]) == float(jm["participation"]) == 0.5
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _compare(jtr, jstate, ttr, tstate)
    idle = int(np.argmin(u))
    assert torch.equal(tstate.x[idle], t0.x[idle])
    assert torch.equal(tstate.z[idle], t0.z[idle])


def test_dp_round_with_replayed_noise_matches(models):
    tau, clip = 0.01, 1.0
    privacy = dict(tau=tau, clip=clip)
    jtr, ttr = _trainers(
        models, dict(privacy=japi.PrivacySpec(**privacy),
                     engine_backend="pallas", use_pallas=True),
        dict(privacy=tapi.PrivacySpec(**privacy), engine_backend="fused",
             use_fused_update=True))
    key = jax.random.PRNGKey(3)
    jstate0 = jtr.init(jax.random.PRNGKey(0))
    jstate, jm = jtr.step(jstate0, models["jbatch"], key)

    _, k_solve = _round_keys(key, 0)
    scale = jnp.sqrt(2.0 * GAMMA) * tau
    shapes = jcompress.unpack_leaves(jstate0.x, jtr.packed_meta)
    draws = []
    for k in jax.random.split(k_solve, EPOCHS):
        noise = jsolvers._leaf_noise(shapes, jax.random.split(k)[1], scale)
        tree = params_from_jax(jax.tree_util.tree_map(np.asarray, noise),
                               models["tcfg"])
        draws.append(tcompress.pack_leaves(tree, ttr.packed_meta)[0])

    t0, _ = ttr.init(0, params=models["params"])
    tstate, tm = ttr.step(t0, models["tbatch"], noise=lambda e, w: draws[e])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _compare(jtr, jstate, ttr, tstate)
