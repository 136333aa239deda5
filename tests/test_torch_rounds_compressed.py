"""Compressed Fed-PLT rounds of the port against the reference.

Reduced gemma2-2b (fp32, 2 KV heads), 2 agents with 2 sequences of 64
tokens, N_e = 2, gamma = 0.05, participation 0.5 with the reference's
draws replayed (round 0 ``u = [1, 0]``, round 1 ``u = [0, 1]``), 2
rounds, for ``topk`` (ratio 0.25), ``int8`` and ``adaptive_topk``
(energy 0.95).  Two layouts, each with its backends: the tree layout with
the unfused edges and the per-leaf registry compressors (the reference's
``xla``), and the packed layout with the fused edges, fused update and
fused compressors (the reference's ``pallas``).  After 2 rounds the
port's ``x``, ``z`` and ``t`` are within 1e-4 of the reference's,
except at entries where the compressor's discrete choice flipped on a
near-tie: the two runs' increments differ by float32 rounding (~1e-7),
which can swap two near-equal magnitudes at the k-th position, move an
``adaptive_topk`` k_i by one, or move an int8 code across a half.  Such an
entry differs by a whole transmitted value.  The test allows a mismatch
only at an entry that was such a near-tie in the reference's own
increment in some round (its magnitude rank within 3 of the kept count,
or ``|x| / scale`` within 0.01 of a half), and at most 16 of them.

The transmitted ``q`` itself is discrete: the port's compressor fed the
reference run's own increments ``z_r - t_{r-1}`` reproduces the
reference's ``q`` exactly (``adaptive_topk`` on the (agent, leaf)
segments whose energy threshold has a 1e-4 margin, as in
``tests/test_torch_compress.py``).
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

N, ROUNDS, P = 2, 2, 0.5
U_ROWS = ([1.0, 0.0], [0.0, 1.0])
COMPRESSORS = ("topk", "int8", "adaptive_topk")
LAYOUTS = {
    "tree": (dict(engine_backend="xla"), "xla",
             dict(engine_backend="torch"), "torch"),
    "packed": (dict(state_layout="packed", engine_backend="pallas",
                    use_pallas=True), "pallas",
               dict(state_layout="packed", engine_backend="fused",
                    use_fused_update=True), "fused"),
}
CASES = [(c, lay) for c in COMPRESSORS for lay in LAYOUTS]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(ROUNDS):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 64)).astype(np.int32)
        batches.append((tok, np.roll(tok, -1, axis=-1)))
    return dict(jmodel=jmodel, tmodel=build_model(tcfg), tcfg=tcfg,
                params=params_from_jax(tree, tcfg), batches=batches)


def _round_key(step, row):
    """A key whose reference round ``step`` draws participation ``row``."""
    for seed in range(256):
        key = jax.random.PRNGKey(seed)
        _, k_part, _ = jax.random.split(jax.random.fold_in(key, step), 3)
        u = np.asarray(jax.random.bernoulli(k_part, P, (N,)), np.float32)
        if np.array_equal(u, row):
            return key
    raise AssertionError(f"no key draws {row}")


def _run(models, name, layout):
    jkw, jback, tkw, tback = LAYOUTS[layout]
    common = dict(n_agents=N, n_epochs=2, gamma=0.05, participation=P)
    jspec = japi.FedSpec(**common, **jkw, compression=japi.CompressionSpec(
        name=name, ratio=0.25, energy=0.95, backend=jback))
    tspec = tapi.FedSpec(**common, **tkw, compression=tapi.CompressionSpec(
        name=name, ratio=0.25, energy=0.95, backend=tback))
    jtr = japi.build_trainer(models["jmodel"], jspec)
    ttr = tapi.build_trainer(models["tmodel"], tspec, device="cpu")
    jstates = [jtr.init(jax.random.PRNGKey(0))]
    tstate, _ = ttr.init(0, params=models["params"])
    kernels.reset_launch_counts()
    tm = []
    for r, (tok, lab) in enumerate(models["batches"]):
        jstate, _ = jtr.step(jstates[-1], {"tokens": jnp.asarray(tok),
                                           "labels": jnp.asarray(lab)},
                             _round_key(r, U_ROWS[r]))
        jstates.append(jstate)
        tstate, m = ttr.step(tstate, {"tokens": torch.from_numpy(tok).long(),
                                      "labels": torch.from_numpy(lab).long()},
                             u=torch.tensor(U_ROWS[r]))
        tm.append({k: float(v) for k, v in m.items()})
    return dict(jtr=jtr, ttr=ttr, jstates=jstates, tstate=tstate, tm=tm,
                jcfg=jspec.round_config(),
                tcfg=tspec.round_config(), counts=kernels.launch_counts())


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c}-{lay}" for c, lay in CASES])
def rounds(request, models):
    return _run(models, *request.param)


def _jax_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = jcompress.unpack_leaves(x, trainer.packed_meta)
    return jax.tree_util.tree_map(np.asarray, x)


def _port_tree(trainer, x):
    if trainer.packed_meta is not None:
        x = tcompress.unpack_leaves(x, trainer.packed_meta)
    return params_to_jax(x)


def _reference_q(rounds, dz):
    """The reference's transmitted q for an increment (jitted, as in its
    round: eager XLA rounds the int8 scale differently on some shapes)."""
    jtr, jcfg = rounds["jtr"], rounds["jcfg"]
    if jtr.packed_meta is not None:
        return jax.jit(lambda d: jcompress.compress_increment_packed(
            d, jtr.packed_meta, jcfg))(dz)
    return jax.jit(lambda d: jcompress.compress_increment(d, jcfg))(dz)


def _near_ties(rounds):
    """Per leaf, the (agent, flat index) entries of the reference's
    increments that sat on a near-tie of the compressor in some round."""
    jtr, name = rounds["jtr"], rounds["jcfg"].compression
    out = None
    for r in range(1, ROUNDS + 1):
        dz = jax.tree_util.tree_map(jnp.subtract, rounds["jstates"][r].z,
                                    rounds["jstates"][r - 1].t)
        q = _jax_tree(jtr, _reference_q(rounds, dz))
        dz = _jax_tree(jtr, dz)
        leaves = []
        for d, ql in zip(jax.tree_util.tree_leaves(dz),
                         jax.tree_util.tree_leaves(q)):
            d, ql = d.reshape(N, -1), ql.reshape(N, -1)
            near = np.zeros(d.shape, bool)
            for i in range(N):
                mag = np.abs(d[i])
                if name == "int8":
                    frac = mag / max(mag.max() / 127.0, 1e-12) % 1.0
                    near[i] = np.abs(frac - 0.5) < 0.01
                    continue
                k = int(np.count_nonzero(ql[i]))
                desc = np.sort(mag)[::-1]
                hi = desc[max(k - 4, 0)]
                lo = desc[min(k + 2, desc.size - 1)]
                near[i] = (mag <= hi) & (mag >= lo)
            leaves.append(near)
        out = leaves if out is None else [a | b for a, b in zip(out, leaves)]
    return out


@pytest.mark.parametrize("var", ["x", "z", "t"])
def test_agent_states_match(rounds, var):
    want = _jax_tree(rounds["jtr"], getattr(rounds["jstates"][-1], var))
    got = _port_tree(rounds["ttr"], getattr(rounds["tstate"], var))
    near = _near_ties(rounds)
    flips = 0
    for w, g, nr in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got), near):
        bad = np.abs(g.reshape(N, -1) - w.reshape(N, -1)) > 1e-4
        assert not (bad & ~nr).any(), (
            f"{int((bad & ~nr).sum())} entries beyond 1e-4 off any near-tie")
        flips += int(bad.sum())
    assert flips <= 16


def test_participation_replayed_and_loss_finite(rounds):
    assert [m["participation"] for m in rounds["tm"]] == [0.5, 0.5]
    assert all(np.isfinite(m["loss"]) for m in rounds["tm"])
    assert set(rounds["counts"].values()) == {0}   # CPU: plain versions


def test_compressed_t_lags_z(rounds):
    """t advanced by what was transmitted, not by the whole increment."""
    st = rounds["tstate"]
    tz = _port_tree(rounds["ttr"], st.z)
    tt = _port_tree(rounds["ttr"], st.t)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(tz), jax.tree_util.tree_leaves(tt)))
    assert diff > 0.0


def _fp32_margin(row):
    sq = (np.abs(row).astype(np.float32) ** 2).astype(np.float64)
    cum = np.cumsum(np.sort(sq)[::-1])
    total = max(cum[-1], 1e-30)
    return np.abs(cum - 0.95 * total).min() / total


def test_port_compressor_reproduces_reference_q_on_its_increments(rounds):
    jtr, ttr = rounds["jtr"], rounds["ttr"]
    tcfg_model = dataclasses.replace(
        get_config("gemma2-2b").reduced(), n_kv_heads=2)
    name = rounds["tcfg"].compression
    compared = 0
    for r in range(1, ROUNDS + 1):
        jz, jt = rounds["jstates"][r].z, rounds["jstates"][r - 1].t
        dz = jax.tree_util.tree_map(jnp.subtract, jz, jt)
        jq = _reference_q(rounds, dz)
        if jtr.packed_meta is not None:
            jq = jcompress.unpack_leaves(jq, jtr.packed_meta)
            dz = jcompress.unpack_leaves(dz, jtr.packed_meta)
        dz_port = params_from_jax(jax.tree_util.tree_map(np.asarray, dz),
                                  tcfg_model)
        if ttr.packed_meta is not None:
            buf = tcompress.pack_leaves(dz_port, ttr.packed_meta)[0]
            tq = tcompress.unpack_leaves(tcompress.compress_increment_packed(
                buf, ttr.packed_meta, rounds["tcfg"]), ttr.packed_meta)
        else:
            tq = tcompress.compress_increment(dz_port, rounds["tcfg"])
        want = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jq))
        got = jax.tree_util.tree_leaves(params_to_jax(tq))
        inc = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                dz))
        for w, g, d in zip(want, got, inc):
            for i in range(N):
                if name == "adaptive_topk" and _fp32_margin(d[i]) <= 1e-4:
                    continue
                np.testing.assert_array_equal(g[i], w[i])
                compared += 1
    assert compared >= 10
