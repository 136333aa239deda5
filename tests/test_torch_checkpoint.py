"""Checkpoints of the port (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): one file format for both packages.

* The port restores the reference's round checkpoints bit for bit:
  float32 and bfloat16, tree and packed layouts, with the compressed
  exchange's ``.t``; states compared leaf by leaf after each package's own
  unpack.
* The reference restores the port's float32 checkpoints bit for bit,
  packed ones into its own packed restore target (the port writes the
  reference's columns).  The reference cannot restore bfloat16 leaves at
  all (its ``astype`` has no cast from ``|V2``), so that direction is
  float32 only.
* Both packages describe a packed layout with the same manifest.
* The reference's crash-safety cases (``tests/test_faults.py``): the key
  diff, failed saves that keep the old checkpoint or leave nothing, and
  ``find_latest_checkpoint`` skipping debris.
* Cross-package resume: the reference runs 3 rounds (packed, half
  participation, noisy GD) and writes its checkpoint; the port restores
  it and runs rounds 4-6 with the reference's participation rows and
  noise given.  States agree with the reference's rounds 4-6 to 1e-4 and
  losses to 1e-6 relative, in float32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jax_get_config
from repro.core import solvers as jsolvers
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.fed import runtime as jruntime
from repro.models.model import build_model as jax_build_model
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.models.model import build_model

N = 2


def _trainers(dtype="float32", layout="packed", arch="gemma2-2b",
              compression="topk", **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    common = dict(n_agents=N, n_epochs=1, gamma=0.05, state_layout=layout,
                  **kw)
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        compression=japi.CompressionSpec(compression), **common))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(
        compression=tapi.CompressionSpec(compression), **common),
        device="cpu")
    return jcfg, tcfg, jtr, ttr


def _named(tree) -> dict:
    """The reference's tree as ``{dotted name: numpy}``."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _jax_leaves(jtr, x) -> dict:
    if jtr.packed_meta is not None:
        x = jcompress.unpack_leaves(x, jtr.packed_meta)
    return _named(x)


def _port_leaves(ttr, x) -> dict:
    if ttr.packed_meta is not None:
        x = tcompress.unpack_leaves(x, ttr.packed_meta)
    return dict(x)


def _assert_same_bits(ref: dict, port: dict):
    assert set(ref) == set(port)
    for n in ref:
        assert np.array_equal(_bits(ref[n]), _bits(port[n])), n


# ---------------------------------------------------------------------------
# The reference's checkpoints in the port, the port's in the reference
# ---------------------------------------------------------------------------

def _numpy_pack(tree, meta) -> np.ndarray:
    """The reference's ``pack_leaves`` in numpy (leaves in its flattening
    order, into its segments)."""
    leaves = jax.tree_util.tree_leaves(tree)
    buf = np.zeros((leaves[0].shape[0], meta.width), leaves[0].dtype)
    for leaf, (s0, s1) in zip(leaves, meta.segments):
        buf[:, s0:s1] = leaf.reshape(leaf.shape[0], -1)
    return buf


def _reference_like(jtr):
    """The reference trainer's state shapes (``ShapeDtypeStruct`` leaves:
    a restore target for its ``restore_checkpoint``)."""
    return jax.eval_shape(jtr.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("layout", ["tree", "packed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_checkpoint_bit_for_bit(tmp_path, dtype,
                                                        layout):
    _, _, jtr, ttr = _trainers(dtype, layout)
    like = _reference_like(jtr)
    rng = np.random.default_rng(0)
    fields = {}
    for var in ("x", "z", "t"):
        tree = getattr(like, var)
        if layout == "packed":
            meta = jtr.packed_meta
            tree = jax.tree_util.tree_unflatten(meta.treedef, [
                jax.ShapeDtypeStruct(s, tree.dtype) for s in meta.shapes])
        tree = jax.tree_util.tree_map(
            lambda l: rng.standard_normal(l.shape, np.float32).astype(
                l.dtype), tree)
        fields[var] = (_numpy_pack(tree, jtr.packed_meta)
                       if layout == "packed" else tree)
    jstate = like._replace(step=np.asarray(3, np.int32), **fields)
    path = str(tmp_path / "ck")
    jio.save_checkpoint(path, jstate, step=3, extra={"round": 3})
    if dtype == "bfloat16":
        assert np.load(os.path.join(path, "leaves.npz"))[
            ".x" if layout == "packed" else ".x/embed"].dtype == np.dtype("V2")
    tlike, _ = ttr.init(1)
    tstate, extra = ttr.restore_state(path, tlike)
    assert tstate.step == 3 and extra == {"round": 3}
    for var in ("x", "z", "t"):
        _assert_same_bits(_jax_leaves(jtr, getattr(jstate, var)),
                          _port_leaves(ttr, getattr(tstate, var)))


@pytest.mark.parametrize("layout", ["tree", "packed"])
def test_reference_restores_port_checkpoint_bit_for_bit(tmp_path, layout):
    _, tcfg, jtr, ttr = _trainers("float32", layout)
    like, gen = ttr.init(0)
    g = torch.Generator().manual_seed(1)
    fields = {}
    for var in ("x", "z", "t"):
        tree = {n: torch.randn(l.shape, generator=g)
                for n, l in _port_leaves(ttr, getattr(like, var)).items()}
        fields[var] = (tcompress.pack_leaves(tree, ttr.packed_meta)[0]
                       if layout == "packed" else tree)
    tstate = like._replace(step=4, **fields)
    path = str(tmp_path / "ck")
    ttr.save_state(path, tstate, gen, extra={"round": 4, "arrivals": []})
    jstate = jio.restore_checkpoint(path, _reference_like(jtr))
    assert int(jstate.step) == 4
    assert jio.checkpoint_extra(path)["round"] == 4
    for var in ("x", "z", "t"):
        _assert_same_bits(_jax_leaves(jtr, getattr(jstate, var)),
                          _port_leaves(ttr, getattr(tstate, var)))


def test_reference_restores_port_parameter_checkpoint(tmp_path):
    """A ``{name: tensor}`` dict (the standard-mode or consensus model) is
    the reference's parameter tree on disk."""
    jcfg, tcfg, _, _ = _trainers()
    params = build_model(tcfg).init(torch.Generator().manual_seed(1), "cpu")
    path = str(tmp_path / "params")
    tio.save_checkpoint(path, params, step=7)
    got = jio.restore_checkpoint(path, jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(1)))
    _assert_same_bits(_named(got), params)
    assert jio.checkpoint_step(path) == 7


def test_bfloat16_parameters_round_trip_in_the_port(tmp_path):
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               dtype="bfloat16")
    params = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "p")
    tio.save_checkpoint(path, params)
    data = np.load(os.path.join(path, "leaves.npz"))
    assert {data[k].dtype for k in data.files} == {np.dtype("V2")}
    got = tio.restore_checkpoint(path, {n: torch.zeros_like(p)
                                        for n, p in params.items()})
    for n, p in params.items():
        assert got[n].dtype == torch.bfloat16 and torch.equal(
            got[n].view(torch.int16), p.view(torch.int16)), n


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi4-mini-3.8b",
                                  "nemotron-4-340b"])
def test_packed_layout_manifest_matches_reference(arch):
    _, _, jtr, ttr = _trainers(arch=arch, compression="none")
    assert tio.packed_layout_manifest(ttr.packed_meta) == \
        jio.packed_layout_manifest(jtr.packed_meta)


# ---------------------------------------------------------------------------
# Crash-safe checkpoints (the reference's tests/test_faults.py cases)
# ---------------------------------------------------------------------------

def _tree(val):
    return {"a": torch.full((2, 3), val),
            "b": {"c": torch.full((4,), val + 1)}}


def test_restore_lists_missing_and_extra_keys_together(tmp_path):
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, _tree(1.0))
    bad_like = {"a": torch.zeros((2, 3)), "d": torch.zeros((4,))}
    with pytest.raises(ValueError) as ei:
        tio.restore_checkpoint(path, bad_like)
    msg = str(ei.value)
    assert "missing from checkpoint: d" in msg
    assert "unexpected in checkpoint: b/c" in msg


def test_save_checkpoint_failure_preserves_previous(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    tio.save_checkpoint(path, _tree(1.0), step=1)
    assert tio.is_checkpoint(path)

    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        tio.save_checkpoint(path, _tree(2.0), step=2)
    monkeypatch.undo()
    # the old checkpoint is fully intact and no tmp debris is left
    assert tio.is_checkpoint(path)
    got = tio.restore_checkpoint(path, _tree(0.0))
    assert torch.equal(got["a"], _tree(1.0)["a"])
    assert tio.checkpoint_step(path) == 1
    assert not [n for n in os.listdir(tmp_path) if ".ckpt-tmp-" in n]


def test_save_checkpoint_failure_on_fresh_path_leaves_nothing(
        tmp_path, monkeypatch):
    path = str(tmp_path / "fresh")

    def boom(*a, **kw):
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError):
        tio.save_checkpoint(path, _tree(1.0))
    monkeypatch.undo()
    assert not os.path.exists(path)
    assert not [n for n in os.listdir(tmp_path) if ".ckpt-tmp-" in n]


def test_find_latest_checkpoint_skips_debris(tmp_path):
    root = str(tmp_path)
    assert tio.find_latest_checkpoint(root) is None
    tio.save_checkpoint(os.path.join(root, "step-000002"), _tree(1.0),
                        step=2)
    tio.save_checkpoint(os.path.join(root, "step-000010"), _tree(2.0),
                        step=10)
    os.makedirs(os.path.join(root, "step-000099.ckpt-tmp-x"))
    os.makedirs(os.path.join(root, "not-a-checkpoint"))
    latest = tio.find_latest_checkpoint(root)
    assert latest is not None and latest.endswith("step-000010")
    # a direct checkpoint path is itself the answer
    assert tio.find_latest_checkpoint(latest) == latest
    assert tio.find_latest_checkpoint(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------------
# Cross-package resume
# ---------------------------------------------------------------------------

EPOCHS, GAMMA, TAU, P = 2, 0.05, 0.01, 0.5


def test_port_resumes_reference_run(tmp_path):
    kw = dict(participation=P, n_epochs=EPOCHS, gamma=GAMMA,
              weight_decay=0.01, state_layout="packed")
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    privacy = dict(tau=TAU, clip=1.0)
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(
        n_agents=N, privacy=japi.PrivacySpec(**privacy), **kw))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(
        n_agents=N, privacy=tapi.PrivacySpec(**privacy), **kw),
        device="cpu")
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(2)

    @jax.jit
    def round_draws(rkey, i, x):
        """The round's participation row and per-epoch noise, as the
        reference's round derives them from (key, state.step)."""
        _, k_part, k_solve = jax.random.split(jax.random.fold_in(rkey, i), 3)
        u = jax.random.bernoulli(k_part, P, (N,)).astype(jnp.float32)
        leaves = jcompress.unpack_leaves(x, jtr.packed_meta)
        noise = [jsolvers._leaf_noise(leaves, jax.random.split(k)[1],
                                      jnp.sqrt(2.0 * GAMMA) * TAU)
                 for k in jax.random.split(k_solve, EPOCHS)]
        return u, noise

    # the reference's initial state from the port's init, packed in numpy
    # (its own init compiles op by op)
    params = params_to_jax(ttr.model.init(torch.Generator().manual_seed(0),
                                          "cpu"))
    x0 = jnp.asarray(_numpy_pack(jax.tree_util.tree_map(
        lambda p: np.broadcast_to(p, (N,) + p.shape), params),
        jtr.packed_meta))
    jstate = jruntime.FedState(x=x0, z=x0, step=jnp.asarray(0, jnp.int32))
    batches, jstates, jlosses, draws = [], [], [], []
    path = str(tmp_path / "ref" / "rounds" / "step-000003")
    for i in range(6):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 32)).astype(np.int32)
        batch = (tok, np.roll(tok, -1, axis=-1))
        rkey = jax.random.fold_in(key, i)
        u, noise = round_draws(rkey, i, jstate.x)
        noise = [tcompress.pack_leaves(params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), tcfg),
            ttr.packed_meta)[0] for tree in noise]
        jstate, m = jtr.step(jstate, {"tokens": jnp.asarray(batch[0]),
                                      "labels": jnp.asarray(batch[1])}, rkey)
        batches.append(batch)
        draws.append((np.array(u), noise))
        jstates.append(jstate)
        jlosses.append(float(m["loss"]))
        if i == 2:
            jio.save_checkpoint(path, jstate, step=3,
                                extra={"round": 3, "arrivals": []})
    like, _ = ttr.init(0)
    tstate, extra = ttr.restore_state(path, like)
    assert extra["round"] == 3 and tstate.step == 3
    for i in range(3, 6):
        u, noise = draws[i]
        tstate, m = ttr.step(
            tstate, {"tokens": torch.from_numpy(batches[i][0]).long(),
                     "labels": torch.from_numpy(batches[i][1]).long()},
            u=torch.from_numpy(u), noise=lambda e, w: noise[e])
        np.testing.assert_allclose(float(m["loss"]), jlosses[i], rtol=1e-6)
        for var in ("x", "z"):
            ref = _jax_leaves(jtr, getattr(jstates[i], var))
            got = _port_leaves(ttr, getattr(tstate, var))
            for n in ref:
                np.testing.assert_allclose(got[n].numpy(), ref[n],
                                           atol=1e-4, rtol=0,
                                           err_msg=f"round {i + 1} {var} {n}")
    assert [float(d[0].mean()) for d in draws[3:]] != [1.0] * 3
