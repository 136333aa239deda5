"""The encoder-decoder and the vision prefix of the port against the
reference: reduced whisper-small (2 encoder layers over 24 frames, 2
decoder layers with cross-attention, gelu) and reduced internvl2-26b (2
layers, 16 patch embeddings before the text), d 256, float32.  One set of
parameters (the reference's init, converted) and numpy inputs go to both
packages.

* Forward: the logits, the loss and the gradients of the loss with
  respect to every parameter agree to 1e-5 relative (largest difference
  over the largest entry of the reference's tensor); whisper's encoder
  output too.
* Decode: whisper's ``fill_cross_cache`` from each package's own encoder
  output, then ``decode_step`` at every position against the reference's
  (jitted) to 1e-4 absolute, and against the port's own forward to 2e-2
  (the reference's ``tests/test_models_smoke.py`` bound); internvl2's
  text decode against the reference's the same way.
* ``make_batch_for``: the keys, shapes and dtypes of the reference's
  ``batch_specs`` (the vision text cut to ``seq_len - n_frontend_tokens``,
  no labels for a prefill shape), with and without the agent axis; the
  stubs' embeddings at the reference's scale, 0.02.
* ``convert``: the reference's tree to the port's names and back, bit
  for bit.
* Fed rounds: 3 rounds, N 2 (2 sequences of 16 tokens each), N_e 2, the
  packed layout with the fused edges and update (plain on the CPU)
  against the reference's packed xla round: states 1e-4 absolute, losses
  1e-6 relative.
* Checkpoints: a packed whisper round state written by each package is
  restored by the other bit for bit (the encoder and the ``ln_x`` /
  ``xattn`` leaves in the reference's sorted-key columns); the packed
  layout manifest is the reference's for both configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JShape
from repro.fed import api as japi
from repro.fed import compress as jcompress
from repro.models import decode as jdecode
from repro.models import model as jmodel_lib
from repro.models import transformer as jtfm
from repro.models.layers import rms_norm as jrms_norm
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.data import synthetic as tsynthetic
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.models.decode import fill_cross_cache
from repro_torch.models.model import build_model

ARCHS = ("whisper-small", "internvl2-26b")
B, S_TEXT = 2, 12
KEY = jax.random.PRNGKey(1)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _named(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """Both reduced models, the reference's parameters in both forms and
    one numpy batch (tokens, labels, the frontend's embeddings)."""
    jcfg, tcfg = _cfgs(request.param)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(KEY))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, (B, S_TEXT)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    if jcfg.n_enc_layers:
        batch["enc_embeds"] = 0.02 * rng.standard_normal(
            (B, jcfg.n_enc_tokens, jcfg.d_model)).astype(np.float32)
    else:
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, tmodel=tmodel,
                tree=tree, params=params_from_jax(tree, tcfg), batch=batch)


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_forward_loss_and_gradients_match_reference(models):
    jmodel, tmodel = models["jmodel"], models["tmodel"]
    jb = {k: jnp.asarray(v) for k, v in models["batch"].items()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (jmodel.loss_fn(p, batch=jb),
                   jmodel.forward(p, batch=jb)[0]), has_aux=True))(
        models["tree"])
    tb = _tbatch(models["batch"])
    names = list(models["params"])
    leaves = [models["params"][n].clone().requires_grad_() for n in names]
    tloss = tmodel.loss_fn(dict(zip(names, leaves)), tb)
    tgrads = dict(zip(names, torch.autograd.grad(tloss, leaves)))
    with torch.no_grad():
        tlogits = tmodel.forward(models["params"], tb)
    tcfg = models["tcfg"]
    front = tcfg.n_frontend_tokens if tcfg.frontend == "vision" else 0
    assert tlogits.shape == (B, S_TEXT + front, models["tcfg"].vocab)
    assert _rel(tlogits.numpy(), jlogits) < 1e-5
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    ref = _named(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(ref) == set(tgrads)
    if models["tcfg"].n_enc_layers:       # gradients reach the encoder
        assert np.abs(ref["stages.0.0.attn.wq"]).max() > 0
    for n in ref:
        assert _rel(tgrads[n].numpy(), ref[n]) < 1e-5, n


def _decode(models):
    """The reference's jitted decode and the port's, position by
    position, from each package's own cross cache (whisper)."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    jmodel, tmodel = models["jmodel"], models["tmodel"]
    tree, params, batch = models["tree"], models["params"], models["batch"]
    jcache = jmodel.init_cache(batch=B, cache_len=S_TEXT)
    tcache = tmodel.init_cache(B, S_TEXT, device="cpu")
    enc = None
    if jcfg.n_enc_layers:
        stage = jtfm.build_stages(jcfg)[0]
        x = jnp.asarray(batch["enc_embeds"])
        jenc, _ = jtfm._stage_forward(tree["stages"][0], stage, x, jcfg,
                                      jnp.arange(x.shape[1]),
                                      jnp.zeros((), jnp.float32))
        jenc = jrms_norm(jenc, jnp.zeros_like(jenc[0, 0]), jcfg.norm_eps)
        enc = tmodel.encode(params, torch.from_numpy(batch["enc_embeds"]))
        assert _rel(enc.numpy(), jenc) < 1e-5
        jcache = jdecode.fill_cross_cache(tree, jcfg, jcache, jenc)
        tcache = fill_cross_cache(params, tcfg, tcache, enc)
        np.testing.assert_allclose(
            tcache["stages"][0]["0"]["xk"].numpy(),
            np.asarray(jcache["stages"][0]["0"]["xk"]), atol=1e-5, rtol=0)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, cache=c, tokens=t))
    ref, got = [], []
    for t in range(S_TEXT):
        tok = batch["tokens"][:, t]
        lg, jcache = step(tree, jcache, jnp.asarray(tok))
        tl, tcache = tmodel.decode_step(params, tcache, torch.from_numpy(tok))
        ref.append(np.asarray(lg))
        got.append(tl.numpy())
    return np.stack(ref, 1), np.stack(got, 1)


def test_decode_matches_reference_and_own_forward(models):
    ref, got = _decode(models)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    if models["tcfg"].n_enc_layers:
        # the forward over the same tokens and frames (a text-only
        # decode of the vision model has no prefix to compare with)
        with torch.no_grad():
            fwd = models["tmodel"].forward(models["params"],
                                           _tbatch(models["batch"]))
        assert float(np.abs(fwd.numpy() - got).max()) < 2e-2


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_for_matches_reference_specs(arch, kind):
    """The reference's ``make_batch_for`` draws to its ``batch_specs``
    (``repro/models/model.py``); the port's batch holds the same keys,
    shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    for n_agents in (None, 2):
        b = 4 if n_agents is None else 4 // n_agents
        want = jmodel_lib.batch_specs(jcfg, JShape("s", 32, b, kind),
                                      with_labels=kind == "train")
        got = tsynthetic.make_batch_for(tcfg, InputShape("s", 32, 4, kind),
                                        gen, n_agents=n_agents, device="cpu")
        lead = () if n_agents is None else (n_agents,)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == lead + tuple(want[k].shape), k
            assert got[k].is_floating_point() == jnp.issubdtype(
                want[k].dtype, jnp.floating), k
        text = 32 - (tcfg.n_frontend_tokens if tcfg.frontend == "vision"
                     else 0)
        assert got["tokens"].shape[-1] == text
        assert ("labels" in got) == (kind == "train")
        emb = got["enc_embeds" if tcfg.n_enc_layers else "patch_embeds"]
        np.testing.assert_allclose(float(emb.std()), 0.02, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_bit_for_bit(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_build_model(jcfg).init(KEY))
    back = _named(params_to_jax(params_from_jax(tree, tcfg)))
    want = _named(tree)
    assert set(back) == set(want) == set(build_model(tcfg).param_shapes())
    for n in want:
        assert np.array_equal(back[n].view(np.uint32),
                              want[n].view(np.uint32)), n


@pytest.fixture(scope="module", params=ARCHS)
def rounds(request):
    jcfg, tcfg = _cfgs(request.param)
    common = dict(n_agents=2, n_epochs=2, gamma=0.05, weight_decay=0.01,
                  state_layout="packed")
    jmodel = jax_build_model(jcfg)
    jtr = japi.build_trainer(jmodel, japi.FedSpec(**common))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(
        **common, engine_backend="fused", use_fused_update=True),
        device="cpu")
    jstate = jtr.init(KEY)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(KEY))
    tstate, gen = ttr.init(0, params=params_from_jax(tree, tcfg))
    rng = np.random.default_rng(2)
    losses = []
    kernels.reset_launch_counts()
    for i in range(3):
        tok = rng.integers(0, jcfg.vocab, (2, 2, 16)).astype(np.int32)
        b = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
        if jcfg.n_enc_layers:
            b["enc_embeds"] = 0.02 * rng.standard_normal(
                (2, 2, jcfg.n_enc_tokens, jcfg.d_model)).astype(np.float32)
        else:
            b["patch_embeds"] = 0.02 * rng.standard_normal(
                (2, 2, jcfg.n_frontend_tokens, jcfg.d_model)).astype(
                    np.float32)
        jstate, jm = jtr.step(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()},
                              jax.random.fold_in(KEY, i))
        tstate, tm = ttr.step(tstate, _tbatch(b), gen)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    return dict(jtr=jtr, ttr=ttr, jstate=jstate, tstate=tstate,
                losses=losses, counts=kernels.launch_counts())


def test_fed_rounds_match_reference(rounds):
    jl, tl = np.array(rounds["losses"]).T
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]
    # on the CPU the fused backend runs the kernels' plain versions
    assert set(rounds["counts"].values()) == {0}
    for var in ("x", "z"):
        ref = _named(jax.tree_util.tree_map(np.asarray, jcompress.unpack_leaves(
            getattr(rounds["jstate"], var), rounds["jtr"].packed_meta)))
        got = tcompress.unpack_leaves(getattr(rounds["tstate"], var),
                                      rounds["ttr"].packed_meta)
        assert set(ref) == set(got)
        for n in ref:
            np.testing.assert_allclose(got[n].numpy(), ref[n], atol=1e-4,
                                       rtol=0, err_msg=f"{var} {n}")


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_trainers():
    jcfg, tcfg = _cfgs("whisper-small")
    common = dict(n_agents=2, n_epochs=1, gamma=0.05, state_layout="packed")
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**common))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**common),
                             device="cpu")
    return jtr, ttr, jax.eval_shape(jtr.init, KEY)


def _assert_same_state(jtr, jx, ttr, tx):
    ref = _named(jax.tree_util.tree_map(
        np.asarray, jcompress.unpack_leaves(jx, jtr.packed_meta)))
    got = tcompress.unpack_leaves(tx, ttr.packed_meta)
    assert set(ref) == set(got)
    assert {"stages.1.0.ln_x", "stages.1.0.xattn.wk",
            "stages.0.0.mlp.wi"} <= set(ref)
    for n in ref:
        assert np.array_equal(got[n].numpy().view(np.uint32),
                              ref[n].view(np.uint32)), n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_whisper_checkpoint_crosses_packages_bit_for_bit(tmp_path, writer,
                                                         ckpt_trainers):
    jtr, ttr, like = ckpt_trainers
    path = str(tmp_path / "ck")
    tlike, gen = ttr.init(0)
    if writer == "reference":
        rng = np.random.default_rng(0)
        fields = {v: rng.standard_normal(getattr(like, v).shape, np.float32)
                  for v in ("x", "z")}
        jio.save_checkpoint(path, like._replace(
            step=np.asarray(2, np.int32), **fields), step=2)
        tstate, _ = ttr.restore_state(path, tlike)
        assert tstate.step == 2
        for v in ("x", "z"):
            _assert_same_state(jtr, fields[v], ttr, getattr(tstate, v))
        return
    g = torch.Generator().manual_seed(1)
    fields = {v: torch.randn(getattr(tlike, v).shape, generator=g)
              for v in ("x", "z")}
    ttr.save_state(path, tlike._replace(step=5, **fields), gen,
                   extra={"round": 5, "arrivals": []})
    jstate = jio.restore_checkpoint(path, like)
    assert int(jstate.step) == 5
    for v in ("x", "z"):
        _assert_same_state(jtr, getattr(jstate, v), ttr, fields[v])


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_layout_manifest_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(n_agents=2, gamma=0.05, state_layout="packed")
    jtr = japi.build_trainer(jax_build_model(jcfg), japi.FedSpec(**kw))
    ttr = tapi.build_trainer(build_model(tcfg), tapi.FedSpec(**kw),
                             device="cpu")
    assert tio.packed_layout_manifest(ttr.packed_meta) == \
        jio.packed_layout_manifest(jtr.packed_meta)
