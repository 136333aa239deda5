"""The port's model layers, attention and loss against the JAX reference.

Reduced gemma2-2b (d 256, vocab 512, 2 layers, window 16, fp32) with
2 KV heads for 4 query heads, so GQA grouping is exercised; inputs come
from numpy with a fixed seed and go to both packages.  Tolerances: 1e-5
on values (float32 rounding of two different op orders), 1e-4 relative
on gradients (the backward sums over many more terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=atol, rtol=atol)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tree, params_from_jax(tree, tcfg)


@pytest.fixture(scope="module")
def batch(cfgs):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfgs[0].vocab, (2, 64)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=-1)


def test_rms_norm_scales_by_one_plus_w():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w))


def test_apply_rope_split_halves():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)
    _close(tlayers.apply_rope(_t(x), torch.arange(7), 10_000.0),
           jlayers.apply_rope(x, pos, 10_000.0))


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "relu2", "gelu"])
def test_mlp_activations(activation):
    rng = np.random.default_rng(3)
    gated = activation in ("geglu", "swiglu")
    p = {"wi": rng.normal(size=(16, 64 if gated else 32)).astype(np.float32),
         "wo": rng.normal(size=(32, 16)).astype(np.float32) * 0.1}
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    out = tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x), activation)
    _close(out, jlayers.mlp(p, x, activation), atol=1e-4)


def test_softcap_and_cross_entropy():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 6, 50)).astype(np.float32) * 40
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    _close(tlayers.softcap(_t(logits), 30.0), jlayers.softcap(logits, 30.0))
    _close(tlayers.cross_entropy(_t(logits), _t(labels)),
           jlayers.cross_entropy(logits, labels), atol=1e-4)


def _qkv(S, H=4, Hkv=2, D=16, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, S, H, D)).astype(np.float32)
    k = rng.normal(size=(2, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(2, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=5, cap=50.0),
                                dict(causal=False, cap=20.0)])
def test_attn_reference(kw):
    q, k, v = _qkv(24)
    _close(tattn.attn_reference(_t(q), _t(k), _t(v), **kw),
           jattn.attn_reference(q, k, v, **kw))


@pytest.mark.parametrize("chunk", [8, 1024])
def test_attn_chunked(chunk):
    q, k, v = _qkv(32)
    _close(tattn.attn_chunked(_t(q), _t(k), _t(v), cap=50.0, chunk=chunk),
           jattn.attn_chunked(q, k, v, cap=50.0, chunk=chunk))


@pytest.mark.parametrize("S,W", [(64, 16), (16, 16), (20, 8)])
def test_attn_block_local(S, W):
    """(64, 16) is four blocks; S == W and S % W fall back to the
    reference with the window mask."""
    q, k, v = _qkv(S)
    _close(tattn.attn_block_local(_t(q), _t(k), _t(v), window=W, cap=50.0),
           jattn.attn_block_local(q, k, v, window=W, cap=50.0))


def test_params_round_trip(cfgs, params):
    _, tree, tp = params
    back = params_to_jax(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, back)


def test_loss_and_logits_match(cfgs, params, batch):
    jcfg, tcfg = cfgs
    jp, _, tp = params
    tok, lab = batch
    model = build_model(tcfg)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": _t(tok).long(), "labels": _t(lab).long()}
    _close(model.loss_fn(tp, tb), jtfm.loss_fn(jp, jcfg, jb))
    logits, _ = jtfm.forward(jp, jcfg, jb)
    _close(model.forward(tp, tb), logits, atol=1e-4)


def test_loss_gradient_matches(cfgs, params, batch):
    jcfg, tcfg = cfgs
    jp, _, tp = params
    tok, lab = batch
    jg = jax.grad(lambda p: jtfm.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(tok),
                  "labels": jnp.asarray(lab)}))(jp)
    leaves = {n: p.clone().requires_grad_() for n, p in tp.items()}
    loss = build_model(tcfg).loss_fn(
        leaves, {"tokens": _t(tok).long(), "labels": _t(lab).long()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    tg = params_to_jax(dict(zip(leaves, grads)))

    def rel(a, b):
        a = np.asarray(a)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))

    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(rel, jg, tg))
    assert max(errs) <= 1e-4, errs
