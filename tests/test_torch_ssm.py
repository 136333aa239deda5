"""The port's SSM (Mamba-1) and RG-LRU blocks against the JAX reference.

Reduced falcon-mamba-7b (2 ``ssm`` layers, d 256, d_inner 512, state 16,
dt_rank 16) and reduced recurrentgemma-2b with 3 layers (``rec, rec,
local``: d 256, lru_width 256, MQA 4 heads over 1 KV head, window 16),
both float32, parameters from the reference's init carried across by
``convert.params_from_jax``; inputs from numpy with a fixed seed.  Each
function's forward and its gradients (of ``sum(out * ct)`` for a fixed
numpy cotangent, against ``jax.grad``) are compared:
``causal_conv1d``, ``_ssm_coeffs``, ``ssm_scan_chunked`` (the CPU scan,
in ``jax.lax.associative_scan``'s order, with a carry across chunks),
``mamba_forward``, ``_gates`` and ``rglru_forward``; then each whole
model's loss and gradients, on the CPU path and with every scan sent
through the card's ``LruScan`` autograd Function (on CPU tensors, where
it runs the plain sequential scan); and falcon-mamba with the fused
output (``ssm_fused_output``) under ``ssm_inner`` "seq" and "assoc", and
with its time mixing sent through the card's ``SsmScan`` Function (the
selective-scan kernels' plain versions on CPU tensors) against the
reference's associative path.  Tolerances: values 1e-5 relative
plus 1e-5 absolute (float32 rounding of two op orders); gradients 1e-4
of the largest entry of each reference gradient (the backward sums over
many more terms).

Also: the float32 init leaves (``dt_bias``, ``A_log``, ``D``, ``lam``)
and the mixed-dtype parameter trees at bfloat16 (names, shapes and
per-leaf dtypes of both packages, and ``convert`` keeping each leaf's
dtype).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model

MODELS = {"falcon-mamba-7b": 2, "recurrentgemma-2b": 3}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    test workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(port, ref, what=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5, err_msg=what)


def _grad_close(port, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max(), err_msg=what)


def _rng_like(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _check(jfn, tfn, args, seed, names=None):
    """Forward and gradients of ``fn(*args)`` (a tuple of outputs or one)
    in both packages; ``args`` are numpy arrays or dicts of them."""
    jargs = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
    jout = jax.jit(jfn)(*jargs)
    single = not isinstance(jout, tuple)
    jouts = (jout,) if single else jout
    cts = _rng_like(seed, [o.shape for o in jouts])

    def jloss(*xs):
        out = jfn(*xs)
        out = (out,) if single else out
        return sum(jnp.sum(o * c) for o, c in zip(out, cts))

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(
        *jargs)
    targs = [{k: _t(v).requires_grad_() for k, v in a.items()}
             if isinstance(a, dict) else _t(a).requires_grad_()
             for a in args]
    touts = tfn(*targs)
    touts = (touts,) if single else touts
    for i, (o, jo) in enumerate(zip(touts, jouts)):
        _close(o, jo, f"output {i}")
    leaves = [t for a in targs for t in (a.values() if isinstance(a, dict)
                                          else [a])]
    loss = sum(torch.sum(o * _t(c)) for o, c in zip(touts, cts))
    # a block function reads some of its block's params only (zero grads)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    jleaves = [g for jg, a in zip(jgrads, args) for g in
               ([jg[k] for k in a] if isinstance(a, dict) else [jg])]
    names = [f"{i}:{k}" for i, a in enumerate(args) for k in
             (a if isinstance(a, dict) else [""])]
    for n, g, jg in zip(names, grads, jleaves):
        _grad_close(g, jg, f"grad {n}")


def _model(arch):
    jcfg = jax_get_config(arch).reduced(n_layers=MODELS[arch])
    tcfg = get_config(arch).reduced(n_layers=MODELS[arch])
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tree=tree,
                tparams=params_from_jax(tree, tcfg))


@pytest.fixture(scope="module")
def mamba():
    return _model("falcon-mamba-7b")


@pytest.fixture(scope="module")
def rec():
    return _model("recurrentgemma-2b")


def _block(model, kind):
    """The first unit's params of the first layer of ``kind``, as numpy
    (carried across by convert, then back to a dict of arrays)."""
    i = model["tcfg"].pattern.index(kind)
    block = "mamba" if kind == "ssm" else "rec"
    prefix = f"stages.0.{i}.{block}."
    return {k[len(prefix):]: v[0].numpy() for k, v in model["tparams"].items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Layers and blocks
# ---------------------------------------------------------------------------

def test_causal_conv1d():
    x, w, b = _rng_like(0, [(2, 9, 5), (4, 5), (5,)])
    _check(jlayers.causal_conv1d, tlayers.causal_conv1d, (x, w, b), 1)


@pytest.mark.parametrize("S,chunk", [(40, 8), (40, 16), (7, 128)])
def test_ssm_scan_chunked(S, chunk):
    rng = np.random.default_rng(S + chunk)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(2, S, 6, 3))))).astype(
        np.float32)
    bx, h0 = _rng_like(S, [(2, S, 6, 3), (2, 6, 3)])
    _check(lambda *xs: jssm.ssm_scan_chunked(*xs, chunk=chunk),
           lambda *xs: tssm.ssm_scan_chunked(*xs, chunk=chunk),
           (a, bx, h0), 2)


@pytest.mark.parametrize("S", [1, 2, 5, 8, 13])
def test_associative_scan_takes_jax_order(S):
    """Bit for bit: the same products and sums in the same order."""
    rng = np.random.default_rng(S)
    a, b = (rng.normal(size=(2, S, 3)).astype(np.float32) for _ in range(2))

    def comb(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = tssm.associative_scan(_t(a), _t(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_ssm_coeffs(mamba):
    p = _block(mamba, "ssm")
    (u,) = _rng_like(3, [(2, 12, mamba["tcfg"].d_inner)])
    _check(jssm._ssm_coeffs, tssm._ssm_coeffs, (p, u), 4)


@pytest.mark.parametrize("chunk", [None, 8])
def test_mamba_forward(mamba, chunk):
    p = _block(mamba, "ssm")
    (x,) = _rng_like(5, [(2, 40, mamba["tcfg"].d_model)])
    _check(lambda p, x: jssm.mamba_forward(p, x, mamba["jcfg"], chunk),
           lambda p, x: tssm.mamba_forward(p, x, mamba["tcfg"], chunk),
           (p, x), 6)


def test_gates(rec):
    p = _block(rec, "rec")
    (u,) = _rng_like(7, [(2, 12, rec["tcfg"].resolved_lru_width)])
    _check(jrglru._gates, trglru._gates, (p, u), 8)


@pytest.mark.parametrize("chunk", [256, 8])
def test_rglru_forward(rec, chunk):
    p = _block(rec, "rec")
    (x,) = _rng_like(9, [(2, 40, rec["tcfg"].d_model)])
    _check(lambda p, x: jrglru.rglru_forward(p, x, rec["jcfg"], chunk),
           lambda p, x: trglru.rglru_forward(p, x, rec["tcfg"], chunk),
           (p, x), 10)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def _lru_scan_through_function(a, bx, chunk):
    """The card's scan on CPU tensors: the 4-D fold and ``LruScan``."""
    B, S, W, N = a.shape
    return lru_ops.LruScan.apply(a.reshape(B, S, W * N).contiguous(),
                                 bx.reshape(B, S, W * N).contiguous()
                                 ).reshape(B, S, W, N)


def _ssm_scan_through_function(params, u, chunk, scan_dtype):
    """The card's fused output on CPU tensors: ``SsmScan``."""
    return tssm.ssm_mix_kernel(params, u, scan_dtype)


# the fused output's config (both packages) per route
FUSED = {"fused_seq": dict(ssm_fused_output=True, ssm_inner="seq"),
         "fused_assoc": dict(ssm_fused_output=True),
         "ssm_scan_function": dict(ssm_fused_output=True)}


@pytest.mark.parametrize("arch,route", [
    (arch, route) for arch in MODELS
    for route in ("cpu", "lru_scan_function")] + [
    ("falcon-mamba-7b", route) for route in FUSED])
def test_model_loss_and_grads_match_reference(arch, route, request,
                                              monkeypatch):
    model = request.getfixturevalue({"falcon-mamba-7b": "mamba",
                                     "recurrentgemma-2b": "rec"}[arch])
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    if route in FUSED:
        jcfg = dataclasses.replace(jcfg, **FUSED[route])
        tcfg = dataclasses.replace(tcfg, **FUSED[route])
    rng = np.random.default_rng(11)
    tok = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_build_model(jcfg).loss_fn(p, batch=jbatch)))(
            model["jparams"])
    if route == "lru_scan_function":
        monkeypatch.setattr(tssm, "scan_from_zero",
                            _lru_scan_through_function)
    if route == "ssm_scan_function":
        monkeypatch.setattr(tssm, "ssm_mix_fused", _ssm_scan_through_function)
    tmodel = build_model(tcfg)
    leaves = {n: p.clone().requires_grad_()
              for n, p in model["tparams"].items()}
    kernels.reset_launch_counts()
    loss = tmodel.loss_fn(leaves, {"tokens": torch.from_numpy(tok).long(),
                                   "labels": torch.from_numpy(lab).long()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    want = params_to_jax(dict(zip(leaves, grads)))
    jax.tree_util.tree_map(lambda g, jg: _grad_close(_t(g), jg), want,
                           jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,width", [("falcon-mamba-7b", 256),
                                        ("falcon-mamba-7b", 1024),
                                        ("recurrentgemma-2b", 256),
                                        ("recurrentgemma-2b", 2560)])
def test_fixed_float32_init_leaves(arch, width):
    """``dt_bias``, ``A_log``, ``D`` and ``lam`` are the reference's
    formulas: ``D`` exactly, ``A_log`` to one float32 ulp (the packages'
    ``log`` differ by an ulp at some entries); ``dt_bias = log(exp(x) -
    1)`` for x from 1e-3 and ``lam`` to 1e-5 relative: an ulp of
    ``linspace`` or ``exp`` grows through the cancellation in ``exp(x) -
    1`` near 0 (measured: at most 6.0e-6 at d_inner 8192, 3.0e-6 at
    2048)."""
    jcfg = jax_get_config(arch).reduced(d_model=width)
    tcfg = get_config(arch).reduced(d_model=width)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    if arch == "falcon-mamba-7b":
        jp = jssm.init_mamba(key, jcfg, jnp.float32)
        tp = tssm.init_mamba(gen, tcfg, torch.float32, lead=(2,))
        rtols = {"A_log": 2.0 ** -23, "D": 0.0, "dt_bias": 1e-5}
    else:
        jp = jrglru.init_rglru_block(key, jcfg, jnp.float32)
        tp = trglru.init_rglru_block(gen, tcfg, torch.float32, lead=(2,))
        rtols = {"lam": 1e-5}
    for k, rtol in rtols.items():
        assert tp[k].dtype == torch.float32
        for u in range(2):
            np.testing.assert_allclose(tp[k][u].numpy(), np.asarray(jp[k]),
                                       rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("arch,n_layers", [("falcon-mamba-7b", 2),
                                           ("recurrentgemma-2b", 3),
                                           ("falcon-mamba-7b", 64),
                                           ("recurrentgemma-2b", 26)])
def test_parameter_trees_match_at_published_dtype(arch, n_layers):
    """Names, shapes and per-leaf dtypes of the mixed bf16 / float32 tree
    at the published widths and dtype (shapes only, nothing allocated)."""
    jcfg = dataclasses.replace(jax_get_config(arch), n_layers=n_layers)
    tcfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    jtree = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat[name] = (tuple(leaf.shape), str(leaf.dtype))
    port = {n: (s, str(d).replace("torch.", ""))
            for n, (s, d) in build_model(tcfg).param_shapes().items()}
    assert port == flat
    assert {d for _, d in port.values()} == {"bfloat16", "float32"}


def test_convert_keeps_each_leafs_dtype():
    cfg = dataclasses.replace(jax_get_config("recurrentgemma-2b").reduced(
        n_layers=3), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(
        n_layers=3), dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(1)))
    params = params_from_jax(tree, tcfg)
    shapes = build_model(tcfg).param_shapes()
    for n, t in params.items():
        assert t.dtype == shapes[n][1], n
    assert params["stages.0.0.rec.lam"].dtype == torch.float32
    assert params["stages.0.0.rec.w_a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["stages.0.0.rec.lam"].numpy(),
                                  tree["stages"][0]["0"]["rec"]["lam"])
