"""The untied LM head, the vocab-chunked loss and the three dense configs
they bring (phi4-mini-3.8b, gemma3-12b, nemotron-4-340b) against the
reference.

* ``chunked_cross_entropy``: the loss and ``jax.grad`` with respect to
  ``x`` and the head of the reference's ``layers.chunked_cross_entropy``
  against the port's ``autograd.Function`` on the same numpy draws
  (B 2, S 8, d 32, V 96): float32 and bfloat16, cap None and 30, one
  chunk, four, and a non-divisor (40) that falls back to one chunk; the
  head as its own ``(d, V)`` array and as a tied ``embed.t()``.  float32:
  the loss to 1e-6 relative, the gradients to 1e-5 of their largest
  magnitude (the port sums ``dx`` over chunks from the last to the first
  in ``x``'s dtype, as the reference's scan transpose does, and writes
  ``dhead`` chunk by chunk).  bfloat16: the loss to 2e-3 relative and the
  gradients to 2e-2 of their largest magnitude (each chunk's product is
  rounded to bf16 in both packages, by matmuls that accumulate in
  different orders; the cotangent is cast to bf16 before the products).
* The reduced phi4-mini-3.8b, gemma3-12b (6 layers, so that its global
  layer runs) and nemotron-4-340b (untied; head dim 64 and 192), float32,
  from the reference's init converted by ``params_from_jax`` (and back,
  ``lm_head`` included, bit for bit): logits 1e-5 of their largest
  magnitude, loss 1e-5 relative and every gradient leaf 1e-4 of its
  largest magnitude against the reference's ``forward`` / ``loss_fn`` /
  ``jax.grad``, with ``chunked_loss`` 0 and 128 (4 chunks of the 512
  reduced vocab).
* The registry: the port's three configs equal the reference's field
  for field.
* Three federated rounds of the reduced nemotron (packed state, fused
  edges and update; mean and topk 0.25) against the reference's
  ``build_trainer`` rounds: losses 1e-5 relative, states 1e-4 absolute
  (topk: apart from at most 64 entries of a variable, each in a column
  where some agent's increment, in either run and some round, had its
  magnitude rank within 3 of the segment's kept count -- the rule of
  ``test_torch_rounds_compressed.py`` over 3 rounds, where a flip moves
  y and so every agent's column; 52 such entries are seen); the port's
  topk on the reference's increments sends the reference's q exactly.  The packed
  layout's segments are the reference's, leaf for leaf.
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
from repro.fed import runtime as jruntime
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.fed import api as tapi
from repro_torch.fed import compress as tcompress
from repro_torch.fed import runtime as truntime
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model

ARCHS = ("phi4-mini-3.8b", "gemma3-12b", "nemotron-4-340b")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(a):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), dtype=np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# chunked_cross_entropy
# ---------------------------------------------------------------------------

B, S, D, V = 2, 8, 32, 96
TOLS = {"float32": (1e-6, 1e-5), "bfloat16": (2e-3, 2e-2)}


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
@pytest.mark.parametrize("chunk", [96, 24, 40])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_cross_entropy_matches_reference(dtype, cap, chunk, tied):
    rng = np.random.default_rng([chunk, int(tied), int(cap or 0),
                                 len(dtype)])
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    # large enough logits that a cap of 30 bends them
    h = (3.0 * rng.standard_normal((V, D) if tied else (D, V))
         ).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jloss(xx, hh):
        return jlayers.chunked_cross_entropy(
            xx, hh.T if tied else hh, jnp.asarray(lab), chunk, cap=cap)

    jx, jh = jnp.asarray(x, jdt), jnp.asarray(h, jdt)
    want = jloss(jx, jh)
    jgx, jgh = jax.grad(jloss, argnums=(0, 1))(jx, jh)

    tx = _t(x).to(tdt).requires_grad_()
    th = _t(h).to(tdt).requires_grad_()
    got = tlayers.chunked_cross_entropy(tx, th.t() if tied else th,
                                        _t(lab), chunk, cap=cap)
    gx, gh = torch.autograd.grad(got, (tx, th))
    assert got.dtype == torch.float32
    assert gx.dtype == gh.dtype == tdt
    loss_tol, grad_tol = TOLS[dtype]
    assert _rel(got, want) <= loss_tol
    assert _rel(gx, jgx) <= grad_tol
    assert _rel(gh, jgh) <= grad_tol


@pytest.mark.parametrize("cap", [None, 30.0])
def test_chunked_equals_full_logits_in_float32(cap):
    """In float32 the two paths' orders coincide: chunked and full-logit
    losses and gradients agree to float32 rounding."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, D), generator=g, requires_grad=True)
    h = (3 * torch.randn((D, V), generator=g)).requires_grad_()
    lab = torch.randint(0, V, (B, S), generator=g)
    full = tlayers.cross_entropy(tlayers.softcap(x @ h, cap), lab)
    chunked = tlayers.chunked_cross_entropy(x, h, lab, 24, cap=cap)
    assert _rel(chunked, full) <= 1e-6
    for a, b in zip(torch.autograd.grad(chunked, (x, h)),
                    torch.autograd.grad(full, (x, h))):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# The reduced models
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "phi4-mini-3.8b": {},
    "gemma3-12b": dict(n_layers=6),
    "nemotron-4-340b": {},
    "nemotron-4-340b-d192": dict(head_dim=192),
}


def _cfgs(case, chunked_loss=0):
    arch = case.removesuffix("-d192")
    kw = dict(MODEL_CASES[case])
    n_layers = kw.pop("n_layers", 2)
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(arch).reduced(n_layers=n_layers)
        out.append(dataclasses.replace(cfg, chunked_loss=chunked_loss, **kw))
    return out


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_case(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    tok = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    return request.param, tree, tok, lab


def test_reduced_configs_keep_their_features(model_case):
    name, tree, _, _ = model_case
    jcfg, tcfg = _cfgs(name)
    assert tcfg == dataclasses.replace(tcfg, **dataclasses.asdict(jcfg))
    assert ("lm_head" in tree) == (not tcfg.tie_embeddings)
    assert ("lm_head" in tree) == name.startswith("nemotron")
    if name == "gemma3-12b":
        assert tcfg.layer_kinds() == ("local",) * 5 + ("global",)
    if name.endswith("d192"):
        assert tcfg.resolved_head_dim == 192


def test_params_round_trip(model_case):
    name, tree, _, _ = model_case
    _, tcfg = _cfgs(name)
    params = params_from_jax(tree, tcfg)
    shapes = build_model(tcfg).param_shapes()
    assert list(params) == list(shapes)
    if not tcfg.tie_embeddings:
        assert shapes["lm_head"] == ((tcfg.d_model, tcfg.vocab),
                                     torch.float32)
    back = params_to_jax(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, back)


def test_port_init_draws_the_head(model_case):
    name, _, _, _ = model_case
    _, tcfg = _cfgs(name)
    p = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(build_model(tcfg).param_shapes())
    if not tcfg.tie_embeddings:
        h = p["lm_head"]
        assert h.shape == (tcfg.d_model, tcfg.vocab)
        assert abs(float(h.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
        assert not torch.equal(h.t()[:4], p["embed"][:4])


def test_logits_match(model_case):
    name, tree, tok, _ = model_case
    jcfg, tcfg = _cfgs(name)
    want = jtfm.forward(tree, jcfg, {"tokens": jnp.asarray(tok)})[0]
    got = build_model(tcfg).forward(params_from_jax(tree, tcfg),
                                    {"tokens": _t(tok).long()})
    assert got.shape == (2, 24, tcfg.vocab)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("chunked_loss", [0, 128])
def test_loss_and_gradients_match(model_case, chunked_loss):
    name, tree, tok, lab = model_case
    jcfg, tcfg = _cfgs(name, chunked_loss)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    want, jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, batch))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    leaves = {n: p.requires_grad_() for n, p in
              params_from_jax(tree, tcfg).items()}
    loss = build_model(tcfg).loss_fn(
        leaves, {"tokens": _t(tok).long(), "labels": _t(lab).long()})
    assert _rel(loss, want) <= 1e-5
    tg = params_to_jax(dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values())))))
    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_rel, tg, jg))
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("chunked_loss", [0, 128])
def test_chunked_loss_keeps_no_logits(model_case, chunked_loss):
    """Autograd keeps a (B, S, V) logits tensor for the backward of the
    full-logit loss and none for the chunked one, whose forward saves x,
    the head, the labels and one float32 per token (a vocab of 384, which
    no other activation of the reduced models has as its width)."""
    name, _, tok, lab = model_case
    _, tcfg = _cfgs(name, chunked_loss)
    tcfg = dataclasses.replace(tcfg, vocab=384)
    model = build_model(tcfg)
    params = {n: p.requires_grad_() for n, p in
              model.init(torch.Generator().manual_seed(0), "cpu").items()}
    logits_shape = (tok.shape[1], tcfg.vocab)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape[-2:]) == logits_shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss_fn(params, {"tokens": _t(tok % 384).long(),
                               "labels": _t(lab % 384).long()})
    assert any(saved) == (chunked_loss == 0)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    build_model(get_config(arch))


# ---------------------------------------------------------------------------
# Federated rounds of the reduced nemotron (untied)
# ---------------------------------------------------------------------------

N, ROUNDS = 2, 3
TOPK = dict(name="topk", ratio=0.25)
ROUND_CASES = {
    "mean": ({}, {}),
    "topk": (dict(compression=japi.CompressionSpec(**TOPK,
                                                   backend="pallas")),
             dict(compression=tapi.CompressionSpec(**TOPK,
                                                   backend="fused"))),
}


def _nemotron():
    return [dataclasses.replace(get("nemotron-4-340b").reduced(),
                                chunked_loss=128)
            for get in (jax_get_config, get_config)]


def test_packed_segments_match_reference():
    jcfg, tcfg = _nemotron()
    jmeta = jruntime.packed_layout(jax_build_model(jcfg),
                                   japi.FedSpec(n_agents=N))
    tmeta = truntime.packed_layout(build_model(tcfg),
                                   tapi.FedSpec(n_agents=N))
    assert tmeta.width == jmeta.width
    assert tmeta.m_total == jmeta.m_total
    # the reference's leaves by path, and the port's by name: each leaf
    # has the same shape and segment length in both layouts, the untied
    # head's among them
    jpaths = ["".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      + "." for k in path)[:-1]
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  jcompress.unpack_leaves(
                      jnp.zeros((N, jmeta.width)), jmeta))[0]]
    jseg = {p: (s1 - s0, sh) for p, (s0, s1), sh in
            zip(jpaths, jmeta.segments, jmeta.shapes)}
    tseg = {p: (s1 - s0, sh) for p, (s0, s1), sh in
            zip(build_model(tcfg).param_shapes(), tmeta.segments,
                tmeta.shapes)}
    assert tseg == jseg
    # the leaves outside the stages come first in both, in one order
    # (embed, final_norm, lm_head), on the same aligned columns
    top = ("embed", "final_norm", "lm_head")
    assert jpaths[:3] == list(top)
    assert list(build_model(tcfg).param_shapes())[:3] == list(top)
    assert tmeta.segments[:3] == jmeta.segments[:3]


def _nemotron_run(name):
    jkw, tkw = ROUND_CASES[name]
    jcfg, tcfg = _nemotron()
    common = dict(n_agents=N, n_epochs=2, gamma=0.05, weight_decay=0.01,
                  state_layout="packed")
    jspec = japi.FedSpec(**common, engine_backend="pallas", use_pallas=True,
                         **jkw)
    tspec = tapi.FedSpec(**common, engine_backend="fused",
                         use_fused_update=True, **tkw)
    jmodel = jax_build_model(jcfg)
    jtr = japi.build_trainer(jmodel, jspec)
    ttr = tapi.build_trainer(build_model(tcfg), tspec, device="cpu")
    key = jax.random.PRNGKey(0)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(key))
    jstates = [jtr.init(key)]
    tstate, gen = ttr.init(0, params=params_from_jax(tree, tcfg))
    tstates = [tstate]
    rng = np.random.default_rng(0)
    jm, tm = [], []
    for i in range(ROUNDS):
        tok = rng.integers(0, jcfg.vocab, (N, 2, 32)).astype(np.int32)
        lab = np.roll(tok, -1, axis=-1)
        jstate, m = jtr.step(jstates[-1], {"tokens": jnp.asarray(tok),
                                           "labels": jnp.asarray(lab)},
                             jax.random.fold_in(key, i))
        jstates.append(jstate)
        jm.append(float(m["loss"]))
        tstate, m = ttr.step(tstate, {"tokens": _t(tok).long(),
                                      "labels": _t(lab).long()}, gen)
        # the step updates its buffers in place: keep this round's copy
        tstates.append(tstate._replace(**{
            v: getattr(tstate, v).clone() for v in ("x", "z", "t")
            if getattr(tstate, v) is not None}))
        tm.append(float(m["loss"]))
    return dict(name=name, jtr=jtr, ttr=ttr, jstates=jstates,
                tstates=tstates, tstate=tstate, jm=jm, tm=tm, tcfg=tcfg,
                jround=jspec.round_config(), tround=tspec.round_config())


@pytest.fixture(scope="module", params=list(ROUND_CASES))
def nemotron_rounds(request):
    return _nemotron_run(request.param)


def _in_reference_layout(r, buf):
    """A port packed state in the reference's packed layout."""
    tree = params_to_jax(tcompress.unpack_leaves(buf, r["ttr"].packed_meta))
    return np.asarray(jcompress.pack_leaves(
        jax.tree_util.tree_map(jnp.asarray, tree))[0])


def _increments(r):
    """Each round's increment z_r - t_{r-1} (packed, the reference's
    layout) in both runs, and the reference's q of its own."""
    meta = r["jtr"].packed_meta
    q_of = jax.jit(lambda d: jcompress.compress_increment_packed(
        d, meta, r["jround"]))
    out = []
    for i in range(1, ROUNDS + 1):
        dz = r["jstates"][i].z - r["jstates"][i - 1].t
        tdz = (_in_reference_layout(r, r["tstates"][i].z)
               - _in_reference_layout(r, r["tstates"][i - 1].t))
        out.append((np.asarray(dz), tdz, np.asarray(q_of(dz))))
    return out


def _near_ties(r):
    """Columns where some agent's magnitude rank lay within 3 of the
    segment's kept count in some round's increment, of either run (a
    flip moves the coordinator's y, so every agent's column follows)."""
    near = np.zeros((N, r["jtr"].packed_meta.width), bool)
    for dz, tdz, q in _increments(r):
        for s0, s1 in r["jtr"].packed_meta.segments:
            for i in range(N):
                k = int(np.count_nonzero(q[i, s0:s1]))
                for d in (dz, tdz):
                    mag = np.abs(d[i, s0:s1])
                    desc = np.sort(mag)[::-1]
                    hi, lo = desc[max(k - 4, 0)], desc[min(k + 2,
                                                           mag.size - 1)]
                    near[:, s0:s1] |= (mag <= hi) & (mag >= lo)
    return near


def test_nemotron_rounds_match(nemotron_rounds):
    r = nemotron_rounds
    np.testing.assert_allclose(r["tm"], r["jm"], rtol=1e-5)
    assert r["tm"][-1] < r["tm"][0]
    compressed = r["name"] == "topk"
    near = _near_ties(r) if compressed else None
    for var in ("x", "z") + (("t",) if compressed else ()):
        want = np.asarray(getattr(r["jstates"][-1], var))
        bad = np.abs(_in_reference_layout(r, getattr(r["tstate"], var))
                     - want) > 1e-4
        if compressed:
            # a float32 rounding may swap two near-equal magnitudes at the
            # k-th place of a segment: such an entry differs by a whole
            # transmitted value
            assert not (bad & ~near).any(), int((bad & ~near).sum())
            assert bad.sum() <= 64, int(bad.sum())
        else:
            assert not bad.any(), var
    tree = params_to_jax(tcompress.unpack_leaves(r["tstate"].x,
                                                 r["ttr"].packed_meta))
    assert "lm_head" in tree
    if compressed:
        # the port's compressor on the reference run's own increments
        # sends the reference's q, segment by segment
        for dz, _, q in _increments(r):
            dz = jcompress.unpack_leaves(jnp.asarray(dz),
                                         r["jtr"].packed_meta)
            buf = tcompress.pack_leaves(params_from_jax(
                jax.tree_util.tree_map(np.asarray, dz), r["tcfg"]),
                r["ttr"].packed_meta)[0]
            got = tcompress.compress_increment_packed(
                buf, r["ttr"].packed_meta, r["tround"])
            np.testing.assert_array_equal(_in_reference_layout(r, got), q)

