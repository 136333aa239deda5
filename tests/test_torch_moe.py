"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``).

Reduced qwen2-moe-a2.7b (swiglu, 4 experts of 256, top-2, one shared
expert) and grok-1-314b (geglu, 4 experts, top-2, attention softcap 30),
d 256, B 2, S 16; one set of parameters (the port's init, as numpy) and
numpy inputs ``x`` and a cotangent ``g`` go to both packages.

* ``moe_ffn`` (the flat route) and ``moe_ffn_grouped`` (capacity a batch
  row), float32: the outputs, the aux loss and the gradients of
  ``sum(out * g) + aux`` with respect to every parameter and ``x`` agree
  to 1e-5 relative (largest difference over the largest entry of the
  reference's leaf: float32 rounding of two matmul orders), and each
  contribution's expert, rank within its expert and slot are equal
  exactly.  The reference's routing is read by its own lines
  (``repro/models/moe.py:52-71, 120-147``), run in JAX here.
  Cases: the published capacity factor 1.25 on both routes; 0.5, so
  contributions are dropped (counted: at least one; qwen2-moe's flat
  route, grok-1's grouped one); a zero router, where every
  probability is equal and top-K must pick experts 0..K-1 for every
  token (ties to the lower index, as ``jax.lax.top_k``); bfloat16 (the
  router stays float32), held to 2^-6 relative on the output and 2^-5
  on the gradients (bf16's 8 bits, rounded at other places by the two
  frameworks; measured below 2^-8 and 2^-7).
* The model: reduced qwen2-moe's loss (``ce + 0.01 aux``, on the full
  logits and on the vocab-chunked path) and its gradients against the
  reference's ``loss_fn``: loss 1e-6 relative, gradients 1e-5.
* ``decode_step`` (the flat route on ``(B, 1, d)``, capacity ``int(1.25 B
  K / E) + 1``) against the reference's at every step of B 4, S 12
  (reduced qwen2-moe with 8 experts: capacity 2, so decode drops
  contributions; at least one is counted); and, at capacity factor 8
  (nothing dropped), against the port's own forward to 2e-2 (the
  reference's ``tests/test_models_smoke.py`` bound).
* One AdamW standard step against the reference's optimizer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model import build_model as jax_build_model
from repro_torch import optim as toptim
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch import train
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model

B, S = 2, 16
ARCHS = {"qwen": "qwen2-moe-a2.7b", "grok": "grok-1-314b"}
# (arch, dtype, capacity factor, zero router, grouped) per case
CASES = {
    f"{arch}-f32-{route}": (arch, "float32", 1.25, False, route == "grouped")
    for arch in ("qwen", "grok") for route in ("flat", "grouped")}
CASES.update({
    "qwen-f32-drops-flat": ("qwen", "float32", 0.5, False, False),
    "grok-f32-drops-grouped": ("grok", "float32", 0.5, False, True),
    "qwen-f32-ties-flat": ("qwen", "float32", 1.25, True, False),
    "qwen-bf16-flat": ("qwen", "bfloat16", 1.25, False, False),
})
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -5)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def layer_params():
    """Float32 MoE parameters of one layer (the port's init, as numpy
    ``{name: array}``), by arch."""
    out = {}
    for key, arch in ARCHS.items():
        p = tmoe.init_moe(torch.Generator().manual_seed(0), _cfgs(arch)[1],
                          torch.float32)
        out[key] = {n: v.numpy() for n, v in _named(p).items()}
    return out


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nested(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _bits_dtype(a, dtype):
    """numpy float32 -> the case's dtype, the same values in both
    packages."""
    return np.asarray(jnp.asarray(a, jnp.dtype(dtype)).astype(jnp.float32))


def _reference_routing(p, x, cfg, grouped):
    """The reference's expert ids, ranks and slots (its own lines)."""
    E, K = cfg.n_experts, cfg.top_k
    Bx, Sx, d = x.shape
    logits = x.reshape(Bx * Sx, d).astype(jnp.float32) @ p["router"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    tokens = Sx if grouped else Bx * Sx
    cap = int(cfg.capacity_factor * tokens * K / E) + 1
    groups = idx.reshape(Bx if grouped else 1, -1)

    def rank_of(fe):
        n = fe.shape[0]
        order = jnp.argsort(fe, stable=True)
        se = fe[order]
        starts = jnp.searchsorted(se, jnp.arange(E), side="left")
        rank_sorted = jnp.arange(n) - starts[se]
        return jnp.zeros(n, jnp.int32).at[order].set(
            rank_sorted.astype(jnp.int32))

    rank = jax.vmap(rank_of)(groups)
    return (np.asarray(groups), np.asarray(rank),
            np.asarray(jnp.minimum(rank, cap)))


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)),
                                                    1e-30))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, S, 256)).astype(np.float32),
            rng.standard_normal((B, S, 256)).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(layer_params, inputs, case):
    arch, dtype, cf, zero_router, grouped = CASES[case]
    params = layer_params[arch]
    jcfg, tcfg = _cfgs(ARCHS[arch], capacity_factor=cf, moe_grouped=grouped,
                       dtype=dtype)
    flat = dict(params)
    if zero_router:
        flat["router"] = np.zeros_like(flat["router"])
    # the float32 router as it is, every other leaf in the case's dtype
    flat = {n: (v if n == "router" else _bits_dtype(v, dtype))
            for n, v in flat.items()}
    x, g = (_bits_dtype(a, dtype) for a in inputs)
    jdt = jnp.dtype(dtype)

    jp = {n: jnp.asarray(v, jnp.float32 if n == "router" else jdt)
          for n, v in flat.items()}

    def jloss(jp, jx):
        out, aux = jmoe.moe_ffn(_nested(jp), jx, jcfg)
        return (jnp.sum(out.astype(jnp.float32) * g) + aux, (out, aux))

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x, jdt))

    tdt = getattr(torch, dtype)
    tp = {n: torch.from_numpy(v).to(torch.float32 if n == "router" else tdt)
          .requires_grad_() for n, v in flat.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tout, taux = tmoe.moe_ffn(_nested(tp), tx, tcfg)
    (torch.sum(tout.float() * torch.from_numpy(g)) + taux).backward()

    out_tol, grad_tol = TOL[dtype]
    assert _rel(tout.detach().float(), np.asarray(jout, np.float32)) <= out_tol
    assert _rel(taux.detach(), jaux) <= 1e-6
    for n in flat:
        assert _rel(tp[n].grad.float(), np.asarray(jgp[n], np.float32)) \
            <= grad_tol, n
    assert _rel(tx.grad.float(), np.asarray(jgx, np.float32)) <= grad_tol

    # expert choice, rank within the expert and slot, exactly
    ids, rank, slot = _reference_routing(
        {"router": jnp.asarray(flat["router"])}, jnp.asarray(x, jdt), jcfg,
        grouped)
    _, _, experts = tmoe.route(tx.detach().reshape(B * S, -1),
                               tp["router"].detach(), tcfg.top_k)
    groups = B if grouped else 1
    cap = tmoe.capacity(tcfg, B * S // groups)
    plan = tmoe.dispatch_plan(experts.reshape(groups, -1), tcfg.n_experts,
                              cap)
    np.testing.assert_array_equal(experts.reshape(groups, -1).numpy(), ids)
    np.testing.assert_array_equal(plan["rank"].numpy(), rank)
    np.testing.assert_array_equal(plan["slot"].numpy(), slot)
    if zero_router:
        np.testing.assert_array_equal(
            ids.reshape(-1, tcfg.top_k),
            np.broadcast_to(np.arange(tcfg.top_k), (B * S, tcfg.top_k)))
    if cf < 1.0 or zero_router:
        assert int((~plan["kept"]).sum()) > 0


def test_dispatch_plan_maps_are_inverse():
    """Every kept contribution has its own buffer row and back; dropped
    contributions and empty rows point past the end (a zero row)."""
    experts = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]]).reshape(1, -1)
    plan = tmoe.dispatch_plan(experts, 4, 2)
    kept = plan["kept"].reshape(-1)
    assert plan["rank"].tolist() == [[0, 0, 1, 0, 2, 1, 0, 3]]
    assert kept.tolist() == [True, True, True, True, False, True, True,
                             False]
    to_buf, from_buf = plan["to_buffer"], plan["from_buffer"]
    assert (to_buf[~kept] == 4 * 2).all()
    for i in torch.nonzero(kept)[:, 0].tolist():
        assert from_buf[to_buf[i]] == i
    assert int((from_buf < 8).sum()) == int(kept.sum())


# ---------------------------------------------------------------------------
# The model: loss with aux, decode, a standard step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_model():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    tree = params_to_jax(build_model(tcfg).init(
        torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    value_and_grad = {  # the reference's loss and gradient, by chunk
        chunk: jax.jit(jax.value_and_grad(lambda p, c=c: jtfm.loss_fn(
            p, c, batch)))
        for chunk, c in ((c, dataclasses.replace(jcfg, chunked_loss=c))
                         for c in (0, 128))}
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, tok=tok, lab=lab,
                value_and_grad=value_and_grad)


@pytest.mark.parametrize("chunked", [0, 128], ids=["logits", "chunked"])
def test_loss_with_aux_matches_reference(qwen_model, chunked):
    m = qwen_model
    tcfg = dataclasses.replace(m["tcfg"], chunked_loss=chunked)
    jl, jg = m["value_and_grad"][chunked](m["tree"])
    tp = {n: p.requires_grad_() for n, p in
          params_from_jax(m["tree"], tcfg).items()}
    tl = build_model(tcfg).loss_fn(
        tp, {"tokens": torch.from_numpy(m["tok"]).long(),
             "labels": torch.from_numpy(m["lab"]).long()})
    grads = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    tg = params_to_jax(dict(zip(tp, grads)))
    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_rel, tg, jg))
    assert max(errs) <= 1e-5, errs


def test_decode_step_matches_reference_with_drops(monkeypatch):
    jcfg, tcfg = (c.reduced(n_experts=8) for c in (
        jax_get_config("qwen2-moe-a2.7b"), get_config("qwen2-moe-a2.7b")))
    Bd, Sd = 4, 12
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    params = tmodel.init(torch.Generator().manual_seed(1), "cpu")
    tree = params_to_jax(params)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (Bd, Sd))
    dropped = []
    plan_of = tmoe.dispatch_plan

    def counting_plan(experts, n_experts, cap):
        plan = plan_of(experts, n_experts, cap)
        dropped.append(int((~plan["kept"]).sum()))
        return plan

    monkeypatch.setattr(tmoe, "dispatch_plan", counting_plan)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, cache=c, tokens=t))
    jcache = jmodel.init_cache(batch=Bd, cache_len=Sd)
    tcache = tmodel.init_cache(Bd, Sd, device="cpu")
    for t in range(Sd):
        jl, jcache = step(tree, jcache, jnp.asarray(toks[:, t], jnp.int32))
        tl, tcache = tmodel.decode_step(params, tcache,
                                        torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    assert tmoe.capacity(tcfg, Bd) == 2
    assert len(dropped) == Sd * tcfg.n_layers and sum(dropped) > 0


def test_decode_matches_own_forward_without_drops():
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": toks})
    cache = model.init_cache(B, S, device="cpu")
    steps = []
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        steps.append(lg)
    assert float((fwd - torch.stack(steps, 1)).abs().max()) < 2e-2


def test_adamw_standard_step_matches_reference(qwen_model):
    m, lr = qwen_model, 1e-3
    jp = jax.tree_util.tree_map(jnp.asarray, m["tree"])
    jopt, topt = joptim.optimizers.adamw(lr), toptim.OPTIMIZERS["adamw"](lr)
    jloss, g = m["value_and_grad"][0](jp)

    @jax.jit
    def jupdate(g, jp):
        upd, _ = jopt.update(g, jopt.init(jp), jp)
        return joptim.apply_updates(jp, upd)

    jp = jupdate(g, jp)
    tp = params_from_jax(m["tree"], m["tcfg"])
    tp, _, tloss = train.standard_step(
        build_model(m["tcfg"]), topt, tp, topt.init(tp),
        {"tokens": torch.from_numpy(m["tok"]).long(),
         "labels": torch.from_numpy(m["lab"]).long()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    got = jax.tree_util.tree_leaves(params_to_jax(tp))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    # AdamW's first step moves an entry by about lr * sign(g): an entry
    # whose gradient is within rounding of 0 may move the other way
    # (tests/test_torch_train_modes.py)
    assert diff.max() <= 2 * lr, diff.max()
    assert int((diff > 1e-4).sum()) <= 1e-3 * diff.size
