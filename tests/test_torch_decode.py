"""The port's decode / serve path against the reference's.

* ``decode_step``: reduced gemma2-2b (local ring and global caches),
  phi4-mini-3.8b (global, untied head), falcon-mamba-7b (Mamba cache) and
  recurrentgemma-2b (RG-LRU cache and a local ring), float32, B 2, S 24:
  S is longer than the reduced window of 16, so the ring caches wrap.
  From the same parameters and tokens, the port's logits match the
  reference's (its decode step jitted) to 1e-4 absolute at every step,
  and the port's own parallel forward to 2e-2 (the reference's bound,
  ``tests/test_models_smoke.py``).  ``long_ctx=True`` once: gemma2-2b's
  global layer on its ring of ``long_ctx_global_window`` (32), S 40.
* The reference's serving cases (``tests/test_serving.py``) in the port:
  slot isolation, ``reset_slots``, staggered positions.
* Greedy ``generate`` gives the reference's tokens on reduced gemma2-2b;
  a token may differ only where the reference's top two logits lie within
  1e-5 (a near-tie that float32 rounding can flip), after which the two
  continuations are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_to_jax
from repro_torch.launch import serve as tserve
from repro_torch.models.decode import reset_slots
from repro_torch.models.model import build_model

B, S = 2, 24
ARCHS = ["gemma2-2b", "phi4-mini-3.8b", "falcon-mamba-7b",
         "recurrentgemma-2b"]


def _models(arch):
    """Both packages' reduced models and one set of parameters (the
    port's init, as numpy for the reference)."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    params = tmodel.init(torch.Generator().manual_seed(1), "cpu")
    return jcfg, tcfg, jmodel, tmodel, params_to_jax(params), params


def _decode_both(arch, S, long_ctx=False):
    jcfg, _, jmodel, tmodel, tree, params = _models(arch)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                       jcfg.vocab, jnp.int32))
    step = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, cache=c, tokens=t, long_ctx=long_ctx))
    jcache = jmodel.init_cache(batch=B, cache_len=S, long_ctx=long_ctx)
    tcache = tmodel.init_cache(B, S, long_ctx=long_ctx, device="cpu")
    ref, got = [], []
    for t in range(S):
        lg, jcache = step(tree, jcache, jnp.asarray(toks[:, t]))
        tl, tcache = tmodel.decode_step(params, tcache,
                                        torch.from_numpy(toks[:, t]),
                                        long_ctx=long_ctx)
        ref.append(np.asarray(lg))
        got.append(tl.numpy())
    assert tcache["pos"].tolist() == [S] * B
    return dict(toks=toks, ref=np.stack(ref, 1), got=np.stack(got, 1),
                tmodel=tmodel, params=params)


@pytest.fixture(scope="module", params=ARCHS)
def decoded(request):
    return _decode_both(request.param, S)


def test_decode_step_matches_reference(decoded):
    np.testing.assert_allclose(decoded["got"], decoded["ref"], atol=1e-4,
                               rtol=0)


def test_decode_matches_own_forward(decoded):
    fwd = decoded["tmodel"].forward(
        decoded["params"], {"tokens": torch.from_numpy(decoded["toks"])})
    assert float(np.abs(fwd.numpy() - decoded["got"]).max()) < 2e-2


def test_long_context_decode_matches_reference():
    out = _decode_both("gemma2-2b", 40, long_ctx=True)
    np.testing.assert_allclose(out["got"], out["ref"], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Serving: per-sequence positions, slot isolation, slot reset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gemma2-2b", "falcon-mamba-7b"])
def serving(request):
    cfg = get_config(request.param).reduced()
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(1), "cpu")


def _decode_seq(model, params, toks, B_pad=1, lane=0, other_toks=None,
                cache_len=32):
    """Decode ``toks`` in lane ``lane`` of a ``B_pad``-slot batch; other
    lanes run ``other_toks`` (or idle)."""
    cache = model.init_cache(B_pad, cache_len, device="cpu")
    outs = []
    for t in range(len(toks)):
        batch_toks = torch.zeros(B_pad, dtype=torch.int32)
        batch_toks[lane] = toks[t]
        if other_toks is not None:
            for b in range(B_pad):
                if b != lane:
                    batch_toks[b] = other_toks[(t + b) % len(other_toks)]
        logits, cache = model.decode_step(params, cache, batch_toks)
        outs.append(logits[lane])
    return torch.stack(outs)


def test_slot_isolation(serving):
    """A sequence's logits are the same whether it runs alone or next to
    unrelated sequences in other slots (continuous batching)."""
    model, params = serving
    toks = [3, 17, 5, 9, 11]
    alone = _decode_seq(model, params, toks, B_pad=1, lane=0)
    crowd = _decode_seq(model, params, toks, B_pad=3, lane=1,
                        other_toks=[101, 55, 7, 42])
    np.testing.assert_allclose(alone.numpy(), crowd.numpy(), atol=2e-3)


def test_reset_slots_frees_state(serving):
    """After reset_slots the freed lane reproduces a fresh sequence."""
    model, params = serving
    toks = [3, 17, 5]
    fresh = _decode_seq(model, params, toks, B_pad=2, lane=0)
    cache = model.init_cache(2, 32, device="cpu")
    for t in [9, 8, 7, 6]:
        _, cache = model.decode_step(params, cache, torch.tensor([t, t + 1]))
    cache = reset_slots(cache, torch.tensor([True, False]))
    outs = []
    for t in toks:
        logits, cache = model.decode_step(params, cache, torch.tensor([t, 1]))
        outs.append(logits[0])
    np.testing.assert_allclose(fresh.numpy(), torch.stack(outs).numpy(),
                               atol=2e-3)


def test_staggered_positions(serving):
    """Sequences at different depths coexist: positions advance per
    sequence after a reset."""
    model, params = serving
    cache = model.init_cache(2, 16, device="cpu")
    for _ in range(4):
        _, cache = model.decode_step(params, cache, torch.tensor([1, 2]))
    cache = reset_slots(cache, torch.tensor([True, False]))
    _, cache = model.decode_step(params, cache, torch.tensor([1, 2]))
    assert cache["pos"].tolist() == [1, 5]


# ---------------------------------------------------------------------------
# Greedy generation
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_reference():
    jcfg, _, jmodel, tmodel, tree, params = _models("gemma2-2b")
    P, G = 8, 8
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, P), 0,
                                          jcfg.vocab, jnp.int32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jserve.generate(jmodel, jparams, jnp.asarray(prompts),
                                     gen_len=G, cache_len=P + G))
    got = tserve.generate(tmodel, params, torch.from_numpy(prompts),
                          gen_len=G, cache_len=P + G).numpy()
    assert got.shape == ref.shape == (B, G) and got.dtype == np.int32
    if np.array_equal(got, ref):
        return
    # the reference's logits along its own tokens, to tell a near-tie
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, cache=c, tokens=t))
    cache = jmodel.init_cache(batch=B, cache_len=P + G)
    logits = []
    for t in np.concatenate([prompts, ref], axis=1).T[:P + G - 1]:
        lg, cache = step(jparams, cache, jnp.asarray(t))
        logits.append(np.asarray(lg))
    logits = np.stack(logits[P - 1:], axis=1)            # (B, G, V)
    for b in range(B):
        for t in range(G):
            if got[b, t] != ref[b, t]:
                top2 = np.sort(logits[b, t])[-2:]
                assert top2[1] - top2[0] <= 1e-5, (b, t, top2)
                break
