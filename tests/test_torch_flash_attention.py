"""The port's flash attention against the JAX reference's, on the CPU.

``repro_torch.kernels.flash_attention`` holds the forward and backward
CUDA kernels; on a CPU tensor its op runs the plain version (``ref.py``),
which the kernels are held to on the card (``chip_smoke.py`` phase 9).
Here, on the same numpy inputs:

* the port's ``flash_attention_ref`` against the reference's
  ``flash_attention_ref`` and against its Pallas kernel in interpret
  mode (at S, T <= 128 or multiples of 128: the Pallas grid
  ``T // block_k`` drops a ragged tail, which the port's kernel does
  not), float32 and bfloat16 (the same bf16 bits go into both
  packages), GQA, causal or not, window None / 3 / 64, softcap None /
  50, and ragged S = T = 100 and 200.  Tolerance: float32 atol 1e-5
  (two summation orders), bfloat16 one ulp (both round one float32
  result once) plus 1e-5 max|ref| (near zero, where the float32 sums
  cancel, the two orders differ by more than a bf16 ulp of the tiny
  result: 4.38e-6 against 4.31e-6 in float32 at one entry of the
  128x4x4x32 causal case).
* the port's closed-form backward, autograd through the CPU op, and the
  ``torch.autograd.Function`` the card uses (run on CPU tensors, where it
  calls the plain forward and the closed-form backward), against
  ``jax.grad`` of the reference's oracle, float32, 1e-5 relative in
  norm; rows with no visible key (S > T + window - 1) included.
* the slice as a whole: the reduced gemma2-2b loss and its gradients
  with every layer's attention sent through that ``Function``, against
  the reference model's loss and ``jax.grad``.
* routing: the CPU op equals ``ref.py``, leaves both launch counters at
  0, and the transformer's CPU layers keep the reference's plain paths.
* the bf16 tensor-core kernels' arithmetic, emulated in plain torch
  (exact bf16 score products summed in float32, the float32 p and ds in
  the kernels' NSPLIT bf16 terms), against the plain versions at phase
  9a's bf16 tolerance; and one bf16 term shown to miss it.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro.models import transformer as jtfm
from repro.models.model import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import build_model

# (S, H, Hkv, D): plain heads, GQA 2:1, MQA 8:1, gemma2's 8 over 4 at
# head_dim 256, and ragged lengths
SHAPES = [(128, 4, 4, 32), (256, 4, 2, 64), (256, 8, 1, 32),
          (256, 8, 4, 256), (100, 8, 4, 64), (200, 4, 2, 32)]
PALLAS_SHAPES = [s for s in SHAPES if s[0] <= 128 or s[0] % 128 == 0]
MASKS = [(causal, window) for causal in (True, False)
         for window in (None, 3, 64)]
CAPS = (None, 50.0)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs (the suite runs several
    test workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(S, H, Hkv, D, seed, T=None, B=2):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32))


def _pair(x, dtype):
    """The same values in both packages: float32, or bf16 bit patterns
    rounded once by torch."""
    t = torch.from_numpy(x)
    if dtype == "f32":
        return t, jnp.asarray(x)
    t = t.to(torch.bfloat16)
    bits = t.view(torch.int16).numpy().copy()
    return t, jnp.asarray(bits.view(jnp.bfloat16))


def _assert_close(port, want, dtype, what=""):
    a = port.float().numpy()
    b = np.asarray(want).astype(np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=what)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - b) > ulp + 1e-5 * np.abs(b).max()
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries beyond one "
                           f"bf16 ulp, max abs {np.abs(a - b).max()}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_reference_oracle(shape, causal, window, cap,
                                                dtype):
    q, k, v = (_pair(a, dtype) for a in _inputs(*shape, seed=sum(shape)))
    kw = dict(causal=causal, window=window, cap=cap)
    o, lse = tref.flash_attention_ref(q[0], k[0], v[0], **kw)
    want = jref(q[1], k[1], v[1], **kw)
    assert o.dtype == q[0].dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, shape[1], shape[0])
    _assert_close(o, want, dtype, f"{shape} {kw}")
    assert bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", PALLAS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_pallas_kernel(shape, causal, window, cap,
                                             dtype):
    q, k, v = (_pair(a, dtype) for a in _inputs(*shape, seed=sum(shape) + 1))
    kw = dict(causal=causal, window=window, cap=cap)
    o, _ = tops.flash_attention_fwd(q[0], k[0], v[0], **kw)
    want = jops.flash_attention(q[1], k[1], v[1], interpret=True, **kw)
    _assert_close(o, want, dtype, f"{shape} {kw}")


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    q, k, v = (torch.from_numpy(a) for a in _inputs(40, 4, 2, 16, seed=3))
    _, lse = tref.flash_attention_ref(q, k, v, causal=True, window=5,
                                      cap=50.0)
    s, _ = tref._scores(q, k, 50.0)
    s = torch.where(tref.visible_mask(40, 40, True, 5), s, tref.NEG_INF)
    want = torch.logsumexp(s, dim=-1).reshape(2, 4, 40)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_rows_without_a_visible_key_give_the_mean_of_v():
    """S > T + window - 1: the last rows see no key; the finite fill
    makes them the mean of v (not NaN), as in the reference."""
    q, k, v = _inputs(12, 2, 1, 8, seed=4, T=5)
    o, lse = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                      causal=True, window=3)
    dead = np.arange(12) >= 5 + 3 - 1
    mean = v.mean(axis=1)                                # (B, Hkv, D)
    np.testing.assert_allclose(o.numpy()[:, dead],
                               np.broadcast_to(mean[:, None, [0, 0]],
                                               o[:, dead].shape),
                               atol=1e-6)
    assert bool((lse[:, :, torch.from_numpy(dead)] == tref.NEG_INF).all())
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jref(q, k, v, causal=True, window=3)),
        atol=1e-5)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

GRAD_SHAPES = [(64, 4, 4, 32, 64), (100, 8, 4, 64, 100), (128, 4, 2, 16, 128),
               (24, 4, 2, 16, 6)]          # (S, H, Hkv, D, T)


def _grads_torch(method, q, k, v, do, kw):
    if method == "closed_form":
        o, lse = tref.flash_attention_ref(q, k, v, **kw)
        return tref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if method == "cpu_op":
        o = tops.flash_attention(*leaves, **kw)
    else:                                  # the card's autograd Function
        o = tops.FlashAttention.apply(*leaves, kw["causal"], kw["window"],
                                      kw["cap"])
    return torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("method", ["closed_form", "cpu_op", "function"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", GRAD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_jax_grad(shape, causal, window, cap, method):
    S, H, Hkv, D, T = shape
    q, k, v = _inputs(S, H, Hkv, D, seed=S + T, T=T)
    do = np.random.default_rng(S).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap)
    want = jax.grad(lambda a, b, c: jnp.sum(jref(a, b, c, **kw) * do),
                    argnums=(0, 1, 2))(q, k, v)
    got = _grads_torch(method, *map(torch.from_numpy, (q, k, v, do)), kw)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-5, f"d{name}: relative error {err}"


def test_backward_of_bf16_inputs_is_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(32, 4, 2, 16, seed=6))
    o, lse = tref.flash_attention_ref(q, k, v, window=8, cap=50.0)
    grads = tref.flash_attention_bwd_ref(q, k, v, o, lse, torch.ones_like(o),
                                         window=8, cap=50.0)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


# ---------------------------------------------------------------------------
# The slice as a whole: the model with the kernel's autograd Function
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_setup():
    jcfg = dataclasses.replace(jax_get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    tcfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                               n_kv_heads=2)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
    return jcfg, tcfg, jp, tp, tok, np.roll(tok, -1, axis=-1)


class _FlashAttnLib:
    """``models.attention`` with both full-sequence paths sent through the
    kernel's autograd Function, with the arguments the card's layer
    passes (local: causal with the window; global: the config's causal
    flag, no window)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return getattr(tattn, name)

    def _flash(self, q, k, v, causal, window, cap):
        self.calls.append(window)
        o = tops.FlashAttention.apply(q, k, v, causal, window, cap)
        return o.reshape(q.shape[0], q.shape[1], -1)

    def attn_block_local(self, q, k, v, *, window, cap=None):
        return self._flash(q, k, v, True, window, cap)

    def attn_chunked(self, q, k, v, *, causal=True, window=None, cap=None,
                     chunk=1024):
        return self._flash(q, k, v, causal, window, cap)


def test_model_loss_and_gradients_through_the_kernel_function(model_setup,
                                                              monkeypatch):
    jcfg, tcfg, jp, tp, tok, lab = model_setup
    calls = []
    monkeypatch.setattr(ttfm, "attn_lib", _FlashAttnLib(calls))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    jloss, jg = jax.value_and_grad(lambda p: jtfm.loss_fn(p, jcfg, jb))(jp)
    leaves = {n: p.clone().requires_grad_() for n, p in tp.items()}
    loss = build_model(tcfg).loss_fn(
        leaves, {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(lab).long()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert calls == [tcfg.window, None]        # local, then global
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5,
                               rtol=0)
    tg = params_to_jax(dict(zip(leaves, grads)))

    def rel(a, b):
        a = np.asarray(a)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))

    errs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(rel, jg, tg))
    assert max(errs) <= 1e-4, errs


def test_cpu_layers_keep_the_reference_plain_paths(model_setup, monkeypatch):
    """On the CPU the transformer never calls the kernel's op: the CPU
    trainer's parity with the reference does not move."""
    _, tcfg, _, tp, tok, lab = model_setup

    def refuse(*a, **kw):
        raise AssertionError("flash_attention called on a CPU tensor")

    monkeypatch.setattr(ttfm.flash_ops, "flash_attention", refuse)
    loss = build_model(tcfg).loss_fn(
        tp, {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# Routing, counters, operand checks
# ---------------------------------------------------------------------------

def test_cpu_op_is_the_plain_version_and_counts_no_launch():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(50, 4, 2, 16, seed=7))
    o = tops.flash_attention(q, k, v, window=7, cap=50.0)
    assert torch.equal(o, tref.flash_attention_ref(q, k, v, window=7,
                                                   cap=50.0)[0])
    o.sum().backward()
    tops.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(),
                             *tops.flash_attention_fwd(q, k, v)[1:],
                             torch.ones_like(o))
    counts = kernels.launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_bwd"] == 0


def test_suite_is_registered():
    counts = kernels.launch_counts()
    assert {"flash_attention_fwd", "flash_attention_bwd"} <= set(counts)
    assert tkernel.SOURCE in kernels.kernel_sources()
    assert tkernel.SOURCE.name == "flash_attention.cu"


@pytest.mark.parametrize("case", ["cpu", "head_dim", "head_dim_4", "heads",
                                  "window", "cap", "dtype", "lse",
                                  "misaligned", "head_dim_8_bf16",
                                  "misaligned_bf16"])
def test_kernel_launchers_check_operands(case):
    """The launchers raise before any build on what the kernels do not
    take (the CPU case: the kernels take CUDA tensors only)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 4, 2, 16, seed=8))
    kw = dict(causal=True, window=None, cap=None)
    if case == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (264,)) for t in (q, k, v))
    elif case == "head_dim_4":
        q, k, v = (torch.zeros(t.shape[:3] + (18,)) for t in (q, k, v))
    elif case == "misaligned":
        # contiguous, but one element past an aligned allocation
        k = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    elif case == "head_dim_8_bf16":
        # the TMA copies of the bf16 kernels move 16-byte rows
        q, k, v = (torch.zeros(t.shape[:3] + (12,), dtype=torch.bfloat16)
                   for t in (q, k, v))
    elif case == "misaligned_bf16":
        # four bf16 elements (8 bytes) past an aligned allocation
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        k = torch.zeros(k.numel() + 4, dtype=torch.bfloat16)[4:].view(
            k.shape)
    elif case == "heads":
        q = torch.zeros(2, 8, 3, 16)
    elif case == "window":
        kw["window"] = 0
    elif case == "cap":
        kw["cap"] = -1.0
    elif case == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    match = {"cpu": "CUDA", "head_dim": "head_dim", "head_dim_4": "multiple",
             "heads": "Hkv", "window": "window", "cap": "softcap",
             "dtype": "float32", "lse": "lse", "misaligned": "aligned",
             "head_dim_8_bf16": "multiple of 8",
             "misaligned_bf16": "aligned"}[case]
    with pytest.raises((ValueError, TypeError), match=match):
        if case == "lse":
            tkernel.flash_bwd(q, k, v, q, torch.zeros(2, 4, 7), q, **kw)
        else:
            tkernel.flash_fwd(q, k, v, **kw)


# ---------------------------------------------------------------------------
# On the card (skipped without one; chip_smoke.py phase 9 is the full check)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py phase 9 is their full check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((2, 100, 8, 64), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, 100, 4, 64), generator=gen, device=cuda_device)
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dtype)
    kw = dict(causal=True, window=7, cap=50.0)
    kernels.reset_launch_counts()
    o, lse = tops.flash_attention_fwd(q, k, v, **kw)
    po, plse = tref.flash_attention_ref(q, k, v, **kw)
    grads = tops.flash_attention_bwd(q, k, v, po, plse, do, **kw)
    want = tref.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=1e-4 * float(w.abs().max()),
                                   rtol=tol)
    assert kernels.launch_counts()["flash_attention_fwd"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1


# ---------------------------------------------------------------------------
# The bfloat16 tensor-core kernels' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

# the kernels' number of bf16 terms of the float32 p and ds
NSPLIT = int(re.search(r"constexpr int NSPLIT = (\d+);",
                       tkernel.SOURCE.read_text()).group(1))
KEY_STEP = 64            # keys of a forward step (the online softmax's blocks)


def _bf16_terms(x, n):
    """float32 ``x`` as ``n`` bf16 terms (each held in float32): term t is
    bf16 of ``x`` less the terms before it."""
    terms = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def _split_einsum(eq, a, b, n):
    """``einsum(eq, a, b)`` with the float32 ``a`` split into ``n`` bf16
    terms, one float32 product per term (as one wgmma per term)."""
    return sum(torch.einsum(eq, t, b) for t in _bf16_terms(a, n))


def _emulated_fwd(q, k, v, n, *, causal, window, cap):
    """The forward kernel's arithmetic on bf16 q, k, v: exact bf16 score
    products summed in float32, the float32 online softmax over steps of
    64 keys, ``p v`` with p in ``n`` bf16 terms; ``(o, lse)``."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    s, _ = tref._scores(q, k, cap)                       # (B, Hkv, G, S, T)
    s = torch.where(tref.visible_mask(S, T, causal, window), s, tref.NEG_INF)
    vf = v.float()
    m = torch.full(s.shape[:-1] + (1,), tref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (D,))
    for k0 in range(0, T, KEY_STEP):
        x = s[..., k0:k0 + KEY_STEP]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _split_einsum("bhgst,bthd->bhgsd", p,
                                         vf[:, k0:k0 + KEY_STEP], n)
        m = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    lse = (m + torch.log(l))[..., 0].reshape(B, H, S)
    return o.to(q.dtype), lse


def _emulated_bwd(q, k, v, o, lse, do, n, *, causal, window, cap):
    """The backward kernels' arithmetic: p and ds in float32 from exact
    bf16 score products, then ``p^T dO``, ``ds^T q`` and ``ds k`` with p
    and ds in ``n`` bf16 terms; the heads of a group summed in float32."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    s, qg = tref._scores(q, k, cap)
    mask = tref.visible_mask(S, T, causal, window)
    dead = ~mask.any(dim=-1)[:, None]
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, G, S)[..., None]),
                    0.0)
    p = torch.where(dead, 1.0 / T, p)
    dog = do.reshape(B, S, Hkv, G, D).float()
    delta = (dog * o.reshape(B, S, Hkv, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bshgd,bthd->bhgst", dog, v.float())
    ds = torch.where(mask, p * (dp - delta), 0.0)
    if cap is not None:
        ds = ds * (1.0 - (s / cap) ** 2)
    ds = ds * D ** -0.5
    dv = _split_einsum("bhgst,bshgd->bthd", p, dog, n)
    dk = _split_einsum("bhgst,bshgd->bthd", ds, qg, n)
    dq = _split_einsum("bhgst,bthd->bshgd", ds, k.float(), n)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _beyond_bf16_tolerance(port, want):
    """Entries of ``port`` beyond phase 9a's bf16 tolerance of ``want``:
    one bf16 ulp plus 1e-5 max|want| (as ``_assert_close``)."""
    a, b = port.float(), want.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * b.abs().max()
    return int((~((a - b).abs() <= tol)).sum())


def _emulated_errors(shape, n, kw, seed):
    """{output: entries beyond the tolerance} of the emulated kernels with
    ``n`` terms against the plain versions, on bf16 inputs of ``shape``
    ``(B, S, T, H, Hkv, D)``; the backward of both gets the plain
    forward's o and lse, as phase 9a gives them."""
    B, S, T, H, Hkv, D = shape
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(S, H, Hkv, D, seed=seed, T=T, B=B))
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)).to(torch.bfloat16)
    po, plse = tref.flash_attention_ref(q, k, v, **kw)
    o, lse = _emulated_fwd(q, k, v, n, **kw)
    # o at the bf16 tolerance; the float32 lse at 9a's 1e-5 max(1, |ref|)
    out = {"o": _beyond_bf16_tolerance(o, po),
           "lse": int((~((lse - plse).abs()
                         <= 1e-5 * plse.abs().clamp_min(1.0))).sum())}
    want = tref.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
    got = _emulated_bwd(q, k, v, po, plse, do, n, **kw)
    out.update({name: _beyond_bf16_tolerance(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), got, want)})
    return out


# (B, S, T, H, Hkv, D) and the masks: phase 9a's bf16 shapes (S = T up to
# 1000, GQA 8:4 / 8:8 / 8:1, D 64-256), its dead rows (T < S), the main
# path's global and local layer, recurrentgemma-2b's MQA layer
EMULATED = [
    ((2, 7, 7, 8, 4, 64), dict(causal=True, window=None, cap=50.0)),
    ((2, 64, 64, 8, 8, 128), dict(causal=False, window=3, cap=None)),
    ((2, 128, 128, 8, 1, 256), dict(causal=True, window=100, cap=50.0)),
    ((2, 1000, 1000, 8, 4, 64), dict(causal=True, window=None, cap=50.0)),
    ((2, 1000, 1000, 8, 1, 128), dict(causal=False, window=100, cap=None)),
    ((2, 300, 40, 8, 4, 64), dict(causal=True, window=100, cap=50.0)),
    ((2, 512, 512, 8, 4, 256), dict(causal=True, window=None, cap=50.0)),
    ((2, 512, 512, 8, 4, 256), dict(causal=True, window=4096, cap=50.0)),
    ((2, 512, 512, 10, 1, 256), dict(causal=True, window=2048, cap=None)),
]


@pytest.mark.parametrize("shape,kw", EMULATED,
                         ids=[f"{'x'.join(map(str, s))}-{kw['window']}-"
                              f"{kw['cap']}" for s, kw in EMULATED])
def test_emulated_tensor_core_arithmetic_meets_the_bf16_tolerance(shape,
                                                                   kw):
    """The bf16 kernels' numerics (NSPLIT bf16 terms of p and ds) against
    the plain versions at phase 9a's bf16 tolerance, unloosened."""
    bad = _emulated_errors(shape, NSPLIT, kw, seed=sum(shape))
    assert not any(bad.values()), f"{bad} beyond the tolerance"


def test_launcher_names_the_kernels_term_count():
    """kernel.NSPLIT (read by chip_smoke.py's bound) is the source's."""
    assert tkernel.NSPLIT == NSPLIT


def test_one_bf16_term_of_p_misses_the_bf16_tolerance():
    """The split is needed: with p and ds rounded to one bf16 term the
    main path's shape has entries beyond the tolerance."""
    bad = _emulated_errors((2, 512, 512, 8, 4, 256), 1,
                              dict(causal=True, window=None, cap=50.0),
                              seed=1)
    assert NSPLIT > 1
    assert any(bad.values()), bad
