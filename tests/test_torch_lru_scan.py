"""The port's lru_scan against the JAX reference's, on the CPU.

``repro_torch.kernels.lru_scan`` holds the forward and backward CUDA
kernels of the recurrence ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``);
on a CPU tensor its op runs the plain version (``ref.py``), which the
kernels are held to on the card, bit for bit (``chip_smoke.py`` phase
10a).  Here, on the same numpy inputs (a drawn in (0, 1) as the
reference's own tests draw it):

* the port's ``lru_scan_ref`` against the reference's oracle, float32
  and bfloat16 (the same bf16 bits go into both packages), at the
  reference's kernel-test shapes and at ragged S = 129 and 200; and
  against its Pallas kernel in interpret mode at S <= 128 or multiples
  of 128 (the Pallas grid ``S // chunk`` drops a ragged tail, which the
  port's kernel does not), the 4-D ``(B, S, W, N)`` fold included.
  Tolerance: float32 1e-5 relative plus 1e-6 absolute (the port walks
  time in order, the reference's associative scan rounds in XLA's
  order); bfloat16 one ulp (both round one float32 result once).
* ``lru_scan_bwd_ref``, autograd through the CPU op and the
  ``torch.autograd.Function`` the card uses (run on CPU tensors, where
  it calls the plain forward and backward), against ``jax.vjp`` of the
  reference's oracle, float32, 1e-5 relative in norm.
* routing: the CPU op equals ``ref.py`` and leaves both launch counters
  at 0; the launchers raise on operands the kernels do not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lru_scan import ops as jops
from repro.kernels.lru_scan.ref import lru_scan_ref
from repro_torch import kernels
from repro_torch.kernels.lru_scan import kernel as tkernel
from repro_torch.kernels.lru_scan import ops as tops
from repro_torch.kernels.lru_scan import ref as tref

jref = jax.jit(lru_scan_ref)

# the reference's kernel-test shapes (tests/test_kernels.py) and ragged S
SHAPES = [(1, 128, 16), (2, 256, 32), (3, 64, 8), (2, 129, 8), (1, 200, 5)]
PALLAS_SHAPES = [s for s in SHAPES if s[1] <= 128 or s[1] % 128 == 0]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.normal(size=shape)))
    return (a.astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


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
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=what)
        return
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(a - b) > ulp
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries beyond one "
                           f"bf16 ulp, max abs {np.abs(a - b).max()}")


def _close_in_norm(port, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    err = np.linalg.norm(port.detach().float().numpy() - want)
    return err <= rtol * np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_oracle(shape, dtype):
    a, b = (_pair(x, dtype) for x in _inputs(shape, sum(shape)))
    h = tref.lru_scan_ref(a[0], b[0])
    assert h.dtype == a[0].dtype and tuple(h.shape) == shape
    _assert_close(h, jref(a[1], b[1]), dtype, f"{shape}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES + [(2, 128, 8, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_kernel(shape, dtype):
    a, b = (_pair(x, dtype) for x in _inputs(shape, sum(shape) + 1))
    h = tops.lru_scan(a[0], b[0])
    assert tuple(h.shape) == shape
    _assert_close(h, jops.lru_scan(a[1], b[1], interpret=True), dtype,
                  f"{shape}")


def test_recurrence_edge_values():
    """a = 0 restarts from b, a = 1 sums, |a| > 1 and negative a grow and
    flip; a NaN poisons its column from its step on."""
    b = torch.tensor([[[1.0, 1.0, 1.0, 1.0, 1.0]]]).expand(1, 4, 5).clone()
    a = torch.tensor([0.0, 1.0, 2.0, -1.0, 1.0]).expand(1, 4, 5).clone()
    a[0, 2, 4] = float("nan")
    h = tref.lru_scan_ref(a, b)
    torch.testing.assert_close(h[0, :, :4], torch.tensor(
        [[1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 0.0], [1.0, 3.0, 7.0, 1.0],
         [1.0, 4.0, 15.0, 0.0]]))
    assert torch.equal(torch.isnan(h[0, :, 4]),
                       torch.tensor([False, False, True, True]))


@pytest.mark.parametrize("shape", [(2, 64, 8), (1, 129, 5), (3, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_vjp(shape):
    a, b = _inputs(shape, 7 + sum(shape))
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(jref, jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(g))
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))

    # the closed form, given the forward's h
    da, db = tref.lru_scan_bwd_ref(ta, tref.lru_scan_ref(ta, tb), tg)
    # autograd through the CPU op, and through the card's Function
    grads = {"closed form": (da, db)}
    for name, fn in (("cpu op", tops.lru_scan),
                     ("LruScan", tops.LruScan.apply)):
        la, lb = ta.clone().requires_grad_(), tb.clone().requires_grad_()
        grads[name] = torch.autograd.grad(fn(la, lb), (la, lb), tg)
    for name, (ga, gb) in grads.items():
        assert _close_in_norm(ga, want_da), name
        assert _close_in_norm(gb, want_db), name
    # h_{-1} = 0: the first step's a has no gradient
    assert not bool(grads["closed form"][0][:, 0].any())


def test_backward_4d_fold_matches_3d():
    a, b = (torch.from_numpy(x).requires_grad_()
            for x in _inputs((2, 32, 3, 4), 5))
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32, 3, 4)).astype(np.float32))
    got = torch.autograd.grad(tops.lru_scan(a, b), (a, b), g)
    a3, b3 = (t.detach().reshape(2, 32, 12).requires_grad_() for t in (a, b))
    want = torch.autograd.grad(tops.LruScan.apply(a3, b3), (a3, b3),
                               g.reshape(2, 32, 12))
    for x, y in zip(got, want):
        assert torch.equal(x, y.reshape(2, 32, 3, 4))


def test_bf16_backward_reads_stored_h():
    """In bfloat16 the backward takes h as stored (rounded), and rounds
    da and db once from float32."""
    a, b = (torch.from_numpy(x) for x in _inputs((2, 16, 4), 3))
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 16, 4)).astype(np.float32))
    a16, b16, g16 = (t.to(torch.bfloat16) for t in (a, b, g))
    h16 = tref.lru_scan_ref(a16, b16)
    da, db = tref.lru_scan_bwd_ref(a16, h16, g16)
    want = tref.lru_scan_bwd_ref(a16.float(), h16.float(), g16.float())
    assert da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(da, want[0].to(torch.bfloat16))
    assert torch.equal(db, want[1].to(torch.bfloat16))


def test_cpu_op_is_the_plain_version_and_counts_no_launch():
    kernels.reset_launch_counts()
    a, b = (torch.from_numpy(x).requires_grad_()
            for x in _inputs((2, 40, 6), 9))
    h = tops.lru_scan(a, b)
    assert torch.equal(h, tref.lru_scan_ref(a, b))
    h.sum().backward()
    tops.lru_scan_bwd(a.detach(), h.detach(), torch.ones_like(h))
    counts = kernels.launch_counts()
    assert counts["lru_scan_fwd"] == 0 and counts["lru_scan_bwd"] == 0


def test_suite_is_registered():
    assert {"lru_scan_fwd", "lru_scan_bwd"} <= set(kernels.launch_counts())
    assert tkernel.SOURCE in kernels.kernel_sources()
    assert tkernel.SOURCE.name == "lru_scan.cu"


@pytest.mark.parametrize("case", ["cpu", "ndim", "float64", "float16"])
def test_kernel_launchers_check_operands(case):
    """The launchers raise before any build on what the kernels do not
    take (the CPU case: the kernels take CUDA tensors only; shape,
    dtype and contiguity of the other operands are checked after the
    device, by the check every suite shares)."""
    a, b = (torch.from_numpy(x) for x in _inputs((2, 8, 4), 4))
    if case == "ndim":
        a, b = a[0], b[0]
    elif case in ("float64", "float16"):
        a, b = (t.to(getattr(torch, case)) for t in (a, b))
    match = {"cpu": "CUDA", "ndim": r"\(B, S, W\)", "float64": "float32",
             "float16": "float32"}[case]
    with pytest.raises((ValueError, TypeError), match=match):
        tkernel.lru_fwd(a, b)
    with pytest.raises((ValueError, TypeError), match=match):
        tkernel.lru_bwd(a, a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_takes_misaligned_views(dtype):
    """Operands one element past an aligned allocation, which the card's
    per-column kernel takes where TMA cannot copy them, at widths and
    lengths on both sides of the ring kernel's 32-column, 32-step tiles:
    the plain forward and backward give the oracle's result, and the same
    bits as on aligned copies."""
    for shape in ((2, 31, 33), (1, 33, 32), (3, 32, 1)):
        a, b = (_pair(x, dtype) for x in _inputs(shape, sum(shape)))
        g = torch.from_numpy(np.random.default_rng(5).normal(
            size=shape).astype(np.float32)).to(a[0].dtype)
        views = [torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(shape)
                 .copy_(t) for t in (a[0], b[0], g)]
        assert all(v.data_ptr() % 16 != 0 for v in views)
        h = tref.lru_scan_ref(*views[:2])
        _assert_close(h, jref(a[1], b[1]), dtype, f"{shape}")
        assert torch.equal(h, tref.lru_scan_ref(a[0], b[0]))
        for got, want in zip(tref.lru_scan_bwd_ref(views[0], h, views[2]),
                             tref.lru_scan_bwd_ref(a[0], h, g)):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card (skipped without one; chip_smoke.py phase 10 is the full check)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py phase 10 is their full check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.rand((3, 129, 1001), generator=gen, device=cuda_device)
    b, g = (torch.randn((3, 129, 1001), generator=gen, device=cuda_device)
            for _ in range(2))
    a, b, g = (t.to(dtype) for t in (a, b, g))
    kernels.reset_launch_counts()
    h = tops.lru_scan_fwd(a, b)
    grads = tops.lru_scan_bwd(a, h, g)
    want_h = tref.lru_scan_ref(a, b)
    want = tref.lru_scan_bwd_ref(a, h, g)
    torch.cuda.synchronize()
    assert torch.equal(h, want_h)
    for x, y in zip(grads, want):
        assert torch.equal(x, y)
    assert kernels.launch_counts()["lru_scan_fwd"] == 1
    assert kernels.launch_counts()["lru_scan_bwd"] == 1
