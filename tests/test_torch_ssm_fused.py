"""The port's fused SSM output against the JAX reference, on the CPU.

``repro_torch.models.ssm`` ports the reference's ``ssm_mix_seq`` (a time
loop folding ``y_t = <h_t, C_t>`` into each step) and ``ssm_mix_fused``
(coefficients, an associative scan in the scan dtype and the C
contraction chunk by chunk, a float32 carry), which ``mamba_forward``
takes under ``cfg.ssm_fused_output``.  On a CUDA tensor both go to the
selective-scan kernels of ``kernels/lru_scan`` (``csrc/ssm_scan.cu``), which
walk time in order and equal their plain versions ``ssm_scan_ref`` /
``ssm_scan_bwd_ref`` bit for bit on the card (``chip_smoke.py`` phase 14a).
Here, on numpy inputs with a fixed seed and one mamba block's parameters
from the reference's init (d_model 12, d_inner 24, dt_rank 1, state n):

* ``ssm_mix_seq`` and ``ssm_mix_fused`` of both packages: B 2, S in (1, 7,
  128, 200), n in (4, 16), chunk in (64, 128) (``S % chunk`` falls back to
  one chunk, as in the reference), scan dtype float32 and bfloat16; the
  output and the gradients of ``sum(y * ct)`` against every parameter and
  u (``jax.vjp``).  float32: 1e-5 relative plus 1e-5 of the largest entry
  (two orders of float32 rounding).  bfloat16 scan dtype (the coefficients
  rounded to bf16 in both packages, where ``exp`` and the products may
  round a float32 ulp apart first, and an entry of ``a`` one bf16 step
  apart moves every later state of its channel): seq 1e-3 of the largest
  entry, output and gradients; fused 1e-3 and 2e-2 (the associative scan
  multiplies in bf16, in orders the two frameworks round apart).
* the card's route of both modes (``ssm_mix_kernel``: the kernels' time
  order, run here through ``SsmScan`` on their plain versions) against the
  reference's associative ``ssm_mix_fused``: float32 as above, bf16 4e-2
  of the largest output and 6e-2 of the largest gradient entry.
The largest differences seen are listed beside ``TOL``.
* ``ssm_scan_ref`` and ``ssm_scan_bwd_ref`` (the kernels' plain versions,
  fed ``dt``, ``B``, ``C`` and ``A`` made as the model makes them) against
  the reference's ``ssm_mix_seq`` and its gradients, chained back through
  the projections by autograd: the tolerances above.
* ``SsmScan.apply`` on CPU tensors runs the plain versions (bit for bit)
  and counts no launch; the kernel launchers refuse CPU tensors and
  operands out of range.
* the kernels' layout, emulated: for every n and its lane group
  (``kernel.ssm_plan``: G lanes a channel, K states a lane), the sum
  over states as the kernels take it -- register levels over a lane's
  strided states, then xor-shuffle levels -- bit-equal to
  ``ref.lane_tree_sum`` on every lane; the plan's G, K, block width and
  threads for each n; the sum over channels of dB and dC written out in
  the backward kernel's order (64-channel blocks, 16-channel groups, a
  tree over the groups), bit-equal to ``ref._over_channel_blocks``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro_torch import kernels
from repro_torch.kernels.lru_scan import kernel as tkernel
from repro_torch.kernels.lru_scan import ops as tops
from repro_torch.kernels.lru_scan import ref as tref
from repro_torch.models import ssm as tssm

SEQS = (1, 7, 128, 200)
STATES = (4, 16)
SCANS = ("float32", "bfloat16")
# (output, gradient) tolerances relative to the largest reference entry
# (float32 also 1e-5 relative elementwise).  The largest seen over every
# case under seven seeds: float32 at most 6.6e-7 / 1.2e-6 on each route;
# bf16 seq 1.8e-4 / 1.7e-4, fused 1.8e-4 / 5.9e-3, the kernel's order
# against the reference's associative scan 1.2e-2 / 2.0e-2 (the
# reference's scan multiplies in bf16, the kernel carries h in float32)
TOL = {("seq", "float32"): (1e-5, 1e-5), ("fused", "float32"): (1e-5, 1e-5),
       ("kernel", "float32"): (1e-5, 1e-5),
       ("seq", "bfloat16"): (1e-3, 1e-3), ("fused", "bfloat16"): (1e-3, 2e-2),
       ("kernel", "bfloat16"): (4e-2, 6e-2)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _block(n):
    """One block's parameters from the reference's init, as numpy."""
    cfg = dataclasses.replace(jax_get_config("falcon-mamba-7b").reduced(
        d_model=12), ssm_state=n)
    params = jssm.init_mamba(jax.random.PRNGKey(n), cfg, jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}


def _inputs(S, n, seed):
    rng = np.random.default_rng(seed)
    params = _block(n)
    u = rng.normal(size=(2, S, 24)).astype(np.float32)
    ct = rng.normal(size=(2, S, 24)).astype(np.float32)
    return params, u, ct


def _reference(fn, params, u, ct):
    """``(y, grads of params, grad of u)`` of the reference's ``fn``."""
    @jax.jit
    def run(p, x, c):
        y, vjp = jax.vjp(fn, p, x)
        return y, vjp(c)

    y, (gp, gu) = run(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(u), jnp.asarray(ct))
    return (np.asarray(y), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gu))


def _leaves(params, u):
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    return tp, torch.from_numpy(u.copy()).requires_grad_()


def _close(got, want, tol, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _assert_matches(y, gp, gu, ref, key):
    """The port's output and gradients against the reference's, to
    ``TOL[key]``; float32 also to 1e-5 relative elementwise."""
    (out_tol, grad_tol), rtol = TOL[key], 1e-5 if key[1] == "float32" else 0
    ry, rgp, rgu = ref
    _close(y.detach().numpy(), ry, out_tol, rtol, "y")
    for k, g in gp.items():
        _close(g.numpy(), rgp[k], grad_tol, rtol, f"grad {k}")
    _close(gu.numpy(), rgu, grad_tol, rtol, "grad u")


def _port_grads(y, tp, tu, ct):
    grads = torch.autograd.grad(y, [*tp.values(), tu], torch.from_numpy(ct),
                                allow_unused=True)
    gp = {k: torch.zeros_like(v) if g is None else g
          for (k, v), g in zip(tp.items(), grads[:-1])}
    return gp, grads[-1]


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("S", SEQS)
def test_ssm_mix_seq_matches_reference(S, n, scan):
    params, u, ct = _inputs(S, n, S + n)
    ref = _reference(lambda p, x: jssm.ssm_mix_seq(p, x, jnp.dtype(scan)),
                     params, u, ct)
    tp, tu = _leaves(params, u)
    y = tssm.ssm_mix_seq(tp, tu, getattr(torch, scan))
    _assert_matches(y, *_port_grads(y, tp, tu, ct), ref, ("seq", scan))


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("chunk", (64, 128))
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("S", SEQS)
def test_ssm_mix_fused_matches_reference(S, n, chunk, scan):
    params, u, ct = _inputs(S, n, S + n + chunk)
    ref = _reference(
        lambda p, x: jssm.ssm_mix_fused(p, x, chunk, jnp.dtype(scan)),
        params, u, ct)
    tp, tu = _leaves(params, u)
    y = tssm.ssm_mix_fused(tp, tu, chunk, getattr(torch, scan))
    _assert_matches(y, *_port_grads(y, tp, tu, ct), ref, ("fused", scan))


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("S", (7, 200))
def test_kernel_route_against_reference_fused(S, n, scan):
    """The card's route of the assoc mode (``ssm_mix_kernel``: dt, B, C, A
    into ``SsmScan``, here on CPU tensors its plain versions, which the
    kernels equal bit for bit) against the reference's ``ssm_mix_fused``."""
    params, u, ct = _inputs(S, n, 5 * S + n)
    ref = _reference(
        lambda p, x: jssm.ssm_mix_fused(p, x, 128, jnp.dtype(scan)),
        params, u, ct)
    tp, tu = _leaves(params, u)
    kernels.reset_launch_counts()
    y = tssm.ssm_mix_kernel(tp, tu, getattr(torch, scan))
    _assert_matches(y, *_port_grads(y, tp, tu, ct), ref, ("kernel", scan))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("S", (1, 7, 200))
def test_plain_kernel_versions_match_reference_seq(S, n, scan):
    """``ssm_scan_ref`` against ``ssm_mix_seq``; ``ssm_scan_bwd_ref``'s six
    gradients, chained back through the projections, against its
    ``jax.vjp``."""
    params, u, ct = _inputs(S, n, 3 * S + n)
    ref = _reference(lambda p, x: jssm.ssm_mix_seq(p, x, jnp.dtype(scan)),
                     params, u, ct)
    sd = getattr(torch, scan)
    tp, tu = _leaves(params, u)
    dt, Bc, Cc, A = tssm._projections(tp, tu)
    D = tp["D"]
    ops_in = [t.detach() for t in (dt, tu, Bc, Cc, A, D)]
    y = tref.ssm_scan_ref(*ops_in, sd)
    ddt, du, dB, dC, dA, dD = tref.ssm_scan_bwd_ref(
        *ops_in, torch.from_numpy(ct), sd)
    leaves = [*tp.values(), tu]
    chained = torch.autograd.grad([dt, Bc, Cc, A], leaves, [ddt, dB, dC, dA],
                                  allow_unused=True)
    gp = {k: torch.zeros_like(v) if g is None else g
          for (k, v), g in zip(tp.items(), chained[:-1])}
    gp["D"] = gp["D"] + dD
    gu = chained[-1] + du
    _assert_matches(y, gp, gu, ref, ("seq", scan))


@pytest.mark.parametrize("u_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("scan", SCANS)
def test_ssm_scan_function_on_cpu_is_the_plain_version(scan, u_dtype):
    rng = np.random.default_rng(5)
    Bn, S, d, n = 2, 19, 20, 5
    dt = torch.from_numpy(rng.uniform(1e-3, 0.2, (Bn, S, d)).astype(
        np.float32))
    u = torch.from_numpy(rng.normal(size=(Bn, S, d)).astype(
        np.float32)).to(getattr(torch, u_dtype))
    Bm, Cm = (torch.from_numpy(rng.normal(size=(Bn, S, n)).astype(np.float32))
              for _ in range(2))
    A = -torch.from_numpy(rng.uniform(0.5, n, (d, n)).astype(np.float32))
    D = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(Bn, S, d)).astype(np.float32))
    sd = getattr(torch, scan)
    kernels.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (dt, u, Bm, Cm, A, D)]
    y = tops.ssm_scan(*leaves, sd)
    got = torch.autograd.grad(y, leaves, gy)
    assert torch.equal(y.detach(), tref.ssm_scan_ref(dt, u, Bm, Cm, A, D, sd))
    want = tref.ssm_scan_bwd_ref(dt, u, Bm, Cm, A, D, gy, sd)
    assert [g.dtype for g in got] == [torch.float32, u.dtype] + [
        torch.float32] * 4
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    counts = kernels.launch_counts()
    assert counts["ssm_scan_fwd"] == 0 and counts["ssm_scan_bwd"] == 0


@pytest.mark.parametrize("n", (1, 3, 4, 5, 16, 17, 32))
def test_lane_tree_sum_is_the_halving_tree(n):
    """The kernel's butterfly order, written out for P = 2^ceil(log2 n):
    pairs (i, i + P/2), then (i, i + P/4), ... on zero-padded lanes."""
    s = torch.from_numpy(np.random.default_rng(n).normal(
        size=(3, n)).astype(np.float32))
    P = tref.state_lanes(n)
    assert P >= n and P & (P - 1) == 0 and P < 2 * max(n, 1)
    v = [s[:, i] if i < n else torch.zeros(3) for i in range(P)]
    while len(v) > 1:
        half = len(v) // 2
        v = [v[i] + v[i + half] for i in range(half)]
    assert torch.equal(tref.lane_tree_sum(s), v[0])
    assert tref.block_channels(n) == tkernel.ssm_plan(n)[2] == 64


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", range(1, 33))
def test_kernel_tree_is_the_halving_tree(n):
    """The kernels' sum over states, emulated lane by lane: lane l of a
    group of G holds states l, l + G, .. (K = P / G of them, zero past
    n), adds register k + K/2 into k, then k + K/4, ..; then xor-shuffle
    levels G/2 .. 1, each lane adding its partner's value to its own.
    Every lane must end with ``ref.lane_tree_sum``'s bits, on rows whose
    entries span six decades (so that another pairing rounds apart)."""
    G, K = tkernel.ssm_plan(n)[:2]
    rng = np.random.default_rng(100 + n)
    s = torch.from_numpy((rng.normal(size=(256, n)) * 10.0 ** rng.uniform(
        -3, 3, size=(256, n))).astype(np.float32))
    zero = torch.zeros(s.shape[0])
    regs = [[s[:, l + k * G] if l + k * G < n else zero for k in range(K)]
            for l in range(G)]
    half = K // 2
    while half:
        for r in regs:
            for k in range(half):
                r[k] = r[k] + r[k + half]
        half //= 2
    v = [r[0] for r in regs]
    o = G // 2
    while o:
        v = [v[l] + v[l ^ o] for l in range(G)]
        o //= 2
    want = _bits(tref.lane_tree_sum(s))
    for lane in v:
        assert torch.equal(_bits(lane), want)


# (n range, G, K, threads) of the plan: K = min(P, 4) states a lane, 64
# channels a block
PLAN = [((1, 1), 1, 1, 64), ((2, 2), 1, 2, 64), ((3, 4), 1, 4, 64),
        ((5, 8), 2, 4, 128), ((9, 16), 4, 4, 256), ((17, 32), 8, 4, 512)]


@pytest.mark.parametrize("n", range(1, 33))
def test_ssm_plan(n):
    """G, K, channels and threads of a block for each n; the block width
    ``ref.block_channels`` sums dB and dC by; the staged state order (lane
    l's K states side by side) a permutation of the P states."""
    (_, _), G, K, threads = next(row for row in PLAN
                                 if row[0][0] <= n <= row[0][1])
    P = tref.state_lanes(n)
    assert tkernel.ssm_plan(n) == (G, K, 64, threads)
    assert G * K == P and tref.block_channels(n) == 64
    assert (G, K) in tkernel.SSM_ROUTES
    order = [p // K + (p % K) * G for p in range(P)]
    assert sorted(order) == list(range(P))
    assert all(order[l * K + k] == l + k * G for l in range(G)
               for k in range(K))
    assert tkernel.ssm_ckpt_shape(2, 17, 5, n) == (2, 3, 5, P)


@pytest.mark.parametrize("d_in", (1, 15, 16, 17, 64, 65, 130))
def test_over_channel_blocks_is_the_kernels_order(d_in):
    """dB and dC sum over d as the backward kernel does, written out: zero
    padding to whole 64-channel blocks; in a block, each group of 16
    channels in channel order, then (g0 + g2) + (g1 + g3); then the blocks
    in order.  On rows spanning six decades, so that another order rounds
    apart."""
    rng = np.random.default_rng(d_in)
    t = torch.from_numpy((rng.normal(size=(2, 3, d_in, 5)) * 10.0 ** (
        rng.uniform(-3, 3, size=(2, 3, d_in, 5)))).astype(np.float32))
    zero = torch.zeros(2, 3, 5)
    total = None
    for b in range(-(-d_in // 64)):
        groups = []
        for g in range(4):
            acc = None
            for c in range(16):
                d = 64 * b + 16 * g + c
                x = t[:, :, d] if d < d_in else zero
                acc = x if acc is None else acc + x
            groups.append(acc)
        blk = (groups[0] + groups[2]) + (groups[1] + groups[3])
        total = blk if total is None else total + blk
    assert torch.equal(_bits(tref._over_channel_blocks(t)), _bits(total))
    assert tref.block_channels(5) * 1 == 64 and tref.SSM_CHANNEL_GROUPS == 4


def test_ssm_plan_routes_cover_the_library():
    """Every (G, K) the library builds is some n's plan, one for each P
    in the library's route order, and nothing else is planned."""
    planned = [tkernel.ssm_plan(2 ** r)[:2] for r in range(6)]
    assert planned == list(tkernel.SSM_ROUTES)
    assert {tkernel.ssm_plan(n)[:2] for n in range(1, 33)} == set(planned)
    for n in (0, 33):
        with pytest.raises(ValueError, match="state of 1 to 32"):
            tkernel.ssm_plan(n)


def test_suite_is_registered():
    assert {"ssm_scan_fwd", "ssm_scan_bwd"} <= set(kernels.launch_counts())
    assert tkernel.SSM_SOURCE in kernels.kernel_sources()
    assert tkernel.SSM_SOURCE.name == "ssm_scan.cu"


@pytest.mark.parametrize("case", ["cpu", "ndim", "float64_dt", "state",
                                  "scan_dtype"])
def test_kernel_launchers_check_operands(case):
    """The launchers raise before building on operands the kernels do not
    take: the shapes, dtypes and ranges first, then the device."""
    dt = torch.rand(2, 5, 8)
    u, Bm, Cm = dt.clone(), torch.rand(2, 5, 4), torch.rand(2, 5, 4)
    A, D = -torch.rand(8, 4), torch.rand(8)
    args = dict(dt=dt, u=u, Bm=Bm, Cm=Cm, A=A, D=D,
                scan_dtype=torch.float32)
    err, match = ValueError, "CUDA"
    if case == "ndim":
        args["dt"], match = dt[0], "B, S, d_in"
    elif case == "float64_dt":
        args["dt"], err, match = dt.double(), TypeError, "float32"
    elif case == "state":
        args["A"], match = -torch.rand(8, 33), "state of 1 to 32"
    elif case == "scan_dtype":
        args["scan_dtype"], err, match = torch.float16, TypeError, "scan dtype"
    with pytest.raises(err, match=match):
        tkernel.ssm_fwd(**args)
