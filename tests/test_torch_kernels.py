"""The kernels' plain versions against the JAX kernels in interpret mode.

``repro_torch.kernels.*.ref`` is the function each CUDA kernel computes
and the CPU path of its ops wrapper; here it is held against the JAX
round-edge and fedplt_update ops (Pallas in interpret mode) on the same
numpy inputs: the whole prox table, exact and lagged exchanges, ragged
widths, and a NaN row of ``w`` for an agent that sat the round out.
Tolerance 1e-6 (float32; the agent-axis mean may sum in another order).
The kernels themselves run only on a card: the ``cuda``-marked test
compares them with these plain versions there and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro.kernels.fedplt_update import ops as jupdate
from repro.kernels.round_edge import ops as jedge
from repro_torch import kernels
from repro_torch.core import prox as tprox
from repro_torch.kernels.compress import ops as tcompress
from repro_torch.kernels.fedplt_update import kernel as update_kernel
from repro_torch.kernels.fedplt_update import ops as tupdate
from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.lru_scan import ops as tlru
from repro_torch.kernels.robust_agg import ops as trobust
from repro_torch.kernels.round_edge import kernel as edge_kernel
from repro_torch.kernels.round_edge import ops as tedge

TOL = 1e-6

PROXES = [
    ("none", {}),
    ("zero", {}),
    ("l1", {}),
    ("l2sq", {}),
    ("weight_decay", {"weight": 0.3}),
    ("elastic_net", {"l1": 0.5, "l2": 2.0}),
    ("box", {"lo": -0.2, "hi": 0.3}),
    ("linf_ball", {"radius": 0.25}),
]


def _proxes(name, kw):
    if name == "none":
        return None, None
    return jprox.make_prox(name, **kw), tprox.make_prox(name, **kw)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, m)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("name,kw", PROXES, ids=[p[0] for p in PROXES])
@pytest.mark.parametrize("lagged", [False, True], ids=["exact", "lagged"])
@pytest.mark.parametrize("m", [1000, 7])
def test_uplink_plain_matches_jax(name, kw, lagged, m):
    jp, tp = _proxes(name, kw)
    z, t, _, _ = _inputs(3, m)
    t = t if lagged else None
    jy, jv = jedge.round_uplink(jnp.asarray(z), None if t is None
                                else jnp.asarray(t), prox=jp, rho_eff=0.7)
    ty, tv = tedge.round_uplink(torch.from_numpy(z), None if t is None
                                else torch.from_numpy(t), prox=tp,
                                rho_eff=0.7)
    assert ty.shape == (1, m) and tv.shape == (3, m)
    _close(ty, jy)
    _close(tv, jv)


@pytest.mark.parametrize("name,kw", PROXES, ids=[p[0] for p in PROXES])
@pytest.mark.parametrize("lagged", [False, True], ids=["exact", "lagged"])
def test_downlink_plain_matches_jax_nan_safe(name, kw, lagged):
    jp, tp = _proxes(name, kw)
    x, w, z, t = _inputs(3, 1000, seed=1)
    w[1] = np.nan                   # a diverged solve of an inactive agent
    u = np.array([1.0, 0.0, 1.0], np.float32)
    t = t if lagged else None
    jx, jz = jedge.round_downlink(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(z), jnp.asarray(u),
        None if t is None else jnp.asarray(t), prox=jp, rho_eff=0.7,
        damping=0.5)
    tx, tz = tedge.round_downlink(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(z),
        torch.from_numpy(u), None if t is None else torch.from_numpy(t),
        prox=tp, rho_eff=0.7, damping=0.5)
    _close(tx, jx)
    _close(tz, jz)
    assert torch.equal(tx[1], torch.from_numpy(x[1]))
    assert torch.equal(tz[1], torch.from_numpy(z[1]))


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("shape", [(3, 1000), (2, 3, 700)])
def test_fedplt_update_plain_matches_jax(noise, shape):
    rng = np.random.default_rng(2)
    w, g, v, t = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    t = t if noise else None
    ref = jupdate.fedplt_update(jnp.asarray(w), jnp.asarray(g),
                                jnp.asarray(v),
                                None if t is None else jnp.asarray(t),
                                gamma=0.05, inv_rho=0.8)
    wt = torch.from_numpy(w.copy())
    out = tupdate.fedplt_update(wt, torch.from_numpy(g), torch.from_numpy(v),
                                None if t is None else torch.from_numpy(t),
                                gamma=0.05, inv_rho=0.8, out=wt)
    assert out is wt                # in place
    _close(out, ref)


def test_fedplt_update_bf16_casts_like_reference():
    """bf16 storage: operands cast to w's dtype, float32 arithmetic, one
    rounding at the store -- the reference's wrapper semantics, bit for
    bit."""
    rng = np.random.default_rng(3)
    w, g, v = (rng.normal(size=(2, 640)).astype(np.float32)
               for _ in range(3))
    t = rng.normal(size=(2, 640)).astype(np.float32) * 1e-2
    ref = jupdate.fedplt_update(jnp.asarray(w, jnp.bfloat16), jnp.asarray(g),
                                jnp.asarray(v), jnp.asarray(t), gamma=0.05,
                                inv_rho=0.8)
    out = tupdate.fedplt_update(torch.from_numpy(w).bfloat16(),
                                torch.from_numpy(g), torch.from_numpy(v),
                                torch.from_numpy(t), gamma=0.05, inv_rho=0.8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("name,kw", PROXES[1:], ids=[p[0] for p in PROXES[1:]])
def test_prox_kernel_code_matches_table(name, kw):
    """The (code, a, b) form the kernels evaluate equals the table entry."""
    fn = tprox.make_prox(name, **kw)
    y = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4096,)).astype(np.float32))
    for rho in (0.05, 0.7, 3.0):
        code, a, b = fn.kernel_params(rho)
        assert torch.equal(tprox.apply_prox_code(y, code, a, b), fn(y, rho))


def test_cpu_ops_take_plain_versions_and_count_no_launch():
    kernels.reset_launch_counts()
    z = torch.randn(3, 100)
    tedge.round_uplink(z)
    tedge.round_downlink(z, z, z, torch.ones(3))
    tupdate.fedplt_update(z, z, z, gamma=0.1, inv_rho=1.0)
    trobust.robust_aggregate(z, stat="trimmed_mean", trim=1)
    tedge.round_uplink_partial(z)
    tedge.round_downlink_presummed(z, z, z, z[:1], torch.ones(3))
    q = torch.randn(1, 5, 2, 8, requires_grad=True)
    tflash.flash_attention(q, q[:, :, :1], q[:, :, 1:], window=2,
                           cap=5.0).sum().backward()
    a = torch.rand(2, 6, 3, 4, requires_grad=True)
    tlru.lru_scan(a, a).sum().backward()
    dt = torch.rand(2, 6, 3, requires_grad=True)
    tlru.ssm_scan(dt, dt, a[:, :, 0], a[:, :, 1], -a[0, 0], dt[0, 0],
                  torch.float32).sum().backward()
    tcompress.segment_ranks(z, segments=((10, 40), (50, 90)))
    assert kernels.launch_counts() == {"round_uplink": 0,
                                       "round_downlink": 0,
                                       "round_uplink_partial": 0,
                                       "round_downlink_presummed": 0,
                                       "fedplt_update": 0,
                                       "rank_select": 0,
                                       "segment_ranks": 0,
                                       "int8_quantize": 0,
                                       "sort_aggregate": 0,
                                       "flash_attention_fwd": 0,
                                       "flash_attention_bwd": 0,
                                       "lru_scan_fwd": 0,
                                       "lru_scan_bwd": 0,
                                       "ssm_scan_fwd": 0,
                                       "ssm_scan_bwd": 0}


def test_kernel_launchers_reject_cpu_tensors():
    """The CUDA launchers take CUDA tensors only (checked before any
    build)."""
    z = torch.randn(3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        edge_kernel.round_uplink(z, None, 0, 0.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        update_kernel.fedplt_update(z, z, z, None, z, 0.1, 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py phase 2 is their full check)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, w, z, t = (torch.randn((3, 1000), generator=gen, device=cuda_device
                              ).to(dtype) for _ in range(4))
    u = torch.tensor([1.0, 0.0, 1.0], device=cuda_device)
    for _, (jp, tp) in [(n, _proxes(n, kw)) for n, kw in PROXES]:
        for tt in (None, t):
            got = tedge.round_uplink(z, tt, prox=tp, rho_eff=0.7)
            want = tedge.ref.round_uplink_ref(z, tt, tp, 0.7)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            got = tedge.round_downlink(x, w, z, u, tt, prox=tp, rho_eff=0.7)
            want = tedge.ref.round_downlink_ref(x, w, z, u, tt, tp, 0.7)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    got = tupdate.fedplt_update(w, x, z, t, gamma=0.05, inv_rho=0.8)
    assert torch.equal(got, fedplt_update_ref(w, x, z, t, gamma=0.05,
                                              inv_rho=0.8))
