"""The port's robust aggregation and fault hooks against the reference's,
on the CPU.

``repro_torch.kernels.robust_agg.ops.robust_aggregate`` on a CPU tensor
runs the plain version (``ref.py``), which the CUDA kernel is held to bit
for bit on the card.  Here the plain version is held to the reference's
oracle (``robust_aggregate_ref``) and to its Pallas kernel in interpret
mode (``sort_impl`` "xla" and "bitonic") on the same numpy inputs:
float32 and bfloat16 (the same bf16 bit patterns go into both packages),
every trim and ``coord_median``, eviction rows, a single live agent and
an all-dead row, and columns of ties, +-0.0, +-inf and NaN.  Equality is
bit for bit, except that NaN results are compared by position only: the
bit pattern of a NaN may differ between frameworks (bf16 NaN
canonicalisation).

Then the registry (contents, ``validate_aggregator``'s errors), the
engine's fault hooks (``apply_corruption`` in both encodings,
``increment_guard``, ``survivor_mean_input``, ``live_mask_rows``) and
``FaultPlan`` / ``FaultRecord``, each against the reference's function on
the same inputs.  The guard's norms and ``norm_clip_mean`` sum float32
squares in another order than the reference: they are held to 1e-6
relative, and the guard's bounds lie far from every row's norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import compress as jcompress
from repro.fed import engine as jengine
from repro.fed import faults as jfaults
from repro.fed import robust as jrobust
from repro.kernels.robust_agg import kernel as jkernel
from repro.kernels.robust_agg import ops as jops
from repro.kernels.robust_agg.ref import robust_aggregate_ref as jref
from repro_torch import kernels
from repro_torch.fed import compress as tcompress
from repro_torch.fed import engine as tengine
from repro_torch.fed import faults as tfaults
from repro_torch.fed import robust as trobust
from repro_torch.kernels.robust_agg import kernel as tkernel
from repro_torch.kernels.robust_agg import ops as tops
from repro_torch.kernels.robust_agg import ref as tref

SHAPES = [(1, 5), (4, 128), (8, 300), (17, 64), (64, 129), (100, 37)]
DTYPES = ("f32", "bf16")
LIVES = ("all", "evict", "one", "dead")
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0,
                     2.5, 2.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: the suite runs several
    test workers on one machine, where oversubscribed OpenMP threads slow
    every torch op down manyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(n, m, dtype, seed, special=False):
    """float32 or bf16 bit patterns (uint32 / uint16) of a seeded stack;
    ``special`` fills the first columns with ties and special values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    if special:
        k = min(m, 40)
        x[:, :k] = SPECIALS[rng.integers(0, len(SPECIALS), (n, k))]
        x[:, k // 2:k // 2 + 4] = 0.75              # whole tied columns
    if dtype == "f32":
        return x.view(np.uint32)
    t = torch.from_numpy(x).to(torch.bfloat16)      # round to nearest even
    return t.view(torch.int16).numpy().view(np.uint16)


def _port(bits):
    if bits.dtype == np.uint32:
        return torch.from_numpy(bits.view(np.float32).copy())
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _ref(bits):
    if bits.dtype == np.uint32:
        return jnp.asarray(bits.view(np.float32))
    return jnp.asarray(bits.view(jnp.bfloat16))


def _out_bits(a):
    """Bits of a result of either package, as a numpy unsigned array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype == jnp.bfloat16 else np.uint32)


def _is_nan(bits):
    if bits.dtype == np.uint16:
        return ((bits & 0x7F80) == 0x7F80) & ((bits & 0x7F) != 0)
    return np.isnan(bits.view(np.float32))


def _assert_same(got, want, msg=""):
    g, w = _out_bits(got), _out_bits(want)
    assert g.shape == w.shape, msg
    nan = _is_nan(w)
    np.testing.assert_array_equal(_is_nan(g), nan, err_msg="NaN " + msg)
    np.testing.assert_array_equal(g[~nan], w[~nan], err_msg=msg)


def _live(kind, n):
    if kind == "all":
        return None
    live = np.ones(n, np.float32)
    if kind == "evict":
        live[::max(n // 3, 2)] = 0.0
    elif kind == "one":
        live[:] = 0.0
        live[-1] = 1.0
    else:
        live[:] = 0.0
    return live


def _stats(n):
    return ([("trimmed_mean", f) for f in range((n - 1) // 2 + 1)]
            + [("coord_median", 0)])


# ---------------------------------------------------------------------------
# The plain version against the reference's oracle and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live_kind", LIVES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_matches_reference_oracle(n, m, dtype, live_kind):
    """Every trim and the median, bit for bit."""
    bits = _bits(n, m, dtype, seed=n * m)
    live = _live(live_kind, n)
    for stat, trim in _stats(n):
        got = tops.robust_aggregate(_port(bits), live, stat=stat, trim=trim)
        want = jref(_ref(bits), live, stat=stat, trim=trim)
        _assert_same(got, want, f"{stat} trim={trim}")


@pytest.mark.parametrize("sort_impl", ["xla", "bitonic"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_matches_reference_kernel_interpret(n, m, dtype, sort_impl):
    """The reference's Pallas kernel in interpret mode (both sort
    realisations), with evictions: no trim, the largest trim, and the
    median."""
    bits = _bits(n, m, dtype, seed=7 * n + m)
    live = _live("evict", n) if n >= 4 else None
    for stat, trim in (("trimmed_mean", 0),
                       ("trimmed_mean", (n - 1) // 2),
                       ("coord_median", 0)):
        got = tops.robust_aggregate(_port(bits), live, stat=stat, trim=trim)
        want = jops.robust_aggregate(_ref(bits), live, stat=stat, trim=trim,
                                     sort_impl=sort_impl)
        _assert_same(got, want, f"{stat} trim={trim} {sort_impl}")


@pytest.mark.parametrize("live_kind", LIVES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 17])
def test_special_values(n, dtype, live_kind):
    """Ties, +-0.0, +-inf and NaN (by position) against the oracle; the
    median of -0.0 values comes out +0.0 in both."""
    bits = _bits(n, 53, dtype, seed=100 + n, special=True)
    live = _live(live_kind, n)
    for stat, trim in _stats(n):
        got = tops.robust_aggregate(_port(bits), live, stat=stat, trim=trim)
        want = jref(_ref(bits), live, stat=stat, trim=trim)
        _assert_same(got, want, f"{stat} trim={trim}")
    got = tops.robust_aggregate(_port(bits), live, stat="coord_median")
    want = jops.robust_aggregate(_ref(bits), live, stat="coord_median",
                                 sort_impl="bitonic")
    _assert_same(got, want, "median vs the bitonic kernel")


def test_median_of_negative_zero_is_positive_zero():
    x = torch.full((4, 3), -0.0)
    out = tops.robust_aggregate(x, stat="coord_median")
    assert out.view(torch.int32).eq(0).all()        # +0.0 bits


def test_order_key_is_the_reference_involution():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    bits[:len(SPECIALS)] = SPECIALS.view(np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    key = tref._order_key(x)
    np.testing.assert_array_equal(
        key.numpy(), np.asarray(jkernel._order_key(jnp.asarray(
            bits.view(np.float32)))))
    np.testing.assert_array_equal(
        tref._order_val(key).view(torch.int32).numpy(), bits.view(np.int32))
    # the key order is the IEEE total order: -0.0 before +0.0, and the
    # non-NaN values in ascending order
    order = torch.argsort(key)
    vals = x[order]
    finite = ~torch.isnan(vals)
    assert bool((vals[finite][1:] >= vals[finite][:-1]).all())
    z = tref._order_key(torch.tensor([-0.0, 0.0]))
    assert int(z[0]) < int(z[1])


def test_ops_rejects_bad_inputs_and_launches_nothing_on_cpu():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="unknown robust stat"):
        tops.robust_aggregate(x, stat="mode")
    with pytest.raises(ValueError, match=r"\(N, M\) buffers"):
        tops.robust_aggregate(torch.zeros(4), stat="coord_median")
    with pytest.raises(ValueError, match="float64"):
        tops.robust_aggregate(x.double(), stat="coord_median")
    with pytest.raises(ValueError, match="unknown robust stat"):
        tref.robust_aggregate_ref(x, stat="mode")
    kernels.reset_launch_counts()
    tops.robust_aggregate(x, stat="trimmed_mean", trim=1)
    assert kernels.launch_counts()["sort_aggregate"] == 0


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The launcher's checks run before any build: a CPU tensor is
    refused.  No agent count is: up to REGISTER_ROWS the sort runs in
    one thread's registers, then over a lane group of a warp, then over
    the warps of a block, and past BLOCK_ROWS in a global scratch buffer,
    as the reference pads any N."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.sort_aggregate(torch.zeros((4, 8)), None, "coord_median", 0)
    assert tkernel.REGISTER_ROWS == 32
    assert tkernel.route_plan(129, 1000) == ("warp", 256, 32, 8, 64, 16, 0)
    assert tkernel.route_plan(1000, 1001) == ("warp", 1024, 32, 32, 16, 63,
                                              0)
    assert tkernel.route_plan(16384, 5) == ("block", 16384, 32, 512, 2, 3,
                                            0)
    plan = tkernel.route_plan(20000, 40)
    assert plan == ("scratch", 32768, 32768, 1, 8, 5, 5 * 32768 * 8)


# (N, route, P, threads a column) on both sides of every route boundary
ROUTE_EDGES = [(1, "register", 1, 1), (32, "register", 32, 1),
               (33, "warp", 64, 2), (64, "warp", 64, 2),
               (65, "warp", 128, 4), (128, "warp", 128, 4),
               (129, "warp", 256, 8), (1024, "warp", 1024, 32),
               (1025, "block", 2048, 64), (16384, "block", 16384, 512),
               (16385, "scratch", 32768, 1), (40000, "scratch", 65536, 1)]


@pytest.mark.parametrize("n,route,pow2,lanes", ROUTE_EDGES)
def test_route_plans_at_every_boundary(n, route, pow2, lanes):
    """The route of each N, its padded rows and threads a column; the
    lane routes' tile (columns a block: 256 threads, or one group where G
    is larger, two bf16 columns or one float32 column a group) and the
    persistent grid (every tile, capped at the blocks that fit the card),
    the register route's 16-byte vectors only up to 64 keys a thread, and
    the scratch route's buffer under SCRATCH_BYTES."""
    assert tkernel.route_of(n) == (route, pow2)
    for dtype, cols in ((torch.bfloat16, 2), (torch.float32, 1)):
        for m in (1, 1000, 1 << 20):
            plan = tkernel.route_plan(n, m, dtype, sms=132, blocks_per_sm=3)
            assert (plan.route, plan.pow2, plan.lanes) == (route, pow2, lanes)
            if route in ("warp", "block"):
                assert plan.keys == tkernel.KEYS == pow2 // lanes
                assert plan.tile == cols * max(256, lanes) // lanes
                assert plan.grid == min(-(-m // plan.tile), 132 * 3)
            elif route == "register":
                per = 8 if dtype == torch.bfloat16 else 4
                v = per if pow2 * per <= 64 else 1
                assert plan.tile == 256 * v
                assert plan.grid == -(-m // plan.tile)
                assert tkernel.route_plan(n, m, dtype, vec=False).tile == 256
            else:
                assert plan.tile == tkernel.GLOBAL_TILE
                assert plan.grid == min(-(-m // 8), tkernel.SCRATCH_BYTES
                                        // (4 * pow2 * 8))
                assert plan.scratch_keys == plan.grid * pow2 * plan.tile
                assert 4 * plan.scratch_keys <= tkernel.SCRATCH_BYTES


def _emulate_network(k, t, K):
    """The lane kernel's network on ``k[t, j]`` (thread ``t`` of the
    group, register ``j``, position ``t K + j``): each thread's K registers
    by Batcher's odd-even merge sort, then bitonic merges of sizes 2K ...
    P, each a mirror stage (p against p ^ (size - 1)) and strides size/4
    ... 1, the smaller key to the lower position; spans below K within a
    thread, the others against thread ``t ^ D`` (the kernel's shuffle or
    shared-memory round), the mirror's registers reversed."""
    G = k.shape[0]

    def exchange(i, j):
        a, b = k[:, i].clone(), k[:, j].clone()
        k[:, i] = torch.minimum(a, b)
        k[:, j] = torch.maximum(a, b)

    p = 1
    while p < K:
        d = p
        while d >= 1:
            r = d % p
            for i in range(K):
                if (i + d < K and i >= r and ((i - r) // d) % 2 == 0
                        and i // (2 * p) == (i + d) // (2 * p)):
                    exchange(i, i + d)
            d //= 2
        p *= 2
    size = 2 * K
    while size <= K * G:
        stages = [(size - 1, True)]
        stride = size // 4
        while stride >= 1:
            stages.append((stride, False))
            stride //= 2
        for span, mirror in stages:
            if span < K:
                for i in range(K):
                    if i ^ span > i:
                        exchange(i, i ^ span)
                continue
            D = span // K
            bit = size // K // 2 if mirror else D
            lower = ((t & bit) == 0)[:, None, None]
            other = k[t ^ D]
            if mirror:
                other = other.flip(1)
            k = torch.where(lower, torch.minimum(k, other),
                            torch.maximum(k, other))
        size *= 2
    return k


def _emulate_lane_kernel(bits, live, stat, trim):
    """The warp and block routes' arithmetic in plain torch on the CPU:
    keys (bf16 as 16-bit keys; dead rows and the padding the largest key),
    row ``j G + t`` to thread ``t``'s register ``j``, the network, then the
    trimmed mean's tree in the lane layout as the kernel runs it (the
    levels across threads, D = G/2 ... 1, then thread 0's registers spread
    over a group's lanes: the levels h >= W in registers, the levels h < W
    across lanes) or the median's two values each plus 0.0."""
    n, m = bits.shape
    route, pow2 = tkernel.route_of(n)
    assert route in ("warp", "block")
    K = tkernel.KEYS
    G = pow2 // K
    b = torch.from_numpy(bits.astype(np.int64))
    if bits.dtype == np.uint16:
        key = b ^ torch.where(b >= 0x8000, 0x7FFF, 0) ^ 0x8000
        last = 0xFFFF
    else:
        key = torch.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b ^ 0x80000000)
        last = 0xFFFFFFFF
    lv = np.ones(n, np.float32) if live is None else live
    n_live = int(lv.astype(np.int32).sum())
    keep = torch.from_numpy((lv != 0) | bool((lv != 0).sum() == 0))
    key = torch.where(keep[:, None], key, last)
    key = torch.cat([key, torch.full((pow2 - n, m), last)])
    t = torch.arange(G)
    k = _emulate_network(key.reshape(K, G, m).permute(1, 0, 2).clone(), t, K)
    if bits.dtype == np.uint16:
        u = k ^ 0x8000
        u = u ^ torch.where(u >= 0x8000, 0x7FFF, 0)
        u = u << 16
    else:
        u = torch.where(k >= 1 << 31, k ^ 0x80000000, k ^ 0xFFFFFFFF)
    val = (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)
    if stat == "trimmed_mean":
        p = (t[:, None] * K + torch.arange(K)[None, :])[:, :, None]
        v = torch.where((p >= trim) & (p < n_live - trim), val,
                        torch.zeros((), dtype=torch.float32))
        D = G // 2
        while D >= 1:
            v = torch.cat([v[:D] + v[D:2 * D], v[2 * D:]])
            D //= 2
        # thread 0's registers j: the kernel's lane u of a W-lane group
        # holds j = u + W i; levels h >= W pair i and i + h / W in its
        # registers, then levels h < W pair lanes u and u + h by shuffles
        W = min(G, 32)
        u = v[0].reshape(K // W, W, m)             # u[i, lane] = v[lane + W i]
        while u.shape[0] > 1:
            u = u[:u.shape[0] // 2] + u[u.shape[0] // 2:]
        u = u[0]
        while u.shape[0] > 1:
            u = u[:u.shape[0] // 2] + u[u.shape[0] // 2:]
        v = u
        d = torch.tensor(float(max(n_live - 2 * trim, 1)))
        res = v[0] * (torch.tensor(1.0) / d)
    else:
        flat = val.reshape(pow2, m)
        lo, hi = (n_live - 1) // 2, n_live // 2
        v_lo = flat[lo] + 0.0 if lo >= 0 else torch.zeros(m)
        res = 0.5 * (v_lo + (flat[hi] + 0.0))
    return res.reshape(1, m).to(_port(bits).dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [129, 200, 256, 1000, 1025])
def test_lane_kernel_emulation_matches_reference(n, dtype):
    """The lane routes' network and pairwise tree in their layout,
    emulated on the CPU, bit-equal to the reference's oracle: every live
    kind, no trim, one, N/3, the largest, and the median."""
    bits = _bits(n, 24, dtype, seed=500 + n, special=True)
    for live_kind in LIVES:
        live = _live(live_kind, n)
        for stat, trim in (("trimmed_mean", 0), ("trimmed_mean", 1),
                           ("trimmed_mean", (n - 1) // 3),
                           ("trimmed_mean", (n - 1) // 2),
                           ("coord_median", 0)):
            got = _emulate_lane_kernel(bits, live, stat, trim)
            want = jref(_ref(bits), live, stat=stat, trim=trim)
            _assert_same(got, want, f"{live_kind} {stat} trim={trim}")


@pytest.mark.parametrize("live_kind", ("all", "evict", "dead"))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [129, 200, 256, 1024, 1025])
def test_plain_matches_reference_above_128_agents(n, dtype, live_kind):
    """Above 128 agents (the card's warp, block and scratch routes; the
    plain version has no cap) the plain version equals the reference's
    oracle bit for bit, with dead rows, ties and special values: no trim,
    one, the largest, and the median."""
    bits = _bits(n, 67, dtype, seed=300 + n, special=True)
    live = _live(live_kind, n)
    for stat, trim in (("trimmed_mean", 0), ("trimmed_mean", 1),
                       ("trimmed_mean", (n - 1) // 2), ("coord_median", 0)):
        got = tops.robust_aggregate(_port(bits), live, stat=stat, trim=trim)
        want = jref(_ref(bits), live, stat=stat, trim=trim)
        _assert_same(got, want, f"{stat} trim={trim}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card "
                    "(chip_smoke.py phase 2 is its full check)")
    return torch.device("cuda")


def _on_card_matches_plain(x, n, stats):
    """Every live kind and stat through the kernel bit-equal to the plain
    version, each launch on the route ``route_of(n)`` names (the C
    launcher's tallies)."""
    route = tkernel.route_of(n)[0]
    for live_kind in LIVES:
        live = _live(live_kind, n)
        for stat, trim in stats:
            before = tkernel.route_counts()
            got = tops.robust_aggregate(x, live, stat=stat, trim=trim)
            torch.cuda.synchronize()
            after = tkernel.route_counts()
            assert {r for r in after if after[r] > before[r]} == {route}
            want = tref.robust_aggregate_ref(x, live, stat=stat, trim=trim)
            _assert_same(got.cpu(), want.cpu(), f"{stat} trim={trim}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4, 17, 32, 33, 64, 65, 128])
def test_kernel_matches_plain_version_on_card(cuda_device, n, dtype):
    """The register route (N <= 32) and the warp route's groups of 2 and
    4 lanes, every trim and the median."""
    bits = _bits(n, 1001, dtype, seed=n, special=True)
    _on_card_matches_plain(_port(bits).to(cuda_device), n, _stats(n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [129, 200, 256, 1000, 1024, 1025, 20000])
def test_tile_kernel_matches_plain_version_on_card(cuda_device, n, dtype):
    """The warp route (up to 1024 agents), the block route (1025) and the
    global scratch route (20,000) against the plain version, bit for
    bit."""
    bits = _bits(n, 40 if n > 1025 else 1001, dtype, seed=n, special=True)
    _on_card_matches_plain(_port(bits).to(cuda_device), n,
                           (("trimmed_mean", 0), ("trimmed_mean", 1),
                            ("trimmed_mean", (n - 1) // 2),
                            ("coord_median", 0)))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

BAD_PAIRS = [("geometric_median", 0.0, None), ("trimmed_mean", 1.5, None),
             ("trimmed_mean", 2, 4), ("trimmed_mean", -1, None),
             ("norm_clip_mean", 0.0, None), ("norm_clip_mean", float("inf"),
                                             None),
             ("mean", "x", None)]


def test_registry_contents():
    assert trobust.available_aggregators() == jrobust.available_aggregators()
    assert trobust.FUSED_AGGREGATORS == jrobust.PALLAS_AGGREGATORS
    assert trobust.validate_aggregator("trimmed_mean", 2, n_agents=8) == 2.0
    assert trobust.validate_aggregator("mean", 0.0) == 0.0


@pytest.mark.parametrize("name,param,n", BAD_PAIRS)
def test_validate_aggregator_errors_match(name, param, n):
    with pytest.raises(ValueError) as want:
        jrobust.validate_aggregator(name, param, n)
    with pytest.raises(ValueError) as got:
        trobust.validate_aggregator(name, param, n)
    assert str(got.value) == str(want.value)


def test_spec_threads_the_robust_fields():
    from repro_torch.fed import api as tapi

    spec = tapi.spec_from_args(["--aggregator", "trimmed_mean",
                                "--aggregator-param", "2", "--n-agents", "8",
                                "--guard-increments", "--guard-norm-bound",
                                "5.0"]).validate()
    cfg = spec.round_config()
    assert (cfg.aggregator, cfg.aggregator_param) == ("trimmed_mean", 2.0)
    assert cfg.robust_aggregator == "trimmed_mean"
    assert cfg.guard_increments and cfg.guard_norm_bound == 5.0
    with pytest.raises(ValueError, match="2f < N"):
        tapi.FedSpec(n_agents=4, gamma=0.05, aggregator="trimmed_mean",
                     aggregator_param=2).validate()
    with pytest.raises(ValueError, match="clip radius"):
        tapi.FedSpec(n_agents=4, gamma=0.05,
                     aggregator="norm_clip_mean").validate()


def test_round_config_screening():
    with pytest.raises(ValueError, match="2f < N"):
        tengine.RoundConfig(n_agents=4, aggregator="trimmed_mean",
                            aggregator_param=2)
    with pytest.raises(ValueError, match="unknown aggregator"):
        tengine.RoundConfig(n_agents=4, aggregator="nope")
    with pytest.raises(ValueError, match="guard_norm_bound"):
        tengine.RoundConfig(n_agents=4, guard_norm_bound=float("nan"))
    for kw, want in ((dict(), None),
                     (dict(aggregator="trimmed_mean", aggregator_param=0),
                      None),
                     (dict(aggregator="trimmed_mean", aggregator_param=1),
                      "trimmed_mean"),
                     (dict(aggregator="coord_median"), "coord_median")):
        got = tengine.RoundConfig(n_agents=4, **kw).robust_aggregator
        assert got == jengine.RoundConfig(n_agents=4, **kw).robust_aggregator
        assert got == want


# ---------------------------------------------------------------------------
# Fault hooks of the engine
# ---------------------------------------------------------------------------

def _tree(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 7)).astype(np.float32),
            "b": rng.normal(size=(n, 3, 4)).astype(np.float32)}


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _assert_trees(got, want, rtol=0.0):
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)
        else:
            nan = np.isnan(w)
            np.testing.assert_array_equal(np.isnan(g), nan, err_msg=k)
            np.testing.assert_array_equal(g[~nan], w[~nan], err_msg=k)


CORRUPT = {
    "rows": np.array([0.0, np.nan, 2.0, 0.0, -1.0], np.float32),
    "pairs": np.array([[0, 0], [-1, 0], [3.5, 0], [1, 0.25], [0, 0.5]],
                      np.float32),
}


@pytest.mark.parametrize("form", list(CORRUPT))
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_corruption_matches_reference(form, dtype):
    tree = _tree()
    tt = _ttree(tree)
    jt = _jtree(tree)
    if dtype == "bf16":
        tt = {k: v.to(torch.bfloat16) for k, v in tt.items()}
        jt = {k: v.astype(jnp.bfloat16) for k, v in jt.items()}
    got = tengine.apply_corruption(tt, CORRUPT[form])
    want = jengine.apply_corruption(jt, jnp.asarray(CORRUPT[form]))
    for k in want:
        _assert_same(got[k], want[k], k)
    assert tengine.apply_corruption(tt, None) is tt


@pytest.mark.parametrize("bound", [float("inf"), 30.0])
def test_increment_guard_matches_reference(bound):
    """A NaN row and an over-norm row (norm ~1e3 against a bound of 30;
    the clean rows' norms are ~4) are quarantined."""
    tree = _tree()
    tree["a"][1, 2] = np.nan
    tree["b"][3] *= 300.0
    u = np.array([1, 1, 0, 1, 1], np.float32)
    kw = dict(n_agents=5, guard_increments=True, guard_norm_bound=bound)
    tu, tok = tengine.increment_guard(tengine.RoundConfig(**kw),
                                      _ttree(tree), torch.from_numpy(u))
    ju, jok = jengine.increment_guard(jengine.RoundConfig(**kw),
                                      _jtree(tree), jnp.asarray(u))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert not tok[1] and bool(tok[3]) == (bound == float("inf"))
    np.testing.assert_allclose(
        tengine._row_sq_norms(_ttree(tree)).numpy(),
        np.asarray(jengine._row_sq_norms(_jtree(tree))), rtol=1e-6)
    off = tengine.increment_guard(tengine.RoundConfig(n_agents=5),
                                  _ttree(tree), torch.from_numpy(u))
    assert off[1] is None and torch.equal(off[0], torch.from_numpy(u))


def test_guard_on_packed_buffer_ignores_drifted_padding():
    """The port's packing has gap columns between leaves: a NaN there is
    not part of any row's norm, as in the reference's packing."""
    tree = _tree()
    buf, meta = tcompress.pack_leaves(_ttree(tree))
    gap = meta.segments[0][1]
    assert gap < meta.segments[1][0]
    buf[:, gap] = float("nan")
    jbuf, jmeta = jcompress.pack_leaves(_jtree(tree))
    np.testing.assert_allclose(
        tengine._row_sq_norms(buf, meta).numpy(),
        np.asarray(jengine._row_sq_norms(jbuf, jmeta)), rtol=1e-6)
    u, ok = tengine.increment_guard(
        tengine.RoundConfig(n_agents=5, guard_increments=True), buf, meta=meta,
        u=torch.ones(5))
    assert bool(ok.all()) and torch.equal(u, torch.ones(5))


@pytest.mark.parametrize("live", [None, np.array([1, 0, 1, 1, 0], np.float32)])
def test_survivor_mean_input_and_live_mask_rows(live):
    tree = _tree()
    tcfg, jcfg = tengine.RoundConfig(n_agents=5), jengine.RoundConfig(
        n_agents=5)
    tt = _ttree(tree)
    got = tengine.survivor_mean_input(tcfg, tt, live)
    if live is None:
        assert got is tt
    _assert_trees(got, jengine.survivor_mean_input(jcfg, _jtree(tree), live))
    u = np.array([1, 1, 0, 1, 1], np.float32)
    np.testing.assert_array_equal(
        tengine.live_mask_rows(torch.from_numpy(u), live).numpy(),
        np.asarray(jengine.live_mask_rows(jnp.asarray(u), live)))


def test_robust_seen_mean_keeps_object_identity():
    z = _ttree(_tree())
    assert tengine.robust_seen(tengine.RoundConfig(n_agents=5), z, None) is z
    cfg0 = tengine.RoundConfig(n_agents=5, aggregator="trimmed_mean",
                               aggregator_param=0)
    assert tengine.robust_seen(cfg0, z, None) is z


@pytest.mark.parametrize("name,param", [("mean", 0.0), ("trimmed_mean", 2),
                                        ("coord_median", 0.0),
                                        ("norm_clip_mean", 0.7)])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_robust_seen_matches_reference(name, param, backend):
    """The z_seen transform on trees and on packed buffers, against the
    reference's (order statistics bit for bit; the mean and
    norm_clip_mean's float32 sums to 1e-6 relative)."""
    tree = _tree(n=8)
    live = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    jback = "pallas" if backend == "fused" else "xla"
    want = jrobust.robust_seen_tree(_jtree(tree), live, name=name,
                                    param=param, backend=jback)
    rtol = 1e-6 if name in ("mean", "norm_clip_mean") else 0.0
    got = trobust.robust_seen_tree(_ttree(tree), live, name=name,
                                   param=param, backend=backend)
    _assert_trees(got, want, rtol)
    buf, meta = tcompress.pack_leaves(_ttree(tree))
    buf[:, meta.segments[0][1]] = 1e6        # drifted gap column
    seen = trobust.robust_seen_packed(buf, live, name=name, param=param,
                                      meta=meta, backend=backend)
    _assert_trees(tcompress.unpack_leaves(seen, meta), want, rtol)


# ---------------------------------------------------------------------------
# Fault plans and records
# ---------------------------------------------------------------------------

PLANS = [dict(seed=0, n_agents=4, n_rounds=3, n_byzantine=1,
              byzantine_kind="sign_flip"),
         dict(seed=5, n_agents=8, n_rounds=12, n_byzantine=2,
              byzantine_kind="drift", byzantine_value=0.5,
              byzantine_start=2, p_crash=0.1, crash_length=3, p_drop=0.1,
              p_corrupt=0.1, p_stall=0.1),
         dict(seed=9, n_agents=6, n_rounds=10, p_corrupt=0.2,
              corrupt_value=float("nan"))]


@pytest.mark.parametrize("kw", PLANS, ids=["signflip", "mixed", "corrupt"])
def test_fault_plan_matches_reference(kw):
    kw = dict(kw)
    seed, n, rounds = kw.pop("seed"), kw.pop("n_agents"), kw.pop("n_rounds")
    tp = tfaults.FaultPlan.generate(seed, n, rounds, **kw)
    jp = jfaults.FaultPlan.generate(seed, n, rounds, **kw)
    assert json.dumps(tp.to_json()) == json.dumps(jp.to_json())
    assert tp.has_byzantine == jp.has_byzantine
    for a in range(n):
        for r in range(rounds):
            assert tp.byzantine_at(a, r) == jp.byzantine_at(a, r)
            assert tp.crashed(a, r) == jp.crashed(a, r)
            tv, jv = tp.corrupt_value(a, r), jp.corrupt_value(a, r)
            assert (tv is None) == (jv is None)
            if tv is not None:
                assert tv == jv or (np.isnan(tv) and np.isnan(jv))
    back = tfaults.FaultPlan.from_json(json.loads(json.dumps(tp.to_json())))
    assert json.dumps(back.to_json()) == json.dumps(tp.to_json())


def test_fault_record_matches_reference():
    recs = []
    for mod in (tfaults, jfaults):
        rec = mod.FaultRecord(n_agents=4)
        rec.note_eviction(2, 1)
        rec.note_rejoin(2, 3)
        rec.note_eviction(0, 4)
        rec.note_corrupt_row(1, np.array([[0, 0], [-1, 0], [0, 0], [0, 0]]))
        rec.note_corrupt_row(2, np.array([0, np.nan, 0, 0]))
        recs.append(rec)
    t, j = recs
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())
    for r in range(6):
        tl, jl = t.live_row(r), j.live_row(r)
        assert (tl is None) == (jl is None)
        if tl is not None:
            np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(t.live_matrix(6), j.live_matrix(6))
    back = tfaults.FaultRecord.from_json(json.loads(json.dumps(t.to_json())))
    assert json.dumps(back.to_json()) == json.dumps(t.to_json())
