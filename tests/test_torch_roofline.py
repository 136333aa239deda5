"""The port's analysis tools against the reference's: the analytic model
FLOPs, the meta-device input descriptions, the per-leaf specs of the
tree layout, the dry run, and the conventions of the round analyzer
(``launch/profile_analysis.py``, the counterpart of the reference's HLO
analyzer, whose tests in ``tests/test_roofline.py`` these mirror)."""

import dataclasses
import os
import tempfile
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.fed import sharding as jsharding
from repro.launch import roofline as jroofline
from repro.models import model as jmodel
from repro_torch import collectives
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.fed import sharding
from repro_torch.kernels import costs
from repro_torch.launch import dryrun, profile_analysis, roofline
from repro_torch.models import model as tmodel

MODES = ("train", "prefill", "decode")


def _jax_param_count(cfg) -> int:
    tree = jax.eval_shape(jmodel.build_model(cfg).init, jax.random.PRNGKey(0))
    return sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(tree))


# ---------------------------------------------------------------------------
# Analytic model FLOPs
# ---------------------------------------------------------------------------

def test_arch_and_shape_tables_match_the_reference():
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert roofline.active_param_count(cfg) == \
        jroofline.active_param_count(jcfg)
    for name in SHAPES:
        for mode in MODES:
            got = roofline.model_flops(cfg, SHAPES[name], mode)
            want = jroofline.model_flops(jcfg, J_SHAPES[name], mode)
            assert got == want and type(got) is type(want), (name, mode)


@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "gemma2-2b",
                                  "nemotron-4-340b"))
def test_active_params_match_meta_param_count_dense(arch):
    """For dense archs the analytic active-param count is within a few %
    of the meta-device model's parameter count (it IS the count)."""
    cfg = get_config(arch)
    true = tmodel.build_model(cfg).param_count()
    approx = roofline.active_param_count(cfg)
    assert abs(approx - true) / true < 0.05, (arch, approx, true)


def test_moe_active_less_than_total():
    cfg = get_config("grok-1-314b")
    total = tmodel.build_model(cfg).param_count()
    assert roofline.active_param_count(cfg) < 0.55 * total


def test_mfu_and_the_h100_constants():
    assert roofline.BF16_PEAK == 989e12 and roofline.FP32_PEAK == 67e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.card_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError, match="no data-sheet bandwidth"):
        roofline.card_bandwidth("TPU v5e")
    assert roofline.mfu(989e12, 2.0, 2) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# Input descriptions on the meta device
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    """``batch_specs``, ``cache_specs`` and ``shape_supported``: the
    reference's keys, shapes, dtypes and skip reasons, as meta tensors."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        ok, why = tmodel.shape_supported(cfg, shape)
        assert (ok, why) == jmodel.shape_supported(jcfg, J_SHAPES[name])
        if not ok:
            continue
        for labels in (True, False):
            got = tmodel.batch_specs(cfg, shape, labels)
            assert all(t.device.type == "meta" for t in got.values())
            assert _flat(got) == _flat(jmodel.batch_specs(
                jcfg, J_SHAPES[name], labels))
        if shape.kind == "decode":
            got = tmodel.input_specs(cfg, shape)
            assert all(t.device.type == "meta" for t in
                       torch.utils._pytree.tree_leaves(got))
            assert _flat(got) == _flat(jmodel.input_specs(jcfg,
                                                          J_SHAPES[name]))


# ---------------------------------------------------------------------------
# Per-leaf specs of the tree layout
# ---------------------------------------------------------------------------

def _spec_tuples(jtree, fsdp, sizes):
    specs = jsharding.param_specs(jtree, fsdp_axis=fsdp, axis_sizes=sizes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                        for k in path)
        out[name] = tuple(spec)
    return out


SPEC_CASES = [(a, "reduced", m) for a in ARCH_IDS for m in (1, 2, 4)] + [
    # 60 experts over 8 model ranks: the expert axis stays replicated and
    # the inner dims take the tensor-parallel rule (_sanitize / the E
    # check); 8 experts over 16 likewise
    ("qwen2-moe-a2.7b", "published", 8), ("grok-1-314b", "published", 16)]


@pytest.mark.parametrize("arch,size,model", SPEC_CASES)
def test_param_specs_equal_the_reference(arch, size, model):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if size == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    jtree = jax.eval_shape(jmodel.build_model(jcfg).init,
                           jax.random.PRNGKey(0))
    shapes = {n: s for n, (s, _) in
              tmodel.build_model(cfg).param_shapes().items()}
    sizes = {"agent": 1, "model": model}
    for fsdp in (None, "data"):
        want = _spec_tuples(jtree, fsdp, sizes)
        got = sharding.param_specs(shapes, fsdp_axis=fsdp, axis_sizes=sizes)
        assert got == want, fsdp
    if size == "published" and "qwen" in arch:
        wi = sharding.param_specs(shapes, fsdp_axis=None, axis_sizes=sizes)[
            "stages.0.0.moe.experts.wi"]
        # 60 % 8: no expert axis; the hidden dim (2 x 1408) takes 'model'
        assert wi == (None, None, None, "model"), wi
    # agent-stacked leaves reserve the leading axis
    stacked = sharding.param_specs({n: (4,) + s for n, s in shapes.items()},
                                   fsdp_axis=None, agent_axis="agent",
                                   axis_sizes=sizes)
    assert stacked == {n: ("agent",) + s for n, s in
                       sharding.param_specs(shapes, fsdp_axis=None,
                                            axis_sizes=sizes).items()}


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_cases_pass_and_count_the_reference_params(arch, capsys):
    want = _jax_param_count(jget_config(arch))
    results = [dryrun.run_case(arch, name, mesh, mode)
               for name in SHAPES for mesh in dryrun.MESHES
               for mode in ("fed", "standard")]
    assert not [r for r in results if r["status"] == "FAILED"]
    ok = [r for r in results if r["status"] == "ok"]
    assert ok and all(r["params"] == want for r in ok)
    skipped = {r["shape"] for r in results if r["status"] == "skipped"}
    assert skipped == ({"long_500k"}
                       if not get_config(arch).supports_long_ctx else set())
    for r in ok:
        rl = r["roofline"]
        assert rl["bottleneck"] in ("compute", "memory", "collective")
        assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
        if r["mode"] == "fed" and SHAPES[r["shape"]].kind == "train":
            assert r["model_flops"] == 4 * jroofline.model_flops(
                jget_config(arch), J_SHAPES[r["shape"]], "train")
            tree = r["resident_bytes_per_rank"]["tree"]["x"]
            agents, model = dryrun.parse_mesh(r["mesh"])
            one = dryrun.state_bytes(tmodel.build_model(get_config(arch)), 4)
            # a rank holds its agents' rows; a model rank at most all of them
            assert tree <= one["tree"] // agents
            assert (tree < one["tree"] // agents) == (model > 1)


def test_dryrun_cli_exits_zero():
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k",
                        "--mesh", "1x2"]) == 0


# ---------------------------------------------------------------------------
# The round analyzer's conventions
# ---------------------------------------------------------------------------

def test_collective_pricing_all_reduce_2x():
    c = profile_analysis.Costs(coll_by_kind={"all-reduce": 128 * 4})
    assert roofline.collective_bytes(c.coll_by_kind)["per_kind"][
        "all-reduce"] == 2 * 128 * 4
    rl = roofline.analyze(profile_analysis.Costs(
        flops=1.0, bytes=1.0, coll_by_kind={"all-reduce": 512},
        coll_counts={"all-reduce": 1}), 1.0, 1)
    assert rl.coll_bytes == 1024 and rl.bottleneck == "collective"


def test_top_collectives_sorted():
    c = profile_analysis.Costs(collectives={
        ("all-reduce", "agent_sum"): {"calls": 1, "bytes": 512},
        ("all-reduce", "model_gather"): {"calls": 2, "bytes": 4096},
        ("broadcast", "resume"): {"calls": 1, "bytes": 100}})
    tops = profile_analysis.top_collectives(c, 5)
    assert [t[2] for t in tops] == ["model_gather", "agent_sum", "resume"]
    assert tops[0][0] == 2 * 4096 and tops[0][0] >= tops[-1][0]


def test_loop_of_matmuls_is_counted_in_full():
    a = torch.ones((32, 32))

    def f():
        x = a
        for _ in range(5):
            x = x @ a
        return x

    _, c = profile_analysis.count(f)
    assert c.flops == 5 * 2 * 32 ** 3
    assert c.ops["aten.mm"]["calls"] == 5
    # operand and result bytes of each product, nothing for the views
    assert c.ops["aten.mm"]["bytes"] == 5 * 3 * 32 * 32 * 4


def test_kernel_costs_reach_the_report():
    """A kernel launch's recorded operations and bytes (the ops wrappers
    record them where they count a launch) reach the counted round, beside
    the aten ops, and a bound reads the same count."""
    fwd = costs.flash(2, 512, 8, 4, 256, True, None)["fwd"]

    def f():
        costs.record("flash_attention_fwd", fwd["flops"], fwd["bytes"])
        return torch.ones(4) * 2.0

    _, c = profile_analysis.count(f)
    assert c.kernels["flash_attention_fwd"] == {
        "launches": 1, "flops": fwd["flops"], "bytes": fwd["bytes"]}
    assert c.flops == fwd["flops"]
    assert c.bytes == fwd["bytes"] + sum(v["bytes"] for v in c.ops.values())
    assert c.ops["aten.mul"]["bytes"] == 2 * 4 * 4
    bd = roofline.flash_bounds(3.35e12, 2, 512, 8, 4, 256, True, None)
    assert bd["fwd"]["flops_bf16"] + bd["fwd"]["flops_split"] == fwd["flops"]
    top = profile_analysis.top_kernels(c, 1)[0]
    assert top[1] == "flash_attention_fwd" and top[2] == 1


def test_kernel_groups():
    g = profile_analysis.kernel_group
    assert g("void flash_fwd_kernel_wgmma<256>") == "flash_attention"
    assert g("partial_sum_kernel") == "round_uplink_partial"
    assert g("sm90_xmma_gemm_bf16") == "matmul"
    assert g("vectorized_elementwise_kernel") == \
        "other elementwise/reduction"


def _gloo_worker(rank, world, store, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(model=2, device="cpu")
        collectives.reset()
        sharding.model_sum(torch.ones(10), mesh)
        sharding.model_gather(torch.ones((3, 4), dtype=torch.bfloat16), mesh,
                              8)
        torch.save(collectives.tally(), f"{out}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_tally_their_collectives():
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_gloo_worker, args=(2, d + "/store", d),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.time() + 120
        while not ctx.join(timeout=2):
            assert time.time() < deadline, "the ranks did not finish"
        tallies = [torch.load(os.path.join(d, f"{r}.pt")) for r in range(2)]
    for t in tallies:
        assert t == {("all-reduce", "model_sum"): {"calls": 1, "bytes": 40},
                     ("all-reduce", "model_gather"): {"calls": 1,
                                                      "bytes": 3 * 8 * 2}}
