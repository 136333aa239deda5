"""The reference's public surface in the port, and the port's copies of the
reference's public helpers held against it on the CPU.

Surface: every public top-level name of each ``src/repro/`` module, read
by AST -- the functions, classes and constants a module defines, and in a
package's ``__init__.py`` also the names it imports (its re-exports; a
name another module imports for its own use does not count, in either
package) -- is defined or re-exported by the port's counterpart module
(the same path under ``src/repro_torch/``; ``launch/hlo_analysis.py`` is
``launch/profile_analysis.py``), apart from :data:`EXCLUDED`, each with
its reason: TPU-only names, names the port renamed on purpose, and names
the port defines in another module.

Parity: ``fed_lm_batches`` (shapes, keys, dtypes of the tokens' range,
each agent's skew, one stream a seed), the derived prox operators on
``tests/test_prox.py``'s cases, ``FedConfig().to_spec()`` field for field
(the backends under the port's names) and its privacy report,
``fedplt_update_tree`` against the reference's in interpret mode, and the
``FedTrainer`` handle behind both front ends.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import prox as JP
from repro.core.problem import make_logreg_problem as jax_logreg
from repro.data import synthetic as jsyn
from repro.fed import api as japi
from repro.fed import runtime as jruntime
from repro.kernels.fedplt_update import ops as jupdate
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import problem_from_arrays
from repro_torch.core import prox as TP
from repro_torch.data import synthetic as tsyn
from repro_torch.fed import api as tapi
from repro_torch.fed import runtime as truntime
from repro_torch.kernels.fedplt_update import ops as tupdate
from repro_torch.models.model import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
RENAMED = {"launch/hlo_analysis.py": "launch/profile_analysis.py"}

_PALLAS = "a Pallas kernel body; the port's kernel is CUDA C++ under csrc/"
_TILE = "a Pallas tile size; the CUDA kernels choose their own"
_GSPMD = ("a GSPMD sharding spec of the reference's TPU mesh; the port "
          "places each rank's block itself (fed/sharding.py)")
_HLO = ("parses XLA's HLO text; the port has no HLO, and "
        "launch/profile_analysis.py counts a real round instead")
EXCLUDED = {
    ("fed/compress.py", "PALLAS_COMPRESSORS"):
        "the Pallas kernels' set, the port's FUSED_COMPRESSORS",
    ("fed/robust.py", "PALLAS_AGGREGATORS"):
        "the Pallas kernels' set, the port's FUSED_AGGREGATORS",
    ("fed/robust.py", "tree_map"): "an alias of jax.tree_util.tree_map",
    ("fed/engine.py", "count_primitives"):
        "counts jaxpr primitives; the port traces no jaxpr",
    ("fed/sharding.py", "batch_spec"): _GSPMD,
    ("fed/sharding.py", "cache_spec_tree"): _GSPMD,
    ("fed/sharding.py", "fed_state_specs"): _GSPMD,
    ("fed/sharding.py", "shardings"): _GSPMD,
    ("fed/sharding.py", "tree_batch_specs"): _GSPMD,
    ("kernels/__init__.py", "ON_TPU"): "TPU detection for Pallas's interpret flag",
    ("kernels/__init__.py", "jax"): "the JAX package itself",
    ("kernels/compress/kernel.py", "BLOCK_AGENTS"): _TILE,
    ("kernels/compress/kernel.py", "int8_2d"): _PALLAS,
    ("kernels/compress/kernel.py", "rank_select_2d"): _PALLAS,
    ("kernels/compress/kernel.py", "segment_ranks_2d"): _PALLAS,
    ("kernels/fedplt_update/kernel.py", "BLOCK_M"): _TILE,
    ("kernels/fedplt_update/kernel.py", "BLOCK_N"): _TILE,
    ("kernels/fedplt_update/kernel.py", "fedplt_update_2d"): _PALLAS,
    ("kernels/flash_attention/kernel.py", "DEFAULT_BLOCK_K"): _TILE,
    ("kernels/flash_attention/kernel.py", "DEFAULT_BLOCK_Q"): _TILE,
    ("kernels/flash_attention/kernel.py", "flash_attention_bhsd"): _PALLAS,
    ("kernels/lru_scan/kernel.py", "DEFAULT_CHUNK"): _TILE,
    ("kernels/lru_scan/kernel.py", "lru_scan_bsw"): _PALLAS,
    ("kernels/robust_agg/kernel.py", "BLOCK_COLS"): _TILE,
    ("kernels/robust_agg/kernel.py", "sort_aggregate_2d"): _PALLAS,
    ("kernels/round_edge/kernel.py", "BLOCK_COLS"): _TILE,
    ("kernels/round_edge/kernel.py", "round_uplink_2d"): _PALLAS,
    ("kernels/round_edge/kernel.py", "round_downlink_2d"): _PALLAS,
    ("kernels/round_edge/kernel.py", "round_uplink_partial_2d"): _PALLAS,
    ("kernels/round_edge/kernel.py", "round_downlink_presummed_2d"): _PALLAS,
    ("kernels/round_edge/ops.py", "round_downlink_sharded"):
        "a downlink under a GSPMD mesh; round_downlink_presummed and the "
        "engine's mesh edge fill its role",
    ("launch/dryrun.py", "build_case"):
        "lowers a case to HLO; the port's dry run describes each case on "
        "the meta device",
    ("launch/hlo_analysis.py", "COLLECTIVES"): _HLO,
    ("launch/hlo_analysis.py", "HloAnalyzer"): _HLO,
    ("launch/hlo_analysis.py", "Instr"): _HLO,
    ("launch/hlo_analysis.py", "analyze_text"): _HLO,
    ("launch/hlo_analysis.py", "parse_module"): _HLO,
    ("launch/mesh.py", "make_production_mesh"): "a TPU pod's device mesh",
    ("launch/roofline.py", "PEAK_FLOPS"):
        "a TPU constant; the port's are the H100's (BF16_PEAK)",
    ("launch/roofline.py", "HBM_BW"):
        "a TPU constant; the port's is card_bandwidth",
    ("launch/roofline.py", "ICI_BW"):
        "a TPU constant; the port's is NVLINK_BW",
    ("models/layers.py", "mlp_flops"): "used nowhere in the reference",
    ("fed/engine.py", "LocalSolver"): "the port defines it in fed/solvers.py",
    ("fed/engine.py", "make_local_solver"):
        "the port defines it in fed/solvers.py",
    ("fed/engine.py", "mesh_agent_shards"):
        "the port defines it in fed/sharding.py",
    ("kernels/flash_attention/kernel.py", "NEG_INF"):
        "the port defines it in kernels/flash_attention/ref.py; the CUDA "
        "kernel has its own constant",
    ("kernels/robust_agg/kernel.py", "ROBUST_STATS"):
        "the port defines it in kernels/robust_agg/ref.py",
    ("models/transformer.py", "forward"):
        "a method of the port's Transformer module",
    ("models/transformer.py", "forward_hidden"):
        "a method of the port's Transformer module",
    ("models/transformer.py", "loss_fn"):
        "a method of the port's Transformer module",
}


def _top_nodes(body):
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_nodes(node.body)
            for handler in getattr(node, "handlers", []):
                yield from _top_nodes(handler.body)
            yield from _top_nodes(node.orelse)
            yield from _top_nodes(getattr(node, "finalbody", []))
        else:
            yield node


def public_names(path: pathlib.Path, with_imports: bool) -> set:
    """Public top-level names of a module: what it defines, and with
    ``with_imports`` what it imports."""
    names = set()
    for node in _top_nodes(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = [target] if isinstance(target, ast.Name) else \
                    getattr(target, "elts", [])
                names |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _reference_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _missing(rel: str) -> set:
    ref = REF / rel
    port = PORT / RENAMED.get(rel, rel)
    assert port.exists(), f"no counterpart of {rel}"
    return (public_names(ref, ref.name == "__init__.py")
            - public_names(port, port.name == "__init__.py"))


@pytest.mark.parametrize("rel", _reference_modules())
def test_port_defines_the_reference_surface(rel):
    missing = {n for n in _missing(rel) if (rel, n) not in EXCLUDED}
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def test_every_exclusion_is_a_current_gap_with_a_reason():
    """An excluded name is one the reference has and the port lacks, and
    carries a reason: the list does not outlive the gaps it excuses."""
    for (rel, name), reason in EXCLUDED.items():
        assert reason.strip(), (rel, name)
        assert name in _missing(rel), f"{rel}: {name} is no longer a gap"


def test_package_reexports_match_the_reference():
    import repro.data
    import repro.fed
    import repro.models
    import repro_torch.data
    import repro_torch.fed
    import repro_torch.models

    assert repro_torch.fed.__all__ == repro.fed.__all__
    for pkg, names in ((repro_torch.fed, repro.fed.__all__),
                       (repro_torch.data, ("synthetic_lm_batch",
                                           "fed_lm_batches",
                                           "make_batch_for")),
                       (repro_torch.models, ("Model", "build_model"))):
        for name in names:
            assert callable(getattr(pkg, name)), (pkg.__name__, name)
    import repro_torch.configs as tconfigs

    assert tconfigs.fedplt_logreg.LogRegConfig().n_agents == 100


# ---------------------------------------------------------------------------
# fed_lm_batches
# ---------------------------------------------------------------------------

N_AGENTS, SEQ, BATCH = 3, 64, 12


def _head_share(tokens: np.ndarray, vocab: int, agent: int) -> float:
    """The share of an agent's tokens in its shifted head range."""
    lo = (agent * 100) % vocab
    rel = (tokens - lo) % vocab
    return float(np.mean(rel < max(2, int(vocab * 0.1))))


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-small",
                                  "internvl2-26b"])
def test_fed_lm_batches_shapes_keys_and_skews(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jit = jsyn.fed_lm_batches(jcfg, JaxShape("t", SEQ, BATCH, "train"),
                              N_AGENTS)
    tit = tsyn.fed_lm_batches(tcfg, InputShape("t", SEQ, BATCH, "train"),
                              N_AGENTS, device="cpu")
    j0, t0, t1 = next(jit), next(tit), next(tit)
    assert set(t0) == set(j0)
    for k in j0:
        assert tuple(t0[k].shape) == tuple(j0[k].shape), k
        assert t0[k].dtype.is_floating_point == \
            jnp.issubdtype(j0[k].dtype, jnp.floating), k
    tok = t0["tokens"].numpy()
    assert tok.min() >= 0 and tok.max() < tcfg.vocab
    assert np.array_equal(t0["labels"].numpy(), np.roll(tok, -1, axis=-1))
    # agent a draws its head at skew a in both packages
    for a in range(N_AGENTS):
        j = _head_share(np.asarray(j0["tokens"][a]), jcfg.vocab, a)
        t = _head_share(tok[a], tcfg.vocab, a)
        assert abs(j - t) < 0.08, (a, j, t)
    # one stream a seed; each step its own draw
    again = next(tsyn.fed_lm_batches(tcfg, InputShape("t", SEQ, BATCH,
                                                      "train"),
                                     N_AGENTS, device="cpu"))
    other = next(tsyn.fed_lm_batches(tcfg, InputShape("t", SEQ, BATCH,
                                                      "train"),
                                     N_AGENTS, seed=1, device="cpu"))
    assert torch.equal(again["tokens"], t0["tokens"])
    assert not torch.equal(t1["tokens"], t0["tokens"])
    assert not torch.equal(other["tokens"], t0["tokens"])


def test_fed_lm_batches_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the stream would run there")
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tsyn.fed_lm_batches(cfg, InputShape("t", 8, 2, "train"), 2))


# ---------------------------------------------------------------------------
# The derived prox operators (tests/test_prox.py's cases)
# ---------------------------------------------------------------------------

def _vectors(n=50, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        size = int(rng.integers(1, 9))
        yield (rng.uniform(-10, 10, size).astype(np.float32),
               rng.uniform(-10, 10, size).astype(np.float32),
               float(rng.uniform(0.2, 5.0)))


def test_reflect_matches_the_reference_and_is_nonexpansive():
    for x, y, rho in _vectors():
        refl = TP.reflect(TP.prox_l1)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        np.testing.assert_allclose(
            refl(tx, rho).numpy(),
            np.asarray(JP.reflect(JP.prox_l1)(jnp.asarray(x), rho)),
            rtol=1e-6, atol=1e-6)
        d_out = float(torch.linalg.norm(refl(tx, rho) - refl(ty, rho)))
        assert d_out <= float(torch.linalg.norm(tx - ty)) + 1e-5


def test_moreau_conjugate_of_l1_is_linf_projection():
    for x, _, rho in _vectors(seed=1):
        tx = torch.from_numpy(x)
        got = TP.moreau_conjugate(TP.prox_l1)(tx, rho)
        np.testing.assert_allclose(got.numpy(), np.clip(x, -1.0, 1.0),
                                   atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JP.moreau_conjugate(JP.prox_l1)(
                jnp.asarray(x), rho)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prox", ["zero", "l1", "l2sq", "box"])
def test_coordinator_prox_lemma6(prox):
    z = np.array([[1.0, 2.0], [3.0, -1.0], [-2.0, 5.0]], np.float32)
    rho = 2.0
    got = TP.coordinator_prox(torch.from_numpy(z), rho, TP.make_prox(prox))
    want = JP.coordinator_prox(jnp.asarray(z), rho, JP.make_prox(prox))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    expect = TP.make_prox(prox)(torch.from_numpy(z).mean(0), rho / 3.0)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=1e-7)


def test_prox_of_smooth_matches_closed_form_and_reference():
    Q = np.array([[2.0, 0.3], [0.3, 1.0]], np.float32)
    b = np.array([0.5, -1.0], np.float32)
    y = np.array([1.0, 1.0], np.float32)
    rho = 0.5
    tQ, tb = torch.from_numpy(Q), torch.from_numpy(b)
    got = TP.prox_of_smooth(lambda x: tQ @ x + tb, torch.from_numpy(y), rho,
                            steps=2000, smoothness=3.0)
    expect = np.linalg.solve(np.eye(2) + rho * Q, y - rho * b)
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-4)
    jQ, jb = jnp.asarray(Q), jnp.asarray(b)
    for steps in (1, 7, 50):
        want = JP.prox_of_smooth(lambda x: jQ @ x + jb, jnp.asarray(y), rho,
                                 steps=steps, smoothness=3.0)
        got = TP.prox_of_smooth(lambda x: tQ @ x + tb, torch.from_numpy(y),
                                rho, steps=steps, smoothness=3.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# FedConfig, privacy_report, fedplt_update_tree, FedTrainer
# ---------------------------------------------------------------------------

RENAMED_FIELDS = {"use_pallas": "use_fused_update"}
RENAMED_VALUES = {"xla": "torch", "pallas": "fused"}
SHIMS = {
    "defaults": {},
    "dp": dict(tau=0.1, clip=1.0, n_agents=4, gamma=0.02),
    "compressed": dict(compression="topk", compress_ratio=0.1,
                       compress_backend="pallas", engine_backend="pallas",
                       state_layout="packed", damping=0.5),
    "agd": dict(solver="agd", mu=0.1, L=4.0, weight_decay=0.01,
                participation=0.5),
    "robust-async": dict(aggregator="trimmed_mean", aggregator_param=1.0,
                         guard_increments=True, guard_norm_bound=10.0,
                         async_mode="stale", max_staleness=2,
                         use_pallas_update=True),
}


def _port_value(v):
    if isinstance(v, dict):
        return {k: _port_value(x) for k, x in v.items()}
    return RENAMED_VALUES.get(v, v) if isinstance(v, str) else v


@pytest.mark.parametrize("name", list(SHIMS))
def test_fed_config_to_spec_field_for_field(name):
    kw = SHIMS[name]
    tkw = {("use_fused_update" if k == "use_pallas_update" else k):
           _port_value(v) for k, v in kw.items()}
    jspec = jruntime.FedConfig(**kw).to_spec()
    tspec = truntime.FedConfig(**tkw).to_spec()
    assert isinstance(tspec, tapi.FedSpec)
    jd, td = dataclasses.asdict(jspec), dataclasses.asdict(tspec)
    for k, v in jd.items():
        assert td[RENAMED_FIELDS.get(k, k)] == _port_value(v), k
    assert tapi.as_spec(truntime.FedConfig(**tkw)) == tspec
    if jspec.privacy.tau > 0:
        jrep = jruntime.privacy_report(jruntime.FedConfig(**kw), 100, 8)
        trep = truntime.privacy_report(truntime.FedConfig(**tkw), 100, 8)
        assert trep.adp_eps == pytest.approx(jrep.adp_eps, rel=1e-12)
        assert trep.eps_ceiling == pytest.approx(jrep.eps_ceiling, rel=1e-12)


def test_fedplt_update_tree_matches_the_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 37), "b": (4, 3, 5), "c": (4, 1)}
    trees = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    want = jupdate.fedplt_update_tree(
        *[{k: jnp.asarray(v) for k, v in t.items()} for t in trees],
        gamma=0.05, inv_rho=0.5, interpret=True)
    got = tupdate.fedplt_update_tree(
        *[{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
        gamma=0.05, inv_rho=0.5)
    assert set(got) == set(want)
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_both_trainers_are_fed_trainers():
    jp = jax_logreg(n_agents=4, q=10, dim=3, seed=0)
    dense = tapi.build_trainer(
        problem_from_arrays(np.asarray(jp.A), np.asarray(jp.b)),
        tapi.FedSpec(), device="cpu")
    model = tapi.build_trainer(build_model(get_config("gemma2-2b").reduced()),
                               tapi.FedSpec(n_agents=2, gamma=0.05),
                               device="cpu")
    for tr in (dense, model):
        assert isinstance(tr, tapi.FedTrainer)
        assert isinstance(tr.spec, tapi.FedSpec)
    assert issubclass(japi.DenseTrainer, japi.FedTrainer)
    with pytest.raises(NotImplementedError):
        tapi.FedTrainer().consensus(None)
