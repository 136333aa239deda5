"""Import hygiene and device rules of the PyTorch port.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor anything
of the reference package ``repro``; every module imports on a machine
without CUDA, nvcc or Triton; an entry point asked for CUDA on such a
machine raises rather than carrying on on the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "triton", "ml_dtypes")


def _modules():
    return sorted(p for p in PKG.rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_flash_attention_suite_is_scanned():
    """The flash-attention suite is among the modules the import rules
    here scan (and ``chip_smoke.py``, which drives it on the card)."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    suite = {f"kernels/flash_attention/{m}.py"
             for m in ("__init__", "kernel", "ops", "ref")}
    assert suite <= names, suite - names


def test_ssm_slice_modules_are_scanned():
    """The lru_scan suite, the SSM and RG-LRU blocks and their configs are
    among the modules the import rules here scan."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    slice_ = {f"kernels/lru_scan/{m}.py"
              for m in ("__init__", "kernel", "ops", "ref")}
    slice_ |= {"models/ssm.py", "models/rglru.py",
               "configs/falcon_mamba_7b.py", "configs/recurrentgemma_2b.py"}
    assert slice_ <= names, slice_ - names


def test_moe_slice_modules_are_scanned():
    """The MoE FFN and the MoE configs are among the modules the import
    rules here scan."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    slice_ = {"models/moe.py", "configs/qwen2_moe_a2_7b.py",
              "configs/grok_1_314b.py"}
    assert slice_ <= names, slice_ - names


def test_analysis_modules_are_scanned():
    """The analysis tools (the dry run, the H100 roofline, the round
    analyzer), the kernels' cost formulas and the collectives' tally are
    among the modules the import rules here scan."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    slice_ = {"launch/dryrun.py", "launch/roofline.py",
              "launch/profile_analysis.py", "kernels/costs.py",
              "collectives.py"}
    assert slice_ <= names, slice_ - names


def test_no_module_imports_ml_dtypes():
    """The card machine has no ml_dtypes (it comes with JAX): the port
    reads and writes bfloat16 checkpoints without it."""
    for path in _modules() + [ROOT / "chip_smoke.py"]:
        assert "ml_dtypes" not in set(_imported_roots(path)), path


def test_encdec_and_frontend_modules_are_scanned():
    """The frontend stubs and the enc-dec and vision configs are among the
    modules the import rules here scan."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    slice_ = {"models/frontends.py", "configs/whisper_small.py",
              "configs/internvl2_26b.py"}
    assert slice_ <= names, slice_ - names


def test_checkpoint_optim_and_serving_modules_are_scanned():
    """The checkpoint, optimizer, decode and serve modules are among the
    modules the import rules here scan (and import in the subprocess
    below)."""
    names = {p.relative_to(PKG).as_posix() for p in _modules()}
    slice_ = {"checkpoint/__init__.py", "checkpoint/io.py",
              "optim/__init__.py", "optim/optimizers.py",
              "models/decode.py", "launch/serve.py",
              "configs/fedplt_logreg.py"}
    assert slice_ <= names, slice_ - names


def test_every_module_imports_without_jax_repro_or_triton():
    names = []
    for p in _modules():
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_train_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry point would run")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "gemma2-2b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("entry", [
    ("train", ["--arch", "gemma2-2b", "--smoke", "--steps", "1", "--mode",
               "standard", "--optimizer", "adamw"]),
    ("serve", ["--arch", "gemma2-2b", "--smoke"])], ids=lambda e: e[0])
def test_standard_and_serve_entry_points_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry point would run")
    import importlib

    module = importlib.import_module(f"repro_torch.launch.{entry[0]}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(entry[1])


def test_serve_entry_point_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--batch", "2",
                      "--prompt-len", "4", "--gen-len", "3",
                      "--temperature", "0.7", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3) and "tok/s" in capsys.readouterr().out


def test_trainer_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.configs import get_config
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    model = build_model(get_config("gemma2-2b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build_trainer(model, api.FedSpec(n_agents=2, gamma=0.05))


def test_chip_smoke_fails_without_cuda_and_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
