"""Standard training and resumed federated runs of the port.

Standard mode: the port's ``standard_step`` (one loss and gradient over
the whole batch, ``opt.update``, ``apply_updates``) against the
reference's step (``jax.value_and_grad`` of its ``loss_fn``, its
optimizer), reduced gemma2-2b and falcon-mamba-7b in float32, 3 steps
of each optimizer from the same parameters (the port's init, as numpy
for the reference) on the same numpy batches.  The losses agree to 1e-5
relative and, after sgd and momentum, the parameters to 1e-4.  AdamW's first step moves every entry by about
``lr * sign(g)``: an entry whose gradient is near 0 in one package
(within float32 rounding of the two gradients) may move the other way,
so after 3 steps an entry may differ by up to ``2 * 3 * lr``.  The test
allows that at a counted number of entries, at most 0.1% of them, and
holds every other entry to 1e-4 (measured: 2 of 1,443,072 entries of
gemma2-2b and 0 of 1,007,360 of falcon-mamba-7b beyond 1e-4).

Resume: ``launch.train`` runs 6 rounds with a checkpoint every 3, and
again 3 rounds, then ``--resume`` to 6; the two step-6 checkpoints hold
the same bits (``x``, ``z``, ``t``, ``step``).  Packed and tree layouts,
gd, noisy_gd (``--tau``) and sgd, ``--compression topk``; the dense front
end through ``DenseTrainer.save_state`` / ``restore_state``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import optim as toptim
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.problem import make_logreg_problem
from repro_torch.fed import api as tapi
from repro_torch.launch import train
from repro_torch.models.model import build_model

STEPS, LR = 3, 1e-3


@pytest.fixture(scope="module", params=["gemma2-2b", "falcon-mamba-7b"])
def standard(request):
    arch = request.param
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    tree = params_to_jax(tmodel.init(torch.Generator().manual_seed(1),
                                     "cpu"))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, batch=b)))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
        batches.append((tok, np.roll(tok, -1, axis=-1)))
    return dict(arch=arch, tcfg=tcfg, tmodel=tmodel, tree=tree, vg=vg,
                batches=batches)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_standard_steps_match_reference(standard, opt):
    jp = jax.tree_util.tree_map(jnp.asarray, standard["tree"])
    tp = params_from_jax(standard["tree"], standard["tcfg"])
    jopt = getattr(joptim.optimizers, opt)(LR)
    topt = toptim.OPTIMIZERS[opt](LR)
    js, ts = jopt.init(jp), topt.init(tp)

    @jax.jit
    def jupdate(g, js, jp):
        upd, js = jopt.update(g, js, jp)
        return joptim.apply_updates(jp, upd), js

    for tok, lab in standard["batches"]:
        jloss, g = standard["vg"](jp, {"tokens": jnp.asarray(tok),
                                       "labels": jnp.asarray(lab)})
        jp, js = jupdate(g, js, jp)
        tp, ts, tloss = train.standard_step(
            standard["tmodel"], topt, tp, ts,
            {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    got = jax.tree_util.tree_leaves(params_to_jax(tp))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    if opt != "adamw":
        assert diff.max() <= 1e-4, diff.max()
        return
    flips = int((diff > 1e-4).sum())
    assert diff.max() <= 2 * STEPS * LR, diff.max()
    assert flips <= 1e-3 * diff.size, (flips, diff.size)


def test_standard_mode_cli_runs_on_the_cpu(tmp_path, capsys):
    train.main(["--arch", "gemma2-2b", "--smoke", "--mode", "standard",
                "--optimizer", "adamw", "--steps", "2", "--seq-len", "16",
                "--batch", "2", "--device", "cpu",
                "--checkpoint", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "saved checkpoint" in out
    assert sorted(np.load(tmp_path / "ck" / "leaves.npz").files) == sorted(
        n.replace(".", "/") for n in
        build_model(get_config("gemma2-2b").reduced()).param_shapes())


# ---------------------------------------------------------------------------
# Resume, bit for bit
# ---------------------------------------------------------------------------

RESUME = {
    "packed-gd": dict(state_layout="packed"),
    "tree-gd": {},
    "packed-noisy_gd": dict(state_layout="packed",
                            privacy=tapi.PrivacySpec(tau=0.01, clip=1.0)),
    "packed-sgd": dict(state_layout="packed", solver="sgd"),
    "packed-topk": dict(state_layout="packed", participation=0.5,
                        compression=tapi.CompressionSpec("topk")),
}


def _leaves(root, step):
    return np.load(os.path.join(root, "rounds", f"step-{step:06d}",
                                "leaves.npz"))


def _same_checkpoints(a, b):
    assert a.files == b.files
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_resume_through_the_cli(tmp_path, capsys):
    """``--checkpoint-every`` / ``--resume`` of ``launch.train``: 6 rounds
    against 3, then a resume to 6; the final consensus saves agree too."""
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")

    def cli(root, steps, *flags):
        train.main(["--arch", "gemma2-2b", "--smoke", "--steps", str(steps),
                    "--n-agents", "2", "--n-epochs", "1", "--seq-len", "16",
                    "--batch", "4", "--state-layout", "packed", "--device",
                    "cpu", "--checkpoint", root, "--checkpoint-every", "3",
                    *flags])

    cli(whole, 6)
    cli(split, 3)
    cli(split, 6, "--resume")
    out = capsys.readouterr().out
    assert f"resumed from {split}/rounds/step-000003 at round 3" in out
    _same_checkpoints(_leaves(whole, 6), _leaves(split, 6))
    _same_checkpoints(*(np.load(os.path.join(r, "consensus", "leaves.npz"))
                        for r in (whole, split)))


@pytest.mark.parametrize("case", list(RESUME))
def test_resumed_run_equals_uninterrupted_run(tmp_path, case):
    cfg = get_config("gemma2-2b").reduced(d_model=64, vocab=128)
    spec = tapi.FedSpec(n_agents=2, n_epochs=2, gamma=0.05, **RESUME[case])
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    kw = dict(seq_len=16, batch=4, device="cpu", checkpoint_every=3,
              log=lambda *a: None)
    train.run_fed(cfg, spec, steps=6, checkpoint=whole, **kw)
    train.run_fed(cfg, spec, steps=3, checkpoint=split, **kw)
    _, state, hist = train.run_fed(cfg, spec, steps=6, checkpoint=split,
                                   resume=True, **kw)
    assert len(hist) == 3 and state.step == 6
    a, b = _leaves(whole, 6), _leaves(split, 6)
    want = {".x", ".z", ".step"} | ({".t"} if "topk" in case else set())
    assert {k.split("/")[0] for k in a.files} == want
    assert ("tree" in case) == (".x" not in a.files)
    _same_checkpoints(a, b)
    assert int(a[".step"]) == 6 and a[".step"].dtype == np.int32


def test_dense_resume_equals_uninterrupted_run(tmp_path):
    problem = make_logreg_problem(n_agents=8, q=20, dim=5, seed=0,
                                  device="cpu")
    spec = tapi.FedSpec(rho=1.0, n_epochs=3, participation=0.5,
                        solver="sgd", batch_size=4,
                        compression=tapi.CompressionSpec("topk"),
                        privacy=tapi.PrivacySpec(tau=0.01))

    def trainer():
        return tapi.build_trainer(problem, spec, device="cpu")

    tr = trainer()
    whole = tr.init(0)
    for _ in range(6):
        whole = tr.step(whole)
    split = tr.init(0)
    for _ in range(3):
        split = tr.step(split)
    tr.save_state(str(tmp_path / "ck"), split, extra={"round": 3})
    tr2 = trainer()
    state, extra = tr2.restore_state(str(tmp_path / "ck"), tr2.init(5))
    assert extra["round"] == 3 and state.k == 3
    for _ in range(3):
        state = tr2.step(state)
    for var in ("x", "z", "y", "t"):
        assert torch.equal(getattr(state, var), getattr(whole, var)), var
    assert state.k == whole.k == 6
