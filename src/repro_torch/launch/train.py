"""Training entry point (counterpart of ``repro/launch/train.py``).

Runs Fed-PLT rounds (``--mode fed``, the default) or standard training
with an optimizer (``--mode standard --optimizer sgd|momentum|adamw
--lr``) of an architecture on one device: CUDA unless ``--device cpu``.
:func:`run_fed` and :func:`run_standard` hold the loops for a built
config, so other scripts (``chip_smoke.py``) run the same loops on a
config cut in depth.

Checkpoints (:mod:`repro_torch.checkpoint`, the reference's format):
``--checkpoint DIR`` saves the final model (the consensus in fed mode)
to ``DIR``; in fed mode ``--checkpoint-every K`` saves the round state
to ``DIR/rounds/step-NNNNNN`` every K rounds and ``--resume`` continues
from the latest of them, the final save then going to
``DIR/consensus``.  A round checkpoint's ``extra`` holds the round, the
realised arrival rows of the rounds so far (async rounds; empty when
synchronous) and the state of the run's ``torch.Generator``, so a resumed
run draws what the uninterrupted run draws and equals it bit for bit.
Under a mesh every rank takes part in a save (the state's blocks are
gathered, rank 0 writes the one file the unsharded run writes) and
resumes from the checkpoint rank 0 finds, keeping its own block; a
sharded run resumes from an unsharded run's checkpoint and the other way
round.

Heterogeneous agent groups (``--agent-groups``, the grammar
``SIZE[*SOLVER][:key=value]...``; each group its own solver, epochs, step
size and participation): with ``--tau > 0`` the privacy line is followed
by the per-agent (eps_i, delta) table.  ``--problem logreg`` takes them
too:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 3 --agent-groups '2*gd,2*agd:n_epochs=1' --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --problem logreg \\
      --steps 20 --agent-groups '50*gd,50*agd' --device cpu

Bounded-staleness async rounds (``--async-mode stale --max-staleness
K``): each round line also prints ``stale=`` (the mean staleness), the
realised arrival rows are collected (and restored on ``--resume``), and
with ``--tau > 0`` the run ends with the effective per-agent privacy
table composed over that schedule:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 6 --n-agents 4 --participation 0.5 \\
      --async-mode stale --max-staleness 2 --tau 0.01 --clip 1.0 \\
      --state-layout packed --device cpu

Standard training (one loss and gradient a step over the whole batch):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 3 --mode standard --optimizer adamw --device cpu

Round checkpoints and a resume:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 3 --n-agents 2 --checkpoint ckpt \\
      --checkpoint-every 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 6 --n-agents 2 --checkpoint ckpt \\
      --checkpoint-every 1 --resume --device cpu

Example (the slice's main path, on a card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01

The same with the compressed z-uplink (one rank_select kernel per
round; ``--compression int8|adaptive_topk`` likewise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01 --compression topk --compress-ratio 0.25

The byzantine-robust, fault-screened round (one sort_aggregate kernel
per round; ``--aggregator coord_median|norm_clip_mean`` likewise):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --n-agents 4 --batch 8 --seq-len 512 --n-epochs 2 \\
      --state-layout packed --engine-backend fused --use-fused-update \\
      --weight-decay 0.01 --aggregator trimmed_mean --aggregator-param 1 \\
      --guard-increments

Sharded rounds (checkpoints and ``--resume`` as above): one process per
rank of the ``(agent, model)`` mesh,
started by torchrun (``--mesh-shape 1x1`` runs in one process, without
it); every rank draws the same global batch and keeps its agents, and
only rank 0 prints.  On cards torchrun starts one rank per card (NCCL).
Two gloo ranks on the CPU:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --n-agents 4 --agent-shards 2 --state-layout packed \\
      --engine-backend fused --use-fused-update --device cpu
The model axis (``--mesh-shape AxM``, M > 1): each model rank holds a
column block of the packed state (in the tree layout, each leaf's block
by its spec) and runs a share of each agent's batch:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --n-agents 4 --mesh-shape 1x2 --state-layout packed \\
      --engine-backend fused --use-fused-update --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch falcon-mamba-7b --smoke --n-agents 4 --mesh-shape 1x2 \\
      --device cpu
The paper's dense front end (``--problem logreg``: N agents, ``--dim``
features, ``--q`` samples each; one criterion line a round), sharded the
same way:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --problem logreg \\
      --n-agents 100 --dim 100 --mesh-shape 2x2 --state-layout packed \\
      --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import find_latest_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.fedplt_logreg import CONFIG as LOGREG
from repro_torch.core.problem import make_logreg_problem
from repro_torch.data.synthetic import make_batch_for
from repro_torch.fed import api
from repro_torch.models.model import build_model
from repro_torch.optim import OPTIMIZERS, apply_updates


def run_fed(cfg: ModelConfig, spec: api.FedSpec, *, steps: int,
            seq_len: int, batch: int, device=None, seed: int = 0,
            local_dataset_size=None, checkpoint=None, checkpoint_every=0,
            resume=False, log=print):
    """``steps`` Fed-PLT rounds of ``cfg`` under ``spec`` on synthetic
    per-agent batches; logs one line per round (and the privacy position
    first when ``tau > 0``, followed by the per-agent table under agent
    groups; under async rounds the effective per-agent table last).
    With ``checkpoint_every`` the round state goes to
    ``<checkpoint>/rounds/step-NNNNNN`` every that many rounds; ``resume``
    continues from the latest of them (module docstring).  Returns
    ``(trainer, state, history)``, the history of the rounds run here
    (async rounds: each entry's ``arrivals`` is the realised row)."""
    device = resolve_device(device)
    spec.validate()
    trainer = api.build_trainer(build_model(cfg), spec, device)
    log = _mesh_log(trainer.mesh, log)
    if spec.privacy.tau > 0:
        q = local_dataset_size or max(1, batch // spec.n_agents)
        rep = trainer.privacy_report(steps, q)
        caveat = "" if spec.privacy.clip is not None else \
            " (UNCLIPPED: per-sample sensitivity assumed 1.0 -- pass --clip)"
        log(f"privacy: ({rep.adp_eps:.3f}, {rep.adp_delta:.0e})-ADP"
            f" over K={rep.K} rounds x N_e={rep.n_epochs};"
            f" ceiling as K*Ne->inf: eps={rep.eps_ceiling:.3f}"
            f" at Renyi order {rep.rdp_order:.1f}{caveat}")
        if rep.per_agent:
            # agent groups: the headline eps above is the max over this
            # per-agent (eps_i, delta) table (Prop. 4)
            for a in rep.per_agent:
                log(f"  agent {a.agent:3d}: q_i={a.q} N_e={a.n_epochs} "
                    f"gamma={a.gamma:.4g} eps_i={a.adp_eps:.3f} "
                    f"(ceiling {a.eps_ceiling:.3f})")
    state, gen = trainer.init(seed)
    start = 0
    stale = spec.staleness_config().enabled
    arrival_rows = []       # the realised (N,) rows: the run's schedule
    rounds_dir = os.path.join(checkpoint, "rounds") if checkpoint else None
    if resume:
        latest = [find_latest_checkpoint(rounds_dir)]
        if trainer.mesh is not None:
            # every rank resumes from rank 0's choice
            dist.broadcast_object_list(latest, src=0)
        latest = latest[0]
        if latest is None:
            log(f"resume: no committed checkpoint under {rounds_dir} -- "
                f"starting from round 0")
        else:
            state, extra = trainer.restore_state(latest, state, gen)
            start = int(extra.get("round", 0))
            arrival_rows = [list(r) for r in extra.get("arrivals", [])]
            log(f"resumed from {latest} at round {start}")
    shape = InputShape("cli", seq_len, batch, "train")
    history = []
    for i in range(start, steps):
        b = make_batch_for(cfg, shape, gen, n_agents=spec.n_agents,
                           device=trainer.device)
        t0 = time.time()
        state, metrics = trainer.step(state, b, gen)
        # waits for the device
        m = {k: float(v) if v.ndim == 0 else v.tolist()
             for k, v in metrics.items()}
        m["dt"] = time.time() - t0
        history.append(m)
        extra = ""
        if stale:
            arrival_rows.append(m["arrivals"])
            extra = f" stale={m['staleness']:.2f}"
        log(f"round {i:4d} loss={m['loss']:.4f} "
            f"part={m['participation']:.2f}{extra} dt={m['dt']:.2f}s")
        if checkpoint_every and (i + 1) % checkpoint_every == 0:
            ck = os.path.join(rounds_dir, f"step-{i + 1:06d}")
            # synchronous rounds realize no arrival rows
            trainer.save_state(ck, state, gen,
                               extra={"round": i + 1,
                                      "arrivals": list(arrival_rows)})
            log(f"  checkpointed round {i + 1} -> {ck}")
    if stale and spec.privacy.tau > 0 and arrival_rows:
        # the nominal position above charged every agent all the rounds;
        # recompose over the realised schedule, each agent over the
        # rounds of local work it released
        q = local_dataset_size or max(1, batch // spec.n_agents)
        rep = api.effective_privacy_report(spec, arrival_rows, q)
        log(f"effective privacy (realized arrival schedule, "
            f"max_staleness={spec.max_staleness}): "
            f"({rep.adp_eps:.3f}, {rep.adp_delta:.0e})-ADP")
        for a in rep.per_agent:
            log(f"  agent {a.agent:3d}: arrivals={a.arrivals} "
                f"released_rounds={a.K}/{rep.K} eps_i={a.adp_eps:.3f} "
                f"(ceiling {a.eps_ceiling:.3f})")
    return trainer, state, history


def standard_step(model, opt, params: dict, opt_state, batch: dict):
    """One standard training step: the loss and its gradient over the
    whole batch, ``opt.update`` and :func:`apply_updates`.  Returns
    ``(params, opt_state, loss)``."""
    names = list(params)
    leaves = [params[n].detach().requires_grad_() for n in names]
    with torch.enable_grad():
        loss = model.loss_fn(dict(zip(names, leaves)), batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    with torch.no_grad():
        upd, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, upd)
    return params, opt_state, loss.detach()


def run_standard(cfg: ModelConfig, *, optimizer: str, lr: float, steps: int,
                 seq_len: int, batch: int, device=None, seed: int = 0,
                 log=print):
    """``steps`` standard training steps of ``cfg`` with ``optimizer``
    (``sgd``, ``momentum`` or ``adamw``) at ``lr`` on synthetic batches
    without an agent axis; logs one line a step.  Returns ``(params,
    history)``."""
    device = resolve_device(device)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device)
    opt = OPTIMIZERS[optimizer](lr)
    opt_state = opt.init(params)
    shape = InputShape("cli", seq_len, batch, "train")
    history = []
    for i in range(steps):
        b = make_batch_for(cfg, shape, gen, device=device)
        t0 = time.time()
        params, opt_state, loss = standard_step(model, opt, params,
                                                opt_state, b)
        m = {"loss": float(loss), "dt": time.time() - t0}
        history.append(m)
        log(f"step {i:4d} loss={m['loss']:.4f} dt={m['dt']:.2f}s")
    return params, history


def _silent(*args, **kwargs):
    """The log of ranks other than 0."""


def _mesh_log(mesh, log):
    """The log of this rank (silent but on rank 0 of a mesh), after the
    reference's mesh line."""
    if mesh is None:
        return log
    if dist.get_rank() != 0:
        log = _silent
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    log(f"mesh: {sizes} over {mesh.size()} devices (agent axis sharded)")
    return log


def run_dense(spec: api.FedSpec, *, steps: int, dim: int = LOGREG.dim,
              q: int = LOGREG.q, device=None, seed: int = 0, log=print):
    """``steps`` Fed-PLT rounds of the paper's logistic-regression
    federation (``spec.n_agents`` agents, ``dim`` features, ``q`` samples
    each, seeded); logs the criterion ``||sum_i grad f_i(x_bar)||^2`` a
    round.  Returns ``(trainer, state, criterion history)``."""
    device = resolve_device(device)
    problem = make_logreg_problem(n_agents=spec.n_agents, q=q, dim=dim,
                                  seed=seed, device=device)
    trainer = api.build_trainer(problem, spec.validate(), device)
    log = _mesh_log(trainer.mesh, log)
    t0 = time.time()
    state, crit = trainer.run(seed, steps)
    crit = crit.tolist()                      # waits for the device
    dt = (time.time() - t0) / max(steps, 1)
    for i, c in enumerate(crit):
        log(f"round {i:4d} criterion={c:.4e}")
    log(f"{dt * 1e3:.2f} ms a round")
    return trainer, state, crit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model architecture (or --problem)")
    ap.add_argument("--problem", default=None, choices=["logreg"],
                    help="the paper's dense front end instead of a model")
    ap.add_argument("--dim", type=int, default=LOGREG.dim,
                    help="--problem: features n")
    ap.add_argument("--q", type=int, default=LOGREG.q,
                    help="--problem: samples a agent q_i")
    ap.add_argument("--mode", default="fed", choices=["fed", "standard"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, d_model 256)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local-dataset-size", type=int, default=None,
                    help="local dataset size q_i for the privacy report "
                         "(default: per-agent batch)")
    ap.add_argument("--optimizer", default="sgd",
                    choices=sorted(OPTIMIZERS))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="fed mode: save the round state to "
                         "<checkpoint>/rounds/step-NNNNNN every N rounds "
                         "(atomic tmp-then-rename saves; 0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="fed mode: resume from the latest committed "
                         "round checkpoint under <checkpoint>/rounds "
                         "(bit for bit: the checkpoint carries the run's "
                         "generator state)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    api.add_spec_args(ap)
    # --problem takes its agent count from the paper's set-up, --arch the
    # spec flag's default
    model_agents = ap.get_default("n_agents")
    ap.set_defaults(n_agents=None)
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.problem is None):
        ap.error("give one of --arch and --problem")
    if args.n_agents is None:
        args.n_agents = LOGREG.n_agents if args.problem else model_agents
    if (args.checkpoint_every or args.resume) and not args.checkpoint:
        ap.error("--checkpoint-every/--resume require --checkpoint")
    if (args.checkpoint_every or args.resume) and args.mode != "fed":
        ap.error("--checkpoint-every/--resume are fed-mode only")
    if args.problem is not None and (args.mode != "fed" or args.checkpoint):
        ap.error("--problem runs fed rounds without --checkpoint (the dense "
                 "trainer checkpoints through DenseTrainer.save_state)")
    device = resolve_device(args.device)
    spec = api.spec_from_args(args)
    if args.mode == "fed":
        spec.validate()      # fail fast, before building the model
    if args.problem is not None:
        trainer, _, _ = run_dense(spec, steps=args.steps, dim=args.dim,
                                  q=args.q, device=device, seed=args.seed)
        if trainer.mesh is not None:
            dist.destroy_process_group()
        return
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    mesh, run_device = None, device
    if args.mode == "fed":
        trainer, state, _ = run_fed(
            cfg, spec, steps=args.steps, seq_len=args.seq_len,
            batch=args.batch, device=device, seed=args.seed,
            local_dataset_size=args.local_dataset_size,
            checkpoint=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume)
        final = trainer.consensus(state)
        mesh, run_device = trainer.mesh, trainer.device
    else:
        final, _ = run_standard(
            cfg, optimizer=args.optimizer, lr=args.lr, steps=args.steps,
            seq_len=args.seq_len, batch=args.batch, device=device,
            seed=args.seed)
    if mesh is None or dist.get_rank() == 0:
        if args.checkpoint:
            target = args.checkpoint
            if args.checkpoint_every or args.resume:
                # the round checkpoints live under <checkpoint>/rounds;
                # save_checkpoint atomically REPLACES its target, so the
                # final save takes a sibling entry
                target = os.path.join(args.checkpoint, "consensus")
            save_checkpoint(target, final, step=args.steps)
            print(f"saved checkpoint to {target}")
        n = sum(p.numel() for p in final.values())
        print(f"done: {args.arch} ({n / 1e6:.2f}M params) on {run_device}")
        if device.type == "cuda":
            print(f"peak device memory: "
                  f"{torch.cuda.max_memory_allocated(run_device) / 2**30:.2f}"
                  f" GiB")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
