"""End-to-end run, in PyTorch: federated training of a ~100M-param
transformer with Fed-PLT (the twin of ``examples/train_lm_federated.py``
on ``repro_torch``).

A gemma2-family model (8 layers, d_model 768, vocab 32,768 => ~100M
params counting embeddings) trained over 4 agents with non-IID synthetic
streams, 3 local epochs per round, partial participation, and optional
DP noise.  Runs on the card unless ``--device cpu``: in float32 every
attention layer of every agent's local step runs the flash-attention
kernels (forward and backward) there.  The parameters and every later
draw come from a ``torch.Generator`` seeded 0 on the run's device, the
batches from :func:`repro_torch.data.synthetic.fed_lm_batches` (seed 0).

Run:  PYTHONPATH=src python examples/train_lm_federated_torch.py \\
          [--rounds 300] [--tau 0.001] [--device cpu]
"""

import argparse
import dataclasses
import time

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.synthetic import fed_lm_batches
from repro_torch.fed.api import (FedSpec, PrivacySpec, build_trainer,
                                 parse_agent_groups)
from repro_torch.models.model import build_model


def lm_config(**overrides):
    """The ~100M-param member of the gemma2 family: embed 32768 x 768 =
    25.2M + 8 layers x (attn 1.8M + geglu MLP 7.1M); ``overrides``
    shrink it (tests)."""
    fields = dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=6,
                  head_dim=64, d_ff=3072, vocab=32768, window=64,
                  dtype="float32")
    fields.update(overrides)
    return dataclasses.replace(get_config("gemma2-2b"), **fields)


def make_trainer(model, args, device):
    return build_trainer(model, FedSpec(
        n_agents=args.n_agents, rho=1.0, gamma=0.1,
        n_epochs=args.n_epochs, participation=args.participation,
        agent_groups=args.agent_groups,
        privacy=PrivacySpec(tau=args.tau,
                            clip=1.0 if args.tau > 0 else None)),
        device=device)


def train(trainer, state, batches, n_rounds, generator=None, u_rows=None,
          log=print) -> tuple:
    """``n_rounds`` rounds over ``batches`` (an iterator of agent-stacked
    batches); ``u_rows`` replays given ``(N,)`` participation rows, one a
    round.  Returns ``(state, history)``: each round's loss, participation
    and wall ms (the loss read on the host every round)."""
    hist = []
    t0 = time.time()
    for i in range(n_rounds):
        t_round = time.perf_counter()
        state, metrics = trainer.step(
            state, next(batches), generator,
            u=None if u_rows is None else u_rows[i])
        loss = float(metrics["loss"])
        hist.append(dict(loss=loss,
                         participation=float(metrics["participation"]),
                         ms=1e3 * (time.perf_counter() - t_round)))
        if i % 10 == 0 or i == n_rounds - 1:
            log(f"round {i:4d} loss={loss:.4f} "
                f"part={hist[-1]['participation']:.2f} "
                f"({time.time() - t0:.0f}s)")
    return state, hist


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--n-agents", type=int, default=4)
    ap.add_argument("--n-epochs", type=int, default=3)
    ap.add_argument("--tau", type=float, default=0.0)
    ap.add_argument("--participation", type=float, default=0.75)
    ap.add_argument("--agent-groups", type=parse_agent_groups,
                    default=None,
                    help="heterogeneous agent groups, e.g. "
                         "'2*agd,2*gd:n_epochs=1:participation=0.5' "
                         "(sizes must sum to --n-agents)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_config()
    model = build_model(cfg)
    n_params = model.param_count()
    log(f"model: gemma2-family, {n_params/1e6:.1f}M params")

    trainer = make_trainer(model, args, device)
    if args.tau > 0:
        rep = trainer.privacy_report(args.rounds,
                                     local_dataset_size=args.batch)
        log(f"privacy: ({rep.adp_eps:.3f}, {rep.adp_delta:.0e})-ADP "
            f"over {rep.K} rounds (ceiling {rep.eps_ceiling:.3f})")
        if rep.per_agent:   # heterogeneous groups: per-agent table
            for a in rep.per_agent:
                log(f"  agent {a.agent}: N_e={a.n_epochs} "
                    f"eps_i={a.adp_eps:.3f}")
    state, gen = trainer.init(0)

    shape = InputShape("lm", args.seq_len, args.batch, "train")
    batches = fed_lm_batches(cfg, shape, args.n_agents, device=device)
    state, hist = train(trainer, state, batches, args.rounds, gen, log=log)

    final = trainer.consensus(state)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, final, step=args.rounds)
        log("checkpoint saved:", args.checkpoint)
    log("done.")
    return dict(n_params=n_params, history=hist, consensus=final,
                trainer=trainer, state=state)


if __name__ == "__main__":
    main()
