"""Serving entry point: batched prefill (through the decode step) and a
decode loop (counterpart of ``repro/launch/serve.py``).

Runs on CUDA unless ``--device cpu``.  Sampling at ``--temperature > 0``
draws from an explicit ``torch.Generator``, the one that drew the
parameters and prompts (seed 0); 0 is greedy.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --smoke --prompt-len 16 --gen-len 16 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.model import build_model


@torch.no_grad()
def prefill_via_decode(model, params, cache, prompt):
    """Feed the prompt's tokens (B, P) through ``decode_step`` one
    position at a time (the serving cache's own semantics; the parallel
    forward is the other way to prefill).  Returns ``(cache, logits of
    the last position)``."""
    logits = None
    for t in range(prompt.shape[1]):
        logits, cache = model.decode_step(params, cache, prompt[:, t])
    return cache, logits


@torch.no_grad()
def generate(model, params, prompts, gen_len, cache_len, temperature=0.0,
             generator=None):
    """``gen_len`` tokens a prompt after ``prompts`` (B, P): greedy, or
    sampled at ``temperature`` from ``generator`` when both are given.
    The cache lives on the prompts' device.  Returns (B, gen_len) int32
    tokens."""
    B = prompts.shape[0]
    cache = model.init_cache(B, cache_len, device=prompts.device)
    cache, logits = prefill_via_decode(model, params, cache, prompts)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [toks]
    for _ in range(gen_len - 1):
        logits, cache = model.decode_step(params, cache, toks)
        if temperature > 0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            toks = torch.multinomial(probs, 1, generator=generator)[:, 0]
            toks = toks.to(torch.int32)
        else:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(toks)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.time()
    out = generate(model, params, prompts, gen_len=args.gen_len,
                   cache_len=args.prompt_len + args.gen_len,
                   temperature=args.temperature, generator=gen)
    out = out.cpu()                         # waits for the device
    dt = time.time() - t0
    tps = args.batch * args.gen_len / dt
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    print("sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
