"""Serve a small model with batched requests, in PyTorch (the twin of
``examples/serve_lm.py`` on ``repro_torch``): prefill + decode with the
production cache semantics (ring buffers for local-attention layers,
recurrent state for SSM / hybrid layers).

Runs on the card unless ``--device cpu``.  The parameters, the prompts
and the samples at ``--temperature > 0`` come from one
``torch.Generator`` seeded 0 on the run's device.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py \\
          --arch recurrentgemma-2b [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models.model import build_model


def serve(model, params, prompts, gen_len, temperature=0.8,
          generator=None):
    """``gen_len`` tokens after each of the batched ``prompts`` (B, P):
    sampled at ``temperature`` from ``generator``, greedy at 0.  Returns
    ``(tokens (B, gen_len), seconds)``, the tokens on the host."""
    t0 = time.time()
    out = generate(model, params, prompts, gen_len=gen_len,
                   cache_len=prompts.shape[1] + gen_len,
                   temperature=temperature, generator=generator)
    out = out.cpu()                         # waits for the device
    return out, time.time() - t0


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=8,
                    help="batched concurrent requests")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)

    # batched "requests": different prompts, served together
    prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                            generator=gen, device=device)
    out, dt = serve(model, params, prompts, args.gen_len, args.temperature,
                    gen)
    tps = args.requests * args.gen_len / dt
    log(f"arch={args.arch} (reduced), {args.requests} requests, "
        f"{args.gen_len} tokens each")
    log(f"throughput: {tps:.1f} tok/s ({device.type})")
    for i in range(min(3, args.requests)):
        log(f"request {i}: {out[i][:10].tolist()}...")
    return dict(tokens=out, seconds=dt, tokens_per_s=tps)


if __name__ == "__main__":
    main()
