"""Continuous batching, in PyTorch: serve a stream of requests through
fixed decode slots (the twin of ``examples/continuous_batching.py`` on
``repro_torch``; vLLM-style scheduling, simplified).

Per-sequence cache positions let each slot sit at a different depth:
while one request is still consuming its prompt (prefill-by-decode),
others are generating, and finished slots are freed (``reset_slots``)
and immediately refilled from the queue -- no global synchronization.

Runs on the card unless ``--device cpu``.  The request queue comes from
``numpy.random.default_rng(0)`` (the reference's queue, token for
token), the parameters from a ``torch.Generator`` seeded 1.

Run:  PYTHONPATH=src python examples/continuous_batching_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.decode import reset_slots
from repro_torch.models.model import build_model


def make_queue(vocab: int, requests: int, max_prompt: int, seed: int = 0):
    """``requests`` prompts of 3 to ``max_prompt`` random tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(3, max_prompt + 1)).tolist()
            for _ in range(requests)]


@torch.no_grad()
def serve_stream(model, params, queue, slots, gen_len, device,
                 cache_len=None, record=False) -> dict:
    """Serve ``queue`` (a list of prompts) through ``slots`` decode slots,
    ``gen_len`` greedy tokens a request.  Returns ``done`` (request id ->
    its tokens), ``steps``, ``seconds``, ``tokens_per_s``, ``naive_steps``
    and ``utilization``; with ``record``, ``logits`` (request id -> one
    ``(vocab,)`` row a decode step it took part in, on the device)."""
    B = slots
    if cache_len is None:
        cache_len = max(len(q) for q in queue) + gen_len
    cache = model.init_cache(B, cache_len, device=device)

    slot_req = [-1] * B          # request id per slot (-1 = free)
    slot_prompt = [[] for _ in range(B)]   # remaining prompt
    slot_out = [[] for _ in range(B)]
    done, logged = {}, {}
    next_req = 0
    steps = 0
    t0 = time.time()

    while len(done) < len(queue):
        # admit new requests into free slots
        for b in range(B):
            if slot_req[b] == -1 and next_req < len(queue):
                slot_req[b] = next_req
                slot_prompt[b] = list(queue[next_req])
                slot_out[b] = []
                logged[next_req] = []
                next_req += 1

        # build the next token per slot: prompt token (teacher-forced) or
        # last generated token
        toks = []
        for b in range(B):
            if slot_req[b] == -1:
                toks.append(0)
            elif slot_prompt[b]:
                toks.append(slot_prompt[b].pop(0))
            else:
                toks.append(slot_out[b][-1])
        logits, cache = model.decode_step(
            params, cache, torch.tensor(toks, dtype=torch.int32,
                                        device=device))
        steps += 1
        nxt = torch.argmax(logits, dim=-1).tolist()

        # collect generations / retire finished slots
        finished = [False] * B
        for b in range(B):
            if slot_req[b] == -1:
                continue
            if record:
                logged[slot_req[b]].append(logits[b])
            if not slot_prompt[b]:          # past the prompt: generating
                slot_out[b].append(int(nxt[b]))
            if len(slot_out[b]) >= gen_len:
                done[slot_req[b]] = slot_out[b]
                finished[b] = True
                slot_req[b] = -1
        if any(finished):
            cache = reset_slots(cache, torch.tensor(finished, device=device))

    dt = time.time() - t0
    total = sum(len(v) for v in done.values())
    naive = sum(len(q) + gen_len for q in queue)
    return dict(done=done, steps=steps, seconds=dt, tokens_per_s=total / dt,
                naive_steps=naive, utilization=naive / steps,
                logits=logged if record else None)


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-prompt", type=int, default=12)
    ap.add_argument("--gen-len", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(1),
                        device)

    # request queue: random-length prompts
    queue = make_queue(cfg.vocab, args.requests, args.max_prompt)
    res = serve_stream(model, params, queue, args.slots, args.gen_len,
                       device, cache_len=args.max_prompt + args.gen_len)

    done, steps = res["done"], res["steps"]
    log(f"served {args.requests} requests through {args.slots} slots in "
        f"{steps} decode steps ({res['seconds']:.1f}s, "
        f"{res['tokens_per_s']:.1f} gen tok/s)")
    log(f"continuous batching: {steps} steps vs {res['naive_steps']} "
        f"sequential steps (x{res['utilization']:.1f} utilization)")
    for rid in sorted(done)[:3]:
        log(f"request {rid}: {done[rid][:8]}...")
    return res


if __name__ == "__main__":
    main()
