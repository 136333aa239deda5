#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero before the
last line):

1. Card: ``nvidia-smi`` name and power limit, torch / CUDA versions; the
   kernels are compiled from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, in parallel); the flash kernels' registers and
   spills from ``-Xptxas -v`` (and the lru_scan, compress and robust_agg
   kernels').
2. Kernels against their plain PyTorch versions on the card: every prox
   of the table, exact and lagged exchanges, with and without the noise
   operand, ragged widths (N=3, M=1000 and M=1001), a participation row
   with zeros and a NaN row of ``w`` for an inactive agent, in float32
   and bfloat16; then the trainer's full shape ``(4, 745,549,056)`` in
   bfloat16, the plain versions run in column slabs.  Tolerance: 1e-6
   relative in float32, one bfloat16 ulp in bfloat16.  Each kernel is
   timed with CUDA events (median of 7) beside its plain version and its
   byte bound.
3. A small-input check: the reduced gemma2-2b in float32 runs two
   federated rounds on the card (kernels, the flash attention kernels
   included) and on the CPU (plain versions); the states agree to 1e-4.
4. Main path: gemma2-2b at published width cut to 2 layers, N=4 agents,
   global batch 8, seq 512, N_e=2, gd, gamma 0.05, weight decay 0.01,
   packed state, fused edges and fused update, 3 rounds through
   ``repro_torch.launch.train.run_fed``.  Launch counters are zeroed just
   before and read just after: uplink=3, downlink=3, fedplt_update=6,
   flash_attention_fwd=48, flash_attention_bwd=48.
   Then one more round under ``torch.profiler``: device time by kernel
   group and the device's idle share; then phase 22b's report on the same
   trainer.
5. DP path: one round with tau=0.01, clip=1.0 (the noise variant of the
   update kernel) and its privacy line.
6. Compressed main path: phase 4's spec with the topk z-uplink (ratio
   0.25), 3 rounds: uplink=3, downlink=3 (their lagged variants),
   fedplt_update=6, rank_select=3, int8_quantize=0; finite losses and a
   finite coordinator copy ``t``; one profiled round.  Then one round each
   of int8 (int8_quantize=1, rank_select=0) and adaptive_topk
   (rank_select=1).

7. Robust main path: phase 4's spec with ``--aggregator trimmed_mean
   --aggregator-param 1 --guard-increments``, 3 rounds with the ``(N, 2)``
   rows of a seeded one-agent sign-flip ``FaultPlan``: sort_aggregate=3,
   uplink=3, downlink=3 (lagged variants), fedplt_update=6; one profiled
   round.  Then, from that state, one round each of ``coord_median`` with
   ``live = [1, 1, 1, 0]`` (sort_aggregate=1), ``norm_clip_mean`` with the
   radius set to the median of the rows' residual norms ``||z_i -
   median(z)||`` (sort_aggregate=1, the centre) and ``mean`` with guards on
   and a NaN ``(N,)`` corrupt row, which the guard quarantines (that
   agent's x and z rows unchanged, sort_aggregate=0).  Round ms and peak
   memory of each variant.
8. Sharded rounds (``mesh_shape="1x1"``: a 1-rank NCCL process group in
   this process).  8a: ``round_uplink_partial`` and
   ``round_downlink_presummed`` bit-equal to their plain versions (NaN by
   position) for N_local 1..8, M = 1000 and 1001, fp32 and bf16, exact and
   lagged, damping 1 and 0.65, a NaN row of ``w`` for an inactive agent
   and a misaligned view; then at the full ``(4, 745,549,056)`` bf16
   shape, timed beside the byte bound, the plain versions and, for the
   partial sum, ``torch.sum(z, dim=0, keepdim=True)``.  8b: reduced
   gemma2-2b fp32, N = 4, 3 rounds (mean, topk 0.25, trimmed_mean f=1
   with a sign-flipped agent): the 1-rank mesh equals the unsharded card
   run bit for bit, with partial=3, presummed=3 and no unsharded edge
   launch.  8c: phase 4's spec under the mesh, 3 rounds:
   round_uplink_partial=3, round_downlink_presummed=3, fedplt_update=6;
   one profiled round; round times beside phase 4's; then the bf16 ``y``
   of the mesh against the unsharded uplink on the same ``z`` after round
   1 (at most 1 ulp: the partial sum is rounded to bf16 before ``/ N``).
   8d: one robust round (trimmed_mean f=1, guards, a sign flip) under the
   mesh: sort_aggregate=1, partial=1, presummed=1.  8e: two gloo ranks
   spawned on the one card, 2 agents each, against 8b's 1-rank run
   (rtol 1e-5, atol 1e-6); dropped with a note only if gloo refuses CUDA
   tensors (any other failure of a rank fails the smoke).

9. Flash attention (the attention of every layer of the trainer on the
   card, forward and backward; phases 3-8 count its launches: one
   forward and one backward per layer per agent per local epoch, 16 of
   each per round of the full-width trainer; bf16 runs the tensor-core
   kernels, fp32 the CUDA-core ones).  9a: both kernels against
   their plain versions (``kernels/flash_attention/ref.py``): fp32 and
   bf16, S = T in (1, 7, 64, 128, 1000), (H, Hkv) in ((8, 4), (8, 8),
   (8, 1)), D in (64, 128, 256), causal or not, window None / 3 / 100,
   cap None / 50; the edges of the bf16 tiles, (S, T) in (63, 63),
   (65, 65), (129, 129), (192, 192), (300, 40), (40, 300), (200, 129)
   with (H, Hkv) (8, 4) and the MQA head split (10, 1), D 64 and 256;
   rows with no visible key, the main path's own
   shape (B 2, S = T 512, H 8, Hkv 4, D 256, bf16, cap 50, causal with
   window None and 4096) and recurrentgemma-2b's local layer of phase
   10d (B 2, S = T 512, H 10, Hkv 1, D 256, bf16, no cap, causal with
   window None and 2048); the head shapes of phase 13's configs, fp32
   and bf16, S = T in (64, 129, 512), causal, no cap: (H, Hkv, D) (24,
   8, 128), (96, 8, 192), (8, 1, 192) -- D 192 padded to 256 by the
   launcher -- and (16, 8, 256) with window 1024; and their published
   layers at B 2, S = T 512, bf16 (phi4-mini-3.8b, gemma3-12b's local
   layer, nemotron-4-340b).  Tolerance: fp32 o and lse 1e-5 max(1, |ref|)
   elementwise, fp32 gradients 1e-4 max|ref|, bf16 one ulp of the plain
   result plus 1e-5 max|ref|; at S = T = 1 the exact dq and dk are 0
   (one key, p = 1), held to 1e-5 max|dv|.  9b: gemma2-2b's attention
   over 8192 tokens (B 1, H 8, Hkv 4, D 256, bf16, cap 50), the global
   (causal) and the local (window 4096) layer, forward and backward
   against the plain versions run head by head, timed beside the bound
   (every product at the bf16 tensor-core peak, the products with the
   float32 p or ds once per bf16 term), ``flex_attention`` under
   ``torch.compile`` (the same function: the softcap as its score_mod,
   the mask as its block mask; ``library_ms``), SDPA (``is_causal``, a
   yardstick: no softcap, no window) and the plain
   PyTorch path the kernel replaces (``attn_chunked`` /
   ``attn_block_local`` with autograd).  9c: the
   same forward and backward again, bit for bit.
10. The SSM (Mamba-1) and RG-LRU model kinds through the lru_scan
   kernels (the recurrence ``h_t = a_t h_{t-1} + b_t`` forward, its
   reverse scan backward).  10a: both kernels bit-equal to their plain
   versions (``kernels/lru_scan/ref.py``, NaN by position): B in (1, 2,
   3), S in (1, 7, 128, 129, 1000), W in (1, 5, 1000, 1001), fp32 and
   bf16, a drawn in (0, 1) with a = 0, 1, 1.5 and -0.7 at scattered
   entries, one NaN in a, a misaligned view and a 4-D (B, S, W, N) call
   through the op's autograd Function.  10b: float32 at the trainers'
   scans (Mamba: B 2, S 512, W 8192 x 16; RG-LRU: B 2, S 512, W 2560)
   and recurrentgemma's 8192-token context (B 1, W 2560), bit-equal and
   timed (CUDA events, median of 7) beside the byte bound and the plain
   versions; no PyTorch call computes the recurrence.  10c: reduced
   falcon-mamba-7b (2 layers) and recurrentgemma-2b (3 layers: rec,
   rec, local) in float32, 2 rounds in the tree layout on the card and
   on the CPU; the states agree to 1e-4.  10d: the full-width trainers,
   bf16 (a mixed tree: dt_bias, A_log, D and lam stay float32, so the
   state is the tree layout, the round edges run per leaf in PyTorch and
   the fused update once per leaf): recurrentgemma-2b cut to one pattern
   unit (912,309,760 parameters) and falcon-mamba-7b cut to 2 layers
   (476,966,912), N=4, global batch 8, seq 512, N_e=2, gd, gamma 0.05,
   weight decay 0.01, fused backend and update, 3 rounds each: lru_scan
   48 / 48 in both, flash 24 / 24 in recurrentgemma-2b, fedplt_update
   204 and 72 (one a leaf a local epoch), round edges 0; finite losses
   and states, peak memory under 80 GB; one profiled round each.

11. ``segment_ranks`` (the last TPU kernel: stable descending-|x| ranks
   within every column interval) and the paper's dense front end.  11a:
   the kernel bit-equal to its plain version (``kernels/compress/ref.py``
   ``segment_ranks_ref``): N in (1, 2, 3, 5, 100), M = 1000 and 1001,
   fp32 and bf16, no segments, one, and several with leading, interior
   and trailing gaps, tie-heavy, all-equal and all-zero rows, +-0.0,
   +-inf and NaN, a misaligned view; N = 5 over three chunks (both dtypes,
   two segments with gaps: randn with the edge values, a rounded row, an
   all-equal and a zero row, a run of ties across chunk edges), also as
   a misaligned view; and ``where(segment_ranks < k, x, 0)`` equal to
   the rank_select kernel's topk per segment, the multi-chunk rows
   included.  11b: the public op at the trainer's packed increment (4 x
   745,549,056 bf16, 18 segments), launch counted, bit-equal to the plain
   version run row by row, timed beside the byte bound (read x, write
   int32 ranks), the plain version and ``torch.argsort(stable)`` per
   (row, interval) as a yardstick, with one profiled call by stage
   (hist, bases, rank).  11c: the paper's problem (N 100, q 250, n 5,
   eps 0.5) through ``build_trainer(problem, FedSpec(rho=1,
   n_epochs=5))`` on the
   card and on the CPU: 200 rounds (the same hitting round, states 1e-5),
   50% participation with a given ``u`` over 400 rounds, FedAvg's drift
   plateau (1e-3 relative), ``||x_bar - x*|| < 1e-4`` against ``solve()``.
   11d: the dense kernel path (fused edges, packed state,
   ``use_fused_update`` -- which the dense solver never takes -- the fused
   compress backend, gamma given) on the paper's problem and Table 5's
   n = 100: topk 0.25, int8, adaptive_topk, trimmed_mean f=5 with guards
   and coord_median with an evicted agent, 20 rounds each: uplink,
   downlink and the compress or sort_aggregate kernel 20 launches each,
   fedplt_update 0; 5 rounds checked against the CPU round by round
   (1e-5); steady round ms and one profiled round.  11e: the private
   pipeline (Lemma 7's stabilizer, Prop. 4's noise calibration, noisy GD
   with ``dp_init``, the (eps, delta) report, Corollary 1's bound).

12. ``sort_aggregate`` above 128 agents and the model mesh axis.  12a:
   the kernel bit-equal to its plain version (NaN by position) on each
   route above 128 agents, both sides of every boundary: (N, M) in
   (129, 1000), (129, 1001), (200, 1000), (256, 1000), (257, 1001),
   (1000, 1001), (1024, 1000) on the warp route, (1025, 1001), (4096,
   64), (16384, 16) on the block route and (16385, 8), (40000, 8) on the
   global scratch route, fp32 and bf16, trims 0 / 1 / N/3 / max and
   coord_median, all live / evictions / one live / all dead, ties and
   special values, each call's route read from the C launcher's tallies;
   then timed at N 100 over 2^24 columns and N 1000 over 2^20, bf16 and
   fp32, trimmed_mean (f N/10) and coord_median, beside the byte bound,
   the network's operation bound, the plain version (in column slabs)
   and ``torch.sort(x, dim=0)``.  12b: reduced
   gemma2-2b fp32 (N 4, participation 0.75, 3 rounds; packed, fused
   backend and update) under ``mesh_shape`` 1x2 and 2x2 on 2 and 4 gloo
   ranks spawned on the one card, against the unsharded card run (rtol
   1e-5, atol 1e-6; topk and int8 with the near-tie allowance of
   ``tests/test_torch_rounds_sharded.py``): mean, topk, int8,
   trimmed_mean f=1 (guards, a sign flip, an eviction), norm_clip_mean
   (guards, a sign flip), noisy GD with clip 1; and the edges alone: on
   the same z, t, w, x, u the 1x2 ranks' blocks of y, v, x, z, the topk
   and int8 ``q`` and the trimmed mean equal the 1x1 mesh's columns bit
   for bit.  12c: the main path at full width (gemma2-2b, 2 layers, bf16,
   N 4, batch 8, seq 512, N_e 2, gd) under ``mesh_shape="1x2"`` on two
   gloo ranks on the card, one round: finite, equal losses on both ranks;
   per rank and round partial 1, presummed 1, fedplt_update 2, flash 16
   forward and 16 backward, unsharded edges 0; each rank's state block
   (4, 372,774,528) and peak memory; round seconds (gloo-staged), beside
   the dtypes gloo's all_reduce takes on CUDA tensors and the seconds of
   one all_reduce of 512 MB between the two ranks.  12d:
   the dense front end (the paper's problem and Table 5's n 100) under
   2x1, 1x2 and 2x2 meshes: Fed-PLT N_e 5 over 200 rounds and 50%
   participation (given rows) over 400 reach the unsharded card run's
   hitting round with a final criterion within a factor 10 (or both
   below 1e-8, the criterion's float32 floor);
   trimmed_mean f=5 with guards at N 100 (2x2) and N 200 (2x1), the
   kernel's warp route on the gathered agent column, 20 sort_aggregate
   launches each.  Only gloo's refusal of CUDA tensors drops 12b-12d, as
   it drops 8e.

13. The untied LM head, the vocab-chunked loss and the configs that bring
   them (no new kernel).  13a: the reduced phi4-mini-3.8b (chunked_loss
   128: 4 chunks of the 512-token vocab), gemma3-12b (6 layers: five
   local, one global) and nemotron-4-340b (untied head, head_dim 192,
   chunked_loss 128), float32, N 4, packed, fused backend and update, 2
   rounds and one topk 0.25 round on the card and on the CPU: launch
   counts, states within 1e-4 (phase 3's rule for the near-tie top-k
   swaps).  13b: phi4-mini-3.8b at published width cut to 2 layers
   (815,938,560 parameters: the tied embedding 614,596,608, 2 x
   100,669,440 and the final norm's 3,072), phase 4's spec, 3 rounds
   through ``run_fed``: uplink 3, downlink 3, fedplt_update 6, flash 48
   forward and 48 backward; finite losses and state; peak memory; one
   profiled round.  13c: 13b with ``chunked_loss`` 25,008 and phase 4's
   gemma2-2b with 32,000 (8 chunks each, asserted), the same counts;
   the first-round loss against the full-logit run's (1e-3 relative for
   phi4, 2^-8 for gemma2, whose full-logit path softcaps in bf16), round
   ms, peak memory and the profiled round's matmul and elementwise
   groups beside the full-logit run's.
14. The SSM block's fused output through the selective-scan kernels
   (``kernels/lru_scan/csrc/ssm_scan.cu``: ``a = exp(dt A)``, ``bx = dt u
   B``, ``h = a h + bx`` and ``y = <h, C> + D u`` inside the time loop,
   forward and backward; a lane group of G lanes a channel, K states a
   lane).  14a: the library's plan (G, K, block width, checkpoint span)
   against ``kernel.ssm_plan`` and ``ref.block_channels`` for every n;
   both kernels bit-equal to their plain versions
   (``kernels/lru_scan/ref.py`` ``ssm_scan_ref``, ``ssm_scan_bwd_ref``:
   y; ddt, du, dB, dC, dA, dD) at (B, S, d_in, n) in {1, 2} x {1, 7, 513}
   x {5, 100} x {4, 16}, u and scan dtype float32 and bfloat16; n 1, 5,
   17 and 32; every (G, K) instantiation at shapes with ragged channel
   and step tails and without, both u and scan dtypes; every backward
   run twice with the same bits; each check on the instantiation its n
   plans by the C launcher's tallies; the autograd Function; both
   kernels from a fresh thread.  14b: falcon-mamba-7b's scan (B 2, S
   512, d_in 8192, n 16, bf16 u), float32 and bfloat16 scan dtype,
   bit-equal and timed (CUDA events around a call, and around its
   kernels alone behind a sleep-held stream) beside the bound (bytes,
   float operations at the rate without FMA, one exponential a state
   entry at the MUFU rate) and the plain versions; no PyTorch call
   computes the function.  14c: reduced falcon-mamba-7b
   with ``ssm_fused_output`` in float32, 2 rounds in the tree layout,
   card (ssm_scan 16 / 16, lru_scan 0) against the CPU (the reference's
   associative path); 1e-4.  14d: falcon-mamba-7b at published width cut
   to 2 layers, phase 10d's spec with the fused output, 3 rounds each in
   three forms: float32 scan, float32 with ``ssm_inner="seq"`` (the same
   kernel on the card: its losses and counts must equal the first's) and
   bfloat16 scan: ssm_scan 48 / 48, lru_scan 0, fedplt_update 72; finite
   losses and states, peak under 80 GB; one profiled round each.  Then
   two probes: one full-width block's forward and backward (B 2, S 512,
   bf16) must add less peak memory than one (B, S, d_in, n) float32
   tensor (0.537 GB) with the fused output (the unfused number is
   printed); and one block's weights applied 64 times in a chain, the
   published depth, fused: the memory the forward keeps for the
   backward, a layer's share of it, and the peak of both.
15. Standard mode: gemma2-2b at published width cut to 2 layers, bf16,
   batch 8, seq 512, AdamW, 3 steps through ``run_standard``: finite
   losses and parameters, flash 6 / 6 launches (one a layer a step) and
   nothing else; steady step ms and peak memory.
16. Resume on the card: reduced gemma2-2b, N 4, packed, fused edges and
   update, 6 rounds against 3, a checkpoint, ``resume`` and 3 more
   (``run_fed`` with ``checkpoint_every=3``), in bf16 and fp32 (gd), fp32
   topk and bf16 noisy_gd (the CUDA generator's state crosses the
   checkpoint), and reduced qwen2-moe-a2.7b in fp32 (gd): x, z and t
   bit-equal, the two legs' launches equal and summing to the
   uninterrupted run's.  The mesh case: reduced gemma2-2b in bf16 on two
   gloo ranks spawned on the card, under 2x1 and 1x2, 4 rounds against 2
   + checkpoint + resume + 2 (``run_fed``, ``checkpoint_every=2``): each
   rank's x and z bit-equal, and the round-2 checkpoint (the gathered
   global state, written by rank 0) restored into the unsharded trainer
   equal to the ranks' blocks bit for bit.
17. Serving: phase 15's parameters through ``save_checkpoint`` /
   ``restore_checkpoint`` (bit-equal; seconds and GB/s), ``generate`` on
   them at batch 4, prompt 128, 32 new tokens (prefill ms, ms a token,
   tok/s; no kernel on the decode path), the prefill's last logits
   against the forward through the flash kernels (largest difference,
   argmax agreement); 17c reduced gemma2-2b, falcon-mamba-7b and
   recurrentgemma-2b in fp32 decoded token by token against their
   forward through the flash and lru_scan kernels, within 2e-2.
18. The MoE FFN (``models/moe.py``; no new kernel).  18a: the reduced
   qwen2-moe-a2.7b (swiglu, one shared expert) and grok-1-314b (geglu)
   MoE layers in fp32, flat and grouped routes, capacity factor 1.25 and
   0.5 (drops, counted), on the card against the port's CPU path: every
   contribution's expert, rank and slot equal; output, aux and gradients
   within 1e-5 relative.  18b: qwen2-moe-a2.7b at published width cut to
   one layer (881,719,296 parameters, 13 leaves), bf16 with the float32
   router (tree layout), phase 4's spec otherwise, 3 rounds: flash 8 / 8
   a round, fedplt_update once a leaf a local epoch (78), no edge kernel;
   peak memory; one profiled round, and one split by MoE part (router,
   dispatch, experts, combine, shared; forward and backward).  18c: two
   full-width rounds from one state, one batch and one generator state,
   equal bit for bit (and phase 16's MoE case).  18d: one-layer
   qwen2-moe-a2.7b through ``run_standard`` (AdamW, 2 steps, flash 1 / 1
   a step), served (``generate`` at batch 4, prompt 128, 32 new tokens),
   grok-1-314b cut to one layer (5,725,292,544 parameters, expert wi (1,
   8, 6144, 65536)) served the same way, and reduced qwen2-moe / grok-1
   decoded against their forward at capacity factor 8 (2e-2).
19. The encoder-decoder and the vision prefix (no new kernel; the flash
   kernels at new shapes).  19a: reduced whisper-small (2 encoder layers
   over 24 frames, 2 decoder layers with cross-attention) and reduced
   internvl2-26b (16 patch embeddings before the text) in fp32, N 2,
   packed, fused, 2 rounds on the card (flash once an attention call per
   agent per epoch) against the CPU (1e-4); the flash forward and
   backward against their plain versions at 9a's bf16 tolerances at
   whisper-small's encoder (B 2, S = T 1500, H 12, D 64, no mask),
   decoder self-attention (448, causal) and cross-attention (S 448, T
   1500, no mask), and internvl2-26b's layer (512 causal, H 48, Hkv 8, D
   128); the whisper shapes timed beside the bound (4 D operations a
   visible pair forward, 10 D backward, at the bf16 peak), the plain
   versions, SDPA (the same function: whisper has no cap) and
   ``flex_attention`` compiled.  19b: whisper-small at published width
   and depth (12 + 12 layers, 238,060,032 parameters, bf16, packed), N
   4, batch 8 (2 an agent) x 448 text tokens with 1500 encoder frames,
   N_e 2, 3 rounds through ``run_fed``: flash 864 / 864 (36 calls an
   agent's forward), uplink 3, downlink 3, fedplt_update 6, nothing
   else; peak memory; one profiled round.  19c: internvl2-26b cut to one
   layer of 48 (958,734,336 parameters, packed; 256 patch embeddings and
   256 text tokens), 3 rounds: flash 24 / 24.  19d: reduced whisper
   decoded against its forward after the encoder and
   ``fill_cross_cache`` (2e-2); whisper-small at published width served
   at batch 4 (the encoder, the cross cache, a 128-token prompt through
   ``decode_step``, 32 greedy tokens: ms a token), its prefill's last
   logits against the forward's.
20. Bounded-staleness async rounds and the host broker (no new kernel:
   the async round runs the synchronous round's kernels).  20a: reduced
   gemma2-2b fp32, N 4, packed, fused, K 2, five given arrival rows (a
   round nobody arrives in, stale arrivals, rows the bound must add
   agents to) on the card and on the CPU: the realised rows and the
   staleness counters equal (and the host's replay of the bound), x, z
   and y_tag within 1e-4; K = 0 async rounds equal the synchronous ones
   bit for bit on the card over 3 rounds with generator draws
   (participation 0.5).  20b: phase 4's trainer (gemma2-2b, 2 layers,
   packed bf16, fused) with K 2: ``IncrementBroker`` drives 6 rounds,
   agent 0 a straggler (20 ms against 2 ms, 3 ms of grace), then
   ``replay`` of its schedule from the same init: x, z, y_tag and the
   counters equal bit for bit, the schedule holds a stale arrival, each
   run launches what 6 synchronous rounds launch (uplink 6, downlink 6,
   fedplt_update 12, flash 96 / 96); round ms, peak memory and one
   profiled round.  20c: the same width with the topk 0.25 exchange,
   participation 0.5, 3 rounds: phase 6's topk counts, finite losses.
   20d: reduced gemma2-2b fp32, K 2, participation 0.5: 4 rounds equal 2
   + checkpoint + resume + 2 bit for bit (x, z, y_tag, counters and the
   checkpoint's arrival rows).  20e: the paper's dense cell (N 100, q
   250, n 5, K 3, participation 0.4, noisy GD with given noise) 100
   rounds: ``run_recorded`` then ``replay`` bit for bit on the card, the
   CPU's replay of the card's schedule within 1e-5, and the effective
   per-agent privacy report of the schedule equal on both.
21. Heterogeneous agent groups (no new kernel: the groups drive the
   existing kernels).  21a: reduced gemma2-2b fp32, N 4, fused,
   groups ``2*gd,2*agd:n_epochs=1:gamma=0.02``: 2 rounds card vs CPU
   (1e-4) packed, then async K 2 on given arrival rows (the counters
   equal), then the tree layout.  21b: gemma2-2b at published width cut
   to 2 layers (745,549,056 parameters, bf16), N 4, batch 8, seq 512,
   packed, fused backend and update, the same groups, 3 rounds through
   ``run_fed``: per round fedplt_update 2 (the gd group's 2 epochs on its
   row slice; agd never fuses), flash 12 / 12 (2 layers x 6
   agent-epochs), uplink 1, downlink 1; finite losses, peak under 64 GB;
   round ms and a profiled round's kernel groups beside phase 4's.  21c:
   as 21b with ``3*gd:participation=0.5,1*agd:n_epochs=1``: the rows the
   participation draw gives (per-agent rates) are the rows
   ``round_downlink`` takes, the agd agent (rate 1) arrives every round;
   launches fedplt_update 2, flash 14 / 14 a round.  21d: reduced
   gemma2-2b bf16, N 4, packed, fused, the 21a groups on two gloo ranks
   on the card under 2x1 (one group a rank: fedplt_update 2 / 0, flash
   8 / 4, one partial and one presummed launch a rank a round) against
   the unsharded grouped card run: round 1 bit for bit (identical rows in,
   an exact agent mean), round 2 within 2^-5 of the largest entry (the
   ranks' bf16 partial sums); ``1*gd,3*agd`` refused by the spec and the
   engine on both ranks.  21e: the paper's cell (N 100, q 250, n 5) with
   ``50*gd,50*agd``, 200 rounds: the same hitting round of 1e-5 on the
   card and the CPU, states 1e-5; DP groups ``50*gd,50*gd:n_epochs=2``
   (tau 0.05, given noise), 100 rounds: states 1e-5 and the per-agent
   privacy tables equal.
22. The analysis tools (no new kernel: ``repro_torch.launch.dryrun``,
   ``roofline`` and ``profile_analysis``).  22a: the dry run over every
   architecture x shape x mesh (1x1, 1x2, 2x1) on the meta device, one
   line a case, no case FAILED; one round each of falcon-mamba-7b (2
   layers) and qwen2-moe-a2.7b (1 layer), tree layout, phase 4's spec,
   under ``torch.cuda.memory._record_memory_history``: the measured peak
   (``max_memory_allocated``), the 5 largest buffers live at the traced
   peak by their allocation site in the port, and the dry run's resident
   ``x + z`` and inputs under that peak; then, at N 4, how many layers of
   gemma3-12b, nemotron-4-340b, qwen2-moe-a2.7b and internvl2-26b the dry
   run puts under 80 GB by resident bytes and by resident bytes scaled by
   gemma2-2b's measured peak-to-state ratio (phase 4's peak over its
   resident x + z).  22b (on phase 4's trainer, after its profiled
   round): one steady round counted by ``profile_analysis.count`` --
   FLOPs (aten ops through ``FlopCounterMode`` and the kernels' own
   counts), HBM bytes, launches, which must equal
   ``kernels.launch_counts()`` (flash 16 / 16, fedplt_update 2, uplink 1,
   downlink 1) -- the H100 roofline of the counts (compute, memory,
   collective and the bottleneck), ``useful_ratio``, and the MFU of the
   model FLOPs (6 N D times N_e) over the median wall time of 3 uncounted
   rounds; the top kernels by least time.  22c: falcon-mamba-7b at
   published width, 2 layers, bf16, tree layout, N 4, one round under
   ``mesh_shape="1x2"`` on two gloo ranks spawned on the card (each leaf's
   tensor-parallel block, lru_scan 16 / 16 and fedplt_update 24 a rank)
   against the 1x1 round in this process: every gathered leaf's increment
   over the round (``x - x0``, ``z - x0``) within ``TREE_INC`` of the 1x1
   run's in norm, the losses within ``TREE_LOSS`` relative, a replicated
   leaf equal on both ranks; each rank's state bytes, seconds and peak
   beside the 1x1 run's; then reduced qwen2-moe-a2.7b (float32, its 4
   experts on the model axis) the same way.
23. The examples' torch twins (``examples/*_torch.py``; no new kernel),
   gemma3-12b at published width and the grouped MoE route at width.  23a:
   the dense twins at their own sizes on the card, each beside the same
   twin's run on the CPU in this process (draws made on a CPU
   generator): quickstart (N 100, n 5, q 250; 200 / 400 / 400 rounds; x*
   solved once on the card) with equal hitting rounds and ``||x_bar -
   x*||`` within 1e-5; private (300 rounds of noisy GD with ``dp_init``)
   with tau and eps equal and states within 1e-5; compressed (n 20, 600
   rounds, six rows) with each row's hitting round equal and
   ``rank_select`` launched 600 times in ``adaptive/fused`` and never in
   the others (the tallies); async (40 broker rounds) replayed bit for
   bit on the card.  23b: ``train_lm_federated_torch`` at its ~100M
   float32 config, 20 rounds (300 under ``--examples``): finite losses,
   the last below the first, flash fp32 launches 4 agents x 3 epochs x 8
   layers a round; round ms and peak GB.  23c: ``serve_stream`` of
   ``continuous_batching_torch`` at published width (gemma2-2b cut to 2
   layers, recurrentgemma-2b to one pattern unit; bf16 and float32), 4
   slots, 12 requests of 3-12 prompt tokens, 10 generated: every slot's
   logits at every step against the request decoded alone (its tokens
   equal to ``generate``'s), the largest difference over the largest
   |logit| under ``BATCH_LIMIT``, tokens equal wherever the alone run's
   top-2 margin exceeds it; steps, tokens/s and the utilisation figure.
   23d: gemma3-12b (d 3840, 16 / 8 heads, head_dim 256, d_ff 15,360, vocab
   262,144) cut to 2 layers (1,454,918,400 parameters, both layers local:
   window 1024 > seq 512), phase 4's spec, 3 rounds: uplink 3, downlink 3,
   fedplt_update 6, flash 48 / 48; peak under 80 GB; a profiled round
   beside phase 4's.  23e: qwen2-moe-a2.7b at 18b's cut and spec with
   ``moe_grouped=True``, one round: flash 8 / 8, fedplt_update 26, a
   finite loss; each route's dropped contributions on one agent's batch.

Phase 2 also holds the compress kernels against their plain versions,
bit for bit (masks and int8 codes are discrete): topk, adaptive_topk and
int8, fp32 and bf16, N=3, M=1000 and 1001, one segment and several with
gap columns, ratios 0.01/0.25/1.0, energies 0.5/0.95/1.0, tie-heavy,
all-equal and all-zero rows, a misaligned view (the scalar path), and N=5
over three chunks with a rounded, an all-equal and a zero row and a tie
run across chunk edges that holds the topk cut; then at the full
``(4, 745,549,056)`` bf16 shape with the trainer's 18 packed segments,
the plain versions run row by row, timed beside the byte bound and, for
topk, ``torch.topk`` per (row, segment) as a yardstick (its tie order
differs), rank_select with one profiled call by stage (hist, bin sums,
select, ties, write).  And the robust-aggregation kernel, bit for bit (NaN
results by position), each call on the route its N takes (the register
route up to 32 agents, the warp route above; the C launcher's tallies):
N in {1, 2, 3, 4, 5, 8, 17, 32, 33, 64, 65, 100, 128}, M = 1000 (16-byte
vectors) and 1001 (scalar), fp32 and bf16, every trim and coord_median,
live rows all live, with evictions, with one live agent and all dead,
columns of ties, +-0.0, +-inf and NaN, and a misaligned view at N 4 and
100;
then at the full ``(4, 745,549,056)`` bf16 shape (trimmed_mean f=1, the
robust main path's statistic) against its plain version run in column
slabs, timed beside the byte bound and, as a yardstick of the sort alone,
``torch.sort(x, dim=0)``.  Phase 3 also runs 2 compressed (topk) rounds
and 2 robust rounds (N=4, trimmed_mean f=1, one sign-flipped agent).

Then the seconds of each phase, one JSON line per kernel table, and the
last line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sort-aggregate-times [--src DIR]`` builds only
``robust_agg.cu`` of the ``repro_torch`` under ``DIR`` (default this
checkout's ``src``) and prints phase 12a's timed calls without the plain
version, as one JSON line: run once for each of two trees, in turns, to
compare them on one card.  ``--ssm-scan`` runs phases 14a and 14b alone;
``--ssm-times [--src DIR]`` times the selective-scan kernels of the
``repro_torch`` under ``DIR`` at 14b's shape (CUDA events and device
time) and runs the 64-layer memory probe, as one JSON line; and
``--ssm-rounds [--src DIR]`` runs phases 14c and 14d alone with the
``repro_torch`` under ``DIR``: each run once a tree, in turns, to
compare two trees on one card.  ``--train-serve`` runs phases 15-17
alone, ``--moe`` phase 18 (with phase 16's MoE case), ``--encdec`` phase
19 (with phase 16's mesh case), ``--async`` phase 20, ``--groups`` phase
21 (after one profiled round of phase 4, which 21b is shown beside),
``--analysis`` phase 22 (after one profiled round of phase 4, whose
trainer 22b reports on) and ``--examples`` phase 23 (23b at 300
rounds).  Under ``--src`` the peaks, bounds and
profile grouping stay this checkout's (:func:`use_tree`).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_N, FULL_M = 4, 745_549_056
N_EPOCHS, N_LAYERS = 2, 2           # the full-width trainer's N_e and depth
SLAB = 1 << 26                      # columns per slab of the plain versions


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def short_kernel_name(mangled: str) -> str:
    """A mangled kernel name without its anonymous namespace, cut to 72
    characters (the template arguments stay: they tell instances apart)."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", mangled)[:72]


SHARED_TOOLS = ("repro_torch.kernels.costs", "repro_torch.launch.roofline",
                "repro_torch.launch.profile_analysis")


def use_tree(src: str):
    """``--src DIR``: take every ``repro_torch`` module from ``DIR`` except
    :data:`SHARED_TOOLS` (the peaks, bounds, counts and profile grouping),
    which stay this checkout's: so two trees are timed against one formula,
    and a tree from before those modules existed can be timed too."""
    import importlib

    for name in SHARED_TOOLS:
        importlib.import_module(name)
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"
                 and m not in SHARED_TOOLS]:
        del sys.modules[name]
    sys.path.insert(0, src)


def card_bandwidth(name: str) -> float:
    """Data-sheet memory rate (bytes/s) of the named card
    (:func:`repro_torch.launch.roofline.card_bandwidth`; fails for a card
    it does not know)."""
    from repro_torch.launch import roofline

    try:
        return roofline.card_bandwidth(name)
    except ValueError as e:
        fail(str(e))


def cuda_ms(torch, fn, reps=7):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps=7, lead_cycles=2_000_000):
    """Median of ``reps`` device times of one call of ``fn`` after one
    warm-up: a sleep kernel (``lead_cycles`` clocks, ~1 ms) holds the
    stream while the host enqueues the call between two CUDA events, so
    the events time its kernels alone, without the host launch path that
    :func:`cuda_ms` counts (the path must take less than the sleep)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(lead_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(torch, got, want, what):
    """Max abs error of ``got`` vs ``want``; fails beyond the tolerance
    (1e-6 relative for float32, one ulp for bfloat16; NaN must match).
    Wide buffers are compared slab by slab to bound the float32 copies."""
    if got.ndim == 2 and got.shape[1] > SLAB:
        return max(compare(torch, got[:, c:c + SLAB], want[:, c:c + SLAB],
                           what) for c in range(0, got.shape[1], SLAB))
    a, b = got.float(), want.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    if got.dtype == torch.bfloat16:
        mag = b.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        tol = 1e-6 * b.abs()
    bad = ~(diff <= tol) & ~both_nan
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} elements beyond tolerance, "
             f"max abs err {float(diff.nan_to_num(float('inf')).max())}")
    return float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def small_checks(torch):
    from repro_torch.core.prox import make_prox
    from repro_torch.kernels.fedplt_update import ops as update_ops
    from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.kernels.round_edge import ref as edge_ref

    proxes = [None, make_prox("zero"), make_prox("l1"), make_prox("l2sq"),
              make_prox("weight_decay", weight=0.3),
              make_prox("elastic_net", l1=0.5, l2=2.0),
              make_prox("box", lo=-0.2, hi=0.3),
              make_prox("linf_ball", radius=0.25)]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_checks, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m in (1000, 1001):
            x, w, z, t, g = (torch.randn((3, m), generator=gen, device=dev
                                         ).to(dtype) for _ in range(5))
            w[1] = float("nan")
            u = torch.tensor([1.0, 0.0, 1.0], device=dev)
            for prox in proxes:
                for tt in (None, t):
                    tag = f"{dtype} m={m} prox={getattr(prox, '__name__', prox)} lagged={tt is not None}"
                    got = edge_ops.round_uplink(z, tt, prox=prox, rho_eff=0.7)
                    want = edge_ref.round_uplink_ref(z, tt, prox, 0.7)
                    for a, b in zip(got, want):
                        worst = max(worst, compare(torch, a, b, "uplink " + tag))
                    got = edge_ops.round_downlink(x, w, z, u, tt, prox=prox,
                                                  rho_eff=0.7, damping=0.5)
                    want = edge_ref.round_downlink_ref(x, w, z, u, tt, prox,
                                                       0.7, 0.5)
                    for a, b in zip(got, want):
                        worst = max(worst, compare(torch, a, b, "downlink " + tag))
                    if not (torch.equal(got[0][1], x[1])
                            and torch.equal(got[1][1], z[1])):
                        fail(f"downlink {tag}: inactive agent's state changed")
                    n_checks += 2
            for tt in (None, t):
                got = update_ops.fedplt_update(z, g, x, tt, gamma=0.05,
                                               inv_rho=0.8)
                want = fedplt_update_ref(z, g, x, tt, gamma=0.05, inv_rho=0.8)
                worst = max(worst, compare(torch, got, want,
                                           f"fedplt_update {dtype} m={m}"))
                inplace = z.clone()
                update_ops.fedplt_update(inplace, g, x, tt, gamma=0.05,
                                         inv_rho=0.8, out=inplace)
                worst = max(worst, compare(torch, inplace, want,
                                           f"fedplt_update in place {dtype}"))
                n_checks += 2
    torch.cuda.synchronize()
    log(f"phase 2: {n_checks} small-shape kernel checks passed "
        f"(fp32 and bf16, N=3, M=1000 and 1001, prox table, exact/lagged, "
        f"t present/absent, NaN inactive row); max abs err {worst}")


def slabbed(fn, outs, *ins):
    """Run the plain version ``fn`` over column slabs, writing ``outs``."""
    m = ins[0].shape[-1]
    for c0 in range(0, m, SLAB):
        res = fn(*[None if a is None else a[..., c0:c0 + SLAB] for a in ins])
        res = res if isinstance(res, tuple) else (res,)
        for o, r in zip(outs, res):
            o[..., c0:c0 + SLAB] = r


def full_shape(torch, bw):
    """Every kernel at the trainer's full shape, against its slabbed plain
    version; returns ``{name: record}`` (and prints one line each)."""
    from repro_torch.kernels import costs
    from repro_torch.launch.roofline import bound as kernel_bound
    from repro_torch.core.prox import make_prox
    from repro_torch.kernels.fedplt_update import ops as update_ops
    from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.kernels.round_edge import ref as edge_ref

    N, M, s = FULL_N, FULL_M, 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    prox, rho = make_prox("weight_decay", weight=0.01), 0.25

    def buf():
        return torch.randn((N, M), generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def record(name, bytes_, flops, ms, plain_ms, err):
        bd = kernel_bound(bw, bytes_, flops)
        bound = bd["bound_ms"]
        rec = dict(bytes=bytes_, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bd["bound_by"], max_abs_err=err)
        log(f"phase 2 full shape: {name} ({N}x{M} bf16) max_abs_err={err} "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({bytes_ / 1e9:.2f} GB), "
            f"{100 * bound / ms:.1f}% of bound")
        return rec

    recs = {}
    for lagged in (False, True):
        z = buf()
        t = buf() if lagged else None
        y, v = edge_ops.round_uplink(z, t, prox=prox, rho_eff=rho)
        py, pv = torch.empty_like(y), torch.empty_like(v)
        plain = lambda: slabbed(lambda *a: edge_ref.round_uplink_ref(
            *a, prox, rho), (py, pv), z, t)
        plain()
        err = max(compare(torch, y, py, "uplink full"),
                  compare(torch, v, pv, "uplink full"))
        ms = cuda_ms(torch, lambda: edge_ops.round_uplink(z, t, prox=prox,
                                                          rho_eff=rho))
        pms = cuda_ms(torch, plain, reps=5)
        name = "round_uplink" + ("[lagged]" if lagged else "")
        flops, nbytes = costs.round_uplink(N, M, s, lagged)
        recs[name] = record(name, nbytes, flops, ms, pms, err)
        del z, t, y, v, py, pv
        torch.cuda.empty_cache()

    for lagged in (False, True):
        x, w, z = buf(), buf(), buf()
        t = buf() if lagged else None
        u = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
        xo, zo = edge_ops.round_downlink(x, w, z, u, t, prox=prox,
                                         rho_eff=rho, damping=1.0)
        px, pz = torch.empty_like(xo), torch.empty_like(zo)
        plain = lambda: slabbed(lambda x_, w_, z_, t_: edge_ref.round_downlink_ref(
            x_, w_, z_, u, t_, prox, rho, 1.0), (px, pz), x, w, z, t)
        plain()
        err = max(compare(torch, xo, px, "downlink full"),
                  compare(torch, zo, pz, "downlink full"))
        del xo, zo
        ms = cuda_ms(torch, lambda: edge_ops.round_downlink(
            x, w, z, u, t, prox=prox, rho_eff=rho, damping=1.0))
        pms = cuda_ms(torch, plain, reps=5)
        name = "round_downlink" + ("[lagged]" if lagged else "")
        flops, nbytes = costs.round_downlink(N, M, s, lagged)
        recs[name] = record(name, nbytes, flops, ms, pms, err)
        del x, w, z, t, px, pz
        torch.cuda.empty_cache()

    for noise in (False, True):
        w, g, v = buf(), buf(), buf()
        t = buf() if noise else None
        out = update_ops.fedplt_update(w, g, v, t, gamma=0.05, inv_rho=1.0)
        pout = torch.empty_like(out)
        plain = lambda: slabbed(lambda *a: fedplt_update_ref(
            *a, gamma=0.05, inv_rho=1.0), (pout,), w, g, v, t)
        plain()
        err = compare(torch, out, pout, "fedplt_update full")
        ms = cuda_ms(torch, lambda: update_ops.fedplt_update(
            w, g, v, t, gamma=0.05, inv_rho=1.0, out=out))
        pms = cuda_ms(torch, plain, reps=5)
        name = "fedplt_update" + ("[noise]" if noise else "")
        flops, nbytes = costs.fedplt_update(N * M, s, noise)
        recs[name] = record(name, nbytes, flops, ms, pms, err)
        del w, g, v, t, out, pout
        torch.cuda.empty_cache()
    return recs


def multi_chunk_input(torch, dtype, gen):
    """``(x, segments)``: 5 rows over three float32 compress chunks (and
    six bf16 key-histogram chunks), two segments with gaps before,
    between and after them.  Rows: randn with +-0.0, +-inf and NaN;
    randn rounded to integers (long tie runs); all equal; all zero; and
    small values with a run of 2.0 over 45% of each segment across chunk
    edges, so the topk cut (25%) falls inside a tie run that straddles
    chunks."""
    from repro_torch.kernels.compress import kernel as ckernel

    dev = torch.device("cuda")
    m = 3 * ckernel.CHUNK + 1001
    segs = ((5, m // 2), (m // 2 + 7, m - 3))
    x = torch.randn((5, m), generator=gen, device=dev)
    specials = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0,
                             -1.0], device=dev)
    x[0, ::100_003] = specials[torch.arange(x[0, ::100_003].numel(),
                                            device=dev) % 7]
    x[1] = (x[1] * 3).round()
    x[2] = -0.75
    x[3] = 0.0
    x[4] *= 0.1
    for s0, s1 in segs:
        a = s0 + (s1 - s0) // 8
        x[4, a:a + 45 * (s1 - s0) // 100] = 2.0
    return x.to(dtype), segs


def compress_small_checks(torch):
    """The compress kernels against their plain versions, bit for bit."""
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    settings = ([("topk", r, 0.95) for r in (0.01, 0.25, 1.0)]
                + [("adaptive_topk", r, e) for r in (0.01, 0.25)
                   for e in (0.5, 0.95, 1.0)])
    n_checks = 0

    def check(x, segs, tag, int8=True, settings=settings):
        """rank_select copies the kept entries' bits, NaN and -0.0 alike,
        and int8's zero codes are +0.0: both are compared bit for bit."""
        nonlocal n_checks
        full = cops.check_segments(segs or ((0, x.shape[1]),), x.shape[1])
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        for mode, ratio, energy in settings:
            got = cops.rank_select(x, segments=segs, mode=mode, ratio=ratio,
                                   energy=energy).view(bits[x.dtype])
            want = cref.rank_select_ref(x, full, mode, ratio,
                                        energy).view(bits[x.dtype])
            if not torch.equal(got, want):
                fail(f"rank_select {mode} ratio={ratio} energy={energy} "
                     f"{tag}: {int((got != want).sum())} entries differ")
            n_checks += 1
        if int8:
            got = cops.int8_quantize(x, segments=segs).view(bits[x.dtype])
            want = cref.int8_ref(x, full).view(bits[x.dtype])
            if not torch.equal(got, want):
                fail(f"int8_quantize {tag}: {int((got != want).sum())} "
                     f"entries differ from the plain version")
            n_checks += 1

    for dtype in (torch.float32, torch.bfloat16):
        for m in (1000, 1001):
            x = torch.randn((3, m), generator=gen, device=dev).to(dtype)
            ties = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0], device=dev)[
                torch.randint(0, 5, (3, m), generator=gen, device=dev)]
            ties = ties.to(dtype)
            ties[1] = 0.5                 # all equal
            ties[2] = 0.0                 # all zero
            for segs in (None, ((0, 300), (310, 700), (700, m - 5))):
                check(x, segs, f"{dtype} m={m} randn segs={segs}")
                check(ties, segs, f"{dtype} m={m} ties segs={segs}")
            wide = torch.randn((4, m), generator=gen, device=dev).to(dtype)
            check(wide[1:], None, f"{dtype} m={m} misaligned view")
        # inf and NaN: no int8.  No energy 1.0: over millions of entries
        # the last prefix sums reach the total within float64 rounding,
        # where the kernels' order of summation may pick another k_i than
        # the plain cumsum (kernels/compress/ref.py)
        x, segs = multi_chunk_input(torch, dtype, gen)
        check(x, segs, f"{dtype} multi-chunk M={x.shape[1]}", int8=False,
              settings=[t for t in settings if t[2] < 1.0])
    x, segs = int8_patterns_row(torch, gen)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    for view, tag in ((x, "aligned"), (shifted, "misaligned view")):
        got = cops.int8_quantize(view, segments=segs)
        same_bits(torch, got, cref.int8_ref(view, segs),
                  f"int8_quantize every finite bf16 pattern, {tag}")
        n_checks += 1
    torch.cuda.synchronize()
    log(f"phase 2: {n_checks} small-shape compress checks bit-equal (topk, "
        f"adaptive_topk, int8; fp32 and bf16; N=3, M=1000 and 1001; one and "
        f"several segments with gaps; ties, all-equal, all-zero rows; a "
        f"misaligned view; N=5 over three chunks: rounded, all-equal "
        f"and zero rows, a tie run across chunk edges holding the topk cut; "
        f"and int8 on a bf16 row of every finite pattern under the maxima "
        f"{list(INT8_MAXIMA)}, aligned and as a misaligned view, +-0.0 by "
        f"bits)")


# int8's all-patterns row: one segment per maximum (Queue C's float32 amax
# 1218.9414 rounds to 1216 in bf16; 1e-11 floors the scale at 1e-12; at
# 0.171875 the maximum's own quotient rounds to 128: -0.171875 saturates)
INT8_MAXIMA = {"1.0": 1.0, "1218.9414": 1218.9414, "1e-11": 1e-11,
               "largest finite": 3.3895313892515355e38, "all zero": 0.0,
               "0.171875": 0.171875}


def int8_patterns_row(torch, gen):
    """``(x, segments)``: one bf16 row with a segment per maximum M of
    :data:`INT8_MAXIMA`, holding every finite bf16 pattern of magnitude at
    most bf16(M) (M 0: +0.0 and -0.0) in a seeded order, and one gap
    column after each segment."""
    dev = torch.device("cuda")
    every = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16)
    finite = every[torch.isfinite(every)]
    parts, segs, col = [], [], 0
    for m in INT8_MAXIMA.values():
        top = torch.tensor(m, dtype=torch.bfloat16, device=dev)
        seg = finite[finite.abs() <= top]
        seg = seg[torch.randperm(seg.numel(), generator=gen, device=dev)]
        parts += [seg, torch.ones(1, dtype=torch.bfloat16, device=dev)]
        segs.append((col, col + seg.numel()))
        col += seg.numel() + 1
    return torch.cat(parts)[None], tuple(segs)


def compress_full_shape(torch, bw):
    """Both compress kernels at the trainer's full shape and packed
    segments against their plain versions run row by row; returns
    ``{name: record}``."""
    from repro_torch.kernels import costs
    from repro_torch.launch.profile_analysis import (INT8_STAGES,
                                                     RANK_SELECT_STAGES)
    from repro_torch.configs import get_config
    from repro_torch.fed import runtime
    from repro_torch.fed.api import FedSpec
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    meta = runtime.packed_layout(build_model(cfg), FedSpec(
        n_agents=FULL_N, gamma=0.05, state_layout="packed"))
    segs, N, M = meta.segments, FULL_N, meta.width
    if M != FULL_M:
        fail(f"packed width {M}, want {FULL_M}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((N, M), generator=gen, device=dev, dtype=torch.bfloat16)
    bytes_ = costs.compress_rows(N, M, 2)[1]     # read x, write q
    bound = bytes_ / bw * 1e3
    log(f"phase 2 full shape: {len(segs)} packed segments, largest "
        f"{max(b - a for a, b in segs):,} columns")

    def rows(fn, out):
        for i in range(N):
            out[i:i + 1] = fn(x[i:i + 1])

    def held(name, got, plain_fn):
        """Fails unless ``got`` equals the plain version bit for bit;
        returns the plain version's host-clock seconds."""
        want = torch.empty_like(got)
        t0 = time.time()
        rows(plain_fn, want)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        for i in range(N):
            g, w = got[i].view(torch.int16), want[i].view(torch.int16)
            if not torch.equal(g, w):
                fail(f"{name} full shape row {i}: "
                     f"{int((g != w).sum())} entries differ")
        return plain_s

    recs = {}
    cases = [("rank_select", dict(mode="topk", ratio=0.25), True),
             ("rank_select[adaptive]", dict(mode="adaptive_topk", ratio=0.25,
                                            energy=0.95), False),
             ("int8_quantize", None, True)]
    for name, kw, time_plain in cases:
        if kw is None:
            run = lambda: cops.int8_quantize(x, segments=segs)
            plain_fn = lambda r: cref.int8_ref(r, segs)
        else:
            run = lambda: cops.rank_select(x, segments=segs, **kw)
            plain_fn = lambda r: cref.rank_select_ref(
                r, segs, kw["mode"], kw["ratio"], kw.get("energy", 0.95))
        got = run()
        torch.cuda.synchronize()
        kept = int(got.count_nonzero())
        plain_once_s = held(name, got, plain_fn)
        del got
        torch.cuda.empty_cache()
        ms = cuda_ms(torch, run)
        stages = profile_stages(torch, run, INT8_STAGES if kw is None
                                else RANK_SELECT_STAGES)
        if time_plain:
            scratch = torch.empty_like(x)
            pms = cuda_ms(torch, lambda: rows(plain_fn, scratch), reps=3)
            del scratch
        else:
            pms = 1e3 * plain_once_s
        torch.cuda.empty_cache()
        lib_ms = None
        if name == "rank_select":
            def lib():
                for i in range(N):
                    for a, b in segs:
                        torch.topk(x[i, a:b].abs(), cref.seg_k(0.25, b - a),
                                   sorted=False)
            lib_ms = cuda_ms(torch, lib, reps=3)
        elif name == "int8_quantize":
            lib_ms = int8_yardstick(torch, x, segs)
        recs[name] = dict(bytes=bytes_, ms=ms, plain_ms=pms, bound_ms=bound,
                          bound_by="bytes", max_abs_err=0.0,  # bit-equal
                          library_ms=lib_ms, kept=kept)
        recs[name]["profiled_stages_ms"] = stages
        log(f"phase 2 full shape: {name} ({N}x{M} bf16) bit-equal to the "
            f"plain version; kept {kept:,} of {N * M:,}; kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms"
            + ("" if time_plain else " (one run)")
            + f", bound {bound:.3f} ms ({bytes_ / 1e9:.2f} GB), "
            f"{100 * bound / ms:.1f}% of bound"
            + ("" if lib_ms is None else
               f"; yardstick torch.topk per (row, segment) {lib_ms:.3f} ms "
               f"(tie order differs)" if kw is not None else
               f"; yardstick amax + torch.fake_quantize_per_channel_affine "
               f"per segment {lib_ms:.3f} ms (rounds x * (1/scale))")
            + f"; one profiled call by stage (ms): "
            f"{ {k: round(v, 3) for k, v in stages.items()} }")
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return recs


def int8_yardstick(torch, x, segs):
    """ms of int8's library yardstick on ``x``: per segment, the rows'
    ``amax`` and ``torch.fake_quantize_per_channel_affine`` (rows as
    channels, zero point 0, codes -128..127).  Another function's rounding:
    it rounds ``x * (1 / scale)`` where the port divides.  None, logged,
    where PyTorch refuses the bf16 buffer."""
    from repro_torch.kernels.compress.ref import INV_127

    zero = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)

    def lib():
        for a, b in segs:
            seg = x[:, a:b]
            scale = (seg.abs().amax(dim=1).float() * INV_127).clamp_min(1e-12)
            torch.fake_quantize_per_channel_affine(seg, scale, zero, 0, -128,
                                                   127)

    try:
        lib()
    except RuntimeError as e:
        log(f"phase 2: int8 yardstick refused ({str(e).splitlines()[0]}); "
            f"library_ms stays none")
        return None
    return cuda_ms(torch, lib, reps=3)


def same_bits(torch, got, want, what):
    """Fails unless ``got`` equals ``want`` bit for bit, NaN results
    compared by position only (a NaN's bits may differ between the kernel
    and PyTorch's float-to-bf16 conversion)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"{what}: NaN positions differ")
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    g = got.view(ints[got.dtype])
    w = want.view(ints[want.dtype])
    bad = (g != w) & ~nan
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} of {bad.numel()} entries differ")


# N of phase 2's checks: the register route (P <= 32) and the warp route's
# lane groups of 2 and 4 threads (P 64, 128), each boundary from both sides
ROBUST_NS = (1, 2, 3, 4, 5, 8, 17, 32, 33, 64, 65, 100, 128)


def robust_routes_run(torch, fn):
    """``(fn(), routes)``: the sort_aggregate routes ``fn`` launched, from
    the C launcher's own tallies of the launches that succeeded."""
    from repro_torch.kernels.robust_agg import kernel as rkernel

    before = rkernel.route_counts()
    out = fn()
    torch.cuda.synchronize()
    after = rkernel.route_counts()
    return out, {k for k in after if after[k] > before[k]}


def robust_checks(torch, gen, shapes, stats_of, lives_of, tag, views_of=None):
    """Each (N, M) of ``shapes`` in fp32 and bf16, seeded with ties and
    special values, through ``robust_aggregate`` bit-equal to the plain
    version (NaN by position), and on the route :func:`route_of` names
    (the launcher's tallies); returns the number of checks."""
    from repro_torch.kernels.robust_agg import kernel as rkernel
    from repro_torch.kernels.robust_agg import ops as rops
    from repro_torch.kernels.robust_agg.ref import robust_aggregate_ref

    dev = torch.device("cuda")
    specials = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0,
                             -1.0, 2.5], device=dev)
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n, m in shapes:
            x = torch.randn((n, m), generator=gen, device=dev)
            w = min(64, m // 2)
            idx = torch.randint(0, len(specials), (n, w), generator=gen,
                                device=dev)
            x[:, :w] = specials[idx]
            x[:, w:w + 8] = 0.75                   # whole tied columns
            x = x.to(dtype)
            views = views_of(x) if views_of else {"": x}
            route = rkernel.route_of(n)[0]
            for vname, xv in views.items():
                for lname, live in lives_of(n).items():
                    for stat, trim in stats_of(n):
                        got, ran = robust_routes_run(
                            torch, lambda: rops.robust_aggregate(
                                xv, live, stat=stat, trim=trim))
                        what = (f"{tag} sort_aggregate {dtype} N={n} M={m} "
                                f"{lname}{vname} {stat} trim={trim}")
                        if ran != {route}:
                            fail(f"{what}: ran the routes {sorted(ran)}, "
                                 f"not {route!r}")
                        want = robust_aggregate_ref(xv, live, stat=stat,
                                                    trim=trim)
                        same_bits(torch, got, want, what)
                        n_checks += 1
    torch.cuda.synchronize()
    return n_checks


def robust_small_checks(torch):
    """The sort_aggregate kernel against its plain version, bit for bit,
    at N <= 128 (the register route and the warp route's small groups)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def lives(n):
        out = {"all live": None}
        if n > 1:
            ev = torch.ones(n, device=dev)
            ev[::max(n // 3, 2)] = 0.0
            out["evictions"] = ev
            one = torch.zeros(n, device=dev)
            one[n // 2] = 1.0
            out["one live"] = one
        out["all dead"] = torch.zeros(n, device=dev)
        return out

    def views(x):
        out = {"": x}
        if x.shape[0] in (4, 100):
            n, m = x.shape
            flat = torch.empty(n * m + 1, device=dev, dtype=x.dtype)
            mis = flat[1:].view(n, m)
            mis.copy_(x)
            out[" misaligned view"] = mis
        return out

    n_checks = robust_checks(
        torch, gen, [(n, m) for m in (1000, 1001) for n in ROBUST_NS],
        lambda n: ([("trimmed_mean", f) for f in range((n - 1) // 2 + 1)]
                   + [("coord_median", 0)]), lives, "phase 2", views)
    log(f"phase 2: {n_checks} small-shape sort_aggregate checks bit-equal "
        f"(NaN by position) on the route each N takes (register up to 32 "
        f"agents, warp above; the launcher's tallies): N in {ROBUST_NS}, "
        f"M=1000 and 1001, fp32 and bf16, every trim and coord_median, all "
        f"live / evictions / one live / all dead, ties, +-0.0, +-inf, NaN, "
        f"a misaligned view at N 4 and 100")


def robust_full_shape(torch, bw):
    """sort_aggregate at the trainer's full shape against its slabbed
    plain version; returns ``{name: record}``."""
    from repro_torch.kernels import costs
    from repro_torch.launch.roofline import bound as kernel_bound
    from repro_torch.kernels.robust_agg import ops as rops
    from repro_torch.kernels.robust_agg.ref import robust_aggregate_ref

    N, M = FULL_N, FULL_M
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((N, M), generator=gen, device=dev, dtype=torch.bfloat16)
    live = torch.ones(N, device=dev)
    run = lambda: rops.robust_aggregate(x, live, stat="trimmed_mean", trim=1)
    got = run()
    want = torch.empty_like(got)
    plain = lambda: slabbed(lambda a: robust_aggregate_ref(
        a, live, stat="trimmed_mean", trim=1), (want,), x)
    plain()
    same_bits(torch, got, want, "sort_aggregate full shape")
    del got
    ms = cuda_ms(torch, run)
    pms = cuda_ms(torch, plain, reps=3)
    del want
    torch.cuda.empty_cache()
    sort_ms = cuda_ms(torch, lambda: torch.sort(x, dim=0), reps=3)
    # per column at N 4: 6 compare-exchanges (2 ops each) of the 4-key
    # bitonic network, 4 selects, 3 adds and a multiply
    ops, bytes_ = costs.sort_aggregate(N, M, 2, x.dtype)
    bd = kernel_bound(bw, bytes_, ops)
    bound = bd["bound_ms"]
    rec = dict(bytes=bytes_, ms=ms, plain_ms=pms, bound_ms=bound,
               bound_by=bd["bound_by"], max_abs_err=0.0,   # bit-equal
               library_ms=None, sort_yardstick_ms=sort_ms)
    log(f"phase 2 full shape: sort_aggregate trimmed_mean f=1 ({N}x{M} "
        f"bf16) bit-equal to the plain version; kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {bound:.3f} ms ({bytes_ / 1e9:.3f} GB), "
        f"{100 * bound / ms:.1f}% of bound; yardstick torch.sort(x, dim=0) "
        f"alone {sort_ms:.3f} ms (sorts only; no library call computes "
        f"the trimmed mean)")
    del x
    torch.cuda.empty_cache()
    return {"sort_aggregate": rec}


# ---------------------------------------------------------------------------
# Phases 3-6: the trainer
# ---------------------------------------------------------------------------

def card_vs_cpu(torch, states, what):
    """``(max abs err, flips)`` of the card's x, z (and t) against the
    CPU's; fails beyond 1e-4, or beyond 24 flips."""
    compressed = states["cpu"].t is not None
    err, flips = 0.0, 0
    for var in ("x", "z", "t") if compressed else ("x", "z"):
        d = (getattr(states["cuda"], var).cpu()
             - getattr(states["cpu"], var)).abs()
        if compressed:
            # a float32-rounding difference in z_new - t may swap two
            # near-equal magnitudes at the k-th position: a few entries
            # of t then differ by a whole transmitted value, and x and
            # z follow at those entries in the next round
            flips += int((d > 1e-4).sum())
            d = torch.where(d > 1e-4, torch.zeros_like(d), d)
        err = max(err, float(d.max()))
    if not err <= 1e-4 or flips > 24:
        fail(f"{what}: card vs CPU max abs err {err}, {flips} entries "
             f"beyond 1e-4")
    return err, flips


def small_input_parity(torch):
    """Two reduced-gemma2 rounds (float32) on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.configs.base import InputShape
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    base = dict(n_agents=2, n_epochs=2, gamma=0.05, weight_decay=0.01,
                state_layout="packed", engine_backend="fused",
                use_fused_update=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    shape = InputShape("small", 64, 4, "train")
    batches = [make_batch_for(cfg, shape, gen, n_agents=2) for _ in range(2)]
    for label, spec in (
            ("", api.FedSpec(**base)),
            (" compressed (topk 0.25)", api.FedSpec(
                **base, compression=api.CompressionSpec("topk", ratio=0.25)))):
        states = {}
        for dev in ("cuda", "cpu"):
            tr = api.build_trainer(model, spec, dev)
            st, _ = tr.init(0, params=params)
            for b in batches:
                st, _ = tr.step(st, b, u=torch.ones(2))
            states[dev] = st
        compressed = states["cpu"].t is not None
        err, flips = card_vs_cpu(torch, states, f"small-input check{label}")
        log(f"phase 3{label}: reduced gemma2-2b fp32, 2 rounds, card (kernels) "
            f"vs CPU (plain versions): max abs err {err:.3g} (tolerance 1e-4)"
            + (f" on x, z and t apart from {flips} entries (of "
               f"{3 * states['cpu'].x.numel():,}) that follow a near-tie "
               f"top-k swap" if compressed else ""))

    # the robust round: 4 agents, trimmed_mean f=1, one sign-flipped agent
    from repro_torch import kernels

    spec = api.FedSpec(**dict(base, n_agents=4), aggregator="trimmed_mean",
                       aggregator_param=1, guard_increments=True)
    batches = [make_batch_for(cfg, InputShape("small", 64, 8, "train"), gen,
                              n_agents=4) for _ in range(2)]
    flip = torch.tensor([[0.0, 0.0], [-1.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
    states = {}
    for dev in ("cuda", "cpu"):
        tr = api.build_trainer(model, spec, dev)
        st, _ = tr.init(0, params=params)
        kernels.reset_launch_counts()
        for b in batches:
            st, _ = tr.step(st, b, u=torch.ones(4), corrupt=flip)
        states[dev] = (st, kernels.launch_counts()["sort_aggregate"])
    err = max(float((getattr(states["cuda"][0], v).cpu()
                     - getattr(states["cpu"][0], v)).abs().max())
              for v in ("x", "z"))
    if not err <= 1e-4 or states["cuda"][1] != 2 or states["cpu"][1] != 0:
        fail(f"small-input check (robust): card vs CPU max abs err {err}, "
             f"sort_aggregate launches card {states['cuda'][1]} / CPU "
             f"{states['cpu'][1]} (want 2 / 0)")
    log(f"phase 3 robust (trimmed_mean f=1, guards on, one sign-flipped "
        f"agent of 4): reduced gemma2-2b fp32, 2 rounds, card (kernels, "
        f"2 sort_aggregate launches) vs CPU (plain versions): max abs err "
        f"{err:.3g} (tolerance 1e-4)")


def attention_calls(cfg, seq):
    """The flash calls of one agent's forward at ``seq`` tokens, as
    ``(S, T, causal)``: a self-attention layer over the sequence (a local
    layer sees what a causal one sees while ``seq`` is within its
    window); an encoder-decoder model's encoder over its frames, its
    decoder's self-attention and its cross-attention over the frames."""
    if cfg.n_enc_layers:
        T = cfg.n_enc_tokens
        return ([(T, T, False)] * cfg.n_enc_layers
                + [(seq, seq, True), (seq, T, False)] * cfg.n_layers)
    if seq > cfg.window and "local" in cfg.layer_kinds():
        fail(f"{cfg.name}: sequence {seq} > window {cfg.window}")
    return [(seq, seq, True) for k in cfg.layer_kinds()
            if k in ("global", "local")]


def profile_round(torch, trainer, state, gen, cfg, label, seq=None):
    """One more main-path round under torch.profiler: device time by
    kernel group, the top kernels, and the device's idle share of the
    round's wall time (one stream, so kernel times do not overlap)."""
    from repro_torch.launch.profile_analysis import kernel_group
    from repro_torch.launch.profile_analysis import profile as profile_groups
    from repro_torch.launch.roofline import (flash_bounds, lru_bounds,
                                             ssm_bounds)
    from repro_torch import kernels
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for

    seq = MAIN_SEQ if seq is None else seq
    shape = InputShape("profile", seq, MAIN_BATCH, "train")
    batch = make_batch_for(cfg, shape, gen, n_agents=FULL_N, device="cuda")

    def one_round():
        kernels.reset_launch_counts()     # the profiled (second) call's
        _, m = trainer.step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()

    events = {}
    wall_ms, groups, kernels_ms = profile_groups(one_round, events=events)
    busy = sum(groups.values())
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8])
    compress_ms = {k: v for k, v in kernels_ms.items()
                   if kernel_group(k) in ("rank_select", "int8_quantize",
                                           "sort_aggregate")}
    counts = kernels.launch_counts()
    # the kernels that run one device kernel a launch: the profile holds
    # every launch the tallies counted, or it lost events
    seen = {g: [events.get(g, 0), counts[g]] for g in ONE_KERNEL_A_LAUNCH
            if counts[g] or events.get(g, 0)}
    complete = all(a == b for a, b in seen.values())
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1.0 - busy / wall_ms) if busy else None,
           "groups_ms": groups, "top_kernels_ms": top,
           "events_vs_launches": seen, "events_complete": complete}
    if compress_ms:
        rec["compress_kernels_ms"] = compress_ms
    bw = card_bandwidth(torch.cuda.get_device_name(0))
    flash_ms = {k: v for k, v in kernels_ms.items()
                if kernel_group(k) == "flash_attention"}
    if flash_ms:
        rec["flash_kernels_ms"] = flash_ms
        # this round's flash time against its bound: the bounds of one
        # agent's calls, times the agents and epochs that ran them
        calls = attention_calls(cfg, seq)
        per_agent = {name: sum(flash_bounds(
            bw, MAIN_BATCH // FULL_N, S, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, causal, None, T=T)[name]["bound_ms"]
            for S, T, causal in calls) for name in ("fwd", "bwd")}
        for name in ("fwd", "bwd"):
            n = counts[f"flash_attention_{name}"]
            ms = sum(v for k, v in flash_ms.items()
                     if f"flash_{name}_" in k)
            bound = n / len(calls) * per_agent[name]
            rec[f"flash_{name}"] = dict(launches=n, ms=ms, bound_ms=bound,
                                        share_of_bound=bound / ms if ms else None)
    lru_ms = {k: v for k, v in kernels_ms.items()
              if kernel_group(k) == "lru_scan"}
    if lru_ms:
        # every scan layer of the model has the same width
        bounds = lru_bounds(bw, MAIN_BATCH // FULL_N, MAIN_SEQ,
                            scan_width(cfg), 4)
        for name in ("fwd", "bwd"):
            n = counts[f"lru_scan_{name}"]
            ms = sum(v for k, v in lru_ms.items() if f"lru_{name}_kernel" in k)
            bound = n * bounds[name]["bound_ms"]
            rec[f"lru_scan_{name}"] = dict(launches=n, ms=ms, bound_ms=bound,
                                           share_of_bound=bound / ms if ms else None)
    ssm_ms = {k: v for k, v in kernels_ms.items()
              if kernel_group(k) == "ssm_scan"}
    if ssm_ms:
        bounds = ssm_bounds(bw, MAIN_BATCH // FULL_N, MAIN_SEQ, cfg.d_inner,
                            cfg.ssm_state, 2)
        for name in ("fwd", "bwd"):
            n = counts[f"ssm_scan_{name}"]
            ms = sum(v for k, v in ssm_ms.items() if f"ssm_{name}_kernel" in k
                     or (name == "bwd" and "ssm_reduce_kernel" in k))
            bound = n * bounds[name]["bound_ms"]
            rec[f"ssm_scan_{name}"] = dict(launches=n, ms=ms, bound_ms=bound,
                                           share_of_bound=bound / ms if ms else None)
    log(f"{label} profile: one round {wall_ms:.1f} ms wall under the "
        f"profiler, device busy {busy:.1f} ms"
        + (f" ({100 * rec['idle_share']:.1f}% idle)" if busy else
           " (the profiler saw no device time)")
        + ("" if complete else f"; the profile LOST events (kernel "
           f"executions seen vs launches counted: {seen}), so its busy "
           f"time and idle share are not the round's"))
    log(json.dumps({"profile": rec}))
    return rec


# the kernel groups whose every launch runs one device kernel
ONE_KERNEL_A_LAUNCH = ("round_uplink", "round_downlink",
                       "round_uplink_partial", "round_downlink_presummed",
                       "fedplt_update")
MAIN_SEQ, MAIN_BATCH = 512, 8     # the main path's tokens per sequence, batch
# phase 4's FedSpec fields (the full-width trainers' spec)
MAIN_SPEC = dict(n_agents=FULL_N, n_epochs=N_EPOCHS, gamma=0.05,
                 weight_decay=0.01, state_layout="packed",
                 engine_backend="fused", use_fused_update=True)


@dataclasses.dataclass(frozen=True)
class Cell:
    """A full-width trainer of the smoke: an architecture at published
    width cut to ``n_layers``; its parameter count and leaves; the packed
    width of its state (None: the tree layout, which a mixed-dtype tree
    takes); its attention calls (an enc-dec layer's cross-attention
    counts as one) and scan layers, which set the flash and lru_scan
    launches of a round (one forward and one backward per call per agent
    per local epoch); the tokens of a sequence."""
    arch: str
    n_layers: int
    n_params: int
    n_leaves: int
    packed_width: int | None
    attn_layers: int
    scan_layers: int = 0
    seq_len: int = MAIN_SEQ


GEMMA = Cell("gemma2-2b", N_LAYERS, 745_549_056, 18, FULL_M, N_LAYERS)
# tied embedding 614,596,608 + 2 x 100,669,440 + the final norm's 3,072;
# one global layer a pattern unit, so ten leaves stacked over 2 units
PHI4 = Cell("phi4-mini-3.8b", N_LAYERS, 815_938_560, 10, 815_938_560,
            N_LAYERS)
# one pattern unit (rec, rec, local), and two Mamba layers, both bf16 with
# float32 leaves (dt_bias, A_log, D; lam): tree layout
RGEMMA = Cell("recurrentgemma-2b", 3, 912_309_760, 34, None, 1, 2)
MAMBA = Cell("falcon-mamba-7b", 2, 476_966_912, 12, None, 0, 2)
# one layer: the tied embedding 311,164,928, attention 16,777,216, the
# MoE 553,771,008 (router 122,880 float32; 60 experts' wi 346,030,080 and
# wo 173,015,040; the shared experts' 34,603,008), norms 6,144; bf16 with
# the float32 router: tree layout
QWEN = Cell("qwen2-moe-a2.7b", 1, 881_719_296, 13, None, 1)
# published depth: 12 encoder layers (over 1500 frames) and 12 decoder
# layers, 36 attention calls an agent's forward (12 encoder, 12 causal
# self, 12 cross); the decoder's 448-token text context; 23 leaves, bf16
WHISPER = Cell("whisper-small", 12, 238_060_032, 23, 238_060_032, 36,
               seq_len=448)
# one layer of 48: the tied embedding 568,653,632, attention 88,080,384,
# the swiglu MLP 301,989,888, norms 12,288; 256 patch embeddings before
# 256 text tokens
INTERNVL = Cell("internvl2-26b", 1, 958_734_336, 10, 958_734_336, 1)


def train_phase(torch, label, spec, steps, expect, profile=False, cell=GEMMA,
                cfg_kw=None, profile_out=None, after=None):
    """``steps`` rounds of ``cell`` (its config with ``cfg_kw`` replaced)
    through ``run_fed``, checked; returns ``(counts, history, peak)`` and,
    with ``profile``, puts the profiled round's record in
    ``profile_out``.  ``after(trainer, state, cfg)`` runs last, before the
    trainer and its state are freed."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_fed

    cfg = dataclasses.replace(get_config(cell.arch), n_layers=cell.n_layers,
                              **(cfg_kw or {}))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    trainer, state, hist = run_fed(cfg, spec, steps=steps,
                                   seq_len=cell.seq_len, batch=MAIN_BATCH,
                                   device="cuda", log=log)
    trainer_gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.time() - t0
    n_params = trainer.model.param_count()
    if n_params != cell.n_params:
        fail(f"{label}: {n_params} parameters, want {cell.n_params:,}")
    if len(trainer.model.param_shapes()) != cell.n_leaves:
        fail(f"{label}: {len(trainer.model.param_shapes())} leaves, want "
             f"{cell.n_leaves}")
    meta = trainer.packed_meta
    if (meta.width if meta is not None else None) != cell.packed_width:
        fail(f"{label}: packed width {meta and meta.width}, want "
             f"{cell.packed_width}")
    for h in hist:
        if not math.isfinite(h["loss"]):
            fail(f"{label}: non-finite loss {h['loss']}")
    x = state.x

    def finite(v):
        return all(bool(torch.isfinite(l).all()) for l in
                   (v.values() if isinstance(v, dict) else [v]))

    if not finite(x):
        fail(f"{label}: non-finite agent state")
    if state.t is not None and not finite(state.t):
        fail(f"{label}: non-finite coordinator copy t")
    if counts != expect:
        fail(f"{label}: launch counts {counts}, want {expect}")
    peak = torch.cuda.max_memory_allocated()
    layout = (f"packed state {tuple(x.shape)} {x.dtype}" if meta is not None
              else f"tree state of {len(x)} leaves "
              f"({sorted({str(l.dtype) for l in x.values()})})")
    log(f"{label}: {n_params:,} params, {layout}; launches {counts}; peak "
        f"device memory {peak / 1e9:.2f} GB; {wall:.1f} s wall")
    if profile:
        rec = profile_round(torch, trainer, state, trainer_gen, cfg,
                            " ".join(label.split()[:2]), cell.seq_len)
        if profile_out is not None:
            profile_out.update(rec)
    if after is not None:
        after(trainer, state, cfg)
    del trainer, state, x
    torch.cuda.empty_cache()
    return counts, hist, peak


def expected_counts(rounds=0, cell=GEMMA, **kw):
    """Every kernel's launch count: 0 unless given; ``rounds`` rounds of
    the full-width trainer ``cell`` add their attention and scan launches
    (every agent's every local epoch runs one forward and one backward per
    attention layer, and per scan layer)."""
    from repro_torch import kernels

    out = dict.fromkeys(kernels.launch_counts(), 0)
    per_round = FULL_N * N_EPOCHS
    out.update(flash_attention_fwd=rounds * per_round * cell.attn_layers,
               flash_attention_bwd=rounds * per_round * cell.attn_layers,
               lru_scan_fwd=rounds * per_round * cell.scan_layers,
               lru_scan_bwd=rounds * per_round * cell.scan_layers)
    out.update(kw)
    return out


def robust_phase(torch, base):
    """Phase 7: the robust main path and its variants, driven through
    ``ModelTrainer.step(corrupt=, live=)``; returns ``(counts of the
    3-round path, {variant: {"round_ms": [...], "peak_gb": g}})``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.fed.faults import FaultPlan
    from repro_torch.fed.robust import row_sq_norms
    from repro_torch.kernels.robust_agg import ops as rops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    model = build_model(cfg)
    shape = InputShape("robust", 512, 8, "train")
    gen = torch.Generator(device="cuda").manual_seed(7)
    plan = FaultPlan.generate(0, FULL_N, 3, n_byzantine=1,
                              byzantine_kind="sign_flip")
    rows = []
    for r in range(3):
        row = torch.zeros((FULL_N, 2))
        for a in range(FULL_N):
            pair = plan.byzantine_at(a, r)
            if pair is not None:
                row[a] = torch.tensor(pair)
        rows.append(row)
    flipped = [a for a in range(FULL_N) if plan.byzantine_at(a, 0)]
    robust = dict(base, guard_increments=True)
    def drive(label, spec, state, n, corrupt, live, expect):
        trainer = api.build_trainer(model, spec, "cuda")
        if state is None:
            state, _ = trainer.init(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        hist = []
        for r in range(n):
            b = make_batch_for(cfg, shape, gen, n_agents=FULL_N,
                               device="cuda")
            t0 = time.time()
            state, m = trainer.step(state, b, gen, corrupt=corrupt[r],
                                    live=live)
            m = {k: float(v) for k, v in m.items()}   # waits for the device
            m["dt"] = time.time() - t0
            hist.append(m)
            log(f"round {r:4d} loss={m['loss']:.4f} "
                f"part={m['participation']:.2f} dt={m['dt']:.2f}s")
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if got != expect:
            fail(f"{label}: launch counts {got}, want {expect}")
        for h in hist:
            if not math.isfinite(h["loss"]):
                fail(f"{label}: non-finite loss {h['loss']}")
        if not bool(torch.isfinite(state.x).all() & torch.isfinite(
                state.z).all()):
            fail(f"{label}: non-finite agent state")
        if peak > 80e9:
            fail(f"{label}: peak device memory {peak / 1e9:.2f} GB")
        log(f"{label}: launches {got}; peak device memory "
            f"{peak / 1e9:.2f} GB; round ms "
            f"{[round(1e3 * h['dt'], 1) for h in hist]}")
        return trainer, state, got, hist, peak

    variants = {}

    def note(name, hist, peak):
        variants[name] = {"round_ms": [1e3 * h["dt"] for h in hist],
                          "peak_gb": peak / 1e9,
                          "participation": [h["participation"] for h in hist]}

    label = "phase 7 robust main path (trimmed_mean f=1, guards on)"
    log(f"{label}: sign-flipped agent(s) {flipped} of {FULL_N} "
        f"(FaultPlan.generate(0, 4, 3, n_byzantine=1))")
    trainer, state, main_counts, hist, peak = drive(
        label, api.FedSpec(**robust, aggregator="trimmed_mean",
                           aggregator_param=1), None, 3, rows, None,
        expected_counts(3, round_uplink=3, round_downlink=3, fedplt_update=6,
                        sort_aggregate=3))
    note("trimmed_mean", hist, peak)
    profile_round(torch, trainer, state, gen, cfg, "phase 7")
    del trainer

    _, st, _, hist, peak = drive(
        "phase 7 coord_median, live [1, 1, 1, 0]",
        api.FedSpec(**robust, aggregator="coord_median"), state, 1, [None],
        [1.0, 1.0, 1.0, 0.0],
        expected_counts(1, round_uplink=1, round_downlink=1, fedplt_update=2,
                        sort_aggregate=1))
    if hist[0]["participation"] != 0.75:
        fail("phase 7 coord_median: the evicted agent took part")
    note("coord_median", hist, peak)
    del st
    torch.cuda.empty_cache()

    center = rops.robust_aggregate(state.z, stat="coord_median")
    norms = torch.sqrt(row_sq_norms(state.z - center)).tolist()
    radius = sorted(norms)[FULL_N // 2]
    del center
    log(f"phase 7 norm_clip_mean: residual norms ||z_i - median(z)|| "
        f"{[round(v, 4) for v in norms]}, radius {radius:.4f} (their median)")
    _, st, _, hist, peak = drive(
        "phase 7 norm_clip_mean", api.FedSpec(
            **robust, aggregator="norm_clip_mean", aggregator_param=radius),
        state, 1, [None], None,
        expected_counts(1, round_uplink=1, round_downlink=1, fedplt_update=2,
                        sort_aggregate=1))
    note("norm_clip_mean", hist, peak)
    del st
    torch.cuda.empty_cache()

    bad = 2
    x_row, z_row = state.x[bad].clone(), state.z[bad].clone()
    poison = torch.zeros(FULL_N)
    poison[bad] = math.nan
    _, st, _, hist, peak = drive(
        "phase 7 mean, guards on, NaN corrupt row for agent 2",
        api.FedSpec(**robust), state, 1, [poison], None,
        expected_counts(1, round_uplink=1, round_downlink=1, fedplt_update=2))
    if not (torch.equal(st.x[bad], x_row) and torch.equal(st.z[bad], z_row)):
        fail("phase 7 guard: the quarantined agent's state changed")
    if hist[0]["participation"] != 0.75:
        fail("phase 7 guard: the NaN row was not quarantined")
    log("phase 7 guard: agent 2's NaN increment was quarantined (x and z "
        "rows unchanged, participation 0.75, finite loss)")
    note("mean_guard_nan", hist, peak)
    del st, state, x_row, z_row
    torch.cuda.empty_cache()
    return main_counts, variants



# ---------------------------------------------------------------------------
# Phase 8: sharded rounds
# ---------------------------------------------------------------------------

def sharded_small_checks(torch):
    """The sharded round-edge kernels against their plain versions, bit
    for bit (NaN results by position)."""
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.kernels.round_edge import ref as edge_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m in (1000, 1001):
            for n in range(1, 9):
                x, w, z, t = (torch.randn((n, m), generator=gen, device=dev
                                          ).to(dtype) for _ in range(4))
                u = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
                u[0] = 0.0
                w[0] = float("nan")    # a diverged solve of an inactive agent
                views = {"": (x, w, z, t)}
                flat = torch.empty(4 * n * m + 1, device=dev, dtype=dtype)
                mis = tuple(flat[1 + i * n * m:1 + (i + 1) * n * m].view(n, m)
                            for i in range(4))
                for a, b in zip(mis, (x, w, z, t)):
                    a.copy_(b)
                views[" misaligned view"] = mis
                for vname, (xv, wv, zv, tv) in views.items():
                    for seen, lag in ((zv, "exact"), (tv, "lagged")):
                        tag = f"{dtype} N_local={n} M={m} {lag}{vname}"
                        s = edge_ops.round_uplink_partial(seen)
                        same_bits(torch, s, edge_ref.round_uplink_partial_ref(
                            seen), f"round_uplink_partial {tag}")
                        for damping in (1.0, 0.65):
                            got = edge_ops.round_downlink_presummed(
                                xv, wv, zv, s, u, damping=damping)
                            want = edge_ref.round_downlink_presummed_ref(
                                xv, wv, zv, u, s, damping)
                            for a, b in zip(got, want):
                                same_bits(torch, a, b,
                                          f"round_downlink_presummed {tag} "
                                          f"damping={damping}")
                            if not (torch.equal(got[0][0], xv[0])
                                    and torch.equal(got[1][0], zv[0])):
                                fail(f"round_downlink_presummed {tag}: "
                                     f"inactive agent's state changed")
                            n_checks += 1
                        n_checks += 1
    torch.cuda.synchronize()
    log(f"phase 8a: {n_checks} small-shape checks of round_uplink_partial "
        f"and round_downlink_presummed bit-equal (NaN by position): N_local "
        f"1..8, M=1000 and 1001, fp32 and bf16, exact and lagged, damping 1 "
        f"and 0.65, a NaN row of w for an inactive agent, a misaligned view")


def sharded_full_shape(torch, bw):
    """Both sharded kernels at the trainer's full shape against their
    slabbed plain versions; returns ``{name: record}``."""
    from repro_torch.kernels import costs
    from repro_torch.launch.roofline import bound as kernel_bound
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.kernels.round_edge import ref as edge_ref

    N, M, sz = FULL_N, FULL_M, 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def buf():
        return torch.randn((N, M), generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def record(name, bytes_, flops, ms, plain_ms, lib_ms):
        bd = kernel_bound(bw, bytes_, flops)
        bound = bd["bound_ms"]
        rec = dict(bytes=bytes_, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bd["bound_by"], max_abs_err=0.0,   # bit-equal
                   library_ms=lib_ms)
        log(f"phase 8a full shape: {name} ({N}x{M} bf16) bit-equal to the "
            f"plain version; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound:.3f} ms ({bytes_ / 1e9:.3f} GB), "
            f"{100 * bound / ms:.1f}% of bound"
            + ("" if lib_ms is None else
               f"; torch.sum(z, dim=0, keepdim=True) {lib_ms:.3f} ms"))
        return rec

    recs = {}
    z = buf()
    s = edge_ops.round_uplink_partial(z)
    ps = torch.empty_like(s)
    plain = lambda: slabbed(edge_ref.round_uplink_partial_ref, (ps,), z)
    plain()
    same_bits(torch, s, ps, "round_uplink_partial full shape")
    ms = cuda_ms(torch, lambda: edge_ops.round_uplink_partial(z))
    pms = cuda_ms(torch, plain, reps=5)
    lib_ms = cuda_ms(torch, lambda: torch.sum(z, dim=0, keepdim=True))
    flops, nbytes = costs.round_uplink_partial(N, M, sz)
    recs["round_uplink_partial"] = record(
        "round_uplink_partial", nbytes, flops, ms, pms, lib_ms)
    del z, ps
    torch.cuda.empty_cache()

    x, w, z = buf(), buf(), buf()
    y = s
    u = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    xo, zo = edge_ops.round_downlink_presummed(x, w, z, y, u, damping=1.0)
    px, pz = torch.empty_like(xo), torch.empty_like(zo)
    plain = lambda: slabbed(lambda x_, w_, z_, y_: edge_ref.round_downlink_presummed_ref(
        x_, w_, z_, u, y_, 1.0), (px, pz), x, w, z, y)
    plain()
    same_bits(torch, xo, px, "round_downlink_presummed full shape x")
    same_bits(torch, zo, pz, "round_downlink_presummed full shape z")
    del xo, zo
    ms = cuda_ms(torch, lambda: edge_ops.round_downlink_presummed(
        x, w, z, y, u, damping=1.0))
    pms = cuda_ms(torch, plain, reps=5)
    flops, nbytes = costs.round_downlink_presummed(N, M, sz)
    recs["round_downlink_presummed"] = record(
        "round_downlink_presummed", nbytes, flops, ms, pms, None)
    del x, w, z, y, s, px, pz
    torch.cuda.empty_cache()
    return recs


def _reduced_sharded_rounds(torch, spec_kw, device, step_kw=None):
    """3 rounds of reduced gemma2-2b (fp32, N = 4) from seeded parameters
    and batches; returns ``(state, launch counts)``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [make_batch_for(cfg, InputShape("small", 64, 8, "train"), gen,
                              n_agents=FULL_N) for _ in range(3)]
    tr = api.build_trainer(model, api.FedSpec(
        n_agents=FULL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
        participation=0.75, state_layout="packed", engine_backend="fused",
        use_fused_update=True, **spec_kw), device)
    st, tgen = tr.init(0, params=params)
    kernels.reset_launch_counts()
    for b in batches:
        st, m = tr.step(st, b, tgen, **(step_kw or {}))
    float(m["loss"])                        # waits for the device
    return st, kernels.launch_counts()


def sharded_reduced_parity(torch):
    """Phase 8b: the 1-rank mesh against the unsharded card run, bit for
    bit; returns the mean case's 1-rank state (8e's reference)."""
    from repro_torch.fed.api import CompressionSpec

    flip = torch.tensor([[0.0, 0.0], [-1.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
    cases = {
        "mean": ({}, None),
        "topk 0.25": (dict(compression=CompressionSpec("topk", ratio=0.25)),
                      None),
        "trimmed_mean f=1 (guards, agent 1 sign-flipped)": (
            dict(aggregator="trimmed_mean", aggregator_param=1,
                 guard_increments=True), dict(corrupt=flip)),
    }
    keep = None
    for label, (kw, step_kw) in cases.items():
        st0, c0 = _reduced_sharded_rounds(torch, kw, "cuda", step_kw)
        st1, c1 = _reduced_sharded_rounds(torch, dict(kw, mesh_shape="1x1"),
                                          "cuda", step_kw)
        for var in ("x", "z", "t"):
            a, b = getattr(st0, var), getattr(st1, var)
            if (a is None) != (b is None) or (a is not None
                                              and not torch.equal(a, b)):
                again = _reduced_sharded_rounds(torch, kw, "cuda",
                                                step_kw)[0]
                fail(f"phase 8b {label}: the 1-rank mesh's {var} differs "
                     f"from the unsharded card run (max abs "
                     f"{float((a - b).abs().max())}); a second unsharded "
                     f"run {'repeats' if torch.equal(getattr(again, var), a) else 'does not repeat'} "
                     f"the first bit for bit")
        if (c0["round_uplink"], c0["round_downlink"],
                c0["round_uplink_partial"]) != (3, 3, 0) or (
                c1["round_uplink_partial"], c1["round_downlink_presummed"],
                c1["round_uplink"], c1["round_downlink"]) != (3, 3, 0, 0):
            fail(f"phase 8b {label}: launches unsharded {c0}, mesh {c1}")
        log(f"phase 8b {label}: reduced gemma2-2b fp32, N=4, 3 rounds: the "
            f"1-rank NCCL mesh equals the unsharded card run bit for bit "
            f"(x, z, t); launches partial={c1['round_uplink_partial']}, "
            f"presummed={c1['round_downlink_presummed']}, unsharded edges 0")
        if label == "mean":
            keep = st1
    return keep


def bf16_y_difference(torch, base):
    """The coordinator ``y`` of the 1-rank mesh against the unsharded
    fused uplink on the same bf16 ``z`` after round 1 (round 0's rows are
    equal, so its ``y`` is exact either way)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    model = build_model(cfg)
    z1 = {}
    for label, kw in (("unsharded", {}), ("mesh", {"mesh_shape": "1x1"})):
        tr = api.build_trainer(model, api.FedSpec(**base, **kw), "cuda")
        st, gen = tr.init(0)
        b = make_batch_for(cfg, InputShape("cli", 512, 8, "train"), gen,
                           n_agents=FULL_N, device="cuda")
        st, _ = tr.step(st, b, gen)
        z1[label] = st.z
        del st, tr
        torch.cuda.empty_cache()
    if not torch.equal(z1["unsharded"], z1["mesh"]):
        fail("phase 8c: z after round 1 differs between the 1-rank mesh "
             "and the unsharded run")
    z = z1.pop("mesh")
    del z1
    spec = api.FedSpec(**base, mesh_shape="1x1")
    prox, rho_eff = spec.resolve_prox_h(), spec.rho / FULL_N
    y0 = edge_ops.round_uplink(z, prox=prox, rho_eff=rho_eff)[0]
    mesh = spec.build_mesh("cuda")
    y1 = edge_ops.round_uplink_sharded(z, mesh=mesh, n_total=FULL_N,
                                       prox=prox, rho_eff=rho_eff)[0]
    a, b = y0.float(), y1.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    differ = int((y0 != y1).sum())
    rec = {"entries": y0.numel(), "differ": differ,
           "share": differ / y0.numel(), "max_ulps": float(ulps.max()),
           "max_abs": float((a - b).abs().max())}
    del y0, y1, a, b, mag, ulps, z
    torch.cuda.empty_cache()
    if rec["max_ulps"] > 1.0:
        fail(f"phase 8c: the 1-rank mesh's bf16 y differs by "
             f"{rec['max_ulps']} ulps (tolerance 1: one extra rounding of "
             f"the partial sum)")
    log(f"phase 8c bf16 y after round 1 (1-rank mesh vs unsharded, same z): "
        f"{differ:,} of {rec['entries']:,} entries differ "
        f"({100 * rec['share']:.2f}%), max {rec['max_ulps']} bf16 ulp, max "
        f"abs {rec['max_abs']:.3g} (tolerance: 1 ulp, the partial sum's "
        f"rounding to bf16 before the division)")
    return rec


def _two_rank_worker(rank, world, store, out_dir):
    """8e: one of two gloo ranks on the one card (spawned)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        st, counts = _reduced_sharded_rounds(torch, {"agent_shards": world},
                                             "cuda")
        torch.save({"x": st.x.cpu(), "z": st.z.cpu(), "counts": counts},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# gloo's refusal of a CUDA tensor (``ProcessGroupGloo::allreduce:
# unsupported device type cuda``, or a gloo built without CUDA): the one
# error that drops 8e; any other failure of a rank fails the smoke
GLOO_REFUSES_CUDA = re.compile(
    r"ProcessGroupGloo::\w+: unsupported device type|"
    r"[Gg]loo[^\n]*(?:not|without)[^\n]*CUDA")


def two_ranks_over_gloo(torch, want):
    """Phase 8e: two gloo ranks on the one card, each holding 2 of the 4
    agents, against 8b's 1-rank run (fp32 rounding).  Returns a short
    outcome string.  Only gloo's refusal of CUDA tensors
    (:data:`GLOO_REFUSES_CUDA`) drops 8e; any other failure fails."""
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    out = tempfile.mkdtemp()
    try:
        mp.start_processes(_two_rank_worker,
                           args=(2, os.path.join(out, "store"), out),
                           nprocs=2, join=True, start_method="spawn")
    except Exception as e:
        text = str(e)
        last = (text.strip().splitlines() or [type(e).__name__])[-1]
        if not GLOO_REFUSES_CUDA.search(text):
            fail(f"phase 8e: a rank of the two-rank run failed: {last}")
        log(f"phase 8e dropped: gloo on this build refuses CUDA tensors: "
            f"{last}")
        return f"dropped: {last}"
    got = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]
    worst = 0.0
    for var in ("x", "z"):
        g = torch.cat([r[var] for r in got])
        w = getattr(want, var).cpu()
        d = (g - w).abs()
        if not bool((d <= 1e-6 + 1e-5 * w.abs()).all()):
            fail(f"phase 8e: two ranks' {var} differ from the 1-rank run "
                 f"beyond rtol 1e-5 / atol 1e-6 (max abs {float(d.max())})")
        worst = max(worst, float(d.max()))
    counts = got[0]["counts"]
    log(f"phase 8e: two gloo ranks on the card (2 agents each, engine via "
        f"ModelTrainer.step -> packed_round_step(mesh=...)): x and z agree "
        f"with the 1-rank run to max abs {worst:.3g} (rtol 1e-5, atol 1e-6); "
        f"rank 0 launches partial={counts['round_uplink_partial']}, "
        f"presummed={counts['round_downlink_presummed']}")
    return f"ran: max abs {worst}"


def sharded_robust_round(torch, base):
    """Phase 8d: one robust round (trimmed_mean f=1, guards, one
    sign-flipped agent) at full width under the 1-rank mesh."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    tr = api.build_trainer(build_model(cfg), api.FedSpec(
        **base, guard_increments=True, aggregator="trimmed_mean",
        aggregator_param=1, mesh_shape="1x1"), "cuda")
    st, gen = tr.init(0)
    b = make_batch_for(cfg, InputShape("robust", 512, 8, "train"), gen,
                       n_agents=FULL_N, device="cuda")
    flip = torch.zeros((FULL_N, 2))
    flip[1, 0] = -1.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    st, m = tr.step(st, b, gen, corrupt=flip)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_counts(1, sort_aggregate=1, round_uplink_partial=1,
                           round_downlink_presummed=1, fedplt_update=2)
    if counts != want:
        fail(f"phase 8d: launch counts {counts}, want {want}")
    if not math.isfinite(loss) or peak > 80e9:
        fail(f"phase 8d: loss {loss}, peak {peak / 1e9:.2f} GB")
    log(f"phase 8d robust round under the 1-rank mesh (trimmed_mean f=1, "
        f"guards, agent 1 sign-flipped): launches {counts}; loss {loss:.4f}; "
        f"{1e3 * dt:.1f} ms; peak device memory {peak / 1e9:.2f} GB "
        f"(the all-gather of one rank's block is skipped)")
    del tr, st
    torch.cuda.empty_cache()
    return {"round_ms": 1e3 * dt, "peak_gb": peak / 1e9}


# ---------------------------------------------------------------------------
# Phase 9: flash attention, forward and backward
# ---------------------------------------------------------------------------

FLASH_FULL = dict(B=1, S=8192, H=8, Hkv=4, D=256)   # gemma2-2b at 8192 tokens
FLASH_CAP, FLASH_WINDOW = 50.0, 4096
# (H, Hkv, D, window) of phi4-mini-3.8b, nemotron-4-340b (and MQA at its
# D 192) and gemma3-12b's local layer
NEW_HEADS = ((24, 8, 128, None), (96, 8, 192, None), (8, 1, 192, None),
             (16, 8, 256, 1024))
# 23b's twin, one agent's (B, S): its --batch 8 over --n-agents 4, and
# --seq-len 128
LM_TWIN_SHAPE = (2, 128)


def flash_close(torch, got, want, what, grad=False):
    """Max abs error of a flash output against its plain version; fails
    beyond the tolerance: float32 ``o`` and ``lse`` 1e-5 max(1, |ref|)
    elementwise, float32 gradients 1e-4 max|ref|, bfloat16 one ulp of
    the plain result plus 1e-5 max|ref|."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    top = float(b.abs().max()) if b.numel() else 0.0
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(a.abs(), b.abs()).clamp_min(
            torch.finfo(torch.float32).tiny)
        tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * top
    elif grad:
        tol = 1e-4 * top
    else:
        tol = 1e-5 * b.abs().clamp_min(1.0)
    bad = ~(diff <= tol)
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} of {bad.numel()} elements beyond "
             f"tolerance, max abs err {float(diff.nan_to_num(float('inf')).max())}")
    return float(diff.max()) if diff.numel() else 0.0


def flash_zero(torch, grads, dv, what):
    """Fails unless gradients whose exact value is 0 are within 1e-5
    max|dv| of it (float32 rounding of terms of dv's size)."""
    top = 1e-5 * float(dv.float().abs().max())
    for g in grads:
        err = float(g.float().abs().max())
        if not err <= top:
            fail(f"{what}: max |g| {err} beyond 1e-5 max|dv| = {top} "
                 f"(exact value 0)")


def flash_small_checks(torch):
    """Phase 9a: the forward and backward kernels against their plain
    versions over dtypes, lengths (ragged too), GQA groupings, head
    dims, masks and softcaps; the backward kernels and the plain
    backward get the same inputs (the plain forward's o and lse)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = {"o": 0.0, "lse": 0.0, "grad": 0.0}
    n_checks = 0

    def draw(B, S, T, H, Hkv, D, dtype):
        q = torch.randn((B, S, H, D), generator=gen, device=dev)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen, device=dev)
                for _ in range(2))
        do = torch.randn((B, S, H, D), generator=gen, device=dev)
        return tuple(t.to(dtype) for t in (q, k, v, do))

    def check(q, k, v, do, kw, tag):
        nonlocal n_checks
        o, lse = fops.flash_attention_fwd(q, k, v, **kw)
        po, plse = fref.flash_attention_ref(q, k, v, **kw)
        worst["o"] = max(worst["o"], flash_close(torch, o, po,
                                                 "flash fwd o " + tag))
        worst["lse"] = max(worst["lse"], flash_close(
            torch, lse, plse, "flash fwd lse " + tag))
        got = fops.flash_attention_bwd(q, k, v, po, plse, do, **kw)
        want = fref.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
        names = ("dq", "dk", "dv")
        if q.shape[1] == 1 and k.shape[1] == 1:
            # one key: p = 1, so the exact dq and dk are 0 and both
            # versions return the rounding of dp - delta
            flash_zero(torch, got[:2], want[2], "flash bwd dq, dk " + tag)
            names, got, want = names[2:], got[2:], want[2:]
        for name, a, b in zip(names, got, want):
            worst["grad"] = max(worst["grad"], flash_close(
                torch, a, b, f"flash bwd {name} {tag}", grad=True))
        n_checks += 1

    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 7, 64, 128, 1000):
            for H, Hkv in ((8, 4), (8, 8), (8, 1)):
                for D in (64, 128, 256):
                    q, k, v, do = draw(2, S, S, H, Hkv, D, dtype)
                    for causal in (True, False):
                        for window in (None, 3, 100):
                            for cap in (None, FLASH_CAP):
                                kw = dict(causal=causal, window=window,
                                          cap=cap)
                                check(q, k, v, do, kw,
                                      f"{dtype} S={S} H={H} Hkv={Hkv} "
                                      f"D={D} {kw}")
    # the edges of the bf16 tensor-core kernels' tiles: S = T around the
    # 64-row warpgroup tiles, the 128-row CTAs and the 32- and 64-key
    # steps; T != S, with rows that see no key (S 300, T 40, window 100)
    # and keys no row sees; GQA 8:4 and the MQA head split (10 over 1)
    for S, T in ((63, 63), (65, 65), (129, 129), (192, 192), (300, 40),
                 (40, 300), (200, 129)):
        for H, Hkv in ((8, 4), (10, 1)):
            for D in (64, 256):
                q, k, v, do = draw(2, S, T, H, Hkv, D, torch.bfloat16)
                for causal, window, cap in ((True, None, FLASH_CAP),
                                            (True, 100, None),
                                            (False, 3, FLASH_CAP),
                                            (False, None, None)):
                    kw = dict(causal=causal, window=window, cap=cap)
                    check(q, k, v, do, kw, f"bf16 tile edge S={S} T={T} "
                          f"H={H} Hkv={Hkv} D={D} {kw}")
    # the main path's shape: one agent's batch of phase 4 through a
    # full-width global and local layer (bf16, its softcap and window);
    # recurrentgemma-2b's local layer in phase 10d: MQA, 10 heads over 1
    shapes = []
    for arch in ("gemma2-2b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        B, S = MAIN_BATCH // FULL_N, MAIN_SEQ
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q, k, v, do = draw(B, S, S, H, Hkv, D, torch.bfloat16)
        for window in (None, cfg.window):
            kw = dict(causal=True, window=window, cap=cfg.attn_softcap)
            check(q, k, v, do, kw, f"{arch} shape B={B} S={S} H={H} "
                  f"Hkv={Hkv} D={D} bf16 {kw}")
        shapes.append(f"{arch}'s B {B}, S = T {S}, H {H}, Hkv {Hkv}, D {D}"
                      f", bf16, cap {cfg.attn_softcap}, causal with window "
                      f"None and {cfg.window}")
    # the head shapes of phi4-mini-3.8b (GQA groups of 3), nemotron-4-340b
    # (groups of 12, D 192: the launcher pads to 256, the fourth 64-column
    # panel wholly out of bounds) and gemma3-12b's local layer
    for dtype in (torch.float32, torch.bfloat16):
        for S in (64, 129, 512):
            for H, Hkv, D, window in NEW_HEADS:
                q, k, v, do = draw(2, S, S, H, Hkv, D, dtype)
                kw = dict(causal=True, window=window, cap=None)
                check(q, k, v, do, kw, f"{dtype} S={S} H={H} Hkv={Hkv} "
                      f"D={D} {kw}")
    # the published layers of the three configs at the trainer's shape
    for arch in ("phi4-mini-3.8b", "gemma3-12b", "nemotron-4-340b"):
        cfg = get_config(arch)
        B, S = MAIN_BATCH // FULL_N, MAIN_SEQ
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        window = cfg.window if "local" in cfg.pattern else None
        q, k, v, do = draw(B, S, S, H, Hkv, D, torch.bfloat16)
        kw = dict(causal=True, window=window, cap=cfg.attn_softcap)
        check(q, k, v, do, kw, f"{arch} shape B={B} S={S} H={H} "
              f"Hkv={Hkv} D={D} bf16 {kw}")
        shapes.append(f"{arch}'s B {B}, S = T {S}, H {H}, Hkv {Hkv}, D {D}"
                      f", bf16, cap {cfg.attn_softcap}, causal, window "
                      f"{window}")
    # 23b's twin (the ~100M gemma2-family config, float32): one agent's
    # batch through its global and local layers
    lm = example("train_lm_federated").lm_config()
    B, S = LM_TWIN_SHAPE
    H, Hkv, D = lm.n_heads, lm.n_kv_heads, lm.resolved_head_dim
    q, k, v, do = draw(B, S, S, H, Hkv, D, torch.float32)
    for window in (None, lm.window):
        kw = dict(causal=True, window=window, cap=lm.attn_softcap)
        check(q, k, v, do, kw, f"LM twin shape B={B} S={S} H={H} "
              f"Hkv={Hkv} D={D} fp32 {kw}")
    shapes.append(f"the LM twin's B {B}, S = T {S}, H {H}, Hkv {Hkv}, D {D}"
                  f", fp32, cap {lm.attn_softcap}, causal with window None "
                  f"and {lm.window}")
    # rows with no visible key (S > T + window - 1): the mean of v
    q, k, v, do = draw(2, 300, 40, 8, 4, 64, torch.float32)
    for causal in (True, False):
        kw = dict(causal=causal, window=100, cap=FLASH_CAP)
        check(q, k, v, do, kw, f"dead rows {kw}")
    q, k, v, do = draw(1, 128, 128, 8, 4, 128, torch.bfloat16)
    o, lse = fops.flash_attention_fwd(q, k, v, causal=True)
    fresh_thread_launches(torch, {
        "flash_attention_fwd bf16": lambda: fops.flash_attention_fwd(
            q, k, v, causal=True),
        "flash_attention_bwd bf16": lambda: fops.flash_attention_bwd(
            q, k, v, o, lse, do, causal=True)})
    torch.cuda.synchronize()
    log(f"phase 9a: {n_checks} flash attention checks (forward o and lse, "
        f"backward dq, dk, dv) against the plain versions: fp32 and bf16, "
        f"S = T in (1, 7, 64, 128, 1000), (H, Hkv) in ((8, 4), (8, 8), "
        f"(8, 1)), D in (64, 128, 256), causal or not, window None / 3 / "
        f"100, cap None / 50; bf16 tile edges (S, T) in (63, 63), (65, 65), "
        f"(129, 129), (192, 192), (300, 40), (40, 300), (200, 129) with "
        f"(H, Hkv) (8, 4) and (10, 1), D 64 and 256; fp32 and bf16, S = T "
        f"in (64, 129, 512), causal, cap None at (H, Hkv, D, window) in "
        f"{NEW_HEADS}; the trainers' shapes "
        f"({'; '.join(shapes)}), and fp32 rows with no visible key (S 300, "
        f"T 40, window 100); max abs err o {worst['o']:.3g}, lse "
        f"{worst['lse']:.3g}, grads {worst['grad']:.3g}; the bf16 kernels "
        f"also launched from a fresh thread, bit-equal")


def _plain_by_head(fn, q, k, v, *rest, **kw):
    """A plain flash function run one query head at a time (bounded
    float32 scores); returns the per-head outputs stacked on the head
    axis of their layout."""
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    outs = []
    for h in range(H):
        sl = slice(h // G, h // G + 1)
        outs.append(fn(q[:, :, h:h + 1], k[:, :, sl], v[:, :, sl],
                       *[r(h) for r in rest], **kw))
    return outs


def plain_fwd_by_head(torch, q, k, v, **kw):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    outs = _plain_by_head(flash_attention_ref, q, k, v, **kw)
    return (torch.cat([o for o, _ in outs], dim=2),
            torch.cat([lse for _, lse in outs], dim=1))


def plain_bwd_by_head(torch, q, k, v, o, lse, do, **kw):
    """The plain backward one query head at a time in float32, summing
    dk and dv over the heads of a group in float32 and rounding once."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    f32 = lambda t: t.float()
    outs = _plain_by_head(
        flash_attention_bwd_ref, f32(q), f32(k), f32(v),
        lambda h: f32(o[:, :, h:h + 1]), lambda h: lse[:, h:h + 1],
        lambda h: f32(do[:, :, h:h + 1]), **kw)
    dq = torch.cat([g[0] for g in outs], dim=2)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for h, (_, gk, gv) in enumerate(outs):
        dk[:, :, h // G:h // G + 1] += gk
        dv[:, :, h // G:h // G + 1] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_full_shape(torch, bw):
    """Phases 9b and 9c at gemma2-2b's attention shape over 8192 tokens
    (bf16, cap 50): the global (causal) and local (window 4096) layers,
    forward and backward, against their plain versions run head by head,
    timed beside the bounds and the yardsticks; then the same forward and
    backward twice, bit for bit.  Returns ``{kind: record}``."""
    from repro_torch.launch.roofline import BF16_PEAK, flash_bounds
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import attention as attn_lib

    B, S, H, Hkv, D = (FLASH_FULL[k] for k in ("B", "S", "H", "Hkv", "D"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(bf)
            for _ in range(2))
    do = torch.randn((B, S, H, D), generator=gen, device=dev).to(bf)
    recs = {}
    for kind, causal, window in (("global", True, None),
                                 ("local", True, FLASH_WINDOW)):
        kw = dict(causal=causal, window=window, cap=FLASH_CAP)
        o, lse = fops.flash_attention_fwd(q, k, v, **kw)
        po, plse = plain_fwd_by_head(torch, q, k, v, **kw)
        err_o = flash_close(torch, o, po, f"phase 9b {kind} o")
        err_lse = flash_close(torch, lse, plse, f"phase 9b {kind} lse")
        grads = fops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = plain_bwd_by_head(torch, q, k, v, o, lse, do, **kw)
        err_g = max(flash_close(torch, a, b, f"phase 9b {kind} d{n}",
                                grad=True)
                    for n, a, b in zip("qkv", grads, want))
        del want
        # 9c: the same launches again give the same bits
        o2, lse2 = fops.flash_attention_fwd(q, k, v, **kw)
        again = fops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, again))):
            fail(f"phase 9c {kind}: a second run of the flash kernels "
                 f"differs from the first")
        del o2, lse2, again, grads
        torch.cuda.empty_cache()

        fwd_ms = cuda_ms(torch, lambda: fops.flash_attention_fwd(q, k, v, **kw))
        bwd_ms = cuda_ms(torch, lambda: fops.flash_attention_bwd(
            q, k, v, o, lse, do, **kw))
        pfwd_ms = cuda_ms(torch, lambda: plain_fwd_by_head(torch, q, k, v, **kw),
                          reps=3)
        pbwd_ms = cuda_ms(torch, lambda: plain_bwd_by_head(
            torch, q, k, v, o, lse, do, **kw), reps=3)
        torch.cuda.empty_cache()

        # yardsticks: SDPA (no softcap, no window: a different function),
        # flex_attention under torch.compile (the same function: the softcap
        # as its score_mod, the mask as its block mask) and the plain
        # PyTorch path that the kernel replaces, with autograd
        import torch.nn.functional as F
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True)
        sdpa_fwd_ms = cuda_ms(torch, sdpa)
        out = sdpa()
        sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        del out

        def mask_mod(b, h, qi, ki):
            seen = qi >= ki
            return seen if window is None else seen & (qi - ki < window)

        def softcap(score, b, h, qi, ki):
            return FLASH_CAP * torch.tanh(score / FLASH_CAP)

        block_mask = create_block_mask(mask_mod, None, None, S, S,
                                       device="cuda")
        flex = torch.compile(flex_attention)
        flex_call = lambda: flex(qt, kt, vt, score_mod=softcap,
                                 block_mask=block_mask, enable_gqa=True)
        out = flex_call()
        # a yardstick's own rounding (recorded, not held to 9a's tolerance)
        flex_err = float((out.transpose(1, 2).float() - po.float()).abs().max())
        flex_fwd_ms = cuda_ms(torch, flex_call)
        flex_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
        del out, qt, kt, vt, dot, block_mask
        torch.cuda.empty_cache()
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        if kind == "global":
            plain = lambda: attn_lib.attn_chunked(ql, kl, vl, causal=True,
                                                  cap=FLASH_CAP)
        else:
            plain = lambda: attn_lib.attn_block_local(ql, kl, vl,
                                                      window=FLASH_WINDOW,
                                                      cap=FLASH_CAP)
        with torch.no_grad():
            torch_fwd_ms = cuda_ms(torch, plain, reps=3)
        dflat = do.reshape(B, S, H * D)
        torch_fb_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            plain(), (ql, kl, vl), dflat), reps=3)
        del ql, kl, vl
        torch.cuda.empty_cache()

        bounds = flash_bounds(bw, B, S, H, Hkv, D, causal, window)
        rec = {"pairs": bounds["pairs"]}
        for name, ms, pms, lib_ms, sdpa_ms, err in (
                ("fwd", fwd_ms, pfwd_ms, flex_fwd_ms, sdpa_fwd_ms,
                 max(err_o, err_lse)),
                ("bwd", bwd_ms, pbwd_ms, flex_bwd_ms, sdpa_bwd_ms, err_g)):
            bd = bounds[name]
            bound, f_bf16, f_split = (bd[f] for f in ("bound_ms", "flops_bf16",
                                                       "flops_split"))
            rec[name] = dict(ms=ms, plain_ms=pms, max_abs_err=err,
                             library_ms=lib_ms, sdpa_ms=sdpa_ms, **bd)
            log(f"phase 9b {kind} ({'causal' if window is None else f'window {window}'}"
                f", cap {FLASH_CAP}, B {B} S {S} H {H} Hkv {Hkv} D {D} bf16) "
                f"{name}: max_abs_err={err:.3g}; kernel {ms:.3f} ms, plain "
                f"(head by head) {pms:.3f} ms, bound {bound:.3f} ms "
                f"({f_bf16 / 1e9:.1f} GFLOP bf16 x bf16 + {f_split / 1e9:.1f} "
                f"GFLOP in {bd['nsplit']} bf16 terms of p or ds, all at "
                f"{BF16_PEAK / 1e12:.0f} TFLOP/s; {100 * bound / ms:.1f}% of "
                f"it); yardsticks flex_attention (compiled, the same "
                f"function) {lib_ms:.3f} ms, SDPA is_causal {sdpa_ms:.3f} ms")
        rec["flex_max_abs_err"] = flex_err
        rec["sdpa_fwd_plus_bwd_ms"] = sdpa_fwd_ms + sdpa_bwd_ms
        rec["flex_fwd_plus_bwd_ms"] = flex_fwd_ms + flex_bwd_ms
        rec["torch_path_fwd_ms"] = torch_fwd_ms
        rec["torch_path_fwd_plus_bwd_ms"] = torch_fb_ms
        log(f"phase 9b {kind} yardsticks: flex_attention fwd {flex_fwd_ms:.3f}"
            f" + bwd {flex_bwd_ms:.3f} ms (its o against the plain one: max "
            f"abs err {flex_err:.3g}); SDPA fwd {sdpa_fwd_ms:.3f} + bwd "
            f"{sdpa_bwd_ms:.3f} ms (no softcap{'' if window is None else ', no window'}: "
            f"another function); the plain PyTorch path it replaces "
            f"({'attn_chunked' if window is None else 'attn_block_local'}) "
            f"fwd {torch_fwd_ms:.3f} ms, fwd + autograd bwd {torch_fb_ms:.3f} "
            f"ms; kernels fwd + bwd {fwd_ms + bwd_ms:.3f} ms")
        recs[kind] = rec
        del o, lse, po, plse
        torch.cuda.empty_cache()
    log("phase 9c: a second forward and backward (global and local, full "
        "shape) repeat the first bit for bit")
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# Phase 10: the SSM and RG-LRU model kinds, the lru_scan kernels
# ---------------------------------------------------------------------------

# the trainers' scans (B 2 a agent, S 512) and recurrentgemma's at its
# 8192-token context: (B, S, W)
LRU_FULL = {"mamba": (2, 512, 8192 * 16), "rglru": (2, 512, 2560),
            "rglru_8k": (1, 8192, 2560)}


def scan_width(cfg) -> int:
    """The channels of the model's scans: Mamba's d_inner x state, or the
    RG-LRU width."""
    if "ssm" in cfg.layer_kinds():
        return cfg.d_inner * cfg.ssm_state
    return cfg.resolved_lru_width


# (B, W) of 10a's rows across the ring kernel's tiling on an H100 (132 SMs,
# tiles of 32 columns and blocks of 32 steps: csrc/lru_scan.cu kTile,
# kSteps): fewer CTAs than SMs, more, four an SM, and the Mamba scan's width
LRU_TILING_BW = ((1, 1000), (3, 2560), (2, 8448), (2, 131072))
LRU_RING_TILE = LRU_RING_STEPS = 32


def lru_small_checks(torch):
    """Phase 10a: both scan kernels against their plain versions, bit for
    bit (NaN by position): B in (1, 2, 3), S in (1, 7, 128, 129, 1000), W
    in (1, 5, 1000, 1001), float32 and bfloat16, a drawn in (0, 1) with
    a = 0, 1, 1.5 and -0.7 at scattered entries; one NaN in a; a 4-D
    (B, S, W, N) call through the op and its autograd Function; a view
    one element past an aligned allocation."""
    from repro_torch.kernels.lru_scan import ops as lops
    from repro_torch.kernels.lru_scan import ref as lref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    special = torch.tensor([0.0, 1.0, 1.5, -0.7], device=dev)
    n_checks = 0

    def check(a, b, g, tag):
        h = lops.lru_scan_fwd(a, b)
        same_bits(torch, h, lref.lru_scan_ref(a, b), f"lru_scan fwd {tag}")
        for name, got, want in zip(("da", "db"), lops.lru_scan_bwd(a, h, g),
                                   lref.lru_scan_bwd_ref(a, h, g)):
            same_bits(torch, got, want, f"lru_scan bwd {name} {tag}")

    def draw(shape, dtype):
        a = torch.rand(shape, generator=gen, device=dev)
        pos = torch.randint(0, a.numel(), (8,), generator=gen, device=dev)
        a.view(-1)[pos] = special.repeat(2)
        b, g = (torch.randn(shape, generator=gen, device=dev)
                for _ in range(2))
        return tuple(t.to(dtype) for t in (a, b, g))

    def misaligned(ts):
        return tuple(torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
                     .view(t.shape).copy_(t) for t in ts)

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2, 3):
            for S in (1, 7, 128, 129, 1000):
                for W in (1, 5, 1000, 1001):
                    check(*draw((B, S, W), dtype), f"{dtype} B={B} S={S} W={W}")
                    n_checks += 1
        for W in (1001, 1000):  # the per-column kernel, the ring kernel
            a, b, g = draw((2, 129, W), dtype)
            a[1, 3, 2] = float("nan")
            check(a, b, g, f"{dtype} W={W} one NaN in a")
        # one element past an aligned allocation: the per-column kernel
        # (TMA needs 16-byte aligned operands)
        check(*misaligned(draw((3, 129, 1000), dtype)),
              f"{dtype} misaligned view")
        # 4-D through the op: the fold and LruScan's forward and backward
        a, b, g = draw((2, 129, 40, 16), dtype)
        la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
        h = lops.lru_scan(la, lb)
        da, db = torch.autograd.grad(h, (la, lb), g)
        fold = lambda t: t.reshape(2, 129, 640)
        want_h = lref.lru_scan_ref(fold(a), fold(b))
        same_bits(torch, h.detach(), want_h.reshape(h.shape),
                  f"lru_scan 4-D fwd {dtype}")
        for got, want in zip((da, db), lref.lru_scan_bwd_ref(
                fold(a), want_h, fold(g))):
            same_bits(torch, got, want.reshape(got.shape),
                      f"lru_scan 4-D bwd {dtype}")
        n_checks += 3
    # the ring kernel's tiling: S one below, at and one above a block's
    # steps, and 8193; B x W from fewer CTAs than SMs to the Mamba scan's
    # width; each (B, W) also as a view one element past an aligned
    # allocation, which the per-column kernel takes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {}
    steps = LRU_RING_STEPS

    def on_kernel(want, ops, tag):
        seen = lru_kernels_run(torch, lambda: check(*ops, tag))
        if seen != {want}:
            fail(f"phase 10a {tag}: the call launched the lru_scan kernels "
                 f"{sorted(seen)}, want the {want} kernel alone")

    for B, W in LRU_TILING_BW:
        long = (8193,) if B * W < 1e5 else ()
        for dtype in (torch.float32, torch.bfloat16):
            for S in (steps - 1, steps, steps + 1) + long:
                check(*draw((B, S, W), dtype), f"{dtype} B={B} S={S} W={W}")
                n_checks += 1
            on_kernel("ring", draw((B, steps, W), dtype),
                      f"{dtype} B={B} S={steps} W={W}")
            on_kernel("per-column", misaligned(draw((B, steps + 1, W), dtype)),
                      f"{dtype} misaligned view B={B} S={steps + 1} W={W}")
            n_checks += 2
        ctas = B * -(-W // LRU_RING_TILE)
        plans[(B, W)] = f"{ctas} CTAs ({ctas / sms:.2f} an SM)"
    a, b, g = draw((2, 64, 256), torch.float32)
    h = lops.lru_scan_fwd(a, b)
    fresh_thread_launches(torch, {
        "lru_scan_fwd": lambda: lops.lru_scan_fwd(a, b),
        "lru_scan_bwd": lambda: lops.lru_scan_bwd(a, h, g)})
    torch.cuda.synchronize()
    log(f"phase 10a: {n_checks} lru_scan checks (forward h, backward da and "
        f"db) bit-equal to the plain versions: fp32 and bf16, B in (1, 2, "
        f"3), S in (1, 7, 128, 129, 1000), W in (1, 5, 1000, 1001) (W 1, 5, "
        f"1001 on the per-column kernel, 1000 on the ring kernel), a in "
        f"(0, 1) with a = 0, 1, 1.5, -0.7 at scattered entries, one NaN in "
        f"a on each kernel (propagated at the plain version's positions), "
        f"a misaligned view, a 4-D (2, 129, 40, 16) call through the "
        f"autograd Function; and across the ring kernel's tiling, (B, W): "
        f"{plans} at S a block's steps -1, +0, +1 and 8193 (B x W < 1e5), "
        f"each (S a block's steps) run on the ring kernel and, as a "
        f"misaligned view, on the per-column kernel, fp32 and bf16; both "
        f"ring kernels also launched from a fresh thread, bit-equal")


def fresh_thread_launches(torch, calls):
    """Runs each of ``calls`` (name: fn returning a tensor or a tuple of
    them) in this thread, then in a new thread whose first CUDA work it is
    (its outputs come from the allocator's cache), and fails unless that
    launch succeeds with the same bits.  A thread that has made no runtime
    call has no current context, which the TMA encoders need."""
    import threading

    for name, fn in calls.items():
        want = fn()
        torch.cuda.synchronize()
        got = {}

        def run():
            try:
                got["out"] = fn()
            except Exception as e:  # reported below, in the main thread
                got["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        torch.cuda.synchronize()
        if "error" in got:
            fail(f"{name} from a fresh thread: {got['error']}")
        pairs = zip(want, got["out"]) if isinstance(want, tuple) else (
            (want, got["out"]),)
        for w, x in pairs:
            same_bits(torch, x, w, f"{name} from a fresh thread")


def lru_kernels_run(torch, fn):
    """Which lru_scan kernels ``fn`` launched, ``"ring"`` or
    ``"per-column"``, from the C launcher's own tallies of the launches
    that succeeded (a profile of the call can hold no device event at
    all, as whole runs have shown)."""
    from repro_torch.kernels.lru_scan import kernel as lkernel

    before = lkernel.route_counts()
    fn()
    torch.cuda.synchronize()
    after = lkernel.route_counts()
    return {k for k in after if after[k] > before[k]}


def lru_full_shape(torch, bw):
    """Phase 10b: the scans at the trainers' shapes and recurrentgemma's
    8192-token context, float32, bit-equal to the plain versions and timed
    (CUDA events, median of 7; plain median of 3) beside the byte bound.
    Returns ``{name: record}`` with ``lru_scan_fwd`` / ``_bwd`` at the
    Mamba shape and ``lru_scan_fwd[rglru ...]`` variants."""
    from repro_torch.launch.roofline import lru_bounds
    from repro_torch.kernels.lru_scan import ops as lops
    from repro_torch.kernels.lru_scan import ref as lref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    recs = {}
    for shape_name, (B, S, W) in LRU_FULL.items():
        a = torch.rand((B, S, W), generator=gen, device=dev)
        b, g = (torch.randn((B, S, W), generator=gen, device=dev)
                for _ in range(2))
        h = lops.lru_scan_fwd(a, b)
        ph = lref.lru_scan_ref(a, b)
        same_bits(torch, h, ph, f"phase 10b {shape_name} h")
        err = {"fwd": float((h - ph).abs().max())}
        del ph
        grads = lops.lru_scan_bwd(a, h, g)
        want = lref.lru_scan_bwd_ref(a, h, g)
        for n, x, y in zip(("da", "db"), grads, want):
            same_bits(torch, x, y, f"phase 10b {shape_name} {n}")
        err["bwd"] = max(float((x - y).abs().max())
                         for x, y in zip(grads, want))
        del grads, want
        torch.cuda.empty_cache()
        ms = {"fwd": cuda_ms(torch, lambda: lops.lru_scan_fwd(a, b)),
              "bwd": cuda_ms(torch, lambda: lops.lru_scan_bwd(a, h, g))}
        plain = {"fwd": cuda_ms(torch, lambda: lref.lru_scan_ref(a, b),
                                reps=3),
                 "bwd": cuda_ms(torch, lambda: lref.lru_scan_bwd_ref(a, h, g),
                                reps=3)}
        bounds = lru_bounds(bw, B, S, W, 4)
        for name in ("fwd", "bwd"):
            bd = bounds[name]
            rec = dict(shape=[B, S, W], ms=ms[name], plain_ms=plain[name],
                       max_abs_err=err[name], library_ms=None, **bd)
            key = (f"lru_scan_{name}" if shape_name == "mamba" else
                   f"lru_scan_{name}[{shape_name} B{B} S{S} W{W}]")
            recs[key] = rec
            log(f"phase 10b {shape_name} (B {B}, S {S}, W {W:,}, fp32) "
                f"{name}: bit-equal to the plain version; kernel "
                f"{ms[name]:.4f} ms, plain {plain[name]:.3f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['bytes'] / 1e6:.1f} MB at "
                f"{bw / 1e12:.2f} TB/s), {100 * bd['bound_ms'] / ms[name]:.1f}% "
                f"of bound; no PyTorch call computes the recurrence")
        del a, b, g, h
        torch.cuda.empty_cache()
    return recs


def ssm_small_input_parity(torch, spec_kw, cells=None, cfg_kw=None,
                           tag="10c"):
    """Phase 10c: reduced falcon-mamba (2 layers) and recurrentgemma (3
    layers), float32, 2 rounds in the tree layout on the card (the scan,
    flash, edge and update kernels) and on the CPU (plain versions); the
    states agree to 1e-4.  Phase 14c: the same for falcon-mamba with
    ``cfg_kw`` (the fused output: the selective-scan kernels on the card,
    the reference's associative ``ssm_mix_fused`` on the CPU).  Returns
    ``{arch: max abs err}``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    out = {}
    for cell in cells or (MAMBA, RGEMMA):
        cfg = dataclasses.replace(
            get_config(cell.arch).reduced(n_layers=cell.n_layers),
            **(cfg_kw or {}))
        spec = api.FedSpec(**dict(spec_kw, n_agents=2))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        shape = InputShape("small", 64, 4, "train")
        batches = [make_batch_for(cfg, shape, gen, n_agents=2)
                   for _ in range(2)]
        states, counts = {}, {}
        for dev in ("cuda", "cpu"):
            tr = api.build_trainer(model, spec, dev)
            st, _ = tr.init(0, params=params)
            kernels.reset_launch_counts()
            for b in batches:
                st, _ = tr.step(st, b, u=torch.ones(2))
            states[dev], counts[dev] = st, kernels.launch_counts()
        err = max(float((getattr(states["cuda"], v)[n].cpu()
                         - getattr(states["cpu"], v)[n]).abs().max())
                  for v in ("x", "z") for n in states["cpu"].x)
        scans = 2 * 2 * N_EPOCHS * cell.scan_layers
        flash = 2 * 2 * N_EPOCHS * cell.attn_layers
        scan = "ssm_scan" if cfg.ssm_fused_output else "lru_scan"
        want = {"lru_scan_fwd": 0, "lru_scan_bwd": 0, "ssm_scan_fwd": 0,
                "ssm_scan_bwd": 0, f"{scan}_fwd": scans,
                f"{scan}_bwd": scans, "flash_attention_fwd": flash,
                "flash_attention_bwd": flash}
        got = {k: counts["cuda"][k] for k in want}
        if not err <= 1e-4 or got != want or set(counts["cpu"].values()) != {0}:
            fail(f"phase {tag} {cell.arch}: card vs CPU max abs err {err}, "
                 f"card launches {got} (want {want}), CPU {counts['cpu']}")
        log(f"phase {tag}: reduced {cell.arch} ({cfg.layer_kinds()}"
            f"{', fused output' if cfg.ssm_fused_output else ''}) fp32, "
            f"tree layout, 2 rounds, card (kernels: {got}) vs CPU (plain "
            f"versions): max abs err {err:.3g} (tolerance 1e-4)")
        out[cell.arch] = err
    return out


# ---------------------------------------------------------------------------
# Phase 11: segment_ranks and the dense front end
# ---------------------------------------------------------------------------

RANK_NS = (1, 2, 3, 5, 100)


def segment_ranks_small_checks(torch):
    """Phase 11a: the segment_ranks kernel bit-equal to its plain version;
    then, per segment, the ranks against the rank_select kernel."""
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    specials = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0,
                             -1.0], device=dev)
    n_checks = 0

    def check(x, segs, tag):
        nonlocal n_checks
        got = cops.segment_ranks(x, segments=segs)
        want = cref.segment_ranks_ref(x, segs)
        if not torch.equal(got, want):
            fail(f"segment_ranks {tag} segs={segs}: "
                 f"{int((got != want).sum())} ranks differ")
        n_checks += 1
        return got

    def against_topk(x, segs, ranks, tag):
        """where(ranks < k, x, 0) equal to the rank_select kernel's topk"""
        nonlocal n_checks
        for r in (0.01, 0.25):
            top = cops.rank_select(x, segments=segs, mode="topk", ratio=r)
            for s0, s1 in segs:
                k = cref.seg_k(r, s1 - s0)
                sel = torch.where(ranks[:, s0:s1] < k, x[:, s0:s1],
                                  torch.zeros_like(x[:, s0:s1]))
                kept = top[:, s0:s1]
                same = (sel == kept) | (torch.isnan(sel) & torch.isnan(kept))
                if not bool(same.all()):
                    fail(f"segment_ranks vs rank_select {tag} ratio={r} "
                         f"segment ({s0}, {s1})")
            n_checks += 1

    for dtype in (torch.float32, torch.bfloat16):
        for n in RANK_NS:
            for m in (1000, 1001):
                seg_sets = (None, ((17, m - 20),),
                            ((5, 300), (310, 700), (700, m - 5)))
                x = torch.randn((n, m), generator=gen, device=dev)
                x[0, ::97] = specials[torch.arange(x[0, ::97].numel(),
                                                   device=dev) % 7]
                ties = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0], device=dev)[
                    torch.randint(0, 5, (n, m), generator=gen, device=dev)]
                if n > 2:
                    ties[1] = 0.5             # all equal
                    ties[2] = 0.0             # all zero
                x, ties = x.to(dtype), ties.to(dtype)
                for segs in seg_sets:
                    check(x, segs, f"{dtype} N={n} M={m} randn+specials")
                    check(ties, segs, f"{dtype} N={n} M={m} ties")
                wide = torch.randn((n + 1, m), generator=gen,
                                   device=dev).to(dtype)
                check(wide[1:], seg_sets[2], f"{dtype} N={n} M={m} "
                      f"misaligned view")
                # kernel against kernel: where(rank < k, x, 0) is top-k
                segs = seg_sets[2]
                against_topk(x, segs, cops.segment_ranks(x, segments=segs),
                             f"{dtype} N={n} M={m}")
        x, segs = multi_chunk_input(torch, dtype, gen)
        tag = f"{dtype} multi-chunk M={x.shape[1]}"
        against_topk(x, segs, check(x, segs, tag), tag)
        wide = torch.empty((x.shape[0] + 1, x.shape[1]), dtype=dtype,
                           device=dev)
        wide[1:] = x                      # M is odd: rows start unaligned
        check(wide[1:], segs, f"{tag} misaligned view")
    torch.cuda.synchronize()
    log(f"phase 11a: {n_checks} segment_ranks checks bit-equal (fp32 and "
        f"bf16; N in {RANK_NS}; M = 1000 and 1001; no segments, one, and "
        f"several with leading, interior and trailing gaps; tie-heavy, "
        f"all-equal and all-zero rows, +-0.0, +-inf and NaN; a misaligned "
        f"view; N=5 over three chunks: rounded, all-equal and zero rows, a "
        f"tie run across chunk edges), and where(segment_ranks < k, x, 0) "
        f"equal to the rank_select kernel's topk per segment (ratios 0.01, "
        f"0.25)")


def segment_ranks_full_shape(torch, bw):
    """Phase 11b: the public op at the trainer's packed increment (4 x
    745,549,056 bf16, 18 packed segments): the path run (launches counted),
    bit-equal to the plain version run row by row, and timed beside the
    byte bound, the plain version and the yardstick ``torch.argsort(key,
    stable=True)`` per (row, interval) on the complemented key (the sort
    alone).  Returns ``(counts, {name: record})``."""
    from repro_torch.kernels import costs
    from repro_torch.launch.profile_analysis import SEGMENT_RANKS_STAGES
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.fed import runtime
    from repro_torch.fed.api import FedSpec
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    meta = runtime.packed_layout(build_model(cfg), FedSpec(
        n_agents=FULL_N, gamma=0.05, state_layout="packed"))
    segs, N, M = meta.segments, FULL_N, meta.width
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn((N, M), generator=gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = cops.segment_ranks(x, segments=segs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts != expected_counts(segment_ranks=1):
        fail(f"phase 11b: launch counts {counts}, want segment_ranks=1")
    intervals = cref.column_intervals(segs, M)
    for i in range(N):
        want = cref.segment_ranks_ref(x[i:i + 1], segs)
        if not torch.equal(got[i:i + 1], want):
            fail(f"phase 11b: row {i}: "
                 f"{int((got[i:i + 1] != want).sum())} ranks differ")
        del want
    del got
    torch.cuda.empty_cache()
    scratch = torch.empty((N, M), dtype=torch.int32, device=dev)

    def plain():
        for i in range(N):
            scratch[i:i + 1] = cref.segment_ranks_ref(x[i:i + 1], segs)
    plain_ms = cuda_ms(torch, plain, reps=3)
    del scratch
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: cops.segment_ranks(x, segments=segs))
    stages = profile_stages(torch, lambda: cops.segment_ranks(
        x, segments=segs), SEGMENT_RANKS_STAGES)
    torch.cuda.empty_cache()
    ckey = 0x7FFFFFFF - cref.magnitude_key(x)

    def lib():
        for i in range(N):
            for lo, hi, _ in intervals:
                torch.argsort(ckey[i, lo:hi], stable=True)
    lib_ms = cuda_ms(torch, lib, reps=3)
    del ckey, x
    torch.cuda.empty_cache()
    bytes_ = costs.segment_ranks(N, M, 2)[1]   # read bf16 x, write int32
    bound = bytes_ / bw * 1e3
    rec = dict(bytes=bytes_, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes", max_abs_err=0.0, library_ms=lib_ms,
               intervals=len(intervals), profiled_stages_ms=stages)
    log(f"phase 11b: segment_ranks ({N}x{M:,} bf16, {len(segs)} segments, "
        f"{len(intervals)} intervals) bit-equal to the plain version; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms (row by row into a scratch "
        f"output, median of 3), bound {bound:.3f} ms ({bytes_ / 1e9:.3f} GB at "
        f"{bw / 1e12:.2f} TB/s), {100 * bound / ms:.1f}% of bound; yardstick "
        f"torch.argsort(stable) per (row, interval) {lib_ms:.3f} ms; one "
        f"profiled call by stage (ms): "
        f"{ {k: round(v, 3) for k, v in stages.items()} }")
    return counts, {"segment_ranks": rec}


def profile_stages(torch, fn, stages):
    """Device ms of one profiled call of ``fn`` (synchronised here) by
    stage: ``{stage: ms}`` over the kernels whose names hold one of the
    stage's substrings."""
    from repro_torch.launch.profile_analysis import profile as profile_groups
    _, _, kernels_ms = profile_groups(
        lambda: (fn(), torch.cuda.synchronize()), width=None)
    split = {stage: sum(v for k, v in kernels_ms.items()
                        if any(n in k for n in names))
             for stage, names in stages.items()}
    if not any(split.values()):
        # seen in phase 11b of whole runs: the profile holds no device event
        log(f"profile_stages: no kernel of {list(stages)} in the profile; "
            f"it saw {[k[:80] for k in kernels_ms][:8]}")
    return split


PAPER_PROBLEM = dict(n_agents=100, q=250, dim=5, eps=0.5, seed=0)
TABLE5_PROBLEM = dict(PAPER_PROBLEM, dim=100)


def _state_err(torch, a, b):
    """Max abs difference of x, z and (when the exchange is compressed)
    t between a card state ``a`` and a CPU state ``b``."""
    return max(float((getattr(a, v).cpu() - getattr(b, v)).abs().max())
               for v in ("x", "z", "t") if getattr(a, v) is not None)


def dense_paper_runs(torch):
    """Phase 11c: the paper's problem through ``build_trainer(problem,
    FedSpec(rho=1, n_epochs=5))`` on the card and on the CPU with the same
    draws: 200 rounds, 50% participation with a given ``u`` over 400
    rounds, FedAvg's drift plateau, and ``||x_bar - x*||`` against
    ``solve()``.  Tolerances: the same ``hitting_round``; states 1e-5
    absolute (float32 reductions in another order on the card; Fed-PLT
    contracts, so the difference does not grow); FedAvg's plateau 1e-3
    relative (400 rounds of a drift that does not contract to a point);
    ``||x_bar - x*|| < 1e-4`` on the card."""
    from repro_torch.core.baselines import make_fedavg
    from repro_torch.core.metrics import hitting_round
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, build_trainer

    problem = make_logreg_problem(**PAPER_PROBLEM)
    out = {}

    def both(label, spec, rounds, **draws):
        res = {}
        for dev in ("cuda", "cpu"):
            tr = build_trainer(problem, spec, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, crit = tr.run(0, rounds, **draws)
            crit = crit.cpu().numpy()
            torch.cuda.synchronize()
            res[dev] = (tr, state, crit, time.perf_counter() - t0)
        hit = {d: hitting_round(r[2]) for d, r in res.items()}
        err = _state_err(torch, res["cuda"][1], res["cpu"][1])
        if hit["cuda"] != hit["cpu"] or hit["cuda"] is None:
            fail(f"phase 11c {label}: hitting rounds card {hit['cuda']} / "
                 f"CPU {hit['cpu']}")
        if not err <= 1e-5:
            fail(f"phase 11c {label}: card vs CPU states differ by {err}")
        ms = 1e3 * res["cuda"][3] / rounds
        log(f"phase 11c {label}: {rounds} rounds, hitting round "
            f"{hit['cuda']} on the card and the CPU, final criterion "
            f"{res['cuda'][2][-1]:.3e} / {res['cpu'][2][-1]:.3e}; card vs "
            f"CPU states {err:.3g} (tolerance 1e-5); card {ms:.3f} ms a round "
            f"(host clock over the run, one sync at the end)")
        out[label] = dict(rounds=rounds, hitting_round=hit["cuda"],
                          final_crit_card=float(res["cuda"][2][-1]),
                          final_crit_cpu=float(res["cpu"][2][-1]),
                          state_err=err, card_ms_per_round=ms)
        return res

    res = both("Fed-PLT N_e 5", FedSpec(rho=1.0, n_epochs=5), 200)
    tr, state = res["cuda"][0], res["cuda"][1]
    x_star = tr.problem.solve()
    dist = float(torch.linalg.norm(tr.consensus(state) - x_star))
    if not dist < 1e-4:
        fail(f"phase 11c: ||x_bar - x*|| = {dist} on the card")
    log(f"phase 11c: ||x_bar - x*|| = {dist:.3e} on the card (solve(): "
        f"20,000 GD steps on the card)")
    out["x_bar_minus_x_star"] = dist
    u = (torch.rand((400, problem.n_agents),
                    generator=torch.Generator().manual_seed(7)) < 0.5).float()
    both("Fed-PLT 50% participation (given u)",
         FedSpec(rho=1.0, n_epochs=5, participation=0.5), 400, u=u)
    plateau = {}
    for dev in ("cuda", "cpu"):
        crit = make_fedavg(problem.to(dev), gamma=0.1, n_epochs=5).run(0, 400)
        plateau[dev] = float(crit[-1])
    rel = abs(plateau["cuda"] - plateau["cpu"]) / plateau["cpu"]
    if not (plateau["cuda"] > 1e-5 and rel <= 1e-3):
        fail(f"phase 11c FedAvg: plateau card {plateau['cuda']} / CPU "
             f"{plateau['cpu']}")
    log(f"phase 11c FedAvg (gamma 0.1, N_e 5): plateau {plateau['cuda']:.4e} "
        f"on the card, {plateau['cpu']:.4e} on the CPU after 400 rounds "
        f"(client drift: never reaches 1e-5; relative difference {rel:.2e}, "
        f"tolerance 1e-3)")
    out["fedavg_plateau"] = plateau
    return out


DENSE_R = 20
# rounds in one profiler window, reported per round: a window can miss its
# first launches, which a round of the dense path (0.2 ms of device time)
# would feel
DENSE_PROFILED = 5


def dense_kernel_path(torch):
    """Phase 11d: the dense kernel path -- fused edges, packed state,
    ``use_fused_update`` (which the dense solver never takes), the fused
    compress backend, gamma given -- on the paper's problem and Table 5's
    n = 100: topk 0.25, int8, adaptive_topk (damping 0.5), trimmed_mean
    f = 5 with guards, coord_median with one evicted agent.  For each:
    ``DENSE_R`` rounds on the card, one synchronize a round, counted and
    timed; 5 rounds checked against the CPU round by round (each CPU round
    starts from the card's state: x, z and t agree to 1e-5, with no
    allowance for a compressor choice that flips); the increments
    ``z_new - t`` the card's compressed rounds hand the compressor,
    captured there, each held bit-equal to the plain versions under topk,
    adaptive_topk and int8 (the kernels at the dense path's own shapes,
    (100, 5) and (100, 100) with one segment); ``DENSE_PROFILED`` rounds
    under the profiler, reported per round.  Returns
    ``{cell: {run: record}}``."""
    from repro_torch.launch.profile_analysis import profile as profile_groups
    from repro_torch import kernels
    from repro_torch.core.fedplt import FedPLTState
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed import compress as fcompress
    from repro_torch.fed.api import CompressionSpec, FedSpec, build_trainer
    from repro_torch.kernels.compress import ops as cops
    from repro_torch.kernels.compress import ref as cref

    def held(dz, segments, what):
        """The compress kernels bit-equal to their plain versions on one
        captured increment."""
        for mode in ("topk", "adaptive_topk"):
            got = cops.rank_select(dz, segments=segments, mode=mode,
                                   ratio=0.25, energy=0.95)
            want = cref.rank_select_ref(dz, segments, mode, 0.25, 0.95)
            if not torch.equal(got, want):
                fail(f"phase 11d {what}: rank_select {mode} at "
                     f"{tuple(dz.shape)}: {int((got != want).sum())} "
                     f"entries differ from the plain version")
        got = cops.int8_quantize(dz, segments=segments)
        if not torch.equal(got, cref.int8_ref(dz, segments)):
            fail(f"phase 11d {what}: int8_quantize at {tuple(dz.shape)} "
                 f"differs from the plain version")

    def capturing(fn, into):
        def wrapped(x, **kw):
            if x.is_cuda:
                into.append((x.clone(), kw.get("segments")))
            return fn(x, **kw)
        return wrapped

    out = {}
    for cell, kw in (("paper (N 100, q 250, n 5)", PAPER_PROBLEM),
                     ("Table 5 (N 100, q 250, n 100)", TABLE5_PROBLEM)):
        problem = make_logreg_problem(**kw)
        N = problem.n_agents
        mu, L = problem.strong_convexity(), problem.smoothness()
        gamma = 2.0 / (L + mu + 2.0)           # gamma* at rho = 1, given
        base = dict(rho=1.0, n_epochs=5, gamma=gamma, engine_backend="fused",
                    state_layout="packed", use_fused_update=True)
        live = torch.ones(N)
        live[N - 1] = 0.0
        runs = {
            "topk 0.25": (dict(damping=0.5, compression=CompressionSpec(
                "topk", ratio=0.25, backend="fused")), dict(rank_select=1),
                None),
            "int8": (dict(damping=0.5, compression=CompressionSpec(
                "int8", backend="fused")), dict(int8_quantize=1), None),
            "adaptive_topk": (dict(damping=0.5, compression=CompressionSpec(
                "adaptive_topk", ratio=0.25, backend="fused")),
                dict(rank_select=1), None),
            "trimmed_mean f=5, guards": (dict(
                aggregator="trimmed_mean", aggregator_param=5,
                guard_increments=True), dict(sort_aggregate=1), None),
            "coord_median, agent 99 evicted": (dict(
                aggregator="coord_median"), dict(sort_aggregate=1), live),
        }
        out[cell] = {}
        for name, (extra, per_round, live_row) in runs.items():
            spec = FedSpec(**base, **extra)
            card = build_trainer(problem, spec)
            cpu = build_trainer(problem, spec, device="cpu")

            def step(tr, st):
                if live_row is None:
                    return tr.step(st)
                return tr.round_with_faults(st, None, None, live_row)[0]

            state = card.init(0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            dts = []
            for _ in range(DENSE_R):
                t0 = time.perf_counter()
                state = step(card, state)
                torch.cuda.synchronize()
                dts.append(1e3 * (time.perf_counter() - t0))
            counts = kernels.launch_counts()
            want = expected_counts(round_uplink=DENSE_R,
                                   round_downlink=DENSE_R,
                                   **{k: v * DENSE_R
                                      for k, v in per_round.items()})
            if counts != want:
                fail(f"phase 11d {cell} {name}: launch counts {counts}, "
                     f"want {want}")
            for v in ("x", "z"):
                if not bool(torch.isfinite(getattr(state, v)).all()):
                    fail(f"phase 11d {cell} {name}: non-finite {v}")
            crit = float(card.problem.criterion(state.x))
            # round-by-round check against the CPU, capturing the card's
            # compressor inputs where the engine's compressor calls the ops
            err, captured = 0.0, []
            st = card.init(0)
            fcompress.compress_ops = types.SimpleNamespace(
                rank_select=capturing(cops.rank_select, captured),
                int8_quantize=capturing(cops.int8_quantize, captured))
            try:
                for _ in range(5):
                    host = FedPLTState(
                        x=st.x.cpu(), z=st.z.cpu(), y=st.y.cpu(),
                        generator=torch.Generator().manual_seed(0), k=st.k,
                        t=None if st.t is None else st.t.cpu().clone())
                    st = step(card, st)
                    ref = step(cpu, host)
                    err = max(err, _state_err(torch, st, ref))
            finally:
                fcompress.compress_ops = cops
            if not err <= 1e-5:
                fail(f"phase 11d {cell} {name}: card vs CPU {err}")
            if st.t is not None and len(captured) != 5:
                fail(f"phase 11d {cell} {name}: {len(captured)} compressor "
                     f"calls captured in 5 card rounds, want 5")
            for dz, segments in captured:
                held(dz, segments, f"{cell} {name}")

            def profiled_rounds(st=state):
                for _ in range(DENSE_PROFILED):
                    st = step(card, st)
                torch.cuda.synchronize()

            wall, groups, kernels_ms = profile_groups(profiled_rounds)
            wall /= DENSE_PROFILED
            groups = {k: v / DENSE_PROFILED for k, v in groups.items()}
            kernels_ms = {k: v / DENSE_PROFILED
                          for k, v in kernels_ms.items()}
            busy = sum(groups.values())
            steady = statistics.median(dts[1:])
            rec = dict(round_ms=dts, steady_round_ms=steady, counts=counts,
                       final_crit=crit, card_vs_cpu=err,
                       increments_held=len(captured),
                       profile=dict(wall_ms=wall, device_busy_ms=busy,
                                    idle_share=(1 - busy / wall)
                                    if busy else None,
                                    groups_ms=groups,
                                    top_kernels_ms=dict(sorted(
                                        kernels_ms.items(),
                                        key=lambda kv: -kv[1])[:6])))
            out[cell][name] = rec
            log(f"phase 11d {cell} {name}: {DENSE_R} rounds, launches "
                f"{ {k: v for k, v in counts.items() if v} } (fedplt_update "
                f"0); steady round {steady:.3f} ms (median, one sync a "
                f"round); criterion {crit:.3e}; card vs CPU {err:.3g} "
                f"(x, z, t; tolerance 1e-5)"
                + (f"; {len(captured)} captured increments "
                   f"{tuple(captured[0][0].shape)} bit-equal under topk, "
                   f"adaptive_topk and int8" if captured else "")
                + "; "
                f"profiled ({DENSE_PROFILED} rounds) {wall:.3f} ms wall a "
                f"round, "
                + (f"device busy {busy:.3f} ms ({100 * (1 - busy / wall):.1f}% "
                   f"idle)" if busy else "the profiler saw no device time"))
            del card, cpu, state
            torch.cuda.empty_cache()
    return out


def private_pipeline(torch):
    """Phase 11e: the private pipeline of the paper on the card: Lemma 7's
    stabilizer, Prop. 4's noise calibration for (2.0, 1e-5)-ADP, noisy GD
    with ``dp_init`` for 300 rounds, the (eps, delta) report and
    Corollary 1's bound.  Checks a finite criterion and eps at the
    target."""
    from repro_torch.core import privacy, theory
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, PrivacySpec, build_trainer

    problem = make_logreg_problem(**PAPER_PROBLEM)
    mu, L = problem.strong_convexity(), problem.smoothness()
    K, delta, target = 300, 1e-5, 2.0
    stab = theory.stabilize(mu, L, n_epochs_grid=(5,))
    tau = privacy.calibrate_noise(target, delta, sensitivity=1.0, mu=mu,
                                  q=problem.q, gamma=stab.gamma, K=K,
                                  n_epochs=stab.n_epochs)
    trainer = build_trainer(problem, FedSpec(
        rho=stab.rho, gamma=stab.gamma, n_epochs=stab.n_epochs,
        privacy=PrivacySpec(tau=tau, dp_init=True, delta=delta)))
    rep = trainer.privacy_report(K)
    state, crit = trainer.run(0, K)
    crit = crit.cpu().numpy()
    bound = theory.corollary1_bound(
        K, mu, L, stab.rho, stab.gamma, stab.n_epochs, tau, problem.dim,
        problem.n_agents, r0=float(torch.linalg.norm(state.x)))
    if not (math.isfinite(float(crit[-1])) and rep.adp_eps <= target * 1.001):
        fail(f"phase 11e: criterion {crit[-1]}, eps {rep.adp_eps}")
    log(f"phase 11e: Lemma-7 stabilizer rho={stab.rho:.3f} gamma="
        f"{stab.gamma:.3f} N_e={stab.n_epochs} ||S||={stab.s_norm:.3f}; "
        f"tau = {tau:.4f} for ({target}, {delta})-ADP; achieved eps = "
        f"{rep.adp_eps:.3f} at Renyi order {rep.rdp_order:.1f}, ceiling "
        f"{rep.eps_ceiling:.3f}; after K={K} rounds criterion "
        f"{crit[-1]:.3e}, Corollary-1 bound {bound:.3e}")
    return dict(tau=tau, adp_eps=rep.adp_eps, final_crit=float(crit[-1]),
                corollary1_bound=bound)


# ---------------------------------------------------------------------------
# Phase 12: the model mesh axis, and sort_aggregate beyond 128 agents
# ---------------------------------------------------------------------------

# 12a: (N, M) of the checks above 128 agents, each route's boundaries from
# both sides: the warp route's lane groups of 8 to 32 threads (N 129-1024),
# the block route's groups of 2 to 16 warps (N 1025-16,384), and the global
# scratch route past it (N 16,385 and 40,000)
ROBUST_TILE_NM = ((129, 1000), (129, 1001), (200, 1000), (256, 1000),
                  (257, 1001), (1000, 1001), (1024, 1000), (1025, 1001),
                  (4096, 64), (16384, 16), (16385, 8), (40000, 8))
# the timed calls: (N, M) at the paper's N 100 (P 128, the warp route's
# 4-lane groups; 3.39 GB in bf16) and at 1000 agents (P 1024, a whole warp
# a column); trimmed_mean trims N / 10 a side
ROBUST_TIMED = ((100, 1 << 24), (1000, 1 << 20))
INT32_PEAK = 132 * 64 * 1.755e9     # H100 SXM: 64 INT32 lanes an SM, 1.755 GHz


def robust_tile_checks(torch, bw, timed=True):
    """Phase 12a: sort_aggregate above 128 agents bit-equal to its plain
    version (NaN by position) on the route each N takes, then (``timed``)
    the timed records; returns ``{name: record}`` for the kernel table's
    variants."""
    from repro_torch.kernels.robust_agg import kernel as rkernel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def lives(n):
        ev = torch.ones(n, device=dev)
        ev[::3] = 0.0
        one = torch.zeros(n, device=dev)
        one[n // 2] = 1.0
        return {"all live": None, "evictions": ev, "one live": one,
                "all dead": torch.zeros(n, device=dev)}

    n_checks = robust_checks(
        torch, gen, ROBUST_TILE_NM,
        lambda n: (("trimmed_mean", 0), ("trimmed_mean", 1),
                   ("trimmed_mean", (n - 1) // 3),
                   ("trimmed_mean", (n - 1) // 2), ("coord_median", 0)),
        lives, "phase 12a")
    routes = {n: rkernel.route_of(n)[0] for n, _ in ROBUST_TILE_NM}
    log(f"phase 12a: {n_checks} sort_aggregate checks above 128 agents "
        f"bit-equal (NaN by position), each on its route (the launcher's "
        f"tallies): {routes}, fp32 and bf16, trims 0 / 1 / N/3 / max and "
        f"coord_median, all live / evictions / one live / all dead, ties, "
        f"+-0.0, +-inf, NaN; phase 2 holds N <= 128")
    return robust_timed(torch, bw) if timed else {}


def robust_timed(torch, bw, plain=True, shapes=ROBUST_TIMED):
    """sort_aggregate timed at ``shapes``, bf16 and fp32, trimmed_mean (f
    N/10) and coord_median, all rows live: kernel ms (CUDA events, median
    of 7) beside the byte bound and the network's operation bound; with
    ``plain``, each result bit-equal to the plain version (column slabs),
    its time, and ``torch.sort(x, dim=0)`` as the yardstick of the sort
    alone.  Runs against whichever ``repro_torch`` is imported (the parent
    tree's too: it reads no route tally)."""
    from repro_torch.kernels import costs
    from repro_torch.kernels.costs import network_ops
    from repro_torch.kernels.robust_agg import ops as rops
    from repro_torch.kernels.robust_agg.ref import robust_aggregate_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    recs = {}
    for n, m in shapes:
        slab = 1 << (18 if n <= 128 else 16)
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            x = torch.randn((n, m), generator=gen, device=dev, dtype=dtype)
            live = torch.ones(n, device=dev)
            sort_ms = (cuda_ms(torch, lambda: torch.sort(x, dim=0), reps=3)
                       if plain else None)
            torch.cuda.empty_cache()
            for stat, f in (("trimmed_mean", n // 10), ("coord_median", 0)):
                run = lambda: rops.robust_aggregate(x, live, stat=stat, trim=f)
                pms = None
                if plain:
                    got = run()
                    want = torch.empty_like(got)

                    def plain_fn():
                        for c in range(0, m, slab):
                            want[:, c:c + slab] = robust_aggregate_ref(
                                x[:, c:c + slab], live, stat=stat, trim=f)

                    plain_fn()
                    same_bits(torch, got, want,
                              f"sort_aggregate timed N={n} M={m} {dt} {stat}")
                    pms = cuda_ms(torch, plain_fn, reps=3)
                    del got, want
                ms = cuda_ms(torch, run)
                bytes_ = costs.sort_aggregate(n, m, x.element_size(),
                                              dtype)[1]
                byte_ms = bytes_ / bw * 1e3
                net_ms = network_ops(n, m, dtype) / INT32_PEAK * 1e3
                name = f"sort_aggregate[N={n},{dt},{stat}]"
                recs[name] = dict(
                    ms=ms, plain_ms=pms, bound_ms=byte_ms, bound_by="bytes",
                    network_bound_ms=net_ms, max_abs_err=0.0,  # bit-equal
                    library_ms=None, sort_yardstick_ms=sort_ms)
                log(f"sort_aggregate timed: {stat} f={f} ({n}x{m} {dt}) "
                    f"kernel {ms:.3f} ms, plain {pms} ms, byte bound "
                    f"{byte_ms:.3f} ms ({bytes_ / 1e9:.3f} GB; "
                    f"{100 * byte_ms / ms:.1f}%), network bound {net_ms:.3f} "
                    f"ms ({100 * net_ms / ms:.1f}%); torch.sort(x, dim=0) "
                    f"{sort_ms} ms")
            del x
            torch.cuda.empty_cache()
    return recs


# 12b: the model-axis cases (reduced gemma2-2b, fp32, N 4, 3 rounds);
# name -> (spec kwargs, step kwargs, compressor of the near-tie allowance)
MODEL_AXIS_CASES = {
    "mean": ({}, {}, None),
    "topk": ({"compression": ("topk", 0.25)}, {}, "topk"),
    "int8": ({"compression": ("int8", 0.25)}, {}, "int8"),
    "trimmed_mean": (dict(aggregator="trimmed_mean", aggregator_param=1,
                          guard_increments=True),
                     {"corrupt": "flip", "live": [1.0, 1.0, 1.0, 0.0]},
                     None),
    "norm_clip_mean": (dict(aggregator="norm_clip_mean",
                            aggregator_param=0.5, guard_increments=True),
                       {"corrupt": "flip"}, None),
    "noisy_gd clip 1": ({"privacy": (0.05, 1.0)}, {}, None),
}
MODEL_MESHES = {2: "1x2", 4: "2x2"}


def _model_axis_rounds(torch, case, device, mesh_shape=None):
    """3 rounds of reduced gemma2-2b (fp32, N 4, participation 0.75) on
    ``device`` under one of :data:`MODEL_AXIS_CASES`: returns ``(state,
    launch counts, losses, increments)`` (this rank's block under a mesh;
    the increments ``z_r - t_{r-1}`` of a compressed run)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    spec_kw, step_kw, _ = MODEL_AXIS_CASES[case]
    spec_kw = dict(spec_kw)
    if "compression" in spec_kw:
        name, ratio = spec_kw.pop("compression")
        spec_kw["compression"] = api.CompressionSpec(name, ratio=ratio)
    if "privacy" in spec_kw:
        tau, clip = spec_kw.pop("privacy")
        spec_kw["privacy"] = api.PrivacySpec(tau=tau, clip=clip)
    step_kw = dict(step_kw)
    if step_kw.get("corrupt") == "flip":
        flip = torch.zeros((FULL_N, 2))
        flip[1, 0] = -1.0
        step_kw["corrupt"] = flip
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [make_batch_for(cfg, InputShape("small", 64, 8, "train"), gen,
                              n_agents=FULL_N) for _ in range(3)]
    tr = api.build_trainer(model, api.FedSpec(
        n_agents=FULL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
        participation=0.75, state_layout="packed", engine_backend="fused",
        use_fused_update=True, mesh_shape=mesh_shape, **spec_kw), device)
    st, tgen = tr.init(0, params=params)
    kernels.reset_launch_counts()
    losses, increments = [], []
    for b in batches:
        t_prev = None if st.t is None else st.t.clone()
        st, m = tr.step(st, b, tgen, **step_kw)
        losses.append(float(m["loss"]))
        if t_prev is not None:
            increments.append((st.z - t_prev).cpu())
    return st, kernels.launch_counts(), losses, increments


def _near_tie_columns(torch, increments, segments, compressor):
    """The ``(1, width)`` columns where an increment entry sat on a
    near-tie of the compressor in some round: topk, a magnitude rank
    within 3 of its (agent, segment)'s kept count; int8, ``|x| / scale``
    within 0.01 of a half (``tests/test_torch_rounds_sharded.py``)."""
    from repro_torch.kernels.compress.ref import INV_127, seg_k

    near = None
    for dz in increments:
        cur = torch.zeros(dz.shape, dtype=torch.bool)
        for a, b in segments:
            mag = dz[:, a:b].abs()
            if compressor == "int8":
                r = mag / (mag.amax(dim=1, keepdim=True) * INV_127).clamp_min(
                    1e-30)
                cur[:, a:b] = (r - torch.floor(r) - 0.5).abs() < 0.01
                continue
            k = seg_k(0.25, b - a)
            desc = torch.sort(mag, dim=1, descending=True).values
            cur[:, a:b] = ((mag <= desc[:, max(k - 4, 0)][:, None])
                           & (mag >= desc[:, min(k + 2, b - a - 1)][:, None]))
        near = cur if near is None else near | cur
    return near.any(dim=0, keepdim=True)


EDGE_TREE = {"a": (1000,), "b": (37, 3), "c": (555,)}


def model_axis_edges(torch, mesh, dtype, device):
    """The round's column-local pieces on this rank's column block of
    seeded full-width inputs (N 4, three leaves with alignment gaps):
    the lagged uplink's ``y`` and ``v``, the downlink's ``x`` and ``z``,
    the compressors' ``q`` (topk, int8) and the trimmed mean's broadcast
    row, each as the launched kernels give it.  Returns them on the CPU."""
    from repro_torch.core import prox as prox_lib
    from repro_torch.fed import compress as fcompress
    from repro_torch.fed import engine, robust, sharding

    meta = fcompress.packed_meta({k: torch.empty((FULL_N,) + s, dtype=dtype,
                                                 device="meta")
                                  for k, s in EDGE_TREE.items()})
    g = torch.Generator().manual_seed(12)
    z, t, w, x = (torch.randn((FULL_N, meta.width), generator=g).to(dtype)
                  for _ in range(4))
    cols = sharding.model_cols(mesh, meta.width)
    blk = lambda a: a[:, cols].contiguous().to(device)
    u = torch.tensor([1.0, 0.0, 1.0, 1.0], device=device)
    live = torch.tensor([1.0, 1.0, 0.0, 1.0])
    prox = prox_lib.make_prox("weight_decay", weight=0.01)
    out = {}
    for comp in ("topk", "int8"):
        cfg = engine.RoundConfig(n_agents=FULL_N, damping=0.65,
                                 engine_backend="fused",
                                 state_layout="packed", compression=comp,
                                 compress_backend="fused")
        y, v = engine.coordinator_edge_packed(cfg, blk(z), blk(t), meta, prox,
                                              mesh)
        xn, zn = engine.agent_edge_packed(cfg, u, blk(w), blk(x), blk(z), y,
                                          blk(t), prox, mesh)
        out.update(y=y, v=v, x=xn, z=zn)
        out[f"q {comp}"] = fcompress.compress_increment_packed(
            zn - blk(t), meta, cfg, mesh)
    out["trimmed_mean"] = robust.robust_seen_packed(
        blk(z), live, name="trimmed_mean", param=1, meta=meta,
        backend="fused", mesh=mesh)
    return {k: v.cpu() for k, v in out.items()}, (cols.start, cols.stop)


# 12d: the dense front end on meshes of gloo ranks
DENSE_MESHES = {2: ("2x1", "1x2"), 4: ("2x2",)}
DENSE_MESH_RUNS = {
    # name -> (problem, spec kwargs, rounds, given participation rows)
    "Fed-PLT N_e 5, n 5": (PAPER_PROBLEM, {}, 200, None),
    "Fed-PLT N_e 5, n 100": (TABLE5_PROBLEM, {}, 200, None),
    "50% participation, n 5": (PAPER_PROBLEM, {"participation": 0.5}, 400,
                               0.5),
}


def _dense_mesh_run(torch, label, device, mesh_shape=None):
    """One of :data:`DENSE_MESH_RUNS` (packed, fused edges): returns the
    criterion history (global) and the seconds a round."""
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, build_trainer

    prob_kw, kw, rounds, p = DENSE_MESH_RUNS[label]
    draws = {}
    if p is not None:
        draws["u"] = (torch.rand((rounds, prob_kw["n_agents"]),
                                 generator=torch.Generator().manual_seed(7))
                      < p).float()
    tr = build_trainer(make_logreg_problem(**prob_kw, device="cpu"), FedSpec(
        rho=1.0, n_epochs=5, state_layout="packed", engine_backend="fused",
        mesh_shape=mesh_shape, **kw), device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, crit = tr.run(0, rounds, **draws)
    crit = crit.cpu().numpy()
    return crit, (time.perf_counter() - t0) / rounds


def _dense_robust_mesh(torch, device, mesh_shape, n_agents, trim):
    """20 rounds of trimmed_mean f=``trim`` with guards (the
    sort_aggregate kernel on the gathered agent column) on ``n_agents``
    agents of the paper's problem: returns the last criterion and the
    launch counts."""
    from repro_torch import kernels
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, build_trainer

    tr = build_trainer(make_logreg_problem(**dict(PAPER_PROBLEM,
                                                  n_agents=n_agents),
                                           device="cpu"),
                       FedSpec(rho=1.0, n_epochs=5, gamma=0.1,
                               state_layout="packed", engine_backend="fused",
                               aggregator="trimmed_mean",
                               aggregator_param=trim, guard_increments=True,
                               mesh_shape=mesh_shape), device=device)
    kernels.reset_launch_counts()
    _, crit = tr.run(0, DENSE_R)
    return float(crit[-1]), kernels.launch_counts()


# 12c's rounds: each is 22-30 s of gloo staging through host memory (the
# full-width rounds on one rank run in phases 4-8 and 13)
FW_ROUNDS = 1


def _full_width_rank(torch, mesh_shape):
    """12c on one rank: gemma2-2b at published width, 2 layers, bf16, the
    main path's spec under ``mesh_shape``, :data:`FW_ROUNDS` rounds; per
    round the loss, the seconds and the launch counts, then the peak
    memory and the state block's shape."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=N_LAYERS)
    tr = api.build_trainer(build_model(cfg), api.FedSpec(
        n_agents=FULL_N, n_epochs=N_EPOCHS, gamma=0.05, weight_decay=0.01,
        state_layout="packed", engine_backend="fused", use_fused_update=True,
        mesh_shape=mesh_shape), "cuda:0")
    st, gen = tr.init(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shape = InputShape("cli", MAIN_SEQ, MAIN_BATCH, "train")
    rounds = []
    for _ in range(FW_ROUNDS):
        b = make_batch_for(cfg, shape, gen, n_agents=FULL_N, device=tr.device)
        kernels.reset_launch_counts()
        t0 = time.time()
        st, m = tr.step(st, b, gen)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rounds.append(dict(loss=loss, s=time.time() - t0,
                           counts=kernels.launch_counts()))
    finite = bool(torch.isfinite(st.x).all())
    return dict(rounds=rounds, peak=torch.cuda.max_memory_allocated(),
                shape=tuple(st.x.shape), finite=finite)


def _gloo_staging(torch, device):
    """What gloo takes on this device's tensors (all_reduce of float32,
    bf16, int32, int16) and the seconds of one all_reduce of a 512 MB
    bf16 buffer and of its int32 view between the ranks."""
    import torch.distributed as dist

    takes = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.int16):
        try:
            dist.all_reduce(torch.ones(8, dtype=dt, device=device))
            takes[str(dt)] = True
        except RuntimeError:    # gloo's refusal of a dtype is the record
            takes[str(dt)] = False
    x = torch.zeros(1 << 28, dtype=torch.bfloat16, device=device)
    secs = {}
    for name, t in (("bf16", x), ("int32 view", x.view(torch.int32))):
        dist.all_reduce(t)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t)
        if device != "cpu":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    return {"takes": takes, "all_reduce_512MB_s": secs}


def _mesh_rank_worker(rank, world, store, out_dir, device):
    """12b-12d on one of ``world`` gloo ranks spawned on the one card
    (``device`` "cuda:0"; a rehearsal on the CPU passes "cpu" and skips
    12c)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    if device != "cpu":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # a rank that waits on a dead peer fails within minutes, not hours
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        from repro_torch.launch.mesh import make_fed_mesh

        res = {"rounds": {}, "dense": {}}
        shape = MODEL_MESHES[world]
        for case in MODEL_AXIS_CASES:
            st, counts, losses, _ = _model_axis_rounds(torch, case, device,
                                                       shape)
            res["rounds"][case] = dict(
                x=st.x.cpu(), z=st.z.cpu(),
                t=None if st.t is None else st.t.cpu(), counts=counts,
                losses=losses)
        if world == 2:
            res["gloo"] = _gloo_staging(torch, device)
            mesh = make_fed_mesh(1, 2, device=device)
            res["edges"] = {str(d): model_axis_edges(torch, mesh, d, device)
                            for d in (torch.float32, torch.bfloat16)}
        for dshape in DENSE_MESHES[world]:
            for label in DENSE_MESH_RUNS:
                res["dense"][dshape, label] = _dense_mesh_run(
                    torch, label, device, dshape)
        if world == 4:
            res["dense robust"] = _dense_robust_mesh(torch, device, "2x2",
                                                     100, 5)
        else:
            res["dense robust"] = _dense_robust_mesh(torch, device, "2x1",
                                                     200, 5)
            if device != "cpu":
                torch.cuda.empty_cache()
                res["full width"] = _full_width_rank(torch, "1x2")
        torch.save(res, os.path.join(out_dir, f"mesh{world}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn_mesh_ranks(torch, world, out, device):
    """Spawn ``world`` gloo ranks on the card; returns None, or the
    reason gloo refused a CUDA tensor (the one allowed drop)."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_mesh_rank_worker,
                           args=(world, os.path.join(out, f"store{world}"),
                                 out, device),
                           nprocs=world, join=True, start_method="spawn")
    except Exception as e:
        text = str(e)
        last = (text.strip().splitlines() or [type(e).__name__])[-1]
        if not GLOO_REFUSES_CUDA.search(text):
            fail(f"phase 12: a rank of the {world}-rank run failed: {last}")
        return last
    return None


def _assemble(torch, blocks, model, width):
    """The global ``(N, width)`` state from the ranks' blocks (rank
    ``r * model + c`` holds agent block r, model block c)."""
    rows = []
    for r in range(len(blocks) // model):
        own = blocks[r * model:(r + 1) * model]
        rows.append(own[0] if own[0].shape[1] == width
                    else torch.cat(own, 1))
    return torch.cat(rows)


def _full_width_checks(fw):
    """12c's checks of the two ranks' full-width runs; returns their
    record."""
    for k, r in enumerate(fw):
        if not r["finite"]:
            fail(f"phase 12c: rank {k} has a non-finite state")
        if r["shape"] != (FULL_N, FULL_M // 2):
            fail(f"phase 12c: rank {k} holds {r['shape']}, want "
                 f"{(FULL_N, FULL_M // 2)}")
        for i, rd in enumerate(r["rounds"]):
            want_c = expected_counts(1, round_uplink_partial=1,
                                     round_downlink_presummed=1,
                                     fedplt_update=N_EPOCHS)
            if rd["counts"] != want_c:
                fail(f"phase 12c: rank {k} round {i} launches {rd['counts']}, "
                     f"want {want_c}")
            if not math.isfinite(rd["loss"]) or rd["loss"] != fw[0]["rounds"][
                    i]["loss"]:
                fail(f"phase 12c: rank {k} round {i} loss {rd['loss']} (rank "
                     f"0: {fw[0]['rounds'][i]['loss']})")
    rec = dict(
        losses=[rd["loss"] for rd in fw[0]["rounds"]],
        round_s=[[rd["s"] for rd in r["rounds"]] for r in fw],
        peak_gb=[r["peak"] / 1e9 for r in fw], block=list(fw[0]["shape"]))
    log(f"phase 12c: gemma2-2b ({N_LAYERS} layers, {FULL_M:,} parameters, "
        f"bf16, N {FULL_N}, batch {MAIN_BATCH}, seq {MAIN_SEQ}, N_e "
        f"{N_EPOCHS}, gd) under mesh_shape 1x2 on two gloo ranks on the "
        f"card, {FW_ROUNDS} round(s): losses {rec['losses']} on both "
        f"ranks; each "
        f"rank holds the state block {fw[0]['shape']} and launches per round "
        f"partial 1, presummed 1, fedplt_update {N_EPOCHS}, flash "
        f"{FULL_N * N_EPOCHS * N_LAYERS} forward and "
        f"{FULL_N * N_EPOCHS * N_LAYERS} backward, unsharded edges 0; peak "
        f"device memory per rank {[round(v, 2) for v in rec['peak_gb']]} "
        f"GB; round seconds {[[round(s, 2) for s in v] for v in rec['round_s']]} "
        f"(gloo stages every model-group collective through host memory: a "
        f"correctness cell, not a speed figure)")
    return rec


def model_mesh_phase(torch, device="cuda"):
    """Phase 12b-12d: the unsharded references in this process, then the
    2- and 4-rank spawns on the card, each held to them.  Returns a
    record for the JSON line.  (``device="cpu"`` rehearses it on gloo
    ranks of the CPU, without 12c.)"""
    import tempfile

    from repro_torch.core.metrics import hitting_round
    from repro_torch.fed import compress as fcompress
    from repro_torch.fed import sharding
    from repro_torch.fed.api import FedSpec
    from repro_torch.kernels.robust_agg.kernel import route_of

    want = {c: _model_axis_rounds(torch, c, device) for c in MODEL_AXIS_CASES}
    one = FedSpec(mesh_shape="1x1").build_mesh(device)
    edges = {str(d): model_axis_edges(torch, one, d, device)[0]
             for d in (torch.float32, torch.bfloat16)}
    dense = {label: _dense_mesh_run(torch, label, device)
             for label in DENSE_MESH_RUNS}
    if device != "cpu":
        torch.cuda.empty_cache()
    out = tempfile.mkdtemp()
    worker_device = "cpu" if device == "cpu" else "cuda:0"
    rec = {"12b": {}, "12d": {}}
    got = {}
    for world in (2, 4):
        t0 = time.time()
        dropped = _spawn_mesh_ranks(torch, world, out, worker_device)
        if dropped is not None:
            log(f"phase 12 dropped: gloo on this build refuses CUDA tensors: "
                f"{dropped}")
            return {"dropped": dropped}
        got[world] = [torch.load(os.path.join(out, f"mesh{world}-rank{r}.pt"),
                                 weights_only=False)
                      for r in range(world)]
        log(f"phase 12: {world} gloo ranks on the card ran in "
            f"{time.time() - t0:.1f} s")

    # 12b: whole rounds against the unsharded card run
    for world, ranks in got.items():
        shape = MODEL_MESHES[world]
        agents, model = (int(e) for e in shape.split("x"))
        for case, (_, _, comp) in MODEL_AXIS_CASES.items():
            st, c0, losses, incr = want[case]
            meta_segments = None
            worst, flips = 0.0, 0
            for var in ("x", "z", "t"):
                w = getattr(st, var)
                if w is None:
                    continue
                w = w.cpu()
                blocks = [r["rounds"][case][var] for r in ranks]
                if {b.shape for b in blocks} != {(FULL_N // agents,
                                                  w.shape[1] // model)}:
                    fail(f"phase 12b {shape} {case}: {var} blocks "
                         f"{[tuple(b.shape) for b in blocks]}")
                g = _assemble(torch, blocks, model, w.shape[1])
                bad = ~((g - w).abs() <= 1e-6 + 1e-5 * w.abs())
                if comp is not None and bool(bad.any()):
                    if meta_segments is None:
                        meta_segments = _reduced_segments(torch)
                    near = _near_tie_columns(torch, incr, meta_segments, comp)
                    if bool((bad & ~near).any()) or int(
                            bad.any(0).sum()) > w.shape[1] // 500:
                        fail(f"phase 12b {shape} {case}: {var} differs off "
                             f"the near-ties ({int((bad & ~near).sum())}) or "
                             f"in {int(bad.any(0).sum())} columns")
                    flips = max(flips, int(bad.any(0).sum()))
                    g = torch.where(bad, w, g)
                elif bool(bad.any()):
                    fail(f"phase 12b {shape} {case}: {var} differs from the "
                         f"unsharded card run beyond rtol 1e-5 / atol 1e-6 "
                         f"(max abs {float((g - w).abs().max())})")
                worst = max(worst, float((g - w).abs().max()))
            for r in ranks:
                if not all(abs(a - b) <= 1e-5 * abs(b) for a, b in
                           zip(r["rounds"][case]["losses"], losses)):
                    fail(f"phase 12b {shape} {case}: losses "
                         f"{r['rounds'][case]['losses']} vs {losses}")
            counts = ranks[0]["rounds"][case]["counts"]
            if device != "cpu" and (
                    counts["round_uplink_partial"],
                    counts["round_downlink_presummed"],
                    counts["round_uplink"], counts["round_downlink"]) != (
                        3, 3, 0, 0):
                fail(f"phase 12b {shape} {case}: launches {counts}")
            for k in ("rank_select", "int8_quantize", "sort_aggregate"):
                if counts[k] != c0[k]:
                    fail(f"phase 12b {shape} {case}: {k} {counts[k]} launches, "
                         f"the unsharded run {c0[k]}")
            rec["12b"][f"{shape} {case}"] = dict(max_abs=worst,
                                                 flipped_columns=flips)
            log(f"phase 12b {shape} {case}: reduced gemma2-2b fp32, 3 rounds, "
                f"{world} gloo ranks on the card against the unsharded card "
                f"run: max abs {worst:.3g} (rtol 1e-5, atol 1e-6"
                + (f"; {flips} columns on a {comp} near-tie" if comp else "")
                + f"); rank 0 launches partial={counts['round_uplink_partial']}, "
                f"presummed={counts['round_downlink_presummed']}, "
                f"rank_select={counts['rank_select']}, "
                f"int8={counts['int8_quantize']}, "
                f"sort_aggregate={counts['sort_aggregate']}")

    # 12b: the edges alone, bit for bit against the 1x1 mesh's columns
    for dtype, full in edges.items():
        for r in got[2]:
            blocks, (c0, c1) = r["edges"][dtype]
            for k, v in full.items():
                if not torch.equal(blocks[k].view(torch.int16 if
                                                  v.dtype == torch.bfloat16
                                                  else torch.int32),
                                   v[:, c0:c1].contiguous().view(
                                       torch.int16 if v.dtype == torch.bfloat16
                                       else torch.int32)):
                    fail(f"phase 12b edges {dtype}: the 1x2 rank's {k} block "
                         f"(columns {c0}:{c1}) differs from the 1x1 mesh's")
    log(f"phase 12b edges: on the same z, t, w, x and u the two 1x2 ranks' "
        f"blocks of y, v, x, z (round_uplink_partial, round_downlink_presummed), "
        f"q (rank_select topk, int8_quantize) and the trimmed mean "
        f"(sort_aggregate) equal the 1x1 mesh's columns bit for bit, fp32 "
        f"and bf16, {FULL_N} agents, three leaves with alignment gaps")

    # 12c: the main path at full width on two ranks, beside what gloo's
    # host staging costs between them
    gloo = got[2][0]["gloo"]
    rec["gloo"] = gloo
    log(f"phase 12c gloo between two ranks on the card: all_reduce takes "
        f"{gloo['takes']}; 512 MB all-reduced in "
        f"{ {k: round(v, 3) for k, v in gloo['all_reduce_512MB_s'].items()} } s "
        f"(the model group's collectives at full width are 1.49 GB each)")
    fw = [r["full width"] for r in got[2] if "full width" in r]
    if device != "cpu" and len(fw) != 2:
        fail("phase 12c: the two ranks returned no full-width run")
    if fw:
        rec["12c"] = _full_width_checks(fw)

    # 12d: the dense front end against the unsharded card run
    for world, ranks in got.items():
        for (dshape, label), (crit, s) in ranks[0]["dense"].items():
            base_crit = dense[label][0]
            for r in ranks[1:]:
                if not (r["dense"][dshape, label][0] == crit).all():
                    fail(f"phase 12d {dshape} {label}: ranks disagree on the "
                         f"criterion")
            hit, base_hit = hitting_round(crit), hitting_round(base_crit)
            ratio = float(crit[-1] / base_crit[-1])
            # the same order, unless both sit at the criterion's float32
            # floor (a squared norm of a sum that cancels: ~1e-10)
            floor = max(crit[-1], base_crit[-1]) <= 1e-8
            if hit != base_hit or not (floor or 0.1 <= ratio <= 10.0):
                fail(f"phase 12d {dshape} {label}: hitting round {hit} "
                     f"(unsharded {base_hit}), final criterion {crit[-1]:.3e} "
                     f"(unsharded {base_crit[-1]:.3e})")
            rec["12d"][f"{dshape} {label}"] = dict(
                hitting_round=hit, final_crit=float(crit[-1]),
                unsharded_final_crit=float(base_crit[-1]), s_per_round=s)
            log(f"phase 12d {dshape} {label}: hitting round {hit} (unsharded "
                f"card run {base_hit}), final criterion {crit[-1]:.3e} "
                f"(unsharded {base_crit[-1]:.3e}); {1e3 * s:.2f} ms a round "
                f"(gloo-staged collectives)")
        crit, counts = ranks[0]["dense robust"]
        n_agents = 200 if world == 2 else 100
        if (device != "cpu" and counts["sort_aggregate"] != DENSE_R
                or not math.isfinite(crit)):
            fail(f"phase 12d robust N {n_agents}: launches {counts}, last "
                 f"criterion {crit}")
        rec["12d"][f"robust N {n_agents}"] = dict(final_crit=crit,
                                                  counts=counts)
        log(f"phase 12d trimmed_mean f=5 with guards, N {n_agents}, "
            f"{'2x1' if world == 2 else '2x2'} mesh: sort_aggregate "
            f"{counts['sort_aggregate']} launches in {DENSE_R} rounds on the "
            f"gathered agent column (the {route_of(n_agents)[0]} route on a "
            f"card), "
            f"last criterion {crit:.3e}")
    return rec


# ---------------------------------------------------------------------------
# Phase 13: the untied LM head, the vocab-chunked loss, the new configs
# ---------------------------------------------------------------------------

# 13a: (arch, layers, config changes) of the reduced models; 128 is 4
# chunks of the reduced 512-token vocab; gemma3-12b's 6 layers run its
# global layer; nemotron's head dim at its published 192
LM_REDUCED = (("phi4-mini-3.8b", 2, dict(chunked_loss=128)),
              ("gemma3-12b", 6, {}),
              ("nemotron-4-340b", 2, dict(head_dim=192, chunked_loss=128)))
# 13c: (cell, chunk, chunks, first-round loss tolerance).  phi4 has no
# final softcap: both paths round the same bf16 products, so 1e-3
# relative.  gemma2's full-logit path softcaps the bf16 logits in bf16,
# the chunked path in float32: each softcapped logit moves by at most
# 2^-9 of its magnitude, which moves the gold logit and the log-sum-exp
# by at most 2^-9 max|z| each; at the random init max|z| is below the
# loss (ln 256,000 = 12.45), so 2^-8 relative
CHUNKED = ((PHI4, 25_008, 8, 1e-3), (GEMMA, 32_000, 8, 2.0 ** -8))


def chunks_of(torch, vocab: int, chunk: int, want: int) -> int:
    """The number of vocab chunks a loss takes (a chunk that does not
    divide the vocab is one chunk); fails unless it is ``want``."""
    from repro_torch.models.layers import vocab_chunk

    n = vocab // vocab_chunk(vocab, chunk)
    if n != want:
        fail(f"chunked_loss {chunk} over a vocab of {vocab}: {n} chunks, "
             f"want {want}")
    return n


def lm_head_parity(torch):
    """Phase 13a: the reduced phi4-mini-3.8b, gemma3-12b and nemotron-4-340b
    (float32), 2 rounds and one topk round, N 4, packed, fused backend
    and update, on the card (kernels) and the CPU (plain versions)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    base = dict(n_agents=FULL_N, n_epochs=N_EPOCHS, gamma=0.05,
                weight_decay=0.01, state_layout="packed",
                engine_backend="fused", use_fused_update=True)
    out = {}
    for arch, n_layers, kw in LM_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(n_layers=n_layers),
                                  **kw)
        if cfg.chunked_loss:
            chunks_of(torch, cfg.vocab, cfg.chunked_loss, 4)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        shape = InputShape("small", 64, 2 * FULL_N, "train")
        batches = [make_batch_for(cfg, shape, gen, n_agents=FULL_N)
                   for _ in range(2)]
        topk = api.CompressionSpec("topk", ratio=0.25)
        for label, spec, rounds, extra in (
                ("", api.FedSpec(**base), 2, {}),
                (" topk 0.25", api.FedSpec(**base, compression=topk), 1,
                 dict(rank_select=1))):
            states, counts, losses = {}, {}, {}
            for dev in ("cuda", "cpu"):
                tr = api.build_trainer(model, spec, dev)
                st, _ = tr.init(0, params=params)
                kernels.reset_launch_counts()
                losses[dev] = []
                for b in batches[:rounds]:
                    st, m = tr.step(st, b, u=torch.ones(FULL_N))
                    losses[dev].append(float(m["loss"]))
                states[dev], counts[dev] = st, kernels.launch_counts()
            what = f"phase 13a {arch}{label}"
            flash = rounds * FULL_N * N_EPOCHS * n_layers
            want = expected_counts(
                round_uplink=rounds, round_downlink=rounds,
                fedplt_update=rounds * N_EPOCHS, flash_attention_fwd=flash,
                flash_attention_bwd=flash, **extra)
            if counts["cuda"] != want or set(counts["cpu"].values()) != {0}:
                fail(f"{what}: launches card {counts['cuda']}, CPU "
                     f"{counts['cpu']}; want {want} and none")
            if not all(map(math.isfinite, losses["cuda"])):
                fail(f"{what}: losses {losses['cuda']}")
            err, flips = card_vs_cpu(torch, states, what)
            out[f"{arch}{label}"] = dict(max_abs_err=err, flips=flips,
                                         losses=losses["cuda"])
            log(f"{what}: reduced ({n_layers} layers {cfg.layer_kinds()}, "
                f"head dim {cfg.resolved_head_dim}, "
                f"{'tied' if cfg.tie_embeddings else 'untied'} head, "
                f"chunked_loss {cfg.chunked_loss}) fp32, {rounds} rounds, "
                f"card (kernels: {want['flash_attention_fwd']} flash "
                f"launches each way) vs CPU: max abs err {err:.3g} "
                f"(tolerance 1e-4)" + (f", {flips} entries that follow a "
                                       f"near-tie top-k swap" if flips
                                       else ""))
    return out


def chunked_variant(torch, spec, cell, chunk, n_chunks, tol, plain):
    """Phase 13c: ``cell``'s full-width run with ``chunked_loss = chunk``
    beside its full-logit run ``plain`` (``(history, peak, profile)`` of
    the same script run)."""
    from repro_torch.configs import get_config

    chunks_of(torch, get_config(cell.arch).vocab, chunk, n_chunks)
    prof = {}
    label = f"phase 13c {cell.arch} chunked_loss {chunk} ({n_chunks} chunks)"
    _, hist, peak = train_phase(
        torch, label, spec, 3,
        expected_counts(3, cell, round_uplink=3, round_downlink=3,
                        fedplt_update=6), profile=True, cell=cell,
        cfg_kw=dict(chunked_loss=chunk), profile_out=prof)
    p_hist, p_peak, p_prof = plain
    first, p_first = hist[0]["loss"], p_hist[0]["loss"]
    rel = abs(first - p_first) / abs(p_first)
    if not rel <= tol:
        fail(f"{label}: first-round loss {first} against the full logits' "
             f"{p_first} (relative {rel:.3g} > {tol:.3g})")
    groups = ("other elementwise/reduction", "matmul")
    rec = {"chunk": chunk, "chunks": n_chunks,
           "first_loss": first, "unchunked_first_loss": p_first,
           "first_loss_rel": rel, "tolerance": tol,
           "round_ms": [1e3 * h["dt"] for h in hist],
           "unchunked_round_ms": [1e3 * h["dt"] for h in p_hist],
           "peak_gb": peak / 1e9, "unchunked_peak_gb": p_peak / 1e9,
           "groups_ms": {g: prof.get("groups_ms", {}).get(g)
                         for g in groups},
           "unchunked_groups_ms": {g: p_prof.get("groups_ms", {}).get(g)
                                   for g in groups}}
    log(f"{label}: first-round loss {first:.6f} (full logits {p_first:.6f}, "
        f"relative {rel:.3g}, tolerance {tol:.3g}); steady rounds "
        f"{[round(v, 2) for v in rec['round_ms'][1:]]} ms (full logits "
        f"{[round(v, 2) for v in rec['unchunked_round_ms'][1:]]}); peak "
        f"{peak / 1e9:.2f} GB (full logits {p_peak / 1e9:.2f}); profiled "
        f"round {rec['groups_ms']} (full logits {rec['unchunked_groups_ms']})")
    return rec


# ---------------------------------------------------------------------------
# Phase 14: the SSM block's fused output (the selective-scan kernels)
# ---------------------------------------------------------------------------

# falcon-mamba-7b's scan in the full-width trainer: B (8 sequences over 4
# agents), S, d_inner, state
SSM_FULL = (MAIN_BATCH // FULL_N, MAIN_SEQ, 8192, 16)
# 14a: (B, S, d_in, n) -- S 1, 7 and 513 over 128-step spans; d_in 5 and
# 100 not a multiple of a block's 64 channels
SSM_SMALL = tuple((B, S, d, n) for B, S in ((1, 1), (2, 7), (2, 513))
                  for d in (5, 100) for n in (4, 16))
# 14a: (B, S, d_in, n) reaching every (G, K) instantiation: ragged
# channel tails (d_in past a 64-channel block) and step tails (S past an
# 8-step sub-span or a 32-step forward tile), and shapes with none
SSM_ROUTE_SHAPES = (
    (2, 41, 130, 1), (1, 40, 65, 2), (2, 33, 64, 3), (2, 9, 127, 4),
    (2, 100, 70, 7), (1, 64, 128, 8), (2, 71, 129, 13), (2, 96, 192, 16),
    (2, 65, 100, 16), (1, 64, 64, 16), (2, 50, 66, 25), (1, 32, 64, 32))
# 14d: the chained blocks of the memory probe (falcon-mamba-7b's depth)
SSM_STACK_LAYERS = 64
# 14d: (label, config changes) of the three full-width forms
SSM_FORMS = (("float32", dict(ssm_fused_output=True)),
             ("float32 seq", dict(ssm_fused_output=True, ssm_inner="seq")),
             ("bfloat16", dict(ssm_fused_output=True,
                               ssm_scan_dtype="bfloat16")))


def ssm_inputs(torch, gen, B, S, d_in, n, u_dtype):
    """``(dt, u, B, C, A, D, gy)`` on the card: dt in (1e-3, 0.2) as the
    softplus gives it, A = -exp(A_log) near the init's -(1..n)."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = 0.2 * torch.rand((B, S, d_in), generator=gen, device=dev) + 1e-3
    A = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev,
                                          dtype=torch.float32))
                   + 0.1 * rnd(d_in, n))
    return (dt, rnd(B, S, d_in).to(u_dtype), rnd(B, S, n), rnd(B, S, n), A,
            rnd(d_in), rnd(B, S, d_in))


def ssm_routes_run(before, after):
    """The launches of each (G, K) instantiation between two
    ``ssm_route_counts()`` readings: ``{"fwd": {(G, K): n}, "bwd": ..}``
    with the instantiations that ran."""
    return {d: {gk: after[d][gk] - before[d][gk] for gk in after[d]
                if after[d][gk] != before[d][gk]} for d in after}


def ssm_check(torch, ins, scan_dtype, tag):
    """The kernels (through the ops) against their plain versions on
    ``ins``, bit for bit (y; ddt, du, dB, dC, dA, dD), and the backward
    twice with the same bits; the library's tallies must show the
    instantiation the state plans, once forward and twice backward.
    Returns ``{"fwd": .., "bwd": ..}``, the max abs errors."""
    from repro_torch.kernels.lru_scan import kernel as lkernel
    from repro_torch.kernels.lru_scan import ops as lops
    from repro_torch.kernels.lru_scan import ref as lref

    dt, u, Bm, Cm, A, D, gy = ins
    G, K = lkernel.ssm_plan(A.shape[1])[:2]
    before = lkernel.ssm_route_counts()
    y, ckpt = lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D, scan_dtype)
    want_y = lref.ssm_scan_ref(dt, u, Bm, Cm, A, D, scan_dtype)
    same_bits(torch, y, want_y, f"ssm_scan fwd {tag}")
    err = {"fwd": float((y - want_y).abs().max()), "bwd": 0.0}
    grads = lops.ssm_scan_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype)
    want = lref.ssm_scan_bwd_ref(dt, u, Bm, Cm, A, D, gy, scan_dtype)
    again = lops.ssm_scan_bwd(dt, u, Bm, Cm, A, D, ckpt, gy, scan_dtype)
    for name, g, w, g2 in zip(("ddt", "du", "dB", "dC", "dA", "dD"), grads,
                              want, again):
        same_bits(torch, g, w, f"ssm_scan bwd {name} {tag}")
        same_bits(torch, g2, g, f"ssm_scan bwd {name} {tag}, second run")
        err["bwd"] = max(err["bwd"], float((g - w).abs().max()))
    ran = ssm_routes_run(before, lkernel.ssm_route_counts())
    if ran != {"fwd": {(G, K): 1}, "bwd": {(G, K): 2}}:
        fail(f"ssm_scan {tag}: the tallies show {ran}, not G {G} K {K} "
             f"once forward and twice backward")
    return err


def ssm_small_checks(torch):
    """Phase 14a: the selective-scan kernels bit-equal to their plain
    versions (``kernels/lru_scan/ref.py``), each check on the (G, K)
    instantiation its state plans (the library's tallies read before and
    after): :data:`SSM_SMALL` shapes, u float32 and bfloat16, scan dtype
    float32 and bfloat16; n 1, 5, 17 and 32; every instantiation at
    :data:`SSM_ROUTE_SHAPES` (ragged channel and step tails and none),
    both u and scan dtypes; the backward twice with the same bits;
    the library's plan, block width and checkpoint span against
    ``kernel.ssm_plan`` and ``ref.block_channels``; the autograd Function;
    both kernels launched from a fresh thread."""
    from repro_torch.kernels.lru_scan import kernel as lkernel
    from repro_torch.kernels.lru_scan import ops as lops
    from repro_torch.kernels.lru_scan import ref as lref

    gen = torch.Generator(device="cuda").manual_seed(14)
    if lkernel.ssm_library_ckpt_steps() != lkernel.SSM_CKPT_STEPS:
        fail(f"phase 14a: the library checkpoints every "
             f"{lkernel.ssm_library_ckpt_steps()} steps, kernel.py "
             f"{lkernel.SSM_CKPT_STEPS}")
    for n in range(1, lkernel.SSM_MAX_STATE + 1):
        got = lkernel.ssm_library_plan(n)
        want = lkernel.ssm_plan(n)
        if got != want or want[2] != lref.block_channels(n):
            fail(f"phase 14a: the library plans n {n} as {got}, kernel.py "
                 f"{want}, ref.py {lref.block_channels(n)} channels a block")
    n_checks = 0
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in SSM_SMALL:
        for u_dtype in (f32, bf16):
            for scan in (f32, bf16):
                ins = ssm_inputs(torch, gen, *shape, u_dtype)
                ssm_check(torch, ins, scan, f"{shape} u {u_dtype} scan {scan}")
                n_checks += 1
    for n in (1, 5, 17, 32):
        for scan in (f32, bf16):
            ins = ssm_inputs(torch, gen, 2, 37, 70, n, bf16)
            ssm_check(torch, ins, scan, f"n {n} scan {scan}")
            n_checks += 1
    routes = {}
    for shape in SSM_ROUTE_SHAPES:
        gk = lkernel.ssm_plan(shape[3])[:2]
        for u_dtype in (f32, bf16):
            for scan in (f32, bf16):
                ins = ssm_inputs(torch, gen, *shape, u_dtype)
                ssm_check(torch, ins, scan, f"{shape} G {gk[0]} K {gk[1]} "
                          f"u {u_dtype} scan {scan}")
                routes[gk] = routes.get(gk, 0) + 1
                n_checks += 1
    if set(routes) != set(lkernel.SSM_ROUTES):
        fail(f"phase 14a: the route shapes reached {sorted(routes)}, not "
             f"every instantiation {lkernel.SSM_ROUTES}")
    # the autograd Function on a bf16 u, as the model calls it
    dt, u, Bm, Cm, A, D, gy = ssm_inputs(torch, gen, 2, 129, 48, 16, bf16)
    leaves = [t.clone().requires_grad_() for t in (dt, u, Bm, Cm, A, D)]
    y = lops.ssm_scan(*leaves, f32)
    got = torch.autograd.grad(y, leaves, gy)
    same_bits(torch, y.detach(), lref.ssm_scan_ref(dt, u, Bm, Cm, A, D),
              "SsmScan forward")
    want = lref.ssm_scan_bwd_ref(dt, u, Bm, Cm, A, D, gy)
    for name, g, w in zip(("dt", "u", "B", "C", "A", "D"), got, want):
        same_bits(torch, g, w.to(g.dtype), f"SsmScan grad {name}")
    y, ckpt = lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D)
    fresh_thread_launches(torch, {
        "ssm_scan_fwd": lambda: lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D)[0],
        "ssm_scan_bwd": lambda: lops.ssm_scan_bwd(dt, u, Bm, Cm, A, D, ckpt,
                                                  gy)})
    torch.cuda.synchronize()
    log(f"phase 14a: {n_checks} ssm_scan checks bit-equal to the plain "
        f"versions (y; ddt, du, dB, dC, dA, dD), each backward twice with "
        f"the same bits and on its planned (G, K) by the library's tallies: "
        f"(B, S, d_in, n) in {list(SSM_SMALL)}, u and scan dtype float32 "
        f"and bfloat16; n 1, 5, 17, 32; the "
        f"instantiations {sorted(routes)} at {len(SSM_ROUTE_SHAPES)} "
        f"shapes with ragged channel and step tails; the autograd Function "
        f"(B 2, S 129, d_in 48, bf16 u); both kernels from a fresh thread")
    return n_checks


def ssm_timings(torch, ins, scan_dtype):
    """The forward and the backward through the ops on ``ins``, timed:
    ``{"fwd": {"ms", "device_ms"}, "bwd": ..}`` (:func:`cuda_ms`,
    :func:`device_ms`), and the bytes of the checkpoints that the forward
    returns."""
    from repro_torch.kernels.lru_scan import ops as lops

    dt, u, Bm, Cm, A, D, gy = ins
    ckpt = lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D, scan_dtype)[1]
    calls = {"fwd": lambda: lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D,
                                              scan_dtype),
             "bwd": lambda: lops.ssm_scan_bwd(dt, u, Bm, Cm, A, D, ckpt, gy,
                                              scan_dtype)}
    out = {name: {"ms": cuda_ms(torch, fn), "device_ms": device_ms(torch, fn)}
           for name, fn in calls.items()}
    out["ckpt_bytes"] = ckpt.numel() * ckpt.element_size()
    return out


def ssm_full_shape(torch, bw):
    """Phase 14b: the kernels at falcon-mamba-7b's scan (B 2, S 512, d_in
    8192, n 16, bf16 u), scan dtype float32 and bfloat16, bit-equal to the
    plain versions and timed (:func:`ssm_timings`; plain median of 3)
    beside the bound.  No PyTorch call computes the function."""
    from repro_torch.launch.roofline import ssm_bounds
    from repro_torch.kernels.lru_scan import kernel as lkernel
    from repro_torch.kernels.lru_scan import ref as lref

    gen = torch.Generator(device="cuda").manual_seed(15)
    B, S, d_in, n = SSM_FULL
    ins = ssm_inputs(torch, gen, B, S, d_in, n, torch.bfloat16)
    dt, u, Bm, Cm, A, D, gy = ins
    bounds = ssm_bounds(bw, B, S, d_in, n, 2)
    G, K = lkernel.ssm_plan(n)[:2]
    recs = {}
    for scan in (torch.float32, torch.bfloat16):
        tag = str(scan).replace("torch.", "")
        err = ssm_check(torch, ins, scan, f"14b {tag}")
        times = ssm_timings(torch, ins, scan)
        plain = {"fwd": cuda_ms(torch, lambda: lref.ssm_scan_ref(
                     dt, u, Bm, Cm, A, D, scan), reps=3),
                 "bwd": cuda_ms(torch, lambda: lref.ssm_scan_bwd_ref(
                     dt, u, Bm, Cm, A, D, gy, scan), reps=3)}
        for name in ("fwd", "bwd"):
            bd = bounds[name]
            rec = dict(shape=list(SSM_FULL), scan_dtype=tag, lanes=[G, K],
                       max_abs_err=err[name], plain_ms=plain[name],
                       library_ms=None, **times[name], **bd)
            recs[f"ssm_scan_{name}" + ("" if scan == torch.float32
                                       else "[bf16 scan]")] = rec
            log(f"phase 14b (B {B}, S {S}, d_in {d_in}, n {n}, bf16 u, "
                f"{tag} scan, G {G} K {K}) {name}: bit-equal to the plain "
                f"version; kernel {rec['ms']:.4f} ms a call (device "
                f"{rec['device_ms']:.4f} ms, "
                f"{100 * bd['bound_ms'] / rec['device_ms']:.1f}% of bound), "
                f"plain {rec['plain_ms']:.2f} "
                f"ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                f"({bd['bytes'] / 1e6:.1f} MB, {bd['flops']:,} float "
                f"operations, {bd['exps']:,} exp), "
                f"{100 * bd['bound_ms'] / rec['ms']:.1f}% of bound; no "
                f"PyTorch call computes the function")
    del ins, dt, u, Bm, Cm, A, D, gy
    torch.cuda.empty_cache()
    return recs


def ssm_block_memory(torch):
    """Phase 14d's probe: the peak device memory that one full-width
    falcon-mamba-7b block's forward and backward (B 2, S 512, bf16; the
    gradients of x and of every parameter) add to what is allocated before,
    fused output and not; the fused one must stay under one (B, S, d_in,
    n) float32 tensor."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as tssm

    cfg = get_config("falcon-mamba-7b")
    B, S, d_in, n = SSM_FULL
    state = B * S * d_in * n * 4
    gen = torch.Generator(device="cuda").manual_seed(16)
    params = {k: v.requires_grad_() for k, v in tssm.init_mamba(
        gen, cfg, torch.bfloat16, device="cuda").items()}
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    out = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, ssm_fused_output=fused)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = tssm.mamba_forward(params, x, c)
        grads = torch.autograd.grad(y, [x, *params.values()],
                                    torch.ones_like(y))
        torch.cuda.synchronize()
        out["fused" if fused else "unfused"] = (
            torch.cuda.max_memory_allocated() - before)
        del y, grads
    del params, x
    torch.cuda.empty_cache()
    log(f"phase 14d probe: one block's forward + backward adds "
        f"{out['fused'] / 1e9:.3f} GB of peak memory with the fused output, "
        f"{out['unfused'] / 1e9:.3f} GB without (one (B, S, d_in, n) float32 "
        f"state is {state / 1e9:.3f} GB)")
    if not out["fused"] < state:
        fail(f"phase 14d probe: the fused block adds {out['fused']:,} bytes, "
             f"not under the state's {state:,}")
    return {k: v / 1e9 for k, v in out.items()} | {"state_gb": state / 1e9}


def ssm_stack_memory(torch, layers=SSM_STACK_LAYERS):
    """Phase 14d's second probe: one full-width falcon-mamba-7b block's
    weights with the fused output, applied ``layers`` times in a chain (B
    2, S 512, bf16): the device memory the forward keeps for the backward
    (allocated after it less before), a layer's share, and the peak of the
    forward and backward above what was allocated before."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as tssm

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              ssm_fused_output=True)
    B, S = SSM_FULL[:2]
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = {k: v.requires_grad_() for k, v in tssm.init_mamba(
        gen, cfg, torch.bfloat16, device="cuda").items()}
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = x
    for _ in range(layers):
        y = tssm.mamba_forward(params, y, cfg)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    grads = torch.autograd.grad(y, [x, *params.values()], torch.ones_like(y))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del y, grads, params, x
    torch.cuda.empty_cache()
    out = {"layers": layers, "kept_gb": kept / 1e9,
           "kept_per_layer_gb": kept / layers / 1e9, "peak_gb": peak / 1e9}
    log(f"phase 14d probe: {layers} chained fused blocks (B {B}, S {S}, "
        f"bf16) keep {out['kept_gb']:.3f} GB for the backward "
        f"({out['kept_per_layer_gb']:.4f} GB a layer); forward + backward "
        f"peak {out['peak_gb']:.3f} GB")
    return out


def ssm_fused_phase(torch, ssm_base):
    """Phase 14c and 14d; returns ``(counts of the float32 form, record)``."""
    from repro_torch.fed.api import FedSpec

    rec = {"14c": ssm_small_input_parity(
        torch, ssm_base, cells=(MAMBA,), cfg_kw=dict(ssm_fused_output=True),
        tag="14c")}
    scans = 3 * FULL_N * N_EPOCHS * MAMBA.scan_layers
    runs = {}
    for form, kw in SSM_FORMS:
        label = f"phase 14d/{MAMBA.arch} fused output, {form} scan"
        prof = {}
        counts, hist, peak = train_phase(
            torch, label, FedSpec(**ssm_base), 3,
            expected_counts(3, MAMBA, fedplt_update=3 * N_EPOCHS *
                            MAMBA.n_leaves, lru_scan_fwd=0, lru_scan_bwd=0,
                            ssm_scan_fwd=scans, ssm_scan_bwd=scans),
            profile=True, cell=MAMBA, cfg_kw=kw, profile_out=prof)
        if peak > 80e9:
            fail(f"{label}: peak device memory {peak / 1e9:.2f} GB")
        runs[form] = {"counts": counts, "peak_gb": peak / 1e9,
                      "round_ms": [1e3 * h["dt"] for h in hist],
                      "losses": [h["loss"] for h in hist],
                      "profile": {k: prof.get(k) for k in (
                          "wall_ms", "device_busy_ms", "idle_share",
                          "groups_ms", "ssm_scan_fwd", "ssm_scan_bwd")}}
    seq, assoc = runs["float32 seq"], runs["float32"]
    if seq["losses"] != assoc["losses"] or seq["counts"] != assoc["counts"]:
        fail(f"phase 14d: ssm_inner seq gave losses {seq['losses']} and "
             f"counts {seq['counts']}, assoc {assoc['losses']} and "
             f"{assoc['counts']}: one kernel on the card, so they must agree")
    log(f"phase 14d: seq and assoc gave the same losses "
        f"{assoc['losses']} (one kernel on the card)")
    rec["14d"] = runs
    rec["14d_memory_probe"] = ssm_block_memory(torch)
    rec["14d_stack_probe"] = ssm_stack_memory(torch)
    return assoc["counts"], rec


def _reduced_segments(torch):
    """The packed segments of 12b's reduced gemma2-2b state."""
    from repro_torch.configs import get_config
    from repro_torch.fed import api
    from repro_torch.fed.runtime import packed_layout
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    return packed_layout(build_model(cfg),
                         api.FedSpec(n_agents=FULL_N)).segments


def sort_aggregate_times(torch, src: str) -> int:
    """``--sort-aggregate-times [--src DIR]``: build ``robust_agg.cu`` of the
    ``repro_torch`` under ``DIR`` (default this checkout's ``src``), print
    its ptxas lines, and time :data:`ROBUST_TIMED` without the plain
    version: one JSON line.  Two trees are compared in one call by running
    this once for each, in turns."""
    from repro_torch.kernels import build
    from repro_torch.kernels.robust_agg import kernel as rkernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    for text in build.build_all([rkernel.SOURCE]).values():
        for kname, regs, st, ld in build.ptxas_summary(text):
            log(f"ptxas: {short_kernel_name(kname)}: {regs} registers, "
                f"spill stores {st} B, loads {ld} B")
    recs = robust_timed(torch, card_bandwidth(torch.cuda.get_device_name(0)),
                        plain=False)
    log(json.dumps({"sort_aggregate_times": recs, "src": src, "card": smi}))
    return 0


def _ssm_build(torch):
    """Build ``ssm_scan.cu`` of the ``repro_torch`` on the path, print its
    ptxas lines and the card; returns the card's nvidia-smi line."""
    from repro_torch.kernels import build
    from repro_torch.kernels.lru_scan import kernel as lkernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    for text in build.build_all([lkernel.SSM_SOURCE]).values():
        for kname, regs, st, ld in build.ptxas_summary(text):
            log(f"ptxas: {short_kernel_name(kname)}: {regs} registers, "
                f"spill stores {st} B, loads {ld} B")
    return smi


def ssm_scan_phases(torch) -> int:
    """``--ssm-scan``: build ``ssm_scan.cu``, run phases 14a and 14b, and
    print 14b's records as one JSON line."""
    smi = _ssm_build(torch)
    ssm_small_checks(torch)
    recs = ssm_full_shape(torch, card_bandwidth(torch.cuda.get_device_name(0)))
    log(json.dumps({"ssm_scan_times": recs, "card": smi}))
    return 0


def ssm_times(torch, src) -> int:
    """``--ssm-times [--src DIR]``: build ``ssm_scan.cu`` of the
    ``repro_torch`` under ``DIR`` (default this checkout's ``src``), hold
    its forward's y at 14b's shape bit-equal to its plain version, time
    both kernels there (:func:`ssm_timings`, float32 and bfloat16 scan)
    and run the chained-block memory probe; one JSON line.  Two trees are
    compared in one call by running this once for each, in turns."""
    from repro_torch.kernels.lru_scan import ops as lops
    from repro_torch.kernels.lru_scan import ref as lref

    smi = _ssm_build(torch)
    gen = torch.Generator(device="cuda").manual_seed(15)
    ins = ssm_inputs(torch, gen, *SSM_FULL, torch.bfloat16)
    dt, u, Bm, Cm, A, D, _ = ins
    recs = {}
    for scan in (torch.float32, torch.bfloat16):
        tag = str(scan).replace("torch.", "")
        same_bits(torch, lops.ssm_scan_fwd(dt, u, Bm, Cm, A, D, scan)[0],
                  lref.ssm_scan_ref(dt, u, Bm, Cm, A, D, scan),
                  f"--ssm-times {tag} y")
        recs[tag] = ssm_timings(torch, ins, scan)
        log(f"ssm_scan times ({tag} scan): fwd {recs[tag]['fwd']}, bwd "
            f"{recs[tag]['bwd']}, checkpoints {recs[tag]['ckpt_bytes']:,} B")
    del ins, dt, u, Bm, Cm, A, D
    torch.cuda.empty_cache()
    recs["stack_probe"] = ssm_stack_memory(torch)
    log(json.dumps({"ssm_times": recs, "src": src, "card": smi}))
    return 0


def ssm_rounds(torch, src) -> int:
    """``--ssm-rounds [--src DIR]``: phases 14c and 14d (the three
    full-width fused forms, the profiled rounds, the block memory probe)
    with the ``repro_torch`` under ``DIR`` (default this checkout's
    ``src``), as one JSON line: run once for each of two trees, in turns,
    to compare their rounds on one card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    base = dict(n_agents=FULL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
                state_layout="tree", engine_backend="fused",
                use_fused_update=True)
    _, rec = ssm_fused_phase(torch, base)
    log(json.dumps({"ssm_rounds": rec, "src": src, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# Phases 15-17: standard training, resumed rounds, serving
# ---------------------------------------------------------------------------

STD_STEPS = 3                       # phase 15's standard steps
RESUME_CASES = (                    # phase 16: (label, dtype, spec fields)
    ("bf16 gd", "bfloat16", {}),
    ("fp32 gd", "float32", {}),
    ("fp32 topk 0.25", "float32", {"compression": ("topk", 0.25)}),
    ("bf16 noisy_gd (tau 0.01)", "bfloat16", {"privacy": (0.01, 1.0)}),
    ("qwen2-moe fp32 gd", "float32", {"arch": QWEN.arch}),
)
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
# (arch, layers) of 17c: recurrentgemma-2b's 3 reduced layers hold its local
# attention layer
DECODE_CELLS = (("gemma2-2b", 2), ("falcon-mamba-7b", 2),
                ("recurrentgemma-2b", 3))


def _scratch_dir():
    """A directory under the checkout's git-ignored ``build/`` for the
    checkpoints of phases 16 and 17 (removed by the caller)."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt-",
                            dir=os.path.join(ROOT, "build"))


def standard_phase(torch):
    """Phase 15: gemma2-2b at published width cut to 2 layers, bf16,
    batch 8, seq 512, AdamW, ``STD_STEPS`` standard steps through
    ``run_standard``.  Gates: finite losses and parameters, the parameter
    count, and flash forward and backward launches of one per attention
    layer a step (nothing else launches).  Returns ``(params, record)``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_standard

    cfg = dataclasses.replace(get_config(GEMMA.arch), n_layers=GEMMA.n_layers)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    params, hist = run_standard(cfg, optimizer="adamw", lr=1e-3,
                                steps=STD_STEPS, seq_len=MAIN_SEQ,
                                batch=MAIN_BATCH, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_counts(
        flash_attention_fwd=STD_STEPS * GEMMA.attn_layers,
        flash_attention_bwd=STD_STEPS * GEMMA.attn_layers)
    n = sum(p.numel() for p in params.values())
    if n != GEMMA.n_params:
        fail(f"phase 15: {n} parameters, want {GEMMA.n_params:,}")
    if counts != want:
        fail(f"phase 15: launch counts {counts}, want {want}")
    if not all(math.isfinite(h["loss"]) for h in hist) or not all(
            bool(torch.isfinite(p).all()) for p in params.values()):
        fail(f"phase 15: non-finite loss or parameters ({hist})")
    step_ms = [1e3 * h["dt"] for h in hist]
    log(f"phase 15 standard mode: gemma2-2b (2 layers, {n:,} params, bf16), "
        f"AdamW, batch {MAIN_BATCH} x seq {MAIN_SEQ}, {STD_STEPS} steps: "
        f"losses {[round(h['loss'], 4) for h in hist]}, step ms "
        f"{[round(v, 2) for v in step_ms]} (steady {step_ms[1:]}), peak "
        f"{peak / 1e9:.2f} GB; flash launches {want['flash_attention_fwd']} "
        f"fwd / {want['flash_attention_bwd']} bwd")
    return params, {"step_ms": step_ms, "losses": [h["loss"] for h in hist],
                    "peak_gb": peak / 1e9,
                    "flash_launches": want["flash_attention_fwd"]}


def _resume_spec(fields):
    from repro_torch.fed.api import CompressionSpec, FedSpec, PrivacySpec

    kw = dict(n_agents=FULL_N, n_epochs=N_EPOCHS, gamma=0.05,
              weight_decay=0.01, state_layout="packed",
              engine_backend="fused", use_fused_update=True)
    if "compression" in fields:
        name, ratio = fields["compression"]
        kw["compression"] = CompressionSpec(name, ratio=ratio)
    if "privacy" in fields:
        tau, clip = fields["privacy"]
        kw["privacy"] = PrivacySpec(tau=tau, clip=clip)
    if "async" in fields:
        K, p = fields["async"]
        kw.update(async_mode="stale", max_staleness=K, participation=p)
    return FedSpec(**kw)


def resume_phase(torch, cases=RESUME_CASES, legs=3, tag="16"):
    """Phase 16 (and 20d): reduced gemma2-2b (and reduced qwen2-moe, the
    case whose fields name its arch), N 4, packed, fused edges and update,
    on the card: 2 x ``legs`` rounds against ``legs`` rounds, a
    checkpoint, ``resume`` and ``legs`` more (``run_fed`` with
    ``checkpoint_every=legs``), for each of ``cases``.  Gates: ``x``,
    ``z``, ``t`` and the async carriers ``y_tag`` and ``staleness`` equal
    bit for bit, and so the last checkpoint's arrival rows; the
    uninterrupted run's launches equal the two legs' together and the
    legs' launches equal each other (so the second leg launches what the
    uninterrupted run's last rounds launch)."""
    import shutil

    from repro_torch import kernels
    from repro_torch.checkpoint import checkpoint_extra
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_fed

    out = {}
    root = _scratch_dir()
    try:
        for label, dtype, fields in cases:
            cfg = dataclasses.replace(
                get_config(fields.get("arch", "gemma2-2b")).reduced(),
                dtype=dtype)
            spec = _resume_spec(fields)
            kw = dict(seq_len=64, batch=8, device="cuda",
                      checkpoint_every=legs, log=lambda *a: None)
            case = label.split()[0] + "-" + label.split()[1]
            runs, last = {}, f"step-{2 * legs:06d}"
            for leg, steps, resume, where in (
                    ("whole", 2 * legs, False, "whole"),
                    ("first", legs, False, "split"),
                    ("second", 2 * legs, True, "split")):
                kernels.reset_launch_counts()
                _, state, hist = run_fed(
                    cfg, spec, steps=steps, resume=resume,
                    checkpoint=os.path.join(root, case, where), **kw)
                torch.cuda.synchronize()
                runs[leg] = (state, kernels.launch_counts(), hist)
            whole, split = runs["whole"][0], runs["second"][0]
            held = [v for v in ("x", "z", "t", "y_tag", "staleness")
                    if getattr(whole, v) is not None]
            for var in ("x", "z", "t", "y_tag", "staleness"):
                a, b = getattr(whole, var), getattr(split, var)
                if (a is None) != (b is None) or (a is not None and not (
                        a.dtype == b.dtype and torch.equal(
                            a.view(torch.int16), b.view(torch.int16)))):
                    fail(f"phase {tag} {label}: the resumed run's {var} "
                         f"differs from the uninterrupted run's")
            rows = [checkpoint_extra(os.path.join(
                root, case, where, "rounds", last))["arrivals"]
                for where in ("whole", "split")]
            if rows[0] != rows[1] or len(rows[0]) != (
                    2 * legs if spec.async_mode != "off" else 0):
                fail(f"phase {tag} {label}: checkpointed arrival rows "
                     f"{rows[0]} / {rows[1]}")
            c6, c1, c2 = (runs[k][1] for k in ("whole", "first", "second"))
            if c1 != c2 or any(c6[k] != c1[k] + c2[k] for k in c6) or \
                    c2["round_uplink"] != legs or \
                    c2["fedplt_update"] != legs * N_EPOCHS:
                fail(f"phase {tag} {label}: launches whole {c6}, legs {c1} "
                     f"/ {c2}")
            losses = [h["loss"] for h in runs["whole"][2]]
            if [h["loss"] for h in runs["second"][2]] != losses[legs:]:
                fail(f"phase {tag} {label}: the second leg's losses differ")
            launched = {k: v for k, v in c2.items() if v}
            log(f"phase {tag} resume ({label}): {2 * legs} rounds equal "
                f"{legs} + checkpoint + resume + {legs} bit for bit "
                f"({', '.join(held)}"
                f"{'; arrival rows ' + str(rows[0]) if rows[0] else ''}); "
                f"the second leg launches {launched} in both runs; losses "
                f"{[round(v, 4) for v in losses]}")
            out[label] = {"launches_second_leg": launched, "losses": losses,
                          "arrivals": rows[0]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _bits_equal(torch, a, b) -> bool:
    """Bit equality of two tensors of one dtype (NaN by position)."""
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def _same_param_bits(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_bits_equal(torch, a[n], b[n])
                                        for n in a)


def decode_vs_forward(torch, cells=DECODE_CELLS, cfg_kw=None, tag="17c"):
    """Phase 17c: reduced gemma2-2b, falcon-mamba-7b and recurrentgemma-2b
    in float32 (B 2, S 24, past the reduced window of 16): the parallel
    forward on the card through the flash and scan kernels (their forward
    launch counts above 0) against token-by-token ``decode_step``; held to
    2e-2 (the reference's bound).  ``cells`` and ``cfg_kw`` (config fields
    replaced) run other models the same way (phase 18d).  Returns ``{arch:
    max abs diff}``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    out = {}
    for arch, n_layers in cells:
        cfg = dataclasses.replace(get_config(arch).reduced(n_layers=n_layers),
                                  **(cfg_kw or {}))
        kinds = cfg.layer_kinds()
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(4)
        params = model.init(gen, "cuda")
        toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen,
                             device="cuda")
        kernels.reset_launch_counts()
        with torch.no_grad():
            fwd = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        attn = sum(k in ("global", "local") for k in kinds)
        scan = sum(k in ("ssm", "rec") for k in kinds)
        want = expected_counts(flash_attention_fwd=attn, lru_scan_fwd=scan)
        if counts != want:
            fail(f"phase {tag} {arch}: forward launches {counts}, want "
                 f"{want}")
        cache = model.init_cache(2, 24, device="cuda")
        steps = []
        for t in range(24):
            lg, cache = model.decode_step(params, cache, toks[:, t])
            steps.append(lg)
        diff = float((fwd - torch.stack(steps, 1)).abs().max())
        if not diff < 2e-2:
            fail(f"phase {tag} {arch}: decode vs forward {diff}")
        log(f"phase {tag}: reduced {arch} fp32{f' {cfg_kw}' if cfg_kw else ''}"
            f", decode vs the forward through the kernels "
            f"({ {k: v for k, v in counts.items() if v} }): max abs diff "
            f"{diff:.3g} (bound 2e-2)")
        out[arch] = diff
    return out


def generate_timed(torch, cfg, params, tag, attn_layers):
    """``generate`` of ``cfg`` on ``params`` at batch 4, prompt 128, 32 new
    tokens (after a short warm-up): prefill ms (the prompt through
    ``decode_step``), ms a token, tok/s; no kernel launches on the decode
    path; then the prefill's last logits against the forward through the
    flash kernels (``attn_layers`` forward launches): largest difference
    and argmax agreement, reported (an MoE decode drops contributions
    that the forward keeps).  Returns ``{"generate": ...,
    "full_width_last_logits": ...}``."""
    from repro_torch import kernels
    from repro_torch.launch.serve import generate, prefill_via_decode
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    generate(model, params, prompts[:, :8], gen_len=4, cache_len=12)  # warm
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    cache = model.init_cache(SERVE_B, SERVE_PROMPT + SERVE_GEN,
                             device="cuda")
    cache, last = prefill_via_decode(model, params, cache, prompts)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    del cache
    t0 = time.time()
    out = generate(model, params, prompts, gen_len=SERVE_GEN,
                   cache_len=SERVE_PROMPT + SERVE_GEN)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    if set(kernels.launch_counts().values()) != {0}:
        fail(f"phase {tag}: decode launched {kernels.launch_counts()}")
    if tuple(out.shape) != (SERVE_B, SERVE_GEN) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        fail(f"phase {tag}: generated {tuple(out.shape)} {out}")
    token_ms = 1e3 * (gen_s - prefill_s) / (SERVE_GEN - 1)
    rec = {"generate": {"batch": SERVE_B, "prompt": SERVE_PROMPT,
                        "new_tokens": SERVE_GEN, "prefill_ms": 1e3 * prefill_s,
                        "ms_a_token": token_ms,
                        "tok_s": SERVE_B * SERVE_GEN / gen_s,
                        "generate_s": gen_s}}
    log(f"phase {tag}: generate on {cfg.name} ({cfg.n_layers} layer(s), "
        f"{cfg.dtype}), batch {SERVE_B}, prompt {SERVE_PROMPT}, {SERVE_GEN} "
        f"new tokens: prefill (through decode_step) {1e3 * prefill_s:.1f} ms, "
        f"{token_ms:.2f} ms a token, {SERVE_B * SERVE_GEN / gen_s:.1f} tok/s "
        f"({gen_s:.2f} s in all); no kernel launches on the decode path")
    kernels.reset_launch_counts()
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": prompts})[:, -1]
    torch.cuda.synchronize()
    if kernels.launch_counts()["flash_attention_fwd"] != attn_layers:
        fail(f"phase {tag}: forward launches {kernels.launch_counts()}")
    diff = float((fwd.float() - last.float()).abs().max())
    fwd_top, last_top = (torch.argmax(t, -1).tolist() for t in (fwd, last))
    agree = sum(a == b for a, b in zip(fwd_top, last_top))
    rec["full_width_last_logits"] = {"max_abs_diff": diff,
                                     "argmax_agrees": agree == SERVE_B,
                                     "argmax_rows_agreeing": agree,
                                     "logit_max": float(fwd.float().abs().max())}
    log(f"phase {tag}: full width {cfg.dtype}, the prefill's last logits "
        f"against the forward's (flash kernels): max abs diff {diff:.4g} "
        f"(logits up to {rec['full_width_last_logits']['logit_max']:.3g}), "
        f"argmax {'agrees' if agree == SERVE_B else 'differs'} in {agree} of "
        f"{SERVE_B} rows")
    return rec


def serve_phase(torch, params):
    """Phase 17: the standard phase's parameters through ``save_checkpoint``
    / ``restore_checkpoint`` (bit-equal gate; seconds and GB/s), then
    ``generate`` on them (gemma2-2b, 2 layers, bf16) at batch 4, prompt
    128, 32 new tokens: prefill ms, ms a token, tok/s; the prefill's last
    logits against the forward through the flash kernels (largest
    difference, argmax agreement); then decode against forward on reduced
    models (:func:`decode_vs_forward`)."""
    import shutil

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config

    rec = {}
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    root = _scratch_dir()
    try:
        path = os.path.join(root, "params")
        torch.cuda.synchronize()
        t0 = time.time()
        save_checkpoint(path, params, step=STD_STEPS)
        save_s = time.time() - t0
        like = {n: torch.empty_like(p) for n, p in params.items()}
        t0 = time.time()
        got = restore_checkpoint(path, like, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not _same_param_bits(torch, got, params):
        fail("phase 17a: the restored parameters differ from the saved")
    del got, like
    rec["checkpoint"] = {"bytes": nbytes, "save_s": save_s,
                         "restore_s": restore_s,
                         "save_gb_s": nbytes / save_s / 1e9,
                         "restore_gb_s": nbytes / restore_s / 1e9}
    log(f"phase 17a: the trained parameters ({nbytes / 1e9:.3f} GB bf16) "
        f"saved in {save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s) and "
        f"restored bit-equal in {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s; warm file cache)")

    cfg = dataclasses.replace(get_config(GEMMA.arch), n_layers=GEMMA.n_layers)
    rec.update(generate_timed(torch, cfg, params, "17b", GEMMA.attn_layers))
    rec["decode_vs_forward"] = decode_vs_forward(torch)
    return rec


# ---------------------------------------------------------------------------
# Phase 18: the MoE FFN (qwen2-moe-a2.7b, grok-1-314b)
# ---------------------------------------------------------------------------

# 18a: (arch, capacity factor, grouped route) of the reduced MoE layer
MOE_LAYER_CASES = (("qwen2-moe-a2.7b", 1.25, False),
                   ("qwen2-moe-a2.7b", 1.25, True),
                   ("grok-1-314b", 1.25, False), ("grok-1-314b", 1.25, True),
                   ("qwen2-moe-a2.7b", 0.5, False),
                   ("grok-1-314b", 0.5, True))
MOE_RANGES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine",
              "moe.shared")
MOE_STD_STEPS = 2                   # 18d's standard steps
# 18d: grok-1-314b at published width cut to one layer (bf16; the expert
# wi (1, 8, 6144, 65536))
GROK_LAYERS, GROK_PARAMS = 1, 5_725_292_544
MOE_DECODE_CELLS = (("qwen2-moe-a2.7b", 2), ("grok-1-314b", 2))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def moe_layer_parity(torch):
    """Phase 18a: the reduced qwen2-moe (swiglu, one shared expert) and
    grok-1 (geglu) MoE layers in float32 on the card against the port's
    CPU path, both routes, capacity factor 1.25 and 0.5 (drops), B 2, S
    64: every contribution's expert, rank and slot equal exactly; the
    output, the aux loss and the gradients of ``sum(out * g) + aux`` (every
    parameter and x) within 1e-5 relative (largest difference over the
    largest entry).  Returns ``{case: {"max_rel_err", "dropped"}}``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib

    out = {}
    B, S = 2, 64
    for arch, cf, grouped in MOE_LAYER_CASES:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  capacity_factor=cf, moe_grouped=grouped)
        label = f"{arch} cf {cf} {'grouped' if grouped else 'flat'}"
        gen = torch.Generator().manual_seed(7)
        params = moe_lib.init_moe(gen, cfg, torch.float32)
        x = torch.randn((B, S, cfg.d_model), generator=gen)
        g = torch.randn((B, S, cfg.d_model), generator=gen)
        groups = B if grouped else 1
        cap = moe_lib.capacity(cfg, B * S // groups)
        res = {}
        for dev in ("cpu", "cuda"):
            p = _tree_map(lambda t: t.detach().to(dev).requires_grad_(),
                          params)
            xx = x.detach().to(dev).requires_grad_()
            y, aux = moe_lib.moe_ffn(p, xx, cfg)
            (torch.sum(y * g.to(dev)) + aux).backward()
            _, _, experts = moe_lib.route(xx.detach().reshape(B * S, -1),
                                          p["router"].detach(), cfg.top_k)
            plan = moe_lib.dispatch_plan(experts.reshape(groups, -1),
                                         cfg.n_experts, cap)
            res[dev] = {
                "values": dict([("out", y.detach()), ("aux", aux.detach()),
                                ("dx", xx.grad)] + [
                    (f"d{n}", t.grad) for n, t in _tree_items(p)]),
                "ids": (experts, plan["rank"], plan["slot"]),
                "dropped": int((~plan["kept"]).sum())}
        for a, b, what in zip(res["cuda"]["ids"], res["cpu"]["ids"],
                              ("experts", "ranks", "slots")):
            if not torch.equal(a.cpu(), b):
                fail(f"phase 18a {label}: {what} differ card / CPU")
        errs = {k: _rel_err(v.cpu(), res["cpu"]["values"][k])
                for k, v in res["cuda"]["values"].items()}
        worst = max(errs.values())
        if not worst <= 1e-5:
            fail(f"phase 18a {label}: card vs CPU {errs}")
        if cf < 1 and res["cuda"]["dropped"] == 0:
            fail(f"phase 18a {label}: no contribution dropped")
        if res["cuda"]["dropped"] != res["cpu"]["dropped"]:
            fail(f"phase 18a {label}: drops {res['cuda']['dropped']} card, "
                 f"{res['cpu']['dropped']} CPU")
        log(f"phase 18a: reduced {label} fp32 (capacity {cap}): experts, "
            f"ranks and slots equal card / CPU, "
            f"{res['cuda']['dropped']} of {B * S * cfg.top_k} contributions "
            f"dropped; out, aux and gradients within {worst:.3g} relative "
            f"(bound 1e-5)")
        out[label] = {"max_rel_err": worst,
                      "dropped": res["cuda"]["dropped"],
                      "contributions": B * S * cfg.top_k, "capacity": cap}
    return out


def _range_of(e, names):
    """The innermost range of ``names`` that holds profiler event ``e``
    (None outside them), and whether ``e`` runs inside a backward node."""
    r, in_backward = None, False
    while e is not None:
        if r is None and e.name in names:
            r = e.name
        if e.name.startswith("autograd::engine::evaluate_function"):
            in_backward = True
        e = e.cpu_parent
    return r, in_backward


def moe_profile_split(torch, fn):
    """``fn()`` (ending in a synchronize) under torch.profiler: the device
    ms of the MoE's parts, forward and backward.  A part's forward is the
    kernels launched inside its ``record_function`` range (``MOE_RANGES``);
    its backward is the kernels of the autograd nodes its forward ops
    created, matched by sequence number (an op records the number the next
    node takes, so the last forward op to hold a number is that node's
    maker, or runs inside it).  Returns ``{"wall_ms", "device_ms",
    "forward_ms": {part: ms}, "backward_ms": {part: ms}, "moe_ms",
    "moe_share"}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    fwd = dict.fromkeys(MOE_RANGES, 0.0)
    bwd = dict.fromkeys(MOE_RANGES, 0.0)
    maker = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name in MOE_RANGES:
            fwd[e.name] += e.device_time_total / 1e3
        r, in_backward = _range_of(e, MOE_RANGES)
        if e.sequence_nr >= 0 and not in_backward and not \
                e.name.startswith("autograd::"):
            maker[(e.thread, e.sequence_nr)] = r
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function") and \
                e.sequence_nr >= 0:
            r = maker.get((e.fwd_thread, e.sequence_nr))
            if r is not None:
                bwd[r] += e.device_time_total / 1e3
    device_ms = sum(
        getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    moe_ms = sum(fwd.values()) + sum(bwd.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms, "forward_ms": fwd,
            "backward_ms": bwd, "moe_ms": moe_ms,
            "moe_share": moe_ms / device_ms if device_ms else None}


def _moe_round_checks(torch, trainer, state, cfg, out):
    """Phase 18b/18c on the full-width trainer's final state: one round
    under the profiler split by MoE part (:func:`moe_profile_split`), then
    two rounds from that state with the same batch and generator state,
    equal bit for bit (x, z and the loss; the first round's state held on
    the host while the second runs)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for

    shape = InputShape("moe", MAIN_SEQ, MAIN_BATCH, "train")
    batch = make_batch_for(cfg, shape,
                           torch.Generator(device="cuda").manual_seed(11),
                           n_agents=FULL_N, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)

    def one_round():
        _, m = trainer.step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()

    split = moe_profile_split(torch, one_round)
    out["moe_profile"] = split
    if not split["moe_ms"]:
        # a measurement, not a gate: phase 11b has seen profiles that hold
        # no device event
        log(f"phase 18b profile: no MoE device time in the profile ({split})")
    else:
        log(f"phase 18b profile: one round {split['wall_ms']:.1f} ms wall, "
            f"device {split['device_ms']:.1f} ms, the MoE "
            f"{split['moe_ms']:.1f} ms ({100 * split['moe_share']:.1f}%): "
            f"forward "
            f"{ {k: round(v, 2) for k, v in split['forward_ms'].items()} }, "
            f"backward "
            f"{ {k: round(v, 2) for k, v in split['backward_ms'].items()} }")

    g0 = gen.get_state()
    s1, m1 = trainer.step(state, batch, gen)
    first = {v: {n: t.cpu() for n, t in getattr(s1, v).items()}
             for v in ("x", "z")}
    loss1 = float(m1["loss"])
    del s1, m1
    gen.set_state(g0)
    s2, m2 = trainer.step(state, batch, gen)
    for v in ("x", "z"):
        if not _same_param_bits(torch, first[v], {
                n: t.cpu() for n, t in getattr(s2, v).items()}):
            fail(f"phase 18c: two rounds from one state differ in {v}")
    if float(m2["loss"]) != loss1:
        fail(f"phase 18c: two rounds from one state, losses {loss1} / "
             f"{float(m2['loss'])}")
    del s2, m2, first
    out["repeat_round_bit_equal"] = True
    log(f"phase 18c: two full-width rounds from one state with one batch "
        f"and generator state: x, z and the loss ({loss1:.6f}) equal bit for "
        f"bit")


def moe_phase(torch, base, resume=False):
    """Phase 18: the MoE FFN.  18a :func:`moe_layer_parity`; 18b
    qwen2-moe-a2.7b at published width cut to one layer, bf16 (tree
    layout: the float32 router), phase 4's spec otherwise, 3 rounds
    (flash 8 / 8 a round, fedplt_update once a leaf a local epoch, no edge
    kernel), a profiled round split by MoE part; 18c two full-width rounds
    from one state bit for bit (and, with ``resume``, phase 16's reduced
    qwen2-moe case); 18d one-layer qwen2-moe through ``run_standard``
    (AdamW, flash 1 / 1 a step) and served, grok-1-314b cut to one layer
    served, and reduced decode against the forward at capacity factor 8.
    Returns the phase's record."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.fed.api import FedSpec
    from repro_torch.launch.train import run_standard
    from repro_torch.models.model import build_model

    rec = {"18a": moe_layer_parity(torch)}
    checks = {}
    tree_base = dict(base, state_layout="tree")
    counts, hist, peak = train_phase(
        torch, "phase 18b qwen2-moe-a2.7b (1 layer, tree layout)",
        FedSpec(**tree_base), 3,
        expected_counts(3, QWEN, fedplt_update=3 * N_EPOCHS * QWEN.n_leaves),
        profile=True, cell=QWEN, profile_out=checks.setdefault("profile", {}),
        after=lambda tr, st, cfg: _moe_round_checks(torch, tr, st, cfg,
                                                    checks))
    if peak > 80e9:
        fail(f"phase 18b: peak device memory {peak / 1e9:.2f} GB")
    rec["18b"] = dict(checks, counts={k: v for k, v in counts.items() if v},
                      peak_gb=peak / 1e9,
                      round_ms=[1e3 * h["dt"] for h in hist],
                      losses=[h["loss"] for h in hist])
    if resume:
        rec["18c_resume"] = resume_phase(
            torch, [c for c in RESUME_CASES if "arch" in c[2]])

    # 18d: a standard step and serving at published width
    cfg = dataclasses.replace(get_config(QWEN.arch), n_layers=QWEN.n_layers)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    params, hist = run_standard(cfg, optimizer="adamw", lr=1e-3,
                                steps=MOE_STD_STEPS, seq_len=MAIN_SEQ,
                                batch=MAIN_BATCH, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = expected_counts(flash_attention_fwd=MOE_STD_STEPS,
                           flash_attention_bwd=MOE_STD_STEPS)
    if counts != want:
        fail(f"phase 18d: standard launches {counts}, want {want}")
    if not all(math.isfinite(h["loss"]) for h in hist) or not all(
            bool(torch.isfinite(p).all()) for p in params.values()):
        fail(f"phase 18d: non-finite loss or parameters ({hist})")
    std_peak = torch.cuda.max_memory_allocated()
    step_ms = [1e3 * h["dt"] for h in hist]
    log(f"phase 18d standard mode: qwen2-moe-a2.7b (1 layer, bf16), AdamW, "
        f"batch {MAIN_BATCH} x seq {MAIN_SEQ}: losses "
        f"{[round(h['loss'], 4) for h in hist]}, step ms "
        f"{[round(v, 2) for v in step_ms]}, peak {std_peak / 1e9:.2f} GB; "
        f"flash {MOE_STD_STEPS} / {MOE_STD_STEPS}")
    rec["18d_standard"] = {"step_ms": step_ms,
                           "losses": [h["loss"] for h in hist],
                           "peak_gb": std_peak / 1e9}
    rec["18d_serve_qwen"] = generate_timed(torch, cfg, params, "18d",
                                           QWEN.attn_layers)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=GROK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(6), "cuda")
    n = sum(p.numel() for p in params.values())
    wi = params["stages.0.0.moe.experts.wi"]
    if n != GROK_PARAMS or tuple(wi.shape) != (1, 8, 6144, 65536):
        fail(f"phase 18d: grok-1-314b {n:,} parameters, expert wi "
             f"{tuple(wi.shape)}")
    log(f"phase 18d: grok-1-314b (1 layer, {n:,} params, "
        f"{sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f}"
        f" GB bf16; expert wi {tuple(wi.shape)})")
    rec["18d_serve_grok"] = generate_timed(torch, cfg, params, "18d",
                                           GROK_LAYERS)
    rec["18d_serve_grok"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, wi
    torch.cuda.empty_cache()
    rec["18d_decode_vs_forward"] = decode_vs_forward(
        torch, MOE_DECODE_CELLS, dict(capacity_factor=8.0), tag="18d")
    return rec


# ---------------------------------------------------------------------------
# Phase 16's mesh case: checkpoints of a sharded state
# ---------------------------------------------------------------------------

MESH_RESUME = ("2x1", "1x2")        # meshes of the two gloo ranks
MESH_RESUME_ROUNDS, MESH_RESUME_EVERY = 4, 2


def _mesh_resume_run(torch, mesh_shape, root):
    """Reduced gemma2-2b (bf16) under ``mesh_shape``: ``run_fed`` for
    ``MESH_RESUME_ROUNDS`` rounds with a checkpoint every
    ``MESH_RESUME_EVERY``, and again stopped at the first checkpoint and
    resumed; this rank's ``x`` and ``z`` of each leg (on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_fed

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              dtype="bfloat16")
    # participation 0.75: every rank draws the rows from its generator,
    # whose state the checkpoint carries
    spec = dataclasses.replace(_resume_spec({}), mesh_shape=mesh_shape,
                               participation=0.75)
    kw = dict(seq_len=64, batch=8, device="cuda:0",
              checkpoint_every=MESH_RESUME_EVERY, log=lambda *a: None)
    out = {}
    for leg, steps, resume, where in (
            ("whole", MESH_RESUME_ROUNDS, False, "whole"),
            ("first", MESH_RESUME_EVERY, False, "split"),
            ("second", MESH_RESUME_ROUNDS, True, "split")):
        _, state, hist = run_fed(
            cfg, spec, steps=steps, resume=resume,
            checkpoint=os.path.join(root, mesh_shape, where), **kw)
        out[leg] = {"x": state.x.cpu(), "z": state.z.cpu(),
                    "step": state.step, "losses": [h["loss"] for h in hist]}
    return out


def _mesh_resume_worker(rank, world, store, out_dir):
    """Phase 16's mesh case on one of two gloo ranks on the one card."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        res = {m: _mesh_resume_run(torch, m, out_dir) for m in MESH_RESUME}
        torch.save(res, os.path.join(out_dir, f"resume-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_resume_phase(torch):
    """Phase 16's mesh case: reduced gemma2-2b (bf16, N 4, packed, fused,
    participation 0.75) on two gloo ranks spawned on the card under 2x1
    and 1x2: the run stopped at round 2 and resumed to round 4 equals the
    uninterrupted sharded run bit for bit on each rank, and the round-2
    checkpoint (the global state) restores into the unsharded trainer as
    the ranks' gathered blocks, bit for bit.  Any failure of a rank fails
    the smoke."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    root = _scratch_dir()
    out = {}
    try:
        try:
            mp.start_processes(_mesh_resume_worker,
                               args=(2, os.path.join(root, "store"), root),
                               nprocs=2, join=True, start_method="spawn")
        except Exception as e:
            text = str(e)
            last = (text.strip().splitlines() or [type(e).__name__])[-1]
            fail(f"phase 16 mesh: a rank failed: {last}")
        ranks = [torch.load(os.path.join(root, f"resume-rank{r}.pt"))
                 for r in range(2)]
        cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                                  dtype="bfloat16")
        tr = api.build_trainer(build_model(cfg), _resume_spec({}), "cuda")
        width = tr.packed_meta.width
        for mesh in MESH_RESUME:
            model = int(mesh.split("x")[1])
            for r, res in enumerate(ranks):
                for var in ("x", "z"):
                    a, b = res[mesh]["whole"][var], res[mesh]["second"][var]
                    if not torch.equal(a.view(torch.int16),
                                       b.view(torch.int16)):
                        fail(f"phase 16 mesh {mesh}: rank {r}'s resumed {var} "
                             f"differs from the uninterrupted run's")
                if res[mesh]["second"]["losses"] != \
                        res[mesh]["whole"]["losses"][MESH_RESUME_EVERY:]:
                    fail(f"phase 16 mesh {mesh}: rank {r}'s resumed losses "
                         f"differ")
            path = os.path.join(root, mesh, "split", "rounds",
                                f"step-{MESH_RESUME_EVERY:06d}")
            st, extra = tr.restore_state(path, tr.init(1)[0])
            for var in ("x", "z"):
                want = _assemble(torch, [res[mesh]["first"][var]
                                         for res in ranks], model, width)
                if not torch.equal(getattr(st, var).cpu().view(torch.int16),
                                   want.view(torch.int16)):
                    fail(f"phase 16 mesh {mesh}: the checkpoint's {var} "
                         f"restored unsharded differs from the gathered "
                         f"blocks")
            blocks = tuple(ranks[0][mesh]["first"]["x"].shape)
            log(f"phase 16 mesh {mesh}: reduced gemma2-2b bf16, two gloo "
                f"ranks on the card (blocks {blocks}): {MESH_RESUME_EVERY} "
                f"rounds + checkpoint + resume + "
                f"{MESH_RESUME_ROUNDS - MESH_RESUME_EVERY} equal "
                f"{MESH_RESUME_ROUNDS} rounds bit for bit on both ranks; the "
                f"checkpoint restores unsharded (round {extra['round']}) as "
                f"the gathered blocks")
            out[mesh] = {"blocks": blocks,
                         "losses": ranks[0][mesh]["whole"]["losses"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 19: the encoder-decoder and the vision prefix (whisper-small,
# internvl2-26b; no new kernel)
# ---------------------------------------------------------------------------

ENCDEC_REDUCED = ("whisper-small", "internvl2-26b")
# 19a's flash shapes, bf16, no cap: (label, B, S, T, H, Hkv, D, causal);
# whisper-small's (2 sequences an agent) are timed
ENCDEC_FLASH = (
    ("whisper encoder", 2, 1500, 1500, 12, 12, 64, False),
    ("whisper decoder self", 2, 448, 448, 12, 12, 64, True),
    ("whisper cross", 2, 448, 1500, 12, 12, 64, False),
    ("internvl2 layer", 2, 512, 512, 48, 8, 128, True),
)


def encdec_reduced_parity(torch):
    """19a: reduced whisper-small and internvl2-26b in fp32, N 2, packed,
    fused edges and update, 2 rounds on the card and on the CPU: the
    states within 1e-4 (:func:`card_vs_cpu`); on the card one flash
    forward and backward an attention call per agent per epoch, on the
    CPU no launch.  Returns ``{arch: max abs err}``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    spec = api.FedSpec(n_agents=2, n_epochs=2, gamma=0.05, weight_decay=0.01,
                       state_layout="packed", engine_backend="fused",
                       use_fused_update=True)
    out = {}
    for arch in ENCDEC_REDUCED:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        batches = [make_batch_for(cfg, InputShape("small", 32, 4, "train"),
                                  gen, n_agents=2) for _ in range(2)]
        states, counts = {}, {}
        for dev in ("cuda", "cpu"):
            tr = api.build_trainer(model, spec, dev)
            st, _ = tr.init(0, params=params)
            kernels.reset_launch_counts()
            for b in batches:
                st, m = tr.step(st, b, u=torch.ones(2))
            float(m["loss"])
            states[dev], counts[dev] = st, kernels.launch_counts()
        calls = 2 * 2 * 2 * len(attention_calls(cfg, 32))
        want = expected_counts(flash_attention_fwd=calls,
                               flash_attention_bwd=calls, round_uplink=2,
                               round_downlink=2, fedplt_update=4)
        if counts["cuda"] != want or set(counts["cpu"].values()) != {0}:
            fail(f"phase 19a {arch}: launches card {counts['cuda']}, CPU "
                 f"{counts['cpu']}; want {want} on the card")
        err, _ = card_vs_cpu(torch, states, f"phase 19a {arch}")
        log(f"phase 19a: reduced {arch} fp32, 2 rounds, card (flash "
            f"{calls} / {calls}, edges, update) vs CPU (plain versions): max "
            f"abs err {err:.3g} (tolerance 1e-4)")
        out[arch] = err
    return out


def encdec_flash_checks(torch, bw):
    """19a: the flash forward and backward at whisper-small's encoder,
    decoder self- and cross-attention shapes and internvl2-26b's layer
    (:data:`ENCDEC_FLASH`, bf16, no cap) against their plain versions run
    head by head, at 9a's bf16 tolerances; whisper's shapes timed (CUDA
    events, median of 7) beside the bound (:func:`plain_flash_bound`),
    the bound as the kernels run the products (9b's), the plain versions,
    SDPA (the same function: no cap) and ``flex_attention`` compiled.
    Returns ``{label: record}``."""
    from repro_torch.launch.roofline import (BF16_PEAK, flash_bounds,
                                             plain_flash_bound)
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    from repro_torch.kernels.flash_attention import ops as fops

    flex = torch.compile(flex_attention)
    gen = torch.Generator(device="cuda").manual_seed(19)
    recs = {}
    for label, B, S, T, H, Hkv, D, causal in ENCDEC_FLASH:
        bf = torch.bfloat16
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(bf)
        k, v = (torch.randn((B, T, Hkv, D), generator=gen,
                            device="cuda").to(bf) for _ in range(2))
        do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(bf)
        kw = dict(causal=causal, window=None, cap=None)
        o, lse = fops.flash_attention_fwd(q, k, v, **kw)
        po, plse = plain_fwd_by_head(torch, q, k, v, **kw)
        err_f = max(flash_close(torch, o, po, f"phase 19a {label} o"),
                    flash_close(torch, lse, plse, f"phase 19a {label} lse"))
        grads = fops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = plain_bwd_by_head(torch, q, k, v, o, lse, do, **kw)
        err_b = max(flash_close(torch, a, b, f"phase 19a {label} d{n}",
                                grad=True)
                    for n, a, b in zip("qkv", grads, want))
        del grads, want
        rec = {"shape": dict(B=B, S=S, T=T, H=H, Hkv=Hkv, D=D,
                             causal=causal),
               "max_abs_err_fwd": err_f, "max_abs_err_bwd": err_b}
        if label.startswith("whisper"):
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != Hkv)
            out = sdpa()
            sdpa_err = float((out.detach().transpose(1, 2).float()
                              - po.float()).abs().max())
            times = {
                "fwd": cuda_ms(torch, lambda: fops.flash_attention_fwd(
                    q, k, v, **kw)),
                "bwd": cuda_ms(torch, lambda: fops.flash_attention_bwd(
                    q, k, v, o, lse, do, **kw)),
                "plain_fwd": cuda_ms(torch, lambda: plain_fwd_by_head(
                    torch, q, k, v, **kw), reps=3),
                "plain_bwd": cuda_ms(torch, lambda: plain_bwd_by_head(
                    torch, q, k, v, o, lse, do, **kw), reps=3),
                "sdpa_fwd": cuda_ms(torch, sdpa),
                "sdpa_bwd": cuda_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True))}
            del out
            mask = (create_block_mask(lambda b, h, qi, ki: qi >= ki, None,
                                      None, S, T, device="cuda")
                    if causal else None)
            flex_call = lambda: flex(qt, kt, vt, block_mask=mask,
                                     enable_gqa=H != Hkv)
            # the backward is timed on one graph, kept between calls:
            # a compiled backward that donates its buffers refuses that
            with torch._functorch.config.patch(donated_buffer=False):
                out = flex_call()
                flex_err = float((out.detach().transpose(1, 2).float()
                                  - po.float()).abs().max())
                times["flex_fwd"] = cuda_ms(torch, flex_call)
                times["flex_bwd"] = cuda_ms(torch, lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True))
            del out, qt, kt, vt, dot
            bounds = plain_flash_bound(bw, B, S, T, H, Hkv, D, causal)
            as_run = flash_bounds(bw, B, S, H, Hkv, D, causal, None, T=T)
            for name in ("fwd", "bwd"):
                bd = bounds[name]
                rec[name] = dict(
                    ms=times[name], plain_ms=times[f"plain_{name}"],
                    sdpa_ms=times[f"sdpa_{name}"],
                    library_ms=times[f"flex_{name}"], **bd,
                    as_run_bound_ms=as_run[name]["bound_ms"])
                log(f"phase 19a {label} (B {B} S {S} T {T} H {H} Hkv {Hkv} "
                    f"D {D} bf16, {'causal' if causal else 'no mask'}) "
                    f"{name}: kernel {times[name]:.4f} ms, bound "
                    f"{bd['bound_ms']:.4f} ms ({bd['flops'] / 1e9:.2f} GFLOP "
                    f"at {BF16_PEAK / 1e12:.0f} TFLOP/s, by {bd['bound_by']}; "
                    f"{100 * bd['bound_ms'] / times[name]:.1f}% of it; as the "
                    f"kernels run the products "
                    f"{as_run[name]['bound_ms']:.4f} ms), plain "
                    f"{times[f'plain_{name}']:.3f} ms, SDPA "
                    f"{times[f'sdpa_{name}']:.4f} ms, flex_attention "
                    f"{times[f'flex_{name}']:.4f} ms")
            rec["sdpa_max_abs_err"], rec["flex_max_abs_err"] = sdpa_err, flex_err
        log(f"phase 19a {label}: flash forward and backward against the "
            f"plain versions (B {B} S {S} T {T} H {H} Hkv {Hkv} D {D} bf16, "
            f"{'causal' if causal else 'no mask'}): max abs err "
            f"{err_f:.3g} / {err_b:.3g}")
        recs[label] = rec
        del q, k, v, do, o, lse, po, plse
        torch.cuda.empty_cache()
    return recs


def whisper_serving(torch):
    """19d: reduced whisper-small (fp32, B 2, 24 text tokens, 24 frames):
    the encoder once through the kernels, ``fill_cross_cache``, then
    ``decode_step`` token by token against the forward through the
    kernels (2e-2, the reference's bound); then whisper-small at
    published width (bf16) at batch 4: the encoder over 1500 frames,
    ``fill_cross_cache``, a 128-token prompt through ``decode_step`` and
    32 greedy tokens (ms a token, tok/s; no kernel on the decode path),
    and the prefill's last logits against the forward's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill_via_decode
    from repro_torch.models import frontends
    from repro_torch.models.decode import fill_cross_cache
    from repro_torch.models.model import build_model

    rec = {}
    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = model.init(gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen, device="cuda")
    enc = frontends.fake_audio_frames(gen, cfg, 2, "cuda")
    kernels.reset_launch_counts()
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": toks, "enc_embeds": enc})
        enc_out = model.encode(params, enc)
    torch.cuda.synchronize()
    calls = len(attention_calls(cfg, 24))
    counts = kernels.launch_counts()
    if counts != expected_counts(flash_attention_fwd=calls
                                 + cfg.n_enc_layers):
        fail(f"phase 19d: reduced forward and encoder launches {counts}")
    cache = fill_cross_cache(params, cfg,
                             model.init_cache(2, 24, device="cuda"), enc_out)
    steps = []
    for t in range(24):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        steps.append(lg)
    diff = float((fwd - torch.stack(steps, 1)).abs().max())
    if not diff < 2e-2:
        fail(f"phase 19d: reduced whisper decode vs forward {diff}")
    rec["reduced_decode_vs_forward"] = diff
    log(f"phase 19d: reduced whisper-small fp32, the encoder once (flash "
        f"{cfg.n_enc_layers}), fill_cross_cache, decode vs the forward "
        f"through the kernels (flash {calls}): max abs diff {diff:.3g} "
        f"(bound 2e-2)")

    cfg = get_config("whisper-small")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(5),
                        "cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    enc = frontends.fake_audio_frames(gen, cfg, SERVE_B, "cuda")

    def serve(prompt, gen_len):
        with torch.no_grad():
            cache = fill_cross_cache(
                params, cfg, model.init_cache(SERVE_B, SERVE_PROMPT
                                              + SERVE_GEN, device="cuda"),
                model.encode(params, enc))
        torch.cuda.synchronize()
        t0 = time.time()
        cache, last = prefill_via_decode(model, params, cache, prompt)
        torch.cuda.synchronize()
        t1 = time.time()
        tok = torch.argmax(last, -1)
        for _ in range(gen_len):
            lg, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        return last, t1 - t0, time.time() - t1

    serve(prompts[:, :8], 4)                          # warm-up
    kernels.reset_launch_counts()
    last, prefill_s, decode_s = serve(prompts, SERVE_GEN)
    counts = kernels.launch_counts()
    if counts != expected_counts(flash_attention_fwd=cfg.n_enc_layers):
        fail(f"phase 19d: serving launched {counts} (the encoder only, "
             f"{cfg.n_enc_layers} flash forwards, want)")
    kernels.reset_launch_counts()
    with torch.no_grad():
        fwd = model.forward(params, {"tokens": prompts,
                                     "enc_embeds": enc})[:, -1]
    if kernels.launch_counts()["flash_attention_fwd"] != len(
            attention_calls(cfg, SERVE_PROMPT)):
        fail(f"phase 19d: forward launches {kernels.launch_counts()}")
    ldiff = float((fwd.float() - last.float()).abs().max())
    agree = sum(a == b for a, b in zip(torch.argmax(fwd, -1).tolist(),
                                       torch.argmax(last, -1).tolist()))
    token_ms = 1e3 * decode_s / SERVE_GEN
    rec["full_width"] = {
        "batch": SERVE_B, "prompt": SERVE_PROMPT, "new_tokens": SERVE_GEN,
        "prefill_ms": 1e3 * prefill_s, "ms_a_token": token_ms,
        "tok_s": SERVE_B * SERVE_GEN / decode_s,
        "last_logits_max_abs_diff": ldiff, "argmax_rows_agreeing": agree}
    log(f"phase 19d: whisper-small (published width, bf16) at batch "
        f"{SERVE_B}: the encoder over {cfg.n_enc_tokens} frames and the "
        f"cross cache, prefill of {SERVE_PROMPT} tokens through decode_step "
        f"{1e3 * prefill_s:.1f} ms, {token_ms:.2f} ms a token "
        f"({SERVE_B * SERVE_GEN / decode_s:.1f} tok/s); the prefill's last "
        f"logits against the forward's: max abs diff {ldiff:.4g}, argmax "
        f"agrees in {agree} of {SERVE_B} rows")
    del params
    torch.cuda.empty_cache()
    return rec


def encdec_phase(torch, base, bw):
    """Phase 19: 19a :func:`encdec_reduced_parity` and
    :func:`encdec_flash_checks`; 19b whisper-small at published width and
    depth (238,060,032 parameters, bf16, packed), phase 4's spec with the
    448-token text context and 1500 encoder frames, 3 rounds: flash 864 /
    864, uplink 3, downlink 3, fedplt_update 6, nothing else; a profiled
    round; 19c internvl2-26b cut to one layer of 48 (958,734,336
    parameters, packed; 256 patch embeddings and 256 text tokens), 3
    rounds: flash 24 / 24; 19d :func:`whisper_serving`.  Returns the
    phase's record."""
    from repro_torch.fed.api import FedSpec

    t0 = time.time()
    rec = {"19a_reduced": encdec_reduced_parity(torch)}
    secs = {"19a reduced": time.time() - t0}
    rec["19a_flash"] = encdec_flash_checks(torch, bw)
    secs["19a flash"] = time.time() - t0 - sum(secs.values())
    for tag, cell in (("19b", WHISPER), ("19c", INTERNVL)):
        prof = {}
        counts, hist, peak = train_phase(
            torch, f"phase {tag} {cell.arch} ({cell.n_layers} "
            f"{'decoder + 12 encoder layers' if cell is WHISPER else 'layer'}"
            f", packed)", FedSpec(**base), 3,
            expected_counts(3, cell, round_uplink=3, round_downlink=3,
                            fedplt_update=6), profile=True, cell=cell,
            profile_out=prof)
        if peak > 80e9:
            fail(f"phase {tag}: peak device memory {peak / 1e9:.2f} GB")
        rec[tag] = {"counts": {k: v for k, v in counts.items() if v},
                    "peak_gb": peak / 1e9,
                    "round_ms": [1e3 * h["dt"] for h in hist],
                    "losses": [h["loss"] for h in hist], "profile": prof}
        secs[tag] = time.time() - t0 - sum(secs.values())
    rec["19d"] = whisper_serving(torch)
    secs["19d"] = time.time() - t0 - sum(secs.values())
    rec["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    log(f"phase 19 seconds: {rec['seconds']}")
    return rec


def encdec_phases(torch) -> int:
    """``--encdec``: build the kernels, run phase 19 and phase 16's mesh
    case alone and print their record as one JSON line."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    rec = encdec_phase(torch, MAIN_SPEC,
                          card_bandwidth(torch.cuda.get_device_name(0)))
    t1 = time.time()
    mesh = mesh_resume_phase(torch)
    log(json.dumps({"encdec": rec, "mesh_resume": mesh,
                    "seconds": {19: round(t1 - t0, 1),
                                "16 mesh": round(time.time() - t1, 1)},
                    "card": smi}))
    return 0


def moe_phases(torch) -> int:
    """``--moe``: build the kernels, run phase 18 (with phase 16's MoE
    resume case) alone and print its record as one JSON line."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    rec = moe_phase(torch, MAIN_SPEC, resume=True)
    log(json.dumps({"moe": rec, "seconds": round(time.time() - t0, 1),
                    "card": smi}))
    return 0


def train_serve_phases(torch) -> int:
    """``--train-serve``: build the kernels, run phases 15-17 alone and
    print their records as one JSON line."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    params, std = standard_phase(torch)
    t1 = time.time()
    resume = resume_phase(torch)
    t2 = time.time()
    serve = serve_phase(torch, params)
    t3 = time.time()
    secs = {15: round(t1 - t0, 1), 16: round(t2 - t1, 1),
            17: round(t3 - t2, 1)}
    log(f"phase seconds: {secs}")
    log(json.dumps({"standard": std, "resume": resume, "serve": serve,
                    "phase_seconds": secs, "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# Phase 20: bounded-staleness async rounds and the host broker
# ---------------------------------------------------------------------------

ASYNC_K = 2
# 20a's given rows (N 4, K 2): nobody in round 0; agents 0 and 2 arrive
# stale (1 round) in round 1; round 2 gives nobody and the bound adds
# agents 1 and 3 (2 rounds old); round 4 gives nobody and the bound adds
# agent 2
ASYNC_ROWS = ((0, 0, 0, 0), (1, 0, 1, 0), (0, 0, 0, 0), (1, 1, 0, 0),
              (0, 0, 0, 0))
ASYNC_BROKER_ROUNDS = 6
ASYNC_LATENCY = (0.020, 0.002)      # agent 0 (the straggler), the others
ASYNC_GRACE = 0.003
ASYNC_DENSE = dict(rounds=100, K=3, participation=0.4, tau=0.05)


def realised_rows(rows, K):
    """The rows a round realises from given rows: each OR-ed with the
    agents the bound forces in (the counters replayed on the host)."""
    import numpy as np

    s = np.zeros(len(rows[0]), np.int64)
    out = []
    for row in rows:
        u = np.maximum(np.asarray(row, np.float32),
                       ((s >= K) & (s > 0)).astype(np.float32))
        out.append(u)
        s = np.where(u != 0, 0, np.where(s < K, s + 1, s))
    return np.stack(out)


def async_reduced_parity(torch):
    """Phase 20a (docstring at the top); returns its record."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.fed.async_engine import effective_counts
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    shape = InputShape("small", 64, 8, "train")
    batches = [make_batch_for(cfg, shape, gen, n_agents=FULL_N)
               for _ in ASYNC_ROWS]
    base = dict(n_agents=FULL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
                state_layout="packed", engine_backend="fused",
                use_fused_update=True)
    want = realised_rows(ASYNC_ROWS, ASYNC_K)
    arrivals, released = effective_counts(want, ASYNC_K)
    given = np.asarray(ASYNC_ROWS, np.float32)
    if not ((released > arrivals).any() and (want > given).any()
            and (want.sum(1) == 0).any()):
        fail("phase 20a: the schedule lacks a stale arrival, a forced "
             "arrival or an empty round")
    spec = api.FedSpec(**base, async_mode="stale", max_staleness=ASYNC_K)
    states, rows = {}, {}
    for dev in ("cuda", "cpu"):
        tr = api.build_trainer(model, spec, dev)
        st, g = tr.init(0, params=params)
        got = []
        for b, row in zip(batches, ASYNC_ROWS):
            st, m = tr.step(st, b, g, arrival=torch.tensor(
                row, dtype=torch.float32))
            got.append(m["arrivals"].cpu().numpy())
        states[dev], rows[dev] = st, np.stack(got)
    for dev in ("cuda", "cpu"):
        if not np.array_equal(rows[dev], want):
            fail(f"phase 20a: {dev} realised rows {rows[dev].tolist()}, "
                 f"want {want.tolist()}")
    if not torch.equal(states["cuda"].staleness.cpu(),
                       states["cpu"].staleness):
        fail(f"phase 20a: counters card {states['cuda'].staleness} / CPU "
             f"{states['cpu'].staleness}")
    err = max(float((getattr(states["cuda"], v).cpu()
                     - getattr(states["cpu"], v)).abs().max())
              for v in ("x", "z", "y_tag"))
    if not err <= 1e-4:
        fail(f"phase 20a: card vs CPU max abs err {err} on x, z, y_tag")
    # K = 0 is the synchronous round, bit for bit, with generator draws
    k0 = {}
    for tag, extra in (("sync", {}),
                       ("async", dict(async_mode="stale", max_staleness=0))):
        tr = api.build_trainer(model, api.FedSpec(
            **base, participation=0.5, **extra), "cuda")
        st, g = tr.init(0, params=params)
        parts = []
        for b in batches[:3]:
            st, m = tr.step(st, b, g)
            parts.append(float(m["participation"]))
        k0[tag] = (st, parts)
    same = all(_bits_equal(torch, getattr(k0["sync"][0], v),
                           getattr(k0["async"][0], v)) for v in ("x", "z"))
    if not same or k0["sync"][1] != k0["async"][1]:
        fail(f"phase 20a: K = 0 async rounds differ from the synchronous "
             f"ones (participation {k0['sync'][1]} / {k0['async'][1]})")
    log(f"phase 20a: reduced gemma2-2b fp32, K {ASYNC_K}, rows "
        f"{want.astype(int).tolist()} realised on the card and the CPU "
        f"(counters {states['cpu'].staleness.tolist()}), x / z / y_tag "
        f"card vs CPU {err:.3g} (tolerance 1e-4); K = 0 equals the "
        f"synchronous round bit for bit over 3 rounds (participation "
        f"{k0['sync'][1]})")
    return {"card_vs_cpu_max_abs_err": err, "rows": want.tolist(),
            "k0_participation": k0["sync"][1]}


def _host_copy(torch, state):
    return {v: getattr(state, v).cpu() for v in ("x", "z", "y_tag",
                                                 "staleness")}


def _same_as_host(torch, host, state) -> list:
    """The fields of ``state`` that differ in their bits from ``host``
    (compared a column slab at a time on the card)."""
    bad = []
    for v, want in host.items():
        got = getattr(state, v)
        if want.ndim == 1:
            ok = _bits_equal(torch, want, got.cpu())
        else:
            ok = want.shape == got.shape and all(
                _bits_equal(torch, want[:, i:i + SLAB].to(got.device),
                            got[:, i:i + SLAB])
                for i in range(0, want.shape[1], SLAB))
        if not ok:
            bad.append(v)
    return bad


def async_broker_full_width(torch, base, cfg=None):
    """Phase 20b (docstring at the top); returns its record.  ``cfg``
    replaces the full-width config (a rehearsal at a reduced one)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.fed.broker import IncrementBroker, replay
    from repro_torch.models.model import build_model

    if cfg is None:
        cfg = dataclasses.replace(get_config(GEMMA.arch),
                                  n_layers=GEMMA.n_layers)
    spec = api.FedSpec(**base, async_mode="stale", max_staleness=ASYNC_K)
    trainer = api.build_trainer(build_model(cfg), spec, "cuda")
    shape = InputShape("async", MAIN_SEQ, MAIN_BATCH, "train")
    R = ASYNC_BROKER_ROUNDS
    want = expected_counts(R, round_uplink=R, round_downlink=R,
                           fedplt_update=R * N_EPOCHS)

    def drive(label, run):
        """``run(round_fn, holder)`` from a fresh init, the launch counts
        zeroed just before and read just after.  ``holder`` is a list
        holding the initial state, which ``run`` pops into the broker's
        call: no other frame keeps it, so each state is freed as the next
        one replaces it."""
        holder = list(trainer.init(0))
        gen = holder.pop()
        ms, losses = [], []

        def round_fn(s, u):
            b = make_batch_for(cfg, shape, torch.Generator(
                device="cuda").manual_seed(100 + len(ms)), n_agents=FULL_N,
                device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, m = trainer.step(s, b, gen, arrival=torch.as_tensor(u))
            losses.append(float(m["loss"]))     # waits for the device
            ms.append(1e3 * (time.perf_counter() - t0))
            return s

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, sched = run(round_fn, holder)
        torch.cuda.synchronize()
        counts, peak = kernels.launch_counts(), torch.cuda.max_memory_allocated()
        if counts != want:
            fail(f"phase 20b {label}: launch counts {counts}, want {want}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"phase 20b {label}: non-finite losses {losses}")
        if peak > 80e9:
            fail(f"phase 20b {label}: peak {peak / 1e9:.2f} GB")
        return state, gen, sched, dict(round_ms=ms, losses=losses,
                                       peak_gb=peak / 1e9)

    broker = IncrementBroker(
        FULL_N, ASYNC_K, grace=ASYNC_GRACE,
        latency_fn=lambda a, r: ASYNC_LATENCY[0 if a == 0 else 1])
    state, _, sched, run1 = drive(
        "broker", lambda f, h: broker.run(f, h.pop(), R))
    arrivals, released = sched.effective_counts()
    if not (released > arrivals).any():
        fail(f"phase 20b: the broker's schedule {sched.arrivals.tolist()} "
             f"holds no stale arrival")
    host = _host_copy(torch, state)
    del state
    torch.cuda.empty_cache()
    state, gen, _, run2 = drive(
        "replay", lambda f, h: (replay(f, h.pop(), sched), sched))
    bad = _same_as_host(torch, host, state)
    if bad:
        fail(f"phase 20b: the replay's {bad} differ from the broker run's")
    if run1["losses"] != run2["losses"]:
        fail(f"phase 20b: losses {run1['losses']} / {run2['losses']}")
    del host
    prof = profile_round(torch, trainer, state, gen, cfg, "phase 20b")
    log(f"phase 20b: gemma2-2b (2 layers, packed bf16) K {ASYNC_K}, "
        f"{R} broker rounds (agent 0 {ASYNC_LATENCY[0] * 1e3:.0f} ms, the "
        f"others {ASYNC_LATENCY[1] * 1e3:.0f} ms, grace "
        f"{ASYNC_GRACE * 1e3:.0f} ms): schedule "
        f"{sched.arrivals.astype(int).tolist()}, released rounds "
        f"{released.tolist()} for {arrivals.tolist()} arrivals; replay bit "
        f"for bit (x, z, y_tag, counters); launches {want} in each run; "
        f"round ms {[round(v, 1) for v in run1['round_ms']]} (replay "
        f"{[round(v, 1) for v in run2['round_ms']]}); peak "
        f"{run1['peak_gb']:.2f} / {run2['peak_gb']:.2f} GB")
    del state, trainer
    torch.cuda.empty_cache()
    return {"schedule": sched.arrivals.tolist(),
            "released_rounds": released.tolist(),
            "arrivals": arrivals.tolist(), "broker": run1, "replay": run2,
            "counts": want, "profile": prof}


def async_dense_cell(torch):
    """Phase 20e (docstring at the top); returns its record."""
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, PrivacySpec, build_trainer

    c = ASYNC_DENSE
    problem = make_logreg_problem(**PAPER_PROBLEM)
    spec = FedSpec(rho=1.0, n_epochs=5, participation=c["participation"],
                   async_mode="stale", max_staleness=c["K"],
                   privacy=PrivacySpec(tau=c["tau"]))
    noise = torch.randn((c["rounds"], 5, problem.n_agents, problem.dim),
                        generator=torch.Generator().manual_seed(3))
    card = build_trainer(problem, spec, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, crit, sched = card.run_recorded(0, c["rounds"], noise=noise)
    crit = crit.cpu()
    ms = 1e3 * (time.perf_counter() - t0) / c["rounds"]
    sched = sched.cpu()
    back, crit2 = card.replay(0, sched, noise=noise)
    if not (all(_bits_equal(torch, getattr(state, v), getattr(back, v))
                for v in ("x", "z", "y_tag", "staleness"))
            and _bits_equal(torch, crit, crit2.cpu())):
        fail("phase 20e: the card's replay differs from its recorded run")
    cpu = build_trainer(problem, spec, device="cpu")
    cstate, ccrit = cpu.replay(0, sched, noise=noise)
    err = _state_err(torch, back, cstate)
    if not err <= 1e-5 or not torch.equal(back.staleness.cpu(),
                                          cstate.staleness):
        fail(f"phase 20e: card vs CPU replay differ by {err}")
    reps = [tr.effective_privacy_report(sched.numpy())
            for tr in (card, cpu)]
    if reps[0] != reps[1]:
        fail("phase 20e: the effective privacy reports differ")
    arrivals, released = (
        [a.arrivals for a in reps[0].per_agent], [a.K for a in reps[0].per_agent])
    stale = sum(r > a for r, a in zip(released, arrivals))
    if not stale:
        fail("phase 20e: no agent released stale work")
    log(f"phase 20e: the paper's cell (N 100, q 250, n 5), K {c['K']}, "
        f"participation {c['participation']}, noisy GD (tau {c['tau']}, "
        f"given noise), {c['rounds']} rounds: replay bit for bit on the "
        f"card, the CPU's replay within {err:.3g} (tolerance 1e-5); "
        f"{stale} agents released stale work; effective eps max "
        f"{reps[0].adp_eps:.4f} (nominal K {reps[0].K}); {ms:.3f} ms a "
        f"round on the card (host clock)")
    return {"card_vs_cpu": err, "adp_eps": reps[0].adp_eps,
            "agents_with_stale_work": stale, "card_ms_per_round": ms,
            "final_crit": float(crit[-1])}


ASYNC_RESUME = (("fp32 async K 2", "float32",
                 {"async": (ASYNC_K, 0.5)}),)


def async_phase(torch, base):
    """Phase 20: 20a-20e; returns their record."""
    from repro_torch.fed.api import CompressionSpec, FedSpec

    rec = {"20a": async_reduced_parity(torch),
           "20b": async_broker_full_width(torch, base)}
    counts, hist, peak = train_phase(
        torch, "phase 20c async topk 0.25 (K 2, participation 0.5)",
        FedSpec(**dict(base, participation=0.5), async_mode="stale",
                max_staleness=ASYNC_K,
                compression=CompressionSpec("topk", ratio=0.25)), 3,
        expected_counts(3, round_uplink=3, round_downlink=3, fedplt_update=6,
                        rank_select=3))
    rec["20c"] = {"counts": counts, "round_ms": [1e3 * h["dt"] for h in hist],
                  "losses": [h["loss"] for h in hist],
                  "arrivals": [h["arrivals"] for h in hist],
                  "peak_gb": peak / 1e9}
    rec["20d"] = resume_phase(torch, ASYNC_RESUME, legs=2, tag="20d")
    rec["20e"] = async_dense_cell(torch)
    return rec


def async_phases(torch) -> int:
    """``--async``: build the kernels, run phase 20 alone and print its
    record as one JSON line."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    rec = async_phase(torch, MAIN_SPEC)
    log(json.dumps({"async": rec, "seconds": round(time.time() - t0, 1),
                    "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# Phase 21: heterogeneous agent groups (no new kernel)
# ---------------------------------------------------------------------------

GROUPS = "2*gd,2*agd:n_epochs=1:gamma=0.02"
GROUPS_PART = "3*gd:participation=0.5,1*agd:n_epochs=1"
GROUPS_STRADDLE = "1*gd,3*agd"
GROUPS_DENSE = "50*gd,50*agd"
GROUPS_DENSE_DP = "50*gd,50*gd:n_epochs=2"
GROUPS_ROUNDS = 3
GROUPS_MESH_ROUNDS = 2
GROUPS_DENSE_ROUNDS, GROUPS_DP_ROUNDS = 200, 100
GROUPS_PEAK_GB = 64.0


def group_launches(groups, rounds, layers):
    """A grouped round's launches of the full-width trainer: every
    agent's every local epoch runs one flash forward and backward per
    layer; each gd-type group runs one ``fedplt_update`` an epoch on its
    row slice (agd never fuses); one uplink and one downlink a round.
    ``groups``: ``(size, solver, n_epochs)`` a group."""
    agent_epochs = sum(size * ne for size, _, ne in groups)
    return expected_counts(
        0, round_uplink=rounds, round_downlink=rounds,
        fedplt_update=rounds * sum(ne for _, s, ne in groups if s != "agd"),
        flash_attention_fwd=rounds * agent_epochs * layers,
        flash_attention_bwd=rounds * agent_epochs * layers)


def _resolved(spec):
    return [(g.size, g.solver, g.n_epochs) for g in spec.resolved_groups()]


def groups_reduced_parity(torch):
    """Phase 21a (docstring at the top); returns its record."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(), n_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [make_batch_for(cfg, InputShape("small", 64, 8, "train"), gen,
                              n_agents=FULL_N) for _ in range(2)]
    base = dict(n_agents=FULL_N, n_epochs=2, gamma=0.05, weight_decay=0.01,
                engine_backend="fused", use_fused_update=True,
                agent_groups=GROUPS)
    rec = {}
    for label, kw, rows in (
            ("packed", dict(state_layout="packed"), None),
            ("packed async K 2", dict(state_layout="packed",
                                      async_mode="stale",
                                      max_staleness=ASYNC_K),
             ASYNC_ROWS[:2]),
            ("tree", dict(state_layout="tree"), None)):
        spec = api.FedSpec(**base, **kw)
        states = {}
        for dev in ("cuda", "cpu"):
            tr = api.build_trainer(model, spec, dev)
            st, g = tr.init(0, params=params)
            for r, b in enumerate(batches):
                row = torch.ones(FULL_N) if rows is None else torch.tensor(
                    rows[r], dtype=torch.float32)
                st, _ = tr.step(st, b, g, u=row)
            states[dev] = st
        if kw["state_layout"] == "tree":
            err = max(float((getattr(states["cuda"], var)[n].cpu()
                             - l).abs().max())
                      for var in ("x", "z") for n, l in
                      getattr(states["cpu"], var).items())
            if not err <= 1e-4:
                fail(f"phase 21a {label}: card vs CPU max abs err {err}")
        else:
            err, _ = card_vs_cpu(torch, states, f"phase 21a {label}")
        if rows is not None and not torch.equal(
                states["cuda"].staleness.cpu(), states["cpu"].staleness):
            fail(f"phase 21a {label}: counters card "
                 f"{states['cuda'].staleness} / CPU {states['cpu'].staleness}")
        rec[label] = err
        log(f"phase 21a {label}: reduced gemma2-2b fp32, N {FULL_N}, groups "
            f"{GROUPS}, 2 rounds card (kernels) vs CPU (plain versions): max "
            f"abs err {err:.3g} (tolerance 1e-4)")
    return rec


def groups_full_width(torch, base, main_prof):
    """Phases 21b and 21c (docstring at the top); returns their record.
    ``main_prof``: phase 4's profiled round, shown beside 21b's."""
    from repro_torch.fed import api, engine
    from repro_torch.kernels.round_edge import ops as edge_ops

    rec = {}
    spec = api.FedSpec(**base, agent_groups=GROUPS)
    want = group_launches(_resolved(spec), GROUPS_ROUNDS, GEMMA.attn_layers)
    prof = {}
    counts, hist, peak = train_phase(
        torch, f"phase 21b groups {GROUPS}", spec, GROUPS_ROUNDS, want,
        profile=True, profile_out=prof)
    if peak > GROUPS_PEAK_GB * 1e9:
        fail(f"phase 21b: peak {peak / 1e9:.2f} GB > {GROUPS_PEAK_GB} GB")
    per_round = {k: v // GROUPS_ROUNDS for k, v in counts.items() if v}
    rec["21b"] = {"counts": counts, "per_round": per_round,
                  "round_ms": [1e3 * h["dt"] for h in hist],
                  "losses": [h["loss"] for h in hist], "peak_gb": peak / 1e9,
                  "profile": prof}
    side = {k: {"groups_ms": p.get("groups_ms"), "wall_ms": p.get("wall_ms"),
                "device_busy_ms": p.get("device_busy_ms"),
                "idle_share": p.get("idle_share")}
            for k, p in (("phase 4", main_prof), ("phase 21b", prof))}
    log(f"phase 21b: per round {per_round}; round ms "
        f"{[round(v, 1) for v in rec['21b']['round_ms']]}; peak "
        f"{peak / 1e9:.2f} GB; profiled groups beside phase 4's:")
    log(json.dumps({"groups_vs_phase4": side}))

    # 21c: the per-group participation row through round_downlink
    drawn, passed = [], []
    draw, downlink = engine.participation_mask, edge_ops.round_downlink

    def drawing(*a, **kw):
        u = draw(*a, **kw)
        drawn.append(u.clone())
        return u

    def passing(x, w, z, u, *a, **kw):
        passed.append(u.clone())
        return downlink(x, w, z, u, *a, **kw)

    spec = api.FedSpec(**base, agent_groups=GROUPS_PART)
    want = group_launches(_resolved(spec), GROUPS_ROUNDS, GEMMA.attn_layers)
    engine.participation_mask, edge_ops.round_downlink = drawing, passing
    try:
        counts, hist, peak = train_phase(
            torch, f"phase 21c groups {GROUPS_PART}", spec, GROUPS_ROUNDS,
            want)
    finally:
        engine.participation_mask, edge_ops.round_downlink = draw, downlink
    rows = [u.cpu() for u in drawn]
    if len(rows) != GROUPS_ROUNDS or len(passed) != GROUPS_ROUNDS or not all(
            _bits_equal(torch, d, p.cpu()) for d, p in zip(rows, passed)):
        fail(f"phase 21c: the downlink's rows {[p.tolist() for p in passed]} "
             f"differ from the drawn rows {[d.tolist() for d in rows]}")
    if not all(float(r[3]) == 1.0 for r in rows):
        fail(f"phase 21c: the agd agent (participation 1) missed a round: "
             f"{[r.tolist() for r in rows]}")
    for h, r in zip(hist, rows):
        if h["participation"] != float(r.mean()):
            fail(f"phase 21c: participation {h['participation']} for the "
                 f"row {r.tolist()}")
    rec["21c"] = {"counts": counts, "rows": [r.tolist() for r in rows],
                  "round_ms": [1e3 * h["dt"] for h in hist],
                  "losses": [h["loss"] for h in hist], "peak_gb": peak / 1e9}
    log(f"phase 21c: drawn rows {rec['21c']['rows']} (group rates 0.5, 0.5, "
        f"0.5, 1) equal the rows round_downlink took; round ms "
        f"{[round(v, 1) for v in rec['21c']['round_ms']]}; peak "
        f"{peak / 1e9:.2f} GB")
    return rec


def _groups_mesh_run(torch, device, mesh_shape=None):
    """21d's run: reduced gemma2-2b bf16, N 4, packed, fused, ``GROUPS``,
    ``GROUPS_MESH_ROUNDS`` rounds (this rank's block under a mesh): the
    state after each round (on the CPU) and each round's launches."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              n_kv_heads=2, dtype="bfloat16")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    batches = [make_batch_for(cfg, InputShape("small", 64, 8, "train"), gen,
                              n_agents=FULL_N)
               for _ in range(GROUPS_MESH_ROUNDS)]
    tr = api.build_trainer(model, api.FedSpec(
        n_agents=FULL_N, n_epochs=2, gamma=0.05, state_layout="packed",
        engine_backend="fused", use_fused_update=True, agent_groups=GROUPS,
        mesh_shape=mesh_shape), device)
    st, g = tr.init(0)
    out = []
    for b in batches:
        kernels.reset_launch_counts()
        st, m = tr.step(st, b, g)
        out.append(dict(x=st.x.cpu(), z=st.z.cpu(), loss=float(m["loss"]),
                        counts=kernels.launch_counts()))
    return out


def _groups_mesh_worker(rank, world, store, out_dir):
    """21d on one of two gloo ranks on the one card: the grouped run under
    2x1, and the straddling groups refused by the spec and by the
    engine."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        from repro_torch.fed import api, engine

        res = {"rounds": _groups_mesh_run(torch, "cuda:0", "2x1")}
        refused = []
        try:
            api.FedSpec(n_agents=FULL_N, gamma=0.05, mesh_shape="2x1",
                        agent_groups=GROUPS_STRADDLE).validate()
        except ValueError as e:
            refused.append(str(e))
        mesh = api.FedSpec(mesh_shape="2x1").build_mesh("cuda:0")
        solver = engine.other_rank_solver
        try:
            engine.validate_mesh(
                engine.RoundConfig(n_agents=FULL_N), mesh,
                local_solver=(engine.SolverGroup(1, solver),
                              engine.SolverGroup(3, solver)))
        except ValueError as e:
            refused.append(str(e))
        res["refused"] = refused
        torch.save(res, os.path.join(out_dir, f"groups-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def groups_mesh_phase(torch):
    """Phase 21d (docstring at the top); returns its record."""
    import shutil

    import torch.multiprocessing as mp

    want = _groups_mesh_run(torch, "cuda")
    root = _scratch_dir()
    try:
        try:
            mp.start_processes(_groups_mesh_worker,
                               args=(2, os.path.join(root, "store"), root),
                               nprocs=2, join=True, start_method="spawn")
        except Exception as e:
            text = str(e)
            last = (text.strip().splitlines() or [type(e).__name__])[-1]
            fail(f"phase 21d: a rank failed: {last}")
        ranks = [torch.load(os.path.join(root, f"groups-rank{r}.pt"))
                 for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    errs = []
    for i, w in enumerate(want):
        # the rank's launches: rank 0 holds the gd rows, rank 1 the agd rows
        for r, res in enumerate(ranks):
            got = res["rounds"][i]["counts"]
            layers = 2
            agent_epochs = 2 * (N_EPOCHS if r == 0 else 1)
            need = expected_counts(
                0, round_uplink_partial=1, round_downlink_presummed=1,
                fedplt_update=N_EPOCHS if r == 0 else 0,
                flash_attention_fwd=agent_epochs * layers,
                flash_attention_bwd=agent_epochs * layers)
            if got != need:
                fail(f"phase 21d: rank {r} round {i} launches {got}, want "
                     f"{need}")
            if res["rounds"][i]["loss"] != ranks[0]["rounds"][i]["loss"]:
                fail(f"phase 21d: the ranks' round {i} losses differ")
        for var in ("x", "z"):
            got = torch.cat([res["rounds"][i][var] for res in ranks])
            if i == 0:
                # identical rows in: the agent mean is exact on both sides
                if not _bits_equal(torch, got, w[var]):
                    fail(f"phase 21d: round 1 {var} under 2x1 differs from "
                         f"the unsharded run's")
            d = (got.float() - w[var].float()).abs().max()
            scale = w[var].float().abs().max()
            errs.append(float(d / scale))
            if not float(d) <= 2.0 ** -5 * float(scale):
                fail(f"phase 21d: round {i + 1} {var} max abs difference "
                     f"{float(d)} from the unsharded run's (max |{var}| "
                     f"{float(scale)})")
    for r, res in enumerate(ranks):
        if len(res["refused"]) != 2 or "straddle" not in res["refused"][0] \
                or "inside an agent shard" not in res["refused"][1]:
            fail(f"phase 21d: rank {r}: the straddling groups were not "
                 f"refused ({res['refused']})")
    log(f"phase 21d: reduced gemma2-2b bf16, groups {GROUPS} on two gloo "
        f"ranks on the card under 2x1 (one group a rank: fedplt_update "
        f"{N_EPOCHS} / 0 a round, flash {4 * N_EPOCHS} / 4, one partial and "
        f"one presummed launch a rank a round): round 1 bit for bit the "
        f"unsharded grouped run, round {GROUPS_MESH_ROUNDS} within "
        f"{max(errs):.3g} of max |x|, |z| (the ranks' bf16 partial sums; "
        f"bound 2^-5); {GROUPS_STRADDLE} refused by the spec and the engine")
    return {"rel_diff": errs, "refused": ranks[0]["refused"],
            "losses": [r["loss"] for r in ranks[0]["rounds"]]}


def groups_dense_cell(torch):
    """Phase 21e (docstring at the top); returns its record."""
    from repro_torch.core.metrics import hitting_round
    from repro_torch.core.problem import make_logreg_problem
    from repro_torch.fed.api import FedSpec, PrivacySpec, build_trainer

    problem = make_logreg_problem(**PAPER_PROBLEM)
    rec = {}
    spec = FedSpec(rho=1.0, n_epochs=5, agent_groups=GROUPS_DENSE)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = build_trainer(problem, spec, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, crit = tr.run(0, GROUPS_DENSE_ROUNDS)
        crit = crit.cpu().numpy()
        res[dev] = (state, crit, 1e3 * (time.perf_counter() - t0)
                    / GROUPS_DENSE_ROUNDS)
    hit = {d: hitting_round(r[1]) for d, r in res.items()}
    err = _state_err(torch, res["cuda"][0], res["cpu"][0])
    if hit["cuda"] is None or hit["cuda"] != hit["cpu"] or not err <= 1e-5:
        fail(f"phase 21e: hitting rounds card {hit['cuda']} / CPU "
             f"{hit['cpu']}, states {err}")
    rec["gd-agd"] = dict(hitting_round=hit["cuda"], state_err=err,
                         card_ms_per_round=res["cuda"][2])
    # DP: gd-type groups (agd takes no noise), given noise (N_e 2: the
    # groups' largest), the per-agent privacy table of each trainer
    spec = FedSpec(rho=1.0, n_epochs=1, agent_groups=GROUPS_DENSE_DP,
                   privacy=PrivacySpec(tau=ASYNC_DENSE["tau"]))
    noise = torch.randn((GROUPS_DP_ROUNDS, 2, problem.n_agents, problem.dim),
                        generator=torch.Generator().manual_seed(3))
    states, reps = {}, {}
    for dev in ("cuda", "cpu"):
        tr = build_trainer(problem, spec, device=dev)
        states[dev] = tr.run(0, GROUPS_DP_ROUNDS, noise=noise)[0]
        reps[dev] = tr.privacy_report(GROUPS_DP_ROUNDS)
    dp_err = _state_err(torch, states["cuda"], states["cpu"])
    if not dp_err <= 1e-5 or reps["cuda"] != reps["cpu"]:
        fail(f"phase 21e DP: card vs CPU states {dp_err}, reports equal "
             f"{reps['cuda'] == reps['cpu']}")
    table = sorted({(a.n_epochs, a.adp_eps) for a in reps["cuda"].per_agent})
    rec["dp"] = dict(state_err=dp_err, adp_eps=reps["cuda"].adp_eps,
                     per_group=table)
    log(f"phase 21e: the paper's cell (N 100, q 250, n 5) with groups "
        f"{GROUPS_DENSE}: hitting round {hit['cuda']} on the card and the CPU "
        f"(states {err:.3g}, tolerance 1e-5; {res['cuda'][2]:.3f} ms a round "
        f"on the card, host clock); DP groups {GROUPS_DENSE_DP} (tau "
        f"{ASYNC_DENSE['tau']}, given noise) {GROUPS_DP_ROUNDS} rounds: states "
        f"{dp_err:.3g}, the per-agent tables equal (eps_i by N_e: {table}; "
        f"headline {reps['cuda'].adp_eps:.4f})")
    return rec


def groups_phase(torch, base, main_prof):
    """Phase 21: 21a-21e; returns their record."""
    return {"21a": groups_reduced_parity(torch),
            **groups_full_width(torch, base, main_prof),
            "21d": groups_mesh_phase(torch),
            "21e": groups_dense_cell(torch)}


def groups_phases(torch) -> int:
    """``--groups``: build the kernels, run phase 4's profiled round (one
    round, for the comparison) and phase 21 alone, and print its record as
    one JSON line."""
    from repro_torch import kernels
    from repro_torch.fed.api import FedSpec
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    main_prof = {}
    train_phase(torch, "phase 4 main path (one round, for 21b)",
                FedSpec(**MAIN_SPEC), 1,
                expected_counts(1, round_uplink=1, round_downlink=1,
                                fedplt_update=N_EPOCHS),
                profile=True, profile_out=main_prof)
    rec = groups_phase(torch, MAIN_SPEC, main_prof)
    log(json.dumps({"groups": rec, "seconds": round(time.time() - t0, 1),
                    "card": smi}))
    return 0


# ---------------------------------------------------------------------------
# Phase 22: the analysis tools on the card (the dry run and the measured
# peaks, a profiled round's report, the tree layout under a model axis)
# ---------------------------------------------------------------------------

CARD_BYTES = 80e9                   # the H100's device memory
# 22a: the configurations whose cuts the dry run sizes at N 4
CUT_ARCHS = ("gemma3-12b", "nemotron-4-340b", "qwen2-moe-a2.7b",
             "internvl2-26b")
PEAK_TOP = 5                        # 22a: the live buffers listed at a peak
# 22c: the tree-layout mesh, and its tolerances against the 1x1 run, for
# the full-width bf16 cell and the reduced float32 MoE (its experts on the
# model axis): each leaf's increment over the round (x - x0, z - x0) within
# TREE_INC[cell] of the 1x1 run's in norm, and the loss within
# TREE_LOSS[cell] relative.  Set from the runs read on the H100: bf16 0.111
# in norm (dt_proj, whose increment is a few bf16 ulps of x: the batch
# split reorders the gradient's sums and flips roundings) and a loss gap of
# 3.9e-5; float32 bit for bit (an MoE's model ranks each run the whole
# batch at weight 1/m).  A gradient that skips its model_sum, or lands in
# the mirrored block, read 0.49-3.8 in norm and 0.10-1.2 in loss.
TREE_MESH = "1x2"
TREE_INC = {"full": 0.25, "reduced": 1e-6}
TREE_LOSS = {"full": 2e-4, "reduced": 1e-6}


def _site(frames) -> str:
    """An allocation's innermost frame in the port (else its innermost
    frame): ``file:line function``, which names the tensor it made."""
    frames = frames or []
    own = [f for f in frames if "repro_torch" in f.get("filename", "")]
    f = (own or frames or [{}])[0]
    name = f.get("filename", "?").split("src/repro_torch/")[-1]
    return f"{name}:{f.get('line', '?')} {f.get('name', '?')}"


def peak_buffers(torch, fn):
    """``fn()`` under ``torch.cuda.memory._record_memory_history``:
    ``(fn's result, record)``, the record holding the measured peak
    (``max_memory_allocated``), the traced allocations' own peak (replayed
    from the snapshot's trace: allocations live since recording began)
    and the :data:`PEAK_TOP` largest buffers live at that peak, each by
    its allocation site."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=4_000_000,
                                             stacks="python")
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = [e for trace in snap["device_traces"] for e in trace]
    live, total, best, best_i = {}, 0, 0, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > best:
                best, best_i = total, i
        elif e["action"] in ("free_requested", "free_completed"):
            total -= live.pop(e["addr"], 0)
    at_peak = {}
    for e in events[:best_i + 1]:
        if e["action"] == "alloc":
            at_peak[e["addr"]] = e
        elif e["action"] in ("free_requested", "free_completed"):
            at_peak.pop(e["addr"], None)
    top = sorted(at_peak.values(), key=lambda e: -e["size"])[:PEAK_TOP]
    sites = {}
    for e in at_peak.values():
        site = _site(e.get("frames"))
        sites[site] = sites.get(site, 0) + e["size"]
    return out, dict(
        measured_peak=torch.cuda.max_memory_allocated(), base=base,
        traced_peak=best, events=len(events),
        top=[dict(bytes=e["size"], site=_site(e.get("frames")))
             for e in top],
        sites=sorted(sites.items(), key=lambda kv: -kv[1])[:PEAK_TOP])


def _resident(cfg, n_agents=FULL_N, agents=1, model=1):
    """The dry run's resident bytes a rank holds of ``x`` and ``z`` in the
    layout the model trains in (packed where its leaves share a dtype)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import build_model

    st = dryrun.state_bytes(build_model(cfg), n_agents, agents, model)
    layout = "packed" if st["packed"] is not None else "tree"
    return 2 * st[layout], layout


def dryrun_phase(torch, base, gemma_peak):
    """Phase 22a: the dry run over every case, the measured peaks of
    falcon-mamba-7b's and qwen2-moe-a2.7b's tree rounds with the buffers
    that set them, and the cuts the dry run puts under 80 GB; returns
    the record."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.fed.api import FedSpec
    from repro_torch.launch import dryrun

    t0 = time.time()
    cases = [dryrun.run_case(a, s, m, verbose=False) for a in ARCH_IDS
             for s in SHAPES for m in dryrun.MESHES]
    for r in cases:
        line = f"phase 22a dryrun: {r['arch']} {r['shape']} {r['mesh']} "
        if r["status"] != "ok":
            log(line + r["status"] + " " + r.get("reason", r.get("error", "")))
            continue
        res = r["resident_bytes_per_rank"]
        rl = r["roofline"]
        mem = ", ".join(f"{k} {(v['sync'] if isinstance(v, dict) else v) / 1e9:.3f}"
                        for k, v in res.items() if v is not None)
        log(line + f"ok params {r['params']:,} resident GB/rank ({mem}) "
            f"model_flops {r['model_flops']:.3e} -> {rl['bottleneck']} "
            f"({rl['compute_s']:.3e} / {rl['memory_s']:.3e} / "
            f"{rl['collective_s']:.3e} s)")
    failed = [r for r in cases if r["status"] == "FAILED"]
    if failed:
        fail(f"phase 22a: the dry run failed {len(failed)} cases: "
             f"{failed[0]['arch']} {failed[0]['shape']}: {failed[0]['error']}")
    rec = {"cases": len(cases), "seconds": round(time.time() - t0, 2),
           "ok": sum(r["status"] == "ok" for r in cases), "peaks": {}}
    spec = FedSpec(**dict(base, state_layout="tree"))
    for cell in (MAMBA, QWEN):
        label = f"phase 22a/{cell.arch} ({cell.n_layers} layers, tree layout)"
        (counts, hist, _), mem = peak_buffers(torch, lambda: train_phase(
            torch, label, spec, 1,
            expected_counts(1, cell, fedplt_update=N_EPOCHS * cell.n_leaves),
            cell=cell))
        cfg = dataclasses.replace(get_config(cell.arch),
                                  n_layers=cell.n_layers)
        resident, layout = _resident(cfg)
        batch = MAIN_BATCH * MAIN_SEQ * 8 * 2       # int64 tokens, labels
        if resident + batch > mem["measured_peak"]:
            fail(f"{label}: the dry run's resident {resident / 1e9:.2f} GB "
                 f"exceeds the measured peak {mem['measured_peak'] / 1e9:.2f}")
        log(f"{label}: measured peak {mem['measured_peak'] / 1e9:.3f} GB "
            f"(traced {mem['traced_peak'] / 1e9:.3f} GB over "
            f"{mem['events']} events, {mem['base'] / 1e9:.3f} GB live "
            f"before); the dry run's resident x + z {resident / 1e9:.3f} GB "
            f"({layout}) and inputs {batch / 1e6:.1f} MB, under it; the "
            f"{PEAK_TOP} largest live buffers at the peak: "
            + "; ".join(f"{t['bytes'] / 1e9:.3f} GB {t['site']}"
                        for t in mem["top"])
            + f"; the {PEAK_TOP} sites holding most at the peak: "
            + "; ".join(f"{b / 1e9:.3f} GB {site}" for site, b in mem["sites"]))
        rec["peaks"][cell.arch] = dict(mem, resident=resident,
                                       layout=layout, loss=hist[0]["loss"])
    ratio = gemma_peak / _resident(dataclasses.replace(
        get_config(GEMMA.arch), n_layers=GEMMA.n_layers))[0]
    rec["gemma_peak_to_state"] = ratio
    rec["cuts"] = {}
    for arch in CUT_ARCHS:
        cfg = get_config(arch)
        r1, layout = _resident(dataclasses.replace(cfg, n_layers=1))
        r2, _ = _resident(dataclasses.replace(cfg, n_layers=2))
        per, fixed = r2 - r1, 2 * r1 - r2
        by_state = min(cfg.n_layers, int((CARD_BYTES - fixed) // per))
        scaled = min(cfg.n_layers,
                     int((CARD_BYTES / ratio - fixed) // per))
        rec["cuts"][arch] = dict(layout=layout, per_layer=per, fixed=fixed,
                                 layers_by_state=by_state,
                                 layers_scaled=scaled,
                                 of=cfg.n_layers)
        log(f"phase 22a cut: {arch} at N {FULL_N} ({layout} layout; x + z "
            f"{fixed / 1e9:.3f} GB + {per / 1e9:.3f} GB a layer): "
            f"{max(by_state, 0)} of {cfg.n_layers} layers fit 80 GB by "
            f"resident bytes; {max(scaled, 0)} by resident bytes scaled by "
            f"gemma2-2b's measured peak-to-state ratio {ratio:.3f}")
    return rec


def round_report(torch, trainer, state, cfg, out, prof):
    """Phase 22b on phase 4's trainer (its ``after`` hook): one steady
    round counted through :mod:`repro_torch.launch.profile_analysis`, its
    launches held to the kernels' own counts, the H100 roofline of the
    counts, and the MFU of an uncounted round's wall time, beside the
    device ms by kernel group of phase 4's profiled round ``prof`` (the
    same trainer, just before); fills ``out``."""
    from repro_torch import kernels
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.launch import profile_analysis, roofline

    shape = InputShape("22b", MAIN_SEQ, MAIN_BATCH, "train")
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = make_batch_for(cfg, shape, gen, n_agents=FULL_N, device="cuda")

    def one_round():
        _, m = trainer.step(state, batch, gen)
        float(m["loss"])
        torch.cuda.synchronize()

    _, c = profile_analysis.count(one_round)
    counts = kernels.launch_counts()
    want = expected_counts(1, round_uplink=1, round_downlink=1,
                           fedplt_update=N_EPOCHS)
    if counts != want:
        fail(f"phase 22b: launches {counts}, want {want}")
    if c.launches() != {k: v for k, v in counts.items() if v}:
        fail(f"phase 22b: the report's launches {c.launches()} are not the "
             f"launch counts {counts}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_round()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    mf = roofline.model_flops(cfg, shape, "train") * N_EPOCHS
    bw = card_bandwidth(torch.cuda.get_device_name(0))
    rl = roofline.analyze(c, mf, 1, bw)
    mfu = roofline.mfu(mf, wall)
    aten = {k: sum(v[k] for v in c.ops.values()) for k in ("flops", "bytes")}
    kern = {k: sum(v[k] for v in c.kernels.values())
            for k in ("flops", "bytes")}
    out.update(flops=c.flops, hbm_bytes=c.bytes, aten=aten, kernels=kern,
               launches=c.launches(), roofline=rl.as_dict(),
               model_flops=mf, round_s=walls, mfu=mfu,
               top_kernels=profile_analysis.top_kernels(c, 8, bw),
               top_collectives=profile_analysis.top_collectives(c),
               profile_groups_ms=prof.get("groups_ms"))
    log(f"phase 22b report: one steady round of phase 4's trainer counted: "
        f"{c.flops:.4e} FLOPs ({aten['flops']:.4e} in aten ops, "
        f"{kern['flops']:.4e} in the kernels), {c.bytes / 1e9:.3f} GB of "
        f"HBM traffic ({aten['bytes'] / 1e9:.3f} aten, "
        f"{kern['bytes'] / 1e9:.3f} kernels); launches {c.launches()} equal "
        f"kernels.launch_counts(); H100 roofline compute "
        f"{rl.compute_s * 1e3:.3f} ms, memory {rl.memory_s * 1e3:.3f} ms, "
        f"collective {rl.collective_s * 1e3:.3f} ms -> {rl.bottleneck}; "
        f"useful_ratio {rl.useful_ratio:.4f}; model FLOPs {mf:.4e} over the "
        f"median wall {wall * 1e3:.1f} ms of 3 uncounted rounds: MFU "
        f"{100 * mfu:.2f}% of {roofline.BF16_PEAK / 1e12:.0f} TFLOP/s")
    groups = {k: round(v, 2)
              for k, v in (prof.get("groups_ms") or {}).items()}
    log(f"phase 22b top kernels (least ms, name, calls, flops, bytes): "
        f"{[(round(r[0], 3),) + r[1:] for r in out['top_kernels']]}; "
        f"device ms by kernel group of phase 4's profiled round of the "
        f"same trainer: {groups}")


def _tree_mesh_spec(base, mesh_shape=None):
    from repro_torch.fed.api import FedSpec

    return FedSpec(**dict(base, state_layout="tree", mesh_shape=mesh_shape))


def _tree_mesh_run(torch, base, device, mesh_shape=None, reduced=False):
    """22c's run: falcon-mamba-7b at published width cut to 2 layers
    (``reduced``: the reduced qwen2-moe-a2.7b, float32, its 4 experts on
    the model axis), tree layout, one round from the seeded init; this
    rank's blocks (CPU), the loss, the seconds, the launches, the peak
    and the state's bytes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.fed import api
    from repro_torch.models.model import build_model

    if reduced:
        cfg = get_config(QWEN.arch).reduced()
        shape = InputShape("22c", 64, 8, "train")
    else:
        cfg = dataclasses.replace(get_config(MAMBA.arch),
                                  n_layers=MAMBA.n_layers)
        shape = InputShape("22c", MAIN_SEQ, MAIN_BATCH, "train")
    tr = api.build_trainer(build_model(cfg), _tree_mesh_spec(base, mesh_shape),
                           device)
    st, gen = tr.init(0)
    x0 = {k: v.cpu() for k, v in st.x.items()} if mesh_shape is None else None
    batch = {k: v.to(tr.device) for k, v in make_batch_for(
        cfg, shape, torch.Generator().manual_seed(5), n_agents=FULL_N).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    st, m = tr.step(st, batch, gen)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    secs = time.time() - t0
    nbytes = sum(l.numel() * l.element_size()
                 for v in (st.x, st.z) for l in v.values())
    return dict(x={k: v.cpu() for k, v in st.x.items()},
                z={k: v.cpu() for k, v in st.z.items()}, x0=x0, loss=loss,
                s=secs, counts=kernels.launch_counts(), state_bytes=nbytes,
                peak=torch.cuda.max_memory_allocated(),
                dims=None if tr.tree_blocks is None else tr.tree_blocks.dims)


def _tree_mesh_worker(rank, world, store, out_dir, base):
    """22c on one of two gloo ranks on the one card (two host threads
    each: the ranks share the host's cores)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        res = {"full": _tree_mesh_run(torch, base, "cuda:0", TREE_MESH),
               "reduced": _tree_mesh_run(torch, base, "cuda:0", TREE_MESH,
                                         reduced=True)}
        torch.save(res, os.path.join(out_dir, f"tree-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tree_increment_err(torch, ranks, want):
    """Each leaf's increments over the round, ``x - x0`` and ``z - x0``
    (``z0`` is ``x0``), of the ranks' gathered blocks against the 1x1
    run's (``ranks`` a list of per-rank ``{x, z, dims}``, ``want`` the 1x1
    run with its init ``x0``), on the card in float32: ``{var: [norm
    ratio ||d - d_1x1|| / ||d_1x1||, leaf, max ratio max|d - d_1x1| /
    max|d_1x1|, leaf]}``, each the worst over the leaves (a replicated
    leaf read on rank 0), and the replicated leaves that differ between
    the ranks.  Fails where a gathered leaf's shape or dtype is off."""
    out, differ = {}, []
    for var in ("x", "z"):
        worst = [0.0, None, 0.0, None]
        for k, w in want[var].items():
            d = ranks[0]["dims"][k]
            if d is None:
                got = ranks[0][var][k]
                if not all(torch.equal(r[var][k], got) for r in ranks[1:]):
                    differ.append(f"{var}.{k}")
            else:
                got = torch.cat([r[var][k] for r in ranks], d + 1)
            if got.shape != w.shape or got.dtype != w.dtype:
                fail(f"phase 22c: {var}.{k} gathered {tuple(got.shape)} "
                     f"{got.dtype}, want {tuple(w.shape)} {w.dtype}")
            x0 = want["x0"][k].cuda().float()
            dw = w.cuda().float() - x0
            diff = got.cuda().float() - x0 - dw
            ref_norm, ref_max = float(dw.norm()), float(dw.abs().max())
            moved = math.inf if bool(diff.any()) else 0.0
            e_norm = float(diff.norm()) / ref_norm if ref_norm else moved
            e_max = float(diff.abs().max()) / ref_max if ref_max else moved
            if e_norm >= worst[0]:
                worst[:2] = [e_norm, k]
            if e_max >= worst[2]:
                worst[2:] = [e_max, k]
            del x0, dw, diff
        out[var] = worst
    return out, differ


def tree_mesh_phase(torch, base):
    """Phase 22c: the tree layout under a 1x2 model axis on two gloo
    ranks sharing the card, each cell held to its 1x1 run in this
    process; returns the record."""
    import shutil

    import torch.multiprocessing as mp

    want = {"full": _tree_mesh_run(torch, base, "cuda"),
            "reduced": _tree_mesh_run(torch, base, "cuda", reduced=True)}
    torch.cuda.empty_cache()
    root = _scratch_dir()
    try:
        t0 = time.time()
        try:
            mp.start_processes(_tree_mesh_worker,
                               args=(2, os.path.join(root, "store"), root,
                                     base),
                               nprocs=2, join=True, start_method="spawn")
        except Exception as e:
            text = str(e)
            fail(f"phase 22c: a rank failed: "
                 f"{(text.strip().splitlines() or [type(e).__name__])[-1]}")
        spawn_s = time.time() - t0
        ranks = [torch.load(os.path.join(root, f"tree-rank{r}.pt"))
                 for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = {"spawn_s": spawn_s}
    bad = []
    for cell in ("full", "reduced"):
        rk = [r[cell] for r in ranks]
        w = want[cell]
        inc, differ = _tree_increment_err(torch, rk, w)
        bad += [f"{cell} replicated {k} differs between the ranks"
                for k in differ]
        loss_gap = max(abs(r["loss"] - w["loss"]) / abs(w["loss"])
                       for r in rk)
        bad += [f"{cell} {var}.{v[1]} increment {v[0]:.4g} of its norm off "
                f"the 1x1 run's (limit {TREE_INC[cell]:g})"
                for var, v in inc.items() if not v[0] <= TREE_INC[cell]]
        if not loss_gap <= TREE_LOSS[cell]:
            bad.append(f"{cell} loss {loss_gap:.4g} relative off the 1x1 "
                       f"run's (limit {TREE_LOSS[cell]:g})")
        split = sorted(k for k, d in rk[0]["dims"].items() if d is not None)
        if cell == "full":
            lru = FULL_N * N_EPOCHS * MAMBA.scan_layers
            want_c = expected_counts(fedplt_update=N_EPOCHS * MAMBA.n_leaves,
                                     lru_scan_fwd=lru, lru_scan_bwd=lru)
            for i, r in enumerate(rk):
                if r["counts"] != want_c:
                    fail(f"phase 22c: rank {i} launches {r['counts']}, "
                         f"want {want_c}")
            if w["counts"] != want_c:
                fail(f"phase 22c: the 1x1 run's launches {w['counts']}, "
                     f"want {want_c}")
        rec[cell] = dict(increment_err=inc, loss_gap=loss_gap,
                         losses=[r["loss"] for r in rk],
                         loss_1x1=w["loss"], seconds=[r["s"] for r in rk],
                         seconds_1x1=w["s"],
                         state_gb=[r["state_bytes"] / 1e9 for r in rk],
                         state_gb_1x1=w["state_bytes"] / 1e9,
                         peak_gb=[r["peak"] / 1e9 for r in rk],
                         peak_gb_1x1=w["peak"] / 1e9, split_leaves=split)
        what = (f"{MAMBA.arch} at published width, {MAMBA.n_layers} "
                f"layers, bf16" if cell == "full"
                else f"reduced {QWEN.arch}, float32")
        log(f"phase 22c: {what}, tree layout, N {FULL_N}, one round under "
            f"{TREE_MESH} on two gloo ranks on the card against the 1x1 "
            f"run: {len(split)} leaves split ({', '.join(split)}); each "
            f"leaf's increment (x - x0, z - x0) off the 1x1 run's, worst "
            f"leaf: "
            + "; ".join(f"{var} {v[0]:.4g} of its norm ({v[1]}), {v[2]:.4g} "
                        f"of its largest entry ({v[3]})"
                        for var, v in inc.items())
            + f" (limit {TREE_INC[cell]:g} in norm); loss {loss_gap:.4g} "
            f"relative off (limit {TREE_LOSS[cell]:g}); losses "
            f"{rec[cell]['losses']} (1x1 {w['loss']}); state x + z "
            f"per rank {[round(v, 3) for v in rec[cell]['state_gb']]} GB "
            f"(1x1 {rec[cell]['state_gb_1x1']:.3f}); round seconds "
            f"{[round(v, 2) for v in rec[cell]['seconds']]} (1x1 "
            f"{w['s']:.2f}; gloo stages the model group's collectives "
            f"through host memory); peak per rank "
            f"{[round(v, 2) for v in rec[cell]['peak_gb']]} GB (1x1 "
            f"{rec[cell]['peak_gb_1x1']:.2f})")
    if bad:
        fail("phase 22c: " + "; ".join(bad))
    return rec


def analysis_phase(torch, base, gemma_peak):
    """Phase 22a and 22c (22b runs on phase 4's trainer); returns their
    record."""
    return {"22a": dryrun_phase(torch, base, gemma_peak),
            "22c": tree_mesh_phase(torch, base)}


def analysis_phases(torch) -> int:
    """``--analysis``: build the kernels, run phase 4's main path (one
    round, profiled, with 22b's report on its trainer) and phase 22, and
    print the record as one JSON line."""
    from repro_torch import kernels
    from repro_torch.fed.api import FedSpec
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(kernels.kernel_sources())
    t0 = time.time()
    main_prof, report = {}, {}
    _, _, peak = train_phase(
        torch, "phase 4 main path (one round, with 22b)",
        FedSpec(**MAIN_SPEC), 1,
        expected_counts(1, round_uplink=1, round_downlink=1,
                        fedplt_update=N_EPOCHS),
        profile=True, profile_out=main_prof,
        after=lambda tr, st, cfg: round_report(torch, tr, st, cfg, report,
                                               main_prof))
    rec = dict(analysis_phase(torch, MAIN_SPEC, peak), **{"22b": report})
    log(json.dumps({"analysis": rec, "seconds": round(time.time() - t0, 1),
                    "card": smi}, default=str))
    return 0


# ---------------------------------------------------------------------------
# Phase 23: the examples as torch twins; gemma3-12b and the grouped MoE route
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "private_training", "compressed_training",
            "async_training", "train_lm_federated", "serve_lm",
            "continuous_batching")
LM_ROUNDS = 20                      # 23b in the whole script (300: --examples)
# gemma3-12b (hf:google/gemma-3-12b-pt: d 3840, 16 / 8 heads, head_dim 256,
# d_ff 15,360, vocab 262,144, window 1024) cut to 2 layers, both local: the
# tied embedding 1,006,632,960 + 2 x 224,140,800 + the final norm's 3,840;
# 18 leaves, bf16, packed
GEMMA3 = Cell("gemma3-12b", N_LAYERS, 1_454_918_400, 18, 1_454_918_400,
              N_LAYERS)
# 23c: gemma2-2b at phase 4's cut, recurrentgemma-2b at one pattern unit
BATCH_CELLS = ((GEMMA.arch, GEMMA.n_layers), (RGEMMA.arch, RGEMMA.n_layers))
BATCH_DTYPES = ("bfloat16", "float32")
# 23c's limit on a slot's logits against the request decoded alone, the
# largest difference over the largest |logit| of the request: about 4x and
# 30x the largest measured on the H100 (bf16 0.00752, float32 3.3e-7; a
# slot refilled without reset_slots is off by 0.21 at its first step;
# PERF.md §6)
BATCH_LIMIT = {"bfloat16": 3e-2, "float32": 1e-5}


def example(name: str):
    """The torch twin ``examples/<name>_torch.py`` as a module."""
    import importlib.util

    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(*a):
    pass


def _launched(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def dense_twins(torch):
    """Phase 23a: the four dense twins at their own sizes on the card, each
    beside the same twin's run on the CPU in this process (the draws are
    made on a CPU generator, so both see the same ones).  Returns the
    record."""
    from repro_torch import kernels
    from repro_torch.core.metrics import hitting_round
    from repro_torch.core.problem import make_logreg_problem

    out = {}

    def timed(fn, dev):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(dev, log if dev == "cuda" else _quiet)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, kernels.launch_counts()

    # quickstart: N 100, n 5, q 250, 200 / 400 / 400 rounds; x* once
    qs = example("quickstart")
    problem = make_logreg_problem(n_agents=100, q=250, dim=5, seed=0,
                                  device="cpu")
    x_star = problem.to("cuda").solve()
    log("phase 23a quickstart_torch on the card:")
    (card, s_card, c_card), (cpu, s_cpu, _) = (
        timed(lambda d, lg: qs.run(problem, d, x_star=x_star.to(d), log=lg),
              dev) for dev in ("cuda", "cpu"))
    for k in ("hit", "hit_pp"):
        if card[k] != cpu[k] or card[k] is None:
            fail(f"phase 23a quickstart: {k} card {card[k]} / CPU {cpu[k]}")
    gap = abs(card["x_bar_err"] - cpu["x_bar_err"])
    if not (gap <= 1e-5 and card["x_bar_err"] < 1e-4):
        fail(f"phase 23a quickstart: ||x_bar - x*|| card "
             f"{card['x_bar_err']} / CPU {cpu['x_bar_err']}")
    log(f"phase 23a quickstart: hitting rounds {card['hit']} / "
        f"{card['hit_pp']} on the card and the CPU; ||x_bar - x*|| "
        f"{card['x_bar_err']:.3e} / {cpu['x_bar_err']:.3e}; {s_card:.2f} s "
        f"on the card, {s_cpu:.2f} s on the CPU; launches "
        f"{_launched(c_card)}")
    out["quickstart"] = dict(hit=card["hit"], hit_pp=card["hit_pp"],
                             x_bar_err=[card["x_bar_err"], cpu["x_bar_err"]],
                             seconds=[s_card, s_cpu],
                             launches=_launched(c_card))

    # private: 300 rounds of noisy GD with dp_init
    pv = example("private_training")
    log("phase 23a private_training_torch on the card:")
    (card, s_card, c_card), (cpu, s_cpu, _) = (
        timed(lambda d, lg: pv.run(problem, d, log=lg), dev)
        for dev in ("cuda", "cpu"))
    err = _state_err(torch, card["state"], cpu["state"])
    if not (err <= 1e-5 and card["tau"] == cpu["tau"]
            and card["report"].adp_eps == cpu["report"].adp_eps
            and math.isfinite(float(card["crit"][-1]))):
        fail(f"phase 23a private: states {err}, tau {card['tau']} / "
             f"{cpu['tau']}, eps {card['report'].adp_eps} / "
             f"{cpu['report'].adp_eps}")
    log(f"phase 23a private: card vs CPU states {err:.3g} (tolerance 1e-5), "
        f"tau and eps equal, criterion {card['crit'][-1]:.4e} / "
        f"{cpu['crit'][-1]:.4e}; {s_card:.2f} s on the card, {s_cpu:.2f} s "
        f"on the CPU; launches {_launched(c_card)}")
    out["private"] = dict(tau=card["tau"], adp_eps=card["report"].adp_eps,
                          crit=[float(card["crit"][-1]),
                                float(cpu["crit"][-1])],
                          state_err=err, seconds=[s_card, s_cpu],
                          launches=_launched(c_card))

    # compressed: n 20, 600 rounds, six rows; each row through
    # ``run_row`` on the card and the CPU, its tallies read between rows
    cp = example("compressed_training")
    problem20 = make_logreg_problem(n_agents=100, q=250, dim=20, seed=0,
                                    device="cpu")
    rows, s_card, s_cpu = {}, 0.0, 0.0
    for name, comp, _ in cp.ROWS:
        (card, secs, t), (cpu, secs_cpu, _) = (
            timed(lambda d, lg: cp.run_row(problem20, d, comp, cp.ROUNDS),
                  dev) for dev in ("cuda", "cpu"))
        s_card, s_cpu = s_card + secs, s_cpu + secs_cpu
        k_card, k_cpu = hitting_round(card), hitting_round(cpu)
        want = cp.ROUNDS if name == "adaptive/fused" else 0
        if t["rank_select"] != want:
            fail(f"phase 23a compressed {name}: rank_select "
                 f"{t['rank_select']}, want {want}")
        if k_card != k_cpu or k_card is None:
            fail(f"phase 23a compressed {name}: hitting round card "
                 f"{k_card} / CPU {k_cpu}")
        rows[name] = dict(rounds=k_card, final_crit=float(card[-1]),
                          launches=_launched(t))
    log(f"phase 23a compressed: hitting rounds "
        f"{ {k: v['rounds'] for k, v in rows.items()} } on the card and the "
        f"CPU; launches { {k: v['launches'] for k, v in rows.items()} }; "
        f"{s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU")
    out["compressed"] = dict(rows=rows, seconds=[s_card, s_cpu])

    # async: 40 rounds through the broker, replayed bit for bit
    asy = example("async_training")
    log("phase 23a async_training_torch on the card:")
    problem8 = make_logreg_problem(n_agents=asy.N_AGENTS, q=200, dim=5,
                                   seed=0, device="cpu")
    res, s_card, c_card = timed(lambda d, lg: asy.run(problem8, d, log=lg),
                                "cuda")
    if not res["bitwise"] or res["state"].x.device.type != "cuda":
        fail("phase 23a async: the replay is not bit for bit on the card")
    arrivals, _ = res["schedule"].effective_counts()
    log(f"phase 23a async: replay bit for bit on the card; arrivals "
        f"{[int(a) for a in arrivals]}; effective eps "
        f"{res['effective'].adp_eps:.3f}; {s_card:.2f} s; launches "
        f"{_launched(c_card)}")
    out["async"] = dict(arrivals=[int(a) for a in arrivals],
                        adp_eps=res["effective"].adp_eps, seconds=s_card,
                        launches=_launched(c_card))
    return out


def lm_twin(torch, rounds):
    """Phase 23b: ``train_lm_federated_torch`` at its own config (~100M,
    float32) for ``rounds`` rounds on the card: finite losses, the last
    below the first, flash fp32 launches agents x epochs x 8 layers a
    round; round ms and peak GB."""
    from repro_torch import kernels

    lm = example("train_lm_federated")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = lm.main(["--rounds", str(rounds), "--device", "cuda"], log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in res["history"]]
    cfg = lm.lm_config()
    want = rounds * 4 * 3 * cfg.n_layers
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"phase 23b: losses {losses}")
    if counts["flash_attention_fwd"] != want or \
            counts["flash_attention_bwd"] != want:
        fail(f"phase 23b: flash launches {_launched(counts)}, want {want}")
    ms = [h["ms"] for h in res["history"]]
    steady = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    log(f"phase 23b: {res['n_params']:,} parameters, {rounds} rounds, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; round {steady:.1f} ms "
        f"(median of rounds 2-{rounds}; the first {ms[0]:.1f}), peak "
        f"{peak / 1e9:.2f} GB; launches {_launched(counts)}; {secs:.1f} s")
    n_params = res["n_params"]
    del res
    torch.cuda.empty_cache()
    return dict(n_params=n_params, rounds=rounds, loss_first=losses[0], loss_last=losses[-1],
                round_ms_median=steady, round_ms=ms, peak_gb=peak / 1e9,
                launches=_launched(counts), seconds=secs)


def decode_alone(torch, model, params, prompt, gen_len, cache_len):
    """One request decoded alone as ``generate`` decodes it (its prompt
    through ``decode_step`` a token at a time, then greedy tokens),
    keeping every step's logits: ``(tokens, [(vocab,) rows])``."""
    cache = model.init_cache(1, cache_len, device="cuda")
    rows, toks = [], []
    with torch.no_grad():
        for t in prompt:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([t], dtype=torch.int32,
                                            device="cuda"))
            rows.append(logits[0])
        for _ in range(gen_len):
            toks.append(int(torch.argmax(rows[-1])))
            if len(toks) == gen_len:
                break
            logits, cache = model.decode_step(
                params, cache, torch.tensor([toks[-1]], dtype=torch.int32,
                                            device="cuda"))
            rows.append(logits[0])
    return toks, rows


def batching_phase(torch):
    """Phase 23c: ``serve_stream`` of ``continuous_batching_torch`` at
    published width (gemma2-2b cut to 2 layers, recurrentgemma-2b to one
    pattern unit; bf16 and float32), 4 slots, 12 requests of 3-12 prompt
    tokens, 10 generated: every slot's logits at every step against the
    request decoded alone, the largest difference over the largest |logit|
    of the request under :data:`BATCH_LIMIT`; tokens equal wherever the
    alone run's top-2 margin (over the same largest |logit|) exceeds the
    limit, compared up to a token that a smaller margin let flip; the
    alone tokens equal ``generate``'s.  Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cb = example("continuous_batching")
    out = {}
    for arch, n_layers in BATCH_CELLS:
        for dtype in BATCH_DTYPES:
            label = f"{arch} ({n_layers} layers, {dtype})"
            cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                      dtype=dtype)
            model = build_model(cfg)
            params = model.init(
                torch.Generator(device="cuda").manual_seed(1), "cuda")
            queue = cb.make_queue(cfg.vocab, 12, 12)
            cache_len = 12 + 10
            torch.cuda.synchronize()
            res = cb.serve_stream(model, params, queue, 4, 10, "cuda",
                                  cache_len=cache_len, record=True)
            worst, flips, compared = 0.0, 0, 0
            for rid, prompt in enumerate(queue):
                toks, rows = decode_alone(torch, model, params, prompt, 10,
                                          cache_len)
                gen_toks = generate(
                    model, params, torch.tensor([prompt], device="cuda"),
                    10, cache_len)[0].tolist()
                if gen_toks != toks:
                    fail(f"phase 23c {label}: request {rid} decoded alone "
                         f"{toks}, generate {gen_toks}")
                got = res["logits"][rid]
                if len(got) != len(rows):
                    fail(f"phase 23c {label}: request {rid} took "
                         f"{len(got)} steps, alone {len(rows)}")
                scale = max(float(r.float().abs().max()) for r in rows)
                lim = BATCH_LIMIT[dtype]
                for j, (g, a) in enumerate(zip(got, rows)):
                    err = float((g.float() - a.float()).abs().max()) / scale
                    worst = max(worst, err)
                    compared += 1
                    if err > lim:
                        fail(f"phase 23c {label}: request {rid} step {j}: "
                             f"logits differ by {err:.3g} of the largest "
                             f"|logit| (limit {lim})")
                    k = j - (len(prompt) - 1)      # generated token index
                    if k < 0:
                        continue
                    if res["done"][rid][k] != toks[k]:
                        top2 = torch.topk(a.float(), 2).values
                        margin = float(top2[0] - top2[1]) / scale
                        if margin > lim:
                            fail(f"phase 23c {label}: request {rid} token "
                                 f"{k}: {res['done'][rid][k]} in the slot, "
                                 f"{toks[k]} alone (top-2 margin {margin:.3g})")
                        flips += 1
                        break
            log(f"phase 23c {label}: {len(queue)} requests through 4 slots in "
                f"{res['steps']} steps vs {res['naive_steps']} sequential "
                f"(x{res['utilization']:.1f} utilization), "
                f"{res['tokens_per_s']:.1f} gen tok/s; {compared} slot-steps "
                f"against the requests alone: largest difference "
                f"{worst:.3g} of the largest |logit| (limit {BATCH_LIMIT[dtype]}), "
                f"{flips} near-tie token flips")
            out[label] = dict(steps=res["steps"],
                              naive_steps=res["naive_steps"],
                              utilization=res["utilization"],
                              tokens_per_s=res["tokens_per_s"],
                              max_rel_err=worst, flips=flips,
                              compared=compared)
            del model, params, res
            torch.cuda.empty_cache()
    return out


def packed_width_checks(torch, width, n_rows=FULL_N):
    """23d: the uplink, downlink and fedplt_update wrappers once each on
    card tensors of a trainer's packed shape ``(n_rows, width)`` bf16
    (past 2^32 elements at gemma3-12b's), against their plain versions
    computed slab by slab, at phase 2's tolerances; each must launch its
    kernel once.  Runs with no trainer alive: the downlink's three inputs
    and two outputs are 58 GB at gemma3-12b's width.  Returns
    ``{kernel: max abs err}``."""
    from repro_torch import kernels
    from repro_torch.core.prox import make_prox
    from repro_torch.kernels.fedplt_update import ops as update_ops
    from repro_torch.kernels.fedplt_update.ref import fedplt_update_ref
    from repro_torch.kernels.round_edge import ops as edge_ops
    from repro_torch.kernels.round_edge import ref as edge_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    prox, rho = make_prox("weight_decay", weight=0.01), 0.25

    def buf():
        b = torch.empty((n_rows, width), device=dev, dtype=torch.bfloat16)
        for row in b:
            row.normal_(generator=gen)
        return b

    def held(got, plain, ins, what):
        err = 0.0
        for c0 in range(0, width, SLAB):
            want = plain(*[a[..., c0:c0 + SLAB] for a in ins])
            for g, w in zip(got, want if isinstance(want, tuple)
                            else (want,)):
                err = max(err, compare(torch, g[..., c0:c0 + SLAB], w,
                                       f"phase 23d {what}"))
        return err

    kernels.reset_launch_counts()
    errs = {}
    z = buf()
    y, v = edge_ops.round_uplink(z, None, prox=prox, rho_eff=rho)
    errs["round_uplink"] = held(
        (y, v), lambda z_: edge_ref.round_uplink_ref(z_, None, prox, rho),
        (z,), "round_uplink")
    del z, y, v
    x, w, z = buf(), buf(), buf()
    u = torch.tensor([1.0, 0.0] + [1.0] * (n_rows - 2), device=dev)
    xo, zo = edge_ops.round_downlink(x, w, z, u, None, prox=prox,
                                     rho_eff=rho, damping=1.0)
    errs["round_downlink"] = held(
        (xo, zo), lambda x_, w_, z_: edge_ref.round_downlink_ref(
            x_, w_, z_, u, None, prox, rho, 1.0), (x, w, z),
        "round_downlink")
    if not (torch.equal(xo[1], x[1]) and torch.equal(zo[1], z[1])):
        fail("phase 23d round_downlink: the inactive agent's row changed")
    del x, w, z, xo, zo
    w, g, v = buf(), buf(), buf()
    out = update_ops.fedplt_update(w, g, v, None, gamma=0.05, inv_rho=1.0)
    errs["fedplt_update"] = held(
        (out,), lambda w_, g_, v_: fedplt_update_ref(
            w_, g_, v_, None, gamma=0.05, inv_rho=1.0), (w, g, v),
        "fedplt_update")
    del w, g, v, out
    torch.cuda.synchronize()
    counts = _launched(kernels.launch_counts())
    if counts != dict.fromkeys(errs, 1):
        fail(f"phase 23d packed-width checks: launches {counts}")
    torch.cuda.empty_cache()
    log(f"phase 23d: round_uplink, round_downlink and fedplt_update at the "
        f"packed shape ({n_rows}, {width:,}) bf16 ({n_rows * width:,} "
        f"elements) against their plain versions slab by slab: max abs err "
        f"{errs}")
    return errs


def gemma3_phase(torch, base, main_prof=None):
    """Phase 23d: gemma3-12b at published width cut to 2 layers (both
    local; window 1024 > seq 512, so the window does not bite: the global
    layer's head shape is held in 9a), phase 4's spec, 3 rounds: uplink 3,
    downlink 3, fedplt_update 6, flash 48 / 48; peak under 80 GB; two
    profiled rounds beside phase 4's; then the edge and update kernels at
    the packed shape against their plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.fed.api import FedSpec
    from repro_torch.models.transformer import build_stages

    cfg = dataclasses.replace(get_config(GEMMA3.arch),
                              n_layers=GEMMA3.n_layers)
    kinds = [k for s in build_stages(cfg) for _ in range(s.n_units)
             for k in s.unit]
    if kinds != ["local"] * GEMMA3.n_layers or not cfg.window > MAIN_SEQ:
        fail(f"phase 23d: layer kinds {kinds}, window {cfg.window}")
    prof, again = {}, {}

    def second_profile(trainer, state, cfg_):
        again.update(profile_round(
            torch, trainer, state,
            torch.Generator(device="cuda").manual_seed(2), cfg_,
            "phase 23d (again)", GEMMA3.seq_len))

    counts, hist, peak = train_phase(
        torch, "phase 23d gemma3-12b (2 local layers)", FedSpec(**base), 3,
        expected_counts(3, GEMMA3, round_uplink=3, round_downlink=3,
                        fedplt_update=6),
        profile=True, cell=GEMMA3, profile_out=prof, after=second_profile)
    if peak > 80e9:
        fail(f"phase 23d: peak device memory {peak / 1e9:.2f} GB")
    ms = [1e3 * h["dt"] for h in hist]

    def groups(p):
        return {k: round(v, 2) for k, v in p.get("groups_ms", {}).items()}

    def idle(p):
        return 100 * (p.get("idle_share") or 0)

    side = ""
    if main_prof:
        side = (f"; phase 4: {main_prof.get('wall_ms', 0):.1f} ms wall, idle "
                f"{idle(main_prof):.1f}%, groups {groups(main_prof)}")
    log(f"phase 23d: rounds {[round(v, 1) for v in ms]} ms, peak "
        f"{peak / 1e9:.2f} GB; profiled rounds {prof.get('wall_ms', 0):.1f} "
        f"/ {again.get('wall_ms', 0):.1f} ms wall, idle {idle(prof):.1f} / "
        f"{idle(again):.1f}%, events complete "
        f"{prof.get('events_complete')} / {again.get('events_complete')}, "
        f"groups {groups(prof)} / {groups(again)}{side}")
    errs = packed_width_checks(torch, GEMMA3.packed_width)
    return dict(counts=_launched(counts), peak_gb=peak / 1e9, round_ms=ms,
                losses=[h["loss"] for h in hist], profile=prof,
                profile_again=again, phase4_profile=main_prof,
                packed_width_err=errs)


def _dropped_by_route(torch, trainer, state, cfg, out):
    """Each MoE route's dropped contributions on one agent's batch through
    the consensus model (``dispatch_plan`` wrapped to count them)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import build_model

    params = trainer.consensus(state)
    batch = make_batch_for(cfg, InputShape("moe", MAIN_SEQ, 2, "train"),
                           torch.Generator(device="cuda").manual_seed(5),
                           device="cuda")
    plan_fn, seen = moe_lib.dispatch_plan, []

    def counting(experts, n_experts, cap):
        plan = plan_fn(experts, n_experts, cap)
        seen.append((int((~plan["kept"]).sum()), plan["kept"].numel(), cap))
        return plan

    moe_lib.dispatch_plan = counting
    try:
        for grouped in (False, True):
            seen.clear()
            model = build_model(dataclasses.replace(cfg, moe_grouped=grouped))
            with torch.no_grad():
                model.loss_fn(params, batch)
            if len(seen) != cfg.n_layers:
                fail(f"phase 23e: {len(seen)} dispatch plans seen in "
                     f"{cfg.n_layers} MoE layers (grouped={grouped})")
            out["grouped" if grouped else "flat"] = {
                "dropped": sum(s[0] for s in seen),
                "contributions": sum(s[1] for s in seen),
                "capacity": seen[0][2]}
    finally:
        moe_lib.dispatch_plan = plan_fn


def grouped_moe_phase(torch, base, flat=None):
    """Phase 23e: qwen2-moe-a2.7b at 18b's one-layer cut and spec with
    ``moe_grouped=True``, one round: a finite loss, flash 8 / 8,
    fedplt_update 26; each route's dropped contributions on one agent's
    batch; round ms and peak GB beside 18b's flat route (``flat``, its
    record, in the whole script)."""
    from repro_torch.fed.api import FedSpec

    drops = {}
    counts, hist, peak = train_phase(
        torch, "phase 23e qwen2-moe-a2.7b grouped route (1 layer, tree)",
        FedSpec(**dict(base, state_layout="tree")), 1,
        expected_counts(1, QWEN, fedplt_update=N_EPOCHS * QWEN.n_leaves),
        cell=QWEN, cfg_kw=dict(moe_grouped=True),
        after=lambda tr, st, cfg: _dropped_by_route(torch, tr, st, cfg,
                                                    drops))
    if peak > 80e9:
        fail(f"phase 23e: peak device memory {peak / 1e9:.2f} GB")
    side = ""
    if flat:
        side = (f"; 18b's flat route: rounds "
                f"{[round(v, 1) for v in flat['round_ms']]} ms, peak "
                f"{flat['peak_gb']:.2f} GB")
    log(f"phase 23e: round {1e3 * hist[0]['dt']:.1f} ms, loss "
        f"{hist[0]['loss']:.4f}, peak {peak / 1e9:.2f} GB; dropped "
        f"contributions on one agent's batch (2 x {MAIN_SEQ} tokens): "
        f"{drops}{side}")
    return dict(counts=_launched(counts), peak_gb=peak / 1e9,
                round_ms=1e3 * hist[0]["dt"], loss=hist[0]["loss"],
                dropped=drops)


def examples_phase(torch, base, lm_rounds=LM_ROUNDS, main_prof=None,
                   moe_flat=None):
    """Phase 23 (23a-23e); returns its record with each part's seconds."""
    rec, secs = {}, {}
    for part, fn in (("23a", lambda: dense_twins(torch)),
                     ("23b", lambda: lm_twin(torch, lm_rounds)),
                     ("23c", lambda: batching_phase(torch)),
                     ("23d", lambda: gemma3_phase(torch, base, main_prof)),
                     ("23e", lambda: grouped_moe_phase(torch, base,
                                                       moe_flat))):
        t0 = time.time()
        rec[part] = fn()
        secs[part] = round(time.time() - t0, 1)
    log(f"phase 23 seconds: {secs} ({sum(secs.values()):.1f} s)")
    rec["seconds"] = secs
    return rec


def examples_phases(torch) -> int:
    """``--examples``: build the kernels and run phase 23 alone (23b at the
    twin's default 300 rounds)."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    build.build_all(kernels.kernel_sources())
    rec = examples_phase(torch, MAIN_SPEC, lm_rounds=300)
    log(json.dumps({"examples": rec, "seconds": round(time.time() - t0, 1),
                    "card": smi}, default=str))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    if "--src" in args:
        src = args[args.index("--src") + 1]
        use_tree(src)
    if "--sort-aggregate-times" in args:
        return sort_aggregate_times(torch, src)
    if "--ssm-scan" in args:
        return ssm_scan_phases(torch)
    if "--ssm-times" in args:
        return ssm_times(torch, src)
    if "--ssm-rounds" in args:
        return ssm_rounds(torch, src)
    if "--train-serve" in args:
        return train_serve_phases(torch)
    if "--moe" in args:
        return moe_phases(torch)
    if "--encdec" in args:
        return encdec_phases(torch)
    if "--async" in args:
        return async_phases(torch)
    if "--groups" in args:
        return groups_phases(torch)
    if "--analysis" in args:
        return analysis_phases(torch)
    if "--examples" in args:
        return examples_phases(torch)
    from repro_torch import kernels
    from repro_torch.fed.api import CompressionSpec, FedSpec, PrivacySpec
    from repro_torch.kernels import build

    # seconds of each phase (the last line of every run reads them)
    phase_s, last = {}, [time.time()]

    def stamp(phase):
        now = time.time()
        phase_s[phase] = round(now - last[0], 1)
        last[0] = now

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}, capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bw = card_bandwidth(name)
    t0 = time.time()
    logs = build.build_all(kernels.kernel_sources())
    log(f"phase 1: kernels built in {time.time() - t0:.1f} s "
        f"({', '.join(str(build.library_path(s).name) for s in kernels.kernel_sources())})")
    for src, text in logs.items():
        if not any(k in str(src) for k in ("flash_attention", "lru_scan",
                                           "compress", "robust_agg")):
            continue
        for kname, regs, st, ld in build.ptxas_summary(text):
            log(f"phase 1 ptxas: {short_kernel_name(kname)}: {regs} "
                f"registers, spill stores {st} B, loads {ld} B")

    stamp(1)
    # phase 2: kernels against plain versions
    small_checks(torch)
    compress_small_checks(torch)
    recs = full_shape(torch, bw)
    recs.update(compress_full_shape(torch, bw))
    robust_small_checks(torch)
    recs.update(robust_full_shape(torch, bw))

    stamp(2)
    # phase 3: small-input agreement of the whole round
    small_input_parity(torch)

    stamp(3)
    # phase 4: the main path
    base = dict(MAIN_SPEC)
    main_prof, report = {}, {}
    main_counts, hist, main_peak = train_phase(
        torch, "phase 4 main path", FedSpec(**base), 3,
        expected_counts(3, round_uplink=3, round_downlink=3, fedplt_update=6),
        profile=True, profile_out=main_prof,
        after=lambda tr, st, cfg: round_report(torch, tr, st, cfg, report,
                                               main_prof))
    round_ms = [1e3 * h["dt"] for h in hist]
    main_run = (hist, main_peak, main_prof)      # 13c's full-logit gemma2

    stamp(4)
    # phase 5: the DP path
    train_phase(torch, "phase 5 DP path",
                FedSpec(**base, privacy=PrivacySpec(tau=0.01, clip=1.0)), 1,
                expected_counts(1, round_uplink=1, round_downlink=1,
                                fedplt_update=2))

    stamp(5)
    # phase 6: the compressed z-exchange on the main path
    comp_counts, comp_hist, comp_peak = train_phase(
        torch, "phase 6 compressed main path (topk 0.25)",
        FedSpec(**base, compression=CompressionSpec("topk", ratio=0.25)), 3,
        expected_counts(3, round_uplink=3, round_downlink=3, fedplt_update=6,
                        rank_select=3), profile=True)
    int8_counts, int8_hist, int8_peak = train_phase(
        torch, "phase 6 compressed (int8)",
        FedSpec(**base, compression=CompressionSpec("int8")), 1,
        expected_counts(1, round_uplink=1, round_downlink=1, fedplt_update=2,
                        int8_quantize=1), profile=True)
    _, ada_hist, ada_peak = train_phase(
        torch, "phase 6 compressed (adaptive_topk 0.25, energy 0.95)",
        FedSpec(**base, compression=CompressionSpec("adaptive_topk",
                                                    ratio=0.25)), 1,
        expected_counts(1, round_uplink=1, round_downlink=1, fedplt_update=2,
                        rank_select=1))

    stamp(6)
    # phase 7: the byzantine-robust, fault-screened round
    robust_counts, robust_variants = robust_phase(torch, base)

    stamp(7)
    # phase 8: agent-sharded rounds on a 1-rank NCCL mesh
    sharded_small_checks(torch)
    recs.update(sharded_full_shape(torch, bw))
    one_rank = sharded_reduced_parity(torch)
    mesh_counts, mesh_hist, mesh_peak = train_phase(
        torch, "phase 8c main path under a 1-rank NCCL mesh (mesh_shape 1x1)",
        FedSpec(**base, mesh_shape="1x1"), 3,
        expected_counts(3, round_uplink_partial=3,
                        round_downlink_presummed=3, fedplt_update=6),
        profile=True)
    mesh_ms = [1e3 * h["dt"] for h in mesh_hist]
    log(f"phase 8c: steady rounds {[round(v, 1) for v in mesh_ms[1:]]} ms "
        f"under the mesh, {[round(v, 1) for v in round_ms[1:]]} ms in phase "
        f"4; peak {mesh_peak / 1e9:.2f} GB; losses "
        f"{[round(h['loss'], 4) for h in mesh_hist]} (phase 4 "
        f"{[round(h['loss'], 4) for h in hist]})")
    y_diff = bf16_y_difference(torch, base)
    mesh_robust = sharded_robust_round(torch, base)
    two_ranks = two_ranks_over_gloo(torch, one_rank)

    stamp(8)
    # phase 9: flash attention, forward and backward
    flash_small_checks(torch)
    flash = flash_full_shape(torch, bw)
    for kname in ("flash_attention_fwd", "flash_attention_bwd"):
        recs[kname] = flash["global"][kname[-3:]]

    stamp(9)
    # phase 10: the SSM and RG-LRU kinds through the lru_scan kernels
    lru_small_checks(torch)
    recs.update(lru_full_shape(torch, bw))
    ssm_base = dict(base, state_layout="tree")
    ssm_parity = ssm_small_input_parity(torch, ssm_base)
    ssm = {"card_vs_cpu_max_abs_err": ssm_parity}
    for cell in (RGEMMA, MAMBA):
        label = f"phase 10d/{cell.arch} ({cell.n_layers} layers, tree layout)"
        counts, hist, peak = train_phase(
            torch, label, FedSpec(**ssm_base), 3,
            expected_counts(3, cell, fedplt_update=3 * N_EPOCHS * cell.n_leaves),
            profile=True, cell=cell)
        if peak > 80e9:
            fail(f"{label}: peak device memory {peak / 1e9:.2f} GB")
        ssm[cell.arch] = {"counts": counts, "peak_gb": peak / 1e9,
                          "round_ms": [1e3 * h["dt"] for h in hist],
                          "losses": [h["loss"] for h in hist]}
    lru_counts = ssm[MAMBA.arch]["counts"]

    stamp(10)
    # phase 11: segment_ranks, and the dense front end on the card
    segment_ranks_small_checks(torch)
    rank_counts, rank_recs = segment_ranks_full_shape(torch, bw)
    recs.update(rank_recs)
    dense = {"paper": dense_paper_runs(torch),
             "kernel_path": dense_kernel_path(torch),
             "private": private_pipeline(torch)}

    stamp(11)
    # phase 12: sort_aggregate above 128 agents; the model mesh axis
    recs.update(robust_tile_checks(torch, bw))
    model_mesh = model_mesh_phase(torch)

    stamp(12)
    # phase 13: the untied head, the chunked loss, phi4-mini at full width
    lm_head = {"13a": lm_head_parity(torch)}
    phi_prof = {}
    phi_counts, phi_hist, phi_peak = train_phase(
        torch, "phase 13b phi4-mini-3.8b (2 layers)", FedSpec(**base), 3,
        expected_counts(3, PHI4, round_uplink=3, round_downlink=3,
                        fedplt_update=6), profile=True, cell=PHI4,
        profile_out=phi_prof)
    lm_head["13b"] = {"counts": phi_counts, "peak_gb": phi_peak / 1e9,
                      "round_ms": [1e3 * h["dt"] for h in phi_hist],
                      "losses": [h["loss"] for h in phi_hist],
                      "profile": phi_prof}
    plain = {PHI4.arch: (phi_hist, phi_peak, phi_prof),
             GEMMA.arch: main_run}
    lm_head["13c"] = {
        cell.arch: chunked_variant(torch, FedSpec(**base), cell, chunk, n,
                                   tol, plain[cell.arch])
        for cell, chunk, n, tol in CHUNKED}

    stamp(13)
    # phase 14: the SSM block's fused output through the selective scan
    ssm_small_checks(torch)
    recs.update(ssm_full_shape(torch, bw))
    ssm_counts, ssm_fused = ssm_fused_phase(torch, ssm_base)

    stamp(14)
    # phase 15: standard training with AdamW at published width
    std_params, standard = standard_phase(torch)

    stamp(15)
    # phase 16: resumed rounds on the card, bit for bit (and under a mesh)
    resumed = resume_phase(torch)
    resumed["mesh"] = mesh_resume_phase(torch)

    stamp(16)
    # phase 17: the trained parameters checkpointed and served
    serving = serve_phase(torch, std_params)
    del std_params
    torch.cuda.empty_cache()

    stamp(17)
    # phase 18: the MoE FFN, trained and served at published width
    moe = moe_phase(torch, base)

    stamp(18)
    # phase 19: the encoder-decoder and the vision prefix
    encdec = encdec_phase(torch, base, bw)

    stamp(19)
    # phase 20: bounded-staleness async rounds and the host broker
    async_rec = async_phase(torch, base)

    stamp(20)
    # phase 21: heterogeneous agent groups
    groups_rec = groups_phase(torch, base, main_prof)

    stamp(21)
    # phase 22: the analysis tools (22b ran on phase 4's trainer)
    analysis = dict(analysis_phase(torch, base, main_peak), **{"22b": report})

    stamp(22)
    # phase 23: the examples' torch twins, gemma3-12b, the grouped MoE route
    examples_rec = examples_phase(torch, base, main_prof=main_prof,
                                  moe_flat=moe["18b"])

    stamp(23)
    log(f"phase seconds: {phase_s}; {sum(phase_s.values()):.1f} s in all")

    table = []
    meta = {
        "round_uplink": ("src/repro_torch/kernels/round_edge/csrc/round_edge.cu",
                         "src/repro/kernels/round_edge/kernel.py:229",
                         main_counts),
        "round_downlink": ("src/repro_torch/kernels/round_edge/csrc/round_edge.cu",
                           "src/repro/kernels/round_edge/kernel.py:278",
                           main_counts),
        "fedplt_update": ("src/repro_torch/kernels/fedplt_update/csrc/fedplt_update.cu",
                          "src/repro/kernels/fedplt_update/kernel.py:59",
                          main_counts),
        "rank_select": ("src/repro_torch/kernels/compress/csrc/compress.cu",
                        "src/repro/kernels/compress/kernel.py:374",
                        comp_counts),
        "int8_quantize": ("src/repro_torch/kernels/compress/csrc/compress.cu",
                          "src/repro/kernels/compress/kernel.py:374",
                          int8_counts),
        "segment_ranks": (
            "src/repro_torch/kernels/compress/csrc/segment_ranks.cu",
            "src/repro/kernels/compress/kernel.py:398", rank_counts),
        "sort_aggregate": ("src/repro_torch/kernels/robust_agg/csrc/robust_agg.cu",
                           "src/repro/kernels/robust_agg/kernel.py:175",
                           robust_counts),
        "round_uplink_partial": (
            "src/repro_torch/kernels/round_edge/csrc/round_edge.cu",
            "src/repro/kernels/round_edge/kernel.py:307", mesh_counts),
        "round_downlink_presummed": (
            "src/repro_torch/kernels/round_edge/csrc/round_edge.cu",
            "src/repro/kernels/round_edge/kernel.py:345", mesh_counts),
        # the backward has no TPU kernel: the reference differentiates its
        # attention by autodiff; both replace the Pallas forward's role
        "flash_attention_fwd": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:93", main_counts),
        "flash_attention_bwd": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:93", main_counts),
        # likewise the scan's backward: the reference differentiates its
        # scan by autodiff
        "lru_scan_fwd": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
                         "src/repro/kernels/lru_scan/kernel.py:52",
                         lru_counts),
        "lru_scan_bwd": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
                         "src/repro/kernels/lru_scan/kernel.py:52",
                         lru_counts),
        # no Pallas kernel: the reference's XLA stand-ins ssm_mix_seq and
        # ssm_mix_fused (and their autodiff)
        "ssm_scan_fwd": ("src/repro_torch/kernels/lru_scan/csrc/ssm_scan.cu",
                         "src/repro/models/ssm.py:96 (ssm_mix_seq; :123 "
                         "ssm_mix_fused), no Pallas kernel", ssm_counts),
        "ssm_scan_bwd": ("src/repro_torch/kernels/lru_scan/csrc/ssm_scan.cu",
                         "src/repro/models/ssm.py:96 (ssm_mix_seq; :123 "
                         "ssm_mix_fused), no Pallas kernel", ssm_counts),
    }
    for kname, (source, replaces, path_counts) in meta.items():
        r = recs[kname]
        table.append({"name": kname, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": path_counts[kname],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r.get("library_ms")})
    variants = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                      "max_abs_err", "network_bound_ms",
                                      "sort_yardstick_ms", "lanes",
                                      "device_ms") if f in v}
                for k, v in recs.items() if "[" in k}
    variants["round_uplink[lagged]"]["launches_compressed_path"] = \
        comp_counts["round_uplink"]
    variants["round_downlink[lagged]"]["launches_compressed_path"] = \
        comp_counts["round_downlink"]
    log(json.dumps({"variants": variants, "round_ms": round_ms,
                    "compressed_round_ms": {
                        "topk": [1e3 * h["dt"] for h in comp_hist],
                        "int8": [1e3 * h["dt"] for h in int8_hist],
                        "adaptive_topk": [1e3 * h["dt"] for h in ada_hist]},
                    "compressed_peak_gb": {"topk": comp_peak / 1e9,
                                           "int8": int8_peak / 1e9,
                                           "adaptive_topk": ada_peak / 1e9},
                    "robust": robust_variants,
                    "sort_aggregate_yardstick_torch_sort_ms":
                        recs["sort_aggregate"]["sort_yardstick_ms"],
                    "sharded": {"round_ms": mesh_ms,
                                "peak_gb": mesh_peak / 1e9,
                                "bf16_y": y_diff, "robust": mesh_robust,
                                "two_gloo_ranks": two_ranks},
                    "main_path_peak_gb": main_peak / 1e9,
                    "flash_attention_full_shape": flash,
                    "ssm_rglru": ssm,
                    "segment_ranks_full_shape": rank_recs["segment_ranks"],
                    "dense": dense, "model_mesh": model_mesh,
                    "lm_head": lm_head, "ssm_fused_output": ssm_fused,
                    "ssm_scan_full_shape": {
                        k: v for k, v in recs.items()
                        if k.startswith("ssm_scan")},
                    "standard": standard, "resume": resumed,
                    "serve": serving, "moe": moe, "encdec": encdec,
                    "async": async_rec, "groups": groups_rec,
                    "analysis": analysis, "examples": examples_rec,
                    "phase_seconds": phase_s},
                   default=str))
    log(json.dumps({"kernels": table}))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
