#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in
order (any failure raises and the script exits non-zero):

1. build every kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, started together) and print the card;
2. K1 (paged decode attention, one split-KV launch through the block
   table) against its plain version at the main path's shapes (pages
   of 16), and over pages of 8 and 32 and a lane of 1000 positions (so
   chunks straddle pages and the last chunk is short), float32 (TF32
   off, tol 1e-4) and bfloat16 (tol 2e-2): a dead lane gives exactly
   0, table slots past the length (page ids far outside the pools) are
   never read, a second call repeats the bits, and K1 equals K3 on the
   gathered pools bit for bit;
3. K2 (flash prefill) against its plain version at ``K2_CASES``: causal
   at Sq 64, 100, 512 and 1024, a sliding window, no mask, a window
   without causality, D 64, 96 (phi-3-vision's: causal at Sq 256, 100
   and 1000, windowed, B 2, unmasked Sq 200 against Sk 256, GQA group
   4) and 256, the float32 SMOKE serve's own shape (H 4, Hkv 2, D 32)
   at its prompt buckets 8 to 128, hymba-1.5b's (H 25 over Hkv 5, D
   64, window 1024, Sq 2048 and 512; SMOKE's window 32 at D 32),
   whisper-base's encoder (Sq = Sk = 1500, unmasked, D 64, H 8 over 8)
   and cross-attention (Sq 64 against Sk 1500, unmasked), and
   phi-3-vision-4.2b's prefill (causal Sq 1024, D 96, H 32); float32
   on the CUDA-core kernel
   (``flash_attention_cc``, tol 1e-4) and bfloat16 on the tensor-core
   kernel (``flash_attention_mma``, tol 2e-2) at D 64, 96 and 128 (D
   96's bf16 cases also within ``k2_scaled_check``'s bound and scale),
   on the CUDA-core one at D 32 and 256, each call's launch counters
   naming the kernel its dtype and D select;
4. K3 (length-aware dense decode) and K6a (masked dense decode), one
   split-KV launch each, against their plain version at the fixed-lane
   path's shapes (S = 1024) and at S = 1000, and at whisper-base's
   cross-attention (4 lanes, H 8 over 8, D 64, every lane at S = 1500),
   same tolerances; a dead lane gives exactly 0, K3 equals K6a, and a
   second call of each gives the same bits;
5. K5 (length-aware int8 dense decode), K6b (masked int8 dense decode)
   and K4 (paged int8 decode) against their plain versions at the same
   shapes, q in float32 and bfloat16, at the model's ``qblock=1``
   (per-token scales) and the reference kernels' own (32 dense, 16
   paged; K4 also over pages of 8 at qblock 1 and of 32 at qblock 16);
   a dead lane gives exactly 0, K5 equals K6b and repeats its bits, K4
   repeats its bits and equals K5 on the gathered pools at the same
   qblock, and at ``qblock=1`` each agrees with the reference model's
   route (dequantize to float32, then K3 or K1); then K3, K1, K5 and K4
   at hymba-1.5b's decode shapes (GQA group 5, D 64, a ring of 1024
   slots, four lanes at lengths 96, 1000, 1024 and 1500, so two rings
   have wrapped, paged through a shuffled table), each against its
   plain version, K1 giving K3's bits on the gathered rings and K4
   K5's;
6. end to end at SMOKE width in float32: the same requests through
   ``ServeEngine()`` (fixed-lane) and ``ServeEngine(paged=True)``,
   greedy and at temperature 0.8, on the CPU (plain versions) and on
   the card (kernels): CPU and card streams, and fixed-lane and paged
   streams on the card, must be identical; once with the cache in the
   compute dtype and once with ``kv_quant="int8"``; the card's float32
   prefill must run K2's CUDA-core kernel.  On the card every decode
   dispatch after the first of its size is a CUDA graph replay (one
   graph per ``n_steps``): each serve must count replays ==
   ``decode_dispatches - decode_compiles`` > 0 -- and each prefill
   after the first of its bucket replays that bucket's graph (prefill
   replays == prefills - ``prefill_compiles`` > 0, ``prefill_compiles``
   the prefill graphs captured; every later serve that gates its
   decode replays gates these too) -- and once in each serve,
   after the ``dispatch_n`` graph is captured and with lanes live, one
   replayed dispatch is held bit for bit against the eager
   ``model.decode_n_steps`` on the same saved state (tokens, valid
   flags, budgets, lengths, next tokens, token indices and every cache
   tensor, i.e. the KV rows or ssm state written), and both are timed
   (host clock, synced; the check's own launches and replays are taken
   back out of the serve's counts);
7. end to end at full width, paged: qwen2.5-1.5b in bfloat16 with
   seeded random weights, 16 requests through ``ServeEngine(paged=
   True)``; every request must finish its budget, K2's tensor-core
   kernel must have launched and K1 28 times per decode step (counted
   through the graphs' replay accounting); the replay gate and check
   of phase 6, with each graph's capture seconds, the graph pool's
   size, and decode ms per dispatch eager and replayed;
8. end to end at full width, fixed-lane (the engine's default): the
   same 16 requests through ``ServeEngine()``; every request must
   finish, K2's tensor-core kernel and K3 must have launched, K3 28
   times per decode step; then a short run at temperature 0.8 whose
   tokens must all finish inside the vocabulary;
9. end to end at full width with ``kv_quant="int8"``: the same 16
   requests fixed-lane and paged; every request must finish, K5 (resp.
   K4) must launch 28 times per decode step and the fp decode kernels
   not at all;
10. timings at the main-path shapes, as device time per call (CUDA
   events around 20 calls queued behind a busy-wait, so the host's
   launch cost stays out): each kernel, its plain version and
   ``F.scaled_dot_product_attention`` where one call computes the same
   function, beside the card's bound; K2 in bf16 at Sq 512 and 1024 and
   in float32 at Sq 512, and in bf16 at D 96 (the tensor-core kernel);
   for K1 also its pages gathered and then SDPA
   (no single call reads a block table); for the int8 kernels also the
   reference model's route (dequantize to float32, then K3 or K1);
11. the paper's compute path, checked: K8 (mixbench) in float32 and
   bfloat16, both arms, at 1, 16 and 128 steps, in one grid-stride
   pass and in several, aligned and not (f32 mul_add and bf16
   bitwise, f32 fma within 1e-6); K9 (fma_matmul) both variants in
   float32 and bfloat16 at (128, 1024, 512), the qwen2.5-1.5b MLP
   shapes (128, 1536, 8960) and (128, 8960, 1536), one decode row
   (1, 1536, 8960) and a ragged shape (100, 1000, 520) against one f32
   matmul (K9_TOL), every call run twice and required to repeat bit
   for bit, the launch counters showing each arm's weight stream
   there and its staged kernel (WMMA, or FMUL/FADD on 64 x 64 tiles)
   at (128, 1536, 130), whose rows are not whole 16-byte chunks; K7
   (qmatmul: dequant_dot on the bf16 tensor cores, dot_i8 on the int8
   ones) on those weights quantized on the card in all four formats
   and on a (512, 100) weight (rows that are not whole 16-byte chunks:
   the _plain kernels), dequant_dot and q8_0 dot_i8 at M 1, 8, 24, 128
   and 256 with float32 and bfloat16 activations, within 1e-5, every
   call run twice and required to repeat bit for bit, the launch
   counters naming the variant;
12. the instructions (``cuobjdump -sass``): no FFMA/HFMA2/HMMA in any
   mul_add kernel of K8 and K9 (K9's stream and staged kernels) and
   FMUL and FADD present, none in the split-K reduce either (adds
   alone), FFMA/HFMA2 in K8's fma kernels, HMMA in K9's mxu kernels --
   the paper's ``-fmad=false``; HMMA in K2's bf16 kernels and in K10's
   four kernels, and no HMMA or HGMMA in K2's CUDA-core kernels and
   the dense and paged decode kernels; HMMA in every K7 dequant_dot
   kernel, IMMA and no IDP.4A in every dot_i8 kernel;
13. the compute path through its entry points, launch counts zeroed
   before and read after: the K8 intensity sweep (2^26 float32
   elements, 1 to 1024 steps, both arms: GFLOP/s and GB/s per point,
   the fused/unfused peak ratio and the stream rate; its output at 1,
   64 and 1024 steps held to the plain version as in 11), ``matmul(x, w,
   policy=PathPolicy(p))`` for the four profiles (each must launch the
   variant the reference's policy picks) and ``qmatmul(x, qt,
   profile=CMP_170HX)`` for the four formats (dot_i8 for q8_0,
   dequant_dot otherwise);
14. timings of K8, K9 and K7 at full width beside their bounds, plain
   versions and ``torch.matmul`` (K9) or the dequantize-then-matmul
   route (K7); K9's and K7's as device time per call (launches queued
   behind a busy-wait): each K9 arm at both MLP shapes in float32 and
   bfloat16 (mxu beside TF32 or bf16 ``torch.matmul``, mul_add beside
   one f32 ``torch.matmul`` with TF32 off) with its TB/s, TFLOP/s and
   share of the bound, and each arm's staged kernel at (128, 1536,
   8958); K7's dequant_dot q4_k and dot_i8 q8_0 at both MLP shapes, M
   128 and 8, float32 and bfloat16 x (``by_shape``), and dequant_dot in
   every format at float32 (128, 1536, 8960);
15. K10 (the SSD chunk scan: C.B^T once per chunk, then the per-head
   products on the tensor cores) against its plain version at
   mamba2-780m's widths (H 48, P 64, N 128, chunk 256): S 64, 256, 1024
   and 2048, B 1 and 2, x/b/c in float32 and bfloat16, A over the
   model's range and from ``-exp(0.3 randn)``; at every serve bucket
   (one chunk of Q 8 to 256), at SMOKE's widths (H 8, P 32, N 16,
   chunk 32), at odd widths (H 3, P 30, N 20) with chunk 50, at the
   longest chunk (1024), and at hymba-1.5b's widths (H 50, P 64, N 16:
   a quarter of the kernel's state tile) at S 256, 1024 and 2048;
   relative max error <= K10_TOL on all three
   outputs; the full SSD on K10 against ``ssd_chunked`` at S 2048;
16. end to end at SMOKE width in float32, mamba2: CPU and card streams
   identical, fixed-lane and paged, greedy and at temperature 0.8, with
   lanes reused; K10 launched on every layer of every card prefill;
   the replay gate and check of phase 6, and every prompt token but
   the engine's first streamed by a replay of the captured batch-1
   decode step;
17. end to end at full width, mamba2-780m in bfloat16 with seeded
   random weights: 3 requests fixed-lane and 2 of them paged, each
   serve then a fourth in an earlier prompt's bucket (a prefill graph
   replays), K10
   launched 48 times per prompt; the prefill's logits at the last
   prompt position (K10's path) beside the streamed ones (the recurrent
   path); the graph gates and check of phase 16, and 64 prompt tokens
   streamed into a free lane by replays and eagerly (``decode_step`` on
   a fresh batch-1 state), logits and state bitwise equal, ms per
   token of each.  The serve discards the prefill's logits for the streamed
   ones, as the reference does, so these K10 launches (the kernels
   line's ``launches``) are counted but their output is only printed,
   not gated;
18. ``build_model(cfg).forward`` at full width: bfloat16 at S 2048 (48
   K10 launches, finite logits; timed on the host clock, and the
   device's busy time by kernel from ``torch.profiler``, K10's share
   apart), and in float32 every position of a
   512-token prompt against the logits of streaming it through
   ``lm_decode_step`` (which never runs K10), max |diff| <= SSM_FWD_TOL:
   these 48 launches (``launches_forward_checked``) are the ones whose
   output is checked; then K10's timing row beside its bound, as
   device time per call (launches queued behind a busy-wait);
19. end to end at SMOKE width in float32, hymba (the hybrid family:
   attention with a window of 32 beside Mamba-2 heads in every block),
   with the KV in float32 and in int8: the checks of phase 6 (CPU and
   card streams identical, fixed-lane and paged, greedy and at t=0.8,
   prompts that wrap the window), the prompt-stream gate of phase 16,
   K2's CUDA-core kernel and K10 on every layer of every card prefill,
   K3 and K1 (K5 and K4 in int8) in the decode;
20. end to end at full width, hymba-1.5b in bfloat16 with seeded random
   weights: prompts of 96, 700, 1000 and 1100 tokens (one wraps the
   window of 1024, one decode crosses it), 64 new tokens, 4 lanes,
   ``max_len`` 2048, fixed-lane and paged (pages of 16); K2's
   tensor-core kernel and K10 launched 32 times a prompt, K3 (resp. K1)
   32 times a decode step beside 32 times a streamed prompt token
   (replay accounting); the graph gates and checks of phase 17, the
   stream check holding the K/V the stream wrote too; tok/s, decode
   and stream ms eager and replayed, prefill ms per bucket, capture s;
21. timings at hymba-1.5b's shapes, as in phase 10: K2 bf16 at Sq 2048
   and 1024 with the window (beside SDPA with the window as a mask),
   K3, K1, K5 and K4 at the wrapped ring, K10 at N 16;
22. (between phases 9 and 10, while qwen2.5-1.5b's weights are loaded)
   prefix sharing: at SMOKE width in float32, KV in float32 and in int8,
   greedy and at t=0.8, the sharing engine on the CPU and on the card
   and the unshared engine on the card give identical streams (a
   partial page copied on write among them), the sharing stats equal
   CPU vs card; at full width (paged, 256 pages of 16, 8 lanes) 16
   requests opening with one 520-token head (32 full pages and 8
   tokens) and a tail of their own (16-80 tokens), and one repeating
   the first prompt that ends mid-page with 5 more tokens, 64 new
   tokens: served twice with sharing (identical streams, every stat
   equal to what the port's rules give for these prompts on a one-layer
   CPU mirror of the same geometry and vocabulary), and once without
   (a higher page high-water mark; the share of equal streams printed,
   not gated in bf16); K1 28 times a decode step plus 28 a streamed
   tail token, every tail token but the first a replay of the batch-1
   step; tail ms per token;
23. (there too) evict/restore at full width, paged, KV in bf16 and int8:
   after the second dispatch two live lanes are evicted, one restored
   into the same engine and one into a fresh one with the same
   ``n_lanes``, seed and temperature; every stream equals the
   uninterrupted serve's bit for bit; evict and restore ms;
24. the rest of the dense family at SMOKE width in float32: olmo (MHA,
   non-parametric LN), KV in float32 and int8, through the checks of
   phase 6 (K2's CUDA-core kernel, K3/K1, K5/K4 in int8);
25. K2, K3, K1, K5 and K4 at olmo-1b's, mistral-nemo-12b's,
   qwen2.5-32b's, moonshot-v1-16b-a3b's and phi-3-vision-4.2b's shapes
   (D 128, GQA group 1, 4 and 5; D 96 for phi-3-vision, whose bf16 K2
   is the tensor-core kernel too; the serves' lanes) against their plain
   versions, K1 == K3 and K4 == K5 bitwise;
26. full width in bf16 with seeded random weights, each loaded after
   every earlier model is dropped and the cache emptied: olmo-1b (16
   requests, 8 lanes) and mistral-nemo-12b (8 requests, 8 lanes;
   ``head_dim`` 128 against d_model / n_heads = 160) on both layouts,
   qwen2.5-32b (~65.5 GB; 4 requests, 32 new tokens, 4 lanes) paged;
   then the moe family's moonshot-v1-16b-a3b (~57.8 GB: 64 experts
   top-6 routed by the sort-based capacity dispatch inside the captured
   decode step, every expert read each step; 8 requests, 32 new
   tokens, 8 lanes) paged, and the vlm family's
   phi-3-vision-4.2b (8 requests, 8 lanes; K2's tensor-core kernel at
   D 96) on both layouts, with ``Model.forward`` at S 1024 over a
   256-token ``vision_embeds`` prefix from the seed (finite logits, 32
   K2 launches); prompts 64-700, max_len 1024, pages of 16; K2 once a
   layer a prompt and K3/K1 a decode step, the replay gates and check,
   tok/s, prefill ms per bucket, decode ms per dispatch, the phase's
   peak device memory;
27. timings at those five configs' shapes, as in phase 21;
28. (after phase 23, with qwen2.5-1.5b's weights loaded) observability
   at SMOKE width in float32, paged (pages of 8, a pool that blocks an
   admission): the full stack (tracer, registry, flight recorder, a
   lenient SLO controller over a degradation ladder, the page
   sanitizer) on the CPU port and on the card, and the card's engine
   with everything off: streams identical across the three; the spans
   and instants (kind, name, track, args; times left out), the 23
   ``STATS_SCHEMA`` counters and the sanitizer's page-op log equal CPU
   vs card; the ladder at level 0; replays == dispatches - compiles >
   0, the same on and off; every request's timeline complete;
29. the same on the fixed-lane engine with the tracer and registry
   (the sanitizer is paged only);
30. full width, qwen2.5-1.5b bf16 paged, phase 7's traffic, served off,
   on, on, off (the full stack of phase 28): streams bitwise equal,
   decode_compiles and replays equal, every timeline complete with a
   TTFT and a TPOT series, one ``decode.dispatch`` span (and histogram
   sample) per dispatch, the pool's gauges at 0 in use with allocs ==
   frees, the sanitizer clean, the flight ring holding dispatch
   records; wall, tok/s and the on/off ratio printed, not gated;
31. the ladder at full width: phase 30's traffic with ``priority = i %
   2`` on 160 pages under ``DegradationLadder(page_pressure=0.75,
   trip_after=1, cooldown=4)``: it reaches ``evict`` and sheds lanes,
   restores == preemptions == degrade_sheds, every budget finishes and
   every stream equals an engine's without a ladder (same ``n_lanes``,
   ``n_pages`` and seed) bit for bit; decode_compiles equals the
   number of distinct dispatch sizes (one graph each); transitions,
   sizes and both walls printed;
32. (there too) quantized weights at SMOKE width in float32:
   ``quantize_params`` on the card gives the CPU port's stats and
   planes bit for bit in q8_0, q6_k, q4_k and q2_k (one leaf,
   ``embed.tok``: the reference's rule on its stacked tree), the
   dequantized tensors bitwise too; greedy streams over the dequantized
   q8_0 and q4_k weights equal CPU vs card, fixed-lane and paged; the
   README's canonical launch (``--smoke --quant q8_0 --paged
   --page-size 16 --prefix-sharing``) exits 0 on the card;
33. full width, qwen2.5-1.5b bf16, phase 7's traffic paged (256 pages,
   8 lanes), served over the dense weights and over the dequantized
   q8_0 and q4_k weights: one leaf quantized, ``embed.tok`` (152064 x
   1536), its planes quantized on the card bitwise those quantized on
   the CPU; K1 28 times a decode step, the replay gates of phase 7;
   tok/s of each serve;
34. multi-model serving at full width: qwen2.5-1.5b and olmo-1b in
   bf16 (host master copies in one ``ModelPool``), an alternating trace
   of 6 requests through ``MultiModelServeEngine`` (pages of 16, 8
   lanes, ``max_len`` 1024) at 6.0e9 B (both resident) and 4.0e9 B (one
   at a time, LRU swaps and reloads): every stream bitwise equal to its
   model's single-engine serve, every pool checked and empty, each
   unload returning at least 90% of the model's weight bytes of device
   memory; weight and page bytes, swaps, the modelled swap seconds over
   the CMP 170HX's host link and the measured host-to-device seconds
   of each load printed;
35. the execution replay: at SMOKE width ``run_trace_on_engine`` (dense
   and paged), ``run_trace_with_faults`` and
   ``run_multimodel_trace_on_engine`` give the CPU port's results on
   the card; at full width (qwen2.5-1.5b paged, a Poisson trace of 19
   requests) ``validate_recovery_exactness`` and
   ``validate_preemption_exactness`` hold, the crashed node's flight
   dump exists, and ``calibrate_replay`` of the replay against
   ``predict_replay`` passes its gate;
36. (after phase 27) the moe and vlm families at SMOKE width in
   float32: moonshot (experts and a shared expert), arctic (experts
   beside a dense FFN) and phi-3-vision (the text decoder) through the
   checks of phase 6, K2's CUDA-core kernel, K3 and K1;
37. ``quantize_params`` of SMOKE moonshot in q8_0 on the card: the
   reference's leaf rule on the moe tree (``embed.tok`` and
   ``embed.head``; the 4-D expert stacks and 3-D routers stay dense),
   planes and stats bitwise the CPU port's, streams over the
   dequantized weights CPU vs card; the launcher's ``--arch
   moonshot-v1-16b-a3b --smoke --quant q8_0`` exits 0;
38. whisper-base at SMOKE width in float32: ``encode`` and 16 tokens
   through ``decode_n_steps``, greedy and t=0.8, equal CPU vs card;
39. whisper-base at full width in bf16: ``encode`` of (4, 1500, 512)
   frames (K2 unmasked at Sq = Sk = 1500), 64 greedy tokens a lane
   through ``decode_n_steps`` (K3 over the self-attention ring and the
   cross K/V), and the reference's check of each decode step against
   ``decode_forward`` at the same position (log-probabilities; float32
   weights within 1e-4, bf16 within ``WHISPER_LOGPROB_TOL_BF16``);
40. timings at whisper-base's shapes: K2 at the encoder's and the
   cross-attention's, K3 over the cross K/V, as in phase 21;
41. K2 under autograd (``FlashAttentionFn``): its forward is K2's launch
   (the counters name the arm) and its dq, dk and dv agree with
   autograd through the plain version on the card, bf16 at D 64, 96
   and 128 on the tensor-core kernel and float32 at D 32 on the
   CUDA-core one, causal at S 256 and 1000, a window, GQA groups of 4
   and 6, whisper-base's unmasked encoder (1500 x 1500) and
   cross-attention (Sq 256 against Sk 1500) and hymba-1.5b's window of
   1024 at S 2048 (K2's tolerances, 2e-2 and 1e-4, over max(1,
   max|grad|)); at each case a control whose backward zeroes dq and dk
   fails the gate; forward plus backward at qwen2.5-1.5b's training
   shape timed beside the plain version's autograd and SDPA's;
42. training at SMOKE width in float32 (qwen2.5-1.5b): ``make_train_step``
   on the CPU and on the card from one state, 3 steps, remat off and on,
   microbatches 1 and 2: losses and first-step gradient leaves within
   1e-5 relative, the parameters' change per leaf within 1e-2; K2's
   CUDA-core kernel once a layer a microbatch (twice with remat);
43. training at full width: qwen2.5-1.5b in bf16 from seed 0 with the
   launcher's defaults (batch 8, seq 256, remat, warmup 20 over 30
   steps): every first-step gradient leaf with K2 within 5e-2 of the
   same step with the plain attention under autograd (the zeroed
   control beyond it), 30 steps with a checkpoint at 15 and a restart
   from it to 30 (the restarted losses equal the uninterrupted ones),
   losses finite and falling, K2's tensor-core kernel 56 launches a
   step; the median step, tokens/s, the optimizer's and K2's backward
   ms a step and peak memory, beside the card's name and power limit;
44. K10 under autograd (``SSDChunkFn``): its forward is one K10 launch
   within ``K10_TOL`` of the plain version, and its five gradients (every
   output's cotangent live) agree with autograd through the plain
   version on the card within 1e-5 (L2, relative) at mamba2-780m's and
   hymba-1.5b's training shapes (bf16) and SMOKE's (float32), and the
   full SSD's at S 1000 padded to the chunk; at each case a control
   whose backward zeroes dx fails the gate; the backward and forward
   plus backward timed at mamba2-780m's shape;
45. phase 42 for moonshot, arctic, mamba2, hymba and whisper-base at
   SMOKE width (whisper with seeded frames): the same gates, K2's
   CUDA-core kernel and K10's float32 arm launched exactly once a layer
   a microbatch (twice with remat), a control with K10's gradients
   zeroed at mamba2;
46. training at full width: mamba2-780m, hymba-1.5b, whisper-base
   (frames (8, 1500, 512)) and moonshot-v1-16b-a3b at its published
   widths cut to 2 layers, bf16 from seed 0, batch 8, seq 256, remat:
   every first-step gradient leaf with the kernels within 5e-2 of the
   plain versions under autograd (a control beyond it), 8 steps with
   finite, falling losses, exact K2 and K10 launches a step, a restart
   of mamba2-780m from a step-4 checkpoint equal to the uninterrupted
   losses, moonshot's first-step gradients bitwise twice; the median
   step, tokens/s, the optimizer's ms and peak memory;
47. the fleet simulator: the mixed plan (2 a100-40g, 8
   cmp-170hx-nofma) under a seeded bursty trace, run twice with equal
   ``metrics()`` (TTFT/TPOT p99, goodput, $/Mtok printed); then the
   token accounting at full width: a seeded Poisson trace of 16
   requests (prompts 64-512, generations 16-128) through a prefill and
   an 8-lane decode board, replayed on the card (qwen2.5-1.5b bf16,
   seed 0, fixed-lane, 8 lanes, ``max_len`` 1024): the simulator's
   prompt and generated tokens equal the engine's, K2 launches = 16 x
   28, K3 launches = the engine's decode steps x 28, a control with one
   record's ``gen_len`` off by one mismatches; the replay's tokens/s;
48. the dry run over every cell of ``all_cells()`` (32) on the meta
   device in parallel processes: no cell fails, ``model_flops`` is
   ``_model_flops``, and the counted FLOPs equal ``derived_flops``
   exactly (one line a cell, the ratio to ``model_flops`` printed);
49. the dry run against the card: qwen2.5-1.5b train (batch 8, seq 256,
   remat, f32 moments), qwen2.5-1.5b decode (8 lanes, a 1024-deep
   cache) and mamba2-780m train (batch 8, seq 256), one step each from
   ``reset_peak_memory_stats``: the meta pass's peak within
   ``DRYRUN_MEM_TOL`` of ``max_memory_allocated`` above what was there
   before, a control without the optimizer moments outside it, the
   counted FLOPs over the measured step as TFLOP/s; the launcher's
   ``--mesh 1,1`` trains 2 SMOKE steps on the card and ``--mesh 2,1``
   is refused with its device count;
50. the prefill graphs at full width: qwen2.5-1.5b bf16 (8 lanes,
   ``max_len`` 1024, both layouts) at buckets 64 to 1024, then one
   bucket of 1024 for hymba-1.5b (K2 windowed and K10), mamba2-780m
   (K10; logits alone, the serve discards them) and phi-3-vision-4.2b
   (K2 at D 96): each bucket's graph captured through the engine's own
   call, then two other prompts of it replayed, each equal bit for bit
   to the eager ``model.prefill`` on the same buffers (logits, K and
   V), their logits different, a replay's launches equal to the eager
   call's; 5 replays and 5 eager calls timed (host clock, synced), the
   capture's seconds and the graph pool's bytes;
51. the mesh: two rank processes (this script with ``--mesh-rank``)
   share the card over gloo on mesh (data 1, model 2) with qwen2.5-1.5b
   at full width in bf16: the unsharded first step on each rank and
   three steps on rank 0, then the same sharded (the first loss and the
   three within 1e-2 relative, every gradient leaf within phase 43's
   gate, the losses falling), and four sharded decode steps on a dense
   cache in float32 (logits within 1e-2 of the unsharded step's) and
   bf16 (its distance from the float32 logits within twice the
   unsharded bf16 step's);
   K2 and K3 launches counted from zero on each rank, all at the local
   heads (6 / 1), K2 and K3 checked and timed at those shapes; each
   rank's peak memory and synced step times.

The last two lines are the ``{"kernels": [...]}`` summary and the
``{"ok": true, ...}`` verdict.  Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are not beside it.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 5, iters: int = 30) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, warmup: int = 5, reps: int = 10, calls: int = 50) -> float:
    """Host time to issue one ``fn``: median over ``reps`` of the wall
    time of ``calls`` calls issued back to back from an idle card, not
    waiting for it, over ``calls``.  A host-bound serve pays this for
    every launch, whatever the device time."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_ms_queued(fn, warmup: int = 5, reps: int = 30,
                   launches: int = 20) -> float:
    """Device time of one ``fn``: median over ``reps`` of CUDA events
    around ``launches`` calls queued behind a busy-wait kernel, over
    ``launches``.  The wait lets the host enqueue every call before the
    first one starts, so the host's launch cost (which exceeds a short
    kernel's time) stays out of the reading."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)          # ~2 ms at 1.98 GHz
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# ----------------------------------------------------------------------
# the decode dispatch's CUDA graphs
# ----------------------------------------------------------------------

def _dispatch_state(eng):
    """Clones of every tensor a decode dispatch reads or writes."""
    out = {f"cache.{k}": t.clone() for k, t in eng.cache.items()}
    for name in ("_next_token", "_remaining", "_tok_idx"):
        out[name] = getattr(eng, name).clone()
    return out


def _restore_dispatch_state(eng, state):
    for key, t in state.items():
        dst = (eng.cache[key[len("cache."):]] if key.startswith("cache.")
               else getattr(eng, key))
        dst.copy_(t)


def check_replay(eng, tag, reps: int = 3):
    """One replayed dispatch of ``eng.dispatch_n`` steps against the eager
    ``model.decode_n_steps`` on the same saved state (lengths, next
    tokens, budgets, token indices, the cache): tokens, valid flags,
    budgets, lengths, next tokens, token indices and every cache tensor
    (the KV rows or ssm state written) must be equal bit for bit.  Then
    ``reps`` of each, timed on the host clock with the device synced,
    the state restored before each.  The engine is left as it was, its
    launch counts too; returns the timings and the replays it made."""
    import torch
    from repro_torch.kernels import add_launches, launch_counts, launch_delta
    n = eng.dispatch_n
    counts = launch_counts()
    eng.map_dispatch_pages(n)             # as decode_n does before it
    saved = _dispatch_state(eng)

    def replay():
        block, first = eng.graphs.run(n, lambda: eng._decode_block(n))
        if first:
            fail(f"{tag}: the n_steps={n} graph was not captured yet")
        return {"toks": block[:n], "valid": block[n:2 * n],
                "remaining": block[2 * n], "len": eng.cache["len"],
                "next": eng._next_token, "tok_idx": eng._tok_idx}

    def eager():
        toks, valid, nxt, cache, rem, idx = eng.model.decode_n_steps(
            eng.params, eng.cache, eng._next_token, eng._rng_decode,
            eng._remaining, eng._lane_seed, eng._tok_idx, n_steps=n,
            temperature=eng.temperature, len_cap=eng.max_len - 1)
        return {"toks": toks, "valid": valid.to(torch.int32),
                "remaining": rem, "len": cache["len"], "next": nxt,
                "tok_idx": idx}

    def timed(fn):
        _restore_dispatch_state(eng, saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        out["toks"].cpu()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def written():
        """The cache tensors a live lane may read: on the paged layout
        every page but the scratch page, which dead lanes write at once
        (their values race there, and no live lane reads it)."""
        return {k: (v[:, :eng._scratch_page] if k.endswith("_pages")
                    else v) for k, v in eng.cache.items() if k != "len"}

    got, _ = timed(replay)
    got = {k: v.clone() for k, v in got.items()}
    got.update({k: v.clone() for k, v in written().items()})
    want, _ = timed(eager)
    want.update(written())
    differ = [k for k in sorted(want) if not torch.equal(got[k], want[k])]
    if differ:
        fail(f"{tag}: a replayed dispatch differs from eager "
             f"decode_n_steps on the same state in {differ}")
    graph_s = [timed(replay)[1] for _ in range(reps)]
    eager_s = [timed(eager)[1] for _ in range(reps)]
    _restore_dispatch_state(eng, saved)
    add_launches(launch_delta(launch_counts(), counts))
    torch.cuda.synchronize()
    print(f"[{tag}] replayed dispatch == eager decode_n_steps bitwise "
          f"(n_steps {n}, {len(eng.live_lanes())} live lanes: tokens, "
          f"valid, budgets, lengths, next tokens, token indices, "
          f"{len(eng.cache) - 1} cache tensors); host ms a dispatch, "
          f"synced: eager {[round(1e3 * t, 3) for t in eager_s]}, graph "
          f"{[round(1e3 * t, 3) for t in graph_s]}")
    return {"n_steps": n, "check_replays": 1 + reps,
            "decode_ms_eager": 1e3 * statistics.median(eager_s),
            "decode_ms_graph": 1e3 * statistics.median(graph_s)}


def check_replay_midway(eng, tag, out):
    """Wrap ``eng.decode_n`` so that :func:`check_replay` runs once,
    after the first dispatch that captured ``dispatch_n`` with lanes
    still live; its result goes to ``out["check"]``."""
    decode_n = eng.decode_n

    def wrapped(n=None):
        res = decode_n(n)
        if "check" not in out and eng.live_lanes() and \
                eng.dispatch_n in eng.timings["capture"]:
            out["check"] = check_replay(eng, tag)
        return res

    eng.decode_n = wrapped


def prefill_gate(eng, tag, expect_replays=True):
    """Fail unless the serve replayed a bucket's prefill graph for every
    prefill but the first of its bucket (replays == prefills -
    ``prefill_compiles``, and > 0 unless ``expect_replays`` is False: a
    sharing serve prefills only its misses, a prefix hit streams its
    tail) and ``prefill_compiles`` equals the ``("prefill", b)`` graphs
    captured; returns the figures."""
    keys = sorted(k for k in eng.timings["capture"]
                  if isinstance(k, tuple) and k[0] == "prefill")
    flags = eng.timings["prefill_replayed"]
    prefills = sum(len(v) for v in flags.values())
    replays = sum(eng.graphs.replays(k) for k in keys)
    compiles = eng.stats["prefill_compiles"]
    if compiles != len(keys):
        fail(f"{tag}: prefill_compiles {compiles} but prefill graphs "
             f"captured for {keys}")
    if replays != prefills - compiles or (expect_replays and
                                          replays <= 0) or \
            replays != sum(sum(v) for v in flags.values()):
        fail(f"{tag}: {replays} prefill graph replays for {prefills} "
             f"prefills and {compiles} compiles: a prefill ran eagerly")
    return {"prefill_compiles": compiles, "prefill_replays": replays,
            "prefill_capture_s": {k[1]: eng.timings["capture"][k]
                                  for k in keys}}


def graph_summary(eng, tag, check, prefill_replays=True):
    """Fail unless the serve replayed a graph for every dispatch but the
    first of each size (replays == decode_dispatches - decode_compiles
    > 0, ``check``'s own replays left out) and ``check`` ran, and for
    every prefill but the first of its bucket (:func:`prefill_gate`,
    ``prefill_replays`` its ``expect_replays``); returns the serve's
    graph figures."""
    if check is None:
        fail(f"{tag}: the replay-vs-eager check never ran")
    sizes = sorted(k for k in eng.timings["capture"] if isinstance(k, int))
    replays = (sum(eng.graphs.replays(k) for k in sizes)
               - check["check_replays"])
    st = eng.stats
    if st["decode_compiles"] != len(sizes):
        fail(f"{tag}: decode_compiles {st['decode_compiles']} but graphs "
             f"captured for sizes {sizes}")
    if replays != st["decode_dispatches"] - st["decode_compiles"] or \
            replays <= 0:
        fail(f"{tag}: {replays} graph replays for "
             f"{st['decode_dispatches']} dispatches and "
             f"{st['decode_compiles']} compiles: the serve ran eagerly")
    dec = eng.timings["decode"]          # empty unless the engine is timed
    replayed = [t for t, r in zip(dec, eng.timings["decode_replayed"]) if r]
    first = [t for t, r in zip(dec, eng.timings["decode_replayed"]) if not r]
    return {"decode_compiles": st["decode_compiles"], "replays": replays,
            "capture_s": {str(k): eng.timings["capture"][k]
                          for k in sorted(eng.timings["capture"], key=str)},
            "pool_bytes": eng.graphs.pool_bytes(),
            "replayed_ms_median": (1e3 * statistics.median(replayed)
                                   if replayed else None),
            "first_dispatch_ms": [1e3 * t for t in first], **check,
            **prefill_gate(eng, tag, prefill_replays)}


def prefill_split(eng):
    """A timed serve's prefill ms by bucket: the first prompt's (eager on
    the capture stream; capture excluded) and the median of the
    replayed ones (None where the bucket had one prompt)."""
    out = {}
    for bucket, times in eng.timings["prefill"].items():
        flags = eng.timings["prefill_replayed"][bucket]
        rep = [1e3 * t for t, r in zip(times, flags) if r]
        out[bucket] = {"first_ms": 1e3 * times[0],
                       "replayed_ms": (round(statistics.median(rep), 3)
                                       if rep else None),
                       "n_replayed": len(rep)}
    return out


def stream_gate(eng, tag, reqs):
    """Fail unless every prompt token but the engine's first streamed
    through the ssm step's graph (one replay a token)."""
    want = sum(min(len(r.prompt), eng.max_len - 1) for r in reqs) - 1
    got = eng.graphs.replays("stream_step")
    if got != want:
        fail(f"{tag}: {got} replays of the prompt stream's step for "
             f"{want + 1} prompt tokens")
    return got


def print_graphs(tag, g):
    pool = g["pool_bytes"]
    print(f"[{tag}] graphs: decode_compiles {g['decode_compiles']}, "
          f"replays {g['replays']}; capture s "
          f"{ {k: round(v, 3) for k, v in g['capture_s'].items()} }; pool "
          f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'};"
          f" decode ms a dispatch (n_steps {g['n_steps']}, host, synced): "
          f"eager {g['decode_ms_eager']:.3f}, graph "
          f"{g['decode_ms_graph']:.3f}; the serve's replayed dispatches "
          f"median {g['replayed_ms_median']:.3f}, first (eager; capture "
          f"excluded) {[round(t, 3) for t in g['first_dispatch_ms']]}; "
          f"prefill_compiles {g['prefill_compiles']}, prefill replays "
          f"{g['prefill_replays']}")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernels built in "
          f"{time.perf_counter() - t0:.1f}s into {_build.build_dir()}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] card: {gpu_line()}")


def k1_inputs(dtype, dev, ps=16, t=64):
    """Main-path shapes: B=8 lanes, H=12, Hkv=2, D=128, ps=16, T=64
    (max_len 1024), shuffled disjoint tables, ragged lengths incl. a
    dead lane and a full table (clamped to T*ps)."""
    import numpy as np
    import torch
    b, h, hkv, d = 8, 12, 2, 128
    n_pages = b * t + 1
    rng = np.random.default_rng(SEED if (ps, t) == (16, 64) else
                                (SEED, ps, t))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d),
                                              np.float32))
    bt = torch.from_numpy(rng.permutation(n_pages)[:b * t].reshape(b, t)
                          .astype(np.int32))
    lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                        dtype=torch.int32)
    return ([x.to(dev, dtype) for x in (q, kp, vp)]
            + [bt.to(dev), lens.to(dev)])


#: (page size, pages a lane) of K1's and K4's checks: the serve's pages
#: of 16, pages of 8 and 32, and a lane of 1000 positions (T*ps not a
#: multiple of the chunk)
PAGED_CASES = ((16, 64), (8, 128), (32, 32), (8, 125))


def wild_table(bt, lens, ps):
    """``bt`` with every slot past a lane's length set to a page id far
    outside the pools: a kernel that read one would fault."""
    wild = bt.clone()
    for lane, n in enumerate(lens.tolist()):
        wild[lane, -(-min(n, bt.shape[1] * ps) // ps):] = 1 << 30
    return wild


def phase_k1(dev):
    """K1 against its plain version at PAGED_CASES, f32 (tol 1e-4) and
    bf16 (tol 2e-2), through a table whose slots past each length point
    far outside the pools; a dead lane gives 0, a second call repeats
    the bits, and K1 gives the bits of K3 on the gathered pools."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_ref,
        gather_pages)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = 0.0
        for ps, t in PAGED_CASES:
            q, kp, vp, bt, lens = k1_inputs(dtype, dev, ps, t)
            wild = wild_table(bt, lens, ps)
            out = decode_attention_paged(q, kp, vp, wild, lens)
            again = decode_attention_paged(q, kp, vp, wild, lens)
            ref = decode_attention_paged_ref(q, kp, vp, bt, lens)
            k3 = decode_attention(q, gather_pages(kp, bt),
                                  gather_pages(vp, bt), lens)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            what = f"{dtype} ps={ps} T={t}"
            print(f"[K1] {what}: max_abs_err {err:.3e} (tol {tol}), "
                  f"bitwise K3 {torch.equal(out, k3)}")
            if not err <= tol:
                fail(f"K1 {what} disagrees with its plain version: {err}")
            if not bool(torch.all(out[0] == 0)):
                fail("K1: dead lane did not give 0")
            if not torch.equal(out, again):
                fail(f"K1 did not repeat its bits ({what})")
            if not torch.equal(out, k3):
                fail(f"K1 differs from K3 on the gathered pools ({what})")
            worst = max(worst, err)
        errs[str(dtype).split(".")[-1]] = (worst, tol)
    return errs


def k2_inputs(sq, dtype, dev, d=128, h=12, hkv=2, sk=None, b=1):
    """q (b, h, sq, d) and k/v (b, hkv, sk, d) from the seed (sk: sq by
    default, whisper's cross-attention reads sk != sq)."""
    import numpy as np
    import torch
    sk = sq if sk is None else sk
    rng = np.random.default_rng(SEED + sq + (0 if d == 128 else d)
                                + (0 if hkv == 2 else 1000 * hkv)
                                + (0 if sk == sq else 7 * sk)
                                + (0 if b == 1 else 100000 * b))
    shapes = ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)
                             ).to(dev, dtype) for s in shapes]


#: K2's check cases (Sq, causal, window, D, H, Hkv[, Sk, B]; Sk = Sq
#: and B = 1 when left out): the full-width serve's buckets 64, 512 and 1024, a ragged
#: length, a sliding window, no mask, a window without causality, D 64,
#: 96 (phi-3-vision's; causal, a ragged windowed prompt, Sq 100 and 1000
#: (not multiples of 64), B 2, no mask at Sq 200 against Sk 256, GQA
#: group 4) and 256,
#: and the float32 SMOKE serve's shape (D 32, H 4) at its prompt buckets
#: (prompts of 3 to 127 tokens); then hymba-1.5b's (H 25 over Hkv 5, D
#: 64, window 1024) at its serve's largest bucket, 2048, where most
#: query tiles start past key 0, and at 512, and its SMOKE serve's
#: (window 32, D 32, H 4 over 2); then whisper-base's encoder (Sq = Sk =
#: 1500, not a multiple of the 64-key block, unmasked, D 64, H 8 over
#: 8) and its cross-attention (64 decoder positions against the 1500
#: encoder keys), both at the served batch of 4 (the tensor-core
#: kernel's TMA maps span B x Hkv), and phi-3-vision-4.2b's prefill (causal Sq 1024, D 96,
#: H 32 over 32)
K2_CASES = ((64, True, None, 128, 12, 2), (100, True, None, 128, 12, 2),
            (512, True, None, 128, 12, 2), (512, True, 128, 128, 12, 2),
            (1024, True, None, 128, 12, 2), (200, False, None, 128, 12, 2),
            (512, False, 96, 128, 12, 2), (512, True, None, 64, 12, 2),
            (256, True, None, 96, 12, 2), (300, True, 128, 96, 12, 2),
            (100, True, None, 96, 12, 2), (1000, True, None, 96, 12, 2),
            (300, True, None, 96, 12, 2, 300, 2),
            (200, False, None, 96, 12, 2, 256, 1),
            (512, True, None, 96, 16, 4),
            (256, True, None, 256, 12, 2),
            *((sq, True, None, 32, 4, 2) for sq in (8, 16, 32, 64, 128)),
            (2048, True, 1024, 64, 25, 5), (512, True, 1024, 64, 25, 5),
            (64, True, 32, 32, 4, 2),
            (1500, False, None, 64, 8, 8, 1500, 4),
            (64, False, None, 64, 8, 8, 1500, 4),
            (1024, True, None, 96, 32, 32))
#: (D, H) of the float32 SMOKE serve's prefill, which runs K2's CUDA-core
#: kernel on the main path
SMOKE_K2_SHAPE = (32, 4)


def phase_k2(dev):
    """K2 against its plain version at K2_CASES, float32 (tol 1e-4) and
    bfloat16 (tol 2e-2); the launch counters must name the kernel that
    ``kernel_for`` picks from the dtype and D: the tensor-core kernel
    for bf16 at D 64, 96 and 128, the CUDA-core kernel otherwise.
    Returns {kernel: {dtype: (worst error over its cases, tol)}}, under
    ``"smoke"`` the worst float32 error at ``SMOKE_K2_SHAPE``, and under
    ``"hymba"`` the worst at hymba-1.5b's shapes (Hkv 5), under
    ``"whisper"`` at whisper-base's (Hkv 8) and under ``"phi3v"`` at
    phi-3-vision-4.2b's (Hkv 32).  whisper's bf16 cases are also held
    element by element within ``k2_scaled_check``'s bound (under
    ``"scaled"``) and by their least-squares scale (under ``"scale"``);
    every bf16 D 96 case likewise (under ``"d96_scaled"`` and
    ``"d96_scale"``; its worst error under ``"d96"``)."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import kernel_for
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        key = str(dtype).split(".")[-1]
        for sq, causal, window, d, h, hkv, *rest in K2_CASES:
            sk, b = rest if rest else (sq, 1)
            kernel = f"flash_attention_{kernel_for(dtype, d)}"
            q, k, v = k2_inputs(sq, dtype, dev, d, h, hkv, sk=sk, b=b)
            before = launch_counts()
            out = flash_attention(q, k, v, causal=causal, window=window)
            ran = {n: c - before[n] for n, c in launch_counts().items()
                   if c != before[n]}
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[K2] {dtype} B={b} Sq={sq} Sk={sk} causal={causal} "
                  f"window={window} D={d} H={h} Hkv={hkv}: {kernel}, "
                  f"max_abs_err "
                  f"{err:.3e} (tol {tol})")
            if ran != {kernel: 1}:
                fail(f"K2 {dtype} D={d} launched {ran}, not {kernel}")
            if not err <= tol:
                fail(f"K2 {dtype} Sq={sq} D={d} window={window} "
                     f"disagrees: {err}")
            worst = errs.setdefault(kernel, {}).get(key, (0.0, tol))[0]
            errs[kernel][key] = (max(worst, err), tol)
            if dtype == torch.float32 and (d, h) == SMOKE_K2_SHAPE:
                worst = errs[kernel].get("smoke", (0.0, tol))[0]
                errs[kernel]["smoke"] = (max(worst, err), tol)
            shape_key = {5: "hymba", 8: "whisper", 32: "phi3v"}.get(hkv)
            if shape_key:
                worst = errs[kernel].get(shape_key, (0.0, tol))[0]
                errs[kernel][shape_key] = (max(worst, err), tol)
            if shape_key == "whisper" and dtype == torch.bfloat16:
                k2_scaled_check(errs, "whisper-base", out, q, k, v, kernel,
                                causal=causal)
            if d == 96 and dtype == torch.bfloat16:
                worst = errs[kernel].get("d96", (0.0, tol))[0]
                errs[kernel]["d96"] = (max(worst, err), tol)
                k2_scaled_check(errs, f"D 96 (H {h}/{hkv})",
                                out, q, k, v, kernel, causal=causal,
                                window=window, key="d96_")
    return errs


#: whisper-base's cross-attention decode: 4 lanes, H 8 over Hkv 8, D 64,
#: every lane at the full 1500 encoder positions
WHISPER_CROSS = dict(b=4, h=8, hkv=8, d=64, s=1500)


def dense_inputs(dtype, dev, s=1024, b=8, h=12, hkv=2, d=128, full=False):
    """Fixed-lane path shapes: B=8 lanes, H=12, Hkv=2, D=128, a cache of
    S positions (max_len 1024), ragged lengths incl. a dead lane and a
    full lane (clipped to S); ``full``: every lane at S (whisper's cross
    K/V)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + s + (0 if (b, h, hkv, d) == (
        8, 12, 2, 128) else 31 * b + h + hkv + d))
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
    if full:
        lens = torch.full((b,), s, dtype=torch.int32)
    else:
        lens = torch.tensor([0, 1, 15, 16, 17, 300, 777, 1024],
                            dtype=torch.int32).clamp(max=s)
    return [x.to(dev, dtype) for x in (q, k, v)] + [lens.to(dev)]


def phase_dense(dev):
    """K3 and K6a against their plain version at S 1024 and 1000, and at
    whisper-base's cross-attention (``WHISPER_CROSS``: S 1500, every
    lane at full length), f32 (tol 1e-4) and bf16 (tol 2e-2): a dead
    lane gives exactly 0, K3 equals K6a, and a second call of each
    repeats the bits (the merge adds the chunks in a fixed order).
    Under ``"whisper"`` the bf16 error at the cross shape."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    errs = {"decode_attention_lengthaware": {}, "decode_attention_masked": {}}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = {name: 0.0 for name in errs}
        for s, shape in ((1024, {}), (1000, {}), (1500, WHISPER_CROSS)):
            args = (dense_inputs(dtype, dev, full=True, **shape) if shape
                    else dense_inputs(dtype, dev, s))
            la = decode_attention(*args)
            masked = decode_attention(*args, length_aware=False)
            again = (decode_attention(*args),
                     decode_attention(*args, length_aware=False))
            ref = decode_attention_ref(*args)
            torch.cuda.synchronize()
            for name, out in (("decode_attention_lengthaware", la),
                              ("decode_attention_masked", masked)):
                err = max_err(out, ref)
                print(f"[K3/K6a] {name} {dtype} S={s}"
                      f"{' (whisper cross, every lane full)' if shape else ''}"
                      f": max_abs_err {err:.3e} (tol {tol})")
                if not err <= tol:
                    fail(f"{name} {dtype} S={s} disagrees with its plain "
                         f"version: {err}")
                if not shape and not bool(torch.all(out[0] == 0)):
                    fail(f"{name}: dead lane did not give 0")
                worst[name] = max(worst[name], err)
                if shape and dtype == torch.bfloat16:
                    errs[name]["whisper"] = (err, tol)
            if not torch.equal(la, masked):
                fail(f"K3 and K6a differ ({dtype}, S={s})")
            if not (torch.equal(la, again[0]) and
                    torch.equal(masked, again[1])):
                fail(f"K3/K6a did not repeat their bits ({dtype}, S={s})")
        for name in errs:
            errs[name][str(dtype).split(".")[-1]] = (worst[name], tol)
    return errs


def q8_dense_inputs(dtype, dev, s, qblock):
    """``dense_inputs`` with K/V quantized to int8 with one f32 scale per
    ``qblock`` positions (``qblock=1``: the model's per-token scales)."""
    from repro_torch.kernels.decode_attention import quantize_kv_q8
    q, k, v, lens = dense_inputs(dtype, dev, s)
    kq, ks = quantize_kv_q8(k.float(), qblock)
    vq, vs = quantize_kv_q8(v.float(), qblock)
    return [q, kq, ks, vq, vs, lens]


def q8_paged_inputs(dtype, dev, qblock, ps=16, t=64):
    """``k1_inputs`` with the pools quantized to int8 with one f32 scale
    per ``qblock`` positions of a page."""
    from repro_torch.kernels.decode_attention import quantize_kv_q8
    q, kp, vp, bt, lens = k1_inputs(dtype, dev, ps, t)
    kq, ks = quantize_kv_q8(kp.float(), qblock)
    vq, vs = quantize_kv_q8(vp.float(), qblock)
    return [q, kq, ks, vq, vs, bt, lens]


def _route_dense(q, kq, ks, vq, vs, lens, qblock):
    """The reference model's int8 route: dequantize the whole cache to
    float32, then the fp kernel (K3) in float32, cast back to q's dtype."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      dequant_kv_q8)
    return decode_attention(q.float(), dequant_kv_q8(kq, ks, qblock),
                            dequant_kv_q8(vq, vs, qblock), lens).to(q.dtype)


def _route_paged(q, kq, ks, vq, vs, bt, lens, qblock):
    """As :func:`_route_dense` over the pools, with K1."""
    from repro_torch.kernels.decode_attention import (decode_attention_paged,
                                                      dequant_kv_q8)
    return decode_attention_paged(q.float(), dequant_kv_q8(kq, ks, qblock),
                                  dequant_kv_q8(vq, vs, qblock), bt,
                                  lens).to(q.dtype)


def phase_q8(dev):
    """K5/K6b (dense, S 1024 at qblock 1 and 32, S 1000 at qblock 1) and
    K4 (paged: pages of 16 at qblock 1 and 16, of 8 at qblock 1, of 32
    at qblock 16, through a table whose dead slots point outside the
    pools) against their plain versions; K4 repeats its bits and gives
    those of K5 on the gathered pools."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_q8, decode_attention_paged_q8_ref,
        decode_attention_q8, decode_attention_q8_ref, gather_pages)
    names = ("decode_attention_q8_lengthaware", "decode_attention_q8_masked",
             "decode_attention_paged_q8")
    errs = {name: {} for name in names}

    def check(name, out, ref, tol, what):
        err = max_err(out, ref)
        print(f"[K4/K5/K6b] {name} {what}: max_abs_err {err:.3e} "
              f"(tol {tol})")
        if not err <= tol:
            fail(f"{name} {what} disagrees: {err}")
        if not bool(torch.all(out[0] == 0)):
            fail(f"{name}: dead lane did not give 0")
        return err

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        worst = {name: 0.0 for name in names}
        for s, qblock in ((1024, 1), (1024, 32), (1000, 1)):
            args = q8_dense_inputs(dtype, dev, s, qblock)
            la = decode_attention_q8(*args, qblock=qblock)
            masked = decode_attention_q8(*args, qblock=qblock,
                                         length_aware=False)
            again = decode_attention_q8(*args, qblock=qblock)
            ref = decode_attention_q8_ref(*args, qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} S={s} qblock={qblock}"
            for name, out in ((names[0], la), (names[1], masked)):
                worst[name] = max(worst[name],
                                  check(name, out, ref, tol, what))
            if not torch.equal(la, masked):
                fail(f"K5 and K6b differ ({what})")
            if not torch.equal(la, again):
                fail(f"K5 did not repeat its bits ({what})")
            if qblock == 1:
                route = _route_dense(*args, qblock)
                torch.cuda.synchronize()
                err = max_err(la, route)
                print(f"[K4/K5/K6b] K5 vs dequantize + K3 {what}: "
                      f"max_abs_err {err:.3e}, bitwise {torch.equal(la, route)}")
                if not err <= tol:
                    fail(f"K5 disagrees with the reference's route: {err}")
        for ps, t, qblock in ((16, 64, 1), (16, 64, 16), (8, 128, 1),
                              (32, 32, 16)):
            args = q8_paged_inputs(dtype, dev, qblock, ps, t)
            q, kq, ks, vq, vs, bt, lens = args
            wild = wild_table(bt, lens, ps)
            out = decode_attention_paged_q8(q, kq, ks, vq, vs, wild, lens,
                                            qblock=qblock)
            again = decode_attention_paged_q8(q, kq, ks, vq, vs, wild,
                                              lens, qblock=qblock)
            ref = decode_attention_paged_q8_ref(*args, qblock=qblock)
            k5 = decode_attention_q8(
                q, gather_pages(kq, bt), gather_pages(ks, bt),
                gather_pages(vq, bt), gather_pages(vs, bt), lens,
                qblock=qblock)
            torch.cuda.synchronize()
            what = f"{dtype} ps={ps} qblock={qblock}"
            worst[names[2]] = max(worst[names[2]],
                                  check(names[2], out, ref, tol, what))
            print(f"[K4/K5/K6b] K4 vs K5 on the gathered pools {what}: "
                  f"bitwise {torch.equal(out, k5)}")
            if not torch.equal(out, again):
                fail(f"K4 did not repeat its bits ({what})")
            if not torch.equal(out, k5):
                fail(f"K4 differs from K5 on the gathered pools ({what})")
            if qblock == 1 and ps == 16:
                route = _route_paged(*args, qblock)
                torch.cuda.synchronize()
                err = max_err(out, route)
                print(f"[K4/K5/K6b] K4 vs dequantize + K1 {what}: "
                      f"max_abs_err {err:.3e}, bitwise "
                      f"{torch.equal(out, route)}")
                if not err <= tol:
                    fail(f"K4 disagrees with the reference's route: {err}")
        for name in names:
            errs[name][str(dtype).split(".")[-1]] = (worst[name], tol)
    return errs


#: hymba-1.5b's decode attention: H 25 over Hkv 5 (GQA group 5), D 64, a
#: ring of the window's 1024 slots (paged: 64 pages of 16), four lanes
#: at cache lengths 1000, 1024, 1500 and 96 -- the first three past the
#: window's last slot or wrapped, so every slot is read, the newest
#: mid-ring -- read with the model's lengths ``min(len + 1, 1024)``
HYMBA_DECODE = dict(h=25, hkv=5, d=64, s=1024, ps=16,
                    lens=(1000, 1024, 1500, 96))


def hymba_decode_inputs(dtype, dev):
    """q (B, 25, 64), pools (B * 64 + 1, 5, 16, 64) and a shuffled table
    (B, 64) of disjoint pages, the lengths the model passes, and the
    lanes' rings gathered from the pools (B, 5, 1024, 64)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import gather_pages
    c = HYMBA_DECODE
    b, t = len(c["lens"]), c["s"] // c["ps"]
    rng = np.random.default_rng(SEED + 5)
    q = torch.from_numpy(rng.standard_normal((b, c["h"], c["d"]),
                                             np.float32))
    pools = [torch.from_numpy(rng.standard_normal(
        (b * t + 1, c["hkv"], c["ps"], c["d"]), np.float32))
        for _ in range(2)]
    bt = torch.from_numpy(rng.permutation(b * t + 1)[:b * t]
                          .reshape(b, t).astype(np.int32)).to(dev)
    lens = torch.tensor([min(n + 1, c["s"]) for n in c["lens"]],
                        dtype=torch.int32, device=dev)
    q, kp, vp = (x.to(dev, dtype) for x in [q] + pools)
    return q, kp, vp, bt, lens, gather_pages(kp, bt), gather_pages(vp, bt)


def phase_hymba_decode(dev):
    """K3 and K1 (and, over int8 with per-token scales, K5 and K4) at
    hymba-1.5b's decode shapes (``HYMBA_DECODE``: GQA group 5, a wrapped
    ring of 1024 slots, paged through a shuffled table) against their
    plain versions, f32 (tol 1e-4) and bf16 (tol 2e-2): K1 gives K3's
    bits on the gathered rings (K4 K5's), and each repeats its bits.
    Returns {kernel: {dtype: (max_abs_err, tol)}}."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, kp, vp, bt, lens, k, v = hymba_decode_inputs(dtype, dev)
        kq, ks = quantize_kv_q8(kp.float(), 1)
        vq, vs = quantize_kv_q8(vp.float(), 1)
        gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
        runs = {
            "decode_attention_lengthaware": (
                lambda: decode_attention(q, k, v, lens),
                decode_attention_ref(q, k, v, lens)),
            "decode_attention_paged": (
                lambda: decode_attention_paged(q, kp, vp, bt, lens),
                decode_attention_paged_ref(q, kp, vp, bt, lens)),
            "decode_attention_q8_lengthaware": (
                lambda: decode_attention_q8(q, *gq, lens, qblock=1),
                decode_attention_q8_ref(q, *gq, lens, qblock=1)),
            "decode_attention_paged_q8": (
                lambda: decode_attention_paged_q8(q, kq, ks, vq, vs, bt,
                                                  lens, qblock=1),
                decode_attention_paged_q8_ref(q, kq, ks, vq, vs, bt, lens,
                                              qblock=1))}
        outs = {}
        for name, (run, ref) in runs.items():
            out, again = run(), run()
            torch.cuda.synchronize()
            err = max_err(out, ref)
            print(f"[hymba decode] {name} {dtype} H=25 Hkv=5 D=64 S=1024 "
                  f"lengths {lens.tolist()}: max_abs_err {err:.3e} (tol "
                  f"{tol})")
            if not err <= tol:
                fail(f"{name} at hymba's shapes ({dtype}) disagrees with "
                     f"its plain version: {err}")
            if not torch.equal(out, again):
                fail(f"{name} did not repeat its bits at hymba's shapes")
            errs.setdefault(name, {})[str(dtype).split(".")[-1]] = (err,
                                                                    tol)
            outs[name] = out
        for paged, dense in (("decode_attention_paged",
                              "decode_attention_lengthaware"),
                             ("decode_attention_paged_q8",
                              "decode_attention_q8_lengthaware")):
            if not torch.equal(outs[paged], outs[dense]):
                fail(f"{paged} differs from {dense} on the gathered rings "
                     f"at hymba's shapes ({dtype})")
        print(f"[hymba decode] {dtype}: K1 == K3 and K4 == K5 bitwise on "
              f"the wrapped rings through the shuffled table")
    return errs


def _requests(cfg, n, plen_lo, plen_hi, gen, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    plens = rng.integers(plen_lo, plen_hi + 1, n)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(p)
                                               ).astype(np.int32),
                    max_new_tokens=gen) for i, p in enumerate(plens)]


def phase_smoke_e2e(dev, kv_quant=None, arch="qwen2.5-1.5b"):
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", kv_quant=kv_quant)
    tag = (f"[smoke e2e{'' if arch == 'qwen2.5-1.5b' else ' ' + arch}"
           f"{' int8' if kv_quant else ''}]")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = copy.deepcopy(params).to(dev)
    streams, counts = {}, {}
    runs = [("cpu", False, 0.0), ("cuda", False, 0.0), ("cuda", True, 0.0),
            ("cpu", False, 0.8), ("cuda", False, 0.8), ("cuda", True, 0.8),
            ("cpu", True, 0.0)]
    for where, paged, temperature in runs:
        eng = ServeEngine(cfg, params if where == "cpu" else on_card,
                          n_lanes=4, max_len=128, temperature=temperature,
                          rng_seed=SEED + 3, paged=paged, page_size=16,
                          n_pages=24, device=where)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        checked = {}
        if where == "cuda":
            check_replay_midway(
                eng, f"{tag} paged={paged} t={temperature}", checked)
        reset_launch_counts()
        eng.run(reqs)
        counts[where, paged, temperature] = launch_counts()
        if where == "cuda":
            g = graph_summary(eng, f"{tag} paged={paged} t={temperature}",
                              checked.get("check"))
            streamed = (f", {stream_gate(eng, tag, reqs)} prompt-stream "
                        f"replays" if cfg.has_ssm else "")
            print(f"{tag} paged={paged} t={temperature}: "
                  f"{g['replays']} replays, decode_compiles "
                  f"{g['decode_compiles']}{streamed}")
        k10 = counts[where, paged, temperature]["ssd_chunk"]
        if cfg.has_ssm and where == "cuda" and \
                k10 != cfg.n_layers * len(reqs):
            fail(f"{tag} K10 launched {k10} times, not {cfg.n_layers} per "
                 f"prompt ({where}, paged={paged}, t={temperature})")
        if paged:
            eng.pool.check()
        streams[where, paged, temperature] = [r.generated for r in reqs]
    pairs = [(("cpu", True, 0.0), ("cuda", True, 0.0),
              "paged greedy, CPU vs card"),
             (("cpu", False, 0.0), ("cuda", False, 0.0),
              "fixed-lane greedy, CPU vs card"),
             (("cpu", False, 0.8), ("cuda", False, 0.8),
              "fixed-lane temperature 0.8, CPU vs card"),
             (("cuda", False, 0.0), ("cuda", True, 0.0),
              "greedy, fixed-lane vs paged on the card"),
             (("cuda", False, 0.8), ("cuda", True, 0.8),
              "temperature 0.8, fixed-lane vs paged on the card")]
    for a, b, what in pairs:
        same = sum(x == y for x, y in zip(streams[a], streams[b]))
        print(f"{tag} float32 SMOKE: {same}/{len(streams[a])} "
              f"streams identical, {what}")
        if same != len(streams[a]):
            fail(f"{tag} SMOKE streams differ: {what}")
    if streams["cuda", False, 0.0] == streams["cuda", False, 0.8]:
        fail(f"{tag} temperature 0.8 gave the greedy streams: nothing was "
             "sampled")
    return counts["cuda", False, 0.0], counts["cuda", True, 0.0]


def init_full(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2.5-1.5b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[full e2e] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve_full(dev, cfg, params, tag, need, reqs=None, n_lanes=8,
               prefill_replays=True, **engine_kw):
    """Serve the full-width traffic (``reqs``; by default 16 requests,
    prompts 64-700 from the seed, 64 new tokens; 8 lanes, max_len 1024)
    through one engine with the launch counts zeroed just before and
    read just after; fail unless every budget finishes and every kernel
    in ``need`` ran, and unless the graphs replayed
    (:func:`graph_summary`; ``prefill_replays`` False where the traffic
    prefills no bucket twice).  The summary carries the engine's stats
    and timings."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServeEngine
    if reqs is None:
        reqs = _requests(cfg, 16, 64, 700, 64, SEED + 2)
    gen = reqs[0].max_new_tokens
    eng = ServeEngine(cfg, params, n_lanes=n_lanes, max_len=1024, device=dev,
                      timed=True, **engine_kw)
    checked = {}
    check_replay_midway(eng, tag, checked)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    if eng.paged:
        eng.pool.check()
    if not all(r.done and len(r.generated) == gen for r in reqs):
        fail(f"{tag}: full-width run did not finish every request's budget")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: generated token outside the vocabulary")
    if min(counts[k] for k in need) <= 0:
        fail(f"{tag}: a kernel of the path never launched: {counts}")
    graphs = graph_summary(eng, tag, checked.get("check"), prefill_replays)
    pre = eng.timings["prefill"]
    dec = eng.timings["decode"]
    print(f"[{tag}] {len(reqs)} requests, {n_gen} tokens in {wall:.3f}s "
          f"= {n_gen / wall:.1f} tok/s end to end; stats {dict(eng.stats)}")
    print_graphs(tag, graphs)
    replayed = prefill_split(eng)
    for bucket in sorted(pre):
        print(f"[{tag}] prefill bucket {bucket}: {len(pre[bucket])} "
              f"prompts, median {1e3 * statistics.median(pre[bucket]):.2f} "
              f"ms (first, eager: {replayed[bucket]['first_ms']:.2f}; "
              f"replayed: {replayed[bucket]['replayed_ms']})")
    print(f"[{tag}] decode: {len(dec)} dispatches, median "
          f"{1e3 * statistics.median(dec):.2f} ms per dispatch "
          f"({eng.dispatch_n} steps x {eng.n_lanes} lanes max)")
    print(f"[{tag}] launches: {counts}")
    summary = {"tok_s": n_gen / wall, "wall_s": wall,
               "prefill_ms": {b: 1e3 * statistics.median(v)
                              for b, v in pre.items()},
               "prefill_split_ms": replayed,
               "decode_ms_per_dispatch": 1e3 * statistics.median(dec),
               "n_dispatches": len(dec),
               "decode_steps": eng.stats["decode_steps"], "graphs": graphs,
               "stats": dict(eng.stats),
               "prefix_stream_s": list(eng.timings["prefix_stream"]),
               "prefix_tail_tokens": list(eng.timings["prefix_tail_tokens"]),
               "stream_replays": eng.graphs.replays("stream_step")}
    if eng.prefix_cache is not None:
        eng.prefix_cache.flush()
        eng.pool.check()
        if eng.pool.n_in_use:
            fail(f"{tag}: {eng.pool.n_in_use} pages left in use after the "
                 f"cache was flushed")
    del eng                     # the check's wrapper holds a cycle to it
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def phase_full_paged(dev, cfg, params):
    counts, summary = serve_full(dev, cfg, params, "full e2e paged",
                                 ("decode_attention_paged",
                                  "flash_attention_mma"),
                                 paged=True, page_size=16, n_pages=256)
    per_step = counts["decode_attention_paged"] / summary["decode_steps"]
    print(f"[full e2e paged] K1 launches per decode step: {per_step}")
    if per_step != cfg.n_layers:
        fail(f"K1 launched {per_step} times per decode step, not "
             f"{cfg.n_layers}")
    # outputs: finite last-position logits with the padded vocab masked
    import torch
    from repro_torch.models.transformer import lm_prefill_batched
    prompt = torch.from_numpy(_requests(cfg, 1, 64, 64, 1, SEED)[0]
                              .prompt[None]).to(dev)
    logits, _ = lm_prefill_batched(params, prompt, cfg)
    if logits.shape != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()) or \
            not bool((logits[:, cfg.vocab_size:] == -1e30).all()):
        fail("full-width prefill logits are not finite/masked as expected")
    return counts, summary


def phase_full_fixed(dev, cfg, params):
    need = ("decode_attention_lengthaware", "flash_attention_mma")
    counts, summary = serve_full(dev, cfg, params, "full e2e fixed-lane",
                                 need)
    per_step = counts["decode_attention_lengthaware"] / summary["decode_steps"]
    print(f"[full e2e fixed-lane] K3 launches per decode step: {per_step}")
    if per_step != cfg.n_layers:
        fail(f"K3 launched {per_step} times per decode step, not "
             f"{cfg.n_layers}")
    # the same traffic sampled at temperature 0.8: every budget finishes
    # inside the vocabulary (serve_full checks both)
    _, sampled = serve_full(dev, cfg, params, "full e2e fixed-lane t=0.8",
                            need, temperature=0.8, rng_seed=SEED)
    summary["temperature_0.8"] = sampled
    return counts, summary


def phase_full_int8(dev, cfg, params):
    """The same traffic with ``kv_quant="int8"`` on both layouts: K5
    (fixed-lane) and K4 (paged) launch 28 times per decode step, the fp
    decode kernels never."""
    import dataclasses
    cfg_q = dataclasses.replace(cfg, kv_quant="int8")
    out = {}
    for tag, kernel, fp_kernel, kw in (
            ("full e2e fixed-lane int8", "decode_attention_q8_lengthaware",
             "decode_attention_lengthaware", {}),
            ("full e2e paged int8", "decode_attention_paged_q8",
             "decode_attention_paged",
             dict(paged=True, page_size=16, n_pages=256))):
        counts, summary = serve_full(dev, cfg_q, params, tag,
                                     (kernel, "flash_attention_mma"), **kw)
        per_step = counts[kernel] / summary["decode_steps"]
        print(f"[{tag}] {kernel} launches per decode step: {per_step}")
        if per_step != cfg.n_layers:
            fail(f"{kernel} launched {per_step} times per decode step, not "
                 f"{cfg.n_layers}")
        if counts[fp_kernel] or counts["decode_attention_q8_masked"]:
            fail(f"{tag}: another decode kernel ran: {counts}")
        out[tag] = (counts, summary)
    return out


def _k2_row(q, k, v, bytes_per_elem, causal=True):
    """K2's timing row at one shape, causal (the work: the Sq (Sq + 1) /
    2 live pairs) or unmasked (Sq x Sk pairs): the kernel (through the
    wrapper, which picks the kernel by dtype and head dim), its plain
    version, and SDPA on the same inputs."""
    from torch.nn import functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    import torch
    sq, sk = q.shape[2], k.shape[2]
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return dict(
        # the peak of the input type, whichever arm the wrapper picks:
        # TF32 for float32 inputs, bf16 tensor cores for bf16 ones
        peak=TF32_FLOPS_PER_S if q.dtype == torch.float32
        else BF16_FLOPS_PER_S,
        ms=time_ms_queued(lambda: flash_attention(q, k, v, causal=causal)),
        host_ms=host_ms(lambda: flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms_queued(lambda: attention_ref(q, k, v,
                                                      causal=causal)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)),
        bytes=bytes_per_elem * (2 * q.numel() + k.numel() + v.numel()),
        flops=4 * q.shape[0] * q.shape[1] * pairs * q.shape[3])


def phase_timings(dev):
    """Every attention kernel at the serves' shapes as device time per
    call (``time_ms_queued``), beside its plain version, SDPA where one
    call computes the same function, K1's pages gathered and then SDPA,
    and the dequantize route of the int8 kernels."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages)
    rows = {}
    # K1: bf16, main-path shapes
    q, kp, vp, bt, lens = k1_inputs(torch.bfloat16, dev)
    ps, t = kp.shape[2], bt.shape[1]
    live = lens.clamp(max=t * ps).to(torch.int64)
    n_live = int(live.sum().item())
    hkv, d, h = kp.shape[1], kp.shape[3], q.shape[1]
    pages_live = int(((live + ps - 1) // ps).sum().item())
    k1_bytes = (2 * n_live * hkv * d * 2 + 2 * q.numel() * 2
                + 4 * pages_live + 4 * lens.numel())
    k1_flops = 4 * n_live * h * d
    # the closest library yardstick: no single call reads a block table,
    # so gather the live lanes' pages, then SDPA with the length mask
    alive = lens >= 1
    mask = (torch.arange(t * ps, device=dev)[None, :] < lens[:, None])[alive]
    mask = mask[:, None, None, :].contiguous()
    ql = q[alive][:, :, None].contiguous()

    def gather_sdpa():
        return F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt)[alive], gather_pages(vp, bt)[alive],
            attn_mask=mask, enable_gqa=True)
    rows["decode_attention_paged"] = dict(
        ms=time_ms_queued(lambda: decode_attention_paged(q, kp, vp, bt,
                                                         lens)),
        host_ms=host_ms(lambda: decode_attention_paged(q, kp, vp, bt, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_ref(
            q, kp, vp, bt, lens)),
        library_ms=None, gather_sdpa_ms=time_ms_queued(gather_sdpa),
        bytes=k1_bytes, flops=k1_flops)
    # K2: B=1, H 12, Hkv 2, D 128, causal; bf16 (the serves' dtype: the
    # tensor-core kernel) at Sq 512 and the serve's largest bucket, 1024;
    # float32 (the CUDA-core kernel) at Sq 512 beside f32 SDPA, and bf16
    # at phi-3-vision's D 96 (the tensor-core kernel) beside bf16 SDPA
    q, k, v = k2_inputs(512, torch.bfloat16, dev)
    rows["flash_attention_mma"] = _k2_row(q, k, v, 2)
    q, k, v = k2_inputs(1024, torch.bfloat16, dev)
    rows["flash_attention_mma"]["s1024"] = _k2_row(q, k, v, 2)
    q, k, v = k2_inputs(512, torch.float32, dev)
    rows["flash_attention_cc"] = _k2_row(q, k, v, 4)
    q, k, v = k2_inputs(512, torch.bfloat16, dev, d=96)
    rows["flash_attention_mma"]["d96"] = _k2_row(q, k, v, 2)
    # K3 / K6a: bf16, fixed-lane path shapes (S = 1024)
    q, k, v, lens = dense_inputs(torch.bfloat16, dev)
    b, hkv, s, d = k.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    io_bytes = 2 * q.numel() * 2 + 4 * lens.numel()     # q, out, lens
    live = lens >= 1                                    # SDPA: no dead lane
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[live]
    mask = mask[:, None, None, :].contiguous()
    ql, kl, vl = q[live][:, :, None].contiguous(), k[live], v[live]
    sdpa_ms = time_ms_queued(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, enable_gqa=True))
    for name, la, n_pos in (("decode_attention_lengthaware", True, n_live),
                            ("decode_attention_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms_queued(lambda: decode_attention(q, k, v, lens,
                                                       length_aware=la)),
            host_ms=host_ms(lambda: decode_attention(q, k, v, lens,
                                                     length_aware=la)),
            plain_ms=time_ms_queued(lambda: decode_attention_ref(q, k, v,
                                                                 lens)),
            library_ms=sdpa_ms,
            bytes=2 * n_pos * hkv * d * 2 + io_bytes,
            flops=4 * n_pos * h * d)
    # K5 / K6b / K4: bf16 q over int8 caches with the model's per-token
    # scales (qblock 1), the serves' layout; no single PyTorch call
    # computes int8 attention, so beside each stands the reference
    # model's route (dequantize to float32, then K3 or K1) instead
    q, kq, ks, vq, vs, lens = q8_dense_inputs(torch.bfloat16, dev, 1024, 1)
    b, hkv, s, d = kq.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    row_bytes = hkv * (2 * d + 2 * 4)       # int8 k and v, f32 k/v scales
    route_ms = time_ms_queued(lambda: _route_dense(q, kq, ks, vq, vs, lens,
                                                   1))
    for name, la, n_pos in (("decode_attention_q8_lengthaware", True,
                             n_live),
                            ("decode_attention_q8_masked", False, b * s)):
        rows[name] = dict(
            ms=time_ms_queued(lambda: decode_attention_q8(
                q, kq, ks, vq, vs, lens, qblock=1, length_aware=la)),
            host_ms=host_ms(lambda: decode_attention_q8(
                q, kq, ks, vq, vs, lens, qblock=1, length_aware=la)),
            plain_ms=time_ms_queued(lambda: decode_attention_q8_ref(
                q, kq, ks, vq, vs, lens, qblock=1)),
            library_ms=None, route_ms=route_ms,
            bytes=n_pos * row_bytes + io_bytes,
            flops=4 * n_pos * h * d + 2 * n_pos * hkv * d)
    q, kq, ks, vq, vs, bt, lens = q8_paged_inputs(torch.bfloat16, dev, 1)
    ps, t = kq.shape[2], bt.shape[1]
    live = lens.clamp(max=t * ps).to(torch.int64)
    n_live = int(live.sum().item())
    pages_live = int(((live + ps - 1) // ps).sum().item())
    rows["decode_attention_paged_q8"] = dict(
        ms=time_ms_queued(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        host_ms=host_ms(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_paged(q, kq, ks, vq, vs, bt,
                                                     lens, 1)),
        bytes=(n_live * row_bytes + 2 * q.numel() * 2 + 4 * pages_live
               + 4 * lens.numel()),
        flops=4 * n_live * h * d + 2 * n_live * hkv * d)
    for name, r in rows.items():
        for tag, rr in (("", r), (" Sq 1024", r.get("s1024")),
                        (" bf16 D 96", r.get("d96"))):
            if rr is None:
                continue
            # K2's rows carry their input type's peak; the rest are bf16
            peak = rr.get("peak", BF16_FLOPS_PER_S)
            t_bytes = 1e3 * rr["bytes"] / HBM_BYTES_PER_S
            t_ops = 1e3 * rr["flops"] / peak
            rr["bound_ms"] = max(t_bytes, t_ops)
            rr["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            lib = rr["library_ms"]
            route = (f", dequantize + fp kernel {rr['route_ms']:.4f} ms"
                     if "route_ms" in rr else "")
            if "gather_sdpa_ms" in rr:
                route += (f", gather pages + SDPA "
                          f"{rr['gather_sdpa_ms']:.4f} ms")
            print(f"[time] {name}{tag}: kernel {rr['ms']:.4f} ms (host "
                  f"{rr['host_ms']:.4f} ms a call), plain "
                  f"{rr['plain_ms']:.4f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}{route}, "
                  f"bound {rr['bound_ms']:.5f} ms ({rr['bound_by']}: "
                  f"{rr['bytes']} B, {rr['flops']} flop)")
    return rows


# ----------------------------------------------------------------------
# the paper's compute path: K8 (mixbench), K9 (fma_matmul), K7 (qmatmul)
# ----------------------------------------------------------------------

#: further published H100 SXM peaks (NVIDIA data sheet) for the bounds:
#: FP32 outside the tensor cores (an unfused multiply and add issue two
#: instructions per multiply-accumulate: half of it), TF32 and int8
#: tensor cores
FP32_FLOPS_PER_S = 66.9e12
TF32_FLOPS_PER_S = 495e12
INT8_OPS_PER_S = 1979e12
SWEEP_N = 1 << 26                     # 256 MB of float32, beyond the L2
SWEEP_ITERS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
SWEEP_CHECK_ITERS = (1, 64, 1024)     # 64: the timing row's count
MLP_SHAPES = ((128, 1536, 8960), (128, 8960, 1536))   # qwen2.5-1.5b
#: the reference's choice for f32 activations at the MLP shape
#: (tests/test_torch_compute_path.py holds the port's policy to it)
POLICY_VARIANT = {"cmp-170hx": "mul_add", "cmp-170hx-nofma": "mul_add",
                  "a100-40g": "mxu", "tpu-v5e": "mxu"}
QFMTS = ("q8_0", "q6_k", "q4_k", "q2_k")
#: K9 against one f32 matmul, relative max error: mul_add sums exact f32
#: products in f32 (bf16 inputs are exact in f32); mxu runs TF32 on f32
#: inputs by design, and exact bf16 products into f32 accumulators
K9_TOL = {("mxu", "float32"): 2e-3, ("mxu", "bfloat16"): 1e-4,
          ("mul_add", "float32"): 1e-5, ("mul_add", "bfloat16"): 1e-5}


def rel_err(a, b) -> float:
    return max_err(a, b) / (float(b.float().abs().max().item()) + 1e-9)


def mlp_weights(k, n, dev):
    """A qwen2.5-1.5b-shaped MLP weight (k, n) from the seed, on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + k)
    return torch.randn(k, n, device=dev, generator=g)


def activations(m, k, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k)
    return torch.randn(m, k, device=dev, generator=g)


def phase_k8_check(dev):
    """K8 against its plain version by the rule of
    ``repro_torch.kernels.mixbench.check``: f32 mul_add and both bf16
    arms bit for bit, f32 fma <= 1e-6; on whole vectors in one pass and
    in several, a scalar tail, and an unaligned view (all scalar, in
    several passes)."""
    import torch
    from repro_torch.kernels.mixbench.check import (card_cases,
                                                   check_on_card, tolerance)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (what, x, block), variant, iters in itertools.product(
                card_cases(dtype, dev), ("fma", "mul_add"), (1, 16, 128)):
            r = check_on_card(x, iters, variant, block)
            rule = f"tol {r['tol']}" if r["tol"] else "must be bitwise"
            print(f"[K8] {variant} {dtype} {what} n={x.numel()} "
                  f"iters={iters}: max_abs_err {r['max_abs_err']:.3e} "
                  f"({rule}), bitwise {r['bitwise']}")
            if not r["ok"]:
                fail(f"K8 {variant} {dtype} {what} iters={iters}: {r}")
            worst[variant, dtype] = max(worst.get((variant, dtype), 0.0),
                                        r["max_abs_err"])
    return {f"mixbench_{v}": dict(
        max_abs_err=worst[v, torch.bfloat16],
        tol=tolerance(torch.bfloat16, v),
        max_abs_err_f32=worst[v, torch.float32],
        tol_f32=tolerance(torch.float32, v)) for v in ("fma", "mul_add")}


#: shapes of K9's check beyond the MLP ones: the reference bench's, one
#: decode row, and a ragged one the contract lets through (blocks
#: given), all on the weight stream; then rows that are not whole
#: 16-byte chunks (N = 130 in f32, not a multiple of 8 in bf16 either),
#: which go to each arm's staged kernel
K9_SHAPES = (((128, 1024, 512), {}), ((1, 1536, 8960), {}),
             ((100, 1000, 520), dict(bk=8, bn=8)))
K9_STAGED_SHAPE = ((128, 1536, 130), dict(bn=2))
#: (variant, staged) -> the counter of the kernel K9 must launch
K9_KERNEL = {("mxu", False): "fma_matmul_mxu",
             ("mxu", True): "fma_matmul_mxu_wmma",
             ("mul_add", False): "fma_matmul_mul_add",
             ("mul_add", True): "fma_matmul_mul_add_staged"}


def phase_k9_check(dev):
    """K9 against one f32 matmul (TF32 off) at the relative max errors
    of K9_TOL, f32 and bf16, both variants at the reference bench's
    shape, the MLP shapes, one decode row, a ragged shape and a shape
    whose rows are not whole 16-byte chunks; each call run twice and
    required to give the same bits (the split-K pieces are added in a
    fixed order), with the launch counters showing each arm's weight
    stream at the first five shapes and its staged kernel at the
    last."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.fma_matmul import matmul_ref, matmul_variant
    errs = {}
    shapes = [(s, {}) for s in ((128, 1024, 512),) + MLP_SHAPES]
    shapes += [sk for sk in K9_SHAPES if sk[0] != (128, 1024, 512)]
    shapes.append(K9_STAGED_SHAPE)
    for (m, k, n), blocks in shapes:
        x, w = activations(m, k, dev), mlp_weights(k, n, dev)
        for dtype, variant in itertools.product(("float32", "bfloat16"),
                                                ("mxu", "mul_add")):
            xd, wd = x.to(getattr(torch, dtype)), w.to(getattr(torch, dtype))
            ref = matmul_ref(xd, wd)
            before = launch_counts()
            out = matmul_variant(xd, wd, variant=variant, **blocks)
            again = matmul_variant(xd, wd, variant=variant, **blocks)
            torch.cuda.synchronize()
            ran = sorted(kk for kk, v in launch_counts().items()
                         if v != before[kk])
            rel = rel_err(out, ref)
            same = bool(torch.equal(out, again))
            tol = K9_TOL[variant, dtype]
            want = [K9_KERNEL[variant, (m, k, n) == K9_STAGED_SHAPE[0]]]
            print(f"[K9] {variant} {dtype} ({m},{k},{n}): rel max err "
                  f"{rel:.3e} (tol {tol}), repeat bitwise {same}, "
                  f"launched {ran}")
            if not rel <= tol:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}): {rel}")
            if not same:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}): two runs "
                     "differ")
            if ran != want:
                fail(f"K9 {variant} {dtype} ({m},{k},{n}) launched "
                     f"{ran}, want {want}")
            errs[want[0], dtype] = max(errs.get((want[0], dtype),
                                                (0.0, 0.0)),
                                       (max_err(out, ref), rel))
    return {name: dict(
        max_abs_err=errs[name, "float32"][0],
        max_rel_err=errs[name, "float32"][1], tol=K9_TOL[v, "float32"],
        max_rel_err_bf16=errs[name, "bfloat16"][1],
        tol_bf16=K9_TOL[v, "bfloat16"])
        for (v, _), name in K9_KERNEL.items()}


#: K7's check shapes (K, N, bk) beyond the MLP ones: rows of 100
#: columns are not whole 16-byte chunks (the _plain kernels); and its rows
#: M (16-row tiles up to 16, 128-row tiles beyond, two bands at 256)
K7_ODD_SHAPE = (512, 100, 512)
K7_ROWS = (1, 8, 24, 128, 256)


def phase_k7_check(dev):
    """K7: the MLP weights quantized on the card in all four formats, and
    a (512, 100) weight; dequant_dot (every format) and dot_i8 (q8_0) at
    M 1, 8, 24, 128 and 256 with float32 and bfloat16 activations,
    against their plain versions, relative max error <= 1e-5; every call
    run twice and required to give the same bits (the split-K pieces are
    added in run order), the launch counters showing the variant's
    kernel."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.qmatmul import (qmatmul_i8_ref, qmatmul_ref,
                                             qmatmul_variant)
    from repro_torch.quant import quantize
    errs = {}
    shapes = [(k, n, 512 if k % 512 == 0 else 256)     # the contract: bk | k
              for _, k, n in MLP_SHAPES] + [K7_ODD_SHAPE]
    for k, n, bk in shapes:
        w = mlp_weights(k, n, dev)
        for fmt in QFMTS:
            qt = quantize(w, fmt)
            runs = [("dequant_dot", qmatmul_ref)]
            if fmt == "q8_0":
                runs.append(("dot_i8", qmatmul_i8_ref))
            for m, dtype, (variant, plain) in itertools.product(
                    K7_ROWS, ("float32", "bfloat16"), runs):
                x = activations(m, k, dev).to(getattr(torch, dtype))
                before = launch_counts()
                out = qmatmul_variant(x, qt, variant=variant, bk=bk)
                again = qmatmul_variant(x, qt, variant=variant, bk=bk)
                ref = plain(x, qt)
                torch.cuda.synchronize()
                ran = {kk: v - before[kk] for kk, v in launch_counts().items()
                       if v != before[kk]}
                rel = rel_err(out, ref)
                same = bool(torch.equal(out, again))
                print(f"[K7] {variant} {fmt} x {dtype} ({m},{k},{n}): rel "
                      f"max err {rel:.3e} (tol 1e-05), repeat bitwise "
                      f"{same}, launched {ran}")
                if not rel <= 1e-5:
                    fail(f"K7 {variant} {fmt} x {dtype} ({m},{k},{n}): "
                         f"{rel}")
                if not same:
                    fail(f"K7 {variant} {fmt} x {dtype} ({m},{k},{n}): two "
                         "runs differ")
                if ran != {f"qmatmul_{variant}": 2}:
                    fail(f"K7 {variant} {fmt} ({m},{k},{n}) launched {ran}")
                errs[variant, dtype] = max(errs.get((variant, dtype),
                                                    (0.0, 0.0)),
                                           (max_err(out, ref), rel))
        del w
    return {f"qmatmul_{v}": dict(
        max_abs_err=errs[v, "float32"][0], max_rel_err=errs[v, "float32"][1],
        tol=1e-5, max_rel_err_bf16=errs[v, "bfloat16"][1], tol_bf16=1e-5)
        for v in ("dequant_dot", "dot_i8")}


def phase_sass():
    from repro_torch.kernels._sass import sass_report
    try:
        found, problems = sass_report()
    except FileNotFoundError as e:
        fail(str(e))
    print(f"[sass] {json.dumps(found, sort_keys=True)}")
    if problems:
        fail("SASS: " + "; ".join(problems))
    return found


def sweep(dev, reps: int = 10):
    """The measured form of the reference's ``sweep_points``: mixbench
    over SWEEP_N float32 elements, both arms in turn at each count of
    steps, timed with CUDA events (median of ``reps`` after two
    warm-ups).  The first warm-up's output at each of SWEEP_CHECK_ITERS
    is held to the plain version on the same x by the rule of phase 11
    (every thread runs many grid-stride passes here).  Then each arm's
    top point runs for about a second while ``nvidia-smi`` reads the SM
    clock and the power under that load."""
    import torch
    from repro_torch.kernels.mixbench import mixbench, mixbench_ref
    from repro_torch.kernels.mixbench.check import compare
    x = torch.rand(SWEEP_N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    points, load, checks = {}, {}, {}
    for iters in SWEEP_ITERS:
        for variant in ("fma", "mul_add"):
            y = mixbench(x, iters=iters, variant=variant)
            if iters in SWEEP_CHECK_ITERS:
                r = compare(y, mixbench_ref(x, iters, variant), variant)
                print(f"[sweep] output of {variant} at {iters} steps, n = "
                      f"2^26: max_abs_err {r['max_abs_err']:.3e}, bitwise "
                      f"{r['bitwise']} (tol {r['tol']})")
                if not r["ok"]:
                    fail(f"K8 sweep {variant} iters={iters}: {r}")
                checks[f"{variant}/{iters}"] = r["max_abs_err"]
            del y
            ms = time_ms(lambda: mixbench(x, iters=iters, variant=variant),
                         warmup=1, iters=reps)
            flops = 2.0 * iters * SWEEP_N
            points[variant, iters] = dict(
                ms=ms, gflops=flops / ms / 1e6,
                gbps=8.0 * SWEEP_N / ms / 1e6)      # 4 B read + 4 B written
    top = SWEEP_ITERS[-1]
    for variant in ("fma", "mul_add"):
        n_runs = int(1000 / points[variant, top]["ms"]) + 1
        for _ in range(n_runs):
            mixbench(x, iters=top, variant=variant)
        time.sleep(0.5)
        load[variant] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        torch.cuda.synchronize()
    return points, load, checks


def phase_compute_main(dev):
    """The compute path through its entry points, with the launch counts
    zeroed just before and read just after: the K8 sweep, ``matmul(x, w,
    policy=PathPolicy(p))`` for the four profiles and ``qmatmul(x, qt,
    profile=CMP_170HX)`` for the four formats, at the MLP width."""
    import torch
    from repro_torch.core import PROFILES, PathPolicy
    from repro_torch.core.device_profile import CMP_170HX
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fma_matmul import matmul, matmul_ref
    from repro_torch.kernels.mixbench import sweep_points
    from repro_torch.kernels.qmatmul import (qmatmul, qmatmul_i8_ref,
                                             qmatmul_ref)
    from repro_torch.core.device_profile import Path as CPath
    from repro_torch.quant import quantize
    m, k, n = MLP_SHAPES[0]
    x, w = activations(m, k, dev), mlp_weights(k, n, dev)
    qts = {fmt: quantize(w, fmt) for fmt in QFMTS}
    ref = matmul_ref(x, w)
    torch.cuda.synchronize()
    reset_launch_counts()
    points, load, checks = sweep(dev)
    for name in sorted(PROFILES):
        before = launch_counts()
        out = matmul(x, w, policy=PathPolicy(PROFILES[name]))
        torch.cuda.synchronize()
        ran = [kk for kk, v in launch_counts().items() if v != before[kk]]
        want = f"fma_matmul_{POLICY_VARIANT[name]}"
        tol = {"fma_matmul_mxu": 2e-3, "fma_matmul_mul_add": 1e-5}[want]
        rel = rel_err(out, ref)
        print(f"[policy] matmul on {name}: launched {ran} (reference: "
              f"{want}), rel max err {rel:.3e}")
        if ran != [want] or not rel <= tol:
            fail(f"matmul(policy={name}) launched {ran}, want {want}")
    for fmt, qt in qts.items():
        before = launch_counts()
        out = qmatmul(x, qt, profile=CMP_170HX)
        torch.cuda.synchronize()
        ran = [kk for kk, v in launch_counts().items() if v != before[kk]]
        want = "qmatmul_dot_i8" if fmt == "q8_0" else "qmatmul_dequant_dot"
        plain = qmatmul_i8_ref if fmt == "q8_0" else qmatmul_ref
        rel = rel_err(out, plain(x, qt))
        print(f"[policy] qmatmul {fmt} on cmp-170hx: launched {ran}, rel "
              f"max err {rel:.3e}")
        if ran != [want] or not rel <= 1e-5:
            fail(f"qmatmul({fmt}, cmp-170hx) launched {ran}, want {want}")
    counts = launch_counts()
    print(f"[compute path] launches: {counts}")
    compute = ("mixbench_fma", "mixbench_mul_add", "fma_matmul_mxu",
               "fma_matmul_mul_add", "qmatmul_dequant_dot", "qmatmul_dot_i8")
    if min(counts[kk] for kk in compute) <= 0:
        fail(f"a kernel of the compute path never launched: {counts}")

    print("[sweep] iters  fma GFLOP/s  fma GB/s  mul_add GFLOP/s  "
          "mul_add GB/s   (f32, n = 2^26, GB/s counts read + write)")
    for iters in SWEEP_ITERS:
        f, u = points["fma", iters], points["mul_add", iters]
        print(f"[sweep] {iters:5d}  {f['gflops']:11.1f}  {f['gbps']:8.1f}  "
              f"{u['gflops']:15.1f}  {u['gbps']:12.1f}")
    peak = {v: max(points[v, i]["gflops"] for i in SWEEP_ITERS) / 1e3
            for v in ("fma", "mul_add")}
    stream = max(points[v, 1]["gbps"] for v in ("fma", "mul_add")) / 1e3
    cmp = {v: max(p["gflops"] for p in sweep_points(
        CMP_170HX, "f32", CPath(v))) / 1e3 for v in ("fma", "mul_add")}
    summary = {"output_max_abs_err": checks,
               "under_load_clock_power": load,
               "peak_fma_tflops": peak["fma"],
               "peak_mul_add_tflops": peak["mul_add"],
               "fused_over_unfused": peak["fma"] / peak["mul_add"],
               "stream_tbps_iters1": stream,
               "stream_share_of_3.35": stream * 1e12 / HBM_BYTES_PER_S,
               "cmp_170hx_modeled_unfused_over_fused":
                   cmp["mul_add"] / cmp["fma"]}
    print(f"[sweep] peak f32: fma {peak['fma']:.2f} TFLOP/s, mul_add "
          f"{peak['mul_add']:.2f} TFLOP/s; fused/unfused "
          f"{summary['fused_over_unfused']:.3f} (CMP 170HX, modeled from "
          f"the paper: unfused/fused "
          f"{summary['cmp_170hx_modeled_unfused_over_fused']:.1f}); "
          f"iters=1 stream {stream:.3f} TB/s = "
          f"{100 * summary['stream_share_of_3.35']:.1f}% of 3.35; SM "
          f"clock, power at {SWEEP_ITERS[-1]} steps: {load}")
    print(f"[sweep] {json.dumps({'points': {f'{v}/{i}': p for (v, i), p in points.items()}, **summary})}")
    return counts, summary


def with_bound(r):
    """r with its bound: bytes over 3.35 TB/s against operations over
    the peak of the variant's path, whichever is longer."""
    t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
    t_ops = 1e3 * r["flops"] / r["peak"]
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return r


def k9_row(x, w, variant, peak, **blocks):
    """K9's timing row on (x, w): the kernel, the plain version and
    torch.matmul, each as device time per call; beside mxu torch.matmul
    on x and w with TF32 on, beside mul_add one float32 product with
    TF32 off (on float32 copies of bf16 inputs: the function the arm
    computes).  Bytes count x and w read once and the f32 output
    written once."""
    import torch
    from repro_torch.kernels.fma_matmul import matmul_ref, matmul_variant
    m, k = x.shape
    n = w.shape[1]
    torch.backends.cuda.matmul.allow_tf32 = variant == "mxu"
    xl, wl = (x, w) if variant == "mxu" else (x.float(), w.float())
    lib_ms = time_ms_queued(lambda: torch.matmul(xl, wl))
    torch.backends.cuda.matmul.allow_tf32 = False
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[x.dtype]
    return dict(
        ms=time_ms_queued(lambda: matmul_variant(x, w, variant=variant,
                                                 **blocks)),
        plain_ms=time_ms_queued(lambda: matmul_ref(x, w)),
        library_ms=lib_ms,
        bytes=x.element_size() * (m * k + k * n) + 4 * m * n,
        flops=2 * m * k * n, peak=peak, shape=f"{name} ({m},{k},{n})")


def phase_compute_timings(dev):
    """Each compute-path kernel and variant at full width: kernel ms,
    plain ms, library (or route) ms, and the bound: bytes over 3.35 TB/s
    against operations over the peak of the path the variant names."""
    import torch
    from repro_torch.kernels.fma_matmul import matmul_variant
    from repro_torch.kernels.mixbench import mixbench, mixbench_ref
    from repro_torch.kernels.qmatmul import (qmatmul_i8_ref, qmatmul_ref,
                                             qmatmul_variant)
    from repro_torch.quant import dequantize, quantize
    rows = {}
    # K8: f32, n = 2^26, the reference wrapper's default 64 steps (the
    # sweep held this output, on the same x, to the plain version)
    x = torch.rand(SWEEP_N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    for variant, peak in (("fma", FP32_FLOPS_PER_S),
                          ("mul_add", FP32_FLOPS_PER_S / 2)):
        rows[f"mixbench_{variant}"] = dict(
            ms=time_ms(lambda: mixbench(x, iters=64, variant=variant)),
            plain_ms=time_ms(lambda: mixbench_ref(x, 64, variant),
                             warmup=1, iters=5),
            library_ms=None, bytes=8 * SWEEP_N, flops=2 * 64 * SWEEP_N,
            peak=peak, shape="f32 n=2^26 iters=64")
    del x
    # K9, as device time per launch (time_ms_queued: through ctypes the
    # host takes ~0.04 ms to launch a call, longer than the mxu kernel
    # runs): each arm at both MLP shapes in f32 and bf16, the first f32
    # shape its row; each arm's staged kernel on rows that are not
    # whole 16-byte chunks (N - 2 columns)
    m, k, n = MLP_SHAPES[0]
    a, w = activations(m, k, dev), mlp_weights(k, n, dev)
    k9_peak = {("mxu", torch.float32): TF32_FLOPS_PER_S,
               ("mxu", torch.bfloat16): BF16_FLOPS_PER_S,
               ("mul_add", torch.float32): FP32_FLOPS_PER_S / 2,
               ("mul_add", torch.bfloat16): FP32_FLOPS_PER_S / 2}
    k9_shapes = {}
    for variant in ("mxu", "mul_add"):
        by_shape = k9_shapes[variant] = {}
        for (mm, kk, nn), dtype in itertools.product(
                MLP_SHAPES, (torch.float32, torch.bfloat16)):
            r = k9_row(activations(mm, kk, dev).to(dtype),
                       mlp_weights(kk, nn, dev).to(dtype), variant,
                       k9_peak[variant, dtype])
            by_shape[r["shape"]] = with_bound(r)
        name = f"fma_matmul_{variant}"
        rows[name] = dict(by_shape[f"f32 ({m},{k},{n})"])
        rows[name]["single_call_ms"] = time_ms(
            lambda: matmul_variant(a, w, variant=variant))
        rows[name]["by_shape"] = by_shape
    w2 = mlp_weights(k, n - 2, dev)
    rows["fma_matmul_mxu_wmma"] = k9_row(a, w2, "mxu", TF32_FLOPS_PER_S,
                                         bn=2)
    rows["fma_matmul_mul_add_staged"] = k9_row(
        a, w2, "mul_add", FP32_FLOPS_PER_S / 2, bn=2)
    del w2
    # K7, as device time per call: dequant_dot q4_k (the paper's Q4_K_M)
    # and dot_i8 q8_0 at both MLP shapes, M 128 and 8, f32 and bf16 x,
    # the first f32 shape each variant's row; there every format's
    # dequant_dot too.  No single PyTorch call computes a block-quantized
    # product, so the route (dequantize, then torch.matmul with TF32 off)
    # stands beside each as route_ms.  Bound: f32 products at the TF32
    # rule (as K10's), one bf16 pass at the bf16 rate, int8 at the int8
    # rate.
    k7_shapes = {}
    k7_peak = {("dequant_dot", torch.float32): TF32_FLOPS_PER_S,
               ("dequant_dot", torch.bfloat16): BF16_FLOPS_PER_S,
               ("dot_i8", torch.float32): INT8_OPS_PER_S,
               ("dot_i8", torch.bfloat16): INT8_OPS_PER_S}
    per_fmt = {}
    for (_, kk, nn), mm in itertools.product(MLP_SHAPES, (128, 8)):
        wq = mlp_weights(kk, nn, dev)
        bk = 512 if kk % 512 == 0 else 256     # the contract: bk | k
        qts = {fmt: quantize(wq, fmt) for fmt in QFMTS}
        for dtype in (torch.float32, torch.bfloat16):
            xq = activations(mm, kk, dev).to(dtype)
            tag = (f"{'f32' if dtype == torch.float32 else 'bf16'} "
                   f"({mm},{kk},{nn})")
            main = tag == f"f32 ({m},{k},{n})"
            for variant, fmt, plain in (
                    ("dequant_dot", "q4_k", qmatmul_ref),
                    ("dot_i8", "q8_0", qmatmul_i8_ref)):
                qt = qts[fmt]
                r = dict(
                    ms=time_ms_queued(lambda: qmatmul_variant(
                        xq, qt, variant=variant, bk=bk)),
                    plain_ms=time_ms_queued(lambda: plain(xq, qt)),
                    library_ms=None,
                    route_ms=time_ms_queued(lambda: xq.float() @
                                            dequantize(qt)),
                    bytes=xq.element_size() * mm * kk + 4 * mm * nn
                    + qt.nbytes(),
                    flops=2 * mm * kk * nn, peak=k7_peak[variant, dtype],
                    shape=f"{tag} {fmt}")
                k7_shapes.setdefault(variant, {})[tag] = with_bound(r)
            if main:
                for fmt in QFMTS:
                    per_fmt[fmt] = time_ms_queued(lambda: qmatmul_variant(
                        xq, qts[fmt], variant="dequant_dot", bk=bk))
        del wq, qts
    for variant, by_shape in k7_shapes.items():
        rows[f"qmatmul_{variant}"] = dict(by_shape[f"f32 ({m},{k},{n})"])
        rows[f"qmatmul_{variant}"]["by_shape"] = by_shape
    rows["qmatmul_dequant_dot"]["ms_by_format"] = per_fmt
    for name, r in rows.items():
        with_bound(r)
        lib = r["library_ms"]
        route = (f", dequantize + torch.matmul {r['route_ms']:.4f} ms"
                 if "route_ms" in r else "")
        print(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}{route}, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B, "
              f"{r['flops']} flop at {r['peak'] / 1e12:.2f} T/s)")
    for variant, by_shape in k9_shapes.items():
        for shape, r in by_shape.items():
            print(f"[time] fma_matmul_{variant} {shape}: kernel "
                  f"{r['ms']:.4f} ms = {r['bytes'] / r['ms'] / 1e9:.3f} "
                  f"TB/s, {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); torch.matmul "
                  f"{r['library_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms")
        print(f"[time] fma_matmul_{variant} f32 ({m},{k},{n}) one call at "
              "a time (host launch included): "
              f"{rows[f'fma_matmul_{variant}']['single_call_ms']:.4f} ms")
    for variant, by_shape in k7_shapes.items():
        for shape, r in by_shape.items():
            print(f"[time] qmatmul_{variant} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms = {r['bytes'] / r['ms'] / 1e9:.3f} TB/s,"
                  f" {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); route "
                  f"{r['route_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms")
    print("[time] qmatmul_dequant_dot f32 ({},{},{}) by format: {}".format(
        m, k, n, ", ".join(f"{f} {v:.4f} ms" for f, v in per_fmt.items())))
    return rows


# ----------------------------------------------------------------------
# the SSM family: K10 (the SSD chunk scan), mamba2 served and forward
# ----------------------------------------------------------------------

#: mamba2-780m's SSD widths: heads (d_inner / head_dim), head dim, state
#: width, chunk
SSD_H, SSD_P, SSD_N, SSD_Q = 48, 64, 128, 256
#: K10 against its plain version, relative max error (max |diff| / max
#: |plain|) on each output: the two cumsums add in other orders, and
#: exp carries the f32 rounding of segment sums up to ~100 into y
#: (measured <= 3.2e-6 on an H100 80GB HBM3 at 700 W)
K10_TOL = 1e-5
#: float32 forward (chunked dual form on K10) against streaming the same
#: tokens through the decode recurrence, max |diff| of the logits: the
#: two forms of one function sum in other orders through 48 layers;
#: measured 3.97e-5 against logits up to 3.9 on an H100 80GB HBM3 at
#: 700 W, so 2.5x headroom
SSM_FWD_TOL = 1e-4


#: SMOKE mamba2's SSD widths (d_inner 256 / head_dim 32): heads, head
#: dim, state width, chunk
SMOKE_SSD = (8, 32, 16, 32)
#: (H, P, N) whose rows are no whole 16-byte chunks in either dtype
ODD_SSD = (3, 30, 20)
#: hymba-1.5b's SSD widths (d_inner 3200 / head_dim 64): heads, head
#: dim, state width -- N 16, a quarter of the kernel's 64-row state tile
HYMBA_SSD = (50, 64, 16)


def k10_inputs(bsz, s, dtype, a_kind, dev, seed=SEED,
               widths=(SSD_H, SSD_P, SSD_N)):
    """x (B,S,H,P), dt = softplus(randn + dt_bias), A (H,), b/c (B,S,N)
    from the seed on the card, at ``widths`` (H, P, N), mamba2-780m's by
    default; x/b/c in ``dtype``."""
    import math
    import torch
    h, p, n = widths
    g = torch.Generator(device=dev).manual_seed(seed + 31 * s + bsz)
    x = torch.randn(bsz, s, h, p, device=dev, generator=g)
    dt_bias = math.log(math.expm1(0.01))
    dt = torch.logaddexp(torch.randn(bsz, s, h, device=dev, generator=g)
                         + dt_bias, torch.zeros((), device=dev))
    if a_kind == "model":
        a = -torch.linspace(1.0, 16.0, h, device=dev)
    else:
        a = -torch.exp(0.3 * torch.randn(h, device=dev, generator=g))
    b = torch.randn(bsz, s, n, device=dev, generator=g)
    c = torch.randn(bsz, s, n, device=dev, generator=g)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def k10_cases():
    """(dtype name, S, B, A kind, chunk, widths) of K10's checks: the
    forward's and the serve's lengths at mamba2-780m's widths, each serve
    bucket as the one chunk of a prompt, SMOKE's widths, odd widths at a
    ragged chunk, the longest chunk (1024), and hymba-1.5b's widths at
    its serve's buckets 256, 1024 and 2048."""
    full = (SSD_H, SSD_P, SSD_N)
    cases = [(d, s, bsz, a_kind, SSD_Q, full) for d, s, bsz, a_kind in
             itertools.product(("float32", "bfloat16"), (64, 256, 1024, 2048),
                               (1, 2), ("model", "exp"))]
    cases += [(d, q, 1, "model", SSD_Q, full)
              for d in ("float32", "bfloat16") for q in (8, 16, 32, 128)]
    h, p, n, q = SMOKE_SSD
    cases += [(d, s, 2, a_kind, q, (h, p, n))
              for d in ("float32", "bfloat16") for s in (8, 32, 128)
              for a_kind in ("model", "exp")]
    # rows of no whole 16-byte chunk (the kernel's plain-copy staging) at
    # a ragged chunk, and the longest chunk
    cases += [(d, s, bsz, "model", q, widths)
              for d in ("float32", "bfloat16")
              for s, bsz, q, widths in ((100, 2, 50, ODD_SSD),
                                        (2048, 1, 1024, full))]
    cases += [(d, s, 1, "model", SSD_Q, HYMBA_SSD)
              for d in ("float32", "bfloat16") for s in (256, 1024, 2048)]
    return cases


def phase_k10(dev):
    import torch
    from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk, ssd_chunk_ref,
                                              ssd_chunked)
    worst = {}
    for dname, s, bsz, a_kind, chunk, widths in k10_cases():
        dtype = getattr(torch, dname)
        args = k10_inputs(bsz, s, dtype, a_kind, dev, widths=widths)
        out = ssd_chunk(*args, chunk=chunk)
        ref = ssd_chunk_ref(*args, chunk)
        torch.cuda.synchronize()
        rels = [rel_err(o, r) for o, r in zip(out, ref)]
        ok = all(bool(torch.isfinite(o).all()) for o in out)
        tag = (f"{dtype} S={s} B={bsz} A={a_kind} Q={min(chunk, s)} "
               f"(H, P, N)={widths}")
        print(f"[K10] {tag}: rel max err y {rels[0]:.3e} states "
              f"{rels[1]:.3e} decay {rels[2]:.3e} (tol {K10_TOL})")
        if not ok or not max(rels) <= K10_TOL:
            fail(f"K10 {tag}: {rels}")
        key = str(dtype).split(".")[-1]
        abs_err = max(max_err(o, r) for o, r in zip(out, ref))
        for k in (key, key + " hymba") if widths == HYMBA_SSD else (key,):
            prev = worst.get(k, (0.0, 0.0))
            worst[k] = (max(prev[0], abs_err), max(prev[1], max(rels)))
    args = k10_inputs(1, 2048, torch.float32, "model", dev)
    y = ssd(*args, chunk=SSD_Q)
    rel = rel_err(y, ssd_chunked(*args, chunk=SSD_Q))
    torch.cuda.synchronize()
    print(f"[K10] full SSD on K10 vs ssd_chunked, float32 S=2048: rel max "
          f"err {rel:.3e} (tol {K10_TOL})")
    if not rel <= K10_TOL:
        fail(f"ssd on K10 disagrees with ssd_chunked: {rel}")
    return dict(max_abs_err=worst["bfloat16"][0],
                max_rel_err=worst["bfloat16"][1], tol=K10_TOL,
                max_abs_err_f32=worst["float32"][0],
                max_rel_err_f32=worst["float32"][1], tol_f32=K10_TOL,
                max_rel_err_hymba=worst["bfloat16 hymba"][1],
                max_rel_err_hymba_f32=worst["float32 hymba"][1],
                ssd_rel_err=rel)


def init_mamba(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[mamba2] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def lane_kv(eng, lane, n):
    """Clones of the K/V in ring slots ``[0, n)`` of a lane (a hybrid's;
    empty for ssm): dense, of its row; paged, of its mapped pages in
    table order."""
    import torch
    if not eng.paged:
        return {k: eng.cache[k][:, lane, :, :n].clone() for k in eng.cache
                if k in ("k", "v", "k_scale", "v_scale")}
    if not eng.lane_pages(lane):
        return {}
    pages = torch.tensor(eng.lane_pages(lane), device=eng.device)
    out = {}
    for k in eng.cache:
        if k.endswith("_pages"):
            g = eng.cache[k][:, pages]            # (L, T', Hkv, ps, D)
            g = g.permute(0, 2, 1, 3, 4).flatten(2, 3)
            out[k] = g[:, :, :n].clone()
    return out


def check_stream(eng, tag, prompt, streamed):
    """Stream ``prompt`` into a free lane through the engine (replays of
    its captured batch-1 step) and eagerly (``model.decode_step`` on a
    fresh batch-1 cache, token by token, as the engine streamed before
    its step was captured): the logits at the last token, the state and
    a hybrid's K/V must be equal bit for bit.  A paged hybrid lane maps
    its pages first (and they are zeroed before the eager stream, which
    writes them through the same table row).  ``streamed`` is the list
    the engine's first-token logits are appended to.  Leaves the lane
    dead; returns host ms per token, synced, of each."""
    import numpy as np
    import torch
    lane = eng.free_lanes()[0]
    n = len(prompt)
    if eng.paged and eng._bt_width:
        need = eng._pages_needed(n + 1)
        if not eng.pool.reserve(need):
            fail(f"{tag}: no pages free for the stream check")
        eng._lane_reserved[lane] = need
        eng._map_pages(lane, need)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._stream_ssm_prompt(prompt, lane)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    take = min(n, eng.cache["k"].shape[3]) if "k" in eng.cache else n
    got = {k: eng.cache[k][:, lane].clone() for k in ("ssm_h", "ssm_conv")}
    got.update(lane_kv(eng, lane, take), logits=streamed[-1])
    state = {}
    for key, t in eng._stream_lane.items():
        if key.endswith("_pages"):
            state[key] = t                          # the shared pools
        elif key == "block_tables":
            state[key] = eng.cache[key][lane:lane + 1].clone()
        else:
            state[key] = torch.zeros_like(t)
    if "block_tables" in state:
        pages = torch.tensor(eng.lane_pages(lane), device=eng.device)
        for key in state:
            if key.endswith("_pages"):
                state[key][:, pages] = 0
    toks = torch.from_numpy(prompt.astype(np.int32)).to(eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits, state = eng.model.decode_step(eng.params, state,
                                              toks[t:t + 1])
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    want = {k: state[k][:, 0] for k in ("ssm_h", "ssm_conv")}
    if eng.paged:
        want.update(lane_kv(eng, lane, take))
    else:
        want.update({k: state[k][:, 0, :, :take] for k in state
                     if k in ("k", "v", "k_scale", "v_scale")})
    want["logits"] = logits.float()
    differ = [k for k in sorted(want) if not torch.equal(got[k], want[k])]
    if differ or sorted(got) != sorted(want):
        fail(f"{tag}: the replayed prompt stream differs from the eager "
             f"one in {differ or sorted(set(got) ^ set(want))}")
    eng._release_lane(lane)
    per_tok = {"stream_ms_per_token_eager": 1e3 * t_eager / n,
               "stream_ms_per_token_graph": 1e3 * t_graph / n,
               "stream_check_tokens": n}
    print(f"[{tag}] {n} prompt tokens streamed into lane {lane}: replayed "
          f"step == eager decode_step bitwise ({', '.join(sorted(want))}); "
          f"host ms per token, synced: eager "
          f"{per_tok['stream_ms_per_token_eager']:.3f}, replayed "
          f"{per_tok['stream_ms_per_token_graph']:.3f}")
    return per_tok


def serve_streamed(dev, cfg, params, tag, reqs, gen, max_len, **engine_kw):
    """Serve ``reqs`` (``gen`` new tokens each, 4 lanes) through an engine
    whose prompts are streamed (ssm or hybrid), with the launch counts
    zeroed just before and read just after; K10 must launch once a layer
    a prompt, and for a hybrid K2's tensor-core kernel too, and K3
    (fixed-lane) or K1 (paged) once a layer a decode step beside once a
    layer a streamed prompt token (replay accounting).  Also holds, for
    each prompt, the prefill's logits at ``plen - 1`` (the chunked scan
    on K10) beside the streamed logits that give the first token (the
    recurrent path), and streams 64 prompt tokens by replays and
    eagerly (:func:`check_stream`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, n_lanes=4, max_len=max_len, device=dev,
                      timed=True, **engine_kw)
    pairs = {"prefill": [], "stream": [], "prefill_s": []}
    run, first = eng.graphs.run, eng._set_first_token

    def keep_prefill(key, fn):            # K10's logits at plen - 1
        if not (isinstance(key, tuple) and key[0] == "prefill"):
            return run(key, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, made = run(key, fn)          # the graph, or its capture
        torch.cuda.synchronize()
        capture = eng.graphs.capture_s[key] if made else 0.0
        pairs["prefill_s"].append(time.perf_counter() - t0 - capture)
        pairs["prefill"].append(out[0].float().clone())
        return out, made

    def keep_stream(logits, lane):        # the streamed logits
        pairs["stream"].append(logits.float().clone())
        return first(logits, lane)

    eng.graphs.run, eng._set_first_token = keep_prefill, keep_stream
    checked = {}
    check_replay_midway(eng, tag, checked)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_gen = sum(len(r.generated) for r in reqs)
    if not all(r.done and len(r.generated) == gen for r in reqs):
        fail(f"{tag}: did not finish every request's budget")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: generated token outside the vocabulary")
    per_prompt = {"ssd_chunk": cfg.n_layers}
    if not cfg.attn_free:
        per_prompt["flash_attention_mma"] = cfg.n_layers
    for name, per in per_prompt.items():
        if counts[name] != per * len(reqs):
            fail(f"{tag}: {name} launched {counts[name]} times, not {per} x "
                 f"{len(reqs)} prompts")
    plens = [len(r.prompt) for r in reqs]
    streamed = sum(min(p, max_len - 1) for p in plens)
    per_step = None
    if not cfg.attn_free:
        kernel = ("decode_attention_paged" if eng.paged else
                  "decode_attention_lengthaware")
        per_step = ((counts[kernel] - cfg.n_layers * streamed)
                    / eng.stats["decode_steps"])
        print(f"[{tag}] {kernel} launches {counts[kernel]} = {per_step} a "
              f"decode step x {eng.stats['decode_steps']} + "
              f"{cfg.n_layers} a streamed token x {streamed}")
        if per_step != cfg.n_layers:
            fail(f"{tag}: {kernel} launched {per_step} times a decode "
                 f"step, not {cfg.n_layers}")
    if eng.paged:
        eng.pool.check()
        if cfg.attn_free and (eng.pool.n_pages != 0 or
                              "block_tables" in eng.cache):
            fail(f"{tag}: an attention-free paged engine holds pages")
    stream = list(eng.timings["ssm_stream"])   # the serve's prompts
    graphs = graph_summary(eng, tag, checked.get("check"))
    graphs["stream_replays"] = stream_gate(eng, tag, reqs)
    graphs.update(check_stream(eng, tag, reqs[-1].prompt[:64],
                               pairs["stream"]))
    v = cfg.vocab_size
    diffs = [max_err(a[:, :v], b[:, :v])
             for a, b in zip(pairs["prefill"], pairs["stream"])]
    agree = sum(int(a[:, :v].argmax()) == int(b[:, :v].argmax())
                for a, b in zip(pairs["prefill"], pairs["stream"]))
    pre, dec = eng.timings["prefill"], eng.timings["decode"]
    print(f"[{tag}] {len(reqs)} requests (prompts {plens}), {n_gen} tokens "
          f"in {wall:.3f}s = {n_gen / wall:.1f} tok/s end to end; stats "
          f"{dict(eng.stats)}")
    for bucket in sorted(pre):
        print(f"[{tag}] prefill bucket {bucket}: {len(pre[bucket])} "
              f"prompts, median {1e3 * statistics.median(pre[bucket]):.2f} "
              f"ms (chunked scan + prompt streaming)")
    print(f"[{tag}] chunked prefill (K10's path) ms per prompt: "
          f"{[round(1e3 * t, 2) for t in pairs['prefill_s']]}")
    print(f"[{tag}] prompt streaming ms per prompt: "
          f"{[round(1e3 * t, 2) for t in stream]} "
          f"({1e3 * sum(stream) / streamed:.3f} ms per prompt token)")
    print(f"[{tag}] decode: {len(dec)} dispatches, median "
          f"{1e3 * statistics.median(dec):.2f} ms per dispatch "
          f"({eng.dispatch_n} steps x {eng.n_lanes} lanes max)")
    print(f"[{tag}] K10 launches {counts['ssd_chunk']} = {cfg.n_layers} x "
          f"{len(reqs)} prompts; launches: {counts}")
    print_graphs(tag, graphs)
    print(f"[{tag}] prefill (K10) vs streamed logits at plen - 1, bf16: "
          f"max |diff| per prompt {[round(d, 4) for d in diffs]}, argmax "
          f"agrees {agree}/{len(diffs)} (no gate in bf16: the prefill conv "
          f"rounds in bf16, the decode conv in f32)")
    summary = {"tok_s": n_gen / wall, "wall_s": wall,
               "prefill_ms": {b: 1e3 * statistics.median(t)
                              for b, t in pre.items()},
               "chunked_prefill_ms_per_prompt": [1e3 * t for t in
                                                 pairs["prefill_s"]],
               "stream_ms_per_prompt": [1e3 * t for t in stream],
               "stream_ms_per_token": 1e3 * sum(stream) / streamed,
               "decode_ms_per_dispatch": 1e3 * statistics.median(dec),
               "n_dispatches": len(dec), "plens": plens, "graphs": graphs,
               "decode_launches_per_step": per_step,
               "prefill_vs_stream_max_abs": diffs,
               "prefill_vs_stream_argmax_agree": agree}
    del eng                     # the check's wrapper holds a cycle to it
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def serve_mamba(dev, cfg, params, tag, which, **engine_kw):
    """Serve the full-width ssm requests numbered ``which`` (prompts
    64-512 from seed 2: 440, 181 and 113 tokens) and then a prompt of
    ``MAMBA_REPLAY_PLEN`` tokens in 113's bucket, so that a prefill
    graph replays (32 new tokens, 4 lanes, max_len 1024) through
    :func:`serve_streamed`; K10 must launch 48 times per prompt.  Prompt
    streaming cost ~29-50 ms per token at this depth on an H100 as eager
    decode steps (host-bound), so the serve was cut to a few requests to
    keep these phases near a minute; it now replays a captured step."""
    import numpy as np
    from repro_torch.serving import Request
    reqs = _requests(cfg, 3, 64, 512, 32, SEED + 2)
    prompt = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, MAMBA_REPLAY_PLEN).astype(np.int32)
    again = Request(uid=len(reqs), prompt=prompt, max_new_tokens=32)
    return serve_streamed(dev, cfg, params, tag,
                          [reqs[i] for i in which] + [again], 32, 1024,
                          **engine_kw)


#: the full-width mamba2 serves' last prompt: bucket 128, as the 113
#: tokens of their last seeded prompt, so its prefill replays that graph
MAMBA_REPLAY_PLEN = 120


#: the full-width hymba serve's prompt lengths: one in the 128 bucket,
#: two in the 1024 bucket (1000 + 64 new tokens decodes across position
#: 1024, the window's last slot), and one past the window (1100: the
#: ring has wrapped before the first decode step)
HYMBA_PLENS = (96, 700, 1000, 1100)


def init_hymba(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[hymba] {cfg.name} bf16, {n_params / 1e9:.3f}B params "
          f"initialised in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve_hymba(dev, cfg, params, tag, **engine_kw):
    """Serve hymba-1.5b at full width (``HYMBA_PLENS`` prompts from the
    seed, 64 new tokens, 4 lanes, max_len 2048: a ring of the window's
    1024 slots, or its 64 pages of 16) through :func:`serve_streamed`,
    which gates K2, K10 and K3/K1's launches, the replayed dispatch and
    the replayed stream."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED + 6)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n
                                               ).astype(np.int32),
                    max_new_tokens=64) for i, n in enumerate(HYMBA_PLENS)]
    return serve_streamed(dev, cfg, params, tag, reqs, 64, 2048, **engine_kw)


def phase_ssm_forward(dev, cfg, params):
    """``build_model(cfg).forward`` at full width: bf16 at B 1, S 2048
    (timed, 48 K10 launches, finite logits); then in float32 (the same
    weights, upcast) every position of a 512-token prompt against the
    logits of streaming it through ``lm_decode_step`` from a fresh
    cache, which never runs K10."""
    import dataclasses
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.transformer import LM
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device=dev,
                           generator=g, dtype=torch.int32)
    model.forward(params, tokens)                     # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.forward(params, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        k10 = launch_counts()["ssd_chunk"]
        if k10 != cfg.n_layers:
            fail(f"forward launched K10 {k10} times, not {cfg.n_layers}")
    v = cfg.vocab_size
    if logits.shape != (1, 2048, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :v]).all()):
        fail("full-width forward logits are not finite of the right shape")
    fwd_ms = 1e3 * statistics.median(times)
    del logits
    # the device's busy time in the same call, by kernel (torch.profiler):
    # the call issues thousands of eager launches, more than a stream
    # queues behind a busy-wait, so CUDA events around it would count
    # the host's gaps
    from repro_torch.kernels.breakdown import kernel_ms
    by_kernel = kernel_ms(lambda: model.forward(params, tokens), reps=3)
    busy_ms = sum(by_kernel.values())
    k10_ms = sum(v for name, v in by_kernel.items() if "ssd_c" in name)
    print(f"[mamba2 forward] bf16 B=1 S=2048: median {fwd_ms:.2f} ms over "
          f"3 runs ({[round(1e3 * t, 2) for t in times]}) on the host "
          f"clock; device busy {busy_ms:.2f} ms a call, {k10_ms:.2f} of "
          f"it in K10's kernels; K10 launches {k10}, logits finite")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = LM(cfg32, dev)
    p32.load_state_dict(params.state_dict())          # upcast copies
    model32 = build_model(cfg32)
    prompt = tokens[:, :512]
    reset_launch_counts()
    full = model32.forward(p32, prompt)[0, :, :v]
    torch.cuda.synchronize()
    k10_32 = launch_counts()["ssd_chunk"]
    cache = model32.init_cache(1, 1024, device=dev)
    t0 = time.perf_counter()
    streamed = []
    for t in range(prompt.shape[1]):
        step_logits, cache = model32.decode_step(p32, cache, prompt[:, t])
        streamed.append(step_logits[0, :v])
    streamed = torch.stack(streamed)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    diff = max_err(full, streamed)
    scale = float(streamed.abs().max().item())
    agree = int((full.argmax(-1) == streamed.argmax(-1)).sum().item())
    print(f"[mamba2 forward] float32, 512 tokens (2 chunks), K10 launches "
          f"{k10_32}: forward vs streamed logits at every position: max "
          f"|diff| {diff:.3e} (max |logit| {scale:.3f}; tol "
          f"{SSM_FWD_TOL}), argmax agrees {agree}/512; streaming took "
          f"{stream_s:.2f}s")
    if k10_32 != cfg.n_layers:
        fail(f"float32 forward launched K10 {k10_32} times")
    if not diff <= SSM_FWD_TOL:
        fail(f"forward (chunked, K10) and streamed (recurrent) logits "
             f"differ by {diff}")
    del p32, model32, cache
    torch.cuda.empty_cache()
    return {"forward_bf16_s2048_ms": fwd_ms,
            "forward_bf16_s2048_runs_ms": [1e3 * t for t in times],
            "forward_bf16_s2048_busy_ms": busy_ms,
            "forward_bf16_s2048_k10_busy_ms": k10_ms,
            "fp32_forward_vs_stream_max_abs": diff,
            "fp32_max_abs_logit": scale,
            "fp32_argmax_agree_of_512": agree,
            "fp32_forward_k10_launches": k10_32,
            "fp32_stream_512_s": stream_s}


def phase_hymba_timings(dev):
    """The kernels of hymba-1.5b's path at its shapes, as device time per
    call (``time_ms_queued``) beside their plain versions, one PyTorch
    call where one computes the function, and the bound: K2 bf16 at B 1,
    H 25 over Hkv 5, D 64, window 1024, Sq 2048 (the 1100-token prompt's
    bucket; beside SDPA with the window as a boolean mask) and Sq 1024;
    K3, K1, K5 and K4 at ``HYMBA_DECODE`` (bf16 q; int8 with per-token
    scales; K1 beside its pages gathered then SDPA, the int8 kernels
    beside the dequantize route); K10 bf16 at (1, 2048, 50, 64), N 16,
    chunk 256, and at S 1024."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    rows = {}
    win = 1024

    def k2(sq):
        q, k, v = k2_inputs(sq, torch.bfloat16, dev, 64, 25, 5)
        i = torch.arange(sq, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
        pairs = int(mask.sum().item())
        return with_bound(dict(
            ms=time_ms_queued(lambda: flash_attention(q, k, v, causal=True,
                                                      window=win)),
            plain_ms=time_ms_queued(lambda: attention_ref(
                q, k, v, causal=True, window=win)),
            library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
            flops=4 * 25 * pairs * 64, peak=BF16_FLOPS_PER_S,
            shape=f"bf16 B 1 H 25 Hkv 5 Sq {sq} D 64 window {win}"))

    rows["flash_attention_mma"] = k2(2048)
    rows["flash_attention_mma"]["s1024"] = k2(1024)
    q, kp, vp, bt, lens, k, v = hymba_decode_inputs(torch.bfloat16, dev)
    b, hkv, s, d = k.shape
    h = q.shape[1]
    n_live = int(lens.to(torch.int64).sum().item())
    ps = kp.shape[2]
    pages_live = int(((lens.to(torch.int64) + ps - 1) // ps).sum().item())
    io_bytes = 2 * q.numel() * 2 + 4 * lens.numel()
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :].contiguous()
    ql = q[:, :, None].contiguous()
    shape = (f"bf16 q, B 4 H 25 Hkv 5 D 64, S 1024 ring, lengths "
             f"{lens.tolist()}")
    rows["decode_attention_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention(q, k, v, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_ref(q, k, v,
                                                             lens)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, k, v, attn_mask=mask, enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S, shape=shape))
    rows["decode_attention_paged"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged(q, kp, vp, bt,
                                                         lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_ref(
            q, kp, vp, bt, lens)),
        library_ms=None,
        gather_sdpa_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt), gather_pages(vp, bt), attn_mask=mask,
            enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16"))
    kq, ks = quantize_kv_q8(kp.float(), 1)
    vq, vs = quantize_kv_q8(vp.float(), 1)
    gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
    row_bytes = hkv * (2 * d + 2 * 4)       # int8 k and v, f32 k/v scales
    rows["decode_attention_q8_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_q8(q, *gq, lens,
                                                      qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_q8_ref(
            q, *gq, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_dense(q, *gq, lens, 1)),
        bytes=n_live * row_bytes + io_bytes,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S, shape=shape + ", int8 per-token scales"))
    rows["decode_attention_paged_q8"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_paged(q, kq, ks, vq, vs, bt,
                                                     lens, 1)),
        bytes=n_live * row_bytes + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16, int8 per-token scales"))
    hh, pp, nn = HYMBA_SSD

    def k10(sq):
        args = k10_inputs(1, sq, torch.bfloat16, "model", dev,
                          widths=HYMBA_SSD)
        nc, tri = sq // SSD_Q, SSD_Q * (SSD_Q + 1) // 2
        flops = (2 * nc * tri * nn
                 + 2 * nc * hh * (tri * pp + SSD_Q * nn * pp))
        out_bytes = 4 * (args[0].numel() + nc * hh * (nn * pp + 1))
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        return with_bound(dict(
            ms=time_ms_queued(lambda: ssd_chunk(*args, chunk=SSD_Q)),
            plain_ms=time_ms_queued(lambda: ssd_chunk_ref(*args, SSD_Q)),
            library_ms=None, bytes=in_bytes + out_bytes, flops=flops,
            peak=TF32_FLOPS_PER_S,
            shape=f"bf16 x/b/c (1,{sq},50,64) N 16 chunk 256"))

    rows["ssd_chunk"] = k10(2048)
    rows["ssd_chunk"]["s1024"] = k10(1024)
    for name, r in rows.items():
        for rr in (r, r.get("s1024")):
            if rr is None:
                continue
            lib = rr["library_ms"]
            extra = "".join(f", {k} {rr[k]:.4f} ms" for k in
                            ("route_ms", "gather_sdpa_ms") if k in rr)
            print(f"[time hymba] {name} ({rr['shape']}): kernel "
                  f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, "
                  f"library {'n/a' if lib is None else f'{lib:.4f} ms'}"
                  f"{extra}, bound {rr['bound_ms']:.5f} ms "
                  f"({rr['bound_by']}: {rr['bytes']} B, {rr['flops']} flop)")
    return rows


def k10_timing(dev):
    """K10 at (1, 1024, 48, 64), N 128, chunk 256, bf16 x/b/c: kernel and
    plain ms as device time per call (``time_ms_queued``) beside the
    bound.  Operations: the multiply-adds the
    function needs -- C.B over each chunk's lower triangle once per
    (b, z) (B and C are shared by the heads), per head the triangle's
    products with dt*x and the N x P boundary state -- over the 495
    TFLOP/s TF32 peak, as for K7's f32 dot; bytes: every input read once
    and every output written once."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    bsz, s = 1, 1024
    args = k10_inputs(bsz, s, torch.bfloat16, "model", dev)
    x, dt, a, b, c = args
    nc, tri = s // SSD_Q, SSD_Q * (SSD_Q + 1) // 2
    flops = (2 * bsz * nc * tri * SSD_N
             + 2 * bsz * nc * SSD_H * (tri * SSD_P + SSD_Q * SSD_N * SSD_P))
    out_bytes = 4 * (x.numel() + bsz * nc * SSD_H * (SSD_N * SSD_P + 1))
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    r = dict(ms=time_ms_queued(lambda: ssd_chunk(*args, chunk=SSD_Q)),
             plain_ms=time_ms_queued(lambda: ssd_chunk_ref(*args, SSD_Q)),
             library_ms=None, bytes=in_bytes + out_bytes, flops=flops,
             shape="bf16 x/b/c (1,1024,48,64) N 128 chunk 256")
    t_bytes = 1e3 * r["bytes"] / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / TF32_FLOPS_PER_S
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    # the forward phase's length, 8 chunks: K10's share of that forward
    long_args = k10_inputs(1, 2048, torch.bfloat16, "model", dev)
    r["ms_s2048"] = time_ms_queued(
        lambda: ssd_chunk(*long_args, chunk=SSD_Q))
    print(f"[time] ssd_chunk at S=2048: kernel {r['ms_s2048']:.4f} ms")
    print(f"[time] ssd_chunk ({r['shape']}): kernel {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.2f} TFLOP/s of the needed work), "
          f"plain {r['plain_ms']:.4f} ms, library n/a (no single call), "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} B "
          f"= {t_bytes:.5f} ms, {flops} flop at 495 T/s = {t_ops:.5f} ms)")
    return r


# ----------------------------------------------------------------------
# the rest of the dense family: olmo-1b, mistral-nemo-12b, qwen2.5-32b
# ----------------------------------------------------------------------

#: full-width serves of the dense family's new configs: GQA group 1
#: (olmo-1b, MHA), 4 (mistral-nemo-12b) and 5 (qwen2.5-32b), D 128 each;
#: (requests, new tokens, lanes, layouts) per config, prompts 64-700
FAMILY_SERVES = {"olmo-1b": (16, 64, 8, ("fixed-lane", "paged")),
                 "mistral-nemo-12b": (8, 64, 8, ("fixed-lane", "paged")),
                 "qwen2.5-32b": (4, 32, 4, ("paged",)),
                 # ~57.8 GB of bf16 weights: every step reads all 64
                 # experts (the reference's dispatch), >= 16 ms a step;
                 # paged only, as qwen2.5-32b (phase 25 holds K3 at its
                 # shapes)
                 "moonshot-v1-16b-a3b": (8, 32, 8, ("paged",)),
                 # D 96: K2's tensor-core kernel on its prefill
                 "phi-3-vision-4.2b": (8, 64, 8, ("fixed-lane", "paged"))}
#: decode lengths of the kernel checks and timings at each config's
#: shapes: a dead lane, lengths across page and chunk edges, a full lane
FAMILY_LENS = {8: (0, 1, 15, 16, 17, 300, 777, 1024), 4: (0, 64, 700, 1024)}


def family_decode_inputs(arch, dtype, dev, ps=16, s=1024):
    """q (B, H, 128), pools (B * T + 1, Hkv, ps, 128) through a shuffled
    table (B, T) of disjoint pages, the lengths, and the lanes' caches
    gathered from the pools (B, Hkv, S, 128), at ``arch``'s heads and
    serve's lanes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import gather_pages
    cfg = get_config(arch)
    b = FAMILY_SERVES[arch][2]
    t = s // ps
    rng = np.random.default_rng(SEED + 11 + cfg.n_heads)
    q = torch.from_numpy(rng.standard_normal((b, cfg.n_heads, cfg.hd),
                                             np.float32))
    pools = [torch.from_numpy(rng.standard_normal(
        (b * t + 1, cfg.n_kv_heads, ps, cfg.hd), np.float32))
        for _ in range(2)]
    bt = torch.from_numpy(rng.permutation(b * t + 1)[:b * t]
                          .reshape(b, t).astype(np.int32)).to(dev)
    lens = torch.tensor(FAMILY_LENS[b], dtype=torch.int32, device=dev)
    q, kp, vp = (x.to(dev, dtype) for x in [q] + pools)
    return q, kp, vp, bt, lens, gather_pages(kp, bt), gather_pages(vp, bt)


#: the most K2's bf16 output may be scaled against its float32 reference
#: (least squares over the whole output): the relative rounding of one
#: bf16 weight, 2^-9
K2_SCALE_TOL = 2.0 ** -9


def k2_scaled_check(errs, arch, out, q, k, v, kernel="flash_attention_mma",
                    causal=True, window=None, key=""):
    """Hold K2's bf16 output (causal or unmasked) to an error bound
    scaled by the reference, element by element, so that late causal
    rows and long unmasked ones (|out| a few hundredths) are held as
    tightly as early ones (|out| a few units).  The reference is float32 attention of the same bf16
    inputs.  The kernel rounds each weight to bf16 (relative 2^-9) and
    normalises by the rounded weights (the tensor-core kernel; the
    CUDA-core one keeps f32 weights and is inside the bound with room),
    which moves an element by at
    most 2^-9 * sum_j w_j |v_j - ref| <= 2^-9 * (ref_abs + |ref|), where
    ref_abs is the same attention over |V|; the bf16 output adds
    2^-9 * |ref|.  So |out - ref| <= 2^-8 * (|ref| + ref_abs) + 1e-5
    (float32 summation order) holds for a sound kernel; the ratio of the
    error to that bound must stay at or below 1.

    That bound is per element and leaves room for a small bias: keys
    past Sk let into the softmax (zero keys and values) shrink every
    output by their share of the weight, 1.4% at whisper's 36 pad keys
    of 1536, which stays inside it.  So the least-squares scale of the
    output on the reference, sum(out ref) / sum(ref ref), is held too:
    the kernel's roundings are unbiased, so it stays within
    ``K2_SCALE_TOL`` of 1 (PERF.md has the sound and the control
    readings).  The ratio and the scale go into ``errs[kernel]`` under
    ``key + "scaled"`` and ``key + "scale"``."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref
    qf, kf, vf = (x.float() for x in (q, k, v))
    ref = attention_ref(qf, kf, vf, causal=causal, window=window)
    ref_abs = attention_ref(qf, kf, vf.abs(), causal=causal, window=window)
    err = (out.float() - ref).abs()
    ratio = float((err / (2.0 ** -8 * (ref.abs() + ref_abs) + 1e-5))
                  .max().item())
    bias = abs(float((out.float() * ref).sum() / (ref * ref).sum()) - 1.0)
    sq = q.shape[2]
    late = slice(3 * sq // 4, sq)
    print(f"[{arch} kernels] {kernel} bf16 B={q.shape[0]} Sq={sq} "
          f"Sk={k.shape[2]} causal={causal} window={window} against a "
          f"float32 reference: error over the scaled bound {ratio:.3f} "
          f"(limit 1), |least-squares scale - 1| {bias:.3e} (limit "
          f"{K2_SCALE_TOL:.3e}); last quarter of rows: max_abs_err "
          f"{float(err[:, :, late].max()):.3e}, median |ref| "
          f"{float(ref[:, :, late].abs().median()):.3e}, bound there "
          f"{float((2.0 ** -8 * (ref.abs() + ref_abs))[:, :, late].median()):.3e}"
          f" at the median")
    if not ratio <= 1.0:
        fail(f"{kernel} at {arch}'s shapes (Sq {sq}) exceeds its "
             f"reference-scaled bound: error/bound {ratio}")
    if not bias <= K2_SCALE_TOL:
        fail(f"{kernel} at {arch}'s shapes (Sq {sq}) is biased: its "
             f"least-squares scale on the reference is {1 - bias} or "
             f"{1 + bias}, beyond {K2_SCALE_TOL} of 1")
    worst = errs.setdefault(kernel, {}).get(key + "scaled", (0.0, 1.0))[0]
    errs[kernel][key + "scaled"] = (max(worst, ratio), 1.0)
    worst = errs[kernel].get(key + "scale", (0.0, K2_SCALE_TOL))[0]
    errs[kernel][key + "scale"] = (max(worst, bias), K2_SCALE_TOL)


def phase_family_kernels(dev, arch):
    """The attention kernels at ``arch``'s shapes against their plain
    versions, f32 (tol 1e-4) and bf16 (tol 2e-2): K2 causal at Sq 1024
    (bf16 on the tensor cores, the kernel ``kernel_for`` picks at D 128
    and at phi-3-vision's D 96; f32 on the CUDA cores) and at
    a ragged Sq 700, the bf16 one also within ``k2_scaled_check``'s bound; K3, K1, K5 and K4 (per-token int8 scales) at the serve's
    lanes over ``FAMILY_LENS``; K1 gives K3's bits on the gathered pools
    and K4 K5's, and each repeats its bits.  Returns {kernel: {dtype:
    (max_abs_err, tol)}}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.ops import kernel_for
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    errs = {}

    def record(name, dtype, err, tol, what):
        print(f"[{arch} kernels] {name} {dtype} {what}: max_abs_err "
              f"{err:.3e} (tol {tol})")
        if not err <= tol:
            fail(f"{name} at {arch}'s shapes ({dtype}, {what}) disagrees "
                 f"with its plain version: {err}")
        key = str(dtype).split(".")[-1]
        worst = errs.setdefault(name, {}).get(key, (0.0, tol))[0]
        errs[name][key] = (max(worst, err), tol)

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        kernel = f"flash_attention_{kernel_for(dtype, d)}"
        for sq in (1024, 700):
            q, k, v = k2_inputs(sq, dtype, dev, d, h, hkv)
            before = launch_counts()
            out = flash_attention(q, k, v, causal=True)
            ran = {n: c - before[n] for n, c in launch_counts().items()
                   if c != before[n]}
            if ran != {kernel: 1}:
                fail(f"K2 {dtype} at {arch}'s shapes launched {ran}")
            torch.cuda.synchronize()
            record(kernel, dtype, max_err(out, attention_ref(q, k, v,
                                                             causal=True)),
                   tol, f"Sq={sq} H={h} Hkv={hkv} D={d}")
            if dtype == torch.bfloat16:
                k2_scaled_check(errs, arch, out, q, k, v, kernel)
        q, kp, vp, bt, lens, kd, vd = family_decode_inputs(arch, dtype, dev)
        kq, ks = quantize_kv_q8(kp.float(), 1)
        vq, vs = quantize_kv_q8(vp.float(), 1)
        gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
        runs = {
            "decode_attention_lengthaware": (
                lambda: decode_attention(q, kd, vd, lens),
                decode_attention_ref(q, kd, vd, lens)),
            "decode_attention_paged": (
                lambda: decode_attention_paged(q, kp, vp, bt, lens),
                decode_attention_paged_ref(q, kp, vp, bt, lens)),
            "decode_attention_q8_lengthaware": (
                lambda: decode_attention_q8(q, *gq, lens, qblock=1),
                decode_attention_q8_ref(q, *gq, lens, qblock=1)),
            "decode_attention_paged_q8": (
                lambda: decode_attention_paged_q8(q, kq, ks, vq, vs, bt,
                                                  lens, qblock=1),
                decode_attention_paged_q8_ref(q, kq, ks, vq, vs, bt, lens,
                                              qblock=1))}
        outs = {}
        for name, (run, ref) in runs.items():
            out, again = run(), run()
            torch.cuda.synchronize()
            record(name, dtype, max_err(out, ref), tol,
                   f"B={len(lens)} H={h} Hkv={hkv} D={d} lengths "
                   f"{lens.tolist()}")
            if not torch.equal(out, again):
                fail(f"{name} did not repeat its bits at {arch}'s shapes")
            if not bool(torch.all(out[0] == 0)):
                fail(f"{name}: the dead lane did not give 0 at {arch}'s "
                     f"shapes")
            outs[name] = out
        for paged, dense in (("decode_attention_paged",
                              "decode_attention_lengthaware"),
                             ("decode_attention_paged_q8",
                              "decode_attention_q8_lengthaware")):
            if not torch.equal(outs[paged], outs[dense]):
                fail(f"{paged} differs from {dense} on the gathered pools "
                     f"at {arch}'s shapes ({dtype})")
    print(f"[{arch} kernels] K1 == K3 and K4 == K5 bitwise on the gathered "
          f"pools, every kernel repeats its bits")
    return errs


def phase_family_timings(dev, arch):
    """The attention kernels of ``arch``'s path at its shapes, as device
    time per call (``time_ms_queued``) beside their plain versions, one
    PyTorch call where one computes the function, and the bound: K2 bf16
    causal at B 1, Sq 1024 (beside SDPA; the kernel ``kernel_for`` picks,
    its bound at the bf16 peak whichever arm runs); K3 (beside SDPA with the length
    mask), K1 (beside its pages gathered then SDPA), K5 and K4 (beside
    the dequantize route) with bf16 q at the serve's lanes and
    ``FAMILY_LENS``."""
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_paged, decode_attention_paged_q8,
        decode_attention_paged_q8_ref, decode_attention_paged_ref,
        decode_attention_q8, decode_attention_q8_ref, decode_attention_ref,
        gather_pages, quantize_kv_q8)
    from repro_torch.kernels.flash_attention.ops import kernel_for
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = {}
    q, k, v = k2_inputs(1024, torch.bfloat16, dev, d, h, hkv)
    k2 = kernel_for(torch.bfloat16, d)
    rows[f"flash_attention_{k2}"] = with_bound(dict(
        _k2_row(q, k, v, 2),
        shape=f"bf16 B 1 H {h} Hkv {hkv} Sq 1024 D {d} causal"))
    q, kp, vp, bt, lens, kd, vd = family_decode_inputs(arch, torch.bfloat16,
                                                       dev)
    ps = kp.shape[2]
    live = lens.to(torch.int64)
    n_live = int(live.sum().item())
    pages_live = int(((live + ps - 1) // ps).sum().item())
    io_bytes = 2 * q.numel() * 2 + 4 * lens.numel()
    alive = lens >= 1
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            < lens[:, None])[alive][:, None, None, :].contiguous()
    ql = q[alive][:, :, None].contiguous()
    shape = (f"bf16 q, B {len(lens)} H {h} Hkv {hkv} D {d}, S 1024, "
             f"lengths {lens.tolist()}")
    rows["decode_attention_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention(q, kd, vd, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_ref(q, kd, vd,
                                                             lens)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, kd[alive], vd[alive], attn_mask=mask, enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S, shape=shape))
    rows["decode_attention_paged"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged(q, kp, vp, bt,
                                                         lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_ref(
            q, kp, vp, bt, lens)),
        library_ms=None,
        gather_sdpa_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            ql, gather_pages(kp, bt)[alive], gather_pages(vp, bt)[alive],
            attn_mask=mask, enable_gqa=True)),
        bytes=2 * n_live * hkv * d * 2 + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d, peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16"))
    kq, ks = quantize_kv_q8(kp.float(), 1)
    vq, vs = quantize_kv_q8(vp.float(), 1)
    gq = [gather_pages(x, bt) for x in (kq, ks, vq, vs)]
    row_bytes = hkv * (2 * d + 2 * 4)       # int8 k and v, f32 k/v scales
    rows["decode_attention_q8_lengthaware"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_q8(q, *gq, lens,
                                                      qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_q8_ref(
            q, *gq, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_dense(q, *gq, lens, 1)),
        bytes=n_live * row_bytes + io_bytes,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S, shape=shape + ", int8 per-token scales"))
    rows["decode_attention_paged_q8"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention_paged_q8(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        plain_ms=time_ms_queued(lambda: decode_attention_paged_q8_ref(
            q, kq, ks, vq, vs, bt, lens, qblock=1)),
        library_ms=None,
        route_ms=time_ms_queued(lambda: _route_paged(q, kq, ks, vq, vs, bt,
                                                     lens, 1)),
        bytes=n_live * row_bytes + io_bytes + 4 * pages_live,
        flops=4 * n_live * h * d + 2 * n_live * hkv * d,
        peak=BF16_FLOPS_PER_S,
        shape=shape + ", pages of 16, int8 per-token scales"))
    for name, rr in rows.items():
        lib = rr["library_ms"]
        extra = "".join(f", {k} {rr[k]:.4f} ms" for k in
                        ("route_ms", "gather_sdpa_ms") if k in rr)
        print(f"[time {arch}] {name} ({rr['shape']}): kernel "
              f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}{extra}, bound "
              f"{rr['bound_ms']:.5f} ms ({rr['bound_by']}: {rr['bytes']} B, "
              f"{rr['flops']} flop)")
    return rows


def init_config(dev, arch):
    """``arch``'s CONFIG in bf16 with random weights from the seed, on
    the card; prints its size."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{arch}] bf16, {n_params / 1e9:.3f}B params "
          f"({2 * n_params / 1e9:.1f} GB) initialised in "
          f"{time.perf_counter() - t0:.1f}s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, params


def phase_family_serve(dev, arch):
    """``arch`` at full width (bf16, random weights from the seed) served
    with ``FAMILY_SERVES``' traffic on its layouts through
    :func:`serve_full` (the replay gates and check): K2 (the kernel
    ``kernel_for`` picks at the config's head dim: the tensor cores at D
    128 and at phi-3-vision's D 96) once a layer a prompt and K3
    (fixed-lane) or K1 (paged) once a layer a decode step; the prefill's
    last-position logits finite with the padded vocab masked; a vlm
    also runs :func:`vision_forward_check`.  Loaded after every earlier
    model is dropped and the cache emptied; reports the phase's peak
    device memory.  Returns {layout: (counts, summary)}; a vlm's first
    summary holds ``"vision_forward"``."""
    import torch
    from repro_torch.kernels.flash_attention.ops import kernel_for
    from repro_torch.models.transformer import lm_prefill_batched
    n_req, gen, lanes, layouts = FAMILY_SERVES[arch]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[{arch}] before loading: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved")
    cfg, params = init_config(dev, arch)
    k2 = f"flash_attention_{kernel_for(cfg.compute_dtype, cfg.hd)}"
    out = {}
    for layout in layouts:
        kw = dict(paged=True, page_size=16) if layout == "paged" else {}
        kernel = ("decode_attention_paged" if layout == "paged" else
                  "decode_attention_lengthaware")
        tag = f"{arch} {layout}"
        reqs = _requests(cfg, n_req, 64, 700, gen, SEED + 2)
        counts, summary = serve_full(dev, cfg, params, tag, (kernel, k2),
                                     reqs=reqs, n_lanes=lanes, **kw)
        per_step = counts[kernel] / summary["decode_steps"]
        print(f"[{tag}] {kernel} launches per decode step: {per_step}; "
              f"{k2} {counts[k2]} for {n_req} prompts")
        if per_step != cfg.n_layers or counts[k2] != cfg.n_layers * n_req:
            fail(f"{tag}: {kernel} {per_step} a step, K2 ({k2}) "
                 f"{counts[k2]}, not {cfg.n_layers} a step and a prompt")
        out[layout] = (counts, summary)
    prompt = torch.from_numpy(_requests(cfg, 1, 64, 64, 1, SEED)[0]
                              .prompt[None]).to(dev)
    logits, _ = lm_prefill_batched(params, prompt, cfg)
    if logits.shape != (1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()) or \
            not bool((logits[:, cfg.vocab_size:] == -1e30).all()):
        fail(f"{arch}: prefill logits are not finite/masked as expected")
    if cfg.family == "vlm":
        out[layouts[0]][1]["vision_forward"] = vision_forward_check(
            dev, cfg, params)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{arch}] phase peak device memory allocated {peak / 2**30:.2f} "
          f"GiB ({torch.cuda.get_device_name(0)})")
    for layout in layouts:
        out[layout][1]["peak_gib"] = peak / 2**30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vision_forward_check(dev, cfg, params, s=1024):
    """``build_model(cfg).forward`` at S ``s`` with a ``n_vision_tokens``
    prefix of ``vision_embeds`` drawn from the seed (launch counts zeroed
    before and read after): K2 (tensor-core kernel at D 96) once a layer,
    finite logits of the right shape with the padded vocab masked, and
    the logits at the vision positions moved by the embeddings (against
    the same tokens without them).  Returns the launches and the host
    ms of the call."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.ops import kernel_for
    from repro_torch.models import build_model
    rng = np.random.default_rng(SEED + 17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)).astype(
        np.int32)).to(dev)
    vis = torch.from_numpy(rng.standard_normal(
        (1, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    model = build_model(cfg)
    k2 = f"flash_attention_{kernel_for(cfg.compute_dtype, cfg.hd)}"
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model.forward(params, toks, vision_embeds=vis)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    plain = model.forward(params, toks)
    n = cfg.n_vision_tokens
    v = cfg.vocab_size
    if logits.shape != (1, s, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :v]).all()) or \
            not bool((logits[..., v:] == -1e30).all()):
        fail(f"[{cfg.name} vision] forward logits are not finite/masked")
    if counts[k2] != cfg.n_layers:
        fail(f"[{cfg.name} vision] {k2} launched {counts[k2]} times, not "
             f"{cfg.n_layers}")
    if torch.equal(logits[:, :n], plain[:, :n]):
        fail(f"[{cfg.name} vision] the vision prefix changed no logit")
    print(f"[{cfg.name} vision] forward at S {s} with a {n}-token vision "
          f"prefix: {k2} {counts[k2]} launches, finite logits "
          f"{tuple(logits.shape)}, {ms:.2f} ms host (first call)")
    return {"launches": {k2: counts[k2]}, "ms_host": ms, "s": s,
            "n_vision_tokens": n}


# ----------------------------------------------------------------------
# prefix sharing and evict/restore
# ----------------------------------------------------------------------

def share_smoke_prompts(cfg):
    """The SMOKE sharing traffic (pages of 8): a 20-token head served
    alone first (2 full pages and a partial one go to the cache), the
    head plus 2 tokens (a hit on the partial page: a copy-on-write
    split), members with tails of their own, an unrelated prompt and a
    member past ``max_len - 1``."""
    import numpy as np
    rng = np.random.default_rng(SEED + 11)
    head = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)

    def tail(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    return [head, np.concatenate([head, tail(2)]),
            np.concatenate([head, tail(9)]), tail(13),
            np.concatenate([head, tail(5)]),
            np.concatenate([head, tail(40)]), head.copy()]


def phase_share_smoke(dev):
    """SMOKE qwen2.5-1.5b in float32, KV in float32 and in int8, greedy
    and at t=0.8: the sharing engine on the CPU and on the card and the
    unshared engine on the card give identical streams, the two sharing
    engines identical stats (hits, a copy-on-write split for float32 KV,
    pages saved), and on the card K1 (K4) ran and the unmatched tails
    replayed the captured batch-1 step."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import STATS_KEYS, Request, ServeEngine
    base = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                               dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(base).init(torch.Generator().manual_seed(SEED),
                                    cpu)
    on_card = copy.deepcopy(params).to(dev)
    prompts = share_smoke_prompts(base)
    gens = [6, 5, 7, 4, 6, 3, 5]
    for kv_quant in (None, "int8"):
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        kernel = ("decode_attention_paged_q8" if kv_quant else
                  "decode_attention_paged")
        for temperature in (0.0, 0.8):
            tag = (f"[share smoke{' int8' if kv_quant else ''} "
                   f"t={temperature}]")
            streams, stats = {}, {}
            for where, share in (("cpu", True), ("cuda", True),
                                 ("cuda", False)):
                eng = ServeEngine(cfg, params if where == "cpu" else on_card,
                                  n_lanes=2, max_len=48, dispatch_n=4,
                                  paged=True, page_size=8, rng_seed=7,
                                  temperature=temperature,
                                  prefix_sharing=share, device=where)
                reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=g)
                        for i, (p, g) in enumerate(zip(prompts, gens))]
                reset_launch_counts()
                eng.run(reqs)
                counts = launch_counts()
                streams[where, share] = [r.generated for r in reqs]
                stats[where, share] = {k: eng.stats[k] for k in STATS_KEYS}
                if where == "cuda" and counts[kernel] <= 0:
                    fail(f"{tag} {kernel} never ran: {counts}")
                if where == "cuda" and share and not kv_quant and \
                        eng.graphs.replays("stream_step") <= 0:
                    fail(f"{tag} the tails never replayed the batch-1 step")
                if share:
                    eng.prefix_cache.flush()
                eng.pool.check()
                if eng.pool.n_in_use:
                    fail(f"{tag} pages left in use ({where}, share={share})")
            st = stats["cuda", True]
            if stats["cpu", True] != st:
                fail(f"{tag} sharing stats differ CPU vs card: "
                     f"{stats['cpu', True]} {st}")
            want_cow = 0 if kv_quant else 1
            if st["prefix_hits"] < 4 or st["prefix_cow_copies"] < want_cow:
                fail(f"{tag} too few hits or copy-on-write splits: {st}")
            same_cpu = streams["cpu", True] == streams["cuda", True]
            same_unshared = streams["cuda", True] == streams["cuda", False]
            print(f"{tag} streams identical CPU vs card (shared) "
                  f"{same_cpu}, shared vs unshared on the card "
                  f"{same_unshared}; hits {st['prefix_hits']}, tokens "
                  f"matched {st['prefix_tokens_matched']}, pages saved "
                  f"{st['prefix_pages_saved']}, cow {st['prefix_cow_copies']}")
            if not (same_cpu and same_unshared):
                fail(f"{tag} streams differ")


#: full-width sharing traffic: a common head of 32 full pages and 8
#: tokens, each request's own tail of 16-80 tokens, 64 new tokens
SHARE_HEAD, SHARE_TAILS, SHARE_REQS = 520, (16, 80), 16


def share_full_requests(cfg):
    """``SHARE_REQS`` requests opening with one ``SHARE_HEAD``-token head
    and a tail of their own, then one more that repeats the first prompt
    not ending on a page boundary with 5 more tokens: it matches that
    prompt's partial last page, which it copies on write."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(SEED + 7)
    head = rng.integers(0, cfg.vocab_size, SHARE_HEAD).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, cfg.vocab_size, int(rng.integers(*SHARE_TAILS, endpoint=True))
        ).astype(np.int32)]) for _ in range(SHARE_REQS)]
    donor = next(p for p in prompts if len(p) % 16)
    prompts.append(np.concatenate(
        [donor, rng.integers(0, cfg.vocab_size, 5).astype(np.int32)]))
    return [Request(uid=i, prompt=p, max_new_tokens=64)
            for i, p in enumerate(prompts)]


def share_mirror_stats(cfg, reqs):
    """The stats the port's rules give for ``reqs`` on the sharing
    engine's geometry (8 lanes, max_len 1024, 256 pages of 16), from a
    one-layer float32 model of the same vocabulary on the CPU: which
    prompts hit, what they match and share, and the page counts depend
    on the prompts' tokens, lengths and budgets only."""
    import dataclasses
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import STATS_KEYS, Request, ServeEngine
    tiny = dataclasses.replace(cfg, n_layers=1, d_model=64, n_heads=1,
                               n_kv_heads=1, d_ff=64, dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(tiny).init(torch.Generator().manual_seed(SEED), cpu)
    eng = ServeEngine(tiny, params, n_lanes=8, max_len=1024, paged=True,
                      page_size=16, n_pages=256, prefix_sharing=True,
                      device="cpu")
    eng.run([Request(uid=r.uid, prompt=r.prompt.copy(),
                     max_new_tokens=r.max_new_tokens) for r in reqs])
    return {k: eng.stats[k] for k in STATS_KEYS}


def phase_share_full(dev, cfg, params):
    """qwen2.5-1.5b at full width (bf16), paged over 256 pages of 16, 8
    lanes, with prefix sharing: ``share_full_requests``' traffic served
    twice with sharing and once without.  Gates: every budget finishes;
    every stat of both sharing serves equals the port's rules for these
    prompts (:func:`share_mirror_stats`); the two sharing serves give
    identical streams; the unshared serve's page high-water mark is
    above theirs; K1 launches 28 a decode step plus 28 a streamed tail
    token and K2 28 a missed prompt (replay accounting); every tail
    token but the engine's first is a replay of the batch-1 step.  The
    share of streams equal to the unshared serve's is printed, not
    gated (bf16: K1 over a streamed tail and K2 over the whole prompt
    may round apart).  Returns the summary."""
    import torch
    reqs = share_full_requests(cfg)
    want = share_mirror_stats(cfg, reqs)
    print(f"[share full] the port's rules for this traffic (CPU mirror): "
          f"{want}")
    need = ("decode_attention_paged", "flash_attention_mma")
    runs = {}
    for tag, share in (("share full 1", True), ("share full 2", True),
                       ("share full unshared", False)):
        rq = share_full_requests(cfg)
        # sharing, only the one miss prefills: no bucket recurs
        counts, summary = serve_full(dev, cfg, params, tag, need, reqs=rq,
                                     prefill_replays=not share, paged=True,
                                     page_size=16, n_pages=256,
                                     prefix_sharing=share)
        runs[tag] = (counts, summary, [r.generated for r in rq])
    for tag in ("share full 1", "share full 2"):
        counts, summary, _ = runs[tag]
        st = summary["stats"]
        differ = {k: (st[k], want[k]) for k in want if st[k] != want[k]}
        if differ:
            fail(f"[{tag}] stats differ from the port's rules: {differ}")
        tail = sum(summary["prefix_tail_tokens"])
        per_step = ((counts["decode_attention_paged"] - cfg.n_layers * tail)
                    / st["decode_steps"])
        if per_step != cfg.n_layers or counts["flash_attention_mma"] != \
                cfg.n_layers * st["prefix_misses"]:
            fail(f"[{tag}] K1 {counts['decode_attention_paged']} for "
                 f"{st['decode_steps']} steps and {tail} tail tokens, K2 "
                 f"{counts['flash_attention_mma']} for "
                 f"{st['prefix_misses']} misses")
        if summary["stream_replays"] != tail - 1:
            fail(f"[{tag}] {summary['stream_replays']} replays of the "
                 f"batch-1 step for {tail} tail tokens")
        summary["tail_ms_per_token"] = (1e3 * sum(summary["prefix_stream_s"])
                                        / tail)
        print(f"[{tag}] hits {st['prefix_hits']}, misses "
              f"{st['prefix_misses']}, tokens matched "
              f"{st['prefix_tokens_matched']}, pages shared "
              f"{st['prefix_pages_shared']}, saved "
              f"{st['prefix_pages_saved']}, cow {st['prefix_cow_copies']}, "
              f"evictions {st['prefix_evictions']}, kv_pages_hwm "
              f"{st['kv_pages_hwm']}; {tail} tail tokens streamed, "
              f"{summary['tail_ms_per_token']:.3f} ms a token (host, "
              f"synced; replays of the batch-1 step, the capture excluded)")
    s1, s2, plain = (runs[t][2] for t in ("share full 1", "share full 2",
                                          "share full unshared"))
    if s1 != s2:
        fail("[share full] two sharing serves gave different streams")
    hwm = {t: runs[t][1]["stats"]["kv_pages_hwm"] for t in runs}
    if not hwm["share full 1"] < hwm["share full unshared"]:
        fail(f"[share full] sharing did not lower the page high-water "
             f"mark: {hwm}")
    same = sum(a == b for a, b in zip(s1, plain))
    print(f"[share full] {same}/{len(s1)} streams equal to the unshared "
          f"serve's (not gated in bf16); kv_pages_hwm {hwm}; tok/s shared "
          f"{runs['share full 1'][1]['tok_s']:.1f} / "
          f"{runs['share full 2'][1]['tok_s']:.1f}, unshared "
          f"{runs['share full unshared'][1]['tok_s']:.1f}")
    out = runs["share full 1"][1]
    out.update(same_as_unshared=same, n_streams=len(s1), kv_pages_hwm=hwm,
               tok_s_unshared=runs["share full unshared"][1]["tok_s"],
               tok_s_second=runs["share full 2"][1]["tok_s"])
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_preempt_full(dev, cfg, params):
    """qwen2.5-1.5b at full width, paged (256 pages of 16, 8 lanes), KV
    in bf16 and in int8: the full-width traffic served uninterrupted,
    then again with two live lanes evicted after the second dispatch,
    one restored into the same engine and one into a fresh engine with
    the same ``n_lanes``, seed and temperature.  Every stream equals the
    uninterrupted serve's bit for bit.  Prints evict and restore ms
    (host, synced)."""
    import dataclasses
    import torch
    from repro_torch.serving import ServeEngine
    kw = dict(n_lanes=8, max_len=1024, paged=True, page_size=16,
              n_pages=256, device=dev)
    out = {}
    for kv_quant in (None, "int8"):
        cfg_q = dataclasses.replace(cfg, kv_quant=kv_quant)
        tag = f"[preempt full{' int8' if kv_quant else ''}]"
        base = _requests(cfg, 16, 64, 700, 64, SEED + 2)
        ServeEngine(cfg_q, params, **kw).run(base)
        reqs = _requests(cfg, 16, 64, 700, 64, SEED + 2)
        src = ServeEngine(cfg_q, params, **kw)
        dst = ServeEngine(cfg_q, params, **kw)
        pending, dispatches, times = list(reqs), 0, {}
        while pending or src.live_lanes():
            while pending and src.free_lanes():
                if not src.admit(pending[0]):
                    break
                pending.pop(0)
            src.decode_n()
            dispatches += 1
            if dispatches != 2:
                continue
            live = src.live_lanes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpts = [src.evict(lane) for lane in live[:2]]
            times["evict_ms"] = 1e3 * (time.perf_counter() - t0) / 2
            pages = [c.n_pages for c in ckpts]
            t0 = time.perf_counter()
            if not (src.restore(ckpts[0]) and dst.restore(ckpts[1])):
                fail(f"{tag} a restore found no lane or pages")
            torch.cuda.synchronize()
            times["restore_ms"] = 1e3 * (time.perf_counter() - t0) / 2
        while dst.live_lanes():
            dst.decode_n()
        moved = [ckpts[0].uid, ckpts[1].uid]
        same = sum(a.generated == b.generated for a, b in zip(reqs, base))
        print(f"{tag} lanes {live[:2]} (uids {moved}, {pages} pages) "
              f"evicted after dispatch 2; one restored here, one into a "
              f"fresh engine: {same}/{len(reqs)} streams equal to the "
              f"uninterrupted serve's; evict {times['evict_ms']:.3f} ms, "
              f"restore {times['restore_ms']:.3f} ms a lane (host, synced)")
        if same != len(reqs) or not all(r.done for r in reqs):
            fail(f"{tag} a resumed stream differs from the uninterrupted "
                 f"one")
        for eng in (src, dst):
            eng.pool.check()
            if eng.pool.n_in_use:
                fail(f"{tag} pages left in use")
        if (src.stats["preemptions"], src.stats["restores"],
                dst.stats["restores"]) != (2, 1, 1) or \
                dst.stats["pages_migrated"] != pages[1]:
            fail(f"{tag} preemption stats {src.stats} {dst.stats}")
        out[kv_quant or "bf16"] = dict(times, pages=pages, uids=moved)
        del src, dst
        gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# observability and resilience: registry, tracer, flight recorder, SLO
# control, degradation ladder, page sanitizer
# ----------------------------------------------------------------------

def obs_stack():
    """The full observability stack of one engine, as keyword arguments:
    an enabled tracer feeding a registry, a flight recorder big enough
    for the whole serve, an SLO controller with a lenient objective
    (TTFT 60 s, TPOT 1 s) over a ladder of its own, and the sanitizer."""
    from repro_torch import obs
    from repro_torch.serving import DegradationLadder
    reg = obs.MetricsRegistry()
    mon = obs.BurnRateMonitor(obs.SLOObjective(ttft_s=60.0, tpot_s=1.0),
                              registry=reg)
    return dict(tracer=obs.SpanTracer(enabled=True, registry=reg),
                registry=reg, flight=obs.FlightRecorder(capacity=1 << 16),
                slo=obs.SLOController(mon, DegradationLadder()),
                sanitize=True)


def record_seq(eng):
    """The engine's spans and instants in recording order, as (kind,
    name, track, args) with times left out (the flight ring's copy)."""
    return [(r["kind"], r["name"], r["track"], r["args"])
            for r in eng.flight.records()
            if r["kind"] in ("span", "instant")]


def decode_replays(eng):
    return sum(eng.graphs.replays(k) for k in eng.graphs.capture_s
               if isinstance(k, int))


def gate_replays(eng, tag):
    """The decode replays, gated as :func:`graph_summary` gates them, and
    the prefill's (:func:`prefill_gate`)."""
    st = eng.stats
    got = decode_replays(eng)
    if got != st["decode_dispatches"] - st["decode_compiles"] or got <= 0:
        fail(f"{tag}: {got} graph replays for {st['decode_dispatches']} "
             f"dispatches and {st['decode_compiles']} compiles")
    prefill_gate(eng, tag)
    return got


def gate_timelines(eng, reqs, tag):
    """Every request's timeline complete, with a TTFT and a TPOT series;
    one ``decode.dispatch`` span (and histogram sample) per dispatch."""
    from repro_torch import obs
    tls = obs.request_timelines(eng.tracer)
    if sorted(tls) != sorted(r.uid for r in reqs):
        fail(f"{tag}: timelines for uids {sorted(tls)}")
    for uid, tl in tls.items():
        if not (tl.complete and tl.ttft_s is not None and tl.ttft_s > 0
                and tl.tpot_series):
            fail(f"{tag}: request {uid}'s timeline is not complete: "
                 f"{tl.gaps()} ttft {tl.ttft_s}")
    n = eng.stats["decode_dispatches"]
    spans = len(eng.tracer.spans_named("decode.dispatch"))
    hist = eng.registry["span.decode.dispatch.seconds"].count
    if spans != n or hist != n:
        fail(f"{tag}: {spans} decode.dispatch spans, {hist} samples, for "
             f"{n} dispatches")
    return tls


def phase_obs_smoke(dev, paged):
    """Phases 28 (paged) and 29 (fixed-lane): SMOKE qwen2.5 in float32
    (pages of 8), the full stack on the CPU port and on the card (the
    fixed-lane engine: tracer and registry only), and the card's engine
    with everything off.  Streams equal across the three; the spans and
    instants (kind, name, track, args), every ``STATS_SCHEMA`` counter
    and, paged, the sanitizer's page-op log equal CPU vs card; the
    ladder stays at level 0; the card's dispatches replay graphs."""
    import copy
    import dataclasses
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import STATS_KEYS, ServeEngine
    tag = f"[obs smoke {'paged' if paged else 'fixed-lane'}]"
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = copy.deepcopy(params).to(dev)
    kw = dict(n_lanes=4, max_len=128, paged=paged, page_size=8,
              n_pages=40 if paged else None, rng_seed=SEED + 3)
    out = {}
    for run in ("cpu", "cuda", "cuda off"):
        where = run.split()[0]
        if run.endswith("off"):
            stack = {}
        elif paged:
            stack = obs_stack()
        else:
            reg = obs.MetricsRegistry()
            stack = dict(registry=reg,
                         tracer=obs.SpanTracer(enabled=True, registry=reg),
                         flight=obs.FlightRecorder(capacity=1 << 16))
        eng = ServeEngine(cfg, params if where == "cpu" else on_card,
                          device=where, **kw, **stack)
        if eng._sanitizer is not None:
            eng._sanitizer.log = obs.EventLog(clock=lambda: 0.0)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        reset_launch_counts()
        eng.run(reqs)
        counts = launch_counts()
        out[run] = dict(eng=eng, streams=[r.generated for r in reqs],
                        stats=dict(eng.stats), counts=counts, reqs=reqs)
    cpu_r, card, off = out["cpu"], out["cuda"], out["cuda off"]
    if not (cpu_r["streams"] == card["streams"] == off["streams"]):
        fail(f"{tag} streams differ: CPU stack vs card stack vs card off")
    if card["stats"] != cpu_r["stats"] or len(card["stats"]) != \
            len(STATS_KEYS):
        fail(f"{tag} counters differ CPU vs card: {cpu_r['stats']} "
             f"{card['stats']}")
    ceng, teng = cpu_r["eng"], card["eng"]
    seq = record_seq(teng)
    if seq != record_seq(ceng):
        fail(f"{tag} the span/instant sequence differs CPU vs card")
    need = ("decode_attention_paged" if paged
            else "decode_attention_lengthaware", "flash_attention_cc")
    if min(card["counts"][k] for k in need) <= 0:
        fail(f"{tag} a kernel of the path never launched: {card['counts']}")
    replays = gate_replays(teng, tag)
    if (teng.stats["decode_compiles"], replays) != (
            off["eng"].stats["decode_compiles"], decode_replays(off["eng"])):
        fail(f"{tag} compiles or replays differ with the stack on and off")
    gate_timelines(teng, card["reqs"], tag)
    n_ops = 0
    if paged:
        logs = [[(e.name, e.fields) for e in eng._sanitizer.log.records()]
                for eng in (ceng, teng)]
        if logs[0] != logs[1]:
            fail(f"{tag} the sanitizer's page-op log differs CPU vs card")
        if not teng._sanitizer.clean:
            fail(f"{tag} sanitizer violations {teng._sanitizer.violations}")
        if teng.slo.ladder.level != 0 or teng.slo.escalated:
            fail(f"{tag} the lenient SLO moved the ladder")
        n_ops = len(logs[1])
        if not teng.stats["kv_admit_blocked"]:
            fail(f"{tag} no admission was blocked for pages")
    names = sorted({name for _, name, _, _ in seq})
    print(f"{tag} float32 SMOKE, 10 requests: streams identical CPU stack "
          f"/ card stack / card off; {len(seq)} spans and instants "
          f"({names}), {len(STATS_KEYS)} counters"
          f"{f', {n_ops} page ops' if paged else ''} equal CPU vs card; "
          f"decode_compiles {teng.stats['decode_compiles']}, replays "
          f"{replays} on and off; kv_admit_blocked "
          f"{teng.stats['kv_admit_blocked']}")
    result = {"spans_and_instants": len(seq), "page_ops": n_ops,
              "replays": replays, "stats": card["stats"]}
    del out, ceng, teng
    gc.collect()
    return result


def serve_timed(eng, reqs):
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, launch_counts()


def first_difference(a_reqs, b_reqs):
    for a, b in zip(a_reqs, b_reqs):
        if a.generated != b.generated:
            i = next((i for i, (x, y) in enumerate(zip(a.generated,
                                                       b.generated))
                      if x != y), min(len(a.generated), len(b.generated)))
            return (f"uid {a.uid}: first differing token at index {i} "
                    f"({a.generated[i:i + 3]} vs {b.generated[i:i + 3]})")
    return None


def phase_obs_full(dev, cfg, params):
    """Phase 30: qwen2.5-1.5b bf16 paged at full width (phase 7's
    traffic, 256 pages of 16, 8 lanes), served with everything off and
    with the full stack, in the order off, on, on, off: streams bitwise
    equal, the same decode_compiles and replays (replays == dispatches -
    compiles > 0), every timeline complete, one decode.dispatch span per
    dispatch, the pool's gauges at 0 in use with allocs == frees, the
    sanitizer clean and the flight ring holding dispatch records.
    Prints each serve's wall and tok/s, the wall less the graph's
    capture, and the on/off ratios: the stack's cost on the card (not
    gated)."""
    from repro_torch.serving import ServeEngine
    tag = "[obs full]"
    kw = dict(n_lanes=8, max_len=1024, paged=True, page_size=16,
              n_pages=256, device=dev)
    res = []
    for run in ("off", "on", "on", "off"):
        eng = ServeEngine(cfg, params, **kw,
                          **(obs_stack() if run == "on" else {}))
        reqs = _requests(cfg, 16, 64, 700, 64, SEED + 2)
        wall, counts = serve_timed(eng, reqs)
        if not all(r.done and len(r.generated) == 64 for r in reqs):
            fail(f"{tag} {run}: a budget did not finish")
        if min(counts[k] for k in ("decode_attention_paged",
                                   "flash_attention_mma")) <= 0:
            fail(f"{tag} {run}: a kernel of the path never launched")
        n_gen = sum(len(r.generated) for r in reqs)
        capture = sum(eng.timings["capture"].values())
        res.append(dict(run=run, eng=eng, reqs=reqs, wall_s=wall,
                        tok_s=n_gen / wall, capture_s=capture,
                        tok_s_less_capture=n_gen / (wall - capture),
                        replays=gate_replays(eng, f"{tag} {run}"),
                        decode_compiles=eng.stats["decode_compiles"],
                        dispatches=eng.stats["decode_dispatches"]))
        if run == "off":
            del eng                   # only the stack's engines are read
            res[-1]["eng"] = None
            gc.collect()
    for r in res[1:]:
        diff = first_difference(r["reqs"], res[0]["reqs"])
        if diff is not None:
            fail(f"{tag} the stack changed a bf16 stream: {diff}")
        if (r["decode_compiles"], r["replays"]) != (
                res[0]["decode_compiles"], res[0]["replays"]):
            fail(f"{tag} compiles/replays differ on and off: "
                 f"{[(x['decode_compiles'], x['replays']) for x in res]}")
    for r in res:
        if r["run"] != "on":
            continue
        eng = r["eng"]
        tls = gate_timelines(eng, r["reqs"], tag)
        reg = eng.registry
        gauges = {k: reg[f"serve.pool.pages.{k}"].value
                  for k in ("in_use", "allocs", "frees", "hwm", "reserved")}
        if gauges["in_use"] or gauges["reserved"] or \
                gauges["allocs"] != gauges["frees"]:
            fail(f"{tag} pool gauges at the end {gauges}")
        if not eng._sanitizer.clean or eng._sanitizer.ops_seen <= 0:
            fail(f"{tag} sanitizer: {eng._sanitizer.violations}")
        flight = sum(x["kind"] == "span" and x["name"] == "decode.dispatch"
                     for x in eng.flight.records())
        if not flight or eng.flight.n_dumps:
            fail(f"{tag} flight ring: {flight} dispatch records, "
                 f"{eng.flight.n_dumps} dumps")
    ttft = sorted(tl.ttft_s for tl in tls.values())
    disp = reg["span.decode.dispatch.seconds"]
    on = [r for r in res if r["run"] == "on"]
    off = [r for r in res if r["run"] == "off"]

    def mean(rs, key):
        return sum(r[key] for r in rs) / len(rs)
    ratio = mean(on, "tok_s") / mean(off, "tok_s")
    ratio_less = (mean(on, "tok_s_less_capture")
                  / mean(off, "tok_s_less_capture"))
    print(f"{tag} qwen2.5-1.5b bf16 paged, 16 requests, served off, on, "
          f"on, off: streams bitwise equal; decode_compiles "
          f"{res[0]['decode_compiles']}, replays {res[0]['replays']} of "
          f"{res[0]['dispatches']} dispatches in each; {len(tls)} timelines"
          f" complete; sanitizer clean over {eng._sanitizer.ops_seen} page "
          f"ops; pool gauges {gauges}")
    for r in res:
        print(f"{tag} {r['run']}: {r['wall_s']:.3f}s = {r['tok_s']:.1f} "
              f"tok/s; less the capture ({r['capture_s']:.3f}s) "
              f"{r['tok_s_less_capture']:.1f} tok/s")
    print(f"{tag} on/off tok/s {ratio:.4f}, less the captures "
          f"{ratio_less:.4f}; decode.dispatch span p50 "
          f"{1e3 * disp.percentile(50):.2f} ms, p99 "
          f"{1e3 * disp.percentile(99):.2f} ms; TTFT median "
          f"{1e3 * statistics.median(ttft):.1f} ms, max "
          f"{1e3 * ttft[-1]:.1f} ms ({gpu_line()})")
    out = {"serves": [{f: r[f] for f in (
        "run", "wall_s", "tok_s", "capture_s", "tok_s_less_capture",
        "replays", "decode_compiles", "dispatches")} for r in res],
        "ratio_tok_s": ratio, "ratio_tok_s_less_capture": ratio_less,
        "pool_gauges": gauges, "page_ops": eng._sanitizer.ops_seen,
        "dispatch_span_ms": {"p50": 1e3 * disp.percentile(50),
                             "p99": 1e3 * disp.percentile(99)},
        "ttft_ms": {"median": 1e3 * statistics.median(ttft),
                    "max": 1e3 * ttft[-1]}}
    del res, on, off, eng
    gc.collect()
    return out


def phase_ladder_full(dev, cfg, params):
    """Phase 31: phase 30's traffic with ``priority = i % 2`` on a pool
    of 160 pages of 16 (more than one full context, 64 pages, fewer than
    the 8 lanes need), under ``DegradationLadder(page_pressure=0.75,
    trip_after=1, cooldown=4)``, against an engine without a ladder with
    the same ``n_lanes``, ``n_pages`` and seed: the ladder reaches
    ``evict`` and sheds lanes, every shed lane is restored, every budget
    finishes and every stream equals the other serve's bit for bit;
    ``decode_compiles`` is the number of distinct dispatch sizes."""
    from repro_torch import obs
    from repro_torch.serving import DegradationLadder, ServeEngine
    tag = "[ladder full]"
    kw = dict(n_lanes=8, max_len=1024, paged=True, page_size=16,
              n_pages=160, device=dev)

    def reqs():
        out = _requests(cfg, 16, 64, 700, 64, SEED + 2)
        for r in out:
            r.priority = r.uid % 2
        return out
    plain = ServeEngine(cfg, params, **kw)
    plain_reqs = reqs()
    plain_wall, _ = serve_timed(plain, plain_reqs)
    ladder = DegradationLadder(page_pressure=0.75, trip_after=1, cooldown=4)
    tracer = obs.SpanTracer(enabled=True)
    eng = ServeEngine(cfg, params, ladder=ladder, tracer=tracer, **kw)
    lreqs = reqs()
    wall, counts = serve_timed(eng, lreqs)
    st = eng.stats
    if not all(r.done and len(r.generated) == 64 for r in lreqs + plain_reqs):
        fail(f"{tag} a budget did not finish")
    diff = first_difference(lreqs, plain_reqs)
    if diff is not None:
        fail(f"{tag} a stream under the ladder differs from the serve "
             f"without one: {diff}")
    levels = [to for _, to, _ in ladder.transitions]
    if 3 not in levels or st["degrade_sheds"] < 1:
        fail(f"{tag} the ladder never reached evict or shed nothing: "
             f"{ladder.transitions[:8]} sheds {st['degrade_sheds']}")
    if not (st["restores"] == st["preemptions"] == st["degrade_sheds"]):
        fail(f"{tag} restores {st['restores']}, preemptions "
             f"{st['preemptions']}, sheds {st['degrade_sheds']}")
    if st["degrade_transitions"] != len(ladder.transitions):
        fail(f"{tag} degrade_transitions {st['degrade_transitions']}")
    sizes = sorted({s.args["n_steps"]
                    for s in tracer.spans_named("decode.dispatch")})
    if st["decode_compiles"] != len(sizes):
        fail(f"{tag} decode_compiles {st['decode_compiles']} for dispatch "
             f"sizes {sizes}")
    replays = gate_replays(eng, tag)
    if min(counts[k] for k in ("decode_attention_paged",
                               "flash_attention_mma")) <= 0:
        fail(f"{tag} a kernel of the path never launched: {counts}")
    eng.pool.check()
    if eng.pool.n_in_use:
        fail(f"{tag} pages left in use")
    moves = {}
    for frm, to, _ in ladder.transitions:
        moves[f"{frm}->{to}"] = moves.get(f"{frm}->{to}", 0) + 1
    n_gen = sum(len(r.generated) for r in lreqs)
    print(f"{tag} qwen2.5-1.5b bf16 paged, 160 pages, 16 requests: "
          f"{len(ladder.transitions)} transitions {moves} (first "
          f"{ladder.transitions[:4]}); {st['degrade_sheds']} lanes shed "
          f"and restored ({st['pages_migrated']} pages); dispatch sizes "
          f"{sizes}, decode_compiles {st['decode_compiles']}, "
          f"{st['decode_dispatches']} dispatches ({replays} replays) "
          f"against {plain.stats['decode_dispatches']} without the ladder;"
          f" streams bitwise equal to the serve without it")
    print(f"{tag} wall {wall:.3f}s ({n_gen / wall:.1f} tok/s) under the "
          f"ladder, {plain_wall:.3f}s ({n_gen / plain_wall:.1f} tok/s) "
          f"without ({gpu_line()})")
    out = {"transitions": len(ladder.transitions), "moves": moves,
           "sheds": st["degrade_sheds"], "pages_migrated":
           st["pages_migrated"], "dispatch_sizes": sizes,
           "decode_compiles": st["decode_compiles"],
           "dispatches": st["decode_dispatches"],
           "dispatches_plain": plain.stats["decode_dispatches"],
           "kv_admit_blocked": st["kv_admit_blocked"], "wall_s": wall,
           "wall_s_plain": plain_wall, "tok_s": n_gen / wall,
           "tok_s_plain": n_gen / plain_wall}
    del plain, eng
    gc.collect()
    return out


# ----------------------------------------------------------------------
# quantized weights (M11 + M14), multi-model serving on one byte budget
# (M9), the execution replay with crash recovery (M10)
# ----------------------------------------------------------------------

def _planes_differ(a, b):
    """Planes of two ``QTensor``s that are not bitwise equal."""
    import torch
    from repro_torch.quant import PLANES
    out = []
    for name in PLANES:
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x.cpu(), y.cpu())):
            out.append(name)
    return out


def phase_quant_smoke(dev):
    """Phase 32: ``quantize_params`` of float32 SMOKE qwen2.5-1.5b on the
    card, planes bitwise the CPU port's in all four formats, dequantized
    tensors bitwise; greedy streams over the dequantized q8_0 and q4_k
    weights equal CPU vs card, fixed-lane and paged (K3, K1 and K2's
    CUDA-core kernel launched); the README's canonical launch exits 0
    on the card."""
    import dataclasses
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import (ServeEngine, dequantize_params,
                                     device_copy, quantize_params)
    tag = "[quant smoke]"
    cfg = dataclasses.replace(get_config("qwen2.5-1.5b", smoke=True),
                              dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = device_copy(cfg, params, dev)
    out = {}
    for fmt in QFMTS:
        qc, sc = quantize_params(params, fmt)
        qd, sd = quantize_params(on_card, fmt)
        if sc != sd or sorted(qc.quantized) != ["embed.tok"]:
            fail(f"{tag} {fmt}: stats CPU {sc}, card {sd}, quantized "
                 f"{sorted(qc.quantized)}")
        for path in sorted(qc.quantized):
            differ = _planes_differ(qc.quantized[path], qd.quantized[path])
            if differ:
                fail(f"{tag} {fmt} {path}: planes {differ} differ CPU vs "
                     f"card")
        dc, dd = dequantize_params(qc), dequantize_params(qd)
        if not torch.equal(dc.embed.tok, dd.embed.tok.cpu()):
            fail(f"{tag} {fmt}: dequantized embed.tok differs CPU vs card")
        out[fmt] = {"stats": sd}
        if fmt not in ("q8_0", "q4_k"):
            continue
        for paged in (False, True):
            streams = {}
            for where, p in (("cpu", dc), ("cuda", dd)):
                eng = ServeEngine(cfg, p, n_lanes=4, max_len=128,
                                  rng_seed=SEED + 3, paged=paged,
                                  page_size=16, n_pages=24, device=where)
                reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
                reset_launch_counts()
                eng.run(reqs)
                counts = launch_counts()
                streams[where] = [r.generated for r in reqs]
                if where == "cuda":
                    k = ("decode_attention_paged" if paged
                         else "decode_attention_lengthaware")
                    if not (counts[k] and counts["flash_attention_cc"]):
                        fail(f"{tag} {fmt} paged={paged}: a kernel of the "
                             f"path never launched: {counts}")
                    eng.graphs.release()
            if streams["cpu"] != streams["cuda"]:
                fail(f"{tag} {fmt} paged={paged}: streams differ CPU vs "
                     f"card")
            print(f"{tag} {fmt} paged={paged}: {len(streams['cpu'])}/"
                  f"{len(streams['cpu'])} float32 SMOKE streams over the "
                  f"dequantized weights identical CPU vs card")
    print(f"{tag} planes bitwise CPU vs card for {list(QFMTS)}; stats "
          f"{ {f: out[f]['stats'] for f in QFMTS} }")
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen2.5-1.5b", "--smoke", "--quant", "q8_0", "--paged",
            "--page-size", "16", "--prefix-sharing"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not lines or \
            not lines[-1].endswith("(q8_0)") or \
            not any(ln.startswith("quantized 1 weight matrices")
                    for ln in lines):
        fail(f"{tag} the README's canonical launch failed (exit "
             f"{res.returncode}): {res.stdout[-2000:]} {res.stderr[-2000:]}")
    print(f"{tag} README launch `{' '.join(argv[2:])}` exit 0 in "
          f"{time.perf_counter() - t0:.1f}s on the card:")
    for ln in lines:
        if ln.startswith(("quantized", "served", "prefix sharing",
                          "capability")):
            print(f"{tag}   {ln}")
    out["readme_launch"] = [ln for ln in lines
                            if ln.startswith(("quantized", "served"))]
    return out


def phase_quant_full(dev, cfg, params):
    """Phase 33: full-width qwen2.5-1.5b bf16, the main path's traffic,
    paged (256 pages of 16, 8 lanes), served over the unquantized
    weights and over ``dequantize_params`` of q8_0 and q4_k: one leaf
    quantized (``embed.tok``, 152064 x 1536), its planes quantized on
    the card bitwise those quantized on the CPU; K1 28 times a decode
    step, K2's tensor-core kernel, replays == dispatches -
    decode_compiles (``serve_full``); tok/s of each serve."""
    import torch
    from repro_torch.quant import quantize
    from repro_torch.serving import dequantize_params, quantize_params
    tag = "[quant full]"
    need = ("decode_attention_paged", "flash_attention_mma")
    kw = dict(paged=True, page_size=16, n_pages=256)
    out = {}
    _, plain = serve_full(dev, cfg, params, "quant full none paged", need,
                          **kw)
    out["none"] = {"tok_s": plain["tok_s"], "wall_s": plain["wall_s"]}
    for fmt in ("q8_0", "q4_k"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp, st = quantize_params(params, fmt)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        print(f"{tag} {fmt}: quantized {st['quantized']} weight matrices "
              f"({st['quantized_bytes']/1e6:.1f} MB vs dense "
              f"{st['dense_bytes']/1e6:.1f} MB kept dense); stats {st}; "
              f"{q_s:.3f}s on the card")
        qt = qp.quantized.get("embed.tok")
        if st["quantized"] != 1 or sorted(qp.quantized) != ["embed.tok"] \
                or tuple(qt.shape) != (cfg.padded_vocab, cfg.d_model):
            fail(f"{tag} {fmt}: expected embed.tok "
                 f"({cfg.padded_vocab}, {cfg.d_model}) alone, got "
                 f"{ {p: q.shape for p, q in qp.quantized.items()} }")
        t0 = time.perf_counter()
        on_cpu = quantize(params.embed.tok.cpu(), fmt)
        cpu_s = time.perf_counter() - t0
        differ = _planes_differ(qt, on_cpu)
        if differ:
            fail(f"{tag} {fmt}: embed.tok planes {differ} differ card vs "
                 f"CPU")
        print(f"{tag} {fmt}: embed.tok planes bitwise card vs CPU "
              f"({cpu_s:.1f}s on the CPU)")
        deq = dequantize_params(qp)
        del qp, qt, on_cpu
        counts, summary = serve_full(dev, cfg, deq, f"quant full {fmt} paged",
                                     need, **kw)
        per_step = counts["decode_attention_paged"] / summary["decode_steps"]
        if per_step != cfg.n_layers:
            fail(f"{tag} {fmt}: K1 launched {per_step} times a decode step")
        out[fmt] = {"stats": st, "tok_s": summary["tok_s"],
                    "wall_s": summary["wall_s"], "quantize_s": q_s,
                    "replays": summary["graphs"]["replays"]}
        del deq
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{tag} tok/s paged, 16 requests: none {out['none']['tok_s']:.1f}"
          f", q8_0 {out['q8_0']['tok_s']:.1f}, q4_k "
          f"{out['q4_k']['tok_s']:.1f} ({gpu_line()})")
    return out


#: phase 34's byte budgets: both models resident with shrunk pools, and
#: one at a time (LRU swaps and reloads)
MM_BUDGETS = (6.0e9, 4.0e9)


def phase_multimodel_full(dev, cfg, params):
    """Phase 34: qwen2.5-1.5b and olmo-1b at full width, bf16, pages of
    16, 8 lanes, max_len 1024, host master copies registered in one
    ``ModelPool``; an alternating trace served by
    ``MultiModelServeEngine`` at 6.0e9 B (both resident, their pools
    below the two dense targets: the later load is shrunk to what is
    left) and 4.0e9 B (one at a time: LRU swaps and reloads).  Each
    model's streams equal the same requests served alone by one
    ``ServeEngine`` bit for bit; every pool checks and holds no page; after each unload ``memory_allocated`` has fallen
    by at least 90% of the model's weight bytes; swaps, bytes, the
    modelled swap seconds (the CMP 170HX's host link) and the measured
    host-to-device seconds of each load."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import (ModelPool, MultiModelServeEngine,
                                     ServeEngine, device_copy,
                                     kv_page_bytes, params_nbytes)
    tag = "[multimodel full]"
    cpu = torch.device("cpu")
    ocfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    olmo_card = build_model(ocfg).init(
        torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    hosts = {"olmo-1b": (ocfg, device_copy(ocfg, olmo_card, cpu)),
             "qwen2.5-1.5b": (cfg, device_copy(cfg, params, cpu))}
    del olmo_card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} host master copies made in "
          f"{time.perf_counter() - t0:.1f}s")
    n_lanes, max_len, ps = 8, 1024, 16
    bt = max_len // ps
    figures = {}
    for mid, (c, p) in sorted(hosts.items()):
        wb, pb = params_nbytes(p), kv_page_bytes(c, ps)
        figures[mid] = {"weight_bytes": wb, "page_bytes": pb,
                        "dense_target_bytes": (n_lanes * bt + 1) * pb}
        print(f"{tag} {mid}: weights {wb} B ({wb / 1e9:.3f} GB), a page "
              f"{pb} B, the dense target {n_lanes * bt + 1} pages = "
              f"{(n_lanes * bt + 1) * pb} B")

    def reqs():
        out = _requests(cfg, 6, 64, 300, 32, SEED + 7)
        for r in out:
            r.model_id = ("qwen2.5-1.5b", "olmo-1b")[r.uid % 2]
            r.prompt = r.prompt % min(c.vocab_size
                                      for c, _ in hosts.values())
        return out

    class Watched(MultiModelServeEngine):
        """Records device memory around every unload."""

        freed = []

        def _unload(self, model_id):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            super()._unload(model_id)
            torch.cuda.synchronize()
            self.freed.append((model_id,
                               before - torch.cuda.memory_allocated(dev)))

    engine_kw = dict(n_lanes=n_lanes, max_len=max_len, dispatch_n=8,
                     rng_seed=SEED)
    streams, runs = {}, {}
    for budget in MM_BUDGETS:
        pool = ModelPool(budget, page_size=ps)
        for mid in sorted(hosts):
            pool.register(mid, *hosts[mid])
        mm = Watched(pool, device=dev, **engine_kw)
        mm.freed = []
        rs = reqs()
        reset_launch_counts()
        t0 = time.perf_counter()
        mm.run(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if min(counts[k] for k in ("decode_attention_paged",
                                   "flash_attention_mma")) <= 0:
            fail(f"{tag} {budget:.1e} B: a kernel of the path never "
                 f"launched: {counts}")
        if not all(r.done and len(r.generated) == 32 for r in rs):
            fail(f"{tag} {budget:.1e} B: a budget did not finish")
        active = mm.kv_pages_active()
        # (no loop variable may keep an engine, and its memory, alive
        # past the unloads below)
        for mid in sorted(mm.engines):
            mm.engines[mid].pool.check()
            if mm.engines[mid].pool.n_in_use:
                fail(f"{tag} {budget:.1e} B: {mid} holds pages after the "
                     f"run")
        st = dict(mm.stats)
        phys = mm.physical_kv_bytes()
        if budget == MM_BUDGETS[0]:
            # both resident; the later load found less than its dense
            # target free, so the pools hold fewer pages than the two
            # dense targets
            if st["weight_evictions"] or len(mm.engines) != 2 or \
                    sum(active.values()) >= 2 * n_lanes * bt:
                fail(f"{tag} 6.0e9 B: expected both resident with shrunk "
                     f"pools: {st}, active pages {active}")
        elif st["weight_evictions"] < 1 or st["model_swaps"] <= 2:
            fail(f"{tag} 4.0e9 B: expected LRU swaps and reloads: {st}")
        for mid in sorted(mm.engines):
            mm.unload(mid)
        for mid, dropped in mm.freed:
            if dropped < 0.9 * figures[mid]["weight_bytes"]:
                fail(f"{tag} {budget:.1e} B: unloading {mid} freed "
                     f"{dropped} B of device memory, its weights are "
                     f"{figures[mid]['weight_bytes']} B")
        loads = [(m, b, round(s, 4), round(b / s / 1e9, 2))
                 for m, b, s in mm.load_seconds]
        print(f"{tag} {budget:.1e} B: {len(rs)} requests in {wall:.3f}s; "
              f"swaps {st['model_swaps']}, swap bytes {st['swap_bytes']}, "
              f"modelled swap seconds {st['swap_seconds']:.3f} "
              f"({pool.profile.name}'s host link), weight evictions "
              f"{st['weight_evictions']}, pages shrunk "
              f"{st['kv_pages_shrunk']}, grown {st['kv_pages_grown']}; "
              f"active pages at the end {active}, physical KV bytes "
              f"{phys}")
        print(f"{tag} {budget:.1e} B: measured host-to-device loads "
              f"(model, bytes, s, GB/s) {loads} on {gpu_line()}; device "
              f"memory freed per unload {mm.freed}")
        streams[budget] = {r.uid: r.generated for r in rs}
        runs[str(budget)] = {"stats": st, "wall_s": wall,
                             "active_pages": active,
                             "physical_kv_bytes": phys,
                             "loads": loads, "freed": list(mm.freed)}
        del mm, pool
        gc.collect()
        torch.cuda.empty_cache()
    for mid in sorted(hosts):
        c, host = hosts[mid]
        solo = [r for r in reqs() if r.model_id == mid]
        for r in solo:
            r.model_id = None
        eng = ServeEngine(c, device_copy(c, host, dev), paged=True,
                          page_size=ps, device=dev, **engine_kw)
        eng.run(solo)
        for budget in MM_BUDGETS:
            for r in solo:
                if streams[budget][r.uid] != r.generated:
                    fail(f"{tag} {budget:.1e} B: {mid} uid {r.uid} "
                         f"differs from the same request served alone")
        eng.graphs.release()
        del eng
        gc.collect()
    print(f"{tag} every stream at both budgets bitwise equal to its "
          f"model's single-engine serve")
    del hosts
    gc.collect()
    torch.cuda.empty_cache()
    return {"figures": figures, "runs": runs}


def phase_replay(dev, cfg, params):
    """Phase 35: the execution replay.  SMOKE (float32 qwen2.5-1.5b, and
    olmo-1b for the multi-model replay): ``run_trace_on_engine`` dense
    and paged, ``run_trace_with_faults`` (a crash at dispatch 10,
    ``checkpoint_every`` 4, transient dispatches 2 and 5) and
    ``run_multimodel_trace_on_engine`` give on the card what they give
    on the CPU, field for field.  Full width (qwen2.5-1.5b bf16, paged,
    8 lanes, a Poisson trace of 19 requests): ``validate_recovery_
    exactness`` (a crash at dispatch 9, when 5 live lanes hold a
    checkpoint and 3 do not) and ``validate_preemption_exactness`` hold,
    the crashed node's flight dump exists, and
    ``calibrate_replay(real, predict_replay(...))`` is printed and
    gated."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fleet import (FleetRequest, LengthDist, poisson_trace,
                                   run_multimodel_trace_on_engine,
                                   run_trace_on_engine,
                                   run_trace_with_faults,
                                   validate_preemption_exactness,
                                   validate_recovery_exactness)
    from repro_torch.models import build_model
    from repro_torch.obs import (MetricsRegistry, SpanTracer,
                                 calibrate_replay, predict_replay)
    from repro_torch.serving import device_copy
    tag = "[replay]"
    cpu = torch.device("cpu")
    smoke = {}
    for i, arch in enumerate(("qwen2.5-1.5b", "olmo-1b")):
        c = dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32")
        p = build_model(c).init(torch.Generator().manual_seed(SEED + i), cpu)
        smoke[arch] = (c, p)
    scfg, sparams = smoke["qwen2.5-1.5b"]
    trace = poisson_trace(2.0, 6.0, seed=3, prompt=LengthDist(12, cv=0.3),
                          gen=LengthDist(14, cv=0.4))
    mm_trace = [FleetRequest(uid=i, arrival_s=0.1 * i, prompt_len=4 + i % 3,
                             gen_len=5, model_id=("qwen2.5-1.5b",
                                                  "olmo-1b")[i % 2])
                for i in range(6)]
    kw = dict(n_lanes=2, max_len=32, dispatch_n=4, page_size=8, seed=5)
    got = {}
    for side, where in (("cpu", cpu), ("card", dev)):
        p = sparams if side == "cpu" else device_copy(scfg, sparams, dev)
        res = {
            "dense": run_trace_on_engine(trace, scfg, p, device=where, **kw),
            "paged": run_trace_on_engine(trace, scfg, p, paged=True,
                                         device=where, **kw),
            "faults": run_trace_with_faults(
                trace, scfg, p, crash_at_dispatch=10, checkpoint_every=4,
                transient_dispatches=(2, 5), device=where, **kw),
            "multimodel": run_multimodel_trace_on_engine(
                mm_trace, smoke, device=where, **kw)}
        got[side] = {k: dataclasses.asdict(v) for k, v in res.items()}
    for k in sorted(got["cpu"]):
        if got["cpu"][k] != got["card"][k]:
            fail(f"{tag} SMOKE {k}: card {got['card'][k]} != CPU "
                 f"{got['cpu'][k]}")
    f = got["card"]["faults"]
    if f["crashes"] != 1 or f["retry_attempts"] < 3:
        fail(f"{tag} SMOKE faults: {f}")
    print(f"{tag} SMOKE card == CPU: dense "
          f"{got['card']['dense']['gen_tokens']} tokens in "
          f"{got['card']['dense']['decode_dispatches']} "
          f"dispatches; paged hwm {got['card']['paged']['kv_pages_hwm']}; "
          f"faults: checkpointed {f['checkpointed_uids']}, replayed "
          f"{f['replayed_uids']}, retries {f['retry_attempts']}, "
          f"checkpoints {f['checkpoints']}; multimodel swaps "
          f"{got['card']['multimodel']['model_swaps']}")

    full_trace = poisson_trace(4.0, 4.0, seed=SEED + 5,
                               prompt=LengthDist(256, cv=0.5, max_len=700),
                               gen=LengthDist(64, cv=0.3, max_len=120))
    fkw = dict(n_lanes=8, max_len=1024, dispatch_n=8, page_size=16,
               seed=SEED)
    reg = MetricsRegistry()
    tracer = SpanTracer(registry=reg)
    t0 = time.perf_counter()
    real = run_trace_on_engine(full_trace, cfg, params, paged=True,
                               tracer=tracer, registry=reg, device=dev,
                               **fkw)
    replay_s = time.perf_counter() - t0
    sim = predict_replay(full_trace, n_lanes=8, max_len=1024, dispatch_n=8,
                         paged=True, page_size=16)
    rep = calibrate_replay(real, sim, spans=tracer.spans)
    print(f"{tag} full width: {len(full_trace)} requests, "
          f"{real.prompt_tokens} prompt and {real.gen_tokens} generated "
          f"tokens in {replay_s:.3f}s; calibrate_replay "
          f"{json.dumps(rep.as_dict())} ({gpu_line()})")
    if not rep.ok:
        fail(f"{tag} the scheduling model drifted from the replay: "
             f"{rep.as_dict()}")
    flight_dir = ROOT / "build" / "flight"
    flight_dir.mkdir(parents=True, exist_ok=True)
    dump = flight_dir / "flight_node0.jsonl"
    if dump.exists():
        dump.unlink()
    t0 = time.perf_counter()
    rec = validate_recovery_exactness(full_trace, cfg, params,
                                      crash_at_dispatch=9,
                                      checkpoint_every=4,
                                      transient_dispatches=(2,),
                                      flight_dir=str(flight_dir),
                                      device=dev, **fkw)
    rec_s = time.perf_counter() - t0
    if not (rec["resume_exact"] and rec["replay_exact"]
            and rec["counts_match"] and rec["crashes"] == 1
            and rec["recovered_lanes"] >= 1
            and rec["replayed_from_prompt"] >= 1):
        fail(f"{tag} recovery is not exact at full width: {rec}")
    if not dump.is_file() or dump.stat().st_size == 0:
        fail(f"{tag} no flight dump for the crashed node at {dump}")
    t0 = time.perf_counter()
    pre = validate_preemption_exactness(full_trace, cfg, params,
                                        preempt_every=3, device=dev, **fkw)
    pre_s = time.perf_counter() - t0
    if not pre["resume_exact"] or pre["preemptions"] < 1:
        fail(f"{tag} preemption is not exact at full width: {pre}")
    print(f"{tag} full width recovery exact ({rec_s:.1f}s): crashes "
          f"{rec['crashes']}, recovered lanes {rec['recovered_lanes']}, "
          f"replayed from the prompt {rec['replayed_from_prompt']}, "
          f"retries {rec['retry_attempts']}, checkpoints "
          f"{rec['checkpoints']}, flight dump {dump.name} "
          f"({dump.stat().st_size} B); preemption exact ({pre_s:.1f}s): "
          f"{pre['preemptions']} evictions, {pre['restores']} restores, "
          f"{pre['pages_migrated']} pages")
    return {"smoke": {k: {x: y for x, y in v.items()
                          if x not in ("streams", "gen_by_uid")}
                      for k, v in got["card"].items()},
            "calibration": rep.as_dict(), "replay_s": replay_s,
            "recovery": {k: v for k, v in rec.items() if k != "mismatches"},
            "recovery_s": rec_s,
            "preemption": {k: v for k, v in pre.items()
                           if k != "mismatches"}, "preemption_s": pre_s}


# ----------------------------------------------------------------------
# the moe and vlm families at SMOKE width, and whisper-base's
# encoder-decoder
# ----------------------------------------------------------------------

#: the SMOKE configs of the moe and vlm families served CPU vs card
MOE_VLM_SMOKE = ("moonshot-v1-16b-a3b", "arctic-480b", "phi-3-vision-4.2b")


def phase_moe_vlm_smoke(dev):
    """Phase 36: the checks of phase 6 (CPU and card streams identical,
    fixed-lane and paged, greedy and at t=0.8, the replay gates and
    check) at float32 SMOKE width for moonshot (experts routed inside
    the captured decode step), arctic (experts beside a dense FFN) and
    phi-3-vision (the text decoder); K2's CUDA-core kernel on every card
    prefill, K3 (fixed-lane) and K1 (paged) in the decode.  Returns
    {arch: (fixed-lane counts, paged counts)}."""
    out = {}
    for arch in MOE_VLM_SMOKE:
        fixed, paged = phase_smoke_e2e(dev, arch=arch)
        if not (fixed["flash_attention_cc"] and
                fixed["decode_attention_lengthaware"] and
                paged["decode_attention_paged"]):
            fail(f"the float32 {arch} SMOKE serves missed a kernel of their "
                 f"path: {fixed} {paged}")
        out[arch] = (fixed, paged)
    return out


def phase_moe_quant_smoke(dev):
    """Phase 37: ``quantize_params`` of float32 SMOKE moonshot in q8_0 on
    the card: the quantized leaves are the ones the reference's rule
    picks on its stacked tree (2-D, at least 2^16 elements, first axis
    a multiple of the block: ``embed.tok`` and ``embed.head``; the
    stacked experts are 4-D, the router and shared experts 3-D), stats
    and planes bitwise the CPU port's; greedy streams over the
    dequantized weights equal CPU vs card, paged; the launcher's
    ``--arch moonshot-v1-16b-a3b --smoke --quant q8_0`` exits 0 on the
    card with the reference's ``quantized 2 weight matrices`` line."""
    import dataclasses
    import os
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant.formats import get_format
    from repro_torch.serving import (ServeEngine, dequantize_params,
                                     device_copy, quantize_params)
    from repro_torch.serving.engine import reference_leaves
    tag = "[moe quant smoke]"
    arch, fmt = "moonshot-v1-16b-a3b", "q8_0"
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    cpu = torch.device("cpu")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED), cpu)
    on_card = device_copy(cfg, params, dev)
    blk = get_format(fmt).block
    rule = sorted(path for path, _, shape in reference_leaves(params)
                  if len(shape) == 2 and int(np.prod(shape)) >= 1 << 16
                  and shape[0] % blk == 0)
    qc, sc = quantize_params(params, fmt)
    qd, sd = quantize_params(on_card, fmt)
    if rule != ["embed.head", "embed.tok"] or sorted(qd.quantized) != rule \
            or sc != sd:
        fail(f"{tag} quantized {sorted(qd.quantized)}, the rule picks "
             f"{rule}; stats CPU {sc}, card {sd}")
    for path in rule:
        differ = _planes_differ(qc.quantized[path], qd.quantized[path])
        if differ:
            fail(f"{tag} {path}: planes {differ} differ CPU vs card")
    streams = {}
    for where, p in (("cpu", dequantize_params(qc)),
                     ("cuda", dequantize_params(qd))):
        eng = ServeEngine(cfg, p, n_lanes=4, max_len=128, rng_seed=SEED + 3,
                          paged=True, page_size=16, n_pages=24, device=where)
        reqs = _requests(cfg, 10, 3, 140, 16, SEED + 1)
        eng.run(reqs)
        streams[where] = [r.generated for r in reqs]
        eng.graphs.release()
    if streams["cpu"] != streams["cuda"]:
        fail(f"{tag} streams over the dequantized weights differ CPU vs "
             f"card")
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            arch, "--smoke", "--quant", fmt, "--paged", "--page-size", "16"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    lines = res.stdout.splitlines()
    if res.returncode != 0 or not any(
            ln.startswith("quantized 2 weight matrices") for ln in lines):
        fail(f"{tag} the launch failed (exit {res.returncode}): "
             f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    print(f"{tag} {fmt}: quantized {rule} (the reference's rule on the moe "
          f"tree), planes bitwise CPU vs card, stats {sd}; "
          f"{len(streams['cpu'])}/{len(streams['cpu'])} streams equal CPU "
          f"vs card; `{' '.join(argv[2:])}` exit 0 in "
          f"{time.perf_counter() - t0:.1f}s:")
    for ln in lines:
        if ln.startswith(("quantized", "served")):
            print(f"{tag}   {ln}")
    return {"quantized": rule, "stats": sd,
            "launch": [ln for ln in lines
                       if ln.startswith(("quantized", "served"))]}


def whisper_frames(cfg, b, s_enc, seed):
    """Stub frame embeddings (b, s_enc, d) float32 and each lane's first
    decoder token, from the seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal(
        (b, s_enc, cfg.d_model)).astype(np.float32))
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(
        np.int32))
    return frames, first


def whisper_generate(model, params, enc, first, gen, n_steps, temperature,
                     dev):
    """``gen`` tokens a lane through ``Model.decode_n_steps`` in dispatches
    of ``n_steps`` from a cache over ``enc`` (budgets of ``gen``): the
    (gen, B) tokens and valid flags and the cache."""
    import torch
    from repro_torch import rng as trng
    b = first.shape[0]
    cache = model.init_cache(b, gen + 8, params=params, enc=enc)
    tok = first.to(dev)
    rem = torch.full((b,), gen, dtype=torch.int32, device=dev)
    seed = torch.arange(b, dtype=torch.int32, device=dev)
    idx = torch.zeros(b, dtype=torch.int32, device=dev)
    key = trng.PRNGKey(SEED + 5, device=dev)
    toks, valid = [], []
    for _ in range(gen // n_steps):
        t, v, tok, cache, rem, idx = model.decode_n_steps(
            params, cache, tok, key, rem, seed, idx, n_steps=n_steps,
            temperature=temperature, len_cap=gen + 7)
        toks.append(t)
        valid.append(v)
    return torch.cat(toks), torch.cat(valid), cache


def phase_whisper_smoke(dev):
    """Phase 38: float32 SMOKE whisper (2 + 2 layers, d 128) on the CPU
    and the card: ``encode`` of (3, 100, d) frames within 1e-4, then 16
    tokens a lane through ``decode_n_steps`` (dispatches of 8), greedy
    and at t=0.8: every valid token equal CPU vs card; on the card K2's
    CUDA-core kernel (float32) once an encoder layer and K3 twice a
    decoder layer a step (self- and cross-attention)."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    tag = "[whisper smoke]"
    cfg = dataclasses.replace(get_config("whisper-base", smoke=True),
                              dtype="float32")
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = model.init(torch.Generator().manual_seed(SEED), cpu)
    on_card = copy.deepcopy(params).to(dev)
    frames, first = whisper_frames(cfg, 3, 100, SEED + 21)
    gen, n_steps = 16, 8
    out = {}
    for temperature in (0.0, 0.8):
        res = {}
        for where, p in (("cpu", params), ("cuda", on_card)):
            d = cpu if where == "cpu" else dev
            reset_launch_counts()
            enc = model.encode(p, frames.to(d))
            toks, valid, _ = whisper_generate(model, p, enc, first, gen,
                                              n_steps, temperature, d)
            res[where] = (enc.cpu(), toks.cpu(), valid.cpu(),
                          launch_counts())
        err = max_err(res["cpu"][0], res["cuda"][0])
        if not err <= 1e-4:
            fail(f"{tag} encoder states differ CPU vs card: {err}")
        if not (torch.equal(res["cpu"][2], res["cuda"][2]) and torch.equal(
                res["cpu"][1][res["cpu"][2]], res["cuda"][1][res["cuda"][2]])):
            fail(f"{tag} t={temperature}: tokens differ CPU vs card")
        counts = res["cuda"][3]
        k3 = 2 * cfg.n_layers * gen
        if counts["flash_attention_cc"] != cfg.n_encoder_layers or \
                counts["decode_attention_lengthaware"] != k3:
            fail(f"{tag} launches {counts}: want K2 (cc) "
                 f"{cfg.n_encoder_layers}, K3 {k3}")
        print(f"{tag} t={temperature}: encoder states within {err:.2e} "
              f"CPU vs card, {int(res['cpu'][2].sum())} tokens equal; "
              f"card launches K2 cc {counts['flash_attention_cc']}, K3 "
              f"{counts['decode_attention_lengthaware']}")
        out[f"t{temperature}"] = {"encode_max_abs_err": err,
                                  "tokens": int(res["cpu"][2].sum())}
    return out


#: whisper-base at full width: 4 lanes of 1500 encoder frames (30 s of
#: audio), 64 greedy tokens in dispatches of 8
WHISPER_FULL = dict(b=4, s_enc=1500, gen=64, n_steps=8)
#: the reference's own bound on a decode step's log-probabilities against
#: the teacher-forced pass (tests/test_decode_consistency.py, bf16 at
#: SMOKE width, 2 lanes of 8 tokens)
WHISPER_LOGPROB_TOL = 2e-2
#: the same check in float32, where the two paths compute the same
#: numbers up to summation order: the float32 kernel tolerance
WHISPER_LOGPROB_TOL_F32 = 1e-4
#: the check in bf16 at full width: above the sound kernels' reading
#: (0.0205) and below a control's (0.0356), the tensor-core K2 with
#: Sk's tail keys left unmasked (PERF.md, whisper-base)
WHISPER_LOGPROB_TOL_BF16 = 2.8e-2


def whisper_step_check(model, params, enc, seq, full, toks):
    """``seq`` (B, T) teacher-forced through ``decode_step`` on a fresh
    cache over ``enc``: the largest |log-prob| difference of a step
    against ``full``'s (the forward's logits at that position), whether
    every step's argmax is ``toks[t]``, and the host ms of each step
    (synced)."""
    import torch
    v = model.cfg.vocab_size
    b, n = seq.shape
    cache = model.init_cache(b, n + 8, params=params, enc=enc)
    worst, same, step_ms = 0.0, True, []
    for t in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, seq[:, t])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        inc = torch.log_softmax(logits[:, :v].float(), dim=-1)
        ref = torch.log_softmax(full[:, t, :v].float(), dim=-1)
        worst = max(worst, float((inc - ref).abs().max()))
        same &= bool(torch.equal(
            torch.argmax(logits, dim=-1).to(torch.int32), toks[t]))
    return worst, same, step_ms


def phase_whisper_full(dev):
    """Phase 39: whisper-base at full width in bf16 with random weights
    from the seed, through the reference's entry points: ``encode`` of
    (4, 1500, 512) frames (K2's tensor-core kernel unmasked at Sq = Sk =
    1500, once a layer), ``init_cache(enc=...)``, 64 greedy tokens a
    lane through ``decode_n_steps`` (K3 twice a layer a step: the
    self-attention ring and the cross K/V at every lane's 1500
    positions); then the reference's check: the generated tokens,
    teacher-forced through ``forward`` (``encode`` again, then
    ``decode_forward``: K2 causal, and unmasked at Sq 64 against Sk
    1500, once a layer each) and step by step through ``decode_step`` on
    a fresh cache, each step's argmax the token ``decode_n_steps``
    generated and its log-probabilities against the forward's at that
    position.  The same weights upcast to float32 (K2's CUDA-core
    kernel, K3 in float32) hold that difference within
    ``WHISPER_LOGPROB_TOL_F32``, and bf16 within
    ``WHISPER_LOGPROB_TOL_BF16``; the bf16 forward's distance from the
    float32 one (the rounding of the serve dtype) and the reference's
    SMOKE bound ``WHISPER_LOGPROB_TOL`` are printed beside it.  Times (host clock, synced): encode,
    a decode step, the forward."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.whisper import Whisper
    tag = "[whisper full]"
    cfg = get_config("whisper-base")
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(p.numel() for p in params.parameters())
    w = WHISPER_FULL
    frames, first = whisper_frames(cfg, w["b"], w["s_enc"], SEED + 22)
    frames = frames.to(dev)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t0)

    model.encode(params, frames)                  # warm-up (cuBLAS, ...)
    reset_launch_counts()
    enc, enc_ms = synced(lambda: model.encode(params, frames))
    enc_counts = launch_counts()
    reset_launch_counts()
    (toks, valid, _), gen_ms = synced(lambda: whisper_generate(
        model, params, enc, first, w["gen"], w["n_steps"], 0.0, dev))
    gen_counts = launch_counts()
    k3 = 2 * cfg.n_layers * w["gen"]
    if enc.shape != (w["b"], w["s_enc"], cfg.d_model) or \
            not bool(torch.isfinite(enc).all()):
        fail(f"{tag} encoder states {tuple(enc.shape)} not finite")
    if enc_counts["flash_attention_mma"] != cfg.n_encoder_layers or \
            gen_counts["decode_attention_lengthaware"] != k3 or \
            not bool(valid.all()):
        fail(f"{tag} encode launched {enc_counts}, decode {gen_counts} (K3 "
             f"{k3} wanted); valid {int(valid.sum())}")
    seq = torch.cat([first.to(dev)[None], toks[:-1]]).t().contiguous()
    reset_launch_counts()
    full, fwd_ms = synced(lambda: model.forward(params, seq, frames=frames))
    fwd_counts = launch_counts()
    want_fwd = {"flash_attention_mma": 2 * cfg.n_layers
                + cfg.n_encoder_layers}
    if {k: fwd_counts[k] for k in want_fwd} != want_fwd:
        fail(f"{tag} forward launched {fwd_counts}, want {want_fwd}")
    worst, argmax_same, step_ms = whisper_step_check(model, params, enc, seq,
                                                     full, toks)
    # the float32 twin: the same (bf16) weights upcast
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = Whisper(cfg32, dev)
    src = dict(params.named_parameters())
    with torch.no_grad():
        for name, t in params32.named_parameters():
            t.copy_(src[name].float())
    enc32 = model32.encode(params32, frames)
    full32 = model32.forward(params32, seq, frames=frames)
    worst32, _, _ = whisper_step_check(model32, params32, enc32, seq, full32,
                                       toks)
    v = cfg.vocab_size
    floor = float((torch.log_softmax(full[..., :v].float(), dim=-1)
                   - torch.log_softmax(full32[..., :v], dim=-1)).abs().max())
    if not worst32 <= WHISPER_LOGPROB_TOL_F32:
        fail(f"{tag} float32: decode steps against the forward differ by "
             f"{worst32} in log-probability (tol {WHISPER_LOGPROB_TOL_F32})")
    if not worst <= WHISPER_LOGPROB_TOL_BF16 or not argmax_same:
        fail(f"{tag} bf16: decode steps against the forward differ by "
             f"{worst} in log-probability (tol {WHISPER_LOGPROB_TOL_BF16}); "
             f"argmax equal to the generated tokens: {argmax_same}")
    summary = {
        "params": n_params, "encode_ms": enc_ms,
        "decode_n_steps_ms": gen_ms,
        "decode_ms_per_step": gen_ms / w["gen"],
        "decode_step_ms_median": statistics.median(step_ms),
        "forward_ms": fwd_ms, "logprob_max_abs_diff": worst,
        "logprob_max_abs_diff_f32": worst32,
        "bf16_forward_vs_f32": floor,
        "reference_smoke_bound": WHISPER_LOGPROB_TOL,
        "tol": WHISPER_LOGPROB_TOL_BF16,
        "tol_f32": WHISPER_LOGPROB_TOL_F32,
        "launches": {"encode": enc_counts["flash_attention_mma"],
                     "decode_n_steps": gen_counts[
                         "decode_attention_lengthaware"],
                     "forward": fwd_counts["flash_attention_mma"]},
        **w}
    print(f"{tag} {cfg.name} {cfg.dtype}, {n_params / 1e6:.1f}M params: "
          f"encode {tuple(frames.shape)} {enc_ms:.2f} ms (K2 mma "
          f"{enc_counts['flash_attention_mma']} launches); {w['gen']} "
          f"tokens x {w['b']} lanes through "
          f"decode_n_steps in {gen_ms:.1f} ms ({gen_ms / w['gen']:.2f} ms a "
          f"step, eager; K3 {gen_counts['decode_attention_lengthaware']}); "
          f"forward {fwd_ms:.2f} ms (K2 mma "
          f"{fwd_counts['flash_attention_mma']}); decode steps vs the "
          f"forward, max |log-prob diff|: bf16 {worst:.3e} (tol "
          f"{WHISPER_LOGPROB_TOL_BF16}; the bf16 "
          f"forward vs the float32 one {floor:.3e}; the reference's SMOKE "
          f"bound {WHISPER_LOGPROB_TOL}), float32 {worst32:.3e} (tol "
          f"{WHISPER_LOGPROB_TOL_F32}); argmax == generated: {argmax_same}")
    del params, params32, enc, enc32, full, full32
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_whisper_timings(dev):
    """Phase 40: the attention kernels at whisper-base's shapes as
    device time per call beside their plain versions, SDPA and the
    bound: K2 bf16 unmasked at the encoder's (4, 8, 1500, 64) (~18.4
    GFLOP) and the cross-attention's (Sq 64 against Sk 1500), K3 bf16
    over the cross K/V (``WHISPER_CROSS``, every lane at 1500)."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    rows = {}
    for key, sq in (("encoder", 1500), ("cross", 64)):
        q, k, v = k2_inputs(sq, torch.bfloat16, dev, 64, 8, 8, sk=1500, b=4)
        rows[f"flash_attention_mma/{key}"] = with_bound(dict(
            _k2_row(q, k, v, 2, causal=False),
            shape=f"bf16 B 4 H 8 Hkv 8 Sq {sq} Sk 1500 D 64 unmasked"))
    q, k, v, lens = dense_inputs(torch.bfloat16, dev, full=True,
                                 **WHISPER_CROSS)
    b, hkv, s, d = k.shape
    h = q.shape[1]
    rows["decode_attention_lengthaware/cross"] = with_bound(dict(
        ms=time_ms_queued(lambda: decode_attention(q, k, v, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_ref(q, k, v, lens)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v)),
        bytes=2 * b * s * hkv * d * 2 + 2 * q.numel() * 2 + 4 * b,
        flops=4 * b * s * h * d, peak=BF16_FLOPS_PER_S,
        shape=f"bf16 q, B {b} H {h} Hkv {hkv} D {d}, S {s}, every lane "
              f"full"))
    for name, rr in rows.items():
        print(f"[time whisper] {name} ({rr['shape']}): kernel "
              f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, SDPA "
              f"{rr['library_ms']:.4f} ms, bound {rr['bound_ms']:.5f} ms "
              f"({rr['bound_by']}: {rr['bytes']} B, {rr['flops']} flop)")
    return rows


# ----------------------------------------------------------------------
# training: K2 under autograd, SMOKE CPU vs card, full width
# ----------------------------------------------------------------------

#: K2's backward cases (dtype, B, H, Hkv, Sq, Sk, D, causal, window):
#: bf16 on the tensor-core kernel at D 128 (qwen2.5-1.5b's training
#: shape, and causal Sq 1000), D 64 with a window, D 96 at a GQA group of
#: 4 and at Sq 1000, whisper-base's training shapes (the encoder unmasked
#: at 1500 x 1500, the cross-attention's 256 decoder rows unmasked over
#: 1500 frames) and hymba-1.5b's window of 1024 where it bites (S 2048,
#: H 25 over 5); float32 on the CUDA-core kernel at D 32 (the SMOKE
#: train step's shape, a group of 4 at Sq 1000, a window)
K2_BWD_CASES = (
    ("bfloat16", 8, 12, 2, 256, 256, 128, True, None),
    ("bfloat16", 1, 12, 2, 1000, 1000, 128, True, None),
    ("bfloat16", 2, 12, 2, 256, 256, 64, True, 64),
    ("bfloat16", 1, 16, 4, 256, 256, 96, True, None),
    ("bfloat16", 1, 8, 2, 1000, 1000, 96, True, None),
    ("bfloat16", 8, 8, 8, 1500, 1500, 64, False, None),
    ("bfloat16", 8, 8, 8, 256, 1500, 64, False, None),
    ("bfloat16", 1, 25, 5, 2048, 2048, 64, True, 1024),
    ("float32", 4, 4, 2, 64, 64, 32, True, None),
    ("float32", 1, 4, 1, 1000, 1000, 32, True, None),
    ("float32", 2, 4, 2, 256, 256, 32, True, 32))
#: K2's own tolerances, on each gradient's largest error over its largest
#: element (at least 1)
K2_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the SMOKE train step, CPU against card (float32): each loss, and each
#: first-step gradient leaf (L2, relative); the parameters' change over
#: three steps per leaf (relative: AdamW's first steps move a weight by
#: ~lr * sign(g), so an element whose gradient sits at float32 noise
#: steps the other way; sound runs read at most ~5e-5, the zeroed-dq/dk
#: control ~1, PERF.md has the readings)
TRAIN_SMOKE_TOL = {"loss": 1e-5, "grad": 1e-5, "update": 1e-3}
#: full width, first step: each gradient leaf with K2 against the same
#: step with the plain attention under autograd (L2, relative)
TRAIN_FULL_GRAD_TOL = 5e-2
#: the SMOKE train step's schedule: it moves the weights within 3 steps
TRAIN_SMOKE_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _zeroed_qk_fn():
    """The control: K2's Function with dq and dk replaced by zeros."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn

    class ZeroedQK(FlashAttentionFn):
        @staticmethod
        def backward(ctx, d_out):
            import torch
            dq, dk, dv, *rest = FlashAttentionFn.backward(ctx, d_out)
            return (torch.zeros_like(dq), torch.zeros_like(dk), dv, *rest)

    return ZeroedQK


def _plain_attention_fn(q, k, v, *, causal=True, window=None, scale=None):
    """The plain version under autograd (the gradient gate's baseline)."""
    from repro_torch.kernels.flash_attention import attention_ref
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def k2_bwd_inputs(dtype, b, h, hkv, sq, d, dev, sk=None):
    """q, k, v and the output's cotangent from the seed (Sk = Sq unless
    given)."""
    import numpy as np
    import torch
    sk = sq if sk is None else sk
    rng = np.random.default_rng(SEED + 7 * sq + 13 * d + h + 1000 * b
                                + 3 * (sk - sq))
    shapes = ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, h, sq, d))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        dev, getattr(torch, dtype)) for s in shapes]


def k2_grads(fn_cls, q, k, v, d_out, causal, window, with_out=False):
    """(dq, dk, dv) through ``fn_cls`` (a Function), or through the plain
    version's autograd when ``fn_cls`` is None; with ``with_out``,
    (output, (dq, dk, dv))."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    if fn_cls is None:
        out = attention_ref(qs, ks, vs, causal=causal, window=window)
    else:
        out = fn_cls.apply(qs, ks, vs, causal, window, None)
    grads = torch.autograd.grad(out, (qs, ks, vs), d_out)
    return (out.detach(), grads) if with_out else grads


def k2_bwd_err(got, want) -> float:
    return max(max_err(g, w) / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


def phase_k2_backward(dev):
    """Phase 41: K2 under autograd on the card.  The Function's forward
    is K2's launch (the counters name the arm ``kernel_for`` picks); its
    output agrees with the plain version's on the same inputs within
    K2's tolerances (bf16 also within ``k2_scaled_check``'s bound and
    scale), and its dq, dk and dv agree with autograd through the plain
    version on the card within them, at ``K2_BWD_CASES`` (the first is
    the training path's shape: the backward recomputes P from q, k and
    v and never reads the forward's output, so the output is held on its
    own); at every case a control whose backward zeroes dq and dk fails
    the same gate.  Then fwd+bwd
    at qwen2.5-1.5b's training shape (B 8, H 12 over 2, S 256, D 128,
    causal, bf16) beside the plain version's autograd and SDPA's, and
    the backward alone.  Returns {kernel: {dtype: (worst, tol)}} with
    the timings under ``"timing"`` and the control under ``"control"``."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels import launch_counts, launch_delta
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     attention_backward,
                                                     attention_ref)
    from repro_torch.kernels.flash_attention.ops import kernel_for
    errs = {}
    ctrl = None
    for dtype, b, h, hkv, sq, sk, d, causal, window in K2_BWD_CASES:
        q, k, v, d_out = k2_bwd_inputs(dtype, b, h, hkv, sq, d, dev, sk)
        kernel = f"flash_attention_{kernel_for(q.dtype, d)}"
        before = launch_counts()
        out, got = k2_grads(FlashAttentionFn, q, k, v, d_out, causal,
                            window, with_out=True)
        ran = launch_delta(before, launch_counts())
        plain, want = k2_grads(None, q, k, v, d_out, causal, window,
                               with_out=True)
        err, tol = k2_bwd_err(got, want), K2_BWD_TOL[dtype]
        fwd_err = max_err(out, plain)
        ctrl_err = k2_bwd_err(k2_grads(_zeroed_qk_fn(), q, k, v, d_out,
                                       causal, window), want)
        print(f"[K2 bwd] {dtype} B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} "
              f"D={d} causal={causal} window={window}: forward {ran}, "
              f"output max_abs_err {fwd_err:.3e} (tol {tol}), dq/dk/dv err "
              f"{err:.3e} (tol {tol}, over max(1, max|grad|)); control "
              f"(dq, dk zeroed) {ctrl_err:.3e}")
        if ctrl_err <= tol:
            fail(f"the zeroed-dq/dk control passed K2's backward gate at "
                 f"{dtype} Sq={sq} Sk={sk} D={d}: {ctrl_err}")
        ctrl = ctrl_err if ctrl is None else min(ctrl, ctrl_err)
        if ran != {kernel: 1}:
            fail(f"K2's Function at {dtype} D={d} launched {ran}, not "
                 f"{kernel} once")
        if not fwd_err <= tol:
            fail(f"K2's Function forward {dtype} B={b} S={sq} D={d} "
                 f"window={window} disagrees with the plain version: "
                 f"{fwd_err}")
        if dtype == "bfloat16":
            k2_scaled_check(errs, "train", out, q, k, v, kernel,
                            causal=causal, window=window, key="fwd ")
            errs[kernel].setdefault("cases", []).append({
                "shape": f"B {b} H {h} Hkv {hkv} Sq {sq} Sk {sk} D {d} "
                         f"causal={causal} window={window}",
                "forward_max_abs_err": fwd_err, "backward_err": err,
                "control_err": ctrl_err})
        worst = errs.setdefault(kernel, {}).get("fwd " + dtype,
                                                (0.0, tol))[0]
        errs[kernel]["fwd " + dtype] = (max(worst, fwd_err), tol)
        if not err <= tol:
            fail(f"K2's backward {dtype} S={sq} D={d} window={window} "
                 f"disagrees with the plain autograd: {err}")
        worst = errs.setdefault(kernel, {}).get(dtype, (0.0, tol))[0]
        errs[kernel][dtype] = (max(worst, err), tol)
    dtype, b, h, hkv, sq, sk, d, causal, window = K2_BWD_CASES[0]
    q, k, v, d_out = k2_bwd_inputs(dtype, b, h, hkv, sq, d, dev)
    print(f"[K2 bwd] control (dq, dk zeroed): smallest err over the cases "
          f"{ctrl:.3e} against tol {K2_BWD_TOL[dtype]}")

    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd(forward):
        return lambda: torch.autograd.grad(forward(), (qs, ks, vs), d_out)

    timing = {
        "shape": f"bf16 B {b} H {h} Hkv {hkv} S {sq} D {d} causal",
        "backward_ms": time_ms(lambda: attention_backward(
            q, k, v, d_out, causal=causal)),
        "fwd_bwd_ms": time_ms(fwd_bwd(lambda: FlashAttentionFn.apply(
            qs, ks, vs, causal, None, None))),
        "plain_fwd_bwd_ms": time_ms(fwd_bwd(lambda: attention_ref(
            qs, ks, vs, causal=causal))),
        "library_fwd_bwd_ms": time_ms(fwd_bwd(
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True)))}
    print(f"[K2 bwd] timing at {timing['shape']}: backward "
          f"{timing['backward_ms']:.4f} ms; forward+backward "
          f"{timing['fwd_bwd_ms']:.4f} ms, plain autograd "
          f"{timing['plain_fwd_bwd_ms']:.4f} ms, SDPA "
          f"{timing['library_fwd_bwd_ms']:.4f} ms")
    errs["timing"] = timing
    errs["control"] = (ctrl, K2_BWD_TOL[dtype])
    return errs


def _leaf_rel(a, b) -> float:
    import torch
    den = float(torch.linalg.vector_norm(b.double()))
    return float(torch.linalg.vector_norm((a - b).double())) / max(den,
                                                                   1e-30)


def _zeroed_k10_fn(every=False):
    """A control: K10's Function with dx replaced by zeros, or with
    ``every`` all five gradients (the model-level control: at
    initialisation dt ~ 0.01 keeps the scan's share of dx near 1% of the
    D skip's, while A's and dt's gradients come through the scan
    alone)."""
    from repro_torch.kernels.ssd_scan import SSDChunkFn

    class Zeroed(SSDChunkFn):
        @staticmethod
        def backward(ctx, d_y, d_states, d_decay):
            import torch
            grads = list(SSDChunkFn.backward(ctx, d_y, d_states, d_decay))
            for i in range(5 if every else 1):
                if grads[i] is not None:
                    grads[i] = torch.zeros_like(grads[i])
            return tuple(grads)

    return Zeroed


def _plain_scan_fn(x, dt, a, b, c, *, chunk):
    """K10's plain version under autograd (the gradient gate's
    baseline)."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_ref
    return ssd_chunk_ref(x, dt, a, b, c, chunk)


def _through(plain_out, kernel_out):
    """``kernel_out``'s values (exactly: ``plain - plain`` is 0) with
    ``plain_out``'s gradient."""
    return plain_out - plain_out.detach() + kernel_out


def _plain_bwd_attention_fn(q, k, v, *, causal=True, window=None,
                            scale=None):
    """The plain version's autograd through K2's forward values: the
    full-width gradient gate's baseline, which differs from the
    Function only in its backward."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    out = flash_attention(q.detach(), k.detach(), v.detach(), causal=causal,
                          window=window, scale=scale)
    return _through(attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale), out)


def _plain_bwd_scan_fn(x, dt, a, b, c, *, chunk):
    """The plain version's autograd through K10's forward values."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
    outs = ssd_chunk(*(t.detach() for t in (x, dt, a, b, c)), chunk=chunk)
    return tuple(_through(p, o) for p, o in
                 zip(ssd_chunk_ref(x, dt, a, b, c, chunk), outs))


@contextlib.contextmanager
def routes_recorded(routes):
    """Each moe layer's expert ids (t, k), appended to ``routes`` as the
    model routes (a remat recompute appends again)."""
    import torch
    from repro_torch.models import moe as moe_mod
    inner = moe_mod._moe_tokens

    def recording(p, x, moe):
        with torch.no_grad():
            logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                                  p.router.float())
            ids = torch.topk(torch.softmax(logits, -1), moe.top_k)[1]
            routes.append(torch.sort(ids, dim=-1)[0])
        return inner(p, x, moe)

    moe_mod._moe_tokens = recording
    try:
        yield
    finally:
        moe_mod._moe_tokens = inner


def _control_fns(kind):
    """(attend, scan) of a control: ``"k2"`` K2's Function with dq and dk
    zeroed, ``"k10"`` K10's with every gradient zeroed."""
    if kind == "k2":
        zeroed = _zeroed_qk_fn()
        return (lambda q, k, v, **kw: zeroed.apply(
            q, k, v, kw.get("causal", True), kw.get("window"), None)), None
    zeroed = _zeroed_k10_fn(every=True)
    return None, (lambda x, dt, a, b, c, *, chunk: zeroed.apply(
        x, dt, a, b, c, chunk))


@contextlib.contextmanager
def functions_swapped(attend=None, scan=None):
    """The model's training Functions replaced, for a baseline or a
    control: ``attend`` for K2's (every attention: the decoders', and
    whisper's encoder, self- and cross-attention), ``scan`` for K10's
    (the SSD's intra-chunk pass); None keeps the Function."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import whisper as whisper_mod
    sites = []
    if attend is not None:
        sites += [(attn_mod, "flash_attention_fn", attend),
                  (whisper_mod, "flash_attention_fn", attend)]
    if scan is not None:
        sites.append((ssd_ops, "ssd_chunk_fn", scan))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    try:
        for mod, name, fn in sites:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_batch(dc, step, cfg, s_enc=None):
    """The pipeline's batch of ``step`` (numpy); an encoder-decoder's
    also holds seeded random frames (B, S_enc, d) float32, S_enc the
    sequence length unless given."""
    import numpy as np
    from repro_torch.data import synth_batch
    batch = synth_batch(dc, step)
    if cfg.is_encdec:
        rng = np.random.default_rng(SEED + 1000 + step)
        batch["frames"] = rng.standard_normal(
            (dc.global_batch, s_enc or dc.seq_len, cfg.d_model),
            dtype=np.float32)
    return batch


def train_launches(cfg, passes):
    """K2's and K10's launches in ``passes`` forward passes of ``cfg``'s
    training loss (each (micro)batch's forward, and remat's recompute):
    one K2 a self-attention (a decoder block with attention; whisper's
    encoder, decoder and cross-attention) and one K10 an ssm or hybrid
    block, the K2 arm the one ``kernel_for`` picks."""
    import torch
    from repro_torch.kernels.flash_attention.ops import kernel_for
    k2 = (cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.is_encdec
          else 0 if cfg.attn_free else cfg.n_layers)
    k10 = cfg.n_layers if cfg.has_ssm or cfg.attn_free else 0
    want = {}
    if k2:
        name = f"flash_attention_{kernel_for(cfg.compute_dtype, cfg.hd)}"
        want[name] = k2 * passes
    if k10:
        want["ssd_chunk"] = k10 * passes
    return want


#: the SMOKE training phase's configs and the control each runs (K2's
#: zeroed dq/dk, K10's zeroed dx, or none)
TRAIN_SMOKE_ARCHS = {"qwen2.5-1.5b": "k2", "moonshot-v1-16b-a3b": None,
                     "arctic-480b": None, "mamba2-780m": "k10",
                     "hymba-1.5b": None, "whisper-base": None}


def phase_train_smoke(dev, arch="qwen2.5-1.5b"):
    """Phases 42 and 45: SMOKE ``arch`` in float32, ``make_train_step``
    on the CPU and on the card from one state, 3 steps at remat off and
    on, microbatches 1 and 2 (f32 moments): losses, first-step gradients
    and the parameters' change per leaf within ``TRAIN_SMOKE_TOL``; the
    card's steps launch exactly ``train_launches``: K2's CUDA-core
    kernel once a self-attention a microbatch and K10's float32 arm
    once an ssm or hybrid block (twice each with remat), and nothing
    else of either.  The control ``TRAIN_SMOKE_ARCHS`` names (remat off,
    one microbatch, on the card: K2's backward with dq and dk zeroed,
    or K10's with every gradient zeroed) must fail the gradient and
    update gates.
    whisper-base's batches carry seeded frames as long as its tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.checkpoint import (empty_train_state, load_train_state,
                                        train_state_to_numpy)
    from repro_torch.data import DataConfig
    from repro_torch.kernels import launch_counts, launch_delta
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.train_loop import batch_to_device
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    start = {n: (a, dt) for n, a, dt in train_state_to_numpy(
        init_train_state(build_model(cfg),
                         torch.Generator().manual_seed(SEED), cpu))}
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    def run(where, tcfg, control=None):
        attend, scan = _control_fns(control) if control else (None, None)
        with functions_swapped(attend, scan):
            state = load_train_state(empty_train_state(cfg, where), start)
            step = make_train_step(cfg, tcfg)
            _, g0 = step.grads_of(state.params, batch_to_device(
                train_batch(dc, 0, cfg), where))
            before = launch_counts()
            losses = []
            for i in range(3):
                state, m = step(state, train_batch(dc, i, cfg))
                losses.append(float(m["loss"]))
            ran = launch_delta(before, launch_counts())
        return (losses, {n: g.cpu() for n, g in g0.items()},
                {n: torch.from_numpy(a.astype("float64"))
                 for n, a, _ in train_state_to_numpy(state)}, ran)

    def readings(cpu_run, dev_run):
        (l_cpu, g_cpu, s_cpu, _), (l_dev, g_dev, s_dev, _) = cpu_run, dev_run
        grad = {n: _leaf_rel(g_dev[n], g_cpu[n]) for n in g_cpu}
        update = {n: _leaf_rel(s_dev[n] - start[n][0].astype("float64"),
                               s_cpu[n] - start[n][0].astype("float64"))
                  for n in s_cpu if n.startswith(".params/")}
        return {
            "loss": max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_dev)),
            "grad": max(grad.values()),
            "update": max(update.values()),
            "leaf": max(_leaf_rel(s_dev[n], s_cpu[n]) for n in s_cpu),
            "grad_leaf": max(grad, key=grad.get),
            "update_leaf": max(update, key=update.get)}

    t0 = time.perf_counter()
    control = TRAIN_SMOKE_ARCHS[arch]
    out = {}
    for remat, mb in ((False, 1), (True, 1), (False, 2), (True, 2)):
        tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_SMOKE_OPT),
                           remat=remat, microbatches=mb)
        cpu_run, dev_run = run(cpu, tcfg), run(dev, tcfg)
        (l_cpu, _, _, _), (l_dev, _, _, ran) = cpu_run, dev_run
        r = readings(cpu_run, dev_run)
        loss_err, grad_err, upd_err, param_err = (
            r["loss"], r["grad"], r["update"], r["leaf"])
        if (remat, mb) == (False, 1) and control:
            ctrl = readings(cpu_run, run(dev, tcfg, control))
            what = ("dq, dk zeroed" if control == "k2" else
                    "K10's gradients zeroed")
            print(f"[train smoke {arch}] control ({what} on the card), "
                  f"remat=False microbatches=1: loss rel "
                  f"{ctrl['loss']:.3e}, first-step grad rel "
                  f"{ctrl['grad']:.3e}, update rel {ctrl['update']:.3e} "
                  f"(tols {TRAIN_SMOKE_TOL})")
            for key in ("grad", "update"):
                if ctrl[key] <= TRAIN_SMOKE_TOL[key]:
                    fail(f"the {what} control passed {arch}'s SMOKE "
                         f"training {key} gate: {ctrl[key]}")
            out["control"] = ctrl
        want = train_launches(cfg, 3 * mb * (2 if remat else 1))
        tag = f"remat={remat} microbatches={mb}"
        print(f"[train smoke {arch}] {tag}: losses cpu {l_cpu} card "
              f"{l_dev}; loss rel {loss_err:.3e}, first-step grad rel "
              f"{grad_err:.3e} ({r['grad_leaf']}), update rel "
              f"{upd_err:.3e} ({r['update_leaf']}), leaf rel "
              f"{param_err:.3e}; card launches {ran}")
        if ran != want:
            fail(f"{arch}'s SMOKE train steps ({tag}) launched {ran}, not "
                 f"{want}")
        for key, err in (("loss", loss_err), ("grad", grad_err),
                         ("update", upd_err)):
            if not err <= TRAIN_SMOKE_TOL[key]:
                fail(f"{arch} SMOKE training {tag}: {key} CPU vs card "
                     f"{err} > {TRAIN_SMOKE_TOL[key]}")
        out[tag] = {"losses_cpu": l_cpu, "losses_card": l_dev,
                    "loss_rel": loss_err, "grad_rel": grad_err,
                    "update_rel": upd_err, "leaf_rel": param_err,
                    "grad_leaf": r["grad_leaf"],
                    "update_leaf": r["update_leaf"], "launches": ran}
    out["phase_s"] = time.perf_counter() - t0
    return out


def _grads_with(step, params, batch, attend=None, scan=None):
    """First-step gradients with ``attend`` standing in for K2's Function
    and ``scan`` for K10's (None: the Function itself)."""
    with functions_swapped(attend, scan):
        return step.grads_of(params, batch)[1]


def phase_train_full(dev):
    """Phase 43: qwen2.5-1.5b at full width in bf16 from seed 0, with the
    launcher's defaults (batch 8, seq 256, remat, AdamW warmup 20 over
    30 steps): the first step's gradients with K2 against the same step
    with the plain attention under autograd (and the zeroed-dq/dk
    control against the same), 30 steps with a checkpoint at step 15,
    then a restart from it (the launcher's init and ``restore_latest``)
    to step 30.  Gates: every gradient leaf within
    ``TRAIN_FULL_GRAD_TOL`` and the control beyond it; losses finite and
    falling; the restarted losses equal the uninterrupted ones (bitwise
    or within 1e-5 relative); K2's tensor-core kernel 56 launches a
    step.  Prints the median step, tokens/s, the optimizer's and K2's
    backward ms a step, and peak memory."""
    import math
    import shutil
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataLoader, synth_batch
    from repro_torch.kernels import (launch_counts, launch_delta,
                                     reset_launch_counts)
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     attention_backward)
    from repro_torch.launch.train import SEED as TRAIN_SEED
    from repro_torch.launch.train import parse_args, train_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_update
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.train_loop import batch_to_device
    t_phase = time.perf_counter()
    args = parse_args(["--arch", "qwen2.5-1.5b", "--steps", "30"])
    cfg = get_config(args.arch)
    model = build_model(cfg)
    tcfg = train_config(args)
    ck_step = 15
    per_step = 2 * cfg.n_layers        # forward and remat's recompute
    step = make_train_step(cfg, tcfg)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    batch0 = batch_to_device(synth_batch(dc, 0), dev)
    g_plain = _grads_with(step, state.params, batch0, _plain_attention_fn)
    reading = {}
    for tag, attend in (("k2", None), ("control", _control_fns("k2")[0])):
        g = _grads_with(step, state.params, batch0, attend)
        errs = {n: _leaf_rel(g[n], g_plain[n]) for n in g_plain}
        worst = max(errs, key=errs.get)
        reading[tag] = (errs[worst], worst)
        del g
    del g_plain
    print(f"[train full] first-step gradients against the plain attention "
          f"under autograd: K2 worst leaf {reading['k2'][1]} rel "
          f"{reading['k2'][0]:.3e}; control (dq, dk zeroed) worst "
          f"{reading['control'][1]} rel {reading['control'][0]:.3e}; tol "
          f"{TRAIN_FULL_GRAD_TOL}")
    if not reading["k2"][0] <= TRAIN_FULL_GRAD_TOL:
        fail(f"full-width gradients with K2 disagree with the plain "
             f"attention's: {reading['k2']}")
    if reading["control"][0] <= TRAIN_FULL_GRAD_TOL:
        fail(f"the zeroed-dq/dk control passed the full-width gradient "
             f"gate: {reading['control']}")

    ckdir = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = AsyncCheckpointer(str(ckdir))
    loader = DataLoader(dc, start_step=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs = [], []
    try:
        for i, batch in zip(range(args.steps), loader):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if i + 1 == ck_step:
                t0 = time.perf_counter()
                ck.save(ck_step, state)
                save_host_s = time.perf_counter() - t0
    finally:
        loader.close()
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    ck.close()
    write_wait_s = time.perf_counter() - t0
    ran = {n: c for n, c in counts.items() if c}
    if ran != {"flash_attention_mma": per_step * args.steps}:
        fail(f"the full-width train run launched {ran}, not "
             f"{per_step * args.steps} of flash_attention_mma")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite full-width losses: {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        fail(f"full-width losses did not fall: {losses}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
    got, state = restore_latest(str(ckdir), state)
    restore_s = time.perf_counter() - t0
    if got != ck_step:
        fail(f"restore_latest found step {got}, not {ck_step}")
    loader = DataLoader(dc, start_step=ck_step)
    before = launch_counts()
    resumed = []
    try:
        for i, batch in zip(range(ck_step, args.steps), loader):
            state, m = step(state, batch)
            resumed.append(float(m["loss"]))
    finally:
        loader.close()
    ran2 = launch_delta(before, launch_counts())
    tail = losses[ck_step:]
    bitwise = resumed == tail
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, tail))
    if ran2 != {"flash_attention_mma": per_step * (args.steps - ck_step)}:
        fail(f"the restarted run launched {ran2}")
    if not resume_err <= 1e-5:
        fail(f"the restarted losses differ from the uninterrupted run's: "
             f"{resumed} vs {tail}")

    _, grads = step.grads_of(state.params,
                             batch_to_device(synth_batch(dc, args.steps),
                                             dev))
    opt_ms = time_ms(lambda: adamw_update(tcfg.optimizer, state.params,
                                          grads, state.opt),
                     warmup=1, iters=3)
    del grads, state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    shape = (args.batch, cfg.n_heads, cfg.n_kv_heads, args.seq, cfg.hd)
    q, k, v, d_out = k2_bwd_inputs("bfloat16", *shape, dev)
    bwd_ms = time_ms(lambda: attention_backward(q, k, v, d_out,
                                                causal=True))
    fwd_ms = time_ms(lambda: FlashAttentionFn.apply(q, k, v, True, None,
                                                    None))
    step_ms = 1e3 * statistics.median(secs[3:])
    # the writer thread shares the host with the steps after the save
    step_ms_before = 1e3 * statistics.median(secs[3:ck_step])
    out = {
        "gpu": gpu_line(), "batch": args.batch, "seq": args.seq,
        "steps": args.steps, "remat": tcfg.remat,
        "grad_rel_k2": reading["k2"], "grad_rel_control":
            reading["control"], "grad_tol": TRAIN_FULL_GRAD_TOL,
        "losses": losses, "loss_first3": first, "loss_last3": last,
        "resumed_losses": resumed, "resume_bitwise": bitwise,
        "resume_max_rel": resume_err,
        "launches": ran, "launches_resumed": ran2,
        "launches_per_step": per_step,
        "step_ms_median": step_ms, "step_ms_median_before_ckpt":
            step_ms_before, "step_ms": [1e3 * s for s in secs],
        "tok_s": args.batch * args.seq / (step_ms / 1e3),
        "optimizer_ms": opt_ms,
        "k2_backward_ms_per_call": bwd_ms,
        "k2_backward_ms_per_step": cfg.n_layers * bwd_ms,
        "k2_forward_ms_per_call": fwd_ms,
        "k2_forward_ms_per_step": per_step * fwd_ms,
        "peak_gib": peak_gib, "ckpt_host_copy_s": save_host_s,
        "ckpt_write_wait_s": write_wait_s, "restore_s": restore_s,
        "phase_s": time.perf_counter() - t_phase}
    print(f"[train full] {out['gpu']}: losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of first 3 {first:.4f}, last 3 "
          f"{last:.4f}); restart from step {ck_step}: losses "
          f"{'bitwise equal' if bitwise else 'not bitwise'} (max rel "
          f"{resume_err:.3e}); median step {step_ms:.2f} ms after 3 warm "
          f"steps ({step_ms_before:.2f} before the checkpoint's writer "
          f"starts), {out['tok_s']:,.0f} tok/s, optimizer {opt_ms:.2f} ms a "
          f"step, K2 backward {out['k2_backward_ms_per_step']:.2f} ms a "
          f"step ({bwd_ms:.4f} a layer), K2 forward "
          f"{out['k2_forward_ms_per_step']:.2f} ms a step, peak "
          f"{peak_gib:.2f} GiB; checkpoint: host copy {save_host_s:.1f} s, "
          f"write waited {write_wait_s:.1f} s, restore {restore_s:.1f} s")
    return out


# ----------------------------------------------------------------------
# training, the other families: K10 under autograd, SMOKE CPU vs card,
# full width
# ----------------------------------------------------------------------

#: K10's backward cases (dtype, B, S, (H, P, N), chunk): mamba2-780m's
#: training shape (bf16 x/b/c, B 8, S 256, one chunk of 256),
#: hymba-1.5b's (H 50, N 16), and float32 at SMOKE mamba2's widths
K10_BWD_CASES = (
    ("bfloat16", 8, 256, (SSD_H, SSD_P, SSD_N), SSD_Q),
    ("bfloat16", 8, 256, HYMBA_SSD, SSD_Q),
    ("float32", 4, 64, SMOKE_SSD[:3], SMOKE_SSD[3]))
#: the full SSD (``ssd``) at a length it pads to the chunk: S 1000 to
#: 1024 at chunk 256, mamba2-780m's widths, bf16
K10_BWD_PADDED = ("bfloat16", 2, 1000, (SSD_H, SSD_P, SSD_N), SSD_Q)
#: K10's gradients against autograd through its plain version on the
#: card, each gradient's L2 error over its L2 norm: the Function's
#: backward differentiates a float32 recompute of the plain version,
#: so a sound reading sits at rounding level
K10_BWD_TOL = 1e-5


def k10_bwd_case(dname, bsz, s, widths, chunk, dev):
    """Tracked K10 inputs (x/b/c in ``dname``, dt and a float32) and
    cotangents for the three outputs, from the seed."""
    import torch
    dtype = getattr(torch, dname)
    ins = [t.detach().requires_grad_()
           for t in k10_inputs(bsz, s, dtype, "model", dev, seed=SEED + 5,
                               widths=widths)]
    h, p, n = widths
    nc = s // min(chunk, s)
    g = torch.Generator(device=dev).manual_seed(SEED + 17 * s + h)
    cots = [torch.randn(shape, device=dev, generator=g) for shape in (
        (bsz, s, h, p), (bsz, nc, h, n, p), (bsz, nc, h))]
    return ins, cots


def k10_grads(fn, ins, cots, chunk):
    """(outputs, gradients of the five inputs) through ``fn`` (K10's
    Function or a control class; None: the plain version's autograd)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_chunk_ref
    leaves = [t.detach().requires_grad_() for t in ins]
    outs = (ssd_chunk_ref(*leaves, chunk) if fn is None
            else fn.apply(*leaves, chunk))
    grads = torch.autograd.grad(outs, leaves, cots)
    return [o.detach() for o in outs], grads


def k10_bwd_err(got, want) -> float:
    return max(_leaf_rel(g, w) for g, w in zip(got, want))


def phase_k10_backward(dev):
    """Phase 44: K10 under autograd (``SSDChunkFn``) on the card.  Its
    forward is one launch of K10's arm for the dtype and its outputs
    agree with the plain version's within ``K10_TOL`` (relative max);
    its dx, ddt, da, db and dc (every output's cotangent live) agree
    with autograd through the plain version on the card within
    ``K10_BWD_TOL`` at ``K10_BWD_CASES``, and so do the full SSD's at a
    padded length; a control whose backward zeroes dx fails the gate at
    every case.  Then the backward alone and forward + backward at
    mamba2-780m's training shape, beside the plain version's autograd.
    Returns the readings and the timings."""
    import torch
    from repro_torch.kernels import launch_counts, launch_delta
    from repro_torch.kernels.ssd_scan import (SSDChunkFn, ssd, ssd_chunked,
                                              ssd_chunk_ref)
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk_backward
    t0 = time.perf_counter()
    zeroed = _zeroed_k10_fn()
    out = {"cases": [], "tol": K10_BWD_TOL, "fwd_tol": K10_TOL}
    for dname, bsz, s, widths, chunk in K10_BWD_CASES:
        ins, cots = k10_bwd_case(dname, bsz, s, widths, chunk, dev)
        before = launch_counts()
        outs, got = k10_grads(SSDChunkFn, ins, cots, chunk)
        ran = launch_delta(before, launch_counts())
        plain, want = k10_grads(None, ins, cots, chunk)
        fwd = max(rel_err(o, w) for o, w in zip(outs, plain))
        err = k10_bwd_err(got, want)
        ctrl = k10_bwd_err(k10_grads(zeroed, ins, cots, chunk)[1], want)
        dtypes = [str(g.dtype).split(".")[-1] for g in got]
        tag = f"{dname} B={bsz} S={s} (H, P, N)={widths} Q={chunk}"
        print(f"[K10 bwd] {tag}: forward {ran}, outputs rel max err "
              f"{fwd:.3e} (tol {K10_TOL}); dx/ddt/da/db/dc ({dtypes}) L2 "
              f"rel err {err:.3e} (tol {K10_BWD_TOL}); control (dx "
              f"zeroed) {ctrl:.3e}")
        if ran != {"ssd_chunk": 1}:
            fail(f"K10's Function at {tag} launched {ran}, not K10 once")
        if not fwd <= K10_TOL:
            fail(f"K10's Function forward at {tag} disagrees with the "
                 f"plain version: {fwd}")
        if dtypes != [dname, "float32", "float32", dname, dname]:
            fail(f"K10's gradients at {tag} came back in {dtypes}")
        if not err <= K10_BWD_TOL:
            fail(f"K10's backward at {tag} disagrees with the plain "
                 f"autograd: {err}")
        if ctrl <= K10_BWD_TOL:
            fail(f"the dx-zeroed control passed K10's backward gate at "
                 f"{tag}: {ctrl}")
        out["cases"].append({"shape": tag, "forward_rel_err": fwd,
                             "backward_rel_err": err, "control_err": ctrl})
    dname, bsz, s, widths, chunk = K10_BWD_PADDED
    ins, _ = k10_bwd_case(dname, bsz, s, widths, chunk, dev)
    cot = torch.randn(ins[0].shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED + s))
    grads = []
    for full in (ssd, ssd_chunked):
        leaves = [t.detach().requires_grad_() for t in ins]
        before = launch_counts()
        y = full(*leaves, chunk=chunk)
        grads.append(torch.autograd.grad(y, leaves, cot))
        if full is ssd:
            ran = launch_delta(before, launch_counts())
    padded = k10_bwd_err(*grads)
    print(f"[K10 bwd] full SSD, {dname} B={bsz} S={s} padded to the chunk "
          f"{chunk}: launches {ran}, gradients against ssd_chunked's "
          f"autograd L2 rel err {padded:.3e} (tol {K10_BWD_TOL})")
    if ran != {"ssd_chunk": 1} or not padded <= K10_BWD_TOL:
        fail(f"the full SSD's gradients at S {s}: launches {ran}, err "
             f"{padded}")
    out["padded_rel_err"] = padded
    out["control_err_min"] = min(c["control_err"] for c in out["cases"])
    out["max_backward_rel_err"] = max(c["backward_rel_err"]
                                      for c in out["cases"] + [
                                          {"backward_rel_err": padded}])

    dname, bsz, s, widths, chunk = K10_BWD_CASES[0]
    ins, cots = k10_bwd_case(dname, bsz, s, widths, chunk, dev)
    leaves = [t.detach().requires_grad_() for t in ins]

    def fwd_bwd(forward):
        return lambda: torch.autograd.grad(forward(), leaves, cots)

    timing = {
        "shape": f"{dname} B {bsz} S {s} H {widths[0]} P {widths[1]} "
                 f"N {widths[2]} chunk {chunk}",
        "backward_ms": time_ms(lambda: ssd_chunk_backward(
            *ins, chunk, *cots)),
        "fwd_bwd_ms": time_ms(fwd_bwd(lambda: SSDChunkFn.apply(
            *leaves, chunk))),
        "plain_fwd_bwd_ms": time_ms(fwd_bwd(lambda: ssd_chunk_ref(
            *leaves, chunk)))}
    print(f"[K10 bwd] timing at {timing['shape']}: backward "
          f"{timing['backward_ms']:.4f} ms; forward+backward "
          f"{timing['fwd_bwd_ms']:.4f} ms, plain autograd "
          f"{timing['plain_fwd_bwd_ms']:.4f} ms (no library call)")
    out["timing"] = timing
    out["phase_s"] = time.perf_counter() - t0
    return out


#: full-width training per family: (arch, layers kept (None: all), the
#: control, the step of the restart's checkpoint (None: no restart))
TRAIN_FAMILIES_FULL = (("mamba2-780m", None, "k10", 4),
                       ("hymba-1.5b", None, "k10", None),
                       ("whisper-base", None, "k2", None),
                       ("moonshot-v1-16b-a3b", 2, "k2", None))
#: steps of each family's full-width run, at the launcher's batch and
#: length; whisper's frames are (B, 1500, 512)
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 8, 8, 256
WHISPER_FRAMES = 1500


def phase_train_family_full(dev, arch, layers, control, ck_step):
    """Phase 46: ``arch`` at its published widths (``layers`` of them when
    cut, said where it prints) in bf16 over float32 masters and moments
    from seed 0, batch 8, seq 256, remat, the launcher's learning rate
    (3e-4) warmed up over 2 steps and decayed over 8 (the launcher's 20
    warm-up steps would keep 8 steps' rates below 1.2e-4), synthetic
    Zipf tokens (whisper: seeded
    random frames (8, 1500, 512) beside them).  Gates: the first step's
    gradients with K2 and K10 against the same step with both plain
    versions' autograd through the kernels' forward values, every leaf
    within ``TRAIN_FULL_GRAD_TOL``, and the ``control`` (K2's dq/dk or
    K10's gradients zeroed) beyond it (against the plain versions end to
    end, forward too, the reading is printed and not gated: in bf16 a
    forward's last-bit differences reach the gradients of the SSM's A and
    dt bias, whose sums cancel, and move a moe's near-tied routes; a
    plain twin with half-length SSD chunks and the share of tokens whose
    experts differ show it); 8
    steps with finite, falling losses; exactly ``train_launches`` a
    step (2 a layer with remat).  With ``ck_step``, a checkpoint there
    and a restart from it (``restore_latest``) to step 8, whose losses
    equal the uninterrupted ones (bitwise or within 1e-5 relative); the
    moe run also takes its first-step gradients twice, which must be
    bitwise equal (the dispatch's backward has no atomics).  Prints the
    median step after 3 warm, tokens/s, the optimizer's ms and peak
    memory."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, restore_latest
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import SEED as TRAIN_SEED
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.train_loop import batch_to_device
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    cut = ""
    if layers is not None:
        cut = (f", cut from {cfg.n_layers} layers to {layers} (the whole "
               f"model's training state does not fit one card)")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    steps = TRAIN_FAMILY_STEPS
    model = build_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=2,
                                             total_steps=steps), remat=True)
    step = make_train_step(cfg, tcfg)
    per_step = train_launches(cfg, 2)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"[train full {arch}] {n_params / 1e9:.3f}e9 parameters at the "
          f"published widths{cut}")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_FAMILY_SEQ,
                    global_batch=TRAIN_FAMILY_BATCH)

    def batch(i):
        return batch_to_device(train_batch(dc, i, cfg, WHISPER_FRAMES), dev)

    batch0 = batch(0)
    reading = {}

    def worst(g, base):
        errs = {n: _leaf_rel(g[n], base[n]) for n in base}
        name = max(errs, key=errs.get)
        return errs[name], name

    routes = []
    with routes_recorded(routes):
        g = _grads_with(step, state.params, batch0)
    base = _grads_with(step, state.params, batch0, _plain_bwd_attention_fn,
                       _plain_bwd_scan_fn)
    reading["kernels"] = worst(g, base)
    reading["control"] = worst(_grads_with(step, state.params, batch0,
                                           *_control_fns(control)), base)
    del base
    if cfg.moe is not None:
        again = _grads_with(step, state.params, batch0)
        reading["repeat_bitwise"] = all(torch.equal(g[n], again[n])
                                        for n in g)
        del again
    plain_routes = []
    with routes_recorded(plain_routes):
        g_plain = _grads_with(step, state.params, batch0,
                              _plain_attention_fn, _plain_scan_fn)
    reading["plain"] = worst(g, g_plain)
    del g
    if routes:
        # the first n_layers entries are the forward's (remat recomputes)
        reading["routes_changed"] = [
            float((a != b).any(dim=-1).float().mean())
            for a, b in zip(routes[:cfg.n_layers],
                            plain_routes[:cfg.n_layers])]
    if cfg.ssm is not None:
        # a sound twin of the plain run: the same SSD in chunks of half
        # the length (the dual form sums in another order)
        twin_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=cfg.ssm.chunk // 2))
        g_twin = _grads_with(make_train_step(twin_cfg, tcfg), state.params,
                             batch0, _plain_attention_fn, _plain_scan_fn)
        reading["plain_twin"] = worst(g_twin, g_plain)
        del g_twin
    del g_plain
    gc.collect()
    what = ("dq, dk zeroed" if control == "k2" else
            "K10's gradients zeroed")
    print(f"[train full {arch}] first-step gradients against the plain "
          f"versions' autograd through the kernels' forward values: worst "
          f"leaf {reading['kernels'][1]} rel {reading['kernels'][0]:.3e}; "
          f"control ({what}) worst {reading['control'][1]} rel "
          f"{reading['control'][0]:.3e}; tol {TRAIN_FULL_GRAD_TOL}"
          + (f"; the same step twice bitwise: {reading['repeat_bitwise']}"
             if "repeat_bitwise" in reading else ""))
    print(f"[train full {arch}] against the plain versions end to end "
          f"(forward too; not gated: bf16 roundings of the forward carried "
          f"through every layer): worst leaf {reading['plain'][1]} rel "
          f"{reading['plain'][0]:.3e}"
          + (f"; a plain twin with SSD chunks of {cfg.ssm.chunk // 2} "
             f"against the plain run: worst {reading['plain_twin'][1]} rel "
             f"{reading['plain_twin'][0]:.3e}" if "plain_twin" in reading
             else "")
          + (f"; tokens whose experts differ, by layer: "
             f"{reading['routes_changed']}" if "routes_changed" in reading
             else ""))
    if not reading["kernels"][0] <= TRAIN_FULL_GRAD_TOL:
        fail(f"{arch}'s full-width gradients with the kernels disagree "
             f"with the plain versions' backward: {reading['kernels']}")
    if reading["control"][0] <= TRAIN_FULL_GRAD_TOL:
        fail(f"the {what} control passed {arch}'s full-width gradient "
             f"gate: {reading['control']}")
    if reading.get("repeat_bitwise") is False:
        fail(f"{arch}'s first-step gradients differ between two runs")

    ckdir = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = AsyncCheckpointer(str(ckdir)) if ck_step else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs = [], []
    for i in range(steps):
        b = batch(i)
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if ck and i + 1 == ck_step:
            ck.save(ck_step, state)
    ran = {n: c for n, c in launch_counts().items() if c}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if ck:
        ck.close()
    want = {n: c * steps for n, c in per_step.items()}
    if ran != want:
        fail(f"{arch}'s full-width train run launched {ran}, not {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite full-width {arch} losses: {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        fail(f"{arch}'s full-width losses did not fall: {losses}")
    step_ms = 1e3 * statistics.median(secs[3:])
    out = {"gpu": gpu_line(), "arch": arch, "layers": cfg.n_layers,
           "cut": cut.lstrip(", "), "parameters": n_params,
           "batch": TRAIN_FAMILY_BATCH, "seq": TRAIN_FAMILY_SEQ,
           "steps": steps, "remat": tcfg.remat,
           "grad_rel_kernels": reading["kernels"],
           "grad_rel_control": reading["control"], "control": control,
           "grad_rel_plain": reading["plain"],
           "grad_tol": TRAIN_FULL_GRAD_TOL, "losses": losses,
           "loss_first3": first, "loss_last3": last, "launches": ran,
           "launches_per_step": per_step, "step_ms_median": step_ms,
           "step_ms": [1e3 * x for x in secs],
           "tok_s": TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ / (step_ms / 1e3),
           "peak_gib": peak_gib}
    for key in ("repeat_bitwise", "plain_twin", "routes_changed"):
        if key in reading:
            out[f"grad_{key}"] = reading[key]
    if ck:
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
        got, state = restore_latest(str(ckdir), state)
        out["restore_s"] = time.perf_counter() - t0
        if got != ck_step:
            fail(f"restore_latest found step {got}, not {ck_step}")
        resumed = []
        for i in range(ck_step, steps):
            state, m = step(state, batch(i))
            resumed.append(float(m["loss"]))
        tail = losses[ck_step:]
        out["resumed_losses"] = resumed
        out["resume_bitwise"] = resumed == tail
        out["resume_max_rel"] = max(abs(a - b) / abs(b)
                                    for a, b in zip(resumed, tail))
        print(f"[train full {arch}] restart from step {ck_step}: losses "
              f"{'bitwise equal' if resumed == tail else 'not bitwise'} "
              f"(max rel {out['resume_max_rel']:.3e}); restore "
              f"{out['restore_s']:.1f} s")
        if not out["resume_max_rel"] <= 1e-5:
            fail(f"{arch}'s restarted losses differ from the uninterrupted "
                 f"run's: {resumed} vs {tail}")
        shutil.rmtree(ckdir, ignore_errors=True)
    _, grads = step.grads_of(state.params, batch(steps))
    out["optimizer_ms"] = time_ms(lambda: adamw_update(
        tcfg.optimizer, state.params, grads, state.opt), warmup=1, iters=3)
    del grads, state
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[train full {arch}] {out['gpu']}: losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of first 3 {first:.4f}, last 3 "
          f"{last:.4f}); launches a step {per_step}; median step "
          f"{step_ms:.2f} ms after 3 warm, {out['tok_s']:,.0f} tok/s, "
          f"optimizer {out['optimizer_ms']:.2f} ms, peak {peak_gib:.2f} "
          f"GiB; phase {out['phase_s']:.1f} s")
    return out



# ----------------------------------------------------------------------
# the fleet simulator, the token accounting and the dry run (M16)
# ----------------------------------------------------------------------

#: the replay's fleet and trace (phase 47): 16 requests, prompts 64-512,
#: generations 16-128, through one prefill and one 8-lane decode board
FLEET_REPLAY = dict(n=16, lanes=8, max_len=1024)
#: phase 49's shapes: (arch, kind, batch, seq)
DRYRUN_CHECKS = (("qwen2.5-1.5b", "train", 8, 256),
                 ("qwen2.5-1.5b", "decode", 8, 1024),
                 ("mamba2-780m", "train", 8, 256))
#: the dry run's peak against ``max_memory_allocated``: the meta pass
#: counts every storage's bytes; the card's allocator rounds each block
#: to 512 bytes and may keep an unsplit remainder (< 1 MiB) of a large
#: segment with it, and cuBLAS takes its workspace -- a few hundred MiB
#: at most over the thousands of live tensors of a train step, against
#: peaks of 3 to 33 GiB; the moment-less control sits 35-45% below
DRYRUN_MEM_TOL = 0.10
#: phase 48's longest meta passes (on the H100 machine's host: moonshot's
#: train cell 52 s, arctic's 33, mamba2's 19, qwen1.5-110b's 15),
#: submitted first
DRYRUN_LONGEST = (("moonshot-v1-16b-a3b", "train_4k"),
                  ("arctic-480b", "train_4k"), ("mamba2-780m", "train_4k"),
                  ("qwen1.5-110b", "train_4k"))


def phase_fleet(dev):
    """Phase 47: the fleet simulator and the token accounting on the
    card."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.fleet import (FleetSim, LengthDist, NodeSpec,
                                   bursty_trace, diff_token_accounting,
                                   fleet_from_plan, poisson_trace,
                                   run_trace_on_engine)
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import Workload, plan_fleet
    tag = "[fleet]"
    t_phase = time.perf_counter()
    wl = Workload(512, 128, "q8_0")
    plan = plan_fleet({"a100-40g": 2, "cmp-170hx-nofma": 8}, wl)
    trace = bursty_trace(40.0, 60.0, seed=7, prompt=LengthDist(512, cv=0.3),
                         gen=LengthDist(128, cv=0.3))
    specs = fleet_from_plan(plan, decode_lanes=4)
    t0 = time.perf_counter()
    reps = [FleetSim(specs, trace, fmt=wl.fmt, ttft_slo_s=2.0,
                     tpot_slo_s=0.05).run() for _ in range(2)]
    sim_s = (time.perf_counter() - t0) / 2
    m = reps[0].metrics()
    if reps[1].metrics() != m:
        fail(f"{tag} two runs of one seeded simulation differ")
    if reps[0].completed != reps[0].offered:
        fail(f"{tag} the mixed fleet left requests: {m}")
    print(f"{tag} mixed plan ({plan.requests_per_s:.2f} req/s planned), "
          f"{len(trace)} bursty requests, twice equal ({sim_s:.2f}s a "
          f"run): TTFT p99 {m['ttft_p99_s']:.4f}s, TPOT p99 "
          f"{m['tpot_p99_s']:.5f}s, goodput {m['goodput_rps']:.3f} req/s, "
          f"${m['usd_per_mtok']:.4f}/Mtok")

    cfg, params = init_full(dev)
    full = poisson_trace(8.0, 8.0, seed=SEED + 11,
                         prompt=LengthDist(256, cv=0.6, min_len=64,
                                           max_len=512),
                         gen=LengthDist(64, cv=0.6, min_len=16,
                                        max_len=128))[:FLEET_REPLAY["n"]]
    if len(full) != FLEET_REPLAY["n"]:
        fail(f"{tag} the trace holds {len(full)} requests")
    nodes = [NodeSpec("a100-40g", 1, "prefill"),
             NodeSpec("cmp-170hx-nofma", 1, "decode", FLEET_REPLAY["lanes"])]
    sim = FleetSim(nodes, full, fmt="q8_0")
    report = sim.run()
    if report.completed != len(full):
        fail(f"{tag} the simulator completed {report.completed} of "
             f"{len(full)}")
    reg = MetricsRegistry()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe = run_trace_on_engine([rec.req for rec in sim.records], cfg, params,
                              n_lanes=FLEET_REPLAY["lanes"],
                              max_len=FLEET_REPLAY["max_len"], device=dev,
                              registry=reg)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = diff_token_accounting(sim, report, exe)
    steps = next(reg[n].value for n in reg.names()
                 if n.endswith(".decode.steps"))
    k2 = counts["flash_attention_mma"]
    k3 = counts["decode_attention_lengthaware"]
    if not (res["match"] and res["sim_prompt_tokens"] ==
            res["engine_prompt_tokens"] and res["sim_gen_tokens"] ==
            res["engine_gen_tokens"]):
        fail(f"{tag} token accounting differs at full width: {res}")
    if k2 != len(full) * cfg.n_layers:
        fail(f"{tag} K2 launched {k2} times for {len(full)} prompts x "
             f"{cfg.n_layers} layers")
    if k3 != steps * cfg.n_layers:
        fail(f"{tag} K3 launched {k3} times for {steps} decode steps x "
             f"{cfg.n_layers} layers")
    # the control: one record's claim one token off
    bad = [dataclasses.replace(r, gen_len=r.gen_len + (r.uid == 3))
           for r in full]
    ctrl_sim = FleetSim(nodes, bad, fmt="q8_0")
    ctrl = diff_token_accounting(ctrl_sim, ctrl_sim.run(), exe)
    if ctrl["match"] or list(ctrl["mismatches"]) != [3]:
        fail(f"{tag} the control (uid 3's gen_len off by one) passed: "
             f"{ctrl}")
    tokens = exe.prompt_tokens + exe.gen_tokens
    print(f"{tag} token accounting at full width (qwen2.5-1.5b bf16, "
          f"fixed-lane, {FLEET_REPLAY['lanes']} lanes): match, "
          f"{exe.prompt_tokens} prompt and {exe.gen_tokens} generated "
          f"tokens == the simulator's; K2 {k2} = {len(full)} x "
          f"{cfg.n_layers}, K3 {k3} = {steps} steps x {cfg.n_layers}; the "
          f"off-by-one control mismatches uid 3; replay {replay_s:.3f}s, "
          f"{exe.gen_tokens / replay_s:.1f} generated tok/s, "
          f"{tokens / replay_s:.1f} tok/s with prompts ({gpu_line()})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"sim": {k: m[k] for k in ("ttft_p99_s", "tpot_p99_s",
                                      "goodput_rps", "usd_per_mtok",
                                      "completed", "offered")},
            "sim_s": sim_s, "accounting": {k: v for k, v in res.items()
                                           if k != "mismatches"},
            "control_mismatches": {str(k): v for k, v in
                                   ctrl["mismatches"].items()},
            "launches": {"flash_attention_mma": k2,
                         "decode_attention_lengthaware": k3},
            "decode_steps": steps, "replay_s": replay_s,
            "gen_tok_s": exe.gen_tokens / replay_s,
            "tok_s": tokens / replay_s,
            "phase_s": time.perf_counter() - t_phase}


def phase_dryrun_cells():
    """Phase 48: ``run_cell`` over every cell of ``all_cells()`` on the
    meta device, in parallel processes; the same pool runs phase 49's
    meta passes (returned beside the cells)."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import SHAPES, all_cells, get_config
    from repro_torch.launch.dryrun import (_cell_or_error, _model_flops,
                                           analyze_step, derived_flops)
    tag = "[dryrun]"
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        # the longest first: the longest train cells (the pool's wall is
        # moonshot's), phase 49's train passes, the other train cells
        cells = sorted(all_cells(),
                       key=lambda c: SHAPES[c[1]]["kind"] != "train")
        futs = {c: pool.submit(_cell_or_error, c[0], c[1], 1)
                for c in cells if c in DRYRUN_LONGEST}
        checks = {}
        for arch, kind, b, s in DRYRUN_CHECKS:
            for mdt in ((None, "none") if kind == "train" else (None,)):
                checks[(arch, kind, mdt)] = pool.submit(
                    analyze_step, get_config(arch), kind, b, s,
                    moment_dtype=mdt)
        for c in cells:
            if c not in futs:
                futs[c] = pool.submit(_cell_or_error, c[0], c[1], 1)
        recs = [futs[c].result() for c in cells]
        metas = {k: f.result() for k, f in checks.items()}
    wall = time.perf_counter() - t0
    errors = [r for r in recs if "error" in r]
    if errors or len(recs) != 32:
        for r in errors:
            print(r.get("traceback", ""), file=sys.stderr)
        fail(f"{tag} {len(errors)} of {len(recs)} cells failed: "
             f"{[(r['arch'], r['shape'], r['error']) for r in errors]}")
    out = {}
    for r in recs:
        cfg, sh = get_config(r["arch"]), SHAPES[r["shape"]]
        want = derived_flops(cfg, sh["kind"], sh["global_batch"],
                             sh["seq_len"])
        if r["model_flops"] != _model_flops(cfg, r["shape"]):
            fail(f"{tag} {r['arch']}/{r['shape']}: model_flops "
                 f"{r['model_flops']}")
        if r["hlo_flops"] != want:
            fail(f"{tag} {r['arch']}/{r['shape']}: counted "
                 f"{r['hlo_flops']:.6e} FLOPs, the derived count {want:.6e}")
        ratio = r["hlo_flops"] / r["model_flops"]
        print(f"{tag} {r['arch']}/{r['shape']} ({r['kind']}): counted "
              f"{r['hlo_flops']:.4e} FLOPs = derived, model "
              f"{r['model_flops']:.4e} (x{ratio:.4f}), bytes "
              f"{r['hlo_bytes']:.4e}, peak {r['bytes_per_device'] / 2**30:.2f}"
              f" GiB (args {r['argument_size_in_bytes'] / 2**30:.2f}), fits "
              f"{r['fits_device']}, {r['meta_s']}s")
        out[f"{r['arch']}/{r['shape']}"] = {
            k: r[k] for k in ("hlo_flops", "model_flops", "hlo_bytes",
                              "bytes_per_device", "argument_size_in_bytes",
                              "fits_device", "meta_s")}
    print(f"{tag} {len(recs)} cells on the meta device, every count equal "
          f"to its derivation, in {wall:.1f}s ({workers} processes, with "
          f"phase 49's {len(metas)} meta passes)")
    return {"cells": out, "n_cells": len(recs), "wall_s": wall,
            "workers": workers}, metas


def _real_step(dev, cfg, kind, batch, seq):
    """One step of ``kind`` on the card from fresh state: (bytes of the
    peak above what was allocated before the state, step seconds, a
    second step's seconds, the launches of the first)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if kind == "train":
        state = init_train_state(model, gen, dev)
        batch_ = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        step = make_train_step(cfg, TrainConfig(remat=True))

        def run():
            step(state, batch_)
    else:
        params = model.init(gen, dev)
        cache = model.init_cache(batch, seq, device=dev)
        tok = tokens[:, 0].contiguous()

        def run():
            model.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = kernels.launch_delta(
        {n: 0 for n in kernels.COUNTERS}, kernels.launch_counts())
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    return peak, first_s, second_s, launches


def phase_dryrun_check(dev, metas):
    """Phase 49: the dry run's peak bytes (``metas``, phase 48's meta
    passes) against the card's ``max_memory_allocated`` on three shapes,
    a moment-less control, the counted FLOPs over the measured step, and
    the launcher's ``--mesh``."""
    import torch
    from repro_torch.configs import get_config
    tag = "[dryrun check]"
    t_phase = time.perf_counter()
    out = {}
    for arch, kind, b, s in DRYRUN_CHECKS:
        cfg = get_config(arch)
        meta = metas[(arch, kind, None)]
        peak, first_s, second_s, launches = _real_step(dev, cfg, kind, b, s)
        err = meta["peak_bytes"] / peak - 1.0
        if abs(err) > DRYRUN_MEM_TOL:
            fail(f"{tag} {arch} {kind} B {b} S {s}: dry run "
                 f"{meta['peak_bytes'] / 2**30:.3f} GiB, card "
                 f"{peak / 2**30:.3f} GiB ({err:+.2%}, tol "
                 f"{DRYRUN_MEM_TOL:.0%})")
        entry = {"dry_bytes": meta["peak_bytes"], "card_bytes": peak,
                 "rel_err": err, "flops": meta["flops"],
                 "first_step_s": first_s, "step_s": second_s,
                 "tflops": meta["flops"] / second_s / 1e12,
                 "launches": launches}
        line = (f"{tag} {arch} {kind} B {b} S {s}: dry run "
                f"{meta['peak_bytes'] / 2**30:.3f} GiB, card peak "
                f"{peak / 2**30:.3f} GiB ({err:+.2%}, tol "
                f"{DRYRUN_MEM_TOL:.0%})")
        if kind == "train":
            ctrl = metas[(arch, kind, "none")]
            cerr = ctrl["peak_bytes"] / peak - 1.0
            if abs(cerr) <= DRYRUN_MEM_TOL:
                fail(f"{tag} {arch}: the control without moments "
                     f"({ctrl['peak_bytes'] / 2**30:.3f} GiB, {cerr:+.2%}) "
                     f"passed the gate")
            entry["control_bytes"], entry["control_rel_err"] = \
                ctrl["peak_bytes"], cerr
            line += f"; control without moments {cerr:+.2%}"
        print(f"{line}; {meta['flops']:.4e} counted FLOPs in "
              f"{second_s * 1e3:.1f} ms = {entry['tflops']:.2f} TFLOP/s "
              f"(first step {first_s * 1e3:.1f} ms); launches {launches} "
              f"({gpu_line()})")
        out[f"{arch} {kind}"] = entry
        gc.collect()
        torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2.5-1.5b", "--smoke", "--steps", "2", "--batch", "2",
           "--seq", "32"]
    ok = subprocess.run(cmd + ["--mesh", "1,1"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    if ok.returncode != 0 or "done" not in ok.stdout:
        fail(f"{tag} --mesh 1,1 did not train: {ok.stdout[-800:]} "
             f"{ok.stderr[-800:]}")
    no = subprocess.run(cmd + ["--mesh", "2,1"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    if no.returncode == 0 or "needs 2 devices" not in no.stderr:
        fail(f"{tag} --mesh 2,1 was not refused: {no.stderr[-800:]}")
    print(f"{tag} the launcher on the card: --mesh 1,1 trains "
          f"({ok.stdout.strip().splitlines()[-2]}), --mesh 2,1 refused "
          f"({no.stderr.strip().splitlines()[-1]})")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 50: qwen2.5-1.5b's serve buckets at full width (8 lanes,
#: max_len 1024, both layouts), then one bucket each of the other
#: families whose prefill runs a kernel: (arch, bucket, layouts)
PREFILL_GRAPH_BUCKETS = (64, 128, 256, 512, 1024)
PREFILL_GRAPH_OTHERS = (("hymba-1.5b", 1024, ("fixed-lane",)),
                        ("mamba2-780m", 1024, ("fixed-lane",)),
                        ("phi-3-vision-4.2b", 1024, ("fixed-lane",)))
PREFILL_GRAPH_REPS = 5


def prefill_graph_check(eng, tag, bucket, seed, reps=PREFILL_GRAPH_REPS):
    """The engine's ``("prefill", bucket)`` graph: captured through
    ``graphs.run`` (the engine's own call) over a prompt of the bucket,
    then replayed over two other prompts of it, each replay's logits
    and K/V (logits alone for an ssm model) equal bit for bit to the
    eager ``model.prefill`` on the same buffers, the two prompts' logits
    different, and the launches one replay adds equal to the eager
    call's; then ``reps`` replays and ``reps`` eager calls timed on the
    host clock with the device synced.  The serve's launch counts are
    left as they were.  Returns the figures."""
    import numpy as np
    import torch
    from repro_torch.kernels import add_launches, launch_counts, launch_delta
    counts = launch_counts()
    key = ("prefill", bucket)
    tokens, last_pos = eng._prefill_inputs(bucket)
    rng = np.random.default_rng(seed)
    top = min(bucket, eng.max_len - 1)
    plens = [int(p) for p in rng.integers(bucket // 2 + 1, top + 1, 3)]

    def load(plen):
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = rng.integers(0, eng.cfg.vocab_size, plen)
        tokens.copy_(torch.from_numpy(padded))
        last_pos.fill_(plen - 1)

    def flat(out):
        logits, kv = out
        return [logits] + ([] if kv is None else list(kv))

    def replay():
        out, made = eng.graphs.run(key, lambda: eng._prefill_block(bucket))
        if made:
            fail(f"{tag} bucket {bucket}: the graph was captured again")
        return flat(out)

    def eager():
        return flat(eng.model.prefill(eng.params, tokens,
                                      last_pos=last_pos))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    if key in eng.graphs.capture_s:
        fail(f"{tag} bucket {bucket}: a graph was there before the check")
    load(plens[0])
    first_s = timed(lambda: eng.graphs.run(
        key, lambda: eng._prefill_block(bucket)))
    capture_s = eng.graphs.capture_s[key]
    names = ["logits", "k", "v"]
    logits = []
    for plen in plens[1:]:
        load(plen)
        before = launch_counts()
        got = [t.clone() for t in replay()]
        replay_delta = launch_delta(before, launch_counts())
        before = launch_counts()
        want = eager()
        eager_delta = launch_delta(before, launch_counts())
        torch.cuda.synchronize()
        differ = [n for n, a, b in zip(names, got, want)
                  if not torch.equal(a, b)]
        if len(got) != len(want) or differ:
            fail(f"{tag} bucket {bucket}: the replayed prefill differs from "
                 f"the eager one on the same buffers in {differ}")
        if replay_delta != eager_delta or not replay_delta:
            fail(f"{tag} bucket {bucket}: a replay launched {replay_delta}, "
                 f"the eager call {eager_delta}")
        logits.append(got[0])
    if torch.equal(logits[0], logits[1]):
        fail(f"{tag} bucket {bucket}: prompts of {plens[1:]} tokens gave "
             f"the same logits: the graph did not read its buffers")
    replay_s = [timed(replay) for _ in range(reps)]
    eager_s = [timed(eager) for _ in range(reps)]
    add_launches(launch_delta(launch_counts(), counts))
    eager_ms = 1e3 * statistics.median(eager_s)
    replay_ms = 1e3 * statistics.median(replay_s)
    saved = eager_ms - replay_ms
    pays = int(np.ceil(1e3 * capture_s / saved)) if saved > 0 else None
    print(f"{tag} bucket {bucket}: replay == eager prefill bitwise "
          f"({', '.join(names[:len(got)])}; prompts {plens[1:]}"
          f" differ), launches a replay {replay_delta}; host ms, synced: "
          f"eager {[round(1e3 * t, 3) for t in eager_s]}, replayed "
          f"{[round(1e3 * t, 3) for t in replay_s]}; capture "
          f"{capture_s:.3f}s (first call {first_s:.3f}s); the capture pays "
          f"after {pays} replayed prompts")
    return {"eager_ms": eager_ms, "replayed_ms": replay_ms,
            "eager_ms_all": [1e3 * t for t in eager_s],
            "replayed_ms_all": [1e3 * t for t in replay_s],
            "capture_s": capture_s, "first_call_s": first_s,
            "launches_per_replay": replay_delta, "plens": plens,
            "prompts_to_pay": pays}


def phase_prefill_graphs(dev):
    """Phase 50: the prefill graphs at full width, each bucket's graph
    checked and timed by :func:`prefill_graph_check` in a fresh engine:
    qwen2.5-1.5b bf16 (8 lanes, max_len 1024) at buckets 64 to 1024 on
    both layouts, then one bucket of hymba-1.5b (K2 windowed and K10),
    mamba2-780m (K10; the serve discards the logits, so they alone are
    compared) and phi-3-vision-4.2b (K2 at D 96), fixed-lane; the graph
    pool's bytes after each engine's last capture."""
    import torch
    from repro_torch.serving import ServeEngine
    t_phase = time.perf_counter()
    gpu = gpu_line()
    out = {}
    runs = [("qwen2.5-1.5b", PREFILL_GRAPH_BUCKETS, ("fixed-lane", "paged"))]
    runs += [(arch, (b,), layouts)
             for arch, b, layouts in PREFILL_GRAPH_OTHERS]
    for arch, buckets, layouts in runs:
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params = init_config(dev, arch)
        for layout in layouts:
            tag = f"[prefill graphs {arch} {layout}]"
            kw = dict(paged=True, page_size=16) if layout == "paged" else {}
            eng = ServeEngine(cfg, params, n_lanes=8, max_len=1024,
                              device=dev, **kw)
            res = {b: prefill_graph_check(eng, tag, b, SEED + b)
                   for b in buckets}
            pool = eng.graphs.pool_bytes()
            size = ("not measured" if pool is None
                    else f"{pool / 2**20:.1f} MiB")
            print(f"{tag} graph pool after {len(buckets)} captures: {size} "
                  f"({gpu})")
            out[f"{arch} {layout}"] = {"buckets": res, "pool_bytes": pool}
            eng.graphs.release()
            del eng
        del params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = gpu
    print(f"[prefill graphs] phase 50 took {out['phase_s']:.1f}s")
    return out


# ----------------------------------------------------------------------
# phase 51: the mesh -- ranks on the card, the dense family sharded
# ----------------------------------------------------------------------

#: the mesh phase: two ranks share the one card, so the group's backend
#: is gloo (``runtime.backend_for``: NCCL refuses two ranks on one
#: device; gloo carries a CUDA tensor through the host); mesh (data 1,
#: model 2), so attention, the MLP and the vocab are split over model
MESH_RANKS, MESH_SHAPE = 2, (1, 2)
#: qwen2.5-1.5b at full width in bf16: three steps on one repeated batch
#: (remat, one microbatch; the launcher's schedule for 30 steps) and
#: four decode steps of four lanes
MESH_TRAIN = dict(batch=4, seq=256, steps=3)
MESH_OPT = dict(lr=3e-4, warmup_steps=20, total_steps=30)
MESH_DECODE = dict(lanes=4, max_len=64, steps=4)
#: the decode runs' weight dtypes: float32 is held to the reference's
#: gate; bf16 cannot be (one bf16 ulp of a logit of magnitude 2 to 4 is
#: 0.0156), so its sharded logits are held to the float32 step's (the
#: same draws, unrounded) within ``MESH_BF16_RATIO`` times the
#: unsharded bf16 step's distance from them
MESH_DECODE_DTYPES = ("float32", "bfloat16")
#: each sharded step's loss against the unsharded step's (relative)
MESH_LOSS_TOL = 1e-2
#: the bf16 decode: the sharded logits' distance from the unsharded
#: float32 step's, at most this many times the unsharded bf16 step's
MESH_BF16_RATIO = 2.0
#: the decode logits against the unsharded step's (the reference's
#: sharded-decode gate, absolute)
MESH_LOGIT_TOL = 1e-2
#: seconds the ranks may take, start to exit
MESH_TIMEOUT = 420


def _mesh_kernel_rows(dev, b, h, hkv, s, d, lanes, s_dec):
    """K2 and K3 at the local heads the ranks ran: each against its plain
    version (bf16, tol 2e-2), and timed beside it and SDPA."""
    import torch
    from torch.nn import functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
    q, k, v = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    k2_err = max_err(flash_attention(q, k, v, causal=True),
                     attention_ref(q, k, v, causal=True))
    k2 = with_bound(_k2_row(q, k, v, 2))
    qd, kd, vd = rnd(lanes, h, d), rnd(lanes, hkv, s_dec, d), \
        rnd(lanes, hkv, s_dec, d)
    lens = torch.full((lanes,), s_dec, dtype=torch.int32, device=dev)
    k3_err = max_err(decode_attention(qd, kd, vd, lens),
                     decode_attention_ref(qd, kd, vd, lens))
    n_pos = lanes * s_dec
    k3 = with_bound(dict(
        peak=BF16_FLOPS_PER_S,
        ms=time_ms_queued(lambda: decode_attention(qd, kd, vd, lens)),
        plain_ms=time_ms_queued(lambda: decode_attention_ref(qd, kd, vd,
                                                             lens)),
        library_ms=time_ms_queued(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kd, vd, enable_gqa=True)),
        bytes=2 * n_pos * hkv * d * 2 + 2 * qd.numel() * 2 + 4 * lanes,
        flops=4 * n_pos * h * d))
    keep = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return ({"max_abs_err": k2_err, "tol": 2e-2,
             **{x: k2[x] for x in keep}, "shape": [b, h, hkv, s, d]},
            {"max_abs_err": k3_err, "tol": 2e-2,
             **{x: k3[x] for x in keep}, "shape": [lanes, h, hkv, s_dec, d]})


def _mesh_steps(step, tcfg, state, batch, loss, grads):
    """``MESH_TRAIN["steps"]`` steps from ``state``: the first the update
    with ``grads`` (the first pass's, its loss ``loss``), the rest
    ``step``'s.  Returns (state, losses, host ms of the later steps,
    synced and, on a mesh, between barriers)."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import adamw_update
    from repro_torch.parallel import sharding
    from repro_torch.train import TrainState
    params, opt, _ = adamw_update(tcfg.optimizer, state.params, grads,
                                  state.opt)
    state, losses, ms = TrainState(params=params, opt=opt), [float(loss)], []
    meshed = sharding.active() is not None
    for _ in range(MESH_TRAIN["steps"] - 1):
        if meshed:
            dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        if meshed:
            dist.barrier()
        ms.append(1e3 * (time.perf_counter() - t))
    return state, losses, ms


def _mesh_work(rank, world, dev):
    """One rank's share of phase 51 (see :func:`phase_mesh`); returns
    its readings."""
    import collections
    import dataclasses
    import torch
    import torch.distributed as dist
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_cache, lm_decode_step
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.parallel import comm, sharding, use_mesh
    from repro_torch.train import TrainConfig, TrainState, make_train_step
    from repro_torch.train.train_loop import batch_to_device
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-1.5b")
    model = build_model(cfg)
    mesh = make_test_mesh(MESH_SHAPE)
    tcfg = TrainConfig(optimizer=AdamWConfig(**MESH_OPT), remat=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=MESH_TRAIN["seq"],
                    global_batch=MESH_TRAIN["batch"])
    batch = batch_to_device(synth_batch(dc, 0), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev,
                        train=True)
    out = {"rank": rank, "mesh": mesh.shape, "backend": dist.get_backend(),
           "device": str(dev)}
    # the unsharded first step on every rank (each compares its blocks
    # with these gradients); on rank 0 also the unsharded steps, whose
    # masters are then drawn again for the sharded run
    step1 = make_train_step(cfg, tcfg)
    loss1, g1 = step1.grads_of(params, batch)
    if rank == 0:
        state1 = TrainState(params=params, opt=init_adamw(params))
        state1, losses1, step_ms1 = _mesh_steps(step1, tcfg, state1, batch,
                                                loss1, g1)
        del state1, params
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            dev, train=True)
    del step1
    dist.barrier()
    sharding.place_params(mesh, params, cfg, "train")
    state = TrainState(params=params, opt=init_adamw(params))
    specs = {n: sharding.spec_of(p) for n, p in params.named_parameters()}
    seen = collections.Counter()
    fn, dec = attention.flash_attention_fn, attention.decode_attention

    def k2_fn(q, k, v, **kw):
        seen[f"flash_attention_mma H {q.shape[1]} Hkv {k.shape[1]}"] += 1
        return fn(q, k, v, **kw)

    def k3(q, k, v, lens, **kw):
        seen[f"decode_attention_lengthaware H {q.shape[1]} Hkv "
             f"{k.shape[1]}"] += 1
        return dec(q, k, v, lens, **kw)
    attention.flash_attention_fn, attention.decode_attention = k2_fn, k3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with use_mesh(mesh):
            reset_launch_counts()
            step = make_train_step(cfg, tcfg)
            loss_s, gs = step.grads_of(state.params, batch)
            # each leaf's relative L2 error: the squares of this rank's
            # blocks against the same blocks of the unsharded gradients,
            # summed over the ranks that own them
            sq = torch.zeros(len(gs), 2, dtype=torch.float64, device=dev)
            for i, (name, g) in enumerate(gs.items()):
                if sharding.owns(mesh, specs[name]):
                    ref = comm.local_of(g1[name], mesh, specs[name]).double()
                    sq[i, 0] = torch.sum(torch.square(g.double() - ref))
                    sq[i, 1] = torch.sum(torch.square(ref))
            sq = comm.all_reduce(sq, mesh, mesh.axis_names)
            rels = torch.sqrt(sq[:, 0]) / torch.sqrt(sq[:, 1]).clamp(
                min=1e-30)
            i = int(torch.argmax(rels))
            worst = (float(rels[i]), list(gs)[i])
            del g1
            state, losses, step_ms = _mesh_steps(step, tcfg, state, batch,
                                                 loss_s, gs)
            del gs
            train_launches = {n: c for n, c in launch_counts().items() if c}
            train_heads = dict(seen)
        out["train_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del state, step, params
        gc.collect()
        torch.cuda.empty_cache()
        # decode: serving's weights from the same seed, in float32 (the
        # gated run) and in bf16
        toks = torch.randint(0, cfg.vocab_size, (MESH_DECODE["steps"],
                                                 MESH_DECODE["lanes"]),
                             generator=torch.Generator().manual_seed(SEED),
                             dtype=torch.int32).to(dev)
        decode = {}
        for dtype in MESH_DECODE_DTYPES:
            dcfg = dataclasses.replace(cfg, dtype=dtype)
            serve = build_model(dcfg).init(
                torch.Generator(device=dev).manual_seed(SEED), dev)
            if rank == 0:
                cache = init_cache(dcfg, MESH_DECODE["lanes"],
                                   MESH_DECODE["max_len"], device=dev)
                ref, ref_ms = [], []
                for t in toks:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lg, cache = lm_decode_step(serve, dcfg, cache, t)
                    torch.cuda.synchronize()
                    ref_ms.append(1e3 * (time.perf_counter() - t1))
                    ref.append(lg[:, :cfg.vocab_size].float())
                del cache
            sharding.place_params(mesh, serve, dcfg, "serve")
            torch.cuda.reset_peak_memory_stats(dev)
            seen.clear()
            dec_ms = []
            with use_mesh(mesh, mode="serve"):
                reset_launch_counts()
                cache = init_cache(dcfg, MESH_DECODE["lanes"],
                                   MESH_DECODE["max_len"], device=dev)
                got = []
                for t in toks:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lg, cache = lm_decode_step(serve, dcfg, cache, t)
                    torch.cuda.synchronize()
                    dec_ms.append(1e3 * (time.perf_counter() - t1))
                    got.append(lg[:, :cfg.vocab_size].float())
                d = {"launches": {n: c for n, c in launch_counts().items()
                                  if c},
                     "heads": dict(seen), "ms": dec_ms,
                     "cache_k_shape": list(cache["k"].shape),
                     "lens": cache["len"].tolist(),
                     "peak_gib": torch.cuda.max_memory_allocated(dev)
                     / 2**30}
            if rank == 0:
                d["ms_unsharded"] = ref_ms
                d["logit_err"] = max(max_err(a, b) for a, b in zip(got, ref))
                d["logit_max"] = max(float(b.abs().max()) for b in ref)
                if dtype == "float32":
                    ref32 = ref
                else:
                    d["precision_err"] = max(max_err(a, b)
                                             for a, b in zip(ref, ref32))
                    d["truth_err"] = max(max_err(a, b)
                                         for a, b in zip(got, ref32))
                    del ref32
                del ref
            decode[dtype] = d
            del serve, cache, got
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        attention.flash_attention_fn, attention.decode_attention = fn, dec
    out.update(train_launches=train_launches, train_heads=train_heads,
               losses=losses, loss_first=losses[0], step_ms=step_ms,
               decode=decode)
    if rank == 0:
        out["loss_unsharded"] = losses1[0]
        out["losses_unsharded"] = losses1
        out["step_ms_unsharded"] = step_ms1
        out["loss_rel"] = abs(losses[0] - losses1[0]) / abs(losses1[0])
        out["losses_rel"] = max(abs(a - b) / abs(b)
                                for a, b in zip(losses, losses1))
        out["grad_worst"] = list(worst)
        h, hkv = cfg.n_heads // MESH_SHAPE[1], cfg.n_kv_heads // MESH_SHAPE[1]
        out["k2"], out["k3"] = _mesh_kernel_rows(
            dev, MESH_TRAIN["batch"], h, hkv, MESH_TRAIN["seq"], cfg.hd,
            MESH_DECODE["lanes"], MESH_DECODE["max_len"])
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank_main(argv):
    """A rank of phase 51 (``chip_smoke.py --mesh-rank R STORE OUT``):
    joins the group, runs :func:`_mesh_work`, writes its readings to
    ``OUT/rank{R}.json``."""
    rank, store, out = int(argv[0]), argv[1], Path(argv[2])
    import torch
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.device import resolve_device
    from repro_torch.parallel import runtime
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    with runtime.process_group(store, rank, MESH_RANKS, dev):
        res = _mesh_work(rank, MESH_RANKS, dev)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def phase_mesh(dev):
    """Phase 51: the mesh.  ``MESH_RANKS`` rank processes (this script
    with ``--mesh-rank``) share the card over gloo on mesh
    ``MESH_SHAPE`` and run qwen2.5-1.5b at full width in bf16: the
    unsharded first step on every rank (each compares its blocks of the
    gradients) and three unsharded steps on rank 0, then the same
    sharded (FSDP over data,
    TP over model: K2 at the local heads) -- the first loss within
    ``MESH_LOSS_TOL`` relative, every gradient leaf within
    ``TRAIN_FULL_GRAD_TOL`` (phase 43's bf16 gate), three steps whose
    losses fall, each within ``MESH_LOSS_TOL`` of the unsharded one's;
    then four sharded ``lm_decode_step`` calls on a dense cache (serve
    mode: K3 at the local KV heads) against the unsharded step's
    logits: float32 within ``MESH_LOGIT_TOL``, bf16 by its distance from
    the float32 logits (``MESH_DECODE_DTYPES``, ``MESH_BF16_RATIO``).
    Launch counts are each rank's, from zero just before each path; K2 and K3 are checked and timed at the local
    shapes.  Prints the mesh, the gaps, the launches at their head
    counts, each rank's peak memory and the synchronized step times."""
    import shutil
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(tmp / "store"), str(tmp)],
        env=dict(env, LOCAL_RANK=str(r)), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(MESH_RANKS)]
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tag = "[mesh]"
    if any(p.returncode for p in procs):
        for r in range(MESH_RANKS):
            print(f"{tag} rank {r} (exit {procs[r].returncode}):\n"
                  f"{(tmp / f'rank{r}.log').read_text()[-4000:]}")
        fail(f"{tag} a rank failed or overran {MESH_TIMEOUT} s")
    res = [json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(MESH_RANKS)]
    r0 = res[0]
    gpu = gpu_line()
    print(f"{tag} mesh {r0['mesh']} over {MESH_RANKS} ranks on one card "
          f"({r0['backend']}; {r0['device']}, {res[-1]['device']}), "
          f"qwen2.5-1.5b bf16 full width ({gpu})")
    losses = r0["losses"]
    print(f"{tag} first step: loss {r0['loss_first']:.6f} sharded, "
          f"{r0['loss_unsharded']:.6f} unsharded (rel {r0['loss_rel']:.3e},"
          f" tol {MESH_LOSS_TOL}); worst gradient leaf {r0['grad_worst'][1]}"
          f" rel {r0['grad_worst'][0]:.3e} (tol {TRAIN_FULL_GRAD_TOL}); "
          f"losses over {len(losses)} steps {losses}, unsharded "
          f"{r0['losses_unsharded']} (worst rel {r0['losses_rel']:.3e}, "
          f"tol {MESH_LOSS_TOL}); unsharded step ms "
          f"{[round(x, 1) for x in r0['step_ms_unsharded']]} ({gpu})")
    for dtype, d in r0["decode"].items():
        gate = (f"tol {MESH_LOGIT_TOL}" if dtype == "float32" else
                f"against the float32 step {d['truth_err']:.3e}, the "
                f"unsharded bf16 step {d['precision_err']:.3e}, tol "
                f"{MESH_BF16_RATIO}x")
        print(f"{tag} decode {dtype}: {MESH_DECODE['steps']} steps of "
              f"{MESH_DECODE['lanes']} lanes, logits max abs err "
              f"{d['logit_err']:.3e} against the unsharded step (largest "
              f"|logit| {d['logit_max']:.3f}; {gate}); each rank's cache "
              f"k {d['cache_k_shape']}, len {d['lens']}; unsharded step "
              f"ms median {statistics.median(d['ms_unsharded']):.2f} "
              f"({gpu})")
    for r in res:
        print(f"{tag} rank {r['rank']}: train launches "
              f"{r['train_launches']} at {r['train_heads']}; peak "
              f"{r['train_peak_gib']:.2f} GiB training; step ms "
              f"{[round(x, 1) for x in r['step_ms']]} ({gpu})")
        for dtype, d in r["decode"].items():
            print(f"{tag} rank {r['rank']} decode {dtype}: launches "
                  f"{d['launches']} at {d['heads']}; peak "
                  f"{d['peak_gib']:.2f} GiB; step ms median "
                  f"{statistics.median(d['ms']):.2f} ({gpu})")
    if not r0["loss_rel"] <= MESH_LOSS_TOL:
        fail(f"{tag} the sharded first loss is {r0['loss_rel']:.3e} from "
             f"the unsharded one")
    if not r0["grad_worst"][0] <= TRAIN_FULL_GRAD_TOL:
        fail(f"{tag} sharded gradients disagree: {r0['grad_worst']}")
    # falling as the reference's elastic test has it (the last below the
    # first): at this schedule the unsharded run's third loss sits above
    # its second too
    if not (all(x == x for x in losses) and losses[-1] < losses[0]):
        fail(f"{tag} the sharded losses did not fall: {losses}")
    if not r0["losses_rel"] <= MESH_LOSS_TOL:
        fail(f"{tag} the sharded losses {losses} are not the unsharded "
             f"{r0['losses_unsharded']}")
    if not r0["decode"]["float32"]["logit_err"] <= MESH_LOGIT_TOL:
        fail(f"{tag} sharded float32 decode logits off by "
             f"{r0['decode']['float32']['logit_err']:.3e}")
    bf16 = r0["decode"]["bfloat16"]
    if not bf16["truth_err"] <= MESH_BF16_RATIO * bf16["precision_err"]:
        fail(f"{tag} sharded bf16 decode logits {bf16['truth_err']:.3e} "
             f"from the float32 step's, the unsharded bf16 step's "
             f"{bf16['precision_err']:.3e}")
    for dtype, d in r0["decode"].items():
        if d["lens"] != [MESH_DECODE["steps"]] * MESH_DECODE["lanes"]:
            fail(f"{tag} the {dtype} cache's len is {d['lens']}")
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-1.5b")
    h, hkv = cfg.n_heads // MESH_SHAPE[1], cfg.n_kv_heads // MESH_SHAPE[1]
    # a train pass runs K2 twice a layer (forward and remat's recompute):
    # grads_of (the first step's gradients), then the later steps
    k2_want = 2 * cfg.n_layers * MESH_TRAIN["steps"]
    k3_want = cfg.n_layers * MESH_DECODE["steps"]
    for r in res:
        if r["train_launches"] != {"flash_attention_mma": k2_want} or \
                r["train_heads"] != {f"flash_attention_mma H {h} Hkv {hkv}":
                                     k2_want}:
            fail(f"{tag} rank {r['rank']} trained with "
                 f"{r['train_launches']} at {r['train_heads']}")
        for dtype, d in r["decode"].items():
            if d["launches"] != {"decode_attention_lengthaware":
                                 k3_want} or d["heads"] != {
                    f"decode_attention_lengthaware H {h} Hkv {hkv}":
                    k3_want}:
                fail(f"{tag} rank {r['rank']} decoded {dtype} with "
                     f"{d['launches']} at {d['heads']}")
    for name in ("k2", "k3"):
        if not r0[name]["max_abs_err"] <= r0[name]["tol"]:
            fail(f"{tag} {name} at the local heads: {r0[name]}")
    out = {"card": gpu, "ranks": res, "phase_s": time.perf_counter() - t_phase}
    print(f"{tag} K2 at the local heads {r0['k2']['shape']}: "
          f"{r0['k2']['ms']:.4f} ms (plain {r0['k2']['plain_ms']:.4f}, SDPA "
          f"{r0['k2']['library_ms']:.4f}, bound {r0['k2']['bound_ms']:.4f});"
          f" K3 {r0['k3']['shape']}: {r0['k3']['ms']:.4f} ms (plain "
          f"{r0['k3']['plain_ms']:.4f}, SDPA {r0['k3']['library_ms']:.4f}, "
          f"bound {r0['k3']['bound_ms']:.4f}); phase 51 took "
          f"{out['phase_s']:.1f}s")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    errs = {"decode_attention_paged": phase_k1(dev)}
    errs.update(phase_k2(dev))
    errs.update(phase_dense(dev))
    errs.update(phase_q8(dev))
    hymba_errs = phase_hymba_decode(dev)
    smoke_counts, _ = phase_smoke_e2e(dev)
    if not smoke_counts["flash_attention_cc"]:
        fail(f"the float32 SMOKE serve never ran K2's CUDA-core kernel: "
             f"{smoke_counts}")
    phase_smoke_e2e(dev, kv_quant="int8")
    cfg, params = init_full(dev)
    paged_counts, paged_e2e = phase_full_paged(dev, cfg, params)
    fixed_counts, fixed_e2e = phase_full_fixed(dev, cfg, params)
    int8 = phase_full_int8(dev, cfg, params)
    t_share = time.perf_counter()
    phase_share_smoke(dev)
    share_full = phase_share_full(dev, cfg, params)
    preempt = phase_preempt_full(dev, cfg, params)
    print(f"[share/preempt] the sharing and evict/restore phases took "
          f"{time.perf_counter() - t_share:.1f}s")
    t_obs = time.perf_counter()
    obs_smoke = {"paged": phase_obs_smoke(dev, paged=True),
                 "fixed_lane": phase_obs_smoke(dev, paged=False)}
    obs_full = phase_obs_full(dev, cfg, params)
    ladder_full = phase_ladder_full(dev, cfg, params)
    print(f"[obs] the observability and ladder phases took "
          f"{time.perf_counter() - t_obs:.1f}s")
    t_slice = time.perf_counter()
    quant_smoke = phase_quant_smoke(dev)
    quant_full = phase_quant_full(dev, cfg, params)
    multimodel = phase_multimodel_full(dev, cfg, params)
    replay = phase_replay(dev, cfg, params)
    print(f"[quant/multimodel/replay] phases 32-35 took "
          f"{time.perf_counter() - t_slice:.1f}s")
    del params
    rows = phase_timings(dev)
    compute_errs = {**phase_k8_check(dev), **phase_k9_check(dev),
                    **phase_k7_check(dev)}
    phase_sass()
    compute_counts, sweep_summary = phase_compute_main(dev)
    for key, err in sweep_summary["output_max_abs_err"].items():
        e = compute_errs["mixbench_" + key.split("/")[0]]
        e["max_abs_err_f32"] = max(e["max_abs_err_f32"], err)
    compute_rows = phase_compute_timings(dev)
    t_ssm = time.perf_counter()
    k10_errs = phase_k10(dev)
    phase_smoke_e2e(dev, arch="mamba2-780m")
    m_cfg, m_params = init_mamba(dev)
    m_fixed_counts, m_fixed = serve_mamba(dev, m_cfg, m_params,
                                          "mamba2 fixed-lane", (0, 1, 2))
    m_paged_counts, m_paged = serve_mamba(dev, m_cfg, m_params,
                                          "mamba2 paged", (1, 2),
                                          paged=True)
    m_forward = phase_ssm_forward(dev, m_cfg, m_params)
    del m_params
    torch.cuda.empty_cache()
    k10_row = k10_timing(dev)
    print(f"[mamba2] the SSM phases took {time.perf_counter() - t_ssm:.1f}s")
    t_hybrid = time.perf_counter()
    h_smoke = {}
    for kv_quant in (None, "int8"):
        fixed, paged = phase_smoke_e2e(dev, kv_quant=kv_quant,
                                       arch="hymba-1.5b")
        h_smoke[kv_quant] = fixed, paged
        need = (("decode_attention_q8_lengthaware",
                 "decode_attention_paged_q8") if kv_quant else
                ("decode_attention_lengthaware", "decode_attention_paged"))
        if not (fixed["flash_attention_cc"] and fixed["ssd_chunk"] and
                fixed[need[0]] and paged[need[1]]):
            fail(f"the float32 hymba SMOKE serves (kv {kv_quant}) missed a "
                 f"kernel of their path: {fixed} {paged}")
    h_cfg, h_params = init_hymba(dev)
    h_fixed_counts, h_fixed = serve_hymba(dev, h_cfg, h_params,
                                          "hymba fixed-lane")
    h_paged_counts, h_paged = serve_hymba(dev, h_cfg, h_params,
                                          "hymba paged", paged=True,
                                          page_size=16)
    del h_params
    torch.cuda.empty_cache()
    hymba_rows = phase_hymba_timings(dev)
    print(f"[hymba] the hybrid phases took "
          f"{time.perf_counter() - t_hybrid:.1f}s")
    t_family = time.perf_counter()
    olmo_smoke = {}
    for kv_quant in (None, "int8"):
        fixed, paged = phase_smoke_e2e(dev, kv_quant=kv_quant,
                                       arch="olmo-1b")
        olmo_smoke[kv_quant] = fixed, paged
        need = (("decode_attention_q8_lengthaware",
                 "decode_attention_paged_q8") if kv_quant else
                ("decode_attention_lengthaware", "decode_attention_paged"))
        if not (fixed["flash_attention_cc"] and fixed[need[0]] and
                paged[need[1]]):
            fail(f"the float32 olmo SMOKE serves (kv {kv_quant}) missed a "
                 f"kernel of their path: {fixed} {paged}")
    family_errs = {arch: phase_family_kernels(dev, arch)
                   for arch in FAMILY_SERVES}
    family = {arch: phase_family_serve(dev, arch) for arch in FAMILY_SERVES}
    family_rows = {arch: phase_family_timings(dev, arch)
                   for arch in FAMILY_SERVES}
    print(f"[family] the dense-family phases (and moonshot-v1-16b-a3b's "
          f"and phi-3-vision-4.2b's full width) took "
          f"{time.perf_counter() - t_family:.1f}s")
    t_encdec = time.perf_counter()
    moe_vlm_smoke = phase_moe_vlm_smoke(dev)
    moe_quant = phase_moe_quant_smoke(dev)
    whisper_smoke = phase_whisper_smoke(dev)
    whisper_full = phase_whisper_full(dev)
    whisper_rows = phase_whisper_timings(dev)
    print(f"[moe/vlm/whisper] phases 36-40 took "
          f"{time.perf_counter() - t_encdec:.1f}s")
    t_train = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    k2_bwd = phase_k2_backward(dev)
    train_smoke = phase_train_smoke(dev)
    train_full = phase_train_full(dev)
    print(f"[train] phases 41-43 took {time.perf_counter() - t_train:.1f}s")
    t_families = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    k10_bwd = phase_k10_backward(dev)
    families_smoke = {arch: phase_train_smoke(dev, arch)
                      for arch in TRAIN_SMOKE_ARCHS if arch != "qwen2.5-1.5b"}
    families_full = {}
    for arch, layers, control, ck_step in TRAIN_FAMILIES_FULL:
        families_full[arch] = phase_train_family_full(dev, arch, layers,
                                                      control, ck_step)
    family_phase_s = {
        "44 (K10 backward)": k10_bwd["phase_s"],
        **{f"45 ({a} SMOKE)": r["phase_s"] for a, r in families_smoke.items()},
        **{f"46 ({a} full)": r["phase_s"] for a, r in families_full.items()}}
    print(f"[train families] phases 44-46 took "
          f"{time.perf_counter() - t_families:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in family_phase_s.items()))
    gc.collect()
    torch.cuda.empty_cache()
    t_m16 = time.perf_counter()
    fleet = phase_fleet(dev)
    dry_cells, dry_metas = phase_dryrun_cells()
    dry_check = phase_dryrun_check(dev, dry_metas)
    print(f"[fleet/dryrun] phases 47-49 took "
          f"{time.perf_counter() - t_m16:.1f}s: 47 (fleet, token "
          f"accounting) {fleet['phase_s']:.1f}s, 48 (dry run, "
          f"{dry_cells['n_cells']} cells) {dry_cells['wall_s']:.1f}s, 49 "
          f"(dry run vs card, --mesh) {dry_check['phase_s']:.1f}s")
    prefill_graphs = phase_prefill_graphs(dev)
    mesh = phase_mesh(dev)
    m16_launches = {
        "flash_attention_mma": {
            "fleet_replay": fleet["launches"]["flash_attention_mma"],
            "dryrun_check": {k: v["launches"].get("flash_attention_mma", 0)
                             for k, v in dry_check.items()
                             if isinstance(v, dict)}},
        "decode_attention_lengthaware": {
            "fleet_replay": fleet["launches"][
                "decode_attention_lengthaware"],
            "dryrun_check": {k: v["launches"].get(
                "decode_attention_lengthaware", 0)
                for k, v in dry_check.items() if isinstance(v, dict)}},
        "ssd_chunk": {
            "dryrun_check": {k: v["launches"].get("ssd_chunk", 0)
                             for k, v in dry_check.items()
                             if isinstance(v, dict)}}}

    replaces = {
        "decode_attention_paged":
            "src/repro/kernels/decode_attention/kernel.py:322",
        "flash_attention_mma":
            "src/repro/kernels/flash_attention/kernel.py:85",
        "flash_attention_cc":
            "src/repro/kernels/flash_attention/kernel.py:85",
        "decode_attention_lengthaware":
            "src/repro/kernels/decode_attention/kernel.py:205",
        "decode_attention_masked":
            "src/repro/kernels/decode_attention/kernel.py:98",
        "decode_attention_paged_q8":
            "src/repro/kernels/decode_attention/kernel.py:406",
        "decode_attention_q8_lengthaware":
            "src/repro/kernels/decode_attention/kernel.py:545",
        "decode_attention_q8_masked":
            "src/repro/kernels/decode_attention/kernel.py:456",
    }
    sources = {"flash_attention_mma": "flash_attention",
               "flash_attention_cc": "flash_attention",
               "decode_attention_lengthaware": "decode_attention_dense",
               "decode_attention_masked": "decode_attention_dense",
               "decode_attention_q8_lengthaware": "decode_attention_dense",
               "decode_attention_q8_masked": "decode_attention_dense",
               "decode_attention_paged_q8": "decode_attention_paged"}
    # each kernel's launches come from the main-path run that drives it:
    # K1 from the paged serve, K2's tensor-core kernel and K3 from the
    # fixed-lane (default) serve, K5 from the fixed-lane int8 serve, K4
    # from the paged int8 serve, K2's CUDA-core kernel from the float32
    # SMOKE serve on the card (fixed-lane, greedy); K6a and K6b are on no
    # serving path and report the count of the fixed-lane serve of their
    # cache type, 0
    # hymba-1.5b: K2's tensor-core kernel, K3 and K10 from its fixed-lane
    # serve, K1 from its paged serve, K5 and K4 from its float32 int8
    # SMOKE serves (fixed-lane and paged, greedy), K2's CUDA-core kernel
    # from its float32 SMOKE serve; errors at its shapes (bf16, f32 beside)
    hymba_launches = {
        "flash_attention_mma": h_fixed_counts["flash_attention_mma"],
        "flash_attention_cc": h_smoke[None][0]["flash_attention_cc"],
        "decode_attention_lengthaware":
            h_fixed_counts["decode_attention_lengthaware"],
        "decode_attention_paged": h_paged_counts["decode_attention_paged"],
        "decode_attention_q8_lengthaware":
            h_smoke["int8"][0]["decode_attention_q8_lengthaware"],
        "decode_attention_paged_q8":
            h_smoke["int8"][1]["decode_attention_paged_q8"],
        "ssd_chunk": h_fixed_counts["ssd_chunk"]}
    hymba_errs["flash_attention_mma"] = {
        "bfloat16": errs["flash_attention_mma"]["hymba"]}
    hymba_errs["flash_attention_cc"] = {
        "float32": errs["flash_attention_cc"]["hymba"]}

    def hymba_entry(name):
        out = {"launches": hymba_launches[name]}
        r = hymba_rows.get(name)
        if r is not None:
            out.update({k: r[k] for k in r if k not in ("peak", "s1024")})
            if "s1024" in r:
                out["s1024"] = {k: r["s1024"][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "shape")}
        for dtype, tag in (("bfloat16", ""), ("float32", "_f32")):
            if dtype in hymba_errs.get(name, {}):
                out[f"max_abs_err{tag}"], out[f"tol{tag}"] = \
                    hymba_errs[name][dtype]
        return out

    # the dense family, moonshot and phi-3-vision at full width: K2
    # (the kernel its head dim selects: the tensor cores, at D 128 and at
    # phi-3-vision's D 96) and K3 from each config's fixed-lane
    # serve (qwen2.5-32b and moonshot: the paged serve, which launches no
    # K3), K1 from the paged serve; K2's CUDA-core kernel, K5 and K4
    # from olmo's float32 SMOKE serves (KV in float32, and in int8:
    # fixed-lane and paged, greedy); errors and timings at each config's
    # shapes
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import kernel_for

    def family_entry(name):
        out = {}
        for arch, serves in family.items():
            counts = {layout: c for layout, (c, _) in serves.items()}
            first = counts.get("fixed-lane", counts["paged"])
            k2 = f"flash_attention_{kernel_for(torch.bfloat16, get_config(arch).hd)}"
            launches = {
                k2: first[k2],
                "decode_attention_lengthaware":
                    first["decode_attention_lengthaware"],
                "decode_attention_paged":
                    counts["paged"]["decode_attention_paged"]}
            e = {}
            if arch == "olmo-1b":
                launches.update({
                    "flash_attention_cc":
                        olmo_smoke[None][0]["flash_attention_cc"],
                    "decode_attention_q8_lengthaware":
                        olmo_smoke["int8"][0][
                            "decode_attention_q8_lengthaware"],
                    "decode_attention_paged_q8":
                        olmo_smoke["int8"][1]["decode_attention_paged_q8"]})
            if name in launches:
                e["launches"] = launches[name]
            r = family_rows[arch].get(name)
            if r is not None:
                e.update({k: r[k] for k in r if k not in ("peak",)})
            for dtype, tag in (("bfloat16", ""), ("float32", "_f32"),
                               ("scaled", "_scaled"), ("scale", "_scale")):
                if dtype in family_errs[arch].get(name, {}):
                    e[f"max_abs_err{tag}"], e[f"tol{tag}"] = \
                        family_errs[arch][name][dtype]
            if e:
                out[arch] = e
        return out

    # whisper-base at full width: K2's tensor-core kernel from ``encode``
    # (unmasked, Sq = Sk = 1500) and the teacher-forced ``decode_forward``
    # (causal, and unmasked at Sq 64 against Sk 1500), K3 from
    # ``decode_n_steps`` (self-attention and the cross K/V); errors at
    # its shapes (phases 3 and 4) and timings (phase 40)
    def whisper_entry(name):
        launches = {"flash_attention_mma": {
            "encode": whisper_full["launches"]["encode"],
            "forward": whisper_full["launches"]["forward"]},
            "decode_attention_lengthaware":
                whisper_full["launches"]["decode_n_steps"]}
        out = {}
        if name in launches:
            out["launches"] = launches[name]
        if "whisper" in errs.get(name, {}):
            out["max_abs_err"], out["tol"] = errs[name]["whisper"]
        for key in ("scaled", "scale"):
            if key in errs.get(name, {}):
                out[f"max_abs_err_{key}"], out[f"tol_{key}"] = \
                    errs[name][key]
        for key, r in whisper_rows.items():
            kname, part = key.split("/")
            if kname == name:
                out[part] = {k: r[k] for k in r if k != "peak"}
        return out

    # training: K2's tensor-core kernel from the full-width run (30 steps
    # uninterrupted, then 15 resumed from the checkpoint; 56 a step), its
    # CUDA-core kernel from the SMOKE float32 steps on the card (all four
    # remat/microbatch runs); the backward's error (phase 41) and time;
    # the other families' launches a step at full width (phase 46) and
    # over their SMOKE steps (phase 45)
    def smoke_launches(runs, name):
        """``name``'s launches over one config's SMOKE runs (the four
        remat/microbatch runs; not the control's)."""
        return sum(r["launches"].get(name, 0) for r in runs.values()
                   if isinstance(r, dict) and "launches" in r)

    def family_launches(name):
        full = {a: r["launches_per_step"][name]
                for a, r in families_full.items()
                if name in r["launches_per_step"]}
        smoke = {a: smoke_launches(runs, name)
                 for a, runs in families_smoke.items()}
        return {"per_step_full_width": full,
                "smoke": {a: n for a, n in smoke.items() if n}}

    def training_entry(name):
        if name == "flash_attention_mma":
            t = k2_bwd["timing"]
            return {
                "families": family_launches(name),
                "backward_cases": k2_bwd[name]["cases"],
                "launches": train_full["launches"][name],
                "launches_resumed": train_full["launches_resumed"][name],
                "launches_per_step": train_full["launches_per_step"],
                "forward_max_abs_err": k2_bwd[name]["fwd bfloat16"][0],
                "forward_scaled": k2_bwd[name]["fwd scaled"][0],
                "forward_scale": k2_bwd[name]["fwd scale"][0],
                "backward_max_abs_err": k2_bwd[name]["bfloat16"][0],
                "backward_tol": k2_bwd[name]["bfloat16"][1],
                "backward_control_err": k2_bwd["control"][0],
                "backward_ms_per_call": train_full[
                    "k2_backward_ms_per_call"],
                "backward_ms_per_step": train_full[
                    "k2_backward_ms_per_step"],
                "forward_ms_per_step": train_full["k2_forward_ms_per_step"],
                "fwd_bwd_ms": t["fwd_bwd_ms"],
                "plain_fwd_bwd_ms": t["plain_fwd_bwd_ms"],
                "library_fwd_bwd_ms": t["library_fwd_bwd_ms"],
                "shape": t["shape"],
                "step_ms_median": train_full["step_ms_median"]}
        if name == "flash_attention_cc":
            return {
                "launches": smoke_launches(train_smoke, name),
                "forward_max_abs_err": k2_bwd[name]["fwd float32"][0],
                "backward_max_abs_err": k2_bwd[name]["float32"][0],
                "backward_tol": k2_bwd[name]["float32"][1],
                "families": family_launches(name)}
        return None

    # the mesh (phase 51): each rank's launches from zero before each
    # path (K2: the sharded first step's pass and three steps; K3: four
    # decode steps in each dtype) at the local heads, and the kernels
    # checked and timed at those shapes on rank 0
    r0 = mesh["ranks"][0]
    mesh_entries = {
        "flash_attention_mma": {
            "mesh": r0["mesh"], "backend": r0["backend"],
            "launches_by_rank": [r["train_launches"].get(
                "flash_attention_mma", 0) for r in mesh["ranks"]],
            "heads": r0["train_heads"], **r0["k2"]},
        "decode_attention_lengthaware": {
            "mesh": r0["mesh"], "backend": r0["backend"],
            "launches_by_rank": {dt: [r["decode"][dt]["launches"].get(
                "decode_attention_lengthaware", 0) for r in mesh["ranks"]]
                for dt in MESH_DECODE_DTYPES},
            "heads": r0["decode"]["bfloat16"]["heads"], **r0["k3"]}}
    int8_fixed = int8["full e2e fixed-lane int8"][0]
    int8_paged = int8["full e2e paged int8"][0]
    launches = dict(fixed_counts)
    launches["decode_attention_paged"] = paged_counts["decode_attention_paged"]
    launches["flash_attention_cc"] = smoke_counts["flash_attention_cc"]
    for name in ("decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        launches[name] = int8_fixed[name]
    launches["decode_attention_paged_q8"] = \
        int8_paged["decode_attention_paged_q8"]
    kernels = []
    for name in ("decode_attention_paged", "flash_attention_mma",
                 "flash_attention_cc", "decode_attention_lengthaware",
                 "decode_attention_masked", "decode_attention_paged_q8",
                 "decode_attention_q8_lengthaware",
                 "decode_attention_q8_masked"):
        r = rows[name]
        # max_abs_err is that of the dtype the main path launches: float32
        # for K2's CUDA-core kernel (the SMOKE serve; its own shape's
        # error stands beside, as max_abs_err_smoke_shape), bf16 for the
        # rest; the other dtype's stands beside it
        main_dtype = ("float32" if name == "flash_attention_cc"
                      else "bfloat16")
        err, tol = errs[name][main_dtype]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err, "tol": tol,
            "ms": r["ms"], "host_ms": r["host_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bytes": r["bytes"]}
        for other, tag in (("float32", "f32"), ("bfloat16", "bf16")):
            if other != main_dtype and other in errs[name]:
                entry[f"max_abs_err_{tag}"], entry[f"tol_{tag}"] = \
                    errs[name][other]
        if "smoke" in errs[name]:
            entry["max_abs_err_smoke_shape"] = errs[name]["smoke"][0]
        for extra in ("route_ms", "gather_sdpa_ms"):
            if extra in r:
                entry[extra] = r[extra]
        for sub in ("s1024", "d96"):
            if sub in r:
                entry[sub] = {key: r[sub][key] for key in (
                    "ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}
        # bf16 D 96 (phase 3's cases): worst error, scaled-bound ratio
        # and least-squares scale
        for key, tag in (("d96", ""), ("d96_scaled", "_scaled"),
                         ("d96_scale", "_scale")):
            if key in errs[name]:
                sub = entry.setdefault("d96", {})
                sub[f"max_abs_err{tag}"], sub[f"tol{tag}"] = errs[name][key]
        if name in hymba_launches:
            entry["hymba"] = hymba_entry(name)
        fam = family_entry(name)
        if fam:
            entry["dense_family"] = fam
        wh = whisper_entry(name)
        if wh:
            entry["whisper"] = wh
        tr = training_entry(name)
        if tr:
            entry["training"] = tr
        if name in m16_launches:
            entry["m16"] = m16_launches[name]
        if name in mesh_entries:
            entry["mesh"] = mesh_entries[name]
        kernels.append(entry)
    compute_replaces = {
        "mixbench_fma": "src/repro/kernels/mixbench/kernel.py:56",
        "mixbench_mul_add": "src/repro/kernels/mixbench/kernel.py:56",
        "fma_matmul_mxu": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mxu_wmma": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mul_add": "src/repro/kernels/fma_matmul/kernel.py:69",
        "fma_matmul_mul_add_staged":
            "src/repro/kernels/fma_matmul/kernel.py:69",
        "qmatmul_dequant_dot": "src/repro/kernels/qmatmul/kernel.py:197",
        "qmatmul_dot_i8": "src/repro/kernels/qmatmul/kernel.py:149"}
    for name, replaced in compute_replaces.items():
        r = compute_rows[name]
        src = next(f for f in ("mixbench", "fma_matmul", "qmatmul")
                   if name.startswith(f))
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{src}.cu",
                 "replaces": replaced, "launches": compute_counts[name],
                 **compute_errs[name], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "bytes": r["bytes"], "shape": r["shape"]}
        for extra in ("route_ms", "ms_by_format", "single_call_ms",
                      "by_shape"):
            if extra in r:
                entry[extra] = r[extra]
        kernels.append(entry)
    # K10's launches: the fixed-lane (default) mamba2 serve, 48 per prompt;
    # the serve discards their output (as the reference does), the float32
    # forward's launches are the ones whose output is gated
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:68",
        "launches": m_fixed_counts["ssd_chunk"],
        "launches_paged_serve": m_paged_counts["ssd_chunk"],
        "launches_forward_checked": m_forward["fp32_forward_k10_launches"],
        **k10_errs,
        "ms": k10_row["ms"], "plain_ms": k10_row["plain_ms"],
        "bound_ms": k10_row["bound_ms"], "bound_by": k10_row["bound_by"],
        "library_ms": None, "bytes": k10_row["bytes"],
        "flops": k10_row["flops"], "shape": k10_row["shape"],
        "ms_s2048": k10_row["ms_s2048"], "hymba": {
            **hymba_entry("ssd_chunk"),
            "max_rel_err": k10_errs["max_rel_err_hymba"],
            "max_rel_err_f32": k10_errs["max_rel_err_hymba_f32"],
            "tol": K10_TOL,
            "launches_paged_serve": h_paged_counts["ssd_chunk"]},
        # training (phases 44-46): launches a step at full width (mamba2
        # 96, hymba 64), over the SMOKE float32 steps, the backward's
        # readings against the plain autograd and its times
        "training": {
            **family_launches("ssd_chunk"),
            "backward_max_rel_err": k10_bwd["max_backward_rel_err"],
            "backward_tol": K10_BWD_TOL,
            "backward_control_err": k10_bwd["control_err_min"],
            "backward_cases": k10_bwd["cases"],
            "padded_rel_err": k10_bwd["padded_rel_err"],
            **k10_bwd["timing"]},
        "m16": m16_launches["ssd_chunk"]})
    e2e = {"paged": paged_e2e, "fixed_lane": fixed_e2e,
           "paged_int8": int8["full e2e paged int8"][1],
           "fixed_lane_int8": int8["full e2e fixed-lane int8"][1]}
    e2e["fixed_lane_t0.8"] = fixed_e2e.pop("temperature_0.8")
    for name, r in e2e.items():
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch (eager "
              f"{g['decode_ms_eager']:.2f}, graph {g['decode_ms_graph']:.2f}"
              f" at n_steps {g['n_steps']}), capture s {g['capture_s']}")
    for name, r in (("mamba2 fixed_lane", m_fixed), ("mamba2 paged",
                                                      m_paged)):
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, prompt streaming "
              f"{r['stream_ms_per_token']:.3f} ms per token in the serve "
              f"(check: eager {g['stream_ms_per_token_eager']:.3f}, "
              f"replayed {g['stream_ms_per_token_graph']:.3f}), decode "
              f"eager {g['decode_ms_eager']:.2f}, graph "
              f"{g['decode_ms_graph']:.2f} ms per dispatch")
    print(f"[e2e] {json.dumps(e2e)}")
    ssm_e2e = {"fixed_lane": m_fixed, "paged": m_paged,
               "forward": m_forward}
    print(f"[mamba2] {json.dumps(ssm_e2e)}")
    for name, r in (("hymba fixed_lane", h_fixed), ("hymba paged",
                                                     h_paged)):
        g = r["graphs"]
        print(f"[e2e] {name}: {r['tok_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch in the "
              f"serve (check at n_steps {g['n_steps']}: eager "
              f"{g['decode_ms_eager']:.2f}, replayed "
              f"{g['decode_ms_graph']:.2f}); prompt streaming "
              f"{r['stream_ms_per_token']:.3f} ms per token in the serve "
              f"(check: eager {g['stream_ms_per_token_eager']:.3f}, "
              f"replayed {g['stream_ms_per_token_graph']:.3f}); prefill ms "
              f"by bucket {({b: round(t, 2) for b, t in sorted(r['prefill_ms'].items())})}"
              f"; capture s {g['capture_s']}")
    print(f"[hymba] {json.dumps({'fixed_lane': h_fixed, 'paged': h_paged})}")
    for arch, serves in family.items():
        for layout, (_, r) in serves.items():
            g = r["graphs"]
            print(f"[e2e] {arch} {layout}: {r['tok_s']:.1f} tok/s, decode "
                  f"{r['decode_ms_per_dispatch']:.2f} ms per dispatch in "
                  f"the serve (replayed median "
                  f"{g['replayed_ms_median']:.2f}; check at n_steps "
                  f"{g['n_steps']}: eager {g['decode_ms_eager']:.2f}, "
                  f"replayed {g['decode_ms_graph']:.2f}); prefill ms by "
                  f"bucket {({b: round(t, 2) for b, t in sorted(r['prefill_ms'].items())})}"
                  f"; peak {r['peak_gib']:.2f} GiB")
    print(f"[family] {json.dumps({a: {l: r for l, (_, r) in v.items()} for a, v in family.items()})}")
    print(f"[e2e] share full: {share_full['tok_s']:.1f} tok/s shared "
          f"({share_full['tok_s_second']:.1f} again), "
          f"{share_full['tok_s_unshared']:.1f} unshared; tail "
          f"{share_full['tail_ms_per_token']:.3f} ms a streamed token; "
          f"{share_full['same_as_unshared']}/{share_full['n_streams']} "
          f"streams equal to the unshared serve's; kv_pages_hwm "
          f"{share_full['kv_pages_hwm']}")
    print(f"[share] {json.dumps(share_full)}")
    print(f"[preempt] {json.dumps(preempt)}")
    print(f"[obs] {json.dumps({'smoke': obs_smoke, 'full': obs_full, 'ladder': ladder_full})}")
    print(f"[quant] {json.dumps({'smoke': quant_smoke, 'full': quant_full})}")
    print(f"[multimodel] {json.dumps(multimodel)}")
    print(f"[replay] {json.dumps(replay)}")
    print(f"[moe/vlm smoke] {json.dumps({a: {'fixed_lane': f, 'paged': p} for a, (f, p) in moe_vlm_smoke.items()})}")
    print(f"[moe quant] {json.dumps(moe_quant)}")
    print(f"[whisper] {json.dumps({'smoke': whisper_smoke, 'full': whisper_full})}")
    print(f"[sweep] {json.dumps(sweep_summary)}")
    print(f"[train] {json.dumps({'k2_backward': k2_bwd, 'smoke': train_smoke, 'full': train_full})}")
    print(f"[train families] {json.dumps({'k10_backward': k10_bwd, 'smoke': families_smoke, 'full': families_full, 'phase_s': family_phase_s})}")
    print(f"[fleet] {json.dumps(fleet)}")
    print(f"[dryrun] {json.dumps({'cells': dry_cells, 'check': dry_check})}")
    print(f"[prefill graphs] {json.dumps(prefill_graphs)}")
    print(f"[mesh] {json.dumps(mesh)}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
