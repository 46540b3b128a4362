#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX or of the JAX
package ``repro``, and exits non-zero with no result line when there is no
CUDA device or no ``src/repro_torch`` beside it. Phases:

  1. environment: the card's name and power limit (``nvidia-smi``);
  2. build: the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``), all
     sources' parts at once, with the ``-Xptxas -v`` registers/spills of
     the nx=5 combine instances (which must not spill) and of the ssm_scan
     and flash attention instances;
  3. combine kernel parity: each combine against its plain PyTorch
     version on the card — the main path's top scan level (B=16,384
     pairs, nx=5) in f64 and f32, edge shapes and B=0 on packed input, and
     scan levels read in place: a [64, 512] element set's first and second
     calls, an odd-T slice that is only 8-byte aligned, nx=1/8/16 — then
     timings (CUDA events over back-to-back calls, and device time by CUDA
     graph replay) on packed and in-place input beside the memory/compute
     bound, the packing cost the scan no longer pays, and a sweep over the
     service's level sizes (64 rows x 256 ... 1 pairs);
  4. smoother path: ``serve_smoother`` on 64 coordinated-turn requests (n
     up to 512, launch width 64, f64) on the card, with the launch
     counters zeroed just before and read just after (and no packing copy
     in its scans); then checks against the same fleet served with the
     plain versions (``backend="jnp"``) and against the sequential
     smoother at the same linearization; then a profile of one bucket
     launch;
  5. ``[slr]``: the same service linearized by sigma-point SLR (IPLS,
     cubature points, ``method="slr"``), with the same gates, the same
     checks against the plain versions and the sequential smoother, and a
     profile of one bucket launch;
  6. ``[matrix]``: the port's scenario matrix on the card (six scenarios
     x {taylor, slr} x {standard, sqrt}, n = 24, 3 passes), every cell
     gated ok, the combine launches of each standard-form cell counted,
     each cell held against its twin with the plain combines;
  7. ``[sqrt]``: one 64 x 512 bucket in the square-root form, timed
     beside the standard form and held against it at one linearization;
  8. ``[adaptive]``: one 64 x 512 bucket with adaptive damping (Taylor
     and SLR): lane codes and pass counts equal to the plain run's, no
     NaN, kernel launches counted;

  Every phase runs ``backend="auto"``: a bucket shape the autotuner
  measured takes its winner, kernel or plain version, and a shape nothing
  measured (phases 4-8, the one-shot path, the retry lane) the kernels.

  9. ``[autotune]``: the kernel-vs-plain verdict (``kernel_us``,
     ``fused_us``, choice, from the f32 probe) for every bucket shape of
     the stream (n_pad 256 and 512 x widths 1 ... 64), with the same probe
     in f64 beside it; an ``"auto"`` f64 filter+smoother pass at the shape
     must launch the combine kernels if and only if the choice is
     "pallas", and must not be slower than the same pass on the other
     backend;
  10. ``[stream]``: ``serve_smoother`` with the JAX service's streaming
     defaults (64 coordinated-turn requests, n in {256, 384, 512}, width
     64, f64, Poisson at 8/s, deadline policy, 2 s deadline, 0.25 s wait
     cap, warmed): latency percentiles, throughput, deadline hit rate,
     goodput, occupancy, flush reasons, backend choices and launches;
     every verdict ok, no launch error, each flush's launches as its
     measured choice says, each request's mean within PATH_TOL of the
     [main] one-shot run's, median position RMSE < 0.1;
  11. ``[chaos]``: the same stream on the same warm server under the
     static policy, fault-free and under `CHAOS` (NaN payloads in 0.1 of
     the requests, a transient exception and a straggler each in 0.5 of
     the flushes): at least one of each injected, every corrupted request
     verdicted, no NaN to a client, healthy requests bit-identical to the
     fault-free run;
  12. ``[tenants]``: coordinated_turn, pendulum (gold) and lorenz96
     (batch) through one queue, 16 requests, n <= 512, Poisson at 8/s,
     deadline policy: latency, deadline hit rate, RMSE, log-likelihood
     and kernel launches per tenant; no launch mixes tenants or errs;
  13. ``[surface]``: the single-trajectory surface on the paper's
     configuration (coordinated_turn, one trajectory of n = 4096 from seed
     0, f64): ``ieks`` and ``ipls`` (10 passes, LM damping 1.0) with the
     counters zeroed before and read after, each combine kernel launching
     exactly 10 x the non-empty combine calls of one scan, no plain
     combine and no other kernel; each result equal bit for bit to
     ``build_smoother(...).iterate``, within PATH_TOL of
     ``iterated_smoother`` on the plain versions, finite and not
     diverged, and a second call warning no more; at one Taylor
     linearization of the IEKS result, ``parallel_filter_smoother``
     through the kernels against the textbook combines (TOL), the
     sequential pass and the square-root form (SEQ_TOL),
     ``parallel_filter`` + ``parallel_smoother`` and the public
     ``associative_scan`` bit for bit, ``kalman_filter`` with its
     log-likelihood, ``smoothed_log_likelihood`` and ``gn_cost`` against
     the ``Smoother``'s methods; the paper's Fig. 1b panel in f32 (one
     Gauss-Newton pass at n = 128, 1,024, 4,096 through the kernels,
     the textbook combines and sequentially, launches and device busy
     per pass); each combine kernel's device time at B = 1's top level
     beside its bound;
  14. ``[ssm_scan]``: the linear-recurrence entry points at Hymba-1.5B's SSM
     width (``ops.ssm_scan`` on B=2, T=4096, D=51,200 and
     ``linear_recurrence_scan(combine_impl="pallas")`` on [4096, 2, 3200,
     16], f32) with the counters zeroed before and read after; each held
     against the plain version in f32, f64 and bf16, with edge shapes,
     T=0 and ``h0``; CUDA-event times of kernel and plain version;
  15. ``[flash]``: the flash attention entry point at Llama-3.2-3B's
     attention width (Hq=24, Hkv=8, Dh=128): prefill B=2, T=4096, causal,
     and decode B=16, Tq=1, Tk=4096, bf16, with the counters zeroed before
     and read after: the prefill must launch the ``wgmma`` kernel once and
     the decode the split-K kernel once, and nothing else. Each is held
     against the plain version (prefill and decode also in f32, through
     the FMA and decode kernels), against the plain version in f32 on
     peaked bf16 inputs at a tolerance derived from bf16 rounding, and on
     edge cases (MQA, T=100/130 at Dh 64/128, non-causal, Dh 16/32/256,
     ragged decode splits, Tk=1, Tq > Tk against the oracle), each edge
     asserting which kernel served it; the split-K decode under a head map
     (a tensor-parallel rank's q heads against its own cache, in place:
     qwen2-1.5b's uneven 6 + 2 map on "model" 2, and a map into a
     replicated cache), each one launch, held against the plain version
     with its log-sum-exps, a planted map (one q head on the other kv
     head) missing the tight bound; CUDA-event times of the new
     kernels, of the FMA kernel on the same inputs, of the plain version
     and of ``scaled_dot_product_attention`` (timed only, never on the
     port's path), profiler device times, and the decode/``wgmma``
     crossover over the rows per kv head;
  16. ``[lm_decode]``: the LM decode service (``launch.serve.serve``) for
     qwen2-1.5b at full width (28 layers, d_model 1536, 12 query heads
     padded to 16, 2 kv heads, head_dim 128, vocabulary 151,936 padded to
     153,600, tied embeddings), bf16, random weights from seed 0: batch 64,
     a 128-token prompt teacher-forced, 128 greedy steps, caches of 512.
     Gates first, on the same weights and prompts, each held against the
     same model computed in float32 (plain attention), whose distance to
     the plain bf16 path is the bf16 noise: the first 32 teacher-forced
     steps with the split-K decode kernel (error against float32 within
     `LM_NOISE_FACTOR` times the noise, top-1 equal to float32's on
     `LM_TOP1` of the positions no noise can flip, and every top-1
     mismatch with the plain bf16 steps a near tie), and ``prefill`` (the
     ``wgmma`` kernel, once per layer) and the teacher-forced decode at
     position 127, each against float32's prefill by the same rules.
     Then the timed service run with the counters zeroed before and read
     after: the decode kernel launches exactly 28 x 256 times, nothing
     else and no plain attention; tok/s and wall per step; a profile of
     32 decode steps (device busy, idle share); the decode kernel's time
     at L = 512 against its byte bound, the plain version and SDPA on the
     same cache, and the ``wgmma`` prefill's time;
  17. ``[lm_hybrid]``: the LM decode service's loop (``generate``) for
     hymba-1.5b at full width and depth 8 of its 32 layers (d_model 1600,
     25 query heads padded to 32, 5 kv heads, head_dim 64, d_ff 5504, SSM
     d_inner 3200, state 16, conv 4, a 1,024-row sliding window except in
     the first, middle and last layers 0, 4 and 7, vocabulary 32,001
     padded to 32,768), bf16, random weights from seed 0: batch 64, a
     1,024-token prompt teacher-forced, 64 greedy steps, caches of 1,088,
     so the 5 windowed layers' rings wrap at step 1,024. The loop with
     the counters zeroed before and read after: exactly 8 x 1,088
     decode-kernel launches, nothing else, no plain attention and no plain
     scan (the SSM step is elementwise). Then, continuing from the
     service's own caches: every decode-kernel call of the 32 steps after
     its last (the rings wrapped, the global layers' caches full) against
     plain on its own q and ring or cache at the tight bf16 bound, which a
     read one row short misses at every step; a profile of 32 steps past
     them; ``prefill`` of the first 8 sequences' 1,088 tokens, which
     launches ``wgmma`` 8 times (with the window in the windowed layers)
     and ``ssm_scan`` 8 x 5 times (chunks of 256), each call held against
     its plain version on its own inputs (the attention at the tight bf16
     bound, which the same call with the window one key wider misses; the
     scan at the float32 TOL); the service's logits at its last step and
     the prefill's, each against the same model in float32 by the bf16
     noise (as ``[lm_decode]``), and against each other; device times of
     the windowed ``wgmma`` prefill (SDPA with the window as a boolean
     mask beside it), of the decode kernel on a full ring (SDPA beside
     it) and of ``ssm_scan`` at one prefill chunk, each beside its bound;
  18. ``[lm_moe]``: the LM decode service for deepseek-moe-16b at full
     width (28 layers, d_model 2048, 16 query and 16 kv heads, head_dim
     128, 64 routed experts top-6 plus 2 shared, expert d_ff 1,408,
     vocabulary 102,400; 33.8 GB in bf16), random weights from seed 0:
     batch 64, a 64-token prompt teacher-forced, 64 greedy steps, caches
     of 128. The service with the counters zeroed before and read after:
     exactly 28 x 128 decode-kernel launches and nothing else, no plain
     attention. Then, on the same weights, teacher-forced over the
     service's positions: every decode-kernel call of the first 16 steps
     against plain at the tight bf16 bound (a planted fault, one key too
     few, misses it at every length), the dropped assignments per step
     (a decode step has C = 8 slots per expert for 384 assignments; some
     step must drop), a profile of 32 steps; one ``moe_layer`` at full
     width on a layer's real decode input, under
     ``set_sync_debug_mode("error")`` (no host sync), and in float32 on
     the card and on the CPU from the same weights (routing equal, drops
     > 0, outputs at the float32 TOL); ``prefill`` at B = 8, T = 64 (28
     ``wgmma`` launches, each against plain). No model-level float32
     logit gate: the float32 model (67.5 GB) does not fit beside the bf16
     one, and the per-call gates carry the weight. Then grok-1-314b at
     full width and depth 2 of 64 (22.9 GB in bf16; the card holds 80):
     the service loop (`generate`) at batch 64, 64 prompt and 64 greedy
     steps, caches of 128: 2 x 128 decode-kernel launches, every one with
     the softcap 30 and held against plain with it (fault planted); a
     profile of 16 steps; a prefill at B = 8, T = 128 (2 ``wgmma``
     launches with the cap); and
     the cap acting on kernel inputs at grok's head shape (48 query and 8
     kv heads, Dh 128) scaled so that many scores pass +-60: the prefill
     and decode kernels within the tight bound of plain with the cap,
     which plain without it misses. Device times of the decode kernel at
     deepseek's (1 row per kv head, L = 128) and grok's (6 rows, L = 128,
     cap 30) shapes and of both prefills, beside their bounds and SDPA
     (which has no softcap);
  19. ``[lm_xlstm]``: the LM decode service for xlstm-350m at full width
     (24 blocks, sLSTM at 7, 15 and 23, mLSTM elsewhere; d_model 1,024, 4
     heads, mLSTM inner width 2,048 so dh 512; vocabulary 50,304, untied),
     bf16, random weights from seed 0, nothing cut: batch 64, 128 prompt
     and 128 greedy steps. The service with the counters zeroed before
     and read after: no kernel launch and no plain call (a decode step is
     plain PyTorch on a state of fixed size, written in place); peak
     device memory and the state's bytes; a profile of 32 steps; the
     matrix memory's step (`xlstm._memory_step`) at B = 64 by CUDA graph
     beside one read and one write of ``C``. ``prefill`` at B = 8, T =
     1,024 (4 chunks of 256) launches ``ssm_scan`` once per mLSTM layer
     (21) over ``[8, 4, 4 x (512^2 + 512)]``, each call held against
     ``ssm_scan_plain`` on its own inputs at the float32 TOL, which a scan
     that loses one chunk's state misses in every call (the carry into a
     chunk dropped is reported beside it: the random model's forget
     gates underflow the carry to 0 within a chunk, so no model call can
     show it); the chunk carry where it matters (forget gates
     ``log_sigmoid(6 + z)``, full width): ``_mlstm_chunked`` on the
     kernel against the recurrent step, which the carry dropped misses;
     float32 ``prefill`` (kernel) of the first 320 tokens against the
     float32 model teacher-forced through ``decode_step`` to position 319
     (one chunk boundary crossed), and the bf16
     ``prefill`` on the kernel against plain, each relative to the
     largest logit; device time of ``ssm_scan`` at the prefill's shape
     beside its bound;
  20. ``[lm_encdec]``: the LM decode service for seamless-m4t-medium at
     full width (12 encoder and 12 decoder layers, d_model 1,024, 16 query
     and 16 kv heads, head_dim 64, d_ff 4,096, vocabulary 256,206 padded
     to 258,048, untied, an encoder memory of 1,024 frames), bf16, random
     weights from seed 0, nothing cut: batch 64, 128 prompt and 128 greedy
     steps, caches of 256. The service encodes a zero frontend once, as
     the reference does: that memory, and every cross-attention output
     against it, is exactly 0 (printed). With the counters zeroed before
     and read after it must launch exactly 12 ``wgmma`` kernels (the
     encode) and 12 x 256 x 2 split-K decode kernels (self- and
     cross-attention), nothing else, no plain call; tok/s, wall per step,
     peak memory. Then, on the same weights, the first 8 sequences and a
     random frontend (std 1): ``encode`` (the ``wgmma`` kernel
     non-causal) against the float32 model by the bf16 noise; every
     encoder kernel call against plain at the tight bf16 bound, which the
     same call made causal misses; ``prefill(enc_emb=)`` at T = 128 (36
     ``wgmma`` launches: encoder, self, cross), each call held to plain,
     each cross call's fault (the memory one key short) caught; 64
     teacher-forced ``decode_step(memory=)`` steps, every self-attention
     call (fault: ``length - 1``) and cross-attention call (fault: one key
     short) held to plain, the logits against float32 by the noise rule;
     the decode at position 127 against ``prefill``; a profile of 32
     steps at B = 64 with the memory K/V projection named; that
     projection by CUDA graph beside its bound; device times of the
     encoder's non-causal ``wgmma`` (B = 64, S = 1,024), the cross
     ``wgmma`` (B = 8, Tq = 128, Tk = 1,024), the cross split-K decode (B
     = 64, 1 row per kv head, Tk = 1,024) and the self decode at L = 256,
     each beside its bound and SDPA;
  21. ``[lm_mrope]``: qwen2-vl-72b at full width (d_model 8,192, 64 query
     and 8 kv heads, head_dim 128, QKV bias, M-RoPE sections (16, 24,
     24), vocabulary 152,064 padded to 153,600) and depth 4 of 80 (~12.1
     GB in bf16), random weights from seed 0: `generate` at batch 64, 64
     prompt and 64 greedy steps, caches of 128: exactly 4 x 128 decode
     launches (8 rows per kv head), nothing else; every decode-kernel call
     teacher-forced over the same positions against plain with the
     ``length - 1`` fault; a profile of 16 steps; ``prefill`` at B = 8, T
     = 128 (4 ``wgmma`` launches, each held to plain); layer 0's attention
     sublayer on vision positions of a 4 x 16 x 16 patch grid (the three
     rows differ, so the sections act) against plain at the tight bound,
     which the same input on text positions (rows equal) misses; device
     times of the decode kernel (8 rows, L = 128) and the prefill beside
     their bounds and SDPA;
  22. ``[train]``: training on one device, TF32 off. Every kernel
     wrapper first raises on a CUDA input that requires grad (and runs it
     under ``no_grad``). Then qwen2-1.5b at full width (1.59 B
     parameters, bf16, float32 AdamW moments, block remat), random
     weights from seed 0: its step-0 gradients on the pipeline's batch 0
     against the same weights in float32 — every parameter a finite
     nonzero gradient, each tensor's relative distance within
     `TRAIN_GRAD_FACTOR` x the largest such distance on batch 1, which
     the same gradients with attention's output detached miss in every
     attention tensor, and the two losses within `TRAIN_LOSS_BOUND`;
     ``train()`` for 10 steps (B 8, T 128, lr 3e-4, warmup 2) with the
     counters zeroed before and read after: no kernel launch, every loss
     finite, the last below the first, peak memory; the same step timed
     one step at a time (the median of 5: ms per step, tokens/s) and
     profiled over 3 (busy, idle, launches per step), and the AdamW
     update alone beside its byte bound. Each of the
     five families' reduced configs trains 3 float32 steps on the card
     and on the CPU from the same weights (seamless on a random
     frontend): losses and grad norms at the float32 TOL. A checkpoint
     resume on the card (reduced qwen2, float32: 6 steps checkpointed
     every 3, then a second ``train()`` to 10) equals the uninterrupted
     run within 1e-6; a bf16 train state round-trips bit for bit; the
     card's checkpoint restores onto the CPU. No training path launches
     a kernel;
  23. ``[mesh]``: the cross-device paths as four ranks sharing the card,
     a 1 x 4 ("data", "model") mesh over gloo (`repro_torch.launch.mesh`,
     `repro_torch.distributed`;
     the parent has built the kernels, the ranks load them), each rank's
     counters zeroed just before each sharded call and read just after.
     coordinated_turn in f64, one trajectory at n = 16,384 and 64 lanes
     at n = 2,048: the filtering and smoothing
     ``sharded_associative_scan`` of each rank's time shard through the
     combine kernels (``combine_impl="pallas"``) against the one-rank
     plain version (``"fused"``) at rtol 1e-8, atol 1e-9, with two planted
     faults (the exchange replaced by the identity, the fix-up's operands
     swapped) caught on every rank they reach, and exactly the local
     scan's launches plus one fix-up launch per rank;
     ``parallel_filter_smoother`` (and the batched filter and smoother)
     with ``axis_name`` against the one-rank plain drivers at PATH_TOL;
     ``linear_recurrence_scan(axis_name=)`` at Hymba-1.5B's SSM width ([4
     x 1,024, 51,200] f32; two ``ssm_scan`` launches per rank) against
     ``ssm_scan_plain`` on the whole input, the exchange-free fault
     caught. xlstm-350m at full width and depth, ``prefill`` at B = 8, T =
     1,024 under the mesh (every mLSTM layer sequence-parallel, one
     ``ssm_scan`` launch per layer per rank) against the one-rank float32
     prefill by the bf16 noise (the one-rank bf16 prefill's distance to
     it, `LM_NOISE_FACTOR`), the same in float32 against the one-rank
     float32 prefill at 2e-4 of the largest logit, and in it each layer's
     real q, k, v on the synthetic gates ``log_sigmoid(6 + z)``
     sequence-parallel against the one-rank chunked form on the plain
     chunk carry in float32 (2e-4), which the first layer with
     the state exchange planted away misses. deepseek-moe-16b at full width and depth 2 of
     28, each rank holding 16 of the 64 experts (`moe.shard_model`),
     ``prefill`` at B = 8, T = 256 (one ``wgmma`` launch per layer per
     rank): at a drop-free capacity factor (E/k) the logits and each
     layer's expert-parallel output against the one-rank global dispatch
     by the bf16 noise (float32 on the same routing, `LM_NOISE_FACTOR`);
     at the config's capacity each layer's output by the same rule and
     each rank's drops equal to the same per-slice routing run on one
     rank with all 64 experts. Prints the backend, each rank's device,
     the bytes staged through the host, and each sharded call's wall
     beside the one-rank call's (four ranks share one card: data only);
  24. ``[train_mesh]``: training across a 2 x 2 ("data", "model") mesh of
     four ranks sharing the card over gloo, TF32 off, each rank's counters
     zeroed before and read after every part (no kernel launch anywhere).
     (a) The main path: ``train()`` of qwen2-1.5b at full width on the
     mesh (B 8, T 128, 2 steps, bf16): the losses finite and equal on
     every rank, step 0 against ``[train]``'s one-device step-0 loss on
     the same batch within the bf16 noise ``[train]`` measures (its bf16
     vs float32 step-0 loss); each rank's resident parameter and moment
     blocks against the plan's count and the reference's
     ``per_chip_argument_bytes``, its peak memory, the bytes it staged
     through the host and the wall of each step. (b) The five families'
     reduced configs (tp 2, float32, the MoE at its drop-free capacity
     factor E / k): 2 steps on the mesh against 2 one-device steps on the
     card from the same weights and batches, every parameter and loss at
     the float32 TOL, and each step's grad norm; two planted faults must
     miss: the gradients left unsummed over "data", and every gradient
     multiplied by the "model" size (caught by the grad norm: the global
     clip hides a uniform factor from the parameters). (c) Elastic:
     reduced qwen2 checkpointed at step 2 on 2 x 2 and resumed on 1 x 4
     for step 3 equals the uninterrupted run at TOL, leaf for leaf. (d)
     ``compressed_psum`` over "data" of one step's gradients against
     ``psum`` within 2 % of each tensor's largest magnitude (the
     reference's bound), with the bytes each staged through the host.
     (e) The MoE's global dispatch on the mesh: reduced deepseek-moe-16b
     (tp 2) at its production capacity factor 1.25 and an odd T (the
     experts split over "model" but T does not), on tokens of few ids so
     that routing drops: 2 steps against 2 one-device steps (losses,
     aux, grad norms and every parameter at the float32 TOL), and the
     drops of one "model" line's data ranks summed against the one
     device's (nonzero). (a) trains tensor-parallel: each rank's compute
     model is its "model" block (its bytes against the plan's count and
     the whole model's). (f) The slice's serve path at full width:
     qwen2-1.5b's ``make_prefill_step`` and ``make_decode_step`` on the
     mesh, tensor-parallel (global batch 16, a prompt of 64 prefilled and
     teacher-forced, 16 greedy steps, caches of 128 split along their
     sequence over "model"): exactly 28 ``wgmma`` launches per rank per
     prefill and 28 split-K decode launches per rank per decode step,
     every rank of a "model" line returning the same logits, the logits
     of the ranks at "model" 0 (gathered over the vocabulary) against the
     one-device steps on the same weights and tokens by ``[lm_decode]``'s
     rules (the one-device bf16 path's distance to float32 as the noise;
     the mesh's greedy tokens against the one-device argmax, a mismatch
     only at a near tie), each kernel call of 8 steps past the prompt
     against its plain version on the rank's cache block (and its
     log-sum-exps), the same steps with rank 1 reading kv head 0 for one
     of its q heads (planted) missing that bound, and the bytes each rank
     stages per decode step beside the replicated layout's gathers. (g)
     and (h) the same for the hybrid and the encoder-decoder family at
     full width and depth, tensor-parallel (global batch 16, a prompt of
     64, 16 greedy steps). (g) hymba-1.5b, caches of 1,088 (each
     windowed layer's ring of 1,024 whole on every rank, the three
     global layers' caches split along the sequence): exactly 32
     ``wgmma`` and 32 ``ssm_scan`` launches per rank per prefill (one
     chunk of 64 on the rank's ``d_inner`` channels, each scan against
     plain at the float32 TOL) and 32 split-K launches per decode step,
     each kernel call of 8 steps past the prompt against plain on the
     rank's cache block or whole ring; the logits by ``[lm_decode]``'s
     rules; a float32 copy of the compute model's prefill on the mesh
     against the one-device float32 prefill within 2^-10 of the largest
     logit, which rank 1 on its contiguous resting block of every
     ``in_proj`` (planted, in place of its block of each half) must miss.
     (h) seamless-m4t-medium on a random frontend of 1,024 rows, caches
     of 128 (split by kv heads): exactly 36 ``wgmma`` launches per rank
     per prefill (12 encoder, 12 self, 12 cross; sequence-parallel), 12
     for the memory's encode on the mesh, 24 split-K per decode step
     (self and cross), the taps on 8 steps past the prompt, the logits
     by the same rules, and rank 1's cross-attention reading kv heads off
     by one (planted) caught by its tap;
  25. ``[dryrun]``: the dry-run's layer on the card (`launch.steps`,
     `launch.cost`, `launch.roofline`). (a) The one-device train plan's
     ``per_chip_argument_bytes`` for ``[train]``'s qwen2-1.5b state (B 8,
     T 128) against the bytes that state and batch hold on the card and
     against the growth of the caching allocator's requested bytes as
     they are built, both exactly (``torch.cuda.memory_allocated()``'s
     growth, larger by the allocator's rounding, printed beside). (b)
     The step count of ``[train]``'s step and of ``[lm_decode]``'s
     qwen2-1.5b decode step (B 64, caches of 512) on the card, kernels
     running, against the same steps traced on ``meta`` tensors (plain
     versions): FLOPs, bytes and kernel calls equal. (c) Each step's
     compute and memory terms at the card's peaks, the dominant one, and
     its roofline share (the least time over the wall ``[train]`` and
     ``[lm_decode]`` measured) and model-FLOPs share, with the card's
     name and power limit;
  26. the ``kernels`` JSON line (each combine kernel's launches per path,
     ``surface``, ``train``, ``mesh`` and ``train_mesh`` among them, and
     its B = 1 top-level time; ``ssm_scan``'s: ``ssm_scan``,
     ``lm_hybrid_prefill``, ``lm_xlstm_prefill``, ``train``, ``mesh``,
     ``train_mesh``; the flash kernels': ``flash``, ``lm_decode``,
     ``lm_prefill``, ``lm_hybrid``, ``lm_hybrid_prefill``, ``lm_moe``,
     ``lm_moe_prefill``, ``lm_grok``, ``lm_grok_prefill``, ``lm_encdec``,
     ``lm_encdec_prefill``, ``lm_mrope``, ``lm_mrope_prefill``, ``train``,
     ``mesh``, ``train_mesh``, ``train_mesh_serve``, ``tp_serve_hybrid``,
     ``tp_serve_encdec``, ``dryrun``; ``ssm_scan``'s ``tp_serve_hybrid``
     too; the ``mesh``, ``train_mesh``, ``train_mesh_serve`` and
     ``tp_serve_*`` counts summed over the ranks), then the device JSON
     line, last.

Details (every ptxas line, all timings) go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

#: Per-dtype parity tolerance: the kernel suite's TOL (same arithmetic,
#: different rounding order and FMA contraction).
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "float64": dict(rtol=1e-9, atol=1e-10)}
#: Whole iterated path, kernels vs plain versions: rounding differences
#: compound over up to 10 Gauss-Newton passes.
PATH_TOL = dict(rtol=1e-7, atol=1e-8)
#: Parallel vs sequential smoother at one linearization (the JAX suite's
#: f64 tolerance for that comparison).
SEQ_TOL = dict(rtol=1e-6, atol=1e-8)

#: The card's peaks (NVIDIA's H100 SXM data sheet) are named once, in
#: `repro_torch.launch.roofline`; each call's work in `repro_torch.kernels
#: .work`. Both are imported where used: the package is on the path only
#: once `main` has found it.
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}

MAIN_ROWS, MAIN_T, MAIN_NX = 64, 512, 5
MAIN_PAIRS = MAIN_ROWS * MAIN_T // 2
EDGE_SHAPES = [(1, 1), (513, 8), (7, 16), (0, 5)]
#: Scan levels read in place: (what, L, T, nx). Each runs the level's first
#: call (``x[:, 0:-1:2]`` with ``x[:, 1::2]``) and its second (the first's
#: result ``odd``, trimmed to ``odd[:, :-1]`` for even T, with
#: ``x[:, 2::2]``). At T = 513 every other row starts off a 16-byte
#: boundary (513 blocks of 200 B at f64, nx = 5), so the slices' bases are
#: only 8-byte aligned (4-byte at f32).
STRIDED_LEVELS = [("top level", 64, 512, 5), ("odd T", 64, 513, 5),
                  ("nx=1", 8, 33, 1), ("nx=8", 8, 33, 8),
                  ("nx=16", 4, 33, 16)]
#: Pairs per row of the level sizes the service's scans launch at n=512.
SWEEP_P = (256, 128, 64, 32, 16, 8, 4, 2, 1)
#: name -> (TPU kernel it replaces, CUDA source of the port).
KERNELS = {
    "filtering_combine": (
        "src/repro/kernels/kalman_combine/kalman_combine.py:118",
        "src/repro_torch/csrc/kalman_combine.cu"),
    "smoothing_combine": (
        "src/repro/kernels/kalman_combine/kalman_combine.py:142",
        "src/repro_torch/csrc/kalman_combine.cu"),
    "ssm_scan": ("src/repro/kernels/ssm_scan/ssm_scan.py:62",
                 "src/repro_torch/csrc/ssm_scan.cu"),
    "flash_attention": (
        "src/repro/kernels/flash_attention/flash_attention.py:77",
        "src/repro_torch/csrc/flash_attention.cu"),
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Work and bound of one combine launch
# ---------------------------------------------------------------------------

def bound(kind: str, B: int, nx: int, dtype: str):
    """Least time for one launch: the larger of bytes (2 elements read +
    1 written per pair) over HBM bandwidth and flops over peak
    (`kernels.work.combine_work`)."""
    from repro_torch.kernels.work import combine_work

    flops, n_bytes = combine_work(kind, B, nx, ITEMSIZE[dtype])
    return _bound(n_bytes, flops, dtype)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    say(f"[env] device {name}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    say(f"[env] nvidia-smi: {card}")
    return {"device": name, "nvidia_smi": card,
            "count": torch.cuda.device_count()}


def _ptxas_summary(lines):
    """``{kernel symbol: {registers, stack, spill_stores, spill_loads}}``
    from ``-Xptxas -v`` output."""
    import re

    out, cur = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


#: ptxas lines printed: the main path's instances of each kernel.
_PTXAS_SHOWN = {"kalman_combine": r"_combine_kernelI[df]Li5E",
                "ssm_scan": r"_ZN2ss",
                "flash_attention": r"flash_attention_kernel|wgmma_kernel|"
                                   r"decode_kernelI\w+Li128ELi3E|"
                                   r"merge_kernelI\w+Li128E"}


def _sass_counts(lib_path, opcode: str) -> dict:
    """``{kernel symbol: lines of SASS holding opcode}`` of a built library
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``)."""
    from repro_torch.kernels.build import nvcc_path

    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    counts = {}
    for section in out.stdout.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        counts[name] = section.count(opcode)
    return counts


def phase_build() -> dict:
    import re

    from repro_torch.kernels.build import build_many
    from repro_torch.kernels.flash_attention.flash_attention import \
        BUILD_PARTS as FA_PARTS
    from repro_torch.kernels.kalman_combine.kalman_combine import \
        BUILD_PARTS as KC_PARTS

    specs = [("kalman_combine", KC_PARTS), ("ssm_scan", ((),)),
             ("flash_attention", FA_PARTS)]
    nparts = sum(len(p) for _, p in specs)
    say(f"[build] compiling {len(specs)} sources as {nparts} nvcc parts "
        "at once ...")
    t0 = time.perf_counter()
    built = build_many(specs)
    wall = time.perf_counter() - t0
    report = {"build_load_s": wall}
    for name, parts in specs:
        lib = built[name]
        say(f"[build] {lib.path.name}: nvcc {lib.seconds:.1f}s for "
            f"{len(parts)} parts, {len(lib.ptxas)} ptxas lines")
        summary = _ptxas_summary(lib.ptxas)
        shown = {k: v for k, v in summary.items()
                 if re.search(_PTXAS_SHOWN[name], k)}
        for sym, info in sorted(shown.items()):
            say(f"[build] ptxas {sym}: {info}")
        report[name] = {"nvcc_s": lib.seconds, "ptxas_lines": lib.ptxas,
                        "ptxas": shown}
    combine = report["kalman_combine"]["ptxas"]
    spilled = {k: v for k, v in combine.items()
               if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    if len(combine) != 4 or spilled:
        fail(f"the four nx=5 combine instances must build without spills: "
             f"found {len(combine)}, spilling {spilled}")
    hgmma = {k: n for k, n in _sass_counts(
        built["flash_attention"].path, "HGMMA").items() if n}
    wgmma = {k: n for k, n in hgmma.items() if "wgmma_kernel" in k}
    say(f"[build] SASS lines with HGMMA (cuobjdump -sass): {hgmma}")
    if len(wgmma) != 4 or set(hgmma) != set(wgmma):
        fail(f"HGMMA expected in the four wgmma_kernel instances only (Dh 64 "
             f"and 128, with and without the softcap): {hgmma}")
    report["flash_attention"]["sass_hgmma"] = hgmma
    say(f"[build] all sources built and loaded in {wall:.1f}s")
    return report


def _elements(torch, kind, B, nx, dtype, gen):
    from repro_torch.core.types import FilteringElement, SmoothingElement

    kw = dict(dtype=dtype, device="cuda", generator=gen)

    def psd():
        a = torch.randn((B, nx, nx), **kw)
        return a @ a.mT / nx + 0.1 * torch.eye(nx, dtype=dtype, device="cuda")

    def mat():
        return torch.randn((B, nx, nx), **kw) / nx ** 0.5

    if kind == "filtering_combine":
        return FilteringElement(mat(), torch.randn((B, nx), **kw), psd(),
                                torch.randn((B, nx), **kw), psd())
    return SmoothingElement(mat(), torch.randn((B, nx), **kw), psd())


def _time_ms(torch, fn, sets, iters=200, warmup=10):
    """Mean ms per call over ``iters`` calls, rotating through input
    ``sets`` (together larger than the 50 MB L2, so each call finds its
    inputs in HBM as the first scan levels do)."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, sets, iters=100, replays=3):
    """Device ms per call: ``iters`` calls, rotating through input
    ``sets``, captured in one CUDA graph and replayed, so that the host's
    dispatch (the wrapper's Python takes longer than a small launch) is
    out of the time."""
    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (iters * replays)


def _level_set(torch, kind, L, T, nx, dtype, gen):
    """An ``[L, T]`` element set: the elements of one scan level."""
    e = _elements(torch, kind, L * T, nx, dtype, gen)
    return type(e)(*(t.reshape((L, T) + t.shape[1:]) for t in e))


def _sl(x, start, stop, step=None):
    """Every field of ``x`` sliced along the pair axis (a view)."""
    return type(x)(*(t[:, start:stop:step] for t in x))


def scan_level_pairs(n: int) -> list:
    """Pairs per row of each combine call of one scan over ``n`` elements,
    in order (the recursion of ``core/scan.py::_scan``)."""
    if n < 2:
        return []
    return ([n // 2] + scan_level_pairs(n // 2)
            + [n // 2 - 1 if n % 2 == 0 else n // 2])


def phase_kernels(torch) -> dict:
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    wrappers = {"filtering_combine": (kc.filtering_combine_cuda,
                                      kc.filtering_combine_plain),
                "smoothing_combine": (kc.smoothing_combine_cuda,
                                      kc.smoothing_combine_plain)}
    dtypes = {"float64": torch.float64, "float32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for kind, (kernel, plain) in wrappers.items():
        checks = []

        def check(ei, ej, what, dname):
            """One launch (none for no pairs) against the plain version."""
            before = kc.LAUNCHES[kind]
            got = kernel(ei, ej)
            torch.cuda.synchronize()
            pairs, nx = got[1].shape[:-1].numel(), got[1].shape[-1]
            launched = kc.LAUNCHES[kind] - before
            if launched != (1 if pairs else 0):
                fail(f"{kind} {what}: {launched} launches, expected "
                     f"{1 if pairs else 0}")
            want = plain(ei, ej)
            err = 0.0
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"{kind} {dname} {what}: output {tuple(g.shape)}/"
                         f"{g.dtype}, expected {tuple(w.shape)}/{w.dtype}")
                if pairs and not torch.allclose(g, w, **TOL[dname]):
                    fail(f"{kind} {dname} {what} disagrees with its plain "
                         f"version: max abs err "
                         f"{(g - w).abs().max().item():.3e}")
                if pairs:
                    err = max(err, (g - w).abs().max().item())
            checks.append({"what": what, "dtype": dname, "pairs": pairs,
                           "nx": nx, "max_abs_err": err})
            say(f"[parity] {kind} {dname} {what}: ok, max abs err {err:.3e}")
            return got

        for dname, dtype in dtypes.items():
            for B, nx in [(MAIN_PAIRS, MAIN_NX)] + EDGE_SHAPES:
                check(_elements(torch, kind, B, nx, dtype, gen),
                      _elements(torch, kind, B, nx, dtype, gen),
                      f"packed B={B} nx={nx}", dname)
            for what, L, T, nx in STRIDED_LEVELS:
                x = _level_set(torch, kind, L, T, nx, dtype, gen)
                odd = check(_sl(x, 0, -1, 2), _sl(x, 1, None, 2),
                            f"{what} [{L}, {T}] nx={nx}: x[:, 0:-1:2], "
                            "x[:, 1::2]", dname)
                check(odd if T % 2 else _sl(odd, 0, -1), _sl(x, 2, None, 2),
                      f"{what} [{L}, {T}] nx={nx}: "
                      f"{'odd' if T % 2 else 'odd[:, :-1]'}, x[:, 2::2]",
                      dname)
                del x, odd
        timing = {}
        for dname, dtype in dtypes.items():
            packed = [(_elements(torch, kind, MAIN_PAIRS, MAIN_NX, dtype, gen),
                       _elements(torch, kind, MAIN_PAIRS, MAIN_NX, dtype, gen))
                      for _ in range(3)]
            in_place = [(_sl(x, 0, -1, 2), _sl(x, 1, None, 2)) for x in (
                _level_set(torch, kind, MAIN_ROWS, MAIN_T, MAIN_NX, dtype,
                           gen) for _ in range(3))]
            before = kc.LAUNCHES[kind]
            t = {"ms": _time_ms(torch, kernel, packed),
                 "graph_ms": _graph_ms(torch, kernel, packed),
                 "in_place_ms": _time_ms(torch, kernel, in_place),
                 "in_place_graph_ms": _graph_ms(torch, kernel, in_place),
                 "plain_ms": _time_ms(torch, plain, packed, iters=50)}
            if kc.LAUNCHES[kind] == before:
                fail(f"{kind}: timing loop launched no kernel")
            t["bound_ms"], t["bound_by"] = bound(kind, MAIN_PAIRS, MAIN_NX,
                                                 dname)
            timing[dname] = t
            us = {k: v * 1e3 for k, v in t.items() if k.endswith("ms")}
            say(f"[time] {kind} {dname} B={MAIN_PAIRS} nx={MAIN_NX}: kernel "
                f"packed {us['ms']:.2f} us (graph {us['graph_ms']:.2f}), in "
                f"place {us['in_place_ms']:.2f} us (graph "
                f"{us['in_place_graph_ms']:.2f}), plain {us['plain_ms']:.2f} "
                f"us, bound {us['bound_ms']:.2f} us ({t['bound_by']}), in "
                f"place (graph)/bound "
                f"{t['in_place_graph_ms'] / t['bound_ms']:.2f}")
            del packed, in_place
            torch.cuda.empty_cache()
        sweep = []
        for P in SWEEP_P:
            sets = [(_sl(x, 0, -1, 2), _sl(x, 1, None, 2)) for x in (
                _level_set(torch, kind, MAIN_ROWS, 2 * P, MAIN_NX,
                           torch.float64, gen) for _ in range(3))]
            g_ms = _graph_ms(torch, kernel, sets)
            b_ms, _ = bound(kind, MAIN_ROWS * P, MAIN_NX, "float64")
            sweep.append({"rows": MAIN_ROWS, "pairs_per_row": P,
                          "graph_ms": g_ms, "bound_ms": b_ms})
            say(f"[time] {kind} float64 level {MAIN_ROWS} x {P} pairs in "
                f"place: {g_ms * 1e3:.2f} us per launch (graph), bound "
                f"{b_ms * 1e3:.3f} us")
        report[kind] = {"checks": checks, "timing": timing, "sweep": sweep}
    return report


def phase_pack(torch) -> dict:
    """What packing one scan level's strided ``x[:, 0:-1:2]`` /
    ``x[:, 1::2]`` slices into a contiguous ``[B*P]`` batch cost (the top
    filtering level of a width-64, n=512 bucket, f64): the copies the scan
    made before the kernels read levels in place, and no longer makes."""
    from repro_torch.core.types import FilteringElement

    B, n, nx = MAIN_ROWS, MAIN_T, MAIN_NX
    kw = dict(dtype=torch.float64, device="cuda")
    elems = FilteringElement(torch.randn(B, n, nx, nx, **kw),
                             torch.randn(B, n, nx, **kw),
                             torch.randn(B, n, nx, nx, **kw),
                             torch.randn(B, n, nx, **kw),
                             torch.randn(B, n, nx, nx, **kw))

    def pack(e):
        for sl in (slice(0, -1, 2), slice(1, None, 2)):
            for x in e:
                x[:, sl].reshape((-1,) + x.shape[2:]).contiguous()

    ms = _time_ms(torch, pack, [(elems,)], iters=50)
    say(f"[pack] strided level slices -> contiguous (no longer on the "
        f"path), filtering top level B=64 n=512 f64: {ms * 1e3:.2f} us per "
        "level")
    return {"filtering_top_level_ms": ms}


def _counted_modules():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.kernels.ssm_scan import ssm_scan as ss

    return kc, ss, fa


def reset_counts() -> None:
    """Zero every kernel's launch counter (just before a path runs)."""
    for mod in _counted_modules():
        mod.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launches since `reset_counts`."""
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def sc_model(torch):
    from repro_torch.scenarios import get_scenario

    return get_scenario("coordinated_turn").make_model(torch.float64, "cuda")


def sc_spec(cfg, **fields):
    """The coordinated-turn spec of a service config: its linearization
    (``cfg.method``) and iteration knobs, with ``fields`` on top."""
    from repro_torch.scenarios import get_scenario

    return get_scenario("coordinated_turn").default_spec(
        linearization="taylor" if cfg.method == "ekf" else "slr",
        n_iter=cfg.n_iter, tol=cfg.tol, lm_lambda=cfg.lm_lambda, **fields)


def _rmse(torch, mean, truth) -> float:
    return float(torch.sqrt(torch.mean((mean[1:, :2] - truth[1:, :2]) ** 2)))


def phase_main_path(torch, method: str = "ekf", tag: str = "main") -> tuple:
    """The smoother service at 64 x n<=512, f64, on the card, linearized
    by ``method`` ("ekf": IEKS, the first slice's main path; "slr": IPLS
    with cubature points), its lines tagged ``[tag]``. Returns the report
    and the service's stats (the [stream] phase holds its results against
    the [main] run's)."""
    import dataclasses

    from repro_torch.core import scan as scan_lib
    from repro_torch.core.api import build_smoother
    from repro_torch.core.iterated import (LANE_DIVERGED, _augment_lm,
                                           _linearize, _scheme_for)
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch.serve import (SmootherServeConfig, SmootherServer,
                                          make_fleet, pad_requests,
                                          serve_smoother)

    cfg = SmootherServeConfig(requests=64, n=512, max_batch=64, f64=True,
                              method=method)
    torch.cuda.synchronize()
    copies = scan_lib.PACK_COPIES
    reset_counts()
    t0 = time.perf_counter()
    stats = serve_smoother(cfg, emit=say, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts.pop(k) for k in kc.LAUNCHES}
    total_s = time.perf_counter() - t0
    copies = scan_lib.PACK_COPIES - copies
    say(f"[{tag}] serve_smoother: {total_s:.2f}s end to end incl. fleet "
        f"simulation; serve {stats['wall_s']:.3f}s, "
        f"{stats['traj_per_s']:.1f} traj/s, {stats['launches']} bucket "
        f"launches, {stats['mean_iterations']:.2f} mean iters; kernel "
        f"launches {launches}; scan packing copies {copies}")
    if copies:
        fail(f"the service's scans made {copies} packing copies, expected 0")
    for kind, count in launches.items():
        if count == 0:
            fail(f"the main path launched no {kind} kernel")
    if any(counts.values()):
        fail(f"the smoother path launched other kernels: {counts}")
    if launches["filtering_combine"] != launches["smoothing_combine"]:
        fail(f"filtering/smoothing launch counts differ: {launches}")
    diverged = sum(c == LANE_DIVERGED for c in stats["codes"])
    if diverged:
        fail(f"{diverged} lanes diverged")
    for m in stats["results"]:
        if not bool(torch.isfinite(m).all()):
            fail("non-finite smoothed mean")
    # The served fleet again (same seed, same generator stream).
    model = sc_model(torch)
    requests, truths = make_fleet(cfg, model)
    # Tracking quality. The mean is pulled up by the few tracks that ten
    # damped Gauss-Newton passes from the prior do not capture (the JAX
    # service prints a mean of 0.2025 on its own 64 x 512 fleet), so the
    # gate is on the median request; the mean is reported.
    rmses = sorted(_rmse(torch, m, t)
                   for m, t in zip(stats["results"], truths))
    median = rmses[len(rmses) // 2]
    tracked = sum(r < 0.1 for r in rmses)
    say(f"[{tag}] position RMSE: median {median:.4f}, mean "
        f"{stats['mean_rmse']:.4f}, {tracked}/{len(rmses)} requests < 0.1")
    if not median < 0.1:
        fail(f"median position RMSE {median} >= 0.1")

    # The same fleet through the plain versions, on the card.
    spec = sc_spec(cfg)
    before = dict(kc.LAUNCHES)
    plain = SmootherServer(model, cfg, spec=dataclasses.replace(
        spec, backend="jnp"), device="cuda").serve_requests(
            requests, emit=lambda *_: None)
    if kc.LAUNCHES != before:
        fail('backend="jnp" launched a kernel')
    worst = 0.0
    for i, (a, b) in enumerate(zip(stats["results"], plain["results"])):
        if not torch.allclose(a, b, **PATH_TOL):
            fail(f"request {i}: kernel path and plain path disagree, max "
                 f"abs diff {(a - b).abs().max().item():.3e}")
        worst = max(worst, (a - b).abs().max().item())
    ll_diff = max(abs(a - b) for a, b in zip(stats["logliks"],
                                             plain["logliks"]))
    say(f"[{tag}] kernel path vs plain path (backend=jnp, "
        f"{plain['wall_s']:.3f}s): max |dmean| {worst:.3e}, max |dloglik| "
        f"{ll_diff:.3e}")
    # The first serve above pays one-time costs (CUDA module loading,
    # library handles); the same fleet again shows the steady state.
    warm = SmootherServer(model, cfg, spec=spec, device="cuda"
                          ).serve_requests(requests, emit=lambda *_: None)
    say(f"[{tag}] warm repeat through the kernels: {warm['wall_s']:.3f}s, "
        f"{warm['traj_per_s']:.1f} traj/s (plain versions: "
        f"{plain['traj_per_s']:.1f} traj/s)")

    # One bucket against the sequential smoother at the same linearization.
    idx = [i for i, y in enumerate(requests) if len(y) > cfg.n // 2][:16]
    ys, rs = pad_requests([requests[i] for i in idx], cfg.n, 16, model.R)
    model_b = dataclasses.replace(model, R=rs)
    par = build_smoother(spec, device="cuda")
    traj = par.iterate(model_b, ys)
    lin = _linearize(model_b, traj, par.config,
                     _scheme_for(model_b, par.config))
    lin, pseudo = _augment_lm(lin, traj.mean[:, 1:], cfg.lm_lambda)
    ys_eff = torch.cat([ys, pseudo], dim=-1)
    _, s_par = par.smooth(lin, ys_eff, model.m0, model.P0)
    _, s_seq = build_smoother(spec, mode="sequential", device="cuda").smooth(
        lin, ys_eff, model.m0, model.P0)
    for name, a, b in (("mean", s_par.mean, s_seq.mean),
                       ("cov", s_par.cov, s_seq.cov)):
        if not torch.allclose(a, b, **SEQ_TOL):
            fail(f"parallel vs sequential smoothed {name} disagree: max abs "
                 f"diff {(a - b).abs().max().item():.3e}")
    seq_diff = (s_par.mean - s_seq.mean).abs().max().item()
    say(f"[{tag}] parallel (kernels) vs sequential at one linearization, "
        f"{len(idx)} lanes x n={cfg.n}: max |dmean| {seq_diff:.3e}")
    return {"launches": launches, "wall_s": stats["wall_s"],
            "total_s": total_s, "traj_per_s": stats["traj_per_s"],
            "bucket_launches": stats["launches"],
            "mean_iterations": stats["mean_iterations"],
            "mean_rmse": stats["mean_rmse"], "median_rmse": median,
            "tracked_below_0.1": tracked, "plain_wall_s": plain["wall_s"],
            "warm_wall_s": warm["wall_s"],
            "warm_traj_per_s": warm["traj_per_s"],
            "pack_copies": copies, "kernel_vs_plain_max_abs": worst,
            "parallel_vs_sequential_max_abs": seq_diff}, stats


def _device_events(key_averages) -> list:
    """The profiler's device-side entries (kernels and copies on the
    card), each with its self device time."""
    return [e for e in key_averages
            if getattr(e, "self_device_time_total", 0) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]


def phase_profile(torch, method: str = "ekf", tag: str = "profile"
                  ) -> dict:
    """Where one bucket launch's time goes: ``torch.profiler`` over one
    width-64, n=512 ``smooth_batch`` (10 passes, linearized by
    ``method``). Device busy time is the sum of kernel self times; the
    rest of the wall time the card is idle, waiting on the host. Tables
    go to ``chiprun_out/``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import (SmootherServeConfig, SmootherServer,
                                          make_fleet)

    cfg = SmootherServeConfig(requests=64, n=512, max_batch=64,
                              vary_lengths=False, method=method)
    model = sc_model(torch)
    requests, _ = make_fleet(cfg, model)
    server = SmootherServer(model, cfg, device="cuda", spec=sc_spec(cfg))
    server.smooth_batch(requests, 512, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.smooth_batch(requests, 512, 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.smooth_batch(requests, 512, 64)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kernels = _device_events(ka)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    ops = sum(e.count for e in ka if e.key.startswith("aten::"))
    OUT.mkdir(exist_ok=True)
    (OUT / ("profile_bucket.txt" if method == "ekf"
            else f"profile_bucket_{method}.txt")).write_text(
        ka.table(sort_by="self_device_time_total", row_limit=40) + "\n"
        + ka.table(sort_by="cpu_time_total", row_limit=40))
    ours, bounds = {}, {}
    levels = [P for P in scan_level_pairs(512) if P]
    for kind in ("filtering_combine", "smoothing_combine"):
        evs = [e for e in kernels if f"{kind}_kernel" in e.key]
        ours[kind] = sum(e.self_device_time_total for e in evs) / 1e3
        scans = sum(e.count for e in evs) / len(levels)
        bounds[kind] = scans * sum(bound(kind, 64 * P, MAIN_NX, "float64")[0]
                                   for P in levels)
    # PyTorch's strided copy: the instance of elementwise_kernel<128, 2>
    # that direct_copy_kernel_cuda launches.
    copies = sum(e.count for e in kernels
                 if "elementwise_kernel<128, 2" in e.key
                 and "direct_copy_kernel" in e.key)
    say(f"[{tag}] one 64 x 512 bucket launch: wall {wall * 1e3:.1f} ms "
        f"(unprofiled), device busy {busy_us / 1e3:.1f} ms in {launches} "
        f"kernel launches ({copies} strided copies: elementwise_kernel<128, "
        f"2> of direct_copy_kernel_cuda), {ops} aten ops; combine kernels "
        f"{ours['filtering_combine']:.3f} + {ours['smoothing_combine']:.3f} "
        f"ms against summed bounds {bounds['filtering_combine']:.3f} + "
        f"{bounds['smoothing_combine']:.3f} ms; device idle "
        f"{1 - busy_us / 1e6 / wall:.1%} of the unprofiled wall")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    say(f"[{tag}] top device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in top))
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "kernel_launches": launches, "aten_ops": ops,
            "strided_copy_launches": copies,
            "combine_kernels_ms": ours, "combine_bounds_ms": bounds}


def phase_matrix(torch) -> dict:
    """``[matrix]``: the port's scenario matrix (every scenario x {taylor,
    slr} x {standard, sqrt}, n = 24, 3 passes, f64) on the card, every
    cell gated ok; each standard-form cell's combine-kernel launches
    counted (read at the cell's report), each cell held against the same
    cell with the plain combines (``backend="jnp"``)."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.scenarios.smoke import run_matrix

    marks = []

    def mark(line):
        marks.append(dict(kc.LAUNCHES))
        say(line.replace("[smoke]", "[matrix]", 1))

    t0 = time.perf_counter()
    reset_counts()
    rows = run_matrix(device="cuda", emit=mark)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    others = {k: v for k, v in read_counts().items() if k not in kc.LAUNCHES}
    if any(others.values()):
        fail(f"the matrix launched other kernels: {others}")
    t0 = time.perf_counter()
    before = dict(kc.LAUNCHES)
    plain = run_matrix(device="cuda", backend="jnp", emit=lambda *_: None)
    plain_wall = time.perf_counter() - t0
    if kc.LAUNCHES != before:
        fail('the matrix with backend="jnp" launched a kernel')
    prev = {k: 0 for k in kc.LAUNCHES}
    cells, worst = [], 0.0
    for row, twin, now in zip(rows, plain, marks):
        what = f"{row['scenario']} {row['method']} {row['form']}"
        launched = {k: now[k] - prev[k] for k in now}
        prev = now
        if not row["ok"]:
            fail(f"matrix cell {what} failed its gates: {row}")
        if row["form"] == "standard":
            if (min(launched.values()) == 0
                    or len(set(launched.values())) != 1):
                fail(f"matrix cell {what}: combine launches {launched}")
        elif any(launched.values()):
            fail(f"matrix cell {what} (square-root form) launched "
                 f"{launched}")
        if not torch.allclose(row["mean"], twin["mean"], **PATH_TOL):
            fail(f"matrix cell {what}: kernels vs plain max abs diff "
                 f"{(row['mean'] - twin['mean']).abs().max().item():.3e}")
        diff = (row["mean"] - twin["mean"]).abs().max().item()
        worst = max(worst, diff)
        cells.append({k: v for k, v in row.items() if k != "mean"}
                     | {"launches": launched, "vs_plain_max_abs": diff})
    total = {k: sum(c["launches"][k] for c in cells) for k in kc.LAUNCHES}
    say(f"[matrix] {sum(c['ok'] for c in cells)}/{len(cells)} cells ok in "
        f"{wall:.2f}s (plain combines {plain_wall:.2f}s); combine launches "
        f"{total}; kernels vs plain max |dmean| {worst:.3e}")
    return {"cells": cells, "launches": total, "wall_s": wall,
            "plain_wall_s": plain_wall, "vs_plain_max_abs": worst}


def _bucket(torch, method: str = "ekf"):
    """One full 64 x 512 coordinated-turn bucket (f64): the model with
    its per-lane R stack, the padded measurements and the service
    config (fleet seed 0, every request n = 512)."""
    import dataclasses

    from repro_torch.launch.serve import (SmootherServeConfig, make_fleet,
                                          pad_requests)

    cfg = SmootherServeConfig(requests=64, n=512, max_batch=64,
                              vary_lengths=False, method=method)
    model = sc_model(torch)
    requests, _ = make_fleet(cfg, model)
    ys, rs = pad_requests(requests, 512, 64, model.R)
    return dataclasses.replace(model, R=rs), ys, cfg


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sqrt(torch) -> dict:
    """``[sqrt]``: one 64 x 512 coordinated-turn bucket with
    ``form="sqrt"`` (f64, Taylor, the service's knobs) on the card, timed
    beside the standard form; at one linearization its smoothed means
    must lie within ``SQRT_PARITY_TOL`` of the standard-form kernel
    path's."""
    from repro_torch.core.api import build_smoother
    from repro_torch.core.iterated import _augment_lm, _linearize
    from repro_torch.scenarios.smoke import SQRT_PARITY_TOL

    model, ys, cfg = _bucket(torch)
    spec = sc_spec(cfg)
    std = build_smoother(spec, device="cuda")
    sq = build_smoother(spec, form="sqrt", device="cuda")
    std.iterate(model, ys)                                # warm
    reset_counts()
    (traj_sq, info_sq), sq_s = _timed(
        torch, lambda: sq.iterate(model, ys, return_info=True))
    counts = read_counts()
    if any(counts.values()):
        fail(f"the square-root path launched kernels: {counts}")
    traj_std, std_s = _timed(torch, lambda: std.iterate(model, ys))
    if not bool(torch.isfinite(traj_sq.mean).all()):
        fail("non-finite square-root means")
    _, sq2_s = _timed(torch, lambda: sq.iterate(model, ys))
    iter_diff = (traj_sq.mean - traj_std.mean).abs().max().item()
    # One linearization (at the standard path's result), both forms.
    lin = _linearize(model, traj_std, std.config, None)
    lin, pseudo = _augment_lm(lin, traj_std.mean[:, 1:], cfg.lm_lambda)
    ys_eff = torch.cat([ys, pseudo], dim=-1)
    _, s_std = std.smooth(lin, ys_eff, model.m0, model.P0)
    _, s_sq = sq.smooth(lin, ys_eff, model.m0, model.P0)
    one_diff = (s_sq.mean - s_std.mean).abs().max().item()
    cov_diff = (s_sq.cov - s_std.cov).abs().max().item()
    if not one_diff < SQRT_PARITY_TOL:
        fail(f"square-root vs standard means at one linearization: max abs "
             f"diff {one_diff:.3e} >= {SQRT_PARITY_TOL}")
    say(f"[sqrt] 64 x 512 bucket, f64, {cfg.n_iter} passes: square-root "
        f"form {sq_s:.3f}s (again {sq2_s:.3f}s), standard form (kernels) "
        f"{std_s:.3f}s; kernel launches {counts}; at one linearization "
        f"max |dmean| {one_diff:.3e}, max |dcov| {cov_diff:.3e}; iterated "
        f"max |dmean| {iter_diff:.3e}")
    return {"sqrt_s": sq_s, "sqrt_again_s": sq2_s, "standard_s": std_s,
            "one_linearization_max_abs_mean": one_diff,
            "one_linearization_max_abs_cov": cov_diff,
            "iterated_max_abs_mean": iter_diff,
            "codes": info_sq.code.tolist()}


#: Relative band within which two GN costs are one value up to rounding.
COST_RTOL = 1e-9


def phase_adaptive(torch) -> dict:
    """``[adaptive]``: one 64 x 512 coordinated-turn bucket with
    ``damping="adaptive"`` (Taylor and SLR, f64) on the card, held lane by
    lane against the plain run (``backend="jnp"``); no NaN may come back.

    A lane's code and pass count must equal the plain run's, and its
    means agree within ``PATH_TOL``, unless its verdict flipped at a
    rounding tie: the accept test ``cand_cost <= cost`` (the JAX
    package's) compares two costs that are equal up to rounding once a
    step is far below ``tol``, so the two combine paths may accept and
    reject one such step differently. Such a lane must end converged or
    at the pass budget in both runs (never diverged), with GN costs equal
    within ``COST_RTOL`` and means within the smoother's ``tol``; each
    is printed."""
    from repro_torch.core.api import build_smoother
    from repro_torch.core.iterated import LANE_DIVERGED
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    report = {}
    for method in ("ekf", "slr"):
        model, ys, cfg = _bucket(torch, method)
        spec = sc_spec(cfg, damping="adaptive")
        reset_counts()
        (traj, info), wall = _timed(torch, lambda: build_smoother(
            spec, device="cuda").iterate(model, ys, return_info=True))
        counts = read_counts()
        launches = {k: counts.pop(k) for k in kc.LAUNCHES}
        if any(counts.values()) or min(launches.values()) == 0 or len(
                set(launches.values())) != 1:
            fail(f"adaptive {method}: kernel launches {launches}, "
                 f"others {counts}")
        (ptraj, pinfo), plain_wall = _timed(torch, lambda: build_smoother(
            spec, backend="jnp", device="cuda").iterate(
                model, ys, return_info=True))
        for x in (*traj, info.final_cost):
            if not bool(torch.isfinite(x).all()):
                fail(f"adaptive {method}: NaN or inf returned")
        dmean = (traj.mean - ptraj.mean).abs().amax(dim=(1, 2))
        same = ((info.code == pinfo.code)
                & (info.iterations == pinfo.iterations)).tolist()
        flips, worst = [], 0.0
        for lane, equal in enumerate(same):
            codes = (int(info.code[lane]), int(pinfo.code[lane]))
            passes = (int(info.iterations[lane]),
                      int(pinfo.iterations[lane]))
            costs = (float(info.final_cost[lane]),
                     float(pinfo.final_cost[lane]))
            if equal:
                if not torch.allclose(traj.mean[lane], ptraj.mean[lane],
                                      **PATH_TOL):
                    fail(f"adaptive {method} lane {lane}: kernel path vs "
                         f"plain path max abs diff {dmean[lane]:.3e}")
                worst = max(worst, float(dmean[lane]))
                continue
            tie = (LANE_DIVERGED not in codes
                   and abs(costs[0] - costs[1]) <= COST_RTOL * abs(costs[1])
                   and float(dmean[lane]) <= spec.tol)
            say(f"[adaptive] {method} lane {lane}: codes {codes}, passes "
                f"{passes} (kernels, plain); GN costs {costs[0]!r}, "
                f"{costs[1]!r}; max |dmean| {float(dmean[lane]):.3e}: "
                f"{'a verdict flipped at a rounding tie' if tie else 'FAIL'}")
            if not tie:
                fail(f"adaptive {method} lane {lane}: code/passes differ "
                     "from the plain run beyond a rounding tie")
            flips.append({"lane": lane, "codes": codes, "passes": passes,
                          "costs": costs, "max_abs_mean": float(dmean[lane])})
        codes = {c: int((info.code == c).sum()) for c in (0, 1, 2)}
        say(f"[adaptive] {method} 64 x 512 bucket, f64: {wall:.3f}s "
            f"(plain combines {plain_wall:.3f}s); kernel launches "
            f"{launches}; lane codes {codes} (converged/max iters/"
            f"diverged), mean passes {info.iterations.double().mean():.2f}; "
            f"{len(same) - len(flips)}/{len(same)} lanes with the plain "
            f"run's code and passes (max |dmean| {worst:.3e}), "
            f"{len(flips)} flipped at a tie")
        report[method] = {"wall_s": wall, "plain_wall_s": plain_wall,
                          "launches": launches, "codes": codes,
                          "iterations": info.iterations.tolist(),
                          "vs_plain_max_abs": worst, "tie_flips": flips}
    return report


# ---------------------------------------------------------------------------
# The streaming service: autotuner, stream, chaos and tenants
# ---------------------------------------------------------------------------

#: The stream's bucket shapes: n in {256, 384, 512} pads to 256 or 512,
#: and the deadline policy flushes at every power-of-two width <= 64.
STREAM_N_PADS = (256, 512)
STREAM_B_PADS = (1, 2, 4, 8, 16, 32, 64)
TENANTS = "coordinated_turn,pendulum:gold,lorenz96:batch"
#: [tenants]' requests (the stream's 64, cut to keep the script in its
#: time: the executor runs near capacity, so the phase's wall follows the
#: request count; the arrival rate, widths and deadline stay the stream's).
TENANTS_REQUESTS = 16
#: The [chaos] fault mix: NaN payloads at the headline rate 0.1; the
#: executor faults at 0.5 per flush, so that the static policy's handful
#: of flushes meets transient exceptions and stragglers too.
CHAOS = dict(seed=0, nan_rate=0.1, exception_rate=0.5, straggler_rate=0.5)


def stream_config(**fields):
    """The JAX service's streaming defaults at full width: 64
    coordinated-turn requests, n in {256, 384, 512}, launch width 64, f64,
    IEKS (10 passes, tol 1e-6, lambda 1), Poisson arrivals at 8/s, the
    deadline policy with a 2 s deadline and a 0.25 s wait cap, warmed,
    ``backend="auto"``."""
    from repro_torch.launch.serve import SmootherServeConfig

    return SmootherServeConfig(**{
        "requests": 64, "n": 512, "max_batch": 64, "f64": True,
        "arrival": "poisson", "policy": "deadline", "rate": 8.0,
        "deadline_s": 2.0, "max_wait_s": 0.25, **fields})


class FlushLaunches:
    """Counts each queue flush's combine-kernel launches, read around
    `SmootherServer.run_flush` (the executor every stream calls), so a
    flush can be held against the measured choice for its shape."""

    def __enter__(self):
        from repro_torch.kernels.kalman_combine import kalman_combine as kc
        from repro_torch.launch.serve import SmootherServer

        self._cls, self._orig, self.flushes = SmootherServer, \
            SmootherServer.run_flush, []
        orig, flushes = self._orig, self.flushes

        def counted(server, fl):
            before = dict(kc.LAUNCHES)
            out = orig(server, fl)
            flushes.append((server, fl, out[3], {
                k: kc.LAUNCHES[k] - before[k] for k in before}))
            return out

        SmootherServer.run_flush = counted
        return self

    def __exit__(self, *exc):
        self._cls.run_flush = self._orig

    def check(self, tag: str) -> dict:
        """Each flush that ran a pass launched both combine kernels if
        its bucket's choice is "pallas" (measured, or unmeasured on the
        card, as the retry lane's shapes are), and none otherwise; a
        flush of lanes that all diverged up front (NaN observations) runs
        no pass and launches nothing. Returns the launches per tenant."""
        from repro_torch.kernels.kalman_combine import autotune as kc_at

        per_tenant = {}
        for server, fl, passes, launched in self.flushes:
            n_pad, nx = fl.signature[2], fl.signature[3]
            choice = kc_at.decide(fl.signature[0], fl.b_pad, n_pad, nx,
                                  device="cuda")
            ok = (min(launched.values()) > 0 if choice == "pallas" and passes
                  else not any(launched.values()))
            if not ok:
                fail(f"[{tag}] flush {fl.signature} x {fl.b_pad} (choice "
                     f"{choice}, {passes} passes) launched {launched}")
            tot = per_tenant.setdefault(server.tenant,
                                        {k: 0 for k in launched})
            for k, v in launched.items():
                tot[k] += v
        return per_tenant


def _stream_line(stats) -> str:
    return (f"p50 {stats['latency_p50_s'] * 1e3:.1f} ms, p95 "
            f"{stats['latency_p95_s'] * 1e3:.1f} ms, {stats['traj_per_s']:.2f}"
            f" traj/s, deadline hit {stats['deadline_hit_rate']:.3f}, goodput "
            f"{stats['goodput_rps']:.2f} req/s, occupancy "
            f"{stats['occupancy']:.3f}, {stats['launches']} launches, flush "
            f"reasons {stats['flush_reasons']}, verdicts {stats['verdicts']}")


def _digest(stats) -> dict:
    keys = ("requests", "launches", "latency_p50_s", "latency_p95_s",
            "latency_mean_s", "queue_wait_p95_s", "deadline_hit_rate",
            "traj_per_s", "goodput_rps", "occupancy", "flush_reasons",
            "verdicts", "stragglers", "mean_iterations", "compiles",
            "per_tenant", "mean_rmse_per_tenant", "mean_loglik_per_tenant")
    return {k: stats[k] for k in keys if k in stats}


def _paired_ms(torch, fa, fb, reps: int = 7) -> tuple:
    """Median wall milliseconds of ``fa()`` and of ``fb()`` (each call
    synchronized before and after), after one warm call each. The calls
    alternate, so a slow spell of the shared host lands on both."""
    fa(), fb()
    times = ([], [])
    for _ in range(reps):
        for fn, out in zip((fa, fb), times):
            out.append(_timed(torch, fn)[1] * 1e3)
    return tuple(sorted(t)[reps // 2] for t in times)


def phase_autotune(torch) -> dict:
    """``[autotune]``: the kernel-vs-plain verdict for every bucket shape
    of the stream, measured under the stream's own spec (so its warmup
    finds them cached). The verdict comes from the JAX package's probe,
    one f32 filtering combine; the same probe in f64 is printed beside
    it. The gates hold what the stream runs: one ``"auto"`` f64
    filter+smoother pass at the shape launches both combine kernels if
    and only if the choice is "pallas", and takes no longer than the same
    pass on the other backend (``"jnp"`` or ``"gpu"``)."""
    import dataclasses

    from repro_torch.core.api import build_smoother
    from repro_torch.core.iterated import (_linearize,
                                           initial_trajectory_batched)
    from repro_torch.kernels.kalman_combine import autotune as kc_at
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch.serve import pad_requests

    cfg = stream_config()
    smoother = build_smoother(sc_spec(cfg), device="cuda")
    other = {"pallas": build_smoother(smoother.spec, backend="jnp",
                                      device="cuda"),
             "fused": build_smoother(smoother.spec, backend="gpu",
                                     device="cuda")}
    model = sc_model(torch)
    dev = torch.device("cuda")
    rows = []
    for n_pad in STREAM_N_PADS:
        for b_pad in STREAM_B_PADS:
            entry = smoother.autotune(b_pad, n_pad, MAIN_NX)
            if entry["backend"] != "gpu":
                fail(f"[autotune] {b_pad} x {n_pad}: {entry}")
            pairs = max(n_pad // 2, 1)
            ei, ej = (kc_at._level_elements(b_pad, pairs, MAIN_NX,
                                            torch.float64, dev)
                      for _ in range(2))
            probe64 = {name: kc_at._time_us(fn, ei, ej) for name, fn in (
                ("kernel_us", kc.filtering_combine_cuda),
                ("fused_us", kc.filtering_combine_plain))}
            ys, rs = pad_requests(
                [torch.zeros((n_pad, model.ny), dtype=torch.float64,
                             device="cuda")], n_pad, b_pad, model.R)
            model_b = dataclasses.replace(model, R=rs)
            lin = _linearize(model_b, initial_trajectory_batched(
                model_b, b_pad, n_pad), smoother.config, None)
            before = dict(kc.LAUNCHES)
            _, sm = smoother.smooth(lin, ys, model.m0, model.P0)
            torch.cuda.synchronize()
            launched = {k: kc.LAUNCHES[k] - before[k] for k in before}
            if entry["choice"] == "pallas":
                ok = min(launched.values()) > 0
            else:
                ok = not any(launched.values())
            if not ok or not bool(torch.isfinite(sm.mean).all()):
                fail(f"[autotune] {b_pad} x {n_pad}: choice "
                     f"{entry['choice']}, an auto pass launched {launched}")
            auto_ms, other_ms = _paired_ms(
                torch, lambda: smoother.smooth(lin, ys, model.m0, model.P0),
                lambda: other[entry["choice"]].smooth(lin, ys, model.m0,
                                                      model.P0))
            say(f"[autotune] B={b_pad} T={n_pad} nx={MAIN_NX} "
                f"({b_pad} x {pairs} pairs): probe f32 kernel "
                f"{entry['kernel_us']:.1f} us, plain "
                f"{entry['fused_us']:.1f} us -> {entry['choice']}; probe "
                f"f64 kernel {probe64['kernel_us']:.1f} us, plain "
                f"{probe64['fused_us']:.1f} us; f64 pass auto "
                f"{auto_ms:.3f} ms vs {other[entry['choice']].spec.backend}"
                f" {other_ms:.3f} ms; auto pass launched {launched}")
            if not auto_ms <= other_ms:
                fail(f"[autotune] {b_pad} x {n_pad}: the auto f64 pass "
                     f"({entry['choice']}) takes {auto_ms:.3f} ms, the other "
                     f"backend {other_ms:.3f} ms")
            rows.append({"B": b_pad, "T": n_pad, **entry,
                         "probe_f64": probe64, "pass_f64_auto_ms": auto_ms,
                         "pass_f64_other_ms": other_ms,
                         "auto_launches": launched})
    chosen = sum(r["choice"] == "pallas" for r in rows)
    say(f"[autotune] {chosen}/{len(rows)} bucket shapes choose the kernels")
    return {"spec_id": smoother.spec_id, "rows": rows}


def phase_stream(torch, oneshot) -> tuple:
    """``[stream]``: `serve_smoother` with the JAX service's streaming
    defaults on the card, counts zeroed before and read after. Every
    verdict ok, no launch error, every flush's launches as its measured
    choice says, each request's mean within PATH_TOL of the [main]
    one-shot run's (a lane whose pass count differs within the smoother's
    tol), median position RMSE < 0.1. Returns the report and the stats
    (with the warm server) for [chaos]."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch.serve import make_fleet, serve_smoother

    cfg = stream_config()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with FlushLaunches() as flushes:
        stats = serve_smoother(cfg, emit=say, device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    launches = {k: counts.pop(k) for k in kc.LAUNCHES}
    if any(counts.values()):
        fail(f"the stream launched other kernels: {counts}")
    in_flushes = flushes.check("stream")
    choices = stats["backend_choices"]
    say(f"[stream] {_stream_line(stats)}")
    say(f"[stream] {total_s:.2f}s end to end incl. fleet simulation, warmup "
        f"and autotune lookups; backend_choices "
        f"{sum(v == 'pallas' for v in choices.values())} pallas / "
        f"{sum(v == 'fused' for v in choices.values())} fused of "
        f"{len(choices)}; kernel launches {launches} (in flushes "
        f"{in_flushes.get('coordinated_turn')})")
    bad = {v for v in stats["verdicts"] if v != "ok"}
    errors = [l for l in stats["launch_log"] if "error" in l]
    if bad or errors:
        fail(f"[stream] verdicts {stats['verdicts']}, launch errors "
             f"{[l['error'] for l in errors]}")
    main = oneshot
    worst, flips = 0.0, []
    for i, (a, b) in enumerate(zip(stats["results"], main["results"])):
        diff = (a - b).abs().max().item()
        if stats["iterations"][i] != main["iterations"][i]:
            say(f"[stream] request {i}: {stats['iterations'][i]} passes "
                f"against the one-shot run's {main['iterations'][i]}, max "
                f"|dmean| {diff:.3e} (tol {cfg.tol:g})")
            flips.append({"request": i, "diff": diff})
            if not diff <= cfg.tol:
                fail(f"[stream] request {i} differs from the one-shot run "
                     f"by {diff:.3e} > tol")
            continue
        if not torch.allclose(a, b, **PATH_TOL):
            fail(f"[stream] request {i}: stream vs one-shot max abs diff "
                 f"{diff:.3e}")
        worst = max(worst, diff)
    model = sc_model(torch)
    _, truths = make_fleet(cfg, model)
    rmses = sorted(_rmse(torch, m, t)
                   for m, t in zip(stats["results"], truths))
    median = rmses[len(rmses) // 2]
    say(f"[stream] vs the [main] one-shot run: max |dmean| {worst:.3e} over "
        f"{len(rmses) - len(flips)} requests with equal passes, "
        f"{len(flips)} with other passes; position RMSE median "
        f"{median:.4f}, mean {stats['mean_rmse']:.4f}")
    if not median < 0.1:
        fail(f"[stream] median position RMSE {median} >= 0.1")
    load = _executor_load(stats)
    say(f"[stream] executor: {load['flushes']} flushes of "
        f"{load['mean_requests']:.2f} requests on average, compute "
        f"{load['mean_compute_s'] * 1e3:.1f} ms per flush (min "
        f"{load['min_compute_s'] * 1e3:.1f}, max "
        f"{load['max_compute_s'] * 1e3:.1f}), busy {load['busy_share']:.3f} "
        f"of the span from the first arrival to the last completion")
    flush = _profile_flush(torch, stats["server"], make_fleet(
        cfg, stats["server"].model)[0], cfg.n)
    say(f"[stream] one flush of 2 requests at n_pad={cfg.n} (the stream's "
        f"typical width): wall {flush['wall_s'] * 1e3:.1f} ms unprofiled, "
        f"device busy {flush['device_busy_s'] * 1e3:.2f} ms in "
        f"{flush['kernel_launches']} kernel launches, device idle "
        f"{flush['idle_share']:.1%} of the wall")
    report = {**_digest(stats), "launches_by_kernel": launches,
              "total_s": total_s, "backend_choices": choices,
              "vs_oneshot_max_abs": worst, "pass_flips": flips,
              "median_rmse": median, "mean_rmse": stats["mean_rmse"],
              "executor": load, "flush_profile": flush}
    return report, stats


def _executor_load(stats) -> dict:
    """How loaded the stream's serial executor was: flushes, requests and
    measured compute per flush, and compute over the stream's span."""
    ran = [l for l in stats["launch_log"] if not l.get("shed")]
    compute = [l["compute_s"] for l in ran]
    span = max(r["arrival"] + r["latency_s"] for r in stats["records"]) \
        - min(r["arrival"] for r in stats["records"])
    return {"flushes": len(ran),
            "mean_requests": sum(l["b"] for l in ran) / len(ran),
            "mean_compute_s": sum(compute) / len(ran),
            "min_compute_s": min(compute), "max_compute_s": max(compute),
            "busy_share": sum(compute) / span}


def _profile_flush(torch, server, requests, n: int) -> dict:
    """Device busy time of one warm ``smooth_batch`` of two length-``n``
    requests at width 2 (``torch.profiler``) beside its unprofiled
    wall."""
    from torch.profiler import ProfilerActivity, profile

    batch = [y for y in requests if len(y) == n][:2]
    server.smooth_batch(batch, n, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.smooth_batch(batch, n, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.smooth_batch(batch, n, 2)
        torch.cuda.synchronize()
    kernels = _device_events(prof.key_averages())
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "kernel_launches": sum(e.count for e in kernels),
            "idle_share": 1 - busy / wall}


def phase_chaos(torch, stream) -> dict:
    """``[chaos]``: the same stream on the same warm server under the
    static policy, without faults and then under `CHAOS` (counts zeroed
    before the chaos run and read after): at least one transient
    exception and one straggler are injected, every corrupted request
    gets an explicit verdict, no NaN mean reaches a client, every healthy
    request is bit-identical to the fault-free run, and no launch error
    escapes the in-place retry."""
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch.autobatch import FlushPolicy, make_arrivals
    from repro_torch.launch.chaos import ChaosConfig
    from repro_torch.launch.serve import make_fleet

    cfg = stream_config()
    server = stream["server"]
    requests, _ = make_fleet(cfg, server.model)
    arrivals = make_arrivals(cfg.arrival, cfg.requests, cfg.rate,
                             cfg.burst_size, seed=cfg.seed)
    policy = FlushPolicy(kind="static", max_batch=cfg.max_batch)
    clean = server.serve_stream(requests, arrivals, emit=say, policy=policy)
    torch.cuda.synchronize()
    reset_counts()
    with FlushLaunches() as flushes:
        faulty = server.serve_stream(requests, arrivals, emit=say,
                                     policy=policy,
                                     chaos=ChaosConfig(**CHAOS))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts.pop(k) for k in kc.LAUNCHES}
    if any(counts.values()):
        fail(f"the chaos stream launched other kernels: {counts}")
    flushes.check("chaos")
    verdicts = {r["req_id"]: r["verdict"] for r in faulty["records"]}
    corrupted = {int(i) for i in faulty["chaos"]["corrupted_requests"]}
    for log in (clean, faulty):
        errors = [l["error"] for l in log["launch_log"] if "error" in l]
        if errors:
            fail(f"[chaos] launch errors: {errors}")
    if not (faulty["chaos"]["exceptions"] and faulty["chaos"]["stragglers"]):
        fail(f"[chaos] injected {faulty['chaos']['exceptions']} transient "
             f"exceptions and {faulty['chaos']['stragglers']} stragglers")
    if set(v for v in (r["verdict"] for r in clean["records"])) != {"ok"}:
        fail(f"[chaos] fault-free static run verdicts {clean['verdicts']}")
    for i in corrupted:
        if verdicts[i] not in ("diverged", "retried", "shed"):
            fail(f"[chaos] corrupted request {i} got verdict {verdicts[i]}")
    healthy = [i for i, v in verdicts.items() if v == "ok"]
    for i in healthy:
        if not (torch.equal(faulty["results"][i], clean["results"][i])
                and faulty["logliks"][i] == clean["logliks"][i]):
            fail(f"[chaos] healthy request {i} differs from the fault-free "
                 "run")
    for i, m in enumerate(faulty["results"]):
        if verdicts[i] != "shed" and (m is None
                                      or not bool(torch.isfinite(m).all())):
            fail(f"[chaos] request {i}: NaN or no mean reached the client")
    say(f"[chaos] static policy: fault-free {clean['launches']} launches, "
        f"{clean['traj_per_s']:.2f} traj/s; under {CHAOS}: corrupted "
        f"{sorted(corrupted)} -> verdicts "
        f"{ {i: verdicts[i] for i in sorted(corrupted)} }, "
        f"{faulty['chaos']['exceptions']} transient exceptions, "
        f"{faulty['chaos']['stragglers']} stragglers injected "
        f"({faulty['stragglers']} flagged); {len(healthy)} healthy requests "
        f"bit-identical to the fault-free run; no NaN reached a client; "
        f"kernel launches {launches}")
    say(f"[chaos] {_stream_line(faulty)}")
    # The corrupted requests' retry flushes hold only NaN lanes, which
    # run no pass; two healthy requests show the retry lane's kernels.
    batch = [y for y in requests if len(y) == cfg.n][:2]
    before = dict(kc.LAUNCHES)
    _, info, _, health = server.smooth_batch(batch, cfg.n, 2, lane="retry")
    retry_launched = {k: kc.LAUNCHES[k] - before[k] for k in before}
    say(f"[chaos] retry lane, 2 healthy requests at n_pad={cfg.n}: "
        f"{info.iterations[:2].tolist()} passes, health {health}, kernel "
        f"launches {retry_launched}")
    if min(retry_launched.values()) == 0 or not all(health):
        fail(f"[chaos] the retry lane launched {retry_launched}, health "
             f"{health}")
    return {"clean": _digest(clean), "faulty": _digest(faulty),
            "chaos": faulty["chaos"], "launches_by_kernel": launches,
            "healthy_bit_identical": len(healthy),
            "retry_lane_launches": retry_launched}


def phase_tenants(torch) -> dict:
    """``[tenants]``: `serve_smoother_multitenant` over coordinated_turn,
    pendulum (gold) and lorenz96 (batch) on the card, `TENANTS_REQUESTS`
    requests, n <= 512, Poisson at 8/s, deadline policy, counts zeroed before and read
    after. No launch mixes tenants and none has an error; each flush's
    launches follow its tenant's measured choice."""
    from repro_torch.kernels.kalman_combine import autotune as kc_at
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.launch.serve import TenantSpec, serve_smoother_multitenant
    from repro_torch.scenarios import get_scenario

    cfg = stream_config(requests=TENANTS_REQUESTS)
    tenants = [TenantSpec.parse(t) for t in TENANTS.split(",")]
    # The warmup's autotune probes compare the kernel with its plain
    # version; measured here, before the counters are zeroed, they stay
    # out of the path's launches (the warmup finds them cached).
    for t in tenants:
        spec_id, nx = t.smoother_spec(cfg).spec_id, \
            get_scenario(t.scenario).nx
        entries = [kc_at.autotune(spec_id, b, n, nx, device="cuda")
                   for n in STREAM_N_PADS for b in STREAM_B_PADS]
        say(f"[tenants] {t.tenant} (nx={nx}) autotune: "
            f"{sum(e['choice'] == 'pallas' for e in entries)}/"
            f"{len(entries)} shapes choose the kernels; kernel "
            f"{min(e['kernel_us'] for e in entries):.1f}-"
            f"{max(e['kernel_us'] for e in entries):.1f} us, plain "
            f"{min(e['fused_us'] for e in entries):.1f}-"
            f"{max(e['fused_us'] for e in entries):.1f} us")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with FlushLaunches() as flushes:
        stats = serve_smoother_multitenant(cfg, tenants, emit=say,
                                           device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    launches = {k: counts.pop(k) for k in kc.LAUNCHES}
    if any(counts.values()):
        fail(f"the tenant stream launched other kernels: {counts}")
    per_tenant = flushes.check("tenants")
    tenant_of = {r["req_id"]: r["tenant"] for r in stats["records"]}
    for l in stats["launch_log"]:
        members = {tenant_of[i] for i in l["req_ids"]}
        if len(members) != 1 or l["tenants"] != sorted(members):
            fail(f"[tenants] a launch mixes tenants: {l['tenants']}")
        if "error" in l:
            fail(f"[tenants] launch error: {l['error']}")
    say(f"[tenants] {_stream_line(stats)}; {total_s:.2f}s end to end")
    nan = float("nan")
    for t, d in sorted(stats["per_tenant"].items()):
        say(f"[tenants] {t}: {d['requests']} requests, p50 "
            f"{d['latency_p50_s'] * 1e3:.1f} ms, p95 "
            f"{d['latency_p95_s'] * 1e3:.1f} ms, deadline hit "
            f"{d['deadline_hit_rate']:.3f}, state RMSE "
            f"{stats['mean_rmse_per_tenant'].get(t, nan):.4f}, loglik "
            f"{stats['mean_loglik_per_tenant'].get(t, nan):.1f}, kernel "
            f"launches in flushes {per_tenant.get(t)}")
    return {**_digest(stats), "launches_by_kernel": launches,
            "launches_per_tenant": per_tenant, "total_s": total_s,
            "backend_choices": stats["backend_choices"]}


# ---------------------------------------------------------------------------
# The single-trajectory surface: the paper's drivers at n = 4096
# ---------------------------------------------------------------------------

#: The largest size of the paper's Fig. 1 (``benchmarks/paper_fig1.py``
#: SIZES), the passes and damping of its IEKS/IPLS runs, and the sizes of
#: the timed Fig. 1b panel.
SURFACE_N, SURFACE_ITERS, SURFACE_LM = 4096, 10, 1.0
SURFACE_SIZES = (128, 1024, 4096)
#: Timed calls per Fig. 1b point (the median is kept; 5 before, cut to
#: keep the script in its time). Sequential passes at or above
#: `SURFACE_LONG_SEQ` steps (about 50 launches per time step, seconds
#: each) are timed once, warmed by the n = 128 one (the same ops at
#: another length), and not profiled.
SURFACE_REPEATS, SURFACE_LONG_SEQ = 3, 1024


def _deprecations(fn):
    """``fn()`` and the DeprecationWarnings naming `build_smoother` that
    it emitted."""
    import warnings

    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out = fn()
    return out, [w for w in ws if issubclass(w.category, DeprecationWarning)
                 and "build_smoother" in str(w.message)]


def _err_over_tol(got, want, tol) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over every field
    of two NamedTuples of tensors (the check passes below 1)."""
    return max(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
               .max().item() for g, w in zip(got, want))


def _same(a, b) -> bool:
    """Every field of ``a`` equal to ``b``'s, bit for bit."""
    return all(x.shape == y.shape and bool((x == y).all())
               for x, y in zip(a, b))


def _kernel_profile(torch, fn) -> dict:
    """Device launches and busy time of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _device_events(prof.key_averages())
    return {"launches": sum(e.count for e in kernels),
            "busy_s": sum(e.self_device_time_total for e in kernels) / 1e6}


def phase_surface(torch) -> dict:
    """``[surface]``: the single-trajectory surface on the card, on the
    paper's coordinated_turn configuration (nx = 5, ny = 2), one
    trajectory of n = 4096 simulated on the card from seed 0.

    (a) ``ieks`` and ``ipls`` (10 passes, LM damping 1.0, f64) with the
    counters zeroed just before and read just after: each combine kernel
    launches exactly 10 x the non-empty combine calls of one scan, no
    plain combine and no other kernel runs; each result bit for bit equal
    to ``build_smoother(...).iterate`` and within PATH_TOL of
    ``iterated_smoother`` on the plain versions (``backend="jnp"``);
    finite, not diverged; a second call warns no more. (b) One Taylor
    linearization at the IEKS result: the single-trajectory passes
    against each other (kernels, textbook combines, sequential,
    square-root), the public `associative_scan` against
    `parallel_filter`, the log-likelihood and GN cost against the
    `Smoother`'s methods. (c) The Fig. 1b panel in f32: the wall time of
    one Gauss-Newton pass at n in `SURFACE_SIZES` through the kernels,
    through the textbook combines and sequentially, with launches per
    pass and the kernel pass's device busy time at n = 4096; the device
    time of each combine kernel at B = 1's top level beside its bound."""
    import repro_torch.core as C
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.scenarios import get_scenario

    tag = "surface"
    sc = get_scenario("coordinated_turn")
    model = sc.make_model(torch.float64, "cuda")
    xs, ys = sc.simulate(model, SURFACE_N,
                         torch.Generator(device="cuda").manual_seed(0))
    calls = [P for P in scan_level_pairs(SURFACE_N) if P]
    want = SURFACE_ITERS * len(calls)
    say(f"[{tag}] coordinated_turn, one trajectory n={SURFACE_N} (seed 0) "
        f"f64: expect {want} launches of each combine kernel per "
        f"{SURFACE_ITERS}-pass run ({len(calls)} non-empty combine calls "
        f"per scan, each a [1, P] grid)")
    report = {"n": SURFACE_N, "expected_launches": want, "drivers": {}}
    launches = {k: 0 for k in kc.LAUNCHES}

    # (a) The paper's iterated drivers through the kernels.
    for name, method in (("ieks", "ekf"), ("ipls", "slr")):
        def run():
            return getattr(C, name)(model, ys, n_iter=SURFACE_ITERS,
                                    lm_lambda=SURFACE_LM)

        _, first = _deprecations(run)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        traj, again = _deprecations(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        plain_calls = dict(kc.PLAIN_CALLS)
        got = {k: counts.pop(k) for k in kc.LAUNCHES}
        say(f"[{tag}] {name}(model, ys, n_iter={SURFACE_ITERS}, "
            f"lm_lambda={SURFACE_LM}): {wall:.3f}s, kernel launches {got}, "
            f"plain combine calls {plain_calls}, other kernels {counts}; "
            f"DeprecationWarnings: first call {len(first)}, second "
            f"{len(again)}")
        if len(first) != 1 or again:
            fail(f"{name}: {len(first)} DeprecationWarnings on the first "
                 f"call and {len(again)} on the second, expected 1 and 0")
        if any(v != want for v in got.values()):
            fail(f"{name}: combine kernel launches {got}, expected {want} "
                 "of each")
        if any(plain_calls.values()) or any(counts.values()):
            fail(f"{name}: plain combine calls {plain_calls}, other "
                 f"kernels {counts}")
        for k in launches:
            launches[k] += got[k]
        cfg = C.IteratedConfig(method=method, n_iter=SURFACE_ITERS,
                               lm_lambda=SURFACE_LM)
        ref, info = C.build_smoother(C.SmootherSpec.from_iterated_config(
            cfg), device="cuda").iterate(model, ys, return_info=True)
        if not _same(traj, ref):
            fail(f"{name} differs from build_smoother(...).iterate")
        before = dict(kc.LAUNCHES)
        plain = C.iterated_smoother(model, ys, dataclasses.replace(
            cfg, backend="jnp"))
        torch.cuda.synchronize()
        if kc.LAUNCHES != before:
            fail(f'{name}: iterated_smoother with backend="jnp" launched '
                 "a kernel")
        ratio = _err_over_tol(traj, plain, PATH_TOL)
        diff = (traj.mean - plain.mean).abs().max().item()
        if not ratio < 1.0:
            fail(f"{name}: kernels vs plain versions, max err/tol {ratio:.3f}"
                 f" (max |dmean| {diff:.3e})")
        finite = all(bool(torch.isfinite(x).all()) for x in traj)
        code = int(info.code)
        if not finite or code == C.LANE_DIVERGED:
            fail(f"{name}: finite {finite}, lane code {code}")
        rmse = _rmse(torch, traj.mean, xs)
        say(f"[{tag}] {name}: equal to build_smoother(...).iterate bit for "
            f"bit; vs iterated_smoother on the plain versions max |dmean| "
            f"{diff:.3e} (err/tol {ratio:.4f} at PATH_TOL); lane code "
            f"{code}, finite; position RMSE {rmse:.4f}")
        report["drivers"][name] = {
            "wall_s": wall, "launches": got, "vs_plain_max_abs": diff,
            "vs_plain_err_over_tol": ratio, "code": code, "rmse": rmse,
            "traj": traj}

    # (b) One Taylor linearization at the IEKS result.
    traj = report["drivers"]["ieks"].pop("traj")
    report["drivers"]["ipls"].pop("traj")
    lin = C.linearize_model_taylor(model, traj.mean)
    args = (lin, ys, model.m0, model.P0)
    reset_counts()
    kf, ks = C.parallel_filter_smoother(*args, combine_impl="pallas")
    torch.cuda.synchronize()
    one = {k: kc.LAUNCHES[k] for k in kc.LAUNCHES}
    if any(v != len(calls) for v in one.values()) or \
            any(kc.PLAIN_CALLS.values()):
        fail(f"parallel_filter_smoother(combine_impl='pallas'): launches "
             f"{one}, plain calls {kc.PLAIN_CALLS}; expected {len(calls)} "
             "launches of each and no plain call")
    tf, ts = C.parallel_filter_smoother(*args, combine_impl="jnp")
    sf, ss = C.filter_smoother(*args)
    qf, qs = C.sqrt_parallel_filter_smoother(*args)
    checks = {
        "kernels vs textbook": (_err_over_tol(kf + ks, tf + ts,
                                              TOL["float64"]), "TOL"),
        "kernels vs sequential": (_err_over_tol(kf + ks, sf + ss, SEQ_TOL),
                                  "SEQ_TOL"),
        "sqrt vs sequential": (_err_over_tol(qf + qs, sf + ss, SEQ_TOL),
                               "SEQ_TOL"),
    }
    for what, (ratio, tol) in checks.items():
        if not ratio < 1.0:
            fail(f"[{tag}] one linearization, {what}: err/tol {ratio:.3f} "
                 f"at {tol}")
    f = C.parallel_filter(*args, combine_impl="pallas")
    s = C.parallel_smoother(lin, f, model.m0, model.P0,
                            combine_impl="pallas")
    if not (_same(f, kf) and _same(s, ks)):
        fail("parallel_filter + parallel_smoother differ from "
             "parallel_filter_smoother")
    scanned = C.associative_scan(C.filtering_combine,
                                 C.filtering_elements(*args),
                                 combine_impl="pallas")
    if not _same((scanned.b, scanned.C), f):
        fail("associative_scan over filtering_elements differs from "
             "parallel_filter")
    kfl, loglik = C.kalman_filter(*args, return_loglik=True)
    if not (_same(kfl, sf) and bool(torch.isfinite(loglik))):
        fail(f"kalman_filter(return_loglik=True): filtered equal to "
             f"filter_smoother's {_same(kfl, sf)}, loglik {loglik.item()}")
    sm = C.build_smoother(sc.default_spec(n_iter=SURFACE_ITERS),
                          device="cuda")
    ll = C.smoothed_log_likelihood(model, ys, traj, sm.config)
    cost = C.gn_cost(model, ys, traj)
    if not (_same((ll, cost), (sm.log_likelihood(model, ys, traj),
                               sm.cost(model, ys, traj)))
            and ll.shape == () and cost.shape == ()):
        fail("smoothed_log_likelihood / gn_cost on one trajectory differ "
             "from the Smoother's methods")
    say(f"[{tag}] one Taylor linearization at the IEKS result: "
        f"parallel_filter_smoother launches {one}; " + "; ".join(
            f"{what} err/tol {r:.2e} at {t}" for what, (r, t)
            in checks.items())
        + "; parallel_filter + parallel_smoother and associative_scan "
        f"equal bit for bit; kalman_filter loglik {loglik.item():.4f}; "
        f"smoothed loglik {ll.item():.4f} and GN cost {cost.item():.4f} "
        "equal to the Smoother's")
    report["one_linearization"] = {
        "launches": one, "kalman_loglik": loglik.item(),
        "smoothed_loglik": ll.item(), "gn_cost": cost.item(),
        **{what: r for what, (r, _) in checks.items()}}

    # (c) The Fig. 1b panel: one Gauss-Newton pass, f32.
    model32 = sc.make_model(torch.float32, "cuda")
    ys32 = ys.float()
    setups = {"kernels": dict(combine_impl="pallas"),
              "textbook": dict(combine_impl="jnp"),
              "sequential": dict(parallel=False)}
    fig = []
    for n in SURFACE_SIZES:
        y = ys32[:n]
        for setup, kw in setups.items():
            cfg = C.IteratedConfig(n_iter=1, lm_lambda=SURFACE_LM, **kw)

            def one_pass():
                return C.iterated_smoother(model32, y, cfg)

            long_seq = setup == "sequential" and n >= SURFACE_LONG_SEQ
            if not long_seq:
                one_pass()
            walls = []
            for _ in range(1 if long_seq else SURFACE_REPEATS):
                reset_counts()
                out, wall = _timed(torch, one_pass)
                walls.append(wall)
            kernel_launches = dict(kc.LAUNCHES)
            if not all(bool(torch.isfinite(x).all()) for x in out):
                fail(f"[{tag}] f32 pass {setup} n={n}: non-finite output")
            row = {"n": n, "setup": setup, "wall_s": sorted(walls)[
                len(walls) // 2], "walls_s": walls,
                "combine_launches": kernel_launches}
            if not long_seq:
                row.update(_kernel_profile(torch, one_pass))
            fig.append(row)
        by = {r["setup"]: r for r in fig[-len(setups):]}
        say(f"[{tag}] f32 one Gauss-Newton pass n={n} (median of "
            f"{SURFACE_REPEATS}; long sequential passes once): " + "; ".join(
            f"{k} {r['wall_s'] * 1e3:.2f} ms ("
            + (f"{r['launches']} launches, busy {r['busy_s'] * 1e3:.2f} ms"
               if "launches" in r else "not profiled")
            + f", combine kernels {sum(r['combine_launches'].values())})"
            for k, r in by.items())
            + f"; sequential / kernels "
            f"{by['sequential']['wall_s'] / by['kernels']['wall_s']:.1f}x")
    top = next(r for r in fig if r["n"] == SURFACE_N
               and r["setup"] == "kernels")
    idle = 1 - top["busy_s"] / top["wall_s"]
    say(f"[{tag}] f32 kernel pass n={SURFACE_N}: device busy "
        f"{top['busy_s'] * 1e3:.2f} ms of {top['wall_s'] * 1e3:.2f} ms wall "
        f"(idle {idle:.1%}); the 10-pass IEKS of (a) (f64) took "
        f"{report['drivers']['ieks']['wall_s']:.3f}s")
    report["fig1b"] = fig
    report["kernel_pass_idle"] = idle

    # The combine kernels at B = 1's top level, read in place.
    gen = torch.Generator(device="cuda").manual_seed(1)
    wrappers = {"filtering_combine": kc.filtering_combine_cuda,
                "smoothing_combine": kc.smoothing_combine_cuda}
    report["b1_top_level"] = {}
    for kind, kernel in wrappers.items():
        sets = [(_sl(x, 0, -1, 2), _sl(x, 1, None, 2)) for x in (
            _level_set(torch, kind, 1, SURFACE_N, MAIN_NX, torch.float64,
                       gen) for _ in range(3))]
        ms = _graph_ms(torch, kernel, sets)
        b_ms, b_by = bound(kind, SURFACE_N // 2, MAIN_NX, "float64")
        say(f"[time] {kind} float64 B=1 top level 1 x {SURFACE_N // 2} "
            f"pairs in place: {ms * 1e3:.2f} us per launch (graph), bound "
            f"{b_ms * 1e3:.3f} us ({b_by})")
        report["b1_top_level"][kind] = {"ms": ms, "bound_ms": b_ms,
                                        "bound_by": b_by}
    report["launches"] = launches
    return report


# ---------------------------------------------------------------------------
# ssm_scan and flash attention paths
# ---------------------------------------------------------------------------

#: Hymba-1.5B's SSM (src/repro/configs/hymba_1p5b.py): d_model 1600,
#: ssm_expand 2, ssm_state 16, so ``models/ssm.py`` scans din*n = 51,200
#: channels of ``[B, T, din*n]``.
SSM_B, SSM_T, SSM_D = 2, 4096, 2 * 1600 * 16
SSM_4D = (SSM_T, 2, 3200, 16)
SSM_EDGES = [(1, 1, 1), (3, 257, 40), (1, 4096, 16), (2, 0, 8)]
#: The JAX kernel suite's TOL (bf16 against an f32-carried reference).
SSM_TOL = {"float32": dict(rtol=2e-4, atol=1e-5),
           "float64": dict(rtol=1e-10, atol=1e-11),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}

#: Llama-3.2-3B's attention (src/repro/configs/llama3p2_3b.py): 24 query
#: heads, 8 key/value heads, head_dim 128.
FA_HQ, FA_HKV, FA_DH = 24, 8, 128
FA_PREFILL_B, FA_PREFILL_T = 2, 4096
FA_DECODE_B, FA_DECODE_TK = 16, 4096
FA_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
          "bfloat16": dict(rtol=3e-2, atol=3e-2)}
#: (B, Hq, Hkv, Tq, Tk, Dh, causal, what)
FA_EDGES = [(1, 8, 1, 512, 512, 128, True, "MQA Hkv=1"),
            (1, 4, 2, 100, 100, 64, True, "T=100"),
            (1, 2, 2, 64, 80, 32, False, "non-causal Tq=64 Tk=80"),
            (2, 4, 2, 200, 200, 16, True, "Dh=16"),
            (2, 4, 2, 200, 200, 32, True, "Dh=32"),
            (2, 4, 2, 200, 200, 64, True, "Dh=64"),
            (1, 4, 2, 130, 130, 256, True, "Dh=256"),
            (3, 6, 2, 7, 300, 64, True, "decode Tq=7"),
            (1, 2, 1, 40, 24, 16, True, "Tq>Tk"),
            (1, 4, 2, 130, 130, 64, True, "T=130 Dh=64"),
            (1, 4, 2, 100, 100, 128, True, "T=100 Dh=128"),
            (1, 4, 2, 130, 130, 128, True, "T=130 Dh=128"),
            (1, 2, 2, 100, 230, 128, False, "non-causal Dh=128"),
            (1, 6, 2, 300, 200, 128, True, "Tq>Tk Dh=128"),
            (2, 6, 2, 1, 300, 128, True, "decode Tk=300, ragged last split"),
            (2, 6, 2, 2, 1, 128, True, "decode Tk=1, Tq=2>Tk"),
            (2, 6, 2, 5, 300, 64, True, "decode Tq=5, 15 rows"),
            (1, 8, 1, 1, 1000, 256, True, "decode MQA Dh=256")]
#: The tight bf16 check: q scaled by this, so that each row's weights
#: peak on a few keys and the outputs are O(1) (rows of v).
FA_PEAK = 8.0
#: The mapped decode edges (tensor parallelism: a rank's q heads against
#: its own cache block, in place): qwen2-1.5b at full width (12 q heads
#: padded to 16, 2 replicated kv heads, Dh 128) on "model" 2. Rank 0's 8
#: q heads read kv heads 0 (six) and 1 (two); rank 1's 4 real heads read
#: kv head 1 of the whole (replicated) cache. (what, head map, planted
#: map: one q head reading the other kv head.) B 8 rows, a cache of 128
#: rows with 96 keys, as ``[train_mesh]`` (f) decodes.
FA_MAP_B, FA_MAP_S, FA_MAP_LEN = 8, 128, 96
FA_MAP_EDGES = [
    ("uneven map (rank 0: 6 + 2)", (0,) * 6 + (1,) * 2,
     (0,) * 6 + (1, 0)),
    ("map into a replicated cache (rank 1: kv 1)", (1,) * 4,
     (0,) + (1,) * 3)]
#: P rounded to bf16 (wgmma kernel) moves each weight by at most 2^-8 of
#: itself, so the output by at most 2^-8 sum_j p_j |v_j| / l; the output's
#: own rounding to bf16 adds 2^-8 |o|. f32 sums add ~1e-6.
FA_BF16_REL = 2.0 ** -8
FA_BF16_ABS = 1e-5


def _dtypes(torch) -> dict:
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}


def _compare(torch, got, want, tol, what) -> float:
    """Max abs error of ``got`` against ``want``; fails outside ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: output {tuple(got.shape)}/{got.dtype}, expected "
             f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0.0
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite output")
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, **tol):
        fail(f"{what} disagrees with its reference: max abs err {err:.3e}")
    return err


def _tight_tol(plain, q, k, v, *extra):
    """The tight bf16 bound of an attention output on bf16 ``q, k, v``:
    ``plain`` in float32 on the same values, and the tolerance
    2^-8 (sum_j p_j |v_j| / l + |o|) + 1e-5 around it."""
    q, k, v = q.float(), k.float(), v.float()
    want = plain(q, k, v, *extra)
    spread = plain(q, k, v.abs(), *extra)
    return want, FA_BF16_REL * (spread + want.abs()) + FA_BF16_ABS


def _excess(got, want, tol):
    """Largest error over its tolerance (a tensor: no host sync)."""
    return ((got.float() - want).abs() / tol).amax()


def _bound(n_bytes: float, n_ops: float, op_dtype: str):
    """Least time in ms (bytes over HBM bandwidth or operations over the
    peak of their type, the larger) and which of the two it is
    (`launch.roofline.bound_ms`)."""
    from repro_torch.launch.roofline import bound_ms

    return bound_ms(n_bytes, n_ops, op_dtype)


def ssm_bound(n: int, dname: str, op_dtype: str):
    """Least time of one scan over ``n`` values (`kernels.work
    .ssm_scan_work`)."""
    from repro_torch.kernels.work import ssm_scan_work

    flops, n_bytes = ssm_scan_work(n, ITEMSIZE[dname])
    return _bound(n_bytes, flops, op_dtype)


def _ssm_inputs(torch, shape, dtype, gen):
    # Decays in (0.2, 1.0): stable recurrences, like trained SSM gates.
    kw = dict(device="cuda", generator=gen)
    a = torch.rand(shape, **kw) * 0.8 + 0.2
    return a.to(dtype), torch.randn(shape, **kw).to(dtype)


def phase_ssm_scan(torch) -> dict:
    from repro_torch.core import linear_recurrence_scan
    from repro_torch.kernels.ssm_scan import ops, ref
    from repro_torch.kernels.ssm_scan import ssm_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(1)
    main_shape = (SSM_B, SSM_T, SSM_D)
    flat = (1, SSM_T, -1)
    a, b = _ssm_inputs(torch, main_shape, torch.float32, gen)
    a4, b4 = _ssm_inputs(torch, SSM_4D, torch.float32, gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    h = ops.ssm_scan(a, b)
    h4 = linear_recurrence_scan(a4, b4, combine_impl="pallas")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = read_counts()
    launches = counts.pop("ssm_scan")
    say(f"[ssm_scan] path: ops.ssm_scan {main_shape} + "
        f"linear_recurrence_scan(pallas) {SSM_4D}, f32: {path_s * 1e3:.2f} "
        f"ms, kernel launches {launches}")
    if launches != 2:
        fail(f"the ssm_scan path launched its kernel {launches} times, "
             "expected 2")
    if any(counts.values()):
        fail(f"the ssm_scan path launched other kernels: {counts}")

    checks = []

    def check(what, got, want, dname):
        err = _compare(torch, got, want, SSM_TOL[dname], f"ssm_scan {what}")
        checks.append({"what": what, "dtype": dname, "max_abs_err": err})
        say(f"[ssm_scan] {what} {dname}: ok, max abs err {err:.3e}")

    check(f"main {main_shape} vs plain", h, ss.ssm_scan_plain(a, b),
          "float32")
    check(f"4-D {SSM_4D} vs plain", h4, ss.ssm_scan_plain(
        a4.reshape(flat), b4.reshape(flat)).reshape(SSM_4D), "float32")
    check(f"4-D {SSM_4D} vs jnp path (scan over the leading axis)", h4,
          linear_recurrence_scan(a4, b4, combine_impl="jnp"), "float32")
    del h, h4
    torch.cuda.empty_cache()
    for dname in ("float64", "bfloat16"):
        dt = _dtypes(torch)[dname]
        x, y = a.to(dt), b.to(dt)
        check(f"main {main_shape} vs plain", ss.ssm_scan_cuda(x, y),
              ss.ssm_scan_plain(x, y), dname)
        x, y = a4.to(dt), b4.to(dt)
        check(f"4-D {SSM_4D} vs plain",
              linear_recurrence_scan(x, y, combine_impl="pallas"),
              ss.ssm_scan_plain(x.reshape(flat), y.reshape(flat)
                                ).reshape(SSM_4D), dname)
        del x, y
        torch.cuda.empty_cache()
    for dname, dt in _dtypes(torch).items():
        for shape in SSM_EDGES:
            x, y = _ssm_inputs(torch, shape, dt, gen)
            before = ss.LAUNCHES["ssm_scan"]
            got = ops.ssm_scan(x, y)
            want_launches = 1 if x.numel() else 0
            if ss.LAUNCHES["ssm_scan"] - before != want_launches:
                fail(f"ssm_scan {shape}: expected {want_launches} launches")
            check(f"edge {shape} vs plain", got, ss.ssm_scan_plain(x, y),
                  dname)
        x, y = _ssm_inputs(torch, (3, 257, 40), dt, gen)
        h0 = torch.randn((3, 40), device="cuda", generator=gen).to(dt)
        work = torch.float32 if dt == torch.bfloat16 else dt
        want = ref.ssm_scan_ref(x.to(work), y.to(work), h0.to(work)).to(dt)
        check("h0 (3, 257, 40) vs sequential ref", ops.ssm_scan(x, y, h0),
              want, dname)
        check("h0, 2-D (257, 40) vs sequential ref",
              ops.ssm_scan(x[0], y[0], h0[0]), want[0], dname)

    timing = {}
    n = a.numel()
    for dname, dt in _dtypes(torch).items():
        x, y = (a, b) if dt == torch.float32 else (a.to(dt), b.to(dt))
        ms = _time_ms(torch, ss.ssm_scan_cuda, [(x, y)], iters=20,
                      warmup=3)
        plain_ms = (_time_ms(torch, ss.ssm_scan_plain, [(x, y)], iters=3,
                             warmup=1) if dname == "float32" else None)
        op_dtype = "float32" if dname == "bfloat16" else dname
        b_ms, b_by = ssm_bound(n, dname, op_dtype)
        timing[dname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
        say(f"[time] ssm_scan {dname} {main_shape}: kernel {ms:.3f} ms, "
            + (f"plain {plain_ms:.3f} ms, " if plain_ms else "")
            + f"bound {b_ms:.3f} ms ({b_by}), kernel/bound {ms / b_ms:.2f}")
        del x, y
    torch.cuda.empty_cache()
    t = timing["float32"]
    return {"launches": launches, "path_s": path_s, "checks": checks,
            "timing": timing, "max_abs_err": max(
                c["max_abs_err"] for c in checks if c["dtype"] == "float32"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


def _qkv(torch, B, Hq, Hkv, Tq, Tk, Dh, dt, gen):
    kw = dict(device="cuda", generator=gen)
    return (torch.randn((B, Hq, Tq, Dh), **kw).to(dt),
            torch.randn((B, Hkv, Tk, Dh), **kw).to(dt),
            torch.randn((B, Hkv, Tk, Dh), **kw).to(dt))


def flash_bound(B, Hq, Hkv, Tq, Tk, Dh, causal, dname, window=0):
    """Least time of one attention call (`kernels.work.flash_work`): q,
    k, v read and o written once against 4 Dh operations per (query, key)
    pair the mask (a causal ``window`` too) lets through (a row that sees
    no key averages all Tk keys)."""
    from repro_torch.kernels.work import flash_work

    flops, n_bytes = flash_work(B, Hq, Hkv, Tq, Tk, Dh, causal,
                                ITEMSIZE[dname], window)
    return _bound(n_bytes, flops, dname)


def decode_bound(B, Hq, Hkv, L, Dh):
    """Least time of one bf16 decode call against ``L`` cached keys
    (`kernels.work.decode_work`)."""
    from repro_torch.kernels.work import decode_work

    flops, n_bytes = decode_work(B, Hq, Hkv, L, Dh, ITEMSIZE["bfloat16"])
    return _bound(n_bytes, flops, "bfloat16")


def _device_ms(torch, fn, args, iters):
    """Kernel time per call on the card: ``torch.profiler``'s device time
    of every kernel ``iters`` calls launch, over ``iters``; None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / iters / 1e3 if us > 0 else None


def _flash_mapped_edges(torch, fa, gen, check) -> list:
    """The split-K decode kernel under a head map (`FA_MAP_EDGES`): one
    launch each (asserted), the cache read in place, against the plain
    version (FA_TOL and the tight bf16 bound, the log-sum-exps at
    float32 TOL); the planted map must miss the tight bound."""
    out = []
    for what, hmap, planted in FA_MAP_EDGES:
        q = torch.randn((FA_MAP_B, len(hmap), 1, FA_DH), device="cuda",
                        generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((FA_MAP_B, 2, FA_MAP_S, FA_DH), device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        length = torch.tensor([FA_MAP_LEN], dtype=torch.int32,
                              device="cuda")
        ptrs = (k.data_ptr(), v.data_ptr())
        before = dict(fa.LAUNCHES)
        got, lse = fa.decode_attention_cuda(q, k, v, length, head_map=hmap,
                                            return_lse=True)
        moved = {n: fa.LAUNCHES[n] - before[n] for n in before}
        if moved != {n: int(n == "flash_attention_decode") for n in before}:
            fail(f"flash mapped decode {what}: launches {moved}, expected "
                 "one split-K decode launch")
        plain = functools.partial(fa.decode_attention_plain, head_map=hmap)
        check(f"mapped decode, {what} [decode] vs plain", got,
              plain(q, k, v, length), "bfloat16")
        want, tol = _tight_tol(plain, q, k, v, length)
        excess = _excess(got, want, tol).item()
        _, want_lse = fa.decode_attention_plain(
            q.float(), k.float(), v.float(), length, head_map=hmap,
            return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        bad = fa.decode_attention_cuda(q, k, v, length, head_map=planted)
        fault = _excess(bad, want, tol).item()
        in_place = (k.data_ptr(), v.data_ptr()) == ptrs
        say(f"[flash] mapped decode, {what}: map {hmap}, B={FA_MAP_B} "
            f"S={FA_MAP_S} length {FA_MAP_LEN}, bf16: tight max err/tol "
            f"{excess:.3f}, log-sum-exp max abs err {lse_err:.3e}; planted "
            f"map {planted}: err/tol {fault:.3f}")
        if not (excess <= 1.0 and lse_err <= 2e-4 * (
                1 + want_lse.abs().max().item()) and in_place):
            fail(f"flash mapped decode {what}: err/tol {excess:.3f}, "
                 f"log-sum-exp err {lse_err:.3e}")
        if not fault > 1.0:
            fail(f"flash mapped decode {what}: the planted map {planted} "
                 f"passes (err/tol {fault:.3f})")
        out.append({"what": what, "map": hmap, "max_err_over_tol": excess,
                    "lse_max_abs_err": lse_err,
                    "fault_err_over_tol": fault})
        del q, k, v, got, bad, want, tol
    return out


def phase_flash(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    pre = (FA_PREFILL_B, FA_HQ, FA_HKV, FA_PREFILL_T, FA_PREFILL_T, FA_DH)
    dec = (FA_DECODE_B, FA_HQ, FA_HKV, 1, FA_DECODE_TK, FA_DH)
    qp, kp, vp = _qkv(torch, *pre, bf16, gen)
    qd, kd, vd = _qkv(torch, *dec, bf16, gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    o_pre = ops.flash_attention(qp, kp, vp, causal=True)
    o_dec = ops.flash_attention(qd, kd, vd, causal=True)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = read_counts()
    by_kernel = {k: counts.pop(k) for k in fa.LAUNCHES}
    launches = sum(by_kernel.values())
    say(f"[flash] path: prefill B={pre[0]} T={pre[3]} + decode B={dec[0]} "
        f"Tk={dec[4]}, Hq={FA_HQ} Hkv={FA_HKV} Dh={FA_DH}, bf16, causal: "
        f"{path_s * 1e3:.2f} ms, kernel launches {by_kernel}")
    want = {"flash_attention_wgmma": 1, "flash_attention_decode": 1,
            "flash_attention": 0}
    if by_kernel != want:
        fail(f"the flash path launched {by_kernel}, expected {want}: the "
             "prefill on the wgmma kernel, the decode on the split-K kernel")
    if any(counts.values()):
        fail(f"the flash path launched other kernels: {counts}")

    checks = []

    def check(what, got, want, dname):
        err = _compare(torch, got, want, FA_TOL[dname], f"flash {what}")
        checks.append({"what": what, "dtype": dname, "max_abs_err": err})
        say(f"[flash] {what} {dname}: ok, max abs err {err:.3e}")

    check("prefill (wgmma) vs plain", o_pre,
          fa.flash_attention_plain(qp, kp, vp), "bfloat16")
    check("decode (split-K) vs plain", o_dec,
          fa.flash_attention_plain(qd, kd, vd), "bfloat16")
    sdpa_diff = (o_pre.float() - F.scaled_dot_product_attention(
        qp, kp, vp, is_causal=True, enable_gqa=True).float()).abs().max()
    say(f"[flash] prefill bf16: max |kernel - sdpa| {sdpa_diff.item():.3e} "
        "(information only)")
    del o_pre, o_dec
    qf, kf, vf = qp.float(), kp.float(), vp.float()
    check("prefill (fma) vs plain", ops.flash_attention(qf, kf, vf),
          fa.flash_attention_plain(qf, kf, vf), "float32")
    qdf, kdf, vdf = qd.float(), kd.float(), vd.float()
    check("decode (split-K) vs plain", ops.flash_attention(qdf, kdf, vdf),
          fa.flash_attention_plain(qdf, kdf, vdf), "float32")
    del qf, kf, vf, qdf, kdf, vdf
    torch.cuda.empty_cache()

    # Tight bf16 check: peaked rows, O(1) outputs, against the plain
    # version in f32 on the same bf16 values.
    tight = []
    for name, (q, k, v) in (("prefill", (qp, kp, vp)),
                            ("decode", (qd, kd, vd))):
        qs = (q.float() * FA_PEAK).to(bf16)
        got = ops.flash_attention(qs, k, v).float()
        want, tol = _tight_tol(fa.flash_attention_plain, qs, k, v)
        excess = _excess(got, want, tol).item()
        err = (got - want).abs().max().item()
        typical = want.abs().median().item()
        say(f"[flash] tight bf16 {name} (q x {FA_PEAK:g}): max abs err "
            f"{err:.3e}, median |o| {typical:.3f}, max err/tol {excess:.3f}")
        if not excess <= 1.0 or not bool(torch.isfinite(got).all()):
            fail(f"flash tight bf16 {name}: error {err:.3e} exceeds 2^-8 "
                 f"(sum p|v|/l + |o|) + {FA_BF16_ABS:g} (ratio {excess:.3f})")
        tight.append({"what": name, "max_abs_err": err, "median_abs_out":
                      typical, "max_err_over_tol": excess})
        del qs, got, want, tol
    torch.cuda.empty_cache()
    mapped = _flash_mapped_edges(torch, fa, gen, check)

    edge_kernels = {}
    for B, Hq, Hkv, Tq, Tk, Dh, causal, what in FA_EDGES:
        for dname, dt in (("float32", f32), ("bfloat16", bf16)):
            q, k, v = _qkv(torch, B, Hq, Hkv, Tq, Tk, Dh, dt, gen)
            kernel = fa.select_kernel(q, k)
            counter = fa.KERNEL_COUNTERS[kernel]
            before = dict(fa.LAUNCHES)
            got = ops.flash_attention(q, k, v, causal=causal)
            moved = {n: fa.LAUNCHES[n] - before[n] for n in before}
            if moved != {n: int(n == counter) for n in before}:
                fail(f"flash {what} {dname}: launches {moved}, expected one "
                     f"of {counter}")
            edge_kernels[kernel] = edge_kernels.get(kernel, 0) + 1
            check(f"{what} [{kernel}] vs plain", got,
                  fa.flash_attention_plain(q, k, v, causal=causal), dname)
            check(f"{what} [{kernel}] vs attention_ref", got,
                  ops.attention_ref(q, k, v, causal=causal), dname)
    if set(edge_kernels) != set(fa.KERNEL_COUNTERS):
        fail(f"the edges reached only {edge_kernels}")

    def sdpa(causal):
        return lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    def kernel(name):
        return lambda q, k, v: fa.flash_attention_cuda(q, k, v, kernel=name)

    timing = {}
    qf, kf, vf = qp.float(), kp.float(), vp.float()
    qdf, kdf, vdf = qd.float(), kd.float(), vd.float()
    cases = [("prefill", "bfloat16", (qp, kp, vp), pre, True, (20, 2, 20)),
             ("prefill", "float32", (qf, kf, vf), pre, True, (3, 2, 5)),
             ("decode", "bfloat16", (qd, kd, vd), dec, False, (100, 10, 100)),
             ("decode", "float32", (qdf, kdf, vdf), dec, False,
              (100, 10, 100))]
    for name, dname, qkv, shape, sdpa_causal, (ik, ip, il) in cases:
        chosen = fa.select_kernel(qkv[0], qkv[1])
        ms = _time_ms(torch, kernel(chosen), [qkv], iters=ik, warmup=2)
        dev_ms = _device_ms(torch, kernel(chosen), qkv, 10)
        # The FMA kernel (PR 12's, unchanged) on the same inputs.
        fma_ms = ms if chosen == "fma" else _time_ms(
            torch, kernel("fma"), [qkv], iters=3 if name == "prefill" else 10,
            warmup=1)
        plain_ms = _time_ms(torch, fa.flash_attention_plain, [qkv],
                            iters=ip, warmup=1)
        lib_ms = _time_ms(torch, sdpa(sdpa_causal), [qkv], iters=il,
                          warmup=2)
        lib_dev_ms = _device_ms(torch, sdpa(sdpa_causal), qkv, 10)
        b_ms, b_by = flash_bound(*shape, True, dname)
        timing[f"{name}/{dname}"] = {
            "kernel": chosen, "ms": ms, "device_ms": dev_ms,
            "fma_ms": fma_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": b_ms,
            "bound_by": b_by}
        dev = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
        say(f"[time] flash {name} {dname} {shape}: {chosen} kernel "
            f"{ms:.4f} ms (device {dev(dev_ms)}), fma kernel {fma_ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms (device "
            f"{dev(lib_dev_ms)}), bound {b_ms:.4f} ms ({b_by}), "
            f"kernel/bound {ms / b_ms:.2f}, kernel/sdpa {ms / lib_ms:.2f}")
    del qf, kf, vf, qdf, kdf, vdf
    torch.cuda.empty_cache()

    # Which kernel should take bf16 decode-like calls: rows per kv head.
    crossover = []
    for tq in (1, 2, 3, 4, 5):
        q, k, v = _qkv(torch, FA_DECODE_B, FA_HQ, FA_HKV, tq, FA_DECODE_TK,
                       FA_DH, bf16, gen)
        row = {"rows": FA_HQ // FA_HKV * tq, "chosen": fa.select_kernel(q, k)}
        for name in ("decode", "wgmma"):
            row[name] = _time_ms(torch, kernel(name), [(q, k, v)], iters=50,
                                 warmup=2)
        crossover.append(row)
        say(f"[time] flash bf16 B={FA_DECODE_B} Tk={FA_DECODE_TK}, "
            f"{row['rows']} rows per kv head: decode {row['decode']:.4f} ms, "
            f"wgmma {row['wgmma']:.4f} ms; dispatch takes {row['chosen']}")
    smem = {"wgmma Dh=128": fa.smem_bytes("wgmma", bf16, FA_DH),
            "decode bf16 Dh=128, 3 rows, 512 keys": fa.smem_bytes(
                "decode", bf16, FA_DH, 3, 512),
            "fma Dh=128": fa.smem_bytes("fma", f32, FA_DH)}
    say(f"[flash] dynamic shared memory per CTA (bytes): {smem}")
    torch.cuda.empty_cache()
    t = timing["prefill/bfloat16"]
    return {"launches": launches, "launches_by_kernel": by_kernel,
            "path_s": path_s, "checks": checks, "tight_bf16": tight,
            "edge_kernels": edge_kernels, "mapped_edges": mapped,
            "sdpa_prefill_bf16_max_abs_diff": sdpa_diff.item(),
            "timing": timing, "crossover": crossover, "smem_bytes": smem,
            "max_abs_err": max(
                c["max_abs_err"] for c in checks if c["dtype"] == "bfloat16"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


# ---------------------------------------------------------------------------
# LM decode service
# ---------------------------------------------------------------------------

#: qwen2-1.5b (src/repro_torch/configs/qwen2_1p5b.py) at full width: the
#: architecture the reference CLI's docstring serves. A 128-token prompt
#: and 128 greedy steps in caches of 512 (256 and 256 before, cut to
#: keep the script in its time on a slow host).
LM_ARCH, LM_SEED = "qwen2-1.5b", 0
LM_B, LM_PROMPT, LM_GEN, LM_MAX = 64, 128, 128, 512
#: Teacher-forced steps whose decode-kernel calls are held to plain (64
#: before, cut to keep the script in its time).
LM_GATE_STEPS = 32
LM_PROFILE_STEPS = 32
#: The yardstick of the bf16 gates is the same model computed in float32
#: (the bf16 weights widened, the plain attention): the bf16 noise at this
#: width is the plain bf16 path's largest logit error against it. (In
#: this phase's runs, NVIDIA H100 80GB HBM3, 700 W, that noise was 0.164,
#: 3.5 % of the largest logit, and the plain bf16 path's top-1 agreed
#: with float32's at 92 % of the positions: a bound of 3e-2 of the
#: largest logit with 99 % raw top-1 agreement holds for no bf16 path
#: here.) The kernel path's error against float32 may be at most
#: `LM_NOISE_FACTOR` times the plain path's: the two bf16 runs round at
#: the same places but inside attention (0.170 against 0.164 in those
#: runs).
LM_NOISE_FACTOR = 1.5
#: Top-1: where the float32 top-1 leads its runner-up by more than twice
#: the noise (no bf16 noise of that size can flip it), the kernel path's
#: choice must equal float32's on this share of the positions; and where
#: the kernel and plain paths choose differently, the two choices must
#: lie within twice the noise of each other (a near tie).
LM_TOP1 = 0.99


def _plain_attention_calls() -> dict:
    from repro_torch.models import attention

    return dict(attention.PLAIN_CALLS)


def _reset_plain_attention_calls() -> None:
    from repro_torch.models import attention

    attention.reset_plain_calls()


class _Logits:
    """Running comparison of one run's logits ``[B, 1, V]`` with
    another's, step by step (kept on the card, read once at the end)."""

    def __init__(self, torch, vocab):
        self.torch, self.vocab = torch, vocab
        self.err, self.peak, self.match, self.gap, self.margin = \
            [], [], [], [], []

    def add(self, got, want):
        torch = self.torch
        g = got[:, 0, :self.vocab].float()
        w = want[:, 0, :self.vocab].float()
        self.err.append((g - w).abs().amax())
        self.peak.append(w.abs().amax())
        ig, iw = g.argmax(-1), w.argmax(-1)
        self.match.append(ig == iw)
        # How far each run's choice falls below the other run's best.
        self.gap.append(torch.maximum(
            w.amax(-1) - w.gather(-1, ig[:, None])[:, 0],
            g.amax(-1) - g.gather(-1, iw[:, None])[:, 0]))
        top2 = w.topk(2, dim=-1).values
        self.margin.append(top2[:, 0] - top2[:, 1])

    def result(self, noise=None) -> dict:
        torch = self.torch
        err, peak = torch.stack(self.err), torch.stack(self.peak)
        match = torch.cat(self.match)
        gap, margin = torch.cat(self.gap), torch.cat(self.margin)
        res = {"max_abs_err": err.max().item(),
               "max_abs_logit": peak.max().item(),
               "max_err_over_peak": (err / peak).max().item(),
               "top1_match": match.float().mean().item(),
               "max_mismatch_gap": gap[~match].max().item()
               if bool((~match).any()) else 0.0,
               "positions": match.numel()}
        if noise is not None:
            decisive = margin > 2 * noise
            res["decisive_share"] = decisive.float().mean().item()
            res["decisive_top1_match"] = (
                match[decisive].float().mean().item()
                if bool(decisive.any()) else 1.0)
        return res


def _say_logits(what, res, tag="lm_decode") -> None:
    extra = (f"; top-1 equal at {res['decisive_top1_match']:.4f} of the "
             f"{res['decisive_share']:.3f} decisive positions"
             if "decisive_share" in res else "")
    say(f"[{tag}] {what}: max |dlogit| {res['max_abs_err']:.4e} (max "
        f"|logit| {res['max_abs_logit']:.4f}, ratio "
        f"{res['max_err_over_peak']:.4e}), top-1 equal at "
        f"{res['top1_match']:.4f} of {res['positions']} positions, largest "
        f"mismatch gap {res['max_mismatch_gap']:.4e}{extra}")


def _check_noise(what, res, noise, tag="lm_decode") -> None:
    """``res``: a bf16 run of the kernels against the float32 reference."""
    _say_logits(f"{what} vs float32", res, tag)
    if not res["max_abs_err"] <= LM_NOISE_FACTOR * noise:
        fail(f"{tag} {what}: max |dlogit| {res['max_abs_err']:.4e} "
             f"against float32, over {LM_NOISE_FACTOR:g} x the plain bf16 "
             f"path's {noise:.4e}")
    if not res["decisive_top1_match"] >= LM_TOP1:
        fail(f"{tag} {what}: top-1 equal to float32's at "
             f"{res['decisive_top1_match']:.4f} of the decisive positions, "
             f"under {LM_TOP1}")


def _check_ties(what, res, noise, tag="lm_decode") -> None:
    """``res``: two bf16 runs against each other."""
    _say_logits(what, res, tag)
    if not res["max_mismatch_gap"] <= 2 * noise:
        fail(f"{tag} {what}: a top-1 mismatch is no near tie (gap "
             f"{res['max_mismatch_gap']:.4e} over twice the noise "
             f"{noise:.4e})")


class _DecodeTap:
    """Stands in for `decode_attention_cuda` while the model runs. Each
    call launches the kernel as the model's call would and holds its
    output against the plain version in float32 on the same q and the
    same layer cache (each layer on its own, so no error carries over
    from the layers before) at the tight bf16 bound; then it launches the
    kernel once more with one key too few (a planted fault: the first
    ``min(length, S) - 1`` rows, so a full ring is read one row short)
    and records how far that misses the same bound. ``length`` is the
    cache length of the step under way (the kernel reads its own copy on
    the card)."""

    def __init__(self, fa):
        self.fa, self.kernel = fa, fa.decode_attention_cuda
        self.length, self.fault_launches = 0, 0
        self.ok, self.fault, self.softcaps = {}, {}, set()

    def __enter__(self):
        self.fa.decode_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.fa.decode_attention_cuda = self.kernel

    def __call__(self, q, k_cache, v_cache, length, **kw):
        self.softcaps.add(kw.get("softcap", 0.0))
        out = self.kernel(q, k_cache, v_cache, length, **kw)
        want, tol = _tight_tol(functools.partial(
            self.fa.decode_attention_plain, **kw), q, k_cache, v_cache,
            length)
        bad = self.kernel(q, k_cache, v_cache,
                          length.clamp(max=k_cache.shape[2]) - 1, **kw)
        self.fault_launches += 1
        self.ok.setdefault(self.length, []).append(_excess(out, want, tol))
        self.fault.setdefault(self.length, []).append(
            _excess(bad, want, tol))
        return out

    def result(self, torch) -> dict:
        """Per cache length, the largest error over the bound across the
        layers: the kernel's must be at most 1, the fault's over 1."""
        lengths = sorted(self.ok)
        ok = torch.stack([torch.stack(self.ok[n]).amax()
                          for n in lengths]).tolist()
        fault = torch.stack([torch.stack(self.fault[n]).amax()
                             for n in lengths]).tolist()
        return {"lengths": [lengths[0], lengths[-1]],
                "calls": sum(len(c) for c in self.ok.values()),
                "max_err_over_tol": max(ok),
                "length_of_max": lengths[ok.index(max(ok))],
                "fault_min_err_over_tol": min(fault),
                "length_of_fault_min": lengths[fault.index(min(fault))],
                "fault_caught_at": sum(f > 1.0 for f in fault),
                "n_lengths": len(lengths), "softcaps": sorted(self.softcaps)}


def _lm_kernel_time(torch, kernel, plain, library, sets, bound,
                    plain_iters) -> dict:
    """A kernel at an LM shape: event time of back-to-back wrapper calls
    (``ms``; the host's dispatch can set it) and CUDA-graph device time
    (``graph_ms``, the kernel alone); the plain version's event time; the
    library call's event and graph times (None where ``library`` is:
    no PyTorch call computes the function). (At these shapes the
    profiler's sum of kernel times undercounts, on an NVIDIA H100 80GB
    HBM3 at 700 W below the prefill's own bound: PERF.md §6.)"""
    b_ms, b_by = bound
    return {"ms": _time_ms(torch, kernel, sets, iters=200),
            "graph_ms": _graph_ms(torch, kernel, sets),
            "plain_ms": _time_ms(torch, plain, sets, iters=plain_iters,
                                 warmup=1),
            "library_ms": None if library is None else _time_ms(
                torch, library, sets, iters=200),
            "library_graph_ms": None if library is None else _graph_ms(
                torch, library, sets),
            "bound_ms": b_ms, "bound_by": b_by}


def _say_lm_time(what, t, library="sdpa") -> None:
    lib = ("" if t["library_ms"] is None else
           f"{library} {t['library_graph_ms'] * 1e3:.2f} us device "
           f"({t['library_ms'] * 1e3:.2f} us calls), ")
    ratio = ("" if t["library_ms"] is None else
             f", kernel/sdpa {t['graph_ms'] / t['library_graph_ms']:.2f}")
    say(f"[time] {what} {t['graph_ms'] * 1e3:.2f} us device (CUDA graph; "
        f"{t['ms'] * 1e3:.2f} us back-to-back calls), "
        f"plain {t['plain_ms'] * 1e3:.2f} us, {lib}bound "
        f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); device "
        f"kernel/bound {t['graph_ms'] / t['bound_ms']:.2f}{ratio}; vs plain "
        f"max abs err {t['max_abs_err']:.3e}, err/tol "
        f"{t['max_err_over_tol']:.3f}")


def _lm_profile(torch, step, steps, name, named=None) -> dict:
    """Device busy, idle share, launches and top kernels over ``steps``
    calls of ``step`` (one decode step each), traced with
    ``torch.profiler``; the tables go to ``chiprun_out/profile_<name>``.
    ``named``: label -> (operator, its first input's shape); each label's
    device time (the kernels the operator launched, summed over the
    calls with that shape) is reported under ``named_ms``; the trace then
    records shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=named is not None) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(steps):
            step(j)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = _device_events(ka)
    busy_us = sum(e.self_device_time_total for e in kernels)
    dec_us = sum(e.self_device_time_total for e in kernels
                 if "decode_kernel" in e.key or "merge_kernel" in e.key)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_{name}.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=40) + "\n"
        + ka.table(sort_by="cpu_time_total", row_limit=40))
    launches = sum(e.count for e in kernels)
    named_ms = {}
    if named:
        by_shape = prof.key_averages(group_by_input_shape=True)
        for label, (op, shape) in named.items():
            hits = [e for e in by_shape if e.key == op and e.input_shapes
                    and list(e.input_shapes[0]) == list(shape)]
            named_ms[label] = {
                "ms": sum(getattr(e, "device_time_total", 0)
                          for e in hits) / 1e3,
                "calls": sum(e.count for e in hits)}
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "named_ms": named_ms,
            "busy_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "kernel_launches": launches,
            "launches_per_step": launches / steps,
            "decode_kernel_ms": dec_us / 1e3,
            "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def _say_profile(tag, what, p) -> None:
    say(f"[{tag}] profile of {p['steps']} decode steps ({what}): wall "
        f"{p['wall_s'] * 1e3:.1f} ms (profiled), device busy "
        f"{p['device_busy_s'] * 1e3:.2f} ms ({p['busy_ms_per_step']:.3f} ms "
        f"per step) in {p['kernel_launches']} kernel launches "
        f"({p['launches_per_step']:.1f} per step), idle "
        f"{p['idle_share']:.1%}; decode+merge kernels "
        f"{p['decode_kernel_ms']:.3f} ms; top: " + "; ".join(
            f"{k[:48]} {ms:.2f} ms x{n}" for k, ms, n in p["top"])
        + "".join(f"; {label}: {v['ms']:.2f} ms in {v['calls']} calls"
                  for label, v in p.get("named_ms", {}).items()))


def _check_layer_taps(tag, what, res) -> None:
    if not res["max_err_over_tol"] <= 1.0:
        fail(f"{tag} {what}: the decode kernel misses the tight bf16 bound "
             f"against plain on its own inputs (err/tol "
             f"{res['max_err_over_tol']:.3f} at length "
             f"{res['length_of_max']})")
    if res["fault_caught_at"] != res["n_lengths"]:
        fail(f"{tag} {what}: the tight bound does not catch a kernel that "
             f"drops the last key at every length (caught at "
             f"{res['fault_caught_at']} of {res['n_lengths']})")


def _say_layer_taps(tag, what, res, layers) -> None:
    say(f"[{tag}] {what}: every decode-kernel call ({res['calls']} = "
        f"{layers} layers x {res['n_lengths']} cache lengths "
        f"{res['lengths'][0]}..{res['lengths'][1]}, softcaps "
        f"{res['softcaps']}) vs plain in float32 on the same q and layer "
        f"cache: max err/tol {res['max_err_over_tol']:.3f} (at length "
        f"{res['length_of_max']}); planted fault (length - 1) exceeds it at "
        f"{res['fault_caught_at']} of {res['n_lengths']} lengths, least "
        f"err/tol {res['fault_min_err_over_tol']:.3f} (at length "
        f"{res['length_of_fault_min']})")


def _decode_time(torch, fa, B, Hq, Hkv, L, Dh, gen, softcap=0.0) -> dict:
    """The decode kernel on full caches of ``L`` rows (four of them, so
    each call reads HBM) against the plain version (with ``softcap``) and
    SDPA (which has no softcap)."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    full = torch.tensor(L, dtype=torch.int32, device="cuda")
    sets = [_qkv(torch, B, Hq, Hkv, 1, L, Dh, bf16, gen) + (full,)
            for _ in range(4)]
    q, k, v, _ = sets[0]
    kernel = functools.partial(fa.decode_attention_cuda, softcap=softcap)
    plain = functools.partial(fa.decode_attention_plain, softcap=softcap)
    got = kernel(q, k, v, full)
    err = _compare(torch, got, plain(q, k, v, full), FA_TOL["bfloat16"],
                   f"decode kernel B={B} Hq={Hq} Hkv={Hkv} L={L}")
    tight = _excess(got, *_tight_tol(plain, q, k, v, full)).item()
    if not tight <= 1.0:
        fail(f"decode kernel B={B} Hq={Hq} Hkv={Hkv} L={L}: err/tol "
             f"{tight:.3f} over the tight bf16 bound")
    sdpa = lambda q, k, v, n: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, enable_gqa=True)
    t = _lm_kernel_time(
        torch, kernel, plain, sdpa, sets,
        decode_bound(B, Hq, Hkv, L, Dh), 20)
    t.update(max_abs_err=err, max_err_over_tol=tight)
    del q, k, v, got, sets
    torch.cuda.empty_cache()
    return t


def _mapped_decode_time(torch, fa, B, hmap, Hkv, L, Dh, gen,
                        lse=False) -> dict:
    """The split-K decode kernel as a tensor-parallel rank calls it: q
    head ``i`` against kv head ``hmap[i]`` of full caches of ``L`` rows
    (the map passed unless it is the kernel's own grouped map), with the
    log-sum-exps where ``lse``; against the plain version, and SDPA on the
    k/v expanded by the map (one kv head per q head, built before the
    timing). The byte bound reads the kv heads the map reaches."""
    import torch.nn.functional as F

    Hq, bf16 = len(hmap), torch.bfloat16
    grouped = Hq % Hkv == 0 and tuple(hmap) == tuple(
        j // (Hq // Hkv) for j in range(Hq))
    hm = None if grouped else tuple(hmap)
    full = torch.tensor(L, dtype=torch.int32, device="cuda")
    sets = [_qkv(torch, B, Hq, Hkv, 1, L, Dh, bf16, gen) + (full,)
            for _ in range(4)]
    idx = torch.tensor(hmap, device="cuda")
    expanded = [(q, k.index_select(1, idx), v.index_select(1, idx))
                for q, k, v, _ in sets]
    kernel = functools.partial(fa.decode_attention_cuda, head_map=hm,
                               return_lse=lse)
    plain = functools.partial(fa.decode_attention_plain, head_map=hm)
    q, k, v, _ = sets[0]
    got = kernel(q, k, v, full)
    out = got[0] if lse else got
    what = (f"mapped decode B={B} map {tuple(hmap)} L={L}"
            + (" with log-sum-exps" if lse else ""))
    err = _compare(torch, out, plain(q, k, v, full), FA_TOL["bfloat16"],
                   what)
    tight = _excess(out, *_tight_tol(plain, q, k, v, full)).item()
    if not tight <= 1.0:
        fail(f"{what}: err/tol {tight:.3f} over the tight bf16 bound")
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v)
    b_ms, b_by = decode_bound(B, Hq, len(set(hmap)), L, Dh)
    t = {"ms": _time_ms(torch, kernel, sets, iters=200),
         "graph_ms": _graph_ms(torch, kernel, sets),
         "plain_ms": _time_ms(torch, functools.partial(
             plain, return_lse=lse), sets, iters=20, warmup=1),
         "library_ms": _time_ms(torch, sdpa, expanded, iters=200),
         "library_graph_ms": _graph_ms(torch, sdpa, expanded),
         "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
         "max_err_over_tol": tight, "map": list(hmap), "lse": lse}
    del q, k, v, got, sets, expanded
    torch.cuda.empty_cache()
    return t


def _prefill_time(torch, fa, B, Hq, Hkv, T, Dh, gen, softcap=0.0,
                  causal=True, Tk=None) -> dict:
    """`flash_attention_cuda` (the kernel `select_kernel` picks) on ``q
    [B, Hq, T, Dh]`` and ``k/v [B, Hkv, Tk, Dh]`` (``Tk`` = ``T`` unless
    given), causal unless told otherwise, against the plain version (with
    ``softcap``) and SDPA with the same mask (no softcap)."""
    import torch.nn.functional as F

    Tk = T if Tk is None else Tk
    what = (f"{'causal' if causal else 'non-causal'} attention B={B} "
            f"Hq={Hq} Hkv={Hkv} T={T} Tk={Tk}")
    sets = [_qkv(torch, B, Hq, Hkv, T, Tk, Dh, torch.bfloat16, gen)
            for _ in range(2)]
    q, k, v = sets[0]
    kernel = functools.partial(fa.flash_attention_cuda, causal=causal,
                               softcap=softcap)
    plain = functools.partial(fa.flash_attention_plain, causal=causal,
                              softcap=softcap)
    got = kernel(q, k, v)
    err = _compare(torch, got, plain(q, k, v), FA_TOL["bfloat16"],
                   f"{what} kernel")
    tight = _excess(got, *_tight_tol(plain, q, k, v)).item()
    if not tight <= 1.0:
        fail(f"{what} kernel: err/tol {tight:.3f} over the tight bf16 bound")
    t = _lm_kernel_time(
        torch, kernel, plain, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), sets,
        flash_bound(B, Hq, Hkv, T, Tk, Dh, causal, "bfloat16"), 3)
    t.update(max_abs_err=err, max_err_over_tol=tight,
             kernel=fa.select_kernel(q, k))
    del q, k, v, got, sets
    torch.cuda.empty_cache()
    return t


def phase_lm_decode(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models import (decode_step, init_caches, init_model,
                                    prefill)

    cfg = get_config(LM_ARCH)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    serve_cfg = ServeConfig(arch=LM_ARCH, batch=LM_B, prompt_len=LM_PROMPT,
                            gen=LM_GEN, max_len=LM_MAX, reduced=False,
                            seed=LM_SEED)
    t0 = time.perf_counter()
    model = init_model(cfg, LM_SEED, device="cuda")
    # The service's prompts: the same generator and draw as `serve`.
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, vocab, (LM_B, LM_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[lm_decode] {LM_ARCH} full width: {layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads} (padded {cfg.padded_heads}) "
        f"/ kv {cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, vocab "
        f"{vocab} (padded {cfg.padded_vocab}), {n_params:,} parameters in "
        f"bf16, init {time.perf_counter() - t0:.2f}s")

    # The float32 reference: the same weights widened, plain attention.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = copy.deepcopy(model).float()

    # Gate 1: the first steps with the kernel, with the plain version and
    # in float32; every kernel call of this and the next loop is held
    # against the plain version on its own inputs (`_DecodeTap`).
    tap = _DecodeTap(fa)
    kernel_caches = init_caches(cfg, LM_B, LM_MAX, device="cuda")
    plain_caches = init_caches(cfg, LM_B, LM_MAX, device="cuda")
    ref_caches = init_caches(cfg32, LM_B, LM_MAX, device="cuda")
    k_vs_p, k_vs_ref, p_vs_ref = (_Logits(torch, vocab) for _ in range(3))
    reset_counts()
    _reset_plain_attention_calls()
    for i in range(LM_GATE_STEPS):
        tok = prompts[:, i:i + 1]
        tap.length = i + 1
        with tap:
            lk, kernel_caches = decode_step(model, cfg, kernel_caches, tok,
                                            i)
        lp, plain_caches = decode_step(model, cfg, plain_caches, tok, i,
                                       impl="plain")
        lr, ref_caches = decode_step(model32, cfg32, ref_caches, tok, i,
                                     impl="plain")
        k_vs_p.add(lk, lp)
        k_vs_ref.add(lk, lr)
        p_vs_ref.add(lp, lr)
    torch.cuda.synchronize()
    counts, plain_calls = read_counts(), _plain_attention_calls()
    # Each model call launches the kernel twice: its own launch and the
    # planted fault's.
    if (counts["flash_attention_decode"] != 2 * layers * LM_GATE_STEPS
            or plain_calls["decode_attention"] != 2 * layers * LM_GATE_STEPS):
        fail(f"lm_decode gate run: kernel launches {counts}, plain calls "
             f"{plain_calls}; expected {2 * layers * LM_GATE_STEPS} kernel "
             "launches (half of them the planted fault's) and as many "
             "plain calls")
    p_vs_ref = p_vs_ref.result()
    noise = p_vs_ref["max_abs_err"]
    what = f"first {LM_GATE_STEPS} teacher-forced steps"
    _say_logits(f"{what}, plain bf16 vs float32 (the noise)", p_vs_ref)
    kernel_vs_ref = k_vs_ref.result(noise)
    _check_noise(f"{what}, kernel bf16", kernel_vs_ref, noise)
    kernel_vs_plain = k_vs_p.result()
    _check_ties(f"{what}, kernel vs plain bf16", kernel_vs_plain, noise)
    del plain_caches, ref_caches

    # Gate 2: prefill (the wgmma kernel) against the teacher-forced decode
    # at the last prompt position, both against float32's prefill (the
    # same function: float32 decode and prefill agree to ~1e-5).
    with tap:
        for i in range(LM_GATE_STEPS, LM_PROMPT):
            tap.length = i + 1
            lk, kernel_caches = decode_step(model, cfg, kernel_caches,
                                            prompts[:, i:i + 1], i)
    layer_check = tap.result(torch)
    _say_layer_taps("lm_decode", f"the {LM_PROMPT} prompt steps",
                    layer_check, layers)
    _check_layer_taps("lm_decode", LM_ARCH, layer_check)
    reset_counts()
    _reset_plain_attention_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lpre = prefill(model, cfg, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts, plain_calls = read_counts(), _plain_attention_calls()
    prefill_launches = {k: v for k, v in counts.items() if v}
    if prefill_launches != {"flash_attention_wgmma": layers} or any(
            plain_calls.values()):
        fail(f"lm_decode prefill launched {prefill_launches}, plain calls "
             f"{plain_calls}; expected the wgmma kernel once per layer")
    say(f"[lm_decode] prefill B={LM_B} T={LM_PROMPT}: {prefill_s:.3f}s, "
        f"kernel launches {prefill_launches}")
    lpre_plain = prefill(model, cfg, prompts, impl="plain")
    lpre_ref = prefill(model32, cfg32, prompts, impl="plain")
    del model32
    torch.cuda.empty_cache()
    results = {}
    for name, got in (("plain prefill", lpre_plain), ("prefill", lpre),
                      ("decode", lk)):
        acc = _Logits(torch, vocab)
        acc.add(got, lpre_ref)
        results[name] = acc
    noise255 = results.pop("plain prefill").result()["max_abs_err"]
    what = f"position {LM_PROMPT - 1}"
    say(f"[lm_decode] {what}: plain bf16 prefill vs float32 (the noise) "
        f"{noise255:.4e}")
    prefill_vs_ref = results["prefill"].result(noise255)
    _check_noise(f"{what}, prefill (wgmma) bf16", prefill_vs_ref, noise255)
    decode_vs_ref = results["decode"].result(noise255)
    _check_noise(f"{what}, decode (split-K) bf16", decode_vs_ref, noise255)
    acc = _Logits(torch, vocab)
    acc.add(lpre, lk)
    prefill_vs_decode = acc.result()
    _check_ties(f"{what}, prefill vs decode bf16", prefill_vs_decode,
                noise255)

    # Device busy over decode steps at cache lengths 256..287.
    state = {"caches": kernel_caches, "tok": lk[:, :, :vocab].argmax(-1)}

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], LM_PROMPT + j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    profile_res = _lm_profile(torch, step, LM_PROFILE_STEPS, "lm_decode")
    _say_profile("lm_decode", f"cache {LM_PROMPT}.."
                 f"{LM_PROMPT + LM_PROFILE_STEPS - 1}", profile_res)
    del kernel_caches, state, lk, lp, lr, lpre, lpre_plain, lpre_ref, model
    torch.cuda.empty_cache()

    # The service, timed, with the counters zeroed before and read after.
    torch.cuda.synchronize()
    reset_counts()
    _reset_plain_attention_calls()
    out = serve(serve_cfg, emit=say)
    torch.cuda.synchronize()
    counts, plain_calls = read_counts(), _plain_attention_calls()
    steps = LM_PROMPT + LM_GEN
    decode_launches = counts.pop("flash_attention_decode")
    say(f"[lm_decode] path: serve({LM_ARCH}, batch {LM_B}, prompt "
        f"{LM_PROMPT}, gen {LM_GEN}, max_len {LM_MAX}, full width): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / steps * 1e3:.3f} "
        f"ms per step; decode kernel launches {decode_launches}, other "
        f"kernels {counts}, plain attention calls {plain_calls}")
    if decode_launches != layers * steps:
        fail(f"the lm_decode path launched the decode kernel "
             f"{decode_launches} times, expected {layers} x {steps}")
    if any(counts.values()) or any(plain_calls.values()):
        fail(f"the lm_decode path launched {counts}, plain calls "
             f"{plain_calls}: only the decode kernel may run")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_B, LM_GEN) or tokens.dtype != torch.int32
            or not bool(((tokens >= 0) & (tokens < vocab)).all())):
        fail(f"lm_decode tokens {tuple(tokens.shape)} {tokens.dtype} are "
             f"not [{LM_B}, {LM_GEN}] int32 ids below {vocab}")

    # Kernel times at the path's shapes.
    gen = torch.Generator(device="cuda").manual_seed(3)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    decode_time = _decode_time(torch, fa, LM_B, Hq, Hkv, LM_MAX, Dh, gen)
    _say_lm_time(f"lm decode attention B={LM_B} Hq={Hq} Hkv={Hkv} "
                 f"L={LM_MAX} Dh={Dh} bf16: split-K kernel", decode_time)
    prefill_time = _prefill_time(torch, fa, LM_B, Hq, Hkv, LM_PROMPT, Dh,
                                 gen)
    _say_lm_time(f"lm prefill attention B={LM_B} Hq={Hq} Hkv={Hkv} "
                 f"T={LM_PROMPT} Dh={Dh} bf16 causal: "
                 f"{prefill_time['kernel']} kernel", prefill_time)
    return {"arch": LM_ARCH, "parameters": n_params,
            "noise": noise, "plain_vs_ref": p_vs_ref,
            "kernel_vs_ref": kernel_vs_ref, "kernel_vs_plain": kernel_vs_plain,
            "noise_255": noise255, "prefill_vs_ref": prefill_vs_ref,
            "decode_vs_ref": decode_vs_ref, "layer_check": layer_check,
            "prefill_vs_decode": prefill_vs_decode, "prefill_s": prefill_s,
            "launches_by_path": {"lm_decode": decode_launches,
                                 "lm_prefill": prefill_launches[
                                     "flash_attention_wgmma"]},
            "tok_per_s": out["tok_per_s"], "seconds": out["seconds"],
            "ms_per_step": out["seconds"] / steps * 1e3,
            "profile": profile_res, "decode_attention": decode_time,
            "prefill_attention": prefill_time}


# ---------------------------------------------------------------------------
# LM hybrid family
# ---------------------------------------------------------------------------

#: hymba-1.5b (src/repro_torch/configs/hymba_1p5b.py) at full width and
#: depth 8 of its 32 layers (cut to keep the script in its time):
#: attention and a Mamba SSM in every block, a 1,024-row sliding window
#: except in the first, middle and last layers (0, 4 and 7 of the 8, as 0,
#: 16 and 31 of the 32). Prompts of 1,024 tokens and 64 greedy steps: the
#: windowed layers' rings (1,024 rows) wrap at step 1,024, and every
#: greedy step reads a full ring.
HY_ARCH, HY_SEED, HY_LAYERS = "hymba-1.5b", 0, 8
HY_B, HY_PROMPT, HY_GEN = 64, 1024, 64
HY_MAX = HY_PROMPT + HY_GEN
#: The prefill gate: the first sequences' prompt and generated tokens.
HY_PREFILL_B = 8
HY_PROFILE_STEPS = 32
#: The decode-kernel taps: the steps after the service's last, on the
#: service's own caches (rings wrapped, the global layers' caches full).
HY_TAP_STEPS = 32


class _PrefillTaps:
    """Stand in for `flash_attention_cuda` and `ssm_scan_cuda` while a
    prefill runs. Each attention call launches the kernel as the model's
    call would and is held against `flash_attention_plain` (with the
    call's window) in float32 on the same q, k, v at the tight bf16
    bound; a windowed call launches once more with the window one key
    wider (a planted fault), which must miss that bound. Each scan is
    held against `ssm_scan_plain` on the same ``a, b`` at the float32
    TOL (error over the allclose tolerance)."""

    def __init__(self, fa, ss):
        self.fa, self.ss = fa, ss
        self.attn, self.scan = fa.flash_attention_cuda, ss.ssm_scan_cuda
        self.windows, self.ok, self.fault, self.scan_excess = [], [], [], []
        self.softcaps = set()

    def __enter__(self):
        self.fa.flash_attention_cuda = self.attention
        self.ss.ssm_scan_cuda = self.ssm_scan
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda = self.attn
        self.ss.ssm_scan_cuda = self.scan

    def attention(self, q, k, v, *, causal=True, window=0, softcap=0.0,
                  **kw):
        out = self.attn(q, k, v, causal=causal, window=window,
                        softcap=softcap, **kw)
        want, tol = _tight_tol(functools.partial(
            self.fa.flash_attention_plain, causal=causal, window=window,
            softcap=softcap), q, k, v)
        self.windows.append(window)
        self.softcaps.add(softcap)
        self.ok.append(_excess(out, want, tol))
        if window:
            bad = self.attn(q, k, v, causal=causal, window=window + 1,
                            softcap=softcap, **kw)
            self.fault.append(_excess(bad, want, tol))
        return out

    def ssm_scan(self, a, b):
        h = self.scan(a, b)
        want = self.ss.ssm_scan_plain(a, b)
        t = SSM_TOL["float32"]
        self.scan_excess.append(((h - want).abs() / (
            t["atol"] + t["rtol"] * want.abs())).amax())
        return h

    def result(self, torch) -> dict:
        ok = torch.stack(self.ok).tolist()
        fault = torch.stack(self.fault).tolist() if self.fault else []
        scans = (torch.stack(self.scan_excess).tolist()
                 if self.scan_excess else [0.0])
        return {"attention_calls": len(ok), "windows": sorted(
                    set(self.windows)), "softcaps": sorted(self.softcaps),
                "max_err_over_tol": max(ok),
                "fault_calls": len(fault),
                "fault_min_err_over_tol": min(fault) if fault else None,
                "fault_caught": sum(f > 1.0 for f in fault),
                "scans": len(self.scan_excess),
                "scan_max_err_over_tol": max(scans)}


def _window_mask(torch, T, window):
    """SDPA's boolean mask for a causal window (True: attend)."""
    i = torch.arange(T, device="cuda")
    d = i[:, None] - i[None, :]
    return (d >= 0) & (d < window)


def phase_lm_hybrid(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssm_scan import ssm_scan as ss
    import repro_torch.models as models_lib
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.attention import head_map as attention_head_map
    from repro_torch.models.blocks import layer_schedule

    tag = "lm_hybrid"
    full = get_config(HY_ARCH)
    cfg = dataclasses.replace(
        full, num_layers=HY_LAYERS,
        global_layers=(0, HY_LAYERS // 2, HY_LAYERS - 1))
    vocab, layers = cfg.vocab_size, cfg.num_layers
    W = cfg.sliding_window
    din, n_state = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    chunks = -(-HY_MAX // cfg.scan_chunk)
    windowed = sum(r.count for r in layer_schedule(cfg) if r.window)

    def reset_all():
        reset_counts()
        _reset_plain_attention_calls()
        ssm_lib.reset_plain_calls()

    def plain_calls():
        return {**_plain_attention_calls(), **ssm_lib.PLAIN_CALLS}

    # The service's loop (`generate`) on random weights from the seed and
    # prompts drawn as `serve` draws them, timed, with the counters zeroed
    # before and read after.
    t0 = time.perf_counter()
    model = init_model(cfg, HY_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(HY_SEED + 1)
    prompts = torch.randint(0, vocab, (HY_B, HY_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_all()
    # The service's caches, kept for the gates after it: `generate`'s
    # steps go through `models.decode_step`, recorded here (no copy).
    kept, step_fn = {}, models_lib.decode_step

    def recorded(*args, **kwargs):
        logits, kept["caches"] = step_fn(*args, **kwargs)
        return logits, kept["caches"]

    models_lib.decode_step = recorded
    try:
        out = generate(model, cfg, prompts, HY_GEN, HY_MAX)
    finally:
        models_lib.decode_step = step_fn
    torch.cuda.synchronize()
    counts, plain = read_counts(), plain_calls()
    decode_launches = counts.pop("flash_attention_decode")
    say(f"[{tag}] path: generate({HY_ARCH} depth {layers} of "
        f"{full.num_layers}, batch {HY_B}, prompt {HY_PROMPT}, gen {HY_GEN}, "
        f"max_len {HY_MAX}, full width): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / HY_MAX * 1e3:.3f} "
        f"ms per step; decode kernel launches {decode_launches}, other "
        f"kernels {counts}, plain calls {plain}")
    if decode_launches != layers * HY_MAX:
        fail(f"the {tag} path launched the decode kernel {decode_launches} "
             f"times, expected {layers} x {HY_MAX}")
    if any(counts.values()) or any(plain.values()):
        fail(f"the {tag} path launched {counts}, plain calls {plain}: only "
             "the decode kernel may run (the SSM step launches no scan)")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (HY_B, HY_GEN) or tokens.dtype != torch.int32
            or not bool(((tokens >= 0) & (tokens < vocab)).all())):
        fail(f"{tag} tokens {tuple(tokens.shape)} {tokens.dtype} are not "
             f"[{HY_B}, {HY_GEN}] int32 ids below {vocab}")
    serve_logits = out["logits"][:HY_PREFILL_B]
    last_tok = out["logits"][:, :, :vocab].argmax(-1)
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out
    torch.cuda.empty_cache()

    # The same weights and prompts for the gates below.
    seq = torch.cat([prompts, tokens.long()], dim=1)   # [B, HY_MAX]
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] {HY_ARCH} full width, depth {layers} of "
        f"{full.num_layers} ({windowed} with a "
        f"{W}-row window), d_model {cfg.d_model}, heads {cfg.num_heads} "
        f"(padded {cfg.padded_heads}) / kv {cfg.num_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, SSM d_inner {din} state "
        f"{n_state} conv {cfg.ssm_conv}, vocab {vocab} (padded "
        f"{cfg.padded_vocab}), {n_params:,} parameters in bf16, init "
        f"{init_s:.2f}s")

    # Every decode-kernel call of the steps after the service's last, on
    # the service's own caches (the windowed layers' rings wrapped since
    # step 1,024; the global layers' linear caches full, each step written
    # at their last row), held against plain on its own q and ring or
    # cache. Then the device's busy time over the steps after those.
    tap = _DecodeTap(fa)
    state = {"caches": kept.pop("caches"), "tok": last_tok}
    rings = sorted({c["attn"].k.shape[3] for c in state["caches"]})

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], HY_MAX + j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    for j in range(HY_TAP_STEPS):
        tap.length = HY_MAX + j + 1
        with tap:
            step(j)
    layer_check = tap.result(torch)
    _say_layer_taps(tag, f"the {HY_TAP_STEPS} steps after the service's "
                    f"last (cache rows {rings}; the fault reads a ring or "
                    f"cache one row short)", layer_check, layers)
    _check_layer_taps(tag, HY_ARCH, layer_check)

    first = HY_MAX + HY_TAP_STEPS
    profile_res = _lm_profile(torch, lambda j: step(HY_TAP_STEPS + j),
                              HY_PROFILE_STEPS, tag)
    _say_profile(tag, f"positions {first}.."
                 f"{first + HY_PROFILE_STEPS - 1}", profile_res)
    del state
    torch.cuda.empty_cache()

    # Prefill over the first sequences' prompt and generated tokens, with
    # the counters zeroed before and read after: wgmma once per layer (a
    # window in the windowed layers), ssm_scan once per chunk per layer.
    toks = seq[:HY_PREFILL_B]
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    lpre = prefill(model, cfg, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts, plain = read_counts(), plain_calls()
    prefill_launches = {k: v for k, v in counts.items() if v}
    want = {"flash_attention_wgmma": layers, "ssm_scan": layers * chunks}
    say(f"[{tag}] prefill B={HY_PREFILL_B} T={HY_MAX}: {prefill_s:.3f}s, "
        f"kernel launches {prefill_launches}, plain calls {plain}")
    if prefill_launches != want or any(plain.values()):
        fail(f"{tag} prefill launched {prefill_launches}, plain calls "
             f"{plain}; expected {want}")
    with _PrefillTaps(fa, ss) as taps:
        prefill(model, cfg, toks)
    per_call = taps.result(torch)
    say(f"[{tag}] every prefill call vs plain on its own inputs: "
        f"{per_call['attention_calls']} attention calls (windows "
        f"{per_call['windows']}), max err/tol "
        f"{per_call['max_err_over_tol']:.3f} at the tight bf16 bound; the "
        f"window one key wider misses it in {per_call['fault_caught']} of "
        f"{per_call['fault_calls']} windowed calls (least err/tol "
        f"{per_call['fault_min_err_over_tol']:.3f}); {per_call['scans']} "
        f"ssm_scan launches, max err/tol "
        f"{per_call['scan_max_err_over_tol']:.3f} (float32 TOL)")
    if not per_call["max_err_over_tol"] <= 1.0:
        fail(f"{tag}: a prefill attention call misses the tight bf16 bound")
    if (per_call["fault_calls"] != windowed
            or per_call["fault_caught"] != windowed):
        fail(f"{tag}: a window one key wider passes the tight bound in "
             f"{per_call['fault_calls'] - per_call['fault_caught']} of "
             f"{per_call['fault_calls']} windowed calls")
    if (per_call["scans"] != layers * chunks
            or not per_call["scan_max_err_over_tol"] <= 1.0):
        fail(f"{tag}: an ssm_scan launch of the prefill disagrees with "
             "ssm_scan_plain")

    # Logits at position HY_MAX - 1: the service's decode, the prefill,
    # the plain bf16 prefill (the noise), all against float32's prefill.
    lpre_plain = prefill(model, cfg, toks, impl="plain")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    lpre_ref = prefill(model32, cfg32, toks, impl="plain")
    del model32
    torch.cuda.empty_cache()
    res = {}
    for name, got, want_ in (("noise", lpre_plain, lpre_ref),
                             ("prefill", lpre, lpre_ref),
                             ("decode", serve_logits, lpre_ref),
                             ("prefill_vs_decode", lpre, serve_logits)):
        acc = _Logits(torch, vocab)
        acc.add(got, want_)
        res[name] = acc
    noise = res.pop("noise").result()["max_abs_err"]
    what = f"position {HY_MAX - 1} (B={HY_PREFILL_B})"
    say(f"[{tag}] {what}: plain bf16 prefill vs float32 (the noise) "
        f"{noise:.4e}")
    prefill_vs_ref = res["prefill"].result(noise)
    _check_noise(f"{what}, prefill (wgmma + ssm_scan) bf16", prefill_vs_ref,
                 noise, tag)
    decode_vs_ref = res["decode"].result(noise)
    _check_noise(f"{what}, the service's decode bf16", decode_vs_ref, noise,
                 tag)
    prefill_vs_decode = res["prefill_vs_decode"].result()
    _check_ties(f"{what}, prefill vs the service's decode",
                prefill_vs_decode, noise, tag)
    del lpre, lpre_plain, lpre_ref, serve_logits, model
    torch.cuda.empty_cache()

    # Kernel times at the path's shapes.
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sets = [_qkv(torch, HY_PREFILL_B, Hq, Hkv, HY_MAX, HY_MAX, Dh, bf16, gen)
            for _ in range(2)]
    q, k, v = sets[0]
    plain_w = functools.partial(fa.flash_attention_plain, window=W)
    got = fa.flash_attention_cuda(q, k, v, window=W)
    err = _compare(torch, got, plain_w(q, k, v), FA_TOL["bfloat16"],
                   f"hymba windowed prefill at T={HY_MAX}")
    tight = _excess(got, *_tight_tol(plain_w, q, k, v)).item()
    if not tight <= 1.0:
        fail(f"hymba windowed prefill: err/tol {tight:.3f} over the tight "
             "bf16 bound")
    mask = _window_mask(torch, HY_MAX, W)
    prefill_time = _lm_kernel_time(
        torch, lambda q, k, v: fa.flash_attention_cuda(q, k, v, window=W),
        plain_w, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), sets,
        flash_bound(HY_PREFILL_B, Hq, Hkv, HY_MAX, HY_MAX, Dh, True,
                    "bfloat16", window=W), 3)
    prefill_time.update(max_abs_err=err, max_err_over_tol=tight,
                        kernel=fa.select_kernel(q, k))
    _say_lm_time(f"hymba windowed prefill attention B={HY_PREFILL_B} "
                 f"Hq={Hq} Hkv={Hkv} T={HY_MAX} Dh={Dh} window={W} bf16 "
                 f"(sdpa: the window as a boolean mask): "
                 f"{prefill_time['kernel']} kernel", prefill_time)
    del q, k, v, got, sets, mask
    torch.cuda.empty_cache()

    # The decode kernel on a full ring (length past the capacity).
    full = torch.tensor(HY_MAX, dtype=torch.int32, device="cuda")
    sets = [_qkv(torch, HY_B, Hq, Hkv, 1, W, Dh, bf16, gen) + (full,)
            for _ in range(4)]
    q, k, v, _ = sets[0]
    got = fa.decode_attention_cuda(q, k, v, full)
    err = _compare(torch, got, fa.decode_attention_plain(q, k, v, full),
                   FA_TOL["bfloat16"], "hymba decode on a full ring")
    tight = _excess(got, *_tight_tol(fa.decode_attention_plain, q, k, v,
                                      full)).item()
    if not tight <= 1.0:
        fail(f"hymba decode on a full ring: err/tol {tight:.3f} over the "
             "tight bf16 bound")
    decode_time = _lm_kernel_time(
        torch, fa.decode_attention_cuda, fa.decode_attention_plain,
        lambda q, k, v, n: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True), sets,
        decode_bound(HY_B, Hq, Hkv, W, Dh), 20)
    decode_time.update(max_abs_err=err, max_err_over_tol=tight)
    _say_lm_time(f"hymba decode attention on a full ring B={HY_B} Hq={Hq} "
                 f"Hkv={Hkv} rows={W} Dh={Dh} bf16: split-K kernel",
                 decode_time)
    del q, k, v, got, sets
    torch.cuda.empty_cache()
    # The two calls of the tensor-parallel decode ((g) in [train_mesh]) at
    # "model" 2: rank 1's 9 real heads through the uneven map on a whole
    # ring, and every real head against a rank's block of a global layer's
    # cache of 1,088 rows, with the log-sum-exps the merge takes.
    full_map = attention_head_map(cfg)[:cfg.num_heads]
    n_q = cfg.padded_heads // 2
    tp_times = {
        "ring": _mapped_decode_time(
            torch, fa, HY_B, full_map[n_q:], Hkv, W, Dh, gen),
        "global_block": _mapped_decode_time(
            torch, fa, HY_B, full_map, Hkv, TP_SERVE["tp_serve_hybrid"][1]
            // 2, Dh, gen, lse=True)}
    for part, t in tp_times.items():
        rows = W if part == "ring" else TP_SERVE["tp_serve_hybrid"][1] // 2
        _say_lm_time(f"hymba tensor-parallel decode ({part}) B={HY_B} map "
                     f"{tuple(t['map'])} rows={rows} Dh={Dh} bf16"
                     + (" with log-sum-exps" if t["lse"] else "")
                     + ": split-K kernel (sdpa on the k/v expanded by the "
                     "map)", t)

    # ssm_scan at one prefill chunk.
    shape = (HY_PREFILL_B, cfg.scan_chunk, din * n_state)
    sets = [_ssm_inputs(torch, shape, torch.float32, gen) for _ in range(2)]
    a, b = sets[0]
    got, want = ss.ssm_scan_cuda(a, b), ss.ssm_scan_plain(a, b)
    t = SSM_TOL["float32"]
    err = _compare(torch, got, want, t, f"hymba ssm_scan chunk {shape}")
    excess = ((got - want).abs() / (t["atol"] + t["rtol"] * want.abs())
              ).amax().item()
    del got, want
    n = a.numel()
    scan_time = _lm_kernel_time(
        torch, ss.ssm_scan_cuda, ss.ssm_scan_plain, None, sets,
        ssm_bound(n, "float32", "float32"), 3)
    scan_time.update(max_abs_err=err, max_err_over_tol=excess)
    _say_lm_time(f"hymba ssm_scan prefill chunk {shape} f32 (err/tol at "
                 "the float32 TOL):", scan_time)
    del a, b, sets
    torch.cuda.empty_cache()
    return {"arch": HY_ARCH, "parameters": n_params,
            "layer_check": layer_check, "prefill_calls": per_call,
            "noise": noise, "prefill_vs_ref": prefill_vs_ref,
            "decode_vs_ref": decode_vs_ref,
            "prefill_vs_decode": prefill_vs_decode, "prefill_s": prefill_s,
            "launches_by_path": {
                "lm_hybrid": decode_launches,
                "lm_hybrid_prefill": prefill_launches[
                    "flash_attention_wgmma"]},
            "ssm_launches": prefill_launches["ssm_scan"],
            "tok_per_s": tok_per_s, "seconds": seconds,
            "ms_per_step": seconds / HY_MAX * 1e3,
            "profile": profile_res, "prefill_attention": prefill_time,
            "decode_attention": decode_time, "ssm_scan": scan_time,
            "tp_decode_attention": tp_times}


# ---------------------------------------------------------------------------
# LM MoE family
# ---------------------------------------------------------------------------

#: deepseek-moe-16b (src/repro_torch/configs/deepseek_moe_16b.py) at full
#: width, nothing cut: 28 layers, d_model 2048, 16 query and 16 kv heads,
#: head_dim 128, 64 routed experts top-6 plus 2 shared, per-expert d_ff
#: 1,408, vocabulary 102,400 (16.9 B parameters, 33.8 GB in bf16). A
#: 64-token prompt teacher-forced and 64 greedy steps, caches of 128
#: (prompts of 256 and 128 before, cut to keep the script in its time;
#: the model is not narrowed). A
#: decode step's 64 tokens make 384 assignments for 64 experts of 8 slots
#: each (capacity factor 1.25), so an expert that draws more than 8 drops
#: the rest: the full width drops in decode, the reduced config never.
MOE_ARCH, MOE_SEED = "deepseek-moe-16b", 0
MOE_B, MOE_PROMPT, MOE_GEN = 64, 64, 64
MOE_MAX = MOE_PROMPT + MOE_GEN
#: Every decode-kernel call of the first prompt steps is held to plain
#: (32 before, cut to keep the script in its time).
MOE_GATE_STEPS = 16
MOE_PREFILL_B = 8
MOE_PROFILE_STEPS = 32
#: grok-1-314b (configs/grok_1_314b.py) at full width (d_model 6,144, 48
#: query and 8 kv heads, head_dim 128, 8 experts top-2 of d_ff 32,768,
#: vocabulary 131,072, logit softcap 30) and depth 2 of its 64 layers:
#: ~630 GB in bf16 at full depth, 22.9 GB at 2 layers (the card holds 80).
GROK_ARCH, GROK_SEED, GROK_LAYERS = "grok-1-314b", 0, 2
GROK_B, GROK_PROMPT, GROK_GEN = 64, 64, 64
GROK_MAX = GROK_PROMPT + GROK_GEN
GROK_PREFILL_B = 8
GROK_PROFILE_STEPS = 16
#: The softcap gates' inputs at grok's head shape: q and k scaled by this,
#: so that the scores q.k / sqrt(128) spread with a standard deviation of
#: ~64 and many lie past +-60 (twice the cap). Random weights at std 0.02
#: give scores far below the cap: the model runs alone never show it act.
CAP_PEAK = 8.0
CAP_PREFILL_B, CAP_PREFILL_T = 2, 256


class _RouteTap:
    """Stands in for `models.moe.route` while a model runs: records each
    call's dropped assignments (a device tensor, read once at the end)
    and, while ``capture`` is set, each layer's input ``xt`` with its
    drops."""

    def __init__(self, moe_lib, layer_of):
        self.moe_lib, self.route = moe_lib, moe_lib.route
        self.layer_of = layer_of   # id(MoE module) -> layer index
        self.drops, self.capture, self.inputs = [], False, {}

    def __enter__(self):
        self.moe_lib.route = self
        return self

    def __exit__(self, *exc):
        self.moe_lib.route = self.route

    def __call__(self, params, xt, cfg):
        r = self.route(params, xt, cfg)
        self.drops.append(self.moe_lib.dropped(r))
        if self.capture:
            self.inputs[self.layer_of[id(params)]] = (xt, self.drops[-1])
        return r

    def per_step(self, torch, steps: int, layers: int) -> dict:
        d = torch.stack(self.drops).reshape(steps, layers).sum(1).float()
        return {"mean": d.mean().item(), "max": d.max().item(),
                "steps_with_drops": int((d > 0).sum().item()),
                "steps": steps}


def _check_service(tag, arch, counts, plain, decode_launches, want,
                   tokens, shape, vocab, torch) -> None:
    if decode_launches != want:
        fail(f"the {tag} path ({arch}) launched the decode kernel "
             f"{decode_launches} times, expected {want}")
    if any(counts.values()) or any(plain.values()):
        fail(f"the {tag} path ({arch}) launched {counts}, plain calls "
             f"{plain}: only the decode kernel may run")
    if (tuple(tokens.shape) != shape or tokens.dtype != torch.int32
            or not bool(((tokens >= 0) & (tokens < vocab)).all())):
        fail(f"{tag} {arch} tokens {tuple(tokens.shape)} {tokens.dtype} are "
             f"not {list(shape)} int32 ids below {vocab}")


def _prefill_gate(torch, tag, arch, model, cfg, toks, softcap) -> dict:
    """``prefill`` with the counters zeroed before and read after (the
    ``wgmma`` kernel once per layer, nothing else, no plain attention,
    finite logits), then again with every attention call held against
    plain (with the layer's softcap) at the tight bf16 bound."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssm_scan import ssm_scan as ss
    from repro_torch.models import prefill

    layers = cfg.num_layers
    torch.cuda.synchronize()
    reset_counts()
    _reset_plain_attention_calls()
    t0 = time.perf_counter()
    logits = prefill(model, cfg, toks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, plain = read_counts(), _plain_attention_calls()
    launches = {k: v for k, v in counts.items() if v}
    B, T = toks.shape
    say(f"[{tag}] {arch} prefill B={B} T={T}: {seconds:.3f}s, kernel "
        f"launches {launches}, plain calls {plain}")
    if launches != {"flash_attention_wgmma": layers} or any(plain.values()):
        fail(f"{tag} {arch} prefill launched {launches}, plain calls "
             f"{plain}; expected the wgmma kernel once per layer")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{tag} {arch} prefill: non-finite logits")
    with _PrefillTaps(fa, ss) as taps:
        prefill(model, cfg, toks)
    per_call = taps.result(torch)
    say(f"[{tag}] {arch} every prefill attention call vs plain on its own "
        f"inputs: {per_call['attention_calls']} calls (softcaps "
        f"{per_call['softcaps']}), max err/tol "
        f"{per_call['max_err_over_tol']:.3f} at the tight bf16 bound")
    if (per_call["attention_calls"] != layers
            or per_call["softcaps"] != [softcap]
            or not per_call["max_err_over_tol"] <= 1.0):
        fail(f"{tag} {arch}: a prefill attention call misses the tight bf16 "
             f"bound or the softcap {softcap} ({per_call})")
    return {"seconds": seconds, "launches": launches["flash_attention_wgmma"],
            "per_call": per_call}


def _moe_layer_gate(torch, tag, cfg, layer, x) -> dict:
    """One ``moe_layer`` at full width on a layer's real decode input
    ``x [B, 1, d]`` (bf16): once under ``set_sync_debug_mode("error")``
    (no host sync), then in float32 on the card and on the CPU from the
    same weights: the routing (expert ids, ``keep``, slots, token order)
    must be equal, some assignments dropped, and the outputs and aux loss
    equal at the float32 TOL (the card's ``index_add_`` sums in any
    order)."""
    from repro_torch.models import moe as moe_lib

    if torch.backends.cuda.matmul.allow_tf32:
        fail(f"{tag}: TF32 matmuls are on; the float32 gate needs them off")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            y16, _ = moe_lib.moe_layer(layer, x, cfg)
    except RuntimeError as e:
        fail(f"{tag}: moe_layer synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    l32 = copy.deepcopy(layer).float()
    lcpu = copy.deepcopy(l32).cpu()
    x32 = x.float()
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    with torch.no_grad():
        r_card = moe_lib.route(l32, x32.reshape(n, d), cfg)
        y_card, aux_card = moe_lib.moe_layer(l32, x32, cfg)
        r_cpu = moe_lib.route(lcpu, x32.cpu().reshape(n, d), cfg)
        y_cpu, aux_cpu = moe_lib.moe_layer(lcpu, x32.cpu(), cfg)
    equal = {name: bool(torch.equal(r_card[name].cpu(), r_cpu[name]))
             for name in ("experts", "keep", "slot", "tok")}
    if not all(equal.values()):
        fail(f"{tag}: the card's float32 routing differs from the CPU's: "
             f"{equal}")
    dropped = int(moe_lib.dropped(r_cpu))
    err = _compare(torch, y_card.cpu(), y_cpu, TOL["float32"],
                   f"{tag} moe_layer card vs CPU (float32)")
    aux_err = abs(aux_card.item() - aux_cpu.item())
    bf16_err = (y16.float() - y_card).abs().max().item()
    res = {"routing_equal": equal, "dropped": dropped,
           "assignments": n * cfg.num_experts_per_tok, "capacity": r_cpu["C"],
           "max_abs_err": err, "max_abs_out": y_cpu.abs().max().item(),
           "aux": aux_cpu.item(), "aux_err": aux_err,
           "bf16_vs_float32": bf16_err}
    del l32, lcpu
    torch.cuda.empty_cache()
    return res


def phase_lm_moe(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models import decode_step, init_caches, init_model
    from repro_torch.models import moe as moe_lib

    tag = "lm_moe"
    cfg = get_config(MOE_ARCH)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = moe_lib._capacity(MOE_B, cfg)

    # The service, timed, with the counters zeroed before and read after.
    serve_cfg = ServeConfig(arch=MOE_ARCH, batch=MOE_B,
                            prompt_len=MOE_PROMPT, gen=MOE_GEN,
                            max_len=MOE_MAX, reduced=False, seed=MOE_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _reset_plain_attention_calls()
    out = serve(serve_cfg, emit=say)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = read_counts(), _plain_attention_calls()
    decode_launches = counts.pop("flash_attention_decode")
    say(f"[{tag}] path: serve({MOE_ARCH}, batch {MOE_B}, prompt "
        f"{MOE_PROMPT}, gen {MOE_GEN}, max_len {MOE_MAX}, full width): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / MOE_MAX * 1e3:.3f} "
        f"ms per step; decode kernel launches {decode_launches}, other "
        f"kernels {counts}, plain calls {plain}; peak device memory "
        f"{peak_gb:.2f} GB")
    tokens = out["tokens"]
    _check_service(tag, MOE_ARCH, counts, plain, decode_launches,
                   layers * MOE_MAX, tokens, (MOE_B, MOE_GEN), vocab, torch)
    if not bool(torch.isfinite(out["logits"]).all()):
        fail(f"{tag}: non-finite logits at the service's last step")
    serve_logits = out["logits"]
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out
    torch.cuda.empty_cache()

    # The same weights (the service's seed) and prompts (its generator),
    # teacher-forced over the prompt and the service's greedy tokens.
    t0 = time.perf_counter()
    model = init_model(cfg, MOE_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(MOE_SEED + 1)
    prompts = torch.randint(0, vocab, (MOE_B, MOE_PROMPT), generator=gen,
                            device="cuda")
    seq = torch.cat([prompts, tokens.long()], dim=1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] {MOE_ARCH} full width: {layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads} / kv {cfg.num_kv_heads}, "
        f"head_dim {cfg.resolved_head_dim}, {E} routed experts top-{k} + "
        f"{cfg.num_shared_experts} shared, expert d_ff "
        f"{cfg.d_ff_per_expert}, vocab {vocab} (padded {cfg.padded_vocab}), "
        f"{n_params:,} parameters in bf16, init "
        f"{time.perf_counter() - t0:.2f}s; decode capacity C = {C} per "
        f"expert for {MOE_B * k} assignments")
    blocks = [b for run in model.runs for b in run]
    decode_tap = _DecodeTap(fa)
    route_tap = _RouteTap(moe_lib, {id(b.moe): li
                                    for li, b in enumerate(blocks)})
    caches = init_caches(cfg, MOE_B, MOE_MAX + MOE_PROFILE_STEPS,
                         device="cuda")
    with route_tap:
        for i in range(MOE_MAX):
            route_tap.capture = i == MOE_PROMPT - 1
            decode_tap.length = i + 1
            if i < MOE_GATE_STEPS:
                with decode_tap:
                    lk, caches = decode_step(model, cfg, caches,
                                             seq[:, i:i + 1], i)
            else:
                lk, caches = decode_step(model, cfg, caches, seq[:, i:i + 1],
                                         i)
    layer_check = decode_tap.result(torch)
    _say_layer_taps(tag, f"{MOE_ARCH}, the first {MOE_GATE_STEPS} prompt "
                    "steps", layer_check, layers)
    _check_layer_taps(tag, MOE_ARCH, layer_check)
    drops = route_tap.per_step(torch, MOE_MAX, layers)
    acc = _Logits(torch, vocab)
    acc.add(lk, serve_logits)
    tf_vs_service = acc.result()
    say(f"[{tag}] dropped assignments per decode step (teacher-forced over "
        f"the service's {MOE_MAX} positions; {layers} layers x {MOE_B * k} "
        f"assignments, C = {C}): mean {drops['mean']:.2f}, max "
        f"{drops['max']:.0f}, {drops['steps_with_drops']} of "
        f"{drops['steps']} steps drop; its last logits vs the service's "
        f"(the same function; bf16 routing near ties and the float32 "
        f"combine's atomics may differ): max |dlogit| "
        f"{tf_vs_service['max_abs_err']:.4e}, top-1 equal at "
        f"{tf_vs_service['top1_match']:.4f}")
    if not drops["steps_with_drops"]:
        fail(f"{tag}: no decode step dropped an assignment at C = {C}")

    # Device busy over decode steps past the service's last.
    state = {"caches": caches, "tok": lk[:, :, :vocab].argmax(-1)}

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], MOE_MAX + j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    profile_res = _lm_profile(torch, step, MOE_PROFILE_STEPS, tag)
    _say_profile(tag, f"{MOE_ARCH}, positions {MOE_MAX}..."
                 f"{MOE_MAX + MOE_PROFILE_STEPS - 1}", profile_res)
    del caches, state, lk
    torch.cuda.empty_cache()

    # One moe_layer at full width on a real decode input: the layer whose
    # input dropped the most at the last prompt step.
    li, (xt, _) = max(route_tap.inputs.items(),
                      key=lambda kv: int(kv[1][1]))
    layer_gate = _moe_layer_gate(torch, tag, cfg, blocks[li].moe,
                                 xt.reshape(MOE_B, 1, cfg.d_model))
    say(f"[{tag}] moe_layer at full width (layer {li}'s input at position "
        f"{MOE_PROMPT - 1}, B={MOE_B}): no host sync under "
        f"set_sync_debug_mode('error'); float32 card vs CPU: routing equal "
        f"{layer_gate['routing_equal']}, {layer_gate['dropped']} of "
        f"{layer_gate['assignments']} assignments dropped (C = "
        f"{layer_gate['capacity']}), max abs err "
        f"{layer_gate['max_abs_err']:.3e} (max |out| "
        f"{layer_gate['max_abs_out']:.4f}; TOL rtol 2e-4 atol 2e-5), aux "
        f"{layer_gate['aux']:.6f} (err {layer_gate['aux_err']:.2e}); bf16 "
        f"layer vs float32 {layer_gate['bf16_vs_float32']:.3e}")
    if not layer_gate["dropped"] > 0:
        fail(f"{tag}: the full-width moe_layer gate dropped nothing")
    if not layer_gate["aux_err"] <= 2e-5 + 2e-4 * abs(layer_gate["aux"]):
        fail(f"{tag}: aux loss card vs CPU {layer_gate['aux_err']:.3e}")
    del route_tap, xt, blocks
    torch.cuda.empty_cache()

    prefill_res = _prefill_gate(torch, tag, MOE_ARCH, model, cfg,
                                prompts[:MOE_PREFILL_B], 0.0)
    del model, prompts, seq, serve_logits
    torch.cuda.empty_cache()

    # Kernel times at the path's shapes.
    gen = torch.Generator(device="cuda").manual_seed(5)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    decode_time = _decode_time(torch, fa, MOE_B, Hq, Hkv, MOE_MAX, Dh, gen)
    _say_lm_time(f"deepseek decode attention B={MOE_B} Hq={Hq} Hkv={Hkv} "
                 f"L={MOE_MAX} Dh={Dh} bf16 (1 row per kv head): split-K "
                 "kernel", decode_time)
    prefill_time = _prefill_time(torch, fa, MOE_PREFILL_B, Hq, Hkv,
                                 MOE_PROMPT, Dh, gen)
    _say_lm_time(f"deepseek prefill attention B={MOE_PREFILL_B} Hq={Hq} "
                 f"Hkv={Hkv} T={MOE_PROMPT} Dh={Dh} bf16 causal: "
                 f"{prefill_time['kernel']} kernel", prefill_time)
    return {"arch": MOE_ARCH, "parameters": n_params, "capacity": C,
            "peak_memory_gb": peak_gb, "layer_check": layer_check,
            "drops_per_step": drops, "teacher_forced_vs_service":
            tf_vs_service, "moe_layer": layer_gate, "prefill": prefill_res,
            "launches_by_path": {"lm_moe": decode_launches,
                                 "lm_moe_prefill": prefill_res["launches"]},
            "tok_per_s": tok_per_s, "seconds": seconds,
            "ms_per_step": seconds / MOE_MAX * 1e3,
            "profile": profile_res, "decode_attention": decode_time,
            "prefill_attention": prefill_time}


def _cap_gate(torch, tag, what, cap, kernel, plain, args, want_kernel):
    """``kernel`` (a wrapper with the softcap ``cap``) on inputs whose
    scores pass the cap: within the tight bf16 bound of ``plain`` with the
    cap, which ``plain`` without the cap must miss."""
    before = read_counts()
    got = kernel(*args)
    torch.cuda.synchronize()
    moved = {n: v - before[n] for n, v in read_counts().items()
             if v != before[n]}
    want, tol = _tight_tol(functools.partial(plain, softcap=cap), *args)
    ok = _excess(got, want, tol).item()
    nocap = _excess(plain(*args), want, tol).item()
    q, k = args[0].float(), args[1].float()
    group = q.shape[1] // k.shape[1]
    s = (q[:, ::group] @ k.mT) / q.shape[-1] ** 0.5
    res = {"err_over_tol": ok, "uncapped_err_over_tol": nocap,
           "max_abs_score": s.abs().max().item(),
           "share_past_2cap": (s.abs() > 2 * cap).float().mean().item(),
           "launches": moved}
    say(f"[{tag}] softcap {cap:g} {what}: launches {moved}, max |score| "
        f"{res['max_abs_score']:.1f} ({res['share_past_2cap']:.3f} past "
        f"twice the cap); err/tol vs plain with the cap {ok:.3f}; plain "
        f"without the cap {nocap:.1f}")
    if moved != {want_kernel: 1}:
        fail(f"{tag} softcap {what}: launched {moved}, not {want_kernel}")
    if not ok <= 1.0:
        fail(f"{tag} softcap {what}: err/tol {ok:.3f} over the tight bound")
    if not nocap > 1.0:
        fail(f"{tag} softcap {what}: the cap-free plain version passes the "
             f"tight bound ({nocap:.3f}): the cap does not act")
    return res


def phase_lm_grok(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_caches, init_model
    from repro_torch.models import moe as moe_lib

    tag = "lm_moe"
    full = get_config(GROK_ARCH)
    cfg = dataclasses.replace(full, num_layers=GROK_LAYERS)
    vocab, layers, cap = cfg.vocab_size, cfg.num_layers, cfg.attn_logit_softcap
    C = moe_lib._capacity(GROK_B, cfg)

    # The service's loop (`generate`) on random weights from the seed and
    # prompts drawn as `serve` draws them, with the counters zeroed before
    # and read after.
    t0 = time.perf_counter()
    model = init_model(cfg, GROK_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(GROK_SEED + 1)
    prompts = torch.randint(0, vocab, (GROK_B, GROK_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] {GROK_ARCH} full width, depth {layers} of "
        f"{full.num_layers}: d_model {cfg.d_model}, heads {cfg.num_heads} / "
        f"kv {cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, expert "
        f"d_ff {cfg.d_ff_per_expert}, softcap {cap}, vocab {vocab}, "
        f"{n_params:,} parameters in bf16, init "
        f"{time.perf_counter() - t0:.2f}s; decode capacity C = {C}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _reset_plain_attention_calls()
    out = generate(model, cfg, prompts, GROK_GEN, GROK_MAX)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = read_counts(), _plain_attention_calls()
    decode_launches = counts.pop("flash_attention_decode")
    say(f"[{tag}] path: generate({GROK_ARCH} depth {layers}, batch "
        f"{GROK_B}, prompt {GROK_PROMPT}, gen {GROK_GEN}, max_len "
        f"{GROK_MAX}): {out['tok_per_s']:.1f} tok/s, "
        f"{out['seconds'] / GROK_MAX * 1e3:.3f} ms per step; decode kernel "
        f"launches {decode_launches}, other kernels {counts}, plain calls "
        f"{plain}; peak device memory {peak_gb:.2f} GB")
    tokens = out["tokens"]
    _check_service(tag, GROK_ARCH, counts, plain, decode_launches,
                   layers * GROK_MAX, tokens, (GROK_B, GROK_GEN), vocab,
                   torch)
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out

    # Every decode-kernel call, teacher-forced over the same positions,
    # against plain with the cap; the cap passed to every call.
    seq = torch.cat([prompts, tokens.long()], dim=1)
    tap = _DecodeTap(fa)
    blocks = [b for run in model.runs for b in run]
    route_tap = _RouteTap(moe_lib, {id(b.moe): li
                                    for li, b in enumerate(blocks)})
    caches = init_caches(cfg, GROK_B, GROK_MAX + GROK_PROFILE_STEPS,
                         device="cuda")
    with route_tap, tap:
        for i in range(GROK_MAX):
            tap.length = i + 1
            lk, caches = decode_step(model, cfg, caches, seq[:, i:i + 1], i)
    layer_check = tap.result(torch)
    _say_layer_taps(tag, f"{GROK_ARCH}, all {GROK_MAX} steps", layer_check,
                    layers)
    _check_layer_taps(tag, GROK_ARCH, layer_check)
    if layer_check["softcaps"] != [cap]:
        fail(f"{tag}: grok's decode calls passed softcaps "
             f"{layer_check['softcaps']}, not [{cap}]")
    drops = route_tap.per_step(torch, GROK_MAX, layers)
    say(f"[{tag}] {GROK_ARCH} dropped assignments per decode step ({layers} "
        f"layers x {GROK_B * cfg.num_experts_per_tok} assignments, C = "
        f"{C}): mean {drops['mean']:.2f}, max {drops['max']:.0f}, "
        f"{drops['steps_with_drops']} of {drops['steps']} steps drop")
    if not bool(torch.isfinite(lk).all()):
        fail(f"{tag} {GROK_ARCH}: non-finite decode logits")

    # Device busy over decode steps past the service's last.
    state = {"caches": caches, "tok": lk[:, :, :vocab].argmax(-1)}

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], GROK_MAX + j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    profile_res = _lm_profile(torch, step, GROK_PROFILE_STEPS, "lm_grok")
    _say_profile(tag, f"{GROK_ARCH}, positions {GROK_MAX}..."
                 f"{GROK_MAX + GROK_PROFILE_STEPS - 1}", profile_res)
    del caches, state, lk, route_tap, blocks
    torch.cuda.empty_cache()

    prefill_res = _prefill_gate(torch, tag, GROK_ARCH, model, cfg,
                                seq[:GROK_PREFILL_B], cap)
    del model, prompts, seq
    torch.cuda.empty_cache()

    # The cap acting, on kernel inputs at grok's head shape scaled so that
    # many scores pass +-60.
    gen = torch.Generator(device="cuda").manual_seed(6)
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16

    def scaled(B, Tq, Tk):
        q, k, v = _qkv(torch, B, Hq, Hkv, Tq, Tk, Dh, torch.float32, gen)
        return ((q * CAP_PEAK).to(bf16), (k * CAP_PEAK).to(bf16), v.to(bf16))

    cap_prefill = _cap_gate(
        torch, tag, f"prefill B={CAP_PREFILL_B} Hq={Hq} Hkv={Hkv} "
        f"T={CAP_PREFILL_T} Dh={Dh} bf16", cap,
        functools.partial(fa.flash_attention_cuda, softcap=cap),
        fa.flash_attention_plain, scaled(CAP_PREFILL_B, CAP_PREFILL_T,
                                         CAP_PREFILL_T),
        "flash_attention_wgmma")
    full_len = torch.tensor(GROK_MAX, dtype=torch.int32, device="cuda")
    cap_decode = _cap_gate(
        torch, tag, f"decode B={GROK_B} Hq={Hq} Hkv={Hkv} L={GROK_MAX} "
        f"Dh={Dh} bf16", cap, functools.partial(fa.decode_attention_cuda,
                                                softcap=cap),
        fa.decode_attention_plain, scaled(GROK_B, 1, GROK_MAX) + (full_len,),
        "flash_attention_decode")

    # Kernel times at the path's shapes (SDPA has no softcap).
    decode_time = _decode_time(torch, fa, GROK_B, Hq, Hkv, GROK_MAX, Dh, gen,
                               softcap=cap)
    _say_lm_time(f"grok decode attention B={GROK_B} Hq={Hq} Hkv={Hkv} "
                 f"L={GROK_MAX} Dh={Dh} bf16 softcap {cap}: split-K kernel",
                 decode_time, library="SDPA without the cap")
    prefill_time = _prefill_time(torch, fa, GROK_PREFILL_B, Hq, Hkv,
                                 GROK_MAX, Dh, gen, softcap=cap)
    _say_lm_time(f"grok prefill attention B={GROK_PREFILL_B} Hq={Hq} "
                 f"Hkv={Hkv} T={GROK_MAX} Dh={Dh} bf16 causal softcap {cap}: "
                 f"{prefill_time['kernel']} kernel", prefill_time,
                 library="SDPA without the cap")
    return {"arch": GROK_ARCH, "layers": layers, "parameters": n_params,
            "capacity": C, "peak_memory_gb": peak_gb,
            "layer_check": layer_check, "profile": profile_res,
            "drops_per_step": drops, "prefill": prefill_res,
            "cap_prefill": cap_prefill, "cap_decode": cap_decode,
            "launches_by_path": {"lm_grok": decode_launches,
                                 "lm_grok_prefill": prefill_res["launches"]},
            "tok_per_s": tok_per_s, "seconds": seconds,
            "ms_per_step": seconds / GROK_MAX * 1e3,
            "decode_attention": decode_time,
            "prefill_attention": prefill_time}


# ---------------------------------------------------------------------------
# LM xLSTM family
# ---------------------------------------------------------------------------

#: xlstm-350m (src/repro_torch/configs/xlstm_350m.py) at full width,
#: nothing cut: 24 blocks (sLSTM at 7, 15, 23, mLSTM elsewhere), d_model
#: 1,024, 4 heads, mLSTM inner width 2,048 (dh 512), vocabulary 50,304,
#: embeddings untied. The decode state has a fixed size whatever the
#: length: 21 x C [64, 4, 512, 512] float32 is 5.64 GB at B = 64, five
#: times the weights.
XL_ARCH, XL_SEED = "xlstm-350m", 0
#: The service: a 128-token prompt and 128 greedy steps (256 and 256
#: before, cut to keep the script in its time).
XL_B, XL_PROMPT, XL_GEN = 64, 128, 128
XL_MAX = XL_PROMPT + XL_GEN
#: The prefill gates: 4 chunks of 256, so one scan over [8, 4, 1,050,624].
XL_PREFILL_B, XL_PREFILL_T = 8, 1024
#: The float32 whole-model gate: prefill against teacher-forced decode at
#: position XL_F32_T - 1, past one chunk boundary (a whole chunk of 256
#: and a short one); 1,024 positions before, cut to keep the script in
#: its time.
XL_F32_T = 320
XL_PROFILE_STEPS = 32
#: Whole-model logit gates, relative to the largest logit: float32
#: chunkwise against float32 recurrent (the suite's float32 rtol), and
#: bf16 kernel against bf16 plain (one bf16 rounding).
XL_F32_REL = 2e-4
XL_BF16_REL = 2.0 ** -8
#: Forget gates log_sigmoid(6 + z): memory that outlasts a 256-step chunk
#: (the random model's gates forget within one).
XL_LONG_FORGET = 6.0


class _ScanTap:
    """Stands in for `ssm_scan_cuda` while the mLSTM prefill runs. Each
    call launches the kernel as the model's call would and is held
    against `ssm_scan_plain` on the same ``a, b [B, nc, D]`` at the
    float32 TOL (error over the allclose tolerance). Two planted faults
    launch the kernel again: the carry into the second chunk dropped
    (``a[:, 1] = 0``), and the state after it lost as well (``a[:, 1] =
    b[:, 1] = 0``); the largest carry factor ``a`` of the call is
    recorded beside them. With ``plant`` the carry-dropped output is what
    the model gets."""

    def __init__(self, ss, plant=False):
        self.ss, self.scan, self.plant = ss, ss.ssm_scan_cuda, plant
        self.ok, self.lost, self.carry, self.carry_max = [], [], [], []

    def __enter__(self):
        self.ss.ssm_scan_cuda = self
        return self

    def __exit__(self, *exc):
        self.ss.ssm_scan_cuda = self.scan

    def __call__(self, a, b):
        h = self.scan(a, b)
        want = self.ss.ssm_scan_plain(a, b)
        t = SSM_TOL["float32"]
        tol = t["atol"] + t["rtol"] * want.abs()
        a_bad, b_bad = a.clone(), b.clone()
        a_bad[:, 1] = 0
        dropped = self.scan(a_bad, b)
        b_bad[:, 1] = 0
        lost = self.scan(a_bad, b_bad)
        for acc, out in ((self.ok, h), (self.lost, lost),
                         (self.carry, dropped)):
            acc.append(((out - want).abs() / tol).amax())
        self.carry_max.append(a[:, 1:].amax())
        return dropped if self.plant else h

    def result(self, torch) -> dict:
        ok, lost, carry = (torch.stack(x).tolist()
                           for x in (self.ok, self.lost, self.carry))
        return {"scans": len(ok), "max_err_over_tol": max(ok),
                "lost_min_err_over_tol": min(lost),
                "lost_caught": sum(s > 1.0 for s in lost),
                "carry_dropped_max_err_over_tol": max(carry),
                "carry_dropped_caught": sum(c > 1.0 for c in carry),
                "max_carry_factor": torch.stack(self.carry_max).amax().item()}


def _recurrent_mlstm(torch, xl, q, k, v, lf, li):
    """The mLSTM over T from a zero state by the port's decode step
    (`xlstm._memory_step`, held against JAX's on the CPU): h ``[B, H, T,
    dh]`` and the final ``(C, n)``, float32."""
    B, H, T, dh = q.shape
    C, n = q.new_zeros((B, H, dh, dh)), q.new_zeros((B, H, dh))
    f, i = lf.exp(), li.exp()
    hs = [xl._memory_step(C, n, f[..., t], i[..., t], q[:, :, t], k[:, :, t],
                          v[:, :, t]) for t in range(T)]
    return torch.cat(hs, dim=2), (C, n)


def _rel(got, want) -> float:
    """Largest error over the reference's largest magnitude."""
    return ((got.float() - want.float()).abs().amax()
            / want.float().abs().amax()).item()


def phase_lm_xlstm(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ssm_scan as ss
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models import (decode_step, init_caches, init_model,
                                    prefill)
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xl

    tag = "lm_xlstm"
    cfg = get_config(XL_ARCH)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    H, CT = cfg.num_heads, cfg.scan_chunk
    din = int(cfg.mlstm_proj_factor * cfg.d_model)
    dh = din // H
    n_mlstm = layers - len(cfg.slstm_layers)
    nc = XL_PREFILL_T // CT

    def reset_all():
        reset_counts()
        _reset_plain_attention_calls()
        ssm_lib.reset_plain_calls()

    def plain_calls():
        return {**_plain_attention_calls(), **ssm_lib.PLAIN_CALLS}

    # The service, timed, with the counters zeroed before and read after:
    # no kernel and no plain call (the decode step is plain PyTorch).
    serve_cfg = ServeConfig(arch=XL_ARCH, batch=XL_B, prompt_len=XL_PROMPT,
                            gen=XL_GEN, max_len=XL_MAX, reduced=False,
                            seed=XL_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    out = serve(serve_cfg, emit=say)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = read_counts(), plain_calls()
    say(f"[{tag}] path: serve({XL_ARCH}, batch {XL_B}, prompt {XL_PROMPT}, "
        f"gen {XL_GEN}, max_len {XL_MAX}, full width): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / XL_MAX * 1e3:.3f} "
        f"ms per step; kernel launches {counts}, plain calls {plain}; peak "
        f"device memory {peak_gb:.2f} GB")
    _check_service(tag, XL_ARCH, counts, plain, 0, 0, out["tokens"],
                   (XL_B, XL_GEN), vocab, torch)
    if not bool(torch.isfinite(out["logits"]).all()):
        fail(f"{tag}: non-finite logits at the service's last step")
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out
    torch.cuda.empty_cache()

    # The same weights (the service's seed); the decode state's bytes.
    t0 = time.perf_counter()
    model = init_model(cfg, XL_SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    caches = init_caches(cfg, XL_B, XL_MAX, device="cuda")
    state_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c)
    c_bytes = sum(c.C.numel() * 4 for c in caches if hasattr(c, "C"))
    say(f"[{tag}] {XL_ARCH} full width: {layers} blocks ({n_mlstm} mLSTM, "
        f"sLSTM at {list(cfg.slstm_layers)}), d_model {cfg.d_model}, heads "
        f"{H}, mLSTM inner {din} (dh {dh}), conv {cfg.ssm_conv}, vocab "
        f"{vocab} (padded {cfg.padded_vocab}), {n_params:,} parameters in "
        f"bf16, init {time.perf_counter() - t0:.2f}s; decode state at B="
        f"{XL_B}: {state_bytes / 1e9:.3f} GB ({c_bytes / 1e9:.3f} GB of C)")

    # Device busy over 32 decode steps (the state's size, and so the
    # step's work, does not depend on the position).
    gen = torch.Generator(device="cuda").manual_seed(XL_SEED + 1)
    state = {"caches": caches, "tok": torch.randint(
        0, vocab, (XL_B, 1), generator=gen, device="cuda")}

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    for j in range(4):
        step(j)
    profile_res = _lm_profile(torch, step, XL_PROFILE_STEPS, tag)
    _say_profile(tag, "a constant-size state", profile_res)
    del caches, state
    torch.cuda.empty_cache()

    # The matrix memory's step (`_memory_step`: C <- f C + (i k) v^T in
    # place, and the readout C^T q) of one layer at B = 64, by CUDA graph,
    # beside one read and one write of C.
    g4 = torch.Generator(device="cuda").manual_seed(5)
    kw = dict(device="cuda", generator=g4)
    mem_sets = [(torch.randn((XL_B, H, dh, dh), **kw),
                 torch.randn((XL_B, H, dh), **kw),
                 torch.rand((XL_B, H), **kw), torch.rand((XL_B, H), **kw),
                 *(torch.randn((XL_B, H, dh), **kw) for _ in range(3)))
                for _ in range(2)]
    mem_ms = _graph_ms(torch, xl._memory_step, mem_sets)
    # C and n read and written once, q, k, v and the gates read, the
    # readout written; per element of C a multiply, an FMA and an FMA.
    mem_bound, mem_by = _bound(
        4 * XL_B * H * (2 * dh * dh + 6 * dh + 2), 5 * XL_B * H * dh * dh,
        "float32")
    say(f"[time] xlstm decode memory step (C update in place + readout) "
        f"B={XL_B} H={H} dh={dh} f32: {mem_ms * 1e3:.2f} us device per "
        f"layer (CUDA graph), bound {mem_bound * 1e3:.2f} us ({mem_by}: one "
        f"read and one write of C); x {n_mlstm} layers {mem_ms * n_mlstm:.3f}"
        f" ms per step against {mem_bound * n_mlstm:.3f} ms")
    del mem_sets
    torch.cuda.empty_cache()

    # Prefill at B = 8, T = 1,024 with the counters zeroed before and read
    # after: one ssm_scan launch per mLSTM layer, no plain call.
    toks = torch.randint(0, vocab, (XL_PREFILL_B, XL_PREFILL_T),
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    lpre = prefill(model, cfg, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts, plain = read_counts(), plain_calls()
    prefill_launches = {k: v for k, v in counts.items() if v}
    say(f"[{tag}] prefill B={XL_PREFILL_B} T={XL_PREFILL_T} ({nc} chunks "
        f"of {CT}): {prefill_s:.3f}s, kernel launches {prefill_launches}, "
        f"plain calls {plain}")
    if prefill_launches != {"ssm_scan": n_mlstm} or any(plain.values()):
        fail(f"{tag} prefill launched {prefill_launches}, plain calls "
             f"{plain}; expected ssm_scan x {n_mlstm} and nothing else")
    with _ScanTap(ss) as tap:
        prefill(model, cfg, toks)
    per_call = tap.result(torch)
    say(f"[{tag}] every prefill scan vs ssm_scan_plain on its own inputs "
        f"[{XL_PREFILL_B}, {nc}, {H * (dh * dh + dh)}]: "
        f"{per_call['scans']} calls, max err/tol "
        f"{per_call['max_err_over_tol']:.3f} (float32 TOL); the state "
        f"after chunk 1 lost misses it in {per_call['lost_caught']} of "
        f"{per_call['scans']} (least err/tol "
        f"{per_call['lost_min_err_over_tol']:.3e}); the carry into chunk 1 "
        f"dropped: max err/tol "
        f"{per_call['carry_dropped_max_err_over_tol']:.3e}, caught in "
        f"{per_call['carry_dropped_caught']} (largest carry factor "
        f"{per_call['max_carry_factor']:.3e}: the random gates forget "
        f"within a chunk)")
    if per_call["scans"] != n_mlstm or not per_call["max_err_over_tol"] <= 1:
        fail(f"{tag}: a prefill scan disagrees with ssm_scan_plain")
    if per_call["lost_caught"] != n_mlstm:
        fail(f"{tag}: a scan that loses a chunk's state passes the float32 "
             "TOL")

    # The carry where it matters: forget gates near 1, at the full width.
    long = [torch.randn((XL_PREFILL_B, H, XL_PREFILL_T, dh), **kw)
            for _ in range(3)]
    long[0] /= dh ** 0.5
    z = torch.randn((2, XL_PREFILL_B, H, XL_PREFILL_T), **kw)
    lf = torch.nn.functional.logsigmoid(XL_LONG_FORGET + z[0])
    li = torch.nn.functional.logsigmoid(z[1])
    h_ref, (C_ref, _) = _recurrent_mlstm(torch, xl, *long, lf, li)
    carry = {}
    for plant in (False, True):
        with _ScanTap(ss, plant=plant) as ctap:
            h, (C_end, _) = xl._mlstm_chunked(*long, lf, li, CT)
        carry["dropped" if plant else "kernel"] = {
            "h_rel": _rel(h, h_ref), "C_rel": _rel(C_end, C_ref),
            "scan": ctap.result(torch)}
    del long, z, lf, li, h, C_end, h_ref, C_ref
    torch.cuda.empty_cache()
    ck, cd = carry["kernel"], carry["dropped"]
    say(f"[{tag}] chunk carry at full width, forget gates "
        f"log_sigmoid({XL_LONG_FORGET:g} + z) (carry factor up to "
        f"{ck['scan']['max_carry_factor']:.3f}): chunkwise on the kernel vs "
        f"the recurrent step, max |dh| / max |h| {ck['h_rel']:.3e}, final C "
        f"{ck['C_rel']:.3e} (bound {XL_F32_REL:g}); scan err/tol "
        f"{ck['scan']['max_err_over_tol']:.3f}; the carry into chunk 1 "
        f"dropped: {cd['h_rel']:.3e}, final C {cd['C_rel']:.3e}, scan "
        f"err/tol {cd['scan']['carry_dropped_max_err_over_tol']:.3e}")
    if not (ck["h_rel"] <= XL_F32_REL and ck["C_rel"] <= XL_F32_REL
            and ck["scan"]["max_err_over_tol"] <= 1.0):
        fail(f"{tag}: the chunkwise mLSTM on the kernel disagrees with the "
             "recurrent step where the carry matters")
    if not (cd["h_rel"] > XL_F32_REL and cd["C_rel"] > XL_F32_REL
            and cd["scan"]["carry_dropped_caught"] == 1):
        fail(f"{tag}: a dropped chunk carry passes the bounds")

    # Whole model: bf16 kernel vs bf16 plain; float32 chunkwise (kernel)
    # vs float32 recurrent (decode_step teacher-forced to T - 1).
    lpre_plain = prefill(model, cfg, toks, impl="plain")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    del model
    torch.cuda.empty_cache()
    reset_all()
    lpre32 = prefill(model32, cfg32, toks)
    torch.cuda.synchronize()
    if read_counts()["ssm_scan"] != n_mlstm:
        fail(f"{tag}: the float32 prefill did not run the kernel")
    t0 = time.perf_counter()
    lshort32 = prefill(model32, cfg32, toks[:, :XL_F32_T])
    caches = init_caches(cfg32, XL_PREFILL_B, XL_F32_T, device="cuda")
    for i in range(XL_F32_T):
        ldec32, caches = decode_step(model32, cfg32, caches,
                                     toks[:, i:i + 1], i)
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    del caches, model32
    torch.cuda.empty_cache()
    V = slice(0, vocab)
    logit_res = {
        "f32_prefill_vs_decode": _rel(lshort32[..., V], ldec32[..., V]),
        "bf16_kernel_vs_plain": _rel(lpre[..., V], lpre_plain[..., V]),
        "bf16_noise": _rel(lpre_plain[..., V], lpre32[..., V]),
        "bf16_kernel_vs_f32": _rel(lpre[..., V], lpre32[..., V]),
        "max_abs_logit_f32": lpre32[..., V].abs().amax().item(),
        "top1_f32_equal": (lshort32[..., V].argmax(-1)
                           == ldec32[..., V].argmax(-1)).float().mean().item(),
        "finite": bool(torch.isfinite(lpre).all()
                       and torch.isfinite(lpre32).all()),
        "forced_s": forced_s}
    say(f"[{tag}] relative to the largest logit: float32 prefill "
        f"(ssm_scan) vs float32 teacher-forced decode at position "
        f"{XL_F32_T - 1} (B={XL_PREFILL_B}, {forced_s:.1f}s) "
        f"{logit_res['f32_prefill_vs_decode']:.3e} (bound {XL_F32_REL:g}, "
        f"top-1 equal {logit_res['top1_f32_equal']:.3f}); bf16 prefill "
        f"kernel vs plain {logit_res['bf16_kernel_vs_plain']:.3e} (bound "
        f"2^-8 = {XL_BF16_REL:.3e}); bf16 noise (plain bf16 vs float32) "
        f"{logit_res['bf16_noise']:.3e}, kernel bf16 vs float32 "
        f"{logit_res['bf16_kernel_vs_f32']:.3e}; max |logit| "
        f"{logit_res['max_abs_logit_f32']:.4f}")
    if not logit_res["finite"]:
        fail(f"{tag}: non-finite prefill logits")
    if not logit_res["f32_prefill_vs_decode"] <= XL_F32_REL:
        fail(f"{tag}: the float32 chunkwise prefill differs from the "
             "float32 recurrent decode")
    if not logit_res["bf16_kernel_vs_plain"] <= XL_BF16_REL:
        fail(f"{tag}: the bf16 prefill on the kernel differs from plain")
    del lpre, lpre_plain, lpre32, lshort32, ldec32
    torch.cuda.empty_cache()

    # ssm_scan at the prefill's shape.
    shape = (XL_PREFILL_B, nc, H * (dh * dh + dh))
    sets = [_ssm_inputs(torch, shape, torch.float32, g4) for _ in range(2)]
    a, b = sets[0]
    got, want = ss.ssm_scan_cuda(a, b), ss.ssm_scan_plain(a, b)
    t = SSM_TOL["float32"]
    err = _compare(torch, got, want, t, f"xlstm ssm_scan {shape}")
    excess = ((got - want).abs() / (t["atol"] + t["rtol"] * want.abs())
              ).amax().item()
    del got, want
    n = a.numel()
    scan_time = _lm_kernel_time(
        torch, ss.ssm_scan_cuda, ss.ssm_scan_plain, None, sets,
        ssm_bound(n, "float32", "float32"), 3)
    scan_time.update(max_abs_err=err, max_err_over_tol=excess)
    _say_lm_time(f"xlstm ssm_scan mLSTM chunk states {shape} f32 (err/tol "
                 "at the float32 TOL):", scan_time)
    del a, b, sets
    torch.cuda.empty_cache()
    return {"arch": XL_ARCH, "parameters": n_params,
            "state_bytes": state_bytes, "C_bytes": c_bytes,
            "peak_gb": peak_gb, "tok_per_s": tok_per_s, "seconds": seconds,
            "ms_per_step": seconds / XL_MAX * 1e3, "profile": profile_res,
            "memory_step_ms": mem_ms, "memory_step_bound_ms": mem_bound,
            "prefill_s": prefill_s, "prefill_calls": per_call,
            "carry": carry, "logits": logit_res,
            "ssm_launches": prefill_launches["ssm_scan"],
            "ssm_scan": scan_time}


# ---------------------------------------------------------------------------
# LM encoder-decoder family and the M-RoPE model
# ---------------------------------------------------------------------------

#: seamless-m4t-medium (src/repro_torch/configs/seamless_m4t_medium.py) at
#: full width, nothing cut: 12 encoder and 12 decoder layers, d_model
#: 1,024, 16 query and 16 kv heads, head_dim 64, d_ff 4,096, vocabulary
#: 256,206 padded to 258,048, untied, an encoder memory of 1,024 frames. A
#: 128-token prompt teacher-forced and 128 greedy steps, caches of 256
#: (256, 256 and 512 before, cut to keep the script in its time).
ED_ARCH, ED_SEED = "seamless-m4t-medium", 0
ED_B, ED_PROMPT, ED_GEN = 64, 128, 128
ED_MAX = ED_PROMPT + ED_GEN
#: The gates run on the first sequences and a random frontend: the
#: service's memory is exactly zero, so it shows nothing of `encode` or
#: of cross-attention.
ED_GATE_B = 8
ED_GATE_STEPS = 64
ED_PROFILE_STEPS = 32
#: qwen2-vl-72b (configs/qwen2_vl_72b.py) at full width (d_model 8,192, 64
#: query and 8 kv heads, head_dim 128, d_ff 29,568, QKV bias, M-RoPE
#: sections (16, 24, 24), vocabulary 152,064 padded to 153,600, untied)
#: and depth 4 of its 80 layers: ~145 GB in bf16 at full depth, ~12.1 GB
#: at 4 layers (the card holds 80).
VL_ARCH, VL_SEED, VL_LAYERS = "qwen2-vl-72b", 0, 4
VL_B, VL_PROMPT, VL_GEN = 64, 64, 64
VL_MAX = VL_PROMPT + VL_GEN
VL_PREFILL_B = 8
VL_PROFILE_STEPS = 16
#: The vision-position gate: a (t, h, w) patch grid of 4 x 16 x 16 = 1,024
#: tokens per sequence.
VL_GRID = (4, 16, 16)


class _FlashTap:
    """Stands in for `flash_attention_cuda` while an encoder-decoder model
    runs. Each call launches the kernel as the model's call would and is
    held against `flash_attention_plain` in float32 on the same q, k, v at
    the tight bf16 bound. By kind: a causal call is the decoder's
    self-attention in prefill; a non-causal call with as many queries as
    keys the encoder's self-attention, launched once more causal (its
    planted fault); any other non-causal call a cross-attention against
    the memory (prefill or a decode step), launched once more with the
    memory's last key dropped (its planted fault). Each fault must miss
    the bound."""

    KINDS = ("encoder", "self", "cross")

    def __init__(self, fa):
        self.fa, self.kernel = fa, fa.flash_attention_cuda
        self.ok = {k: [] for k in self.KINDS}
        self.fault = {k: [] for k in self.KINDS}
        self.kernels = {k: set() for k in self.KINDS}

    def __enter__(self):
        self.fa.flash_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda = self.kernel

    def __call__(self, q, k, v, *, causal=True, **kw):
        out = self.kernel(q, k, v, causal=causal, **kw)
        want, tol = _tight_tol(functools.partial(
            self.fa.flash_attention_plain, causal=causal, **kw), q, k, v)
        bad = None
        if causal:
            kind = "self"
        elif q.shape[2] == k.shape[2]:
            kind = "encoder"
            bad = self.kernel(q, k, v, causal=True, **kw)
        else:
            kind = "cross"
            bad = self.kernel(q, k[:, :, :-1].contiguous(),
                              v[:, :, :-1].contiguous(), causal=False, **kw)
        self.kernels[kind].add(self.fa.select_kernel(q, k))
        self.ok[kind].append(_excess(out, want, tol))
        if bad is not None:
            self.fault[kind].append(_excess(bad, want, tol))
        return out

    def result(self, torch) -> dict:
        res = {}
        for kind in self.KINDS:
            if not self.ok[kind]:
                continue
            ok = torch.stack(self.ok[kind]).tolist()
            fault = (torch.stack(self.fault[kind]).tolist()
                     if self.fault[kind] else [])
            res[kind] = {"calls": len(ok), "kernels": sorted(
                self.kernels[kind]), "max_err_over_tol": max(ok),
                "fault_calls": len(fault),
                "fault_caught": sum(f > 1.0 for f in fault),
                "fault_min_err_over_tol": min(fault) if fault else None}
        return res


def _check_flash_taps(tag, what, res, want) -> None:
    """``want``: kind -> (calls, kernel); every call within the bound,
    every planted fault past it."""
    faults = {"encoder": "causal", "cross": "one key short"}
    for kind, r in res.items():
        fault = (f"; planted fault ({faults[kind]}) caught in "
                 f"{r['fault_caught']} of {r['fault_calls']}, least err/tol "
                 f"{r['fault_min_err_over_tol']:.3f}" if r["fault_calls"]
                 else "")
        say(f"[{tag}] {what}, {kind} attention: {r['calls']} kernel calls "
            f"({', '.join(r['kernels'])}) vs plain in float32 on their own "
            f"inputs: max err/tol {r['max_err_over_tol']:.3f} at the tight "
            f"bf16 bound{fault}")
    got = {kind: (r["calls"], r["kernels"]) for kind, r in res.items()}
    if got != {kind: (n, [kernel]) for kind, (n, kernel) in want.items()}:
        fail(f"{tag} {what}: attention calls by kind {got}, expected {want}")
    for kind, r in res.items():
        if not r["max_err_over_tol"] <= 1.0:
            fail(f"{tag} {what}: a {kind} attention call misses the tight "
                 f"bf16 bound (err/tol {r['max_err_over_tol']:.3f})")
        if kind in faults and r["fault_caught"] != r["calls"]:
            fail(f"{tag} {what}: the tight bound does not catch the {kind} "
                 f"fault ({faults[kind]}) in every call ({r['fault_caught']}"
                 f" of {r['calls']})")


def _launched(torch) -> dict:
    torch.cuda.synchronize()
    return {k: v for k, v in read_counts().items() if v}


def phase_lm_encdec(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import ServeConfig, serve
    from repro_torch.models import (decode_step, encode, init_caches,
                                    init_model, prefill)
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import embedding_lookup, rms_norm

    tag = "lm_encdec"
    cfg = get_config(ED_ARCH)
    vocab, layers, enc_layers = (cfg.vocab_size, cfg.num_layers,
                                 cfg.encoder_layers)
    S, d, H, Dh = (cfg.encoder_seq_len, cfg.d_model, cfg.num_heads,
                   cfg.resolved_head_dim)

    # The service, timed, with the counters zeroed before and read after.
    serve_cfg = ServeConfig(arch=ED_ARCH, batch=ED_B, prompt_len=ED_PROMPT,
                            gen=ED_GEN, max_len=ED_MAX, reduced=False,
                            seed=ED_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _reset_plain_attention_calls()
    out = serve(serve_cfg, emit=say)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = read_counts(), _plain_attention_calls()
    decode_launches = counts.pop("flash_attention_decode")
    wgmma_launches = counts.pop("flash_attention_wgmma")
    say(f"[{tag}] path: serve({ED_ARCH}, batch {ED_B}, prompt {ED_PROMPT}, "
        f"gen {ED_GEN}, max_len {ED_MAX}, full width): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / ED_MAX * 1e3:.3f} "
        f"ms per step; wgmma launches {wgmma_launches} (the encode), decode "
        f"kernel launches {decode_launches} (self- and cross-attention), "
        f"other kernels {counts}, plain calls {plain}; peak device memory "
        f"{peak_gb:.2f} GB")
    if wgmma_launches != enc_layers:
        fail(f"the {tag} path launched the wgmma kernel {wgmma_launches} "
             f"times, expected {enc_layers} (one encode)")
    _check_service(tag, ED_ARCH, counts, plain, decode_launches,
                   2 * layers * ED_MAX, out["tokens"], (ED_B, ED_GEN), vocab,
                   torch)
    if not bool(torch.isfinite(out["logits"]).all()):
        fail(f"{tag}: non-finite logits at the service's last step")
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out
    torch.cuda.empty_cache()

    # The same weights (the service's seed) and prompts (its generator);
    # the float32 model widened from them; a random frontend.
    t0 = time.perf_counter()
    model = init_model(cfg, ED_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(ED_SEED + 1)
    prompts = torch.randint(0, vocab, (ED_B, ED_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()

    def count(*mods):
        return sum(p.numel() for m in mods for p in (
            m.parameters() if hasattr(m, "parameters") else [m]))
    parts = {"embed": count(model.embed), "lm_head": count(model.lm_head),
             "decoder": count(model.runs, model.final_norm),
             "encoder": count(model.encoder, model.enc_norm),
             "cross": count(model.cross_attn, model.ln_cross)}
    n_params = sum(parts.values())
    say(f"[{tag}] {ED_ARCH} full width: {enc_layers} encoder + {layers} "
        f"decoder layers, d_model {d}, heads {H} / kv {cfg.num_kv_heads}, "
        f"head_dim {Dh}, d_ff {cfg.d_ff}, memory {S} frames, vocab {vocab} "
        f"(padded {cfg.padded_vocab}), {n_params:,} parameters in bf16 "
        f"({parts}), init {time.perf_counter() - t0:.2f}s")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    fgen = torch.Generator(device="cuda").manual_seed(7)
    emb = torch.randn((ED_GATE_B, S, d), generator=fgen, device="cuda")
    toks = prompts[:ED_GATE_B]

    # Gate 1: encode, the wgmma kernel non-causal at Tq = Tk = S.
    reset_counts()
    _reset_plain_attention_calls()
    mem = encode(model, cfg, emb)
    launched, plain = _launched(torch), _plain_attention_calls()
    if launched != {"flash_attention_wgmma": enc_layers} or any(
            plain.values()):
        fail(f"{tag} encode launched {launched}, plain calls {plain}; "
             f"expected the wgmma kernel once per encoder layer")
    mem_plain = encode(model, cfg, emb, impl="plain")
    mem32 = encode(model32, cfg32, emb, impl="plain")
    enc = {"noise": (mem_plain.float() - mem32).abs().max().item(),
           "kernel_vs_ref": (mem.float() - mem32).abs().max().item(),
           "kernel_vs_plain": (mem.float() - mem_plain.float()).abs()
           .max().item(), "max_abs_memory": mem32.abs().max().item()}
    say(f"[{tag}] encode B={ED_GATE_B} S={S} (random frontend, std 1): "
        f"launches {launched}; memory kernel bf16 vs float32 max |d| "
        f"{enc['kernel_vs_ref']:.4e} against the plain bf16 path's "
        f"{enc['noise']:.4e} (the noise; max |memory| "
        f"{enc['max_abs_memory']:.4f}); kernel vs plain bf16 "
        f"{enc['kernel_vs_plain']:.4e}")
    if not enc["kernel_vs_ref"] <= LM_NOISE_FACTOR * enc["noise"]:
        fail(f"{tag} encode: kernel bf16 vs float32 {enc['kernel_vs_ref']:.4e}"
             f" over {LM_NOISE_FACTOR:g} x the noise {enc['noise']:.4e}")
    with _FlashTap(fa) as tap:
        encode(model, cfg, emb)
    enc_calls = tap.result(torch)
    _check_flash_taps(tag, "encode", enc_calls,
                      {"encoder": (enc_layers, "wgmma")})

    # The service's memory: a zero frontend encodes to exactly zero, and
    # every cross-attention output against it is exactly zero.
    zero_mem = encode(model, cfg, torch.zeros_like(emb))
    h = rms_norm(embedding_lookup(model.embed, toks[:, :1]).to(mem.dtype),
                 model.ln_cross[0], cfg.rmsnorm_eps)
    zero = {"max_abs_memory": zero_mem.abs().max().item(),
            "max_abs_cross": attn_lib.cross_attention_layer(
                model.cross_attn[0], h, zero_mem, cfg).abs().max().item(),
            "max_abs_cross_random": attn_lib.cross_attention_layer(
                model.cross_attn[0], h, mem, cfg).abs().max().item()}
    say(f"[{tag}] the service's zero frontend: max |memory| "
        f"{zero['max_abs_memory']}, max |cross output| (layer 0) "
        f"{zero['max_abs_cross']}; on the random frontend "
        f"{zero['max_abs_cross_random']:.4e}: the gates run on the random "
        "frontend")
    if zero["max_abs_memory"] != 0.0 or zero["max_abs_cross"] != 0.0:
        fail(f"{tag}: the zero frontend's memory or cross output is not "
             f"exactly zero ({zero})")
    del zero_mem, h

    # Gate 2: prefill(enc_emb=), 12 encoder + 12 self + 12 cross launches
    # of the wgmma kernel.
    reset_counts()
    _reset_plain_attention_calls()
    t0 = time.perf_counter()
    lpre = prefill(model, cfg, toks, emb)
    launched, plain = _launched(torch), _plain_attention_calls()
    prefill_s = time.perf_counter() - t0
    say(f"[{tag}] prefill B={ED_GATE_B} T={ED_PROMPT} (enc_emb S={S}): "
        f"{prefill_s:.3f}s, kernel launches {launched}, plain calls {plain}")
    if launched != {"flash_attention_wgmma": enc_layers + 2 * layers} or any(
            plain.values()):
        fail(f"{tag} prefill launched {launched}, plain calls {plain}; "
             f"expected the wgmma kernel {enc_layers + 2 * layers} times")
    with _FlashTap(fa) as tap:
        prefill(model, cfg, toks, emb)
    pre_calls = tap.result(torch)
    _check_flash_taps(tag, "prefill", pre_calls, {
        "encoder": (enc_layers, "wgmma"), "self": (layers, "wgmma"),
        "cross": (layers, "wgmma")})
    lpre_plain = prefill(model, cfg, toks, emb, impl="plain")
    lpre_ref = prefill(model32, cfg32, toks, emb, impl="plain")

    # Gate 3: teacher-forced decode over the first steps, with the kernels
    # (every self-attention call against plain on its cache, every cross
    # call against plain on the memory's k/v, each with its fault), with
    # the plain versions and in float32.
    dtap, ftap = _DecodeTap(fa), _FlashTap(fa)
    kc, pc = (init_caches(cfg, ED_GATE_B, ED_PROMPT, device="cuda")
              for _ in range(2))
    rc = init_caches(cfg32, ED_GATE_B, ED_PROMPT, device="cuda")
    k_vs_p, k_vs_ref, p_vs_ref = (_Logits(torch, vocab) for _ in range(3))
    reset_counts()
    _reset_plain_attention_calls()
    for i in range(ED_GATE_STEPS):
        tok = toks[:, i:i + 1]
        dtap.length = i + 1
        with dtap, ftap:
            lk, kc = decode_step(model, cfg, kc, tok, i, mem)
        lp, pc = decode_step(model, cfg, pc, tok, i, mem_plain, impl="plain")
        lr, rc = decode_step(model32, cfg32, rc, tok, i, mem32, impl="plain")
        k_vs_p.add(lk, lp)
        k_vs_ref.add(lk, lr)
        p_vs_ref.add(lp, lr)
    launched, plain = _launched(torch), _plain_attention_calls()
    n = layers * ED_GATE_STEPS
    if launched != {"flash_attention_decode": 4 * n} or plain != {
            "blockwise_causal_attention": 0, "decode_attention": 2 * n,
            "chunked_cross": 2 * n}:
        fail(f"{tag} decode gate run: kernel launches {launched}, plain "
             f"calls {plain}; expected {4 * n} decode launches (self, cross "
             f"and their faults) and {2 * n} plain calls of each kind")
    self_check = dtap.result(torch)
    _say_layer_taps(tag, f"the first {ED_GATE_STEPS} steps, self-attention",
                    self_check, layers)
    _check_layer_taps(tag, ED_ARCH, self_check)
    cross_calls = ftap.result(torch)
    _check_flash_taps(tag, f"the first {ED_GATE_STEPS} decode steps",
                      cross_calls, {"cross": (n, "decode")})
    p_vs_ref = p_vs_ref.result()
    noise = p_vs_ref["max_abs_err"]
    what = f"first {ED_GATE_STEPS} teacher-forced steps"
    _say_logits(f"{what}, plain bf16 vs float32 (the noise)", p_vs_ref, tag)
    kernel_vs_ref = k_vs_ref.result(noise)
    _check_noise(f"{what}, kernel bf16", kernel_vs_ref, noise, tag)
    kernel_vs_plain = k_vs_p.result()
    _check_ties(f"{what}, kernel vs plain bf16", kernel_vs_plain, noise, tag)
    del pc, rc, lp, lr

    # Gate 4: the decode at the last prompt position against prefill.
    for i in range(ED_GATE_STEPS, ED_PROMPT):
        lk, kc = decode_step(model, cfg, kc, toks[:, i:i + 1], i, mem)
    del model32, mem32, kc
    torch.cuda.empty_cache()
    results = {}
    for name, got in (("plain prefill", lpre_plain), ("prefill", lpre),
                      ("decode", lk)):
        acc = _Logits(torch, vocab)
        acc.add(got, lpre_ref)
        results[name] = acc
    noise255 = results.pop("plain prefill").result()["max_abs_err"]
    what = f"position {ED_PROMPT - 1}"
    say(f"[{tag}] {what}: plain bf16 prefill vs float32 (the noise) "
        f"{noise255:.4e}")
    prefill_vs_ref = results["prefill"].result(noise255)
    _check_noise(f"{what}, prefill (wgmma) bf16", prefill_vs_ref, noise255,
                 tag)
    decode_vs_ref = results["decode"].result(noise255)
    _check_noise(f"{what}, decode (split-K) bf16", decode_vs_ref, noise255,
                 tag)
    acc = _Logits(torch, vocab)
    acc.add(lpre, lk)
    prefill_vs_decode = acc.result()
    _check_ties(f"{what}, prefill vs decode bf16", prefill_vs_decode,
                noise255, tag)
    del lpre, lpre_plain, lpre_ref, lk, mem, mem_plain, emb
    torch.cuda.empty_cache()

    # Device busy over the service's steps: its zero memory, the prompt
    # teacher-forced, then greedy steps profiled.
    mem64 = encode(model, cfg, torch.zeros((ED_B, S, d), device="cuda"))
    caches = init_caches(cfg, ED_B, ED_PROMPT + ED_PROFILE_STEPS,
                         device="cuda")
    for i in range(ED_PROMPT):
        lk, caches = decode_step(model, cfg, caches, prompts[:, i:i + 1], i,
                                 mem64)
    state = {"caches": caches, "tok": lk[:, :, :vocab].argmax(-1)}
    del caches

    def step(j):
        logits, state["caches"] = decode_step(
            model, cfg, state["caches"], state["tok"], ED_PROMPT + j, mem64)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    kv_label = f"memory K/V projection [{ED_B}, {S}, {d}]"
    profile_res = _lm_profile(torch, step, ED_PROFILE_STEPS, tag, named={
        kv_label: ("aten::linear", (ED_B, S, d))})
    _say_profile(tag, f"B={ED_B}, positions {ED_PROMPT}.."
                 f"{ED_PROMPT + ED_PROFILE_STEPS - 1}", profile_res)
    del state, lk
    torch.cuda.empty_cache()

    # One layer's memory K/V projection (the reference recomputes it in
    # every layer of every step) by CUDA graph, beside its bound.
    xa = model.cross_attn[0]
    proj = lambda m: (F.linear(m, xa.wk.weight),  # noqa: E731
                      F.linear(m, xa.wv.weight))
    kv_ms = _graph_ms(torch, proj, [(mem64,)], iters=10)
    kv_flops = 2 * 2 * ED_B * S * d * cfg.num_kv_heads * Dh
    kv_bytes = 2 * (ED_B * S * d + 2 * d * cfg.num_kv_heads * Dh
                    + 2 * ED_B * S * cfg.num_kv_heads * Dh)
    kv_bound, kv_by = _bound(kv_bytes, kv_flops, "bfloat16")
    kv = {"graph_ms": kv_ms, "bound_ms": kv_bound, "bound_by": kv_by,
          "per_step_ms": kv_ms * layers,
          "tflops": kv_flops / kv_ms / 1e9}
    say(f"[time] {tag} memory K/V projection B={ED_B} S={S} d={d} (one "
        f"layer, two GEMMs) {kv_ms * 1e3:.2f} us device (CUDA graph), bound "
        f"{kv_bound * 1e3:.2f} us ({kv_by}), {kv['tflops']:.1f} TFLOP/s; x "
        f"{layers} layers = {kv['per_step_ms']:.3f} ms per decode step "
        f"(device busy {profile_res['busy_ms_per_step']:.3f} ms per step)")
    del mem64, model, prompts
    torch.cuda.empty_cache()

    # Kernel times at the path's shapes.
    g = torch.Generator(device="cuda").manual_seed(8)
    Hkv = cfg.num_kv_heads
    encoder_time = _prefill_time(torch, fa, ED_B, H, Hkv, S, Dh, g,
                                 causal=False)
    _say_lm_time(f"{tag} encoder attention B={ED_B} Hq={H} Hkv={Hkv} T={S} "
                 f"Dh={Dh} bf16 non-causal: {encoder_time['kernel']} kernel",
                 encoder_time)
    cross_prefill_time = _prefill_time(torch, fa, ED_GATE_B, H, Hkv,
                                       ED_PROMPT, Dh, g, causal=False, Tk=S)
    _say_lm_time(f"{tag} cross attention prefill B={ED_GATE_B} Hq={H} "
                 f"Hkv={Hkv} Tq={ED_PROMPT} Tk={S} Dh={Dh} bf16: "
                 f"{cross_prefill_time['kernel']} kernel", cross_prefill_time)
    cross_decode_time = _prefill_time(torch, fa, ED_B, H, Hkv, 1, Dh, g,
                                      causal=False, Tk=S)
    _say_lm_time(f"{tag} cross attention decode B={ED_B} Hq={H} Hkv={Hkv} "
                 f"Tq=1 Tk={S} Dh={Dh} bf16 (1 row per kv head, k/v no "
                 f"cache): {cross_decode_time['kernel']} kernel",
                 cross_decode_time)
    self_decode_time = _decode_time(torch, fa, ED_B, H, Hkv, ED_MAX, Dh, g)
    _say_lm_time(f"{tag} self attention decode B={ED_B} Hq={H} Hkv={Hkv} "
                 f"L={ED_MAX} Dh={Dh} bf16: split-K kernel", self_decode_time)
    return {"arch": ED_ARCH, "parameters": n_params, "parameters_by_part":
            parts, "peak_memory_gb": peak_gb, "tok_per_s": tok_per_s,
            "seconds": seconds, "ms_per_step": seconds / ED_MAX * 1e3,
            "encode": enc, "encode_calls": enc_calls, "zero_frontend": zero,
            "prefill_s": prefill_s, "prefill_calls": pre_calls,
            "self_check": self_check, "cross_calls": cross_calls,
            "noise": noise, "plain_vs_ref": p_vs_ref,
            "kernel_vs_ref": kernel_vs_ref, "kernel_vs_plain": kernel_vs_plain,
            "noise_255": noise255, "prefill_vs_ref": prefill_vs_ref,
            "decode_vs_ref": decode_vs_ref,
            "prefill_vs_decode": prefill_vs_decode, "profile": profile_res,
            "memory_kv_projection": kv,
            "launches_by_path": {
                "lm_encdec": wgmma_launches + decode_launches,
                "lm_encdec_prefill": enc_layers + 2 * layers},
            "service_launches": {"flash_attention_wgmma": wgmma_launches,
                                 "flash_attention_decode": decode_launches},
            "encoder_attention": encoder_time,
            "prefill_attention": cross_prefill_time,
            "decode_attention": cross_decode_time,
            "self_decode_attention": self_decode_time}


class _CaptureTap:
    """Stands in for `flash_attention_cuda`: launches the kernel and keeps
    each call's ``(q, k, v, out)``."""

    def __init__(self, fa):
        self.fa, self.kernel, self.calls = fa, fa.flash_attention_cuda, []

    def __enter__(self):
        self.fa.flash_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda = self.kernel

    def __call__(self, q, k, v, **kw):
        out = self.kernel(q, k, v, **kw)
        self.calls.append((q, k, v, out, kw))
        return out


def phase_lm_mrope(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_caches, init_model
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import rope as rope_lib
    from repro_torch.models.layers import rms_norm

    tag = "lm_mrope"
    full = get_config(VL_ARCH)
    cfg = dataclasses.replace(full, num_layers=VL_LAYERS)
    vocab, layers = cfg.vocab_size, cfg.num_layers
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    # The service's loop (`generate`) on random weights from the seed and
    # prompts drawn as `serve` draws them, with the counters zeroed before
    # and read after.
    t0 = time.perf_counter()
    model = init_model(cfg, VL_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(VL_SEED + 1)
    prompts = torch.randint(0, vocab, (VL_B, VL_PROMPT), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] {VL_ARCH} full width, depth {layers} of "
        f"{full.num_layers}: d_model {cfg.d_model}, heads {Hq} (padded "
        f"{cfg.padded_heads}) / kv {Hkv}, head_dim {Dh}, d_ff {cfg.d_ff}, "
        f"QKV bias {cfg.qkv_bias}, M-RoPE sections {cfg.mrope_sections}, "
        f"vocab {vocab} (padded {cfg.padded_vocab}), {n_params:,} parameters "
        f"in bf16, init {time.perf_counter() - t0:.2f}s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _reset_plain_attention_calls()
    out = generate(model, cfg, prompts, VL_GEN, VL_MAX)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts, plain = read_counts(), _plain_attention_calls()
    decode_launches = counts.pop("flash_attention_decode")
    say(f"[{tag}] path: generate({VL_ARCH} depth {layers}, batch {VL_B}, "
        f"prompt {VL_PROMPT}, gen {VL_GEN}, max_len {VL_MAX}): "
        f"{out['tok_per_s']:.1f} tok/s, {out['seconds'] / VL_MAX * 1e3:.3f} "
        f"ms per step; decode kernel launches {decode_launches} ("
        f"{Hq // Hkv} rows per kv head), other kernels {counts}, plain "
        f"calls {plain}; peak device memory {peak_gb:.2f} GB")
    tokens = out["tokens"]
    _check_service(tag, VL_ARCH, counts, plain, decode_launches,
                   layers * VL_MAX, tokens, (VL_B, VL_GEN), vocab, torch)
    tok_per_s, seconds = out["tok_per_s"], out["seconds"]
    del out

    # Every decode-kernel call, teacher-forced over the same positions,
    # against plain with the `length - 1` fault.
    seq = torch.cat([prompts, tokens.long()], dim=1)
    tap = _DecodeTap(fa)
    caches = init_caches(cfg, VL_B, VL_MAX + VL_PROFILE_STEPS, device="cuda")
    with tap:
        for i in range(VL_MAX):
            tap.length = i + 1
            lk, caches = decode_step(model, cfg, caches, seq[:, i:i + 1], i)
    layer_check = tap.result(torch)
    _say_layer_taps(tag, f"{VL_ARCH}, all {VL_MAX} steps", layer_check,
                    layers)
    _check_layer_taps(tag, VL_ARCH, layer_check)
    if not bool(torch.isfinite(lk).all()):
        fail(f"{tag} {VL_ARCH}: non-finite decode logits")

    # Device busy over decode steps past the service's last.
    state = {"caches": caches, "tok": lk[:, :, :vocab].argmax(-1)}
    del caches

    def step(j):
        logits, state["caches"] = decode_step(model, cfg, state["caches"],
                                              state["tok"], VL_MAX + j)
        state["tok"] = logits[:, :, :vocab].argmax(-1)

    profile_res = _lm_profile(torch, step, VL_PROFILE_STEPS, tag)
    _say_profile(tag, f"{VL_ARCH}, positions {VL_MAX}.."
                 f"{VL_MAX + VL_PROFILE_STEPS - 1}", profile_res)
    del state, lk
    torch.cuda.empty_cache()

    prefill_res = _prefill_gate(torch, tag, VL_ARCH, model, cfg,
                                seq[:VL_PREFILL_B], 0.0)

    # Layer 0's attention sublayer on vision positions (three rows that
    # differ), where the sections act: the kernel against plain at the
    # tight bound; the same input on text positions (rows equal) lands far
    # outside that bound.
    block = model.runs[0][0]
    gt, gh, gw = VL_GRID
    T = gt * gh * gw
    xg = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((VL_PREFILL_B, T, cfg.d_model), generator=xg,
                    device="cuda").to(torch.bfloat16)
    h = rms_norm(x, block.ln1, cfg.rmsnorm_eps)
    vision = rope_lib.vision_mrope_positions(VL_PREFILL_B, gt, gh, gw,
                                             device="cuda")
    text = rope_lib.text_mrope_positions(VL_PREFILL_B, T, device="cuda")
    reset_counts()
    _reset_plain_attention_calls()
    with torch.no_grad(), _CaptureTap(fa) as cap:
        attn_lib.attention_layer(block.attn, h, cfg, vision)
        attn_lib.attention_layer(block.attn, h, cfg, text)
    launched, plain = _launched(torch), _plain_attention_calls()
    (q, k, v, got, kw), (_, _, _, got_text, _) = cap.calls
    want, tol = _tight_tol(functools.partial(fa.flash_attention_plain, **kw),
                           q, k, v)
    vis = {"T": T, "grid": list(VL_GRID), "launches": launched,
           "rows_differ": bool((vision[0] != vision[1]).any()
                               and (vision[1] != vision[2]).any()),
           "err_over_tol": _excess(got, want, tol).item(),
           "text_err_over_tol": _excess(got_text, want, tol).item()}
    say(f"[{tag}] layer 0 attention on vision positions (grid "
        f"{gt}x{gh}x{gw}, T={T}, B={VL_PREFILL_B}; rows differ "
        f"{vis['rows_differ']}): launches {launched}, kernel vs plain in "
        f"float32 err/tol {vis['err_over_tol']:.3f} at the tight bf16 bound; "
        f"the same input on text positions (rows equal) err/tol "
        f"{vis['text_err_over_tol']:.1f}")
    if launched != {"flash_attention_wgmma": 2} or any(plain.values()):
        fail(f"{tag} vision attention launched {launched}, plain {plain}")
    if not vis["rows_differ"]:
        fail(f"{tag}: the vision positions' rows do not differ")
    if not vis["err_over_tol"] <= 1.0:
        fail(f"{tag}: the vision-position attention misses the tight bound "
             f"(err/tol {vis['err_over_tol']:.3f})")
    if not vis["text_err_over_tol"] > 1.0:
        fail(f"{tag}: text positions give the vision positions' output "
             f"(err/tol {vis['text_err_over_tol']:.3f}): the sections do not "
             "act")
    del model, prompts, seq, x, h, cap, q, k, v, got, got_text, want, tol
    torch.cuda.empty_cache()

    # Kernel times at the path's shapes.
    g = torch.Generator(device="cuda").manual_seed(10)
    decode_time = _decode_time(torch, fa, VL_B, Hq, Hkv, VL_MAX, Dh, g)
    _say_lm_time(f"{tag} decode attention B={VL_B} Hq={Hq} Hkv={Hkv} "
                 f"L={VL_MAX} Dh={Dh} bf16 ({Hq // Hkv} rows per kv head): "
                 "split-K kernel", decode_time)
    prefill_time = _prefill_time(torch, fa, VL_PREFILL_B, Hq, Hkv, VL_MAX,
                                 Dh, g)
    _say_lm_time(f"{tag} prefill attention B={VL_PREFILL_B} Hq={Hq} "
                 f"Hkv={Hkv} T={VL_MAX} Dh={Dh} bf16 causal: "
                 f"{prefill_time['kernel']} kernel", prefill_time)
    return {"arch": VL_ARCH, "layers": layers, "parameters": n_params,
            "peak_memory_gb": peak_gb, "tok_per_s": tok_per_s,
            "seconds": seconds, "ms_per_step": seconds / VL_MAX * 1e3,
            "layer_check": layer_check, "profile": profile_res,
            "prefill": prefill_res, "vision": vis,
            "launches_by_path": {"lm_mrope": decode_launches,
                                 "lm_mrope_prefill": prefill_res["launches"]},
            "decode_attention": decode_time,
            "prefill_attention": prefill_time}


#: [train]: the full-width run (the trainer's own B and T), its steps, and
#: the steps timed one by one (a host-bound step's time swings with the
#: host's load: the median is reported) and profiled after it.
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS = 10
TRAIN_TIMED_STEPS = 5
TRAIN_PROFILE_STEPS = 3
#: The bf16 gradients' tolerance is this factor times their distance to
#: float32 on a calibration batch (the pipeline's batch 1); the gate runs
#: on batch 0, the first training batch.
TRAIN_GRAD_FACTOR = 2.0
#: bf16 loss at step 0 against float32: 2^-7 relative (a loss of ~12
#: carries bf16 logits of ~8 significant bits).
TRAIN_LOSS_BOUND = 2.0 ** -7
#: Five families card vs CPU: reduced configs, float32, this many steps
#: at B x T tokens; the checkpoint resume on the card at the loop's own.
TRAIN_FAMILIES = ("qwen2-1.5b", "hymba-1.5b", "deepseek-moe-16b",
                  "xlstm-350m", "seamless-m4t-medium")
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_B, TRAIN_FAMILY_T = 3, 2, 64


def _train_guards(torch) -> dict:
    """Every kernel wrapper refuses a CUDA input that requires grad while
    grad mode is on (a RuntimeError), and runs it under ``no_grad``."""
    from repro_torch.core.types import FilteringElement, SmoothingElement
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.kalman_combine import kalman_combine as kc
    from repro_torch.kernels.ssm_scan import ssm_scan as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype).requires_grad_(True)

    q, k, v = (rand(1, 2, 64, 64, dtype=torch.bfloat16) for _ in range(3))
    a, b = rand(2, 16, 8), rand(2, 16, 8)
    eye = torch.eye(3, device=dev).expand(4, 3, 3).contiguous()
    fe = FilteringElement(A=eye, b=rand(4, 3), C=eye, eta=rand(4, 3), J=eye)
    se = SmoothingElement(E=eye, g=rand(4, 3), L=eye)
    length = torch.tensor([64], dtype=torch.int32, device=dev)
    calls = {
        "flash_attention_cuda": lambda: fa.flash_attention_cuda(q, k, v),
        "decode_attention_cuda": lambda: fa.decode_attention_cuda(
            q[:, :, :1].contiguous(), k, v, length),
        "ssm_scan_cuda": lambda: ss.ssm_scan_cuda(a, b),
        "filtering_combine_cuda": lambda: kc.filtering_combine_cuda(fe, fe),
        "smoothing_combine_cuda": lambda: kc.smoothing_combine_cuda(se, se)}
    out = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            out[name] = str(e).split(":")[0]
        else:
            fail(f"[train] {name} ran on inputs that require grad")
        with torch.no_grad():
            call()
    say(f"[train] every kernel wrapper raises under grad: {sorted(out)}")
    return out


def _rel_errs(torch, got: dict, want: dict) -> dict:
    """Per tensor ``||got - want|| / ||want||`` in float32."""
    return {n: float(torch.linalg.vector_norm(got[n].float() - w.float())
                     / torch.linalg.vector_norm(w.float()).clamp_min(1e-30))
            for n, w in want.items()}


def _train_grad_check(torch, model, cfg, pipe) -> dict:
    """Step-0 gradients of the bf16 model against the same weights in
    float32 (TF32 off), on the card: every parameter has a finite, nonzero
    gradient; the per-tensor relative distance on batch 0 within
    ``TRAIN_GRAD_FACTOR`` x its largest value on batch 1; the same check
    with attention's output detached (``wq``/``wk``/``wv``/``wo`` and the
    QKV biases then get no gradient) missing it in every such tensor; the
    two losses within ``TRAIN_LOSS_BOUND``."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention as attn_lib

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(i).items()} for i in (0, 1)]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    res, errs = {}, {}
    for i, batch in enumerate(batches):
        loss32, _, g32 = loss_and_grads(model32, cfg32, batch)
        loss, _, g = loss_and_grads(model, cfg, batch)
        if i == 0:
            dead = [n for n, t in g.items() if not bool(
                torch.isfinite(t).all()) or not bool((t != 0).any())]
            if dead:
                fail(f"[train] {len(dead)} parameters have no finite "
                     f"nonzero gradient: {dead[:4]}")
            res.update(loss_bf16=float(loss), loss_f32=float(loss32))
            orig = attn_lib.attention_layer

            def detached(*a, **kw):
                out, cache = orig(*a, **kw)
                return out.detach(), cache

            attn_lib.attention_layer = detached
            try:
                _, _, g_fault = loss_and_grads(model, cfg, batch)
            finally:
                attn_lib.attention_layer = orig
            fault = _rel_errs(torch, g_fault, g32)
            del g_fault
        errs[i] = _rel_errs(torch, g, g32)
        del g, g32
    del model32
    torch.cuda.empty_cache()
    noise = max(errs[1].values())
    tol = TRAIN_GRAD_FACTOR * noise
    worst = max(errs[0], key=errs[0].get)
    attn = [n for n in fault if ".attn." in n]
    caught = [n for n in attn if fault[n] > tol]
    rel_loss = abs(res["loss_bf16"] - res["loss_f32"]) / abs(res["loss_f32"])
    res.update(tol=tol, calibration_max=noise,
               calibration_worst=max(errs[1], key=errs[1].get),
               max_rel_err=errs[0][worst], worst=worst,
               median_rel_err=float(sorted(errs[0].values())[
                   len(errs[0]) // 2]),
               fault_caught=len(caught), fault_tensors=len(attn),
               fault_least=min(fault[n] for n in attn),
               loss_rel_err=rel_loss, tensors=len(errs[0]),
               seconds=time.perf_counter() - t0)
    say(f"[train] step-0 gradients, bf16 vs float32 on the card "
        f"({res['tensors']} tensors): tol {tol:.4g} = "
        f"{TRAIN_GRAD_FACTOR} x the largest relative distance on "
        f"calibration batch 1 ({noise:.4g}, {res['calibration_worst']}); "
        f"batch 0 max {res['max_rel_err']:.4g} ({worst}), median "
        f"{res['median_rel_err']:.4g}; attention output detached: caught "
        f"in {len(caught)} of {len(attn)} attention tensors (least "
        f"{res['fault_least']:.4g}); loss bf16 {res['loss_bf16']:.6f} vs "
        f"float32 {res['loss_f32']:.6f} (rel {rel_loss:.3g}, bound "
        f"{TRAIN_LOSS_BOUND:.4g}); {res['seconds']:.1f} s")
    if not res["max_rel_err"] <= tol:
        fail(f"[train] bf16 gradient of {worst} is {res['max_rel_err']:.4g} "
             f"from float32, over the tolerance {tol:.4g}")
    if len(caught) != len(attn) or not attn:
        fail(f"[train] the detached attention output passes the gradient "
             f"gate in {len(attn) - len(caught)} tensors")
    if not rel_loss <= TRAIN_LOSS_BOUND:
        fail(f"[train] step-0 loss bf16 vs float32 {rel_loss:.3g} over "
             f"{TRAIN_LOSS_BOUND:.3g}")
    return res


def _train_full_width(torch) -> dict:
    """qwen2-1.5b at full width through `train()`, then the timed and
    profiled steps and the AdamW update alone."""
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.launch import train as tr
    from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig, adamw_update

    dev = torch.device("cuda")
    loop = tr.TrainLoopConfig(arch=TRAIN_ARCH, reduced=False, seq_len=128,
                              global_batch=8, steps=TRAIN_STEPS, lr=3e-4,
                              warmup_steps=2, log_every=1, device="cuda")
    cfg = tr.loop_model_config(loop)
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    t0 = time.perf_counter()
    model = init_model(cfg, loop.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[train] {cfg.name} at full width: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} query heads padded to "
        f"{cfg.padded_heads}, {cfg.num_kv_heads} kv, vocabulary "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab}; {n_params:,} "
        f"parameters in {cfg.param_dtype}, float32 moments; B "
        f"{loop.global_batch}, T {loop.seq_len}, remat {cfg.remat}; built "
        f"in {init_s:.1f} s")
    res = {"params": n_params, "grads": _train_grad_check(
        torch, model, cfg, pipe)}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lines = []
    t1 = time.perf_counter()
    out = tr.train(loop, emit=lines.append, model=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    say(f"[train] path: train({TRAIN_ARCH}, reduced=False, steps "
        f"{TRAIN_STEPS}, seq_len {loop.seq_len}, global_batch "
        f"{loop.global_batch}, lr {loop.lr}, warmup {loop.warmup_steps}) "
        f"in {wall:.2f} s; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; kernel launches {counts}; peak {peak:.2f} GB")
    if any(counts.values()):
        fail(f"[train] training launched kernels: {counts}")
    if len(losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses):
        fail(f"[train] losses not finite over {TRAIN_STEPS} steps: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"[train] the loss did not fall: {losses[0]} -> {losses[-1]}")
    res.update(losses=losses, train_wall_s=wall, launches=counts,
               peak_gb=peak)

    # The same step, timed and profiled, on the trained weights.
    step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=loop.lr),
                           total_steps=TRAIN_STEPS,
                           warmup_steps=loop.warmup_steps)
    state = init_train_state(model)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(TRAIN_STEPS).items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        t1 = time.perf_counter()
        state, met = step(state, batch)
        float(met["loss"])
        step_ms.append((time.perf_counter() - t1) * 1e3)
    ms = sorted(step_ms)[TRAIN_TIMED_STEPS // 2]
    holder = {"state": state}

    def one(j):
        holder["state"], _ = step(holder["state"], batch)

    prof = _lm_profile(torch, one, TRAIN_PROFILE_STEPS, "train")
    tokens = loop.global_batch * loop.seq_len
    # AdamW alone on the last gradients (CUDA events, back-to-back).
    _, _, grads = loss_and_grads(model, cfg, batch)
    params = dict(model.named_parameters())
    opt = holder["state"].opt
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    adamw_update(AdamWConfig(lr=0.0), params, grads, opt)
    ev[0].record()
    for _ in range(TRAIN_PROFILE_STEPS):
        _, opt, _ = adamw_update(AdamWConfig(lr=0.0), params, grads, opt)
    ev[1].record()
    torch.cuda.synchronize()
    adamw_ms = ev[0].elapsed_time(ev[1]) / TRAIN_PROFILE_STEPS
    adamw_bytes = sum(p.numel() * (2 * p.element_size() + 16
                                   + g.element_size())
                      for p, g in zip(params.values(), grads.values()))
    flops = 8 * n_params * tokens
    res.update(ms_per_step=ms, step_ms=step_ms,
               tokens_per_s=tokens / ms * 1e3,
               adamw_ms=adamw_ms,
               adamw_bound_ms=_bound(adamw_bytes, 0, "bfloat16")[0],
               adamw_tensors=len(params), flops_per_step=flops,
               flops_bound_ms=_bound(0, flops, "bfloat16")[0], profile=prof,
               seconds=time.perf_counter() - t0)
    say(f"[train] step at full width: {ms:.2f} ms per step (median of "
        f"{TRAIN_TIMED_STEPS}: " + ", ".join(f"{t:.1f}" for t in step_ms)
        + f"), "
        f"{res['tokens_per_s']:.1f} tokens/s ({tokens} tokens per step; "
        f"8 x params x tokens = {flops / 1e12:.2f} TFLOP, "
        f"{res['flops_bound_ms']:.2f} ms at the bf16 peak); AdamW update "
        f"alone {adamw_ms:.2f} ms over {len(params)} tensors (bound "
        f"{res['adamw_bound_ms']:.2f} ms: {adamw_bytes / 1e9:.2f} GB)")
    say(f"[train] profile of {prof['steps']} train steps: wall "
        f"{prof['wall_s'] * 1e3:.1f} ms (profiled), device busy "
        f"{prof['busy_ms_per_step']:.2f} ms per step, "
        f"{prof['launches_per_step']:.1f} launches per step, idle "
        f"{prof['idle_share']:.1%}; top: " + "; ".join(
            f"{k[:48]} {t:.2f} ms x{n}" for k, t, n in prof["top"]))
    del model, state, holder, grads, params, opt
    torch.cuda.empty_cache()
    return res


def _train_families(torch) -> dict:
    """Each family's reduced config trains ``TRAIN_FAMILY_STEPS`` steps on
    the card and on the CPU from the same weights and batches (float32,
    TF32 off; the encoder-decoder on a seeded random frontend): per-step
    loss and grad_norm at the float32 TOL."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = reduced_config(get_config(arch))
        pipe = SyntheticTokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_FAMILY_T,
            global_batch=TRAIN_FAMILY_B, seed=0))
        rng = np.random.default_rng(0)
        enc = rng.standard_normal((TRAIN_FAMILY_B, cfg.encoder_seq_len,
                                   cfg.d_model)).astype(np.float32) \
            if cfg.encoder_layers else None
        cpu_model = init_model(cfg, 0, device="cpu")
        runs = {}
        for dev in ("cuda", "cpu"):
            state = init_train_state(copy.deepcopy(cpu_model).to(dev))
            step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=2e-2),
                                   total_steps=TRAIN_FAMILY_STEPS,
                                   warmup_steps=1)
            t0 = time.perf_counter()
            rows = []
            for s in range(TRAIN_FAMILY_STEPS):
                batch = pipe.batch_at(s)
                if enc is not None:
                    batch = dict(batch, enc_emb=enc)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                state, met = step(state, batch)
                rows.append((float(met["loss"]), float(met["grad_norm"])))
            runs[dev] = (rows, time.perf_counter() - t0)
        got, want = (np.array(runs[d][0]) for d in ("cuda", "cpu"))
        err = float(np.max(np.abs(got - want) / (TOL["float32"]["atol"]
                    + TOL["float32"]["rtol"] * np.abs(want))))
        out[arch] = {"card": runs["cuda"][0], "cpu": runs["cpu"][0],
                     "err_over_tol": err, "card_s": runs["cuda"][1],
                     "cpu_s": runs["cpu"][1]}
        say(f"[train] {cfg.name}: {TRAIN_FAMILY_STEPS} float32 steps "
            f"(B {TRAIN_FAMILY_B}, T {TRAIN_FAMILY_T}) card vs CPU: losses "
            + ", ".join(f"{a:.6f}/{b:.6f}" for (a, _), (b, _) in zip(
                runs["cuda"][0], runs["cpu"][0]))
            + f"; grad_norm last {got[-1, 1]:.6f}/{want[-1, 1]:.6f}; "
            f"max err/tol {err:.3g} ({runs['cuda'][1]:.1f} s / "
            f"{runs['cpu'][1]:.1f} s)")
        if not err <= 1.0:
            fail(f"[train] {arch}: card and CPU training differ "
                 f"(err/tol {err:.3g})")
    return out


def _train_resume(torch) -> dict:
    """Checkpoint resume on the card (reduced qwen2, float32): 6 steps
    checkpointed every 3, then a second `train()` to 10, against an
    uninterrupted 10-step run; a bf16 train state round-trips bit for
    bit; the card's checkpoint restores onto the CPU."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import train as tr
    from repro_torch.launch.steps import init_train_state
    from repro_torch.models import init_model

    t0 = time.perf_counter()
    kw = dict(arch=TRAIN_ARCH, lr=2e-2, log_every=100, device="cuda")
    quiet = lambda m: None  # noqa: E731
    base = tr.train(tr.TrainLoopConfig(steps=10, **kw), emit=quiet)
    OUT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        tr.train(tr.TrainLoopConfig(steps=6, ckpt_dir=d, ckpt_every=3, **kw),
                 emit=quiet)
        cfg = tr.loop_model_config(tr.TrainLoopConfig(**kw))
        model = init_model(cfg, 5, device="cuda")
        log = []
        second = tr.train(tr.TrainLoopConfig(steps=10, ckpt_dir=d,
                                             ckpt_every=3, **kw),
                          emit=log.append, model=model)
        if "[train] resumed from step 6" not in log:
            fail(f"[train] the second run did not resume: {log}")
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(second["losses"], base["losses"][6:]))
        mgr = CheckpointManager(d)
        cpu_state = init_train_state(init_model(cfg, 1, device="cpu"))
        mgr.restore(cpu_state)
        card = dict(model.named_parameters())
        onto_cpu = all(torch.equal(p, card[n].cpu()) for n, p in
                       cpu_state.params.named_parameters())
        bf = reduced_config(get_config(TRAIN_ARCH), param_dtype="bfloat16")
        state = init_train_state(init_model(bf, 0, device="cuda"))
        for m in state.opt.m.values():
            m.normal_()
        mgr.save(99, state)
        other = init_train_state(init_model(bf, 1, device="cuda"))
        mgr.restore(other, step=99)
        bitwise = all(torch.equal(p.view(torch.int16), q.view(torch.int16))
                      for p, q in zip(state.params.parameters(),
                                      other.params.parameters())) and all(
            torch.equal(state.opt.m[n], other.opt.m[n]) for n in state.opt.m)
    say(f"[train] resume on the card ({cfg.name}, float32): steps 6-9 "
        f"after resuming from step 6 vs uninterrupted: max rel "
        f"{rel:.3g} (bound 1e-6); bf16 train state round trip bit-exact "
        f"{bitwise}; card checkpoint restored onto the CPU equal {onto_cpu}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not rel <= 1e-6:
        fail(f"[train] the resumed run differs from the uninterrupted one "
             f"by {rel:.3g}")
    if not (bitwise and onto_cpu):
        fail(f"[train] checkpoint round trip: bf16 bit-exact {bitwise}, "
             f"card onto CPU {onto_cpu}")
    return {"max_rel": rel, "losses": second["losses"],
            "seconds": time.perf_counter() - t0,
            "uninterrupted": base["losses"], "bf16_bitwise": bitwise,
            "card_onto_cpu": onto_cpu}


def phase_train(torch) -> dict:
    """``[train]``: training on one device (see the module docstring)."""
    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    try:
        guards = _train_guards(torch)
        reset_counts()
        full = _train_full_width(torch)
        families = _train_families(torch)
        resume = _train_resume(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    counts = read_counts()
    if any(counts.values()):
        fail(f"[train] the training paths launched kernels: {counts}")
    seconds = time.perf_counter() - t0
    say(f"[train] phase done in {seconds:.1f} s (full width "
        f"{full['seconds']:.1f} s, five families "
        f"{sum(f['card_s'] + f['cpu_s'] for f in families.values()):.1f} s "
        f"of steps, resume {resume['seconds']:.1f} s); kernel launches "
        f"across every training path {counts}")
    return {"guards": guards, "full_width": full, "families": families,
            "resume": resume, "launches": counts, "seconds": seconds}


# ---------------------------------------------------------------------------
# Across a mesh: four ranks on the card
# ---------------------------------------------------------------------------

#: Four ranks on one card as a 1 x 4 ("data", "model") mesh, over gloo (two
#: ranks on one card are refused by NCCL).
MESH_SHAPE = (1, 4)
MESH_RANKS = MESH_SHAPE[0] * MESH_SHAPE[1]
#: The sharded scans: coordinated_turn, f64, one trajectory at 4 x the
#: [surface] cell's n and 64 lanes at 4 x the service bucket's; the linear
#: recurrence at Hymba-1.5B's SSM width, 1,024 steps per rank.
MESH_N1, MESH_B, MESH_NB = 4 * SURFACE_N, 64, 4 * 512
MESH_LRS_T, MESH_LRS_D = MESH_RANKS * 1024, 51200
#: The JAX suite's sharded-scan tolerance.
MESH_SCAN_TOL = dict(rtol=1e-8, atol=1e-9)
#: xlstm-350m at full width and depth; deepseek-moe-16b at full width, 2 of
#: its 28 layers (every layer is MoE).
MESH_XL_B, MESH_XL_T = 8, 1024
MESH_DS_DEPTH, MESH_DS_B, MESH_DS_T = 2, 8, 256


def _mesh_scans(torch, mesh, data, dev) -> dict:
    """Rank side: the sharded filtering and smoothing scans and drivers on
    this rank's time shard, through the combine kernels, each held against
    the one-rank plain version ("fused") on the whole input and timed
    beside the one-rank kernel call (both after the counters are read).
    Planted faults: the exchange dropped, and the fix-up's operands
    swapped (``loc (x) excl``: a fault only the fix-up launch can have)."""
    import repro_torch.core as C
    from repro_torch.core import scan as scan_lib
    from repro_torch.kernels.kalman_combine import kalman_combine as kc

    r, D = mesh.coords["model"], mesh.shape["model"]
    m0, P0 = (data[k].to(dev) for k in ("m0", "P0"))
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_counts(), \
            dict(kc.PLAIN_CALLS)

    for tag, bd in (("single", 0), ("batched", 1)):
        lin, ys, fe, se = (type(x)(*(t.to(dev) for t in x))
                           if isinstance(x, tuple) else x.to(dev)
                           for x in data[tag])
        nl = ys.shape[bd] // D

        def shard(x, extra=0):
            return x.narrow(bd, r * nl, nl + extra)

        for kind, elems, combine, ident, rev in (
                ("filtering_combine", fe, C.filtering_combine,
                 C.filtering_identity, False),
                ("smoothing_combine", se, C.smoothing_combine,
                 C.smoothing_identity, True)):
            loc = type(elems)(*(shard(x) for x in elems))
            e = ident(elems[1].shape[-1], torch.float64, dev)

            def run():
                return C.sharded_associative_scan(
                    combine, loc, axis_name="model", identity=e,
                    reverse=rev, combine_impl="pallas", batch_dims=bd)

            with mesh:
                got, wall, counts, plain = timed(run)
                real = scan_lib.device_exclusive_scan
                scan_lib.device_exclusive_scan = \
                    lambda *a, identity, **k: identity
                try:
                    no_exchange = run()
                finally:
                    scan_lib.device_exclusive_scan = real
                real = scan_lib._fix_up
                scan_lib._fix_up = lambda *a, reverse, **k: real(
                    *a, reverse=not reverse, **k)
                try:
                    swapped_fixup = run()
                finally:
                    scan_lib._fix_up = real
            _, one_wall, _, _ = timed(lambda: C.associative_scan(
                combine, elems, reverse=rev, combine_impl="pallas",
                batch_dims=bd))
            want = C.associative_scan(combine, elems, reverse=rev,
                                      combine_impl="fused", batch_dims=bd)
            want = type(want)(*(shard(x) for x in want))
            out[(tag, kind)] = {
                "wall_s": wall, "one_rank_wall_s": one_wall,
                "launches": counts, "plain": plain,
                "cuda": all(x.is_cuda for x in got),
                "err_over_tol": _err_over_tol(got, want, MESH_SCAN_TOL),
                "no_exchange": _err_over_tol(no_exchange, want,
                                             MESH_SCAN_TOL),
                "swapped_fixup": _err_over_tol(swapped_fixup, want,
                                               MESH_SCAN_TOL),
                # The swapped fix-up is not the local scan in disguise.
                "swapped_vs_local": _err_over_tol(swapped_fixup,
                                                  no_exchange,
                                                  MESH_SCAN_TOL)}

        llin, lys = type(lin)(*(shard(x) for x in lin)), shard(ys)
        if bd == 0:
            def drivers(lin_, ys_, impl="pallas", **kw):
                return C.parallel_filter_smoother(
                    lin_, ys_, m0, P0, combine_impl=impl, **kw)
        else:
            def drivers(lin_, ys_, impl="pallas", **kw):
                f = C.parallel_filter_batched(lin_, ys_, m0, P0,
                                              combine_impl=impl, **kw)
                return f, C.parallel_smoother_batched(
                    lin_, f, m0, P0, combine_impl=impl, **kw)
        with mesh:
            (f, s), wall, counts, plain = timed(
                lambda: drivers(llin, lys, axis_name="model"))
        _, one_wall, _, _ = timed(lambda: drivers(lin, ys))
        f1, s1 = drivers(lin, ys, "fused")
        out[(tag, "drivers")] = {
            "wall_s": wall, "one_rank_wall_s": one_wall, "launches": counts,
            "plain": plain, "cuda": f.mean.is_cuda and s.mean.is_cuda,
            "err_over_tol": max(
                _err_over_tol(f, type(f1)(*(shard(x) for x in f1)),
                              PATH_TOL),
                _err_over_tol(s, type(s1)(*(shard(x, 1) for x in s1)),
                              PATH_TOL))}
    return out


def _mesh_lrs_slice(torch, j, dev):
    """Rank ``j``'s slice of the linear recurrence's inputs, from its own
    seed, so that any process makes the same numbers on the card."""
    gen = torch.Generator(device=dev).manual_seed(1000 + j)
    shape = (MESH_LRS_T // MESH_RANKS, MESH_LRS_D)
    a = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
    return a, torch.randn(shape, generator=gen, device=dev)


def _mesh_lrs(torch, mesh, dev) -> dict:
    """Rank side: ``linear_recurrence_scan(axis_name=)`` at Hymba-1.5B's
    SSM width on ``ssm_scan``, against ``ssm_scan_plain`` on the whole
    input, timed beside the one-rank kernel scan."""
    import repro_torch.core as C
    from repro_torch.core import scan as scan_lib
    from repro_torch.kernels.ssm_scan import ssm_scan as ss

    r = mesh.coords["model"]
    a, b = _mesh_lrs_slice(torch, r, dev)
    with mesh:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        h = C.linear_recurrence_scan(a, b, axis_name="model",
                                     combine_impl="pallas")
        torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, read_counts()
        real = scan_lib.device_exclusive_scan
        scan_lib.device_exclusive_scan = lambda *a_, identity, **k: identity
        try:
            bad = C.linear_recurrence_scan(a, b, axis_name="model",
                                           combine_impl="pallas")
        finally:
            scan_lib.device_exclusive_scan = real
    parts = [_mesh_lrs_slice(torch, j, dev) for j in range(MESH_RANKS)]
    A, B_ = (torch.cat(x) for x in zip(*parts))
    del parts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.linear_recurrence_scan(A, B_, combine_impl="pallas")
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    want = ss.ssm_scan_plain(A[None], B_[None])[0]
    want = want[r * a.shape[0]:(r + 1) * a.shape[0]]
    tol = SSM_TOL["float32"]
    return {"wall_s": wall, "one_rank_wall_s": one_wall, "launches": counts,
            "cuda": h.is_cuda, "err_over_tol": _err_over_tol((h,), (want,),
                                                             tol),
            "no_exchange": _err_over_tol((bad,), (want,), tol)}


class _SPTap:
    """Stands in for `xlstm._mlstm_sp` during a prefill: passes each
    layer's call through, and holds the layer's real q, k, v (in float32)
    on the synthetic gates ``lf = log_sigmoid(6 + z)``, ``li =
    log_sigmoid(z')`` (the same on every rank: seeded per layer)
    sequence-parallel against the one-rank chunked form with its chunk
    carry on the plain version (``impl="plain"``); in the first layer also
    with the state exchange planted away (``C_in = 0``)."""

    def __init__(self, torch, xl):
        self.torch, self.xl, self.sp = torch, xl, xl._mlstm_sp
        self.rel, self.rel_fault = [], []

    def __enter__(self):
        self.xl._mlstm_sp = self
        return self

    def __exit__(self, *exc):
        self.xl._mlstm_sp = self.sp

    def __call__(self, q, k, v, lf, li, CT, mesh, *, impl="auto"):
        torch, xl = self.torch, self.xl
        h = self.sp(q, k, v, lf, li, CT, mesh, impl=impl)
        gen = torch.Generator(device=q.device).manual_seed(len(self.rel))
        z = torch.randn((2,) + tuple(lf.shape), generator=gen,
                        device=q.device)
        lf_s = torch.nn.functional.logsigmoid(XL_LONG_FORGET + z[0])
        li_s = torch.nn.functional.logsigmoid(z[1])
        q, k, v = q.float(), k.float(), v.float()
        one, _ = xl._mlstm_chunked(q, k, v, lf_s, li_s, CT, impl="plain")
        self.rel.append(_rel(self.sp(q, k, v, lf_s, li_s, CT, mesh,
                                     impl=impl), one))
        if not self.rel_fault:
            real = xl.device_exclusive_scan
            xl.device_exclusive_scan = lambda *a, identity, **kw: identity
            try:
                bad = self.sp(q, k, v, lf_s, li_s, CT, mesh, impl=impl)
            finally:
                xl.device_exclusive_scan = real
            self.rel_fault.append(_rel(bad, one))
        return h


def _mesh_xlstm(torch, mesh, dev) -> dict:
    """Rank side: xlstm-350m's prefill at full width and depth, every
    mLSTM layer sequence-parallel over the ranks (counted and timed), in
    bf16 and, with each layer also held on the synthetic gates
    (`_SPTap`), in float32; each beside the one-rank prefill of its
    type."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, prefill
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xl

    cfg = get_config(XL_ARCH)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model = init_model(cfg, XL_SEED, device=dev)
    model32 = copy.deepcopy(model).float()
    gen = torch.Generator(device=dev).manual_seed(XL_SEED + 11)
    toks = torch.randint(0, cfg.vocab_size, (MESH_XL_B, MESH_XL_T),
                         generator=gen, device=dev)
    V = slice(0, cfg.vocab_size)
    with mesh:
        torch.cuda.synchronize()
        reset_counts()
        _reset_plain_attention_calls()
        ssm_lib.reset_plain_calls()
        t0 = time.perf_counter()
        logits = prefill(model, cfg, toks)
        torch.cuda.synchronize()
        wall, counts = time.perf_counter() - t0, read_counts()
        plain = {**_plain_attention_calls(), **ssm_lib.PLAIN_CALLS}
        with _SPTap(torch, xl) as tap:
            logits32 = prefill(model32, cfg32, toks)
    t0 = time.perf_counter()
    ref = prefill(model, cfg, toks)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    ref32 = prefill(model32, cfg32, toks)
    return {"wall_s": wall, "one_rank_wall_s": one_wall, "launches": counts,
            "plain": plain, "cuda": logits.is_cuda,
            "bf16_vs_one_rank": _rel(logits[..., V], ref[..., V]),
            "bf16_vs_f32": _rel(logits[..., V], ref32[..., V]),
            "noise": _rel(ref[..., V], ref32[..., V]),
            "f32_vs_one_rank": _rel(logits32[..., V], ref32[..., V]),
            "layer_rel": tap.rel, "layer_rel_fault": tap.rel_fault}


class _EPTap:
    """Stands in for `moe._moe_layer_ep` and `moe._route_local` during a
    prefill: records each layer's input and output (on the host) and the
    rank's dropped assignments."""

    def __init__(self, moe_lib, keep_inputs):
        self.moe, self.ep, self.route = (moe_lib, moe_lib._moe_layer_ep,
                                         moe_lib._route_local)
        self.keep, self.x, self.y, self.drops = keep_inputs, [], [], []

    def __enter__(self):
        self.moe._moe_layer_ep, self.moe._route_local = self.layer, \
            self.local
        return self

    def __exit__(self, *exc):
        self.moe._moe_layer_ep, self.moe._route_local = self.ep, self.route

    def local(self, xt, router, cfg):
        buf, r, parts = self.route(xt, router, cfg)
        self.drops.append(int(self.moe.dropped(r)))
        return buf, r, parts

    def layer(self, params, x, cfg, mesh):
        y, aux = self.ep(params, x, cfg, mesh)
        if self.keep:
            self.x.append(x.cpu())
            self.y.append(y.cpu())
        return y, aux


def _mesh_cfg_ds(torch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_DS_DEPTH)


def _mesh_deepseek(torch, mesh, dev) -> dict:
    """Rank side: deepseek-moe-16b at full width, depth 2, the rank holding
    16 of the 64 experts: ``prefill`` under the mesh at a drop-free
    capacity factor (E/k) and at the config's, each layer's MoE input,
    output and drops recorded (`_EPTap`; inputs and outputs from rank 0)."""
    from repro_torch.models import init_model, prefill
    from repro_torch.models import moe as moe_lib

    cfg = _mesh_cfg_ds(torch)
    model = init_model(cfg, MOE_SEED, device=dev)
    moe_lib.shard_model(model, cfg, mesh)
    torch.cuda.empty_cache()
    experts = model.runs[0][0].moe.w_gate.shape[0]
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 11)
    toks = torch.randint(0, cfg.vocab_size, (MESH_DS_B, MESH_DS_T),
                         generator=gen, device=dev)
    out = {"experts_held": experts}
    free = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    for label, c in (("drop_free", free), ("config", cfg)):
        with mesh, _EPTap(moe_lib, mesh.rank == 0) as tap:
            torch.cuda.synchronize()
            reset_counts()
            _reset_plain_attention_calls()
            t0 = time.perf_counter()
            logits = prefill(model, c, toks)
            torch.cuda.synchronize()
            wall, counts = time.perf_counter() - t0, read_counts()
        out[label] = {"wall_s": wall, "launches": counts,
                      "plain": _plain_attention_calls(),
                      "cuda": logits.is_cuda, "logits": logits.cpu(),
                      "x": tap.x, "y": tap.y, "drops": tap.drops}
    return out


def _mesh_rank(ctx, path) -> dict:
    """What each rank of the ``[mesh]`` phase runs (`run_ranks`)."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    if ctx.device.type != "cuda":
        raise RuntimeError(f"rank {ctx.rank} has no card ({ctx.device})")
    mesh = make_debug_mesh(*MESH_SHAPE)
    data = torch.load(path, weights_only=False)
    res = {"device": str(ctx.device), "backend": ctx.backend,
           "card": torch.cuda.get_device_name(ctx.device)}
    with torch.no_grad():
        res["scans"] = _mesh_scans(torch, mesh, data, ctx.device)
        del data
        res["lrs"] = _mesh_lrs(torch, mesh, ctx.device)
        torch.cuda.empty_cache()
        res["xlstm"] = _mesh_xlstm(torch, mesh, ctx.device)
        torch.cuda.empty_cache()
        res["deepseek"] = _mesh_deepseek(torch, mesh, ctx.device)
    res["staged_bytes"] = mesh.staged_bytes
    return res


def _mesh_inputs(torch, path, dev="cuda") -> dict:
    """Parent side: the scans' inputs (coordinated_turn, f64, on the card)
    written to ``path`` for the ranks; the one-rank filter gives the
    smoothing elements."""
    import repro_torch.core as C
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.base import simulate_trajectory

    sc = get_scenario("coordinated_turn")
    model = sc.make_model(torch.float64, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs, ys = sc.simulate(model, MESH_N1, gen)
    lin = C.linearize_model_taylor(model, xs)
    f = C.parallel_filter(lin, ys, model.m0, model.P0, combine_impl="pallas")
    single = (lin, ys, C.filtering_elements(lin, ys, model.m0, model.P0),
              C.smoothing_elements(lin, f))
    xb, yb = simulate_trajectory(model, MESH_NB, gen, batch=(MESH_B,))
    linb = C.linearize_model_taylor_batched(model, xb)
    fb = C.parallel_filter_batched(linb, yb, model.m0, model.P0,
                                   combine_impl="pallas")
    batched = (linb, yb, C.filtering_elements_batched(linb, yb, model.m0,
                                                      model.P0),
               C.smoothing_elements_batched(linb, fb))
    cpu = lambda x: (type(x)(*(t.cpu() for t in x))  # noqa: E731
                     if isinstance(x, tuple) else x.cpu())
    torch.save({"single": tuple(cpu(x) for x in single),
                "batched": tuple(cpu(x) for x in batched),
                "m0": model.m0.cpu(), "P0": model.P0.cpu()}, path)
    return {"n_single": MESH_N1, "lanes": MESH_B, "n_batched": MESH_NB}


def _moe_reference(torch, moe_lib, layer, layer32, x, cfg, slices):
    """One rank's view of the MoE layer on ``x [B, T, d]`` with every
    expert: each of ``slices`` T-slices routed on its own (the
    expert-parallel routing; one slice is the global dispatch), its
    experts and shared experts applied in bf16 and, on the same routing,
    in float32. Returns (bf16 output, float32 output, drops per slice)."""
    from repro_torch.models import mlp as mlp_lib

    B, T, d = x.shape
    Tl = T // slices
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    o16, o32, drops = [], [], []
    for s in range(slices):
        xt = x[:, s * Tl:(s + 1) * Tl].reshape(-1, d)
        _, r, _ = moe_lib._route_local(xt, layer.router, cfg)
        drops.append(int(moe_lib.dropped(r)))
        for lay, xx, acc in ((layer, xt, o16), (layer32, xt.float(), o32)):
            y = moe_lib._experts(moe_lib._dispatch(xx, r, E), lay.w_gate,
                                 lay.w_up, lay.w_down)
            o = moe_lib._combine_gather(y, r, xt.shape[0], k, xx.dtype) \
                + mlp_lib.mlp(lay.shared, xx)
            acc.append(o.reshape(B, Tl, d))
    return torch.cat(o16, 1), torch.cat(o32, 1), drops


def _mesh_check_deepseek(torch, ranks, tag, dev="cuda") -> dict:
    """Parent side: the ranks' deepseek prefills against one rank with all
    64 experts, by the bf16 noise (float32 on the same routing)."""
    from repro_torch.models import init_model, prefill
    from repro_torch.models import moe as moe_lib

    cfg = _mesh_cfg_ds(torch)
    model = init_model(cfg, MOE_SEED, device=dev)
    model32 = copy.deepcopy(model).float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    free = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 11)
    toks = torch.randint(0, cfg.vocab_size, (MESH_DS_B, MESH_DS_T),
                         generator=gen, device=dev)
    V = slice(0, cfg.vocab_size)
    ds = [r["deepseek"] for r in ranks]
    report = {"experts_held": [d["experts_held"] for d in ds]}
    # Drop-free: the EP prefill against the one-rank global dispatch.
    one = prefill(model, free, toks)
    # float32 through the plain attention (no kernel instance serves
    # float32 at head_dim 128).
    one32 = prefill(model32, dataclasses.replace(
        cfg32, capacity_factor=free.capacity_factor), toks, impl="plain")
    noise = _rel(one[..., V], one32[..., V])
    got = [d["drop_free"]["logits"].to(dev) for d in ds]
    report["drop_free_logits"] = {
        "noise": noise, "vs_f32": max(_rel(g[..., V], one32[..., V])
                                      for g in got),
        "vs_one_rank": max(_rel(g[..., V], one[..., V]) for g in got)}
    layers = [blk.moe for blk in model.runs[0]]
    layers32 = [blk.moe for blk in model32.runs[0]]
    for label, c, slices in (("drop_free", free, 1),
                             ("config", cfg, MESH_RANKS)):
        per_layer = []
        for li, (x, y) in enumerate(zip(ds[0][label]["x"],
                                        ds[0][label]["y"])):
            x, y = x.to(dev), y.to(dev)
            r16, r32, drops = _moe_reference(torch, moe_lib, layers[li],
                                             layers32[li], x, c, slices)
            per_layer.append({
                "noise": _rel(r16, r32), "vs_f32": _rel(y, r32),
                "vs_ref": _rel(y, r16), "ref_drops": drops,
                "rank_drops": [d[label]["drops"][li] for d in ds]})
        report[label] = per_layer
    for label in ("drop_free", "config"):
        for li, p in enumerate(report[label]):
            ok = p["vs_f32"] <= LM_NOISE_FACTOR * p["noise"]
            if label == "config":
                ok &= p["rank_drops"] == p["ref_drops"]
            say(f"[{tag}] deepseek layer {li} {label}: EP output vs float32 "
                f"{p['vs_f32']:.3e} (bf16 noise {p['noise']:.3e}; vs the "
                f"one-rank bf16 reference {p['vs_ref']:.3e}); drops per rank "
                f"{p['rank_drops']}, one rank per slice {p['ref_drops']}")
            if not ok:
                fail(f"{tag} deepseek layer {li} at {label} capacity: EP "
                     "output or drops differ from one rank with every "
                     "expert")
    lg = report["drop_free_logits"]
    say(f"[{tag}] deepseek prefill (depth {MESH_DS_DEPTH}, B={MESH_DS_B}, "
        f"T={MESH_DS_T}), drop-free: EP logits vs float32 {lg['vs_f32']:.3e}"
        f" of the largest (bf16 noise of the one-rank global dispatch "
        f"{lg['noise']:.3e}), vs the one-rank bf16 prefill "
        f"{lg['vs_one_rank']:.3e}")
    if not lg["vs_f32"] <= LM_NOISE_FACTOR * lg["noise"]:
        fail(f"{tag}: deepseek EP prefill logits outside the bf16 noise")
    del model, model32
    torch.cuda.empty_cache()
    return report


def phase_mesh(torch) -> dict:
    """``[mesh]``: the cross-device paths as four ranks on the card (see
    the module docstring)."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    tag = "mesh"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "scan_inputs.pt")
        inputs = _mesh_inputs(torch, path)
        torch.cuda.empty_cache()
        t_ranks = time.perf_counter()
        ranks = run_ranks(_mesh_rank, MESH_RANKS, path, emit=say)
        t_ranks = time.perf_counter() - t_ranks
    say(f"[{tag}] {MESH_RANKS} ranks as a {'x'.join(map(str, MESH_SHAPE))} "
        f"('data', 'model') mesh in {t_ranks:.1f}s: devices "
        f"{[r['device'] for r in ranks]} ({ranks[0]['card']}), backend "
        f"{ranks[0]['backend']}, staged through the host "
        f"{[round(r['staged_bytes'] / 1e9, 3) for r in ranks]} GB per rank")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # The sharded scans and drivers.
    calls = {"single": len([P for P in scan_level_pairs(
        MESH_N1 // MESH_RANKS) if P]), "batched": len([P for P in
                                                        scan_level_pairs(
        MESH_NB // MESH_RANKS) if P])}
    for (what, kind), _ in sorted(ranks[0]["scans"].items()):
        res = [r["scans"][(what, kind)] for r in ranks]
        want = calls[what] + 1
        if kind == "drivers":
            expect = {"filtering_combine": want, "smoothing_combine": want}
        else:
            expect = {kind: want}
        for i, x in enumerate(res):
            got = {k: v for k, v in x["launches"].items() if v}
            if got != expect or any(x["plain"].values()) or not x["cuda"]:
                fail(f"{tag} {what} {kind} rank {i}: launches {got} (expected"
                     f" {expect}), plain calls {x['plain']}, CUDA outputs "
                     f"{x['cuda']}")
            if not x["err_over_tol"] < 1.0:
                fail(f"{tag} {what} {kind} rank {i}: err/tol "
                     f"{x['err_over_tol']:.3f} against one rank's plain "
                     "version")
            add(x["launches"])
        size = (f"n = {MESH_N1}" if what == "single"
                else f"B x n = {MESH_B} x {MESH_NB}")
        line = (f"[{tag}] {what} {kind} ({size}, f64): launches per rank "
                f"{expect}, err/tol "
                f"{max(x['err_over_tol'] for x in res):.3e}; wall per rank "
                f"{[round(x['wall_s'] * 1e3, 2) for x in res]} ms, one rank "
                f"{[round(x['one_rank_wall_s'] * 1e3, 2) for x in res]} ms")
        if kind != "drivers":
            # The rank the fault cannot reach: the first (prefix scan) or
            # the last (suffix scan) holds what it would hold alone.
            spared = MESH_RANKS - 1 if kind == "smoothing_combine" else 0
            for fault in ("no_exchange", "swapped_fixup"):
                reached = [x[fault] for i, x in enumerate(res)
                           if i != spared]
                caught = [e > 1.0 for e in reached]
                line += (f"; {fault} err/tol {min(reached):.3e} (caught "
                         f"{sum(caught)} of {len(caught)})")
                if not all(caught):
                    fail(f"{tag} {what} {kind}: the planted fault {fault} "
                         "passes the gate")
            apart = min(x["swapped_vs_local"] for i, x in enumerate(res)
                        if i != spared)
            line += f", its err/tol against the local scan {apart:.3e}"
            if not apart > 1.0:
                fail(f"{tag} {what} {kind}: the swapped fix-up gives the "
                     "local scan")
        say(line)

    lrs = [r["lrs"] for r in ranks]
    for i, x in enumerate(lrs):
        got = {k: v for k, v in x["launches"].items() if v}
        if got != {"ssm_scan": 2} or not x["cuda"] or \
                not x["err_over_tol"] < 1.0:
            fail(f"{tag} linear_recurrence_scan rank {i}: launches {got} "
                 f"(expected {{'ssm_scan': 2}}), err/tol "
                 f"{x['err_over_tol']:.3f}")
        add(x["launches"])
    caught = [x["no_exchange"] > 1.0 for x in lrs[1:]]
    say(f"[{tag}] linear_recurrence_scan(axis_name='model') [{MESH_LRS_T}, "
        f"{MESH_LRS_D}] f32: ssm_scan launches 2 per rank, err/tol "
        f"{max(x['err_over_tol'] for x in lrs):.3e} (SSM_TOL, against "
        f"ssm_scan_plain); no exchange "
        f"caught {sum(caught)} of {len(caught)}; wall per rank "
        f"{[round(x['wall_s'] * 1e3, 2) for x in lrs]} ms, one rank "
        f"{[round(x['one_rank_wall_s'] * 1e3, 2) for x in lrs]} ms")
    if not all(caught):
        fail(f"{tag}: linear_recurrence_scan without the exchange passes")

    # xlstm-350m, every mLSTM layer sequence-parallel.
    from repro_torch.configs import get_config

    xs = [r["xlstm"] for r in ranks]
    xl_cfg = get_config(XL_ARCH)
    n_mlstm = xl_cfg.num_layers - len(xl_cfg.slstm_layers)
    for i, x in enumerate(xs):
        got = {k: v for k, v in x["launches"].items() if v}
        if got != {"ssm_scan": n_mlstm} or any(x["plain"].values()) or \
                not x["cuda"]:
            fail(f"{tag} xlstm rank {i}: launches {got} (expected "
                 f"{{'ssm_scan': {n_mlstm}}}), plain {x['plain']}")
        add(x["launches"])
    worst = {k: max(x[k] for x in xs) for k in (
        "bf16_vs_one_rank", "bf16_vs_f32", "noise", "f32_vs_one_rank")}
    layer_rel = max(max(x["layer_rel"]) for x in xs)
    fault_rel = min(min(x["layer_rel_fault"]) for x in xs)
    say(f"[{tag}] xlstm-350m prefill B={MESH_XL_B} T={MESH_XL_T}, {n_mlstm} "
        f"mLSTM layers sequence-parallel, relative to the largest logit: "
        f"float32 vs the one-rank float32 prefill "
        f"{worst['f32_vs_one_rank']:.3e} (bound {XL_F32_REL:g}); bf16 vs "
        f"the one-rank float32 {worst['bf16_vs_f32']:.3e} against the bf16 "
        f"noise {worst['noise']:.3e} (one rank bf16 vs float32; bound "
        f"{LM_NOISE_FACTOR:g} x), vs the one-rank bf16 "
        f"{worst['bf16_vs_one_rank']:.3e}; each layer's real q, k, v on the "
        f"gates log_sigmoid({XL_LONG_FORGET:g} + z) vs the one-rank chunked "
        f"form, float32: max {layer_rel:.3e} (bound {XL_F32_REL:g}) over "
        f"{len(xs[0]['layer_rel'])} layers x {MESH_RANKS} ranks; layer 0 "
        f"with C_in planted to 0: min {fault_rel:.3e}; wall per rank "
        f"{[round(x['wall_s'], 3) for x in xs]} s, one rank "
        f"{[round(x['one_rank_wall_s'], 3) for x in xs]} s")
    if not (worst["f32_vs_one_rank"] <= XL_F32_REL
            and all(x["bf16_vs_f32"] <= LM_NOISE_FACTOR * x["noise"]
                    for x in xs)
            and layer_rel <= XL_F32_REL and fault_rel > XL_F32_REL
            and all(len(x["layer_rel"]) == n_mlstm for x in xs)):
        fail(f"{tag}: the sequence-parallel xlstm prefill misses its gates")

    # deepseek-moe-16b, expert-parallel.
    for i, r in enumerate(ranks):
        for label in ("drop_free", "config"):
            x = r["deepseek"][label]
            got = {k: v for k, v in x["launches"].items() if v}
            if got != {"flash_attention_wgmma": MESH_DS_DEPTH} or \
                    any(x["plain"].values()) or not x["cuda"]:
                fail(f"{tag} deepseek {label} rank {i}: launches {got}, "
                     f"plain {x['plain']}")
            add(x["launches"])
    ds = _mesh_check_deepseek(torch, ranks, tag)
    walls = {label: [round(r["deepseek"][label]["wall_s"], 3) for r in ranks]
             for label in ("drop_free", "config")}
    say(f"[{tag}] deepseek ranks hold {ds['experts_held']} experts; wall per"
        f" rank drop-free {walls['drop_free']} s, config {walls['config']} s")
    for r in ranks:
        r["scans"] = {" ".join(k): v for k, v in r["scans"].items()}
        for label in ("drop_free", "config"):
            for k in ("logits", "x", "y"):
                r["deepseek"][label].pop(k)
    seconds = time.perf_counter() - t0
    say(f"[{tag}] phase done in {seconds:.1f} s; kernel launches summed over"
        f" the ranks {launches}")
    return {"inputs": inputs, "ranks": ranks, "deepseek": ds,
            "launches": launches, "seconds": seconds, "ranks_s": t_ranks}


# ---------------------------------------------------------------------------
# Training across a mesh: four ranks on the card
# ---------------------------------------------------------------------------

#: [train_mesh]: four ranks sharing the card over gloo as a 2 x 2 ("data",
#: "model") mesh. (a) qwen2-1.5b at full width through `train()` (the
#: trainer's B and T, 2 steps); (b) the five families' reduced configs,
#: float32, 2 mesh steps against the one-device step (the MoE at its
#: reduced capacity factor E / k, drop-free); (c) the elastic resume; (d)
#: the int8 compressed all-reduce against psum at the reference's bound.
TRAIN_MESH_SHAPE = (2, 2)
TRAIN_MESH_RANKS = TRAIN_MESH_SHAPE[0] * TRAIN_MESH_SHAPE[1]
TRAIN_MESH_STEPS = 2
TRAIN_MESH_FAMILY_B, TRAIN_MESH_FAMILY_T = 4, 64
#: The reduced steps' AdamW lr (the reference's): AdamW's m / sqrt(v) of
#: an element whose gradient is near zero turns float32 rounding into up
#: to ~lr / 100, inside TOL at this lr.
TRAIN_MESH_LR = 3e-4
#: The reference's compressed_psum bound: 2 % of the largest magnitude.
COMPRESS_BOUND = 0.02
#: (e) The MoE's global dispatch on the mesh: reduced deepseek at the
#: production capacity factor, an odd T (E splits over "model", T does
#: not), tokens drawn from this few ids (routing crowds a few experts).
TRAIN_MESH_MOE_T, TRAIN_MESH_MOE_CF, TRAIN_MESH_MOE_IDS = 63, 1.25, 6
#: (f), (g) and (h): the tensor-parallel serve plans of the dense, the
#: hybrid and the encoder-decoder family on the mesh, at full width and
#: depth, one bf16 model from one seed each: a global batch of 16, a
#: prompt of 64 (prefill, then teacher-forced through the decode plan),
#: 16 greedy steps ((f): 32 before, cut to keep the script in its time);
#: the kernel taps and the planted faults on the first `TP_SERVE_TAP`
#: steps past the prompt. By path: (arch, cache rows). qwen2-1.5b's
#: caches of 128 rows split along the sequence over "model" (its 2 kv
#: heads are replicated); hymba's of 1,088: each windowed layer's ring of
#: 1,024 whole on every rank, the three global layers' caches split along
#: the sequence (its 5 kv heads are replicated); seamless's of 128 split
#: by its kv heads, its random frontend (std 1) at the config's 1,024
#: rows.
TP_SERVE = {"train_mesh_serve": (TRAIN_ARCH, 128),
            "tp_serve_hybrid": ("hymba-1.5b", 1088),
            "tp_serve_encdec": ("seamless-m4t-medium", 128)}
TP_SERVE_B, TP_SERVE_PROMPT, TP_SERVE_GEN, TP_SERVE_TAP = 16, 64, 16, 8
#: (g)'s float32 prefill gate: the mesh's float32 prefill (the kernels'
#: float32 instances) against the one-device float32 prefill (plain), as
#: a share of the largest logit (2^-10).
TP_SERVE_F32_BOUND = 2.0 ** -10


def _whole_params(plan, state) -> dict:
    sh = plan.shardings(plan.param_specs)
    return {n: sh[n].gather(t) for n, t in state.params.items()}


def _err_over_tol_trees(torch, got: dict, want: dict) -> float:
    tol = TOL["float32"]
    worst = 0.0
    for n, w in want.items():
        g = got[n].float().to(w.device)
        w = w.float()
        worst = max(worst, float(((g - w).abs() / (
            tol["atol"] + tol["rtol"] * w.abs())).max()))
    return worst


def _err_over_tol_lists(got, want) -> float:
    tol = TOL["float32"]
    return max(abs(g - w) / (tol["atol"] + tol["rtol"] * abs(w))
               for g, w in zip(got, want))


def _train_mesh_full(torch, ctx) -> dict:
    """(a): the main path, `train()` at full width on the 2 x 2 mesh; each
    step timed, the bytes it staged through the host and the rank's
    resident blocks read at the step (the plan's `__call__` wrapped)."""
    from repro_torch.launch import steps as st
    from repro_torch.launch import train as tr

    captured, times, staged, resident = {}, [], [], {}
    build, call = tr.build_mesh, st.TrainPlan.__call__

    def built(loop_cfg):
        captured["mesh"] = build(loop_cfg)
        return captured["mesh"]

    def timed(plan, state, batch):
        mesh = captured["mesh"]
        torch.cuda.synchronize()
        before, t0 = mesh.staged_bytes, time.perf_counter()
        out = call(plan, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        staged.append(mesh.staged_bytes - before)
        if not resident:
            nb = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
            resident.update(
                params=nb(state.params.values()),
                moments=nb(state.opt.m.values()) + nb(state.opt.v.values()),
                batch=nb(batch.values()),
                per_chip_argument_bytes=plan.per_chip_argument_bytes(),
                plan_resident=plan.resident_bytes(),
                compute=nb(plan.model.parameters()),
                plan_compute=plan.compute_param_bytes(),
                whole=sum(math.prod(sh) * dt.itemsize for sh, dt in
                          plan.param_shapes.values()),
                tensor_parallel=plan.tensor_parallel)
        return out

    loop = tr.TrainLoopConfig(arch=TRAIN_ARCH, reduced=False, seq_len=128,
                              global_batch=8, steps=TRAIN_MESH_STEPS,
                              lr=3e-4, warmup_steps=2, log_every=1,
                              mesh_shape=TRAIN_MESH_SHAPE)
    tr.build_mesh, st.TrainPlan.__call__ = built, timed
    lines = []
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = tr.train(loop, emit=lines.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        tr.build_mesh, st.TrainPlan.__call__ = build, call
    return {"losses": out["losses"], "launches": counts, "wall_s": wall,
            "step_s": times, "staged_bytes": staged, "resident": resident,
            "peak_bytes": torch.cuda.max_memory_allocated(), "log": lines,
            "backend": captured["mesh"].backend}


def _train_mesh_families(torch, ctx) -> dict:
    """(b): each family's reduced config (tp = 2), float32, 2 steps on the
    mesh against 2 one-device steps on the card from the same weights and
    batches (rank 0 holds both), on the losses, the grad norms and every
    parameter; then two planted faults, which must miss: the gradients
    not summed over "data" (the parameters catch it), and the gradients
    multiplied by the "model" size (a uniform factor, which the global
    clip and AdamW's m / sqrt(v) hide from the parameters: the grad norm
    catches it)."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.optim import AdamWConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(*TRAIN_MESH_SHAPE)
    B, T = TRAIN_MESH_FAMILY_B, TRAIN_MESH_FAMILY_T

    def run(cfg, model, batches, on_mesh, steps):
        plan = st.make_train_step(
            cfg, mesh if on_mesh else None, ShapeConfig("t", T, B, "train"),
            opt_cfg=AdamWConfig(lr=TRAIN_MESH_LR), total_steps=10,
            warmup_steps=0)
        state = plan.init_state(copy.deepcopy(model))
        losses, norms = [], []
        for batch in batches[:steps]:
            if on_mesh:
                batch = st.batch_rows(batch, mesh)
            state, met = plan(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        whole = (_whole_params(plan, state) if on_mesh else
                 {n: p.detach() for n, p in
                  state.params.named_parameters()})
        return losses, norms, whole

    def planted(fault, cfg, model, batches):
        reduce = st._reduce_grad
        st._reduce_grad = fault(reduce)
        try:
            return run(cfg, model, batches, True, 1)
        finally:
            st._reduce_grad = reduce

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                  tp_size=TRAIN_MESH_SHAPE[1])
        pipe = SyntheticTokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=T, global_batch=B, seed=0))
        rng = np.random.default_rng(0)
        batches = []
        for s in range(TRAIN_MESH_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(s).items()}
            if cfg.encoder_layers:
                batch["enc_emb"] = torch.from_numpy(rng.standard_normal(
                    (B, cfg.encoder_seq_len, cfg.d_model)).astype(
                    np.float32)).to(dev)
            batches.append(batch)
        model = init_model(cfg, 0, device=dev)
        t0 = time.perf_counter()
        losses, norms, whole = run(cfg, model, batches, True,
                                   TRAIN_MESH_STEPS)
        res = {"mesh": losses, "grad_norm": norms,
               "mesh_s": time.perf_counter() - t0}
        if ctx.rank == 0:
            one, one_norms, want = run(cfg, model, batches, False,
                                       TRAIN_MESH_STEPS)
            res.update(one_device=one, one_device_grad_norm=one_norms,
                       err_over_tol=max(
                           _err_over_tol_trees(torch, whole, want),
                           _err_over_tol_lists(losses, one),
                           _err_over_tol_lists(norms, one_norms)))
        if arch == TRAIN_ARCH:
            # The planted faults: each data rank's gradient left unsummed;
            # every gradient tp times too large.
            tp = mesh.shape["model"]
            unsummed = lambda reduce: lambda g, c, m, b: reduce(  # noqa
                g, c, m, ())
            scaled = lambda reduce: lambda g, c, m, b: reduce(  # noqa
                g, c, m, b) * tp
            _, _, faulty = planted(unsummed, cfg, model, batches)
            f_loss, f_norm, f_whole = planted(scaled, cfg, model, batches)
            if ctx.rank == 0:
                _, _, want1 = run(cfg, model, batches, False, 1)
                res["fault_err_over_tol"] = _err_over_tol_trees(
                    torch, faulty, want1)
                res["scaled_fault"] = {
                    "grad_norm": f_norm[0], "want": one_norms[0],
                    "norm_err_over_tol": _err_over_tol_lists(
                        f_norm, one_norms[:1]),
                    "loss_err_over_tol": _err_over_tol_lists(f_loss,
                                                             one[:1]),
                    "params_err_over_tol": _err_over_tol_trees(
                        torch, f_whole, want1)}
        out[arch] = res
    return out


def _train_mesh_moe_global(torch, ctx) -> dict:
    """(e): reduced deepseek-moe-16b (tp 2) at capacity factor 1.25 and
    T = 63, whose MoE layers take the global dispatch on the mesh (E
    splits over "model", T does not): 2 steps on the mesh against 2
    one-device steps on the card from the same weights and batches (rank
    0 holds both), each run's drops counted in `moe.route`."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import AdamWConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(*TRAIN_MESH_SHAPE)
    B, T = TRAIN_MESH_FAMILY_B, TRAIN_MESH_MOE_T
    cfg = dataclasses.replace(
        reduced_config(get_config("deepseek-moe-16b")),
        tp_size=TRAIN_MESH_SHAPE[1], capacity_factor=TRAIN_MESH_MOE_CF)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = []
    for _ in range(TRAIN_MESH_STEPS):
        t = torch.randint(0, TRAIN_MESH_MOE_IDS, (B, T), generator=gen,
                          device=dev, dtype=torch.int32)
        batches.append({"tokens": t, "labels": t})
    model = init_model(cfg, 0, device=dev)

    def run(on_mesh):
        route, drops = moe_lib.route, [0]

        def tapped(params, xt, c):
            r = route(params, xt, c)
            drops[0] += int(moe_lib.dropped(r))
            return r

        plan = st.make_train_step(
            cfg, mesh if on_mesh else None, ShapeConfig("t", T, B, "train"),
            opt_cfg=AdamWConfig(lr=TRAIN_MESH_LR), total_steps=10,
            warmup_steps=0)
        state = plan.init_state(copy.deepcopy(model))
        out = {"loss": [], "aux": [], "grad_norm": []}
        moe_lib.route = tapped
        try:
            for batch in batches:
                if on_mesh:
                    batch = st.batch_rows(batch, mesh)
                state, met = plan(state, batch)
                for k in out:
                    out[k].append(float(met[k]))
        finally:
            moe_lib.route = route
        out["drops"] = drops[0]
        whole = (_whole_params(plan, state) if on_mesh else
                 {n: p.detach() for n, p in
                  state.params.named_parameters()})
        return out, whole

    t0 = time.perf_counter()
    got, whole = run(True)
    res = {"mesh": got, "coords": dict(mesh.coords),
           "mesh_s": time.perf_counter() - t0}
    if ctx.rank == 0:
        one, want = run(False)
        res.update(one_device=one, err_over_tol=max(
            _err_over_tol_trees(torch, whole, want),
            *(_err_over_tol_lists(got[k], one[k])
              for k in ("loss", "aux", "grad_norm"))))
    return res


def _train_mesh_elastic(torch, ctx, tmp) -> dict:
    """(c): reduced qwen2, float32: `train()` on 2 x 2 for 3 steps with a
    checkpoint at step 2; that checkpoint resumed on 1 x 4 for the third
    step; the two step-3 checkpoints compared."""
    import os
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as tr

    base = dict(arch=TRAIN_ARCH, steps=3, seq_len=32, global_batch=4,
                ckpt_every=2, log_every=100, lr=TRAIN_MESH_LR, warmup_steps=1)
    straight, resumed = (os.path.join(tmp, n) for n in ("straight",
                                                         "resumed"))
    log = []
    a = tr.train(tr.TrainLoopConfig(mesh_shape=(2, 2), ckpt_dir=straight,
                                    **base), emit=log.append)
    if ctx.rank == 0:
        shutil.copytree(CheckpointManager(straight).path_for(2),
                        CheckpointManager(resumed).path_for(2))
    dist.barrier()
    b = tr.train(tr.TrainLoopConfig(mesh_shape=(1, 4), ckpt_dir=resumed,
                                    **base), emit=log.append)
    res = {"straight": a["losses"], "resumed": b["losses"],
           "resumed_log": any("resumed from step 2" in x for x in log)}
    if ctx.rank == 0:
        tol = TOL["float32"]
        worst = abs(b["losses"][0] - a["losses"][2]) / (
            tol["atol"] + tol["rtol"] * abs(a["losses"][2]))
        pa, pb = (CheckpointManager(d).path_for(3) for d in (straight,
                                                             resumed))
        files = sorted(f for f in os.listdir(pa) if f.endswith(".npy"))
        for f in files:
            x, y = (np.load(os.path.join(p, f)).astype(np.float64)
                    for p in (pa, pb))
            worst = max(worst, float(np.max(np.abs(x - y) / (
                tol["atol"] + tol["rtol"] * np.abs(x)))))
        res.update(err_over_tol=worst, leaves=len(files))
    return res


def _train_mesh_compression(torch, ctx) -> dict:
    """(d): one step's gradients of reduced qwen2 (float32, the rank's rows
    on 2 x 2) summed over "data" by `compressed_psum` and by `psum`."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.distributed import psum
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_model
    from repro_torch.optim import compressed_psum, init_compression

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(*TRAIN_MESH_SHAPE)
    cfg = dataclasses.replace(reduced_config(get_config(TRAIN_ARCH)),
                              tp_size=TRAIN_MESH_SHAPE[1])
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_MESH_FAMILY_T,
        global_batch=TRAIN_MESH_FAMILY_B, seed=0))
    batch = st.batch_rows({k: torch.from_numpy(v).to(dev) for k, v in
                           pipe.batch_at(0).items()}, mesh)
    model = init_model(cfg, 0, device=dev)
    with mesh:
        _, _, grads = st.loss_and_grads(model, cfg, batch)
        before = mesh.staged_bytes
        got, _ = compressed_psum(grads, init_compression(grads), "data")
        compressed = mesh.staged_bytes - before
        before = mesh.staged_bytes
        want = {n: psum(g, "data") for n, g in grads.items()}
        plain = mesh.staged_bytes - before
    rel = max(float((got[n] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for n, w in want.items())
    return {"rel_to_largest": rel, "staged_compressed": compressed,
            "staged_psum": plain, "tensors": len(grads)}


class _MappedDecodeTap:
    """Stands in for `decode_attention_cuda` on a rank while the mesh's
    decode plan runs: each call launches the kernel as the model's would
    (``plant``: with q head ``plant[0]`` reading kv head ``plant[1]``, the
    rest of the reference's map kept) and holds its output against the
    plain version with the model's own map on the same q and cache block
    in place, in float32, at the tight bf16 bound; the log-sum-exps the
    merge across the ranks takes at float32 TOL."""

    def __init__(self, fa, plant=None):
        self.fa, self.kernel, self.plant = fa, fa.decode_attention_cuda, plant
        self.excess, self.lse_err, self.calls = [], [], 0

    def __enter__(self):
        self.fa.decode_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.fa.decode_attention_cuda = self.kernel

    def __call__(self, q, k_cache, v_cache, length, **kw):
        # No map: the kernel's own, q head j on kv head j // group.
        group = q.shape[1] // k_cache.shape[1]
        hmap = kw.get("head_map") or tuple(j // group
                                           for j in range(q.shape[1]))
        run = dict(kw)
        if self.plant is not None:
            bad = list(hmap)
            bad[self.plant[0]] = self.plant[1]
            run["head_map"] = tuple(bad)
        out = self.kernel(q, k_cache, v_cache, length, **run)
        o, lse = out if kw.get("return_lse") else (out, None)
        plain = functools.partial(
            self.fa.decode_attention_plain, head_map=hmap,
            softcap=kw.get("softcap", 0.0))
        if int(length) > 0:
            # (A rank whose block holds no key yet returns zeros and a
            # log-sum-exp of -inf, which weighs 0 in the merge.)
            want, tol = _tight_tol(plain, q, k_cache, v_cache, length)
            self.excess.append(_excess(o, want, tol))
        if lse is not None:
            _, wl = plain(q.float(), k_cache.float(), v_cache.float(),
                          length, return_lse=True)
            finite = wl.isfinite()
            self.lse_err.append(((lse - wl).abs() / (
                2e-4 * wl.abs() + 2e-4)).where(finite, 0).amax())
        self.calls += 1
        return out

    def result(self) -> dict:
        import torch

        return {"calls": self.calls, "checked": len(self.excess),
                "max_err_over_tol": torch.stack(self.excess).amax().item()
                if self.excess else 0.0,
                "lse_err_over_tol": (torch.stack(self.lse_err).amax().item()
                                     if self.lse_err else 0.0)}


def _parent_serve_bytes(plan, cfg, B, S) -> int:
    """The bytes per rank per decode step the replicated layout of the
    mesh's decode plan stages through the host (the layout these families
    ran in before they were tensor-parallel): every
    parameter gathered whole from its block, and every cache block
    gathered over "model" and its block copied back (each all_gather
    moving its block out and the whole back)."""
    from repro_torch.distributed import NamedSharding, P, tree_map
    from repro_torch.models import init_caches

    total = 0
    for n, (shape, dt) in plan.param_shapes.items():
        block = math.prod(NamedSharding(plan.mesh, plan.param_specs[n])
                          .shard_shape(shape)) * dt.itemsize
        whole = math.prod(shape) * dt.itemsize
        total += block + whole if block != whole else 0
    caches, specs = [], []
    tree_map(caches.append, init_caches(cfg, B, S, device="meta"),
             is_leaf=lambda x: hasattr(x, "shape"))
    tree_map(specs.append, plan.cache_specs,
             is_leaf=lambda x: isinstance(x, P))
    for t, sp in zip(caches, specs):
        sh = NamedSharding(plan.mesh, sp)
        block = math.prod(sh.shard_shape(t.shape)) * t.element_size()
        rows = math.prod(NamedSharding(plan.mesh, P(*[
            e if e in ("data", "pod") else None for e in sp]))
            .shard_shape(t.shape)) * t.element_size()
        total += block + rows if rows != block else 0
    return total


def _train_mesh_rank(ctx, tmp) -> dict:
    """What each rank of the ``[train_mesh]`` phase runs (`run_ranks`)."""
    import torch

    if ctx.device.type != "cuda":
        raise RuntimeError(f"rank {ctx.rank} has no card ({ctx.device})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"device": str(ctx.device), "backend": ctx.backend,
           "card": torch.cuda.get_device_name(ctx.device)}
    t0 = time.perf_counter()
    res["full"] = _train_mesh_full(torch, ctx)
    res["full_s"] = time.perf_counter() - t0
    # (The plans' cycles hold their models until the collector runs.)
    gc.collect()
    torch.cuda.empty_cache()
    for path in TP_SERVE:
        t1 = time.perf_counter()
        with torch.no_grad():
            res[path] = _tp_serve(torch, ctx, path)
        res[f"{path}_s"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
    reset_counts()
    t1 = time.perf_counter()
    res["families"] = _train_mesh_families(torch, ctx)
    res["moe_global"] = _train_mesh_moe_global(torch, ctx)
    res["elastic"] = _train_mesh_elastic(torch, ctx, tmp)
    res["compression"] = _train_mesh_compression(torch, ctx)
    res["reduced_launches"] = read_counts()
    res["reduced_s"] = time.perf_counter() - t1
    return res


def phase_train_mesh(torch, train) -> dict:
    """``[train_mesh]``: training across a 2 x 2 mesh of four ranks sharing
    the card (see the module docstring)."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    tag = "train_mesh"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        ranks = run_ranks(_train_mesh_rank, TRAIN_MESH_RANKS, tmp, emit=say)
    t_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    launches = {}
    for r in ranks:
        for counts in (r["full"]["launches"], r["reduced_launches"]):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    if any(launches.values()):
        fail(f"[{tag}] the training paths launched kernels: {launches}")

    # (a) The main path at full width.
    full = [r["full"] for r in ranks]
    losses = full[0]["losses"]
    if any(f["losses"] != losses for f in full):
        fail(f"[{tag}] the ranks' losses differ: "
             f"{[f['losses'] for f in full]}")
    if len(losses) != TRAIN_MESH_STEPS or not all(
            math.isfinite(x) for x in losses):
        fail(f"[{tag}] losses not finite over {TRAIN_MESH_STEPS} steps: "
             f"{losses}")
    grads = train["full_width"]["grads"]
    one = train["full_width"]["losses"][0]
    noise = abs(grads["loss_bf16"] - grads["loss_f32"])
    off = abs(losses[0] - one)
    say(f"[{tag}] path: train({TRAIN_ARCH}, reduced=False, mesh_shape "
        f"{TRAIN_MESH_SHAPE}, steps {TRAIN_MESH_STEPS}, seq_len 128, "
        f"global_batch 8) on {TRAIN_MESH_RANKS} ranks "
        f"({r0['card']}, backend {full[0]['backend']}): losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; step 0 vs the one-device step 0 ({one:.6f}): "
        f"{off:.3g} (bf16 noise from [train]: |bf16 - float32| = "
        f"{noise:.3g}); kernel launches {launches}")
    if not off <= noise:
        fail(f"[{tag}] step-0 loss {losses[0]} is {off:.3g} from the "
             f"one-device {one}, past the bf16 noise {noise:.3g}")
    for i, f in enumerate(full):
        res = f["resident"]
        say(f"[{tag}] rank {i}: parameters {res['params'] / 1e9:.3f} GB + "
            f"moments {res['moments'] / 1e9:.3f} GB + batch "
            f"{res['batch']} B resident ({res['plan_resident']} bytes with "
            f"the step, as the plan counts; the reference's "
            f"per_chip_argument_bytes {res['per_chip_argument_bytes']}); "
            f"peak {f['peak_bytes'] / 1e9:.2f} GB; staged through "
            f"the host per step "
            f"{[round(b / 1e9, 3) for b in f['staged_bytes']]} GB; wall per "
            f"step {[round(t, 2) for t in f['step_s']]} s; train() "
            f"{f['wall_s']:.1f} s")
        say(f"[{tag}] rank {i}: compute model (tensor-parallel "
            f"{res['tensor_parallel']}) {res['compute'] / 1e9:.3f} GB of "
            f"the whole model's {res['whole'] / 1e9:.3f} GB (the plan's "
            f"count {res['plan_compute'] / 1e9:.3f} GB)")
        if not (res["tensor_parallel"] and res["compute"] ==
                res["plan_compute"] and res["compute"] < res["whole"]):
            fail(f"[{tag}] rank {i}: the compute model holds "
                 f"{res['compute']} bytes; its plan's 'model' block is "
                 f"{res['plan_compute']} of {res['whole']}")
        # The port holds what its plan counts; at least the reference's
        # count (a layer cannot be cut along the stacked layer dimension
        # that zero_specs may pick: ROADMAP C, differences by design).
        held = res["params"] + res["moments"] + res["batch"] + 4
        if held != res["plan_resident"] or \
                res["plan_resident"] < res["per_chip_argument_bytes"]:
            fail(f"[{tag}] rank {i} holds {held} bytes of state and batch; "
                 f"its plan says {res['plan_resident']}, the reference's "
                 f"count {res['per_chip_argument_bytes']}")

    # (b) Five families against the one-device step.
    fam = r0["families"]
    for arch, res in fam.items():
        say(f"[{tag}] {arch} (reduced, tp 2, float32): "
            f"{TRAIN_MESH_STEPS} steps on {TRAIN_MESH_SHAPE} vs one device "
            f"(B {TRAIN_MESH_FAMILY_B}, T {TRAIN_MESH_FAMILY_T}): losses "
            + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(
                res["mesh"], res["one_device"]))
            + "; grad norms " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(
                res["grad_norm"], res["one_device_grad_norm"]))
            + f"; every parameter, loss and grad norm err/tol "
            f"{res['err_over_tol']:.3g}; {res['mesh_s']:.1f} s"
            + (f"; gradients not summed over 'data' (planted): err/tol "
               f"{res['fault_err_over_tol']:.3g}"
               if "fault_err_over_tol" in res else ""))
        if not res["err_over_tol"] <= 1.0:
            fail(f"[{tag}] {arch}: the mesh step differs from the "
                 f"one-device step (err/tol {res['err_over_tol']:.3g})")
        for r in ranks:
            if r["families"][arch]["mesh"] != res["mesh"]:
                fail(f"[{tag}] {arch}: the ranks' losses differ")
    if not fam[TRAIN_ARCH]["fault_err_over_tol"] > 1.0:
        fail(f"[{tag}] the unsummed gradients pass the gate")
    sf = fam[TRAIN_ARCH]["scaled_fault"]
    say(f"[{tag}] {TRAIN_ARCH}: gradients times the 'model' size "
        f"(planted): step-0 grad norm {sf['grad_norm']:.6f} vs "
        f"{sf['want']:.6f}, err/tol {sf['norm_err_over_tol']:.3g} (blind "
        f"to it: the step-0 loss {sf['loss_err_over_tol']:.3g} and the "
        f"parameters after the clipped step {sf['params_err_over_tol']:.3g})"
        )
    if not sf["norm_err_over_tol"] > 1.0:
        fail(f"[{tag}] the gradients scaled by the 'model' size pass the "
             "gate")

    # (c) Elastic resume.
    el = r0["elastic"]
    say(f"[{tag}] elastic: reduced {TRAIN_ARCH} float32, 2 steps on 2 x 2 "
        f"checkpointed, resumed on 1 x 4 for step 3: loss "
        f"{el['resumed'][0]:.6f} vs uninterrupted {el['straight'][2]:.6f};"
        f" {el['leaves']} checkpoint leaves and the loss err/tol "
        f"{el['err_over_tol']:.3g}")
    if not (el["resumed_log"] and el["err_over_tol"] <= 1.0):
        fail(f"[{tag}] the elastic resume differs (err/tol "
             f"{el['err_over_tol']:.3g}, resumed {el['resumed_log']})")

    # (d) Compression.
    comp = [r["compression"] for r in ranks]
    worst = max(c["rel_to_largest"] for c in comp)
    say(f"[{tag}] compressed_psum over 'data' of one step's gradients "
        f"(reduced {TRAIN_ARCH}, {comp[0]['tensors']} tensors): max error "
        f"{worst:.3g} of each tensor's largest magnitude (bound "
        f"{COMPRESS_BOUND}); staged through the host per rank: "
        f"compressed_psum {comp[0]['staged_compressed']} bytes (int32 "
        f"payload and a pmax per tensor, there and back), float32 psum "
        f"{comp[0]['staged_psum']} bytes")
    if not worst <= COMPRESS_BOUND:
        fail(f"[{tag}] compressed_psum is {worst:.3g} of the largest "
             "magnitude from psum")
    # (e) The MoE's global dispatch.
    mg = r0["moe_global"]
    line = [r["moe_global"]["mesh"]["drops"] for r in ranks
            if r["moe_global"]["coords"]["model"] == 0]
    one = mg["one_device"]
    say(f"[{tag}] deepseek-moe-16b (reduced, tp 2, float32, capacity "
        f"factor {TRAIN_MESH_MOE_CF}, T {TRAIN_MESH_MOE_T}: the global "
        f"dispatch) {TRAIN_MESH_STEPS} steps on {TRAIN_MESH_SHAPE} vs one "
        f"device: losses " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(
            mg["mesh"]["loss"], one["loss"]))
        + "; aux " + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(
            mg["mesh"]["aux"], one["aux"]))
        + f"; drops by data rank {line} (sum {sum(line)}) vs "
        f"{one['drops']}; every parameter, loss, aux and grad norm err/tol "
        f"{mg['err_over_tol']:.3g}; {mg['mesh_s']:.1f} s")
    if not (mg["err_over_tol"] <= 1.0 and one["drops"] > 0
            and sum(line) == one["drops"]):
        fail(f"[{tag}] the global dispatch's mesh step differs from the "
             f"one-device step (err/tol {mg['err_over_tol']:.3g}, drops "
             f"{line} vs {one['drops']})")
    if any(r["moe_global"]["mesh"]["loss"] != mg["mesh"]["loss"]
           for r in ranks):
        fail(f"[{tag}] the global dispatch's losses differ across ranks")

    tp_serve_launches = {path: _check_tp_serve(tag, path, ranks)
                         for path in TP_SERVE}

    seconds = time.perf_counter() - t0
    say(f"[{tag}] phase done in {seconds:.1f} s (ranks "
        f"{t_ranks:.1f} s: full width {max(r['full_s'] for r in ranks):.1f}"
        f" s, " + ", ".join(f"{path} {max(r[path + '_s'] for r in ranks):.1f}"
                            " s" for path in TP_SERVE)
        + f", reduced parts {max(r['reduced_s'] for r in ranks):.1f} s); "
        f"training kernel launches summed over the ranks {launches}, serve "
        + ", ".join(f"{path} {n}" for path, n in tp_serve_launches.items()))
    for r in ranks:
        r["full"].pop("log")
        for path in TP_SERVE:
            for k in ("sums", "tokens", "decode_counts"):
                r[path].pop(k)
    return {"ranks": ranks, "launches": launches,
            "tp_serve_launches": tp_serve_launches, "seconds": seconds,
            "step0_vs_one_device": off, "bf16_noise": noise}


class _TpScanTap:
    """Stands in for `ssm_scan_cuda` while a rank's prefill runs: each
    call launches the kernel as the model's would, on the rank's
    channels, and is held against `ssm_scan_plain` on the same ``a, b``
    at the float32 TOL (error over the allclose tolerance)."""

    def __init__(self, ss):
        self.ss, self.kernel, self.excess = ss, ss.ssm_scan_cuda, []
        self.widths = set()

    def __enter__(self):
        self.ss.ssm_scan_cuda = self
        return self

    def __exit__(self, *exc):
        self.ss.ssm_scan_cuda = self.kernel

    def __call__(self, a, b):
        h = self.kernel(a, b)
        want = self.ss.ssm_scan_plain(a, b)
        t = SSM_TOL["float32"]
        self.excess.append(((h - want).abs() / (
            t["atol"] + t["rtol"] * want.abs())).amax())
        self.widths.add(a.shape[-1])
        return h

    def result(self) -> dict:
        import torch

        return {"calls": len(self.excess), "widths": sorted(self.widths),
                "max_err_over_tol": torch.stack(self.excess).amax().item()
                if self.excess else 0.0}


class _CrossTap:
    """Stands in for `flash_attention_cuda` while a rank's decode steps
    run: a cross-attention call (non-causal, a query row against the
    memory's keys: the split-K kernel) launches the kernel as the model's
    would (``plant``: on k/v whose kv heads are rolled by one, each q head
    reading its neighbour's) and is held against the plain version on the
    model's own k/v in float32 at the tight bf16 bound; any other call
    passes through."""

    def __init__(self, fa, plant=False):
        self.fa, self.kernel, self.plant = fa, fa.flash_attention_cuda, plant
        self.excess, self.kernels = [], set()

    def __enter__(self):
        self.fa.flash_attention_cuda = self
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_cuda = self.kernel

    def __call__(self, q, k, v, *, causal=True, **kw):
        if causal or q.shape[2] == k.shape[2]:
            return self.kernel(q, k, v, causal=causal, **kw)
        kk, vk = ((k.roll(1, dims=1).contiguous(),
                   v.roll(1, dims=1).contiguous()) if self.plant else (k, v))
        out = self.kernel(q, kk, vk, causal=False, **kw)
        want, tol = _tight_tol(functools.partial(
            self.fa.flash_attention_plain, causal=False, **kw), q, k, v)
        self.excess.append(_excess(out, want, tol))
        self.kernels.add(self.fa.select_kernel(q, k))
        return out

    def result(self) -> dict:
        import torch

        return {"calls": len(self.excess), "kernels": sorted(self.kernels),
                "max_err_over_tol": torch.stack(self.excess).amax().item()
                if self.excess else 0.0}


def _tp_serve(torch, ctx, path) -> dict:
    """(f), (g) and (h): the tensor-parallel serve plans of ``path``'s
    arch at full width and depth on the 2 x 2 mesh (`TP_SERVE`). Every
    rank builds the same bf16 model (one seed) and binds it to the
    prefill and decode plans, which cut it to the rank's "model" blocks
    (its heads, ``d_ff`` and vocabulary block; hymba's SSM on its
    ``d_inner`` channels, ``in_proj`` its block of each half; seamless's
    encoder and cross-attention on its heads); the prefill runs on the
    rank's rows (sequence-parallel: the ``wgmma`` kernel on the rank's
    heads, hymba's ``ssm_scan`` on its channels, each scan held to
    plain), then the decode plan teacher-forces the prompt and takes
    `TP_SERVE_GEN` greedy steps, the split-K kernel reading the rank's
    cache block or whole ring in place (seamless's cross-attention: on
    the rank's kv heads of the memory, which the mesh's own encoder
    makes). The first `TP_SERVE_TAP` steps past the prompt run under the
    kernel taps. The ranks at "model" 0 run the one-device steps on
    their rows (the kernels in bf16, and the plain version in float32) on
    the tokens the mesh fed. hymba's bf16 noise is of its logits' size,
    so its layout is also held in float32: a float32 copy of each rank's
    compute model, bound to a float32 prefill plan on the mesh, against
    the one-device float32 prefill. The planted faults, on the rank at
    ("data" 0, "model" 1): for hymba that float32 prefill again with the
    contiguous reference block of every ``in_proj`` in place of ``[x_r ;
    z_r]``; for the others the tapped steps again, from a copy of the
    caches taken before them, qwen2-1.5b's first q head on the rank
    (padded head 8 of 16) reading kv head 0, seamless's cross-attention
    reading kv heads off by one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import tree_map
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssm_scan import ssm_scan as ss
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import (decode_step, encode, init_caches,
                                    init_model, prefill)

    arch, S = TP_SERVE[path]
    cfg = get_config(arch)
    vocab, encdec = cfg.vocab_size, bool(cfg.encoder_layers)
    hybrid = cfg.family == "hybrid"
    B, Pn, G, tap_steps = (TP_SERVE_B, TP_SERVE_PROMPT, TP_SERVE_GEN,
                           TP_SERVE_TAP)
    dev = ctx.device
    mesh = make_debug_mesh(*TRAIN_MESH_SHAPE)
    ref = mesh.coords["model"] == 0
    planted = mesh.coords == {"data": 0, "model": 1}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init_model(cfg, LM_SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, vocab, (B, Pn), generator=gen, device=dev)
    enc = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16) if encdec else None
    # The ranks at "model" 0 keep the whole model on the host until the
    # one-device steps (four ranks share the card's memory).
    whole = copy.deepcopy(model).cpu() if ref else None
    pp = st.make_prefill_step(cfg, mesh, ShapeConfig("p", Pn, B, "prefill"))
    dp = st.make_decode_step(cfg, mesh, ShapeConfig("d", S, B, "decode"))
    params_p, params_d = pp.bind(model), dp.bind(model)
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    res = {"coords": dict(mesh.coords), "arch": arch,
           "tensor_parallel": (pp.tensor_parallel, dp.tensor_parallel),
           "compute_bytes": nb(model.parameters()),
           "plan_compute_bytes": dp.compute_param_bytes(),
           "whole_bytes": nb(whole.parameters()) if ref else None,
           "parent_decode_step_bytes": _parent_serve_bytes(dp, cfg, B, S)}
    rows = pp.rows(prompts)
    extra = [pp.rows(enc)] if encdec else []
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0

    scan_tap = _TpScanTap(ss)
    reset_counts()
    t0 = time.perf_counter()
    with scan_tap:
        lpre = pp(params_p, rows, *extra)
    torch.cuda.synchronize()
    res["prefill_s"] = time.perf_counter() - t0
    res["prefill_launches"] = {k: v for k, v in read_counts().items() if v}
    res["scan_tap"] = scan_tap.result()
    kw = {}
    if encdec:
        # The memory of the rank's rows from the mesh's own encoder.
        reset_counts()
        with mesh:
            kw["memory"] = encode(dp.model, cfg, extra[0],
                                  sequence_parallel=True)
        res["encode_launches"] = {k: v for k, v in read_counts().items()
                                  if v}

    tapped = range(Pn, Pn + tap_steps)
    clone = lambda c: tree_map(lambda t: t.clone(), c,  # noqa: E731
                               is_leaf=lambda x: hasattr(x, "clone"))

    def decode(steps, caches, feed, taps, first=0):
        logits, fed, counts, staged, walls, snap = [], [], [], [], [], None
        tok = feed[:, :1]
        for i in range(first, first + steps):
            if i < feed.shape[1]:
                tok = feed[:, i:i + 1]
            if i == tapped[0]:
                snap = clone(caches)
            fed.append(tok)
            before = mesh.staged_bytes
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if i in tapped:
                    for tap in taps:
                        stack.enter_context(tap)
                lg, caches = dp(params_d, caches, tok, i, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            staged.append(mesh.staged_bytes - before)
            counts.append({k: v for k, v in read_counts().items() if v})
            logits.append(lg)
            tok = lg[:, :, :vocab].argmax(-1)
        return logits, torch.cat(fed, dim=1), counts, staged, walls, snap

    taps = [_MappedDecodeTap(fa)] + ([_CrossTap(fa)] if encdec else [])
    caches = dp.cache_blocks(init_caches(cfg, B, S, device=dev))
    logits, fed, counts, staged, walls, snap = decode(Pn + G, caches, rows,
                                                      taps)
    res.update(decode_counts=counts, staged_per_step=staged, step_s=walls,
               taps=[t.result() for t in taps],
               cache_rows=sorted({int(c["attn"].k.shape[3])
                                  for c in caches}),
               sums=[float(lg.float().sum()) for lg in logits],
               tokens=fed[:, Pn:].tolist(),
               prefill_sum=float(lpre.float().sum()),
               finite=bool(all(torch.isfinite(lg).all() for lg in logits)
                           and torch.isfinite(lpre).all()))
    del caches
    if not hybrid:
        ftap = _CrossTap(fa, plant=planted) if encdec else _MappedDecodeTap(
            fa, plant=(cfg.padded_heads // 2, 0) if planted else None)
        flog = decode(tap_steps, snap, fed, [ftap], first=tapped[0])[0]
        res["fault_tap"] = ftap.result()
    else:
        # hymba's bf16 noise is of the logits' own size, so the layout is
        # gated in float32: a float32 copy of the rank's compute model
        # bound to a float32 prefill plan on the same mesh (the kernels'
        # float32 instances), held against the one-device float32
        # prefill; then every rank runs it again (the collectives need
        # all), the planted rank with the contiguous reference block of
        # each in_proj (its resting block) in place of [x_r ; z_r].
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        m32 = copy.deepcopy(dp.model).float()
        pp32 = st.make_prefill_step(cfg32, mesh, ShapeConfig(
            "p", Pn, B, "prefill"))
        params32 = pp32.bind(m32)
        flog = [pp32(params32, rows)]
        saved = 0
        with torch.no_grad():
            for n, p in m32.named_parameters():
                if planted and shard_lib.split_halves(n):
                    p.copy_(params32[n])
                    saved += 1
        flog.append(pp32(params32, rows))
        res["fault_layers"] = saved
        del m32, params32, pp32
    # A plan and its step refer to each other: the cycle collector frees
    # the plans, their compute model and their blocks.
    del snap, pp, dp, params_p, params_d, model
    gc.collect()
    torch.cuda.empty_cache()
    if ref:
        # The one-device steps on the rank's rows, on the same tokens.
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        whole = whole.to(dev)
        w32 = copy.deepcopy(whole).float()
        kw1, kw32 = {}, {}
        if encdec:
            kw1["memory"] = encode(whole, cfg, extra[0])
            kw32["memory"] = encode(w32, cfg32, extra[0].float(),
                                    impl="plain")
        c1 = init_caches(cfg, B // 2, S, device=dev)
        c32 = init_caches(cfg32, B // 2, S, device=dev)
        m_vs_ref, one_vs_ref, m_vs_one = (_Logits(torch, vocab)
                                          for _ in range(3))
        f_vs_ref = _Logits(torch, vocab)
        for i in range(Pn + G):
            tok = fed[:, i:i + 1]
            l1, c1 = decode_step(whole, cfg, c1, tok, i, **kw1)
            l32, c32 = decode_step(w32, cfg32, c32, tok, i, impl="plain",
                                   **kw32)
            m_vs_ref.add(logits[i], l32)
            one_vs_ref.add(l1, l32)
            m_vs_one.add(logits[i], l1)
            if not hybrid and i in tapped:
                f_vs_ref.add(flog[i - tapped[0]], l32)
        noise = one_vs_ref.result()["max_abs_err"]
        pre_one = prefill(whole, cfg, rows, *extra)
        pre32 = prefill(w32, cfg32, rows,
                        *[e.float() for e in extra], impl="plain")
        acc = _Logits(torch, vocab)
        acc.add(pre_one, pre32)
        pre_noise = acc.result()["max_abs_err"]
        acc = _Logits(torch, vocab)
        acc.add(lpre, pre32)
        if hybrid:
            mesh32 = _Logits(torch, vocab)
            mesh32.add(flog[0], pre32)
            res["mesh32_vs_ref"] = mesh32.result()
            f_vs_ref.add(flog[1], pre32)
        res.update(noise=noise, prefill_noise=pre_noise,
                   mesh_vs_ref=m_vs_ref.result(noise),
                   mesh_vs_one=m_vs_one.result(),
                   fault_vs_ref=f_vs_ref.result(),
                   prefill_vs_ref=acc.result(pre_noise))
        del w32, c1, c32, whole, kw1, kw32
    del logits, flog, kw
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    return res


def _check_tp_serve(tag, path, ranks) -> dict:
    """(f), (g) or (h): the gates of `_tp_serve` over the ranks' results;
    returns the kernel launches summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import layer_schedule

    arch, S = TP_SERVE[path]
    cfg = get_config(arch)
    part = "(" + "fgh"[list(TP_SERVE).index(path)] + ")"
    L, encdec = cfg.num_layers, bool(cfg.encoder_layers)
    hybrid = cfg.family == "hybrid"
    steps = TP_SERVE_PROMPT + TP_SERVE_GEN
    # Per layer: the self-attention (and a hybrid's scan, an
    # encoder-decoder's encoder and cross-attention).
    want_pre = {"flash_attention_wgmma": L + (cfg.encoder_layers + L
                                              if encdec else 0)}
    if hybrid:
        want_pre["ssm_scan"] = L
    want_step = {"flash_attention_decode": 2 * L if encdec else L}
    # Each run's cache: the rank's block of its sequence where the kv
    # heads are replicated and it has the plan's rows (16 or more), else
    # whole; a windowed ring has min(S, window) rows.
    rows = {min(S, run.window or S) for run in layer_schedule(cfg)}
    want_rows = sorted(n // 2 if not cfg.shard_kv_heads and S >= 16
                       and n == S else n for n in rows)
    fault = ("cross-attention reading kv heads off by one" if encdec else
             "map (rank 1's first q head reading kv head 0)")
    sv = [r[path] for r in ranks]
    launches = {}
    for i, f in enumerate(sv):
        for counts in [f["prefill_launches"], f.get("encode_launches", {})
                       ] + f["decode_counts"]:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        bad = [c for c in f["decode_counts"] if c != want_step]
        if f["prefill_launches"] != want_pre or bad or \
                len(f["decode_counts"]) != steps:
            fail(f"[{tag}] {part} rank {i}: prefill launched "
                 f"{f['prefill_launches']}, decode steps {bad[:2]}; "
                 f"expected {want_pre} per prefill and {want_step} per step")
        if encdec and f["encode_launches"] != {
                "flash_attention_wgmma": cfg.encoder_layers}:
            fail(f"[{tag}] {part} rank {i}: the memory's encode launched "
                 f"{f['encode_launches']}")
        if not (all(f["tensor_parallel"]) and f["finite"]
                and f["compute_bytes"] == f["plan_compute_bytes"]
                and f["cache_rows"] == want_rows):
            fail(f"[{tag}] {part} rank {i}: tensor-parallel "
                 f"{f['tensor_parallel']}, finite {f['finite']}, compute "
                 f"model {f['compute_bytes']} bytes vs the plan's "
                 f"{f['plan_compute_bytes']}, cache block rows "
                 f"{f['cache_rows']} (expected {want_rows})")
        line = [g for g in sv if g["coords"]["data"] == f["coords"]["data"]]
        if any(g["sums"] != f["sums"] or g["tokens"] != f["tokens"]
               or g["prefill_sum"] != f["prefill_sum"] for g in line):
            fail(f"[{tag}] {part} the ranks of a 'model' line return "
                 "different logits")
        scan = f["scan_tap"]
        if scan["calls"] != (L if hybrid else 0) or \
                not scan["max_err_over_tol"] <= 1.0:
            fail(f"[{tag}] {part} rank {i}: ssm_scan taps {scan}: every "
                 "scan on the rank's channels within the float32 TOL")
        for t in f["taps"]:
            if not (t["calls"] > 0 and t["max_err_over_tol"] <= 1.0
                    and t.get("lse_err_over_tol", 0.0) <= 1.0):
                fail(f"[{tag}] {part} rank {i}: a tapped kernel misses its "
                     f"plain version: {t}")
        planted = f["coords"] == {"data": 0, "model": 1}
        stage = sum(f["staged_per_step"]) / steps
        say(f"[{tag}] {part} {arch} rank {i} {f['coords']}: compute model "
            f"{f['compute_bytes'] / 1e9:.3f} GB (the plan's count) of "
            f"{sv[0]['whole_bytes'] / 1e9:.3f} GB; cache blocks "
            f"{f['cache_rows']} rows (caches of {S}); prefill "
            f"{f['prefill_s'] * 1e3:.1f} ms {f['prefill_launches']}, "
            f"decode step mean {1e3 * sum(f['step_s']) / steps:.1f} ms "
            f"{want_step}; peak {f['peak_bytes'] / 1e9:.2f} GB; staged "
            f"through the host per decode step "
            f"{stage:.0f} bytes (the replicated layout's gathers: "
            f"{f['parent_decode_step_bytes']} bytes); scans vs plain "
            f"{scan['calls']} max err/tol {scan['max_err_over_tol']:.3f} "
            f"(widths {scan['widths']}); kernel taps over the "
            f"{TP_SERVE_TAP} steps past the prompt: "
            + "; ".join(f"{t['calls']} calls max err/tol "
                        f"{t['max_err_over_tol']:.3f}"
                        + (f", log-sum-exp err/tol {t['lse_err_over_tol']:.3f}"
                           if "lse_err_over_tol" in t else "")
                        for t in f["taps"])
            + (f"; planted {fault}: err/tol "
               f"{f['fault_tap']['max_err_over_tol']:.3f}"
               if planted and not hybrid else ""))
        if planted and not hybrid and \
                not f["fault_tap"]["max_err_over_tol"] > 1.0:
            fail(f"[{tag}] {part} the planted {fault} passes: "
                 f"{f['fault_tap']}")
        if f["coords"]["model"] == 0:
            what = (f"{part} {arch} full width on {TRAIN_MESH_SHAPE}, rows "
                    f"of data {f['coords']['data']}")
            say(f"[{tag}] {what}: one-device bf16 vs float32 (the noise) "
                f"{f['noise']:.4e}; prefill {f['prefill_noise']:.4e}")
            _check_noise(f"{what}, prefill (wgmma, sequence-parallel) "
                         "bf16", f["prefill_vs_ref"], f["prefill_noise"],
                         tag)
            _check_noise(f"{what}, decode (split-K on the rank's block) "
                         "bf16", f["mesh_vs_ref"], f["noise"], tag)
            _check_ties(f"{what}, mesh vs one-device bf16 (greedy tokens)",
                        f["mesh_vs_one"], f["noise"], tag)
            fv = f["fault_vs_ref"]
            if hybrid:
                m32 = f["mesh32_vs_ref"]
                bound = TP_SERVE_F32_BOUND * m32["max_abs_logit"]
                say(f"[{tag}] {what}, prefill in float32 (the kernels' "
                    f"float32 instances) vs the one-device float32 prefill: "
                    f"max |dlogit| {m32['max_abs_err']:.4e} (bound "
                    f"{bound:.4e}, {TP_SERVE_F32_BOUND:g} of the largest "
                    f"logit {m32['max_abs_logit']:.4f}); the planted in_proj "
                    f"(rank (0, 1) on its contiguous resting block in "
                    f"{sv[1]['fault_layers']} layers): "
                    f"{fv['max_abs_err']:.4e} "
                    f"({fv['max_abs_err'] / bound:.1f} x the bound)")
                if not m32["max_abs_err"] <= bound:
                    fail(f"[{tag}] {part} the float32 mesh prefill misses the "
                         f"one-device float32 prefill: {m32['max_abs_err']:.4e}"
                         f" over {bound:.4e}")
                if f["coords"]["data"] == 0 and not fv["max_abs_err"] > bound:
                    fail(f"[{tag}] {part} the planted in_proj layout passes "
                         f"the float32 prefill gate ({fv['max_abs_err']:.4e} "
                         f"within {bound:.4e})")
            else:
                say(f"[{tag}] {what}: the planted {fault}: logits vs "
                    f"float32 max |dlogit| {fv['max_abs_err']:.4e} "
                    f"({fv['max_abs_err'] / max(f['noise'], 1e-30):.2f} x "
                    "the noise; information)")
    return launches


# ---------------------------------------------------------------------------
# The dry-run's layer on the card
# ---------------------------------------------------------------------------

def _count_line(c: dict) -> str:
    return (f"{c['flops']:.6e} FLOPs, {c['hbm_bytes']:.6e} bytes, kernels "
            f"{dict(c['kernels'])}")


def phase_dryrun(torch, train, lm, env) -> dict:
    """``[dryrun]``: the cell plans' byte count against the card's
    allocations, the step count with the kernels running against the
    ``meta`` trace, and the roofline shares of ``[train]``'s and
    ``[lm_decode]``'s steps (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.launch import train as tr
    from repro_torch.launch.cost import count, count_cell
    from repro_torch.launch.roofline import (H100_HBM_BYTES_PER_S,
                                             PEAK_FLOPS, model_flops)
    from repro_torch.launch.steps import make_decode_step, make_train_step
    from repro_torch.models import init_caches, init_model
    from repro_torch.optim import AdamWConfig

    tag = "dryrun"
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    out = {}

    # (a) [train]'s state: the plan's count against the allocations.
    loop = tr.TrainLoopConfig(arch=TRAIN_ARCH, reduced=False, seq_len=128,
                              global_batch=8, steps=TRAIN_STEPS, lr=3e-4,
                              warmup_steps=2, device="cuda")
    cfg = tr.loop_model_config(loop)
    shape = ShapeConfig("train", loop.seq_len, loop.global_batch, "train")
    make = lambda: make_train_step(  # noqa: E731
        cfg, None, shape, opt_cfg=AdamWConfig(lr=loop.lr),
        total_steps=TRAIN_STEPS, warmup_steps=loop.warmup_steps)
    plan = make()
    want = plan.per_chip_argument_bytes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    requested = "requested_bytes.all.current"
    before = torch.cuda.memory_allocated()
    asked = torch.cuda.memory_stats().get(requested)
    state = plan.init_state(init_model(cfg, loop.seed, device=dev))
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    stats = torch.cuda.memory_stats()
    if asked is None or requested not in stats:
        fail(f"[{tag}] the caching allocator reports no {requested}")
    asked = stats[requested] - asked
    tensors = (list(state.params.parameters()) + list(state.opt.m.values())
               + list(state.opt.v.values()) + [state.opt.step]
               + list(batch.values()))
    held = sum(t.untyped_storage().nbytes() for t in tensors)
    # The allocator's record of the bytes its callers asked for grows by
    # exactly what the tensors hold; what it allocated is larger by its
    # rounding (each block up to 512 bytes, and the remainder of a
    # segment left unsplit).
    say(f"[{tag}] (a) {TRAIN_ARCH} train state (B {loop.global_batch}, T "
        f"{loop.seq_len}; bf16 parameters, float32 moments, the step, the "
        f"int32 batch): per_chip_argument_bytes {want}; the {len(tensors)} "
        f"tensors built on the card hold {held} bytes; the allocator's "
        f"{requested} grew {asked} as they were built, and "
        f"torch.cuda.memory_allocated() {grown} ({grown - asked} more: "
        "its rounding)")
    if not held == want == asked or grown < asked:
        fail(f"[{tag}] the plan counts {want} bytes; the state holds {held},"
             f" the card was asked for {asked} and allocated {grown}")
    n_tensors = len(tensors)
    out["state_bytes"] = {"per_chip_argument_bytes": want, "held": held,
                          "requested": asked, "grown": grown,
                          "tensors": n_tensors}

    # (b) Each step counted on the card (kernels running) and on meta.
    reset_counts()
    t1 = time.perf_counter()
    _, card = count(plan, state, batch)
    torch.cuda.synchronize()
    train_card = card.summary()
    train_card_s = time.perf_counter() - t1
    del state, batch, plan, card
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train_meta, _ = count_cell(make())
    train_meta_s = time.perf_counter() - t1

    lcfg = get_config(LM_ARCH)
    dshape = ShapeConfig("decode", LM_MAX, LM_B, "decode")
    dplan = make_decode_step(lcfg, None, dshape)
    params = dplan.bind(init_model(lcfg, LM_SEED, device=dev))
    caches = init_caches(lcfg, LM_B, LM_MAX, device=dev)
    tokens = torch.zeros((LM_B, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    _, card = count(dplan, params, caches, tokens, pos)
    torch.cuda.synchronize()
    launches = read_counts()
    decode_card = card.summary()
    del params, caches, dplan, card
    torch.cuda.empty_cache()
    decode_meta, _ = count_cell(make_decode_step(lcfg, None, dshape))
    for what, c, m in (("train", train_card, train_meta),
                       ("decode", decode_card, decode_meta)):
        say(f"[{tag}] (b) {what} step counted on the card: "
            f"{_count_line(c)}; traced on meta: {_count_line(m)}")
        if (c["flops"], c["hbm_bytes"], c["kernels"]) != (
                m["flops"], m["hbm_bytes"], m["kernels"]):
            fail(f"[{tag}] the {what} step counts differently on the card "
                 "and on meta")
    if not decode_card["kernels"].get("decode_attention"):
        fail(f"[{tag}] the decode step ran no decode kernel")
    say(f"[{tag}] (b) the train step counted in {train_card_s:.1f} s on "
        f"the card, {train_meta_s:.1f} s on meta; kernel launches "
        f"{launches}")

    # (c) The roofline of each step against the wall its phase measured.
    card_name = env["nvidia_smi"]
    rows = {}
    for what, c, c_cfg, c_shape, wall_ms in (
            ("train", train_card, cfg, shape,
             train["full_width"]["ms_per_step"]),
            ("lm_decode", decode_card, lcfg, dshape, lm["ms_per_step"])):
        peak = PEAK_FLOPS[c_cfg.compute_dtype]
        compute_ms = c["flops"] / peak * 1e3
        memory_ms = c["hbm_bytes"] / H100_HBM_BYTES_PER_S * 1e3
        bound_ms = max(compute_ms, memory_ms)
        mf = model_flops(c_cfg, c_shape)
        rows[what] = {
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "dominant": "compute" if compute_ms >= memory_ms else "memory",
            "wall_ms": wall_ms, "roofline_share": bound_ms / wall_ms,
            "model_flops": mf, "mfu": mf / peak / (wall_ms / 1e3),
            "flops": c["flops"], "hbm_bytes": c["hbm_bytes"]}
        r = rows[what]
        say(f"[{tag}] (c) [{what}] {c_cfg.name} step (B "
            f"{c_shape.global_batch}, {'T' if what == 'train' else 'S'} "
            f"{c_shape.seq_len}): compute {compute_ms:.3f} ms "
            f"({c['flops']:.4e} FLOPs at {peak / 1e12:.0f} TFLOP/s), "
            f"memory {memory_ms:.3f} ms ({c['hbm_bytes']:.4e} bytes at "
            f"{H100_HBM_BYTES_PER_S / 1e12:.2f} TB/s): {r['dominant']}-"
            f"bound; measured {wall_ms:.2f} ms per step, roofline share "
            f"{r['roofline_share']:.2%}; model FLOPs {mf:.4e}, MFU "
            f"{r['mfu']:.2%}; on {card_name}")
    seconds = time.perf_counter() - t0
    say(f"[{tag}] phase done in {seconds:.1f} s")
    out.update(train_card=train_card, train_meta=train_meta,
               decode_card=decode_card, decode_meta=decode_meta,
               roofline=rows, launches=launches, card=card_name,
               seconds=seconds)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        say(f"[time] phase {name}: {phase_s[name]:.1f} s")
        return out

    env = timed("environment", phase_environment, torch)
    build = timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, torch)
    pack = timed("pack", phase_pack, torch)
    main_path, oneshot = timed("main_path", phase_main_path, torch)
    prof = timed("profile", phase_profile, torch)
    slr, _ = timed("main_path_slr", phase_main_path, torch, "slr", "slr")
    slr_prof = timed("profile_slr", phase_profile, torch, "slr", "slr")
    matrix = timed("matrix", phase_matrix, torch)
    sqrt = timed("sqrt", phase_sqrt, torch)
    adaptive = timed("adaptive", phase_adaptive, torch)
    autotune = timed("autotune", phase_autotune, torch)
    stream, stream_stats = timed("stream", phase_stream, torch, oneshot)
    chaos = timed("chaos", phase_chaos, torch, stream_stats)
    tenants = timed("tenants", phase_tenants, torch)
    surface = timed("surface", phase_surface, torch)
    ssm = timed("ssm_scan", phase_ssm_scan, torch)
    flash = timed("flash", phase_flash, torch)
    # The LM phases infer: no gradient (the kernels refuse inputs that
    # need one, and a layer called directly on the model's parameters
    # would pass them one).
    with torch.no_grad():
        lm = timed("lm_decode", phase_lm_decode, torch)
        hybrid = timed("lm_hybrid", phase_lm_hybrid, torch)
        moe = timed("lm_moe", phase_lm_moe, torch)
        grok = timed("lm_grok", phase_lm_grok, torch)
        xlstm = timed("lm_xlstm", phase_lm_xlstm, torch)
        encdec = timed("lm_encdec", phase_lm_encdec, torch)
        mrope = timed("lm_mrope", phase_lm_mrope, torch)
    train = timed("train", phase_train, torch)
    with torch.no_grad():
        mesh = timed("mesh", phase_mesh, torch)
    train_mesh = timed("train_mesh", phase_train_mesh, torch, train)
    dryrun = timed("dryrun", phase_dryrun, torch, train, lm, env)

    rows = []
    for kind in ("filtering_combine", "smoothing_combine"):
        t = kernels[kind]["timing"]["float64"]
        err = max(c["max_abs_err"] for c in kernels[kind]["checks"]
                  if c["dtype"] == "float64")
        by_path = {"main": main_path["launches"][kind],
                   "slr": slr["launches"][kind],
                   "matrix": matrix["launches"][kind],
                   **{f"adaptive_{m}": adaptive[m]["launches"][kind]
                      for m in ("ekf", "slr")},
                   **{tag: res["launches_by_kernel"][kind] for tag, res in (
                       ("stream", stream), ("chaos", chaos),
                       ("tenants", tenants))},
                   "surface": surface["launches"][kind],
                   "train": train["launches"][kind],
                   "mesh": mesh["launches"].get(kind, 0),
                   "train_mesh": train_mesh["launches"].get(kind, 0)}
        rows.append({"launches": sum(by_path.values()),
                     "launches_by_path": by_path, "max_abs_err": err,
                     "ms": t["in_place_graph_ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "packed_ms": t["graph_ms"], "event_ms": t["ms"],
                     "surface_b1_top_level":
                         surface["b1_top_level"][kind]})
    for res in (ssm, flash):
        rows.append({k: res[k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")})
    lm_times = ("ms", "graph_ms", "plain_ms", "library_ms",
                "library_graph_ms", "bound_ms", "max_abs_err")
    ssm_paths = {"ssm_scan": ssm["launches"],
                 "lm_hybrid_prefill": hybrid["ssm_launches"],
                 "lm_xlstm_prefill": xlstm["ssm_launches"],
                 "train": train["launches"]["ssm_scan"],
                 "mesh": mesh["launches"].get("ssm_scan", 0),
                 "train_mesh": train_mesh["launches"].get("ssm_scan", 0),
                 **{path: n.get("ssm_scan", 0) for path, n in
                    train_mesh["tp_serve_launches"].items()}}
    rows[-2].update(launches=sum(ssm_paths.values()),
                    launches_by_path=ssm_paths,
                    **{path: {k: res["ssm_scan"][k] for k in lm_times}
                       for path, res in (("lm_hybrid_prefill", hybrid),
                                         ("lm_xlstm_prefill", xlstm))})
    flash_paths = {"flash": flash["launches"], **lm["launches_by_path"],
                   **hybrid["launches_by_path"], **moe["launches_by_path"],
                   **grok["launches_by_path"], **encdec["launches_by_path"],
                   **mrope["launches_by_path"],
                   "train": sum(n for k, n in train["launches"].items()
                                if k.startswith("flash_attention")),
                   "mesh": sum(n for k, n in mesh["launches"].items()
                               if k.startswith("flash_attention")),
                   "train_mesh": sum(
                       n for k, n in train_mesh["launches"].items()
                       if k.startswith("flash_attention")),
                   **{path: sum(n for k, n in counts.items()
                                if k.startswith("flash_attention"))
                      for path, counts in
                      train_mesh["tp_serve_launches"].items()},
                   "dryrun": sum(n for k, n in dryrun["launches"].items()
                                 if k.startswith("flash_attention"))}
    rows[-1].update(launches=sum(flash_paths.values()),
                    launches_by_path=flash_paths,
                    launches_by_kernel=flash["launches_by_kernel"],
                    **{path: {k: res[f"{name}_attention"][k] for k in lm_times}
                       for path, res, name in (
                           ("lm_decode", lm, "decode"),
                           ("lm_prefill", lm, "prefill"),
                           ("lm_hybrid", hybrid, "decode"),
                           ("lm_hybrid_prefill", hybrid, "prefill"),
                           ("lm_moe", moe, "decode"),
                           ("lm_moe_prefill", moe, "prefill"),
                           ("lm_grok", grok, "decode"),
                           ("lm_grok_prefill", grok, "prefill"),
                           ("lm_encdec", encdec, "decode"),
                           ("lm_encdec_prefill", encdec, "prefill"),
                           ("lm_mrope", mrope, "decode"),
                           ("lm_mrope_prefill", mrope, "prefill"))},
                    **{f"tp_serve_hybrid_{part}": {k: t[k] for k in lm_times}
                       for part, t in hybrid["tp_decode_attention"].items()})
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, **row}
            for (name, (replaces, source)), row in zip(KERNELS.items(), rows)]
    say("[kernels] " + ", ".join(
        f"{r['name']}: parity ok, {r['ms'] * 1e3:.2f} us/launch "
        f"(bound {r['bound_ms'] * 1e3:.2f} us)" for r in rows))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"env": env, "build": build, "kernels": kernels, "pack": pack,
         "main_path": main_path, "profile": prof, "slr": slr,
         "slr_profile": slr_prof, "matrix": matrix, "sqrt": sqrt,
         "adaptive": adaptive, "autotune": autotune, "stream": stream,
         "chaos": chaos, "tenants": tenants, "surface": surface,
         "ssm_scan": ssm,
         "flash_attention": flash, "lm_decode": lm, "lm_hybrid": hybrid,
         "lm_moe": moe, "lm_grok": grok, "lm_xlstm": xlstm,
         "lm_encdec": encdec, "lm_mrope": mrope, "train": train,
         "mesh": mesh, "train_mesh": train_mesh, "dryrun": dryrun,
         "phase_s": phase_s, "seconds": time.perf_counter() - t_start},
        indent=1,
        default=str))
    say(f"[chip_smoke] all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s on {env['nvidia_smi']}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device"], "count": env["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
