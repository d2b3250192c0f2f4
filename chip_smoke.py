#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the process exits nonzero):
  1. PyTorch's TF32 flags are left as PyTorch sets them: the port runs its
     float path with TF32 off by itself (``fp32_exact``), which phase 8
     shows.
  2. The card's name and power limit; build every CUDA kernel of
     ``src/repro_torch/csrc`` with nvcc (one process per source, in
     parallel) and print ptxas' register and spill counts.
  3. Each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ``bitflip`` and ``quant_bitflip`` bitwise for all
     four fault models, every storage type, rates 0 / 1e-3 / 0.2 and an
     all-zero row, ``bitflip`` also with its fused dequantization
     (bitwise ``bitflip_ref(...).float() * scale``); ``fault_matmul`` at
     both main-path shapes (ResNet18's fc 512x512x16, AlexNet's fc0
     512x4096x1024) for int8, int16 and int32 weights, bitwise at
     x = I_K and, at random x, within 2 K 2^-24 (|x| @ |w|): both sides'
     worst-case fp32 accumulation error, whatever the order of the sums.
     Then each kernel's times: its device time (a CUDA graph of 20
     launches replayed between events, so no host cost), its wrapper time
     (events around back-to-back Python calls), its plain version's, the
     library call's where one exists, and the bound.  ``fault_matmul`` on
     bf16 x (the transformer path) at olmo-1b's three projection shapes
     with M = B S = 2048 (2048x2048, 2048x8192, 8192x2048), int8 and int32
     weights, all four fault models: bitwise bf16(q' scale) at x = I_K,
     and at random bf16 x within 2 K 2^-24 (|x| @ |w|) + 2^-8 (|k| + |p|)
     (1 + 2^-7): both sides sum exact products in fp32 in some order, then
     round once to bf16 (half an ulp, at most 2^-8 of the magnitude); its
     two kernels alone: the hash pass (``fault_weight_tiles``) bitwise
     bf16(q' scale) for every row, the product (``matmul_tiles``) within
     the same bound of its plain version; 9 rows at 2048x8192, two row
     groups, each bitwise its one-row call; the call's device time beside
     ``torch.matmul`` on the same bf16 shapes, each kernel's own times
     beside its own bound, and an 8-row call at 2048x2048 against one
     row, the call and the product alone; the product alone at
     starcoder2-3b's kv projection (2048x3072x256, K in slices) within the
     same bound, 3 rows each bitwise its one-row call, timed beside
     ``torch.matmul``; and
     ``quant_bitflip``'s times at the transformer's unit input, one row of
     [8, 256, 2048] bf16, after checking it bitwise against its plain
     version there for all four fault models on signed bf16 x, four rows
     at rates 0.2 / 0 / 4e-3 / 0.1, and then in one grouped call beside
     the CNN's unit input (four float32 rows, one all zero), seamless's
     float32 encoder input at a 0-d rate, a bf16 leaf expanded over three
     rows (stride 0) and a bf16 view whose rows start off a 16-byte
     boundary, each tensor bitwise its plain version.  The bf16 checks, times and bounds
     use phase 9's 6 faulty bits; the others the CNN path's 4 (and
     ``bitflip`` is checked at 4, 6 and 8).  For phases 10 and 10b, at 6
     faulty bits: ``bitflip`` at mixtral-8x7b's expert tensor
     [8, 4096, 14336] int8 (one row) and recurrentgemma-2b's recurrent
     weight [2560, 2560] (three rows, all four fault models), integers out
     and dequantized straight to float32 and to bf16, each bitwise
     ``(q'.float() * scale).to(dtype)``; bf16 ``fault_matmul`` at
     recurrentgemma-2b's four projection shapes (2560x2560, the kv
     projection 2560x256 with K in slices, 2560x7680, 7680x2560; int8,
     all four fault models) as at olmo-1b's; ``quant_bitflip`` bitwise at
     its unit input [1, 8, 256, 2560] bf16; each timed as above.  For
     phase 11, at 6 faulty bits: ``fault_matmul`` on float32 x with bf16
     weights (``out_dtype=bfloat16``, the encoder's projections and the
     cross-attention K/V, M = B Se = 8 x 32 = 256) at 1024x1024, 1024x4096
     and 4096x1024, int8, all four fault models, bitwise
     float(bf16(q' scale)) at x = I_K, at random x within
     2 K 2^-24 (|x| @ |w|) of its plain version, each of 3 rows bitwise
     its one-row call; its product alone (``matmul_tiles_f32``) within the
     same bound of its plain version on the hash pass's W'; the call and
     the product each timed beside ``torch.matmul`` on the same float32
     operands and its own bound; bf16 x at the
     decoder's shapes (M = 2048) as at olmo-1b's; ``quant_bitflip``
     bitwise at [1, 8, 32, 1024] float32 and [1, 8, 256, 1024] bf16; and
     ``bitflip`` bitwise on a [1024] LayerNorm leaf dequantized to bf16.
     The glue kernels (``csrc/glue.cu``): ``swiglu`` bitwise its op-by-op
     chain over every bf16 h1 (16 h3 values), and ``swiglu`` and ``rope``
     bitwise at olmo-1b's shapes in bf16, fp16 and float32 (``rope`` also
     at decode's [8, 1] positions), then timed in bf16 beside their bound
     and the chain's device time (RoPE's with the tables it built at every
     call).  Phases 9, 13, 16, 17 and 18 check the glue counters: a
     forward that autograd differentiates (training) runs the op-by-op
     chains, counted in ``ops.unfused``, and launches neither kernel; any
     other launches both and runs no chain (phase 9: one ``swiglu`` and
     two ``rope`` a unit step).
  4. The whole-forward path: ResNet18 at width 1.0 (channels 64-512), img
     32, 16 classes, n_eval=512, labels = the clean model's own argmax;
     ``AFarePart`` (NSGA-II pop 24, 3 generations) under the kernel backend
     and ``eval_strategy="full"``, then ``FaultUnawareBaseline``.  The
     launch counters are zeroed just before and read just after; all three
     kernels must have launched.
  5. One ΔAcc population on AlexNet at width 1.0 (fc0 is 512x4096x1024),
     its launches counted the same way.
  6. Generic against kernel ΔAcc on one ResNet18 population.
  7. Where the time of one ResNet18 candidate goes (torch.profiler): each
     kernel's total per candidate and the elementwise glue.
  8. The staged path, the default: the same ``AFarePart`` search through
     the chain-fused staged engine (kernel backend, ``eval_batch_size=
     "auto"``, a 16 GiB activation store), its launches counted as in
     phase 4; its front and every evaluated row's ΔAcc bitwise equal to
     phase 4's, its wall time beside a warm rerun of the full search, the
     engine's counters, the store's peak bytes and the allocator's peak.
     Then one population fused against unfused in turns (bitwise), the
     reference's default tables + staged against kernel + staged (within
     2/n_eval), a profile of the fused walk (its idle share), one
     candidate under PyTorch's default TF32 flags against the flags off
     (equal), the cost per row of an 8-row whole forward against a 1-row
     one, and ``python -m repro_torch.quickstart`` at 20 training steps
     and 2 generations.
  9. The dense transformer path: olmo-1b at its published widths (16
     layers, d_model 2048, 16 heads, d_ff 8192, vocab 50304, bf16, depth
     uncut), weights from ``init_lm`` with a seeded generator on the card,
     B = 8 sequences of S = 256 tokens from a numpy seed, labelled with the
     clean model's own argmax (the label spread is printed and checked;
     the share of labels that are their own input token is printed: with
     random tied weights at full width it is all of them, the probe is
     the identity, and ΔAcc counts the tokens a fault moves off
     themselves).
     ``FaultSpec(bits=8, faulty_bits=6)`` at 0.2/0.2 over ``POD_TIERS_4``:
     with random weights and tied embeddings the reference replay's 4
     LSBs move no token at full width (a probe population at 4 LSBs is
     printed, and changes nothing), so the regime is pinned at 6.
     ``lm_partitioner`` (pop 24, 3 generations) under the kernel backend,
     staged and fused with ``eval_batch_size="auto"``, then the same
     search through ``eval_strategy="full"``: every evaluated row and both
     fronts bitwise equal, the spread of ΔAcc over the rows checked (it
     must neither vanish nor saturate), wall times, ``staged_stats()`` and
     launches per path printed.  One candidate's wall, 5 readings, and
     its profile by kernel group;
     generic against kernel on 4 rows; starcoder2-3b at its published
     widths, depth cut to 4 layers, one population of 8 rows (GQA,
     LayerNorm with bias, gelu, an untied head, ``bitflip`` on the norm
     params).
 10. The RG-LRU path: recurrentgemma-2b at its published widths and full
     depth (26 layers of (rglru, rglru, local) in 9 groups, the 27th slot
     built and never run; d_model 2560, 10 heads of 256 with 1 kv head,
     d_ff 7680, lru_width 2560, vocab 256000, bf16, tied embeddings),
     ``init_lm``'s seeded weights on the card, the same batch and
     self-labels as phase 9.  Probes at 4, 6 and 8 faulty bits are
     printed; the search runs at ``RG_FAULTY_BITS``.  ``lm_partitioner``
     staged and full as in phase 9, bitwise over every row and both
     fronts, ``bitflip``, ``fault_weight_tiles``, ``matmul_tiles`` and
     ``quant_bitflip`` each launched; one candidate's wall and profile,
     with the RG-LRU scan's own range.
 10b. One population of 8 rows each, kernel backend, ``eval_batch_size=
     "auto"``: mixtral-8x7b at full width (8 experts of d_ff 14336, top 2,
     capacity factor 2.0, so C = T/2) cut to 2 layers, and mamba2-2.7b at
     full width (d_inner 5120, 80 heads, state 128) cut to 8 layers; each
     one's launches, ΔAcc spread and allocator peak.
 11. The encoder-decoder: seamless-m4t-medium at its published widths and
     depth (12 encoder and 12 decoder layers, d_model 1024, 16 heads of
     64, ReLU MLP of 4096, LayerNorm, an untied head of 256206 rows, bf16;
     0.98 B params), ``init_lm``'s seeded weights on the card, B = 8
     sequences of S = 256 tokens and the float32 encoder input [8, 32,
     1024] from a numpy seed, self-labels (their spread and the share that
     are their own input token printed).  Probes at 4, 6 and 8 faulty bits
     are printed; the search runs at the first whose ΔAcc neither vanishes
     nor saturates.  ``lm_partitioner`` staged and fused with
     ``eval_batch_size="auto"``, then full, bitwise over every row and both
     fronts; the staged store holds the memory once per encoder prefix
     and every decoder carry's ``"mem"`` is a ``PrefixRef``;
     ``fault_matmul`` on both x dtypes, ``quant_bitflip`` and ``bitflip``
     each launched; one candidate's wall and profile.
 12. The online loop (paper Alg. 1, lines 13-19), run right after phase 8
     on its ResNet18 plan and staged kernel-backend evaluator:
     ``simulate_deployment`` over 8 ticks of a ``FaultEnvironment`` whose
     one step, at t = 3, makes the most reliable device the plan uses 25x
     worse; ``observe_fn`` sets the evaluator's ``device_fault_scale`` and
     returns the deployed partition's true ΔAcc; θ is 1.5x the observed
     ΔAcc at the base scales, 3 re-optimization generations.  At least one
     swap, the observed ΔAcc after it no higher than at the trigger, no
     rebuild of the kernel backend (``_fault_env_rebuilds``); a
     ``ReoptJob`` drained a generation at a time equal, bitwise, to the
     synchronous step from the same state, with all three CNN kernels
     launched in it; each tick's wall time printed.
 13. Serving: olmo-1b at its published widths and full depth (16 layers,
     bf16, 1.177 B params, ``init_lm``'s seeded weights) through
     ``serve.Engine`` under the trace of ``benchmarks/serve.py``: 48
     engine steps and a drain, Poisson arrivals at 0.5 a step (numpy
     seeds), prompts of 4-12 tokens and 8-16 new tokens, 8 slots of 64, a
     canary every 4 decode steps, 4 re-optimization generations a job,
     ``lm_partitioner`` (population 16, 8 generations) over ``POD_TIERS``
     at ``FaultSpec(0.2, 0.2, bits=8)``, tier 1 64x worse at step 12 and
     512x at step 32 behind a ``FaultMonitor`` fed Poisson error counts.
     The canary observes with the sensitivity surrogate (the random-weight
     probe is the identity).  Every decode step is faulted: each float
     leaf of each layer and its input corrupted by ``quant_bitflip`` at 16
     bits with 4 faulty, one whole tensor each, a layer's 8 tensors in one
     grouped call (one launch pair).  First, ``quant_bitflip`` bitwise
     against its plain version at those shapes ([2048,2048], [2048,8192],
     [8192,2048] and the input [8,1,2048], bf16, one row, all four fault
     models), each timed beside its bound; then one whole layer as one
     group, bitwise tensor by tensor for all four models, timed beside the
     sum of its tensors' bounds.  The phase fails on
     a dropped request, no re-opt swap, a swap that does not strictly
     lower the observed ΔAcc, a swap stall above max(mean decode step,
     5 ms), monitor time at or above 5% of decode time, a host wait other
     than each decode step's argmax and each admission's first token (sync
     debug mode), ``quant_bitflip`` launches other than 2 a layer in each
     decode step (32 for 16 layers), a profiled faulted step with more fill
     or memset kernels than the clean one (the amax workspace is never
     cleared), or a first token that is not the argmax of
     ``transformer.forward`` on the request's right-aligned prompt.  It prints TTFT and TPOT means,
     tokens a second, the swap events, and one faulted and one clean
     decode step of the full batch: wall, busy time by kernel group, idle
     share and the host's time by op.
 14. Training (``repro_torch.train``), run last.  a: olmo-1b at its
     published widths and depth (bf16, 1.177 B params, ``init_lm``'s
     seeded weights) trained by ``Trainer`` for ``TRAIN_STEPS`` steps on
     ``TokenStream(vocab=4096, seq_len=256, batch=8, seed=0)`` (ids below
     4096 are valid olmo ids), two microbatches, AdamW with warmup and a
     cosine; it prints the loss (means of the first and last 5 steps), the
     grad norm, the step's dt median and range, tokens a second, the
     allocator's peak and the host waits by Python line (sync debug mode),
     and one profiled step's busy time by kernel group, the optimizer's
     kernels (inside its ``train.adamw_update`` span) apart, and its idle
     share against the median step.  It fails on a non-finite loss, a last-5
     mean not below the first-5 mean, or more than one host wait a step.
     c: the trained model's self-labels on the held-out
     ``TokenStream(seed=1)`` batch of 8 x 256, their spread and the share
     equal to their own input token beside the untrained model's on the
     same batch (it fails unless the trained share is lower); ΔAcc probe
     populations at 4, 6 and 8 faulty bits (kernel backend,
     ``FaultSpec(bits=8)`` at 0.2/0.2 over ``POD_TIERS_4``), whether the
     paper's 4 LSBs move tokens, then ``lm_partitioner`` (pop 24, 3
     generations) staged, then full, bitwise, at the first regime whose
     ΔAcc neither vanishes nor saturates; ``quant_bitflip``,
     ``fault_weight_tiles`` and ``matmul_tiles`` must each launch in the
     staged search.  b: the example's config (``train_lm.build_100m``,
     float32; its 16384-token stream built once and rewound): the same
     step twice bitwise, the ops PyTorch flags as nondeterministic in it
     (``use_deterministic_algorithms(True, warn_only=True)``, put back
     after), then 2k steps straight against k steps, a checkpoint (its
     save and restore timed), a fresh ``Trainer`` that restores it and k
     more: params and optimizer state bitwise equal.  Checkpoints go to a
     temporary directory removed afterwards.
 15. Multi-device evaluation (``core.eval_engine.DeviceScheduler``), run
     on the CNN right after phase 12 and on olmo-1b right after phase 9.
     a: ``DeviceScheduler("auto").n_devices`` and the cards' names.  b:
     phase 8's staged ResNet18 search and phase 4's full one, then phase
     9's olmo-1b ``lm_partitioner`` search staged and full, each on a pool
     of four slots on one card (``devices=[card] * 4``; ``"auto"`` chunks
     fitted to a quarter of the card a slot).  Each fails unless every
     evaluated row's accuracy and the front are bitwise the one-slot
     run's (same NSGA-II seed, so the same rows), the path's kernels
     launched (counts zeroed just before the search, read just after),
     the host waited at most once a ``delta_acc`` call (sync debug mode),
     one replica of the weights is resident (``_replicas``; for olmo-1b
     the allocator's bytes beyond the store under twice the integer
     copy's), and (staged) ``device_dispatches`` sums to ``dispatches``
     over every slot a depth-0 gene was given (prefix groups: one slot a
     gene, so two of four for the paper's two devices).  The walls print
     beside the one-slot walls.  c: a ``[card, host]`` pool on ResNet18 at
     the CPU tests' size (width 0.25, img 16, 8 images, kernel backend),
     staged and full: a tensor left on the wrong slot's device would make
     PyTorch raise; the host slot runs (a replica there), rows on the card
     slot are bitwise the one-slot run's and every row within 1/n_eval.
     d: with two cards or more, b's searches on ``devices="auto"``;
     otherwise one line says the host has one card.
 16. The launch stack (``repro_torch.launch``), run before 18.  a: olmo-1b at
     its published widths and depth (bf16) through
     ``steps.abstract_pp_train_step`` on a ``(pod=4, data=1, model=1)``
     mesh of four slots of the card, the pipeline cut by phase 9's
     ``lm_partitioner`` plan over ``POD_TIERS_4`` (``contiguous_stages``
     -> ``group_cuts``), phase 14's first ``TokenStream`` batch of 8 x 256
     in 4 microbatches, ``PP_STEPS`` steps of GPipe and AdamW; it prints
     the cuts and stage lengths, the first loss beside ``make_loss_fn``'s
     on the same params and batch (it fails beyond 2^-8 of the loss: both
     run the same bf16 ops a row, but cuBLAS may pick another algorithm
     for 2 rows than for 8), the losses (the last must be below the
     first), the step walls, tokens a second, the allocator's peak, the
     host waits a step (limit 1, sync debug mode), ``model_flops /
     (wall x 989 TFLOP/s)`` (``launch/roofline.py``) and the port kernels
     launched over the steps (it fails unless none: the launch stack's
     training steps take no faults, as the reference's do not; phase 17
     trains with them).  b: olmo-1b prefilled
     (8 prompts of 64) by ``abstract_serve_prefill`` and decoded
     ``SHARD_STEPS`` faulted steps (phase 13's regime: 16 bits, 4 faulty,
     rates 0.2 x the tier scale of the plan's layers, a grouped
     ``quant_bitflip`` pair a layer) by ``abstract_serve_decode`` with
     every attention cache's 128 slots split over four slots of the card
     (``data=1, model=4``), beside the unsharded ``decode_step``: the
     prefill's logits bitwise, the greedy tokens equal on every step, the
     logits within 2^-5 of the largest (the shards' partials are summed in
     another order, and a bf16 rounding or a 16-bit grid step may move),
     and ``2 n_layers`` ``quant_bitflip`` kernels a sharded step; the step
     walls print.  c: ``train.compression.compress_psum`` over four slots
     of the card, slot ``s`` holding the first layer group's gradient of
     16a's stage ``s``, three calls (the error feedback carries), every
     mean and residual bitwise the same call on the host.  d: ``python -m
     repro_torch.launch.train --arch olmo-1b --steps 10 --device cuda``
     (the reduced config): its loss falls.
 17. Training with faults, run right after phase 14 (before phase 16).
     a: ``quant_bitflip`` under autograd (``ops.quant_bitflip_group`` with
     an input that requires grad) at a faulted olmo-1b step's shapes:
     layer 0's float leaves as ``_inject`` groups them (expanded over one
     row, seeds + 977 j) and a microbatch's block input [1, 4, 256, 2048],
     bf16, 16 bits with 4 faulty: the forward with the q' store bitwise
     the plain version's outputs and its integers (int32), one launch pair
     a group; the backward (the reference's scale-only gradient, plain
     PyTorch) against autograd through the plain version on the card: the
     same nonzero entries, each within 2^-20 sum|g q'| / qmax of its row
     plus 2^-8 of its value; each group's device time with the q' store
     and without, the plain forward's and the backward's times, and the
     bound (bytes: x read, out and q' written; operations: the hash).  b:
     olmo-1b at its published widths and depth (bf16, phase 14's init),
     phase 14's first ``TokenStream`` batch of 8 x 256 (vocab 4096) in 2
     microbatches without remat, rates 0.2 x the ``POD_TIERS_4`` fault
     scale of phase 9's plan (as phase 16b), seed 17: each microbatch's
     loss and gradients through ``make_loss_fn(fault=...)`` with the
     kernels and with the plain versions (``ops.quant_bitflip_group``
     swapped for ``ref.quant_bitflip_group_ref``) on the card: the losses
     and every gradient leaf bitwise (the kernel's outputs and q' are the
     plain version's bits, and the backward runs the same PyTorch ops on
     them), and some block leaf with the reference's few nonzero entries
     a layer; then
     ``FAULT_TRAIN_STEPS`` faulted ``make_train_step`` steps and as many
     unfaulted ones (phase 14's step) after a warm-up each, as
     ``Trainer.run`` takes them: step wall (median), tokens a second, the
     allocator's peak, host waits a step (limit 1, sync debug mode), the
     launches a step (it fails unless ``quant_bitflip`` > 0 and every
     other kernel 0 when faulted, and all 0 when not) and one profiled
     step's busy time and idle share.  c: ``repro_torch.
     serve_fault_resilient.main(["--device", "cuda"])``, the online-phase
     entry point, once: its plan, reconfiguration events and swaps.
 18. FSDP x tensor parallelism (``launch/collectives.py``, the
     ``layers.Sharded`` blocks), run after phase 16, olmo-1b at its
     published widths and depth in bf16 on slots of the card, params and
     AdamW state laid out by ``param_specs`` / ``opt_state_specs``
     (``shardings.place_params``).  a: ``abstract_train_step`` on
     ``(data=2, model=2)``, phase 14's first batch (8 x 256, vocab 4096),
     ``TP_STEPS`` steps with remat: the first loss beside the unsharded
     ``make_train_step(microbatches=2)``'s (limit 2^-8 of it: the
     row-parallel sums round once a slot before their fp32 sum) and the
     updated params beside its update (limit 2 lr + 2^-6 max(|p|, |p'|)
     an element: AdamW's first step moves a param by about lr·sign(g), and
     bf16 rounds both results), the losses, step walls, host waits a step (limit 1, sync
     debug mode), the allocator's peak and the collective bytes a step
     (``collectives.BYTES``).  b: prefill (8 prompts of 64) and
     ``SHARD_STEPS`` faulted decode steps (phase 16b's regime) on ``(1,
     4)`` and on ``(2, 2)``, beside the unsharded steps fed the same tokens:
     the logits' largest difference, the share of argmax tokens that agree
     (it fails below ``TP_AGREE``) and the ``quant_bitflip`` kernels a
     step and a computing row (each corrupts its layers whole, one grouped
     pair a layer: it fails unless ``2 n_layers`` a row).  On ``(2, 2)``
     the batch splits over the data rows, so each row's activation grid
     is its own half batch's.  c: a ``seq_axis="model"`` train step on
     ``(1, 4)``: its loss beside a's unsharded one (limit 2^-8).  d: the
     pipeline's two stages on ``(1, 1, 2)`` sub-meshes (a ``(2, 1, 2)``
     mesh) cut by phase 9's plan, ``TP_STEPS`` steps: the first loss
     beside ``make_loss_fn``'s (limit 2^-8), no port kernel.  e: the dry
     run (``launch/dryrun.py``) of olmo-1b x train_4k on a 16x16 mesh of
     meta devices: its wall and per-device bytes.
The lines before the last are the ``{"kernels": [...]}`` record, one
entry a kernel wrapper, each counting its own launches (``ops.launches``):
``launches`` are those of the kernel's main path, the CNN staged search of
phase 8 for ``bitflip``, ``quant_bitflip`` and ``fault_matmul`` (float32
x), phase 9's olmo-1b staged search for ``fault_weight_tiles`` and
``matmul_tiles``, the two kernels ``fault_matmul`` runs on bf16 x, one
each a row group; ``full_launches`` phase 4's; ``lm_launches`` /
``lm_full_launches`` phase 9's staged and full olmo-1b searches;
``rg_launches`` / ``rg_full_launches`` phase 10's, ``mixtral_launches`` /
``mamba2_launches`` phase 10b's, ``seamless_launches`` /
``seamless_full_launches`` phase 11's (the main path of
``matmul_tiles_f32``, the product of ``fault_matmul``'s float32-x route
on bf16 weights, and of that route's entry ``fault_matmul_bf16w``, whose
launches are its calls' row groups: one hash pass, counted under
``fault_weight_tiles``, and one ``matmul_tiles_f32`` each),
``reconfig_launches`` phase 12's drained re-optimization,
``serve_launches`` phase 13's trace, ``train_probe_launches`` phase
14c's staged search, ``pool_launches`` phase 15b's staged search on four
slots (the CNN's for its kernels, olmo-1b's for the LM's),
``pp_launches`` phase 16a's pipelined steps (counted over its steps; the
phase fails unless every count is 0: the pipelined step takes no faults
and runs no port kernel), ``shard_decode_launches`` phase 16b's sharded
decode steps
(counted over those steps alone, not the unsharded ones beside them);
``fault_train_launches`` phase 17b's faulted training step's (a step's
mean over its steps); ``tp_decode_launches`` phase 18b's tensor-parallel
decode steps on both meshes; ``train_shapes`` phase 17a's rows for
``quant_bitflip`` (``ms`` with the q' store, ``nostore_ms`` without,
``backward_ms`` the plain PyTorch backward); ``lm_shapes`` the LM shapes of
phase 3 and ``decode_shapes`` phase 13's, its last row one decode layer
as one group.  Then come the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Bounds: the least time for the same work is the larger of the bytes each
input read once and each output written once over 3.35 TB/s, and the
operations over their peak.  The fault hash takes 15 32-bit integer
operations per draw as ``csrc/faultmodel.cuh``'s ``hash32`` computes it
(the plane's offset, lowbias32 twice with the xorshift pair between them
folded into one xor, four multiplies, the compare on the whole hash),
counted at 16.7 Tops/s (64 INT32 lanes per SM x 132 SMs x 1.98 GHz, from
the H100 white paper).
``quant_bitflip`` computes that form; ``bitflip`` and ``fault_matmul``'s
hash passes still compute the unfolded ``draw24`` (20 operations), which
the bound does not credit: the same draws take 15.
  * ``bitflip``, ``quant_bitflip``: one draw per element and bit plane;
    the hash outweighs the bytes (1 + 1 B, 1 + 2 B dequantized to bf16,
    or 4 + 4 + 4 B, an element).
  * ``fault_matmul``: the hash once per weight (K N draws per plane), and
    the product as it runs on the tensor cores: three exact bf16 products
    of the split x, 3 x 2 M K N at 989 TFLOP/s (float32 x), or one, 2 M K
    N (bf16 x).  Whichever is larger; at AlexNet's fc0 and olmo-1b's
    projections the hash.  (The SIMT body of int16/int32 weights with
    float32 x would be bound by fp32 FMAs at 67 TFLOP/s; the CNN path
    stores int8.)  float32 x on bf16 weights (``fault_matmul_bf16w``)
    takes the same bound as float32 x; it runs as the hash pass and
    three exact bf16 products of the split x.
  * ``fault_weight_tiles`` (bf16 x's hash pass): K N planes draws, or
    its bytes (qw read, W' written).
  * ``matmul_tiles`` (bf16 x's product): 2 M K N at 989 TFLOP/s, or its
    bytes (x and W' read, out written).
  * ``matmul_tiles_f32`` (the float32-x route's product): 3 x 2 M K N at
    989 TFLOP/s (the three parts of x), or its bytes (float32 x and W'
    read, float32 out written).
  * ``swiglu``, ``rope``: their bytes (h1 and h3 read, the gate written;
    x and the float32 tables read, x's rotation written).
Rates are the H100 SXM's published peaks at 700 W.
"""
from __future__ import annotations

import collections
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT32_OPS = 132 * 64 * 1.98e9
HASH_OPS_PER_DRAW = 15          # faultmodel.cuh hash32 (see the docstring)
FAULTY_BITS = 4                 # the CNN path's (SPEC_RATES)
# phase 9's fault regime at bits=8: 6 faulty bits at weight and activation
# rate 0.2.  The reference replay runs 4; with random weights 4 move no
# token of olmo-1b at full width (see lm_phase)
LM_FAULTY_BITS, LM_RATE = 6, 0.2
# phases 10 and 10b's faulty bits at the same rates (see family_phase)
RG_FAULTY_BITS = LM_FAULTY_BITS
SPEC_RATES = dict(weight_fault_rate=0.2, act_fault_rate=0.2, faulty_bits=4,
                  bits=16)
# the kernels (``ops.launches`` keys) of the CNN path, float32, and of the
# transformer path, bf16, whose fault_matmul runs the hash pass
# (fault_weight_tiles) and the product (matmul_tiles)
CNN_KERNELS = ("bitflip", "quant_bitflip", "fault_matmul")
LM_KERNELS = ("quant_bitflip", "fault_weight_tiles", "matmul_tiles")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, host cost
    included (CUDA events around the calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches=20, replays=10) -> float:
    """Mean device time of ``fn``: ``launches`` calls captured in one CUDA
    graph, replayed between events, so the wrapper's host work is not in
    it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def bound(n_bytes: float, tc_flops: float = 0.0, int_ops: float = 0.0):
    t = {"bytes": n_bytes / HBM_BPS,
         "operations": max(tc_flops / BF16_FLOPS, int_ops / INT32_OPS)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.float16: torch.int16}
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return bool(torch.equal(a, b))


def check_quant_group(label, xs, seeds, rates, fb, spec) -> float:
    """``quant_bitflip_group`` on ``xs`` (one launch pair) against its
    plain version, tensor by tensor, bitwise, for all four fault models;
    returns the largest |difference| (0 when bitwise)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS

    err = 0.0
    for model in FAULT_MODELS:
        got = ops.quant_bitflip_group(xs, seeds, rates, fb, spec,
                                      fault_model=model)
        want = ref.quant_bitflip_group_ref(xs, seeds, rates, fb, spec,
                                           fault_model=model)
        for i, (k, p) in enumerate(zip(got, want)):
            err = max(err, max_abs_err(k, p))
            if not bits_equal(k, p):
                bad = (k.float() != p.float()).sum().item()
                raise AssertionError(f"quant_bitflip group {label} {model}: "
                                     f"tensor {i} {list(k.shape)} has {bad} "
                                     "elements off the plain version")
        del got, want
    return err


# fault_matmul at the main path's two shapes: (label, M, K, N)
MATMUL_SHAPES = (("resnet18 fc", 512, 512, 16), ("alexnet fc0", 512, 4096, 1024))


def check_kernels(dev, records):
    """Phase 3: every kernel against its plain version, then timings."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.quant import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(0)
    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    spec8 = QuantSpec(bits=8)
    scale = torch.tensor(0.0123, device=dev)

    # bitflip: ResNet18's largest conv weight, 3x3x512x512, as stored (int8)
    # and in the wider storage types; integers out, and dequantized
    bf_err = qb_err = 0.0
    for dtype, hi in ((torch.int8, 127), (torch.int16, 2 ** 14),
                      (torch.int32, 2 ** 20)):
        q = torch.randint(-hi, hi, (3, 3, 512, 512), device=dev, dtype=dtype,
                          generator=gen)
        for model in FAULT_MODELS:
            for bits in (FAULTY_BITS, LM_FAULTY_BITS, 8):
                k = ops.bitflip(q, 7919, rates, bits, fault_model=model)
                p = ref.bitflip_ref(q, 7919, rates, bits, fault_model=model)
                bf_err = max(bf_err, max_abs_err(k, p))
                if not bits_equal(k, p):
                    raise AssertionError(f"bitflip {dtype} {model} bits={bits}"
                                         " differs from its plain version")
                k = ops.bitflip(q, 7919, rates, bits, fault_model=model,
                                scale=scale)
                bf_err = max(bf_err, max_abs_err(k, p.float() * scale))
                if not bits_equal(k, p.float() * scale):
                    raise AssertionError(f"bitflip {dtype} {model} bits={bits}"
                                         " with scale differs from "
                                         "bitflip_ref(...).float() * scale")
    log("phase3 bitflip: bitwise equal to plain for int8/int16/int32 x "
        f"{FAULT_MODELS} x bits {FAULTY_BITS},{LM_FAULTY_BITS},8 x rates "
        "0,1e-3,0.2 at [3,3,512,512], integers out and fused dequant")

    # quant_bitflip: the input of ResNet18 units 1-3 at n_eval=512,
    # [R, 512, 32, 32, 64]; row 0 all zeros
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 512, 32, 32, 64, device=dev, generator=gen)
        x = torch.relu(x).to(dtype)
        x[0] = 0
        r4 = torch.tensor([0.2, 0.0, 1e-3, 0.2], device=dev)
        for model in FAULT_MODELS:
            k = ops.quant_bitflip(x, 7920, r4, FAULTY_BITS, spec8,
                                  fault_model=model)
            p = ref.quant_bitflip_ref(x, 7920, r4, FAULTY_BITS, spec8,
                                      fault_model=model)
            qb_err = max(qb_err, max_abs_err(k, p))
            if not bits_equal(k, p):
                bad = (k.float() != p.float()).sum().item()
                raise AssertionError(f"quant_bitflip {dtype} {model}: {bad} "
                                     "elements differ from the plain version")
            if k[0].abs().max().item() >= torch.finfo(torch.float32).tiny:
                raise AssertionError("all-zero row did not stay (sub)zero")
        del x, k, p
    log("phase3 quant_bitflip: bitwise equal to plain for float32/bfloat16 x "
        f"{FAULT_MODELS} x rates 0,1e-3,0.2 at [4,512,32,32,64] with an "
        "all-zero row")

    # fault_matmul at both main-path shapes, every storage type
    max_err, worst = {}, 0.0
    for label, M, K, N in MATMUL_SHAPES:
        eye = torch.eye(K, device=dev).expand(3, K, K).contiguous()
        x = torch.randn(3, M, K, device=dev, generator=gen)
        max_err[label] = 0.0
        for dtype, hi in ((torch.int8, 128), (torch.int16, 2 ** 14),
                          (torch.int32, 2 ** 20)):
            qw = torch.randint(-hi, hi, (K, N), device=dev, dtype=dtype,
                               generator=gen)
            for model in FAULT_MODELS:
                w = ref.bitflip_ref(qw, 7921, rates, FAULTY_BITS,
                                    fault_model=model, scale=scale)
                k = ops.fault_matmul(eye, qw, scale, 7921, rates, FAULTY_BITS,
                                     fault_model=model)
                if not bits_equal(k, w):
                    raise AssertionError(f"fault_matmul {label} {dtype} "
                                         f"{model}: x = I_K does not return "
                                         "the corrupted weights bitwise")
                k = ops.fault_matmul(x, qw, scale, 7921, rates, FAULTY_BITS,
                                     fault_model=model)
                p = ref.fault_matmul_ref(x, qw, scale, 7921, rates,
                                         FAULTY_BITS, fault_model=model)
                tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
                err = (k - p).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"fault_matmul {label} {dtype} "
                                         f"{model}: max err "
                                         f"{err.max().item():.3g} above the "
                                         "bound")
                if dtype == torch.int8:
                    max_err[label] = max(max_err[label], err.max().item())
                worst = max(worst, (err / tol).max().item())
        del eye
    log("phase3 fault_matmul: x=I_K bitwise; random x within "
        f"2*K*2^-24*(|x|@|w|) (worst ratio to it {worst:.3g}), at "
        f"{[s[0] for s in MATMUL_SHAPES]} x int8/int16/int32 x "
        f"{FAULT_MODELS}; int8 max |err| {max_err}")

    # timings, one row, at the main path's shapes
    one = torch.tensor([0.2], device=dev)
    q = torch.randint(-127, 128, (3, 3, 512, 512), device=dev,
                      dtype=torch.int8, generator=gen)
    n = q.numel()
    b_ms, b_by = bound(2 * n, int_ops=n * FAULTY_BITS * HASH_OPS_PER_DRAW)
    records["bitflip"].update(
        ms=device_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS)),
        wrapper_ms=time_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS)),
        fused_ms=device_ms(lambda: ops.bitflip(q, 1, one, FAULTY_BITS,
                                               scale=scale)),
        plain_ms=time_ms(lambda: ref.bitflip_ref(q, 1, one, FAULTY_BITS)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=bf_err,
        shape="[1] x [3,3,512,512] int8")
    x = torch.relu(torch.randn(1, 512, 32, 32, 64, device=dev, generator=gen))
    n = x.numel()
    b_ms, b_by = bound(8 * n, int_ops=n * FAULTY_BITS * HASH_OPS_PER_DRAW)
    records["quant_bitflip"].update(
        ms=device_ms(lambda: ops.quant_bitflip(x, 1, one, FAULTY_BITS, spec8)),
        wrapper_ms=time_ms(lambda: ops.quant_bitflip(x, 1, one, FAULTY_BITS,
                                                     spec8)),
        plain_ms=time_ms(lambda: ref.quant_bitflip_ref(x, 1, one, FAULTY_BITS,
                                                       spec8), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=qb_err,
        shape="[1,512,32,32,64] float32")
    del x
    shapes = []
    for label, M, K, N in MATMUL_SHAPES:
        qw = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x = torch.randn(1, M, K, device=dev, generator=gen)
        w = qw.float() * scale
        b_ms, b_by = bound(4 * M * K + K * N + 4 * M * N,
                           tc_flops=3 * 2 * M * K * N,
                           int_ops=K * N * FAULTY_BITS * HASH_OPS_PER_DRAW)
        shapes.append(dict(
            label=label, shape=f"[1,{M},{K}] x [{K},{N}] int8",
            ms=device_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                  FAULTY_BITS)),
            wrapper_ms=time_ms(lambda: ops.fault_matmul(x, qw, scale, 1, one,
                                                        FAULTY_BITS)),
            plain_ms=time_ms(lambda: ref.fault_matmul_ref(
                x, qw, scale, 1, one, FAULTY_BITS)),
            library_ms=device_ms(lambda: torch.matmul(x, w)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err[label]))
    # the record's own numbers are those of ResNet18's fc, the shape the
    # main path (phase 4) launches; AlexNet's fc0 rides along in "shapes"
    records["fault_matmul"].update(shapes[0], shapes=shapes)
    for name in CNN_KERNELS:
        for sr in records[name].get("shapes", [records[name]]):
            log(f"phase3 time {name} at {sr['shape']}: device {sr['ms']:.4f} "
                f"ms, wrapper {sr['wrapper_ms']:.4f} ms, plain "
                f"{sr['plain_ms']:.4f} ms, library {sr['library_ms']}, bound "
                f"{sr['bound_ms']:.4f} ms ({sr['bound_by']})")
    log(f"phase3 time bitflip fused dequant: device "
        f"{records['bitflip']['fused_ms']:.4f} ms")


RECORD_KEYS = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
               "wrapper_ms", "fused_ms", "candidate_ms", "candidate_launches",
               "full_launches", "shapes", "lm_launches", "lm_full_launches",
               "lm_candidate_ms", "lm_candidate_launches", "lm_shapes",
               "lm_rows8", "starcoder2_launches", "rg_launches",
               "rg_full_launches", "rg_candidate_ms", "rg_candidate_launches",
               "mixtral_launches", "mamba2_launches", "seamless_launches",
               "seamless_full_launches", "seamless_candidate_ms",
               "seamless_candidate_launches", "reconfig_launches",
               "decode_shapes", "serve_launches", "train_probe_launches",
               "pool_launches", "pp_launches", "shard_decode_launches",
               "train_shapes", "fault_train_launches", "tp_decode_launches",
               "lm_unfused")


# fault_matmul on bf16 x at olmo-1b's projections, M = B S = 2048:
# (label, M, K, N)
LM_MATMUL_SHAPES = (("olmo-1b wq/wk/wv/wo", 2048, 2048, 2048),
                    ("olmo-1b w1/w3", 2048, 2048, 8192),
                    ("olmo-1b w2", 2048, 8192, 2048))
# the bf16 product where K is cut into slices: starcoder2-3b's kv
# projection (d_model 3072, 2 kv heads of 128), M = B S = 2048
SPLIT_K_SHAPE = ("starcoder2-3b wk/wv", 2048, 3072, 256)


def _bf16_matmul_shape(dev, gen, label, M, K, N, storages, out, hash_out,
                       prod_out) -> float:
    """Phase 3, bf16 x, one projection shape (``check_fault_matmul_bf16``
    says what is checked): the call, the hash pass and the product against
    their plain versions for each storage ``(dtype, hi)`` and fault model,
    then each one's times on one row, appended to ``out``, ``hash_out`` and
    ``prod_out``.  Returns the worst ratio of an error to its bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS

    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    one = torch.tensor([0.2], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    bf16, fb, worst = torch.bfloat16, LM_FAULTY_BITS, 0.0
    eye = torch.eye(K, device=dev, dtype=bf16).expand(3, K, K)
    eye = eye.contiguous()
    x = torch.randn(3, M, K, device=dev, generator=gen).to(bf16)
    for dtype, hi in storages:
        qw = torch.randint(-hi, hi, (K, N), device=dev, dtype=dtype,
                           generator=gen)
        err_max = hash_err = prod_err = 0.0
        for model in FAULT_MODELS:
            w = ref.bitflip_ref(qw, 7921, rates, fb,
                                fault_model=model,
                                scale=scale).to(bf16)
            k = ops.fault_matmul(eye, qw, scale, 7921, rates, fb,
                                 fault_model=model)
            if not bits_equal(k, w):
                raise AssertionError(
                    f"fault_matmul bf16 {label} {dtype} {model}: "
                    "x = I_K does not return bf16(q' scale) bitwise")
            k = ops.fault_matmul(x, qw, scale, 7921, rates, fb,
                                 fault_model=model)
            p = ref.fault_matmul_ref(x, qw, scale, 7921, rates, fb,
                                     fault_model=model)
            if k.dtype != bf16 or p.dtype != bf16:
                raise AssertionError("bf16 x must give bf16 out")
            k, p = k.float(), p.float()
            mag = torch.matmul(x.float().abs(), w.float().abs())
            tol = 2 * K * 2.0 ** -24 * mag \
                + 2.0 ** -8 * (k.abs() + p.abs()) * (1 + 2.0 ** -7)
            err = (k - p).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"fault_matmul bf16 {label} {dtype} {model}: max "
                    f"err {err.max().item():.3g} above the bound")
            err_max = max(err_max, err.max().item())
            worst = max(worst, (err / tol).max().item())
            # the hash pass alone: every row's W' is bf16(q' s)
            t = ops.fault_weight_tiles(qw, scale, 7921, rates, fb,
                                       fault_model=model)
            tw = ref.unpack_tiles(t, K, N)
            hash_err = max(hash_err, max_abs_err(tw, w))
            if not bits_equal(tw, w):
                raise AssertionError(
                    f"fault_matmul bf16 {label} {dtype} {model}: "
                    "the hash pass differs from bf16(q' scale)")
            # the product alone, within the same bound
            k = ops.matmul_tiles(x, t, K, N).float()
            p = ref.matmul_tiles_ref(x, t, K, N).float()
            tol = 2 * K * 2.0 ** -24 * mag \
                + 2.0 ** -8 * (k.abs() + p.abs()) * (1 + 2.0 ** -7)
            err = (k - p).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"matmul_tiles {label} {dtype} {model}: max err "
                    f"{err.max().item():.3g} above the bound")
            prod_err = max(prod_err, err.max().item())
            worst = max(worst, (err / tol).max().item())
            del k, p, mag, tol, err, w, t, tw
        x1 = x[:1].contiguous()
        w1 = (qw.float() * scale).to(bf16)
        qb = qw.element_size()
        n_tiles = ref.tile_elems(K, N)
        b_ms, b_by = bound(2 * M * K + qb * K * N + 2 * M * N,
                           tc_flops=2 * M * K * N,
                           int_ops=K * N * fb * HASH_OPS_PER_DRAW)
        h_ms, h_by = bound(qb * K * N + 2 * n_tiles,
                           int_ops=K * N * fb * HASH_OPS_PER_DRAW)
        p_ms, p_by = bound(2 * M * K + 2 * n_tiles + 2 * M * N,
                           tc_flops=2 * M * K * N)
        tiles = ops.fault_weight_tiles(qw, scale, 1, one, fb)
        shape = (f"[1,{M},{K}] bf16 x [{K},{N}] "
                 f"{str(dtype).removeprefix('torch.')}")
        lib_ms = device_ms(lambda: torch.matmul(x1, w1))
        out.append(dict(
            label=label, shape=shape,
            ms=device_ms(lambda: ops.fault_matmul(
                x1, qw, scale, 1, one, fb)),
            wrapper_ms=time_ms(lambda: ops.fault_matmul(
                x1, qw, scale, 1, one, fb), iters=10),
            plain_ms=time_ms(lambda: ref.fault_matmul_ref(
                x1, qw, scale, 1, one, fb), iters=3, warmup=1),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err_max))
        hash_out.append(dict(
            label=label, shape=f"[1] x [{K},{N}] "
                               f"{str(dtype).removeprefix('torch.')}",
            ms=device_ms(lambda: ops.fault_weight_tiles(
                qw, scale, 1, one, fb, out=tiles)),
            wrapper_ms=time_ms(lambda: ops.fault_weight_tiles(
                qw, scale, 1, one, fb, out=tiles), iters=10),
            plain_ms=time_ms(lambda: ref.fault_weight_tiles_ref(
                qw, scale, 1, one, fb), iters=3, warmup=1),
            library_ms=None, bound_ms=h_ms, bound_by=h_by,
            max_abs_err=hash_err))
        prod_out.append(dict(
            label=label, shape=shape,
            ms=device_ms(lambda: ops.matmul_tiles(x1, tiles, K, N)),
            wrapper_ms=time_ms(lambda: ops.matmul_tiles(
                x1, tiles, K, N), iters=10),
            plain_ms=time_ms(lambda: ref.matmul_tiles_ref(
                x1, tiles, K, N), iters=3, warmup=1),
            library_ms=lib_ms, bound_ms=p_ms, bound_by=p_by,
            max_abs_err=prod_err))
        del qw, w1, tiles
    del eye, x
    torch.cuda.empty_cache()

    return worst


def check_fault_matmul_bf16(dev, records):
    """Phase 3, bf16 x, at phase 9's ``LM_FAULTY_BITS``: ``fault_matmul``
    at olmo-1b's three projection shapes against its plain version (see
    the docstring), then its times at each shape and storage type beside
    ``torch.matmul`` and the bound; and ``quant_bitflip`` at the
    transformer's unit input, [R, 8, 256, 2048] bf16, bitwise against its
    plain version, alone and in one group with the other unit inputs,
    then timed on one row."""
    from repro_torch._device import fp32_exact
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.quant import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(1)
    rates = torch.tensor([0.0, 1e-3, 0.2], device=dev)
    one = torch.tensor([0.2], device=dev)
    scale = torch.tensor(0.0123, device=dev)
    bf16, fb = torch.bfloat16, LM_FAULTY_BITS
    worst, out, hash_out, prod_out = 0.0, [], [], []
    with torch.no_grad(), fp32_exact():
        for label, M, K, N in LM_MATMUL_SHAPES:
            worst = max(worst, _bf16_matmul_shape(
                dev, gen, label, M, K, N,
                ((torch.int8, 128), (torch.int32, 2 ** 15)), out, hash_out,
                prod_out))

        # rows across row groups: at 2048x8192 a group is 8 rows, so 9
        # rows span two; then R = 8 rows at 2048x2048 (one group, one hash)
        # timed against one row
        M, K, N = LM_MATMUL_SHAPES[1][1:]
        qw = torch.randint(-128, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        G = ops.row_groups(10 ** 6, K, N)[0][1]
        x = torch.randn(G + 1, M, K, device=dev, generator=gen).to(bf16)
        r9 = torch.linspace(0.0, 0.3, G + 1, device=dev)
        many = ops.fault_matmul(x, qw, scale, 7923, r9, fb)
        for r in range(G + 1):
            if not bits_equal(many[r:r + 1], ops.fault_matmul(
                    x[r:r + 1].contiguous(), qw, scale, 7923, r9[r:r + 1],
                    fb)):
                raise AssertionError(f"fault_matmul bf16 row {r} of {G + 1}"
                                     f" (groups of {G}) differs from its "
                                     "one-row call")
        log(f"phase3 fault_matmul bf16 {G + 1} rows at [{K},{N}] (groups of "
            f"{G} rows, {len(ops.row_groups(G + 1, K, N))} groups): every "
            "row bitwise its one-row call")
        del x, many, qw
        M, K, N = LM_MATMUL_SHAPES[0][1:]
        qw = torch.randint(-128, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        x8 = torch.randn(8, M, K, device=dev, generator=gen).to(bf16)
        r8 = torch.full((8,), LM_RATE, device=dev)
        b_ms, b_by = bound(8 * (2 * M * K + 2 * M * N) + K * N,
                           tc_flops=8 * 2 * M * K * N,
                           int_ops=K * N * fb * HASH_OPS_PER_DRAW)
        rows8 = dict(shape=f"[8,{M},{K}] bf16 x [{K},{N}] int8",
                     ms=device_ms(lambda: ops.fault_matmul(
                         x8, qw, scale, 1, r8, fb), launches=5),
                     one_row_ms=device_ms(lambda: ops.fault_matmul(
                         x8[:1], qw, scale, 1, r8[:1], fb)),
                     bound_ms=b_ms, bound_by=b_by)
        records["fault_matmul"]["lm_rows8"] = rows8
        log(f"phase3 time fault_matmul bf16 at {rows8['shape']}, 8 rows: "
            f"device {rows8['ms']:.4f} ms against {8 * rows8['one_row_ms']:.4f}"
            f" ms for 8 one-row calls, bound {b_ms:.4f} ms ({b_by})")
        # the product alone on those 8 rows (8 W'), against one row
        t8 = ops.fault_weight_tiles(qw, scale, 1, r8, fb)
        n_tiles = ref.tile_elems(K, N)
        b_ms, b_by = bound(8 * (2 * M * K + 2 * n_tiles + 2 * M * N),
                           tc_flops=8 * 2 * M * K * N)
        prod8 = dict(shape=f"[8,{M},{K}] bf16 x 8 W' [{K},{N}]",
                     ms=device_ms(lambda: ops.matmul_tiles(x8, t8, K, N),
                                  launches=5),
                     one_row_ms=device_ms(lambda: ops.matmul_tiles(
                         x8[:1], t8[:1], K, N)),
                     bound_ms=b_ms, bound_by=b_by)
        records["matmul_tiles"]["lm_rows8"] = prod8
        log(f"phase3 time matmul_tiles at {prod8['shape']}, 8 rows: device "
            f"{prod8['ms']:.4f} ms against {8 * prod8['one_row_ms']:.4f} ms "
            f"for 8 one-row calls, bound {b_ms:.4f} ms ({b_by})")
        del x8, t8, qw

        # the product alone at starcoder2-3b's kv projection, whose K is cut
        # into slices: within the bound of its plain version, each of 3 rows
        # bitwise its one-row call, timed beside torch.matmul
        label, M, K, N = SPLIT_K_SHAPE
        splits = ops._k_splits(M, K, N, "bf16", dev)
        qw = torch.randint(-128, 128, (K, N), device=dev, dtype=torch.int8,
                           generator=gen)
        t3 = ops.fault_weight_tiles(qw, scale, 7924, rates, fb)
        x3 = torch.randn(3, M, K, device=dev, generator=gen).to(bf16)
        k = ops.matmul_tiles(x3, t3, K, N)
        for r in range(3):
            if not bits_equal(k[r:r + 1], ops.matmul_tiles(
                    x3[r:r + 1].contiguous(), t3[r:r + 1], K, N)):
                raise AssertionError(f"matmul_tiles {label} row {r} differs "
                                     "from its one-row call")
        k, p = k.float(), ref.matmul_tiles_ref(x3, t3, K, N).float()
        w = ref.unpack_tiles(t3, K, N)
        mag = torch.matmul(x3.float().abs(), w.float().abs())
        tol = 2 * K * 2.0 ** -24 * mag \
            + 2.0 ** -8 * (k.abs() + p.abs()) * (1 + 2.0 ** -7)
        err = (k - p).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"matmul_tiles {label}: max err "
                                 f"{err.max().item():.3g} above the bound")
        worst = max(worst, (err / tol).max().item())
        x1, t1, w1 = x3[:1].contiguous(), t3[:1], w[:1].contiguous()
        n_tiles = ref.tile_elems(K, N)
        p_ms, p_by = bound(2 * M * K + 2 * n_tiles + 2 * M * N,
                           tc_flops=2 * M * K * N)
        prod_out.append(dict(
            label=f"{label}, K in {splits} slices",
            shape=f"[1,{M},{K}] bf16 x [{K},{N}] int8",
            ms=device_ms(lambda: ops.matmul_tiles(x1, t1, K, N)),
            wrapper_ms=time_ms(lambda: ops.matmul_tiles(x1, t1, K, N),
                               iters=10),
            plain_ms=time_ms(lambda: ref.matmul_tiles_ref(x1, t1, K, N),
                             iters=3, warmup=1),
            library_ms=device_ms(lambda: torch.matmul(x1, w1)),
            bound_ms=p_ms, bound_by=p_by, max_abs_err=err.max().item()))
        log(f"phase3 matmul_tiles {label} ({splits} K slices): 3 rows each "
            "bitwise its one-row call, within the bound")
        del x3, t3, k, p, w, mag, tol, err, qw

        # quant_bitflip at the unit input: signed activations, one row a
        # rate of phase 9's tiers (0.2 x fault scale) and one clean row
        spec8 = QuantSpec(bits=8)
        x = torch.randn(4, 8, 256, 2048, device=dev, generator=gen).to(bf16)
        r4 = torch.tensor([0.2, 0.0, 4e-3, 0.1], device=dev)
        qb_err = 0.0
        for model in FAULT_MODELS:
            k = ops.quant_bitflip(x, 7922, r4, fb, spec8, fault_model=model)
            p = ref.quant_bitflip_ref(x, 7922, r4, fb, spec8,
                                      fault_model=model)
            qb_err = max(qb_err, max_abs_err(k, p))
            if not bits_equal(k, p):
                bad = (k.float() != p.float()).sum().item()
                raise AssertionError(f"quant_bitflip bf16 [4,8,256,2048] "
                                     f"{model}: {bad} elements differ from "
                                     "the plain version")
        del k, p
        log(f"phase3 quant_bitflip bf16: bitwise equal to plain for "
            f"{FAULT_MODELS} at {fb} faulty bits, [4,8,256,2048] signed x, "
            "rates 0.2,0,4e-3,0.1")
        # the unit inputs as one group: the CNN's float32 [4,512,32,32,64]
        # (an all-zero row), this bf16 one, seamless's float32 encoder
        # input at a 0-d rate, a bf16 leaf expanded over 3 rows (stride 0)
        # and a bf16 view whose rows start off a 16-byte boundary
        cnn = torch.relu(torch.randn(4, 512, 32, 32, 64, device=dev,
                                     generator=gen))
        cnn[0] = 0
        leaf = torch.randn(2048, 2048, device=dev, generator=gen).to(bf16)
        odd = torch.randn(1 + 3 * 4000, device=dev, generator=gen).to(bf16)
        xs = [cnn, x, torch.randn(1, 8, 32, 1024, device=dev, generator=gen),
              leaf.expand(3, 2048, 2048), odd[1:].view(3, 4000)]
        r3 = torch.tensor([0.2, 0.0, 0.05], device=dev)
        qb_err = max(qb_err, check_quant_group(
            "unit inputs", xs, [7923, 7924, 7925, 7926, 7927],
            [torch.tensor([0.2, 0.0, 1e-3, 0.2], device=dev), r4, one[0],
             r3, r3], fb, spec8))
        del cnn, leaf, odd, xs
        log(f"phase3 quant_bitflip group: bitwise equal to plain for "
            f"{FAULT_MODELS} at {fb} faulty bits, one launch pair over "
            "[4,512,32,32,64] float32 (a zero row), [4,8,256,2048] bf16, "
            "[1,8,32,1024] float32 at a 0-d rate, [2048,2048] bf16 "
            "expanded over 3 rows (stride 0), [3,4000] bf16 unaligned")
        x = x[:1].contiguous()
        n = x.numel()
        b_ms, b_by = bound(2 * n + 2 * n,
                           int_ops=n * fb * HASH_OPS_PER_DRAW)
        records["quant_bitflip"]["lm_shapes"] = [dict(
            label="olmo-1b unit input", shape="[1,8,256,2048] bfloat16",
            ms=device_ms(lambda: ops.quant_bitflip(x, 1, one, fb, spec8)),
            wrapper_ms=time_ms(lambda: ops.quant_bitflip(x, 1, one, fb,
                                                         spec8)),
            plain_ms=time_ms(lambda: ref.quant_bitflip_ref(
                x, 1, one, fb, spec8), iters=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=qb_err)]
    records["fault_matmul"]["lm_shapes"] = out
    # the two kernels of the bf16 route: their own numbers are those of
    # the first shape (2048x2048, int8), the others ride along
    records["fault_weight_tiles"].update(hash_out[0], lm_shapes=hash_out)
    records["matmul_tiles"].update(prod_out[0], lm_shapes=prod_out)
    log(f"phase3 fault_matmul bf16 x at {fb} faulty bits: x=I_K bitwise, "
        f"the hash pass bitwise; random x, the call and the product alone, "
        f"within 2K2^-24(|x|@|w|) + 2^-8(|k|+|p|)(1+2^-7) (worst "
        f"ratio to it {worst:.3g}), at {[s[0] for s in LM_MATMUL_SHAPES]} x "
        f"int8/int32 x {FAULT_MODELS}")
    for name, rs in (("fault_matmul", out), ("fault_weight_tiles", hash_out),
                     ("matmul_tiles", prod_out),
                     ("quant_bitflip", records["quant_bitflip"]["lm_shapes"])):
        for r in rs:
            log(f"phase3 time {name} {r['label']} at {r['shape']}: device "
                f"{r['ms']:.4f} ms, wrapper {r['wrapper_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
                f"{r['max_abs_err']:.3g}")


# recurrentgemma-2b's projections at M = B S = 2048 (phase 10): (label, M,
# K, N); its kv projection (one kv head of 256) cuts K into slices
RG_MATMUL_SHAPES = (("recurrentgemma-2b wq/wo", 2048, 2560, 2560),
                    ("recurrentgemma-2b wk/wv", 2048, 2560, 256),
                    ("recurrentgemma-2b w1/w3", 2048, 2560, 7680),
                    ("recurrentgemma-2b w2", 2048, 7680, 2560))
# bitflip at the LM leaves it corrupts in phases 10 and 10b: (label, shape)
LM_BITFLIP_SHAPES = (("mixtral-8x7b expert w1/w3", (8, 4096, 14336)),
                     ("recurrentgemma-2b rec in_x/in_g/wa/wx/out",
                      (2560, 2560)))


def check_lm_family_kernels(dev, records):
    """Phase 3 at the shapes of phases 10 and 10b (see the docstring):
    ``bitflip`` bitwise against its plain version at mixtral-8x7b's expert
    tensor (one row) and recurrentgemma-2b's recurrent weight (three rows,
    all fault models), integers out and dequantized to float32 and bf16;
    bf16 ``fault_matmul`` at recurrentgemma-2b's four projection shapes;
    ``quant_bitflip`` bitwise at its unit input; each one timed."""
    from repro_torch._device import fp32_exact
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.quant import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(2)
    fb, bf16, f32 = LM_FAULTY_BITS, torch.bfloat16, torch.float32
    scale = torch.tensor(0.0123, device=dev)
    rows = []
    with torch.no_grad(), fp32_exact():
        for label, shape in LM_BITFLIP_SHAPES:
            big = len(shape) == 3
            rates = torch.tensor([LM_RATE] if big else [0.0, 1e-3, LM_RATE],
                                 device=dev)
            q = torch.randint(-127, 128, shape, dtype=torch.int8,
                              device=dev, generator=gen)
            err = 0.0
            for model in ("flip",) if big else FAULT_MODELS:
                p = ref.bitflip_ref(q, 7925, rates, fb, fault_model=model)
                if not bits_equal(ops.bitflip(q, 7925, rates, fb,
                                              fault_model=model), p):
                    raise AssertionError(f"bitflip {label} {model} differs "
                                         "from its plain version")
                for dt in (f32, bf16):
                    k = ops.bitflip(q, 7925, rates, fb, fault_model=model,
                                    scale=scale, dtype=dt)
                    want = (p.float() * scale).to(dt)
                    err = max(err, max_abs_err(k, want))
                    if not bits_equal(k, want):
                        raise AssertionError(
                            f"bitflip {label} {model} dequantized to {dt} "
                            "differs from (q'.float() * scale).to(dtype)")
                    del k, want
                del p
            one = rates[-1:]
            n = q.numel()
            b_ms, b_by = bound(n + 2 * n, int_ops=n * fb * HASH_OPS_PER_DRAW)
            rows.append(dict(
                label=label,
                shape=f"[1] x [{','.join(map(str, shape))}] int8, bf16 out",
                ms=device_ms(lambda: ops.bitflip(q, 1, one, fb, scale=scale,
                                                 dtype=bf16)),
                f32_out_ms=device_ms(lambda: ops.bitflip(q, 1, one, fb,
                                                         scale=scale)),
                wrapper_ms=time_ms(lambda: ops.bitflip(
                    q, 1, one, fb, scale=scale, dtype=bf16), iters=10),
                plain_ms=time_ms(lambda: ref.bitflip_ref(
                    q, 1, one, fb, scale=scale, dtype=bf16), iters=2,
                    warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err))
            log(f"phase3 bitflip {label} at {list(shape)} int8: bitwise "
                f"equal to plain, integers out and dequantized to float32 "
                f"and bf16, {fb} faulty bits, rates {rates.tolist()}"
                + ("" if big else f", {FAULT_MODELS}"))
            del q
            torch.cuda.empty_cache()
        records["bitflip"]["lm_shapes"] = rows

        out, hash_out, prod_out = [], [], []
        worst = 0.0
        for label, M, K, N in RG_MATMUL_SHAPES:
            worst = max(worst, _bf16_matmul_shape(
                dev, gen, label, M, K, N, ((torch.int8, 128),), out,
                hash_out, prod_out))
        records["fault_matmul"]["lm_shapes"] += out
        records["fault_weight_tiles"]["lm_shapes"] += hash_out
        records["matmul_tiles"]["lm_shapes"] += prod_out
        log(f"phase3 fault_matmul bf16 x at recurrentgemma-2b's shapes "
            f"{[s[1:] for s in RG_MATMUL_SHAPES]} (the kv projection in "
            f"{ops._k_splits(2048, 2560, 256, 'bf16', dev)} K slices): x=I_K "
            f"and the hash pass bitwise, the call and the product within "
            f"the bound (worst ratio to it {worst:.3g}), int8 x "
            f"{FAULT_MODELS}")

        spec8 = QuantSpec(bits=8)
        x = torch.randn(1, 8, 256, 2560, device=dev, generator=gen).to(bf16)
        one = torch.tensor([LM_RATE], device=dev)
        qb_err = 0.0
        for model in FAULT_MODELS:
            k = ops.quant_bitflip(x, 7926, one, fb, spec8, fault_model=model)
            p = ref.quant_bitflip_ref(x, 7926, one, fb, spec8,
                                      fault_model=model)
            qb_err = max(qb_err, max_abs_err(k, p))
            if not bits_equal(k, p):
                raise AssertionError(f"quant_bitflip bf16 [1,8,256,2560] "
                                     f"{model} differs from its plain "
                                     "version")
        n = x.numel()
        b_ms, b_by = bound(2 * n + 2 * n, int_ops=n * fb * HASH_OPS_PER_DRAW)
        records["quant_bitflip"]["lm_shapes"].append(dict(
            label="recurrentgemma-2b / mamba2-2.7b unit input",
            shape="[1,8,256,2560] bfloat16",
            ms=device_ms(lambda: ops.quant_bitflip(x, 1, one, fb, spec8)),
            wrapper_ms=time_ms(lambda: ops.quant_bitflip(x, 1, one, fb,
                                                         spec8)),
            plain_ms=time_ms(lambda: ref.quant_bitflip_ref(
                x, 1, one, fb, spec8), iters=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=qb_err))
        log(f"phase3 quant_bitflip bf16 [1,8,256,2560]: bitwise equal to "
            f"plain for {FAULT_MODELS} at {fb} faulty bits, rate {LM_RATE}")
    for name, rs in (("bitflip", rows), ("fault_matmul", out),
                     ("fault_weight_tiles", hash_out),
                     ("matmul_tiles", prod_out),
                     ("quant_bitflip",
                      records["quant_bitflip"]["lm_shapes"][-1:])):
        for r in rs:
            log(f"phase3 time {name} {r['label']} at {r['shape']}: device "
                f"{r['ms']:.4f} ms"
                + (f" (float32 out {r['f32_out_ms']:.4f} ms)"
                   if "f32_out_ms" in r else "")
                + f", wrapper {r['wrapper_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
                f"{r['max_abs_err']:.3g}")


# seamless-m4t-medium's products (phase 11): float32 x on bf16 weights in
# the encoder's projections and the decoder's cross-attention K/V, M = B Se
# = 8 x 32; bf16 x in the decoder, M = B S = 2048: (label, M, K, N)
ENC_MATMUL_SHAPES = (("seamless-m4t-medium enc wq/wk/wv/wo, cross wk/wv",
                      256, 1024, 1024),
                     ("seamless-m4t-medium enc w1", 256, 1024, 4096),
                     ("seamless-m4t-medium enc w2", 256, 4096, 1024))
DEC_MATMUL_SHAPES = (("seamless-m4t-medium dec wq/wk/wv/wo, cross wq/wo",
                      2048, 1024, 1024),
                     ("seamless-m4t-medium dec w1", 2048, 1024, 4096),
                     ("seamless-m4t-medium dec w2", 2048, 4096, 1024))


def check_encdec_kernels(dev, records):
    """Phase 3 at the shapes of phase 11 (see the docstring), at
    ``LM_FAULTY_BITS``: ``fault_matmul`` on float32 x with bf16 weights at
    the encoder's three shapes, bitwise float(bf16(q' scale)) at x = I_K
    and at random x, with its product alone (``matmul_tiles_f32``), within
    2 K 2^-24 (|x| @ |w|) of its plain version, each row bitwise its
    one-row call, int8, all four fault models; bf16 x at the decoder's
    three shapes as
    at olmo-1b's; ``quant_bitflip`` bitwise at the encoder's float32 and
    the decoder's bf16 unit inputs; ``bitflip`` bitwise on a [1024]
    LayerNorm leaf dequantized to bf16; each one timed."""
    from repro_torch._device import fp32_exact
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.quant import QuantSpec

    gen = torch.Generator(device=dev).manual_seed(3)
    fb, bf16, f32 = LM_FAULTY_BITS, torch.bfloat16, torch.float32
    rates = torch.tensor([0.0, 1e-3, LM_RATE], device=dev)
    one = rates[-1:]
    scale = torch.tensor(0.0123, device=dev)
    enc_out, enc_prod, worst = [], [], 0.0
    with torch.no_grad(), fp32_exact():
        for label, M, K, N in ENC_MATMUL_SHAPES:
            qw = torch.randint(-128, 128, (K, N), device=dev,
                               dtype=torch.int8, generator=gen)
            eye = torch.eye(K, device=dev).expand(3, K, K).contiguous()
            x = torch.randn(3, M, K, device=dev, generator=gen)
            err_max = prod_err = 0.0
            for model in FAULT_MODELS:
                w = ref.bitflip_ref(qw, 7927, rates, fb, fault_model=model,
                                    scale=scale).to(bf16).float()
                k = ops.fault_matmul(eye, qw, scale, 7927, rates, fb,
                                     fault_model=model, out_dtype=bf16)
                if not bits_equal(k, w):
                    raise AssertionError(
                        f"fault_matmul float32 x bf16 w {label} {model}: "
                        "x = I_K does not return float(bf16(q' scale))")
                k = ops.fault_matmul(x, qw, scale, 7927, rates, fb,
                                     fault_model=model, out_dtype=bf16)
                p = ref.fault_matmul_ref(x, qw, scale, 7927, rates, fb,
                                         fault_model=model, out_dtype=bf16)
                tol = 2 * K * 2.0 ** -24 * torch.matmul(x.abs(), w.abs())
                err = (k - p).abs()
                if k.dtype != f32 or not bool((err <= tol).all()):
                    raise AssertionError(
                        f"fault_matmul float32 x bf16 w {label} {model}: "
                        f"max err {err.max().item():.3g} above the bound")
                err_max = max(err_max, err.max().item())
                worst = max(worst, (err / tol).max().item())
                for r in range(3):
                    if not bits_equal(k[r:r + 1], ops.fault_matmul(
                            x[r:r + 1].contiguous(), qw, scale, 7927,
                            rates[r:r + 1], fb, fault_model=model,
                            out_dtype=bf16)):
                        raise AssertionError(
                            f"fault_matmul float32 x bf16 w {label} {model}"
                            f": row {r} differs from its one-row call")
                # the product alone, on the hash pass's W'
                t = ops.fault_weight_tiles(qw, scale, 7927, rates, fb,
                                           fault_model=model)
                k = ops.matmul_tiles_f32(x, t, K, N)
                p = ref.matmul_tiles_f32_ref(x, t, K, N)
                err = (k - p).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(
                        f"matmul_tiles_f32 {label} {model}: max err "
                        f"{err.max().item():.3g} above the bound")
                prod_err = max(prod_err, err.max().item())
                worst = max(worst, (err / tol).max().item())
                del k, p, tol, err, w, t
            del eye
            x1 = x[:1].contiguous()
            w1 = (qw.float() * scale).to(bf16).float()
            n_tiles = ref.tile_elems(K, N)
            b_ms, b_by = bound(4 * M * K + K * N + 4 * M * N,
                               tc_flops=3 * 2 * M * K * N,
                               int_ops=K * N * fb * HASH_OPS_PER_DRAW)
            p_ms, p_by = bound(4 * M * K + 2 * n_tiles + 4 * M * N,
                               tc_flops=3 * 2 * M * K * N)
            lib_ms = device_ms(lambda: torch.matmul(x1, w1))
            splits = ops._k_splits(M, K, N, "f32w", dev)
            shape = f"[1,{M},{K}] float32 x [{K},{N}] int8, bf16 weights"
            enc_out.append(dict(
                label=label, shape=shape,
                ms=device_ms(lambda: ops.fault_matmul(
                    x1, qw, scale, 1, one, fb, out_dtype=bf16)),
                wrapper_ms=time_ms(lambda: ops.fault_matmul(
                    x1, qw, scale, 1, one, fb, out_dtype=bf16), iters=10),
                plain_ms=time_ms(lambda: ref.fault_matmul_ref(
                    x1, qw, scale, 1, one, fb, out_dtype=bf16), iters=3,
                    warmup=1),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err_max, splits=splits))
            tiles = ops.fault_weight_tiles(qw, scale, 1, one, fb)
            enc_prod.append(dict(
                label=label, shape=shape,
                ms=device_ms(lambda: ops.matmul_tiles_f32(x1, tiles, K, N)),
                wrapper_ms=time_ms(lambda: ops.matmul_tiles_f32(
                    x1, tiles, K, N), iters=10),
                plain_ms=time_ms(lambda: ref.matmul_tiles_f32_ref(
                    x1, tiles, K, N), iters=3, warmup=1),
                library_ms=lib_ms, bound_ms=p_ms, bound_by=p_by,
                max_abs_err=prod_err, splits=splits))
            del qw, x, x1, w1, tiles
        log(f"phase3 fault_matmul float32 x bf16 weights at "
            f"{[s[1:] for s in ENC_MATMUL_SHAPES]}: x=I_K bitwise "
            f"float(bf16(q' scale)); random x, the call and its product "
            f"alone, within 2K2^-24(|x|@|w|) (worst ratio to it "
            f"{worst:.3g}); 3 rows each bitwise its one-row call; int8 x "
            f"{FAULT_MODELS} at {fb} faulty bits, rates 0,1e-3,0.2")
        records["fault_matmul_bf16w"].update(enc_out[0], shapes=enc_out)
        records["matmul_tiles_f32"].update(enc_prod[0], shapes=enc_prod)

        out, hash_out, prod_out = [], [], []
        worst = 0.0
        for label, M, K, N in DEC_MATMUL_SHAPES:
            worst = max(worst, _bf16_matmul_shape(
                dev, gen, label, M, K, N, ((torch.int8, 128),), out,
                hash_out, prod_out))
        records["fault_matmul"]["lm_shapes"] += out
        records["fault_weight_tiles"]["lm_shapes"] += hash_out
        records["matmul_tiles"]["lm_shapes"] += prod_out
        log(f"phase3 fault_matmul bf16 x at seamless-m4t-medium's decoder "
            f"shapes {[s[1:] for s in DEC_MATMUL_SHAPES]}: x=I_K and the "
            f"hash pass bitwise, the call and the product within the bound "
            f"(worst ratio to it {worst:.3g}), int8 x {FAULT_MODELS}")

        spec8, qb_rows = QuantSpec(bits=8), []
        for label, shape, dt in (
                ("seamless-m4t-medium encoder unit input", (1, 8, 32, 1024),
                 f32),
                ("seamless-m4t-medium decoder unit input", (1, 8, 256, 1024),
                 bf16)):
            x = torch.randn(shape, device=dev, generator=gen).to(dt)
            qb_err = 0.0
            for model in FAULT_MODELS:
                k = ops.quant_bitflip(x, 7928, one, fb, spec8,
                                      fault_model=model)
                p = ref.quant_bitflip_ref(x, 7928, one, fb, spec8,
                                          fault_model=model)
                qb_err = max(qb_err, max_abs_err(k, p))
                if not bits_equal(k, p):
                    raise AssertionError(f"quant_bitflip {label} {model} "
                                         "differs from its plain version")
            n, eb = x.numel(), x.element_size()
            b_ms, b_by = bound(2 * eb * n, int_ops=n * fb * HASH_OPS_PER_DRAW)
            qb_rows.append(dict(
                label=label, shape=f"{list(shape)} {str(dt)[6:]}",
                ms=device_ms(lambda: ops.quant_bitflip(x, 1, one, fb, spec8)),
                wrapper_ms=time_ms(lambda: ops.quant_bitflip(
                    x, 1, one, fb, spec8)),
                plain_ms=time_ms(lambda: ref.quant_bitflip_ref(
                    x, 1, one, fb, spec8), iters=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=qb_err))
        records["quant_bitflip"]["lm_shapes"] += qb_rows
        log(f"phase3 quant_bitflip at [1,8,32,1024] float32 and "
            f"[1,8,256,1024] bf16: bitwise equal to plain for {FAULT_MODELS} "
            f"at {fb} faulty bits, rate {LM_RATE}")

        q = torch.randint(-127, 128, (1024,), dtype=torch.int8, device=dev,
                          generator=gen)
        bf_err = 0.0
        for model in FAULT_MODELS:
            p = ref.bitflip_ref(q, 7929, rates, fb, fault_model=model)
            k = ops.bitflip(q, 7929, rates, fb, fault_model=model,
                            scale=scale, dtype=bf16)
            want = (p.float() * scale).to(bf16)
            bf_err = max(bf_err, max_abs_err(k, want))
            if not bits_equal(k, want) or not bits_equal(
                    ops.bitflip(q, 7929, rates, fb, fault_model=model), p):
                raise AssertionError(f"bitflip [1024] {model} differs from "
                                     "its plain version")
        n = q.numel()
        b_ms, b_by = bound(n + 2 * n, int_ops=n * fb * HASH_OPS_PER_DRAW)
        bf_row = dict(
            label="seamless-m4t-medium LayerNorm gain/bias",
            shape="[1] x [1024] int8, bf16 out",
            ms=device_ms(lambda: ops.bitflip(q, 1, one, fb, scale=scale,
                                             dtype=bf16)),
            wrapper_ms=time_ms(lambda: ops.bitflip(q, 1, one, fb, scale=scale,
                                                   dtype=bf16)),
            plain_ms=time_ms(lambda: ref.bitflip_ref(q, 1, one, fb,
                                                     scale=scale, dtype=bf16)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=bf_err)
        records["bitflip"]["lm_shapes"].append(bf_row)
        log(f"phase3 bitflip [1024] int8: bitwise equal to plain, integers "
            f"out and dequantized to bf16, {FAULT_MODELS}, {fb} faulty bits")
    torch.cuda.empty_cache()
    for name, rs in (("fault_matmul_bf16w", enc_out),
                     ("matmul_tiles_f32", enc_prod), ("fault_matmul", out),
                     ("fault_weight_tiles", hash_out),
                     ("matmul_tiles", prod_out), ("quant_bitflip", qb_rows),
                     ("bitflip", [bf_row])):
        for r in rs:
            log(f"phase3 time {name} {r['label']} at {r['shape']}: device "
                f"{r['ms']:.4f} ms, wrapper {r['wrapper_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
                f"{r['max_abs_err']:.3g}"
                + (f", {r['splits']} K slices" if "splits" in r else ""))


# the glue kernels at one olmo-1b unit run of a row (B S = 2048 tokens):
# the gate at d_ff 8192, RoPE on q (or k), 16 heads of 128
GLUE_SHAPES = {"swiglu": (1, 8, 256, 8192), "rope": (1, 8, 256, 16, 128)}
ROPE_THETA = 10000.0


def check_glue_kernels(dev, records):
    """Phase 3's glue kernels: ``swiglu`` and ``rope`` bitwise their
    op-by-op chains (``ref.swiglu_ref``, ``ref.rope_ref``), the gate over
    every bf16 h1, then each timed in bf16 at ``GLUE_SHAPES``: its device
    time, its wrapper's, the chain's device time (``plain_ms``; RoPE's
    building its tables, as every call did) and the bound.  RoPE also at
    decode's ``[B, 1]`` positions, a table row a sequence."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(3)
    h1 = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    h1 = h1.to(torch.int16).view(torch.bfloat16)
    h3 = (3 * torch.randn(16, 1, device=dev, generator=gen)).to(
        torch.bfloat16).expand(16, h1.numel()).contiguous()
    h1 = h1.expand_as(h3).contiguous()
    if not bits_equal(ops.swiglu(h1, h3), ref.swiglu_ref(h1, h3)):
        raise AssertionError("swiglu differs from its chain over the bf16 h1")
    S, H, dh = GLUE_SHAPES["rope"][-3:]
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    tables = L.rope_tables(pos, dh // 2, ROPE_THETA)
    # decode's: a token a sequence, each at its own position
    dpos = torch.randint(0, 4096, (8, 1), dtype=torch.int32, device=dev,
                         generator=gen)
    dtables = L.rope_tables(dpos, dh // 2, ROPE_THETA)
    args = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        a, b = [(3 * torch.randn(GLUE_SHAPES["swiglu"], device=dev,
                                 generator=gen)).to(dtype) for _ in range(2)]
        x = torch.randn(GLUE_SHAPES["rope"], device=dev, generator=gen).to(
            dtype)
        xd = torch.randn(8, 1, H, dh, device=dev, generator=gen).to(dtype)
        if not bits_equal(ops.swiglu(a, b), ref.swiglu_ref(a, b)):
            raise AssertionError(f"swiglu {dtype} differs from its chain")
        if not bits_equal(ops.rope(x, *tables), ref.rope_ref(x, *tables)):
            raise AssertionError(f"rope {dtype} differs from its chain")
        if not bits_equal(ops.rope(xd, *dtables),
                          ref.rope_ref(xd, *dtables)):
            raise AssertionError(f"decode's rope {dtype} differs from its "
                                 "chain")
        args[dtype] = (a, b, x)
    log("phase3 glue: swiglu bitwise its chain over every bf16 h1 x 16 h3 "
        "and at [1,8,256,8192], rope at [1,8,256,16,128] and decode's "
        "[8,1,16,128] at 8 positions, in bfloat16/float16/float32")
    a, b, x = args[torch.bfloat16]
    del args
    # x (8.4 MB) would stay in the 50 MB L2 over a graph's launches: each
    # launch takes the next of 8 copies (67 MB), so its reads are cold, as
    # the gate's 100 MB are
    xs, turn = [x.clone() for _ in range(8)], itertools.count()
    n = a.numel()
    b_ms, b_by = bound(3 * 2 * n)
    records["swiglu"].update(
        ms=device_ms(lambda: ops.swiglu(a, b)),
        wrapper_ms=time_ms(lambda: ops.swiglu(a, b)),
        plain_ms=device_ms(lambda: ref.swiglu_ref(a, b)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        shape="[1,8,256,8192] bf16 h1, h3")
    b_ms, b_by = bound(2 * 2 * x.numel() + 2 * 4 * S * dh // 2)
    records["rope"].update(
        ms=device_ms(lambda: ops.rope(xs[next(turn) % 8], *tables)),
        wrapper_ms=time_ms(lambda: ops.rope(xs[next(turn) % 8], *tables)),
        plain_ms=device_ms(lambda: ref.rope_ref(
            xs[next(turn) % 8], *L.rope_tables(pos, dh // 2, ROPE_THETA))),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0,
        shape="[1,8,256,16,128] bf16 x, [256,64] float32 tables")
    for name in ("swiglu", "rope"):
        r = records[name]
        log(f"phase3 time {name} at {r['shape']}: device {r['ms']:.4f} ms, "
            f"wrapper {r['wrapper_ms']:.4f} ms, op-by-op chain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.0f}% of it)")


def launch_counts() -> dict:
    """``ops.launches`` with the float32-x, bf16-weight route's entry
    ``fault_matmul_bf16w`` added: its row groups, each one hash pass
    (counted under ``fault_weight_tiles``) and one ``matmul_tiles_f32``
    launch."""
    from repro_torch.kernels import ops
    counts = dict(ops.launches)
    counts["fault_matmul_bf16w"] = counts["matmul_tiles_f32"]
    return counts


def glue_problems(cfg, launched: dict, unfused: dict, train: bool) -> list:
    """What is wrong with a phase's glue counters (``launches`` and
    ``ops.unfused`` of ``swiglu`` and ``rope``) on the card: a forward that
    autograd differentiates (``train``) runs the op-by-op chains, counted
    in ``unfused``, and launches neither kernel; any other launches both
    (the gate where ``cfg`` gates by SwiGLU) and runs no chain."""
    names = ("rope", "swiglu") if cfg.act_fn == "silu_glu" else ("rope",)
    ran, idle = (unfused, launched) if train else (launched, unfused)
    if all(ran[k] > 0 for k in names) and not any(
            idle[k] for k in ("swiglu", "rope")):
        return []
    return [f"glue kernels launched {launched['swiglu']} swiglu, "
            f"{launched['rope']} rope; op-by-op chains {unfused}"]


# the SIMT body of fault_matmul (float32 x on int16/int32 storage with a
# float32 weight dtype), a group of its own so a profile shows whether it
# ran
SIMT_GROUP = "fault_matmul SIMT"


def kernel_group(key: str, other: str = "convolution") -> str:
    """The group a profiled device kernel belongs to: one of the port's
    kernels (the float32 split-K sums count under ``fault_matmul``), or
    what PyTorch and the libraries run around them (``other``: cuDNN's
    convolutions on the CNN path, cuBLAS's products on the transformer
    path)."""
    if "quant_bitflip_kernel" in key or "amax_kernel" in key:
        return "quant_bitflip"
    if "bitflip_kernel" in key:
        return "bitflip"
    if "bfp::hash_kernel" in key:
        return "fault_weight_tiles"
    if "bfp::product_kernel" in key or "sum_splits_kernel<__nv_bfloat16>" \
            in key:
        return "matmul_tiles"
    if "fwp::product_kernel" in key:
        return "matmul_tiles_f32"
    if "glue::swiglu_kernel" in key:
        return "swiglu"
    if "glue::rope_kernel" in key:
        return "rope"
    if "simt::kernel" in key:
        return SIMT_GROUP
    if "tc::kernel" in key or "sum_splits" in key:
        return "fault_matmul"
    if "Memcpy" in key or "Memset" in key:
        return "copies"
    if "nhwcToNchw" in key or "nchwToNhwc" in key:
        return "layout"
    if "at::native" in key:
        return "elementwise glue"
    return other


def pick_resnet_seed(dev):
    """First seed whose random-init ResNet18 spreads the 512 calibration
    images over several classes (a collapsed head keeps its argmax under
    corruption and ΔAcc would be identically 0)."""
    from repro_torch.cnn_setup import clean_argmax_labels
    from repro_torch.models.cnn import ResNet18
    for seed in (7, 5, 11, 13, 17):
        params = ResNet18.init(seed, 16, width=1.0, img=32, device=dev)
        labels = clean_argmax_labels("resnet18", params, 512, device=dev)
        counts = torch.bincount(labels, minlength=16)
        if int((counts > 0).sum()) >= 2 and int(counts.max()) < 512 - 16:
            return seed, params, labels
    raise AssertionError("no ResNet18 init seed gave a working probe")


STORE_BYTES = 16 << 30         # phase 8's activation-store cap
N_EVAL = 512                   # calibration images, the paper's batch


def staged_phase(dev, params, labels, spec, layers, cfg, full_plan, full_rows,
                 full_ev, records):
    """Phase 8: the staged, chain-fused engine on the main path, held
    bitwise against phase 4's whole-forward search."""
    from repro_torch import quickstart
    from repro_torch.cnn_setup import eval_batch, make_evaluator
    from repro_torch.core import PAPER_DEVICES, AFarePart
    from repro_torch.core.eval_engine import device_memory_budget
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import ResNet18

    def evaluator(**kw):
        kw.setdefault("fault_backend", "kernel")
        kw.setdefault("max_store_bytes", STORE_BYTES)
        return make_evaluator("resnet18", params, spec, n_eval=N_EVAL,
                              labels=labels, devices=1, device=dev, **kw)

    # the search, staged and fused, against a warm rerun of the full one
    s_ev = evaluator(eval_batch_size="auto")
    chunk = s_ev.eval_batch_size
    log(f"phase8 eval_batch_size='auto' -> {chunk} rows: peak bytes of a "
        f"1- and a 2-row dispatch {s_ev.auto_probe_bytes}, store cap "
        f"{STORE_BYTES} reserved, budget now "
        f"{device_memory_budget(device=dev)} bytes")
    if not chunk or chunk < 2:
        raise AssertionError(f"auto chunk {chunk}: expected several rows")
    f_ev = evaluator(eval_strategy="full", eval_batch_size=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=f_ev,
                       nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0
    del f_ev
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=s_ev,
                     nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    st = s_ev.staged_stats()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase8 AFarePart staged+fused: {wall:.3f} s wall against "
        f"{full_wall:.3f} s for the full search rerun warm (phase 4, cold: "
        f"see above); launches {launches}")
    log(f"phase8 staged stats {json.dumps(st)}; peak store bytes "
        f"{s_ev._prefix_engine.store.peak_nbytes}; max_memory_allocated "
        f"{peak}")
    if min(launches[name] for name in CNN_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched on the staged path: "
                             f"{launches}")
    if dict(s_ev._cache) != full_rows:
        bad = [k for k in full_rows if s_ev._cache.get(k) != full_rows[k]]
        raise AssertionError(f"staged rows differ from the full path: "
                             f"{len(bad)} of {len(full_rows)} "
                             f"(rows {len(s_ev._cache)}), e.g. {bad[:3]}")
    for p in (plan, f_plan):
        if not (np.array_equal(p.front, full_plan.front)
                and np.array_equal(p.front_objs, full_plan.front_objs)):
            raise AssertionError("the front differs from phase 4's")
    log(f"phase8 staged = full bitwise: {len(full_rows)} rows' accuracies "
        f"and the front ({len(plan.front)} points)")
    for name in CNN_KERNELS:
        records[name]["launches"] = launches[name]
    records["fault_matmul"]["shapes"][0]["launches"] = launches[
        "fault_matmul"]
    s_ev._prefix_engine.store.clear()

    # one population: fused and unfused in turns, then tables against
    # kernel, then a profile of the fused walk (its idle share)
    P = np.array(list(full_rows)[:24])
    got, secs = {}, {}
    for label in ("fused", "unfused", "unfused", "fused", "tables"):
        kw = {"unfused": {"fuse_chains": False},
              "tables": {"fault_backend": "tables"}}.get(label, {})
        e = evaluator(eval_batch_size=chunk, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[label] = e.delta_acc(P)
        torch.cuda.synchronize()
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        st = e.staged_stats()
        log(f"phase8 {label:8s} {secs[label][-1]:.3f} s, "
            f"{st['dispatches']} dispatches, {st['fused_segments']} fused "
            f"segments, {st['unit_runs']} unit runs of "
            f"{st['full_unit_runs']}")
        del e
        torch.cuda.empty_cache()
    if not np.array_equal(got["fused"], got["unfused"]):
        raise AssertionError("fused and unfused staged dAcc differ")
    diff = np.abs(got["tables"] - got["fused"])
    log(f"phase8 fused = unfused bitwise on {len(P)} rows; tables vs kernel: "
        f"{int((diff > 0).sum())} rows differ, max {diff.max():.4f}")
    if diff.max() > 2.0 / N_EVAL:
        raise AssertionError("tables and kernel staged dAcc differ by more "
                             "than 2/n_eval")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    e = evaluator(eval_batch_size=chunk)
    e.clean_accuracy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e.delta_acc(P)
        torch.cuda.synchronize()
        t_walk = (time.perf_counter() - t0) * 1e3
    del e
    torch.cuda.empty_cache()
    kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA
            and not a.key.startswith(RANGE_PREFIX)]
    if not kern:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(a.self_device_time_total for a in kern) / 1e3
    groups = {}
    for a in kern:
        g = groups.setdefault(kernel_group(a.key), [0.0, 0])
        g[0] += a.self_device_time_total / 1e3
        g[1] += a.count
    log(f"phase8 profiled fused walk of {len(P)} rows: kernels busy "
        f"{busy:.1f} ms of {t_walk:.1f} ms wall ({100 * (1 - busy / t_walk):.1f}"
        f"% idle); " + ", ".join(f"{k} {v[0]:.1f} ms in {v[1]}" for k, v in
                                 sorted(groups.items(), key=lambda kv:
                                        -kv[1][0])))

    # TF32: one candidate under PyTorch's default flags and with them off
    row = P[:1]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    d_default = evaluator(eval_strategy="full").delta_acc(row)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d_off = evaluator(eval_strategy="full").delta_acc(row)
    x, _ = eval_batch(N_EVAL, device=dev)
    scale = np.asarray([d.fault_scale for d in PAPER_DEVICES], np.float32)
    wr = torch.as_tensor(0.2 * scale[row], device=dev)
    with torch.no_grad():
        off = ResNet18.apply(params, x, wr, wr, 0)
        torch.backends.cudnn.allow_tf32 = True
        on = ResNet18.apply(params, x, wr, wr, 0)
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = flags
    log(f"phase8 TF32 flags by default (cudnn, matmul) {flags}: dAcc "
        f"{d_default.tolist()} = {d_off.tolist()} with both off; unguarded, "
        f"TF32 convolutions change {int((on != off).sum())} of {on.numel()} "
        f"logits")
    if not np.array_equal(d_default, d_off) or \
            d_off[0] != max(0.0, full_ev.clean_accuracy() - full_rows[
                tuple(int(g) for g in row[0])]):
        raise AssertionError("dAcc depends on the caller's TF32 flags")

    # the per-row conv loop at rows > 1: one 8-row forward against 1 row
    rows8 = np.array(list(full_rows)[:8])
    t1 = time_ms(lambda: full_ev._dispatch(rows8[:1]), iters=5, warmup=1)
    t8 = time_ms(lambda: full_ev._dispatch(rows8), iters=3, warmup=1)
    log(f"phase8 whole forward per row: {t1:.3f} ms at 1 row, "
        f"{t8 / 8:.3f} ms at 8 rows")

    # the quickstart, shortened
    t0 = time.perf_counter()
    out = quickstart.main(["--steps", "20", "--generations", "2"])
    objs = out["plan"].front_objs
    q_stats = out["evaluator"].staged_stats()
    if not (np.isfinite(objs).all() and (objs[:, 2] >= 0).all()
            and out["evaluator"].eval_strategy == "staged"
            and q_stats["unit_runs_avoided"] > 0):
        raise AssertionError(f"quickstart front out of range or no unit "
                             f"run saved: {objs}, {q_stats}")
    log(f"phase8 quickstart: {time.perf_counter() - t0:.2f} s, staged stats "
        f"{json.dumps(q_stats)}")
    return s_ev, plan, wall


LM_B, LM_S = 8, 256             # phase 9's calibration batch
LM_STORE_BYTES = 16 << 30      # phase 9's activation-store cap
STARCODER_LAYERS = 4


def _spread_problem(dacc: np.ndarray, tokens: int) -> str | None:
    """Why a ΔAcc sample cannot tell candidates apart, or None: it
    vanishes (every row within 2 tokens of 0), or saturates (every row
    within 2 tokens of the largest drop), or has fewer than 3 values."""
    if dacc.max() <= 2.0 / tokens:
        return "vanishes"
    if dacc.max() - dacc.min() <= 2.0 / tokens:
        return "saturates"
    if len(np.unique(dacc)) < 3:
        return "saturates"
    return None


def _lm_fixture(tag, dev, cfg, B, S, seed=0, check=True):
    """``init_lm``'s seeded params on ``dev``, the numpy-seeded batch and
    the clean model's own argmax as labels, which must spread where
    ``check`` (printed: the share of labels that are their own input token,
    all of them when random tied weights make the probe the identity)."""
    from repro_torch.lm_setup import calibration_batch, self_labels
    from repro_torch.models.transformer import init_lm

    tokens = B * S
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=seed, device=dev)
    batch = calibration_batch(cfg, B, S, seed=7, device=dev)
    labels = self_labels(cfg, params, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = torch.bincount(labels.reshape(-1), minlength=cfg.vocab)
    distinct, top = int((counts > 0).sum()), int(counts.max())
    # with random weights and tied embeddings the clean argmax at full
    # width is the input token itself (its logit leads by a margin that
    # grows with d_model): the probe is then the identity on this batch,
    # and dAcc counts the tokens a fault moves off themselves.  That is
    # printed; what must not degenerate is the spread of dAcc, checked on
    # the search rows
    own = (labels == batch["tokens"]).sum().item()
    log(f"{tag} init + self-labels {time.perf_counter() - t0:.2f} s; "
        f"labels: {distinct} distinct tokens of {tokens}, the most common "
        f"{top} times; {own} of {tokens} ({own / tokens:.4f}) are their own "
        "input token" + (": the probe is the identity on this batch"
                         if own == tokens else ""))
    if check and (distinct < tokens // 16 or top > tokens // 4):
        raise AssertionError("degenerate self-labels")
    return params, batch, labels


def _lm_evaluator(dev, cfg, params, batch, labels, faulty_bits=LM_FAULTY_BITS,
                  **kw):
    """The LM ΔAcc evaluator at ``FaultSpec(bits=8, faulty_bits)``, rates
    ``LM_RATE`` over ``POD_TIERS_4``; kernel backend, one slot (the
    one-slot baseline phase 15 holds a pool to, on any host) and a 16 GiB
    store unless ``kw`` says otherwise."""
    from repro_torch.core import (POD_TIERS_4, FaultSpec,
                                  make_lm_accuracy_evaluator)
    kw.setdefault("fault_backend", "kernel")
    kw.setdefault("max_store_bytes", LM_STORE_BYTES)
    kw.setdefault("devices", 1)
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    spec = FaultSpec(bits=8, faulty_bits=faulty_bits,
                     weight_fault_rate=LM_RATE, act_fault_rate=LM_RATE)
    return make_lm_accuracy_evaluator(cfg, params, batch, labels, spec, scale,
                                      device=dev, **kw), spec


def _lm_search(tag, dev, cfg, fixture, nsga, tokens, faulty_bits,
               inspect=None):
    """``lm_partitioner`` staged and fused (``eval_batch_size="auto"``),
    then through ``eval_strategy="full"``: every evaluated row and both
    fronts bitwise equal, the spread of ΔAcc over the rows checked.  The
    launch counters are zeroed just before each search and read just
    after.  ``inspect(staged_evaluator)`` runs after the staged search."""
    from repro_torch.core import lm_partitioner
    from repro_torch.kernels import ops

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    s_ev, spec = _lm_evaluator(dev, cfg, *fixture, faulty_bits=faulty_bits,
                               eval_batch_size="auto")
    log(f"{tag} eval_batch_size='auto' -> {s_ev.eval_batch_size} rows: "
        f"peak bytes of a 1- and a 2-row dispatch {s_ev.auto_probe_bytes}, "
        f"store cap {LM_STORE_BYTES}")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = lm_partitioner(cfg, s_ev, fault_spec=spec, fault_backend="kernel",
                          nsga2_config=nsga).optimize()
    sync()
    s_wall = time.perf_counter() - t0
    s_launches, s_unfused = launch_counts(), dict(ops.unfused)
    st = s_ev.staged_stats()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    store_peak = s_ev._prefix_engine.store.peak_nbytes
    s_rows = dict(s_ev._cache)
    if inspect is not None:
        inspect(s_ev)
    del s_ev
    f_ev, _ = _lm_evaluator(dev, cfg, *fixture, faulty_bits=faulty_bits,
                            eval_strategy="full", eval_batch_size=1)
    ops.reset_launches()
    t0 = time.perf_counter()
    f_plan = lm_partitioner(cfg, f_ev, fault_spec=spec, fault_backend="kernel",
                            eval_strategy="full", nsga2_config=nsga).optimize()
    sync()
    f_wall = time.perf_counter() - t0
    f_launches = launch_counts()
    log(f"{tag} lm_partitioner staged+fused: {s_wall:.3f} s wall, launches "
        f"{s_launches}; full: {f_wall:.3f} s wall, launches {f_launches}")
    log(f"{tag} staged stats {json.dumps(st)}; peak store bytes "
        f"{store_peak}; max_memory_allocated {peak}")
    f_rows = dict(f_ev._cache)
    if s_rows != f_rows:
        bad = [k for k in f_rows if s_rows.get(k) != f_rows[k]]
        raise AssertionError(f"staged rows differ from the full path: "
                             f"{len(bad)} of {len(f_rows)}, e.g. {bad[:2]}")
    if not (np.array_equal(plan.front, f_plan.front)
            and np.array_equal(plan.front_objs, f_plan.front_objs)):
        raise AssertionError("the staged front differs from the full one")
    clean = f_ev.clean_accuracy()
    dacc = np.maximum(0.0, clean - np.array(list(f_rows.values())))
    log(f"{tag} staged = full bitwise: {len(f_rows)} rows' accuracies and "
        f"the front ({len(plan.front)} points); clean accuracy {clean:.4f}; "
        f"dAcc over the rows min {dacc.min():.4f} max {dacc.max():.4f}, "
        f"{len(np.unique(dacc))} distinct values")
    why = _spread_problem(dacc, tokens)
    if why:
        raise AssertionError(f"dAcc over the evaluated rows {why}")
    for row, o in zip(plan.front, plan.front_objs):
        log(f"  map={''.join(map(str, row))} lat={o[0] * 1e3:.3f}ms "
            f"energy={o[1] * 1e3:.3f}mJ dAcc={o[2]:.4f}")
    if on_card:
        torch.cuda.empty_cache()
    return dict(f_ev=f_ev, f_rows=f_rows, s_launches=s_launches,
                s_unfused=s_unfused,
                f_launches=f_launches, s_wall=s_wall, f_wall=f_wall,
                plan=plan, f_plan=f_plan)


# profiler ranges the port opens around its scans (``models/layers.py``)
# the port's spans (repro_torch.trace) show on the device timeline as
# annotations named "afp:<span>": ranges, not kernels
RANGE_PREFIX = "afp:"
SCAN_RANGES = ("afp:forward.rglru_scan", "afp:forward.ssd_chunk_scan")


def _host_waits(ev, row) -> int:
    """How many times the kernel backend's whole forward of ``row`` makes
    the host wait on the card (PyTorch's sync debug mode warns at each
    synchronizing call); 0 off the card."""
    if ev.device.type != "cuda":
        return 0
    wr = torch.as_tensor(ev.w_rates_by_device[row], device=ev.device)
    ar = torch.as_tensor(ev.a_rates_by_device[row], device=ev.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ev._apply_fn(ev._qparams, ev._x, wr, ar, int(ev.base_seed))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _profiled_split(fn, on_card, iters):
    """``fn``'s wall (5 readings, each the mean of ``iters`` back-to-back
    calls: the host's share moves with what else the machine runs) and,
    from one more call under torch.profiler, its device time by kernel
    group.  Returns the sorted walls, their median, the profile, the busy
    ms, ``{group: [ms, kernels]}`` and the wrappers' launches in the
    profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    walls = sorted(time_ms(fn, iters=iters, warmup=1)
                   for _ in range(5)) if on_card else [0.0]
    before = dict(ops.launches)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        fn()
        sync()
    launched = {k: v - before.get(k, 0) for k, v in ops.launches.items()}
    # the port's spans show on the device timeline as annotations (ranges,
    # not kernels): kept out of the kernels
    kern = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA
            and not a.key.startswith(RANGE_PREFIX)]
    if on_card and not kern:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(a.self_device_time_total for a in kern) / 1e3
    groups = {}
    for a in kern:
        g = groups.setdefault(kernel_group(a.key, "cuBLAS matmul"), [0.0, 0])
        g[0] += a.self_device_time_total / 1e3
        g[1] += a.count
    return walls, walls[len(walls) // 2], prof, busy, groups, launched


def _groups_text(groups) -> str:
    return ", ".join(f"{k} {v[0]:.3f} ms in {v[1]}" for k, v in
                     sorted(groups.items(), key=lambda kv: -kv[1][0]))


def _profile_candidate(tag, dev, cfg, f_ev, row, B, S):
    """One candidate's wall (5 readings of 3 back-to-back dispatches) and
    its device time by kernel group, with the scans' ranges (the kernels
    that run inside a range's spans summed as its own time).  Returns the
    groups."""
    from torch.autograd import DeviceType

    on_card = dev.type == "cuda"
    walls, t_row, prof, busy, groups, _ = _profiled_split(
        lambda: f_ev._dispatch(row), on_card, iters=3)
    log(f"{tag} one {cfg.name} candidate wall, 5 readings: "
        f"{[round(w, 3) for w in walls]} ms (median {t_row:.3f}); the "
        f"forward waits on the card {_host_waits(f_ev, row)} times")
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    k_ev = [e.time_range for e in dev_ev
            if not e.name.startswith(RANGE_PREFIX)]
    scans = {}
    for name in SCAN_RANGES:
        spans = [e.time_range for e in dev_ev if e.name == name]
        if spans:
            inside = [k for k in k_ev if any(
                r.start <= k.start and k.end <= r.end for r in spans)]
            scans[name] = (sum(k.elapsed_us() for k in inside) / 1e3,
                           len(inside), len(spans),
                           sum(r.elapsed_us() for r in spans) / 1e3)
    log(f"{tag} one {cfg.name} candidate (kernel backend, {B}x{S} tokens): "
        f"{t_row:.3f} ms median wall; profiler: kernels busy {busy:.3f} ms "
        f"({100 * (1 - busy / max(t_row, 1e-9)):.1f}% idle); "
        + _groups_text(groups)
        + "".join(f"; of the glue, {k} {v[0]:.3f} ms in {v[1]} kernels "
                  f"within {v[2]} ranges spanning {v[3]:.3f} ms"
                  for k, v in scans.items()))
    return groups


def lm_phase(dev, records, cfg=None, sc_cfg=None, B=LM_B, S=LM_S,
             nsga=None):
    """Phase 9: the dense transformer ΔAcc path (see the docstring).  The
    arguments other than ``dev`` and ``records`` let a rehearsal on the
    CPU run it at a small size."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import NSGA2Config
    from repro_torch.kernels import ops
    from repro_torch.models.graph import lm_eval_strategy

    cfg = cfg or get_config("olmo-1b")
    sc_cfg = sc_cfg or dataclasses.replace(get_config("starcoder2-3b"),
                                           n_layers=STARCODER_LAYERS)
    nsga = nsga or NSGA2Config(population=24, generations=3, seed=0)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tokens = B * S
    strategy = lm_eval_strategy(cfg, device=dev)
    log(f"phase9 {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f} B params; "
        f"lm_eval_strategy -> {strategy!r}")
    if strategy != "staged":
        raise AssertionError(f"lm_eval_strategy gave {strategy!r}")
    fixture = _lm_fixture("phase9", dev, cfg, B, S)
    L = cfg.n_layers

    # the reference replay's 4 LSBs, printed only: with random weights the
    # input token's logit leads by a margin 4 of 8 bits do not close
    probe = np.random.default_rng(5).integers(0, 4, size=(8, L))
    ev, _ = _lm_evaluator(dev, cfg, *fixture, faulty_bits=4,
                          eval_strategy="full", eval_batch_size=1)
    d = ev.delta_acc(probe)
    log(f"phase9 probe at the reference replay's 4 faulty bits, rates "
        f"{LM_RATE}/{LM_RATE}: clean accuracy {ev.clean_accuracy():.4f}, "
        f"dAcc {np.round(d, 4).tolist()} (not used)")
    del ev
    log(f"phase9 fault regime: FaultSpec(bits=8, faulty_bits={LM_FAULTY_BITS})"
        f" at {LM_RATE}/{LM_RATE} over POD_TIERS_4")

    res = _lm_search("phase9", dev, cfg, fixture, nsga, tokens,
                     LM_FAULTY_BITS)
    s_launches, f_launches = res["s_launches"], res["f_launches"]
    for name in LM_KERNELS:
        if on_card and min(s_launches[name], f_launches[name]) <= 0:
            raise AssertionError(f"{name} never launched on the LM path")
    # a unit step (one layer over a chunk of rows) gates its MLP once and
    # ropes q and k: one swiglu and two rope launches, no op-by-op chain
    unfused = res["s_unfused"]
    log(f"phase9 glue of the staged search: swiglu {s_launches['swiglu']} "
        f"and rope {s_launches['rope']} launches, ops.unfused {unfused}")
    if on_card and (any(unfused.values()) or not
                    s_launches["rope"] == 2 * s_launches["swiglu"] > 0):
        raise AssertionError(f"the staged search's glue: launches "
                             f"{s_launches}, unfused {unfused}")
    for name, r in records.items():
        r["lm_launches"], r["lm_full_launches"] = \
            s_launches[name], f_launches[name]
        if name in unfused:
            r["lm_unfused"] = unfused[name]
        if name not in CNN_KERNELS:          # the LM path is their main path
            r["launches"] = s_launches[name]
    f_ev, f_rows = res["f_ev"], res["f_rows"]

    # one candidate by kernel group
    groups = _profile_candidate("phase9", dev, cfg, f_ev,
                                np.array(list(f_rows)[:1]), B, S)
    for name, r in records.items():
        r["lm_candidate_ms"], r["lm_candidate_launches"] = \
            groups.get(name, (0.0, 0))

    # starcoder2-3b: GQA, LayerNorm with bias, gelu, an untied head
    t0 = time.perf_counter()
    sc_fix = _lm_fixture("phase9", dev, sc_cfg, B, S, seed=1, check=False)
    sc_own = (sc_fix[2] == sc_fix[1]["tokens"]).sum().item()
    sc_ev, _ = _lm_evaluator(dev, sc_cfg, *sc_fix, eval_batch_size="auto")
    P = np.random.default_rng(6).integers(0, 4, size=(8, sc_cfg.n_layers))
    ops.reset_launches()
    d = sc_ev.delta_acc(P)
    sync()
    sc_launches = launch_counts()
    log(f"phase9 {sc_cfg.name} at depth {sc_cfg.n_layers} (d_model "
        f"{sc_cfg.d_model}, kv heads {sc_cfg.n_kv_heads}, d_ff {sc_cfg.d_ff}, "
        f"vocab {sc_cfg.vocab}): dAcc {np.round(d, 4).tolist()} in "
        f"{time.perf_counter() - t0:.2f} s with set-up, launches "
        f"{sc_launches}, {len(torch.unique(sc_fix[2]))} distinct labels, "
        f"{sc_own} of {tokens} their own input token")
    if (on_card and min(sc_launches[k] for k in ("bitflip", *LM_KERNELS))
            <= 0) or not np.isfinite(d).all():
        raise AssertionError("the starcoder2-3b population missed a kernel")
    for name, r in records.items():
        r["starcoder2_launches"] = sc_launches[name]
    del sc_ev, sc_fix

    # generic against kernel on 4 rows of the olmo-1b search
    P4 = np.array(list(f_rows)[:4])
    g_ev, _ = _lm_evaluator(dev, cfg, *fixture, fault_backend="generic",
                            eval_strategy="full", eval_batch_size=1)
    dk, dg = f_ev.delta_acc(P4), g_ev.delta_acc(P4)
    diff = np.abs(dk - dg)
    log(f"phase9 kernel {dk.tolist()} generic {dg.tolist()}: "
        f"{int((diff > 0).sum())} of 4 rows differ, max "
        f"{diff.max() * tokens:.0f} tokens of {tokens}")
    del g_ev
    if diff.max() > 1.0 / tokens:
        raise AssertionError("generic and kernel dAcc differ by more than "
                             "1/(B S) in a row")
    del res["f_ev"], f_ev
    return dict(cfg=cfg, fixture=fixture, nsga=nsga, tokens=tokens, **res)


# phase 10b's depth cuts: mixtral-8x7b's 32 layers resolve to the
# surrogate on one card (a corrupted copy of the experts a row); mamba2's
# 64 are cut to keep the run short
MIXTRAL_LAYERS, MAMBA2_LAYERS = 2, 8
# the kernels each family's path must launch: recurrentgemma-2b's
# attention and MLP run fault_matmul (its two bf16 kernels), its recurrent
# weights and norm gains bitflip; mixtral's experts and router bitflip;
# mamba2 has no fault_matmul site
FAMILY_KERNELS = {"recurrentgemma-2b": ("bitflip", *LM_KERNELS),
                  "mixtral-8x7b": ("bitflip", *LM_KERNELS),
                  "mamba2-2.7b": ("bitflip", "quant_bitflip")}


def family_phase(dev, records, rg_cfg=None, mx_cfg=None, mb_cfg=None,
                 B=LM_B, S=LM_S, nsga=None):
    """Phase 10 (recurrentgemma-2b at full width and depth through
    ``lm_partitioner``, staged = full bitwise, a profile of one candidate)
    and phase 10b (one population each of mixtral-8x7b and mamba2-2.7b at
    full width, depth cut).  The arguments other than ``dev`` and
    ``records`` let a rehearsal on the CPU run it at a small size."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import NSGA2Config
    from repro_torch.kernels import ops
    from repro_torch.models.graph import lm_eval_strategy

    rg_cfg = rg_cfg or get_config("recurrentgemma-2b")
    mx_cfg = mx_cfg or dataclasses.replace(get_config("mixtral-8x7b"),
                                           n_layers=MIXTRAL_LAYERS)
    mb_cfg = mb_cfg or dataclasses.replace(get_config("mamba2-2.7b"),
                                           n_layers=MAMBA2_LAYERS)
    nsga = nsga or NSGA2Config(population=24, generations=3, seed=0)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tokens = B * S
    cfg = rg_cfg
    strategy = lm_eval_strategy(cfg, device=dev)
    log(f"phase10 {cfg.name}: {cfg.n_layers} layers of "
        f"{cfg.block_pattern} ({cfg.n_groups} groups, "
        f"{cfg.n_groups * len(cfg.block_pattern)} slots), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_}, "
        f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, lru_width {cfg.lru_width}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, tied {cfg.tie_embeddings}, "
        f"{cfg.param_count() / 1e9:.3f} B params; lm_eval_strategy -> "
        f"{strategy!r}")
    if strategy != "staged":
        raise AssertionError(f"lm_eval_strategy gave {strategy!r}")
    fixture = _lm_fixture("phase10", dev, cfg, B, S)
    probe = np.random.default_rng(5).integers(0, 4, size=(8, cfg.n_layers))
    for fb in sorted({4, 6, 8, RG_FAULTY_BITS}):
        ev, _ = _lm_evaluator(dev, cfg, *fixture, faulty_bits=fb,
                              eval_strategy="full", eval_batch_size=1)
        d = ev.delta_acc(probe)
        log(f"phase10 probe at {fb} faulty bits, rates {LM_RATE}/{LM_RATE}: "
            f"clean accuracy {ev.clean_accuracy():.4f}, dAcc "
            f"{np.round(d, 4).tolist()}"
            + (" (the search's regime)" if fb == RG_FAULTY_BITS
               else " (not used)"))
        del ev
    res = _lm_search("phase10", dev, cfg, fixture, nsga, tokens,
                     RG_FAULTY_BITS)
    s_launches, f_launches = res["s_launches"], res["f_launches"]
    for name in FAMILY_KERNELS[cfg.name.removesuffix('-smoke')]:
        if on_card and min(s_launches[name], f_launches[name]) <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"{cfg.name} path")
    for name, r in records.items():
        r["rg_launches"], r["rg_full_launches"] = \
            s_launches[name], f_launches[name]
    row = np.array(list(res["f_rows"])[:1])
    groups = _profile_candidate("phase10", dev, cfg, res["f_ev"], row, B, S)
    ops.reset_launches()
    res["f_ev"]._dispatch(row)
    sync()
    log(f"phase10 one {cfg.name} candidate's launches (ops.launches): "
        f"{dict(ops.launches)}")
    for name, r in records.items():
        r["rg_candidate_ms"], r["rg_candidate_launches"] = \
            groups.get(name, (0.0, 0))
    del res, fixture, groups
    if on_card:
        torch.cuda.empty_cache()

    # phase 10b: one population of 8 rows each
    for cfg, seed in ((mx_cfg, 2), (mb_cfg, 3)):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        fix = _lm_fixture("phase10b", dev, cfg, B, S, seed=seed, check=False)
        P = np.random.default_rng(seed).integers(0, 4, size=(8, cfg.n_layers))
        for fb in (7, 8):
            p_ev, _ = _lm_evaluator(dev, cfg, *fix, faulty_bits=fb,
                                    eval_batch_size="auto")
            d = p_ev.delta_acc(P)
            log(f"phase10b {cfg.name} probe at {fb} faulty bits: dAcc "
                f"{np.round(d, 4).tolist()} (spread: "
                f"{_spread_problem(d, tokens) or 'ok'}; not used)")
            del p_ev
            gc.collect()
        ev, _ = _lm_evaluator(dev, cfg, *fix, faulty_bits=RG_FAULTY_BITS,
                              eval_batch_size="auto")
        ops.reset_launches()
        t1 = time.perf_counter()
        d = ev.delta_acc(P)
        sync()
        wall = time.perf_counter() - t1
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        log(f"phase10b {cfg.name} at depth {cfg.n_layers} of "
            f"{cfg.block_pattern} (d_model {cfg.d_model}, "
            f"{cfg.param_count() / 1e9:.3f} B params, "
            + (f"{cfg.n_experts} experts of d_ff {cfg.expert_d_ff}, top "
               f"{cfg.top_k}, capacity factor {cfg.moe_capacity_factor}"
               if cfg.is_moe else
               f"d_inner {cfg.ssm_expand * cfg.d_model}, "
               f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads, "
               f"state {cfg.ssm_state}")
            + f"): eval_batch_size='auto' -> {ev.eval_batch_size} rows "
            f"(probe bytes {ev.auto_probe_bytes}); dAcc "
            f"{np.round(d, 4).tolist()} (spread: "
            f"{_spread_problem(d, tokens) or 'ok'}) in {wall:.2f} s, "
            f"{time.perf_counter() - t0:.2f} s with set-up; launches "
            f"{launches}; max_memory_allocated {peak}")
        if (on_card and min(launches[k] for k in FAMILY_KERNELS[cfg.name.removesuffix('-smoke')])
                <= 0) or not np.isfinite(d).all():
            raise AssertionError(f"the {cfg.name} population missed a "
                                 "kernel")
        key = "mixtral_launches" if cfg.is_moe else "mamba2_launches"
        for name, r in records.items():
            r[key] = launches[name]
        del ev, fix


# the kernels seamless-m4t-medium's path must launch: float32 x on bf16
# weights in the encoder and the cross-attention K/V, bf16 x in the
# decoder, bitflip on the LayerNorm leaves, quant_bitflip on both inputs
ENCDEC_KERNELS = ("bitflip", "quant_bitflip", "fault_weight_tiles",
                  "matmul_tiles", "matmul_tiles_f32")


def encdec_phase(dev, records, cfg=None, B=LM_B, S=LM_S, nsga=None):
    """Phase 11: seamless-m4t-medium at its published widths and depth
    through ``lm_partitioner`` (see the docstring).  The arguments other
    than ``dev`` and ``records`` let a rehearsal on the CPU run it at a
    small size."""
    from repro_torch.configs import get_config
    from repro_torch.core import NSGA2Config
    from repro_torch.core.eval_engine import PrefixRef
    from repro_torch.kernels import ops
    from repro_torch.models.graph import lm_eval_strategy

    cfg = cfg or get_config("seamless-m4t-medium")
    nsga = nsga or NSGA2Config(population=24, generations=3, seed=0)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tokens, ne = B * S, cfg.n_enc_layers
    L = ne + cfg.n_layers
    strategy = lm_eval_strategy(cfg, device=dev)
    log(f"phase11 {cfg.name}: {ne} encoder + {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_}, "
        f"d_ff {cfg.d_ff} ({cfg.act_fn}), {cfg.norm_kind}, vocab {cfg.vocab}"
        f" (untied head), {cfg.dtype}, {cfg.param_count() / 1e9:.3f} B "
        f"params; encoder input {B} x {max(1, S // cfg.enc_ratio)} x "
        f"{cfg.d_model} float32; lm_eval_strategy -> {strategy!r}")
    if strategy != "staged":
        raise AssertionError(f"lm_eval_strategy gave {strategy!r}")
    # the spread of the labels is printed, not required: with random
    # weights the deep ReLU stack sends most tokens to a few labels (the
    # reference's does too); what must not degenerate is ΔAcc, checked on
    # the probe and the search rows
    fixture = _lm_fixture("phase11", dev, cfg, B, S, check=False)
    probe = np.random.default_rng(5).integers(0, 4, size=(8, L))
    fb = None
    for bits in (4, 6, 8):
        ev, _ = _lm_evaluator(dev, cfg, *fixture, faulty_bits=bits,
                              eval_strategy="full", eval_batch_size=1)
        d = ev.delta_acc(probe)
        why = _spread_problem(d, tokens)
        log(f"phase11 probe at {bits} faulty bits, rates {LM_RATE}/{LM_RATE}"
            f": clean accuracy {ev.clean_accuracy():.4f}, dAcc "
            f"{np.round(d, 4).tolist()} (spread: {why or 'ok'})")
        del ev
        if fb is None and why is None:
            fb = bits
    if fb is None:
        raise AssertionError("dAcc vanishes or saturates at 4, 6 and 8 "
                             "faulty bits")
    log(f"phase11 fault regime: FaultSpec(bits=8, faulty_bits={fb}) at "
        f"{LM_RATE}/{LM_RATE} over POD_TIERS_4")
    store_seen = {}

    def inspect(s_ev):
        eng = s_ev._prefix_engine
        store = eng.store._store
        enc = {k for k in store if len(k) == ne}
        dec = [a for k, a in store.items() if len(k) > ne]
        if eng.shared_fields != {"mem": ne - 1} or not dec or not all(
                isinstance(a["mem"], PrefixRef) for a in dec) or not all(
                a["mem"].prefix in enc or a["mem"].prefix not in store
                for a in dec):
            raise AssertionError("a decoder carry holds no PrefixRef to an "
                                 "encoder prefix's memory")
        store_seen.update(memories=len(enc), decoder_carries=len(dec),
                          encoder_prefixes=len({k[:ne] for k in store
                                                if len(k) >= ne}),
                          entries=len(store), nbytes=eng.store.nbytes)

    res = _lm_search("phase11", dev, cfg, fixture, nsga, tokens, fb,
                     inspect=inspect)
    log(f"phase11 store after the staged search: {store_seen['memories']} "
        f"memories stored for {store_seen['encoder_prefixes']} encoder "
        f"prefixes held, {store_seen['decoder_carries']} decoder carries each"
        f" with a PrefixRef, {store_seen['entries']} entries, "
        f"{store_seen['nbytes']} bytes")
    if store_seen["memories"] > store_seen["encoder_prefixes"]:
        raise AssertionError("a memory is stored more than once")
    s_launches, f_launches = res["s_launches"], res["f_launches"]
    for name in ENCDEC_KERNELS:
        if on_card and min(s_launches[name], f_launches[name]) <= 0:
            raise AssertionError(f"{name} never launched on the {cfg.name} "
                                 "path")
    for name, r in records.items():
        r["seamless_launches"], r["seamless_full_launches"] = \
            s_launches[name], f_launches[name]
    for name in ("fault_matmul_bf16w", "matmul_tiles_f32"):
        records[name]["launches"] = s_launches[name]
    row = np.array(list(res["f_rows"])[:1])
    groups = _profile_candidate("phase11", dev, cfg, res["f_ev"], row, B, S)
    if SIMT_GROUP in groups:
        raise AssertionError(f"the SIMT body ran in a {cfg.name} candidate: "
                             f"{groups[SIMT_GROUP]}")
    # no float32-weight body runs here: the float32 split-K sums are the
    # float32-x, bf16-weight route's product's
    if "fault_matmul" in groups:
        g = groups.setdefault("matmul_tiles_f32", [0.0, 0])
        ms, n = groups.pop("fault_matmul")
        g[0] += ms
        g[1] += n
    ops.reset_launches()
    res["f_ev"]._dispatch(row)
    sync()
    counts = launch_counts()
    log(f"phase11 one {cfg.name} candidate's launches (ops.launches): "
        f"{counts}")
    # the route: its products and sums, and the hash passes of its row
    # groups.  The decoder's bf16 x hashes the same shapes as many times
    # (72 at 1024^2, 12 at each MLP shape), so the profile's mean hash
    # launch stands for the route's
    h_ms, h_n = groups.get("fault_weight_tiles", (0.0, 0))
    p_ms, p_n = groups.get("matmul_tiles_f32", (0.0, 0))
    n_route = counts["fault_matmul_bf16w"]
    groups["fault_matmul_bf16w"] = (
        p_ms + (h_ms / h_n * n_route if h_n else 0.0), p_n + n_route)
    log(f"phase11 the float32-x route in one candidate: {n_route} calls, "
        f"{groups['fault_matmul_bf16w'][0]:.3f} ms of device time in "
        f"{groups['fault_matmul_bf16w'][1]} kernels (its products and sums "
        f"{p_ms:.3f} ms, its hash passes at the mean hash launch)")
    for name, r in records.items():
        r["seamless_candidate_ms"], r["seamless_candidate_launches"] = \
            groups.get(name, (0.0, 0))
    del res, fixture
    if on_card:
        torch.cuda.empty_cache()


def reconfig_phase(dev, records, ev, plan, layers, nsga, ticks=8):
    """Phase 12: the online loop (paper Alg. 1, lines 13-19) on phase 8's
    ResNet18 plan and its staged kernel-backend evaluator (see the
    docstring)."""
    from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultEnvironment,
                                  OnlineReconfigurator, simulate_deployment)
    from repro_torch.kernels import ops

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    part = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                     nsga2_config=nsga)
    base = np.asarray(ev.device_fault_scale, float).copy()
    rebuilds0 = ev._fault_env_rebuilds

    def observe(partition, scales):
        ev.device_fault_scale = np.asarray(scales, np.float32)
        return float(ev.delta_acc(np.asarray(partition)[None])[0])

    # the most reliable device the deployed plan uses turns 25x worse at t=3
    used = np.unique(plan.partition)
    reliable = int(used[np.argmin(base[used])])
    shifted = base.copy()
    shifted[reliable] *= 25.0
    theta = 1.5 * observe(plan.partition, base) + 1e-9
    rec = OnlineReconfigurator(part, plan, theta=theta, observe_fn=observe,
                               reopt_generations=3)
    walls, inner = [], rec.step

    def timed_step(t, scales):
        t0 = time.perf_counter()
        out = inner(t, scales)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    rec.step = timed_step
    env = FaultEnvironment(base_scale=base, schedule={3: shifted})
    t0 = time.perf_counter()
    log_ = simulate_deployment(rec, env, ticks)
    wall = time.perf_counter() - t0
    events, obs = log_["events"], log_["observed_delta_acc"]
    log(f"phase12 deployed P={''.join(map(str, plan.partition))} on scales "
        f"{base.tolist()}; device {reliable} x25 at t=3 -> "
        f"{shifted.tolist()}; theta {theta:.4f}; {ticks} ticks in "
        f"{wall:.3f} s; tick walls (ms) {[round(w, 3) for w in walls]}; "
        f"observed dAcc {np.round(obs, 4).tolist()}")
    for e in events:
        log(f"phase12 event at t={e.step}: observed {e.observed_delta_acc:.4f}"
            f" -> P={''.join(map(str, e.new_partition))} predicted "
            f"{e.new_predicted_delta_acc:.4f} (re-optimization in the tick's "
            f"{walls[e.step]:.3f} ms)")
    if not events:
        raise AssertionError("the environment shift triggered no swap")
    if obs[-1] > events[0].observed_delta_acc:
        raise AssertionError("the swap did not lower the observed dAcc")
    if ev._fault_env_rebuilds != rebuilds0:
        raise AssertionError("a hot swap rebuilt the kernel backend's "
                             "functions")
    # a ReoptJob drained a generation at a time against the synchronous
    # step, each from the same state: the deployed plan, the evaluator's
    # row cache and activation store emptied (the loop above stored the
    # very search both repeat, and would serve it from the store)
    def fresh():
        ev._cache.clear()
        ev._prefix_engine.store.clear()

    sync_rec = OnlineReconfigurator(part, plan, theta=-1.0,
                                    observe_fn=observe, reopt_generations=3)
    job_rec = OnlineReconfigurator(part, plan, theta=-1.0,
                                   observe_fn=observe, reopt_generations=3)
    fresh()
    sync_rec.step(3, shifted)
    fresh()
    observed = observe(plan.partition, shifted)
    ops.reset_launches()
    t0 = time.perf_counter()
    job = job_rec.start_reconfigure(3, observed, shifted)
    while not job.advance(1):
        pass
    sync()
    job_wall = time.perf_counter() - t0
    launches = launch_counts()
    a, b = sync_rec.events[0], job_rec.events[0]
    if not (np.array_equal(a.new_partition, b.new_partition)
            and a.new_predicted_delta_acc == b.new_predicted_delta_acc):
        raise AssertionError("the drained ReoptJob differs from the "
                             "synchronous step")
    if on_card and min(launches[k] for k in CNN_KERNELS) <= 0:
        raise AssertionError(f"a CNN kernel did not launch in the "
                             f"re-optimization: {launches}")
    if ev._fault_env_rebuilds != rebuilds0:
        raise AssertionError("the re-optimization rebuilt the kernel "
                             "backend's functions")
    log(f"phase12 ReoptJob drained in {job.generations_run} advances "
        f"({job_wall:.3f} s) = the synchronous step bitwise: P="
        f"{''.join(map(str, b.new_partition))} predicted "
        f"{b.new_predicted_delta_acc:.4f}; launches {launches}; "
        f"_fault_env_rebuilds {ev._fault_env_rebuilds}")
    for name, r in records.items():
        r["reconfig_launches"] = launches[name]


# phase 13's trace, benchmarks/serve.py::run_trace at these settings: engine
# steps, Poisson arrivals a step, slots, KV capacity, decode steps between
# canaries, re-opt generations a job
SERVE_STEPS, SERVE_ARRIVALS = 48, 0.5
SERVE_BATCH, SERVE_MAX_LEN, SERVE_CANARY, SERVE_REOPT_GENS = 8, 64, 4, 4


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def check_decode_kernels(dev, cfg, params, records, batch=SERVE_BATCH):
    """Phase 13's kernel check: ``quant_bitflip`` at the shapes a faulted
    decode step corrupts (each float leaf of a layer, one row, and the
    block input ``[batch, 1, d_model]``), at the ``layers`` module's
    16 bits with 4 faulty, bitwise against its plain version for all four
    fault models, each shape timed beside its bound; then one whole layer
    (its float leaves at the weight rate, seeds + 977 j, and the input at
    the activation rate) as the one group ``_decode_block`` passes,
    bitwise tensor by tensor for all four models, timed beside the sum of
    its tensors' bounds.  Returns the launches one faulted decode step
    makes: a launch pair a layer for each 32 of its float leaves and its
    input; the trace's measured total is held against it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.faultmodel import FAULT_MODELS
    from repro_torch.models import layers as L
    from repro_torch.quant import QuantSpec

    spec, fb = QuantSpec(L.FAULT_BITS), L.FAULT_LSBS
    P = len(cfg.block_pattern)
    shapes = {}                   # shape -> [labels, calls a step, a leaf]
    per_step = 0
    for s in range(P):
        leaves = [(name, t) for name, t in
                  _named_leaves(params["groups"][f"b{s}"])
                  if t.is_floating_point()]
        layers = len(range(s, cfg.n_layers, P))
        per_step += 2 * -(-(len(leaves) + 1) // ops._QB_MAX_ENTRIES) * layers
        for name, t in leaves:
            e = shapes.setdefault(tuple(t.shape[1:]), [[], 0, t[0]])
            e[0].append(name)
            e[1] += layers
    gen = torch.Generator(device=dev).manual_seed(13)
    x_in = torch.randn(batch, 1, cfg.d_model, device=dev, generator=gen) \
        .to(cfg.torch_dtype)
    shapes[(batch, 1, cfg.d_model)] = [["block input"], cfg.n_layers, x_in]
    rate = torch.tensor([0.0, 0.2], device=dev)[1]       # a 0-d rate
    on_card = dev.type == "cuda"
    rows, per_call = [], []
    for shape, (names, calls, x) in shapes.items():
        x = x.contiguous()
        err = 0.0
        for model in FAULT_MODELS:
            k = ops.quant_bitflip(x, 7919 * 3 + 977, rate, fb, spec,
                                  fault_model=model)
            p = ref.quant_bitflip_ref(x, 7919 * 3 + 977, rate, fb, spec,
                                      fault_model=model)
            err = max(err, max_abs_err(k, p))
            if not bits_equal(k, p):
                raise AssertionError(f"quant_bitflip {list(shape)} {model} "
                                     "differs from its plain version")
        n, eb = x.numel(), x.element_size()
        b_ms, b_by = bound(2 * eb * n, int_ops=n * fb * HASH_OPS_PER_DRAW)
        times = dict(
            ms=device_ms(lambda: ops.quant_bitflip(x, 1, rate, fb, spec)),
            wrapper_ms=time_ms(lambda: ops.quant_bitflip(x, 1, rate, fb,
                                                         spec)),
            plain_ms=time_ms(lambda: ref.quant_bitflip_ref(
                x, 1, rate, fb, spec), iters=5)) if on_card else {}
        rows.append(dict(
            label=f"{cfg.name} decode {', '.join(names)}",
            shape=f"{list(shape)} {str(x.dtype)[6:]}, one row",
            bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err,
            **times))
        per_call.append(calls)
    log(f"phase13 quant_bitflip at {[list(s) for s in shapes]}: bitwise equal "
        f"to plain for {FAULT_MODELS} at {spec.bits} bits with {fb} faulty, "
        f"a 0-d rate (one row); the shapes' tensors a step: "
        f"{' + '.join(map(str, per_call))}")

    # layer 0 of slot 0 as _decode_block groups it
    leaves = [t[0] for _, t in _named_leaves(params["groups"]["b0"])
              if t.is_floating_point()]
    xs, seeds = leaves + [x_in], [977 * j for j in range(len(leaves))] + [1]
    arate = torch.tensor([0.0, 0.05], device=dev)[1]
    rates = [rate] * len(leaves) + [arate]
    err = check_quant_group(f"{cfg.name} decode layer", xs, seeds, rates, fb,
                            spec)
    n_all = sum(x.numel() for x in xs)
    bounds = [bound(2 * x.element_size() * x.numel(),
                    int_ops=x.numel() * fb * HASH_OPS_PER_DRAW) for x in xs]
    b_ms = sum(b[0] for b in bounds)
    b_by = "operations" if all(b[1] == "operations" for b in bounds) \
        else "bytes and operations"

    def group():
        return ops.quant_bitflip_group(xs, seeds, rates, fb, spec)

    times = dict(
        ms=device_ms(group), wrapper_ms=time_ms(group),
        plain_ms=time_ms(lambda: ref.quant_bitflip_group_ref(
            xs, seeds, rates, fb, spec), iters=3, warmup=1)) \
        if on_card else {}
    rows.append(dict(
        label=f"{cfg.name} decode layer, one group: {len(leaves)} weight "
              "leaves and the block input",
        shape=" + ".join(f"{list(x.shape)}" for x in xs)
              + f" {str(x_in.dtype)[6:]}, {n_all} elements",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err,
        **times))
    log(f"phase13 quant_bitflip decode layer as one group ({len(xs)} "
        f"tensors, {n_all} elements): bitwise equal to plain for "
        f"{FAULT_MODELS}; {per_step} launches a faulted decode step by the "
        "param tree, one launch pair a layer")
    for r in rows if on_card else []:
        log(f"phase13 time quant_bitflip {r['label']} at {r['shape']}: device "
            f"{r['ms']:.4f} ms, wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; the kernel reaches "
            f"{100 * r['bound_ms'] / r['ms']:.0f}% of it)")
    records["quant_bitflip"]["decode_shapes"] = rows
    return per_step


def _decode_split(tag, fn) -> int:
    """One decode step's wall (median of 5 readings, each the mean of 5
    steps, the argmax read back each step) and its device time by kernel
    group from one profiled step, beside the wrappers' launches in it
    (``quant_bitflip`` counts its kernels: an amax pass and the flip a
    layer).  Returns the fill and memset kernels the profile recorded."""
    from torch.autograd import DeviceType

    walls, wall, prof, busy, groups, launched = _profiled_split(
        fn, True, iters=5)
    n = sum(g[1] for g in groups.values())
    fills = sum(a.count for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA
                and ("fill" in a.key.lower() or "memset" in a.key.lower()))
    host = sorted((a for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda a: -a.self_cpu_time_total)[:8]
    log(f"phase13 {tag} decode step, host time by op (self): "
        + ", ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.3f} ms in "
                    f"{a.count}" for a in host))
    log(f"phase13 {tag} decode step: wall {wall:.3f} ms (5 readings "
        f"{[round(w, 3) for w in walls]}), kernels busy {busy:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle), {n} kernels: "
        + _groups_text(groups) + f"; wrapper launches in the profiled step "
        f"{ {k: v for k, v in launched.items() if v} }; {fills} fill or "
        "memset kernels")
    return fills


def serve_phase(dev, records, cfg=None, steps=SERVE_STEPS, nsga=None):
    """Phase 13: olmo-1b served through ``serve.Engine`` (see the
    docstring).  The canary observes with the sensitivity surrogate,
    ``benchmarks/serve.py``'s default: the random-weight olmo-1b probe is
    the identity (ROADMAP.md Queue C, fact 3), so a canary on the true
    evaluator waits for a trained model (Queue A item 13).  The arguments
    other than ``dev`` and ``records`` let a rehearsal on the CPU run it at
    a small size."""
    from repro_torch._device import fp32_exact
    from repro_torch.configs import get_config
    from repro_torch.core import (POD_TIERS, CostModel, FaultEnvironment,
                                  FaultSpec, NSGA2Config,
                                  OnlineReconfigurator,
                                  SurrogateAccuracyEvaluator, lm_partitioner)
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.graph import lm_layer_infos
    from repro_torch.models.transformer import decode_step, forward, init_lm
    from repro_torch.serve import (Engine, FaultMonitor, MonitorConfig,
                                   Request, ServeConfig)
    from repro_torch.serve.engine import _bucket

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = cfg or get_config("olmo-1b")
    if (L.FAULT_BITS, L.FAULT_LSBS) != (16, 4):
        raise AssertionError("decode corrupts at the layers module's width, "
                             "expected 16 bits with 4 faulty")
    gc.collect()                    # the earlier phases' garbage
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)
    sync()
    log(f"phase13 {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.2f} s")
    per_step = check_decode_kernels(dev, cfg, params, records)

    # the system: benchmarks/serve.py::build_system's surrogate path
    base_scale = np.array([d.fault_scale for d in POD_TIERS])
    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2, bits=8)
    cm = CostModel(lm_layer_infos(cfg, seq=64), POD_TIERS)
    part = lm_partitioner(cfg, SurrogateAccuracyEvaluator(cm),
                          devices=POD_TIERS, seq=64, fault_spec=spec,
                          nsga2_config=nsga or NSGA2Config(
                              population=16, generations=8, seed=0))

    def observe(partition, scales):
        old = cm.fault_scale.copy()
        cm.fault_scale = np.asarray(scales, float)
        v = float(cm.sensitivity_surrogate(np.asarray(partition)[None, :])[0])
        cm.fault_scale = old
        return v

    def partition_to_rates(partition, scales):
        sc = np.asarray(scales if scales is not None else base_scale)
        r = sc[np.asarray(partition)]
        return ((spec.weight_fault_rate * r).astype(np.float32),
                (spec.act_fault_rate * r).astype(np.float32))

    plan = part.optimize()
    # tier 1, the reliable one the plan leans on, degrades x64 at t1 and
    # fails outright (another x8) at t2
    t1, t2 = steps // 4, (2 * steps) // 3
    env = FaultEnvironment(
        base_scale=base_scale,
        schedule={t1: base_scale * np.array([1.0, 64.0]),
                  t2: base_scale * np.array([1.0, 512.0])})
    theta = observe(plan.partition, base_scale) * 5.0 + 1e-9
    rec = OnlineReconfigurator(part, plan, theta=theta, observe_fn=observe,
                               reopt_generations=SERVE_REOPT_GENS)
    mcfg = MonitorConfig(base_error_rate=50.0, ewma_alpha=0.25,
                         scale_quantum=0.05, degraded_factor=4.0,
                         critical_factor=100.0, recovery_ticks=8,
                         watchdog_timeout_ticks=1000)
    mon = FaultMonitor(base_scale, mcfg)
    err_rng = np.random.default_rng(1)

    def error_source(tick):
        return err_rng.poisson(mcfg.base_error_rate * env.scales_at(tick))

    scfg = ServeConfig(max_batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                       canary_every=SERVE_CANARY)
    trace_rng = np.random.default_rng(2)
    arrivals = []
    for t in range(steps):
        for _ in range(trace_rng.poisson(SERVE_ARRIVALS)):
            prompt = trace_rng.integers(
                0, cfg.vocab, int(trace_rng.integers(4, 13))).astype(np.int32)
            arrivals.append((t, Request(
                uid=len(arrivals), prompt=prompt,
                max_new_tokens=int(trace_rng.integers(8, 17)))))
    # warm-up: one request through a clean engine (the library handles)
    Engine(cfg, params, scfg).generate([Request(
        uid=-1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=3)])
    eng = Engine(cfg, params, scfg, reconfigurator=rec,
                 partition_to_rates=partition_to_rates, monitor=mon,
                 error_source=error_source)
    log(f"phase13 plan P={''.join(map(str, plan.partition))} on POD_TIERS "
        f"scales {base_scale.tolist()}; theta {theta:.4g}; {len(arrivals)} "
        f"requests over {steps} steps; tier 1 x64 at step {t1}, x512 at "
        f"{t2}")

    sync()
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            wall0 = time.perf_counter()
            ai = 0
            for t in range(steps):
                while ai < len(arrivals) and arrivals[ai][0] <= t:
                    eng.submit(arrivals[ai][1])
                    ai += 1
                eng.step()
            eng.run()                 # drain the tail under the final scales
            wall = time.perf_counter() - wall0
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    sync()
    launches, unfused = launch_counts(), dict(ops.unfused)
    # sync debug mode warns at each call that makes the host wait, from
    # the Python line that made it
    sites = collections.Counter(f"{os.path.relpath(w.filename, HERE)}:"
                                f"{w.lineno}" for w in caught
                                if "called a synchronizing" in str(w.message))
    waits = sum(sites.values())
    st = eng.stats()
    done = sorted(eng.completed, key=lambda r: r.uid)
    tokens = sum(len(r.out) for r in done)
    log(f"phase13 served {len(done)} requests, {tokens} tokens in "
        f"{st['decode_steps']} decode steps, {wall:.3f} s wall "
        f"({tokens / wall:.1f} tokens/s); TTFT mean "
        f"{1e3 * st['ttft_s_mean']:.3f} ms, TPOT mean "
        f"{1e3 * st['tpot_s_mean']:.3f} ms; decode {st['decode_s']:.3f} s "
        f"({1e3 * st['decode_s'] / max(st['decode_steps'], 1):.3f} ms a "
        f"step), monitor {1e3 * st['monitor_s']:.3f} ms, canary "
        f"{1e3 * st['canary_s']:.3f} ms, {st['reopt_generations']} re-opt "
        f"generations; host waits {waits} at {dict(sites)}; launches "
        f"{launches}")
    log(f"phase13 stats {json.dumps(st)}")
    for e in eng.swap_events:
        log(f"phase13 swap at step {e['step']}: {e['kind']} "
            f"P={''.join(map(str, e['new_partition']))} pre {e['pre_delta']} "
            f"post {e['post_delta']} stall {e['stall_s']:.2e} s, "
            f"{e['migrated_layers']} layers moved")
    log(f"phase13 monitor {json.dumps(mon.stats())}")

    # one faulted and one clean decode step of a full batch, profiled
    if on_card:
        cache = eng._cache
        toks = torch.zeros(SERVE_BATCH, dtype=torch.int32, device=dev)
        pos = torch.full((SERVE_BATCH,), 40, dtype=torch.int32, device=dev)
        fault = eng._fault_triple()
        fills = {tag: _decode_split(tag, lambda f=f: torch.argmax(decode_step(
            params, cfg, cache, toks, pos, fault=f)[0], -1).cpu())
            for tag, f in (("faulted", fault), ("clean", None))}

    # the guards of benchmarks/serve.py --smoke, and the port's own
    problems = []
    if st["dropped"] != 0:
        problems.append(f"{st['dropped']} in-flight requests dropped")
    reopts = [e for e in eng.swap_events if e["kind"] == "reopt"]
    if not reopts:
        problems.append("the fault schedule ran without a re-opt swap")
    for e in reopts:
        if not (e["post_delta"] is not None and e["pre_delta"] is not None
                and e["post_delta"] < e["pre_delta"]):
            problems.append(f"swap at step {e['step']} did not strictly "
                            f"improve dAcc ({e['pre_delta']} -> "
                            f"{e['post_delta']})")
    step_s = st["decode_s"] / max(st["decode_steps"], 1)
    if st["swap_stall_s_max"] > max(step_s, 5e-3):
        problems.append(f"swap stall {st['swap_stall_s_max']:.2e} s above "
                        f"max(one decode step, 5 ms)")
    if st["monitor_s"] >= 0.05 * st["decode_s"]:
        problems.append(f"monitor {st['monitor_s']:.3f} s is >= 5% of decode "
                        f"{st['decode_s']:.3f} s")
    if on_card and waits != st["decode_steps"] + st["admitted"]:
        problems.append(f"{waits} host waits, against one a decode step and "
                        f"one an admission ({st['decode_steps']} + "
                        f"{st['admitted']})")
    if on_card and launches["quant_bitflip"] != per_step * st["decode_steps"]:
        problems.append(f"quant_bitflip launched {launches['quant_bitflip']} "
                        f"kernels, against {per_step} (a launch pair a "
                        f"layer) in each of {st['decode_steps']} faulted "
                        "decode steps")
    if on_card and fills["faulted"] > fills["clean"]:
        problems.append(f"the faulted decode step ran {fills['faulted']} fill "
                        f"or memset kernels, the clean one {fills['clean']}: "
                        "quant_bitflip's workspace was cleared")
    if on_card:
        problems += glue_problems(cfg, launches, unfused, train=False)
    for r in done:
        S = _bucket(len(r.prompt))
        toks = np.zeros((1, S), np.int32)
        toks[0, S - len(r.prompt):] = r.prompt
        with fp32_exact(), torch.no_grad():
            logits = forward(params, cfg, {"tokens": torch.from_numpy(toks)
                                           .to(dev)})
        if int(torch.argmax(logits[0, -1])) != r.out[0]:
            problems.append(f"request {r.uid}: first token {r.out[0]} is not "
                            "the argmax of forward on its prompt")
    if problems:
        raise AssertionError("phase13: " + "; ".join(problems))
    log(f"phase13 guards hold: no drop, {len(reopts)} re-opt swaps each "
        f"strictly improving dAcc, stall {st['swap_stall_s_max']:.2e} s, "
        f"monitor {100 * st['monitor_s'] / st['decode_s']:.2f}% of decode, "
        f"{waits} host waits (one a decode step and an admission), "
        f"quant_bitflip {launches['quant_bitflip']} = {per_step} x "
        f"{st['decode_steps']}, "
        + (f"fill or memset kernels faulted {fills['faulted']} <= clean "
           f"{fills['clean']}, " if on_card else "")
        + f"{len(done)} first tokens = forward's argmax; swiglu "
        f"{launches['swiglu']} and rope {launches['rope']} launches, "
        f"ops.unfused {unfused}")
    for name, r in records.items():
        r["serve_launches"] = launches[name]

    del eng, params
    gc.collect()


# phase 14's olmo-1b training run: the example's microbatches, a warmup and
# a cosine to 0.1 lr; the token ids below TRAIN_VOCAB are valid olmo ids (a
# stream over the full 50304 vocab would build a 20 GB table on the host)
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 60, 1e-3, 10
TRAIN_VOCAB, TRAIN_B, TRAIN_S, TRAIN_MICRO = 4096, 8, 256, 2
RESTART_K = 3                   # 14b: 2k steps against k, restart, k


def _label_spread(cfg, params, batch):
    """``(labels, distinct, most common count, share equal to the input
    token)`` of the clean model's own argmax on ``batch``."""
    from repro_torch.lm_setup import self_labels
    labels = self_labels(cfg, params, batch)
    counts = torch.bincount(labels.reshape(-1), minlength=cfg.vocab)
    own = (labels == batch["tokens"]).float().mean().item()
    return labels, int((counts > 0).sum()), int(counts.max()), own


def _train_profile(trainer, on_card):
    """One more step under torch.profiler: device time by kernel group, the
    optimizer's kernels (those inside the ``train.adamw_update`` spans)
    apart from the rest, the kernels launched.  Returns (busy ms, groups,
    kernels, dt)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
        trainer.run(max_steps=1)
    dt = trainer.history[-1]["dt"]
    if not on_card:
        return 0.0, {}, 0, dt
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e.time_range for e in dev_ev
             if e.name == RANGE_PREFIX + "train.adamw_update"]
    groups = {}
    n = 0
    for e in dev_ev:
        if e.name.startswith(RANGE_PREFIX):
            continue
        r = e.time_range
        g = kernel_group(e.name, "cuBLAS matmul")
        if any(s.start <= r.start and r.end <= s.end for s in spans):
            g = "optimizer " + g
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += r.elapsed_us() / 1e3
        acc[1] += 1
        n += 1
    if not n:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(v[0] for v in groups.values())
    return busy, groups, n, dt


def train_phase(dev, records, cfg=None, steps=TRAIN_STEPS, vocab=TRAIN_VOCAB,
                B=TRAIN_B, S=TRAIN_S, small_cfg=None, small_seq=128,
                small_batch=16, k=RESTART_K, nsga=None):
    """Phase 14: training (see the docstring).  The arguments other than
    ``dev`` and ``records`` let a rehearsal on the CPU run it at a small
    size."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import NSGA2Config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.train_lm import build_100m

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = cfg or get_config("olmo-1b")
    small_cfg = small_cfg or build_100m()
    nsga = nsga or NSGA2Config(population=24, generations=3, seed=0)
    gc.collect()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # ---- 14a: olmo-1b at its published widths and depth ------------
        t0 = time.perf_counter()
        data = TokenStream(vocab=vocab, seq_len=S, batch=B, seed=0)
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=steps)
        trainer = Trainer(cfg, opt, TrainerConfig(
            total_steps=steps + 1, ckpt_every=10 ** 9, ckpt_dir=tmp,
            microbatches=TRAIN_MICRO), data, device=dev)
        # the probe's held-out batch: another seed's first batch
        held = {"tokens": torch.from_numpy(next(TokenStream(
            vocab=vocab, seq_len=S, batch=B, seed=1))["tokens"]).to(dev)}
        _, d0, top0, own0 = _label_spread(cfg, trainer.params, held)
        sync()
        log(f"phase14 {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
            f"{cfg.param_count() / 1e9:.3f} B params; TokenStream(vocab="
            f"{vocab}, seq_len={S}, batch={B}), {TRAIN_MICRO} microbatches, "
            f"AdamW lr {TRAIN_LR} warmup {TRAIN_WARMUP} over {steps} steps; "
            f"set-up {time.perf_counter() - t0:.2f} s; untrained self-labels "
            f"on the held-out batch: {d0} distinct, the most common {top0} "
            f"times, {own0:.4f} their own input token")
        trainer.run(max_steps=1)                  # warm-up: cuBLAS handles
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                wall0 = time.perf_counter()
                trainer.run(max_steps=steps - 1)
                wall = time.perf_counter() - wall0
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message))
        waits = sum(sites.values())
        hist = trainer.history
        loss = np.array([h["loss"] for h in hist])
        dts = np.array([h["dt"] for h in hist[1:]])
        first, last = loss[:5].mean(), loss[-5:].mean()
        log(f"phase14 trained {len(hist)} steps in {wall:.3f} s wall after "
            f"the first: loss {first:.4f} -> {last:.4f} (means of the first "
            f"and last 5), grad_norm {hist[0]['grad_norm']:.4f} -> "
            f"{hist[-1]['grad_norm']:.4f}, lr peak "
            f"{max(h['lr'] for h in hist):.3e}; step dt median "
            f"{1e3 * np.median(dts):.3f} ms (range {1e3 * dts.min():.3f}-"
            f"{1e3 * dts.max():.3f}), first step {1e3 * hist[0]['dt']:.3f} "
            f"ms; {B * S / np.median(dts):.0f} tokens/s; "
            f"max_memory_allocated {peak}; host waits {waits} in "
            f"{steps - 1} steps at {dict(sites)}")
        busy, groups, n_k, pdt = _train_profile(trainer, on_card)
        med = float(np.median(dts))
        opt_ms = sum(v[0] for g, v in groups.items()
                     if g.startswith("optimizer"))
        if on_card:
            log(f"phase14 one profiled step: dt {1e3 * pdt:.3f} ms; kernels "
                f"busy {busy:.3f} ms in {n_k} kernels ({100 * (1 - busy / (1e3 * med)):.1f}% "
                f"idle against the median step), the optimizer "
                f"{opt_ms:.3f} ms ({100 * opt_ms / busy:.1f}%); "
                + _groups_text(groups))
        problems = []
        if not np.isfinite(loss).all():
            problems.append("a non-finite loss")
        if not last < first:
            problems.append(f"the last 5 steps' mean loss {last:.4f} is not "
                            f"below the first 5's {first:.4f}")
        if on_card and waits > steps - 1:
            problems.append(f"{waits} host waits in {steps - 1} steps")
        if problems:
            raise AssertionError("phase14a: " + "; ".join(problems))

        # ---- 14c's labels, while the trained params are at hand --------
        params = trainer.params
        del trainer, data
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        labels, d1, top1, own1 = _label_spread(cfg, params, held)
        log(f"phase14 trained self-labels on the held-out TokenStream(seed=1)"
            f" batch {B}x{S}: {d1} distinct, the most common {top1} times, "
            f"{own1:.4f} their own input token (untrained {own0:.4f})")
        if not own1 < own0:
            raise AssertionError("phase14c: the trained probe is no less the "
                                 "identity than the untrained one")
        probe_stage(dev, cfg, params, held, labels, nsga, records)
        del params, labels, held
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # ---- 14b: restart on the card is bit-identical -----------------
        restart_phase(dev, small_cfg, small_seq, small_batch, k, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe_stage(dev, cfg, params, batch, labels, nsga, records):
    """Phase 14c: ΔAcc probe populations of the trained model at 4, 6 and 8
    faulty bits, then ``lm_partitioner`` at the first that spreads."""
    tokens = labels.numel()
    L = cfg.n_layers
    probe = np.random.default_rng(5).integers(0, 4, size=(8, L))
    fixture = (params, batch, labels)
    chosen = None
    for fb in (4, 6, 8):
        ev, _ = _lm_evaluator(dev, cfg, *fixture, faulty_bits=fb,
                              eval_strategy="full", eval_batch_size=1)
        d = ev.delta_acc(probe)
        why = _spread_problem(d, tokens)
        log(f"phase14 trained probe at {fb} faulty bits, rates "
            f"{LM_RATE}/{LM_RATE}: clean accuracy {ev.clean_accuracy():.4f}, "
            f"dAcc {np.round(d, 4).tolist()}"
            + (f" ({why})" if why else " (spreads)"))
        if fb == 4:
            log(f"phase14 the paper's 4 LSBs "
                f"{'move' if d.max() > 0 else 'move no'} tokens of the "
                f"trained olmo-1b ({int(round(d.max() * tokens))} of {tokens} "
                "at most)")
        del ev
        if chosen is None and why is None:
            chosen = fb
    if chosen is None:
        raise AssertionError("phase14c: dAcc neither spreads at 4, 6 nor 8 "
                             "faulty bits")
    res = _lm_search("phase14", dev, cfg, fixture, nsga, tokens, chosen)
    launches = res["s_launches"]
    if dev.type == "cuda" and min(launches[k] for k in LM_KERNELS) <= 0:
        raise AssertionError(f"phase14c: a kernel never launched in the "
                             f"trained probe's search: {launches}")
    for name, r in records.items():
        r["train_probe_launches"] = launches[name]
    log(f"phase14 trained probe's search at {chosen} faulty bits: launches "
        f"{launches}")


def restart_phase(dev, cfg, seq, batch, k, tmp):
    """Phase 14b: the example's config (``train_lm.build_100m``, float32)
    trained 2k steps straight against k steps, a checkpoint, a fresh
    ``Trainer`` that restores it and k more: params and optimizer state
    bitwise equal.  First the step itself: the same step twice from the
    same state bitwise, and the ops PyTorch calls nondeterministic in it
    (``use_deterministic_algorithms(True, warn_only=True)``, put back
    after)."""
    import os.path as osp

    from repro_torch._tree import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.train.train_step import make_train_step

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    data = TokenStream(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
    t_data = time.perf_counter() - t0
    opt = AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=300)

    def trainer(d, every):
        return Trainer(cfg, opt, TrainerConfig(
            total_steps=2 * k, ckpt_every=every, ckpt_dir=osp.join(tmp, d),
            microbatches=2), data, device=dev)

    # the step twice, and what PyTorch flags in it
    t = trainer("twice", 10 ** 9)
    nb = {key: torch.from_numpy(v).to(dev) for key, v in next(data).items()}
    step = make_train_step(cfg, opt, microbatches=2, remat=False)
    outs = [step(t.params, t.opt_state, nb) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(outs[0]),
                                                 tree_leaves(outs[1])))

    def flagged(fn):
        """The messages PyTorch's deterministic mode warns with in
        ``fn()``, the mode put back after."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                fn()
            finally:
                torch.use_deterministic_algorithms(False)
        return sorted({str(w.message).split(".")[0][:120] for w in caught
                       if "deterministic" in str(w.message)}) or "none"

    in_step = flagged(lambda: step(t.params, t.opt_state, nb))
    # the reference's gold logit, a gather: its backward adds into the
    # logits' gradient with atomics on the card
    x = torch.randn(nb["labels"].numel(), cfg.vocab, device=dev,
                    requires_grad=True)
    lab = nb["labels"].reshape(-1, 1).long()
    by_gather = flagged(lambda: torch.take_along_dim(x, lab, -1).sum()
                        .backward())
    del t, outs, x
    log(f"phase14 {cfg.name} ({cfg.param_count() / 1e6:.1f} M params, "
        f"{cfg.dtype}, TokenStream(vocab={cfg.vocab}) built in {t_data:.2f} "
        f"s): the same step twice bitwise: {same}; ops flagged "
        f"nondeterministic in it: {in_step}; in a gather's backward (the "
        f"reference's gold logit): {by_gather}")
    if not same:
        raise AssertionError("phase14b: the same step twice differs")

    data.load_state_dict({"step": 0})
    full = trainer("full", 10 ** 9)
    full.run()
    data.load_state_dict({"step": 0})
    t1 = trainer("restart", k)
    t1.run(max_steps=k)                       # checkpoint at step k
    tc0 = time.perf_counter()
    t1._checkpoint()                          # again, timed (same content)
    t_save = time.perf_counter() - tc0
    del t1
    t2 = trainer("restart", k)
    tc0 = time.perf_counter()
    ok = t2.try_restore()
    t_restore = time.perf_counter() - tc0
    if not (ok and t2.step == k and data.state_dict() == {"step": k}):
        raise AssertionError("phase14b: no checkpoint restored at step k")
    t2.run()
    leaves = list(zip(tree_leaves((full.params, full.opt_state)),
                      tree_leaves((t2.params, t2.opt_state))))
    bad = sum(not torch.equal(a, b) for a, b in leaves)
    ckpt = osp.join(tmp, "restart", f"ckpt_{k:08d}", "arrays.npz")
    log(f"phase14 restart: {2 * k} steps straight against {k}, a checkpoint "
        f"({osp.getsize(ckpt) / 1e6:.1f} MB, saved in {t_save:.3f} s, "
        f"restored in {t_restore:.3f} s), a fresh Trainer and {k} more: "
        f"{len(leaves) - bad} of {len(leaves)} leaves of params and "
        f"optimizer state bitwise equal; losses "
        f"{[round(h['loss'], 4) for h in full.history]} / "
        f"{[round(h['loss'], 4) for h in t2.history]}")
    if bad:
        raise AssertionError(f"phase14b: {bad} leaves differ after restart")


# phase 17's faulted olmo-1b training: phase 14's batch, microbatches and
# remat setting (none), its rates 0.2 x the tier scale of phase 9's plan
# (POD_TIERS_4, as phase 16b), FAULT_TRAIN_STEPS timed steps of each kind
FAULT_TRAIN_STEPS = 10
FAULT_TRAIN_SEED = 17


def _grad_problems(label, got, want, x, q, g, spec):
    """The kernel's and the plain version's gradients of ``x`` (whose
    q' is ``q`` and output cotangent ``g``): the same nonzero entries,
    each within 2^-20 sum_j |g_j q'_j| / qmax of its row plus 2^-8 of
    its value (another order of the sum, a bf16 rounding).  Returns the
    problems and the largest difference."""
    R = q.shape[0]
    s = (g.reshape(R, -1).float().abs() * q.float().abs()).sum(1) \
        * spec.inv_qmax
    tol = (2.0 ** -20 * s)[:, None].expand(R, x.numel() // R).sum(0) \
        if x.shape[0] == R and x.stride(0) == 0 else \
        (2.0 ** -20 * s)[:, None].expand(R, x.numel() // R)
    tol = tol.reshape(got.shape) + 2.0 ** -8 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    problems = []
    if not torch.equal(got != 0, want != 0):
        problems.append(f"{label}: nonzero entries differ")
    if not bool((diff <= tol).all()):
        problems.append(f"{label}: {int((diff > tol).sum())} entries beyond "
                        "the bound")
    return problems, float(diff.max())


def check_train_kernels(dev, cfg, params, records, B=TRAIN_B // TRAIN_MICRO,
                        S=TRAIN_S):
    """Phase 17a: ``quant_bitflip`` under autograd at a faulted training
    step's shapes (see the docstring): layer 0's float leaves as
    ``_inject`` groups them (expanded over one row, seeds + 977 j) and a
    microbatch's block input, each group's forward with the q' store
    bitwise its plain version (outputs and q'), its backward against
    autograd through the plain version, and the times."""
    from repro_torch._tree import tree_flatten
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.quant import QuantSpec

    on_card = dev.type == "cuda"
    spec, fb = QuantSpec(L.FAULT_BITS), L.FAULT_LSBS
    gen = torch.Generator(device=dev).manual_seed(FAULT_TRAIN_SEED)
    leaves = [t[0].detach().clone() for t in
              tree_flatten(params["groups"]["b0"])[0] if t.is_floating_point()]
    x_in = torch.randn(1, B, S, cfg.d_model, device=dev, generator=gen) \
        .to(cfg.torch_dtype)
    rate = torch.tensor([0.2], device=dev)
    groups = (("block leaves", leaves, [977 * j for j in range(len(leaves))],
               True),
              ("block input", [x_in], [1], False))
    rows = []
    for label, ts, seeds, expand in groups:
        ts = [t.requires_grad_(True) for t in ts]
        xs = [t.expand(1, *t.shape) if expand else t for t in ts]
        rates = [rate] * len(xs)
        shapes = sorted({str(list(x.shape)) for x in xs})
        # the forward with the q' store: bitwise, outputs and integers
        with torch.no_grad():
            ys, qs = ops._qb_forward(xs, seeds, rates, fb, spec, "flip", 2,
                                     keep_q=True)
            for x, y, q, s in zip(xs, ys, qs, seeds):
                wy, wq = ref.quant_bitflip_q_ref(x, s, rate, fb, spec)
                if not (bits_equal(y, wy) and torch.equal(q, wq)):
                    raise AssertionError(f"phase17a {label} {list(x.shape)}: "
                                         "the q' store's forward differs "
                                         "from the plain version")
        del ys
        # the backward against autograd through the plain version
        gs = [torch.randn(x.shape, device=dev, generator=gen).to(x.dtype)
              for x in xs]
        ops.reset_launches()
        torch.autograd.backward(ops.quant_bitflip_group(xs, seeds, rates, fb,
                                                        spec), gs)
        launched = ops.launches["quant_bitflip"]
        want_launches = 2 * -(-len(xs) // ops._QB_MAX_ENTRIES)
        if on_card and launched != want_launches:
            raise AssertionError(f"phase17a {label}: {ops.launches} launches"
                                 f", expected {want_launches} quant_bitflip")
        got = [t.grad for t in ts]
        for t in ts:
            t.grad = None
        torch.autograd.backward(ref.quant_bitflip_group_ref(
            xs, seeds, rates, fb, spec), gs)
        problems, gerr = [], 0.0
        for t, x, q, g, a in zip(ts, xs, qs, gs, got):
            p, e = _grad_problems(f"{label} {list(x.shape)}", a, t.grad, x,
                                  q, g, spec)
            problems += p
            gerr = max(gerr, e)
            t.grad = None
        if problems:
            raise AssertionError("phase17a: " + "; ".join(problems))
        n = sum(x.numel() for x in xs)
        eb, qb = xs[0].element_size(), qs[0].element_size()
        b_ms, b_by = bound(n * (2 * eb + qb),
                           int_ops=n * fb * HASH_OPS_PER_DRAW)
        times = {}
        if on_card:
            with torch.no_grad():
                times = dict(
                    ms=device_ms(lambda: ops._qb_forward(
                        xs, seeds, rates, fb, spec, "flip", 2, keep_q=True),
                        launches=10, replays=5),
                    nostore_ms=device_ms(lambda: ops.quant_bitflip_group(
                        xs, seeds, rates, fb, spec), launches=10, replays=5),
                    plain_ms=time_ms(lambda: ref.quant_bitflip_group_ref(
                        xs, seeds, rates, fb, spec), iters=3, warmup=1),
                    backward_ms=time_ms(lambda: [
                        ref.quant_bitflip_grad_ref(x, q, g, spec)
                        for x, q, g in zip(xs, qs, gs)], iters=3, warmup=1))
        rows.append(dict(label=f"{cfg.name} train {label}",
                         shape=f"{' '.join(shapes)} {str(xs[0].dtype)[6:]}, "
                               f"q' {str(qs[0].dtype)[6:]}",
                         tensors=len(xs), bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, max_abs_err=0.0, grad_max_err=gerr,
                         **times))
        log(f"phase17a quant_bitflip under autograd, {label} "
            f"({len(xs)} tensors, {' '.join(shapes)}, {spec.bits} bits, "
            f"{fb} faulty): forward with the q' store bitwise the plain "
            f"version's outputs and integers ({str(qs[0].dtype)[6:]}), "
            f"{launched} launches under autograd; gradient's nonzero "
            f"entries equal autograd through the plain version's, largest "
            f"difference {gerr:.3e}"
            + (f"; device {times['ms']:.4f} ms with the q' store, "
               f"{times['nostore_ms']:.4f} ms without, plain "
               f"{times['plain_ms']:.3f} ms, backward (plain PyTorch) "
               f"{times['backward_ms']:.3f} ms, bound {b_ms:.4f} ms "
               f"({b_by})" if on_card else ""))
        del xs, ts, qs, gs, got
    records["quant_bitflip"]["train_shapes"] = rows


def _step_loop(dev, step, params, data, steps, on_card):
    """``steps`` train steps as ``Trainer.run`` takes them (the batch on
    the card first, then the step and its one read of the metrics), after
    one warm-up: ``(history, step walls, peak bytes, host waits and their
    sites, launches and ops.unfused over the steps, params)``."""
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import adamw_init

    def to_dev(a):
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if on_card else t

    def one(params, st):
        batch = {k: to_dev(v) for k, v in next(data).items()}
        t0 = time.perf_counter()
        params, st, m = step(params, st, batch)
        keys = list(m)           # the step's one wait: its metrics at once
        vals = torch.stack([m[k].to(torch.float32) for k in keys]).tolist()
        dts.append(time.perf_counter() - t0)
        hist.append(dict(zip(keys, vals)))
        return params, st

    hist, dts = [], []
    params, st = one(params, adamw_init(params))          # the warm-up
    dts.clear()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                params, st = one(params, st)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    launches, unfused = launch_counts(), dict(ops.unfused)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))
    return hist, np.array(dts), peak, sites, launches, unfused, params, st


def fault_train_phase(dev, records, partition, cfg=None, B=TRAIN_B,
                      S=TRAIN_S, vocab=TRAIN_VOCAB, steps=FAULT_TRAIN_STEPS):
    """Phase 17: training with faults (see the docstring).  The arguments
    other than ``dev``, ``records`` and ``partition`` let a rehearsal on the
    CPU run it at a small size."""
    from repro_torch import serve_fault_resilient
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.core import POD_TIERS_4
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import init_lm
    from repro_torch.quant import QuantSpec
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import _value_and_grad, make_loss_fn

    on_card = dev.type == "cuda"
    cfg = cfg or get_config("olmo-1b")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device=dev)        # phase 14's init
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    r = torch.from_numpy(0.2 * scale[np.asarray(partition)]).to(dev)
    fault = (r, r, FAULT_TRAIN_SEED)
    log(f"phase17 {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}; TokenStream(vocab={vocab}, seq_len={S}, batch={B}), "
        f"{TRAIN_MICRO} microbatches, no remat (phase 14's); partition "
        f"{''.join(map(str, partition))} -> weight and activation rates "
        f"{np.round(r.cpu().numpy(), 6).tolist()} (0.2 x POD_TIERS_4 "
        f"fault scale), 16 bits with 4 faulty, seed {FAULT_TRAIN_SEED}; "
        f"init {time.perf_counter() - t0:.2f} s")

    # ---- 17a: the kernel under autograd at the training shapes --------
    check_train_kernels(dev, cfg, params, records, B // TRAIN_MICRO, S)

    # ---- 17b: one step through the kernels and through the plain ------
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(TokenStream(vocab=vocab, seq_len=S, batch=B,
                              seed=0)).items()}
    loss_fn = make_loss_fn(cfg, remat=False, fault=fault)
    kernel_group_fn = ops.quant_bitflip_group

    def plain_group(xs, seeds, rates, fb, spec=QuantSpec(), **kw):
        return ref.quant_bitflip_group_ref(xs, seeds, rates, fb, spec, **kw)

    problems, n_sparse, losses = [], 0, []
    b = B // TRAIN_MICRO
    for i in range(TRAIN_MICRO):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        ops.reset_launches()
        lk, gk = _value_and_grad(loss_fn, params, mb)
        launched = launch_counts()
        ops.quant_bitflip_group = plain_group       # the plain versions
        try:
            lp, gp = _value_and_grad(loss_fn, params, mb)
        finally:
            ops.quant_bitflip_group = kernel_group_fn
        losses.append((float(lk), float(lp)))
        if not bits_equal(lk, lp):
            problems.append(f"microbatch {i}: loss {float(lk)!r} through the "
                            f"kernels, {float(lp)!r} through the plain")
        if on_card and (launched["quant_bitflip"] <= 0 or any(
                launched[k] for k in launched if k != "quant_bitflip")):
            problems.append(f"microbatch {i}: launches {launched}")
        for (path, a), (_, w) in zip(tree_flatten_with_path(gk)[0],
                                     tree_flatten_with_path(gp)[0]):
            name = "/".join(map(str, path))
            if not bits_equal(a, w):
                problems.append(
                    f"microbatch {i} {name}: not bitwise ({int((a != 0).sum())}"
                    f" nonzero entries against {int((w != 0).sum())}, "
                    f"{float((a.float() - w.float()).abs().max()):.3e} apart "
                    "at most)")
            n_sparse += int(path[0] == "groups" and 0 < int((a != 0).sum())
                            <= 4 * a.shape[0] < a.numel())
        del gk, gp
        gc.collect()
    if not n_sparse:
        problems.append("no block leaf has the reference's few nonzero "
                        "gradient entries")
    if problems:
        raise AssertionError("phase17b: " + "; ".join(problems))
    log(f"phase17b one step's {TRAIN_MICRO} microbatches through the kernels "
        f"and through the plain versions on the card: losses "
        f"{[a for a, _ in losses]} bitwise; every gradient leaf bitwise "
        f"({n_sparse} block leaves at a few entries a layer: the "
        f"reference's scale-only gradient); launches a microbatch's forward "
        f"and backward {launched}")

    # ---- 17b: FAULT_TRAIN_STEPS faulted steps beside unfaulted ones ----
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                      total_steps=TRAIN_STEPS)
    out = {}
    for tag, f in (("faulted", fault), ("unfaulted", None)):
        step = make_train_step(cfg, opt, microbatches=TRAIN_MICRO,
                               remat=False, fault=f)
        data = TokenStream(vocab=vocab, seq_len=S, batch=B, seed=0)
        hist, dts, peak, sites, launches, unfused, p2, st = _step_loop(
            dev, step, params, data, steps, on_card)
        *_, busy, groups, _ = _profiled_split(
            lambda: step(p2, st, batch), on_card, iters=1)
        del p2, st
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        med = float(np.median(dts))
        waits = sum(sites.values())
        per_step = {k: v / steps for k, v in launches.items()}
        out[tag] = dict(med=med, peak=peak, waits=waits, per_step=per_step,
                        loss=[h["loss"] for h in hist])
        log(f"phase17b {tag} make_train_step: {steps} steps after a warm-up, "
            f"step wall median {1e3 * med:.3f} ms (range "
            f"{1e3 * dts.min():.3f}-{1e3 * dts.max():.3f}), {B * S / med:.0f}"
            f" tokens/s, max_memory_allocated {peak}, host waits {waits} in "
            f"{steps} steps at {dict(sites)}, launches a step "
            f"{ {k: v for k, v in per_step.items() if v} }, ops.unfused "
            f"{unfused}; losses "
            f"{np.round(out[tag]['loss'], 4).tolist()}"
            + (f"; one profiled step: kernels busy {busy:.3f} ms "
               f"({100 * (1 - busy / (1e3 * med)):.1f}% idle against the "
               f"median), " + _groups_text(groups) if on_card else ""))
        problems = []
        if not np.isfinite(out[tag]["loss"]).all():
            problems.append("a non-finite loss")
        if on_card and waits > steps:
            problems.append(f"{waits} host waits in {steps} steps")
        want_qb = tag == "faulted"
        if on_card and ((per_step["quant_bitflip"] > 0) != want_qb or any(
                v for k, v in per_step.items() if k != "quant_bitflip")):
            problems.append(f"launches a step {per_step}")
        if on_card:
            problems += glue_problems(cfg, launches, unfused, train=True)
        if problems:
            raise AssertionError(f"phase17b {tag}: " + "; ".join(problems))
    for name, rec in records.items():
        rec["fault_train_launches"] = out["faulted"]["per_step"][name]
    f_, u_ = out["faulted"], out["unfaulted"]
    log(f"phase17b faulted against unfaulted on this card: step "
        f"{1e3 * f_['med']:.3f} ms against {1e3 * u_['med']:.3f} ms "
        f"(x{f_['med'] / u_['med']:.3f}), peak {f_['peak']} against "
        f"{u_['peak']} bytes (+{(f_['peak'] - u_['peak']) / 2**30:.2f} GiB), "
        f"quant_bitflip {f_['per_step']['quant_bitflip']:.0f} launches a step")
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- 17c: the online-phase entry point -----------------------------
    t0 = time.perf_counter()
    res = serve_fault_resilient.main(["--device", str(dev)])
    log(f"phase17c python -m repro_torch.serve_fault_resilient --device "
        f"{dev}: {time.perf_counter() - t0:.2f} s, plan "
        f"{''.join(map(str, res['plan'].partition))}, "
        f"{len(res['events'])} reconfiguration events at steps "
        f"{[e.step for e in res['events']]}, engine swaps at decode steps "
        f"{[e['step'] for e in res['swap_events']]}")


# --------------------------------------------------------------------------
# phase 15: multi-device evaluation
# --------------------------------------------------------------------------
POOL_SLOTS = 4                 # phase 15's slots on one card
# phase 15c: a [card, host] pool on ResNet18 at the CPU tests' size
MIXED_N_EVAL, MIXED_SCALE = 8, np.array([0.0, 0.5, 1.0, 2.0], np.float32)
MIXED_RATES = dict(weight_fault_rate=0.3, act_fault_rate=0.05, faulty_bits=4,
                   bits=8)


def _waits_in(fn):
    """``fn()`` and the host waits it made, counted by the Python line that
    waited (PyTorch's sync debug mode warns at each); none off the card."""
    on_card = torch.cuda.is_available()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))
    return out, sites


def _pooled_search(tag, ev, search, want_rows, want_plan, one_wall, kernels,
                   on_card):
    """Run ``search()`` (a partitioner's ``optimize``) on a pooled
    evaluator: launch counts zeroed just before and read just after, host
    waits counted, ``delta_acc`` calls counted.  Fails unless every row and
    the front are bitwise ``want_rows`` / ``want_plan``'s, each of
    ``kernels`` launched, the host waited at most once a ``delta_acc``
    call, one replica is resident a device that ran a chunk (and on no
    other), and (staged) ``device_dispatches`` sums
    to ``dispatches`` over every slot a depth-0 gene was given.  Returns the launches."""
    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ev.clean_accuracy()                 # its one wait, outside the window
    calls = [0]
    inner = ev.delta_acc

    def counted(P):
        calls[0] += 1
        return inner(P)

    ev.delta_acc = counted
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    plan, sites = _waits_in(search)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    del ev.delta_acc
    waits = sum(sites.values())
    rows = dict(ev._cache)
    log(f"{tag}: {wall:.3f} s wall against {one_wall:.3f} s with one slot; "
        f"{ev.dispatches} dispatches, {len(rows)} rows, {calls[0]} "
        f"evaluations, host waits {waits} {dict(sites)}; replicas on "
        f"{[str(d) for d in ev._replicas]}; launches {launches}")
    if rows != want_rows:
        bad = [k for k in want_rows if rows.get(k) != want_rows[k]]
        raise AssertionError(f"{tag}: rows differ from one slot's: "
                             f"{len(bad)} of {len(want_rows)} (rows "
                             f"{len(rows)}), e.g. {bad[:2]}")
    if not (np.array_equal(plan.front, want_plan.front)
            and np.array_equal(plan.front_objs, want_plan.front_objs)):
        raise AssertionError(f"{tag}: the front differs from one slot's")
    if on_card and min(launches[k] for k in kernels) <= 0:
        raise AssertionError(f"{tag}: a kernel of the path never launched")
    if waits > calls[0]:
        raise AssertionError(f"{tag}: {waits} host waits in {calls[0]} "
                             f"evaluations")
    slots = ev._scheduler.devices
    staged = ev.eval_strategy == "staged"
    ran = {slots[i] for i in ev.staged_stats()["device_dispatches"]} \
        if staged else set(slots)
    if not ran <= set(ev._replicas) <= set(slots) | {ev.device}:
        raise AssertionError(f"{tag}: replicas on {list(ev._replicas)}, "
                             f"slots that ran on {sorted(map(str, ran))}")
    if staged:
        # prefix groups: a slot a depth-0 gene, so min(slots, genes seen at
        # depth 0) slots work (two for the paper's two devices)
        st = ev.staged_stats()
        dd = st["device_dispatches"]
        roots = ev._prefix_engine._root_device
        used = min(ev.devices, len(roots))
        log(f"{tag} device_dispatches {dd} of {st['dispatches']}; "
            f"depth-0 genes {sorted(roots)} on slots {roots}; dispatches a "
            f"slot {st['dispatches'] / max(len(dd), 1):.1f}")
        if sum(dd.values()) != st["dispatches"] \
                or set(dd) != set(range(used)):
            raise AssertionError(f"{tag}: device_dispatches {dd} against "
                                 f"{st['dispatches']} dispatches on "
                                 f"{used} of {ev.devices} slots")
    log(f"{tag} = one slot bitwise: {len(rows)} rows and the front "
        f"({len(plan.front)} points)")
    return launches


def _card_pool(dev):
    from repro_torch.launch.mesh import indexed_device
    return [indexed_device(dev)] * POOL_SLOTS


def pool_phase_cnn(dev, records, params, labels, spec, layers, cfg, rows,
                   plan, walls):
    """Phase 15 on the CNN path (see the docstring): (a) the local cards;
    (b) phases 8's and 4's ResNet18 searches on a pool of four slots on one
    card against their one-slot rows, front and walls; (c) a [card, host]
    pool at the CPU tests' size; (d) ``devices="auto"`` where the host has
    two cards or more."""
    from repro_torch.cnn_setup import make_evaluator
    from repro_torch.core import PAPER_DEVICES, AFarePart, FaultSpec
    from repro_torch.core.eval_engine import DeviceScheduler
    from repro_torch.core.objectives import InferenceAccuracyEvaluator
    from repro_torch.launch.mesh import indexed_device
    from repro_torch.models.cnn import ResNet18, quantize_unit_params

    on_card = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    auto = DeviceScheduler("auto")
    log(f"phase15a DeviceScheduler('auto').n_devices = {auto.n_devices}: "
        f"{[torch.cuda.get_device_name(i) for i in range(n_cards)]}")

    def evaluator(devices, **kw):
        kw.setdefault("max_store_bytes", STORE_BYTES)
        return make_evaluator("resnet18", params, spec, n_eval=N_EVAL,
                              labels=labels, fault_backend="kernel",
                              devices=devices, device=dev, **kw)

    def search(ev):
        return lambda: AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                                 nsga2_config=cfg).optimize()

    pools = [("phase15b", _card_pool(dev))]
    if n_cards >= 2:
        pools.append(("phase15d", "auto"))
    for tag, pool in pools:
        ev = evaluator(pool, eval_batch_size="auto")
        log(f"{tag} resnet18 staged on {ev.devices} slots "
            f"{[str(d) for d in ev._scheduler.devices]}: eval_batch_size "
            f"'auto' -> {ev.eval_batch_size} rows")
        launches = _pooled_search(f"{tag} resnet18 staged", ev, search(ev),
                                  rows, plan, walls["staged"], CNN_KERNELS,
                                  on_card)
        if tag == "phase15b":
            for name in CNN_KERNELS:
                records[name]["pool_launches"] = launches[name]
        del ev
        ev = evaluator(pool, eval_strategy="full")
        _pooled_search(f"{tag} resnet18 full", ev, search(ev), rows, plan,
                       walls["full"], CNN_KERNELS, on_card)
        del ev
    if n_cards < 2:
        log(f"phase15d not run: devices='auto' over real cards needs two, "
            f"and this host has {n_cards}")

    # (c) a [card, host] pool at the CPU tests' size: no tensor crosses
    # slots (PyTorch refuses a product of tensors on two devices)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(MIXED_N_EVAL, 16, 16, 3))
                         .astype(np.float32)).to(dev)
    for seed in range(32):
        p = ResNet18.init(seed, 8, width=0.25, img=16, device=dev)
        z = torch.zeros(ResNet18.n_units, device=dev)
        y = ResNet18.apply(p, x, z, z, 0).argmax(-1)
        if len(torch.unique(y)) >= 2:
            break
    else:
        raise AssertionError("no ResNet18 seed spreads the 8 images")
    P = rng.integers(0, len(MIXED_SCALE), size=(12, ResNet18.n_units))
    qp = quantize_unit_params(p)
    mixed = [indexed_device(dev), torch.device("cpu")]
    for strategy in ("staged", "full"):
        def ev_for(devices):
            return InferenceAccuracyEvaluator(
                ResNet18.apply, p, x, y, FaultSpec(**MIXED_RATES),
                MIXED_SCALE, base_seed=3, quant_params=qp,
                fault_backend="kernel", step_fn=ResNet18.step,
                eval_strategy=strategy, devices=devices, device=dev)
        one, two = ev_for(1), ev_for(mixed)
        d1, d2 = one.delta_acc(P), two.delta_acc(P)
        diff = np.abs(d1 - d2)
        on_host = []
        if strategy == "staged":
            roots = two._prefix_engine._root_device
            on_host = [i for i, r in enumerate(P) if roots[int(r[0])] == 1]
        log(f"phase15c resnet18 seed {seed} (8 images, width 0.25) "
            f"{strategy} on [card, host]: replicas "
            f"{[str(d) for d in two._replicas]}; dAcc one slot "
            f"{d1.tolist()}, pool {d2.tolist()}; {int((diff > 0).sum())} of "
            f"{len(P)} rows differ (rows on the host slot: {on_host})")
        if not np.isfinite(d2).all() or diff.max() > 1.0 / MIXED_N_EVAL:
            raise AssertionError("phase15c: the [card, host] pool is off "
                                 "by more than 1/n_eval")
        if set(two._replicas) != set(mixed):
            raise AssertionError("phase15c: the host slot never ran")
        if strategy == "staged":
            card_rows = [i for i in range(len(P)) if i not in on_host]
            if not on_host or not card_rows \
                    or (d1[card_rows] != d2[card_rows]).any():
                raise AssertionError("phase15c: the card slot's rows differ "
                                     "from one slot's, or a slot is unused")
        del one, two


def pool_phase_lm(dev, records, ctx):
    """Phase 15b/d on phase 9's olmo-1b search: four slots on one card (and
    ``devices="auto"`` where there are two cards or more) against phase 9's
    rows, fronts and walls; one replica of the weights resident."""
    from repro_torch.core import lm_partitioner

    on_card = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    cfg, nsga = ctx["cfg"], ctx["nsga"]
    pools = [("phase15b", _card_pool(dev))]
    if n_cards >= 2:
        pools.append(("phase15d", "auto"))
    for tag, pool in pools:
        for strategy in ("staged", "full"):
            kw = dict(eval_batch_size="auto") if strategy == "staged" \
                else dict(eval_strategy="full", eval_batch_size=1)
            gc.collect()        # a dropped evaluator's tensors (cycles)
            before = torch.cuda.memory_allocated(dev) if on_card else 0
            ev, spec = _lm_evaluator(dev, cfg, *ctx["fixture"], devices=pool,
                                     **kw)
            log(f"{tag} {cfg.name} {strategy} on {ev.devices} slots: "
                f"eval_batch_size -> {ev.eval_batch_size} rows")
            want_plan = ctx["plan"] if strategy == "staged" else ctx["f_plan"]
            launches = _pooled_search(
                f"{tag} {cfg.name} {strategy}", ev,
                lambda: lm_partitioner(
                    cfg, ev, fault_spec=spec, fault_backend="kernel",
                    eval_strategy=strategy, nsga2_config=nsga).optimize(),
                ctx["f_rows"], want_plan,
                ctx["s_wall" if strategy == "staged" else "f_wall"],
                LM_KERNELS, on_card)
            if strategy == "staged" and tag == "phase15b":
                gc.collect()
                store = ev._prefix_engine.store.nbytes
                extra = (torch.cuda.memory_allocated(dev) if on_card else 0) \
                    - before - store
                log(f"{tag} {cfg.name} allocator: {extra} bytes beyond the "
                    f"store's {store} after the search, the integer copy "
                    f"{ev.fault_state_bytes()} bytes")
                if extra > 2 * ev.fault_state_bytes():
                    raise AssertionError(f"{tag}: more than one copy of the "
                                         f"weights resident")
                for name in LM_KERNELS:
                    records[name]["pool_launches"] = launches[name]
            del ev
            if on_card:
                torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 16: the launch stack
# --------------------------------------------------------------------------
PP_STAGES, PP_MICRO, PP_STEPS = 4, 4, 5     # 16a: 4 stages, GPipe
SHARDS, SHARD_PROMPT, SHARD_STEPS, SHARD_LEN = 4, 64, 8, 128   # 16b
PSUM_CALLS = 3                                # 16c


def pipeline_stage(dev, records, partition, cfg, B, S, vocab, steps):
    """Phase 16a: olmo-1b's pipelined train step over ``PP_STAGES`` slots of
    the card, cut by phase 9's AFarePart plan.  Returns one layer group's
    gradient from each stage (16c's input)."""
    from repro_torch.core.partitioner import contiguous_stages
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.launch.steps import abstract_pp_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_step import (_value_and_grad,
                                              init_train_state, make_loss_fn)

    on_card = dev.type == "cuda"
    mesh = make_test_mesh((PP_STAGES, 1, 1), ("pod", "data", "model"),
                          pool=[dev] * PP_STAGES)
    shape = ShapeSpec("pp", seq_len=S, global_batch=B, kind="train")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    fn, (pp_s, _, _) = abstract_pp_train_step(
        cfg, mesh, shape, opt, n_micro=PP_MICRO, partition=partition)
    layer_cuts = contiguous_stages(np.asarray(partition), PP_STAGES)
    lens = [fn.cuts[i + 1] - fn.cuts[i] for i in range(PP_STAGES)]
    data = next(TokenStream(vocab=vocab, seq_len=S, batch=B, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    params = init_lm(cfg, seed=0, device=dev)
    with torch.no_grad():
        ref = make_loss_fn(cfg, remat=False)(params, batch).item()
    placed = pp.place_pp_params(pp.to_pp(params, fn.cuts), mesh)
    del params
    gc.collect()
    state = init_train_state(cfg, placed, opt)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    hist, walls, waits = [], [], 0
    ops.reset_launches()
    for i in range(steps):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card and i:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                placed, state, m = fn(placed, state, batch)
                keys = list(m)
                vals = torch.stack([m[k].to(torch.float32).to(dev)
                                    for k in keys]).tolist()
                walls.append(time.perf_counter() - t0)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        if i:
            waits += sum("called a synchronizing" in str(w.message)
                         for w in caught)
        hist.append(dict(zip(keys, vals)))
    launched = {k: launch_counts()[k] for k in records}
    unfused = dict(ops.unfused)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    first = hist[0]["loss"]
    diff = abs(first - ref)
    bound = 2.0 ** -8 * abs(ref)
    med = float(np.median(walls[1:]))
    mfu = model_flops(cfg, shape) / (med * PEAK_FLOPS)
    bubble = (PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1)
    log(f"phase16a {cfg.name} pipelined: P={''.join(map(str, partition))} -> "
        f"layer cuts {list(layer_cuts)} -> group cuts {fn.cuts}, stage "
        f"lengths {lens} on {PP_STAGES} slots of {dev}; {B}x{S} tokens in "
        f"{PP_MICRO} microbatches ({PP_MICRO + PP_STAGES - 1} ticks, bubble "
        f"share {bubble:.4f})")
    log(f"phase16a first loss {first:.6f} against make_loss_fn's {ref:.6f} "
        f"on the same params and batch: |diff| {diff:.6f} (bound "
        f"2^-8 |loss| = {bound:.6f}); losses "
        f"{[round(h['loss'], 4) for h in hist]}; step walls "
        f"{[round(1e3 * w, 3) for w in walls]} ms, median after the first "
        f"{1e3 * med:.3f} ms, {B * S / med:.0f} tokens/s; "
        f"max_memory_allocated {peak}; host waits {waits} in {steps - 1} "
        f"steps; model_flops / (wall x {PEAK_FLOPS:.3g}) = {mfu:.4f}; "
        f"port kernel launches in the {steps} steps "
        f"{launched}, ops.unfused {unfused}")
    problems = []
    if not np.isfinite([h["loss"] for h in hist]).all():
        problems.append("a non-finite loss")
    if diff > bound:
        problems.append(f"first loss {first} off make_loss_fn's {ref} by "
                        f"{diff} > {bound}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        problems.append("the loss did not fall over the steps")
    if on_card and waits > steps - 1:
        problems.append(f"{waits} host waits in {steps - 1} steps")
    # the pipelined step takes no faults (nor does the reference's): it
    # launches no port kernel
    if any(launched.values()):
        problems.append(f"the pipelined steps launched port kernels "
                        f"{launched}")
    if on_card:
        problems += glue_problems(cfg, launched, unfused, train=True)
    if problems:
        raise AssertionError("phase16a: " + "; ".join(problems))
    for name, r in records.items():
        r["pp_launches"] = launched[name]
    loss_fn = pp.make_pp_loss(cfg, mesh, fn.cuts, PP_MICRO)
    _, grads = _value_and_grad(loss_fn, placed, batch)
    del placed, state, loss_fn
    group = [_first_group(g) for g in grads["stages"]]
    del grads
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ops.reset_launches()
    return group


def _first_group(stage_tree):
    """A stage's first layer group's leaves, ``{path: tensor}`` (copies)."""
    from repro_torch._tree import tree_flatten_with_path
    return {"/".join(map(str, p)): t[0, 0].clone()
            for p, t in tree_flatten_with_path(stage_tree)[0]}


def psum_stage(dev, group):
    """Phase 16c: ``compress_psum`` over one slot a stage on the card,
    ``PSUM_CALLS`` calls (the error feedback carries), each bitwise the same
    call on the host."""
    from repro_torch.train.compression import compress_psum, \
        init_error_feedback

    on_card = dev.type == "cuda"
    err = [init_error_feedback(g) for g in group]
    host = [{k: v.cpu() for k, v in g.items()} for g in group]
    herr = [init_error_feedback(g) for g in host]
    n_el = sum(v.numel() for v in group[0].values())
    bad, walls = 0, []
    for call in range(PSUM_CALLS):
        # another gradient a call: the stage's, scaled
        gs = [{k: v * (call + 1) for k, v in g.items()} for g in group]
        hs = [{k: v * (call + 1) for k, v in g.items()} for g in host]
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, err = compress_psum(gs, err)
        if on_card:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        hmean, herr = compress_psum(hs, herr)
        for i in range(len(group)):
            for k in group[i]:
                bad += not bits_equal(mean[i][k].cpu(), hmean[i][k])
                bad += not bits_equal(err[i][k].cpu(), herr[i][k])
    log(f"phase16c compress_psum over {len(group)} slots of {dev}, one layer "
        f"group's gradients a slot ({len(group[0])} leaves, {n_el} elements "
        f"each), {PSUM_CALLS} calls: walls {[round(1e3 * w, 3) for w in walls]}"
        f" ms; {bad} tensors differ from the host's")
    if bad:
        raise AssertionError(f"phase16c: {bad} tensors of compress_psum "
                             f"differ between the card and the host")


def sharded_decode_stage(dev, records, partition, cfg, B=SERVE_BATCH,
                         prompt=SHARD_PROMPT, steps=SHARD_STEPS,
                         max_len=SHARD_LEN):
    """Phase 16b: olmo-1b prefilled by ``abstract_serve_prefill`` and
    decoded ``steps`` faulted steps by ``abstract_serve_decode`` with every
    attention cache's sequence axis over ``SHARDS`` slots of the card
    (data=1, model=SHARDS), against the unsharded ``decode_step``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import POD_TIERS_4
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (abstract_serve_decode,
                                          abstract_serve_prefill)
    from repro_torch.models.transformer import decode_step, init_lm, prefill

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = make_test_mesh((1, SHARDS), pool=[dev] * SHARDS)
    pfn, _ = abstract_serve_prefill(cfg, mesh, ShapeSpec(
        "p", seq_len=max_len, global_batch=B, kind="prefill"))
    dfn, _ = abstract_serve_decode(cfg, mesh, ShapeSpec(
        "d", seq_len=max_len, global_batch=B, kind="decode"))
    params = init_lm(cfg, seed=0, device=dev)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, prompt))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    w = torch.from_numpy(0.2 * scale[np.asarray(partition)]).to(dev)
    with torch.no_grad():
        last, shards = pfn(params, batch)
        logits, cache = prefill(params, cfg, batch, max_len)
    if not torch.equal(last, logits[:, -1]):
        raise AssertionError("phase16b: the sharded prefill's logits differ")
    tok_s = tok_u = last.argmax(-1).to(torch.int32)
    same, worst, top, walls, walls_u, launched = True, 0.0, 0.0, [], [], []
    unfused = []
    for i in range(steps):
        pos = torch.full((B,), prompt + i, dtype=torch.int32, device=dev)
        fault = (w, w, 1000 + i)
        sync()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            ls, shards = dfn(params, shards, {"tokens": tok_s,
                                              "positions": pos}, fault=fault)
        nxt_s = ls.argmax(-1).to(torch.int32)
        got = nxt_s.tolist()
        walls.append(time.perf_counter() - t0)
        launched.append(launch_counts())
        unfused.append(dict(ops.unfused))
        t0 = time.perf_counter()
        with torch.no_grad():
            lu, cache = decode_step(params, cfg, cache, tok_u, pos,
                                    fault=fault)
        nxt_u = lu.argmax(-1).to(torch.int32)
        want = nxt_u.tolist()
        walls_u.append(time.perf_counter() - t0)
        same = same and got == want
        worst = max(worst, (ls.float() - lu.float()).abs().max().item())
        top = max(top, lu.float().abs().max().item())
        tok_s, tok_u = nxt_s, nxt_u
    bound = 2.0 ** -5 * top
    per_step = 2 * cfg.n_layers
    totals = {name: sum(c[name] for c in launched) for name in records}
    log(f"phase16b {cfg.name}: {B} prompts of {prompt} prefilled and "
        f"{steps} faulted decode steps (16 bits, 4 faulty, rates 0.2 x the "
        f"tier scale of P={''.join(map(str, partition))}) on a (data=1, "
        f"model={SHARDS}) mesh of {dev}, {max_len // SHARDS} of {max_len} "
        f"slots a shard: tokens equal on every step {same}; logits max "
        f"|diff| {worst:.5f} (bound 2^-5 max|logit| = {bound:.5f}); step wall "
        f"median {1e3 * np.median(walls):.3f} ms sharded, "
        f"{1e3 * np.median(walls_u):.3f} ms unsharded (walls "
        f"{[round(1e3 * x, 3) for x in walls]}); quant_bitflip kernels a "
        f"sharded step {[c['quant_bitflip'] for c in launched]}; port "
        f"kernel launches in the {steps} sharded steps {totals}")
    if not same or worst > bound:
        raise AssertionError("phase16b: the sharded decode left the "
                             "unsharded one")
    if on_card and any(c["quant_bitflip"] != per_step for c in launched):
        raise AssertionError(f"phase16b: quant_bitflip kernels a step "
                             f"{launched}, expected {per_step}")
    glue = [g for c, u in zip(launched, unfused)
            for g in glue_problems(cfg, c, u, train=False)]
    if on_card and glue:
        raise AssertionError(f"phase16b, a sharded step's {glue[0]}")
    for name, r in records.items():
        r["shard_decode_launches"] = totals[name]
    del params, shards, cache
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def launch_phase(dev, records, partition, cfg=None, B=TRAIN_B, S=TRAIN_S,
                 vocab=TRAIN_VOCAB, steps=PP_STEPS, cli_steps=10):
    """Phase 16: the launch stack (see the docstring).  The arguments other
    than ``dev``, ``records`` and ``partition`` let a rehearsal on the CPU
    run it at a small size."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("olmo-1b")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    group = pipeline_stage(dev, records, partition, cfg, B, S, vocab, steps)
    sharded_decode_stage(dev, records, partition, cfg)
    psum_stage(dev, group)
    del group
    # 16d: the training CLI on the card
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--steps", str(cli_steps), "--ckpt-dir",
         os.path.join(HERE, "build", "launch_train_ckpt"), "--device",
         str(dev)], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
    lines = r.stdout.strip().splitlines()
    log(f"phase16d python -m repro_torch.launch.train --arch olmo-1b --steps "
        f"{cli_steps} --device {dev}: exit {r.returncode} in "
        f"{time.perf_counter() - t0:.2f} s; {' | '.join(lines)}")
    m = re.match(r"loss: ([0-9.]+) -> ([0-9.]+)", lines[-1] if lines else "")
    if r.returncode or not m or not float(m.group(2)) < float(m.group(1)):
        raise AssertionError(f"phase16d: the training CLI failed or its loss "
                             f"did not fall: {r.stderr[-2000:]}")


# --------------------------------------------------------------------------
# phase 18: FSDP x tensor parallelism
# --------------------------------------------------------------------------
TP_STEPS, TP_AGREE = 3, 0.75


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs() * 2.0 ** -7


def tp_train_stage(dev, cfg, B, S, vocab, steps):
    """Phase 18a (and c): olmo-1b's FSDP x TP train step on (2, 2) slots
    of the card against the unsharded step, then a ``seq_axis`` step on
    (1, 4).  Returns the unsharded first loss."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.launch import collectives as C
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import abstract_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    on_card = dev.type == "cuda"
    shape = ShapeSpec("tp", seq_len=S, global_batch=B, kind="train")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    data = next(TokenStream(vocab=vocab, seq_len=S, batch=B, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    params = init_lm(cfg, seed=0, device=dev)
    want, wstate, wm = make_train_step(cfg, opt, microbatches=2)(
        params, init_train_state(cfg, params, opt), batch)
    ref_loss = float(wm["loss"])
    del wstate
    mesh = make_test_mesh((2, 2), pool=[dev] * 4)
    fn, (params_s, _, _) = abstract_train_step(cfg, mesh, shape, opt,
                                               microbatches=1)
    placed = SH.place_params(params, mesh)
    state = SH.place_opt_state(init_train_state(cfg, params, opt), params,
                               mesh)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    hist, walls, waits, coll = [], [], [], []
    worst, n_el = 0.0, 0
    for i in range(steps):
        C.reset_bytes()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card and i:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                placed, state, m = fn(placed, state, batch)
                loss = m["loss"].item()
                walls.append(time.perf_counter() - t0)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        coll.append(dict(C.BYTES))
        if i:
            waits.append(sum("called a synchronizing" in str(w.message)
                             for w in caught))
        hist.append(loss)
        if i == 0:                   # the update against the unsharded one
            got = SH.gather_params(placed, params_s, mesh)
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                # both results rounded to bf16: half a spacing each
                bound = 2 * TRAIN_LR + 2 * _bf16_ulp(torch.maximum(
                    a.float().abs(), b.float().abs()))
                worst = max(worst, float(((a.float() - b.float()).abs()
                                          / bound).max()))
                n_el += b.numel()
            del got
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del want
    diff = abs(hist[0] - ref_loss)
    log(f"phase18a {cfg.name} FSDP x TP train step on (data=2, model=2) "
        f"slots of {dev}, {B}x{S} tokens: first loss {hist[0]:.6f} against "
        f"the unsharded make_train_step(microbatches=2)'s {ref_loss:.6f} "
        f"(|diff| {diff:.6f}, limit 2^-8 = {2 ** -8 * abs(ref_loss):.6f}); "
        f"updated params over {n_el} elements: max |diff| / (2 lr + 2^-6 "
        f"max(|p|, |p'|)) = {worst:.4f} (limit 1); losses {[round(x, 5) for x in hist]}; "
        f"step walls {[round(1e3 * w, 3) for w in walls]} ms; host waits a "
        f"step {waits}; max_memory_allocated {peak}; collective bytes a "
        f"step {coll[-1]} (total {sum(coll[-1].values())})")
    problems = []
    if not np.isfinite(hist).all():
        problems.append("a non-finite loss")
    if diff > 2 ** -8 * abs(ref_loss):
        problems.append(f"first loss off by {diff}")
    if worst > 1:
        problems.append(f"updated params off by {worst} x the bound")
    if on_card and any(w > 1 for w in waits):
        problems.append(f"host waits a step {waits}")
    if problems:
        raise AssertionError("phase18a: " + "; ".join(problems))
    del placed, state
    gc.collect()
    # 18c: seq_axis="model" on (1, 4)
    mesh = make_test_mesh((1, 4), pool=[dev] * 4)
    fn, _ = abstract_train_step(cfg, mesh, shape, opt, microbatches=2,
                                seq_axis="model")
    placed = SH.place_params(params, mesh)
    state = SH.place_opt_state(init_train_state(cfg, params, opt), params,
                               mesh)
    del params
    gc.collect()
    t0 = time.perf_counter()
    _, _, m = fn(placed, state, batch)
    loss = m["loss"].item()
    wall = time.perf_counter() - t0
    log(f"phase18c seq_axis='model' train step on (data=1, model=4): loss "
        f"{loss:.6f} against the unsharded {ref_loss:.6f} (|diff| "
        f"{abs(loss - ref_loss):.6f}, limit {2 ** -8 * abs(ref_loss):.6f}); "
        f"wall {1e3 * wall:.3f} ms (the first step)")
    if not abs(loss - ref_loss) <= 2 ** -8 * abs(ref_loss):
        raise AssertionError(f"phase18c: loss {loss} against {ref_loss}")
    del placed, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def tp_decode_stage(dev, records, partition, cfg, B, prompt, steps,
                    max_len):
    """Phase 18b: prefill and faulted decode with placed params on (1, 4)
    and (2, 2) slots against the unsharded steps fed the same tokens."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import POD_TIERS_4
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (abstract_serve_decode,
                                          abstract_serve_prefill)
    from repro_torch.models.transformer import decode_step, init_lm, prefill

    on_card = dev.type == "cuda"
    params = init_lm(cfg, seed=0, device=dev)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, prompt))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}
    scale = np.array([d.fault_scale for d in POD_TIERS_4], np.float32)
    w = torch.from_numpy(0.2 * scale[np.asarray(partition)]).to(dev)
    per_row = 2 * cfg.n_layers
    totals = {name: 0 for name in records}
    for shp in ((1, 4), (2, 2)):
        mesh = make_test_mesh(shp, pool=[dev] * 4)
        pfn, _ = abstract_serve_prefill(cfg, mesh, ShapeSpec(
            "p", seq_len=max_len, global_batch=B, kind="prefill"))
        dfn, _ = abstract_serve_decode(cfg, mesh, ShapeSpec(
            "d", seq_len=max_len, global_batch=B, kind="decode"))
        rows = dfn.n_rows
        placed = SH.place_params(params, mesh)
        with torch.no_grad():
            last, shards = pfn(placed, batch)
            logits, cache = prefill(params, cfg, batch, max_len)
        top = logits[:, -1].float().abs().max().item()
        pdiff = (last.float() - logits[:, -1].float()).abs().max().item()
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        diffs, agree, launched, walls, unfused = [], [], [], [], []
        for i in range(steps):
            pos = torch.full((B,), prompt + i, dtype=torch.int32, device=dev)
            fault = (w, w, 1000 + i)
            if on_card:
                torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            with torch.no_grad():
                ls, shards = dfn(placed, shards, {"tokens": tok,
                                                  "positions": pos},
                                 fault=fault)
            if on_card:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launched.append(launch_counts())
            unfused.append(dict(ops.unfused))
            with torch.no_grad():
                lu, cache = decode_step(params, cfg, cache, tok, pos,
                                        fault=fault)
            diffs.append((ls.float() - lu.float()).abs().max().item())
            agree.append((ls.argmax(-1) == lu.argmax(-1)).float().mean()
                         .item())
            top = max(top, lu.float().abs().max().item())
            tok = lu.argmax(-1).to(torch.int32)
        qb = [c["quant_bitflip"] for c in launched]
        share = float(np.mean(agree))
        log(f"phase18b {cfg.name} prefill ({B} prompts of {prompt}) and "
            f"{steps} faulted decode steps on (data={shp[0]}, "
            f"model={shp[1]}) slots of {dev}, placed params, {rows} "
            f"computing rows: prefill logits max |diff| {pdiff:.5f}; decode "
            f"logits max |diff| {max(diffs):.5f} (largest logit {top:.3f}); "
            f"argmax agreement a step {[round(a, 3) for a in agree]} (mean "
            f"{share:.4f}, limit {TP_AGREE}); quant_bitflip kernels a step "
            f"{qb} ({[q // rows for q in qb]} a row, unsharded "
            f"{per_row}); step walls {[round(1e3 * x, 3) for x in walls]} "
            f"ms")
        if not np.isfinite(diffs).all() or share < TP_AGREE:
            raise AssertionError(f"phase18b {shp}: argmax agreement {share}")
        if on_card and any(q != per_row * rows for q in qb):
            raise AssertionError(f"phase18b {shp}: quant_bitflip kernels a "
                                 f"step {qb}, expected {per_row} a row")
        glue = [g for c, u in zip(launched, unfused)
                for g in glue_problems(cfg, c, u, train=False)]
        if on_card and glue:
            raise AssertionError(f"phase18b {shp}, a step's {glue[0]}")
        for name in records:
            totals[name] += sum(c[name] for c in launched)
        del placed, shards, cache
        gc.collect()
    for name, r in records.items():
        r["tp_decode_launches"] = totals[name]
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def tp_pipeline_stage(dev, partition, cfg, B, S, vocab, steps):
    """Phase 18d: two pipeline stages over (1, 2) sub-meshes of the card."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import abstract_pp_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_loss_fn

    mesh = make_test_mesh((2, 1, 2), ("pod", "data", "model"),
                          pool=[dev] * 4)
    shape = ShapeSpec("pp", seq_len=S, global_batch=B, kind="train")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    fn, _ = abstract_pp_train_step(cfg, mesh, shape, opt, n_micro=2,
                                   partition=partition)
    data = next(TokenStream(vocab=vocab, seq_len=S, batch=B, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    params = init_lm(cfg, seed=0, device=dev)
    with torch.no_grad():
        ref = make_loss_fn(cfg, remat=False)(params, batch).item()
    placed = pp.place_pp_params(pp.to_pp(params, fn.cuts), mesh)
    del params
    gc.collect()
    state = init_train_state(cfg, placed, opt)
    hist, walls = [], []
    ops.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        placed, state, m = fn(placed, state, batch)
        hist.append(m["loss"].item())
        walls.append(time.perf_counter() - t0)
    launched, unfused = launch_counts(), dict(ops.unfused)
    diff = abs(hist[0] - ref)
    log(f"phase18d {cfg.name} pipelined over two (data=1, model=2) stages "
        f"of {dev}, group cuts {fn.cuts}: first loss {hist[0]:.6f} against "
        f"make_loss_fn's {ref:.6f} (|diff| {diff:.6f}, limit "
        f"{2 ** -8 * abs(ref):.6f}); losses {[round(x, 5) for x in hist]}; "
        f"step walls {[round(1e3 * w, 3) for w in walls]} ms; port kernel "
        f"launches {launched}, ops.unfused {unfused}")
    if diff > 2 ** -8 * abs(ref) or any(launched.values()) or (
            dev.type == "cuda"
            and glue_problems(cfg, launched, unfused, train=True)):
        raise AssertionError(f"phase18d: loss {hist[0]} against {ref}, "
                             f"launches {launched}, ops.unfused {unfused}")
    del placed, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def tp_dryrun_stage():
    """Phase 18e: the dry run of olmo-1b x train_4k on 16x16 meta
    slots."""
    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    rec = run_cell("olmo-1b", "train_4k", out_dir=os.path.join(
        HERE, "chiprun_out", "torch_dryrun"))
    wall = time.perf_counter() - t0
    mem, r = rec["memory"], rec["roofline"]
    log(f"phase18e dry run olmo-1b x train_4k on 16x16 meta slots: wall "
        f"{wall:.2f} s (probes {rec['probe_compile_s']} s); per device "
        f"argument {mem['argument_bytes']} B, output {mem['output_bytes']} "
        f"B, temp {mem['temp_bytes']} B, peak {mem['peak_bytes']} B; step "
        f"flops {rec['flops']:.4e}, bytes {rec['bytes_accessed']:.4e}, "
        f"collective bytes {rec['collective_bytes']:.4e}; roofline "
        f"bottleneck {r['bottleneck']}, lower bound "
        f"{r['step_time_lower_bound_s']:.4f} s; model_flops / flops "
        f"{rec['useful_flop_ratio']:.4f}")
    if rec["status"] != "ok" or not rec["flops"] > 0:
        raise AssertionError(f"phase18e: {rec}")


def tp_phase(dev, records, partition, cfg=None, B=TRAIN_B, S=TRAIN_S,
             vocab=TRAIN_VOCAB, steps=TP_STEPS, serve_B=SERVE_BATCH,
             prompt=SHARD_PROMPT, dsteps=SHARD_STEPS, max_len=SHARD_LEN,
             dry=True):
    """Phase 18 (see the docstring).  The arguments other than ``dev``,
    ``records`` and ``partition`` let a rehearsal on the CPU run it at a
    small size."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config("olmo-1b")
    t0 = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tp_train_stage(dev, cfg, B, S, vocab, steps)
    tp_decode_stage(dev, records, partition, cfg, serve_B, prompt, dsteps,
                    max_len)
    tp_pipeline_stage(dev, partition, cfg, B, S, vocab, steps)
    if dry:
        tp_dryrun_stage()
    log(f"phase18 wall {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.cnn_setup import (accuracy_under_partition,
                                       clean_argmax_labels, make_evaluator)
    from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,
                                  FaultUnawareBaseline, NSGA2Config)
    from repro_torch.kernels import _build, ops
    from repro_torch.models.cnn import AlexNet, ResNet18

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # phase 1: nothing to set (see the docstring)
    # phase 2
    smi = nvidia_smi()
    log("card:", smi, "| torch", torch.__version__, "cuda", torch.version.cuda)
    info = _build.build_all()
    log(f"phase2 build: {info['seconds']:.1f} s for {info['built']} "
        f"into {info['dir']}")
    for name, text in info["ptxas"].items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs)} "
            f"registers a thread, {spill} bytes of spills")

    records = {
        "bitflip": dict(route="cuda", source="src/repro_torch/csrc/bitflip.cu",
                        replaces="src/repro/kernels/bitflip.py:57"),
        "quant_bitflip": dict(
            route="cuda", source="src/repro_torch/csrc/quant_bitflip.cu",
            replaces="src/repro/kernels/quant_bitflip.py:50"),
        "fault_matmul": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
        "fault_matmul_bf16w": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
        "fault_weight_tiles": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
        "matmul_tiles": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
        "matmul_tiles_f32": dict(
            route="cuda", source="src/repro_torch/csrc/fault_matmul.cu",
            replaces="src/repro/kernels/fault_matmul.py:61"),
        "swiglu": dict(route="cuda", source="src/repro_torch/csrc/glue.cu",
                       replaces="none: the op-by-op gate ref.swiglu_ref"),
        "rope": dict(route="cuda", source="src/repro_torch/csrc/glue.cu",
                     replaces="none: the op-by-op RoPE ref.rope_ref"),
    }
    check_kernels(dev, records)
    check_fault_matmul_bf16(dev, records)
    check_lm_family_kernels(dev, records)
    check_encdec_kernels(dev, records)
    check_glue_kernels(dev, records)

    # phase 4: the main path
    spec = FaultSpec(**SPEC_RATES)
    seed, params, labels = pick_resnet_seed(dev)
    log(f"phase4 resnet18 width 1.0 seed {seed}: clean-argmax labels span "
        f"{int((torch.bincount(labels, minlength=16) > 0).sum())} classes")
    layers = ResNet18.layer_infos(num_classes=16, width=1.0, img=32)
    cfg = NSGA2Config(population=24, generations=3, seed=0)
    ev = make_evaluator("resnet18", params, spec, n_eval=512,
                        fault_backend="kernel", labels=labels,
                        eval_strategy="full", devices=1, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                     nsga2_config=cfg).optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    full_rows = dict(ev._cache)
    base = FaultUnawareBaseline(layers, PAPER_DEVICES,
                                nsga2_config=cfg).optimize()
    main_launches = launch_counts()
    log(f"phase4 AFarePart (full): {wall:.3f} s wall, "
        f"{ev.dispatches} dispatches, {ev._engine.rows_evaluated} rows, "
        f"launches {main_launches}")
    if min(main_launches[name] for name in CNN_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{main_launches}")
    objs = plan.front_objs
    if not (np.isfinite(objs).all() and (objs[:, 2] >= 0).all()
            and (objs[:, 2] <= 1).all() and objs[:, 2].max() > 0):
        raise AssertionError(f"AFarePart front out of range: {objs}")
    log(f"phase4 front ({len(plan.front)} points):")
    for row, o in zip(plan.front, objs):
        log(f"  map={''.join(map(str, row))} lat={o[0] * 1e3:.3f}ms "
            f"energy={o[1] * 1e3:.3f}mJ dAcc={o[2]:.4f}")
    for tool, p in (("AFarePart", plan), ("fault-unaware", base)):
        acc = accuracy_under_partition("resnet18", params, p.partition, 0.2,
                                       0.2, n_eval=512, labels=labels,
                                       device=dev)
        log(f"phase4 {tool:13s} P={''.join(map(str, p.partition))} "
            f"top-1 under 20% faults={acc:.4f} lat={p.latency * 1e3:.3f}ms "
            f"energy={p.energy * 1e3:.3f}mJ")
    for name, r in records.items():
        r["full_launches"] = main_launches[name]

    # phase 5: AlexNet at width 1.0
    a_params = AlexNet.init(0, 16, width=1.0, img=32, device=dev)
    a_labels = clean_argmax_labels("alexnet", a_params, 512, device=dev)
    a_ev = make_evaluator("alexnet", a_params, spec, n_eval=512,
                          fault_backend="kernel", labels=a_labels, device=dev)
    P = np.random.default_rng(1).integers(0, 2, size=(8, AlexNet.n_units))
    ops.reset_launches()
    t0 = time.perf_counter()
    a_dacc = a_ev.delta_acc(P)
    torch.cuda.synchronize()
    log(f"phase5 alexnet width 1.0 dAcc {np.round(a_dacc, 4).tolist()} in "
        f"{time.perf_counter() - t0:.2f} s, launches {dict(ops.launches)}")
    if ops.launches["fault_matmul"] <= 0 or not np.isfinite(a_dacc).all():
        raise AssertionError("alexnet population did not run fault_matmul")
    records["fault_matmul"]["shapes"][1]["launches"] = ops.launches[
        "fault_matmul"]

    # phase 6: generic against kernel on one ResNet18 population
    P = np.random.default_rng(2).integers(0, 2, size=(8, ResNet18.n_units))
    g_ev = make_evaluator("resnet18", params, spec, n_eval=512,
                          fault_backend="generic", labels=labels, device=dev)
    dk, dg = ev.delta_acc(P), g_ev.delta_acc(P)
    diff = np.abs(dk - dg)
    log(f"phase6 kernel {np.round(dk, 4).tolist()} generic "
        f"{np.round(dg, 4).tolist()}: {int((diff > 0).sum())} of {len(P)} "
        f"rows differ, max {diff.max():.4f}")
    # the generic backend's fc runs cuBLAS, the kernel backend fault_matmul:
    # another fp32 summation order can move a near-tie image
    if diff.max() > 2.0 / 512:
        raise AssertionError("generic and kernel dAcc differ by more than "
                             "2/n_eval")

    # phase 7: where one candidate's device time goes, by kernel
    row = np.zeros((1, ResNet18.n_units), np.int64)
    t_row = time_ms(lambda: ev._dispatch(row), iters=5, warmup=1)
    log(f"phase7 one ResNet18 candidate (kernel backend, 512 images): "
        f"{t_row:.3f} ms device time")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev._dispatch(row)
        torch.cuda.synchronize()
    kernels_ = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA
                and not a.key.startswith(RANGE_PREFIX)]
    if not kernels_:
        raise AssertionError("the profiler recorded no device kernel")
    busy = sum(a.self_device_time_total for a in kernels_) / 1e3
    log(f"phase7 profiler: kernels busy {busy:.3f} ms of {t_row:.3f} ms "
        f"({100 * (1 - busy / t_row):.1f}% idle)")
    groups = {}
    for a in kernels_:
        g = groups.setdefault(kernel_group(a.key), [0.0, 0])
        g[0] += a.self_device_time_total / 1e3
        g[1] += a.count
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"phase7 per candidate: {name:16s} {ms:8.3f} ms {count:4d} launches")
    for name, r in records.items():
        r["candidate_ms"], r["candidate_launches"] = groups.get(name, (0.0, 0))
    for a in sorted(kernels_, key=lambda a: a.self_device_time_total,
                    reverse=True)[:12]:
        log(f"  {a.self_device_time_total / 1e3:8.3f} ms {a.count:4d}x "
            f"{a.key[:90]}")

    # phase 8: the staged path
    s_ev, s_plan, s_wall = staged_phase(dev, params, labels, spec, layers,
                                        cfg, plan, full_rows, ev, records)
    # phase 12, run here while phase 8's evaluator is at hand: the online
    # loop on its plan
    reconfig_phase(dev, records, s_ev, s_plan, layers, cfg)
    del ev, s_ev
    torch.cuda.empty_cache()
    # phase 15 on the CNN: phases 8 and 4 on a pool of slots
    pool_phase_cnn(dev, records, params, labels, spec, layers, cfg,
                   full_rows, plan, {"staged": s_wall, "full": wall})
    del params
    torch.cuda.empty_cache()

    # phase 9: the dense transformer path, then phase 15 on its search
    lm_ctx = lm_phase(dev, records)
    torch.cuda.empty_cache()
    pool_phase_lm(dev, records, lm_ctx)
    lm_partition = lm_ctx["plan"].partition          # phase 16's cut
    del lm_ctx
    torch.cuda.empty_cache()

    # phases 10 and 10b: the RG-LRU, MoE and SSD block kinds
    family_phase(dev, records)
    torch.cuda.empty_cache()

    # phase 11: the encoder-decoder
    encdec_phase(dev, records)
    torch.cuda.empty_cache()

    # phase 13: serving olmo-1b
    serve_phase(dev, records)
    torch.cuda.empty_cache()

    # phase 14: training, and the trained olmo-1b as the LM probe
    train_phase(dev, records)
    torch.cuda.empty_cache()

    # phase 17: training with faults, and the online-phase entry point
    fault_train_phase(dev, records, lm_partition)
    torch.cuda.empty_cache()

    # phase 16: the launch stack (phase 9's plan cuts the pipeline)
    launch_phase(dev, records, lm_partition)
    torch.cuda.empty_cache()

    # phase 18: FSDP x tensor parallelism
    tp_phase(dev, records, lm_partition)

    kernels = [dict(name=name, **{k: r[k] for k in RECORD_KEYS if k in r})
               for name, r in records.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
