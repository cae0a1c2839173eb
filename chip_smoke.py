#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the whole run, one card
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --resnet-only    # the card, then phase 19 alone
    python3 chip_smoke.py --resume-drill JSON   # one run of phase 17's drill
    python3 chip_smoke.py --fit-only       # the card, the build, phase 20
    python3 chip_smoke.py --long-only      # the card, the build, phase 21
    python3 chip_smoke.py --static-only    # the card, the build, phase 22
    python3 chip_smoke.py --seq2seq-only   # the card, the build, phase 23
    python3 chip_smoke.py --rnn-only       # the card, the build, phase 24
    python3 chip_smoke.py --moe-only       # the card, the build, phase 25
    python3 chip_smoke.py --unet-only      # the card, the build, phase 26
    python3 chip_smoke.py --dlrm-only      # the card, the build, phase 27
    python3 chip_smoke.py --fit-drill JSON # one run of phase 20's drill

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit as nvidia-smi reports them, torch and
     CUDA versions; no CUDA is a failure;
  2. build: every kernel source in paddle_tpu_torch/ops/csrc, one nvcc
     each, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes, the flash forward also at the training main path's
     (B=16, T=512, 12 heads, bfloat16, causal, as make_eval_step gives
     it), and at the edge cases (ragged T, idle slot, block
     edge, the paged kernel's chunk edges for each cache, T-1, full clamp,
     every slot full, NaN tail, a 16384-row cache), and the fused
     dropout-residual(+LN) kernels at float32, bfloat16 and mixed input
     types, Hd 64, 768 and 1000, p 0, 0.1 and 1, both dropout modes, and
     at the training paths' shapes, fed the kernels' own dropout bits,
     with the tolerances stated below; the dropout kernels read their key
     from a Philox word on the card (seed, base) and a delta, held to the
     plain versions at (seed, base + delta); AdamW reads lr, c1 and c2
     from a scalar buffer on the card, also over t = 1..5 with the lr
     changed; with the scalar buffer's guard word at 0 the kernel and the
     plain rule leave the parameter and both moments bit-equal to their
     inputs (float32 and bfloat16); with the clip's scale word at 0.3711
     the kernel and the plain rule bit-equal to the composed float32
     product g * scale; the one-launch update over a mixed list of 324
     tensors (every type pair, coeff 0 and 0.01, scaled and not, lr
     factors, sizes 1 to 4 M + 3, views off 16-byte alignment) bit-equal
     to the plain rule tensor by tensor over 3 steps, eagerly and from a
     CUDA graph, the guard word 0 on step 2; F.dropout's keep-mask kernel
     against its plain version (and its bits route against the plain
     bits) at the main paths' shapes and at h = 1, h and n not multiples
     of 4; the backward's mask equal to the forward's; each
     gate raising on inputs its kernel does not take, and the flash gate
     handing an additive mask and dropout p=1 to the plain attention;
  4. each kernel's device time (CUDA events, median of 25 runs of 10
     back-to-back launches queued behind a sleep kernel) beside its bound,
     its plain version's time and one library call's time;
  5. the main path: gpt2-small at full width and depth (seeded weights)
     behind GenerationEngine(max_batch=8, max_seq_len=512, buckets
     (32, 128, 256)) and ContinuousBatcher with the prefix cache on,
     serving 16 requests; the engine's step programs are CUDA graphs,
     each captured once and replayed; the kernel launch counters are
     zeroed just before and read just after, and must equal each
     program's runs times its captured launches, with kernels launched
     through replays; the compile-once contract (one decode program, at
     most one prefill program a bucket, a suffix program for the shared
     head of requests 2 and 6), each program's capture time and the graph
     pool's memory; the flash forward's launches by prefill bucket
     (summed against each bucket's time and bound); a torch.profiler
     breakdown of the decode step; the same requests again on the same
     engine (dirty slots, a fresh prefix cache, every program built):
     the same tokens and no build; then the same requests through the
     engine's step bodies run eagerly: tokens identical and the final
     cache (k, v, lens) bit-equal to the replayed run's;
  6. the same requests with both kernel flags off (the plain versions on
     the card, captured the same way): tokens must agree, or first differ
     where the plain run's top-2 logit gap is a near tie;
  7. a shorter int8-cache run, checked, profiled and held to the eager
     bodies (scales too) the same way, and to the plain int8 path;
  8. the server: the same model behind InferenceServer (the same engine
     settings, http_port=0, the flight recorder's and the heartbeat's
     directories in a temporary folder), requests submitted from 4
     threads: (a) one worker, the 16 requests of phase 5; (b) two
     workers, the same, both engines' programs built; (c) an int8 cache,
     one worker, phase 7's 8 requests. Each: tokens held to phase 6's (or
     7's) plain run by its rule; /healthz (200) and /metrics scraped while
     it serves, /statusz before and after (completed requests and tokens
     equal to the handles', ttft_ms present, hbm in_use in (0, memory
     reserved], retraces by engine equal to the programs built); the
     heartbeat file fresh; the launch counts zeroed just before and read
     just after, the flash forward and the paged decode kernel launched,
     also through replays; tokens/s, TTFT p50, the decode step, the graph
     pools and peak memory printed. (d) the crash drill: a worker whose
     decode raises on its third call: its handles fail with the fault
     chained, a crash bundle with its six files (memory.json too), and
     /healthz 503 naming the dead worker, 200 after stop(). (e) the
     built engine's decode step with telemetry off and on, in turns;
  9. the training kernels' device times at the training main path's
     shapes (flash forward with lse and dropout, flash backward dq and
     dk/dv: B=16, H=12, T=512, D=64, bfloat16, causal, p=0.1; AdamW over
     every gpt2-small parameter), each beside its bound, its plain
     version's time and one library call's time (AdamW's one launch over
     the 148 tensors with the clip's scale word replayed from one CUDA
     graph, beside the launch without it and the eager call's device and
     host time); the flash
     forward and backward also at p=0 (their Philox share) and at ERNIE's
     attention (B=32, T=128, not causal, p=0.1); the keep-mask kernel at
     a hidden dropout's shape;
 10. the training main path: the JAX package's GPT-2 train bench
     (benchmarks/train_bench.py) on the port: gpt2-small at full width and
     depth (seeded weights, both dropouts 0.1) -> amp.decorate(O2,
     bfloat16) -> AdamW(lr=1e-4, weight_decay=0.01) -> make_train_step,
     fed by DataLoader(prefetch_to_device=2) over the bench's synthetic
     token stream, B=16, T=512: first 2 + 5 steps through the step's
     bodies run eagerly (the step as it ran before it was captured), then
     the captured step, one CUDA graph built at its first call and
     replayed, 3 warm-up and 10 timed steps, the launch and path counters
     zeroed just before and read just after (launches a step, launches
     through replays, capture ms, graph pool); each with a torch.profiler
     breakdown of one step; then, from one saved state, two steps through
     the captured step and two through its eager bodies (twice), at
     dropout 0.1 and on a fresh model at 0: losses, parameters and
     moments bit-equal, the steps' Philox words and masks different, a
     restored RNG state repeating the first;
 11. the same float32 weights with both dropouts 0, B=4, T=512, 3 steps
     through the captured step, once with the kernels and once with
     use_flash_attention and use_fused_optimizer off (which must launch
     nothing): step 1's gradients, per parameter in norm, the losses and
     the parameters must agree within the stated tolerances
     (compare_runs);
 12. the fused dropout-residual(+LN) kernels' device times at path B's
     shape (N=8192, Hd=768, bfloat16) and path A's (N=4096, Hd=768,
     float32), beside their bounds, their plain versions and the composed
     PyTorch route the flag replaces, and the backward's grid and the
     bytes of its partial rows;
 13. path B: phase 10 with FLAGS_use_fused_dropout_ln and FLAGS_fused_block
     on (12 / 12 / 24 launches of the fused forward, no-LN forward and
     backward a step), its step beside phase 10's; then phase 11 with the
     fused flags on in the kernel run;
 14. path A: the JAX package's ERNIE bench (train_bench.py bench_ernie)
     on the port: ernie-base at full width and depth (seeded weights,
     dropouts 0.1), B=32, T=128, AdamW(lr=1e-4, weight_decay=0.01),
     make_train_step with the MLM + NSP criterion, under
     amp.auto_cast(level="O2"), FLAGS_use_fused_dropout_ln on, eager
     bodies, captured step and graph against eager as in 10; then one
     forward in eval mode with a [B, T] padding mask (half of one row
     padded) and use_flash_attention on: every layer takes the plain
     attention (xla_sdpa), no flash kernel launches, and the output is
     bit-equal to the same call with the flag off;
 15. path A's kernels vs plain: float32, no dropout, 3 steps, as in 11;
 16. guards and eval on the training main path (phase 10's model,
     optimizer and loader, built again): (1) captured steps made with
     FLAGS_skip_nonfinite_steps off and on, 3 + 10 steps each (launches
     a step equal to phase 10's), then 20 pairs of steps and 20 pairs of
     the graph's replays alone (CUDA events), one of each way a pair, the
     order flipped every pair: step times and the pairs' differences
     beside phase 10's step, the card's clock and temperature before and
     after, one profiled step each way (the guard's kernels, and the
     device's idle time, off and on);
     (2) the NaN drill,
     PADDLE_TPU_CHAOS=nan_at_step:3 over 5 steps from a saved state
     through the captured graph: the loss NaN at step 3 only, that step
     alone skipped, parameters and both moments after it bit-equal to
     their values after step 2, AdamW launched once every step, and
     steps 4-5 bit-equal to the same drill through the eager bodies; (3)
     the watchdog, step_watchdog_s=0.5 with hang_at_step:2:1.5 (warn):
     the dump names compiled train step 2 and the step finishes finite;
     (4) the OOM drill, oom:2: the call raises, a crash bundle with
     memory.json names jit_train and step 2, pt_oom_total rises by 1,
     and the next call replays with no build; (5) make_eval_step with
     the criterion in eval mode, B=16, T=512: one program, 10 timed
     replays (ms, tokens/s), the loss bit-equal to its eager body, the
     loss and logits held to the eager body with use_flash_attention off
     (the plain attention: 12 xla_sdpa, no flash launch), 12
     flash forward launches a call through replays, no backward or AdamW
     launch, the parameters untouched; (6) the jit_train and jit_eval
     retraces equal the programs built, pt_train_steps_total the steps
     run, and the flight recorder's last dispatch the last step;
 17. resumable training on the GPT-2 configuration: phase 10's model,
     O2 and loader with AdamW(LinearWarmup(CosineAnnealingDecay(1e-4,
     T_max=100), warmup_steps=4), weight_decay=0.01,
     ClipGradByGlobalNorm(1.0)) (`gpt2_recipe`): (a) the captured step,
     3 + 10 steps (one program, launches equal to phase 10's, the clip's
     scale in (0, 1]), its ms beside phase 10's, then the clip's cost as
     20 pairs of steps with an optimizer without the clip on the same
     model, in turns; (b) a sync save (host capture s, total s, bytes),
     one step, an async save (s it blocks, the steps while its write is
     in flight), a load of the sync save into the built step (s; the
     state bit-equal to the saved one) and the step after it bit-equal
     to the step after the save with no new build, the pt_ckpt_*
     counters; (c) the resume drill, each run a fresh process
     (`chip_smoke.py --resume-drill`, `resume_drill`): 3 epochs x 2
     steps in TrainEpochRange uninterrupted, then under
     PADDLE_TPU_CHAOS=sigterm_at_step:3 (exit 0 after epoch 1's save),
     then a relaunch that resumes at epoch 2: its losses and the sha256
     of its final parameters and moments bit-equal to the uninterrupted
     run's, dropout on; (d) bitflip_ckpt:1 on the newer of two saves:
     load_latest quarantines it and falls back (pt_ckpt_corrupt_total
     and pt_ckpt_fallback_total +1), then torn_write in epoch 1's save
     (the run dies by SIGKILL) and a relaunch from epoch 0 whose losses
     and final state equal the uninterrupted run's. Checkpoints go under
     a temporary directory, removed at the end of the phase.
 18. float16, GradScaler and the other optimizers: (a) the float16
     instances of rows 1t, 2, 3, 4-6 and 7 timed at the main path's shapes
     beside their bounds and PyTorch's float16 calls (phase 3 holds each
     against its plain version, and the flash backward under a loss scale
     of 2^15), then phase 10's GPT-2 path in float16 (decorate O2 float16,
     every step under auto_cast(O2, float16)) with the fused flags off and
     as path B: launches a step of the float16 instances only, graph
     against eager at dropout 0.1; (b) the reference's eager GradScaler
     recipe at full width (scale, backward, step, clear_grad; 20 steps,
     GradScaler(init_loss_scaling=2**15), no auto_cast as the recipe runs
     in the reference: a float16 loss): skipped steps, scale history,
     then the overflow drill (scale 2^24: the step skipped, parameters and
     moments bit-equal, the scale halved); (c) ERNIE-base (path A's
     setup) with Lamb(1e-4, lamb_weight_decay=0.01, LayerNorm and biases
     excluded) through the captured step, and 3 steps bit-equal to its
     eager bodies; (d) SGD, Momentum (and Nesterov), Lars, Adamax, Adagrad,
     Adadelta, RMSProp (and centered), Ftrl, DecayedAdagrad, ProximalGD and
     ProximalAdagrad on gpt2-small at 2 layers and full width, B=16, T=512,
     O2 bf16, LinearWarmup over CosineAnnealingDecay: 3 captured steps
     bit-equal to their eager bodies and a nan_at_step:2 drill under
     FLAGS_skip_nonfinite_steps (the state bit-equal across the skipped
     step); Dpsgd 3 eager steps, and make_train_step refusing it.
 19. ResNet-50 (`resnet_main`), the JAX package's bench_resnet50 at its
     on-chip shapes (train_bench.py:317-388) through the dygraph step:
     resnet50(num_classes=100), seeded weights, Momentum(0.01, 0.9),
     make_train_step, the batch RandomState(0) rand(B, 3, 224, 224) and
     randint(0, 100, (B, 1)). (a) float32, B=8, 3 steps from one state
     (parameters, velocities, running statistics, step count) through the
     captured step and twice through its eager bodies: losses,
     parameters, velocities and running statistics bit-equal; if the two
     eager runs or the graph differ, the check is made again with
     torch.backends.cudnn.deterministic on (cuDNN's weight-gradient
     algorithms may sum with atomics), and the run says so; (b) B=64 under
     auto_cast(level="O1", dtype="bfloat16") (the bench's amp_bf16_pass),
     3 warm-up and 20 timed steps of the captured step: step ms, images/s,
     MFU (3 x 4.1e9 x B FLOPs a step, train_bench.py:379-381), peak
     memory, one profiled step's device idle share and its groups
     (cuDNN convolutions, pooling, batch norm's reductions, elementwise),
     the Momentum update's device time alone (a graph replay); every
     parameter, velocity and running statistic float32; none of the
     port's kernels launched (the reference reaches no pl.pallas_call on
     this path); (c) the guard drill, FLAGS_skip_nonfinite_steps with
     nan_at_step:2 at B=16: step 2 skipped, parameters, velocities and
     every running statistic after it bit-equal to their values before
     it, step 3 moving them; (d) make_eval_step in eval() mode on the
     trained network: one program, replays timed, the loss and logits
     held to the eager eval forward, no running statistic written.
 20. Model.fit (`fit_main`), the hapi loop over the port's train step:
     (a) GPT-2-small at full width and depth, phase 10's setup with
     AdamW over LinearWarmup(1e-4, 4 steps), through
     `Model(net).prepare(opt, criterion).fit(TokenPairs, batch_size=16,
     shuffle=False, num_workers=2, num_iters=13, telemetry_dir=...,
     callbacks=[LRScheduler(by_step=True)])`: the first 13 batches of 2
     worker processes (spawned: CUDA is up) bit-equal to num_workers=0's
     and pinned; one program, launches a step equal to phase 10's (rows
     1t, 2, 3 12 each, row 7 1, row K 25), all through replays; the
     per-step losses bit-equal to a make_train_step loop over the same
     batches from the same seed; `tools/ptdoctor.py summary` over the
     telemetry directory showing `retraces: jit_train=1` and the last
     step; fit's step (host clock between batch ends, median of the last
     10) beside the loop's and phase 10's, pt_feed_stall_ms at 2 workers
     and at 0, one profiled fit step's device idle share; (b) the
     preemption drill in fresh processes (`--fit-drill`): GPT-2 cut to 2
     layers at full width, 2 epochs x 4 steps with auto_checkpoint_dir,
     SIGTERM (chaos sigterm_at_step:5) mid-epoch -> rc 0 and a committed
     preempt_ckpt; the relaunch resumes at epoch 1 step 2 and its losses
     and the sha256 of its parameters and AdamW moments are bit-equal to
     an uninterrupted fit's, dropout on; preempt_ckpt gone after; (c)
     ResNet-50 (phase 19's setup, auto_cast O1 bf16) through fit over a
     map-style set (`ImageSet`: sample i is RandomState(i)'s image) with
     4 workers (38.5 MB a batch through shared memory) and
     Accuracy(topk=(1, 5)), 3 + 20 steps: each step's top-1/top-5 equal
     to the stable rank of its labels among its logits; `evaluate` over 4
     batches equal to the eager eval forward, no running statistic
     written; `predict` over 2 batches equal to the eager logits;
     images/s beside phase 19's and the feed stall; (d) bench.py's
     bench_lenet_fit (LeNet, Adam(1e-3), CrossEntropyLoss, MNIST with
     PADDLE_TPU_SYNTH_SAMPLES=8192, B=256, 2 + 50 train_batch calls):
     images/s; then a one-epoch fit with Accuracy and ModelCheckpoint,
     and Model.load of its final.pdparams/.pdopt into a fresh Model: an
     evaluate bit-equal to the trained one's. (d) is bench.py's body as
     written against `import paddle_tpu_torch as paddle` (paddle.seed,
     paddle.Model, paddle.optimizer.Adam, paddle.nn.CrossEntropyLoss);
     after its timed loop two more builds after paddle.seed(0) give
     bit-equal losses (under cuDNN's deterministic algorithms);
 21. GPT-2 long context (`long_main`, `--long-only`): (a) one layer's
     attention at the long-context shape (B=1, H=12, T=8192, D=64,
     bfloat16, causal): the flash forward and backward against their
     plain versions at p=0 and p=0.1 under one Philox word (relative
     1e-2, as phase 3 at T=512), then their device times beside their
     bounds, their plain versions' and torch sdpa's forward and backward;
     (b) benchmarks/train_bench.py bench_gpt2_long as written against
     `import paddle_tpu_torch as paddle`: gpt2_small(
     max_position_embeddings=8193), dropouts 0.1, paddle.seed(0),
     paddle.to_tensor(ids), paddle.optimizer.AdamW(1e-4, wd 0.01),
     paddle.amp.decorate(O2, bfloat16), make_train_step, 2 warm-up and 10
     timed steps and float(loss.numpy()): one program, launches a step
     (rows 1t, 2, 3 12 each, row 7 1, row K 25) through replays, path
     flash_dropout, finite losses; step ms (median), tokens/s, MFU by
     train_bench.py:139's formula, peak memory, one profiled step's idle
     share and kernel groups; (c) the same model at dropout 0, 3 steps
     from seed 0's weights and (b)'s batch, with the flash kernels and
     with use_flash_attention off, FLAGS_sdpa_chunked_threshold at its
     2048: the second run's attention all xla_chunked (the blockwise
     online-softmax tier, ops/ring_attention.py), no flash launch, losses
     within 2e-2 relative of the first's; both runs' step ms and peak
     memory. The dense attention is never run at T=8192 (its saved
     probabilities alone would take tens of GB).
 22. the static graph and the predictor (`static_main`, `--static-only`):
     (a) the flash forward at the BERT predictors' attention (B=8,
     H=12, T=128, D=64, not causal), row 1's float32 instance and the
     bfloat16 one (row 1t's body without lse), each against its plain
     version (phase 3's tolerance for its dtype), its device time beside
     its bound, its plain version's and torch sdpa's forward; (b) benchmarks/train_bench.py
     bench_resnet50's static body as written against `import
     paddle_tpu_torch as paddle` (static.data, resnet50(num_classes=100),
     cross_entropy, Momentum(0.01, 0.9).minimize, amp_bf16_pass,
     static.Executor, B=64 224x224, 3 warm-up runs and 20 timed with
     return_numpy=False, one float(lv.numpy())): first the program's 3
     steps from one saved state through its captured program and twice
     interpreted eagerly, bit-equal (cudnn.deterministic on for that
     check); then the timed run: one program for the feed signature,
     replayed, finite losses, the running statistics moved, no kernel of
     the port launched; step ms, images/s, MFU by :379-381, peak memory,
     one profiled run's idle share and kernel groups; (c)
     inference_bench.py bench_resnet50 (:82, B=8 and 64 at 224x224) and
     bench_bert (:114, bert-base, B=8, T=128) as written (`_export`
     through save_inference_model and its fusion passes, Config,
     create_predictor, `_serve_loop`'s 3 + 20 runs): one program a
     signature, replayed; each output within INFER_REL_TOL of the same
     model's dygraph eval forward on the card (BERT also with
     use_flash_attention off); BERT launches row 1 12 times a run, through
     replays, every attention call on path flash; latency and
     images/s or tokens/s; each predictor's graph pool; (d) BERT's artifact through
     Config.enable_mkldnn_bfloat16(): the bfloat16 flash forward's 12
     launches a run, output within INFER_BF16_REL_TOL of (c)'s.

 23. the encoder-decoder Transformer (`nmt_main`, `--seq2seq-only`),
     Transformer-base (Vaswani et al. 2017, Table 3: nn.Transformer's
     defaults, d 512, 8 heads, 6 + 6 layers, FFN 2048) over a shared
     37000-token vocabulary (`seq2seq_model`: a shared Embedding with
     padding_idx 0 and a ParamAttr initializer, scaled by sqrt(512), the
     sinusoidal table, the tied output projection), use_fused_dropout_ln
     on: (a) the kernels at its shapes, each against its plain version at
     phase 3's tolerances and timed as phase 4 times (bound, plain, torch
     sdpa or the composed route): rows 1t, 2, 3 at B=32, H=8, D=64, bf16,
     not causal, the encoder's 256 x 256 and the cross-attention's 200
     queries against 256 keys (Tq != Tk), p 0.1 and 0; row 1b at one
     query against 1, 32 and 64 cached keys and the 256 of the
     cross-attention; rows 4-6 at Hd=512, N=8192 and 6400, p=0.1; row K
     at [32, 256, 2048]; (b) training: B=32 pairs of 256 source and 200
     target tokens (synthetic ids, no padding), dropout 0.1, label
     smoothing 0.1 (label_smooth(one_hot) and soft-label cross_entropy),
     amp.decorate O2 bf16, Adam(0.9, 0.98, 1e-9) under NoamDecay(512,
     4000), make_train_step (one CUDA graph), 3 + 20 steps with the
     counters zeroed just before and read just after: 12 / 12 / 12 / 30 /
     30 / 20 launches a step of rows 1t, 2, 3, 4, 6, K and Adam's one a
     parameter, attention paths flash_dropout (encoder, cross) and
     xla_sdpa (the decoder's masked self-attention); step ms, tokens/s
     (source + target), MFU from the shapes (`nmt_flops`), peak memory,
     the graph pool, a profiled step's idle share and kernel groups; the
     captured step against its eager bodies over 3 steps from one state
     (bit-equal), row 7 at the model's 253 parameters; then float32 at p
     0, 2 captured steps with the kernels and with their flags off:
     step 1's gradients within 1e-3 of each parameter's norm, the losses
     and, outside the elements with a near-zero first gradient, the
     parameters within 1e-4; (c) cached greedy decoding, eval, B=32
     sources of 256 tokens: the encoder once, decoder.gen_cache(memory),
     64 steps of one token (12 flash launches a step, row 1b), ms a
     token; the tokens against a decode that runs the whole prefix every
     step under the causal mask (equal, or first differing where that
     decode's top-2 float32 logits are within NMT_TIE = 1e-2); (d) the
     encoder's weights
     through `fused_encoder` (fused_multi_head_attention and
     fused_feedforward, q/k/v packed by models.pack_qkv), bf16, p 0,
     post-LN against the encoder and pre-LN against a pre-LN
     nn.TransformerEncoder of the same weights (row 5), within 2e-2; a
     forward + backward launches rows 1t, 2, 3 and, post-LN, 4 and 6.

 24. the recurrent family (`rnn_main`, `--rnn-only`), float32 with TF32
     off: (a) the port's LSTM(1500, 1500, 2) at B=20, T=35 and a 2-layer
     bidirectional GRU(512, 512) at B=64, T=128 with lengths drawn in
     [16, 128] against torch.nn.LSTM / GRU (cuDNN; over
     pack_padded_sequence for the lengths) with the same weights: y and
     the final states within RNN_FWD_REL_TOL of each output's largest
     |value|, each parameter's gradient within RNN_GRAD_REL_TOL of its
     norm; BiRNN(GRUCell, GRUCell) against the fused GRU; the port's
     forward and forward + backward timed eagerly and replayed from a CUDA
     graph, cuDNN's eagerly, beside their FLOP bound at 67 TFLOP/s; (b) Zaremba et al.'s large LSTM language model
     (`ptb_model`: vocab 10000, 2 x 1500, B=20, T=35, dropout 0.65,
     Uniform(-0.04, 0.04)) trained by SGD(1.0) under
     ClipGradByGlobalNorm(10) through make_train_step (one CUDA graph),
     the states carried from step to step, 3 + 20 steps with the counters
     zeroed just before and read just after: 3 keep-mask launches a step
     (after the embedding, between the layers, before the projection) and
     no other kernel; step ms, tokens/s, MFU from the shapes
     (`ptb_flops`), peak memory, the graph pool, a profiled step; the
     captured step bit-equal to its eager bodies over 3 steps; at p 0,
     step 1 against the same model with torch.nn.LSTM: losses within
     1e-4, gradients within TRAIN_GRAD_TOL of each norm; (c) the model
     under amp.decorate O2 bfloat16: 3 + 20 captured steps, every loss
     finite, and at p 0 the first loss and the logits within
     PTB_BF16_LOSS_TOL of (b)'s.

 25. the tensor-op surface and GPT-2-small-MoE (`moe_main`, `--moe-only`):
     (a) every op the port registers from the reference's ops/math.py,
     manipulation.py, creation.py and linalg.py run on CUDA tensors
     against the same op on CPU tensors (the tier-1 tests hold the CPU
     path against the reference), forward and, where it is
     differentiable, the input gradients under one cotangent: within
     1e-5 of the largest |value| for one-element-in-one-out ops, 1e-4 for
     reductions, products and linear algebra (factorizations by
     reconstruction), integers exact; the random ops by shape, dtype,
     range, one seed's repeat and the moments of 1e6 draws within 5
     sigma; (b) GPT-2-small with an MoELayer (8 experts, top-2, capacity
     factor 1.25) in every other block (GShard's layout), B=16, T=512,
     dropouts 0.1, O2 bf16, AdamW, the criterion + 0.01 x moe_aux_loss(),
     through run_path (eager bodies, then the captured step with the
     counters zeroed just before and read just after: 12 launches a step
     of rows 1t, 2, 3, 1 of row 7, 25 of row K), step ms, tokens/s,
     MFU from the shapes (`moe_flops`, the dispatch and combine einsums
     at capacity included) with the expert FFNs' share, peak memory,
     graph pool, idle, the tokens over capacity by block, l_aux read
     after the captured steps; the captured step bit-equal to its eager
     bodies over 3 steps; row 7 timed at this path's parameters; (c) the
     configuration in float32 at B=4 and 4 blocks, kernels against plain
     through compare_runs, every token's experts the same in both runs
     but at near ties (within 1e-5, counted), and a planted fault (second
     choices placed without the first choices' count) refused.
 26. the rest of nn and the improved-DDPM CIFAR-10 UNet (`unet_main`,
     `--unet-only`): (a) row K bit-equal to its plain mask at each
     ResBlock dropout's shape at p 0.3; the slice's functions and
     layers (transposed
     convolutions, group, instance and local-response norms, the pools,
     interpolate in every mode, grid sampling, shuffles, unfold, pads,
     CTC and the losses, sparse attention, the sequence ops) on CUDA
     tensors against the same calls on CPU tensors, forward and input
     (and parameter) gradients, TF32 off, within NN_TOL; the dropouts by
     their draws; a step resampling through weights built on the card
     (bilinear, bicubic, align_corners, trilinear, an affine grid)
     captured and bit-equal to its eager bodies; the static calls
     repaired in this slice through
     static.Executor on the card against their eager results; (b) the
     UNet at full width (52,542,979 parameters in 446 tensors), B=128,
     O1 bf16, dropout 0.3, AdamW(1e-4, weight_decay 0), L_simple on
     x_t drawn outside the step, through run_path (15 launches a step of
     rows 1t, 2 and 3, 1 of row 7, 30 of row K), step ms, images/s,
     MFU from the shapes (`unet_flops`: 6.438 TFLOP a step), peak
     memory, graph pool, idle, the profile's groups; the captured step
     bit-equal to its eager bodies over 3 steps; rows 1t, 2, 3 at the
     UNet's three attention shapes, row K at its first dropout, row 7 at
     its float32 parameters; (c) the UNet at reduced depth in float32,
     kernels against plain through compare_runs, and a planted fault (a
     group norm whose variance is taken over the channels only)
     refused.
 27. row-sparse gradients, the legacy op surface and DLRM (`dlrm_main`,
     `--dlrm-only`): (a) the slice's 48 registered ops (ops/misc_ops.py,
     lookup_table_v2_sparse, fft, frame, overlap_add), stft / istft, the
     distributions, fluid.layers over the new ops and static.gradients on
     CUDA tensors against the CPU, forward and gradients, TF32 off,
     within OPS_TOL, hash_op and viterbi_decode_op bit-equal,
     shuffle_batch's and nce's bodies on the CPU's draws; (b) DLRM at the
     Criteo Kaggle tables' full 33,762,577 rows (dlrm_s_criteo_kaggle.sh:
     26 tables of 16, bottom MLP 13-512-256-64-16, top 367-512-256-1,
     B=128, float32) on synthetic power-law batches: (b1) SGD(0.1)
     eagerly with row-sparse table gradients (one step against the dense
     step within 1e-6, untouched rows bit-identical after 60 steps),
     (b2) Adam(lazy_mode=True, 1e-3) eagerly (untouched rows bit-identical
     in the parameter and both moments; the MLP through row 7, one launch
     a step, counted with the counters zeroed just before and read just
     after), (b3) the tables dense through make_train_step (one CUDA
     graph); each its step ms, samples/s, peak memory, the profiled
     step's groups and the device's idle share; (c) DLRM at 4 small
     tables on the card against its CPU run, 3 steps each of SGD, lazy
     Adam and lazy AdamW, within 1e-5.

The line before the last is the kernel table as JSON (the float16
instances under their names + "_f16"; rows 1t, 2, 3 with their times at
phase 21's shape under "long_context"; the launches of phase 21 (b)
counted in with phase 10's; row 1 at phase 22's BERT shape under
"static_bert", the float32 BERT predictor's launches counted in with the
serving paths'; the bfloat16 instance as "flash_fwd_bf16", its launches
those of the bfloat16 BERT predictor and phase 23 (c)'s decoding, its
times there under "nmt_decode"; rows 1t, 2, 3, 4-7 and K with phase
23 (a)'s entries under "nmt", and phase 23 (b)'s launches counted in;
row K's launches of phase 24 (b) counted in, its time at that shape
under "ptb"; rows 1t, 2, 3, 7 and K's launches of phase 25 (b) counted
in, row 7's time at its parameters under "moe"; rows 1t, 2, 3, 7 and K's
launches of phase 26 (b) counted in, their times at the UNet's shapes
under "unet"; row 7's launches of phase 27 (b2) counted in, under
"dlrm"); the last line is {"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# tolerances of the kernel-vs-plain checks (max abs error)
TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 1e-4,
    # one bfloat16 rounding of outputs of magnitude up to ~3 (one ulp at
    # |o| in [2, 4) is 0.0156; at |o| >= 4 it is 0.031, which fails)
    "bfloat16": 2e-2,
    # float16 rounds 8 times finer; held to bfloat16's bound all the same
    "float16": 2e-2,
}
# greedy tokens may first differ only where the plain run's top-2 logit
# gap is below this: a near tie that summation order can flip. int8 adds
# the chance that a K/V element rounds to the other int8 neighbour.
TIE_TOL = {"float32": 1e-3, "int8": 1e-2}

# NVIDIA H100 SXM data-sheet peaks (dense), as the bound's denominators.
# int32: instructions a second, from the float32 rate: 67 TFLOP/s counts
# an FMA as 2 operations on 128 float32 lanes an SM a clock, and an SM of
# compute capability 9.0 has 64 int32 lanes a clock (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "int32": 67e12 / 2 / 2}
SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
# int32 operations a lane makes in one Philox-4x32-10 call
# (attn_dropout.cuh), as nvcc compiles it for sm_90a (cuobjdump -sass of
# fdrln_bits_kernel<true>): a round is two IMAD.WIDE.U32, each a low and a
# high 32-bit product (4), and two LOP3 three-way XORs (2). The key
# schedule runs once a warp on the uniform datapath (UIADD3) and is not
# counted, nor are indexing and the stores.
PHILOX_INT_OPS = 10 * 6

# training-kernel checks, max abs error relative to the largest |value| of
# the plain version's output (at least 1):
REL_TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 2e-4,
    # bfloat16 outputs, rounded once on each side: a float32 difference
    # under one bfloat16 ulp of the largest value (2^-8 to 2^-7 of it)
    # shows as at most that one ulp, which this passes and two fail. The
    # tensor-core flash backward keeps its difference far below that by
    # taking M o p (P without dropout) and dS as bfloat16 hi + lo pairs;
    # the tensor-core forward rounds P once to bfloat16 for P V, about
    # 1e-3 of the largest output, under a quarter of this (the CPU mirrors
    # tests/test_torch_flash_bwd.py and test_torch_flash_fwd.py; the
    # latter also holds check_flash's bfloat16 cases to TOL)
    "bfloat16": 1e-2,
    # float16 outputs: one rounding is 2^-11, four times finer than
    # bfloat16's; held to bfloat16's tolerance, the reading printed beside
    # it
    "float16": 1e-2,
}
# the float16 backward under a loss scale: dO times this (GradScaler's
# default init_loss_scaling) must give finite dq, dk and dv wherever the
# plain float32 arithmetic rounds to a finite float16
LOSS_SCALE = 2.0 ** 15
# AdamW: the kernel rounds every operation on its own, as the plain rule
# does (no FMA contraction), so the parameter must be bit-equal; each
# moment element may differ from the plain one by at most this share of
# its size (one float32 ulp)
ADAMW_MOMENT_REL_TOL = 2 ** -23
# the bfloat16 cases at lr 1e-2 on parameters of size ~1e-2 must move at
# least this share of the elements, or the bit-equality shows nothing
ADAMW_MOVED_MIN = 0.9
# the clip scale the row-7 checks stage in the buffer's fifth word
ADAMW_CHECK_SCALE = 0.3711
# train_compare: max parameter difference after 3 float32 steps at lr
# 1e-4, between a sound reading (~1e-5: float32 sums in another order,
# amplified by Adam's normalised step) and the whole 3-step movement
# (~3e-4), which a run that skipped its updates would show
TRAIN_PARAM_TOL = 1e-4
TRAIN_LR = 1e-4
# compare_runs: each parameter's first-step gradient (both runs start from
# the same weights on the same batch) within this share of its norm in the
# plain run. On an H100, float32 sums in another order read ~1.2e-6
# (GPT-2), up to 7.1e-4 where the gradient is a sum that cancels (ERNIE's
# top query and key projections at init); a ReLU whose input rounds to the
# other side of 0 in one run adds one token's term (Transformer-base: up
# to 5.3e-4). A dK scaled by 1.002 reads 2.1e-3 on the key projections,
# by 1.01 0.01, dropped 1, dK and dV swapped 300
TRAIN_GRAD_TOL = 1e-3
# ... or of this share of the whole model's gradient norm, where the
# parameter's own is below it: a gradient that is 0 in exact arithmetic
# (the key projections' biases: softmax ignores a constant added to a row
# of scores) is rounding noise in both runs, ~1e-10 of the model's
TRAIN_GRAD_FLOOR = 1e-6
DROP_RATE_TOL = 0.002
# fused dropout-LN checks with bfloat16 outputs: one bfloat16 rounding of
# y, z and the gradients (2^-8 relative), plus the float32 differences
# that flip it, relative to the largest value (at least 1); float32
# outputs are held to 1e-4 the same way
FDRLN_BF16_REL_TOL = 2e-2
FDRLN_F32_REL_TOL = 1e-4

TPU_KERNELS = {
    "flash_fwd": "paddle_tpu/ops/pallas_kernels.py:324",
    "flash_fwd_train": "paddle_tpu/ops/pallas_kernels.py:324",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_kernels.py:462",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_kernels.py:524",
    "fused_dropout_ln_fwd": "paddle_tpu/ops/pallas_kernels.py:768",
    "fused_dropout_residual_fwd": "paddle_tpu/ops/pallas_kernels.py:792",
    "fused_dropout_ln_bwd": "paddle_tpu/ops/pallas_kernels.py:800",
    "adamw": "paddle_tpu/ops/pallas_kernels.py:1044",
    # no TPU kernel: the reference draws a dropout's mask with jax.random
    "dropout_keep": "paddle_tpu/ops/nn_ops.py:577",
    "paged_decode": "paddle_tpu/ops/pallas_kernels.py:1738",
    "paged_decode_int8": "paddle_tpu/ops/pallas_kernels.py:1746",
}
SOURCES = {
    "flash_fwd": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_fwd_train": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_bwd_dq": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
    "fused_dropout_ln_fwd": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "fused_dropout_residual_fwd":
        "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "fused_dropout_ln_bwd": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "adamw": "paddle_tpu_torch/ops/csrc/adamw.cu",
    "dropout_keep": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "paged_decode": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
    "paged_decode_int8": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
}
KERNEL_ORDER = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
                "flash_bwd_dkv", "fused_dropout_ln_fwd",
                "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw",
                "dropout_keep", "paged_decode", "paged_decode_int8")
FUSED_KERNELS = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
                 "fused_dropout_ln_bwd")
# the training kernels' float16 instances, counted apart from the others
# (cuda_kernels.F16), each in the kernels line under its own name
F16_ORDER = tuple(n + "_f16" for n in (
    "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv", "fused_dropout_ln_fwd",
    "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw"))

# the training main path: the JAX package's GPT-2 train bench
TRAIN_B, TRAIN_T, TRAIN_WARMUP, TRAIN_STEPS = 16, 512, 3, 10
# the same paths' step bodies run eagerly, for the step as it ran before
# it was captured
EAGER_WARMUP, EAGER_STEPS = 2, 5
# the ERNIE-base pretraining path: the JAX package's ERNIE bench
ERNIE_B, ERNIE_T = 32, 128
# the serving main path's prefill buckets (GenerationEngine's
# prefill_buckets), each a query length of the flash forward
BUCKETS = (32, 128, 256)
DROPOUT = 0.1
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7       # kernel checks' dropout key
# ... which the kernels read from a Philox word on the card holding (SEED,
# OFFSET - DELTA), with the call's delta DELTA (made in main)
DELTA = 3
WORD = None

VOCAB_TOKENS = 50257          # GPT-2's tokenizer; the table is padded


def say(*parts):
    print(*parts, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit("chip_smoke FAILED: " + msg)


def ptxas_registers(logs, needles):
    """(source, kernel entry, registers, spill line) from nvcc's -Xptxas -v
    output, for the entries whose mangled name holds one of `needles`."""
    out = []
    for name, log in sorted(logs.items()):
        entry = spill = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry, spill = m.group(1), None
            elif "spill stores" in line:
                spill = line.strip()
            else:
                m = re.search(r"Used (\d+) registers", line)
                if m and entry and any(n in entry for n in needles):
                    out.append((name, entry, int(m.group(1)), spill))
                    entry = None
    return out


# ---------------------------------------------------------------------------
# timing


class Timer:
    """Device time of a callable: each run queues `reps` calls behind a
    sleep kernel long enough to cover their enqueue, so the launches run
    back to back and the events measure the device, not the host."""

    def __init__(self, torch):
        self.torch = torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def ms(self, fn, runs=25, reps=10):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        cycles = int(self.cycles_per_ms * (2.0 * host_ms + 0.5))
        out = []
        for _ in range(runs):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / reps)
        return statistics.median(out)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel checks


def qkv_views(torch, B, T, H, D, dtype, gen):
    """q, k, v [B, H, T, D] as the model hands them over: views of one
    fused qkv tensor [B, T, 3, H, D]."""
    qkv = torch.randn((B, T, 3, H, D), generator=gen, device="cuda")
    return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)


def check_flash(torch, ck, gen):
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    cases = [(1, T, T, 12, 64, True) for T in (32, 128, 256)] + [
        (2, 40, 40, 12, 64, True),           # ragged edge
        (1, 16, 48, 4, 64, True),            # bottom-right causal, Tq < Tk
        (1, 100, 100, 4, 64, False),
        (1, 64, 64, 2, 128, True),           # widest head the kernel takes
        (1, 33, 33, 2, 24, True)]            # head_dim not a multiple of 32
    # the training main path's attention, which make_eval_step's forward
    # (phase 16) sends through this wrapper: gpt2-small in bfloat16
    train_case = (TRAIN_B, TRAIN_T, TRAIN_T, 12, 64, True)
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for B, Tq, Tk, H, D, causal in cases + (
                [train_case] if dtype_name != "float32" else []):
            q, _, _ = qkv_views(torch, B, Tq, H, D, dtype, gen)
            _, k, v = qkv_views(torch, B, Tk, H, D, dtype, gen)
            got = ck.flash_attention(q, k, v, causal)
            want = ck.flash_attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dtype and got.shape == want.shape,
                    "flash_fwd output type or shape")
            require(err <= TOL[dtype_name],
                    "flash_fwd %s B=%d Tq=%d Tk=%d H=%d D=%d causal=%s: "
                    "max abs err %.3g > %.3g" % (dtype_name, B, Tq, Tk, H,
                                                 D, causal, err,
                                                 TOL[dtype_name]))
            worst[dtype_name] = max(worst[dtype_name], err)
    for name, err in worst.items():
        say("check flash_fwd %s: max abs err %.3g (tol %.0e) over %d cases%s"
            % (name, err, TOL[name], len(cases) + (name != "float32"),
               ", one at B=%d T=%d H=12 D=64 causal" % (TRAIN_B, TRAIN_T)
               if name != "float32" else ""))
    return worst["float32"]


def abs_rel_err(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def rel_err(got, want, floor):
    """max |got - want| over max(floor, max |want|): floor 1 for values of
    order one, 0 for the array's own scale. numpy arrays or tensors."""
    got, want = (np.asarray(a.detach().double().cpu()) if hasattr(a, "detach")
                 else np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max()
                 / max(floor, np.abs(want).max(), 1e-30))


def graph_of(torch, fn, warmups=2):
    """`fn` captured in a CUDA graph, warmed up `warmups` times on a side
    stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmups):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def check_dropout_bits(torch, ck):
    """The kernel's bits equal the plain Philox bit for bit, and drop at
    rate p at the main path's shapes."""
    for BH, Tq, Tk in ((6, 37, 50), (2, 4, 1)):
        got = ck.attn_dropout_bits(WORD, DELTA, BH, Tq, Tk)
        want = ck.attn_dropout_bits_plain(SEED, OFFSET, BH, Tq, Tk,
                                          device="cuda")
        require(torch.equal(got, want), "attn_dropout_bits %s differ from "
                "the plain Philox" % ((BH, Tq, Tk),))
    bits = ck.attn_dropout_bits(WORD, DELTA, TRAIN_B * 12, TRAIN_T, TRAIN_T)
    thr = min(int(DROPOUT * 2 ** 32), 2 ** 32 - 1)
    rate = (bits < thr).double().mean().item()
    require(abs(rate - DROPOUT) <= DROP_RATE_TOL,
            "dropout rate %.5f, want %.3f +- %.3f" % (rate, DROPOUT,
                                                       DROP_RATE_TOL))
    say("check attn_dropout_bits: bit-equal to the plain Philox; drop rate "
        "%.5f at [%d, %d, %d] (want %.3f +- %.3f)"
        % (rate, TRAIN_B * 12, TRAIN_T, TRAIN_T, DROPOUT, DROP_RATE_TOL))


def check_flash_train(torch, ck, gen):
    """Training forward (o, lse) and backward (dq, dk, dv) against the
    plain versions fed the kernels' own dropout bits; the backward plain
    versions take the kernel's o and lse, so each kernel is held alone.
    The float16 instances (names + ck.F16) at every case the bfloat16 ones
    take."""
    names = ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")
    names += tuple(n + ck.F16 for n in names)
    worst = {n: 0.0 for n in names}            # relative, for the checks
    worst_abs = {n: 0.0 for n in names}        # absolute, for the table
    worst_at = {n: "" for n in names}          # the case of the worst
    count = {n: 0 for n in names}
    cases = [(2, 64, 64, 4, 64, True),
             (1, 200, 200, 2, 64, True),          # ragged T
             (1, 48, 96, 2, 64, True),            # bottom-right, Tq < Tk
             (1, 100, 100, 2, 64, False),
             (1, 64, 64, 2, 128, True),           # widest head
             (1, 33, 33, 2, 24, True),            # D not a multiple of 32
             (2, 512, 512, 2, 64, True)]          # main path's T
    runs = [(dn, dt, c, p) for dn, dt in (("float32", torch.float32),
                                          ("bfloat16", torch.bfloat16))
            for c in cases for p in (0.0, DROPOUT)]
    # bfloat16 only (the tensor-core kernels): GPT-2's and ERNIE's
    # attention as their training steps launch it, and a head dim that is
    # not a multiple of 8 (rows not 16-byte aligned: the kernels' element
    # loads and stores)
    runs += [("bfloat16", torch.bfloat16, (TRAIN_B, TRAIN_T, TRAIN_T, 12, 64,
                                           True), DROPOUT),
             ("bfloat16", torch.bfloat16, (ERNIE_B, ERNIE_T, ERNIE_T, 12, 64,
                                           False), DROPOUT)]
    runs += [("bfloat16", torch.bfloat16, (1, 72, 72, 2, 20, True), p)
             for p in (0.0, DROPOUT)]
    runs += [("float16", torch.float16) + r[2:] for r in runs
             if r[0] == "bfloat16"]
    for dtype_name, dtype, (B, Tq, Tk, H, D, causal), p in runs:
        sfx = ck.F16 if dtype == torch.float16 else ""
        tol = REL_TOL[dtype_name]
        q, _, _ = qkv_views(torch, B, Tq, H, D, dtype, gen)
        _, k, v = qkv_views(torch, B, Tk, H, D, dtype, gen)
        do = torch.randn((B, H, Tq, D), generator=gen,
                         device="cuda").to(dtype)
        bits = (ck.attn_dropout_bits(WORD, DELTA, B * H, Tq, Tk)
                if p else None)
        o, lse = ck.flash_fwd_train(q, k, v, causal, p, WORD, DELTA)
        dq, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD,
                                    DELTA)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, WORD,
                                  DELTA)
        o_ref, lse_ref = ck.flash_fwd_train_plain(q, k, v, causal, p, bits)
        dq_ref, delta_ref = ck.flash_bwd_dq_plain(q, k, v, o, do, lse,
                                                  causal, p, bits)
        dk_ref, dv_ref = ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta_ref,
                                                causal, p, bits)
        torch.cuda.synchronize()
        pairs = {"flash_fwd_train" + sfx: ((o, o_ref), (lse, lse_ref)),
                 "flash_bwd_dq" + sfx: ((dq, dq_ref), (delta, delta_ref)),
                 "flash_bwd_dkv" + sfx: ((dk, dk_ref), (dv, dv_ref))}
        for t in (o, dq, dk, dv):
            require(t.dtype == dtype
                    and bool(torch.isfinite(t.float()).all()),
                    "flash training kernels: non-finite or wrong type")
        for name, outs in pairs.items():
            ea, er = (max(x) for x in zip(*(abs_rel_err(g, w)
                                            for g, w in outs)))
            case = "%s B=%d Tq=%d Tk=%d H=%d D=%d causal=%s p=%g" % (
                dtype_name, B, Tq, Tk, H, D, causal, p)
            require(er <= tol, "%s %s: rel err %.3g > %.3g"
                    % (name, case, er, tol))
            if er > worst[name] or not worst_at[name]:
                worst[name], worst_at[name] = er, case
            worst_abs[name] = max(worst_abs[name], ea)
            count[name] += 1
    for name, err in worst.items():
        say("check %s: max rel err %.3g at %s (tol f32 %.0e, bf16 %.0e, "
            "f16 %.0e), max abs err %.3g, over %d cases, p in {0, %g}"
            % (name, err, worst_at[name], REL_TOL["float32"],
               REL_TOL["bfloat16"], REL_TOL["float16"], worst_abs[name],
               count[name], DROPOUT))
    return worst_abs


def check_flash_f16_range(torch, ck, gen):
    """The float16 flash backward under a loss scale: dO of a GradScaler
    step (LOSS_SCALE times a gradient of unit size, clamped to float16's
    range, which is all dO can hold) against values of size ~4, so that
    dS = p (dP - Delta) / 8 reaches past float16's 65504 in some rows: the
    kernels' per-row power-of-two scaling of dS must absorb it. The main
    path's T and head size, causal, p in {0, 0.1}. Where the plain
    version's float32 dq, dk and dv round to finite float16 values, the
    kernels' must be finite and within REL_TOL["float16"] of them
    (relative to the largest finite value); where the plain version
    overflows float16, so may the kernels. Prints the largest |dS| of the
    plain arithmetic and how many of its elements pass 65504."""
    B, H, T, D = 2, 4, TRAIN_T, 64
    dt = torch.float16
    worst, ds_max, n_big, n_fin = 0.0, 0.0, 0, 0
    for p in (0.0, DROPOUT):
        q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
        v = (v.float() * 4.0).to(dt)
        do = (torch.randn((B, H, T, D), generator=gen, device="cuda")
              * LOSS_SCALE).clamp(-60000, 60000).to(dt)
        bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
        o, lse = ck.flash_fwd_train(q, k, v, True, p, WORD, DELTA)
        dq, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, True, p, WORD,
                                    DELTA)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, delta, True, p, WORD,
                                  DELTA)
        dq_ref, delta_ref = ck.flash_bwd_dq_plain(q, k, v, o, do, lse, True,
                                                  p, bits)
        dk_ref, dv_ref = ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta_ref,
                                                True, p, bits)
        pr, _, dpr = ck._bwd_terms(q, k, v, do, lse, True, p, bits)
        ds = (pr * (dpr - delta_ref.reshape(B, H, T, 1)) * (D ** -0.5)).abs()
        ds_max = max(ds_max, ds.max().item())
        n_big += int((ds > 65504).sum().item())
        del pr, dpr, ds
        torch.cuda.synchronize()
        for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref)):
            fin = torch.isfinite(want.float())
            require(bool(torch.isfinite(got.float())[fin].all()),
                    "flash backward f16 under a loss scale of %g, p=%g: %s "
                    "non-finite where the plain version is finite"
                    % (LOSS_SCALE, p, name))
            w = want.float()[fin]
            err = (got.float()[fin] - w).abs().max().item() / max(
                1.0, w.abs().max().item())
            require(err <= REL_TOL["float16"], "flash backward f16 under a "
                    "loss scale, p=%g: %s rel err %.3g > %.3g"
                    % (p, name, err, REL_TOL["float16"]))
            worst = max(worst, err)
            n_fin += int(fin.sum().item())
    require(n_big > 0, "the loss-scale check's dS stayed below 65504: it "
            "shows nothing")
    say("check flash backward f16 under a loss scale of %g (dO = %g x "
        "N(0, 1) clamped to 60000, |v| ~ 4, B=%d H=%d T=%d D=%d causal, p 0 "
        "and %g): largest |dS| %.6g, %d elements past float16's 65504; dq, "
        "dk, dv finite wherever the plain float32 arithmetic rounds finite "
        "(%d elements), max rel err %.3g (tol %.0e)"
        % (LOSS_SCALE, LOSS_SCALE, B, H, T, D, DROPOUT, ds_max, n_big,
           n_fin, worst, REL_TOL["float16"]))


def step_scalars(torch, ck, lr, t, scale=1.0):
    """A scalar buffer on the card holding the step's (lr, c1, c2, go,
    scale), as the optimizer stages it, with the clip's scale written
    over the staged 1."""
    from paddle_tpu_torch.framework.device import write_values
    sc = torch.empty(5, device="cuda")
    vals = ck.adam_step_scalars(lr, t, 0.9, 0.999)
    vals[ck.SCALE] = scale
    write_values(sc, vals)
    return sc


def adamw_launches(params):
    """AdamW launches a step over `params`: one a (parameter dtype,
    gradient dtype) group (`adamw_multi`); a gradient has its parameter's
    dtype."""
    return len({p.dtype for p in params})


def check_adamw(torch, ck, gen):
    """The kernel, reading lr, c1 and c2 from a scalar buffer on the card,
    against the plain rule with host lr and t: parameter bit-equal,
    moments within one float32 ulp. Each case runs at lr 1e-4 on
    parameters of size ~1 (the main path's lr, where a bfloat16 parameter
    mostly does not move) and at lr 1e-2 on parameters of size ~1e-2,
    where it must. Then five steps t = 1..5 with the lr changed after the
    second, the buffer rewritten before each: the kernel and the plain
    rule reading the same buffer (the route with use_fused_optimizer off)
    against the plain rule with host arguments."""
    worst_p = {"adamw": 0.0, "adamw" + ck.F16: 0.0}
    worst_m = 0.0
    moved_min = 1.0
    n = 0
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for lr, pscale in ((1e-4, 1.0), (1e-2, 1e-2)):
            for coeff in (0.0, 0.01):
                for t in (1, 1000):
                    for numel in (7, 768, 2304 * 768):
                        p = (torch.randn(numel, generator=gen, device="cuda")
                             * pscale).to(dtype)
                        g = (torch.randn(numel, generator=gen, device="cuda")
                             * 1e-2).to(dtype)
                        m1 = torch.randn(numel, generator=gen,
                                         device="cuda") * 1e-3
                        m2 = torch.rand(numel, generator=gen,
                                        device="cuda") * 1e-5
                        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                                  coeff=coeff)
                        ka = [x.clone() for x in (p, g, m1, m2)]
                        pa = [x.clone() for x in (p, g, m1, m2)]
                        ck.adamw(*ka, step_scalars(torch, ck, lr, t), **kw)
                        ck.adamw_plain(*pa, lr, t, **kw)
                        torch.cuda.synchronize()
                        what = "adamw %s lr=%g coeff=%g t=%d numel=%d" % (
                            dtype_name, lr, coeff, t, numel)
                        err_p = (ka[0].float() - pa[0].float()).abs() \
                            .max().item()
                        require(torch.equal(ka[0], pa[0]),
                                "%s: parameter differs from the plain rule "
                                "by %.3g" % (what, err_p))
                        key = "adamw" + (ck.F16 if dtype == torch.float16
                                         else "")
                        worst_p[key] = max(worst_p[key], err_p)
                        err_m = max(((ka[i] - pa[i]).abs()
                                     / pa[i].abs().clamp_min(1e-30)).max()
                                    .item() for i in (2, 3))
                        require(err_m <= ADAMW_MOMENT_REL_TOL,
                                "%s: moment rel err %.3g > %.3g"
                                % (what, err_m, ADAMW_MOMENT_REL_TOL))
                        worst_m = max(worst_m, err_m)
                        if dtype != torch.float32 and lr == 1e-2 \
                                and numel > 7:
                            moved = (ka[0] != p).double().mean().item()
                            require(moved >= ADAMW_MOVED_MIN,
                                    "%s: only %.3f of the parameter moved"
                                    % (what, moved))
                            moved_min = min(moved_min, moved)
                        n += 1
    say("check adamw: parameters bit-equal to the plain rule, moments max "
        "rel err %.3g (tol %.3g) over %d cases (float32, bfloat16, "
        "float16); bfloat16 and float16 at lr 1e-2 moved >= %.4f of the "
        "elements (want >= %.2f)"
        % (worst_m, ADAMW_MOMENT_REL_TOL, n, moved_min, ADAMW_MOVED_MIN))
    from paddle_tpu_torch.framework.device import write_values
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        numel = 2304 * 768
        p = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        ka, sa, pa = ([p.clone(), torch.zeros(numel, device="cuda"),
                       torch.zeros(numel, device="cuda")] for _ in range(3))
        sc = torch.empty(5, device="cuda")
        for t in range(1, 6):
            lr = 1e-2 if t <= 2 else 3e-3
            g = (torch.randn(numel, generator=gen, device="cuda")
                 * 1e-2).to(dtype)
            write_values(sc, ck.adam_step_scalars(lr, t, 0.9, 0.999))
            ck.adamw(ka[0], g, ka[1], ka[2], sc, **kw)
            ck.adamw_plain_scalars(sa[0], g, sa[1], sa[2], sc, **kw)
            ck.adamw_plain(pa[0], g, pa[1], pa[2], lr, t, **kw)
            torch.cuda.synchronize()
            what = "adamw %s t=%d lr=%g (scalar buffer)" % (dtype, t, lr)
            require(torch.equal(ka[0], pa[0]) and torch.equal(sa[0], pa[0]),
                    "%s: parameter differs from the plain rule" % what)
            require(all(torch.equal(a, b) for a, b in ((sa[1], pa[1]),
                                                       (sa[2], pa[2]))),
                    "%s: the plain rule on the buffer differs from it with "
                    "host arguments" % what)
            err_m = max(((ka[i] - pa[i]).abs()
                         / pa[i].abs().clamp_min(1e-30)).max().item()
                        for i in (1, 2))
            require(err_m <= ADAMW_MOMENT_REL_TOL, "%s: moment rel err %.3g"
                    % (what, err_m))
            n += 1
    say("check adamw over t = 1..5 (lr 1e-2, then 3e-3 from t = 3) through "
        "the scalar buffer, float32, bfloat16 and float16: kernel "
        "parameters and the "
        "plain rule on the buffer bit-equal to the plain rule with host lr "
        "and t")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        numel = 2304 * 768
        p = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        g = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        m1 = torch.randn(numel, generator=gen, device="cuda") * 1e-3
        m2 = torch.rand(numel, generator=gen, device="cuda") * 1e-5
        sc = step_scalars(torch, ck, 1e-2, 3)
        sc[3].zero_()                   # the guard skipped this step
        for fn in (ck.adamw, ck.adamw_plain_scalars):
            args = [x.clone() for x in (p, g, m1, m2)]
            fn(*args, sc, **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in
                        zip(args, (p, g, m1, m2))),
                    "%s %s with the guard word at 0 changed its state"
                    % (fn.__name__, dtype))
    say("check adamw guard word: at 0 the kernel and the plain rule leave "
        "the parameter and both moments bit-equal to their inputs (float32, "
        "bfloat16 and float16, %d elements); at 1 (every case above) the "
        "kernel is "
        "bit-equal to the plain rule" % (2304 * 768))
    check_adamw_scale(torch, ck, gen)
    check_adamw_multi(torch, ck, gen)
    return worst_p


def check_adamw_scale(torch, ck, gen):
    """The clip's scale word (ClipGradByGlobalNorm): the kernel launched
    with scaled=True on a buffer whose fifth word is ADAMW_CHECK_SCALE,
    against the plain rule on the same buffer and against the composed
    route, the gradient widened and multiplied by the scale in float32
    (the reference's product) and then the unscaled plain rule with host
    lr and t: parameters bit-equal, moments within one float32 ulp; the
    plain rule on the buffer bit-equal to the composed route. Float32 and
    bfloat16 and float16 gradients, lr 1e-2 on parameters of size ~1e-2,
    t = 3."""
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    worst_m = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for numel in (7, 2304 * 768):
            p = (torch.randn(numel, generator=gen, device="cuda")
                 * 1e-2).to(dtype)
            g = torch.randn(numel, generator=gen, device="cuda").to(dtype)
            m1 = torch.randn(numel, generator=gen, device="cuda") * 1e-3
            m2 = torch.rand(numel, generator=gen, device="cuda") * 1e-5
            sc = step_scalars(torch, ck, 1e-2, 3, ADAMW_CHECK_SCALE)
            ka, sa, pa = ([x.clone() for x in (p, m1, m2)] for _ in range(3))
            ck.adamw(ka[0], g, ka[1], ka[2], sc, scaled=True, **kw)
            ck.adamw_plain_scalars(sa[0], g, sa[1], sa[2], sc, scaled=True,
                                   **kw)
            composed = g.float() * sc[ck.SCALE]
            ck.adamw_plain(pa[0], composed, pa[1], pa[2], 1e-2, 3, **kw)
            unscaled = p.clone()
            ck.adamw(unscaled, g, m1.clone(), m2.clone(), sc, **kw)
            torch.cuda.synchronize()
            what = "adamw %s numel=%d scale=%g" % (dtype, numel,
                                                  ADAMW_CHECK_SCALE)
            require(torch.equal(ka[0], pa[0]) and torch.equal(sa[0], pa[0]),
                    "%s: parameter differs from the composed float32 "
                    "product" % what)
            require(all(torch.equal(a, b) for a, b in ((sa[1], pa[1]),
                                                       (sa[2], pa[2]))),
                    "%s: the plain rule on the buffer differs from the "
                    "composed route" % what)
            err_m = max(((ka[i] - pa[i]).abs()
                         / pa[i].abs().clamp_min(1e-30)).max().item()
                        for i in (1, 2))
            require(err_m <= ADAMW_MOMENT_REL_TOL,
                    "%s: moment rel err %.3g" % (what, err_m))
            require(numel == 7 or not torch.equal(unscaled, ka[0]),
                    "%s: the scale changed nothing" % what)
            worst_m = max(worst_m, err_m)
    say("check adamw clip scale word (%g, t = 3, lr 1e-2): kernel and the "
        "plain rule on the buffer bit-equal to the composed float32 product "
        "g * scale and the plain rule (float32, bfloat16 and float16 "
        "gradients), "
        "moments max rel err %.3g; the scale moved the parameters"
        % (ADAMW_CHECK_SCALE, worst_m))


# the multi-tensor check's sizes: 1 to ~4 M elements, odd ones, the edges
# of the kernel's 4-element vectors and 4096-element chunks
ADAMW_MULTI_SIZES = (1, 2, 3, 4, 5, 7, 31, 64, 127, 128, 129, 255, 256, 511,
                     512, 768, 1000, 1023, 3071, 4095, 4096, 4097, 8191,
                     8192, 12289, 65535, 65537, 100003, 262144, 589825,
                     768 * 768, 2304 * 768 + 1, 3 * 2 ** 20 + 5)
# ... and one tensor of 4 M + 3 in each (parameter, gradient) type pair
ADAMW_MULTI_BIG = 4 * 2 ** 20 + 3
ADAMW_MULTI_PER_PAIR = 36


def adamw_mixed_list(torch, gen):
    """The multi-tensor check's entries: ADAMW_MULTI_PER_PAIR a
    (parameter, gradient) type pair of float32, bfloat16 and float16 (324
    in all), each a dict of param, grad, m1, m2 (fresh tensors; some views
    one element into a larger buffer, so 4-byte but not 16-byte aligned)
    and its coeff, clip bit and lr factor, in an order that interleaves
    the pairs."""
    types = (torch.float32, torch.bfloat16, torch.float16)
    sizes = list(ADAMW_MULTI_SIZES) + [ADAMW_MULTI_BIG]
    out = []
    for i in range(ADAMW_MULTI_PER_PAIR):
        for k, (pdt, gdt) in enumerate((a, b) for a in types for b in types):
            numel = sizes[(i + 5 * k) % len(sizes)]
            # all four tensors views, or the gradient alone
            every, grad_only = (i + k) % 7 == 3, (i + k) % 7 == 5

            def make(scale, dtype, view=every, positive=False):
                t = torch.randn(numel + view, generator=gen, device="cuda")
                t = ((t.abs() if positive else t) * scale).to(dtype)
                return t[1:] if view else t
            out.append(dict(
                param=make(1e-2, pdt),
                grad=make(1e-2, gdt, view=every or grad_only),
                m1=make(1e-3, torch.float32),
                m2=make(1e-5, torch.float32, positive=True),
                coeff=(0.0, 0.01)[i % 2], scaled=(i // 2) % 2 == 1,
                lr_factor=(1.0, 0.5, 2.0 / 3.0)[(i + k) % 3]))
    return out


def check_adamw_multi(torch, ck, gen):
    """The multi-tensor launch (`adamw_multi`, the optimizer's route) on a
    mixed list of 324 tensors of every (parameter, gradient) type pair,
    coeff 0 and 0.01, scaled and not, lr factors 1, 0.5 and 2/3, sizes 1 to
    4 M + 3, some views 4 bytes off 16-byte alignment, against the plain
    rule tensor by tensor (`adamw_plain_scalars`, the lr factor's buffer
    made as the optimizer makes it): over 3 steps with lr and t restaged
    and the clip scale word at ADAMW_CHECK_SCALE, the second step's guard
    word at 0, every parameter and moment bit-equal after each step,
    eagerly (one launch a type pair) and replayed from a CUDA graph that
    captured the launches once."""
    from paddle_tpu_torch.framework.device import write_values
    entries = adamw_mixed_list(torch, gen)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
    cols = ("param", "grad", "m1", "m2")
    attrs = {a: [e[a] for e in entries] for a in ("coeff", "scaled")}
    attrs["lr_factor"] = [e["lr_factor"] for e in entries]
    # the three copies of the state: eager kernel, graph, plain rule
    state = [[{c: e[c].clone() if c != "grad" else e[c] for c in cols}
              for e in entries] for _ in range(3)]
    sc = torch.empty(5, device="cuda")

    def multi(st):
        ck.adamw_multi(*([x[c] for x in st] for c in cols), sc, **kw,
                       coeff=attrs["coeff"], scaled=attrs["scaled"],
                       lr_factor=attrs["lr_factor"])
    write_values(sc, ck.adam_step_scalars(1e-2, 1, 0.9, 0.999))
    torch.cuda.synchronize()
    graph = graph_of(torch, lambda: multi(state[1]), 0)
    pairs = {(e["param"].dtype, e["grad"].dtype) for e in entries}
    groups = len(pairs)
    n_el = sum(e["param"].numel() for e in entries)
    for t, lr, go in ((1, 1e-2, 1.0), (2, 1e-2, 0.0), (3, 3e-3, 1.0)):
        vals = ck.adam_step_scalars(lr, t, 0.9, 0.999)
        vals[ck.GO], vals[ck.SCALE] = go, ADAMW_CHECK_SCALE
        write_values(sc, vals)
        before = [x["param"].clone() for x in state[2]]
        mark = ck.launch_counts()
        multi(state[0])
        launched = ck.launch_delta(mark)
        require(launched["adamw"] + launched["adamw" + ck.F16] == groups,
                "adamw_multi: %s launches for %d type pairs"
                % (launched, groups))
        graph.replay()
        for x, e in zip(state[2], entries):
            f = e["lr_factor"]
            psc = sc if f == 1.0 else torch.cat((sc[:1] * float(f), sc[1:]))
            ck.adamw_plain_scalars(x["param"], x["grad"], x["m1"], x["m2"],
                                   psc, coeff=e["coeff"], scaled=e["scaled"],
                                   **kw)
        torch.cuda.synchronize()
        for route, st in (("eager", state[0]), ("graph", state[1])):
            for i, (x, y) in enumerate(zip(st, state[2])):
                require(all(torch.equal(x[c], y[c]) for c in cols),
                        "adamw_multi %s step %d (go %g): entry %d (%s param, "
                        "%s grad, %d elements, coeff %g, scaled %s, lr "
                        "factor %g) differs from the plain rule"
                        % (route, t, go, i, entries[i]["param"].dtype,
                           entries[i]["grad"].dtype, x["param"].numel(),
                           entries[i]["coeff"], entries[i]["scaled"],
                           entries[i]["lr_factor"]))
        moved = sum(int(not torch.equal(a, x["param"]))
                    for a, x in zip(before, state[2]))
        require(moved == 0 if go == 0 else moved > len(entries) // 2,
                "adamw_multi step %d (go %g): %d of %d parameters moved"
                % (t, go, moved, len(entries)))
    say("check adamw multi-tensor: %d tensors (%d elements, sizes %d to %d, "
        "%d entries with views off 16-byte alignment), %d type pairs, coeff 0 / 0.01, "
        "scaled and not, lr factors 1 / 0.5 / 2/3: eager (%d launches a "
        "step) and replayed from one CUDA graph, bit-equal to the plain rule "
        "tensor by tensor over 3 steps (lr and t restaged, clip scale %g; "
        "step 2's guard word 0 wrote nothing)"
        % (len(entries), n_el, min(ADAMW_MULTI_SIZES), ADAMW_MULTI_BIG,
           sum(1 for e in entries
               if any(e[c].data_ptr() % 16 for c in cols)),
           groups, groups, ADAMW_CHECK_SCALE))


def keep_cases():
    """(shape, p) at which F.dropout's keep mask runs on the main paths:
    the training paths' hidden and ERNIE's feed-forward activation at the
    kernels' drop rate and 0.5; phase 24's embedding and projection
    dropouts [B, T, hidden] and its `rnn` op's inter-layer mask, time-major
    [T, B, hidden], at the model's 0.65; phase 26's ResBlock dropouts at
    0.3; one ragged shape."""
    main = [((TRAIN_B, TRAIN_T, 768), p) for p in (DROPOUT, 0.5)] + [
        ((ERNIE_B, ERNIE_T, w), p) for w in (768, 3072)
        for p in (DROPOUT, 0.5)] + [((3, 5, 7), p) for p in (DROPOUT, 0.5)]
    return (main + [(shape, DROPOUT) for shape in KEEP_EDGE_SHAPES]
            + ptb_keep_cases() + unet_keep_cases())


# shapes at the edges of the keep-mask kernel's lanes (4 columns of a 4-row
# group, whole groups and quads stored 4 bytes a row): h = 1, h not a
# multiple of 4 or of 16, n not a multiple of 4, one row
KEEP_EDGE_SHAPES = ((5, 1), (4, 1, 1), (7, 6), (9, 20), (2, 3, 33),
                    (1, 130), (13, 1500), (6, 36), (4, 12), (3, 2, 4, 17))


def ptb_keep_cases():
    return [((PTB_B, PTB_T, PTB_HIDDEN), PTB_DROPOUT),
            ((PTB_T, PTB_B, PTB_HIDDEN), PTB_DROPOUT)]


def unet_keep_cases():
    """Phase 26's ResBlock dropouts at the model's 0.3: [B, ch * mult,
    32 / 2^level, 32 / 2^level] at each level (128 x 32 x 32, then 256
    at 16, 8 and 4)."""
    return [((UNET_B, UNET_CH * m, UNET_HW >> i, UNET_HW >> i),
             UNET_DROPOUT) for i, m in enumerate(UNET_MULT)]


def check_dropout_keep(torch, ck, cases):
    """The keep mask of F.dropout on the card (`dropout_keep`: the fused
    bits kernel under its own tag) bit-equal to its plain version at each
    (shape, p) of `cases`, the same kernel's bits route
    (`fused_dropout_bits`) bit-equal to the plain bits at each shape, and
    the mask's drop rate at the largest of them."""
    for shape, p in cases:
        got = ck.dropout_keep(WORD, DELTA, shape, p)
        want = ck.dropout_keep_plain(SEED, OFFSET, shape, p, device="cuda")
        require(got.dtype == torch.bool and torch.equal(got, want),
                "dropout_keep %s p=%g differs from its plain version"
                % (shape, p))
    for shape, _ in cases:                  # the mask = 0 route: the bits
        n, h = int(np.prod(shape[:-1])), shape[-1]
        require(torch.equal(
            ck.fused_dropout_bits(WORD, DELTA, n, h),
            ck.fused_dropout_bits_plain(SEED, OFFSET, n, h, device="cuda")),
            "fused_dropout_bits [%d, %d] differ from the plain Philox"
            % (n, h))
    shape, p = max(cases, key=lambda c: int(np.prod(c[0])))
    rate = 1.0 - ck.dropout_keep(WORD, DELTA, shape, p).double().mean().item()
    require(abs(rate - p) <= DROP_RATE_TOL, "dropout_keep rate %.5f at %s "
            "p=%g" % (rate, shape, p))
    say("check dropout_keep: bit-equal to the plain Philox mask (and "
        "fused_dropout_bits to the plain bits) at %s; drop "
        "rate %.5f at %s (want %.3f +- %.3f)"
        % (["%s p=%g" % c for c in cases], rate, shape, p, DROP_RATE_TOL))
    return 0.0


def paged_inputs(torch, quantized, lens, gen, nan_tail=True, B=8, H=12,
                 T=512, D=64):
    """Decode-step inputs; the cache past each slot's lens is NaN garbage
    when `nan_tail` (uninitialized pages, the hostile case)."""
    dev = "cuda"
    q, nk, nv = (torch.randn((B, H, 1, D), generator=gen, device=dev)
                 for _ in range(3))
    kf = torch.randn((B, H, T, D), generator=gen, device=dev)
    vf = torch.randn((B, H, T, D), generator=gen, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    dead = (torch.arange(T, device=dev)[None, :]
            >= lens_t[:, None])[:, None, :] & nan_tail        # [B, 1, T]
    if quantized:
        from paddle_tpu_torch.ops.cuda_kernels import quantize_kv
        kc, ks = quantize_kv(kf)
        vc, vs = quantize_kv(vf)
        ks = ks.masked_fill(dead, float("nan"))
        vs = vs.masked_fill(dead, float("nan"))
        return [q, kc, vc, lens_t, nk, nv, ks, vs]
    kf = kf.masked_fill(dead[..., None], float("nan"))
    vf = vf.masked_fill(dead[..., None], float("nan"))
    return [q, kf, vf, lens_t, nk, nv, None, None]


def clone_args(args):
    return [None if a is None else a.clone() for a in args]


def check_paged(torch, ck, quantized, gen):
    """Idle slot, inside a block, both sides of a 128-row block edge, a
    mid length, T-1 and T (full clamp), NaN garbage past every lens; the
    kernel's chunk edges for this cache (lens 0, chunk - 1, chunk, chunk +
    1, 2 chunk, T - 1, T) and a batch whose every slot is at T, so every
    chunk is live; then a cache depth and head width no power-of-two block
    tiles (T=100, D=24), which the gate also sends to the kernel, and a
    cache deeper than any shared array could hold (T=16384, lens near
    T)."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    worst = 0.0
    serving = dict(B=8, H=12, T=512, D=64)
    geometry = (ck.paged_int8_geometry if quantized
                else ck.paged_split_geometry)
    c = geometry(64)[1]
    for lens, shape in (([0, 5, 127, 128, 300, 511, 512, 200], serving),
                        ([0, c - 1, c, c + 1, 2 * c, 511, 512, 3 * c + 1],
                         serving),
                        ([512] * 8, serving),
                        ([0, 57, 99, 100], dict(B=4, H=2, T=100, D=24)),
                        ([16384, 16001], dict(B=2, H=2, T=16384, D=64))):
        args = paged_inputs(torch, quantized, lens, gen, **shape)
        ka, pa = clone_args(args), clone_args(args)
        got = ck.paged_decode(*ka)
        want = ck.paged_decode_plain(*pa)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()),
                "%s %s: non-finite output" % (name, shape))
        require(err <= TOL["float32"], "%s %s: max abs err %.3g > %.3g"
                % (name, shape, err, TOL["float32"]))
        # the in-place append: same rows written, bit for bit, nothing else
        for i in (1, 2, 6, 7) if quantized else (1, 2):
            a, b = ka[i], pa[i]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            require(bool(same.all()), "%s %s: cache buffer %d differs from "
                    "the plain version's after the append" % (name, shape, i))
        say("check %s %s: max abs err %.3g (tol %.0e), lens %s, cache rows "
            "bit-equal" % (name, shape, err, TOL["float32"], lens))
        worst = max(worst, err)
    return worst


def check_gates(torch, ck, gen):
    """On the card a gate gives way to the plain version only when its
    flag is off, or, for the flash gate, where the reference's gate does
    for what the call computes (an additive mask, dropout p=1): an input
    its kernel does not take raises."""
    q, k, v = qkv_views(torch, 1, 32, 2, 64, torch.float32, gen)
    routed = [("additive mask", lambda: ck.flash_attention_or_none(
                  q, k, v, torch.zeros(32, 32, device="cuda"), True)),
              ("dropout p=1", lambda: ck.flash_attention_or_none(
                  q, k, v, None, True, dropout_p=1.0))]
    bad = [("float16 q with float32 k, v", lambda: ck.flash_attention_or_none(
                q.half(), k, v, None, True)),
           ("D=160", lambda: ck.flash_attention_or_none(
                *qkv_views(torch, 1, 8, 1, 160, torch.float32, gen), None,
                True))]
    bad.append(("dropout p=-0.1", lambda: ck.flash_attention_or_none(
        q, k, v, None, True, dropout_p=-0.1)))
    qh = q.detach().double()
    bad.append(("float64 backward", lambda: ck.flash_bwd_dq(
        qh, qh, qh, qh, qh, torch.zeros(64, device="cuda"), True)))
    w = torch.zeros(16, device="cuda", dtype=torch.float64)
    m = torch.zeros(16, device="cuda")
    sc = torch.zeros(4, device="cuda")
    bad.append(("float64 adamw", lambda: ck.fused_adamw_or_none(
        w, w, sc, m, m, beta1=0.9, beta2=0.999, epsilon=1e-8,
        coeff=0.0)))
    f = torch.zeros(16, device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.0)
    for what, lists in (
            ("a float64 entry", ([f, w], [f, w], [m, m], [m, m])),
            ("lists of unequal length", ([f, f], [f], [m, m], [m, m])),
            ("an empty list", ([], [], [], [])),
            ("a strided gradient", ([f], [torch.zeros(32, device="cuda")
                                         [::2]], [m], [m])),
            ("a float16 moment", ([f], [f], [m.half()], [m])),
            ("a CPU entry", ([f, f.cpu()], [f, f.cpu()], [m, m.cpu()],
                             [m, m.cpu()])),
            ("a shape mismatch", ([f], [f[:8]], [m], [m]))):
        bad.append(("multi-tensor adamw with " + what,
                    lambda lists=lists: ck.fused_adamw_multi_or_none(
                        lists[0], lists[1], sc, lists[2], lists[3], **kw)))
    args = paged_inputs(torch, False, [3, 4], gen, B=2, H=2, T=64, D=64)
    args[3] = args[3].long()
    bad.append(("int64 lens",
                lambda: ck.paged_decode_attention_or_none(*args)))
    before = ck.launch_counts()
    for what, call in bad:
        try:
            call()
        except ValueError:
            continue
        raise SystemExit("chip_smoke FAILED: a gate took %s on the card "
                         "without raising" % what)
    for what, call in routed:
        require(call() is None, "the flash gate took %s on the card" % what)
    require(ck.launch_counts() == before, "a rejected input launched")
    say("check gates: %d inputs the kernels do not take raise on the card; "
        "%s go to the plain attention, launching nothing"
        % (len(bad), " and ".join(w for w, _ in routed)))


# ---------------------------------------------------------------------------
# kernel timings


def time_flash(torch, ck, F, timer, gen, T):
    q, k, v = qkv_views(torch, 1, T, 12, 64, torch.float32, gen)
    B, H, D = 1, 12, 64
    nbytes = 4 * B * H * T * D * 4
    flops = 4 * D * B * H * (T * (T + 1) // 2)
    bound, by = bound_ms(nbytes, flops, "float32")
    return {
        "ms": timer.ms(lambda: ck.flash_attention(q, k, v, True)),
        "plain_ms": timer.ms(lambda: ck.flash_attention_plain(q, k, v,
                                                              True)),
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": bound, "bound_by": by}


def time_paged(torch, ck, F, timer, gen, quantized, lens):
    """Times at the main path's shapes with `lens` as the live lengths.
    Eight copies of the inputs are used in turn (over 50 MB, the L2), so
    each launch finds its cache cold, as a decode step does."""
    sets = [paged_inputs(torch, quantized, lens, gen, nan_tail=False)
            for _ in range(8)]
    B, H, T, D = sets[0][1].shape
    esize = 1 if quantized else 4
    nbytes = flops = 0
    for ln in lens:
        cl = min(ln, T - 1)
        rows = cl * (2 * D * esize + (8 if quantized else 0))
        io = 3 * D * 4 + D * 4 + 2 * D * esize + (8 if quantized else 0)
        nbytes += H * (rows + io) + 4
        flops += H * 4 * D * (cl + 1)
    bound, by = bound_ms(nbytes, flops, "float32")
    turn = [0]

    def rotating(fn):
        def call():
            a = sets[turn[0] % len(sets)]
            turn[0] += 1
            fn(a)
        return call

    out = {
        "ms": timer.ms(rotating(lambda a: ck.paged_decode(*a))),
        "plain_ms": timer.ms(rotating(lambda a: ck.paged_decode_plain(*a))),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    if not quantized:
        # yardstick: sdpa over the same cache with a live-length mask; it
        # reads all T rows and does not append
        live = (torch.arange(T, device="cuda")[None, :]
                <= sets[0][3][:, None].long())[:, None, None, :]
        out["library_ms"] = timer.ms(rotating(
            lambda a: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                     attn_mask=live)))
    return out


# ---------------------------------------------------------------------------
# training


def bwd_timings(torch, ck, F, timer, gen, B, T, causal, p,
                dt_name="bfloat16", plain_runs=(25, 10)):
    """Device times of the flash backward kernels (rows 2 and 3) at
    B x 12 heads x T x 64, bfloat16 (or float16: their float16 instances),
    beside their plain versions (timed over `plain_runs`: runs, calls a
    run), their bounds and PyTorch's sdpa backward (dq, dk and dv in one
    call) on the same inputs."""
    H, D, dt = 12, 64, getattr(torch, dt_name)
    q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
    do = torch.randn((B, H, T, D), generator=gen, device="cuda").to(dt)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
    o, lse = ck.flash_fwd_train(q, k, v, causal, p, WORD, DELTA)
    _, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD, DELTA)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                        dropout_p=p)
    lib_bwd = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # dq: reads q, k, v, o, dO, lse; writes dq, Delta; 3 products.
    # dk/dv: reads q, k, v, dO, lse, Delta; writes dk, dv; 4 products.
    kernels = (
        ("flash_bwd_dq", 3,
         lambda: ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD,
                                 DELTA),
         lambda: ck.flash_bwd_dq_plain(q, k, v, o, do, lse, causal, p,
                                       bits)),
        ("flash_bwd_dkv", 4,
         lambda: ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, WORD,
                                  DELTA),
         lambda: ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, p,
                                        bits)))
    out = {}
    for name, products, fn, plain in kernels:
        b, by = bound_ms(6 * bhtd + 2 * bht, 2 * products * D * pairs,
                         dt_name)
        out[name] = {"ms": timer.ms(fn),
                     "plain_ms": timer.ms(plain, *plain_runs),
                     "library_ms": lib_bwd, "bound_ms": b, "bound_by": by}
    shape = "B=%d H=%d T=%d D=%d %s %s p=%g" % (
        B, H, T, D, SHORT[dt_name], "causal" if causal else "not causal", p)
    for name, t in out.items():
        say("time %s %s: %.4f ms, plain %.4f ms, torch sdpa bwd (dq+dk+dv) "
            "%.4f ms, bound %.4f ms (%s)"
            % (name, shape, t["ms"], t["plain_ms"], t["library_ms"],
               t["bound_ms"], t["bound_by"]))
    say("time flash backward dq + dkv %s: %.4f ms vs torch sdpa backward "
        "%.4f ms, bound %.4f ms" % (
            shape, out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"],
            lib_bwd, out["flash_bwd_dq"]["bound_ms"]
            + out["flash_bwd_dkv"]["bound_ms"]))
    return out


def fwd_timings(torch, ck, F, timer, gen, B, T, causal, p,
                dt_name="bfloat16", plain_runs=(25, 10)):
    """Device time of the training flash forward (row 1t: lse and
    in-kernel dropout) at B x 12 heads x T x 64, bfloat16 (or float16: its
    float16 instance), beside its plain version (timed over `plain_runs`),
    its bound and PyTorch's sdpa forward on the same inputs."""
    H, D = 12, 64
    q, k, v = qkv_views(torch, B, T, H, D, getattr(torch, dt_name), gen)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # reads q, k, v; writes o, lse; 2 products of 2 D flops a live pair
    b, by = bound_ms(4 * bhtd + bht, 4 * D * pairs, dt_name)
    t = {"ms": timer.ms(lambda: ck.flash_fwd_train(q, k, v, causal, p, WORD,
                                                   DELTA)),
         "plain_ms": timer.ms(lambda: ck.flash_fwd_train_plain(
             q, k, v, causal, p, bits), *plain_runs),
         "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=causal, dropout_p=p)),
         "bound_ms": b, "bound_by": by}
    say("time flash_fwd_train B=%d H=%d T=%d D=%d %s %s p=%g: %.4f ms, "
        "plain %.4f ms, torch sdpa fwd %.4f ms, bound %.4f ms (%s)"
        % (B, H, T, D, SHORT[dt_name], "causal" if causal else "not causal",
           p, t["ms"],
           t["plain_ms"], t["library_ms"], t["bound_ms"], t["bound_by"]))
    return t


def train_timings(torch, ck, F, timer, gen):
    """Device times of the training kernels at the main path's shapes; the
    flash kernels also at GPT-2's shape without dropout (the Philox share)
    and at ERNIE's attention shape (path A)."""
    B, T = TRAIN_B, TRAIN_T
    out = {"flash_fwd_train": fwd_timings(torch, ck, F, timer, gen, B, T,
                                          True, DROPOUT)}
    fwd_timings(torch, ck, F, timer, gen, B, T, True, 0.0)
    fwd_timings(torch, ck, F, timer, gen, ERNIE_B, ERNIE_T, False, DROPOUT)
    out.update(bwd_timings(torch, ck, F, timer, gen, B, T, True, DROPOUT))
    bwd_timings(torch, ck, F, timer, gen, B, T, True, 0.0)
    bwd_timings(torch, ck, F, timer, gen, ERNIE_B, ERNIE_T, False, DROPOUT)
    return out


def time_adamw(torch, ck, timer, gen, shapes, card, dt_name="bfloat16",
               plain_runs=(3, 1)):
    """One AdamW step over tensors shaped like `shapes` (a model's
    parameters), `dt_name` parameters and gradients, float32 moments, as
    the captured train step runs it: one launch for the whole list
    (`adamw_multi`), lr and the bias corrections from the scalar buffer,
    each gradient times the clip's scale word (the GPT-2 configuration's
    ClipGradByGlobalNorm, phase 17). The row's time is that launch
    replayed from a CUDA graph: device time alone. The launch without the
    scale (phase 10's optimizer) is replayed too, and the eager call is
    timed on the device and, apart, on the host (the seconds a step's
    Python takes to check and enqueue it; the packed table reused). With
    dt_name float16: the kernel's float16 instance; PyTorch's
    AdamW(fused=True) keeps float16 moments there, so it is no yardstick
    of the same function (library_ms None). With float32 (an O1 path's
    parameters and gradients): 28 bytes an element in the bound, and
    PyTorch's fused AdamW computes the same function. The plain version,
    tensor by tensor (0.07-0.22 s a call on an H100), is timed over
    `plain_runs` (runs, calls a run)."""
    dt = getattr(torch, dt_name)
    ps = [torch.randn(s, generator=gen, device="cuda").to(dt)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-2).to(dt)
          for s in shapes]
    m1 = [torch.zeros(s, device="cuda") for s in shapes]
    m2 = [torch.zeros(s, device="cuda") for s in shapes]
    sc = step_scalars(torch, ck, 1e-4, 10, ADAMW_CHECK_SCALE)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)

    def multi(**extra):
        ck.adamw_multi(ps, gs, m1, m2, sc, **kw, **extra)

    def plain():
        for p, g, a, b in zip(ps, gs, m1, m2):
            ck.adamw_plain_scalars(p, g, a, b, sc, scaled=True, **kw)
    graph = graph_of(torch, lambda: multi(scaled=True), 1)
    unscaled = graph_of(torch, multi, 1)
    lib_p = [p.clone().requires_grad_() for p in ps]
    for p, g in zip(lib_p, gs):
        p.grad = g.clone()
    lib = torch.optim.AdamW(lib_p, lr=1e-4, weight_decay=0.01, fused=True)
    n = sum(p.numel() for p in ps)
    # each element: param read + write (2 + 2 bytes, 4 + 4 for float32),
    # grad read (2, or 4), m1 and m2 read + write (8 + 8); 10 operations
    # and the scale's product
    size = torch.empty((), dtype=dt).element_size()
    b, by = bound_ms((3 * size + 16) * n, 11 * n, "float32")
    mark = ck.launch_counts()
    multi()
    launched = ck.launch_delta(mark)
    per_step = launched["adamw"] + launched["adamw" + ck.F16]
    require(per_step == 1, "time adamw: %d launches for one type pair"
            % per_step)
    eager_ms = timer.ms(multi)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            multi()
        host.append((time.perf_counter() - t0) * 1e2)
    host_ms = statistics.median(host)
    unscaled_ms = timer.ms(unscaled.replay)
    lib_ms = timer.ms(lib.step)
    out = {"ms": timer.ms(graph.replay),
           "plain_ms": timer.ms(plain, *plain_runs),
           "library_ms": lib_ms if dt != torch.float16 else None,
           "bound_ms": b, "bound_by": by, "tensors": len(shapes),
           "unscaled_ms": unscaled_ms, "eager_ms": eager_ms,
           "host_ms": host_ms}
    say("time adamw %d parameters, %d elements, %s param+grad, f32 "
        "moments, the clip's scale word, one launch: %.4f ms/step replayed "
        "from a CUDA graph (without the scale %.4f ms replayed; the eager "
        "call %.4f ms on the device, %.4f ms of host time to check and "
        "enqueue), plain %.4f ms, torch AdamW(fused=True) %.4f ms (%s "
        "moments), bound %.4f ms (%s)"
        % (len(shapes), n, SHORT[dt_name], out["ms"], unscaled_ms, eager_ms,
           host_ms, out["plain_ms"], lib_ms, SHORT[dt_name], b, by))
    say("time adamw %s with the scale word: %.4f ms/step replayed, %.2f of "
        "its bound, %.2f of torch's fused AdamW time, %+.4f ms against the "
        "unscaled launch in this run (%s)"
        % (SHORT[dt_name], out["ms"], b / out["ms"], lib_ms / out["ms"],
           out["ms"] - unscaled_ms, card))
    return out


def time_dropout_keep(torch, ck, timer, shape, p=DROPOUT):
    """Device time of the keep-mask kernel at a dropout's shape and rate
    beside its bound (one bool written an element; one Philox call,
    PHILOX_INT_OPS int32 operations a lane, a 4 elements at the card's
    int32 rate) and its plain version. No PyTorch call
    draws this function (torch.rand's bits are another generator's):
    library_ms is null."""
    n = int(np.prod(shape))
    b, by = bound_ms(n, PHILOX_INT_OPS * n / 4, "int32")
    out = {"ms": timer.ms(lambda: ck.dropout_keep(WORD, DELTA, shape, p)),
           "plain_ms": timer.ms(lambda: ck.dropout_keep_plain(
               SEED, OFFSET, shape, p, device="cuda")),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    say("time dropout_keep %s p=%g: %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%s)" % (shape, p, out["ms"], out["plain_ms"], b, by))
    return out


def token_stream(io, vocab, T):
    class TokenStream(io.Dataset):
        """The bench's synthetic stream (benchmarks/train_bench.py)."""

        def __len__(self):
            return 100000

        def __getitem__(self, i):
            rs = np.random.RandomState(i)
            return rs.randint(0, vocab, (T + 1,)).astype(np.int64)
    return TokenStream()


# kernel-name patterns of the training step's profile groups, first match
PROFILE_GROUPS = (("flash kernels (port)", ("flash_fwd_", "flash_bwd_")),
                  ("dropout keep mask (port)", ("fdrln_bits_kernel",)),
                  ("fused dropout-LN (port)", ("fdrln_",)),
                  ("adamw (port)", ("adamw_kernel",)),
                  ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "cublas")),
                  ("reductions", ("reduce_kernel",)),
                  ("elementwise", ("elementwise", "vectorized")))


def group_of(kernel, groups=PROFILE_GROUPS):
    """The first group of `groups` whose patterns a kernel name holds, else
    "other"."""
    return next((g for g, pats in groups if any(p in kernel for p in pats)),
                "other")


def profile_groups(rows, groups=PROFILE_GROUPS):
    """Device ms per group of `groups` (and "other") of profiler rows."""
    out = {}
    for t_us, key, _ in rows:
        name = group_of(key, groups)
        out[name] = out.get(name, 0.0) + t_us / 1e3
    return out


def profile_step(torch, step, batch):
    """Device time of one train step from torch.profiler: (kernel ms, all
    kernel rows by device time). 0 ms when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*batch())
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return sum(t for t, _, _ in rows) / 1e3, rows


def report_profile(label, dev_ms, step_ms, top, groups=PROFILE_GROUPS):
    """Print one profiled step: its kernel time against the median step
    (the device's idle share), the groups and the largest kernels."""
    if dev_ms <= 0:
        say("%s step profile: not measured (the profiler saw no device "
            "activity)" % label)
        return
    say("%s step profile: %.3f ms of kernels in one step (torch.profiler) "
        "vs %.2f ms median step: device idle %.1f %%"
        % (label, dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms)))
    for name, ms in sorted(profile_groups(top, groups).items(),
                           key=lambda kv: -kv[1]):
        say("  group %-26s %8.3f ms/step" % (name, ms))
    for t_us, key, count in top[:12]:
        say("  %9.1f us/step  %5d launches  %s" % (t_us, count, key[:90]))


def eager_train_step(Step):
    class EagerStep(Step):
        """The step's body run eagerly on every call: no program is built,
        captured or replayed (the step as it ran before it was captured,
        and the reference the programs are held to). Its telemetry counts
        under an engine of its own, so that the jit_train and jit_eval
        retraces count program builds."""

        engine = "eager_bodies"

        def _run(self, key, body):
            return body()
    return EagerStep


def timed_steps(torch, step, batch, warmup, timed):
    """warmup + timed calls of `step` on `batch()`, each ended by a
    synchronize: (losses, ms of each timed call, the last outputs)."""
    losses, times = [], []
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        loss, outs = step(*batch())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return [float(x) for x in losses], times[warmup:], outs


def step_line(label, times, tokens, flops, peak, dev_ms, card):
    """One path's step numbers: median step, tokens/s, MFU, peak memory,
    and the kernel time and device idle share of one profiled step."""
    step_ms = statistics.median(times)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    idle = ("%.3f ms of kernels in one profiled step, device idle %.1f %%"
            % (dev_ms, 100.0 * (1.0 - dev_ms / step_ms)) if dev_ms > 0
            else "kernel time not measured (the profiler saw no device "
            "activity)")
    say("%s: step %.2f ms median (%.2f mean) over %d timed steps, %.0f "
        "tokens/s, MFU %.4f of 989 TFLOP/s bf16, peak memory %.1f MiB; %s "
        "(%s)" % (label, step_ms, statistics.mean(times), len(times),
                  tokens / (step_ms / 1e3), mfu, peak / 2 ** 20, idle, card))
    return step_ms


def run_path(torch, ck, label, card, model, opt, loss_fn, batch, ctx,
             tokens, flops, want, groups=PROFILE_GROUPS):
    """One training path: its step's bodies run eagerly (EAGER_WARMUP +
    EAGER_STEPS steps, one profiled), then the captured step, the main
    path: the launch and path counters zeroed just before its TRAIN_WARMUP
    + TRAIN_STEPS steps and read just after; one program built, every
    later step a replay; the launches a step `want` (kernel: count), all
    of them through replays; one replay profiled. Returns (launches,
    attention paths, median step ms, the last outputs, the runs of the
    step's body in Python: on the card the build's eager run and its
    capture, on the CPU every step)."""
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    with ctx():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, times, _ = timed_steps(torch, eager, batch, EAGER_WARMUP,
                                  EAGER_STEPS)
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = profile_step(torch, eager, batch)
    step_line("%s eager bodies" % label, times, tokens, flops, peak, dev_ms,
              card)
    report_profile("%s eager" % label, dev_ms, statistics.median(times), top,
                   groups)
    del eager
    step = make_train_step(model, loss_fn, opt)
    with ctx():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        ck.attention_path_counts(reset=True)
        losses, times, outs = timed_steps(torch, step, batch, TRAIN_WARMUP,
                                          TRAIN_STEPS)
        launches = ck.launch_counts()
        paths = ck.attention_path_counts()
        peak = torch.cuda.max_memory_allocated()
        progs = step.programs
        (key,) = progs.builds
        replayed = {k: progs.replays[key] * n for k, n in
                    progs.launches[key].items()}
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        require(step.compiles == 1 and step.replays == n_steps - 1,
                "%s: %d programs and %d replays in %d steps (want one "
                "build, then replays)" % (label, step.compiles, step.replays,
                                          n_steps))
        dev_ms, top = profile_step(torch, step, batch)
    require(all(math.isfinite(x) for x in losses),
            "%s: non-finite loss %s" % (label, losses))
    say("%s main path: %d steps, losses %s" % (
        label, n_steps, ["%.4f" % x for x in losses]))
    per_step = {k: launches[k] / n_steps for k in launches}
    say("%s main path launches %s, attention paths %s" % (label, launches,
                                                         paths))
    require(all(per_step[k] == v for k, v in want.items()),
            "%s: launches per step %s, want %s" % (label, per_step, want))
    require(all(replayed[k] > 0 for k, v in want.items() if v),
            "%s: kernels launched in no replay: %s" % (label, replayed))
    say("%s program %s: %d build + %d replays (compiles %d), captured in "
        "%.1f ms, graph pool %.1f MiB, launches a step %s, launches through "
        "replays %s (%s)"
        % (label, key, progs.builds[key], progs.replays[key], step.compiles,
           progs.capture_s[key] * 1e3, progs.pool_bytes() / 2 ** 20,
           {k: n for k, n in progs.launches[key].items() if n},
           {k: n for k, n in replayed.items() if n}, card))
    step_ms = step_line("%s captured step" % label, times, tokens, flops,
                        peak, dev_ms, card)
    report_profile("%s captured" % label, dev_ms, step_ms, top, groups)
    bodies = 2 if next(model.parameters()).is_cuda else n_steps
    return launches, paths, step_ms, outs, bodies


def graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                              batches, ctx, p):
    """From one saved state (parameters, moments, step count, RNG), the steps
    of `batches` (two or more) through the captured step and through its bodies
    run eagerly, twice (the eager step must repeat itself bit for bit for the
    comparison to mean anything): losses, parameters and moments bit-equal. At
    p > 0 the two steps' Philox words differ and so do the bits they give a
    flash call and a fused call, and the restored state gives step 1's word
    again."""
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    step = make_train_step(model, loss_fn, opt)
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    params = [t for t in model.parameters() if t.requires_grad]
    moments = lambda: [a for t in params
                       for a in opt._get_accumulators(t).values()]
    with ctx():
        step(*batches[0])                 # the build; later calls replay
        torch.cuda.synchronize()
        saved = ([t.detach().clone() for t in params],
                 [a.clone() for a in moments()], opt._step_count,
                 prandom.get_rng_state())

        def two_steps(fn):
            with torch.no_grad():
                for t, v in zip(params + moments(), saved[0] + saved[1]):
                    t.copy_(v)
            opt._step_count = saved[2]
            prandom.set_rng_state(saved[3])
            losses, words = [], []
            for b in batches:
                losses.append(fn(*b)[0])
                words.append(prandom.RNG.word(params[0].device).clone())
            torch.cuda.synchronize()
            return (losses, [t.detach().clone() for t in params],
                    [a.clone() for a in moments()], words)
        e1, e2 = two_steps(eager), two_steps(eager)
        replays = step.replays
        g = two_steps(step)
        require(step.replays == replays + len(batches),
                "%s: the captured steps did not replay" % label)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    for i, what in enumerate(("losses", "parameters", "moments")):
        require(same(e1[i], e2[i]), "%s p=%g: two eager runs from one state "
                "differ in their %s (the eager step is not deterministic)"
                % (label, p, what))
        require(same(g[i], e1[i]), "%s p=%g: the captured step's %s differ "
                "from the eager bodies'" % (label, p, what))
    note = ""
    if p > 0:
        w1, w2 = g[3][:2]
        require(not torch.equal(w1, w2), "%s: steps 1 and 2 ran on one "
                "Philox word %s" % (label, w1.tolist()))
        require(torch.equal(w1, e1[3][0]) and torch.equal(w2, e1[3][1]),
                "%s: the restored RNG state did not give step 1's word "
                "again" % label)
        bits = [(ck.attn_dropout_bits(w, 0, 12, 64, 64),
                 ck.fused_dropout_bits(w, 1, 64, 768)) for w in (w1, w2)]
        require(not torch.equal(bits[0][0], bits[1][0])
                and not torch.equal(bits[0][1], bits[1][1]),
                "%s: steps 1 and 2 drew the same masks" % label)
        note = (", words (seed, base) %s then %s: a flash call's and a "
                "fused call's bits differ between the steps, the restored "
                "state repeats step 1's" % (w1.tolist()[1], w2.tolist()[1]))
    say("%s graph against eager p=%g: %d steps from one state, losses %s, "
        "parameters and moments bit-equal to the eager bodies (which repeat "
        "themselves bit for bit)%s"
        % (label, p, len(batches), ["%.6f" % float(x) for x in g[0]], note))


def free_memory(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_main(torch, ck, flags, card, fused=False, dtype="bfloat16"):
    """The GPT-2 training path, with both fused flags (use_fused_dropout_ln,
    fused_block) off (phase 10) or on (path B), through `run_path`; then
    the captured step against its eager bodies at the path's dropout 0.1
    and, on a fresh model, at 0. With dtype float16 (phase 18 (a)):
    decorate O2 float16 and every step under auto_cast(O2, float16), the
    kernels' float16 instances counted (names + ck.F16), the check at 0
    left out. Returns (launch counts, parameter shapes, median step
    ms)."""
    import contextlib
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    f16 = dtype == "float16"
    label = ("train fused" if fused else "train") + (" f16" if f16 else "")
    sfx = ck.F16 if f16 else ""
    ctx = ((lambda: amp.auto_cast(level="O2", dtype="float16")) if f16
           else contextlib.nullcontext)
    saved = flags.get_flags(["use_fused_dropout_ln", "fused_block"])
    flags.set_flags({"use_fused_dropout_ln": fused, "fused_block": fused})
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731

    def build(**kw):
        prandom.seed(0)
        model = gpt2_small(seed=0, **kw)
        model.train()
        opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
        return amp.decorate(model, opt, level="O2", dtype=dtype)
    try:
        t0 = time.perf_counter()
        model, opt = build()
        vocab = model.gpt.vocab_size
        loader = io.DataLoader(token_stream(io, vocab, TRAIN_T),
                               batch_size=TRAIN_B, prefetch_to_device=2)
        it = iter(loader)

        def batch():
            ids = next(it)
            return [ids[:, :-1]], [ids[:, 1:]]
        n_params = sum(p.numel() for p in model.parameters())
        n_tensors = len(list(model.parameters()))
        say("%s: gpt2-small %d parameters (%d tensors) in %s, built in %.1f "
            "s, use_fused_dropout_ln and fused_block %s"
            % (label, n_params, n_tensors, next(model.parameters()).dtype,
               time.perf_counter() - t0, "on" if fused else "off"))
        L = len(model.gpt.layers)
        want = {"flash_fwd_train" + sfx: L, "flash_bwd_dq" + sfx: L,
                "flash_bwd_dkv" + sfx: L,
                "adamw" + sfx: adamw_launches(model.parameters()),
                "fused_dropout_ln_fwd" + sfx: L if fused else 0,
                "fused_dropout_residual_fwd" + sfx: L if fused else 0,
                "fused_dropout_ln_bwd" + sfx: 2 * L if fused else 0,
                # the hidden dropouts (2 a layer, unfused) and the
                # embeddings' dropout
                "dropout_keep": 1 if fused else 2 * L + 1}
        if f16:                         # and no bfloat16 instance runs
            want.update({k: 0 for k in (
                "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv", "adamw",
                "fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
                "fused_dropout_ln_bwd")})
        tokens = TRAIN_B * TRAIN_T
        d = model.gpt.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * TRAIN_T * tokens
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        launches, paths, step_ms, _, _ = run_path(
            torch, ck, label, card, model, opt, loss_fn, batch, ctx, tokens,
            flops, want)
        say("%s feed stall %.3f ms a batch" % (label, (
            FEED_STALL.sum - stall0[0]) / (FEED_STALL.count - stall0[1])))
        require(paths["flash_dropout"] > 0 and paths["xla_sdpa"] == 0,
                "%s: attention paths %s" % (label, paths))
        fixed = [batch() for _ in range(2)]
        it.close()
        free_memory(torch)
        graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                  fixed, ctx, DROPOUT)
        shapes = [tuple(p.shape) for p in model.parameters()]
        del model, opt
        free_memory(torch)
        if not f16:
            model, opt = build(attn_dropout_prob=0.0,
                               hidden_dropout_prob=0.0)
            graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                      fixed, ctx, 0.0)
            del model, opt
            free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches, shapes, step_ms


def compare_runs(torch, ck, flags, label, build, kernel_flags, must_launch,
                 steps=3, near_zero=None):
    """Kernels vs plain versions on the card. `build()` makes the seeded
    float32 model without dropout, its optimizer and a closure that runs
    train step i; it runs once with `kernel_flags` on and once with all of
    them off (which must launch nothing). Both runs keep their first
    step's gradients (the step's eager build: the same weights on the same
    batch), and each parameter's ||g_kernels - g_plain|| must be within
    TRAIN_GRAD_TOL of ||g_plain|| (of TRAIN_GRAD_FLOOR times the model's
    gradient norm where its own is below that). The losses must agree
    within 1e-4 relative and the parameters after the steps within
    TRAIN_PARAM_TOL, which the plain run's own movement must exceed.

    With `near_zero`, an element whose first-step gradient in the plain
    run is at most that share of its parameter's gradient RMS is held
    within 2 * steps * lr instead, and the elements are counted: Adam's
    step is lr * g / (|g| + eps), the gradient's sign, and one token's
    ReLU rounding to the other side of 0 in one run can turn a sign that
    small. Those elements' check is the gradient comparison."""
    saved = flags.get_flags(list(kernel_flags))

    def run(on):
        flags.set_flags({f: on for f in kernel_flags})
        try:
            model, opt, step = build()
            start = None if on else [p.detach().clone()
                                     for p in model.parameters()]
            first = []
            apply = opt.apply_updates

            def recording(pairs):
                # the step's first run is its eager build
                pairs = list(pairs)
                if not first:
                    first.extend(g.detach().clone() for _, g in pairs)
                return apply(pairs)
            opt.apply_updates = recording
            ck.launch_counts(reset=True)
            losses = [float(step(i)[0]) for i in range(steps)]
            torch.cuda.synchronize()
            launches = ck.launch_counts()
        finally:
            flags.set_flags(saved)
        params = [p.detach() for p in model.parameters()]
        require(len(first) == len(params), "%s: %d gradients for %d "
                "parameters" % (label, len(first), len(params)))
        return (losses, params, launches, start, first,
                [n for n, _ in model.named_parameters()])
    kl, kp, kla, _, kg, _ = run(True)
    pl, pp, pla, start, pg, names = run(False)
    require(sum(pla.values()) == 0, "%s: the plain run launched %s"
            % (label, pla))
    require(all(kla[k] > 0 for k in must_launch),
            "%s: the kernel run launched %s" % (label, kla))
    norms = [g.double().norm().item() for g in pg]
    floor = TRAIN_GRAD_FLOOR * math.sqrt(sum(n * n for n in norms))
    ratios = [(a - b).double().norm().item() / max(n, floor)
              for a, b, n in zip(kg, pg, norms)]
    order = sorted(range(len(names)), key=lambda i: -ratios[i])
    low = [i for i in order if norms[i] < floor]
    top = [i for i in order if norms[i] >= floor][:4]
    say("%s step 1 gradients, kernels vs plain (same weights, same batch): "
        "||g_k - g_p|| / ||g_p|| per parameter, the largest %s (tol %.0e); "
        "%d parameters with ||g_p|| below %.0e of the model's %.4g held "
        "against that: largest %s"
        % (label, ", ".join("%s %.3g" % (names[i], ratios[i]) for i in top),
           TRAIN_GRAD_TOL, len(low), TRAIN_GRAD_FLOOR,
           floor / TRAIN_GRAD_FLOOR,
           "%.3g (%s)" % (ratios[low[0]], names[low[0]]) if low else "-"))
    worst_g = order[0]
    require(ratios[worst_g] <= TRAIN_GRAD_TOL, "%s: step 1 gradients of %s "
            "differ by %.3g of their norm" % (label, names[worst_g],
                                              ratios[worst_g]))
    quiet = None
    if near_zero is not None:
        quiet = [g.abs() <= near_zero * g.float().pow(2).mean().sqrt()
                 for g in pg]
    del kg, pg
    rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    diffs = [(a - b).abs() for a, b in zip(kp, pp)]
    if quiet:
        noisy = max(d[q].max().item() if bool(q.any()) else 0.0
                    for d, q in zip(diffs, quiet))
        diffs = [d.masked_fill(q, 0.0) for d, q in zip(diffs, quiet)]
    worst = max(range(len(diffs)), key=lambda i: diffs[i].max().item())
    diff = diffs[worst].max().item()
    # control: what a kernel run that never updated would differ by
    moved = max((a - b).abs().max().item() for a, b in zip(pp, start))
    say("%s kernels vs plain (float32, no dropout, %d steps, flags %s): "
        "losses %s vs %s, max rel diff %.3g (tol 1e-4); max parameter diff "
        "%.3g (tol %.0e, in %s), against the plain run's own movement %.3g"
        % (label, steps, "+".join(kernel_flags), ["%.6f" % x for x in kl],
           ["%.6f" % x for x in pl], rel, diff, TRAIN_PARAM_TOL,
           names[worst], moved))
    if quiet:
        n = sum(int(q.sum()) for q in quiet)
        total = sum(q.numel() for q in quiet)
        say("%s: %d of %d elements with a first-step |g| <= %g of their "
            "parameter's gradient RMS (Adam's step there follows a sign "
            "that one flipped ReLU can turn) held within %.0e: max diff "
            "%.3g"
            % (label, n, total, near_zero, 2 * steps * TRAIN_LR, noisy))
        require(noisy <= 2 * steps * TRAIN_LR, "%s: a near-zero-gradient "
                "element moved %.3g apart" % (label, noisy))
    require(rel <= 1e-4, "%s: kernel and plain losses differ by %.3g"
            % (label, rel))
    require(moved > TRAIN_PARAM_TOL, "%s: the parameters moved %.3g, "
            "within the tolerance: the check would not see a skipped update"
            % (label, moved))
    require(diff <= TRAIN_PARAM_TOL, "%s: parameters differ by %.3g"
            % (label, diff))


def train_compare(torch, ck, flags, fused=False):
    """GPT-2 kernels vs plain: the same float32 weights, no dropout, B=4,
    T=512, 3 AdamW steps; with `fused`, the kernel run has both fused
    flags on too."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import (GPT_CONFIGS, GPTPretrainingCriterion,
                                         gpt2_small)
    B, lr = 4, TRAIN_LR
    vocab = GPT_CONFIGS["gpt2-small"]["vocab_size"]
    data = [torch.from_numpy(token_stream_batch(np, vocab, B, TRAIN_T, s))
            .cuda() for s in range(3)]

    def build():
        prandom.seed(0)
        model = gpt2_small(seed=0, attn_dropout_prob=0.0,
                           hidden_dropout_prob=0.0)
        model.train()
        opt = optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=model.parameters())
        crit = GPTPretrainingCriterion()
        step = make_train_step(model, lambda o, l: crit(o, l), opt)
        return model, opt, lambda i: step([data[i][:, :-1]],
                                          [data[i][:, 1:]])
    kernel_flags = ("use_flash_attention", "use_fused_optimizer")
    must = ("flash_fwd_train", "flash_bwd_dkv", "adamw")
    if fused:
        kernel_flags += ("use_fused_dropout_ln", "fused_block")
        must += FUSED_KERNELS
    compare_runs(torch, ck, flags, "train fused" if fused else "train",
                 build, kernel_flags, must)


def token_stream_batch(np, vocab, B, T, n):
    """Batch n of the bench's token stream: samples n*B .. n*B+B-1."""
    return np.stack([np.random.RandomState(i).randint(0, vocab, (T + 1,))
                     for i in range(n * B, n * B + B)]).astype(np.int64)


# ---------------------------------------------------------------------------
# fused bias + dropout + residual (+ LayerNorm): rows 4-6


FDRLN_MODES = ("upscale_in_train", "downscale_in_infer")


def fdrln_scale(p, mode):
    """The kernels' keep scale for dropout p in training (reference:
    fused_bias_dropout_residual_ln_arrays)."""
    if mode == "downscale_in_infer":
        return 1.0
    return float(np.float32(1.0 / (1.0 - p))) if p < 1.0 else 0.0


def check_fused(torch, ck, flags, gen):
    """Rows 4-6 against their plain versions fed the kernels' own bits:
    float32, bfloat16 and mixed x/residual types, Hd 64, 768 and 1000,
    p 0, 0.1 and 1, both modes; row 6 also at path B's shape; the keep
    decisions bit-equal; the gates raising on inputs the kernels do not
    take."""
    names = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
             "fused_dropout_ln_bwd")
    names += tuple(n + ck.F16 for n in names)
    worst = {n: 0.0 for n in names}             # relative, for the checks
    worst_abs = {n: 0.0 for n in names}         # absolute, for the table

    def hold(what, name, pairs, tol):
        # the instance launched is named by the rows' type (x, or z)
        if pairs and pairs[0][0].dtype == torch.float16:
            name += ck.F16
        torch.cuda.synchronize()
        for a, b in pairs:
            require(a.dtype == b.dtype and a.shape == b.shape
                    and bool(torch.isfinite(a.float()).all()),
                    what + ": type, shape or non-finite")
        ea, er = (max(v) for v in zip(*(abs_rel_err(a, b) for a, b in pairs)))
        require(er <= tol, what + ": rel err %.3g > %.3g" % (er, tol))
        worst[name] = max(worst[name], er)
        worst_abs[name] = max(worst_abs[name], ea)

    types = (("float32", torch.float32, torch.float32),
             ("bfloat16", torch.bfloat16, torch.bfloat16),
             ("mixed", torch.bfloat16, torch.float32),
             ("mixed", torch.float32, torch.bfloat16),
             ("float16", torch.float16, torch.float16),
             ("mixed", torch.float16, torch.float32),
             ("mixed", torch.float32, torch.float16))
    n = 0
    for N, Hd in ((301, 64), (4096, 768), (67, 1000)):
        bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
        require(torch.equal(bits, ck.fused_dropout_bits_plain(
            SEED, OFFSET, N, Hd, device="cuda")), "fused_dropout_bits "
            "[%d, %d] differ from the plain Philox" % (N, Hd))
        for tname, xdt, rdt in types:
            tol = FDRLN_F32_REL_TOL if xdt == torch.float32 else \
                FDRLN_BF16_REL_TOL
            x = torch.randn((N, Hd), generator=gen, device="cuda").to(xdt)
            res = torch.randn((N, Hd), generator=gen, device="cuda").to(rdt)
            vec = lambda s, o: (torch.randn(Hd, generator=gen, device="cuda")
                                * s + o).to(rdt)
            bias, gamma, beta = vec(1.0, 0.0), vec(0.1, 1.0), vec(1.0, 0.0)
            dy = torch.randn((N, Hd), generator=gen, device="cuda").to(xdt)
            dz = torch.randn((N, Hd), generator=gen, device="cuda").to(rdt)
            for p in (0.0, DROPOUT, 1.0):
                for mode in FDRLN_MODES:
                    s = fdrln_scale(p, mode)
                    what = "%s x=%s res=%s N=%d Hd=%d p=%g %s" % (
                        "%s", xdt, rdt, N, Hd, p, mode)
                    y, z = ck.fused_dropout_ln_fwd(x, res, bias, gamma, beta,
                                                   p, s, 1e-5, WORD, DELTA)
                    z1 = ck.fused_dropout_residual_fwd(x, res, bias, p, s,
                                                       WORD, DELTA)
                    yp, zp = ck.fused_dropout_ln_fwd_plain(
                        x, res, bias, gamma, beta, p, s, 1e-5, bits=bits)
                    z1p = ck.fused_dropout_residual_fwd_plain(
                        x, res, bias, p, s, bits=bits)
                    outs = {"fused_dropout_ln_fwd": [(y, yp), (z, zp)],
                            "fused_dropout_residual_fwd": [(z1, z1p)],
                            "fused_dropout_ln_bwd": []}
                    for g, dzx in ((gamma, dz), (None, dz), (gamma, None)):
                        got = ck.fused_dropout_ln_bwd(z, dy, dzx, g, p, s,
                                                      1e-5, WORD, DELTA)
                        want = ck.fused_dropout_ln_bwd_plain(
                            z, dy, dzx, g, p, s, 1e-5, bits=bits)
                        outs["fused_dropout_ln_bwd"] += [
                            (a, b) for a, b in zip(got, want)
                            if b is not None]
                        require(all(a is None for a, b in zip(got, want)
                                    if b is None),
                                "fused_dropout_ln_bwd: dgamma without LN")
                        # keep decisions: the dropped dx are exactly 0
                        keep = bits >= min(int(p * 2 ** 32), 2 ** 32 - 1)
                        if p > 0.0 and s > 0.0:
                            nz = (got[1] != 0) & keep
                            require(torch.equal(got[0] != 0, nz),
                                    (what % "fused_dropout_ln_bwd")
                                    + ": keep mask differs from the bits")
                    for name, pairs in outs.items():
                        hold(what % name, name, pairs, tol)
                    n += 1
        # the forward's keep decisions: ones + 0 residual is 0 where dropped
        ones, zeros = (torch.ones((N, Hd), device="cuda"),
                       torch.zeros((N, Hd), device="cuda"))
        for p in (DROPOUT, 0.5):
            z1 = ck.fused_dropout_residual_fwd(ones, zeros, None, p, 1.0,
                                               WORD, DELTA)
            require(torch.equal(z1 != 0, bits >= int(p * 2 ** 32)),
                    "fused_dropout_residual_fwd: keep mask differs from the "
                    "bits at p=%g" % p)
    # the backward at path B's shape, the only one of these where a warp
    # takes two 4-row groups (2048 groups on a grid of one CTA of 8 warps
    # an SM): its column sums run across groups, and it loads the next
    # group's first row ahead. With LN and dz_extra, and without LN, as
    # the main path calls it; also without LN with dz_extra, and float32.
    # The forward with LN there too (bf16 is path B's own case; path A's,
    # N=4096 f32, is in the cases above), where a warp of its persistent
    # grid may take more than one group.
    N, Hd, s = 8192, 768, fdrln_scale(DROPOUT, "upscale_in_train")
    bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
    nb = 0
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        tol = FDRLN_F32_REL_TOL if dt == torch.float32 else FDRLN_BF16_REL_TOL
        x, res, beta = (torch.randn(shape, generator=gen, device="cuda")
                        .to(dt) for shape in ((N, Hd), (N, Hd), Hd))
        gamma = (torch.randn(Hd, generator=gen, device="cuda") * 0.1
                 + 1.0).to(dt)
        got = ck.fused_dropout_ln_fwd(x, res, None, gamma, beta, DROPOUT, s,
                                      1e-5, WORD, DELTA)
        want = ck.fused_dropout_ln_fwd_plain(x, res, None, gamma, beta,
                                             DROPOUT, s, 1e-5, bits=bits)
        hold("fused_dropout_ln_fwd %s N=%d Hd=%d p=%g" % (dt, N, Hd, DROPOUT),
             "fused_dropout_ln_fwd", list(zip(got, want)), tol)
        z, dy, dz = (torch.randn((N, Hd), generator=gen, device="cuda").to(dt)
                     for _ in range(3))
        for g, dzx in ((gamma, dz), (None, None), (None, dz)):
            got = ck.fused_dropout_ln_bwd(z, dy, dzx, g, DROPOUT, s, 1e-5,
                                          WORD, DELTA)
            want = ck.fused_dropout_ln_bwd_plain(z, dy, dzx, g, DROPOUT, s,
                                                 1e-5, bits=bits)
            hold("fused_dropout_ln_bwd %s N=%d Hd=%d p=%g LN=%s dz_extra=%s"
                 % (dt, N, Hd, DROPOUT, g is not None, dzx is not None),
                 "fused_dropout_ln_bwd",
                 [(a, b) for a, b in zip(got, want) if b is not None], tol)
            nb += 1
    check_mask_identity(torch, ck)
    extra = {"fused_dropout_ln_fwd": " and 3 at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32, f16)" % DROPOUT,
             "fused_dropout_ln_bwd": " and %d at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32, f16; with LN and dz_extra, without LN with "
             "and without dz_extra)" % (nb, DROPOUT)}
    for name in names:
        say("check %s: max rel err %.3g (tol f32 %.0e, bf16 and f16 %.0e, "
            "by the output's type), max abs err %.3g, over %d cases (f32, "
            "bf16, f16, mixed with f32; Hd 64, 768, 1000; p 0, %g, 1; both "
            "modes; the _f16 instance where the rows are float16)%s"
            % (name, worst[name], FDRLN_F32_REL_TOL, FDRLN_BF16_REL_TOL,
               worst_abs[name], n, DROPOUT,
               extra.get(name.replace(ck.F16, ""), "")))
    # the drop rate and the gates
    bits = ck.fused_dropout_bits(WORD, DELTA, 8192, 768)
    rate = (bits < int(DROPOUT * 2 ** 32)).double().mean().item()
    require(abs(rate - DROPOUT) <= DROP_RATE_TOL,
            "fused dropout rate %.5f, want %.3f +- %.3f"
            % (rate, DROPOUT, DROP_RATE_TOL))
    say("check fused_dropout_bits: bit-equal to the plain Philox; drop rate "
        "%.5f at [8192, 768] (want %.3f +- %.3f); keep decisions of the "
        "forward and backward bit-equal to the bits" % (rate, DROPOUT,
                                                        DROP_RATE_TOL))
    big = torch.zeros((4, ck.FDRLN_MAX_HD + 1), device="cuda")
    x = torch.zeros((8, 64), device="cuda")
    v = torch.ones(64, device="cuda")
    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    # the public routes, which take the kernels while the flag is on
    from paddle_tpu_torch.incubate.nn import functional as IF

    def gate(x, r, g, b):
        return IF.fused_bias_dropout_residual_layer_norm(x, r, None, g, b,
                                                         dropout_rate=0.1)
    bad = [("Hd above the limit", lambda: IF.fused_bias_dropout_residual(
               big, big, dropout_rate=0.1)),
           ("bfloat16 with float16", lambda: gate(x.half(), x.bfloat16(),
                                                  v, v)),
           ("mismatched shapes", lambda: gate(x, x[:4], v, v)),
           ("gamma of another width",
            lambda: ck.fused_bias_dropout_residual_ln(
                x, x, None, v[:32], v, 0.1, 1e-5, True,
                "upscale_in_train")),
           ("bfloat16 with float16 backward", lambda: ck.fused_dropout_ln_bwd(
               x.half(), x.half(), None, v.bfloat16(), 0.1, 1.0, 1e-5)),
           ("float64", lambda: gate(x.double(), x, v, v))]
    before = ck.launch_counts()
    try:
        for what, call in bad:
            try:
                call()
            except ValueError:
                continue
            raise SystemExit("chip_smoke FAILED: a fused gate took %s on the "
                             "card without raising" % what)
    finally:
        flags.set_flags(saved)
    require(ck.launch_counts() == before, "a rejected input launched")
    say("check fused gates: %d inputs the kernels do not take raise on the "
        "card" % len(bad))
    return worst_abs


def check_mask_identity(torch, ck):
    """Row 6 regenerates row 4's mask: at path B's shape (bf16, N=8192) and
    path A's (f32, N=4096), the forward with LN drops h = 1 (x = 1, no
    bias, residual 0) exactly where the bits say, so z is 0 exactly there;
    the backward with LN from the same (seed, offset), fed dy = 0 and
    dz_extra = 1 (so dz = 1), gives dx = 0 exactly there too."""
    s = fdrln_scale(DROPOUT, "upscale_in_train")
    for N, dt in ((8192, torch.bfloat16), (4096, torch.float32)):
        Hd = 768
        ones = torch.ones((N, Hd), device="cuda", dtype=dt)
        zeros = torch.zeros((N, Hd), device="cuda", dtype=dt)
        g, b = ones[0].clone(), zeros[0].clone()
        _, z = ck.fused_dropout_ln_fwd(ones, zeros, None, g, b, DROPOUT, s,
                                       1e-5, WORD, DELTA)
        dropped = z == 0
        bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
        require(torch.equal(dropped, bits < int(DROPOUT * 2 ** 32)),
                "fused_dropout_ln_fwd %s N=%d: dropped elements differ from "
                "the bits" % (dt, N))
        dx = ck.fused_dropout_ln_bwd(z, zeros, ones, g, DROPOUT, s, 1e-5,
                                     WORD, DELTA)[0]
        require(torch.equal(dx == 0, dropped),
                "fused_dropout_ln_bwd %s N=%d: dx is not zero exactly where "
                "the forward dropped h" % (dt, N))
        say("check mask identity %s N=%d Hd=%d p=%g: the forward with LN "
            "dropped %d elements, the bits' own; the backward's dx is zero "
            "at exactly those" % (str(dt).split(".")[-1], N, Hd, DROPOUT,
                                  int(dropped.sum())))


def time_fused(torch, ck, timer, gen, N, Hd, dtype, dz_extra, label):
    """Device times of rows 4-6 at one path's shape: x, residual and the
    LN vectors in `dtype`, no bias (the model's tails pass none), p=0.1,
    upscale_in_train; the backward with LN (dz_extra: whether z's own
    cotangent is passed, as the fused_block pair does and the post-LN
    tail does not) and without. The yardstick is the composed route the
    flag replaces, in PyTorch's own ops: residual +
    torch.nn.functional.dropout(x), then torch.nn.functional.layer_norm,
    and its autograd backward."""
    tF = torch.nn.functional
    mk = lambda: torch.randn((N, Hd), generator=gen, device="cuda").to(dtype)
    x, res, dy, dz = mk(), mk(), mk(), mk()
    g = (1.0 + 0.1 * torch.randn(Hd, generator=gen, device="cuda")).to(dtype)
    b = torch.randn(Hd, generator=gen, device="cuda").to(dtype)
    p, s = DROPOUT, fdrln_scale(DROPOUT, "upscale_in_train")
    bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
    y, z = ck.fused_dropout_ln_fwd(x, res, None, g, b, p, s, 1e-5, WORD,
                                   DELTA)
    dzx = dz if dz_extra else None
    esize = x.element_size()
    rows = N * Hd * esize
    vecs = Hd * esize
    flop = N * Hd

    lx, lr, lg, lb = (t.detach().clone().requires_grad_()
                      for t in (x, res, g, b))
    lz = lr + tF.dropout(lx, p)
    ly = tF.layer_norm(lz, (Hd,), lg, lb, 1e-5)
    cot = (dy, dz) if dz_extra else (dy,)
    outs = (ly, lz) if dz_extra else (ly,)
    out = {}
    # row 4: reads x, res, gamma, beta; writes y, z; ~10 flops an element
    bound, by = bound_ms(4 * rows + 2 * vecs, 10 * flop, "float32")
    out["fused_dropout_ln_fwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_ln_fwd(
            x, res, None, g, b, p, s, 1e-5, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_fwd_plain(
            x, res, None, g, b, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: tF.layer_norm(
            res + tF.dropout(x, p), (Hd,), g, b, 1e-5)),
        "bound_ms": bound, "bound_by": by}
    # row 5: reads x, res; writes z; 2 flops an element
    bound, by = bound_ms(3 * rows, 2 * flop, "float32")
    out["fused_dropout_residual_fwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_residual_fwd(
            x, res, None, p, s, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_residual_fwd_plain(
            x, res, None, p, s, bits=bits)),
        "library_ms": timer.ms(lambda: res + tF.dropout(x, p)),
        "bound_ms": bound, "bound_by": by}
    # row 6 with LN: reads z, dy (, dz_extra), gamma; writes dx, dres and
    # dbias, dgamma, dbeta; ~16 flops an element
    nrows = 4 + (1 if dz_extra else 0)
    bound, by = bound_ms(nrows * rows + 4 * vecs, 16 * flop, "float32")
    out["fused_dropout_ln_bwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_ln_bwd(
            z, dy, dzx, g, p, s, 1e-5, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_bwd_plain(
            z, dy, dzx, g, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            outs, (lx, lr, lg, lb), cot, retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    noln = {"ms": timer.ms(lambda: ck.fused_dropout_ln_bwd(
                z, dy, None, None, p, s, 1e-5, WORD, DELTA)),
            "bound_ms": bound_ms(3 * rows + vecs, 2 * flop, "float32")[0]}
    for name, t in out.items():
        say("time %s %s N=%d Hd=%d %s p=%g%s: %.4f ms, plain %.4f ms, "
            "composed torch route %.4f ms, bound %.4f ms (%s)"
            % (name, label, N, Hd, str(dtype).split(".")[-1], p,
               " dz_extra" if dz_extra and name.endswith("bwd") else "",
               t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
    say("time fused_dropout_ln_bwd without LN %s N=%d Hd=%d: %.4f ms, bound "
        "%.4f ms (bytes)" % (label, N, Hd, noln["ms"], noln["bound_ms"]))
    # the backward's partial rows (one float32 row per column sum and CTA,
    # written by the kernel and read by its column-sum kernel), which the
    # bound above does not count
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = ck._fdrln_bwd_grid(N, "cuda")
    for what, nacc in (("with LN", 3), ("without LN", 1)):
        say("fused_dropout_ln_bwd %s %s N=%d Hd=%d: grid %d CTAs on %d SMs, "
            "partial rows %d x %d x %d float32 = %d bytes written, then read "
            "by the column-sum kernel"
            % (what, label, N, Hd, grid, sms, grid, nacc, Hd,
               4 * grid * nacc * Hd))
    return out


# ---------------------------------------------------------------------------
# ERNIE-base pretraining (path A)


def ernie_batch(torch, vocab, B, T):
    """The ERNIE bench's batch (benchmarks/train_bench.py bench_ernie):
    ids from RandomState(0), every fifth MLM label -100, random NSP
    labels."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (B, T)).astype(np.int64)
    labels = ids.copy()
    labels[:, ::5] = -100
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    to = lambda a: torch.from_numpy(a).cuda()
    return [to(ids)], [to(labels), to(nsp)]


def ernie_main(torch, ck, flags, card):
    """Path A: the JAX package's ERNIE bench on the port: ernie_base at full
    width and depth (seeded weights, dropouts 0.1), B=32, T=128,
    AdamW(lr=1e-4, weight_decay=0.01), make_train_step with the MLM + NSP
    criterion, under amp.auto_cast(level="O2") with float32 parameters,
    FLAGS_use_fused_dropout_ln on, through `run_path`; then the captured
    step against its eager bodies at dropout 0.1 and, on a fresh model, at
    0. Returns the launch counts."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    crit = BertPretrainingCriterion()
    loss_fn = lambda lg, nl, y1, y2: crit(lg, nl, y1, y2)  # noqa: E731
    ctx = lambda: amp.auto_cast(level="O2")  # noqa: E731

    def build(**kw):
        net = ernie_base(seed=0, **kw)
        net.train()
        prandom.seed(0)
        return net, optimizer.AdamW(parameters=net.parameters(),
                                    learning_rate=1e-4, weight_decay=0.01)
    try:
        t0 = time.perf_counter()
        net, opt = build()
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        n_params = sum(p.numel() for p in net.parameters())
        n_tensors = len(list(net.parameters()))
        say("ernie: ernie-base %d parameters (%d tensors) in %s, built in "
            "%.1f s" % (n_params, n_tensors, next(net.parameters()).dtype,
                        time.perf_counter() - t0))
        L = len(net.bert.layers)
        want = {"fused_dropout_ln_fwd": 2 * L, "fused_dropout_ln_bwd": 2 * L,
                "flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": adamw_launches(net.parameters()),
                "fused_dropout_residual_fwd": 0,
                # the feed-forward's activation dropout a layer and the
                # embeddings' dropout
                "dropout_keep": L + 1}
        tokens = ERNIE_B * ERNIE_T
        d = net.bert.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * ERNIE_T * tokens
        launches, paths, _, (logits, _), bodies = run_path(
            torch, ck, "ernie", card, net, opt, loss_fn, lambda: batch, ctx,
            tokens, flops, want)
        require(logits.dtype == torch.float32
                and tuple(logits.shape) == (ERNIE_B, ERNIE_T, vocab),
                "ernie: logits %s %s" % (logits.dtype, tuple(logits.shape)))
        # the path counters count bodies run in Python, as the reference's
        # count rises at trace time
        require(paths["flash_dropout"] == L * bodies
                and paths["xla_sdpa"] == 0 and paths["flash"] == 0,
                "ernie: attention paths %s" % paths)
        free_memory(torch)
        graph_against_eager_train(torch, ck, "ernie", net, opt, loss_fn,
                                  [batch, batch], ctx, DROPOUT)
        ernie_masked(torch, ck, flags, net, batch[0][0], ctx)
        del net, opt
        free_memory(torch)
        net, opt = build(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        graph_against_eager_train(torch, ck, "ernie", net, opt, loss_fn,
                                  [batch, batch], ctx, 0.0)
        del net, opt
        free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches


def ernie_masked(torch, ck, flags, net, ids, ctx):
    """One ERNIE forward in eval mode with a [B, T] padding mask (half of
    row 1 padded) and use_flash_attention on: every layer takes the plain
    attention (path xla_sdpa), as the reference's gate hands a masked call
    to its composed attention; no flash kernel launches; the output is
    bit-equal to the same call with the flag off."""
    B, T = ids.shape
    pad = torch.ones((B, T), dtype=torch.int64, device="cuda")
    pad[1, T // 2:] = 0
    L = len(net.bert.layers)
    outs = {}
    net.eval()
    try:
        for on in (True, False):
            flags.set_flags({"use_flash_attention": on})
            launches0 = ck.launch_counts()
            paths0 = ck.attention_path_counts()
            with torch.no_grad(), ctx():
                seq, _ = net.bert(ids, attention_mask=pad)
            torch.cuda.synchronize()
            paths = {k: v - paths0[k]
                     for k, v in ck.attention_path_counts().items()}
            outs[on] = (seq, ck.launch_delta(launches0), paths)
    finally:
        flags.set_flags({"use_flash_attention": True})
        net.train()
    seq, launches, paths = outs[True]
    require(paths["xla_sdpa"] == L and paths["flash"] == 0
            and paths["flash_dropout"] == 0,
            "ernie masked forward: attention paths %s, want %d xla_sdpa"
            % (paths, L))
    require(not any(n for k, n in launches.items() if k.startswith("flash")),
            "ernie masked forward launched a flash kernel: %s" % launches)
    require(torch.equal(seq, outs[False][0]),
            "ernie masked forward: flag on and off differ")
    require(bool(torch.isfinite(seq).all()), "ernie masked forward: "
            "non-finite output")
    say("ernie masked forward: [B=%d, T=%d] padding mask (row 1 half "
        "padded), use_flash_attention on: %d xla_sdpa, no flash launch, "
        "output %s %s bit-equal to the flag off"
        % (B, T, paths["xla_sdpa"], tuple(seq.shape), seq.dtype))


def ernie_compare(torch, ck, flags):
    """Path A's kernels against the plain versions on the card: the same
    float32 ernie-base weights, no dropout, the bench's batch, 3 AdamW
    steps at lr 1e-4, without auto_cast."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    def build():
        prandom.seed(0)
        net = ernie_base(seed=0, hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0)
        net.train()
        opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                              parameters=net.parameters())
        crit = BertPretrainingCriterion()
        step = make_train_step(
            net, lambda lg, nl, y1, y2: crit(lg, nl, y1, y2), opt)
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        return net, opt, lambda i: step(*batch)
    compare_runs(torch, ck, flags, "ernie", build,
                 ("use_flash_attention", "use_fused_optimizer",
                  "use_fused_dropout_ln"),
                 ("flash_fwd_train", "flash_bwd_dkv", "adamw",
                  "fused_dropout_ln_fwd", "fused_dropout_ln_bwd"))
# ---------------------------------------------------------------------------
# guards and eval on the training main path (phase 16)

GUARD_WATCHDOG_S, GUARD_HANG_S = 0.5, 1.5
EVAL_STEPS = 10
# make_eval_step's bfloat16 logits against the same forward through the
# plain attention: each of the 12 layers rounds its attention output to
# bfloat16 from float32 sums in another order (REL_TOL["bfloat16"] for one
# call), and the residual stream carries every layer's difference on to
# the logits, so the whole forward is held to four times one call's
# tolerance, relative to the largest logit
EVAL_LOGITS_REL_TOL = 4 * REL_TOL["bfloat16"]


def check_all_finite(torch, all_finite):
    """The guard's test on the card: no NaN, no inf, with float32 and
    bfloat16 gradients, alone or in one of 150 tensors (several launches
    of the multi-tensor pass); 3e38 (finite, where a norm or a sum
    overflows) is no false skip."""
    big = torch.full((4096,), 3e38, device="cuda")
    one = torch.ones((), device="cuda")
    require(bool(all_finite(one, [big, big.bfloat16()])),
            "all_finite: 3e38 read as non-finite")
    for bad in (float("nan"), float("inf"), -float("inf")):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(768 * 768, device="cuda").to(dtype)
            g[12345] = bad
            require(not bool(all_finite(one, [big, g])),
                    "all_finite missed %r in %s" % (bad, dtype))
            many = [torch.randn(65536 + i, device="cuda").to(dtype)
                    for i in range(150)]
            require(bool(all_finite(one, many)),
                    "all_finite: finite %s tensors read as non-finite"
                    % dtype)
            many[97][40000] = bad
            require(not bool(all_finite(one, many)),
                    "all_finite missed %r in tensor 97 of 150 %s"
                    % (bad, dtype))
        require(not bool(all_finite(torch.tensor(bad, device="cuda"),
                                    [big])),
                "all_finite missed a %r loss" % bad)


def gpu_state():
    """The card's SM clock, its maximum, temperature and power draw, as
    nvidia-smi reads them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines() or ["not read"])[0] \
        if smi.returncode == 0 else "not read"


def replay_ms(torch, programs, n):
    """Device ms of each of n replays of `programs`' one graph (CUDA
    events around the replay alone), with no host work between them."""
    (graph,) = programs._graphs.values()
    out = []
    for _ in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def guard_profile(torch, steps, batch):
    """One profiled step made with the guard off and one with it on:
    ({on: (kernel ms, kernels launched)}, the guard-on step's kernels
    that the guard-off step does not run, as (us, count, name) rows)."""
    out, rows = {}, {}
    for on in (False, True):
        dev_ms, rows[on] = profile_step(torch, steps[on], batch)
        out[on] = (dev_ms, sum(n for _, _, n in rows[on]))
    known = {key for _, key, _ in rows[False]}
    return out, [(t, n, key) for t, key, n in rows[True] if key not in known]


def guards_main(torch, ck, flags, card, off_ms, off_launches):
    """Phase 16 (see the module's note): the non-finite guard, its NaN
    drill, the watchdog and OOM drills through the captured GPT-2 step,
    and make_eval_step, on phase 10's configuration built again."""
    import glob
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import (EvalStep, TrainStep, make_eval_step,
                                      make_train_step)
    from paddle_tpu_torch.jit.engine import all_finite
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.observability import flight, metrics, tracing
    from paddle_tpu_torch.resilience import chaos, watchdog

    check_all_finite(torch, all_finite)
    names = ["skip_nonfinite_steps", "step_watchdog_s",
             "step_watchdog_action"]
    saved = flags.get_flags(names)
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    prandom.seed(0)
    model = gpt2_small(seed=0)
    model.train()
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    L = len(model.gpt.layers)
    loader = io.DataLoader(token_stream(io, model.gpt.vocab_size, TRAIN_T),
                           batch_size=TRAIN_B, prefetch_to_device=2)
    it = iter(loader)

    def batch():
        ids = next(it)
        return [ids[:, :-1]], [ids[:, 1:]]
    params = list(model.parameters())

    def snapshot():
        moments = [a for p in params
                   for a in opt._get_accumulators(p).values()]
        return ([p.detach().clone() for p in params],
                [m.clone() for m in moments])

    def restore(state, rng):
        with torch.no_grad():
            moments = [a for p in params
                       for a in opt._get_accumulators(p).values()]
            for t, v in zip(params + moments, state[0] + state[1]):
                t.copy_(v)
        opt._step_count = 0
        prandom.set_rng_state(rng)

    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a[0] + a[1], b[0] + b[1]))
    counters0 = (tracing.RETRACES.labels("jit_train").value,
                 tracing.RETRACES.labels("jit_eval").value,
                 tracing.TRAIN_STEPS.value)
    ran = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guards_")
    try:
        # (1) the guard's cost: steps made with the guard off and on, each
        # first run as phase 10's (3 warm-up + 10 timed; its launches
        # checked against phase 10's), then in pairs, one step of each
        # with the order flipped every pair, so that a card or a host that
        # drifts during the phase moves both alike
        steps = {}
        for on in (False, True):
            flags.set_flags({"skip_nonfinite_steps": on})
            steps[on] = make_train_step(model, loss_fn, opt)
        n = TRAIN_WARMUP + TRAIN_STEPS
        for on in (False, True):
            before = ck.launch_counts()
            losses, _, _ = timed_steps(torch, steps[on], batch, TRAIN_WARMUP,
                                       TRAIN_STEPS)
            launches = ck.launch_delta(before)
            ran += n
            require(all(math.isfinite(x) for x in losses),
                    "guards (1): losses %s" % losses)
            require(launches == off_launches,
                    "guards (1) guard %s: launches %s, phase 10's %s"
                    % (on, launches, off_launches))
        state0 = gpu_state()
        times = {False: [], True: []}
        for i in range(2 * TRAIN_STEPS):
            for on in (False, True) if i % 2 == 0 else (True, False):
                times[on] += timed_steps(torch, steps[on], batch, 0, 1)[1]
                ran += 1
        # the replays alone, in the same pairs: the step's device time with
        # the gaps between its kernels, and none of the host's work
        rep = {False: [], True: []}
        for i in range(2 * TRAIN_STEPS):
            for on in (False, True) if i % 2 == 0 else (True, False):
                rep[on] += replay_ms(torch, steps[on].programs, 1)
        state1 = gpu_state()
        require(steps[True].skipped_steps == 0,
                "guards (1): %d steps skipped" % steps[True].skipped_steps)
        step_g = steps[True]
        off_t, on_t = (statistics.median(times[k]) for k in (False, True))
        off_r, on_r = (statistics.median(rep[k]) for k in (False, True))
        pair_t = statistics.median(b - a for a, b in zip(times[False],
                                                        times[True]))
        pair_r = statistics.median(b - a for a, b in zip(rep[False],
                                                        rep[True]))
        prof, added = guard_profile(torch, steps, batch)
        ran += 2
        progs = step_g.programs
        (key,) = progs.builds
        say("guards (1) captured step, skip_nonfinite_steps off / on, %d "
            "pairs of steps: %.2f / %.2f ms median, the pairs' difference "
            "%+.3f ms median (%+.2f %%); phase 10's guard off %.2f ms; the "
            "graph's replay alone (CUDA events, %d pairs) %.3f / %.3f ms "
            "median, difference %+.3f ms median; port kernel launches a "
            "step %s, as phase 10's, both ways; captured in %.1f ms, graph "
            "pool %.1f MiB; card (SM clock, max SM clock, temperature, "
            "power draw) before the pairs %s, after %s (%s)"
            % (2 * TRAIN_STEPS, off_t, on_t, pair_t, 100.0 * pair_t / off_t,
               off_ms, 2 * TRAIN_STEPS, off_r, on_r, pair_r,
               {k: v // n for k, v in launches.items() if v},
               progs.capture_s[key] * 1e3, progs.pool_bytes() / 2 ** 20,
               state0, state1, card))
        if prof[False][0] > 0 and prof[True][0] > 0:
            (off_dev, off_n), (on_dev, on_n) = prof[False], prof[True]
            say("guards (1) one profiled step each way (torch.profiler): "
                "kernels %.3f / %.3f ms (%+.3f ms; the kernels only the "
                "guard-on step runs %.3f ms), %d / %d kernels launched "
                "(%+d); device idle against the median steps %.3f / %.3f "
                "ms (%+.3f ms) (%s)"
                % (off_dev, on_dev, on_dev - off_dev,
                   sum(t for t, _, _ in added) / 1e3, off_n, on_n,
                   on_n - off_n, off_t - off_dev, on_t - on_dev,
                   (on_t - on_dev) - (off_t - off_dev), card))
            for t_us, cnt, name in sorted(added, reverse=True):
                say("  guard kernel %9.1f us/step %4d launches  %s"
                    % (t_us, cnt, name[:90]))
        else:
            say("guards (1) step profiles: not measured (the profiler saw "
                "no device activity)")
        train_built = steps[False].compiles
        del steps
        free_memory(torch)

        # (2) the NaN drill, captured and through the eager bodies
        state0, rng0 = snapshot(), prandom.get_rng_state()
        fixed = [batch() for _ in range(5)]
        it.close()
        chaos.configure("nan_at_step:3")

        def drill(step):
            out = {"loss": [], "skipped": [], "adamw": [], "state": []}
            for b in fixed:
                mark = ck.launch_counts()
                loss, _ = step(*b)
                torch.cuda.synchronize()
                out["adamw"].append(ck.launch_delta(mark)["adamw"])
                out["loss"].append(loss)
                out["skipped"].append(step.last_step_skipped)
                out["state"].append(snapshot())
            return out
        restore(state0, rng0)
        step_n = make_train_step(model, loss_fn, opt)
        require(step_n.guard and step_n.nan_step == 3,
                "guards (2): the step did not read the drill")
        g = drill(step_n)
        restore(state0, rng0)
        e = drill(eager_train_step(TrainStep)(model, loss_fn, opt))
        chaos.reset()
        ran += 10
        nan = [math.isnan(float(x)) for x in g["loss"]]
        require(nan == [False, False, True, False, False],
                "guards (2): NaN losses at %s" % nan)
        require(g["skipped"] == e["skipped"] == nan
                and step_n.skipped_steps == 1,
                "guards (2): skipped %s (eager %s), skipped_steps %d"
                % (g["skipped"], e["skipped"], step_n.skipped_steps))
        require(same(g["state"][2], g["state"][1]),
                "guards (2): the skipped step changed parameters or moments")
        require(not same(g["state"][3], g["state"][2]),
                "guards (2): step 4 did not move the model")
        require(g["adamw"] == [adamw_launches(model.parameters())] * 5,
                "guards (2): AdamW launches a step %s" % g["adamw"])
        same_loss = lambda a, b: (torch.equal(a, b)  # noqa: E731
                                  or bool(a.isnan() and b.isnan()))
        require(all(same_loss(a, b) for a, b in zip(g["loss"], e["loss"]))
                and all(same(a, b) for a, b in zip(g["state"], e["state"])),
                "guards (2): the captured drill differs from the eager "
                "bodies'")
        say("guards (2) NaN drill (nan_at_step:3, 5 steps through the "
            "captured graph): losses %s, skipped %s, skipped_steps %d; "
            "parameters and moments after step 3 bit-equal to after step 2; "
            "AdamW launches a step %s; every step's loss, parameters and "
            "moments bit-equal to the eager bodies' drill"
            % (["%.4f" % float(x) for x in g["loss"]], g["skipped"],
               step_n.skipped_steps, g["adamw"]))
        del step_n, g, e
        free_memory(torch)

        # (3) the watchdog
        restore(state0, rng0)
        dump = os.path.join(tmp, "watchdog.txt")
        os.environ[watchdog.ENV_FILE] = dump
        flags.set_flags({"step_watchdog_s": GUARD_WATCHDOG_S,
                         "step_watchdog_action": "warn"})
        chaos.configure("hang_at_step:2:%g" % GUARD_HANG_S)
        try:
            wd = [step_g(*fixed[i]) for i in range(2)]
        finally:
            chaos.reset()
            flags.set_flags({"step_watchdog_s": 0.0})
            os.environ.pop(watchdog.ENV_FILE, None)
        ran += 2
        text = open(dump).read() if os.path.exists(dump) else ""
        require("'compiled train step 2' exceeded" in text,
                "guards (3): no watchdog dump names compiled train step 2")
        require(all(math.isfinite(float(x[0])) for x in wd),
                "guards (3): losses %s" % [float(x[0]) for x in wd])
        say("guards (3) watchdog: step_watchdog_s=%g, hang_at_step:2:%g, "
            "warn: %s dumps %d bytes naming compiled train step 2; losses "
            "%s" % (GUARD_WATCHDOG_S, GUARD_HANG_S, os.path.basename(dump),
                    len(text), ["%.4f" % float(x[0]) for x in wd]))

        # (4) the OOM drill
        restore(state0, rng0)
        flight_dir = os.path.join(tmp, "flight")
        os.environ[flight.ENV_DIR] = flight_dir
        flight.reset()
        oom = metrics.REGISTRY.get("pt_oom_total")
        oom0 = oom.value if oom is not None else 0
        chaos.configure("oom:2")
        try:
            step_g(*fixed[0])
            try:
                step_g(*fixed[1])
                raised = None
            except RuntimeError as err:    # the drill's expected failure
                raised = str(err)
            built = (step_g.compiles, step_g.replays)
            after, _ = step_g(*fixed[2])
        finally:
            chaos.reset()
        ran += 2
        require(raised is not None and "RESOURCE_EXHAUSTED" in raised,
                "guards (4): the oom:2 call raised %r" % raised)
        require((step_g.compiles, step_g.replays) == (built[0], built[1] + 1)
                and math.isfinite(float(after)),
                "guards (4): the call after the OOM built %d programs"
                % (step_g.compiles - built[0]))
        bundles = glob.glob(os.path.join(flight_dir, "crash", "*"))
        require(len(bundles) == 1 and os.path.exists(
            os.path.join(bundles[0], "memory.json")),
            "guards (4): bundles %s" % bundles)
        with open(os.path.join(bundles[0], "memory.json")) as f:
            mem = json.load(f)
        n_oom = metrics.REGISTRY.get("pt_oom_total").value - oom0
        require(mem["engine"] == "jit_train" and mem["step"] == 2
                and n_oom == 1 and mem.get("buffers"),
                "guards (4): memory.json engine %s step %s, pt_oom_total "
                "+%d" % (mem["engine"], mem["step"], n_oom))
        say("guards (4) OOM drill (oom:2): the call raised RESOURCE_EXHAUSTED"
            ", bundle %s with memory.json (engine %s, step %d, %d live "
            "blocks, %.1f MiB; jit_train banked %.1f MiB held + %.1f MiB "
            "pool), pt_oom_total +%d; the next call replayed with no build"
            % (os.path.basename(bundles[0]), mem["engine"], mem["step"],
               mem["buffers"]["n_arrays"],
               mem["buffers"]["total_bytes"] / 2 ** 20,
               mem["executables"]["jit_train"]["args_bytes"] / 2 ** 20,
               mem["executables"]["jit_train"]["temp_bytes"] / 2 ** 20,
               n_oom))
        last = dict(flight._last_dispatch or {})
        require(last.get("engine") == "jit_train"
                and last.get("step") == opt._step_count,
                "guards (6): the flight recorder's last dispatch %s, last "
                "step %d" % (last, opt._step_count))
        flight.reset()
        os.environ.pop(flight.ENV_DIR, None)
        train_built += step_g.compiles + 1         # step_n's one program
        del step_g
        free_memory(torch)

        # (5) make_eval_step
        model.eval()
        ev = make_eval_step(model, loss_fn)
        x, y = fixed[0]
        w0 = [p.detach().clone() for p in params]
        mark = ck.launch_counts()
        t0 = time.perf_counter()
        ev(x, y)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        times = []
        for _ in range(EVAL_STEPS):
            t0 = time.perf_counter()
            loss, (logits,) = ev(x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = ck.launch_delta(mark)
        progs = ev.programs
        (key,) = progs.builds
        replayed = {k: progs.replays[key] * v
                    for k, v in progs.launches[key].items()}
        eager_loss, _ = eager_train_step(EvalStep)(model, loss_fn)(x, y)
        # the same forward through the plain attention (the flag off):
        # holds the flash forward's 12 calls a replay to their plain
        # version, through the whole model
        flags.set_flags({"use_flash_attention": False})
        try:
            paths0 = ck.attention_path_counts()
            mark_plain = ck.launch_counts()
            plain_loss, (plain_logits,) = eager_train_step(EvalStep)(
                model, loss_fn)(x, y)
            torch.cuda.synchronize()
            plain_paths = {k: v - paths0[k]
                           for k, v in ck.attention_path_counts().items()}
            plain_launches = ck.launch_delta(mark_plain)
        finally:
            flags.set_flags({"use_flash_attention": True})
        model.train()
        loss_err = abs(float(loss) - float(plain_loss)) / abs(
            float(plain_loss))
        _, logits_err = abs_rel_err(logits, plain_logits)
        del plain_logits
        require(ev.compiles == 1 and ev.replays == EVAL_STEPS,
                "guards (5): %d programs, %d replays" % (ev.compiles,
                                                         ev.replays))
        require(progs.launches[key]["flash_fwd"] == L
                and replayed["flash_fwd"] == EVAL_STEPS * L,
                "guards (5): flash forward launches %s, through replays %s"
                % (progs.launches[key], replayed))
        require(not any(launches[k] for k in ("flash_fwd_train",
                                              "flash_bwd_dq",
                                              "flash_bwd_dkv", "adamw")),
                "guards (5): the eval step launched %s" % launches)
        require(torch.equal(loss, eager_loss)
                and math.isfinite(float(loss)),
                "guards (5): loss %r, eager body %r" % (float(loss),
                                                        float(eager_loss)))
        require(plain_paths["xla_sdpa"] == L and plain_paths["flash"] == 0
                and not any(n for k, n in plain_launches.items()
                            if k.startswith("flash")),
                "guards (5): the flag-off forward took paths %s, launched %s"
                % (plain_paths, plain_launches))
        require(loss_err <= REL_TOL["bfloat16"]
                and logits_err <= EVAL_LOGITS_REL_TOL,
                "guards (5): against the plain attention, loss %.4g vs %.4g "
                "(relative %.3g > %.0e) or logits relative %.3g > %.0e"
                % (float(loss), float(plain_loss), loss_err,
                   REL_TOL["bfloat16"], logits_err, EVAL_LOGITS_REL_TOL))
        require(all(torch.equal(a, b) for a, b in zip(params, w0)),
                "guards (5): the eval step changed a parameter")
        eval_ms = statistics.median(times)
        say("guards (5) make_eval_step gpt2-small B=%d T=%d O2 bf16, eval "
            "mode, with the criterion: built in %.1f s, %.2f ms median over "
            "%d replays (%.2f mean), %.0f tokens/s; loss %.4f bit-equal to "
            "the eager body; against the plain attention (flag off, %d "
            "xla_sdpa): loss %.4f (relative %.3g, tol %.0e), logits max "
            "abs err %.3g of the largest (tol %.0e); logits %s %s; "
            "launches %s (through replays %s); parameters unchanged (%s)"
            % (TRAIN_B, TRAIN_T, build_s, eval_ms, EVAL_STEPS,
               statistics.mean(times), TRAIN_B * TRAIN_T / (eval_ms / 1e3),
               float(loss), plain_paths["xla_sdpa"], float(plain_loss),
               loss_err, REL_TOL["bfloat16"], logits_err,
               EVAL_LOGITS_REL_TOL, tuple(logits.shape), logits.dtype,
               {k: v for k, v in launches.items() if v},
               {k: v for k, v in replayed.items() if v}, card))
        eval_built = ev.compiles
        del ev

        # (6) telemetry
        got = (tracing.RETRACES.labels("jit_train").value - counters0[0],
               tracing.RETRACES.labels("jit_eval").value - counters0[1],
               tracing.TRAIN_STEPS.value - counters0[2])
        require(got == (train_built, eval_built, ran),
                "guards (6): retraces jit_train %d, jit_eval %d, train steps "
                "%d; want %d, %d, %d" % (got + (train_built, eval_built,
                                                ran)))
        say("guards (6) telemetry: jit_train retraces %d = programs built, "
            "jit_eval %d = programs built, pt_train_steps_total +%d = steps "
            "run; the flight recorder's last dispatch named the last step"
            % got)
    finally:
        chaos.reset()
        flags.set_flags(saved)
        os.environ.pop(watchdog.ENV_FILE, None)
        os.environ.pop(flight.ENV_DIR, None)
        shutil.rmtree(tmp, ignore_errors=True)
    del model, opt
    free_memory(torch)
    return on_t, eval_ms


# ---------------------------------------------------------------------------
# resumable training on the training main path (phase 17)

# the resume drill: epochs x steps a run; the preempted run's SIGTERM
# lands before this global step (0-based, in epoch 1), so the run saves
# epoch 1 and stops at its boundary
DRILL_EPOCHS, DRILL_STEPS, DRILL_SIGTERM_STEP = 3, 2, 3
DRILL_TIMEOUT_S = 600
CLIP_PAIRS = 20
# steps timed while an async save's write is in flight, at least
INFLIGHT_STEPS_MIN = 3


def gpt2_recipe(optimizer, parameters, device="cuda", clip=True):
    """The GPT-2 configuration's optimizer: the bench's AdamW(1e-4, weight
    decay 0.01) with the public GPT-2 recipe's warm-up, cosine schedule
    and global-norm clip (nanoGPT's train.py). Returns (optimizer,
    scheduler); the caller steps the scheduler after each train step."""
    from paddle_tpu_torch.optimizer import lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100),
                            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
    opt = optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01, parameters=parameters,
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0) if clip else None,
        device=device)
    return opt, sched


def state_digest(torch, model, opt):
    """sha256 of every parameter and both its moments, in parameter
    order, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        for t in [p] + list(opt._get_accumulators(p).values()):
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


def epoch_tokens(io, stream, start, n):
    class EpochTokens(io.Dataset):
        """Items start .. start + n of the bench's token stream: epoch e
        of the drill reads the same batches in every run."""

        def __len__(self):
            return n

        def __getitem__(self, i):
            return stream[start + i]
    return EpochTokens()


def resume_drill(cfg):
    """One run of the resume drill (`--resume-drill JSON`; phase 17 (c)
    and (d), and tests/test_torch_resilience.py on the CPU): the GPT-2
    configuration (`cfg["model"]` from paddle_tpu_torch.models at
    cfg["device"], seed 0, dropouts 0.1, `amp.decorate` O2 when
    cfg["dtype"] is bfloat16, `gpt2_recipe`, make_train_step) in a
    TrainEpochRange of cfg["epochs"] epochs under cfg["root"], each epoch
    cfg["steps"] batches of cfg["B"] x cfg["T"] from a DataLoader over its
    slice of the bench's token stream. It restores the newest intact
    epoch (and the RNG state in its meta), calls chaos.step_hook with the
    global step before each step (as Model.fit does), appends each step's
    loss to cfg["log"], saves every epoch with the RNG state in its meta,
    and prints DRILL_RESTORED <epoch> <step count>, DRILL_SAVED <epoch>
    and, at the end, DRILL_DONE or DRILL_PREEMPTED with `state_digest`."""
    import torch
    from paddle_tpu_torch import amp, io, models, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.resilience import chaos

    dev, B, T, per = cfg["device"], cfg["B"], cfg["T"], cfg["steps"]
    prandom.seed(0)
    model = getattr(models, cfg["model"])(seed=0, device=dev)
    model.train()
    opt, sched = gpt2_recipe(optimizer, model.parameters(), dev)
    if cfg["dtype"] == "bfloat16":
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    crit = models.GPTPretrainingCriterion()
    step = make_train_step(model, lambda o, l: crit(o, l), opt, device=dev)
    tr = TrainEpochRange(cfg["epochs"], "drill", checkpoint_dir=cfg["root"])
    meta = tr.restore(model, opt)
    if meta:
        prandom.set_rng_state(meta["rng"])
    say("DRILL_RESTORED %d %d" % (tr.restored_epoch, opt._step_count))
    stream = token_stream(io, model.gpt.vocab_size, T)
    with open(cfg["log"], "a") as log:
        for epoch in tr.get():
            loader = io.DataLoader(
                epoch_tokens(io, stream, epoch * per * B, per * B),
                batch_size=B, device=dev,
                prefetch_to_device=2 if dev == "cuda" else 0)
            for i, ids in enumerate(loader):
                g = epoch * per + i
                chaos.step_hook(g)
                loss, _ = step([ids[:, :-1]], [ids[:, 1:]])
                sched.step()
                log.write(json.dumps({"step": g, "loss": float(loss)})
                          + "\n")
                log.flush()
            tr.save(layer=model, optimizer=opt,
                    meta={"rng": prandom.get_rng_state()})
            say("DRILL_SAVED %d" % epoch)
    say("DRILL_%s %s" % ("PREEMPTED" if tr.preempted else "DONE",
                         state_digest(torch, model, opt)))
    return 0


def run_drill(root, log, chaos_spec="", **cfg):
    """`resume_drill` in a fresh process (this script with --resume-drill)
    under PADDLE_TPU_CHAOS=chaos_spec: (exit code, stdout, stderr, wall
    seconds, its losses by step from the log)."""
    cfg = dict(cfg, root=root, log=log)
    env = dict(os.environ, PADDLE_TPU_CHAOS=chaos_spec)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-drill",
         json.dumps(cfg)], env=env, capture_output=True, text=True,
        timeout=DRILL_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    losses = {}
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return (out.returncode, out.stdout, out.stderr,
            time.perf_counter() - t0, losses)


def drill_digest(stdout, word):
    """The digest of the DRILL_<word> line of a drill's output, or None."""
    for line in stdout.splitlines():
        if line.startswith("DRILL_%s " % word):
            return line.split()[1]
    return None


def ckpt_counters(metrics):
    """The pt_ckpt_* counters of the registry, by name (and mode)."""
    out = {}
    for name in ("pt_ckpt_bytes_total", "pt_ckpt_corrupt_total",
                 "pt_ckpt_fallback_total", "pt_ckpt_gc_total"):
        m = metrics.REGISTRY.get(name)
        out[name] = m.value if m is not None else 0.0
    saves = metrics.REGISTRY.get("pt_ckpt_saves_total")
    for mode in ("sync", "async"):
        out["pt_ckpt_saves_total{%s}" % mode] = (
            saves.labels(mode).value if saves is not None else 0.0)
    return out


def timed_step(torch, step, sched, batch):
    t0 = time.perf_counter()
    loss, _ = step(*batch)
    torch.cuda.synchronize()
    sched.step()
    return float(loss), (time.perf_counter() - t0) * 1e3


def resume_main(torch, ck, card, off_ms, off_launches):
    """Phase 17 (see the module's note): the GPT-2 configuration's captured
    step and the clip's cost, sync and async saves and a load into the
    built step, the resume drill and the corruption drills."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.checkpoint import engine, store
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import chaos

    tmp = tempfile.mkdtemp(prefix="pt-resume-")
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    try:
        prandom.seed(0)
        model = gpt2_small(seed=0)
        model.train()
        opt, sched = gpt2_recipe(optimizer, model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        loader = io.DataLoader(token_stream(io, model.gpt.vocab_size,
                                            TRAIN_T),
                               batch_size=TRAIN_B, prefetch_to_device=2)
        it = iter(loader)

        def batch():
            ids = next(it)
            return [ids[:, :-1]], [ids[:, 1:]]

        # (a) the captured step with the schedule and the clip
        step = make_train_step(model, loss_fn, opt)
        ck.launch_counts(reset=True)
        res = [timed_step(torch, step, sched, batch())
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
        launches = ck.launch_counts()
        losses = [r[0] for r in res]
        times = [r[1] for r in res[TRAIN_WARMUP:]]
        require(all(math.isfinite(x) for x in losses),
                "resume (a): non-finite loss %s" % losses)
        require(step.compiles == 1 and step.replays
                == TRAIN_WARMUP + TRAIN_STEPS - 1,
                "resume (a): %d programs built, %d replays"
                % (step.compiles, step.replays))
        for k in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                  "adamw", "dropout_keep"):
            require(launches[k] == off_launches[k],
                    "resume (a): %s launched %d times, phase 10 %d"
                    % (k, launches[k], off_launches[k]))
        scale = float(opt._scalars[ck.SCALE])
        require(0.0 < scale <= 1.0, "resume (a): clip scale %g" % scale)
        step_ms = statistics.median(times)
        say("resume (a) gpt2-small B=%d T=%d O2 bf16, LinearWarmup(4) over "
            "CosineAnnealingDecay(1e-4, 100), ClipGradByGlobalNorm(1.0), "
            "captured: step %.2f ms median over %d timed steps (%.2f mean), "
            "%.0f tokens/s; phase 10's step (constant lr, no clip) %.2f ms; "
            "launches as phase 10's %s; lr staged %.4g at step %d, last "
            "clip scale %.4f; losses %s (%s)"
            % (TRAIN_B, TRAIN_T, step_ms, len(times), statistics.mean(times),
               TRAIN_B * TRAIN_T / (step_ms / 1e3), off_ms,
               {k: v for k, v in launches.items() if v},
               float(opt._scalars[0]), opt._step_count, scale,
               ["%.4f" % x for x in losses], card))

        # the clip's cost: the same model under an optimizer without the
        # clip (its own moments), one step each way a pair, order flipped
        opt_off, sched_off = gpt2_recipe(optimizer, model.parameters(),
                                         clip=False)
        step_off = make_train_step(model, loss_fn, opt_off)
        for _ in range(TRAIN_WARMUP):
            timed_step(torch, step_off, sched_off, batch())
        on_t, off_t = [], []
        state0 = gpu_state()
        for i in range(CLIP_PAIRS):
            ways = ((step, sched, on_t), (step_off, sched_off, off_t))
            for st, sc, acc in (ways if i % 2 else ways[::-1]):
                acc.append(timed_step(torch, st, sc, batch())[1])
        # the replays alone, in the same pairs: device time and the gaps
        # between the kernels, none of the host's work
        rep = {True: [], False: []}
        for i in range(CLIP_PAIRS):
            for on in ((True, False) if i % 2 else (False, True)):
                rep[on] += replay_ms(torch, (step if on else
                                             step_off).programs, 1)
        state1 = gpu_state()
        diffs = [a - b for a, b in zip(on_t, off_t)]
        rdiffs = [a - b for a, b in zip(rep[True], rep[False])]
        say("resume (a) the clip's cost, %d pairs of steps in turns: on "
            "%.2f ms, off %.2f ms median, pair difference %+.3f ms median "
            "(%+.2f %%), min %+.3f, max %+.3f; the graph's replay alone "
            "(CUDA events, %d pairs) on %.3f, off %.3f ms median, "
            "difference %+.3f ms median; card (SM clock, max SM clock, "
            "temperature, power draw) before %s, after %s (%s)"
            % (CLIP_PAIRS, statistics.median(on_t), statistics.median(off_t),
               statistics.median(diffs),
               100 * statistics.median(diffs) / statistics.median(off_t),
               min(diffs), max(diffs), CLIP_PAIRS,
               statistics.median(rep[True]), statistics.median(rep[False]),
               statistics.median(rdiffs), state0, state1, card))
        prof, added = guard_profile(torch, {False: step_off, True: step},
                                    batch)
        if prof[False][0] > 0 and prof[True][0] > 0:
            (off_dev, off_n), (on_dev, on_n) = prof[False], prof[True]
            say("resume (a) one profiled step each way (torch.profiler): "
                "kernels clip off %.3f / on %.3f ms (%+.3f ms; the kernels "
                "only the clipped step runs %.3f ms), %d / %d kernels (%+d) "
                "(%s)" % (off_dev, on_dev, on_dev - off_dev,
                          sum(t for t, _, _ in added) / 1e3, off_n, on_n,
                          on_n - off_n, card))
            for t_us, cnt, name in sorted(added, reverse=True):
                say("  clip kernel %9.1f us/step %4d launches  %s"
                    % (t_us, cnt, name[:90]))
        del step_off, opt_off
        free_memory(torch)

        # (b) saves and a load into the built step
        c0 = ckpt_counters(metrics)
        fixed = batch()
        it.close()
        capture_s = []
        for _ in range(2):          # the first allocates the pinned buffer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = engine.snapshot(model, opt)
            capture_s.append(time.perf_counter() - t0)
            snap_bytes = sum(int(a.numel()) * a.element_size()
                             for a in snap["arrays"].values())
            n_arrays = len(snap["arrays"])
            del snap
        sync_path = os.path.join(tmp, "sync")
        meta = {"rng": prandom.get_rng_state()}
        saved = state_digest(torch, model, opt)
        saved_t = opt._step_count
        t0 = time.perf_counter()
        engine.save_checkpoint(sync_path, model, opt, meta)
        sync_s = time.perf_counter() - t0
        c1 = ckpt_counters(metrics)
        sync_bytes = c1["pt_ckpt_bytes_total"] - c0["pt_ckpt_bytes_total"]
        require(sync_bytes == snap_bytes and store.is_complete(sync_path),
                "resume (b): %d bytes committed, snapshot %d"
                % (sync_bytes, snap_bytes))
        after_loss, _ = timed_step(torch, step, sched, fixed)
        after = state_digest(torch, model, opt)
        # the same batch's steps with no write in flight, for the in-flight
        # ones below (no loader in either)
        quiet = [timed_step(torch, step, sched, fixed)[1]
                 for _ in range(TRAIN_STEPS)]
        t0 = time.perf_counter()
        pending = engine.save_checkpoint(os.path.join(tmp, "async"), model,
                                         opt, meta, async_=True)
        blocked_s = time.perf_counter() - t0
        inflight = []
        while not pending.done or len(inflight) < INFLIGHT_STEPS_MIN:
            inflight.append(timed_step(torch, step, sched, fixed)[1])
            if len(inflight) >= 200:
                break
        pending.wait(120)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_meta = engine.load_checkpoint(sync_path, model, opt)
        load_s = time.perf_counter() - t0
        prandom.set_rng_state(got_meta["rng"])
        require(state_digest(torch, model, opt) == saved
                and opt._step_count == saved_t,
                "resume (b): the load did not restore the saved state")
        again_loss, _ = timed_step(torch, step, sched, fixed)
        require(again_loss == after_loss
                and state_digest(torch, model, opt) == after
                and step.compiles == 1,
                "resume (b): the step after the load gave loss %r (%r "
                "after the save), %d programs built"
                % (again_loss, after_loss, step.compiles))
        c2 = ckpt_counters(metrics)
        say("resume (b) sync save: %d arrays, %d bytes (%.3f GB), host "
            "capture %.3f s (the first, which allocates the pinned buffer, "
            "%.3f s), total %.3f s (%.2f GB/s); async save: blocked %.3f s, "
            "committed after %.3f s, %d steps on one batch while its write "
            "was in flight, %.2f ms median (%.2f max) against %.2f ms with "
            "no write (%d steps, the same batch); load %.3f s (verified, "
            "copied into the built step); the step after the load bit-equal "
            "to the step after the save (loss %.6f, parameters and moments), "
            "%d program built; counters %s (%s)"
            % (n_arrays, sync_bytes, sync_bytes / 1e9, capture_s[1],
               capture_s[0], sync_s, sync_bytes / 1e9 / sync_s, blocked_s,
               write_s, len(inflight), statistics.median(inflight),
               max(inflight), statistics.median(quiet), len(quiet), load_s,
               after_loss, step.compiles,
               {k: v - c0[k] for k, v in c2.items() if v != c0[k]}, card))
        n_state = len(model.state_dict())
        n_params = len(list(model.parameters()))
        del step, model, opt, fixed, loader, it
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        free_memory(torch)

        # (c) the resume drill, each run a fresh process
        cfg = dict(device="cuda", model="gpt2_small", B=TRAIN_B, T=TRAIN_T,
                   epochs=DRILL_EPOCHS, steps=DRILL_STEPS, dtype="bfloat16")
        total = DRILL_EPOCHS * DRILL_STEPS

        def drill(name, spec="", root=None):
            rc, out, err, wall, losses = run_drill(
                root or os.path.join(tmp, name),
                os.path.join(tmp, name + ".jsonl"), spec, **cfg)
            return rc, out, err, wall, losses

        rc, out, err, wall_u, ref = drill("uninterrupted")
        ref_digest = drill_digest(out, "DONE")
        require(rc == 0 and ref_digest and len(ref) == total,
                "resume (c) uninterrupted run: rc %d, %d losses\n%s"
                % (rc, len(ref), err[-2000:]))
        shutil.rmtree(os.path.join(tmp, "uninterrupted"), ignore_errors=True)
        root = os.path.join(tmp, "preempted")
        rc, out, err, wall_p, part1 = drill(
            "preempted", "sigterm_at_step:%d" % DRILL_SIGTERM_STEP, root)
        stop = (DRILL_SIGTERM_STEP // DRILL_STEPS + 1) * DRILL_STEPS
        require(rc == 0 and drill_digest(out, "PREEMPTED")
                and "DRILL_SAVED %d" % (stop // DRILL_STEPS - 1) in out
                and sorted(part1) == list(range(stop)),
                "resume (c) preempted run: rc %d, steps %s\n%s"
                % (rc, sorted(part1), err[-2000:]))
        rc, out, err, wall_r, both = drill("preempted", root=root)
        restored = "DRILL_RESTORED %d %d" % (stop // DRILL_STEPS - 1, stop)
        got_digest = drill_digest(out, "DONE")
        require(rc == 0 and restored in out,
                "resume (c) relaunch: rc %d, want %r\n%s\n%s"
                % (rc, restored, out[-1000:], err[-2000:]))
        require(both == ref and got_digest == ref_digest,
                "resume (c) relaunch differs from the uninterrupted run: "
                "losses %s against %s, digest %s against %s"
                % (both, ref, got_digest, ref_digest))
        say("resume (c) drill, gpt2-small B=%d T=%d O2 bf16, dropout %g, %d "
            "epochs x %d steps, a fresh process each: the uninterrupted run "
            "(%.1f s); under PADDLE_TPU_CHAOS=sigterm_at_step:%d the run "
            "saved epoch %d and exited 0 at its boundary (%.1f s); the "
            "relaunch restored it (step count %d) and ran on (%.1f s): "
            "losses %s bit-equal, final parameters and moments sha256 %s "
            "equal to the uninterrupted run's (%s)"
            % (TRAIN_B, TRAIN_T, DROPOUT, DRILL_EPOCHS, DRILL_STEPS, wall_u,
               DRILL_SIGTERM_STEP, stop // DRILL_STEPS - 1, wall_p, stop,
               wall_r, [ref[k] for k in sorted(ref)], ref_digest[:16], card))
        shutil.rmtree(root, ignore_errors=True)

        # (d) bitflip: load_latest quarantines and falls back
        prandom.seed(0)
        model = gpt2_small(seed=0)
        opt, _ = gpt2_recipe(optimizer, model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        p0, p1 = os.path.join(tmp, "epoch_0"), os.path.join(tmp, "epoch_1")
        good = state_digest(torch, model, opt)       # makes the moments
        engine.save_checkpoint(p0, model, opt, {"epoch": 0})
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(2)
        chaos.configure("bitflip_ckpt:1")
        try:
            engine.save_checkpoint(p1, model, opt, {"epoch": 1})
        finally:
            chaos.reset()
        c0 = ckpt_counters(metrics)
        path, got = engine.load_latest([p1, p0], model, opt)
        c1 = ckpt_counters(metrics)
        corrupt = c1["pt_ckpt_corrupt_total"] - c0["pt_ckpt_corrupt_total"]
        fallback = (c1["pt_ckpt_fallback_total"]
                    - c0["pt_ckpt_fallback_total"])
        require(path == p0 and got == {"epoch": 0} and corrupt == 1
                and fallback == 1 and os.path.isdir(p1 + ".corrupt")
                and state_digest(torch, model, opt) == good,
                "resume (d) bitflip: loaded %s, corrupt +%d, fallback +%d"
                % (path, corrupt, fallback))
        del model, opt
        free_memory(torch)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        # torn write: the blob after one and a half saves, in epoch 1's
        blobs = n_state + 2 * n_params
        spec = "torn_write:%d" % (blobs + blobs // 2)
        root = os.path.join(tmp, "torn")
        rc, out, err, wall_t, part1 = drill("torn", spec, root)
        require(rc == -9 and "DRILL_SAVED 0" in out
                and "DRILL_SAVED 1" not in out,
                "resume (d) torn write: rc %d (want -9, SIGKILL)\n%s\n%s"
                % (rc, out[-1000:], err[-2000:]))
        os.remove(os.path.join(tmp, "torn.jsonl"))
        rc, out, err, wall_t2, again = drill("torn", root=root)
        require(rc == 0 and "DRILL_RESTORED 0 %d" % DRILL_STEPS in out
                and again == {k: v for k, v in ref.items()
                              if k >= DRILL_STEPS}
                and drill_digest(out, "DONE") == ref_digest,
                "resume (d) torn-write relaunch: rc %d, losses %s\n%s"
                % (rc, again, err[-2000:]))
        say("resume (d) bitflip_ckpt:1 on epoch 1's save: load_latest "
            "quarantined it and fell back to epoch 0 (pt_ckpt_corrupt_total "
            "+%d, pt_ckpt_fallback_total +%d), state bit-equal to epoch 0's; "
            "PADDLE_TPU_CHAOS=%s (%d blobs a save): the run died by SIGKILL "
            "in epoch 1's save (%.1f s), the relaunch resumed from epoch 0 "
            "(%.1f s) and its losses and final state equal the "
            "uninterrupted run's (%s)"
            % (corrupt, fallback, spec, blobs, wall_t, wall_t2, card))
    finally:
        chaos.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: float16 on the card, GradScaler, the other optimizers


# (b): the eager GradScaler loop's steps, and the overflow drill's scale
# phase 19: bench_resnet50's on-chip shapes (train_bench.py:317-388)
RESNET_B, RESNET_HW, RESNET_CLASSES = 64, 224, 100
RESNET_WARMUP, RESNET_STEPS = 3, 20
RESNET_LR, RESNET_MOMENTUM = 0.01, 0.9
# train_bench.py:379-381: a 224x224 forward is ~4.1 GFLOPs, a step 3x that
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9
RESNET_PARITY_B, RESNET_PARITY_STEPS = 8, 3
RESNET_GUARD_B, RESNET_GUARD_NAN, RESNET_GUARD_STEPS = 16, 2, 3
RESNET_EVAL_REPLAYS = 10
# kernel-name patterns of the ResNet step's profile groups, first match:
# cuDNN's convolution kernels (implicit GEMMs, their layout transforms)
# before cuBLAS's GEMMs (the classifier)
RESNET_PROFILE_GROUPS = (
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                              "implicit", "nchwToNhwc", "nhwcToNchw")),
    ("pooling", ("max_pool", "avg_pool", "adaptive")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass")),
    ("reductions (batch norm statistics)", ("reduce_kernel",)),
    ("elementwise (batch norm, ReLU, casts, Momentum)",
     ("elementwise", "vectorized")))


def resnet_batch(torch, B, seed=0):
    """bench_resnet50's feed on the card: RandomState(seed) images
    rand(B, 3, 224, 224) float32 and labels randint(0, 100, (B, 1))
    int64."""
    rs = np.random.RandomState(seed)
    x = rs.rand(B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, (B, 1)).astype(np.int64)
    return [torch.from_numpy(x).cuda()], [torch.from_numpy(y).cuda()]


def resnet_setup(seed=0):
    """resnet50(num_classes=100) on the card in train() mode, seeded, with
    Momentum(0.01, 0.9) and the cross entropy over [B, 1] labels."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=RESNET_CLASSES, seed=seed)
    model.train()
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM,
                             parameters=model.parameters())
    return model, opt, lambda o, y: F.cross_entropy(o, y)


def resnet_tensors(model, opt):
    """The tensors a step updates: parameters, their velocities, the
    running statistics."""
    params = list(model.parameters())
    return (params + [opt._get_accumulators(p)["velocity"] for p in params]
            + list(model.buffers()))


def resnet_copies(model, opt):
    """Copies of `resnet_tensors`, detached: a copy with autograd history
    would keep the parameters' gradient accumulators alive, made on the
    stream of the step that made them, and a later capture's backward on
    the capture stream would then fail."""
    return [t.detach().clone() for t in resnet_tensors(model, opt)]


def resnet_parity(torch, label, model, opt, loss_fn, batches):
    """From one saved state, the steps of `batches` through a captured step
    and twice through its eager bodies: (the eager runs equal each other,
    the captured run equal the first eager one, the runs' losses and
    tensors)."""
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    step = make_train_step(model, loss_fn, opt)
    step(*batches[0])                        # the build; later calls replay
    torch.cuda.synchronize()
    saved = resnet_copies(model, opt), opt._step_count

    def run(fn):
        with torch.no_grad():
            for t, v in zip(resnet_tensors(model, opt), saved[0]):
                t.copy_(v)
        opt._step_count = saved[1]
        losses = [fn(*b)[0] for b in batches]
        torch.cuda.synchronize()
        return losses, resnet_copies(model, opt)
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    e1, e2 = run(eager), run(eager)
    replays = step.replays
    g = run(step)
    require(step.replays == replays + len(batches) and step.compiles == 1,
            "%s: the captured steps did not replay" % label)
    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a[0] + a[1], b[0] + b[1]))
    return same(e1, e2), same(g, e1), g, e1


def resnet_float32_parity(torch, card):
    """Phase 19 (a): float32 ResNet-50 at B=8, captured against eager."""
    model, opt, loss_fn = resnet_setup()
    batches = [resnet_batch(torch, RESNET_PARITY_B, seed=s)
               for s in range(RESNET_PARITY_STEPS)]
    eager_same, graph_same, g, e = resnet_parity(
        torch, "resnet (a)", model, opt, loss_fn, batches)
    note = "cudnn.deterministic off"
    if not (eager_same and graph_same):
        # cuDNN's weight-gradient algorithms may sum with atomics, in an
        # order that changes from run to run: this check alone runs with
        # deterministic algorithms, the timed run (b) without
        worst = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(g[1], e[1]))
        say("resnet (a) float32: with cudnn.deterministic off the two eager "
            "runs are %s and the captured run %s the eager one (largest "
            "difference %.3g): made again with "
            "torch.backends.cudnn.deterministic = True for this check only"
            % ("equal" if eager_same else "not equal",
               "equals" if graph_same else "differs from", worst))
        note = "cudnn.deterministic on for this check"
        torch.backends.cudnn.deterministic = True
        try:
            eager_same, graph_same, g, e = resnet_parity(
                torch, "resnet (a)", model, opt, loss_fn, batches)
        finally:
            torch.backends.cudnn.deterministic = False
    require(eager_same, "resnet (a): two eager runs from one state differ "
            "with deterministic cuDNN algorithms")
    require(graph_same, "resnet (a): the captured step's losses, parameters, "
            "velocities or running statistics differ from its eager "
            "bodies'")
    n_buf = len(list(model.buffers()))
    say("resnet (a) float32 resnet50 B=%d %dx%d, %d steps from one state "
        "(%s): losses %s; parameters (%d), velocities and running "
        "statistics (%d buffers) bit-equal to the eager bodies, which "
        "repeat themselves bit for bit (%s)"
        % (RESNET_PARITY_B, RESNET_HW, RESNET_HW, RESNET_PARITY_STEPS, note,
           ["%.6f" % float(x) for x in g[0]],
           len(list(model.parameters())), n_buf, card))
    del model, opt


def momentum_ms(torch, model, n=20):
    """Device ms of one Momentum update over `model`'s parameter shapes,
    replayed from a CUDA graph as in the captured step (CUDA events around
    the replay, median of n), on copies of the parameters."""
    from paddle_tpu_torch import optimizer
    params = [torch.nn.Parameter(p.detach().clone())
              for p in model.parameters()]
    pairs = [(p, torch.full_like(p, 1e-3)) for p in params]
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM, parameters=params)
    opt.stage_step()
    # the warm-up makes the velocities
    graph = graph_of(torch, lambda: opt.apply_updates(pairs), 1)
    out = []
    for _ in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out), len(params)


def resnet_timed(torch, ck, card):
    """Phase 19 (b): the bench's run under auto_cast O1 bfloat16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    model, opt, loss_fn = resnet_setup()
    n_params = sum(p.numel() for p in model.parameters())
    batch = resnet_batch(torch, RESNET_B)
    step = make_train_step(model, loss_fn, opt)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        F.conv_path_counts(reset=True)
        losses, times, outs = timed_steps(torch, step, lambda: batch,
                                          RESNET_WARMUP, RESNET_STEPS)
        launches = ck.launch_counts()
        convs = F.conv_path_counts()
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = profile_step(torch, step, lambda: batch)
    n_steps = RESNET_WARMUP + RESNET_STEPS
    require(step.compiles == 1 and step.replays == n_steps,
            "resnet (b): %d programs, %d replays in %d + 1 steps"
            % (step.compiles, step.replays, n_steps))
    require(all(math.isfinite(x) for x in losses),
            "resnet (b): non-finite loss %s" % losses)
    require(sum(launches.values()) == 0,
            "resnet (b): the port's kernels launched on a path that reaches "
            "none: %s" % {k: n for k, n in launches.items() if n})
    n_conv = sum(1 for m in model.modules()
                 if type(m).__name__ == "Conv2D")
    # the body runs in Python at the build (its eager run and its capture)
    # on the card, at every step on the CPU
    bodies = 2 if batch[0][0].is_cuda else n_steps
    require(convs == {"direct": bodies * n_conv, "im2col": 0, "nhwc": 0},
            "resnet (b): conv paths %s (want direct, %d convs in each of "
            "%d body runs)" % (convs, n_conv, bodies))
    dtypes = {str(t.dtype) for t in resnet_tensors(model, opt)}
    require(dtypes == {"torch.float32"} and outs[0].dtype == torch.float32,
            "resnet (b): parameter, velocity or buffer dtypes %s, logits %s "
            "(auto_cast O1 keeps them float32)" % (dtypes, outs[0].dtype))
    progs = step.programs
    (key,) = progs.builds
    step_ms = statistics.median(times)
    mfu = (RESNET_FLOPS_PER_IMAGE * RESNET_B / (step_ms / 1e3)
           / PEAK_FLOPS["bfloat16"])
    say("resnet (b) main path: resnet50 %d parameters, %d convs (conv_algo "
        "direct: %s), B=%d %dx%d, auto_cast O1 bf16, Momentum(%g, %g); "
        "%d timed and warm-up steps (and 1 profiled), losses %s; launches "
        "of the port's kernels %d (no Pallas counterpart on this path)"
        % (n_params, n_conv, convs, RESNET_B, RESNET_HW, RESNET_HW,
           RESNET_LR, RESNET_MOMENTUM, n_steps,
           ["%.4f" % x for x in losses], sum(launches.values())))
    say("resnet (b) program: 1 build + %d replays, captured in %.1f ms, "
        "graph pool %.1f MiB (%s)"
        % (progs.replays[key], progs.capture_s[key] * 1e3,
           progs.pool_bytes() / 2 ** 20, card))
    idle = ("device idle %.1f %% (%.3f ms of kernels in one profiled step)"
            % (100.0 * (1.0 - dev_ms / step_ms), dev_ms) if dev_ms > 0
            else "device idle not measured (the profiler saw no device "
            "activity)")
    say("resnet (b) captured step: %.2f ms median (%.2f mean, min %.2f, max "
        "%.2f) over %d timed steps after %d warm-up, %.1f images/s, MFU "
        "%.4f of 989 TFLOP/s bf16 (3 x 4.1e9 x %d FLOPs a step), peak "
        "memory %.1f MiB, %s (%s)"
        % (step_ms, statistics.mean(times), min(times), max(times),
           len(times), RESNET_WARMUP, RESNET_B / (step_ms / 1e3), mfu,
           RESNET_B, peak / 2 ** 20, idle, card))
    report_profile("resnet (b) captured", dev_ms, step_ms, top,
                   RESNET_PROFILE_GROUPS)
    by_group = {}
    for t_us, name, count in top:            # largest first
        by_group.setdefault(group_of(name, RESNET_PROFILE_GROUPS),
                            []).append((t_us, count, name))
    for group, rows in by_group.items():
        for t_us, count, name in rows[:3]:
            say("  %-10s %9.1f us/step %5d launches  %s"
                % (group.split()[0], t_us, count, name[:110]))
    mom_ms, n_tensors = momentum_ms(torch, model)
    say("resnet (b) Momentum update alone: %.4f ms a step over %d tensors "
        "(%.1f M float32 elements), replayed from a CUDA graph (%s)"
        % (mom_ms, n_tensors, n_params / 1e6, card))
    return model, step_ms


def resnet_guard(torch, ck, flags, card, model):
    """Phase 19 (c): the NaN drill on the trained network at B=16."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.resilience import chaos
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM,
                             parameters=model.parameters())
    loss_fn = lambda o, y: F.cross_entropy(o, y)  # noqa: E731
    saved = flags.get_flags(["skip_nonfinite_steps"])
    flags.set_flags({"skip_nonfinite_steps": True})
    chaos.reset()
    chaos.configure("nan_at_step:%d" % RESNET_GUARD_NAN)
    try:
        step = make_train_step(model, loss_fn, opt)
        require(step.guard and step.nan_step == RESNET_GUARD_NAN,
                "resnet (c): the step did not read the drill")
        states, losses, skipped = [], [], []
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            for s in range(RESNET_GUARD_STEPS):
                loss, _ = step(*resnet_batch(torch, RESNET_GUARD_B, seed=s))
                torch.cuda.synchronize()
                losses.append(float(loss))
                skipped.append(step.last_step_skipped)
                states.append(resnet_copies(model, opt))
    finally:
        chaos.reset()
        flags.set_flags(saved)
    want = [i + 1 == RESNET_GUARD_NAN for i in range(RESNET_GUARD_STEPS)]
    require([math.isnan(x) for x in losses] == want and skipped == want
            and step.skipped_steps == 1,
            "resnet (c): losses %s, skipped %s" % (losses, skipped))
    k = RESNET_GUARD_NAN - 1
    n_p = len(list(model.parameters()))
    groups = (("parameters", 0, n_p), ("velocities", n_p, 2 * n_p),
              ("running statistics", 2 * n_p, len(states[k])))
    for name, a, b in groups:
        require(all(torch.equal(x, y) for x, y in
                    zip(states[k][a:b], states[k - 1][a:b])),
                "resnet (c): the skipped step changed the %s" % name)
        require(not all(torch.equal(x, y) for x, y in
                        zip(states[k + 1][a:b], states[k][a:b])),
                "resnet (c): the step after the skip did not move the %s"
                % name)
    say("resnet (c) guard drill, B=%d, nan_at_step:%d: losses %s, skipped "
        "%s; after the skipped step the parameters, velocities and %d "
        "running statistics are bit-equal to their values before it, and "
        "the next step moves each group (%s)"
        % (RESNET_GUARD_B, RESNET_GUARD_NAN, ["%.4f" % x for x in losses],
           skipped, len(list(model.buffers())), card))


def resnet_eval(torch, ck, card, model):
    """Phase 19 (d): make_eval_step in eval() mode against the eager
    forward."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import make_eval_step
    from paddle_tpu_torch.nn import functional as F
    model.eval()
    loss_fn = lambda o, y: F.cross_entropy(o, y)  # noqa: E731
    x, y = resnet_batch(torch, RESNET_B, seed=7)
    bufs = [b.clone() for b in model.buffers()]
    ev = make_eval_step(model, loss_fn)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        ck.launch_counts(reset=True)
        loss, outs = ev(x, y)
        times = []
        for _ in range(RESNET_EVAL_REPLAYS):
            t0 = time.perf_counter()
            loss, outs = ev(x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = ck.launch_counts()
        with torch.no_grad():
            want = model(*x)
            want_loss = loss_fn(want, *y)
    require(ev.compiles == 1 and ev.replays == RESNET_EVAL_REPLAYS,
            "resnet (d): %d programs, %d replays" % (ev.compiles,
                                                     ev.replays))
    require(sum(launches.values()) == 0,
            "resnet (d): the port's kernels launched: %s" % launches)
    require(all(torch.equal(a, b) for a, b in zip(model.buffers(), bufs)),
            "resnet (d): the eval step wrote a running statistic")
    _, err = abs_rel_err(outs[0], want)
    lerr = abs(float(loss) - float(want_loss)) / max(1.0,
                                                     abs(float(want_loss)))
    require(err <= REL_TOL["bfloat16"] and lerr <= REL_TOL["bfloat16"],
            "resnet (d): eval logits %.3g, loss %.3g from the eager forward "
            "(tolerance %g)" % (err, lerr, REL_TOL["bfloat16"]))
    ms = statistics.median(times)
    say("resnet (d) make_eval_step, eval() mode, B=%d O1 bf16: 1 program, "
        "%d replays, %.2f ms median, %.1f images/s; logits %s the eager "
        "eval forward (max error %.3g of the largest, tolerance %g), loss "
        "%.6f (eager %.6f); no running statistic written (%s)"
        % (RESNET_B, RESNET_EVAL_REPLAYS, ms, RESNET_B / (ms / 1e3),
           "bit-equal to" if torch.equal(outs[0], want) else "within",
           err, REL_TOL["bfloat16"], float(loss), float(want_loss), card))
    model.train()


def resnet_main(torch, ck, flags, card):
    """Phase 19: ResNet-50 training and evaluation on the card, (a)-(d)
    (see the module's docstring). Returns (b)'s median step ms."""
    t0 = time.perf_counter()
    resnet_float32_parity(torch, card)
    free_memory(torch)
    model, step_ms = resnet_timed(torch, ck, card)
    free_memory(torch)
    resnet_guard(torch, ck, flags, card, model)
    free_memory(torch)
    resnet_eval(torch, ck, card, model)
    del model
    free_memory(torch)
    say("resnet phase 19: %.1f s" % (time.perf_counter() - t0))
    return step_ms


SCALER_STEPS = 20
SCALER_DRILL_SCALE = 2.0 ** 24
# (d): the rules through the captured step at reduced depth; each with
# the lr of LinearWarmup(CosineAnnealingDecay(base lr, 100), 2) from base
# lr / 10
OPT_LAYERS, OPT_STEPS = 2, 3
OPT_RULES = (("SGD", {}, 1e-3), ("Momentum", {"momentum": 0.9}, 1e-3),
             ("Momentum", {"momentum": 0.9, "use_nesterov": True}, 1e-3),
             ("Lars", {"lars_weight_decay": 5e-4}, 1e-2),
             ("Adamax", {}, 1e-4), ("Adagrad", {}, 1e-3),
             ("Adadelta", {}, 1.0), ("RMSProp", {"momentum": 0.9}, 1e-4),
             ("RMSProp", {"centered": True}, 1e-4),
             ("Ftrl", {"l1": 1e-4, "l2": 1e-4}, 1e-2),
             ("DecayedAdagrad", {}, 1e-3),
             ("ProximalGD", {"l1": 1e-5, "l2": 1e-5}, 1e-3),
             ("ProximalAdagrad", {"l1": 1e-5, "l2": 1e-5}, 1e-3))


def no_decay(p):
    """LayerNorm weights and every bias, by qualified name: the weight
    decay exclusion of BERT's LAMB recipe."""
    name = getattr(p, "qualname", "") or ""
    return name.endswith(".bias") or "norm" in name or ".ln_" in name


def f16_main(torch, ck, F, flags, timer, gen, shapes, card):
    """Phase 18 (a): the float16 instances' device times at the main
    path's shapes (rows 1t, 2, 3 at B=16, H=12, T=512, D=64, causal,
    p=0.1; row 7 over every gpt2-small parameter; rows 4-6 at path B's
    N=8192, Hd=768), each beside its bound (the same bytes as bfloat16)
    and PyTorch's float16 call; then GPT-2 training in float16 (decorate
    O2 float16, auto_cast O2 float16) through `train_main` with the fused
    flags off and on (path B). Returns (times, launches flags off,
    launches path B)."""
    sfx = ck.F16
    times = {"flash_fwd_train" + sfx: fwd_timings(
        torch, ck, F, timer, gen, TRAIN_B, TRAIN_T, True, DROPOUT,
        "float16")}
    times.update({k + sfx: v for k, v in bwd_timings(
        torch, ck, F, timer, gen, TRAIN_B, TRAIN_T, True, DROPOUT,
        "float16").items()})
    times["adamw" + sfx] = time_adamw(torch, ck, timer, gen, shapes, card,
                                      "float16")
    times.update({k + sfx: v for k, v in time_fused(
        torch, ck, timer, gen, TRAIN_B * TRAIN_T, 768, torch.float16, True,
        "gpt2 (path B)").items()})
    free_memory(torch)
    off, _, off_ms = train_main(torch, ck, flags, card, dtype="float16")
    on, _, on_ms = train_main(torch, ck, flags, card, fused=True,
                              dtype="float16")
    say("train step, gpt2-small B=%d T=%d O2 f16 under auto_cast f16 (%s): "
        "fused flags off %.2f ms, on %.2f ms (median of %d steps each, this "
        "run)" % (TRAIN_B, TRAIN_T, card, off_ms, on_ms, TRAIN_STEPS))
    return times, off, on


def scaler_main(torch, ck, card):
    """Phase 18 (b): the reference's dygraph AMP recipe at full width:
    gpt2-small (dropouts 0.1), decorate O2 float16, AdamW(lr=1e-4,
    weight_decay=0.01), GradScaler(init_loss_scaling=2**15), the bench's
    token stream through DataLoader(prefetch_to_device=2), each step
    `scaler.scale(loss).backward(); scaler.step(opt); opt.clear_grad()`,
    SCALER_STEPS steps, the launch counters zeroed just before and read
    just after: the skipped steps and the scale history, the step ms
    (eager: one found_inf read on the host a step). No auto_cast, as the
    recipe runs in the reference (its eager tape fails under auto_cast,
    ROADMAP.md section 3): the loss is float16, and a float16 loss near
    11 times 2^15 overflows, so the first steps are skipped until the
    scale has halved enough, as in the reference. Then the overflow
    drill: the scale set to 2^24, one step: it must be skipped
    (found_inf), the parameters and moments bit-equal to before it, the
    optimizer's step count unmoved and the scale halved."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    prandom.seed(0)
    model = gpt2_small(seed=0)
    model.train()
    opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    crit = GPTPretrainingCriterion()
    loader = io.DataLoader(token_stream(io, model.gpt.vocab_size, TRAIN_T),
                           batch_size=TRAIN_B, prefetch_to_device=2)
    it = iter(loader)
    params = list(model.parameters())

    def one_step():
        ids = next(it)
        loss = crit(model(ids[:, :-1]), ids[:, 1:])
        scaler.scale(loss).backward()
        t = opt._step_count
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach(), opt._step_count == t

    torch.cuda.synchronize()
    ck.launch_counts(reset=True)
    losses, skipped, times = [], [], []
    scales = [scaler.get_init_loss_scaling()]
    for _ in range(SCALER_STEPS):
        t0 = time.perf_counter()
        loss, sk = one_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        skipped.append(sk)
        scales.append(scaler.get_init_loss_scaling())
    launches = ck.launch_counts()
    taken = SCALER_STEPS - sum(skipped)
    require(all(math.isfinite(x) for x in losses) and taken > 0,
            "scaler (b): losses %s, %d steps taken" % (losses, taken))
    require(launches["adamw" + ck.F16] == adamw_launches(params) * taken
            and launches["flash_fwd_train" + ck.F16] > 0
            and launches["adamw"] == 0,
            "scaler (b): launches %s for %d steps taken" % (launches, taken))
    say("scaler (b) eager GradScaler loop, gpt2-small B=%d T=%d O2 f16 (a "
        "float16 loss), %d steps: skipped %d (steps %s), scale history %s, "
        "losses %.4f .. %.4f, step %.2f ms median (eager, one found_inf read "
        "a step), %.0f tokens/s, launches %s (%s)"
        % (TRAIN_B, TRAIN_T, SCALER_STEPS, sum(skipped),
           [i + 1 for i, s in enumerate(skipped) if s], scales,
           losses[0], losses[-1], statistics.median(times),
           TRAIN_B * TRAIN_T / (statistics.median(times) / 1e3),
           {k: n for k, n in launches.items() if n}, card))
    # the overflow drill
    moments = [a for p in params for a in opt._get_accumulators(p).values()]
    before = [t.detach().clone() for t in params + moments]
    count = opt._step_count
    scaler.set_init_loss_scaling(SCALER_DRILL_SCALE)
    loss, sk = one_step()
    torch.cuda.synchronize()
    it.close()
    require(sk and opt._step_count == count,
            "scaler (b) drill: a scale of 2^24 did not skip the step")
    require(all(torch.equal(a, b) for a, b in zip(params + moments, before)),
            "scaler (b) drill: the skipped step changed parameters or "
            "moments")
    require(scaler.get_init_loss_scaling() == SCALER_DRILL_SCALE / 2,
            "scaler (b) drill: scale %g after the skip"
            % scaler.get_init_loss_scaling())
    say("scaler (b) overflow drill: scale 2^24, loss %.4f, the step skipped "
        "(found_inf), parameters and moments (%d tensors) bit-equal to "
        "before it, step count %d unmoved, scale now %g"
        % (float(loss), len(params + moments), count,
           scaler.get_init_loss_scaling()))
    del model, opt, params, moments, before
    free_memory(torch)
    return launches


def ernie_lamb(torch, ck, flags, card):
    """Phase 18 (c): ERNIE-base pretraining with LAMB (You et al. 2019,
    its own use): path A's setup (ernie_base at full width and depth,
    seeded, dropouts 0.1, B=32, T=128, auto_cast(level="O2"),
    FLAGS_use_fused_dropout_ln on) with Lamb(learning_rate=1e-4,
    lamb_weight_decay=0.01, exclude_from_weight_decay_fn=no_decay),
    through `run_path` (no AdamW launch), then the captured step against
    its eager bodies over 3 steps from one state: bit-equal. Returns the
    launch counts."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    crit = BertPretrainingCriterion()
    loss_fn = lambda lg, nl, y1, y2: crit(lg, nl, y1, y2)  # noqa: E731
    ctx = lambda: amp.auto_cast(level="O2")  # noqa: E731
    try:
        net = ernie_base(seed=0)
        net.train()
        prandom.seed(0)
        opt = optimizer.Lamb(learning_rate=1e-4, lamb_weight_decay=0.01,
                             exclude_from_weight_decay_fn=no_decay,
                             parameters=net.parameters())
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        n_params = sum(p.numel() for p in net.parameters())
        excluded = sum(1 for p in net.parameters() if no_decay(p))
        L = len(net.bert.layers)
        want = {"fused_dropout_ln_fwd": 2 * L, "fused_dropout_ln_bwd": 2 * L,
                "flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": 0, "fused_dropout_residual_fwd": 0,
                "dropout_keep": L + 1}
        tokens = ERNIE_B * ERNIE_T
        d = net.bert.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * ERNIE_T * tokens
        say("ernie lamb: ernie-base %d parameters, %d of %d tensors excluded "
            "from the decay (LayerNorm, biases)"
            % (n_params, excluded, len(list(net.parameters()))))
        launches, _, _, _, _ = run_path(
            torch, ck, "ernie lamb", card, net, opt, loss_fn, lambda: batch,
            ctx, tokens, flops, want)
        free_memory(torch)
        graph_against_eager_train(torch, ck, "ernie lamb", net, opt,
                                  loss_fn, [batch] * 3, ctx, DROPOUT)
        del net, opt
        free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches


def optimizer_sweep(torch, ck, flags, card):
    """Phase 18 (d): each capturable rule but Adam/AdamW (OPT_RULES) in the
    captured step on gpt2-small at OPT_LAYERS layers and full width (768),
    B=16, T=512, dropouts 0.1, decorate O2 bfloat16, the lr from
    LinearWarmup over CosineAnnealingDecay stepped after every step; from
    one state (parameters, accumulators, step count, schedule, RNG),
    OPT_STEPS steps through the captured step and twice through its
    bodies run eagerly: losses, parameters and accumulators bit-equal
    (the eager runs to each other first), one program; then a step made
    with FLAGS_skip_nonfinite_steps and nan_at_step:2 from the same
    state: step 2 skipped, its parameters and accumulators bit-equal to
    after step 1, step 3 moving them again. Dpsgd: OPT_STEPS eager steps
    (finite, the parameters moved) and make_train_step's first call must
    raise NotImplementedError."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.optimizer import lr as tlr
    from paddle_tpu_torch.resilience import chaos

    prandom.seed(0)
    model = gpt2_small(seed=0, num_layers=OPT_LAYERS)
    model.train()
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    params = [p for p in model.parameters() if p.requires_grad]
    init = [p.detach().clone() for p in params]
    vocab = model.gpt.vocab_size
    batches = []
    for n in range(OPT_STEPS):
        ids = torch.from_numpy(token_stream_batch(
            np, vocab, TRAIN_B, TRAIN_T, n)).cuda()
        batches.append(([ids[:, :-1]], [ids[:, 1:]]))
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    rng0 = prandom.get_rng_state()
    Eager = eager_train_step(TrainStep)
    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a, b))
    rows = []
    t_all = time.perf_counter()
    for name, kw, base_lr in OPT_RULES:
        label = name + "".join(" %s=%s" % kv for kv in kw.items()
                               if kv[0] in ("use_nesterov", "centered"))
        sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(base_lr, T_max=100),
                                 warmup_steps=2, start_lr=base_lr / 10,
                                 end_lr=base_lr)
        opt = getattr(optimizer, name)(learning_rate=sched,
                                       parameters=params, **kw)
        accs = [a for p in params for a in opt._get_accumulators(p).values()]
        accs0 = [a.clone() for a in accs]
        sched0 = sched.state_dict()

        def run(step):
            with torch.no_grad():
                for t, v in zip(params + accs, init + accs0):
                    t.copy_(v)
            opt._step_count = 0
            sched.set_state_dict(dict(sched0))
            prandom.set_rng_state(rng0)
            losses, states, skips, lrs = [], [], [], []
            for b in batches:
                loss, _ = step(*b)
                lrs.append(opt.get_lr())
                sched.step()
                losses.append(loss)
                states.append([t.detach().clone() for t in params + accs])
                skips.append(step.last_step_skipped
                             if isinstance(step, TrainStep) else False)
            torch.cuda.synchronize()
            return losses, states, skips, lrs

        t0 = time.perf_counter()
        step = make_train_step(model, loss_fn, opt)
        g = run(step)
        e1, e2 = run(Eager(model, loss_fn, opt)), run(Eager(model, loss_fn,
                                                            opt))
        require(same(e1[0], e2[0]) and all(same(a, b) for a, b in
                                           zip(e1[1], e2[1])),
                "optimizers (d) %s: two eager runs from one state differ"
                % label)
        require(same(g[0], e1[0]) and all(same(a, b) for a, b in
                                          zip(g[1], e1[1])),
                "optimizers (d) %s: the captured steps differ from the eager "
                "bodies'" % label)
        require(step.compiles == 1 and step.replays == OPT_STEPS - 1,
                "optimizers (d) %s: %d programs, %d replays"
                % (label, step.compiles, step.replays))
        require(not same(g[1][-1][:len(params)], init)
                and all(math.isfinite(float(x)) for x in g[0]),
                "optimizers (d) %s: the parameters did not move, or a loss "
                "is not finite" % label)
        del step
        flags.set_flags({"skip_nonfinite_steps": True})
        chaos.configure("nan_at_step:2")
        try:
            gstep = make_train_step(model, loss_fn, opt)
        finally:
            chaos.reset()
            flags.set_flags({"skip_nonfinite_steps": False})
        d = run(gstep)
        require(d[2] == [False, True, False] and gstep.skipped_steps == 1,
                "optimizers (d) %s drill: skipped %s" % (label, d[2]))
        require(same(d[1][1], d[1][0]) and not same(d[1][2], d[1][1]),
                "optimizers (d) %s drill: the skipped step changed the state, "
                "or step 3 did not move it" % label)
        rows.append((label, ["%.4f" % float(x) for x in g[0]],
                     ["%.3g" % x for x in g[3]], len(accs),
                     (time.perf_counter() - t0) * 1e3))
        del gstep, opt, accs, accs0, g, e1, e2, d
        free_memory(torch)
    for label, losses, lrs, n_acc, ms in rows:
        say("optimizers (d) %s: %d captured steps bit-equal to the eager "
            "bodies (losses %s, lr %s), %d accumulators; nan_at_step:2 "
            "skipped with the state bit-equal across it (%.0f ms for the "
            "rule's runs)" % (label, OPT_STEPS, losses, lrs, n_acc, ms))
    # Dpsgd: eager only
    with torch.no_grad():
        for p, v in zip(params, init):
            p.copy_(v)
    opt = optimizer.Dpsgd(learning_rate=1e-3, clip=10.0,
                          batch_size=float(TRAIN_B), sigma=1e-3,
                          parameters=params, seed=5)
    dl = []
    for x, y in batches:
        loss = loss_fn(model(*x), *y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        dl.append(float(loss.detach()))
    require(all(math.isfinite(x) for x in dl)
            and not same(params, init), "optimizers (d) Dpsgd: %s" % dl)
    try:
        make_train_step(model, loss_fn, opt)(*batches[0])
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise SystemExit("chip_smoke FAILED: make_train_step took Dpsgd")
    say("optimizers (d) Dpsgd: %d eager steps, losses %s; make_train_step "
        "refused it: %s" % (OPT_STEPS, ["%.4f" % x for x in dl], refused))
    say("optimizers (d): %d rules on gpt2-small at %d layers, B=%d T=%d bf16 "
        "O2, in %.1f s (%s)" % (len(OPT_RULES), OPT_LAYERS, TRAIN_B, TRAIN_T,
                                time.perf_counter() - t_all, card))
    del model, opt, params, init
    free_memory(torch)


# ---------------------------------------------------------------------------
# serving


def make_requests(np, n=16):
    """16 prompts of 2-256 tokens asking 16-64 new tokens, from
    RandomState(0); requests 2 and 6 share a 128-token head."""
    rs = np.random.RandomState(0)
    lengths = rs.randint(2, 257, n)
    news = rs.randint(16, 65, n)
    head = rs.randint(1, VOCAB_TOKENS, 128)
    prompts = [rs.randint(1, VOCAB_TOKENS, int(L)) for L in lengths]
    for i in (2, 6):
        tail = rs.randint(1, VOCAB_TOKENS, int(rs.randint(1, 129)))
        prompts[i] = np.concatenate([head, tail])
    return [(p, int(m)) for p, m in zip(prompts, news)]


def recording_engine(torch, GenerationEngine):
    class RecordingEngine(GenerationEngine):
        """Keeps each request's top-2 logit gap at every step (plain
        comparison runs only), keyed by the request's prompt object. The
        step programs write the gaps into a static buffer, which each
        step's replay overwrites: it is read right after the step."""

        batcher = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps = {}
            self._gap = torch.zeros(self.max_batch, device=self.device)

        def _logits(self, hidden):
            logits = super()._logits(hidden)
            top = torch.topk(logits.float(), 2, dim=-1).values
            gap = (top[..., 0] - top[..., 1]).reshape(-1)
            self._gap[:gap.numel()].copy_(gap)
            return logits

        def prefill(self, slot, prompt):
            tok = super().prefill(slot, prompt)
            self.gaps.setdefault(id(prompt), []).append(float(self._gap[0]))
            return tok

        def decode(self):
            out = super().decode()
            gap = self._gap.cpu()
            for s, req in enumerate(self.batcher.slots):
                if req is not None:
                    self.gaps.setdefault(id(req.prompt), []).append(
                        float(gap[s]))
            return out
    return RecordingEngine


def eager_engine(GenerationEngine):
    class EagerEngine(GenerationEngine):
        """The engine's step bodies run eagerly on every call: no program
        is built, captured or replayed."""

        def _run(self, key, body):
            body()
    return EagerEngine


def serve(serving, engine, reqs):
    """Serve `reqs` through ContinuousBatcher; returns (requests, wall s,
    the run's decode step wall times in ms)."""
    batcher = serving.ContinuousBatcher(engine)
    engine.batcher = batcher
    steps = []
    decode = engine.decode

    def timed_decode():
        t0 = time.perf_counter()
        out = decode()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out
    engine.decode = timed_decode
    rs = [serving.Request(prompt=p.copy(), max_new_tokens=m)
          for p, m in reqs]
    t0 = time.perf_counter()
    try:
        for r in rs:
            batcher.submit(r)
        batcher.run_until_idle(max_steps=10_000)
    finally:
        # later decode steps (the profile, a second pass) are not this run's
        engine.decode = decode
    wall = time.perf_counter() - t0
    for r in rs:
        require(r.outcome == "completed" and len(r.tokens) == r.max_new_tokens,
                "request %d did not complete (%s, %d/%d tokens)"
                % (r.rid, r.outcome, len(r.tokens), r.max_new_tokens))
    return rs, wall, steps


def profile_decode(torch, engine, n=10):
    """Device time of `n` decode steps from torch.profiler: (kernel ms per
    step, the 5 kernels with most device time). 0 ms when the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine.decode()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total_us = sum(t for t, _, _ in rows)
    return total_us / n / 1e3, rows[:5]


def program_launches(engines, launches):
    """Launch accounting through the engines' step programs: each
    program's runs (its build's eager run and its replays) times its
    launches a run must add up to `launches`, the counts of the run.
    Returns (the flash forward's launches by prefill bucket, the launches
    that replays made)."""
    total = dict.fromkeys(launches, 0)
    replayed = dict.fromkeys(launches, 0)
    by_t = {}
    for progs in (eng._programs for eng in engines):
        for key, per_run in progs.launches.items():
            for name, n in per_run.items():
                total[name] += progs.runs(key) * n
                replayed[name] += progs.replays[key] * n
            if key[0] == "prefill":
                by_t[key[1]] = (by_t.get(key[1], 0)
                                + progs.runs(key) * per_run["flash_fwd"])
    require(total == launches,
            "launch counts %s are not the programs' runs x launches %s"
            % (launches, total))
    return by_t, replayed


def report_programs(label, eng, card):
    """The compile-once contract and each program's build."""
    progs = eng._programs
    for key in sorted(progs.builds, key=str):
        say("%s program %s: %d replays, launches a run %s, captured in "
            "%.1f ms (%s)" % (label, key, progs.replays[key],
                              {k: n for k, n in progs.launches[key].items()
                               if n}, progs.capture_s[key] * 1e3, card))
    say("%s programs: %d prefill, %d suffix, %d decode; graph pool %.1f "
        "MiB (%s)" % (label, eng.prefill_compiles,
                      eng.suffix_prefill_compiles, eng.decode_compiles,
                      progs.pool_bytes() / 2**20, card))
    require(eng.decode_compiles == 1,
            "%s: %d decode programs" % (label, eng.decode_compiles))
    require(eng.prefill_compiles <= len(BUCKETS),
            "%s: %d prefill programs" % (label, eng.prefill_compiles))
    require(eng.suffix_prefill_compiles >= 1,
            "%s: no suffix program (requests 2 and 6 share a head)" % label)
    require(all(progs.replays[key] > 0 for key in progs.builds
                if key[0] == "decode"), "%s: decode never replayed" % label)


def serve_line(label, rs, wall, steps, card):
    ntok = sum(len(r.tokens) for r in rs)
    say("%s: %d requests, %d tokens in %.3f s: %.1f tokens/s; TTFT p50 %.1f "
        "ms; %d decode steps, %.2f ms/step median, %.2f ms/step mean (%s)"
        % (label, len(rs), ntok, wall, ntok / wall,
           statistics.median(r.ttft_s for r in rs) * 1e3, len(steps),
           statistics.median(steps), statistics.mean(steps), card))


def serve_again(serving, eng, rq, first, label, card):
    """The same requests again on the same engine, its slots dirty, with a
    fresh prefix cache: every program is built, so every call replays;
    the tokens must be the first pass's."""
    built = dict(eng._programs.builds)
    eng.prefix_cache = serving.PrefixCache(eng.prefix_cache.max_bytes,
                                           eng.buckets)
    rs, wall, steps = serve(serving, eng, rq)
    require(eng._programs.builds == built,
            "%s: the second pass built a program" % label)
    require([r.tokens for r in rs] == [r.tokens for r in first],
            "%s: the second pass gave other tokens" % label)
    serve_line("%s again (every program built, same tokens)" % label, rs,
               wall, steps, card)
    return sum(len(r.tokens) for r in rs) / wall


def graph_against_eager(torch, serving, model, cfg, rq, graph_reqs,
                        graph_state, label, card, **kw):
    """The same requests through the engine's step bodies run eagerly:
    tokens identical and the final cache (k, v, scales, lens) bit-equal
    to the graph-replayed run's."""
    e = eager_engine(serving.GenerationEngine)(model, **cfg, **kw)
    ereqs, wall, steps = serve(serving, e, rq)
    for a, b in zip(graph_reqs, ereqs):
        require(a.tokens == b.tokens,
                "%s: request %d's tokens differ between the replayed "
                "programs and the eager bodies" % (label, a.rid))
    names = ("k", "v", "k_scale", "v_scale", "lens")
    if len(graph_state) == 3:
        names = ("k", "v", "lens")
    for name, g, t in zip(names, graph_state, e.kv.state()):
        require(g.dtype == t.dtype and torch.equal(g, t),
                "%s: the cache's %s differs between the replayed programs "
                "and the eager bodies" % (label, name))
    say("%s graph against eager: %d requests token-identical, %s bit-equal"
        % (label, len(ereqs), ", ".join(names)))
    serve_line("%s eager bodies" % label, ereqs, wall, steps, card)


def report_decode_profile(label, dev_ms, step_ms, top, card):
    if dev_ms > 0:
        say("%s decode step profile: %.3f ms of kernels per step (torch."
            "profiler, 10 steps) vs %.2f ms wall: device idle %.1f %% (%s)"
            % (label, dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms),
               card))
        for t_us, key, count in top:
            say("  %8.1f us/step  %5d launches  %s"
                % (t_us / 10, count, key[:90]))
    else:
        say("%s decode step profile: not measured (the profiler saw no "
            "device activity)" % label)


def compare_tokens(kernel_reqs, plain_reqs, gaps, kv_dtype):
    same = 0
    for a, b in zip(kernel_reqs, plain_reqs):
        if a.tokens == b.tokens:
            same += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        gap = float(gaps[id(b.prompt)][i])
        say("request %d: tokens first differ at step %d, plain top-2 "
            "logit gap %.3g (tie tolerance %.0e)"
            % (a.rid, i, gap, TIE_TOL[kv_dtype]))
        require(gap < TIE_TOL[kv_dtype],
                "request %d differs from the plain run at step %d where "
                "the plain top-2 gap %.3g is no near tie" % (a.rid, i, gap))
    say("compare %s: %d/%d requests token-identical to the plain run, the "
        "rest first differ at near ties" % (kv_dtype, same, len(kernel_reqs)))
    return same


# ---------------------------------------------------------------------------
# the server: InferenceServer on the card


# request i is submitted from thread i % SERVER_THREADS, each thread pausing
# SERVER_STAGGER_S between its submissions
SERVER_THREADS = 4
SERVER_STAGGER_S = 0.005
TELEMETRY_STEPS = 50


def scrape(url, route):
    """(status, body) of a GET on the server's live plane."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + route, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def statusz(url):
    code, body = scrape(url, "/statusz")
    require(code == 200, "/statusz answered %d" % code)
    return json.loads(body)


def submit_from_threads(srv, reqs):
    """Submit `reqs` from SERVER_THREADS threads; the handles in request
    order."""
    import threading
    handles = [None] * len(reqs)

    def submitter(k):
        for i in range(k, len(reqs), SERVER_THREADS):
            p, m = reqs[i]
            handles[i] = srv.submit(p.tolist(), max_new_tokens=m)
            time.sleep(SERVER_STAGGER_S)
    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(SERVER_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    require(all(h is not None for h in handles),
            "a submitting thread did not submit its requests")
    return handles


def timed_decodes(engines):
    """Record each engine's decode step wall times (ms) into one list."""
    steps = []
    for eng in engines:
        def timed(decode=eng.decode):
            t0 = time.perf_counter()
            out = decode()
            steps.append((time.perf_counter() - t0) * 1e3)
            return out
        eng.decode = timed
    return steps


def server_pass(torch, srv, reqs, plain, gaps, label, kv_dtype, steps,
                card):
    """Serve `reqs` once through the started server `srv`, submitted from
    SERVER_THREADS threads; scrape /healthz and /metrics while it serves
    and /statusz before and after; hold the tokens to the plain run's rule
    and /statusz's serving and hbm blocks to the run. Returns (tokens/s,
    /statusz before, after)."""
    url = srv._http.url
    before = statusz(url)
    del steps[:]
    t0 = time.perf_counter()
    handles = submit_from_threads(srv, reqs)
    code, _ = scrape(url, "/healthz")
    require(code == 200, "%s: /healthz answered %d while serving"
            % (label, code))
    code, text = scrape(url, "/metrics")
    require(code == 200 and "pt_serve_queue_depth" in text,
            "%s: /metrics answered %d without the queue gauge"
            % (label, code))
    rs = [h.request for h in handles]
    for h, (_, m) in zip(handles, reqs):
        require(len(h.result(timeout=600)) == m,
                "%s: request %d gave %d of %d tokens"
                % (label, h.request.rid, len(h.request.tokens), m))
    wall = time.perf_counter() - t0
    after = statusz(url)
    reserved = torch.cuda.memory_reserved()
    code, body = scrape(url, "/healthz")
    require(code == 200, "%s: /healthz answered %d after serving: %s"
            % (label, code, body))
    ntok = sum(len(r.tokens) for r in rs)
    now, then = after["serving"], before["serving"]
    done = now["completed"] - then.get("completed", 0)
    toks = now["tokens"] - then.get("tokens", 0)
    require(done == len(reqs) and toks == ntok,
            "%s: /statusz counted %d requests and %d tokens, the handles "
            "%d and %d" % (label, done, toks, len(reqs), ntok))
    require("ttft_ms" in now, "%s: /statusz has no ttft_ms" % label)
    hbm = after.get("hbm_bytes", {})
    require(0 < hbm.get("in_use", 0) <= reserved,
            "%s: /statusz hbm in_use %s not in (0, reserved %d]"
            % (label, hbm.get("in_use"), reserved))
    compare_tokens(rs, plain, gaps, kv_dtype)
    say("%s: %d requests from %d threads, %d tokens in %.3f s: %.1f "
        "tokens/s; TTFT p50 %.1f ms; %d decode steps, %.2f ms/step median; "
        "/statusz: TTFT p50 %s ms, hbm in_use %.1f MiB (%s)"
        % (label, len(rs), SERVER_THREADS, ntok, wall, ntok / wall,
           statistics.median(r.ttft_s for r in rs) * 1e3, len(steps),
           statistics.median(steps), now["ttft_ms"].get("p50"),
           hbm["in_use"] / 2**20, card))
    return ntok / wall, before, after


def programs_built(engines):
    """Programs the engines built, by StepTelemetry engine label."""
    built = {"serve_prefill": sum(e.prefill_compiles for e in engines),
             "serve_suffix": sum(e.suffix_prefill_compiles for e in engines),
             "serve_decode": sum(e.decode_compiles for e in engines)}
    return {k: n for k, n in built.items() if n}


def retraced(before, after):
    """Programs built between two /statusz reads, by engine."""
    then = before.get("train", {}).get("retraces", {})
    now = after.get("train", {}).get("retraces", {})
    return {e: n - then.get(e, 0) for e, n in now.items() if n - then.get(e, 0)}


def server_run(torch, ck, serving, model, cfg, reqs, plain, gaps, label,
               card, hb_path, workers=1, kv_dtype="float32"):
    """`reqs` through a fresh InferenceServer(workers, http_port=0) twice:
    on fresh engines (each builds its programs), then again with fresh
    prefix caches (one worker: every program built). /statusz's retraces
    must equal the programs built, the heartbeat must be fresh, and the
    launch counts,
    zeroed before the first pass and read after the second, must add up
    to the programs' runs, with the kernels launched through replays.
    Returns (the server, its launches, tokens/s of each pass)."""
    from paddle_tpu_torch.resilience import health
    srv = serving.InferenceServer(model, workers=workers, http_port=0,
                                  kv_dtype=kv_dtype, **cfg)
    engines = srv.engines
    steps = timed_decodes(engines)
    srv.start()
    try:
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        tps1, before, after = server_pass(torch, srv, reqs, plain, gaps,
                                          label, kv_dtype, steps, card)
        built = programs_built(engines)
        require(retraced(before, after) == built,
                "%s: /statusz retraces %s are not the programs built %s"
                % (label, retraced(before, after), built))
        require(all(e.decode_compiles == 1 for e in engines),
                "%s: an engine built no decode program: %s"
                % (label, [e.decode_compiles for e in engines]))
        for e in engines:
            e.prefix_cache = serving.PrefixCache(e.prefix_cache.max_bytes,
                                                 e.buckets)
        # two workers may deal the requests out otherwise the second time,
        # and a worker then builds a program for a bucket new to it
        tps2, before2, after2 = server_pass(
            torch, srv, reqs, plain, gaps, label + " again", kv_dtype,
            steps, card)
        built2 = programs_built(engines)
        new = {k: n - built.get(k, 0) for k, n in built2.items()
               if n != built.get(k, 0)}
        require(retraced(before2, after2) == new,
                "%s: /statusz retraces %s of the second pass are not the "
                "programs it built %s" % (label, retraced(before2, after2),
                                          new))
        require(workers > 1 or not new,
                "%s: the second pass built programs %s" % (label, new))
        say("%s: the second pass built %s" % (label, new or "nothing"))
        launches = ck.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        srv.stop()
    hb = health.read_heartbeat(hb_path)
    stale = health.stale_seconds(hb_path)
    require(hb is not None and hb["pid"] == os.getpid() and stale < 30,
            "%s: heartbeat %s is stale (%s s)" % (label, hb, stale))
    _, replayed = program_launches(engines, launches)
    say("%s launches (both passes) %s, through replays %s" % (
        label, {k: n for k, n in launches.items() if n},
        {k: n for k, n in replayed.items() if n}))
    kernel = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    for name in ("flash_fwd", kernel):
        require(launches[name] > 0 and replayed[name] > 0,
                "%s: %s launched %d times, %d through replays"
                % (label, name, launches[name], replayed[name]))
    say("%s: retraces %s; graph pools %s MiB; peak memory %.1f MiB over "
        "both passes (%s)"
        % (label, retraced(before, after),
           ", ".join("%.1f" % (e._programs.pool_bytes() / 2**20)
                     for e in engines), peak / 2**20, card))
    return srv, launches, tps1, tps2


def crash_drill(serving, model, cfg, flight_dir):
    """A worker whose decode raises on its third call: its handles fail
    with the fault chained, a crash bundle with memory.json is written,
    /healthz reads 503 naming the dead worker, then 200 after stop()."""
    import glob

    class InjectedFault(RuntimeError):
        pass
    srv = serving.InferenceServer(model, workers=1, http_port=0, **cfg)
    eng = srv.engines[0]
    calls = []

    def failing_decode(decode=eng.decode):
        calls.append(1)
        if len(calls) == 3:
            raise InjectedFault("injected decode fault (crash drill)")
        return decode()
    eng.decode = failing_decode
    srv.start()
    try:
        url = srv._http.url
        handles = [srv.submit([1, 2, 3 + i], max_new_tokens=8)
                   for i in range(2)]
        for h in handles:
            try:
                h.result(timeout=120)
                cause = None
            except RuntimeError as e:     # the drill's expected failure
                cause = e.__cause__
            require(isinstance(cause, InjectedFault),
                    "crash drill: a handle did not fail with the fault")
        srv._threads[0].join(30)
        code, body = scrape(url, "/healthz")
        check = json.loads(body)["checks"]["serve_loop"]
        require(code == 503 and "pt-serve-0" in check["detail"],
                "crash drill: /healthz answered %d: %s" % (code, check))
    finally:
        srv.stop()
    code, _ = scrape(url, "/healthz")
    require(code == 200, "crash drill: /healthz answered %d after stop()"
            % code)
    bundles = glob.glob(os.path.join(flight_dir, "crash", "*"))
    files = sorted(os.listdir(bundles[0])) if len(bundles) == 1 else []
    require(files == sorted(["MANIFEST.json", "ring.jsonl", "stacks.txt",
                             "metrics.json", "env.json", "memory.json"]),
            "crash drill: bundles %s, files %s" % (bundles, files))
    with open(os.path.join(bundles[0], "memory.json")) as f:
        memory = json.load(f)
    require(memory.get("device_kind") and memory.get("buffers"),
            "crash drill: memory.json lacks the device or its buffers")
    say("crash drill: both handles failed with the injected fault, "
        "/healthz 503 (%s), 200 after stop(); bundle %s with %s; "
        "memory.json: %d live blocks, %.1f MiB, %d samples"
        % (check["detail"], os.path.basename(bundles[0]), ", ".join(files),
           memory["buffers"]["n_arrays"],
           memory["buffers"]["total_bytes"] / 2**20,
           len(memory["hbm_history"])))


def telemetry_cost(torch, tracing, eng, card):
    """The built engine's decode step wall time with telemetry off and on,
    in turns (off, on, on, off), TELEMETRY_STEPS steps each way. On, the
    phase samples device memory after every step, telemetry's dearest
    setting (the default samples every 0.5 s)."""
    times = {False: [], True: []}
    decode = type(eng).decode          # not the server run's timing wrapper
    for on in (False, True, True, False):
        tracing.enable(on)
        try:
            for _ in range(TELEMETRY_STEPS // 2):
                t0 = time.perf_counter()
                decode(eng)
                times[on].append((time.perf_counter() - t0) * 1e3)
        finally:
            tracing.enable(True)
    off, on = (statistics.median(times[k]) for k in (False, True))
    say("telemetry cost: decode step %.4f ms with tracing off, %.4f ms on "
        "(median of %d each, in turns): %+.2f %% (%s)"
        % (off, on, TELEMETRY_STEPS, 100.0 * (on - off) / off, card))
    # the same steps' kernels: idle slots keep decoding into their tails,
    # so the paged kernel's work grows with each step here
    dev_ms, top = profile_decode(torch, eng)
    report_decode_profile("server (a) engine, idle slots", dev_ms, on, top,
                          card)


# ---------------------------------------------------------------------------
# 20. Model.fit on the card

FIT_ITERS = 13                  # (a): fit's steps, num_iters
FIT_TIMED = 10                  # (a): the last 10 step intervals
FIT_WORKERS = 2                 # (a): DataLoader worker processes
FIT_DRILL = dict(layers=2, B=TRAIN_B, T=TRAIN_T, epochs=2, steps=4,
                 sigterm=5)     # (b): 2 epochs x 4 steps, SIGTERM before 6
FIT_RESNET_WARMUP, FIT_RESNET_STEPS = 3, 20     # (c)
FIT_RESNET_WORKERS = 4
FIT_RESNET_EVAL, FIT_RESNET_PREDICT = 4, 2      # batches
LENET_B, LENET_WARMUP, LENET_STEPS = 256, 2, 50  # (d): bench.py:27-53
LENET_SYNTH = "8192"            # bench.py:17's PADDLE_TPU_SYNTH_SAMPLES


class TokenPairs:
    """The bench's synthetic token stream (benchmarks/train_bench.py) as
    (input ids, next ids) pairs, items start .. start + n: a class at
    module level, so that spawned DataLoader workers can unpickle it."""

    def __init__(self, vocab, T, n=100000, start=0):
        self.vocab, self.T, self.n, self.start = vocab, T, n, start

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(self.start + i)
        ids = rs.randint(0, self.vocab, (self.T + 1,)).astype(np.int64)
        return ids[:-1], ids[1:]


class ImageSet:
    """bench_resnet50's data as a map-style dataset: sample i is
    RandomState(i)'s float32 rand(3, 224, 224) image and a [1] int64
    label below 100, or the image alone (`labels=False`, for predict); a
    class at module level, for spawned workers."""

    def __init__(self, n, hw=224, classes=100, labels=True):
        self.n, self.hw, self.classes = n, hw, classes
        self.labels = labels

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        x = rs.rand(3, self.hw, self.hw).astype(np.float32)
        if not self.labels:
            return x
        return x, np.array([rs.randint(0, self.classes)], np.int64)


def fit_recorder(Callback):
    from paddle_tpu_torch.io.prefetch import FEED_STALL

    class Recorder(Callback):
        """Each train batch's logs, the host clock at its end and the feed
        stall histogram's (sum, count) then; with `profile_at`, a
        torch.profiler trace of that batch (its wall ms and kernel
        rows)."""

        def __init__(self, torch=None, profile_at=None):
            super().__init__()
            self.logs, self.ends, self.stalls = [], [], []
            self.torch, self.profile_at = torch, profile_at
            self.prof = self.prof_ms = None

        def on_train_batch_begin(self, step, logs=None):
            if step == self.profile_at:
                from torch.profiler import ProfilerActivity, profile
                self.torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            if step == self.profile_at and self.prof is not None:
                self.torch.cuda.synchronize()
                self.prof_ms = (time.perf_counter() - self._t0) * 1e3
                self.prof.__exit__(None, None, None)
            self.logs.append(dict(logs or {}))
            self.ends.append(time.perf_counter())
            self.stalls.append((FEED_STALL.sum, FEED_STALL.count))

        def stall_after_first(self):
            """pt_feed_stall_ms a batch over the batches after the first
            (whose wait holds the workers' start)."""
            (s0, n0), (s1, n1) = self.stalls[0], self.stalls[-1]
            return (s1 - s0) / (n1 - n0) if n1 > n0 else float("nan")

        def step_ms(self, last):
            gaps = [(b - a) * 1e3 for a, b in zip(self.ends, self.ends[1:])]
            return statistics.median(gaps[-last:]), gaps[-last:]

        def profile_rows(self):
            from torch.autograd import DeviceType
            rows = sorted(((e.self_device_time_total, e.key, e.count)
                           for e in self.prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          reverse=True)
            return sum(t for t, _, _ in rows) / 1e3, rows
    return Recorder


def first_batches(loader, n):
    """The loader's first n host batches; its workers stopped after."""
    it = loader._host_iter()
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def stall_since(FEED_STALL, before):
    n = FEED_STALL.count - before[1]
    return (FEED_STALL.sum - before[0]) / n if n else float("nan")


def gpt2_fit_setup(torch, dev="cuda", name="gpt2_small", **kw):
    """Phase 10's GPT-2 setup for fit: seed 0, gpt2_small (dropouts 0.1;
    `name`: another factory of paddle_tpu_torch.models), AdamW(LinearWarmup
    to 1e-4 over 4 steps, weight_decay=0.01), decorate O2 bfloat16, the
    criterion."""
    from paddle_tpu_torch import amp, models, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.optimizer import lr
    prandom.seed(0)
    model = getattr(models, name)(seed=0, device=dev, **kw)
    model.train()
    sched = lr.LinearWarmup(TRAIN_LR, warmup_steps=4, start_lr=0.0,
                            end_lr=TRAIN_LR)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                          parameters=model.parameters(), device=dev)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, opt, sched, models.GPTPretrainingCriterion()


def fit_gpt2(torch, ck, card, off_ms, off_launches):
    """Phase 20 (a): GPT-2-small at full width and depth through
    Model.fit, against a make_train_step loop over the same batches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi.callbacks import Callback, LRScheduler
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.jit import make_train_step
    Recorder = fit_recorder(Callback)
    model, opt, sched, crit = gpt2_fit_setup(torch)
    vocab = model.gpt.vocab_size
    data = TokenPairs(vocab, TRAIN_T)
    L = len(model.gpt.layers)
    want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "adamw": adamw_launches(model.parameters()),
            "dropout_keep": 2 * L + 1}
    # the loader's batches: 2 workers against the consumer's own, in order
    loaders = [io.DataLoader(data, batch_size=TRAIN_B, num_workers=w)
               for w in (FIT_WORKERS, 0)]
    t0 = time.perf_counter()
    host = [first_batches(ld, FIT_ITERS) for ld in loaders]
    mp_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for x, y in zip(*host)
               for a, b in zip(x, y))
    require(len(host[0]) == len(host[1]) == FIT_ITERS and same,
            "fit (a): the batches of %d workers differ from those of 0"
            % FIT_WORKERS)
    say("fit (a): %d batches from %d worker processes (start method %s) "
        "bit-equal to num_workers=0's, in order; pinned: %s"
        % (FIT_ITERS, FIT_WORKERS, "spawn" if torch.cuda.is_initialized()
           else "fork", host[0][0][0].is_pinned()))
    del host
    rec = Recorder(torch, profile_at=FIT_ITERS - 1)
    net = paddle.Model(model)
    net.prepare(opt, crit)
    tdir = tempfile.mkdtemp(prefix="fit_tele_")
    try:
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        ck.launch_counts(reset=True)
        t0 = time.perf_counter()
        net.fit(data, batch_size=TRAIN_B, shuffle=False,
                num_workers=FIT_WORKERS, num_iters=FIT_ITERS, verbose=0,
                telemetry_dir=tdir,
                callbacks=[LRScheduler(by_step=True), rec])
        fit_s = time.perf_counter() - t0
        launches = ck.launch_counts()
        stall_mp = stall_since(FEED_STALL, stall0)
        doctor = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools", "ptdoctor.py"),
             "summary", tdir], capture_output=True, text=True, timeout=120)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    step = net._train_step_fn
    progs = step.programs
    (key,) = progs.builds
    replayed = {k: progs.replays[key] * n for k, n in
                progs.launches[key].items()}
    losses = [lg["loss"] for lg in rec.logs]
    require(len(losses) == FIT_ITERS and all(map(math.isfinite, losses)),
            "fit (a): losses %s" % losses)
    require(step.compiles == 1 and step.replays == FIT_ITERS - 1,
            "fit (a): %d programs and %d replays in %d steps"
            % (step.compiles, step.replays, FIT_ITERS))
    per_step = {k: launches[k] / FIT_ITERS for k in want}
    require(per_step == {k: float(v) for k, v in want.items()},
            "fit (a): launches a step %s, want %s (phase 10's)"
            % (per_step, want))
    if off_launches is not None:
        ten = {k: off_launches[k] / (TRAIN_WARMUP + TRAIN_STEPS)
               for k in want}
        require(per_step == ten, "fit (a): launches a step %s, phase 10's "
                "step %s" % (per_step, ten))
    require(all(replayed[k] == v * (FIT_ITERS - 1) for k, v in want.items()),
            "fit (a): launches through replays %s" % replayed)
    require(doctor.returncode == 0, "fit (a): ptdoctor summary failed: "
            + doctor.stderr[-400:])
    require("retraces: jit_train=1" in doctor.stdout
            and "last-alive step=%d" % FIT_ITERS in doctor.stdout,
            "fit (a): ptdoctor summary: " + doctor.stdout[-600:])
    fit_ms, gaps = rec.step_ms(FIT_TIMED)
    dev_ms, top = rec.profile_rows()
    lr_seen = opt.get_lr()
    say("fit (a) GPT-2-small B=%d T=%d O2 bf16 through Model.fit "
        "(num_workers=%d, LRScheduler by step, telemetry_dir): %d steps in "
        "%.1f s, losses %s, lr after %.3g; one program (%d replays), "
        "launches a step %s, all through replays; ptdoctor: %s"
        % (TRAIN_B, TRAIN_T, FIT_WORKERS, FIT_ITERS, fit_s,
           ["%.4f" % x for x in losses], lr_seen, step.replays,
           {k: int(v) for k, v in per_step.items()},
           " | ".join(ln.strip() for ln in doctor.stdout.splitlines()
                      if "retraces" in ln or "last-alive" in ln)))
    del net, step, progs
    model, opt = None, None
    free_memory(torch)

    # the same batches through a make_train_step loop from the same seed
    model, opt, sched, crit = gpt2_fit_setup(torch)
    loop = make_train_step(model, lambda o, y: crit(o, y), opt)
    loader = io.DataLoader(data, batch_size=TRAIN_B, prefetch_to_device=2)
    stall0 = (FEED_STALL.sum, FEED_STALL.count)
    ref, ends = [], []
    feed = iter(loader)
    for _ in range(FIT_ITERS):
        x, y = next(feed)
        loss, _ = loop([x], [y])
        ref.append(float(loss))
        sched.step()
        ends.append(time.perf_counter())
    feed.close()
    stall_0 = stall_since(FEED_STALL, stall0)
    loop_gaps = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])][-FIT_TIMED:]
    loop_ms = statistics.median(loop_gaps)
    require(losses == ref, "fit (a): fit's losses %s differ from the "
            "make_train_step loop's %s" % (losses, ref))
    say("fit (a): the per-step losses bit-equal to a make_train_step loop "
        "over the same batches from the same seed and RNG state (%d steps)"
        % FIT_ITERS)
    idle = ("%.1f %% (%.3f ms of kernels in a %.2f ms profiled fit step)"
            % (100.0 * (1.0 - dev_ms / rec.prof_ms), dev_ms, rec.prof_ms)
            if dev_ms > 0 else "not measured (the profiler saw no device "
            "activity)")
    say("fit (a) step %.2f ms (host clock between batch ends, median of the "
        "last %d; min %.2f max %.2f), the make_train_step loop over the "
        "same batches %.2f ms (the same clock)%s; pt_feed_stall_ms %.3f a "
        "batch at %d workers (%.3f after the first batch, whose wait holds "
        "the workers' start), %.3f at 0 (the loop); device idle in one "
        "profiled fit step %s (%s)"
        % (fit_ms, FIT_TIMED, min(gaps), max(gaps), loop_ms,
           "" if off_ms is None else ", phase 10's captured step %.2f ms"
           % off_ms, stall_mp, FIT_WORKERS, rec.stall_after_first(),
           stall_0, idle, card))
    report_profile("fit (a) profiled", dev_ms, rec.prof_ms, top)
    say("fit (a) host read of the batches from %d workers: %.2f s for %d "
        "batches (with the workers' start)" % (FIT_WORKERS, mp_s, FIT_ITERS))
    del loop, model, opt
    free_memory(torch)
    return {"fit_ms": fit_ms, "loop_ms": loop_ms, "stall_mp": stall_mp,
            "stall_0": stall_0, "stall_later": rec.stall_after_first(),
            "idle": idle}


def fit_drill(cfg):
    """One run of phase 20 (b)'s drill (`--fit-drill JSON`): gpt2_small
    (or cfg["model"]) cut to cfg["layers"] layers at full width (phase
    10's setup otherwise: `gpt2_fit_setup`) through Model.fit over cfg["epochs"] epochs of
    cfg["steps"] batches of cfg["B"] x cfg["T"], with auto_checkpoint_dir
    cfg["root"] and the LRScheduler callback; each step's loss is appended
    to cfg["log"] under its global step (the optimizer's count). Under
    PADDLE_TPU_CHAOS=sigterm_at_step:K fit checkpoints and exits 0; a
    finished fit prints DRILL_DONE with `state_digest`."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback, LRScheduler

    dev, B = cfg["device"], cfg["B"]
    model, opt, _, crit = gpt2_fit_setup(
        torch, dev, cfg.get("model", "gpt2_small"), num_layers=cfg["layers"])

    class Log(Callback):
        def on_train_batch_end(self, step, logs=None):
            with open(cfg["log"], "a") as f:
                f.write(json.dumps({"step": opt._step_count - 1,
                                    "loss": logs["loss"]}) + "\n")

    net = paddle.Model(model, device=dev)
    net.prepare(opt, crit)
    net.fit(TokenPairs(model.gpt.vocab_size, cfg["T"], n=cfg["steps"] * B),
            batch_size=B, epochs=cfg["epochs"], shuffle=False, verbose=0,
            auto_checkpoint_dir=cfg["root"],
            callbacks=[LRScheduler(by_step=True), Log()])
    say("DRILL_DONE %s" % state_digest(torch, model, opt))
    return 0


def run_fit_drill(root, log, chaos_spec="", **cfg):
    """`fit_drill` in a fresh process: (exit code, stdout, stderr, wall s,
    losses by step)."""
    cfg = dict(cfg, root=root, log=log)
    env = dict(os.environ, PADDLE_TPU_CHAOS=chaos_spec)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--fit-drill",
         json.dumps(cfg)], env=env, capture_output=True, text=True,
        timeout=DRILL_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    losses = {}
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return (out.returncode, out.stdout, out.stderr,
            time.perf_counter() - t0, losses)


def fit_preempt(torch, card, **over):
    """Phase 20 (b): the preemption drill, each run a fresh process
    (`over`: settings of the drill's JSON to change, for a rehearsal)."""
    d = FIT_DRILL
    cfg = dict(dict(device="cuda", layers=d["layers"], B=d["B"], T=d["T"],
                    epochs=d["epochs"], steps=d["steps"]), **over)
    total = d["epochs"] * d["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        rc, out, err, s_ref, ref = run_fit_drill(
            os.path.join(tmp, "ref"), os.path.join(tmp, "ref.log"), **cfg)
        require(rc == 0 and sorted(ref) == list(range(total)),
                "fit (b): the uninterrupted fit failed (rc %d, steps %s): %s"
                % (rc, sorted(ref), err[-1500:]))
        want = drill_digest(out, "DONE")
        root, log = os.path.join(tmp, "run"), os.path.join(tmp, "run.log")
        rc1, out1, err1, s1, first = run_fit_drill(
            root, log, "sigterm_at_step:%d" % d["sigterm"], **cfg)
        ckpt = os.path.join(root, "preempt_ckpt")
        require(rc1 == 0 and drill_digest(out1, "DONE") is None
                and sorted(first) == list(range(d["sigterm"] + 1))
                and os.path.isfile(os.path.join(ckpt, "COMMIT")),
                "fit (b): the preempted fit (rc %d, steps %s, checkpoint %s)"
                ": %s" % (rc1, sorted(first), os.path.isdir(ckpt),
                          err1[-1500:]))
        rc2, out2, err2, s2, losses = run_fit_drill(root, log, **cfg)
        got = drill_digest(out2, "DONE")
        require(rc2 == 0 and got is not None,
                "fit (b): the relaunch failed (rc %d): %s" % (rc2,
                                                             err2[-1500:]))
        require(losses == ref, "fit (b): losses %s, uninterrupted %s"
                % (losses, ref))
        require(got == want, "fit (b): the resumed fit's parameters and "
                "moments differ from the uninterrupted fit's")
        require(not os.path.exists(ckpt), "fit (b): preempt_ckpt left "
                "after the clean end")
    say("fit (b) preemption drill (gpt2-small cut to %d layers at full "
        "width, B=%d T=%d, dropouts 0.1, %d epochs x %d steps, "
        "auto_checkpoint_dir): SIGTERM before global step %d -> rc 0 and a "
        "committed preempt_ckpt after step %d; the relaunch resumed at "
        "epoch %d step %d: losses and the sha256 of parameters and AdamW "
        "moments bit-equal to the uninterrupted fit's, preempt_ckpt gone; "
        "runs %.1f / %.1f / %.1f s (%s)"
        % (d["layers"], d["B"], d["T"], d["epochs"], d["steps"],
           d["sigterm"], d["sigterm"], (d["sigterm"] + 1) // d["steps"],
           (d["sigterm"] + 1) % d["steps"], s_ref, s1, s2, card))


def stable_rank(torch, logits, labels):
    """Each row's label's place among its logits, largest first, ties by
    the lower class index: the order of a stable descending sort, counted
    without sorting."""
    p = logits.float()
    lab = labels.reshape(-1).long()
    own = p.gather(1, lab[:, None])
    idx = torch.arange(p.shape[1], device=p.device)
    return ((p > own).sum(1)
            + ((p == own) & (idx[None, :] < lab[:, None])).sum(1))


def fit_resnet(torch, ck, card, resnet_ms):
    """Phase 20 (c): ResNet-50 through fit, evaluate and predict."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, metric
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io.prefetch import FEED_STALL

    class SeenAccuracy(metric.Accuracy):
        """Accuracy that keeps the last logits and labels it was given."""

        def compute(self, pred, label, *args):
            self.last = (pred.detach().clone(), label.detach().clone())
            return super().compute(pred, label, *args)

    Recorder = fit_recorder(Callback)

    class TopK(Recorder):
        def on_train_batch_end(self, step, logs=None):
            pred, lab = acc.last
            rank = stable_rank(torch, pred, lab)
            n = rank.numel()
            want = [int((rank < k).sum()) / n for k in (1, 5)]
            require(logs["acc_top1"] == want,
                    "fit (c) step %d: top-1/top-5 %s, from the logits %s"
                    % (step, logs["acc_top1"], want))
            super().on_train_batch_end(step, logs)

    model, opt, loss_fn = resnet_setup()
    acc = SeenAccuracy(topk=(1, 5))
    net = paddle.Model(model)
    net.prepare(opt, loss_fn, metrics=acc)
    n_fit = (FIT_RESNET_WARMUP + FIT_RESNET_STEPS) * RESNET_B
    rec = TopK()
    eval_set = ImageSet(FIT_RESNET_EVAL * RESNET_B, RESNET_HW,
                        RESNET_CLASSES)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        t0 = time.perf_counter()
        net.fit(ImageSet(n_fit, RESNET_HW, RESNET_CLASSES),
                batch_size=RESNET_B, shuffle=False,
                num_workers=FIT_RESNET_WORKERS, verbose=0, callbacks=[rec])
        fit_s = time.perf_counter() - t0
        stall = stall_since(FEED_STALL, stall0)
        step = net._train_step_fn
        bufs = [b.detach().clone() for b in model.buffers()]
        result = net.evaluate(eval_set, batch_size=RESNET_B,
                              num_workers=FIT_RESNET_WORKERS, verbose=0)
        kept = all(torch.equal(a, b) for a, b in zip(model.buffers(), bufs))
        # the eager eval forward over the same batches
        model.eval()
        losses, hits, n, logits = [], [0, 0], 0, []
        with torch.no_grad():
            for b in range(FIT_RESNET_EVAL):
                xs, ys = zip(*[eval_set[i] for i in range(
                    b * RESNET_B, (b + 1) * RESNET_B)])
                x = torch.from_numpy(np.stack(xs)).cuda()
                y = torch.from_numpy(np.stack(ys)).cuda()
                out = model(x)
                losses.append(float(loss_fn(out, y)))
                rank = stable_rank(torch, out, y)
                hits = [h + int((rank < k).sum())
                        for h, k in zip(hits, (1, 5))]
                n += rank.numel()
                if b < FIT_RESNET_PREDICT:
                    logits.append(out.float().cpu().numpy())
        pred = net.predict(ImageSet(FIT_RESNET_PREDICT * RESNET_B,
                                    RESNET_HW, RESNET_CLASSES, False),
                           batch_size=RESNET_B, stack_outputs=True,
                           verbose=0)
    model.train()
    steps = FIT_RESNET_WARMUP + FIT_RESNET_STEPS
    require(len(rec.logs) == steps and step.compiles == 1
            and step.replays == steps - 1,
            "fit (c): %d steps, %d programs, %d replays"
            % (len(rec.logs), step.compiles, step.replays))
    want = {"loss": float(np.mean(losses)),
            "acc_top1": [hits[0] / n, hits[1] / n]}
    require(result == want, "fit (c): evaluate %s, the eager eval forward "
            "over the same batches %s" % (result, want))
    require(kept, "fit (c): evaluate changed a running statistic")
    require(len(pred) == 1 and np.array_equal(pred[0],
                                              np.concatenate(logits)),
            "fit (c): predict's logits differ from the eager forward's")
    fit_ms, gaps = rec.step_ms(FIT_RESNET_STEPS)
    say("fit (c) ResNet-50 B=%d %dx%d O1 bf16 Momentum through Model.fit "
        "(num_workers=%d, %.1f MB a batch through shared memory, "
        "Accuracy(topk=(1, 5))): %d steps in %.1f s, one program (%d "
        "replays); every step's top-1/top-5 equal to the stable rank of "
        "its labels among its logits; last losses %s"
        % (RESNET_B, RESNET_HW, RESNET_HW, FIT_RESNET_WORKERS,
           RESNET_B * 3 * RESNET_HW * RESNET_HW * 4 / 1e6, steps, fit_s,
           step.replays, ["%.4f" % lg["loss"] for lg in rec.logs[-3:]]))
    say("fit (c) evaluate over %d batches %s, bit-equal to the eager eval "
        "forward; no running statistic written; predict over %d batches "
        "bit-equal to the eager forward's logits" % (
            FIT_RESNET_EVAL, result, FIT_RESNET_PREDICT))
    say("fit (c) step %.2f ms (median of the last %d batch-end gaps, min "
        "%.2f max %.2f): %.1f images/s%s; pt_feed_stall_ms %.3f a batch "
        "(%.3f after the first batch) (%s)"
        % (fit_ms, FIT_RESNET_STEPS, min(gaps), max(gaps),
           RESNET_B / (fit_ms / 1e3), "" if resnet_ms is None else
           " beside phase 19's captured step %.2f ms (%.1f images/s)"
           % (resnet_ms, RESNET_B / (resnet_ms / 1e3)), stall,
           rec.stall_after_first(), card))
    del net, step, model, opt
    free_memory(torch)
    return {"fit_ms": fit_ms, "stall": stall}


def fit_lenet(torch, card):
    """Phase 20 (d): bench.py's bench_lenet_fit, then a one-epoch fit with
    Accuracy and ModelCheckpoint, and Model.load into a fresh Model."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    old = os.environ.get("PADDLE_TPU_SYNTH_SAMPLES")
    os.environ["PADDLE_TPU_SYNTH_SAMPLES"] = LENET_SYNTH
    try:
        train, test = MNIST(mode="train"), MNIST(mode="test")
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_SYNTH_SAMPLES")
        else:
            os.environ["PADDLE_TPU_SYNTH_SAMPLES"] = old

    def build(seed):
        # bench.py bench_lenet_fit's calls (:32-36), `paddle` the port
        paddle.seed(seed)
        model = paddle.Model(LeNet())
        opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                    learning_rate=1e-3)
        model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                      metrics=paddle.metric.Accuracy())
        return model
    model = build(0)
    x = np.stack([train[i][0] for i in range(LENET_B)]).astype(np.float32)
    y = np.asarray([train[i][1] for i in range(LENET_B)], np.int64)
    warm = [model.train_batch([x], [y])["loss"] for _ in range(LENET_WARMUP)]
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        logs = model.train_batch([x], [y])
    dt = time.perf_counter() - t0
    ips = LENET_STEPS * LENET_B / dt
    require(math.isfinite(logs["loss"]), "fit (d): loss %s" % logs)
    # after the timed loop, which runs as the bench's does: two builds
    # after paddle.seed(0) give bit-equal losses. With cuDNN's
    # deterministic algorithms only: the default weight-gradient
    # algorithm sums with atomics, so its last bits vary from run to run
    # (phase 19's float32 check needs the same for ResNet-50)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        seeded = []
        for _ in range(2):
            again = build(0)
            seeded.append([again.train_batch([x], [y])["loss"]
                           for _ in range(LENET_WARMUP)])
            del again
    finally:
        torch.backends.cudnn.deterministic = det
    require(seeded[0] == seeded[1], "fit (d): two builds after "
            "paddle.seed(0) gave losses %s and %s" % tuple(seeded))
    say("fit (d) bench.py bench_lenet_fit on the port (paddle.seed, "
        "paddle.Model, paddle.optimizer.Adam(1e-3), "
        "paddle.nn.CrossEntropyLoss): LeNet, B=%d, %d warm-up + %d "
        "train_batch calls: %.1f images/s (%.3f ms a call, host clock; %s); "
        "warm-up losses %s; two more builds after paddle.seed(0) (cuDNN "
        "deterministic) bit-equal: %s"
        % (LENET_B, LENET_WARMUP, LENET_STEPS, ips, dt / LENET_STEPS * 1e3,
           card, warm, seeded[0]))
    with tempfile.TemporaryDirectory() as save_dir:
        model = build(0)
        t0 = time.perf_counter()
        model.fit(train, batch_size=LENET_B, epochs=1, verbose=0,
                  num_workers=FIT_WORKERS, save_dir=save_dir)
        fit_s = time.perf_counter() - t0
        trained = model.evaluate(test, batch_size=LENET_B, verbose=0)
        files = sorted(os.listdir(save_dir))
        fresh = build(1)
        fresh.load(os.path.join(save_dir, "final"))
        loaded = fresh.evaluate(test, batch_size=LENET_B, verbose=0)
    require(files == ["0.pdopt", "0.pdparams", "final.pdopt",
                      "final.pdparams"], "fit (d): save_dir holds %s" % files)
    require(loaded == trained, "fit (d): evaluate after Model.load %s, the "
            "trained model's %s" % (loaded, trained))
    n = len(train)
    say("fit (d) one-epoch LeNet fit (%d samples, B=%d, %d workers, "
        "Accuracy, ModelCheckpoint): %.1f s, %.1f images/s with the "
        "workers' start; save_dir %s; evaluate %s, bit-equal after "
        "Model.load of final.pdparams/.pdopt into a fresh Model (%s)"
        % (n, LENET_B, FIT_WORKERS, fit_s, n / fit_s, files, trained, card))
    return ips


def fit_main(torch, ck, card, off_ms=None, off_launches=None,
             resnet_ms=None):
    """Phase 20: Model.fit on the card, (a)-(d) (see the module's
    docstring)."""
    t0 = time.perf_counter()
    out = {"gpt2": fit_gpt2(torch, ck, card, off_ms, off_launches)}
    t1 = time.perf_counter()
    fit_preempt(torch, card)
    t2 = time.perf_counter()
    out["resnet"] = fit_resnet(torch, ck, card, resnet_ms)
    t3 = time.perf_counter()
    out["lenet_ips"] = fit_lenet(torch, card)
    free_memory(torch)
    say("fit phase 20: %.1f s ((a) %.1f, (b) %.1f, (c) %.1f, (d) %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2,
           time.perf_counter() - t3))
    return out


# ---------------------------------------------------------------------------
# phase 21: GPT-2 long context (benchmarks/train_bench.py bench_gpt2_long)

LONG_B, LONG_T, LONG_WARMUP, LONG_STEPS = 1, 8192, 2, 10  # :229-230
LONG_H, LONG_D = 12, 64
# (c): the blockwise tier's steps from the flash path's weights and batch
LONG_CHUNKED_STEPS = 3
# (c): its losses against the flash path's under the same cut, relative
LONG_LOSS_REL_TOL = 2e-2
# (a): the plain versions' timing at T=8192 (runs, calls a run): one call
# holds [12, 8192, 8192] float32 scores (3.2 GB) and takes tens of ms
LONG_PLAIN_RUNS = (3, 1)
CHUNK_FLAG = "FLAGS_sdpa_chunked_threshold"


def long_kernels(torch, ck, F, timer, gen):
    """Phase 21 (a): the flash forward and backward at one layer of the
    long-context path (B=1, H=12, T=8192, D=64, bfloat16, causal) against
    their plain versions at p=0 and p=0.1 under one Philox word (the plain
    versions take the kernels' own bits), each held to REL_TOL bfloat16 as
    phase 3 holds T=512; then their device times beside their bounds, the
    plain versions' and torch sdpa's, at p=0.1 and p=0."""
    B, T, H, D, dt = LONG_B, LONG_T, LONG_H, LONG_D, torch.bfloat16
    tol = REL_TOL["bfloat16"]
    q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
    do = torch.randn((B, H, T, D), generator=gen, device="cuda").to(dt)
    errs = {}
    for p in (0.0, DROPOUT):
        bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
        o, lse = ck.flash_fwd_train(q, k, v, True, p, WORD, DELTA)
        dq, dsum = ck.flash_bwd_dq(q, k, v, o, do, lse, True, p, WORD, DELTA)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, dsum, True, p, WORD,
                                  DELTA)
        for t in (o, dq, dk, dv):
            require(bool(torch.isfinite(t.float()).all()),
                    "long kernels p=%g: non-finite output" % p)
        got = {"flash_fwd_train": (o, lse), "flash_bwd_dq": (dq, dsum),
               "flash_bwd_dkv": (dk, dv)}
        want = {"flash_fwd_train": lambda: ck.flash_fwd_train_plain(
                    q, k, v, True, p, bits),
                "flash_bwd_dq": lambda: ck.flash_bwd_dq_plain(
                    q, k, v, o, do, lse, True, p, bits),
                "flash_bwd_dkv": lambda: ck.flash_bwd_dkv_plain(
                    q, k, v, do, lse, dsum, True, p, bits)}
        for name, plain in want.items():
            ref = plain()
            ea, er = (max(x) for x in zip(*(abs_rel_err(g, w) for g, w in
                                            zip(got[name], ref))))
            del ref
            free_memory(torch)
            require(er <= tol, "%s B=1 H=12 T=%d D=64 bf16 causal p=%g: rel "
                    "err %.3g > %.3g" % (name, T, p, er, tol))
            errs[(name, p)] = (ea, er)
            say("check %s B=1 H=12 T=%d D=64 bf16 causal p=%g: max rel err "
                "%.3g (tol %.0e), max abs err %.3g" % (name, T, p, er, tol,
                                                       ea))
        del bits, o, lse, dq, dsum, dk, dv, got
        free_memory(torch)
    del q, k, v, do
    times = {}
    for p in (DROPOUT, 0.0):
        t = {"flash_fwd_train": fwd_timings(
            torch, ck, F, timer, gen, B, T, True, p,
            plain_runs=LONG_PLAIN_RUNS)}
        free_memory(torch)
        t.update(bwd_timings(torch, ck, F, timer, gen, B, T, True, p,
                             plain_runs=LONG_PLAIN_RUNS))
        free_memory(torch)
        times[p] = t
    return errs, times


def long_model(paddle, gpt2_small, **kw):
    """bench_gpt2_long's model (:229-230) and its harness's optimizer and
    AMP (`_gpt_train_bench` :52-73), written against `paddle` the port:
    (network, optimizer, step)."""
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    net = gpt2_small(max_position_embeddings=LONG_T + 1, **kw)
    paddle.seed(0)
    crit = GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(parameters=net.parameters(),
                                 learning_rate=1e-4, weight_decay=0.01)
    net, opt = paddle.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    return net, opt, make_train_step(net, lambda o, l: crit(o, l), opt)


def long_bench(torch, ck, paddle, gpt2_small, card):
    """Phase 21 (b): bench_gpt2_long on the card, the flash kernels on, the
    dropouts at 0.1: LONG_WARMUP + LONG_STEPS steps of the captured step,
    the launch and path counters zeroed just before and read just after;
    step ms (median), tokens/s, MFU by train_bench.py:139's formula,
    peak memory, one profiled step's idle share and kernel groups."""
    paddle.seed(0)
    net, opt, step = long_model(paddle, gpt2_small)
    # bench_gpt2_long's batch (:244-247)
    vocab = net.gpt.embeddings.word_embeddings.weight.shape[0]
    rs = np.random.RandomState(0)
    ids = paddle.to_tensor(rs.randint(0, vocab, (LONG_B, LONG_T + 1))
                           .astype(np.int64))
    args = ([ids[:, :-1]], [ids[:, 1:]])
    L, d = len(net.gpt.layers), net.gpt.hidden_size
    n_params = sum(int(np.prod(p.shape)) for p in net.parameters())
    n_tensors = len(list(net.parameters()))
    tokens = LONG_B * LONG_T
    flops = 6 * n_params * tokens + 12 * L * d * LONG_T * tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    losses, times, _ = timed_steps(torch, step, lambda: args, LONG_WARMUP,
                                   LONG_STEPS)
    launches = ck.launch_counts()
    paths = ck.attention_path_counts()
    peak = torch.cuda.max_memory_allocated()
    last, _ = step(*args)
    losses.append(float(last.numpy()))      # the bench's read
    n_steps = LONG_WARMUP + LONG_STEPS + 1
    progs = step.programs
    (key,) = progs.builds
    replayed = {k: progs.replays[key] * n for k, n in
                progs.launches[key].items()}
    require(all(math.isfinite(x) for x in losses),
            "long (b): non-finite loss %s" % losses)
    require(step.compiles == 1 and step.replays == n_steps - 1,
            "long (b): %d programs, %d replays in %d steps"
            % (step.compiles, step.replays, n_steps))
    per_step = {k: launches[k] / (n_steps - 1) for k in launches}
    want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "adamw": adamw_launches(net.parameters()),
            "dropout_keep": 2 * L + 1}
    say("long (b) launches %s, attention paths %s" % (launches, paths))
    require(all(per_step[k] == v for k, v in want.items()),
            "long (b): launches a step %s, want %s" % (per_step, want))
    require(all(replayed[k] > 0 for k in want),
            "long (b): kernels launched in no replay: %s" % replayed)
    # the body runs twice on the card (the build's eager run and its
    # capture), every step on the CPU
    bodies = 2 if next(net.parameters()).is_cuda else n_steps - 1
    require(paths["flash_dropout"] == bodies * L and paths["xla_sdpa"] == 0
            and paths["xla_chunked"] == 0 and paths["flash"] == 0,
            "long (b): attention paths %s" % paths)
    dev_ms, top = profile_step(torch, step, lambda: args)
    say("long (b) bench_gpt2_long on the port: gpt2-small "
        "max_position_embeddings=%d, %d parameters (%d tensors), B=%d T=%d, "
        "dropouts 0.1, O2 bf16, AdamW; %d steps, losses %s; program %s "
        "captured in %.1f ms, graph pool %.1f MiB, launches a step %s; %s "
        "%d a step (%s)"
        % (LONG_T + 1, n_params, n_tensors, LONG_B, LONG_T, n_steps,
           ["%.4f" % x for x in losses], key, progs.capture_s[key] * 1e3,
           progs.pool_bytes() / 2 ** 20,
           {k: n for k, n in progs.launches[key].items() if n},
           "flash_dropout attention path", L, card))
    step_ms = step_line("long (b) captured step", times, tokens, flops,
                        peak, dev_ms, card)
    report_profile("long (b) captured", dev_ms, step_ms, top)
    del net, opt, step
    free_memory(torch)
    return {"launches": {k: launches[k] for k in want}, "step_ms": step_ms,
            "peak": peak, "args": args}


def long_chunked(torch, ck, flags, paddle, gpt2_small, args, card):
    """Phase 21 (c): the same model at dropout 0, LONG_CHUNKED_STEPS steps from one seed's weights and the same batch,
    once with the flash kernels and once with use_flash_attention off,
    where the threshold (2048, unchanged) sends every layer's attention to
    the blockwise tier: path xla_chunked, no flash launch, losses within
    LONG_LOSS_REL_TOL of the flash run's; step ms and peak memory of
    each."""
    require(paddle.get_flags([CHUNK_FLAG])[CHUNK_FLAG] == 2048,
            "long (c): %s is %s, not the reference's 2048"
            % (CHUNK_FLAG, paddle.get_flags([CHUNK_FLAG])))
    saved = flags.get_flags(["use_flash_attention"])
    runs = {}
    try:
        for name, flash in (("flash", True), ("blockwise", False)):
            flags.set_flags({"use_flash_attention": flash})
            paddle.seed(0)
            net, opt, step = long_model(paddle, gpt2_small,
                                        attn_dropout_prob=0.0,
                                        hidden_dropout_prob=0.0)
            L = len(net.gpt.layers)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ck.launch_counts(reset=True)
            ck.attention_path_counts(reset=True)
            losses, times, _ = timed_steps(torch, step, lambda: args, 1,
                                           LONG_CHUNKED_STEPS - 1)
            bodies = (2 if next(net.parameters()).is_cuda
                      else LONG_CHUNKED_STEPS)
            runs[name] = dict(losses=losses, ms=statistics.median(times),
                              peak=torch.cuda.max_memory_allocated(),
                              paths=ck.attention_path_counts(),
                              launches=ck.launch_counts(), L=L,
                              calls=L * bodies)
            del net, opt, step
            free_memory(torch)
    finally:
        flags.set_flags(saved)
    f, b = runs["flash"], runs["blockwise"]
    require(f["paths"]["flash"] == f["calls"]
            and f["paths"]["xla_chunked"] == 0,
            "long (c) flash run: attention paths %s" % f["paths"])
    require(b["paths"]["xla_chunked"] == b["calls"]
            and b["paths"]["flash"] == b["paths"]["flash_dropout"] == 0
            and b["paths"]["xla_sdpa"] == 0,
            "long (c) blockwise run: attention paths %s" % b["paths"])
    require(all(b["launches"][k] == 0 for k in
                ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")),
            "long (c): a flash kernel launched with its flag off: %s"
            % b["launches"])
    rel = [abs(x - y) / abs(y) for x, y in zip(b["losses"], f["losses"])]
    require(all(math.isfinite(x) for x in b["losses"] + f["losses"])
            and max(rel) <= LONG_LOSS_REL_TOL,
            "long (c): blockwise losses %s against flash %s (rel %s > %g)"
            % (b["losses"], f["losses"], rel, LONG_LOSS_REL_TOL))
    say("long (c) blockwise tier (use_flash_attention off, %s %d): %d "
        "layers at dropout 0, %d steps from seed 0's weights: attention "
        "paths %s; losses %s against the flash kernels' %s (max rel %.3g, "
        "tol %g); step %.2f ms against the flash kernels' %.2f ms (medians "
        "of %d after the build); peak memory %.1f MiB against %.1f MiB (%s)"
        % (CHUNK_FLAG, 2048, b["L"], LONG_CHUNKED_STEPS,
           {k: n for k, n in b["paths"].items() if n},
           ["%.5f" % x for x in b["losses"]],
           ["%.5f" % x for x in f["losses"]], max(rel), LONG_LOSS_REL_TOL,
           b["ms"], f["ms"], LONG_CHUNKED_STEPS - 1, b["peak"] / 2 ** 20,
           f["peak"] / 2 ** 20, card))
    return runs


def long_main(torch, ck, F, flags, card):
    """Phase 21: GPT-2 long context (see the module's docstring), (a)-(c).
    Returns (b)'s launches and (a)'s times by kernel."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework.random import philox_word
    from paddle_tpu_torch.models import gpt2_small
    global WORD
    if WORD is None:
        WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    errs, times = long_kernels(torch, ck, F, Timer(torch), gen)
    t1 = time.perf_counter()
    bench = long_bench(torch, ck, paddle, gpt2_small, card)
    t2 = time.perf_counter()
    chunked = long_chunked(torch, ck, flags, paddle, gpt2_small,
                           bench.pop("args"), card)
    say("long phase 21: %.1f s ((a) %.1f, (b) %.1f, (c) %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1,
           time.perf_counter() - t2))
    return {"launches": bench["launches"], "times": times, "errs": errs,
            "bench": bench, "chunked": chunked}


# ---------------------------------------------------------------------------
# 22. the static graph and the predictor

# (a): row 1 at the BERT predictor's attention (inference_bench.py:114
# bench_bert: bert-base, B=8, T=128; 12 heads of 64), float32, not causal
STATIC_BERT_B, STATIC_BERT_T, STATIC_BERT_H, STATIC_BERT_D = 8, 128, 12, 64
# (b): bench_resnet50's static run (train_bench.py:317-388, its TPU
# branch); the graph-against-eager check's steps
STATIC_STEPS_EAGER = 3
# (c): inference_bench.py's predictor runs (its TPU branch)
INFER_RESNET_BATCHES, INFER_HW = (8, 64), 224
INFER_STEPS, INFER_WARMUP = 20, 3
# (c): a predictor's output against the same model's dygraph eval forward
# on the card (float32, TF32 off), max abs error over the largest |value|
# (at least 1). ResNet-50's predictor runs the batch norms folded into the
# convolutions' weights (conv_bn_fuse_pass: the weights rounded once more,
# float32 sums in another order); BERT's runs the same kernels as the
# forward, and against the forward with use_flash_attention off the plain
# attention's float32 sums in another order
INFER_REL_TOL = REL_TOL["float32"]
# (d): the bfloat16 predictor (every weight and activation bfloat16)
# against (c)'s float32 one: bfloat16 rounds at 2^-9 relative in each of
# BERT-base's 12 layers; held to 5e-2 of the largest |logit| (the CPU's
# plain versions at bert-base, B=2, T=32, read 1.9e-2)
INFER_BF16_REL_TOL = 5e-2


def static_flash(torch, ck, F, timer, gen):
    """Phase 22 (a): `flash_attention` at the BERT predictor's shape, not
    causal, in both instances the predictors launch: float32 (row 1, (c))
    and bfloat16 (row 1t's tensor-core body without lse, (d)), each
    against its plain version on the same inputs at phase 3's tolerance
    for its dtype, then its device time beside its bound, its plain
    version's and torch sdpa's forward. Returns {dtype name: entry}."""
    B, T, H, D = STATIC_BERT_B, STATIC_BERT_T, STATIC_BERT_H, STATIC_BERT_D
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        q, k, v = qkv_views(torch, B, T, H, D, dtype, gen)
        got = ck.flash_attention(q, k, v, False)
        want = ck.flash_attention_plain(q, k, v, False)
        err = (got.float() - want.float()).abs().max().item()
        require(got.shape == want.shape and got.dtype == dtype,
                "static (a): flash_fwd %s output type or shape" % name)
        require(err <= TOL[name], "static (a) flash_fwd B=%d H=%d T=%d D=%d "
                "%s not causal: max abs err %.3g > %.3g"
                % (B, H, T, D, name, err, TOL[name]))
        nbytes = 4 * B * H * T * D * q.element_size()
        flops = 4 * B * H * T * T * D
        bound, by = bound_ms(nbytes, flops, name)
        t = {"ms": timer.ms(lambda: ck.flash_attention(q, k, v, False)),
             "plain_ms": timer.ms(lambda: ck.flash_attention_plain(
                 q, k, v, False)),
             "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                 q, k, v)),
             "bound_ms": bound, "bound_by": by, "max_abs_err": err,
             "B": B, "H": H, "T": T, "D": D, "causal": False,
             "dtype": name}
        say("static (a) check flash_fwd B=%d H=%d T=%d D=%d %s not causal: "
            "max abs err %.3g (tol %.0e); time %.4f ms, plain %.4f ms, sdpa "
            "%.4f ms, bound %.4f ms (%s: %.1f MB, %.3f GFLOP)"
            % (B, H, T, D, name, err, TOL[name], t["ms"], t["plain_ms"],
               t["library_ms"], bound, by, nbytes / 1e6, flops / 1e9))
        out[name] = t
    return out


def static_resnet_build(paddle, static, B):
    """bench_resnet50's static program (train_bench.py:343-358 on its TPU
    branch), written against `paddle` the port: (net, loss, opt)."""
    from paddle_tpu_torch.vision.models import resnet50
    static.reset_default_programs()
    paddle.seed(0)
    img = static.data("image", [-1, 3, RESNET_HW, RESNET_HW], "float32")
    label = static.data("label", [-1, 1], "int64")
    net = resnet50(num_classes=RESNET_CLASSES)
    logits = net(img)
    loss = paddle.nn.functional.cross_entropy(logits, label)
    opt = paddle.optimizer.Momentum(learning_rate=RESNET_LR,
                                    momentum=RESNET_MOMENTUM)
    opt.minimize(loss)
    static.apply_pass(static.default_main_program(), "amp_bf16_pass")
    return net, loss, opt


def static_feed(B, seed=0):
    rs = np.random.RandomState(seed)
    return {"image": rs.rand(B, 3, RESNET_HW, RESNET_HW).astype(np.float32),
            "label": rs.randint(0, RESNET_CLASSES, (B, 1)).astype(np.int64)}


def static_parity(torch, paddle, static, card):
    """Phase 22 (b), first: the bench's program at B=64, its first
    STATIC_STEPS_EAGER steps from one saved state through the captured
    program and twice through the same program interpreted eagerly (the
    train step's bodies, `eager_train_step`): losses, parameters,
    velocities and running statistics bit-equal; cuDNN's deterministic
    algorithms for this check (phase 19 (a))."""
    from paddle_tpu_torch.static.executor import _StaticTrainStep
    torch.backends.cudnn.deterministic = True
    try:
        net, loss, opt = static_resnet_build(paddle, static, RESNET_B)
        exe = static.Executor()
        exe.run(static.default_startup_program())
        feeds = [static_feed(RESNET_B, s) for s in range(STATIC_STEPS_EAGER)]
        exe.run(feed=feeds[0], fetch_list=[loss])   # the build
        (cp,) = exe._cache.values()
        step = cp.step
        eager = eager_train_step(_StaticTrainStep)(
            step.network, step.loss_fn, opt)
        tensors = lambda: (list(net.parameters()) + [  # noqa: E731
            opt._get_accumulators(p)["velocity"] for p in net.parameters()]
            + list(net.buffers()))
        torch.cuda.synchronize()
        saved = [t.detach().clone() for t in tensors()], opt._step_count

        def run(fn):
            with torch.no_grad():
                for t, s in zip(tensors(), saved[0]):
                    t.copy_(s)
            opt._step_count = saved[1]
            losses = [fn.run([torch.from_numpy(f[n])
                              for n in cp.feed_names], ())[0]
                      for f in feeds]
            torch.cuda.synchronize()
            return losses, [t.detach().clone() for t in tensors()]
        e1, e2 = run(eager), run(eager)
        replays = step.replays
        g = run(step)
        require(step.replays == replays + len(feeds) and step.compiles == 1,
                "static (b): the captured program did not replay")
        same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                                for x, y in zip(a[0] + a[1], b[0] + b[1]))
        require(same(e1, e2), "static (b): two eager runs of the program "
                "from one state differ")
        require(same(g, e1), "static (b): the captured program's losses, "
                "parameters, velocities or running statistics differ from "
                "the program interpreted eagerly")
        say("static (b) graph against eager: resnet50 static program B=%d, "
            "amp_bf16_pass, %d steps from one state (cudnn.deterministic "
            "on for this check): losses %s; %d parameters, their "
            "velocities and %d running statistics bit-equal to the program "
            "interpreted eagerly, which repeats itself bit for bit (%s)"
            % (RESNET_B, len(feeds), ["%.6f" % float(x) for x in g[0]],
               len(list(net.parameters())), len(list(net.buffers())), card))
    finally:
        torch.backends.cudnn.deterministic = False
        static.reset_default_programs()


def static_train(torch, ck, paddle, static, card):
    """Phase 22 (b): bench_resnet50's static run as written (3 warm-up
    runs fetching numpy, 20 timed with return_numpy=False, one
    float(lv.numpy())), then one profiled run."""
    net, loss, opt = static_resnet_build(paddle, static, RESNET_B)
    prog = static.default_main_program()
    kinds = {}
    for op in prog.ops:
        kinds[op.op_type] = kinds.get(op.op_type, 0) + 1
    exe = static.Executor()
    exe.run(static.default_startup_program())
    feed = static_feed(RESNET_B)
    mean0 = net.bn1._mean.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launch_counts(reset=True)
    t0 = time.perf_counter()
    warm = [float(exe.run(feed=feed, fetch_list=[loss])[0])
            for _ in range(RESNET_WARMUP)]
    build_s = time.perf_counter() - t0
    times, outs = [], []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        t1 = time.perf_counter()
        (lv,) = exe.run(feed=feed, fetch_list=[loss], return_numpy=False)
        outs.append(lv)
        times.append((time.perf_counter() - t1) * 1e3)
    last = float(lv.numpy())
    wall = (time.perf_counter() - t0) / RESNET_STEPS * 1e3
    launches = ck.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    (cp,) = exe._cache.values()
    step = cp.step
    n_runs = RESNET_WARMUP + RESNET_STEPS
    require(len(exe._cache) == 1 and step.compiles == 1
            and step.replays == n_runs - 1,
            "static (b): %d programs, %d builds, %d replays in %d runs"
            % (len(exe._cache), step.compiles, step.replays, n_runs))
    losses = warm + [float(x.numpy()) for x in outs]
    require(all(math.isfinite(x) for x in losses) and losses[-1] == last,
            "static (b): non-finite loss %s" % losses)
    moved = (net.bn1._mean - mean0).abs().max().item()
    require(moved > 0, "static (b): the running statistics did not move")
    require(sum(launches.values()) == 0,
            "static (b): the port's kernels launched on a path that "
            "reaches none: %s" % {k: n for k, n in launches.items() if n})
    dev_ms, top = profile_step(
        torch, lambda: exe.run(feed=feed, fetch_list=[loss],
                               return_numpy=False), lambda: ())
    step_ms = statistics.median(times)
    mfu = (RESNET_FLOPS_PER_IMAGE * RESNET_B / (wall / 1e3)
           / PEAK_FLOPS["bfloat16"])
    (key,) = step.programs.builds
    say("static (b) program: %d ops %s, %d buffer updates; 1 build (%.2f s "
        "for the %d warm-up runs) + %d replays, captured in %.1f ms, graph "
        "pool %.1f MiB; bn1 running mean moved by up to %.4g; launches of "
        "the port's kernels 0 (none on this path)"
        % (len(prog.ops), kinds, len(prog.buffer_updates), build_s,
           RESNET_WARMUP, step.replays, step.programs.capture_s[key] * 1e3,
           step.programs.pool_bytes() / 2 ** 20, moved))
    idle = ("device idle %.1f %% (%.3f ms of kernels in one profiled run)"
            % (100.0 * (1.0 - dev_ms / step_ms), dev_ms) if dev_ms > 0
            else "device idle not measured (the profiler saw no device "
            "activity)")
    say("static (b) bench_resnet50 static, B=%d %dx%d, Momentum(%g, %g), "
        "amp_bf16_pass: %.2f ms a step by the bench's clock (20 runs, one "
        "sync), %.2f ms median a run (host, no sync), %.1f images/s, MFU "
        "%.4f of 989 TFLOP/s bf16 (train_bench.py:379-381), peak memory "
        "%.1f MiB, losses %s ... %s, %s (%s)"
        % (RESNET_B, RESNET_HW, RESNET_HW, RESNET_LR, RESNET_MOMENTUM, wall,
           step_ms, RESNET_B / (wall / 1e3), mfu, peak / 2 ** 20,
           ["%.4f" % x for x in losses[:3]], "%.4f" % losses[-1], idle,
           card))
    report_profile("static (b)", dev_ms, wall, top, RESNET_PROFILE_GROUPS)
    static.reset_default_programs()


def serve_loop(pred, feed_name, out_name, make_batch, steps, warmup):
    """inference_bench.py:37 `_serve_loop` as written: seconds a run, each
    run's output copied to the host."""
    inh = pred.get_input_handle(feed_name)
    oh = pred.get_output_handle(out_name)
    for _ in range(warmup):
        inh.copy_from_cpu(make_batch())
        pred.run()
        oh.copy_to_cpu()
    t0 = time.perf_counter()
    for _ in range(steps):
        inh.copy_from_cpu(make_batch())
        pred.run()
        oh.copy_to_cpu()
    return (time.perf_counter() - t0) / steps


def export(paddle, static, build_fn, feed_specs, tag, root):
    """inference_bench.py:56 `_export` against the port: the model built
    under the static graph, saved through save_inference_model (the fusion
    passes run). Returns (path, feed names)."""
    paddle.enable_static()
    static.reset_default_programs()
    try:
        paddle.seed(0)
        feeds = [static.data(n, shape, dtype)
                 for n, shape, dtype in feed_specs]
        out = build_fn(*feeds)
        exe = static.Executor()
        exe.run(static.default_startup_program())
        path = os.path.join(root, tag)
        static.save_inference_model(path, feeds, [out], exe)
    finally:
        paddle.disable_static()
        static.reset_default_programs()
    return path, [n for n, _, _ in feed_specs]


def infer_resnet(torch, ck, paddle, static, root, card):
    """Phase 22 (c): inference_bench.py:82 bench_resnet50 as written (on
    its TPU branch) against the port, each batch's output held to the
    same model's dygraph eval forward."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.vision.models import resnet50
    nets = []

    def build(img):
        net = resnet50(num_classes=100)
        net.eval()
        nets.append(net)
        return net(img)
    path, feeds = export(paddle, static, build,
                         [("image", [-1, 3, INFER_HW, INFER_HW],
                           "float32")],
                         "resnet50", root)
    pred = create_predictor(Config(path + ".pdmodel", path + ".pdiparams"))
    out_name = pred.get_output_names()[0]
    kinds = {}
    for op in pred._program.ops:
        kinds[op.op_type] = kinds.get(op.op_type, 0) + 1
    for B in INFER_RESNET_BATCHES:
        rs = np.random.RandomState(0)
        x = rs.rand(B, 3, INFER_HW, INFER_HW).astype(np.float32)
        dt = serve_loop(pred, feeds[0], out_name, lambda: x, INFER_STEPS,
                        INFER_WARMUP)
        got = pred.get_output_handle(out_name).copy_to_cpu()
        with torch.no_grad():
            want = nets[0](torch.from_numpy(x).cuda()).cpu().numpy()
        err = rel_err(got, want, 1.0)
        require(err <= INFER_REL_TOL, "static (c) resnet50 predictor B=%d: "
                "rel err %.3g against the dygraph eval forward > %.0e"
                % (B, err, INFER_REL_TOL))
        dev_ms, top = profile_step(torch, pred.run, lambda: ())
        say("static (c) resnet50_infer B=%d %dx%d: latency %.3f ms, %.1f "
            "images/s (inference_bench.py's loop: copy in, run, copy out; "
            "%d runs after %d); output against the dygraph eval forward: "
            "rel err %.3g (tol %.0e) (%s)"
            % (B, INFER_HW, INFER_HW, dt * 1e3, B / dt, INFER_STEPS,
               INFER_WARMUP, err, INFER_REL_TOL, card))
        report_profile("static (c) resnet50_infer B=%d run" % B, dev_ms,
                       dt * 1e3, top, RESNET_PROFILE_GROUPS)
    progs = pred.programs
    # each batch's runs and its profiled run: one build, then replays
    require(len(progs.builds) == len(INFER_RESNET_BATCHES) and all(
        n == INFER_STEPS + INFER_WARMUP for n in progs.replays.values()),
        "static (c) resnet50: programs %s, replays %s"
        % (progs.builds, progs.replays))
    say("static (c) resnet50 predictor program: %d ops %s (every batch norm "
        "folded); one program a batch size, each built once and replayed "
        "%d times, graph pool %.1f MiB"
        % (len(pred._program.ops), kinds, INFER_STEPS + INFER_WARMUP,
           progs.pool_bytes() / 2 ** 20))


def infer_bert(torch, ck, flags, paddle, static, root, card):
    """Phase 22 (c) and (d): inference_bench.py:114 bench_bert as written
    (bert-base, B=8, T=128), its flash launches and attention paths, its
    output against the dygraph eval forward with the flash flag on and
    off; then the same artifact through Config.enable_mkldnn_bfloat16()."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import bert_base
    B, T = STATIC_BERT_B, STATIC_BERT_T
    net = bert_base()
    net.eval()
    core = getattr(net, "bert", net)
    vocab = core.embeddings.word_embeddings.weight.shape[0]

    def build(ids):
        out = net(ids)
        return out[0] if isinstance(out, (list, tuple)) else out
    path, feeds = export(paddle, static, build, [("ids", [B, T], "int64")],
                         "bert", root)
    cfg = Config(path + ".pdmodel", path + ".pdiparams")
    pred = create_predictor(cfg)
    out_name = pred.get_output_names()[0]
    rs = np.random.RandomState(0)
    x = rs.randint(0, vocab, (B, T)).astype(np.int64)
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    dt = serve_loop(pred, feeds[0], out_name, lambda: x, INFER_STEPS,
                    INFER_WARMUP)
    launches = ck.launch_counts()
    paths = ck.attention_path_counts()
    got = pred.get_output_handle(out_name).copy_to_cpu()
    progs = pred.programs
    (key,) = progs.builds
    n_runs = INFER_STEPS + INFER_WARMUP
    layers = len(core.layers)
    require(progs.replays[key] == n_runs - 1,
            "static (c) bert: %d replays in %d runs" % (progs.replays[key],
                                                       n_runs))
    require(progs.launches[key].get("flash_fwd") == layers
            and launches["flash_fwd"] == layers * n_runs
            and sum(launches.values()) == launches["flash_fwd"],
            "static (c) bert: launches %s in %d runs (want flash_fwd %d a "
            "run)" % ({k: n for k, n in launches.items() if n}, n_runs,
                      layers))
    # the attention gates count bodies that ran in Python: on the card the
    # build's eager run and its capture, on the CPU every run
    bodies = 2 if progs._cuda else n_runs
    require(paths["flash"] == bodies * layers
            and sum(paths.values()) == bodies * layers,
            "static (c) bert: attention paths %s (want flash only, %d a "
            "body)" % (paths, layers))
    ids = torch.from_numpy(x).cuda()
    with torch.no_grad():
        want = net(ids)[0].cpu().numpy()
        saved = flags.get_flags(["use_flash_attention"])
        flags.set_flags({"use_flash_attention": False})
        try:
            plain = net(ids)[0].cpu().numpy()
        finally:
            flags.set_flags(saved)
    err, err_plain = rel_err(got, want, 1.0), rel_err(got, plain, 1.0)
    require(err <= INFER_REL_TOL and err_plain <= INFER_REL_TOL,
            "static (c) bert predictor: rel err %.3g against the dygraph "
            "eval forward, %.3g against it with use_flash_attention off "
            "(tol %.0e)" % (err, err_plain, INFER_REL_TOL))
    dev_ms, top = profile_step(torch, pred.run, lambda: ())
    say("static (c) bert_infer bert-base B=%d T=%d: latency %.3f ms, %.0f "
        "tokens/s (copy in, run, copy out of the [%d, %d, %d] float32 "
        "logits; %d runs after %d); flash_fwd %d launches in %d runs (%d a "
        "run, through replays), attention paths %s; output against the "
        "dygraph eval forward rel err %.3g, against it with "
        "use_flash_attention off %.3g (tol %.0e); graph pool %.1f MiB (%s)"
        % (B, T, dt * 1e3, B * T / dt, B, T, vocab, INFER_STEPS,
           INFER_WARMUP, launches["flash_fwd"], n_runs, layers,
           {k: n for k, n in paths.items() if n}, err, err_plain,
           INFER_REL_TOL, progs.pool_bytes() / 2 ** 20, card))
    report_profile("static (c) bert_infer run", dev_ms, dt * 1e3, top)
    # (d) bfloat16
    cfg16 = Config(path + ".pdmodel", path + ".pdiparams")
    cfg16.enable_mkldnn_bfloat16()
    pred16 = create_predictor(cfg16)
    ck.launch_counts(reset=True)
    dt16 = serve_loop(pred16, feeds[0], out_name, lambda: x, INFER_STEPS,
                      INFER_WARMUP)
    launches16 = ck.launch_counts()
    got16 = pred16.get_output_handle(out_name).copy_to_cpu()
    err16 = rel_err(got16, got, 1.0)
    dev16, top16 = profile_step(torch, pred16.run, lambda: ())
    replays16 = pred16.programs.replays
    require(launches16["flash_fwd"] == layers * n_runs and got16.dtype ==
            np.float32 and list(replays16.values()) == [n_runs],
            "static (d) bert bf16: launches %s, output %s, replays %s"
            % ({k: n for k, n in launches16.items() if n}, got16.dtype,
               replays16))
    require(err16 <= INFER_BF16_REL_TOL, "static (d) bert bf16 predictor: "
            "rel err %.3g against the float32 one > %.0e"
            % (err16, INFER_BF16_REL_TOL))
    say("static (d) bert_infer bf16 (Config.enable_mkldnn_bfloat16): "
        "latency %.3f ms, %.0f tokens/s; flash_fwd (bf16 instance) %d "
        "launches in %d runs; output against (c)'s float32 rel err %.3g "
        "(tol %.0e); graph pool %.1f MiB (%s)"
        % (dt16 * 1e3, B * T / dt16, launches16["flash_fwd"], n_runs,
           err16, INFER_BF16_REL_TOL,
           pred16.programs.pool_bytes() / 2 ** 20, card))
    report_profile("static (d) bert_infer bf16 run", dev16, dt16 * 1e3,
                   top16)
    return launches["flash_fwd"], launches16["flash_fwd"]


def static_main(torch, ck, F, flags, card):
    """Phase 22: the static graph and the predictor (see the module's
    docstring), (a)-(d). Returns the flash forward's float32 and bfloat16
    entries at BERT's shape, with the launches of (c) and (d) each."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(22)
    flash = static_flash(torch, ck, F, Timer(torch), gen)
    t1 = time.perf_counter()
    paddle.enable_static()
    try:
        static_parity(torch, paddle, static, card)
        free_memory(torch)
        static_train(torch, ck, paddle, static, card)
    finally:
        paddle.disable_static()
    free_memory(torch)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        infer_resnet(torch, ck, paddle, static, root, card)
        free_memory(torch)
        (flash["float32"]["launches"],
         flash["bfloat16"]["launches"]) = infer_bert(
             torch, ck, flags, paddle, static, root, card)
    free_memory(torch)
    say("static phase 22: %.1f s ((a) %.1f, (b) %.1f, (c)-(d) %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1,
           time.perf_counter() - t2))
    return flash


# ---------------------------------------------------------------------------
# 23. the encoder-decoder Transformer: Transformer-base training, cached
# greedy decoding, the fused block functions

# Transformer-base (Vaswani et al. 2017, Table 3: nn.Transformer's
# defaults) over the paper's shared source-target BPE vocabulary (§5.1)
NMT_VOCAB, NMT_D, NMT_HEADS, NMT_LAYERS, NMT_FFN = 37000, 512, 8, 6, 2048
NMT_DROPOUT, NMT_SMOOTH = 0.1, 0.1             # §5.4: P_drop and eps_ls
NMT_WARMUP_STEPS = 4000                        # §5.3: the learning rate
NMT_PAD, NMT_BOS = 0, 1                        # ids; the data draw from 2
# (b): 32 sentence pairs of 256 source and 200 target tokens, no padding;
# NMT_BATCHES synthetic batches taken in turn
NMT_B, NMT_S, NMT_T = 32, 256, 200
NMT_BATCHES = 4
NMT_WARMUP, NMT_STEPS = 3, 20
# (b): the float32 kernels-against-plain run's steps and its constant lr
# (Noam's first steps, ~1.7e-7, would move the weights less than the
# comparison's tolerance)
NMT_COMPARE_STEPS = 2
# ... where an element's first-step gradient in the plain run is at most
# this share of its parameter's gradient RMS, Adam's step (the sign of g)
# is not set by the arithmetic: the random decoder's FFN has units that
# few tokens reach, whose columns' gradients are a few tokens' terms, and
# one token's ReLU rounding to the other side of 0 turns their sign (the
# elements more than TRAIN_PARAM_TOL apart read |g| <= 0.043 of the RMS)
NMT_NEAR_ZERO = 0.1
# (c): greedy steps; (a): the self-attention cache lengths checked
NMT_DECODE = 64
NMT_SELF_T = (1, 32, 64)
# (c): the cached and the uncached decode may first differ only where the
# uncached run's top-2 logits are at most this far apart (a near tie).
# Both decodes take the output projection in float32 (decode_step), so
# the rule reads no bfloat16 rounding of the logits themselves
NMT_TIE = 1e-2
# (d): the fused functions' stack against nn.TransformerEncoder in
# bfloat16 at p = 0, max abs error over the largest |value|: both round
# every op to bfloat16 (one ulp is 2^-8 of a value), the fused stack's
# q/k/v product one matmul where the layers make three
NMT_FUSED_REL_TOL = 2e-2


def position_table(n, d):
    """The sinusoidal position encoding [n, d] float32 (§3.5): sin at the
    even channels, cos at the odd, of pos / 10000^(2i / d)."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    angle = pos / np.power(10000.0, np.arange(0, d, 2) / d)[None, :]
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def seq2seq_model(vocab=NMT_VOCAB, d_model=NMT_D, nhead=NMT_HEADS,
                  layers=NMT_LAYERS, ffn=NMT_FFN, dropout=NMT_DROPOUT,
                  max_len=NMT_S, normalize_before=False, seed=0,
                  device="cuda"):
    """The Transformer-base translation model around nn.Transformer (the
    JAX package has no such class; tests/test_torch_transformer.py builds
    the same one on it): a source/target Embedding shared by both sides
    (padding_idx NMT_PAD, N(0, d_model^-0.5) through a ParamAttr) scaled
    by sqrt(d_model) plus the sinusoidal table (a buffer, `pos_table`),
    dropout, nn.Transformer with the causal mask on the target, and the
    output projection tied to the embedding (matmul with its transpose).
    Weights drawn on the CPU from a generator seeded with `seed`, then
    moved to `device`."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as PF

    class Seq2Seq(torch.nn.Module):
        def __init__(self, generator):
            super().__init__()
            self.d_model = d_model
            self.embedding = nn.Embedding(
                vocab, d_model, padding_idx=NMT_PAD,
                weight_attr=nn.ParamAttr(initializer=nn.initializer.Normal(
                    0.0, d_model ** -0.5)), generator=generator)
            self.register_buffer("pos_table", torch.from_numpy(
                position_table(max_len, d_model)))
            self.dropout = nn.Dropout(dropout)
            self.transformer = nn.Transformer(
                d_model, nhead, layers, layers, ffn, dropout,
                normalize_before=normalize_before, generator=generator)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * (self.d_model ** 0.5)
            return self.dropout(
                x + self.pos_table[start:start + ids.shape[1]])

        def logits(self, h, dtype=None):
            """The tied output projection; with `dtype`, h and the
            embedding are cast to it first."""
            w = self.embedding.weight
            if dtype is not None:
                h, w = h.to(dtype), w.to(dtype)
            return PF.matmul(h, w, transpose_y=True)

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            return self.logits(self.transformer(
                self.embed(src), self.embed(tgt), tgt_mask=mask))

        def decode_step(self, tok, memory, cache, t):
            """float32 logits [B, 1, vocab] of the token at position t, and
            the grown caches (decoder.gen_cache's)."""
            h, cache = self.transformer.decoder(self.embed(tok, t), memory,
                                                cache=cache)
            return self.logits(h, torch.float32), cache

    gen = torch.Generator().manual_seed(int(seed))
    return Seq2Seq(gen).to(device)


def seq2seq_loss(F, logits, label, vocab=NMT_VOCAB, epsilon=NMT_SMOOTH):
    """Label-smoothed cross entropy (§5.4) in either package's functional
    namespace `F`: one-hot labels smoothed by epsilon, soft-label cross
    entropy, the mean over the positions."""
    soft = F.label_smooth(F.one_hot(label, vocab), epsilon=epsilon)
    return F.cross_entropy(logits, soft, soft_label=True)


def nmt_batch(B, S, T, vocab, seed):
    """Synthetic sentence pairs from RandomState(seed): (source [B, S],
    target input [B, T], label [B, T]) int64, ids in [2, vocab) (no
    padding), the target input starting with NMT_BOS."""
    rs = np.random.RandomState(seed)
    src = rs.randint(2, vocab, (B, S)).astype(np.int64)
    tgt = rs.randint(2, vocab, (B, T + 1)).astype(np.int64)
    tgt[:, 0] = NMT_BOS
    return src, tgt[:, :-1], tgt[:, 1:]


def fused_encoder(fused, pack_qkv, encoder, x, pre_layer_norm,
                  training=True):
    """`encoder` (an nn.TransformerEncoder) rebuilt from the fused block
    functions `fused.fused_multi_head_attention` and
    `fused.fused_feedforward` with its own weights, q/k/v packed by
    `pack_qkv`, dropout 0: post-LN each block's LayerNorm the tail's,
    pre-LN the block's first op."""
    for layer in encoder.layers:
        a = layer.self_attn
        projs = (a.q_proj, a.k_proj, a.v_proj)
        qkv_w, qkv_b = pack_qkv([p.weight for p in projs],
                                [p.bias for p in projs], a.num_heads)
        n1, n2 = layer.norm1, layer.norm2
        x = fused.fused_multi_head_attention(
            x, qkv_w, a.out_proj.weight, pre_layer_norm=pre_layer_norm,
            pre_ln_scale=n1.weight, pre_ln_bias=n1.bias, ln_scale=n1.weight,
            ln_bias=n1.bias, qkv_bias=qkv_b, linear_bias=a.out_proj.bias,
            dropout_rate=0.0, attn_dropout_rate=0.0, training=training)
        x = fused.fused_feedforward(
            x, layer.linear1.weight, layer.linear2.weight,
            layer.linear1.bias, layer.linear2.bias, ln1_scale=n2.weight,
            ln1_bias=n2.bias, ln2_scale=n2.weight, ln2_bias=n2.bias,
            dropout1_rate=0.0, dropout2_rate=0.0, activation="relu",
            pre_layer_norm=pre_layer_norm, training=training)
    return x


def nmt_flops(B=NMT_B, S=NMT_S, T=NMT_T, d=NMT_D, ff=NMT_FFN, V=NMT_VOCAB,
              L=NMT_LAYERS):
    """A training step's FLOPs, from the shapes: 3x the forward's matrix
    products (the backward's two products for each), by part: the
    encoder's projections and FFNs, the decoder's (self-attention and
    cross-attention queries and outputs on the target's tokens, the
    cross-attention keys and values on the source's), the tied output
    projection, and attention's two products (the decoder's self-attention
    at its causal half)."""
    parts = {"encoder": L * 2 * B * S * (4 * d * d + 2 * d * ff),
             "decoder": L * 2 * (B * T * (6 * d * d + 2 * d * ff)
                                 + B * S * 2 * d * d),
             "output projection": 2 * B * T * d * V,
             "attention": L * 4 * B * d * (S * S + T * (T + 1) // 2
                                           + T * S)}
    return {k: 3 * v for k, v in parts.items()}


def nmt_flash_train(torch, ck, F, timer, gen, Tq, Tk, p):
    """(a) rows 1t, 2 and 3 at the model's attention: B=NMT_B, 8 heads of
    64, bfloat16, not causal, Tq queries against Tk keys (the encoder's
    Tq = Tk = 256, the cross-attention's 200 against 256); see
    flash_train_times."""
    return flash_train_times(torch, ck, F, timer, gen, NMT_B, NMT_HEADS,
                             NMT_D // NMT_HEADS, Tq, Tk, p, "nmt (a)")


def flash_train_times(torch, ck, F, timer, gen, B, H, D, Tq, Tk, p, label):
    """Rows 1t, 2 and 3 at B x H heads of D, bfloat16, not causal, Tq
    queries against Tk keys: each against its plain version fed the
    kernels' own dropout bits (REL_TOL bf16), then its device time beside
    its bound, its plain version's and torch sdpa's forward or backward
    (dq, dk and dv in one call)."""
    dt = torch.bfloat16
    tol = REL_TOL["bfloat16"]
    q, _, _ = qkv_views(torch, B, Tq, H, D, dt, gen)
    _, k, v = qkv_views(torch, B, Tk, H, D, dt, gen)
    do = torch.randn((B, H, Tq, D), generator=gen, device="cuda").to(dt)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, Tq, Tk) if p else None
    o, lse = ck.flash_fwd_train(q, k, v, False, p, WORD, DELTA)
    dq, dsum = ck.flash_bwd_dq(q, k, v, o, do, lse, False, p, WORD, DELTA)
    dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, dsum, False, p, WORD, DELTA)
    for t in (o, dq, dk, dv):
        require(t.dtype == dt and bool(torch.isfinite(t.float()).all()),
                "%s flash Tq=%d Tk=%d p=%g: non-finite or wrong type"
                % (label, Tq, Tk, p))
    runs = {
        "flash_fwd_train": (
            (o, lse), lambda: ck.flash_fwd_train(q, k, v, False, p, WORD,
                                                 DELTA),
            lambda: ck.flash_fwd_train_plain(q, k, v, False, p, bits)),
        "flash_bwd_dq": (
            (dq, dsum), lambda: ck.flash_bwd_dq(q, k, v, o, do, lse, False,
                                                p, WORD, DELTA),
            lambda: ck.flash_bwd_dq_plain(q, k, v, o, do, lse, False, p,
                                          bits)),
        "flash_bwd_dkv": (
            (dk, dv), lambda: ck.flash_bwd_dkv(q, k, v, do, lse, dsum, False,
                                               p, WORD, DELTA),
            lambda: ck.flash_bwd_dkv_plain(q, k, v, do, lse, dsum, False, p,
                                           bits))}
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, dropout_p=p)
    lib = {"fwd": timer.ms(lambda: F.scaled_dot_product_attention(
               q, k, v, dropout_p=p)),
           "bwd": timer.ms(lambda: torch.autograd.grad(
               lo, (lq, lk, lv), do, retain_graph=True))}
    bq, bk, bl = B * H * Tq * D * 2, B * H * Tk * D * 2, B * H * Tq * 4
    pairs = B * H * Tq * Tk
    # forward: reads q, k, v, writes o, lse, 2 products; dq: reads q, k,
    # v, o, dO, lse, writes dq, Delta, 3 products; dk/dv: reads q, k, v,
    # dO, lse, Delta, writes dk, dv, 4 products (2 D flops a pair each)
    work = {"flash_fwd_train": (2 * bq + 2 * bk + bl, 4 * D * pairs, "fwd"),
            "flash_bwd_dq": (4 * bq + 2 * bk + 2 * bl, 6 * D * pairs, "bwd"),
            "flash_bwd_dkv": (2 * bq + 4 * bk + 2 * bl, 8 * D * pairs,
                              "bwd")}
    out = {}
    case = "B=%d H=%d Tq=%d Tk=%d D=%d bf16 not causal p=%g" % (
        B, H, Tq, Tk, D, p)
    for name, (got, fn, plain) in runs.items():
        ea, er = (max(x) for x in zip(*(abs_rel_err(g, w) for g, w in
                                        zip(got, plain()))))
        require(er <= tol, "%s %s %s: rel err %.3g > %.3g"
                % (label, name, case, er, tol))
        nbytes, flops, which = work[name]
        b, by = bound_ms(nbytes, flops, "bfloat16")
        out[name] = {"ms": timer.ms(fn), "plain_ms": timer.ms(plain),
                     "library_ms": lib[which], "bound_ms": b,
                     "bound_by": by, "max_abs_err": ea, "B": B, "H": H,
                     "Tq": Tq, "Tk": Tk, "D": D, "p": p}
        say("%s %s %s: max rel err %.3g (tol %.0e), max abs err %.3g; "
            "time %.4f ms, plain %.4f ms, torch sdpa %s %.4f ms, bound %.4f "
            "ms (%s)" % (label, name, case, er, tol, ea, out[name]["ms"],
                         out[name]["plain_ms"], which, lib[which], b, by))
    return out


def nmt_flash_decode(torch, ck, F, timer, gen, Tk, cross):
    """(a) row 1b at cached decoding's attention: one bfloat16 query a
    head (B=NMT_B, 8 heads of 64, a [B, 1, H, 64] view, as the query
    projection gives it) against Tk keys, not causal, no lse: the
    self-attention's cache (contiguous, as torch.cat grows it) or the
    cross-attention's StaticCache (views of one projection); against its
    plain version (TOL bf16, absolute), then its device time beside its
    bound, its plain version's and torch sdpa's forward."""
    B, H, D, dt = NMT_B, NMT_HEADS, NMT_D // NMT_HEADS, torch.bfloat16
    q = torch.randn((B, 1, H, D), generator=gen,
                    device="cuda").to(dt).transpose(1, 2)
    if cross:
        _, k, v = qkv_views(torch, B, Tk, H, D, dt, gen)
    else:
        k, v = (torch.randn((B, H, Tk, D), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
    got = ck.flash_attention(q, k, v, False)
    want = ck.flash_attention_plain(q, k, v, False)
    err = (got.float() - want.float()).abs().max().item()
    what = "%s B=%d H=%d Tq=1 Tk=%d D=%d bf16" % (
        "cross" if cross else "self", B, H, Tk, D)
    require(got.shape == want.shape and got.dtype == dt
            and err <= TOL["bfloat16"], "nmt (a) flash_fwd %s: max abs err "
            "%.3g > %.3g" % (what, err, TOL["bfloat16"]))
    # reads q, k, v, writes o; 2 products of 2 D flops a pair
    b, by = bound_ms(2 * (2 * B * H * D + 2 * B * H * Tk * D),
                     4 * D * B * H * Tk, "bfloat16")
    t = {"ms": timer.ms(lambda: ck.flash_attention(q, k, v, False)),
         "plain_ms": timer.ms(lambda: ck.flash_attention_plain(q, k, v,
                                                               False)),
         "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
             q, k, v)),
         "bound_ms": b, "bound_by": by, "max_abs_err": err, "B": B, "H": H,
         "Tq": 1, "Tk": Tk, "D": D, "attention": "cross" if cross
         else "self"}
    say("nmt (a) flash_fwd %s: max abs err %.3g (tol %.0e); time %.4f ms, "
        "plain %.4f ms, torch sdpa %.4f ms, bound %.4f ms (%s)"
        % (what, err, TOL["bfloat16"], t["ms"], t["plain_ms"],
           t["library_ms"], b, by))
    return t


def nmt_fused_check(torch, ck, gen, N, Hd):
    """(a) rows 4, 5 and 6 at Hd = d_model, bfloat16, p = 0.1, no bias (the
    model's tails pass none), against their plain versions fed the
    kernels' own bits (FDRLN_BF16_REL_TOL). Returns {name: max abs err}."""
    dt = torch.bfloat16
    mk = lambda: torch.randn((N, Hd), generator=gen, device="cuda").to(dt)
    x, res, dy = mk(), mk(), mk()
    g = (1.0 + 0.1 * torch.randn(Hd, generator=gen, device="cuda")).to(dt)
    b = torch.randn(Hd, generator=gen, device="cuda").to(dt)
    p, s = DROPOUT, fdrln_scale(DROPOUT, "upscale_in_train")
    bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
    y, z = ck.fused_dropout_ln_fwd(x, res, None, g, b, p, s, 1e-5, WORD,
                                   DELTA)
    pairs = {
        "fused_dropout_ln_fwd": zip((y, z), ck.fused_dropout_ln_fwd_plain(
            x, res, None, g, b, p, s, 1e-5, bits=bits)),
        "fused_dropout_residual_fwd": [(
            ck.fused_dropout_residual_fwd(x, res, None, p, s, WORD, DELTA),
            ck.fused_dropout_residual_fwd_plain(x, res, None, p, s,
                                                bits=bits))],
        "fused_dropout_ln_bwd": zip(
            ck.fused_dropout_ln_bwd(z, dy, None, g, p, s, 1e-5, WORD, DELTA),
            ck.fused_dropout_ln_bwd_plain(z, dy, None, g, p, s, 1e-5,
                                          bits=bits))}
    out = {}
    for name, prs in pairs.items():
        prs = [(a, w) for a, w in prs if w is not None]
        torch.cuda.synchronize()
        for a, w in prs:
            require(a.dtype == w.dtype and a.shape == w.shape
                    and bool(torch.isfinite(a.float()).all()),
                    "nmt (a) %s N=%d Hd=%d: type, shape or non-finite"
                    % (name, N, Hd))
        ea, er = (max(v) for v in zip(*(abs_rel_err(a, w) for a, w in prs)))
        require(er <= FDRLN_BF16_REL_TOL, "nmt (a) %s N=%d Hd=%d bf16 "
                "p=%g: rel err %.3g > %.3g" % (name, N, Hd, p, er,
                                               FDRLN_BF16_REL_TOL))
        say("nmt (a) check %s N=%d Hd=%d bf16 p=%g: max rel err %.3g (tol "
            "%.0e), max abs err %.3g" % (name, N, Hd, p, er,
                                         FDRLN_BF16_REL_TOL, ea))
        out[name] = ea
    return out


def nmt_kernels(torch, ck, F, timer, gen):
    """Phase 23 (a): the kernels at this slice's new shapes (see the
    module's docstring). Returns {kernel: [entries]}."""
    out = {n: [] for n in ("flash_fwd_train", "flash_bwd_dq",
                           "flash_bwd_dkv", "flash_fwd_bf16",
                           "fused_dropout_ln_fwd",
                           "fused_dropout_residual_fwd",
                           "fused_dropout_ln_bwd", "adamw",
                           "dropout_keep")}
    for Tq, Tk in ((NMT_S, NMT_S), (NMT_T, NMT_S)):
        for p in (DROPOUT, 0.0):
            for name, t in nmt_flash_train(torch, ck, F, timer, gen, Tq, Tk,
                                           p).items():
                out[name].append(t)
            free_memory(torch)
    for Tk in NMT_SELF_T:
        out["flash_fwd_bf16"].append(nmt_flash_decode(torch, ck, F, timer,
                                                      gen, Tk, False))
    out["flash_fwd_bf16"].append(nmt_flash_decode(torch, ck, F, timer, gen,
                                                  NMT_S, True))
    for N, label in ((NMT_B * NMT_S, "nmt encoder"),
                     (NMT_B * NMT_T, "nmt decoder")):
        errs = nmt_fused_check(torch, ck, gen, N, NMT_D)
        for name, t in time_fused(torch, ck, timer, gen, N, NMT_D,
                                  torch.bfloat16, False, label).items():
            out[name].append(dict(t, N=N, Hd=NMT_D, p=DROPOUT,
                                  max_abs_err=errs[name]))
        free_memory(torch)
    out["dropout_keep"].append(dict(time_dropout_keep(
        torch, ck, timer, (NMT_B, NMT_S, NMT_FFN)),
        shape=[NMT_B, NMT_S, NMT_FFN]))
    return out


def nmt_build(dtype="bfloat16", dropout=NMT_DROPOUT, lr=None):
    """(b)'s model, Adam (beta1 0.9, beta2 0.98, epsilon 1e-9) under
    NoamDecay(d_model, 4000) (or a constant `lr`) and, for bfloat16, the
    O2 decoration; returns (model, optimizer, scheduler or None)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.optimizer import lr as plr
    prandom.seed(0)
    model = seq2seq_model(dropout=dropout, seed=0)
    model.train()
    sched = None if lr else plr.NoamDecay(NMT_D, NMT_WARMUP_STEPS)
    opt = optimizer.Adam(learning_rate=lr or sched, beta1=0.9, beta2=0.98,
                         epsilon=1e-9, parameters=model.parameters())
    if dtype == "bfloat16":
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    return model, opt, sched


def nmt_batches(torch, n):
    """n of (b)'s batches on the card (seeds 0 .. n-1), as make_train_step
    takes them: ([source, target input], [label])."""
    out = []
    for i in range(n):
        src, tin, lab = nmt_batch(NMT_B, NMT_S, NMT_T, NMT_VOCAB, i)
        out.append(([torch.from_numpy(src).cuda(),
                     torch.from_numpy(tin).cuda()],
                    [torch.from_numpy(lab).cuda()]))
    return out


def nmt_train(torch, ck, card, batches):
    """Phase 23 (b): Transformer-base training through make_train_step (one
    captured CUDA graph), the launch and path counters zeroed just before
    the NMT_WARMUP + NMT_STEPS steps and read just after, the scheduler
    stepped after each; then graph against eager from one saved state.
    Returns (the trained model, launches, step entry)."""
    import contextlib
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as PF
    t0 = time.perf_counter()
    model, opt, sched = nmt_build()
    loss_fn = lambda o, l: seq2seq_loss(PF, o, l)  # noqa: E731
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    say("nmt (b): Transformer-base %d parameters (%d tensors) in %s, vocab "
        "%d, B=%d, source %d, target %d tokens, built in %.1f s"
        % (n_params, n_tensors, next(model.parameters()).dtype, NMT_VOCAB,
           NMT_B, NMT_S, NMT_T, time.perf_counter() - t0))
    L = NMT_LAYERS
    # a step: the encoder's and the cross-attention's flash calls, 2 fused
    # tails an encoder layer and 3 a decoder layer, Adam over every
    # parameter; the keep mask for the FFNs' activation dropouts, the
    # decoder's masked self-attention (the plain path) and the two
    # embeddings' dropouts
    want = {"flash_fwd_train": 2 * L, "flash_bwd_dq": 2 * L,
            "flash_bwd_dkv": 2 * L, "flash_fwd": 0,
            "fused_dropout_ln_fwd": 5 * L, "fused_dropout_residual_fwd": 0,
            "fused_dropout_ln_bwd": 5 * L,
            "adamw": adamw_launches(model.parameters()),
            "dropout_keep": 2 * L + L + 2}
    step = make_train_step(model, loss_fn, opt)
    n_steps = NMT_WARMUP + NMT_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    losses, times = [], []
    for i in range(n_steps):
        t1 = time.perf_counter()
        loss, _ = step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
        sched.step()
    launches = ck.launch_counts()
    paths = ck.attention_path_counts()
    peak = torch.cuda.max_memory_allocated()
    progs = step.programs
    (key,) = progs.builds
    replayed = {k: progs.replays[key] * n for k, n in
                progs.launches[key].items()}
    require(step.compiles == 1 and step.replays == n_steps - 1,
            "nmt (b): %d programs and %d replays in %d steps" % (
                step.compiles, step.replays, n_steps))
    require(all(math.isfinite(x) for x in losses),
            "nmt (b): non-finite loss %s" % losses)
    per_step = {k: launches[k] / n_steps for k in want}
    say("nmt (b) losses %s" % ["%.4f" % x for x in losses])
    say("nmt (b) launches %s, attention paths %s" % (launches, paths))
    require(per_step == {k: float(v) for k, v in want.items()},
            "nmt (b): launches a step %s, want %s" % (per_step, want))
    require(all(replayed[k] > 0 for k, v in want.items() if v),
            "nmt (b): kernels launched in no replay: %s" % replayed)
    # each run of the step's body (the build's eager run and its capture)
    # takes 12 flash calls with dropout and 6 plain masked ones
    require(paths["flash_dropout"] == 2 * paths["xla_sdpa"] > 0
            and paths["flash"] == paths["xla_chunked"] == 0,
            "nmt (b): attention paths %s (want flash_dropout for the "
            "encoder and the cross-attention, xla_sdpa for the decoder's "
            "masked self-attention)" % paths)
    dev_ms, top = profile_step(torch, step, lambda: batches[0])
    sched.step()
    step_ms = statistics.median(times[NMT_WARMUP:])
    flops = nmt_flops()
    total = sum(flops.values())
    tokens = NMT_B * (NMT_S + NMT_T)
    mfu = total / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    say("nmt (b) program %s: 1 build + %d replays, captured in %.1f ms, "
        "graph pool %.1f MiB, launches a step %s (%s)"
        % (key, progs.replays[key], progs.capture_s[key] * 1e3,
           progs.pool_bytes() / 2 ** 20,
           {k: n for k, n in progs.launches[key].items() if n}, card))
    say("nmt (b) Transformer-base train step, O2 bf16, Adam + Noam, "
        "dropout %g, label smoothing %g: %.2f ms median of %d after %d "
        "warm-up (mean %.2f), %.0f tokens/s (source + target: %d a step), "
        "MFU %.4f of 989 TFLOP/s bf16 (%.3f TFLOP a step: %s), peak memory "
        "%.1f MiB (%s)"
        % (NMT_DROPOUT, NMT_SMOOTH, step_ms, NMT_STEPS, NMT_WARMUP,
           statistics.mean(times[NMT_WARMUP:]), tokens / (step_ms / 1e3),
           tokens, mfu, total / 1e12, ", ".join(
               "%s %.3f" % (k, v / 1e12) for k, v in flops.items()),
           peak / 2 ** 20, card))
    report_profile("nmt (b) captured", dev_ms, step_ms, top)
    entry = {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
             "mfu": mfu, "peak_mib": peak / 2 ** 20,
             "pool_mib": progs.pool_bytes() / 2 ** 20,
             "idle": 1.0 - dev_ms / step_ms if dev_ms > 0 else None}
    del step
    free_memory(torch)
    graph_against_eager_train(torch, ck, "nmt (b)", model, opt, loss_fn,
                              batches[:3], contextlib.nullcontext, DROPOUT)
    del opt
    free_memory(torch)
    return model, launches, entry


def nmt_compare(torch, ck, flags, batches):
    """Phase 23 (b): the kernels against their plain versions, float32,
    dropout 0, NMT_COMPARE_STEPS captured steps at lr TRAIN_LR, through
    compare_runs (use_flash_attention, use_fused_dropout_ln and
    use_fused_optimizer on, then all off): step 1's gradients per
    parameter, then the parameters outside the elements with a near-zero
    first gradient (NMT_NEAR_ZERO)."""
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as PF

    def build():
        model, opt, _ = nmt_build("float32", 0.0, TRAIN_LR)
        step = make_train_step(model, lambda o, l: seq2seq_loss(PF, o, l),
                               opt)
        return model, opt, lambda i: step(*batches[i])
    compare_runs(torch, ck, flags, "nmt (b)", build,
                 ("use_flash_attention", "use_fused_dropout_ln",
                  "use_fused_optimizer"),
                 ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                  "fused_dropout_ln_fwd", "fused_dropout_ln_bwd", "adamw"),
                 steps=NMT_COMPARE_STEPS, near_zero=NMT_NEAR_ZERO)


def nmt_decode(torch, ck, model, src, card):
    """Phase 23 (c): greedy decoding of NMT_DECODE tokens from NMT_BOS with
    (b)'s weights in eval mode: the encoder once, decoder.gen_cache(memory)
    (an incremental Cache and a StaticCache a layer), one token a step,
    timed and counted on its second run; against a decode that runs the
    whole prefix every step under the causal mask with no cache: the
    tokens equal, or first differing where the uncached run's top-2 logits
    are a near tie. Returns the cached run's launches."""
    model.eval()
    B = src.shape[0]
    L = NMT_LAYERS
    dec = model.transformer.decoder
    bos = torch.full((B, 1), NMT_BOS, dtype=torch.int64, device=src.device)
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(src))

        def cached():
            cache = dec.gen_cache(memory)
            tok, toks, logits = bos, [], []
            for t in range(NMT_DECODE):
                lg, cache = model.decode_step(tok, memory, cache, t)
                tok = lg[:, -1].argmax(-1, keepdim=True)
                toks.append(tok)
                logits.append(lg[:, -1])
            return torch.cat(toks, 1), torch.stack(logits, 1), cache
        cached()
        torch.cuda.synchronize()
        ck.launch_counts(reset=True)
        ck.attention_path_counts(reset=True)
        t0 = time.perf_counter()
        toks, lg_c, cache = cached()
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / NMT_DECODE
        launches = ck.launch_counts()
        paths = ck.attention_path_counts()
        prefix, lg_u = bos, []
        t0 = time.perf_counter()
        for t in range(NMT_DECODE):
            mask = model.transformer.generate_square_subsequent_mask(t + 1)
            h = dec(model.embed(prefix), memory, tgt_mask=mask)[:, -1:]
            lg = model.logits(h, torch.float32)[:, 0]
            lg_u.append(lg)
            prefix = torch.cat([prefix, lg.argmax(-1, keepdim=True)], 1)
        torch.cuda.synchronize()
        ms_full = (time.perf_counter() - t0) * 1e3 / NMT_DECODE
    lg_u = torch.stack(lg_u, 1)
    toks_u = prefix[:, 1:]
    require(tuple(toks.shape) == (B, NMT_DECODE)
            and all(c[0].k.shape[2] == NMT_DECODE
                    and c[1].k.shape[2] == src.shape[1] for c in cache),
            "nmt (c): tokens %s or cache lengths %s" % (
                tuple(toks.shape), [(c[0].k.shape[2], c[1].k.shape[2])
                                    for c in cache]))
    per = {k: n / NMT_DECODE for k, n in launches.items() if n}
    require(per.get("flash_fwd") == 2 * L and paths["flash"] == 2 * L *
            NMT_DECODE and paths["xla_sdpa"] == 0,
            "nmt (c): launches a step %s, attention paths %s (want %d "
            "flash_fwd a step: %d self-attention, %d cross-attention)"
            % (per, paths, 2 * L, L, L))
    top2 = lg_u.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = (toks != toks_u).cpu().numpy()
    first = [int(np.argmax(row)) if row.any() else None for row in differ]
    same = sum(f is None for f in first)
    shared = torch.tensor([[t < (f if f is not None else NMT_DECODE) + 1
                            for t in range(NMT_DECODE)] for f in first],
                          device=lg_u.device)
    dlogit = ((lg_c - lg_u).abs().amax(-1) * shared).max().item()
    gaps = [(b, f, gap[b, f].item()) for b, f in enumerate(first)
            if f is not None]
    bad = [g for g in gaps if g[2] > NMT_TIE]
    say("nmt (c) cached greedy decode B=%d, %d tokens from BOS over a %d "
        "token source: %.3f ms a token (host clock, no sync a step; the "
        "uncached decode %.3f ms a token); launches a step %s, attention "
        "paths %s; %d of %d sequences equal to the uncached decode's "
        "tokens, the rest first differ at (sequence, step, the uncached "
        "decode's top-2 gap, tie bound %g) %s; max |logit difference| "
        "(float32 logits) over the steps both decodes share %.4g (%s)"
        % (B, NMT_DECODE, src.shape[1], ms_tok, ms_full, per, paths, same,
           B, NMT_TIE, ["(%d, %d, %.4g)" % g for g in gaps], dlogit, card))
    require(not bad, "nmt (c): the cached decode first differs from the "
            "uncached one at a top-2 gap above %g: %s" % (NMT_TIE, bad[:4]))
    return launches, {"ms_per_token": ms_tok, "uncached_ms_per_token":
                      ms_full, "same": same, "max_dlogit": dlogit}


def nmt_fused(torch, ck, model, src, card):
    """Phase 23 (d): (b)'s encoder weights through fused_encoder (the fused
    block functions) at p = 0 in bfloat16, post-LN against
    model.transformer.encoder and pre-LN against an nn.TransformerEncoder
    of pre-LN layers holding the same weights; each within
    NMT_FUSED_REL_TOL; a forward + backward of the post-LN stack launches
    rows 1t, 2, 3, 4 and 6 a layer, the pre-LN layers row 5."""
    from paddle_tpu_torch.incubate.nn import functional as fused
    from paddle_tpu_torch.models import pack_qkv
    from paddle_tpu_torch.nn import TransformerEncoder, TransformerEncoderLayer
    model.eval()
    L = NMT_LAYERS
    enc = model.transformer.encoder
    pre = TransformerEncoder(TransformerEncoderLayer(
        NMT_D, NMT_HEADS, NMT_FFN, normalize_before=True), L)
    pre.load_state_dict(enc.state_dict())
    pre = pre.to(device="cuda", dtype=torch.bfloat16).eval()
    with torch.no_grad():
        x = model.embed(src)
    out = {}
    for label, ref, is_pre in (("post-LN", enc, False),
                               ("pre-LN", pre, True)):
        ck.launch_counts(reset=True)
        with torch.no_grad():
            want = ref(x)
        layer_launches = ck.launch_counts()
        xg = x.detach().requires_grad_()
        ck.launch_counts(reset=True)
        got = fused_encoder(fused, pack_qkv, enc, xg, is_pre)
        got.backward(torch.randn(got.shape, device="cuda",
                                 dtype=got.dtype))
        torch.cuda.synchronize()
        launches = ck.launch_counts()
        ea, er = abs_rel_err(got.detach(), want)
        say("nmt (d) fused functions %s, %d layers, B=%d S=%d bf16 p=0: "
            "against nn.TransformerEncoder max rel err %.3g (tol %.0e), "
            "max abs err %.3g; forward + backward launches %s; the layers' "
            "forward launches %s"
            % (label, L, src.shape[0], src.shape[1], er, NMT_FUSED_REL_TOL,
               ea, {k: n for k, n in launches.items() if n},
               {k: n for k, n in layer_launches.items() if n}))
        require(bool(torch.isfinite(got.float()).all())
                and er <= NMT_FUSED_REL_TOL, "nmt (d) %s: rel err %.3g > "
                "%.3g" % (label, er, NMT_FUSED_REL_TOL))
        need = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if not is_pre:
            need.update(fused_dropout_ln_fwd=2 * L,
                        fused_dropout_ln_bwd=2 * L)
        require(all(launches[k] == v for k, v in need.items()),
                "nmt (d) %s: launches %s, want %s" % (label, launches, need))
        if is_pre:
            require(layer_launches["fused_dropout_residual_fwd"] == 2 * L,
                    "nmt (d) pre-LN layers: launches %s, want %d of "
                    "fused_dropout_residual_fwd" % (layer_launches, 2 * L))
        out[label] = dict(rel_err=er, launches=launches,
                          layer_launches=layer_launches)
    return out


def nmt_main(torch, ck, F, flags, card):
    """Phase 23: the encoder-decoder Transformer (see the module's
    docstring), (a)-(d), with use_fused_dropout_ln on. Returns (a)'s
    entries, the launches of (b)'s timed steps and (c)'s cached decode, and
    (d)'s launches."""
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    if WORD is None:
        WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(23)
    timer = Timer(torch)
    kern = nmt_kernels(torch, ck, F, timer, gen)
    t1 = time.perf_counter()
    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    try:
        batches = nmt_batches(torch, NMT_BATCHES)
        model, tlaunches, entry = nmt_train(torch, ck, card, batches)
        shapes = [tuple(p.shape) for p in model.parameters()]
        kern["adamw"].append(time_adamw(torch, ck, timer, gen, shapes,
                                        card))
        t2 = time.perf_counter()
        src = batches[0][0][0]
        dlaunches, dec = nmt_decode(torch, ck, model, src, card)
        t3 = time.perf_counter()
        fus = nmt_fused(torch, ck, model, src, card)
        del model
        free_memory(torch)
        t4 = time.perf_counter()
        nmt_compare(torch, ck, flags, batches)
    finally:
        flags.set_flags(saved)
    free_memory(torch)
    say("nmt phase 23: %.1f s ((a) %.1f, (b) training and row 7 %.1f, (c) "
        "%.1f, (d) %.1f, (b) float32 against plain %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2, t4 - t3,
           time.perf_counter() - t4))
    return {"kernels": kern, "train": tlaunches, "decode": dlaunches,
            "fused": fus, "step": entry, "dec": dec}


# ---------------------------------------------------------------------------
# 24. the recurrent family: the LSTM and GRU recurrence against cuDNN,
# Zaremba et al.'s large LSTM language model

# Zaremba, Sutskever and Vinyals 2014 (arXiv:1409.2329), §4.1, the large
# Penn Treebank model: 2 layers of 1500 units unrolled 35 steps, batch 20,
# a 10000-word vocabulary, dropout 0.65 on the non-recurrent connections,
# weights uniform in [-0.04, 0.04], SGD at lr 1, gradients clipped to a
# global norm of 10. The ids are synthetic (the corpus is not in the
# repository)
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 1500, 2
PTB_B, PTB_T = 20, 35
PTB_DROPOUT, PTB_INIT, PTB_LR, PTB_CLIP = 0.65, 0.04, 1.0, 10.0


def ptb_model(vocab=PTB_VOCAB, hidden=PTB_HIDDEN, layers=PTB_LAYERS,
              dropout=PTB_DROPOUT, init=PTB_INIT, seed=0, device="cuda"):
    """The LSTM language model (the JAX package has no such class;
    tests/test_torch_rnn.py builds the same one on it): Embedding(vocab,
    hidden), Dropout, LSTM(hidden, hidden, layers, dropout), Dropout,
    Linear(hidden, vocab), every weight drawn by ParamAttr(Uniform(-init,
    init)). forward(ids [B, T], h0, c0 [layers, B, hidden]) -> (logits
    [B, T, vocab], h_n, c_n): truncated back-propagation takes h_n and c_n
    as the next batch's h0 and c0. Weights drawn on the CPU from a
    generator seeded with `seed`, then moved to `device`."""
    import torch
    from paddle_tpu_torch import nn

    def attr():
        return nn.ParamAttr(initializer=nn.initializer.Uniform(-init, init))

    class LSTMLM(torch.nn.Module):
        def __init__(self, g):
            super().__init__()
            self.embedding = nn.Embedding(vocab, hidden, weight_attr=attr(),
                                          generator=g)
            self.drop_in = nn.Dropout(dropout)
            self.lstm = nn.LSTM(hidden, hidden, layers, dropout=dropout,
                                weight_ih_attr=attr(), weight_hh_attr=attr(),
                                bias_ih_attr=attr(), bias_hh_attr=attr(),
                                generator=g)
            self.drop_out = nn.Dropout(dropout)
            self.proj = nn.Linear(hidden, vocab, weight_attr=attr(),
                                  bias_attr=attr(), generator=g)

        def forward(self, ids, h0, c0):
            y, (h, c) = self.lstm(self.drop_in(self.embedding(ids)),
                                  (h0, c0))
            return self.proj(self.drop_out(y)), h, c

    gen = torch.Generator().manual_seed(int(seed))
    return LSTMLM(gen).to(device)


def ptb_loss(F, logits, label):
    """The paper's loss in either package's functional namespace `F`: the
    cross entropy summed over the steps and averaged over the batch."""
    return F.cross_entropy(logits, label, reduction="sum") / label.shape[0]


# (a): the recurrence at the model's shapes and a bidirectional GRU with
# lengths (B=64, T=128, 2 layers of 512, lengths drawn in [16, 128]),
# each against PyTorch's cuDNN RNN with the same weights: forward values
# within RNN_FWD_REL_TOL of the largest |value| of each output (float32
# sums over 1500 inputs and up to 128 steps in another order), each
# parameter's gradient within RNN_GRAD_REL_TOL of its norm
RNN_FWD_REL_TOL, RNN_GRAD_REL_TOL = 1e-5, 1e-4
GRU_B, GRU_T, GRU_H, GRU_LAYERS, GRU_MIN_LEN = 64, 128, 512, 2, 16
# (a)'s timings: runs x calls a run; the GRU's port calls take 0.1-0.4 s
# each eagerly (host-bound: ~8000 launches a forward), 20-90 ms from a
# graph
RNN_TIMER_RUNS = {"lstm": (9, 3), "gru": (5, 1)}
# (b): synthetic batches taken in turn, the warm-up and timed steps
PTB_BATCHES, PTB_WARMUP, PTB_STEPS = 4, 3, 20
# (c): the bfloat16 model's first loss at p = 0 against (b)'s float32 one,
# and its logits of the largest float32 |logit|; its LSTM output and
# final states, each of the float32 array's largest |value|, within
# PTB_BF16_STATE_TOL (PERF.md §6 has the readings that set it: sound bf16
# 0.0079-0.0147, a planted fault, the cell gate scaled by PTB_FAULT_SCALE,
# 0.19-0.21)
PTB_BF16_LOSS_TOL = 2e-2
PTB_BF16_STATE_TOL, PTB_FAULT_SCALE = 5e-2, 1.1


def rnn_flops(mode, B, T, I, H, layers, dirs, tokens=None):
    """Forward FLOPs of the fused recurrence, from the shapes: the input
    projection and h @ W_hh^T of each layer and direction, 2 flops a
    multiply-add, over `tokens` valid (row, step) pairs (default B * T;
    the GEMMs' work that lengths need); pointwise math not counted."""
    G = {"LSTM": 4, "GRU": 3}.get(mode, 1) * H
    n = B * T if tokens is None else tokens
    total = 0
    for layer in range(layers):
        in_sz = I if layer == 0 else H * dirs
        total += dirs * 2 * n * (in_sz + H) * G
    return total


def ptb_flops(B=PTB_B, T=PTB_T, V=PTB_VOCAB, H=PTB_HIDDEN, L=PTB_LAYERS):
    """A training step's FLOPs from the shapes: forward (the LSTM's GEMMs
    and the output projection) times 3 for forward + backward: about 306
    MFLOP a token, 214 GFLOP a step at the paper's shapes."""
    fwd = rnn_flops("LSTM", B, T, H, H, L, 1) + 2 * B * T * H * V
    return 3 * fwd


def copy_rnn_weights(torch, src, dst):
    """The port's RNNBase weights into a torch.nn.LSTM / GRU (the same
    names, weight_ih_l0, ..., _reverse) or the other way round."""
    own = dict(dst.named_parameters())
    with torch.no_grad():
        for name, p in src.named_parameters():
            own[name].copy_(p)


def rnn_against_cudnn(torch, label, port, ref, x, states, lens=None):
    """The port's fused class and cuDNN's (torch.nn.LSTM / GRU, batch_first,
    the same weights; with `lens`, over pack_padded_sequence(
    enforce_sorted=False)) on x and the initial states: y and the final
    states within RNN_FWD_REL_TOL, each parameter's gradient under one
    cotangent within RNN_GRAD_REL_TOL of its norm. On a forward failure
    the error by time step is printed first."""
    nn_utils = torch.nn.utils.rnn
    T = x.shape[1]
    lstm = isinstance(states, tuple)
    t_lens = None if lens is None else torch.from_numpy(lens).to(x.device)
    out = port(x, states, sequence_length=t_lens)
    y, fin = out[0], (list(out[1]) if lstm else [out[1]])
    if lens is None:
        ry, rfin = ref(x, states)
    else:
        packed = nn_utils.pack_padded_sequence(
            x, torch.from_numpy(lens), batch_first=True,
            enforce_sorted=False)
        ry, rfin = ref(packed, states)
        ry, _ = nn_utils.pad_packed_sequence(ry, batch_first=True,
                                             total_length=T)
    rfin = list(rfin) if lstm else [rfin]
    errs = [rel_err(a, b, 0.0) for a, b in zip([y] + fin, [ry] + rfin)]
    if max(errs) > RNN_FWD_REL_TOL:
        scale = ry.abs().max().item()
        by_t = [round((y[:, t] - ry[:, t]).abs().max().item() / scale, 9)
                for t in range(T)]
        say("%s: y's error by time step (of max |y|) %s" % (label, by_t))
    require(max(errs) <= RNN_FWD_REL_TOL, "%s: forward against cuDNN %s "
            "(y, final states; tol %g)" % (label, errs, RNN_FWD_REL_TOL))
    gen = torch.Generator(device=x.device).manual_seed(5)
    cts = [torch.randn(t.shape, generator=gen, device=x.device)
           for t in [y] + fin]
    if lens is not None:                # no gradient into padding
        cts[0] = cts[0] * (torch.arange(T, device=x.device)[None, :, None]
                           < t_lens[:, None, None])
    names = [n for n, _ in port.named_parameters()]
    g = torch.autograd.grad([y] + fin, list(port.parameters()), cts)
    rp = dict(ref.named_parameters())
    rg = torch.autograd.grad([ry] + rfin, [rp[n] for n in names], cts)
    ratios = {n: ((a - b).double().norm() / b.double().norm()).item()
              for n, a, b in zip(names, g, rg)}
    worst = max(ratios, key=ratios.get)
    say("%s against cuDNN: y %.3g, final states %s of max |value| (tol %g); "
        "gradients ||g - g_cudnn|| / ||g_cudnn|| largest %s %.3g (tol %g)"
        % (label, errs[0], ["%.3g" % e for e in errs[1:]], RNN_FWD_REL_TOL,
           worst, ratios[worst], RNN_GRAD_REL_TOL))
    require(ratios[worst] <= RNN_GRAD_REL_TOL, "%s: gradient of %s %.3g of "
            "its norm from cuDNN's" % (label, worst, ratios[worst]))
    return y, fin


def time_recurrence(torch, timer, label, port, ref, x, states, flops, card,
                    runs, lens=None):
    """Device time of the port's forward and forward + backward, run
    eagerly (each launch enqueued from Python, as an eager step runs it)
    and replayed from a CUDA graph (as the captured train step runs it),
    and of cuDNN's eager calls for the same work (CUDA events, the median
    as phase 4 takes it, over `runs` = (runs, calls a run)), each beside
    its FLOP bound at the float32 rate."""
    nn_utils = torch.nn.utils.rnn
    t_lens = None if lens is None else torch.from_numpy(lens).cuda()
    packed = None if lens is None else nn_utils.pack_padded_sequence(
        x, torch.from_numpy(lens), batch_first=True, enforce_sorted=False)
    pp, rp = list(port.parameters()), list(ref.parameters())

    def run_port():
        return port(x, states, sequence_length=t_lens)[0]

    def run_ref():
        y = ref(x if packed is None else packed, states)[0]
        return y if packed is None else y.data

    def train(run, params):
        def call():
            y = run()
            torch.autograd.grad(y, params, torch.ones_like(y))
        return call

    def infer(run):
        def call():
            with torch.no_grad():
                run()
        return call
    runs, reps = runs
    out = {"fwd_ms": timer.ms(infer(run_port), runs, reps),
           "cudnn_fwd_ms": timer.ms(infer(run_ref), runs, reps),
           "train_ms": timer.ms(train(run_port, pp), runs, reps),
           "cudnn_train_ms": timer.ms(train(run_ref, rp), runs, reps),
           "fwd_bound_ms": flops / PEAK_FLOPS["float32"] * 1e3,
           "train_bound_ms": 3 * flops / PEAK_FLOPS["float32"] * 1e3}
    fwd_graph = graph_of(torch, infer(run_port))
    out["graph_fwd_ms"] = timer.ms(fwd_graph.replay, runs, reps)
    del fwd_graph
    train_graph = graph_of(torch, train(run_port, pp))
    out["graph_train_ms"] = timer.ms(train_graph.replay, runs, reps)
    del train_graph
    say("time %s (%.3f GFLOP forward): forward port %.4f ms eager, %.4f ms "
        "from a CUDA graph, cuDNN %.4f ms, bound %.4f ms; forward + "
        "backward port %.4f ms eager, %.4f ms from a graph, cuDNN %.4f ms, "
        "bound %.4f ms (operations at 67 TFLOP/s float32; %s)"
        % (label, flops / 1e9, out["fwd_ms"], out["graph_fwd_ms"],
           out["cudnn_fwd_ms"], out["fwd_bound_ms"], out["train_ms"],
           out["graph_train_ms"], out["cudnn_train_ms"],
           out["train_bound_ms"], card))
    return out


def rnn_recurrence(torch, timer, card):
    """Phase 24 (a): the port's LSTM(1500, 1500, 2) at B=20, T=35 and a
    2-layer bidirectional GRU(512, 512) at B=64, T=128 with lengths from
    the seed, each against cuDNN (`rnn_against_cudnn`) and timed
    (`time_recurrence`); BiRNN(GRUCell, GRUCell) against the fused GRU of
    the same weights. Float32, TF32 off for the oracle too."""
    from paddle_tpu_torch import nn
    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on: the float32 comparisons need it off")
    gen = torch.Generator(device="cuda").manual_seed(24)
    H, L = PTB_HIDDEN, PTB_LAYERS
    port = nn.LSTM(H, H, L, generator=torch.Generator().manual_seed(0)).cuda()
    ref = torch.nn.LSTM(H, H, L, batch_first=True).cuda()
    copy_rnn_weights(torch, port, ref)
    x = torch.randn(PTB_B, PTB_T, H, generator=gen, device="cuda")
    st = (0.5 * torch.randn(L, PTB_B, H, generator=gen, device="cuda"),
          0.5 * torch.randn(L, PTB_B, H, generator=gen, device="cuda"))
    label = "rnn (a) LSTM(%d, %d, %d) B=%d T=%d" % (H, H, L, PTB_B, PTB_T)
    rnn_against_cudnn(torch, label, port, ref, x, st)
    out = {"lstm": time_recurrence(
        torch, timer, label, port, ref, x, st,
        rnn_flops("LSTM", PTB_B, PTB_T, H, H, L, 1), card,
        RNN_TIMER_RUNS["lstm"])}
    del port, ref
    gport = nn.GRU(GRU_H, GRU_H, GRU_LAYERS, direction="bidirect",
                   generator=torch.Generator().manual_seed(1)).cuda()
    gref = torch.nn.GRU(GRU_H, GRU_H, GRU_LAYERS, batch_first=True,
                        bidirectional=True).cuda()
    copy_rnn_weights(torch, gport, gref)
    lens = np.random.RandomState(24).randint(
        GRU_MIN_LEN, GRU_T + 1, GRU_B).astype(np.int64)
    gx = torch.randn(GRU_B, GRU_T, GRU_H, generator=gen, device="cuda")
    h0 = 0.5 * torch.randn(2 * GRU_LAYERS, GRU_B, GRU_H, generator=gen,
                           device="cuda")
    glabel = ("rnn (a) GRU(%d, %d, %d, bidirect) B=%d T=%d lengths %d-%d "
              "(%d tokens)" % (GRU_H, GRU_H, GRU_LAYERS, GRU_B, GRU_T,
                               lens.min(), lens.max(), lens.sum()))
    rnn_against_cudnn(torch, glabel, gport, gref, gx, h0, lens)
    out["gru"] = time_recurrence(
        torch, timer, glabel, gport, gref, gx, h0,
        rnn_flops("GRU", GRU_B, GRU_T, GRU_H, GRU_H, GRU_LAYERS, 2,
                  int(lens.sum())), card, RNN_TIMER_RUNS["gru"], lens)
    # BiRNN of two cells against the fused GRU's first layer
    one = nn.GRU(GRU_H, GRU_H, 1, direction="bidirect",
                 generator=torch.Generator().manual_seed(2)).cuda()
    cells = [nn.GRUCell(GRU_H, GRU_H).cuda() for _ in range(2)]
    with torch.no_grad():
        for cell, sfx in zip(cells, ("", "_reverse")):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(cell, k).copy_(getattr(one, k + "_l0" + sfx))
    t_lens = torch.from_numpy(lens).cuda()
    with torch.no_grad():
        y, h = one(gx, h0[:2], sequence_length=t_lens)
        yb, (sf, sb) = nn.BiRNN(*cells)(gx, (h0[0], h0[1]),
                                        sequence_length=t_lens)
    errs = [rel_err(yb, y, 0.0), rel_err(sf, h[0], 0.0),
            rel_err(sb, h[1], 0.0)]
    say("rnn (a) BiRNN(GRUCell, GRUCell) against the fused GRU (1 layer, "
        "the same weights, lengths): y %.3g, states %.3g / %.3g of max "
        "|value| (tol %g)" % (*errs, RNN_FWD_REL_TOL))
    require(max(errs) <= RNN_FWD_REL_TOL, "rnn (a): BiRNN against the "
            "fused GRU %s" % errs)
    return out


def ptb_batches(torch, n, B=PTB_B, T=PTB_T, V=PTB_VOCAB):
    """n synthetic batches (seeds 0 .. n-1) on the card: ids [B, T] and the
    next ids as labels."""
    out = []
    for i in range(n):
        ids = np.random.RandomState(i).randint(0, V, (B, T + 1))
        out.append((torch.from_numpy(ids[:, :-1]).cuda(),
                    torch.from_numpy(ids[:, 1:]).cuda()))
    return out


def ptb_build(torch, dropout=PTB_DROPOUT, dtype="float32"):
    """(b)'s model, SGD(1.0) under ClipGradByGlobalNorm(10), and for
    bfloat16 the O2 decoration: (model, optimizer, step, states zeros)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as PF
    prandom.seed(0)
    model = ptb_model(dropout=dropout, seed=0)
    model.train()
    opt = optimizer.SGD(learning_rate=PTB_LR, parameters=model.parameters(),
                        grad_clip=optimizer.ClipGradByGlobalNorm(PTB_CLIP))
    if dtype != "float32":
        model, opt = amp.decorate(model, opt, level="O2", dtype=dtype)
    step = make_train_step(model, lambda o, h, c, y: ptb_loss(PF, o, y), opt)
    z = torch.zeros(PTB_LAYERS, PTB_B, PTB_HIDDEN, device="cuda",
                    dtype=next(model.parameters()).dtype)
    return model, opt, step, z


def ptb_run(torch, ck, label, step, batches, z, ctx, card):
    """PTB_WARMUP + PTB_STEPS captured steps, the states carried from step
    to step (truncated back-propagation), the counters zeroed just before
    and read just after: (losses, step times ms, launches, replayed
    launches, the program's key)."""
    h = c = z
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    losses, times = [], []
    with ctx():
        for i in range(PTB_WARMUP + PTB_STEPS):
            ids, lab = batches[i % len(batches)]
            t0 = time.perf_counter()
            loss, (_, h, c) = step([ids, h, c], [lab])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    launches = ck.launch_counts()
    progs = step.programs
    (key,) = progs.builds
    replayed = {k: progs.replays[key] * n
                for k, n in progs.launches[key].items()}
    n = PTB_WARMUP + PTB_STEPS
    require(step.compiles == 1 and step.replays == n - 1,
            "%s: %d programs and %d replays in %d steps"
            % (label, step.compiles, step.replays, n))
    require(all(math.isfinite(x) for x in losses),
            "%s: non-finite loss %s" % (label, losses))
    say("%s losses %s" % (label, ["%.3f" % x for x in losses]))
    return losses, times[PTB_WARMUP:], launches, replayed, key, (h, c)


def ptb_train(torch, ck, card, batches):
    """Phase 24 (b): the large LSTM language model (float32, dropout 0.65)
    through make_train_step (one CUDA graph), PTB_WARMUP + PTB_STEPS steps
    with the states carried: the keep mask's launches a step (3: after the
    embedding, between the LSTM's layers, before the projection) and
    through replays, no other kernel; step ms, tokens/s, MFU, peak memory,
    the graph pool, a profiled step; then the captured step against its
    eager bodies over 3 steps from one state. Returns (launches, entry)."""
    import contextlib
    from paddle_tpu_torch.nn import functional as PF
    t0 = time.perf_counter()
    model, opt, step, z = ptb_build(torch)
    n_params = sum(p.numel() for p in model.parameters())
    say("ptb (b): LSTM LM %d parameters (%d tensors), vocab %d, %d x %d, "
        "B=%d, T=%d, dropout %g, built in %.1f s"
        % (n_params, len(list(model.parameters())), PTB_VOCAB, PTB_LAYERS,
           PTB_HIDDEN, PTB_B, PTB_T, PTB_DROPOUT, time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = {k: 0 for k in ck.launch_counts()}
    want["dropout_keep"] = 3
    _, times, launches, replayed, key, _ = ptb_run(
        torch, ck, "ptb (b)", step, batches, z, contextlib.nullcontext, card)
    peak = torch.cuda.max_memory_allocated()
    n = PTB_WARMUP + PTB_STEPS
    per_step = {k: v / n for k, v in launches.items()}
    say("ptb (b) launches %s (%d steps)" % (launches, n))
    require(per_step == {k: float(v) for k, v in want.items()},
            "ptb (b): launches a step %s, want %s" % (per_step, want))
    require(replayed["dropout_keep"] > 0, "ptb (b): the keep mask launched "
            "in no replay: %s" % replayed)
    ids, lab = batches[0]
    dev_ms, top = profile_step(torch, step, lambda: ([ids, z, z], [lab]))
    step_ms = statistics.median(times)
    flops = ptb_flops()
    tokens = PTB_B * PTB_T
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    progs = step.programs
    say("ptb (b) program %s: 1 build + %d replays, captured in %.1f ms, "
        "graph pool %.1f MiB (%s)" % (key, progs.replays[key],
                                      progs.capture_s[key] * 1e3,
                                      progs.pool_bytes() / 2 ** 20, card))
    say("ptb (b) LSTM LM train step, float32, SGD + clip, dropout %g: %.2f "
        "ms median of %d after %d warm-up (mean %.2f), %.0f tokens/s (%d a "
        "step), MFU %.4f of 989 TFLOP/s bf16 (%.4f of 67 TFLOP/s float32; "
        "%.1f GFLOP a step), peak memory %.1f MiB (%s)"
        % (PTB_DROPOUT, step_ms, PTB_STEPS, PTB_WARMUP,
           statistics.mean(times), tokens / (step_ms / 1e3), tokens, mfu,
           flops / (step_ms / 1e3) / PEAK_FLOPS["float32"], flops / 1e9,
           peak / 2 ** 20, card))
    report_profile("ptb (b) captured", dev_ms, step_ms, top)
    entry = {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
             "mfu": mfu, "peak_mib": peak / 2 ** 20,
             "pool_mib": progs.pool_bytes() / 2 ** 20,
             "idle": 1.0 - dev_ms / step_ms if dev_ms > 0 else None}
    del step
    free_memory(torch)
    graph_against_eager_train(
        torch, ck, "ptb (b)", model, opt,
        lambda o, h, c, y: ptb_loss(PF, o, y),
        [([ids, z, z], [lab]) for ids, lab in batches[:3]],
        contextlib.nullcontext, PTB_DROPOUT)
    return launches, entry


def ptb_against_cudnn(torch, batches):
    """Phase 24 (b), float32 at p = 0: step 1 (one forward and backward on
    one batch from zero states) of the port's model against the same
    model whose LSTM is torch.nn.LSTM (cuDNN) with copied weights: the
    losses within 1e-4, each parameter's gradient within TRAIN_GRAD_TOL of
    its norm (compare_runs' rule, with its floor). Returns the port's
    p = 0 outputs (ptb_outputs' keys)."""
    from paddle_tpu_torch.nn import functional as PF
    model = ptb_model(dropout=0.0, seed=0)
    twin = ptb_model(dropout=0.0, seed=0)
    twin.lstm = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                              batch_first=True).cuda()
    copy_rnn_weights(torch, model.lstm, twin.lstm)
    ids, lab = batches[0]
    z = torch.zeros(PTB_LAYERS, PTB_B, PTB_HIDDEN, device="cuda")
    out = []
    for m in (model, twin):
        seen = []
        hook = m.lstm.register_forward_hook(
            lambda mod, args, o: seen.append(o[0].detach()))
        logits, h, c = m(ids, z, z)
        hook.remove()
        loss = ptb_loss(PF, logits, lab)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out.append((loss.item(), dict(zip(names, grads)),
                    {"loss": loss.item(), "y": seen[0], "h_n": h.detach(),
                     "c_n": c.detach(), "logits": logits.detach()}))
    (kl, kg, k_out), (pl, pg, _) = out
    norms = {n: g.double().norm().item() for n, g in pg.items()}
    floor = TRAIN_GRAD_FLOOR * math.sqrt(sum(v * v for v in norms.values()))
    ratios = {n: (kg[n] - g).double().norm().item() / max(norms[n], floor)
              for n, g in pg.items()}
    worst = max(ratios, key=ratios.get)
    rel = abs(kl - pl) / abs(pl)
    say("ptb (b) float32 p=0 step 1 against the cuDNN-LSTM model: loss "
        "%.6f vs %.6f (rel %.3g, tol 1e-4); gradients ||g - g_cudnn|| / "
        "||g_cudnn|| largest %s %.3g (tol %g)"
        % (kl, pl, rel, worst, ratios[worst], TRAIN_GRAD_TOL))
    require(rel <= 1e-4, "ptb (b): loss %.6f against cuDNN's %.6f"
            % (kl, pl))
    require(ratios[worst] <= TRAIN_GRAD_TOL, "ptb (b): gradient of %s %.3g "
            "of its norm from the cuDNN model's" % (worst, ratios[worst]))
    return k_out


def ptb_outputs(torch, PF, model, ids, lab, z, ctx):
    """One p = 0 forward of the language model under `ctx` from zero
    states: the loss, the LSTM's output y (before the projection), h_n,
    c_n and the logits."""
    seen = []
    hook = model.lstm.register_forward_hook(
        lambda mod, args, o: seen.append(o[0]))
    with torch.no_grad(), ctx():
        logits, h, c = model(ids, z, z)
        loss = float(ptb_loss(PF, logits, lab))
    hook.remove()
    return {"loss": loss, "y": seen[0], "h_n": h, "c_n": c,
            "logits": logits}


def ptb_bf16(torch, ck, card, batches, f32):
    """Phase 24 (c): the model under amp.decorate O2 bfloat16, every step
    under auto_cast(O2, bfloat16): PTB_WARMUP + PTB_STEPS captured steps
    (step ms, tokens/s, every loss finite); then at p = 0 from the same
    weights and batch, against (b)'s float32 outputs `f32`: the first
    loss within PTB_BF16_LOSS_TOL (at the initial weights the logits lie
    within a few hundredths of 0, so the loss is close to T ln(vocab)
    whatever the model computes: a weak check) and the logits, of the
    largest float32 |logit|; the LSTM's y, h_n and c_n each within
    PTB_BF16_STATE_TOL of its own largest float32 |value|. Then a planted
    fault, the cell gate g's rows of every LSTM weight and bias scaled by
    PTB_FAULT_SCALE (about that much off in c and h), must put each of y,
    h_n and c_n past PTB_BF16_STATE_TOL: the bound tells a wrong
    recurrence from bf16 rounding. Each loss is also taken in float64
    from its logits (torch's cross entropy, a yardstick only)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as PF

    def ctx():
        return amp.auto_cast(level="O2", dtype="bfloat16")
    model, opt, step, z = ptb_build(torch, dtype="bfloat16")
    _, times, launches, _, _, _ = ptb_run(torch, ck, "ptb (c) bf16", step,
                                          batches, z, ctx, card)
    step_ms = statistics.median(times)
    tokens = PTB_B * PTB_T
    say("ptb (c) LSTM LM train step, O2 bf16: %.2f ms median of %d (mean "
        "%.2f), %.0f tokens/s, MFU %.4f of 989 TFLOP/s bf16, launches %s "
        "(%s)" % (step_ms, PTB_STEPS, statistics.mean(times),
                  tokens / (step_ms / 1e3),
                  ptb_flops() / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
                  {k: v for k, v in launches.items() if v}, card))
    del model, opt, step
    free_memory(torch)
    m16 = amp.decorate(ptb_model(dropout=0.0, seed=0), level="O2",
                       dtype="bfloat16")
    ids, lab = batches[0]
    z = torch.zeros(PTB_LAYERS, PTB_B, PTB_HIDDEN, device="cuda",
                    dtype=torch.bfloat16)
    keys, states = ("y", "h_n", "c_n", "logits"), ("y", "h_n", "c_n")

    def errors(out):
        return {k: rel_err(out[k], f32[k], 0.0) for k in keys}

    def ce64(logits):
        return torch.nn.functional.cross_entropy(
            logits.double().flatten(0, 1), lab.flatten(),
            reduction="sum").item() / PTB_B
    b16 = ptb_outputs(torch, PF, m16, ids, lab, z, ctx)
    rel = abs(b16["loss"] - f32["loss"]) / abs(f32["loss"])
    errs = errors(b16)
    f64 = ce64(f32["logits"])
    say("ptb (c) bf16 p=0 first loss %.9g against float32's %.9g: rel %.3g "
        "(tol %g); in float64 from each's logits %.12g against %.12g (%.3g "
        "apart); of each float32 array's largest |value| (%s): %s (tol: "
        "states %g, logits %g)"
        % (b16["loss"], f32["loss"], rel, PTB_BF16_LOSS_TOL,
           ce64(b16["logits"]), f64, ce64(b16["logits"]) - f64,
           ", ".join("%s %.4g" % (k, f32[k].abs().max().item())
                     for k in keys),
           ", ".join("%s %.3g" % kv for kv in errs.items()),
           PTB_BF16_STATE_TOL, PTB_BF16_LOSS_TOL))
    require(rel <= PTB_BF16_LOSS_TOL
            and errs["logits"] <= PTB_BF16_LOSS_TOL
            and max(errs[k] for k in states) <= PTB_BF16_STATE_TOL,
            "ptb (c): bf16 loss %.4f against float32's %.4f, outputs %s"
            % (b16["loss"], f32["loss"], errs))
    H = PTB_HIDDEN
    with torch.no_grad():
        for p in m16.lstm.parameters():      # [i, f, g, o] blocks of 4H
            p[2 * H:3 * H] *= PTB_FAULT_SCALE
    bad = ptb_outputs(torch, PF, m16, ids, lab, z, ctx)
    bad_errs = errors(bad)
    say("ptb (c) planted fault, gate g x %g: loss %.9g (rel %.3g; float64 "
        "%.12g, %.3g from float32's logits); %s (each of y, h_n, c_n must "
        "pass tol %g)"
        % (PTB_FAULT_SCALE, bad["loss"],
           abs(bad["loss"] - f32["loss"]) / abs(f32["loss"]),
           ce64(bad["logits"]), ce64(bad["logits"]) - f64,
           ", ".join("%s %.3g" % kv for kv in bad_errs.items()),
           PTB_BF16_STATE_TOL))
    require(min(bad_errs[k] for k in states) > PTB_BF16_STATE_TOL,
            "ptb (c): the bound %g lets a gate scaled by %g through: %s"
            % (PTB_BF16_STATE_TOL, PTB_FAULT_SCALE, bad_errs))
    return {"step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "errs": errs, "fault_errs": bad_errs}


def rnn_main(torch, ck, card):
    """Phase 24: the recurrent family (see the module's docstring), (a)-(c).
    Returns (b)'s launches, the keep mask's time at the model's dropout
    shape and the phase's numbers."""
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    if WORD is None:
        WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    t0 = time.perf_counter()
    check_dropout_keep(torch, ck, ptb_keep_cases())
    timer = Timer(torch)
    rec = rnn_recurrence(torch, timer, card)
    free_memory(torch)
    t1 = time.perf_counter()
    batches = ptb_batches(torch, PTB_BATCHES)
    launches, entry = ptb_train(torch, ck, card, batches)
    free_memory(torch)
    keep = time_dropout_keep(torch, ck, timer, (PTB_B, PTB_T, PTB_HIDDEN),
                             PTB_DROPOUT)
    t2 = time.perf_counter()
    f32 = ptb_against_cudnn(torch, batches)
    free_memory(torch)
    t3 = time.perf_counter()
    bf16 = ptb_bf16(torch, ck, card, batches, f32)
    del f32
    free_memory(torch)
    say("rnn phase 24: %.1f s ((a) %.1f, (b) %.1f, (b) against cuDNN %.1f, "
        "(c) %.1f)" % (time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2,
                       time.perf_counter() - t3))
    return {"launches": launches, "keep": keep, "recurrence": rec,
            "step": entry, "bf16": bf16}


# ---------------------------------------------------------------------------
# 25. the tensor-op surface on the card, and GPT-2-small-MoE training

# GShard's configuration (Lepikhin et al. 2020, §2) at GPT-2-small's width:
# top-2 gating, capacity factor 1.25, MoE in every other block, 8 experts;
# the load-balancing loss at 0.01 in the criterion (tests/test_moe.py:238)
MOE_EXPERTS, MOE_TOP_K, MOE_CF, MOE_EVERY, MOE_AUX = 8, 2, 1.25, 2, 0.01
# (c): the float32 comparison at B=4 and 4 blocks (2 of them MoE)
MOE_COMPARE_B, MOE_COMPARE_LAYERS = 4, 4
# a routing decision whose competing gate probabilities lie within this is
# a near tie that summation order may flip (the only exemption in (c))
MOE_TIE = 1e-5
# (a): ops on the card against the same ops on CPU tensors, the largest
# error over the largest |value| of the CPU result (at least 1)
OPS_TOL = {"elementwise": 1e-5, "reduction": 1e-4}
OPS_DRAWS = 10 ** 6
OP_MODULES = ("math", "manipulation", "creation", "linalg", "random_ops")


def _u(lo, hi, shape=(4, 3)):
    return lambda rs: (lo + (hi - lo) * rs.rand(*shape)).astype(np.float32)


def _i64(lo, hi, shape):
    return lambda rs: rs.randint(lo, hi, shape).astype(np.int64)


def _bools(shape=(4, 3)):
    return lambda rs: rs.rand(*shape) > 0.5


def _well(n=3):
    return lambda rs: (rs.rand(n, n) + n * np.eye(n)).astype(np.float32)


def _spd(n=3):
    def make(rs):
        a = rs.rand(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


def _sym(n=4):
    def make(rs):
        a = rs.rand(n, n)
        return (a + a.T + np.diag(np.arange(n) * 2.0)).astype(np.float32)
    return make


def _perm_rows(rows, cols):
    return lambda rs: np.stack([rs.permutation(cols) for _ in range(rows)]
                               ).astype(np.int64)


def _const(a):
    return lambda rs: np.array(a)


_SG = _u(-1.5, 1.5)
# (inputs, attrs) of the ops the default (one uniform [0.25, 2.75] [4, 3]
# input for each required positional) does not fit
OP_SPECS = {
    "acos": ([_u(-0.9, 0.9)], {}), "asin": ([_u(-0.9, 0.9)], {}),
    "atanh": ([_u(-0.9, 0.9)], {}), "erfinv": ([_u(-0.9, 0.9)], {}),
    "acosh": ([_u(1.1, 3.0)], {}), "logit": ([_u(0.1, 0.9)], {}),
    "tan": ([_u(-0.6, 0.6)], {}), "sin": ([_SG], {}), "cos": ([_SG], {}),
    "sign": ([_SG], {}), "abs": ([_SG], {}), "neg": ([_SG], {}),
    "clip": ([_SG], {"min": -0.5, "max": 0.5}),
    "clip_t": ([_SG, _const(np.float32(-0.5)), _const(np.float32(0.5))],
               {}),
    "elementwise_pow": ([_u(0.5, 2), _u(-2, 2)], {}),
    "matmul_v2": ([_u(-1, 1, (3, 4)), _u(-1, 1, (4, 5))], {}),
    "mul": ([_u(-1, 1, (2, 3, 4)), _u(-1, 1, (12, 5))], {}),
    "dot": ([_u(-1, 1, (5,)), _u(-1, 1, (5,))], {}),
    "addmm": ([_u(-1, 1, (3, 5)), _u(-1, 1, (3, 4)), _u(-1, 1, (4, 5))],
              {}),
    "outer": ([_u(-1, 1, (3,)), _u(-1, 1, (4,))], {}),
    "inner": ([_u(-1, 1, (3, 4)), _u(-1, 1, (2, 4))], {}),
    "cross": ([_u(-1, 1, (4, 3)), _u(-1, 1, (4, 3))], {"axis": 1}),
    "bmm": ([_u(-1, 1, (2, 3, 4)), _u(-1, 1, (2, 4, 5))], {}),
    "mv": ([_u(-1, 1, (3, 4)), _u(-1, 1, (4,))], {}),
    "kron": ([_u(-1, 1, (2, 3)), _u(-1, 1, (3, 2))], {}),
    "quantile": ([_u(-1, 1, (4, 5))], {"q": 0.3, "axis": 1}),
    "median": ([_u(-1, 1, (4, 6))], {"axis": 1}),
    "top_k_v2": ([_u(-1, 1, (4, 6))], {"k": 2}),
    "cumsum": ([_SG], {"axis": 1}), "cummax": ([_SG], {"axis": 0}),
    "logcumsumexp": ([_SG], {"axis": 0}), "cumprod": ([_u(0.5, 1.5)],
                                                      {"dim": 0}),
    "reduce_sum": ([_SG], {"axis": 1}),
    "reduce_mean": ([_SG], {"axis": 0, "keepdim": True}),
    "reduce_prod": ([_u(0.5, 1.5)], {"axis": 1}),
    "sort_op": ([_SG], {"axis": 0, "descending": True}),
    "argsort": ([_SG], {"axis": 1, "descending": True}),
    "logical_and": ([_bools(), _bools()], {}),
    "logical_or": ([_bools(), _bools()], {}),
    "logical_xor": ([_bools(), _bools()], {}),
    "logical_not": ([_bools()], {}),
    "bitwise_and": ([_i64(0, 16, (4, 3)), _i64(0, 16, (4, 3))], {}),
    "bitwise_or": ([_i64(0, 16, (4, 3)), _i64(0, 16, (4, 3))], {}),
    "bitwise_xor": ([_i64(0, 16, (4, 3)), _i64(0, 16, (4, 3))], {}),
    "bitwise_not": ([_i64(0, 16, (4, 3))], {}),
    "gcd": ([_i64(0, 20, (4, 3)), _i64(0, 20, (4, 3))], {}),
    "lcm": ([_i64(1, 12, (4, 3)), _i64(1, 12, (4, 3))], {}),
    "where": ([_bools(), _SG, _SG], {}),
    "masked_select": ([_SG, _bools()], {}),
    "nonzero": ([lambda rs: (rs.rand(4, 3) > 0.5).astype(np.float32)], {}),
    "unique": ([lambda rs: rs.randint(0, 5, (4, 3)).astype(np.float32)],
               {}),
    "multiplex": ([_const(np.array([[1], [0], [1], [0]], np.int32)), _SG,
                   _SG], {}),
    "lerp": ([_SG, _SG, _u(0.1, 0.9)], {}),
    "heaviside": ([_SG, _u(0.25, 2.75)], {}),
    "searchsorted_op": ([lambda rs: np.sort(rs.rand(2, 5), -1)
                         .astype(np.float32), _u(0, 1, (2, 3))], {}),
    "tensordot_op": ([_u(-1, 1, (2, 3, 4)), _u(-1, 1, (3, 4, 5))],
                     {"axes": 2}),
    "dist_op": ([_SG, _SG], {"p": 3.0}),
    "nan_to_num": ([_const(np.array([1.0, np.nan, np.inf, -np.inf, -2.0],
                                    np.float32))], {"posinf": 9.0}),
    "increment": ([_u(-1, 1, (1,))], {}),
    "cast": ([_SG], {"dtype": "float64"}),
    "reshape2": ([_SG], {"shape": [3, 4]}),
    "transpose2": ([_SG], {"perm": [1, 0]}),
    "unsqueeze2": ([_SG], {"axis": [0]}),
    "squeeze2": ([_u(-1, 1, (1, 3, 4))], {}),
    "concat_op": ([_u(-1, 1, (2, 3)), _u(-1, 1, (4, 3))], {"axis": 0}),
    "stack_op": ([_u(-1, 1, (2, 3)), _u(-1, 1, (2, 3))], {"axis": 1}),
    "unstack_op": ([_u(-1, 1, (3, 4))], {"axis": 1}),
    "split_op": ([_SG], {"sections": 2, "axis": 0}),
    "slice_op": ([_SG], {"axes": [0], "starts": [0], "ends": [2]}),
    "strided_slice_op": ([_SG], {"axes": [0], "starts": [3], "ends": [0],
                                 "strides": [-2]}),
    "getitem": ([_SG], {"index": (slice(0, 2),)}),
    "getitem_dyn": ([_SG, _const(np.array([2, 0, 3], np.int64))],
                    {"index_template": ("__arr__", slice(0, 2))}),
    "gather_op": ([_SG, _i64(0, 4, (3,))], {}),
    "gather_nd": ([_SG, _const(np.array([[0, 1], [3, 2], [1, 0]],
                                        np.int64))], {}),
    "take_along_axis_op": ([_SG, _perm_rows(4, 3)], {"axis": 1}),
    "put_along_axis_op": ([_SG, _perm_rows(4, 3), _SG], {"axis": 1}),
    "scatter_op": ([_u(-1, 1, (5, 4)), _const(np.array([0, 2, 4],
                                                       np.int64)),
                    _u(-1, 1, (3, 4))], {}),
    "scatter_nd_add_op": ([_u(-1, 1, (5, 4)), _i64(0, 5, (3, 1)),
                           _u(-1, 1, (3, 4))], {}),
    "index_select_op": ([_SG, _i64(0, 4, (3,))], {}),
    "index_sample_op": ([_u(-1, 1, (3, 5)), _i64(0, 5, (3, 2))], {}),
    "tile_op": ([_SG], {"repeat_times": [2, 1]}),
    "expand_v2": ([_u(-1, 1, (1, 3))], {"shape": [4, 3]}),
    "broadcast_tensors_op": ([_u(-1, 1, (2, 1)), _u(-1, 1, (1, 3))], {}),
    "flip_op": ([_SG], {"axis": 0}),
    "roll_op": ([_SG], {"shifts": 1}),
    "rot90_op": ([_SG], {"k": 1, "axes": (0, 1)}),
    "pad3d_op": ([_u(-1, 1, (2, 3, 4))],
                 {"paddings": ((0, 0), (1, 2), (2, 1)), "mode": "reflect"}),
    "repeat_interleave_op": ([_SG], {"repeats": 2}),
    "moveaxis_op": ([_u(-1, 1, (2, 3, 4))],
                    {"source": 0, "destination": 1}),
    "as_complex_op": ([_u(-1, 1, (4, 3, 2))], {}),
    "as_real_op": ([lambda rs: (rs.randn(4, 3) + 1j * rs.randn(4, 3))
                    .astype(np.complex64)], {}),
    "unique_consecutive_op": ([_const(np.array([1, 1, 2, 2, 3, 1],
                                               np.float32))], {}),
    "shard_index_op": ([_i64(0, 8, (4, 1))],
                       {"index_num": 8, "nshards": 2, "shard_id": 0}),
    "fill_constant": ([], {"shape": (2, 3), "fill_value": 1.5,
                           "dtype": "float32"}),
    "fill_like": ([_SG], {"fill_value": 2.0}),
    "arange": ([], {"start": 0.0, "end": 2.0, "step": 0.3,
                    "dtype": "float32"}),
    "linspace": ([], {"start": -1.0, "stop": 2.0, "num": 7,
                      "dtype": "float32"}),
    "logspace": ([], {"start": 0.0, "stop": 2.0, "num": 5, "base": 10.0,
                      "dtype": "float32"}),
    "eye_op": ([], {"num_rows": 3, "num_columns": 4, "dtype": "float32"}),
    "tril_op": ([_u(-1, 1, (4, 4))], {"diagonal": -1}),
    "triu_op": ([_u(-1, 1, (4, 4))], {"diagonal": 1}),
    "diag_v2": ([_u(-1, 1, (4,))], {"offset": 1, "padding_value": 0.5}),
    "diagflat": ([_u(-1, 1, (3,))], {}),
    "diag_embed": ([_u(-1, 1, (2, 3))], {"offset": 1}),
    "diagonal": ([_u(-1, 1, (3, 4))], {"offset": 1}),
    "meshgrid_op": ([_u(-1, 1, (3,)), _u(-1, 1, (4,))], {}),
    "complex_op": ([_SG, _SG], {}),
    "matrix_norm": ([_SG], {"porder": 1.0, "axis": (-2, -1)}),
    "cholesky_op": ([_spd()], {}),
    "cholesky_solve_op": ([_u(-1, 1, (3, 2)), lambda rs: np.linalg.cholesky(
        _spd()(rs)).astype(np.float32)], {}),
    "inverse_op": ([_well()], {}), "det_op": ([_well()], {}),
    "slogdet_op": ([_well()], {}), "cond_number_op": ([_well()], {}),
    "matrix_power_op": ([_well()], {"n": 2}),
    "matrix_rank_op": ([_well()], {}),
    "pinv_op": ([_u(-1, 1, (4, 3))], {}),
    "svd_op": ([_u(-1, 1, (4, 3))], {}), "qr_op": ([_u(-1, 1, (4, 3))], {}),
    "lu_op": ([_well(4)], {}), "eig_op": ([_well(4)], {}),
    "eigvals_op": ([_well(4)], {}), "eigh_op": ([_sym()], {}),
    "eigvalsh_op": ([_sym()], {}),
    "solve_op": ([_well(), _u(-1, 1, (3, 2))], {}),
    "triangular_solve_op": ([lambda rs: (np.tril(rs.rand(3, 3))
                                         + 2 * np.eye(3)).astype(np.float32),
                             _u(-1, 1, (3, 2))], {}),
    "lstsq_op": ([_u(-1, 1, (6, 3)), _u(-1, 1, (6, 2))], {}),
    "multi_dot_op": ([_u(-1, 1, (2, 3)), _u(-1, 1, (3, 4)),
                      _u(-1, 1, (4, 2))], {}),
    "histogram_op": ([_u(-1, 1, (20,))], {"bins": 5}),
    "bincount_op": ([_i64(0, 6, (10,))], {"minlength": 3}),
    "trace_op": ([_u(-1, 1, (3, 4))], {"offset": 1}),
    "einsum_op": ([_u(-1, 1, (2, 3, 4)), _u(-1, 1, (2, 4, 5))],
                  {"equation": "bij,bjk->bik"}),
    "corrcoef_op": ([_u(-1, 1, (3, 6))], {}),
    "cov_op": ([_u(-1, 1, (3, 6))], {}),
}
# one element in, one out: held to OPS_TOL["elementwise"]; the rest sum
OPS_ELEMENTWISE = ("elementwise_", "atan2", "scale", "neg", "abs", "sign", "exp",
             "log", "sqrt", "rsqrt", "square", "reciprocal", "sin", "cos",
             "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh",
             "acosh", "atanh", "ceil", "floor", "round", "trunc", "frac",
             "erf", "erfinv", "lgamma", "digamma", "angle", "conj", "real",
             "imag", "is", "clip", "stanh", "logit", "nan_to_num",
             "increment", "lerp", "rad2deg", "deg2rad", "gcd", "lcm",
             "heaviside", "identity", "equal", "not_equal", "greater",
             "less", "logical", "bitwise", "where", "masked_select",
             "multiplex", "frexp")
# factorizations unique up to signs or order: held by reconstruction
OPS_RECONSTRUCT = ("svd_op", "qr_op", "lu_op", "eig_op", "eigh_op",
                   "eigvals_op")


def port_op_modules():
    """{module: [op type, ...]} of the port's registered ops in
    ops/{math,manipulation,creation,linalg,random_ops}.py."""
    from paddle_tpu_torch.framework.dispatch import OPS
    return {m: sorted(n for n, o in OPS.items()
                      if o.fn.__module__ == "paddle_tpu_torch.ops." + m)
            for m in OP_MODULES}


def _op_inputs(op, fn):
    import inspect
    import zlib
    if op in OP_SPECS:
        makers, attrs = OP_SPECS[op]
    else:
        n = sum(1 for p in inspect.signature(fn).parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD
                and p.default is p.empty)
        makers, attrs = [_u(0.25, 2.75)] * n, {}
    rs = np.random.RandomState(zlib.crc32(op.encode()) % 2 ** 31)
    return [np.asarray(m(rs)) for m in makers], dict(attrs)


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _err(torch, got, want, name):
    """max |got - want| over the largest |want| (at least 1), dtype and
    shape exact, integers and bools exact."""
    require(got.dtype == want.dtype and tuple(got.shape) == tuple(
        want.shape), "%s: %s %s on the card, %s %s on the CPU"
        % (name, got.dtype, tuple(got.shape), want.dtype, tuple(want.shape)))
    g, w = got.detach().cpu(), want.detach()
    if not (w.is_floating_point() or w.is_complex()):
        require(torch.equal(g, w), "%s: integer outputs differ" % name)
        return 0.0
    if w.numel() == 0:
        return 0.0
    g, w = g.to(torch.complex128 if w.is_complex() else torch.float64), \
        w.to(torch.complex128 if w.is_complex() else torch.float64)
    require(torch.equal(torch.isnan(g), torch.isnan(w)),
            "%s: NaNs differ" % name)
    fin = ~torch.isnan(w)
    d = torch.where(g == w, torch.zeros_like(w), g - w)[fin].abs()
    mag = w[torch.isfinite(w)].abs()
    s = max(1.0, float(mag.max())) if mag.numel() else 1.0
    return float(d.max()) / s if d.numel() else 0.0


def _reconstruct(torch, op, outs, a):
    """The factorization's residual over |a|'s largest value."""
    a = a.to(outs[0].device)
    if op == "svd_op":
        u, s, vh = outs
        r = (u * s) @ vh - a
    elif op == "qr_op":
        r = outs[0] @ outs[1] - a
    elif op == "lu_op":
        p, lo, up = torch.lu_unpack(outs[0], outs[1])
        r = p @ lo @ up - a
    elif op == "eig_op":
        w, v = outs
        r = a.to(v.dtype) @ v - v * w
    elif op == "eigh_op":
        w, v = outs
        r = a @ v - v * w
    else:
        return 0.0
    return float(r.abs().max()) / max(1.0, float(a.abs().max()))


def check_op_sweep(torch):
    """Phase 25 (a): every ported op of the five modules on CUDA tensors
    against the same op on CPU tensors, forward and (where the op is
    differentiable) the input gradients under one cotangent; the random
    ops by their distributions. Returns {family: largest error}."""
    from paddle_tpu_torch.framework.dispatch import OPS
    mods = port_op_modules()
    worst, n_checked, n_grad = {}, 0, 0
    for mod in OP_MODULES:
        if mod == "random_ops":
            continue
        for op in mods[mod]:
            prim = OPS[op]
            arrays, attrs = _op_inputs(op, prim.fn)
            kind = ("elementwise" if op.startswith(OPS_ELEMENTWISE)
                    or mod == "manipulation" else "reduction")
            family = "%s/%s" % (mod, kind)
            extra = ({"device": "cuda"} if mod == "creation" and not arrays
                     else {})

            def inputs(dev, grad):
                out = []
                for a in arrays:
                    t = torch.from_numpy(np.array(a)).to(dev)
                    if grad and (t.is_floating_point()) and t.ndim:
                        t.requires_grad_(True)
                    out.append(t)
                return out
            diff = not prim.nondiff and op not in OPS_RECONSTRUCT
            cin, gin = inputs("cpu", diff), inputs("cuda", diff)
            want = _as_list(prim.fn(*cin, **attrs, **(
                {"device": "cpu"} if extra else {})))
            got = _as_list(prim.fn(*gin, **attrs, **extra))
            require(len(got) == len(want), "%s: %d outputs on the card, %d "
                    "on the CPU" % (op, len(got), len(want)))
            if op in OPS_RECONSTRUCT:
                e = _reconstruct(torch, op, got, cin[0].detach())
                if op in ("svd_op", "eigh_op"):    # the invariant values
                    e = max(e, _err(torch, got[1 if op == "svd_op" else 0],
                                    want[1 if op == "svd_op" else 0], op))
                if op == "eigvals_op":
                    key = lambda z: (round(z.real, 4), round(z.imag, 4))  # noqa: E731,E501
                    g = sorted(got[0].cpu().tolist(), key=key)
                    w = sorted(want[0].tolist(), key=key)
                    e = max(abs(x - y) for x, y in zip(g, w)) / max(
                        1.0, max(abs(y) for y in w))
                tol = OPS_TOL["reduction"]
            else:
                e = max(_err(torch, g, w, op) for g, w in zip(got, want))
                tol = OPS_TOL[kind]
            require(e <= tol, "%s on the card: error %.3g > %.0e of the "
                    "CPU result's largest |value|" % (op, e, tol))
            worst[family] = max(worst.get(family, 0.0), e)
            n_checked += 1
            fl = [i for i, w in enumerate(want) if w.is_floating_point()
                  and w.requires_grad]
            if not (diff and fl):
                continue
            rs = np.random.RandomState(1234)
            cts = [torch.from_numpy(np.asarray(rs.rand(*want[i].shape),
                                               np.float32)).to(want[i].dtype)
                   for i in fl]
            wi = [t for t in cin if t.requires_grad]
            gi = [t for t in gin if t.requires_grad]
            wg = torch.autograd.grad(
                sum((want[i] * c).sum() for i, c in zip(fl, cts)), wi,
                allow_unused=True)
            gg = torch.autograd.grad(
                sum((got[i] * c.cuda()).sum() for i, c in zip(fl, cts)), gi,
                allow_unused=True)
            for a, b in zip(gg, wg):
                if b is None:
                    continue
                e = _err(torch, a, b, op + " gradient")
                require(e <= OPS_TOL["reduction"], "%s gradient on the "
                        "card: error %.3g" % (op, e))
                worst[mod + "/gradients"] = max(
                    worst.get(mod + "/gradients", 0.0), e)
            n_grad += 1
    n_random = check_random_ops(torch)
    say("op surface on the card (phase 25 (a)): %d ops checked against the "
        "same ops on CPU tensors (%d with their gradients), %d random ops "
        "by their draws; largest error by family %s (tolerances %s of the "
        "largest |value|; integers, bools and indices exact)"
        % (n_checked, n_grad, n_random,
           {k: float("%.3g" % v) for k, v in sorted(worst.items())},
           OPS_TOL))
    return worst


def _moments(name, x, mean, var):
    x = x.double()
    n = x.numel()
    m, v = float(x.mean()), float(x.var())
    require(abs(m - mean) <= 5 * (var / n) ** 0.5, "%s: mean %.5g, want "
            "%.5g within 5 sigma" % (name, m, mean))
    require(abs(v - var) <= 5 * var * (8.0 / n) ** 0.5, "%s: variance %.5g,"
            " want %.5g" % (name, v, var))
    return m, v


def check_random_ops(torch):
    """The random ops on the card: shape, dtype and range, the same draws
    twice from one paddle.seed, the first two moments of OPS_DRAWS draws
    within 5 sigma."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import random_ops as R
    n = OPS_DRAWS
    cases = {
        "gaussian_random": (lambda: paddle.randn([n], device="cuda"),
                            torch.float32, (0.0, 1.0)),
        "uniform_random": (lambda: paddle.uniform([n], min=-2.0, max=3.0,
                                                  device="cuda"),
                           torch.float32, (0.5, 25 / 12)),
        "randint_op": (lambda: paddle.randint(-3, 7, [n], device="cuda"),
                       torch.int64, (1.5, 99 / 12)),
        "randperm_op": (lambda: paddle.randperm(1000, device="cuda"),
                        torch.int64, None),
        "bernoulli_op": (lambda: paddle.bernoulli(
            torch.full((n,), 0.3, device="cuda")), torch.float32,
            (0.3, 0.21)),
        "multinomial_op": (lambda: paddle.multinomial(
            torch.tensor([1.0, 2.0, 7.0], device="cuda"), n, True),
            torch.int64, (1.6, 0.44)),
        "poisson_op": (lambda: paddle.poisson(
            torch.full((n,), 4.0, device="cuda")), torch.float32,
            (4.0, 4.0)),
        "exponential_op": (lambda: R.exponential_(
            torch.empty(n, device="cuda"), 2.0), torch.float32,
            (0.5, 0.25)),
    }
    for name, (draw, dt, mom) in cases.items():
        paddle.seed(11)
        x = draw()
        paddle.seed(11)
        y = draw()
        require(x.is_cuda and x.dtype == dt, "%s: %s on %s" % (
            name, x.dtype, x.device))
        require(torch.equal(x, y), "%s: one seed gave other draws" % name)
        if mom is None:
            require(sorted(x.tolist()) == list(range(1000)),
                    "%s: not a permutation" % name)
            continue
        if name == "uniform_random":
            require(-2.0 <= float(x.min()) and float(x.max()) < 3.0,
                    "%s: out of range" % name)
        if name == "randint_op":
            require(int(x.min()) == -3 and int(x.max()) == 6,
                    "%s: range [%d, %d]" % (name, x.min(), x.max()))
        _moments(name, x, *mom)
    return len(cases)


def moe_flops(B, T, model):
    """(FLOPs of one training step counted from the shapes, of which the
    expert FFNs'): 6 x the parameters a token uses (every dense and gate
    parameter; the experts counted apart) x tokens, the attention scores
    (12 L d T a token), and for each MoE block at capacity C the expert
    FFNs (2 x 2 E C M H forward, x3 with the backward), the dispatch
    einsum (2 S E C M, x2: its backward needs only dX) and the combine
    einsum (2 S E C M, x3)."""
    from paddle_tpu_torch.incubate import MoELayer
    gpt = model.gpt
    S = B * T
    L, d = len(gpt.layers), gpt.hidden_size
    expert_params, experts, einsums = 0, 0, 0
    for blk in gpt.layers:
        m = blk.mlp
        if not isinstance(m, MoELayer):
            continue
        C = m.capacity(S)
        E, M, H = m.num_experts, m.d_model, m.d_hidden
        expert_params += sum(p.numel() for p in (m.w1, m.b1, m.w2, m.b2))
        experts += 3 * 2 * 2 * E * C * M * H
        einsums += (2 + 3) * 2 * S * E * C * M
    dense = sum(p.numel() for p in model.parameters()) - expert_params
    total = 6 * dense * S + 12 * L * d * T * S + experts + einsums
    return total, experts


def moe_routes(torch, model):
    """A forward hook on each MoE block that keeps its routing (the first
    and second choices, from the gate's float32 probabilities) and the
    gaps between the competing probabilities, for one forward."""
    from paddle_tpu_torch.incubate import MoELayer
    seen = []

    def hook(mod, inputs, out):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return
        with torch.no_grad():
            x = inputs[0].reshape(-1, mod.d_model).float()
            p = torch.softmax(x @ mod.gate_weight.float(), -1)
            top = torch.topk(p, 3, dim=-1)
            seen.append((top.indices[:, :2].cpu(),
                         (top.values[:, :2] - top.values[:, 1:3]).cpu()))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoELayer)]
    return seen, handles


def moe_model(**kw):
    from paddle_tpu_torch.models import gpt2_small
    return gpt2_small(seed=0, moe_every_n_layers=MOE_EVERY,
                      moe_num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                      moe_capacity_factor=MOE_CF, **kw)


def moe_train(torch, ck, card):
    """Phase 25 (b): GPT-2-small-MoE at B=16, T=512, O2 bf16, dropouts
    0.1, AdamW, the criterion plus MOE_AUX x moe_aux_loss(), through
    run_path (eager bodies, then the captured step: one build, replays,
    the launches a step), the captured step against its eager bodies over
    3 steps, the tokens over capacity and l_aux after a step, row 7 at
    this path's parameters."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    import contextlib
    prandom.seed(0)
    t0 = time.perf_counter()
    model = moe_model()
    model.train()
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion()
    gpt = model.gpt
    loss_fn = lambda o, l: crit(o, l) + MOE_AUX * gpt.moe_aux_loss()  # noqa
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    moes = [b.mlp for b in gpt.layers if isinstance(b.mlp, MoELayer)]
    S = TRAIN_B * TRAIN_T
    say("moe: gpt2-small-MoE %d parameters (%d tensors), %d of 12 blocks "
        "MoE (E=%d, top-%d, capacity factor %.2f: C=%d of S=%d tokens), "
        "built in %.1f s"
        % (n_params, n_tensors, len(moes), MOE_EXPERTS, MOE_TOP_K, MOE_CF,
           moes[0].capacity(S), S, time.perf_counter() - t0))
    loader = io.DataLoader(token_stream(io, gpt.vocab_size, TRAIN_T),
                           batch_size=TRAIN_B, prefetch_to_device=2)
    it = iter(loader)

    def batch():
        ids = next(it)
        return [ids[:, :-1]], [ids[:, 1:]]
    L = len(gpt.layers)
    want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "adamw": adamw_launches(model.parameters()),
            "dropout_keep": 2 * L + 1, "fused_dropout_ln_fwd": 0, "fused_dropout_residual_fwd": 0,
            "fused_dropout_ln_bwd": 0}
    flops, expert_flops = moe_flops(TRAIN_B, TRAIN_T, model)
    launches, paths, step_ms, _, _ = run_path(
        torch, ck, "moe", card, model, opt, loss_fn, batch,
        contextlib.nullcontext, S, flops, want)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    aux = float(gpt.moe_aux_loss())
    require(math.isfinite(aux) and aux > 0, "moe: l_aux after a captured "
            "step %r" % aux)
    over = [int(m.dropped) / (S * MOE_TOP_K) for m in moes]
    say("moe: %.2f TFLOP a step, %.1f %% of them in the expert FFNs, the "
        "rest the dense blocks, the attention and the [S, E, C] dispatch "
        "and combine einsums; MFU above against 989 TFLOP/s; l_aux after "
        "the captured steps %.6f (sum of %d blocks, read from their "
        "buffers); tokens over capacity (choices dropped / S x k) by MoE "
        "block %s; launches a step %s; graph pool and idle in the lines "
        "above (%s)"
        % (flops / 1e12, 100.0 * expert_flops / flops, aux, len(moes),
           ["%.4f" % x for x in over],
           {k: launches[k] / n_steps for k in want}, card))
    require(paths["flash_dropout"] > 0 and paths["xla_sdpa"] == 0,
            "moe: attention paths %s" % paths)
    fixed = [batch() for _ in range(3)]
    it.close()
    shapes = [tuple(p.shape) for p in model.parameters()]
    free_memory(torch)
    graph_against_eager_train(torch, ck, "moe", model, opt, loss_fn,
                              fixed, contextlib.nullcontext, DROPOUT)
    del model, opt
    free_memory(torch)
    return launches, shapes, {"step_ms": step_ms, "flops": flops,
                              "expert_share": expert_flops / flops,
                              "over": over, "l_aux": aux}


def moe_compare(torch, ck, flags, fault=False):
    """Phase 25 (c): the same configuration in float32 at B=4 and 4
    blocks (2 MoE), no dropout, kernels on against off through
    compare_runs (step 1's gradients within TRAIN_GRAD_TOL of each norm,
    losses within 1e-4); every token's experts the same in both runs' first
    forward, except where the competing probabilities lie within MOE_TIE
    (counted). With `fault`, the kernel run places second choices without
    the first choices' offset (count1): the comparison must refuse it."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPT_CONFIGS, GPTPretrainingCriterion
    B = MOE_COMPARE_B
    vocab = GPT_CONFIGS["gpt2-small"]["vocab_size"]
    data = [torch.from_numpy(token_stream_batch(np, vocab, B, TRAIN_T, s))
            .cuda() for s in range(3)]
    routes = []
    place = MoELayer._place

    def build():
        prandom.seed(0)
        model = moe_model(num_layers=MOE_COMPARE_LAYERS,
                          attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
        model.train()
        opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                              parameters=model.parameters())
        crit = GPTPretrainingCriterion()
        gpt = model.gpt
        step = make_train_step(
            model, lambda o, l: crit(o, l) + MOE_AUX * gpt.moe_aux_loss(),
            opt)
        seen, handles = moe_routes(torch, model)
        routes.append(seen)

        def run(i):
            out = step([data[i][:, :-1]], [data[i][:, 1:]])
            for h in handles:               # the first forward's routes
                h.remove()
            handles.clear()
            return out
        return model, opt, run
    if fault:
        def faulty(self, mask, offset, C):
            return place(self, mask, None, C)
        def build_faulty():
            MoELayer._place = faulty if flags.get_flags(
                ["use_flash_attention"])["use_flash_attention"] else place
            return build()
        try:
            compare_runs(torch, ck, flags, "moe fault", build_faulty,
                         ("use_flash_attention", "use_fused_optimizer"),
                         ("flash_fwd_train", "adamw"))
        except SystemExit as e:
            say("moe planted fault (second choices placed without the first "
                "choices' count): refused, %s" % str(e)[len(
                    "chip_smoke FAILED: "):][:160])
            return None
        finally:
            MoELayer._place = place
        require(False, "moe: the planted fault passed the comparison")
    compare_runs(torch, ck, flags, "moe", build,
                 ("use_flash_attention", "use_fused_optimizer"),
                 ("flash_fwd_train", "flash_bwd_dkv", "adamw"))
    (k_routes, p_routes) = routes
    flips, near, total = 0, 0, 0
    for (ki, kg), (pi, pg) in zip(k_routes, p_routes):
        diff = (ki != pi).any(-1)
        total += diff.numel()
        gap = torch.minimum(kg.min(-1).values, pg.min(-1).values)
        flips += int(diff.sum())
        near += int((diff & (gap <= MOE_TIE)).sum())
    require(flips == near, "moe: %d tokens routed to other experts with "
            "the kernels, %d of them at a near tie (within %g)"
            % (flips, near, MOE_TIE))
    say("moe routing, kernels vs plain (first forward, %d MoE blocks x %d "
        "tokens): %d tokens routed differently, all at near ties (within "
        "%g); the smallest gap between competing probabilities %.3g"
        % (len(k_routes), k_routes[0][0].shape[0], flips, MOE_TIE,
           min(float(g.min()) for _, g in p_routes)))
    return flips


def moe_main(torch, ck, flags, card, timer=None, gen=None):
    """Phase 25: (a) the op surface on the card, (b) GPT-2-small-MoE
    training, (c) its float32 comparison and the planted fault. Returns
    (b)'s launches and the phase's numbers."""
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    if WORD is None:
        WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    t0 = time.perf_counter()
    worst = check_op_sweep(torch)
    free_memory(torch)
    t1 = time.perf_counter()
    launches, shapes, entry = moe_train(torch, ck, card)
    t2 = time.perf_counter()
    timer = timer or Timer(torch)
    gen = gen or torch.Generator(device="cuda").manual_seed(0)
    adamw = time_adamw(torch, ck, timer, gen, shapes, card)
    free_memory(torch)
    t3 = time.perf_counter()
    flips = moe_compare(torch, ck, flags)
    free_memory(torch)
    moe_compare(torch, ck, flags, fault=True)
    free_memory(torch)
    say("moe phase 25: %.1f s ((a) %.1f, (b) %.1f, row 7 at its shapes "
        "%.1f, (c) %.1f)" % (time.perf_counter() - t0, t1 - t0, t2 - t1,
                             t3 - t2, time.perf_counter() - t3))
    entry.update(launches=launches, adamw=adamw, flips=flips, ops=worst)
    return entry



# ---------------------------------------------------------------------------
# 26. the rest of nn on the card, and the improved-DDPM CIFAR-10 UNet

# Nichol & Dhariwal 2021 ("Improved Denoising Diffusion Probabilistic
# Models"), the CIFAR-10 run of openai/improved-diffusion's README:
# --image_size 32 --num_channels 128 --num_res_blocks 3 --learn_sigma True
# --dropout 0.3 --diffusion_steps 4000 --noise_schedule cosine --lr 1e-4
# --batch_size 128, with script_util.py's defaults for 32x32:
# channel_mult (1, 2, 2, 2), 4 heads, attention at 16 and 8 (ds 2 and 4),
# use_scale_shift_norm, AdamW with weight_decay 0. The loss is L_simple
# (learn_sigma's variance output and L_vlb are left out: 3 output
# channels). Images come from the port's synthetic vision.datasets.Cifar10
# (the data files are not in the repository), scaled to [-1, 1]
UNET_CH, UNET_MULT, UNET_RES_BLOCKS = 128, (1, 2, 2, 2), 3
UNET_ATTN_DS, UNET_HEADS, UNET_DROPOUT = (2, 4), 4, 0.3
UNET_DIFFUSION_STEPS, UNET_LR, UNET_B, UNET_HW = 4000, 1e-4, 128, 32
UNET_PARAMS, UNET_TENSORS = 52542979, 446
# the images the batches are drawn from (the synthetic set's first ones)
UNET_POOL = 2048
# (c): the same architecture at reduced depth, in float32 without
# dropout, its zero-initialised convolutions drawn like the others so that
# step 1's gradients reach every parameter
UNET_SMALL = dict(channels=64, channel_mult=(1, 2), num_res_blocks=1,
                  attention_ds=(2,), num_heads=4, dropout=0.0,
                  zero_init=False)
UNET_COMPARE_B = 8
# (a): the surface on the card against its CPU result, TF32 off: within
# NN_TOL of the CPU result's largest |value| (elementwise ops 1e-5;
# reductions, convolutions, resampling and every gradient 1e-4);
# integers exact
NN_TOL = {"elementwise": 1e-5, "reduction": 1e-4}
# kernel-name patterns of the UNet step's profile groups, first match
UNET_PROFILE_GROUPS = (
    ("flash kernels (port)", ("flash_fwd_", "flash_bwd_")),
    ("dropout keep mask (port)", ("fdrln_bits_kernel",)),
    ("adamw (port)", ("adamw_kernel",)),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                              "implicit", "nchwToNhwc", "nhwcToNchw")),
    ("nearest upsampling", ("upsample",)),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass")),
    ("reductions (group norm statistics)", ("reduce_kernel",)),
    ("elementwise (group norm, SiLU, casts)", ("elementwise",
                                               "vectorized")))


def unet_model(channels=UNET_CH, channel_mult=UNET_MULT,
               num_res_blocks=UNET_RES_BLOCKS, attention_ds=UNET_ATTN_DS,
               num_heads=UNET_HEADS, dropout=UNET_DROPOUT, in_channels=3,
               out_channels=3, zero_init=True, seed=0, device="cuda"):
    """improved-diffusion's UNetModel (unet.py) from the port's public API
    (the JAX package has no such class; tests/test_torch_unet.py builds the
    same one on it): a sinusoidal timestep embedding through Linear(ch,
    4ch), SiLU, Linear(4ch, 4ch); ResBlocks (GroupNorm(32) in float32 and
    cast back, as GroupNorm32; SiLU; a 3x3 conv; the embedding's scale and
    shift after the second norm; SiLU; dropout; a 3x3 conv, zero at init
    with `zero_init`; a 1x1 skip conv where the widths differ);
    AttentionBlocks (GroupNorm; a 1x1 qkv conv; `num_heads` heads through
    F.scaled_dot_product_attention; a 1x1 projection, zero at init);
    downsampling by a 3x3 conv at stride 2; upsampling by
    nn.Upsample(scale_factor=2, mode="nearest") then a 3x3 conv.
    forward(x [B, 3, H, W], t [B] integer steps) -> [B, out, H, W].
    Weights drawn on the CPU from a generator seeded with `seed`, then
    moved to `device`."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    F = nn.functional
    gen = torch.Generator().manual_seed(int(seed))
    zero = (nn.ParamAttr(initializer=nn.initializer.Constant(0.0))
            if zero_init else None)

    def conv(cin, cout, k, stride=1, last=False, dims=2):
        cls = nn.Conv2D if dims == 2 else nn.Conv1D
        attr = zero if last else None
        return cls(cin, cout, k, stride=stride, padding=k // 2,
                   weight_attr=attr, bias_attr=attr, generator=gen)

    class Norm(nn.GroupNorm):
        def forward(self, x):
            return paddle.cast(super().forward(paddle.cast(x, "float32")),
                               x.dtype)

    class ResBlock(nn.Layer):
        def __init__(self, cin, cout, emb):
            super().__init__()
            self.in_norm = Norm(32, cin)
            self.in_conv = conv(cin, cout, 3)
            self.emb = nn.Linear(emb, 2 * cout, generator=gen)
            self.out_norm = Norm(32, cout)
            self.drop = nn.Dropout(dropout)
            self.out_conv = conv(cout, cout, 3, last=True)
            self.skip = (nn.Identity() if cin == cout
                         else conv(cin, cout, 1))

        def forward(self, x, emb):
            h = self.in_conv(F.silu(self.in_norm(x)))
            e = paddle.cast(self.emb(F.silu(emb)), h.dtype)
            scale, shift = paddle.chunk(e[:, :, None, None], 2, axis=1)
            h = self.out_norm(h) * (1 + scale) + shift
            h = self.out_conv(self.drop(F.silu(h)))
            return self.skip(x) + h

    class AttentionBlock(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = Norm(32, c)
            self.qkv = conv(c, 3 * c, 1, dims=1)
            self.proj = conv(c, c, 1, last=True, dims=1)

        def forward(self, x):
            B, C, H, W = x.shape
            T, heads = H * W, num_heads
            h = self.qkv(self.norm(paddle.reshape(x, [B, C, T])))
            # improved-diffusion's legacy split: channels [head][q|k|v][d];
            # the kernels take a unit head_dim stride, so the [B, T, 3C]
            # transpose is laid out anew
            h = paddle.reshape(paddle.transpose(h, [0, 2, 1]).contiguous(),
                               [B, T, heads, 3, C // heads])
            q, k, v = (paddle.transpose(h[:, :, :, i], [0, 2, 1, 3])
                       for i in range(3))
            a = F.scaled_dot_product_attention(q, k, v)
            a = paddle.transpose(paddle.reshape(
                paddle.transpose(a, [0, 2, 1, 3]), [B, T, C]), [0, 2, 1])
            return x + paddle.reshape(self.proj(a), [B, C, H, W])

    class Up(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.conv = conv(c, c, 3)

        def forward(self, x):
            return self.conv(self.up(x))

    class Step(nn.LayerList):
        """TimestepEmbedSequential: the embedding to the ResBlocks."""

        def forward(self, x, emb):
            for layer in self:
                x = layer(x, emb) if isinstance(layer, ResBlock) \
                    else layer(x)
            return x

    class UNet(nn.Layer):
        def __init__(self):
            super().__init__()
            emb = 4 * channels
            self.time_in = nn.Linear(channels, emb, generator=gen)
            self.time_out = nn.Linear(emb, emb, generator=gen)
            self.inputs = nn.LayerList([Step([conv(in_channels, channels,
                                                   3)])])
            chans, ch, ds = [channels], channels, 1
            for level, mult in enumerate(channel_mult):
                for _ in range(num_res_blocks):
                    layers = [ResBlock(ch, mult * channels, emb)]
                    ch = mult * channels
                    if ds in attention_ds:
                        layers.append(AttentionBlock(ch))
                    self.inputs.append(Step(layers))
                    chans.append(ch)
                if level != len(channel_mult) - 1:
                    self.inputs.append(Step([conv(ch, ch, 3, stride=2)]))
                    chans.append(ch)
                    ds *= 2
            self.middle = Step([ResBlock(ch, ch, emb), AttentionBlock(ch),
                                ResBlock(ch, ch, emb)])
            self.outputs = nn.LayerList()
            for level, mult in list(enumerate(channel_mult))[::-1]:
                for i in range(num_res_blocks + 1):
                    layers = [ResBlock(ch + chans.pop(), channels * mult,
                                       emb)]
                    ch = channels * mult
                    if ds in attention_ds:
                        layers.append(AttentionBlock(ch))
                    if level and i == num_res_blocks:
                        layers.append(Up(ch))
                        ds //= 2
                    self.outputs.append(Step(layers))
            self.out_norm = Norm(32, ch)
            self.out_conv = conv(channels, out_channels, 3, last=True)

        def forward(self, x, t):
            half = channels // 2
            freqs = paddle.exp(paddle.arange(0, half, dtype="float32",
                                             device=t.device)
                               * (-math.log(10000.0) / half))
            args = paddle.unsqueeze(paddle.cast(t, "float32"), 1) \
                * paddle.unsqueeze(freqs, 0)
            emb = paddle.concat([paddle.cos(args), paddle.sin(args)],
                                axis=-1)
            emb = self.time_out(F.silu(self.time_in(emb)))
            hs = []
            h = x
            for block in self.inputs:
                h = block(h, emb)
                hs.append(h)
            h = self.middle(h, emb)
            for block in self.outputs:
                h = block(paddle.concat([h, hs.pop()], axis=1), emb)
            return self.out_conv(F.silu(self.out_norm(h)))

    return UNet().to(device)


def unet_loss(F, out, eps):
    """L_simple: the mean squared error between the predicted and the
    drawn noise, in either package's functional namespace `F`."""
    return F.mse_loss(out, eps)


def cosine_alphas_cumprod(steps=UNET_DIFFUSION_STEPS, s=0.008):
    """improved DDPM's cosine schedule (gaussian_diffusion.py
    betas_for_alpha_bar): beta_t = min(1 - abar(t + 1) / abar(t), 0.999),
    abar(t) = cos((t / T + s) / (1 + s) * pi / 2)^2, and the product of
    1 - beta, in float64."""
    abar = lambda t: math.cos((t / steps + s) / (1 + s) * math.pi / 2) ** 2  # noqa: E731,E501
    betas = np.array([min(1 - abar(i + 1) / abar(i), 0.999)
                      for i in range(steps)])
    return np.cumprod(1.0 - betas)


def unet_flops(torch, model, B, hw=UNET_HW):
    """FLOPs of one training step counted from the shapes: one forward of
    a [1, 3, hw, hw] image with hooks on every convolution and Linear
    (output elements x input channels / groups x kernel taps
    multiply-adds) and every attention block (2 T^2 C for QK^T and PV),
    2 FLOPs a multiply-add, x3 with the backward, x B."""
    from paddle_tpu_torch import nn
    macs = [0]

    def layer_hook(mod, inputs, out):
        w = mod.weight
        macs[0] += out.numel() * int(np.prod(w.shape[1:])) \
            if w.ndim > 2 else out.numel() * w.shape[0]

    def attn_hook(mod, inputs, out):
        _, C, H, W = inputs[0].shape
        macs[0] += 2 * (H * W) ** 2 * C
    hooks = []
    for m in model.modules():
        if isinstance(m, (nn.Conv1D, nn.Conv2D, nn.Linear)):
            hooks.append(m.register_forward_hook(layer_hook))
        elif type(m).__name__ == "AttentionBlock":
            hooks.append(m.register_forward_hook(attn_hook))
    dev = next(model.parameters()).device
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, hw, hw), device=dev),
                  torch.zeros((1,), dtype=torch.int64, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return 2 * 3 * macs[0] * B, macs[0]


def unet_batches(torch, n_pool=UNET_POOL, B=UNET_B, device="cuda"):
    """A batch maker for the training step: each call draws B images of
    the pool, t ~ U[0, 4000) and eps ~ N(0, 1) from the port's device
    generator and forms x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps
    outside the step: ([x_t, t], [eps])."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.datasets import Cifar10
    imgs = Cifar10(mode="train").images[:n_pool]
    x0 = torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2).float() \
        / 127.5 - 1.0
    abar = torch.from_numpy(cosine_alphas_cumprod()).float().to(device)

    def batch():
        idx = paddle.randint(0, n_pool, [B], device=device)
        t = paddle.randint(0, UNET_DIFFUSION_STEPS, [B], device=device)
        eps = paddle.randn([B, 3, UNET_HW, UNET_HW], device=device)
        a = abar[t][:, None, None, None]
        xt = a.sqrt() * x0[idx] + (1 - a).sqrt() * eps
        return [xt, t], [eps]
    return batch


def _nn_cases(torch, F, nn_mod):
    """(a)'s cases: name -> (fn(*tensors), numpy inputs, differentiable
    indices, kind). Each runs on CPU tensors and on CUDA tensors."""
    rs = np.random.RandomState(26)
    u = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    i64 = lambda hi, *s: rs.randint(0, hi, s).astype(np.int64)  # noqa
    lens = np.array([3, 1, 4, 2], np.int64)
    offs = np.array([[[0, 2, 3, 5, 5, 7]]], np.int64)
    cols = np.array([[[0, 3, 1, 2, 4, 0, 4]]], np.int64)
    ctc_labels = np.array([[1, 2, 2, 3], [4, 1, 0, 0], [3, 0, 0, 0]],
                          np.int64)
    e, r = "elementwise", "reduction"
    cases = {
        "conv2d_transpose": (lambda x, w, b: F.conv2d_transpose(
            x, w, b, stride=2, padding=1, output_padding=1, groups=2),
            [u(2, 4, 5, 5), u(4, 3, 3, 3), u(6)], [0, 1, 2], r),
        "conv1d_transpose": (lambda x, w: F.conv1d_transpose(
            x, w, stride=3, padding=[1, 2], dilation=2),
            [u(2, 3, 7), u(3, 2, 3)], [0, 1], r),
        "conv3d_transpose": (lambda x, w: F.conv3d_transpose(x, w, stride=2),
                             [u(1, 2, 3, 3, 2), u(2, 3, 2, 2, 2)], [0, 1],
                             r),
        "group_norm": (lambda x, w, b: F.group_norm(x, 4, 1e-5, w, b),
                       [u(2, 8, 5, 6), u(8), u(8)], [0, 1, 2], r),
        "instance_norm": (lambda x, w, b: F.instance_norm(
            x, weight=w, bias=b), [u(2, 4, 5, 6), u(4), u(4)], [0, 1, 2], r),
        "local_response_norm": (lambda x: F.local_response_norm(x, 3),
                                [u(2, 6, 3, 4)], [0], r),
        "normalize": (lambda x: F.normalize(x, p=3, axis=-1), [u(4, 5)],
                      [0], r),
        "max_pool1d": (lambda x: F.max_pool1d(x, 3, 2, 1), [u(2, 3, 11)],
                       [0], e),
        "avg_pool3d": (lambda x: F.avg_pool3d(x, 3, 2, 1, ceil_mode=True),
                       [u(1, 2, 5, 6, 5)], [0], r),
        "avg_pool2d_divisor": (lambda x: F.avg_pool2d(
            x, 3, 2, 1, divisor_override=4), [u(2, 3, 7, 7)], [0], r),
        "adaptive_max_pool2d": (lambda x: F.adaptive_max_pool2d(x, (3, 2)),
                                [u(2, 3, 7, 6)], [0], e),
        "adaptive_avg_pool3d": (lambda x: F.adaptive_avg_pool3d(x, 2),
                                [u(1, 2, 5, 4, 3)], [0], r),
        "max_pool2d_mask": (lambda x: F.max_pool2d(x, 2, return_mask=True),
                            [u(2, 3, 6, 8)], [0], e),
        "max_unpool2d": (lambda x, i: F.max_unpool2d(x, i, 2),
                         [u(2, 3, 3, 4), np.array(
                             [[[[0, 3, 5, 6], [17, 18, 20, 23],
                                [32, 34, 37, 39]]] * 3] * 2, np.int64)],
                         [0], e),
        "interpolate_nearest_up": (lambda x: F.interpolate(
            x, scale_factor=2), [u(2, 3, 5, 6)], [0], e),
        "interpolate_nearest_frac": (lambda x: F.interpolate(
            x, size=[7, 4]), [u(2, 3, 5, 6)], [0], e),
        "interpolate_bilinear_down": (lambda x: F.interpolate(
            x, size=[3, 4], mode="bilinear"), [u(2, 3, 7, 9)], [0], r),
        "interpolate_bicubic_up": (lambda x: F.interpolate(
            x, scale_factor=1.5, mode="bicubic"), [u(2, 3, 5, 6)], [0], r),
        "interpolate_align_corners": (lambda x: F.interpolate(
            x, size=[9, 11], mode="bilinear", align_corners=True),
            [u(2, 3, 5, 6)], [0], r),
        "interpolate_trilinear": (lambda x: F.interpolate(
            x, size=[3, 5, 4], mode="trilinear", data_format="NCDHW"),
            [u(1, 2, 4, 3, 6)], [0], r),
        "grid_sample": (lambda x, g: F.grid_sample(x, g), [
            u(2, 3, 5, 6), np.clip(u(2, 4, 7, 2) * 0.6, -1, 1)], [0, 1], r),
        "affine_grid": (lambda t: F.affine_grid(t, [2, 3, 4, 5]),
                        [u(2, 2, 3)], [0], r),
        "pixel_shuffle": (lambda x: F.pixel_shuffle(x, 2), [u(2, 8, 3, 4)],
                          [0], e),
        "pixel_unshuffle": (lambda x: F.pixel_unshuffle(x, 2),
                            [u(2, 3, 4, 6)], [0], e),
        "channel_shuffle": (lambda x: F.channel_shuffle(x, 3),
                            [u(2, 6, 3, 2)], [0], e),
        "unfold": (lambda x: F.unfold(x, [2, 3], strides=2, paddings=1),
                   [u(2, 2, 7, 8)], [0], e),
        "pad_reflect": (lambda x: F.pad(x, [1, 2, 2, 1], mode="reflect"),
                        [u(2, 3, 4, 5)], [0], e),
        "pad_circular": (lambda x: F.pad(x, [1, 2, 2, 1], mode="circular"),
                         [u(2, 3, 4, 5)], [0], e),
        "zeropad2d": (lambda x: F.zeropad2d(x, [1, 2, 0, 3]),
                      [u(2, 3, 4, 5)], [0], e),
        "temporal_shift": (lambda x: F.temporal_shift(x, 3),
                           [u(6, 8, 2, 3)], [0], e),
        "bilinear": (lambda a, b, w, c: F.bilinear(a, b, w, c),
                     [u(3, 4), u(3, 2), u(5, 4, 2), u(5)], [0, 1, 2, 3], r),
        "hsigmoid_loss": (lambda x, y, w, b: F.hsigmoid_loss(x, y, 7, w, b),
                          [u(5, 4), np.array([0, 3, 5, 6, 2]), u(6, 4),
                           u(6, 1)], [0, 2, 3], r),
        "ctc_loss": (lambda lp, y, n, m: F.ctc_loss(lp, y, n, m),
                     [u(10, 3, 5), ctc_labels, np.array([10, 7, 4]),
                      np.array([4, 2, 1])], [0], r),
        "margin_cross_entropy": (lambda x, y: F.margin_cross_entropy(
            x, y, scale=16.0), [np.clip(u(5, 7) * 0.4, -0.9, 0.9),
                                i64(7, 5)], [0], r),
        "sparse_attention": (lambda q, k, v, o, c: F.sparse_attention(
            q, k, v, o, c), [u(1, 1, 5, 4), u(1, 1, 5, 4), u(1, 1, 5, 4),
                             offs, cols], [0, 1, 2], r),
        "masked_attention": (lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m), [u(2, 2, 5, 8), u(2, 2, 5, 8),
                                    u(2, 2, 5, 8),
                                    np.where(rs.rand(2, 1, 5, 5) > 0.3, 0.0,
                                             -1e9).astype(np.float32)],
            [0, 1, 2], r),
        "log_softmax": (lambda x: F.log_softmax(x, axis=1), [u(4, 6)], [0],
                        r),
        "cosine_pairwise": (lambda a, b: nn_mod.PairwiseDistance(p=3.0)(
            a, b) + F.cosine_similarity(a, b, axis=1), [u(4, 6), u(4, 6)],
            [0, 1], r),
        "diag_embed": (lambda x: F.diag_embed(x, 1), [u(2, 3)], [0], e),
        "sequence_pool": (lambda x, n: F.sequence_pool(x, "sqrt", n),
                          [u(4, 5, 3), lens], [0], r),
        "sequence_softmax": (lambda x, n: F.sequence_softmax(x, n),
                             [u(4, 5), lens], [0], r),
        "sequence_reverse": (lambda x, n: F.sequence_reverse(x, n),
                             [u(4, 5, 2), lens], [0], e),
        "sequence_conv": (lambda x, w, n: F.sequence_conv(x, w, n, 3),
                          [u(4, 5, 3), u(9, 2), lens], [0, 1], r),
        "sequence_unpad": (lambda x, n: F.sequence_unpad(x, n),
                           [u(4, 5, 2), lens], [], e),
        "sequence_pad": (lambda x, n: F.sequence_pad(x, torch.tensor(
            0.5, device=x.device), lengths=n), [u(10, 2), lens], [], e),
        "ctc_greedy_decoder": (lambda x: F.ctc_greedy_decoder(x, 0),
                               [u(3, 8, 5)], [], e),
        "gather_tree": (lambda a, b: F.gather_tree(a, b), [
            i64(9, 5, 2, 3), i64(3, 5, 2, 3)], [], e),
        "edit_distance": (lambda a, b: F.edit_distance(a, b), [
            i64(5, 4, 7), i64(5, 4, 6) + 1], [], e),
    }
    return cases


def check_nn_surface(torch, ck):
    """Phase 26 (a): every op, layer and function of the slice on CUDA
    tensors against the same call on CPU tensors, forward and the input
    gradients under one cotangent, TF32 off: within NN_TOL of the CPU
    result's largest |value|, integers exact. The layers with parameters
    are held the same way through their weights' gradients; the dropouts
    by their masks' structure. Returns {kind: largest error}."""
    from paddle_tpu_torch import nn
    F = nn.functional
    worst = {}
    n = 0
    for name, (fn, arrays, diff, kind) in sorted(_nn_cases(
            torch, F, nn).items()):
        outs = {}
        for dev in ("cpu", "cuda"):
            ins = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
            for i in diff:
                ins[i].requires_grad_(True)
            got = _as_list(fn(*ins))
            grads = []
            fl = [o for o in got if o.is_floating_point() and o.requires_grad]
            if fl:
                rs = np.random.RandomState(1234)
                loss = sum((o * torch.from_numpy(np.asarray(
                    rs.rand(*o.shape), np.float32)).to(dev)).sum()
                    for o in fl)
                grads = torch.autograd.grad(loss, [ins[i] for i in diff])
            outs[dev] = (got, grads)
        (cg, cgr), (gg, ggr) = outs["cpu"], outs["cuda"]
        require(len(cg) == len(gg), "%s: outputs differ in number" % name)
        e = max(_err(torch, g, c, name) for g, c in zip(gg, cg))
        require(e <= NN_TOL[kind], "%s on the card: error %.3g > %.0e of "
                "the CPU result's largest |value|" % (name, e, NN_TOL[kind]))
        worst[kind] = max(worst.get(kind, 0.0), e)
        for g, c in zip(ggr, cgr):
            e = _err(torch, g, c, name + " gradient")
            require(e <= NN_TOL["reduction"], "%s gradient on the card: "
                    "error %.3g" % (name, e))
            worst["gradients"] = max(worst.get("gradients", 0.0), e)
        n += 1
    n_layers = check_nn_layers(torch, nn, worst)
    check_nn_dropouts(torch, ck, nn)
    say("nn surface on the card (phase 26 (a)): %d functions and %d layers "
        "against the same calls on CPU tensors, forward and gradients, TF32 "
        "off; largest error by kind %s (tolerances %s of the largest "
        "|value|; integers exact); dropout2d/3d, Dropout(axis), "
        "AlphaDropout and gumbel_softmax by their draws"
        % (n, n_layers, {k: float("%.3g" % v) for k, v in
                         sorted(worst.items())}, NN_TOL))
    return worst


def check_nn_layers(torch, nn, worst):
    """The layers that hold parameters or buffers, built once on the CPU,
    copied to the card: outputs, input and parameter gradients."""
    import copy
    gen = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(5)
    layers = [
        (nn.Conv2DTranspose(4, 6, 3, stride=2, groups=2, generator=gen),
         [(2, 4, 4, 5)]),
        (nn.GroupNorm(2, 6, generator=gen), [(2, 6, 3, 4)]),
        (nn.InstanceNorm3D(3, generator=gen), [(1, 3, 2, 3, 4)]),
        (nn.Bilinear(4, 3, 5, generator=gen), [(6, 4), (6, 3)]),
        (nn.SyncBatchNorm(4), [(3, 4, 2, 2)]),
        (nn.SpectralNorm((4, 3, 2), dim=1, generator=gen), [(4, 3, 2)]),
        (nn.Upsample(scale_factor=2), [(2, 3, 4, 5)]),
        (nn.UpsamplingBilinear2D(size=[7, 3]), [(2, 3, 4, 5)]),
    ]
    for layer, shapes in layers:
        xs = [rs.randn(*s).astype(np.float32) for s in shapes]
        res = {}
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(layer).to(dev)
            ins = [torch.from_numpy(x).to(dev).requires_grad_(True)
                   for x in xs]
            out = m(*ins)
            out.sum().backward()
            res[dev] = ([out] + [t.grad for t in ins]
                        + [p.grad for p in m.parameters() if p.requires_grad]
                        + [b for b in m.buffers()]
                        + [p for p in m.parameters() if not p.requires_grad])
        name = type(layer).__name__
        for g, c in zip(res["cuda"], res["cpu"]):
            e = _err(torch, g, c, name)
            require(e <= NN_TOL["reduction"], "%s on the card: error %.3g"
                    % (name, e))
            worst["layers"] = max(worst.get("layers", 0.0), e)
    return len(layers)


def check_nn_dropouts(torch, ck, nn):
    """The random layers on the card: dropout2d's mask constant over the
    spatial axes and through row K (the keep kernel's launches counted),
    Dropout(axis) shared along the other axes, AlphaDropout's two values
    a kept or dropped element can take, gumbel_softmax's one-hot rows."""
    F = nn.functional
    x = torch.ones((8, 16, 5, 7), device="cuda")
    ck.launch_counts(reset=True)
    out = F.dropout2d(x, 0.5)
    require(ck.launch_counts()["dropout_keep"] == 1, "dropout2d: the keep "
            "kernel did not launch")
    kept = out != 0
    require(bool((kept.all((2, 3)) | ~kept.any((2, 3))).all())
            and 0 < int(kept.all((2, 3)).sum()) < 128
            and bool((out[kept] == 2.0).all()),
            "dropout2d on the card: the mask is not one a channel")
    y = nn.Dropout(0.5, axis=1)(torch.ones((6, 5, 4), device="cuda"))
    require(bool((y == y[:1, :, :1]).all()), "Dropout(axis=1) on the card")
    a = F.alpha_dropout(torch.zeros((1000,), device="cuda"), 0.3)
    require(len(torch.unique(a)) == 2, "alpha_dropout on the card: %d "
            "values" % len(torch.unique(a)))
    g = F.gumbel_softmax(torch.randn((64, 7), device="cuda"), hard=True)
    require(bool((g.sum(-1) == 1).all()) and bool(((g == 0) | (g == 1))
                                                 .all()),
            "gumbel_softmax(hard) on the card: not one-hot")


def check_resize_capture(torch, ck):
    """Phase 26 (a): a step that resamples through weights and taps built
    on the card (bilinear with align_corners, an affine grid, bilinear
    down, bicubic up, trilinear), captured by make_train_step: bit-equal
    to its eager bodies over 2 steps from one state. Sums with atomics,
    in no fixed order, are kept out of the gradients: the index gathers
    (align_corners' taps, grid_sample's) see only the input, which
    carries none, and cuDNN runs its deterministic algorithms (its
    default weight gradient sums with atomics; phase 19 (a) does the
    same)."""
    import contextlib
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.framework import random as prandom
    F = nn.functional
    prandom.seed(0)

    class Resampler(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.theta = self.create_parameter([1, 2, 3])

        def forward(self, x):
            n = x.shape[0]
            x = F.interpolate(x, size=[9, 11], mode="bilinear",
                              align_corners=True)
            grid = F.affine_grid(self.theta.expand(n, 2, 3), [n, 3, 8, 10])
            h = self.conv(F.grid_sample(x, grid))
            h = F.interpolate(h, size=[5, 7], mode="bilinear")
            h = F.interpolate(h, scale_factor=1.5, mode="bicubic")
            return F.interpolate(h.unsqueeze(2), size=[2, 6, 8],
                                 mode="trilinear",
                                 data_format="NCDHW").mean(2)
    model = Resampler().to("cuda")
    opt = optimizer.AdamW(learning_rate=1e-2, weight_decay=0.0,
                          parameters=model.parameters())
    rs = np.random.RandomState(5)
    batches = [([torch.from_numpy(rs.randn(4, 3, 12, 14).astype(
        np.float32)).cuda()], [torch.from_numpy(rs.randn(4, 4, 6, 8).astype(
            np.float32)).cuda()]) for _ in range(2)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graph_against_eager_train(torch, ck, "resampling", model, opt,
                                  lambda o, y: F.mse_loss(o, y), batches,
                                  contextlib.nullcontext, 0.0)
    finally:
        torch.backends.cudnn.deterministic = det


def static_repairs(torch, card):
    """Phase 26 (a), the static recording repaired: each call that raised
    in the port records under static.program_guard and runs through
    static.Executor on the card to the eager result of the same call on
    the same card (1e-5 of the largest |value|)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import incubate, nn, static
    from paddle_tpu_torch.framework import flags
    F = nn.functional
    rs = np.random.RandomState(9)
    x = rs.randn(6, 8).astype(np.float32)
    y = rs.randint(0, 8, (6,)).astype(np.int64)
    w = (rs.rand(8) + 0.5).astype(np.float32)
    m = np.where(rs.rand(2, 1, 6, 6) > 0.3, 0.0, -1e9).astype(np.float32)
    q = rs.randn(2, 2, 6, 8).astype(np.float32)
    torch.manual_seed(0)
    mha = nn.MultiHeadAttention(8, 2).to("cuda")
    moe = incubate.MoELayer(8, 16, 4, generator=torch.Generator()
                            .manual_seed(0)).to("cuda")
    calls = {
        "log_softmax": (lambda a: F.log_softmax(a, axis=1), [x]),
        "softmax_dtype": (lambda a: F.softmax(a, dtype="float64"), [x]),
        "cross_entropy_weight": (lambda a, b, c: F.cross_entropy(
            a, b, weight=c), [x, y, w]),
        "cross_entropy_ignore": (lambda a, b: F.cross_entropy(
            a, b, ignore_index=1), [x, y]),
        "l1_loss": (lambda a: F.l1_loss(a, a * 0.5), [x]),
        "sdpa_masked": (lambda a, b: F.scaled_dot_product_attention(
            a, a, a, attn_mask=b), [q, m]),
        "mha_masked": (lambda a, b: mha(a, a, a, attn_mask=b),
                       [q[:, 0], m]),
        "batch_norm_no_stats": (lambda a: F.batch_norm(
            a, None, None, training=True), [x]),
        "fused_ln": (lambda a: incubate.nn.functional
                     .fused_bias_dropout_residual_layer_norm(
                         a, a * 2.0, dropout_rate=0.0), [x]),
        "moe": (lambda a: moe(a), [x.reshape(2, 3, 8)]),
    }
    saved = flags.get_flags(["use_fused_dropout_ln"])
    try:
        for name, (fn, arrays) in calls.items():
            flags.set_flags({"use_fused_dropout_ln": name == "fused_ln"})
            want = fn(*[torch.from_numpy(a).cuda() for a in arrays])
            paddle.enable_static()
            static.reset_default_programs()
            try:
                main, start = static.Program(), static.Program()
                with static.program_guard(main, start):
                    vs = [static.data("in%d" % i, list(a.shape),
                                      str(a.dtype)) for i, a in
                          enumerate(arrays)]
                    out = fn(*vs)
                exe = static.Executor("gpu:0")
                (got,) = exe.run(main, feed={"in%d" % i: a for i, a in
                                             enumerate(arrays)},
                                 fetch_list=[out])
            finally:
                paddle.disable_static()
                static.reset_default_programs()
            e = _err(torch, torch.as_tensor(np.asarray(got)),
                     want.detach().cpu(), name)
            require(e <= 1e-5, "static %s on the card: %.3g from the eager "
                    "result" % (name, e))
    finally:
        flags.set_flags(saved)
    say("static recording on the card (phase 26 (a)): %d calls that raised "
        "before this slice (log_softmax, softmax(dtype), cross_entropy with "
        "a weight and with ignore_index, l1_loss, masked sdpa and "
        "MultiHeadAttention, batch_norm without statistics, the fused "
        "dropout-LN tail, MoELayer) recorded and run through "
        "static.Executor to their eager results (%s)" % (len(calls), card))


def unet_train(torch, ck, card):
    """Phase 26 (b): the improved-DDPM CIFAR-10 UNet at full width, B=128,
    O1 bf16 under amp.auto_cast, dropout 0.3, AdamW(1e-4, weight_decay 0),
    L_simple, through run_path (eager bodies, then the captured step: one
    build, replays, the launches a step: 15 of rows 1t, 2 and 3 (7
    attention blocks at 16x16, 7 at 8x8, 1 at 4x4), one of row 7 a
    parameter, 30 of row K (one a ResBlock)); the captured step bit-equal
    to its eager bodies over 3 steps at dropout 0.3."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    import paddle_tpu_torch.nn.functional as F
    prandom.seed(0)
    t0 = time.perf_counter()
    model = unet_model()
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    require(n_params == UNET_PARAMS and n_tensors == UNET_TENSORS,
            "unet: %d parameters in %d tensors, want %d in %d"
            % (n_params, n_tensors, UNET_PARAMS, UNET_TENSORS))
    flops, macs = unet_flops(torch, model, UNET_B)
    opt = optimizer.AdamW(learning_rate=UNET_LR, weight_decay=0.0,
                          parameters=model.parameters())
    say("unet: improved-DDPM CIFAR-10 UNet, %d parameters in %d tensors, "
        "%.3f GMAC an image's forward, %.3f TFLOP a step at B=%d, built in "
        "%.1f s" % (n_params, n_tensors, macs / 1e9, flops / 1e12, UNET_B,
                    time.perf_counter() - t0))
    batch = unet_batches(torch)
    loss_fn = lambda out, eps: unet_loss(F, out, eps)  # noqa: E731
    ctx = lambda: amp.auto_cast(level="O1", dtype="bfloat16")  # noqa: E731
    n_attn = sum(1 for m in model.modules()
                 if type(m).__name__ == "AttentionBlock")
    n_res = sum(1 for m in model.modules() if type(m).__name__ == "ResBlock")
    want = {"flash_fwd_train": n_attn, "flash_bwd_dq": n_attn,
            "flash_bwd_dkv": n_attn,
            "adamw": adamw_launches(model.parameters()),
            "dropout_keep": n_res, "fused_dropout_ln_fwd": 0,
            "fused_dropout_residual_fwd": 0, "fused_dropout_ln_bwd": 0}
    launches, paths, step_ms, _, _ = run_path(
        torch, ck, "unet", card, model, opt, loss_fn, batch, ctx, UNET_B,
        flops, want, groups=UNET_PROFILE_GROUPS)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    say("unet: %.1f images/s (B=%d, %.2f ms a captured step), MFU %.4f of "
        "989 TFLOP/s bf16 from %.3f TFLOP a step; %d attention blocks "
        "(flash, 4 heads of 64), %d ResBlocks (dropout %.1f), launches a "
        "step %s (%s)"
        % (UNET_B / (step_ms / 1e3), UNET_B, step_ms,
           flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"], flops / 1e12,
           n_attn, n_res, UNET_DROPOUT,
           {k: launches[k] / n_steps for k in want}, card))
    require(paths["flash"] > 0 and paths["xla_sdpa"] == 0,
            "unet: attention paths %s" % paths)
    fixed = [batch() for _ in range(3)]
    shapes = [tuple(p.shape) for p in model.parameters()]
    free_memory(torch)
    graph_against_eager_train(torch, ck, "unet", model, opt, loss_fn,
                              fixed, ctx, UNET_DROPOUT)
    del model, opt, fixed
    free_memory(torch)
    return launches, shapes, {"step_ms": step_ms, "flops": flops,
                              "images_per_s": UNET_B / (step_ms / 1e3)}


def group_norm_channels_only(x, weight, bias, num_groups, epsilon=1e-5,
                             channel_last=False):
    """(c)'s planted fault: a group norm whose variance is taken over the
    group's channels alone (the mean over the channels and the spatial
    axes, as it should be)."""
    n, c = x.shape[:2]
    xr = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    mean = xr.mean(dim=tuple(range(2, xr.ndim)), keepdim=True)
    var = (xr - mean).square().mean(dim=2, keepdim=True)
    y = ((xr - mean) / (var + epsilon).sqrt()).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * weight.reshape(shape) + bias.reshape(shape)


def unet_compare(torch, ck, flags, fault=False):
    """Phase 26 (c): the UNet at reduced depth (UNET_SMALL: 64 channels,
    channel_mult (1, 2), one res block, attention at 16x16 with 4 heads of
    32) in float32, no dropout, TF32 off, B=UNET_COMPARE_B: the kernels on
    against off through compare_runs (step 1's gradients within
    TRAIN_GRAD_TOL of each norm, losses within 1e-4, parameters after 3
    AdamW steps within TRAIN_PARAM_TOL). With `fault`, the kernel run's
    group norms take their variance over the channels only: the
    comparison must refuse it."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.ops import nn_ops
    import paddle_tpu_torch.nn.functional as F
    B = UNET_COMPARE_B
    rs = np.random.RandomState(3)
    data = [[torch.from_numpy(rs.randn(B, 3, UNET_HW, UNET_HW).astype(
        np.float32)).cuda() for _ in range(2)]
        + [torch.from_numpy(rs.randint(0, UNET_DIFFUSION_STEPS, (B,)))
           .cuda()] for _ in range(3)]
    sound = nn_ops.group_norm

    def build():
        prandom.seed(0)
        model = unet_model(**UNET_SMALL)
        model.train()
        opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.0,
                              parameters=model.parameters())
        step = make_train_step(model, lambda o, e: unet_loss(F, o, e), opt)
        return model, opt, lambda i: step([data[i][0], data[i][2]],
                                          [data[i][1]])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if fault:
            def build_faulty():
                on = flags.get_flags(["use_flash_attention"])[
                    "use_flash_attention"]
                nn_ops.group_norm = group_norm_channels_only if on else sound
                return build()
            try:
                compare_runs(torch, ck, flags, "unet fault", build_faulty,
                             ("use_flash_attention", "use_fused_optimizer"),
                             ("flash_fwd_train", "adamw"))
            except SystemExit as e:
                say("unet planted fault (group norm variance over the "
                    "channels only): refused, %s"
                    % str(e)[len("chip_smoke FAILED: "):][:160])
                return
            finally:
                nn_ops.group_norm = sound
            require(False, "unet: the planted fault passed the comparison")
        compare_runs(torch, ck, flags, "unet", build,
                     ("use_flash_attention", "use_fused_optimizer"),
                     ("flash_fwd_train", "flash_bwd_dkv", "adamw"))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def unet_kernel_times(torch, ck, F, timer, gen, card):
    """Rows 1t, 2 and 3 at the UNet's three attention shapes (B=128, 4
    heads of 64, bf16, not causal, p 0, T = 256, 64, 16), each beside its
    bound, its plain version's and torch sdpa's time; row K at the first
    ResBlocks' dropout (128 x 128 x 32 x 32, p 0.3)."""
    out = {}
    for T in (256, 64, 16):
        out[T] = flash_train_times(torch, ck, F, timer, gen, UNET_B,
                                   UNET_HEADS, UNET_CH * 2 // UNET_HEADS, T,
                                   T, 0.0, "unet (b)")
    keep = time_dropout_keep(torch, ck, timer, (UNET_B, UNET_CH, UNET_HW,
                                                UNET_HW), p=UNET_DROPOUT)
    say("unet kernel times above at the model's shapes (%s)" % card)
    return out, keep


def unet_main(torch, ck, F, flags, card, timer=None, gen=None):
    """Phase 26: (a) the slice's surface and the repaired static recording
    on the card, (b) the full-width UNet's training, its kernels' times at
    its shapes and row 7 at its parameters, (c) the reduced UNet's float32
    kernels-against-plain comparison and the planted fault. Returns (b)'s
    launches and the phase's numbers."""
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    if WORD is None:
        WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    t0 = time.perf_counter()
    check_dropout_keep(torch, ck, unet_keep_cases())
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        worst = check_nn_surface(torch, ck)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    check_resize_capture(torch, ck)
    static_repairs(torch, card)
    free_memory(torch)
    t1 = time.perf_counter()
    launches, shapes, entry = unet_train(torch, ck, card)
    t2 = time.perf_counter()
    timer = timer or Timer(torch)
    gen = gen or torch.Generator(device="cuda").manual_seed(0)
    flash, keep = unet_kernel_times(torch, ck, F, timer, gen, card)
    adamw = time_adamw(torch, ck, timer, gen, shapes, card,
                       dt_name="float32")
    free_memory(torch)
    t3 = time.perf_counter()
    unet_compare(torch, ck, flags)
    free_memory(torch)
    unet_compare(torch, ck, flags, fault=True)
    free_memory(torch)
    say("unet phase 26: %.1f s ((a) %.1f, (b) %.1f, kernel times %.1f, (c) "
        "%.1f)" % (time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2,
                   time.perf_counter() - t3))
    entry.update(launches=launches, flash=flash, keep=keep, adamw=adamw,
                 surface=worst)
    return entry


# ---------------------------------------------------------------------------
# 27. row-sparse gradients, the legacy op surface and DLRM

# Naumov et al. 2019 ("Deep Learning Recommendation Model for
# Personalization and Recommendation Systems"), facebookresearch/dlrm's
# bench/dlrm_s_criteo_kaggle.sh: --arch-sparse-feature-size=16
# --arch-mlp-bot="13-512-256-64-16" --arch-mlp-top="512-256-1"
# --loss-function=bce --learning-rate=0.1 --mini-batch-size=128, the dot
# interaction without self-pairs; the 26 tables at the Criteo Kaggle
# (Display Advertising Challenge) row counts. The data is not in the
# repository: batches are synthetic, of the same shapes (`dlrm_batches`)
DLRM_KAGGLE_ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                    93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10,
                    5652, 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
DLRM_KAGGLE = dict(table_rows=DLRM_KAGGLE_ROWS, dim=16,
                   bot=(13, 512, 256, 64, 16), top=(512, 256, 1))
DLRM_ROWS = 33762577
DLRM_B, DLRM_LR, DLRM_ADAM_LR = 128, 0.1, 1e-3
DLRM_WARMUP, DLRM_STEPS = 10, 50
# ids drawn per table by rank from a power law P(k) ~ k^-1.05 truncated to
# the table's rows; labels Bernoulli(0.256), the Kaggle set's click rate
DLRM_ALPHA, DLRM_CTR = 1.05, 0.256
DLRM_SPARSE_REL_TOL = 1e-6
# (c): the same architecture at 4 small tables against its plain CPU run
DLRM_SMALL = dict(table_rows=(1000, 2000, 3000, 5000), dim=16,
                  bot=(13, 64, 16), top=(64, 1))
DLRM_SMALL_B, DLRM_SMALL_STEPS, DLRM_CPU_TOL = 16, 3, 1e-5
DLRM_PROFILE_GROUPS = (
    ("adamw (port)", ("adamw_kernel",)),
    ("unique / sort", ("unique", "sort", "Sort", "radix", "Radix")),
    ("index_add / scatter / gather", ("index", "scatter", "gather",
                                      "Index", "embedding")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "cublas")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized")))


def dlrm_model(table_rows=DLRM_KAGGLE_ROWS, dim=16, bot=(13, 512, 256, 64, 16),
               top=(512, 256, 1), sparse=True, seed=0, device="cuda"):
    """DLRM (dlrm_s_pytorch.py's DLRM_Net) from the port's public API: a
    bottom MLP over the 13 dense features (ReLU after every layer), one
    nn.Embedding(n_i, dim, sparse=sparse) a table looked up once a
    sample, the dot interaction (the strictly lower triangle of the Gram
    matrix of the dense vector and the 26 rows, in row-major order, after
    the dense vector), a top MLP (ReLU, a sigmoid at the end). DLRM's
    initialisation: tables uniform +-sqrt(1/n_i), weights N(0, sqrt(2 /
    (fan_in + fan_out))), biases N(0, sqrt(1 / fan_out)), drawn on
    `device` from `seed`."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import initializer as I

    class Drawn(I.Initializer):
        """An uninitialised tensor: the values are drawn on the device."""

        def __call__(self, shape, dtype=None, generator=None):
            return torch.empty(tuple(shape), dtype=torch.float32)

    attr = nn.ParamAttr(initializer=Drawn())
    n = len(table_rows) + 1
    widths = (dim + n * (n - 1) // 2,) + tuple(top)

    class DLRM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.LayerList([nn.Embedding(r, dim, sparse=sparse,
                                                  weight_attr=attr)
                                     for r in table_rows])
            self.bot = nn.LayerList([nn.Linear(a, b, attr, attr)
                                     for a, b in zip(bot[:-1], bot[1:])])
            self.top = nn.LayerList([nn.Linear(a, b, attr, attr) for a, b in
                                     zip(widths[:-1], widths[1:])])
            li, lj = torch.tril_indices(n, n, offset=-1)
            self.register_buffer("li", li, persistent=False)
            self.register_buffer("lj", lj, persistent=False)

        def forward(self, dense, ids):
            x = dense
            for lin in self.bot:
                x = F.relu(lin(x))
            rows = [e(ids[:, i]) for i, e in enumerate(self.emb)]
            t = torch.cat([x] + rows, dim=1).reshape(x.shape[0], n, dim)
            z = torch.bmm(t, t.transpose(1, 2))
            r = torch.cat([x, z[:, self.li, self.lj]], dim=1)
            for k, lin in enumerate(self.top):
                r = lin(r)
                r = torch.sigmoid(r) if k == len(self.top) - 1 else F.relu(r)
            return r

    model = DLRM().to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for e, rows in zip(model.emb, table_rows):
            a = math.sqrt(1.0 / rows)
            e.weight.uniform_(-a, a, generator=gen)
        for lin in list(model.bot) + list(model.top):
            fan_in, fan_out = lin.weight.shape
            lin.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                               generator=gen)
            lin.bias.normal_(0.0, math.sqrt(1.0 / fan_out), generator=gen)
    return model


def dlrm_loss(F, p, y):
    """BCE of the click probability (--loss-function=bce), the mean."""
    return F.binary_cross_entropy(p, y)


def power_law_ids(rs, rows, size, alpha=DLRM_ALPHA):
    """Row ids of rank k with P(k) ~ k^-alpha over 1..rows (the inverse of
    the truncated continuous law's CDF, floored), as 0-based rows: the
    hot rows repeat within a batch, as real CTR ids do."""
    a = 1.0 - alpha
    u = rs.rand(size)
    k = np.floor((1.0 + u * ((rows + 1.0) ** a - 1.0)) ** (1.0 / a))
    return np.minimum(k.astype(np.int64), rows) - 1


def dlrm_batches(n, B, table_rows, seed=0):
    """n numpy batches (dense [B, 13] float32 = log(1 + counts), ids [B,
    26] int64 by `power_law_ids`, labels [B, 1] Bernoulli(DLRM_CTR))."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        dense = np.log1p(rs.geometric(0.05, size=(B, 13)) - 1.0)
        ids = np.stack([power_law_ids(rs, r, B) for r in table_rows], 1)
        y = (rs.rand(B, 1) < DLRM_CTR).astype(np.float32)
        out.append((dense.astype(np.float32), ids, y))
    return out


def dlrm_eager_step(model, opt, F):
    """One eager step: forward, BCE, backward (row-sparse table gradients
    where the tables are sparse), opt.step(), opt.clear_grad()."""
    def step(dense, ids, y):
        out = model(dense, ids)
        loss = dlrm_loss(F, out, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach(), [out.detach()]
    return step


def touched_rows(batches, i):
    """The sorted unique ids of table i over `batches`."""
    return np.unique(np.concatenate([b[1][:, i] for b in batches]))


def check_untouched(torch, label, tables, before, batches, extra=()):
    """Every row of each table that no batch touched is bit-identical to
    `before`, and so are the rows of each (name, tensors, want) in
    `extra` (a moment: want 0); returns the rows that changed."""
    changed = 0
    for i, (w, w0) in enumerate(zip(tables, before)):
        keep = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
        keep[torch.from_numpy(touched_rows(batches, i)).to(w.device)] = False
        moved = (w != w0).any(1)
        require(not bool((moved & keep).any()), "%s: table %d moved %d "
                "untouched rows" % (label, i, int((moved & keep).sum())))
        for name, ts, want in extra:
            bad = (ts[i] != want).any(1) & keep
            require(not bool(bad.any()), "%s: %s of table %d is not %s on "
                    "%d untouched rows" % (label, name, i, want,
                                           int(bad.sum())))
        changed += int(moved.sum())
    return changed


def dlrm_sparse_vs_dense(torch, F, model, batch):
    """One SGD step on `batch` with row-sparse table gradients against
    the same step with dense ones (sparse=False), from one state: the
    touched rows within DLRM_SPARSE_REL_TOL of the dense step's largest
    |value|, every other row bit-identical in both. The state is put
    back after."""
    from paddle_tpu_torch import optimizer
    state = [p.detach().clone() for p in model.parameters()]
    dense, ids, y = batch
    ids_np = ids.cpu().numpy()
    rows = [torch.from_numpy(np.unique(ids_np[:, i])).cuda()
            for i in range(ids.shape[1])]
    got = {}
    for sparse in (True, False):
        for e in model.emb:
            e._sparse = sparse
        opt = optimizer.SGD(DLRM_LR, parameters=model.parameters())
        dlrm_eager_step(model, opt, F)(dense, ids, y)
        got[sparse] = [e.weight[r].clone() for e, r in zip(model.emb, rows)]
        check_untouched(torch, "dlrm sparse=%s step" % sparse,
                        [e.weight for e in model.emb], state[:len(rows)],
                        [(None, ids_np, None)])
        got[(sparse, "mlp")] = [p.detach().clone() for p in
                                list(model.parameters())[len(rows):]]
        with torch.no_grad():
            for p, s in zip(model.parameters(), state):
                p.copy_(s)
                p.grad = None     # a dense gradient left would absorb the
                # next sparse ones (dense + sparse is dense)
    for e in model.emb:
        e._sparse = True
    err = 0.0
    for a, b in zip(got[True], got[False]):
        err = max(err, float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30))
    for a, b in zip(got[(True, "mlp")], got[(False, "mlp")]):
        err = max(err, float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30))
    require(err <= DLRM_SPARSE_REL_TOL, "dlrm: the sparse step is %.3g of "
            "the dense step's largest |value| away (> %g)"
            % (err, DLRM_SPARSE_REL_TOL))
    return err


def dlrm_eager_path(torch, ck, F, card, label, model, opt, batches):
    """DLRM_WARMUP + DLRM_STEPS eager steps over `batches` (one a step),
    the launch counters zeroed just before and read just after; one
    profiled step. Returns (launches, step ms, samples/s, peak bytes,
    device ms of the profiled step)."""
    from paddle_tpu_torch import SelectedRows
    it = iter(batches)
    step = dlrm_eager_step(model, opt, F)
    sparse_updates = [0]
    rule = opt._apply_sparse

    def counted(p, sr):
        require(isinstance(sr, SelectedRows), "dlrm %s: a dense table "
                "gradient" % label)
        sparse_updates[0] += 1
        return rule(p, sr)
    opt._apply_sparse = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.launch_counts(reset=True)
    _, times, _ = timed_steps(torch, step, lambda: next(it), DLRM_WARMUP,
                              DLRM_STEPS)
    launches = ck.launch_counts(reset=True)
    n_tables = len(model.emb)
    n_updates = sparse_updates[0]
    opt._apply_sparse = rule
    require(n_updates == n_tables * (DLRM_WARMUP + DLRM_STEPS),
            "dlrm %s: %d row-sparse table updates, want %d (one a table a "
            "step)" % (label, n_updates,
                       n_tables * (DLRM_WARMUP + DLRM_STEPS)))
    peak = torch.cuda.max_memory_allocated()
    dev_ms, rows = profile_step(torch, step, lambda: batches[0])
    step_ms = statistics.median(times)
    say("dlrm %s: step %.3f ms median (%.3f mean) over %d eager steps after "
        "%d warm-up, %.0f samples/s, peak memory %.1f MiB; %d row-sparse "
        "table updates (%s)"
        % (label, step_ms, statistics.mean(times), DLRM_STEPS, DLRM_WARMUP,
           DLRM_B / (step_ms / 1e3), peak / 2 ** 20, n_updates, card))
    report_profile("dlrm %s" % label, dev_ms, step_ms, rows,
                   DLRM_PROFILE_GROUPS)
    return launches, step_ms, DLRM_B / (step_ms / 1e3), peak, dev_ms


def dlrm_train(torch, ck, card):
    """Phase 27 (b): DLRM at the Kaggle tables' full 33,762,577 rows, B=128,
    float32: (b1) SGD(0.1) eagerly with row-sparse table gradients, (b2)
    Adam(lazy_mode=True, 1e-3) eagerly (the MLP's parameters through row
    7, one launch a step), (b3) the tables dense (sparse=False) through
    make_train_step with SGD: one CUDA graph. Returns (b2)'s launches and
    the numbers."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import make_train_step
    import paddle_tpu_torch.nn.functional as F
    t0 = time.perf_counter()
    model = dlrm_model(**DLRM_KAGGLE)
    tables = [e.weight for e in model.emb]
    n_rows = sum(t.shape[0] for t in tables)
    require(n_rows == DLRM_ROWS, "dlrm: %d table rows, want %d"
            % (n_rows, DLRM_ROWS))
    n = DLRM_WARMUP + DLRM_STEPS
    host = dlrm_batches(3 * n + 1, DLRM_B, DLRM_KAGGLE_ROWS, seed=0)
    dev = [tuple(torch.from_numpy(a).cuda() for a in b) for b in host]
    per_step = [sum(len(np.unique(b[1][:, i])) for i in range(26))
                for b in host]
    say("dlrm: %d tables, %d rows (%.2f GB float32), MLPs %s and %s, "
        "built in %.1f s; %d rows a step, %.1f unique rows a step on "
        "average (power law %.2f)"
        % (len(tables), n_rows, n_rows * 16 * 4 / 1e9,
           "-".join(str(w) for w in DLRM_KAGGLE["bot"]),
           "-".join(str(w) for w in (model.top[0].weight.shape[0],)
                    + tuple(DLRM_KAGGLE["top"])), time.perf_counter() - t0,
           DLRM_B * 26, statistics.mean(per_step), DLRM_ALPHA))
    out = {"rows_a_step": DLRM_B * 26,
           "unique_rows_a_step": statistics.mean(per_step)}
    err = dlrm_sparse_vs_dense(torch, F, model, dev[-1])
    say("dlrm (b1): one sparse SGD step against the dense step "
        "(sparse=False, the same batch): %.3g of the dense step's largest "
        "|value| on the touched rows (tolerance %g), every other row "
        "bit-identical in both" % (err, DLRM_SPARSE_REL_TOL))
    # (b1) SGD, eager
    before = [t.detach().clone() for t in tables]
    opt = optimizer.SGD(DLRM_LR, parameters=model.parameters())
    l1, ms1, sps1, peak1, dev1 = dlrm_eager_path(
        torch, ck, F, card, "(b1) SGD sparse eager", model, opt, dev[:n])
    moved = check_untouched(torch, "dlrm (b1)", tables, before, host[:n])
    say("dlrm (b1): %d rows moved, every untouched row bit-identical"
        % moved)
    require(sum(l1.values()) == 0, "dlrm (b1): SGD launched %s" % l1)
    out["b1"] = dict(step_ms=ms1, samples_per_s=sps1, peak_bytes=peak1,
                     device_ms=dev1, sparse_vs_dense=err, moved_rows=moved)
    # (b2) lazy Adam, eager
    del before
    before = [t.detach().clone() for t in tables]
    opt = optimizer.Adam(learning_rate=DLRM_ADAM_LR, lazy_mode=True,
                         parameters=model.parameters())
    l2, ms2, sps2, peak2, dev2 = dlrm_eager_path(
        torch, ck, F, card, "(b2) lazy Adam sparse eager", model, opt,
        dev[n:2 * n])
    accs = [opt._get_accumulators(t) for t in tables]
    moved = check_untouched(
        torch, "dlrm (b2)", tables, before, host[n:2 * n],
        extra=(("moment1", [a["moment1"] for a in accs], 0.0),
               ("moment2", [a["moment2"] for a in accs], 0.0)))
    mlp = [p for p in model.parameters() if all(p is not t for t in tables)]
    want = n * adamw_launches(mlp)
    require(l2.get("adamw", 0) == want, "dlrm (b2): %d adamw launches, want "
            "%d (one a step)" % (l2.get("adamw", 0), want))
    say("dlrm (b2): %d rows moved, untouched rows bit-identical in the "
        "parameter and both moments (zero); row 7 launched %d times over %d "
        "steps (one a step, the tables' sparse pairs outside its group)"
        % (moved, l2["adamw"], n))
    out["b2"] = dict(step_ms=ms2, samples_per_s=sps2, peak_bytes=peak2,
                     device_ms=dev2, moved_rows=moved, launches=l2["adamw"])
    del before, opt, accs
    free_memory(torch)
    # (b3) dense tables through the captured step
    for e in model.emb:
        e._sparse = False
    opt = optimizer.SGD(DLRM_LR, parameters=model.parameters())
    step = make_train_step(model, lambda p, y: dlrm_loss(F, p, y), opt)
    it = iter(dev[2 * n:3 * n])
    batch = lambda: (lambda b: ([b[0], b[1]], [b[2]]))(next(it))  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    _, times, _ = timed_steps(torch, step, batch, DLRM_WARMUP, DLRM_STEPS)
    peak3 = torch.cuda.max_memory_allocated()
    require(step.compiles == 1 and step.replays == n - 1,
            "dlrm (b3): %d builds, %d replays" % (step.compiles,
                                                  step.replays))
    b0 = dev[0]
    dev3, rows3 = profile_step(torch, step, lambda: ([b0[0], b0[1]], [b0[2]]))
    ms3 = statistics.median(times)
    pool = step.programs.pool_bytes()
    say("dlrm (b3) SGD dense captured: step %.3f ms median (%.3f mean) over "
        "%d replays after %d warm-up (one build), %.0f samples/s, peak "
        "memory %.1f MiB, graph pool %.1f MiB (%s)"
        % (ms3, statistics.mean(times), DLRM_STEPS, DLRM_WARMUP,
           DLRM_B / (ms3 / 1e3), peak3 / 2 ** 20, pool / 2 ** 20, card))
    report_profile("dlrm (b3) SGD dense captured", dev3, ms3, rows3,
                   DLRM_PROFILE_GROUPS)
    out["b3"] = dict(step_ms=ms3, samples_per_s=DLRM_B / (ms3 / 1e3),
                     peak_bytes=peak3, device_ms=dev3, pool_bytes=pool)
    del model, opt, step, dev, tables
    free_memory(torch)
    return l2, out


def dlrm_compare(torch):
    """Phase 27 (c): DLRM_SMALL on the card against the same model on the
    CPU (its weights carried over), B=16, float32, TF32 off, 3 steps each
    of SGD, lazy Adam and lazy AdamW with row-sparse tables: losses and
    parameters within DLRM_CPU_TOL of the CPU's largest |value|."""
    from paddle_tpu_torch import optimizer
    import paddle_tpu_torch.nn.functional as F
    rules = (("SGD", lambda ps, dev: optimizer.SGD(
        DLRM_LR, parameters=ps, device=dev)),
             ("Adam lazy", lambda ps, dev: optimizer.Adam(
                 learning_rate=DLRM_ADAM_LR, lazy_mode=True, parameters=ps,
                 device=dev)),
             ("AdamW lazy", lambda ps, dev: optimizer.AdamW(
                 learning_rate=DLRM_ADAM_LR, weight_decay=0.01,
                 lazy_mode=True, parameters=ps, device=dev)))
    batches = dlrm_batches(DLRM_SMALL_STEPS, DLRM_SMALL_B,
                           DLRM_SMALL["table_rows"], seed=1)
    worst = 0.0
    for name, make in rules:
        runs = {}
        for dev in ("cuda", "cpu"):
            model = dlrm_model(**DLRM_SMALL, device="cuda")
            if dev == "cpu":
                model = model.to("cpu")
            opt = make(model.parameters(), dev)
            step = dlrm_eager_step(model, opt, F)
            losses = [float(step(*(torch.from_numpy(a).to(dev)
                                   for a in b))[0]) for b in batches]
            runs[dev] = (losses, [p.detach().cpu() for p in
                                  model.parameters()])
        (lg, pg), (lw, pw) = runs["cuda"], runs["cpu"]
        e = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(lg, lw))
        for a, b in zip(pg, pw):
            e = max(e, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1.0))
        require(e <= DLRM_CPU_TOL, "dlrm (c) %s: the card is %.3g from the "
                "CPU run (> %g)" % (name, e, DLRM_CPU_TOL))
        worst = max(worst, e)
    say("dlrm (c): %s on the card against the CPU run, %d steps each: "
        "largest error %.3g (tolerance %g)"
        % ([r for r, _ in rules], DLRM_SMALL_STEPS, worst, DLRM_CPU_TOL))
    return worst


def _c64(shape=(4, 6)):
    return lambda rs: (rs.randn(*shape) + 1j * rs.randn(*shape)).astype(
        np.complex64)


_R46 = _u(-1.5, 1.5, (4, 6))
# (a): the slice's registered ops, their inputs and attrs
LEGACY_SPECS = {
    "affine_channel_op": ([_u(-1, 1, (2, 3, 4, 4)), _u(0.5, 1.5, (3,)),
                           _u(-0.5, 0.5, (3,))], {}),
    "viterbi_decode_op": ([_u(-1, 1, (3, 5, 4)), _u(-1, 1, (4, 4)),
                           _const(np.array([5, 3, 1], np.int64))], {}),
    "cvm_op": ([_u(0.5, 3, (4, 6)), _u(0.5, 3, (4, 2))], {}),
    "center_loss_op": ([_u(-1, 1, (4, 3)), _i64(0, 3, (4,)),
                        _u(-1, 1, (3, 3)), _u(0.1, 0.5, (1,))],
                       {"cluster_num": 3}),
    "squared_l2_distance_op": ([_u(-1, 1, (4, 3)), _u(-1, 1, (1, 3))], {}),
    "teacher_student_sigmoid_loss_op": (
        [_u(-2, 2, (6,)), _const(np.array([-2, -1, 0.3, 0.8, 1.2, 1.7],
                                          np.float32))], {}),
    "fused_embedding_seq_pool_op": ([_u(-1, 1, (8, 4)), _i64(0, 8, (2, 5)),
                                     _const(np.array([2, 5], np.int64))], {}),
    "squared_l2_norm_op": ([_u(-1, 1, (4, 3))], {}),
    "hinge_loss_op": ([_u(-1, 1, (4, 1)), _const(np.array(
        [[0], [1], [1], [0]], np.float32))], {}),
    "rank_loss_op": ([_const(np.array([[0], [1], [1], [0]], np.float32)),
                      _u(-1, 1, (4, 1)), _u(-1, 1, (4, 1))], {}),
    "bpr_loss_op": ([_u(-1, 1, (4, 5)), _i64(0, 5, (4, 1))], {}),
    "fsp_op": ([_u(-1, 1, (2, 3, 4, 5)), _u(-1, 1, (2, 6, 4, 5))], {}),
    "pad_constant_like_op": ([_u(-1, 1, (4, 5)), _u(-1, 1, (2, 3))],
                             {"pad_value": 0.5}),
    "shuffle_batch_op": ([_u(-1, 1, (6, 3)), _const(np.array([7],
                                                             np.int64))], {}),
    "conv_shift_op": ([_u(-1, 1, (2, 7)), _u(-1, 1, (2, 3))], {}),
    "row_conv_op": ([_u(-1, 1, (2, 5, 3)), _u(-1, 1, (2, 3))], {}),
    "correlation_op": ([_u(-1, 1, (1, 2, 6, 6)), _u(-1, 1, (1, 2, 6, 6))],
                       {"max_displacement": 2, "pad_size": 2}),
    "segment_pool_op": ([_u(-1, 1, (6, 3)), _const(np.array(
        [0, 0, 1, 3, 3, 3], np.int64))], {"pooltype": "MAX"}),
    "positive_negative_pair_op": (
        [_u(0, 1, (8, 1)), lambda rs: rs.randint(0, 3, (8, 1)).astype(
            np.float32), _const(np.array([0, 0, 0, 0, 1, 1, 1, 1],
                                         np.int64))], {}),
    "filter_by_instag_op": ([_u(-1, 1, (4, 3)), _const(np.array(
        [[1, -1], [2, 3], [4, -1], [3, 1]], np.int64)),
        _const(np.array([3], np.int64))], {}),
    "beam_search_step_op": ([_i64(0, 4, (2, 2)), _u(-1, 0, (2, 2)),
                             _u(-2, 0, (2, 2, 4))],
                            {"beam_size": 2, "end_id": 3}),
    "py_func_op": ([_u(-1, 1, (4, 3))], {"func": np.tanh,
                                         "out_shape": (4, 3),
                                         "out_dtype": "float32"}),
    "data_norm_op": ([_u(-1, 1, (4, 3)), _const(np.full((3,), 8.0,
                                                        np.float32)),
                      _u(-1, 1, (3,)), _u(4, 8, (3,))], {}),
    "linear_chain_crf_op": ([_u(-1, 1, (2, 3, 4)), _u(-1, 1, (6, 4)),
                             _i64(0, 4, (2, 3)),
                             _const(np.array([3, 2], np.int64))], {}),
    "hash_op": ([_const(np.array([[1], [12345], [2 ** 40 + 7],
                                  [987654321012]], np.int64))],
                {"num_hash": 3, "mod_by": 100000007}),
    "fill_diagonal_op": ([_u(-1, 1, (7, 3))], {"value": 0.5, "offset": 1,
                                               "wrap": True}),
    "space_to_depth_op": ([_u(-1, 1, (1, 8, 4, 4))], {"blocksize": 2}),
    "nce_op": ([_u(-1, 1, (4, 3)), _u(-1, 1, (8, 3)), _u(-0.5, 0.5, (8,)),
                _i64(0, 8, (4, 1)), _const(np.array([11], np.int64))],
               {"num_neg_samples": 5, "num_total_classes": 8}),
    "prroi_pool_op": ([_u(0, 1, (1, 2, 8, 8)), _const(np.array(
        [[0.5, 0.5, 5.5, 6.0], [1.0, 2.0, 7.0, 7.5]], np.float32))],
        {"output_size": (3, 3), "spatial_scale": 1.0}),
    "lookup_table_v2_sparse": ([_u(-1, 1, (10, 4)), _i64(0, 10, (3, 5))],
                               {}),
    "frame": ([_u(-1, 1, (16,))], {"frame_length": 8, "hop_length": 4}),
    "overlap_add": ([_u(-1, 1, (8, 4))], {"hop_length": 4}),
}
for _op in ("fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "hfft",
            "irfft", "irfft2", "irfftn", "fftshift", "ifftshift"):
    LEGACY_SPECS[_op] = ([_c64()], {})
for _op in ("rfft", "rfft2", "rfftn", "ihfft"):
    LEGACY_SPECS[_op] = ([_R46], {})
# ops whose results must be bit-equal on the card and the CPU
LEGACY_EXACT = ("hash_op", "viterbi_decode_op")


def legacy_inputs(op):
    """(numpy inputs, attrs) of LEGACY_SPECS[op], seeded by the op's
    name."""
    import zlib
    makers, attrs = LEGACY_SPECS[op]
    rs = np.random.RandomState(zlib.crc32(op.encode()) % 2 ** 31)
    return [np.asarray(m(rs)) for m in makers], dict(attrs)


def _card_vs_cpu(torch, name, fn, arrays, grads=True):
    """fn on CUDA tensors against fn on CPU tensors (floating inputs
    differentiated under one cotangent): the largest error over the CPU
    result's largest |value| (integers exact)."""
    def inputs(dev):
        out = []
        for a in arrays:
            t = torch.from_numpy(np.array(a)).to(dev)
            if grads and t.is_floating_point() and t.ndim:
                t.requires_grad_(True)
            out.append(t)
        return out
    cin, gin = inputs("cpu"), inputs("cuda")
    want, got = _as_list(fn(*cin)), _as_list(fn(*gin))
    require(len(got) == len(want), "%s: %d outputs on the card, %d on the "
            "CPU" % (name, len(got), len(want)))
    err = max([_err(torch, g, w, name) for g, w in zip(got, want)] + [0.0])
    fl = [i for i, w in enumerate(want) if w.is_floating_point()
          and w.requires_grad]
    if grads and fl:
        rs = np.random.RandomState(1234)
        cts = [torch.from_numpy(np.asarray(rs.rand(*want[i].shape),
                                           np.float32)).to(want[i].dtype)
               for i in fl]
        wi = [t for t in cin if t.requires_grad]
        gi = [t for t in gin if t.requires_grad]
        wg = torch.autograd.grad(sum((want[i] * c).sum() for i, c in
                                     zip(fl, cts)), wi, allow_unused=True)
        gg = torch.autograd.grad(sum((got[i] * c.cuda()).sum() for i, c in
                                     zip(fl, cts)), gi, allow_unused=True)
        for a, b in zip(gg, wg):
            if b is not None:
                a = a.to_dense() if a.is_sparse else a
                b = b.to_dense() if b.is_sparse else b
                err = max(err, _err(torch, a, b, name + " gradient"))
    return err


def check_legacy_surface(torch):
    """Phase 27 (a): the slice's 48 registered ops, stft / istft, the
    distributions, fluid.layers over the new ops and static.gradients on
    the card against the CPU, forward and gradients, TF32 off, within
    OPS_TOL (hash_op and viterbi_decode_op bit-equal); shuffle_batch's
    and nce's bodies on the CPU's draws."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distribution, fluid, signal, static
    from paddle_tpu_torch.framework.dispatch import OPS
    from paddle_tpu_torch.ops import misc_ops
    worst = {}
    for op in LEGACY_SPECS:
        arrays, attrs = legacy_inputs(op)
        fn = lambda *a, op=op, attrs=attrs: OPS[op].fn(*a, **attrs)  # noqa
        if op == "shuffle_batch_op":
            perm = OPS[op].fn(torch.from_numpy(arrays[0]), 7)[1]
            arrays = [arrays[0], perm.numpy()]
            fn = lambda x, p: misc_ops.shuffle_rows(x, p)  # noqa: E731
        elif op == "nce_op":
            neg = np.random.RandomState(3).randint(0, 8, (4, 5))
            arrays = arrays[:4] + [neg]
            fn = lambda x, w, b, lab, ng: misc_ops.nce_loss(  # noqa: E731
                x, w, b, lab.reshape(-1), ng, float(np.log(5 / 8)))
        e = _card_vs_cpu(torch, op, fn, arrays,
                         grads=not OPS[op].nondiff)
        tol = 0.0 if op in LEGACY_EXACT else OPS_TOL["reduction"]
        require(e <= tol, "%s on the card: error %.3g > %g" % (op, e, tol))
        worst[op] = e
    x = _u(-1, 1, (2, 64))(np.random.RandomState(5))
    win = np.hanning(16).astype(np.float32)
    worst["stft"] = _card_vs_cpu(torch, "stft", lambda t: signal.stft(
        t, 32, 8, 16, torch.from_numpy(win).to(t.device)), [x])
    spec = signal.stft(torch.from_numpy(x).cuda(), 32, 8)
    back = signal.istft(spec, 32, 8, length=64)
    worst["istft round trip"] = _err(torch, back, torch.from_numpy(x),
                                     "istft")
    worst["istft"] = _card_vs_cpu(torch, "istft", lambda s: signal.istft(
        s, 32, 8, length=64), [spec.detach().cpu().numpy()])
    rs = np.random.RandomState(6)
    loc, scale = rs.randn(3).astype(np.float32), rs.rand(3).astype(
        np.float32) + 0.5
    val = rs.randn(4, 3).astype(np.float32)
    logits = rs.randn(4, 5).astype(np.float32)
    for name, fn, arrays in (
            ("Normal", lambda m, s, v: (
                distribution.Normal(m, s).log_prob(v),
                distribution.Normal(m, s).entropy(),
                distribution.Normal(m, s).kl_divergence(
                    distribution.Normal(m * 0.5, s + 0.1))),
             [loc, scale, val]),
            ("Uniform", lambda lo, v: (
                distribution.Uniform(lo, lo + 2.0).log_prob(v),
                distribution.Uniform(lo, lo + 2.0).entropy()),
             [loc, val]),
            ("Categorical", lambda lg: (
                distribution.Categorical(lg).entropy(),
                distribution.Categorical(lg).log_prob(
                    torch.arange(4, device=lg.device) % 5),
                distribution.Categorical(lg).kl_divergence(
                    distribution.Categorical(lg * 0.5))), [logits])):
        worst[name] = _card_vs_cpu(torch, name, fn, arrays)
    L = fluid.layers
    for name, fn, spec_op in (
            ("fluid.layers.hinge_loss", L.hinge_loss, "hinge_loss_op"),
            ("fluid.layers.rank_loss", L.rank_loss, "rank_loss_op"),
            ("fluid.layers.bpr_loss", L.bpr_loss, "bpr_loss_op"),
            ("fluid.layers.linear_chain_crf", L.linear_chain_crf,
             "linear_chain_crf_op"),
            ("fluid.layers.continuous_value_model",
             L.continuous_value_model, "cvm_op")):
        worst[name] = _card_vs_cpu(torch, name, fn, legacy_inputs(spec_op)[0])
    worst["static.gradients"] = _card_vs_cpu(
        torch, "static.gradients", lambda x, w: static_gradients_run(
            paddle, static, x, w), [_u(-1, 1, (4, 3))(rs),
                                    _u(-1, 1, (3, 2))(rs)], grads=False)
    tol = OPS_TOL["reduction"]
    bad = {k: v for k, v in worst.items() if v > tol}
    require(not bad, "legacy surface on the card: %s > %g" % (bad, tol))
    say("legacy surface on the card (phase 27 (a)): %d registered ops, "
        "stft/istft, 3 distributions, 5 fluid.layers wrappers and "
        "static.gradients against the CPU, forward and gradients, TF32 off: "
        "largest error %.3g (%s), hash_op and viterbi_decode_op bit-equal, "
        "istft(stft(x)) within %.3g of x"
        % (len(LEGACY_SPECS), max(worst.values()),
           max(worst, key=worst.get), worst["istft round trip"]))
    return worst


def static_gradients_run(paddle, static, x, w):
    """A static program on x's device: y = tanh(x @ w), loss = mean(y^2);
    (loss, dloss/dx, dloss/dw seeded by 2) through static.gradients and
    Executor.run."""
    import torch
    dev = "gpu:0" if x.device.type == "cuda" else "cpu"
    prog = static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(prog):
            xv = static.data("x", list(x.shape), "float32")
            wp = torch.nn.Parameter(w.detach().clone())
            y = paddle.tanh(paddle.matmul(xv, wp))
            loss = paddle.mean(y * y)
            seed = static.data("seed", [], "float32")
            gx, gw = static.gradients([loss], [xv, wp],
                                      target_gradients=[seed])
        out = static.Executor(dev).run(
            prog, feed={"x": x.detach(), "seed": torch.tensor(2.0)},
            fetch_list=[loss, gx, gw], return_numpy=False)
    finally:
        paddle.disable_static()
    return tuple(out)


def dlrm_main(torch, ck, flags, card):
    """Phase 27: (a) the legacy op surface on the card, (b) DLRM at full
    size through the sparse and dense paths, (c) the small DLRM against
    its CPU run. Returns (b)'s launches and the numbers."""
    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        worst = check_legacy_surface(torch)
        t1 = time.perf_counter()
        launches, entry = dlrm_train(torch, ck, card)
        t2 = time.perf_counter()
        entry["cpu_err"] = dlrm_compare(torch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    free_memory(torch)
    say("dlrm phase 27: %.1f s ((a) %.1f, (b) %.1f, (c) %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1,
           time.perf_counter() - t2))
    entry.update(launches=launches, surface=max(worst.values()))
    return entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, check them against their "
                    "plain versions and stop")
    ap.add_argument("--resnet-only", action="store_true",
                    help="name the card, then run phase 19 (ResNet-50) "
                    "alone: it launches none of the port's kernels, so "
                    "nothing is built")
    ap.add_argument("--resume-drill", metavar="JSON",
                    help="one run of phase 17's resume drill, its settings "
                    "as JSON (see resume_drill); phase 17 starts these")
    ap.add_argument("--fit-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "20 (Model.fit) alone")
    ap.add_argument("--long-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "21 (GPT-2 long context, T=8192) alone")
    ap.add_argument("--static-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "22 (the static graph and the predictor) alone")
    ap.add_argument("--seq2seq-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "23 (the encoder-decoder Transformer) alone")
    ap.add_argument("--rnn-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "24 (the recurrent family, the LSTM language model) "
                    "alone")
    ap.add_argument("--moe-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "25 (the op surface, GPT-2-small-MoE) alone")
    ap.add_argument("--unet-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "26 (the rest of nn, the improved-DDPM CIFAR-10 UNet) "
                    "alone")
    ap.add_argument("--dlrm-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "27 (row-sparse gradients, the legacy op surface, "
                    "DLRM) alone")
    ap.add_argument("--fit-drill", metavar="JSON",
                    help="one run of phase 20's preemption drill, its "
                    "settings as JSON (see fit_drill); phase 20 starts "
                    "these")
    opts = ap.parse_args()
    if opts.resume_drill:
        return resume_drill(json.loads(opts.resume_drill))
    if opts.fit_drill:
        return fit_drill(json.loads(opts.fit_drill))

    import torch
    require(torch.cuda.is_available(), "CUDA is not available")
    import torch.nn.functional as F

    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say("torch %s, CUDA %s, %s x%d, tf32 matmul %s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count(),
           torch.backends.cuda.matmul.allow_tf32))

    if opts.resnet_only:
        resnet_main(torch, ck, flags, card)
        say("resnet-only run: phase 19 passed")
        return 0

    # 2. build
    secs = _build.build()
    say("build: %d kernel sources in %.1f s (parallel nvcc%s)"
        % (len(_build.KERNEL_SOURCES), secs,
           ", " + " ".join(_build._split_flag()) if _build._split_flag()
           else ""))
    for name, log in sorted(_build.build_logs().items()):
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                say("ptxas %s: %s" % (name, line.strip()))
    for src, entry, regs, spill in ptxas_registers(
            _build.build_logs(), ("paged_split_kernel", "flash_fwd_f32")):
        say("registers %s %s: %d (%s)" % (src, entry, regs, spill))
    clock = [time.perf_counter()]

    def lap(what):
        """The wall time since the last lap, so that a slow run shows
        which phases took it."""
        now = time.perf_counter()
        say("wall %s: %.1f s" % (what, now - clock[0]))
        clock[0] = now

    if opts.fit_only:
        fit_main(torch, ck, card)
        say("fit-only run: phase 20 passed")
        return 0
    if opts.long_only:
        long_main(torch, ck, F, flags, card)
        say("long-only run: phase 21 passed")
        return 0
    if opts.static_only:
        static_main(torch, ck, F, flags, card)
        say("static-only run: phase 22 passed")
        return 0
    if opts.seq2seq_only:
        nmt_main(torch, ck, F, flags, card)
        say("seq2seq-only run: phase 23 passed")
        return 0
    if opts.rnn_only:
        rnn_main(torch, ck, card)
        say("rnn-only run: phase 24 passed")
        return 0
    if opts.moe_only:
        moe_main(torch, ck, flags, card)
        say("moe-only run: phase 25 passed")
        return 0
    if opts.unet_only:
        unet_main(torch, ck, F, flags, card)
        say("unet-only run: phase 26 passed")
        return 0
    if opts.dlrm_only:
        dlrm_main(torch, ck, flags, card)
        say("dlrm-only run: phase 27 passed")
        return 0

    # 3. kernels against their plain versions
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_fwd": check_flash(torch, ck, gen),
            "paged_decode": check_paged(torch, ck, False, gen),
            "paged_decode_int8": check_paged(torch, ck, True, gen)}
    check_dropout_bits(torch, ck)
    errs.update(check_flash_train(torch, ck, gen))
    check_flash_f16_range(torch, ck, gen)
    errs.update(check_adamw(torch, ck, gen))
    errs["dropout_keep"] = check_dropout_keep(torch, ck, keep_cases())
    check_gates(torch, ck, gen)
    errs.update(check_fused(torch, ck, flags, gen))
    if opts.kernels_only:
        say("kernels-only run: checks passed")
        return 0

    lap("phase 3, the kernels against their plain versions")

    # 4. kernel timings at the main path's shapes
    timer = Timer(torch)
    times = {}
    flash_t = {}                        # by prefill bucket
    for T in BUCKETS:
        t = time_flash(torch, ck, F, timer, gen, T)
        say("time flash_fwd B=1 H=12 T=%d D=64 f32 causal: %.4f ms, plain "
            "%.4f ms, sdpa %.4f ms, bound %.4f ms (%s)"
            % (T, t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
        flash_t[T] = t
    times["flash_fwd"] = dict(flash_t[BUCKETS[-1]])   # the row's time
    decode_lens = [int(x) for x in
                   np.random.RandomState(1).randint(2, 320, 8)]
    for name, quantized in (("paged_decode", False),
                            ("paged_decode_int8", True)):
        t = time_paged(torch, ck, F, timer, gen, quantized, decode_lens)
        say("time %s B=8 H=12 T=512 D=64 lens=%s: %.4f ms, plain %.4f ms, "
            "sdpa %s, bound %.4f ms (%s)"
            % (name, decode_lens, t["ms"], t["plain_ms"],
               "n/a" if t["library_ms"] is None
               else "%.4f ms" % t["library_ms"], t["bound_ms"],
               t["bound_by"]))
        times[name] = t

    lap("phase 4, the serving kernels' times")

    # 5. main path: gpt2-small behind the engine and the batcher
    t0 = time.perf_counter()
    model = gpt2_small(seed=0)
    say("gpt2-small: %d parameters, built in %.1f s"
        % (sum(p.numel() for p in model.parameters()),
           time.perf_counter() - t0))
    cfg = dict(max_batch=8, max_seq_len=512, prefill_buckets=BUCKETS)
    warm = serving.GenerationEngine(model, **cfg)
    serve(serving, warm, [(np.arange(1, 6), 4), (np.arange(1, 101), 4)])
    del warm
    reqs = make_requests(np)
    torch.cuda.reset_peak_memory_stats()
    eng = serving.GenerationEngine(model, **cfg)
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    kreqs, wall, steps = serve(serving, eng, reqs)
    launches = ck.launch_counts()
    paths = ck.attention_path_counts()
    kstate = [t.clone() for t in eng.kv.state()]
    peak = torch.cuda.max_memory_allocated()
    serve_line("main path (16 submitted at once on 8 slots, step programs "
               "replayed)", kreqs, wall, steps, card)
    direct_tps = sum(len(r.tokens) for r in kreqs) / wall
    say("main path: prefix hits %d; peak memory %.1f MiB (KV cache %.1f "
        "MiB)" % (sum(1 for r in kreqs if r.prefix_len > 0), peak / 2**20,
                  eng.kv.nbytes / 2**20))
    say("main path launches %s, attention paths %s" % (launches, paths))
    require(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
            "the main path did not launch both kernels: %s" % launches)
    require(paths["xla_sdpa"] == 0 and paths["xla_paged"] == 0,
            "the main path took a plain attention path: %s" % paths)
    require(any(r.prefix_len > 0 for r in kreqs),
            "no prefix-cache hit: the suffix path did not run")
    report_programs("float32", eng, card)
    flash_by_t, replayed = program_launches([eng], launches)
    say("main path launches through replays %s"
        % {k: n for k, n in replayed.items() if n})
    require(replayed["flash_fwd"] > 0 and replayed["paged_decode"] > 0,
            "the main path launched its kernels in no replay: %s" % replayed)
    require(sum(flash_by_t.values()) == launches["flash_fwd"]
            and set(flash_by_t) <= set(BUCKETS),
            "flash_fwd launches by bucket %s do not add up to %d"
            % (flash_by_t, launches["flash_fwd"]))
    over = sum(flash_by_t.get(T, 0) * (flash_t[T]["ms"]
                                       - flash_t[T]["bound_ms"])
               for T in BUCKETS)
    say("flash_fwd launches by bucket %s: launches x (time - bound) %.3f "
        "ms over the run" % (flash_by_t, over))
    times["flash_fwd"]["buckets"] = [
        dict(T=T, launches=flash_by_t.get(T, 0), **{
            k: flash_t[T][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms")}) for T in BUCKETS]
    dev_ms, top = profile_decode(torch, eng)
    report_decode_profile("float32", dev_ms, statistics.median(steps), top,
                          card)
    direct_again_tps = serve_again(serving, eng, reqs, kreqs, "main path",
                                   card)
    del eng
    graph_against_eager(torch, serving, model, cfg, reqs, kreqs, kstate,
                        "float32", card)

    # 6. the same requests on the plain versions
    Recording = recording_engine(torch, serving.GenerationEngine)
    saved = flags.get_flags(["use_flash_attention", "paged_flash_decode"])

    def plain_run(rq, **kw):
        flags.set_flags({"use_flash_attention": False,
                         "paged_flash_decode": False})
        ck.launch_counts(reset=True)
        try:
            e = Recording(model, **cfg, **kw)
            out, _, _ = serve(serving, e, rq)
        finally:
            flags.set_flags(saved)
        require(sum(ck.launch_counts().values()) == 0,
                "a kernel launched with its flag off")
        return out, e.gaps

    preqs, gaps = plain_run(reqs)
    compare_tokens(kreqs, preqs, gaps, "float32")

    # 7. int8 cache: kernel run, then the plain int8 path
    ireqs = [(p, min(m, 24)) for p, m in reqs[:8]]
    e8 = serving.GenerationEngine(model, kv_dtype="int8", **cfg)
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    k8, wall8, steps8 = serve(serving, e8, ireqs)
    launches8 = ck.launch_counts()
    paths8 = ck.attention_path_counts()
    state8 = [t.clone() for t in e8.kv.state()]
    serve_line("int8 run (8 submitted at once on 8 slots, step programs "
               "replayed)", k8, wall8, steps8, card)
    say("int8 run launches %s, attention paths %s" % (launches8, paths8))
    require(launches8["paged_decode_int8"] > 0 and
            launches8["flash_fwd"] > 0,
            "the int8 run did not launch its kernels: %s" % launches8)
    require(paths8["xla_sdpa"] == 0 and paths8["xla_paged"] == 0,
            "the int8 run took a plain attention path: %s" % paths8)
    report_programs("int8", e8, card)
    _, replayed8 = program_launches([e8], launches8)
    say("int8 run launches through replays %s"
        % {k: n for k, n in replayed8.items() if n})
    require(replayed8["paged_decode_int8"] > 0,
            "the int8 run launched its kernel in no replay: %s" % replayed8)
    dev8, top8 = profile_decode(torch, e8)
    report_decode_profile("int8", dev8, statistics.median(steps8), top8,
                          card)
    serve_again(serving, e8, ireqs, k8, "int8 run", card)
    del e8
    graph_against_eager(torch, serving, model, cfg, ireqs, k8, state8, "int8",
                        card, kv_dtype="int8")
    p8, gaps8 = plain_run(ireqs, kv_dtype="int8")
    compare_tokens(k8, p8, gaps8, "int8")

    lap("phases 5-7, serving through the engine")

    # 8. the server: InferenceServer on the card, its live plane scraped
    from paddle_tpu_torch.observability import flight, httpd, tracing
    from paddle_tpu_torch.resilience import health
    with tempfile.TemporaryDirectory() as tele_dir:
        # a memory sample after every step, so /statusz's is the run's last
        env = {flight.ENV_DIR: tele_dir, health.ENV_DIR: tele_dir,
               flight.ENV_HBM_INTERVAL: "0"}
        os.environ.update(env)
        hb_path = health.heartbeat_path(tele_dir, 0)
        try:
            srv, slaunch_a, tps_a, tps_a2 = server_run(
                torch, ck, serving, model, cfg, reqs, preqs, gaps,
                "server (a), 1 worker", card, hb_path)
            say("server (a) against the engine alone (phase 5, 16 "
                "submitted at once): fresh %.1f / %.1f tokens/s = %.3f; "
                "built %.1f / %.1f = %.3f"
                % (tps_a, direct_tps, tps_a / direct_tps, tps_a2,
                   direct_again_tps, tps_a2 / direct_again_tps))
            telemetry_cost(torch, tracing, srv.engines[0], card)
            del srv
            srv, slaunch_b, tps_b, tps_b2 = server_run(
                torch, ck, serving, model, cfg, reqs, preqs, gaps,
                "server (b), 2 workers", card, hb_path, workers=2)
            say("server (b) against (a): fresh %.1f / %.1f tokens/s = "
                "%.3f; built %.1f / %.1f = %.3f"
                % (tps_b, tps_a, tps_b / tps_a, tps_b2, tps_a2,
                   tps_b2 / tps_a2))
            del srv
            srv, slaunch_c, _, _ = server_run(
                torch, ck, serving, model, cfg, ireqs, p8, gaps8,
                "server (c), int8 cache", card, hb_path, kv_dtype="int8")
            del srv
            crash_drill(serving, model, cfg, tele_dir)
        finally:
            httpd.shutdown()
            for var in env:
                os.environ.pop(var, None)

    lap("phase 8, the server")

    # 9-11. training: kernel times, the main path, kernels vs plain
    times.update(train_timings(torch, ck, F, timer, gen))
    tlaunches, shapes, off_ms = train_main(torch, ck, flags, card)
    times["adamw"] = time_adamw(torch, ck, timer, gen, shapes, card)
    times["dropout_keep"] = time_dropout_keep(torch, ck, timer,
                                              (TRAIN_B, TRAIN_T, 768))
    train_compare(torch, ck, flags)

    lap("phases 9-11, GPT-2 training")

    # 12-13. rows 4-6 at the paths' shapes; path B: GPT-2 training with
    # both fused flags on, then its kernels vs the flags-off plain run
    times.update(time_fused(torch, ck, timer, gen, TRAIN_B * TRAIN_T, 768,
                            torch.bfloat16, True, "gpt2 (path B)"))
    time_fused(torch, ck, timer, gen, ERNIE_B * ERNIE_T, 768, torch.float32,
               False, "ernie (path A)")
    blaunches, _, on_ms = train_main(torch, ck, flags, card, fused=True)
    say("train step, gpt2-small B=%d T=%d O2 bf16 (%s): fused flags off "
        "%.2f ms, on %.2f ms (median of %d steps each, this run)"
        % (TRAIN_B, TRAIN_T, card, off_ms, on_ms, TRAIN_STEPS))
    train_compare(torch, ck, flags, fused=True)

    lap("phases 12-13, path B")

    # 14-15. path A: ERNIE-base pretraining, then kernels vs plain
    alaunches = ernie_main(torch, ck, flags, card)
    ernie_compare(torch, ck, flags)

    lap("phases 14-15, ERNIE")

    # 16. guards and eval on the training main path
    free_memory(torch)
    guards_main(torch, ck, flags, card, off_ms, tlaunches)

    lap("phase 16, guards and eval")

    # 17. resumable training: schedule, clip, checkpoints, preemption
    free_memory(torch)
    resume_main(torch, ck, card, off_ms, tlaunches)

    lap("phase 17, resumable training")

    # 18. float16 on the card, GradScaler, the other optimizers
    free_memory(torch)
    f16_times, f16_off, f16_on = f16_main(torch, ck, F, flags, timer, gen,
                                          shapes, card)
    times.update(f16_times)
    scaler_main(torch, ck, card)
    ernie_lamb(torch, ck, flags, card)
    optimizer_sweep(torch, ck, flags, card)

    lap("phase 18, float16, GradScaler, the optimizers")

    # 19. ResNet-50 on the card
    free_memory(torch)
    resnet_ms = resnet_main(torch, ck, flags, card)

    # 20. Model.fit on the card
    free_memory(torch)
    fit_main(torch, ck, card, off_ms, tlaunches, resnet_ms)

    # 21. GPT-2 long context: the flash kernels at T=8192, bench_gpt2_long,
    # the blockwise tier
    free_memory(torch)
    long = long_main(torch, ck, F, flags, card)

    # 22. the static graph and the predictor: row 1 at BERT's shape, static
    # ResNet-50 training, the ResNet-50 and BERT-base predictors
    free_memory(torch)
    stat = static_main(torch, ck, F, flags, card)

    # 23. the encoder-decoder Transformer: the kernels at its shapes,
    # Transformer-base training, cached greedy decoding, the fused block
    # functions
    free_memory(torch)
    nmt = nmt_main(torch, ck, F, flags, card)

    # 24. the recurrent family: the recurrence against cuDNN, the large
    # LSTM language model in float32 and bfloat16
    free_memory(torch)
    rnn = rnn_main(torch, ck, card)

    # 25. the tensor-op surface on the card and GPT-2-small-MoE training
    free_memory(torch)
    moe = moe_main(torch, ck, flags, card, timer, gen)

    # 26. the rest of nn on the card and the improved-DDPM CIFAR-10 UNet
    free_memory(torch)
    unet = unet_main(torch, ck, F, flags, card, timer, gen)

    # 27. row-sparse gradients, the legacy op surface and DLRM
    free_memory(torch)
    dlrm = dlrm_main(torch, ck, flags, card)
    lap("phases 19-27 (each timed above)")

    counts = {"flash_fwd": (launches["flash_fwd"] + slaunch_a["flash_fwd"]
                            + slaunch_b["flash_fwd"]
                            + slaunch_c["flash_fwd"]
                            + stat["float32"]["launches"]),
              "paged_decode": (launches["paged_decode"]
                               + slaunch_a["paged_decode"]
                               + slaunch_b["paged_decode"]),
              "paged_decode_int8": (launches8["paged_decode_int8"]
                                    + slaunch_c["paged_decode_int8"])}
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                 "adamw", "dropout_keep"):
        counts[name] = (tlaunches[name] + long["launches"][name]
                        + nmt["train"][name])
        say("launches %s: %d on the training main path (phase 10), %d on "
            "the long-context path (phase 21 (b)), %d in Transformer-base "
            "training (phase 23 (b))"
            % (name, tlaunches[name], long["launches"][name],
               nmt["train"][name]))
    counts["dropout_keep"] += rnn["launches"]["dropout_keep"]
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                 "adamw", "dropout_keep"):
        counts[name] += moe["launches"][name]
        say("launches %s: %d in GPT-2-small-MoE training (phase 25 (b)), "
            "counted in" % (name, moe["launches"][name]))
    say("launches dropout_keep: %d in the LSTM language model's training "
        "(phase 24 (b)), counted in above" % rnn["launches"]["dropout_keep"])
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                 "adamw", "dropout_keep"):
        counts[name] += unet["launches"][name]
        say("launches %s: %d in the UNet's training (phase 26 (b)), counted "
            "in" % (name, unet["launches"][name]))
    counts["adamw"] += dlrm["launches"]["adamw"]
    say("launches adamw: %d in DLRM's lazy Adam steps (phase 27 (b2)), "
        "counted in" % dlrm["launches"]["adamw"])
    for name in FUSED_KERNELS:
        counts[name] = (blaunches[name] + alaunches[name]
                        + nmt["train"][name])
        say("launches %s: %d on path B (gpt2, fused flags), %d on path A "
            "(ernie), %d in Transformer-base training (phase 23 (b))"
            % (name, blaunches[name], alaunches[name], nmt["train"][name]))
    for name in F16_ORDER:
        counts[name] = f16_off[name] + f16_on[name]
        say("launches %s: %d with the fused flags off, %d on path B (gpt2 "
            "f16)" % (name, f16_off[name], f16_on[name]))
    table = [{"name": name, "route": "cuda",
              "source": SOURCES[name.replace(ck.F16, "")],
              "replaces": TPU_KERNELS[name.replace(ck.F16, "")],
              "launches": counts[name],
              "max_abs_err": errs[name], "ms": times[name]["ms"],
              "plain_ms": times[name]["plain_ms"],
              "bound_ms": times[name]["bound_ms"],
              "bound_by": times[name]["bound_by"],
              "library_ms": times[name]["library_ms"]}
             for name in KERNEL_ORDER + F16_ORDER]
    row1 = next(e for e in table if e["name"] == "flash_fwd")
    row1["buckets"] = times["flash_fwd"]["buckets"]
    keys = ("B", "H", "T", "D", "causal", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    row1["static_bert"] = {k: stat["float32"][k] for k in keys}
    # the bfloat16 predictor's attention: flash_fwd's tensor-core instance
    # (row 1t's body, no lse), launched only by phase 22 (d)
    b16 = stat["bfloat16"]
    # ... and phase 23 (c)'s cached decoding, whose flash calls are all
    # this instance (bfloat16, no lse: counted as flash_fwd by the wrapper)
    table.append(dict(
        name="flash_fwd_bf16", route="cuda", source=SOURCES["flash_fwd"],
        replaces=TPU_KERNELS["flash_fwd"],
        **{k: b16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        launches=b16["launches"] + nmt["decode"]["flash_fwd"],
        static_bert={k: b16[k] for k in keys},
        nmt_decode=nmt["kernels"]["flash_fwd_bf16"]))
    say("launches flash_fwd: %d on the serving paths (phases 5, 8), %d in "
        "the float32 BERT predictor (phase 22 (c)); flash_fwd_bf16: %d in "
        "the bfloat16 BERT predictor (phase 22 (d)), %d in cached decoding "
        "(phase 23 (c))"
        % (counts["flash_fwd"] - stat["float32"]["launches"],
           stat["float32"]["launches"], b16["launches"],
           nmt["decode"]["flash_fwd"]))
    for e in table:                     # phase 23 (a) at the new shapes
        name = e["name"]
        if name in nmt["kernels"] and name != "flash_fwd_bf16":
            e["nmt"] = nmt["kernels"][name]
            if name == "fused_dropout_residual_fwd":
                e["nmt_check_launches"] = nmt["fused"]["pre-LN"][
                    "layer_launches"][name]
    adamw_row = next(e for e in table if e["name"] == "adamw")
    adamw_row["moe"] = dict(launches=moe["launches"]["adamw"],
                            **moe["adamw"])
    keep_row = next(e for e in table if e["name"] == "dropout_keep")
    keep_row["ptb"] = dict(shape=[PTB_B, PTB_T, PTB_HIDDEN], p=PTB_DROPOUT,
                           launches=rnn["launches"]["dropout_keep"],
                           **rnn["keep"])
    steps = TRAIN_WARMUP + TRAIN_STEPS
    keep_row["unet"] = dict(shape=[UNET_B, UNET_CH, UNET_HW, UNET_HW],
                            p=UNET_DROPOUT,
                            launches=unet["launches"]["dropout_keep"],
                            **unet["keep"])
    adamw_row["unet"] = dict(dtype="float32",
                             launches=unet["launches"]["adamw"],
                             **unet["adamw"])
    adamw_row["dlrm"] = dict(dtype="float32",
                             launches=dlrm["launches"]["adamw"],
                             step_ms=dlrm["b2"]["step_ms"])
    for e in table:                     # rows 1t, 2, 3 at the UNet's shapes
        if e["name"] in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv"):
            e["unet"] = [dict(unet["flash"][T][e["name"]],
                              launches_a_step=unet["launches"][e["name"]]
                              // steps) for T in (256, 64, 16)]
    for e in table:                     # rows 1t, 2, 3 at phase 21's shape
        if e["name"] in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv"):
            e["long_context"] = [dict(
                B=LONG_B, H=LONG_H, T=LONG_T, D=LONG_D, p=p,
                launches=long["launches"][e["name"]],
                max_abs_err=long["errs"][(e["name"], p)][0],
                **{k: long["times"][p][e["name"]][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}) for p in (DROPOUT, 0.0)]
    say(card)
    say(json.dumps({"kernels": table, "no_pallas_counterpart": {
        "19": "ResNet-50: cuDNN convolutions, composed batch norm and "
              "pooling; the reference reaches no pl.pallas_call on this "
              "path, so phase 19 launches none of the kernels above",
        "24": "the rnn op: composed ops over cuBLAS GEMMs, as the "
              "reference's lax.scan over composed XLA ops; its dropouts "
              "launch dropout_keep (counted above)",
        "25": "the op surface (ops/math, manipulation, creation, linalg, "
              "random_ops) and the MoE layer: torch ops over cuBLAS and "
              "cuSOLVER, as the reference's are XLA ops; GPT-2-small-MoE "
              "training launches rows 1t, 2, 3, 7 and K (counted above)",
        "26": "the rest of nn (ops/nn_ops.py: transposed convolutions over "
              "cuDNN, norms, resampling, pads, CTC, sequence ops): torch "
              "ops, as the reference's are XLA ops; the UNet's training "
              "launches rows 1t, 2, 3, 7 and K (counted above)",
        "27": "row-sparse gradients (SelectedRows, sparse SGD's index_add_, "
              "lazy Adam's merge and row updates), ops/misc_ops.py, fft, "
              "signal, distribution, fluid: torch ops, as the reference's "
              "are XLA ops; DLRM's lazy Adam steps launch row 7 (counted "
              "above)"}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
