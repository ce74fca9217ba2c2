#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. environment: versions, the card, its power limit;
  2. build the CUDA kernels from flexflow_tpu_torch/kernels/csrc with nvcc,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card: the
     optimizer updates at AlexNet's largest leaf, a ragged size and a
     misaligned view, and the multi-tensor SGD step over a ragged list of
     leaves aligned differently and over 130 leaves (three launches); then
     timed per step: SGD as one launch over AlexNet's 16 leaves and over
     the transformer's 54, Adam one launch per AlexNet leaf; the
     flash-attention forward, dK/dV and dQ kernels causal and not, bf16
     and f32, at the transformer's shape (16, 8, 512, 64), ragged S (1, 65,
     300, 1000), Sq != Sk and head dims 16, 32 and 128, with a non-zero lse
     cotangent (f32 once; bf16 causal at S 300, at Sq != Sk both ways and
     at head dims 16, 32 and 128), then timed at the transformer's shape
     (and at head dim 16); each beside its bound, the plain version and the
     library call; the optimizer kernels read lr/alpha_t from a scalar
     vector on the card, and a set skip flag leaves their operands bitwise;
  4. the main paths: full-width AlexNet (3x229x229, batch 256, bf16, fused
     optimizer) trained with SGD then Adam, and the full-width decoder
     transformer (batch 16, S 512, 4 layers, E 512, 8 heads, vocab 32000,
     bf16, fused SGD) trained through FFModel's compiled step (one CUDA
     graph: the first step eager, the second captured, then replays), the
     wrappers' launches checked at the eager step and the capture, and a
     device-time breakdown of each with the launches per step (one SGD
     launch per step) counted exactly (``ExactLaunches``: the wrappers'
     eager launches plus each replay times its captured graph's kernel
     nodes, from CUDA's debug dump; ROADMAP C15), the profiler's count of
     its kernel events printed beside it;
  5. path parity: f32 AlexNet at batch 8, two steps with the fused kernels
     and two with the plain update; an f32 transformer (batch 2, S 128, 2
     layers), two steps through the flash kernels and two through their
     plain versions; every weight compared;
  6. SOAP: an NCCL process group of one rank per visible card (this
     script started again as each helper rank; world size 1 on a machine
     of one card), and on its mesh (DTensor parameters, ops on local
     shards) full-width AlexNet under strategies/alexnet_16.pb legalized
     onto the mesh (SGD momentum 0.9, then Adam) and the full-width
     transformer under data parallelism, each
     2 warm-up and 5 timed steps beside the single-device path in the same
     run, with the kernels' launches checked per step (1 K1; 16 K2 with
     Adam; 4 each of K3-K5), the device busy share of both paths, and the
     weights after 2 f32 steps held against the single-device path's
     (the single-device runs on the lead rank's card), both paths eager;
  7. the compiled step: for full-width AlexNet (SGD, Adam) and the
     transformer, the compiled and the eager step in turns (ms/step,
     device ms/step, busy share, launches per step by the exact count);
     remat against plain (weights, max_memory_allocated); f32 state after
     3 steps compiled vs eager (Adam with next_epoch() between replays);
     grad_accum_steps 4 vs 1; a batch with an inf through the guard on a
     replay (w, m, v bitwise unchanged); save after 2 steps, load into a
     fresh model and 2 more steps against 4 uninterrupted;
  8. the strategy search: (a) the calibration tool times a ladder of
     pinned host<->device copies (1, 8 and 64 MiB) and fits the host link's
     rate and latency, then times every op of both
     cells, forward and backward, at their data-parallel sub-shapes of 1,
     2, 4 and 8 parts on the card (the attention measurements launch K3-K5,
     checked by count) and fits the roofline; (b) each cell's
     data-parallel step on one card simulated from that table and from the
     fit alone, beside phase 7's compiled step and phase 6's eager SOAP
     step, and the predicted memory beside phase 4's peak (when phases 4,
     6 and 7 ran); (c) full-width AlexNet through
     compile(search_budget=...) with the mcmc, population, native and ""
     (which must run native) engines on the default machine (one card, no
     process group, so that its steps are the compiled ones), and the
     full-width transformer (Adam) under "native" through K2-K5, 3
     compiled steps each, the exported strategy loaded back; (d) the
     offline search of both cells for an 8-GPU node by mcmc, population
     and native, every config composable over the port's 8-device mesh and
     accepted by its op's check_config (an attention sequence split runs as
     a ring).  ``--calibration-out DIR`` keeps the
     measured cache and the fit (measured_h100.json, machine_h100.json);
  9. the rest of the zoo at full width through the compiled step
     ([models] lines): ResNet-50 (batch 64, 229x229), Inception-v3 (batch
     128, 299x299), DLRM (batch 256, 8 tables of 1,000,000 x 64 on the
     card), CANDLE-Uno (batch 256), NMT (batch 64, seq 20, hidden 2048,
     vocab 20480, Adam) and the MoE transformer (phase 4's transformer
     with 8 experts every 2nd layer), bf16: the wrappers' launches at the
     eager step and the capture, compiled and eager ms/step in turns,
     profiled device ms, busy share and launches per step, the optimizer
     kernel's time against its byte bound, max_memory_allocated, the rate;
     f32 weights after 2 steps compiled vs eager and kernels vs plain
     versions (the MoE transformer at 2 layers); then [search] lines:
     each model's DP-1 step simulated from its own ops measured on the
     card against the compiled step, and an 8-GPU offline search whose
     configs the training path must accept;
 10. decoding and serving ([decode] and [serve] lines), bf16 unless
     said: (a) the transformer's greedy generate (B16, P 256, N 256)
     through its captured decode graph against the eager steps (equal),
     ms a step, tokens/s, capture ms, profiled device ms and launches a
     step; (b) beam_search (K4, B4, P 64, N 64) and sampled generate
     (B16, P 64, N 64, T 0.8, top-k 50, top-p 0.9, a fixed seed) graphed
     against eager, every
     sampled token within its step's top-k; (c) the MoE transformer (B16, P
     128, N 128) and NMT greedy_translate (B64, 20 tokens) graphed against
     eager; (d) the InferenceEngine dense then paged (max_batch 16, max_seq
     512, block 16), warmed up, serving 64 random requests and 8 sharing a
     128-token prefix, all submitted at once: generated tokens/s, TTFT and
     TPOT p50/p99, prefix hits, graphs captured (none after the warm-up),
     the KV pool's bytes, peak memory; dense == paged for every request;
     (e) the ServingAPI on an ephemeral port before an engine that captures
     in its worker thread (8 POST /generate equal the engine's tokens,
     /healthz and /readyz 200); no kernel launches on these
     paths; then the f32 oracle: one full-sequence forward (K3) over (a)'s
     prompt and f32-generated tokens, whose argmax must be each decoded
     token or within F32_GAP_TOL of it; every token of (a)'s bf16 generate
     and of each engine request against the f32 model's full forward over
     the same tokens, within BF16_GAP_TOL at every generated position; and
     each engine request against generate, a differing one within
     BF16_GAP_TOL at its first difference;
 11. observability ([obs] lines): phase 4's transformer, 20 compiled steps
     untraced, then with FF_TELEMETRY=1 FF_HEALTH=1 FF_MEMPLANE=1
     FF_OPPROF=10 and FF_METRICS_PORT (a temporary trace and opprof corpus):
     (a) losses and every weight bitwise equal, ms/step by CUDA events on
     and off (not gated); (b) the median step span and samples/s within
     10% of that ms/step, MFU in (0, 1) (every dense row counted),
     hbm_bytes in (0, 80e9]; (c) one capture at train_step in the ledger,
     its own graph pool's bytes above 0, no retrace; (d) opprof measured
     every attention op, K3-K5 each launched 7 times more per op than
     untraced; (e) GET /metrics 200 with ff_ lines; (f) trace_report folds
     one step span per step; (g) full-width AlexNet under
     FF_SKIP_NONFINITE, a NaN batch replayed: one health nonfinite_loss and
     one step_skipped event, every weight bitwise unchanged; (h) phase
     10's engine, 16 requests untraced then traced (FF_TRACE_SAMPLE=1,
     FF_MEMPLANE=1): equal tokens, a trace id and one serve_request_done
     per request, no capture after warmup() and each capture's graph pool
     above 0 bytes, the API's /metrics 200;
 12. the replica pool ([pool] lines), phase 10's model and paged engine
     (max_batch 16, max_seq 512, block 16), bf16: (a) ReplicaPool(lm,
     replicas=1, then 3), warmed up, over phase 10's 72-request burst:
     generated tokens/s, TTFT and TPOT p50/p99, graphs captured per
     replica (none after the warm-up), each replica's KV pool and graph
     pool bytes, memory; (b) three replicas, serve:36=replica_kill mid-
     burst: every request resolved exactly once, one replica down, its
     restart capturing its graphs while the survivors decode, the dead
     incarnation's graphs and caches dropped, KV refcounts 0 on every
     incarnation; (c) serve:8=replica_hang:3 with a 1 s replica timeout:
     marked down, its requests failed over, its stale attempts losing the
     CAS when it wakes; (d) hedging at 20 ms: every request hedged, one
     winner, the losers' slots freed; (e) ServingAPI before a one-replica
     pool with max_queue 2: 40 concurrent POSTs, the overflow 503 with
     Retry-After, /healthz per replica, /metrics ff_replica_up, 503 once
     drained; (f) testing/fleet.py's zone_outage (zones zone-a,zone-b,
     4 replicas) over phase 10's 72 requests arriving in 3 s: the
     autoscaler restores the ready count in the surviving zone (time to
     recover, offered and attained requests/s at a 10 s end-to-end SLO);
     (g) memory_allocated, after gc.collect() and empty_cache(), back
     within one replica's footprint of its level before the pools.
     Every request of (a)-(f) is held against generate and the f32 oracle
     under BF16_GAP_TOL; the pool launches no kernel;
 13. sequence parallelism, dropout and BatchNorm ([seq] lines): (a) ring
     (2 and 4 shards) and Ulysses (4) attention at the transformer's shape
     (16, 8, 512, 64), bf16 and f32, causal and not, the shards in
     lockstep in one process on the package's per-step function and
     merge (only the K/V exchange is this script's): O, dq, dk, dv against
     the unsplit K3-K5 path and, in f32, against mha_reference autograd;
     K3-K5 launches per direction (a causal 4-shard ring 10 each, 16
     otherwise); forward + backward ms beside the unsplit call and SDPA;
     (b) with more than one card, the full-width transformer with every
     attention op's sequence split over the cards as a ring and as
     Ulysses, f32 weights after 2 steps against the single-device path and
     bf16 ms/step beside data parallelism (one card: a line says it was
     not run); (c) the full-width transformer with attention dropout 0.1
     through the compiled step: a new mask on every replay (lr 0, one
     batch, 4 distinct losses equal to the eager path's), compiled and
     eager f32 states bitwise equal after 3 steps, remat against plain,
     launches per step unchanged (4 each of K3-K5, 1 of K1), ms/step
     beside dropout 0; (d) conv 7x7/2 -> BatchNorm(ReLU) at ResNet-50's
     stem (batch 64, 229x229x3, 64 channels): running stats bitwise equal
     compiled vs eager after 3 f32 steps, a NaN batch under the guard
     leaves weights and stats bitwise, save then load carries the stats;
     the MSELoss op against float64; examples/pca.py's graph of constants
     trains 20 compiled steps and its loss falls;
 14. the elastic runtime ([elastic] lines): (a) testing/chaos_smoke.py's
     recovery drill on full-width AlexNet (batch 256, bf16, Adam, fused,
     fed by a prefetching DataLoader over 3 seeded batches), 3 epochs of
     3 steps under FF_SKIP_NONFINITE=5: a NaN step in the baseline and the
     victim, the victim preempted by SIGTERM at step 5 with a failing
     checkpoint write, its resume in a fresh model bitwise equal to the
     baseline, no partial file, the trace narrating every recovery, K2's
     launches per run those of an eager step and a capture; checkpoint
     bytes and save seconds; (b) the full-width transformer with dropout
     0.1 preempted at step 5 and resumed bitwise (C8); (c) recompile with
     the same map on the compiled step (f32, 2 layers) bitwise a no-op,
     memory_reserved after 3 more swaps within one graph pool; (d) a
     divergence swap at step 6 rolled back by a planted regression
     (FF_RECONFIGURE, resharding:7=divergence:0.15), its two .pb records
     diffed; (e) StepWatchdog(2) over sync:1=hang:5 raising in 2-3 s, then
     AlexNet fed by the DataLoader with and without prefetch: the same
     weights after 6 shuffled steps with a reset mid-epoch, ms/step and the
     data_wait span in turns; (f) with several cards, chaos_smoke's reshard
     on up to four (one process a card, NCCL): half the ranks lost after
     step 4 and regained after step 7, swaps at 6 and 9 on every rank,
     every rank's weights equal to the same job's on one card with no swap
     (rtol 1e-5, atol 1e-6), two runs bitwise equal (one card: a line says
     it was not run);
 15. pipelines and host-resident tables ([pipe] lines): (a) the
     full-width transformer's 4 blocks as 4 GPipe stages of 4 microbatches
     in lockstep on one card (parallel/pipeline.py's schedule; only the
     hop is a hand-off in one process), with and without remat, bf16 and
     f32: O, dx and every block weight's gradient against the unpipelined
     blocks (f32 O and dx rtol atol 1e-4, weight gradients 1e-4 of their
     largest magnitude; bf16 8 bf16 steps relative to each tensor's
     largest magnitude), K3-K5 launches per direction (16 each,
     16 more K3 in the backward with remat), fwd+bwd ms in turns; (b)
     pipeline_mlp, 8 stages of 4096 x 4096 at batch 256, degree 1, through
     the compiled step: bf16 ms/step, the profiler's launches (one K1 a
     step), f32 compiled == eager bitwise; (c) the hetero DLRM (batch 256,
     8 tables of 1,000,000 x 64 in pinned host memory, row-sparse; the
     MLPs on the card) through the compiled step, configured by (d) the
     ``tools/dlrm_strategy.py --hetero`` file: f32 weights after 3 steps
     against phase 9's on-card DLRM, untouched rows bitwise, peak
     memory_allocated below the tables' bytes, bytes a step each way,
     graphs captured (one per bucket), a guarded NaN step leaving the
     host rows bitwise, save and load; bf16 ms/step in turns with the
     on-card model and with a synchronous scatter-back; forced-lazy Adam
     (K2) and momentum in auto mode (the tables stream); (e) with several
     cards, the full-width transformer under set_pipeline(num_stages=4,
     num_microbatches=4) and the hetero DLRM with its MLPs pipelined, one
     NCCL rank a card: f32 weights after 2 steps against one card
     unpipelined, bf16 ms/step beside data parallelism (one card: a line
     says it was not run);
 16. the JAX package's whole SOAP space ([soap2] lines): (a) each new
     split as its parts in lockstep on one card, in f32 against the
     unsplit op (the output and every input and weight gradient within
     1e-4 of the unsplit op's largest magnitude), then bf16 fwd+bwd ms
     in turns beside it: conv and pool tiles (AlexNet's conv1 and pool1,
     an avg pool at pool1's window, ResNet-50's stem conv and max pool,
     at batch 64; each op split on height, width and both by the degrees
     its output allows: conv1 4, pool1 3, the stem 5, ResNet's pool 2),
     every conv tile's input its ``input_ranges`` rectangle; NMT's LSTM
     (batch 64, seq 20, hidden 2048, with hx/cx) split 2 and 4 on the
     hidden dim; the MoE transformer's ExpertMLP (8 experts, 16 x 512
     tokens) at capacity factor 0.5 under ep 2, ep 4 and dp 2 x ep 2,
     the dropped tokens the unsplit op's; (b) ZeRO-1 on AlexNet's 16
     leaves over 4 ranks in lockstep: K1 (SGD momentum 0.9, one launch a
     rank) and K2 (Adam, one a slice) on each rank's 1/4 row slice of the
     10 leaves whose leading dim divides, bitwise equal to the whole-leaf
     launch, each rank's slice update timed beside it; (c) full-width
     AlexNet and NMT through compile(search_budget=...) on one card and 3
     compiled steps, then offline searches of AlexNet, NMT, the MoE
     transformer and DLRM for 8 and for 2 x 8 GPUs, every config accepted
     by its op and composable over the port's (hybrid) mesh, the configs
     that split a conv or pool spatially, an LSTM's hidden dim or the
     experts, or place a table on the host counted; (d) with several
     cards (one NCCL rank a card, up to 4): NMT with its LSTMs split on
     the hidden dim, the MoE transformer's experts over the cards,
     AlexNet under strategies/alexnet_16.pb legalized onto them (conv1
     split on height and width), AlexNet Adam with zero_optimizer (its
     state bytes per rank) and a hybrid 2 x 2 mesh (num_nodes=2): f32
     weights after 2 steps against one card, bf16 ms/step beside data
     parallelism (one card: a line says it was not run);
 17. decoding on a mesh ([mesh-decode] lines): (a) a one-rank NCCL mesh in
     the lead process: the full-width transformer (4x512, 8 heads,
     vocab 32000) in f32, decode_step probabilities step by step (rtol
     1e-5, atol 1e-6), greedy generate (B16, P 32, N 32) and beam_search
     (K4, B4, P 16, N 16) against the same model on one card (tokens
     equal, scores rtol 1e-5), then the paged engine over 10 of phase 10's
     requests (its first 8 and 2 that share its prefix, in its order),
     each request equal to one card's, tokens/s, TTFT and TPOT
     p50/p99 and the batch's occupancy beside one card's; in bf16 generate against one card's (a difference within
     F32_GAP_TOL under the f32 forward), ms, device ms and launches a
     decode step, eager on the mesh beside the captured one-card step;
     (b) with several cards, one NCCL rank a card (up to 4): the
     transformer with its heads and dense columns split over them,
     generate and the engine (dense, paged; its first 32 and the 8 that
     share its prefix) in f32
     equal to one card's, NMT (batch 64, seq 20, hidden 2048) with its LSTMs split on the
     hidden dim (greedy_translate) and the MoE transformer with its
     experts over the cards (generate), each equal to one card's (one
     card: a line says it was not run), on a group the lead forms after
     (a)'s was shut down.  No kernel of K1-K5 runs on these paths
     (checked);
 18. a replica pool over slices of cards ([slices] lines; the slices are
     this script started again, a process a card, each slice a world of
     its own formed through the pool's SliceHub, the f32 LM's weights
     carried in from the lead's): (a) on one card, a local captured
     engine, a remote one-card replica (captured) and a remote one-rank
     NCCL mesh replica (eager) over TRAFFIC's first 48 requests
     (max_batch 8: 2 x max_batch a replica), each request's f32 tokens
     held against one card's generate (a difference only at an f32
     near-tie), tokens/s, TTFT and TPOT p50/p99, occupancy and card bytes
     per process; then exactly once through each drill: a remote
     leader's replica_kill and its restart in place, a SIGKILLed slice
     process (the slice lost, a spare added through add_replica), an
     Autoscaler's scale-up onto a spare and the scale-down returning it,
     a hedge whose losing attempt, remote, is cancelled on its leader;
     times to recover; (b) with four cards, two slices of two cards (the
     LM's heads and dense columns split 2) and two spare slices,
     max_batch 4 over 16 requests: ROADMAP C11 (a fault planted on a
     follower before its step's collectives ends every rank of that
     slice within the replica timeout plus SLICE_MARGIN_S, under process
     groups whose own timeout is SLICE_PG_TIMEOUT_S) and C10 (that slice
     re-forms its NCCL world in its living processes and serves again),
     then (a)'s drills (one card: a line says it was not run).  No kernel
     of K1-K5 runs on the pool's paths (checked).

 19. the native engines ([native] lines): (a) the g++ version and the
     build seconds of native/ffsim.cpp and native/ffsearch.cpp; for each
     model of the zoo at full width on an 8-GPU node, the C++ event loop
     against the plain Python loops bitwise on the task graphs of data
     parallelism and of the native winner, the annealer's dp and best
     against the Python simulator (rel 1e-9), and proposals/s of native
     against mcmc at one budget on this host; full-width AlexNet
     compile(search_budget=..., search_engine="native") on the card: the
     winner's simulated ms against its measured ms/step; (b) with several
     cards (one NCCL rank a card, up to 4): the same compile on every rank,
     one strategy map on every rank (strategies_fingerprint), 3 eager mesh
     steps, simulated against measured ms/step (one card: a line says it
     was not run);
 20. the observability tools on the card ([tools] lines): (a) the doctor
     as a user runs it (exit 0, its accelerator line naming the card
     nvidia-smi names, ffsim and ffsearch built); (b) chipwatch: the probe
     ok with the card's name, a probe sleeping past its 2 s deadline
     killed and reported within 5 s, both in a trace, the committed
     measured_h100.json and machine_h100.json byte-identical before and
     after the phase (the measurement window chipwatch converts is cut
     for the script's time: tests/test_torch_chipwatch.py holds it, phase
     8 the calibration on the card); (c) profile_report of the full-width
     transformer (batch 16, S 512, bf16) and AlexNet (batch 256): a row
     per op, forward and backward above 0, K3-K5 launched (warm-up +
     timed iterations) times per attention op, the standalone sums beside
     phase 7's compiled ms/step; (d) opbench's suite of 12 ops in bf16 and
     f32; (e) a trace taken with FF_TELEMETRY, FF_MEMPLANE=1 and
     FF_TRACE_SAMPLE=1 of 4 compiled transformer steps and 8 requests
     through a captured engine: memory_report's predicted, captures and
     live sections (the train_step pool equal to StepGraph.pool_bytes, the
     live peak to the last hbm_bytes gauge, each ratio printed), and
     timeline_export's JSON (every B with its E; training, serving and
     requests tracks); (f) soap_report of AlexNet at its canonical scale
     (16 GPUs, batch 64, bf16) on the host, the .pb loading, its keys to a
     temporary file;
 21. whole-graph lowering ([lower] lines; parallel/lowering.py): (a) on
     one card full-width AlexNet (batch 256) and the transformer (batch
     16, S 512), SGD, lowered (one torch.compile region a step, inductor,
     K3-K5 as custom ops inside it, captured by StepGraph) against the
     captured per-op step; the transformer in f32 from the same weights
     (cut to LOWER_F32_LAYERS layers; AlexNet's f32 parity is cut for the
     script's time, (c) holds its lowered f32 step on four cards):
     through inductor, per leaf, the
     first step's gradient, both gradients at per-op's weights after 3
     steps, the update and the optimizer slots within LOWER_MOVE_RTOL of
     per-op's norm, the weights within LOWER_TOL; through aot_eager (no
     fusion) the gradients and the 3 steps bitwise equal to per-op's;
     then bf16: the first step's wall (the lowered one compiles), one
     graph compiled, ms/step in turns, losses within LOWER_LOSS_RTOL of
     per-op's, device ms by kernel family,
     launches a step by the exact count (K1 1; K3-K5 4 each on the
     transformer); (b) a bad FF_LOWERED raises at compile, num_nodes=2
     lowers by default and FF_LOWERED=0 does not; (c) with several cards
     (one NCCL rank a card, up to 4) the transformer split by heads and
     columns and, on four, AlexNet on the hybrid 2 x 2 mesh (num_nodes=2,
     lowered by auto), each lowered against the eager per-op mesh step:
     f32 weights after 3 steps and each leaf's update within
     LOWER_MOVE_RTOL of per-op's norm, eval_batch's counts equal and its loss
     within LOWER_EVAL_RTOL, greedy generate's tokens equal (the mesh
     decode step compiled too), graphs per site, bf16 ms/step and host ms
     a step in turns (one card: a line says it was not run);
 22. the frontends ([front] lines): (a) examples/native/alexnet_new.py's
     full-width graph (229x229, two 11x11 stems concatenated, linear1 9216
     -> 4096) built with the v2 builders and init_inout by a script that
     ``python -m flexflow_tpu_torch script.py -ll:gpu 1 -ll:fsize 14000 -b
     256`` runs: no -ll: flag in its argv, parse_args(None) batch 256, 5
     compiled bf16 steps' losses and weights bitwise those of the same
     graph through the plain calls from the same seed, K1 1 a step (exact),
     ms/step; (b) keras func_cifar10_alexnet at its widths, f32, Model.fit
     2 epochs of 512 synthetic samples (batch 64) with a
     LearningRateScheduler halving lr at epoch 1, every weight against the
     same graph and weights driven eagerly through train_iteration with the
     same schedule (rtol 1e-4, atol 1e-5), K1 1 a step (exact), the step's
     device lr, evaluate and predict; (c) keras Sequential seq_mnist_mlp
     with keras Adam, K2 6 a step (exact); (d) torch_frontend.nn's CNN, 3
     compiled steps.

``--phases 3,17`` runs only the phases listed (1 and 2 always run; the
kernels line needs phase 3); a phase's several-card part runs whenever
several cards are visible, so ``python3 chip_smoke.py --phases 17`` on a
host with four cards runs phase 17 (b).  The last lines are the card's name and
power limit, one JSON object with a row per kernel, and {"ok": true,
"device": {...}}.  Needs one card (phases 6, 14 (f), 15 (e), 16 (d),
17 (b), 18 (b), 19 (b) and 21 (c) use every visible card); it imports nothing of jax or
of the JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import gc
import glob
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # H100 SXM data sheet, dense tensor cores
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
PARITY_TOL = dict(rtol=1e-6, atol=1e-7)
# Adam's first step is uncorrected (alpha_t = alpha, as in the reference):
# every weight moves by about 3*alpha, and at alpha 1e-3 the loss leaps
# into the thousands before it recovers.  1e-4 keeps the run near its
# starting loss, so a finite loss on every step means something.
ADAM_ALPHA = 1e-4
SOURCE = "flexflow_tpu_torch/kernels/csrc/fused_optimizer.cu"
FLASH_SOURCE = "flexflow_tpu_torch/kernels/csrc/flash_attention.cu"
# the transformer of bench.py's transformer workload, at full width
LM = dict(batch=16, seq_length=512, num_layers=4, embed_dim=512, num_heads=8,
          vocab_size=32000)
LM_STEPS, LM_TIMED_FROM = 7, 2
# launches of each of this repo's kernels in one step of each main path
NO_LAUNCH = dict.fromkeys(("fused_sgd_update", "fused_adam_update", "flash_fwd",
                           "flash_bwd_dkdv", "flash_bwd_dq"), 0)
ALEX_SGD_STEP = {**NO_LAUNCH, "fused_sgd_update": 1}
ALEX_ADAM_STEP = {**NO_LAUNCH, "fused_adam_update": 16}
LM_SGD_STEP = {**NO_LAUNCH, "fused_sgd_update": 1, "flash_fwd": LM["num_layers"],
               "flash_bwd_dkdv": LM["num_layers"], "flash_bwd_dq": LM["num_layers"]}
# Flash kernels vs their plain versions on the same inputs.  f32: both sum
# the same f32 products in another order (FMA chains in the kernel, cuBLAS
# tiles with TF32 off in the plain version), about 1e-6 relative on sums
# of up to 512 terms.  bf16: both compute in f32 from the same bf16 inputs
# (the kernels' f32 P and dS enter the tensor cores as bf16 hi + lo pairs,
# about 2**-16 relative) and round the result to bf16 once, so they differ
# by at most one bf16 step (2**-8 relative) where the f32 values straddle
# a rounding boundary; lse stays f32 and keeps the f32 tolerance.
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
# f32 transformer, kernel path vs plain path after 2 SGD steps: the
# gradients differ only by the attention kernels' summation order.
LM_PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
# SOAP path vs single-device path after 2 f32 steps, one rank: the same
# kernels on the same tensors (DTensor adds only wrapping), so the same
# rounded operations, held at the fused-update parity tolerance.
SOAP_TOL = PARITY_TOL
# Over several cards the gradients' sums over ranks are taken in another
# order than one card's: the transformer parity tolerance of phase 5.
SOAP_MULTI_TOL = LM_PARITY_TOL
# Adam moves each weight by about alpha * 0.1 / sqrt(0.001) = 3.16 alpha
# a step whatever its gradient's size, so a gradient element near zero
# whose sign the other summation order flips can move the other way.  Four
# H100s read max |dw| 3.04e-5 = 0.3 alpha after 2 steps; atol 2 alpha sits
# under the 3.16 alpha by which one skipped update moves a weight.
SOAP_MULTI_ADAM_TOL = dict(rtol=1e-4, atol=2 * ADAM_ALPHA)
SOAP_HELPER = "FF_CHIP_SMOKE_SOAP_HELPER"  # set in the helper ranks' environment
# A rank that waits this long in the rendezvous or a collective fails the
# run instead of holding it (the lead rank's single-device runs, which the
# helpers wait through, take seconds).
SOAP_TIMEOUT = datetime.timedelta(seconds=300)
ALEXNET_STRATEGY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "strategies",
                                "alexnet_16.pb")


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


_sleep_cycles_per_ms = None


def hold_stream(ms):
    """Keep the current stream busy for about ``ms`` milliseconds (a
    spinning kernel), so that what the host queues behind it runs back to
    back."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        end.synchronize()
        _sleep_cycles_per_ms = 10**7 / start.elapsed_time(end)
    torch.cuda._sleep(int(_sleep_cycles_per_ms * ms))


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up.  A sleeping kernel holds the stream while the host queues
    the calls, so a call whose host side is slower than its device side (a
    wrapper over many leaves, a plain version of many small operations) is
    timed on the device, not paced by the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    hold_stream(2 * host_ms * iters + 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 3

def kernel_cases(fo, skip=False):
    """One dict per case: label, bytes moved per element, the SGD settings
    (None for Adam), a caller taking (update, w, g, m, v) with the kernel
    wrapper and plain version it is run with, and ``step(plain, leaves)``,
    one optimizer step over a list of (w, g, m, v) as the optimizer takes
    it: SGD one multi-tensor call, Adam one call per leaf.  lr and alpha_t
    come from a scalar vector on the card, as the optimizers pass them;
    with ``skip`` its skip flag is set."""
    scalars = fo.scalar_vector(1e-3, "cuda", skip=skip)

    def sgd(mu, nesterov):
        def call(update, w, g, m, v):
            update(w, g, m if mu > 0 else None, scalars, 1e-4, mu, nesterov)

        def step(plain, leaves):
            update = fo.fused_sgd_update_multi_ref if plain else fo.fused_sgd_update_multi
            ws, gs, ms, _ = (list(x) for x in zip(*leaves))
            update(ws, gs, ms if mu > 0 else None, scalars, 1e-4, mu, nesterov)
        return call, step

    def adam(update, w, g, m, v):
        update(w, g, m, v, scalars, 1e-4, 0.9, 0.999, 1e-8)

    def adam_step(plain, leaves):
        for leaf in leaves:
            adam(fo.fused_adam_update_ref if plain else fo.fused_adam_update, *leaf)

    cases = []
    for mu, nest in ((0.9, False), (0.9, True), (0.0, False)):
        call, step = sgd(mu, nest)
        cases.append(dict(label=f"fused_sgd_update mu={mu}{' nesterov' if nest else ''}",
                          bpe=20 if mu else 12, sgd=(mu, nest), call=call, step=step,
                          kernel=fo.fused_sgd_update, plain=fo.fused_sgd_update_ref))
    cases.append(dict(label="fused_adam_update", bpe=28, sgd=None, call=adam, step=adam_step,
                      kernel=fo.fused_adam_update, plain=fo.fused_adam_update_ref))
    return cases


def operands(n, gen):
    """w, g, m, v of n elements on the card (v >= 0)."""
    return tuple(torch.randn(n, device="cuda", generator=gen).abs_() if i == 3
                 else torch.randn(n, device="cuda", generator=gen) for i in range(4))


def copy_at(t, offset):
    """A copy of ``t``; with offset 1 a view 4 bytes off 16-byte alignment."""
    return torch.cat([t.new_zeros(offset), t])[offset:] if offset else t.clone()


def check_kernels(fo):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = {"fc1_kernel_9216x4096": (9216 * 4096, 0), "ragged_1000003": (1_000_003, 0),
             "misaligned_view": (1_000_003, 1)}
    max_err = {}
    for case in kernel_cases(fo):
        for sname, (n, off) in sizes.items():
            ops = operands(n, gen)
            ka = [copy_at(t, off) for t in ops]
            check(ka[0].data_ptr() % 16 == 4 * off, f"{sname}: unexpected alignment")
            pa = [t.clone() for t in ops]
            case["call"](case["kernel"], *ka)
            case["call"](case["plain"], *pa)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(ka, pa))
            for a, b in zip(ka, pa):
                torch.testing.assert_close(a, b, **KERNEL_TOL)
            name = case["kernel"].__name__
            max_err[name] = max(max_err.get(name, 0.0), err)
            log(f"  check {case['label']:36s} {sname:22s} max_abs_err {err:.3e}")
    # a skipped step (the guard's flag in the scalar vector): the kernel and
    # the plain version leave every operand bitwise as it was
    n = 9216 * 4096
    for case in kernel_cases(fo, skip=True):
        ops = operands(n, gen)
        for update in (case["kernel"], case["plain"]):
            got = [t.clone() for t in ops]
            case["call"](update, *got)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ops)),
                  f"{case['label']}: a skipped step changed its operands")
        log(f"  check {case['label']:36s} skip flag set: w, m, v bitwise unchanged "
            f"(kernel and plain version)")
    return max_err


def main_path_leaves(ft, build_alexnet, build_transformer):
    """The parameter leaf shapes of both main paths' models, from their
    graphs built on the CPU (no parameter is allocated)."""
    alex = ft.FFModel(ft.FFConfig(batch_size=BATCH, device="cpu"))
    build_alexnet(alex, BATCH)
    lm = ft.FFModel(ft.FFConfig(batch_size=LM["batch"], device="cpu"))
    build_transformer(lm, LM["batch"], **{k: v for k, v in LM.items() if k != "batch"})
    return {name: [w.dims for op in g.ops for w in op.weights]
            for name, g in (("AlexNet", alex), ("transformer", lm))}


def check_sgd_multi(fo):
    """The multi-tensor SGD step against its plain version on the card: one
    launch over ragged leaves whose pointers are aligned differently (views
    at an odd offset beside aligned leaves, a zero-size leaf), and 130
    leaves, which take three launches."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ragged = [(1, 0), (7, 0), (165, 1), (0, 0), (108, 0), (1_000_003, 1), (65_536, 0),
              (16_385, 1), (9216 * 4096, 0)]
    many = [(1 + 977 * i, i % 2) for i in range(130)]
    worst = 0.0
    for lname, sizes in (("ragged, mixed alignment", ragged), ("130 leaves", many)):
        want = -(-sum(1 for n, _ in sizes if n) // fo.SGD_TABLE_CAPACITY)
        for case in kernel_cases(fo)[:3]:
            ops = [operands(n, gen) for n, _ in sizes]
            ka = [tuple(copy_at(t, off) for t in leaf) for leaf, (_, off) in zip(ops, sizes)]
            pa = [tuple(t.clone() for t in leaf) for leaf in ops]
            before = fo.fused_sgd_update.launches
            case["step"](False, ka)
            launches = fo.fused_sgd_update.launches - before
            case["step"](True, pa)
            torch.cuda.synchronize()
            check(launches == want, f"{lname}: {launches} launches, expected {want}")
            err = 0.0
            for kl, pl in zip(ka, pa):
                for a, b in zip(kl, pl):
                    torch.testing.assert_close(a, b, **KERNEL_TOL)
                    if a.numel():
                        err = max(err, (a - b).abs().max().item())
            worst = max(worst, err)
            log(f"  check {case['label']:36s} multi, {lname:24s} {len(sizes)} leaves, "
                f"{launches} launch(es)  max_abs_err {err:.3e}")
    return worst


def time_kernels(fo, leaf_sets, copy_gbps):
    """Per-step times over a main path's leaves, as the optimizer runs
    them: SGD one multi-tensor launch over all leaves (AlexNet's 16 in
    every setting, the transformer's 54 without momentum, as its main path
    trains), Adam one launch per AlexNet leaf."""
    rows = {}
    for set_name, leaf_shapes in leaf_sets.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        leaves = [operands(math.prod(s), gen) for s in leaf_shapes]
        for case in kernel_cases(fo):
            if set_name == "AlexNet" or case["sgd"] == (0.0, False):
                label = case["label"] + ("" if set_name == "AlexNet" else f" {set_name}")
                rows[label] = time_case(case, label, leaves, copy_gbps)
        del leaves
        torch.cuda.empty_cache()
    return rows


def time_case(case, label, leaves, copy_gbps):
    """One optimizer step of ``case`` over ``leaves``: kernel, plain version
    and library times beside the byte bound."""
    n_total = sum(leaf[0].numel() for leaf in leaves)
    k_ms = cuda_time_ms(lambda: case["step"](False, leaves), 20)
    p_ms = cuda_time_ms(lambda: case["step"](True, leaves), 5)
    nbytes = n_total * case["bpe"]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    params = [torch.nn.Parameter(leaf[0]) for leaf in leaves]
    for p, leaf in zip(params, leaves):
        p.grad = leaf[1]
    if case["sgd"] is not None:
        mu, nesterov = case["sgd"]
        opt = torch.optim.SGD(params, lr=1e-3, momentum=mu, weight_decay=1e-4,
                              nesterov=nesterov, fused=True)
        lib_ms = cuda_time_ms(opt.step, 20)
        lib_note = "torch.optim.SGD(fused=True)"
    else:
        # eps sits after the bias correction there: not the same function
        opt = torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4, fused=True)
        lib_ms = None
        lib_note = ("(torch.optim.Adam(fused=True), an approximate yardstick: "
                    f"{cuda_time_ms(opt.step, 20):.4f} ms)")
    log(f"  time  {label:48s} {len(leaves)} leaves  kernel_ms {k_ms:.4f}  "
        f"bound_ms {bound_ms:.4f} ({case['bpe']} B/elem x {n_total} elem at 3.35 TB/s; "
        f"{nbytes / copy_gbps / 1e6:.4f} ms at the measured copy rate)  "
        f"ref_ms {p_ms:.4f}  library_ms "
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} {lib_note}  "
        f"kernel rate {nbytes / k_ms / 1e6:.1f} GB/s")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, library_ms=lib_ms)


def host_us(fn, iters=200):
    """Host microseconds per call of ``fn`` (work the device is never the
    limit of)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def launch_diagnostics(fo, leaf_counts, biggest):
    """Separate kernel efficiency from per-launch cost: each kernel on the
    largest leaf alone; the host time of one wrapper call on a leaf small
    enough that the device is never the limit; and for SGD the host time
    of a whole optimizer step (one multi-tensor call) over as many such
    leaves as each main path has."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    big = operands(biggest, gen)
    tiny = [operands(64, gen) for _ in range(max(leaf_counts.values()))]
    for case in kernel_cases(fo):
        ms = cuda_time_ms(lambda: case["call"](case["kernel"], *big), 20)
        nbytes = big[0].numel() * case["bpe"]
        per_call = host_us(lambda: case["call"](case["kernel"], *tiny[0]))
        steps = "; ".join(
            f"host {host_us(lambda: case['step'](False, tiny[:n])):.1f} us per {name} step "
            f"({n} leaves, {'one launch' if case['sgd'] else f'{n} launches'})"
            for name, n in leaf_counts.items() if case["sgd"] or name == "AlexNet")
        log(f"  leaf  {case['label']:36s} fc1 kernel alone {ms:.4f} ms "
            f"(bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {nbytes / ms / 1e6:.1f} GB/s); "
            f"host {per_call:.1f} us per wrapper call on one leaf; {steps}")


# This repo's kernels by a piece of their compiled names (the profiler's
# kernel events), and the wrapper that launches each.
KERNEL_NAMES = (("sgd_kernel", "fused_sgd_update"), ("adam_kernel", "fused_adam_update"),
                ("flash_fwd", "flash_fwd"), ("flash_bwd_dkdv", "flash_bwd_dkdv"),
                ("flash_bwd_dq", "flash_bwd_dq"))


def kernel_of(event_name):
    """This repo's kernel a kernel's name (a profiler event's, a graph
    node's) is, or None.  Inductor names a Triton kernel after the ops it
    fuses, the custom ops K3-K5 among them, and is none of ours."""
    if event_name.startswith("triton"):
        return None
    return next((k for sub, k in KERNEL_NAMES if sub in event_name), None)


def node_launches(names):
    """Launches of each of this repo's kernels in a captured graph's kernel
    nodes (``StepGraph.kernel_names``): what one replay launches."""
    counts = {}
    for name in names or ():
        k = kernel_of(name)
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return counts


@contextlib.contextmanager
def kernel_nodes_kept(model):
    """Inside the block captures keep their kernel nodes
    (``StepGraph.record_kernels``), for ``ExactLaunches``; a model whose
    step was captured before without them is dropped, so that its next two
    steps (eager, capture) capture it again with them.  Every other
    capture of the script keeps nothing, as a user's does."""
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    g = model._step_graph
    if g is not None and g.graph is not None and not g.kernels_kept:
        g.drop()
    StepGraph.record_kernels = True
    try:
        yield
    finally:
        StepGraph.record_kernels = False


class ExactLaunches:
    """This repo's kernels' launches over a window of a model's steps,
    counted so that no launch can be lost (ROADMAP C15): the wrappers'
    counters (each eager launch, and a capture's recording), plus each
    replay of the model's captured step times the kernel nodes of its
    graph (taken as given: a replay runs every node; ``kernel_nodes_kept``
    keeps them), less one replay's nodes for a capture inside the window
    (its recording launched nothing).  A window may capture only a model
    that held no graph at its start, so that every replay in it is of
    that capture's graph."""

    def __init__(self, model):
        from flexflow_tpu_torch.kernels import flash_attention as fa
        from flexflow_tpu_torch.kernels import fused_optimizer as fo

        self.model, self.kernels = model, kernel_wrappers(fo, fa)

    def _graph(self):
        g = self.model._step_graph
        return (g.replays, g.captures) if g is not None else (0, 0)

    def __enter__(self):
        g = self.model._step_graph
        self.fresh = g is None or g.graph is None
        self.c0, self.g0 = read_launches(self.kernels), self._graph()
        return self

    def __exit__(self, *exc):
        c1, (replays, captures) = read_launches(self.kernels), self._graph()
        self.counts = {k: c1[k] - self.c0[k] for k in self.kernels}
        if exc[0] is not None:
            return False
        captured = captures - self.g0[1]
        check(captured == 0 or (captured == 1 and self.fresh),
              f"{captured} captures inside an exact launch window (a graph before it: "
              f"{not self.fresh})")
        if replays > self.g0[0]:
            g = self.model._step_graph
            check(g.kernel_names is not None, "the captured step kept no kernel nodes "
                                              "(captured outside kernel_nodes_kept)")
            for k, n in node_launches(g.kernel_names).items():
                self.counts[k] += n * (replays - self.g0[0] - captured)
        return False


def profile_steps(model, label, step_ms, steps=3, per_step=None, kernel_ms=None):
    """Device time by kernel family over a few steady steps of a main path's
    model, and its share of the unprofiled step time ``step_ms``; returns
    (device ms per step, busy share in %).  With ``per_step`` (launches of
    each of this repo's kernels a step), the exact count of the profiled
    steps' launches (``ExactLaunches``: the wrappers' eager launches and
    each replay's graph nodes) must equal it; the profiler's count of its
    kernel events is printed beside it (it can drop events, ROADMAP C15).
    ``kernel_ms``, a dict, receives each of this repo's kernels' device ms
    per step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with kernel_nodes_kept(model):
        for _ in range(2):
            model.train_iteration()
        model.sync()
        with torch.profiler.profile(activities=acts) as prof, ExactLaunches(model) as exact:
            t0 = time.perf_counter()
            for _ in range(steps):
                model.train_iteration()
            model.sync()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the aten ops above them carry the same time
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if kernel_ms is not None:
        for key, us, _ in rows:
            if kernel_of(key) is not None:
                kernel_ms[kernel_of(key)] = kernel_ms.get(kernel_of(key), 0.0) + us / steps / 1e3
    if per_step is not None:
        seen = dict.fromkeys(per_step, 0)
        for key, _, count in rows:
            if kernel_of(key) is not None:
                seen[kernel_of(key)] += count
        got = {k: exact.counts[k] / steps for k in per_step}
        prof_got = {k: c / steps for k, c in seen.items()}
        check(got == per_step, f"{label}: launches per step (exact count) {got}, "
                               f"expected {per_step}; the profiler's {prof_got}")
        log(f"[profile] {label}: launches per step, exact (wrappers + replays x graph "
            f"nodes) { {k: int(c) for k, c in got.items()} }; the profiler's kernel events "
            f"{ {k: round(c, 3) for k, c in prof_got.items()} }"
            + ("" if prof_got == got else " (the profiler dropped events)"))
    log(f"[profile] {label}, {steps} steps: device kernels {busy / steps / 1e3:.3f} ms/step, "
        f"{100 * busy / steps / 1e3 / step_ms:.1f}% of the unprofiled {step_ms:.3f} ms step "
        f"(wall under the profiler {wall_us / steps / 1e3:.3f} ms/step)")
    groups = {}
    for key, us, _ in rows:
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda g: -g[1]):
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step  {group}")
    for key, us, count in rows[:12]:
        log(f"[profile]   {us / steps / 1e3:8.4f} ms/step {count // steps:4d}x/step  {key[:100]}")
    return busy / steps / 1e3, 100 * busy / steps / 1e3 / step_ms


def kernel_group(name):
    """Coarse kernel families for the step breakdown (cuDNN's convolution
    kernels are implicit GEMMs, so they are matched before GEMM)."""
    low = name.lower()
    if "sgd_kernel" in low or "adam_kernel" in low:
        return "optimizer (this repo's CUDA kernels)"
    if "flash_" in low:
        return "attention (this repo's CUDA flash kernels)"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "padding")):
        return "convolution (cuDNN)"
    if "gemm" in low or "nvjet" in low:
        return "GEMM (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "elementwise, reductions, casts and copies"


def copy_bandwidth_gbps():
    src = torch.empty(256 * 2**20, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    ms = cuda_time_ms(lambda: dst.copy_(src), 10)
    return 2 * src.numel() * 4 / ms / 1e6


def ptxas_summary(log_text):
    """One line per compiled kernel: its name, registers and spill bytes."""
    out, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(flash_(?:fwd|bwd)\w*?_kernel|sgd_kernel|adam_kernel)", mangled)
            tmpl = "bf16" if "bfloat16" in mangled else ("f32" if "flash" in mangled else "")
            dim = re.search(r"Li(\d+)E", mangled)
            name = " ".join(x for x in ((base.group(1) if base else mangled), tmpl,
                                        (f"D={dim.group(1)}" if dim and tmpl else "")) if x)
            if "sgd_kernel" in mangled:
                name += " " + "".join(re.findall(r"Lb([01])E", mangled))
        elif name and "spill" in line:
            out.append([name, line.strip()])
        elif name and "registers" in line and out and out[-1][0] == name:
            out[-1].append(re.search(r"Used \d+ registers", line).group(0))
    return [" | ".join(x) for x in out] or [
        line.strip() for line in log_text.splitlines() if "registers" in line or "spill" in line]


def build_kernels(fo, fa):
    """Both sources, one nvcc each, started together."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {src: pool.submit(mod.build, force=True)
                for src, mod in ((SOURCE, fo), (FLASH_SOURCE, fa))}
        infos = {src: job.result() for src, job in jobs.items()}
    for src, info in infos.items():
        log(f"[build] nvcc {src} -> {info['path']} in {info['seconds']:.2f} s")
        for line in ptxas_summary(info["log"]):
            log(f"[build]   {line}")
    fo._lib()
    fa._lib()


# ------------------------------------------------------------------ phase 3, attention

def attn_inputs(shape, dtype, gen, sk=None):
    """q, k, v, dO of ``shape`` (B, H, S, D) on the card; k and v with
    ``sk`` rows when given."""
    kv = shape if sk is None else shape[:2] + (sk,) + shape[3:]
    return tuple(torch.randn(s, device="cuda", generator=gen).to(dtype)
                 for s in (shape, kv, kv, shape))


def worst_err(got, ref, tol, what):
    torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{what}: {m}")
    return (got.float() - ref.float()).abs().max().item()


def check_flash(fa):
    """Each flash kernel against its plain version on the same inputs.  The
    backward kernels get the plain version's lse and delta, so each kernel
    is held alone."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, s, d = LM["batch"], LM["num_heads"], LM["seq_length"], \
        LM["embed_dim"] // LM["num_heads"]
    # (q shape, k/v rows (None: as q), dtype, causal, a random lse cotangent)
    cases = [((b, h, s, d), None, torch.bfloat16, True, False),
             ((b, h, s, d), None, torch.bfloat16, False, False),
             ((b, h, s, d), None, torch.float32, True, False),
             ((2, 4, 300, 64), None, torch.bfloat16, True, False),
             ((2, 4, 300, 64), None, torch.float32, False, False),
             ((2, 4, 300, 64), None, torch.float32, True, True),
             ((2, 4, 300, 64), None, torch.bfloat16, True, True),
             ((2, 4, 150, 64), 260, torch.bfloat16, False, False),
             ((2, 4, 200, 64), 330, torch.float32, True, False),
             ((2, 4, 256, 128), None, torch.bfloat16, True, False),
             ((2, 4, 256, 128), None, torch.float32, False, False),
             ((2, 4, 200, 32), None, torch.float32, True, False),
             ((2, 4, 200, 32), None, torch.bfloat16, False, False),
             # the bf16 backward's transposed masks (K4) with Sq != Sk both
             # ways, and its D = 128 and D = 32 layouts, with the lse term
             ((2, 4, 200, 64), 330, torch.bfloat16, True, True),
             ((2, 4, 330, 64), 200, torch.bfloat16, True, True),
             ((2, 4, 256, 128), None, torch.bfloat16, True, True),
             ((2, 4, 200, 32), None, torch.bfloat16, True, True),
             # head dim 16 (the JAX package's transformer_4d and
             # transformer_generate examples): bf16 and f32, causal and
             # not, ragged S, Sq != Sk, with and without the lse term
             ((2, 4, 300, 16), None, torch.bfloat16, True, True),
             ((2, 4, 300, 16), None, torch.bfloat16, False, False),
             ((2, 4, 300, 16), None, torch.float32, True, True),
             ((2, 4, 300, 16), None, torch.float32, False, False),
             ((2, 4, 200, 16), 330, torch.bfloat16, True, True),
             ((2, 4, 330, 16), 200, torch.float32, False, True),
             ((2, 4, 65, 16), None, torch.bfloat16, True, False),
             ((16, 8, 512, 16), None, torch.bfloat16, True, True)]
    # the bf16 forward's edges: one row, one key tile and a row, more key
    # tiles than its double buffer
    cases += [((2, 4, s_, 64), None, torch.bfloat16, causal, False)
              for s_ in (1, 65, 1000) for causal in (True, False)]
    max_err = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for shape, sk, dtype, causal, with_glse in cases:
        q, k, v, do = attn_inputs(shape, dtype, gen, sk)
        scale = 1.0 / math.sqrt(shape[-1])
        tol, f32 = FLASH_TOL[dtype], FLASH_TOL[torch.float32]
        label = (f"{str(dtype)[6:]:8s} {str(shape):18s} Sk={k.shape[2]:<4d} "
                 f"causal={int(causal)} g_lse={'randn' if with_glse else 'None '}")
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, scale, causal)
        torch.cuda.synchronize()
        errs = [worst_err(o, o_ref, tol, f"O {label}"),
                worst_err(lse, lse_ref, f32, f"lse {label}")]
        delta = (o_ref.float() * do.float()).sum(-1)
        g_lse = (torch.randn(shape[:3], device="cuda", generator=gen) if with_glse
                 else None)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        dk_ref, dv_ref = fa.flash_bwd_dkdv_ref(q, k, v, do, lse_ref, delta, g_lse, scale,
                                               causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, g_lse, scale, causal)
        torch.cuda.synchronize()
        errs += [worst_err(dk, dk_ref, tol, f"dK {label}"),
                 worst_err(dv, dv_ref, tol, f"dV {label}"),
                 worst_err(dq, dq_ref, tol, f"dQ {label}")]
        if with_glse:
            # the lse term must matter: without it the kernel's dQ misses the tolerance
            dq0 = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, None, scale, causal)
            check(not torch.allclose(dq0.float(), dq_ref.float(), **tol),
                  f"dQ without g_lse still within tolerance ({label})")
        max_err["flash_fwd"] = max(max_err["flash_fwd"], *errs[:2])
        max_err["flash_bwd_dkdv"] = max(max_err["flash_bwd_dkdv"], *errs[2:4])
        max_err["flash_bwd_dq"] = max(max_err["flash_bwd_dq"], errs[4])
        log(f"  check {label}  max_abs_err O {errs[0]:.3e} lse {errs[1]:.3e} "
            f"dK {errs[2]:.3e} dV {errs[3]:.3e} dQ {errs[4]:.3e}")
    return max_err


def flash_bounds(shape, causal):
    """(ms bound, 'bytes' or 'operations', flops, bytes) of each kernel at a
    bf16 ``shape``: matrix-product flops of the (q, k) pairs this mask
    keeps (2 per multiply-add) over the bf16 tensor-core rate, and bytes
    with each input read once and each output written once over 3.35 TB/s."""
    b, h, s, d = shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    mat, row = b * h * s * d * 2, b * h * s * 4  # one (B,H,S,D) bf16, one (B,H,S) f32
    # products: fwd QK^T, PV; dK/dV QK^T, dO V^T, P^T dO, dS^T Q; dQ QK^T, dO V^T, dS K
    work = {"flash_fwd": (2 * 2 * d * pairs, 4 * mat + row),
            "flash_bwd_dkdv": (4 * 2 * d * pairs, 6 * mat + 2 * row),
            "flash_bwd_dq": (3 * 2 * d * pairs, 5 * mat + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
                     flops, nbytes)
    return out


def time_flash(fa, head_dim=None):
    """Each kernel, its plain version and SDPA at the transformer's shape
    (bf16, causal; at ``head_dim`` instead of its 64 when given).  SDPA is
    a yardstick only: the port never calls it."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (LM["batch"], LM["num_heads"], LM["seq_length"],
             head_dim or LM["embed_dim"] // LM["num_heads"])
    q, k, v, do = attn_inputs(shape, torch.bfloat16, gen)
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1)
    bwd_args = (q, k, v, do, lse, delta, None, scale, True)
    calls = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale, True),
                           lambda: fa.flash_fwd_ref(q, k, v, scale, True)),
             "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(*bwd_args),
                                lambda: fa.flash_bwd_dkdv_ref(*bwd_args)),
             "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd_args),
                              lambda: fa.flash_bwd_dq_ref(*bwd_args))}
    sdpa_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), 20)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale).backward(do)

    sdpa_fwd_bwd = cuda_time_ms(fwd_bwd, 20)
    # SDPA's flash backward (dQ, dK, dV in one call) called directly: one
    # dispatch per launch, so unlike the autograd loop above the device,
    # not the host, sets its time
    out, lse_s, cq, ck, mq, mk, seed, offset = \
        torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False,
                                                           scale=scale)[:8]
    sdpa_bwd = cuda_time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse_s, cq, ck, mq, mk, 0.0, True, seed, offset, scale=scale), 20)
    bounds = flash_bounds(shape, True)
    rows = {}
    for name, (kern, plain) in calls.items():
        k_ms, p_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 5)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        lib_ms = sdpa_fwd if name == "flash_fwd" else None
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
        log(f"  time  {name:16s} {shape} bf16 causal  kernel_ms {k_ms:.4f}  "
            f"bound_ms {bound_ms:.4f} (by {bound_by}: {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)  ref_ms {p_ms:.4f}  kernel rate "
            f"{flops / k_ms / 1e9:.2f} TFLOP/s ({100 * bound_ms / k_ms:.1f}% of the bound)")
    log("  host  " + ", ".join(f"{name} {host_us(kern, 100):.1f} us"
                               for name, (kern, _) in calls.items())
        + " of host time per wrapper call")
    log(f"  time  SDPA (library yardstick, never called by the port) forward "
        f"{sdpa_fwd:.4f} ms, forward+backward through autograd {sdpa_fwd_bwd:.4f} ms, "
        f"flash backward alone (aten, one call) {sdpa_bwd:.4f} ms; this repo's kernels forward "
        f"{rows['flash_fwd']['ms']:.4f} ms, backward (dK/dV + dQ + delta excluded) "
        f"{rows['flash_bwd_dkdv']['ms'] + rows['flash_bwd_dq']['ms']:.4f} ms")
    return rows


# ------------------------------------------------------------------ phase 4

def sgd_optimizer(ft):
    return lambda m: ft.SGDOptimizer(m, lr=0.001, momentum=0.9)


def adam_optimizer(ft):
    return lambda m: ft.AdamOptimizer(m, alpha=ADAM_ALPHA)


def stage_synthetic(ft, model, inp, n):
    """Stage the synthetic loader's ``n`` rows as the model's batch, once
    (the loader's numbers, no prefetch worker left behind)."""
    dl = ft.DataLoader.synthetic(model, inp, num_samples=n)
    model.set_batch(dl.inputs, dl.labels)


def main_model(ft, build_alexnet, make_opt, batch=BATCH, machine=None, **cfg):
    """AlexNet 3x229x229 through the user-facing entry points, with its
    synthetic batch staged (bf16 and the fused optimizer unless ``cfg``
    says otherwise; the default machine unless ``machine`` is given)."""
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    inp, _ = build_alexnet(model, batch)
    model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY], machine=machine)
    model.init_layers(seed=0)
    stage_synthetic(ft, model, inp, batch)
    return model


def check_graph_run(model, steps, label):
    """The run went through the compiled step: the first step eager, the
    second captured and replayed, every later one a replay."""
    g = model._step_graph
    check(g is not None and g.captures == 1 and g.replays == steps - 1,
          f"{label}: {steps} steps gave "
          f"{None if g is None else (g.captures, g.replays)} (captures, replays)")


def train_main_path(ft, build_alexnet, fo, make_opt, steps, timed_from):
    """Take ``steps`` steps of full-width AlexNet through the compiled step,
    checking a finite loss on every step and the optimizer's launches (SGD
    one a step, Adam one per leaf, 16): the wrapper runs at the eager first
    step and at the capture, the replays run the captured launches."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    model = main_model(ft, build_alexnet, make_opt)
    opt = model.optimizer
    n_leaves = sum(len(op.weights) for op in model.ops)
    check(n_leaves == 16, f"AlexNet has {n_leaves} leaves, expected 16")
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_params == 57_044_810, f"AlexNet has {n_params} parameters")
    sgd = isinstance(opt, ft.SGDOptimizer)
    kern = fo.fused_sgd_update if sgd else fo.fused_adam_update
    per_step = 1 if sgd else n_leaves
    loss_sums, t0 = [], None
    before = kern.launches
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        # cumulative loss sum on the device: no host transfer inside the loop
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    check_graph_run(model, steps, "AlexNet")
    check(kern.launches - before == 2 * per_step,
          f"{kern.launches - before} wrapper launches of {kern.__name__} (eager step and "
          f"capture), expected {2 * per_step}")
    sums = torch.stack(loss_sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in sums), f"non-finite loss: {losses}")
    probs = model.predict_batch()
    check(probs.shape == (BATCH, 10), f"predict_batch shape {probs.shape}")
    check(bool((abs(probs.sum(-1) - 1) < 2e-2).all()), "softmax rows do not sum to 1")
    timed = steps - timed_from
    return dict(losses=losses, ms_per_step=seconds / timed * 1e3,
                samples_per_s=timed * BATCH / seconds,
                metrics=model.get_metrics().to_string())


def kernel_wrappers(fo, fa):
    """Each kernel's wrapper, which counts its launches."""
    return {"fused_sgd_update": fo.fused_sgd_update,
            "fused_adam_update": fo.fused_adam_update,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dkdv": fa.flash_bwd_dkdv,
            "flash_bwd_dq": fa.flash_bwd_dq}


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def lm_model(ft, build_transformer, synthetic_lm_batch, make_opt, batch, seq_length,
             num_layers, embed_dim, num_heads, vocab_size, machine=None, dropout=0.0,
             **cfg):
    """The decoder transformer through the user-facing entry points, with a
    synthetic batch (numpy seed 0) staged."""
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    tok, pos, _ = build_transformer(model, batch, seq_length=seq_length,
                                    num_layers=num_layers, embed_dim=embed_dim,
                                    num_heads=num_heads, vocab_size=vocab_size,
                                    dropout=dropout)
    model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY], machine=machine)
    model.init_layers(seed=0)
    toks, posa, labels = synthetic_lm_batch(batch, seq_length, vocab_size, seed=0)
    model.set_batch({tok: toks, pos: posa}, labels)
    return model


def train_transformer(ft, build_transformer, synthetic_lm_batch, kernels):
    """Full-width transformer steps through the compiled step: exactly one
    launch of each flash kernel per layer and one fused SGD launch over all
    54 leaves at the eager step and at the capture, a finite loss on every
    step, and a loss that falls."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    model = lm_model(ft, build_transformer, synthetic_lm_batch,
                     lambda m: ft.SGDOptimizer(m, lr=0.001), **LM)
    n_leaves = sum(len(op.weights) for op in model.ops)
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_leaves == 54 and n_params == 45_664_512,
          f"transformer has {n_params} parameters in {n_leaves} leaves")
    per_step = {"flash_fwd": LM["num_layers"], "flash_bwd_dkdv": LM["num_layers"],
                "flash_bwd_dq": LM["num_layers"], "fused_sgd_update": 1,
                "fused_adam_update": 0}
    loss_sums, t0 = [], None
    before = read_launches(kernels)
    for step in range(LM_STEPS):
        if step == LM_TIMED_FROM:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    check_graph_run(model, LM_STEPS, "transformer")
    got = {n: c - before[n] for n, c in read_launches(kernels).items()}
    check(got == {n: 2 * c for n, c in per_step.items()},
          f"wrapper launches {got} (eager step and capture), expected twice {per_step}")
    sums = torch.stack(loss_sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss does not fall: {losses}")
    probs = model.predict_batch()
    shape = (LM["batch"], LM["seq_length"], LM["vocab_size"])
    check(probs.shape == shape, f"predict_batch shape {probs.shape}")
    check(bool((abs(probs.sum(-1) - 1) < 2e-2).all()), "softmax rows do not sum to 1")
    timed = LM_STEPS - LM_TIMED_FROM
    return model, dict(losses=losses, ms_per_step=seconds / timed * 1e3,
                       samples_per_s=timed * LM["batch"] / seconds,
                       tokens_per_s=timed * LM["batch"] * LM["seq_length"] / seconds,
                       metrics=model.get_metrics().to_string())


# ------------------------------------------------------------------ phase 5

def parity(ft, build_alexnet, make_opt):
    def run(fused):
        model = main_model(ft, build_alexnet, make_opt, batch=8,
                           compute_dtype="float32", fused_optimizer=fused)
        for _ in range(2):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): model._params[op.name][w.name].detach().clone()
                for op in model.ops for w in op.weights}

    fused, plain = run(True), run(False)
    worst = 0.0
    for key in fused:
        torch.testing.assert_close(fused[key], plain[key], **PARITY_TOL)
        worst = max(worst, (fused[key] - plain[key]).abs().max().item())
    return worst


def lm_parity(ft, build_transformer, synthetic_lm_batch, fa, kernels):
    """f32 transformer (batch 2, S 128, 2 layers, E 128, 2 heads: head dim
    64), 2 SGD steps through the flash kernels and 2 through their plain
    versions, from the same weights and batch; every weight compared."""
    shape = dict(batch=2, seq_length=128, num_layers=2, embed_dim=128, num_heads=2,
                 vocab_size=512)

    def run(plain):
        model = lm_model(ft, build_transformer, synthetic_lm_batch,
                         lambda m: ft.SGDOptimizer(m, lr=0.01, momentum=0.9),
                         compute_dtype="float32", **shape)
        before = read_launches(kernels)
        with fa.plain_versions() if plain else contextlib.nullcontext():
            for _ in range(2):
                model.train_iteration()
        model.sync()
        flash = {n: c - before[n] for n, c in read_launches(kernels).items()
                 if n.startswith("flash")}
        want = 0 if plain else 2 * shape["num_layers"]
        check(all(c == want for c in flash.values()),
              f"{'plain' if plain else 'kernel'} path flash launches {flash}")
        return {(op.name, w.name): model._params[op.name][w.name].detach().clone()
                for op in model.ops for w in op.weights}

    kern, plain = run(False), run(True)
    worst = 0.0
    for key in kern:
        torch.testing.assert_close(kern[key], plain[key], **LM_PARITY_TOL,
                                   msg=lambda m: f"{key}: {m}")
        worst = max(worst, (kern[key] - plain[key]).abs().max().item())
    return worst


# ------------------------------------------------------------------ phase 6

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def timed_steps(model, kernels, per_step, steps=7, timed_from=2):
    """``steps`` training steps, the first ``timed_from`` a warm-up, each
    checked to launch ``per_step`` of every kernel and to give a finite
    loss; returns the losses and the timed steps' ms/step."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    loss_sums, t0 = [], None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        before = read_launches(kernels)
        model.train_iteration()
        got = {n: c - before[n] for n, c in read_launches(kernels).items()}
        check(got == per_step, f"step {step}: launches {got}, expected {per_step}")
        loss_sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    seconds = time.perf_counter() - t0
    # each rank holds its batch part's share of the loss: one sum over the
    # parts (a collective on a mesh of several devices) gives the loss
    sums = model._sum_over_parts(torch.stack(loss_sums)).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return dict(losses=losses, ms_per_step=seconds / (steps - timed_from) * 1e3)


def soap_vs_single(label, make_model, single_machine, kernels, per_step, samples, tokens=0,
                   lead=True, cell=None):
    """One model trained on the SOAP path and on the single-device path in
    turns (single, SOAP, SOAP, single), 2 warm-up and 5 timed steps each,
    then one more model of each path profiled (after the timed runs, so
    that no timed run follows a profiled one).  Every rank runs the SOAP
    models; only the lead rank runs the single-device ones, profiles and
    prints.  Returns the SOAP runs' launches (counts set to 0 just before
    each SOAP run, read just after)."""
    soap_launches = dict.fromkeys(kernels, 0)
    runs = {"single": [], "soap": []}
    for i, path in enumerate(("single", "soap", "soap", "single", "single", "soap")):
        if path == "single" and not lead:
            continue
        model = make_model(single_machine if path == "single" else None)
        check((model.machine.mesh is None) == (path == "single"),
              f"{label}: the {path} path's machine is {model.machine}")
        if path == "soap":
            check(all(type(w).__name__ == "DTensor" for ws in model._params.values()
                      for w in ws.values()), f"{label}: SOAP parameters are not DTensors")
            reset_launches(kernels)
        if i < 4:
            runs[path].append(timed_steps(model, kernels, per_step))
        elif lead:
            runs[path].append(profile_steps(model, f"{label}, {path} path",
                                            runs[path][0]["ms_per_step"]))
        else:  # the profiled run's steps, in step with the lead rank
            for _ in range(5):
                model.train_iteration()
            model.sync()
        if path == "soap":
            soap_launches = {n: soap_launches[n] + c for n, c in read_launches(kernels).items()}
        if i == 1 and lead:
            log(f"[soap] {label}: configs on the mesh "
                f"{ {op.name: op.pc.dims for op in model.ops} }")
        del model
        torch.cuda.empty_cache()
    if not lead:
        return soap_launches
    for path, (r1, r2, (device_ms, busy)) in runs.items():
        ms = [r1["ms_per_step"], r2["ms_per_step"]]
        rate = (f"{' / '.join(f'{tokens * 1e3 / m:.0f}' for m in ms)} tokens/s" if tokens else
                f"{' / '.join(f'{samples * 1e3 / m:.1f}' for m in ms)} samples/s")
        log(f"[soap] {label}, {path:6s} path: {' / '.join(f'{m:.3f}' for m in ms)} ms/step, "
            f"{rate}, device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first run's "
            f"step, losses {['%.4f' % x for x in r1['losses']]}")
    log(f"[soap] {label}: launches per step on the SOAP path {per_step}")
    if cell is not None:
        MEASURED[cell]["soap_ms"] = sum(r["ms_per_step"] for r in runs["soap"][:2]) / 2
    return soap_launches


def soap_parity(ft, build_alexnet, build_transformer, synthetic_lm_batch, single_machine,
                lead, tol):
    """f32 weights after 2 steps, SOAP path vs single-device path: AlexNet
    at batch 8 (SGD, then Adam) under alexnet_16.pb, and the transformer
    of ``lm_parity`` under data parallelism.  Every rank trains the SOAP
    models and gathers their weights; the lead rank compares."""
    def weights(model):
        for _ in range(2):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
                for op in model.ops for w in op.weights}

    shape = dict(batch=2, seq_length=128, num_layers=2, embed_dim=128, num_heads=2,
                 vocab_size=512)
    cases = [("AlexNet batch 8 SGD", lambda m: main_model(
                 ft, build_alexnet, sgd_optimizer(ft), batch=8, machine=m,
                 compute_dtype="float32", import_strategy_file=ALEXNET_STRATEGY)),
             ("AlexNet batch 8 Adam", lambda m: main_model(
                 ft, build_alexnet, adam_optimizer(ft), batch=8, machine=m,
                 compute_dtype="float32", import_strategy_file=ALEXNET_STRATEGY)),
             ("transformer batch 2 S 128 2x128 SGD", lambda m: lm_model(
                 ft, build_transformer, synthetic_lm_batch,
                 lambda mm: ft.SGDOptimizer(mm, lr=0.01, momentum=0.9), machine=m,
                 compute_dtype="float32", **shape))]
    for label, make in cases:
        soap = weights(make(None))
        if not lead:
            continue
        single = weights(make(single_machine))
        case_tol = SOAP_MULTI_ADAM_TOL if "Adam" in label and tol is not SOAP_TOL else tol
        worst = 0.0
        for key in single:
            torch.testing.assert_close(soap[key], single[key], **case_tol,
                                       msg=lambda m: f"{label} {key}: {m}")
            worst = max(worst, (soap[key] - single[key]).abs().max().item())
        log(f"[soap] parity f32 {label}, 2 steps, SOAP path vs single-device path: "
            f"max |dw| {worst:.3e} (tolerance rtol {case_tol['rtol']:g}, atol "
            f"{case_tol['atol']:g}; cuDNN deterministic, TF32 off)")


def soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev, lead):
    """Phase 6's training on this rank: AlexNet (SGD, then Adam) under
    alexnet_16.pb and the transformer under data parallelism, SOAP beside
    single-device, then the f32 parity runs.  The SOAP path has no
    compiled step yet, so the single-device path it is set beside runs its
    eager step too (``disable_graphs``): the comparison is of what DTensor
    adds.  Returns the SOAP launches."""
    with ft.disable_graphs():
        return _soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels,
                          dev, lead)


def _soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev, lead):
    world = torch.distributed.get_world_size()
    single_machine = ft.Machine(devices=[dev])
    # phase 4's settings for the timed runs
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    soap_launches = dict.fromkeys(kernels, 0)
    none = dict.fromkeys(kernels, 0)
    for label, make_opt, per_step, cell in (
            ("AlexNet SGD momentum 0.9", sgd_optimizer(ft), {**none, "fused_sgd_update": 1},
             "alexnet"),
            ("AlexNet Adam", adam_optimizer(ft), {**none, "fused_adam_update": 16}, None)):
        got = soap_vs_single(
            f"{label} batch {BATCH} bf16 alexnet_16.pb, world {world}",
            lambda m, make_opt=make_opt: main_model(ft, build_alexnet, make_opt, machine=m,
                                                    import_strategy_file=ALEXNET_STRATEGY),
            single_machine, kernels, per_step, BATCH, lead=lead, cell=cell)
        soap_launches = {n: soap_launches[n] + c for n, c in got.items()}
    lm_per_step = {**none, "fused_sgd_update": 1, "flash_fwd": LM["num_layers"],
                   "flash_bwd_dkdv": LM["num_layers"], "flash_bwd_dq": LM["num_layers"]}
    got = soap_vs_single(
        f"transformer batch {LM['batch']} S {LM['seq_length']} bf16 data parallel, "
        f"world {world}",
        lambda m: lm_model(ft, build_transformer, synthetic_lm_batch,
                           lambda mm: ft.SGDOptimizer(mm, lr=0.001), machine=m, **LM),
        single_machine, kernels, lm_per_step, LM["batch"], LM["batch"] * LM["seq_length"],
        lead=lead, cell="transformer")
    soap_launches = {n: soap_launches[n] + c for n, c in got.items()}
    check(all(c > 0 for c in soap_launches.values()),
          f"a kernel never launched on the SOAP path: {soap_launches}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    soap_parity(ft, build_alexnet, build_transformer, synthetic_lm_batch, single_machine,
                lead, SOAP_TOL if world == 1 else SOAP_MULTI_TOL)
    return soap_launches


def soap_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, smi):
    """Phase 6 on the lead rank: an NCCL group of one rank per visible card
    (the others are this script started again as helper ranks), the SOAP
    runs, and the helpers' exit codes.  Returns the lead rank's SOAP
    launches."""
    from flexflow_tpu_torch.parallel import distributed as dist
    from flexflow_tpu_torch.parallel.mesh import mesh_shape
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file

    world, port = torch.cuda.device_count(), free_port()
    helpers = spawn_helpers("soap", world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        # (no Machine here: a mesh of several dims is made by a collective)
        log(f"[soap] process group: backend {torch.distributed.get_backend()}, world size "
            f"{dist.process_count()} (one rank per card; {torch.cuda.device_count()} card(s) "
            f"visible), mesh dims {mesh_shape(world)}; alexnet_16.pb holds "
            f"{len(load_strategies_from_file(ALEXNET_STRATEGY))} configs of up to 8 parts, "
            "legalized onto the mesh")
        launches = soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch,
                             kernels, dev, lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"SOAP helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:  # a failed or hung rank must not outlive the script
            if p.poll() is None:
                p.kill()
    log(f"[soap] launches on the lead rank's SOAP path (2 runs each of AlexNet SGD, AlexNet "
        f"Adam and the transformer, 7 steps a run, and a profiled run of 5 each): "
        f"{launches}; card {smi}")
    return launches


def spawn_helpers(kind, world, port):
    """This script started again as ranks 1 .. world - 1 of a ``kind``
    ("soap": phase 6, "seq": phase 13 (b)) process group at
    localhost:``port``, one per card (the environment carries the rank)."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)], stdout=subprocess.DEVNULL,
        env=dict(os.environ, **{SOAP_HELPER: kind, "RANK": str(r), "LOCAL_RANK": str(r),
                                "WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
                                "MASTER_PORT": str(port)}))
        for r in range(1, world)]


def soap_helper():
    """A helper rank of phase 6 or of phase 13 (b) (its kind, rank, world
    size and rendezvous from the environment the lead rank set): the same
    runs as the lead rank's, printing nothing."""
    if os.environ[SOAP_HELPER] == "seq":
        return seq_helper()
    if os.environ[SOAP_HELPER] == "pipe":
        return pipe_helper()
    if os.environ[SOAP_HELPER] == "soap2":
        return soap2_helper()
    if os.environ[SOAP_HELPER] == MESH_HELPER:
        return mesh_decode_helper()
    if os.environ[SOAP_HELPER] == SLICE_HELPER:
        return slice_helper()
    if os.environ[SOAP_HELPER] == NATIVE_HELPER:
        return native_helper()
    if os.environ[SOAP_HELPER] == LOWER_HELPER:
        return lower_helper()
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    kernels = kernel_wrappers(fo, fa)
    soap_runs(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, dev,
              lead=False)
    dist.shutdown()
    return 0


# ------------------------------------------------------------------ phase 7

# f32 weights, compiled step vs eager step, on the same inputs: the same
# kernels in the same order on the same data, so the two should agree to
# the bit; 1e-6 is the limit stated for them (the fused update's).
GRAPH_TOL = dict(rtol=1e-6, atol=1e-6)
# grad_accum_steps 4 vs 1 after 2 f32 steps: the JAX package's own
# accumulation test's tolerance (tests/test_grad_accum.py)
ACCUM_TOL = dict(rtol=2e-5, atol=2e-6)
# remat vs plain: the same forward recomputed, the JAX package's remat
# test's tolerance
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)


def free_models():
    """Free the models no name holds any more (an op refers to its model, so
    a dropped model waits for the cycle collector) and their cached blocks,
    so that a peak-memory reading counts one model."""
    gc.collect()
    torch.cuda.empty_cache()


def state_of(model):
    """Every weight and optimizer slot of a single-device model, cloned."""
    out = {("w", o, n): t.detach().clone() for o, ws in model._params.items()
           for n, t in ws.items()}
    for slot, tree in (model._opt_state or {}).items():
        out.update({(slot, o, n): t.clone() for o, ws in tree.items() for n, t in ws.items()})
    return out


def compare_states(a, b, tol, what):
    """Max |difference| over every leaf, after holding each at ``tol``;
    returns (max abs difference, whether every leaf is bitwise equal)."""
    worst, bitwise = 0.0, True
    for key in a:
        torch.testing.assert_close(a[key], b[key], **tol, msg=lambda m: f"{what} {key}: {m}")
        bitwise = bitwise and torch.equal(a[key], b[key])
        worst = max(worst, (a[key] - b[key]).abs().max().item())
    return worst, bitwise


def steps_ms(model, steps=7, timed_from=2):
    """Host ms per step over the steps after ``timed_from``, ending in a
    synchronize, and the cumulative loss sums (no host read in the loop)."""
    from flexflow_tpu_torch.model import METRIC_KEYS

    sums, t0 = [], None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        model.train_iteration()
        sums.append(model._metric_acc[METRIC_KEYS.index("loss")].clone())
    model.sync()
    ms = (time.perf_counter() - t0) / (steps - timed_from) * 1e3
    sums = torch.stack(sums).tolist()
    losses = [b - a for a, b in zip([0.0] + sums[:-1], sums)]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    return ms, losses


def graph_vs_eager(ft, label, make_model, per_step, samples, tokens=0):
    """One model's compiled step and eager step in turns (graph, eager,
    eager, graph), 2 warm-up and 5 timed steps each, then one more model of
    each profiled: device ms per step, busy share and launches per step
    (the exact count, ``profile_steps``)."""
    times = {"graph": [], "eager": []}
    for path in ("graph", "eager", "eager", "graph"):
        model = make_model()
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            ms, losses = steps_ms(model)
        if path == "graph":
            check_graph_run(model, 7, label)
        else:
            check(model._step_graph is None, f"{label}: the eager run captured a graph")
        times[path].append(ms)
        del model
        torch.cuda.empty_cache()
    prof = {}
    for path in ("graph", "eager"):
        model = make_model()
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            prof[path] = profile_steps(model, f"{label}, {path} step", times[path][0],
                                       per_step=per_step)
        del model
        torch.cuda.empty_cache()
    for path, ms in times.items():
        device_ms, busy = prof[path]
        rate = (f"{' / '.join(f'{tokens * 1e3 / m:.0f}' for m in ms)} tokens/s (device "
                f"ceiling {tokens * 1e3 / device_ms:.0f})" if tokens else
                f"{' / '.join(f'{samples * 1e3 / m:.1f}' for m in ms)} samples/s (device "
                f"ceiling {samples * 1e3 / device_ms:.1f})")
        log(f"[graph] {label}, {path:5s} step: {' / '.join(f'{m:.3f}' for m in ms)} ms/step, "
            f"{rate}, device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first run's step")
    return times, prof


def graph_eager_parity(ft, label, make_model, steps=3, between=None):
    """f32 state after ``steps`` steps, compiled vs eager, from the same
    weights and batch: the eager first step, the captured second and a
    replay.  ``between(model, i)`` runs before step i on both paths."""
    def run(graph):
        model = make_model()
        with contextlib.nullcontext() if graph else ft.disable_graphs():
            for i in range(steps):
                if between is not None:
                    between(model, i)
                model.train_iteration()
        model.sync()
        if graph:
            check_graph_run(model, steps, label)
        return state_of(model)

    worst, bitwise = compare_states(run(True), run(False), GRAPH_TOL, label)
    log(f"[graph] parity f32 {label}, {steps} steps, compiled vs eager: max |d| {worst:.3e} "
        f"over weights and optimizer state ({'bitwise equal' if bitwise else 'not bitwise'}; "
        f"limit rtol 1e-6, atol 1e-6)")
    return worst


def guard_check(ft, build_alexnet, make_opt, label):
    """FF_SKIP_NONFINITE on the compiled step: two good steps (the eager
    one and the captured one), then the same batch with an inf staged into
    the static buffers and replayed: w, m and v bitwise unchanged and
    skipped_steps 1; a good step after it trains again."""
    import numpy as np

    os.environ["FF_SKIP_NONFINITE"] = "3"
    try:
        model = main_model(ft, build_alexnet, make_opt)
    finally:
        os.environ.pop("FF_SKIP_NONFINITE")
    inp = model.input_tensors[0]
    x = np.random.default_rng(1).standard_normal((BATCH,) + inp.dims[1:], dtype=np.float32)
    y = model._batch["label"].cpu().numpy()
    for _ in range(2):
        model.train_iteration()
    before = state_of(model)
    bad = x.copy()
    bad[3, 7, 11, 0] = np.inf
    model.set_batch({inp: bad}, y)
    model.train_iteration()
    model.sync()
    check_graph_run(model, 3, label)
    _, bitwise = compare_states(before, state_of(model), dict(rtol=0, atol=0), label)
    keys = model._metric_keys()
    acc = dict(zip(keys, model._metric_acc.tolist()))
    check(acc["skipped_steps"] == 1 and acc["consec_skipped"] == 1 and acc["steps"] == 2,
          f"{label}: guard entries {acc}")
    model.set_batch({inp: x}, y)
    model.train_iteration()
    model.sync()
    after = state_of(model)
    check(not torch.equal(after[("w", "fc1", "kernel")], before[("w", "fc1", "kernel")]),
          f"{label}: the good step after the skipped one did not train")
    acc = dict(zip(keys, model._metric_acc.tolist()))
    check(acc["consec_skipped"] == 0 and acc["skipped_steps"] == 1,
          f"{label}: guard entries after a good step {acc}")
    log(f"[graph] guard {label}: a batch with an inf replayed through the captured step left "
        f"every weight and slot ({len(before)} leaves) bitwise unchanged; skipped_steps "
        f"{acc['skipped_steps']:.0f}, nonfinite_loss {acc['nonfinite_loss']:.0f}; the next good "
        "step trained and reset consec_skipped")


def save_load_check(ft, build_alexnet, label):
    """save after 2 compiled steps, load into a fresh model, 2 more steps:
    equal to 4 uninterrupted steps."""
    import tempfile

    straight = main_model(ft, build_alexnet, sgd_optimizer(ft))
    for _ in range(4):
        straight.train_iteration()
    want = state_of(straight)
    del straight
    first = main_model(ft, build_alexnet, sgd_optimizer(ft))
    for _ in range(2):
        first.train_iteration()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alexnet")
        t0 = time.perf_counter()
        first.save(path)
        save_s = time.perf_counter() - t0
        del first
        fresh = main_model(ft, build_alexnet, sgd_optimizer(ft))
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
    check(fresh._step_count == 2, f"{label}: loaded step {fresh._step_count}")
    for _ in range(2):
        fresh.train_iteration()
    fresh.sync()
    check_graph_run(fresh, 2, label)
    worst, bitwise = compare_states(want, state_of(fresh), GRAPH_TOL, label)
    log(f"[graph] checkpoint {label}: save after 2 steps ({size / 2**20:.1f} MiB .npz, save "
        f"{save_s:.2f} s, load {load_s:.2f} s), load into a fresh model, 2 more steps vs 4 "
        f"uninterrupted: max |d| {worst:.3e} ({'bitwise equal' if bitwise else 'not bitwise'})")


def compiled_step_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, smi):
    """Phase 7: the compiled step against the eager step on both main paths,
    and the step's options on the card."""
    lm_make = lambda **cfg: lm_model(  # noqa: E731
        ft, build_transformer, synthetic_lm_batch, lambda m: ft.SGDOptimizer(m, lr=0.001),
        **{**LM, **cfg})
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    for label, make, per_step, samples, tokens, cell in (
            (f"AlexNet batch {BATCH} bf16 SGD momentum 0.9",
             lambda: main_model(ft, build_alexnet, sgd_optimizer(ft)), ALEX_SGD_STEP,
             BATCH, 0, "alexnet"),
            (f"AlexNet batch {BATCH} bf16 Adam",
             lambda: main_model(ft, build_alexnet, adam_optimizer(ft)), ALEX_ADAM_STEP,
             BATCH, 0, None),
            (f"transformer batch {LM['batch']} S {LM['seq_length']} bf16 SGD", lm_make,
             LM_SGD_STEP, LM["batch"], LM["batch"] * LM["seq_length"], "transformer")):
        times, prof = graph_vs_eager(ft, label, make, per_step, samples, tokens)
        if cell is not None:
            MEASURED[cell].update(graph_ms=sum(times["graph"]) / len(times["graph"]),
                                  graph_device_ms=prof["graph"][0])

    # remat against plain on the bf16 main path: weights (compiled step) and
    # peak memory on both paths
    peaks, states = {}, {}
    for remat in (False, True):
        for path in ("graph", "eager"):
            free_models()
            torch.cuda.reset_peak_memory_stats()
            model = lm_make(remat=remat)
            with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
                steps_ms(model, steps=2, timed_from=1)
            peaks[remat, path] = torch.cuda.max_memory_allocated() / 2**30
            if path == "graph":
                check_graph_run(model, 2, f"transformer remat={remat}")
                states[remat] = state_of(model)
            del model
    worst, bitwise = compare_states(states[True], states[False], REMAT_TOL, "remat")
    log(f"[graph] remat transformer bf16, 2 steps: max_memory_allocated plain "
        f"{peaks[False, 'graph']:.2f} GiB compiled / {peaks[False, 'eager']:.2f} GiB eager, "
        f"remat {peaks[True, 'graph']:.2f} / {peaks[True, 'eager']:.2f} GiB; weights after 2 "
        f"compiled steps max |d| {worst:.3e} ({'bitwise equal' if bitwise else 'not bitwise'}; "
        f"limit rtol 1e-6, atol 1e-7); card {smi}")
    del states
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(compute_dtype="float32")
    graph_eager_parity(ft, f"AlexNet batch {BATCH} SGD momentum 0.9",
                       lambda: main_model(ft, build_alexnet, sgd_optimizer(ft), **f32))

    def epochs(model, i):  # alpha_t changes between replays
        if i >= 2:
            model.optimizer.next_epoch()
    graph_eager_parity(ft, f"AlexNet batch {BATCH} Adam, next_epoch() before steps 3 and 4",
                       lambda: main_model(ft, build_alexnet, adam_optimizer(ft), **f32),
                       steps=4, between=epochs)
    lm_sgd = lambda **cfg: lm_model(  # noqa: E731
        ft, build_transformer, synthetic_lm_batch,
        lambda m: ft.SGDOptimizer(m, lr=0.01, momentum=0.9), **{**LM, **f32, **cfg})
    graph_eager_parity(ft, f"transformer batch {LM['batch']} S {LM['seq_length']} SGD "
                       "momentum 0.9", lm_sgd)

    # gradient accumulation: K = 4 against K = 1, 2 compiled f32 steps
    states = {}
    for k in (1, 4):
        model = lm_sgd(grad_accum_steps=k)
        for _ in range(2):
            model.train_iteration()
        model.sync()
        check_graph_run(model, 2, f"transformer grad_accum_steps={k}")
        states[k] = state_of(model)
        del model
        torch.cuda.empty_cache()
    worst, _ = compare_states(states[4], states[1], ACCUM_TOL, "grad_accum_steps")
    log(f"[graph] grad_accum_steps f32 transformer, 4 micro-batches of "
        f"{LM['batch'] // 4} vs the whole batch, 2 compiled steps: max |d| {worst:.3e} over "
        "weights and momentum (limit rtol 2e-5, atol 2e-6)")
    del states
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    guard_check(ft, build_alexnet, sgd_optimizer(ft), f"AlexNet batch {BATCH} bf16 SGD")
    guard_check(ft, build_alexnet, adam_optimizer(ft), f"AlexNet batch {BATCH} bf16 Adam")
    torch.cuda.empty_cache()
    save_load_check(ft, build_alexnet, f"AlexNet batch {BATCH} bf16 SGD")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8

# Part counts of the data-parallel configs the calibration measures, and the
# node the offline search plans for.
CAL_PARTS = (1, 2, 4, 8)
NODE_GPUS = 8
SEARCH_BUDGET = 300    # compile(search_budget=...) on this machine
OFFLINE_BUDGET = 1000  # the offline search for an 8-GPU node
# What phases 4, 6 and 7 measured on each cell, for phase 8's agreement lines.
MEASURED = {"alexnet": {}, "transformer": {}}


def calibration_files(directory):
    """Paths of this run's measured cache and fit in ``directory``, emptied,
    so that the run measures afresh."""
    os.makedirs(directory, exist_ok=True)
    paths = (os.path.join(directory, "measured_h100.json"),
             os.path.join(directory, "machine_h100.json"))
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    return paths


def calibration_cost(mm, measured_path):
    """A cost model over this run's measured cache and nothing else."""
    from flexflow_tpu_torch.simulator.cost_model import CostModel

    return CostModel(mm, compute_dtype="bfloat16", cache_path=None,
                     measured_cache_path=measured_path)


def calibrate_on_card(kernels, smi, measured_path, fit_path):
    """8a: every op of both cells, forward and backward, at their
    data-parallel sub-shapes of 1, 2, 4 and 8 parts, timed on the card; the
    roofline fitted to them.  The attention measurements must have launched
    K3-K5 (7 times per measurement: 2 warm-up and 5 timed iterations)."""
    from flexflow_tpu_torch.simulator import cost_model
    from flexflow_tpu_torch.tools import calibrate

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    reset_launches(kernels)
    # the cells' job space alone: no report keys first (phase 20's window
    # measures those)
    no_keys = os.path.join(os.path.dirname(os.path.abspath(measured_path)), "no_keys.json")
    with environ({"FF_REPORT_KEYS_PATH": no_keys}):
        r = calibrate.calibrate([("alexnet", BATCH), ("transformer", LM["batch"])],
                                devices=NODE_GPUS, dp_parts=CAL_PARTS,
                                compute_dtype="bfloat16", out=measured_path,
                                fit_out=fit_path, device="cuda", verbose=False)
    launches = read_launches(kernels)
    with open(measured_path) as f:
        entries = json.load(f)
    ladder = {k: entries.pop(k) for k in list(entries) if k.startswith("host_xfer:")}
    check(len(ladder) == len(calibrate.HOST_XFER_SIZES)
          and all(v["platform"] == "cuda" for v in ladder.values()),
          f"the host-transfer ladder measured {sorted(ladder)}")
    mha = sum(1 for k in entries if k.startswith("MultiHeadAttention:") and k.endswith(":forward"))
    per = cost_model.MEASURE_WARMUP + cost_model.MEASURE_ITERS
    check(mha == len(CAL_PARTS), f"{mha} attention configs measured, expected {len(CAL_PARTS)}")
    check(r["jobs"] == len(entries) and all(v["platform"] == "cuda" for v in entries.values()),
          f"{r['jobs']} jobs gave {len(entries)} measured entries")
    check(launches == {**dict.fromkeys(kernels, 0), "flash_fwd": mha * per,
                       "flash_bwd_dkdv": mha * per, "flash_bwd_dq": mha * per},
          f"calibration launches {launches}, expected {mha * per} of each flash kernel")
    fit = r["fit"]
    log(f"[search] calibration: {len(entries)} measured points ({r['jobs']} jobs: every op of "
        f"AlexNet batch {BATCH} and the transformer B{LM['batch']} S{LM['seq_length']} bf16, "
        f"forward and backward, data-parallel parts {CAL_PARTS}) in {r['seconds']:.1f} s; "
        f"cudnn.benchmark False, TF32 on; flash launches {launches}")
    log(f"[search] fit over {fit['fit_points']} points: log-rmse {fit['fit_log_rmse']:.4f}, "
        f"matmul_efficiency {fit['matmul_efficiency']:.2f}, hbm_bandwidth "
        f"{fit['hbm_bandwidth'] / 1e9:.0f} GB/s, kernel_launch_overhead "
        f"{fit['kernel_launch_overhead'] * 1e6:.0f} us, backward_multiplier "
        f"{fit['backward_multiplier']:.3f}, op_efficiency {fit['op_efficiency']}, "
        f"op_backward_multiplier "
        f"{ {k: round(v, 3) for k, v in fit['op_backward_multiplier'].items()} }; "
        f"card {fit['device']}, {fit['power_limit']} ({smi})")
    check(r["written"] and 0 < fit["pcie_bandwidth"] < 1e12,
          f"the host link's fit {fit.get('pcie_bandwidth')}")
    log(f"[search] host link: pinned host<->device copies of "
        + ", ".join(f"{int(k.split(':')[1]) >> 20} MiB {v['t'] * 1e3:.3f} ms"
                    for k, v in sorted(ladder.items(), key=lambda kv: int(kv[0].split(':')[1])))
        + f" a direction; fitted pcie_bandwidth {fit['pcie_bandwidth'] / 1e9:.2f} GB/s, "
        f"host_xfer_latency {fit['host_xfer_latency'] * 1e6:.1f} us (spec 64 GB/s, 0 us); "
        f"card {smi}")
    return launches


def cell_model(name, ft, nd=1):
    """A cell's graph (``tools/offline_search.py`` builds the tools' models:
    the same full widths as phases 4-7), its machine sized ``nd``."""
    from flexflow_tpu_torch.tools import offline_search

    check(offline_search.TRANSFORMER == {k: v for k, v in LM.items() if k != "batch"},
          f"the tools' transformer {offline_search.TRANSFORMER} is not the cell's {LM}")
    return offline_search.build_model(name, BATCH if name == "alexnet" else LM["batch"], nd,
                                      "cuda", "bfloat16")


def simulated_agreement(ft, smi, measured_path, fit_path):
    """8b: each cell's data-parallel step on one card, simulated from the
    measured table and from the fitted roofline alone, beside what phases
    4, 6 and 7 measured; the predicted memory beside the measured peak."""
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.simulator.memory import memory_per_device
    from flexflow_tpu_torch.simulator.simulator import Simulator

    mm = H100MachineModel.calibrated(path=fit_path, num_devices=1)
    check(mm.fitted, f"the machine model is not this run's fit: {mm.source}")
    for name in ("alexnet", "transformer"):
        model = cell_model(name, ft)
        dp = {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, 1)
              for op in model.ops}
        table = Simulator(mm, calibration_cost(mm, measured_path))
        roof = Simulator(mm, calibration_cost(mm, os.devnull))
        sim_ms = table.simulate_runtime(model, dp) * 1e3
        roof_ms = roof.simulate_runtime(model, dp) * 1e3
        check(table.cost.stats["analytic"] == 0, f"{name}: a DP-1 op was not measured")
        per_op = sorted(((table.cost.op_time(op, dp[op.name], "forward")
                          + table.cost.op_time(op, dp[op.name], "backward")) * 1e3, op.name)
                        for op in model.ops)[::-1]
        log(f"[search] {name} DP-1 table, largest ops (forward + backward ms): "
            f"{', '.join(f'{n} {t:.3f}' for t, n in per_op[:6])}")
        got = MEASURED[name]
        if not {"graph_ms", "graph_device_ms", "soap_ms", "peak_gib"} <= set(got):
            log(f"[search] {name} DP-1 simulated {sim_ms:.3f} ms/step from the measured table "
                f"({roof_ms:.3f} from the fitted roofline alone); measured: not in this run "
                f"(phases 4, 6 and 7 were not all selected); card {smi}")
            continue
        log(f"[search] {name} DP-1 simulated {sim_ms:.3f} ms/step from the measured table "
            f"({roof_ms:.3f} from the fitted roofline alone); measured: compiled step "
            f"{got['graph_ms']:.3f} ms/step (device {got['graph_device_ms']:.3f}), eager SOAP "
            f"step {got['soap_ms']:.3f} ms/step; simulated/measured {sim_ms / got['graph_ms']:.3f} "
            f"compiled, {sim_ms / got['graph_device_ms']:.3f} device, "
            f"{sim_ms / got['soap_ms']:.3f} SOAP-eager; roofline/compiled "
            f"{roof_ms / got['graph_ms']:.3f}; card {smi}")
        opts = ([("SGD momentum 0.9", ft.SGDOptimizer(lr=0.001, momentum=0.9)),
                 ("Adam", ft.AdamOptimizer(alpha=ADAM_ALPHA))] if name == "alexnet" else
                [("SGD", ft.SGDOptimizer(lr=0.001))])
        preds = {label: memory_per_device(model, dp, machine_model=mm, optimizer=opt)
                 for label, opt in opts}
        peak = max(p["peak_bytes"] for p in preds.values()) / 2**30
        log(f"[search] {name} memory: predicted "
            f"{', '.join(k + ' %.2f GiB' % (p['peak_bytes'] / 2**30) for k, p in preds.items())} "
            f"(dominant {[p['dominant_term'] for p in preds.values()]}) against phase 4's "
            f"max_memory_allocated {got['peak_gib']:.2f} GiB: predicted/measured "
            f"{peak / got['peak_gib']:.3f}")


def search_entry_point(ft, build_alexnet, kernels, out_dir):
    """8c: full-width AlexNet through compile(search_budget=...) with each
    engine ("" must run the native annealer) on the default machine (one
    card without a process group, whose steps are compiled) and the
    committed calibration (what a user's compile reads), init_layers and 3
    compiled steps, then the full-width transformer (Adam) searched by the
    native engine, training through K2-K5; each exported strategy loads
    back equal."""
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file, read_provenance

    launches = dict.fromkeys(kernels, 0)
    runs = [("AlexNet", engine) for engine in ("mcmc", "population", "native", "")]
    runs.append(("transformer", "native"))
    for label, engine in runs:
        free_models()
        pb = os.path.join(out_dir, f"{label}_searched_{engine or 'default'}.pb")
        reset_launches(kernels)
        t0 = time.perf_counter()
        search = dict(search_budget=SEARCH_BUDGET, search_engine=engine,
                      export_strategy_file=pb)
        if label == "AlexNet":
            model = main_model(ft, build_alexnet, sgd_optimizer(ft), **search)
            per_step = ALEX_SGD_STEP
        else:
            model = lm_model(ft, build_transformer, synthetic_lm_batch, adam_optimizer(ft),
                             **LM, **search)
            per_step = {"flash_fwd": LM["num_layers"], "flash_bwd_dkdv": LM["num_layers"],
                        "flash_bwd_dq": LM["num_layers"], "fused_sgd_update": 0,
                        "fused_adam_update": sum(len(op.weights) for op in model.ops)}
        seconds = time.perf_counter() - t0
        ms, losses = steps_ms(model, steps=3, timed_from=2)  # the step after the capture
        got = read_launches(kernels)
        check_graph_run(model, 3, f"{label} searched by {engine!r}")
        # the eager first step and the capture call the wrappers; the replay does not
        check(got == {n: 2 * c for n, c in per_step.items()},
              f"{label} {engine!r}: launches {got}, expected twice {per_step}")
        launches = {n: launches[n] + got[n] for n in kernels}
        check(load_strategies_from_file(pb) == {op.name: op.pc for op in model.ops},
              f"{label} {engine!r}: the exported strategy does not load back equal")
        meta = read_provenance(pb)
        check(meta["engine"] == (engine or "native"),
              f"{label} {engine!r}: the search ran as {meta['engine']!r}")
        log(f"[search] {label} compile(search_budget={SEARCH_BUDGET}, search_engine={engine!r}) "
            f"on {model.machine.num_devices} GPU(s): ran {meta['engine']}, DP "
            f"{meta['dp_ms']:.3f} ms, best {meta['best_ms']:.3f} ms simulated; compile "
            f"{seconds:.2f} s; 3 compiled steps, losses {['%.4f' % x for x in losses]}, "
            f"{ms:.3f} ms/step, the step after the capture; "
            f"configs {sorted({op.pc.dims for op in model.ops})}; launches {got}; "
            f"{meta['machine_model']}")
        del model
    return launches


def offline_node_search(ft, measured_path, fit_path):
    """8d: the offline search for an 8-GPU node on this run's calibration;
    every config of the best strategy composes over the port's 8-device mesh
    and passes its op's ``check_config`` (what compile asks of it); a conv
    or pool may split its height or width (phase 16 holds such tiles)."""
    from flexflow_tpu_torch.parallel.mesh import axes_for_degrees, mesh_shape
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.tools import offline_search

    sizes, names = mesh_shape(NODE_GPUS)
    for name in ("alexnet", "transformer"):
        for engine in ("mcmc", "population", "native"):
            model = cell_model(name, ft, NODE_GPUS)
            mm = H100MachineModel.calibrated(path=fit_path, num_devices=NODE_GPUS)
            best = offline_search.run(model, NODE_GPUS, OFFLINE_BUDGET, seed=0, engine=engine,
                                      machine_model=mm,
                                      cost_model=calibration_cost(mm, measured_path))
            for op in model.ops:
                dims = best[op.name].dims
                axes_for_degrees(names, sizes, dims)  # raises if it cannot
                op.check_config(best[op.name])  # raises if training would refuse it
            split = {op.name: best[op.name].dims for op in model.ops
                     if best[op.name].dims != (NODE_GPUS,) + (1,) * (op.output.num_dims - 1)}
            log(f"[search] offline {engine} search, {name}, {NODE_GPUS} H100s, budget "
                f"{OFFLINE_BUDGET}: DP {best.dp_s * 1e3:.3f} ms, best {best.best_s * 1e3:.3f} "
                f"ms simulated ({best.dp_s / best.best_s:.2f}x), "
                f"{best.proposals_per_s:.0f} proposals/s; configs off data parallel {split}")


def search_phase(ft, build_alexnet, kernels, smi, out_dir):
    """Phase 8: calibration, agreement, the search through compile, the
    offline search for a node.  Returns the kernels' launches on its two
    paths, the calibration's measurements and the searched model's steps."""
    t0 = time.perf_counter()
    measured_path, fit_path = calibration_files(out_dir)
    cal = calibrate_on_card(kernels, smi, measured_path, fit_path)
    simulated_agreement(ft, smi, measured_path, fit_path)
    entry = search_entry_point(ft, build_alexnet, kernels, out_dir)
    offline_node_search(ft, measured_path, fit_path)
    log(f"[search] phase 8 took {time.perf_counter() - t0:.1f} s; calibration written to "
        f"{measured_path} and {fit_path}")
    return {n: cal[n] + entry[n] for n in kernels}


# ------------------------------------------------------------------ phase 9

# The rest of the zoo at full width (PERF.md section 4): per
# model the builder's module and function, its arguments, the global batch,
# the loss, the optimizer (kind, lr or alpha, momentum), the input the
# rate counts (samples, or tokens per sample), and its weight leaves.
ZOO = {
    "resnet50": dict(module="resnet", build="build_resnet50", kw={}, batch=64,
                     loss="sparse_categorical_crossentropy", opt=("sgd", 0.001, 0.9),
                     tokens=0, leaves=108,
                     label="ResNet-50 3x229x229 batch 64 bf16, SGD momentum 0.9"),
    "inception_v3": dict(module="inception", build="build_inception_v3", kw={}, batch=128,
                         loss="sparse_categorical_crossentropy", opt=("sgd", 0.001, 0.9),
                         tokens=0, leaves=190,
                         label="Inception-v3 3x299x299 batch 128 bf16, SGD momentum 0.9"),
    "dlrm": dict(module="dlrm", build="build_dlrm", kw={}, batch=256,
                 loss="mean_squared_error", opt=("sgd", 0.01, 0.0), tokens=0, leaves=22,
                 label="DLRM batch 256, 8 tables x 1,000,000 x 64 on the card, bot "
                       "64-512-512-64, top 576-1024-1024-1024-1, bf16, SGD"),
    "candle_uno": dict(module="candle_uno", build="build_candle_uno", kw={}, batch=256,
                       loss="mean_squared_error", opt=("sgd", 0.001, 0.0), tokens=0,
                       leaves=26, label="CANDLE-Uno batch 256, 3x1000 towers and trunk, "
                                        "bf16, SGD"),
    "nmt": dict(module="nmt", build="build_nmt", kw={}, batch=64,
                loss="sparse_categorical_crossentropy", opt=("adam", ADAM_ALPHA, 0.0),
                tokens=20, leaves=15,
                label="NMT batch 64, seq 20, 2+2 LSTM layers, hidden = embed 2048, vocab "
                      "20480, bf16, Adam"),
    "transformer_moe": dict(module="transformer", build="build_transformer",
                            kw=dict(moe_every=2, num_experts=8,
                                    **{k: v for k, v in LM.items() if k != "batch"}),
                            batch=LM["batch"], loss="sparse_categorical_crossentropy",
                            opt=("sgd", 0.001, 0.0), tokens=LM["seq_length"], leaves=56,
                            label=f"MoE transformer batch {LM['batch']} S {LM['seq_length']} "
                                  f"{LM['num_layers']}x{LM['embed_dim']}, 8 experts every 2nd "
                                  "layer, bf16, SGD"),
}
# Smaller depth for the f32 parity runs of phase 9 (the MoE transformer:
# 2 layers, one of them MoE); the other models run whole.
ZOO_PARITY_KW = {"transformer_moe": dict(num_layers=2)}
# The offline search of each new model for an 8-GPU node (simulation only).
ZOO_SEARCH_BUDGET = 300


def zoo_model(ft, name, kw=None, machine=None, **cfg):
    """A model of the zoo through the user-facing entry points (bf16 and
    the fused optimizer unless ``cfg`` says otherwise; the default machine
    unless ``machine`` is given), its synthetic batch (made from a seed, the
    JAX package's recipes) staged."""
    import importlib

    import numpy as np

    z = ZOO[name]
    batch = z["batch"]
    mod = importlib.import_module(f"flexflow_tpu_torch.models.{z['module']}")
    cfg = {"compute_dtype": "bfloat16", "fused_optimizer": True, **cfg}
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    built = getattr(mod, z["build"])(model, batch, **{**z["kw"], **(kw or {})})
    kind, lr, momentum = z["opt"]
    opt = (ft.SGDOptimizer(model, lr=lr, momentum=momentum) if kind == "sgd"
           else ft.AdamOptimizer(model, alpha=lr))
    metrics = (["accuracy"] if z["loss"] == "sparse_categorical_crossentropy"
               else ["mean_squared_error"])
    model.compile(opt, z["loss"], metrics, machine=machine)
    model.init_layers(seed=0)
    if name in ("resnet50", "inception_v3"):
        stage_synthetic(ft, model, built[0], batch)
    elif name == "dlrm":
        rows = [op.num_entries for op in model.ops if op._type == "Embedding"]
        sparse, dense, labels = mod.synthetic_batch(batch, rows, 1, built[1].dims[1], seed=11)
        model.set_batch({**dict(zip(built[0], sparse)), built[1]: dense}, labels)
    elif name == "candle_uno":
        rng = np.random.default_rng(0)
        model.set_batch({t: rng.standard_normal(t.dims, dtype=np.float32)
                         for t in built[0].values()},
                        rng.standard_normal((batch, 1), dtype=np.float32))
    elif name == "nmt":
        vocab = model.ops[0].num_entries  # embed_src's rows
        src, dst, labels = mod.synthetic_batch(batch, built[0].dims[1], vocab, seed=5)
        model.set_batch({built[0]: src, built[1]: dst}, labels)
    else:
        toks, posa, labels = mod.synthetic_lm_batch(batch, built[0].dims[1],
                                                    z["kw"]["vocab_size"], seed=0)
        model.set_batch({built[0]: toks, built[1]: posa}, labels)
    return model


def zoo_per_step(fo, model, name):
    """Launches of each of this repo's kernels in one step of a zoo model:
    SGD one per 64 leaves (``sgd_launch_plan``), Adam one per leaf, the
    flash kernels one per attention layer."""
    numels = [w.numel() for ws in model._params.values() for w in ws.values()]
    attn = sum(op._type == "MultiHeadAttention" for op in model.ops)
    kind = ZOO[name]["opt"][0]
    return {**NO_LAUNCH, "fused_sgd_update": len(fo.sgd_launch_plan(numels)) if kind == "sgd"
            else 0, "fused_adam_update": len(numels) if kind == "adam" else 0,
            "flash_fwd": attn, "flash_bwd_dkdv": attn, "flash_bwd_dq": attn}


def zoo_train(ft, fo, kernels, name, smi):
    """One zoo model at full width: the wrappers' launches at the eager step
    and the capture, the compiled and eager steps in turns, the profiled
    compiled step (device ms, busy share, launches per step from the
    profiler, top families), max_memory_allocated, the rate, the predict
    output's shape; the measured numbers for the search lines."""
    z = ZOO[name]
    free_models()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    model = zoo_model(ft, name)
    n_leaves = sum(len(ws) for ws in model._params.values())
    n_params = sum(w.numel() for ws in model._params.values() for w in ws.values())
    check(n_leaves == z["leaves"], f"{name} has {n_leaves} leaves, expected {z['leaves']}")
    per_step = zoo_per_step(fo, model, name)
    ms, losses = steps_ms(model)
    check_graph_run(model, 7, name)
    got = read_launches(kernels)
    check(got == {n: 2 * c for n, c in per_step.items()},
          f"{name}: wrapper launches {got} (eager step and capture), expected twice {per_step}")
    probs = model.predict_batch()  # the MoE transformer's forward launches K3 per layer
    launches = read_launches(kernels)
    out_dims = model.final_tensor().dims
    check(tuple(probs.shape) == tuple(out_dims) and bool(torch.isfinite(
        torch.from_numpy(probs)).all()), f"{name}: predict_batch {probs.shape} vs {out_dims}")
    # the optimizer kernel's byte bound: w read and written, g read, and
    # each slot read and written (SGD momentum one, Adam two), f32
    kind, _, momentum = z["opt"]
    slots = 2 if kind == "adam" else int(momentum > 0)
    opt_bound_ms = n_params * 4 * (3 + 2 * slots) / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = model.get_metrics().to_string()
    del model
    times = {"graph": [ms], "eager": []}
    for path in ("eager", "eager", "graph"):
        free_models()
        model = zoo_model(ft, name)
        with contextlib.nullcontext() if path == "graph" else ft.disable_graphs():
            times[path].append(steps_ms(model)[0])
        del model
    free_models()
    model = zoo_model(ft, name)
    kernel_ms = {}
    device_ms, busy = profile_steps(model, f"{name}, compiled step", times["graph"][0],
                                    per_step=per_step, kernel_ms=kernel_ms)
    del model
    free_models()
    samples = z["batch"]
    unit = (lambda m: f"{samples * z['tokens'] * 1e3 / m:.0f} tokens/s") if z["tokens"] else \
        (lambda m: f"{samples * 1e3 / m:.1f} samples/s")
    log(f"[models] {z['label']}: {n_params:,} parameters in {n_leaves} leaves; losses "
        f"{['%.5f' % x for x in losses]}; {metrics}")
    for path in ("graph", "eager"):
        log(f"[models] {name} {'compiled' if path == 'graph' else 'eager'} step: "
            f"{' / '.join(f'{m:.3f}' for m in times[path])} ms/step, "
            f"{' / '.join(unit(m) for m in times[path])}")
    log(f"[models] {name}: device {device_ms:.3f} ms/step, busy {busy:.1f}% of the first "
        f"compiled run's step (device ceiling {unit(device_ms)}); max_memory_allocated "
        f"{peak:.2f} GiB; launches per step {per_step}; card {smi}")
    opt_kernel = "fused_adam_update" if kind == "adam" else "fused_sgd_update"
    log(f"[models] {name}: {opt_kernel} {kernel_ms.get(opt_kernel, 0.0):.4f} ms/step over "
        f"{per_step[opt_kernel]} launch(es) and {n_params * 4 / 2**30:.2f} GiB of f32 "
        f"weights, against its byte bound {opt_bound_ms:.4f} ms; flash kernels "
        f"{ {k: round(v, 4) for k, v in kernel_ms.items() if k.startswith('flash')} } ms/step")
    return launches, dict(graph_ms=sum(times["graph"]) / len(times["graph"]),
                          graph_device_ms=device_ms)


def zoo_parity(ft, fa, kernels, name):
    """f32 weights and optimizer state after 2 steps of three runs from the
    same weights and batch: compiled with the kernels, eager with the
    kernels, eager with the plain versions (the plain update and, for the
    MoE transformer, the flash kernels' plain versions).  Compiled vs eager
    is held at GRAPH_TOL; kernel vs plain at the fused update's tolerance,
    and at the transformer's where attention's summation order differs."""
    kw = ZOO_PARITY_KW.get(name)

    def run(graph, fused):
        free_models()
        model = zoo_model(ft, name, kw=kw, compute_dtype="float32", fused_optimizer=fused)
        before = read_launches(kernels)
        plain = contextlib.nullcontext() if fused else fa.plain_versions()
        with contextlib.nullcontext() if graph else ft.disable_graphs(), plain:
            for _ in range(2):
                model.train_iteration()
        model.sync()
        used = {n: c - before[n] for n, c in read_launches(kernels).items()}
        check(fused or not any(used.values()), f"{name}: the plain path launched {used}")
        check(not fused or any(used.values()), f"{name}: the kernel path launched nothing")
        if graph:
            check_graph_run(model, 2, f"{name} f32")
        return state_of(model)

    compiled, eager, plain = run(True, True), run(False, True), run(False, False)
    g_worst, g_bitwise = compare_states(compiled, eager, GRAPH_TOL, f"{name} compiled/eager")
    tol = LM_PARITY_TOL if name == "transformer_moe" else PARITY_TOL
    p_worst, _ = compare_states(eager, plain, tol, f"{name} kernel/plain")
    log(f"[models] parity f32 {name}{' ' + str(kw) if kw else ''}, 2 steps: compiled vs eager "
        f"max |d| {g_worst:.3e} ({'bitwise equal' if g_bitwise else 'not bitwise'}; limit "
        f"rtol 1e-6, atol 1e-6); kernels vs plain versions max |d| {p_worst:.3e} (limit rtol "
        f"{tol['rtol']:g}, atol {tol['atol']:g})")


def zoo_search(ft, measured, smi, out_dir):
    """Each new model's data-parallel step on one card simulated from a
    table of its own ops measured on the card here (calibrate, one part),
    beside the compiled step measured above; then the offline search for an
    8-GPU node, whose configs must all be ones the port's training path
    runs (check_config) and compose over its 8-device mesh."""
    from flexflow_tpu_torch.parallel.mesh import axes_for_degrees, mesh_shape
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.simulator.simulator import Simulator
    from flexflow_tpu_torch.tools import calibrate, offline_search

    measured_path = os.path.join(out_dir, "zoo_measured_h100.json")
    fit_path = os.path.join(out_dir, "zoo_machine_h100.json")
    for path in (measured_path, fit_path):
        if os.path.exists(path):
            os.remove(path)
    names = {"resnet50": "resnet", "inception_v3": "inception"}
    for name, z in ZOO.items():
        _, _, batch, kw = offline_search.MODELS[names.get(name, name)]
        check((batch, kw) == (z["batch"], z["kw"]),
              f"the tools' {name} {batch, kw} is not phase 9's {z['batch'], z['kw']}")
    t0 = time.perf_counter()
    # the zoo's own ops alone: no report keys first (phase 20's window
    # measures those)
    with environ({"FF_REPORT_KEYS_PATH": os.path.join(out_dir, "no_keys.json")}):
        r = calibrate.calibrate([(names.get(n, n), ZOO[n]["batch"]) for n in ZOO], devices=1,
                                dp_parts=(1,), compute_dtype="bfloat16", out=measured_path,
                                fit_out=fit_path, device="cuda", verbose=False)
    log(f"[search] zoo calibration: {r['measured']} measured points, every op of the six "
        f"models at one part, forward and backward, in {time.perf_counter() - t0:.1f} s")
    mm = H100MachineModel.calibrated(path=fit_path, num_devices=1)
    for name in ZOO:
        model = offline_search.build_model(names.get(name, name), ZOO[name]["batch"], 1,
                                           "cuda", "bfloat16")
        dp = {op.name: ft.ParallelConfig.data_parallel(op.output.num_dims, 1)
              for op in model.ops}
        table = Simulator(mm, calibration_cost(mm, measured_path))
        sim_ms = table.simulate_runtime(model, dp) * 1e3
        check(table.cost.stats["analytic"] == 0, f"{name}: a DP-1 op was not measured")
        got = measured[name]
        log(f"[search] {name} DP-1 simulated {sim_ms:.3f} ms/step from its measured table; "
            f"measured compiled step {got['graph_ms']:.3f} ms/step (device "
            f"{got['graph_device_ms']:.3f}): simulated/measured {sim_ms / got['graph_ms']:.3f} "
            f"compiled, {sim_ms / got['graph_device_ms']:.3f} device; card {smi}")
    sizes, axes = mesh_shape(NODE_GPUS)
    node = H100MachineModel.calibrated(num_devices=NODE_GPUS)
    for name in ZOO:
        model = offline_search.build_model(names.get(name, name), ZOO[name]["batch"],
                                           NODE_GPUS, "cuda", "bfloat16")
        best = offline_search.run(model, NODE_GPUS, ZOO_SEARCH_BUDGET, seed=0, machine_model=node)
        for op in model.ops:
            op.check_config(best[op.name])  # raises on a split training rejects
            axes_for_degrees(axes, sizes, best[op.name].dims)
        log(f"[search] offline {best.engine} search, {name}, {NODE_GPUS} H100s, budget "
            f"{ZOO_SEARCH_BUDGET}: DP {best.dp_s * 1e3:.3f} ms, best {best.best_s * 1e3:.3f} ms "
            f"simulated ({best.dp_s / best.best_s:.2f}x; {node.source})")


def models_phase(ft, fo, fa, kernels, smi, out_dir):
    """Phase 9: the rest of the zoo at full width through the compiled
    step, f32 parity on the card, and the search lines.  Returns the
    kernels' wrapper launches of the main-path runs (the eager first steps
    and the captures)."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    launches = dict.fromkeys(kernels, 0)
    measured = {}
    for name in ZOO:
        got, measured[name] = zoo_train(ft, fo, kernels, name, smi)
        launches = {n: launches[n] + got[n] for n in kernels}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    for name in ZOO:
        zoo_parity(ft, fa, kernels, name)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    free_models()
    zoo_search(ft, measured, smi, out_dir)
    log(f"[models] phase 9 took {time.perf_counter() - t0:.1f} s; wrapper launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 10

GEN = dict(P=256, N=256)       # (a): LM["batch"] rows, P + N = LM["seq_length"]
BEAM = dict(B=4, K=4, P=64, N=64)
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1234)
SAMPLED = dict(P=64, N=64)     # sampled generate: LM["batch"] rows
MOE_GEN = dict(P=128, N=128)
NMT_GEN = dict(batch=64, seq_length=20, max_len=20)
ENGINE = dict(max_batch=16, max_seq=512, kv_block=16, max_new_tokens=128)
TRAFFIC = dict(requests=64, prompt=(16, 256), new=(16, 128), shared=8, prefix=128, tail=64)
# The f32 oracle: where a full-sequence forward's argmax differs from a
# decoded token, the two tokens' probabilities under that forward must lie
# within this share of the top one (f32 sums in another order, TF32 off).
F32_GAP_TOL = 1e-4
# bf16 decoding has no exact reference: every token that bf16 generate or
# the engine chose must have an f32 probability (the f32 model with the
# same weights, full forward over the same tokens) within this share of
# the top one, a few bf16 roundings of a logit.  The same bound holds the
# engine (decode steps of max_batch rows, B = 1 prefill) against generate
# (B rows) at their first differing token: the card's GEMMs round
# differently at different batch shapes, so a near-tie may break the
# other way.
BF16_GAP_TOL = 2.0 ** -5


def decode_lm(ft, build_transformer, dtype, machine=None, strategies=None, **kw):
    """The bench transformer (LM) for decoding: random weights from seed
    0, so the bf16 and the f32 model hold the same weights (on the default
    machine, or ``machine``; under ``strategies`` on a mesh)."""
    shape = {k: v for k, v in LM.items() if k != "batch"}
    shape.update(kw)
    model = ft.FFModel(ft.FFConfig(batch_size=LM["batch"], compute_dtype=dtype,
                                   strategies=dict(strategies or {})))
    tok, pos, _ = build_transformer(model, LM["batch"], **shape)
    model.compile(ft.SGDOptimizer(lr=0.001), "sparse_categorical_crossentropy", ["accuracy"],
                  machine=machine)
    model.init_layers(seed=0)
    return model, tok, pos


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def graphed_vs_eager(ft, label, call, steps, tokens):
    """``call`` through the decode graphs (a first call of the signature:
    eager first step and capture; then a replayed call) and eagerly;
    returns (outputs, replayed call ms), having checked them equal."""
    def parts(x):
        return x if isinstance(x, tuple) else (x,)

    first, first_ms = timed_ms(call)
    out, ms = timed_ms(call)
    with ft.disable_graphs():
        eager, eager_ms = timed_ms(call)
    for got in (first, out):
        check(all(np.array_equal(a, b) for a, b in zip(parts(got), parts(eager))),
              f"{label}: graphed and eager outputs differ")
    log(f"[decode] {label}: graphed {ms:.1f} ms a call ({ms / steps:.4f} ms a step, "
        f"{tokens / ms * 1e3:,.0f} tokens/s), first call {first_ms:.1f} ms (eager first step "
        f"and capture), eager {eager_ms:.1f} ms ({eager_ms / steps:.4f} ms a step); graphed == "
        "eager: True")
    return out, ms


def profile_decode(model, label, call, steps):
    """Device ms and kernel launches per decode step of one replayed call."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows if not r[0].startswith("Memcpy"))
    log(f"[decode] {label}, profiled: device {busy_us / steps / 1e3:.4f} ms a step, "
        f"{launches / steps:.1f} kernel launches a step ({len(rows)} kernel names)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[decode]   {us / steps / 1e3:8.4f} ms/step {count / steps:5.1f}x/step  {key[:90]}")
    return busy_us / steps / 1e3, launches / steps


def f32_probs(model, tok, pos, seqs):
    """Full-sequence forward probabilities (float32, on the card) of up to
    LM["batch"] token rows, zero-padded to the model's sequence length."""
    B, S = LM["batch"], LM["seq_length"]
    toks = np.zeros((B, S), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    posa = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    model.set_batch({tok: toks, pos: posa}, np.zeros((B, S), np.int32))
    return model._eval()[model.final_tensor().guid]


def gap(probs_row, a, b):
    """The probabilities of tokens a and b, as a share of the top one."""
    top = float(probs_row.max())
    return abs(float(probs_row[a]) - float(probs_row[b])) / top


def oracle_check(ft, build_transformer, kernels, prompt, smi):
    """(a), f32: generate, then one full-sequence forward (K3) over prompt +
    generated tokens; its argmax at every decoded position must be the
    generated token, or within F32_GAP_TOL of it.  Returns the kernels'
    launches in that forward."""
    P, N = GEN["P"], GEN["N"]
    model, tok, pos = decode_lm(ft, build_transformer, "float32")
    out = model.generate(prompt, N)
    model._gen_cache.clear()
    reset_launches(kernels)
    probs = f32_probs(model, tok, pos, np.concatenate([prompt, out], axis=1))
    launches = read_launches(kernels)
    check(launches == {**NO_LAUNCH, "flash_fwd": LM["num_layers"]},
          f"oracle forward launches {launches}")
    dec = probs[:, P - 1:P + N - 1]                     # predicts tokens P..P+N-1
    arg = dec.argmax(-1).cpu().numpy()
    diff = np.argwhere(arg != out)
    worst = 0.0
    for b, t in diff:
        g = gap(dec[b, t], arg[b, t], out[b, t])
        worst = max(worst, g)
        log(f"[decode]   oracle: row {b} position {P + t}: forward argmax {arg[b, t]}, "
            f"decoded {out[b, t]}, gap {g:.3e} of the top probability")
    check(worst <= F32_GAP_TOL, f"f32 oracle gap {worst:.3e} > {F32_GAP_TOL}")
    log(f"[decode] (a) f32 oracle: {LM['batch']}x{P + N} full forward through K3 "
        f"({launches['flash_fwd']} launches) against f32 generate: {arg.size - len(diff)} of "
        f"{arg.size} argmaxes equal the decoded tokens, the rest within gap {worst:.3e} "
        f"(tolerance {F32_GAP_TOL:g} of the top probability; TF32 off); card {smi}")
    return launches, model, tok, pos


def bf16_oracle(f32, label, seqs, starts, smi):
    """Every token a bf16 path generated (``seqs[i][starts[i]:]``) against
    the f32 model's full forward over the same token rows, 16 rows a
    forward: the token's f32 probability lies within BF16_GAP_TOL of the
    forward's top one at every generated position."""
    model, tok, pos = f32
    worst, count, differ = 0.0, 0, 0
    for j in range(0, len(seqs), LM["batch"]):
        chunk = seqs[j:j + LM["batch"]]
        probs = f32_probs(model, tok, pos, chunk)
        for row, s in enumerate(chunk):
            st = starts[j + row]
            p = probs[row, st - 1:len(s) - 1]                # predicts s[st:]
            want = torch.as_tensor(s[st:], dtype=torch.long, device=p.device)
            top = p.max(-1).values
            g = (top - p.gather(1, want[:, None])[:, 0]) / top
            worst = max(worst, float(g.max()))
            differ += int((g > 0).sum())
            count += want.numel()
    check(worst <= BF16_GAP_TOL, f"{label}: bf16 tokens against the f32 forward: gap "
                                 f"{worst:.3e} > {BF16_GAP_TOL}")
    log(f"[serve] {label} against the f32 full forward at every generated position: "
        f"{count - differ} of {count} tokens are its argmax, the rest within gap {worst:.3e} "
        f"(tolerance {BF16_GAP_TOL:g} of the top probability; TF32 off); card {smi}")


def traffic():
    """TRAFFIC from numpy seed 0: random prompts and lengths, then requests
    that share one prefix."""
    rng = np.random.default_rng(0)
    T = TRAFFIC
    reqs = [(rng.integers(0, LM["vocab_size"], size=int(rng.integers(T["prompt"][0],
                                                                     T["prompt"][1] + 1)),
                          dtype=np.int32), int(rng.integers(T["new"][0], T["new"][1] + 1)))
            for _ in range(T["requests"])]
    prefix = rng.integers(0, LM["vocab_size"], size=T["prefix"], dtype=np.int32)
    for _ in range(T["shared"]):
        tail = rng.integers(0, LM["vocab_size"], size=int(rng.integers(1, T["tail"] + 1)),
                            dtype=np.int32)
        reqs.append((np.concatenate([prefix, tail]),
                     int(rng.integers(T["new"][0], T["new"][1] + 1))))
    return reqs


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def serve(ft, lm, paged, reqs, smi):
    """(d): one engine, warmed up, serving every request submitted at once;
    returns (tokens per request, the engine)."""
    from flexflow_tpu_torch.runtime.decode_graph import cache_leaves
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    free_models()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(lm, paged=paged, **ENGINE)
    check(eng._paged == (paged == "on"), f"engine paged={paged}: {eng._paged}")
    t0 = time.perf_counter()
    warm = eng.warmup()
    warm_s = time.perf_counter() - t0
    hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs]
    t0 = time.perf_counter()
    with eng:
        outs = [h.result(600) for h in hs]
    wall = time.perf_counter() - t0
    st = eng.stats()
    check(st["completed"] == len(reqs), f"engine paged={paged}: {st}")
    check(st["graphs_captured"] == warm, f"engine paged={paged}: {st['graphs_captured']} "
                                         f"graphs captured, {warm} in the warm-up")
    kv_bytes = sum(c.numel() * c.element_size() for c in cache_leaves(eng._caches))
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs if h.tpot_s is not None]
    kv = st.get("kv", {})
    log(f"[serve] (d) engine {'paged' if eng._paged else 'dense'}: {len(reqs)} requests, "
        f"{st['tokens_out']} tokens in {wall:.3f} s = {st['tokens_out'] / wall:,.1f} generated "
        f"tokens/s; TTFT p50 {pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; TPOT p50 "
        f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; mean occupancy "
        f"{st['mean_occupancy']:.2f} of {ENGINE['max_batch']}, {st['step_iterations']} token "
        f"boundaries; card {smi}")
    log(f"[serve]   graphs captured {warm} in the warm-up ({warm_s:.2f} s), "
        f"{st['graphs_captured'] - warm} after it; prefill signatures "
        f"{st['prefill_compiles']}; prefix hits {kv.get('prefix_hits', 0)} "
        f"({kv.get('prefill_tokens_saved', 0)} prefill tokens saved, "
        f"{kv.get('cow_copies', 0)} copy-on-write tails); KV pool {kv_bytes / 2**20:.1f} MiB; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return outs, eng


def engine_vs_generate(lm, f32, reqs, outs, smi):
    """(d): each request against generate(prompt[None], n) of the bf16
    model; a request that differs is reported with the f32 gap at its first
    differing token, which must be within BF16_GAP_TOL."""
    model, tok, pos = f32
    diffs = []
    wants = {}
    t0 = time.perf_counter()
    for i, ((p, n), got) in enumerate(zip(reqs, outs)):
        want = wants[(p.tobytes(), int(n))] = lm.generate(p[None], n)[0]
        if not np.array_equal(got, want):
            k = int(np.argmax(got != want))  # no eos: both are n long
            diffs.append((i, k, int(got[k]), int(want[k])))
    gen_s = time.perf_counter() - t0
    lm._gen_cache.clear()
    worst = 0.0
    for j in range(0, len(diffs), LM["batch"]):
        chunk = diffs[j:j + LM["batch"]]
        seqs = [np.concatenate([reqs[i][0], outs[i][:k]]) for i, k, _, _ in chunk]
        probs = f32_probs(model, tok, pos, seqs)
        for row, (i, k, a, b) in enumerate(chunk):
            g = gap(probs[row, len(seqs[row]) - 1], a, b)
            worst = max(worst, g)
            log(f"[serve]   request {i}: first differs at token {k} (engine {a}, generate "
                f"{b}); f32 gap {g:.3e} of the top probability")
    check(worst <= BF16_GAP_TOL, f"engine vs generate: gap {worst:.3e} > {BF16_GAP_TOL}")
    log(f"[serve] (d) engine vs generate (bf16, B = 1 signatures, {gen_s:.1f} s): "
        f"{len(reqs) - len(diffs)} of {len(reqs)} requests equal; {len(diffs)} differ at a "
        f"near-tie, worst f32 gap {worst:.3e} (tolerance {BF16_GAP_TOL:g}); card {smi}")
    return wants


def http_check(ft, lm, reqs):
    """(e): the ServingAPI on an ephemeral port in front of a paged engine
    that was not warmed up, so that it captures its graphs in its worker
    thread."""
    import urllib.request

    from flexflow_tpu_torch.serving.api import ServingAPI
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    picks = sorted(reqs, key=lambda r: r[0].size + r[1])[:8]
    eng = InferenceEngine(lm, paged="on", **ENGINE)
    with eng, ServingAPI(eng, port=0) as api:
        port = api.port
        for path in ("/healthz", "/readyz"):
            with urllib.request.urlopen(f"{api.url}{path}", timeout=60) as r:
                check(r.status == 200, f"{path}: {r.status}")
        t0 = time.perf_counter()
        for p, n in picks:
            body = json.dumps({"prompt": [int(t) for t in p], "max_new_tokens": n}).encode()
            req = urllib.request.Request(f"{api.url}/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                got = np.asarray(json.loads(r.read())["tokens"], np.int32)
            # the same request straight to the engine, alone as it was
            check(np.array_equal(got, eng.submit(p, n).result(300)),
                  "HTTP and engine tokens differ")
        ms = (time.perf_counter() - t0) * 1e3
    log(f"[serve] (e) ServingAPI on port {port}: 8 POST /generate equal the engine's tokens "
        f"for the same requests ({ms:.0f} ms for both, one at a time); /healthz and /readyz "
        f"200; {eng.graphs_captured()} graphs captured in the engine's worker thread")


def serving_phase(ft, kernels, smi):
    """Phase 10: decoding and serving at full width.  Returns the kernels'
    wrapper launches (none on the decode paths, checked; K3 in the f32
    oracle's forward) and generate's tokens for each request of the burst
    (phase 12 holds the pool against them)."""
    from flexflow_tpu_torch.models import nmt
    from flexflow_tpu_torch.models.transformer import build_transformer

    t_phase = t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[serve] {what} took {now - t_lap:.1f} s")
        t_lap = now

    free_models()
    rng = np.random.default_rng(0)
    B, V = LM["batch"], LM["vocab_size"]
    P, N = GEN["P"], GEN["N"]
    prompt = rng.integers(0, V, size=(B, P), dtype=np.int32)
    reset_launches(kernels)
    # (a) -----------------------------------------------------------------
    lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    out, ms = graphed_vs_eager(ft, f"(a) transformer B{B} P{P} N{N} bf16 greedy generate",
                               lambda: lm.generate(prompt, N), P + N - 1, B * N)
    run = next(iter(lm._gen_cache.values()))
    log(f"[decode] (a) {ms / N:.4f} ms per generated token position ({B} rows), capture "
        f"{run.capture_s * 1e3:.1f} ms, {run.captures} graph; card {smi}")
    profile_decode(lm, "(a) generate", lambda: lm.generate(prompt, N), P + N - 1)
    lap("(a)")
    # (b) -----------------------------------------------------------------
    bp = prompt[:BEAM["B"], :BEAM["P"]]
    (seqs, scores), _ = graphed_vs_eager(
        ft, f"(b) beam_search K{BEAM['K']} B{BEAM['B']} P{BEAM['P']} N{BEAM['N']}",
        lambda: lm.beam_search(bp, BEAM["N"], beam_size=BEAM["K"]),
        BEAM["P"] + BEAM["N"] - 1, BEAM["B"] * BEAM["N"])
    check(bool(np.isfinite(scores).all()) and bool((np.diff(scores, axis=1) <= 0).all()),
          f"beam scores not finite and best first: {scores}")
    kw = dict(SAMPLING)
    sp, sn = SAMPLED["P"], SAMPLED["N"]
    sampled, _ = graphed_vs_eager(ft, f"(b) sampled generate B{B} P{sp} N{sn} {kw}",
                                  lambda: lm.generate(prompt[:, :sp], sn, **kw), sp + sn - 1,
                                  B * sn)
    # every token within its step's top-k: the probabilities the step saw,
    # recomputed by eager decode steps at the same shapes
    tok_t, pos_t = lm.resolve_decode_inputs()
    caches = lm.init_decode_caches(B, sp + sn)
    seq = torch.tensor(np.concatenate([prompt[:, :sp], sampled], axis=1), device=lm.device)
    outside = 0
    for t in range(sp + sn - 1):
        probs, _ = lm.decode_step(lm._params, caches, seq[:, t], t, tok_t, pos_t)
        if t >= sp - 1:  # step t drew token t + 1
            kth = torch.sort(probs, dim=-1, descending=True).values[:, kw["top_k"] - 1]
            outside += int((probs.gather(1, seq[:, t + 1:t + 2])[:, 0] < kth).sum())
    check(outside == 0, f"{outside} sampled tokens outside their step's top-{kw['top_k']}")
    log(f"[decode] (b) sampled: every one of the {B * sn} tokens within its step's top-"
        f"{kw['top_k']} (eager decode steps recompute the probabilities)")
    del caches
    lm._gen_cache.clear()
    lap("(b)")
    # (c) -----------------------------------------------------------------
    moe, _, _ = decode_lm(ft, build_transformer, "bfloat16", moe_every=2, num_experts=8)
    mp = prompt[:, :MOE_GEN["P"]]
    _, ms = graphed_vs_eager(ft, f"(c) MoE transformer B{B} P{MOE_GEN['P']} N{MOE_GEN['N']}",
                             lambda: moe.generate(mp, MOE_GEN["N"]),
                             MOE_GEN["P"] + MOE_GEN["N"] - 1, B * MOE_GEN["N"])
    log(f"[decode] (c) MoE {ms / MOE_GEN['N']:.4f} ms per generated token position; card {smi}")
    del moe
    free_models()
    nm = ft.FFModel(ft.FFConfig(batch_size=NMT_GEN["batch"], compute_dtype="bfloat16"))
    src, dst, _ = nmt.build_nmt(nm, NMT_GEN["batch"], seq_length=NMT_GEN["seq_length"])
    nm.compile(ft.AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", ["accuracy"])
    nm.init_layers(seed=0)
    src_toks = rng.integers(0, 20 * 1024, size=(NMT_GEN["batch"], NMT_GEN["seq_length"]),
                            dtype=np.int32)

    def translate():
        return nmt.greedy_translate(nm, src, dst, src_toks, NMT_GEN["max_len"])

    _, ms = graphed_vs_eager(ft, f"(c) NMT greedy_translate B{NMT_GEN['batch']} seq "
                                 f"{NMT_GEN['seq_length']} hidden 2048 vocab 20480",
                             translate, NMT_GEN["max_len"], NMT_GEN["batch"] * NMT_GEN["max_len"])
    log(f"[decode] (c) NMT {ms / NMT_GEN['max_len']:.4f} ms per generated token position; "
        f"card {smi}")
    profile_decode(nm, "(c) NMT", translate, NMT_GEN["max_len"])
    del nm
    lap("(c)")
    # (d) -----------------------------------------------------------------
    reqs = traffic()
    outs = {}
    for paged in ("off", "on"):
        outs[paged], eng = serve(ft, lm, paged, reqs, smi)
    same = sum(np.array_equal(a, b) for a, b in zip(outs["off"], outs["on"]))
    check(same == len(reqs), f"dense and paged engines differ on {len(reqs) - same} requests")
    log(f"[serve] (d) dense == paged: all {len(reqs)} requests equal")
    lap("(d)")
    del eng
    # (e) -----------------------------------------------------------------
    http_check(ft, lm, reqs)
    lap("(e)")
    decode_launches = read_launches(kernels)
    check(decode_launches == NO_LAUNCH, f"decode paths launched {decode_launches}")
    # the f32 oracle and the engine's gaps ---------------------------------
    oracle_launches, model, tok, pos = oracle_check(ft, build_transformer, kernels, prompt,
                                                    smi)
    lap("the f32 oracle")
    bf16_oracle((model, tok, pos), "(a) bf16 generate",
                list(np.concatenate([prompt, out], axis=1)), [P] * B, smi)
    bf16_oracle((model, tok, pos), "(d) engine",
                [np.concatenate([p, o]) for (p, _), o in zip(reqs, outs["on"])],
                [p.size for p, _ in reqs], smi)
    lap("the bf16 oracle")
    wants = engine_vs_generate(lm, (model, tok, pos), reqs, outs["on"], smi)
    lap("engine vs generate")
    del lm, model
    free_models()
    log(f"[serve] phase 10 took {time.perf_counter() - t_phase:.1f} s; wrapper launches on "
        f"the decode paths {decode_launches}, in the oracle's forward {oracle_launches}")
    return oracle_launches, wants


# ------------------------------------------------------------------ phase 11

OBS_STEPS = 20
OBS_WINDOW = (2, 10)    # steps timed by CUDA events: after the capture, before a drain
OBS_DRAINS = (9, 19)    # get_metrics after these steps: the losses compared bitwise
OBS_ENV = {"FF_TELEMETRY": "1", "FF_HEALTH": "1", "FF_HEALTH_SAMPLE_EVERY": "10",
           "FF_MEMPLANE": "1", "FF_OPPROF": "10", "FF_OPPROF_BUDGET_S": "30",
           "FF_METRICS_HOST": "127.0.0.1"}
OBS_REQUESTS = 16
# the step spans' median (device time of each replay) against the phase's
# own CUDA-event ms/step over the window (replays back to back)
OBS_SPAN_TOL = 0.10


@contextlib.contextmanager
def environ(env):
    """``env`` set for the block; the telemetry singletons closed after it."""
    from flexflow_tpu_torch.observability import events, metrics

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        events.reset_active()
        metrics.stop()


def obs_lm_run(ft, build_transformer, synthetic_lm_batch, label):
    """OBS_STEPS compiled steps of the full-width transformer: (mean losses
    at OBS_DRAINS, CUDA-event ms/step over OBS_WINDOW, every weight, model)."""
    model = lm_model(ft, build_transformer, synthetic_lm_batch,
                     lambda m: ft.SGDOptimizer(m, lr=0.001), **LM)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    for step in range(OBS_STEPS):
        if step == OBS_WINDOW[0]:
            model.sync()
            start.record()
        model.train_iteration()
        if step == OBS_WINDOW[1] - 1:
            end.record()
        if step in OBS_DRAINS:
            model.get_metrics()
            losses.append(model.last_loss)
    model.sync()
    check_graph_run(model, OBS_STEPS, label)
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite losses {losses}")
    ms = start.elapsed_time(end) / (OBS_WINDOW[1] - OBS_WINDOW[0])
    return losses, ms, state_of(model), model


def obs_trace_gates(model, trace, ms, launches_off, launches_on, smi):
    """Gates (b)-(f) on the traced run's records."""
    import urllib.request

    from flexflow_tpu_torch.observability import metrics
    from flexflow_tpu_torch.simulator.cost_model import MEASURE_ITERS, MEASURE_WARMUP
    from flexflow_tpu_torch.tools import trace_report

    recs = trace_report.parse_trace(trace)
    steps = [r for r in recs if r.get("t") == "span" and r["name"] == "step"]
    # (f) one step span per step, folded by the port's reader
    report = trace_report.render_report(recs)
    check(len(steps) == OBS_STEPS, f"(f) {len(steps)} step spans for {OBS_STEPS} steps")
    firsts = [s["attrs"]["step"] for s in steps if s["attrs"]["first"]]
    check(firsts == [0, 1] and steps[1]["attrs"].get("capture") is True,
          f"(f) first/capture steps {firsts}")
    check(f"steady-state over {OBS_STEPS - 2} steps" in report, "(f) trace_report: "
          + report[:600])
    # (b) the step spans against the phase's own events
    steady = [s for s in steps if not s["attrs"]["first"]]
    span_ms = float(np.median([s["dur"] for s in steady])) * 1e3
    sps = float(np.median([s["attrs"]["samples_per_sec"] for s in steady]))
    want_sps = LM["batch"] / ms * 1e3
    mfu = [s["attrs"]["mfu"] for s in steady]
    check(abs(span_ms - ms) <= OBS_SPAN_TOL * ms,
          f"(b) median step span {span_ms:.4f} ms vs {ms:.4f} ms/step by CUDA events")
    check(abs(sps - want_sps) <= OBS_SPAN_TOL * want_sps,
          f"(b) samples_per_sec {sps:.2f} vs {want_sps:.2f}")
    check(all(0.0 < x < 1.0 for x in mfu), f"(b) MFU {min(mfu)}..{max(mfu)}")
    fwd_flops = model._stepstats._statics()[0]
    hbm = [r for r in recs if r.get("name") == "hbm_bytes"
           and r["attrs"]["kind"] in ("in_use", "peak")]
    check(hbm and all(0 < r["v"] <= 80e9 for r in hbm),
          f"(b) hbm_bytes {[r['v'] for r in hbm]}")
    log(f"[obs] (b) median step span {span_ms:.4f} ms (device time of one replay) vs "
        f"{ms:.4f} ms/step by the phase's CUDA events over steps {OBS_WINDOW[0]}-"
        f"{OBS_WINDOW[1] - 1}: {abs(span_ms - ms) / ms:.2%} apart (tolerance "
        f"{OBS_SPAN_TOL:.0%}); samples_per_sec {sps:.2f} vs {want_sps:.2f}; MFU "
        f"{float(np.median(mfu)):.4f} of 989e12 bf16 dense (analytic forward "
        f"{fwd_flops / 1e9:.2f} GFLOP a sample, every dense row counted, x3 a training "
        f"step); hbm_bytes in use "
        f"{max(r['v'] for r in hbm if r['attrs']['kind'] == 'in_use') / 2**30:.2f} GiB, "
        f"peak {max(r['v'] for r in hbm if r['attrs']['kind'] == 'peak') / 2**30:.2f} GiB; "
        f"card {smi}")
    # (c) one capture at train_step, no retrace
    done = [r["attrs"] for r in recs if r.get("name") == "compile_done"]
    check([a["site"] for a in done] == ["train_step"] and not done[0]["retrace"]
          and (model._memplane.compiles, model._memplane.retraces) == (1, 0)
          and done[0].get("graph_pool_bytes", 0) > 0, f"(c) captures {done}")
    log(f"[obs] (c) capture ledger: 1 capture at train_step ({done[0]['wall_s'] * 1e3:.1f} "
        f"ms host, its graph pool {done[0]['graph_pool_bytes'] / 2**20:.1f} MiB from the "
        f"allocator's segments of that pool), 0 compile_retraces over {OBS_STEPS} steps")
    # (d) opprof measured every attention op, through K3-K5
    rt = [r["attrs"] for r in recs if r.get("name") == "op_runtime"]
    attn = sorted({a["op"] for a in rt if a["op"].startswith("attn")})
    check(len(attn) == LM["num_layers"] and all(
        a["measured_ms"] > 0 for a in rt if a["op"] in attn), f"(d) op_runtime {rt}")
    per_op = MEASURE_WARMUP + MEASURE_ITERS
    for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(launches_on[k] - launches_off[k] == per_op * len(attn),
              f"(d) {k}: {launches_on[k]} launches traced, {launches_off[k]} untraced; "
              f"expected {per_op} more per measured attention op")
    (passes,) = [r["attrs"] for r in recs if r.get("name") == "op_runtime_pass"]
    log(f"[obs] (d) opprof pass at step {passes['step']}: {passes['ops_measured']} of "
        f"{passes['ops_total']} ops in {passes['elapsed_s']:.2f} s; "
        + "; ".join(f"{a['op']} {a['which']} {a['measured_ms']:.4f} ms (predicted "
                    f"{a['predicted_ms']:.4f} ms, {a['src']})"
                    for a in rt if a["op"] == attn[0])
        + f"; K3-K5 each {per_op * len(attn)} more launches than untraced; card {smi}")
    top = sorted(rt, key=lambda a: -a["measured_ms"])[:6]
    for a in top:
        log(f"[obs]   {a['op']:>12s} {a['which']:8s} measured {a['measured_ms']:.4f} ms, "
            f"predicted {a['predicted_ms']:.4f} ms ({a['src']})")
    # (e) the live /metrics plane
    port = metrics.server_port()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        status, text = r.status, r.read().decode()
    ff_lines = [ln for ln in text.splitlines() if ln.startswith("ff_")]
    check(status == 200 and ff_lines, f"(e) /metrics {status}: {text[:300]}")
    log(f"[obs] (e) GET /metrics on :{port}: 200, {len(ff_lines)} ff_ series lines "
        f"(e.g. {[ln for ln in ff_lines if ln.startswith('ff_samples_total')]})")


def obs_guard(ft, build_alexnet, trace):
    """(g): full-width AlexNet under the guard, traced: a batch with a NaN
    replayed through the captured step gives one health nonfinite_loss and
    one step_skipped event, and leaves every weight bitwise as it was."""
    from flexflow_tpu_torch.tools import trace_report

    model = main_model(ft, build_alexnet, sgd_optimizer(ft), batch=BATCH)
    inp = model.input_tensors[0]
    x = np.random.default_rng(1).standard_normal((BATCH,) + inp.dims[1:], dtype=np.float32)
    y = model._batch["label"].cpu().numpy()
    model.set_batch({inp: x}, y)
    for _ in range(2):
        model.train_iteration()
    before = state_of(model)
    x[1, 3, 2, 1] = np.nan
    model.set_batch({inp: x}, y)
    model.train_iteration()
    model.get_metrics()
    model.sync()
    check_graph_run(model, 3, "(g) AlexNet")
    _, bitwise = compare_states(before, state_of(model), dict(rtol=0, atol=0), "(g)")
    recs = trace_report.parse_trace(trace)
    health = [r["attrs"] for r in recs if r.get("name") == "health"
              and r["attrs"]["kind"] == "nonfinite_loss"]
    skipped = [r["attrs"] for r in recs if r.get("name") == "step_skipped"]
    check(bitwise and len(health) == 1 and health[0]["count"] == 1
          and len(skipped) == 1 and skipped[0]["count"] == 1,
          f"(g) bitwise {bitwise}, health {health}, step_skipped {skipped}")
    log(f"[obs] (g) AlexNet batch {BATCH}, a NaN batch replayed under FF_SKIP_NONFINITE: one "
        f"health nonfinite_loss event ({health[0]}), one step_skipped event ({skipped[0]}); "
        f"every weight and slot ({len(before)} leaves) bitwise unchanged")


def obs_serving(ft, build_transformer, tmp, smi):
    """(h): phase 10's engine configuration, OBS_REQUESTS of its requests,
    without telemetry and then traced with FF_TRACE_SAMPLE=1 and the
    capture ledger: the same tokens, a trace id on every request, one
    serve_request_done each, no capture after warmup(), and /metrics on
    the API server."""
    import urllib.request

    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.serving.api import ServingAPI
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.tools import trace_report

    lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    reqs = traffic()[:OBS_REQUESTS]
    out = {}
    for traced in (False, True):
        path = os.path.join(tmp, "serve.jsonl")
        log_ = EventLog(path) if traced else None
        env = {"FF_TRACE_SAMPLE": "1", "FF_MEMPLANE": "1"} if traced else {}
        with environ(env):
            eng = InferenceEngine(lm, telemetry=log_, **ENGINE)
            warm = eng.warmup()
            hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs]
            t0 = time.perf_counter()
            with eng, ServingAPI(eng, port=0) as api:
                toks = [h.result(600) for h in hs]
                wall = time.perf_counter() - t0
                with urllib.request.urlopen(f"{api.url}/metrics", timeout=60) as r:
                    status, text = r.status, r.read().decode()
        st = eng.stats()
        check(status == 200 and any(ln.startswith("ff_") for ln in text.splitlines()),
              f"(h) API /metrics {status}: {text[:300]}")
        check(st["graphs_captured"] == warm, f"(h) {st['graphs_captured']} captures, {warm} "
                                             "in the warm-up")
        out[traced] = toks
        log(f"[obs] (h) engine {'traced' if traced else 'untraced'}: {len(reqs)} requests, "
            f"{st['tokens_out']} tokens in {wall:.3f} s ({st['tokens_out'] / wall:,.1f} "
            f"tokens/s); API /metrics 200; card {smi}")
        if not traced:
            continue
        log_.close()
        recs = trace_report.parse_trace(path)
        done = [r["attrs"] for r in recs if r.get("name") == "serve_request_done"]
        ids = {h.trace.trace_id for h in hs if h.trace is not None}
        check(len(ids) == len(reqs) and len(done) == len(reqs)
              and {a["trace_id"] for a in done} == ids,
              f"(h) {len(ids)} trace ids, {len(done)} serve_request_done records")
        check(eng._memplane.retraces == 0 and eng._memplane.compiles == warm,
              f"(h) ledger {eng._memplane.compiles} captures, {eng._memplane.retraces} "
              f"retraces; {warm} in the warm-up")
        pools = [r["attrs"].get("graph_pool_bytes", 0) for r in recs
                 if r.get("name") == "compile_done"]
        check(len(pools) == warm and all(b > 0 for b in pools),
              f"(h) graph_pool_bytes of the engine's captures {pools}")
        log(f"[obs] (h) the engine's {warm} captures in the ledger, each with its own "
            f"graph pool: {', '.join(f'{b / 2**20:.1f}' for b in pools)} MiB")
        chunks = sum(r.get("name") == "serve_decode_chunk" for r in recs)
        log(f"[obs] (h) every request traced and sampled: {len(done)} serve_request_done, "
            f"{chunks} serve_decode_chunk spans; ledger {warm} captures in warmup(), 0 "
            "retraces")
    same = all(np.array_equal(a, b) for a, b in zip(out[False], out[True]))
    check(same, "(h) the traced engine's tokens differ from the untraced one's")
    log(f"[obs] (h) the traced engine's tokens equal the untraced engine's on all "
        f"{len(reqs)} requests")
    del lm, eng
    free_models()


def observability_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels,
                        smi):
    """Phase 11: telemetry on the card.  Returns the kernels' launches."""
    t0 = time.perf_counter()
    reset_launches(kernels)
    free_models()
    off_losses, off_ms, off_state, _ = obs_lm_run(ft, build_transformer, synthetic_lm_batch,
                                                  "(a) untraced")
    launches_off = read_launches(kernels)
    free_models()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "ff_trace.jsonl")
        env = dict(OBS_ENV, FF_TELEMETRY_FILE=trace, FF_METRICS_PORT=str(free_port()),
                   # opprof's measurements go to a temporary corpus, never the
                   # committed measured_h100.json
                   FF_OPPROF_CORPUS=os.path.join(tmp, "corpus.json"))
        with environ(env):
            on_losses, on_ms, on_state, model = obs_lm_run(
                ft, build_transformer, synthetic_lm_batch, "(a) traced")
            launches_on = {k: v - launches_off[k] for k, v in read_launches(kernels).items()}
            _, bitwise = compare_states(off_state, on_state, dict(rtol=0, atol=0), "(a)")
            check(on_losses == off_losses and bitwise,
                  f"(a) losses {on_losses} traced vs {off_losses} untraced; weights bitwise "
                  f"{bitwise}")
            log(f"[obs] (a) transformer (phase 4's, B{LM['batch']} S{LM['seq_length']}), "
                f"{OBS_STEPS} compiled steps, telemetry off then FF_TELEMETRY=1 FF_HEALTH=1 "
                f"FF_MEMPLANE=1 FF_OPPROF=10 FF_METRICS_PORT: losses {on_losses} bitwise equal, "
                f"every weight ({len(on_state)} leaves) bitwise equal; ms/step by CUDA events "
                f"off {off_ms:.4f}, on {on_ms:.4f} ({on_ms / off_ms - 1:+.2%}, not gated); "
                f"card {smi}")
            obs_trace_gates(model, trace, on_ms, launches_off, launches_on, smi)
            del model
            free_models()
            with environ({"FF_SKIP_NONFINITE": "3"}):
                obs_guard(ft, build_alexnet, trace)
        free_models()
        obs_serving(ft, build_transformer, tmp, smi)
    launches = read_launches(kernels)
    log(f"[obs] phase 11 took {time.perf_counter() - t0:.1f} s; wrapper launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 12

POOL_ENGINE = dict(ENGINE, paged="on")
POOL_KILL_AT = 36            # (b): the burst's admission whose replica dies
POOL_HANG = (8, 3.0)         # (c): the admission whose replica wedges, seconds
POOL_HANG_REQUESTS = 24
POOL_HEDGE = dict(requests=4, prompt=32, new=64, hedge_ms=20.0)
POOL_SHED = dict(max_queue=2, posts=40)
# (f)'s end-to-end SLO: what one unfailed engine gives the burst's longest
# request (phase 10: TTFT p50 up to 3.6 s in the burst, TPOT p99 41 ms, 128
# new tokens: 8.9 s)
POOL_FLEET_SLO_MS = 10000.0
POOL_WAIT_S = 60.0           # bound on every wait for the pool to settle
# launches of the f32 oracle's full forwards (K3) in phase 12: the pool's
# own paths launch none
ORACLE_LAUNCHES = dict(NO_LAUNCH)


class Want:
    """generate(prompt[None], n)[0] of the bf16 model per request, memoized
    (phase 10's results seed it); each call's decode graph is dropped after
    it, so no generate graph holds card memory across the pools."""

    def __init__(self, lm, known=None):
        self.lm = lm
        self.memo = dict(known or {})

    def __call__(self, p, n):
        key = (p.tobytes(), int(n))
        if key not in self.memo:
            self.memo[key] = self.lm.generate(p[None], n)[0]
            self.lm._gen_cache.clear()
        return self.memo[key]


def token_gaps(want, f32, reqs, outs):
    """Phase 10's gap rule per request: (f32 gap at the first token that
    differs from generate, 0 when equal; worst f32 gap over every generated
    token against the full forward over the same tokens)."""
    model, tok, pos = f32
    before = read_launches(KERNELS)
    first = [0.0] * len(reqs)
    diffs = []
    for i, ((p, n), got) in enumerate(zip(reqs, outs)):
        w = want(p, n)
        if not np.array_equal(got, w):
            k = int(np.argmax(got != w))  # no eos: both are n long
            diffs.append((i, k, int(got[k]), int(w[k])))
    for j in range(0, len(diffs), LM["batch"]):
        chunk = diffs[j:j + LM["batch"]]
        seqs = [np.concatenate([reqs[i][0], outs[i][:k]]) for i, k, _, _ in chunk]
        probs = f32_probs(model, tok, pos, seqs)
        for row, (i, k, a, b) in enumerate(chunk):
            first[i] = gap(probs[row, len(seqs[row]) - 1], a, b)
    every = [0.0] * len(reqs)
    for j in range(0, len(reqs), LM["batch"]):
        seqs = [np.concatenate([p, o]) for (p, _), o in zip(reqs[j:j + LM["batch"]],
                                                          outs[j:j + LM["batch"]])]
        probs = f32_probs(model, tok, pos, seqs)
        for row, s in enumerate(seqs):
            st = reqs[j + row][0].size
            pr = probs[row, st - 1:len(s) - 1]
            w = torch.as_tensor(s[st:], dtype=torch.long, device=pr.device)
            top = pr.max(-1).values
            every[j + row] = float(((top - pr.gather(1, w[:, None])[:, 0]) / top).max())
    for k, v in read_launches(KERNELS).items():
        ORACLE_LAUNCHES[k] += v - before[k]
    return first, every, len(diffs)


def pool_tokens(label, want, f32, reqs, outs, smi):
    """Every request of a pool run under phase 10's gap rule (checked)."""
    first, every, ndiff = token_gaps(want, f32, reqs, outs)
    worst = max(max(first), max(every))
    check(worst <= BF16_GAP_TOL, f"{label}: gap {worst:.3e} > {BF16_GAP_TOL} (first "
                                 f"differences {max(first):.3e}, every token {max(every):.3e})")
    log(f"[pool] {label} tokens: {len(reqs) - ndiff} of {len(reqs)} requests equal "
        f"generate, {ndiff} differ first at a near-tie (worst f32 gap {max(first):.3e}); "
        f"every generated token within {max(every):.3e} of the f32 forward's top "
        f"probability (tolerance {BF16_GAP_TOL:g}); card {smi}")


def pool_config(**kw):
    from flexflow_tpu_torch.serving import ServeConfig

    base = dict(POOL_ENGINE, replica_timeout_s=30.0, restart_backoff_s=0.05,
                restart_cap_s=0.2)
    base.update(kw)
    return ServeConfig(**base)


def pool_burst(pool, reqs, timeout=600):
    """Every request submitted at once; (client handles, tokens, wall s),
    each client's done callbacks checked to fire exactly once."""
    import collections

    fires = collections.Counter()
    t0 = time.perf_counter()
    hs = [pool.submit(p, n, timeout_s=0) for p, n in reqs]
    for h in hs:
        h.add_done_callback(lambda r: fires.update([r.request_id]))
    outs = [h.result(timeout) for h in hs]
    wall = time.perf_counter() - t0
    check(len(fires) == len(reqs) and set(fires.values()) == {1},
          f"exactly once: {len(fires)} clients resolved of {len(reqs)}, fires {set(fires.values())}")
    return hs, outs, wall


def settle(cond, what):
    deadline = time.perf_counter() + POOL_WAIT_S
    while not cond():
        check(time.perf_counter() < deadline, f"{what} within {POOL_WAIT_S:g} s")
        time.sleep(0.01)


KERNELS = {}


def settled_allocated():
    """memory_allocated once the dropped pools' objects are collected and
    the allocator's cache is released."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def replica_bytes(pool):
    """The largest live replica's card memory: its KV pool and graph pools."""
    return max(b["kv"] + (b["graph_pools"] or 0) for b in pool.device_bytes().values())


def kv_clean(engines, what):
    for e in engines:
        kv = e._kvpool
        check(kv.slot_refs() == 0 and kv.stats()["blocks_promised"] == 0,
              f"{what}: {e.uid} slot refs {kv.slot_refs()}, {kv.stats()}")


def pool_events(path, *names):
    from flexflow_tpu_torch.tools import trace_report

    return [r for r in trace_report.parse_trace(path) if r.get("name") in names]


def pool_throughput(lm, reqs, want, f32, smi):
    """(a): ReplicaPool(lm, replicas=N), warmed up, over phase 10's burst;
    returns the largest replica footprint seen."""
    from flexflow_tpu_torch.serving import ReplicaPool

    footprint = 0
    for n in (1, 3):
        torch.cuda.reset_peak_memory_stats()
        pool = ReplicaPool(lm, config=pool_config(replicas=n), warmup=True)
        t0 = time.perf_counter()
        pool.start()
        warm_s = time.perf_counter() - t0
        warm = {k: v["engine"]["graphs_captured"] for k, v in pool.stats()["replicas"].items()}
        hs, outs, wall = pool_burst(pool, reqs)
        st = pool.stats()
        after = {k: v["engine"]["graphs_captured"] for k, v in st["replicas"].items()}
        dev = pool.device_bytes()
        footprint = max(footprint, replica_bytes(pool))
        alloc, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        kv_clean([r.engine for r in pool._replicas], f"(a) N={n}")
        pool.stop()
        check(st["completed"] == len(reqs) and st["failovers"] == 0
              and st["replica_downs"] == 0, f"(a) N={n}: {st}")
        check(after == warm and len(set(warm.values())) == 1,
              f"(a) N={n}: graphs {warm} after warm-up, {after} after the burst")
        tokens = sum(len(o) for o in outs)
        ttft = [h.ttft_s for h in hs]
        tpot = [h.tpot_s for h in hs if h.tpot_s is not None]
        log(f"[pool] (a) {n} replica(s) of one model sharing the card: {len(reqs)} requests, "
            f"{tokens} tokens in {wall:.3f} s = {tokens / wall:,.1f} generated tokens/s; TTFT "
            f"p50 {pct(ttft, 50):.1f} ms p99 {pct(ttft, 99):.1f} ms; TPOT p50 "
            f"{pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} ms; card {smi}")
        log(f"[pool]   warm-up {warm_s:.2f} s, graphs captured per replica {warm}, "
            f"{sum(after.values()) - sum(warm.values())} after it; per replica "
            + "; ".join(f"{k}: KV pool {b['kv'] / 2**20:.1f} MiB, graph pools "
                        f"{(b['graph_pools'] or 0) / 2**20:.1f} MiB" for k, b in dev.items())
            + f"; memory_allocated {alloc / 2**30:.3f} GiB, max_memory_allocated "
              f"{peak / 2**30:.3f} GiB, memory_reserved {reserved / 2**30:.3f} GiB")
        pool_tokens(f"(a) N={n}", want, f32, reqs, outs, smi)
        del pool
    return footprint


def pool_failover(lm, reqs, want, f32, tmp, smi, mem):
    """(b): three replicas, the POOL_KILL_AT-th admission kills its replica."""
    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.serving import ReplicaPool
    from flexflow_tpu_torch.testing.chaos import ChaosMonkey

    path = os.path.join(tmp, "failover.jsonl")
    tel = EventLog(path)
    lm._chaos = ChaosMonkey(f"serve:{POOL_KILL_AT}=replica_kill")
    try:
        pool = ReplicaPool(lm, config=pool_config(replicas=3), telemetry=tel, warmup=True)
        pool.start()
        engines = [r.engine for r in pool._replicas]
        hs, outs, wall = pool_burst(pool, reqs)
        settle(lambda: pool.stats()["replica_restarts"] >= 1, "(b) the restart")
        st = pool.stats()
        reborn = [r for r in pool._replicas if r.restarts]
        engines += [r.engine for r in pool._replicas]
        mem.append(("(b) after the restart", torch.cuda.memory_allocated()))
        pool.stop()
    finally:
        lm._chaos = None
    tel.close()
    check(st["completed"] == len(reqs) and st["replica_downs"] == 1
          and st["replica_restarts"] >= 1 and st["failovers"] >= 1, f"(b) {st}")
    downs = pool_events(path, "replica_down", "replica_restart_failed", "serve_loop_crashed")
    check(all("ChaosReplicaKill" in (r["attrs"].get("reason") or r["attrs"].get("error", ""))
              for r in downs), f"(b) a replica failed in a way not injected: {downs}")
    dead = [e for e in engines if e.crashed is not None]
    check(len(dead) == 1 and not dead[0].alive() and dead[0]._caches is None
          and not dead[0]._step_graphs, f"(b) the killed incarnation: {[e.uid for e in dead]}")
    new = reborn[0].engine
    w0, w1 = new.warmup_window
    t0 = tel._t0
    survivors = {r.name for r in pool._replicas} - {reborn[0].name}
    during = [r for r in pool_events(path, "serve_batch_occupancy")
              if r["attrs"]["replica"] in survivors and w0 <= t0 + r["ts"] <= w1]
    captured = new.graphs_captured()
    check(captured > 0 and during, f"(b) the restart captured {captured} graphs in "
                                   f"[{w0:.3f}, {w1:.3f}], survivors stepped {len(during)} "
                                   "times meanwhile")
    kv_clean({id(e): e for e in engines}.values(), "(b)")
    log(f"[pool] (b) failover: serve:{POOL_KILL_AT}=replica_kill in a burst of {len(reqs)} on "
        f"3 replicas ({wall:.2f} s): completed {st['completed']}, each client resolved once, "
        f"replica_downs {st['replica_downs']}, failovers {st['failovers']}, restarts "
        f"{st['replica_restarts']}; {new.uid} captured {captured} graphs in {w1 - w0:.3f} s "
        f"while the survivors took {len(during)} decode steps; the killed {dead[0].uid} "
        f"dropped its graphs and caches; KV slot refs and promised blocks 0 on all "
        f"{len({id(e) for e in engines})} incarnations; card {smi}")
    pool_tokens("(b) failover", want, f32, reqs, outs, smi)
    del pool, engines, dead, new, reborn


def pool_hang(lm, reqs, want, f32, tmp, smi, mem):
    """(c): the POOL_HANG[0]-th admission wedges its replica's loop for
    POOL_HANG[1] s, past a 1 s replica timeout."""
    from flexflow_tpu_torch.observability.events import EventLog
    from flexflow_tpu_torch.serving import ReplicaPool
    from flexflow_tpu_torch.testing.chaos import ChaosMonkey

    k, secs = POOL_HANG
    path = os.path.join(tmp, "hang.jsonl")
    tel = EventLog(path)
    lm._chaos = ChaosMonkey(f"serve:{k}=replica_hang:{secs:g}")
    try:
        pool = ReplicaPool(lm, config=pool_config(replicas=3, replica_timeout_s=1.0),
                           telemetry=tel, warmup=True)
        pool.start()
        engines = [r.engine for r in pool._replicas]
        hs, outs, wall = pool_burst(pool, reqs)
        settle(lambda: pool.stats()["replica_restarts"] >= 1, "(c) the restart")
        hung = next(e for e in engines if e._abandoned)
        settle(lambda: not hung.alive(), "(c) the wedged loop's exit")
        st = pool.stats()
        engines += [r.engine for r in pool._replicas]
        moved = sum(r.failovers for r in pool._replicas)
        mem.append(("(c) after the restart", torch.cuda.memory_allocated()))
        pool.stop()
    finally:
        lm._chaos = None
    tel.close()
    downs = pool_events(path, "replica_down", "replica_restart_failed", "serve_loop_crashed")
    check(st["completed"] == len(reqs) and st["replica_downs"] == 1 and len(downs) == 1
          and "no decode progress" in downs[0]["attrs"]["reason"], f"(c) {st}; {downs}")
    # after the mark-down no client took its tokens from the wedged
    # incarnation: its stale attempts lost the CAS when it woke
    t_down = tel._t0 + downs[0]["ts"]
    late = [h.request_id for h in hs if h.admitted_by == hung.uid and h.t_done > t_down]
    check(hung.crashed is None and hung._caches is None and not hung.active_requests()
          and not late, f"(c) the wedged incarnation after it woke: {hung.stats()}; "
                        f"clients it resolved after its mark-down {late}")
    kv_clean({id(e): e for e in engines}.values(), "(c)")
    log(f"[pool] (c) serve:{k}=replica_hang:{secs:g} with replica_timeout_s 1: "
        f"{downs[0]['attrs']['reason']}; {moved} attempt(s) failed over, {len(reqs)} of "
        f"{len(reqs)} requests completed once in {wall:.2f} s; the wedged {hung.uid} woke, "
        f"its stale attempts lost the CAS (no client resolved by it after the mark-down), "
        f"and it dropped its graphs and caches; restarts {st['replica_restarts']}; card "
        f"{smi}")
    pool_tokens("(c) hang", want, f32, reqs, outs, smi)
    del pool, engines, hung


def pool_hedge(lm, want, f32, smi):
    """(d): hedge_ms low enough to fire on every request."""
    from flexflow_tpu_torch.serving import ReplicaPool

    H = POOL_HEDGE
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, LM["vocab_size"], size=H["prompt"], dtype=np.int32), H["new"])
            for _ in range(H["requests"])]
    pool = ReplicaPool(lm, config=pool_config(replicas=3, hedge_ms=H["hedge_ms"]), warmup=True)
    with pool:
        hs, outs, wall = pool_burst(pool, reqs)
        st = pool.stats()
        settle(lambda: not pool._attempts and all(
            v["engine"]["active"] == 0 and v["engine"]["kv"]["blocks_promised"] == 0
            for v in pool.stats()["replicas"].values()), "(d) the losers' slots freed")
        kv_clean([r.engine for r in pool._replicas], "(d)")
    check(st["hedged"] > 0 and st["completed"] == len(reqs) and st["failed"] == 0,
          f"(d) {st}")
    log(f"[pool] (d) hedging at {H['hedge_ms']:g} ms on 3 replicas: {st['hedged']} of "
        f"{len(reqs)} requests hedged, {st['completed']} completed once in {wall:.3f} s (the "
        f"first finisher's tokens), every losing attempt's slot and KV blocks freed at its "
        f"next token boundary; card {smi}")
    pool_tokens("(d) hedging", want, f32, reqs, outs, smi)


def pool_shed(lm, reqs, want, f32, smi):
    """(e): ServingAPI before a one-replica pool with a small max_queue."""
    import urllib.error
    import urllib.request

    from flexflow_tpu_torch.serving import ReplicaPool
    from flexflow_tpu_torch.serving.api import ServingAPI

    S = POOL_SHED
    picks = reqs[:S["posts"]]

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                return r.status, r.read().decode(), r.headers
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode(), e.headers

    def post(url, p, n):
        body = json.dumps({"prompt": [int(t) for t in p], "max_new_tokens": n}).encode()
        req = urllib.request.Request(f"{url}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read()), r.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    pool = ReplicaPool(lm, config=pool_config(replicas=1, max_queue=S["max_queue"]),
                       warmup=True)
    with pool, ServingAPI(pool, port=0) as api:
        code, body, _ = get(f"{api.url}/healthz")
        hz = json.loads(body)
        check(code == 200 and hz["status"] == "ok" and [r["state"] for r in hz["replicas"]]
              == ["ready"] and hz["replicas"][0]["incarnation"], f"(e) /healthz {code} {hz}")
        with ThreadPoolExecutor(len(picks)) as ex:
            got = list(ex.map(lambda r: post(api.url, *r), picks))
        code, metrics_text, _ = get(f"{api.url}/metrics")
        check(code == 200 and "ff_replica_up" in metrics_text, f"(e) /metrics {code}")
        st = pool.stats()
        pool.stop(drain=True)
        late, _, late_h = post(api.url, *picks[0])
        hz_code, hz_body, _ = get(f"{api.url}/healthz")
        rz_code, _, _ = get(f"{api.url}/readyz")
    shed = [(c, b, h) for c, b, h in got if c == 503]
    ok = [(i, b) for i, (c, b, _) in enumerate(got) if c == 200]
    check(shed and all(h.get("Retry-After") and int(h["Retry-After"]) >= 1
                       and b["error"].startswith("overloaded") for _, b, h in shed)
          and len(ok) + len(shed) == len(picks) and st["shed"] == len(shed),
          f"(e) {len(ok)} 200, {len(shed)} 503 of {len(picks)}; pool {st}")
    check(late == 503 and late_h.get("Retry-After") and hz_code == 503 and rz_code == 503,
          f"(e) the drained pool: POST {late}, /healthz {hz_code} {hz_body}, /readyz {rz_code}")
    ups = [ln for ln in metrics_text.splitlines() if ln.startswith("ff_replica_up")]
    log(f"[pool] (e) ServingAPI on a one-replica pool, max_queue {S['max_queue']}: "
        f"{len(picks)} concurrent POST /generate -> {len(ok)} 200, {len(shed)} 503 with "
        f"Retry-After {sorted({int(h['Retry-After']) for _, _, h in shed})} s; /healthz 200 "
        f"with per-replica detail {hz['replicas'][0]}; /metrics {ups}; drained: POST 503, "
        f"/healthz 503 ({json.loads(hz_body)['status']}), /readyz 503; card {smi}")
    pool_tokens("(e) shedding", want, f32, [picks[i] for i, _ in ok],
                [np.asarray(b["tokens"], np.int32) for _, b in ok], smi)


def pool_fleet(lm, reqs, want, f32, smi):
    """(f): fleet's zone_outage scenario at full width over phase 10's
    requests, zones zone-a,zone-b."""
    from flexflow_tpu_torch.testing import fleet

    def matches(prompts, news, outs):
        first, every, _ = token_gaps(want, f32, list(zip(prompts, news)), outs)
        return [max(a, b) <= BF16_GAP_TOL for a, b in zip(first, every)]

    res = fleet.run_scenario("zone_outage", seed=0, slo_ms=POOL_FLEET_SLO_MS, model=lm,
                             serve=POOL_ENGINE, matches=matches, traffic=reqs,
                             pool_warmup=True)
    sc = fleet.SCENARIOS["zone_outage"]
    check(res["incident"] is not None and res["time_to_recover_s"] is not None
          and res["pool"]["ready_replicas"] >= sc.scale["min_replicas"]
          and res["pool"]["replicas_added"] >= 1 and res["n_lost"] == 0
          and res["n_incorrect"] == 0 and res["n_failed"] == 0
          and res["n_done"] == len(reqs), f"(f) {res}")
    tokens = sum(n for _, n in reqs)
    log(f"[pool] (f) fleet zone_outage, phase 10's {len(reqs)} requests ({tokens} new tokens) "
        f"arriving over {sc.duration_s:g} s, zones {','.join(sc.zones)}, "
        f"{sc.replicas} replicas (autoscaler min {sc.scale['min_replicas']} max "
        f"{sc.scale['max_replicas']}): zone down at {res['incident']['t_down']} s, ready "
        f"{res['incident']['ready_before']} -> {res['incident']['ready_min']} -> "
        f"{res['pool']['ready_replicas']}, time to recover {res['time_to_recover_s']} s "
        f"({res['pool']['replicas_added']} added, scale-ups {res['scale_events']['ups']}); "
        f"all done in {res['duration_s']} s = {tokens / res['duration_s']:,.1f} generated "
        f"tokens/s; offered {res['offered_rps']} requests/s, attained {res['attained_rps']} "
        f"({res['n_good']} of {res['requests']} within the {res['slo_ms']:g} ms end-to-end "
        f"SLO; all {res['n_done']} within the gap rule); failovers "
        f"{res['pool']['failovers']}; card {smi}")


def pool_phase(ft, kernels, smi, known=None):
    """Phase 12: the replica pool and the autoscaler on the card.  Returns
    the kernels' wrapper launches (none: the pool decodes only)."""
    from flexflow_tpu_torch.models.transformer import build_transformer

    t_phase = t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[pool] {what} took {now - t_lap:.1f} s")
        t_lap = now

    KERNELS.update(kernels)
    free_models()
    lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    f32 = decode_lm(ft, build_transformer, "float32")
    reqs = traffic()
    want = Want(lm, known)
    for p, n in reqs:   # before the baseline: generate's graphs come and go
        want(p, n)
    lap("generate for every request")
    reset_launches(kernels)
    mem = [("before the pools", settled_allocated())]
    footprint = pool_throughput(lm, reqs, want, f32, smi)
    lap("(a)")
    with tempfile.TemporaryDirectory() as tmp:
        pool_failover(lm, reqs, want, f32, tmp, smi, mem)
        lap("(b)")
        pool_hang(lm, reqs[:POOL_HANG_REQUESTS], want, f32, tmp, smi, mem)
        lap("(c)")
    pool_hedge(lm, want, f32, smi)
    lap("(d)")
    pool_shed(lm, reqs, want, f32, smi)
    lap("(e)")
    pool_fleet(lm, reqs, want, f32, smi)
    lap("(f)")
    lm._gen_cache.clear()
    mem.append(("after close", settled_allocated()))
    grew = mem[-1][1] - mem[0][1]
    check(grew <= footprint, f"(g) memory_allocated grew {grew / 2**20:.1f} MiB over the "
                             f"pools, more than one replica's {footprint / 2**20:.1f} MiB")
    launches = read_launches(kernels)
    pool_own = {k: launches[k] - ORACLE_LAUNCHES[k] for k in launches}
    check(pool_own == NO_LAUNCH, f"the pool paths launched {pool_own}")
    log(f"[pool] (g) memory_allocated: " + "; ".join(f"{w} {b / 2**30:.4f} GiB"
                                                     for w, b in mem)
        + f"; after close {grew / 2**20:+.1f} MiB against one replica's footprint "
          f"{footprint / 2**20:.1f} MiB (KV pool and graph pools); each reading after "
          f"gc.collect() and empty_cache()")
    del lm, f32
    free_models()
    log(f"[pool] phase 12 took {time.perf_counter() - t_phase:.1f} s; wrapper launches on "
        f"the pool paths {pool_own}, in the f32 oracle's forwards {ORACLE_LAUNCHES}")
    return dict(ORACLE_LAUNCHES)


# ------------------------------------------------------------------ phase 13

# (a): the transformer's attention, (B, H, S, D) = (16, 8, 512, 64)
SEQ_SHAPE = (LM["batch"], LM["num_heads"], LM["seq_length"], LM["embed_dim"] // LM["num_heads"])
# (mode, shards) of (a), each in bf16 and f32, causal and not
SEQ_SPLITS = (("ring", 2), ("ring", 4), ("ulysses", 4))
# f32 ring or Ulysses against mha_reference autograd (f32, TF32 off): the
# kernels' f32 sums and the merges' exp/log round differently from one
# softmax over the whole row, about 1e-6 relative; phase 3's f32 tolerance
SEQ_REF_TOL = FLASH_TOL[torch.float32]


def seq_tol(mode, n, dtype):
    """(a)'s tolerance against the unsplit K3-K5 path.  f32 and Ulysses
    (whole rows, each head's attention the unsplit call's): phase 3's.  A
    bf16 ring rounds each block's O, dq, dk and dv to bf16 (the kernels'
    output dtype) before it merges or sums them, where the unsplit path
    rounds once: n block results and n - 1 bf16 sums, up to n bf16 steps
    (2**-7 each at |x| near 1, where these values lie with unit-variance
    inputs), so rtol and atol n * 2**-7."""
    if dtype == torch.float32 or mode == "ulysses":
        return FLASH_TOL[dtype]
    return dict(rtol=n * 2 ** -7, atol=n * 2 ** -7)
# (c): dropout rate of the full-width transformer
SEQ_DROPOUT = 0.1
# (d): ResNet-50's stem (conv 7x7 stride 2 to 64 channels at batch 64,
# 229x229x3), then BatchNorm with ReLU
STEM = dict(batch=64, side=229, channels=64)
PCA_STEPS = 20


def lockstep_ring(seq, q, k, v, n, causal, scale):
    """Ring attention of ``n`` shards in one process, in lockstep: at each
    step every shard runs the package's per-step function on the K/V block
    it holds and merges with the package's ``_merge_partials``; then each
    receives the previous shard's block.  That exchange, a list rotation
    here (NCCL peer to peer across cards), is the only part that is not
    the package's."""
    qs = [t.contiguous() for t in q.chunk(n, dim=2)]
    held = [(kb.contiguous(), vb.contiguous()) for kb, vb in zip(k.chunk(n, dim=2),
                                                                 v.chunk(n, dim=2))]
    acc = [None] * n
    for step in range(n):
        for idx in range(n):
            o_s, lse_s = seq.ring_block_attention(qs[idx], *held[idx], idx, step, n,
                                                  causal=causal, scale=scale)
            acc[idx] = ((o_s.float(), lse_s) if acc[idx] is None
                        else seq._merge_partials(*acc[idx], o_s, lse_s))
        held = held[-1:] + held[:-1]
    return torch.cat([o.to(q.dtype) for o, _ in acc], dim=2)


def lockstep_ulysses(fa, q, k, v, n, causal, scale):
    """Ulysses over ``n`` shards in one process: after the all-to-all (a
    slice here) shard j holds head block j of the whole sequence and runs
    the package's flash attention on it; the inverse all-to-all is the
    concatenation of the heads."""
    hn = q.shape[1] // n
    return torch.cat([fa.flash_attention(*(t[:, j * hn:(j + 1) * hn].contiguous()
                                           for t in (q, k, v)), causal=causal, scale=scale)
                      for j in range(n)], dim=1)


def seq_runs(seq, fa):
    """Each (mode, shards) of (a) as a function of (q, k, v)."""
    scale = 1.0 / math.sqrt(SEQ_SHAPE[-1])
    runs = {}
    for mode, n in SEQ_SPLITS:
        for causal in (True, False):
            if mode == "ring":
                fn = (lambda q, k, v, n=n, c=causal: lockstep_ring(seq, q, k, v, n, c, scale))
            else:
                fn = (lambda q, k, v, n=n, c=causal: lockstep_ulysses(fa, q, k, v, n, c, scale))
            runs[(mode, n, causal)] = fn
    return runs


def expected_seq_launches(mode, n, causal):
    """K3 launches (and K4, K5 each) of one forward (backward): the ring's
    blocks that are not masked, one per Ulysses shard."""
    if mode == "ulysses":
        return n
    return n * (n + 1) // 2 if causal else n * n


def fwd_bwd(fn, q, k, v, do):
    """O and (dq, dk, dv) of ``fn`` through autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves)
    return o.detach(), torch.autograd.grad(o, leaves, do)


def seq_checks(seq, fa, kernels, smi):
    """(a): each split against the unsplit K3-K5 path (phase 3's tolerance
    for its dtype) and, in f32, against mha_reference autograd; K3-K5
    launches per direction.  Returns the launches and the worst errors."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    scale = 1.0 / math.sqrt(SEQ_SHAPE[-1])
    launches = dict.fromkeys(kernels, 0)
    worst = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    runs = seq_runs(seq, fa)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = attn_inputs(SEQ_SHAPE, dtype, gen)
        for causal in (True, False):
            unsplit = fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c, causal=causal,
                                                                 scale=scale), q, k, v, do)
            ref = None
            if dtype == torch.float32:
                ref = fwd_bwd(lambda a, b, c: fa.mha_reference(a, b, c, causal=causal,
                                                               scale=scale), q, k, v, do)
            for (mode, n, c), fn in runs.items():
                if c != causal:
                    continue
                label = f"{mode} n={n} {str(dtype)[6:]} causal={int(causal)}"
                reset_launches(kernels)
                leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
                o = fn(*leaves)
                fwd = read_launches(kernels)
                grads = torch.autograd.grad(o, leaves, do)
                torch.cuda.synchronize()
                got = read_launches(kernels)
                bwd = {name: got[name] - fwd[name] for name in got}
                want = expected_seq_launches(mode, n, causal)
                check(fwd["flash_fwd"] == want and bwd["flash_bwd_dkdv"] == want
                      and bwd["flash_bwd_dq"] == want and bwd["flash_fwd"] == 0,
                      f"{label}: launches forward {fwd}, backward {bwd}, expected {want} each")
                launches = {name: launches[name] + got[name] for name in got}
                tol = seq_tol(mode, n, dtype)
                errs = [worst_err(o, unsplit[0], tol, f"O {label} vs unsplit")]
                errs += [worst_err(g, w, tol, f"d{x} {label} vs unsplit")
                         for x, g, w in zip("qkv", grads, unsplit[1])]
                line = (f"[seq] (a) {label}: K3 {fwd['flash_fwd']}, K4 {bwd['flash_bwd_dkdv']}, "
                        f"K5 {bwd['flash_bwd_dq']} launches; vs the unsplit K3-K5 path max|d| "
                        f"O {errs[0]:.3e} dq {errs[1]:.3e} dk {errs[2]:.3e} dv {errs[3]:.3e}")
                if ref is not None:
                    rerrs = [worst_err(o, ref[0], SEQ_REF_TOL, f"O {label} vs mha_reference")]
                    rerrs += [worst_err(g, w, SEQ_REF_TOL, f"d{x} {label} vs mha_reference")
                              for x, g, w in zip("qkv", grads, ref[1])]
                    line += (f"; vs mha_reference autograd max|d| O {rerrs[0]:.3e} dq "
                             f"{rerrs[1]:.3e} dk {rerrs[2]:.3e} dv {rerrs[3]:.3e}")
                    errs = [max(a, b) for a, b in zip(errs, rerrs)]
                log(line)
                worst["flash_fwd"] = max(worst["flash_fwd"], errs[0])
                worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"], *errs[2:])
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[1])
                del o, grads, leaves
            del unsplit, ref
        del q, k, v, do
        torch.cuda.empty_cache()
    log(f"[seq] (a) tolerances: against the unsplit path phase 3's (bf16 rtol 2**-7 atol 1e-3, "
        f"f32 rtol atol 1e-4), a bf16 ring of n shards rtol atol n * 2**-7 (n bf16 roundings "
        f"more); f32 against mha_reference autograd rtol atol 1e-4 (TF32 off); "
        f"the shards run in lockstep in one process on the package's ring_block_attention, "
        f"_merge_partials and flash_attention, and only the exchange of K/V between shards "
        f"is this script's; card {smi}")
    return launches, worst


def seq_times(seq, fa, smi):
    """(a)'s timing, bf16 causal: each split's forward plus backward beside
    the unsplit K3-K5 call and SDPA's (a library yardstick).  Not gated."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = attn_inputs(SEQ_SHAPE, torch.bfloat16, gen)
    scale = 1.0 / math.sqrt(SEQ_SHAPE[-1])
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def timed(fn):
        return cuda_time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, do), 10)

    times = {"unsplit K3-K5": timed(lambda a, b, c: fa.flash_attention(
                 a, b, c, causal=True, scale=scale)),
             "SDPA": timed(lambda a, b, c: F.scaled_dot_product_attention(
                 a, b, c, is_causal=True, scale=scale))}
    runs = seq_runs(seq, fa)
    for (mode, n, causal), fn in runs.items():
        if causal:
            times[f"{mode} n={n}"] = timed(fn)
    log(f"[seq] (a) forward + backward ms, bf16 causal {SEQ_SHAPE}, the shards in lockstep "
        f"on one card (not gated): " + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
        + f"; card {smi}")
    # where the 4-shard ring's time goes: device time by kernel family
    ring = runs[("ring", 4, True)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            torch.autograd.grad(ring(*leaves), leaves, do)
        torch.cuda.synchronize()
    groups, count = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            groups[kernel_group(e.key)] = groups.get(kernel_group(e.key), 0.0) + \
                e.self_device_time_total / 3e3
            count += e.count
    log(f"[seq] (a) ring n=4 forward + backward, profiled: {sum(groups.values()):.4f} device "
        f"ms in {count // 3} kernels a call: " + ", ".join(
            f"{g} {ms:.4f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    return times


def seq_lm(ft, build_transformer, synthetic_lm_batch, dtype="bfloat16", lr=0.001, **cfg):
    """The full-width transformer (bf16 unless said) with SGD at ``lr``."""
    return lm_model(ft, build_transformer, synthetic_lm_batch,
                    lambda m: ft.SGDOptimizer(m, lr=lr), compute_dtype=dtype, **{**LM, **cfg})


def dropout_checks(ft, build_transformer, synthetic_lm_batch, kernels, smi):
    """(c): attention dropout in the full-width transformer's compiled step.
    Returns the launches of its bf16 runs."""
    def make(**cfg):
        return seq_lm(ft, build_transformer, synthetic_lm_batch, dropout=SEQ_DROPOUT, **cfg)

    # lr 0: the weights stay, so the loss of a replay of the one staged
    # batch moves only with the mask it draws
    def losses(graph):
        model = make(dtype="float32", lr=0.0)
        with contextlib.nullcontext() if graph else ft.disable_graphs():
            _, out = steps_ms(model, steps=4, timed_from=1)
        if graph:
            check_graph_run(model, 4, "dropout lr 0")
        return out

    compiled, eager = losses(True), losses(False)
    check(len(set(compiled)) == 4, f"dropout: 4 steps on one batch gave losses {compiled}")
    check(compiled == eager, f"dropout: compiled losses {compiled} != eager {eager}")
    log(f"[seq] (c) dropout {SEQ_DROPOUT}, f32, lr 0, one batch: losses of the eager step, the "
        f"capture and 2 replays {['%.7f' % x for x in compiled]} (a new mask each), equal to "
        "the eager path's bit for bit (the generator registered with the capture)")

    def state(graph, remat=False, steps=3):
        model = make(dtype="float32", remat=remat)
        with contextlib.nullcontext() if graph else ft.disable_graphs():
            for _ in range(steps):
                model.train_iteration()
        model.sync()
        if graph:
            check_graph_run(model, steps, "dropout f32")
        return state_of(model)

    graph_state = state(True)
    worst, bitwise = compare_states(graph_state, state(False), GRAPH_TOL, "dropout graph/eager")
    check(bitwise, f"dropout: compiled and eager f32 states differ (max |d| {worst:.3e})")
    rworst, rbitwise = compare_states(graph_state, state(True, remat=True), REMAT_TOL,
                                      "dropout remat/plain")
    log(f"[seq] (c) dropout f32, 3 steps: compiled vs eager bitwise equal over "
        f"{len(graph_state)} leaves; remat vs plain max |d| {rworst:.3e} "
        f"({'bitwise equal' if rbitwise else 'not bitwise'}; limit rtol 1e-6, atol 1e-7)")
    del graph_state
    free_models()
    launches = dict.fromkeys(kernels, 0)
    times = {"dropout 0": [], f"dropout {SEQ_DROPOUT}": []}
    for rate in (0.0, SEQ_DROPOUT, SEQ_DROPOUT, 0.0):
        model = seq_lm(ft, build_transformer, synthetic_lm_batch, dropout=rate)
        reset_launches(kernels)
        ms, _ = steps_ms(model)
        check_graph_run(model, 7, f"dropout {rate}")
        if rate:
            launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
        times[f"dropout {rate:g}"].append(ms)
        del model
        free_models()
    model = make()
    reset_launches(kernels)
    profile_steps(model, f"transformer dropout {SEQ_DROPOUT}", times[f"dropout {SEQ_DROPOUT}"][0],
                  per_step=LM_SGD_STEP)
    launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
    del model
    free_models()
    tokens = LM["batch"] * LM["seq_length"]
    log(f"[seq] (c) transformer bf16 compiled step, ms/step in turns: " + "; ".join(
        f"{label} {' / '.join(f'{m:.3f}' for m in ms)} ms "
        f"({' / '.join(f'{tokens * 1e3 / m:.0f}' for m in ms)} tokens/s)"
        for label, ms in times.items()) + f"; launches per step with dropout {LM_SGD_STEP} "
        f"(the profiler's); card {smi}")
    return launches


def stem_model(ft, dtype="float32", **cfg):
    """ResNet-50's stem and BatchNorm, then a pool and a classifier, with
    its synthetic batch staged."""
    b = STEM["batch"]
    model = ft.FFModel(ft.FFConfig(batch_size=b, compute_dtype=dtype, fused_optimizer=True,
                                   **cfg))
    inp = model.create_tensor((b, 3, STEM["side"], STEM["side"]))
    t = model.conv2d(inp, STEM["channels"], 7, 7, 2, 2, 3, 3, use_bias=False, name="conv1")
    t = model.batch_norm(t, relu=True, name="bn1")
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    t = model.dense(model.flat(t, name="flat"), 10, name="fc")
    model.softmax(t, name="sm")
    model.compile(ft.SGDOptimizer(model, lr=0.01, momentum=0.9),
                  ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [ft.MetricsType.ACCURACY])
    model.init_layers(seed=0)
    stage_synthetic(ft, model, inp, b)
    return model


def stats_of(model):
    return {(o, n): t.clone() for o, st in model._stats.items() for n, t in st.items()}


def pca_graph(model, b, npcs=5, widths=(10, 10, 10, 10, 10, 1)):
    """examples/pca.py's graph (the reference's tests/PCA/pca.cc): inputs
    normalized by element-binary ops, five towers of dense layers whose
    tanh is built from graph ops on ``create_constant`` tensors, concat."""
    vec, vmax, vmin = (model.create_tensor((b, npcs), name=n, nchw=False)
                       for n in ("pcvec", "pcmax", "pcmin"))
    sb = {i: model.create_tensor((b, widths[i]), name=f"sb{i}", nchw=False)
          for i in range(1, 6)}
    x = model.divide(model.subtract(vec, vmin), model.subtract(vmax, vmin))
    outs = []
    for pc in range(1, npcs + 1):
        s = x
        for i in range(1, 6):
            s = model.add(model.dense(s, widths[i], name=f"pc{pc}_dense{i}"), sb[i])
            one, two, m2 = (model.create_constant((b, widths[i]), c) for c in (1.0, 2.0, -2.0))
            s = model.add(one, model.exp(model.multiply(m2, s)))
            s = model.subtract(model.divide(two, s), one)
        outs.append(s)
    model.concat(outs, axis=1, name="outlayer")
    return {"pcvec": vec, "pcmax": vmax, "pcmin": vmin, **{f"sb{i}": sb[i] for i in sb}}


def batch_norm_checks(ft, kernels, smi):
    """(d): BatchNorm at ResNet-50's stem through the compiled step, the
    guard and a checkpoint; the MSELoss op; the PCA graph of constants.
    Returns the launches of its training runs."""
    import numpy as np

    from flexflow_tpu_torch.ops.base import FwdCtx

    launches = dict.fromkeys(kernels, 0)

    def run(graph, steps=3):
        model = stem_model(ft)
        reset_launches(kernels)
        with contextlib.nullcontext() if graph else ft.disable_graphs():
            for _ in range(steps):
                model.train_iteration()
        model.sync()
        if graph:
            check_graph_run(model, steps, "BatchNorm stem")
        return model, read_launches(kernels)

    (g, gl), (e, el) = run(True), run(False)
    for got in (gl, el):
        launches = {n: launches[n] + c for n, c in got.items()}
    check(gl["fused_sgd_update"] == 2 and el["fused_sgd_update"] == 3,
          f"BatchNorm stem: SGD launches compiled {gl}, eager {el}")
    _, sbit = compare_states(stats_of(g), stats_of(e), dict(rtol=0, atol=0), "stats")
    worst, wbit = compare_states(state_of(g), state_of(e), GRAPH_TOL, "stem graph/eager")
    moved = (g._stats["bn1"]["var"] - 1).abs().max().item()
    check(moved > 0, "BatchNorm stem: the running variance did not move")
    log(f"[seq] (d) BatchNorm stem f32 (batch {STEM['batch']}, {STEM['side']}x{STEM['side']}x3, "
        f"conv 7x7/2 to {STEM['channels']}), 3 steps compiled vs eager: running mean and var "
        f"bitwise equal (max |var - 1| {moved:.3e}); weights max |d| {worst:.3e} "
        f"({'bitwise equal' if wbit else 'not bitwise'})")
    del g, e
    free_models()
    os.environ["FF_SKIP_NONFINITE"] = "3"
    try:
        model = stem_model(ft)
    finally:
        os.environ.pop("FF_SKIP_NONFINITE")
    inp = model.input_tensors[0]
    x = np.random.default_rng(2).standard_normal((STEM["batch"],) + inp.dims[1:],
                                                 dtype=np.float32)
    y = model._batch["label"].cpu().numpy()
    reset_launches(kernels)
    for _ in range(2):
        model.train_iteration()
    stats, weights = stats_of(model), state_of(model)
    bad = x.copy()
    bad[1, 5, 9, 2] = np.nan
    model.set_batch({inp: bad}, y)
    model.train_iteration()
    model.sync()
    launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
    check_graph_run(model, 3, "BatchNorm guard")
    compare_states(stats, stats_of(model), dict(rtol=0, atol=0), "guard stats")
    compare_states(weights, state_of(model), dict(rtol=0, atol=0), "guard weights")
    skipped = dict(zip(model._metric_keys(), model._metric_acc.tolist()))["skipped_steps"]
    check(skipped == 1, f"BatchNorm guard: skipped_steps {skipped}")
    log(f"[seq] (d) a NaN batch replayed under FF_SKIP_NONFINITE left the running stats and "
        f"{len(weights)} weight and slot leaves bitwise unchanged (skipped_steps 1)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stem")
        model.save(path)
        fresh = stem_model(ft)
        fresh.load(path)
    compare_states(stats_of(model), stats_of(fresh), dict(rtol=0, atol=0), "loaded stats")
    del model, fresh
    free_models()
    log("[seq] (d) save then load into a fresh model: running stats bitwise equal")
    mse = ft.FFModel(ft.FFConfig(batch_size=STEM["batch"], compute_dtype="float32"))
    a, b_ = (mse.create_tensor((STEM["batch"], 1000), nchw=False) for _ in range(2))
    mse.mse_loss(a, b_)
    gen = torch.Generator(device="cuda").manual_seed(15)
    xa, xb = (torch.randn(STEM["batch"], 1000, device="cuda", generator=gen) for _ in range(2))
    got = mse.ops[0].forward({}, [xa, xb], FwdCtx())[0]
    want = ((xa.double() - xb.double()) ** 2).sum() / STEM["batch"]
    check(got.shape == (1,) and abs(got.item() - want.item()) <= 1e-5 * want.item(),
          f"MSELoss op {got.tolist()} vs {want.item()}")
    b = 64
    pca = ft.FFModel(ft.FFConfig(batch_size=b, compute_dtype="float32"))
    ins = pca_graph(pca, b)
    pca.compile(ft.SGDOptimizer(pca, lr=0.05), "mean_squared_error", ["mean_squared_error"])
    pca.init_layers(seed=0)
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((b, 5), dtype=np.float32)
    feed = {ins["pcvec"]: xv, ins["pcmax"]: np.full((b, 5), 3.0, np.float32),
            ins["pcmin"]: np.full((b, 5), -3.0, np.float32)}
    feed.update({ins[f"sb{i}"]: np.zeros((b, 10 if i < 5 else 1), np.float32)
                 for i in range(1, 6)})
    pca.set_batch(feed, np.tanh(xv))
    reset_launches(kernels)
    _, losses = steps_ms(pca, steps=PCA_STEPS, timed_from=1)
    launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
    check_graph_run(pca, PCA_STEPS, "PCA")
    check(losses[-1] < losses[0], f"PCA loss does not fall: {losses}")
    log(f"[seq] (d) MSELoss op on the card: {got.item():.6f} vs float64 {want.item():.6f}; the "
        f"PCA graph ({len(pca._constants)} constants made on the card, none in set_batch) "
        f"trained {PCA_STEPS} compiled f32 steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"card {smi}")
    return launches


def seq_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev, lead):
    """(b) on this rank: the full-width transformer with every attention
    op's sequence split over the world, as a ring and as Ulysses, f32
    weights after 2 steps against the single-device path (lead rank), then
    bf16 ms/step of each beside data parallelism.  The mesh runs eagerly.
    Returns this rank's launches."""
    world = torch.distributed.get_world_size()
    split = {f"attn_{i}": ft.ParallelConfig(dims=(1, world, 1))
             for i in range(LM["num_layers"])}

    def make(mode, machine=None, **cfg):
        model = seq_lm(ft, build_transformer, synthetic_lm_batch, machine=machine,
                       strategies=dict(split) if mode != "dp" else {}, **cfg)
        for op in model.ops:
            if op._type == "MultiHeadAttention":
                op.seq_parallel_mode = mode if mode != "dp" else "ring"
        return model

    def weights(model):
        for _ in range(2):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
                for op in model.ops for w in op.weights}

    launches = dict.fromkeys(kernels, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    single = weights(make("dp", ft.Machine(devices=[dev]), dtype="float32")) if lead else None
    for mode in ("ring", "ulysses"):
        reset_launches(kernels)
        got = weights(make(mode, dtype="float32"))
        launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
        if lead:
            worst = 0.0
            for key in single:
                torch.testing.assert_close(got[key], single[key], **LM_PARITY_TOL,
                                           msg=lambda m: f"(b) {mode} {key}: {m}")
                worst = max(worst, (got[key] - single[key]).abs().max().item())
            log(f"[seq] (b) f32 transformer, attention sequence split {world} ways as {mode}, 2 "
                f"steps vs the single-device path: max |dw| {worst:.3e} (rtol 1e-4, atol 1e-5)")
        free_models()
    times = {}
    for mode in ("dp", "ring", "ulysses", "ulysses", "ring", "dp"):
        model = make(mode)
        reset_launches(kernels)
        ms, _ = steps_ms(model)
        launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
        times.setdefault(mode, []).append(ms)
        del model
        free_models()
    if lead:
        tokens = LM["batch"] * LM["seq_length"]
        log(f"[seq] (b) bf16 transformer on {world} cards (eager mesh step), ms/step in turns: "
            + "; ".join(f"{'data parallel' if m == 'dp' else m + ' sequence split'} "
                        f"{' / '.join(f'{x:.2f}' for x in ms)} ms "
                        f"({' / '.join(f'{tokens * 1e3 / x:.0f}' for x in ms)} tokens/s)"
                        for m, ms in times.items()))
    return launches


def seq_multi_phase(ft, build_transformer, synthetic_lm_batch, kernels, smi):
    """(b): with one visible card it says so and runs nothing; with more, an
    NCCL group of one rank per card (this script started again as the
    helper ranks) runs ``seq_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = torch.cuda.device_count()
    if world < 2:
        log(f"[seq] (b) needs more than one card ({world} visible): the sequence split across "
            "cards was not run")
        return dict.fromkeys(kernels, 0)
    port = free_port()
    helpers = spawn_helpers("seq", world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        launches = seq_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev,
                                  lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"(b) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[seq] (b) launches on the lead rank: {launches}; card {smi}")
    return launches


def seq_helper():
    """A helper rank of phase 13 (b)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    seq_multi_runs(ft, build_transformer, synthetic_lm_batch, kernel_wrappers(fo, fa), dev,
                   lead=False)
    dist.shutdown()
    return 0


def sequence_phase(ft, fa, kernels, smi):
    """Phase 13: (a) ring and Ulysses on one card, (b) across cards when
    there are several, (c) dropout and (d) BatchNorm, the MSELoss op and
    constants.  Returns the launches of its paths and (a)'s worst errors
    and times."""
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import sequence as seq

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, worst = seq_checks(seq, fa, kernels, smi)
    times = seq_times(seq, fa, smi)
    free_models()
    for part in (seq_multi_phase(ft, build_transformer, synthetic_lm_batch, kernels, smi),
                 dropout_checks(ft, build_transformer, synthetic_lm_batch, kernels, smi),
                 batch_norm_checks(ft, kernels, smi)):
        launches = {n: launches[n] + c for n, c in part.items()}
    free_models()
    log(f"[seq] phase 13 took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches, worst, times


# ---------------------------------------------------------------------------
# phase 14: the elastic runtime
# ---------------------------------------------------------------------------

ELASTIC_BATCHES = 3          # one epoch: 3 batches of the seeded dataset
ELASTIC_EPOCHS = 3           # (a), (b): 9 steps
RECOMPILE_LM = dict(LM, num_layers=2)   # (c), (d): reduced depth
RECOMPILE_SWAPS = 3          # (c): swaps after the first, memory held
RECONFIG_ENV = {"FF_RECONFIGURE": "1", "FF_RECONFIG_GAIN": "-10",
                "FF_RECONFIG_LAG_STEPS": "2", "FF_RECONFIG_PROBATION": "3",
                "FF_RECONFIG_BUDGET": "40", "FF_CHAOS": "resharding:7=divergence:0.15"}
WATCHDOG = (2.0, 5.0)        # (e): the deadline and the planted hang, seconds
RESHARD_TIMEOUT_S = 240      # (f): the two runs on every card (about 8 s a rank to start)
PREFETCH_STEPS = (3, 12)     # (e): steps a turn takes, and the untimed first ones
# the keys each drill sets, restored after it
ELASTIC_ENV = dict.fromkeys(("FF_CHAOS", "FF_TELEMETRY", "FF_TELEMETRY_FILE",
                             "FF_SKIP_NONFINITE", "FF_CKPT_BACKOFF_S", "FF_RECONFIGURE",
                             "FF_RECONFIG_BUDGET", "FF_RECONFIG_LAG_STEPS"), "")


def alexnet_data(n=ELASTIC_BATCHES * BATCH):
    """A seeded dataset of ``n`` NHWC images and labels (float32 in host
    memory: 161.1 MB a batch)."""
    rng = np.random.default_rng(4)
    return (rng.standard_normal((n, 229, 229, 3), dtype=np.float32),
            rng.integers(0, 10, size=(n, 1), dtype=np.int32))


def elastic_alexnet(ft, build_alexnet, data, make_opt, prefetch=True, shuffle=False, **cfg):
    """A maker of full-width AlexNet (bf16, fused) and its DataLoader over
    ``data``, through the user-facing entry points."""
    def build():
        model = ft.FFModel(ft.FFConfig(batch_size=BATCH, compute_dtype="bfloat16",
                                       fused_optimizer=True, **cfg))
        inp, _ = build_alexnet(model, BATCH)
        model.compile(make_opt(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                      [ft.MetricsType.ACCURACY])
        model.init_layers(seed=0)
        return model, ft.DataLoader(model, {inp: data[0]}, data[1], shuffle=shuffle, seed=3,
                                    prefetch=prefetch)
    return build


def elastic_lm(ft, build_transformer, synthetic_lm_batch, dropout=0.0, dtype="bfloat16",
               shape=None):
    """A maker of the transformer (full width unless ``shape``; SGD lr
    0.001, fused) and its DataLoader over 3 seeded batches."""
    shape = shape or LM

    def build():
        model = ft.FFModel(ft.FFConfig(batch_size=shape["batch"], compute_dtype=dtype,
                                       fused_optimizer=True))
        tok, pos, _ = build_transformer(
            model, shape["batch"], seq_length=shape["seq_length"],
            num_layers=shape["num_layers"], embed_dim=shape["embed_dim"],
            num_heads=shape["num_heads"], vocab_size=shape["vocab_size"], dropout=dropout)
        model.compile(ft.SGDOptimizer(model, lr=0.001),
                      ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [ft.MetricsType.ACCURACY])
        model.init_layers(seed=0)
        toks, posa, labels = synthetic_lm_batch(ELASTIC_BATCHES * shape["batch"],
                                                shape["seq_length"], shape["vocab_size"], seed=5)
        return model, ft.DataLoader(model, {tok: toks, pos: posa}, labels)
    return build


class LaunchesPerRun:
    """Wraps a model maker: the kernels' launches of each model it made, read
    from one build to the next (one model, one process of a drill)."""

    def __init__(self, build, kernels):
        self.build, self.kernels, self.marks = build, kernels, []

    def __call__(self):
        self.marks.append(read_launches(self.kernels))
        return self.build()

    def runs(self):
        marks = self.marks + [read_launches(self.kernels)]
        return [{n: b[n] - a[n] for n in a} for a, b in zip(marks, marks[1:])]


def all_params(model):
    return {k: v.detach().clone() for k, v in
            ((f"{o}/{n}", t) for o, ws in model._params.items() for n, t in ws.items())}


def elastic_recovery(ft, build_alexnet, kernels, data, tmp, smi):
    """(a): chaos_smoke's recovery drill on full-width AlexNet with Adam."""
    from flexflow_tpu_torch.testing import chaos_smoke

    build = LaunchesPerRun(elastic_alexnet(ft, build_alexnet, data, adam_optimizer(ft)), kernels)
    with environ(ELASTIC_ENV):
        out = chaos_smoke.recovery(os.path.join(tmp, "a"), build, epochs=ELASTIC_EPOCHS,
                                   max_to_keep=1)
    runs = build.runs()
    want = {**NO_LAUNCH, "fused_adam_update": 2 * 16}  # eager step and capture, 16 leaves
    check(all(r == want for r in runs), f"(a) launches per run {runs}, expected {want} each")
    check(out["preempted_at"] == 5, f"(a) preempted at step {out['preempted_at']}, not 5")
    for name in ("base", "victim", "resumed"):
        check(out[name]._step_graph.captures == 1, f"(a) {name}: "
              f"{out[name]._step_graph.captures} captures")
    log(f"[elastic] (a) recovery, AlexNet 3x229x229 batch {BATCH} bf16 Adam fused, prefetching "
        f"DataLoader, {ELASTIC_EPOCHS} epochs x {ELASTIC_BATCHES} steps, FF_SKIP_NONFINITE=5: "
        f"baseline ({chaos_smoke.NAN_SPEC}) {out['base_s']:.2f} s; victim "
        f"({chaos_smoke.VICTIM_SPEC}) preempted at step {out['preempted_at']} after "
        f"{out['victim_s']:.2f} s; resume {out['resume_s']:.2f} s; every parameter bitwise "
        f"equal to the baseline; one skipped step in each run; no *.tmp-*; the trace has "
        f"fault_injected, step_skipped, preemption_save, ckpt_retry; launches per run {runs[0]} "
        f"(each of 3 runs); checkpoint {out['ckpt_bytes']} bytes, the victim's saves "
        f"{['%.3f' % s for s in out['save_s']]} s; card {smi}")
    return {n: sum(r[n] for r in runs) for n in kernels}


def elastic_dropout(ft, build_transformer, synthetic_lm_batch, kernels, tmp, smi):
    """(b): the full-width transformer with dropout 0.1 preempted at step
    5 and resumed in a fresh model: bitwise equal to an uninterrupted run."""
    from flexflow_tpu_torch.runtime.elastic import elastic_train
    from flexflow_tpu_torch.runtime.resilience import Preempted

    build = LaunchesPerRun(elastic_lm(ft, build_transformer, synthetic_lm_batch,
                                      dropout=SEQ_DROPOUT), kernels)
    steps = ELASTIC_EPOCHS * ELASTIC_BATCHES
    walls = {}
    with environ(ELASTIC_ENV):
        base, dl = build()
        t0 = time.perf_counter()
        elastic_train(base, dl, epochs=ELASTIC_EPOCHS, checkpoint_dir=os.path.join(tmp, "b0"),
                      max_to_keep=1)
        walls["uninterrupted"] = (time.perf_counter() - t0, steps)
        dl.close()
        os.environ["FF_CHAOS"] = "step:4=sigterm"
        victim, dl = build()
        t0 = time.perf_counter()
        try:
            elastic_train(victim, dl, epochs=ELASTIC_EPOCHS,
                          checkpoint_dir=os.path.join(tmp, "b1"), max_to_keep=1)
            check(False, "(b) the victim was not preempted")
        except Preempted as e:
            check(e.step == 5, f"(b) preempted at step {e.step}, not 5")
        walls["preempted"] = (time.perf_counter() - t0, 5)
        dl.close()
        os.environ["FF_CHAOS"] = ""
        resumed, dl = build()
        t0 = time.perf_counter()
        elastic_train(resumed, dl, epochs=ELASTIC_EPOCHS,
                      checkpoint_dir=os.path.join(tmp, "b1"), max_to_keep=1)
        walls["resumed"] = (time.perf_counter() - t0, steps - 5)
        dl.close()
    check(resumed._step_count == steps, f"(b) resumed run ended at {resumed._step_count}")
    want, got = all_params(base), all_params(resumed)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    check(not differ, f"(b) the resumed dropout run differs from the uninterrupted one: {differ}")
    runs = build.runs()
    layers = LM["num_layers"]
    per_run = {**NO_LAUNCH, "fused_sgd_update": 2, "flash_fwd": 2 * layers,
               "flash_bwd_dkdv": 2 * layers, "flash_bwd_dq": 2 * layers}
    check(all(r == per_run for r in runs), f"(b) launches per run {runs}, expected {per_run}")
    log(f"[elastic] (b) dropout resume, transformer B{LM['batch']} S{LM['seq_length']} "
        f"{layers}x{LM['embed_dim']} {LM['num_heads']} heads vocab {LM['vocab_size']} bf16 SGD "
        f"lr 0.001, dropout {SEQ_DROPOUT}: preempted at step 5, resumed in a fresh model to "
        f"step {steps}: {len(want)} parameters bitwise equal to the uninterrupted run; "
        "ms/step over each run, its saves and its first (eager) and second (capture) "
        "steps included: " + "; ".join(f"{k} {w * 1e3 / n:.1f} ({n} steps)"
                                       for k, (w, n) in walls.items())
        + f"; launches per run {runs[0]}; card {smi}")
    return {n: sum(r[n] for r in runs) for n in kernels}


def recompile_checks(ft, build_transformer, synthetic_lm_batch, kernels, smi):
    """(c): recompile with the same map on the compiled step is bitwise a
    no-op, and repeated swaps hold memory_reserved within one graph pool."""
    shape = RECOMPILE_LM
    build = elastic_lm(ft, build_transformer, synthetic_lm_batch, dtype="float32", shape=shape)

    def steps(model, dl, n):
        for _ in range(n):
            dl.next_batch(model)
            model.train_iteration()
        model.sync()

    straight, sdl = build()
    steps(straight, sdl, 6)
    want = all_params(straight)
    sdl.close()
    del straight, sdl
    free_models()
    model, dl = build()
    steps(model, dl, 3)
    model.recompile(strategies=model._all_strategies())
    steps(model, dl, 3)
    got = all_params(model)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    check(not differ, f"(c) recompile then 3 steps differs from 6 steps: {differ}")
    # the eager step and a capture before the recompile and again after it
    g = model._step_graph
    check((g.captures, g.replays) == (2, 4), f"(c) {(g.captures, g.replays)} (captures, "
          "replays): the recompiled model's step was not captured anew")
    free_models()
    first = torch.cuda.memory_reserved()
    pool = model._step_graph.pool_bytes()
    levels = []
    for _ in range(RECOMPILE_SWAPS):
        model.recompile(strategies=model._all_strategies())
        steps(model, dl, 3)
        free_models()
        levels.append(torch.cuda.memory_reserved())
    dl.close()
    check(levels[-1] <= first + pool, f"(c) memory_reserved {levels} after {RECOMPILE_SWAPS} "
          f"swaps, first swap {first}, graph pool {pool}")
    log(f"[elastic] (c) recompile(strategies=<the same map>) on the compiled step, transformer "
        f"f32 {shape['num_layers']}x{shape['embed_dim']}: 3 steps + recompile + 3 steps bitwise "
        f"equal to 6 steps ({len(want)} parameters); memory_reserved after the first swap "
        f"{first} B, after {RECOMPILE_SWAPS} more {levels} B (limit: + one graph pool, "
        f"{pool} B); card {smi}")


def divergence_swap(ft, build_transformer, synthetic_lm_batch, tmp, smi):
    """(d): a planted regression after a divergence swap on one card rolls
    the strategy back; the swap records render as a diff."""
    from flexflow_tpu_torch.runtime.elastic import elastic_train
    from flexflow_tpu_torch.tools.search_report import render_diff

    build = elastic_lm(ft, build_transformer, synthetic_lm_batch, shape=RECOMPILE_LM)
    ck = os.path.join(tmp, "d")
    with environ({**ELASTIC_ENV, **RECONFIG_ENV}):
        model, dl = build()

        def kick(epoch, _metrics):
            if epoch == 0:
                model._reconfig.request("divergence", ratio=2.0)

        t0 = time.perf_counter()
        elastic_train(model, dl, epochs=5, checkpoint_dir=ck, on_epoch=kick)
        wall = time.perf_counter() - t0
        dl.close()
    swaps = model._reconfig.swaps
    check(swaps[0] == (6, "divergence", "applied") and [o for _, _, o in swaps] ==
          ["applied", "rolled_back"], f"(d) swaps {swaps}")
    check(model._step_count == 15 and all(bool(torch.isfinite(p).all())
                                          for p in all_params(model).values()),
          "(d) training did not finish finite")
    pbs = sorted(glob.glob(os.path.join(ck, "reconfig", "*.pb")))
    check(len(pbs) == 2, f"(d) swap records {pbs}")
    diff = render_diff(*pbs[::-1])
    check("reconfig-mcmc" in diff, "(d) the diff lost the new side's engine")
    log(f"[elastic] (d) divergence swap on one card, transformer bf16 "
        f"{RECOMPILE_LM['num_layers']} layers, {', '.join(f'{k}={v}' for k, v in RECONFIG_ENV.items())}: "
        f"swaps {swaps}, 15 steps finite in {wall:.2f} s, 2 swap records, search_report --diff "
        f"{len(diff.splitlines())} lines; card {smi}")


def watchdog_check(ft, smi):
    """(e): a hang planted in sync surfaces as DeviceHangError within the
    deadline, and the next model trains."""
    from flexflow_tpu_torch.runtime.elastic import DeviceHangError, StepWatchdog
    from flexflow_tpu_torch.testing.chaos_smoke import build_mlp

    deadline, hang = WATCHDOG
    with environ({**ELASTIC_ENV, "FF_CHAOS": f"sync:1=hang:{hang:g}"}):
        model, _ = build_mlp("cuda")
    t0 = time.perf_counter()
    try:
        StepWatchdog(deadline).run(model.sync)
        check(False, "(e) the planted hang was not detected")
    except DeviceHangError:
        waited = time.perf_counter() - t0
    check(deadline <= waited < deadline + 1.0, f"(e) DeviceHangError after {waited:.2f} s")
    nxt, dl = build_mlp("cuda")
    for _ in range(3):
        dl.next_batch(nxt)
        nxt.train_iteration()
    nxt.get_metrics()
    check(nxt.last_loss is not None and math.isfinite(nxt.last_loss),
          f"(e) the next model's loss {nxt.last_loss}")
    dl.close()
    log(f"[elastic] (e) StepWatchdog({deadline:g}) over sync:1=hang:{hang:g}: DeviceHangError "
        f"after {waited:.2f} s; the next model trained 3 steps (loss {nxt.last_loss:.4f}); "
        f"card {smi}")


def prefetch_checks(ft, build_alexnet, kernels, data, tmp, smi):
    """(e): AlexNet fed by the DataLoader with and without prefetch: the same
    batches (params bitwise after 6 shuffled steps with a reset in the
    middle of an epoch), then ms/step and the data_wait span in turns."""
    states = []
    for prefetch in (False, True):
        model, dl = elastic_alexnet(ft, build_alexnet, data, sgd_optimizer(ft),
                                    prefetch=prefetch, shuffle=True)()
        for step in range(6):
            if step in (0, 2):  # the second reset cuts the epoch after 2 batches
                dl.reset()
            dl.next_batch(model)
            model.train_iteration()
        model.sync()
        states.append(state_of(model))
        dl.close()
        del model, dl
        free_models()
    _, bitwise = compare_states(states[0], states[1], GRAPH_TOL, "prefetch on/off")
    check(bitwise, "(e) prefetch changed what was trained on")
    del states
    trace = os.path.join(tmp, "prefetch.jsonl")
    warm, n = PREFETCH_STEPS
    with environ({**ELASTIC_ENV, "FF_TELEMETRY": "1", "FF_TELEMETRY_FILE": trace}):
        model, _ = elastic_alexnet(ft, build_alexnet, data, sgd_optimizer(ft))()
        inp = model.input_tensors[0]
        loaders = {p: ft.DataLoader(model, {inp: data[0]}, data[1], prefetch=p)
                   for p in (False, True)}
        turns = []
        for p in (False, True, True, False):
            dl = loaders[p]
            dl.reset()
            for step in range(n):
                if step == warm:
                    model.sync()
                    t0 = time.perf_counter()
                dl.next_batch(model)  # unshuffled: it wraps to the first batch
                model.train_iteration()
            model.sync()
            turns.append((p, (time.perf_counter() - t0) / (n - warm) * 1e3))
            dl.drain()
        for dl in loaders.values():
            dl.close()
        model._telemetry.flush()
    check(model._step_graph.captures == 1, "(e) the loaders changed the step's signature")
    spans = [json.loads(line) for line in open(trace) if '"data_wait"' in line]
    spans = [s for s in spans if s.get("t") == "span" and s.get("name") == "data_wait"]
    check(len(spans) == 4 * n, f"(e) {len(spans)} data_wait spans, expected {4 * n}")
    report = []
    for i, (p, ms) in enumerate(turns):
        mine = spans[i * n + warm:(i + 1) * n]
        waits = sorted(s["dur"] * 1e3 for s in mine)
        hits = sum(bool(s["attrs"].get("prefetched")) for s in mine)
        report.append(f"prefetch={p}: {ms:.2f} ms/step, {BATCH * 1e3 / ms:.1f} samples/s, "
                      f"data_wait median {waits[len(waits) // 2]:.2f} ms, prefetched "
                      f"{hits}/{len(mine)}")
    del model, loaders
    free_models()
    log(f"[elastic] (e) prefetch: AlexNet batch {BATCH} bf16 SGD fused fed by the DataLoader, "
        f"6 shuffled steps with a reset mid-epoch bitwise equal with and without prefetch; in "
        f"turns, {n - warm} timed steps each (telemetry on): " + "; ".join(report)
        + f"; card {smi}")


def elastic_multi(smi):
    """(f): device loss and gain across the cards (chaos_smoke's reshard
    scenario on one process per card, NCCL), when there are several."""
    from flexflow_tpu_torch.testing import chaos_smoke

    count = torch.cuda.device_count()
    if count < 2:
        log("[elastic] (f) device loss and gain across cards: not run (one card visible; "
            "chaos_smoke --scenario reshard needs 2 or more)")
        return
    world = min(4, count)
    with tempfile.TemporaryDirectory() as wd, environ(ELASTIC_ENV):
        job = chaos_smoke.reshard_job(wd, "cuda", world, timeout=RESHARD_TIMEOUT_S)
        lines = chaos_smoke.check_reshard(job)
    ev = job["ranks"][0]["run1"]["events"]
    log(f"[elastic] (f) device loss and gain on {world} cards (NCCL, the MLP of chaos_smoke, "
        f"{chaos_smoke.reshard_spec(world)}, lag 2): swaps "
        f"{[(e['step'], e['trigger'], e['outcome'], e['new_devices']) for e in ev]} on every "
        f"rank, {chaos_smoke.RESHARD_EPOCHS * 3} steps finite on {world} ranks, every "
        f"rank's weights equal to the unswapped one-card run ({chaos_smoke.RESHARD_TOL}), "
        f"two runs bitwise equal, swap diff {lines} lines, {job['wall_s']:.1f} s; card {smi}")


def elastic_phase(ft, build_alexnet, kernels, smi):
    """Phase 14: the elastic runtime.  Returns the launches of (a)-(e)."""
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch

    t0 = time.perf_counter()
    free_models()
    data = alexnet_data()
    launches = dict.fromkeys(kernels, 0)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(kernels)
        for part in (elastic_recovery(ft, build_alexnet, kernels, data, tmp, smi),
                     elastic_dropout(ft, build_transformer, synthetic_lm_batch, kernels, tmp,
                                     smi)):
            launches = {n: launches[n] + c for n, c in part.items()}
        free_models()
        reset_launches(kernels)
        recompile_checks(ft, build_transformer, synthetic_lm_batch, kernels, smi)
        divergence_swap(ft, build_transformer, synthetic_lm_batch, tmp, smi)
        watchdog_check(ft, smi)
        prefetch_checks(ft, build_alexnet, kernels, data, tmp, smi)
        launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
    del data
    free_models()
    elastic_multi(smi)
    check(all(launches[n] > 0 for n in kernels), f"phase 14 launched no kernel of {launches}")
    log(f"[elastic] phase 14 took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: pipelines and host-resident tables
# ---------------------------------------------------------------------------

PIPE_M = 4                  # (a): microbatches of the lockstep GPipe
# (a): bf16 against the unpipelined blocks: each of the S stages' outputs
# and each of the M microbatch partial weight gradients is rounded to bf16
# where the unpipelined call rounds once, so S + M bf16 steps (2**-7 each)
# relative to each tensor's largest magnitude; f32: phase 3's flash
# tolerance (summation order)
PIPE_BF16_STEPS = LM["num_layers"] + PIPE_M
PIPE_F32_TOL = FLASH_TOL[torch.float32]
PIPE_MLP = dict(batch=256, width=4096, stages=8, classes=16)   # (b)
HETERO_STEPS = 3            # (c): f32 steps held against the on-card DLRM
HETERO_BATCHES = 8          # (c): distinct seeded batches a timed run cycles through
PIPE_MULTI_STEPS = 2        # (e): f32 steps held against one card
DLRM_TABLE_BYTES = 8 * 1_000_000 * 64 * 4


def transformer_blocks(ft, build_transformer, synthetic_lm_batch, dtype):
    """The full-width transformer (phase 4's, ``dtype``) and its blocks as
    stage functions ``fn(params, [x], micro_idx)`` over the model's own ops
    and weights: block i is ln1_i .. res_mlp_i, (B, S, E) -> (B, S, E)."""
    from flexflow_tpu_torch.ops.base import FwdCtx

    model = lm_model(ft, build_transformer, synthetic_lm_batch,
                     lambda m: ft.SGDOptimizer(m, lr=0.001), compute_dtype=dtype, **LM)
    names = [op.name for op in model.ops]
    fns = []
    for i in range(LM["num_layers"]):
        ops = model.ops[names.index(f"ln1_{i}"):names.index(f"res_mlp_{i}") + 1]

        def fn(p, hs, micro_idx, ops=ops):
            env = {ops[0].inputs[0].guid: hs[0]}
            for op in ops:
                ys = op.forward({w.name: p[f"{op.name}/{w.name}"] for w in op.weights},
                                [env[t.guid] for t in op.inputs], FwdCtx(training=True))
                for t, y in zip(op.outputs, ys):
                    env[t.guid] = y
            return [env[ops[-1].output.guid]]
        fns.append(fn)
    params = {f"{opn}/{wn}": w for opn, ws in model._params.items() for wn, w in ws.items()
              if any(opn.endswith(f"_{i}") for i in range(LM["num_layers"]))}
    return model, fns, params


def pipe_runs(pipeline, fns, params, dtype):
    """(pipelined, remat) -> fn(x): the blocks through the lockstep GPipe
    schedule, and the unpipelined blocks under (False, False)."""
    from flexflow_tpu_torch.parallel.pipeline import Spec

    specs = [[Spec((LM["seq_length"], LM["embed_dim"]), dtype)]] * len(fns)

    def unpipelined(x):
        for fn in fns:
            x = fn(params, [x], 0)[0]
        return x

    def pipelined(x, remat):
        return pipeline.gpipe(fns, params, [x], PIPE_M, specs, remat=remat)[0]

    return {(False, False): unpipelined, (True, False): lambda x: pipelined(x, False),
            (True, True): lambda x: pipelined(x, True)}


def rel_err(got, want):
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(
        1e-30)).item()


def lockstep_gpipe_checks(ft, pipeline, build_transformer, synthetic_lm_batch, kernels, smi):
    """(a): the transformer's 4 blocks as 4 stages, M microbatches, in
    lockstep on one card, with and without remat, bf16 and f32: O, dx and
    every block weight's gradient against the unpipelined blocks; K3-K5
    launches per direction; fwd+bwd ms beside the unpipelined call."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    S, M = LM["num_layers"], PIPE_M
    launches = dict.fromkeys(kernels, 0)
    times = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model, fns, params = transformer_blocks(ft, build_transformer, synthetic_lm_batch,
                                                dtype_name)
        runs = pipe_runs(pipeline, fns, params, dtype)
        shape = (LM["batch"], LM["seq_length"], LM["embed_dim"])
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        leaves = list(params.values())

        def fwd_bwd(fn):
            xl = x.detach().clone().requires_grad_(True)
            reset_launches(kernels)
            y = fn(xl)
            fwd = read_launches(kernels)
            grads = torch.autograd.grad(y, [xl] + leaves, dy)
            torch.cuda.synchronize()
            got = read_launches(kernels)
            return y.detach(), grads, fwd, {n: got[n] - fwd[n] for n in got}, got

        want_y, want_g, fwd, bwd, _ = fwd_bwd(runs[(False, False)])
        check(fwd["flash_fwd"] == S and bwd["flash_bwd_dkdv"] == S and bwd["flash_bwd_dq"] == S,
              f"(a) unpipelined launches forward {fwd}, backward {bwd}")
        for remat in (False, True):
            label = f"{dtype_name} remat={int(remat)}"
            y, g, fwd, bwd, got = fwd_bwd(runs[(True, remat)])
            # bubbles skipped: S x M forward launches, S x M of each backward
            # kernel, and with remat the forward again inside the backward
            want = S * M
            check(fwd["flash_fwd"] == want and bwd["flash_bwd_dkdv"] == want
                  and bwd["flash_bwd_dq"] == want
                  and bwd["flash_fwd"] == (want if remat else 0),
                  f"(a) {label}: launches forward {fwd}, backward {bwd}, expected {want} "
                  f"each ({want if remat else 0} K3 in the backward)")
            launches = {n: launches[n] + got[n] for n in got}
            errs = [rel_err(y, want_y)] + [rel_err(a, b) for a, b in zip(g, want_g)]
            if dtype == torch.float32:
                # O and dx elementwise; a weight's gradient sums B x S rows,
                # M microbatch partial sums here, so its summation order
                # differs: held relative to the tensor's largest magnitude
                torch.testing.assert_close(y, want_y, **PIPE_F32_TOL)
                torch.testing.assert_close(g[0], want_g[0], **PIPE_F32_TOL)
                check(max(errs[2:]) <= PIPE_F32_TOL["rtol"],
                      f"(a) {label}: weight gradient error {max(errs[2:]):.3e} relative to "
                      "the largest magnitude")
            else:
                check(max(errs) <= PIPE_BF16_STEPS * 2 ** -7,
                      f"(a) {label}: worst relative error {max(errs):.3e} over "
                      f"{PIPE_BF16_STEPS} bf16 steps")
            log(f"[pipe] (a) {label}: {S} stages x {M} microbatches in lockstep, K3 {fwd['flash_fwd']}"
                f" forward, K3 {bwd['flash_fwd']} K4 {bwd['flash_bwd_dkdv']} K5 "
                f"{bwd['flash_bwd_dq']} backward; vs the unpipelined blocks max|d|/max|ref| O "
                f"{errs[0]:.3e}, dx {errs[1]:.3e}, weight grads {max(errs[2:]):.3e} "
                f"({len(errs) - 2} leaves)")
        if dtype == torch.bfloat16:
            xl = x.detach().clone().requires_grad_(True)
            for key in ((False, False), (True, False), (True, True), (True, True),
                        (True, False), (False, False)):
                fn = runs[key]
                times.setdefault(key, []).append(cuda_time_ms(
                    lambda: torch.autograd.grad(fn(xl), [xl] + leaves, dy), 5))
        del model, fns, params, runs, x, dy, leaves
        free_models()
    log(f"[pipe] (a) tolerances: f32 O and dx rtol atol 1e-4 (phase 3's), weight gradients "
        f"1e-4 of their largest magnitude (summed over {PIPE_M} microbatch partials); bf16 "
        f"{PIPE_BF16_STEPS} bf16 "
        f"steps ({LM['num_layers']} stage outputs and {PIPE_M} microbatch partial sums each "
        f"rounded once more) relative to each tensor's largest magnitude")
    log(f"[pipe] (a) bf16 forward + backward ms of the 4 blocks (B{LM['batch']} S"
        f"{LM['seq_length']} E{LM['embed_dim']}), in turns: " + "; ".join(
            f"{'unpipelined' if not k[0] else ('GPipe remat' if k[1] else 'GPipe')} "
            f"{' / '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())
        + f"; card {smi}")
    return launches


def pipeline_mlp_model(ft, dtype):
    """(b): 8 stages of 4096 x 4096 at batch 256 (``pipeline_mlp`` at
    degree 1, one card), a 16-way head, SGD, fused, its batch staged."""
    p = PIPE_MLP
    model = ft.FFModel(ft.FFConfig(batch_size=p["batch"], compute_dtype=dtype,
                                   fused_optimizer=True))
    inp = model.create_tensor((p["batch"], p["width"]), nchw=False)
    t = model.pipeline_mlp(inp, num_stages=p["stages"], num_microbatches=4, name="pipe")
    model.softmax(model.dense(t, p["classes"], name="head"), name="sm")
    model.compile(ft.SGDOptimizer(model, lr=0.001), "sparse_categorical_crossentropy",
                  ["accuracy"])
    model.init_layers(seed=0)
    rng = np.random.default_rng(15)
    model.set_batch({inp: rng.standard_normal((p["batch"], p["width"]), dtype=np.float32)},
                    rng.integers(0, p["classes"], (p["batch"], 1)).astype(np.int32))
    return model


def pipeline_mlp_checks(ft, kernels, smi):
    """(b): pipeline_mlp through the compiled step: bf16 ms/step and the
    profiler's launches (one K1 a step), f32 compiled == eager bitwise."""
    free_models()
    reset_launches(kernels)
    model = pipeline_mlp_model(ft, "bfloat16")
    ms, losses = steps_ms(model)
    check_graph_run(model, 7, "(b) pipeline_mlp")
    launches = read_launches(kernels)
    check(launches == {**NO_LAUNCH, "fused_sgd_update": 2},
          f"(b) wrapper launches {launches} (eager step and capture), expected 2 K1")
    device_ms, busy = profile_steps(model, "(b) pipeline_mlp 8 x 4096^2 bf16, compiled step", ms,
                                    per_step={**NO_LAUNCH, "fused_sgd_update": 1})
    del model
    states = []
    for graphed in (True, False):
        free_models()
        model = pipeline_mlp_model(ft, "float32")
        with contextlib.nullcontext() if graphed else ft.disable_graphs():
            for _ in range(3):
                model.train_iteration()
        model.sync()
        states.append(state_of(model))
        del model
    worst, bitwise = compare_states(states[0], states[1], GRAPH_TOL, "(b) compiled vs eager")
    check(bitwise, f"(b) f32 compiled and eager states differ (max |d| {worst:.3e})")
    del states
    free_models()
    p = PIPE_MLP
    flops = 6 * p["batch"] * p["width"] ** 2 * p["stages"]
    log(f"[pipe] (b) pipeline_mlp {p['stages']} stages x {p['width']}^2 batch {p['batch']} "
        f"bf16, degree 1 (sequential stages) through the compiled step: {ms:.3f} ms/step, "
        f"device {device_ms:.3f} ms ({busy:.1f}% busy), {flops / device_ms / 1e9:.1f} TFLOP/s "
        f"of the stages' GEMMs on the device; losses {['%.4f' % x for x in losses]}; f32 "
        f"compiled == eager bitwise after 3 steps; card {smi}")
    return launches


def hetero_strategy(directory):
    """(d): the hetero DLRM strategy file of tools/dlrm_strategy.py (8
    tables on the host, the reference's dlrm_strategy_hetero.cc)."""
    import io

    from flexflow_tpu_torch.tools import dlrm_strategy

    with contextlib.redirect_stdout(io.StringIO()):
        return dlrm_strategy.main(["--hetero", "--emb", "8", "-o",
                                   os.path.join(directory, "dlrm_hetero.pb")])


def dlrm_model(ft, dtype, strategy=None, opt=("sgd", 0.01, 0.0), sparse=None):
    """Phase 9's DLRM (batch 256, 8 tables of 1M x 64, bf16 unless said,
    fused), its tables on the card or, with the hetero ``strategy``, on the
    host; returns (model, inputs)."""
    from flexflow_tpu_torch.models.dlrm import build_dlrm

    cfg = dict(compute_dtype=dtype, fused_optimizer=True, sparse_host_embeddings=sparse)
    if strategy:
        cfg.update(import_strategy_file=strategy, import_strategy_reference_order=True)
    batch = ZOO["dlrm"]["batch"]
    model = ft.FFModel(ft.FFConfig(batch_size=batch, **cfg))
    sparse_in, dense_in, _ = build_dlrm(model, batch)
    kind, lr, momentum = opt
    optimizer = (ft.SGDOptimizer(model, lr=lr, momentum=momentum) if kind == "sgd"
                 else ft.AdamOptimizer(model, alpha=lr))
    model.compile(optimizer, "mean_squared_error", ["mean_squared_error"])
    model.init_layers(seed=0)
    return model, sparse_in + [dense_in]


def dlrm_batch(model, ins, seed):
    from flexflow_tpu_torch.models.dlrm import synthetic_batch

    rows = [op.num_entries for op in model.ops if op._type == "Embedding"]
    sparse, dense, labels = synthetic_batch(ZOO["dlrm"]["batch"], rows, 1, ins[-1].dims[1],
                                            seed=seed)
    model.set_batch(dict(zip(ins, sparse + [dense])), labels)
    return sparse


def dlrm_weights(model):
    return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
            for op in model.ops for w in op.weights}


def dlrm_ms(model, ins, steps=HETERO_BATCHES, timed_from=2):
    """Host ms per step over seeded batches staged each step (the swap-in's
    unique, gather and remap on every step), ending in a sync."""
    t0 = None
    for step in range(steps):
        if step == timed_from:
            model.sync()
            t0 = time.perf_counter()
        dlrm_batch(model, ins, 100 + step)
        model.train_iteration()
    model.sync()
    return (time.perf_counter() - t0) / (steps - timed_from) * 1e3


def hetero_checks(ft, kernels, smi, tmp):
    """(c) and (d): the hetero DLRM (8 tables of 1M x 64 in pinned host
    memory, row-sparse, the MLPs on the card) through the compiled step,
    configured by the hetero strategy file."""
    strategy = hetero_strategy(tmp)
    launches = dict.fromkeys(kernels, 0)
    # f32 on the card: phase 9's model, 3 steps
    free_models()
    on_card, ins = dlrm_model(ft, "float32")
    for step in range(HETERO_STEPS):
        dlrm_batch(on_card, ins, step)
        on_card.train_iteration()
    on_card.sync()
    want = dlrm_weights(on_card)
    del on_card
    free_models()
    # f32 on the host, under the guard (a NaN step below)
    reset_launches(kernels)
    with environ({"FF_SKIP_NONFINITE": "5"}):
        model, ins = dlrm_model(ft, "float32", strategy)
    host = model._host
    check(sorted(host.sparse) == [f"embedding{i}" for i in range(8)] and not host.offload,
          f"(d) the hetero file placed {sorted(host.sparse)} row-sparse, {list(host.offload)} "
          "streamed")
    tables0 = {k: v.clone() for k, v in dlrm_weights(model).items() if "embedding" in k[0]}
    touched = [set() for _ in range(8)]
    peak_alloc = 0
    for step in range(HETERO_STEPS):
        for i, ids in enumerate(dlrm_batch(model, ins, step)):
            touched[i].update(np.unique(ids).tolist())
        model.train_iteration()
        peak_alloc = max(peak_alloc, torch.cuda.memory_allocated())
    model.sync()
    launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
    check(launches["fused_sgd_update"] == 2, f"(c) K1 wrapper launches {launches}")
    got = dlrm_weights(model)
    bitwise, worst = True, 0.0
    for key, w in want.items():
        torch.testing.assert_close(got[key], w, **PARITY_TOL,
                                   msg=lambda m: f"(c) host vs card {key}: {m}")
        bitwise = bitwise and torch.equal(got[key], w)
        worst = max(worst, (got[key] - w).abs().max().item())
    for i in range(8):
        key = (f"embedding{i}", "weight")
        keep = torch.ones(got[key].shape[0], dtype=torch.bool)
        keep[list(touched[i])] = False
        check(torch.equal(got[key][keep], tables0[key][keep]),
              f"(c) untouched rows of {key[0]} moved")
    check(peak_alloc < DLRM_TABLE_BYTES, f"(c) memory_allocated {peak_alloc} >= the tables' "
                                         f"{DLRM_TABLE_BYTES} bytes")
    bytes_in, bytes_out = host.bytes_in, host.bytes_out
    buckets = {k: info["u_hwm"] for k, info in host.sparse.items()}
    captures = model._step_graph.captures
    log(f"[pipe] (c) hetero DLRM f32 (8 tables of 1M x 64 in pinned host memory, "
        f"{DLRM_TABLE_BYTES / 1e9:.2f} GB, row-sparse; the MLPs on the card), {HETERO_STEPS} "
        f"compiled steps against phase 9's on-card DLRM: {'bitwise equal' if bitwise else 'max |dw| %.3e (PARITY_TOL)' % worst}; "
        f"untouched rows bitwise unchanged; memory_allocated peak {peak_alloc / 2**20:.1f} MiB "
        f"(< {DLRM_TABLE_BYTES / 2**20:.0f} MiB of tables); per step {bytes_in} bytes in, "
        f"{bytes_out} bytes out (buckets {sorted(set(buckets.values()))}); graphs captured "
        f"{captures}")
    check(captures == len(set(buckets.values())), f"(c) {captures} captures for buckets {buckets}")
    # the guard: a NaN dense input, skipped; every host row bitwise as before
    before = {k: v for k, v in got.items() if "embedding" in k[0]}
    dlrm_batch(model, ins, 50)
    bad = model._batch[f"in_{ins[-1].guid}"]
    bad[3, 0] = float("nan")
    model.train_iteration()
    model.get_metrics()
    after = dlrm_weights(model)
    check(model._guard.total_skipped == 1 and all(torch.equal(after[k], v)
                                                 for k, v in before.items()),
          f"(c) a guarded NaN step: skipped {model._guard.total_skipped}, host rows moved")
    # save, one more step, load: back to the saved state bitwise
    path = os.path.join(tmp, "hetero.npz")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    dlrm_batch(model, ins, 51)
    model.train_iteration()
    t0 = time.perf_counter()
    model.load(path)
    load_s = time.perf_counter() - t0
    loaded = dlrm_weights(model)
    check(all(torch.equal(loaded[k], v) for k, v in after.items()),
          "(c) the loaded state differs from the saved one")
    log(f"[pipe] (c) a NaN batch under FF_SKIP_NONFINITE: skipped, host rows bitwise unchanged; "
        f"save {os.path.getsize(path) / 1e9:.2f} GB .npz in {save_s:.1f} s, load {load_s:.1f} s, "
        f"bitwise")
    os.remove(path)
    del model, got, want, tables0, before, after, loaded
    free_models()
    # bf16 ms/step: on the host (the scatter-back async, synchronous, async
    # again on one model), then on the card
    times = {}
    free_models()
    model, ins = dlrm_model(ft, "bfloat16", strategy)
    for label in ("host rows", "host rows, FF_HE_SYNC_SCATTER", "host rows"):
        with environ({"FF_HE_SYNC_SCATTER": "1"} if "SYNC" in label else {}):
            times.setdefault(label, []).append(dlrm_ms(model, ins))
    bytes_in, bytes_out = model._host.bytes_in, model._host.bytes_out
    del model
    free_models()
    model, ins = dlrm_model(ft, "bfloat16")
    times["on the card"] = [dlrm_ms(model, ins)]
    del model
    log(f"[pipe] (c) hetero DLRM bf16 batch 256, compiled step over {HETERO_BATCHES} seeded "
        f"batches, ms/step in turns: " + "; ".join(
            f"{k} {' / '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())
        + f" (phase 9 times the same on-card step); {bytes_in} bytes in and {bytes_out} out "
          f"a step; card {smi}")
    # forced-lazy Adam on the rows (K2), then momentum in auto mode (offload)
    for label, opt, sparse in (("forced-lazy Adam", ("adam", ADAM_ALPHA, 0.0), True),
                               ("SGD momentum 0.9, auto", ("sgd", 0.01, 0.9), None)):
        free_models()
        reset_launches(kernels)
        model, ins = dlrm_model(ft, "bfloat16", strategy, opt=opt, sparse=sparse)
        ms = dlrm_ms(model, ins, steps=4)
        got = read_launches(kernels)
        launches = {n: launches[n] + c for n, c in got.items()}
        host = model._host
        if sparse:
            check(len(host.sparse) == 8 and got["fused_adam_update"] == 2 * 22,
                  f"(c) {label}: {len(host.sparse)} row-sparse tables, launches {got}")
        else:
            check(not host.sparse and len(host.offload) == 8,
                  f"(c) {label}: {len(host.offload)} streamed tables")
        log(f"[pipe] (c) {label}: {ms:.3f} ms/step; {host.bytes_in / 1e9:.4f} GB in, "
            f"{host.bytes_out / 1e9:.4f} GB out a step ({'row-sparse' if sparse else 'offload'}); "
            f"launches {got}")
        del model
    free_models()
    return launches


def pipe_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev, lead, tmp):
    """(e) on this rank: the full-width transformer under
    set_pipeline(num_stages=4, num_microbatches=4) and the hetero DLRM with
    its MLPs pipelined, f32 weights after 2 steps against the single-device
    unpipelined path (lead rank), then bf16 ms/step beside data
    parallelism (eager mesh steps).  Returns this rank's launches."""
    world = torch.distributed.get_world_size()
    launches = dict.fromkeys(kernels, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the host's cores shared among the ranks, as torchrun's one thread a
    # rank would (the host tables' CPU work runs on every rank at once)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    try:
        return _pipe_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev, lead,
                                tmp, world, launches)
    finally:
        torch.set_num_threads(threads)


def _pipe_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev, lead, tmp, world,
                     launches):
    def lm(pipelined, machine=None, dtype="float32"):
        model = ft.FFModel(ft.FFConfig(batch_size=LM["batch"], compute_dtype=dtype,
                                       fused_optimizer=True))
        tok, pos, _ = build_transformer(model, LM["batch"], **{
            k: v for k, v in LM.items() if k != "batch"})
        if pipelined:
            model.set_pipeline(num_stages=world, num_microbatches=PIPE_M)
        model.compile(ft.SGDOptimizer(model, lr=0.001), "sparse_categorical_crossentropy",
                      ["accuracy"], machine=machine)
        model.init_layers(seed=0)
        toks, posa, labels = synthetic_lm_batch(LM["batch"], LM["seq_length"],
                                                LM["vocab_size"], seed=0)
        model.set_batch({tok: toks, pos: posa}, labels)
        return model

    def dlrm(pipelined, machine=None, dtype="float32"):
        from flexflow_tpu_torch.models.dlrm import build_dlrm

        batch = ZOO["dlrm"]["batch"]
        model = ft.FFModel(ft.FFConfig(batch_size=batch, compute_dtype=dtype,
                                       fused_optimizer=True,
                                       import_strategy_file=hetero_strategy(tmp),
                                       import_strategy_reference_order=True))
        sparse_in, dense_in, _ = build_dlrm(model, batch)
        if pipelined:
            model.set_pipeline(num_stages=world, num_microbatches=PIPE_M)
        model.compile(ft.SGDOptimizer(model, lr=0.01), "mean_squared_error",
                      ["mean_squared_error"], machine=machine)
        model.init_layers(seed=0)
        ins = sparse_in + [dense_in]
        dlrm_batch(model, ins, 0)
        return model

    def weights(model):
        for _ in range(PIPE_MULTI_STEPS):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
                for op in model.ops for w in op.weights}

    for name, make in (("transformer", lm), ("hetero DLRM", dlrm)):
        single = weights(make(False, ft.Machine(devices=[dev]))) if lead else None
        free_models()
        reset_launches(kernels)
        model = make(True)
        plan = model._pipeline_plan
        check(plan is not None and plan["degree"] == world,
              f"(e) {name}: no ring of {world} ({plan and plan['degree']})")
        got = weights(model)
        launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
        if lead:
            worst = 0.0
            for key in single:
                torch.testing.assert_close(got[key], single[key], **LM_PARITY_TOL,
                                           msg=lambda m: f"(e) {name} {key}: {m}")
                worst = max(worst, (got[key] - single[key]).abs().max().item())
            log(f"[pipe] (e) f32 {name} pipelined over {world} cards "
                f"({[[o.name for o in g][:1] + ['..'] for g in plan['stages']]}, head "
                f"{[o.name for o in plan['head']]}), {PIPE_MULTI_STEPS} steps vs one card "
                f"unpipelined: max |dw| {worst:.3e} (rtol 1e-4, atol 1e-5)")
        del model, got, single
        free_models()
    times = {}
    for name, make in (("transformer", lm), ("hetero DLRM", dlrm)):
        for pipelined in (False, True, True, False):
            model = make(pipelined, dtype="bfloat16")
            ms, _ = steps_ms(model)
            times.setdefault((name, pipelined), []).append(ms)
            del model
            free_models()
    if lead:
        log(f"[pipe] (e) bf16 on {world} cards (eager mesh steps), ms/step in turns: " + "; ".join(
            f"{name} {'GPipe' if p else 'data parallel'} {' / '.join(f'{x:.2f}' for x in ms)}"
            for (name, p), ms in times.items()))
    return launches


def pipe_multi_phase(ft, build_transformer, synthetic_lm_batch, kernels, smi):
    """(e): with one visible card it says so and runs nothing; with more, an
    NCCL group of one rank per card (up to 4; this script started again as
    the helper ranks) runs ``pipe_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = min(4, torch.cuda.device_count())
    if world < 2:
        log(f"[pipe] (e) needs more than one card ({torch.cuda.device_count()} visible): the "
            "pipeline across cards was not run")
        return dict.fromkeys(kernels, 0)
    port = free_port()
    helpers = spawn_helpers("pipe", world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        with tempfile.TemporaryDirectory() as tmp:
            launches = pipe_multi_runs(ft, build_transformer, synthetic_lm_batch, kernels, dev,
                                       lead=True, tmp=tmp)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"(e) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[pipe] (e) launches on the lead rank: {launches}; card {smi}")
    return launches


def pipe_helper():
    """A helper rank of phase 15 (e)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    with tempfile.TemporaryDirectory() as tmp:
        pipe_multi_runs(ft, build_transformer, synthetic_lm_batch, kernel_wrappers(fo, fa), dev,
                        lead=False, tmp=tmp)
    dist.shutdown()
    return 0


def pipeline_phase(ft, kernels, smi):
    """Phase 15: (a) the lockstep GPipe of the transformer's blocks, (b)
    pipeline_mlp through the compiled step, (c)-(d) the hetero DLRM on
    host-resident row-sparse tables, (e) across cards when there are
    several.  Returns the launches of its paths."""
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.parallel import pipeline

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, took = dict.fromkeys(kernels, 0), []
    with tempfile.TemporaryDirectory() as tmp:
        for part in (lambda: lockstep_gpipe_checks(ft, pipeline, build_transformer,
                                                   synthetic_lm_batch, kernels, smi),
                     lambda: pipeline_mlp_checks(ft, kernels, smi),
                     lambda: hetero_checks(ft, kernels, smi, tmp),
                     lambda: pipe_multi_phase(ft, build_transformer, synthetic_lm_batch,
                                              kernels, smi)):
            t1 = time.perf_counter()
            launches = {n: launches[n] + c for n, c in part().items()}
            took.append(time.perf_counter() - t1)
    free_models()
    check(all(launches[n] > 0 for n in kernels), f"phase 15 launched no kernel of {launches}")
    log(f"[pipe] phase 15 took {time.perf_counter() - t0:.1f} s ((a) {took[0]:.1f}, (b) "
        f"{took[1]:.1f}, (c)-(d) {took[2]:.1f}, (e) {took[3]:.1f}); launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 16

# (a): the splits of the JAX package's SOAP space, each op at the width its
# model gives it, as (label, input NHWC dims, op arguments, the splits its
# output dims allow: legalize_pc keeps only degrees that divide them)
SOAP2_WINDOWS = (
    ("AlexNet conv1 11x11/4", (64, 229, 229, 3), ("conv", 64, 11, 4, 2),
     ((4, 1), (1, 4), (2, 2))),
    ("AlexNet pool1 max 3x3/2", (64, 56, 56, 64), ("max", 3, 2, 0), ((3, 1), (1, 3), (3, 3))),
    ("avg pool 3x3/2 at pool1", (64, 56, 56, 64), ("avg", 3, 2, 0), ((3, 1), (1, 3), (3, 3))),
    ("ResNet-50 stem conv 7x7/2", (64, 229, 229, 3), ("conv", 64, 7, 2, 3),
     ((5, 1), (1, 5), (5, 5))),
    ("ResNet-50 max pool 3x3/2 pad 1", (64, 115, 115, 64), ("max", 3, 2, 1),
     ((2, 1), (1, 2), (2, 2))),
)
SOAP2_LSTM = dict(batch=64, seq=20, hidden=2048, splits=(2, 4))   # NMT's LSTM
SOAP2_MOE = dict(batch=LM["batch"], seq=LM["seq_length"], embed=LM["embed_dim"], experts=8,
                 hidden=4 * LM["embed_dim"], capacity=0.5,        # drops tokens
                 splits=((1, 2), (1, 4), (2, 2)))                 # (dp, ep)
# f32, a split against the unsplit op: max |split - unsplit| over the largest
# |unsplit|, for the output and every input and weight gradient (the parts
# sum in another order; cuDNN deterministic, TF32 off)
SOAP2_TOL = 1e-4
SOAP2_SEARCH_BUDGET = 200          # (c): each offline search
SOAP2_MODELS = ("alexnet", "nmt", "transformer_moe", "dlrm")
SOAP2_MULTI_STEPS = 2              # (d): f32 steps held against one card


def soap2_runs(label, run, leaves, splits, dtype, smi, iters=3):
    """``run(split)`` -> the op's outputs from ``leaves`` (split None: the
    unsplit op).  f32: every output and gradient of each split held
    against the unsplit op's (SOAP2_TOL of its largest magnitude); bf16:
    fwd+bwd ms of the unsplit op and of each split, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def fwd_bwd(split, cots=None):
        outs = run(split)
        cots = cots or [torch.randn(o.shape, device="cuda", generator=gen, dtype=o.dtype)
                        for o in outs]
        grads = torch.autograd.grad(outs, leaves, cots)
        return [o.detach() for o in outs] + list(grads), cots

    want, cots = fwd_bwd(None)
    errs = {}
    for split in splits:
        got, _ = fwd_bwd(split, cots)
        errs[split] = max(rel_err(a, b) for a, b in zip(got, want))
        if dtype == torch.float32:
            check(errs[split] <= SOAP2_TOL, f"(a) {label} split {split}: f32 max |d| / max "
                  f"|unsplit| {errs[split]:.3e} above {SOAP2_TOL:g}")
    del want
    if dtype == torch.float32:
        log(f"[soap2] (a) f32 {label}: max |split - unsplit| / max |unsplit| over the output "
            f"and every gradient: " + "; ".join(f"{s} {e:.3e}" for s, e in errs.items())
            + f" (tolerance {SOAP2_TOL:g}; cuDNN deterministic, TF32 off)")
        return
    times = {}
    for split in [None, *splits, *reversed(splits), None]:
        times.setdefault(split, []).append(
            cuda_time_ms(lambda s=split: fwd_bwd(s, cots), iters))
    log(f"[soap2] (a) bf16 {label}, fwd+bwd ms in turns (every part in lockstep on one "
        f"card): unsplit " + " / ".join(f"{t:.3f}" for t in times[None]) + "; " + "; ".join(
            f"{s} " + " / ".join(f"{t:.3f}" for t in times[s]) + f" (rel err {errs[s]:.2e})"
            for s in splits) + f"; card {smi}")


def window_checks(ft, smi):
    """(a) convs and pools: each split's tiles (``forward_tiles``: the input
    split as DTensor splits it, each tile's rectangle from a halo exchange
    in lockstep, padding at the image edge only) against the unsplit op;
    each conv tile's rectangle its ``input_ranges``."""
    for dtype in (torch.float32, torch.bfloat16):
        for label, dims, args, splits in SOAP2_WINDOWS:
            m = ft.FFModel(ft.FFConfig(batch_size=dims[0], device="cuda"))
            x = m.create_tensor((dims[0], dims[3], dims[1], dims[2]))
            if args[0] == "conv":
                _, cout, k, s, p = args
                m.conv2d(x, cout, k, k, s, s, p, p, activation="relu")
            else:
                pool, k, s, p = args
                m.pool2d(x, k, k, s, s, p, p, pool_type=pool)
            op = m.ops[0]
            gen = torch.Generator(device="cuda").manual_seed(0)
            fan = math.prod(op.weights[0].dims[:3]) if op.weights else 1
            params = {w.name: (torch.randn(w.dims, device="cuda", generator=gen)
                               / math.sqrt(fan)).requires_grad_(True) for w in op.weights}
            xt = torch.randn(dims, device="cuda", generator=gen).to(dtype).requires_grad_(True)
            rects = []

            def run(split, op=op, params=params, xt=xt, rects=rects):
                if split is None:
                    return op.forward(params, [xt], None)
                return [op.forward_tiles(params, xt, *split, rects)]

            soap2_runs(label, run, [xt, *params.values()], splits, dtype, smi)
            if dtype == torch.float32 and op._type == "Conv2D":
                split = splits[-1]
                rects.clear()
                run(split)
                pc = ft.ParallelConfig(dims=(1, *split, 1))
                want = [tuple(hi - lo + 1 for lo, hi in op.input_ranges(0, pc, i)[1:3])
                        for i in range(split[0] * split[1])]
                check([tuple(r.shape[1:3]) for r in rects] == want,
                      f"(a) {label}: tile rectangles {[r.shape for r in rects]}, "
                      f"input_ranges {want}")
            del m, op, params, xt, rects
            free_models()


def lstm_checks(ft, smi):
    """(a) NMT's LSTM (batch 64, seq 20, hidden = embed 2048): the hidden
    split's parts (``forward_parts``: each part's gate-blocked columns, one
    h gather a step) against the unsplit op, with the encoder's state
    inputs, as the decoder LSTMs take them."""
    c = SOAP2_LSTM
    b, t, h = c["batch"], c["seq"], c["hidden"]
    for dtype in (torch.float32, torch.bfloat16):
        m = ft.FFModel(ft.FFConfig(batch_size=b, device="cuda"))
        x = m.create_tensor((b, t, h), nchw=False)
        hx, cx = m.create_tensor((b, h), nchw=False), m.create_tensor((b, h), nchw=False)
        m.lstm(x, h, hx=hx, cx=cx)
        op = m.ops[0]
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = {w.name: (torch.randn(w.dims, device="cuda", generator=gen)
                           / math.sqrt(h)).requires_grad_(True) for w in op.weights}
        xs = [torch.randn(s, device="cuda", generator=gen).to(dtype).requires_grad_(True)
              for s in ((b, t, h), (b, h), (b, h))]

        def run(k, op=op, params=params, xs=xs):
            return op.forward(params, xs, None) if k is None else op.forward_parts(params, xs, k)

        soap2_runs(f"NMT LSTM b{b} T{t} H{h} with hx/cx, hidden split", run,
                   [*xs, *params.values()], c["splits"], dtype, smi, iters=2)
        del m, op, params, xs
        free_models()


def moe_checks(ft, smi):
    """(a) the MoE transformer's ExpertMLP (8 experts, 16 x 512 tokens of
    512) at capacity factor 0.5, which drops tokens: expert and batch parts
    (``forward_parts``) against the unsplit op, the kept tokens equal."""
    c = SOAP2_MOE
    for dtype in (torch.float32, torch.bfloat16):
        m = ft.FFModel(ft.FFConfig(batch_size=c["batch"], device="cuda"))
        x = m.create_tensor((c["batch"], c["seq"], c["embed"]), nchw=False)
        m.expert_mlp(x, c["experts"], c["hidden"], capacity_factor=c["capacity"])
        op = m.ops[0]
        gen = torch.Generator(device="cuda").manual_seed(2)
        params = {w.name: (torch.randn(w.dims, device="cuda", generator=gen)
                           / math.sqrt(w.dims[-2] if len(w.dims) > 1 else 1)
                           ).requires_grad_(True) for w in op.weights}
        xt = torch.randn(c["batch"], c["seq"], c["embed"], device="cuda",
                         generator=gen).to(dtype).requires_grad_(True)
        keeps = {}

        def run(split, op=op, params=params, xt=xt, keeps=keeps):
            keep = keeps.setdefault(split, [])
            keep.clear()
            if split is None:
                return [op._forward(params, xt, 1, None, keep_out=keep)]
            return [op.forward_parts(params, xt, *split, keep)]

        soap2_runs(f"MoE ExpertMLP {c['experts']} experts x {c['hidden']}, "
                   f"{c['batch']}x{c['seq']} tokens, capacity {c['capacity']}, (dp, ep)",
                   run, [xt, *params.values()], c["splits"], dtype, smi)
        want = keeps[None][0]
        for split in c["splits"]:
            got = torch.cat(keeps[split], 0)
            check(torch.equal(got, want), f"(a) MoE {split}: the kept tokens differ")
        if dtype == torch.float32:
            kept = int(want.any(-1).sum())
            log(f"[soap2] (a) MoE: every split keeps the unsplit op's {kept} of "
                f"{want.shape[0]} tokens ({want.shape[0] - kept} dropped)")
        del m, op, params, xt, keeps
        free_models()


def zero_slice_checks(fo, kernels, alex_shapes, smi):
    """(b) ZeRO-1's update of AlexNet's 16 leaves on 4 ranks, in lockstep on
    the card: each rank's K1 (one launch over its slices and the leaves not
    split) or K2 (one launch a slice or leaf) on its 1/4 row slice of every
    leaf whose leading dim divides, with that slice's state, bitwise equal
    to the whole-leaf launch.  Returns the launches."""
    ranks = 4
    split = [s[0] % ranks == 0 for s in alex_shapes]
    gen = torch.Generator(device="cuda").manual_seed(4)
    launches = dict.fromkeys(kernels, 0)
    for case in kernel_cases(fo):
        if case["sgd"] not in ((0.9, False), None):
            continue
        whole = [tuple(t.reshape(s) for t in operands(math.prod(s), gen)) for s in alex_shapes]
        per_rank = [[tuple(t.clone() for t in leaf) for leaf in whole] for _ in range(ranks)]
        before = case["kernel"].launches
        case["step"](False, whole)
        whole_launches = case["kernel"].launches - before
        before = case["kernel"].launches
        for r, leaves in enumerate(per_rank):
            case["step"](False, [
                tuple(t[r * (t.shape[0] // ranks):(r + 1) * (t.shape[0] // ranks)]
                      for t in leaf) if sp else leaf for leaf, sp in zip(leaves, split)])
        torch.cuda.synchronize()
        slice_launches = case["kernel"].launches - before
        for i, (leaf, sp) in enumerate(zip(whole, split)):
            for j, t in enumerate(leaf):
                rows = t.shape[0] // ranks
                got = (torch.cat([per_rank[r][i][j][r * rows:(r + 1) * rows]
                                  for r in range(ranks)]) if sp else per_rank[0][i][j])
                check(torch.equal(got, t), f"(b) {case['label']} leaf {alex_shapes[i]} operand "
                      f"{j}: the slices' update differs from the whole leaf's")
        sgd = case["sgd"] is not None
        want = ranks if sgd else ranks * len(alex_shapes)
        check(slice_launches == want, f"(b) {case['label']}: {slice_launches} launches over "
              f"the slices, expected {want}")
        kname = case["kernel"].__name__
        launches[kname] += whole_launches + slice_launches
        ms_whole = cuda_time_ms(lambda: case["step"](False, whole), 10)
        rank0 = [tuple(t[:t.shape[0] // ranks] for t in leaf) if sp else leaf
                 for leaf, sp in zip(per_rank[0], split)]
        ms_rank = cuda_time_ms(lambda: case["step"](False, rank0), 10)
        log(f"[soap2] (b) ZeRO-1 {case['label']}, AlexNet's 16 leaves, {sum(split)} split "
            f"4 ways on their rows: every rank's slice update bitwise equal to the whole-leaf "
            f"launch; launches whole {whole_launches}, slices {slice_launches} over 4 ranks "
            f"({'one a rank' if sgd else 'one a slice or leaf'}); kernel ms a step: whole "
            f"{ms_whole:.4f}, one rank's slices {ms_rank:.4f}; card {smi}")
        del whole, per_rank, rank0
        torch.cuda.empty_cache()
    return launches


def composable(model, strategies, nd):
    """Every op's config accepted by its op and composable over the mesh
    the port builds for ``nd`` GPUs (nodes of 8 above 8)."""
    from flexflow_tpu_torch.parallel.mesh import hybrid_mesh_shape, placements_for_degrees

    sizes, names = hybrid_mesh_shape(nd, max(1, nd // NODE_GPUS))
    for op in model.ops:
        pc = op.legalize_pc(strategies[op.name])
        op.check_config(pc)
        if not pc.host_placed:
            placements_for_degrees(names, sizes, pc.dims)


def split_counts(model, strategies):
    """Configs that split a conv or pool spatially, the LSTM's hidden dim or
    the experts, or place a table on the host."""
    counts = dict(spatial=0, lstm_hidden=0, experts=0, host=0)
    for op in model.ops:
        pc = strategies[op.name]
        if pc.host_placed:
            counts["host"] += 1
        elif op._type in ("Conv2D", "Pool2D") and max(pc.dims[1:3]) > 1:
            counts["spatial"] += 1
        elif op._type == "LSTM" and len(pc.dims) > 2 and pc.dims[2] > 1:
            counts["lstm_hidden"] += 1
        elif op._type == "ExpertMLP" and pc.dims[1] > 1:
            counts["experts"] += 1
    return counts


def full_space_search(ft, fo, kernels, smi):
    """(c) full-width AlexNet (SGD) and NMT (Adam) through
    compile(search_budget=...) on the default one-card machine, 3 compiled
    steps each; then offline searches of AlexNet, NMT, the MoE transformer
    and DLRM for an 8-GPU node and for 2 x 8 GPUs, every config accepted
    by its op and composable over the port's mesh.  Returns the launches
    of the compiled steps."""
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.tools import offline_search

    reset_launches(kernels)
    for name in ("alexnet", "nmt"):
        if name == "alexnet":
            model = main_model(ft, build_alexnet, sgd_optimizer(ft), search_budget=SEARCH_BUDGET)
        else:
            model = zoo_model(ft, "nmt", search_budget=SEARCH_BUDGET)
        ms, losses = steps_ms(model, steps=3, timed_from=2)  # the step after the capture
        check_graph_run(model, 3, f"(c) {name}")
        log(f"[soap2] (c) full-width {name} through compile(search_budget={SEARCH_BUDGET}) on "
            f"one card: {sum(op.pc.num_parts() > 1 for op in model.ops)} ops split, 3 "
            f"compiled steps, losses {['%.4f' % x for x in losses]}, {ms:.2f} ms/step")
        del model
        free_models()
    launches = read_launches(kernels)
    want = {"fused_sgd_update": 2, "fused_adam_update": 2 * ZOO["nmt"]["leaves"]}
    check(all(launches[n] == c for n, c in want.items()),
          f"(c) launches {launches}, expected {want} (the eager step and the capture)")
    for nd in (NODE_GPUS, 2 * NODE_GPUS):
        for name in SOAP2_MODELS:
            model = offline_search.build_model(name, offline_search.MODELS[name][2], nd,
                                               device="cpu", compute_dtype="bfloat16")
            t0 = time.perf_counter()
            best = offline_search.run(model, nd, SOAP2_SEARCH_BUDGET, seed=1)
            composable(model, best, nd)
            log(f"[soap2] (c) offline search {name} on {nd} H100s "
                f"({'2 nodes x 8' if nd > NODE_GPUS else 'one node'}), budget "
                f"{SOAP2_SEARCH_BUDGET}: {best.dp_s * 1e3:.3f} ms data parallel, "
                f"{best.best_s * 1e3:.3f} searched; configs that split "
                f"{split_counts(model, best)}; every config accepted and composable; "
                f"{time.perf_counter() - t0:.1f} s")
            del model
    return launches


def legalized(path, nd):
    """A shipped strategy's configs with more parts than ``nd`` cut down by
    halving their largest degree, so a split dim stays split."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file

    out = {}
    for name, pc in load_strategies_from_file(path).items():
        dims = list(pc.dims)
        while math.prod(dims) > nd:
            i = max(range(len(dims)), key=lambda j: dims[j])
            dims[i] //= 2
        out[name] = ft.ParallelConfig(dims=tuple(dims))
    return out


def soap2_multi_runs(ft, kernels, dev, lead):
    """(d) on this rank: eager mesh steps of NMT with its LSTMs split on the
    hidden dim, the MoE transformer's experts split over the cards, AlexNet
    under strategies/alexnet_16.pb legalized onto them (convs and pools
    split spatially), AlexNet Adam with zero_optimizer (state bytes per
    rank) and data parallelism on a hybrid 2 x 2 mesh (num_nodes=2): f32
    weights after 2 steps against one card, then bf16 ms/step beside data
    parallelism.  Returns this rank's launches."""
    from flexflow_tpu_torch.models.alexnet import build_alexnet

    world = torch.distributed.get_world_size()
    launches = dict.fromkeys(kernels, 0)
    # every rank runs this: f32 parity with cuDNN deterministic and TF32
    # off (phase 6's settings for it), the timed bf16 runs as phase 4's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    alex16 = legalized(ALEXNET_STRATEGY, world)
    lstm = {f"{p}_lstm{i}": ft.ParallelConfig(dims=(1, 1, world))
            for p in ("enc", "dec") for i in range(2)}
    experts = {f"moe_{i}": ft.ParallelConfig(dims=(1, world, 1))
               for i in range(1, LM["num_layers"], 2)}
    cases = [
        ("NMT LSTM hidden split", lambda m, dt, split: zoo_model(
            ft, "nmt", machine=m, compute_dtype=dt, strategies=dict(lstm) if split else {}),
         ADAM_ALPHA),
        ("MoE transformer experts split", lambda m, dt, split: zoo_model(
            ft, "transformer_moe", machine=m, compute_dtype=dt,
            strategies=dict(experts) if split else {}), None),
        ("AlexNet alexnet_16.pb legalized", lambda m, dt, split: main_model(
            ft, build_alexnet, sgd_optimizer(ft), machine=m, compute_dtype=dt,
            strategies=dict(alex16) if split else {}), None),
        # f32 at batch 8, as phase 6 holds Adam: Adam's uncorrected first
        # step moves each weight by about 3.2 alpha whatever its gradient's
        # size, so a summed gradient element near 0 whose sign the
        # reduction order flips moves its weight 6.4 alpha the other way
        ("AlexNet Adam zero_optimizer", lambda m, dt, split: main_model(
            ft, build_alexnet, adam_optimizer(ft), machine=m, compute_dtype=dt,
            zero_optimizer=split, batch=8 if dt == "float32" else BATCH), ADAM_ALPHA),
        # per-op dispatch, as measured before the lowering (num_nodes=2 lowers
        # by default; phase 21 (c) holds it lowered)
        ("AlexNet hybrid 2 x 2 mesh (num_nodes=2)", lambda m, dt, split: main_model(
            ft, build_alexnet, sgd_optimizer(ft), machine=m, compute_dtype=dt,
            num_nodes=2 if split else 1, lowered=False), None),
    ]
    if world != 4:
        cases = cases[:-1]  # the hybrid mesh is 2 nodes of 2

    def weights(model):
        for _ in range(SOAP2_MULTI_STEPS):
            model.train_iteration()
        model.sync()
        return {(op.name, w.name): torch.from_numpy(model.get_parameter(op.name, w.name))
                for op in model.ops for w in op.weights}

    for label, make, adam in cases:
        single = weights(make(ft.Machine(devices=[dev]), "float32", False)) if lead else None
        free_models()
        reset_launches(kernels)
        model = make(None, "float32", True)
        applied = {"NMT": "lstm_hidden", "MoE": "experts", "AlexNet alexnet_16": "spatial"}
        for prefix, kind in applied.items():
            if label.startswith(prefix):
                n = split_counts(model, {op.name: op.pc for op in model.ops})[kind]
                check(n > 0, f"(d) {label}: no op split ({kind})")
        check("zero" not in label or model._zero_pl, f"(d) {label}: no state split")
        check("hybrid" not in label or model.machine.axis_names[0] == "dcn",
              f"(d) {label}: mesh {model.machine.axis_names}")
        state = sum(t.to_local().numel() * 4 for tree in (model._opt_state or {}).values()
                    for ws in tree.values() for t in ws.values())
        got = weights(model)
        launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
        if lead:
            tol = SOAP_MULTI_ADAM_TOL if adam else LM_PARITY_TOL
            worst = 0.0
            for key in single:
                torch.testing.assert_close(got[key], single[key], **tol,
                                           msg=lambda m: f"(d) {label} {key}: {m}")
                worst = max(worst, (got[key] - single[key]).abs().max().item())
            extra = ""
            if "zero" in label:
                whole = 4 * 2 * sum(t.numel() for t in single.values())
                extra = (f"; optimizer state on this rank {state:,} bytes against "
                         f"{whole:,} on one card ({len(model._zero_pl)} of 16 leaves split)")
            log(f"[soap2] (d) f32 {label} on {world} cards, {SOAP2_MULTI_STEPS} steps vs one "
                f"card: max |dw| {worst:.3e} (rtol {tol['rtol']:g}, atol {tol['atol']:g}); "
                f"axes {dict(zip(model.machine.axis_names, model.machine.axis_sizes))}{extra}")
        del model, got, single
        free_models()
    times = {}
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    for label, make, _ in cases:
        for split in (False, True, True, False):
            model = make(None, "bfloat16", split)
            ms, _ = steps_ms(model)
            times.setdefault((label, split), []).append(ms)
            del model
            free_models()
    if lead:
        log(f"[soap2] (d) bf16 on {world} cards (eager mesh steps), ms/step in turns: "
            + "; ".join(f"{label} {'split' if s else 'data parallel'} "
                        + " / ".join(f"{x:.2f}" for x in ms) for (label, s), ms in times.items()))
    return launches


def soap2_multi_phase(ft, kernels, smi):
    """(d): with one visible card it says so and runs nothing; with more, an
    NCCL group of one rank per card (up to 4; this script started again as
    the helper ranks) runs ``soap2_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = min(4, torch.cuda.device_count())
    if world < 2:
        log(f"[soap2] (d) needs more than one card ({torch.cuda.device_count()} visible): the "
            "splits across cards were not run")
        return dict.fromkeys(kernels, 0)
    port = free_port()
    helpers = spawn_helpers("soap2", world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        launches = soap2_multi_runs(ft, kernels, dev, lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"(d) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[soap2] (d) launches on the lead rank: {launches}; card {smi}")
    return launches


def soap2_helper():
    """A helper rank of phase 16 (d)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    soap2_multi_runs(ft, kernel_wrappers(fo, fa), dev, lead=False)
    dist.shutdown()
    return 0


def soap_space_phase(ft, fo, kernels, smi, alex_shapes):
    """Phase 16: (a) each new split in lockstep against the unsplit op, (b)
    ZeRO-1's slice updates, (c) the search in the full space, (d) across
    cards when there are several.  Returns the launches of its paths."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, took = dict.fromkeys(kernels, 0), []
    for part in (lambda: (window_checks(ft, smi), lstm_checks(ft, smi), moe_checks(ft, smi),
                          dict.fromkeys(kernels, 0))[-1],
                 lambda: zero_slice_checks(fo, kernels, alex_shapes, smi),
                 lambda: full_space_search(ft, fo, kernels, smi),
                 lambda: soap2_multi_phase(ft, kernels, smi)):
        t1 = time.perf_counter()
        launches = {n: launches[n] + c for n, c in part().items()}
        took.append(time.perf_counter() - t1)
    free_models()
    check(launches["fused_sgd_update"] > 0 and launches["fused_adam_update"] > 0,
          f"phase 16 launched no optimizer kernel: {launches}")
    log(f"[soap2] phase 16 took {time.perf_counter() - t0:.1f} s ((a) {took[0]:.1f}, (b) "
        f"{took[1]:.1f}, (c) {took[2]:.1f}, (d) {took[3]:.1f}); launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 17

MESH_GEN = dict(P=32, N=32)          # generate on the mesh: LM["batch"] rows
MESH_BEAM = dict(B=4, K=4, P=16, N=16)
MESH_PROBS_STEPS = 4                 # decode_step probabilities held step by step
MESH_TOL = dict(rtol=1e-5, atol=1e-6)
# the engine on the mesh: TRAFFIC's first 32 requests (twice ENGINE's
# max_batch, so the batch fills and its slots are reused) and the 8 that
# share its prefix, in TRAFFIC's order (eager mesh steps: the whole
# burst's 10,500 B = 1 prefill steps would take minutes a mode); (a), on
# one card, takes its first 8 and 2 (at the eager mesh's 30 generated
# tokens/s on an H100 its 40 requests took 95 s of the script's time)
MESH_TRAFFIC = (32, 8)
MESH_ONE_TRAFFIC = (8, 2)
MESH_NMT_LEN = 20                    # greedy_translate tokens (NMT_GEN's)
MESH_SERVE_TIMEOUT_S = 120.0         # the followers' replica timeout
MESH_HELPER = "decode"              # (b)'s helper ranks


def mesh_traffic(counts=MESH_TRAFFIC):
    reqs = traffic()
    n, shared = counts
    return reqs[:n] + reqs[TRAFFIC["requests"]:TRAFFIC["requests"] + shared]


def head_split(ft, world):
    """Attention split by heads and every dense layer (the vocabulary-wide
    head included) by column over ``world`` cards."""
    split = {}
    for i in range(LM["num_layers"]):
        for name in (f"attn_{i}", f"mlp_up_{i}", f"mlp_down_{i}"):
            split[name] = ft.ParallelConfig(dims=(1, 1, world))
    split["lm_head"] = ft.ParallelConfig(dims=(1, 1, world))
    return split


def engine_run(lm, paged, reqs, lead):
    """One engine over ``reqs`` submitted at once (on a mesh every rank
    builds, warms up, starts and stops it; the leader submits).  Returns
    (tokens per request, tokens/s, TTFT and TPOT lists) on the leader."""
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(lm, paged=paged, replica_timeout_s=MESH_SERVE_TIMEOUT_S, **ENGINE)
    check(eng._paged == (paged == "on"), f"engine paged={paged}: {eng._paged}")
    eng.warmup()
    hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs] if lead else []
    t0 = time.perf_counter()
    with eng:
        outs = [h.result(1200) for h in hs]
    wall = time.perf_counter() - t0
    if not lead:
        return None
    st = eng.stats()
    check(st["completed"] == len(reqs), f"engine paged={paged}: {st}")
    return (outs, st["tokens_out"] / wall, [h.ttft_s for h in hs],
            [h.tpot_s for h in hs if h.tpot_s is not None], st)


def serve_line(label, r):
    _, rate, ttft, tpot, st = r
    return (f"{label} {rate:,.1f} generated tokens/s, TTFT p50 {pct(ttft, 50):.1f} ms p99 "
            f"{pct(ttft, 99):.1f} ms, TPOT p50 {pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} "
            f"ms, occupancy mean {st['mean_occupancy']:.2f} max {st['max_active']} of "
            f"{ENGINE['max_batch']} over {st['step_iterations']} token boundaries, world size "
            f"{st['world_size']}, prefix hits {st.get('kv', {}).get('prefix_hits', 0)}")


def same_tokens(label, got, want):
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not np.array_equal(a, b)]
    check(len(got) == len(want) and not bad, f"{label}: requests {bad} differ")


def mesh_decode_one(ft, kernels, smi, dev):
    """(a) on a one-rank NCCL mesh: the full-width LM's generate,
    beam_search and paged engine in f32 against the same model's
    one-card decode, decode_step probabilities step by step; bf16 generate
    against one card's; ms and device ms a decode step, eager on the mesh
    beside the captured one-card step.  Returns the kernels' launches on
    these decode paths (an f32 oracle forward that a bf16 difference needs
    is not one of them)."""
    from flexflow_tpu_torch.models.transformer import build_transformer

    rng = np.random.default_rng(17)
    B, V = LM["batch"], LM["vocab_size"]
    P, N = MESH_GEN["P"], MESH_GEN["N"]
    steps = P + N - 1
    prompt = rng.integers(0, V, size=(B, P), dtype=np.int32)
    single = ft.Machine(devices=[dev])
    one, tok, pos = decode_lm(ft, build_transformer, "float32", machine=single)
    mesh, mtok, mpos = decode_lm(ft, build_transformer, "float32")
    check(mesh._sharded and mesh.machine.num_devices == 1, f"(a) mesh {mesh.machine}")
    caches = (one.init_decode_caches(B, P), mesh.init_decode_caches(B, P))
    worst = 0.0
    for t in range(MESH_PROBS_STEPS):
        cur = torch.as_tensor(prompt[:, t], device=dev)
        p1, _ = one.decode_step(one._decode_params(), caches[0], cur, t, tok, pos)
        p2, _ = mesh.decode_step(mesh._decode_params(), caches[1], cur, t, mtok, mpos)
        torch.testing.assert_close(p2, p1, **MESH_TOL, msg=lambda m: f"(a) step {t}: {m}")
        worst = max(worst, (p2 - p1).abs().max().item())
    del caches
    one.generate(prompt, N)  # the first calls: the capture, the mesh's first steps
    mesh.generate(prompt, N)
    want, one_ms = timed_ms(lambda: one.generate(prompt, N))
    got, mesh_ms = timed_ms(lambda: mesh.generate(prompt, N))
    check(np.array_equal(got, want), "(a) f32 mesh generate differs from one card's")
    bp = prompt[:MESH_BEAM["B"], :MESH_BEAM["P"]]
    (s1, sc1), (s2, sc2) = (m.beam_search(bp, MESH_BEAM["N"], beam_size=MESH_BEAM["K"])
                            for m in (one, mesh))
    check(np.array_equal(s1, s2), "(a) f32 mesh beam_search sequences differ")
    np.testing.assert_allclose(sc2, sc1, rtol=MESH_TOL["rtol"])
    log(f"[mesh-decode] (a) f32 one-rank NCCL mesh vs one card: decode_step probabilities "
        f"{MESH_PROBS_STEPS} steps max |dp| {worst:.3e} (rtol {MESH_TOL['rtol']:g}, atol "
        f"{MESH_TOL['atol']:g}); greedy generate B{B} P{P} N{N} equal; beam_search K"
        f"{MESH_BEAM['K']} B{MESH_BEAM['B']} P{MESH_BEAM['P']} N{MESH_BEAM['N']} equal, "
        f"scores within rtol {MESH_TOL['rtol']:g}; card {smi}")
    log(f"[mesh-decode] (a) f32 generate {steps} steps: mesh eager {mesh_ms:.1f} ms "
        f"({mesh_ms / steps:.3f} ms a step), one card captured {one_ms:.1f} ms "
        f"({one_ms / steps:.3f} ms a step); card {smi}")
    # the paged engine alone here (the default for this LM): the dense one
    # runs across cards in (b), and both would outrun the phase's time
    reqs = mesh_traffic(MESH_ONE_TRAFFIC)
    r1 = engine_run(one, "on", reqs, True)
    r2 = engine_run(mesh, "on", reqs, True)
    same_tokens("(a) f32 engine paged=on, mesh vs one card", r2[0], r1[0])
    log(f"[mesh-decode] (a) f32 engine paged over {len(reqs)} requests, every request equal "
        "to one card's; " + serve_line("mesh", r2) + "; " + serve_line("one card", r1)
        + f"; card {smi}")
    del one, mesh
    free_models()
    # bf16: the tokens against one card's, a difference held by the f32 gap
    one, tok, pos = decode_lm(ft, build_transformer, "bfloat16", machine=single)
    mesh, _, _ = decode_lm(ft, build_transformer, "bfloat16")
    one.generate(prompt, N)
    mesh.generate(prompt, N)
    want, one_ms = timed_ms(lambda: one.generate(prompt, N))
    got, mesh_ms = timed_ms(lambda: mesh.generate(prompt, N))
    rows = [b for b in range(B) if not np.array_equal(got[b], want[b])]
    launches = read_launches(kernels)
    worst = 0.0
    if rows:
        f32 = decode_lm(ft, build_transformer, "float32", machine=single)
        for b in rows:
            k = int(np.argmax(got[b] != want[b]))
            probs = f32_probs(*f32, [np.concatenate([prompt[b], got[b][:k]])])
            worst = max(worst, gap(probs[0, P + k - 1], int(got[b][k]), int(want[b][k])))
        del f32
    check(worst <= F32_GAP_TOL, f"(a) bf16 mesh generate: f32 gap {worst:.3e}")
    log(f"[mesh-decode] (a) bf16 generate B{B} P{P} N{N}: {B - len(rows)} of {B} rows equal "
        f"to one card's, the rest within f32 gap {worst:.3e} (tolerance {F32_GAP_TOL:g}); "
        f"mesh eager {mesh_ms / steps:.3f} ms a step, one card captured "
        f"{one_ms / steps:.3f} ms a step; card {smi}")
    m_dev, m_launch = profile_decode(mesh, "(a) bf16 mesh generate (eager)",
                                     lambda: mesh.generate(prompt, N), steps)
    o_dev, o_launch = profile_decode(one, "(a) bf16 one-card generate (captured)",
                                     lambda: one.generate(prompt, N), steps)
    log(f"[mesh-decode] (a) bf16 a decode step: mesh {mesh_ms / steps:.3f} ms ({m_dev:.4f} "
        f"device ms, {m_launch:.1f} launches), one card {one_ms / steps:.3f} ms "
        f"({o_dev:.4f} device ms, {o_launch:.1f} launches); card {smi}")
    del one, mesh
    free_models()
    return launches


def mesh_decode_inputs():
    """(b)'s prompt and requests, made alike on every rank from seeds."""
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, LM["vocab_size"], size=(LM["batch"], MESH_GEN["P"]),
                          dtype=np.int32)
    return prompt, mesh_traffic()


def nmt_translate(model):
    """greedy_translate of MESH_NMT_LEN tokens from a seeded source batch,
    timed."""
    from flexflow_tpu_torch.models import nmt

    src, dst = model.input_tensors[:2]
    toks = np.random.default_rng(5).integers(0, model.ops[0].num_entries,
                                             size=(ZOO["nmt"]["batch"], src.dims[1]),
                                             dtype=np.int32)
    return timed_ms(lambda: nmt.greedy_translate(model, src, dst, toks, MESH_NMT_LEN))


def mesh_decode_refs(ft, dev):
    """(b)'s references on one card, made by the lead before any process
    group exists: the LM's generate and engine (dense, paged), NMT's
    greedy_translate and the MoE transformer's generate, in f32."""
    from flexflow_tpu_torch.models.transformer import build_transformer

    single = ft.Machine(devices=[dev])
    prompt, reqs = mesh_decode_inputs()
    one, _, _ = decode_lm(ft, build_transformer, "float32", machine=single)
    ref = {"generate": one.generate(prompt, MESH_GEN["N"])}
    ref.update({p: engine_run(one, p, reqs, True) for p in ("off", "on")})
    del one
    free_models()
    ref["nmt"], _ = nmt_translate(zoo_model(ft, "nmt", machine=single, compute_dtype="float32"))
    free_models()
    ref["moe"] = zoo_model(ft, "transformer_moe", machine=single,
                           compute_dtype="float32").generate(prompt, MESH_GEN["N"])
    free_models()
    return ref


def mesh_decode_multi_runs(ft, ref):
    """(b) on this rank of min(4, cards): the LM with its heads split and
    its dense layers split by column, greedy generate and the engine
    (dense, paged) in f32; NMT with its LSTMs split on the hidden dim
    (greedy_translate) and the MoE transformer with its experts over the
    cards (generate); on the lead (``ref``: one card's results) each
    against one card."""
    from flexflow_tpu_torch.models.transformer import build_transformer

    world = torch.distributed.get_world_size()
    lead = ref is not None
    smi = nvidia_smi_line() if lead else ""
    prompt, reqs = mesh_decode_inputs()
    B, P, N = LM["batch"], MESH_GEN["P"], MESH_GEN["N"]
    lm, _, _ = decode_lm(ft, build_transformer, "float32", strategies=head_split(ft, world))
    got, ms = timed_ms(lambda: lm.generate(prompt, N))
    if lead:
        check(np.array_equal(got, ref["generate"]),
              f"(b) f32 generate on {world} cards differs from one card's")
        log(f"[mesh-decode] (b) f32 LM heads and columns split {world} ways: greedy generate "
            f"B{B} P{P} N{N} equal to one card's, {ms / (P + N - 1):.3f} ms a step; card {smi}")
    for paged in ("off", "on"):
        r = engine_run(lm, paged, reqs, lead)
        if lead:
            same_tokens(f"(b) engine paged={paged} on {world} cards", r[0], ref[paged][0])
            log(f"[mesh-decode] (b) f32 engine {'paged' if paged == 'on' else 'dense'} over "
                f"{len(reqs)} requests on {world} cards, every request equal to one card's; "
                + serve_line("mesh", r) + "; " + serve_line("one card", ref[paged])
                + f"; card {smi}")
    del lm
    free_models()
    lstm = {f"{p}_lstm{i}": ft.ParallelConfig(dims=(1, 1, world))
            for p in ("enc", "dec") for i in range(2)}
    got, ms = nmt_translate(zoo_model(ft, "nmt", compute_dtype="float32", strategies=lstm))
    free_models()
    if lead:
        check(np.array_equal(got, ref["nmt"]), f"(b) NMT split {world} differs from one card")
        log(f"[mesh-decode] (b) f32 NMT (batch 64, seq 20, hidden 2048) LSTMs split {world} "
            f"ways: greedy_translate {MESH_NMT_LEN} tokens equal to one card's, "
            f"{ms / MESH_NMT_LEN:.3f} ms a token; card {smi}")
    experts = {f"moe_{i}": ft.ParallelConfig(dims=(1, world, 1))
               for i in range(1, LM["num_layers"], 2)}
    moe = zoo_model(ft, "transformer_moe", compute_dtype="float32", strategies=experts)
    got, ms = timed_ms(lambda: moe.generate(prompt, N))
    del moe
    free_models()
    if lead:
        check(np.array_equal(got, ref["moe"]), f"(b) MoE ep {world} differs from one card")
        log(f"[mesh-decode] (b) f32 MoE transformer experts over {world} cards: generate "
            f"B{B} P{P} N{N} equal to one card's, {ms / (P + N - 1):.3f} ms a step; "
            f"card {smi}")


def mesh_decode_multi(ft, smi):
    """(b): with one visible card it says so and runs nothing; with more,
    the lead makes one card's references with no process group alive, then
    an NCCL group of one rank per card (up to 4; this script started again
    as the helper ranks) runs ``mesh_decode_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = min(4, torch.cuda.device_count())
    if world < 2:
        log(f"[mesh-decode] (b) needs more than one card ({torch.cuda.device_count()} "
            "visible): decoding across cards was not run")
        return
    ref = mesh_decode_refs(ft, torch.device("cuda", 0))  # before any process group
    port = free_port()
    helpers = spawn_helpers(MESH_HELPER, world, port)
    try:
        dist.initialize("cuda", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        mesh_decode_multi_runs(ft, ref)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"(b) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[mesh-decode] (b) ran on {world} cards; card {smi}")


def mesh_decode_helper():
    """A helper rank of phase 17 (b)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel import distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    mesh_decode_multi_runs(ft, None)
    dist.shutdown()
    return 0


def mesh_decode_phase(ft, kernels, smi):
    """Phase 17: decoding on a mesh.  (a) a one-rank NCCL mesh against one
    card, in this process; then (b) across the visible cards when there are
    several, on a process group this process forms after (a)'s was shut
    down (ROADMAP C10's path).  Returns the kernels' launches (none: a
    one-token decode step launches none of K1-K5, checked)."""
    from flexflow_tpu_torch.parallel import distributed as dist

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity: TF32 off
    free_models()
    reset_launches(kernels)
    dev = dist.initialize("cuda", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                          rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
    one = mesh_decode_one(ft, kernels, smi, dev)
    dist.shutdown()
    check(one == NO_LAUNCH, f"(a) decode paths launched {one}")
    reset_launches(kernels)  # past (a)'s f32 oracle forward, which is no decode path
    t1 = time.perf_counter()
    mesh_decode_multi(ft, smi)
    launches = read_launches(kernels)
    check(launches == NO_LAUNCH, f"phase 17 launched {launches}")
    log(f"[mesh-decode] phase 17 took {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f}, "
        f"(b) {time.perf_counter() - t1:.1f}); launches {launches}; card {smi}")
    return launches


# ------------------------------------------------------------------ phase 18

SLICE_HELPER = "slice"               # a rank of a slice (SOAP_HELPER's value)
SLICE_SPEC = "FF_CHIP_SMOKE_SLICE"   # that rank's slice, as JSON
# (a): 3 replicas take 2 x max_batch requests each of TRAFFIC, in its order:
# 48 at max_batch 8 (TRAFFIC holds 72)
SLICE_ENGINE = dict(POOL_ENGINE, max_batch=8)
# (b): an eager split-2 mesh prefills at tens of ms a prompt token (PERF.md
# §6): max_batch 4, 2 x 4 requests a replica
SLICE_ENGINE_B = dict(POOL_ENGINE, max_batch=4)
SLICE_TIMEOUT_S = 30.0               # (a)'s replica timeout
SLICE_TIMEOUT_B_S = 20.0             # (b)'s, which C11's drill is held to
SLICE_MARGIN_S = 10.0                # C11: each rank ends within the timeout plus this
SLICE_PG_TIMEOUT_S = 1800.0          # the slices' process groups' own timeout
SLICE_HEDGE = dict(prompt=32, new=64, hedge_ms=20.0)
SLICE_START_S = 300.0                # bound on a slice's registration


def slice_helper():
    """One rank of a phase 18 slice (SLICE_SPEC): the f32 LM on its card,
    one card or its share of a mesh split ``split`` ways by heads and dense
    columns, the lead's weights carried in (convert.load_jax_params), served
    through ``serving.remote.serve_slice`` until the hub says exit.  With
    ``plant``, this rank's first decode step after that file appears fails
    before its collectives (ROADMAP C11's fault, planted here)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.convert import load_jax_params
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.serving import remote

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = json.loads(os.environ[SLICE_SPEC])
    params = np.load(spec["params"], allow_pickle=True).item()
    if spec.get("plant"):
        plant_step_fault(spec["plant"])

    def build(dev):
        machine = None if spec["mesh"] else ft.Machine(devices=[dev])
        split = head_split(ft, spec["split"]) if spec["split"] > 1 else None
        model, _, _ = decode_lm(ft, build_transformer, "float32", machine=machine,
                                strategies=split)
        load_jax_params(model, params)
        return model

    remote.serve_slice(build, name=spec["name"], rank=spec["rank"], ranks=spec["ranks"],
                       device="cuda", local_rank=spec["card"], mesh=spec["mesh"],
                       pg_timeout_s=SLICE_PG_TIMEOUT_S)
    return 0


def plant_step_fault(flag):
    """Make this process's first engine decode step after ``flag`` exists
    raise before it runs: its peers wait in that step's collectives."""
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    run, fired = InferenceEngine._run_decode, []

    def planted(self, *args):
        if not fired and os.path.exists(flag):
            fired.append(1)
            raise RuntimeError("planted step fault before the step's collectives")
        return run(self, *args)

    InferenceEngine._run_decode = planted


def spawn_slice(hub, name, cards, params, split=1, mesh=None, plant=None):
    """This script started again as each rank of slice ``name``, rank r on
    card ``cards[r]``; ``plant`` goes to rank 1 (a follower)."""
    from flexflow_tpu_torch.serving import remote

    mesh = len(cards) > 1 if mesh is None else mesh
    procs = []
    for r, card in enumerate(cards):
        spec = dict(name=name, rank=r, ranks=len(cards), card=card, split=split, mesh=mesh,
                    params=params, plant=plant if r == 1 else None)
        env = dict(os.environ, **{SOAP_HELPER: SLICE_HELPER, SLICE_SPEC: json.dumps(spec),
                                  remote.HUB_ENV: hub.endpoint})
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "FF_CHAOS"):
            env.pop(k, None)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                      stdout=subprocess.DEVNULL))
    return procs


def wait_slices(hub, names, procs):
    """The slices ``names`` once registered; fails at once when one of
    their processes ended first (and after SLICE_START_S)."""
    deadline = time.perf_counter() + SLICE_START_S
    while True:
        try:
            return hub.wait(names, timeout=1.0)
        except TimeoutError:
            dead = [(n, p.returncode) for n in names for p in procs[n] if p.poll() is not None]
            check(not dead, f"slice processes ended before registering: {dead}")
            check(time.perf_counter() < deadline, f"slices {names} within {SLICE_START_S:g} s")


def save_params(model, path):
    """Every weight of ``model`` as {op: {weight: array}} (the tree
    convert.load_jax_params carries into another model)."""
    np.save(path, {op.name: {w.name: model.get_parameter(op.name, w.name) for w in op.weights}
                   for op in model.ops if op.weights}, allow_pickle=True)


class ReplicaStates:
    """Each replica's state over time, sampled every 5 ms in a thread of
    its own (``recovered``: the time to recover of a drill)."""

    def __init__(self, pool):
        import threading

        self.pool, self.seen, self._stop = pool, [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = None
        while not self._stop.wait(0.005):
            now = tuple((r.name, (r.state, r.slice.name if r.slice is not None else None))
                        for r in list(self.pool._replicas))
            if now != last:
                self.seen.append((time.perf_counter(), dict(now), self.pool.ready_replicas))
                last = now

    def stop(self):
        self._stop.set()
        self._thread.join(2)

    def recovered(self, t0, ready):
        """Seconds from ``t0`` until ``ready`` replicas were ready again
        after fewer had been (None when that never happened)."""
        down = False
        for t, _, n in self.seen:
            if t < t0:
                continue
            down = down or n < ready
            if down and n >= ready:
                return t - t0
        return None


def slice_tokens(label, lm, tok, pos, want, reqs, outs, smi):
    """Each request's f32 tokens against one card's f32 generate: equal, or
    differing first at a near-tie of the f32 full forward (the engine's
    batch shapes round the GEMMs otherwise than generate's B = 1; phase
    17's F32_GAP_TOL).  Returns the full forwards' kernel launches."""
    before = read_launches(KERNELS)
    diffs = []
    for i, ((p, n), got) in enumerate(zip(reqs, outs)):
        w = want(p, n)
        if not np.array_equal(got, w):
            k = int(np.argmax(got[:len(w)] != w[:len(got)])) if len(got) == len(w) else 0
            diffs.append((i, k, int(got[k]), int(w[k])))
    worst = 0.0
    for j in range(0, len(diffs), LM["batch"]):
        chunk = diffs[j:j + LM["batch"]]
        seqs = [np.concatenate([reqs[i][0], outs[i][:k]]) for i, k, _, _ in chunk]
        probs = f32_probs(lm, tok, pos, seqs)
        for row, (i, k, a, b) in enumerate(chunk):
            worst = max(worst, gap(probs[row, len(seqs[row]) - 1], a, b))
    check(worst <= F32_GAP_TOL, f"{label}: f32 gap {worst:.3e} > {F32_GAP_TOL}")
    log(f"[slices] {label}: {len(reqs) - len(diffs)} of {len(reqs)} requests' f32 tokens "
        f"equal one card's generate, {len(diffs)} differ first at a near-tie (worst f32 gap "
        f"{worst:.3e}, tolerance {F32_GAP_TOL:g}); card {smi}")
    after = read_launches(KERNELS)
    return {k: after[k] - before[k] for k in after}


def slice_line(label, pool, hs, outs, wall, smi):
    """Tokens/s, TTFT and TPOT p50/p99 of a burst, and each replica's
    occupancy, requests served and card bytes (a remote one's from its
    beat: its engine's KV and graph pools, its process's allocator)."""
    time.sleep(0.3)  # the remote leaders' next beats carry their stats
    st = pool.stats()
    tokens = sum(len(o) for o in outs)
    ttft = [h.ttft_s for h in hs]
    tpot = [h.tpot_s for h in hs if h.tpot_s is not None]
    per = []
    dev = pool.device_bytes()
    for name, r in st["replicas"].items():
        e = r["engine"]
        b = dev.get(name, {})
        if "remote" not in e:
            b = dict(b, allocated=torch.cuda.memory_allocated(),
                     reserved=torch.cuda.memory_reserved())
        mib = {k: ("n/a" if v is None else f"{v / 2**20:.1f}") for k, v in b.items()}
        per.append(f"{name} ({e.get('remote', 'local')}, {e.get('world_size', 1)} rank(s)): "
                   f"{e.get('completed', 0)} served, occupancy mean "
                   f"{e.get('mean_occupancy', 0):.2f} max {e.get('max_active', 0)}, MiB "
                   + ", ".join(f"{k} {v}" for k, v in mib.items()))
    log(f"[slices] {label}: {len(outs)} requests, {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:,.1f} generated tokens/s; TTFT p50 {pct(ttft, 50):.1f} ms p99 "
        f"{pct(ttft, 99):.1f} ms; TPOT p50 {pct(tpot, 50):.2f} ms p99 {pct(tpot, 99):.2f} "
        f"ms; card {smi}")
    log("[slices]   " + "; ".join(per))


def replica_of(pool, slice_name):
    return next(r for r in pool._replicas if r.slice is not None
                and r.slice.name == slice_name)


def slice_drill_kill(label, pool, sl, reqs, states, check_tokens):
    """A replica_kill on ``sl``'s leader at its second admission: its
    attempts fail over exactly once and it restarts in place."""
    rep = replica_of(pool, sl.name)
    before = pool.stats()
    sl.set_chaos("serve:2=replica_kill")
    t0 = time.perf_counter()
    hs, outs, _ = pool_burst(pool, reqs)
    settle(lambda: rep.restarts > 0 and rep.state == "ready"
           and pool.ready_replicas == before["ready_replicas"], f"{label}: restart in place")
    sl.set_chaos(None)
    st = pool.stats()
    check(st["replica_downs"] == before["replica_downs"] + 1
          and st["replica_restarts"] == before["replica_restarts"] + 1
          and st["failovers"] > before["failovers"], f"{label}: {st}")
    check_tokens(label, reqs, outs)
    ttr = states.recovered(t0, before["ready_replicas"])
    log(f"[slices] {label}: {sl.name}'s leader killed at its 2nd admission; "
        f"{st['failovers'] - before['failovers']} attempts failed over exactly once, restarted "
        f"in place (incarnation {rep.engine.uid}, world generation {sl.generation}), time to "
        f"recover {ttr:.3f} s")
    return ttr


def slice_drill_sigkill(label, pool, hub, sl, proc, reqs, states, check_tokens):
    """SIGKILL of ``proc`` (a rank of ``sl``) while ``sl`` holds attempts:
    the slice is lost, its attempts fail over exactly once, it is not
    restarted, and ``add_replica`` claims a spare slice."""
    import collections

    rep = replica_of(pool, sl.name)
    before, restarts = pool.stats(), rep.restarts
    ready = before["ready_replicas"]
    fires = collections.Counter()
    hs = [pool.submit(p, n, timeout_s=0) for p, n in reqs]
    for h in hs:
        h.add_done_callback(lambda r: fires.update([r.request_id]))
    settle(lambda: rep.engine.active_requests(), f"{label}: {sl.name} holds attempts")
    t0 = time.perf_counter()
    proc.kill()
    settle(lambda: rep.state == "lost", f"{label}: {sl.name} marked lost")
    t_lost = time.perf_counter() - t0
    added = pool.add_replica()       # returns once the spare serves
    check(added is not None, f"{label}: no spare slice to add")
    t_back = time.perf_counter() - t0
    outs = [h.result(1200) for h in hs]
    check(len(fires) == len(reqs) and set(fires.values()) == {1}, f"{label}: exactly once")
    new = next(r for r in pool._replicas if r.name == added)
    st = pool.stats()
    check(rep.restarts == restarts and st["failovers"] > before["failovers"]
          and pool.ready_replicas == ready, f"{label}: {st}")
    check_tokens(label, reqs, outs)
    log(f"[slices] {label}: {sl.name}'s process {proc.pid} killed (SIGKILL) holding attempts: "
        f"lost {t_lost:.3f} s after it ({sl.lost}), {st['failovers'] - before['failovers']} "
        f"attempts failed over exactly once, no restart in place; spare slice "
        f"{new.slice.name} added as {added}, {ready} ready again {t_back:.3f} s after the "
        "kill")
    return new.slice


def slice_drill_scale(label, pool, hub, reqs, states, check_tokens):
    """An Autoscaler over the pool: the burst's queue adds a spare slice,
    the quiet after it drains that replica and returns its slice."""
    from flexflow_tpu_torch.serving import Autoscaler, ScaleConfig

    spares = {s.name for s in hub.spares()}
    check(bool(spares), f"{label}: no spare slice")
    names = {r.name for r in pool._replicas}
    ready = pool.ready_replicas
    sc = Autoscaler(pool, ScaleConfig(min_replicas=ready, max_replicas=pool.num_replicas + 1,
                                      interval_s=0.05, up_queue=1.0, up_burn=0.0,
                                      down_queue=0.5, streak=2, up_cooldown_s=0.1,
                                      down_cooldown_s=1.0))
    t0 = time.perf_counter()
    with sc:
        hs, outs, wall = pool_burst(pool, reqs)
        settle(lambda: sc.stats()["scale_ups"] >= 1, f"{label}: scale-up")
        settle(lambda: sc.stats()["scale_downs"] >= 1, f"{label}: scale-down")
    st = sc.stats()
    added = {sl for t, seen, _ in states.seen if t >= t0
             for name, (_, sl) in seen.items() if name not in names}
    back = {s.name for s in hub.spares()}
    check(bool(added) and added <= spares and added <= back,
          f"{label}: added {added} of the spares {spares}, spares after {back}")
    check_tokens(label, reqs, outs)
    log(f"[slices] {label}: scale-up onto spare slice {sorted(added)[0]} and scale-down "
        f"returning it ({st['scale_ups']} up, {st['scale_downs']} down, "
        f"{time.perf_counter() - t0:.3f} s); burst {len(reqs)} requests in {wall:.3f} s")


def slice_drill_hedge(label, hub, names, cfg, prompt, want, smi):
    """A pool over slices ``names`` hedging after SLICE_HEDGE ms: one
    request, hedged once, the winner's tokens; the losing attempt, remote,
    is cancelled on its leader and its slot freed."""
    from flexflow_tpu_torch.serving import ReplicaPool

    slices = [hub.claim(n) for n in names]
    check(all(slices), f"{label}: slices {names} not idle")
    n = SLICE_HEDGE["new"]
    with ReplicaPool(slices, config=cfg) as pool:
        h = pool.submit(prompt, n, timeout_s=0)
        got = h.result(1200)
        st = pool.stats()
        settle(lambda: not pool._attempts, f"{label}: loser untracked")
        settle(lambda: all(r.engine.num_active == 0 for r in pool._replicas),
               f"{label}: the loser's slot freed")
        settle(lambda: sum(v["engine"].get("cancelled", 0)
                           for v in pool.stats()["replicas"].values()) >= 1,
               f"{label}: the loser cancelled on its leader")
    check(st["hedged"] == 1 and st["completed"] == 1 and st["failed"] == 0, f"{label}: {st}")
    winner = (h.admitted_by or "").split("#")[0]
    log(f"[slices] {label}: hedged after {SLICE_HEDGE['hedge_ms']:g} ms, won by {winner} "
        f"({h.admitted_by}); the other attempt, remote, cancelled on its leader and its slot "
        f"freed; card {smi}")
    return got


def slice_pool_one(ft, smi, tmp):
    """(a) on one card: a local captured engine, a remote one-card replica
    (captured) and a remote one-rank NCCL mesh replica (eager), every
    request's f32 tokens held against one card's generate, then the drills:
    a remote leader killed and restarted in place, a slice's process killed
    and a spare added, an autoscaler up onto a spare and down, a hedge whose
    loser is remote.  Returns the f32 oracle's launches (the pool's paths
    launch none)."""
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.serving import ReplicaPool
    from flexflow_tpu_torch.serving.remote import SliceHub

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    lm, tok, pos = decode_lm(ft, build_transformer, "float32", machine=ft.Machine(devices=[dev]))
    params = os.path.join(tmp, "lm_f32.npy")
    save_params(lm, params)
    hub = SliceHub()
    procs = {n: spawn_slice(hub, n, [0], params, mesh=m)
             for n, m in (("card1", False), ("mesh1", True), ("spare-a", False),
                          ("spare-b", False))}
    oracle = dict(NO_LAUNCH)
    try:
        mb = SLICE_ENGINE["max_batch"]
        reqs = traffic()[:2 * mb * 3]
        rng = np.random.default_rng(18)
        hedge_p = rng.integers(0, LM["vocab_size"], size=SLICE_HEDGE["prompt"], dtype=np.int32)
        want = Want(lm)
        t0 = time.perf_counter()
        for p, n in reqs + [(hedge_p, SLICE_HEDGE["new"])]:
            want(p, n)
        t_want = time.perf_counter() - t0
        card1, mesh1 = wait_slices(hub, ["card1", "mesh1"], procs)
        wait_slices(hub, ["spare-a", "spare-b"], procs)
        t_up = time.perf_counter() - t_phase
        outs_all = []

        def check_tokens(label, rs, outs):
            outs_all.append((label, rs, outs))

        cfg = pool_config(**{k: v for k, v in SLICE_ENGINE.items() if k != "paged"},
                          replica_timeout_s=SLICE_TIMEOUT_S)
        pool = ReplicaPool([lm, card1, mesh1], config=cfg, warmup=True)
        t0 = time.perf_counter()
        pool.start()
        log(f"[slices] (a) slices registered {t_up:.1f} s into the phase (one card's f32 "
            f"generate of {len(reqs) + 1} requests {t_want:.1f} s meanwhile); pool of a local "
            f"engine, remote card1 (one card, captured) and mesh1 (one-rank NCCL mesh, eager) "
            f"started in {time.perf_counter() - t0:.1f} s; spares spare-a, spare-b")
        states = ReplicaStates(pool)
        try:
            hs, outs, wall = pool_burst(pool, reqs)
            time.sleep(0.3)  # the remote leaders' next beats carry their stats
            st = pool.stats()
            check(st["completed"] == len(reqs) and st["failovers"] == 0
                  and st["replica_downs"] == 0, f"(a) burst: {st}")
            served = {k: v["engine"]["completed"] for k, v in st["replicas"].items()}
            check(all(n > 0 for n in served.values()), f"(a) a replica served nothing: {served}")
            slice_line(f"(a) f32 burst of TRAFFIC's first {len(reqs)} (2 x max_batch {mb} a "
                       "replica)", pool, hs, outs, wall, smi)
            check_tokens("(a) f32 burst", reqs, outs)
            # each drill sends as many requests as the other replicas have
            # slots and more, so that its target admits some
            ttr_kill = slice_drill_kill("(a) drill replica_kill", pool, card1, reqs[:24], states,
                                        check_tokens)
            added = slice_drill_sigkill("(a) drill SIGKILL", pool, hub, card1,
                                        procs["card1"][0], reqs[24:48], states, check_tokens)
            slice_drill_scale("(a) drill autoscaler", pool, hub, reqs, states,
                              check_tokens)
        finally:
            states.stop()
            pool.stop()
        hcfg = pool_config(**{k: v for k, v in SLICE_ENGINE.items() if k != "paged"},
                           replica_timeout_s=SLICE_TIMEOUT_S, hedge_ms=SLICE_HEDGE["hedge_ms"])
        got = slice_drill_hedge("(a) drill hedge", hub, [added.name, "mesh1"], hcfg, hedge_p,
                                want, smi)
        check_tokens("(a) drill hedge", [(hedge_p, SLICE_HEDGE["new"])], [got])
        launches = read_launches(KERNELS)
        for label, rs, outs in outs_all:
            for k, v in slice_tokens(label, lm, tok, pos, want, rs, outs, smi).items():
                oracle[k] += v
        log(f"[slices] (a) drills: replica_kill time to recover {ttr_kill:.3f} s; phase 18 "
            f"(a) took {time.perf_counter() - t_phase:.1f} s; card {smi}")
        return launches, oracle
    finally:
        hub.close()
        for ps in procs.values():
            for p in ps:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
        del lm
        free_models()


def slice_pool_multi(ft, smi, tmp):
    """(b) on four cards: two replicas of two cards each (the LM's heads
    and dense columns split 2, a process a card) and two spare slices over
    the same cards, every request's f32 tokens against one card's generate;
    C11 (a fault planted on a follower before its step's collectives: every
    rank of that slice ends within the replica timeout plus SLICE_MARGIN_S,
    under process groups whose own timeout is SLICE_PG_TIMEOUT_S, its
    attempts fail over exactly once) and C10 (that slice re-forms its
    communicators in its living processes and serves again), then the
    drills of (a)."""
    from flexflow_tpu_torch.models.transformer import build_transformer
    from flexflow_tpu_torch.serving import ReplicaPool
    from flexflow_tpu_torch.serving.remote import SliceHub

    if torch.cuda.device_count() < 4:
        log(f"[slices] (b) needs four cards ({torch.cuda.device_count()} visible): the pool "
            "over two-card slices was not run")
        return dict(NO_LAUNCH), dict(NO_LAUNCH)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    lm, tok, pos = decode_lm(ft, build_transformer, "float32", machine=ft.Machine(devices=[dev]))
    params = os.path.join(tmp, "lm_f32_b.npy")
    save_params(lm, params)
    flag = os.path.join(tmp, "plant_c11")
    hub = SliceHub()
    procs = {"A": spawn_slice(hub, "A", [0, 1], params, split=2, plant=flag),
             "B": spawn_slice(hub, "B", [2, 3], params, split=2),
             "C": spawn_slice(hub, "C", [0, 1], params, split=2),
             "D": spawn_slice(hub, "D", [2, 3], params, split=2)}
    oracle = dict(NO_LAUNCH)
    try:
        mb = SLICE_ENGINE_B["max_batch"]
        reqs = traffic()[:2 * mb * 2]
        rng = np.random.default_rng(18)
        hedge_p = rng.integers(0, LM["vocab_size"], size=SLICE_HEDGE["prompt"], dtype=np.int32)
        want = Want(lm)
        for p, n in reqs + [(hedge_p, SLICE_HEDGE["new"])]:
            want(p, n)
        A, B = wait_slices(hub, ["A", "B"], procs)
        wait_slices(hub, ["C", "D"], procs)
        outs_all = []

        def check_tokens(label, rs, outs):
            outs_all.append((label, rs, outs))

        cfg = pool_config(**{k: v for k, v in SLICE_ENGINE_B.items() if k != "paged"},
                          replica_timeout_s=SLICE_TIMEOUT_B_S)
        pool = ReplicaPool([A, B], config=cfg)
        pool.start()
        states = ReplicaStates(pool)
        try:
            hs, outs, wall = pool_burst(pool, reqs, timeout=1200)
            st = pool.stats()
            check(st["completed"] == len(reqs) and st["failovers"] == 0, f"(b) burst: {st}")
            slice_line(f"(b) f32 burst of TRAFFIC's first {len(reqs)} (2 x max_batch {mb} a "
                       "replica) over two slices of two cards", pool, hs, outs, wall, smi)
            check_tokens("(b) f32 burst", reqs, outs)
            # C11 and C10 ----------------------------------------------
            rep = replica_of(pool, "A")
            before = pool.stats()
            hs = [pool.submit(p, n, timeout_s=0) for p, n in reqs[:8]]
            settle(lambda: rep.engine.num_active > 0, "(b) C11: A decoding")
            old = rep.engine
            open(flag, "w").close()
            t0 = time.perf_counter()
            outs = [h.result(1200) for h in hs]
            settle(lambda: len(old.ended_at) == 2, "(b) C11: every rank of A ended")
            ends = {r: t - t0 for r, (t, _) in old.ended_at.items()}
            limit = SLICE_TIMEOUT_B_S + SLICE_MARGIN_S
            check(all(e < limit for e in ends.values()),
                  f"(b) C11: ranks of A ended {ends} s after the fault, limit {limit:g}")
            check(all("LockstepBroken" in (c or "") for _, c in old.ended_at.values()),
                  f"(b) C11: {old.ended_at}")
            settle(lambda: rep.restarts >= 1 and rep.state == "ready", "(b) C10: A restarted")
            st = pool.stats()
            moved = st["failovers"] - before["failovers"]
            check(st["replica_downs"] == before["replica_downs"] + 1 and moved >= 1,
                  f"(b) C11: {st}")
            check_tokens("(b) C11 drill", reqs[:8], outs)
            ttr = states.recovered(t0, 2)
            log(f"[slices] (b) C11: a fault planted on A's follower before its step's "
                f"collectives; A's ranks ended {', '.join(f'rank {r} {e:.3f} s' for r, e in sorted(ends.items()))} "
                f"after it (replica timeout {SLICE_TIMEOUT_B_S:g} s + margin {SLICE_MARGIN_S:g}"
                f", process groups' own {SLICE_PG_TIMEOUT_S:g} s), each LockstepBroken; "
                f"{moved} attempts failed over exactly once")
            hs2, outs2, _ = pool_burst(pool, reqs[8:16], timeout=1200)
            settle(lambda: rep.engine.stats().get("completed", 0) > 0,
                   "(b) C10: the re-formed A served")
            check_tokens("(b) C10 after the re-form", reqs[8:16], outs2)
            log(f"[slices] (b) C10: A re-formed its NCCL world in its living processes "
                f"(generation {A.generation}) and serves again ({rep.engine.uid}, "
                f"{rep.engine.stats().get('completed', 0)} served), {ttr:.3f} s from the fault "
                "to two ready replicas")
            # the drills of (a) --------------------------------------------
            # (a)'s drills; each sends as many requests as the other
            # replicas have slots and more, so that the target admits some
            slice_drill_kill("(b) drill replica_kill", pool, B, reqs[:8], states, check_tokens)
            slice_drill_sigkill("(b) drill SIGKILL", pool, hub, B, procs["B"][1], reqs[8:16],
                                states, check_tokens)
            slice_drill_scale("(b) drill autoscaler", pool, hub, reqs[:12], states,
                              check_tokens)
        finally:
            states.stop()
            pool.stop()
        hcfg = pool_config(**{k: v for k, v in SLICE_ENGINE_B.items() if k != "paged"},
                           replica_timeout_s=SLICE_TIMEOUT_B_S, hedge_ms=SLICE_HEDGE["hedge_ms"])
        idle = [s.name for s in hub.spares()][:2]
        got = slice_drill_hedge("(b) drill hedge", hub, idle, hcfg, hedge_p, want, smi)
        check_tokens("(b) drill hedge", [(hedge_p, SLICE_HEDGE["new"])], [got])
        launches = read_launches(KERNELS)
        for label, rs, outs in outs_all:
            for k, v in slice_tokens(label, lm, tok, pos, want, rs, outs, smi).items():
                oracle[k] += v
        log(f"[slices] (b) took {time.perf_counter() - t_phase:.1f} s on four cards; card {smi}")
        return launches, oracle
    finally:
        hub.close()
        for ps in procs.values():
            for p in ps:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
        del lm
        free_models()


def slice_pool_phase(ft, kernels, smi):
    """Phase 18: a replica pool over slices of cards.  (a) on one card; (b)
    with four.  Returns the kernels' launches: the pool's paths launch none
    (checked); the f32 oracle's full forwards, where a request differs
    from generate, launch K3."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity: TF32 off
    free_models()
    KERNELS.update(kernels)
    total = dict(NO_LAUNCH)
    with tempfile.TemporaryDirectory() as tmp:
        for part in (slice_pool_one, slice_pool_multi):
            reset_launches(kernels)
            launches, oracle = part(ft, smi, tmp)
            check(launches == NO_LAUNCH, f"phase 18 {part.__name__} launched {launches}")
            for k, v in oracle.items():
                total[k] += v
    log(f"[slices] phase 18 took {time.perf_counter() - t0:.1f} s; the pool's paths launched "
        f"{NO_LAUNCH}, the f32 oracle's forwards {total}; card {smi}")
    return total


# ----------------------------------------------------------------- phase 19

NATIVE_BUDGET = 1000         # (a): proposals of native and of mcmc, one seed
NATIVE_ZOO = ("alexnet", "transformer", "resnet", "inception", "dlrm", "candle_uno", "nmt",
              "transformer_moe")
NATIVE_HELPER = "native"     # (b)'s helper ranks
NATIVE_REL = 1e-9


def native_builds():
    """The g++ version and each library's build seconds (a fresh build into
    the same hashed path, renamed over it)."""
    from flexflow_tpu_torch.utils import native

    version = subprocess.run([native.compiler(), "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    secs = {src: native.build(src, force=True)["seconds"] for src in ("ffsim.cpp", "ffsearch.cpp")}
    log(f"[native] {version}; build {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())} "
        f"(g++ {' '.join(native.FLAGS)}); host {os.cpu_count()} cores")


def native_zoo_checks(ft, smi):
    """(a) for each zoo model on an 8-GPU node: loops bitwise, the annealer
    against the simulator, proposals/s of native and mcmc."""
    from flexflow_tpu_torch.simulator.delta import DeltaSimulator, _simulate_arrays_ref
    from flexflow_tpu_torch.simulator.machine import H100MachineModel
    from flexflow_tpu_torch.simulator.native_search import native_mcmc_search
    from flexflow_tpu_torch.simulator.search import mcmc_search, search_setup
    from flexflow_tpu_torch.tools import offline_search
    from flexflow_tpu_torch.utils.native import simulate_dag

    rates = []
    for name in NATIVE_ZOO:
        model = offline_search.build_model(name, offline_search.MODELS[name][2], NODE_GPUS,
                                           "cuda", "bfloat16")
        mm = H100MachineModel.calibrated(num_devices=NODE_GPUS)
        _, _, cost, sim = search_setup(model, mm, None, None)
        nat = native_mcmc_search(model, NATIVE_BUDGET, machine_model=mm, seed=0,
                                 verbose=False, cost_model=cost)
        mc = mcmc_search(model, NATIVE_BUDGET, machine_model=mm, seed=0, verbose=False,
                         cost_model=cost)
        dp = {op.name: op.legalize_pc(ft.ParallelConfig.data_parallel(op.output.num_dims,
                                                                      NODE_GPUS))
              for op in model.ops}
        delta = DeltaSimulator(sim, model)
        for label, plan in (("dp", dp), ("native best", dict(nat))):
            full = sim.simulate_runtime(model, plan)
            check(full == sim.simulate_runtime_ref(model, plan),
                  f"{name} {label}: the C++ loop differs from the Python loop")
            arrays = delta.task_graph(plan)
            check(simulate_dag(*arrays) == _simulate_arrays_ref(*arrays) == full,
                  f"{name} {label}: the delta graph's loops differ")
            want = nat.dp_s if label == "dp" else nat.best_s
            check(abs(want - full) <= NATIVE_REL * full,
                  f"{name} {label}: native {want!r} against the simulator {full!r}")
        rates.append(nat.proposals_per_s / mc.proposals_per_s)
        log(f"[native] {name} b{model.config.batch_size} on {NODE_GPUS} H100s: "
            f"{len(model.ops)} ops, {nat.candidates} candidates, {len(arrays[0])} tasks in the "
            f"winner's graph; loops bitwise on dp and the winner; native dp "
            f"{nat.dp_s * 1e3:.4f} ms best {nat.best_s * 1e3:.4f} ms (simulator equal at rel "
            f"{NATIVE_REL}); mcmc best {mc.best_s * 1e3:.4f} ms; budget {NATIVE_BUDGET}: native "
            f"{nat.proposals_per_s:.0f} proposals/s ({nat.evaluated} evaluated), mcmc "
            f"{mc.proposals_per_s:.0f} proposals/s, {nat.proposals_per_s / mc.proposals_per_s:.1f}x "
            f"on this host")
    log(f"[native] native/mcmc proposals/s {min(rates):.1f}x-{max(rates):.1f}x over the zoo "
        f"(host, {os.cpu_count()} cores); card {smi}")


def native_on_card(ft, build_alexnet, kernels, smi):
    """(a) full-width AlexNet searched by the native engine on this card:
    the winner's simulated ms against its measured ms/step (compiled)."""
    from flexflow_tpu_torch.parallel.strategy import strategies_fingerprint

    free_models()
    reset_launches(kernels)
    model = main_model(ft, build_alexnet, sgd_optimizer(ft), search_budget=SEARCH_BUDGET,
                       search_engine="native")
    best = model._search_provenance
    ms, losses = steps_ms(model, steps=7, timed_from=2)
    got = read_launches(kernels)
    check_graph_run(model, 7, "AlexNet searched by native")
    check(got == {n: 2 * c for n, c in ALEX_SGD_STEP.items()}, f"native AlexNet launches {got}")
    check(best["engine"] == "native", f"the search ran as {best['engine']!r}")
    log(f"[native] AlexNet b{BATCH} bf16 SGD compile(search_budget={SEARCH_BUDGET}, "
        f"search_engine='native') on 1 card: ran {best['engine']}, map "
        f"{strategies_fingerprint({op.name: op.pc for op in model.ops})[:19]}, simulated "
        f"{best['best_s'] * 1e3:.3f} ms/step against measured {ms:.3f} ms/step (compiled, 5 "
        f"steps after 2; simulated/measured {best['best_s'] * 1e3 / ms:.3f}); losses "
        f"{['%.4f' % x for x in losses]}; launches {got}; card {smi}")
    del model
    free_models()
    return got


def native_multi_runs(ft, kernels, dev, lead):
    """(b) on this rank: AlexNet searched by the native engine over the
    group's cards, every rank's map compared, 3 eager mesh steps."""
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.parallel.strategy import strategies_fingerprint

    world = torch.distributed.get_world_size()
    reset_launches(kernels)
    model = main_model(ft, build_alexnet, sgd_optimizer(ft), search_budget=SEARCH_BUDGET,
                       search_engine="native")
    best = model._search_provenance
    fp = strategies_fingerprint({op.name: op.pc for op in model.ops})
    fps = [None] * world
    torch.distributed.all_gather_object(fps, fp)
    check(len(set(fps)) == 1, f"(b) the ranks' strategy maps differ: {fps}")
    r = timed_steps(model, kernels, {**NO_LAUNCH, "fused_sgd_update": 1}, steps=3,
                    timed_from=1)
    if lead:
        split = {op.name: op.pc.dims for op in model.ops
                 if op.pc.dims != (world,) + (1,) * (op.output.num_dims - 1)}
        log(f"[native] (b) AlexNet b{BATCH} bf16 compile(search_engine='native') over {world} "
            f"cards: one map on every rank ({fp[:19]}), configs off data parallel {split}; "
            f"simulated {best['best_s'] * 1e3:.3f} ms/step (dp {best['dp_s'] * 1e3:.3f}) against "
            f"measured {r['ms_per_step']:.3f} ms/step (eager mesh steps 2-3); losses "
            f"{['%.4f' % x for x in r['losses']]}")
    del model
    return read_launches(kernels)


def native_multi_phase(ft, kernels, smi):
    """(b): with one visible card it says so; with more, an NCCL group of
    one rank per card (up to 4; this script started again as the helper
    ranks) runs ``native_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = min(4, torch.cuda.device_count())
    if world < 2:
        log(f"[native] (b) needs more than one card ({torch.cuda.device_count()} visible): "
            "the search over a group of cards was not run")
        return dict.fromkeys(kernels, 0)
    port = free_port()
    helpers = spawn_helpers(NATIVE_HELPER, world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        launches = native_multi_runs(ft, kernels, dev, lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=300) == 0, f"(b) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[native] (b) launches on the lead rank: {launches}; card {smi}")
    return launches


def native_helper():
    """A helper rank of phase 19 (b)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    native_multi_runs(ft, kernel_wrappers(fo, fa), dev, lead=False)
    dist.shutdown()
    return 0


def native_phase(ft, build_alexnet, kernels, smi):
    """Phase 19: the native engines on the host and on the card."""
    t0 = time.perf_counter()
    native_builds()
    native_zoo_checks(ft, smi)
    launches = native_on_card(ft, build_alexnet, kernels, smi)
    multi = native_multi_phase(ft, kernels, smi)
    log(f"[native] phase 19 took {time.perf_counter() - t0:.1f} s")
    return {n: launches[n] + multi[n] for n in kernels}


# ------------------------------------------------------------------ phase 20

TOOLS_HANG_TIMEOUT_S = 2.0   # (b): the hung fake probe's deadline
TOOLS_HANG_BOUND_S = 5.0     # (b): ... and the bound on its report
TOOLS_STEPS = 4          # (e): compiled steps of the traced transformer
TOOLS_REQUESTS = 8       # (e): the traced engine's burst, phase 10's first requests
TOOLS_SOAP_BUDGET = 20000    # (f): proposals of the one restart
TOOLS_PROFILE = (("transformer", LM["batch"]), ("alexnet", BATCH))
TOOLS_OPBENCH_ROWS = 12


def sha256_of(paths):
    import hashlib

    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def tools_doctor(smi):
    """(a): the doctor as a user runs it, in a process of its own on the
    card: exit 0, the accelerator line names the card nvidia-smi names, the
    native libraries built."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "flexflow_tpu_torch.tools.doctor"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"[tools] (a) doctor: {line}")
    lines = {ln[7:].split("  ", 1)[0].strip(): ln for ln in r.stdout.splitlines()
             if ln.startswith("[")}
    card = smi.rsplit(",", 1)[0].strip()
    check(r.returncode == 0, f"(a) doctor exit {r.returncode}: {r.stderr[-2000:]}")
    accel = lines.get("accelerator", "")
    check(accel.startswith("[ok") and card in accel, f"(a) accelerator line {accel!r}, "
                                                     f"card {card!r}")
    native_line = lines.get("native libs", "")
    check("ffsim built" in native_line and "ffsearch built" in native_line,
          f"(a) native libs line {native_line!r}")
    log(f"[tools] (a) doctor exit 0 in {wall:.1f} s; its accelerator line names {card}")


def tools_chipwatch(tmp, smi):
    """(b): the probe and a hung probe killed, traced.  (The measurement
    window of calibrate that chipwatch converts, 80-85 s on the card, is cut
    to keep the script inside its time; tests/test_torch_chipwatch.py holds
    convert_window, and phase 8 the calibration on the card.)"""
    from types import SimpleNamespace

    from flexflow_tpu_torch.observability import chipwatch, events
    from flexflow_tpu_torch.tools import trace_report

    card = smi.rsplit(",", 1)[0].strip()
    trace = os.path.join(tmp, "window.jsonl")
    # the log of this process only
    events.reset_active()
    events.for_config(SimpleNamespace(telemetry=True, telemetry_file=trace))
    try:
        res = chipwatch.probe_once()
        check(res.ok and res.device_kind == card.replace(" ", "_"), f"(b) probe {res}")
        log(f"[tools] (b) chipwatch.probe_once: ok, {res.device_kind} in {res.latency_s} s")
        t0 = time.perf_counter()
        hung = chipwatch.probe_once(timeout=TOOLS_HANG_TIMEOUT_S, probe_cmd=[
            sys.executable, "-c", "import time; time.sleep(600)"])
        hung_s = time.perf_counter() - t0
        check(not hung.ok and hung_s < TOOLS_HANG_BOUND_S, f"(b) hung probe {hung} after "
                                                           f"{hung_s:.2f} s")
        log(f"[tools] (b) a probe sleeping past its {TOOLS_HANG_TIMEOUT_S:.0f} s deadline: "
            f"killed, not ok, reported after {hung_s:.2f} s ({hung.detail})")
    finally:
        events.reset_active()
    names = [r.get("name") for r in trace_report.parse_trace(trace)]
    check(names.count("chip_probe") == 2, f"(b) probe trace {names}")


def tools_profile(ft, kernels, tmp, smi):
    """(c): profile_report of the full-width transformer and AlexNet; every
    op has a row, every op with a backward both times above 0, and the
    attention ops' flash launches are the ops times the iterations."""
    from flexflow_tpu_torch.simulator.cost_model import MEASURE_ITERS, MEASURE_WARMUP
    from flexflow_tpu_torch.tools import profile_report
    from flexflow_tpu_torch.tools.offline_search import build_model

    launches = dict(NO_LAUNCH)
    for name, batch in TOOLS_PROFILE:
        free_models()
        reset_launches(kernels)
        t0 = time.perf_counter()
        res = profile_report.main([name, "--batch-size", str(batch), "--compute-dtype",
                                   "bfloat16", "--out", os.path.join(tmp, f"{name}.md")])
        wall = time.perf_counter() - t0
        got = read_launches(kernels)
        ops = build_model(name, batch, 1, "cpu", "bfloat16").ops
        check([r["op"] for r in res["rows"]] == [op.name for op in ops],
              f"(c) {name}: rows {[r['op'] for r in res['rows']]}")
        bad = [r for r in res["rows"] if r["forward_ms"] <= 0
               or (r["trains"] and r["backward_ms"] <= 0)]
        check(not bad, f"(c) {name}: rows without times {bad}")
        n_attn = sum(op._type == "MultiHeadAttention" for op in ops)
        per = n_attn * (MEASURE_WARMUP + MEASURE_ITERS)
        want = {**NO_LAUNCH, "flash_fwd": per, "flash_bwd_dkdv": per, "flash_bwd_dq": per}
        check(got == want, f"(c) {name}: launches {got}, want {want}")
        compiled = MEASURED.get(name, {}).get("graph_ms")
        top = sorted(res["rows"], key=lambda r: -(r["forward_ms"] + r["backward_ms"]))[:3]
        log(f"[tools] (c) profile_report {name} batch {batch} bf16: {len(res['rows'])} ops, "
            f"standalone sum {res['total_ms']:.3f} ms"
            + (f" beside phase 7's compiled {compiled:.3f} ms/step" if compiled
               else " (phase 7 not run: no compiled ms/step)")
            + f"; {n_attn} attention ops x ({MEASURE_WARMUP} + {MEASURE_ITERS}) iterations = "
            f"{per} launches each of K3-K5 (got {got['flash_fwd']}, {got['flash_bwd_dkdv']}, "
            f"{got['flash_bwd_dq']}); costliest "
            + ", ".join(f"{r['op']} {r['forward_ms']:.3f}+{r['backward_ms']:.3f}" for r in top)
            + f" ms; {wall:.1f} s; {res['device']}")
        launches = {k: launches[k] + got[k] for k in launches}
    return launches


def tools_opbench(smi):
    """(d): the standard suite in bf16 and f32 on the card."""
    from flexflow_tpu_torch.tools import opbench

    # f32 means f32 whatever an earlier phase left set (cuDNN's default is TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("bfloat16", "float32"):
        free_models()
        log(f"[tools] (d) opbench, the JAX package's suite of {len(opbench._SUITE)} ops, "
            f"{dtype}, median of 10 (device ms, CUDA events behind a held stream; TF32 "
            "off):")
        rows = opbench.main(["--compute-dtype", dtype])
        bad = [r for r in rows if not (math.isfinite(r["fwd_ms"]) and r["fwd_ms"] > 0
                                       and math.isfinite(r["fwd_bwd_ms"])
                                       and r["fwd_bwd_ms"] > 0)]
        check(len(rows) == TOOLS_OPBENCH_ROWS and not bad, f"(d) {dtype}: rows {rows}")
        log(f"[tools] (d) opbench {dtype}: {len(rows)} rows, every fwd and fwd+bwd ms finite "
            f"and above 0; card {smi}")


def tools_traced(ft, kernels, tmp, smi):
    """(e): a traced run on the card (a few compiled transformer steps, a
    burst through a captured engine), folded by memory_report and
    timeline_export."""
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.tools import memory_report, timeline_export
    from flexflow_tpu_torch.tools.trace_report import parse_trace

    trace = os.path.join(tmp, "traced.jsonl")
    env = {"FF_TELEMETRY": "1", "FF_TELEMETRY_FILE": trace, "FF_MEMPLANE": "1",
           "FF_TRACE_SAMPLE": "1"}
    free_models()
    reset_launches(kernels)
    with environ(env):
        # the serving model first: each compile stamps memory_predicted, and
        # the report folds the last, the training model's
        lm, _, _ = decode_lm(ft, build_transformer, "bfloat16")
        model = lm_model(ft, build_transformer, synthetic_lm_batch,
                         lambda m: ft.SGDOptimizer(m, lr=0.001), **LM)
        for _ in range(TOOLS_STEPS):
            model.train_iteration()
        model.sync()
        check_graph_run(model, TOOLS_STEPS, "(e) traced transformer")
        pool = model._step_graph.pool_bytes()
        del model
        free_models()
        eng = InferenceEngine(lm, **ENGINE)
        warm = eng.warmup()
        reqs = traffic()[:TOOLS_REQUESTS]
        hs = [eng.submit(p, n, timeout_s=0) for p, n in reqs]
        with eng:
            for h in hs:
                h.result(600)
        st = eng.stats()
    launches = read_launches(kernels)
    layers = LM["num_layers"]
    want = {**NO_LAUNCH, "fused_sgd_update": 2, "flash_fwd": 2 * layers,
            "flash_bwd_dkdv": 2 * layers, "flash_bwd_dq": 2 * layers}
    check(launches == want, f"(e) launches {launches}, want {want} (the eager step and the "
                            "capture call the wrappers; the engine none)")
    check(st["completed"] == len(reqs) and st["graphs_captured"] == warm,
          f"(e) engine {st}, {warm} captures in the warm-up")
    del lm, eng
    free_models()
    recs = parse_trace(trace)

    folded = memory_report.fold(recs)
    report = memory_report.render(folded, trace)
    for head in ("## Predicted (analytic model)", "## CUDA-graph captures", "## Live HBM"):
        check(head in report, f"(e) memory_report lacks {head}")
    check(folded["predicted"] is not None and folded["live"], "(e) memory_report: no "
                                                              "predicted or live view")
    train = folded["sites"].get("train_step", {})
    check(train.get("graph_pool_bytes") == pool,
          f"(e) train_step pool {train.get('graph_pool_bytes')} against StepGraph.pool_bytes "
          f"{pool}")
    peaks = [r for r in recs if r.get("t") == "gauge" and r.get("name") == "hbm_bytes"
             and (r.get("attrs") or {}).get("kind") == "peak"]
    live_peak = max((v for (_, kind), v in folded["live"].items() if kind == "peak"),
                    default=None)
    check(peaks and live_peak == float(peaks[-1]["v"]),
          f"(e) live peak {live_peak} against the last hbm_bytes peak gauge "
          f"{peaks[-1]['v'] if peaks else None}")
    for line in report.splitlines():
        if line.startswith(("- ", "| train_step", "| serve", "| 0 |", "| pool")):
            log(f"[tools] (e) memory_report: {line}")
    flagged = [ln for ln in report.splitlines() if ln.startswith("- !! ")]
    log(f"[tools] (e) memory_report over {len(recs)} records: train_step pool "
        f"{pool / 2**20:.1f} MiB = StepGraph.pool_bytes; {len(folded['sites'])} capture sites "
        f"({sum(r['captures'] for r in folded['sites'].values())} captures); live peak "
        f"{live_peak / 2**30:.3f} GiB = the last hbm_bytes peak gauge; {len(flagged)} !! "
        f"row(s); card {smi}")

    out = os.path.join(tmp, "timeline.json")
    check(timeline_export.main([trace, "-o", out]) == 0, "(e) timeline_export failed")
    with open(out) as f:
        doc = json.load(f)
    depth = {}
    for e in doc["traceEvents"]:
        key = (e.get("pid"), e.get("tid"))
        if e["ph"] == "B":
            depth[key] = depth.get(key, 0) + 1
        elif e["ph"] == "E":
            depth[key] = depth.get(key, 0) - 1
            check(depth[key] >= 0, f"(e) an E without its B on {key}")
    check(all(v == 0 for v in depth.values()), f"(e) unmatched B/E {depth}")
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    check({"training", "serving", "requests"} <= procs, f"(e) timeline processes {procs}")
    s = timeline_export.summarize(doc)
    log(f"[tools] (e) timeline_export: {s['events']} events, {s['spans']} B/E pairs matched, "
        f"{s['instants']} instants, {s['counters']} counter samples, "
        f"{s['request_tracks']} request tracks; processes {sorted(procs)}")
    return launches


def tools_soap(tmp, smi):
    """(f): soap_report of AlexNet at its canonical scale on the host."""
    from flexflow_tpu_torch.parallel.strategy import load_strategies_from_file
    from flexflow_tpu_torch.tools import soap_report
    from flexflow_tpu_torch.tools.report_configs import REPORT_DEVICES, REPORT_GLOBAL_BATCH

    keys = os.path.join(tmp, "report_keys.json")
    pb = os.path.join(tmp, "alexnet.pb")
    out = os.path.join(tmp, "REPORT_SOAP_H100.md")
    args = ["alexnet", "--devices", str(REPORT_DEVICES["alexnet"]), "--batch-size",
            str(REPORT_GLOBAL_BATCH["alexnet"]), "--budget", str(TOOLS_SOAP_BUDGET),
            "--restarts", "1", "--export", pb, "--out", out]
    compiled = MEASURED["alexnet"].get("graph_ms")
    if compiled:
        args += ["--measured-single-chip-ms", f"{compiled:.6f}"]
    t0 = time.perf_counter()
    with environ({"FF_REPORT_KEYS_PATH": keys}):
        res = soap_report.main(args)
    wall = time.perf_counter() - t0
    strategies = load_strategies_from_file(pb)
    with open(keys) as f:
        written = json.load(f)
    check(res["canonical"] and list(written) == ["alexnet"] and len(strategies) == 13
          and res["speedup"] >= 1.0, f"(f) {res}, keys {list(written)}, {len(strategies)} ops")
    with open(out) as f:
        agree = [ln for ln in f.read().splitlines() if "ratio" in ln]
    log(f"[tools] (f) soap_report alexnet, {REPORT_DEVICES['alexnet']} GPUs, batch "
        f"{REPORT_GLOBAL_BATCH['alexnet']} bf16, {res['engine']} budget {TOOLS_SOAP_BUDGET} x 1: "
        f"dp {res['dp_ms']:.3f} ms, searched {res['soap_ms']:.3f} ms ({res['speedup']:.2f}x), "
        f"{res['measured']} op times measured, {res['analytic']} by the roofline; the .pb loads "
        f"({len(strategies)} ops), {len(written['alexnet']['keys'])} report keys to the "
        f"temporary file; {wall:.1f} s on the host"
        + (f"; {agree[0]}" if agree else "; phase 7 not run: no agreement line"))


def tools_phase(ft, kernels, smi):
    """Phase 20: the observability tools on the card.  Returns the kernels'
    launches."""
    from flexflow_tpu_torch.simulator.cost_model import MEASURED_CACHE
    from flexflow_tpu_torch.simulator.machine import CALIBRATION_PATH

    t0 = time.perf_counter()
    committed = sha256_of((MEASURED_CACHE, CALIBRATION_PATH))
    free_models()
    with tempfile.TemporaryDirectory() as tmp:
        tools_doctor(smi)
        tools_chipwatch(tmp, smi)
        launches = tools_profile(ft, kernels, tmp, smi)
        tools_opbench(smi)
        traced = tools_traced(ft, kernels, tmp, smi)
        tools_soap(tmp, smi)
    check(sha256_of((MEASURED_CACHE, CALIBRATION_PATH)) == committed,
          "(b) the committed measured_h100.json or machine_h100.json changed")
    log("[tools] (b) measured_h100.json and machine_h100.json byte-identical before and after "
        "the phase (sha256)")
    launches = {k: launches[k] + traced[k] for k in launches}
    log(f"[tools] phase 20 took {time.perf_counter() - t0:.1f} s; wrapper launches {launches}")
    return launches


# ------------------------------------------------------------------ phase 21

LOWER_STEPS = 3          # (a), (c): f32 steps from the same weights, lowered vs per-op
# f32 weights of the lowered step (inductor: fused kernels, other summation
# orders) against per-op dispatch after LOWER_STEPS steps, elementwise:
# phase 5's kernel/plain tolerance for the transformer.  At lr 1e-3 a step
# moves a weight by less than atol, so LOWER_MOVE_RTOL holds what moved.
LOWER_TOL = dict(rtol=1e-4, atol=1e-5)
# per leaf, ||lowered - per-op|| / ||per-op|| of what the f32 steps move:
# the gradients (the first step's, and both at the same weights after the
# steps), the update w3 - w0 and the optimizer slots (momentum: the
# summed gradients).  A zeroed, halved or misrouted gradient gives 0.5-1.
# Set at 6-9x the largest of two sound runs' readings on an H100 (grad
# 5.8e-4, update 1.1e-3, slot 1.7e-3: AlexNet, whose sums over a few
# ReLU kinks differ under inductor; the transformer 2.3e-6, 3.4e-4, none)
LOWER_MOVE_RTOL = dict(grad=5e-3, update=1e-2, slot=1e-2)
# bf16 losses of the timed steps, lowered vs per-op: each step's within
# LOWER_LOSS_RTOL of per-op's, the drop over the run within LOWER_DROP_RTOL
LOWER_LOSS_RTOL = 2e-4
LOWER_DROP_RTOL = 0.25
# f32 eval loss on the lowered mesh model against per-op's (the counts equal)
LOWER_EVAL_RTOL = 1e-5
LOWER_HELPER = "lower"   # (c)'s helper ranks
# (a)'s f32 parity run of the transformer: its depth cut (each lowered
# model compiles for 20-35 s on the card; the bf16 runs keep LM's depth)
LOWER_F32_LAYERS = 2
LOWER_GEN = dict(P=32, N=16)   # (c): greedy generate on the lowered mesh model


def lower_cells(ft, build_alexnet, build_transformer, synthetic_lm_batch):
    """(a)'s two cells: (label, make(lowered, dtype, machine=None, **cfg), launches
    a step, samples a step, tokens a step, the f32 parity run's cut: the
    transformer at LOWER_F32_LAYERS layers; None for AlexNet, whose f32
    parity is not run on one card, to keep the script inside its time: (c)
    holds its lowered f32 step on four cards)."""
    def alexnet(lowered, dtype, machine=None, **cfg):
        return main_model(ft, build_alexnet, sgd_optimizer(ft), machine=machine,
                          compute_dtype=dtype, lowered=lowered, **cfg)

    def lm(lowered, dtype, machine=None, **cfg):
        return lm_model(ft, build_transformer, synthetic_lm_batch,
                        lambda m: ft.SGDOptimizer(m, lr=0.001), machine=machine,
                        **{**LM, "compute_dtype": dtype, "lowered": lowered, **cfg})

    return [(f"AlexNet b{BATCH}", alexnet, ALEX_SGD_STEP, BATCH, 0, None),
            (f"transformer b{LM['batch']} s{LM['seq_length']}", lm, LM_SGD_STEP, LM["batch"],
             LM["batch"] * LM["seq_length"], {"num_layers": LOWER_F32_LAYERS})]


def step_grads(model):
    """One step's gradients at the model's weights, by the path it trains
    on (the lowered region or the op walk), nothing written: {(op,
    weight): f32 gradient}."""
    names = [(o, n) for o, ws in model._params.items() for n in ws]
    leaves = [model._params[o][n] for o, n in names]
    fn, masks = model._train_region, None
    if model._lowering is not None:
        fn = model._lowering.region("train_step", model._train_region)
        masks = model._draw_masks(model._batch, model._stats)
    loss = fn(model._params, model._batch, model._stats, masks)[0]
    grads = model._grads(loss, leaves, model._grad_placements(names, leaves))
    return {k: g.detach().float().clone() for k, g in zip(names, grads)}


def rel_diff(a, b):
    """||a - b|| / ||b|| (0 where both are 0)."""
    d = (a.double() - b.double()).norm().item()
    n = b.double().norm().item()
    return d / n if n else (0.0 if d == 0 else math.inf)


def lower_f32_parity(label, make, f32_cfg, smi):
    """(a)'s f32 parity for one cell (under ``f32_cfg``) from the same
    weights, lowered through aot_eager (no fusion) and through inductor
    against per-op: one step's gradients, then LOWER_STEPS captured steps.
    aot_eager must equal per-op bitwise (gradients, weights and slots);
    inductor, per leaf, within LOWER_MOVE_RTOL of per-op's norm: the
    first gradient, both gradients at per-op's weights after the steps,
    the updates and the slots; and the weights elementwise."""
    from flexflow_tpu_torch.parallel.lowering import GraphLowering

    runs = {}
    for path in ("per-op", "aot_eager", "inductor"):
        model = make(path != "per-op", "float32", **f32_cfg)
        check((model._lowering is not None) == (path != "per-op"), f"(a) {label}: {path}")
        if path == "aot_eager":
            model._lowering = GraphLowering(model.machine, model.ops, backend="aot_eager")
        w0 = {k: v for k, v in state_of(model).items() if k[0] == "w"}
        grads = step_grads(model)
        for _ in range(LOWER_STEPS):
            model.train_iteration()
        model.sync()
        check_graph_run(model, LOWER_STEPS, f"(a) {label} f32 {path}")
        state = state_of(model)
        same = None  # the gradient at per-op's weights after the steps
        if path == "per-op":
            same = step_grads(model)
        elif path == "inductor":
            with torch.no_grad():
                for o, ws in model._params.items():
                    for n, t in ws.items():
                        t.copy_(runs["per-op"][2][("w", o, n)])
            same = step_grads(model)
        runs[path] = (w0, grads, state, same)
        del model
        free_models()
    (w0p, gp, sp, sgp), (w0a, ga, sa, _), (w0i, gi, si, sgi) = (
        runs["per-op"], runs["aot_eager"], runs["inductor"])
    check(all(torch.equal(w0p[k], w0i[k]) and torch.equal(w0p[k], w0a[k]) for k in w0p),
          f"(a) {label}: the f32 runs started from different weights")
    aot_grads = all(torch.equal(ga[k], gp[k]) for k in gp)
    aot_steps = all(torch.equal(sa[k], sp[k]) for k in sp)
    moved = {"grad": {k: rel_diff(gi[k], gp[k]) for k in gp},
             f"grad at per-op's w{LOWER_STEPS}": {k: rel_diff(sgi[k], sgp[k]) for k in sgp},
             "update": {k: rel_diff(si[k] - w0i[k], sp[k] - w0p[k]) for k in w0p},
             "slot": {k: rel_diff(si[k], sp[k]) for k in sp if k[0] != "w"}}
    worst = {m: max(((v, k) for k, v in d.items()), default=(0.0, None))
             for m, d in moved.items()}
    gk = worst["grad"][1]
    outliers = int(((gi[gk] - gp[gk]).abs() > 1e-3 * gp[gk].abs().max()).sum())
    weights = {k: v for k, v in si.items() if k[0] == "w"}
    dw, bitwise = compare_states(weights, sp, LOWER_TOL, f"(a) {label} lowered/per-op")
    log(f"[lower] (a) {label} f32 {f32_cfg or ''}, per leaf ||lowered - per-op|| / "
        f"||per-op|| through inductor (grad: the first step's gradient; grad at per-op's "
        f"w{LOWER_STEPS}: both gradients at the same weights after the steps; update: "
        f"w{LOWER_STEPS} - w0; slot: the optimizer's): "
        + "; ".join(f"{m} max {v:.3e} {k} (median {float(np.median(list(moved[m].values()))):.3e}"
                    f", limit {LOWER_MOVE_RTOL[m.split()[0]]:g})" for m, (v, k) in worst.items()
                    if moved[m])
        + f"; the worst gradient leaf {gk} has {outliers} of {gp[gk].numel()} elements off by "
        f"more than 1e-3 of its largest; lowered through aot_eager (no fusion): the gradient "
        f"{'bitwise equal' if aot_grads else 'not equal'} over {len(gp)} leaves, "
        f"{LOWER_STEPS} captured steps' weights and slots "
        f"{'bitwise equal' if aot_steps else 'not equal'}; through inductor the "
        f"weights after {LOWER_STEPS} captured steps max |dw| {dw:.3e} "
        f"({'bitwise' if bitwise else 'not bitwise'}; rtol {LOWER_TOL['rtol']:g}, atol "
        f"{LOWER_TOL['atol']:g}); card {smi}")
    check(aot_grads and aot_steps, f"(a) {label} f32: the lowered step through aot_eager "
                                   "is not bitwise equal to per-op's")
    for m, d in moved.items():
        for k, v in d.items():
            check(v <= LOWER_MOVE_RTOL[m.split()[0]], f"(a) {label} f32 {m} {k}: lowered "
                                                      f"differs from per-op by {v:.3e} of its norm")
    del runs, sp, si, sa, gp, gi, ga, sgp, sgi
    free_models()


def lower_one_card(label, make, per_step, samples, tokens, f32_cfg, smi):
    """(a) for one cell: the f32 parity (``lower_f32_parity``) unless
    ``f32_cfg`` is None, then bf16: the first step's wall (the lowered one
    compiles), ms/step in turns, the losses held against per-op's, device
    ms by kernel family and launches a step by the exact count."""
    if f32_cfg is not None:
        lower_f32_parity(label, make, f32_cfg, smi)
    models, first_s = {}, {}
    for lowered in (False, True):
        model = make(lowered, "bfloat16")
        model.sync()
        t0 = time.perf_counter()
        model.train_iteration()
        model.sync()
        first_s[lowered] = time.perf_counter() - t0
        model.reset_metrics()  # the losses below are the timed runs' own
        models[lowered] = model
    graphs = dict(models[True]._lowering.graphs)
    check(graphs == {"train_step": 1}, f"(a) {label}: graphs compiled {graphs}")
    times, losses = {False: [], True: []}, {}
    for lowered in (False, True, True, False):
        ms, out = steps_ms(models[lowered])
        times[lowered].append(ms)
        losses.setdefault(lowered, out)
    for lowered in (False, True):
        check(models[lowered]._step_graph.captures == 1, f"(a) {label}: one capture")
    prof = {}
    kms = {False: {}, True: {}}
    for lowered in (False, True):
        path = "lowered" if lowered else "per-op"
        prof[lowered] = profile_steps(models[lowered], f"(a) {label} bf16 {path}",
                                      times[lowered][0], per_step=per_step,
                                      kernel_ms=kms[lowered])
    del models
    free_models()
    rate = tokens if tokens else samples
    unit = "tokens/s" if tokens else "samples/s"
    log(f"[lower] (a) {label} bf16 SGD: first step (the lowered one compiles) per-op "
        f"{first_s[False]:.2f} s, lowered {first_s[True]:.2f} s (compile about "
        f"{first_s[True] - first_s[False]:.1f} s); graphs {graphs}; ms/step in turns per-op "
        f"{' / '.join(f'{x:.3f}' for x in times[False])}, lowered "
        f"{' / '.join(f'{x:.3f}' for x in times[True])} "
        f"({rate * 1e3 / times[False][0]:.0f} / {rate * 1e3 / times[True][0]:.0f} {unit}); "
        f"device ms/step per-op {prof[False][0]:.3f} ({prof[False][1]:.1f}% busy), lowered "
        f"{prof[True][0]:.3f} ({prof[True][1]:.1f}% busy); this repo's kernels' device ms "
        f"per-op { {k: round(v, 4) for k, v in kms[False].items()} }, lowered "
        f"{ {k: round(v, 4) for k, v in kms[True].items()} }; launches a step {per_step}; "
        f"card {smi}")
    lp, ll = losses[False], losses[True]
    step_err = max(abs(b - a) / abs(a) for a, b in zip(lp, ll))
    drops = (lp[0] - lp[-1], ll[0] - ll[-1])
    log(f"[lower] (a) {label} bf16 losses per-op {['%.5f' % x for x in lp]}, lowered "
        f"{['%.5f' % x for x in ll]}: a step's largest relative difference {step_err:.3e} "
        f"(limit {LOWER_LOSS_RTOL:g}); drop over the run per-op {drops[0]:.3e}, lowered "
        f"{drops[1]:.3e} (limit {LOWER_DROP_RTOL:g} of per-op's)")
    check(step_err <= LOWER_LOSS_RTOL, f"(a) {label} bf16 losses {ll} vs per-op {lp}")
    check(drops[0] > 0 and abs(drops[1] - drops[0]) <= LOWER_DROP_RTOL * drops[0],
          f"(a) {label} bf16 loss drop lowered {drops[1]} vs per-op {drops[0]}")
    return {"first_s": first_s, "times": times, "prof": prof}


def lower_knobs(ft, smi):
    """(b): a bad FF_LOWERED raises at compile; with num_nodes=2 auto lowers
    and FF_LOWERED=0 does not (resolved on the card's compiled model)."""
    import types

    from flexflow_tpu_torch.parallel import lowering as low

    def tiny(**cfg):
        m = ft.FFModel(ft.FFConfig(batch_size=8, **cfg))
        x = m.create_tensor((8, 16), nchw=False)
        m.softmax(m.dense(x, 4, name="fc"))
        m.compile(ft.SGDOptimizer(lr=0.1), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                  [ft.MetricsType.ACCURACY])
        return m

    with environ({"FF_LOWERED": "banana"}):
        try:
            tiny()
            raised = None
        except ValueError as e:
            raised = str(e)
    check(raised is not None and "FF_LOWERED" in raised, f"(b) FF_LOWERED=banana: {raised}")
    m = tiny()
    check(m._lowering is None, "(b) one card, auto: lowered")
    two = types.SimpleNamespace(config=ft.FFConfig(num_nodes=2), machine=m.machine, ops=m.ops)
    auto = low.maybe_lowering(two)
    with environ({"FF_LOWERED": "0"}):
        off = low.maybe_lowering(two)
    check(auto is not None and auto.backend == "inductor" and off is None,
          f"(b) num_nodes=2: auto {auto}, FF_LOWERED=0 {off}")
    with environ({"FF_LOWERED": "1"}):
        on = tiny()._lowering
    check(on is not None, "(b) FF_LOWERED=1 did not lower")
    log(f"[lower] (b) FF_LOWERED=banana raised at compile ({raised[:60]}...); one card auto: "
        f"per-op; num_nodes=2 auto: {auto!r}; with FF_LOWERED=0: per-op; FF_LOWERED=1: "
        f"{on!r}; card {smi}")


def lower_multi_runs(ft, kernels, dev, lead):
    """(c) on this rank: the full-width transformer split by heads and
    columns over the cards, and AlexNet on the hybrid 2 x 2 mesh
    (num_nodes=2, lowered by auto), each lowered against the eager per-op
    mesh step: f32 weights after LOWER_STEPS steps, one eval_batch and (the
    transformer) one greedy generate; then bf16 ms/step and host ms a step,
    and the graphs each compiled.  Returns this rank's launches."""
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch

    world = torch.distributed.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    cells = lower_cells(ft, build_alexnet, build_transformer, synthetic_lm_batch)
    cases = [(f"transformer split {world} by heads and columns",
              lambda lowered, dt: cells[1][1](lowered, dt, strategies=head_split(ft, world)), True)]
    if world == 4:
        cases.append(("AlexNet hybrid 2 x 2 mesh (num_nodes=2)",
                      lambda lowered, dt: cells[0][1](None if lowered else False, dt,
                                                      num_nodes=2), False))
    launches = dict.fromkeys(kernels, 0)
    toks = synthetic_lm_batch(LM["batch"], LM["seq_length"], LM["vocab_size"], seed=0)[0]
    prompt = toks[:, :LOWER_GEN["P"]]
    for label, make, is_lm in cases:
        res = {}
        for lowered in (False, True):
            reset_launches(kernels)
            model = make(lowered, "float32")
            check((model._lowering is not None) == lowered,
                  f"(c) {label}: lowering {model._lowering}")
            w0 = {(o, n): torch.from_numpy(model.get_parameter(o, n))
                  for o, n in model._weight_names()}
            for _ in range(LOWER_STEPS):
                model.train_iteration()
            w = {(o, n): torch.from_numpy(model.get_parameter(o, n))
                 for o, n in model._weight_names()}
            met = model.eval_batch()
            gen = model.generate(prompt, LOWER_GEN["N"]) if is_lm else None
            graphs = dict(model._lowering.graphs) if lowered else {}
            launches = {n: launches[n] + c for n, c in read_launches(kernels).items()}
            res[lowered] = (w0, w, met, gen, graphs)
            del model
            free_models()
        (w0a, wa, ma, ga, _), (w0b, wb, mb, gb, graphs) = res[False], res[True]
        worst = worst_u = 0.0
        for key in wa:
            check(torch.equal(w0a[key], w0b[key]), f"(c) {label} {key}: different initial weights")
            torch.testing.assert_close(wb[key], wa[key], **LOWER_TOL,
                                       msg=lambda m: f"(c) {label} {key}: {m}")
            worst = max(worst, (wb[key] - wa[key]).abs().max().item())
            upd = rel_diff(wb[key] - w0b[key], wa[key] - w0a[key])
            check(upd <= LOWER_MOVE_RTOL["update"],
                  f"(c) {label} {key}: the update differs by {upd:.3e} of its norm")
            worst_u = max(worst_u, upd)
        counts = {k: v for k, v in ma.items() if k != "loss" and not k.endswith("_loss")}
        check(counts == {k: mb[k] for k in counts}, f"(c) {label}: eval counts {ma} vs {mb}")
        check(abs(mb["loss"] - ma["loss"]) <= LOWER_EVAL_RTOL * abs(ma["loss"]),
              f"(c) {label}: eval loss {mb['loss']} vs {ma['loss']}")
        if is_lm:
            check(np.array_equal(ga, gb), f"(c) {label}: generate differs")
        want = ({"train_step": 1, "eval_step": 1, "decode_step": 1} if is_lm
                else {"train_step": 1, "eval_step": 1})
        check(graphs == want, f"(c) {label}: graphs {graphs}, expected {want}")
        times = {False: [], True: [], "host_False": [], "host_True": []}
        torch.backends.cudnn.deterministic = False
        models = {lowered: make(lowered, "bfloat16") for lowered in (False, True)}
        for lowered in (False, True):
            models[lowered].train_iteration()  # the lowered one compiles
            models[lowered].sync()
        for lowered in (False, True, True, False):
            m = models[lowered]
            t0 = time.perf_counter()
            for _ in range(5):
                m.train_iteration()
            host = (time.perf_counter() - t0) / 5 * 1e3
            m.sync()
            times[lowered].append((time.perf_counter() - t0) / 5 * 1e3)
            times[f"host_{lowered}"].append(host)
        del models
        free_models()
        torch.backends.cudnn.deterministic = True
        if lead:
            log(f"[lower] (c) {label} on {world} cards, f32 {LOWER_STEPS} steps lowered vs "
                f"per-op (eager mesh): max |dw| {worst:.3e} (rtol {LOWER_TOL['rtol']:g}, atol "
                f"{LOWER_TOL['atol']:g}); per leaf ||update lowered - per-op|| / ||per-op|| max "
                f"{worst_u:.3e} (limit {LOWER_MOVE_RTOL['update']:g}); eval_batch {mb} vs {ma}"
                + (f"; greedy generate P{LOWER_GEN['P']} N{LOWER_GEN['N']} equal" if is_lm
                   else "") + f"; graphs {graphs}, 0 breaks (fullgraph)")
            log(f"[lower] (c) {label} bf16 ms/step in turns per-op "
                f"{' / '.join(f'{x:.2f}' for x in times[False])}, lowered "
                f"{' / '.join(f'{x:.2f}' for x in times[True])}; host ms a step (to the "
                f"last enqueue) per-op {' / '.join(f'{x:.2f}' for x in times['host_False'])}, "
                f"lowered {' / '.join(f'{x:.2f}' for x in times['host_True'])}")
    return launches


def lower_multi_phase(ft, kernels, smi):
    """(c): with one visible card it says so and runs nothing; with more, an
    NCCL group of one rank per card (up to 4; this script started again as
    the helper ranks) runs ``lower_multi_runs``."""
    from flexflow_tpu_torch.parallel import distributed as dist

    world = min(4, torch.cuda.device_count())
    if world < 2:
        log(f"[lower] (c) needs more than one card ({torch.cuda.device_count()} visible): the "
            "lowered mesh steps were not run")
        return dict.fromkeys(kernels, 0)
    port = free_port()
    helpers = spawn_helpers(LOWER_HELPER, world, port)
    try:
        dev = dist.initialize("cuda", init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=0, local_rank=0, timeout=SOAP_TIMEOUT)
        launches = lower_multi_runs(ft, kernels, dev, lead=True)
        dist.shutdown()
        for r, p in enumerate(helpers, 1):
            check(p.wait(timeout=600) == 0, f"(c) helper rank {r} exited {p.returncode}")
    finally:
        for p in helpers:
            if p.poll() is None:
                p.kill()
    log(f"[lower] (c) launches on the lead rank: {launches}; card {smi}")
    return launches


def lower_helper():
    """A helper rank of phase 21 (c)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.parallel import distributed as dist

    dev = dist.initialize("cuda", timeout=SOAP_TIMEOUT)
    lower_multi_runs(ft, kernel_wrappers(fo, fa), dev, lead=False)
    dist.shutdown()
    return 0


def lower_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, kernels, smi):
    """Phase 21: (a) the lowered step on one card against the captured
    per-op step, (b) the knobs, (c) on several cards when there are.
    Returns the launches of its paths."""
    t0 = time.perf_counter()
    reset_launches(kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    for label, make, per_step, samples, tokens, f32_cfg in lower_cells(
            ft, build_alexnet, build_transformer, synthetic_lm_batch):
        lower_one_card(label, make, per_step, samples, tokens, f32_cfg, smi)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    launches = read_launches(kernels)
    lower_knobs(ft, smi)
    multi = lower_multi_phase(ft, kernels, smi)
    launches = {n: launches[n] + multi[n] for n in launches}
    log(f"[lower] phase 21 {time.perf_counter() - t0:.1f} s; launches {launches}; card {smi}")
    return launches


# ------------------------------------------------------------------ phase 22

FRONT_STEPS = 5          # (a): compiled bf16 steps of each AlexNet graph, v2 and plain
# (a): the runner's command line, examples/native/alexnet_new.py's flags
FRONT_RUNNER_ARGS = ("-ll:gpu", "1", "-ll:fsize", "14000", "-b", str(BATCH))
FRONT_RUNNER_TIMEOUT_S = 300
# (b): examples/keras/func_cifar10_alexnet.py at its widths: 512 samples,
# batch 64, SGD lr 0.02 halved at epoch 1, f32; fit against train_iteration
FRONT_KERAS = dict(samples=512, batch=64, epochs=2, lr=0.02)
FRONT_KERAS_TOL = dict(rtol=1e-4, atol=1e-5)
FRONT_MLP = dict(samples=512, batch=64, alpha=0.001)   # (c): seq_mnist_mlp, keras Adam
FRONT_TORCH = dict(batch=16, steps=3)                  # (d): tests/test_frontends.py's CNN
# (a)'s script: the runner runs it as __main__; chip_smoke.py is importable
# beside it (PYTHONPATH), and front_v2_run does the work
FRONT_V2_SCRIPT = """\
import chip_smoke
chip_smoke.front_v2_run()
"""


def v2_alexnet(ft, model, batch, plain=False):
    """examples/native/alexnet_new.py:24-62's graph (a 229x229 input, two
    11x11 stems concatenated, linear1 9216 -> 4096, linear2 4096 -> 4096,
    10 classes): its layers declared with the v2 builders and wired with
    init_inout, or with ``plain`` built by the plain calls; returns the
    input tensor."""
    relu = ft.ActiMode.RELU
    inp = model.create_tensor((batch, 3, 229, 229), name="input")
    if plain:
        t1 = model.conv2d(inp, 32, 11, 11, 4, 4, 2, 2, activation=relu, name="conv1_1")
        t2 = model.conv2d(inp, 32, 11, 11, 4, 4, 2, 2, activation=relu, name="conv1_2")
        t = model.concat([t1, t2], 1, name="concat")
        t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool1")
        t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation=relu, name="conv2")
        t = model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool2")
        t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation=relu, name="conv3")
        t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=relu, name="conv4")
        t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=relu, name="conv5")
        t = model.flat(model.pool2d(t, 3, 3, 2, 2, 0, 0, name="pool3"), name="flat")
        t = model.dense(t, 4096, activation=relu, name="linear1")
        t = model.dense(t, 4096, activation=relu, name="linear2")
        model.softmax(model.dense(t, 10, name="linear3"), name="softmax")
        return inp
    conv1_1 = model.conv2d_v2("conv1_1", 3, 32, 11, 11, 4, 4, 2, 2, activation=relu)
    conv1_2 = model.conv2d_v2("conv1_2", 3, 32, 11, 11, 4, 4, 2, 2, activation=relu)
    rest = [model.pool2d_v2("pool1", 3, 3, 2, 2, 0, 0),
            model.conv2d_v2("conv2", 64, 192, 5, 5, 1, 1, 2, 2, activation=relu),
            model.pool2d_v2("pool2", 3, 3, 2, 2, 0, 0),
            model.conv2d_v2("conv3", 192, 384, 3, 3, 1, 1, 1, 1, activation=relu),
            model.conv2d_v2("conv4", 384, 256, 3, 3, 1, 1, 1, 1, activation=relu),
            model.conv2d_v2("conv5", 256, 256, 3, 3, 1, 1, 1, 1, activation=relu),
            model.pool2d_v2("pool3", 3, 3, 2, 2, 0, 0),
            model.flat_v2("flat"),
            model.dense_v2("linear1", 256 * 6 * 6, 4096, activation=relu),
            model.dense_v2("linear2", 4096, 4096, activation=relu),
            model.dense_v2("linear3", 4096, 10)]
    t = model.concat([conv1_1.init_inout(model, inp), conv1_2.init_inout(model, inp)], 1,
                     name="concat")
    for layer in rest:
        t = layer.init_inout(model, t)
    model.softmax(t, name="softmax")
    return inp


def front_v2_run():
    """(a) in the process ``python -m flexflow_tpu_torch`` started: the v2
    AlexNet and the plain one, each FRONT_STEPS compiled bf16 steps from
    one seed on the runner's flags (parse_args(None)); writes what it saw
    to the ``--out`` file."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo

    out = sys.argv[sys.argv.index("--out") + 1]
    cfg = ft.FFConfig(compute_dtype="bfloat16", fused_optimizer=True)
    rest = cfg.parse_args(None)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    kernels = kernel_wrappers(fo, fa)
    runs = {}
    for plain in (False, True):
        before = read_launches(kernels)
        model = ft.FFModel(cfg)
        inp = v2_alexnet(ft, model, cfg.batch_size, plain=plain)
        model.compile(sgd_optimizer(ft)(model), ft.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                      [ft.MetricsType.ACCURACY])
        model.init_layers(seed=0)
        stage_synthetic(ft, model, inp, cfg.batch_size)
        with kernel_nodes_kept(model), ExactLaunches(model) as exact:
            ms, losses = steps_ms(model, steps=FRONT_STEPS, timed_from=2)
        check_graph_run(model, FRONT_STEPS, f"(a) AlexNet {'plain' if plain else 'v2'}")
        runs[plain] = dict(ms=ms, losses=losses, exact=exact.counts, device=str(model.device),
                           ops=[(op.name, op._type, list(op.output.dims)) for op in model.ops],
                           state=state_of(model),
                           wrappers={k: v - before[k] for k, v in read_launches(kernels).items()})
        del model
        free_models()
    v2, plain = runs[False], runs[True]
    same_state = all(torch.equal(v2["state"][k], plain["state"][k]) for k in plain["state"])
    leaves = len(plain["state"])
    del v2["state"], plain["state"]
    with open(out, "w") as f:
        json.dump({"argv": sys.argv[1:], "rest": rest, "batch": cfg.batch_size,
                   "workers": cfg.workers_per_node, "same_state": same_state,
                   "leaves": leaves,
                   "v2": v2, "plain": plain}, f)


def front_v2(smi, tmp):
    """(a): the v2 AlexNet at full width through ``python -m
    flexflow_tpu_torch script.py -ll:gpu 1 -ll:fsize 14000 -b 256``.
    Returns the wrappers' launches in that process."""
    root = os.path.dirname(os.path.abspath(__file__))
    script, out = os.path.join(tmp, "alexnet_v2.py"), os.path.join(tmp, "alexnet_v2.json")
    with open(script, "w") as f:
        f.write(FRONT_V2_SCRIPT)
    cmd = [sys.executable, "-m", "flexflow_tpu_torch", script, *FRONT_RUNNER_ARGS, "--out", out]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                       timeout=FRONT_RUNNER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"(a) the runner exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    for line in r.stdout.splitlines():
        log(line)  # the runner's process's own lines
    with open(out) as f:
        res = json.load(f)
    v2, plain = res["v2"], res["plain"]
    check(not any(a.startswith(("-ll:", "-lg:")) for a in res["argv"]),
          f"(a) the script's argv {res['argv']} holds a Legion flag")
    check(res["rest"] == ["--out", out], f"(a) parse_args(None) left {res['rest']}")
    check(res["batch"] == BATCH and res["workers"] == 1,
          f"(a) parse_args(None) saw batch {res['batch']}, -ll:gpu {res['workers']}")
    check(v2["ops"] == plain["ops"], "(a) the v2 graph is not the plain calls' graph")
    check(dict(zip((o[0] for o in v2["ops"]), (o[2] for o in v2["ops"])))["flat"] ==
          [BATCH, 9216], "(a) linear1's input is not 9216 wide")
    check(v2["losses"] == plain["losses"] and res["same_state"],
          f"(a) v2 and plain differ: losses {v2['losses']} vs {plain['losses']}, weights and "
          f"momentum bitwise {res['same_state']}")
    want = {**NO_LAUNCH, "fused_sgd_update": FRONT_STEPS}
    check(v2["exact"] == want and plain["exact"] == want,
          f"(a) launches over {FRONT_STEPS} steps, exact: v2 {v2['exact']}, plain "
          f"{plain['exact']}, expected {want}")
    check(v2["device"].startswith("cuda"), f"(a) the model ran on {v2['device']}")
    log(f"[front] (a) python -m flexflow_tpu_torch {os.path.basename(script)} "
        f"{' '.join(FRONT_RUNNER_ARGS)}: the script's argv {res['argv'][:2]} (no -ll: flag), "
        f"parse_args(None) batch {res['batch']}, -ll:gpu {res['workers']}; "
        f"examples/native/alexnet_new.py's graph through conv2d_v2/pool2d_v2/dense_v2/flat_v2 "
        f"+ init_inout, {len(v2['ops'])} ops, bf16, fused SGD momentum 0.9: {FRONT_STEPS} "
        f"compiled steps' losses {['%.5f' % x for x in v2['losses']]} and {res['leaves']} "
        f"weight and momentum leaves bitwise equal to the plain calls' graph from the same "
        f"seed; ms/step (3 replays, cuDNN deterministic for that gate) v2 {v2['ms']:.3f} "
        f"({BATCH * 1e3 / v2['ms']:.0f} samples/s), plain {plain['ms']:.3f}; launches over the {FRONT_STEPS} steps, "
        f"exact, { {k: c for k, c in v2['exact'].items() if c} } (K1 1 a step); the "
        f"runner's process {wall:.1f} s; card {smi}")
    return {k: v2["wrappers"][k] + plain["wrappers"][k] for k in v2["wrappers"]}


def front_keras_alexnet(ft, smi):
    """(b): examples/keras/func_cifar10_alexnet.py at its widths, f32, fit
    over 2 epochs of 512 synthetic CIFAR-10 samples with a
    LearningRateScheduler halving lr at epoch 1, against the same graph
    from the same weights driven eagerly through train_iteration with lr
    set on its optimizer; then evaluate and predict."""
    from flexflow_tpu_torch import keras as K
    from flexflow_tpu_torch.keras.datasets import cifar10

    c = FRONT_KERAS
    (x, y), _ = cifar10.load_data()
    x, y = x[:c["samples"]].astype(np.float32) / 255.0, y[:c["samples"]].astype(np.int32)

    def build():
        inp = K.Input(shape=(3, 32, 32))
        h = K.Conv2D(64, (5, 5), strides=(1, 1), activation="relu", padding="same",
                     name="conv1")(inp)
        h = K.MaxPooling2D((2, 2), name="pool1")(h)
        h = K.Conv2D(192, (3, 3), activation="relu", padding="same", name="conv2")(h)
        h = K.MaxPooling2D((2, 2), name="pool2")(h)
        h = K.Conv2D(256, (3, 3), activation="relu", padding="same", name="conv3")(h)
        h = K.Flatten(name="flat")(K.MaxPooling2D((2, 2), name="pool3")(h))
        h = K.Dense(512, activation="relu", name="fc6")(h)
        h = K.Dense(512, activation="relu", name="fc7")(h)
        out = K.Dense(10, activation="softmax", name="fc8")(h)
        model = K.Model(inputs=[inp], outputs=out,
                        config=ft.FFConfig(batch_size=c["batch"], fused_optimizer=True))
        model.compile(K.optimizers.SGD(lr=c["lr"]), "sparse_categorical_crossentropy",
                      ["accuracy"])
        return model

    def schedule(epoch):
        return c["lr"] * 0.5 ** epoch

    model, ref = build(), build()
    check(model.ffmodel.device.type == "cuda", f"(b) keras ran on {model.ffmodel.device}")
    for a, b in zip(model.layers, ref.layers):
        b.set_weights(ref.ffmodel, *a.get_weights(model.ffmodel))
    steps = c["epochs"] * (c["samples"] // c["batch"])
    t0 = time.perf_counter()
    with kernel_nodes_kept(model.ffmodel), ExactLaunches(model.ffmodel) as exact:
        model.fit(x, y, epochs=c["epochs"], verbose=False,
                  callbacks=[K.LearningRateScheduler(schedule)])
        model.ffmodel.sync()
    fit_s, counts = time.perf_counter() - t0, exact.counts
    check_graph_run(model.ffmodel, steps, "(b) keras fit")
    graph = (model.ffmodel._step_graph.captures, model.ffmodel._step_graph.replays)
    check(counts == {**NO_LAUNCH, "fused_sgd_update": steps},
          f"(b) launches over {steps} fit steps, exact, {counts}: expected K1 1 a step")
    vec = model.ffmodel.optimizer.scalars(model.ffmodel.device)
    check(float(vec[0]) == np.float32(schedule(c["epochs"] - 1)),
          f"(b) the step's device lr {float(vec[0])}, scheduled {schedule(c['epochs'] - 1)}")
    # the reference: the same batches, eagerly, lr set on the core optimizer
    ff = ref.ffmodel
    dl = ft.DataLoader(ff, {ref._core_inputs[0]: x}, y)
    with ft.disable_graphs():
        for epoch in range(c["epochs"]):
            dl.reset()
            ff.reset_metrics()
            ff.optimizer.next_epoch()
            ff.optimizer.lr = schedule(epoch)
            for _ in range(dl.num_batches()):
                dl.next_batch(ff)
                ff.train_iteration()
            ff.get_metrics()
    dl.close()
    check(ff._step_graph is None or ff._step_graph.captures == 0, "(b) the reference captured")
    worst = 0.0
    for a, b in zip(model.layers, ref.layers):
        for wa, wb in zip(a.get_weights(model.ffmodel), b.get_weights(ff)):
            np.testing.assert_allclose(wa, wb, **FRONT_KERAS_TOL,
                                       err_msg=f"(b) {a.name}: fit vs train_iteration")
            worst = max(worst, float(np.abs(wa - wb).max()))
    logs = model.evaluate(x, y)
    probs = model.predict(x.transpose(0, 2, 3, 1))  # predict takes NHWC, as the JAX package's
    check(probs.shape == (c["samples"], 10) and np.allclose(probs.sum(1), 1.0, atol=1e-4),
          f"(b) predict gave {probs.shape}")
    acc = float((probs.argmax(1) == y[:, 0]).mean())
    check(acc == logs["accuracy"], f"(b) predict's accuracy {acc} vs evaluate's {logs}")
    ms, _ = steps_ms(model.ffmodel)
    log(f"[front] (b) keras func_cifar10_alexnet (convs 64/192/256, Dense 512/512/10), f32, "
        f"batch {c['batch']}, SGD lr {c['lr']} halved at epoch 1 by LearningRateScheduler: "
        f"Model.fit {c['epochs']} epochs x {c['samples'] // c['batch']} steps in "
        f"{fit_s:.2f} s (compiled: {graph[0]} capture, {graph[1]} replays), the step's "
        f"device lr after it "
        f"{float(vec[0]):g}; every weight against the same graph and weights driven eagerly "
        f"through train_iteration with the same schedule: max |dw| {worst:.3e} (rtol "
        f"{FRONT_KERAS_TOL['rtol']:g}, atol {FRONT_KERAS_TOL['atol']:g}); launches over the "
        f"fit, exact, { {k: v for k, v in counts.items() if v} } (K1 1 a step); evaluate "
        f"accuracy {logs['accuracy']:.4f}, predict {probs.shape} with the same accuracy; "
        f"ms/step {ms:.3f} "
        f"({c['batch'] * 1e3 / ms:.0f} samples/s); card {smi}")


def front_keras_adam(ft, smi):
    """(c): examples/keras/seq_mnist_mlp.py's Sequential (784 -> 512 -> 512
    -> 10, batch 64) with keras Adam: K2 one launch a leaf a step."""
    from flexflow_tpu_torch import keras as K
    from flexflow_tpu_torch.keras.datasets import mnist

    c = FRONT_MLP
    (x, y), _ = mnist.load_data()
    x = x[:c["samples"]].reshape(-1, 784).astype(np.float32) / 255.0
    y = y[:c["samples"]].astype(np.int32)
    model = K.Sequential(config=ft.FFConfig(batch_size=c["batch"], fused_optimizer=True))
    model.add(K.Input(shape=(784,)))
    model.add(K.Dense(512, activation="relu", name="dense1"))
    model.add(K.Dense(512, activation="relu", name="dense2"))
    model.add(K.Dense(10, activation="softmax", name="dense3"))
    model.compile(K.optimizers.Adam(lr=c["alpha"]), "sparse_categorical_crossentropy",
                  ["accuracy"])
    leaves = sum(len(op.weights) for op in model.ffmodel.ops)
    steps = c["samples"] // c["batch"]
    with kernel_nodes_kept(model.ffmodel), ExactLaunches(model.ffmodel) as exact:
        model.fit(x, y, epochs=1, verbose=False)
        model.ffmodel.sync()
    counts = exact.counts
    check_graph_run(model.ffmodel, steps, "(c) keras Adam fit")
    check(leaves == 6 and counts == {**NO_LAUNCH, "fused_adam_update": leaves * steps},
          f"(c) launches over {steps} steps, exact, {counts}: expected K2 {leaves} a step")
    logs = model.evaluate(x, y)
    check(math.isfinite(logs["sparse_categorical_crossentropy"]), f"(c) evaluate {logs}")
    ms, _ = steps_ms(model.ffmodel)
    log(f"[front] (c) keras Sequential seq_mnist_mlp 784-512-512-10 batch {c['batch']}, f32, "
        f"keras Adam lr {c['alpha']}: fit 1 epoch of {steps} compiled steps, launches exact "
        f"{ {k: v for k, v in counts.items() if v} } (K2 {leaves} a step, one a leaf); "
        f"evaluate accuracy {logs['accuracy']:.4f}; ms/step {ms:.3f}; card {smi}")


def front_torch(ft, smi):
    """(d): torch_frontend.nn builds tests/test_frontends.py's CNN (conv1 3 ->
    8, ReLU, MaxPool2d 2, Flatten, fc1 512 -> 10, Softmax) and takes 3
    compiled steps on the card."""
    from flexflow_tpu_torch.torch_frontend import nn

    class CNN(nn.Module):
        def __init__(self):
            self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
            self.relu1 = nn.ReLU()
            self.pool1 = nn.MaxPool2d(2)
            self.flat = nn.Flatten()
            self.fc1 = nn.Linear(8 * 8 * 8, 10)
            self.sm = nn.Softmax()

        def forward(self, x):
            return self.sm(self.fc1(self.flat(self.pool1(self.relu1(self.conv1(x))))))

    c = FRONT_TORCH
    net = CNN()
    model = net.build((c["batch"], 3, 16, 16),
                      ft.FFConfig(batch_size=c["batch"], fused_optimizer=True))
    names = [op.name for op in model.ops]
    check(names[:2] == ["conv1", "relu1"] and "fc1" in names and model.device.type == "cuda",
          f"(d) ops {names} on {model.device}")
    model.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", ["accuracy"])
    model.init_layers(seed=0)
    dl = ft.DataLoader.synthetic(model, net._input_tensor, num_samples=c["batch"])
    with kernel_nodes_kept(model), ExactLaunches(model) as exact:
        for _ in range(c["steps"]):
            dl.next_batch(model)
            model.train_iteration()
        model.sync()
    dl.close()
    counts = exact.counts
    check_graph_run(model, c["steps"], "(d) torch frontend")
    check(counts == {**NO_LAUNCH, "fused_sgd_update": c["steps"]},
          f"(d) launches over {c['steps']} steps, exact, {counts}")
    pm = model.get_metrics()
    check(pm.train_all == c["steps"] * c["batch"] and math.isfinite(model.last_loss),
          f"(d) metrics {pm.to_string()}, loss {model.last_loss}")
    log(f"[front] (d) torch_frontend.nn CNN {names}: {c['steps']} compiled steps at batch "
        f"{c['batch']}, loss {model.last_loss:.5f}, launches exact "
        f"{ {k: v for k, v in counts.items() if v} }; card {smi}")


def frontends_phase(ft, kernels, smi):
    """Phase 22: the frontends on the card.  Returns the launches of its
    paths (the runner's process's included)."""
    t0 = time.perf_counter()
    free_models()
    reset_launches(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        runner = front_v2(smi, tmp)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    front_keras_alexnet(ft, smi)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    front_keras_adam(ft, smi)
    front_torch(ft, smi)
    free_models()
    launches = {k: v + runner[k] for k, v in read_launches(kernels).items()}
    log(f"[front] phase 22 {time.perf_counter() - t0:.1f} s; launches (wrappers, the "
        f"runner's process's included) {launches}; card {smi}")
    return launches


PHASES = tuple(range(1, 23))


def selected_phases(argv):
    """``--phases 3,17``: the phases to run (default every one).  Phases 1
    and 2 (the environment and the kernels' build) always run; phase 16
    reads phase 3's leaf shapes, which are recomputed when phase 3 is not
    selected; the kernels line is printed when phase 3 ran."""
    if "--phases" not in argv:
        return set(PHASES)
    picked = {int(x) for x in argv[argv.index("--phases") + 1].split(",") if x}
    bad = picked - set(PHASES)
    if bad:
        raise SystemExit(f"chip_smoke: no phase {sorted(bad)} (phases {PHASES[0]}-{PHASES[-1]})")
    return picked | {1, 2}


def main(argv=None):
    faulthandler.enable()  # a crash in a native library prints the Python stack
    argv = sys.argv[1:] if argv is None else argv
    # --calibration-out DIR keeps phase 8's measured cache and fit (else a
    # temporary directory holds them)
    calibration_out = argv[argv.index("--calibration-out") + 1] \
        if "--calibration-out" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if os.environ.get(SOAP_HELPER):
        return soap_helper()
    phases = selected_phases(argv)
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import fused_optimizer as fo
    from flexflow_tpu_torch.models.alexnet import build_alexnet
    from flexflow_tpu_torch.models.transformer import build_transformer, synthetic_lm_batch

    kernels = kernel_wrappers(fo, fa)
    t_start = time.perf_counter()
    ran = {}  # phase -> the kernels' launches on its paths
    # phase 1 ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {name} capability {cap} count "
        f"{torch.cuda.device_count()}; phases {sorted(phases)}")
    log(f"[env] nvidia-smi: {smi}")
    check(cap == (9, 0), f"expected a Hopper card (capability (9, 0)), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    # phase 2 ------------------------------------------------------------
    build_kernels(fo, fa)

    # phase 3 ------------------------------------------------------------
    leaf_sets = (main_path_leaves(ft, build_alexnet, build_transformer)
                 if phases & {3, 16} else None)
    if 3 in phases:
        log("[kernels] kernel vs plain PyTorch version, tolerance rtol=atol=1e-6 "
            "(both run the same rounded f32 operations; built with -fmad=false)")
        max_err = check_kernels(fo)
        max_err["fused_sgd_update"] = max(max_err["fused_sgd_update"], check_sgd_multi(fo))
        copy_gbps = copy_bandwidth_gbps()
        log(f"[kernels] measured device copy rate {copy_gbps:.1f} GB/s (1 GiB copy_)")
        rows = time_kernels(fo, leaf_sets, copy_gbps)
        launch_diagnostics(fo, {name: len(shapes) for name, shapes in leaf_sets.items()},
                           max(math.prod(s) for s in leaf_sets["AlexNet"]))
        log("[kernels] flash kernels vs plain PyTorch versions on the same inputs, "
            "tolerance f32 rtol=atol=1e-4 (summation order), bf16 rtol=2**-7 atol=1e-3 "
            "(one bf16 rounding of f32 results; lse f32)")
        max_err.update(check_flash(fa))
        flash_rows = time_flash(fa)
        time_flash(fa, head_dim=16)

    # phase 4 ------------------------------------------------------------
    if 4 in phases:
        reset_launches(kernels)
        free_models()
        torch.cuda.reset_peak_memory_stats()
        sgd_run = train_main_path(ft, build_alexnet, fo, sgd_optimizer(ft), steps=7,
                                  timed_from=2)
        torch.cuda.empty_cache()
        adam_run = train_main_path(ft, build_alexnet, fo, adam_optimizer(ft), steps=5,
                                   timed_from=2)
        alex_launches = read_launches(kernels)
        # the eager first step and the capture call the wrappers; replays do not
        check(alex_launches == {"fused_sgd_update": 2, "fused_adam_update": 16 * 2,
                                "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0},
              f"AlexNet launch counts {alex_launches}")
        peak = torch.cuda.max_memory_allocated()
        for label, r in (("SGD momentum 0.9", sgd_run), ("Adam", adam_run)):
            log(f"[main] AlexNet 3x229x229 batch {BATCH} bf16 fused, {label}: "
                f"losses {['%.4f' % x for x in r['losses']]}  "
                f"{r['samples_per_s']:.1f} samples/s  {r['ms_per_step']:.2f} ms/step  "
                f"{r['metrics']}")
        MEASURED["alexnet"]["peak_gib"] = peak / 2**30
        log(f"[main] max_memory_allocated {peak / 2**30:.2f} GiB; launches {alex_launches}; "
            f"card {smi}")
        profile_steps(main_model(ft, build_alexnet, sgd_optimizer(ft)), "AlexNet SGD",
                      sgd_run["ms_per_step"], per_step=ALEX_SGD_STEP)
        torch.cuda.empty_cache()

        reset_launches(kernels)
        free_models()
        torch.cuda.reset_peak_memory_stats()
        lm, lm_run = train_transformer(ft, build_transformer, synthetic_lm_batch, kernels)
        lm_launches = read_launches(kernels)
        per_layer = 2 * LM["num_layers"]  # the eager first step and the capture
        # predict_batch's forward adds one flash_fwd launch per layer
        check(lm_launches == {"fused_sgd_update": 2, "fused_adam_update": 0,
                              "flash_fwd": per_layer + LM["num_layers"],
                              "flash_bwd_dkdv": per_layer, "flash_bwd_dq": per_layer},
              f"transformer launch counts {lm_launches}")
        peak = torch.cuda.max_memory_allocated()
        log(f"[main] transformer batch {LM['batch']} S {LM['seq_length']} {LM['num_layers']}x"
            f"{LM['embed_dim']} {LM['num_heads']} heads vocab {LM['vocab_size']} bf16 fused "
            f"SGD lr 0.001: losses {['%.5f' % x for x in lm_run['losses']]}  "
            f"{lm_run['samples_per_s']:.2f} samples/s  {lm_run['tokens_per_s']:.0f} tokens/s  "
            f"{lm_run['ms_per_step']:.2f} ms/step  {lm_run['metrics']}")
        MEASURED["transformer"]["peak_gib"] = peak / 2**30
        log(f"[main] transformer max_memory_allocated {peak / 2**30:.2f} GiB; launches "
            f"{lm_launches}; card {smi}")
        profile_steps(lm, "transformer SGD", lm_run["ms_per_step"], per_step=LM_SGD_STEP)
        del lm
        torch.cuda.empty_cache()
        ran["AlexNet"] = alex_launches
        ran["transformer"] = lm_launches

    # phase 5 ------------------------------------------------------------
    if 5 in phases:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for label, make_opt in (("SGD", sgd_optimizer(ft)), ("Adam", adam_optimizer(ft))):
            worst = parity(ft, build_alexnet, make_opt)
            log(f"[parity] f32 AlexNet batch 8, 2 {label} steps, fused kernels vs plain "
                f"update: max |dw| {worst:.3e} (tolerance rtol 1e-6, atol 1e-7; cuDNN "
                "deterministic, TF32 off)")
        worst = lm_parity(ft, build_transformer, synthetic_lm_batch, fa, kernels)
        log(f"[parity] f32 transformer batch 2 S 128 2x128 2 heads, 2 SGD steps, flash "
            f"kernels vs plain versions: max |dw| {worst:.3e} (tolerance rtol 1e-4, atol "
            "1e-5; TF32 off)")

    # phase 6 ------------------------------------------------------------
    if 6 in phases:
        ran["SOAP"] = soap_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch,
                                 kernels, smi)

    # phase 7 ------------------------------------------------------------
    if 7 in phases:
        compiled_step_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch, smi)

    # phase 8 ------------------------------------------------------------
    with contextlib.ExitStack() as stack:
        out_dir = calibration_out or stack.enter_context(tempfile.TemporaryDirectory())
        if 8 in phases:
            ran["search"] = search_phase(ft, build_alexnet, kernels, smi, out_dir)

        # phase 9 ----------------------------------------------------------
        if 9 in phases:
            ran["models"] = models_phase(ft, fo, fa, kernels, smi, out_dir)

    # phase 10 -----------------------------------------------------------
    wants = None
    if 10 in phases:
        ran["serving"], wants = serving_phase(ft, kernels, smi)

    # phase 11 -----------------------------------------------------------
    if 11 in phases:
        ran["observability"] = observability_phase(ft, build_alexnet, build_transformer,
                                                    synthetic_lm_batch, kernels, smi)

    # phase 12 -----------------------------------------------------------
    if 12 in phases:
        ran["pool"] = pool_phase(ft, kernels, smi, known=wants)

    # phase 13 -----------------------------------------------------------
    if 13 in phases:
        ran["sequence"], _, _ = sequence_phase(ft, fa, kernels, smi)

    # phase 14 -----------------------------------------------------------
    if 14 in phases:
        ran["elastic"] = elastic_phase(ft, build_alexnet, kernels, smi)

    # phase 15 -----------------------------------------------------------
    if 15 in phases:
        ran["pipelines and host tables"] = pipeline_phase(ft, kernels, smi)

    # phase 16 -----------------------------------------------------------
    if 16 in phases:
        ran["SOAP space"] = soap_space_phase(ft, fo, kernels, smi, leaf_sets["AlexNet"])

    # phase 17 -----------------------------------------------------------
    if 17 in phases:
        ran["mesh decode"] = mesh_decode_phase(ft, kernels, smi)

    # phase 18 -----------------------------------------------------------
    if 18 in phases:
        ran["slices"] = slice_pool_phase(ft, kernels, smi)

    # phase 19 -----------------------------------------------------------
    if 19 in phases:
        ran["native"] = native_phase(ft, build_alexnet, kernels, smi)

    # phase 20 -----------------------------------------------------------
    if 20 in phases:
        ran["tools"] = tools_phase(ft, kernels, smi)

    # phase 21 -----------------------------------------------------------
    if 21 in phases:
        ran["lowering"] = lower_phase(ft, build_alexnet, build_transformer, synthetic_lm_batch,
                                      kernels, smi)

    # phase 22 -----------------------------------------------------------
    if 22 in phases:
        ran["frontends"] = frontends_phase(ft, kernels, smi)

    # result -------------------------------------------------------------
    main_launches = {n: sum(r[n] for r in ran.values()) for n in kernels}
    log(f"[done] {time.perf_counter() - t_start:.1f} s; launches on the main paths: "
        + ", ".join(f"{label} {r}" for label, r in ran.items()))
    log(smi)
    if 3 in phases:
        table = []
        for kname, source, replaces in (
                ("fused_sgd_update", SOURCE, "flexflow_tpu/kernels/fused_optimizer.py:63"),
                ("fused_adam_update", SOURCE, "flexflow_tpu/kernels/fused_optimizer.py:110"),
                ("flash_fwd", FLASH_SOURCE, "flexflow_tpu/kernels/flash_attention.py:53"),
                ("flash_bwd_dkdv", FLASH_SOURCE,
                 "flexflow_tpu/kernels/flash_attention.py:145"),
                ("flash_bwd_dq", FLASH_SOURCE, "flexflow_tpu/kernels/flash_attention.py:195")):
            r = flash_rows.get(kname) or dict(
                rows["fused_sgd_update mu=0.9" if kname == "fused_sgd_update" else kname],
                bound_by="bytes")
            table.append({"name": kname, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": main_launches[kname],
                          "max_abs_err": max_err[kname], "ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        log(json.dumps({"kernels": table}))
    else:
        log("[done] phase 3 was not selected: no kernels line")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
