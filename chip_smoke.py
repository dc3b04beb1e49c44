#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (omldm_tpu_torch) on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--records N] [--parity-records N]
                          [--lm-steps N] [--profile DIR] [--sequence-only]
                          [--kafka-only] [--fleet-only] [--selfheal-only]

Phases (any failure raises and the script exits nonzero without a result):
  1. setup       card name and power limit, torch/CUDA versions, TF32 off;
  2. build       every kernel source in omldm_tpu_torch/csrc/, one nvcc
                 each, started together (pa_scan.cu, flash_attention.cu,
                 scatter_add.cu); each pa_scan and flash kernel's registers,
                 spills and static shared memory from the -Xptxas -v log
                 (no flash kernel instance may spill). The script waits for
                 flash_attention.cu (about a minute of nvcc) only after the
                 sparse and CLI phases, and runs the flash phases (7-10,
                 43-45) then;
  3. check       pa_scan against its plain PyTorch version on the card, at
                 (B, D+1) in {(1,29), (256,29), (256,1025), (255,4097)},
                 variants PA/PA-I/PA-II, C in {0.01, 0.5}, masks with trailing
                 and scattered zeros, labels in {0,1} and {-1,+1}; then one
                 batch of CHUNKED_CHECK's 28,000 rows, past the kernel's row
                 limit, which the wrapper runs as two chunks;
  4. time        pa_scan at TIME_SHAPES: CUDA events over 1000 back-to-back
                 calls (host work included once it exceeds the kernel), the
                 host's own time a call, the device's busy time a call
                 (torch.profiler, the launches' sum), the device span a call
                 (first launch's start to last launch's end, from the same
                 kind of trace) and a CUDA graph's time a call (events around
                 replays of 100 captured calls: the launches and the gaps
                 between them, no host work), beside its plain version;
  5. slice       StreamJob(parallelism=16, batch 256) on cuda: Create (PA-I,
                 StandardScaler, Asynchronous, perRecord), --records HIGGS-
                 shaped training records (28 features, a planted linear rule
                 plus noise) with every tenth record a forecast, a Query
                 halfway, termination; pa_scan must have launched once per
                 per-record fit;
  6. parity      the first --parity-records records through the port on cuda
                 and on cpu at parallelism 4, batch 256: >= 99% of predictions
                 equal, final parameters within rtol=2e-4, atol=2e-5;
  7. flash-check the flash forward, dQ and dK/dV kernels against their plain
                 twins (run one (b, h) head at a time) on FLASH_CHECKS (among
                 them q, k and v as views into one packed [B, L, 3, H, Dh]
                 projection, L shorter than one tile, dh 64 with ragged L,
                 CTAs with no tile to sweep):
                 out, dq, dk, dv within FLASH_TOL's relative L2 and
                 per-element limits, lse absolute;
  8. flash-time  device time a call (torch.profiler) of each flash kernel,
                 its plain twin and the PyTorch library call
                 (scaled_dot_product_attention, forward and autograd
                 backward) at FLASH_TIME_SHAPES, median of 3 turns, with
                 each kernel's bound, TFLOP/s, share of the bound and ratio
                 to the library call, the dQ + dK/dV pair against the
                 library's backward, and each wrapper's host time a call;
  9. lm          SeqTrainer on cuda at the LM's full width (LM_CONFIG: vocab
                 8192, d 512, 4 heads, 4 layers, d_ff 2048, bf16, loss chunk
                 1024, Adam 1e-3), context 1024, batch 8: one warm-up step,
                 then --lm-steps steps through step_many on a seeded copy-task
                 stream; the loss falls, each flash kernel launched
                 n_layers x steps times; then greedy generate (no kernel);
 10. lm-parity   a small float32 config trained 3 steps on cuda and on cpu
                 from the same numpy parameters: parameters within
                 LM_PARITY_ATOL, greedy tokens equal;
 11. sparse-check the scatter_add kernel against its plain version on the
                 card at (B, K) in SPARSE_CHECKS into D = 13 + 2^18 and the
                 outer entry point at OUTER_CHECK (D = 2^20, C = 2), with
                 uniform, duplicate-heavy (a pool of 64) and Criteo-shaped
                 index draws, masked rows, pad slots and one out-of-range
                 index, each entry point copying (its input left alone) and
                 in place (on a clone, against the plain version in place):
                 every element within scatter_limit; then three fits of a
                 sparse PA-II (13 + 2^18) and a sparse Softmax (2^20)
                 through MLPipeline.fit, which must launch the kernel once a
                 fit and write into the donated weights' memory;
 12. sparse-time the kernel in place and in-place index_add_ at
                 SPARSE_TIME_SHAPES (Criteo, uniform and pool-of-64 draws),
                 as a CUDA graph of 200 calls and as device busy time a call
                 (torch.profiler), median (min-max) of 3 turns; at the stream
                 shapes also the plain version, the copying kernel and
                 torch.index_add; an empty kernel's launch as the floor;
                 the in-place bound (distinct touched rows) and the copying
                 form's;
 13. calibrate   python -m omldm_tpu_torch.ops.sparse_calibrate --smoke on
                 the card into a temporary table: a cuda section with every
                 formulation measured (mxu skipped by its cap);
 14. sparse      StreamJob(parallelism=16, batch 256) on cuda: a sparse
                 Create (PA-II, C 0.1, nFeatures 13 + 2^18, hashSpace 2^18,
                 maxNnz 40, Asynchronous), SPARSE_RECORDS Criteo-shaped
                 records (13 numerics, 26 hashed categoricals, a planted
                 linear rule on the numerics), every tenth a forecast, a
                 Query halfway; the formulation the calibration table picks
                 there is logged (scatterImpl pinned to the kernel if it
                 would launch none); scatter_add launched once per fit,
                 holdout accuracy > 0.6;
 15. sparse-parity the first --parity-records records of phase 14 on cuda
                 and on cpu at parallelism 4, as phase 6;
 16. avazu       AVAZU_RECORDS records of 21 hashed categoricals into
                 2^20 through a sparse Softmax (nClasses 2): the outer entry
                 point launched once per fit.
 17. cli         phase 5's stream as files (the Create, naming its 28
                 features, and the Query in a requests file; every training
                 record and, inline at its position, every forecast marked
                 "operation": "forecasting" in a training file) through
                 python -m omldm_tpu_torch's main() in-process on cuda,
                 --parallelism 16 --batchSize 256 --fastIngest true: the
                 native parser (g++, built into build/omldm_tpu_torch/native/)
                 must have built and taken every block of the training file
                 (fast_ingest.blocks: no block through the Python codec);
                 the Query answered once, before training; pa_scan launched
                 once per per-record fit; one prediction a forecast; holdout
                 accuracy > 0.6; every state tensor on cuda; records/s, p50/
                 p99 forecast latency and programLaunches beside phase 5's;
 18. cli-parity  the first --parity-records records of phase 17's stream (a
                 requests file with the Create alone) through the CLI three
                 ways at parallelism 4, batch 256: the packed route on cuda
                 and on cpu (one row a worker a block, --ingestBatch 4, so
                 each worker takes its rows in the record route's order) and
                 --fastIngest false on cuda; against the packed cuda run:
                 the same predictions in the same order, >= 99% of values
                 equal, final parameters within rtol=2e-4, atol=2e-5;
 19. serving     phase 17's files with --serving maxBatch=64,maxDelayMs=5,
                 staleness=exact: as many predictions as phase 17, each
                 worker's in phase 17's order (the interleaving across
                 workers may move), >= 99% of values equal to phase 17's
                 (the mismatch count is logged), pa_scan once per fit;
                 serving launches (predicts), records/s and p50/p99 beside
                 phase 17's;
 20. cli-sparse  phase 14's Criteo stream as files through the CLI with
                 --serving on: the sparse Create takes the per-record route
                 (no block through the dense parser) and the plane's sparse
                 flush; scatter_add launched once per fit, holdout accuracy
                 > 0.6; records/s beside phase 14's.
 21. learners    StreamJob on cuda, fed as protocol_comparison.py feeds it
                 (blocks of 8,192 packed rows, every tenth a forecast), one
                 run each of LEARNER_RUNS: BASELINE configs 1 (Softmax, lr
                 0.05, StandardScaler, 28 features), 2 (ORR, lambda 1,
                 StandardScaler, 90 features, a regression target) and 4
                 (SVM, lambda 1e-4, rffDim 512, gamma 0.5, 18 features), at
                 parallelism 1 (CentralizedTraining) and batch 4096; the
                 bench job's Softmax under Synchronous at parallelism 16,
                 batch 4096; RegressorPA (perRecord), NN at its defaults,
                 MultiClassPA (3 classes), K-means (k 2) and HT (both
                 forced onto SingleLearner), PA behind MinMaxScaler and
                 behind PolynomialFeatures (28 -> 434 wide) at parallelism
                 16, batch 256: records/s, score
                 (above SCORE_FLOORS), programLaunches; every state tensor
                 on cuda, HT's tree on the host;
 22. protocols   protocol_comparison.py's host section: PA (C 1.0), 28
                 features, parallelism 16, batch 256, testSetSize 64,
                 syncEvery 4, 50,000 records through process_packed_batch,
                 once per protocol (all 8): records/s, score, bytesShipped,
                 modelsShipped, numOfBlocks; then Synchronous with
                 perRecord (pa_scan once per fit) and phase 14's sparse
                 PA-II under Synchronous, 20,000 records (scatter_add once
                 per fit);
 23. protocol-parity the first --parity-records rows of each phase-22
                 protocol run and each phase-21 learner run at parallelism
                 4, batch 256, on cuda and on cpu: integer statistics
                 equal, >= 99% of predictions (the emitted ones and every
                 pipeline's on 512 probe rows) equal (regression values
                 within rtol 1e-3, atol 1e-3), parameters within W_RTOL,
                 W_ATOL (ORR's statistics: within W_RTOL of their largest
                 magnitude, PARITY_SCALED says why).
 24. bench       the bench.py route: run_benchmarks.py's _make_e2e_job
                 (Softmax, lr 0.05, 2 classes, 28 features, Synchronous on
                 the SPMD engine, stageChain 32, parallelism 1, batch 4096)
                 on --bench-records (1,000,000) lines of _gen_stream_file's
                 shape from --seed, written before timing: the overlapped
                 fused route (StreamJob.run_file_fused), the serial fused
                 route and the host alone (the trainer stubbed: t_host,
                 best of 3), each to the trained parameters read back;
                 records/s, the idle share and kernels a stage under
                 torch.profiler; the same file through the CPU: statistics,
                 512 probe predictions equal, parameters within W_RTOL,
                 W_ATOL; the fused route
                 taken (no packed block, every stage from the dispatch
                 thread); a line in bench.py's JSON schema (backend cuda);
 25. spmd        protocol_comparison.py's SPMD section (run_one(engine=
                 "spmd"): PA C 1.0, 28 features, parallelism 16, batch
                 256, syncEvery 4, stageChain 4, 50,000 records, after an
                 untimed warm-up): the 6 protocols' records/s, score,
                 bytesShipped, modelsShipped, numOfBlocks; Synchronous
                 perRecord (pa_scan once a worker a step) and phase 14's
                 sparse PA-II (scatter_add once a step) through the fused
                 COO line loop and the multithreaded block route;
 26. spmd-parity SPMDTrainer on Mesh(8, 2) (8 workers as a leading axis,
                 hub 2) on cuda and on cpu, the 6 protocols x Softmax,
                 perRecord PA and sparse PA-II at Criteo width, 12 steps of
                 the same batches (SSP at staleness 1 refuses some):
                 sync_count, bytes_shipped, collective_bytes_physical,
                 worker_clocks and fitted equal, parameters within W_RTOL,
                 W_ATOL; perRecord PA one batched pa_scan launch a step
                 for the 8 workers (pa_scan_update_batched), scatter_add
                 one; then the bench job's first 20,000 rows on both: 512
                 probe predictions and the statistics equal.
 46. ingest      (run after phase 26, on phase 24's file) the bench job over
                 the bench file's first INGEST_LINES (200,000) lines through
                 the packed route, StreamJob.run_file_sharded at
                 ingest_shards() parsers (cores - 1), the same with
                 device=on and the CLI's --ingest: fitted count, score,
                 parameters and holdout bitwise equal on the first three
                 (the CLI's fitted and score too), no degrade and the
                 resident stage armed on clean runs, a parser SIGKILLed
                 mid-stream degrading with class crash to the same bits;
                 records/s of each route beside the card; the sharded
                 ingest rate with the device stubbed against the single
                 parse's (sharded_vs_single); driver wait, starvation and
                 the device's idle share with device=on under
                 torch.profiler; phase 25's perRecord PA job over the
                 file's first 50,000 lines on the sharded route, pa_scan
                 once a worker a step;
 27. batched-check pa_scan_update_batched (C scans in one launch
                 sequence: member on the grid's y axis, a chain CTA a
                 member) against its plain version at BATCHED_SHAPES
                 (C, B, D+1) = (64, 256, 29), (8, 256, 1025), (3, 255,
                 4097), PA-I and PA-II, and a 5-member call whose member 2
                 has an all-zero mask (it keeps w0 bitwise); BATCHED_GROUPED_
                 CHECK, 96 members at B = 16,384 whose scratch (103 GB)
                 passes the card's memory: launches over member groups,
                 the peak inside the wrapper's budget, every member held
                 to its single scan, two to the plain version; its time as a
                 CUDA graph against C single pa_scan calls as a CUDA graph,
                 device busy time, host time, the plain version, the bound;
 28. multi-tenant MT_RUN: 64 same-spec Creates (PA-I, C 0.01, perRecord,
                 Synchronous, every other one serving-armed) at
                 parallelism 2, dim 28, the first 12,500 of 50,000
                 HIGGS-shaped rows (MT_RUN's main_records) through
                 the packed route, every tenth a forecast, with cohorts
                 auto (vmap; one cohort of 64 a spoke, one batched pa_scan
                 launch a gang step, no solo pa_scan; every forecast
                 answered by every tenant); then the first 5,000 rows
                 with cohorts auto and off (one pa_scan a tenant a fit),
                 held to each other by the JAX package's rule for
                 schedules that differ (each net's forecasts all served,
                 holdout scores within 0.05), and each again
                 under torch.profiler: the device's idle share (busy over
                 the unprofiled run's wall); then those rows on the CPU
                 (map) against the card's cohort run (vmap): each net's
                 predictions in order, >= 99% equal, parameters within
                 W_RTOL, W_ATOL (scaled by their largest magnitude),
                 fitted equal; records/s, launches, gang launches and
                 predicts on a "multi-tenant:" JSON line;
 29. specs       every dense spec of the reference's cohort tests (PA,
                 PA perRecord, RegressorPA, ORR, SVM, MultiClassPA, NN,
                 Softmax) at 8 members, 2,000 rows, parallelism 1: cohort
                 on (vmap) on the card against solo on the CPU (one worker:
                 the same schedule), held as phase 28 holds card against
                 CPU (regression predictions within rtol 1e-3, atol 1e-3).
 30. codec       the QDQ twins (fp16, int8) on the card against the CPU on a
                 seeded vector of 2^20 (fp16 bitwise, 65520 becomes inf;
                 int8 within one step) and on exact ties; phase 24's bench
                 job with comm.codec int8, then fp16, on the whole file:
                 records/s beside phase 24's unarmed run, bytesOnWire below
                 bytesShipped; the file's first CODEC_PARITY_ROWS on the
                 card and the CPU: statistics (bytesOnWire among them),
                 probe predictions and parameters (W_RTOL, W_ATOL) equal;
 31. guard       phase 5's stream with the Create guarded: the slice's
                 checks (pa_scan once a fit: the guard's health dot adds no
                 program launch), records/s beside phase 5's; the first
                 GUARD_PROFILE_RECORDS unguarded and guarded in turns (the
                 ratio) and under torch.profiler (the idle share of each);
                 GUARD_PARITY's run (the
                 first 20,000 records, 4 workers, syncEvery 1) under
                 GUARD_CHAOS (tests/test_guard.py's worker->hub spec: the
                 hubs reject, no worker trips) and GUARD_CHAOS_BOTH (trips,
                 rollbacks; a poisoned worker answers NaN until its guard's
                 next check, as in the JAX package) on the card and the
                 CPU: statistics and the chaos channels' counters equal,
                 >= 99% predictions equal (NaN for NaN), holdout score
                 above chance;
 32. guard-cohort phase 28's 64 tenants guarded, cohorts auto, over its
                 first prefix_records: one batched pa_scan launch a gang
                 step, one [C] health read a gang launch, predictions equal
                 to the unguarded run's (records/s beside it); a tenant
                 picked by --seed poisoned halfway on each worker where it
                 is not waiting on its round: evicted, rolled back, finite,
                 every other tenant's predictions unchanged;
 33. reliable    phase 5's stream at parallelism 4 over its first 20,000
                 records through RELIABLE_CHAOS on the card and the CPU
                 (duplicatesDropped, gapsResynced, every statistic and the
                 chaos counters equal, >= 99% predictions equal), and
                 unarmed on the card (wall against the chaos run's).
 34. recovery    phase 5's stream over RECOVERY_RUN's first 20,000 records
                 on the card: unarmed; checkpointed about 20 times (the
                 interval: the unarmed wall over 20; 10-40 snapshots; the
                 same statistics and predictions); checkpointed with a
                 FaultInjector crash in worker 3 at 9,000 records under
                 JobSupervisor(max_restarts=2): one failure restored from a
                 snapshot, every integer statistic but the tallies no
                 snapshot carries (UNSNAPSHOTTED_TALLIES) and fitted equal
                 to the unfaulted run's, parameters within rtol 1e-5, atol
                 1e-6 (bitwise printed), the forecasts' last emissions >=
                 99% equal, pa_scan once a fit of the final incarnation;
                 the snapshot it restored, restored with device="cpu" and
                 run to the end: the card continuation's statistics, >= 99%
                 of its forecasts; save seconds, bytes, restore seconds and
                 records/s armed against unarmed;
 35. rescale     the same records at 16 workers with rescale(4) after 7,000
                 and rescale(8) after 14,000 on the card and the CPU (every
                 integer statistic equal, rescalesPerformed 2, >= 99%
                 forecasts equal, parameters within W_RTOL, W_ATOL, pa_scan
                 once a fit); the snapshot at 10,000 restored at
                 parallelism 4 on both (the same checks); phase 14's sparse
                 stream over 20,000 records crashed and recovered on the
                 card (phase 34's checks, scatter_add once a fit);
 36. rescale-cohort phase 28's 64 tenants at 2 workers over their first
                 5,000 rows, rescale(1) at 2,500 and rescale(2) at 3,750, on
                 the card (one batched pa_scan launch a gang step, no solo
                 launch) and the CPU (>= 99% predictions equal, parameters
                 within W_RTOL, W_ATOL, fitted equal);
 37. spmd-ckpt   the bench job on phase 26's Mesh(8, 2) over the bench
                 file's first 20,000 rows, a snapshot at 10,000: the
                 same-mesh restore continues to the uninterrupted run's
                 counters and parameters (W_RTOL, W_ATOL); a restore at dp 4
                 seeds the mean of the saved replicas on the card and the
                 CPU, which then agree; SPMDTrainer save/load bitwise;
 38. lm-ckpt     phase 9's trainer saved, loaded into a fresh SeqTrainer
                 (bitwise), both take 2 more steps: parameters bitwise or
                 within LM_PARITY_ATOL (printed), the loaded trainer
                 launches each flash kernel n_layers x 2 times; save and
                 load seconds and bytes.
 39. overload    the JAX package's overload smoke (protocol_comparison.py
                 run_overload_one): 64 PA tenants (C 1.0, Asynchronous,
                 syncEvery 4, serving maxBatch 64 maxDelayMs 500), cohorts
                 off, parallelism 1, batch 256, test off, OVERLOAD_SPEC,
                 OVERLOAD_RUN's 4,096 rows of its _mt_stream (28 features)
                 50/50 forecast and train through the record route, a
                 no-burst leg and a burst leg (a 10x forecast flood at
                 tenant 0 through the middle half), paired up to 3 times:
                 its gates (the hot tenant sheds and throttles, the level
                 peaks at CRITICAL and returns to OK; no healthy tenant
                 sheds and they serve what the no-burst leg serves; the
                 healthy p99 within 500 ms and 1.5x the no-burst leg's;
                 nothing stranded in queue_depths; the healthy throughput
                 ratio, best of the trials, reported and held to 0.9); the
                 two legs on the first 1,024 rows on the card and the CPU:
                 per-tenant forecastsShed, recordsThrottled and the
                 dead-letter counts by reason equal; then phase 28's 64
                 perRecord tenants on their first 5,000 rows, cohorts on,
                 with the plane armed at its defaults and unarmed: every
                 prediction bitwise equal, one batched pa_scan launch a
                 gang step and no solo launch, records/s of each; then
                 phase 14's sparse learner through the armed admission on
                 its first 2,000 records: scatter_add once a fit.
 40. lifecycle   the JAX package's lifecycle smoke (run_lifecycle_one) on
                 LIFECYCLE_RUN's 6,144 rows of the same stream, 50/50,
                 parallelism 1, batch 64, test on, PA C 1.0 with perRecord
                 (every fit a pa_scan launch), four legs: off; healthy
                 (Shadow PA C 0.5, Promote; it must promote: active
                 version 1, shadowScored >= 2, no rollback); hold (never
                 promotes); poison (the candidate blown up at row 1,024:
                 rolled back, active version 0, no promotion); no leg loses
                 a forecast, and in hold and poison every untagged
                 prediction is bitwise the off leg's at the same position;
                 pa_scan once an active fit plus once a candidate fit (two
                 a flush while a candidate trains); the healthy leg on the
                 card and the CPU (the promotion at the same forecast, the
                 version tags equal, >= 99% of predictions equal); a
                 snapshot mid-canary restored on the card and with
                 device="cpu" reaches the same promotion at the same
                 forecast; records/s of healthy and hold against off, the
                 device time the candidate adds in the hold leg
                 (torch.profiler, hold against off), the snapshot's bytes
                 and its save and restore seconds.
 41. telemetry   (a) the JAX package's telemetry smoke (protocol_comparison.py
                 --telemetry-smoke), not cut: TELEMETRY_SMOKE's 48,000 rows
                 (28 features), parallelism 4, batch 64, Synchronous PA C
                 1.0, packed blocks of 8,192; unarmed against armed
                 (statsEvery=4096,traceSample=16,spanPath=...) in 4 paired
                 trials after one warm-up pair: the armed leg's score,
                 fitted, modelsShipped, bytesOnWire and numOfBlocks equal
                 the unarmed leg's, the best pair costs at most 1.03x, at
                 least max(records // 8192 - 1, 1) heartbeats, the phase
                 table's coverage at least 0.5, a completed span whose
                 record has networkId, seq, op and rttMs; (b) phase 5's
                 stream armed (statsEvery=10000,traceSample=16) under
                 torch.profiler (device activity): predictions bitwise
                 phase 5's, pa_scan launches phase 5's, the heartbeat count,
                 phase table and device-busy seconds printed; (c) the first
                 PROFILED_CLI_RECORDS training records of phase 17's stream
                 through the CLI with --profileDir and without: the Chrome
                 trace names pa_gram_kernel, pa_chain_kernel and
                 pa_update_kernel, each as often as pa_scan's launch counter
                 moved over the run, and the predictions are equal.
 42. recorder    (a) the JAX package's incident smoke (run_incident_smoke),
                 not cut: INCIDENT_SMOKE's 16,000 rows, dim 28, parallelism
                 2, batch 64, Asynchronous PA C 1.0 guarded; 4 paired
                 clean trials unarmed against INCIDENT_EVENTS_SPEC (the
                 score equal, the best pair at most 1.03x, an event
                 recorded); the supervised leg (guard maxStrikes 1, the
                 reliable channel, syncEvery 1, spoke 1 poisoned before
                 block 6, worker 0 dying after 2,500 rows under
                 JobSupervisor): exactly one restart, a kind="alert" record
                 on the performance sink, one merged bundle holding
                 delta_rejected (strikes >= 1) < worker_retired
                 (guard_strikes) < restart, the rejection stamped, each
                 sender stream in seq order, an alert in the bundle; the
                 same leg on the CPU: the same timeline without wall
                 times; (b) phase 32's poisoned guarded cohorts with
                 events on, on the card and the CPU: guard_trip,
                 guard_rollback and guard_evict for the poisoned tenant
                 only, batched pa_scan launches phase 32's, the journals
                 equal; (c) phase 40's poison leg with events on, on the
                 card and the CPU: the lifecycle transitions through the
                 rollback recorded, pa_scan launches and predictions phase
                 40's, version tags and journals equal.
 43. flash-coverage the forward, dQ and dK/dV kernels against their plain
                 twins (phase 7's limits; float32 against the twin in
                 float64) at the widths and dtypes the JAX kernels take:
                 float32 dh 128 (8 x 1024 x 4, and ragged 1000/1100), dh
                 8, 12, 16, 36, 48, 80, 96, 100 and 256 in bf16 and
                 float32 (square and ragged); and B * H = 131,072 on each
                 design (32,768 x 64 x 4: bf16 dh 64 sm90, float32 dh 8
                 mma; the twin in batch chunks); then FLASH_WIDE_CHECKS
                 with their own readings: the wide instance at dh 320 and
                 512 in both dtypes (2 x 1024 x 2, and ragged 1000/1100)
                 and a bf16 dh-128 case whose views are 2 bytes off
                 16-byte alignment (it must run mma.sync): every (dtype,
                 built width, design) run_dtype reaches; then
                 FLASH_COVERAGE_TIME timed as phase 8 (20 launches a turn)
                 with each design's bound and SDPA (the SDPA backends that
                 take each shape named);
 44. lm-moe      SeqTrainer at LM_MOE_CONFIG (phase 9's LM with 8 switch
                 experts, capacity 1.25, remat): a warm-up step and 8
                 steps; the warm-up batch's loss falls; flash launches
                 forward 64, dQ 32, dK/dV 32 (remat runs the forward again
                 in the backward); tokens/s, ms a step, peak memory, the
                 share of tokens dropped at capacity on the last step; the
                 config without remat for 2 steps, both steps' peak memory
                 printed, and the loss-and-gradient pass's peak above the
                 resident state must be higher without remat; generate
                 refuses the config;
 45. lm-f32      (a) phase 9's LM at float32, 4 steps: the loss falls, each
                 float32 dh-128 kernel launched 16 times, ms a step beside
                 phase 9's; (b) LM_MOE_PARITY_CONFIG (MoE, remat, float32)
                 3 steps on cuda and cpu from the same numpy parameters:
                 every token's (expert, keep) on the last step's forward
                 equal, parameters within LM_PARITY_ATOL, losses within
                 1e-5; (c) GRAFT_MOE_CONFIG (dh 8, the JAX package's MoE
                 dry-run width) 3 steps on the card, finite falling losses.
 47. kafka       (47d runs after phase 40, before phases 41-42: its
                 profile window needs torch.profiler's device records; the
                 rest after phase 42, so that the reference smokes' timed
                 gates run as before the phase existed) the Kafka
                 route over tests/fskafka.py's file-backed broker
                 (installed as the ``kafka`` module; FSKAFKA_DIR under the
                 run's temporary directory; sys.modules and the
                 environment restored after): (a) python -m
                 omldm_tpu_torch --kafkaBrokers fs://local on the card
                 (phase 17's flags), phase 5's stream published to the
                 requests, trainingData and forecastingData logs by a
                 feeder thread once the consumer connected, the job ended
                 by its silence timer: one predictions-topic line for
                 every forecast, fitted equal to phase 17's, pa_scan
                 launched once a fit, the statistics on the performance
                 topic, holdout accuracy > 0.6, the Query answered once;
                 then the route's time a record split in the same call
                 (kafka-breakdown: the file-backed consumer alone,
                 polling_events with no job, a producer send, the job
                 alone through _kafka_loop, over a window of the logs'
                 head and one of their training-only tail); (b) the first --parity-records records preloaded and
                 consumed in assign mode from offset 0 (connect_kafka,
                 polling_events) at phase 6's parallelism on the card and
                 on the CPU: every integer statistic equal, >= 99% of
                 predictions equal; then again under OMLDM_CHAOS_KAFKA
                 (seeded drop, duplicate, reorder): ChaosConsumer's
                 counters equal too; (c) phase 34's records (forecasts
                 inline on trainingData) through the CLI with
                 --checkpointing --checkInterval (about 10 saves)
                 --restartAttempts 2 and phase 34's FaultInjector crash:
                 one restore, the reconnect seeks the snapshot's offsets,
                 fitted equal to phase 34's unfaulted run, every forecast
                 answered; (d) --profileSteps 1000 --profileDir on the
                 route (the first 5,000 training records, batch 16): the
                 trace stops once, names pa_gram_kernel, pa_chain_kernel
                 and pa_update_kernel each as often as pa_scan launched in
                 the window, and gives the window's idle share; (e) the
                 load harness's default storm (seed 7, 128 tenants, 1,024
                 records, chunk rows 64) through run_inprocess_storm on the
                 card, again on the card and on the CPU: the SLO report
                 passes (the hot tenants may shed, no row stranded), the
                 three core digests equal; run_composition_identity on
                 STORM_IDENTITY on the card: equal digests; (f) the storm
                 at 64 tenants with perRecord: one batched pa_scan launch a
                 gang step,
                 the solo launches printed. After each of its two parts
                 no thread started in it is alive and torch.profiler is
                 off (a residue: line). With --kafka-only: the build,
                 phase 17 and phase 47, then exit.
 48. fleet       (after phase 47) the multi-process fleet's file route,
                 each process a python -c bootstrap that calls
                 omldm_tpu_torch.runtime.distributed_job.run_distributed
                 with the CLI's flags and prints its pa_scan and
                 scatter_add launches, fleet steps and group calls: (a)
                 the slice-1 Create (nFeatures 28) on 100,000
                 HIGGS-shaped records, a forecast every 9, a final Query,
                 at --processes 2 sharing the card (gloo, the backend
                 rule), at --processes 1 on the card and at --processes 2
                 --device cpu: fitted + holdout = the training rows,
                 every forecast answered, score > 0.6, on the card
                 pa_scan launched once a fleet step on each process; card
                 against CPU every integer statistic equal, >= 99% of
                 predictions equal; (b) the slice-3 sparse Create (13 +
                 2^18, maxNnz 40) on 20,000 Criteo-shaped records at two
                 processes, card and CPU: scatter_add once a fleet step a
                 process, every integer statistic equal. Prints records/s
                 at 1 and 2 processes, each process's wall and group
                 calls a step (fleet[...]: lines).
 49. recovery    (after phase 48) the fleet's recovery half, 2 processes
                 sharing the card over gloo (phase 48's bootstrap), the
                 slice-1 Create on 20,000 records in chunks of 1,024 rows:
                 (a) clean, faulted (--checkpointEvery 4 --failAfterChunks
                 9, exit 3) and --restore true: the resumed run's integer
                 statistics and holdout equal the clean run's, and each
                 resumed process launches pa_scan once a fleet step it
                 takes; (b) the snapshot restored at 1 process: fitted +
                 holdout = the training rows, one rescale counted; (c)
                 process 1's shard of ckpt-1 truncated: the restore falls
                 back to ckpt-0 with --flightRecorder on recording
                 candidate_rejected, and ends as the clean run; (d)
                 --hangProcess 1 --collectiveTimeoutMs 5000: process 0 exits
                 19 with a hang event, the frozen peer is SIGKILLed; (e) the
                 card's snapshot restored on the CPU: every integer
                 statistic equal; (f) the sparse fleet faulted and restored
                 at its byte cursor: the clean run's statistics, scatter_add
                 once a step. Prints each save's and restore's seconds
                 (recovery[...]: lines). With --fleet-only: the build and
                 phases 48-49, then exit.
 50. selfheal    (after phase 49) the self-healing fleet, its legs side by
                 side (started 2 s apart, those with most relaunches
                 first), each fleet on its own file-backed broker
                 (tests/fskafka.py) and coordinator port, 2 processes sharing
                 the card over gloo, each a python -c bootstrap (BOOT_KAFKA)
                 writing its row to a file however it ends: (a) the
                 fleet's Kafka drive, phase 49's records on 2 partitions,
                 card and CPU: fitted + holdout = the training rows, pa_scan
                 once a fleet step on each card process, card = CPU in every
                 integer statistic, >= 99% predictions equal, records/s from
                 the first consumed record to the report; (b) the same under
                 --supervise true with process 0 killed after 9,500 records
                 (snapshots every 4 windows): one relaunch, (a)'s statistics,
                 each forecast of (a) once on the predictions topic (EMITTED)
                 and >= 99% of its answers equal (a)'s, the time from the
                 kill to the HEAL event split into detection, spawn, imports, the card's context, the join, the restore
                 and the first beat; (c) --severBrokerAfterChunks 2: exit 0,
                 dropped sends, the report on its file; (d) the self-heal
                 chain of tests/test_selfheal.py (a frozen process, 2 -> 1
                 -> probe -> 2): its lines in order, strike < degrade < probe
                 in the final bundle, conservation, exactly once, back at 2
                 and not degraded; (e) the autoscale run of
                 tests/test_autoscale.py (1 -> 2 -> 1): 2 rescales,
                 conservation, exactly once; (f) the JAX CI gate's
                 supervised storm (16 tenants) through
                 load_harness.run_supervised_storm: the SLO report passes.
                 (g) phase 49's sparse stream under the supervisor:
                 scatter_add once a step a process. pa_scan once a step in
                 every process of every incarnation (selfheal[...]: lines).
                 With --selfheal-only: the build, (b) alone on an otherwise
                 idle host (its time to recover by part, its checks but the
                 comparison with (a)), phase 50, then exit.
Phases 43-45 run right after phase 10 (their timings need the profiler's
device records, which can come back empty after phases 41-42's traces).
With --sequence-only: the build, phase 9 and phases 43-45, then exit.
With --profile DIR, after phase 20: phases 17, 19 and 20's CLI runs under
cProfile, parsing on the main thread (host seconds by function: parse,
the record route's vectorize, holdout, stage, fit, serve, the sink); after
phase 23: the HOST_PLANE_PROFILES runs of phases 21 and 22 under cProfile
and torch.profiler (host seconds by function, device busy time and the
idle share against the unprofiled run); after phase 26: the bench job's
serial fused route under cProfile (host seconds by function:
BENCH_PROFILE_FUNCS); then the slice's and the sparse
stream's runs under cProfile (host time by function) and torch.profiler
(device busy time), then 4 LM steps under torch.profiler (device busy
time, the flash kernels' share, the top kernels), and in phase 44 4 steps
of the MoE LM the same way; in phase 48 the one-process card run again
under cProfile (fleet-card1.txt); tables are written into DIR.
With --ab-pa-scan SRC, after the build: the one-scan kernel against SRC
(another checkout's omldm_tpu_torch/csrc/pa_scan.cu, e.g. a parent commit
unpacked with git archive) as CUDA graphs at TIME_SHAPES in alternating
turns, then exit.
With --overload-legs N, after the build: N trials of phase 39's timed legs
(no burst, then burst), each leg's healthy serve p99, seconds and the full
collections inside it, with full collections deferred as the phase runs
them or, with --overload-collector on, left to the collector;
then exit.
With --telemetry-legs N, after the build: N pairs of phase 41a's timed
legs (unarmed, then armed), each pair's ratio and records/s, the 1.03x
gate reported and not held; then exit.
With either, --package DIR takes omldm_tpu_torch from DIR (another
checkout, e.g. a parent commit unpacked with git archive).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM data-sheet peaks, dense (the card's power limit is printed beside them)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
W_RTOL, W_ATOL, LOSS_ATOL = 2e-4, 2e-5, 1e-5
CHECK_SHAPES = [(1, 29), (256, 29), (256, 1025), (255, 4097)]
# a batch past the kernel's row limit (26,944): the wrapper runs two chunks
CHUNKED_CHECK = (28_000, 29)
TIME_SHAPES = [(256, 29), (256, 1025), (255, 4097)]
N_FEATURES = 28  # HIGGS


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


_LAP = [time.perf_counter()]


def lap(label: str) -> None:
    """Logs the wall seconds since the previous lap: where the script's time
    goes against its limit."""
    now = time.perf_counter()
    log(f"lap: {label} {now - _LAP[0]:.1f} s")
    _LAP[0] = now


# --- data -------------------------------------------------------------------


def higgs_like(n: int, rng):
    """HIGGS-shaped rows: 28 features -- positive momenta-like columns, angles
    in (-pi, pi), discrete b-tags, positive invariant-mass-like columns --
    and a binary label from a planted linear rule on the standardized
    features plus noise."""
    import numpy as np

    cols = []
    for k in range(N_FEATURES):
        if k in (5, 9, 13, 17):                       # b-tag weights
            cols.append(rng.choice([0.0, 1.0, 2.17], size=n))
        elif k % 2 == 0 and k < 21:                   # momenta
            cols.append(rng.lognormal(0.0, 0.5, size=n))
        elif k < 21:                                  # angles
            cols.append(rng.uniform(-np.pi, np.pi, size=n))
        else:                                         # high-level masses
            cols.append(rng.gamma(4.0, 0.25, size=n))
    x = np.stack(cols, axis=1)
    w = rng.randn(N_FEATURES)
    z = (x - x.mean(axis=0)) / x.std(axis=0)
    y = (z @ w + 0.5 * np.sqrt(N_FEATURES) * rng.randn(n) > 0).astype(np.float64)
    return np.round(x, 6), y


def make_events(n_train: int, seed: int, query_at: int | None):
    """Create + n_train training records, a forecast after every 9 training
    records (every tenth record), an optional Query."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n_fore = n_train // 9
    x, y = higgs_like(n_train + n_fore, rng)
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"}},
        "preProcessors": [{"name": "StandardScaler"}],
        "trainingConfiguration": {"protocol": "Asynchronous", "perRecord": True},
    }
    events = [("requests", json.dumps(create))]
    f = n_train
    for i in range(n_train):
        events.append(("trainingData", json.dumps(
            {"numericalFeatures": x[i].tolist(), "target": float(y[i])}
        )))
        if i % 9 == 8 and f < x.shape[0]:
            events.append(("forecastingData", json.dumps(
                {"numericalFeatures": x[f].tolist()}
            )))
            f += 1
        if query_at is not None and i == query_at:
            events.append(("requests", json.dumps(
                {"id": 0, "request": "Query", "requestId": 1}
            )))
    return events


# --- phases -----------------------------------------------------------------


def phase_setup(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build(pa_scan, attention, sparse):
    """One nvcc per source, all started together. Waits for pa_scan's and
    scatter_add's builds (seconds) and returns the wait for flash
    attention's (about a minute), which runs on beside the phases that need
    no flash kernel; a build never waited for is stopped at exit."""
    t0 = time.perf_counter()
    for lib in (pa_scan.LIBRARY, attention.LIBRARY, sparse.LIBRARY):
        lib.start()
    atexit.register(attention.LIBRARY.stop)
    _load_libraries([("pa_scan.cu", pa_scan.LIBRARY), ("scatter_add.cu", sparse.LIBRARY)], t0)
    return lambda: _load_libraries([("flash_attention.cu", attention.LIBRARY)], t0)


def _load_libraries(libraries, t0):
    """Wait for each library's build and load it; log nvcc's seconds and
    report, and the registers and spills of pa_scan's and flash's kernels."""
    for _, lib in libraries:
        lib.load()
    log(f"build: {', '.join(name for name, _ in libraries)} loaded "
        f"{time.perf_counter() - t0:.2f} s after the builds started")
    for name, lib in libraries:
        log(f"build: {name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if line.strip():
                log(f"  nvcc: {line.strip()}")
        prefix = {"pa_scan.cu": "_kernel", "flash_attention.cu": "flash_"}.get(name)
        for kernel, info in (ptxas_summary(lib.build_log, prefix).items() if prefix else ()):
            log(f"build: ptxas {kernel}: {info}")
            # every flash instance must build without spills (the register
            # budget each design's tiles and column chunks are sized for)
            check(prefix != "flash_" or info.get("spill_stores", 0) + info.get("spill_loads", 0) == 0,
                  f"{kernel} spills: {info}")


def ptxas_summary(build_log: str, prefix: str = "flash_") -> dict:
    """Registers, spills and static shared memory of each kernel instance
    whose name holds ``prefix``, from nvcc's -Xptxas -v report (names
    demangled by c++filt where the machine has it)."""
    import re
    import shutil

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or prefix not in name:
            continue
        info = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info["spill_stores"], info["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            info["static_smem"] = int(m.group(1)) if m else 0
    if out and shutil.which("c++filt"):
        names = list(out)
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
        if len(plain) == len(names):
            out = {p.replace("(anonymous namespace)::", ""): out[n] for p, n in zip(plain, names)}
    return out


def _kernel_inputs(torch, B, D, labels, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, D), generator=g)
    x[:, -1] = 1.0  # the bias column
    w0 = torch.randn((D,), generator=g) * 0.1
    if labels == "01":
        y = torch.randint(0, 2, (B,), generator=g).float()
    else:
        y = torch.randint(0, 2, (B,), generator=g).float() * 2.0 - 1.0
    mask = (torch.rand((B,), generator=g) > 0.2).float()
    mask[-max(B // 8, 1):] = 0.0
    return [t.cuda().contiguous() for t in (w0, x, y, mask)]


def phase_check(torch, pa_scan):
    max_w = max_loss = 0.0
    n = 0
    for B, D in CHECK_SHAPES:
        for variant in ("PA", "PA-I", "PA-II"):
            for C in (0.01, 0.5):
                for labels in ("01", "pm1"):
                    w0, x, y, mask = _kernel_inputs(torch, B, D, labels, seed=B * 7 + D + n)
                    kw, kl = pa_scan.pa_scan_update(w0, x, y, mask, variant, C)
                    pw, pl = pa_scan.pa_scan_reference(w0, x, y, mask, variant, C)
                    torch.cuda.synchronize()
                    err_w = (kw - pw).abs().max().item()
                    err_l = abs(kl.item() - pl.item())
                    ok = torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL)
                    check(ok and err_l <= LOSS_ATOL,
                          f"pa_scan disagrees at B={B} D={D} {variant} C={C} "
                          f"labels={labels}: max|dw|={err_w} |dloss|={err_l}")
                    max_w, max_loss = max(max_w, err_w), max(max_loss, err_l)
                    n += 1
    log(f"check: {n} kernel-vs-plain cases pass; max|dw|={max_w:.3e} "
        f"max|dloss|={max_loss:.3e} (rtol={W_RTOL}, atol={W_ATOL}, loss {LOSS_ATOL})")
    B, D = CHUNKED_CHECK
    limit = pa_scan.LIBRARY.load().omldm_pa_scan_max_rows()
    check(B > limit, f"CHUNKED_CHECK B={B} is not past the row limit {limit}")
    w0, x, y, mask = _kernel_inputs(torch, B, D, "pm1", seed=5)
    before = pa_scan.launches
    t0 = time.perf_counter()
    kw, kl = pa_scan.pa_scan_update(w0, x, y, mask, "PA-II", 0.5)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    chunks = pa_scan.launches - before
    pw, pl = pa_scan.pa_scan_reference(w0, x, y, mask, "PA-II", 0.5)
    err_w = (kw - pw).abs().max().item()
    err_l = abs(kl.item() - pl.item())
    log(f"check: pa_scan B={B} D+1={D} past the row limit {limit}: {chunks} chunks "
        f"({k_s:.3f} s with the first call's scratch), max|dw|={err_w:.3e} |dloss|={err_l:.3e}")
    check(chunks == -(-B // limit), f"pa_scan ran {chunks} chunks for B={B}")
    check(torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL) and err_l <= LOSS_ATOL,
          f"pa_scan disagrees past the row limit: max|dw|={err_w} |dloss|={err_l}")
    return max(max_w, err_w)


def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(B, D):
    """Least time for the same work: each input read once, each output
    written once, over HBM; fp32 operations (w.x, x.x, the update) over the
    non-tensor-core peak. Returns (ms, "bytes" | "operations")."""
    nbytes = (B * D + 2 * B + D + D + 1) * 4
    flops = 6 * B * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _call_latency(torch, fn, reps):
    """The device's time a call of ``fn`` with the gaps between its
    launches: (the median span from a call's first kernel start to its last
    kernel end in a torch.profiler trace of ``reps`` eager calls, the time a
    call of a CUDA graph of ``reps`` captured calls, by events around 5
    replays). Calls are told apart in the trace by launch order: every call
    launches the same number of kernels."""
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then comes back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            tp.export_chrome_trace(str(trace))
            kern = sorted((e for e in json.loads(trace.read_text()).get("traceEvents", [])
                           if e.get("cat") == "kernel"), key=lambda e: e["ts"])
        if kern and len(kern) % reps == 0:
            break
        log(f"profile: session {attempt} traced {len(kern)} kernels for {reps} calls; "
            f"profiling again")
    check(kern and len(kern) % reps == 0,
          f"torch.profiler traced {len(kern)} kernels for {reps} calls in 3 sessions")
    per = len(kern) // reps
    spans = [kern[i + per - 1]["ts"] + kern[i + per - 1]["dur"] - kern[i]["ts"]
             for i in range(0, len(kern), per)]
    span_ms = statistics.median(spans) / 1e3
    return span_ms, _graph_ms(torch, fn, reps)


def _graph_ms(torch, fn, reps, replays=5):
    """The time a call of ``fn`` as a CUDA graph of ``reps`` captured calls,
    by events around ``replays`` replays: its launches and the gaps between
    them on the device, no host work (warmed up on a side stream first, as
    capture wants)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def phase_time(torch, pa_scan):
    """Kernel ms from CUDA events over 1000 back-to-back calls (once the
    kernel is shorter than the wrapper's host work, this times the host),
    plain ms over fewer, in turns kernel, plain, kernel, plain (the second
    of each is reported); the host's time a call (``_host_us``); the
    device's busy time a call (torch.profiler, 200 calls, median of 3
    turns: the three launches' sum); then the time a call with the gaps
    between its launches (``_call_latency``: the device span of an eager
    call and a CUDA graph's time a call). The kernel's ``ms`` is the graph's
    time a call: the launches and their gaps, without the host."""
    import statistics

    out = {}
    for B, D in TIME_SHAPES:
        w0, x, y, mask = _kernel_inputs(torch, B, D, "01", seed=99)
        kern = lambda: pa_scan.pa_scan_update(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        plain = lambda: pa_scan.pa_scan_reference(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        k1 = _time_ms(torch, kern, 1000)
        p1 = _time_ms(torch, plain, 10)
        k2 = _time_ms(torch, kern, 1000)
        p2 = _time_ms(torch, plain, 10)
        host = _host_us(torch, kern)
        parts = {}
        dev = [_device_ms(torch, kern, 200, parts) for _ in range(3)]
        d = statistics.median(dev)
        span, graph = _call_latency(torch, kern, 200)
        b, by = bound_ms(B, D)
        out[(B, D)] = {"ms": graph, "plain_ms": p2, "bound_ms": b, "bound_by": by}
        log(f"time: pa_scan B={B} D+1={D}: CUDA graph {graph:.6f} ms a call (launches and "
            f"their gaps); eager device span {span:.6f} ms a call (median); device busy "
            f"{d:.6f} ms a call (torch.profiler, {min(dev):.6f}-{max(dev):.6f} over 3 turns); "
            f"events {k1:.6f} / {k2:.6f} ms; host {host:.1f} us a call; "
            f"plain {p1:.4f} / {p2:.4f} ms, bound {b:.7f} ms ({by}-bound by the "
            f"roofline; the chain of {B} dependent rows bounds it in fact), "
            f"library none")
        log(f"time: pa_scan B={B} D+1={D}: its launches, device ms a call (last turn): " + "; ".join(
            f"{name.split('(')[0]} {ms:.6f}" for name, ms in parts.items()))
    return out


def _pipelines(job):
    """The workers' pipelines and a SingleLearner hub's."""
    pipes = [net.pipeline for spoke in job.spokes for net in spoke.nets.values()]
    return pipes + [h.node.pipeline for h in job.hub_manager.hubs.values()
                    if getattr(h.node, "pipeline", None) is not None]


SLICE_CONFIG = dict(parallelism=16, batch_size=256)


def _run_slice(torch, events, device="cuda", chaos=""):
    """The slice's job on ``events`` (with ``chaos``, through the seeded
    chaos channel); returns (job, report, wall seconds)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    job = StreamJob(JobConfig(**SLICE_CONFIG, chaos=chaos), device=device)
    t0 = time.perf_counter()
    report = job.run(events)
    if device == "cuda":
        torch.cuda.synchronize()
    return job, report, time.perf_counter() - t0


def phase_slice(torch, pa_scan, events, device="cuda"):
    """Phase 5. Returns (pa_scan launches, wall seconds, the predictions'
    values in emission order)."""
    launches, wall, job, _ = _slice_checked(torch, pa_scan, events, device)
    return launches, wall, [p.value for p in job.predictions]


def _slice_checked(torch, pa_scan, events, device="cuda", label="slice", chaos=""):
    """One slice job, counted and checked: pa_scan once a per-record fit (a
    fit counted by programLaunches; with chaos, where a rejected or lost
    push takes its learning-curve points with it, by programLaunches
    alone), every forecast answered, the Query's parameters, the state on
    the device, the holdout score above chance. Returns (launches, wall,
    job, statistics)."""
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    pa_scan.launches = 0
    job, report, wall = _run_slice(torch, events, device, chaos)
    launches = pa_scan.launches

    check(report is not None, f"{label}: the job emitted no JobStatistics")
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    # one holdout evaluation per worker for the Query and for termination
    evaluations = 2 * job.config.parallelism
    fits_by_launches = stats.program_launches - stats.forecasts_served - evaluations
    log(f"{label}: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, "
        f"fits {fits}, pa_scan launches {launches}, programLaunches "
        f"{stats.program_launches}, fitted {stats.fitted}, score {stats.score:.4f}, "
        f"serveLatencyP50Ms {stats.serve_latency_p50_ms:.4f}, "
        f"serveLatencyP99Ms {stats.serve_latency_p99_ms:.4f}")
    check(launches > 0, f"{label}: pa_scan was never launched on the main path")
    if chaos:
        check(launches == fits_by_launches,
              f"{label}: pa_scan launches {launches} != per-record fits by programLaunches "
              f"{fits_by_launches}")
    else:
        check(launches == fits == fits_by_launches,
              f"{label}: pa_scan launches {launches} != per-record fits {fits} "
              f"(programLaunches accounting: {fits_by_launches})")
    for pipe in _pipelines(job):
        tensors = [pipe.state["fitted"], pipe.state["cum_loss"]]
        tensors += list(pipe.state["params"].values())
        tensors += [t for s in pipe.state["preps"] for t in s.values()]
        check(all(t.device.type == device for t in tensors),
              f"{label}: a pipeline state tensor is not on {device}")
    check(len(job.predictions) == n_fore,
          f"{label}: {len(job.predictions)} predictions for {n_fore} forecasting records")
    preds = [p.value for p in job.predictions]
    # under chaos a worker whose release arrived poisoned answers NaN until
    # its guard's next check rolls it back, as the JAX package does (the
    # CPU runs of phase 31 hold the card to it); else every answer is a sign
    nan_preds = sum(1 for v in preds if v != v)
    check(all(v in (-1.0, 1.0) for v in preds if v == v) and (chaos or not nan_preds),
          f"{label}: a prediction is not a sign ({nan_preds} NaN)")
    check(len(job.responses) == 1, f"{label}: {len(job.responses)} query responses, expected 1")
    values = job.responses[0].learner["parameters"]["values"]
    check(len(values) == N_FEATURES + 1, f"{label}: query returned {len(values)} parameters")
    check(stats.forecasts_served == n_fore, f"{label}: forecastsServed != forecasting records")
    check(stats.score > 0.6, f"{label}: final holdout accuracy {stats.score} is not above chance")
    # host wall time inside the spokes' fit-flush and forecast-serve timers
    # (a fit returns before the device finishes, except at sync points)
    fit_s = sum(s.step_timer.total_ms for s in job.spokes) / 1e3
    serve_s = sum(s.serve_timer.total_ms for s in job.spokes) / 1e3
    log(f"{label}: " + json.dumps({
        "records": len(events), "wall_s": wall, "records_per_s": len(events) / wall,
        "fit_flush_s": fit_s, "serve_s": serve_s,
        "fits": fits, "pa_scan_launches": launches, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms,
        "forecasts": n_fore, "nan_predictions": nan_preds,
    }))
    return launches, wall, job, stats


def phase_parity(events, devices=("cuda", "cpu")):
    """``events``: the Create and the first records of the slice's stream."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    runs = {}
    for device in devices:
        job = StreamJob(JobConfig(parallelism=4, batch_size=256), device=device)
        job.run(events)
        flats = [p.get_flat_params()[0] for p in _pipelines(job)]
        runs[device] = (np.array([p.value for p in job.predictions]), flats)
    (pc, fc), (pp, fp) = (runs[d] for d in devices)
    check(len(pc) == len(pp) > 0, "parity runs emitted different prediction counts")
    mismatches = int((pc != pp).sum())
    err = max(float(np.abs(a - b).max()) for a, b in zip(fc, fp))
    log(f"parity: {devices[0]} vs {devices[1]} on {len(events) - 1} records: prediction mismatches "
        f"{mismatches}/{len(pc)}, final params max|d|={err:.3e}")
    check(mismatches <= 0.01 * len(pc), "more than 1% of predictions differ")
    for a, b in zip(fc, fp):
        check(np.allclose(a, b, rtol=W_RTOL, atol=W_ATOL),
              f"final params differ between cuda and cpu: max|d|={np.abs(a - b).max()}")


# host functions whose cumulative time the profile phase reports:
# (label, file suffix, function name)
PROFILE_FUNCS = [
    ("job.run", "runtime/job.py", "run"),
    ("json parse (records)", "api/data.py", "parse"),
    ("json parse (requests)", "api/requests.py", "from_json"),
    ("job._handle_data", "runtime/job.py", "_handle_data"),
    ("spoke.handle_data", "runtime/spoke.py", "handle_data"),
    ("vectorize", "runtime/vectorizer.py", "vectorize"),
    ("spoke._train (holdout, batch)", "runtime/spoke.py", "_train"),
    ("flush_batch (fits, sync points)", "runtime/spoke.py", "flush_batch"),
    ("spoke._serve", "runtime/spoke.py", "_serve"),
    ("pipeline.predict", "pipelines/pipeline.py", "predict"),
    ("on_forecast_batch (predict + read back)", "protocols/base.py", "on_forecast_batch"),
    ("emit prediction", "runtime/job.py", "_emit_prediction"),
    ("job.terminate", "runtime/job.py", "terminate"),
    ("sync point: flat params to the host", "pipelines/pipeline.py", "get_flat_params"),
    ("sync point: flat params to the device", "pipelines/pipeline.py", "set_flat_params"),
    ("hub fold (Asynchronous PS)", "protocols/async_ps.py", "receive"),
]


def _dev_us(e):
    """A torch.profiler average's device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def phase_profile(torch, events, out_dir: Path, stream="slice"):
    """A stream (``stream``: slice or sparse) under cProfile, then under
    torch.profiler."""
    import cProfile
    import io
    import pstats

    out_dir.mkdir(parents=True, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    _, _, wall_c = _run_slice(torch, events)
    prof.disable()
    st = pstats.Stats(prof)
    st.dump_stats(str(out_dir / f"{stream}.pstats"))
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
    (out_dir / f"{stream}_cprofile.txt").write_text(buf.getvalue())
    host = {}
    for (path, _, name), (_, _, tt, ct, _) in st.stats.items():
        for label, suffix, fname in PROFILE_FUNCS:
            if name == fname and path.endswith(suffix):
                host[label] = host.get(label, 0.0) + ct
    top_self = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    log(f"profile[{stream}]: cProfile wall {wall_c:.3f} s (profiler overhead included); "
        "cumulative host seconds by function:")
    for label, _, _ in PROFILE_FUNCS:
        log(f"  {label}: {host.get(label, 0.0):.3f}")
    log(f"profile[{stream}]: top self time:")
    for (path, line, name), (_, nc, tt, _, _) in top_self:
        log(f"  {tt:.3f} s self, {nc} calls: {Path(path).name}:{line} {name}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        _, _, wall_t = _run_slice(torch, events)
    events_avg = tp.key_averages()
    (out_dir / f"{stream}_torch.txt").write_text(
        events_avg.table(sort_by="self_cpu_time_total", row_limit=40)
    )

    from torch.autograd import DeviceType

    kernels = [e for e in events_avg if e.device_type == DeviceType.CUDA]
    busy_s = sum(_dev_us(e) for e in kernels) / 1e6
    log(f"profile[{stream}]: torch.profiler wall {wall_t:.3f} s (profiler overhead "
        f"included); device busy {busy_s:.4f} s in {len(kernels)} kernel "
        f"names, {sum(e.count for e in kernels)} launches")
    for e in sorted(kernels, key=lambda e: -_dev_us(e))[:8]:
        log(f"  {_dev_us(e) / 1e3:.3f} ms, {e.count} launches: {e.key[:90]}")
    host_ops = sorted(events_avg, key=lambda e: -e.self_cpu_time_total)[:10]
    log(f"profile[{stream}]: top host self time under torch.profiler:")
    for e in host_ops:
        log(f"  {e.self_cpu_time_total / 1e6:.3f} s, {e.count} calls: {e.key[:90]}")
    return busy_s


# --- flash attention -----------------------------------------------------------

# (name, B, Lq, Lk, H, Dh, dtype, q_offset, kv_offset); each runs causal and not
FLASH_CHECKS = [
    ("slice", 8, 1024, 1024, 4, 128, "bfloat16", 0, 0),
    ("lm4096", 2, 4096, 4096, 4, 128, "bfloat16", 0, 0),
    ("bench8192", 4, 8192, 8192, 8, 64, "bfloat16", 0, 0),
    ("ragged", 2, 1000, 1100, 4, 128, "bfloat16", 0, 0),
    ("q_offset256", 2, 512, 768, 4, 128, "bfloat16", 256, 0),
    ("masked_rows", 2, 256, 256, 4, 128, "bfloat16", 0, 100),
    ("f32", 2, 256, 256, 2, 64, "float32", 0, 0),
    ("packed_qkv", 8, 1024, 1024, 4, 128, "bfloat16", 0, 0),
    ("short48", 2, 48, 48, 4, 128, "bfloat16", 0, 0),
    ("dh64_ragged", 2, 1000, 1000, 8, 64, "bfloat16", 0, 0),
    # causal: the first 128-row Q tile sees no key and the last key tile no
    # query, so both sm90 kernels have CTAs with nothing to sweep
    ("kv_offset200", 1, 256, 256, 2, 128, "bfloat16", 0, 200),
]
# cases whose q, k and v are views into one [B, L, 3, H, Dh] projection, as
# the transformer hands them over
FLASH_PACKED = {"packed_qkv"}
# cases whose q, k, v and dO are each a view one element (2 bytes in bf16)
# off 16-byte alignment: a Hopper width that runs on mma.sync
FLASH_MISALIGNED = {"misaligned_dh128"}
# Each kernel output against its twin, per tensor: the relative L2 error
# ||a - ref|| / ||ref||, and the worst element against its own size plus the
# tensor's rms, max |a - ref| / (|ref| + rms(ref)); lse absolute. Limits: a
# few times the largest reading of the sound kernels (PERF.md), far below
# what one wrong row tile or a mis-scaled P would give. bfloat16 is compared
# in its working type (both sides round out, dq, dk and dv to bf16, and P
# against another row max); float32 is held tightly to the exact answer:
# its twin runs in float64 (reference_inputs), so no library's summation
# order enters the check.
FLASH_TOL = {"bfloat16": (1e-2, 1e-1, 1e-5), "float32": (2e-6, 2e-5, 4e-6)}  # l2, elem, lse
FLASH_TIME_SHAPES = [(8, 1024, 4, 128), (2, 4096, 4, 128)]


def _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed, packed=False, misaligned=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dt)  # noqa: E731
    if misaligned:  # each a view whose base is one element off 16-byte alignment
        def mk(*s):  # noqa: F811
            flat = torch.randn(math.prod(s) + 1, generator=g, device="cuda").to(dt)
            return flat[1:].view(s)
    if packed:  # transformer.py's qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert lq == lk
        qkv = mk(b, lq, 3, h, dh)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mk(b, lq, h, dh)
    return mk(b, lq, h, dh), mk(b, lk, h, dh), mk(b, lk, h, dh), mk(b, lq, h, dh)


def _per_head(torch, fn, *tensors):
    """Run a [B, L, H, Dh] -> tuple twin one (b, h) head at a time (so the
    [L, L] scores of L = 8192 fit) and reassemble [B, L, H, Dh] results and
    [B*H, Lq] rows."""
    b, h = tensors[0].shape[0], tensors[0].shape[2]
    outs = None
    for bi in range(b):
        for hi in range(h):
            part = fn(bi, hi, *[t[bi:bi + 1, :, hi:hi + 1] for t in tensors])
            if outs is None:
                outs = [[None] * (b * h) for _ in part]
            for slot, piece in zip(outs, part):
                slot[bi * h + hi] = piece
    result = []
    for pieces in outs:
        if pieces[0].dim() == 4:  # [1, L, 1, Dh] pieces -> [B, L, H, Dh]
            rows = [torch.cat(pieces[bi * h:(bi + 1) * h], dim=2) for bi in range(b)]
            result.append(torch.cat(rows, dim=0))
        else:                     # [1, L] pieces -> [B*H, L]
            result.append(torch.cat([x.reshape(1, -1) for x in pieces], dim=0))
    return result


def _batch_chunks(torch, fn, *tensors, heads=8192):
    """Run a [B, L, H, Dh] -> tuple twin over batch chunks of at most
    ``heads`` (b, h) heads (so B * H past 65,535 takes a few calls, not one
    a head) and concatenate the results along their leading axis."""
    b, h = tensors[0].shape[0], tensors[0].shape[2]
    step = max(1, heads // h)
    parts = [fn(b0, min(b0 + step, b), *[t[b0:b0 + step] for t in tensors])
             for b0 in range(0, b, step)]
    return [torch.cat(pieces, dim=0) for pieces in zip(*parts)]


def reference_inputs(dtype, *tensors):
    """The tensors the plain twin takes for a kernel of ``dtype``: float32
    cases widened to float64 (the twin then computes the exact answer, and
    the check reads only the kernel's own rounding); bf16 as they are (the
    twin rounds P and dS to bf16 as the kernels do)."""
    return [t.double() if dtype == "float32" else t for t in tensors]


def phase_flash_check(torch, attention):
    """Each kernel against its plain twin on the card. The backward kernels
    and twin share the kernel forward's lse and delta, so each comparison
    isolates one kernel."""
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    readings = {dtype: [0.0, 0.0, 0.0] for dtype in FLASH_TOL}  # l2, elem, lse
    n = run_flash_checks(torch, attention, FLASH_CHECKS, worst, readings, "flash-check")
    log(f"flash-check: {n} cases pass; largest readings (rel L2, worst element, lse) "
        f"{readings} against the limits {FLASH_TOL}")
    return worst


def run_flash_checks(torch, attention, cases, worst, readings, label, seed0=0):
    """The three kernels against their plain twins on ``cases``, each causal
    and not; the twin runs one (b, h) head at a time, or batch chunks past
    64 heads. Updates ``worst`` (max |d| by kernel) and ``readings`` (the
    largest rel L2, worst element and lse error by dtype); returns the
    number of cases run."""
    n = 0
    for name, b, lq, lk, h, dh, dtype, qo, ko in cases:
        l2_tol, elem_tol, lse_atol = FLASH_TOL[dtype]
        packed = name in FLASH_PACKED
        misaligned = name in FLASH_MISALIGNED
        for causal in (False, True):
            q, k, v, g = _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed=seed0 + n,
                                       packed=packed, misaligned=misaligned)
            check(not packed or q.data_ptr() + h * dh * q.element_size() == k.data_ptr(),
                  "the packed case's k is not a view into the qkv projection")
            design = attention.kernel_design(q, k, v, g)
            if misaligned:
                check(q.data_ptr() % 16 == q.element_size() and design == "mma",
                      f"{name}: a view {q.data_ptr() % 16} bytes off alignment runs {design}")
            by_design = dict(attention.design_launches)
            out, lse = attention.flash_attention(q, k, v, causal, qo, ko, return_lse=True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, lq).contiguous()
            dq, dk, dv = attention.flash_attention_bwd(q, k, v, g, lse, delta, causal, qo, ko)
            torch.cuda.synchronize()
            check(attention.design_launches[design] == by_design[design] + 3,
                  f"{name}: {design} launched {attention.design_launches[design] - by_design[design]}"
                  " of the three passes")
            rq, rk, rv, rg, lse2, delta2 = reference_inputs(
                dtype, q, k, v, g, lse.reshape(b, h, lq), delta.reshape(b, h, lq))
            if b * h <= 64:
                p_out, p_lse = _per_head(
                    torch, lambda bi, hi, q, k, v: attention.flash_attention_reference(
                        q, k, v, causal, qo, ko), q, k, v)
                p_dq, p_dk, p_dv = _per_head(
                    torch, lambda bi, hi, q, k, v, g: attention.flash_attention_bwd_reference(
                        q, k, v, g, lse2[bi, hi].contiguous(), delta2[bi, hi].contiguous(),
                        causal, qo, ko), rq, rk, rv, rg)
            else:
                p_out, p_lse = _batch_chunks(
                    torch, lambda b0, b1, q, k, v: attention.flash_attention_reference(
                        q, k, v, causal, qo, ko), q, k, v)
                p_dq, p_dk, p_dv = _batch_chunks(
                    torch, lambda b0, b1, q, k, v, g: attention.flash_attention_bwd_reference(
                        q, k, v, g, lse2[b0:b1].reshape(-1, lq), delta2[b0:b1].reshape(-1, lq),
                        causal, qo, ko), rq, rk, rv, rg)
            pairs = [("flash_fwd", "out", out, p_out), ("flash_dq", "dq", dq, p_dq),
                     ("flash_dkdv", "dk", dk, p_dk), ("flash_dkdv", "dv", dv, p_dv)]
            errs = {}
            for kern, what, a, ref in pairs:
                check(bool(torch.isfinite(a).all()), f"{what} not finite at {name} causal={causal}")
                err, l2, elem = flash_errors(torch, a, ref)
                check(l2 <= l2_tol and elem <= elem_tol,
                      f"flash {what} disagrees at {name} causal={causal}: rel L2 {l2:.3e} "
                      f"(limit {l2_tol}), worst element {elem:.3e} (limit {elem_tol})")
                worst[kern] = max(worst[kern], err)
                readings[dtype][0] = max(readings[dtype][0], l2)
                readings[dtype][1] = max(readings[dtype][1], elem)
                errs[what] = f"{err:.3e}/{l2:.3e}/{elem:.3e}"
            lse_err = (lse.reshape(-1) - p_lse.reshape(-1)).abs().max().item()
            check(lse_err <= lse_atol, f"flash lse disagrees at {name} causal={causal}: "
                  f"max|d|={lse_err:.3e}")
            worst["flash_fwd"] = max(worst["flash_fwd"], lse_err)
            readings[dtype][2] = max(readings[dtype][2], lse_err)
            if causal and ko > qo:  # rows 0 .. ko - qo - 1 see no key
                rows = out[:, :ko - qo].float()
                check(rows.abs().max().item() == 0.0 and dq[:, :ko - qo].abs().max().item() == 0.0,
                      "rows that see no key must have zero output and zero dq")
                check(lse.reshape(b, h, lq)[:, :, :ko - qo].max().item() < attention.NEG_INF / 2,
                      "rows that see no key must have an lse near NEG_INF")
            width = attention.kernel_width(dh)
            log(f"{label}: {name} {(b, lq, lk, h, dh)} {dtype} ({design} at {width}) "
                f"causal={causal} q_offset={qo} kv_offset={ko}{' packed' if packed else ''}"
                f"{' misaligned' if misaligned else ''}: "
                f"max|d|/relL2/element " + " ".join(
                    f"{w}={e}" for w, e in errs.items()) + f" lse={lse_err:.3e}")
            n += 1
            del q, k, v, g, rq, rk, rv, rg, out, lse, dq, dk, dv, p_out, p_lse, p_dq, p_dk, p_dv
            torch.cuda.empty_cache()
    return n


def flash_errors(torch, a, ref):
    """(max |a - ref|, ||a - ref|| / ||ref||, max |a - ref| / (|ref| + rms(ref)))
    in float32, or in float64 against a float64 twin."""
    wide = torch.float64 if ref.dtype == torch.float64 else torch.float32
    a, ref = a.to(wide), ref.to(wide)
    d = (a - ref).abs()
    rms = ref.square().mean().sqrt()
    return (d.max().item(), (d.norm() / ref.norm().clamp_min(1e-30)).item(),
            (d / (ref.abs() + rms.clamp_min(1e-30))).max().item())


def flash_flops(kernel, b, lq, lk, h, dh, causal):
    """The operations of one call: 2 per multiply-add of its products
    (forward 2, dQ 3, dK/dV 4), over the (query, key) pairs the causal mask
    keeps, at the true head width (not the instance's padded one)."""
    pairs = sum(min(lk, i + 1) for i in range(lq)) if causal else lq * lk
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkdv": 4}[kernel]
    return 2 * products * dh * pairs * b * h


def flash_bound_ms(kernel, b, lq, lk, h, dh, causal, dtype="bfloat16"):
    """Least time for the same work on this card: the larger of the
    operations over the dtype's peak (bf16 tensor cores 989 TFLOP/s; float32
    67 TFLOP/s outside the tensor cores) and the bytes (each input read
    once, each output written once) over 3.35 TB/s. Operations count only
    the (query, key) pairs the causal mask keeps."""
    flops = flash_flops(kernel, b, lq, lk, h, dh, causal)
    size = 2 if dtype == "bfloat16" else 4
    tile = b * h * dh * size  # one [B, L, H, Dh] row set per position
    rows = b * h * lq * 4  # one f32 value per query row
    nbytes = {
        "flash_fwd": tile * (lq + 2 * lk + lq) + rows,          # q, k, v -> out, lse
        "flash_dq": tile * (lq + 2 * lk + lq + lq) + 2 * rows,  # q, k, v, dO, lse, delta -> dq
        "flash_dkdv": tile * (lq + 2 * lk + lq + 2 * lk) + 2 * rows,  # ... -> dk, dv
    }[kernel]
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _device_ms(torch, fn, reps, by_name=None):
    """The card's busy time a call: every kernel, copy and memset that
    torch.profiler traces in ``reps`` calls after warm-up, over ``reps``;
    host work and the gaps between launches are left out. A dict given as
    ``by_name`` receives each kernel's ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then comes back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in tp.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(_dev_us(e) for e in kernels)
        if busy_us > 0:
            break
        log(f"profile: session {attempt} traced no device time; profiling again")
    check(busy_us > 0, "torch.profiler traced no device time in 3 sessions")
    if by_name is not None:
        by_name.update({e.key: _dev_us(e) / 1e3 / reps for e in kernels})
    return busy_us / 1e3 / reps


FLASH_TIME_TURNS = 3


def _launch_attrs(torch, fn):
    """What the profiler recorded of each kernel a call of ``fn``
    launches: {name: {grid, block, registers per thread, shared memory}},
    read from its Chrome trace (the launch's own record: shared memory is
    static plus dynamic, a CTA)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for _ in range(3):  # a lone launch's record is sometimes missing from the trace
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        tp.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    keys = ("grid", "block", "registers per thread", "shared memory")
    return {e["name"]: {k: e["args"][k] for k in keys if k in e.get("args", {})}
            for e in events if e.get("cat") == "kernel"}


def _host_us(torch, fn, batches=8, reps=50):
    """Host microseconds a call of a wrapper (checks, allocation, tensor
    maps, launch), the card's work left out (the queue never fills in
    ``reps`` calls of these kernels): the least mean over ``batches``
    batches, since the shared host only ever adds time."""
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / reps * 1e6


def phase_flash_time(torch, attention):
    """Device time a call (torch.profiler) of each kernel over 100 launches
    after warm-up, of the plain twins over 5 calls, and of SDPA forward and
    its autograd backward (dQ, dK and dV in one call, reported for both
    backward kernels) over 100, in FLASH_TIME_TURNS turns of kernel, plain,
    library; the median turn is reported, the spread printed."""
    out = {}
    for b, lq, h, dh in FLASH_TIME_SHAPES:
        out.update(flash_time_at(torch, attention, b, lq, h, dh, "bfloat16"))
    return out


def sdpa_backends(torch, q, k, v):
    """The fused SDPA backends (flash, efficient, cuDNN) that take these
    [B, H, L, Dh] inputs causal, forward and backward: each tried alone.
    The math backend (plain matmuls and softmax) takes everything and is
    left out."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    took = []
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        try:
            with sdpa_kernel([backend]):
                o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
                torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
            torch.cuda.synchronize()
            took.append(name)
        except RuntimeError:
            pass
    return took


def flash_time_at(torch, attention, b, lq, h, dh, dtype, reps=100, plain_reps=5, detail=True):
    """Phase 8's timing at one causal shape and dtype: {(b, lq, h, dh, name):
    {ms, plain_ms, bound_ms, bound_by, library_ms}}; checks that each pass
    launched the design KERNEL_DESIGNS names for (dtype, dh). ``detail``
    adds each wrapper's host time, the launches' attributes and the sm90
    tile plan."""
    import statistics

    import torch.nn.functional as F

    out = {}
    tag = "bf16" if dtype == "bfloat16" else "f32"
    design = attention.KERNEL_DESIGNS[(getattr(torch, dtype), dh)]
    q, k, v, g = _flash_inputs(torch, b, lq, lq, h, dh, dtype, seed=123)
    o, lse = attention.flash_attention(q, k, v, True, return_lse=True)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, lq).contiguous()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    calls = {
        "flash_fwd": (reps, lambda: attention.flash_attention(q, k, v, True, return_lse=True)),
        "flash_dq": (reps, lambda: attention.flash_attention_dq(q, k, v, g, lse, delta, True)),
        "flash_dkdv": (reps, lambda: attention.flash_attention_dkdv(
            q, k, v, g, lse, delta, True)),
        "plain_fwd": (plain_reps, lambda: attention.flash_attention_reference(q, k, v, True)),
        "plain_bwd": (plain_reps, lambda: attention.flash_attention_bwd_reference(
            q, k, v, g, lse, delta, True)),
        "lib_fwd": (reps, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "lib_bwd": (reps, lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)),
    }
    log(f"flash-time: SDPA backends that take {(b, lq, h, dh)} {tag} causal: "
        f"{', '.join(sdpa_backends(torch, qt, kt, vt)) or 'none'}")
    turns = {key: [] for key in calls}
    names = {key: {} for key in calls}  # kernel names each call launched
    for turn in range(FLASH_TIME_TURNS):
        for key, (n, fn) in calls.items():
            turns[key].append(_device_ms(torch, fn, n, names[key]))
        log(f"flash-time: turn {turn} at {(b, lq, h, dh)} {tag} causal, device ms a call: "
            + " ".join(f"{key} {val[-1]:.6f}" for key, val in turns.items()))
    times = {key: statistics.median(val) for key, val in turns.items()}
    log(f"flash-time: at {(b, lq, h, dh)} {tag}, median (min-max) over {FLASH_TIME_TURNS} "
        f"turns: " + "; ".join(f"{key} {times[key]:.6f} ({min(val):.6f}-{max(val):.6f})"
                               for key, val in turns.items()))
    passes = ("flash_fwd", "flash_dq", "flash_dkdv")
    host = {name: _host_us(torch, calls[name][1]) for name in passes} if detail else {}
    for name in passes:
        if detail:
            for kernel, attrs in _launch_attrs(torch, calls[name][1]).items():
                log(f"flash-time: {name} at {(b, lq, h, dh)} launches {kernel[:70]}: {attrs}")
        # each pass launches the design run_dtype dispatches (dtype, dh) to
        want = (f"{name}_sm90_kernel" if design == "sm90" else f"{name}_wide_kernel"
                if attention.kernel_width(dh) == attention.WIDE else f"{name}_kernel")
        check(any(want in kernel for kernel in names[name]),
              f"{name} at {(b, lq, h, dh)} {tag} launched {list(names[name])}, not {want}")
    for name in passes:
        bound, by = flash_bound_ms(name, b, lq, lq, h, dh, True, dtype)
        bwd = name != "flash_fwd"
        lib = times["lib_bwd" if bwd else "lib_fwd"]
        out[(b, lq, h, dh, name)] = {
            "ms": times[name],
            "plain_ms": times["plain_bwd" if bwd else "plain_fwd"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": lib,
        }
        tflops = flash_flops(name, b, lq, lq, h, dh, True) / (times[name] * 1e-3) / 1e12
        log(f"flash-time: {name} at {(b, lq, h, dh)} {tag} ({design}): kernel "
            f"{times[name]:.6f} ms, {tflops:.1f} TFLOP/s, bound {bound:.6f} ms ({by}), "
            f"{bound / times[name]:.4f} of the bound; plain "
            f"{out[(b, lq, h, dh, name)]['plain_ms']:.6f} ms; library {lib:.6f} ms "
            f"({'SDPA backward, dQ+dK+dV' if bwd else 'SDPA forward'}), kernel / library "
            f"{times[name] / lib:.3f}" + (f"; host {host[name]:.1f} us a call" if detail else ""))
    if detail and design == "sm90":
        for which, name in (("fwd", "flash_fwd"), ("dq", "flash_dq"), ("dkdv", "flash_dkdv")):
            states = [s for _, tiles in attention.sm90_tile_plan(which, lq, lq, True)
                      for _, pair in tiles for s in pair]
            log(f"flash-time: {name} at {(b, lq, h, dh)}: a head's warpgroup tiles "
                + ", ".join(f"{s} {states.count(s)}" for s in ("full", "cut", "skip")))
    log(f"flash-time: SDPA at {(b, lq, h, dh)} {tag} launched: forward "
        f"{sorted(k[:50] for k in names['lib_fwd'])}, backward "
        f"{sorted(k[:50] for k in names['lib_bwd'])}")
    pair = times["flash_dq"] + times["flash_dkdv"]
    log(f"flash-time: backward pair dQ + dK/dV at {(b, lq, h, dh)} {tag}: {pair:.6f} ms "
        f"against SDPA's backward {times['lib_bwd']:.6f} ms: {pair / times['lib_bwd']:.3f}x")
    del q, k, v, g, o, lse, delta, qt, kt, vt, gt, ot, calls
    torch.cuda.empty_cache()
    return out


# --- the transformer LM ---------------------------------------------------------

LM_CONFIG = dict(vocab_size=8192, d_model=512, n_heads=4, n_layers=4, d_ff=2048,
                 max_len=2048, dtype="bfloat16", loss_chunk=1024)
LM_BATCH, LM_LEN, LM_LR = 8, 1024, 1e-3
LM_PARITY_CONFIG = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                        max_len=128, dtype="float32")
# a tenth of one Adam step (lr 1e-3): far above float32 reordering, far below
# an update whose sign flipped
LM_PARITY_ATOL = 1e-4


def copy_task_batches(n, b, l, vocab, seed, n_patterns=16):
    """[n, b, l] tokens, targets and masks: each sequence repeats a 4-token
    pattern drawn from a seeded pool of ``n_patterns``, so the next token is
    predictable and every batch draws on the same tokens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pool = rng.randint(1, vocab, size=(n_patterns, 4))
    base = pool[rng.randint(0, n_patterns, size=(n, b))]
    toks = np.tile(base, (1, 1, l // 4 + 1))[:, :, : l + 1]
    return (toks[:, :, :-1].astype(np.int64), toks[:, :, 1:].astype(np.int64),
            np.ones((n, b, l), np.float32))


def _lm_trainer(seed, device="cuda", **cfg):
    from omldm_tpu_torch.models.transformer import TransformerConfig
    from omldm_tpu_torch.parallel import SeqTrainer

    return SeqTrainer(TransformerConfig(**cfg), device=device, lr=LM_LR, seed=seed)


def phase_lm(torch, attention, steps, seed):
    from omldm_tpu_torch.models import generate, lm_loss
    from omldm_tpu_torch.models.transformer import tree_leaves

    trainer = _lm_trainer(seed, **LM_CONFIG)
    cfg = trainer.cfg
    tok, tgt, mask = copy_task_batches(steps + 1, LM_BATCH, LM_LEN, cfg.vocab_size, seed)
    t0 = time.perf_counter()
    warm = float(trainer.step(tok[0], tgt[0], mask[0]))
    torch.cuda.synchronize()
    log(f"lm: warm-up step {time.perf_counter() - t0:.3f} s, loss {warm:.4f}")
    torch.cuda.reset_peak_memory_stats()
    for name in attention.launches:
        attention.launches[name] = 0
    t0 = time.perf_counter()
    losses = trainer.step_many(tok[1:], tgt[1:], mask[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(attention.launches)
    losses = losses.float().cpu().tolist()
    tokens = steps * LM_BATCH * LM_LEN
    peak = torch.cuda.max_memory_allocated()
    log(f"lm: {steps} steps in {wall:.4f} s: {wall / steps * 1e3:.3f} ms/step, "
        f"{tokens / wall:.0f} tokens/s, peak memory {peak / 2**30:.3f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {launches}")
    check(all(x == x and abs(x) < float("inf") for x in losses), "an LM loss is not finite")
    # the warm-up batch's loss before any update, against the same batch's
    # loss after all of them
    with torch.no_grad():
        after = float(lm_loss(cfg, trainer.params, *(torch.as_tensor(a[0], device="cuda")
                                                     for a in (tok, tgt, mask))))
    log(f"lm: loss on the warm-up batch {warm:.4f} before training, {after:.4f} after")
    check(after < warm, f"the LM loss did not fall: {warm} -> {after}")
    want = cfg.n_layers * steps
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times in the LM phase, expected {want}")
    tensors = tree_leaves(trainer.params) + tree_leaves(trainer.opt)
    check(all(t.device.type == "cuda" for t in tensors),
          "a parameter or optimizer tensor is not on cuda")
    check(trainer.fitted == (steps + 1) * LM_BATCH * LM_LEN, "fitted token count is off")

    before = dict(attention.launches)
    t0 = time.perf_counter()
    prompt = torch.as_tensor(tok[0][:2, :64], device="cuda")
    gen = generate(cfg, trainer.params, prompt, 32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(gen.shape == (2, 32) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
          "generate returned tokens out of range")
    check(attention.launches == before, "a flash kernel ran on the decode path")
    log(f"lm: greedy generate 2 x 32 tokens after a 64-token prompt in {gen_s:.3f} s "
        f"(no kernel launched); first row {gen[0, :12].tolist()}")
    log("lm: " + json.dumps({
        "steps": steps, "batch": LM_BATCH, "context": LM_LEN, "wall_s": wall,
        "ms_per_step": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "peak_memory_bytes": peak, "losses": losses, "warmup_batch_loss": [warm, after],
        "launches": launches,
    }))
    return launches, trainer, wall / steps * 1e3


def phase_lm_parity(torch, seed):
    import numpy as np

    from omldm_tpu_torch.models import generate
    from omldm_tpu_torch.models.transformer import tree_leaves

    cfg = LM_PARITY_CONFIG
    tok, tgt, mask = copy_task_batches(3, 4, 128, cfg["vocab_size"], seed + 1)
    start = _lm_trainer(seed, device="cpu", **cfg).host_params()  # numpy parameters
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = _lm_trainer(seed, device=device, **cfg)
        trainer.load_numpy(start)
        losses = trainer.step_many(tok, tgt, mask).cpu().numpy()
        prompt = torch.as_tensor(tok[0][:, :16], device=device)
        gen = generate(trainer.cfg, trainer.params, prompt, 24).cpu().numpy()
        runs[device] = (losses, tree_leaves(trainer.host_params()), gen)
    (lc, pc, gc), (lp, pp, gp) = runs["cuda"], runs["cpu"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(pc, pp))
    log(f"lm-parity: float32 {cfg}, 3 steps cuda vs cpu: losses {lc.tolist()} vs "
        f"{lp.tolist()}, final params max|d|={err:.3e} (atol {LM_PARITY_ATOL}), greedy "
        f"tokens equal: {bool((gc == gp).all())}")
    check(err <= LM_PARITY_ATOL, f"LM params differ between cuda and cpu: {err}")
    check(bool((gc == gp).all()), "greedy tokens differ between cuda and cpu")


def phase_lm_profile(torch, attention, trainer, out_dir: Path, seed, tag="lm"):
    """4 LM steps under torch.profiler: device busy time, the flash kernels'
    share, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    tok, tgt, mask = copy_task_batches(4, LM_BATCH, LM_LEN, trainer.cfg.vocab_size, seed + 7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        trainer.step_many(tok, tgt, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = tp.key_averages()
    (out_dir / f"{tag}_torch.txt").write_text(avg.table(sort_by="self_cpu_time_total",
                                                        row_limit=60))
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kernels) / 1e6
    flash = sum(_dev_us(e) for e in kernels if "flash_" in e.key) / 1e6
    log(f"{tag}-profile: 4 steps, wall {wall:.4f} s under the profiler; device busy "
        f"{busy:.4f} s ({busy / wall:.3f} of the wall), flash kernels {flash:.4f} s "
        f"({flash / max(busy, 1e-12):.3f} of busy); top kernels:")
    for e in sorted(kernels, key=lambda e: -_dev_us(e))[:12]:
        log(f"  {_dev_us(e) / 1e3:.3f} ms, {e.count} launches: {e.key[:100]}")
    return busy, flash, wall


# --- phases 43-45: the sequence-model family on one card --------------------

# phase 43: the head widths and dtypes the JAX kernels take, each causal and
# not: float32 at dh 128; dh 8 (the JAX tests' and the graft's width), 12
# (rows that are not whole 16-byte groups in bf16), 16, 36 and 100 (bf16
# rows of odd 8-byte groups: mma.sync at 64 and 128), 48 (bf16: the Hopper
# instance at 64, its TMA box wider than the rows), 80, 96 and 256 in both
# dtypes, square and ragged; B * H = 131,072 (past the grid's y limit) on
# the Hopper design and on mma.sync
FLASH_COVERAGE_CHECKS = [
    ("f32_dh128", 8, 1024, 1024, 4, 128, "float32", 0, 0),
    ("f32_dh128_ragged", 2, 1000, 1100, 4, 128, "float32", 0, 0),
    *[(f"{dtype}_dh{dh}{tag}", 2, lq, lk, 2 if dh == 256 else 4, dh, dtype, 0, 0)
      for dtype in ("bfloat16", "float32") for dh in (8, 12, 16, 36, 48, 80, 96, 100, 256)
      for tag, lq, lk in (("", 1024, 1024), ("_ragged", 1000, 1100))],
    ("bh131072", 32768, 64, 64, 4, 64, "bfloat16", 0, 0),
    ("bh131072_mma", 32768, 64, 64, 4, 8, "float32", 0, 0),
]
# the wide instance (every head width past 256, one instance a type): dh
# 320 (a ragged last chunk in both types) and 512 in both dtypes, square and
# ragged, each causal and not; and a bf16 dh-128 case whose views are 2
# bytes off 16-byte alignment (the Hopper width on mma.sync)
FLASH_WIDE_CHECKS = [
    *[(f"{dtype}_dh{dh}{tag}", 2, lq, lk, 2, dh, dtype, 0, 0)
      for dtype in ("bfloat16", "float32") for dh in (320, 512)
      for tag, lq, lk in (("", 1024, 1024), ("_ragged", 1000, 1100))],
    ("misaligned_dh128", 2, 1024, 1024, 4, 128, "bfloat16", 0, 0),
]
# (B, L, H, Dh, dtype) timed as phase 8 times its shapes
FLASH_COVERAGE_TIME = [(8, 1024, 4, 128, "float32"), (2, 1024, 4, 8, "bfloat16"),
                       (2, 1024, 4, 80, "bfloat16"), (2, 1024, 4, 256, "bfloat16"),
                       (2, 1024, 4, 512, "bfloat16"), (2, 1024, 4, 512, "float32")]
# phase 44: the LM of phase 9 with Switch-Base-8's switch layer (8 experts,
# capacity factor 1.25; Fedus et al. 2021, section 2.1 and Table 1) and remat
LM_MOE_CONFIG = dict(LM_CONFIG, n_experts=8, capacity_factor=1.25, remat=True)
LM_MOE_NO_REMAT_STEPS = 2
# phase 45: phase 9's LM in float32; the parity config as a remat MoE; the
# JAX package's own MoE dry-run width (__graft_entry__.py: d 16, 2 heads)
LM_F32_STEPS = 4
LM_MOE_PARITY_CONFIG = dict(LM_PARITY_CONFIG, n_experts=4, remat=True)
GRAFT_MOE_CONFIG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                        max_len=64, n_experts=4)
LOSS_PARITY_ATOL = 1e-5


def phase_flash_coverage(torch, attention):
    """Phase 43: the forward, dQ and dK/dV kernels against their plain twins
    at every (dtype, head width) design of FLASH_COVERAGE_CHECKS and at
    B * H = 131,072, then at the wide instance's widths and on a misaligned
    view (FLASH_WIDE_CHECKS), each set with its own largest readings; then
    device times at FLASH_COVERAGE_TIME."""
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    for label, cases, seed0 in (("flash-coverage", FLASH_COVERAGE_CHECKS, 1000),
                                ("flash-wide", FLASH_WIDE_CHECKS, 2000)):
        readings = {dtype: [0.0, 0.0, 0.0] for dtype in FLASH_TOL}
        for name in attention.launches:
            attention.launches[name] = 0
        n = run_flash_checks(torch, attention, cases, worst, readings, label, seed0=seed0)
        check(all(v == 2 * len(cases) for v in attention.launches.values()),
              f"{label}: launches {attention.launches}, expected {2 * len(cases)} each")
        log(f"{label}: {n} cases pass; largest readings (rel L2, worst element, lse) "
            f"{readings} against the limits {FLASH_TOL}; float32 worst element "
            f"{readings['float32'][1]:.4e}")
    times = {}
    for b, lq, h, dh, dtype in FLASH_COVERAGE_TIME:
        for key, val in flash_time_at(torch, attention, b, lq, h, dh, dtype, reps=20,
                                      plain_reps=2, detail=False).items():
            times[(*key[:4], dtype, key[4])] = val
    return worst, times


def _moe_routes(transformer):
    """Records the keep mask and expert of every moe_route call until the
    context exits: a list the caller reads."""
    routes = []
    orig = transformer.moe_route

    def record(layer, t, capacity_factor):
        out = orig(layer, t, capacity_factor)
        routes.append((out[0].detach(), out[2].detach()))
        return out

    @contextlib.contextmanager
    def ctx():
        transformer.moe_route = record
        try:
            yield routes
        finally:
            transformer.moe_route = orig

    return ctx()


def _grad_peak(torch, trainer, tok, tgt, mask):
    """Bytes a loss-and-gradient pass of ``trainer`` (its step without the
    Adam update) allocates above what is resident before it, at its peak:
    the activations remat trades for recomputation. (A whole step's peak is
    the Adam update's, which holds the old and new parameter and optimizer
    trees at once whether remat is on or not.)"""
    from omldm_tpu_torch.models.transformer import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainer.params)]
    params = tree_unflatten(trainer.params, leaves)
    batch = [trainer._as_device(a, dt) for a, dt in ((tok, torch.long), (tgt, torch.long),
                                                      (mask, torch.float32))]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(trainer._loss(params, *batch), leaves)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads, leaves, params
    return peak


def phase_lm_moe(torch, attention, seed, profile_dir=None):
    """Phase 44: SeqTrainer at LM_MOE_CONFIG (the LM's full width, 8 switch
    experts, capacity 1.25, remat): a warm-up step, then --lm-steps steps;
    the warm-up batch's loss falls, the flash forward runs 2 x layers a
    step (remat runs it again in the backward) and dQ, dK/dV once a layer;
    the share of tokens dropped at capacity on the last step; then the same
    trainer without remat for LM_MOE_NO_REMAT_STEPS steps: both steps' peak
    memory printed, and the loss-and-gradient pass's peak above the
    resident state (_grad_peak) must be lower with remat; generate refuses
    the config as the JAX package does."""
    from omldm_tpu_torch.models import generate, lm_loss
    from omldm_tpu_torch.models import transformer

    steps = 8
    trainer = _lm_trainer(seed, **LM_MOE_CONFIG)
    cfg = trainer.cfg
    tok, tgt, mask = copy_task_batches(steps + 1, LM_BATCH, LM_LEN, cfg.vocab_size, seed + 3)
    t0 = time.perf_counter()
    warm = float(trainer.step(tok[0], tgt[0], mask[0]))
    torch.cuda.synchronize()
    log(f"lm-moe: warm-up step {time.perf_counter() - t0:.3f} s, loss {warm:.4f}")
    torch.cuda.reset_peak_memory_stats()
    for name in attention.launches:
        attention.launches[name] = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(1, steps):
        losses.append(trainer.step(tok[i], tgt[i], mask[i]))
    with _moe_routes(transformer) as routes:  # the last step: its forward routes first
        losses.append(trainer.step(tok[steps], tgt[steps], mask[steps]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(attention.launches)
    losses = [float(x) for x in losses]
    kept = torch.stack([keep for _, keep in routes[:cfg.n_layers]]).float()
    dropped = 1.0 - float(kept.mean())
    loads = torch.stack([torch.bincount(e, minlength=cfg.n_experts)
                         for e, _ in routes[:cfg.n_layers]]).tolist()
    tokens = steps * LM_BATCH * LM_LEN
    log(f"lm-moe: {steps} steps in {wall:.4f} s: {wall / steps * 1e3:.3f} ms/step, "
        f"{tokens / wall:.0f} tokens/s, peak memory {peak / 2**30:.3f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {launches}; last step "
        f"dropped {dropped:.4f} of tokens at capacity; tokens an expert by layer {loads}")
    check(all(x == x and abs(x) < float("inf") for x in losses), "an MoE LM loss is not finite")
    with torch.no_grad():
        after = float(lm_loss(cfg, trainer.params, *(torch.as_tensor(a[0], device="cuda")
                                                     for a in (tok, tgt, mask))))
    log(f"lm-moe: loss on the warm-up batch {warm:.4f} before training, {after:.4f} after")
    check(after < warm, f"the MoE LM loss did not fall: {warm} -> {after}")
    want = {"flash_fwd": 2 * cfg.n_layers * steps, "flash_dq": cfg.n_layers * steps,
            "flash_dkdv": cfg.n_layers * steps}
    check(launches == want, f"lm-moe: launches {launches}, expected {want}")
    try:
        generate(cfg, trainer.params, torch.as_tensor(tok[0][:1, :8], device="cuda"), 4)
        check(False, "generate ran an MoE config")
    except ValueError as err:
        check("decode supports dense transformer configs" in str(err), f"generate: {err}")
        log(f"lm-moe: generate refuses the config: {err}")
    if profile_dir is not None:
        phase_lm_profile(torch, attention, trainer, profile_dir, seed, tag="lm-moe")
    remat_grad = _grad_peak(torch, trainer, tok[0], tgt[0], mask[0])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    plain = _lm_trainer(seed, **dict(LM_MOE_CONFIG, remat=False))
    plain.step(tok[0], tgt[0], mask[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(1, LM_MOE_NO_REMAT_STEPS + 1):
        plain.step(tok[i], tgt[i], mask[i])
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / LM_MOE_NO_REMAT_STEPS
    plain_peak = torch.cuda.max_memory_allocated()
    plain_grad = _grad_peak(torch, plain, tok[0], tgt[0], mask[0])
    log(f"lm-moe: without remat {plain_wall * 1e3:.3f} ms/step, a step's peak memory "
        f"{plain_peak / 2**30:.3f} GiB against remat's {peak / 2**30:.3f} GiB "
        f"({peak / plain_peak:.4f}x; the Adam update sets both); the loss-and-gradient "
        f"pass's peak above the resident state {plain_grad / 2**30:.3f} GiB against "
        f"remat's {remat_grad / 2**30:.3f} GiB ({remat_grad / plain_grad:.4f}x)")
    check(remat_grad < plain_grad,
          f"remat did not lower the activations' peak: {remat_grad} >= {plain_grad}")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    result = {"steps": steps, "ms_per_step": wall / steps * 1e3, "tokens_per_s": tokens / wall,
              "peak_memory_bytes": peak, "no_remat_peak_memory_bytes": plain_peak,
              "grad_pass_peak_bytes": remat_grad, "no_remat_grad_pass_peak_bytes": plain_grad,
              "no_remat_ms_per_step": plain_wall * 1e3, "dropped_share_last_step": dropped,
              "losses": losses, "warmup_batch_loss": [warm, after], "launches": launches}
    log("lm-moe: " + json.dumps(result))
    return launches


def _parity_steps(torch, transformer, cfg, start, batches, device):
    """3 steps from numpy parameters on ``device``: the losses, the numpy
    parameters and the last step's forward routes (expert, keep) by layer."""
    import numpy as np

    from omldm_tpu_torch.models.transformer import tree_leaves

    trainer = _lm_trainer(0, device=device, **cfg)
    trainer.load_numpy(start)
    losses = []
    tok, tgt, mask = batches
    for i in range(len(tok) - 1):
        losses.append(float(trainer.step(tok[i], tgt[i], mask[i])))
    with _moe_routes(transformer) as routes:
        losses.append(float(trainer.step(tok[-1], tgt[-1], mask[-1])))
    fwd = [(e.cpu().numpy(), k.cpu().numpy()) for e, k in routes[:trainer.cfg.n_layers]]
    return np.asarray(losses), tree_leaves(trainer.host_params()), fwd


def phase_lm_f32_and_parity(torch, attention, seed, bf16_ms):
    """Phase 45: (a) phase 9's LM at float32 (the float32 dh-128 instances),
    LM_F32_STEPS steps, the loss falls, n_layers x steps launches of each
    kernel; (b) LM_MOE_PARITY_CONFIG (MoE, remat, float32) 3 steps on the
    card and on the CPU from the same numpy parameters: routes equal,
    parameters within LM_PARITY_ATOL, losses within LOSS_PARITY_ATOL; (c)
    GRAFT_MOE_CONFIG (dh 8) 3 steps on the card, finite losses that fall."""
    import numpy as np

    from omldm_tpu_torch.models import lm_loss
    from omldm_tpu_torch.models import transformer

    cfg32 = dict(LM_CONFIG, dtype="float32")
    trainer = _lm_trainer(seed, **cfg32)
    tok, tgt, mask = copy_task_batches(LM_F32_STEPS + 1, LM_BATCH, LM_LEN, LM_CONFIG["vocab_size"],
                                       seed + 5)
    warm = float(trainer.step(tok[0], tgt[0], mask[0]))
    torch.cuda.synchronize()
    for name in attention.launches:
        attention.launches[name] = 0
    t0 = time.perf_counter()
    losses = trainer.step_many(tok[1:], tgt[1:], mask[1:]).cpu().tolist()
    wall = time.perf_counter() - t0
    launches = dict(attention.launches)
    with torch.no_grad():
        after = float(lm_loss(trainer.cfg, trainer.params,
                              *(torch.as_tensor(a[0], device="cuda") for a in (tok, tgt, mask))))
    ms = wall / LM_F32_STEPS * 1e3
    log(f"lm-f32: {LM_F32_STEPS} float32 steps, {ms:.3f} ms/step against phase 9's bf16 "
        f"{bf16_ms:.3f} ms/step ({ms / bf16_ms:.3f}x); losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; warm-up batch {warm:.4f} -> {after:.4f}; launches {launches}")
    check(after < warm, f"the float32 LM loss did not fall: {warm} -> {after}")
    want = LM_CONFIG["n_layers"] * LM_F32_STEPS
    check(all(n == want for n in launches.values()),
          f"lm-f32: launches {launches}, expected {want} each")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    cfg = LM_MOE_PARITY_CONFIG
    batches = copy_task_batches(3, 4, 128, cfg["vocab_size"], seed + 1)
    start = _lm_trainer(seed, device="cpu", **cfg).host_params()
    card = _parity_steps(torch, transformer, cfg, start, batches, "cuda")
    cpu = _parity_steps(torch, transformer, cfg, start, batches, "cpu")
    routes_equal = all((a[0] == b[0]).all() and (a[1] == b[1]).all()
                       for a, b in zip(card[2], cpu[2]))
    err = max(float(np.abs(a - b).max()) for a, b in zip(card[1], cpu[1]))
    loss_err = float(np.abs(card[0] - cpu[0]).max())
    dropped = [float(1.0 - k.mean()) for _, k in card[2]]
    log(f"lm-moe-parity: {cfg}, 3 steps cuda vs cpu: losses {card[0].tolist()} vs "
        f"{cpu[0].tolist()} (max|d| {loss_err:.3e}, atol {LOSS_PARITY_ATOL}); params "
        f"max|d|={err:.3e} (atol {LM_PARITY_ATOL}); last step's (expert, keep) equal for "
        f"every token: {routes_equal}; dropped share by layer {dropped}")
    check(routes_equal, "MoE routes differ between cuda and cpu")
    check(err <= LM_PARITY_ATOL, f"MoE LM params differ between cuda and cpu: {err}")
    check(loss_err <= LOSS_PARITY_ATOL, f"MoE LM losses differ between cuda and cpu: {loss_err}")

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 64, size=(4, 16))
    tgts = np.roll(toks, -1, axis=1)
    graft = _lm_trainer(seed, **GRAFT_MOE_CONFIG)
    before = dict(attention.launches)
    g_losses = [float(graft.step(toks, tgts)) for _ in range(3)]
    g_launches = {k: attention.launches[k] - before[k] for k in before}
    log(f"lm-graft-moe: {GRAFT_MOE_CONFIG} (dh 8) on the card, 3 steps: losses {g_losses}; "
        f"launches {g_launches}")
    check(all(np.isfinite(g_losses)) and g_losses[-1] < g_losses[0],
          f"the graft MoE losses are not finite and falling: {g_losses}")
    check(all(n == 3 for n in g_launches.values()), f"lm-graft-moe: launches {g_launches}")
    return launches, g_launches


def phase_sequence_family(torch, attention, seed, lm_ms, profile_dir=None):
    """Phases 43-45, each lapped."""
    coverage_err, coverage_times = phase_flash_coverage(torch, attention)
    lap("flash coverage")
    moe_launches = phase_lm_moe(torch, attention, seed, profile_dir)
    lap("lm-moe")
    f32_launches, graft_launches = phase_lm_f32_and_parity(torch, attention, seed, lm_ms)
    lap("lm-f32 and lm-moe-parity")
    return coverage_err, coverage_times, moe_launches, f32_launches, graft_launches


# --- the sparse (padded-COO) path ------------------------------------------------

CRITEO_HASH = 1 << 18
CRITEO_DIM = 13 + CRITEO_HASH      # nFeatures: 13 numerics + the hashed space
CRITEO_NNZ = 40                    # maxNnz: 39 active slots and one pad
AVAZU_DIM = 1 << 20                # 21 categorical slots hashed into 2^20
AVAZU_SLOTS = 21
# phases 14 and 16 (phase 14 cut from 100,000 for the script's time limit)
SPARSE_RECORDS, AVAZU_RECORDS = 50_000, 20_000
# (B, K) into w[CRITEO_DIM + 1]: one record and a micro-batch of the slice
# (K = maxNnz + the bias slot), and the experiment's 4096 x 39
SPARSE_CHECKS = [(1, CRITEO_NNZ + 1), (256, CRITEO_NNZ + 1), (4096, 39)]
# the outer entry point: (B, K, D, C) of a ragged Avazu Softmax batch
OUTER_CHECK = (255, AVAZU_SLOTS + 1, AVAZU_DIM + 1, 2)
# (name, B, K, D, C, draw) timed in place: the slice's shape (Criteo draw,
# then uniform), the experiment's (Criteo, uniform, a pool of 64) and the
# Avazu Softmax's; the first of each name feeds the kernels line
SPARSE_TIME_SHAPES = [
    ("slice", 256, CRITEO_NNZ + 1, CRITEO_DIM + 1, 1, "criteo"),
    ("slice", 256, CRITEO_NNZ + 1, CRITEO_DIM + 1, 1, "uniform"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "criteo"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "uniform"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "pool64"),
    ("avazu", 256, AVAZU_SLOTS + 1, AVAZU_DIM + 1, 2, "avazu"),
]
# what the stream shapes also time: the plain version in place and the
# copying forms (the kernel of PRs 3-5 and torch.index_add)
SPARSE_TIME_FULL = {("slice", "criteo"), ("avazu", "avazu")}
SPARSE_TIME_TURNS = 3


def _scatter_inputs(torch, b, k, d, c, draw, seed, device="cuda"):
    """w[d] (or [d, c]), idx[b, k] int32, coef[b] (or [b, c]), val[b, k] on
    the card. ``draw``: "uniform" indices in [0, d); "pool64", every index
    from a pool of 64; "criteo" and "avazu", the learners' layouts --
    hashed slots in [13, d - 1) after 13 numeric slots at 0..12 in every
    record (criteo) or in [0, d - 1) (avazu), then the bias slot d - 1 with
    value 1; criteo's maxNnz = 40 holds its 39 active slots and one pad
    slot (0, 0). Rows and pad slots are masked with zeros; index (0, 1)
    lies past d, with a large update, and must be dropped."""
    import numpy as np

    rng = np.random.RandomState(seed)
    val = rng.randn(b, k)
    if draw == "uniform":
        idx = rng.randint(0, d, size=(b, k))
    elif draw == "pool64":
        idx = rng.choice(rng.randint(0, d, size=64), size=(b, k))
    elif draw == "criteo":
        idx = rng.randint(13, d - 1, size=(b, k))
        idx[:, :13] = np.arange(13)
        idx[:, -2], val[:, -2] = 0, 0.0       # the pad slot
    else:
        idx = rng.randint(0, d - 1, size=(b, k))
    if draw in ("criteo", "avazu"):
        idx[:, -1], val[:, -1] = d - 1, 1.0   # the bias slot
    else:
        idx[::3, -1], val[::3, -1] = 0, 0.0   # pad slots
    cshape = (b,) if c == 1 else (b, c)
    coef = rng.randn(*cshape) * 0.1
    coef[rng.rand(b) < 0.2] = 0.0             # masked rows
    if b > 8:
        coef[-(b // 8):] = 0.0                # a ragged tail
    coef[0] = 1.5
    if k > 1:
        idx[0, 1], val[0, 1] = d + 7, 1000.0  # out of range: dropped
    w = rng.randn(*((d,) if c == 1 else (d, c)))
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)  # noqa: E731
    return (as_t(w, np.float32), as_t(idx, np.int32), as_t(coef, np.float32),
            as_t(val, np.float32))


def scatter_limit(torch, w, idx, coef, val):
    """Per-element limit of |kernel - plain|: two float32 sums of the same
    m + 1 terms (w and the m updates landing on the element) in other
    orders differ by at most 2 m 2^-24 (|w| + sum |u|) -- the worst case of
    recursive summation, so the sound kernel's atomics sit far inside it,
    while one update lost or added anywhere with few duplicates does not."""
    from omldm_tpu_torch.ops.sparse import sparse_scatter_add_reference

    absu = sparse_scatter_add_reference(torch.zeros_like(w), idx, coef.abs(), val.abs())
    ones = torch.ones_like(coef)
    hits = sparse_scatter_add_reference(torch.zeros_like(w), idx, ones, torch.ones_like(val))
    return 2.0 * (hits + 1.0) * 2.0 ** -24 * (w.abs() + absu)


def phase_sparse_check(torch, sparse):
    """The kernel (both entry points), copying and in place, against its
    plain version; then the sparse learners through ``MLPipeline.fit`` on the
    card, which must scatter into the donated w without a copy. Returns the
    largest |kernel - plain|."""
    cases = [(b, k, CRITEO_DIM + 1 if k == CRITEO_NNZ + 1 else CRITEO_DIM, 1, draw)
             for b, k in SPARSE_CHECKS for draw in ("uniform", "pool64", "criteo")]
    cases += [(*OUTER_CHECK, draw) for draw in ("uniform", "pool64", "avazu")]
    worst_abs = worst_ratio = 0.0
    n_checks = 0
    for n, (b, k, d, c, draw) in enumerate(cases):
        w, idx, coef, val = _scatter_inputs(torch, b, k, d, c, draw, seed=100 + n)
        entry = sparse.sparse_scatter_add if c == 1 else sparse.sparse_scatter_add_outer
        name = "scatter_add" if c == 1 else "scatter_add_outer"
        kept = w.clone()
        limit = scatter_limit(torch, w, idx, coef, val)
        plain = sparse.sparse_scatter_add_reference(w, idx, coef, val)
        plain_in = sparse.sparse_scatter_add_reference(w.clone(), idx, coef, val, inplace=True)
        copied = entry(w, idx, coef, val)
        w_in = w.clone()
        check(entry(w_in, idx, coef, val, inplace=True) is w_in,
              f"{name} in place did not return its w")
        torch.cuda.synchronize()
        check(torch.equal(w, kept), f"{name} (copying) wrote into its input at {(b, k, d, c, draw)}")
        for form, out, want in (("copy", copied, plain), ("in place", w_in, plain_in)):
            check(bool(torch.isfinite(out).all()), f"{name} {form} output not finite at "
                  f"{(b, k, d, c, draw)}")
            err = (out - want).abs()
            ratio = (err / limit).max().item()
            worst_abs, worst_ratio = max(worst_abs, err.max().item()), max(worst_ratio, ratio)
            n_checks += 1
            log(f"sparse-check: {name} {form} (B, K, D, C)={(b, k, d, c)} {draw}: "
                f"max|d|={err.max().item():.3e}, largest |d|/limit {ratio:.3e}")
            check(ratio <= 1.0, f"{name} {form} disagrees with its plain version at "
                  f"{(b, k, d, c, draw)}: |d|/limit {ratio:.3e}")
    log(f"sparse-check: {n_checks} checks ({len(cases)} cases, copying and in place) pass; "
        f"largest |d| {worst_abs:.3e}; largest reading |d| / (2 (m+1) 2^-24 (|w| + sum|u|)) "
        f"{worst_ratio:.3e} against the limit 1")
    _check_donated_fits(torch, sparse)
    return worst_abs


def _check_donated_fits(torch, sparse):
    """Three fits of a sparse PA-II pipeline at the Criteo width and of a
    sparse Softmax at Avazu's, through ``MLPipeline.fit`` on the card: one
    kernel launch a fit, the weights written where they lie (the same
    memory after every fit), the flat parameters taken before a fit left
    alone by it."""
    import numpy as np

    from omldm_tpu_torch.api.requests import LearnerSpec
    from omldm_tpu_torch.pipelines import MLPipeline

    for name, hp, width, k, entry, leaf in (
        ("PA", {"C": 0.1, "variant": "PA-II"}, CRITEO_DIM, CRITEO_NNZ, "scatter_add", "w"),
        ("Softmax", {"learningRate": 0.05, "nClasses": 2}, AVAZU_DIM, AVAZU_SLOTS,
         "scatter_add_outer", "W"),
    ):
        ds = {"sparse": True, "nFeatures": width, "hashSpace": width - 13 if name == "PA" else width,
              "maxNnz": k, "scatterImpl": "scatter"}
        pipe = MLPipeline(LearnerSpec(name, hyper_parameters=hp, data_structure=ds), dim=width,
                          device="cuda")
        rng = np.random.RandomState(17)
        ptr = pipe.state["params"][leaf].data_ptr()
        before = sparse.launches[entry]
        for _ in range(3):
            idx = rng.randint(0, width, size=(256, k)).astype(np.int32)
            val = rng.randn(256, k).astype(np.float32)
            y = rng.randint(0, 2, size=256).astype(np.float32)
            flat, _ = pipe.get_flat_params()
            kept = flat.copy()
            pipe.fit((idx, val), y, np.ones(256, np.float32))
            torch.cuda.synchronize()
            check(np.array_equal(flat, kept), f"sparse {name}: a fit changed flat params taken before it")
        launched = sparse.launches[entry] - before
        same = pipe.state["params"][leaf].data_ptr() == ptr
        log(f"sparse-check: MLPipeline.fit, sparse {name} at {width} + 1: {launched} {entry} "
            f"launches for 3 fits, weights {'written in place' if same else 'MOVED'}")
        check(launched == 3, f"sparse {name}: {launched} {entry} launches for 3 fits")
        check(same, f"sparse {name}: a donated fit did not write into its weights' memory")


def scatter_bound_ms(b, k, d, c):
    """The copying form's least time, its earlier bound: idx, val and coef
    read once, w read and written once, over 3.35 TB/s; the b k c products
    and adds over the float32 peak are far below it."""
    nbytes = (2 * b * k + b * c + 2 * d * c) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * c / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_inplace_bound_ms(b, k, c, touched):
    """The in-place work's least time: idx, val and coef read once, and each
    of the ``touched`` distinct in-range elements of w that a nonzero update
    lands on read and written once (C classes each), over 3.35 TB/s."""
    nbytes = (2 * b * k + b * c + 2 * touched * c) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * c / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _touched(torch, w, idx, coef, val):
    """Distinct in-range indices that at least one nonzero update lands on."""
    d = w.shape[0]
    u = coef[:, None] * val if coef.dim() == 1 else (val[:, :, None] * coef[:, None, :]).abs().amax(2)
    live = (idx >= 0) & (idx < d) & (u != 0)
    return int(torch.unique(idx[live]).numel())


def phase_sparse_time(torch, sparse):
    """Each SPARSE_TIME_SHAPES case in SPARSE_TIME_TURNS turns: the kernel in
    place and in-place ``index_add_`` (the same work in one PyTorch call,
    given the products u precomputed) as a CUDA graph of 200 calls (events
    around 5 replays: each call's launch and the gap before the next) and as
    device busy time a call (torch.profiler, 100 calls: the launch alone);
    at the stream shapes also the plain version in place, the copying
    kernel (PRs 3-5's form) and ``torch.index_add``. An empty kernel's
    launch, timed the same two ways, is the floor under one launch."""
    import statistics

    def timed(fn):
        return _graph_ms(torch, fn, 200), _device_ms(torch, fn, 100)

    def spread(v):
        return f"{statistics.median(v):.6f} ({min(v):.6f}-{max(v):.6f})"

    floor = {"graph": [], "busy": []}
    for _ in range(SPARSE_TIME_TURNS):
        g, b = timed(sparse.empty_launch)
        floor["graph"].append(g)
        floor["busy"].append(b)
    floor_ms = {key: statistics.median(v) for key, v in floor.items()}
    log(f"sparse-time: empty kernel launch (the floor of one launch), median (min-max) of "
        f"{SPARSE_TIME_TURNS} turns: CUDA graph {spread(floor['graph'])} ms a call; "
        f"device busy {spread(floor['busy'])} ms a call")
    out = {"floor": floor_ms}
    for name, b, k, d, c, draw in SPARSE_TIME_SHAPES:
        w, idx, coef, val = _scatter_inputs(torch, b, k, d, c, draw, seed=7)
        idx[0, 1] = 0  # in range: index_add_ takes no out-of-range index
        entry = sparse.sparse_scatter_add if c == 1 else sparse.sparse_scatter_add_outer
        flat = idx.reshape(-1).long()
        u = (coef[:, None] * val).reshape(-1) if c == 1 else \
            (val[:, :, None] * coef[:, None, :]).reshape(b * k, c)
        w_kernel, w_plain, w_library = w.clone(), w.clone(), w.clone()
        calls = {
            "kernel": lambda: entry(w_kernel, idx, coef, val, inplace=True),
            "index_add_": lambda: w_library.index_add_(0, flat, u),
        }
        if (name, draw) in SPARSE_TIME_FULL:
            calls.update({
                "plain": lambda: sparse.sparse_scatter_add_reference(
                    w_plain, idx, coef, val, inplace=True),
                "copying kernel": lambda: entry(w, idx, coef, val),
                "torch.index_add": lambda: torch.index_add(w, 0, flat, u),
            })
        turns = {key: {"graph": [], "busy": []} for key in calls}
        for _ in range(SPARSE_TIME_TURNS):
            for key, fn in calls.items():
                g, bz = timed(fn)
                turns[key]["graph"].append(g)
                turns[key]["busy"].append(bz)
        med = {key: {m: statistics.median(v) for m, v in t.items()} for key, t in turns.items()}
        touched = _touched(torch, w, idx, coef, val)
        bound, by = scatter_inplace_bound_ms(b, k, c, touched)
        old_bound, _ = scatter_bound_ms(b, k, d, c)
        kg = med["kernel"]["graph"]
        log(f"sparse-time: {name} (B, K, D, C)={(b, k, d, c)} {draw}, ms a call, median "
            f"(min-max) of {SPARSE_TIME_TURNS} turns: " + "; ".join(
                f"{key} graph {spread(t['graph'])} busy {spread(t['busy'])}"
                for key, t in turns.items())
            + f"; in-place bound {bound:.7f} ({by}; {touched} distinct touched rows), copying "
            f"form's bound {old_bound:.6f}; kernel at {bound / kg:.4f} of its bound by the graph, "
            f"{kg / floor_ms['graph']:.3f}x an empty launch (busy "
            f"{med['kernel']['busy'] / floor_ms['busy']:.3f}x); index_add_ / kernel "
            f"{med['index_add_']['graph'] / kg:.3f} (graph), "
            f"{med['index_add_']['busy'] / med['kernel']['busy']:.3f} (busy)")
        out[(name, draw)] = med
        if (name, draw) in SPARSE_TIME_FULL:
            out[name] = {"ms": kg, "plain_ms": med["plain"]["graph"], "bound_ms": bound,
                         "bound_by": by, "library_ms": med["index_add_"]["graph"]}
    for name, b in (("slice", 256), ("experiment", 4096)):
        base = out[(name, "uniform")]["kernel"]
        for draw in ("criteo", "pool64"):
            if (name, draw) in out:
                t = out[(name, draw)]["kernel"]
                log(f"sparse-time: {name} B={b}: the {draw} draw takes {t['graph'] / base['graph']:.3f}x "
                    f"the uniform draw's time (graph), {t['busy'] / base['busy']:.3f}x (busy)")
    return out


def phase_calibrate(torch):
    """The calibration CLI at --smoke on the card, into a temporary table
    (never the committed one): a cuda section with every formulation
    measured, or mxu skipped by its cap."""
    import tempfile

    from omldm_tpu_torch.ops import sparse_calibrate
    from omldm_tpu_torch.ops.sparse import MXU_LANES, SCATTER_IMPLS

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sparse_dispatch.json"
        sparse_calibrate.main(["--smoke", "--out", str(out)])
        table = json.loads(out.read_text())
    section = table["backends"].get("cuda")
    check(bool(section), "calibrate: no cuda section written")
    grid = [(e["d"], e["batch"], e["nnz"]) for e in section["entries"]]
    check(grid == sparse_calibrate.SMOKE_GRID, f"calibrate: grid {grid}")
    for e in section["entries"]:
        rates = e["rates_updates_per_sec"]
        check(set(rates) == set(SCATTER_IMPLS), f"calibrate: formulations {sorted(rates)}")
        for impl, rate in rates.items():
            capped = impl == "mxu" and 2 * 2 * e["updates"] * (
                -(-e["d"] // MXU_LANES) + MXU_LANES) > sparse_calibrate.MXU_BYTES_CAP
            check((rate is None) == capped and (rate is None or rate > 0),
                  f"calibrate: {impl} at {e['d']}: {rate}")
    log(f"calibrate: cuda section of {len(section['entries'])} entries on {section['note']}: "
        + "; ".join(f"d={e['d']} -> {e['winner']}" for e in section["entries"]))


def criteo_events(n_records: int, seed: int, query_at: int | None, create: dict | None = None,
                  scatter_impl: str | None = None):
    """Create + n_records Criteo-shaped records, every tenth a forecast, an
    optional Query after record ``query_at``. A record: 13 numerics rounded
    to 6 places, 26 categoricals f{j}_v{0..999}, a target from a planted
    linear rule on the numerics (the generator of the JAX package's sparse
    stream benchmark, benchmarks/run_benchmarks.py). ``scatter_impl`` pins
    the Create's scatter formulation (dataStructure.scatterImpl)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    w = rng.randn(13)
    x = np.round(rng.randn(n_records, 13), 6)
    y = (x @ w > 0).astype(np.float64)
    cats = rng.randint(0, 1000, size=(n_records, 26))
    create = create or {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": CRITEO_DIM,
                                      "hashSpace": CRITEO_HASH, "maxNnz": CRITEO_NNZ}},
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }
    if scatter_impl is not None:
        create["learner"]["dataStructure"]["scatterImpl"] = scatter_impl
    events = [("requests", json.dumps(create))]
    for i in range(n_records):
        rec = {"numericalFeatures": x[i].tolist(),
               "categoricalFeatures": [f"f{j}_v{v}" for j, v in enumerate(cats[i])]}
        if i % 10 == 9:
            events.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float(y[i])
            events.append(("trainingData", json.dumps(rec)))
        if query_at is not None and i == query_at:
            events.append(("requests", json.dumps({"id": 0, "request": "Query", "requestId": 1})))
    return events


def avazu_events(n_records: int, seed: int):
    """Create (sparse Softmax, nClasses 2) + n_records records of 21 hashed
    categorical slots (a vocabulary of 1000 a slot), every tenth a
    forecast; the target is a planted rule: the sign of a sum of one hidden
    weight per (slot, value)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    hidden = rng.randn(AVAZU_SLOTS, 1000)
    cats = rng.randint(0, 1000, size=(n_records, AVAZU_SLOTS))
    y = (hidden[np.arange(AVAZU_SLOTS), cats].sum(axis=1) > 0).astype(np.float64)
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "Softmax", "hyperParameters": {"learningRate": 0.05, "nClasses": 2},
                    "dataStructure": {"sparse": True, "nFeatures": AVAZU_DIM,
                                      "hashSpace": AVAZU_DIM, "maxNnz": AVAZU_SLOTS}},
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }
    events = [("requests", json.dumps(create))]
    for i in range(n_records):
        rec = {"categoricalFeatures": [f"c{j}_v{v}" for j, v in enumerate(cats[i])]}
        if i % 10 == 9:
            events.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float(y[i])
            events.append(("trainingData", json.dumps(rec)))
    return events


def _run_sparse_stream(torch, sparse, events, entry, width, label):
    """One sparse stream on cuda with the kernel counts set to 0 just
    before; checks that ``entry`` launched once per fit and nothing else
    launched; returns (launches, stats, wall seconds)."""
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    n_query = sum(1 for s, p in events if s == "requests" and '"Query"' in p)
    for name in sparse.launches:
        sparse.launches[name] = 0
    job, report, wall = _run_slice(torch, events)
    launches = dict(sparse.launches)
    check(report is not None, f"{label}: the job emitted no JobStatistics")
    check(not job.dead_letter.entries, f"{label}: quarantined {list(job.dead_letter.entries)[:1]}")
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    evaluations = (1 + n_query) * job.config.parallelism
    fits_by_launches = stats.program_launches - stats.forecasts_served - evaluations
    fit_s = sum(s.step_timer.total_ms for s in job.spokes) / 1e3
    serve_s = sum(s.serve_timer.total_ms for s in job.spokes) / 1e3
    log(f"{label}: " + json.dumps({
        "records": len(events), "wall_s": wall, "records_per_s": len(events) / wall,
        "fit_flush_s": fit_s, "serve_s": serve_s, "fits": fits, "launches": launches,
        "fitted": stats.fitted, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms, "forecasts": n_fore,
    }))
    check(launches[entry] > 0, f"{label}: {entry} was never launched")
    check(launches[entry] == fits == fits_by_launches,
          f"{label}: {entry} launches {launches[entry]} != fits {fits} "
          f"(programLaunches accounting: {fits_by_launches})")
    check(all(n == 0 for name, n in launches.items() if name != entry),
          f"{label}: another entry point launched: {launches}")
    for pipe in _pipelines(job):
        for t in pipe.state["params"].values():
            check(t.device.type == job.device.type and bool(torch.isfinite(t).all()),
                  f"{label}: a parameter is not finite or not on {job.device}")
        check(pipe.state["params"][next(iter(pipe.state["params"]))].shape[0] == width + 1,
              f"{label}: the model is not {width} + 1 rows wide")
    check(len(job.predictions) == n_fore == stats.forecasts_served,
          f"{label}: {len(job.predictions)} predictions for {n_fore} forecasting records")
    check(all(p.value in (-1.0, 1.0) for p in job.predictions), f"{label}: a prediction is not a sign")
    return launches[entry], job, stats, wall


def stream_scatter_impl(sparse) -> str | None:
    """The formulation the calibration table picks on the card at the
    sparse stream's (D, updates) -- w[13 + 2^18 + 1], a batch of 256 x (40 +
    the bias slot) -- logged; None when it launches scatter_add (scatter, or
    segsum's final scatter), else "scatter", pinned so that the stream's
    launch count reads the kernel."""
    d, updates = CRITEO_DIM + 1, SLICE_CONFIG["batch_size"] * (CRITEO_NNZ + 1)
    pick = sparse._resolve_impl(d, updates, None, "cuda")
    pin = None if pick in ("scatter", "segsum") else "scatter"
    log(f"sparse: the table picks {pick!r} at (D, updates)=({d}, {updates}) on the card"
        + ("" if pin is None else f"; it launches no scatter_add, so the Create pins "
           f"scatterImpl {pin!r} for the launch count"))
    return pin


def phase_sparse(torch, sparse, events):
    launches, job, stats, wall = _run_sparse_stream(
        torch, sparse, events, "scatter_add", CRITEO_DIM, "sparse")
    check(len(job.responses) == 1, f"sparse: {len(job.responses)} query responses, expected 1")
    values = job.responses[0].learner["parameters"]["values"]
    check(len(values) == CRITEO_DIM + 1, f"sparse: query returned {len(values)} parameters")
    check(stats.score > 0.6, f"sparse: final holdout accuracy {stats.score} is not above chance")
    log(f"sparse: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, scatter_add launches "
        f"{launches} (one a fit), score {stats.score:.4f}, serveLatencyP50Ms "
        f"{stats.serve_latency_p50_ms:.4f}, serveLatencyP99Ms {stats.serve_latency_p99_ms:.4f}")
    return launches, wall


def phase_avazu(torch, sparse, events):
    launches, _, stats, wall = _run_sparse_stream(
        torch, sparse, events, "scatter_add_outer", AVAZU_DIM, "avazu")
    log(f"avazu: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, scatter_add_outer "
        f"launches {launches} (one a fit), score {stats.score:.4f}")
    return launches


# --- the CLI file route (phases 17-20) -----------------------------------------

CLI_ARGS = ["--parallelism", str(SLICE_CONFIG["parallelism"]),
            "--batchSize", str(SLICE_CONFIG["batch_size"])]
PARITY_PARALLELISM = 4  # phase 6's
# host functions the CLI profile reports: (label, file suffix, function name).
# The profiled runs parse on the main thread (no prefetch thread): Python
# 3.12's cProfile records every thread into one profile, which muddles the
# cumulative times of the main thread's frames
CLI_PROFILE_FUNCS = [
    ("cli.main", "omldm_tpu_torch/__main__.py", "main"),
    ("requests first, fused route", "omldm_tpu_torch/__main__.py", "_try_fused_run"),
    ("parse: native blocks", "ops/native/loader.py", "_parse_region"),
    ("parse: record route (JSON codec)", "api/data.py", "parse"),
    ("vectorize (record route)", "runtime/vectorizer.py", "vectorize"),
    ("job.process_packed_batch", "runtime/job.py", "process_packed_batch"),
    ("spoke.handle_packed", "runtime/spoke.py", "handle_packed"),
    ("holdout filter", "runtime/spoke.py", "_holdout_filter"),
    ("stage (add_many)", "runtime/vectorizer.py", "add_many"),
    ("fit: flush_batch (fits, sync points)", "runtime/spoke.py", "flush_batch"),
    ("serve: immediate packed predicts", "runtime/spoke.py", "_serve_packed_baseline"),
    ("serve: plane flushes", "runtime/serving.py", "_serve_solo"),
    ("serve: plane emission", "runtime/serving.py", "_emit_entries"),
    ("pipeline.predict", "pipelines/pipeline.py", "predict"),
    ("sink: a JSON line a prediction", "omldm_tpu_torch/__main__.py", "__call__"),
    ("job.terminate", "runtime/job.py", "terminate"),
]


def write_stream_files(events, out_dir: Path, tag: str):
    """A StreamJob event list as the CLI's files: the data records in
    stream order into the training file (a forecast inline, marked
    "operation": "forecasting"), the requests into the requests file."""
    train = out_dir / f"{tag}_train.jsonl"
    reqs = out_dir / f"{tag}_requests.jsonl"
    with open(train, "w") as t, open(reqs, "w") as r:
        for stream, payload in events:
            if stream == "requests":
                r.write(payload + "\n")
            elif stream == "forecastingData":
                rec = json.loads(payload)
                rec["operation"] = "forecasting"
                t.write(json.dumps(rec) + "\n")
            else:
                t.write(payload + "\n")
    return train, reqs


def forecast_workers(events, parallelism):
    """The worker each forecast goes to: data rows are dealt round-robin
    from row 0 (the packed route and the record route alike); keyed by the
    forecast's float32 features, as a prediction carries them."""
    import numpy as np

    out, r = {}, 0
    for stream, payload in events:
        if stream == "requests":
            continue
        if stream == "forecastingData":
            key = tuple(np.float32(json.loads(payload)["numericalFeatures"]).tolist())
            out[key] = r % parallelism
        r += 1
    return out


def run_cli(torch, argv, out_dir: Path, tag: str, profile=None):
    """``python -m omldm_tpu_torch`` in-process, its sinks under
    ``out_dir``; returns (job, wall seconds, predictions read back). The job
    is caught through ``build_job``."""
    import omldm_tpu_torch.__main__ as cli

    captured = {}
    real = cli.build_job

    def build_job(flags):
        job, sinks = real(flags)
        captured["job"] = job
        return job, sinks

    pred = out_dir / f"{tag}_pred.jsonl"
    argv = [str(a) for a in argv] + [
        "--predictionsOut", str(pred), "--responsesOut", str(out_dir / f"{tag}_resp.jsonl"),
        "--performanceOut", str(out_dir / f"{tag}_perf.jsonl"),
    ]
    cli.build_job = build_job
    try:
        if profile is not None:
            profile.enable()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if profile is not None:
            profile.disable()
    finally:
        cli.build_job = real
    check(rc == 0, f"{tag}: the CLI returned {rc}")
    preds = [json.loads(line) for line in pred.read_text().splitlines()]
    return captured["job"], wall, preds


def _cli_counts(job):
    """(stats, fits, serving launches, evaluations) of a CLI job: every
    predict is timed by its spoke's serve timer, every fit adds a point to
    the learning curve, and what is left of programLaunches evaluated."""
    [stats] = job.performance[-1].statistics
    fits = len(stats.learning_curve)
    serves = sum(s.serve_timer.count for s in job.spokes)
    return stats, fits, serves, stats.program_launches - fits - serves


def _by_worker(preds, workers):
    """Each worker's predictions, in emission order: (features, value)."""
    import numpy as np

    out = {}
    for p in preds:
        key = tuple(np.float32(p["dataInstance"]["numericalFeatures"]).tolist())
        out.setdefault(workers[key], []).append((key, p["value"]))
    return out


def phase_cli(torch, pa_scan, fast_ingest, events, out_dir: Path, slice_wall):
    """Phase 5's stream as files through the CLI's packed route on cuda."""
    from omldm_tpu_torch.ops.native import fast_parser_available, loader

    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    p = SLICE_CONFIG["parallelism"]
    # the Create names its width: the requests file is replayed before the
    # training file, and a Query for a pipeline not deployed yet (width
    # unknown) is dropped, in the JAX package as here
    create = json.loads(events[0][1])
    create["learner"]["dataStructure"] = {"nFeatures": N_FEATURES}
    events = [("requests", json.dumps(create))] + events[1:]
    train, reqs = write_stream_files(events, out_dir, "cli")
    check(fast_parser_available(), f"cli: the native parser did not build:\n{loader.build_error}")
    fast_ingest.blocks.update(native=0, python=0)
    pa_scan.launches = 0
    job, wall, preds = run_cli(torch, CLI_ARGS + ["--trainingData", train, "--requests", reqs,
                                                  "--fastIngest", "true"], out_dir, "cli")
    launches, blocks = pa_scan.launches, dict(fast_ingest.blocks)
    stats, fits, serves, evaluations = _cli_counts(job)
    log("cli: " + json.dumps({
        "records": len(events), "wall_s": wall, "records_per_s": len(events) / wall,
        "slice_records_per_s": len(events) / slice_wall, "speedup": slice_wall / wall,
        "parser_blocks": blocks, "fits": fits, "pa_scan_launches": launches,
        "serving_launches": serves, "evaluations": evaluations,
        "programLaunches": stats.program_launches, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms, "forecasts": n_fore,
    }))
    check(blocks["native"] > 0 and blocks["python"] == 0,
          f"cli: the training file did not all go through the native parser: {blocks}")
    check(launches > 0, "cli: pa_scan was never launched")
    check(launches == fits, f"cli: pa_scan launches {launches} != per-record fits {fits}")
    check(evaluations == p, f"cli: {evaluations} evaluations, expected the terminate's {p} "
          "(the Query came before training, on empty holdout sets)")
    check(len(preds) == n_fore == stats.forecasts_served == serves,
          f"cli: {len(preds)} predictions, {serves} predicts for {n_fore} forecasts")
    check(all(q["value"] in (-1.0, 1.0) for q in preds), "cli: a prediction is not a sign")
    check(stats.score > 0.6, f"cli: holdout accuracy {stats.score} is not above chance")
    check([r.data_fitted for r in job.responses] == [0],
          "cli: the Query was not answered once, before training")
    _check_placement(torch, job, "cli")
    return {"train": train, "requests": reqs, "wall": wall, "preds": preds, "stats": stats,
            "records": len(events), "workers": forecast_workers(events, p)}


def phase_cli_parity(torch, events, out_dir: Path):
    """The first records of phase 5 through the CLI three ways; a requests
    file with the Create alone (a Query would flush part-filled batches at
    another point on the record route). The packed runs take one row a
    worker a block, so their workers see their rows in the record route's
    order (default 8192-row blocks reorder the Asynchronous pushes between
    workers, as the reference's rebalance may)."""
    import numpy as np

    train, reqs = write_stream_files(events, out_dir, "parity")
    base = ["--parallelism", PARITY_PARALLELISM, "--batchSize", SLICE_CONFIG["batch_size"],
            "--trainingData", train, "--requests", reqs]
    packed = ["--fastIngest", "true", "--ingestBatch", PARITY_PARALLELISM]
    runs = {}
    for tag, extra in (("packed-cuda", packed), ("record-cuda", ["--fastIngest", "false"]),
                       ("packed-cpu", packed + ["--device", "cpu"])):
        job, _, preds = run_cli(torch, base + extra, out_dir, f"parity_{tag}")
        flats = [pipe.get_flat_params()[0] for pipe in _pipelines(job)]
        feats = [np.float32(q["dataInstance"]["numericalFeatures"]).tolist() for q in preds]
        runs[tag] = (feats, np.array([q["value"] for q in preds]), flats)
    ref_feats, ref_vals, ref_flats = runs["packed-cuda"]
    for tag in ("record-cuda", "packed-cpu"):
        feats, vals, flats = runs[tag]
        check(len(vals) == len(ref_vals) > 0 and feats == ref_feats,
              f"cli-parity: {tag} emitted other predictions or another order")
        mismatches = int((vals != ref_vals).sum())
        err = max(float(np.abs(a - b).max()) for a, b in zip(flats, ref_flats))
        log(f"cli-parity: packed-cuda vs {tag} on {len(events) - 1} records: prediction "
            f"mismatches {mismatches}/{len(vals)}, final params max|d|={err:.3e}")
        check(mismatches <= 0.01 * len(vals), f"cli-parity: {tag}: more than 1% differ")
        for a, b in zip(flats, ref_flats):
            check(np.allclose(a, b, rtol=W_RTOL, atol=W_ATOL),
                  f"cli-parity: {tag}: final params differ: max|d|={np.abs(a - b).max()}")


def phase_serving(torch, pa_scan, fast_ingest, cli, out_dir: Path):
    """Phase 17's files with the serving plane armed job-wide (exact mode,
    maxBatch 64, maxDelayMs 5)."""
    fast_ingest.blocks.update(native=0, python=0)
    pa_scan.launches = 0
    job, wall, preds = run_cli(torch, CLI_ARGS + [
        "--trainingData", cli["train"], "--requests", cli["requests"], "--fastIngest", "true",
        "--serving", "maxBatch=64,maxDelayMs=5,staleness=exact"], out_dir, "serving")
    launches, blocks = pa_scan.launches, dict(fast_ingest.blocks)
    stats, fits, serves, evaluations = _cli_counts(job)
    ref = cli["preds"]
    # a worker's queue may flush after another worker's forecasts, so the
    # order across workers may move; each worker's own order may not
    same_global_order = [q["dataInstance"] for q in preds] == [q["dataInstance"] for q in ref]
    mine, theirs = _by_worker(preds, cli["workers"]), _by_worker(ref, cli["workers"])
    by_key = {k: v for rows in theirs.values() for k, v in rows}
    mismatches = sum(v != by_key.get(k) for rows in mine.values() for k, v in rows)
    log("serving: " + json.dumps({
        "records": cli["records"], "wall_s": wall, "records_per_s": cli["records"] / wall,
        "cli_records_per_s": cli["records"] / cli["wall"], "speedup_vs_cli": cli["wall"] / wall,
        "serving_launches": serves, "cli_serving_launches": cli["stats"].forecasts_served,
        "forecasts_per_launch": len(preds) / max(serves, 1), "fits": fits,
        "pa_scan_launches": launches, "evaluations": evaluations,
        "programLaunches": stats.program_launches,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms,
        "cli_serveLatencyP50Ms": cli["stats"].serve_latency_p50_ms,
        "cli_serveLatencyP99Ms": cli["stats"].serve_latency_p99_ms,
        "value_mismatches": mismatches, "predictions": len(preds),
        "same_global_order": same_global_order, "score": stats.score,
    }))
    check(blocks["native"] > 0 and blocks["python"] == 0,
          f"serving: the training file did not all go through the native parser: {blocks}")
    check(launches == fits > 0, f"serving: pa_scan launches {launches} != fits {fits}")
    check(evaluations == SLICE_CONFIG["parallelism"],
          f"serving: {evaluations} evaluations, expected {SLICE_CONFIG['parallelism']}")
    check(len(preds) == len(ref) == stats.forecasts_served,
          f"serving: {len(preds)} predictions against phase 17's {len(ref)}")
    check(0 < serves < len(preds), f"serving: {serves} predicts for {len(preds)} forecasts")
    check({w: [k for k, _ in v] for w, v in mine.items()}
          == {w: [k for k, _ in v] for w, v in theirs.items()},
          "serving: a worker's forecasts came out in another order than phase 17's")
    log(f"serving: {mismatches}/{len(preds)} forecasts answered with another value than "
        "phase 17's (same record, same worker)")
    check(mismatches <= 0.01 * len(preds),
          "serving: more than 1% of values differ from phase 17's")
    _check_placement(torch, job, "serving")
    return serves, mismatches


def phase_cli_sparse(torch, sparse, fast_ingest, sparse_events, out_dir: Path, sparse_wall):
    """Phase 14's Criteo stream as files through the CLI, serving armed: a
    sparse Create takes the per-record route and the plane's sparse
    flush."""
    n_fore = sum(1 for s, _ in sparse_events if s == "forecastingData")
    train, reqs = write_stream_files(sparse_events, out_dir, "cli_sparse")
    fast_ingest.blocks.update(native=0, python=0)
    for name in sparse.launches:
        sparse.launches[name] = 0
    job, wall, preds = run_cli(torch, CLI_ARGS + [
        "--trainingData", train, "--requests", reqs, "--serving", "on"], out_dir, "cli_sparse")
    launches, blocks = dict(sparse.launches), dict(fast_ingest.blocks)
    stats, fits, serves, evaluations = _cli_counts(job)
    log("cli-sparse: " + json.dumps({
        "records": len(sparse_events), "wall_s": wall,
        "records_per_s": len(sparse_events) / wall,
        "sparse_records_per_s": len(sparse_events) / sparse_wall,
        "speedup_vs_sparse": sparse_wall / wall, "fits": fits, "launches": launches,
        "serving_launches": serves, "forecasts_per_launch": n_fore / max(serves, 1),
        "evaluations": evaluations, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms, "forecasts": n_fore,
    }))
    check(blocks == {"native": 0, "python": 0},
          f"cli-sparse: a sparse job went through the dense block parser: {blocks}")
    check(all(net.sparse and net.serving is not None
              for spoke in job.spokes for net in spoke.nets.values()),
          "cli-sparse: the nets are not sparse and serving-armed")
    check(launches["scatter_add"] == fits > 0,
          f"cli-sparse: scatter_add launches {launches['scatter_add']} != fits {fits}")
    check(all(n == 0 for name, n in launches.items() if name != "scatter_add"),
          f"cli-sparse: another entry point launched: {launches}")
    check(evaluations == SLICE_CONFIG["parallelism"],
          f"cli-sparse: {evaluations} evaluations, expected {SLICE_CONFIG['parallelism']}")
    # a worker meets a forecast every 160 records here, often past the 5 ms
    # deadline: how many a flush serves is this run's measurement
    check(len(preds) == n_fore == stats.forecasts_served and 0 < serves <= n_fore,
          f"cli-sparse: {len(preds)} predictions in {serves} predicts for {n_fore} forecasts")
    check(stats.score > 0.6, f"cli-sparse: holdout accuracy {stats.score} is not above chance")
    for pipe in _pipelines(job):
        for t in pipe.state["params"].values():
            check(t.device.type == "cuda" and bool(torch.isfinite(t).all()),
                  "cli-sparse: a parameter is not finite or not on cuda")
    return train, reqs


def phase_cli_profile(torch, cli, cli_sparse, out_dir: Path):
    """Phases 17, 19 and 20's CLI runs under cProfile: host seconds by
    function. The blocks are parsed on the main thread here (see
    CLI_PROFILE_FUNCS), so the profiled runs have no parse-ahead."""
    import cProfile
    import io
    import pstats

    from omldm_tpu_torch.runtime import prefetch

    out_dir.mkdir(parents=True, exist_ok=True)
    dense = ["--trainingData", cli["train"], "--requests", cli["requests"],
             "--fastIngest", "true"]
    sparse = ["--trainingData", cli_sparse[0], "--requests", cli_sparse[1]]
    for tag, argv in (("cli", dense), ("cli_serving", dense + ["--serving", "on"]),
                      ("cli_sparse", sparse + ["--serving", "on"])):
        prof = cProfile.Profile()
        real = prefetch.prefetch
        prefetch.prefetch = lambda source, depth=2: iter(source)
        try:
            _, wall, _ = run_cli(torch, CLI_ARGS + argv, out_dir, f"profile_{tag}", profile=prof)
        finally:
            prefetch.prefetch = real
        st = pstats.Stats(prof)
        st.dump_stats(str(out_dir / f"{tag}.pstats"))
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
        (out_dir / f"{tag}_cprofile.txt").write_text(buf.getvalue())
        host = {}
        for (path, _, name), (_, _, _, ct, _) in st.stats.items():
            for label, suffix, fname in CLI_PROFILE_FUNCS:
                if name == fname and path.endswith(suffix):
                    host[label] = host.get(label, 0.0) + ct
        log(f"profile[{tag}]: cProfile wall {wall:.3f} s (profiler overhead included); "
            "cumulative host seconds by function:")
        for label, _, _ in CLI_PROFILE_FUNCS:
            log(f"  {label}: {host.get(label, 0.0):.3f}")
        top_self = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
        log(f"profile[{tag}]: top self time:")
        for (path, line, name), (_, nc, tt, _, _) in top_self:
            log(f"  {tt:.3f} s self, {nc} calls: {Path(path).name}:{line} {name}")


# --- the learners and protocols of the host plane (phases 21-23) ---------------

# (name, learner, preprocessors, trainingConfiguration, parallelism, batch,
# records, data kind, width): BASELINE
# configs 1, 2 and 4 (benchmarks/run_benchmarks.py:95-130; one pipeline, so
# parallelism 1, their batch 4096), the bench job's Softmax under
# Synchronous (:857-877; engine left at host; 200,000 records, cut from
# 400,000 for the script's time limit), then every other learner and
# preprocessor at the reference's parallelism 16.
LEARNER_RUNS = [
    ("config1_softmax", {"name": "Softmax",
                         "hyperParameters": {"learningRate": 0.05, "nClasses": 2}},
     ["StandardScaler"], {}, 1, 4096, 100_000, "higgs", 28),
    ("config2_orr", {"name": "ORR", "hyperParameters": {"lambda": 1.0}},
     ["StandardScaler"], {}, 1, 4096, 100_000, "regression", 90),
    ("config4_rff_svm", {"name": "SVM", "hyperParameters": {"lambda": 1e-4},
                         "dataStructure": {"rffDim": 512, "gamma": 0.5}},
     [], {}, 1, 4096, 100_000, "binary", 18),
    ("bench_softmax_sync", {"name": "Softmax",
                            "hyperParameters": {"learningRate": 0.05, "nClasses": 2}},
     [], {"protocol": "Synchronous"}, 16, 4096, 200_000, "binary", 28),
    ("regressor_pa", {"name": "RegressorPA", "hyperParameters": {"C": 0.1, "epsilon": 0.1}},
     [], {"perRecord": True}, 16, 256, 20_000, "regression", 28),
    ("nn", {"name": "NN"}, [], {}, 16, 256, 50_000, "nonlinear", 28),
    ("multiclass_pa", {"name": "MultiClassPA", "hyperParameters": {"nClasses": 3}},
     [], {}, 16, 256, 50_000, "multi3", 28),
    ("kmeans", {"name": "K-means", "hyperParameters": {"k": 2}},
     [], {}, 16, 256, 50_000, "clusters", 28),
    ("ht", {"name": "HT"}, [], {}, 16, 256, 50_000, "axis", 28),
    ("minmax_pa", {"name": "PA", "hyperParameters": {"C": 0.1}},
     ["MinMaxScaler"], {}, 16, 256, 50_000, "binary", 28),
    ("poly2_pa", {"name": "PA", "hyperParameters": {"C": 0.1}},
     [("PolynomialFeatures", {"degree": 2})], {}, 16, 256, 50_000, "binary", 28),
]
# each run's holdout score must reach this (chance: 0.5 binary, 0.33 for
# three classes; ORR and K-means score minus the RMS error). The RFF SVM has
# none: pegasos at lambda 1e-4 takes ~22 steps of 4096 rows here, too few to
# leave chance; phase 23 and the CPU tests hold its values instead.
SCORE_FLOORS = {"config2_orr": -1.0, "regressor_pa": -0.8, "kmeans": -8.0,
                "multiclass_pa": 0.5, "config4_rff_svm": 0.0}
# protocol_comparison.py's host section (:87-130, defaults :1650-1653)
PROTOCOL_ORDER = ("Asynchronous", "Synchronous", "SSP", "EASGD", "GM", "FGM",
                  "CentralizedTraining", "SingleLearner")
PROTOCOL_RUN = dict(records=50_000, parallelism=16, batch=256, test_set_size=64, sync_every=4)
PROTOCOL_SPARSE_RECORDS = 20_000
PACKED_CHUNK = 8192  # protocol_comparison.py's block of rows


def learner_data(kind: str, n: int, width: int, seed: int):
    """(x float32 [n, width], y float32 [n]) from a planted rule: kinds
    "higgs" (phase 5's HIGGS-shaped rows), "binary" (a linear rule),
    "nonlinear" (a linear rule plus a product term), "regression" (a linear
    target of unit scale plus noise of 0.5), "multi3" (the argmax of three
    linear scores), "clusters" (two Gaussian blobs), "axis" (a threshold on
    one feature)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if kind == "higgs":
        x, y = higgs_like(n, rng)
        return x.astype(np.float32), y.astype(np.float32)
    x = rng.randn(n, width)
    w = rng.randn(width)
    if kind == "binary":
        y = x @ w > 0
    elif kind == "nonlinear":
        y = x @ w + 2.0 * x[:, 0] * x[:, 1] > 0
    elif kind == "regression":
        y = x @ w / np.sqrt(width) + 0.5 * rng.randn(n)
    elif kind == "multi3":
        y = np.argmax(x @ rng.randn(width, 3), axis=1)
    elif kind == "clusters":
        centre = rng.randn(2, width) * 3.0
        y = rng.randint(0, 2, n)
        x = x + centre[y]
    else:  # axis
        y = x[:, 3] > 0.2
    return x.astype(np.float32), np.asarray(y, np.float32)


def _create(learner: dict, preps, tc: dict, width: int) -> dict:
    learner = dict(learner)
    learner["dataStructure"] = dict(learner.get("dataStructure", {}), nFeatures=width)
    return {
        "id": 0, "request": "Create", "learner": learner,
        "preProcessors": [{"name": p} if isinstance(p, str) else
                          {"name": p[0], "hyperParameters": p[1]} for p in preps],
        "trainingConfiguration": tc,
    }


def run_packed(torch, create: dict, x, y, op, parallelism: int, batch: int, test_set_size: int,
               device="cuda"):
    """One StreamJob fed as protocol_comparison.py feeds it: the Create,
    then blocks of PACKED_CHUNK pre-vectorized rows, then termination.
    Returns (job, report, wall seconds)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    job = StreamJob(JobConfig(parallelism=parallelism, batch_size=batch,
                              test_set_size=test_set_size), device=device)
    t0 = time.perf_counter()
    job.process_event("requests", json.dumps(create))
    for i in range(0, x.shape[0], PACKED_CHUNK):
        job.process_packed_batch(x[i : i + PACKED_CHUNK], y[i : i + PACKED_CHUNK],
                                 op[i : i + PACKED_CHUNK])
    report = job.terminate()
    if device == "cuda":
        torch.cuda.synchronize()
    return job, report, time.perf_counter() - t0


def _check_placement(torch, job, label):
    """Every tensor of every pipeline state on the job's device, except a
    host-side learner's (HT): its pipeline lives on the host and its model
    holds no tensor."""
    from omldm_tpu_torch.pipelines.pipeline import _leaves

    for pipe in _pipelines(job):
        tensors = [pipe.state["fitted"], pipe.state["cum_loss"]]
        tensors += [t for s in pipe.state["preps"] for t in _leaves(s)]
        params = _leaves(pipe.state["params"])
        if pipe.learner.host_side:
            check(pipe.device.type == "cpu" and all(t.device.type == "cpu" for t in tensors)
                  and not any(isinstance(p, torch.Tensor) for p in params),
                  f"{label}: the host-side model is not on the host")
            continue
        tensors += params
        check(all(t.device.type == job.device.type for t in tensors),
              f"{label}: a pipeline state tensor is not on {job.device}")
        check(all(bool(torch.isfinite(t).all()) for t in params if t.is_floating_point()),
              f"{label}: a parameter is not finite")


def _forecast_ops(n: int):
    import numpy as np

    op = np.zeros((n,), np.uint8)
    op[9::10] = 1  # every tenth record a forecast
    return op


def phase_learners(torch, seed):
    """Phase 21: each learner run on cuda; returns {name: summary}."""
    import numpy as np

    out = {}
    for name, learner, preps, tc, par, batch, n, kind, width in LEARNER_RUNS:
        x, y = learner_data(kind, n, width, seed)
        op = _forecast_ops(n)
        create = _create(learner, preps, tc, width)
        job, report, wall = run_packed(torch, create, x, y, op, par, batch, 256)
        label = f"learners[{name}]"
        check(report is not None and not job.dead_letter.entries,
              f"{label}: no statistics or a refusal: {list(job.dead_letter.entries)[:1]}")
        [stats] = report.statistics
        _check_placement(torch, job, label)
        n_fore = int(op.sum())
        preds = np.array([p.value for p in job.predictions])
        check(len(preds) == n_fore == stats.forecasts_served,
              f"{label}: {len(preds)} predictions for {n_fore} forecasts")
        check(bool(np.isfinite(preds).all()), f"{label}: a prediction is not finite")
        floor = SCORE_FLOORS.get(name, 0.6)
        check(stats.fitted > 0.7 * n and np.isfinite(stats.score) and stats.score > floor,
              f"{label}: fitted {stats.fitted}, score {stats.score} (floor {floor})")
        out[name] = {
            "protocol": stats.protocol, "parallelism": par, "batch": batch, "records": n,
            "wall_s": wall, "records_per_s": n / wall, "score": stats.score,
            "fitted": stats.fitted, "programLaunches": stats.program_launches,
            "bytesShipped": stats.bytes_shipped,
            "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        }
        log(f"learners: {name}: " + json.dumps(out[name]))
    return out


def protocol_stream(records: int):
    """protocol_comparison.py's stream: 28 features from RandomState(0), the
    labels of a planted rule from RandomState(42), all training."""
    import numpy as np

    rng = np.random.RandomState(0)
    w = np.random.RandomState(42).randn(28)
    x = rng.randn(records, 28).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def _protocol_create(protocol: str, per_record: bool = False) -> dict:
    tc = {"protocol": protocol, "syncEvery": PROTOCOL_RUN["sync_every"]}
    if per_record:
        tc["perRecord"] = True
    return _create({"name": "PA", "hyperParameters": {"C": 1.0}}, [], tc, 28)


def phase_protocols(torch, pa_scan, sparse, seed, scatter_impl):
    """Phase 22: the eight protocols on protocol_comparison.py's stream,
    then pa_scan under Synchronous (perRecord) and scatter_add under
    Synchronous (the sparse Create of phase 14); returns (rows, pa_scan
    launches, scatter_add launches)."""
    import numpy as np

    r = PROTOCOL_RUN
    x, y = protocol_stream(r["records"])
    op = np.zeros((r["records"],), np.uint8)
    # untimed warm-up, as protocol_comparison.py runs one
    warm = min(r["parallelism"] * r["batch"] * 4, r["records"])
    run_packed(torch, _protocol_create(PROTOCOL_ORDER[0]), x[:warm], y[:warm], op[:warm],
               r["parallelism"], r["batch"], r["test_set_size"])
    rows = {}
    for protocol in PROTOCOL_ORDER:
        job, report, wall = run_packed(torch, _protocol_create(protocol), x, y, op,
                                       r["parallelism"], r["batch"], r["test_set_size"])
        [stats] = report.statistics
        check(stats.protocol == protocol, f"protocols: {protocol} resolved to {stats.protocol}")
        _check_placement(torch, job, f"protocols[{protocol}]")
        check(stats.fitted > 0.9 * r["records"] and stats.score > 0.8,
              f"protocols[{protocol}]: fitted {stats.fitted}, score {stats.score}")
        rows[protocol] = {
            "records_per_s": r["records"] / wall, "wall_s": wall, "score": stats.score,
            "fitted": stats.fitted, "bytesShipped": stats.bytes_shipped,
            "modelsShipped": stats.models_shipped, "numOfBlocks": stats.num_of_blocks,
            "programLaunches": stats.program_launches,
        }
        log(f"protocols: {protocol}: " + json.dumps(rows[protocol]))

    pa_scan.launches = 0
    job, report, wall = run_packed(torch, _protocol_create("Synchronous", per_record=True),
                                   x, y, op, r["parallelism"], r["batch"], r["test_set_size"])
    launches = pa_scan.launches
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    log(f"protocols: Synchronous perRecord: {r['records'] / wall:.0f} records/s, pa_scan "
        f"launches {launches}, fits {fits}, score {stats.score:.4f}")
    check(launches == fits > 0, f"protocols: pa_scan launches {launches} != per-record fits {fits}")

    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": CRITEO_DIM,
                                      "hashSpace": CRITEO_HASH, "maxNnz": CRITEO_NNZ}},
        "trainingConfiguration": {"protocol": "Synchronous"},
    }
    events = criteo_events(PROTOCOL_SPARSE_RECORDS, seed, None, create=create,
                           scatter_impl=scatter_impl)
    # a Synchronous worker blocked on its round chains its backlog into one
    # fit_many (one programLaunch, one fit a batch), so the fits are read
    # from the learning curve alone
    for name in sparse.launches:
        sparse.launches[name] = 0
    job, report, wall = _run_slice(torch, events)
    scatter = dict(sparse.launches)
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    log(f"protocols: sparse Synchronous: {len(events) / wall:.0f} records/s, launches "
        f"{scatter}, fits {fits}, score {stats.score:.4f}")
    check(scatter["scatter_add"] == fits > 0
          and all(n == 0 for k, n in scatter.items() if k != "scatter_add"),
          f"protocols: sparse Synchronous: launches {scatter} against {fits} fits")
    _check_placement(torch, job, "protocols[sparse Synchronous]")
    check(stats.protocol == "Synchronous" and stats.score > 0.6
          and len(job.predictions) == stats.forecasts_served > 0,
          f"protocols: sparse Synchronous: {stats.protocol}, score {stats.score}")
    return rows, launches, scatter["scatter_add"]


# runs whose parameters are held to W_RTOL times their largest magnitude
# instead of W_RTOL/W_ATOL entry by entry, and why: ORR's parameters are
# the sums A = lambda*I + sum x x^T and b = sum y x over every row a worker
# saw; summed in another order (cuBLAS against the CPU), an entry that
# cancels to near zero keeps the rounding of partial sums thousands wide
# (the JAX package's own tests hold ORR's statistics to rtol 1e-4 and its
# solve to 1e-3).
PARITY_SCALED = {"config2_orr"}


def _parity_run(torch, create, x, y, op, test_set_size, device):
    import numpy as np

    job, report, _ = run_packed(torch, create, x, y, op, 4, 256, test_set_size, device)
    [stats] = report.statistics
    probe = x[:512]
    flats, probes = [], []
    for pipe in _pipelines(job):
        probes.append(pipe.predict(probe).cpu().numpy())
        if not pipe.learner.host_side:
            flats.append(pipe.get_flat_params()[0])
    preds = np.array([p.value for p in job.predictions] + [v for p in probes for v in p])
    return stats, preds, flats


def phase_protocol_parity(torch, seed, records: int):
    """Phase 23: the first ``records`` rows of each phase-22 protocol run and
    of each phase-21 learner run at parallelism 4, on cuda and on cpu."""
    import numpy as np

    x_p, y_p = protocol_stream(records)
    runs = [(p, _protocol_create(p), x_p, y_p, np.zeros((records,), np.uint8),
             PROTOCOL_RUN["test_set_size"], False) for p in PROTOCOL_ORDER]
    for name, learner, preps, tc, _, _, _, kind, width in LEARNER_RUNS:
        x, y = learner_data(kind, records, width, seed)
        runs.append((name, _create(learner, preps, tc, width), x, y, _forecast_ops(records), 256,
                     kind == "regression"))
    worst = {}
    for name, create, x, y, op, tss, regression in runs:
        (sc, pc, fc), (sp, pp, fp) = (_parity_run(torch, create, x, y, op, tss, d)
                                      for d in ("cuda", "cpu"))
        dc, dp = sc.to_dict(), sp.to_dict()
        ints = [k for k, v in dp.items() if isinstance(v, int) and not isinstance(v, bool)]
        check([dc[k] for k in ints] == [dp[k] for k in ints],
              f"protocol-parity[{name}]: integer statistics differ: "
              + str({k: (dc[k], dp[k]) for k in ints if dc[k] != dp[k]}))
        check(len(pc) == len(pp) > 0, f"protocol-parity[{name}]: prediction counts differ")
        if regression:
            mismatches = int((~np.isclose(pc, pp, rtol=1e-3, atol=1e-3)).sum())
        else:
            mismatches = int((pc != pp).sum())
        err = max((float(np.abs(a - b).max()) for a, b in zip(fc, fp)), default=0.0)
        worst[name] = (mismatches, len(pc), err)
        log(f"protocol-parity: {name}: {records} records, fitted {dp['fitted']}, "
            f"bytesShipped {dp['bytesShipped']}, prediction mismatches {mismatches}/{len(pc)}, "
            f"params max|d|={err:.3e}")
        check(mismatches <= 0.01 * len(pc), f"protocol-parity[{name}]: > 1% of predictions differ")
        for a, b in zip(fc, fp):
            close = (float(np.abs(a - b).max()) <= W_RTOL * float(np.abs(b).max())
                     if name in PARITY_SCALED else np.allclose(a, b, rtol=W_RTOL, atol=W_ATOL))
            check(close, f"protocol-parity[{name}]: params differ: max|d|={np.abs(a - b).max()}")
    return worst


# host functions the host-plane profile reports: (label, file suffix, function name)
HOST_PLANE_PROFILE_FUNCS = [
    ("packed deal (job.process_packed_batch)", "runtime/job.py", "process_packed_batch"),
    ("holdout split", "runtime/spoke.py", "_holdout_filter"),
    ("flush_batch (fits, sync points)", "runtime/spoke.py", "flush_batch"),
    ("pipeline.fit", "pipelines/pipeline.py", "fit"),
    ("pipeline.predict", "pipelines/pipeline.py", "predict"),
    ("sync point: flat params to the host", "pipelines/pipeline.py", "get_flat_params"),
    ("sync point: flat params to the device", "pipelines/pipeline.py", "set_flat_params"),
    ("hub receive", "runtime/hub.py", "receive"),
    ("terminate", "runtime/job.py", "terminate"),
]
# (label, phase-21 run or phase-22 protocol) profiled after phase 23
HOST_PLANE_PROFILES = ["Synchronous", "GM", "SingleLearner", "nn", "ht", "config2_orr"]


def phase_host_plane_profile(torch, seed, rows, out_dir: Path):
    """Phase 21 and 22 runs under cProfile (host seconds by function) and
    torch.profiler (device busy time against the unprofiled run's wall:
    the idle share)."""
    import cProfile
    import io
    import pstats

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {name: run for name, *run in LEARNER_RUNS}
    r = PROTOCOL_RUN
    for label in HOST_PLANE_PROFILES:
        if label in runs:
            learner, preps, tc, par, batch, n, kind, width = runs[label]
            x, y = learner_data(kind, n, width, seed)
            args = (_create(learner, preps, tc, width), x, y, _forecast_ops(n), par, batch, 256)
        else:
            x, y = protocol_stream(r["records"])
            args = (_protocol_create(label), x, y, np.zeros((r["records"],), np.uint8),
                    r["parallelism"], r["batch"], r["test_set_size"])
        prof = cProfile.Profile()
        prof.enable()
        _, _, wall_c = run_packed(torch, *args)
        prof.disable()
        st = pstats.Stats(prof)
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
        (out_dir / f"host_plane_{label}_cprofile.txt").write_text(buf.getvalue())
        host = {}
        for (path, _, name), (_, _, _, ct, _) in st.stats.items():
            for hl, suffix, fname in HOST_PLANE_PROFILE_FUNCS:
                if name == fname and path.endswith(suffix):
                    host[hl] = host.get(hl, 0.0) + ct
        log(f"profile[{label}]: cProfile wall {wall_c:.3f} s; cumulative host seconds: "
            + "; ".join(f"{hl} {host.get(hl, 0.0):.3f}" for hl, _, _ in HOST_PLANE_PROFILE_FUNCS))
        for (path, line, name), (_, nc, tt, _, _) in sorted(
                st.stats.items(), key=lambda kv: -kv[1][2])[:6]:
            log(f"  {tt:.3f} s self, {nc} calls: {Path(path).name}:{line} {name}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            _, _, wall_t = run_packed(torch, *args)
        kernels = [e for e in tp.key_averages() if e.device_type == DeviceType.CUDA]
        busy_s = sum(_dev_us(e) for e in kernels) / 1e6
        wall = rows[label]["wall_s"]
        log(f"profile[{label}]: device busy {busy_s:.4f} s in {sum(e.count for e in kernels)} "
            f"launches against the unprofiled run's {wall:.3f} s wall: idle share "
            f"{1.0 - busy_s / wall:.4f}; top kernels: " + "; ".join(
                f"{_dev_us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}"
                for e in sorted(kernels, key=lambda e: -_dev_us(e))[:4]))


# --- the SPMD engine: the bench.py route, its protocols, card against CPU -------

# benchmarks/run_benchmarks.py:_make_e2e_job (:857-877) and bench_e2e_stream
# (:883): Softmax (lr 0.05, 2 classes), 28 features, Synchronous on the SPMD
# engine, stageChain 32, parallelism 1, batch 4096, 1,000,000 records
BENCH_RECORDS = 1_000_000
BENCH_JOB = dict(parallelism=1, batch=4096, chain=32, dim=28)
BENCH_PARITY_ROWS = 20_000
BENCH_BASELINE = 100_000.0  # bench.py's vs_baseline divisor
BENCH_METRIC = ("e2e streaming train throughput, JSON bytes -> trained params "
                "(measured double-buffered overlapped run)")
# benchmarks/protocol_comparison.py:run_one(engine="spmd") (:86-135)
SPMD_RUN = dict(records=50_000, parallelism=16, batch=256, test_set_size=64, sync_every=4,
                chain=4)
SPMD_PROTOCOLS = ("Synchronous", "EASGD", "GM", "FGM", "Asynchronous", "SSP")
SPMD_MESH = (8, 2)  # the JAX engine's 8-device CPU mesh, hub 2, as a leading axis
SPMD_CHECK = dict(steps=12, batch=256)


def _bench_lines(rows) -> str:
    """JSON lines of _gen_stream_file's shape from an array of rows of dim
    features and the target (a worker of write_bench_stream's pool)."""
    dim = rows.shape[1] - 1
    rows = rows.tolist()
    line = ('{"numericalFeatures": [' + ", ".join(["%.6f"] * dim)
            + '], "target": %.1f, "operation": "training"}')
    return "\n".join(line % tuple(r) for r in rows) + "\n"


def write_bench_stream(path: Path, n: int, seed: int, dim: int = 28) -> int:
    """The lines of run_benchmarks.py's _gen_stream_file (:769): ``dim``
    standard normals rounded to 6 places, the {0, 1} target of a planted
    linear rule, "operation": "training"; drawn from RandomState(seed) in
    chunks of 20,000 rows, as that generator draws them. The text is
    formatted by a pool of processes, one a core up to 8, and written in
    order. Returns the file's bytes."""
    import multiprocessing
    import os

    import numpy as np

    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    chunks = []
    for start in range(0, n, 20_000):
        x = np.round(rng.randn(min(20_000, n - start), dim), 6)
        chunks.append(np.concatenate([x, (x @ w > 0)[:, None]], axis=1))
    workers = max(1, min(8, os.cpu_count() or 1, len(chunks)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool, open(path, "w") as f:
        for text in pool.imap(_bench_lines, chunks):
            f.write(text)
    return path.stat().st_size


def _bench_create(codec=None) -> dict:
    """_make_e2e_job's Create (with ``codec``, it arms that ``comm.codec``)."""
    b = BENCH_JOB
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "Softmax", "hyperParameters": {"learningRate": 0.05, "nClasses": 2},
                    "dataStructure": {"nFeatures": b["dim"]}},
        "preProcessors": [],
        "trainingConfiguration": {"protocol": "Synchronous", "engine": "spmd",
                                  "extra": {"stageChain": b["chain"]}},
    }
    if codec is not None:
        create["trainingConfiguration"]["comm"] = {"codec": codec}
    return create


def _bench_job(device, codec=None, ingest=""):
    """_make_e2e_job's job on ``device`` (``ingest``: its JobConfig.ingest):
    (job, bridge)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    b = BENCH_JOB
    job = StreamJob(JobConfig(parallelism=b["parallelism"], batch_size=b["batch"], ingest=ingest),
                    device=device)
    job.process_event("requests", json.dumps(_bench_create(codec)))
    [bridge] = job.spmd_bridges.values()
    return job, bridge


class _NopTrainer:
    """The bench's device stub (run_benchmarks.py:919-965): t_host is the
    fused ingest with every launch taken out."""
    fitted = 0

    def step_many_dense(self, *a, **k):
        pass

    def step(self, *a, **k):
        pass

    def predict(self, x):
        import numpy as np

        return np.zeros(x.shape[0])


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _bench_run(torch, path: Path, device: str, route: str, codec=None):
    """One timed bench run: the job built, then the file through
    ``route`` (``fused``: StreamJob.run_file_fused, which takes the
    overlapped route for Synchronous; ``serial``: the bridge's serial
    ingest_file), the stage drained and the trained parameters read back,
    which ends the timing. Returns (job, bridge, wall s, counts): the
    step_many_dense calls (stages), the calls made off the main thread (the
    dispatch thread's), the single steps (tails) and the packed blocks."""
    import threading

    job, bridge = _bench_job(device, codec)
    tr = bridge.trainer
    counts = {"stages": 0, "stages_off_main": 0, "steps": 0, "packed_blocks": 0}
    many, step, packed = tr.step_many_dense, tr.step, job.process_packed_batch

    def count_many(*a, **k):
        counts["stages"] += 1
        counts["stages_off_main"] += threading.current_thread() is not threading.main_thread()
        return many(*a, **k)

    def count_step(*a, **k):
        counts["steps"] += 1
        return step(*a, **k)

    def count_packed(*a, **k):
        counts["packed_blocks"] += 1
        return packed(*a, **k)

    tr.step_many_dense, tr.step, job.process_packed_batch = count_many, count_step, count_packed
    check(job.fused_file_bridge() is bridge, f"bench[{route}]: the job does not qualify for "
          "the fused route")
    t0 = time.perf_counter()
    if route == "fused":
        check(job.run_file_fused(str(path)), "bench: run_file_fused refused the job")
    else:
        bridge.ingest_file(str(path))
    bridge.flush()
    tr.global_flat_params()
    _sync(torch, device)
    return job, bridge, time.perf_counter() - t0, counts


def _bench_probe(path: Path, rows: int = 512):
    """The first ``rows`` records' features of a bench file."""
    import numpy as np

    with open(path) as f:
        return np.array([json.loads(line)["numericalFeatures"] for _, line in zip(range(rows), f)],
                        np.float32)


def _bench_outcome(job, bridge, probe):
    """A finished bench run's (statistics, probe predictions, flat
    parameters); terminates the job."""
    preds = bridge.trainer.predict(probe)
    [stats] = job.terminate().statistics
    return stats, preds, bridge.trainer.global_flat_params()


def _stat_diff(a, b) -> dict:
    """The integer fields of two JobStatistics entries that differ, and the
    float fields past 1e-4 (wall-clock fields left out)."""
    a, b = a.to_dict(), b.to_dict()
    return {k: (a[k], b[k]) for k in b
            if isinstance(b[k], (int, float)) and not isinstance(b[k], bool)
            and (a[k] != b[k] if isinstance(b[k], int) else abs(a[k] - b[k]) > 1e-4)
            and "Ms" not in k and "Seconds" not in k}


def _check_bench_parity(label, card, cpu) -> float:
    """One bench job's outcome on the card against the CPU's: predictions
    equal, statistics equal (the score within 1e-4, wall-clock fields left
    out), parameters within W_RTOL, W_ATOL. Returns the parameters'
    max|d|."""
    import numpy as np

    (sa, pa, fa), (sb, pb, fb) = card, cpu
    check(np.array_equal(pa, pb), f"{label}: {int((pa != pb).sum())} of {len(pa)} predictions "
          "differ on the card and the CPU")
    diff = _stat_diff(sa, sb)
    check(not diff, f"{label}: statistics differ on the card and the CPU: {diff}")
    err = float(np.abs(fa - fb).max())
    check(np.allclose(fa, fb, rtol=W_RTOL, atol=W_ATOL), f"{label}: params max|d|={err:.3e}")
    return err


def phase_bench(torch, seed, records, tmp: Path, card: str, device="cuda"):
    """Phase 24: the bench.py route on the card; returns the bench file's
    path and a summary."""
    import numpy as np

    path = tmp / "bench.jsonl"
    t0 = time.perf_counter()
    n_bytes = write_bench_stream(path, records, seed)
    log(f"bench: wrote {records} records ({n_bytes} bytes) in {time.perf_counter() - t0:.2f} s "
        "(untimed)")
    warm = tmp / "bench_warm.jsonl"
    write_bench_stream(warm, 3 * BENCH_JOB["chain"] * BENCH_JOB["batch"], seed + 1)
    # untimed warm-up: the native parser's build, first launches, the allocator
    for route in ("fused", "serial"):
        job, _, _, _ = _bench_run(torch, warm, device, route)
        job.terminate()

    job, bridge, wall_over, counts = _bench_run(torch, path, device, "fused")
    probe = _bench_probe(path)
    outcome = _bench_outcome(job, bridge, probe)
    stats = outcome[0]
    check(counts["packed_blocks"] == 0, "bench: the packed route ran")
    check(counts["stages"] > 0 and counts["stages_off_main"] == counts["stages"],
          f"bench: the overlapped route did not dispatch the stages: {counts}")
    check(stats.protocol == "Synchronous" and stats.score > 0.9,
          f"bench: protocol {stats.protocol}, score {stats.score}")
    fitted = bridge.trainer.fitted
    job_s, bridge_s, wall_serial, counts_s = _bench_run(torch, path, device, "serial")
    job_s.terminate()
    check(counts_s["stages_off_main"] == 0 and bridge_s.trainer.fitted == fitted,
          f"bench: the serial route: {counts_s}, fitted {bridge_s.trainer.fitted} vs {fitted}")

    # t_host: the serial fused ingest with the device stubbed, a warm pass,
    # then the best of 3 (the bench's definition)
    job_h, bridge_h = _bench_job(device)
    bridge_h.trainer = _NopTrainer()
    host = []
    for i in range(4):
        t0 = time.perf_counter()
        bridge_h.ingest_file(str(path))
        bridge_h.flush()
        if i:
            host.append(time.perf_counter() - t0)
    t_host = min(host)

    # the same file on the CPU: the card's run must give its statistics,
    # its predictions on the file's first 512 records and its parameters
    if device == "cuda":
        job_c, bridge_c, _, _ = _bench_run(torch, path, "cpu", "fused")
        err = _check_bench_parity("bench", outcome, _bench_outcome(job_c, bridge_c, probe))
        log(f"bench: the card against the CPU on all {records} records: statistics equal, "
            f"{len(probe)} probe predictions equal, params max|d|={err:.3e}")

    summary = {
        "records": records, "bytes": n_bytes, "fitted": fitted, "score": stats.score,
        "records_per_s_overlapped": records / wall_over, "wall_overlapped_s": wall_over,
        "records_per_s_serial": records / wall_serial, "wall_serial_s": wall_serial,
        "records_per_s_host": records / t_host, "t_host_s": t_host,
        "host_samples_s": host, "stages": counts["stages"], "tail_steps": counts["steps"],
        "bytesShipped": stats.bytes_shipped, "modelsShipped": stats.models_shipped,
        "numOfBlocks": stats.num_of_blocks,
    }
    if device == "cuda":
        summary.update(_bench_device_profile(torch, path, wall_over, bridge))
    log("bench: " + json.dumps(summary))
    print(json.dumps({
        "metric": BENCH_METRIC,
        "value": round(records / wall_over, 1),
        "unit": "examples/sec",
        "vs_baseline": round(records / wall_over / BENCH_BASELINE, 3),
        "backend": device,
        "device": card,
        "records": records,
        "serial_examples_per_sec": round(records / wall_serial, 1),
        "host_examples_per_sec": round(records / t_host, 1),
        "idle_share": summary.get("idle_share"),
    }), flush=True)
    return path, summary


def _bench_device_profile(torch, path: Path, wall_over: float, bridge):
    """The overlapped run again under torch.profiler: device busy time, the
    idle share against the unprofiled run's wall, kernels a run; then one
    stage (a step_many_dense call of the bench's shape) alone: its kernel
    launches."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_launches(events):
        return sum(e.count for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset")))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        job, _, wall_prof, counts = _bench_run(torch, path, "cuda", "fused")
    job.terminate()
    avg = tp.key_averages()
    busy_s = sum(_dev_us(e) for e in avg if e.device_type == DeviceType.CUDA) / 1e6
    check(busy_s > 0, "bench: torch.profiler traced no device time")
    b = BENCH_JOB
    xs = np.zeros((b["chain"], 1, b["batch"], b["dim"]), np.float32)
    ys = np.zeros((b["chain"], 1, b["batch"]), np.float32)
    tr = bridge.trainer
    tr.step_many_dense(xs, ys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as ts:
        tr.step_many_dense(xs, ys)
        torch.cuda.synchronize()
    per_stage = kernel_launches(ts.key_averages())
    top = sorted((e for e in avg if e.device_type == DeviceType.CUDA), key=lambda e: -_dev_us(e))
    log("bench: top device time under torch.profiler: " + "; ".join(
        f"{_dev_us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}" for e in top[:6]))
    return {
        "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_over,
        "profiled_wall_s": wall_prof, "kernels_in_run": kernel_launches(avg),
        "kernel_launches_per_stage": per_stage,
        "kernel_launches_per_step": per_stage / b["chain"],
    }


def _spmd_create(protocol: str, per_record: bool = False) -> dict:
    r = SPMD_RUN
    tc = {"protocol": protocol, "syncEvery": r["sync_every"], "engine": "spmd",
          "stageChain": r["chain"]}
    if per_record:
        tc["perRecord"] = True
    return _create({"name": "PA", "hyperParameters": {"C": 1.0}}, [], tc, 28)


def phase_spmd_protocols(torch, pa_scan, sparse, seed, tmp: Path, device="cuda"):
    """Phase 25: protocol_comparison.py's SPMD section, then perRecord PA
    (pa_scan) and phase 14's sparse PA-II (scatter_add) on the engine;
    returns (rows, pa_scan launches, scatter_add launches by route)."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    r = SPMD_RUN
    x, y = protocol_stream(r["records"])
    op = np.zeros((r["records"],), np.uint8)
    warm = min(r["parallelism"] * r["batch"] * 4, r["records"])
    run_packed(torch, _spmd_create(SPMD_PROTOCOLS[0]), x[:warm], y[:warm], op[:warm],
               r["parallelism"], r["batch"], r["test_set_size"], device)
    rows = {}
    for protocol in SPMD_PROTOCOLS:
        job, report, wall = run_packed(torch, _spmd_create(protocol), x, y, op, r["parallelism"],
                                       r["batch"], r["test_set_size"], device)
        [stats] = report.statistics
        check(0 in job.spmd_bridges and stats.protocol == protocol,
              f"spmd[{protocol}]: not on the SPMD engine")
        check(stats.fitted > 0.9 * r["records"] and stats.score > 0.8,
              f"spmd[{protocol}]: fitted {stats.fitted}, score {stats.score}")
        rows[protocol] = {
            "records_per_s": r["records"] / wall, "wall_s": wall, "score": stats.score,
            "fitted": stats.fitted, "bytesShipped": stats.bytes_shipped,
            "modelsShipped": stats.models_shipped, "numOfBlocks": stats.num_of_blocks,
            "workers": job.spmd_bridges[0].dp,
        }
        log(f"spmd: {protocol}: " + json.dumps(rows[protocol]))

    pa_scan.launches = 0
    job, report, wall = run_packed(torch, _spmd_create("Synchronous", per_record=True), x, y, op,
                                   r["parallelism"], r["batch"], r["test_set_size"], device)
    pa_launches = pa_scan.launches
    [stats] = report.statistics
    steps = len(stats.learning_curve) * job.spmd_bridges[0].dp
    log(f"spmd: Synchronous perRecord: {r['records'] / wall:.0f} records/s, pa_scan launches "
        f"{pa_launches}, worker-steps {steps}, score {stats.score:.4f}")
    if device == "cuda":
        check(pa_launches == steps > 0,
              f"spmd: pa_scan launches {pa_launches} != worker-steps {steps}")

    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": CRITEO_DIM,
                                      "hashSpace": CRITEO_HASH, "maxNnz": CRITEO_NNZ}},
        "trainingConfiguration": {"protocol": "Synchronous", "engine": "spmd"},
    }
    events = criteo_events(PROTOCOL_SPARSE_RECORDS, seed, None, create=create)
    train, _ = write_stream_files(events, tmp, "spmd_sparse")
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    scatter = {}
    # parserThreads 1: the fused COO line loop; 0 (auto, one a core up to
    # 8): the multithreaded block parse of padded-COO rows and the C stager
    for route, threads in (("fused", 1), ("blocks", 0)):
        tc = dict(create["trainingConfiguration"], parserThreads=threads)
        job = StreamJob(JobConfig(**SLICE_CONFIG), device=device)
        job.process_event("requests", json.dumps(dict(create, trainingConfiguration=tc)))
        bridge = job.fused_file_bridge()
        check(bridge is not None and bridge.supports_overlapped_ingest(),
              f"spmd sparse[{route}]: the job does not take the overlapped fused route")
        for name in sparse.launches:
            sparse.launches[name] = 0
        t0 = time.perf_counter()
        check(job.run_file_fused(str(train)), f"spmd sparse[{route}]: run_file_fused refused")
        report = job.terminate()
        _sync(torch, device)
        wall = time.perf_counter() - t0
        launched = dict(sparse.launches)
        [stats] = report.statistics
        steps = len(stats.learning_curve)
        log(f"spmd: sparse Synchronous [{route}]: {len(events) / wall:.0f} records/s, launches "
            f"{launched}, steps {steps}, score {stats.score:.4f}, forecasts "
            f"{len(job.predictions)}")
        check(len(job.predictions) == n_fore and stats.score > 0.6,
              f"spmd sparse[{route}]: {len(job.predictions)} predictions, score {stats.score}")
        if device == "cuda":
            check(launched["scatter_add"] == steps > 0 and launched["scatter_add_outer"] == 0,
                  f"spmd sparse[{route}]: launches {launched} against {steps} steps")
        scatter[route] = launched["scatter_add"]
        rows[f"sparse_{route}"] = {"records_per_s": len(events) / wall, "score": stats.score,
                                   "steps": steps, "scatter_add": launched["scatter_add"]}
    return rows, pa_launches, scatter


def _spmd_check_batches(kind: str, seed: int):
    """SPMD_CHECK steps of [dp, B] batches for the card-vs-CPU run: ragged
    masks, a worker idle on some steps, and on a quarter of the steps every
    worker but 0 idle (so SSP refuses a batch now and then)."""
    import numpy as np

    dp = SPMD_MESH[0]
    b = SPMD_CHECK["batch"]
    rng = np.random.RandomState(seed)
    out = []
    for t in range(SPMD_CHECK["steps"]):
        m = np.ones((dp, b), np.float32)
        m[:, rng.randint(b // 2, b + 1):] = 0.0
        if t % 4 == 3:
            m[1:] = 0.0
        elif t % 3 == 1:
            m[t % dp] = 0.0
        if kind == "sparse":
            x = (rng.randint(0, CRITEO_DIM, size=(dp, b, CRITEO_NNZ)).astype(np.int32),
                 rng.randn(dp, b, CRITEO_NNZ).astype(np.float32))
            y = (x[1][:, :, 0] > 0).astype(np.float32)
        else:
            xd = rng.randn(dp, b, N_FEATURES).astype(np.float32)
            x, y = xd, (xd.sum(-1) > 0).astype(np.float32)
        out.append((x, y, m))
    return out


SPMD_CHECK_LEARNERS = {
    "softmax": ({"name": "Softmax", "hyperParameters": {"learningRate": 0.05, "nClasses": 2}},
                False, "dense"),
    "pa_per_record": ({"name": "PA", "hyperParameters": {"C": 1.0}}, True, "dense"),
    "sparse_pa2": ({"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": CRITEO_DIM,
                                      "hashSpace": CRITEO_HASH, "maxNnz": CRITEO_NNZ,
                                      "scatterImpl": "scatter"}}, False, "sparse"),
}


def phase_spmd_parity(torch, pa_scan, sparse, seed, bench_path: Path, tmp: Path,
                      devices=("cuda", "cpu")):
    """Phase 26: SPMDTrainer on an explicit Mesh(8, 2) leading axis on the
    card and on the CPU, the 6 protocols x 3 learners on the same batches;
    then the bench job's first BENCH_PARITY_ROWS rows on both. Returns the
    kernels' launches on the card's runs."""
    import numpy as np

    from omldm_tpu_torch.api.requests import LearnerSpec, TrainingConfiguration
    from omldm_tpu_torch.parallel.mesh import Mesh
    from omldm_tpu_torch.parallel.spmd import SPMDTrainer

    dp, hub = SPMD_MESH
    launches = {"pa_scan": 0, "pa_scan_batched": 0, "scatter_add": 0}
    worst = 0.0
    for label, (learner, per_record, kind) in SPMD_CHECK_LEARNERS.items():
        batches = _spmd_check_batches(kind, seed)
        dim = CRITEO_DIM if kind == "sparse" else N_FEATURES
        for protocol in SPMD_PROTOCOLS:
            # staleness 1 makes SSP refuse a batch after each step where
            # worker 0 alone had rows; threshold 0.05 lets GM and FGM fire
            tc = TrainingConfiguration(protocol=protocol, per_record=per_record,
                                       extra={"syncEvery": 2, "threshold": 0.05,
                                              "staleness": 1})
            trainers = {}
            for d in devices:
                pa_scan.launches = pa_scan.batched_launches = 0
                for name in sparse.launches:
                    sparse.launches[name] = 0
                t = SPMDTrainer(LearnerSpec(learner["name"],
                                            hyper_parameters=learner["hyperParameters"],
                                            data_structure=learner.get("dataStructure")),
                                dim=dim, protocol=protocol, mesh=Mesh(dp, hub, d),
                                training_configuration=tc, batch_size=SPMD_CHECK["batch"])
                for x, y, m in batches:
                    t.step(x, y, m)
                    acc = t.last_accepted()
                    for w in np.nonzero(~acc)[0]:
                        t.note_requeued(int(m[w].sum()))
                _sync(torch, d)
                if d == "cuda":
                    launches["pa_scan"] += pa_scan.launches
                    launches["pa_scan_batched"] += pa_scan.batched_launches
                    launches["scatter_add"] += sparse.launches["scatter_add"]
                    steps = len(batches)
                    # per-record workers scan in ONE batched launch a step
                    want = {"pa_scan": 0, "pa_scan_batched": steps if per_record else 0,
                            "scatter_add": steps if kind == "sparse" else 0}
                    got = {"pa_scan": pa_scan.launches,
                           "pa_scan_batched": pa_scan.batched_launches,
                           "scatter_add": sparse.launches["scatter_add"]}
                    check(got == want, f"spmd-parity[{label}, {protocol}]: launches {got}, "
                          f"expected {want}")
                trainers[d] = t
            a, b = (trainers[d] for d in devices)
            ints = {
                "sync_count": (a.sync_count(), b.sync_count()),
                "bytes_shipped": (a.bytes_shipped(), b.bytes_shipped()),
                "collective_bytes_physical": (a.collective_bytes_physical(),
                                              b.collective_bytes_physical()),
                "worker_clocks": (a.worker_clocks().tolist(), b.worker_clocks().tolist()),
                "fitted": (a.fitted, b.fitted),
            }
            check(all(u == v for u, v in ints.values()),
                  f"spmd-parity[{label}, {protocol}]: counters differ: {ints}")
            pa = a._flat(a.state["params"]).cpu().numpy()
            pb = b._flat(b.state["params"]).cpu().numpy()
            err = float(np.abs(pa - pb).max())
            worst = max(worst, err)
            check(np.allclose(pa, pb, rtol=W_RTOL, atol=W_ATOL),
                  f"spmd-parity[{label}, {protocol}]: params max|d|={err:.3e}")
            log(f"spmd-parity: {label} {protocol} dp {dp} hub {hub}: syncs {ints['sync_count'][0]}, "
                f"bytesShipped {ints['bytes_shipped'][0]}, clocks {ints['worker_clocks'][0]}, "
                f"fitted {ints['fitted'][0]}, params max|d|={err:.3e}")

    # the bench job's first rows on the card and on the CPU
    head = tmp / "bench_head.jsonl"
    with open(bench_path) as src, open(head, "w") as dst:
        for _, line in zip(range(BENCH_PARITY_ROWS), src):
            dst.write(line)
    probe = _bench_probe(head)
    results = []
    for d in devices:
        job, bridge, _, _ = _bench_run(torch, head, d, "fused")
        results.append(_bench_outcome(job, bridge, probe))
    err = _check_bench_parity("spmd-parity[bench]", *results)
    sa, sb = results[0][0].to_dict(), results[1][0].to_dict()
    log(f"spmd-parity: bench job, first {BENCH_PARITY_ROWS} rows: fitted {sb['fitted']}, "
        f"score {sb['score']:.4f} / {sa['score']:.4f}, 512 probe predictions equal, params "
        f"max|d|={err:.3e}; the trainers' worst params max|d|={worst:.3e}")
    return launches


# host functions the bench-route profile reports: (label, file suffix, function name)
BENCH_PROFILE_FUNCS = [
    ("fused loop (C parse, holdout, stage; Python cursors)", "runtime/spmd_bridge.py",
     "_fused_consume"),
    ("C parse_stage calls", "ops/native/loader.py", "parse_stage"),
    ("stage launches (_launch)", "runtime/spmd_bridge.py", "_launch"),
    ("upload (SPMDTrainer._to_device)", "parallel/spmd.py", "_to_device"),
    ("fleet steps (_step_impl)", "parallel/spmd.py", "_step_impl"),
    ("learner updates (_local_update)", "parallel/spmd.py", "_local_update"),
    ("flat and collective (_flat, _ps_allreduce, _unflat)", "parallel/spmd.py", "_flat"),
    ("read back (global_flat_params)", "parallel/spmd.py", "global_flat_params"),
]


def phase_bench_profile(torch, path: Path, out_dir: Path):
    """The bench job's serial fused route under cProfile (the main thread
    alone: Python 3.12's cProfile folds every thread into one profile):
    host seconds by function."""
    import cProfile
    import io
    import pstats

    out_dir.mkdir(parents=True, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    job, _, wall, _ = _bench_run(torch, path, "cuda", "serial")
    prof.disable()
    job.terminate()
    st = pstats.Stats(prof)
    st.dump_stats(str(out_dir / "bench.pstats"))
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
    (out_dir / "bench_cprofile.txt").write_text(buf.getvalue())
    host = {}
    for (fpath, _, name), (_, _, _, ct, _) in st.stats.items():
        for label, suffix, fname in BENCH_PROFILE_FUNCS:
            if name == fname and fpath.endswith(suffix):
                host[label] = host.get(label, 0.0) + ct
    log(f"profile[bench]: cProfile wall {wall:.3f} s (serial route, profiler overhead "
        "included); cumulative host seconds by function:")
    for label, _, _ in BENCH_PROFILE_FUNCS:
        log(f"  {label}: {host.get(label, 0.0):.3f}")


# --- the multi-tenant cohort engine ---------------------------------------------

# (members C, rows B, width D + 1) of the batched pa_scan's check and time;
# (64, 256, 29) is the multi-tenant stream's gang step
# --- phase 46: the sharded ingest plane and the device-resident stage -----------

# the bench file's first INGEST_LINES lines: the phase reads its file eight
# times (four routes, a killed parser, the stubbed-device sharded and
# single-parse rates, a profiled run); the whole 1,000,000-line file would
# take it past ~30 s (the log prints the projection)
INGEST_LINES = 200_000
INGEST_PA_LINES = 50_000  # phase 25's perRecord PA job on the sharded route: its 50,000 records


def ingest_shards() -> int:
    """run_benchmarks.py:1081-1083's shard count: one parser a spare core."""
    import os

    return max((os.cpu_count() or 1) - 1, 1)


def head_file(src: Path, dst: Path, lines: int) -> Path:
    """The first ``lines`` lines of ``src`` in ``dst``."""
    with open(src) as f, open(dst, "w") as out:
        for _, line in zip(range(lines), f):
            out.write(line)
    return dst


def _ingest_run(torch, path: Path, route: str, ingest: str = "", kill: bool = False):
    """One timed run of the bench job over ``path``: ``packed`` (the file as
    iter_file_batches blocks through process_packed_batch) or ``sharded``
    (StreamJob.run_file_sharded under ``ingest``); ``kill`` SIGKILLs parser
    1 when the first block reaches the job. The stage drained and the
    parameters read back end the timing. Returns (job, bridge, wall s)."""
    import multiprocessing
    import os
    import signal

    from omldm_tpu_torch.runtime.fast_ingest import iter_file_batches

    job, bridge = _bench_job("cuda", ingest=ingest)
    if kill:
        real = job.process_packed_batch

        def process(*block):
            for p in multiprocessing.active_children():
                if p.name == "ingest-shard-1" and p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
                    p.join(timeout=5.0)
            return real(*block)

        job.process_packed_batch = process
    t0 = time.perf_counter()
    if route == "packed":
        for block in iter_file_batches(str(path), BENCH_JOB["dim"], PACKED_CHUNK):
            job.process_packed_batch(*block)
    else:
        check(job.run_file_sharded(str(path), dim=BENCH_JOB["dim"]),
              f"ingest[{route}]: run_file_sharded refused the job")
    bridge.flush()
    bridge.trainer.global_flat_params()
    torch.cuda.synchronize()
    return job, bridge, time.perf_counter() - t0


def _ingest_outcome(job, bridge):
    """(fitted, score, flat parameters, holdout x, holdout y) of a finished
    run; terminates the job."""
    if bridge._resident is not None:
        bridge._resident.sync_host()
    [stats] = job.terminate().statistics
    return (stats.fitted, stats.score, bridge.trainer.global_flat_params(),
            *bridge.test_set.arrays())


def _same_outcome(label, a, b) -> None:
    import numpy as np

    check(a[:2] == b[:2], f"{label}: fitted, score {a[:2]} against {b[:2]}")
    for name, u, v in zip(("parameters", "holdout x", "holdout y"), a[2:], b[2:]):
        check(u.shape == v.shape and np.array_equal(u, v),
              f"{label}: {name} differ in {int((u != v).sum()) if u.shape == v.shape else 'shape'}")


def _stub_seconds(path: Path, shards: int):
    """run_benchmarks.py's sharded-ingest leg (:1073-1100) on phase 46's
    file: (t_sharded, t_host), each the best of 3 after a warm pass, with
    the bench bridge's device stubbed out (_NopTrainer): ShardedIngest at
    ``shards`` parsers feeding handle_batch, and the serial fused ingest."""
    from omldm_tpu_torch.runtime.ingest_shard import IngestConfig, ShardedIngest

    _, bridge = _bench_job("cuda")
    bridge.trainer = _NopTrainer()

    def sharded():
        si = ShardedIngest(str(path), BENCH_JOB["dim"], IngestConfig(shards=shards))
        try:
            for block in si.blocks():
                bridge.handle_batch(*block)
        finally:
            si.close()
        bridge.flush()

    def single():
        bridge.ingest_file(str(path))
        bridge.flush()

    out = []
    for fn in (sharded, single):
        samples = []
        for i in range(4):
            t0 = time.perf_counter()
            fn()
            if i:
                samples.append(time.perf_counter() - t0)
        out.append(min(samples))
    return tuple(out)


def _sharded_breakdown(path: Path, lines: int, shards: int) -> dict:
    """One pass of the stubbed-device sharded ingest over ``path``, its host
    seconds split: the rings' allocation and the forks (the constructor),
    the wait for the first block, the blocks through handle_batch, and the
    workers' reaping (close, which the block iterator runs when it ends);
    beside the driver's resident and mapped memory, which each fork copies
    the page tables of."""
    from omldm_tpu_torch.runtime.ingest_shard import IngestConfig, ShardedIngest

    _, bridge = _bench_job("cuda")
    bridge.trainer = _NopTrainer()
    with open("/proc/self/status") as f:
        status = dict(line.split(":", 1) for line in f if ":" in line)
    t0 = time.perf_counter()
    si = ShardedIngest(str(path), BENCH_JOB["dim"], IngestConfig(shards=shards))
    t1 = time.perf_counter()
    blocks = si.blocks()
    bridge.handle_batch(*next(blocks))
    t2 = time.perf_counter()
    t3 = t2
    for block in blocks:
        bridge.handle_batch(*block)
        t3 = time.perf_counter()
    t4 = time.perf_counter()
    bridge.flush()
    return {"lines": lines, "init_s": t1 - t0, "first_block_s": t2 - t1,
            "blocks_s": t3 - t2, "close_s": t4 - t3, "total_s": t4 - t0,
            "driver_rss": status.get("VmRSS", "").strip(),
            "driver_vm": status.get("VmSize", "").strip(), **si.stats()}


def phase_ingest(torch, pa_scan, bench_path: Path, records: int, tmp: Path, card: str):
    """Phase 46: phase 24's bench job over the first INGEST_LINES of the
    bench file's ``records`` lines through the packed route, run_file_sharded at
    ingest_shards() parsers, the same with device=on and the CLI's
    --ingest: fitted count, score, parameters and holdout bitwise equal on
    the first three, no degrade and the resident stage armed on clean runs,
    a SIGKILLed parser degrading with class crash to the same bits; the
    stubbed-device sharded rate against the single parse; driver wait,
    starvation and the device's idle share with device=on under
    torch.profiler; then phase 25's perRecord PA job on the sharded route,
    pa_scan launched once a worker-step. Returns the pa_scan launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    t_phase = time.perf_counter()
    n = ingest_shards()
    lines, pa_lines = min(INGEST_LINES, records), min(INGEST_PA_LINES, records)
    path = head_file(bench_path, tmp / "ingest.jsonl", lines)
    sharded, resident = f"shards={n}", f"shards={n},device=on"
    runs, walls, stats = {}, {}, {}
    for label, route, ingest in (("packed", "packed", ""), ("sharded", "sharded", sharded),
                                 ("sharded_device", "sharded", resident)):
        job, bridge, walls[label] = _ingest_run(torch, path, route, ingest)
        stats[label] = job._ingest_stats
        if route == "sharded":
            check(stats[label].get("degraded") is None and stats[label]["rows"] == lines,
                  f"ingest[{label}]: a clean run degraded or lost rows: {stats[label]}")
            check((bridge._resident is not None) == ingest.endswith("device=on"),
                  f"ingest[{label}]: resident stage {bridge._resident is not None}")
        runs[label] = _ingest_outcome(job, bridge)
    for label in ("sharded", "sharded_device"):
        _same_outcome(f"ingest[{label}] against the packed route", runs[label], runs["packed"])
    fitted, score = runs["packed"][:2]
    check(fitted > 0.75 * lines and score > 0.9, f"ingest: fitted {fitted}, score {score}")
    log(f"ingest: packed, sharded ({sharded}) and sharded with device=on: fitted {fitted}, score "
        f"{score}, parameters and holdout bitwise equal; no degrade; the resident stage armed")

    # a parser SIGKILLed mid-stream (256 KB chunks: parser 1 owns chunks to
    # the file's end, and a ring of one slot holds it back from finishing
    # before the first block reaches the job): degraded with class crash,
    # the same bits
    job, bridge, _ = _ingest_run(torch, path, "sharded", f"{resident},chunkKb=256,ring=1",
                                 kill=True)
    killed = job._ingest_stats
    check(killed.get("degraded", {}).get("class") == "crash",
          f"ingest: a SIGKILLed parser gave {killed.get('degraded')}")
    _same_outcome("ingest[killed parser]", _ingest_outcome(job, bridge), runs["packed"])
    log(f"ingest: parser 1 SIGKILLed at the first block: degraded {killed['degraded']}, "
        "rows and model bitwise the clean run's")

    # the CLI with --ingest
    reqs = tmp / "ingest_requests.jsonl"
    reqs.write_text(json.dumps(_bench_create()) + "\n")
    perf = tmp / "ingest_cli_perf.jsonl"
    calls = []
    real = cli.StreamJob.run_file_sharded  # the class the CLI builds its job from

    def spy(self, *a, **k):
        calls.append(a[0])
        return real(self, *a, **k)

    cli.StreamJob.run_file_sharded = spy
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--trainingData", str(path), "--requests", str(reqs), "--parallelism",
                       str(BENCH_JOB["parallelism"]), "--batchSize", str(BENCH_JOB["batch"]),
                       "--ingest", sharded, "--performanceOut", str(perf)])
        torch.cuda.synchronize()
        walls["cli"] = time.perf_counter() - t0
    finally:
        cli.StreamJob.run_file_sharded = real
    [report] = [json.loads(line) for line in perf.read_text().splitlines()]
    [cst] = report["statistics"]
    check(rc == 0 and calls == [str(path)], f"ingest[cli]: rc {rc}, sharded runs {calls}")
    check((cst["fitted"], cst["score"]) == (fitted, score),
          f"ingest[cli]: fitted, score {(cst['fitted'], cst['score'])} against {(fitted, score)}")

    # the ingest plane's own rate with the device stubbed (the JAX bench
    # leg's sharded_vs_single), and the device's idle share with device=on
    t_sharded, t_host = _stub_seconds(path, n)
    # where the sharded pass's host time goes, on the cut file and the whole
    for label, file, count in (("cut", path, lines), ("whole", bench_path, records)):
        log(f"ingest: stubbed sharded pass over the {label} file: "
            + json.dumps(_sharded_breakdown(file, count, n)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        job, bridge, wall_prof = _ingest_run(torch, path, "sharded", resident)
    job.terminate()
    busy_s = sum(_dev_us(e) for e in tp.key_averages() if e.device_type == DeviceType.CUDA) / 1e6
    check(busy_s > 0, "ingest: torch.profiler traced no device time")
    summary = {
        "card": card, "lines": lines, "shards": n, "fitted": fitted, "score": score,
        **{f"records_per_s_{k}": lines / w for k, w in walls.items()},
        **{f"wall_{k}_s": w for k, w in walls.items()},
        "stub_sharded_records_per_s": lines / t_sharded,
        "stub_host_records_per_s": lines / t_host,
        "sharded_vs_single": t_host / t_sharded,
        "driver_wait_s": {k: stats[k]["driver_wait_s"] for k in ("sharded", "sharded_device")},
        "starvation": {k: stats[k]["starvation"] for k in ("sharded", "sharded_device")},
        "worker_parse_s": stats["sharded"]["parse_s"],
        "worker_stall_s": stats["sharded"]["worker_stall_s"],
        "device_busy_s_device_on": busy_s,
        "idle_share_device_on": 1.0 - busy_s / walls["sharded_device"],
        "profiled_wall_s": wall_prof,
    }
    for k in walls:
        log(f"ingest: {k}: {lines / walls[k]:.1f} records/s ({walls[k]:.4f} s) on {card}")
    log(f"ingest: stubbed device, {n} parsers: {lines / t_sharded:.1f} records/s against the "
        f"single parse's {lines / t_host:.1f} (sharded_vs_single {t_host / t_sharded:.4f}); "
        f"idle share with device=on {summary['idle_share_device_on']:.4f}")

    # phase 25's perRecord PA job on the sharded route: pa_scan a worker-step
    pa_path = head_file(bench_path, tmp / "ingest_pa.jsonl", pa_lines)
    r = SPMD_RUN
    job = StreamJob(JobConfig(parallelism=r["parallelism"], batch_size=r["batch"],
                              test_set_size=r["test_set_size"], ingest=sharded), device="cuda")
    job.process_event("requests", json.dumps(_spmd_create("Synchronous", per_record=True)))
    pa_scan.launches = 0
    t0 = time.perf_counter()
    check(job.run_file_sharded(str(pa_path), dim=BENCH_JOB["dim"]),
          "ingest[pa]: run_file_sharded refused the job")
    [pst] = job.terminate().statistics
    torch.cuda.synchronize()
    pa_wall = time.perf_counter() - t0
    pa_launches = pa_scan.launches
    steps = len(pst.learning_curve) * job.spmd_bridges[0].dp
    check(pa_launches == steps > 0 and pst.fitted > 0.75 * pa_lines,
          f"ingest[pa]: pa_scan launches {pa_launches} against worker-steps {steps}, "
          f"fitted {pst.fitted}")
    summary.update(pa_records_per_s=pa_lines / pa_wall, pa_scan_launches=pa_launches)
    phase_s = time.perf_counter() - t_phase
    summary["phase_s"] = phase_s
    log(f"ingest: perRecord PA at parallelism {r['parallelism']} on the sharded route: "
        f"{pa_lines / pa_wall:.1f} records/s, pa_scan launches {pa_launches} = "
        f"worker-steps {steps}, score {pst.score:.4f}")
    log(f"ingest: phase 46 took {phase_s:.1f} s on {lines} lines (the whole "
        f"{records}-line file projects to {phase_s * records / lines:.0f} s)")
    log("ingest: " + json.dumps(summary))
    return pa_launches


BATCHED_SHAPES = [(64, 256, 29), (8, 256, 1025), (3, 255, 4097)]
# a 5-member call whose member 2 has an all-zero mask: it keeps w0 bitwise
BATCHED_ZERO_CHECK = (5, 256, 29)
# 96 members at B = 16,384: their Gram matrices (1.07 GB each) would take
# 103 GB at once, past the card's 80 GB; the wrapper launches them in
# groups under SCRATCH_BUDGET_FLOATS (3 a launch). Member 40 (the second
# of a group) has an all-zero mask.
BATCHED_GROUPED_CHECK = (96, 16_384, 29, 40)
# phase 28: 64 same-spec PA perRecord tenants (PA-I, C 0.01) under
# Synchronous at parallelism 2, dim 28 (the bench job's width), every tenth
# record a forecast, serving armed on every other tenant
# the cohort run takes the stream's first main_records rows (cut from
# 50,000, then 25,000, for the script's time limit); the stream itself stays the
# 50,000-row draw, so every run of the phase sees the rows it saw before
MT_RUN = dict(nets=64, records=50_000, main_records=12_500, parallelism=2, batch=256,
              test_set_size=64, prefix_records=5_000)
MT_LEARNER = {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"}}
MT_SERVING = {"maxBatch": 64, "maxDelayMs": 5}
# phase 29: every dense spec of the reference's cohort tests, 8 members
COHORT_SPECS = [
    ("PA", {"C": 1.0}, False, "binary"),
    ("PA", {"C": 1.0}, True, "binary"),
    ("RegressorPA", {"C": 0.1, "epsilon": 0.1}, False, "regression"),
    ("ORR", {"lambda": 1.0}, False, "regression"),
    ("SVM", {}, False, "binary"),
    ("MultiClassPA", {"C": 1.0, "nClasses": 3}, False, "multi3"),
    ("NN", {"hidden": 8}, False, "binary"),
    ("Softmax", {"learningRate": 0.05, "nClasses": 2}, False, "binary"),
]
SPECS_RUN = dict(members=8, records=2_000, parallelism=1, batch=64, test_set_size=32)


def _batched_inputs(torch, C, B, D, seed, zero_member=None):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((C, B, D), generator=g)
    x[..., -1] = 1.0
    w0 = torch.randn((C, D), generator=g) * 0.1
    y = torch.randint(0, 2, (C, B), generator=g).float()
    mask = (torch.rand((C, B), generator=g) > 0.2).float()
    if zero_member is not None:
        mask[zero_member] = 0.0
    return [t.cuda().contiguous() for t in (w0, x, y, mask)]


def _time_once(torch, fn):
    """Events around one call (the plain versions take seconds a call, and
    run torch ops the card has already run)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def batched_bound_ms(C, B, D):
    """``bound_ms`` of C independent scans."""
    t_bytes = C * (B * D + 2 * B + D + D + 1) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * C * B * D / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_batched(torch, pa_scan):
    """Phase 27: pa_scan_update_batched against its plain version (a loop of
    pa_scan_reference over members) at BATCHED_SHAPES, variants PA-I and
    PA-II, and BATCHED_ZERO_CHECK's all-zero member; then its time as a
    CUDA graph against C single pa_scan_update calls as a CUDA graph, its
    device busy time, the plain version once, the bound."""
    max_w = max_l = 0.0
    for C, B, D in BATCHED_SHAPES:
        for variant in ("PA-I", "PA-II"):
            w0, x, y, mask = _batched_inputs(torch, C, B, D, seed=C + B + D)
            kw, kl = pa_scan.pa_scan_update_batched(w0, x, y, mask, variant, 0.5)
            pw, pl = pa_scan.pa_scan_batched_reference(w0, x, y, mask, variant, 0.5)
            torch.cuda.synchronize()
            err_w = (kw - pw).abs().max().item()
            err_l = (kl - pl).abs().max().item()
            check(torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL) and err_l <= LOSS_ATOL,
                  f"pa_scan_batched disagrees at C={C} B={B} D={D} {variant}: "
                  f"max|dw|={err_w} max|dloss|={err_l}")
            max_w, max_l = max(max_w, err_w), max(max_l, err_l)
    C, B, D = BATCHED_ZERO_CHECK
    w0, x, y, mask = _batched_inputs(torch, C, B, D, seed=17, zero_member=2)
    kw, kl = pa_scan.pa_scan_update_batched(w0, x, y, mask, "PA-I", 0.01)
    pw, pl = pa_scan.pa_scan_batched_reference(w0, x, y, mask, "PA-I", 0.01)
    torch.cuda.synchronize()
    check(torch.equal(kw[2], w0[2]) and float(kl[2]) == 0.0,
          "pa_scan_batched: the all-zero-mask member did not keep its w bitwise")
    check(torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL)
          and (kl - pl).abs().max().item() <= LOSS_ATOL,
          "pa_scan_batched disagrees on the 5-member call")
    log(f"batched-check: {2 * len(BATCHED_SHAPES) + 1} kernel-vs-plain cases pass; "
        f"max|dw|={max_w:.3e} max|dloss|={max_l:.3e} (rtol={W_RTOL}, atol={W_ATOL}, loss "
        f"{LOSS_ATOL}); the all-zero member of {C} kept w0 bitwise")
    max_w = max(max_w, _check_grouped(torch, pa_scan))

    out = {}
    for C, B, D in BATCHED_SHAPES:
        w0, x, y, mask = _batched_inputs(torch, C, B, D, seed=99)
        batched = lambda: pa_scan.pa_scan_update_batched(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731

        def singles():
            for m in range(C):
                pa_scan.pa_scan_update(w0[m], x[m], y[m], mask[m], "PA-I", 0.01)

        plain = lambda: pa_scan.pa_scan_batched_reference(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        reps = max(2, 400 // C)
        g1 = _graph_ms(torch, batched, reps)
        s1 = _graph_ms(torch, singles, reps)
        g2 = _graph_ms(torch, batched, reps)
        s2 = _graph_ms(torch, singles, reps)
        busy = _device_ms(torch, batched, 20)
        host = _host_us(torch, batched)
        p = _time_once(torch, plain)
        b, by = batched_bound_ms(C, B, D)
        out[(C, B, D)] = {"ms": g2, "plain_ms": p, "bound_ms": b, "bound_by": by}
        log(f"batched-time: pa_scan_batched C={C} B={B} D+1={D}: CUDA graph {g2:.6f} ms a "
            f"call (turns {g1:.6f} / {g2:.6f}); {C} single pa_scan calls as a CUDA graph "
            f"{s2:.6f} ms (turns {s1:.6f} / {s2:.6f}), ratio {s2 / g2:.2f}x; device busy "
            f"{busy:.6f} ms a call; host {host:.1f} us a call; plain {p:.1f} ms; bound "
            f"{b:.7f} ms ({by}-bound by the roofline; the chain of {B} dependent rows "
            f"bounds each member in fact, one CTA a member); library none")
    return max(max_w, max_l), out


def _check_grouped(torch, pa_scan):
    """BATCHED_GROUPED_CHECK: one batched call whose members' scratch
    would not fit the card at once runs as launches over member groups,
    its peak memory inside the budget; every member held to a single scan
    of its own (the one-scan kernels), the first and last to the plain
    version, the all-zero member to w0 bitwise. Returns the worst |dw|."""
    C, B, D, zero = BATCHED_GROUPED_CHECK
    w0, x, y, mask = _batched_inputs(torch, C, B, D, seed=23, zero_member=zero)
    per = pa_scan.LIBRARY.load().omldm_pa_scan_scratch_floats(B)
    groups = pa_scan.member_groups(C, per)
    whole = C * per * 4
    check(whole > torch.cuda.get_device_properties(0).total_memory,
          f"BATCHED_GROUPED_CHECK's scratch ({whole / 1e9:.1f} GB) fits the card at once")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = pa_scan.batched_launches
    t0 = time.perf_counter()
    kw, kl = pa_scan.pa_scan_update_batched(w0, x, y, mask, "PA-I", 0.01)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launched = pa_scan.batched_launches - before
    check(launched == len(groups) > 1,
          f"pa_scan_batched ran {launched} launches for {len(groups)} member groups")
    budget = pa_scan.SCRATCH_BUDGET_FLOATS * 4
    check(peak <= budget + (C * D + C) * 4 + (1 << 20),
          f"pa_scan_batched peaked at {peak / 1e9:.2f} GB, past its {budget / 1e9:.2f} GB budget")
    check(torch.equal(kw[zero], w0[zero]) and float(kl[zero]) == 0.0,
          "pa_scan_batched (grouped): the all-zero-mask member did not keep its w bitwise")
    worst = 0.0
    for m in range(C):
        if m == zero:
            continue
        sw, sl = pa_scan.pa_scan_update(w0[m], x[m], y[m], mask[m], "PA-I", 0.01)
        err = (kw[m] - sw).abs().max().item()
        check(torch.allclose(kw[m], sw, rtol=W_RTOL, atol=W_ATOL)
              and abs(float(kl[m]) - float(sl)) <= LOSS_ATOL,
              f"pa_scan_batched (grouped) member {m} disagrees with its single scan: "
              f"max|dw|={err}")
        worst = max(worst, err)
    plain_err = 0.0
    for m in (0, C - 1):
        pw, pl = pa_scan.pa_scan_reference(w0[m], x[m], y[m], mask[m], "PA-I", 0.01)
        err = (kw[m] - pw).abs().max().item()
        check(torch.allclose(kw[m], pw, rtol=W_RTOL, atol=W_ATOL)
              and abs(float(kl[m]) - float(pl)) <= LOSS_ATOL,
              f"pa_scan_batched (grouped) member {m} disagrees with the plain version: "
              f"max|dw|={err}")
        plain_err = max(plain_err, err)
    log(f"batched-check: C={C} B={B} D+1={D}: {whole / 1e9:.1f} GB of scratch at once, run "
        f"as {launched} launches of at most {groups[0][1] - groups[0][0]} members in "
        f"{secs:.3f} s, peak {peak / 1e9:.2f} GB (budget {budget / 1e9:.2f} GB); every "
        f"member against its single scan max|dw|={worst:.3e}, members 0 and {C - 1} "
        f"against the plain version max|dw|={plain_err:.3e}; member {zero} kept w0 bitwise")
    return max(worst, plain_err)


def phase_ab_pa_scan(torch, pa_scan, src: Path):
    """--ab-pa-scan SRC: this checkout's one-scan kernel against another
    checkout's (SRC: its omldm_tpu_torch/csrc/pa_scan.cu) in one process, a
    call as a CUDA graph of 200 calls at TIME_SHAPES, in turns this, other,
    other, this, this, other (the best of each reported), and their outputs
    compared. Returns {shape: (this ms, other ms)}."""
    import ctypes

    from omldm_tpu_torch.ops._build import KernelLibrary

    def configure(lib):
        lib.omldm_pa_scan.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.omldm_pa_scan.restype = ctypes.c_int
        lib.omldm_pa_scan_max_rows.argtypes = []
        lib.omldm_pa_scan_max_rows.restype = ctypes.c_int
        lib.omldm_pa_scan_scratch_floats.argtypes = [ctypes.c_int]
        lib.omldm_pa_scan_scratch_floats.restype = ctypes.c_longlong

    libs = {"this": pa_scan.LIBRARY, "other": KernelLibrary(str(src.resolve()), configure)}
    libs["other"].load()
    log(f"ab: other kernel {src} built in {libs['other'].build_seconds:.1f} s")
    out = {}
    try:
        for B, D in TIME_SHAPES:
            w0, x, y, mask = _kernel_inputs(torch, B, D, "01", seed=99)
            kern = lambda: pa_scan.pa_scan_update(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
            turns = {"this": [], "other": []}
            res = {}
            for name in ("this", "other", "other", "this", "this", "other"):
                pa_scan.LIBRARY = libs[name]
                turns[name].append(_graph_ms(torch, kern, 200))
                res[name] = kern()
            diff = (res["this"][0] - res["other"][0]).abs().max().item()
            out[(B, D)] = (min(turns["this"]), min(turns["other"]))
            log(f"ab: pa_scan B={B} D+1={D}: this {out[(B, D)][0]:.6f} ms, other "
                f"{out[(B, D)][1]:.6f} ms a call as a CUDA graph (best of 3; turns this "
                + " / ".join(f"{t:.6f}" for t in turns["this"]) + ", other "
                + " / ".join(f"{t:.6f}" for t in turns["other"])
                + f"); this / other {out[(B, D)][0] / out[(B, D)][1]:.4f}; outputs max|dw| "
                f"{diff:.3e}")
    finally:
        pa_scan.LIBRARY = libs["this"]
    return out


def mt_stream(records: int, seed: int):
    """Phase 28's rows: HIGGS-shaped (28 features), every tenth a forecast."""
    import numpy as np

    x, y = learner_data("higgs", records, N_FEATURES, seed)
    return x, y, _forecast_ops(records)


def _mt_job(torch, x, y, op, device, cohort, nets, learner=MT_LEARNER, per_record=True,
            serving=True, run=MT_RUN, protocol="Synchronous", guard=False, split_at=None,
            poke=None, pokes=None, overload="", events=""):
    """``nets`` same-spec Creates (every other one serving-armed; with
    ``guard``, every one guarded; ``overload``, the job-wide overload spec;
    ``events``, the flight recorder's),
    then the rows in packed blocks of
    PACKED_CHUNK (with ``split_at``, a block boundary there too, where
    ``poke(job)`` runs; ``pokes`` maps more rows to their pokes), then
    termination. Returns (job, report, wall seconds)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    job = StreamJob(JobConfig(parallelism=run["parallelism"], batch_size=run["batch"],
                              test_set_size=run["test_set_size"], cohort=cohort,
                              overload=overload, events=events),
                    device=device)
    t0 = time.perf_counter()
    for pid in range(nets):
        tc = {"protocol": protocol, "perRecord": per_record}
        if serving and pid % 2:
            tc["serving"] = MT_SERVING
        if guard:
            tc["guard"] = True
        create = _create(learner, (), tc, x.shape[1])
        create["id"] = pid
        job.process_event("requests", json.dumps(create))
    pokes = {**({split_at: poke} if split_at else {}), **(pokes or {})}
    bounds = sorted({*range(0, x.shape[0], PACKED_CHUNK), *pokes, x.shape[0]})
    for lo, hi in zip(bounds, bounds[1:]):
        if pokes.get(lo) is not None:
            pokes[lo](job)
        job.process_packed_batch(x[lo:hi], y[lo:hi], op[lo:hi])
    report = job.terminate()
    if device == "cuda":
        torch.cuda.synchronize()
    return job, report, time.perf_counter() - t0


def _by_net(preds):
    out = {}
    for p in preds:
        out.setdefault(p.mlp_id, []).append(p.value)
    return out


def _compare_jobs(label, a, b, min_equal=0.99, regression=False):
    """Two runs of one multi-tenant job: the same forecasts a net in the
    same order, >= ``min_equal`` of the values equal (a regression within
    rtol 1e-3, atol 1e-3), every net's final flat parameters within W_RTOL,
    W_ATOL and its fitted count equal. Returns (mismatches, forecasts,
    worst params max|d|)."""
    import numpy as np

    (ja, ra), (jb, rb) = a, b
    pa, pb = _by_net(ja.predictions), _by_net(jb.predictions)
    check(pa.keys() == pb.keys(), f"{label}: the nets that forecast differ")
    mism = total = 0
    for k in pa:
        check(len(pa[k]) == len(pb[k]), f"{label}: net {k} has {len(pa[k])} / {len(pb[k])} "
              "predictions")
        va, vb = np.asarray(pa[k]), np.asarray(pb[k])
        if regression:
            mism += int((~np.isclose(va, vb, rtol=1e-3, atol=1e-3)).sum())
        else:
            mism += int((va != vb).sum())
        total += va.size
    check(total > 0 and mism <= (1.0 - min_equal) * total,
          f"{label}: {mism} of {total} predictions differ")
    sa = {s.pipeline: s for s in ra.statistics}
    sb = {s.pipeline: s for s in rb.statistics}
    check(sa.keys() == sb.keys(), f"{label}: the reports' pipelines differ")
    for k in sa:
        check(sa[k].fitted == sb[k].fitted, f"{label}: net {k} fitted {sa[k].fitted} / "
              f"{sb[k].fitted}")
    worst = 0.0
    fa = {(w, k): net.pipeline.get_flat_params()[0] for w, s in enumerate(ja.spokes)
          for k, net in s.nets.items()}
    for w, s in enumerate(jb.spokes):
        for k, net in s.nets.items():
            pb_flat = net.pipeline.get_flat_params()[0]
            pa_flat = fa[(w, k)]
            scale = max(1.0, float(np.abs(pa_flat).max()))
            err = float(np.abs(pa_flat - pb_flat).max())
            worst = max(worst, err / scale)
            check(np.allclose(pa_flat, pb_flat, rtol=W_RTOL, atol=W_ATOL * scale),
                  f"{label}: worker {w} net {k} params max|d|={err:.3e}")
    return mism, total, worst


def _quality_parity(label, a, b):
    """Cohort on against cohort off at parallelism > 1: the gang replaces
    the cooperative pause toggle, so the two schedules batch and sync
    differently and are held to the JAX package's own rule for this case
    (tests/test_cohort.py TestMultiWorkerParity): each net's holdout score
    within 0.05 and its forecasts all served. (Not fitted: with cohorts
    off, a toggle at termination can resume a net after its final push,
    and what it fits then reaches no statistic.) Returns (prediction
    mismatches, forecasts, worst score gap, fitted of each run)."""
    import numpy as np

    (ja, ra), (jb, rb) = a, b
    pa, pb = _by_net(ja.predictions), _by_net(jb.predictions)
    check({k: len(v) for k, v in pa.items()} == {k: len(v) for k, v in pb.items()},
          f"{label}: the forecasts served a net differ")
    mism = sum(int((np.asarray(pa[k]) != np.asarray(pb[k])).sum()) for k in pa)
    total = sum(len(v) for v in pa.values())
    sa = {s.pipeline: s for s in ra.statistics}
    sb = {s.pipeline: s for s in rb.statistics}
    check(sa.keys() == sb.keys(), f"{label}: the reports' pipelines differ")
    gap = max(abs(sa[k].score - sb[k].score) for k in sa)
    check(gap <= 0.05, f"{label}: a net's holdout score differs by {gap:.4f}")
    fitted = (sum(s.fitted for s in sa.values()), sum(s.fitted for s in sb.values()))
    return mism, total, gap, fitted


def _busy_s(torch, fn):
    """Device busy seconds (torch.profiler: every kernel, copy and memset)
    while ``fn`` runs; the device's activity alone is traced, and summed
    from the raw trace (:func:`_kineto_busy_s`: ``key_averages`` took tens
    of seconds on these runs' launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        fn()
        torch.cuda.synchronize()
    busy = _kineto_busy_s(tp)
    check(busy > 0, "torch.profiler traced no device time")
    return busy


def _mt_counts(pa_scan):
    from omldm_tpu_torch.runtime import cohort as cohort_mod

    return {"pa_scan": pa_scan.launches, "pa_scan_batched": pa_scan.batched_launches,
            "gang_launches": cohort_mod.gang_launches, "gang_steps": cohort_mod.gang_steps,
            "gang_predicts": cohort_mod.gang_predicts}


def _mt_reset(pa_scan):
    from omldm_tpu_torch.runtime import cohort as cohort_mod

    pa_scan.launches = pa_scan.batched_launches = 0
    cohort_mod.gang_launches = cohort_mod.gang_steps = cohort_mod.gang_predicts = 0


def _mt_checked(torch, pa_scan, x, y, op, mode, label):
    """One MT_RUN job on the card, counted and checked: every forecast
    answered by every tenant; with cohorts, one vmap cohort of all tenants
    a spoke and one batched pa_scan launch a gang step (no solo launch);
    without, one pa_scan launch a fit. Returns (job, report, wall, counts,
    fits)."""
    r = MT_RUN
    _mt_reset(pa_scan)
    job, report, wall = _mt_job(torch, x, y, op, "cuda", mode, r["nets"])
    counts = _mt_counts(pa_scan)
    stats = report.statistics
    check(len(stats) == r["nets"], f"{label}: {len(stats)} reports")
    fits = sum(len(s.learning_curve) for s in stats)
    check(len(job.predictions) == int(op.sum()) * r["nets"],
          f"{label}: {len(job.predictions)} predictions for {int(op.sum())} forecasts x "
          f"{r['nets']} tenants")
    if mode == "auto":
        cohorts = [c for s in job.spokes for c in s.cohorts.cohorts.values()]
        check(len(cohorts) == r["parallelism"] and all(
            c.n_active == r["nets"] and c.use_vmap for c in cohorts),
            f"{label}: expected one vmap cohort of {r['nets']} a spoke")
        check(counts["pa_scan"] == 0 and counts["pa_scan_batched"] == counts["gang_steps"] > 0,
              f"{label}: launches {counts}: one batched pa_scan a gang step")
    else:
        # a toggle can resume a net after its final push at termination,
        # so its last fits may miss the learning curve: at least one
        # launch a curve point
        check(counts["pa_scan_batched"] == 0 and counts["pa_scan"] >= fits > 0,
              f"{label}: launches {counts}, fits {fits}")
    scores = [s.score for s in stats]
    check(min(scores) > 0.6, f"{label}: holdout accuracy {min(scores):.3f}")
    log(f"{label}: {x.shape[0]} records, {r['nets']} tenants: {x.shape[0] / wall:.1f} "
        f"records/s ({wall:.3f} s), fits {fits}, launches {json.dumps(counts)}, "
        f"programLaunches {sum(s.program_launches for s in stats)}, score "
        f"{min(scores):.4f}-{max(scores):.4f}")
    return job, report, wall, counts, fits


def phase_multi_tenant(torch, pa_scan, seed):
    """Phase 28: MT_RUN's 64 tenants on the card. The whole stream with
    cohorts auto (vmap: one batched pa_scan launch a gang step, the main
    path's counts); then the first prefix_records rows with cohorts auto
    and off (one pa_scan launch a tenant a fit), held to each other, and
    each again under torch.profiler for the device's idle share (busy over
    the unprofiled run's wall); then the same rows through the CPU (map)
    against the card's cohort run (vmap). Returns the main run's
    pa_scan_batched launches."""
    r = MT_RUN
    x, y, op = mt_stream(r["records"], seed)
    m = r["main_records"]
    main = _mt_checked(torch, pa_scan, x[:m], y[:m], op[:m], "auto", "multi-tenant[cohort]")

    n = r["prefix_records"]
    px, py, pop = x[:n], y[:n], op[:n]
    runs = {mode: _mt_checked(torch, pa_scan, px, py, pop, mode, f"multi-tenant[{label}, {n}]")
            for mode, label in (("auto", "cohort"), ("off", "solo"))}
    mism, total, gap, fitted = _quality_parity("multi-tenant[cohort vs solo]",
                                               runs["auto"][:2], runs["off"][:2])
    log(f"multi-tenant: first {n} records, cohort vs solo on the card: every net's "
        f"forecasts served, holdout scores within {gap:.4f}; {mism} of {total} predictions "
        f"differ (the solo run's pause toggle answers a held forecast later); fitted "
        f"{fitted[0]} / {fitted[1]}")
    idle = {}
    for mode in ("auto", "off"):
        busy = _busy_s(torch, lambda: _mt_job(torch, px, py, pop, "cuda", mode, r["nets"]))
        idle[mode] = 1.0 - busy / runs[mode][2]
        log(f"multi-tenant[{mode}]: first {n} records under torch.profiler: device busy "
            f"{busy:.4f} s against the unprofiled {runs[mode][2]:.3f} s: idle share "
            f"{idle[mode]:.4f}")

    cpu = _mt_job(torch, px, py, pop, "cpu", "auto", r["nets"])
    check(all(not c.use_vmap for s in cpu[0].spokes for c in s.cohorts.cohorts.values()),
          "multi-tenant: the CPU job's cohorts should map")
    mism, total, worst = _compare_jobs("multi-tenant[cuda vs cpu]", runs["auto"][:2], cpu[:2])
    log(f"multi-tenant: first {n} records, cuda (vmap) vs cpu (map): {mism} of {total} "
        f"predictions differ, params max|d| (relative) {worst:.3e}, fitted equal; cpu "
        f"{cpu[2]:.2f} s")
    auto, off = runs["auto"], runs["off"]
    line = {
        "records": m, "tenants": r["nets"],
        "records_per_s": {"cohort": m / main[2],
                          f"cohort_first_{r['prefix_records']}": r["prefix_records"] / auto[2],
                          f"solo_first_{r['prefix_records']}": r["prefix_records"] / off[2]},
        "idle_share": {"cohort": idle["auto"], "solo": idle["off"],
                       "over_records": r["prefix_records"]},
        "launches": {"cohort": main[3], f"solo_first_{r['prefix_records']}": off[3]},
        "fits": {"cohort": main[4], f"solo_first_{r['prefix_records']}": off[4]},
        "pa_launches_per_gang_step": {"cohort": 1, "solo": r["nets"]},
    }
    log("multi-tenant: " + json.dumps(line))
    return main[3]["pa_scan_batched"]


def phase_cohort_specs(torch, pa_scan, seed):
    """Phase 29: every dense spec of COHORT_SPECS at 8 members, 2,000 rows,
    cohort on (vmap) on the card against cohort off (solo) on the CPU.
    Returns the card runs' pa_scan_batched launches."""
    r = SPECS_RUN
    batched = 0
    for name, hp, per_record, kind in COHORT_SPECS:
        x, y = learner_data(kind, r["records"], N_FEATURES, seed)
        op = _forecast_ops(r["records"])
        learner = {"name": name, "hyperParameters": hp}
        pa_scan.batched_launches = 0
        card = _mt_job(torch, x, y, op, "cuda", "on", r["members"], learner=learner,
                       per_record=per_record, serving=False, run=r, protocol="Asynchronous")
        batched += pa_scan.batched_launches
        cohorts = [c for s in card[0].spokes for c in s.cohorts.cohorts.values()]
        check(len(cohorts) == 1 and cohorts[0].n_active == r["members"] and cohorts[0].use_vmap,
              f"specs[{name}]: expected one vmap cohort of {r['members']}")
        check(pa_scan.batched_launches > 0 if per_record and name == "PA"
              else pa_scan.batched_launches == 0,
              f"specs[{name}]: pa_scan_batched launches {pa_scan.batched_launches}")
        cpu = _mt_job(torch, x, y, op, "cpu", "off", r["members"], learner=learner,
                      per_record=per_record, serving=False, run=r, protocol="Asynchronous")
        mism, total, worst = _compare_jobs(f"specs[{name}]", card[:2], cpu[:2],
                                           regression=kind == "regression")
        log(f"specs: {name}{' perRecord' if per_record else ''}: {r['members']} members, "
            f"card cohort {r['records'] / card[2]:.0f} records/s vs cpu solo: {mism} of "
            f"{total} predictions differ, params max|d| (relative) {worst:.3e}")
    return batched


FLASH_SOURCES = {
    "flash_fwd": "omldm_tpu/ops/attention.py:269",
    "flash_dq": "omldm_tpu/ops/attention.py:450",
    "flash_dkdv": "omldm_tpu/ops/attention.py:493",
}


# --- phases 30-33: the transport codec, the guard and the reliable channel --

# phase 30: the bench job's parameters on the card against the CPU over the
# file's first rows (the whole file is phase 24's, on the card)
CODEC_PARITY_ROWS = 200_000
# phase 31: tests/test_guard.py's corruption spec (worker->hub only: the
# hubs reject the poisoned pushes, no worker's own state goes bad) and the
# same classes on both directions (a poisoned release reaches the workers,
# whose guards trip and roll back)
GUARD_CHAOS = "seed=7,up.nan=0.05,up.explode=0.05"
GUARD_CHAOS_BOTH = "seed=7,nan=0.05,explode=0.05"
GUARD_PROFILE_RECORDS = 10_000
# the guarded stream's card-vs-CPU runs: its first 20,000 records at
# parallelism 4 with the Create's syncEvery 1 (at the slice's 16 workers and
# syncEvery 4 a worker pushes first after ~16,000 records, so a shorter
# prefix would carry no push for the channel to corrupt)
GUARD_PARITY = dict(records=20_000, parallelism=4, sync_every=1)
# phase 33: phase 5's stream at parallelism 4 through the lossy channel
RELIABLE_CHAOS = "seed=11,drop=0.05,dup=0.05,reorder=0.05,delay=0.05"
RELIABLE_RUN = dict(parallelism=4, records=20_000)


def phase_codec(torch, seed, bench_path: Path, bench: dict, tmp: Path):
    """Phase 30: the QDQ twins on the card against the CPU on seeded
    vectors (fp16 bitwise, overflow to inf included; int8 within one step,
    ties on the grid included), then phase 24's bench job with comm.codec
    int8 and fp16 on the whole file (records/s beside phase 24's unarmed
    run), and on its first CODEC_PARITY_ROWS on the card and the CPU:
    statistics (bytesOnWire among them) equal, probe predictions equal,
    parameters within W_RTOL, W_ATOL."""
    import numpy as np

    from omldm_tpu_torch.ops import codec as codec_ops

    rng = np.random.RandomState(seed)
    vec = (rng.randn(1 << 20) * np.exp(2.0 * rng.randn(1 << 20))).astype(np.float32)
    vec[:6] = [65504.0, 65519.0, 65520.0, -7e4, 1e-8, 3e38]
    ties = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0, 3.0])
    twins = {}
    for name, fn in (("fp16", codec_ops.qdq_fp16), ("int8", codec_ops.qdq_int8)):
        for tag, v in (("vector", vec), ("ties", ties)):
            card = fn(torch.from_numpy(v).cuda()).cpu().numpy()
            cpu = fn(torch.from_numpy(v)).numpy()
            if name == "fp16":
                check(np.array_equal(card, cpu), f"codec: qdq_fp16 card != cpu on the {tag}")
                err = 0.0
            else:
                step = float(np.abs(v).max()) / 127.0
                err = float(np.abs(card - cpu).max())
                check(err <= step, f"codec: qdq_int8 {tag} max|d|={err:.3e} > a step {step:.3e}")
            twins[f"{name}_{tag}_max_abs_diff"] = err
    check(np.isinf(codec_ops.qdq_fp16(torch.from_numpy(vec[:4]).cuda()).cpu().numpy()[2]),
          "codec: qdq_fp16 kept 65520 finite")
    log("codec: QDQ twins, card against cpu: " + json.dumps(twins))

    prefix = tmp / "bench_prefix.jsonl"
    with open(bench_path) as src, open(prefix, "w") as dst:
        for _, line in zip(range(CODEC_PARITY_ROWS), src):
            dst.write(line)
    probe = _bench_probe(prefix)
    rows = {}
    for codec in ("int8", "fp16"):
        job, bridge, wall, counts = _bench_run(torch, bench_path, "cuda", "fused", codec=codec)
        check(counts["packed_blocks"] == 0 and counts["stages"] == counts["stages_off_main"] > 0,
              f"codec[{codec}]: the overlapped fused route did not run: {counts}")
        check(bridge.trainer._qdq is not None and "ef" in bridge.trainer.state,
              f"codec[{codec}]: the trainer runs no QDQ")
        [stats] = job.terminate().statistics
        check(stats.score > 0.9, f"codec[{codec}]: score {stats.score}")
        check(stats.bytes_on_wire < stats.bytes_shipped,
              f"codec[{codec}]: bytesOnWire {stats.bytes_on_wire} not below bytesShipped "
              f"{stats.bytes_shipped}")
        outcomes = {}
        for device in ("cuda", "cpu"):
            job_p, bridge_p, _, _ = _bench_run(torch, prefix, device, "fused", codec=codec)
            outcomes[device] = _bench_outcome(job_p, bridge_p, probe)
        err = _check_bench_parity(f"codec[{codec}]", outcomes["cuda"], outcomes["cpu"])
        rows[codec] = {
            "records_per_s": bench["records"] / wall, "wall_s": wall,
            "vs_unarmed": (bench["records"] / wall) / bench["records_per_s_overlapped"],
            "bytesOnWire": stats.bytes_on_wire, "bytesShipped": stats.bytes_shipped,
            "score": stats.score, "stages": counts["stages"],
            "parity_rows": CODEC_PARITY_ROWS, "parity_params_max_abs_diff": err,
            "parity_bytesOnWire": outcomes["cuda"][0].bytes_on_wire,
        }
        log(f"codec[{codec}]: {bench['records']} records at {bench['records'] / wall:.1f} "
            f"records/s ({rows[codec]['vs_unarmed']:.4f}x phase 24's unarmed "
            f"{bench['records_per_s_overlapped']:.1f}), bytesOnWire {stats.bytes_on_wire} of "
            f"bytesShipped {stats.bytes_shipped}; first {CODEC_PARITY_ROWS} rows card vs cpu: "
            f"statistics equal (bytesOnWire {outcomes['cuda'][0].bytes_on_wire}), "
            f"{len(probe)} probe predictions equal, params max|d|={err:.3e}")
    log("codec: " + json.dumps(rows))
    return rows


def _guarded_events(events, **tc):
    """``events`` with the Create's trainingConfiguration guarded (and
    ``tc`` set in it)."""
    create = json.loads(events[0][1])
    create["trainingConfiguration"].update(guard=True, **tc)
    return [(events[0][0], json.dumps(create))] + list(events[1:])


def _chaos_parity(label, events, chaos, parallelism=None):
    """``events`` through the chaos channel on the card and the CPU: every
    integer statistic equal (the channel's repairs and the guard's counts
    among them), the chaos channels' counters equal, >= 99% of predictions
    equal (the count is logged). Returns (the card's statistics, mismatches,
    predictions)."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    cfg = dict(SLICE_CONFIG)
    if parallelism is not None:
        cfg["parallelism"] = parallelism
    runs = {}
    for device in ("cuda", "cpu"):
        job = StreamJob(JobConfig(**cfg, chaos=chaos), device=device)
        t0 = time.perf_counter()
        [stats] = job.run(events).statistics
        runs[device] = (job, stats, time.perf_counter() - t0)
    (jc, sc, wc), (jp, sp, wp) = runs["cuda"], runs["cpu"]
    diff = _stat_diff(sc, sp)
    check(not diff, f"{label}: statistics differ on the card and the CPU: {diff}")
    for side in ("_chaos_up", "_chaos_down"):
        check(getattr(jc, side).counters() == getattr(jp, side).counters(),
              f"{label}: the {side} channel's schedule differs")
    pc = np.array([p.value for p in jc.predictions])
    pp = np.array([p.value for p in jp.predictions])
    check(len(pc) == len(pp) > 0, f"{label}: prediction counts {len(pc)} / {len(pp)}")
    mism = int((~((pc == pp) | (np.isnan(pc) & np.isnan(pp)))).sum())
    check(mism <= 0.01 * len(pc), f"{label}: {mism} of {len(pc)} predictions differ")
    log(f"{label}: {len(events) - 1} records, card vs cpu: statistics equal "
        f"(deltasRejected {sc.deltas_rejected}, rollbacksPerformed {sc.rollbacks_performed}, "
        f"duplicatesDropped {sc.duplicates_dropped}, gapsResynced {sc.gaps_resynced}), "
        f"chaos counters {json.dumps(jc._chaos_up.counters())} up, "
        f"{json.dumps(jc._chaos_down.counters())} down; {mism} of {len(pc)} predictions "
        f"differ; card {wc:.2f} s, cpu {wp:.2f} s")
    return sc, mism, len(pc), wc


def phase_guard_stream(torch, pa_scan, events, unguarded_wall):
    """Phase 31: phase 5's stream with the Create guarded (records/s beside
    phase 5's unguarded run; pa_scan once a fit, the guard adding none);
    its first GUARD_PROFILE_RECORDS unguarded and guarded in turns (u, g,
    g, u: the guarded/unguarded ratio inside one phase) and under
    torch.profiler (the device's idle share of each); GUARD_PARITY's run
    under each chaos spec on the card and the CPU, GUARD_CHAOS_BOTH's with
    trips, rollbacks and rejections, the holdout score above chance."""
    import numpy as np

    guarded = _guarded_events(events)
    launches, wall, job, stats = _slice_checked(torch, pa_scan, guarded, label="guard")
    guards = [net.pipeline.guard for sp in job.spokes for net in sp.nets.values()]
    check(all(g is not None for g in guards) and sum(g.trips for g in guards) == 0,
          "guard: a clean stream's guard is missing or tripped")
    log(f"guard: {len(events) / wall:.1f} records/s guarded against phase 5's "
        f"{len(events) / unguarded_wall:.1f} unguarded (earlier in this call)")

    n = GUARD_PROFILE_RECORDS + 1
    heads = {"unguarded": events[:n], "guarded": guarded[:n]}
    walls = {"unguarded": [], "guarded": []}
    for tag in ("unguarded", "guarded", "guarded", "unguarded"):
        walls[tag].append(_run_slice(torch, heads[tag])[2])
    ratio = float(np.mean(walls["unguarded"]) / np.mean(walls["guarded"]))
    idle = {}
    for tag, evs in heads.items():
        w = float(np.mean(walls[tag]))
        busy = _busy_s(torch, lambda evs=evs: _run_slice(torch, evs))
        idle[tag] = {"wall_s": walls[tag], "busy_s": busy, "idle_share": 1.0 - busy / w}
        log(f"guard[{tag}]: first {n - 1} records {w:.3f} s ({(n - 1) / w:.1f} records/s, "
            f"turns {walls[tag]}), device busy {busy:.4f} s under torch.profiler: idle share "
            f"{1.0 - busy / w:.4f}")
    log(f"guard: guarded/unguarded records/s over the first {n - 1} records {ratio:.4f}")

    gp = GUARD_PARITY
    head = _guarded_events(events[: gp["records"] + 1], syncEvery=gp["sync_every"])
    parity = {}
    for spec in (GUARD_CHAOS, GUARD_CHAOS_BOTH):
        st, mism, total, _ = _chaos_parity(f"guard-parity[{spec}]", head, spec,
                                           parallelism=gp["parallelism"])
        check(st.deltas_rejected > 0, f"guard-parity[{spec}]: nothing rejected")
        check(spec == GUARD_CHAOS or st.rollbacks_performed > 0,
              f"guard-parity[{spec}]: no worker rolled back")
        check(st.score > 0.6, f"guard-parity[{spec}]: holdout accuracy {st.score}")
        parity[spec] = {"deltasRejected": st.deltas_rejected,
                        "rollbacksPerformed": st.rollbacks_performed, "score": st.score,
                        "prediction_mismatches": mism, "predictions": total}
    line = {
        "records": len(events), "records_per_s": {"guarded": len(events) / wall,
                                                  "unguarded_phase5": len(events) / unguarded_wall},
        f"guarded_over_unguarded_first_{n - 1}": ratio, "idle": idle,
        "pa_scan_launches": launches, "parity_run": gp, "parity": parity,
    }
    log("guard: " + json.dumps(line))
    return launches


def phase_guard_cohorts(torch, pa_scan, seed):
    """Phase 32: phase 28's 64 tenants, guarded, cohorts auto, over its
    first prefix_records rows: one batched pa_scan launch a gang step and
    one [C] health read a gang launch; values equal to the unguarded run's
    (records/s beside it); then a member picked by the seed poisoned on
    worker 0 halfway: it trips, is evicted from its cohort and rolled back,
    and every other tenant's predictions equal the clean guarded run's."""
    import numpy as np

    from omldm_tpu_torch.runtime import cohort as cohort_mod

    r = MT_RUN
    n = r["prefix_records"]
    x, y, op = mt_stream(n, seed)
    reads = [0]
    real = cohort_mod.gang_health_values

    def counted(v):
        reads[0] += 1
        return real(v)

    cohort_mod.gang_health_values = counted
    try:
        _mt_reset(pa_scan)
        plain = _mt_job(torch, x, y, op, "cuda", "auto", r["nets"], split_at=n // 2)
        plain_counts = _mt_counts(pa_scan)
        _mt_reset(pa_scan)
        reads[0] = 0
        clean = _mt_job(torch, x, y, op, "cuda", "auto", r["nets"], guard=True, split_at=n // 2)
        counts, clean_reads = _mt_counts(pa_scan), reads[0]
        victim = int(np.random.RandomState(seed).randint(r["nets"]))
        poisoned_on = []
        poke = _poison_tenant(victim, poisoned_on)
        _mt_reset(pa_scan)
        poisoned = _mt_job(torch, x, y, op, "cuda", "auto", r["nets"], guard=True,
                           split_at=n // 2, poke=poke)
        poisoned_counts = _mt_counts(pa_scan)
    finally:
        cohort_mod.gang_health_values = real
    check(all(c.guarded and c.use_vmap for s in clean[0].spokes
              for c in s.cohorts.cohorts.values()), "guard-cohort: the cohorts are not guarded")
    check(counts["pa_scan"] == 0 and counts["pa_scan_batched"] == counts["gang_steps"] > 0,
          f"guard-cohort: launches {counts}: one batched pa_scan a gang step")
    check(clean_reads == counts["gang_launches"] > 0,
          f"guard-cohort: {clean_reads} health reads for {counts['gang_launches']} gang launches")
    pa, pb = _by_net(plain[0].predictions), _by_net(clean[0].predictions)
    check(pa == pb, "guard-cohort: guarding a clean stream changed a prediction")
    sp = {s.pipeline: s for s in poisoned[1].statistics}
    pnets = [poisoned[0].spokes[w].nets[victim] for w in poisoned_on]
    check(pnets and all(net.pipeline._cohort is None for net in pnets)
          and sp[victim].members_evicted == len(pnets)
          and sp[victim].rollbacks_performed >= len(pnets),
          f"guard-cohort: tenant {victim} poisoned on workers {poisoned_on}: evicted "
          f"{sp[victim].members_evicted}, rollbacks {sp[victim].rollbacks_performed}")
    check(all(np.isfinite(net.pipeline.get_flat_params()[0]).all() for net in pnets),
          "guard-cohort: the evicted tenant's parameters are not finite")
    check(sum(s.members_evicted for s in poisoned[1].statistics) == len(pnets),
          "guard-cohort: a tenant other than the poisoned one was evicted")
    pp = _by_net(poisoned[0].predictions)
    others = [k for k in pb if k != victim]
    check(all(pp[k] == pb[k] for k in others),
          "guard-cohort: a sibling's predictions changed when another member was poisoned")
    line = {
        "records": n, "tenants": r["nets"], "victim": victim, "poisoned_on": poisoned_on,
        "records_per_s": {"guarded": n / clean[2], "unguarded": n / plain[2],
                          "guarded_poisoned": n / poisoned[2]},
        "guarded_over_unguarded": plain[2] / clean[2],
        "launches": {"guarded": counts, "unguarded": plain_counts, "poisoned": poisoned_counts},
        "health_reads": clean_reads,
        "victim_rollbacks": sp[victim].rollbacks_performed,
        "siblings_predictions_equal": len(others),
    }
    log(f"guard-cohort: first {n} records, {r['nets']} tenants: guarded {n / clean[2]:.1f} "
        f"records/s against unguarded {n / plain[2]:.1f} (same predictions); "
        f"{counts['pa_scan_batched']} batched pa_scan launches for {counts['gang_steps']} gang "
        f"steps, {clean_reads} health reads for {counts['gang_launches']} gang launches; "
        f"tenant {victim} poisoned on workers {poisoned_on}: evicted, "
        f"{sp[victim].rollbacks_performed} rollbacks, the "
        f"other {len(others)} tenants' predictions unchanged")
    log("guard-cohort: " + json.dumps(line))
    return {"batched": counts["pa_scan_batched"], "victim": victim,
            "poisoned_counts": poisoned_counts, "poisoned_preds": pp}


def _poison_tenant(victim, poisoned_on):
    """A poke that sets tenant ``victim``'s parameters to NaN on every
    replica not waiting on its round (a waiting one would take the round's
    release over the poison before a fit), noting the workers in
    ``poisoned_on``."""
    import numpy as np

    def poke(job):
        for w, spoke in enumerate(job.spokes):
            net = spoke.nets[victim]
            if not getattr(net.node, "waiting", False):
                flat, _ = net.pipeline.get_flat_params()
                net.pipeline.set_flat_params(np.full_like(flat, np.nan))
                poisoned_on.append(w)

    return poke


def phase_reliable(torch, pa_scan, events):
    """Phase 33: phase 5's stream at RELIABLE_RUN's parallelism over its
    first records, through RELIABLE_CHAOS on the card and the CPU (the
    reliable channel's repairs, the statistics and the predictions equal)
    and unarmed on the card (the wall against the chaos run's)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    rr = RELIABLE_RUN
    head = events[: rr["records"] + 1]
    job = StreamJob(JobConfig(**dict(SLICE_CONFIG, parallelism=rr["parallelism"])),
                    device="cuda")
    t0 = time.perf_counter()
    [plain] = job.run(head).statistics
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    pa_scan.launches = 0
    stats, mism, total, wall = _chaos_parity("reliable", head, RELIABLE_CHAOS,
                                             parallelism=rr["parallelism"])
    launches = pa_scan.launches
    check(stats.duplicates_dropped > 0 and stats.gaps_resynced >= 0 and launches > 0,
          f"reliable: duplicatesDropped {stats.duplicates_dropped}, launches {launches}")
    check(stats.score > 0.6, f"reliable: score {stats.score}")
    line = {"records": rr["records"], "parallelism": rr["parallelism"], "spec": RELIABLE_CHAOS,
            "duplicatesDropped": stats.duplicates_dropped, "gapsResynced": stats.gaps_resynced,
            "wall_s": {"chaos": wall, "unarmed": plain_wall},
            "records_per_s": {"chaos": rr["records"] / wall, "unarmed": rr["records"] / plain_wall},
            "score": {"chaos": stats.score, "unarmed": plain.score},
            "prediction_mismatches": mism, "predictions": total, "pa_scan_launches": launches}
    log("reliable: " + json.dumps(line))
    return launches


# --- checkpoint, supervised recovery and live rescale (phases 34-38) --------

# phase 34: phase 5's stream, its first `records`, checkpointed about
# `snapshots` times (the interval is the unarmed run's wall over it), a
# crash in `worker` once the stream reached `crash_at` records
RECOVERY_RUN = dict(records=20_000, snapshots=20, crash_at=9_000, worker=3, max_restarts=2)
# a recovered run against the unfaulted one: the JAX suite's limits
REC_RTOL, REC_ATOL = 1e-5, 1e-6
# what a snapshot does not carry, in both packages: the spoke-side tallies
# that fold into the hub statistics at a query or at termination, and the
# learning-curve points of the fits since a worker's last push, which ride
# in (and size) its next push. A recovered run loses those counted or
# fitted between the last fold or push and its snapshot.
UNSNAPSHOTTED_TALLIES = ("programLaunches", "forecastsServed", "bytesShipped", "bytesOnWire")
# phase 35: live rescales at these records of the same stream; the snapshot
# taken at `snapshot_at` restored at `restore_parallelism`; the sparse
# stream's crash as phase 34's
RESCALE_RUN = dict(records=20_000, schedule=((7_000, 4), (14_000, 8)), snapshot_at=10_000,
                   restore_parallelism=4, sparse_snapshots=10)
# phase 36: phase 28's tenants over their first `records` rows, rescaled
COHORT_RESCALE = dict(records=5_000, schedule=((2_500, 1), (3_750, 2)))
# phase 37: phase 24's bench job (Softmax, Synchronous, the SPMD engine) on
# phase 26's Mesh(8, 2) leading axis, over the bench file's first `rows`
SPMD_CKPT = dict(rows=20_000, snapshot_at=10_000, block=1_000, batch=256, chain=4,
                 restore_dp=4)
# phase 38: steps each trainer takes after the save and the load
LM_CKPT_STEPS = 2


class _FitCounter:
    """Counts the solo fits (``MLPipeline._fit_impl`` calls) while entered:
    the launches a per-record PA fit or a sparse fit makes one kernel
    launch each, whatever reaches the learning curve."""

    def __enter__(self):
        from omldm_tpu_torch.pipelines.pipeline import MLPipeline

        self.n = 0
        self._orig = orig = MLPipeline._fit_impl

        def counted(pipe, *a, **k):
            self.n += 1
            return orig(pipe, *a, **k)

        MLPipeline._fit_impl = counted
        return self

    def __exit__(self, *exc):
        from omldm_tpu_torch.pipelines.pipeline import MLPipeline

        MLPipeline._fit_impl = self._orig


def _positions(get_job):
    """A prediction sink keyed by stream position: {events consumed: value},
    a replayed forecast's last emission winning (the sinks are
    at-least-once across a recovery)."""
    out = {}

    def sink(pred):
        out[get_job().events_processed] = pred.value

    return out, sink


def _timed_saves(manager, rows):
    """Wrap ``manager.save``: (seconds, bytes) of each snapshot into ``rows``."""
    import os

    save = manager.save

    def timed(job):
        t0 = time.perf_counter()
        path = save(job)
        rows.append((time.perf_counter() - t0, os.path.getsize(path)))
        return path

    manager.save = timed


def _int_stats(stats, skip=()):
    return {k: v for k, v in stats.to_dict().items()
            if isinstance(v, int) and not isinstance(v, bool) and k not in skip}


def _same_positions(label, a: dict, b: dict, keys=None):
    """>= 99% of the forecasts at the same stream positions equal."""
    keys = sorted(a) if keys is None else keys
    check(keys and all(k in b for k in keys),
          f"{label}: the forecast positions differ ({len(a)} / {len(b)})")
    mism = sum(1 for k in keys if a[k] != b[k])
    check(mism <= 0.01 * len(keys), f"{label}: {mism} of {len(keys)} forecasts differ")
    return mism, len(keys)


def _job_flats(job):
    return [p.get_flat_params()[0] for p in _pipelines(job)]


def _flats_close(label, a, b, rtol, atol):
    """Every pipeline's parameters within (rtol, atol); returns (max|d|,
    bitwise)."""
    import numpy as np

    check(len(a) == len(b), f"{label}: {len(a)} / {len(b)} pipelines")
    err = max(float(np.abs(u - v).max()) for u, v in zip(a, b))
    check(all(np.allclose(u, v, rtol=rtol, atol=atol) for u, v in zip(a, b)),
          f"{label}: parameters max|d|={err:.3e}")
    return err, all(np.array_equal(u, v) for u, v in zip(a, b))


def _slice_job(device, parallelism=None, ckpt_dir=None, interval_ms=0):
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    cfg = dict(SLICE_CONFIG, parallelism=parallelism or SLICE_CONFIG["parallelism"])
    if ckpt_dir is not None:
        cfg.update(checkpointing=True, checkpoint_dir=str(ckpt_dir),
                   check_interval_ms=int(interval_ms), checkpoint_keep=0)
    return StreamJob(JobConfig(**cfg), device=device)


def _supervised(torch, counts, key, head, ckpt_dir, interval_ms, label, after_records):
    """One crash-and-recover run on the card: a FaultInjector crash in
    RECOVERY_RUN's worker once the stream reached ``after_records``,
    JobSupervisor(max_restarts). ``counts[key]`` is the kernel's launch
    count; it and the fit counter are set to 0 when the restored
    incarnation takes over, just before it runs. Returns (supervisor,
    report, wall, positions, fits and launches of the final incarnation,
    the save rows)."""
    from omldm_tpu_torch.runtime.recovery import FaultInjector, JobSupervisor, replayable

    rr = RECOVERY_RUN
    job = _slice_job("cuda", ckpt_dir=ckpt_dir, interval_ms=interval_ms)
    saves = []
    _timed_saves(job.checkpoint_manager, saves)
    holder = {}
    positions, sink = _positions(lambda: holder["sup"].job)
    job.set_sinks(on_prediction=sink)
    FaultInjector().arm(job, worker_id=rr["worker"],
                        after_records=after_records // job.config.parallelism)

    def on_failure(record):
        # the final incarnation counts from here
        fits.n = counts[key] = 0
        _timed_saves(holder["sup"].job.checkpoint_manager, saves)

    with _FitCounter() as fits:
        sup = holder["sup"] = JobSupervisor(job, replayable(lambda: head),
                                            max_restarts=rr["max_restarts"],
                                            on_failure=on_failure)
        t0 = time.perf_counter()
        report = sup.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    final_fits, launched = fits.n, counts[key]
    check(len(sup.failures) == 1 and sup.failures[0].restored_from is not None,
          f"{label}: failures {sup.failures}")
    check(sup.job.events_processed == len(head), f"{label}: the final incarnation stopped at "
          f"{sup.job.events_processed} of {len(head)} events")
    return sup, report, wall, positions, final_fits, launched, saves


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def phase_recovery(torch, pa_scan, events, tmp: Path):
    """Phase 34: phase 5's stream over RECOVERY_RUN's first records on the
    card, unarmed, then checkpointed (the same statistics and predictions),
    then checkpointed with a crash and supervised recovery (held to the
    unfaulted run; pa_scan once a fit of the final incarnation); the
    snapshot the recovery restored, restored on the CPU and run to the end
    (held to the card's continuation). Returns the final incarnation's
    pa_scan launches."""
    from omldm_tpu_torch.checkpoint import CheckpointManager

    rr = RECOVERY_RUN
    head = events[: rr["records"] + 1]
    job = _slice_job("cuda")
    clean_pos, sink = _positions(lambda: job)
    job.set_sinks(on_prediction=sink)
    t0 = time.perf_counter()
    [clean] = job.run(head).statistics
    torch.cuda.synchronize()
    unarmed_wall = time.perf_counter() - t0
    clean_flats = _job_flats(job)
    interval_ms = max(1, int(unarmed_wall * 1000 / rr["snapshots"]))

    armed = _slice_job("cuda", ckpt_dir=tmp / "armed", interval_ms=interval_ms)
    saves = []
    _timed_saves(armed.checkpoint_manager, saves)
    armed_pos, sink = _positions(lambda: armed)
    armed.set_sinks(on_prediction=sink)
    t0 = time.perf_counter()
    [armed_stats] = armed.run(head).statistics
    torch.cuda.synchronize()
    armed_wall = time.perf_counter() - t0
    n_saves = len(saves)
    log(f"recovery: {n_saves} snapshots at check_interval_ms {interval_ms} over "
        f"{rr['records']} records")
    check(10 <= n_saves <= 40, f"recovery: {n_saves} snapshots, expected 10-40")
    check(_int_stats(armed_stats) == _int_stats(clean),
          f"recovery: checkpointing changed a statistic: {_stat_diff(clean, armed_stats)}")
    check(armed_pos == clean_pos, "recovery: checkpointing changed a prediction")

    sup, report, wall, positions, fits, launched, fsaves = _supervised(
        torch, vars(pa_scan), "launches", head, tmp / "faulted", interval_ms, "recovery",
        rr["crash_at"])
    [stats] = report.statistics
    failure = sup.failures[0]
    want, got = _int_stats(clean, UNSNAPSHOTTED_TALLIES), _int_stats(stats, UNSNAPSHOTTED_TALLIES)
    check(got == want, f"recovery: statistics differ from the unfaulted run: "
          f"{ {k: (want[k], got[k]) for k in want if want[k] != got.get(k)} }")
    check(stats.fitted == clean.fitted, "recovery: fitted differs from the unfaulted run")
    err, bitwise = _flats_close("recovery[vs unfaulted]", _job_flats(sup.job), clean_flats,
                                REC_RTOL, REC_ATOL)
    mism, total = _same_positions("recovery[last emissions vs unfaulted]", clean_pos, positions)
    check(launched == fits > 0, f"recovery: pa_scan launches {launched} != fits {fits} of the "
          "final incarnation")
    tallies = {k: (clean.to_dict()[k], stats.to_dict()[k]) for k in UNSNAPSHOTTED_TALLIES}

    # the snapshot the recovery restored, on the card and on the CPU
    t0 = time.perf_counter()
    CheckpointManager(str(tmp / "faulted"), device="cuda").restore(path=failure.restored_from)
    torch.cuda.synchronize()
    restore_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_job = CheckpointManager(str(tmp / "faulted"), device="cpu").restore(
        path=failure.restored_from)
    restore_cpu_s = time.perf_counter() - t0
    offset = cpu_job.events_processed
    cpu_pos, sink = _positions(lambda: cpu_job)
    cpu_job.set_sinks(on_prediction=sink)
    [cpu_stats] = cpu_job.run(head[offset:]).statistics
    check(_int_stats(cpu_stats) == _int_stats(stats),
          f"recovery[cpu continuation]: statistics differ: {_stat_diff(stats, cpu_stats)}")
    cmism, ctotal = _same_positions("recovery[cpu continuation]", cpu_pos, positions)
    cerr = max(float(abs(a - b).max()) for a, b in zip(_job_flats(cpu_job), _job_flats(sup.job)))
    check(all(p.device.type == "cpu" for pipe in _pipelines(cpu_job)
              for p in pipe.state["params"].values()), "recovery: the CPU restore is not on cpu")
    line = {
        "records": rr["records"], "parallelism": SLICE_CONFIG["parallelism"],
        "check_interval_ms": interval_ms, "snapshots": n_saves,
        "save_s_median": _median([s for s, _ in saves + fsaves]),
        "snapshot_bytes_median": _median([b for _, b in saves + fsaves]),
        "restore_s": {"cuda": restore_card_s, "cpu": restore_cpu_s},
        "records_per_s": {"unarmed": len(head) / unarmed_wall, "checkpointed": len(head) / armed_wall,
                          "crash_and_recovery": len(head) / wall},
        "checkpointed_over_unarmed": unarmed_wall / armed_wall,
        "failure": {"offset": failure.offset, "kind": failure.kind,
                    "restored_offset": offset},
        "params_vs_unfaulted": {"max_abs_diff": err, "bitwise": bitwise},
        "last_emissions_differ": [mism, total], "unsnapshotted_tallies": tallies,
        "pa_scan_launches_final_incarnation": launched, "fits_final_incarnation": fits,
        "cpu_continuation": {"events": len(head) - offset, "forecasts_differ": [cmism, ctotal],
                             "params_max_abs_diff": cerr},
    }
    log("recovery: " + json.dumps(line))
    return launched, clean.fitted


def _rescale_run(torch, head, device, schedule):
    """The slice's job over ``head`` with ``rescale(n)`` after each
    (records, n) of ``schedule``; returns (job, report, positions, seconds
    of each rescale call to a synchronize)."""
    job = _slice_job(device)
    pos, sink = _positions(lambda: job)
    job.set_sinks(on_prediction=sink)
    prev, rescale_s = 0, []
    for at, n in schedule:
        job.run(head[prev : at + 1], terminate_on_end=False)
        _sync(torch, device)
        t0 = time.perf_counter()
        job.rescale(n)
        _sync(torch, device)
        rescale_s.append(time.perf_counter() - t0)
        prev = at + 1
    report = job.run(head[prev:])
    _sync(torch, device)
    return job, report, pos, rescale_s


def _card_vs_cpu(label, card, cpu, rtol=W_RTOL, atol=W_ATOL):
    """(job, report, positions) on the card and the CPU: every integer
    statistic equal, >= 99% of the forecasts equal, parameters within
    (rtol, atol). Returns (stats, max|d|, mismatches, forecasts)."""
    [a], [b] = card[1].statistics, cpu[1].statistics
    check(_int_stats(a) == _int_stats(b), f"{label}: statistics differ: {_stat_diff(a, b)}")
    mism, total = _same_positions(label, card[2], cpu[2])
    err, _ = _flats_close(label, _job_flats(card[0]), _job_flats(cpu[0]), rtol, atol)
    return a, err, mism, total


def phase_rescale(torch, pa_scan, sparse, events, sparse_events, tmp: Path):
    """Phase 35: phase 5's stream over RESCALE_RUN's records at 16 workers
    rescaled live to 4 and 8 on the card and the CPU; its snapshot at
    snapshot_at restored at restore_parallelism on both; phase 14's sparse
    stream over the same records crashed and recovered on the card.
    Returns the card's launches a path."""
    from omldm_tpu_torch.checkpoint import CheckpointManager

    rs = RESCALE_RUN
    head = events[: rs["records"] + 1]
    with _FitCounter() as fits:
        pa_scan.launches = 0
        t0 = time.perf_counter()
        card = _rescale_run(torch, head, "cuda", rs["schedule"])
        wall = time.perf_counter() - t0
    launched = pa_scan.launches
    check(launched == fits.n > 0, f"rescale: pa_scan launches {launched} != fits {fits.n}")
    cpu = _rescale_run(torch, head, "cpu", rs["schedule"])
    stats, err, mism, total = _card_vs_cpu("rescale[16 -> 4 -> 8, cuda vs cpu]", card, cpu)
    check(stats.rescales_performed == 2 and len(card[0].spokes) == rs["schedule"][-1][1],
          f"rescale: rescalesPerformed {stats.rescales_performed}")
    check(stats.score > 0.6, f"rescale: score {stats.score}")
    plain = _slice_job("cuda")
    t0 = time.perf_counter()
    plain.run(head)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    # the snapshot at snapshot_at, restored at another parallelism
    job = _slice_job("cuda")
    job.run(head[: rs["snapshot_at"] + 1], terminate_on_end=False)
    path = CheckpointManager(str(tmp / "rescale"), device="cuda").save(job)
    restored = {}
    for device in ("cuda", "cpu"):
        with _FitCounter() as rfits:
            pa_scan.launches = 0
            t0 = time.perf_counter()
            rjob = CheckpointManager(str(tmp / "rescale"), device=device).restore(
                path=path, parallelism=rs["restore_parallelism"])
            restore_s = time.perf_counter() - t0
            pos, sink = _positions(lambda rjob=rjob: rjob)
            rjob.set_sinks(on_prediction=sink)
            report = rjob.run(head[rs["snapshot_at"] + 1 :])
            if device == "cuda":
                torch.cuda.synchronize()
        restored[device] = (rjob, report, pos, restore_s, pa_scan.launches, rfits.n)
    rlaunched, rfits_n = restored["cuda"][4], restored["cuda"][5]
    check(rlaunched == rfits_n > 0, f"rescale[restore]: pa_scan launches {rlaunched} != fits "
          f"{rfits_n}")
    rstats, rerr, rmism, rtotal = _card_vs_cpu(
        f"rescale[restore at {rs['restore_parallelism']}, cuda vs cpu]",
        restored["cuda"][:3], restored["cpu"][:3])
    check(rstats.rescales_performed == 1 and len(restored["cuda"][0].spokes) ==
          rs["restore_parallelism"], f"rescale[restore]: {rstats.rescales_performed} rescales")

    # the sparse stream crashed and recovered
    shead = sparse_events[: rs["records"] + 1]
    sjob = _slice_job("cuda")
    spos, sink = _positions(lambda: sjob)
    sjob.set_sinks(on_prediction=sink)
    t0 = time.perf_counter()
    [sclean] = sjob.run(shead).statistics
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    sup, sreport, srec_wall, spositions, sfits, slaunched, ssaves = _supervised(
        torch, sparse.launches, "scatter_add", shead, tmp / "sparse",
        max(1, int(swall * 1000 / rs["sparse_snapshots"])), "rescale[sparse recovery]",
        RECOVERY_RUN["crash_at"])
    [sstats] = sreport.statistics
    want = _int_stats(sclean, UNSNAPSHOTTED_TALLIES)
    got = _int_stats(sstats, UNSNAPSHOTTED_TALLIES)
    check(got == want, f"rescale[sparse recovery]: statistics differ from the unfaulted run: "
          f"{ {k: (want[k], got[k]) for k in want if want[k] != got.get(k)} }")
    serr, sbitwise = _flats_close("rescale[sparse recovery vs unfaulted]", _job_flats(sup.job),
                                  _job_flats(sjob), REC_RTOL, REC_ATOL)
    smism, stotal = _same_positions("rescale[sparse last emissions]", spos, spositions)
    check(slaunched == sfits > 0, f"rescale[sparse recovery]: scatter_add launches {slaunched} "
          f"!= fits {sfits}")
    line = {
        "records": rs["records"], "schedule": [list(s) for s in rs["schedule"]],
        "records_per_s": {"rescaled": len(head) / wall, "unrescaled": len(head) / plain_wall},
        "rescaled_over_unrescaled_wall": wall / plain_wall, "rescale_s": card[3],
        "cuda_vs_cpu": {"params_max_abs_diff": err, "forecasts_differ": [mism, total]},
        "pa_scan_launches": launched, "fits": fits.n,
        "restore_at": {"parallelism": rs["restore_parallelism"], "snapshot_at": rs["snapshot_at"],
                       "restore_s": {d: restored[d][3] for d in restored},
                       "pa_scan_launches": rlaunched, "fits": rfits_n,
                       "cuda_vs_cpu": {"params_max_abs_diff": rerr,
                                       "forecasts_differ": [rmism, rtotal]}},
        "sparse_recovery": {"snapshots": len(ssaves), "failure_offset": sup.failures[0].offset,
                            "save_s_median": _median([s for s, _ in ssaves]),
                            "snapshot_bytes_median": _median([b for _, b in ssaves]),
                            "records_per_s": {"unfaulted": len(shead) / swall,
                                              "crash_and_recovery": len(shead) / srec_wall},
                            "params_vs_unfaulted": {"max_abs_diff": serr, "bitwise": sbitwise},
                            "last_emissions_differ": [smism, stotal],
                            "scatter_add_launches_final_incarnation": slaunched,
                            "fits_final_incarnation": sfits},
    }
    log("rescale: " + json.dumps(line))
    return {"rescale": launched, "restore_at_4": rlaunched, "sparse_recovery": slaunched}


def phase_rescale_cohort(torch, pa_scan, seed):
    """Phase 36: phase 28's tenants over COHORT_RESCALE's first rows at 2
    workers, rescaled live to 1 and back to 2, on the card (one batched
    pa_scan launch a gang step, no solo launch) and the CPU (held to the
    card). Returns the card's batched launches."""
    r, cr = MT_RUN, COHORT_RESCALE
    x, y, op = mt_stream(r["records"], seed)
    n = cr["records"]
    x, y, op = x[:n], y[:n], op[:n]
    pokes = {at: (lambda job, k=k: job.rescale(k)) for at, k in cr["schedule"]}
    _mt_reset(pa_scan)
    card = _mt_job(torch, x, y, op, "cuda", "auto", r["nets"], pokes=pokes)
    counts = _mt_counts(pa_scan)
    check(counts["pa_scan"] == 0 and counts["pa_scan_batched"] == counts["gang_steps"] > 0,
          f"rescale-cohort: launches {counts}: one batched pa_scan a gang step, no solo launch")
    cohorts = [c for s in card[0].spokes for c in s.cohorts.cohorts.values()]
    check(len(card[0].spokes) == cr["schedule"][-1][1] and len(cohorts) == len(card[0].spokes)
          and all(c.n_active == r["nets"] and c.use_vmap for c in cohorts),
          "rescale-cohort: expected one vmap cohort of every tenant a spoke")
    stats = card[1].statistics
    check(all(s.rescales_performed == 2 for s in stats) and min(s.score for s in stats) > 0.6,
          "rescale-cohort: rescalesPerformed or holdout accuracy off")
    cpu = _mt_job(torch, x, y, op, "cpu", "auto", r["nets"], pokes=pokes)
    mism, total, worst = _compare_jobs("rescale-cohort[cuda vs cpu]", card[:2], cpu[:2])
    log("rescale-cohort: " + json.dumps({
        "records": n, "tenants": r["nets"], "schedule": [list(s) for s in cr["schedule"]],
        "records_per_s": {"cuda": n / card[2], "cpu": n / cpu[2]}, "launches": counts,
        "cuda_vs_cpu": {"forecasts_differ": [mism, total], "params_max_rel_diff": worst},
    }))
    return counts["pa_scan_batched"]


def _spmd_ckpt_job(device, parallelism):
    """Phase 24's bench job (Softmax, Synchronous, the SPMD engine) at
    SPMD_CKPT's batch and chain with hubParallelism 2 and ``parallelism``
    workers: on phase 26's mesh leading axis at parallelism 8."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    s = SPMD_CKPT
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "Softmax", "hyperParameters": {"learningRate": 0.05, "nClasses": 2},
                    "dataStructure": {"nFeatures": BENCH_JOB["dim"]}},
        "preProcessors": [],
        "trainingConfiguration": {"protocol": "Synchronous", "engine": "spmd",
                                  "hubParallelism": SPMD_MESH[1],
                                  "extra": {"stageChain": s["chain"]}},
    }
    job = StreamJob(JobConfig(parallelism=parallelism, batch_size=s["batch"]), device=device)
    job.process_event("requests", json.dumps(create))
    return job


def _concat(tree):
    """Every leaf of a tree, flattened and concatenated in the port's leaf
    order."""
    import numpy as np

    from omldm_tpu_torch.models.transformer import tree_leaves

    return np.concatenate([np.asarray(v).reshape(-1) for v in tree_leaves(tree)])


def phase_spmd_ckpt(torch, bench_path: Path, tmp: Path):
    """Phase 37: the bench job on Mesh(8, 2) over the bench file's first
    rows, a snapshot halfway: the same-mesh restore continues to the
    uninterrupted run's counters and parameters; a restore at dp 4 seeds
    the mean of the saved replicas, on the card and the CPU equal; the
    trainer's save/load round trip is bitwise."""
    import pickle

    import numpy as np

    from omldm_tpu_torch.checkpoint import CheckpointManager
    from omldm_tpu_torch.models.transformer import tree_leaves
    from omldm_tpu_torch.parallel.spmd import SPMDTrainer
    from omldm_tpu_torch.runtime import spmd_bridge
    from omldm_tpu_torch.runtime.job import PACKED_STREAM

    s = SPMD_CKPT
    with open(bench_path) as f:
        rows = [json.loads(line) for _, line in zip(range(s["rows"]), f)]
    x = np.array([r["numericalFeatures"] for r in rows], np.float32)
    y = np.array([r["target"] for r in rows], np.float32)
    op = np.zeros((x.shape[0],), np.uint8)
    b = s["block"]
    blocks = [(PACKED_STREAM, (x[i:i + b], y[i:i + b], op[i:i + b]))
              for i in range(0, x.shape[0], b)]
    half = s["snapshot_at"] // b
    slots = spmd_bridge.device_slots
    # phase 26's mesh: 8 dp workers and 2 hub shards, as leading axes
    spmd_bridge.device_slots = lambda device: SPMD_MESH[0] * SPMD_MESH[1]
    try:
        job = _spmd_ckpt_job("cuda", SPMD_MESH[0])
        trainer = job.spmd_bridges[0].trainer
        check((trainer.dp, trainer.hub) == SPMD_MESH,
              f"spmd-ckpt: mesh {(trainer.dp, trainer.hub)}")
        job.run(blocks[:half], terminate_on_end=False)
        directory = str(tmp / "spmd_ckpt")
        t0 = time.perf_counter()
        path = CheckpointManager(directory, device="cuda").save(job)
        save_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            saved = pickle.load(f)["bridges"][0]["fleet"]["params"]
        [whole] = job.run(blocks[half:]).statistics
        whole_fleet = trainer.fleet_numpy()

        same = CheckpointManager(directory, device="cuda").restore(path=path)
        [cont] = same.run(blocks[half:]).statistics
        check(_int_stats(cont) == _int_stats(whole),
              f"spmd-ckpt[same mesh]: counters differ: {_stat_diff(whole, cont)}")
        cont_fleet = same.spmd_bridges[0].trainer.fleet_numpy()
        same_err = float(np.abs(_concat(cont_fleet["params"]) -
                                _concat(whole_fleet["params"])).max())
        check(np.allclose(_concat(cont_fleet["params"]), _concat(whole_fleet["params"]),
                          rtol=W_RTOL, atol=W_ATOL)
              and all(np.array_equal(cont_fleet[k], whole_fleet[k]) for k in ("step", "syncs")),
              f"spmd-ckpt[same mesh]: fleet differs (params max|d|={same_err:.3e})")

        seeded = {}
        for device in ("cuda", "cpu"):
            r = CheckpointManager(directory, device=device).restore(
                path=path, parallelism=s["restore_dp"])
            t = r.spmd_bridges[0].trainer
            check((t.dp, t.hub) == (s["restore_dp"], SPMD_MESH[1]),
                  f"spmd-ckpt[dp {s['restore_dp']}, {device}]: mesh {(t.dp, t.hub)}")
            got = t.fleet_numpy()["params"]
            for leaf, g in zip(tree_leaves(saved), tree_leaves(got)):
                mean = leaf[:, 0].mean(axis=0)
                check(np.allclose(g, np.broadcast_to(mean, g.shape), rtol=1e-6, atol=1e-7),
                      f"spmd-ckpt[dp {s['restore_dp']}, {device}]: the params are not the "
                      "mean of the saved replicas")
            seeded[device] = (r, _concat(got))
        dp_err = float(np.abs(seeded["cuda"][1] - seeded["cpu"][1]).max())
        check(dp_err <= W_ATOL, f"spmd-ckpt[dp {s['restore_dp']}]: card and CPU seed "
              f"differently ({dp_err:.3e})")
        ran = {d: r.run(blocks[half:]).statistics[0] for d, (r, _) in seeded.items()}
        check(_int_stats(ran["cuda"]) == _int_stats(ran["cpu"]),
              f"spmd-ckpt[dp {s['restore_dp']}, cuda vs cpu]: "
              f"{_stat_diff(ran['cuda'], ran['cpu'])}")
        fa, fb = (seeded[d][0].spmd_bridges[0].trainer.global_flat_params() for d in ("cuda", "cpu"))
        run_err = float(np.abs(fa - fb).max())
        check(np.allclose(fa, fb, rtol=W_RTOL, atol=W_ATOL),
              f"spmd-ckpt[dp {s['restore_dp']}, cuda vs cpu]: params max|d|={run_err:.3e}")

        t0 = time.perf_counter()
        trainer.save(str(tmp / "spmd_trainer"))
        tsave_s = time.perf_counter() - t0
        request = job.spmd_bridges[0].request
        other = SPMDTrainer(request.learner, request.preprocessors or (), dim=trainer.dim,
                            protocol=trainer.protocol, mesh=trainer.mesh,
                            training_configuration=trainer.tc, batch_size=trainer.batch_size)
        t0 = time.perf_counter()
        other.load(str(tmp / "spmd_trainer"))
        torch.cuda.synchronize()
        tload_s = time.perf_counter() - t0
        check(all(torch.equal(v, other.state[k]) for k, v in trainer.state.items()
                  if isinstance(v, torch.Tensor)), "spmd-ckpt: SPMDTrainer save/load not bitwise")
    finally:
        spmd_bridge.device_slots = slots
    log("spmd-ckpt: " + json.dumps({
        "rows": s["rows"], "mesh": list(SPMD_MESH), "snapshot_at": s["snapshot_at"],
        "job_save_s": save_s, "same_mesh": {"params_max_abs_diff": same_err,
                                            "fitted": cont.fitted},
        "restore_dp": s["restore_dp"], "dp_seed_cuda_vs_cpu_max_abs_diff": dp_err,
        "dp_run_cuda_vs_cpu_max_abs_diff": run_err,
        "trainer_save_s": tsave_s, "trainer_load_s": tload_s, "trainer_roundtrip": "bitwise",
    }))


def phase_lm_ckpt(torch, attention, trainer, seed, tmp: Path):
    """Phase 38: phase 9's trainer saved; a fresh SeqTrainer (another seed)
    loads it (bitwise), both take LM_CKPT_STEPS steps; the loaded one
    launches each flash kernel n_layers x steps times. Returns its
    launches."""
    import os

    from omldm_tpu_torch.models.transformer import tree_leaves

    cfg = trainer.cfg
    tok, tgt, mask = copy_task_batches(LM_CKPT_STEPS, LM_BATCH, LM_LEN, cfg.vocab_size, seed + 1)
    t0 = time.perf_counter()
    trainer.save(str(tmp / "lm"))
    save_s = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(tmp / "lm" / f) for f in os.listdir(tmp / "lm"))
    fresh = _lm_trainer(seed + 1, **LM_CONFIG)
    t0 = time.perf_counter()
    fresh.load(str(tmp / "lm"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(fresh.fitted == trainer.fitted, "lm-ckpt: fitted token count differs after the load")
    pairs = list(zip(tree_leaves(trainer.params) + tree_leaves(trainer.opt),
                     tree_leaves(fresh.params) + tree_leaves(fresh.opt)))
    check(all(a.device == b.device and torch.equal(a, b) for a, b in pairs),
          "lm-ckpt: the loaded state is not the saved one")
    la = trainer.step_many(tok, tgt, mask).float().cpu()
    for name in attention.launches:
        attention.launches[name] = 0
    lb = fresh.step_many(tok, tgt, mask).float().cpu()
    torch.cuda.synchronize()
    launches = dict(attention.launches)
    want = cfg.n_layers * LM_CKPT_STEPS
    for name, n in launches.items():
        check(n == want, f"lm-ckpt: {name} launched {n} times by the loaded trainer, "
              f"expected {want}")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(tree_leaves(trainer.params), tree_leaves(fresh.params)))
    bitwise = err == 0.0 and torch.equal(la, lb)
    check(err <= LM_PARITY_ATOL, f"lm-ckpt: parameters after {LM_CKPT_STEPS} steps differ by "
          f"{err:.3e}")
    log("lm-ckpt: " + json.dumps({
        "save_s": save_s, "load_s": load_s, "snapshot_bytes": n_bytes,
        "steps_after": LM_CKPT_STEPS, "losses": {"saved": la.tolist(), "loaded": lb.tolist()},
        "params_max_abs_diff": err, "bitwise": bitwise, "launches_loaded": launches,
    }))
    return launches


# --- the overload and lifecycle planes (phases 39-40) ---------------------------

# protocol_comparison.py's overload smoke: 64 tenants, a 50/50 per-record
# stream, the 10x burst at tenant 0 through the middle half of the stream
OVERLOAD_RUN = dict(tenants=64, records=4_096, parity_records=1_024, batch=256,
                    test_set_size=64, trials=3)
OVERLOAD_SPEC = "window=32,share=2,hotHigh=24,hotCritical=48,cool=24"
OVERLOAD_SERVING = {"maxBatch": 64, "maxDelayMs": 500.0}
OVERLOAD_BURST = 10
OVERLOAD_SPARSE_RECORDS = 2_000
# protocol_comparison.py's lifecycle smoke, with perRecord on the Create
LIFECYCLE_RUN = dict(records=6_144, batch=64, test_set_size=64, poison_at=1_024,
                     snapshot_at=768)
LIFECYCLE_SPEC = {"rampFrom": 0.0, "rampTo": 0.5, "rampEvery": 64, "rampStep": 0.125,
                  "promoteAfter": 128, "shadowEvery": 8, "minShadowEvals": 2,
                  "scoreEnvelope": 0.05, "seed": 7}


def overload_stream(records: int, dim: int = N_FEATURES):
    """protocol_comparison.py's _mt_stream: standard-normal rows and a
    planted linear rule (the overload and lifecycle smokes' stream)."""
    import numpy as np

    rng = np.random.RandomState(0)
    w = np.random.RandomState(42).randn(dim)
    x = rng.randn(records, dim).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def overload_chaos(records: int) -> str:
    """The burst window in forecasting records (half the stream): the
    middle half floods tenant 0."""
    n_fore = records // 2
    return (f"seed=7,burst={OVERLOAD_BURST},burstFrom={n_fore // 4},"
            f"burstLen={n_fore // 2},hotTenant=0")


def _feed_5050(job, x, y, lo, hi, before=None):
    """Rows [lo, hi) as DataInstance events, even rows forecasts, odd rows
    training; ``before(i)`` runs ahead of row i."""
    from omldm_tpu_torch.api.data import FORECASTING, DataInstance

    for i in range(lo, hi):
        if before is not None:
            before(i)
        if i % 2 == 0:
            job.process_event("forecastingData", DataInstance(
                numerical_features=x[i].tolist(), operation=FORECASTING))
        else:
            job.process_event("trainingData", DataInstance(
                numerical_features=x[i].tolist(), target=float(y[i])))


@contextlib.contextmanager
def _timed_legs():
    """Timed legs without the collector's full passes, as ``timeit`` times
    with the collector off: a full pass walks every object the script still
    holds, so its length is set by the phases before and not by the job, and
    one that lands inside a leg moves that leg's latency and rate by 10-25%
    on the card's host. Young collections still run inside the legs; each
    leg starts with a full ``gc.collect()`` of its own, and the thresholds
    come back when the legs end."""
    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(thresholds[0], thresholds[1], 1 << 30)
    try:
        yield
    finally:
        gc.set_threshold(*thresholds)


def _overload_job(torch, x, y, burst, device="cuda"):
    """protocol_comparison.py's run_overload_one on the port: the tenants'
    Creates, an untimed warm-up of min(512, records / 4) rows, the timed
    rest, termination. Returns the reference's result row, the per-tenant
    counters and the job."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    r = OVERLOAD_RUN
    records = x.shape[0]
    # every leg starts clean: the previous leg's job (its reference cycles
    # and retained predictions) is collected here, before any forecast's
    # latency clock starts
    gc.collect()
    job = StreamJob(JobConfig(parallelism=1, batch_size=r["batch"],
                              test_set_size=r["test_set_size"], test=False, cohort="off",
                              overload=OVERLOAD_SPEC, serving="",
                              chaos=overload_chaos(records) if burst else ""), device=device)
    for pid in range(r["tenants"]):
        create = _create({"name": "PA", "hyperParameters": {"C": 1.0}}, (),
                         {"protocol": "Asynchronous", "syncEvery": 4,
                          "serving": OVERLOAD_SERVING}, x.shape[1])
        create["id"] = pid
        job.process_event("requests", json.dumps(create))
    warm = min(512, records // 4)
    _feed_5050(job, x, y, 0, warm)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feed_5050(job, x, y, warm, records)
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    level_after_feed = job.overload_level()
    report = job.terminate()
    by = {s.pipeline: s for s in report.statistics}
    hot, healthy = by[0], [s for p, s in by.items() if p != 0]
    served = sum(s.forecasts_served for s in healthy)
    row = {
        "burst": bool(burst), "records": records, "elapsed_s": elapsed,
        "healthy_forecasts_served": served, "healthy_forecasts_per_sec": served / elapsed,
        "healthy_serve_p99_ms": max((s.serve_latency_p99_ms for s in healthy), default=0.0),
        "healthy_shed": sum(s.forecasts_shed for s in healthy),
        "hot_served": hot.forecasts_served, "hot_shed": hot.forecasts_shed,
        "hot_throttled": hot.records_throttled,
        "pressure_peak": max(s.pressure_level for s in by.values()),
        "level_after_feed": level_after_feed,
        "shed_latency_ms": max(s.shed_latency_ms for s in by.values()),
        "dead_letter_reasons": dict(job.dead_letter.by_reason),
        "queue_depths": job.terminate_accounting,
    }
    tenants = {p: (s.forecasts_shed, s.records_throttled, s.forecasts_served)
               for p, s in sorted(by.items())}
    return row, tenants, job


def _overload_gates(base, burst, ratio):
    """protocol_comparison.py's overload gates (a)-(d); returns failures."""
    failures = []
    if burst["hot_shed"] == 0:
        failures.append("the burst never engaged shedding (hot_shed 0)")
    if burst["hot_throttled"] == 0:
        failures.append("the burst never deferred training (hot_throttled 0)")
    if burst["pressure_peak"] < 2:
        failures.append(f"the level never reached CRITICAL (peak {burst['pressure_peak']})")
    if burst["healthy_shed"]:
        failures.append(f"{burst['healthy_shed']} healthy-tenant forecasts shed")
    if burst["healthy_forecasts_served"] != base["healthy_forecasts_served"]:
        failures.append(f"healthy tenants served {burst['healthy_forecasts_served']} under "
                        f"the burst, {base['healthy_forecasts_served']} without it")
    budget = OVERLOAD_SERVING["maxDelayMs"]
    if burst["healthy_serve_p99_ms"] > budget:
        failures.append(f"healthy serve p99 {burst['healthy_serve_p99_ms']:.3f} ms over the "
                        f"{budget} ms budget")
    if burst["healthy_serve_p99_ms"] > 1.5 * base["healthy_serve_p99_ms"]:
        failures.append(f"healthy serve p99 {burst['healthy_serve_p99_ms']:.3f} ms > 1.5x the "
                        f"no-burst leg's {base['healthy_serve_p99_ms']:.3f} ms")
    if ratio < 0.9:
        failures.append(f"healthy forecast throughput {ratio:.3f}x the no-burst leg's (< 0.9)")
    if burst["level_after_feed"] != 0:
        failures.append(f"the level is {burst['level_after_feed']} after the burst, not OK")
    stranded = {k: v for k, v in burst["queue_depths"].items() if k != "pressure_level" and v}
    if stranded:
        failures.append(f"stranded queue rows at terminate: {stranded}")
    return failures


def phase_overload_legs(torch, trials, collector):
    """--overload-legs: phase 39's timed legs alone, every gate reported and
    none held, with the full collections inside each leg (ms) beside its
    p99 and seconds."""
    import omldm_tpu_torch

    log(f"overload-legs: package {Path(omldm_tpu_torch.__file__).parent}, "
        f"collector {collector}")
    x, y = overload_stream(OVERLOAD_RUN["records"])
    _overload_job(torch, x[:1024], y[:1024], burst=False)
    full = []
    t0 = [0.0]

    def note(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        elif info["generation"] == 2:
            full.append(round((time.perf_counter() - t0[0]) * 1e3, 1))

    gc.callbacks.append(note)
    try:
        with _timed_legs() if collector == "deferred" else contextlib.nullcontext():
            for trial in range(trials):
                legs = []
                for burst_on in (False, True):
                    full.clear()
                    row, _, _ = _overload_job(torch, x, y, burst=burst_on)
                    # the first full collection is the leg's own, before its clock
                    legs.append((row, full[1:]))
                (base, base_gc), (burst, burst_gc) = legs
                ratio = (burst["healthy_forecasts_per_sec"]
                         / max(base["healthy_forecasts_per_sec"], 1e-9))
                log("overload-legs: " + json.dumps({
                    "trial": trial, "ratio": ratio,
                    "p99_ms": [base["healthy_serve_p99_ms"], burst["healthy_serve_p99_ms"]],
                    "elapsed_s": [base["elapsed_s"], burst["elapsed_s"]],
                    "full_collections_ms": [base_gc, burst_gc],
                    "failures": _overload_gates(base, burst, ratio)}))
    finally:
        gc.callbacks.remove(note)


def phase_overload(torch, pa_scan, sparse, seed, sparse_events):
    """Phase 39. Returns (the quiet-armed leg's batched pa_scan launches,
    the sparse leg's scatter_add launches)."""
    import numpy as np

    r = OVERLOAD_RUN
    x, y = overload_stream(r["records"])
    # a warm-up job builds the programs and the serving scratch, as the
    # reference's smoke does, so the first trial's base leg is not the
    # slower one
    _overload_job(torch, x[:1024], y[:1024], burst=False)
    # paired trials until one meets every gate (the reference's best of 3:
    # the legs' timings are the shared host's); else the best ratio's
    trials = []
    with _timed_legs():
        for trial in range(r["trials"]):
            base, _, _ = _overload_job(torch, x, y, burst=False)
            burst, _, _ = _overload_job(torch, x, y, burst=True)
            ratio = (burst["healthy_forecasts_per_sec"]
                     / max(base["healthy_forecasts_per_sec"], 1e-9))
            failures = _overload_gates(base, burst, ratio)
            trials.append((not failures, ratio, base, burst, failures))
            log(f"overload[trial {trial}]: healthy throughput burst / no-burst {ratio:.4f} "
                f"({burst['healthy_forecasts_per_sec']:.1f} / "
                f"{base['healthy_forecasts_per_sec']:.1f} forecasts/s), healthy p99 "
                f"{burst['healthy_serve_p99_ms']:.3f} / {base['healthy_serve_p99_ms']:.3f} ms, "
                f"failures {failures}")
            if not failures:
                break
    _, ratio, base, burst, failures = max(trials, key=lambda t: t[:2])
    log("overload: " + json.dumps({"spec": OVERLOAD_SPEC, "chaos": overload_chaos(r["records"]),
                                   "healthy_throughput_ratio": ratio, "trials": len(trials),
                                   "no_burst": base, "burst": burst, "failures": failures}))
    check(not failures, "overload: " + "; ".join(failures))

    # the shed and throttle schedule: a pure function of the records
    n = r["parity_records"]
    sched = {}
    for device in ("cuda", "cpu"):
        for burst_on in (False, True):
            row, tenants, job = _overload_job(torch, x[:n], y[:n], burst_on, device)
            sched[(device, burst_on)] = (tenants, row["dead_letter_reasons"])
    for burst_on in (False, True):
        check(sched[("cuda", burst_on)] == sched[("cpu", burst_on)],
              f"overload-parity: the {'burst' if burst_on else 'no-burst'} leg's per-tenant "
              f"shed/throttled/served or dead letters differ between the card and the CPU")
    tenants, letters = sched[("cuda", True)]
    check(tenants[0][0] > 0 and letters.get("shed_overload", 0) > 0,
          "overload-parity: the first rows' burst leg shed nothing")
    log(f"overload-parity: first {n} rows, both legs, card against CPU: per-tenant "
        f"forecastsShed, recordsThrottled and forecastsServed equal, dead letters {letters} "
        f"equal; hot tenant {tenants[0]}")

    # quiet-armed block admission: phase 28's tenants, cohorts on
    m = MT_RUN["prefix_records"]
    mx, my, mop = mt_stream(m, seed)
    runs, walls = {}, {False: [], True: []}
    for armed in (False, True, True, False):  # in turns: the host drifts
        _mt_reset(pa_scan)
        job, report, wall = _mt_job(torch, mx, my, mop, "cuda", "auto", MT_RUN["nets"],
                                    overload="on" if armed else "")
        runs[armed] = (job, report, wall, _mt_counts(pa_scan))
        walls[armed].append(wall)
    job, _, _, counts = runs[True]
    check(all(s.overload is not None and s.overload.level_peak == 0 for s in job.spokes),
          "overload-quiet: the armed controllers flagged uniform traffic")
    check(counts["pa_scan"] == 0 and counts["pa_scan_batched"] == counts["gang_steps"] > 0,
          f"overload-quiet: launches {counts}: one batched pa_scan a gang step, no solo launch")
    check(_by_net(runs[True][0].predictions) == _by_net(runs[False][0].predictions),
          "overload-quiet: arming the plane changed a prediction")
    log("overload-quiet: " + json.dumps({
        "records": m, "tenants": MT_RUN["nets"], "parallelism": MT_RUN["parallelism"],
        "records_per_s": {"armed": [m / w for w in walls[True]],
                          "unarmed": [m / w for w in walls[False]]},
        "armed_over_unarmed": sum(walls[False]) / sum(walls[True]), "launches": {
            "armed": counts, "unarmed": runs[False][3]},
        "predictions_bitwise_equal": len(runs[True][0].predictions)}))

    # a sparse net through the armed admission: scatter_add once a fit
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    for name in sparse.launches:
        sparse.launches[name] = 0
    job = StreamJob(JobConfig(parallelism=1, batch_size=256, overload="on"), device="cuda")
    report = job.run(sparse_events[: OVERLOAD_SPARSE_RECORDS + 1])
    torch.cuda.synchronize()
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    scatter = sparse.launches["scatter_add"]
    check(job.spokes[0].overload is not None, "overload-sparse: the net is not armed")
    check(scatter == fits > 0, f"overload-sparse: scatter_add launches {scatter} for {fits} fits")
    log(f"overload-sparse: phase 14's learner on {OVERLOAD_SPARSE_RECORDS} records, armed: "
        f"scatter_add launches {scatter} for {fits} fits, score {stats.score:.4f}")
    return counts["pa_scan_batched"], scatter


def _lifecycle_job(x, y, mode, device="cuda", until=None, job=None, start=0,
                   checkpoint_dir=None, events=""):
    """protocol_comparison.py's run_lifecycle_one on the port, perRecord:
    ``mode`` off, healthy, hold or poison. ``until`` stops before that row
    (no termination); ``job`` and ``start`` continue one. Returns (job,
    active fits counter)."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    r = LIFECYCLE_RUN
    if job is None:
        spec = dict(LIFECYCLE_SPEC)
        if mode == "hold":
            spec["promoteAfter"] = 10 * x.shape[0]
        extra = {} if checkpoint_dir is None else dict(
            checkpointing=True, checkpoint_dir=str(checkpoint_dir), check_interval_ms=10 ** 9)
        job = StreamJob(JobConfig(parallelism=1, batch_size=r["batch"],
                                  test_set_size=r["test_set_size"], test=True, events=events,
                                  **extra),
                        device=device)
        tc = {"protocol": "Asynchronous", "syncEvery": 4, "perRecord": True}
        if mode != "off":
            tc["lifecycle"] = spec
        job.process_event("requests", json.dumps(_create(
            {"name": "PA", "hyperParameters": {"C": 1.0}}, (), tc, x.shape[1])))
        if mode != "off":
            job.process_event("requests", json.dumps({
                "id": 0, "request": "Shadow",
                "learner": {"name": "PA", "hyperParameters": {"C": 0.5},
                            "dataStructure": {"nFeatures": int(x.shape[1])}}}))
            job.process_event("requests", json.dumps({"id": 0, "request": "Promote"}))
    net = job.spokes[0].nets[0]
    if not hasattr(job, "smoke"):
        # the active model's fits (every flush reaches the node once) and
        # the row before which the registry first shows a promotion
        job.smoke = {"active_fits": 0, "promoted_at_row": None}
        node_fit = net.node.on_training_batch

        def counted(*a, **k):
            job.smoke["active_fits"] += 1
            return node_fit(*a, **k)

        net.node.on_training_batch = counted

    def before(i):
        if (job.smoke["promoted_at_row"] is None and net.lifecycle is not None
                and net.lifecycle.active_version != 0):
            job.smoke["promoted_at_row"] = i
        if mode == "poison" and i == r["poison_at"]:
            entry = net.lifecycle.candidate_entry
            if entry is not None and entry.pipeline is not None:
                flat, _ = entry.pipeline.get_flat_params()
                entry.pipeline.set_flat_params(np.full_like(flat, 1.0e9))

    _feed_5050(job, x, y, start, x.shape[0] if until is None else until, before)
    return job


def _lifecycle_leg(torch, pa_scan, x, y, mode, device="cuda", events=""):
    """One leg with the pa_scan count set to 0 just before: the leg's
    summary, checked to launch pa_scan once an active fit plus once a
    candidate fit (with ``events``, the flight recorder's spec, its journal
    too)."""
    pa_scan.launches = 0
    t0 = time.perf_counter()
    job = _lifecycle_job(x, y, mode, device, events=events)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a perRecord fit's last rows (the termination flush) count too
    report = job.terminate()
    launches = pa_scan.launches
    [s] = report.statistics
    lc = job.spokes[0].nets[0].lifecycle
    cand_fits = sum(e.fits for v, e in lc.versions.items() if v != 0) if lc is not None else 0
    active_fits = job.smoke["active_fits"]
    if device == "cuda":
        check(launches == active_fits + cand_fits > 0,
              f"lifecycle[{mode}]: pa_scan launches {launches} != active fits {active_fits} + "
              f"candidate fits {cand_fits}")
    return {
        "mode": mode, "wall_s": wall, "records_per_s": x.shape[0] / wall,
        "predictions": [(p.value, p.version) for p in job.predictions],
        "lifecycle": lc.describe() if lc is not None else None,
        "promoted_at_row": job.smoke["promoted_at_row"],
        "pa_scan_launches": launches, "active_fits": active_fits, "candidate_fits": cand_fits,
        "shadow_scored": s.shadow_scored, "canary_promotions": s.canary_promotions,
        "canary_rollbacks": s.canary_rollbacks, "active_version": s.active_version,
        "forecasts_served": s.forecasts_served, "score": s.score,
        "journal": ([{k: v for k, v in e.items() if k != "wall"}
                     for e in job.events.journal.tail()] if job.events is not None else None),
    }


def phase_lifecycle(torch, pa_scan, tmp: Path):
    """Phase 40. Returns (the four legs' pa_scan launches, the poison leg's
    (value, version) predictions)."""
    import os

    from omldm_tpu_torch.checkpoint import CheckpointManager

    r = LIFECYCLE_RUN
    x, y = overload_stream(r["records"])
    # untimed: the first run of a net's per-record paths pays one-time
    # costs, which would land on whichever leg ran first
    _lifecycle_job(x[:512], y[:512], "hold").terminate()
    legs = {mode: _lifecycle_leg(torch, pa_scan, x, y, mode)
            for mode in ("off", "healthy", "hold", "poison")}
    off, healthy, hold, poison = (legs[m] for m in ("off", "healthy", "hold", "poison"))
    failures = []
    if healthy["canary_promotions"] < 1 or healthy["canary_rollbacks"]:
        failures.append(f"healthy: promotions {healthy['canary_promotions']}, rollbacks "
                        f"{healthy['canary_rollbacks']}")
    if healthy["active_version"] != 1 or healthy["shadow_scored"] < 2:
        failures.append(f"healthy: active version {healthy['active_version']}, shadowScored "
                        f"{healthy['shadow_scored']}")
    if poison["canary_rollbacks"] < 1 or poison["canary_promotions"]:
        failures.append(f"poison: rollbacks {poison['canary_rollbacks']}, promotions "
                        f"{poison['canary_promotions']}")
    if poison["lifecycle"]["activeVersion"] != 0:
        failures.append(f"poison: active version {poison['lifecycle']['activeVersion']}")
    if hold["canary_promotions"] or not any(v is not None for _, v in hold["predictions"]):
        failures.append("hold: promoted, or the canary served nothing")
    for leg in (healthy, hold, poison):
        if len(leg["predictions"]) != len(off["predictions"]):
            failures.append(f"{leg['mode']}: {len(leg['predictions'])} forecasts answered, "
                            f"{len(off['predictions'])} without the plane")
    for leg in (hold, poison):
        mism = sum(1 for (v, ver), (v0, _) in zip(leg["predictions"], off["predictions"])
                   if ver is None and v != v0)
        if mism:
            failures.append(f"{leg['mode']}: {mism} baseline predictions differ from the off "
                            f"leg's")
    for leg in (off, healthy, hold, poison):
        log(f"lifecycle[{leg['mode']}]: " + json.dumps({
            k: v for k, v in leg.items() if k not in ("predictions", "lifecycle", "journal")}))
    check(not failures, "lifecycle: " + "; ".join(failures))

    # the healthy leg on the CPU
    cpu = _lifecycle_leg(torch, pa_scan, x, y, "healthy", "cpu")
    tags = [v for _, v in healthy["predictions"]]
    equal = sum(1 for (a, _), (b, _) in zip(healthy["predictions"], cpu["predictions"])
                if a == b)
    check(cpu["promoted_at_row"] == healthy["promoted_at_row"] is not None,
          f"lifecycle-parity: promoted before row {healthy['promoted_at_row']} on the card, "
          f"{cpu['promoted_at_row']} on the CPU")
    check(tags == [v for _, v in cpu["predictions"]], "lifecycle-parity: version tags differ")
    check(equal >= 0.99 * len(tags), f"lifecycle-parity: {equal} of {len(tags)} equal")
    log(f"lifecycle-parity: healthy leg, card against CPU: promoted before row "
        f"{healthy['promoted_at_row']} (forecast {(healthy['promoted_at_row'] + 1) // 2}) on "
        f"both, version tags equal, {equal} of {len(tags)} predictions equal")

    # a snapshot mid-canary, restored on the card and the CPU
    at = r["snapshot_at"]
    ckpt = tmp / "lifecycle"
    job = _lifecycle_job(x, y, "healthy", until=at, checkpoint_dir=ckpt)
    lc = job.spokes[0].nets[0].lifecycle
    check(lc.canary_active and lc.active_version == 0,
          f"lifecycle-ckpt: not mid-canary at row {at}")
    t0 = time.perf_counter()
    path = job.checkpoint_manager.save(job)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    _lifecycle_job(x, y, "healthy", job=job, start=at)
    rows = {"uninterrupted": job.smoke["promoted_at_row"]}
    restore_s = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        restored = CheckpointManager(str(ckpt), device=device).restore(path=path)
        restore_s[device] = time.perf_counter() - t0
        _lifecycle_job(x, y, "healthy", job=restored, start=at)
        rows[device] = restored.smoke["promoted_at_row"]
        check(restored.spokes[0].nets[0].lifecycle.describe()["counters"] ==
              job.spokes[0].nets[0].lifecycle.describe()["counters"],
              f"lifecycle-ckpt: the {device} restore's counters differ")
    check(set(rows.values()) == {healthy["promoted_at_row"]},
          f"lifecycle-ckpt: promoted before rows {rows}, the healthy leg before "
          f"{healthy['promoted_at_row']}")

    # the device time the candidate adds: the hold leg against the off leg
    busy = {mode: _busy_s(torch, lambda m=mode: _lifecycle_job(x, y, m).terminate())
            for mode in ("off", "hold")}
    line = {
        "records": r["records"],
        "records_per_s": {m: legs[m]["records_per_s"] for m in legs},
        "over_off": {m: legs[m]["records_per_s"] / off["records_per_s"]
                     for m in ("healthy", "hold", "poison")},
        "pa_scan": {m: {"launches": legs[m]["pa_scan_launches"],
                        "active_fits": legs[m]["active_fits"],
                        "candidate_fits": legs[m]["candidate_fits"]} for m in legs},
        "promoted_at_row": healthy["promoted_at_row"],
        "device_busy_s": busy,
        "candidate_device_share_hold": (busy["hold"] - busy["off"]) / busy["hold"],
        "snapshot": {"at_row": at, "bytes": size, "save_s": save_s, "restore_s": restore_s,
                     "promoted_at_row": rows},
    }
    log("lifecycle: " + json.dumps(line))
    return {m: legs[m]["pa_scan_launches"] for m in legs}, poison["predictions"]


# phase 41: protocol_comparison.py's telemetry smoke (:2337-2450), not cut
TELEMETRY_SMOKE = dict(records=48_000, parallelism=4, batch=64, stats_every=4_096, trials=4,
                       warmup=2_048)
# phase 41 (b): phase 5's stream armed
TELEMETRY_STREAM_SPEC = "statsEvery=10000,traceSample=16"
# phase 41 (c): the training records of phase 17's stream the profiled CLI takes
PROFILED_CLI_RECORDS = 10_000
PA_SCAN_KERNELS = ("pa_gram_kernel", "pa_chain_kernel", "pa_update_kernel")
# phase 42: run_incident_smoke (protocol_comparison.py:883-1096), not cut
INCIDENT_SMOKE = dict(records=16_000, dim=28, parallelism=2, batch=64, chunk=512,
                      poison_chunk=6, death_rows=2_500, trials=4, warmup=2_048)
INCIDENT_EVENTS_SPEC = "watchdogEvery=2048,shedHigh=1"


def _strip_wall(events):
    return [{k: v for k, v in e.items() if k != "wall"} for e in events]


def _smoke_run(torch, protocol, x, y, parallelism, batch, device="cuda", sync_every=4,
               guard=False, telemetry="", events=""):
    """protocol_comparison.py's run_one on the port: a PA C 1.0 Create, the
    rows as packed blocks of PACKED_CHUNK (all training), termination, the
    clock from the first block to the synchronize after termination.
    Returns its result row."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    n = x.shape[0]
    job = StreamJob(JobConfig(parallelism=parallelism, batch_size=batch, test_set_size=64,
                              telemetry=telemetry, events=events), device=device)
    tc = {"protocol": protocol, "syncEvery": sync_every}
    if guard:
        tc["guard"] = True
    job.process_event("requests", json.dumps(_create(
        {"name": "PA", "hyperParameters": {"C": 1.0}}, (), tc, x.shape[1])))
    op = np.zeros((n,), np.uint8)
    # both legs start clean: the previous leg's garbage (the job's reference
    # cycles) is collected here, not inside the next leg's clock
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n, PACKED_CHUNK):
        job.process_packed_batch(x[i:i + PACKED_CHUNK], y[i:i + PACKED_CHUNK],
                                 op[i:i + PACKED_CHUNK])
    report = job.terminate()
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    [stats] = report.statistics
    out = {"examples_per_sec": n / elapsed, "score": stats.score, "fitted": stats.fitted,
           "models_shipped": stats.models_shipped, "bytes_on_wire": stats.bytes_on_wire,
           "num_of_blocks": stats.num_of_blocks, "events_recorded": stats.events_recorded,
           "alerts_raised": stats.alerts_raised}
    if telemetry:
        out["heartbeats"] = job.telemetry.heartbeats_emitted
        out["spans_completed"] = job.telemetry.spans.completed
        out["phase_table"] = job.phase_table(elapsed)
    return out


def _paired_trials(trials, run_off, run_on):
    """The smokes' paired method: ``trials`` back-to-back (off, on) pairs.
    Returns the best row of each leg and every pair's off/on ratio (host
    noise only inflates a pair's ratio, so the smallest estimates the
    plane's cost)."""
    best_off = best_on = None
    ratios = []
    with _timed_legs():
        for _ in range(trials):
            r_off, r_on = run_off(), run_on()
            ratios.append(r_off["examples_per_sec"] / max(r_on["examples_per_sec"], 1e-9))
            if best_off is None or r_off["examples_per_sec"] > best_off["examples_per_sec"]:
                best_off = r_off
            if best_on is None or r_on["examples_per_sec"] > best_on["examples_per_sec"]:
                best_on = r_on
    return best_off, best_on, ratios


def _kineto_busy_s(prof) -> float:
    """Device busy seconds of a finished torch.profiler run: the sum of its
    device events' durations (kernels, copies, memsets), read from the raw
    trace (``key_averages`` builds an event tree first, which takes seconds
    a 100,000-record stream)."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9


def _trace_kernel_counts(path: Path, names):
    """Launches of each kernel of ``names`` in a torch.profiler Chrome trace
    (a kernel event's name is its demangled signature, ``name(args...)``)."""
    import re

    pattern = re.compile(r"(?:^|[\s:])(" + "|".join(map(re.escape, names)) + r")\(")
    counts = dict.fromkeys(names, 0)
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("cat") == "kernel":
            m = pattern.search(e.get("name", ""))
            if m is not None:
                counts[m.group(1)] += 1
    return counts


def _telemetry_smoke_legs(torch, span_path: Path):
    """Phase 41a's stream and its two legs, the unarmed and the armed run,
    after the reference's warm-up runs. Returns (the armed spec, the
    unarmed leg, the armed leg)."""
    import numpy as np

    r = TELEMETRY_SMOKE
    rng = np.random.RandomState(13)
    w = np.random.RandomState(42).randn(N_FEATURES)
    tx = rng.randn(r["records"], N_FEATURES).astype(np.float32)
    ty = (tx @ w > 0).astype(np.float32)
    spec = f"statsEvery={r['stats_every']},traceSample=16,spanPath={span_path}"
    par, batch, head = r["parallelism"], r["batch"], r["warmup"]
    _smoke_run(torch, "Synchronous", tx[:head], ty[:head], par, batch)
    _smoke_run(torch, "Synchronous", tx[:head], ty[:head], par, batch,
               telemetry=f"statsEvery={r['stats_every']}")
    return (spec, lambda: _smoke_run(torch, "Synchronous", tx, ty, par, batch),
            lambda: _smoke_run(torch, "Synchronous", tx, ty, par, batch, telemetry=spec))


def phase_telemetry_legs(torch, trials, tmp: Path):
    """--telemetry-legs: phase 41a's paired legs alone, each pair's
    unarmed/armed ratio and records/s, the 1.03x gate reported on each
    pair and not held."""
    import omldm_tpu_torch

    log(f"telemetry-legs: package {Path(omldm_tpu_torch.__file__).parent}")
    _, run_off, run_on = _telemetry_smoke_legs(torch, tmp / "spans.jsonl")
    with _timed_legs():
        for trial in range(trials):
            off, on = run_off(), run_on()
            ratio = off["examples_per_sec"] / max(on["examples_per_sec"], 1e-9)
            log("telemetry-legs: " + json.dumps({
                "trial": trial, "ratio": ratio,
                "records_per_s": [off["examples_per_sec"], on["examples_per_sec"]],
                "heartbeats": on["heartbeats"], "over_gate": ratio > 1.03}))


def phase_telemetry(torch, pa_scan, events, slice_launches, slice_preds, tmp: Path):
    """Phase 41. Returns the pa_scan launches of (b) and (c)."""
    from torch.profiler import ProfilerActivity, profile

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob
    from omldm_tpu_torch.utils.tracing import trace_path

    # (a) the reference's smoke, its gates
    t_phase = time.perf_counter()
    r = TELEMETRY_SMOKE
    span_path = tmp / "spans.jsonl"
    spec, run_off, run_on = _telemetry_smoke_legs(torch, span_path)
    best_off, best_on, ratios = _paired_trials(r["trials"], run_off, run_on)
    overhead = min(ratios)
    failures = [f"armed leg diverged on {k}: {best_on[k]} != unarmed {best_off[k]}"
                for k in ("score", "fitted", "models_shipped", "bytes_on_wire", "num_of_blocks")
                if best_off[k] != best_on[k]]
    if overhead > 1.03:
        failures.append(f"telemetry-armed throughput {overhead:.3f}x slower than unarmed")
    # a heartbeat acts at the first block boundary past statsEvery records
    expected_beats = max(r["records"] // max(r["stats_every"], PACKED_CHUNK) - 1, 1)
    if best_on["heartbeats"] < expected_beats:
        failures.append(f"{best_on['heartbeats']} heartbeats < {expected_beats}")
    coverage = best_on["phase_table"].get("_coverage", 0.0)
    if coverage < 0.5:
        failures.append(f"the phase table attributes {coverage:.2f} of the wall (< 0.5)")
    if best_on["spans_completed"] == 0:
        failures.append("no protocol-round span completed")
    span_lines = span_path.read_text().splitlines() if span_path.exists() else []
    if not span_lines:
        failures.append("the span file is empty")
    else:
        first = json.loads(span_lines[0])
        failures += [f"span records lack {k!r}" for k in ("networkId", "seq", "op", "rttMs")
                     if k not in first]
    log("telemetry-smoke: " + json.dumps({
        "records": r["records"], "telemetry_spec": spec, "overhead_x": overhead,
        "pair_ratios": ratios, "phase_coverage": coverage, "spans_written": len(span_lines),
        "unarmed": best_off, "armed": best_on, "smoke_s": time.perf_counter() - t_phase}))
    check(not failures, "telemetry-smoke: " + "; ".join(failures))

    # (b) phase 5's stream armed, under torch.profiler's device trace
    pa_scan.launches = 0
    job = StreamJob(JobConfig(**SLICE_CONFIG, telemetry=TELEMETRY_STREAM_SPEC), device="cuda")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        job.run(events)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stream_launches = pa_scan.launches
    t_busy = time.perf_counter()
    busy = _kineto_busy_s(tp)
    t_busy = time.perf_counter() - t_busy
    preds = [p.value for p in job.predictions]
    table = job.phase_table(wall)
    beats = job.telemetry.heartbeats_emitted
    log(f"telemetry-stream: phase 5's stream armed ({TELEMETRY_STREAM_SPEC}), "
        f"torch.profiler tracing the device: {wall:.2f} s wall, {beats} heartbeats, "
        f"{job.telemetry.spans.completed} spans, pa_scan launches {stream_launches} "
        f"(unarmed {slice_launches}), device busy {busy:.4f} s (summed in {t_busy:.2f} s)")
    log("telemetry-stream: " + json.dumps({
        "wall_s": wall, "heartbeats": beats, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall, "phase_table": table,
        "launch_timing": job.launch_timing()}))
    check(stream_launches == slice_launches,
          f"telemetry-stream: pa_scan launches {stream_launches} != unarmed {slice_launches}")
    check(preds == slice_preds, "telemetry-stream: a prediction differs from phase 5's")
    check(beats == len(events) // 10_000,
          f"telemetry-stream: {beats} heartbeats for {len(events)} events")

    # (c) the CLI with --profileDir: the kernels in the trace, by name
    create = json.loads(events[0][1])
    create["learner"]["dataStructure"] = {"nFeatures": N_FEATURES}
    cut, n_train = [("requests", json.dumps(create))], 0
    for stream, payload in events[1:]:
        if stream == "trainingData":
            if n_train == PROFILED_CLI_RECORDS:
                break
            n_train += 1
        if stream != "requests":
            cut.append((stream, payload))
    train, reqs = write_stream_files(cut, tmp, "profiled")
    argv = CLI_ARGS + ["--trainingData", train, "--requests", reqs, "--fastIngest", "true"]
    pa_scan.launches = 0
    _, plain_wall, plain_preds = run_cli(torch, argv, tmp, "unprofiled")
    plain_launches = pa_scan.launches
    prof_dir = tmp / "profile"
    pa_scan.launches = 0
    _, prof_wall, prof_preds = run_cli(torch, argv + ["--profileDir", prof_dir], tmp, "profiled")
    prof_launches = pa_scan.launches
    trace = Path(trace_path(str(prof_dir)))
    t_parse = time.perf_counter()
    named = _trace_kernel_counts(trace, PA_SCAN_KERNELS)
    t_parse = time.perf_counter() - t_parse
    log(f"cli-profiled: the first {n_train} training records of phase 17's stream: "
        f"{plain_wall:.2f} s unprofiled, {prof_wall:.2f} s under --profileDir "
        f"({trace.stat().st_size} bytes of trace, read in {t_parse:.2f} s); pa_scan launches "
        f"{prof_launches} "
        f"(unprofiled {plain_launches}); kernels in the trace: {json.dumps(named)}")
    check(prof_launches == plain_launches > 0,
          f"cli-profiled: pa_scan launches {prof_launches}, unprofiled {plain_launches}")
    check(all(n == prof_launches for n in named.values()),
          f"cli-profiled: the trace's kernels {named} != {prof_launches} pa_scan launches")
    check([(p["dataInstance"], p["value"]) for p in prof_preds]
          == [(p["dataInstance"], p["value"]) for p in plain_preds],
          "cli-profiled: the profiled run's predictions differ")
    return stream_launches, prof_launches


def _incident_leg(torch, device, gx, gy, tmp: Path):
    """run_incident_smoke's supervised leg on ``device``: guard maxStrikes
    1, the reliable channel, syncEvery 1, spoke 1 poisoned before block
    poison_chunk, worker 0 dying after death_rows rows, JobSupervisor with
    one restart. Returns (supervisor, injector, performance records)."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob
    from omldm_tpu_torch.runtime.job import PACKED_STREAM
    from omldm_tpu_torch.runtime.recovery import FaultInjector, JobSupervisor, replayable

    r = INCIDENT_SMOKE
    op = np.zeros((r["records"],), np.uint8)
    create = json.dumps(_create({"name": "PA", "hyperParameters": {"C": 1.0}}, (), {
        "protocol": "Asynchronous", "syncEvery": 1, "guard": {"maxStrikes": 1},
        "comm": {"reliable": True}}, r["dim"]))
    perf = []
    job = StreamJob(JobConfig(parallelism=r["parallelism"], batch_size=r["batch"],
                              test_set_size=64, events=INCIDENT_EVENTS_SPEC,
                              blackbox_path=str(tmp)),
                    on_performance=perf.append, device=device)
    holder = {"job": job}
    poisoned = [False]

    def make_events():
        yield ("requests", create)
        for idx, i in enumerate(range(0, r["records"], r["chunk"])):
            if idx == r["poison_chunk"] and not poisoned[0]:
                poisoned[0] = True
                net = holder["job"].spokes[1].nets[0]
                flat, _ = net.pipeline.get_flat_params()
                net.pipeline.set_flat_params(np.full_like(flat, 1e9))
            yield (PACKED_STREAM, (gx[i:i + r["chunk"]], gy[i:i + r["chunk"]],
                                   op[i:i + r["chunk"]]))

    injector = FaultInjector()
    injector.arm(job, worker_id=0, after_records=r["death_rows"])
    sup = JobSupervisor(job, replayable(make_events), max_restarts=1,
                        on_failure=lambda rec: holder.update(job=sup.job))
    sup.run()
    return sup, injector, perf


def _incident_gates(sup, injector, perf):
    """run_incident_smoke's gates on one supervised leg. Returns (failures,
    the bundle's timeline)."""
    failures = []
    if injector.fired != 1 or len(sup.failures) != 1:
        failures.append(f"the worker death gave fired={injector.fired}, "
                        f"restarts={len(sup.failures)}")
    if not any(p.kind == "alert" for p in perf):
        failures.append('no kind="alert" record reached the performance sink')
    if sup.bundle_path is None:
        return failures + ["no merged incident bundle"], []
    timeline = json.load(open(sup.bundle_path))["timeline"]
    kinds = [e["kind"] for e in timeline]

    def first(kind, pred=lambda e: True):
        return next((i for i, e in enumerate(timeline) if e["kind"] == kind and pred(e)), None)

    i_rej = first("delta_rejected", lambda e: e.get("strikes", 0) >= 1)
    i_ret = first("worker_retired", lambda e: e["cause"] == "guard_strikes")
    i_restart = first("restart")
    if None in (i_rej, i_ret, i_restart):
        failures.append(f"the bundle lacks the rejection/retire/restart chain: {sorted(set(kinds))}")
    elif not i_rej < i_ret < i_restart:
        failures.append(f"the chain is out of order: {i_rej}, {i_ret}, {i_restart}")
    if i_rej is not None and timeline[i_rej].get("stamp") is None:
        failures.append("the rejection carries no transport stamp")
    per_stream = {}
    for e in timeline:
        if e.get("stamp") and e["stamp"][0] == 0:
            per_stream.setdefault((e.get("worker"), e.get("hub"), e.get("side", "")),
                                  []).append(e["stamp"][1])
    failures += [f"stream {k} not in seq order: {v}" for k, v in per_stream.items()
                 if v != sorted(v)]
    if "alert" not in kinds:
        failures.append("the bundle carries no alert")
    return failures, timeline


def phase_flight_recorder(torch, pa_scan, seed, guard_cohort, lifecycle_launches,
                          poison_preds, tmp: Path):
    """Phase 42. Returns the batched pa_scan launches of (b) and the
    pa_scan launches of (c) on the card."""
    import numpy as np

    # (a) the reference's incident smoke, its gates
    r = INCIDENT_SMOKE
    rng = np.random.RandomState(11)
    w = np.random.RandomState(42).randn(r["dim"])
    gx = rng.randn(r["records"], r["dim"]).astype(np.float32)
    gy = (gx @ w > 0).astype(np.float32)
    par, batch, head = r["parallelism"], r["batch"], r["warmup"]
    _smoke_run(torch, "Asynchronous", gx[:head], gy[:head], par, batch, guard=True)
    _smoke_run(torch, "Asynchronous", gx[:head], gy[:head], par, batch, guard=True,
               events=INCIDENT_EVENTS_SPEC)
    clean_off, clean_on, ratios = _paired_trials(
        r["trials"], lambda: _smoke_run(torch, "Asynchronous", gx, gy, par, batch, guard=True),
        lambda: _smoke_run(torch, "Asynchronous", gx, gy, par, batch, guard=True,
                           events=INCIDENT_EVENTS_SPEC))
    overhead = min(ratios)
    failures = []
    if clean_on["score"] != clean_off["score"]:
        failures.append(f"armed clean score {clean_on['score']} != {clean_off['score']}")
    if overhead > 1.03:
        failures.append(f"events-armed clean throughput {overhead:.3f}x slower than unarmed")
    if clean_on["events_recorded"] < 1:
        failures.append("the armed clean leg recorded no event")
    legs = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        sup, injector, perf = _incident_leg(torch, device, gx, gy, tmp / f"incident_{device}")
        leg_failures, timeline = _incident_gates(sup, injector, perf)
        failures += [f"{device}: {f}" for f in leg_failures]
        legs[device] = {"timeline": timeline, "by_kind": json.load(open(sup.bundle_path))[
            "byKind"] if sup.bundle_path else None,
            "alerts_on_sink": sum(1 for p in perf if p.kind == "alert"),
            "wall_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
    if _strip_wall(legs["cuda"]["timeline"]) != _strip_wall(legs["cpu"]["timeline"]):
        failures.append("the card's bundle timeline differs from the CPU's")
    log("incident-smoke: " + json.dumps({
        "records": r["records"], "events_spec": INCIDENT_EVENTS_SPEC, "overhead_x": overhead,
        "pair_ratios": ratios, "clean_events_off": clean_off, "clean_events_on": clean_on,
        **{device: {k: v for k, v in leg.items() if k != "timeline"}
           for device, leg in legs.items()},
        "timeline_events": len(legs["cuda"]["timeline"])}))
    check(not failures, "incident-smoke: " + "; ".join(failures))

    # (b) phase 32's poisoned guarded cohorts, recorded, card and CPU
    m = MT_RUN
    n = m["prefix_records"]
    x, y, op = mt_stream(n, seed)
    victim = guard_cohort["victim"]
    runs = {}
    for device in ("cuda", "cpu"):
        _mt_reset(pa_scan)
        poisoned_on = []
        job, _, wall = _mt_job(torch, x, y, op, device, "auto", m["nets"], guard=True,
                               split_at=n // 2, poke=_poison_tenant(victim, poisoned_on),
                               events="on")
        runs[device] = {"job": job, "wall": wall, "counts": _mt_counts(pa_scan),
                        "journal": _strip_wall(job.events.journal.tail())}
    card, cpu = runs["cuda"], runs["cpu"]
    guard_kinds = ("guard_trip", "guard_rollback", "guard_evict")
    recorded = [e for e in card["journal"] if e["kind"] in guard_kinds]
    log(f"recorder-cohort: {m['nets']} guarded tenants, {n} rows, tenant {victim} poisoned, "
        f"events on: {len(card['journal'])} events ({len(recorded)} guard events), batched "
        f"pa_scan launches {card['counts']['pa_scan_batched']} and solo "
        f"{card['counts']['pa_scan']} (the evicted member's), unarmed "
        f"{guard_cohort['poisoned_counts']['pa_scan_batched']} and "
        f"{guard_cohort['poisoned_counts']['pa_scan']}; {n / card['wall']:.1f} records/s on "
        f"the card, {n / cpu['wall']:.1f} on the CPU")
    check({e["kind"] for e in recorded} == set(guard_kinds)
          and all(e.get("pipeline") == victim for e in recorded),
          f"recorder-cohort: guard events {[(e['kind'], e.get('pipeline')) for e in recorded]}")
    check(card["counts"] == guard_cohort["poisoned_counts"],
          f"recorder-cohort: launches {card['counts']} against the unarmed run's "
          f"{guard_cohort['poisoned_counts']}")
    armed, unarmed = _by_net(card["job"].predictions), guard_cohort["poisoned_preds"]
    # the poisoned tenant answers NaN until its guard's check: NaN for NaN
    check(armed.keys() == unarmed.keys() and all(
        np.array_equal(np.asarray(armed[k]), np.asarray(unarmed[k]), equal_nan=True)
        for k in armed), "recorder-cohort: a prediction differs from the unarmed poisoned run's")
    check(card["journal"] == cpu["journal"], "recorder-cohort: the journals differ card to CPU")

    # (c) phase 40's poison leg, recorded, card and CPU
    x, y = overload_stream(LIFECYCLE_RUN["records"])
    lc = {device: _lifecycle_leg(torch, pa_scan, x, y, "poison", device, events="on")
          for device in ("cuda", "cpu")}
    transitions = [e["cause"] for e in lc["cuda"]["journal"] if e["kind"] == "lifecycle"]
    log(f"recorder-lifecycle: the poison leg with events on: transitions {transitions}, "
        f"pa_scan launches {lc['cuda']['pa_scan_launches']} (unarmed "
        f"{lifecycle_launches['poison']}), {lc['cuda']['records_per_s']:.1f} records/s")
    check(transitions[:2] == ["shadow_armed", "canary_started"]
          and "canary_rolled_back" in transitions,
          f"recorder-lifecycle: transitions {transitions}")
    check(lc["cuda"]["pa_scan_launches"] == lifecycle_launches["poison"],
          f"recorder-lifecycle: pa_scan launches {lc['cuda']['pa_scan_launches']} != unarmed "
          f"{lifecycle_launches['poison']}")
    check(lc["cuda"]["predictions"] == poison_preds,
          "recorder-lifecycle: a prediction or tag differs from the unarmed leg's")
    check([v for _, v in lc["cuda"]["predictions"]] == [v for _, v in lc["cpu"]["predictions"]],
          "recorder-lifecycle: the version tags differ card to CPU")
    check(lc["cuda"]["journal"] == lc["cpu"]["journal"],
          "recorder-lifecycle: the journals differ card to CPU")
    return card["counts"]["pa_scan_batched"], lc["cuda"]["pa_scan_launches"]


# --- phase 47: the Kafka route and the load harness's in-process leg -----------

# the Kafka route's runs: the silence timer that ends each live run; 47b's
# broker chaos (seeded drop, duplicate and reorder on the record stream);
# 47c's restart run over phase 34's records (the stream's first 20,000,
# its unfaulted run the reference), `restart_saves` snapshots and phase
# 34's crash; 47d's window of `profile_steps` events over the first
# `profile_records` training records at `profile_batch` rows a fit (phase
# 5's 256 fill no batch in 1,000 events)
KAFKA_RUN = dict(timeout_ms=2_000, chaos="seed=7,drop=0.02,dup=0.05,reorder=0.05",
                 restart_saves=10, profile_steps=1_000, profile_records=5_000, profile_batch=16,
                 breakdown_records=5_000)  # cut from 10,000 for the time limit
KAFKA_TOPICS = ("requests", "trainingData", "forecastingData")
# the load harness's default storm (benchmarks/load_harness.py:64-98,
# :367-372), cut from 256 tenants to 128 for the script's time limit (its
# three runs took ~58 s at 256, terminate evaluating ~4,192 nets one by
# one), and the composition-identity storm of tests/test_load_harness.py
# cut from 256 tenants to 64 (its pair of runs took 30 s at 256 on the
# card, the deploys and terminate evaluations of 4,096 nets; the CPU tests
# hold it at 256)
STORM = dict(seed=7, tenants=128, records=1_024, chunk_rows=64)
# 47f's perRecord storm, cut to 64 tenants for the script's time limit
STORM_PER_RECORD = dict(STORM, tenants=64)
STORM_IDENTITY = dict(seed=5, tenants=64, records=128, chunk_rows=64, n_features=4,
                      forecast_ratio=0.4)


@contextlib.contextmanager
def _no_residue(torch, label: str):
    """Phase 47's legs leave nothing behind for the phases after them: on
    exit (after a full collection) no thread started inside the block is
    alive and torch.profiler is off. Logs the threads alive and the
    collector's tracked objects."""
    import threading

    before = set(threading.enumerate())
    yield
    gc.collect()
    left = [t.name for t in threading.enumerate() if t not in before and t.is_alive()]
    log(f"{label}: residue: {threading.active_count()} threads alive, "
        f"{len(left)} started in the phase {left}, {len(gc.get_objects())} objects tracked")
    check(not left, f"{label}: threads of the phase still alive: {left}")
    check(not torch.autograd._profiler_enabled(), f"{label}: torch.profiler left on")


@contextlib.contextmanager
def _fskafka(broker: Path):
    """tests/fskafka.py installed as the ``kafka`` module, its broker the
    directory ``broker``; on exit ``sys.modules["kafka"]``, ``sys.path``
    and the environment are as they were."""
    import os

    saved_env = {k: os.environ.get(k) for k in ("FSKAFKA_DIR", "OMLDM_CHAOS_KAFKA")}
    saved_kafka = sys.modules.get("kafka")
    saved_path = list(sys.path)
    tests = str(Path(__file__).resolve().parent / "tests")
    sys.path.insert(0, tests)
    try:
        import fskafka

        broker.mkdir(parents=True, exist_ok=True)
        os.environ["FSKAFKA_DIR"] = str(broker)
        os.environ.pop("OMLDM_CHAOS_KAFKA", None)
        fskafka.install()
        yield fskafka
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("fskafka", None)
        if saved_kafka is None:
            sys.modules.pop("kafka", None)
        else:
            sys.modules["kafka"] = saved_kafka
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _topic_lines(events, inline_forecasts=False):
    """A StreamJob event list as topic contents: {topic: [lines]}; the
    Create names its width (a Query for a pipeline not deployed yet would
    be dropped). ``inline_forecasts`` puts each forecast on trainingData
    at its position, marked "operation": "forecasting", as the CLI's
    training file holds it."""
    out = {t: [] for t in KAFKA_TOPICS}
    for stream, payload in events:
        if stream == "requests":
            req = json.loads(payload)
            if req.get("request") == "Create":
                req["learner"]["dataStructure"] = {"nFeatures": N_FEATURES}
            out["requests"].append(json.dumps(req))
        elif stream == "forecastingData" and inline_forecasts:
            rec = json.loads(payload)
            rec["operation"] = "forecasting"
            out["trainingData"].append(json.dumps(rec))
        else:
            out[stream].append(payload)
    return out


def _publish(broker: Path, topic: str, lines) -> None:
    """A topic log's whole contents at once (written aside, then renamed
    over the empty log): a consumer never reads a half-written line."""
    import os

    tmp = broker / f".{topic}.partial"
    tmp.write_text("".join(line + "\n" for line in lines))
    os.replace(tmp, broker / f"{topic}--0.log")


def _read_topic(broker: Path, topic: str):
    path = broker / f"{topic}--0.log"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def _kafka_cli(torch, argv, broker: Path, feed=None, arm=None):
    """``python -m omldm_tpu_torch --kafkaBrokers fs://local ...`` in-process
    on the card, its sinks the producer's topic logs under ``broker``.
    ``feed(job)`` runs on a thread once the first consumer has connected
    (a live subscriber starts at the log's end); ``arm(job)`` runs on the
    built job before the loop. Returns (job, wall seconds, the connect
    calls' positions, the time the feeder published the data)."""
    import threading

    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.runtime import kafka_io

    for topic in KAFKA_TOPICS:
        (broker / f"{topic}--0.log").write_text("")
    captured, connects, fed = {}, [], {}
    connected = threading.Event()
    real_build, real_connect = cli.build_job, kafka_io.connect_kafka

    def build_job(flags):
        job, sinks = real_build(flags)
        captured["job"] = job
        if arm is not None:
            arm(job)
        return job, sinks

    def connect(*a, **kw):
        connects.append(None if kw.get("position") is None else dict(kw["position"]))
        out = real_connect(*a, **kw)
        connected.set()
        return out

    def feeder():
        if connected.wait(120):
            fed["wall"] = time.time()
            feed(captured["job"])

    thread = threading.Thread(target=feeder, daemon=True) if feed is not None else None
    cli.build_job, kafka_io.connect_kafka = build_job, connect
    try:
        if thread is not None:
            thread.start()
        t0 = time.perf_counter()
        rc = cli.main(["--kafkaBrokers", "fs://local", "--timeout",
                       str(KAFKA_RUN["timeout_ms"])] + [str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli.build_job, kafka_io.connect_kafka = real_build, real_connect
        if thread is not None:
            thread.join(5)
    check(rc == 0, f"kafka: the CLI returned {rc}")
    check(thread is None or not thread.is_alive(), "kafka: the feeder never saw a connect")
    return captured["job"], wall, connects, fed.get("wall")


def _feed_after_create(broker: Path, lines):
    """A feeder: the requests, then -- once the Create deployed -- the data
    topics (a record before any pipeline would wait in the pre-create
    backlog)."""

    def feed(job):
        _publish(broker, "requests", lines["requests"])
        deadline = time.time() + 60
        while not job.pipeline_manager.live_pipelines and time.time() < deadline:
            time.sleep(0.001)
        for topic in ("trainingData", "forecastingData"):
            if lines[topic]:
                _publish(broker, topic, lines[topic])

    return feed


def _forecast_keys(lines):
    """The float32 feature tuples of the forecasts among topic lines."""
    import numpy as np

    keys = []
    for line in lines:
        rec = json.loads(line)
        if "target" not in rec or rec.get("operation") == "forecasting":
            keys.append(tuple(np.float32(rec["numericalFeatures"]).tolist()))
    return keys


def _answered(preds):
    import numpy as np

    return [tuple(np.float32(p["dataInstance"]["numericalFeatures"]).tolist()) for p in preds]


def _drain(job, kio, broker: Path, chaos=None):
    """Assign mode from offset 0 on every topic: consume until the logs run
    dry (two idle polls in a row), then terminate. Returns (report, the
    ChaosConsumer or None)."""
    from omldm_tpu_torch.runtime import supervisor

    captured = {}
    real = supervisor.maybe_chaos_consumer

    def wrap(consumer, **kw):
        captured["consumer"] = out = real(consumer, **kw)
        return out

    supervisor.maybe_chaos_consumer = wrap
    try:
        position = {(t, 0): 0 for t in KAFKA_TOPICS}
        events, sinks = kio.connect_kafka("fs://local", position=position, tracker=dict(position))
    finally:
        supervisor.maybe_chaos_consumer = real
    idle = 0
    for event in events:
        if event is None:
            idle += 1
            if idle >= 2:
                break
            continue
        idle = 0
        job.process_event(*event)
    report = job.terminate()
    sinks.close()
    consumer = captured.get("consumer")
    return report, (consumer if hasattr(consumer, "dropped") else None)


def _kafka_parity(torch, events, broker: Path, chaos: str):
    """47b: the same preloaded logs on the card and on the CPU, at phase 6's
    parallelism; with ``chaos`` set, under OMLDM_CHAOS_KAFKA."""
    import os

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob
    from omldm_tpu_torch.runtime import kafka_io

    lines = _topic_lines(events)
    for topic in KAFKA_TOPICS:
        _publish(broker, topic, lines[topic])
    if chaos:
        os.environ["OMLDM_CHAOS_KAFKA"] = chaos
    out = {}
    try:
        for device in ("cuda", "cpu"):
            job = StreamJob(JobConfig(**dict(SLICE_CONFIG, parallelism=PARITY_PARALLELISM)),
                            device=device)
            t0 = time.perf_counter()
            report, consumer = _drain(job, kafka_io, broker)
            if device == "cuda":
                torch.cuda.synchronize()
            out[device] = (report, job, consumer, time.perf_counter() - t0)
    finally:
        os.environ.pop("OMLDM_CHAOS_KAFKA", None)
    label = "kafka-parity" + ("[chaos]" if chaos else "")
    (card, cjob, ccons, cwall), (cpu, pjob, pcons, pwall) = out["cuda"], out["cpu"]
    [cs], [ps] = card.statistics, cpu.statistics
    check(cs.fitted > 0, f"{label}: nothing fitted")
    check(_int_stats(cs) == _int_stats(ps),
          f"{label}: integer statistics differ: {_stat_diff(cs, ps)}")
    ck = [(tuple(p.data_instance.numerical_features), p.value) for p in cjob.predictions]
    pk = [(tuple(p.data_instance.numerical_features), p.value) for p in pjob.predictions]
    check(len(ck) == len(pk) > 0 and [k for k, _ in ck] == [k for k, _ in pk],
          f"{label}: the forecasts answered differ ({len(ck)} / {len(pk)})")
    mism = sum(a != b for (_, a), (_, b) in zip(ck, pk))
    check(mism <= 0.01 * len(ck), f"{label}: {mism} of {len(ck)} predictions differ")
    counters = None
    if chaos:
        check(ccons is not None and pcons is not None, f"{label}: the chaos consumer never armed")
        counters = {k: getattr(ccons, k) for k in ("dropped", "duplicated", "reordered",
                                                   "poisoned")}
        check(counters == {k: getattr(pcons, k) for k in counters},
              f"{label}: ChaosConsumer counters differ: {counters}")
        check(counters["dropped"] and counters["duplicated"] and counters["reordered"],
              f"{label}: the chaos spec did not misbehave: {counters}")
    row = {"events": len(events) - 1, "parallelism": PARITY_PARALLELISM,
           "fitted": cs.fitted, "predictions": len(ck), "differ": mism,
           "records_per_s": {"cuda": len(events) / cwall, "cpu": len(events) / pwall},
           "chaos": chaos or None, "chaos_counters": counters}
    log(f"{label}: " + json.dumps(row))
    return row


def _kafka_breakdown(torch, broker: Path, lines, route_rate: float, sends_per_record: float,
                     device="cuda"):
    """Where 47a's time a record goes, in the same call, over two windows
    of ``KAFKA_RUN["breakdown_records"]`` records of 47a's topic logs: the
    head, where the broker alternates forecasts and training records, and
    the training-only tail from the middle of ``trainingData``. Each window
    is read by the file-backed consumer alone, then through the port's
    ``polling_events`` with no job; then the route's job (built by the
    CLI from 47a's flags, its outputs sent through ``ProducerSinks`` to
    scratch topics) takes the head's events and the tail's in the order
    the broker delivered them (requests first, as the live feeder
    published them) through the CLI's ``_kafka_loop``. A producer send of
    a predictions line is also timed alone (the route makes
    ``sends_per_record`` of them; the job's leg includes them). The
    windows' costs weighted by the route's own mix estimate its time a
    record beside the measured one."""
    import kafka

    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.runtime import kafka_io

    n = KAFKA_RUN["breakdown_records"]
    n_fore, n_train = len(lines["forecastingData"]), len(lines["trainingData"])
    ends = {t: len(lines[t]) for t in KAFKA_TOPICS}
    windows = {"head": {t: 0 for t in KAFKA_TOPICS},
               "tail": dict(ends, trainingData=n_train // 2)}
    legs, events = {}, {}
    for name, offsets in windows.items():
        position = {(t, 0): o for t, o in offsets.items()}
        consumer = kafka.KafkaConsumer()
        consumer.assign([kafka.TopicPartition(t, p) for t, p in position])
        for (t, p), o in position.items():
            consumer.seek(kafka.TopicPartition(t, p), o)
        t0 = time.perf_counter()
        got = sum(1 for _ in zip(range(n), consumer))
        consume_s = time.perf_counter() - t0
        consumer.close()
        check(got == n, f"kafka-breakdown[{name}]: the consumer gave {got} of {n} records")
        polled, sinks = kafka_io.connect_kafka("fs://local", position=position,
                                               tracker=dict(position))
        got = []
        t0 = time.perf_counter()
        for event in polled:
            if event is None:
                break
            got.append(event)
            if len(got) == n:
                break
        poll_s = time.perf_counter() - t0
        sinks.close()
        check(len(got) == n, f"kafka-breakdown[{name}]: polling_events gave {len(got)} of {n}")
        events[name] = got
        legs[name] = {"consume": consume_s / n * 1e6, "polling_events": poll_s / n * 1e6}

    preds = (broker / "predictions--0.log").read_bytes().splitlines()[:1_000]
    producer = kafka.KafkaProducer()
    t0 = time.perf_counter()
    for line in preds:
        producer.send("breakdownScratch", line)
    send_us = (time.perf_counter() - t0) / len(preds) * 1e6
    (broker / "breakdownScratch--0.log").unlink()

    # the route's own job: built by the CLI from 47a's flags, its outputs
    # sent through ProducerSinks (to scratch topics)
    flags = cli.parse_flags(CLI_ARGS + ["--kafkaBrokers", "fs://local", "--device", device])
    job, file_sinks = cli.build_job(flags)
    scratch = {k: "breakdown" + v[:1].upper() + v[1:]
               for k, v in kafka_io.DEFAULT_OUT_TOPICS.items()}
    sinks = kafka_io.ProducerSinks(kafka.KafkaProducer(), out_topics=scratch)
    cli._apply_kafka_sinks(job, flags, sinks)
    for event in lines["requests"]:
        job.process_event("requests", event)
    for name in windows:
        data = [e for e in events[name] if e[0] != "requests"]
        t0 = time.perf_counter()
        cli._kafka_loop(job, iter(data), {"window": None, "n_events": 0, "steps": 0,
                                          "error": None})
        if device == "cuda":
            torch.cuda.synchronize()
        legs[name]["job"] = (time.perf_counter() - t0) / len(data) * 1e6
        legs[name]["sends"] = send_us * sends_per_record
        legs[name]["sum"] = legs[name]["polling_events"] + legs[name]["job"]
    sinks.close()
    for sink in file_sinks:
        sink.close()
    for topic in scratch.values():
        (broker / f"{topic}--0.log").unlink(missing_ok=True)
    # the head window's mix holds the route's first 2 x n_fore records
    # (forecasts alternating with training records), the tail's the rest
    n_data = n_fore + n_train
    mixed = {k: (2 * n_fore * legs["head"][k] + (n_data - 2 * n_fore) * legs["tail"][k])
             / n_data for k in legs["head"]}
    row = {"records_a_window": n, "us_per_record": legs, "route_mix_us": mixed,
           "send_us": send_us, "sends_per_record": sends_per_record,
           "route_us": 1e6 / route_rate}
    log("kafka-breakdown: " + json.dumps(row))
    return row


def phase_kafka(torch, pa_scan, events, cli_stats, slice_rate, parity_records, tmp: Path,
                restart_fitted=None):
    """Phase 47 (a-c): the Kafka route on the card over tests/fskafka.py's
    file-backed broker. ``restart_fitted`` is phase 34's unfaulted fitted
    over the same records (run here when None); ``slice_rate`` is phase
    5's records/s in memory, printed beside the route's. Returns the
    pa_scan launches of 47a and of 47c's final incarnation."""
    from omldm_tpu_torch.runtime import recovery
    from omldm_tpu_torch.runtime.recovery import FaultInjector

    t_phase = time.perf_counter()
    kr = KAFKA_RUN
    out = {}
    with _fskafka(tmp / "broker_a"):
        # (a) the CLI route, live: phase 5's stream fed after the connect
        broker = tmp / "broker_a"
        lines = _topic_lines(events)
        n_fore = len(lines["forecastingData"])
        n_data = n_fore + len(lines["trainingData"])
        pa_scan.launches = 0
        job, wall, connects, fed = _kafka_cli(torch, CLI_ARGS, broker,
                                              feed=_feed_after_create(broker, lines))
        launches = pa_scan.launches
        stats, fits, serves, evaluations = _cli_counts(job)
        preds = _read_topic(broker, "predictions")
        perf = _read_topic(broker, "performance")
        resp = _read_topic(broker, "responses")
        answered = _answered(preds)
        want = _forecast_keys(lines["forecastingData"])
        rate = n_data / max(job.stats.last_activity - fed, 1e-9)
        row = {"records": n_data, "wall_s": wall, "records_per_s": rate,
               "records_per_s_phase5": slice_rate,
               "records_per_s_phase17": cli_stats["records"] / cli_stats["wall"],
               "fitted": stats.fitted, "fitted_phase17": cli_stats["stats"].fitted,
               "fits": fits, "pa_scan_launches": launches, "predictions": len(preds),
               "forecasts": n_fore, "responses": len(resp), "score": stats.score,
               "serveLatencyP50Ms": stats.serve_latency_p50_ms,
               "serveLatencyP99Ms": stats.serve_latency_p99_ms,
               "connects": len(connects)}
        log("kafka-route: " + json.dumps(row))
        check(len(connects) == 1 and connects[0] is None,
              f"kafka-route: connects {connects}, expected one subscribe")
        check(len(preds) == n_fore and sorted(answered) == sorted(want),
              f"kafka-route: {len(preds)} prediction lines for {n_fore} forecasts "
              f"({len(set(answered))} distinct)")
        check(stats.fitted == cli_stats["stats"].fitted,
              f"kafka-route: fitted {stats.fitted} != phase 17's {cli_stats['stats'].fitted}")
        check(launches == fits > 0, f"kafka-route: pa_scan launches {launches} != fits {fits}")
        check(perf and perf[-1]["statistics"][0]["fitted"] == stats.fitted,
              "kafka-route: the performance topic does not hold the statistics")
        check(stats.score > 0.6, f"kafka-route: holdout accuracy {stats.score}")
        check(len(resp) == 1, f"kafka-route: {len(resp)} responses to the one Query")
        _check_placement(torch, job, "kafka-route")
        out["route"] = launches
        sends = len(preds) + len(perf) + len(resp)
        del job
        _kafka_breakdown(torch, broker, lines, rate, sends / n_data)

    # (b) card against CPU over the same preloaded logs, then under chaos
    head = events[: parity_records + 1]
    for chaos in ("", kr["chaos"]):
        broker = tmp / ("broker_b_chaos" if chaos else "broker_b")
        with _fskafka(broker):
            _kafka_parity(torch, head, broker, chaos)

    # (c) supervised restart: phase 34's records, forecasts inline on
    # trainingData (one data partition: the replay after the seek is the
    # original order), checkpoints, phase 34's crash
    rr = RECOVERY_RUN
    head = events[: rr["records"] + 1]
    if restart_fitted is None:
        ref = _slice_job("cuda")
        [ref_stats] = ref.run(head).statistics
        restart_fitted = ref_stats.fitted
    lines = _topic_lines(head, inline_forecasts=True)
    want = _forecast_keys(lines["trainingData"])
    interval_ms = max(1, int(len(head) / rate * 1000 / kr["restart_saves"]))
    restored = {}
    real_recover = recovery.recover_job

    def recover_job(failed, floor=None):
        new_job, path = real_recover(failed, floor)
        restored.update(path=path, position=dict(new_job.source_position or {}))
        pa_scan.launches = 0  # the final incarnation counts from here
        return new_job, path

    def arm(job):
        FaultInjector().arm(job, worker_id=rr["worker"],
                            after_records=rr["crash_at"] // job.config.parallelism)

    with _fskafka(tmp / "broker_c1"):
        broker = tmp / "broker_c1"
        recovery.recover_job = recover_job
        try:
            job, wall, connects, _ = _kafka_cli(
                torch, CLI_ARGS + ["--checkpointing", "true", "--stateBackend", tmp / "ckpt_c",
                                   "--checkInterval", interval_ms, "--restartAttempts", "2"],
                broker, feed=_feed_after_create(broker, lines), arm=arm)
        finally:
            recovery.recover_job = real_recover
        final_launches = pa_scan.launches
        preds = _read_topic(broker, "predictions")
        [perf_stats] = _read_topic(broker, "performance")[-1]["statistics"]
    answered = _answered(preds)
    row = {"records": len(head) - 1, "check_interval_ms": interval_ms,
           "restored_from": Path(restored.get("path") or "").name,
           "seek": {f"{t}:{p}": o for (t, p), o in sorted((connects[-1] or {}).items())},
           "fitted": perf_stats["fitted"], "fitted_unfaulted": restart_fitted,
           "predictions": len(preds), "forecasts": len(want),
           "answered_twice": len(answered) - len(set(answered)),
           "pa_scan_launches_final_incarnation": final_launches,
           "wall_s": wall, "records_per_s_crash_and_restart": len(head) / wall}
    log("kafka-restart: " + json.dumps(row))
    check(len(connects) == 2 and connects[0] is None and restored.get("path"),
          f"kafka-restart: connects {connects}, restored {restored}: expected one restore")
    check(connects[1] == restored["position"] and connects[1].get(("trainingData", 0), 0) > 0,
          f"kafka-restart: the reconnect sought {connects[1]}, the snapshot holds "
          f"{restored['position']}")
    check(perf_stats["fitted"] == restart_fitted,
          f"kafka-restart: fitted {perf_stats['fitted']} != the unfaulted {restart_fitted}")
    check(set(answered) == set(want), f"kafka-restart: {len(set(answered))} of {len(want)} "
          "forecasts answered")
    check(final_launches > 0, "kafka-restart: the final incarnation launched no pa_scan")
    out["restart"] = final_launches

    log(f"kafka: phase 47a-c took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_kafka_profile(torch, pa_scan, events, tmp: Path):
    """Phase 47d: the ``--profileSteps`` window on the Kafka route. Runs
    before phases 41-42 (its trace needs torch.profiler's device records).
    Returns the pa_scan launches in the window."""
    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.utils.tracing import trace_path

    kr = KAFKA_RUN
    cut, n_train = [], 0
    for stream, payload in events:
        if stream == "trainingData":
            if n_train == kr["profile_records"]:
                break
            n_train += 1
        cut.append((stream, payload))
    lines = _topic_lines(cut)
    window = {"stops": 0}
    real_start, real_stop = cli.ProfileWindow.start, cli.ProfileWindow.stop

    def start(self):
        window.update(t0=time.perf_counter())
        return real_start(self)

    def stop(self, write=True):
        if self.active:
            torch.cuda.synchronize()
            window["stops"] += 1
            window.update(t1=time.perf_counter(), launches=pa_scan.launches)
        return real_stop(self, write)

    prof_dir = tmp / "profile"
    with _fskafka(tmp / "broker_d"):
        broker = tmp / "broker_d"
        cli.ProfileWindow.start, cli.ProfileWindow.stop = start, stop
        pa_scan.launches = 0
        try:
            argv = ["--parallelism", SLICE_CONFIG["parallelism"], "--batchSize",
                    kr["profile_batch"], "--profileSteps", kr["profile_steps"],
                    "--profileDir", prof_dir]
            job, wall, _, _ = _kafka_cli(torch, argv, broker,
                                         feed=_feed_after_create(broker, lines))
        finally:
            cli.ProfileWindow.start, cli.ProfileWindow.stop = real_start, real_stop
        total_launches = pa_scan.launches
    trace = Path(trace_path(str(prof_dir)))
    named = _trace_kernel_counts(trace, PA_SCAN_KERNELS)
    doc = json.loads(trace.read_text())
    busy_us = sum(e.get("dur", 0) for e in doc.get("traceEvents", [])
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    span_s = window["t1"] - window["t0"]
    row = {"profile_steps": kr["profile_steps"], "batch": kr["profile_batch"],
           "stops": window["stops"], "window_s": span_s,
           "pa_scan_launches_in_window": window["launches"],
           "pa_scan_launches_run": total_launches, "trace_kernels": named,
           "trace_bytes": trace.stat().st_size, "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / span_s}
    log("kafka-profile: " + json.dumps(row))
    check(window["stops"] == 1, f"kafka-profile: the trace stopped {window['stops']} times")
    check(0 < window["launches"] < total_launches,
          f"kafka-profile: pa_scan launches {window['launches']} in the window, "
          f"{total_launches} in the run")
    check(all(n == window["launches"] for n in named.values()),
          f"kafka-profile: the trace's kernels {named} != the window's "
          f"{window['launches']} pa_scan launches")
    return window["launches"]


def _storm_run(torch, storm, budgets, device, **kw):
    """run_inprocess_storm on ``device``, its SLO report checked. Returns
    (report, job, wall seconds, events/s, the seconds of its terminate)."""
    from omldm_tpu_torch.load_harness import run_inprocess_storm
    from omldm_tpu_torch.runtime.job import StreamJob

    real = StreamJob.terminate
    spent = []

    def terminate(job):
        t = time.perf_counter()
        try:
            return real(job)
        finally:
            spent.append(time.perf_counter() - t)

    StreamJob.terminate = terminate
    try:
        t0 = time.perf_counter()
        report, job = run_inprocess_storm(storm, budgets, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        StreamJob.terminate = real
    check(report.passed, f"storm[{device}]: SLO breaches "
          f"{[c.to_dict() for c in report.failing()]}")
    n = storm.spec.tenants + sum(1 for _ in storm.events())
    return report, job, wall, n / wall, sum(spent)


def phase_storm(torch, pa_scan):
    """Phase 47 (e-f): the load harness's in-process leg on the card.
    Returns the batched pa_scan launches of the perRecord storm."""
    from omldm_tpu_torch.load_harness import default_storm_spec, run_composition_identity
    from omldm_tpu_torch.runtime.loadgen import LoadStorm, StormSpec
    from omldm_tpu_torch.runtime.slo import SLOBudgets

    t_phase = time.perf_counter()
    storm = LoadStorm(default_storm_spec(**STORM))
    # JAX TestInprocessLeg's budgets: the hot tenants may shed, no row
    # stranded
    budgets = SLOBudgets(allow_shed_tenants=storm.hot_tenant_ids(), max_stranded_rows=0)
    card, job, card_wall, card_rate, card_term = _storm_run(torch, storm, budgets, "cuda")
    shed = {s.pipeline: s.forecasts_shed for s in job.performance[-1].statistics
            if s.forecasts_shed}
    n_preds, n_nets = len(job.predictions), sum(len(s.nets) for s in job.spokes)
    phase_table = job.phase_table(card_wall)
    del job  # its 4,192 nets are not kept through the runs below
    again, _, again_wall, again_rate, _ = _storm_run(torch, storm, budgets, "cuda")
    cpu, _, cpu_wall, cpu_rate, cpu_term = _storm_run(torch, storm, budgets, "cpu")
    identity = LoadStorm(StormSpec(**STORM_IDENTITY))
    t0 = time.perf_counter()
    bare, composed = run_composition_identity(identity, device="cuda")
    torch.cuda.synchronize()
    identity_wall = time.perf_counter() - t0
    row = {"tenants": STORM["tenants"], "records": STORM["records"],
           "fingerprint": storm.fingerprint()[:16], "core_digest": card.core_digest()[:16],
           "checks": {c.name: c.ok for c in card.checks}, "predictions": n_preds,
           "shed": shed, "records_per_s": {"cuda": card_rate, "cuda_again": again_rate,
                                           "cpu": cpu_rate},
           "wall_s": {"cuda": card_wall, "cuda_again": again_wall, "cpu": cpu_wall,
                      "identity_pair": identity_wall},
           "terminate_s": {"cuda": card_term, "cpu": cpu_term},
           "nets": n_nets, "phase_table": phase_table}
    log("storm: " + json.dumps(row))
    check(card.core_digest() == again.core_digest(),
          "storm: a second run on the card gave another report core")
    check(card.core_digest() == cpu.core_digest(),
          "storm: the card's report core differs from the CPU's")
    check(bare == composed and len(bare) == STORM_IDENTITY["tenants"],
          "storm: the unarmed plane matrix is not bit-transparent on the card")

    # (f) the perRecord storm: one batched pa_scan launch a gang step
    per_record = LoadStorm(default_storm_spec(**STORM_PER_RECORD,
                                              training_extra={"perRecord": True}))
    budgets = SLOBudgets(allow_shed_tenants=per_record.hot_tenant_ids(), max_stranded_rows=0)
    _mt_reset(pa_scan)
    report, job, wall, rate, _ = _storm_run(torch, per_record, budgets, "cuda")
    counts = _mt_counts(pa_scan)
    cohorts = [c for s in job.spokes if s.cohorts is not None for c in s.cohorts.cohorts.values()]
    row = {"records_per_s": rate, "wall_s": wall, **counts,
           "cohorts": len(cohorts), "members": sum(c.n_active for c in cohorts),
           "checks": {c.name: c.ok for c in report.checks}}
    log("storm-per-record: " + json.dumps(row))
    log(f"storm-per-record: {counts['pa_scan']} solo pa_scan launches (members never ganged "
        f"or evicted), {counts['pa_scan_batched']} batched for {counts['gang_steps']} gang steps")
    check(counts["pa_scan_batched"] == counts["gang_steps"] > 0,
          f"storm-per-record: batched launches {counts['pa_scan_batched']} != gang steps "
          f"{counts['gang_steps']}")
    log(f"storm: phase 47e-f took {time.perf_counter() - t_phase:.1f} s")
    return counts["pa_scan_batched"], counts["pa_scan"]


# --- phase 48: the multi-process fleet's file route ---------------------------

FLEET_RECORDS, FLEET_SPARSE_RECORDS = 100_000, 20_000
FLEET_ARGS = ["--batchSize", str(SLICE_CONFIG["batch_size"]), "--testSetSize", "64"]
# each process of a fleet runs this bootstrap: run_distributed, then its own
# launch counters, fleet steps, group calls and host seconds by part on one
# "fleet-process:" line. The parts nest: "step" (SPMDTrainer.step after the
# first) and "step_first" (the first, which imports what torch.library's
# custom op pulls in on first use) inside "pump", "group" (every fabric
# call) inside the others; "parse" is the packed batcher's or the COO
# block's parse and staging, "join" the process group's join with the mesh
# and the card's context. "calls" counts the calls of each part ("step":
# this process's fleet steps, the restored ones not included). Each
# snapshot saved and each restore prints its own line at once
# ("fleet-save:", "fleet-restore:"), so a process an injected fault ends
# leaves them too
FLEET_BOOT = """
import json, os, sys, time
import omldm_tpu_torch.runtime.distributed_job as dj
import omldm_tpu_torch.runtime.fast_ingest as fast_ingest
from omldm_tpu_torch.ops import pa_scan, sparse
from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.parallel.spmd import SPMDTrainer
spent = {}
calls = {}
jobs = []
def timed(owner, name, key):
    real = getattr(owner, name)
    def wrapper(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            part = key + "_first" if key == "step" and "step_first" not in spent else key
            spent[part] = spent.get(part, 0.0) + time.perf_counter() - t
            calls[key] = calls.get(key, 0) + 1
    setattr(owner, name, wrapper)
def logged(name, tag):
    real = getattr(dj.DistributedStreamJob, name)
    def wrapper(self, *a, **k):
        t = time.perf_counter()
        out = real(self, *a, **k)
        row = {"pid": self.pid, "s": time.perf_counter() - t}
        if isinstance(out, str) and os.path.isdir(out):
            row["snapshot"] = os.path.basename(out)
            row["bytes"] = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        else:
            row["cursor"] = out
        print(tag + " " + json.dumps(row), flush=True)
        return out
    setattr(dj.DistributedStreamJob, name, wrapper)
logged("save_checkpoint", "fleet-save:")
logged("restore_checkpoint", "fleet-restore:")
for owner, name, key in ((dj.DistributedStreamJob, "__init__", "join"),
                         (dj.DistributedStreamJob, "sync_requests", "control"),
                         (dj.DistributedStreamJob, "_pump_pipeline", "pump"),
                         (dj.DistributedStreamJob, "_pump_forecasts", "serve"),
                         (dj.DistributedStreamJob, "merged_report", "report"),
                         (dj, "_consume_sparse_block", "parse"),
                         (SPMDTrainer, "step", "step"),
                         (multihost, "on_backend_device", "group")):
    timed(owner, name, key)
init = dj.DistributedStreamJob.__init__
def caught(self, *a, **k):
    init(self, *a, **k)
    jobs.append(self)
dj.DistributedStreamJob.__init__ = caught
batches = fast_ingest.iter_file_batches
def parsed(*a, **k):
    it = batches(*a, **k)
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            spent["parse"] = spent.get("parse", 0.0) + time.perf_counter() - t
        yield item
fast_ingest.iter_file_batches = parsed
profile = os.environ.get("CHIP_SMOKE_FLEET_PROFILE")
if profile:
    import cProfile
    prof = cProfile.Profile()
    prof.enable()
t0 = time.perf_counter()
rc = dj.run_distributed(sys.argv[1:])
wall = time.perf_counter() - t0
job = jobs[0]
if profile:
    prof.disable()
    prof.dump_stats(f"{profile}.p{job.pid}")
print("fleet-process: " + json.dumps({
    "pid": job.pid, "processes": job.nproc, "device": str(job.device), "wall_s": wall,
    "steps": sum(p.steps_run for p in job.pipelines.values()), "calls": calls,
    "rescales": job.rescales_performed,
    "pa_scan": pa_scan.launches, "pa_scan_batched": pa_scan.batched_launches,
    "scatter_add": sparse.launches["scatter_add"], "group_calls": multihost.group_calls,
    "host_s": spent,
}))
sys.exit(rc)
"""


def _fleet_launch(label: str, tag: str, nproc: int, device: str, train: Path, reqs: Path,
                  tmp: Path, extra=(), expect: int = 0, stopped: int | None = None,
                  env: dict | None = None):
    """``nproc`` processes of the fleet's file route (the CLI's flags and
    ``extra``, one FLEET_BOOT bootstrap each, a free localhost port), each
    expected to exit ``expect``; process ``stopped`` is expected to freeze:
    it must still be alive when the others have exited, and is SIGKILLed.
    Returns a dict: the exit codes, the report, the predictions, the
    fleet-process rows, the saves and restores (the bootstrap's
    "fleet-save:" and "fleet-restore:" lines), stderr and the launch's wall
    seconds."""
    import signal
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    perf, pred = (tmp / f"{tag}_{k}.jsonl" for k in ("perf", "pred"))
    flags = FLEET_ARGS + ["--device", device, "--trainingData", str(train), "--requests",
                          str(reqs), "--performanceOut", str(perf), "--predictionsOut",
                          str(pred), "--processes", str(nproc), *map(str, extra)]
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", FLEET_BOOT, *flags, "--processId", str(pid),
         *(["--coordinator", f"127.0.0.1:{port}"] if nproc > 1 else [])],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, **(env or {})))
        for pid in range(nproc)]
    outs = {}
    alive = None
    try:
        for pid, p in enumerate(procs):
            if pid != stopped:
                outs[pid] = p.communicate(timeout=FLEET_TIMEOUT_S)
        if stopped is not None:
            alive = procs[stopped].poll() is None
            os.kill(procs[stopped].pid, signal.SIGKILL)
            outs[stopped] = procs[stopped].communicate(timeout=60)
    finally:
        for p in procs:  # a failed or stuck member must not hold the group
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    err = "\n".join(outs[i][1] for i in sorted(outs))
    rcs = [p.returncode for p in procs]
    for pid, rc in enumerate(rcs):
        if pid != stopped:
            check(rc == expect, f"{label}[{tag}]: process {pid} exited {rc}, not {expect}:\n"
                  f"{err[-3000:]}")
    if stopped is not None:
        check(alive, f"{label}[{tag}]: process {stopped} exited {rcs[stopped]} instead of "
              "freezing")

    def lines(prefix):
        return sorted((json.loads(line.split(" ", 1)[1]) for out, _ in outs.values()
                       for line in out.splitlines() if line.startswith(prefix + " ")),
                      key=lambda r: r["pid"])

    rows = lines("fleet-process:")
    if expect == 0:
        check(len(rows) == nproc, f"{label}[{tag}]: {len(rows)} process lines for {nproc}")
    paths = [pred] if nproc == 1 else [Path(f"{pred}.p{i}") for i in range(nproc)]
    return {"rcs": rcs, "report": json.loads(perf.read_text()) if perf.exists() else None,
            "preds": [json.loads(line) for path in paths if path.exists()
                      for line in path.read_text().splitlines()],
            "rows": rows, "saves": lines("fleet-save:"), "restores": lines("fleet-restore:"),
            "err": err, "wall": wall}


def _fleet_run(tag: str, nproc: int, device: str, train: Path, reqs: Path, final: Path,
               tmp: Path, profile: Path | None = None):
    """``nproc`` processes of the fleet's file route with a final Query
    (:func:`_fleet_launch`); (report, predictions, query responses,
    per-process rows, wall seconds of the launch, backends). With
    ``profile``, each process runs under cProfile into
    ``profile.p<pid>``."""
    resp = tmp / f"{tag}_resp.jsonl"
    run = _fleet_launch("fleet", tag, nproc, device, train, reqs, tmp,
                        ["--requestsFinal", final, "--responsesOut", resp],
                        env={"CHIP_SMOKE_FLEET_PROFILE": str(profile)} if profile else None)
    backends = {line.rsplit(" over ", 1)[1] for line in run["err"].splitlines()
                if line.startswith("[multihost p") and " over " in line}
    responses = [json.loads(line) for line in resp.read_text().splitlines()]
    return (run["report"], run["preds"], responses, run["rows"], run["wall"],
            sorted(backends))


FLEET_TIMEOUT_S = 240
FLEET_INT_STATS = ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "bytesOnWire")


def _fleet_same(label: str, a, b) -> float:
    """Card run ``a`` against CPU run ``b``: every integer statistic, the
    holdout sizes and the Query's dataFitted equal; returns the share of
    predictions equal."""
    (ra, pa, qa, *_), (rb, pb, qb, *_) = a, b
    for sa, sb in zip(ra["statistics"], rb["statistics"]):
        for key in FLEET_INT_STATS:
            check(sa[key] == sb[key], f"{label}: {key} {sa[key]} on the card, {sb[key]} on "
                  "the CPU")
    check(ra["holdout"] == rb["holdout"], f"{label}: holdout {ra['holdout']} != {rb['holdout']}")
    check([q["dataFitted"] for q in qa] == [q["dataFitted"] for q in qb],
          f"{label}: the Query's dataFitted differs")
    check(len(pa) == len(pb), f"{label}: {len(pa)} predictions on the card, {len(pb)} on the CPU")
    return sum(x["value"] == y["value"] for x, y in zip(pa, pb)) / max(len(pa), 1)


def _fleet_checks(label: str, run, training: int, n_fore: int, kernel: str):
    """One run's own checks: rows conserved, every forecast answered, the
    Query answered once, accuracy above chance, and on the card ``kernel``
    launched once a fleet step on every process (none on the CPU)."""
    report, preds, responses, rows, _, _ = run
    [s] = report["statistics"]
    check(s["fitted"] + report["holdout"]["0"] == training,
          f"{label}: fitted {s['fitted']} + holdout {report['holdout']['0']} != {training}")
    check(len(preds) == n_fore, f"{label}: {len(preds)} predictions for {n_fore} forecasts")
    check(len(responses) == 1 and responses[0]["dataFitted"] == s["fitted"],
          f"{label}: the final Query was not answered once with the fleet's fitted")
    check(s["score"] > 0.6, f"{label}: holdout accuracy {s['score']} is not above chance")
    for r in rows:
        want = r["steps"] if r["device"].startswith("cuda") else 0
        check(r["steps"] > 0 and r[kernel] == want,
              f"{label}: process {r['pid']} launched {kernel} {r[kernel]} times in "
              f"{r['steps']} fleet steps on {r['device']}")
    return s


def phase_fleet(torch, sparse, seed: int, card: str, tmp: Path, profile_dir: Path | None = None):
    """Phase 48: the fleet's file route in processes of its own. (a) the
    slice-1 Create on FLEET_RECORDS HIGGS-shaped records, a forecast every
    9, at 2 processes sharing the card, 1 process on the card, 2 processes
    on the CPU; (b) the slice-3 sparse Create on FLEET_SPARSE_RECORDS
    Criteo-shaped records at 2 processes, on the card and on the CPU.
    With ``profile_dir``, (a)'s one-process card run again under cProfile
    (host seconds by function into profile_dir/fleet-card1.txt). Returns
    each card process's pa_scan and scatter_add launches."""
    from omldm_tpu_torch.ops.native import fast_parser_available, loader

    t_phase = time.perf_counter()
    # the native parser is built here, not by the first fleet processes
    # (two building it at once would time g++ as their parse)
    check(fast_parser_available(), f"fleet: the native parser did not build:\n"
          f"{loader.build_error}")
    events = make_events(FLEET_RECORDS, seed, query_at=None)
    create = json.loads(events[0][1])
    create["learner"]["dataStructure"] = {"nFeatures": N_FEATURES}
    train, reqs = write_stream_files([("requests", json.dumps(create))] + events[1:], tmp,
                                     "fleet")
    final = tmp / "fleet_final.jsonl"
    final.write_text(json.dumps({"id": 0, "request": "Query", "requestId": 1}) + "\n")
    n_fore = sum(1 for st, _ in events if st == "forecastingData")
    sparse_events = criteo_events(FLEET_SPARSE_RECORDS, seed, query_at=None,
                                  scatter_impl=stream_scatter_impl(sparse))
    strain, sreqs = write_stream_files(sparse_events, tmp, "fleet_sparse")
    s_fore = sum(1 for st, _ in sparse_events if st == "forecastingData")
    s_training = FLEET_SPARSE_RECORDS - s_fore

    two = _fleet_run("card2", 2, "cuda", train, reqs, final, tmp)
    one = _fleet_run("card1", 1, "cuda", train, reqs, final, tmp)
    # the CPU runs and the sparse fleet are not timed against each other:
    # they run side by side, apart from (a)'s timed card runs
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        cpu_f = pool.submit(_fleet_run, "cpu2", 2, "cpu", train, reqs, final, tmp)
        sparse_f = pool.submit(_fleet_run, "sparse_card2", 2, "cuda", strain, sreqs, final, tmp)
        sparse_cpu_f = pool.submit(_fleet_run, "sparse_cpu2", 2, "cpu", strain, sreqs, final,
                                   tmp)
        cpu, sparse_card, sparse_cpu = cpu_f.result(), sparse_f.result(), sparse_cpu_f.result()
    stats = {}
    for label, run in (("card2", two), ("card1", one), ("cpu2", cpu)):
        stats[label] = _fleet_checks(f"fleet[{label}]", run, FLEET_RECORDS, n_fore, "pa_scan")
    for label, run in (("sparse_card2", sparse_card), ("sparse_cpu2", sparse_cpu)):
        stats[label] = _fleet_checks(f"fleet[{label}]", run, s_training, s_fore, "scatter_add")
    equal = _fleet_same("fleet[card2 vs cpu2]", two, cpu)
    check(equal >= 0.99, f"fleet: {equal:.4f} of the predictions equal card against CPU")
    sparse_equal = _fleet_same("fleet[sparse card2 vs cpu2]", sparse_card, sparse_cpu)
    check(two[5] == ["gloo"] and sparse_card[5] == ["gloo"],
          f"fleet: two processes on one card joined over {two[5]}, not gloo")
    records = FLEET_RECORDS + n_fore
    for label, run in (("card2", two), ("card1", one), ("cpu2", cpu),
                       ("sparse_card2", sparse_card), ("sparse_cpu2", sparse_cpu)):
        report, _, _, rows, wall, backends = run
        n = records if not label.startswith("sparse") else FLEET_SPARSE_RECORDS
        slowest = max(r["wall_s"] for r in rows)
        log(f"fleet[{label}]: " + json.dumps({
            "card": card, "records": n, "records_per_s": n / slowest,
            "launch_wall_s": wall, "process_wall_s": [r["wall_s"] for r in rows],
            "steps": [r["steps"] for r in rows], "pa_scan": [r["pa_scan"] for r in rows],
            "scatter_add": [r["scatter_add"] for r in rows],
            "group_calls": [r["group_calls"] for r in rows],
            "group_calls_per_step": [r["group_calls"] / r["steps"] for r in rows],
            "host_s": [r["host_s"] for r in rows],
            "backend": backends, "score": stats[label]["score"],
            **{k: stats[label][k] for k in FLEET_INT_STATS}, "holdout": report["holdout"],
        }))
    log(f"fleet: card = CPU in every integer statistic; predictions equal {equal:.4f} "
        f"(dense), {sparse_equal:.4f} (sparse); 2 processes at "
        f"{records / max(r['wall_s'] for r in two[3]):.0f} records/s, 1 process at "
        f"{records / max(r['wall_s'] for r in one[3]):.0f}")
    log(f"fleet: phase 48 took {time.perf_counter() - t_phase:.1f} s")
    if profile_dir is not None:
        import pstats

        profile_dir.mkdir(parents=True, exist_ok=True)
        stats_path = tmp / "fleet_card1.prof"
        _fleet_run("card1_profiled", 1, "cuda", train, reqs, final, tmp, profile=stats_path)
        out = profile_dir / "fleet-card1.txt"
        with open(out, "w") as f:
            stats = pstats.Stats(f"{stats_path}.p0", stream=f)
            stats.sort_stats("tottime").print_stats(40)
            stats.sort_stats("cumulative").print_stats(40)
        log(f"fleet: the one-process card run under cProfile: {out}")
    return ({f"fleet_2p_card_p{r['pid']}": r["pa_scan"] for r in two[3]}
            | {"fleet_1p_card": one[3][0]["pa_scan"]},
            {f"fleet_sparse_2p_card_p{r['pid']}": r["scatter_add"] for r in sparse_card[3]})


# --- phase 49: the fleet's recovery half --------------------------------------

RECOVERY_RECORDS, RECOVERY_CHUNK = 20_000, 1024
RECOVERY_FAULT = ["--checkpointEvery", "4", "--failAfterChunks", "9"]


def _recovery_same(label: str, run, ref, holdout=True):
    """``run`` against ``ref``: every integer statistic (and the holdout)
    equal."""
    sa, sb = run["report"]["statistics"][0], ref["report"]["statistics"][0]
    for key in FLEET_INT_STATS:
        check(sa[key] == sb[key], f"{label}: {key} {sa[key]} against {sb[key]}")
    if holdout:
        check(run["report"]["holdout"] == ref["report"]["holdout"],
              f"{label}: holdout {run['report']['holdout']} against {ref['report']['holdout']}")


def _recovery_launches(label: str, run, kernel: str) -> list:
    """Each card process of ``run`` launched ``kernel`` once a fleet step it
    took (``calls["step"]``: the restored steps are not this process's);
    returns the launches."""
    for r in run["rows"]:
        steps = r["calls"].get("step", 0)
        check(steps > 0 and r[kernel] == steps,
              f"{label}: process {r['pid']} launched {kernel} {r[kernel]} times in {steps} "
              "fleet steps")
    return [r[kernel] for r in run["rows"]]


def phase_fleet_recovery(torch, sparse, seed: int, card: str, tmp: Path):
    """Phase 49: the fleet's recovery half on the card, 2 processes sharing
    it over gloo, the slice-1 Create (28 features, PA-I perRecord) on
    RECOVERY_RECORDS records in chunks of RECOVERY_CHUNK rows: (a) clean,
    faulted and restored; (b) the snapshot restored at 1 process; (c) a
    truncated shard's fallback, journalled; (d) a frozen process and the
    survivor's HANG_EXIT; (e) the snapshot restored on the CPU; (f) the
    sparse fleet faulted and restored. Returns the restored card
    processes' pa_scan and scatter_add launches."""
    t_phase = time.perf_counter()
    events = make_events(RECOVERY_RECORDS, seed + 1, query_at=None)
    create = json.loads(events[0][1])
    create["learner"]["dataStructure"] = {"nFeatures": N_FEATURES}
    train, reqs = write_stream_files([("requests", json.dumps(create))] + events[1:], tmp,
                                     "recovery")
    n_fore = sum(1 for st, _ in events if st == "forecastingData")
    sparse_events = criteo_events(RECOVERY_RECORDS, seed + 1, query_at=None,
                                  scatter_impl=stream_scatter_impl(sparse))
    strain, sreqs = write_stream_files(sparse_events, tmp, "recovery_sparse")
    s_fore = sum(1 for st, _ in sparse_events if st == "forecastingData")
    ck, sck, cck = tmp / "ck", tmp / "sparse_ck", tmp / "corrupt_ck"
    bb = tmp / "corrupt_bb"

    first = {
        "clean": (2, "cuda", (train, reqs), []),
        "faulted": (2, "cuda", (train, reqs), ["--checkpointDir", ck, *RECOVERY_FAULT], 3),
        "sparse_clean": (2, "cuda", (strain, sreqs), []),
        "sparse_faulted": (2, "cuda", (strain, sreqs),
                           ["--checkpointDir", sck, *RECOVERY_FAULT], 3),
        "corrupt_faulted": (2, "cuda", (train, reqs), [
            "--checkpointDir", cck, *RECOVERY_FAULT, "--corruptShardProcess", 1,
            "--corruptShardSeq", 1, "--corruptShardMode", "truncate"], 3),
    }

    def launch(tag, spec):
        nproc, device, (tr, rq), extra, *rest = spec
        return _fleet_launch("recovery", tag, nproc, device, tr, rq, tmp,
                             ["--chunkRows", RECOVERY_CHUNK, *extra], *rest)

    # every launch of a wave at once: a fleet process's start-up (imports,
    # the card's context) is most of its launch, and runs beside the others
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(first)) as pool:
        runs = dict(zip(first, pool.map(launch, first, first.values())))
    import shutil

    for name in ("rescaled", "cpu"):
        shutil.copytree(ck, tmp / f"ck_{name}")
    second = {
        "resumed": (2, "cuda", (train, reqs), ["--checkpointDir", ck, "--restore", "true"]),
        "rescaled": (1, "cuda", (train, reqs), [
            "--checkpointDir", tmp / "ck_rescaled", "--restore", "true"]),
        "cpu": (2, "cpu", (train, reqs), ["--checkpointDir", tmp / "ck_cpu", "--restore",
                                          "true"]),
        "sparse_resumed": (2, "cuda", (strain, sreqs), [
            "--checkpointDir", sck, "--restore", "true"]),
        "fallback": (2, "cuda", (train, reqs), [
            "--checkpointDir", cck, "--restore", "true", "--flightRecorder", "on",
            "--blackboxPath", bb]),
        "hang": (2, "cuda", (train, reqs), [
            "--hangProcess", 1, "--hangAfterChunks", 3, "--collectiveTimeoutMs", 5000,
            "--flightRecorder", "on", "--blackboxPath", tmp / "hang_bb"], 19, 1),
    }
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(second)) as pool:
        runs.update(zip(second, pool.map(launch, second, second.values())))

    training = RECOVERY_RECORDS
    clean, resumed = runs["clean"], runs["resumed"]
    # (a) the resumed run ends as the clean one; each of its processes took
    # the clean run's steps (restored + its own) and launched pa_scan once
    # for each of its own
    check(len(runs["faulted"]["saves"]) == 4 and runs["faulted"]["rcs"] == [3, 3],
          f"recovery[faulted]: {len(runs['faulted']['saves'])} saves, exits "
          f"{runs['faulted']['rcs']}")
    check("restored; resuming at row 8192" in resumed["err"],
          "recovery[resumed]: not resumed at the second snapshot's row 8192")
    _recovery_same("recovery[resumed vs clean]", resumed, clean)
    check(len(resumed["preds"]) == len(clean["preds"]) == n_fore,
          f"recovery[resumed]: {len(resumed['preds'])} predictions, clean "
          f"{len(clean['preds'])}, {n_fore} forecasts")
    check([r["steps"] for r in resumed["rows"]] == [r["steps"] for r in clean["rows"]],
          "recovery[resumed]: the fleet's steps differ from the clean run's")
    launches = {"resumed": _recovery_launches("recovery[resumed]", resumed, "pa_scan")}
    # (b) 2 -> 1 on the card
    rescaled = runs["rescaled"]
    s = rescaled["report"]["statistics"][0]
    check(s["fitted"] + rescaled["report"]["holdout"]["0"] == training
          and rescaled["report"]["rescalesPerformed"] == 1
          and len(rescaled["preds"]) == n_fore,
          f"recovery[rescaled]: fitted {s['fitted']} + holdout "
          f"{rescaled['report']['holdout']['0']} != {training}, or no rescale counted")
    launches["rescaled"] = _recovery_launches("recovery[rescaled]", rescaled, "pa_scan")
    # (c) the truncated shard of ckpt-1: the fleet falls back to ckpt-0
    fallback = runs["fallback"]
    check("falling back from ckpt-1 to ckpt-0" in fallback["err"]
          and "restored; resuming at row 4096" in fallback["err"],
          "recovery[fallback]: no fallback to ckpt-0")
    _recovery_same("recovery[fallback vs clean]", fallback, clean)
    journal = [json.loads(line) for path in sorted(bb.glob("blackbox-proc*.jsonl"))
               for line in path.read_text().splitlines()]
    rejected = [e for e in journal if e["kind"] == "restore"
                and e["cause"] == "candidate_rejected"]
    check([e["pid"] for e in rejected] == [1],
          f"recovery[fallback]: candidate_rejected recorded by {[e['pid'] for e in rejected]}")
    launches["fallback"] = _recovery_launches("recovery[fallback]", fallback, "pa_scan")
    # (d) process 0 exits HANG_EXIT, its black box names the hang
    hang = runs["hang"]
    hang_events = [json.loads(line) for line in
                   (tmp / "hang_bb" / "blackbox-proc0.jsonl").read_text().splitlines()]
    check(any(e["kind"] == "hang" and e["cause"] == "collective_timeout"
              for e in hang_events), "recovery[hang]: no hang event in process 0's black box")
    # (e) the card's snapshot restored on the CPU: card = CPU
    _recovery_same("recovery[resumed card vs cpu]", resumed, runs["cpu"])
    equal = sum(a["value"] == b["value"] for a, b in zip(resumed["preds"], runs["cpu"]["preds"]))
    # (f) the sparse fleet
    sp = runs["sparse_resumed"]
    check("restored; resuming at {'bytes': " in sp["err"],
          "recovery[sparse]: not resumed at a byte cursor")
    _recovery_same("recovery[sparse resumed vs clean]", sp, runs["sparse_clean"])
    check(sp["report"]["statistics"][0]["fitted"] + sp["report"]["holdout"]["0"]
          == RECOVERY_RECORDS - s_fore, "recovery[sparse]: rows not conserved")
    launches["sparse"] = _recovery_launches("recovery[sparse]", sp, "scatter_add")
    for label, r in runs.items():
        log(f"recovery[{label}]: " + json.dumps({
            "card": card, "exits": r["rcs"], "launch_wall_s": r["wall"],
            "process_wall_s": [row["wall_s"] for row in r["rows"]],
            "steps": [row["steps"] for row in r["rows"]],
            "own_steps": [row["calls"].get("step", 0) for row in r["rows"]],
            "pa_scan": [row["pa_scan"] for row in r["rows"]],
            "scatter_add": [row["scatter_add"] for row in r["rows"]],
            "saves": [{k: v[k] for k in ("pid", "snapshot", "s", "bytes")} for v in r["saves"]],
            "restores": [{k: v[k] for k in ("pid", "s")} for v in r["restores"]],
            **({k: r["report"]["statistics"][0][k] for k in FLEET_INT_STATS + ("score",)}
               if r["report"] else {}),
        }))
    saves = [v["s"] for r in runs.values() for v in r["saves"]]
    restores = [v["s"] for r in runs.values() for v in r["restores"]]
    log(f"recovery: resumed = clean, fallback = clean, 2 -> 1 conserves {training} rows, "
        f"card = CPU in every integer statistic ({equal}/{len(resumed['preds'])} predictions "
        f"equal), HANG_EXIT; saves {min(saves):.4f}-{max(saves):.4f} s ({len(saves)}), "
        f"restores {min(restores):.4f}-{max(restores):.4f} s ({len(restores)})")
    log(f"recovery: phase 49 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"fleet_restored_2p_card_p{i}": n for i, n in enumerate(launches["resumed"])}
            | {"fleet_rescaled_2_to_1_card": launches["rescaled"][0]}
            | {f"fleet_fallback_2p_card_p{i}": n for i, n in enumerate(launches["fallback"])},
            {f"fleet_sparse_restored_2p_card_p{i}": n
             for i, n in enumerate(launches["sparse"])})


# --- phase 50: the self-healing fleet -------------------------------------------

# every fleet process of phase 50 runs this bootstrap (a direct launch's
# command, and the supervisor's --workerBoot): tests/fskafka.py installed as
# the ``kafka`` module, then the fleet's run_distributed. It writes one row
# (a JSON file of its own under $CHIP_SMOKE_ROWS: the fleet's processes share
# stdout, where a long report line is no atomic write) however the process
# ends (a clean exit, an injected crash's or the hang watchdog's os._exit, a
# rescale's SystemExit): its fleet
# steps ("steps", SPMDTrainer.step calls: the restored ones not included),
# its pa_scan and scatter_add launches, and wall timestamps ("t") of its
# start, the imports, the card's context (a first tensor on the card), the
# group's join, the restore, the first heartbeat, the first record consumed
# from a data topic, the report and the exit -- the parts of a relaunch
BOOT_KAFKA = """
import json, os, sys, time
T = {"start": time.time()}
sys.path.insert(0, os.environ["CHIP_SMOKE_TESTS"])
import fskafka
fskafka.install()
import torch
import omldm_tpu_torch.runtime.distributed_job as dj
from omldm_tpu_torch.ops import pa_scan, sparse
from omldm_tpu_torch.parallel.spmd import SPMDTrainer
T["imported"] = time.time()
argv = sys.argv[1:]
device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
if device.startswith("cuda"):
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
T["context"] = time.time()
jobs, steps = [], [0]
def after(owner, name, key=None, once=False, count=None):
    real = getattr(owner, name)
    def wrapper(*a, **k):
        out = real(*a, **k)
        if key and not (once and key in T):
            T[key] = time.time()
        if count is not None:
            count[0] += 1
        return out
    setattr(owner, name, wrapper)
init = dj.DistributedStreamJob.__init__
def caught(self, *a, **k):
    init(self, *a, **k)
    jobs.append(self)
    T["joined"] = time.time()
dj.DistributedStreamJob.__init__ = caught
after(dj.DistributedStreamJob, "restore_checkpoint", "restored")
after(dj.DistributedStreamJob, "merged_report", "report")
after(dj, "_heartbeat", "first_beat", once=True)
after(SPMDTrainer, "step", count=steps)
# a real consumer blocks consumer_timeout_ms in an idle poll; the fake
# returns at once, which would make an idle window a few milliseconds
made = fskafka.KafkaConsumer.__init__
def make(self, *a, consumer_timeout_ms=1000, **k):
    made(self, *a, consumer_timeout_ms=consumer_timeout_ms, **k)
    self.idle_s = consumer_timeout_ms / 1000.0
fskafka.KafkaConsumer.__init__ = make
poll = fskafka.KafkaConsumer.__next__
def polled(self):
    try:
        rec = poll(self)
    except StopIteration:
        time.sleep(self.idle_s)
        raise
    if "first_record" not in T and rec.topic != "requests":
        T["first_record"] = time.time()
    return rec
fskafka.KafkaConsumer.__next__ = polled
# the answers this process published on the predictions topic, in order
sent = []
send = fskafka.KafkaProducer.send
def sending(self, topic, value):
    send(self, topic, value)
    if topic == "predictions":
        sent.append(json.loads(value)["value"])
fskafka.KafkaProducer.send = sending
def row(rc):
    T["exit"] = time.time()
    job = jobs[0] if jobs else None
    path = os.path.join(os.environ["CHIP_SMOKE_ROWS"], f"{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({
            "pid": job.pid if job else int(argv[argv.index("--processId") + 1]),
            "processes": job.nproc if job else None, "device": device, "rc": rc,
            "steps": steps[0], "pa_scan": pa_scan.launches,
            "scatter_add": sparse.launches["scatter_add"],
            "rescales": job.rescales_performed if job else None,
            "degraded": job.fleet_degraded if job else None, "sent": sent, "t": T}, f)
    os.replace(path + ".tmp", path)
real_exit = os._exit
def hard_exit(code):
    row(code)
    real_exit(code)
os._exit = hard_exit
try:
    rc = dj.run_distributed(argv)
except SystemExit as exc:
    row(exc.code if isinstance(exc.code, int) else 1)
    raise
except BaseException:
    row(1)
    raise
row(rc)
sys.exit(rc)
"""

# (a)-(c): phase 49's records (the slice-1 Create, 28 features, PA-I
# perRecord) over 2 trainingData partitions, each forecast inline at its
# place; windows of SELFHEAL["chunk"] records. (b)'s crash: process 0 at
# its 10th window (9,500 records), past the snapshots at windows 4 and 8,
# so the relaunch restores window 8 and the crash (armed again in each
# incarnation) cannot come back. (d): tests/test_selfheal.py:694-806's
# flags, 6,000 records on 4 partitions; (e): tests/test_autoscale.py:
# 259-336's, 8,000 records on 4 partitions; (f): the JAX CI gate's
# supervised storm (benchmarks/protocol_comparison.py:1609-1620)
SELFHEAL = dict(records=RECOVERY_RECORDS, chunk=1024, fail_after=9_500, chain_records=6_000,
                autoscale_records=8_000, storm=dict(seed=3, tenants=16, records=192,
                                                    chunk_rows=32, processes=1))
KAFKA_FLEET = ["--kafkaBrokers", "fs://local", "--kafkaPollMs", "50", "--idleWindows", "4"]
CHAIN_FLAGS = ["--slotStrikes", "1", "--minProcesses", "1", "--probeAfterMs", "2000",
               "--probeWindowMs", "1500", "--collectiveTimeoutMs", "5000",
               "--killDeadlineMs", "1000", "--hangProcess", "1", "--hangAfterChunks", "6",
               "--checkpointEvery", "2", "--chunkRows", "100", "--idleWindows", "60",
               "--batchSize", "64", "--testSetSize", "32", "--restartAttempts", "2",
               "--restartDelayMs", "50"]
AUTOSCALE_FLAGS = ["--autoscale", "true", "--minProcesses", "1", "--maxProcesses", "2",
                   "--scaleUpAfterMs", "200", "--scaleDownAfterMs", "1200",
                   "--scaleCooldownMs", "400", "--overload", "backlogHigh=40,backlogCritical=80",
                   "--checkpointEvery", "8", "--chunkRows", "100", "--idleWindows", "60",
                   "--batchSize", "64", "--testSetSize", "32", "--restartAttempts", "2",
                   "--restartDelayMs", "50"]
SELFHEAL_TIMEOUT_S = 300
# seconds between the starts of phase 50's legs
SELFHEAL_GAP_S = 2.0


def _kafka_broker(tmp: Path, tag: str, events, partitions: int, sparse=False) -> Path:
    """A broker directory of its own: the Create on requests, the data
    records (forecasts inline) dealt record i to trainingData partition
    i % partitions. A ``sparse`` stream keeps its Create as it is and its
    forecasts on forecastingData, where a record is always a forecast."""
    if sparse:
        topics = {t: [p for st, p in events if st == t] for t in KAFKA_TOPICS}
    else:
        topics = _topic_lines(events, inline_forecasts=True)
    broker = tmp / f"broker_{tag}"
    broker.mkdir(parents=True)
    for topic in ("requests", "forecastingData"):
        if topics[topic]:
            (broker / f"{topic}--0.log").write_text("".join(f"{x}\n" for x in topics[topic]))
    for p in range(partitions):
        (broker / f"trainingData--{p}.log").write_text(
            "".join(f"{x}\n" for x in topics["trainingData"][p::partitions]))
    return broker


def _kafka_env(broker: Path, rows: Path) -> dict:
    rows.mkdir(parents=True)
    return dict(os.environ, FSKAFKA_DIR=str(broker), CHIP_SMOKE_ROWS=str(rows),
                CHIP_SMOKE_TESTS=str(Path(__file__).resolve().parent / "tests"))


def _process_rows(rows: Path):
    """The rows BOOT_KAFKA's processes wrote, in the order they ended."""
    found = [json.loads(p.read_text()) for p in rows.glob("*.json")]
    return sorted(found, key=lambda r: r["t"]["exit"])


def _kafka_fleet(label: str, tag: str, nproc: int, device: str, broker: Path, tmp: Path,
                 extra=(), files=True):
    """``nproc`` processes of the fleet's Kafka drive (BOOT_KAFKA, a free
    localhost port, the outputs on file sinks unless ``files`` is False),
    each expected to exit 0. A dict: the exit codes, the report, the
    predictions, the processes' rows, stderr, the launch's wall seconds."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    perf, pred = tmp / f"{tag}_perf.jsonl", tmp / f"{tag}_pred.jsonl"
    flags = FLEET_ARGS + KAFKA_FLEET + ["--device", device, "--chunkRows",
                                        str(SELFHEAL["chunk"]), "--processes", str(nproc)]
    if files:
        flags += ["--performanceOut", str(perf), "--predictionsOut", str(pred)]
    flags += [str(a) for a in extra]
    env = _kafka_env(broker, tmp / f"{tag}_rows")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", BOOT_KAFKA, *flags, "--processId", str(pid),
         *(["--coordinator", f"127.0.0.1:{port}"] if nproc > 1 else [])],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SELFHEAL_TIMEOUT_S))
    finally:
        for p in procs:  # a failed member must not hold the group
            if p.poll() is None:
                p.kill()
                p.wait()
    err = "\n".join(e for _, e in outs)
    rcs = [p.returncode for p in procs]
    check(rcs == [0] * nproc, f"{label}[{tag}]: exits {rcs}:\n{err[-3000:]}")
    rows = sorted(_process_rows(tmp / f"{tag}_rows"), key=lambda r: r["pid"])
    check(len(rows) == nproc, f"{label}[{tag}]: {len(rows)} process rows for {nproc}")
    paths = [pred] if nproc == 1 else [Path(f"{pred}.p{i}") for i in range(nproc)]
    by_pid = [[json.loads(line) for line in path.read_text().splitlines()]
              if path.exists() else [] for path in paths]
    return {"rcs": rcs, "report": json.loads(perf.read_text()) if perf.exists() else None,
            "preds": [p for preds in by_pid for p in preds], "by_pid": by_pid,
            "rows": rows, "err": err, "wall": time.perf_counter() - t0}


def _supervised_fleet(label: str, tag: str, nproc: int, broker: Path, tmp: Path, extra,
                      files=True, device="cuda"):
    """``python -m omldm_tpu_torch --supervise true`` over the Kafka drive on
    ``device``, the workers started by BOOT_KAFKA (``--workerBoot``); the
    supervisor must exit 0. A dict as :func:`_kafka_fleet`'s, the rows of
    every incarnation, the predictions of the final one's files (or the
    predictions topic), the supervisor's log lines."""
    perf, pred = tmp / f"{tag}_perf.jsonl", tmp / f"{tag}_pred.jsonl"
    argv = ([sys.executable, "-m", "omldm_tpu_torch", "--supervise", "true", "--processes",
             str(nproc), "--workerBoot", BOOT_KAFKA, "--device", device,
             "--performanceOut", str(perf)] + FLEET_ARGS + KAFKA_FLEET
            + (["--predictionsOut", str(pred)] if files else []) + [str(a) for a in extra])
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=Path(__file__).resolve().parent, capture_output=True,
                         text=True, timeout=SELFHEAL_TIMEOUT_S,
                         env=_kafka_env(broker, tmp / f"{tag}_rows"))
    check(out.returncode == 0, f"{label}[{tag}]: the supervisor exited {out.returncode}:\n"
          f"{out.stderr[-4000:]}")
    report = json.loads(perf.read_text())
    n = report["fleetProcesses"]
    paths = [pred] if n == 1 else [Path(f"{pred}.p{i}") for i in range(n)]
    preds = ([json.loads(line) for path in paths if path.exists()
              for line in path.read_text().splitlines()] if files
             else _read_topic(broker, "predictions"))
    return {"report": report, "preds": preds, "rows": _process_rows(tmp / f"{tag}_rows"),
            "err": out.stderr, "wall": time.perf_counter() - t0,
            "log": [line for line in out.stderr.splitlines() if line.startswith("[supervisor]")]}


def _selfheal_launches(label: str, rows, kernel: str = "pa_scan") -> list:
    """Every process of every incarnation that took fleet steps on the card
    launched ``kernel`` once a step it took; returns the launches."""
    for r in rows:
        want = r["steps"] if r["device"].startswith("cuda") else 0
        check(r[kernel] == want, f"{label}: process {r['pid']} of {r['processes']} launched "
              f"{kernel} {r[kernel]} times in {r['steps']} fleet steps")
    check(any(r["steps"] > 0 for r in rows), f"{label}: no fleet step taken")
    return [r[kernel] for r in rows]


def _conserved(label: str, run, training: int, n_fore: int) -> None:
    s = run["report"]["statistics"][0]
    check(s["fitted"] + run["report"]["holdout"]["0"] == training,
          f"{label}: fitted {s['fitted']} + holdout {run['report']['holdout']['0']} != "
          f"{training}")
    check(len(run["preds"]) == n_fore,
          f"{label}: {len(run['preds'])} predictions for {n_fore} forecasts")


def _published(label: str, kill) -> list:
    """The predictions topic of (b) holds what the processes sent, and only
    the relaunched fleet sent any: the killed incarnation died before its
    sinks ran, and a restore that finds EMITTED.p<i> sends nothing again.
    Returns the relaunched processes' rows, by process id."""
    crash = next(r for r in kill["rows"] if r["rc"] == 3)
    later = sorted((r for r in kill["rows"] if r["t"]["start"] > crash["t"]["exit"]),
                   key=lambda r: r["pid"])
    check([r["pid"] for r in later] == [0, 1],
          f"{label}: relaunched processes {[r['pid'] for r in later]}")
    sent = [len(r["sent"]) for r in kill["rows"]]
    check(len(kill["preds"]) == sum(sent) == sum(len(r["sent"]) for r in later),
          f"{label}: {len(kill['preds'])} predictions on the topic; sent by each process of "
          f"each incarnation {sent}")
    return later


def _once_as(label: str, kill, clean) -> int:
    """Each forecast the clean run answered is answered once on (b)'s
    topic: each relaunched process sent as many answers as the clean run's
    process of its id wrote, and at least 99% of them equal that process's
    at the same place (a process answers its partitions' forecasts in their
    order). Returns the equal answers."""
    later = _published(label, kill)
    equal = 0
    for r, want in zip(later, clean["by_pid"]):
        check(len(r["sent"]) == len(want), f"{label}: process {r['pid']} sent "
              f"{len(r['sent'])} answers for the clean run's {len(want)}")
        equal += sum(a == b["value"] for a, b in zip(r["sent"], want))
    check(equal >= 0.99 * len(clean["preds"]),
          f"{label}: {equal} of {len(clean['preds'])} answers equal the clean run's")
    return equal


def _recover_split(run, bundle_events) -> dict:
    """(b)'s time to recover, from process 0's injected crash to the HEAL
    event the supervisor records at the relaunched fleet's first beat, by
    part: the supervisor's detection (to its RESTART event), the spawn (to
    the worker's first line: the restart delay, fork and exec, the
    interpreter), the imports, the card's context, the join, the restore
    and the first beat -- each the relaunched process whose beat came
    first."""
    crash = next(r for r in run["rows"] if r["rc"] == 3)
    t_crash = crash["t"]["exit"]
    sup = [e for e in bundle_events if e.get("pid") == "sup"]
    restart = next(e["wall"] for e in sup if e["kind"] == "restart")
    heal = next(e["wall"] for e in sup if e["kind"] == "heal")
    later = [r for r in run["rows"] if r["t"]["start"] > t_crash and "first_beat" in r["t"]]
    first = min(later, key=lambda r: r["t"]["first_beat"])["t"]
    return {"to_heal_s": heal - t_crash, "detect_s": restart - t_crash,
            "spawn_s": first["start"] - restart, "imports_s": first["imported"] - first["start"],
            "context_s": first["context"] - first["imported"],
            "join_s": first["joined"] - first["context"],
            "restore_s": first["restored"] - first["joined"],
            "first_beat_s": first["first_beat"] - first["restored"],
            "heal_poll_s": heal - first["first_beat"]}


def _bundle_events(blackbox: Path) -> list:
    bundles = sorted(blackbox.glob("incident-*.json"),
                     key=lambda p: int(p.stem.split("-")[1]))
    check(bundles, f"no incident bundle under {blackbox}")
    return json.loads(bundles[-1].read_text())["timeline"]


def _kill_checks(label: str, kill, clean, ck: Path, blackbox: Path):
    """(b): one relaunch, the topic holding what the relaunched fleet sent,
    both EMITTED markers; against ``clean`` (None: no comparison) the
    statistics and the answers, each once. Returns the answers equal to the
    clean run's (None without one) and the time to recover by part."""
    failures = [line for line in kill["log"] if "fleet failure" in line]
    check(len(failures) == 1 and "process 0 exited 3" in failures[0],
          f"{label}: restarts {failures}")
    equal = None
    if clean is None:
        _published(label, kill)
    else:
        _recovery_same(f"{label} vs clean", kill, clean)
        equal = _once_as(label, kill, clean)
    check(all((ck / f"EMITTED.p{i}").exists() for i in range(2)),
          f"{label}: an EMITTED marker is missing")
    return equal, _recover_split(kill, _bundle_events(blackbox))


def _leg_clean(tmp, events, device, tag):
    return _kafka_fleet("selfheal", tag, 2, device, _kafka_broker(tmp, tag, events, 2), tmp)


def _leg_kill(tmp, events, device):
    broker = _kafka_broker(tmp, "kill", events, 2)
    return _supervised_fleet("selfheal", "kill", 2, broker, tmp, device=device, extra=[
        "--checkpointDir", tmp / "kill_ck", "--checkpointEvery", 4, "--failProcess", 0,
        "--failAfterRecords", SELFHEAL["fail_after"], "--restartAttempts", 2,
        "--restartDelayMs", 50, "--heartbeatTimeoutMs", 120_000, "--flightRecorder", "on",
        "--blackboxPath", tmp / "kill_bb", "--chunkRows", SELFHEAL["chunk"]], files=False)


def _leg_sever(tmp, events, device):
    broker = _kafka_broker(tmp, "sever", events, 2)
    run = _kafka_fleet("selfheal", "sever", 2, device, broker, tmp,
                       ["--severBrokerAfterChunks", 2, "--performanceOut",
                        tmp / "sever_perf.jsonl"], files=False)
    run["report"] = json.loads((tmp / "sever_perf.jsonl").read_text())
    return run


def _leg_chain(tmp, seed, device):
    events = make_events(SELFHEAL["chain_records"] * 9 // 10, seed + 2, query_at=None)
    broker = _kafka_broker(tmp, "chain", events, 4)
    run = _supervised_fleet("selfheal", "chain", 2, broker, tmp, device=device,
                            extra=CHAIN_FLAGS + [
        "--faultStateDir", tmp / "chain_fault", "--flightRecorder", "on",
        "--blackboxPath", tmp / "chain_bb", "--checkpointDir", tmp / "chain_ck"])
    return run, events


def _leg_autoscale(tmp, seed, device):
    events = make_events(SELFHEAL["autoscale_records"] * 9 // 10, seed + 3, query_at=None)
    broker = _kafka_broker(tmp, "autoscale", events, 4)
    run = _supervised_fleet("selfheal", "autoscale", 1, broker, tmp, device=device,
                            extra=AUTOSCALE_FLAGS + [
        "--checkpointDir", tmp / "autoscale_ck"])
    return run, events


def _leg_sparse(tmp, sparse, seed, device):
    events = criteo_events(SELFHEAL["records"], seed + 1, query_at=None,
                           scatter_impl=stream_scatter_impl(sparse))
    broker = _kafka_broker(tmp, "sparse", events, 2, sparse=True)
    run = _supervised_fleet("selfheal", "sparse", 2, broker, tmp, device=device, extra=[
        "--checkpointDir", tmp / "sparse_ck", "--checkpointEvery", 4, "--restartAttempts", 1,
        "--heartbeatTimeoutMs", 120_000, "--chunkRows", SELFHEAL["chunk"]])
    return run, events


def _leg_storm(tmp, device):
    from omldm_tpu_torch import load_harness
    from omldm_tpu_torch.runtime.slo import SLOBudgets

    spec = SELFHEAL["storm"]
    storm = load_harness.build_composed_storm(**spec)
    budgets = SLOBudgets(heal_after_fault_s=120.0, expected_heals=2,
                         allow_shed_tenants=storm.hot_tenant_ids(), max_stranded_rows=0)
    t0 = time.perf_counter()
    report, merged, _ = load_harness.run_supervised_storm(
        storm, str(tmp / "storm"), budgets, processes=spec["processes"],
        timeout_s=SELFHEAL_TIMEOUT_S, device=device)
    return report, merged, time.perf_counter() - t0


def phase_selfheal_idle(seed: int, card: str, tmp: Path, device: str = "cuda") -> None:
    """(b) on its own, no other leg beside it: the time to recover of one
    relaunch on an otherwise idle host, by part. Held to one relaunch,
    conservation, each forecast once on the topic, both EMITTED markers and
    pa_scan once a step; the comparison with the clean run's answers is
    phase 50's."""
    events = make_events(SELFHEAL["records"], seed + 1, query_at=None)
    n_fore = sum(1 for st, _ in events if st == "forecastingData")
    kill = _leg_kill(tmp, events, device)
    _, split = _kill_checks("selfheal[kill-idle]", kill, None, tmp / "kill_ck",
                            tmp / "kill_bb")
    _conserved("selfheal[kill-idle]", kill, SELFHEAL["records"], n_fore)
    launches = _selfheal_launches("selfheal[kill-idle]", kill["rows"])
    log("selfheal[kill-idle]: " + json.dumps({
        "card": card, "wall_s": kill["wall"], "recover": split, "pa_scan": launches,
        "incarnations": [[r["processes"], r["pid"], r["rc"], r["steps"]] for r in kill["rows"]]}))


def phase_selfheal(torch, sparse, seed: int, card: str, tmp: Path, device: str = "cuda"):
    """Phase 50: the self-healing fleet on the card, its legs side by side,
    each fleet on a broker directory and a coordinator port of its own, two
    processes sharing the card over gloo: (a) the fleet's Kafka drive on
    phase 49's records, card and CPU; (b) the same under the supervisor
    with process 0 killed mid-stream; (c) the broker severed; (d) the
    self-heal chain 2 -> 1 -> probe -> 2; (e) autoscale 1 -> 2 -> 1; (f)
    the load harness's supervised storm; (g) phase 49's sparse stream under
    the supervisor. ``device`` is the card's (a debugging run on a host
    without one passes "cpu"). Returns the card processes' pa_scan and
    scatter_add launches by leg."""
    t_phase, t_wall = time.perf_counter(), time.time()
    training = SELFHEAL["records"]
    # the legs start SELFHEAL_GAP_S apart, those with the most relaunches
    # first (their streams are drawn in their threads), so that their
    # interpreters do not all import torch at once; the draw of the others'
    # stream runs while the first three start
    first = [("chain", _leg_chain, (tmp, seed, device)),
             ("autoscale", _leg_autoscale, (tmp, seed, device)),
             ("storm", _leg_storm, (tmp, device))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        futures = {}

        def start(legs):
            for name, leg, leg_args in legs:
                if futures:
                    time.sleep(SELFHEAL_GAP_S)
                futures[name] = pool.submit(leg, *leg_args)

        start(first)
        events = make_events(training, seed + 1, query_at=None)
        n_fore = sum(1 for st, _ in events if st == "forecastingData")
        start([("kill", _leg_kill, (tmp, events, device)),
               ("sparse", _leg_sparse, (tmp, sparse, seed, device)),
               ("clean", _leg_clean, (tmp, events, device, "clean_card")),
               ("cpu", _leg_clean, (tmp, events, "cpu", "clean_cpu")),
               ("sever", _leg_sever, (tmp, events, device))])
        clean, cpu = futures["clean"].result(), futures["cpu"].result()
        kill, sever = futures["kill"].result(), futures["sever"].result()
        (chain, chain_events), (scale, scale_events) = (futures["chain"].result(),
                                                        futures["autoscale"].result())
        storm_report, storm_merged, storm_s = futures["storm"].result()
        sparse_run, sparse_events = futures["sparse"].result()
    launches = {}
    # (a) conservation, a launch a step, card = CPU
    for label, run in (("clean_card", clean), ("clean_cpu", cpu)):
        _conserved(f"selfheal[{label}]", run, training, n_fore)
    launches["kafka"] = _selfheal_launches("selfheal[clean_card]", clean["rows"])
    _selfheal_launches("selfheal[clean_cpu]", cpu["rows"])
    _recovery_same("selfheal[card vs cpu]", clean, cpu)
    equal = sum(a["value"] == b["value"] for a, b in zip(clean["preds"], cpu["preds"]))
    check(equal >= 0.99 * n_fore, f"selfheal: {equal} of {n_fore} predictions card = CPU")
    start = min(r["t"]["first_record"] for r in clean["rows"])
    end = max(r["t"]["report"] for r in clean["rows"])
    rate = (training + n_fore) / (end - start)
    # (b) one relaunch, the clean run's statistics, each of the clean run's
    # forecasts once on the predictions topic with its answer, EMITTED.p<i>
    # written by both processes
    kill_equal, split = _kill_checks("selfheal[kill]", kill, clean, tmp / "kill_ck",
                                     tmp / "kill_bb")
    launches["kill"] = _selfheal_launches("selfheal[kill]", kill["rows"])
    # (c) the severed broker
    check("severed file-backed broker" in sever["err"] and "dropping record" in sever["err"],
          "selfheal[sever]: no sever or no dropped send")
    s = sever["report"]["statistics"][0]
    check(0 < s["fitted"] + sever["report"]["holdout"]["0"] <= training,
          f"selfheal[sever]: fitted {s['fitted']}")
    # (d) the chain, in order, and in the final bundle strike < degrade <
    # probe; conservation, exactly once, full width, healed
    order = ["injected hang: SIGSTOP", "collective watchdog: no progress",
             "blaming wedged process 1", "degrading fleet 2 -> 1",
             "redistributing a 2-process snapshot", "probing back 1 -> 2", "re-expansion probe",
             "fleet healed at 2"]
    at = [chain["err"].find(line) for line in order]
    check(all(i >= 0 for i in at) and at[:4] == sorted(at[:4]) and at[5:] == sorted(at[5:]),
          f"selfheal[chain]: the chain's lines at {dict(zip(order, at))}")
    kinds = [e["kind"] for e in _bundle_events(tmp / "chain_bb")]
    chain_kinds = [k for k in kinds if k in ("strike", "degrade", "probe")]
    check(chain_kinds[:3] == ["strike", "degrade", "probe"],
          f"selfheal[chain]: the final bundle's chain {chain_kinds}")
    c_fore = sum(1 for st, _ in chain_events if st == "forecastingData")
    _conserved("selfheal[chain]", chain, SELFHEAL["chain_records"] - c_fore, c_fore)
    check(chain["report"]["fleetProcesses"] == 2 and chain["report"]["fleetDegraded"] == 0,
          f"selfheal[chain]: ends at {chain['report']['fleetProcesses']} processes, degraded "
          f"{chain['report']['fleetDegraded']}")
    launches["chain"] = _selfheal_launches("selfheal[chain]", chain["rows"])
    # (e) out and back
    a_fore = sum(1 for st, _ in scale_events if st == "forecastingData")
    _conserved("selfheal[autoscale]", scale, SELFHEAL["autoscale_records"] - a_fore, a_fore)
    check(scale["report"]["rescalesPerformed"] == 2 and scale["report"]["fleetProcesses"] == 1,
          f"selfheal[autoscale]: {scale['report']['rescalesPerformed']} rescales, ends at "
          f"{scale['report']['fleetProcesses']}")
    check(any("rescaling fleet 1 -> 2" in ln for ln in scale["log"])
          and any("rescaling fleet 2 -> 1" in ln for ln in scale["log"]),
          f"selfheal[autoscale]: {scale['log']}")
    launches["autoscale"] = _selfheal_launches("selfheal[autoscale]", scale["rows"])
    # (g) the sparse supervised fleet: scatter_add once a step
    s_fore = sum(1 for st, _ in sparse_events if st == "forecastingData")
    _conserved("selfheal[sparse]", sparse_run, SELFHEAL["records"] - s_fore, s_fore)
    check(not any("fleet failure" in ln for ln in sparse_run["log"]),
          f"selfheal[sparse]: {sparse_run['log']}")
    launches["sparse"] = _selfheal_launches("selfheal[sparse]", sparse_run["rows"],
                                            "scatter_add")
    # (f) the storm's SLO verdicts
    check(storm_report.passed, f"selfheal[storm]: {[c.to_dict() for c in storm_report.failing()]}")
    heal = next(c for c in storm_report.checks if c.name == "heal_after_fault")
    log("selfheal[kafka]: " + json.dumps({
        "card": card, "records": training + n_fore, "records_per_s": rate,
        "launch_wall_s": [clean["wall"], cpu["wall"]],
        "steps": [r["steps"] for r in clean["rows"]], "pa_scan": launches["kafka"],
        "predictions_equal": equal,
        **{k: clean["report"]["statistics"][0][k] for k in FLEET_INT_STATS + ("score",)},
        "holdout": clean["report"]["holdout"]}))
    log("selfheal[kill]: " + json.dumps({
        "card": card, "wall_s": kill["wall"],
        "restarts": sum("fleet failure" in line for line in kill["log"]),
        "predictions_equal_clean": kill_equal,
        "recover": split, "pa_scan": launches["kill"],
        "incarnations": [[r["processes"], r["pid"], r["rc"], r["steps"]] for r in kill["rows"]],
        "predictions_on_topic": len(kill["preds"])}))
    log("selfheal[sever]: " + json.dumps({"wall_s": sever["wall"], "fitted": s["fitted"],
                                           "holdout": sever["report"]["holdout"]}))
    log("selfheal[chain]: " + json.dumps({
        "wall_s": chain["wall"], "log": chain["log"], "bundle_chain": chain_kinds[:6],
        "pa_scan": launches["chain"],
        "incarnations": [[r["processes"], r["pid"], r["rc"], r["steps"]] for r in chain["rows"]]}))
    log("selfheal[autoscale]: " + json.dumps({
        "wall_s": scale["wall"], "log": scale["log"], "pa_scan": launches["autoscale"],
        "incarnations": [[r["processes"], r["pid"], r["rc"], r["steps"]] for r in scale["rows"]]}))
    log("selfheal[sparse]: " + json.dumps({
        "wall_s": sparse_run["wall"], "scatter_add": launches["sparse"],
        "steps": [r["steps"] for r in sparse_run["rows"]],
        **{k: sparse_run["report"]["statistics"][0][k] for k in FLEET_INT_STATS + ("score",)}}))
    log("selfheal[storm]: " + json.dumps({
        "wall_s": storm_s, "passed": storm_report.passed, "core": storm_report.core_digest(),
        "heals": heal.detail["heals"], "heal_s": heal.detail["healSeconds"],
        "fleetProcesses": storm_merged["fleetProcesses"]}))
    # each process's start, end of imports and exit, in seconds from the
    # phase's start: where the legs' relaunches wait on the host
    log("selfheal[timeline]: " + json.dumps({
        name: [[r["processes"], r["pid"]] + [round(r["t"][k] - t_wall, 2)
                                             for k in ("start", "imported", "exit")]
               for r in sorted(run["rows"], key=lambda r: r["t"]["start"])]
        for name, run in (("clean_card", clean), ("clean_cpu", cpu), ("kill", kill),
                          ("sever", sever), ("chain", chain), ("autoscale", scale),
                          ("sparse", sparse_run))}))
    log(f"selfheal: {rate:.0f} records/s over the Kafka drive at 2 processes; recovered in "
        f"{split['to_heal_s']:.2f} s (spawn {split['spawn_s']:.2f}, imports "
        f"{split['imports_s']:.2f}, context {split['context_s']:.2f}, join {split['join_s']:.2f}, "
        f"restore {split['restore_s']:.2f}, first beat {split['first_beat_s']:.2f}); chain, "
        f"autoscale and storm passed")
    log(f"selfheal: phase 50 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"selfheal_kafka_2p_card_p{i}": n for i, n in enumerate(launches["kafka"])} | {
        "selfheal_supervised_kill_all_incarnations": sum(launches["kill"]),
        "selfheal_chain_all_incarnations": sum(launches["chain"]),
        "selfheal_autoscale_all_incarnations": sum(launches["autoscale"])},
            {f"selfheal_sparse_supervised_2p_card_p{r['pid']}": r["scatter_add"]
             for r in sparse_run["rows"]})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # cut from 100,000, then 50,000, for the script's time limit
    parser.add_argument("--records", type=int, default=25_000)
    parser.add_argument("--parity-records", type=int, default=5_000)
    parser.add_argument("--lm-steps", type=int, default=8)
    parser.add_argument("--bench-records", type=int, default=BENCH_RECORDS)
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR")
    parser.add_argument("--ab-pa-scan", type=Path, default=None, metavar="SRC",
                        help="time the one-scan kernel against SRC (another checkout's "
                             "pa_scan.cu), then exit")
    parser.add_argument("--overload-legs", type=int, default=0, metavar="N",
                        help="run N trials of phase 39's timed legs, then exit")
    parser.add_argument("--overload-collector", choices=("deferred", "on"),
                        default="deferred")
    parser.add_argument("--telemetry-legs", type=int, default=0, metavar="N",
                        help="run N pairs of phase 41a's timed legs, then exit")
    parser.add_argument("--package", type=Path, default=None, metavar="DIR",
                        help="with --overload-legs or --telemetry-legs: the "
                             "omldm_tpu_torch of DIR")
    parser.add_argument("--sequence-only", action="store_true",
                        help="run phases 43-45 after the build (phase 9's LM for 45's "
                             "comparison), then exit")
    parser.add_argument("--kafka-only", action="store_true",
                        help="run phase 17 and phase 47 after the build, then exit")
    parser.add_argument("--fleet-only", action="store_true",
                        help="run phases 48-49 after the build, then exit")
    parser.add_argument("--selfheal-only", action="store_true",
                        help="run phase 50 after the build, then exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "omldm_tpu_torch" / "csrc" / "pa_scan.cu").exists():
        print(f"chip_smoke: no omldm_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    if (args.overload_legs or args.telemetry_legs) and args.package is not None:
        sys.path.insert(0, str(args.package.resolve()))
    from omldm_tpu_torch.ops import attention, pa_scan, sparse
    from omldm_tpu_torch.runtime import fast_ingest

    t_start = time.perf_counter()
    lap("start-up")
    card = phase_setup(torch)
    build_flash = phase_build(pa_scan, attention, sparse)
    lap("build")
    if (args.ab_pa_scan is not None or args.overload_legs or args.telemetry_legs
            or args.sequence_only or args.fleet_only or args.kafka_only):
        build_flash()
        lap("flash build")
    if args.ab_pa_scan is not None:
        ab = phase_ab_pa_scan(torch, pa_scan, args.ab_pa_scan)
        log(json.dumps({"ab_pa_scan": {f"{b}x{d}": {"this_ms": t, "other_ms": o}
                                       for (b, d), (t, o) in ab.items()}}))
        return 0
    if args.overload_legs:
        phase_overload_legs(torch, args.overload_legs, args.overload_collector)
        return 0
    if args.telemetry_legs:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as tmp:
            phase_telemetry_legs(torch, args.telemetry_legs, Path(tmp))
        return 0
    if args.sequence_only:
        _, trainer, lm_ms = phase_lm(torch, attention, args.lm_steps, args.seed)
        del trainer
        phase_sequence_family(torch, attention, args.seed, lm_ms, args.profile)
        return 0
    if args.fleet_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
            phase_fleet(torch, sparse, args.seed, card, Path(tmp), args.profile)
            lap("fleet")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
            phase_fleet_recovery(torch, sparse, args.seed, card, Path(tmp))
            lap("fleet recovery")
        return 0
    if args.selfheal_only:
        # phase 50 needs no flash kernel: its nvcc runs on beside the phase
        with tempfile.TemporaryDirectory(prefix="chip_smoke_selfheal_") as tmp:
            phase_selfheal_idle(args.seed, card, Path(tmp) / "idle")
            lap("supervised kill alone")
            phase_selfheal(torch, sparse, args.seed, card, Path(tmp))
            lap("self-healing fleet")
        build_flash()
        return 0
    if args.kafka_only:
        events = make_events(args.records, args.seed, query_at=args.records // 2)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kafka_") as tmp:
            cli = phase_cli(torch, pa_scan, fast_ingest, events, Path(tmp), float("nan"))
            lap("cli")
            with _no_residue(torch, "kafka-profile"):
                phase_kafka_profile(torch, pa_scan, events, Path(tmp))
            with _no_residue(torch, "kafka"):
                phase_kafka(torch, pa_scan, events, cli, float("nan"), args.parity_records,
                            Path(tmp))
                lap("kafka")
                phase_storm(torch, pa_scan)
                lap("storm")
        return 0
    max_err = phase_check(torch, pa_scan)
    times = phase_time(torch, pa_scan)
    lap("pa_scan check and time")
    t0 = time.perf_counter()
    events = make_events(args.records, args.seed, query_at=args.records // 2)
    log(f"slice: generated {len(events)} events ({args.records} training) "
        f"in {time.perf_counter() - t0:.2f} s")
    launches, wall, slice_preds = phase_slice(torch, pa_scan, events)
    phase_parity(events[: args.parity_records + 1])
    lap("slice stream and parity")
    scatter_err = phase_sparse_check(torch, sparse)
    scatter_times = phase_sparse_time(torch, sparse)
    lap("sparse check and time")
    phase_calibrate(torch)
    lap("calibrate")
    t0 = time.perf_counter()
    sparse_events = criteo_events(SPARSE_RECORDS, args.seed, query_at=SPARSE_RECORDS // 2,
                                  scatter_impl=stream_scatter_impl(sparse))
    log(f"sparse: generated {len(sparse_events)} events in {time.perf_counter() - t0:.2f} s")
    scatter_launches, sparse_wall = phase_sparse(torch, sparse, sparse_events)
    phase_parity(sparse_events[: args.parity_records + 1])
    outer_launches = phase_avazu(torch, sparse, avazu_events(AVAZU_RECORDS, args.seed))
    lap("sparse stream, parity and avazu")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cli_dir = Path(tmp)
        cli = phase_cli(torch, pa_scan, fast_ingest, events, cli_dir, wall)
        phase_cli_parity(torch, events[: args.parity_records + 1], cli_dir)
        phase_serving(torch, pa_scan, fast_ingest, cli, cli_dir)
        cli_sparse = phase_cli_sparse(torch, sparse, fast_ingest, sparse_events, cli_dir,
                                      sparse_wall)
        lap("cli, cli-parity, serving and cli-sparse")
        if args.profile is not None:
            phase_cli_profile(torch, cli, cli_sparse, args.profile)
            lap("cli profiles")
    # the flash phases come after the sparse and CLI phases, which need no
    # flash kernel, so flash attention's nvcc runs on beside them
    build_flash()
    lap("flash build")
    flash_err = phase_flash_check(torch, attention)
    lap("flash check")
    flash_times = phase_flash_time(torch, attention)
    lap("flash time")
    flash_launches, trainer, lm_ms = phase_lm(torch, attention, args.lm_steps, args.seed)
    phase_lm_parity(torch, args.seed)
    lap("lm and lm-parity")
    # phases 43-45 run here, beside the LM phases: their timings need
    # torch.profiler's device records, which can come back empty after
    # phases 41-42's device-only traces
    coverage_err, coverage_times, moe_launches, f32_launches, graft_launches = \
        phase_sequence_family(torch, attention, args.seed, lm_ms, args.profile)
    learner_rows = phase_learners(torch, args.seed)
    lap("learners")
    protocol_rows, sync_pa_launches, sync_scatter_launches = phase_protocols(
        torch, pa_scan, sparse, args.seed, stream_scatter_impl(sparse))
    lap("protocols")
    phase_protocol_parity(torch, args.seed, args.parity_records)
    lap("protocol-parity")
    log("host-plane: " + json.dumps({
        "learners": learner_rows, "protocols": protocol_rows,
        "pa_scan_launches_sync_per_record": sync_pa_launches,
        "scatter_add_launches_sync_sparse": sync_scatter_launches,
    }))
    if args.profile is not None:
        phase_host_plane_profile(torch, args.seed, {**learner_rows, **protocol_rows},
                                 args.profile)
        lap("host-plane profiles")
    # checkpoints of phases 34-38 and phase 37's rows of the bench file
    ckpt_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    ckpt_dir = Path(ckpt_tmp.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spmd_") as tmp:
        spmd_dir = Path(tmp)
        bench_path, bench = phase_bench(torch, args.seed, args.bench_records, spmd_dir, card)
        lap("bench")
        spmd_rows, spmd_pa_launches, spmd_scatter = phase_spmd_protocols(
            torch, pa_scan, sparse, args.seed, spmd_dir)
        lap("spmd protocols")
        spmd_parity_launches = phase_spmd_parity(torch, pa_scan, sparse, args.seed, bench_path,
                                                 spmd_dir)
        lap("spmd-parity")
        ingest_pa_launches = phase_ingest(torch, pa_scan, bench_path, args.bench_records, spmd_dir,
                                          card)
        lap("ingest")
        spmd_ckpt_rows = ckpt_dir / "bench_head.jsonl"
        with open(bench_path) as src, open(spmd_ckpt_rows, "w") as dst:
            for _, line in zip(range(SPMD_CKPT["rows"]), src):
                dst.write(line)
        log("spmd: " + json.dumps({
            "bench": bench, "protocols": spmd_rows,
            "pa_scan_launches_spmd_per_record": spmd_pa_launches,
            "scatter_add_launches_spmd_sparse": spmd_scatter,
            "launches_card_vs_cpu_dp8": spmd_parity_launches,
        }))
        if args.profile is not None:
            phase_bench_profile(torch, bench_path, args.profile)
            lap("bench profile")
        batched_err, batched_times = phase_batched(torch, pa_scan)
        lap("batched pa_scan check and time")
        mt_launches = phase_multi_tenant(torch, pa_scan, args.seed)
        lap("multi-tenant")
        specs_launches = phase_cohort_specs(torch, pa_scan, args.seed)
        lap("cohort specs")
        phase_codec(torch, args.seed, bench_path, bench, spmd_dir)
        lap("codec")
    guard_launches = phase_guard_stream(torch, pa_scan, events, wall)
    lap("guard stream")
    guard_cohort = phase_guard_cohorts(torch, pa_scan, args.seed)
    lap("guard cohorts")
    reliable_launches = phase_reliable(torch, pa_scan, events)
    lap("reliable channel")
    recovery_launches, recovery_fitted = phase_recovery(torch, pa_scan, events, ckpt_dir)
    lap("recovery")
    rescale_launches = phase_rescale(torch, pa_scan, sparse, events, sparse_events, ckpt_dir)
    lap("rescale")
    cohort_rescale_launches = phase_rescale_cohort(torch, pa_scan, args.seed)
    lap("rescale-cohort")
    phase_spmd_ckpt(torch, spmd_ckpt_rows, ckpt_dir)
    lap("spmd-ckpt")
    lm_ckpt_launches = phase_lm_ckpt(torch, attention, trainer, args.seed, ckpt_dir)
    lap("lm-ckpt")
    overload_batched, overload_scatter = phase_overload(torch, pa_scan, sparse, args.seed,
                                                        sparse_events)
    lap("overload")
    lifecycle_launches, poison_preds = phase_lifecycle(torch, pa_scan, ckpt_dir)
    lap("lifecycle")
    # phase 47d runs before phases 41-42: its profile window needs
    # torch.profiler's device records; the rest of phase 47 runs after
    # them, so the reference smokes' timed gates (41a, 42a) see the state
    # of the script they saw before the phase existed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kafka_") as tmp, \
            _no_residue(torch, "kafka-profile"):
        kafka_profile_launches = phase_kafka_profile(torch, pa_scan, events, Path(tmp))
        lap("kafka profile window")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_planes_") as tmp:
        telemetry_launches, cli_profiled_launches = phase_telemetry(
            torch, pa_scan, events, launches, slice_preds, Path(tmp))
        lap("telemetry")
        recorder_batched, recorder_lifecycle = phase_flight_recorder(
            torch, pa_scan, args.seed, guard_cohort, lifecycle_launches, poison_preds, Path(tmp))
        lap("flight recorder")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kafka_") as tmp, \
            _no_residue(torch, "kafka"):
        kafka_launches = phase_kafka(torch, pa_scan, events, cli, len(events) / wall,
                                     args.parity_records, Path(tmp),
                                     restart_fitted=recovery_fitted)
        lap("kafka")
        storm_batched, storm_solo = phase_storm(torch, pa_scan)
        lap("storm")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        fleet_pa_launches, fleet_scatter_launches = phase_fleet(torch, sparse, args.seed, card,
                                                                Path(tmp), args.profile)
        lap("fleet")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        recovery_pa_launches, recovery_scatter_launches = phase_fleet_recovery(
            torch, sparse, args.seed, card, Path(tmp))
        lap("fleet recovery")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_selfheal_") as tmp:
        selfheal_pa_launches, selfheal_scatter_launches = phase_selfheal(
            torch, sparse, args.seed, card, Path(tmp))
        lap("self-healing fleet")
    ckpt_tmp.cleanup()
    if args.profile is not None:
        for name, stream_events, unprofiled in (("slice", events, wall),
                                                ("sparse", sparse_events, sparse_wall)):
            busy_s = phase_profile(torch, stream_events, args.profile, name)
            log(f"profile[{name}]: device busy {busy_s:.4f} s against the unprofiled "
                f"stream's {unprofiled:.3f} s wall: idle share {1.0 - busy_s / unprofiled:.4f}")
        phase_lm_profile(torch, attention, trainer, args.profile, args.seed)
        lap("profiles")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    main_shape = (256, N_FEATURES + 1)
    kernels = [{
        "name": "pa_scan",
        "route": "cuda",
        "source": "omldm_tpu_torch/csrc/pa_scan.cu",
        "replaces": "omldm_tpu/ops/pa_scan.py:27",
        "launches": launches,
        "launches_by_path": {
            "stream": launches,
            "spmd_per_record": spmd_pa_launches,
            "spmd_per_record_sharded_ingest": ingest_pa_launches,
            "spmd_card_vs_cpu_dp8": spmd_parity_launches["pa_scan"],
            "stream_guarded": guard_launches,
            "reliable_chaos_first_records": reliable_launches,
            "recovery_final_incarnation": recovery_launches,
            "rescale_16_4_8": rescale_launches["rescale"],
            "restored_at_parallelism_4": rescale_launches["restore_at_4"],
            **{f"lifecycle_{mode}": n for mode, n in lifecycle_launches.items()},
            "stream_telemetry_armed": telemetry_launches,
            "cli_profiled": cli_profiled_launches,
            "lifecycle_poison_events_armed": recorder_lifecycle,
            "kafka_route": kafka_launches["route"],
            "kafka_restart_final_incarnation": kafka_launches["restart"],
            "kafka_profile_window": kafka_profile_launches,
            "storm_per_record_solo": storm_solo,
            **fleet_pa_launches,
            **recovery_pa_launches,
            **selfheal_pa_launches,
        },
        "max_abs_err": max_err,
        **times[main_shape],
        "library_ms": None,
    }]
    kernels.append({
        "name": "pa_scan_batched",
        "route": "cuda",
        "source": "omldm_tpu_torch/csrc/pa_scan.cu",
        "replaces": "omldm_tpu/ops/pa_scan.py:27",
        "launches": mt_launches,
        "launches_by_path": {
            "multi_tenant": mt_launches,
            "cohort_specs": specs_launches,
            "spmd_card_vs_cpu_dp8": spmd_parity_launches["pa_scan_batched"],
            "multi_tenant_guarded_first_records": guard_cohort["batched"],
            "multi_tenant_rescaled_2_1_2": cohort_rescale_launches,
            "multi_tenant_overload_armed_first_records": overload_batched,
            "multi_tenant_guarded_events_armed": recorder_batched,
            "storm_per_record": storm_batched,
        },
        "max_abs_err": batched_err,
        **batched_times[BATCHED_SHAPES[0]],
        "library_ms": None,
    })
    b, lq, h, dh = FLASH_TIME_SHAPES[0]  # the LM slice's shape
    for name, replaces in FLASH_SOURCES.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "omldm_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": flash_launches[name],
            "launches_by_path": {"lm": flash_launches[name],
                                 "lm_loaded_from_checkpoint": lm_ckpt_launches[name],
                                 "lm_moe_remat": moe_launches[name],
                                 "lm_float32": f32_launches[name],
                                 "graft_moe_dh8": graft_launches[name]},
            "max_abs_err": max(flash_err[name], coverage_err[name]),
            **flash_times[(b, lq, h, dh, name)],
            # phase 43's other (dtype, head width) designs, timed as phase 8
            "times_by_shape": [
                {"shape": [cb, cl, ch, cd], "dtype": cdt, **entry}
                for (cb, cl, ch, cd, cdt, kname), entry in coverage_times.items()
                if kname == name],
        })
    for name, launched, shape in (("scatter_add", scatter_launches, "slice"),
                                  ("scatter_add_outer", outer_launches, "avazu")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "omldm_tpu_torch/csrc/scatter_add.cu",
            "replaces": "benchmarks/sparse_scatter_experiment.py:149",
            "launches": launched,
            "max_abs_err": scatter_err,
            **scatter_times[shape],
        })
    kernels[-2]["launches_by_path"] = {
        "sparse_stream": scatter_launches,
        **{f"spmd_sparse_{route}": n for route, n in spmd_scatter.items()},
        "spmd_card_vs_cpu_dp8": spmd_parity_launches["scatter_add"],
        "sparse_recovery_final_incarnation": rescale_launches["sparse_recovery"],
        "sparse_overload_armed_first_records": overload_scatter,
        **fleet_scatter_launches,
        **recovery_scatter_launches,
        **selfheal_scatter_launches,
    }
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
