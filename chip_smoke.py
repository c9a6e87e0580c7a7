#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — the card's name and power limit (nvidia-smi) and its
   compute capability, which must be (9, 0);
2. build   — compiles every kernel under dmlc_core_tpu_torch/kernels/
   with nvcc, one process per source, all at once, and beside them the
   native parse and pack library with g++;
3. kernels — each kernel on the card at the shapes of the path that runs
   it (serving: the ragged gather and fm terms; training: the embed bag
   and fm terms, forward and backward, at 4096 x 64 and the ragged
   gather forward and backward at 4096 rows in the native packer's nnz
   bucket of cap 131072 (as the flat training batches come), with
   out-of-range ids and padding; the ragged-gather forward also with
   the batch's entries shuffled and with all of them in one row; the
   ragged fm forward and backward at the sharded FM paths' shard shapes,
   D = 16 for mp dim and rows 0..2^19 of a remapped batch for mp rows), held
   against its plain PyTorch version (rtol = atol = 1e-5; zero fill must
   give exact zeros, every ragged backward with nnz_used = 0 also in a
   freed NaN-filled block; two fm-terms or embed-bag calls must be
   bit-equal, at B 4096 and B 128; the ragged backward's sums have no
   fixed order and are not), with CUDA-event times of kernel, plain
   version, the same call with next to no work (the embed-bag and
   fm-terms kernels, forward and backward, at B 1 K 1; each ragged
   forward and backward with nnz_used = 0) and, where one PyTorch call
   computes the same function, that call; the ragged-gather forward and
   backward at the field-aware FM's shape (D = 40 x 4 over 4096 x 40
   segments, F 2^18, segments unsorted within a row), with a sparse CSR
   product as the library call, and the backward at the CLI's FFM
   defaults (D = 640, F 2^20, a 2.7 GB gradient) on the same batch;
   then the fused Adam and FTRL kernels (kernels/optim.cu)
   over every parameter of FM, DCNv2 (and logreg, FTRL) at 2^20
   features, 8 steps against their plain versions (rtol 1e-6, atol
   1e-7), timed beside a launch over no tensors, the plain version and,
   for Adam, torch.optim.Adam (foreach, and fused + capturable);
4. serving — FactorizationMachine(num_features=2^20, dim=32) from seeded
   weights, saved and restored through the port's CheckpointManager and
   served by InferenceEngine (every bucket one captured CUDA graph) +
   MicroBatcher in padded and ragged mode with sigmoid scores: 72
   requests per mode from 8 threads, every answer held against the plain
   path on the card and a few against a float64 numpy FM; then a
   hot-reload to a second step, and one row-major forward.  The kernels'
   launch counts are read around this phase; a predict of the largest
   request is split into pad, H2D, replay (host enqueue, synchronised,
   device) and copy-out;
   server  — the same model and checkpoint behind PredictionServer
   (warm-up captures every bucket), padded and ragged: phase 4's
   requests through PredictClient from 8 connections, held against the
   plain path on the card (rtol = atol = 1e-5), a replay against the
   eager kernel path on the same batch, run_load at 2^20 features (2000
   requests of 128 rows at 8 connections one in flight each, and 2000
   of 4 rows at 8 connections 8 in flight each: qps, rows/s, latency
   quantiles, overloads, and the server's own metrics: engine calls and
   queue-to-answer quantiles), on the padded server also from the load
   generator's command line in a process of its own, a hot-reload to
   step 2 while one request streams (no failure, one switch, the last
   answers step 2's plain scores), and the breakdown again.  This
   slice's main path: the launch counts are read around it and must be
   one a call of each ragged-gather forward plus one a capture's
   warm-up;
   exporter — the same model, checkpoint and padded requests behind
   PredictionServer(metrics_port=0) with DMLC_SLO_SPEC: with a plain and
   a burn-rate rule that must fire (DMLC_SLO_INTERVAL 0.5 s, the
   sampler's DMLC_TIMELINE_INTERVAL 0.25 s), run_load's load 1 while a
   scraper reads /metrics, /spans and /timeline each second: /healthz
   must turn degraded within two SLO intervals of the first breach, both
   rules fire, /metrics parses as text format 0.0.4 and counts the
   requests and batches run_load and the batcher counted, /timeline
   holds a point of serving.latency_s.p99 a sampler tick; with two rules
   that cannot fire, 32 traced predicts (three against a float64 FM)
   whose server and engine spans /spans holds under the client's trace
   ids, and /healthz ok over three SLO intervals; then load 1 in eight
   blocks of one process, off, on, on, off, ... (off: no exporter,
   sampler or monitor; on: exporter, sampler at its default 1 s, the
   monitor, a scraper of /metrics at 1 Hz), with the process's CPU time
   a request, and the host's time to render one /metrics page and of
   one sampler tick.  Launch counts are read around
   it and must be one a call of each ragged-gather forward plus one a
   capture's warm-up;
   incident — the same model and checkpoint behind PredictionServer with
   DMLC_FLIGHT_DIR, DMLC_TRACE_SAMPLE=0.01 and metrics_port=0 (the
   flight recorder's window set to 2 s): (a) with DMLC_SLO_SPEC
   serving.latency_s:max=0 and DMLC_FAULT_SPEC shedding the first 5
   admissions, run_load's load 1: /events holds one serving.request
   event a request sent (the 5 sheds too), every field in FIELDS; the
   sampler decides one trace an engine call; one bundle a window (an
   injected_fault one, then slo_breach ones, each with incident.json,
   trace.json, log_tail.txt and timeline.json where the history had
   series); /flight returns a bundle inline; /metrics has the 11
   dmlc_serving_engine_* families, batches equal to the engine calls;
   (b) 400 traced predicts from one PredictClient with sheds and 30 ms
   admission stalls injected and DMLC_TRACE_KEEP_SLOW_MS=20: each
   trace's verdict, worked out from its records, is kept exactly when
   it errored, ran slow or falls under the hash floor; the recorder
   holds exactly the kept traces, kept + dropped = 400, the errored
   traces are those /events shows shed; (c) python -m
   dmlc_core_tpu_torch.serving.server (the same FM on the card) sent
   SIGTERM leaves a fatal_signal bundle and dies by the signal; (d) load
   1 in eight blocks, the sampler off, on, on, off, ... (wide events in
   both), with the process's CPU time a request; (e) the host's time of
   a wide event, of an engine span with and without the sampler, of the
   record the sampler no longer builds on the batcher's thread, and of
   a bundle and a dump.  Launch counts are read around (a), (b) and (d)
   and must be one a call of each ragged-gather forward plus one a
   capture's warm-up; the process's hooks, signal handlers, sampler and
   recorder are put back after it; each bundle carries profile.txt,
   diagnosis.json and diagnosis.txt, and critical_path.txt and
   profile_diff.txt where it has their sections, and the bundles' gaps
   are taken at each dump's start;
   diagnose — the same model and checkpoint behind PredictionServer with
   metrics_port=0, DMLC_FLIGHT_DIR and DMLC_SLO_SPEC (a p99 rule on the
   load's client latency that fires only under the planted stall):
   (a) after warm-up the capture watchdog counts one capture a bucket
   (xla.compiles 9) and no alert, each later call a hit, a 133-row
   request a ladder miss that latches the alert; /metrics has the JAX
   server's dmlc_xla_* families for the ladder; sample_memory's gauges
   equal memory_stats and mem_get_info; (b) load 1 as traced predicts
   from 8 PredictClients: /profile?seconds=1 (the baseline) holds the
   batcher's thread in the engine's replay and copy-out, /analyze?top=5's
   paths each sum to their root with serving.engine.forward among the
   names; (c) DIAG_FAULT (a 200 ms stall at every admission) installed
   mid-load: the breach's bundle carries profile.txt, critical_path.txt,
   profile_diff.txt, diagnosis.json (trigger breach) and diagnosis.txt,
   the planted cause is among its top 3 suspects, a bare /diagnose
   answers about the breach, /profile?diff=1 shows the admission's sleep
   grown; (d) the host's time of each bundle section, of a bundle and a
   dump with and without them, of /analyze and /diagnose over the ring
   and of a watchdog hit, and load 1 in eight blocks with the watchdog
   and an /analyze + /diagnose scraper off, on, on, off, ...  16 answers
   over TCP and in process are held against the plain path (rtol = atol
   = 1e-5).  Launch counts are read around it and must be one a call of
   each ragged-gather forward plus one a capture's warm-up;
   feed    — the host feed's stages apart over the training file: python
   and native parse, streampack, python and native pack (ms per
   4096-row batch), the H2D copy and device decode of each fused batch
   (CUDA events; the card's decode array_equal to the CPU's), and each
   loader on its own;
   io      — the I/O layer: the training file cut into 4 files and an
   empty one in a directory; the card's batches from the directory, a
   ; list and a glob array_equal to the single file's, on the native and
   streampack paths; DeviceLoader(cache="auto") over dir#cache for 4
   epochs (epoch 1 parses, packs and writes the page file through;
   epochs 2-4 replay it and must be array_equal on the card to epoch 1;
   ms a batch, the wait in next_batch and the page-file bytes read); a
   touched source file and a truncated page file must each rebuild,
   never serve; the flat FM and DeepFM steady state (4 epochs) with and
   without the page file; FactorizationMachine(2^20, dim 32) flat, 8 Adam
   steps with save_async at step 4 while steps 5-8 run, per step and
   through FusedTrainer(k=4) (the save between the two replays): each
   checkpoint restores to parameters and moments array_equal (and is
   byte-equal) to a synchronous save of a clone taken at the same step;
   the host time of the save_async call against save, there and at the
   CLI's FFM size (8 GB), with the card's peak memory.  Launch counts are
   read around its training;
5. training — six paths: DCNv2(2^20, dim=32, layers=3) and
   DeepFM(2^20, dim=32, layers=2) on row-major and flat batches,
   FactorizationMachine(2^20, dim=32) on flat and row-major batches:
   seeded libsvm text, labelled by a planted linear model, through the
   port's native parser and DeviceLoader (engine="native"; the native
   packer on the flat layout, in nnz buckets), 8 Adam(1e-3) steps of
   4096 rows on the kernels, held against the same seeded model on the
   plain path on the same batches (one step's gradients at rtol = atol
   = 1e-5 and within 1e-4 of each parameter's largest gradient, the
   per-step losses at rtol = 1e-4 and within a tenth of their drift,
   the trained parameters within 1e-3 of how far they moved,
   evaluate_stream accuracy within one row and AUC within 1e-4) and
   against the planted model (the eval AUC of each row's change in
   score over the 8 steps at least LEARN_AUC_MIN), with steps/s over
   the 8 steps and in steady state over 4 epochs, the consumer's wait
   in next_batch per step, the device's per-step breakdown and its idle
   share.  Launch counts are read around each path; the six paths run
   the port's fused Adam;
   ffm — FieldAwareFM(2^18, 40 fields, dim 4), the repo's
   bench_ffm_train, on the same rows as libfm text (id j in field
   j % 40) through DeviceLoader(fields=True): 8 Adam steps on the flat
   layout and 8 on the row-major (k_cap 64), with phase 5's checks
   (learning included), steady state and per-step breakdown, and the
   forward's bucket sum G (the ragged-gather kernel at D = 160) and
   cross term timed apart.  Its launch counts must show the ragged-
   gather forward and backward;
   kstep — the k-step trainer: DCNv2, DeepFM and FM flat (Adam) and
   SparseLogReg flat (FTRL), 2^20 features, through DeviceLoader(emit=
   "host") and FusedTrainer(k=8): the epoch's 8 batches are one replay of
   one captured CUDA graph, held against the same seeded model on the
   plain path, eager and one step a batch, with phase 5's checks
   (learning included), then again at k=3 (graphs of 3 and 2 steps);
   steps/s over the 8 steps (the capture apart) and in steady state over
   4 epochs, the host's time a dispatch, the device's time of a replay
   and its idle share; a replay counts the launches its graph recorded
   at capture;
6. cli — the port's dmlc-train (python -m dmlc_core_tpu_torch.models.cli)
   in subprocesses: DeepFM at the same width trained 8 steps on the card
   with a validation file and a checkpoint, then mode=predict on the
   eval file; the 8192 printed scores must match the restored
   checkpoint's scores on the plain path within 2e-6; then the same
   training with kstep=8, whose checkpoint must match the kstep=1 one's
   (each parameter within 1e-3 of how far it moved).  Each wall is
   split into the interpreter's start and imports and the CLI's own
   stages (set-up, build checks, optimizer set-up, first batch, steps,
   ...); the port's server (python -m dmlc_core_tpu_torch.serving.server
   model=deepfm) on the trained checkpoint scores the eval file's first
   512 rows over TCP, within 2e-6 of mode=predict's scores, and stops on
   SIGINT; DeepFM again on data=<dir>#cache (the [io] directory) with
   epochs=2 ckpt_every=4 (the second epoch from the page file, every
   checkpoint a save_async), then mode=predict from its last checkpoint,
   within 2e-6 of it on the plain path; dmlc-train model=ffm at its
   defaults (2^20 features, 40 fields, dim 16: D = 640 in the kernels,
   8 GB of parameters and Adam moments) for 8 steps on the libfm file
   with ckpt_every=4 (save_async at steps 4 and 8), then mode=predict, and
   dmlc-train model=fm format=csv on seeded 32-column csv (label column
   0 from the URI), each prediction within 2e-6 of its restored
   checkpoint on the plain path; a fresh interpreter times building a
   torch.optim.Adam;
   remote — the port's main path against an object store that this
   script runs on loopback (path-style S3 with SigV4 checked, ranged
   GET, multipart uploads, and a WebHDFS namenode and datanode; every
   object a file under the data directory): [io]'s training files
   uploaded to s3://bucket/train/, the card's batches from there
   array_equal to the local directory's on the native and streampack
   paths, again under DMLC_FAULT_SPEC='s3.request:error=0.2:seed=7'
   (faults fired, the retries absorbed them); FM(2^20, 32) flat trained
   from s3:// with phase 5's checks (learning included), and its steady
   state from s3:// and from the local directory in turns (steps/s, the
   wait in next_batch, the feed's MB/s: this Python server's, not S3's);
   save_async of FM + Adam (415 MB) at step 4 to S3 (multipart parts,
   byte-equal to a local save of a clone) and to WebHDFS (temp name
   renamed), each restored array_equal in a fresh CheckpointManager;
   dmlc-train model=fm data=s3:// ckpt_dir=s3:// and mode=predict
   output=s3:// in subprocesses, the scores read back from the store
   within 2e-6 of the restored checkpoint on the plain path; a
   PredictionServer restored from s3:// answering 256 requests, each
   against in-process predict (1e-5) and mode=predict (2e-6), then
   again under DMLC_FAULT_SPEC='serving.server.admit:error=1:times=5':
   exactly 5 OVERLOADED, every request answered by the client's
   retries.  Launch counts are read around its training and serving;
   ingest — disaggregated ingest at full width (FM flat, 2^20 x 32,
   4096-row batches, nnz_cap 131072, Adam 1e-3) on the training text:
   every batch of it and of a raw-value file (no dictionary) through the
   native packer and streampack, v2 and v3; on the card the v3 decode
   kernel's batch array_equal to the v2 batch and to the plain v3 decode
   (wire bytes, pack ms, decode and H2D us per batch); ingest workers as
   processes of their own (python -m dmlc_core_tpu_torch.pipeline.
   ingest_service): two epochs from two workers hold the local loader's
   multiset of rows; FM trained from one worker against the local loader
   with phase 5's checks, from two workers per step and through
   FusedTrainer(k=8) (learning, steps/s, the wait in next_batch, the
   distinct v3 metas and captured graphs); dmlc-train workers= with
   kstep=8 and per step (learning; mode=predict within 2e-6 of the
   checkpoint) and model=ffm workers= exiting 2; a reader fault
   (ingest.reader.restarts, every row still read); serve_ingest with
   DMLC_AUTOTUNE=1 until its tuner converges and persists; the loader's
   steady state with v2 and v3 and with put_threads 1 and 2, in turns.
   Launch counts are read around the training from workers.  Every
   earlier phase's loaders run at the defaults: the v3 wire on the card.
   mesh    — data-parallel training (fit_stream(mesh=)) at full width:
   FM and DCNv2 flat (nnz_cap 131072) and DeepFM and DCNv2 row-major
   (k_cap 64; DCNv2's row-major path is the embed bag's), 2^20 x 32,
   Adam 1e-3, 4096-row global batches, on the training text.  (a) World
   1 over NCCL in this process: every collective on card tensors against
   numpy; 8 steps through the sharded loader against the no-mesh steps
   on the same batches (phase 5's limits: the backward kernels add with
   atomics, so two no-mesh runs differ too, and both gaps are printed;
   on the plain path with deterministic algorithms the mesh's steps are
   array_equal to the no-mesh ones), the k = 8 mesh form of
   make_train_step_kbatch (one captured graph, its all-reduces inside)
   against the 8 mesh steps, evaluate_stream with and without the mesh,
   steps/s over the 8 steps and in steady state with and without the
   mesh, and the all-reduce's ms for the step's bytes.  (b) World 2 over
   gloo: two processes of this script (--mesh-rank), both on cuda:0
   (NCCL refuses two ranks on one card), each reading its partition of
   the training and eval files (2048-row batches, nnz_cap 65536): every
   collective on card tensors (gloo lacks all_to_all there: the line
   says so); each path's parameters array_equal across the ranks, within
   phase 5's limits of one process's steps on the ranks' concatenated
   batches, learning (the eval AUC of the change in score, at least
   LEARN_AUC_MIN), evaluate_stream(mesh=) over both partitions; steps/s
   and the all-reduce's ms.  Then, over the same two processes, the
   sharded paths (4096-row batches, each rank reading all of them):
   mp=2 dim (FM flat, DCNv2 row-major, FFM flat at [ffm]'s shape through
   a sharded fields=True loader), mp=2 rows (FM flat, DeepFM row-major)
   and pp=2 (DeepFM row-major, its tower pipelined in 4 microbatches),
   each placed by shard_params and trained by fit_stream(mesh=): the
   gathered parameters (the replicas among them) array_equal across the
   ranks and within phase 5's limits of one process's no-mesh steps on
   the same batches (both gaps printed), learning at least
   LEARN_AUC_MIN, evaluate_stream(mesh=), each path launching every
   kernel of its model and layout, steps/s, and the bytes and ms of the
   forward's collectives, each timed alone.  Both must launch every
   kernel of the paths;
   tracker — the reference's distributed flow (the JAX
   examples/distributed_logreg.py) on the card: python -m
   dmlc_core_tpu_torch.parallel.tracker with a journal and its fleet
   pages, two ranks (processes of this script, gloo on cuda:0) that take
   their ranks from it through RabitContext.from_env() (heartbeats every
   0.25 s, telemetry pushes every 0.5 s), rank 0 broadcasting the mesh's
   rendezvous and the seed over rabit; each rank trains FM flat at full
   width over its partition (2048 rows a rank) with fit_stream(mesh=)
   for three epochs, and after each all-reduces [sum of w * bce, sum of
   w, batches] over rabit (equal to the mesh's all-reduce of the same,
   relative 1e-6) and all-gathers a digest of its parameters (equal on
   every rank); after epoch 1 the same steps as one
   make_train_step_kbatch(mesh=) call (over gloo, eager) and one captured
   call with no mesh, while a thread pushes telemetry (a push in flight
   during the captured call).  The tracker's /metrics (the merged loader counter the sum
   of its rank series), /stragglers, /timeline and /diagnose are read
   while the ranks train; then it is SIGKILLed during epoch 2, kept down
   at least 4 heartbeats and restarted on its port and journal: it must
   have replayed at least 3 records, re-admit each rank from its
   unchanged listener at its rank and generation 0, and get both ranks'
   pushes; each rank counts heartbeat failures, epoch 3 runs, both
   shutdown() against it, and SIGTERM stops it with exit 0 and a
   compacted journal.  Learning (at least LEARN_AUC_MIN), rank 0's AUC
   broadcast, one process's steps on the union batches within phase 5's
   limits, every kernel of the path launched on every rank; rendezvous
   seconds, rabit's ms, the downtime, steps/s;
   elastic — the JAX examples/elastic_train.py flow on the card: the
   port's launcher as a process (python -m
   dmlc_core_tpu_torch.parallel.launcher.submit --cluster gpu -n 3
   --elastic --max-attempts 2), three ranks (processes of this script,
   gloo on cuda:0) running the port's examples/elastic_train.py at full
   width (FM 2^20 x 32, Adam, FusedTrainer(k=8) over
   DeviceLoader(emit="host"), 4096-row batches of its partition, three
   epochs, the state averaged over rabit at each sync point) with
   ElasticTorchMesh; rank 2 exits 7 after epoch 1's compute and the
   launcher respawns it, the cohort rebuilds its process group at
   generation 1 and the reborn rank receives the whole state from the
   survivors through the resharder.  After each sync point every rank
   all-reduces and all-gathers known vectors over the generation's mesh.
   Checks, each beside its limit: the launcher exits 0, the victim
   exited 7 once; every epoch once on every rank, one loss and one
   state digest an epoch, generation 1 from epoch 1's sync; no
   checkpoint read, the reborn rank's leaves and bytes from peers the
   state's; the data plane's sums exact in both generations; learning
   (at least LEARN_AUC_MIN) of the final averaged model; every kernel of
   the path launched on every rank's last incarnation.  Numbers: the
   reshard's s, MB and MB/s, s from the victim's exit to generation 1
   on every rank, the data plane's teardown and init s, the averaging s
   of a sync point, steps/s a rank by epoch, the phase's s;
   probe   — the transfer probe (pipeline/probe.py) over the training
   file 4 times (32 batches a pass): DeviceLoader batches/s for
   put_threads 1 and 2 x v2 and v3 in 5 alternating rounds after a warm
   pass of each wire, the winner persisted (DMLC_TUNED_CONFIG in the data
   directory) and what resolve("cuda", "auto", "auto") returns; then
   FusedTrainer(k=8) of FM flat on the resolved wire and on the other,
   epoch by epoch in turns (steps/s).
   trace   — last, since a torch.profiler capture leaves every later
   launch of the process slower: spans and traces.  (a) 64 predicts from
   one PredictClient to an in-process PredictionServer (FM 2^20 x 32,
   padded ladder, every bucket a captured graph): each client span's
   trace holds exactly one serving.server.request child, ended OK, and
   one serving.engine.forward grandchild; each name's span count and
   p50 / p99 duration; (b)
   profile_trace (torch.profiler, the host's threads and the card) over
   4 flat FM steps (Adam, the native packer's v3 wire) from DeviceLoader:
   the Chrome trace must name the kernels of ragged_gather.cu,
   ragged_gather_grad.cu, wire_decode.cu and Adam's of optim.cu by their
   __global__ symbols, and the loader's device_loader.pack and .h2d
   ranges; the steps' five largest device ops, the device's busy share
   of their window and its five longest idle gaps, each with the host
   range open during it; (c) the recorded spans written by
   write_chrome_trace and read back; (d) the host cost of an empty span
   (100,000 calls) and of a trace_span range.  Launch counts are read
   around (a) and (b).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is one JSON object with each kernel's numbers.  Runs with no card, or
without the package beside it, exit non-zero.

    python3 chip_smoke.py --plant dtable|forward

plants a fault on the kernel path (a zeroed table gradient, or a zeroed
forward, of the D = 32 tables, in every kernel family) and runs phases
1, 2 and 5 only; it exits 0 only if phase 5's checks catch the fault on
every path.

    python3 chip_smoke.py --serving

runs phases 1, 2, 4, the server, the exporter, the incidents and the
diagnosis only, and prints their numbers as its last line.

    python3 chip_smoke.py --mesh

runs phases 1, 2, [mesh] and [probe] only, and prints their launch
counts as its last line.

    python3 chip_smoke.py --tracker

runs phases 1, 2 and [tracker] only (with ``--mesh-nccl W``, its cohort
over NCCL on W cards).

    python3 chip_smoke.py --elastic

runs phases 1, 2 and [elastic] only.

    python3 chip_smoke.py --mesh-nccl 4

runs phases 1, 2, [mesh] (b), [tracker] and [elastic] over NCCL on 4
cards, rank r
on cuda:r (1024-row batches a rank, nnz_cap 32768), and needs them; there
each
path's steps also run as one captured make_train_step_kbatch call (its
all-reduces across the ranks inside the graph), held to phase 5's limits
of the mesh steps and array_equal across the ranks.  Its sharded paths
are dp=2,mp=2 in both modes (FM flat, DeepFM row-major) and dp=2,pp=2
(DeepFM row-major), 2048-row batches a dp slice, with the same checks
and the captured k-step form.  [tracker]'s cohort is then four ranks,
its make_train_step_kbatch(mesh=) call captured, and /stragglers must
judge every rank (its board needs three).  [elastic]'s cohort is four NCCL ranks
(8192 rows a rank), the victim still rank 2: the survivors' generation 0
communicators, which hold the dead rank, are aborted.

``CHIP_SMOKE_TRACE_DIR`` keeps [trace]'s Chrome traces in that
directory (by default they go with the data directory).
``CHIP_SMOKE_ELASTIC_DIR`` keeps [elastic]'s launcher output and the
ranks' records in that directory.
``tools/trace_ab.py`` measures what the spans cost against another
checkout.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F_FEATURES = 1 << 20
DIM = 32
CAP, ROWS = 8192, 128            # the ladders' largest bucket
B_RM, K_RM = 128, 64             # row-major batch: the ladder's nnz_per_row
# training batches (benchmarks/bench_suite.py bench_dcn_train and the
# row-major integrity config): 4096 rows, k_cap 64 or nnz_cap 131072
ROWS_TR, K_TR, CAP_TR = 4096, 64, 131072
LAYERS = 3                       # DCNv2's cross layers
DEEPFM_LAYERS = 2                # bench_suite.py bench_deepfm_train
LR = 1e-3
TRAIN_STEPS = 8
EVAL_ROWS = 2 * ROWS_TR
BAD_IDS = [-1, -F_FEATURES - 3, F_FEATURES, F_FEATURES + 7]
SPIN_CYCLES = 100_000_000        # device spin that covers a step's enqueue
FEED_EPOCHS = 3                  # passes of the [feed] timings
STEADY_EPOCHS = 4                # passes of each path's steady-state run
HOT_IDS = 64                     # the planted model's ids
RTOL = ATOL = 1e-5               # kernel vs plain version, same f32 inputs
ATOL_F64 = 1e-4                  # f32 scores vs a float64 FM (sums of up
                                 # to 8192 f32 terms)
# the field-aware FM (benchmarks/bench_suite.py bench_ffm_train):
# FieldAwareFM(2^18 hashed features, 40 fields, dim 4) over libfm text
# whose fields are j % 40; its bucket sum is the ragged gather at
# D = 40 * 4 over 4096 * 40 segments
F_FFM, NF_FFM, DIM_FFM = 1 << 18, 40, 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- timing -----------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call on the device, each call after
    an L2 flush (serving requests find the gathered table rows cold).
    A spin kernel queued ahead of each call keeps the device busy while
    the host enqueues it, so the events time the device's work and not
    the host's launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 30, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 + 2 ------------------------------------------------------------

def phase_device(torch) -> str:
    line = smi_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} count {torch.cuda.device_count()}")
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need an sm_90 card, got capability {cap}")
    return line


def phase_build() -> None:
    from dmlc_core_tpu_torch.kernels import build
    from dmlc_core_tpu_torch.native import build as native_build
    t0 = time.monotonic()
    native = {}
    th = threading.Thread(target=lambda: native.update(
        out=native_build.build_native(force=True)))
    th.start()
    try:
        took = build.build_all(force=True)
    finally:
        th.join()
    ok, report = native["out"]
    if not ok:
        raise RuntimeError(f"the native library failed to build: {report}")
    log(f"[build] {len(took)} kernels in {time.monotonic() - t0:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in took.items()))
    log(f"[build] native: {report}")
    for name in took:
        for ln in (build.ptxas_report(name) or "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")


# -- phase 3 ----------------------------------------------------------------

def _ragged_inputs(torch, rng, fill: int):
    """A capacity batch: ``fill`` live entries over ROWS sorted rows,
    then a garbage tail (NaN values, hostile segments, ids past the
    table) that no result may see."""
    ids = rng.integers(0, F_FEATURES, CAP).astype(np.int32)
    vals = rng.random(CAP, dtype=np.float32)
    segs = np.sort(rng.integers(0, ROWS, CAP)).astype(np.int32)
    vals[fill:] = np.nan
    segs[fill:] = rng.choice(np.array([-5, ROWS + 9], np.int32), CAP - fill)
    ids[fill:] = F_FEATURES + 3
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return (dev(ids), dev(vals), dev(segs),
            torch.tensor([fill], dtype=torch.int32, device="cuda"))


def _close(name, got, ref, exact_zero=False):
    torch = sys.modules["torch"]
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact_zero:
        if bool((got != 0).any()):
            raise RuntimeError(f"{name}: zero fill gave non-zero output")
    elif not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"{name}: max |err| {err:.3g} beyond rtol=atol="
                           f"{RTOL}")
    return err


def _bit_equal(name, first, second) -> None:
    """Two calls of a kernel whose every sum has a fixed order."""
    torch = sys.modules["torch"]
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{name}: two calls differ")


def phase_kernels(torch, timer: Timer, power: str) -> dict:
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (fm_terms, fm_terms_reference,
                                             ragged_gather,
                                             ragged_gather_reference)
    rng = np.random.default_rng(SEED)
    results = {}
    # what the Timer reads for one launch that does next to nothing: the
    # floor under every kernel time below (a wrapper that zeroes its
    # outputs first pays it twice)
    floor_ms = timer.ms(lambda: torch.zeros(1, device="cuda"))
    log(f"[kernels] timer floor: one torch.zeros(1) launch {floor_ms:.4f} "
        f"ms [{power}]")
    with torch.inference_mode():
        zero_fill = {}          # (name, D) -> the fill-0 call: the floor
        for D, variants in ((DIM, (True, False)), (1, (False,))):
            table = torch.from_numpy(rng.standard_normal(
                (F_FEATURES, D), dtype=np.float32) * 0.05).cuda()
            for fill in (0, 3031, CAP):             # 0 %, ~37 %, 100 %
                ids, vals, segs, nnz = _ragged_inputs(torch, rng, fill)
                live_rows = int(torch.unique(ids[:fill]).numel())
                for fm in variants:
                    name = "ragged_gather_fm" if fm else "ragged_gather_embed"
                    run = lambda: ragged_gather(  # noqa: E731
                        ids, vals, segs, nnz, table, ROWS, fm=fm,
                        engine="kernel")
                    plain = lambda: ragged_gather_reference(  # noqa: E731
                        ids, vals, segs, nnz, table, ROWS, fm=fm)
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = 0.0
                    for g, w in zip(got, want):
                        if g is not None:
                            err = max(err, _close(f"{name} D={D} "
                                                  f"fill={fill}", g, w,
                                                  exact_zero=fill == 0))
                    ms, plain_ms = timer.ms(run), timer.ms(plain)
                    nout = 2 if fm else 1
                    nbytes = (live_rows * D * 4 + 12 * fill + 4
                              + nout * (ROWS + 1) * D * 4)
                    b_ms, b_by = bound(nbytes, (4 if fm else 2) * fill * D)
                    lib_ms = None
                    if not fm and fill == CAP:
                        # one PyTorch call computing the same embed sum
                        offsets = torch.searchsorted(
                            segs, torch.arange(ROWS, dtype=torch.int32,
                                               device="cuda"),
                            out_int32=True)
                        lib = lambda: Fn.embedding_bag(  # noqa: E731
                            ids, table, offsets, mode="sum",
                            per_sample_weights=vals)
                        _close(f"embedding_bag D={D}", lib(), want[0][:ROWS])
                        lib_ms = timer.ms(lib)
                    log(f"[kernels] {name} cap={CAP} rows={ROWS} D={D} "
                        f"fill={fill}: kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, embedding_bag "
                        f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                        f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.3g} "
                        f"[{power}]")
                    if fill == 0:
                        zero_fill[name, D] = ms
                    # the serving path runs the fm variant at D=32 and the
                    # embed variant (linear term) at D=1, at full fill
                    if fill == CAP and (fm or D == 1):
                        results[name] = dict(
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            max_abs_err=err, floor_ms=zero_fill[name, D])
            del table

        # row-major FM terms at the ladder's nnz_per_row
        table = torch.from_numpy(rng.standard_normal(
            (F_FEATURES, DIM), dtype=np.float32) * 0.05).cuda()
        ids_np = rng.integers(0, F_FEATURES, (B_RM, K_RM)).astype(np.int32)
        vals_np = rng.random((B_RM, K_RM), dtype=np.float32)
        ids, vals = (torch.from_numpy(ids_np).cuda(),
                     torch.from_numpy(vals_np).cuda())
        got = fm_terms(ids, vals, table, engine="kernel")
        want = fm_terms_reference(ids, vals, table)
        err = max(_close("fm_terms", g, w) for g, w in zip(got, want))
        _bit_equal("fm_terms", got, fm_terms(ids, vals, table,
                                             engine="kernel"))
        # out-of-range ids clamp the same way on both
        bad = ids.clone()
        bad[:, :3] = torch.tensor([-1, F_FEATURES, F_FEATURES + 7],
                                  dtype=torch.int32, device="cuda")
        for g, w in zip(fm_terms(bad, vals, table, engine="kernel"),
                        fm_terms_reference(bad, vals, table)):
            _close("fm_terms out-of-range ids", g, w)
        run = lambda: fm_terms(ids, vals, table, engine="kernel")  # noqa
        plain = lambda: fm_terms_reference(ids, vals, table)  # noqa: E731
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        floor_ms = _fm_terms_floor(torch, timer, power, ids, vals, table,
                                   "serving")
        offsets = torch.arange(0, B_RM * K_RM, K_RM, dtype=torch.int32,
                               device="cuda")
        lib_s1 = lambda: Fn.embedding_bag(  # noqa: E731
            ids.reshape(-1), table, offsets, mode="sum",
            per_sample_weights=vals.reshape(-1))
        _close("embedding_bag s1", lib_s1(), want[0])
        s1_lib_ms = timer.ms(lib_s1)
        uniq = int(torch.unique(ids).numel())
        nbytes = uniq * DIM * 4 + B_RM * K_RM * 8 + 2 * B_RM * DIM * 4
        b_ms, b_by = bound(nbytes, 4 * B_RM * K_RM * DIM)
        log(f"[kernels] fm_terms B={B_RM} K={K_RM} D={DIM}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, embedding_bag (s1 only) "
            f"{s1_lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
            f"{err:.3g} [{power}]")
        results["fm_terms"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None,
                                   max_abs_err=err, floor_ms=floor_ms)
    results.update(_training_kernels(torch, timer, power, rng))
    results.update(_shard_kernels(torch, timer, power, rng))
    results.update(_ffm_kernels(torch, timer, power, rng))
    # FFM's G on a rank's columns over mp = 2 (d = 2: D = 80)
    results.update(_ffm_kernels(torch, timer, power, rng, DIM_FFM // 2,
                                "ffm_mp_dim"))
    results.update(_cli_ffm_grad(torch, timer, power, rng))
    results.update(_optimizer_kernels(torch, timer, power))
    return results


def _one_entry(ids, vals):
    """The first entry of a row-major batch as a [1, 1] batch: a call
    with next to no work."""
    return ids[:1, :1].contiguous(), vals[:1, :1].contiguous()


def _fm_terms_floor(torch, timer: Timer, power: str, ids, vals, table,
                    label: str) -> float:
    """The fm-terms forward at B 1, K 1 (held against its plain
    version): its time is the floor under the kernel's at this table."""
    from dmlc_core_tpu_torch.kernels import fm_terms, fm_terms_reference
    one = _one_entry(ids, vals)
    for a, b in zip(fm_terms(*one, table, engine="kernel"),
                    fm_terms_reference(*one, table)):
        _close(f"fm_terms ({label}) B=1 K=1", a, b)
    floor_ms = timer.ms(lambda: fm_terms(*one, table, engine="kernel"))
    log(f"[kernels] fm_terms ({label}) B=1 K=1: {floor_ms:.4f} ms [{power}]")
    return floor_ms


def _rowmajor_train_batch(torch, rng):
    """ids/vals [ROWS_TR, K_TR] with rows of 5-39 values, padding (id 0,
    value 0) after them, and the out-of-range ids in row 0."""
    counts = rng.integers(5, 40, ROWS_TR)
    ids = rng.integers(0, 1_000_000, (ROWS_TR, K_TR)).astype(np.int32)
    vals = rng.random((ROWS_TR, K_TR), dtype=np.float32)
    pad = np.arange(K_TR)[None, :] >= counts[:, None]
    ids[pad], vals[pad] = 0, 0.0
    ids[0, :4] = BAD_IDS
    return torch.from_numpy(ids).cuda(), torch.from_numpy(vals).cuda()


def _bucket(nnz: int) -> int:
    """The native packer's nnz bucket for a flat batch of ``nnz`` values
    under ``CAP_TR``: ``nnz`` rounded up to ``CAP_TR // 8``."""
    q = CAP_TR // 8
    return min(CAP_TR, max(q, -(-nnz // q) * q))


def _flat_train_batch(torch, rng):
    """A flat batch of ROWS_TR rows of 5-39 values, as the native packer
    lays it out for the training paths: in its nnz bucket of slots
    (padding: id 0, value 0, segment ROWS_TR), out-of-range ids first.
    Returns the device tensors, the live count and the row counts."""
    counts = rng.integers(5, 40, ROWS_TR)
    nnz = int(counts.sum())
    cap = _bucket(nnz)
    ids = np.zeros(cap, np.int32)
    vals = np.zeros(cap, np.float32)
    segs = np.full(cap, ROWS_TR, np.int32)
    ids[:nnz] = rng.integers(0, 1_000_000, nnz)
    ids[:4] = BAD_IDS
    vals[:nnz] = rng.random(nnz, dtype=np.float32)
    segs[:nnz] = np.repeat(np.arange(ROWS_TR, dtype=np.int32), counts)
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return dev(ids), dev(vals), dev(segs), nnz, counts


def _library_grad(torch, ids, vals, offsets, table, g):
    """``() -> dtable``: the autograd backward of ``F.embedding_bag`` on
    in-range (clamped) ids, one PyTorch call's yardstick for the
    backward kernels (it sends out-of-range ids' gradient to the
    clamped row, so it is timed, not compared)."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    t = table.detach().clone().requires_grad_()
    with torch.enable_grad():
        out = Fn.embedding_bag(clamp_ids(ids, table.shape[0]).int(), t,
                               offsets, mode="sum", per_sample_weights=vals)
    return lambda: torch.autograd.grad(out, t, g, retain_graph=True)


def _gather_case(torch, timer: Timer, power: str, label: str, fids, fvals,
                 fsegs, tab, fm: bool, nnz: int, rows_read: int,
                 foffsets=None) -> dict:
    """One ragged-gather forward at the flat training batch's shapes
    (every entry live, padding on the scratch row) against its plain
    version, timed; with ``foffsets`` (sorted segments) also the one
    PyTorch call that computes the embed sum, and the floor: the same
    call with ``nnz_used = 0`` (exact zeros)."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (ragged_gather,
                                             ragged_gather_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    Dg = tab.shape[1]
    name = "ragged_gather_fm" if fm else "ragged_gather_embed"
    run = lambda: ragged_gather(  # noqa: E731
        fids, fvals, fsegs, None, tab, ROWS_TR, fm=fm, engine="kernel")
    plain = lambda: ragged_gather_reference(  # noqa: E731
        fids, fvals, fsegs, None, tab, ROWS_TR, fm=fm)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(_close(f"{name} ({label}) D={Dg}", g, w)
              for g, w in zip(got, want) if g is not None)
    ms, plain_ms = timer.ms(run), timer.ms(plain)
    nout = 2 if fm else 1
    b_ms, b_by = bound(rows_read * Dg * 4 + 12 * fids.shape[0]
                       + nout * (ROWS_TR + 1) * Dg * 4,
                       (4 if fm else 2) * nnz * Dg)
    lib_ms = floor_ms = None
    if foffsets is not None:
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        none = lambda: ragged_gather(  # noqa: E731
            fids, fvals, fsegs, zero, tab, ROWS_TR, fm=fm, engine="kernel")
        for g, w in zip(none(), ragged_gather_reference(
                fids, fvals, fsegs, zero, tab, ROWS_TR, fm=fm)):
            if g is not None:
                _close(f"{name} ({label}) nnz_used=0", g, w,
                       exact_zero=True)
        floor_ms = timer.ms(none)
    if not fm and foffsets is not None:
        lib = lambda: Fn.embedding_bag(  # noqa: E731
            clamp_ids(fids[:nnz], tab.shape[0]).int(), tab, foffsets,
            mode="sum", per_sample_weights=fvals[:nnz])
        _close(f"embedding_bag (flat) D={Dg}", lib(), want[0][:ROWS_TR])
        lib_ms = timer.ms(lib)
    above = ("" if floor_ms is None else f" (nnz_used=0: {floor_ms:.4f} ms, "
             f"above it {ms - floor_ms:.4f} ms)")
    log(f"[kernels] {name} ({label}) cap={fids.shape[0]} nnz={nnz} rows="
        f"{ROWS_TR} D={Dg}: kernel {ms:.4f} ms{above}, plain {plain_ms:.4f}"
        f" ms, embedding_bag "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, max_abs_err=err)
    if floor_ms is not None:
        row["floor_ms"] = floor_ms
    return row


def _training_forward(torch, timer: Timer, power: str, table, fids, fvals,
                      fsegs, nnz, rows_read, foffsets) -> dict:
    """The ragged-gather forward at the flat training batch's shapes, as
    the training paths call it: fm at D=32 (FM), embed at D=1 (the
    linear terms) and at D=32 (DCNv2's x0).  Then fm and D=1 on the same
    batch with its live entries shuffled (unsorted segments), and on a
    batch whose live entries all fall in one row; that batch's values
    and table lie on a coarse dyadic grid, so every partial sum of its
    90,553-entry row is exact in float32 and any order of adds agrees
    with the plain version.  Returns ``{"<name>_train[_d32|_unsorted|
    _one_row]": numbers}``."""
    results = {}
    D = table.shape[1]
    col = lambda t: t[:, :1].contiguous()  # noqa: E731
    for fm, tab in ((True, table), (False, col(table)), (False, table)):
        name = "ragged_gather_fm" if fm else "ragged_gather_embed"
        key = f"{name}_train" + ("_d32" if not fm and tab.shape[1] == D
                                 else "")
        results[key] = _gather_case(torch, timer, power, "training", fids,
                                    fvals, fsegs, tab, fm, nnz, rows_read,
                                    foffsets)
    rng = np.random.default_rng(SEED + 7)
    perm = torch.from_numpy(np.concatenate([rng.permutation(nnz), np.arange(
        nnz, fids.shape[0])])).cuda()
    one_segs = torch.where(fsegs < ROWS_TR, 0, fsegs)
    exact_vals = torch.from_numpy(
        rng.integers(1, 5, fids.shape[0]) / 4).float().cuda() * (fvals != 0)
    exact_tab = torch.from_numpy(
        rng.integers(-4, 5, table.shape) / 64).float().cuda()
    cases = (("unsorted", fids[perm], fvals[perm], fsegs[perm], table),
             ("one_row", fids, exact_vals, one_segs, exact_tab))
    for label, ids_c, vals_c, segs_c, tab_c in cases:
        for fm, tab in ((True, tab_c), (False, col(tab_c))):
            name = "ragged_gather_fm" if fm else "ragged_gather_embed"
            results[f"{name}_train_{label}"] = _gather_case(
                torch, timer, power, label, ids_c, vals_c, segs_c, tab, fm,
                nnz, rows_read)
    del exact_tab
    return results


def _training_fm_terms(torch, timer: Timer, power: str, ids, vals, table,
                       g, rows_read: int, live: int) -> dict:
    """The fm-terms kernels at the row-major training batch's shapes
    (DeepFM and FM row-major: B 4096, K 64, D 32, F 2^20, out-of-range
    ids in row 0, padding), forward and backward, against their plain
    versions.  Returns ``fm_terms_train`` and ``fm_terms_grad``."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (fm_terms, fm_terms_grad,
                                             fm_terms_grad_reference,
                                             fm_terms_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    results = {}
    F, D = table.shape
    BK = ids.numel()
    run = lambda: fm_terms(ids, vals, table, engine="kernel")  # noqa: E731
    plain = lambda: fm_terms_reference(ids, vals, table)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(_close("fm_terms (training)", a, b) for a, b in zip(got, want))
    _bit_equal("fm_terms (training)", got, run())
    ms, plain_ms = timer.ms(run), timer.ms(plain)
    floor_ms = _fm_terms_floor(torch, timer, power, ids, vals, table,
                               "training")
    offsets = torch.arange(0, BK, K_TR, dtype=torch.int32, device="cuda")
    lib_s1 = lambda: Fn.embedding_bag(  # noqa: E731
        clamp_ids(ids, F).int().reshape(-1), table, offsets, mode="sum",
        per_sample_weights=vals.reshape(-1))
    _close("embedding_bag s1 (training)", lib_s1(), want[0])
    s1_lib_ms = timer.ms(lib_s1)
    b_ms, b_by = bound(rows_read * D * 4 + BK * 8 + 2 * ROWS_TR * D * 4,
                       4 * BK * D)
    results["fm_terms_train"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None,
                                     max_abs_err=err, floor_ms=floor_ms)
    log(f"[kernels] fm_terms (training) B={ROWS_TR} K={K_TR} D={D}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag (s1 only) "
        f"{s1_lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
        f"{err:.3g} [{power}]")

    g2 = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        (ROWS_TR, D), dtype=np.float32)).cuda()
    lib_bwd = _library_grad(torch, ids.reshape(-1), vals.reshape(-1),
                            offsets, table, g)
    s1_lib_bwd_ms = timer.ms(lib_bwd)
    del lib_bwd
    # the floor: the backward of a B 1, K 1 batch (the dense gradient is
    # still written whole)
    one = _one_entry(ids, vals)
    none = lambda: fm_terms_grad(  # noqa: E731
        *one, table, g[:1], g2[:1], False, engine="kernel")
    for a, b in zip(none(), fm_terms_grad_reference(*one, table, g[:1],
                                                    g2[:1], False)):
        if a is not None:
            _close("fm_terms_grad B=1 K=1", a, b)
    grad_floor_ms = timer.ms(none)
    log(f"[kernels] fm_terms_grad B=1 K=1 D={D}: {grad_floor_ms:.4f} ms "
        f"[{power}]")
    for need_dvals in (False, True):
        run = lambda: fm_terms_grad(  # noqa: E731
            ids, vals, table, g, g2, need_dvals, engine="kernel")
        plain = lambda: fm_terms_grad_reference(  # noqa: E731
            ids, vals, table, g, g2, need_dvals)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max(_close(f"fm_terms_grad dvals={need_dvals}", a, b)
                  for a, b in zip(got, want) if a is not None)
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        nbytes = (BK * 8 + 2 * ROWS_TR * D * 4 + rows_read * D * 4
                  + F * D * 4 + (BK * 4 if need_dvals else 0))
        b_ms, b_by = bound(nbytes, (4 + 2 * need_dvals) * live * D)
        if not need_dvals:              # the training paths ask no dvals
            results["fm_terms_grad"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err, floor_ms=grad_floor_ms)
        log(f"[kernels] fm_terms_grad dvals={need_dvals} B={ROWS_TR} "
            f"K={K_TR} D={D}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"no library call computes both terms (embedding_bag backward, "
            f"s1 half only, {s1_lib_bwd_ms:.4f} ms), bound {b_ms:.4f} ms "
            f"({b_by}), max|err| {err:.3g} [{power}]")
    return results


def _shard_kernels(torch, timer: Timer, power: str, rng) -> dict:
    """The ragged-gather fm kernels (forward and backward) at the shard
    shapes the sharded FM paths give them, on the flat training batch:
    dim mode over mp = 2 (``v`` is [2^20, 16]: every entry at D = 16)
    and rows mode over mp = 2 (``v`` is [2^19, 32]: rank 0's rows, the
    batch remapped as ``ShardPlan.local`` remaps it, the other rank's
    entries inert on the scratch row).  Each against its plain version,
    with its floor and its bound on what this batch needs.  Returns
    ``ragged_gather_fm_mp_dim``, ``ragged_gather_fm_mp_rows`` and the
    ``ragged_gather_grad_fm_`` twins."""
    from dmlc_core_tpu_torch.kernels import (ragged_gather_grad,
                                             ragged_gather_grad_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    from dmlc_core_tpu_torch.models.sharding import ShardPlan
    results = {}
    F, D = F_FEATURES, DIM
    table = torch.from_numpy(rng.standard_normal(
        (F, D), dtype=np.float32) * 0.05).cuda()
    fids, fvals, fsegs, nnz, counts = _flat_train_batch(torch, rng)
    foffsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(counts)[:-1]]).astype(np.int32)).cuda()
    plan = ShardPlan(None, "rows", {"v": "mp:0"}, F, (0, F // 2))
    rids, rvals, rsegs = plan.local(fids, fvals, fsegs, ROWS_TR)
    owned = int(((rsegs[:nnz] < ROWS_TR) & (rvals[:nnz] != 0)).sum())
    cases = (("mp_dim", "mp dim D=16", fids, fvals, fsegs,
              table[:, :D // 2].contiguous(), nnz),
             ("mp_rows", "mp rows F=2^19", rids, rvals, rsegs,
              table[:F // 2].contiguous(), owned))
    with torch.no_grad():
        for key, label, ids, vals, segs, tab, live in cases:
            Ft, Dg = tab.shape
            keep = segs[:nnz] < ROWS_TR
            rows_read = int(torch.unique(clamp_ids(ids[:nnz][keep],
                                                   Ft)).numel())
            results[f"ragged_gather_fm_{key}"] = _gather_case(
                torch, timer, power, label, ids, vals, segs, tab, True, live,
                rows_read, foffsets)
            g1, g2 = (torch.from_numpy(rng.standard_normal(
                (ROWS_TR + 1, Dg), dtype=np.float32)).cuda()
                for _ in range(2))
            floor_ms = _zero_work_grad(
                torch, timer, power,
                lambda nnz_used: ragged_gather_grad(
                    ids, vals, segs, nnz_used, tab, g1, g2, ROWS_TR,
                    need_dvals=False, engine="kernel")[1],
                tab.shape, f"fm {label}")
            run = lambda: ragged_gather_grad(  # noqa: E731
                ids, vals, segs, None, tab, g1, g2, ROWS_TR,
                need_dvals=False, engine="kernel")
            plain = lambda: ragged_gather_grad_reference(  # noqa: E731
                ids, vals, segs, None, tab, g1, g2, ROWS_TR,
                need_dvals=False)
            got, want = run()[1], plain()[1]
            torch.cuda.synchronize()
            err = _close(f"ragged_gather_grad_fm ({label})", got, want)
            ms, plain_ms = timer.ms(run), timer.ms(plain)
            b_ms, b_by = bound(12 * ids.shape[0] + 2 * (ROWS_TR + 1) * Dg * 4
                               + Ft * Dg * 4 + rows_read * Dg * 4,
                               6 * live * Dg)
            results[f"ragged_gather_grad_fm_{key}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err, floor_ms=floor_ms)
            log(f"[kernels] ragged_gather_grad_fm ({label}) cap="
                f"{ids.shape[0]} live={live} rows={ROWS_TR} F={Ft} D={Dg}: "
                f"kernel {ms:.4f} ms (nnz_used=0: {floor_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, no library call computes both terms, "
                f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.3g} "
                f"[{power}]")
            del g1, g2, got, want
    return results


def _zero_work_grad(torch, timer: Timer, power: str, call, shape,
                    label: str) -> float:
    """``call(nnz_used) -> dtable``, one ragged backward at a path's
    shape, with ``nnz_used = 0``: after a freed NaN-filled block of the
    gradient's ``shape``, so the caching allocator may hand it back, the
    gradient must be exact zeros (the launcher writes every element,
    whatever the memory held).  Returns the call's time, the floor under
    the kernel's time at this shape (at D > 1: every row stored as
    zeros by its owner, and the passes over no entries)."""
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    poison = torch.full(shape, float("nan"), device="cuda")
    torch.cuda.synchronize()
    ptr = poison.data_ptr()
    del poison
    got = call(zero)
    torch.cuda.synchronize()
    if not bool((got == 0).all()):
        raise RuntimeError(f"ragged_gather_grad ({label}) nnz_used=0: not "
                           "all zeros after a NaN-filled allocation")
    where = "the freed NaN block" if got.data_ptr() == ptr else "a new block"
    del got
    floor_ms = timer.ms(lambda: call(zero))
    log(f"[kernels] ragged_gather_grad ({label}) nnz_used=0: "
        f"{floor_ms:.4f} ms, exact zeros in {where} [{power}]")
    return floor_ms


def _training_kernels(torch, timer: Timer, power: str, rng) -> dict:
    """The embed-bag kernels (forward and backward) and the ragged-gather
    kernels (forward and backward) at the training paths' shapes,
    against their plain versions, with out-of-range ids and padding in
    the inputs."""
    from torch.nn import functional as Fn

    from dmlc_core_tpu_torch.kernels import (embed_bag_forward,
                                             embed_bag_grad,
                                             embed_bag_grad_reference,
                                             embed_bag_reference,
                                             ragged_gather_grad,
                                             ragged_gather_grad_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids
    results = {}
    F, D = F_FEATURES, DIM
    table = torch.from_numpy(rng.standard_normal(
        (F, D), dtype=np.float32) * 0.05).cuda()
    ids, vals = _rowmajor_train_batch(torch, rng)
    g = torch.from_numpy(rng.standard_normal(
        (ROWS_TR, D), dtype=np.float32)).cuda()
    BK = ROWS_TR * K_TR
    live = int((vals != 0).sum())
    rows_read = int(torch.unique(clamp_ids(ids, F)).numel())
    offsets = torch.arange(0, BK, K_TR, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        # the same call with next to no work (B 1, K 1): what a launch of
        # this kernel costs on the Timer
        one = _one_entry(ids, vals)
        _close("embed_bag B=1 K=1", embed_bag_forward(*one, table,
                                                      engine="kernel"),
               embed_bag_reference(*one, table))
        bag_floor_ms = timer.ms(lambda: embed_bag_forward(*one, table,
                                                          engine="kernel"))
        for square in (False, True):
            run = lambda: embed_bag_forward(  # noqa: E731
                ids, vals, table, square, engine="kernel")
            plain = lambda: embed_bag_reference(  # noqa: E731
                ids, vals, table, square)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = _close(f"embed_bag square={square}", got, want)
            _bit_equal(f"embed_bag square={square}", [got], [run()])
            # B 128 takes the launcher's k split
            few = (ids[:B_RM].contiguous(), vals[:B_RM].contiguous())
            got_few = embed_bag_forward(*few, table, square, engine="kernel")
            _close(f"embed_bag square={square} B={B_RM}", got_few,
                   embed_bag_reference(*few, table, square))
            _bit_equal(f"embed_bag square={square} B={B_RM}", [got_few],
                       [embed_bag_forward(*few, table, square,
                                          engine="kernel")])
            ms, plain_ms = timer.ms(run), timer.ms(plain)
            b_ms, b_by = bound(rows_read * D * 4 + BK * 8 + ROWS_TR * D * 4,
                               (3 if square else 2) * BK * D)
            lib_ms = None
            if not square:
                lib = lambda: Fn.embedding_bag(  # noqa: E731
                    clamp_ids(ids, F).int().reshape(-1), table, offsets,
                    mode="sum", per_sample_weights=vals.reshape(-1))
                _close("embedding_bag (row-major)", lib(), want)
                lib_ms = timer.ms(lib)
                # the training path runs square=False
                results["embed_bag"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, max_abs_err=err, floor_ms=bag_floor_ms)
            log(f"[kernels] embed_bag square={square} B={ROWS_TR} K={K_TR} "
                f"D={D}: kernel {ms:.4f} ms (B=1 K=1: {bag_floor_ms:.4f} "
                f"ms, above it {ms - bag_floor_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, embedding_bag "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g}; bit-equal "
                f"across two calls at B={ROWS_TR} and B={B_RM} [{power}]")

        lib_bwd = _library_grad(torch, ids.reshape(-1), vals.reshape(-1),
                                offsets, table, g)
        # the floor: the backward of the B 1, K 1 call (the dense
        # gradient is still written whole)
        none = lambda: embed_bag_grad(  # noqa: E731
            *one, table, g[:1], False, False, engine="kernel")
        for a, b in zip(none(), embed_bag_grad_reference(
                *one, table, g[:1], False, False)):
            if a is not None:
                _close("embed_bag_grad B=1 K=1", a, b)
        bag_grad_floor_ms = timer.ms(none)
        log(f"[kernels] embed_bag_grad B=1 K=1 D={D}: "
            f"{bag_grad_floor_ms:.4f} ms [{power}]")
        for square in (False, True):
            for need_dvals in (False, True):
                run = lambda: embed_bag_grad(  # noqa: E731
                    ids, vals, table, g, square, need_dvals,
                    engine="kernel")
                plain = lambda: embed_bag_grad_reference(  # noqa: E731
                    ids, vals, table, g, square, need_dvals)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = max(_close(f"embed_bag_grad square={square} "
                                 f"dvals={need_dvals}", a, b)
                          for a, b in zip(got, want) if a is not None)
                ms, plain_ms = timer.ms(run), timer.ms(plain)
                need_x = square or need_dvals
                nbytes = (BK * 8 + ROWS_TR * D * 4 + F * D * 4
                          + (rows_read * D * 4 if need_x else 0)
                          + (BK * 4 if need_dvals else 0))
                b_ms, b_by = bound(nbytes, (2 + 2 * need_x) * live * D)
                lib_ms = None
                if not square and not need_dvals:
                    lib_ms = timer.ms(lib_bwd)
                    # the training path: square=False, no dvals
                    results["embed_bag_grad"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, max_abs_err=err,
                        floor_ms=bag_grad_floor_ms)
                log(f"[kernels] embed_bag_grad square={square} dvals="
                    f"{need_dvals} B={ROWS_TR} K={K_TR} D={D}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag "
                    f"backward "
                    f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
        del lib_bwd
        results.update(_training_fm_terms(torch, timer, power, ids, vals,
                                          table, g, rows_read, live))

        fids, fvals, fsegs, nnz, counts = _flat_train_batch(torch, rng)
        rows_read = int(torch.unique(clamp_ids(fids[:nnz], F)).numel())
        foffsets = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(counts)[:-1]]).astype(np.int32)).cuda()
        results.update(_training_forward(torch, timer, power, table, fids,
                                         fvals, fsegs, nnz, rows_read,
                                         foffsets))
        for fm, Dg in ((True, D), (False, 1), (False, D)):
            tab = table if Dg == D else table[:, :1].contiguous()
            g1 = torch.from_numpy(rng.standard_normal(
                (ROWS_TR + 1, Dg), dtype=np.float32)).cuda()
            g2 = (torch.from_numpy(rng.standard_normal(
                (ROWS_TR + 1, Dg), dtype=np.float32)).cuda() if fm else None)
            name = "ragged_gather_grad_fm" if fm else "ragged_gather_grad_embed"
            floor_ms = _zero_work_grad(
                torch, timer, power,
                lambda nnz, tab=tab, g1=g1, g2=g2: ragged_gather_grad(
                    fids, fvals, fsegs, nnz, tab, g1, g2, ROWS_TR,
                    need_dvals=False, engine="kernel")[1],
                tab.shape, f"{'fm' if fm else 'embed'} D={Dg}")
            for need_dvals in (False, True):
                run = lambda: ragged_gather_grad(  # noqa: E731
                    fids, fvals, fsegs, None, tab, g1, g2, ROWS_TR,
                    need_dvals=need_dvals, engine="kernel")
                plain = lambda: ragged_gather_grad_reference(  # noqa: E731
                    fids, fvals, fsegs, None, tab, g1, g2, ROWS_TR,
                    need_dvals=need_dvals)
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = max(_close(f"{name} D={Dg} dvals={need_dvals}", a, b)
                          for a, b in zip(got, want) if a is not None)
                ms, plain_ms = timer.ms(run), timer.ms(plain)
                need_x = fm or need_dvals
                nbytes = (12 * fids.shape[0]
                          + (1 + fm) * (ROWS_TR + 1) * Dg * 4 + F * Dg * 4
                          + (rows_read * Dg * 4 if need_x else 0)
                          + (fids.shape[0] * 4 if need_dvals else 0))
                b_ms, b_by = bound(nbytes, ((6 if fm else 1)
                                            + 2 * need_dvals) * nnz * Dg)
                lib_ms = None
                if not fm and not need_dvals:
                    lib_ms = timer.ms(_library_grad(
                        torch, fids[:nnz], fvals[:nnz], foffsets, tab,
                        g1[:ROWS_TR]))
                # the training path runs no dvals: fm at D=32, embed at
                # D=1 (the linear term) and at D=32 (DCNv2's x0, the
                # embed row's "d32")
                if not need_dvals:
                    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms,
                               max_abs_err=err, floor_ms=floor_ms)
                    if fm or Dg == 1:
                        results[name] = row
                    else:
                        results[name]["d32"] = row
                above = (f" (nnz_used=0: {floor_ms:.4f} ms, above it "
                         f"{ms - floor_ms:.4f} ms)")
                log(f"[kernels] {name} cap={fids.shape[0]} nnz={nnz} rows="
                    f"{ROWS_TR} D={Dg} dvals={need_dvals}: kernel {ms:.4f} "
                    f"ms{above}, plain {plain_ms:.4f} ms, embedding_bag "
                    f"backward "
                    f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                    f"{b_ms:.4f} ms ({b_by}), max|err| {err:.3g} [{power}]")
    return results


def _ffm_batch(torch, rng, F=F_FFM):
    """FFM's bucket sum as the flat training path calls it: ROWS_TR rows
    of 5-39 entries (ids below 1,000,000 hashed into ``F`` features,
    sorted in a row, so their fields j % 40 are not), in the native
    packer's nnz bucket; segment row * 40 + field, padding (id 0, value
    0) on the scratch row ROWS_TR * 40; out-of-range ids first.  Returns
    the device tensors and the live count."""
    counts = rng.integers(5, 40, ROWS_TR)
    nnz = int(counts.sum())
    cap = _bucket(nnz)
    raw = np.concatenate([np.sort(rng.choice(1_000_000, size=c,
                                             replace=False))
                          for c in counts])
    ids = np.zeros(cap, np.int32)
    ids[:nnz] = raw % F
    ids[:4] = [-1, -F - 3, F, F + 7]
    vals = np.zeros(cap, np.float32)
    vals[:nnz] = rng.random(nnz, dtype=np.float32)
    segs = np.full(cap, ROWS_TR * NF_FFM, np.int32)
    segs[:nnz] = (np.repeat(np.arange(ROWS_TR), counts) * NF_FFM
                  + raw % NF_FFM)
    dev = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return dev(ids), dev(vals), dev(segs), nnz


def _sparse_rows(torch, rows, cols, vals, shape):
    """A CSR matrix of ``shape`` with ``vals`` at (rows, cols), for the
    one PyTorch call (a sparse product) that computes the same sum."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def _ffm_kernels(torch, timer: Timer, power: str, rng, dim: int = DIM_FFM,
                 key: str = "ffm") -> dict:
    """The ragged-gather forward and backward at FFM's shape (D = 40 ·
    ``dim``: 160, or 80 for a rank's columns over mp = 2; 163,840
    segments, F 2^18, unsorted segments within a row, padding on the
    scratch row, out-of-range ids) against their plain versions, timed,
    with the sparse product that computes the same function (built
    beforehand, ids clamped or dropped as each kernel's rule says).
    Returns ``<name>_<key>`` numbers."""
    from dmlc_core_tpu_torch.kernels import (ragged_gather,
                                             ragged_gather_grad,
                                             ragged_gather_grad_reference,
                                             ragged_gather_reference)
    from dmlc_core_tpu_torch.kernels.common import clamp_ids, grad_rows
    results = {}
    D, S = NF_FFM * dim, ROWS_TR * NF_FFM
    table = torch.from_numpy(rng.standard_normal(
        (F_FFM, D), dtype=np.float32) * 0.05).cuda()
    fids, fvals, fsegs, nnz = _ffm_batch(torch, rng)
    cap = fids.shape[0]
    live_ids = fids[:nnz]
    rows_read = int(torch.unique(clamp_ids(live_ids, F_FFM)).numel())
    segs_hit = int(torch.unique(fsegs[:nnz]).numel())
    with torch.no_grad():
        run = lambda: ragged_gather(  # noqa: E731
            fids, fvals, fsegs, None, table, S, fm=False, engine="kernel")[0]
        plain = lambda: ragged_gather_reference(  # noqa: E731
            fids, fvals, fsegs, None, table, S, fm=False)[0]
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = _close(f"ragged_gather_embed ({key}) D={D}", got, want)
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        b_ms, b_by = bound(rows_read * D * 4 + 12 * cap + (S + 1) * D * 4,
                           2 * nnz * D)
        fwd_m = _sparse_rows(torch, fsegs[:nnz].long(),
                             clamp_ids(live_ids, F_FFM), fvals[:nnz],
                             (S + 1, F_FFM))
        lib = lambda: fwd_m @ table  # noqa: E731
        _close(f"sparse CSR @ table ({key})", lib(), want)
        lib_ms = timer.ms(lib)
        # the floor: the same call with nnz_used = 0 (exact zeros)
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        none = lambda: ragged_gather(  # noqa: E731
            fids, fvals, fsegs, zero, table, S, fm=False, engine="kernel")[0]
        _close(f"ragged_gather_embed ({key}) nnz_used=0", none(), want,
               exact_zero=True)
        floor_ms = timer.ms(none)
        results[f"ragged_gather_embed_{key}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, max_abs_err=err, floor_ms=floor_ms)
        log(f"[kernels] ragged_gather_embed ({key}) cap={cap} nnz={nnz} "
            f"segments={S} D={D} F={F_FFM}: kernel {ms:.4f} ms (nnz_used=0:"
            f" {floor_ms:.4f} ms), plain {plain_ms:.4f} ms, sparse CSR "
            f"product {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max|err| {err:.3g} [{power}]")
        del got, want, fwd_m

        g1 = torch.from_numpy(rng.standard_normal(
            (S + 1, D), dtype=np.float32)).cuda()
        run = lambda: ragged_gather_grad(  # noqa: E731
            fids, fvals, fsegs, None, table, g1, None, S, need_dvals=False,
            engine="kernel")[1]
        plain = lambda: ragged_gather_grad_reference(  # noqa: E731
            fids, fvals, fsegs, None, table, g1, None, S,
            need_dvals=False)[1]
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = _close(f"ragged_gather_grad_embed ({key}) D={D}", got, want)
        ms, plain_ms = timer.ms(run), timer.ms(plain)
        b_ms, b_by = bound(12 * cap + segs_hit * D * 4 + F_FFM * D * 4,
                           2 * nnz * D)
        keep = grad_rows(live_ids, F_FFM) < F_FFM
        bwd_m = _sparse_rows(torch, grad_rows(live_ids, F_FFM)[keep],
                             fsegs[:nnz].long()[keep], fvals[:nnz][keep],
                             (F_FFM, S + 1))
        lib = lambda: bwd_m @ g1  # noqa: E731
        _close(f"sparse CSR @ g1 ({key})", lib(), want)
        lib_ms = timer.ms(lib)
        del got, want, bwd_m
        floor_ms = _zero_work_grad(
            torch, timer, power, lambda z: ragged_gather_grad(
                fids, fvals, fsegs, z, table, g1, None, S, need_dvals=False,
                engine="kernel")[1], table.shape, f"{key} D={D}")
        results[f"ragged_gather_grad_embed_{key}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, max_abs_err=err, floor_ms=floor_ms)
        log(f"[kernels] ragged_gather_grad_embed ({key}) cap={cap} nnz={nnz} "
            f"segments={S} D={D} dtable [{F_FFM}, {D}]: kernel {ms:.4f} ms "
            f"(nnz_used=0: {floor_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"sparse CSR product {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), max|err| {err:.3g} [{power}]")
    return results


def _cli_ffm_grad(torch, timer: Timer, power: str, rng) -> dict:
    """The ragged backward at the CLI's FFM defaults (2^20 features, 40
    fields, dim 16: D = 640, a [2^20, 640] gradient of 2.7 GB) on FFM's
    batch, through the table-less entry point the embed sum's backward
    shares: kernel, plain version, the sparse CSR product, the same call
    with nnz_used = 0, and the bound.  Returns ``<name>_cli`` numbers."""
    from dmlc_core_tpu_torch.kernels import ragged_gather_table_grad
    from dmlc_core_tpu_torch.kernels.common import grad_rows
    F, D, S = F_FEATURES, NF_FFM * 16, ROWS_TR * NF_FFM
    fids, fvals, fsegs, nnz = _ffm_batch(torch, rng, F)
    cap = fids.shape[0]
    segs_hit = int(torch.unique(fsegs[:nnz]).numel())
    g1 = torch.from_numpy(rng.standard_normal(
        (S + 1, D), dtype=np.float32)).cuda()
    with torch.no_grad():
        call = lambda nnz_used, engine="kernel": (  # noqa: E731
            ragged_gather_table_grad(fids, fvals, fsegs, nnz_used, g1, S, F,
                                     engine=engine))
        got, want = call(None), call(None, "torch")
        torch.cuda.synchronize()
        err = _close(f"ragged_gather_grad_embed (cli) D={D}", got, want)
        del got
        ms = timer.ms(lambda: call(None), reps=10)
        plain_ms = timer.ms(lambda: call(None, "torch"), reps=10)
        b_ms, b_by = bound(12 * cap + segs_hit * D * 4 + F * D * 4,
                           2 * nnz * D)
        live_ids = fids[:nnz]
        keep = grad_rows(live_ids, F) < F
        bwd_m = _sparse_rows(torch, grad_rows(live_ids, F)[keep],
                             fsegs[:nnz].long()[keep], fvals[:nnz][keep],
                             (F, S + 1))
        lib = lambda: bwd_m @ g1  # noqa: E731
        _close("sparse CSR @ g1 (cli)", lib(), want)
        del want
        lib_ms = timer.ms(lib, reps=10)
        del bwd_m
        floor_ms = _zero_work_grad(torch, timer, power, call, (F, D),
                                   f"cli D={D}")
    log(f"[kernels] ragged_gather_grad_embed (cli) cap={cap} nnz={nnz} "
        f"segments={S} D={D} dtable [{F}, {D}]: kernel {ms:.4f} ms "
        f"(nnz_used=0: {floor_ms:.4f} ms), plain {plain_ms:.4f} ms, sparse "
        f"CSR product {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max|err| {err:.3g} [{power}]")
    return {"ragged_gather_grad_embed_cli": dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, max_abs_err=err, floor_ms=floor_ms)}


# the optimizer kernels against their plain versions after 8 steps: the
# same float32 operations in the same order, each rounded on its own
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
OPT_STEPS = 8
# FTRL on the logreg path: the JAX package's defaults but l1, which at 1.0
# would hold every weight at 0 over 8 steps of gradients near 0.01
FTRL_ARGS = dict(alpha=0.1, beta=1.0, l1=0.01, l2=1.0)
OPT_FLOPS = {"adam": 15, "ftrl": 16}     # operations an element


def _optimizer_kernels(torch, timer: Timer, power: str) -> dict:
    """The fused Adam and FTRL kernels over every parameter of the FM,
    DCNv2 and logreg models (2^20 features): 8 steps against the plain
    version from the same state and gradients (OPT_RTOL / OPT_ATOL), then
    CUDA-event times of one step: kernel, a launch over no tensors (the
    floor), the plain version and, for Adam, torch.optim.Adam (foreach,
    its default, and fused=True, capturable=True) over the same tensors.
    Bound: p, g and the two state tensors read, p and the state written,
    once each: 28 bytes an element over the memory rate."""
    from dmlc_core_tpu_torch.kernels.optim import (adam_step,
                                                   adam_step_reference,
                                                   empty_launch, ftrl_step,
                                                   ftrl_step_reference)
    dev = torch.device("cuda")
    floors = {w: timer.ms(lambda w=w: empty_launch(w, dev))
              for w in ("adam", "ftrl")}
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for kind, whichs in (("fm", ("adam", "ftrl")), ("dcn", ("adam", "ftrl")),
                         ("logreg", ("ftrl",))):
        params = [p.detach() for p in _model(torch, kind, "torch")
                  .parameters()]
        n = sum(p.numel() for p in params)
        grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-2
                 for p in params]
        negs = [-g for g in grads]

        def state():
            ps = [p.clone() for p in params]
            return (ps, [torch.zeros_like(p) for p in ps],
                    [torch.zeros_like(p) for p in ps],
                    torch.zeros((), dtype=torch.int32, device="cuda"),
                    torch.zeros(1, dtype=torch.int32, device="cuda"))

        for which in whichs:
            def kernel(st, g):
                if which == "adam":
                    adam_step(st[0], g, st[1], st[2], st[3], st[4], lr=LR,
                              engine="kernel")
                else:
                    ftrl_step(st[0], g, st[1], st[2], engine="kernel",
                              **FTRL_ARGS)

            def plain(st, g):
                if which == "adam":
                    adam_step_reference(st[0], g, st[1], st[2], st[3], lr=LR)
                else:
                    ftrl_step_reference(st[0], g, st[1], st[2], **FTRL_ARGS)

            sk, sp = state(), state()
            for i in range(OPT_STEPS):
                kernel(sk, grads if i % 2 == 0 else negs)
                plain(sp, grads if i % 2 == 0 else negs)
            torch.cuda.synchronize()
            err = 0.0
            for a, b in zip(sk[0] + sk[1] + sk[2], sp[0] + sp[1] + sp[2]):
                err = max(err, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL):
                    raise RuntimeError(
                        f"{which} {kind}: kernel departs from the plain "
                        f"version after {OPT_STEPS} steps: max|err| "
                        f"{err:.3g} beyond rtol {OPT_RTOL} atol {OPT_ATOL}")
            if which == "adam" and not (int(sk[3]) == int(sp[3])
                                        == OPT_STEPS and int(sk[4]) == 0):
                raise RuntimeError(f"adam {kind}: count {int(sk[3])}, "
                                   f"ticket {int(sk[4])}")
            ms = timer.ms(lambda: kernel(sk, grads))
            plain_ms = timer.ms(lambda: plain(sp, grads))
            del sp
            b_ms, b_by = bound(28 * n, OPT_FLOPS[which] * n)
            lib = {}
            if which == "adam":
                for label, kw in (("foreach", {}),
                                  ("fused", dict(fused=True,
                                                 capturable=True))):
                    prm = [torch.nn.Parameter(p.clone()) for p in params]
                    for p, g in zip(prm, grads):
                        p.grad = g
                    opt = torch.optim.Adam(prm, lr=LR, betas=(0.9, 0.999),
                                           eps=1e-8, **kw)
                    lib[label] = timer.ms(opt.step)
                    del opt, prm
            results[f"{which}_{kind}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib.get("fused"), max_abs_err=err,
                floor_ms=floors[which],
                library_foreach_ms=lib.get("foreach"), elements=n)
            lib_txt = (f", torch.optim.Adam foreach {lib['foreach']:.4f} ms, "
                       f"fused+capturable {lib['fused']:.4f} ms"
                       if lib else ", no PyTorch call")
            log(f"[kernels] {which} over {kind}'s {len(params)} tensors "
                f"({n} elements): kernel {ms:.4f} ms (a launch over no "
                f"tensors {floors[which]:.4f} ms), plain {plain_ms:.4f} ms"
                f"{lib_txt}, bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} "
                f"of it reached); after {OPT_STEPS} steps max|err| "
                f"{err:.3g} (limit rtol {OPT_RTOL} atol {OPT_ATOL}) "
                f"[{power}]")
            del sk
        del params, grads, negs
        torch.cuda.empty_cache()
    # the rows of the kernels line: Adam on the FM path, FTRL on the logreg
    # path, each with its DCNv2 (and FM) figures beside
    results["adam"] = dict(results["adam_fm"], dcn=results["adam_dcn"])
    results["ftrl"] = dict(results["ftrl_logreg"], fm=results["ftrl_fm"],
                           dcn=results["ftrl_dcn"])
    return results


# -- phase 4 ----------------------------------------------------------------

def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w0": np.float32(0.1 * (seed + 1)).reshape(()),
            "w": rng.standard_normal(F_FEATURES, dtype=np.float32) * 0.05,
            "v": rng.standard_normal((F_FEATURES, DIM),
                                     dtype=np.float32) * 0.02}


def _fm_f64(p: dict, ids, vals, row_ptr) -> np.ndarray:
    w, v = p["w"].astype(np.float64), p["v"]
    out = []
    for r in range(len(row_ptr) - 1):
        i, x = ids[row_ptr[r]:row_ptr[r + 1]], vals[row_ptr[r]:row_ptr[r + 1]]
        x = x.astype(np.float64)
        vx = v[i].astype(np.float64) * x[:, None]
        pair = 0.5 * np.sum(vx.sum(0) ** 2 - (vx * vx).sum(0))
        out.append(float(p["w0"]) + float(w[i] @ x) + pair)
    return 1.0 / (1.0 + np.exp(-np.asarray(out)))


def _requests(rng, n: int):
    reqs = []
    for _ in range(n):
        rows = int(rng.integers(1, ROWS + 1))
        per = rng.integers(1, max(2, CAP // rows) + 1, rows)
        row_ptr = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
        nnz = int(row_ptr[-1])
        reqs.append((rng.integers(0, F_FEATURES, nnz).astype(np.int32),
                     rng.random(nnz, dtype=np.float32), row_ptr))
    return reqs


def _serve(call, reqs, threads: int = 8):
    """Closed-loop clients: thread k sends its share one at a time, each
    through ``call(k, request)``.  Returns (answers, per-request latencies
    in ms, wall seconds)."""
    answers = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    errors = []

    def client(k):
        try:
            for j in range(k, len(reqs), threads):
                t0 = time.perf_counter()
                answers[j] = call(k, reqs[j])
                lat[j] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return answers, lat, wall


def _batcher_call(batcher):
    return lambda _k, req: batcher.submit(*req).result(timeout=120)


def breakdown(torch, timer: Timer, engines, reqs, power: str,
              reps: int = 20) -> dict:
    """Where one ``predict`` of the largest request spends its time, each
    stage run alone on the host clock (median of ``reps``): the pad, the
    H2D copy into the bucket's static input (pinned staging, then one
    non-blocking copy, synchronised), the graph's replay as the host
    enqueues it and as the host sees it end (synchronised), the copy of
    the scores out (copy and event wait), and the whole predict; beside
    them the replay's device time (CUDA events).  Returns the medians
    by mode."""
    out = {}
    for mode, eng in engines.items():
        ids, vals, rp = max(reqs[mode], key=lambda r: len(r[0]))
        rows = len(rp) - 1
        bucket = eng.ladder.best_fit(rows, len(ids))
        g = eng._graphs[bucket]
        stages = {k: [] for k in ("pad", "h2d", "replay_enqueue",
                                  "replay_synced", "copy_out", "predict")}
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = eng._pad(bucket, ids, vals, rp)
            t1 = time.perf_counter()
            eng._stage(g, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            eng._replay(g)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            eng._copy_out(g, rows)
            t5 = time.perf_counter()
            eng.predict(ids, vals, rp)
            t6 = time.perf_counter()
            for k, x, y in (("pad", t0, t1), ("h2d", t1, t2),
                            ("replay_enqueue", t2, t3),
                            ("replay_synced", t2, t4), ("copy_out", t4, t5),
                            ("predict", t5, t6)):
                stages[k].append((y - x) * 1e3)
        med = {k: float(np.median(v)) for k, v in stages.items()}
        med["replay_device"] = timer.ms(lambda: eng._replay(g))
        log(f"[breakdown] {mode} bucket {tuple(bucket)} nnz={len(ids)}, "
            f"one captured graph: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items())
            + f"; {sum(g.launches.values())} kernel launches a replay "
            f"{g.launches} [{power}]")
        out[mode] = med
    return out


def phase_serving(torch, timer: Timer, power: str) -> dict:
    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine,
                                     MicroBatcher, params_from_jax)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts

    ckpt = os.path.join(ROOT, ".chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        p1, p2 = _np_params(SEED + 1), _np_params(SEED + 2)
        model = FactorizationMachine(F_FEATURES, DIM, device="cuda")
        model.load_state_dict(params_from_jax(p1, "cuda"))
        mgr = CheckpointManager(ckpt)
        mgr.save(1, {"params": p1}, meta={"model": "fm"})
        plain_model = copy.copy(model)        # shares the parameters
        plain_model.engine = "torch"
        rng = np.random.default_rng(SEED + 3)
        reqs = {m: _requests(rng, 72) for m in ("padded", "ragged")}
        reload_reqs = _requests(rng, 8)
        rm_ids = rng.integers(0, F_FEATURES, (B_RM, K_RM)).astype(np.int32)
        rm_vals = rng.random((B_RM, K_RM), dtype=np.float32)

        engines, answers, stats = {}, {}, {}
        reset_launch_counts()                 # the main path starts here
        for mode, ladder in (("padded", BucketLadder.default()),
                             ("ragged", BucketLadder.ragged_default())):
            eng = InferenceEngine(model, buckets=ladder,
                                  postprocess="sigmoid",
                                  ragged=mode == "ragged", device="cuda")
            if eng.reload_from_checkpoint(ckpt, step=1) != 1:
                raise RuntimeError("restored the wrong step")
            eng.warmup_all()
            calls = []
            predict = eng.predict

            def timed(*a, _predict=predict, _calls=calls):
                t0 = time.perf_counter()
                out = _predict(*a)
                _calls.append((time.perf_counter() - t0) * 1e3)
                return out
            eng.predict = timed
            with MicroBatcher(eng, default_deadline_s=60.0) as batcher:
                answers[mode], lat, wall = _serve(_batcher_call(batcher),
                                                  reqs[mode])
                nbatches = batcher.batches
            eng.predict = predict
            if eng.compile_count != len(eng.ladder):
                raise RuntimeError(f"{mode}: {eng.compile_count} graphs "
                                   f"captured for a ladder of "
                                   f"{len(eng.ladder)}")
            rows = sum(len(r[2]) - 1 for r in reqs[mode])
            stats[mode] = dict(
                requests=len(reqs[mode]), batches=nbatches, rows=rows,
                request_p50_ms=float(np.percentile(lat, 50)),
                request_p99_ms=float(np.percentile(lat, 99)),
                predict_p50_ms=float(np.percentile(calls, 50)),
                predict_p99_ms=float(np.percentile(calls, 99)),
                rows_per_s=rows / wall, buckets_prepared=eng.compile_count,
                ladder=len(eng.ladder))
            engines[mode] = eng

        # hot-reload to a second step: scores must follow it
        mgr.save(2, {"params": p2}, meta={"model": "fm"})
        eng = engines["padded"]
        if eng.reload_from_checkpoint(ckpt) != 2:
            raise RuntimeError("hot-reload restored the wrong step")
        with MicroBatcher(eng, default_deadline_s=60.0) as batcher:
            reloaded, _, _ = _serve(_batcher_call(batcher), reload_reqs)

        # the row-major branch of the same forward
        rm_batch = {"ids": torch.from_numpy(rm_ids).cuda(),
                    "vals": torch.from_numpy(rm_vals).cuda(),
                    "labels": torch.zeros(B_RM, device="cuda")}
        with torch.inference_mode():
            rm_got = model(rm_batch)
        torch.cuda.synchronize()
        launches = launch_counts()            # the main path ends here
        log(f"[serving] kernel launches on the main path: {launches}")

        # -- checks against the plain path and a float64 FM --------------
        for mode in ("padded", "ragged"):
            ref_eng = InferenceEngine(plain_model, postprocess="sigmoid",
                                      ragged=mode == "ragged", device="cuda")
            ref_eng.reload_from_checkpoint(ckpt, step=1)
            for j, (ids, vals, rp) in enumerate(reqs[mode]):
                got = answers[mode][j]
                want = ref_eng.predict(ids, vals, rp)
                if got.shape != (len(rp) - 1,) or not np.isfinite(got).all():
                    raise RuntimeError(f"{mode}: bad answer shape/values")
                if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                    raise RuntimeError(
                        f"{mode} request {j}: kernel path vs plain path "
                        f"max |err| {np.abs(got - want).max():.3g}")
                if j < 4 and not np.allclose(got, _fm_f64(p1, ids, vals, rp),
                                             rtol=0, atol=ATOL_F64):
                    raise RuntimeError(f"{mode} request {j}: far from the "
                                       f"float64 FM")
        for j, (ids, vals, rp) in enumerate(reload_reqs):
            want2 = _fm_f64(p2, ids, vals, rp)
            if not np.allclose(reloaded[j], want2, rtol=0, atol=ATOL_F64):
                raise RuntimeError("hot-reloaded scores do not follow step 2")
        if all(np.allclose(reloaded[j], _fm_f64(p1, *r), atol=ATOL_F64)
               for j, r in enumerate(reload_reqs)):
            raise RuntimeError("hot-reload changed no score")
        with torch.inference_mode():
            rm_want = plain_model(rm_batch)
        _close("row-major FM forward", rm_got, rm_want)

        breakdown(torch, timer, engines, reqs, power)
        for mode, s in stats.items():
            log(f"[serving] {mode}: {s['requests']} requests in "
                f"{s['batches']} batches, {s['rows']} rows, request p50 "
                f"{s['request_p50_ms']:.3f} ms p99 {s['request_p99_ms']:.3f}"
                f" ms, predict p50 {s['predict_p50_ms']:.3f} ms p99 "
                f"{s['predict_p99_ms']:.3f} ms, {s['rows_per_s']:.0f} rows/s,"
                f" buckets {s['buckets_prepared']}/{s['ladder']} [{power}]")
        log("[serving] hot-reload to step 2 followed; row-major forward "
            "matches its plain version")
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# -- phase 4a: the TCP server ------------------------------------------------

LOAD_REQUESTS = 2000
LOADS = (                  # (name, run_load's shape), at 2^20 features
    # the 10 ms request-p99 budget's case: 128 rows a request
    ("load1", dict(concurrency=8, pipeline_depth=1, rows_per_req=128,
                   nnz_per_row=32)),
    # the JAX load generator's defaults, at 8 connections
    ("load2", dict(concurrency=8, pipeline_depth=8, rows_per_req=4,
                   nnz_per_row=32)),
)
RELOAD_STREAM = 40         # answers streamed before and after a hot-reload


def _one_switch(results, s1, s2) -> int:
    """Where a stream of answers to one request moved from step 1's
    scores to step 2's: each answer must be one step's (rtol = atol =
    RTOL) and the stream must switch once.  A replay that read half-copied
    weights matches neither."""
    steps = []
    for r in results:
        one = np.allclose(r, s1, rtol=RTOL, atol=ATOL)
        two = np.allclose(r, s2, rtol=RTOL, atol=ATOL)
        if one == two:
            raise RuntimeError("a hot-reload answer matches neither step's "
                               "scores (or both)")
        steps.append(2 if two else 1)
    if steps[0] != 1 or steps[-1] != 2 or steps != sorted(steps):
        raise RuntimeError(f"the answers do not switch steps once: {steps}")
    return steps.index(2)


def _reload_mid_stream(srv, client, req, ckpt: str) -> tuple:
    """Stream ``req`` through ``client`` while the server hot-reloads step
    2, then RELOAD_STREAM answers more; returns (answers, the answers done
    before the reload began and by the time it returned, its seconds)."""
    stop = threading.Event()
    results, failures = [], []

    def stream():
        while not stop.is_set():
            try:
                results.append(client.predict(*req, timeout=60))
            except Exception as e:  # noqa: BLE001 — raised below
                failures.append(e)
                return

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while len(results) < RELOAD_STREAM and not failures:
            if time.monotonic() > deadline:
                raise RuntimeError("the stream stalled before the reload")
            time.sleep(0.001)
        before = len(results)
        t0 = time.perf_counter()
        if srv.reload_from_checkpoint(ckpt, 2) != 2:
            raise RuntimeError("hot-reload restored the wrong step")
        reload_s = time.perf_counter() - t0
        at = len(results)
        while len(results) < at + RELOAD_STREAM and not failures:
            if time.monotonic() > deadline:
                raise RuntimeError("the stream stalled after the reload")
            time.sleep(0.001)
    finally:
        stop.set()
        t.join(timeout=60)
    if failures:
        raise RuntimeError(f"a request failed during the hot-reload: "
                           f"{failures[0]!r}")
    return results, before, at, reload_s


def _load_main(host: str, port: int, shape: dict) -> dict:
    """The load generator as a user runs it, in its own interpreter
    (``python -m dmlc_core_tpu_torch.serving.client``): its JSON
    report."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    r = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serving.client",
         f"{host}:{port}", f"requests={LOAD_REQUESTS}",
         f"features={F_FEATURES}", f"seed={SEED}"]
        + [f"{k}={v}" for k, v in shape.items()],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"the load generator exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout)


def _server_side(snap: dict) -> dict:
    """What the server's own metrics saw of a load: engine calls,
    requests a call, and each request's time from the batcher's queue to
    its answer (``serving.latency_s``)."""
    calls = snap["serving.batcher.batches"]["value"]
    lat = snap["serving.latency_s"]
    return {"calls": calls, "requests_per_call": lat["count"] / max(1, calls),
            "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3}


def phase_server(torch, timer: Timer, power: str) -> dict:
    """The slice's main path: ``PredictionServer`` over
    FactorizationMachine(2^20, 32) from phase 4's checkpoint, padded and
    ragged ladders, every bucket a captured CUDA graph; phase 4's
    requests through ``PredictClient`` from 8 connections, two load
    mixes through ``run_load``, a hot-reload mid-stream.  Returns the
    kernel launches counted over it and its numbers."""
    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine,
                                     PredictClient, PredictionServer,
                                     run_load)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.utils.metrics import metrics

    ckpt = os.path.join(ROOT, ".chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        p1, p2 = _np_params(SEED + 1), _np_params(SEED + 2)
        mgr = CheckpointManager(ckpt)
        mgr.save(1, {"params": p1}, meta={"model": "fm"})
        mgr.save(2, {"params": p2}, meta={"model": "fm"})
        rng = np.random.default_rng(SEED + 3)     # phase 4's requests
        reqs = {m: _requests(rng, 72) for m in ("padded", "ragged")}
        ladders = {"padded": BucketLadder.default(),
                   "ragged": BucketLadder.ragged_default()}
        engines, answers, stats, reloads = {}, {}, {}, {}
        graphs = batches = answered = 0
        reset_launch_counts()                 # the main path starts here
        for mode, ladder in ladders.items():
            model = FactorizationMachine(F_FEATURES, DIM, device="cuda")
            eng = InferenceEngine(model, buckets=ladder,
                                  postprocess="sigmoid",
                                  ragged=mode == "ragged", device="cuda")
            if eng.reload_from_checkpoint(ckpt, step=1) != 1:
                raise RuntimeError("restored the wrong step")
            t0 = time.perf_counter()
            srv = PredictionServer(eng, warmup=True,
                                   default_deadline_s=60.0)
            capture_s = time.perf_counter() - t0
            if not eng.compile_count == len(ladder) == len(eng._graphs):
                raise RuntimeError(f"{mode}: {eng.compile_count} graphs "
                                   f"for a ladder of {len(ladder)}")
            srv.start()
            try:
                clients = [PredictClient(srv.host, srv.port)
                           for _ in range(8)]
                try:
                    answers[mode], lat, wall = _serve(
                        lambda k, r: clients[k].predict(*r, timeout=120),
                        reqs[mode])
                    loads = {}
                    for name, shape in LOADS:
                        for where in ("in process", "own process"):
                            if where == "own process" and mode != "padded":
                                continue
                            metrics.reset()
                            rep = (run_load(srv.host, srv.port,
                                            requests=LOAD_REQUESTS,
                                            features=F_FEATURES, seed=SEED,
                                            timeout=120.0, **shape)
                                   if where == "in process" else
                                   _load_main(srv.host, srv.port, shape))
                            if (rep["rejected"] or rep["errors"]
                                    or rep["ok"] + rep["overload"]
                                    != LOAD_REQUESTS):
                                raise RuntimeError(f"{mode} {name}: {rep}")
                            rep["server"] = _server_side(metrics.snapshot())
                            loads[f"{name}, client {where}"] = rep
                    stream_req = reqs[mode][0]
                    reloads[mode] = (stream_req,) + _reload_mid_stream(
                        srv, clients[0], stream_req, ckpt)
                finally:
                    for c in clients:
                        c.close()
            finally:
                srv.stop()
            graphs += eng.compile_count
            batches += srv.batcher.batches
            answered += (len(reqs[mode]) + len(reloads[mode][1])
                         + sum(r["ok"] for r in loads.values()))
            stats[mode] = dict(request_p50_ms=float(np.percentile(lat, 50)),
                               request_p99_ms=float(np.percentile(lat, 99)),
                               wall_s=wall, capture_s=capture_s,
                               graphs=eng.compile_count, ladder=len(ladder),
                               loads=loads)
            engines[mode] = eng
        torch.cuda.synchronize()
        launches = launch_counts()            # the main path ends here
        log(f"[server] kernel launches on the main path: {launches}, over "
            f"{batches} engine calls and {graphs} warm-up forwards (one "
            f"before each capture); {answered} requests answered, "
            + ", ".join(f"{k} {(v - graphs) / answered:.4f}"
                        for k, v in sorted(launches.items()))
            + " launches a request")
        for name in ("ragged_gather_fm", "ragged_gather_embed"):
            if launches.get(name, 0) != batches + graphs:
                raise RuntimeError(f"{name}: {launches.get(name, 0)} "
                                   f"launches, expected one a call and one "
                                   f"a warm-up ({batches + graphs})")

        # -- checks against the plain path on the card ----------------------
        for mode, eng in engines.items():
            pm = FactorizationMachine(F_FEATURES, DIM, engine="torch",
                                      device="cuda")
            ref = InferenceEngine(pm, buckets=ladders[mode],
                                  postprocess="sigmoid",
                                  ragged=mode == "ragged", device="cuda")
            ref.reload_from_checkpoint(ckpt, step=1)
            worst = 0.0
            for j, (ids, vals, rp) in enumerate(reqs[mode]):
                got, want = answers[mode][j], ref.predict(ids, vals, rp)
                if got.shape != (len(rp) - 1,) or not np.isfinite(got).all():
                    raise RuntimeError(f"{mode}: bad answer shape/values")
                if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                    raise RuntimeError(
                        f"{mode} request {j} over TCP: max |err| against "
                        f"the plain path {np.abs(got - want).max():.3g}")
                worst = max(worst, float(np.abs(got - want).max()))
            stream_req, results, before, at, reload_s = reloads[mode]
            s1 = ref.predict(*stream_req)
            ref.reload_from_checkpoint(ckpt, step=2)
            s2 = ref.predict(*stream_req)
            switch = _one_switch(results, s1, s2)
            if not before <= switch <= at + 1:
                raise RuntimeError(f"{mode}: the answers switched at "
                                   f"{switch}, outside the reload's "
                                   f"answers {before}..{at + 1}")
            # a replay against the eager kernel path on the same batch
            ids, vals, rp = max(reqs[mode], key=lambda r: len(r[0]))
            bucket = eng.ladder.best_fit(len(rp) - 1, len(ids))
            batch = eng._pad(bucket, ids, vals, rp)
            replay = eng.predict(ids, vals, rp)
            eager = eng._forward(eng._params, batch).cpu().numpy()
            eager = eager[:len(rp) - 1]
            if not np.allclose(replay, eager, rtol=RTOL, atol=ATOL):
                raise RuntimeError(f"{mode}: the replay departs from the "
                                   f"eager kernel path")
            st = stats[mode]
            log(f"[server] {mode}: {st['graphs']}/{st['ladder']} buckets "
                f"captured in {st['capture_s']:.3f} s; 72 requests over TCP "
                f"from 8 connections, request p50 "
                f"{st['request_p50_ms']:.3f} ms p99 "
                f"{st['request_p99_ms']:.3f} ms, max |err| against the plain "
                f"path {worst:.3g} (limit rtol=atol={RTOL}); replay vs eager "
                f"kernel path max |err| {np.abs(replay - eager).max():.3g}; "
                f"hot-reload to step 2 in {reload_s * 1e3:.1f} ms "
                f"mid-stream: {len(results)} answers, no failure, one "
                f"switch, at answer {switch} ({before} done before the "
                f"reload began, {at} by its return) [{power}]")
            for name, rep in st["loads"].items():
                lm, sv = rep["latency_ms"], rep["server"]
                log(f"[server] {mode} {name} (concurrency "
                    f"{rep['concurrency']}, depth {rep['pipeline_depth']}, "
                    f"{rep['rows_per_req']} rows x U[1,{rep['nnz_per_row']}]"
                    f" nnz, {rep['requests']} requests): qps {rep['qps']:.1f}"
                    f", rows/s {rep['rows_per_s']:.0f}, latency p50 "
                    f"{lm['p50']:.3f} p95 {lm['p95']:.3f} p99 "
                    f"{lm['p99']:.3f} ms, overload {rep['overload']}; in the "
                    f"server: {sv['calls']} engine calls of "
                    f"{sv['requests_per_call']:.2f} requests, enqueue to "
                    f"answer p50 {sv['p50_ms']:.3f} p99 {sv['p99_ms']:.3f} ms"
                    f" [{power}]")
        stats["breakdown"] = breakdown(torch, timer, engines, reqs, power)
        return {"launches": launches, "stats": stats}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# -- phase 4b: the telemetry exporter and SLOs -------------------------------

SLO_INTERVAL = 0.5         # DMLC_SLO_INTERVAL of [exporter]'s checks, s
TIMELINE_INTERVAL = 0.25   # DMLC_TIMELINE_INTERVAL of its checks, s
# a plain and a burn-rate rule that must fire (no request is answered in
# 0 s), and a pair that cannot (none waits an hour)
SLO_FIRES = ("serving.latency_s:max=0,serving.latency_s:field=p99:max=0:"
             "budget=0.5:fast=2s/1:slow=4s/1")
SLO_HOLDS = ("serving.latency_s:max=3600s,serving.latency_s:field=p99:"
             "max=3600s:budget=0.5:fast=2s/1:slow=4s/1")
EXPORTER_TRACED = 32       # traced predicts whose spans /spans must hold
EXPORTER_BLOCKS = 4        # load-1 blocks with the exporter off, and on
SCRAPE_S = 1.0             # the on blocks' scraper of /metrics
RENDER_REPS = 50           # renders of one /metrics page, timed
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")
_SCRAPES = {"connect_retries": 0}
# the exporter's long-lived threads: the sampler, the SLO monitor and the
# HTTP server's accept loop (each scrape's handler thread is short-lived)
EXPORTER_THREADS = ("dmlc-timeline", "dmlc-slo", "dmlc-telemetry")


def _thread_cpu_s(names: tuple) -> dict:
    """CPU seconds each live thread of ``names`` has used so far."""
    out = {}
    for t in threading.enumerate():
        if t.name in names and t.ident is not None:
            clock = time.pthread_getcpuclockid(t.ident)
            out[t.name] = out.get(t.name, 0.0) + time.clock_gettime(clock)
    return out


def _scrape(port: int, path: str, timeout: float = 30.0,
            connect_s: float = 2.0, tries: int = 8) -> tuple:
    """``GET http://127.0.0.1:port/path`` → (status, content type, body,
    seconds).  The connect is bounded apart and made again when it times
    out: about one loopback connect in 1,300 hangs on the card's
    machine (tools/loopback_connect_probe.py)."""
    import http.client
    import socket
    for _ in range(tries):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=connect_s)
        try:
            conn.connect()
        except (socket.timeout, TimeoutError):
            conn.close()
            _SCRAPES["connect_retries"] += 1
            continue
        try:
            conn.sock.settimeout(timeout)
            conn.request("GET", path)
            r = conn.getresponse()
            body = r.read().decode("utf-8")
            return (r.status, r.getheader("Content-Type"), body,
                    time.perf_counter() - t0)
        finally:
            conn.close()
    raise RuntimeError(f"[exporter] {tries} connects to :{port} timed out")


def _parse_exposition(page: str) -> dict:
    """Prometheus text format 0.0.4, strictly: one ``# TYPE`` a family,
    before its samples; each sample ``name{labels} value`` of the current
    family (a summary's ``_sum`` and ``_count`` too) with a float value;
    the page ends in a newline.  Returns {name{labels}: value}."""
    if not page.endswith("\n"):
        raise RuntimeError("[exporter] /metrics does not end in a newline")
    families, current, samples = set(), None, {}
    for ln in page.splitlines():
        if ln.startswith("# TYPE "):
            _, _, fam, typ = ln.split(" ")
            if fam in families or typ not in ("counter", "gauge",
                                              "summary"):
                raise RuntimeError(f"[exporter] bad TYPE line {ln!r}")
            families.add(fam)
            current = fam
            continue
        if ln.startswith("#"):
            continue
        m = _SAMPLE.match(ln)
        if (m is None or current is None or m.group(1) not in (
                current, current + "_sum", current + "_count")):
            raise RuntimeError(f"[exporter] bad sample line {ln!r}")
        samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return samples


class _Scraper:
    """A thread that GETs ``paths`` of an exporter every ``every_s``
    seconds until stopped; keeps each scrape's seconds."""

    def __init__(self, port: int, paths: tuple, every_s: float):
        self.port, self.paths, self.every_s = port, paths, every_s
        self.seconds = []
        self._stop = threading.Event()
        self.failed = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.every_s):
                for path in self.paths:
                    code, _, _, s = _scrape(self.port, path)
                    if code != 200:
                        raise RuntimeError(f"{path}: HTTP {code}")
                    self.seconds.append(s)
        except Exception as e:  # noqa: BLE001 — raised by stop()
            self.failed = e

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=60)
        if self.failed is not None:
            raise RuntimeError(f"[exporter] a scrape failed: "
                               f"{self.failed!r}")


def _exporter_fires(eng, shape: dict, power: str) -> dict:
    """Rules that must fire: run_load's load 1 through a server with the
    exporter and SLO_FIRES, scraped all along; /healthz must turn
    degraded within two SLO intervals of the first breach, both rules
    must fire, /metrics must parse and count what run_load counted, and
    /timeline must hold a point of serving.latency_s a sampler tick."""
    from dmlc_core_tpu_torch import PredictionServer, run_load
    from dmlc_core_tpu_torch.telemetry import timeseries
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    seen = {}
    stop = threading.Event()

    def watch():
        # the first breach on the registry, then /healthz until degraded
        while not stop.is_set() and "degraded" not in seen:
            if "breach" not in seen:
                if metrics.counter("slo.breaches").value > 0:
                    seen["breach"] = time.monotonic()
            else:
                code, _, body, _ = _scrape(port, "/healthz")
                if code == 200 and \
                        json.loads(body)["status"] == "degraded":
                    seen["degraded"] = time.monotonic()
            time.sleep(0.005)

    # the monitor reads its interval when it is made, the sampler when it
    # starts (with the exporter)
    with _env(DMLC_SLO_SPEC=SLO_FIRES, DMLC_SLO_INTERVAL=str(SLO_INTERVAL),
              DMLC_TIMELINE_INTERVAL=str(TIMELINE_INTERVAL),
              DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                               metrics_port=0).start()
    port = srv.telemetry.port
    watcher = threading.Thread(target=watch, daemon=True)
    try:
        watcher.start()
        scraper = _Scraper(port, ("/metrics", "/spans", "/timeline"), 1.0)
        t_load = time.monotonic()
        try:
            rep = run_load(srv.host, srv.port, requests=LOAD_REQUESTS,
                           features=F_FEATURES, seed=SEED, timeout=120.0,
                           **shape)
        finally:
            scraper.stop()
        watcher.join(timeout=20 * SLO_INTERVAL)
        stop.set()
        # the burn-rate rule needs its window's points: both fire within
        # a few intervals of load
        deadline = time.monotonic() + 10 * SLO_INTERVAL
        while (len({b["rule"] for b in srv.slo_monitor.breaches}) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        if "degraded" not in seen:
            raise RuntimeError(f"[exporter] /healthz never turned degraded "
                               f"({seen}, slo.breaches "
                               f"{metrics.counter('slo.breaches').value})")
        lag = seen["degraded"] - seen["breach"]
        if lag > 2 * SLO_INTERVAL:
            raise RuntimeError(f"[exporter] /healthz degraded {lag:.3f} s "
                               f"after the first breach (limit "
                               f"{2 * SLO_INTERVAL} s)")
        if (rep["rejected"] or rep["errors"] or rep["overload"]
                or rep["ok"] != LOAD_REQUESTS):
            raise RuntimeError(f"[exporter] load 1: {rep}")
        samples = _parse_exposition(_scrape(port, "/metrics")[2])
        want = {"dmlc_serving_batcher_requests_total": rep["ok"],
                "dmlc_serving_latency_s_count": rep["ok"],
                "dmlc_serving_batcher_batches_total": srv.batcher.batches}
        got = {k: samples.get(k) for k in want}
        if got != want:
            raise RuntimeError(f"[exporter] /metrics counts {got}, run_load "
                               f"and the batcher counted {want}")
        if samples.get("dmlc_slo_breaches_total", 0) < 1:
            raise RuntimeError("[exporter] /metrics shows no breach")
        ticks = metrics.counter("telemetry.timeline.samples").value
        code, _, body, _ = _scrape(
            port, "/timeline?metric=serving.latency_s")
        doc = json.loads(body)
        points = doc["series"]["serving.latency_s.p99"]["tiers"][0]["points"]
        # the histogram exists from the batcher's construction, before the
        # sampler's first tick: one point a tick, the scrape racing one
        if code != 200 or len(points) < max(4, ticks - 1):
            raise RuntimeError(f"[exporter] /timeline: {len(points)} points "
                               f"of serving.latency_s.p99 after {ticks} "
                               f"sampler ticks")
        fired = {b["rule"] for b in srv.slo_monitor.breaches}
        if len(fired) != 2:
            raise RuntimeError(f"[exporter] the rules that must fire: "
                               f"{fired}")
        if json.loads(_scrape(port, "/healthz")[2])["status"] != \
                "degraded" or srv.health != "degraded":
            raise RuntimeError("[exporter] health recovered under a breach")
    finally:
        stop.set()
        srv.stop()
        timeseries.history.stop()     # the exporter's stop leaves it on
    out = {"qps": rep["qps"], "latency_ms": rep["latency_ms"],
           "breach_to_degraded_s": lag,
           "load_to_first_breach_s": seen["breach"] - t_load,
           "timeline_points": len(points),
           "sampler_ticks": ticks, "batches": srv.batcher.batches,
           "slo_breaches": samples["dmlc_slo_breaches_total"],
           "scrape_ms_p50": 1e3 * float(np.median(scraper.seconds)),
           "scrapes": len(scraper.seconds)}
    metrics.gauge("slo.active_breaches").set(0)   # the monitor stopped
    log(f"[exporter] rules that must fire ({SLO_FIRES}): load 1 "
        f"{rep['qps']:.1f} qps, p99 {rep['latency_ms']['p99']:.3f} ms; "
        f"both fired, {out['slo_breaches']:.0f} breaches, the first "
        f"{out['load_to_first_breach_s'] * 1e3:.1f} ms into the load; "
        f"/healthz degraded {lag * 1e3:.1f} ms after it (limit "
        f"{2e3 * SLO_INTERVAL:.0f} ms); /metrics parses as 0.0.4 and counts "
        f"{rep['ok']} requests and {srv.batcher.batches} batches as run_load "
        f"and the batcher did; /timeline {len(points)} points of "
        f"serving.latency_s.p99 over {ticks} sampler ticks; "
        f"{len(scraper.seconds)} scrapes of /metrics /spans /timeline, "
        f"p50 {out['scrape_ms_p50']:.2f} ms [{power}]")
    return out


def _exporter_holds(eng, reqs: list, p1: dict, power: str) -> dict:
    """Rules that cannot fire: EXPORTER_TRACED traced predicts through a
    PredictClient; /spans must hold each one's server and engine spans
    under the client's trace id, and /healthz must stay ok over three
    SLO intervals."""
    from dmlc_core_tpu_torch import PredictClient, PredictionServer
    from dmlc_core_tpu_torch.telemetry import timeseries
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    with _env(DMLC_SLO_SPEC=SLO_HOLDS, DMLC_SLO_INTERVAL=str(SLO_INTERVAL),
              DMLC_TIMELINE_INTERVAL=str(TIMELINE_INTERVAL),
              DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                               metrics_port=0).start()
    port = srv.telemetry.port
    try:
        teltrace.recorder.clear()
        with PredictClient(srv.host, srv.port) as client:
            answers = [client.predict(*r, timeout=120)
                       for r in reqs[:EXPORTER_TRACED]]
        for j in (0, EXPORTER_TRACED // 2, EXPORTER_TRACED - 1):
            want = _fm_f64(p1, *reqs[j])
            if (answers[j].shape != want.shape or not np.allclose(
                    answers[j], want, atol=ATOL_F64, rtol=0)):
                raise RuntimeError(f"[exporter] request {j}: max |err| "
                                   f"against a float64 FM "
                                   f"{np.abs(answers[j] - want).max():.3g}")
        tids = {r["trace_id"] for r in teltrace.recorder.snapshot()
                if r["name"] == "serving.client.predict"}
        code, _, body, _ = _scrape(port, "/spans")
        doc = json.loads(body)
        if code != 200 or doc["dropped"] != teltrace.recorder.dropped:
            raise RuntimeError(f"[exporter] /spans: HTTP {code}, dropped "
                               f"{doc.get('dropped')}")
        chains = _serving_chains([r for r in doc["spans"]
                                  if r["trace_id"] in tids], len(tids))
        if len(tids) != EXPORTER_TRACED:
            raise RuntimeError(f"[exporter] {len(tids)} client traces")
        t_end = time.monotonic() + 3 * SLO_INTERVAL
        polls = 0
        while time.monotonic() < t_end:
            code, _, body, _ = _scrape(port, "/healthz")
            if code != 200 or json.loads(body)["status"] != "ok":
                raise RuntimeError(f"[exporter] rules that cannot fire: "
                                   f"/healthz {code} {body}")
            polls += 1
            time.sleep(0.05)
        if metrics.counter("slo.breaches").value or srv.slo_monitor.breaches:
            raise RuntimeError("[exporter] a rule that cannot fire fired")
    finally:
        srv.stop()
        timeseries.history.stop()
    log(f"[exporter] rules that cannot fire ({SLO_HOLDS}): {EXPORTER_TRACED}"
        f" traced predicts (three against a float64 FM within {ATOL_F64}); "
        f"/spans holds each one's server and engine span under the client's "
        f"trace id ({len(doc['spans'])} records, dropped {doc['dropped']}); "
        f"/healthz ok in {polls} polls over {3 * SLO_INTERVAL} s, no breach "
        f"[{power}]")
    return {"batches": srv.batcher.batches, "chains": chains}


def _load1_block(eng, shape: dict, on: bool) -> tuple:
    """One block of load 1: ``on`` with the exporter, the sampler at its
    default 1 s, the SLO monitor (rules that cannot fire, its default
    interval) and a scraper of /metrics at 1 Hz; off with none of them.
    Returns (run_load's report, the batcher's batches, scrape seconds,
    the process's CPU seconds over the load, the CPU seconds of the
    exporter's long-lived threads, the sampler's ticks)."""
    from dmlc_core_tpu_torch import PredictionServer, run_load
    from dmlc_core_tpu_torch.telemetry import timeseries
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    if timeseries.history.running:
        raise RuntimeError("[exporter] the history sampler runs in a block")
    with _env(DMLC_SLO_SPEC=SLO_HOLDS if on else None, DMLC_SLO_INTERVAL=None,
              DMLC_TIMELINE_INTERVAL=None, DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                               metrics_port=0 if on else None).start()
    scraper = None
    try:
        if on:
            scraper = _Scraper(srv.telemetry.port, ("/metrics",), SCRAPE_S)
        cpu0 = time.process_time()
        rep = run_load(srv.host, srv.port, requests=LOAD_REQUESTS,
                       features=F_FEATURES, seed=SEED, timeout=120.0,
                       **shape)
        cpu_s = time.process_time() - cpu0
        threads_s = _thread_cpu_s(EXPORTER_THREADS)
        ticks = metrics.counter("telemetry.timeline.samples").value
    finally:
        if scraper is not None:
            scraper.stop()
        srv.stop()
        timeseries.history.stop()     # the exporter's stop leaves it on
    if (rep["rejected"] or rep["errors"] or rep["overload"]
            or rep["ok"] != LOAD_REQUESTS):
        raise RuntimeError(f"[exporter] load 1 ({'on' if on else 'off'}): "
                           f"{rep}")
    return (rep, srv.batcher.batches, scraper.seconds if scraper else [],
            cpu_s, threads_s, ticks)


def phase_exporter(torch, power: str) -> dict:
    """[exporter]: the telemetry exporter and the SLO monitor around the
    served FM (2^20 x 32, padded ladder, every bucket a captured graph,
    [server]'s checkpoint and requests): rules that must fire degrade
    /healthz, rules that cannot keep it ok, /metrics /spans /timeline
    are read while run_load drives the server; then load 1 in blocks with
    the exporter, sampler, monitor and a 1 Hz scraper off and on, in
    turns, and the host's time to render one /metrics page.  Returns the
    kernel launches counted over it and its numbers."""
    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.telemetry import exposition, timeseries
    from dmlc_core_tpu_torch.utils.metrics import metrics
    t_phase = time.monotonic()
    shape = dict(LOADS)["load1"]
    ckpt = os.path.join(ROOT, ".chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        p1 = _np_params(SEED + 1)
        CheckpointManager(ckpt).save(1, {"params": p1}, meta={"model": "fm"})
        reqs = _requests(np.random.default_rng(SEED + 3), 72)
        eng = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                                   device="cuda"),
                              buckets=BucketLadder.default(),
                              postprocess="sigmoid", device="cuda")
        if eng.reload_from_checkpoint(ckpt, step=1) != 1:
            raise RuntimeError("[exporter] restored the wrong step")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    reset_launch_counts()                     # the main path starts here
    fires = _exporter_fires(eng, shape, power)
    holds = _exporter_holds(eng, reqs, p1, power)
    batches = fires["batches"] + holds["batches"]
    blocks = []
    # off, on, on, off, ...: a drift over the phase weighs on both alike
    for i in range(2 * EXPORTER_BLOCKS):
        on = i % 4 in (1, 2)
        rep, b, scrapes, cpu_s, threads_s, ticks = _load1_block(eng, shape,
                                                                on)
        batches += b
        if on and set(threads_s) != set(EXPORTER_THREADS):
            raise RuntimeError(f"[exporter] an on block's threads: "
                               f"{sorted(threads_s)}")
        if not on and threads_s:
            raise RuntimeError(f"[exporter] an off block runs "
                               f"{sorted(threads_s)}")
        blocks.append({"state": "on" if on else "off", "qps": rep["qps"],
                       "p50_ms": rep["latency_ms"]["p50"],
                       "p99_ms": rep["latency_ms"]["p99"],
                       "cpu_ms_per_request": 1e3 * cpu_s / rep["ok"],
                       "cpu_s": cpu_s, "wall_s": rep["wall_s"],
                       "sampler_ticks": ticks,
                       "thread_cpu_ms": {k: 1e3 * v
                                         for k, v in threads_s.items()},
                       "scrapes": len(scrapes),
                       "scrape_ms": 1e3 * float(np.median(scrapes))
                       if scrapes else None})
        log(f"[exporter] load 1 block {i + 1} ({blocks[-1]['state']}): "
            f"{rep['qps']:.1f} qps, p50 {rep['latency_ms']['p50']:.3f} p99 "
            f"{rep['latency_ms']['p99']:.3f} ms, the process's CPU "
            f"{blocks[-1]['cpu_ms_per_request']:.3f} ms a request"
            + (f", {len(scrapes)} scrapes of /metrics, p50 "
               f"{blocks[-1]['scrape_ms']:.2f} ms; the exporter's threads' "
               f"CPU " + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
                   blocks[-1]["thread_cpu_ms"].items())) if on else "")
            + f" [{power}]")
    torch.cuda.synchronize()
    launches = launch_counts()                # the main path ends here
    for name in ("ragged_gather_fm", "ragged_gather_embed"):
        if launches.get(name, 0) != batches + eng.compile_count:
            raise RuntimeError(f"[exporter] {name}: {launches.get(name, 0)} "
                               f"launches, expected one a call and one a "
                               f"warm-up ({batches} + {eng.compile_count})")
    # the host's cost of one /metrics page (the last block's registry), of
    # one tick of the sampler and of the snapshot an SLO evaluation takes
    snap_s, render_s, tick_s = [], [], []
    for _ in range(RENDER_REPS):
        t0 = time.perf_counter()
        snap = metrics.snapshot()
        t1 = time.perf_counter()
        page = exposition.render_prometheus(snap)
        t2 = time.perf_counter()
        timeseries.history.sample_once()
        t3 = time.perf_counter()
        snap_s.append(t1 - t0)
        render_s.append(t2 - t0)
        tick_s.append(t3 - t2)
    qps = {s: [b["qps"] for b in blocks if b["state"] == s]
           for s in ("off", "on")}
    p99 = {s: [b["p99_ms"] for b in blocks if b["state"] == s]
           for s in ("off", "on")}
    cpu = {s: [b["cpu_ms_per_request"] for b in blocks if b["state"] == s]
           for s in ("off", "on")}
    out = {"fires": fires, "holds": holds["chains"], "blocks": blocks,
           "qps_on_off": float(np.median(qps["on"]) / np.median(qps["off"])),
           "p99_on_off": float(np.median(p99["on"]) / np.median(p99["off"])),
           "cpu_on_off": float(np.median(cpu["on"]) / np.median(cpu["off"])),
           # each on block over the off block beside it
           "pair_qps_on_off": [blocks[i + 1]["qps"] / blocks[i]["qps"]
                               if i % 4 == 0 else
                               blocks[i]["qps"] / blocks[i + 1]["qps"]
                               for i in range(0, len(blocks), 2)],
           "render_ms": 1e3 * float(np.median(render_s)),
           "snapshot_ms": 1e3 * float(np.median(snap_s)),
           "sampler_tick_ms": 1e3 * float(np.median(tick_s)),
           "page_bytes": len(page.encode("utf-8")),
           # the exporter's host work in the on blocks over the process's
           # CPU: its threads' CPU clocks (which may tick coarsely) plus a
           # page rendered a scrape; and built from parts instead, a tick
           # a sampler tick, a render a scrape, a snapshot each default
           # SLO interval (5 s)
           "exporter_cpu_share": sum(
               sum(b["thread_cpu_ms"].values())
               + b["scrapes"] * 1e3 * float(np.median(render_s))
               for b in blocks if b["state"] == "on")
           / sum(1e3 * b["cpu_s"] for b in blocks if b["state"] == "on"),
           "exporter_parts_share": sum(
               b["sampler_ticks"] * 1e3 * float(np.median(tick_s))
               + b["scrapes"] * 1e3 * float(np.median(render_s))
               + b["wall_s"] / 5.0 * 1e3 * float(np.median(snap_s))
               for b in blocks if b["state"] == "on")
           / sum(1e3 * b["cpu_s"] for b in blocks if b["state"] == "on"),
           "page_families": page.count("# TYPE "),
           "connect_retries": _SCRAPES["connect_retries"]}
    log(f"[exporter] load 1 on / off: qps medians {np.median(qps['on']):.1f} "
        f"/ {np.median(qps['off']):.1f} = {out['qps_on_off']:.4f} (pairs "
        + ", ".join(f"{r:.4f}" for r in out["pair_qps_on_off"])
        + f"), p99 {out['p99_on_off']:.4f}, the process's CPU a request "
        f"{out['cpu_on_off']:.4f}; one /metrics page "
        f"{out['page_bytes']} bytes, {out['page_families']} families, "
        f"rendered in {out['render_ms']:.3f} ms on the host (the snapshot "
        f"{out['snapshot_ms']:.3f} ms of it), a sampler tick "
        f"{out['sampler_tick_ms']:.3f} ms; in the on blocks the exporter's "
        f"threads and renders {100 * out['exporter_cpu_share']:.3f} % of "
        f"the process's CPU by their clocks, "
        f"{100 * out['exporter_parts_share']:.3f} % from the parts' times; "
        f"{out['connect_retries']} scrape "
        f"connects retried [{power}]")
    log(f"[exporter] kernel launches: {launches} over {batches} engine "
        f"calls and {eng.compile_count} warm-ups; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "stats": out}


# -- phase 4c: incidents (wide events, tail sampling, the flight recorder) ---

INCIDENT_WINDOW = 2.0      # the flight recorder's rate-limit window, s
INCIDENT_SLO = "serving.latency_s:max=0"   # a rule that must fire
# a handful of admissions shed at the load's start (run_load does not retry)
INCIDENT_FAULTS = "serving.server.admit:error=1:times=5"
INCIDENT_SHED = 5
INCIDENT_FLOOR = 0.01      # DMLC_TRACE_SAMPLE
INCIDENT_TRACED = 400      # traced predicts, one PredictClient, in turn
# the traced predicts' faults: a shed (the client retries it) or a 30 ms
# stall at admission, each on about one call in twenty
TRACED_FAULTS = "serving.server.admit:error=0.05:latency=30ms:lp=0.05:seed=7"
KEEP_SLOW_MS = 20.0        # DMLC_TRACE_KEEP_SLOW_MS of the traced predicts
INCIDENT_BLOCKS = 4        # load-1 blocks with the sampler off, and on
COST_CALLS = 20_000        # wide events, and engine spans, timed
DUMP_REPS = 5              # incident bundles dumped, timed
ENGINE_FAMILIES = tuple(f"dmlc_serving_engine_{n}" for n in (
    "batches_total", "compiles_total", "forward_count",
    "forward_mean_seconds", "forward_seconds_total", "occupancy",
    "padding_ratio", "params_version", "rows_rate", "rows_total",
    "rows_windowed_rate"))
_OK = ("OK", "ok", None)


def _incident_bundles(d: str) -> list:
    """Every bundle under ``d``, in dump order: (dir name, incident.json,
    the files the directory holds)."""
    out = []
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        if not name.startswith("incident-"):
            continue
        path = os.path.join(d, name)
        with open(os.path.join(path, "incident.json")) as f:
            doc = json.load(f)
        with open(os.path.join(path, "trace.json")) as f:
            if not isinstance(json.load(f).get("traceEvents"), list):
                raise RuntimeError(f"[incident] {name}: trace.json")
        out.append((name, doc, sorted(os.listdir(path))))
    return out


def _check_bundle(name: str, doc: dict, files: list) -> None:
    """incident.json, trace.json and log_tail.txt; profile.txt,
    diagnosis.json and diagnosis.txt (the incident profile and the
    diagnosis are on by default); timeline.json, critical_path.txt and
    profile_diff.txt exactly where the history had series, the ring
    complete spans and a baseline profile was recorded; the schema;
    files as listed."""
    want = {"incident.json", "trace.json", "log_tail.txt", "profile.txt",
            "diagnosis.json", "diagnosis.txt"}
    for key, fname in (("timeline", "timeline.json"),
                       ("critical_path", "critical_path.txt"),
                       ("profile_diff", "profile_diff.txt")):
        if doc.get(key):
            want.add(fname)
    prof = doc.get("profile_collapsed")
    if (not isinstance(prof, str) or not prof or prof.startswith("<")
            or not isinstance(doc.get("diagnosis"), dict)):
        raise RuntimeError(f"[incident] {name}: profile {str(prof)[:80]!r}, "
                           f"diagnosis {str(doc.get('diagnosis'))[:80]!r}")
    if set(files) != want or set(doc["files"].values()) != want:
        raise RuntimeError(f"[incident] {name}: files {files}, listed "
                           f"{doc['files']}")
    if doc["schema"] != "dmlc.flight.incident/1":
        raise RuntimeError(f"[incident] {name}: schema {doc['schema']}")


def _record_view(r) -> dict:
    return r if isinstance(r, dict) else r.record()


def _expected_keep(tid: int, recs: list, timed_out: bool) -> tuple:
    """The verdict the sampler owes a trace, worked out here from its
    records: (keep, errored, slow, floor).  Errored: a record with an
    ``error`` or a status other than OK; slow: its local root (the
    longest span whose parent is not in the trace here) over
    KEEP_SLOW_MS; floor: the hash floor."""
    from dmlc_core_tpu_torch.telemetry import sampling
    recs = [_record_view(r) for r in recs]
    errored = any((r.get("attrs") or {}).get("error") is not None
                  or (r.get("attrs") or {}).get("status") not in _OK
                  for r in recs)
    spans = [r for r in recs if r.get("kind") == "span"]
    ids = {r["span_id"] for r in spans}
    roots = [r for r in spans
             if not r.get("parent_id") or r["parent_id"] not in ids] or spans
    slow = (bool(spans) and not timed_out
            and max(r["dur_us"] for r in roots) / 1e3 > KEEP_SLOW_MS)
    floor = sampling.hash_keep(tid, INCIDENT_FLOOR)
    debug = bool(tid & sampling.DEBUG_BIT)
    return debug or errored or slow or floor, errored, slow, floor


def _events(port: int, since: int, n: int, timeout: float = 30.0) -> dict:
    """/events?since= once it holds ``n`` events (the server emits a
    request's event just after its answer)."""
    deadline = time.monotonic() + timeout
    while True:
        code, _, body, _ = _scrape(port, f"/events?since={since}")
        doc = json.loads(body)
        if code != 200:
            raise RuntimeError(f"[incident] /events: HTTP {code}")
        if len(doc["events"]) >= n or time.monotonic() > deadline:
            return doc
        time.sleep(0.05)


def _incident_load(eng, shape: dict, fdir: str, power: str) -> dict:
    """(a) load 1 through a server with DMLC_FLIGHT_DIR, DMLC_TRACE_SAMPLE,
    a rule that must fire and INCIDENT_FAULTS, all through the server's
    own construction: one serving.request event a request run_load sent
    (the sheds too), every field in FIELDS; the sampler decides every
    engine call (each a root: run_load sends untraced); one bundle a
    rate-limit window (one injected_fault, then slo_breach ones), each
    with its files; /flight inline; /metrics with the engine's families
    and its batches equal to the engine calls."""
    from dmlc_core_tpu_torch import PredictionServer, run_load
    from dmlc_core_tpu_torch.telemetry import (flight, sampling, timeseries,
                                               wide_events)
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    first = wide_events.wide_log.doc()["last_seq"]
    # each dump that writes, by reason, at its start on the rate limit's
    # clock: a bundle's sections take varying time before its ts is set
    rec = flight.flight_recorder
    starts = []

    def timed_dump(reason, *a, **k):
        t = time.monotonic()
        path = dump(reason, *a, **k)
        if path is not None:
            starts.append((reason, t))
        return path

    dump, rec.dump = rec.dump, timed_dump
    with _env(DMLC_FLIGHT_DIR=fdir, DMLC_TRACE_SAMPLE=str(INCIDENT_FLOOR),
              DMLC_TRACE_KEEP_SLOW_MS=None, DMLC_SLO_SPEC=INCIDENT_SLO,
              DMLC_SLO_INTERVAL=str(SLO_INTERVAL),
              DMLC_TIMELINE_INTERVAL=str(TIMELINE_INTERVAL),
              DMLC_FAULT_SPEC=INCIDENT_FAULTS, DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                               metrics_port=0).start()
        port = srv.telemetry.port
        try:
            if not flight.flight_recorder.armed or \
                    sampling.get_sampler() is None:
                raise RuntimeError("[incident] the server armed no recorder "
                                   "or installed no sampler")
            # the history's first ticks before the load: the first bundle
            # then carries a timeline too
            time.sleep(2 * TIMELINE_INTERVAL)
            t_load = time.time()
            rep = run_load(srv.host, srv.port, requests=LOAD_REQUESTS,
                           features=F_FEATURES, seed=SEED, timeout=120.0,
                           **shape)
            t_end = time.time()
            doc = _events(port, first, LOAD_REQUESTS)
            # the rule stays breached while the monitor runs: hold the
            # server until two slo_breach bundles are begun (by name: a
            # bundle's files land one by one; they are read after stop)
            deadline = time.monotonic() + 4 * INCIDENT_WINDOW + 5.0
            while (sum(n.endswith("-slo_breach") for n in os.listdir(fdir))
                   < 2 and time.monotonic() < deadline):
                time.sleep(0.05)
            batches = srv.batcher.batches
            page = _scrape(port, "/metrics")[2]
            samples = _parse_exposition(page)
            s = sampling.get_sampler()
            decided = {k: metrics.counter(f"telemetry.sampling.{k}").value
                       for k in ("kept", "dropped", "keep_slo",
                                 "keep_floor", "keep_slow", "keep_error")}
            t_flight = time.perf_counter()
            code, _, body, _ = _scrape(port, "/flight")
            flight_ms = 1e3 * (time.perf_counter() - t_flight)
            inline = json.loads(body)
        finally:
            srv.stop()
            timeseries.history.stop()
            del rec.dump
    if (rep["overload"] != INCIDENT_SHED or rep["rejected"] or rep["errors"]
            or rep["ok"] != LOAD_REQUESTS - INCIDENT_SHED):
        raise RuntimeError(f"[incident] load 1: {rep}")
    evs = [e for e in doc["events"] if e["kind"] == "serving.request"]
    outcomes = collections.Counter(e["outcome"] for e in evs)
    fields = set().union(*(set(e) for e in doc["events"]))
    if (len(evs) != LOAD_REQUESTS or doc["missed"]
            or outcomes != {"OK": rep["ok"], "OVERLOADED": INCIDENT_SHED}
            or not fields <= wide_events.FIELDS):
        raise RuntimeError(f"[incident] /events: {len(evs)} serving.request "
                           f"events ({dict(outcomes)}, missed "
                           f"{doc['missed']}) for {LOAD_REQUESTS} requests; "
                           f"fields outside FIELDS: "
                           f"{sorted(fields - wide_events.FIELDS)}")
    if decided["kept"] + decided["dropped"] != batches:
        raise RuntimeError(f"[incident] the sampler decided "
                           f"{decided['kept'] + decided['dropped']} traces "
                           f"over {batches} engine calls")
    bundles = _incident_bundles(fdir)
    for name, bdoc, files in bundles:
        _check_bundle(name, bdoc, files)
    if code != 200 or inline["schema"] != "dmlc.flight.incident/1" or \
            not inline.get("dumped_to", "").startswith(fdir):
        raise RuntimeError(f"[incident] /flight: HTTP {code}, "
                           f"{inline.get('schema')}")
    timed = [b for b in bundles if b[1]["reason"] != "endpoint"]
    reasons = [b[1]["reason"] for b in timed]
    if (reasons[:1] != ["injected_fault"] or reasons.count("injected_fault")
            != 1 or reasons.count("slo_breach") < 2
            or len(reasons) != 1 + reasons.count("slo_breach")):
        raise RuntimeError(f"[incident] bundles {reasons}: one "
                           f"injected_fault, then slo_breach ones")
    starts.sort(key=lambda rt: rt[1])
    begun = [t for reason, t in starts if reason != "endpoint"]
    if [r for r, _ in starts if r != "endpoint"] != reasons:
        raise RuntimeError(f"[incident] dumps {starts}, bundles {reasons}")
    gaps = [b - a for a, b in zip(begun, begun[1:])]
    # one bundle a window: never two in one (a gap under a window), and
    # none missed while the rule held (a gap of two windows or more)
    if not all(INCIDENT_WINDOW - 0.05 <= g < 2 * INCIDENT_WINDOW
               for g in gaps):
        raise RuntimeError(f"[incident] bundle gaps {gaps} s, window "
                           f"{INCIDENT_WINDOW} s")
    if metrics.counter("flight.fault_triggers").value != INCIDENT_SHED:
        raise RuntimeError("[incident] flight.fault_triggers "
                           f"{metrics.counter('flight.fault_triggers').value}")
    missing = [f for f in ENGINE_FAMILIES if f"# TYPE {f} " not in page]
    want = {"dmlc_serving_engine_batches_total": batches,
            "dmlc_serving_engine_forward_count": batches,
            "dmlc_serving_engine_compiles_total": eng.compile_count,
            "dmlc_telemetry_wide_events_emitted_total": LOAD_REQUESTS}
    got = {k: samples.get(k) for k in want}
    if missing or got != want:
        raise RuntimeError(f"[incident] /metrics: missing {missing}, counts "
                           f"{got}, expected {want}")
    log(f"[incident] (a) load 1 with DMLC_FLIGHT_DIR, DMLC_TRACE_SAMPLE="
        f"{INCIDENT_FLOOR}, DMLC_SLO_SPEC={INCIDENT_SLO} and DMLC_FAULT_SPEC="
        f"{INCIDENT_FAULTS}: {rep['qps']:.1f} qps, p99 "
        f"{rep['latency_ms']['p99']:.3f} ms, {rep['overload']} shed; /events "
        f"{len(evs)} serving.request events ({dict(outcomes)}), every field "
        f"in FIELDS; the sampler decided {batches} engine calls "
        f"({decided}); bundles {reasons} at gaps "
        + ", ".join(f"{g:.3f}" for g in gaps)
        + f" s (window {INCIDENT_WINDOW} s), each with "
        f"{', '.join(timed[-1][2])}; /flight inline in {flight_ms:.1f} ms; "
        f"/metrics has the {len(ENGINE_FAMILIES)} dmlc_serving_engine_* "
        f"families, batches {batches} = the engine calls [{power}]")
    return {"qps": rep["qps"], "latency_ms": rep["latency_ms"],
            "events": len(evs), "batches": batches, "decided": decided,
            "bundles": reasons, "bundle_gaps_s": gaps,
            "flight_endpoint_ms": flight_ms, "load_s": t_end - t_load}


def _incident_traced(eng, fdir: str, power: str) -> dict:
    """(b) INCIDENT_TRACED predicts, each its own trace (client, server,
    engine), through a server with DMLC_TRACE_KEEP_SLOW_MS and
    TRACED_FAULTS, no SLO rule: every trace the sampler decides is
    captured with its records, and its verdict must be the one worked out
    here (errored, or slow, or under the hash floor); the recorder holds
    exactly the kept traces; kept + dropped = the traced predicts; the
    errored traces are those /events shows shed."""
    from dmlc_core_tpu_torch import PredictClient, PredictionServer
    from dmlc_core_tpu_torch.telemetry import sampling, timeseries
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.telemetry import wide_events
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    metrics.gauge("slo.active_breaches").set(0)
    sampling.uninstall()
    teltrace.recorder.clear()
    first = wide_events.wide_log.doc()["last_seq"]
    groups = []
    reqs = _requests(np.random.default_rng(SEED + 5), 64)
    with _env(DMLC_FLIGHT_DIR=fdir, DMLC_TRACE_SAMPLE=str(INCIDENT_FLOOR),
              DMLC_TRACE_KEEP_SLOW_MS=str(KEEP_SLOW_MS), DMLC_SLO_SPEC=None,
              DMLC_FAULT_SPEC=TRACED_FAULTS, DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                               metrics_port=0).start()
        s = sampling.get_sampler()
        decide = s.buffer._decide

        def capture(group, timed_out):
            groups.append((group.trace_id, list(group.records), timed_out,
                           threading.current_thread().name))
            decide(group, timed_out=timed_out)

        s.buffer._decide = capture
        try:
            t0 = time.perf_counter()
            with PredictClient(srv.host, srv.port) as client:
                for i in range(INCIDENT_TRACED):
                    out = client.predict(*reqs[i % len(reqs)], timeout=120)
                    if not np.isfinite(out).all():
                        raise RuntimeError("[incident] a traced predict's "
                                           "scores are not finite")
            wall = time.perf_counter() - t0
            s.flush()
            doc = _events(srv.telemetry.port, first, INCIDENT_TRACED)
        finally:
            s.buffer._decide = decide
            srv.stop()
            timeseries.history.stop()
    kept = {r["trace_id"] for r in teltrace.recorder.snapshot()}
    shed = {e["trace_id"] for e in doc["events"]
            if e.get("outcome") == "OVERLOADED"}
    tally = collections.Counter()
    wrong = []
    for tid, recs, timed_out, _ in groups:
        keep, errored, slow, floor = _expected_keep(tid, recs, timed_out)
        hexid = teltrace.format_id(tid)
        tally.update({"errored": errored, "slow": slow and not errored,
                      "floor": floor and not (errored or slow),
                      "kept": keep})
        if (s.verdict(tid) is not keep or (hexid in kept) != keep
                or (hexid in shed) != errored):
            wrong.append((hexid, keep, s.verdict(tid), errored,
                          hexid in shed))
    decided = (metrics.counter("telemetry.sampling.kept").value
               + metrics.counter("telemetry.sampling.dropped").value)
    threads = collections.Counter(g[3] for g in groups)
    if (wrong or len(groups) != INCIDENT_TRACED or decided != INCIDENT_TRACED
            or metrics.counter("telemetry.sampling.keep_slo").value):
        raise RuntimeError(f"[incident] (b) {len(groups)} traces decided "
                           f"({decided} counted) for {INCIDENT_TRACED} "
                           f"traced predicts; verdicts that depart from "
                           f"errored | slow | hash floor: {wrong[:5]}")
    if not tally["errored"] or not tally["slow"]:
        raise RuntimeError(f"[incident] (b) no errored or no slow trace "
                           f"({dict(tally)}): the faults did not fire")
    log(f"[incident] (b) {INCIDENT_TRACED} traced predicts in {wall:.2f} s "
        f"(DMLC_TRACE_KEEP_SLOW_MS={KEEP_SLOW_MS:g}, DMLC_FAULT_SPEC="
        f"{TRACED_FAULTS}): kept {tally['kept']} = {tally['errored']} "
        f"errored + {tally['slow']} slow + {tally['floor']} under the hash "
        f"floor only, exactly the sampler's verdicts and the recorder's "
        f"traces; kept + dropped = {decided}; the errored traces are the "
        f"{len(shed)} /events shows shed; decided on {dict(threads)} "
        f"[{power}]")
    return {"decided": decided, "kept": tally["kept"],
            "errored": tally["errored"], "slow": tally["slow"],
            "floor_only": tally["floor"], "wall_s": wall,
            "batches": srv.batcher.batches,
            "decide_threads": dict(threads)}


def _incident_sigterm(ckpt: str, fdir: str, power: str) -> dict:
    """(c) the port's server as a user starts it (python -m
    dmlc_core_tpu_torch.serving.server, the same FM and checkpoint on the
    card) with DMLC_FLIGHT_DIR: SIGTERM after ``serving on`` must leave a
    fatal_signal bundle and end the process by the signal."""
    import select
    import signal
    env = _cli_env()
    env.update(DMLC_FLIGHT_DIR=fdir, DMLC_TRACE_SAMPLE=str(INCIDENT_FLOOR))
    for key in ("DMLC_SLO_SPEC", "DMLC_FAULT_SPEC", "DMLC_METRICS_PORT"):
        env.pop(key, None)
    log_path = os.path.join(fdir + ".log")
    t0 = time.monotonic()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.serving.server",
             f"ckpt_dir={ckpt}", "model=fm", f"features={F_FEATURES}",
             f"dim={DIM}", "host=127.0.0.1", "port=0", "watch_s=3600"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=log_file,
            text=True)
        try:
            line = ""
            while "serving on" not in line:
                left = t0 + 300 - time.monotonic()
                if left <= 0 or proc.poll() is not None:
                    with open(log_path) as f:
                        raise RuntimeError(f"[incident] serve_main did not "
                                           f"come up: {f.read()[-2000:]}")
                if select.select([proc.stdout], [], [], left)[0]:
                    line = proc.stdout.readline()
            up_s = time.monotonic() - t0
            t1 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            down_s = time.monotonic() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    bundles = _incident_bundles(fdir)
    if rc != -signal.SIGTERM or [b[1]["reason"] for b in bundles] != \
            ["fatal_signal"]:
        raise RuntimeError(f"[incident] (c) SIGTERM: exit {rc}, bundles "
                           f"{[b[0] for b in bundles]}")
    name, doc, files = bundles[0]
    _check_bundle(name, doc, files)
    if doc["detail"] != {"signal": "SIGTERM"} or doc["pid"] == os.getpid():
        raise RuntimeError(f"[incident] (c) {name}: {doc['detail']}")
    log(f"[incident] (c) serve_main (model=fm, 2^20 x 32, on the card) up "
        f"in {up_s:.2f} s; SIGTERM: exit {rc} in {down_s * 1e3:.1f} ms, "
        f"bundle {name} ({', '.join(files)}) [{power}]")
    return {"up_s": up_s, "sigterm_exit_ms": 1e3 * down_s, "rc": rc}


def _incident_block(eng, shape: dict, on: bool) -> tuple:
    """One block of load 1: ``on`` with the tail sampler (DMLC_TRACE_SAMPLE
    at INCIDENT_FLOOR), off without; wide events in both.  Returns
    (run_load's report, the batcher's batches, the process's CPU seconds
    over the load, the traces decided)."""
    from dmlc_core_tpu_torch import PredictionServer, run_load
    from dmlc_core_tpu_torch.telemetry import sampling
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    sampling.uninstall()
    with _env(DMLC_TRACE_SAMPLE=str(INCIDENT_FLOOR) if on else None,
              DMLC_TRACE_KEEP_SLOW_MS=None, DMLC_FLIGHT_DIR=None,
              DMLC_SLO_SPEC=None, DMLC_FAULT_SPEC=None,
              DMLC_METRICS_PORT=None):
        srv = PredictionServer(eng, warmup=True,
                               default_deadline_s=60.0).start()
    try:
        if (sampling.get_sampler() is not None) != on:
            raise RuntimeError(f"[incident] a block {'on' if on else 'off'} "
                               f"with sampler {sampling.get_sampler()}")
        cpu0 = time.process_time()
        rep = run_load(srv.host, srv.port, requests=LOAD_REQUESTS,
                       features=F_FEATURES, seed=SEED, timeout=120.0,
                       **shape)
        cpu_s = time.process_time() - cpu0
    finally:
        srv.stop()
        sampling.uninstall()
    decided = (metrics.counter("telemetry.sampling.kept").value
               + metrics.counter("telemetry.sampling.dropped").value)
    if (rep["rejected"] or rep["errors"] or rep["overload"]
            or rep["ok"] != LOAD_REQUESTS
            or decided != (srv.batcher.batches if on else 0)):
        raise RuntimeError(f"[incident] load 1 ({'on' if on else 'off'}): "
                           f"{rep}, {decided} traces decided")
    return rep, srv.batcher.batches, cpu_s, decided


def _incident_costs(fdir: str) -> dict:
    """(e) The host's cost of the parts, on this process as the load left
    it: one wide event as the server emits it, one engine span with the
    sampler installed against without (the sampler's share of each
    engine call, its decide included), the render the sampler no longer
    makes on that thread, and one incident bundle (bundle alone, and a
    whole forced dump to disk)."""
    from dmlc_core_tpu_torch.telemetry import flight, sampling
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.telemetry import wide_events
    out = {}
    wide_events.wide_log.reset(capacity=2048)
    t0 = time.perf_counter()
    for i in range(COST_CALLS):
        wide_events.wide_event(
            "serving.request", model="default", conn=3, req_id=i, rows=128,
            nnz=4096, dur_ms=2.5, outcome="OK", trace_id=None, debug=None,
            queue_ms=2.1, batch_rows=1024, batch_nnz=32768)
    out["wide_event_us"] = 1e6 * (time.perf_counter() - t0) / COST_CALLS

    def spans(n: int) -> float:
        t0w, t0m = time.time(), time.monotonic()
        t = time.perf_counter()
        for _ in range(n):
            teltrace.record_span("serving.engine.forward", t0w, t0m,
                                 rows=128, bucket_rows=128, bucket_nnz=8192,
                                 ragged=False)
        return 1e6 * (time.perf_counter() - t) / n

    sampling.uninstall()
    out["engine_span_us"] = spans(COST_CALLS)
    with _env(DMLC_TRACE_SAMPLE=str(INCIDENT_FLOOR),
              DMLC_TRACE_KEEP_SLOW_MS=None):
        if sampling.maybe_install_from_env() is None:
            raise RuntimeError("[incident] no sampler installed")
    try:
        out["engine_span_sampled_us"] = spans(COST_CALLS)
    finally:
        sampling.uninstall()
    out["decide_us"] = out["engine_span_sampled_us"] - out["engine_span_us"]
    # the record a span's end would have built on the batcher's thread
    ended = []

    class Keep:
        def on_start(self, trace_id):
            pass

        def on_end(self, trace_id, span):
            ended.append(span)

    teltrace.set_sampler(Keep())
    try:
        for _ in range(COST_CALLS // 10):
            teltrace.start_span("serving.engine.forward", rows=128).end()
    finally:
        teltrace.set_sampler(None)
    t = time.perf_counter()
    for sp in ended:
        sp.record()
    out["render_us"] = 1e6 * (time.perf_counter() - t) / len(ended)
    rec = flight.flight_recorder
    bundle_s, dump_s = [], []
    for _ in range(DUMP_REPS):
        t = time.perf_counter()
        doc = rec.bundle("cost")
        bundle_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        path = rec.dump("cost", directory=fdir, force=True)
        dump_s.append(time.perf_counter() - t)
        if path is None:
            raise RuntimeError("[incident] a forced dump wrote nothing")
    out["bundle_ms"] = 1e3 * float(np.median(bundle_s))
    out["dump_ms"] = 1e3 * float(np.median(dump_s))
    out["bundle_spans"] = doc["span_count"]
    out["bundle_bytes"] = sum(
        os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return out


def phase_incident(torch, power: str) -> dict:
    """[incident]: the incident tooling around the served FM (2^20 x 32,
    padded ladder, every bucket a captured graph, [server]'s checkpoint):
    (a) load 1 through a server that arms the flight recorder and the tail
    sampler from its environment, with a rule that must fire and injected
    sheds: the wide events, the sampler's decisions, one bundle a window,
    /flight, the engine's metrics; (b) traced predicts with injected sheds
    and stalls: the kept traces are exactly the errored, slow and
    hash-floor ones; (c) SIGTERM to serve_main on the card leaves a
    fatal_signal bundle; (d) load 1 in blocks with the sampler off and on
    in turns; (e) the host's cost of a wide event, of the sampler on an
    engine call, and of a bundle.  The process's hooks, handlers, sampler
    and recorder are put back after it.  Returns the kernel launches
    counted over (a), (b) and (d), and its numbers."""
    import signal
    import tempfile

    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.telemetry import flight, sampling, wide_events
    from dmlc_core_tpu_torch.utils import faults
    from dmlc_core_tpu_torch.utils.metrics import metrics
    t_phase = time.monotonic()
    shape = dict(LOADS)["load1"]
    rec = flight.flight_recorder
    saved = (sys.excepthook, threading.excepthook,
             {n: signal.getsignal(n) for n in (signal.SIGTERM,
                                               signal.SIGABRT)},
             {k: getattr(rec, k) for k in ("_dir", "_installed",
                                           "_prev_excepthook",
                                           "_prev_thread_hook",
                                           "_min_interval", "_last_dump")})
    work = tempfile.mkdtemp(prefix=".chip_smoke_incident-", dir=ROOT)
    ckpt = os.path.join(work, "ckpt")
    try:
        p1 = _np_params(SEED + 1)
        CheckpointManager(ckpt).save(1, {"params": p1}, meta={"model": "fm"})
        eng = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                                   device="cuda"),
                              buckets=BucketLadder.default(),
                              postprocess="sigmoid", device="cuda")
        if eng.reload_from_checkpoint(ckpt, step=1) != 1:
            raise RuntimeError("[incident] restored the wrong step")
        # the window the knob (DMLC_FLIGHT_MIN_INTERVAL) sets when the
        # recorder is made, which was at import
        rec._min_interval = INCIDENT_WINDOW
        rec._last_dump = -float("inf")
        wide_events.wide_log.reset(capacity=4 * LOAD_REQUESTS)
        reset_launch_counts()                 # the main path starts here
        fdir_a = os.path.join(work, "flight_load")
        load = _incident_load(eng, shape, fdir_a, power)
        batches = load["batches"]
        rec._last_dump = -float("inf")
        traced = _incident_traced(eng, os.path.join(work, "flight_traced"),
                                  power)
        batches += traced["batches"]
        blocks = []
        # off, on, on, off, ...: a drift over the phase weighs on both alike
        for i in range(2 * INCIDENT_BLOCKS):
            on = i % 4 in (1, 2)
            rep, b, cpu_s, decided = _incident_block(eng, shape, on)
            batches += b
            blocks.append({"state": "on" if on else "off",
                           "qps": rep["qps"],
                           "p50_ms": rep["latency_ms"]["p50"],
                           "p99_ms": rep["latency_ms"]["p99"],
                           "cpu_ms_per_request": 1e3 * cpu_s / rep["ok"],
                           "decided": decided})
            log(f"[incident] (d) load 1 block {i + 1} (sampler "
                f"{blocks[-1]['state']}): {rep['qps']:.1f} qps, p50 "
                f"{rep['latency_ms']['p50']:.3f} p99 "
                f"{rep['latency_ms']['p99']:.3f} ms, the process's CPU "
                f"{blocks[-1]['cpu_ms_per_request']:.3f} ms a request, "
                f"{decided} traces decided [{power}]")
        torch.cuda.synchronize()
        launches = launch_counts()            # the main path ends here
        for name in ("ragged_gather_fm", "ragged_gather_embed"):
            if launches.get(name, 0) != batches + eng.compile_count:
                raise RuntimeError(
                    f"[incident] {name}: {launches.get(name, 0)} launches, "
                    f"expected one a call and one a warm-up ({batches} + "
                    f"{eng.compile_count})")
        sigterm = _incident_sigterm(ckpt, os.path.join(work, "flight_child"),
                                    power)
        costs = _incident_costs(os.path.join(work, "flight_cost"))
    finally:
        sampling.uninstall()
        faults.clear_faults()
        metrics.gauge("slo.active_breaches").set(0)
        sys.excepthook, threading.excepthook = saved[0], saved[1]
        for n, h in saved[2].items():
            signal.signal(n, h)
        for k, v in saved[3].items():
            setattr(rec, k, v)
        wide_events.wide_log.reset()
        shutil.rmtree(work, ignore_errors=True)
    series = {k: {s: [b[k] for b in blocks if b["state"] == s]
                  for s in ("off", "on")}
              for k in ("qps", "p99_ms", "cpu_ms_per_request")}
    out = {"load": load, "traced": traced, "sigterm": sigterm,
           "costs": costs, "blocks": blocks,
           **{f"{k}_on_off": float(np.median(v["on"]) / np.median(v["off"]))
              for k, v in series.items()},
           "pair_qps_on_off": [blocks[i + 1]["qps"] / blocks[i]["qps"]
                               if i % 4 == 0 else
                               blocks[i]["qps"] / blocks[i + 1]["qps"]
                               for i in range(0, len(blocks), 2)]}
    log(f"[incident] (d) load 1, sampler on / off: qps medians "
        f"{np.median(series['qps']['on']):.1f} / "
        f"{np.median(series['qps']['off']):.1f} = {out['qps_on_off']:.4f} "
        f"(pairs " + ", ".join(f"{r:.4f}" for r in out["pair_qps_on_off"])
        + f"), p99 {out['p99_ms_on_off']:.4f}, the process's CPU a request "
        f"{out['cpu_ms_per_request_on_off']:.4f} [{power}]")
    log(f"[incident] (e) on the host: a wide event "
        f"{costs['wide_event_us']:.2f} us; an engine span "
        f"{costs['engine_span_us']:.2f} us, with the sampler "
        f"{costs['engine_span_sampled_us']:.2f} us (its share, the decide "
        f"included: {costs['decide_us']:.2f} us); a span's record, which "
        f"the sampler no longer builds on that thread, "
        f"{costs['render_us']:.2f} us; a bundle {costs['bundle_ms']:.2f} ms "
        f"({costs['bundle_spans']} spans in the ring), a dump "
        f"{costs['dump_ms']:.2f} ms ({costs['bundle_bytes']} bytes) "
        f"[{power}]")
    log(f"[incident] kernel launches: {launches} over {batches} engine "
        f"calls and {eng.compile_count} warm-ups; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "stats": out}


# -- [diagnose]: profiles, the critical path and the ranked verdict ----------

#: the SLI of [diagnose]'s rule: each answer's latency as the load's
#: clients see it (the port's client records none of its own)
DIAG_SLI = "smoke.client.latency_s"
#: the rule and the stall: a stall well past the healthy p99 of a busy
#: process (load 1's clients see 17-76 ms there, a 1 kHz profile on top)
DIAG_SLO = f"{DIAG_SLI}:field=p99:max=150ms:for=2"  # only under the stall
DIAG_FAULT = "serving.server.admit:latency=200ms"   # at every admission
#: a top-3 suspect whose subject holds one of these names the planted
#: cause: the server request span the stall sits in, or the stall's
#: delay counter
DIAG_PLANTED = ("span serving.server.request",
                "faults.serving.server.admit.delays")
DIAG_HEALTHY_S = 3.0       # (b) load 1 healthy this long before the fault
DIAG_WINDOW = 1.5          # DMLC_DIAGNOSE_WINDOW: the incident window, s
DIAG_BASELINE = 60.0       # DMLC_DIAGNOSE_BASELINE: the healthy window, s
DIAG_PROFILE_HZ = "997"    # DMLC_PROFILE_HZ of the /profile scrapes:
                           # the replay's few µs a call must show
DIAG_CHECKED = 16          # answers held against predict and the plain path
DIAG_BLOCKS = 4            # load-1 blocks with the slice's work off, and on
DIAG_HIT_CALLS = 200_000   # watchdog hits timed
DIAG_ROWS, DIAG_NNZ_PER_ROW, DIAG_CLIENTS = 128, 32, 8   # load 1


def _diag_request(rng):
    """One load-1 request, as ``run_load`` makes them."""
    from dmlc_core_tpu_torch.serving.client import _gen_request
    return _gen_request(rng, DIAG_ROWS, DIAG_NNZ_PER_ROW, F_FEATURES)


class _DiagLoad:
    """Load 1 as traced predicts: 8 threads, each a PredictClient sending
    128-row requests one at a time until stopped, so each request is a
    trace of client, server and engine spans; each answer's latency goes
    to the DIAG_SLI histogram."""

    def __init__(self, host: str, port: int):
        from dmlc_core_tpu_torch.utils.metrics import metrics
        self.hist = metrics.histogram(DIAG_SLI)
        self.host, self.port = host, port
        self.answered = 0
        self.failed = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(k,),
                                          daemon=True)
                         for k in range(DIAG_CLIENTS)]
        for t in self._threads:
            t.start()

    def _run(self, k: int) -> None:
        from dmlc_core_tpu_torch import PredictClient
        rng = np.random.default_rng(SEED + 40 + k)
        reqs = [_diag_request(rng) for _ in range(32)]
        try:
            with PredictClient(self.host, self.port) as client:
                i = 0
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    out = client.predict(*reqs[i % len(reqs)], timeout=120)
                    self.hist.observe(time.perf_counter() - t0)
                    if out.shape != (DIAG_ROWS,) or \
                            not np.isfinite(out).all():
                        raise RuntimeError("[diagnose] a bad answer")
                    i += 1
                    with self._lock:
                        self.answered += 1
        except Exception as e:  # noqa: BLE001 — raised by stop()
            self.failed = e

    def stop(self) -> int:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        if self.failed is not None:
            raise RuntimeError(f"[diagnose] the load failed: "
                               f"{self.failed!r}")
        return self.answered


def _diag_families(ladder) -> set:
    """The compile watchdog's families on the JAX server's page for this
    ladder, after warm-up, calls and one ladder miss."""
    return ({"dmlc_xla_compiles_total", "dmlc_xla_compile_seconds",
             "dmlc_xla_cache_hits_total", "dmlc_xla_ladder_misses_total",
             "dmlc_xla_retrace_alert"}
            | {f"dmlc_xla_compile_r{b.rows}x{b.nnz}_total" for b in ladder})


def _diag_watchdog(torch, eng, port: int, checked: list, power: str) -> dict:
    """(a) after warm-up: one capture a bucket, no hit, no alert; the
    DIAG_CHECKED in-process predicts are hits; one request past the ladder
    is a ladder miss and latches the alert; /metrics has the JAX server's
    dmlc_xla_* families; sample_memory's gauges are the allocator's."""
    from dmlc_core_tpu_torch.serving import RequestTooLarge
    from dmlc_core_tpu_torch.telemetry import graph_introspect
    from dmlc_core_tpu_torch.utils.metrics import metrics
    wd = graph_introspect.watchdog

    def c(name: str) -> int:
        # read without making: a counter made here would be on the page
        return metrics.snapshot().get(name, {}).get("value", 0)
    if (c("xla.compiles") != len(eng.ladder)
            or eng.compile_count != len(eng.ladder)
            or c("xla.cache_hits") or wd.alerted
            or metrics.gauge("xla.retrace_alert").value):
        raise RuntimeError(f"[diagnose] (a) after warm-up: compiles "
                           f"{c('xla.compiles')} for {len(eng.ladder)} "
                           f"buckets, hits {c('xla.cache_hits')}, alert "
                           f"{wd.alerted}")
    rng = np.random.default_rng(SEED + 30)
    for _ in range(DIAG_CHECKED):
        req = _diag_request(rng)
        checked.append((req, eng.predict(*req)))
    if c("xla.cache_hits") != DIAG_CHECKED or wd.alerted:
        raise RuntimeError(f"[diagnose] (a) {c('xla.cache_hits')} hits for "
                           f"{DIAG_CHECKED} calls")
    big = _diag_request(rng)
    big = (np.concatenate([big[0], big[0][:5]]),
           np.concatenate([big[1], big[1][:5]]),
           np.concatenate([big[2], big[2][-1:] + np.arange(1, 6)]))
    try:
        eng.predict(*big)
        raise RuntimeError("[diagnose] (a) 133 rows fit a 128-row ladder")
    except RequestTooLarge:
        pass
    if (c("xla.ladder_misses") != 1 or not wd.alerted
            or metrics.gauge("xla.retrace_alert").value != 1
            or c("xla.retrace_alerts") or c("xla.compiles") != len(eng.ladder)):
        raise RuntimeError(f"[diagnose] (a) ladder miss: "
                           f"{c('xla.ladder_misses')}, alert {wd.alerted}")
    page = _scrape(port, "/metrics")[2]
    _parse_exposition(page)
    fams = {ln.split()[2] for ln in page.splitlines()
            if ln.startswith("# TYPE dmlc_xla_")}
    want = _diag_families(eng.ladder)
    if fams != want:
        raise RuntimeError(f"[diagnose] (a) /metrics dmlc_xla_* families "
                           f"{sorted(fams)}, the JAX server's "
                           f"{sorted(want)}")
    if not graph_introspect.sample_memory():
        raise RuntimeError("[diagnose] (a) sample_memory() returned False")
    stats = torch.cuda.memory_stats(0)
    total = torch.cuda.mem_get_info(0)[1]
    got = {k: metrics.gauge(f"xla.mem.0.{k}").value
           for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
    want_mem = {"bytes_in_use": stats["allocated_bytes.all.current"],
                "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
                "bytes_limit": total}
    live = metrics.gauge("xla.live_buffers").value
    if got != want_mem or live != stats["active.all.current"]:
        raise RuntimeError(f"[diagnose] (a) sample_memory {got}, live "
                           f"{live}; the allocator {want_mem}, live "
                           f"{stats['active.all.current']}")
    wall = wd.snapshot()["buckets"]
    log(f"[diagnose] (a) the capture watchdog: {c('xla.compiles')} captures "
        f"for {len(eng.ladder)} buckets ("
        + ", ".join(f"{k} {v['wall_s'] * 1e3:.1f} ms" for k, v in
                    wall.items())
        + f"), {DIAG_CHECKED} hits for {DIAG_CHECKED} in-process calls, no "
        f"alert; a 133-row request: ladder_misses 1, alert latched; "
        f"/metrics has the JAX server's {len(want)} dmlc_xla_* families; "
        f"sample_memory: {got['bytes_in_use']} bytes in use, peak "
        f"{got['peak_bytes_in_use']}, limit {got['bytes_limit']}, "
        f"{live} live blocks, equal to memory_stats / mem_get_info "
        f"[{power}]")
    return {"captures": c("xla.compiles"),
            "capture_ms": {k: v["wall_s"] * 1e3 for k, v in wall.items()},
            "memory": {**got, "live_buffers": live}}


def _diag_healthy(port: int, power: str) -> dict:
    """(b) while load 1 runs healthy: a plain /profile?seconds=1 (the
    baseline) whose stacks hold the batcher's thread in the engine's
    replay and copy-out; /analyze?top=5, whose every path's self times
    sum to its root's duration, with serving.engine.forward among the
    aggregated names."""
    from dmlc_core_tpu_torch.telemetry.profiling import _parse_collapsed
    with _env(DMLC_PROFILE_HZ=DIAG_PROFILE_HZ):
        code, ctype, text, prof_s = _scrape(port, "/profile?seconds=1")
    stacks = _parse_collapsed(text)
    held = {f: sum(n for s, n in stacks.items()
                   if "dmlc_core_tpu_torch.serving.batcher:" in s
                   and f"dmlc_core_tpu_torch.serving.engine:{f}" in s)
            for f in ("_replay", "_copy_out")}
    if code != 200 or not ctype.startswith("text/plain") or \
            not all(held.values()):
        raise RuntimeError(f"[diagnose] (b) /profile: HTTP {code}, the "
                           f"batcher's samples in the engine {held}")
    code, _, body, analyze_s = _scrape(port, "/analyze?top=5")
    doc = json.loads(body)
    if code != 200 or len(doc["top"]) != 5:
        raise RuntimeError(f"[diagnose] (b) /analyze: HTTP {code}, "
                           f"{len(doc.get('top', []))} traces")
    for tr in doc["top"]:
        if sum(s["self_us"] for s in tr["path"]) != tr["dur_us"]:
            raise RuntimeError(f"[diagnose] (b) trace {tr['trace_id']}: "
                               f"self times do not sum to {tr['dur_us']}")
    if "serving.engine.forward" not in doc["self_time_us"]:
        raise RuntimeError(f"[diagnose] (b) /analyze names "
                           f"{list(doc['self_time_us'])}")
    total = sum(doc["self_time_us"].values()) or 1
    shares = {k: v / total for k, v in doc["self_time_us"].items()}
    log(f"[diagnose] (b) healthy load 1: /profile?seconds=1 at "
        f"{DIAG_PROFILE_HZ} Hz in {prof_s * 1e3:.0f} ms, {len(stacks)} "
        f"stacks, the batcher's thread in the engine's replay "
        f"{held['_replay']} and copy-out {held['_copy_out']} samples; "
        f"/analyze?top=5 of {doc['traces_seen']} traces in "
        f"{analyze_s * 1e3:.1f} ms, each path summing to its root, self "
        f"time " + ", ".join(f"{k} {v:.1%}" for k, v in shares.items())
        + f" [{power}]")
    return {"profile_stacks": len(stacks), "engine_samples": held,
            "analyze_shares": shares, "traces_seen": doc["traces_seen"]}


def _diag_planted(port: int, fdir: str, power: str) -> dict:
    """(c) load 1 goes on with DIAG_FAULT installed: the rule breaches,
    the monitor runs the breach's diagnosis, then dumps a bundle with the
    five files; the planted cause is among the merged top 3; a bare
    /diagnose answers about the breach; /profile?diff=1 shows the
    admission's sleeping frames' share grown."""
    from dmlc_core_tpu_torch.utils import faults
    from dmlc_core_tpu_torch.utils.metrics import metrics
    healthy_p99 = metrics.histogram(DIAG_SLI).snapshot().get("p99")
    if metrics.counter("slo.breaches").value or (
            os.path.isdir(fdir) and os.listdir(fdir)):
        raise RuntimeError(f"[diagnose] (c) the rule breached before the "
                           f"stall: the healthy p99 {healthy_p99} s")
    t_fault = time.monotonic()
    faults.install_faults(DIAG_FAULT)
    deadline = t_fault + 60.0
    bundle = None
    while bundle is None:
        for name in (os.listdir(fdir) if os.path.isdir(fdir) else []):
            # diagnosis.txt lands last: the bundle is whole
            if name.endswith("-slo_breach") and os.path.exists(
                    os.path.join(fdir, name, "diagnosis.txt")):
                bundle = name
        if bundle is None:
            if time.monotonic() > deadline:
                raise RuntimeError("[diagnose] (c) no slo_breach bundle "
                                   "within 60 s of the fault")
            time.sleep(0.02)
    breach_s = time.monotonic() - t_fault
    code, _, body, diagnose_s = _scrape(port, "/diagnose")
    bare = json.loads(body)
    with _env(DMLC_PROFILE_HZ=DIAG_PROFILE_HZ):
        dcode, _, diff, _ = _scrape(port, "/profile?seconds=1&diff=1")
    faults.clear_faults()
    path = os.path.join(fdir, bundle)
    files = sorted(os.listdir(path))
    with open(os.path.join(path, "incident.json")) as f:
        inc = json.load(f)
    with open(os.path.join(path, "diagnosis.json")) as f:
        diag = json.load(f)
    want = {"incident.json", "trace.json", "log_tail.txt", "timeline.json",
            "profile.txt", "critical_path.txt", "profile_diff.txt",
            "diagnosis.json", "diagnosis.txt"}
    if set(files) != want or set(inc["files"].values()) != want:
        raise RuntimeError(f"[diagnose] (c) bundle {bundle}: {files}, "
                           f"listed {inc['files']}")
    if diag["trigger"]["kind"] != "breach" or \
            diag["trigger"]["breach"]["metric"] != DIAG_SLI:
        raise RuntimeError(f"[diagnose] (c) trigger {diag['trigger']}")
    top3 = diag["suspects"][:3]
    named = [s for s in top3 if any(p in s["subject"] for p in DIAG_PLANTED)]
    if not named:
        raise RuntimeError(f"[diagnose] (c) the planted cause is not in the "
                           f"top 3: {[(s['analyzer'], s['subject']) for s in top3]}")
    if (code != 200 or bare["trigger"].get("kind") != "breach"
            or bare["trigger"]["breach"]["metric"] != DIAG_SLI):
        raise RuntimeError(f"[diagnose] (c) bare /diagnose: HTTP {code}, "
                           f"trigger {bare.get('trigger')}")
    grown = 0.0
    for ln in diff.splitlines()[1:]:
        m = re.search(r" ([+-]\d+\.\d)% \(baseline", ln)
        if m and "dmlc_core_tpu_torch.utils.faults:fire" in ln:
            grown += float(m.group(1))
    if dcode != 200 or not diff.startswith("# profile diff: baseline @ ") \
            or grown <= 0:
        raise RuntimeError(f"[diagnose] (c) /profile?diff=1: HTTP {dcode}, "
                           f"the admission's sleep grew {grown:+.1f} %")
    log(f"[diagnose] (c) {DIAG_FAULT} installed mid-load (the clients' "
        f"p99 {healthy_p99 * 1e3:.1f} ms until then): {DIAG_SLO} "
        f"breached and bundle {bundle} whole {breach_s:.2f} s later, with "
        f"{', '.join(files)}; diagnosis (trigger breach, "
        f"{diag['wall_ms']:.1f} ms) top 3: "
        + "; ".join(f"#{s['rank']} [{s['analyzer']}] {s['subject']} "
                    f"{s['score']:.3f}" for s in top3)
        + f"; the planted cause named by {named[0]['analyzer']} "
        f"({named[0]['subject']}, #{named[0]['rank']}); a bare /diagnose "
        f"in {diagnose_s * 1e3:.1f} ms answers about the breach; "
        f"/profile?diff=1: the admission's sleep {grown:+.1f} % of the "
        f"samples [{power}]")
    return {"healthy_p99_ms": healthy_p99 * 1e3, "breach_s": breach_s,
            "bundle_files": files,
            "diagnosis_wall_ms": diag["wall_ms"],
            "top3": [(s["analyzer"], s["subject"], s["score"])
                     for s in top3],
            "named_by": named[0]["analyzer"], "named": named[0]["subject"],
            "bare_diagnose_ms": diagnose_s * 1e3,
            "sleep_share_grown_pct": grown}


def _diag_costs(port: int, fdir: str) -> dict:
    """(d) on the host, the ring as the load left it: each section a bundle
    adds on the trigger's thread (the incident profile, the critical path,
    the profile diff, the diagnosis: the breach's cached one and a fresh
    run), a bundle and a dump with them and with the profile and
    diagnosis off; /analyze and /diagnose over the ring; the watchdog's
    hit."""
    from dmlc_core_tpu_torch.telemetry import (critical_path, diagnose,
                                               flight, graph_introspect,
                                               profiling)
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.utils.metrics import MetricsRegistry, metrics
    out = {"ring_spans": len(teltrace.recorder)}

    def ms(fn, reps=3):
        times, val = [], None
        for _ in range(reps):
            t = time.perf_counter()
            val = fn()
            times.append(1e3 * (time.perf_counter() - t))
        return float(np.median(times)), val

    out["profile_ms"], prof = ms(profiling.incident_profile)
    out["critical_path_ms"], _ = ms(critical_path.incident_breakdown)
    out["profile_diff_ms"], _ = ms(
        lambda: profiling.incident_profile_diff(prof))
    out["diagnosis_cached_ms"], _ = ms(diagnose.incident_diagnosis)
    out["diagnosis_fresh_ms"], _ = ms(diagnose.diagnose)
    rec = flight.flight_recorder
    for label, env in (("on", {}), ("off", {"DMLC_FLIGHT_PROFILE_S": "0",
                                            "DMLC_DIAGNOSE": "0"})):
        with _env(**env):
            out[f"bundle_{label}_ms"], doc = ms(lambda: rec.bundle("cost"))
            out[f"dump_{label}_ms"], path = ms(
                lambda: rec.dump("cost", directory=fdir, force=True))
        if path is None:
            raise RuntimeError("[diagnose] a forced dump wrote nothing")
        out[f"dump_{label}_files"] = len(os.listdir(path))
    out["analyze_ms"] = 1e3 * _scrape(port, "/analyze?top=5")[3]
    out["diagnose_ms"] = 1e3 * _scrape(port, "/diagnose?since=60")[3]
    runs = metrics.histogram("telemetry.diagnose.wall_ms").snapshot()
    out["diagnose_runs"] = runs.get("count", 0)
    out["diagnose_wall_ms_p50"] = runs.get("p50")
    wd = graph_introspect.RetraceWatchdog(MetricsRegistry())
    wd.mark_steady("r128x8192")
    wd.note_hit("r128x8192")
    t = time.perf_counter()
    for _ in range(DIAG_HIT_CALLS):
        wd.note_hit("r128x8192")
    out["hit_us"] = 1e6 * (time.perf_counter() - t) / DIAG_HIT_CALLS
    return out


class _NoWatchdog:
    """The capture watchdog stubbed out, for [diagnose]'s off blocks."""

    def note_hit(self, bucket):
        pass

    def note_compile(self, bucket, wall_s):
        return False

    def note_ladder_miss(self, detail=""):
        pass

    def begin_warmup(self):
        pass

    def mark_steady(self, bucket=None):
        pass


def _diag_block(eng, shape: dict, on: bool) -> tuple:
    """One block of load 1 through a server with an exporter: ``on`` with
    the capture watchdog fed and a scraper of /analyze and /diagnose once
    a second, off with the watchdog stubbed out and no scraper.  Returns
    (run_load's report, the batcher's batches, the process's CPU seconds
    over the load, the scrapes)."""
    from dmlc_core_tpu_torch import PredictionServer, run_load
    from dmlc_core_tpu_torch.telemetry import graph_introspect, timeseries
    from dmlc_core_tpu_torch.utils.metrics import metrics
    metrics.reset()
    saved = graph_introspect.watchdog
    graph_introspect.watchdog = (graph_introspect.RetraceWatchdog() if on
                                 else _NoWatchdog())
    try:
        with _env(DMLC_TRACE_SAMPLE=None, DMLC_FLIGHT_DIR=None,
                  DMLC_SLO_SPEC=None, DMLC_FAULT_SPEC=None,
                  DMLC_METRICS_PORT=None):
            srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                                   metrics_port=0).start()
        scraper = None
        try:
            if on:
                scraper = _Scraper(srv.telemetry.port,
                                   ("/analyze?top=5", "/diagnose?since=60"),
                                   1.0)
            cpu0 = time.process_time()
            rep = run_load(srv.host, srv.port, requests=LOAD_REQUESTS,
                           features=F_FEATURES, seed=SEED, timeout=120.0,
                           **shape)
            cpu_s = time.process_time() - cpu0
        finally:
            if scraper is not None:
                scraper.stop()
            srv.stop()
            timeseries.history.stop()
    finally:
        graph_introspect.watchdog = saved
    if rep["rejected"] or rep["errors"] or rep["overload"] or \
            rep["ok"] != LOAD_REQUESTS:
        raise RuntimeError(f"[diagnose] load 1 ({'on' if on else 'off'}): "
                           f"{rep}")
    return (rep, srv.batcher.batches, cpu_s,
            len(scraper.seconds) if scraper else 0)


def phase_diagnose(torch, power: str) -> dict:
    """[diagnose]: the diagnosis around the served FM (2^20 x 32, padded
    ladder, every bucket a captured graph) behind a server with an
    exporter, DMLC_FLIGHT_DIR and DMLC_SLO_SPEC: (a) the capture watchdog
    and the memory gauges; (b) a healthy baseline (a profile, the
    critical path); (c) a planted admission stall: the breach's bundle,
    its ranked verdict, /diagnose and the profile diff; (d) the host's
    costs and load 1 in blocks with the slice's work off and on.  The
    answers of (a) are held against the server's and the plain path's.
    Returns the kernel launches counted over it and its numbers."""
    import signal
    import tempfile

    from dmlc_core_tpu_torch import (BucketLadder, CheckpointManager,
                                     FactorizationMachine, InferenceEngine,
                                     PredictClient, PredictionServer)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.telemetry import (diagnose, flight,
                                               graph_introspect, profiling,
                                               sampling, timeseries,
                                               wide_events)
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.utils import faults
    from dmlc_core_tpu_torch.utils.metrics import MetricsRegistry, metrics
    t_phase = time.monotonic()
    shape = dict(LOADS)["load1"]
    rec = flight.flight_recorder
    saved = (sys.excepthook, threading.excepthook,
             {n: signal.getsignal(n) for n in (signal.SIGTERM,
                                               signal.SIGABRT)},
             {k: getattr(rec, k) for k in ("_dir", "_installed",
                                           "_prev_excepthook",
                                           "_prev_thread_hook",
                                           "_min_interval", "_last_dump")},
             graph_introspect.watchdog)
    work = tempfile.mkdtemp(prefix=".chip_smoke_diagnose-", dir=ROOT)
    ckpt = os.path.join(work, "ckpt")
    fdir = os.path.join(work, "flight")
    checked, answers = [], []
    try:
        CheckpointManager(ckpt).save(1, {"params": _np_params(SEED + 1)},
                                     meta={"model": "fm"})
        eng = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                                   device="cuda"),
                              buckets=BucketLadder.default(),
                              postprocess="sigmoid", device="cuda")
        if eng.reload_from_checkpoint(ckpt, step=1) != 1:
            raise RuntimeError("[diagnose] restored the wrong step")
        metrics.reset()
        sampling.uninstall()
        teltrace.recorder.clear()
        wide_events.wide_log.reset()
        graph_introspect.watchdog = graph_introspect.RetraceWatchdog()
        profiling._baseline = None
        diagnose._last_breach = diagnose._last_doc = None
        # one slo_breach bundle: the window outlasts the phase
        rec._min_interval = 3600.0
        rec._last_dump = -float("inf")
        reset_launch_counts()                 # the main path starts here
        with _env(DMLC_FLIGHT_DIR=fdir, DMLC_SLO_SPEC=DIAG_SLO,
                  DMLC_SLO_INTERVAL=str(SLO_INTERVAL),
                  DMLC_TIMELINE_INTERVAL=str(TIMELINE_INTERVAL),
                  DMLC_DIAGNOSE_WINDOW=str(DIAG_WINDOW),
                  DMLC_DIAGNOSE_BASELINE=str(DIAG_BASELINE),
                  DMLC_TRACE_SAMPLE=None, DMLC_FAULT_SPEC=None,
                  DMLC_METRICS_PORT=None, DMLC_DIAGNOSE=None,
                  DMLC_DIAGNOSE_ON_BREACH=None, DMLC_DIAGNOSE_TOP=None,
                  DMLC_DIAGNOSE_SLOW_MS=None, DMLC_FLIGHT_PROFILE_S=None,
                  DMLC_PROFILE_HZ=None, DMLC_FLIGHT_CRITICAL_TOP=None):
            srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0,
                                   metrics_port=0).start()
            port = srv.telemetry.port
            load = None
            try:
                wd = _diag_watchdog(torch, eng, port, checked, power)
                with PredictClient(srv.host, srv.port) as client:
                    answers = [client.predict(*req, timeout=120)
                               for req, _ in checked]
                load = _DiagLoad(srv.host, srv.port)
                t_load = time.monotonic()
                time.sleep(1.0)
                healthy = _diag_healthy(port, power)
                time.sleep(max(0.0, DIAG_HEALTHY_S
                               - (time.monotonic() - t_load)))
                planted = _diag_planted(port, fdir, power)
                answered = load.stop()
                load = None
                hits = metrics.counter("xla.cache_hits").value
                batches = srv.batcher.batches
                costs = _diag_costs(port, os.path.join(work, "cost"))
            finally:
                if load is not None:
                    load._stop.set()
                faults.clear_faults()
                srv.stop()
                timeseries.history.stop()
        # every call after the warm-up replayed a graph that was there
        if hits != batches + DIAG_CHECKED:
            raise RuntimeError(f"[diagnose] xla.cache_hits {hits}, engine "
                               f"calls {batches} + {DIAG_CHECKED}")
        calls = batches + DIAG_CHECKED
        blocks = []
        # off, on, on, off, ...: a drift over the phase weighs on both alike
        for i in range(2 * DIAG_BLOCKS):
            on = i % 4 in (1, 2)
            rep, b, cpu_s, scrapes = _diag_block(eng, shape, on)
            calls += b
            blocks.append({"state": "on" if on else "off",
                           "qps": rep["qps"],
                           "p50_ms": rep["latency_ms"]["p50"],
                           "p99_ms": rep["latency_ms"]["p99"],
                           "cpu_ms_per_request": 1e3 * cpu_s / rep["ok"],
                           "scrapes": scrapes})
            log(f"[diagnose] (d) load 1 block {i + 1} (watchdog and "
                f"/analyze + /diagnose scrapes {blocks[-1]['state']}): "
                f"{rep['qps']:.1f} qps, p50 {rep['latency_ms']['p50']:.3f} "
                f"p99 {rep['latency_ms']['p99']:.3f} ms, the process's CPU "
                f"{blocks[-1]['cpu_ms_per_request']:.3f} ms a request, "
                f"{scrapes} scrapes [{power}]")
        torch.cuda.synchronize()
        launches = launch_counts()            # the main path ends here
        for name in ("ragged_gather_fm", "ragged_gather_embed"):
            if launches.get(name, 0) != calls + eng.compile_count:
                raise RuntimeError(
                    f"[diagnose] {name}: {launches.get(name, 0)} launches, "
                    f"expected one a call and one a warm-up ({calls} + "
                    f"{eng.compile_count})")
        # the answers against the plain path on the card (its engine's
        # captures reported to a watchdog of their own)
        graph_introspect.watchdog = graph_introspect.RetraceWatchdog(
            MetricsRegistry())
        ref = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                                   engine="torch",
                                                   device="cuda"),
                              buckets=BucketLadder.default(),
                              postprocess="sigmoid", device="cuda")
        ref.reload_from_checkpoint(ckpt, step=1)
        worst = 0.0
        for (req, inproc), got in zip(checked, answers):
            want = ref.predict(*req)
            for label, a in (("over TCP", got), ("in process", inproc)):
                if a.shape != want.shape or not np.allclose(
                        a, want, rtol=RTOL, atol=ATOL):
                    raise RuntimeError(f"[diagnose] an answer {label} "
                                       f"departs from the plain path")
                worst = max(worst, float(np.abs(a - want).max()))
            if not np.array_equal(got, inproc):
                raise RuntimeError("[diagnose] the server's answer departs "
                                   "from in-process predict")
    finally:
        sampling.uninstall()
        faults.clear_faults()
        metrics.gauge("slo.active_breaches").set(0)
        sys.excepthook, threading.excepthook = saved[0], saved[1]
        for n, h in saved[2].items():
            signal.signal(n, h)
        for k, v in saved[3].items():
            setattr(rec, k, v)
        graph_introspect.watchdog = saved[4]
        profiling._baseline = None
        diagnose._last_breach = diagnose._last_doc = None
        wide_events.wide_log.reset()
        shutil.rmtree(work, ignore_errors=True)
    series = {k: {s: [b[k] for b in blocks if b["state"] == s]
                  for s in ("off", "on")}
              for k in ("qps", "p99_ms", "cpu_ms_per_request")}
    out = {"watchdog": wd, "healthy": healthy, "planted": planted,
           "costs": costs, "blocks": blocks, "answered": answered,
           "max_abs_err": worst,
           **{f"{k}_on_off": float(np.median(v["on"]) / np.median(v["off"]))
              for k, v in series.items()},
           "pair_qps_on_off": [blocks[i + 1]["qps"] / blocks[i]["qps"]
                               if i % 4 == 0 else
                               blocks[i]["qps"] / blocks[i + 1]["qps"]
                               for i in range(0, len(blocks), 2)]}
    log(f"[diagnose] {DIAG_CHECKED} answers over TCP and in process, max "
        f"|err| against the plain path {worst:.3g} (limit rtol=atol={RTOL}); "
        f"{answered} traced predicts of load 1 over (b) and (c) [{power}]")
    log(f"[diagnose] (d) on the host: the incident profile "
        f"{costs['profile_ms']:.1f} ms, the critical path "
        f"{costs['critical_path_ms']:.1f} ms over {costs['ring_spans']} "
        f"spans, the profile diff {costs['profile_diff_ms']:.2f} ms, the "
        f"diagnosis {costs['diagnosis_cached_ms']:.3f} ms cached / "
        f"{costs['diagnosis_fresh_ms']:.1f} ms fresh (the monitor's runs: "
        f"{costs['diagnose_runs']}, p50 {costs['diagnose_wall_ms_p50']} ms)"
        f"; a bundle {costs['bundle_on_ms']:.1f} ms, "
        f"{costs['bundle_off_ms']:.1f} with the profile and diagnosis off; "
        f"a dump {costs['dump_on_ms']:.1f} ms ({costs['dump_on_files']} "
        f"files), {costs['dump_off_ms']:.1f} off ({costs['dump_off_files']})"
        f"; /analyze {costs['analyze_ms']:.1f} ms, /diagnose "
        f"{costs['diagnose_ms']:.1f} ms over the ring; a watchdog hit "
        f"{costs['hit_us']:.3f} us [{power}]")
    log(f"[diagnose] (d) load 1, on / off: qps medians "
        f"{np.median(series['qps']['on']):.1f} / "
        f"{np.median(series['qps']['off']):.1f} = {out['qps_on_off']:.4f} "
        f"(pairs " + ", ".join(f"{r:.4f}" for r in out["pair_qps_on_off"])
        + f"), p99 {out['p99_ms_on_off']:.4f}, the process's CPU a request "
        f"{out['cpu_ms_per_request_on_off']:.4f} [{power}]")
    log(f"[diagnose] kernel launches: {launches} over {calls} engine calls "
        f"and {eng.compile_count} warm-ups; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "stats": out}


# -- phase 4d: spans and traces ----------------------------------------------

TRACE_REQUESTS = 64        # served requests of [trace] (a)
TRACE_STEPS = 4            # profiled training steps of [trace] (b)
SPAN_CALLS = 100_000       # empty spans timed in [trace] (d)
SERVING_SPANS = ("serving.client.predict", "serving.server.request",
                 "serving.engine.forward")
# the sources whose kernels the profiled FM step must name, by the
# __global__ symbols each defines (optim.cu: Adam's)
TRACED_SOURCES = {"ragged_gather": "ragged_gather.cu",
                  "ragged_gather_grad": "ragged_gather_grad.cu",
                  "wire_decode": "wire_decode.cu", "adam": "optim.cu"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def _global_symbols(source: str) -> list:
    """The ``__global__`` functions a .cu file of the checkout defines."""
    with open(os.path.join(ROOT, "dmlc_core_tpu_torch", "kernels",
                           source)) as f:
        text = f.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s*)?(\w+)\s*\(", text)


def _serving_chains(recs: list, n: int) -> dict:
    """Each client span's trace holds exactly one server child and one
    engine grandchild, and the server span ended OK; returns each name's
    count and p50 / p99 duration (µs)."""
    by = {name: [r for r in recs if r.get("name") == name]
          for name in SERVING_SPANS}
    client, server, engine = (by[k] for k in SERVING_SPANS)
    if not len(client) == len(server) == len(engine) == n:
        raise RuntimeError("[trace] spans: " + ", ".join(
            f"{k} {len(v)}" for k, v in by.items()) + f", expected {n} each")
    for c in client:
        kids = [s for s in server if s["parent_id"] == c["span_id"]]
        if len(kids) != 1 or kids[0]["trace_id"] != c["trace_id"]:
            raise RuntimeError(f"[trace] client span {c['span_id']}: "
                               f"{len(kids)} server children in its trace")
        if kids[0]["attrs"].get("status") != "OK":
            raise RuntimeError(f"[trace] server span ended "
                               f"{kids[0]['attrs'].get('status')}")
        grand = [e for e in engine if e["parent_id"] == kids[0]["span_id"]]
        if len(grand) != 1 or grand[0]["trace_id"] != c["trace_id"]:
            raise RuntimeError(f"[trace] server span {kids[0]['span_id']}: "
                               f"{len(grand)} engine children in its trace")
    return {k: {"count": len(v),
                "p50_us": float(np.percentile([r["dur_us"] for r in v], 50)),
                "p99_us": float(np.percentile([r["dur_us"] for r in v], 99))}
            for k, v in by.items()}


def _merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _profile_split(events: list, step_name: str) -> dict:
    """The profiled steps' device time: the window from the first step's
    host range to the end of the last step's device work, the device's
    busy share of it, its five largest ops (µs summed by name) and its
    five longest idle gaps, each with the innermost host range open at
    its middle on the steps' thread and the named ranges open on the
    loader's threads."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    # the host's ranges (the card's copies of them are gpu_user_annotation)
    steps = [e for e in xs if e.get("name") == step_name
             and e.get("cat") == "user_annotation"]
    step_tid = steps[0].get("tid")
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    t0 = min(e["ts"] for e in steps)
    host_end = max(e["ts"] + e["dur"] for e in steps)
    t1 = max([host_end] + [e["ts"] + e["dur"] for e in dev
                           if t0 <= e["ts"] <= host_end])
    inside = [e for e in dev if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy = _merged([[max(e["ts"], t0), min(e["ts"] + e["dur"], t1)]
                    for e in inside])
    busy_us = sum(b - a for a, b in busy)
    ops: dict = {}
    for e in inside:
        o = ops.setdefault(e["name"], [0.0, 0])
        o[0] += e["dur"]
        o[1] += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:5]
    out_gaps = []
    for dur, start in gaps:
        mid = start + dur / 2
        open_ = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        mine = [e for e in open_ if e.get("tid") == step_tid]
        inner = max(mine, key=lambda e: e["ts"], default=None)
        out_gaps.append({
            "us": dur, "at_us": start - t0,
            "host": inner["name"] if inner else None,
            "others": sorted({e["name"] for e in open_
                              if e.get("tid") != step_tid
                              and e.get("cat") == "user_annotation"})})
    return {"window_us": t1 - t0, "busy_us": busy_us,
            "busy_share": busy_us / max(t1 - t0, 1e-9),
            "top_ops": [{"name": k, "us": v[0], "count": v[1]}
                        for k, v in top],
            "idle_gaps": out_gaps}


def _trace_serving(torch, power: str) -> dict:
    """[trace] (a): TRACE_REQUESTS predicts from one PredictClient to an
    in-process PredictionServer on FM's padded ladder, each a trace of
    client, server and engine spans."""
    from dmlc_core_tpu_torch import (BucketLadder, FactorizationMachine,
                                     InferenceEngine, PredictClient,
                                     PredictionServer)
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    p = _np_params(SEED + 1)
    eng = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                               device="cuda"),
                          p, buckets=BucketLadder.default(),
                          postprocess="sigmoid", device="cuda")
    rng = np.random.default_rng(SEED + 30)
    reqs = _requests(rng, TRACE_REQUESTS)
    srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0)
    first = len(teltrace.recorder)
    srv.start()
    try:
        with PredictClient(srv.host, srv.port) as client:
            answers = [client.predict(*r, timeout=120) for r in reqs]
    finally:
        srv.stop()
    for j in (0, len(reqs) // 2, len(reqs) - 1):
        want = _fm_f64(p, *reqs[j])
        if (answers[j].shape != want.shape
                or not np.allclose(answers[j], want, atol=ATOL_F64, rtol=0)):
            raise RuntimeError(f"[trace] request {j}: max |err| against a "
                               f"float64 FM "
                               f"{np.abs(answers[j] - want).max():.3g}")
    recs = teltrace.recorder.snapshot()[first:]
    stats = _serving_chains(recs, len(reqs))
    log(f"[trace] (a) {len(reqs)} predicts, each one trace of "
        "client -> server -> engine, server status OK: " + "; ".join(
            f"{k} {v['count']} spans, p50 {v['p50_us']:.1f} us, p99 "
            f"{v['p99_us']:.1f} us" for k, v in stats.items())
        + f" [{power}]")
    return stats


def _trace_step(torch, power: str, train_file: str, out_dir: str) -> dict:
    """[trace] (b): profile_trace over TRACE_STEPS flat FM steps (Adam,
    the native packer's v3 wire) from DeviceLoader, after one step
    outside it; the Chrome trace must name the path's kernels by their
    __global__ symbols and the loader's pack and h2d ranges."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     make_train_step)
    from dmlc_core_tpu_torch.utils.metrics import profile_trace, trace_span
    model = _model(torch, "fm", "kernel")
    step = make_train_step(model, adam(model, LR))
    loader = DeviceLoader(create_parser(train_file, engine="native"),
                          ROWS_TR, CAP_TR, layout="flat", device="cuda",
                          engine="native")
    try:
        if not loader.wire_compact:
            raise RuntimeError("[trace] the card's loader is not on v3")
        float(step(loader.next_batch()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile_trace(out_dir) as prof:
            for _ in range(TRACE_STEPS):
                with trace_span("chip_smoke.step"):
                    with trace_span("chip_smoke.next_batch"):
                        batch = loader.next_batch()
                    loss = step(batch)
            with trace_span("chip_smoke.sync"):
                float(loss)
        took = time.perf_counter() - t0
    finally:
        loader.close()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    named = {}
    for key, src in TRACED_SOURCES.items():
        syms = _global_symbols(src)
        if key == "adam":
            syms = [s for s in syms if s.startswith("adam")]
        named[key] = sorted(s for s in syms
                            if any(re.search(rf"\b{s}\b", k)
                                   for k in kernels))
        if not named[key]:
            raise RuntimeError(f"[trace] the profiled step names no kernel "
                               f"of {src} ({syms}); its kernels: "
                               f"{sorted(kernels)[:20]}")
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    for want in ("device_loader.pack", "device_loader.h2d"):
        if want not in ranges:
            raise RuntimeError(f"[trace] the profiled step has no {want} "
                               f"range: {sorted(ranges)}")
    split = _profile_split(events, "chip_smoke.step")
    log(f"[trace] (b) profile_trace of {TRACE_STEPS} flat FM steps (v3, "
        f"Adam) in {took:.2f} s: {len(events)} events, "
        f"{os.path.getsize(prof.trace_path)} bytes; kernels named "
        + ", ".join(f"{k}: {v}" for k, v in named.items())
        + f"; window {split['window_us'] / 1e3:.3f} ms, device busy "
        f"{split['busy_us'] / 1e3:.3f} ms ({100 * split['busy_share']:.1f} "
        f"%, idle {100 * (1 - split['busy_share']):.1f} %) [{power}]")
    for op in split["top_ops"]:
        log(f"[trace] (b) top device op: {op['us']:.1f} us over "
            f"{op['count']} calls, {op['name'][:100]}")
    for g in split["idle_gaps"]:
        log(f"[trace] (b) idle gap {g['us']:.1f} us at +{g['at_us']:.1f} us:"
            f" the steps' thread in {g['host']}; the loader's threads in "
            f"{g['others'] or 'nothing named'}")
    return split


def phase_trace(torch, power: str, train_file: str) -> dict:
    """Spans and traces on the card: (a) served requests traced from
    client through server and batcher to the captured graph; (b) a
    torch.profiler capture of the training step; (c) the recorded spans
    written as a Chrome trace and read back; (d) the host cost of an
    empty span and of a trace_span range.  Returns the kernel launches
    counted over (a) and (b)."""
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.telemetry import trace as teltrace
    from dmlc_core_tpu_torch.telemetry import write_chrome_trace
    from dmlc_core_tpu_torch.utils.metrics import trace_span
    t_phase = time.monotonic()
    out_dir = os.environ.get("CHIP_SMOKE_TRACE_DIR") or os.path.join(
        os.path.dirname(train_file), "trace")
    os.makedirs(out_dir, exist_ok=True)
    teltrace.recorder.clear()
    reset_launch_counts()                     # the main path starts here
    serving = _trace_serving(torch, power)
    split = _trace_step(torch, power, train_file, out_dir)
    torch.cuda.synchronize()
    launches = launch_counts()                # the main path ends here
    # (c) the recorded spans, written and read back
    path = write_chrome_trace(os.path.join(out_dir, "spans.json"))
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    for want in SERVING_SPANS + ("device_loader.h2d",):
        if want not in names:
            raise RuntimeError(f"[trace] the spans' Chrome trace has no "
                               f"{want}: {sorted(names)}")
    log(f"[trace] (c) {len(teltrace.recorder)} recorded spans written as a "
        f"Chrome trace ({len(doc['traceEvents'])} events, "
        f"{os.path.getsize(path)} bytes), read back with "
        f"{sorted(n for n in names if '.' in n)}")
    # (d) the host cost of an empty span and of a profiler range
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS):
        with teltrace.span("chip_smoke.empty"):
            pass
    span_us = (time.perf_counter() - t0) / SPAN_CALLS * 1e6
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS // 10):
        with trace_span("chip_smoke.empty"):
            pass
    range_us = (time.perf_counter() - t0) / (SPAN_CALLS // 10) * 1e6
    teltrace.recorder.clear()
    log(f"[trace] (d) host cost: an empty span {span_us:.2f} us "
        f"({SPAN_CALLS} calls), a trace_span range {range_us:.2f} us "
        f"({SPAN_CALLS // 10} calls) [{power}]")
    missing = [k for k in ("ragged_gather_fm", "ragged_gather_embed",
                           "ragged_gather_grad_fm",
                           "ragged_gather_grad_embed", "wire_decode", "adam")
               if launches.get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"[trace] never launched: {missing}")
    log(f"[trace] kernel launches over (a) and (b): {launches}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "serving": serving, "step": split,
            "span_us": span_us, "trace_span_us": range_us}


# -- phase 4b: the host feed -------------------------------------------------

def _median_ms(fn, items, reps: int) -> float:
    """Median host-clock ms of ``fn(item)`` over ``reps`` passes."""
    ts = []
    for _ in range(reps):
        for it in items:
            t = time.perf_counter()
            fn(it)
            ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def _loader_ms(torch, make, epochs: int) -> float:
    """Median ms a loader takes to hand over a batch when nothing
    consumes it (``epochs`` passes, ``before_first`` between them): what
    the feed can deliver on its own."""
    waits = []
    ld = make()
    try:
        for epoch in range(epochs):
            if epoch:
                ld.before_first()
            while True:
                t = time.perf_counter()
                if ld.next_batch() is None:
                    break
                waits.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
    finally:
        ld.close()
    return float(np.median(waits))


def phase_feed(torch, power: str, train_file: str) -> None:
    """[feed]: the host feed's stages apart, over the training file cut
    into its 8 batches of text (ms per 4096-row batch, host clock,
    median over FEED_EPOCHS passes; the python parser over one): python
    parse, native parse (its OpenMP team and one thread), streampack
    parse-and-pack, python pack (flat into the fused wire; row-major) and
    native pack; then the H2D copy of each fused batch from pinned memory
    and its device decode in CUDA events; then each loader on its own.
    The card's decode of every batch of one epoch must be array_equal to
    the CPU's decode of the same buffer."""
    from dmlc_core_tpu_torch import native
    from dmlc_core_tpu_torch.data import RowBlock, create_parser, parse_libsvm
    from dmlc_core_tpu_torch.data.parser import _default_nthreads
    from dmlc_core_tpu_torch.pipeline import (DeviceLoader, make_decoder,
                                              pack_flat, pack_rowmajor)
    from dmlc_core_tpu_torch.pipeline.loader import (_decode_on_host,
                                                     _fused_words_meta,
                                                     _host_fused)
    t0 = time.monotonic()
    if not native.available():
        raise RuntimeError("the native library is unavailable")
    nt = _default_nthreads()
    log(f"[feed] native library ready in {time.monotonic() - t0:.2f} s; "
        f"parse threads {nt} (OpenMP default {native.num_threads()}), "
        f"torch intra-op threads {torch.get_num_threads()}, cores "
        f"{os.cpu_count()}")
    with open(train_file, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    texts = [b"".join(lines[i:i + ROWS_TR])
             for i in range(0, len(lines), ROWS_TR)]
    blocks = []
    for t in texts:
        d = native.parse_libsvm(t, nt)
        blocks.append(RowBlock(d["offsets"], d["labels"], d["indices"],
                               d["values"], d["weights"]))

    def streampack(text):
        sp = native.SpPacker(ROWS_TR, CAP_TR)
        list(sp.feed_text(text))
        sp.flush()
        sp.close()

    def native_pack(blk):
        pk = native.Packer(ROWS_TR, CAP_TR)
        list(pk.feed(blk))
        pk.flush()
        pk.close()

    def python_flat(blk):
        _host_fused(pack_flat(blk, ROWS_TR, CAP_TR, want_segments=False),
                    ROWS_TR, CAP_TR)

    st = {"python parse": _median_ms(parse_libsvm, texts, 1),
          f"native parse ({nt} threads)": _median_ms(
              lambda t: native.parse_libsvm(t, nt), texts, FEED_EPOCHS),
          "native parse (1 thread)": _median_ms(
              lambda t: native.parse_libsvm(t, 1), texts, FEED_EPOCHS),
          "streampack parse+pack": _median_ms(streampack, texts,
                                              FEED_EPOCHS),
          "python pack flat (fused wire)": _median_ms(python_flat, blocks,
                                                      FEED_EPOCHS),
          "python pack row-major": _median_ms(
              lambda b: pack_rowmajor(b, ROWS_TR, K_TR), blocks,
              FEED_EPOCHS),
          "native pack": _median_ms(native_pack, blocks, FEED_EPOCHS)}
    log("[feed] host stages, ms per 4096-row batch (median): " + ", ".join(
        f"{k} {v:.4f}" for k, v in st.items()) + f" [{power}]")

    # the fused buffers of one epoch, as the native loader emits them;
    # the card's decode of each against the CPU's
    ld = DeviceLoader(create_parser(train_file, engine="native"), ROWS_TR,
                      CAP_TR, device="cuda", engine="native", emit="host")
    items = []
    try:
        for _, buf, meta, _ in ld:
            items.append((buf.copy(), int(meta)))
            ld.recycle(buf)
    finally:
        ld.close()
    h2d, dec, nbytes = [], [], []
    for buf, meta in items:
        words = _fused_words_meta(ROWS_TR, meta)
        host = torch.empty(words, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = buf[:words]
        dev = torch.empty(words, dtype=torch.int32, device="cuda")
        decode = make_decoder(ROWS_TR, meta)
        for _ in range(FEED_EPOCHS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda._sleep(1_000_000)
            ev[0].record()
            dev.copy_(host, non_blocking=True)
            ev[1].record()
            got = decode(dev)
            ev[2].record()
            torch.cuda.synchronize()
            h2d.append(ev[0].elapsed_time(ev[1]))
            dec.append(ev[1].elapsed_time(ev[2]))
        nbytes.append(words * 4)
        want = _decode_on_host(buf, ROWS_TR, meta)
        for k, w in want.items():
            if not torch.equal(got[k].cpu(), w):
                raise RuntimeError(f"[feed] the card's decode of {k} differs "
                                   f"from the CPU's")
    log(f"[feed] {len(items)} fused batches (nnz buckets "
        f"{sorted({m for _, m in items})}): H2D from pinned memory "
        f"{np.median(h2d):.4f} ms ({np.median(nbytes) / 1e6:.3f} MB, "
        f"{np.median(nbytes) / np.median(h2d) / 1e6:.2f} GB/s), device "
        f"decode {np.median(dec):.4f} ms (CUDA events, median); the card's "
        f"decode of every batch array_equal to the CPU's [{power}]")

    def loader(layout, cap, engine, **parser):
        return lambda: DeviceLoader(
            create_parser(train_file, engine="native", **parser), ROWS_TR,
            cap, layout=layout, device="cuda", engine=engine)
    alone = {"native flat": loader("flat", CAP_TR, "native"),
             "streampack flat": loader("flat", CAP_TR, "native",
                                       threaded=False, nthreads=1),
             "python flat": loader("flat", CAP_TR, "python"),
             "row-major (python pack)": loader("rowmajor", K_TR, "native")}
    log("[feed] each loader alone, ms per batch handed over (median, "
        f"{FEED_EPOCHS} epochs): " + ", ".join(
            f"{k} {_loader_ms(torch, make, FEED_EPOCHS):.4f}"
            for k, make in alone.items()) + f" [{power}]")


# -- phase 4b: the I/O layer --------------------------------------------------

IO_PARTS = 4               # files the training file is cut into
IO_EPOCHS = 4              # passes of the page-cache run
KSTEP_IO = 4               # FusedTrainer(k) of the save_async check
SAVE_AT = 4                # the step save_async is called at


def _io_dir(data: str, train_file: str) -> str:
    """The training file cut into IO_PARTS files in its order, plus an
    empty one, under ``data/io``: ``expand_uris`` order is the file's."""
    d = os.path.join(data, "io")
    os.makedirs(d, exist_ok=True)
    with open(train_file, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    cut = [len(lines) * i // IO_PARTS for i in range(IO_PARTS + 1)]
    for i in range(IO_PARTS):
        with open(os.path.join(d, f"part-{i}.libsvm"), "wb") as f:
            f.write(b"".join(lines[cut[i]:cut[i + 1]]))
    open(os.path.join(d, "part-9.libsvm"), "wb").close()       # empty
    return d


def _same_batches(torch, name: str, got: list, want: list,
                  phase: str = "[io]") -> None:
    if len(got) != len(want) or not want:
        raise RuntimeError(f"{phase} {name}: {len(got)} batches, expected "
                           f"{len(want)}")
    for i, (x, y) in enumerate(zip(got, want)):
        for k in y:
            if not torch.equal(x[k], y[k]):
                raise RuntimeError(f"{phase} {name}: batch {i} {k} differs")


def _timed_epoch(torch, loader) -> tuple:
    """One epoch of device batches, its host-clock seconds (to the last
    batch on the card) and the consumer's waits in ``next_batch`` (ms)."""
    batches, waits = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        b = loader.next_batch()
        waits.append((time.perf_counter() - a) * 1e3)
        if b is None:
            break
        batches.append(b)
    torch.cuda.synchronize()
    return batches, time.perf_counter() - t0, waits[:-1]


def _io_forms(torch, power: str, d: str, train_file: str) -> None:
    """The card's batches from a directory, a ; list and a glob against
    the single file's, on the native and streampack paths."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    parts = sorted(os.path.join(d, f) for f in os.listdir(d))
    forms = {"directory": d, "; list": ";".join(parts),
             "glob": os.path.join(d, "part-*.libsvm")}
    for path, kw in (("native", {}),
                     ("streampack", {"threaded": False, "nthreads": 1})):
        def epoch(uri):
            with DeviceLoader(create_parser(uri, engine="native", **kw),
                              ROWS_TR, CAP_TR, device="cuda",
                              engine="native", cache=None) as ld:
                return list(ld)
        want = epoch(train_file)
        for form, uri in forms.items():
            _same_batches(torch, f"{path} {form}", epoch(uri), want)
    log(f"[io] the training file cut into {IO_PARTS} files and an empty "
        f"one: the card's batches from the directory, the ; list and the "
        f"glob array_equal to the single file's, on the native and "
        f"streampack paths ({len(want)} batches each) [{power}]")


def _io_page_cache(torch, power: str, d: str, data: str) -> str:
    """DeviceLoader(cache="auto") over ``dir#cache`` for IO_EPOCHS
    epochs: epoch 1 parses, packs and writes through, the others replay
    the page file; each must be array_equal on the card to epoch 1.
    Then a touched source file and a truncated page file must each
    rebuild, never serve.  Returns the URI."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    uri = f"{d}#{os.path.join(data, 'io_cache')}"
    pages = os.path.join(data, "io_cache.pages")

    def loader():
        return DeviceLoader(create_parser(uri, engine="native"), ROWS_TR,
                            CAP_TR, device="cuda", engine="native",
                            cache_queue_pages=64)

    ld = loader()
    epochs, rows, read = [], [], 0
    try:
        for e in range(IO_EPOCHS):
            if e:
                ld.before_first()
            batches, secs, waits = _timed_epoch(torch, ld)
            epochs.append(batches)
            # the epoch's pages are all read once its end is handed over,
            # and the next epoch starts only at before_first
            read, delta = (ld.cache_stats["bytes_read"],
                           ld.cache_stats["bytes_read"] - read)
            rows.append(f"epoch {e + 1} "
                        f"{'replay' if e else 'parse+pack+write'} "
                        f"{secs * 1e3 / len(batches):.4f} ms a batch, wait "
                        f"in next_batch median {np.median(waits):.4f} / max "
                        f"{np.max(waits):.4f} ms, page-file bytes read "
                        f"{delta}")
        stats = dict(ld.cache_stats)
    finally:
        ld.close()
    for e in range(1, IO_EPOCHS):
        _same_batches(torch, f"page-cache epoch {e + 1}", epochs[e],
                      epochs[0])
    if (stats["hits"] != IO_EPOCHS - 1 or stats["misses"] != 1
            or stats["bytes_read"]
            != (IO_EPOCHS - 1) * stats["bytes_written"]):
        raise RuntimeError(f"[io] page cache: {stats}; expected "
                           f"{IO_EPOCHS - 1} hits, 1 miss and every page "
                           f"read once an epoch")
    log(f"[io] page cache over {len(epochs[0])} batches of {ROWS_TR} rows "
        f"(page file {os.path.getsize(pages)} bytes; page payload written "
        f"{stats['bytes_written']}, read {stats['bytes_read']} in epochs "
        f"2-{IO_EPOCHS}): " + "; ".join(rows)
        + f"; epochs 2-{IO_EPOCHS} array_equal on the card to epoch 1 "
          f"[{power}]")

    # a touched source file, then a truncated page file: both rebuild
    stamp = os.stat(pages).st_mtime_ns
    src = os.path.join(d, "part-1.libsvm")
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    with loader() as ld:
        _same_batches(torch, "after a touch", list(ld), epochs[0])
        touched = dict(ld.cache_stats)
    with open(pages, "r+b") as f:
        f.truncate(os.path.getsize(pages) // 2)
    with loader() as ld:
        served_truncated = ld.cached_page_file()
        _same_batches(torch, "after a truncation", list(ld), epochs[0])
        truncated = dict(ld.cache_stats)
    if (touched["hits"] or touched["misses"] != 1
            or os.stat(pages).st_mtime_ns == stamp
            or served_truncated is not None or truncated["hits"]
            or truncated["misses"] != 1):
        raise RuntimeError(f"[io] a stale page file was served: touched "
                           f"{touched}, truncated {truncated}")
    log(f"[io] a touched source file rebuilt the page file (hits "
        f"{touched['hits']}, misses {touched['misses']}); a truncated one "
        f"failed validation and was rebuilt, never served (hits "
        f"{truncated['hits']}, misses {truncated['misses']}); both epochs "
        f"array_equal to epoch 1 [{power}]")
    return uri


def _io_steady(torch, power: str, d: str, uri: str) -> None:
    """Flat FM and DeepFM steady state over STEADY_EPOCHS, fed from the
    directory uncached and from the page file, in turns (uncached,
    cached, cached, uncached) on one model after a warm-up epoch."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     make_train_step)

    def loader(cached):
        return DeviceLoader(create_parser(uri if cached else d,
                                          engine="native"), ROWS_TR, CAP_TR,
                            device="cuda", engine="native",
                            cache="auto" if cached else None)

    for kind in ("fm", "deepfm"):
        model = _model(torch, kind, "kernel")
        step = make_train_step(model, adam(model, LR))
        with loader(False) as ld:                       # warm-up epoch
            for batch in ld:
                step(batch)
        torch.cuda.synchronize()
        out = {False: [], True: []}
        for cached in (False, True, True, False):
            with loader(cached) as ld:
                r = _steady_state(torch, step, ld, STEADY_EPOCHS)
                stats = dict(ld.cache_stats)
            # (the epoch the loader starts at construction is rewound by
            # _steady_state: one hit more than epochs)
            if cached and (stats["misses"] or stats["hits"] < STEADY_EPOCHS):
                raise RuntimeError(f"[io] {kind}: epochs not all from the "
                                   f"page file: {stats}")
            out[cached].append(r)
        log(f"[io] {kind} flat steady state, {STEADY_EPOCHS} epochs of the "
            f"directory, in turns: " + "; ".join(
                f"{'page file' if c else 'parse+pack'} " + ", ".join(
                    f"{r['steps'] / r['wall_s']:.2f}" for r in out[c])
                + " steps/s, wait in next_batch mean " + ", ".join(
                    f"{r['wait_mean_ms']:.4f}" for r in out[c])
                + " ms, enqueue median " + ", ".join(
                    f"{r['enqueue_median_ms']:.4f}" for r in out[c])
                + " ms" for c in (False, True)) + f" [{power}]")
        del model, step
        torch.cuda.empty_cache()


def _ckpt_state(model, opt) -> dict:
    from dmlc_core_tpu_torch.models import adam_state_to_optax
    from dmlc_core_tpu_torch.models.convert import params_tree
    return {"params": params_tree(model),
            "opt_state": adam_state_to_optax(model, opt, host=False)}


def _same_checkpoints(name: str, a: str, b: str, step: int) -> None:
    """The two directories' checkpoints of ``step``: the same bytes, and
    every restored parameter and moment array_equal."""
    from dmlc_core_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      flatten_tree)
    fa, fb = (os.path.join(x, f"ckpt-{step}.bin") for x in (a, b))
    x = flatten_tree(CheckpointManager(a).restore(step)[1])
    y = flatten_tree(CheckpointManager(b).restore(step)[1])
    if x.keys() != y.keys() or not all(np.array_equal(x[k], y[k])
                                       for k in x):
        raise RuntimeError(f"[io] {name}: the save_async checkpoint "
                           f"departs from the synchronous one")
    with open(fa, "rb") as f, open(fb, "rb") as g:
        if f.read() != g.read():
            raise RuntimeError(f"[io] {name}: the checkpoints' bytes differ")


def _io_save_async(torch, power: str, data: str, train_file: str) -> None:
    """FM(2^20, dim 32) flat: 8 Adam steps with save_async at step
    SAVE_AT while the later steps update the state in place, then the
    same through FusedTrainer(k=KSTEP_IO) with save_async between the
    two replays; each checkpoint against a synchronous save of a clone
    taken at the same step.  Host time of the save_async call against
    the synchronous save; the peak of the card's memory."""
    from dmlc_core_tpu_torch import (DeviceLoader, FusedTrainer, adam,
                                     create_parser, make_train_step)
    from dmlc_core_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      snapshot)
    root = os.path.join(data, "io_ckpt")
    for kstep in (1, KSTEP_IO):
        name = "per step" if kstep == 1 else f"FusedTrainer(k={kstep})"
        model = _model(torch, "fm", "kernel")
        opt = adam(model, LR)
        dirs = [os.path.join(root, f"k{kstep}-{x}") for x in ("a", "s")]
        mgr, ref = (CheckpointManager(x) for x in dirs)
        clone, at = None, None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_call = 0.0

        def save(n):
            nonlocal clone, at, t_call
            t = time.perf_counter()
            mgr.save_async(n, _ckpt_state(model, opt))
            t_call = time.perf_counter() - t
            clone, at = snapshot(_ckpt_state(model, opt)), n

        with DeviceLoader(create_parser(train_file, engine="native"),
                          ROWS_TR, CAP_TR, device="cuda", engine="native",
                          emit="host" if kstep > 1 else "device") as ld:
            if kstep == 1:
                step = make_train_step(model, opt)
                for i, batch in enumerate(ld):
                    last = step(batch)
                    if i + 1 == SAVE_AT:
                        save(SAVE_AT)
                float(last)
            else:
                tr = FusedTrainer(model, opt, ld, k=kstep)
                for item in ld:
                    tr.feed(item)
                    if clone is None and tr.steps >= SAVE_AT:
                        save(tr.steps)
                tr.flush()
                float(tr.losses[-1])
        t = time.perf_counter()
        mgr.wait()
        t_wait = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref.save(at, clone)
        t_sync = time.perf_counter() - t
        if at is None or int(opt.count) != TRAIN_STEPS:
            raise RuntimeError(f"[io] {name}: save at {at}, Adam count "
                               f"{int(opt.count)}")
        _same_checkpoints(name, dirs[0], dirs[1], at)
        size = os.path.getsize(os.path.join(dirs[0], f"ckpt-{at}.bin"))
        log(f"[io] save_async {name} at step {at} while steps "
            f"{at + 1}-{TRAIN_STEPS} ran: restored parameters and moments "
            f"array_equal (and byte-equal files) to a synchronous save of a "
            f"clone taken at step {at}; {size / 1e6:.1f} MB; host time of "
            f"the save_async call {t_call * 1e3:.3f} ms, then wait() "
            f"{t_wait * 1e3:.1f} ms after the last step, against save "
            f"{t_sync * 1e3:.1f} ms; card memory {base / 1e9:.3f} GB before, "
            f"peak {peak / 1e9:.3f} GB (max_memory_allocated) [{power}]")
        del model, opt, clone
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


def _io_ffm_checkpoint(torch, power: str, data: str) -> None:
    """The host time of save_async against save at the CLI's FFM defaults
    (2^20 features, 40 fields, dim 16: 8 GB of parameters and Adam
    moments on the card), and the card's peak memory with the snapshot."""
    from dmlc_core_tpu_torch import FieldAwareFM, adam
    from dmlc_core_tpu_torch.utils.checkpoint import CheckpointManager
    d = os.path.join(data, "io_ffm_ckpt")
    model = FieldAwareFM(1 << 20, 40, 16, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED))
    opt = adam(model, LR)
    state = _ckpt_state(model, opt)
    mgr = CheckpointManager(d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    mgr.save_async(1, state)
    t_call = time.perf_counter() - t
    mgr.wait()
    t_async = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    mgr.save(2, state)
    t_sync = time.perf_counter() - t
    size = os.path.getsize(os.path.join(d, "ckpt-2.bin"))
    log(f"[io] FieldAwareFM(2^20, 40, 16) + Adam, {size / 1e9:.3f} GB: host "
        f"time of the save_async call {t_call * 1e3:.3f} ms, its background "
        f"write to wait() {t_async:.3f} s, save {t_sync:.3f} s; card memory "
        f"{base / 1e9:.3f} GB before, peak {peak / 1e9:.3f} GB with the "
        f"snapshot (max_memory_allocated) [{power}]")
    del state, model, opt
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_io(torch, power: str, data: str, train_file: str) -> dict:
    """[io]: the training file cut into a directory of IO_PARTS files and
    an empty one; the card's batches of each URI form against the single
    file's; the page cache over 4 epochs, stale and truncated page files;
    the flat FM and DeepFM steady state with and without it; save_async
    under training (per step and k-step) against synchronous saves of
    clones; save_async against save at FFM's size.  Returns the launch
    counts of the phase's training."""
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.monotonic()
    d = _io_dir(data, train_file)
    _io_forms(torch, power, d, train_file)
    uri = _io_page_cache(torch, power, d, data)
    reset_launch_counts()                       # the path's training
    _io_steady(torch, power, d, uri)
    _io_save_async(torch, power, data, train_file)
    launches = launch_counts()                  # ends here
    _io_ffm_checkpoint(torch, power, data)
    log(f"[io] phase {time.monotonic() - t0:.1f} s")
    return launches


# -- [remote] ---------------------------------------------------------------
# An object store inside this script: path-style S3 (ranged GET, PUT, HEAD,
# ListObjectsV2, multipart initiate / part / complete / abort, DELETE) and a
# WebHDFS namenode + datanode, stdlib http.server on loopback, every object
# a file under the run's data directory.  What it measures is this Python
# server over loopback, not S3 or HDFS.

REMOTE_BUCKET = "bucket"
REMOTE_FAULTS = "s3.request:error=0.2:seed=7"
ADMIT_FAULTS = "serving.server.admit:error=1:times=5"
ADMIT_SHED = 5
REMOTE_REQUESTS = 256      # eval rows scored one request each over TCP


class _FakeStore:
    """Both fakes on one ``ThreadingHTTPServer`` each, files under
    ``root``; ``parts`` maps each multipart object to its part count and
    ``unsigned`` counts S3 requests without a SigV4 signature (refused
    with 403)."""

    def __init__(self, root: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.root = root
        self.parts = {}
        self.unsigned = 0
        self.bytes_in = self.bytes_out = 0
        self._lock = threading.Lock()
        self._next_upload = 0
        store = self
        q = urllib.parse

        class Base(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _query(self):
                return dict(q.parse_qsl(q.urlsplit(self.path).query,
                                        keep_blank_values=True))

            def _body_to(self, path, mode="wb"):
                n = int(self.headers.get("Content-Length", 0))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, mode) as f:
                    left = n
                    while left:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            raise OSError("request body cut short")
                        f.write(chunk)
                        left -= len(chunk)
                with store._lock:
                    store.bytes_in += n

            def _reply(self, status, body=b"", headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body and self.command != "HEAD":
                    self.wfile.write(body)

            def _send_file(self, path, lo, hi, status, headers=()):
                self.send_response(status)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(hi - lo))
                self.end_headers()
                with open(path, "rb") as f:
                    f.seek(lo)
                    left = hi - lo
                    while left:
                        chunk = f.read(min(left, 1 << 20))
                        self.wfile.write(chunk)
                        left -= len(chunk)
                with store._lock:
                    store.bytes_out += hi - lo

        class S3(Base):
            def _where(self):
                path = q.unquote(q.urlsplit(self.path).path).lstrip("/")
                bucket, _, key = path.partition("/")
                return bucket, key, os.path.join(store.root, "s3", bucket,
                                                 key)

            def _signed(self):
                if self.headers.get("Authorization", "").startswith(
                        "AWS4-HMAC-SHA256 Credential="):
                    return True
                with store._lock:
                    store.unsigned += 1
                self._reply(403)
                return False

            def do_HEAD(self):
                if not self._signed():
                    return
                _, key, path = self._where()
                if not key or not os.path.isfile(path):
                    self._reply(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length",
                                 str(os.path.getsize(path)))
                self.end_headers()

            def do_GET(self):
                if not self._signed():
                    return
                bucket, key, path = self._where()
                qs = self._query()
                if qs.get("list-type") == "2":
                    self._list(bucket, qs.get("prefix", ""),
                               qs.get("delimiter", ""))
                    return
                if not os.path.isfile(path):
                    self._reply(404)
                    return
                size = os.path.getsize(path)
                rng = self.headers.get("Range", "")
                if not rng.startswith("bytes="):
                    self._send_file(path, 0, size, 200)
                    return
                lo, hi = rng[6:].split("-")
                lo = int(lo)
                hi = min(int(hi), size - 1) if hi else size - 1
                if lo >= size:
                    self._reply(416)
                    return
                self._send_file(path, lo, hi + 1, 206, [
                    ("Content-Range", f"bytes {lo}-{hi}/{size}")])

            def _list(self, bucket, prefix, delim):
                base = os.path.join(store.root, "s3", bucket)
                keys, prefixes = [], set()
                for d, _, files in os.walk(base):
                    for f in files:
                        k = os.path.relpath(os.path.join(d, f), base)
                        k = k.replace(os.sep, "/")
                        if not k.startswith(prefix):
                            continue
                        rest = k[len(prefix):]
                        if delim and delim in rest:
                            prefixes.add(prefix + rest.split(delim)[0]
                                         + delim)
                        else:
                            keys.append((k, os.path.getsize(
                                os.path.join(d, f))))
                from xml.sax.saxutils import escape
                xml = ["<ListBucketResult>"]
                xml += [f"<Contents><Key>{escape(k)}</Key><Size>{n}</Size>"
                        f"</Contents>" for k, n in sorted(keys)]
                xml += [f"<CommonPrefixes><Prefix>{escape(p)}</Prefix>"
                        f"</CommonPrefixes>" for p in sorted(prefixes)]
                xml.append("</ListBucketResult>")
                self._reply(200, "".join(xml).encode())

            def do_PUT(self):
                if not self._signed():
                    return
                _, key, path = self._where()
                qs = self._query()
                if "partNumber" in qs:
                    part = os.path.join(store.root, "uploads",
                                        qs["uploadId"], qs["partNumber"])
                    if not os.path.isdir(os.path.dirname(part)):
                        self._reply(404)
                        return
                    self._body_to(part)
                    self._reply(200, headers=[
                        ("ETag", f'"{qs["partNumber"]}"')])
                    return
                tmp = f"{path}.put-{threading.get_ident()}"
                self._body_to(tmp)
                os.replace(tmp, path)
                self._reply(200)

            def do_POST(self):
                if not self._signed():
                    return
                _, key, path = self._where()
                qs = self._query()
                body = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                if "uploads" in qs:
                    with store._lock:
                        store._next_upload += 1
                        uid = f"upload-{store._next_upload}"
                    os.makedirs(os.path.join(store.root, "uploads", uid))
                    self._reply(200, (
                        f"<InitiateMultipartUploadResult><UploadId>{uid}"
                        f"</UploadId></InitiateMultipartUploadResult>"
                    ).encode())
                    return
                d = os.path.join(store.root, "uploads", qs["uploadId"])
                nums = [int(n) for n in re.findall(
                    rb"<PartNumber>(\d+)</PartNumber>", body)]
                if not os.path.isdir(d) or not nums:
                    self._reply(404)
                    return
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.complete"
                with open(tmp, "wb") as out:
                    for n in nums:
                        with open(os.path.join(d, str(n)), "rb") as f:
                            shutil.copyfileobj(f, out, 1 << 20)
                os.replace(tmp, path)
                shutil.rmtree(d)
                with store._lock:
                    store.parts[key] = len(nums)
                self._reply(200, b"<CompleteMultipartUploadResult/>")

            def do_DELETE(self):
                if not self._signed():
                    return
                _, _, path = self._where()
                qs = self._query()
                if "uploadId" in qs:
                    shutil.rmtree(os.path.join(store.root, "uploads",
                                               qs["uploadId"]),
                                  ignore_errors=True)
                elif os.path.isfile(path):
                    os.unlink(path)
                self._reply(204)

        class HDFS(Base):
            def _where(self):
                u = q.urlsplit(self.path)
                path = q.unquote(u.path)
                data = path.startswith("/data/")
                path = path[len("/data"):] if data else \
                    path[len("/webhdfs/v1"):]
                return data, path, os.path.join(store.root, "hdfs",
                                                path.lstrip("/"))

            def _location(self, path, extra=""):
                port = self.server.server_address[1]
                return json.dumps({"Location": (
                    f"http://127.0.0.1:{port}/data{q.quote(path)}{extra}")
                }).encode()

            def _status(self, name, full):
                isdir = os.path.isdir(full)
                return {"pathSuffix": name, "type":
                        "DIRECTORY" if isdir else "FILE",
                        "length": 0 if isdir else os.path.getsize(full)}

            def do_GET(self):
                data, path, full = self._where()
                qs = self._query()
                if data:
                    off = int(qs.get("offset", 0))
                    size = os.path.getsize(full)
                    end = min(size, off + int(qs.get("length", size)))
                    self._send_file(full, off, max(off, end), 200)
                    return
                if not os.path.exists(full):
                    self._reply(404)
                    return
                op = qs.get("op")
                if op == "GETFILESTATUS":
                    body = {"FileStatus": self._status("", full)}
                elif op == "LISTSTATUS":
                    body = {"FileStatuses": {"FileStatus": [
                        self._status(n, os.path.join(full, n))
                        for n in sorted(os.listdir(full))]}}
                elif op == "OPEN":
                    self._reply(200, self._location(
                        path, f"?offset={qs.get('offset', 0)}&length="
                              f"{qs.get('length', 0)}"),
                        [("Content-Type", "application/json")])
                    return
                else:
                    self._reply(400)
                    return
                self._reply(200, json.dumps(body).encode(),
                            [("Content-Type", "application/json")])

            def do_PUT(self):
                data, path, full = self._where()
                qs = self._query()
                if data:
                    self._body_to(full)
                    self._reply(201)
                    return
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if qs.get("op") == "RENAME":
                    dest = os.path.join(store.root, "hdfs",
                                        qs["destination"].lstrip("/"))
                    ok = os.path.isfile(full)
                    if ok:
                        os.replace(full, dest)
                    self._reply(200 if ok else 404,
                                json.dumps({"boolean": ok}).encode())
                    return
                self._reply(200, self._location(path),
                            [("Content-Type", "application/json")])

            def do_POST(self):
                data, path, full = self._where()
                if data:
                    self._body_to(full, "ab")
                    self._reply(200)
                    return
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self._reply(200, self._location(path),
                            [("Content-Type", "application/json")])

            def do_DELETE(self):
                _, _, full = self._where()
                ok = os.path.isfile(full)
                if ok:
                    os.unlink(full)
                self._reply(200, json.dumps({"boolean": ok}).encode())

        os.makedirs(os.path.join(root, "s3", REMOTE_BUCKET))
        os.makedirs(os.path.join(root, "hdfs"))
        self._servers = [ThreadingHTTPServer(("127.0.0.1", 0), h)
                         for h in (S3, HDFS)]
        for s in self._servers:
            s.daemon_threads = True
        self._threads = [threading.Thread(target=s.serve_forever,
                                          daemon=True)
                         for s in self._servers]
        for t in self._threads:
            t.start()
        self.s3 = f"http://127.0.0.1:{self._servers[0].server_address[1]}"
        self.hdfs = f"127.0.0.1:{self._servers[1].server_address[1]}"

    def path(self, key: str) -> str:
        """The file holding ``s3://bucket/<key>``."""
        return os.path.join(self.root, "s3", REMOTE_BUCKET, key)

    def env(self) -> dict:
        """What a client of the store reads from the environment."""
        return {"DMLC_S3_ENDPOINT": self.s3,
                "AWS_ACCESS_KEY_ID": "AKIDSMOKE",
                "AWS_SECRET_ACCESS_KEY": "smoke-secret",
                "AWS_REGION": "us-east-1"}

    def close(self) -> None:
        for s in self._servers:
            s.shutdown()
            s.server_close()
        for t in self._threads:
            t.join(timeout=30)


@contextlib.contextmanager
def _env(**kw):
    """``os.environ`` with ``kw`` set (None: unset), restored after."""
    old = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _remote_put(store, d: str, eval_file: str) -> int:
    """[io]'s training files (and its empty one) under train/ and the
    eval file, uploaded through the port's S3 write streams."""
    from dmlc_core_tpu_torch.io import open_stream
    total = 0
    names = sorted(os.listdir(d))
    for name, src in [(f"train/{n}", os.path.join(d, n)) for n in names] \
            + [("eval.libsvm", eval_file)]:
        with open(src, "rb") as f, \
                open_stream(f"s3://{REMOTE_BUCKET}/{name}", "w") as w:
            blob = f.read()
            w.write(blob)
        with open(store.path(name), "rb") as f:
            if f.read() != blob:
                raise RuntimeError(f"[remote] {name} reads back changed")
        total += len(blob)
    return total


def _remote_batches(torch, power: str, d: str) -> None:
    """The card's batches from ``s3://bucket/train/`` against the local
    directory's, native and streampack, without and with injected
    ``s3.request`` errors."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    from dmlc_core_tpu_torch.utils.faults import clear_faults
    from dmlc_core_tpu_torch.utils.metrics import metrics
    uri = f"s3://{REMOTE_BUCKET}/train/"
    errors = metrics.counter("faults.s3.request.errors")
    retries = metrics.counter("retry.io.http.retries")
    rows = []
    for path, kw in (("native", {}),
                     ("streampack", {"threaded": False, "nthreads": 1})):
        def epoch(u):
            with DeviceLoader(create_parser(u, engine="native", **kw),
                              ROWS_TR, CAP_TR, device="cuda",
                              engine="native", cache=None) as ld:
                batches, secs, _ = _timed_epoch(torch, ld)
            return batches, secs
        want, local_s = epoch(d)
        got, remote_s = epoch(uri)
        _same_batches(torch, f"{path} s3://", got, want, "[remote]")
        e0, r0 = errors.value, retries.value
        with _env(DMLC_FAULT_SPEC=REMOTE_FAULTS):
            faulted, _ = epoch(uri)
        clear_faults()
        _same_batches(torch, f"{path} s3:// with {REMOTE_FAULTS}", faulted,
                      want, "[remote]")
        fired, retried = errors.value - e0, retries.value - r0
        if fired <= 0:
            raise RuntimeError(f"[remote] {path}: no s3.request fault fired")
        rows.append(f"{path}: {len(want)} batches, local {local_s:.4f} s, "
                    f"s3:// {remote_s:.4f} s an epoch; with "
                    f"DMLC_FAULT_SPEC='{REMOTE_FAULTS}' "
                    f"faults.s3.request.errors +{fired}, "
                    f"retry.io.http.retries +{retried}")
    log("[remote] the card's batches from s3://bucket/train/ array_equal to "
        "the local directory's, with and without injected faults (the "
        "retries absorbed them): " + "; ".join(rows) + f" [{power}]")


def _remote_training(torch, power: str, d: str, text_bytes: int) -> dict:
    """FM flat trained from ``s3://`` with phase 5's checks (learning
    included), then steady state from s3:// and from the local directory
    in turns (s3, local, local, s3).  Returns the launch counts."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     make_train_step)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    uri = f"s3://{REMOTE_BUCKET}/train/"
    launches = _train_path(torch, "fm_flat from s3://", "fm", "flat", CAP_TR,
                           uri, f"s3://{REMOTE_BUCKET}/eval.libsvm", power)
    reset_launch_counts()
    model = _model(torch, "fm", "kernel")
    step = make_train_step(model, adam(model, LR))

    def loader(u):
        return DeviceLoader(create_parser(u, engine="native"), ROWS_TR,
                            CAP_TR, device="cuda", engine="native",
                            cache=None)

    with loader(d) as ld:                                # warm-up epoch
        for batch in ld:
            step(batch)
    torch.cuda.synchronize()
    out = {"s3://": [], "local": []}
    for where in ("s3://", "local", "local", "s3://"):
        with loader(uri if where == "s3://" else d) as ld:
            out[where].append(_steady_state(torch, step, ld, STEADY_EPOCHS))
    torch.cuda.synchronize()
    more = launch_counts()
    log("[remote] fm flat steady state, " + str(STEADY_EPOCHS) + " epochs "
        "in turns: " + "; ".join(
            f"{w} " + ", ".join(f"{r['steps'] / r['wall_s']:.2f}"
                                for r in rs)
            + " steps/s, wait in next_batch mean " + ", ".join(
                f"{r['wait_mean_ms']:.4f}" for r in rs)
            + " ms, feed " + ", ".join(
                f"{text_bytes * STEADY_EPOCHS / r['wall_s'] / 1e6:.1f}"
                for r in rs) + " MB/s of text"
            for w, rs in out.items())
        + " (s3:// is this script's Python server over loopback, not S3) "
        + f"[{power}]")
    del model, step
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + more.get(k, 0)
            for k in set(launches) | set(more)}


def _remote_save_async(torch, power: str, store, train_file: str) -> None:
    """FM(2^20, 32) + Adam (415 MB): save_async at step SAVE_AT to the S3
    store while steps SAVE_AT+1..8 run, then to the WebHDFS store; each
    restored in a fresh CheckpointManager array_equal to a clone taken at
    the call, the S3 object byte-equal to a local save of the clone."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     make_train_step)
    from dmlc_core_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      flatten_tree, snapshot)
    local = os.path.join(store.root, "local_ckpt")
    for name, directory in (
            ("s3", f"s3://{REMOTE_BUCKET}/ckpt"),
            ("webhdfs", f"hdfs://{store.hdfs}/ckpt")):
        model = _model(torch, "fm", "kernel")
        opt = adam(model, LR)
        mgr = CheckpointManager(directory)
        step = make_train_step(model, opt)
        clone = None
        with DeviceLoader(create_parser(train_file, engine="native"),
                          ROWS_TR, CAP_TR, device="cuda",
                          engine="native") as ld:
            for i, batch in enumerate(ld):
                last = step(batch)
                if i + 1 == SAVE_AT:
                    t_save = time.perf_counter()
                    mgr.save_async(SAVE_AT, _ckpt_state(model, opt))
                    t_call = time.perf_counter() - t_save
                    clone = snapshot(_ckpt_state(model, opt))
            float(last)
        t = time.perf_counter()
        mgr.wait()
        t_wait = time.perf_counter() - t
        t_write = time.perf_counter() - t_save
        t = time.perf_counter()
        _, got = CheckpointManager(directory).restore()
        t_restore = time.perf_counter() - t
        x, y = flatten_tree(got), flatten_tree(clone)
        if x.keys() != y.keys() or not all(np.array_equal(x[k], y[k])
                                           for k in y):
            raise RuntimeError(f"[remote] the {name} save_async checkpoint "
                               f"departs from a clone taken at the call")
        size = sum(v.nbytes for v in y.values())
        extra = ""
        if name == "s3":
            CheckpointManager(local).save(SAVE_AT, clone)
            with open(os.path.join(local, f"ckpt-{SAVE_AT}.bin"), "rb") as f, \
                    open(store.path(f"ckpt/ckpt-{SAVE_AT}.bin"), "rb") as g:
                if f.read() != g.read():
                    raise RuntimeError("[remote] the S3 checkpoint's bytes "
                                       "differ from a local save's")
            parts = store.parts.get(f"ckpt/ckpt-{SAVE_AT}.bin", 0)
            obj = os.path.getsize(store.path(f"ckpt/ckpt-{SAVE_AT}.bin"))
            part = 5 << 20                 # the S3 write stream's parts
            if parts != (-(-obj // part) if obj >= part else 0):
                raise RuntimeError(f"[remote] {parts} multipart parts for "
                                   f"{obj} bytes")
            extra = (f"; {parts} multipart parts, byte-equal to a local "
                     f"save of the clone")
            shutil.rmtree(local, ignore_errors=True)
        log(f"[remote] save_async to {directory} at step {SAVE_AT} while "
            f"steps {SAVE_AT + 1}-{TRAIN_STEPS} ran ({size / 1e6:.1f} MB of "
            f"leaves): host time of the call {t_call * 1e3:.3f} ms, the write "
            f"published {t_write:.3f} s after the call (wait() {t_wait:.3f} "
            f"s after the last step); restored in a fresh "
            f"CheckpointManager in {t_restore:.3f} s, array_equal to the "
            f"clone{extra} (this script's Python server over loopback) "
            f"[{power}]")
        del model, opt, clone, got, x, y
        torch.cuda.empty_cache()


def _remote_cli(torch, power: str, store, env: dict) -> np.ndarray:
    """``dmlc-train model=fm`` at full width from s3:// into s3://, then
    ``mode=predict`` with its output on the store; the scores read back
    from the store against the restored checkpoint on the plain path.
    Returns those scores."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeviceLoader,
                                     FactorizationMachine, create_parser,
                                     params_from_jax)
    from dmlc_core_tpu_torch.io import open_seek_stream_for_read
    fm = ["model=fm", f"features={F_FEATURES}", f"dim={DIM}"]
    ckpt = f"s3://{REMOTE_BUCKET}/cli_ckpt"
    out, _ = _run_cli(fm + [f"data=s3://{REMOTE_BUCKET}/train/",
                            f"ckpt_dir={ckpt}"], env, power)
    if f"trained fm: {TRAIN_STEPS} steps" not in out:
        raise RuntimeError("[remote] the s3:// CLI's log lacks its steps")
    _run_cli(fm + ["mode=predict", f"data=s3://{REMOTE_BUCKET}/eval.libsvm",
                   f"ckpt_dir={ckpt}",
                   f"output=s3://{REMOTE_BUCKET}/pred.txt"], env, power)
    step, state = CheckpointManager(ckpt).restore()
    model = FactorizationMachine(F_FEATURES, DIM, engine="torch",
                                 device="cuda")
    model.load_state_dict(params_from_jax(state["params"], "cuda"))
    want = _plain_scores(torch, model, DeviceLoader(
        create_parser(f"s3://{REMOTE_BUCKET}/eval.libsvm", engine="native"),
        ROWS_TR, CAP_TR, id_mod=F_FEATURES, device="cuda", engine="native"))
    with open_seek_stream_for_read(f"s3://{REMOTE_BUCKET}/pred.txt") as f:
        got = np.array([float(x) for x in f.read().split()])
    if step != TRAIN_STEPS or got.shape != (EVAL_ROWS,):
        raise RuntimeError(f"[remote] CLI checkpoint step {step}, "
                           f"{got.shape[0]} predictions")
    err = float(np.abs(got - want[:EVAL_ROWS]).max())
    log(f"[remote] dmlc-train model=fm data=s3:// ckpt_dir=s3://, then "
        f"mode=predict output=s3://bucket/pred.txt: {got.shape[0]} scores "
        f"read back from the store, max|err| against the restored "
        f"checkpoint on the plain path {err:.3g} (limit {CLI_TOL:g}) "
        f"[{power}]")
    if not np.isfinite(got).all() or err > CLI_TOL:
        raise RuntimeError(f"[remote] CLI predictions depart from the "
                           f"checkpoint's scores: max|err| {err:.3g}")
    return got


def _remote_server(torch, power: str, eval_file: str,
                   predicted: np.ndarray) -> None:
    """A PredictionServer restored from ``s3://bucket/cli_ckpt`` answers
    REMOTE_REQUESTS requests (one eval row each, 8 connections), each
    against the engine's in-process predict and mode=predict's score;
    then again under ``serving.server.admit:error=1:times=5``: exactly 5
    answers OVERLOADED, every request still answered by the client's
    retries."""
    from dmlc_core_tpu_torch import (FactorizationMachine, InferenceEngine,
                                     PredictClient, PredictionServer)
    from dmlc_core_tpu_torch.utils.faults import clear_faults
    from dmlc_core_tpu_torch.utils.metrics import metrics
    ids, vals, ptr = _libsvm_rows(eval_file, REMOTE_REQUESTS)
    reqs = [(ids[ptr[i]:ptr[i + 1]], vals[ptr[i]:ptr[i + 1]],
             np.array([0, ptr[i + 1] - ptr[i]], np.int64))
            for i in range(REMOTE_REQUESTS)]
    eng = InferenceEngine(FactorizationMachine(F_FEATURES, DIM,
                                               device="cuda"),
                          postprocess="sigmoid", device="cuda")
    t = time.perf_counter()
    srv = PredictionServer(eng, warmup=True, default_deadline_s=60.0)
    step = srv.reload_from_checkpoint(f"s3://{REMOTE_BUCKET}/cli_ckpt")
    t_up = time.perf_counter() - t
    if step != TRAIN_STEPS:
        raise RuntimeError(f"[remote] the server restored step {step}")
    want = np.concatenate([eng.predict(*r) for r in reqs])
    shed = metrics.counter("serving.server.shed")
    retried = metrics.counter("retry.serving.client.retries")
    rows = []
    srv.start()
    try:
        for spec in (None, ADMIT_FAULTS):
            s0, r0 = shed.value, retried.value
            with _env(DMLC_FAULT_SPEC=spec, DMLC_SERVING_RETRIES="8"):
                clients = [PredictClient(srv.host, srv.port)
                           for _ in range(8)]
                try:
                    answers, lat, wall = _serve(
                        lambda k, r: clients[k].predict(*r, timeout=120),
                        reqs)
                finally:
                    for c in clients:
                        c.close()
            clear_faults()
            got = np.concatenate(answers).astype(np.float64)
            err = float(np.abs(got - want).max())
            err_cli = float(np.abs(got - predicted[:REMOTE_REQUESTS]).max())
            n_shed, n_retry = shed.value - s0, retried.value - r0
            rows.append(f"{spec or 'no faults'}: {len(answers)} answers in "
                        f"{wall * 1e3:.1f} ms (p50 "
                        f"{np.percentile(lat, 50):.3f} ms), max|err| "
                        f"{err:.3g} against in-process predict and "
                        f"{err_cli:.3g} against mode=predict, OVERLOADED "
                        f"{n_shed}, client retries {n_retry}")
            if (not np.isfinite(got).all() or err > ATOL or err_cli > CLI_TOL
                    or n_shed != (ADMIT_SHED if spec else 0)
                    or n_retry != n_shed):
                raise RuntimeError("[remote] server: " + rows[-1])
    finally:
        srv.stop()
    log(f"[remote] PredictionServer restored step {step} from "
        f"s3://bucket/cli_ckpt (up, graphs captured, in {t_up:.3f} s): "
        + "; ".join(rows) + f" [{power}]")


def phase_remote(torch, power: str, data: str, train_file: str,
                 eval_file: str) -> dict:
    """[remote]: the port's main path against an object store on
    loopback: [io]'s training files read from s3:// (array_equal to the
    local directory's, with and without injected request errors), FM
    flat trained from s3:// with phase 5's checks and its steady state
    beside the local one, save_async of FM + Adam to S3 and to WebHDFS,
    dmlc-train and mode=predict with data=, ckpt_dir= and output= on
    s3://, and a PredictionServer restored from s3:// under an injected
    burst of sheds.  Returns the launch counts of its training and
    serving."""
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.utils.metrics import metrics
    t0 = time.monotonic()
    connects = metrics.counter("retry.io.connect.retries")
    c0 = connects.value
    store = _FakeStore(os.path.join(data, "remote"))
    try:
        with _env(**store.env()):
            d = os.path.join(data, "io")
            text = _remote_put(store, d, eval_file)
            log(f"[remote] store up: S3 at {store.s3}, WebHDFS at "
                f"{store.hdfs}, files under {store.root}; {text} bytes of "
                f"libsvm uploaded [{power}]")
            _remote_batches(torch, power, d)
            launches = _remote_training(torch, power, d, text - os.path
                                        .getsize(eval_file))
            _remote_save_async(torch, power, store, train_file)
            env = _cli_env()
            env.update(store.env())
            predicted = _remote_cli(torch, power, store, env)
            reset_launch_counts()
            _remote_server(torch, power, eval_file, predicted)
            for k, v in launch_counts().items():
                launches[k] = launches.get(k, 0) + v
        if store.unsigned:
            raise RuntimeError(f"[remote] {store.unsigned} unsigned S3 "
                               f"requests")
        log(f"[remote] the store moved {store.bytes_in / 1e6:.1f} MB in and "
            f"{store.bytes_out / 1e6:.1f} MB out; connects retried in this "
            f"process (retry.io.connect.retries) "
            f"{connects.value - c0}; phase {time.monotonic() - t0:.1f} s "
            f"[{power}]")
    finally:
        store.close()
        shutil.rmtree(store.root, ignore_errors=True)
    return launches


# -- [ingest] ---------------------------------------------------------------

INGEST_PARTS = 2           # worker processes of the two-worker runs
INGEST_EPOCHS = 2          # epochs of the union and steady-state runs
INGEST_FAULTS = "ingest.recv:error=1:times=1:after=3"
TUNE_MAX_CONNECTIONS = 48  # connections served while the tuner converges
RAW_ROWS = 2 * ROWS_TR     # rows of the high-cardinality (raw value) file


def _write_raw_values(path: str, rows: int, seed: int) -> None:
    """libsvm text of the training file's shape whose values are full
    float32 draws (nine significant digits): too many distinct values for
    the v3 dictionary, so the packer ships them raw (dict bits 0)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(rows):
            n = int(rng.integers(5, 40))
            idx = np.sort(rng.choice(1_000_000, size=n, replace=False))
            f.write(b"%d " % (i & 1) + b" ".join(
                b"%d:%.9g" % (j, v) for j, v in
                zip(idx.tolist(), rng.random(n).tolist())) + b"\n")


class _Workers:
    """``python -m dmlc_core_tpu_torch.pipeline.ingest_service`` for parts
    0..nparts-1 of ``uri``, each a process of its own on loopback serving
    until stopped; its port is read from its log line."""

    def __init__(self, uri: str, nparts: int, env: dict) -> None:
        self.procs, self.ports, self._lines, self._ready = [], [], [], []
        try:
            for part in range(nparts):
                self._start(uri, part, nparts, env)
        except BaseException:
            self.stop()
            raise

    def _start(self, uri, part, nparts, env) -> None:
        p = subprocess.Popen(
            [sys.executable, "-m",
             "dmlc_core_tpu_torch.pipeline.ingest_service", uri, str(part),
             str(nparts), "libsvm", "0", f"batch_rows={ROWS_TR}",
             f"nnz_cap={CAP_TR}", f"id_mod={F_FEATURES}", "device=cuda"],
            cwd=ROOT, env=env, stderr=subprocess.PIPE,
            stdout=subprocess.DEVNULL, text=True)
        self.procs.append(p)
        ready, box = threading.Event(), {}

        def drain():
            # read every line, so the worker never blocks on a full pipe
            for ln in p.stderr:
                self._lines.append(ln.rstrip())
                if "ingest worker: part" in ln and not ready.is_set():
                    box["port"] = int(ln.rsplit(":", 1)[1].split()[0])
                    box["wire"] = ln.rsplit("(", 1)[-1].rstrip(")\n")
                    ready.set()
            ready.set()
        threading.Thread(target=drain, daemon=True).start()
        self._ready.append((part, nparts, ready, box))

    def wait(self) -> "_Workers":
        """Wait until every worker listens (they start in parallel)."""
        for part, nparts, ready, box in self._ready:
            if not ready.wait(timeout=120) or "port" not in box:
                raise RuntimeError(f"ingest worker {part}/{nparts} never "
                                   f"listened: {self._lines[-5:]}")
            if box["wire"] != "wire v3":
                raise RuntimeError(f"worker {part} ships {box['wire']}, not "
                                   f"the card's v3")
            self.ports.append(box["port"])
        return self

    @property
    def addresses(self) -> list:
        return [("127.0.0.1", p) for p in self.ports]

    @property
    def arg(self) -> str:
        return ",".join(f"127.0.0.1:{p}" for p in self.ports)

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.stderr is not None:
                p.stderr.close()


def _row_keys(batch) -> list:
    """Each real row of a batch as ``(label, ids bytes, vals bytes)``."""
    ids, vals = batch["ids"].cpu().numpy(), batch["vals"].cpu().numpy()
    rp = batch["row_ptr"].cpu().numpy()
    labels = batch["labels"].cpu().numpy()
    weights = batch["weights"].cpu().numpy()
    return [(float(labels[r]), ids[rp[r]:rp[r + 1]].tobytes(),
             vals[rp[r]:rp[r + 1]].tobytes())
            for r in range(len(labels)) if weights[r] > 0]


def _rows_of(loader) -> "collections.Counter":
    import collections
    rows = collections.Counter()
    for b in loader:
        rows.update(_row_keys(b))
    return rows


def _ingest_wire(torch, timer: Timer, power: str, train_file: str,
                 raw_file: str) -> dict:
    """Step 1: every batch of the dictionary-coded training text and of
    the raw-value file, through the native packer and streampack, v2 and
    v3.  On the card the kernel's v3 decode must be array_equal to the
    v2 decode of the same batch (vals as bits) and to the plain v3 decode.
    Logs per batch the wire bytes, pack ms, decode µs of kernel and plain
    version, and H2D µs; returns the wire_decode kernel's row (the first
    dictionary batch; the raw file's first batch as ``raw``)."""
    from dmlc_core_tpu_torch import native
    from dmlc_core_tpu_torch.data import RowBlock
    from dmlc_core_tpu_torch.kernels import wire_decode, wire_decode_reference
    from dmlc_core_tpu_torch.pipeline.loader import (_decode_meta,
                                                     _fused_words_meta,
                                                     make_decoder)
    out = {}
    for label, path in (("dict", train_file), ("raw", raw_file)):
        with open(path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        texts = [b"".join(lines[i:i + ROWS_TR])
                 for i in range(0, len(lines), ROWS_TR)]
        blocks = []
        for t in texts:
            d = native.parse_libsvm(t, 0)
            blocks.append(RowBlock(d["offsets"], d["labels"], d["indices"],
                                   d["values"], d["weights"]))

        def pack(kind, compact):
            items = []
            t0 = time.perf_counter()
            if kind == "native":
                p = native.Packer(ROWS_TR, CAP_TR, id_mod=F_FEATURES,
                                  compact=compact)
                for blk in blocks:
                    items += [(b.copy(), m) for b, m in p.feed(blk)]
            else:
                p = native.SpPacker(ROWS_TR, CAP_TR, id_mod=F_FEATURES,
                                    compact=compact)
                for t in texts:
                    items += [(b.copy(), m) for b, m in p.feed_text(t)]
            tail = p.flush()
            if tail is not None:
                items.append((tail[0].copy(), tail[1]))
            secs = time.perf_counter() - t0
            p.close()
            return [(b[:_fused_words_meta(ROWS_TR, m)], m)
                    for b, m in items], secs * 1e3 / max(1, len(items))

        for kind in ("native", "streampack"):
            (v2, ms2), (v3, ms3) = pack(kind, False), pack(kind, True)
            if len(v2) != len(v3) or not v2:
                raise RuntimeError(f"[ingest] {label} {kind}: {len(v2)} v2 "
                                   f"batches, {len(v3)} v3")
            for i, ((b2, m2), (b3, m3)) in enumerate(zip(v2, v3)):
                nnz, w, dbits = _decode_meta(m3)
                if nnz != m2 or not w or (dbits == 0) != (label == "raw"):
                    raise RuntimeError(f"[ingest] {label} batch {i}: meta "
                                       f"{(nnz, w, dbits)} against v2 {m2}")
                pinned = []
                for b in (b2, b3):
                    h = torch.empty(len(b), dtype=torch.int32,
                                    pin_memory=True)
                    h.numpy()[:] = b
                    pinned.append(h)
                dev2, dev3 = (h.cuda() for h in pinned)
                got = make_decoder(ROWS_TR, m3)(dev3)
                want = make_decoder(ROWS_TR, m2)(dev2)
                plain = wire_decode_reference(dev3, ROWS_TR, nnz, w, dbits)
                for k in want:
                    a, b = got[k], want[k]
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    if not torch.equal(a, b):
                        raise RuntimeError(f"[ingest] {label} {kind} batch "
                                           f"{i}: v3 {k} differs from v2")
                err = 0.0
                for k, p in zip(("ids", "vals", "segments"), plain):
                    a = got[k]
                    err = max(err, float((a.double() - p.double()).abs()
                                         .max()))
                    if a.dtype == torch.float32:
                        a, p = a.view(torch.int32), p.view(torch.int32)
                    if not torch.equal(a, p):
                        raise RuntimeError(f"[ingest] {label} {kind} batch "
                                           f"{i}: the kernel's {k} differs "
                                           f"from the plain decode's")
                if kind != "native":
                    continue
                h2d = [timer.ms(lambda d=d, h=h: d.copy_(h, non_blocking=True),
                                reps=10) for d, h in zip((dev2, dev3),
                                                         pinned)]
                k_ms = timer.ms(lambda: wire_decode(dev3, ROWS_TR, nnz, w,
                                                    dbits), reps=10)
                p_ms = timer.ms(lambda: wire_decode_reference(
                    dev3, ROWS_TR, nnz, w, dbits), reps=10)
                log(f"[ingest] wire {label} batch {i}: {len(b2) * 4} bytes "
                    f"v2, {len(b3) * 4} v3 ({len(b3) / len(b2):.4f}; id "
                    f"width {w}, dict bits {dbits}); pack ms a batch v2 "
                    f"{ms2:.4f}, v3 {ms3:.4f}; decode kernel "
                    f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us; H2D v2 "
                    f"{h2d[0] * 1e3:.2f} us, v3 {h2d[1] * 1e3:.2f} us "
                    f"[{power}]")
                if i == 0:
                    b_ms, b_by = bound(len(b3) * 4 + 3 * nnz * 4, 0)
                    out[label] = {"ms": k_ms, "plain_ms": p_ms,
                                  "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": None, "max_abs_err": err,
                                  "h2d_v2_ms": h2d[0], "h2d_v3_ms": h2d[1],
                                  "wire_bytes": [len(b2) * 4, len(b3) * 4],
                                  "meta": [nnz, w, dbits]}
            log(f"[ingest] wire {label} {kind}: {len(v3)} batches, v3 "
                f"array_equal to v2 and the kernel to the plain decode on "
                f"the card; pack ms a batch v2 {ms2:.4f}, v3 {ms3:.4f} "
                f"(host clock) [{power}]")
    # the floor: the same launch with next to no work
    tiny = torch.zeros(64, dtype=torch.int32, device="cuda")
    row = dict(out["dict"])
    row["floor_ms"] = timer.ms(lambda: wire_decode(tiny, 1, 8, 8, 0),
                               reps=10)
    row["raw"] = out["raw"]
    return row


def _ingest_train_pair(torch, power: str, workers, train_file: str,
                       eval_file: str) -> dict:
    """Step 3a: FM flat, 8 steps from one worker (one part: the local
    order) and from the local loader, with phase 5's checks between the
    two runs (the local run in place of the plain one).  Returns the
    worker run's launch counts."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     evaluate_stream, make_train_step)
    from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts

    def eval_loader():
        return DeviceLoader(create_parser(eval_file), ROWS_TR, CAP_TR,
                            id_mod=F_FEATURES, device="cuda")

    def run(loader, counted):
        model = _model(torch, "fm", "kernel")
        p_init = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = make_train_step(model, adam(model, LR))
        ev_ld = eval_loader()
        try:
            if counted:
                reset_launch_counts()
            s_init, y_eval = _eval_scores(torch, model, ev_ld)
            g = _grads(model, loader.next_batch())
            model.zero_grad(set_to_none=True)
            loader.before_first()
            t0 = time.perf_counter()
            losses = [step(b) for b in loader]
            lk = torch.stack(losses).cpu().numpy()
            wall = time.perf_counter() - t0
            ev_ld.before_first()
            ev = evaluate_stream(model, ev_ld)
            ev_ld.before_first()
            s_trained, _ = _eval_scores(torch, model, ev_ld)
            torch.cuda.synchronize()
            counts = launch_counts() if counted else {}
        finally:
            ev_ld.close()
            loader.close()
        return dict(model=model, p_init=p_init, g=g, lk=lk, ev=ev,
                    learn=_auc(s_trained - s_init, y_eval), wall=wall,
                    launches=counts)

    remote = run(RemoteIngestLoader(workers.addresses, ROWS_TR,
                                    device="cuda"), True)
    local = run(DeviceLoader(create_parser(train_file), ROWS_TR, CAP_TR,
                             id_mod=F_FEATURES, device="cuda"), False)
    if len(remote["lk"]) != TRAIN_STEPS or len(local["lk"]) != TRAIN_STEPS:
        raise RuntimeError(f"[ingest] {len(remote['lk'])} steps from the "
                           f"worker, {len(local['lk'])} local")
    checks = _train_checks(torch, remote["g"], local["g"], remote["lk"],
                           local["lk"], remote["ev"], local["ev"],
                           remote["model"], local["model"], local["p_init"],
                           remote["learn"])
    log("[ingest] one worker against the local loader, FM flat checks: "
        + "; ".join(f"{c} {r:.3g} (limit {lim:g}{'' if ok else ', FAILED'})"
                    for c, r, lim, ok in checks))
    failed = [c for c, _, _, ok in checks if not ok]
    if failed:
        raise PathDeparts(f"[ingest] training from one worker departs from "
                          f"the local run: {failed}")
    log(f"[ingest] FM flat, {TRAIN_STEPS} steps: from one worker "
        f"{TRAIN_STEPS / remote['wall']:.3f} steps/s, local "
        f"{TRAIN_STEPS / local['wall']:.3f} steps/s (host clock) [{power}]")
    return remote["launches"]


def _ingest_train_two(torch, power: str, workers, eval_file: str) -> dict:
    """Step 3b and 3c: FM flat from both workers, per step (the learning
    check, steps/s, the wait in next_batch, frames/s over INGEST_EPOCHS)
    and through FusedTrainer(k=8) on emit="host" frames (the distinct v3
    metas and the graphs captured in an epoch).  Returns the launch
    counts of both."""
    from dmlc_core_tpu_torch import (DeviceLoader, FusedTrainer, adam,
                                     create_parser, make_train_step)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader
    from dmlc_core_tpu_torch.pipeline.loader import _decode_meta
    ev_ld = DeviceLoader(create_parser(eval_file), ROWS_TR, CAP_TR,
                         id_mod=F_FEATURES, device="cuda")
    counts: dict = {}
    try:
        model = _model(torch, "fm", "kernel")
        step = make_train_step(model, adam(model, LR))
        reset_launch_counts()
        s_init, y_eval = _eval_scores(torch, model, ev_ld)
        with RemoteIngestLoader(workers.addresses, ROWS_TR,
                                device="cuda") as ld:
            steady = _steady_state(torch, step, ld, INGEST_EPOCHS)
        ev_ld.before_first()
        s_trained, _ = _eval_scores(torch, model, ev_ld)
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        learn = _auc(s_trained - s_init, y_eval)
        rate = steady["steps"] / steady["wall_s"]
        log(f"[ingest] FM flat from {len(workers.ports)} workers, per step, "
            f"{INGEST_EPOCHS} epochs ({steady['steps']} steps): "
            f"{rate:.3f} steps/s = frames/s, {rate * ROWS_TR:.1f} rows/s; "
            f"wait in next_batch median {steady['wait_median_ms']:.4f} ms, "
            f"mean {steady['wait_mean_ms']:.4f} ms, max "
            f"{steady['wait_max_ms']:.4f} ms; host enqueue median "
            f"{steady['enqueue_median_ms']:.4f} ms; learning: eval auc of "
            f"the change in score {learn:.6f} (limit {LEARN_AUC_MIN}) "
            f"[{power}]")
        if learn < LEARN_AUC_MIN:
            raise PathDeparts(f"[ingest] two workers: learning auc {learn}")

        model = _model(torch, "fm", "kernel")
        reset_launch_counts()
        ev_ld.before_first()
        s_init, _ = _eval_scores(torch, model, ev_ld)
        with RemoteIngestLoader(workers.addresses, ROWS_TR, emit="host",
                                device="cuda") as ld:
            trainer = FusedTrainer(model, adam(model, LR), ld, k=KSTEP)
            metas = set()
            walls = []
            for epoch in range(INGEST_EPOCHS):
                if epoch:
                    ld.before_first()
                t0 = time.perf_counter()
                steps0 = trainer.steps
                for item in ld:
                    metas.add(item[2])
                    trainer.feed(item)
                trainer.flush()
                float(trainer.losses[-1])
                walls.append((trainer.steps - steps0,
                              time.perf_counter() - t0))
            keys = trainer.graph_keys
        ev_ld.before_first()
        s_trained, _ = _eval_scores(torch, model, ev_ld)
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        learn = _auc(s_trained - s_init, y_eval)
        log(f"[ingest] FusedTrainer(k={KSTEP}) from {len(workers.ports)} "
            f"workers: epochs (steps, s) {walls}, the last "
            f"{walls[-1][0] / walls[-1][1]:.3f} steps/s (capture in the "
            f"first); {len(metas)} distinct v3 metas "
            f"{sorted(_decode_meta(m) for m in metas)}, {len(keys)} graphs "
            f"captured {sorted((_decode_meta(m), kk) for m, kk in keys)}; "
            f"learning auc {learn:.6f} (limit {LEARN_AUC_MIN}) [{power}]")
        if learn < LEARN_AUC_MIN:
            raise PathDeparts(f"[ingest] kstep from workers: learning auc "
                              f"{learn}")
    finally:
        ev_ld.close()
    return counts


def _ingest_cli(torch, power: str, workers, data: str, train_file: str,
                eval_file: str) -> None:
    """Step 4: dmlc-train model=fm workers=... in a process of its own,
    kstep=8 and per step, each reaching LEARN_AUC_MIN; mode=predict from
    the kstep run's checkpoint within CLI_TOL of it; model=ffm workers=
    exits 2."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeviceLoader,
                                     FactorizationMachine, create_parser,
                                     params_from_jax)
    from dmlc_core_tpu_torch.models import cli
    env = _cli_env()
    fm = ["model=fm", f"features={F_FEATURES}", f"dim={DIM}",
          f"batch_rows={ROWS_TR}", f"nnz_cap={CAP_TR}", f"lr={LR}",
          "log_every=4"]

    def eval_scores(model):
        ld = DeviceLoader(create_parser(eval_file), ROWS_TR, CAP_TR,
                          id_mod=F_FEATURES, device="cuda")
        try:
            return _eval_scores(torch, model, ld)
        finally:
            ld.close()

    # the CLI's initial model: its generator seeded with seed=0
    p = cli.TrainParams()
    p.init({"data": train_file, "model": "fm", "features": str(F_FEATURES),
            "dim": str(DIM)})
    init = cli.MODEL_REGISTRY["fm"](
        p, torch.device("cuda"),
        torch.Generator(device="cuda").manual_seed(p.seed))
    s_init, y_eval = eval_scores(init)
    del init
    for kstep in (KSTEP, 1):
        ckpt = os.path.join(data, f"ingest_ckpt_k{kstep}")
        out, _ = _run_cli(fm + [f"data={train_file}",
                                f"workers={workers.arg}", f"kstep={kstep}",
                                f"ckpt_dir={ckpt}"], env, power)
        if "train AUC" not in out or "trained fm:" not in out:
            raise RuntimeError(f"[ingest] the workers CLI (kstep {kstep}) "
                               f"logged no training")
        step, state = CheckpointManager(ckpt).restore()
        model = FactorizationMachine(F_FEATURES, DIM, engine="torch",
                                     device="cuda")
        model.load_state_dict(params_from_jax(state["params"], "cuda"))
        s_trained, _ = eval_scores(model)
        learn = _auc(s_trained - s_init, y_eval)
        log(f"[ingest] dmlc-train workers= kstep={kstep}: checkpoint step "
            f"{step}, learning auc {learn:.6f} (limit {LEARN_AUC_MIN}) "
            f"[{power}]")
        if learn < LEARN_AUC_MIN:
            raise PathDeparts(f"[ingest] the workers CLI kstep={kstep} did "
                              f"not learn: {learn}")
        if kstep > 1:
            pred = os.path.join(data, "ingest_predictions.txt")
            _run_cli(fm + ["mode=predict", f"data={eval_file}",
                           f"ckpt_dir={ckpt}", f"output={pred}"], env, power)
            want = _plain_scores(torch, model, DeviceLoader(
                create_parser(eval_file), ROWS_TR, CAP_TR,
                id_mod=F_FEATURES, device="cuda"))
            _check_predictions("workers= kstep predict", pred, want,
                               EVAL_ROWS, power)
        shutil.rmtree(ckpt, ignore_errors=True)
    rc = cli.main(["model=ffm", f"data={train_file}",
                   f"workers={workers.arg}"])
    if rc != 2:
        raise RuntimeError(f"[ingest] model=ffm workers= exited {rc}")
    log("[ingest] model=ffm workers= exits 2 (the fused wire carries no "
        "fields)")


def _ingest_fault(torch, power: str, workers, local_rows) -> None:
    """Step 5: a reader fault mid-epoch: the reader restarts and the
    epoch still covers every row (a restarted worker may repeat)."""
    from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader
    from dmlc_core_tpu_torch.utils import faults
    from dmlc_core_tpu_torch.utils.metrics import metrics
    r0 = metrics.counter("ingest.reader.restarts").value
    try:
        with _env(DMLC_FAULT_SPEC=INGEST_FAULTS,
                  DMLC_INGEST_READER_BACKOFF="0.01"):
            with RemoteIngestLoader(workers.addresses, ROWS_TR,
                                    device="cuda") as ld:
                rows = _rows_of(ld)
    finally:
        faults.clear_faults()
    restarts = metrics.counter("ingest.reader.restarts").value - r0
    log(f"[ingest] under DMLC_FAULT_SPEC='{INGEST_FAULTS}': "
        f"ingest.reader.restarts {restarts}, {sum(rows.values())} rows read "
        f"({len(rows)} distinct; the file's {len(local_rows)}) [{power}]")
    if restarts < 1 or set(rows) != set(local_rows):
        raise RuntimeError("[ingest] the reader fault was not survived "
                           "with every row")


def _ingest_tuning(torch, power: str, data: str, train_file: str) -> None:
    """Step 6: serve_ingest with DMLC_AUTOTUNE=1 and a temporary tuned
    file, connections until the tuner converges (at least 4); then the
    loader's steady state in turns: FM flat per step with the v2 and the
    v3 wire, put_threads 1 and 2, and FusedTrainer(k=8) with each
    wire."""
    import socket as _socket

    from dmlc_core_tpu_torch import (DeviceLoader, FusedTrainer, adam,
                                     create_parser, make_train_step)
    from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader, serve_ingest
    from dmlc_core_tpu_torch.utils.metrics import metrics
    tuned_file = os.path.join(data, "tuned.json")
    with _env(DMLC_AUTOTUNE="1", DMLC_TUNED_CONFIG=tuned_file):
        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        ready = threading.Event()
        e0 = metrics.counter("autotune.epochs").value
        threading.Thread(target=serve_ingest, args=(
            train_file, 0, 1, "libsvm"), kwargs=dict(
                batch_rows=ROWS_TR, nnz_cap=CAP_TR, port=port,
                host="127.0.0.1", id_mod=F_FEATURES,
                max_epochs=TUNE_MAX_CONNECTIONS, ready_event=ready),
            daemon=True).start()
        if not ready.wait(timeout=60):
            raise RuntimeError("[ingest] the tuning worker never listened")
        served = 0
        t0 = time.monotonic()
        while served < TUNE_MAX_CONNECTIONS:
            with RemoteIngestLoader([("127.0.0.1", port)], ROWS_TR,
                                    emit="host", device="cuda") as ld:
                for _, buf, _, _ in ld:
                    ld.recycle(buf)
            served += 1
            deadline = time.monotonic() + 10
            while (metrics.counter("autotune.epochs").value - e0 < served
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            if served >= 4 and metrics.gauge("autotune.converged").value:
                break
        epochs = metrics.counter("autotune.epochs").value - e0
        with open(tuned_file) as f:
            entries = json.load(f).get("autotune", {})
    knobs = {k: metrics.gauge(f"autotune.knob.{k}").value
             for k in ("parser_threads", "prefetch")}
    log(f"[ingest] serve_ingest autotune: {served} connections in "
        f"{time.monotonic() - t0:.2f} s, autotune.epochs +{epochs}, "
        f"converged {metrics.gauge('autotune.converged').value}, knobs "
        f"{knobs}, persisted {entries} [{power}]")
    if epochs < 4 or not entries:
        raise RuntimeError("[ingest] the ingest autotuner did not advance "
                           "and persist")

    model = _model(torch, "fm", "kernel")
    step = make_train_step(model, adam(model, LR))
    rows = []
    for label, kw in (("v2", dict(wire_compact=False)),
                      ("v3", dict(wire_compact=True)),
                      ("v3", dict(wire_compact=True)),
                      ("v2", dict(wire_compact=False)),
                      ("put_threads 1", dict(put_threads=1)),
                      ("put_threads 2", dict(put_threads=2)),
                      ("put_threads 2", dict(put_threads=2)),
                      ("put_threads 1", dict(put_threads=1))):
        with DeviceLoader(create_parser(train_file), ROWS_TR, CAP_TR,
                          id_mod=F_FEATURES, device="cuda", **kw) as ld:
            st = _steady_state(torch, step, ld, INGEST_EPOCHS)
        rows.append(f"{label}: {st['steps'] / st['wall_s']:.3f} steps/s, "
                    f"wait median {st['wait_median_ms']:.4f} ms, enqueue "
                    f"median {st['enqueue_median_ms']:.4f} ms")
    log(f"[ingest] loader steady state, FM flat per step, {INGEST_EPOCHS} "
        f"epochs each, in turns: " + "; ".join(rows) + f" [{power}]")
    # the k-step trainer, whose feed is the pack thread alone: one warm
    # epoch (the captures), then INGEST_EPOCHS timed
    rows = []
    for compact in (False, True, True, False):
        model = _model(torch, "fm", "kernel")
        with DeviceLoader(create_parser(train_file), ROWS_TR, CAP_TR,
                          id_mod=F_FEATURES, device="cuda", emit="host",
                          wire_compact=compact) as ld:
            trainer = FusedTrainer(model, adam(model, LR), ld, k=KSTEP)
            _fused_epoch(torch, trainer, ld)
            steps0 = trainer.steps
            t0 = time.perf_counter()
            for _ in range(INGEST_EPOCHS):
                ld.before_first()
                _fused_epoch(torch, trainer, ld)
            float(trainer.losses[-1])
            wall = time.perf_counter() - t0
        rows.append(f"{'v3' if compact else 'v2'}: "
                    f"{(trainer.steps - steps0) / wall:.3f} steps/s")
    log(f"[ingest] FusedTrainer(k={KSTEP}) steady state, FM flat, "
        f"{INGEST_EPOCHS} epochs each after a warm one, in turns: "
        + "; ".join(rows) + f" [{power}]")


def phase_ingest(torch, timer: Timer, power: str, data: str,
                 train_file: str, eval_file: str) -> dict:
    """[ingest]: disaggregated ingest at full width (FM flat, 2^20 x 32,
    4096-row batches, nnz_cap 131072, Adam 1e-3) on the training text:
    the v3 wire and its decode kernel (step 1), two worker processes'
    union over two epochs (2), training from one worker against the local
    loader, from two, and through FusedTrainer (3), dmlc-train workers=
    (4), a reader fault (5), the autotuner and the loader's steady state
    (6).  Returns ``{"launches", "kernel"}``: the launch counts of the
    training from workers, and the wire_decode row."""
    t0 = time.monotonic()
    raw_file = os.path.join(data, "raw.libsvm")
    _write_raw_values(raw_file, RAW_ROWS, SEED + 12)
    kernel = _ingest_wire(torch, timer, power, train_file, raw_file)
    env = _cli_env()
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    with DeviceLoader(create_parser(train_file), ROWS_TR, CAP_TR,
                      id_mod=F_FEATURES, device="cuda") as ld:
        local_rows = _rows_of(ld)
    one = _Workers(train_file, 1, env)
    two = None
    try:
        two = _Workers(train_file, INGEST_PARTS, env)
        one.wait()
        two.wait()
        from dmlc_core_tpu_torch.pipeline import RemoteIngestLoader
        with RemoteIngestLoader(two.addresses, ROWS_TR,
                                device="cuda") as ld:
            for epoch in range(INGEST_EPOCHS):
                if epoch:
                    ld.before_first()
                rows = _rows_of(ld)
                if rows != local_rows:
                    raise RuntimeError(f"[ingest] epoch {epoch} from "
                                       f"{INGEST_PARTS} workers: "
                                       f"{sum(rows.values())} rows, not the "
                                       f"local loader's multiset")
        log(f"[ingest] {INGEST_PARTS} worker processes, {INGEST_EPOCHS} "
            f"epochs: each epoch's multiset of {sum(local_rows.values())} "
            f"rows equals the local loader's [{power}]")
        launches = _ingest_train_pair(torch, power, one, train_file,
                                      eval_file)
        for k, v in _ingest_train_two(torch, power, two, eval_file).items():
            launches[k] = launches.get(k, 0) + v
        log(f"[ingest] kernel launches of the training from workers: "
            f"{launches}")
        _ingest_cli(torch, power, two, data, train_file, eval_file)
        _ingest_fault(torch, power, two, local_rows)
    finally:
        one.stop()
        if two is not None:
            two.stop()
    _ingest_tuning(torch, power, data, train_file)
    log(f"[ingest] phase {time.monotonic() - t0:.1f} s [{power}]")
    return {"launches": launches, "kernel": kernel}


# -- phase 5 ----------------------------------------------------------------

TRAIN_PATHS = (            # (name, model, layout, nnz_cap or k_cap)
    ("dcn_rowmajor", "dcn", "rowmajor", K_TR),
    ("dcn_flat", "dcn", "flat", CAP_TR),
    ("fm_flat", "fm", "flat", CAP_TR),
    ("deepfm_rowmajor", "deepfm", "rowmajor", K_TR),
    ("deepfm_flat", "deepfm", "flat", CAP_TR),
    ("fm_rowmajor", "fm", "rowmajor", K_TR),
)


def _planted():
    """The planted linear model every data file's labels come from:
    HOT_IDS ids below 1,000,000 with N(0, 1) weights, from a seed of
    their own (the same for every file)."""
    rng = np.random.default_rng(SEED + 99)
    hot = rng.choice(1_000_000, size=HOT_IDS, replace=False)
    return hot, rng.standard_normal(HOT_IDS)


def _write_libsvm(path: str, rows: int, seed: int,
                  libfm: bool = False) -> None:
    """Seeded libsvm text in the shape of benchmarks/bench_suite.py's
    _gen_libsvm: 5-39 sorted distinct ids below 1,000,000 per row,
    values U[0,1).  Every row carries 2-4 of the planted model's hot ids
    among them; its label is 1 where the planted score (the sum of value
    times weight over its hot ids) lies above the file's median, so the
    classes are balanced and a model that learns ranks the eval rows.
    With ``libfm`` the same rows as libfm text, id j in field j % 40
    (``_gen_libsvm(libfm=True)``)."""
    rng = np.random.default_rng(seed)
    hot, w = _planted()
    lines, scores = [], np.empty(rows)
    for i in range(rows):
        n = int(rng.integers(5, 40))
        k = int(rng.integers(2, 5))
        which = rng.choice(HOT_IDS, size=k, replace=False)
        rest = rng.choice(1_000_000, size=n + k, replace=False)
        rest = rest[~np.isin(rest, hot)][:n - k]
        idx = np.concatenate([hot[which], rest])
        vals = rng.random(n)
        scores[i] = float(vals[:k] @ w[which])
        order = np.argsort(idx)
        pairs = zip(idx[order].tolist(), vals[order].tolist())
        lines.append(b" ".join(
            b"%d:%d:%.4f" % (j % NF_FFM, j, v) if libfm else
            b"%d:%.4f" % (j, v) for j, v in pairs))
    labels = scores > np.median(scores)
    with open(path, "wb") as f:
        f.write(b"".join(b"%d %s\n" % (y, ln)
                         for y, ln in zip(labels.tolist(), lines)))


def _model(torch, kind: str, engine: str):
    from dmlc_core_tpu_torch import (DCNv2, DeepFM, FactorizationMachine,
                                     FieldAwareFM, SparseLogReg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if kind == "ffm":
        return FieldAwareFM(F_FFM, NF_FFM, DIM_FFM, engine=engine,
                            device="cuda", generator=gen)
    if kind == "logreg":
        return SparseLogReg(F_FEATURES, engine=engine, device="cuda")
    if kind == "dcn":
        return DCNv2(F_FEATURES, DIM, LAYERS, engine=engine, device="cuda",
                     generator=gen)
    if kind == "deepfm":
        return DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine=engine,
                      device="cuda", generator=gen)
    return FactorizationMachine(F_FEATURES, DIM, engine=engine,
                                device="cuda", generator=gen)


def _grads(model, batch) -> dict:
    model.zero_grad(set_to_none=True)
    model.loss(batch).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _step_breakdown(torch, model, opt, loader, steps: int = 4) -> dict:
    """Device time of the forward, the backward and the optimizer of a
    few more steps, in CUDA events, and the host's time to enqueue each
    while the feed's threads sit idle.  A spin kernel queued first keeps
    the device busy while the host enqueues the step, so the events time
    device work (the batch's wait is read in steady state instead)."""
    fwd, bwd, optm, busy, enq, spin_ok = [], [], [], [], [], True
    loader.before_first()
    batches = [loader.next_batch() for _ in range(steps)]
    # let the pack thread run to the end of the epoch first: a python
    # pack (row-major) holds the interpreter lock and would stretch the
    # host's enqueue past the spin
    time.sleep(1.0)
    for batch in batches:
        opt.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t2 = time.perf_counter()
        loss = model.loss(batch)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        t_enq = (time.perf_counter() - t2) * 1e3
        torch.cuda.synchronize()
        spin_ok &= ev[0].elapsed_time(ev[1]) > t_enq
        enq.append(t_enq)
        fwd.append(ev[1].elapsed_time(ev[2]))
        bwd.append(ev[2].elapsed_time(ev[3]))
        optm.append(ev[3].elapsed_time(ev[4]))
        busy.append(ev[1].elapsed_time(ev[4]))
    if not spin_ok:
        raise RuntimeError("the spin kernel ended before the host had "
                           "enqueued the step; raise SPIN_CYCLES")
    return {k: float(np.median(v)) for k, v in (
        ("forward_ms", fwd), ("backward_ms", bwd), ("optimizer_ms", optm),
        ("device_ms", busy), ("enqueue_idle_ms", enq))}


def _steady_state(torch, step, loader, epochs: int) -> dict:
    """``epochs`` passes over the training file (``before_first`` between
    them), one step a batch, as fast as the feed allows: steps/s on the
    host clock from the first batch request to the last loss read back,
    the consumer's wait in ``next_batch`` per step, and the host time to
    enqueue a step."""
    waits, enqueue, last = [], [], None
    loader.before_first()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        if epoch:
            loader.before_first()
        while True:
            a = time.perf_counter()
            batch = loader.next_batch()
            b = time.perf_counter()
            if batch is None:
                break
            last = step(batch)
            enqueue.append((time.perf_counter() - b) * 1e3)
            waits.append((b - a) * 1e3)
    float(last)
    wall = time.perf_counter() - t0
    return {"steps": len(waits), "wall_s": wall,
            "wait_median_ms": float(np.median(waits)),
            "wait_mean_ms": float(np.mean(waits)),
            "wait_max_ms": float(np.max(waits)),
            "enqueue_median_ms": float(np.median(enqueue))}


def _eval_scores(torch, model, loader):
    """Each real eval row's score (float64) and label, in file order."""
    scores, labels = [], []
    with torch.no_grad():
        for batch in loader:
            keep = batch["weights"] > 0
            scores.append(model(batch)[keep])
            labels.append(batch["labels"][keep])
    return (torch.cat(scores).double().cpu().numpy(),
            torch.cat(labels).cpu().numpy())


def _auc(score: np.ndarray, label: np.ndarray) -> float:
    """ROC-AUC of ``score`` against ``label > 0`` by the rank sum."""
    ranks = np.empty(len(score))
    ranks[np.argsort(score, kind="stable")] = np.arange(1, len(score) + 1)
    pos = label > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / max(n_pos * n_neg, 1))


# phase 5's checks of the kernel path against the plain path; a reading
# beyond its limit fails the path (see _train_checks)
GRAD_SCALED_TOL = 1e-4     # max|err| over max|g_plain|, each parameter
LOSS_DRIFT_TOL = 0.1       # max|loss diff| over how far the losses moved
PARAM_TOL = 1e-3           # ||p_kernel - p_plain|| over ||p_plain - p_init||
# the kernel run's eval AUC of each row's change in score over the 8
# steps (trained minus initial) must reach this: it reads about 0.5
# (+-0.006, one standard deviation over 8192 rows) for a run that does
# not learn (a broken backward or optimizer), and read 0.867-0.871 on
# the six paths on an NVIDIA H100 80GB HBM3 at 700 W
LEARN_AUC_MIN = 0.75


def _train_checks(torch, g_kernel, g_plain, lk, lp, ev_kernel,
                  ev_plain, model, plain, p_init, learn_auc) -> list:
    """Every check of the kernel path, as ``(check, reading, limit, ok)``
    rows.  A check must be able to fail on a fault as small as the
    thing it compares: gradients are also held against each parameter's
    own scale, the losses against how far they moved, and the trained
    parameters against how far they moved.  The last row is the kernel
    run's learning: the eval AUC of the change in score."""
    rows = []
    # one step's gradients, elementwise (rtol = atol = 1e-5)
    worst = max(g_plain, key=lambda k: float(
        (g_kernel[k] - g_plain[k]).abs().max()))
    err = float((g_kernel[worst] - g_plain[worst]).abs().max())
    ok = all(torch.allclose(g_kernel[k], g_plain[k], rtol=RTOL, atol=ATOL)
             for k in g_plain)
    rows.append((f"gradients max|err| ({worst})", err, ATOL, ok))
    # ... and against each parameter's own scale
    ratios = {k: float((g_kernel[k] - g_plain[k]).abs().max())
              / max(float(g_plain[k].abs().max()), 1e-30) for k in g_plain}
    worst = max(ratios, key=ratios.get)
    rows.append((f"gradients max|err|/max|g| ({worst})", ratios[worst],
                 GRAD_SCALED_TOL, ratios[worst] <= GRAD_SCALED_TOL))
    # 8 losses, relative, and against the drift of the plain losses
    fin = bool(np.isfinite(lk).all())
    rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    rows.append(("losses max rel err", rel, 1e-4, fin and rel <= 1e-4))
    drift = float(np.max(np.abs(lp - lp[0])))
    share = float(np.max(np.abs(lk - lp))) / max(drift, 1e-30)
    rows.append((f"losses max|diff|/drift (drift {drift:.3g})", share,
                 LOSS_DRIFT_TOL, fin and share <= LOSS_DRIFT_TOL))
    # the trained parameters, each against how far it moved
    ratios = {}
    for k, p in plain.named_parameters():
        moved = float((p.detach() - p_init[k]).norm())
        diff = float((dict(model.named_parameters())[k].detach()
                      - p.detach()).norm())
        ratios[k] = diff / max(moved, 1e-30)
    worst = max(ratios, key=ratios.get)
    rows.append((f"parameters ||k-p||/||p-p0|| ({worst})", ratios[worst],
                 PARAM_TOL, ratios[worst] <= PARAM_TOL))
    # eval: accuracy within one row, AUC within 1e-4, every row evaluated
    acc_rows = abs(ev_kernel["accuracy"] - ev_plain["accuracy"]) * \
        ev_plain["weight"]
    rows.append(("eval accuracy |diff| in rows", acc_rows, 1.0,
                 acc_rows <= 1.0 + 1e-6
                 and ev_plain["weight"] == EVAL_ROWS
                 and ev_kernel["weight"] == EVAL_ROWS))
    auc = abs(ev_kernel["auc"] - ev_plain["auc"])
    rows.append(("eval auc |diff|", auc, 1e-4, auc <= 1e-4))
    rows.append(("learning: eval auc of the change in score, at least",
                 learn_auc, LEARN_AUC_MIN, learn_auc >= LEARN_AUC_MIN))
    return rows


class PathDeparts(RuntimeError):
    """A training path's kernel run disagrees with its plain run."""


def _train_path(torch, name, kind, layout, cap, train_file, eval_file,
                power) -> dict:
    """One training path on engine='kernel', held against the same
    seeded model on engine='torch', both fed by native loaders (the
    threaded native parser; the native packer on the flat layout; FFM's
    libfm fields through the python packs, hashed into F_FFM).
    Returns the path's launch counts; raises, after logging every
    check's reading, if any check fails."""
    from dmlc_core_tpu_torch import (DeviceLoader, adam, create_parser,
                                     evaluate_stream, make_train_step)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    ffm = kind == "ffm"

    def loader(path):
        return DeviceLoader(
            create_parser(path, parser_type="libfm" if ffm else "libsvm",
                          engine="native"), ROWS_TR, cap, layout=layout,
            device="cuda", engine="native", fields=ffm,
            id_mod=F_FFM if ffm else 0)

    model = _model(torch, kind, "kernel")
    train_ld, eval_ld = loader(train_file), loader(eval_file)
    try:
        opt = adam(model, LR)
        step = make_train_step(model, opt)

        reset_launch_counts()                      # the path starts here
        s_init, y_eval = _eval_scores(torch, model, eval_ld)
        g_kernel = _grads(model, train_ld.next_batch())
        train_ld.before_first()
        batches, losses = [], []
        t0 = time.perf_counter()
        for batch in train_ld:
            batches.append(batch)
            losses.append(step(batch))
        last = float(losses[-1])                   # the host clock stops
        wall = time.perf_counter() - t0
        eval_ld.before_first()
        ev_kernel = evaluate_stream(model, eval_ld)
        eval_ld.before_first()
        s_trained, _ = _eval_scores(torch, model, eval_ld)
        torch.cuda.synchronize()
        launches = launch_counts()                 # the path ends here
        if len(batches) != TRAIN_STEPS:
            raise RuntimeError(f"{name}: {len(batches)} batches, expected "
                               f"{TRAIN_STEPS}")
        shapes = sorted({tuple(b["ids"].shape) for b in batches})
        learn_auc = _auc(s_trained - s_init, y_eval)

        # the same seeded model on the plain path, on the same batches
        plain = _model(torch, kind, "torch")
        p_init = {k: p.detach().clone() for k, p in plain.named_parameters()}
        g_plain = _grads(plain, batches[0])
        p_step = make_train_step(plain, adam(plain, LR, engine="torch"))
        p_losses = [p_step(b) for b in batches]
        lk = torch.stack(losses).cpu().numpy()
        lp = torch.stack(p_losses).cpu().numpy()
        eval_ld.before_first()
        ev_plain = evaluate_stream(plain, eval_ld)
        checks = _train_checks(torch, g_kernel, g_plain, lk, lp, ev_kernel,
                               ev_plain, model, plain, p_init, learn_auc)
        del plain, p_step, batches, p_init, g_kernel, g_plain
        log(f"[train] {name} checks: " + "; ".join(
            f"{c} {r:.3g} (limit {lim:g}{'' if ok else ', FAILED'})"
            for c, r, lim, ok in checks))
        failed = [c for c, _, _, ok in checks if not ok]
        if failed:
            raise PathDeparts(f"{name}: the kernel path fails {failed}")

        stages = _step_breakdown(torch, model, opt, train_ld)
        steady = _steady_state(torch, step, train_ld, STEADY_EPOCHS)
    finally:
        train_ld.close()
        eval_ld.close()
    idle = 1.0 - TRAIN_STEPS * stages["device_ms"] / (wall * 1e3)
    st_rate = steady["steps"] / steady["wall_s"]
    st_idle = 1.0 - steady["steps"] * stages["device_ms"] / (
        steady["wall_s"] * 1e3)
    log(f"[train] {name}: {TRAIN_STEPS} steps of {ROWS_TR} rows in "
        f"{wall:.4f} s: {TRAIN_STEPS / wall:.3f} steps/s, "
        f"{TRAIN_STEPS * ROWS_TR / wall:.1f} rows/s, device idle "
        f"{idle:.4f}; loss {lk[0]:.6f} -> {last:.6f} (plain {lp[-1]:.6f}); "
        f"eval accuracy {ev_kernel['accuracy']:.6f} (plain "
        f"{ev_plain['accuracy']:.6f}), auc {ev_kernel['auc']:.6f} (plain "
        f"{ev_plain['auc']:.6f}), auc of the change in score "
        f"{learn_auc:.6f}; batch ids shapes {shapes} [{power}]")
    log(f"[train] {name} steady state, {STEADY_EPOCHS} epochs "
        f"({steady['steps']} steps): {st_rate:.3f} steps/s, "
        f"{st_rate * ROWS_TR:.1f} rows/s; wait in next_batch median "
        f"{steady['wait_median_ms']:.4f} ms, mean "
        f"{steady['wait_mean_ms']:.4f} ms, max {steady['wait_max_ms']:.4f} "
        f"ms; host enqueue of a step median "
        f"{steady['enqueue_median_ms']:.4f} ms; device busy "
        f"{stages['device_ms']:.4f} ms/step; device idle share "
        f"{st_idle:.4f} [{power}]")
    log(f"[train] {name} per step (device, median of 4): forward "
        f"{stages['forward_ms']:.4f} ms, backward {stages['backward_ms']:.4f}"
        f" ms, optimizer {stages['optimizer_ms']:.4f} ms, busy "
        f"{stages['device_ms']:.4f} ms; host enqueue of the step with the "
        f"feed's threads idle {stages['enqueue_idle_ms']:.4f} ms [{power}]")
    log(f"[train] {name} kernel launches: {launches}")
    return launches


@contextlib.contextmanager
def _data_files():
    """``(directory, train file, eval file)``: seeded libsvm text for
    phases 5 and 6, removed afterwards."""
    data = os.path.join(ROOT, ".chip_smoke_data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    try:
        train_file = os.path.join(data, "train.libsvm")
        eval_file = os.path.join(data, "eval.libsvm")
        _write_libsvm(train_file, TRAIN_STEPS * ROWS_TR, SEED + 10)
        _write_libsvm(eval_file, EVAL_ROWS, SEED + 11)
        yield data, train_file, eval_file
    finally:
        shutil.rmtree(data, ignore_errors=True)


def phase_training(torch, power: str, train_file: str, eval_file: str,
                   planted: bool = False) -> dict:
    """DCNv2 and DeepFM (row-major and flat each) and FM (flat and
    row-major) at full width: 8 Adam steps each through the port's
    parser, loader and train step on the kernels, against the plain
    path.  Returns the launch counts summed over the six paths; with
    ``planted`` (a fault planted on the kernel path), ``{path: True if
    its checks caught the fault}`` instead."""
    total: dict = {}
    caught: dict = {}
    for name, kind, layout, cap in TRAIN_PATHS:
        try:
            launches = _train_path(torch, name, kind, layout, cap,
                                   train_file, eval_file, power)
            caught[name] = False
        except PathDeparts as e:
            if not planted:
                raise
            log(f"[plant] {name}: caught: {e}")
            caught[name] = True
            continue
        finally:
            torch.cuda.empty_cache()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return caught if planted else total


# -- phase 5a: the field-aware FM ---------------------------------------------

FFM_PATHS = (("ffm_flat", "flat", CAP_TR), ("ffm_rowmajor", "rowmajor", K_TR))


def _libfm_files(data: str):
    """``(train, eval)``: phase 5's rows as libfm text (fields j % 40),
    written once into ``data``."""
    train_file = os.path.join(data, "train.libfm")
    eval_file = os.path.join(data, "eval.libfm")
    if not os.path.exists(eval_file):
        _write_libsvm(train_file, TRAIN_STEPS * ROWS_TR, SEED + 10,
                      libfm=True)
        _write_libsvm(eval_file, EVAL_ROWS, SEED + 11, libfm=True)
    return train_file, eval_file


def _ffm_split(torch, timer: Timer, power: str, name: str, layout: str,
               cap: int, train_file: str) -> dict:
    """The forward's two parts on one training batch, each timed alone on
    the device: the bucket sum G (the ragged-gather kernel at D = 160)
    and the cross term (G against its transpose, plain PyTorch)."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    from dmlc_core_tpu_torch.ops.csr import csr_embed_sum
    nf = NF_FFM
    with DeviceLoader(create_parser(train_file, parser_type="libfm",
                                    engine="native"), ROWS_TR, cap,
                      layout=layout, device="cuda", fields=True,
                      id_mod=F_FFM) as ld:
        batch = ld.next_batch()
    f = batch["fields"].clamp(0, nf - 1).int()
    if layout == "rowmajor":
        rows = torch.arange(ROWS_TR, dtype=torch.int32, device="cuda")
        seg = (rows[:, None] * nf + f).reshape(-1)
        ids, vals = batch["ids"].reshape(-1), batch["vals"].reshape(-1)
    else:
        seg, ids, vals = batch["segments"] * nf + f, batch["ids"], \
            batch["vals"]
    table = _model(torch, "ffm", "kernel").v.detach().view(F_FFM, -1)
    with torch.no_grad():
        g_fwd = lambda: csr_embed_sum(  # noqa: E731
            ids, vals, seg, table, ROWS_TR * nf, engine="kernel")
        G = g_fwd().view(ROWS_TR, nf, nf, DIM_FFM)
        cross = lambda: (G * G.transpose(1, 2)).sum(dim=(1, 2, 3))  # noqa
        out = {"g_forward_ms": timer.ms(g_fwd), "cross_ms": timer.ms(cross)}
    log(f"[ffm] {name} forward parts (device, one batch of {ROWS_TR} rows, "
        f"ids {tuple(batch['ids'].shape)}): G {out['g_forward_ms']:.4f} ms,"
        f" cross {out['cross_ms']:.4f} ms [{power}]")
    return out


def phase_ffm(torch, timer: Timer, power: str, data: str) -> dict:
    """FieldAwareFM(2^18, 40 fields, dim 4) on phase 5's rows as libfm
    text, through DeviceLoader(fields=True): 8 Adam steps on the flat
    layout and 8 on the row-major (k_cap 64), each held against the
    plain path and the planted model as phase 5 holds its paths, with
    the forward's G and cross timed apart.  Returns the launch counts
    summed over both paths."""
    train_file, eval_file = _libfm_files(data)
    total: dict = {}
    for name, layout, cap in FFM_PATHS:
        try:
            launches = _train_path(torch, name, "ffm", layout, cap,
                                   train_file, eval_file, power)
            _ffm_split(torch, timer, power, name, layout, cap, train_file)
        finally:
            torch.cuda.empty_cache()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


# -- phase 5b: the k-step trainer ---------------------------------------------

KSTEP = 8                  # one epoch of the training file is one group
KSTEP_PARTIAL = 3          # groups of 3, 3 and 2: a partial-group graph
KSTEP_PATHS = (            # (name, model, optimizer)
    ("dcn_flat_kstep", "dcn", "adam"),
    ("deepfm_flat_kstep", "deepfm", "adam"),
    ("fm_flat_kstep", "fm", "adam"),
    ("logreg_flat_ftrl_kstep", "logreg", "ftrl"),
)


def _optimizer(kind: str, model, engine: str):
    from dmlc_core_tpu_torch import FTRL, Adam
    if kind == "ftrl":
        return FTRL(model.parameters(), engine=engine, **FTRL_ARGS)
    return Adam(model.parameters(), lr=LR, engine=engine)


def _fused_epoch(torch, trainer, loader) -> list:
    """One pass of a host-emitting loader through ``trainer``: every
    dispatch's losses, in order (a copy each, on the device)."""
    losses, steps = [], trainer.steps
    for item in loader:
        trainer.feed(item)
        if trainer.steps != steps:
            losses.append(trainer.losses)
            steps = trainer.steps
    trainer.flush()
    if trainer.steps != steps:
        losses.append(trainer.losses)
    return losses


def _kstep_path(torch, name, kind, opt_kind, train_file, eval_file,
                power) -> dict:
    """One flat path through DeviceLoader(emit="host") and FusedTrainer:
    k = 8 (the epoch's 8 batches, one replay) held against the same seeded
    model on the plain path, eager and per step, with _train_checks'
    limits; k = 3 (groups 3, 3, 2) held against the same plain run; then
    the steady state over STEADY_EPOCHS with k = 8.  Returns the launch
    counts of the k = 8 run."""
    from dmlc_core_tpu_torch import (DeviceLoader, FusedTrainer,
                                     create_parser, evaluate_stream,
                                     make_train_step)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts

    def loader(path, emit="device"):
        return DeviceLoader(create_parser(path, engine="native"), ROWS_TR,
                            CAP_TR, device="cuda", engine="native",
                            emit=emit)

    model = _model(torch, kind, "kernel")
    opt = _optimizer(opt_kind, model, "kernel")
    train_ld, eval_ld = loader(train_file), loader(eval_file)
    host_ld = loader(train_file, emit="host")
    try:
        reset_launch_counts()                      # the path starts here
        s_init, y_eval = _eval_scores(torch, model, eval_ld)
        g_kernel = _grads(model, train_ld.next_batch())
        model.zero_grad(set_to_none=True)
        trainer = FusedTrainer(model, opt, host_ld, k=KSTEP)
        t0 = time.perf_counter()
        lk = torch.cat(_fused_epoch(torch, trainer, host_ld))
        last = float(lk[-1])                       # the host clock stops
        wall = time.perf_counter() - t0
        eval_ld.before_first()
        ev_kernel = evaluate_stream(model, eval_ld)
        eval_ld.before_first()
        s_trained, _ = _eval_scores(torch, model, eval_ld)
        torch.cuda.synchronize()
        launches = launch_counts()                 # the path ends here
        graphs = {key: fn for key, fn in trainer._kstep_cache.items()}
        if trainer.steps != TRAIN_STEPS or [kk for _, kk in graphs] != [
                KSTEP]:
            raise RuntimeError(f"{name}: {trainer.steps} steps in graphs "
                               f"{sorted(graphs)}; expected one graph of "
                               f"{KSTEP}")
        capture_s = sum(fn.capture_s for fn in graphs.values())
        learn_auc = _auc(s_trained - s_init, y_eval)

        # the same seeded model on the plain path, eager, one step a batch
        train_ld.before_first()
        batches = list(train_ld)
        plain = _model(torch, kind, "torch")
        p_init = {k: p.detach().clone() for k, p in plain.named_parameters()}
        g_plain = _grads(plain, batches[0])
        p_step = make_train_step(plain, _optimizer(opt_kind, plain, "torch"))
        lp = torch.stack([p_step(b) for b in batches]).cpu().numpy()
        eval_ld.before_first()
        ev_plain = evaluate_stream(plain, eval_ld)
        lk = lk.cpu().numpy()
        checks = _train_checks(torch, g_kernel, g_plain, lk, lp, ev_kernel,
                               ev_plain, model, plain, p_init, learn_auc)

        # k = 3: partial groups, from the same seeded start
        part = _model(torch, kind, "kernel")
        tr3 = FusedTrainer(part, _optimizer(opt_kind, part, "kernel"),
                           host_ld, k=KSTEP_PARTIAL)
        host_ld.before_first()
        l3 = torch.cat(_fused_epoch(torch, tr3, host_ld)).cpu().numpy()
        sizes3 = sorted(kk for _, kk in tr3._kstep_cache)
        rel3 = float(np.max(np.abs(l3 - lp) / np.abs(lp)))
        ratios = {}
        for k, p in plain.named_parameters():
            moved = float((p.detach() - p_init[k]).norm())
            diff = float((dict(part.named_parameters())[k].detach()
                          - p.detach()).norm())
            ratios[k] = diff / max(moved, 1e-30)
        worst = max(ratios, key=ratios.get)
        checks += [
            (f"k={KSTEP_PARTIAL}: graphs of {sizes3} steps, losses max rel "
             "err", rel3, 1e-4, tr3.steps == TRAIN_STEPS and sizes3 == [
                 KSTEP_PARTIAL - 1, KSTEP_PARTIAL] and rel3 <= 1e-4),
            (f"k={KSTEP_PARTIAL}: parameters ||k-p||/||p-p0|| ({worst})",
             ratios[worst], PARAM_TOL, ratios[worst] <= PARAM_TOL)]
        del plain, p_step, batches, p_init, g_kernel, g_plain, part, tr3
        log(f"[kstep] {name} checks: " + "; ".join(
            f"{c} {r:.3g} (limit {lim:g}{'' if ok else ', FAILED'})"
            for c, r, lim, ok in checks))
        failed = [c for c, _, _, ok in checks if not ok]
        if failed:
            raise PathDeparts(f"{name}: the k-step path fails {failed}")

        # steady state: STEADY_EPOCHS passes, k = 8, the host's time in
        # each dispatch (stack, copy, replay and the losses' copy enqueued)
        flush = trainer._flush_group
        host = []

        def timed_flush():
            if trainer._group:
                a = time.perf_counter()
                flush()
                host.append(time.perf_counter() - a)
        trainer._flush_group = timed_flush
        steps0 = trainer.steps
        t0 = time.perf_counter()
        for _ in range(STEADY_EPOCHS):
            host_ld.before_first()
            _fused_epoch(torch, trainer, host_ld)
        float(trainer.losses[-1])
        st_wall = time.perf_counter() - t0
        st_steps = trainer.steps - steps0
        trainer._flush_group = flush
        # the device's time of one replay (8 steps), behind a spin kernel
        fn = next(iter(graphs.values()))
        dev_ms = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(SPIN_CYCLES)
            ev[1].record()
            fn.run()
            ev[2].record()
            torch.cuda.synchronize()
            dev_ms.append(ev[1].elapsed_time(ev[2]))
    finally:
        train_ld.close()
        eval_ld.close()
        host_ld.close()
    step_ms = float(np.median(dev_ms)) / KSTEP
    run_s = wall - capture_s
    idle = 1.0 - TRAIN_STEPS * step_ms / (run_s * 1e3)
    st_rate = st_steps / st_wall
    st_idle = 1.0 - st_steps * step_ms / (st_wall * 1e3)
    per_graph = {kk: dict(fn.launches) for (_, kk), fn in graphs.items()}
    log(f"[kstep] {name}: {TRAIN_STEPS} steps of {ROWS_TR} rows in "
        f"{wall:.4f} s of which capture {capture_s:.4f} s: "
        f"{TRAIN_STEPS / wall:.3f} steps/s with the capture, "
        f"{TRAIN_STEPS / run_s:.3f} without it, device idle {idle:.4f} "
        f"without it; loss {lk[0]:.6f} -> {last:.6f} (plain {lp[-1]:.6f}); "
        f"eval auc {ev_kernel['auc']:.6f} (plain {ev_plain['auc']:.6f}), "
        f"auc of the change in score {learn_auc:.6f}; launches of one "
        f"replay {per_graph} [{power}]")
    log(f"[kstep] {name} steady state, {STEADY_EPOCHS} epochs ({st_steps} "
        f"steps, {len(host)} dispatches): {st_rate:.3f} steps/s, "
        f"{st_rate * ROWS_TR:.1f} rows/s; host time a dispatch median "
        f"{np.median(host) * 1e3:.4f} ms, a step "
        f"{np.median(host) * 1e3 / KSTEP:.4f} ms; device "
        f"{step_ms:.4f} ms/step (one replay {np.median(dev_ms):.4f} ms, "
        f"CUDA events); device idle share {st_idle:.4f} [{power}]")
    log(f"[kstep] {name} kernel launches: {launches}")
    return launches


def phase_kstep(torch, power: str, train_file: str, eval_file: str) -> dict:
    """The k-step trainer on the card: DCNv2, DeepFM and FM flat with
    Adam, and SparseLogReg flat with FTRL, at full width, each as one
    replayed CUDA graph an epoch.  Returns the launch counts summed over
    the four paths."""
    total: dict = {}
    for name, kind, opt_kind in KSTEP_PATHS:
        try:
            launches = _kstep_path(torch, name, kind, opt_kind, train_file,
                                   eval_file, power)
        finally:
            torch.cuda.empty_cache()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


# -- [mesh]: data-parallel training over a process mesh -----------------------

MESH_PATHS = (             # (name, model, layout, nnz_cap or k_cap)
    ("fm_flat", "fm", "flat", CAP_TR),
    ("dcn_flat", "dcn", "flat", CAP_TR),
    ("deepfm_rowmajor", "deepfm", "rowmajor", K_TR),
    ("dcn_rowmajor", "dcn", "rowmajor", K_TR),    # the embed bag's path
)
MESH_WORLD = 2             # [mesh] (b): gloo ranks, both on cuda:0
MESH_TIMEOUT = 300         # s: any collective of a rank, and the ranks' run
ALLREDUCE_REPS = 5         # all-reduces of a step's gradient bytes, timed
# every kernel of the [mesh] paths (the flat ones decode the v3 wire)
MESH_KERNELS = ("ragged_gather_fm", "ragged_gather_embed",
                "ragged_gather_grad_fm", "ragged_gather_grad_embed",
                "fm_terms", "fm_terms_grad", "embed_bag", "embed_bag_grad",
                "adam", "wire_decode")


class _Recorder:
    """A dp rank's loader that keeps every batch it hands over (on the
    card), for the references run on the same batches."""

    def __init__(self, loader):
        self.inner, self.seen = loader, []
        self.emit, self.layout = loader.emit, loader.layout
        self.sharding, self.batch_rows = loader.sharding, loader.batch_rows

    def __iter__(self):
        for b in self.inner:
            self.seen.append(b)
            yield b

    def before_first(self):
        self.inner.before_first()


def _mesh_loader(path, layout, cap, rows, mesh, part=0, parts=1):
    """The native loader of partition ``part`` of ``parts``; with a mesh,
    sharded to its rank."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    from dmlc_core_tpu_torch.models import batch_sharding
    return DeviceLoader(
        create_parser(path, part, parts, "libsvm", engine="native"), rows,
        cap, layout=layout, engine="native",
        sharding=batch_sharding(mesh) if mesh is not None else None,
        device=None if mesh is not None else "cuda")


def _flat_params(torch, model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _agree(torch, lk, lp, model, ref, p_init) -> list:
    """Phase 5's loss and parameter checks of a run against a reference
    on the same batches, as ``(check, reading, limit, ok)`` rows; the
    runs' parameters as modules or as ``{name: whole tensor}`` (a
    sharded model's, gathered)."""
    fin = bool(np.isfinite(lk).all())
    rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    drift = float(np.max(np.abs(lp - lp[0])))
    share = float(np.max(np.abs(lk - lp))) / max(drift, 1e-30)
    ratios = {}
    got = model if isinstance(model, dict) else dict(model.named_parameters())
    want = ref if isinstance(ref, dict) else dict(ref.named_parameters())
    for k, p in want.items():
        moved = float((p.detach() - p_init[k]).norm())
        ratios[k] = float((got[k].detach() - p.detach()).norm()) / max(
            moved, 1e-30)
    worst = max(ratios, key=ratios.get)
    return [("losses max rel err", rel, 1e-4, fin and rel <= 1e-4),
            (f"losses max|diff|/drift (drift {drift:.3g})", share,
             LOSS_DRIFT_TOL, fin and share <= LOSS_DRIFT_TOL),
            (f"parameters ||a-b||/||b-b0|| ({worst})", ratios[worst],
             PARAM_TOL, ratios[worst] <= PARAM_TOL)]


def _checked(tag: str, rows: list, phase: str = "[mesh]") -> None:
    log(f"{phase} {tag} checks: " + "; ".join(
        f"{c} {r:.3g} (limit {lim:g}{'' if ok else ', FAILED'})"
        for c, r, lim, ok in rows))
    failed = [c for c, _, _, ok in rows if not ok]
    if failed:
        raise RuntimeError(f"{phase} {tag} fails {failed}")


def _same_shapes(torch, batches) -> list:
    """Flat batches padded to one nnz (padding: id 0, value 0, the
    scratch row), so that k of them stack for the k-step call."""
    if batches[0]["ids"].dim() == 2:
        return batches
    nnz = max(int(b["ids"].shape[0]) for b in batches)
    out = []
    for b in batches:
        pad = nnz - int(b["ids"].shape[0])
        rows = int(b["labels"].shape[0])
        out.append({**b,
                    "ids": _pad(torch, b["ids"], pad, 0),
                    "vals": _pad(torch, b["vals"], pad, 0),
                    "segments": _pad(torch, b["segments"], pad, rows)})
    return out


def _pad(torch, t, n: int, value):
    """``t`` with ``n`` more entries of ``value``."""
    return torch.cat([t, torch.full((n,), value, dtype=t.dtype,
                                    device=t.device)])


def _union(torch, batches: list) -> dict:
    """One process's batch of the ranks' batches of one step: rows in
    rank order, each flat batch's live entries in rank order, then the
    padding (on the union's scratch row)."""
    if batches[0]["ids"].dim() == 2:
        return {k: torch.cat([b[k] for b in batches])
                for k in ("ids", "vals", "labels", "weights")}
    rows = sum(int(b["labels"].shape[0]) for b in batches)
    ids, vals, segs, rps, pads, at, nnz = [], [], [], [], [], 0, 0
    for b in batches:
        n = int(b["row_ptr"][-1])
        ids.append(b["ids"][:n])
        vals.append(b["vals"][:n])
        segs.append(b["segments"][:n] + at)
        rps.append(b["row_ptr"][1:] + nnz)
        pads.append(int(b["ids"].shape[0]) - n)
        at += int(b["labels"].shape[0])
        nnz += n
    pad = sum(pads)
    dev = batches[0]["ids"].device
    return {"ids": _pad(torch, torch.cat(ids), pad, 0),
            "vals": _pad(torch, torch.cat(vals), pad, 0),
            "segments": _pad(torch, torch.cat(segs), pad, rows),
            "row_ptr": torch.cat([torch.zeros(1, dtype=torch.int32,
                                              device=dev)] + rps),
            "labels": torch.cat([b["labels"] for b in batches]),
            "weights": torch.cat([b["weights"] for b in batches])}


def _collectives_check(torch, mesh) -> dict:
    """Every collective of the port over ``mesh`` on card tensors,
    against numpy; ``{"lacks": why}`` where the backend has none."""
    from dmlc_core_tpu_torch.parallel import MeshCollectives, reduce_scatter
    from dmlc_core_tpu_torch.utils import DMLCError
    W, r = mesh.world, mesh.rank
    per = np.random.default_rng(SEED + 7).standard_normal(
        (W, W, 16)).astype(np.float32)        # per[r]: rank r's block
    coll = MeshCollectives(mesh)
    x = torch.from_numpy(per[r]).to(mesh.device)
    cases = {
        "allreduce_sum": (lambda: coll.allreduce(x), per.sum(0)),
        "allreduce_max": (lambda: coll.allreduce(x, "max"), per.max(0)),
        "allreduce_min": (lambda: coll.allreduce(x, "min"), per.min(0)),
        "broadcast": (lambda: coll.broadcast(x, root=W - 1), per[W - 1]),
        "allgather": (lambda: coll.allgather(x), per),
        "reduce_scatter": (lambda: reduce_scatter(x, mesh),
                           per.sum(0)[r:r + 1]),
        "all_to_all": (lambda: coll.all_to_all(x), per[:, r]),
    }
    out = {}
    for name, (fn, want) in cases.items():
        try:
            got = fn().cpu().numpy()
        except DMLCError as e:
            out[name] = {"lacks": str(e)}
            continue
        out[name] = {"max_abs_err": float(np.abs(got - want).max()),
                     "ok": bool(got.shape == want.shape and np.allclose(
                         got, want, rtol=1e-6, atol=1e-6))}
    return out


def _allreduce_ms(torch, mesh, elements: int) -> float:
    """Median ms of an all-reduce of ``elements`` float32 on the card
    (a step's gradients and loss), host clock around a synchronize."""
    import torch.distributed as dist
    buf = torch.ones(elements, device=mesh.device)
    dist.all_reduce(buf, group=mesh.group())
    times = []
    for _ in range(ALLREDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _dp_run(torch, mesh, kind, layout, cap, rows, path, part, parts):
    """fit_stream(mesh=) of a seeded kernel model over its partition of
    ``path``: ``(model, initial parameters, batches, losses, wall s,
    launches)``."""
    from dmlc_core_tpu_torch import adam, fit_stream
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    model = _model(torch, kind, "kernel")
    p_init = {k: p.detach().clone() for k, p in model.named_parameters()}
    with _mesh_loader(path, layout, cap, rows, mesh, part, parts) as ld:
        rec = _Recorder(ld)
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = fit_stream(model, rec, optimizer=adam(model, LR), mesh=mesh,
                          log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    return model, p_init, rec.seen, np.array(hist), wall, launches


def _ref_run(torch, kind, engine, batches, mesh=None):
    """The same seeded model stepped over ``batches`` by make_train_step
    (with ``mesh`` or none): ``(model, losses)``."""
    from dmlc_core_tpu_torch import adam, make_train_step
    ref = _model(torch, kind, engine)
    step = make_train_step(ref, adam(ref, LR, engine=engine), mesh)
    losses = torch.stack([step(b) for b in batches]).cpu().numpy()
    return ref, losses


def _grad_bytes(model) -> int:
    """Bytes of a dp step's gradient all-reduce: every gradient and the
    loss, float32."""
    return (sum(p.numel() for p in model.parameters()) + 1) * 4


def _add(total: dict, launches: dict) -> dict:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n
    return total


def _mesh_world1_path(torch, power, mesh, name, kind, layout, cap,
                      train_file, eval_file) -> dict:
    """[mesh] (a), one path: fit_stream over a world-1 NCCL mesh against
    the no-mesh path (the kernels: phase 5's limits, their atomics order
    varying from run to run; the plain path with deterministic
    algorithms: array_equal), the captured k-step mesh form against the
    mesh steps, and evaluate_stream with and without the mesh."""
    from dmlc_core_tpu_torch import adam, evaluate_stream, fit_stream
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.models import (make_train_step_kbatch,
                                            stack_batches)
    model, p_init, batches, lk, wall, launches = _dp_run(
        torch, mesh, kind, layout, cap, ROWS_TR, train_file, 0, 1)
    if len(batches) != TRAIN_STEPS:
        raise RuntimeError(f"[mesh] {name}: {len(batches)} batches, "
                           f"expected {TRAIN_STEPS}")
    ref, lp = _ref_run(torch, kind, "kernel", batches)
    ref2, _ = _ref_run(torch, kind, "kernel", batches)
    rows = _agree(torch, lk, lp, model, ref, p_init)
    mine, theirs = _flat_params(torch, model), _flat_params(torch, ref)
    diff = float((mine - theirs).abs().max())
    floor = float((theirs - _flat_params(torch, ref2)).abs().max())
    del ref2
    # the plain path, deterministic: the mesh adds nothing at world 1
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, la = _ref_run(torch, kind, "torch", batches, mesh)
        b, lb = _ref_run(torch, kind, "torch", batches)
        exact = bool(torch.equal(_flat_params(torch, a),
                                 _flat_params(torch, b))
                     and np.array_equal(la, lb))
    finally:
        torch.use_deterministic_algorithms(False)
    del a, b
    rows.append(("plain path, deterministic: mesh array_equal to no mesh",
                 float(exact), 1, exact))
    # the k-step mesh form: the 8 steps as one captured graph
    km = _model(torch, kind, "kernel")
    kstep = make_train_step_kbatch(km, adam(km, LR), mesh)
    stacked = stack_batches(_same_shapes(torch, batches))
    reset_launch_counts()
    lkb = kstep(stacked).cpu().numpy()
    torch.cuda.synchronize()
    kb_launches = launch_counts()
    rows += [(f"k-step vs mesh steps: {c}", r, lim, ok)
             for c, r, lim, ok in _agree(torch, lkb, lk, km, model, p_init)]
    rows.append(("k-step route is the captured graph",
                 float(kstep.route == "graph"), 1, kstep.route == "graph"))
    kb_diff = float((_flat_params(torch, km) - mine).abs().max())
    # evaluation with the mesh and without
    with _mesh_loader(eval_file, layout, cap, ROWS_TR, mesh) as ev_ld:
        ev_mesh = evaluate_stream(model, ev_ld, mesh=mesh)
        ev_ld.before_first()
        ev = evaluate_stream(model, ev_ld)
    acc_rows = abs(ev_mesh["accuracy"] - ev["accuracy"]) * ev["weight"]
    rows.append(("eval accuracy |diff| in rows", acc_rows, 1.0,
                 acc_rows <= 1.0 + 1e-6 and ev_mesh["weight"] == EVAL_ROWS))
    rows.append(("eval auc |diff|", abs(ev_mesh["auc"] - ev["auc"]), 1e-4,
                 abs(ev_mesh["auc"] - ev["auc"]) <= 1e-4))
    _checked(f"world 1 {name}", rows)
    nbytes = _grad_bytes(model)
    ar_ms = _allreduce_ms(torch, mesh, nbytes // 4)
    # steady state, STEADY_EPOCHS passes, with the mesh and without
    steady = {}
    for tag, m, msh in (("mesh", model, mesh), ("no mesh", ref, None)):
        with _mesh_loader(train_file, layout, cap, ROWS_TR, msh) as ld:
            t0 = time.perf_counter()
            fit_stream(m, ld, optimizer=adam(m, LR), mesh=msh,
                       epochs=STEADY_EPOCHS, log_every=0)
            torch.cuda.synchronize()
            steady[tag] = STEADY_EPOCHS * TRAIN_STEPS / (
                time.perf_counter() - t0)
    log(f"[mesh] world 1 (nccl) {name}: {len(batches)} steps of {ROWS_TR} "
        f"rows in {wall:.4f} s: {len(batches) / wall:.3f} steps/s; "
        f"all-reduce of the step's {nbytes} bytes {ar_ms:.4f} ms; loss "
        f"{lk[0]:.6f} -> {lk[-1]:.6f} (no mesh {lp[-1]:.6f}); max|p - p "
        f"no mesh| {diff:.3g} (two no-mesh runs: {floor:.3g}, the "
        f"backward kernels' atomics; array_equal "
        f"{bool(torch.equal(mine, theirs))}); k-step route "
        f"{kstep.route}, max|p_k - p| {kb_diff:.3g}; eval accuracy "
        f"{ev_mesh['accuracy']:.6f} auc {ev_mesh['auc']:.6f} [{power}]")
    log(f"[mesh] world 1 (nccl) {name} steady state, {STEADY_EPOCHS} "
        f"epochs of {TRAIN_STEPS} steps: mesh {steady['mesh']:.3f} steps/s, "
        f"no mesh {steady['no mesh']:.3f} steps/s [{power}]")
    log(f"[mesh] world 1 {name} kernel launches: {launches}; k-step "
        f"{kb_launches}")
    return _add(dict(launches), kb_launches)


def _mesh_ranks(torch, power, data, world: int, backend: str) -> dict:
    """[mesh] (b): ``world`` ranks, each a process of this script, each
    reading its partition of the training and eval files: over gloo all
    on cuda:0 (NCCL refuses two ranks on one card), over NCCL rank r on
    cuda:r."""
    port = _free_port()
    procs, logs, hung = [], [], None
    try:
        for r in range(world):
            logs.append(open(os.path.join(data, f"mesh_rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 str(r), "--mesh-world", str(world), "--mesh-port",
                 str(port), "--mesh-data", data, "--mesh-backend", backend],
                cwd=ROOT, env=_cli_env(), stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 2 * MESH_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired as e:
        hung = e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if hung is not None:
        raise RuntimeError(f"[mesh] the ranks outlived {2 * MESH_TIMEOUT} "
                           "s; their output's tails: " + " | ".join(
                               f"rank {r}: {out[-1500:]}"
                               for r, out in enumerate(outs))) from hung
    for r, (p, out) in enumerate(zip(procs, outs)):
        for ln in out.splitlines():
            if ln.startswith("[mesh]"):
                log(ln)
        if p.returncode != 0:
            raise RuntimeError(f"[mesh] rank {r} exited {p.returncode}: "
                               f"{out[-3000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(data, f"mesh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches: dict = {}
    for out in ranks:
        _add(launches, out["launches"])
        for name, c in out["collectives"].items():
            if "lacks" in c and (backend == "nccl" or name.startswith(
                    ("allreduce", "broadcast"))):
                raise RuntimeError(f"[mesh] {backend} lacks {name}")
            if "lacks" not in c and not c["ok"]:
                raise RuntimeError(f"[mesh] {backend} {name} on rank "
                                   f"{out['rank']}: max|err| "
                                   f"{c['max_abs_err']:.3g}")
    for name, c in ranks[0]["collectives"].items():
        log(f"[mesh] world {world} ({backend}, cuda tensors) {name}: "
            + (c["lacks"] if "lacks" in c else
               f"max|err| vs numpy {c['max_abs_err']:.3g} (every rank)"))
    for name, *_ in MESH_PATHS:
        per = [out["paths"][name] for out in ranks]
        if not all(p["ranks_equal"] for p in per):
            raise RuntimeError(f"[mesh] world {world} {name}: the ranks' "
                               "parameters differ")
        rows = [tuple(row) for row in per[0]["reference"]]
        if backend == "nccl":
            rows += [tuple(row) for row in per[0]["kstep"]]
            ok = [all(row[3] for row in p["kstep"]) for p in per]
            rows.append(("k-step checks pass on every rank", float(sum(ok)),
                         world, all(ok)))
        s0 = np.concatenate([np.load(os.path.join(
            data, f"mesh_eval_r{r}_{name}.npz"))["s0"]
            for r in range(world)])
        s1, y = (np.concatenate([np.load(os.path.join(
            data, f"mesh_eval_r{r}_{name}.npz"))[k]
            for r in range(world)]) for k in ("s1", "y"))
        learn = _auc(s1 - s0, y)
        rows.append(("evaluate_stream(mesh=) weight, the eval rows",
                     per[0]["weight"], EVAL_ROWS,
                     all(p["weight"] == EVAL_ROWS for p in per)))
        rows.append(("learning: eval auc of the change in score, at least",
                     learn, LEARN_AUC_MIN, learn >= LEARN_AUC_MIN
                     and len(y) == EVAL_ROWS))
        _checked(f"world {world} {name}", rows)
        log(f"[mesh] world {world} ({backend}) {name}: steps "
            f"{[p['steps'] for p in per]} (batches "
            f"{[p['batches'] for p in per]}) of {ROWS_TR // world} rows "
            f"a rank: " + ", ".join(
                f"rank {r} {p['steps'] / p['wall_s']:.3f} steps/s"
                for r, p in enumerate(per))
            + f"; all-reduce of the step's {per[0]['bytes']} bytes "
            f"{per[0]['allreduce_ms']:.3f} ms; ranks array_equal; "
            f"evaluate_stream(mesh=) accuracy {per[0]['accuracy']:.6f} "
            f"auc {per[0]['auc']:.6f}; auc of the change in score "
            f"{learn:.6f} [{power}]")
    log(f"[mesh] world {world} ({backend}) kernel launches (every rank): "
        f"{launches}")
    _check_shard_paths(ranks, world, backend, data, power)
    shard: dict = {}
    for out in ranks:
        for group, got in out["shard_launches"].items():
            _add(shard.setdefault(group, {}), got)
    log(f"[mesh] world {world} ({backend}) sharded paths in "
        f"{max(out['shard_s'] for out in ranks):.1f} s; kernel launches "
        f"(every rank): {shard}")
    return {"launches": launches, "ranks": ranks, "shard": shard}


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_mesh(torch, power: str, data: str, train_file: str,
               eval_file: str) -> dict:
    """Data-parallel training at full width: (a) world 1 over NCCL in
    this process, (b) world 2 over gloo in two processes, (c) every
    collective on card tensors in both.  Returns the launch counts of
    (a) and of (b) (both ranks)."""
    from dmlc_core_tpu_torch.parallel import make_mesh
    t0 = time.monotonic()
    mesh = make_mesh("dp=-1", timeout_s=MESH_TIMEOUT)
    try:
        coll = _collectives_check(torch, mesh)
        for name, c in coll.items():
            if "lacks" in c or not c["ok"]:
                raise RuntimeError(f"[mesh] nccl {name}: {c}")
            log(f"[mesh] world 1 (nccl) {name}: max|err| vs numpy "
                f"{c['max_abs_err']:.3g}")
        world1: dict = {}
        for name, kind, layout, cap in MESH_PATHS:
            try:
                got = _mesh_world1_path(torch, power, mesh, name, kind,
                                        layout, cap, train_file, eval_file)
            finally:
                torch.cuda.empty_cache()
            _add(world1, got)
    finally:
        mesh.close()
    got = _mesh_ranks(torch, power, data, MESH_WORLD, "gloo")
    world2 = got["launches"]
    for tag, launches in (("world 1", world1),
                          (f"world {MESH_WORLD}", world2)):
        missing = [k for k in MESH_KERNELS if launches.get(k, 0) < 1]
        if missing:
            raise RuntimeError(f"[mesh] {tag} never launched {missing}")
    log(f"[mesh] done in {time.monotonic() - t0:.1f} s")
    return {"world1": world1, "world2": world2, "shard": got["shard"]}


def _save_batches(path: str, batches: list) -> None:
    np.savez(path, **{f"b{i}/{k}": v.cpu().numpy()
                      for i, b in enumerate(batches) for k, v in b.items()})


def _load_batches(torch, path: str) -> list:
    got = np.load(path)
    out: dict = {}
    for key in got.files:
        i, k = key.split("/")
        out.setdefault(int(i[1:]), {})[k] = torch.from_numpy(
            got[key]).cuda()
    return [out[i] for i in sorted(out)]


def _ranks_equal(torch, mesh, model) -> bool:
    """Whether every rank's parameters are array_equal to rank 0's."""
    import torch.distributed as dist
    mine = _flat_params(torch, model)
    theirs = mine.clone()
    dist.broadcast(theirs, 0, group=mesh.group())
    flag = torch.tensor([float(torch.equal(mine, theirs))],
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group())
    return bool(flag.item() == 1.0)


def _mesh_kstep(torch, mesh, kind, batches, lk, model, p_init):
    """[mesh] (b) over NCCL: every step of the mesh run as one captured
    k-step call on this rank's batches (zero-weight copies of its last
    where its slice ran out first, as fit_stream steps), held to phase
    5's limits of the rank's mesh steps, its route and its parameters
    across ranks: ``(check rows, launches)``."""
    from dmlc_core_tpu_torch import adam
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.models import (make_train_step_kbatch,
                                            stack_batches)
    idle = {**batches[-1], "weights": torch.zeros_like(
        batches[-1]["weights"])}
    steps = list(batches) + [idle] * (len(lk) - len(batches))
    km = _model(torch, kind, "kernel")
    kstep = make_train_step_kbatch(km, adam(km, LR), mesh)
    stacked = stack_batches(_same_shapes(torch, steps))
    reset_launch_counts()
    lkb = kstep(stacked).cpu().numpy()
    torch.cuda.synchronize()
    launches = launch_counts()
    rows = [(f"k = {len(lk)} captured vs mesh steps: {c}", r, lim, ok)
            for c, r, lim, ok in _agree(torch, lkb, lk, km, model, p_init)]
    rows.append(("k-step route is the captured graph",
                 float(kstep.route == "graph"), 1, kstep.route == "graph"))
    equal = _ranks_equal(torch, mesh, km)
    rows.append(("k-step ranks array_equal", float(equal), 1, equal))
    del km, stacked
    return rows, launches


# -- [mesh] (b): the sharded paths, mp table sharding and the pp tower ------

PP_MICROBATCHES = 4        # the pipelined tower's microbatches a batch
# (mesh, table_shard, name, model, layout), run after the dp paths; the
# one-card gloo run's meshes have no dp (each rank reads every batch)
SHARD_PATHS = {
    "gloo": (("mp=2", "dim", "fm_flat_mp_dim", "fm", "flat"),
             ("mp=2", "dim", "dcn_rowmajor_mp_dim", "dcn", "rowmajor"),
             ("mp=2", "dim", "ffm_flat_mp_dim", "ffm", "flat"),
             ("mp=2", "rows", "fm_flat_mp_rows", "fm", "flat"),
             ("mp=2", "rows", "deepfm_rowmajor_mp_rows", "deepfm",
              "rowmajor"),
             ("pp=2", "dim", "deepfm_rowmajor_pp", "deepfm", "rowmajor")),
    "nccl": (("dp=2,mp=2", "dim", "fm_flat_mp_dim", "fm", "flat"),
             ("dp=2,mp=2", "dim", "deepfm_rowmajor_mp_dim", "deepfm",
              "rowmajor"),
             ("dp=2,mp=2", "rows", "fm_flat_mp_rows", "fm", "flat"),
             ("dp=2,mp=2", "rows", "deepfm_rowmajor_mp_rows", "deepfm",
              "rowmajor"),
             ("dp=2,pp=2", "dim", "deepfm_rowmajor_pp", "deepfm",
              "rowmajor")),
}
# every kernel of a model and layout, each of which a sharded path must
# launch (the flat FM paths decode the v3 wire; FFM's fields take the
# python packs' v2 wire)
PATH_KERNELS = {
    ("fm", "flat"): ("ragged_gather_fm", "ragged_gather_embed",
                     "ragged_gather_grad_fm", "ragged_gather_grad_embed",
                     "adam", "wire_decode"),
    ("dcn", "rowmajor"): ("embed_bag", "embed_bag_grad", "adam"),
    ("deepfm", "rowmajor"): ("fm_terms", "fm_terms_grad", "adam"),
    ("ffm", "flat"): ("ragged_gather_embed", "ragged_gather_grad_embed",
                      "adam"),
}


def _shard_group(name: str) -> str:
    """A sharded path's group in the launch counts: mp_dim, mp_rows or
    pp."""
    return "pp" if name.endswith("_pp") else name.rsplit("_", 2)[-2] + "_" \
        + name.rsplit("_", 1)[-1]


def _shard_loader(path, layout, cap, rows, mesh, ffm: bool):
    """The native parser of this rank's dp partition of ``path`` (libfm
    with fields for FFM, hashed into F_FFM), sharded to the rank."""
    from dmlc_core_tpu_torch import DeviceLoader, create_parser
    from dmlc_core_tpu_torch.models import batch_sharding
    return DeviceLoader(
        create_parser(path, mesh.coord("dp"), mesh.size("dp"),
                      "libfm" if ffm else "libsvm", engine="native"),
        rows, cap, layout=layout, engine="native", fields=ffm,
        id_mod=F_FFM if ffm else 0, sharding=batch_sharding(mesh))


def _sharded_model(torch, kind, mesh, mode):
    """The seeded kernel model, placed on ``mesh`` (DeepFM's tower
    pipelined where the mesh has pp)."""
    from dmlc_core_tpu_torch.models import shard_params
    model = _model(torch, kind, "kernel")
    if "pp" in mesh.axis_names:
        model = model.with_pipelined_tower(mesh, "pp", PP_MICROBATCHES)
    shard_params(model, mesh, mode)
    return model


def _full_equal(torch, mesh, full: dict) -> bool:
    """Whether every rank's gathered parameters (the replicas among
    them) are array_equal to rank 0's."""
    import torch.distributed as dist
    mine = torch.cat([t.reshape(-1) for t in full.values()])
    theirs = mine.clone()
    dist.broadcast(theirs, 0, group=mesh.world_group)
    flag = torch.tensor([float(torch.equal(mine, theirs))],
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.world_group)
    return bool(flag.item() == 1.0)


def _collective_ms(torch, mesh, kind: str, axis: str, elements: int
                   ) -> float:
    """Median ms of one collective of ``elements`` float32 a rank over
    ``axis`` (an all-reduce or an all-gather), host clock around a
    synchronize."""
    import torch.distributed as dist
    buf = torch.ones(elements, device=mesh.device)
    group = mesh.group(axis)
    parts = [torch.empty_like(buf) for _ in range(mesh.size(axis))]

    def run():
        if kind == "allgather":
            dist.all_gather(parts, buf, group=group)
        else:
            dist.all_reduce(buf, group=group)
    run()
    times = []
    for _ in range(ALLREDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _shard_kstep(torch, mesh, kind, mode, batches, lk, full, p_init):
    """Over NCCL: the sharded path's steps as one captured k-step call
    (zero-weight copies of the last batch where this dp slice ran out
    first), held to phase 5's limits of the mesh steps, its route and its
    gathered parameters across ranks: ``(check rows, launches)``."""
    from dmlc_core_tpu_torch import adam
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.models import (gather_params,
                                            make_train_step_kbatch,
                                            stack_batches)
    idle = {**batches[-1], "weights": torch.zeros_like(
        batches[-1]["weights"])}
    steps = list(batches) + [idle] * (len(lk) - len(batches))
    km = _sharded_model(torch, kind, mesh, mode)
    kstep = make_train_step_kbatch(km, adam(km, LR), mesh)
    stacked = stack_batches(_same_shapes(torch, steps))
    reset_launch_counts()
    lkb = kstep(stacked).cpu().numpy()
    torch.cuda.synchronize()
    launches = launch_counts()
    kfull = gather_params(km)
    rows = [(f"k = {len(lk)} captured vs mesh steps: {c}", r, lim, ok)
            for c, r, lim, ok in _agree(torch, lkb, lk, kfull, full, p_init)]
    rows.append(("k-step route is the captured graph",
                 float(kstep.route == "graph"), 1, kstep.route == "graph"))
    equal = _full_equal(torch, mesh, kfull)
    rows.append(("k-step ranks array_equal", float(equal), 1, equal))
    del km, stacked, kfull
    return rows, launches


def _shard_path(torch, mesh, backend, spec, mode, name, kind, layout,
                data) -> tuple:
    """One sharded path on this rank: fit_stream(mesh=) of the seeded
    kernel model placed by shard_params, then the forward's collectives
    recorded and timed, eval scores through the mesh's forward and a
    fresh no-mesh model's, evaluate_stream(mesh=), the gathered
    parameters across ranks, and over NCCL the captured k-step form.
    Saves the batches and eval scores of the rank that leads its dp
    slice; rank 0 then runs one process's no-mesh steps on the dp
    slices' batches.  Returns ``(result, launches)``."""
    import torch.distributed as dist
    from dmlc_core_tpu_torch import adam, evaluate_stream, fit_stream
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.models import gather_params
    from dmlc_core_tpu_torch.parallel.collectives import record_collectives
    ffm = kind == "ffm"
    dp = mesh.size("dp")
    rows = ROWS_TR // dp
    cap = CAP_TR // dp if layout == "flat" else K_TR
    if ffm:
        train_file, eval_file = _libfm_files(data)
    else:
        train_file = os.path.join(data, "train.libsvm")
        eval_file = os.path.join(data, "eval.libsvm")
    lead = all(mesh.coord(a) == 0 for a in mesh.axis_names if a != "dp")
    model = _sharded_model(torch, kind, mesh, mode)
    p_init = {k: t.clone() for k, t in gather_params(model).items()}
    with _shard_loader(train_file, layout, cap, rows, mesh, ffm) as ld:
        rec = _Recorder(ld)
        reset_launch_counts()
        t0 = time.perf_counter()
        lk = np.array(fit_stream(model, rec, optimizer=adam(model, LR),
                                 mesh=mesh, log_every=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
    batches = rec.seen
    # the forward's collectives at one training batch, each timed alone
    with torch.no_grad(), record_collectives() as coll:
        model(batches[0])
    coll_bytes = sum(n * 4 for _, _, n in coll)
    coll_ms = sum(_collective_ms(torch, mesh, k, a, n) for k, a, n in coll)
    with _shard_loader(eval_file, layout, cap, rows, mesh, ffm) as ev_ld:
        s1, y = _eval_scores(torch, model, ev_ld)
        ev_ld.before_first()
        ev = evaluate_stream(model, ev_ld, mesh=mesh)
        ev_ld.before_first()
        fresh = _model(torch, kind, "kernel")
        s0, _ = _eval_scores(torch, fresh, ev_ld)
        del fresh
    full = gather_params(model)
    equal = _full_equal(torch, mesh, full)
    kstep, kb_launches = None, {}
    if backend == "nccl":
        kstep, kb_launches = _shard_kstep(torch, mesh, kind, mode, batches,
                                          lk, full, p_init)
    if lead:
        np.savez(os.path.join(data, f"shard_eval_d{mesh.coord('dp')}_"
                              f"{name}.npz"), s0=s0, s1=s1, y=y)
        _save_batches(os.path.join(data, f"shard_d{mesh.coord('dp')}_"
                                   f"{name}.npz"), batches)
    dist.barrier(group=mesh.world_group)
    reference = []
    if mesh.rank == 0:
        per = [batches] + [_load_batches(torch, os.path.join(
            data, f"shard_d{d}_{name}.npz")) for d in range(1, dp)]
        steps = ([b[i] for b in per if i < len(b)] for i in range(len(lk)))
        unions = [s[0] if len(s) == 1 else _union(torch, s) for s in steps]
        ref, lp = _ref_run(torch, kind, "kernel", unions)
        ref2, _ = _ref_run(torch, kind, "kernel", unions)
        reference = _agree(torch, lk, lp, full, ref, p_init)
        mine = torch.cat([full[k].reshape(-1) for k, _ in
                          ref.named_parameters()])
        theirs = _flat_params(torch, ref)
        gap = float((mine - theirs).abs().max())
        floor = float((theirs - _flat_params(torch, ref2)).abs().max())
        del ref, ref2, unions, per, mine, theirs
        reference.append(("gap to no mesh, max|p - p no mesh|", gap,
                          float("inf"), True))
        reference.append(("two no-mesh runs, max|p - p| (atomics)", floor,
                          float("inf"), True))
    shapes = {k: list(p.shape) for k, p in model.named_parameters()}
    result = {
        "spec": spec, "mode": mode, "steps": len(lk),
        "batches": len(batches), "wall_s": wall, "ranks_equal": equal,
        "kstep": kstep, "collective_bytes": coll_bytes,
        "collective_ms": coll_ms,
        "collectives": [list(c) for c in coll], "accuracy": ev["accuracy"],
        "auc": ev["auc"], "weight": ev["weight"], "reference": reference,
        "shapes": shapes, "kernels": PATH_KERNELS[(kind, layout)],
        "launches": launches, "loss": [float(lk[0]), float(lk[-1])]}
    del model, batches, full, p_init
    torch.cuda.empty_cache()
    dist.barrier(group=mesh.world_group)
    return result, _add(dict(launches), kb_launches)


def _shard_paths(torch, backend: str, device: str, data: str) -> tuple:
    """[mesh] (b)'s sharded paths on this rank, each mesh built over the
    existing process group: ``(results by path, launches by group)``."""
    from dmlc_core_tpu_torch.parallel import make_mesh
    results, launches, meshes = {}, {}, {}
    for spec, mode, name, kind, layout in SHARD_PATHS[backend]:
        if spec not in meshes:
            meshes[spec] = make_mesh(spec, device=device, backend=backend)
        results[name], got = _shard_path(torch, meshes[spec], backend, spec,
                                         mode, name, kind, layout, data)
        _add(launches.setdefault(_shard_group(name), {}), got)
    for m in meshes.values():
        m.close()
    return results, launches


def _check_shard_paths(ranks: list, world: int, backend: str, data: str,
                       power: str) -> None:
    """The parent's checks of the sharded paths, from every rank's
    results: the replicas array_equal, rank 0's reference rows, the
    k-step rows over NCCL, each path's kernels launched, learning, and
    evaluate_stream's weight."""
    for spec, mode, name, kind, layout in SHARD_PATHS[backend]:
        per = [out["shard"][name] for out in ranks]
        rows = [tuple(row) for row in per[0]["reference"]]
        rows.append(("replicas array_equal on every rank (gathered)",
                     float(all(p["ranks_equal"] for p in per)), 1,
                     all(p["ranks_equal"] for p in per)))
        if backend == "nccl":
            rows += [tuple(row) for row in per[0]["kstep"]]
            ok = [all(row[3] for row in p["kstep"]) for p in per]
            rows.append(("k-step checks pass on every rank", float(sum(ok)),
                         world, all(ok)))
        miss = sorted({k for p in per for k in p["kernels"]
                       if p["launches"].get(k, 0) < 1})
        rows.append((f"kernels of {kind} {layout} launched on every rank "
                     f"(missing {miss})", float(not miss), 1, not miss))
        dp = max(int(s.split("=")[1]) for s in spec.split(",")
                 if s.startswith("dp")) if "dp=" in spec else 1
        ev = [np.load(os.path.join(data, f"shard_eval_d{d}_{name}.npz"))
              for d in range(dp)]
        s0, s1, y = (np.concatenate([e[k] for e in ev])
                     for k in ("s0", "s1", "y"))
        learn = _auc(s1 - s0, y)
        rows.append(("evaluate_stream(mesh=) weight, the eval rows",
                     per[0]["weight"], EVAL_ROWS,
                     all(p["weight"] == EVAL_ROWS for p in per)))
        rows.append(("learning: eval auc of the change in score, at least",
                     learn, LEARN_AUC_MIN, learn >= LEARN_AUC_MIN
                     and len(y) == EVAL_ROWS))
        _checked(f"world {world} {spec} {mode} {name}", rows)
        colls = ", ".join(f"{k} over {a} of {n * 4} bytes"
                          for k, a, n in per[0]["collectives"])
        log(f"[mesh] world {world} ({backend}) {spec} {mode} {name}: "
            f"steps {[p['steps'] for p in per]} of {ROWS_TR} global rows: "
            + ", ".join(f"rank {r} {p['steps'] / p['wall_s']:.3f} steps/s"
                        for r, p in enumerate(per))
            + f"; loss {per[0]['loss'][0]:.6f} -> {per[0]['loss'][1]:.6f}; "
            f"the forward's collectives a step: {colls}; "
            f"{per[0]['collective_bytes']} bytes a rank, "
            f"{per[0]['collective_ms']:.3f} ms (each timed alone); "
            f"rank 0's parameters {per[0]['shapes']}; evaluate_stream("
            f"mesh=) accuracy {per[0]['accuracy']:.6f} auc "
            f"{per[0]['auc']:.6f}; auc of the change in score "
            f"{learn:.6f} [{power}]")


def main_mesh_rank(rank: int, world: int, port: int, data: str,
                   backend: str) -> int:
    """``--mesh-rank R``: one rank of [mesh] (b).  Trains each path over
    its partitions under a ``backend`` mesh (gloo: on cuda:0; NCCL: on
    cuda:R), checks that the ranks' parameters are array_equal (over
    NCCL, also the captured k-step form's, against the mesh steps),
    times the gradient's all-reduce and saves its batches and eval
    scores; rank 0 then runs one process's steps on the ranks'
    concatenated batches.  Writes ``mesh_rank<R>.json`` in ``data``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dmlc_core_tpu_torch import evaluate_stream
    from dmlc_core_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device=f"cuda:{rank if backend == 'nccl' else 0}",
                     backend=backend,
                     init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                     world_size=world, timeout_s=MESH_TIMEOUT)
    train_file = os.path.join(data, "train.libsvm")
    eval_file = os.path.join(data, "eval.libsvm")
    rows = ROWS_TR // world
    out = {"rank": rank, "collectives": _collectives_check(torch, mesh),
           "paths": {}, "launches": {}}
    for name, kind, layout, cap in MESH_PATHS:
        cap = cap // world if layout == "flat" else cap
        fresh = _model(torch, kind, "kernel")
        with _mesh_loader(eval_file, layout, cap, rows, mesh, rank,
                          world) as ev_ld:
            s0, y = _eval_scores(torch, fresh, ev_ld)
        del fresh
        model, p_init, batches, lk, wall, launches = _dp_run(
            torch, mesh, kind, layout, cap, rows, train_file, rank, world)
        _add(out["launches"], launches)
        with _mesh_loader(eval_file, layout, cap, rows, mesh, rank,
                          world) as ev_ld:
            s1, _ = _eval_scores(torch, model, ev_ld)
            ev_ld.before_first()
            ev = evaluate_stream(model, ev_ld, mesh=mesh)
        np.savez(os.path.join(data, f"mesh_eval_r{rank}_{name}.npz"),
                 s0=s0, s1=s1, y=y)
        equal = _ranks_equal(torch, mesh, model)
        kstep = None
        if backend == "nccl":
            kstep, kb_launches = _mesh_kstep(torch, mesh, kind, batches, lk,
                                             model, p_init)
            _add(out["launches"], kb_launches)
        nbytes = _grad_bytes(model)
        ar_ms = _allreduce_ms(torch, mesh, nbytes // 4)
        _save_batches(os.path.join(data, f"mesh_r{rank}_{name}.npz"),
                      batches)
        dist.barrier(group=mesh.group())
        reference = []
        if rank == 0:
            # one process's steps on the ranks' concatenated batches
            per = [batches] + [_load_batches(torch, os.path.join(
                data, f"mesh_r{r}_{name}.npz")) for r in range(1, world)]
            unions = [_union(torch, [b[i] for b in per if i < len(b)])
                      for i in range(len(lk))]
            ref, lp = _ref_run(torch, kind, "kernel", unions)
            reference = _agree(torch, lk, lp, model, ref, p_init)
            del ref, unions, per
        out["paths"][name] = {
            "steps": len(lk), "batches": len(batches), "wall_s": wall,
            "ranks_equal": equal, "kstep": kstep, "bytes": nbytes,
            "allreduce_ms": ar_ms, "accuracy": ev["accuracy"],
            "auc": ev["auc"], "weight": ev["weight"],
            "reference": reference}
        del model, batches
        torch.cuda.empty_cache()
        dist.barrier(group=mesh.group())
    # the sharded paths, each mesh over the same process group
    t0 = time.perf_counter()
    out["shard"], out["shard_launches"] = _shard_paths(
        torch, backend, str(mesh.device), data)
    out["shard_s"] = time.perf_counter() - t0
    with open(os.path.join(data, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh.close()
    return 0


# -- [tracker]: a dp cohort bootstrapped by the port's tracker (A.7.b) -----

TRACKER_WORLD = 2          # [tracker]: gloo ranks, both on cuda:0
TRACKER_HB = 0.25          # the ranks' DMLC_HEARTBEAT_INTERVAL, s
TRACKER_TEL = 0.5          # the ranks' DMLC_TELEMETRY_INTERVAL, s
TRACKER_HB_TIMEOUT = 10.0  # the tracker's heartbeat_timeout, s
TRACKER_DOWN = 4           # heartbeat intervals the tracker stays down
RABIT_REPS = 20            # timed rabit collectives of each kind
RABIT_TOL = 1e-6           # rabit's sums vs the mesh's, relative
PUSH_GAP = 0.005           # s between the pushes beside the k-step call
TRACKER_COUNTER = "dmlc_device_loader_batches_total"
# every kernel of FM flat over the v3 wire: forwards, backwards, Adam
TRACKER_KERNELS = ("ragged_gather_fm", "ragged_gather_embed",
                   "ragged_gather_grad_fm", "ragged_gather_grad_embed",
                   "adam", "wire_decode")


def _tracker_proc(data: str, world: int, journal: str, port: int,
                  metrics_port: int, tag: str):
    """``python -m dmlc_core_tpu_torch.parallel.tracker`` for ``world``
    workers on 127.0.0.1:``port`` (0: any) with ``journal``, its fleet
    pages on ``metrics_port``: ``(process, (host, port), seconds to the
    bind line)``."""
    import select
    err = open(os.path.join(data, f"tracker_{tag}.log"), "w")
    env = _cli_env()
    env.update(DMLC_TRACKER_METRICS_PORT=str(metrics_port),
               DMLC_TIMELINE_INTERVAL="0.25")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.parallel.tracker",
         "host=127.0.0.1", f"port={port}", f"workers={world}",
         f"journal={journal}", f"heartbeat_timeout={TRACKER_HB_TIMEOUT}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else b""
    if not line:
        proc.kill()
        proc.wait()
        with open(os.path.join(data, f"tracker_{tag}.log")) as f:
            raise RuntimeError(f"[tracker] the {tag} tracker never bound: "
                               f"{f.read()[-2000:]}")
    doc = json.loads(line)
    return proc, (doc["host"], int(doc["port"])), time.perf_counter() - t0


def _tracker_cmd(addr, msg: dict) -> dict:
    """One JSON-line command to the tracker and its reply."""
    from dmlc_core_tpu_torch.parallel.tracker import recv_json, send_json
    from dmlc_core_tpu_torch.parallel.rabit import _connect
    with _connect(addr, 30.0) as s:
        s.settimeout(30.0)
        send_json(s, msg)
        return recv_json(s.makefile("r"))


def _wait_files(paths: list, procs: list, logs: list, what: str,
                timeout: float = MESH_TIMEOUT) -> None:
    """Wait until every path exists; fail at once, with its output, if a
    process died."""
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        for p, f in zip(procs, logs):
            if p.poll() is not None:
                f.seek(0)
                raise RuntimeError(f"[tracker] a rank exited "
                                   f"{p.returncode} before {what}: "
                                   f"{f.read()[-3000:]}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"[tracker] {what}: timed out")
        time.sleep(0.05)


def _fleet_pages(mport: int, world: int, backend: str) -> dict:
    """[tracker] (4): the tracker's pages while the cohort trains:
    ``/metrics``' merged loader batches equal to the sum of its rank
    series, every rank pushed, ``/stragglers`` (the JAX document; its
    stages listing every rank from three ranks on, the board's
    ``min_ranks``), ``/timeline`` points of the merged counter,
    ``/diagnose`` over the merged stores."""
    deadline = time.monotonic() + 60
    while True:
        code, _, page, _ = _scrape(mport, "/metrics")
        got = _parse_exposition(page)
        per = [got.get(f'{TRACKER_COUNTER}{{rank="{r}"}}', 0.0)
               for r in range(world)]
        merged = got.get(TRACKER_COUNTER, 0.0)
        if code == 200 and all(v > 0 for v in per):
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"[tracker] /metrics never had every rank's "
                               f"{TRACKER_COUNTER}: {per}")
        time.sleep(0.1)
    if merged != sum(per):
        raise RuntimeError(f"[tracker] merged {TRACKER_COUNTER} {merged} is "
                           f"not the ranks' sum {per}")
    code, _, body, _ = _scrape(mport, "/stragglers")
    board = json.loads(body)
    seen = {r for st in board.get("stages", {}).values() for r in st}
    if code != 200 or set(board) != {"z_threshold", "min_ranks", "stages",
                                     "stragglers"}:
        raise RuntimeError(f"[tracker] /stragglers: {code} {body[:300]}")
    if world >= board["min_ranks"] and seen != {str(r)
                                                for r in range(world)}:
        raise RuntimeError(f"[tracker] /stragglers lists {sorted(seen)}")
    points = 0
    while time.monotonic() < deadline and not points:
        code, _, body, _ = _scrape(mport, "/timeline?metric="
                                   "device_loader.batches")
        points = sum(len(t["points"]) for s in json.loads(body).get(
            "series", {}).values() for t in s["tiers"])
        time.sleep(0.1)
    if not points:
        raise RuntimeError("[tracker] /timeline has no points")
    code, _, body, _ = _scrape(mport, "/diagnose?since=60")
    doc = json.loads(body)
    if code != 200 or doc.get("schema") != "dmlc.diagnosis/1":
        raise RuntimeError(f"[tracker] /diagnose: {code} {body[:300]}")
    log(f"[tracker] /metrics: merged {TRACKER_COUNTER} {merged:g} = ranks "
        f"{[f'{v:g}' for v in per]}; /stragglers min_ranks "
        f"{board['min_ranks']}, ranks judged {sorted(seen)} (world "
        f"{world}, {backend}); /timeline {points} points; /diagnose 200, "
        f"{len(doc.get('suspects', []))} suspects")
    return {"merged": merged, "per_rank": per, "stragglers": sorted(seen),
            "timeline_points": points}


def phase_tracker(torch, power: str, data: str, world: int,
                  backend: str) -> dict:
    """[tracker]: the JAX examples/distributed_logreg.py flow on the card.
    The port's tracker as a process, ``world`` ranks (each a process of
    this script: gloo on cuda:0, or NCCL with rank r on cuda:r) that take
    their ranks from it, agree over rabit and train FM flat over a dp
    mesh rank 0's rendezvous builds; the tracker SIGKILLed mid-run and
    restarted on its port and journal.  Returns the launch counts (every
    rank) and the numbers."""
    import signal
    t_phase = time.monotonic()
    tdir = os.path.join(data, "tracker")
    shutil.rmtree(tdir, ignore_errors=True)
    os.makedirs(tdir)
    journal = os.path.join(tdir, "journal")
    mport = _free_port()
    tracker, addr, _ = _tracker_proc(tdir, world, journal, 0, mport,
                                     "first")
    procs, logs = [], []
    try:
        for task in range(world):
            env = _cli_env()
            env.update(DMLC_TRACKER_URI=addr[0],
                       DMLC_TRACKER_PORT=str(addr[1]),
                       DMLC_NUM_WORKER=str(world), DMLC_TASK_ID=str(task),
                       DMLC_HEARTBEAT_INTERVAL=str(TRACKER_HB),
                       DMLC_TELEMETRY_INTERVAL=str(TRACKER_TEL))
            logs.append(open(os.path.join(tdir, f"task{task}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--tracker-worker", "--mesh-world", str(world),
                 "--mesh-data", data, "--mesh-backend", backend],
                cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        marks = [os.path.join(tdir, f"epoch1_task{t}.json")
                 for t in range(world)]
        _wait_files(marks, procs, logs, "the end of epoch 1")
        pages = _fleet_pages(mport, world, backend)
        ranks1 = []
        for m in marks:
            with open(m) as f:
                ranks1.append(json.load(f))
        # (5) the HA drill: SIGKILL while the ranks train on
        t_kill = time.perf_counter()
        tracker.kill()
        tracker.wait()
        time.sleep(TRACKER_DOWN * TRACKER_HB * 1.5)
        mport2 = _free_port()
        tracker, addr2, boot = _tracker_proc(tdir, world, journal, addr[1],
                                             mport2, "restarted")
        downtime = time.perf_counter() - t_kill
        if addr2 != addr:
            raise RuntimeError(f"[tracker] restarted at {addr2}, not {addr}")
        code, _, page, _ = _scrape(mport2, "/metrics")
        replayed = _parse_exposition(page).get(
            'dmlc_tracker_journal_replayed_total{rank="tracker"}', 0.0)
        for mark in ranks1:
            r = _tracker_cmd(addr, {"cmd": "recover",
                                    "jobid": mark["jobid"],
                                    "host": "127.0.0.1",
                                    "port": mark["listen_port"]})
            if r.get("rank") != mark["rank"] or r.get("generation") != 0:
                raise RuntimeError(f"[tracker] recover of {mark['jobid']} "
                                   f"from its address gave {r}")
        with open(os.path.join(tdir, "back"), "w") as f:
            f.write(json.dumps({"downtime_s": downtime}))
        deadline = time.monotonic() + 2 * MESH_TIMEOUT
        hung = None
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired as e:
            hung = e
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        if hung is not None:
            raise RuntimeError(
                f"[tracker] the ranks outlived {2 * MESH_TIMEOUT} s; their "
                "output's tails: " + " | ".join(
                    f"task {t}: {out[-1500:]}"
                    for t, out in enumerate(outs))) from hung
        for t, (p, out) in enumerate(zip(procs, outs)):
            for ln in out.splitlines():
                if ln.startswith("[tracker]"):
                    log(ln)
            if p.returncode != 0:
                raise RuntimeError(f"[tracker] task {t} exited "
                                   f"{p.returncode}: {out[-3000:]}")
        # pushes reached the restarted tracker from every rank
        code, _, page, _ = _scrape(mport2, "/metrics")
        got = _parse_exposition(page)
        after = [got.get(f'{TRACKER_COUNTER}{{rank="{r}"}}', 0.0)
                 for r in range(world)]
        if not all(v > 0 for v in after):
            raise RuntimeError(f"[tracker] the restarted tracker's /metrics "
                               f"lacks a rank's pushes: {after}")
        tracker.send_signal(signal.SIGTERM)
        rc = tracker.wait(timeout=60)
        with open(journal + ".snap") as f:
            snap = json.load(f)
        log_bytes = os.path.getsize(journal + ".log")
        if rc != 0 or log_bytes != 0 or snap.get("schema") != \
                "dmlc.tracker.snapshot/1":
            raise RuntimeError(f"[tracker] SIGTERM: exit {rc}, log "
                               f"{log_bytes} bytes, snapshot {snap}")
        want = {m["jobid"]: m["rank"] for m in ranks1}
        if {j: w["rank"] for j, w in snap["workers"].items()} != want \
                or snap["generation"] != 0:
            raise RuntimeError(f"[tracker] the compacted journal holds "
                               f"{snap}, the ranks are {want}")
    finally:
        for p in procs + [tracker]:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for r in range(world):
        with open(os.path.join(tdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return _tracker_checks(ranks, world, backend, data, power, pages,
                           downtime, boot, replayed, after,
                           time.monotonic() - t_phase)


def _tracker_checks(outs, world, backend, data, power, pages, downtime,
                    boot, replayed, after, seconds) -> dict:
    """The ranks' results against [tracker]'s limits; logs the numbers."""
    launches: dict = {}
    for out in outs:
        missing = [k for k in TRACKER_KERNELS
                   if out["launches"].get(k, 0) < 1]
        if missing:
            raise RuntimeError(f"[tracker] rank {out['rank']} never "
                               f"launched {missing}")
        _add(launches, out["launches"])
    rows = []
    for out in outs:
        for ep in out["epochs"]:
            rows.append((f"rank {out['rank']} {ep['name']}: rabit sums vs "
                         "the mesh's, max rel err", ep["rel"], RABIT_TOL,
                         ep["rel"] <= RABIT_TOL))
            rows.append((f"rank {out['rank']} {ep['name']}: rabit digests "
                         "equal", float(ep["digests_equal"]), 1,
                         ep["digests_equal"]))
        rows += [tuple(r) for r in out["kstep"]]
        rows.append((f"rank {out['rank']}: broadcast auc is its own",
                     float(out["auc_equal"]), 1, out["auc_equal"]))
        hb = out["heartbeat_failures"]
        rows.append((f"rank {out['rank']}: rabit.heartbeat.failures, at "
                     "least", hb, 1, hb >= 1))
        rows.append((f"rank {out['rank']}: shutdown() on the restarted "
                     "tracker", float(out["shutdown"]), 1, out["shutdown"]))
    rows += [tuple(r) for r in outs[0]["reference"]]
    s0, s1, y = (np.concatenate([np.load(os.path.join(
        data, "tracker", f"eval_r{r}.npz"))[k] for r in range(world)])
        for k in ("s0", "s1", "y"))
    learn = _auc(s1 - s0, y)
    rows.append(("learning: eval auc of the change in score, at least",
                 learn, LEARN_AUC_MIN,
                 learn >= LEARN_AUC_MIN and len(y) == EVAL_ROWS))
    rows.append(("restarted tracker's tracker.journal.replayed, at least",
                 replayed, 3, replayed >= 3))
    _checked(f"world {world} ({backend})", rows, "[tracker]")
    t0 = min(o["t_register"][0] for o in outs)
    t1 = max(o["t_register"][1] for o in outs)
    r0 = outs[0]["rabit_ms"]
    log(f"[tracker] world {world} ({backend}): rendezvous {t1 - t0:.4f} s "
        f"(first registration to last assignment); rabit median of "
        f"{RABIT_REPS}: allreduce of 3 float64 "
        f"{r0['allreduce_3'] * 1e3:.1f} µs, of 1 MiB "
        f"{r0['allreduce_1MiB']:.3f} ms, broadcast "
        f"{r0['broadcast'] * 1e3:.1f} µs (rank 0; every rank "
        + ", ".join(f"{o['rabit_ms']['allreduce_1MiB']:.3f}" for o in outs)
        + f" ms a 1 MiB allreduce) [{power}]")
    log(f"[tracker] world {world} ({backend}): tracker down {downtime:.3f} "
        f"s (restart's bind {boot:.3f} s), heartbeat failures "
        f"{[o['heartbeat_failures'] for o in outs]}, telemetry failures "
        f"{[o['telemetry_failures'] for o in outs]}; pushes after the "
        f"restart {[f'{v:g}' for v in after]}; steps/s a rank by epoch "
        + "; ".join(f"rank {o['rank']} " + ", ".join(
            f"{e['steps'] / e['wall_s']:.3f}" for e in o["epochs"])
            for o in outs)
        + f" ({ROWS_TR // world} rows a rank); the captured k-step call "
        f"and the pushes during it {[o['kstep_pushes'] for o in outs]}; "
        f"learning "
        f"{learn:.6f}; auc {outs[0]['auc']:.6f}; {seconds:.1f} s [{power}]")
    log(f"[tracker] world {world} ({backend}) kernel launches (every "
        f"rank): {launches}")
    return {"launches": launches, "seconds": seconds,
            "downtime_s": downtime, "pages": pages,
            "rendezvous_s": t1 - t0, "rabit_ms": r0}


def _rabit_times(rc) -> dict:
    """Median ms of ``RABIT_REPS`` rabit collectives of each kind after
    one untimed call, each result checked."""
    small = np.arange(3, dtype=np.float64)
    big = np.ones(1 << 17)                       # 1 MiB of float64
    obj = {"seed": SEED, "init": "tcp://127.0.0.1:0"}
    cases = {
        "allreduce_3": (lambda: rc.allreduce(small),
                        lambda got: np.array_equal(got,
                                                   small * rc.world_size)),
        "allreduce_1MiB": (lambda: rc.allreduce(big),
                           lambda got: bool((got == rc.world_size).all())),
        "broadcast": (lambda: rc.broadcast(obj if rc.rank == 0 else None),
                      lambda got: got == obj),
    }
    out = {}
    for name, (fn, ok) in cases.items():
        if not ok(fn()):
            raise RuntimeError(f"[tracker] rabit {name} is wrong")
        times = []
        for _ in range(RABIT_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times))
    return out


def _wbce_sums(torch, model, batches) -> np.ndarray:
    """``[sum of w * bce, sum of w, batches]`` of ``model`` over
    ``batches``, float64."""
    import torch.nn.functional as F
    loss = wsum = 0.0
    with torch.no_grad():
        for b in batches:
            z = model(b).double()
            y = (b["labels"] > 0).double()
            w = b["weights"].double()
            per = -(y * F.logsigmoid(z) + (1.0 - y) * F.logsigmoid(-z))
            loss += float((per * w).sum())
            wsum += float(w.sum())
    return np.array([loss, wsum, float(len(batches))])


def _digest(torch, model) -> np.ndarray:
    flat = _flat_params(torch, model).double()
    return np.array([float(flat.sum()), float(flat.abs().sum()),
                     float((flat * flat).sum())])


def _rabit_agreement(torch, rc, mesh, model, name, batches, hist,
                     wall) -> dict:
    """(3): this rank's sums over its epoch's batches, all-reduced by
    rabit and by the mesh; the parameters' digest all-gathered."""
    from dmlc_core_tpu_torch.parallel import allreduce
    mine = _wbce_sums(torch, model, batches)
    by_rabit = rc.allreduce(mine)
    by_mesh = allreduce(torch.from_numpy(mine).to(mesh.device),
                        mesh).cpu().numpy()
    rel = float(np.max(np.abs(by_rabit - by_mesh) / np.abs(by_mesh)))
    rows = rc.allgather(_digest(torch, model))
    return {"name": name, "rabit": by_rabit.tolist(),
            "mesh": by_mesh.tolist(), "rel": rel,
            "digests_equal": bool((rows == rows[0]).all()),
            "steps": len(hist), "batches": len(batches), "wall_s": wall}


def _pushing(rc):
    """A thread calling ``rc.push_telemetry()`` (its ``sample_memory``
    first) every ``PUSH_GAP`` s: ``(thread, stop event, [(start, end,
    ok)])``."""
    stop, pushes = threading.Event(), []

    def run():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                rc.push_telemetry()
                ok = True
            except Exception as e:  # noqa: BLE001 — counted, then shown
                ok = f"{type(e).__name__}: {e}"
            pushes.append((t0, time.perf_counter(), ok))
            stop.wait(PUSH_GAP)

    th = threading.Thread(target=run, name="tracker-pushes", daemon=True)
    th.start()
    return th, stop, pushes


def _tracker_kstep(torch, rc, mesh, batches, lk, model, p_init) -> tuple:
    """(2): epoch 1's steps again as one make_train_step_kbatch(mesh=)
    call from the same start, while a thread pushes telemetry; over gloo,
    whose mesh form runs eagerly, also one captured call with no mesh on
    this rank's batches, against those steps one at a time.  Returns
    ``(check rows, the captured call's ms and the pushes beside it)``."""
    from dmlc_core_tpu_torch import adam
    from dmlc_core_tpu_torch.models import (make_train_step_kbatch,
                                            stack_batches)
    idle = {**batches[-1], "weights": torch.zeros_like(
        batches[-1]["weights"])}
    steps = list(batches) + [idle] * (len(lk) - len(batches))
    stacked = stack_batches(_same_shapes(torch, steps))
    th, stop, pushes = _pushing(rc)
    calls = []
    try:
        km = _model(torch, "fm", "kernel")
        kstep = make_train_step_kbatch(km, adam(km, LR), mesh)
        t0 = time.perf_counter()
        lkb = kstep(stacked).cpu().numpy()
        calls.append((kstep.route, t0, time.perf_counter()))
        rows = [(f"k-step ({kstep.route}) vs mesh steps: {c}", r, lim, ok)
                for c, r, lim, ok in _agree(torch, lkb, lk, km, model,
                                            p_init)]
        d = rc.allgather(_digest(torch, km))
        rows.append(("k-step replicas' digests equal over rabit",
                     float((d == d[0]).all()), 1, bool((d == d[0]).all())))
        del km
        if kstep.route != "graph":
            km = _model(torch, "fm", "kernel")
            solo = make_train_step_kbatch(km, adam(km, LR))
            own = stack_batches(_same_shapes(torch, batches))
            t0 = time.perf_counter()
            lks = solo(own).cpu().numpy()
            calls.append((solo.route, t0, time.perf_counter()))
            ref, lp = _ref_run(torch, "fm", "kernel", batches)
            rows += [(f"k-step no mesh ({solo.route}) vs its steps: {c}", r,
                      lim, ok) for c, r, lim, ok in _agree(
                          torch, lks, lp, km, ref, p_init)]
            del km, ref
    finally:
        stop.set()
        th.join(timeout=60)
    _, t0, t1 = next(c for c in calls if c[0] == "graph")
    # pushes (each its sample_memory, then the send) that began and ended
    # inside the captured call, and those in flight at some time of it
    inside = sum(1 for a, b, ok in pushes
                 if ok is True and a >= t0 and b <= t1)
    during = sum(1 for a, b, ok in pushes if ok is True and a < t1 and b > t0)
    pushed = sum(1 for *_, ok in pushes if ok is True)
    rows.append(("pushes wholly inside the captured k-step call, at least",
                 float(inside), 1, inside >= 1))
    return [list(r) for r in rows], {
        "call_ms": (t1 - t0) * 1e3, "inside": inside, "during": during,
        "pushes": pushed, "failed": len(pushes) - pushed,
        "errors": sorted({ok for *_, ok in pushes if ok is not True})[:3]}


def main_tracker_worker(world: int, data: str, backend: str) -> int:
    """``--tracker-worker``: one rank of [tracker].  Takes its rank from
    the tracker (``RabitContext.from_env()``), builds the dp mesh at the
    rendezvous rank 0 broadcasts, trains FM flat over its partition for
    three epochs (the tracker killed during the second, back for the
    third), agrees each epoch over rabit, and writes ``rank<R>.json``."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dmlc_core_tpu_torch import adam, evaluate_stream, fit_stream
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.parallel import RabitContext, make_mesh
    from dmlc_core_tpu_torch.utils.metrics import metrics
    tdir = os.path.join(data, "tracker")
    t_reg = [time.time()]
    rc = RabitContext.from_env()
    t_reg.append(time.time())
    if rc.world_size != world:
        raise RuntimeError(f"[tracker] the tracker's world is "
                           f"{rc.world_size}, not {world}")
    cfg = rc.broadcast({"init": f"tcp://127.0.0.1:{_free_port()}",
                        "seed": SEED} if rc.rank == 0 else None, root=0)
    mesh = make_mesh(device=f"cuda:{rc.rank if backend == 'nccl' else 0}",
                     backend=backend, init_method=cfg["init"], rank=rc.rank,
                     world_size=rc.world_size, timeout_s=MESH_TIMEOUT)
    part = mesh.coord("dp")
    if (mesh.rank, part, cfg["seed"]) != (rc.rank, rc.rank, SEED):
        raise RuntimeError(f"[tracker] mesh rank {mesh.rank} dp {part}, "
                           f"tracker rank {rc.rank}, seed {cfg['seed']}")
    train_file = os.path.join(data, "train.libsvm")
    eval_file = os.path.join(data, "eval.libsvm")
    rows, cap = ROWS_TR // world, CAP_TR // world
    out = {"rank": rc.rank, "jobid": rc.jobid, "t_register": t_reg,
           "epochs": [], "rabit_ms": _rabit_times(rc)}
    fresh = _model(torch, "fm", "kernel")
    with _mesh_loader(eval_file, "flat", cap, rows, mesh, part,
                      world) as ev_ld:
        s0, y = _eval_scores(torch, fresh, ev_ld)
    del fresh
    model = _model(torch, "fm", "kernel")
    p_init = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adam(model, LR)
    seen, losses, launches = [], [], {}

    def epoch(name):
        # the launches of the cohort's training only: not the k-step
        # calls, the agreement's forwards, the reference or evaluation
        with _mesh_loader(train_file, "flat", cap, rows, mesh, part,
                          world) as ld:
            rec = _Recorder(ld)
            reset_launch_counts()
            t0 = time.perf_counter()
            hist = fit_stream(model, rec, optimizer=opt, mesh=mesh,
                              log_every=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _add(launches, launch_counts())
        seen.append(rec.seen)
        losses.extend(hist)
        out["epochs"].append(_rabit_agreement(torch, rc, mesh, model, name,
                                              rec.seen, hist, wall))
        return rec.seen, hist

    batches, hist = epoch("epoch 1")
    out["kstep"], out["kstep_pushes"] = _tracker_kstep(
        torch, rc, mesh, batches, np.array(hist), model, p_init)
    log(f"[tracker] rank {rc.rank} captured k-step call and its pushes: "
        f"{out['kstep_pushes']}")
    mark = os.path.join(tdir, f"epoch1_task{rc.jobid}.json")
    with open(mark + ".tmp", "w") as f:
        json.dump({"rank": rc.rank, "jobid": rc.jobid,
                   "listen_port": rc._listen_port}, f)
    os.replace(mark + ".tmp", mark)
    epoch("epoch 2 (tracker killed)")
    deadline = time.monotonic() + MESH_TIMEOUT
    while not os.path.exists(os.path.join(tdir, "back")):
        if time.monotonic() > deadline:
            raise RuntimeError("[tracker] the tracker never came back")
        time.sleep(0.05)
    epoch("epoch 3 (tracker restarted)")
    with _mesh_loader(eval_file, "flat", cap, rows, mesh, part,
                      world) as ev_ld:
        s1, _ = _eval_scores(torch, model, ev_ld)
        ev_ld.before_first()
        ev = evaluate_stream(model, ev_ld, mesh=mesh)
    out["launches"] = launches
    np.savez(os.path.join(tdir, f"eval_r{rc.rank}.npz"), s0=s0, s1=s1, y=y)
    auc0 = rc.broadcast(ev["auc"] if rc.rank == 0 else None, root=0)
    out["auc"], out["auc_equal"] = auc0, auc0 == ev["auc"]
    for e, batches in enumerate(seen):
        _save_batches(os.path.join(tdir, f"batches_r{rc.rank}_e{e}.npz"),
                      batches)
    rc.allreduce(np.zeros(1))            # every rank's batches are saved
    out["reference"] = []
    if rc.rank == 0:
        # one process's steps on the ranks' concatenated batches, epoch
        # by epoch (a rank whose slice ran out adds nothing to a step)
        unions = []
        for e, ep in enumerate(out["epochs"]):
            per = [seen[e]] + [_load_batches(torch, os.path.join(
                tdir, f"batches_r{r}_e{e}.npz")) for r in range(1, world)]
            unions += [_union(torch, [b[i] for b in per if i < len(b)])
                       for i in range(ep["steps"])]
        ref, lp = _ref_run(torch, "fm", "kernel", unions)
        out["reference"] = [list(r) for r in _agree(
            torch, np.array(losses), lp, model, ref, p_init)]
        del ref, unions, per
    out["heartbeat_failures"] = metrics.counter(
        "rabit.heartbeat.failures").value
    out["telemetry_failures"] = metrics.counter(
        "rabit.telemetry.failures").value
    mesh.close()
    rc.shutdown()
    out["shutdown"] = True
    for ep in out["epochs"]:
        log(f"[tracker] rank {rc.rank} {ep['name']}: {ep['steps']} steps "
            f"({ep['batches']} batches) in {ep['wall_s']:.4f} s; rabit sums "
            f"{ep['rabit']} (mesh {ep['mesh']}, rel {ep['rel']:.3g}); "
            f"digests equal {ep['digests_equal']}")
    with open(os.path.join(tdir, f"rank{rc.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# -- [elastic]: elastic rejoin and live resharding (A.7.c1) ------------------

ELASTIC_WORLD = 3          # [elastic]: gloo ranks, all on cuda:0
ELASTIC_EPOCHS = 3
ELASTIC_CRASH = (2, 1)     # (rank, epoch): exits 7 after that epoch's compute
ELASTIC_TIMEOUT = 600      # s: the launcher's whole run
ELASTIC_VECTOR = 1 << 20   # elements of the data plane's known all-reduce
# every kernel of FM flat over the v3 wire, as [tracker]'s
ELASTIC_KERNELS = TRACKER_KERNELS


def _elastic_state_bytes() -> tuple:
    """``(leaves, bytes)`` of the example's state at chip_smoke's width:
    w0, w, v and Adam's count, mu and nu of each."""
    params = 4 + F_FEATURES * 4 + F_FEATURES * DIM * 4
    return 10, 3 * params + 4


def phase_elastic(torch, power: str, data: str, world: int,
                  backend: str) -> dict:
    """[elastic]: the JAX ``examples/elastic_train.py`` flow on the card,
    through the port's launcher as a process: ``--cluster gpu -n world
    --elastic --max-attempts 2``, each rank a process of this script
    (``--elastic-worker``) running the port's example at full width (FM
    2^20 x 32, 4096-row batches, its partition of the training file,
    three epochs) with ``ElasticTorchMesh`` over gloo on cuda:0 (or NCCL,
    rank r on cuda:r).  Rank 2 exits 7 after epoch 1's compute and is
    respawned; after each sync point every rank all-reduces a known
    vector over the generation's mesh.  Returns the launch counts (every
    rank's last incarnation) and the numbers."""
    t_phase = time.monotonic()
    edir = os.path.join(data, "elastic")
    shutil.rmtree(edir, ignore_errors=True)
    os.makedirs(os.path.join(edir, "ckpt"))
    cmd = [sys.executable, "-m",
           "dmlc_core_tpu_torch.parallel.launcher.submit", "--cluster", "gpu",
           "-n", str(world), "--elastic", "--max-attempts", "2",
           "--host-ip", "127.0.0.1",
           "--env", f"DMLC_CHECKPOINT_DIR={os.path.join(edir, 'ckpt')}",
           "--", sys.executable, os.path.abspath(__file__),
           "--elastic-worker", "--mesh-world", str(world), "--mesh-data",
           data, "--mesh-backend", backend]
    env = _cli_env()
    env.pop("DMLC_FAULT_SPEC", None)
    with open(os.path.join(edir, "launcher.out"), "w+") as out, \
            open(os.path.join(edir, "launcher.err"), "w+") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=err, start_new_session=True)
        try:
            rc = proc.wait(timeout=ELASTIC_TIMEOUT)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            # the launcher and every rank it started
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
            proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    keep = os.environ.get("CHIP_SMOKE_ELASTIC_DIR")
    if keep:
        # the launcher's and the ranks' output and records, kept
        shutil.copytree(edir, os.path.join(keep, f"w{world}_{backend}"),
                        ignore=shutil.ignore_patterns("ckpt"),
                        dirs_exist_ok=True)
    if rc != 0:
        raise RuntimeError(f"[elastic] the launcher exited {rc}: "
                           f"{stderr[-3000:]} | {stdout[-1500:]}")
    seconds = time.monotonic() - t_phase
    return _elastic_checks(edir, world, backend, power, stdout, stderr,
                           seconds)


def _elastic_checks(edir, world, backend, power, stdout, stderr,
                    seconds) -> dict:
    """The cohort's records against [elastic]'s limits; logs the
    numbers."""
    victim, crash_epoch = ELASTIC_CRASH
    recs = [json.loads(ln[6:]) for ln in stdout.splitlines()
            if ln.startswith("EPOCH ")]
    outs = []
    for r in range(world):
        with open(os.path.join(edir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    syncs = []
    for r in range(world):
        with open(os.path.join(edir, f"sync_r{r}.jsonl")) as f:
            syncs += [json.loads(ln) for ln in f if ln.strip()]
    with open(os.path.join(edir, f"crash_r{victim}.json")) as f:
        crash = json.load(f)
    exits = [ln for ln in stderr.splitlines() if "exited rc=" in ln]
    leaves, nbytes = _elastic_state_bytes()
    ok = (len(exits) == 1
          and f"gpu worker {victim} exited rc=7 (attempt 1/2)" in exits[0]
          and [o["attempt"] for o in outs] == [int(r == victim)
                                               for r in range(world)])
    rows = [("launcher exit code", 0, 0, True),
            (f"the victim's first attempt exited 7 and was respawned once "
             f"({len(exits)} exits)", float(len(exits)), 1, ok)]
    by_rank: dict = {}
    for rec in recs:
        by_rank.setdefault(rec["rank"], []).append(rec)
    once = all([x["epoch"] for x in by_rank.get(r, [])] ==
               list(range(ELASTIC_EPOCHS)) for r in range(world))
    rows.append(("each epoch once on every rank", float(once), 1, once))
    for e in range(ELASTIC_EPOCHS):
        at = [x for x in recs if x["epoch"] == e]
        losses = {x["loss"] for x in at}
        digests = {x["digest"] for x in at}
        rows.append((f"epoch {e}: losses across ranks", float(len(losses)),
                     1, len(losses) == 1 and len(at) == world))
        rows.append((f"epoch {e}: state digests across ranks",
                     float(len(digests)), 1, len(digests) == 1))
        gen = 0 if e < crash_epoch else 1
        ok = all(x["gen"] == gen for x in at)
        rows.append((f"epoch {e}: every rank at generation {gen}",
                     float(ok), 1, ok))
    ckpt = sum(x["from_ckpt"] for x in recs)
    rows.append(("checkpoint reads (from_ckpt), all records", float(ckpt), 0,
                 ckpt == 0))
    join = [x for x in recs if not x["contributed"]]
    ok = (len(join) == 1 and join[0]["rank"] == victim
          and join[0]["epoch"] == crash_epoch and join[0]["rebuilt"])
    rows.append(("one join epoch, the victim's, rebuilt", float(ok), 1, ok))
    j = join[0] if join else {"from_peers": 0, "bytes_moved": 0}
    rows.append(("the reborn rank's leaves from peers", j["from_peers"],
                 leaves, j["from_peers"] == leaves))
    rows.append(("the reborn rank's bytes moved", j["bytes_moved"], nbytes,
                 j["bytes_moved"] == nbytes))
    sums = {(s["rank"], s["attempt"], s["epoch"]): s for s in syncs}
    gens = sorted({s["gen"] for s in syncs})
    bad = [k for k, s in sums.items() if not s["sums_ok"]]
    ok = all(s["backend"] == backend for s in syncs)
    rows.append((f"every generation's mesh over {backend}", float(ok), 1,
                 ok))
    rows.append((f"data-plane all-reduce and all-gather exact in "
                 f"generations {gens}", float(len(bad)), 0,
                 not bad and gens == [0, 1] and len(sums) == len(syncs)
                 == world * ELASTIC_EPOCHS))
    auc = outs[0]["auc"]
    rows.append(("learning: eval auc of the change in score of the final "
                 "averaged model, at least", auc, LEARN_AUC_MIN,
                 auc >= LEARN_AUC_MIN and outs[0]["eval_rows"] == EVAL_ROWS))
    launches: dict = {}
    for o in outs:
        missing = [k for k in ELASTIC_KERNELS if o["launches"].get(k, 0) < 1]
        rows.append((f"rank {o['rank']} (attempt {o['attempt']}) kernels "
                     f"never launched {missing}", float(len(missing)), 0,
                     not missing))
        _add(launches, o["launches"])
    _checked(f"world {world} ({backend})", rows, "[elastic]")
    # the numbers
    reborn = sums[(victim, 1, crash_epoch)]
    st = reborn["stats"]
    mb = st["bytes_moved"] / 1e6
    to_gen1 = {s["rank"]: s["joined_at"] - crash["time"] for s in syncs
               if s["epoch"] == crash_epoch}
    rebuild = [s for s in syncs if s["epoch"] == crash_epoch]
    log(f"[elastic] world {world} ({backend}): reshard on the reborn rank "
        f"{st['wall_s']:.4f} s, {mb:.3f} MB from peers, "
        f"{mb / max(st['wall_s'], 1e-9):.1f} MB/s ({st['leaves_from_peers']} "
        f"leaves; survivors' rounds "
        + ", ".join(f"{s['stats']['wall_s']:.4f}" for s in rebuild
                    if s["rank"] != victim)
        + f" s); s from the victim's exit to generation 1 "
        + ", ".join(f"rank {r} {v:.3f}" for r, v in sorted(to_gen1.items()))
        + " [" + power + "]")
    log(f"[elastic] world {world} ({backend}): data plane teardown s "
        + ", ".join(f"rank {s['rank']} {s['times']['teardown_s']:.4f}"
                    for s in sorted(rebuild, key=lambda s: s["rank"]))
        + "; init s "
        + ", ".join(f"rank {s['rank']} {s['times']['init_s']:.4f}"
                    for s in sorted(rebuild, key=lambda s: s["rank"]))
        + "; averaging s a sync point "
        + "; ".join(f"rank {r} " + ", ".join(
            f"{sums[k]['times']['average_s']:.3f}" for k in sorted(sums)
            if k[0] == r) for r in range(world))
        + f" [{power}]")
    rate = {k: v["times"]["steps"] / v["times"]["train_s"]
            for k, v in sums.items() if v["times"]["steps"]}
    log(f"[elastic] world {world} ({backend}): steps/s a rank by epoch "
        + "; ".join(f"rank {r} " + ", ".join(
            f"e{k[2]} {rate[k]:.3f}" for k in sorted(rate) if k[0] == r)
            for r in range(world))
        + f" ({ROWS_TR}-row batches); learning {auc:.6f}; "
        f"{seconds:.1f} s [{power}]")
    log(f"[elastic] world {world} ({backend}) kernel launches (every rank's "
        f"last incarnation): {launches}")
    return {"launches": launches, "seconds": seconds,
            "reshard_s": st["wall_s"], "reshard_mb": mb,
            "to_generation1_s": to_gen1, "auc": auc}


def main_elastic_worker(world: int, data: str, backend: str) -> int:
    """``--elastic-worker``: one rank of [elastic], started (and, for the
    victim, restarted) by the port's launcher.  Runs the port's
    ``examples/elastic_train.py`` at full width; after each sync point
    all-reduces and all-gathers known vectors over the generation's
    mesh; writes ``sync_r<R>.jsonl`` (a line a sync point, every
    incarnation), ``crash_r<R>.json`` (the victim, just before it exits)
    and ``rank<R>.json`` (its launches, and on rank 0 the final model's
    learning)."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dmlc_core_tpu_torch.examples import elastic_train as example
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.parallel import allgather, allreduce
    edir = os.path.join(data, "elastic")
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    rank = int(os.environ["DMLC_TASK_ID"])
    victim, crash_epoch = ELASTIC_CRASH
    args = example.build_parser().parse_args([
        "file://" + os.path.join(data, "train.libsvm"), "--features",
        str(F_FEATURES), "--dim", str(DIM), "--epochs", str(ELASTIC_EPOCHS),
        "--batch-rows", str(ROWS_TR), "--nnz-cap", str(CAP_TR),
        "--crash-rank", str(victim), "--crash-epoch", str(crash_epoch),
        "--device", "cuda"])

    def hook(event, **info):
        if event == "crash":
            with open(os.path.join(edir, f"crash_r{rank}.json"), "w") as f:
                json.dump({"time": time.time(), "epoch": info["epoch"]}, f)
            return
        emesh, res = info["mesh"], info["result"]
        mesh, gen = emesh.mesh, emesh.generation
        x = torch.full((ELASTIC_VECTOR,), float((rank + 1) * (gen + 1)),
                       device=mesh.device)
        total = allreduce(x, mesh)
        ranks = allgather(x[:1], mesh)
        want = world * (world + 1) / 2 * (gen + 1)
        ok = (bool((total == want).all()) and ranks.tolist()
              == [float((r + 1) * (gen + 1)) for r in range(world)])
        with open(os.path.join(edir, f"sync_r{rank}.jsonl"), "a") as f:
            f.write(json.dumps({
                "rank": rank, "attempt": attempt, "epoch": info["epoch"],
                "gen": gen, "mesh_generation": mesh.generation,
                "backend": mesh.backend,
                "sums_ok": ok and mesh.generation == gen,
                "joined_at": emesh.joined_at, "times": info["times"],
                "stats": (res.stats.as_dict() if res.stats is not None
                          else None)}) + "\n")

    reset_launch_counts()
    got = example.train(args, hook=hook)
    torch.cuda.synchronize()
    out = {"rank": rank, "attempt": attempt,
           "launches": dict(launch_counts()), "auc": None, "eval_rows": 0}
    if rank == 0:
        from dmlc_core_tpu_torch import (DeviceLoader, FactorizationMachine,
                                         create_parser)
        model = got["model"]
        dev = next(model.parameters()).device
        fresh = FactorizationMachine(F_FEATURES, DIM, device=dev)
        # ids hashed as the example's loaders hash them (id_mod)
        with DeviceLoader(create_parser(os.path.join(data, "eval.libsvm"),
                                        0, 1, "libsvm", engine="native"),
                          ROWS_TR, CAP_TR, id_mod=F_FEATURES,
                          engine="native", device=dev) as ld:
            s0, y = _eval_scores(torch, fresh, ld)
            ld.before_first()
            s1, _ = _eval_scores(torch, model, ld)
        out["auc"], out["eval_rows"] = _auc(s1 - s0, y), len(y)
    with open(os.path.join(edir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# -- [probe]: the transfer probe (ROADMAP A.14) -------------------------------

PROBE_COPIES = 4           # the training file 4 times: 32 batches a pass
PROBE_ROUNDS = 5           # alternating rounds of the 4 configurations
PROBE_EPOCHS = 3           # timed FusedTrainer(k=8) epochs a wire, in turns


def phase_probe(torch, power: str, data: str, train_file: str) -> dict:
    """The port's probe over the training file repeated PROBE_COPIES
    times (4096-row batches, nnz_cap 131072) with DMLC_TUNED_CONFIG in
    the data directory: batches/s per configuration, the winner
    persisted and resolved, then FusedTrainer(k=8) of FM on the resolved
    wire and on the other, epoch by epoch in turns.  Returns the launch
    counts of the FusedTrainer epochs."""
    from dmlc_core_tpu_torch import (DeviceLoader, FusedTrainer, adam,
                                     create_parser)
    from dmlc_core_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dmlc_core_tpu_torch.pipeline import probe, tuned
    big = os.path.join(data, "probe.libsvm")
    with open(train_file, "rb") as f:
        text = f.read()
    with open(big, "wb") as f:
        f.write(text * PROBE_COPIES)
    saved = {k: os.environ.pop(k, None)
             for k in ("DMLC_TUNED_CONFIG",) + probe.PIN_KNOBS}
    os.environ["DMLC_TUNED_CONFIG"] = os.path.join(data, "tuned.json")
    try:
        res = probe.measure(big, batch_rows=ROWS_TR, nnz_cap=CAP_TR,
                            rounds=PROBE_ROUNDS)
        for cfg, runs in res.runs.items():
            log(f"[probe] put_threads {cfg[0]} {'v3' if cfg[1] else 'v2'}: "
                f"{res.score(cfg):.2f} batches/s median of {len(runs)} "
                f"({', '.join(f'{v:.2f}' for v in runs)}); {res.batches} "
                f"batches a pass [{power}]")
        if not probe.persist(res):
            raise RuntimeError("[probe] the winner was not persisted")
        got = tuned.resolve("cuda", "auto", "auto")
        if got != res.winner:
            raise RuntimeError(f"[probe] resolve gives {got}, the probe's "
                               f"winner is {res.winner}")
        log(f"[probe] winner put_threads {got[0]} "
            f"{'v3' if got[1] else 'v2'}, persisted and resolved")
        trainers = {}
        reset_launch_counts()
        for wire in (got[1], not got[1]):
            model = _model(torch, "fm", "kernel")
            loader = DeviceLoader(create_parser(big, engine="native"),
                                  ROWS_TR, CAP_TR, engine="native",
                                  emit="host", device="cuda",
                                  wire_compact="auto" if wire == got[1]
                                  else wire)
            tr = FusedTrainer(model, adam(model, LR), loader, k=KSTEP)
            tr.run_epoch()                     # the captures
            loader.before_first()
            trainers[wire] = (tr, loader, [])
        try:
            for _ in range(PROBE_EPOCHS):
                for wire, (tr, loader, rates) in trainers.items():
                    steps = tr.steps
                    t0 = time.perf_counter()
                    tr.run_epoch()
                    rates.append((tr.steps - steps)
                                 / (time.perf_counter() - t0))
                    loader.before_first()
        finally:
            for tr, loader, _ in trainers.values():
                loader.close()
        torch.cuda.synchronize()
        launches = launch_counts()
        for wire, (tr, loader, rates) in trainers.items():
            log(f"[probe] FusedTrainer(k={KSTEP}) FM flat on "
                f"{'v3' if wire else 'v2'}"
                f"{' (resolved)' if wire == got[1] else ''}: "
                f"{', '.join(f'{r:.2f}' for r in rates)} steps/s by epoch "
                f"({tr.steps // (PROBE_EPOCHS + 1)} steps an epoch, graphs "
                f"{len(tr.graph_keys)}) [{power}]")
        log(f"[probe] kernel launches: {launches}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


def main_mesh_nccl(world: int) -> int:
    """``--mesh-nccl W``: phases 1 and 2, then [mesh] (b), the [tracker]
    cohort and the [elastic] cohort over NCCL with rank r on cuda:r, W
    cards."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --mesh-nccl {world} needs {world} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    power = phase_device(torch)
    phase_build()
    with _data_files() as (data, _, _):
        got = _mesh_ranks(torch, power, data, world, "nccl")
        tracker = phase_tracker(torch, power, data, world, "nccl")
        elastic = phase_elastic(torch, power, data, world, "nccl")
    missing = [k for k in MESH_KERNELS if got["launches"].get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"[mesh] nccl world {world} never launched "
                           f"{missing}")
    print(power)
    print(json.dumps({"mesh_nccl": {"world": world,
                                    "launches": got["launches"],
                                    "shard": got["shard"],
                                    "tracker": tracker,
                                    "elastic": elastic}}, default=str))
    return 0


def main_tracker() -> int:
    """``--tracker``: phases 1, 2 and [tracker] only."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    power = phase_device(torch)
    phase_build()
    with _data_files() as (data, _, _):
        tracker = phase_tracker(torch, power, data, TRACKER_WORLD, "gloo")
    print(power)
    print(json.dumps({"tracker": tracker}))
    return 0


def main_elastic() -> int:
    """``--elastic``: phases 1, 2 and [elastic] only."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    power = phase_device(torch)
    phase_build()
    with _data_files() as (data, _, _):
        elastic = phase_elastic(torch, power, data, ELASTIC_WORLD, "gloo")
    print(power)
    print(json.dumps({"elastic": elastic}, default=str))
    return 0


def main_mesh() -> int:
    """``--mesh``: phases 1, 2, [mesh] and [probe] only."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = phase_device(torch)
    phase_build()
    with _data_files() as (data, train_file, eval_file):
        mesh = phase_mesh(torch, power, data, train_file, eval_file)
        probe = phase_probe(torch, power, data, train_file)
    print(power)
    print(json.dumps({"mesh": mesh, "probe": probe}))
    return 0


# -- phase 6 ----------------------------------------------------------------

CLI_TOL = 2e-6             # printed scores ('%.6f') vs the in-process ones


def _cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def _run_cli(args: list, env: dict, power: str):
    """``python -m dmlc_core_tpu_torch.models.cli *args`` in a process of
    its own; logs its stdout and its wall split into the interpreter's
    start and imports and the CLI's own stage line.  Returns ``(stdout,
    wall seconds)``."""
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.models.cli",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    secs = time.monotonic() - t0
    for ln in r.stdout.splitlines():
        log(f"[cli] {ln}")
    if r.returncode != 0:
        raise RuntimeError(f"dmlc-train {' '.join(args)} exited "
                           f"{r.returncode}: {r.stderr[-2000:]}")
    for ln in r.stderr.splitlines():
        if "save_async of step" in ln or "peak card memory" in ln:
            log(f"[cli] {ln.split('INFO ', 1)[-1]} [{power}]")
    # the CLI's own split of its main(); what precedes main() is the
    # interpreter's start and the imports
    stages = [ln.split("INFO ", 1)[-1] for ln in r.stderr.splitlines()
              if "dmlc-train stages" in ln]
    if not stages:
        raise RuntimeError("the CLI logged no stage times")
    main_s = float(stages[-1].split("main ", 1)[1].split("s", 1)[0])
    what = " ".join(a for a in args if a.startswith("model="))
    what += " predict" if "mode=predict" in args else " train"
    log(f"[cli] {what}: wall {secs:.3f} s = interpreter start and "
        f"imports {secs - main_s:.3f} s + {stages[-1]} [{power}]")
    return r.stdout, secs


def _plain_scores(torch, model, loader) -> np.ndarray:
    """sigmoid scores of every batch of ``loader`` on the plain path, in
    float64, the loader closed afterwards."""
    try:
        with torch.no_grad():
            s = torch.cat([torch.sigmoid(model(b)) for b in loader])
    finally:
        loader.close()
    return s.double().cpu().numpy()


def _check_predictions(name: str, out: str, want: np.ndarray, rows: int,
                       power: str) -> None:
    with open(out) as f:
        got = np.array([float(x) for x in f.read().split()])
    if got.shape != (rows,):
        raise RuntimeError(f"{name}: {got.shape[0]} predictions, expected "
                           f"{rows}")
    err = float(np.abs(got - want[:rows]).max())
    log(f"[cli] {name}: {rows} predictions, max|err| against the restored "
        f"checkpoint on the plain path {err:.3g} (limit {CLI_TOL:g}) "
        f"[{power}]")
    if not np.isfinite(got).all() or err > CLI_TOL:
        raise RuntimeError(f"{name}: CLI predictions depart from the "
                           f"checkpoint's scores: max|err| {err:.3g}")


def _cli_io(torch, power: str, data: str, eval_file: str, env: dict,
            deepfm: list) -> None:
    """``dmlc-train`` DeepFM on ``data=<dir>#cache epochs=2
    ckpt_every=4`` (the training file cut into [io]'s directory; the
    second epoch from the page file; checkpoints by save_async at steps
    4, 8, 12 and 16, the last one the run's), then ``mode=predict`` on
    the eval file from that checkpoint, held against it on the plain
    path."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeepFM,
                                     DeviceLoader, create_parser,
                                     params_from_jax)
    d = os.path.join(data, "io")
    cache = os.path.join(data, "cli_io_cache")
    ckpt = os.path.join(data, "cli_io_ckpt")
    out = os.path.join(data, "io_predictions.txt")
    train_out, _ = _run_cli(deepfm + [f"data={d}#{cache}", "epochs=2",
                                      "ckpt_every=4", f"ckpt_dir={ckpt}"],
                            env, power)
    if f"trained deepfm: {2 * TRAIN_STEPS} steps" not in train_out:
        raise RuntimeError("the dir#cache CLI's log lacks its steps")
    if not os.path.isfile(cache + ".pages"):
        raise RuntimeError("the dir#cache CLI wrote no page file")
    _run_cli(deepfm + ["mode=predict", f"data={eval_file}",
                       f"ckpt_dir={ckpt}", f"output={out}"], env, power)
    mgr = CheckpointManager(ckpt)
    step, state = mgr.restore()
    count = int(np.asarray(state["opt_state"][0][0]))
    if (step, count, mgr.steps) != (2 * TRAIN_STEPS, 2 * TRAIN_STEPS,
                                    [8, 12, 16]):
        raise RuntimeError(f"dir#cache checkpoints {mgr.steps}, step "
                           f"{step}, Adam count {count}")
    model = DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine="torch",
                   device="cuda")
    model.load_state_dict(params_from_jax(state["params"], "cuda"))
    want = _plain_scores(torch, model, DeviceLoader(
        create_parser(eval_file, engine="native"), ROWS_TR, CAP_TR,
        id_mod=F_FEATURES, device="cuda", engine="native"))
    _check_predictions("data=<dir>#cache predict", out, want, EVAL_ROWS,
                       power)
    shutil.rmtree(ckpt, ignore_errors=True)


def _cli_ffm(torch, power: str, data: str, env: dict) -> None:
    """``dmlc-train model=ffm`` at its defaults (features 2^20, fields 40,
    dim 16: v is 2.7 GB, 8 GB with Adam's moments; D = 640 in the
    ragged-gather kernels), libfm implied by the model: one epoch (8
    steps) with ``ckpt_every=4`` (save_async at steps 4 and 8; the second
    is the run's checkpoint), then ``mode=predict`` on the eval file,
    held against the restored checkpoint on the plain path."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeviceLoader,
                                     FieldAwareFM, create_parser,
                                     params_from_jax)
    train_file, eval_file = _libfm_files(data)
    ckpt = os.path.join(data, "cli_ffm_ckpt")
    out = os.path.join(data, "ffm_predictions.txt")
    free = shutil.disk_usage(data).free / 2 ** 30
    log(f"[cli] model=ffm: {free:.1f} GiB free for its checkpoint")
    train_out, _ = _run_cli(["model=ffm", f"data={train_file}",
                             f"ckpt_dir={ckpt}", "ckpt_every=4"], env, power)
    if f"trained ffm: {TRAIN_STEPS} steps" not in train_out:
        raise RuntimeError("the ffm CLI's log lacks its steps")
    _run_cli(["model=ffm", "mode=predict", f"data={eval_file}",
              f"ckpt_dir={ckpt}", f"output={out}"], env, power)
    step, state = CheckpointManager(ckpt).restore()
    model = FieldAwareFM(1 << 20, 40, 16, engine="torch", device="cuda")
    model.load_state_dict(params_from_jax(state["params"], "cuda"))
    count = int(np.asarray(state["opt_state"][0][0]))
    del state
    want = _plain_scores(torch, model, DeviceLoader(
        create_parser(eval_file, parser_type="libfm", engine="native"),
        ROWS_TR, CAP_TR, id_mod=1 << 20, device="cuda", engine="native",
        fields=True))
    del model
    torch.cuda.empty_cache()
    if step != TRAIN_STEPS or count != TRAIN_STEPS:
        raise RuntimeError(f"ffm checkpoint step {step}, Adam count "
                           f"{count}; expected {TRAIN_STEPS}")
    _check_predictions("model=ffm predict", out, want, EVAL_ROWS, power)
    shutil.rmtree(ckpt, ignore_errors=True)


CSV_COLS = 32              # the label column and 31 value columns


def _write_csv(path: str, rows: int, seed: int) -> None:
    """Seeded dense csv: column 0 the label, 1 where a planted linear
    score of the other 31 columns (U[0, 1), '%.4f') lies above the
    file's median."""
    rng = np.random.default_rng(seed)
    x = rng.random((rows, CSV_COLS - 1))
    w = np.random.default_rng(SEED + 98).standard_normal(CSV_COLS - 1)
    score = x @ w
    y = score > np.median(score)
    with open(path, "wb") as f:
        f.write(b"".join(b"%d," % t + b",".join(b"%.4f" % v for v in row)
                         + b"\n" for t, row in zip(y.tolist(), x)))


def _cli_csv(torch, power: str, data: str, env: dict) -> None:
    """``dmlc-train model=fm format=csv`` on seeded 32-column csv whose
    label column comes from the URI (``?label_column=0``): one epoch (8
    steps) with a checkpoint, ``mode=predict`` on the eval file, held
    against the restored checkpoint on the plain path."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeviceLoader,
                                     FactorizationMachine, create_parser,
                                     params_from_jax)
    train_file = os.path.join(data, "train.csv")
    eval_file = os.path.join(data, "eval.csv")
    _write_csv(train_file, TRAIN_STEPS * ROWS_TR, SEED + 20)
    _write_csv(eval_file, EVAL_ROWS, SEED + 21)
    ckpt = os.path.join(data, "cli_csv_ckpt")
    out = os.path.join(data, "csv_predictions.txt")
    model = ["model=fm", "format=csv", f"features={CSV_COLS}"]
    train_out, _ = _run_cli(model + [f"data={train_file}?label_column=0",
                                     f"ckpt_dir={ckpt}"], env, power)
    if f"trained fm: {TRAIN_STEPS} steps" not in train_out:
        raise RuntimeError("the csv CLI's log lacks its steps")
    _run_cli(model + ["mode=predict", f"data={eval_file}?label_column=0",
                      f"ckpt_dir={ckpt}", f"output={out}"], env, power)
    _, state = CheckpointManager(ckpt).restore()
    fm = FactorizationMachine(CSV_COLS, 16, engine="torch", device="cuda")
    fm.load_state_dict(params_from_jax(state["params"], "cuda"))
    want = _plain_scores(torch, fm, DeviceLoader(
        create_parser(f"{eval_file}?label_column=0", parser_type="csv",
                      engine="native"), ROWS_TR, CAP_TR,
        id_mod=CSV_COLS, device="cuda", engine="native"))
    _check_predictions("model=fm format=csv predict", out, want, EVAL_ROWS,
                       power)


def phase_cli(torch, power: str, data: str, train_file: str,
              eval_file: str) -> None:
    """The port's ``dmlc-train`` in subprocesses, as a user runs it:
    DeepFM(2^20, dim=32, layers=2) trained for one epoch (8 steps) on
    the card with a validation file and a checkpoint, then ``mode=
    predict`` on the eval file.  The scores must match what the restored
    checkpoint gives in-process on the plain path."""
    from dmlc_core_tpu_torch import (CheckpointManager, DeepFM,
                                     DeviceLoader, create_parser,
                                     params_from_jax)
    ckpt = os.path.join(data, "cli_ckpt")
    out = os.path.join(data, "predictions.txt")
    env = _cli_env()
    deepfm = ["model=deepfm", f"features={F_FEATURES}", f"dim={DIM}",
              f"layers={DEEPFM_LAYERS}"]

    def run(*args):
        return _run_cli(deepfm + list(args), env, power)

    train_out, train_s = run(f"data={train_file}", f"valid={eval_file}",
                             f"ckpt_dir={ckpt}")
    want = f"trained deepfm: {TRAIN_STEPS} steps"
    if want not in train_out:
        raise RuntimeError(f"the CLI's log lacks {want!r}")
    _, pred_s = run("mode=predict", f"data={eval_file}", f"ckpt_dir={ckpt}",
                    f"output={out}")
    with open(out) as f:
        got = np.array([float(x) for x in f.read().split()])
    if got.shape != (EVAL_ROWS,):
        raise RuntimeError(f"{got.shape[0]} predictions, expected "
                           f"{EVAL_ROWS}")

    step, state = CheckpointManager(ckpt).restore()
    model = DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine="torch",
                   device="cuda")
    model.load_state_dict(params_from_jax(state["params"], "cuda"))
    loader = DeviceLoader(create_parser(eval_file, engine="native"), ROWS_TR,
                          CAP_TR, id_mod=F_FEATURES, device="cuda",
                          engine="native")
    with torch.no_grad():
        want_scores = torch.cat([torch.sigmoid(model(b)) for b in loader])
    loader.close()
    want_scores = want_scores[:EVAL_ROWS].double().cpu().numpy()
    err = float(np.abs(got - want_scores).max())
    count = int(np.asarray(state["opt_state"][0][0]))
    log(f"[cli] train {train_s:.1f} s, predict {pred_s:.1f} s (host clock, "
        f"process start included); checkpoint step {step}, Adam count "
        f"{count}; {got.shape[0]} predictions, max|err| against the "
        f"restored checkpoint on the plain path {err:.3g} (limit "
        f"{CLI_TOL:g}) [{power}]")
    if step != TRAIN_STEPS or count != TRAIN_STEPS:
        raise RuntimeError(f"checkpoint step {step}, Adam count {count}; "
                           f"expected {TRAIN_STEPS}")
    if not np.isfinite(got).all() or err > CLI_TOL:
        raise RuntimeError(f"CLI predictions depart from the checkpoint's "
                           f"scores: max|err| {err:.3g}")

    _serve_main_check(power, env, ckpt, eval_file, got)
    _cli_io(torch, power, data, eval_file, env, deepfm)

    # kstep=8: the epoch's 8 steps as one replayed graph; its checkpoint
    # against the kstep=1 run's, each parameter against how far it moved
    ckpt8 = os.path.join(data, "cli_ckpt_kstep")
    out8, train8_s = run(f"data={train_file}", f"ckpt_dir={ckpt8}",
                         "kstep=8")
    if want not in out8:
        raise RuntimeError(f"the kstep=8 CLI's log lacks {want!r}")
    step8, state8 = CheckpointManager(ckpt8).restore()
    init = DeepFM(F_FEATURES, DIM, DEEPFM_LAYERS, engine="torch",
                  device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    p0 = {k: v.detach() for k, v in init.named_parameters()}
    p1 = params_from_jax(state["params"], "cuda")
    p8 = params_from_jax(state8["params"], "cuda")
    ratios = {k: float((p8[k] - p1[k]).norm())
              / max(float((p1[k] - p0[k]).norm()), 1e-30) for k in p0}
    worst = max(ratios, key=ratios.get)
    count8 = int(np.asarray(state8["opt_state"][0][0]))
    log(f"[cli] train kstep=8 {train8_s:.1f} s; checkpoint step {step8}, "
        f"Adam count {count8}; parameters ||k8-k1||/||k1-p0|| "
        f"({worst}) {ratios[worst]:.3g} (limit {PARAM_TOL:g}) [{power}]")
    if (step8 != TRAIN_STEPS or count8 != TRAIN_STEPS
            or ratios[worst] > PARAM_TOL):
        raise RuntimeError("the kstep=8 CLI run departs from kstep=1")

    _cli_ffm(torch, power, data, env)
    _cli_csv(torch, power, data, env)

    # what "optimizer set-up" cost before the port's own Adam: building a
    # torch.optim.Adam in a fresh interpreter, and what it imported
    probe = ("import json, sys, time; t0 = time.perf_counter(); "
             "import torch; t1 = time.perf_counter(); "
             "p = torch.nn.Parameter(torch.zeros(8, device='cuda')); "
             "t2 = time.perf_counter(); had = 'torch._dynamo' in "
             "sys.modules; torch.optim.Adam([p], lr=1e-3); "
             "t3 = time.perf_counter(); "
             "print(json.dumps({'import_torch_s': t1 - t0, "
             "'cuda_init_s': t2 - t1, 'torch_optim_adam_s': t3 - t2, "
             "'dynamo_imported_before': had, 'dynamo_imported_after': "
             "'torch._dynamo' in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=300, check=True)
    log(f"[cli] a fresh interpreter: {r.stdout.strip()} [{power}]")


SERVE_ROWS, SERVE_CHUNK = 512, 128    # eval rows scored over TCP, a request


def _libsvm_rows(path: str, n: int):
    """The first ``n`` rows of a libsvm file as one CSR request."""
    ids, vals, ptr = [], [], [0]
    with open(path, "rb") as f:
        for _, line in zip(range(n), f):
            for tok in line.split()[1:]:
                i, v = tok.split(b":")
                ids.append(int(i))
                vals.append(float(v))
            ptr.append(len(ids))
    return (np.array(ids, np.int32), np.array(vals, np.float32),
            np.array(ptr, np.int64))


def _serve_main_check(power: str, env: dict, ckpt: str, eval_file: str,
                      predicted: np.ndarray) -> None:
    """The port's server as a user starts it, on the checkpoint
    dmlc-train just wrote: the eval file's first rows scored through
    ``PredictClient`` must match what ``mode=predict`` wrote for them
    (after the same link, printed '%.6f') within CLI_TOL."""
    import select
    import signal

    from dmlc_core_tpu_torch import PredictClient
    log_path = os.path.join(os.path.dirname(ckpt), "server.log")
    t0 = time.monotonic()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.serving.server",
             f"ckpt_dir={ckpt}", "model=deepfm", f"features={F_FEATURES}",
             f"dim={DIM}", "host=127.0.0.1", "port=0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=log_file,
            text=True)
        try:
            line = ""
            while "serving on" not in line:
                left = t0 + 300 - time.monotonic()
                if left <= 0 or proc.poll() is not None:
                    with open(log_path) as f:
                        raise RuntimeError(f"serve_main did not come up: "
                                           f"{f.read()[-2000:]}")
                if select.select([proc.stdout], [], [], left)[0]:
                    line = proc.stdout.readline()
            up_s = time.monotonic() - t0
            host, port = line.split()[-1].rsplit(":", 1)
            ids, vals, ptr = _libsvm_rows(eval_file, SERVE_ROWS)
            t1 = time.monotonic()
            scores = []
            with PredictClient(host, int(port)) as client:
                for a in range(0, SERVE_ROWS, SERVE_CHUNK):
                    lo, hi = ptr[a], ptr[a + SERVE_CHUNK]
                    scores.append(client.predict(
                        ids[lo:hi], vals[lo:hi],
                        ptr[a:a + SERVE_CHUNK + 1] - lo, timeout=120))
            score_s = time.monotonic() - t1
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
    scores = np.concatenate(scores).astype(np.float64)
    err = float(np.abs(scores - predicted[:SERVE_ROWS]).max())
    with open(log_path) as f:
        served = [ln.split("INFO ", 1)[-1].strip() for ln in f
                  if "hot-reloaded" in ln or "captured bucket" in ln]
    log(f"[cli] serve_main (python -m dmlc_core_tpu_torch.serving.server "
        f"model=deepfm): up in {up_s:.3f} s ({served[-1] if served else ''}"
        f"), {SERVE_ROWS} eval rows in {SERVE_ROWS // SERVE_CHUNK} requests "
        f"over TCP in {score_s * 1e3:.1f} ms; max|err| against mode=predict "
        f"{err:.3g} (limit {CLI_TOL:g}); exit {proc.returncode} [{power}]")
    if proc.returncode != 0:
        raise RuntimeError(f"serve_main exited {proc.returncode} on SIGINT")
    if not np.isfinite(scores).all() or err > CLI_TOL:
        raise RuntimeError(f"served scores depart from mode=predict's: "
                           f"max|err| {err:.3g}")
    if not any("hot-reloaded step" in ln for ln in served):
        raise RuntimeError("serve_main never loaded the checkpoint")


# -- planted faults -----------------------------------------------------------

PLANTS = ("dtable", "forward")


def _plant(kind: str) -> None:
    """Break the kernel path on purpose, on the factor tables (D > 1)
    only, leaving the plain path alone: ``dtable`` zeroes the backward
    kernels' table gradient (ragged gather, embed bag, fm terms),
    ``forward`` the forward kernels' output.  Phase 5's checks must
    catch either on every path."""
    import importlib

    from dmlc_core_tpu_torch.kernels.common import use_kernel
    # the modules, not the functions the packages export under their names
    rg = importlib.import_module("dmlc_core_tpu_torch.kernels.ragged_gather")
    emb = importlib.import_module("dmlc_core_tpu_torch.ops.embed")

    if kind == "dtable":
        grad_kernel, bag_grad = rg._grad_kernel, emb.embed_bag_grad
        fm_grad = emb.fm_terms_grad

        def ragged(*a):
            dvals, dtable = grad_kernel(*a)
            if dtable is not None and dtable.shape[1] > 1:
                dtable.zero_()
            return dvals, dtable

        def bag(ids, vals, table, g, *a, engine="auto", **kw):
            dvals, dtable = bag_grad(ids, vals, table, g, *a, engine=engine,
                                     **kw)
            if (dtable is not None and table.shape[1] > 1
                    and use_kernel(engine, table.device)):
                dtable.zero_()
            return dvals, dtable
        def fm(ids, vals, table, g1, g2, *a, engine="auto", **kw):
            dvals, dtable = fm_grad(ids, vals, table, g1, g2, *a,
                                    engine=engine, **kw)
            if (dtable is not None and table.shape[1] > 1
                    and use_kernel(engine, table.device)):
                dtable.zero_()
            return dvals, dtable
        rg._grad_kernel, emb.embed_bag_grad = ragged, bag
        emb.fm_terms_grad = fm
    else:
        gather_kernel, bag_fwd = rg._ragged_gather_kernel, \
            emb.embed_bag_forward
        fm_fwd = emb.fm_terms

        def ragged(ids, vals, segments, nnz_used, table, num_rows, fm):
            out1, out2 = gather_kernel(ids, vals, segments, nnz_used, table,
                                       num_rows, fm)
            if table.shape[1] > 1:
                out1.zero_()
                if out2 is not None:
                    out2.zero_()
            return out1, out2

        def bag(ids, vals, table, square=False, engine="auto"):
            out = bag_fwd(ids, vals, table, square, engine)
            if table.shape[1] > 1 and use_kernel(engine, table.device):
                out.zero_()
            return out
        def fm(ids, vals, table, engine="auto"):
            s1, s2 = fm_fwd(ids, vals, table, engine)
            if table.shape[1] > 1 and use_kernel(engine, table.device):
                s1.zero_()
                s2.zero_()
            return s1, s2
        rg._ragged_gather_kernel, emb.embed_bag_forward = ragged, bag
        emb.fm_terms = fm


def main_planted(kind: str) -> int:
    """``--plant KIND``: the device and build phases, then phase 5 with a
    fault planted on the kernel path.  Exits 0 only if every path's
    checks caught it; the last line names what each path did."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = phase_device(torch)
    phase_build()
    _plant(kind)
    with _data_files() as (_, train_file, eval_file):
        caught = phase_training(torch, power, train_file, eval_file,
                                planted=True)
    print(json.dumps({"plant": kind, "caught": caught}))
    return 0 if all(caught.values()) else 1


def main_serving() -> int:
    """``--serving``: phases 1, 2, 4, 4a, [exporter], [incident] and
    [diagnose] only (the serving numbers, for a comparison on one card);
    the last line is phase 4a's numbers with [exporter]'s, [incident]'s
    and [diagnose]'s under ``exporter``, ``incident`` and ``diagnose``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    power = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    phase_serving(torch, timer, power)
    out = phase_server(torch, timer, power)
    exporter = phase_exporter(torch, power)
    incident = phase_incident(torch, power)
    diagnosis = phase_diagnose(torch, power)
    print(power)
    print(json.dumps({**out["stats"], "exporter": exporter["stats"],
                      "incident": incident["stats"],
                      "diagnose": diagnosis["stats"]}, default=str))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import dmlc_core_tpu_torch  # noqa: F401 — fails without the package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    power = phase_device(torch)
    phase_build()
    timer = Timer(torch)
    kern = phase_kernels(torch, timer, power)
    serving = phase_serving(torch, timer, power)
    server = phase_server(torch, timer, power)["launches"]
    exporter = phase_exporter(torch, power)["launches"]
    incident = phase_incident(torch, power)["launches"]
    diagnosis = phase_diagnose(torch, power)["launches"]
    with _data_files() as (data, train_file, eval_file):
        phase_feed(torch, power, train_file)
        io = phase_io(torch, power, data, train_file)
        training = phase_training(torch, power, train_file, eval_file)
        ffm = phase_ffm(torch, timer, power, data)
        kstep = phase_kstep(torch, power, train_file, eval_file)
        phase_cli(torch, power, data, train_file, eval_file)
        remote = phase_remote(torch, power, data, train_file, eval_file)
        ingest = phase_ingest(torch, timer, power, data, train_file,
                              eval_file)
        mesh = phase_mesh(torch, power, data, train_file, eval_file)
        tracker = phase_tracker(torch, power, data, TRACKER_WORLD,
                                "gloo")["launches"]
        elastic = phase_elastic(torch, power, data, ELASTIC_WORLD,
                                "gloo")["launches"]
        probe = phase_probe(torch, power, data, train_file)
        # last: once torch.profiler has run, every later launch of this
        # process pays for it (PERF.md)
        trace = phase_trace(torch, power, train_file)["launches"]
    kern["wire_decode"] = ingest["kernel"]
    ingest = ingest["launches"]
    src = "dmlc_core_tpu_torch/kernels/"
    # name: (source, TPU kernel, the path whose launches it reports)
    meta = {
        "ragged_gather_fm": ("ragged_gather.cu",
                             "dmlc_core_tpu/ops/ragged_csr.py:166", serving),
        "ragged_gather_embed": ("ragged_gather.cu",
                                "dmlc_core_tpu/ops/ragged_csr.py:166",
                                serving),
        "fm_terms": ("fm_terms.cu", "dmlc_core_tpu/ops/pallas_embed.py:326",
                     serving),
        "embed_bag": ("embed_bag.cu", "dmlc_core_tpu/ops/pallas_embed.py:290",
                      training),
        "embed_bag_grad": ("embed_bag.cu",
                           "dmlc_core_tpu/ops/pallas_embed.py:290", training),
        "ragged_gather_grad_fm": ("ragged_gather_grad.cu",
                                  "dmlc_core_tpu/ops/ragged_csr.py:166",
                                  training),
        "ragged_gather_grad_embed": ("ragged_gather_grad.cu",
                                     "dmlc_core_tpu/ops/ragged_csr.py:166",
                                     training),
        "fm_terms_grad": ("fm_terms.cu",
                          "dmlc_core_tpu/ops/pallas_embed.py:326", training),
        # no Pallas counterpart: the JAX package's optimizer updates, XLA
        "adam": ("optim.cu", "dmlc_core_tpu/models/train.py:106",
                 {"adam": training.get("adam", 0) + kstep.get("adam", 0)
                  + ffm.get("adam", 0)}),
        "ftrl": ("optim.cu", "dmlc_core_tpu/models/ftrl.py:57", kstep),
        # no Pallas counterpart: the JAX package's v3 decode, XLA
        "wire_decode": ("wire_decode.cu",
                        "dmlc_core_tpu/pipeline/device_loader.py:94",
                        ingest),
    }
    missing = [k for k, (_, _, path) in meta.items() if path.get(k, 0) < 1]
    # the forward kernels run on the training paths too
    missing += [f"{k} (training)" for k in ("ragged_gather_fm",
                                            "ragged_gather_embed",
                                            "fm_terms")
                if training.get(k, 0) < 1]
    # the server's path: both ragged-gather forwards, in every replay
    missing += [f"{k} (server)" for k in ("ragged_gather_fm",
                                          "ragged_gather_embed")
                if server.get(k, 0) < 1]
    # the same server with the exporter and the SLO monitor mounted
    missing += [f"{k} (exporter)" for k in ("ragged_gather_fm",
                                            "ragged_gather_embed")
                if exporter.get(k, 0) < 1]
    # the same server with the flight recorder, the tail sampler and its
    # wide events
    missing += [f"{k} (incident)" for k in ("ragged_gather_fm",
                                            "ragged_gather_embed")
                if incident.get(k, 0) < 1]
    # the same server under the diagnosis: the watchdog, the profiler, the
    # critical path and the breach's ranked verdict
    missing += [f"{k} (diagnose)" for k in ("ragged_gather_fm",
                                            "ragged_gather_embed")
                if diagnosis.get(k, 0) < 1]
    # FFM's bucket sum G and its gradient, on both of its paths
    missing += [f"{k} (ffm)" for k in ("ragged_gather_embed",
                                       "ragged_gather_grad_embed")
                if ffm.get(k, 0) < 1]
    # every kernel of the flat paths runs inside the k-step graphs
    missing += [f"{k} (kstep)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam", "ftrl") if kstep.get(k, 0) < 1]
    # the I/O layer's training (page-cache steady state, save_async)
    missing += [f"{k} (io)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam") if io.get(k, 0) < 1]
    # the remote path: FM trained from s3://, the server restored from it
    missing += [f"{k} (remote)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam") if remote.get(k, 0) < 1]
    # training from ingest workers: both wires' paths end in these
    missing += [f"{k} (ingest)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam") if ingest.get(k, 0) < 1]
    # the traced paths: served requests and the profiled FM step
    missing += [f"{k} (trace)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam", "wire_decode")
        if trace.get(k, 0) < 1]
    # the card's loaders ship the v3 wire by default: every flat path
    # decodes through the kernel
    missing += [f"wire_decode ({name})" for name, path in (
        ("training", training), ("kstep", kstep), ("io", io),
        ("remote", remote)) if path.get("wire_decode", 0) < 1]
    # the tracker-bootstrapped cohort: every kernel of FM flat (each rank
    # is checked in [tracker] too)
    missing += [f"{k} (tracker)" for k in TRACKER_KERNELS
                if tracker.get(k, 0) < 1]
    # the elastic cohort: every kernel of FM flat on every rank, the
    # reborn one included (checked per rank in [elastic] too)
    missing += [f"{k} (elastic)" for k in ELASTIC_KERNELS
                if elastic.get(k, 0) < 1]
    # [mesh] checks its own paths' kernels (MESH_KERNELS); the probe's
    # FusedTrainer runs both wires
    missing += [f"{k} (probe)" for k in (
        "ragged_gather_fm", "ragged_gather_embed", "ragged_gather_grad_fm",
        "ragged_gather_grad_embed", "adam", "wire_decode")
        if probe.get(k, 0) < 1]
    if missing:
        raise RuntimeError(f"main path never launched: {missing}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows = []
    for name, (cu, replaces, path) in meta.items():
        k = kern[name]
        row = {"name": name, "route": "cuda", "source": src + cu,
               "replaces": replaces, "launches": path.get(name, 0),
               **{key: k[key] for key in keys}}
        for extra in ("floor_ms", "library_foreach_ms", "dcn", "fm", "d32",
                      "raw"):
            # the same kernel with next to no work; torch.optim.Adam's
            # default (foreach); the optimizers at the other models'
            # shapes; the ragged embed backward at D = 32 (DCNv2's x0);
            # the v3 decode of a batch of raw values (no dictionary)
            if extra in k:
                row[extra] = k[extra]
        if name in ("ragged_gather_fm", "ragged_gather_embed"):
            # the TCP server, one graph replay a call; the same server with
            # the telemetry exporter and the SLO monitor; with the flight
            # recorder and the tail sampler; and under the diagnosis
            row["server"] = {"launches": server.get(name, 0)}
            row["exporter"] = {"launches": exporter.get(name, 0)}
            row["incident"] = {"launches": incident.get(name, 0)}
            row["diagnose"] = {"launches": diagnosis.get(name, 0)}
        if io.get(name, 0):
            # the I/O layer's training: fed from the page file, and
            # save_async under training
            row["io"] = {"launches": io[name]}
        if remote.get(name, 0):
            # FM trained from s3:// and the server restored from it
            row["remote"] = {"launches": remote[name]}
        if name != "wire_decode" and ingest.get(name, 0):
            # FM trained from ingest worker processes
            row["ingest"] = {"launches": ingest[name]}
        if trace.get(name, 0):
            # [trace]: the traced requests and the profiled FM step
            row["trace"] = {"launches": trace[name]}
        if name in MESH_KERNELS:
            # [mesh]: dp training, world 1 over NCCL in this process
            # (fit_stream and the captured k-step form), world 2 over gloo
            # (both ranks' processes)
            row["mesh"] = {"world1": {"launches": mesh["world1"].get(name,
                                                                     0)},
                           "world2": {"launches": mesh["world2"].get(name,
                                                                     0)}}
            # [mesh] (b)'s sharded paths, both ranks: mp dim, mp rows, pp
            row["mesh"]["world2_sharded"] = {
                group: {"launches": got.get(name, 0)}
                for group, got in mesh["shard"].items()}
        if name + "_ffm_mp_dim" in kern:
            # FFM's G at a rank's columns over mp = 2 (D = 80), with the
            # mp dim group's launches (FFM is among its paths)
            row["ffm_mp_dim"] = {
                "launches": mesh["shard"].get("mp_dim", {}).get(name, 0),
                **{key: kern[name + "_ffm_mp_dim"][key]
                   for key in keys + ("floor_ms",)}}
        for group in ("mp_dim", "mp_rows"):
            if f"{name}_{group}" in kern:
                # the same kernel at the sharded FM path's shard shape
                # (dim: D = 16; rows: F = 2^19, the other rank's entries
                # inert), with that group's launches (both ranks)
                row[group] = {"launches": mesh["shard"].get(group, {}).get(
                    name, 0), **{key: kern[f"{name}_{group}"][key]
                                 for key in keys + ("floor_ms",)}}
        if name in TRACKER_KERNELS:
            # [tracker]: the dp cohort the port's tracker bootstrapped
            # (both ranks' processes)
            row["tracker"] = {"launches": tracker.get(name, 0)}
        if name in ELASTIC_KERNELS:
            # [elastic]: the elastic cohort through the port's launcher
            # (every rank's last incarnation: the reborn rank's epoch 2)
            row["elastic"] = {"launches": elastic.get(name, 0)}
        if probe.get(name, 0):
            # [probe]: FusedTrainer(k=8) on the resolved wire and the other
            row["probe"] = {"launches": probe[name]}
        if name == "wire_decode":
            # the flat paths of the other phases, v3 on the card
            row["paths"] = {n: p.get(name, 0) for n, p in (
                ("training", training), ("kstep", kstep), ("io", io),
                ("remote", remote))}
        if name + "_train" in kern:
            # the serving row's numbers, then the same kernel at the
            # training batch's shapes, with the training launches, its
            # floor and (the embed forward) DCNv2's x0 at D = 32
            train = kern[name + "_train"]
            row["training"] = {"launches": training.get(name, 0),
                               **{key: train[key] for key in keys},
                               "floor_ms": train["floor_ms"]}
            if name + "_train_d32" in kern:
                d32 = kern[name + "_train_d32"]
                row["training"]["d32"] = {
                    key: d32[key] for key in keys + ("floor_ms",)}
        if name + "_ffm" in kern:
            # the same kernel at FFM's shape (D = 160, 163,840 segments),
            # with the [ffm] paths' launches
            row["ffm"] = {"launches": ffm.get(name, 0),
                          **{key: kern[name + "_ffm"][key] for key in keys}}
            if "floor_ms" in kern[name + "_ffm"]:
                row["ffm"]["floor_ms"] = kern[name + "_ffm"]["floor_ms"]
        if name + "_cli" in kern:
            # the same kernel at the CLI's FFM defaults (D = 640, F 2^20),
            # which [cli] runs in a process of its own
            row["cli"] = dict(kern[name + "_cli"])
        for case in ("unsorted", "one_row"):
            # the same training batch, entries shuffled or in one row
            if f"{name}_train_{case}" in kern:
                row[f"training_{case}"] = {
                    key: kern[f"{name}_train_{case}"][key] for key in keys}
        rows.append(row)
    log(f"[done] {time.monotonic() - t_start:.1f}s")
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plant", choices=PLANTS, default=None,
                    help="plant a fault on the kernel path and show that "
                         "phase 5's checks catch it")
    ap.add_argument("--serving", action="store_true",
                    help="run the serving phases only (4, 4a, [exporter], "
                         "[incident] and [diagnose])")
    ap.add_argument("--mesh", action="store_true",
                    help="run [mesh] and [probe] only (after phases 1-2)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # [mesh] (b)'s rank processes
    ap.add_argument("--mesh-world", type=int, default=MESH_WORLD,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-data", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-backend", default="gloo",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-nccl", type=int, default=0, metavar="W",
                    help="run [mesh] (b), [tracker] and [elastic] over "
                         "NCCL on W cards, one rank a card, only (after "
                         "phases 1-2)")
    ap.add_argument("--tracker", action="store_true",
                    help="run [tracker] only (after phases 1-2)")
    ap.add_argument("--tracker-worker", action="store_true",
                    help=argparse.SUPPRESS)   # [tracker]'s rank processes
    ap.add_argument("--elastic", action="store_true",
                    help="run [elastic] only (after phases 1-2)")
    ap.add_argument("--elastic-worker", action="store_true",
                    help=argparse.SUPPRESS)   # [elastic]'s rank processes
    args = ap.parse_args()
    try:
        rc = (main_planted(args.plant) if args.plant is not None
              else main_serving() if args.serving
              else main_mesh_rank(args.mesh_rank, args.mesh_world,
                                  args.mesh_port, args.mesh_data,
                                  args.mesh_backend)
              if args.mesh_rank is not None
              else main_tracker_worker(args.mesh_world, args.mesh_data,
                                       args.mesh_backend)
              if args.tracker_worker
              else main_elastic_worker(args.mesh_world, args.mesh_data,
                                       args.mesh_backend)
              if args.elastic_worker
              else main_mesh_nccl(args.mesh_nccl)
              if args.mesh_nccl
              else main_tracker() if args.tracker
              else main_elastic() if args.elastic
              else main_mesh() if args.mesh
              else main())
    except Exception as e:  # noqa: BLE001 — any failed phase fails
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        rc = 1
    sys.exit(rc)
