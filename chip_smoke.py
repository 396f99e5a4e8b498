"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build the port's CUDA kernels from ``photon_ml_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card — kernel 1
   (fixed-effect value+gradient) at 1M x 33 in bf16 and f32, a ragged n and
   d = 1024; kernel 2 (random-effect buckets) at every bucket shape of the
   end-to-end data, a ragged E, S split over blocks (E of 1 and 3, S >
   100k, a whole weight-0 chunk), 10k packed entities of S = 1 and 3, and
   D in {1, 7, 8, 9, 16, 17, 64} (both of its bodies); all four losses,
   weight-0 rows, and bit-identical reruns — and time kernel, plain
   version and the two-pass PyTorch closed form in turns beside the bound
   (bytes / 3.35 TB/s);
3. the main path: ``GameEstimator(device="cuda").fit`` of the end-to-end
   GLMix configuration (fixed effect ``global`` on 32 features + intercept,
   random effects ``perUser`` (40k users) and ``perSong`` (15k songs) on the
   8-wide ``item`` shard, Zipf-skewed entities, 1M rows, bf16 designs, L2
   with lambda 0.001/1/1, L-BFGS, histogram buckets, one sweep), with the
   kernels' launch counts read around it; the GAME model must beat a
   fixed-effect-only model on a held-out draw; kernels 1 and 3 are timed
   at the fixed effect's shape (1M x 33 bf16); the random effects'
   datasets are built by the native bucket packer as index maps only,
   their bucket tensors rebuilt on the card from them and never filled on
   the host (checked after the fit), the index maps held against the
   numpy packer's at the full 1M rows and each bucket's statics against
   that packer's host fill bit for bit in bf16, and the card's rebuild
   of buckets with duplicate (row, feature) entries against the host
   fill;
4. the same fit at 20k rows on the card (kernels) and on the CPU (plain
   versions), which must agree, and on the card again with the resident
   bucket cap lowered so that both random effects stream: that fit must
   equal the resident one bit for bit;
5. kernels 3 (TRON's Hessian-vector product) and 4 (value+gradient for M
   coefficient rows) against their plain versions on the card — kernel 3
   on each of its bodies (narrow: 1M x 33 bf16, 200,003 x 64; wide, held
   in registers: 20k x 128, 50,001 x 100, 200,003 x 1024; streamed:
   20,011 x 8192 and the widest row) with rows of no curvature and huge
   x; kernel 4 in f32 and bf16, all four losses, M in {1, 2, 5, 8, 9, 11,
   16} at d = 1024, {1, 5, 11} at d = 33, 16 at d = 128 and 64 at d = 128
   (kernel 4's narrow and wide bodies), unaligned rows (d = 33, 1025), ragged n, rows
   at and one column below the shared-memory limit of 5 and 11 lanes,
   weight-0 rows with huge x, bit-identical reruns, kernel 4's lanes
   against kernel 1, and kernel 4 at one lane timed against kernel 1 —
   and timed at the GLM path's shape (kernel 4 in f32 and bf16)
   beside their plain versions, the torch.mv / torch.mm two-pass forms and
   the bound;
6. the GLM path at full width: the JAX package's bench GLM configuration
   (``bench.py::_make_problem``: 200k x 1024 dense f32 logistic, 64
   nonzeros a row, column scales over 3 decades; 20k more rows held out),
   L2 with lambda 100;10;1;0.1;0.01, through ``train_glm_sweep`` with TRON
   (maxIter 80) and ``train_glm_sweep_batched`` with L-BFGS (maxIter 50),
   then ``validate_and_select`` by AUC, with the kernels' launch counts
   read around each sweep; at every lambda the optimizer's reported |grad|
   must match the exact f64 gradient at its coefficients within that
   gradient's f32 rounding scale; kernels 1, 3 and 4 timed at this shape
   beside their plain versions and torch.mv / torch.mm two-pass forms;
7. the two sweeps and TRON through ``train_glm_sweep_batched`` at 20k x 128
   (tolerance 1e-4) on the card (kernels) and on the CPU (plain versions):
   the same gradient check on both devices, the f64 objectives at the two
   devices' coefficients within OBJECTIVE_RTOL, AUCs within 1e-4 where
   both converged; kernels 3 and 4 must launch in the batched TRON sweep,
   and kernel 3 is timed at its shape; SIMPLE variances on both;
8. the e2e CLI, from Avro to a model on disk: phase 3's data written to
   two Avro files (``bench.py::_write_e2e_file``'s record layout, null
   codec) and trained through ``photon_ml_tpu_torch.cli.train_game.run``
   with the bench's end-to-end arguments (``bench.py::bench_end_to_end``)
   and the AUC evaluator. The native decoder must have read both files,
   kernels 1 and 2 must have launched, the AUC must be within 1e-4 of
   phase 3's and beat the fixed effect alone, and ``best/``, loaded again
   with the run's index maps and vocabularies, must score the validation
   file to the run's AUC within 1e-6;
9. the GLM command, from Avro to a model directory: phase 6's rows (and
   phase 7's) written to Avro, and a wide sparse file (200k rows, 64
   nonzeros a row over 100,000 columns; 20k x 50,000 for the CPU
   comparison), trained by ``photon_ml_tpu_torch.cli.train_glm.run`` with
   lambda 100;10;1;0.1;0.01 and AUC: TRON (kernels 1 and 3 must launch)
   and batched L-BFGS (kernel 4), which must select phase 6's lambda at
   its AUC within 1e-4; elastic net (alpha 0.5) through OWL-QN,
   sequential (kernel 1) and batched (kernel 4), with exact zeros at the
   largest lambda; and sequential L-BFGS on the sparse file, which must
   launch no kernel and whose contractions must rerun bit for bit. At
   every lambda the reported |grad| (the pseudo-gradient's under elastic
   net) must match the exact f64 one within its f32 rounding scale, and
   ``best/`` must rescore the validation file to the run's AUC within
   1e-6; elastic net at 20k x 128 and the sparse run at 20k x 50,000 on
   the card and on the CPU must agree as phase 7's sweeps do;
10. scoring phase 8's model (``best/`` and the 100k-row validation file):
   (a) ``photon_ml_tpu_torch.cli.score_game.run`` with AUC and the score
   breakdown: the native writer must write ``scores.avro``, the AUC must
   be phase 8's rescored AUC within 1e-6 and the breakdown's totals
   bit-identical to the scores; (b) the online engine
   (``serving.ModelRegistry.load`` on the card, max batch 1024) in f32,
   bf16 and int8 tables: warmup captures 11 CUDA graphs and none follow,
   20,000 records in batches of seeded random sizes from 1 to 1,500 score
   bit-identical to (a) in f32 and within each format's bound in bf16 and
   int8, records naming ids no model saw score as records without ids,
   the table bytes are each format's; (c) ``serve_game``'s HTTP server on
   port 0 with microbatch 64: 8 client threads of at least 250
   single-record POSTs to ``/score`` over loopback, one ``/reload`` of the
   same directory in the middle; no request fails and every reply equals
   (b)'s f32 score. Phase 10 launches none of the four kernels;
11. incremental training on phase 8's run directory and Avro: (a)
   ``refresh_game`` on phase 8's own file solves no entity and retrains
   the fixed effect (kernel 1, no kernel 2) against the random effects'
   scores: every entity's coefficients carry bit for bit, and the fixed
   effect equals, bit for bit, ``train_game --model-input-dir`` phase 8
   ``--locked-coordinates perUser,perSong`` (the same warm-started solve;
   AUC within 1e-4); (b) ``refresh_game`` on day 2 (phase 8's file plus a new
   part of 50,000 rows from other seeds, with users and songs day 1 never
   saw) touches and solves exactly the new part's entities, carries every
   other entity's coefficients bit for bit, and publishes a patch holding
   exactly the solved rows, each equal to its merged-model row (kernels 1
   and 2), new users among them, beside a cold ``train_game`` on day 2 for
   reference; (c)
   ``train_game --model-input-dir`` phase 8 ``--locked-coordinates
   global`` on day 2 keeps ``global`` bit for bit (no kernel 1); (d)
   ``train_game --checkpoint --cd-iterations 2``, then all checkpoints but
   the earliest deleted and ``--resume``: coefficients within rtol 5e-3 /
   atol 1e-3 of the uninterrupted run, AUC within 1e-4; (e) one NaN at
   perUser's step from ``PHOTON_FAULT_PLAN`` under ``--on-divergence
   rollback`` finishes with events detection, rollback, and perUser's
   lambda x10; under ``fail``, in a process of its own, it exits non-zero;
12. the refresh -> serve loop on phase 8's ``best/`` and phase 11 (b)'s
   outputs (its patch, whose ``parentModel`` is phase 8's lineage, and its
   merged model): (a) in f32, bf16 and int8, ``ModelRegistry.load`` of
   phase 8 and ``load_patch`` of the patch: every coordinate's patched
   table and scales equal a build of the merged model row for row by raw
   id, bit for bit (new users appended, carried rows unchanged); phase
   10's 20,000 records score bit-identically through the patched engine
   and the merged model's (in f32 a full ``/reload`` of it); each version
   captures 11 graphs at its warmup and none after; the activation's split
   (reading the patch, ``apply_patch``, the captures) is logged beside the
   full reload's; (b) ``serve_game --watch-dir --reqlog-dir`` on phase 8
   with microbatch 64 and 8 client threads, while a garbage entry, the
   patch and the merged model are published into the watched directory:
   version 3 at the end, 2 applied and 1 rejected, no request failed, each
   reply equal bit for bit to the f32 score of the version it names, and
   after the server stops one logged record per answered request with its
   reply's score, version and lineage; (c) two-phase ``/reload`` on that
   server: the patch refused for its lineage, ``prepare`` that leaves the
   incumbent serving, ``activate``, and ``prepare`` of the patch then
   ``abort``; (d) a second server with ``--max-connections 4``: the fifth
   connection gets the typed 503, counted. Phase 12 launches none of the
   four kernels;
13. the remaining GAME training options through
   ``photon_ml_tpu_torch.cli.train_game.run`` on phase 8's two Avro files
   (1M + 100k rows, 40k users, 15k songs), each run's launches counted:
   (a) elastic net with variances in bf16 (``global`` ELASTIC_NET alpha
   0.5 SIMPLE, its lambda 1000; ``perUser`` ELASTIC_NET alpha 0.7 FULL;
   ``perSong`` L2 SIMPLE): every coordinate's records carry variances in
   the reference layout, each variance of the fixed effect and of 200
   sampled entities per random effect equals its f64 value at the saved
   coefficients (1 / the Hessian diagonal, or the pseudo-inverse's
   diagonal for FULL; the bf16 design rounded as the card used it), the
   two L1 coordinates hold exact zeros, and the AUC beats phase 3's fixed
   effect alone; (b) the RANDOM projector (``perSong``, projectedDim 4)
   and a factored ``perUser`` (projectedDim 2, one factored iteration) in
   f32: kernel 2 runs on the (E, S, 2) and (E, S, 4) buckets,
   ``score_game`` on the back-projected ``best/`` equals the in-memory
   projected model's scores within 1e-6, the AUC beats the fixed effect's;
   (c) ``global`` ``downsample=0.5`` over two sweeps: the weights kernel 1
   saw each sweep equal the host draw's exactly; (d) ``--tuning RANDOM``
   and ``--tuning BAYESIAN --tuning-range 1e-3:1e3``, 4 fits each: the
   best recorded fit is the selected one, ``best/`` rescores to its AUC
   within 1e-6, BAYESIAN's lambdas lie in the range and RANDOM's equal a
   CPU run's bit for bit; (e) ``perUser`` ``cacheBuckets=false``: the
   model records and the AUC equal phase 8's cached run bit for bit; and
   (a), (b) at 20k rows on the card and on the CPU, AUCs within 1e-4;
14. model quality and ranked retrieval, on phase 8's run, phase 9's files,
   phase 10's records and phase 11 (b)'s patch, every launch counted: (a)
   ``train_glm --training-diagnostics`` on phase 9's 200k x 1024 files
   with L-BFGS at phase 6's batched lambda and 16 replicates:
   ``report.html`` with its six sections; every replicate's reported
   |grad| equal to the exact f64 one (with its replicate weights) within
   its f32 rounding scale; the bootstrap and fitting-curve lanes launch
   kernel 1 and never kernel 4; the card's Hosmer–Lemeshow table equal to
   the CPU's on the same probabilities (bins, observed positives;
   expected positives within their f32 summation bound and the
   chi-square within it carried through); at 20k x 128
   with L-BFGS and TRON (kernel 3) on the card and on the CPU on the same
   injected draws, held as phase 9 holds a lambda: replicate, fitting-
   curve and point-model objectives within OBJECTIVE_RTOL, replicate
   solutions within the strong-convexity bound, the AUCs within
   CLI_AUC_TOL where both point solves converged; (b) phase 8's ``quality-baseline.json`` equal to
   ``compute_baseline`` recomputed on the CPU from phase 10 (a)'s saved
   scores and breakdown; (c) ranking ``perSong`` (14,998 items) in f32,
   bf16 and int8: 32 captures at warmup and none after, 32 users' ids
   and scores at k 1, 10 and 128 equal to the engine's scores of every
   (user, song) pair sorted stably (bf16 and int8 also within
   ``quant_bounds`` of the f32 pair scores), phase 11 (b)'s patch
   activated with no capture and ranking its own tables, ``/rank`` under
   8 clients (p50, p99, every reply the registry's); (d) under the canary
   gate the negated-``perSong`` candidate refused (incumbent version,
   scores and captures unchanged), then the patch activated with its
   divergence recorded; (e) the drift evaluator's PSI on phase 10's
   records below the threshold, and above it with one feature shifted,
   with ``quality_drift_detected`` posted;
15. multi-process training and scoring, two gloo ranks sharing the card:
   (a) the distributed objective at phase 6's 200k x 1024 against one
   process's kernels 1 and 3, and over NCCL at world size 1 (bit-identical
   to one process); (b) ``train_glm --multihost`` on phase 9's dense
   files (``MP_GLM_RUNS``) against one process: ranks bit-identical, the
   gradient check, objectives within OBJECTIVE_RTOL, coefficients within
   the JAX package's tolerance where both sides converged; (c)
   ``train_game --multihost`` and (d) ``score_game --multihost`` against
   phases 8 and 10 (a); (e) ``train_game --supervise 2`` on phase 8's
   files with rank 1 killed at sweep 1: a restart, and the records of an
   uninterrupted supervised run;
16. the entity-sharded serving fleet on phase 8's run, phase 10's
   records and phase 11's day 2: (a) ``serve_fleet --fleet-shards 4``:
   the hosts' perUser and perSong rows disjoint, their union the
   unsharded table bit for bit, each host's table bytes ~1/4; (b) the
   20,000 records through the router's ``/score`` bit-identical to one
   unsharded host, records crossing shards among them (the router's
   margin merge), and through the unsharded engine and one host's at
   every bucket size 1 .. 1024 bit for bit; (c) a ``global`` +
   ``perSong`` model trained on phase 8's files, ranked by a fleet: ids
   and scores of ``/rank`` equal to the unsharded ranking's; (d)
   ``refresh_game --fleet-shards 4`` on day 2 (kernels 1 and 2): the
   shard patches partition the touched set, a host refuses another
   shard's patch, the router's two-phase ``/reload`` of the set
   activates one lineage everywhere (a host the refresh did not touch
   captures nothing), the patched fleet scores as the merged model does
   unsharded, bit for bit; bf16 and int8 fleets (``python -m
   photon_ml_tpu_torch serve_fleet`` processes, started with the phase
   and loading beside it) within ``quant_bounds`` before and after the
   same set comes through ``--router-watch-dir``, and refusing ``/rank``
   for phase 8's model (perUser); the patched
   fleet refuses a reshard; (e) ``/reshard`` on (c)'s fleet: an injected
   refusal keeps the incumbent map, 64 buckets moved and
   ``ShardMap.rebalanced`` after, only those buckets' rows moving and
   every score bit for bit; (g) p50 and p99 under 8 clients at a fixed
   rate of the router with its hosts in its process, of one host, and of
   a router over ``serve_game --fleet-shard`` processes (their scores
   checked); (f) 2 shards x 2 replicas: a stopped
   replica is a retry, a ``fleet.replica`` fault exhausting the group a
   typed 503 ``reason=upstream`` with ``Retry-After``, a spent deadline a
   429 ``reason=deadline``;
17. the live telemetry plane: (a) phase 8's ``train_game`` again with
   ``--telemetry-dir --telemetry-poll-s 0.5 --metrics-port``, ``GET
   /metrics`` scraped while it trains: the AUC, ``best/``'s coefficient
   records and kernels 1 and 2's launches equal phase 8's; ``trace.jsonl``
   has one ``train_game`` root and every span inside its parent, one
   ``cd.sweep`` and one ``cd.step`` a coordinate; every stage is a span
   and in ``photon_stage_seconds``;
   ``photon_bytes_accessed_total{fn="game.fixed_effect"}`` (and the
   flops) equal kernel 1's count function times its launches; the device
   memory gauges lie in (0, the card's memory]; ``photon_build_info``;
   its wall beside phase 8's; (b) phase 9's TRON ``train_glm`` again at
   its first lambda with ``--profile --debug-nans --telemetry-dir``: its
   coefficients phase 9's (else its f64 objective within
   OBJECTIVE_RTOL), the Chrome
   trace naming the kernels of ``csrc/fused_glm.cu`` and
   ``csrc/fused_hvp.cu``, the device's busy share of the profiled stage;
   (c) ``train_game --debug-nans`` at SMALL's 20k rows with a NaN at
   perUser's step (the ``optimizer.step`` fault site) raises with a
   ``FloatingPointError`` as the divergence guard's cause and writes no
   ``best/``; a NaN reaching kernels 1, 2 and 3 on the card raises a
   ``FloatingPointError`` naming the kernel and its shape; (d)
   ``serve_game`` on phase 8's ``best/`` with and without
   ``--telemetry-dir`` under 300 of phase 10's records in a batch and 40
   single ones: the replies bit-identical, 11 captures counted in
   ``photon_compiles_total{fn="serving.score"}`` = the engine's
   ``compile_count``, and a ``serving.request`` / ``serving.score`` span a
   request. (Phase 3's profiled second fit was cut to make room: the
   script's limit is 1,200 s.)
18. the retained telemetry plane on phase 8's ``best/``, with seven
   ``serve_game`` processes started first: (a) a manual flight dump of an
   in-process ``serve_game --flight-dir``; one process with
   ``--history-capacity --history-period-s 0.25 --flight-dir
   --watchdog-timeout-s`` against one without, under batches and single
   records from 4 threads while ``/history`` and ``/metrics`` are
   scraped: the replies bit-identical, 11 captures before and after, the
   ring's ``requests`` summing to the requests sent and its
   ``duty_cycle`` in [0, 1]; a ``/reload`` its fault plan trips
   (``serving.reload``) and SIGTERM each leave one whole dump, no
   ``.tmp``, each rendered by ``tools/postmortem.py``; (b) a router with
   the plane (``cli/serve_fleet.py::arm_router_plane``) over 4
   ``serve_game --fleet-shard`` processes: its scores those of the host
   without the plane, its newest ``/history?raw=1`` row the
   ``tools/metrics_fold.py`` fold of its own newest snapshot and the
   rings it scraped, a cool ``/advisor``; then over the same with shard 0
   served by a host whose scoring calls a fault plan stalls 0.05 s:
   shard 0 latched at exactly the third hand tick, and ``/advisor``'s
   move list ``ShardMap.rebalanced``'s. The host's and the router's
   p50/p99 with the plane print beside phase 16's. Phases 8 and 9 write
   their Avro with an encoder of their record shapes, held byte for byte
   against the port's writer;
19. background publication and the closed feedback loop: (a) phase 8's
   ``best/``, published by the background saver, equal to a synchronous
   ``save_game_model`` of the same in-memory model (part files byte for
   byte but for their sync markers, the metadata, the lineage id; checked
   at the end of phase 8, where the model is at hand), with "Save models"
   (now the saver's join) beside the synchronous save's wall; phase 17
   (a)'s trace of phase 8's run: ``io.save.model``, ``io.save.part``,
   ``io.read.validation`` and the other background spans under their
   stages, and their async I/O overlap as ``tools/perf_report.py``'s
   section defines it (computed here, held equal to the tool's on the
   CPU); ``train_game`` at SMALL's 20k rows under a
   ``PHOTON_FAULT_PLAN`` on ``io.model_save`` at visit 0: the fault fired
   once, ``best/`` loads, no ``.tmp``; (b) ``serve_fleet --fleet-shards 2
   --reqlog-dir --autopilot-config --router-watch-dir`` (poll 0.2 s,
   warmup on) in this process on phase 8's run: 64 client-stamped
   one-record requests of shard 0's users and songs, a label CSV with a
   late row, ``quality_drift_detected`` for ``perUser``: one refresh, no
   abort; joined 64, late 1, unjoined 0; ``solved`` perUser = the users
   sent, perSong 0, perSong carried bit for bit; the refresh's launches of
   kernels 1 and 2 counted; the watcher activating the per-shard set on
   both hosts, host 1 (an empty patch) capturing no graph; the router's
   scores of the 64 records = ``score_game`` of the published run, bit for
   bit; a partial ``patch-shard-0`` refused with versions and a probe's
   score unchanged; ``join_feedback`` over both hosts' logs with
   ``--prior-dir``: the autopilot's counts and a ``delta``; the freshness
   lag (drift event to both hosts active) printed.
20. one process over several slots (``--mesh``), every slot on ``cuda:0``
   (this machine has one card; copies between cards are no-ops here): (a)
   phase 3's fit on ``make_mesh({"data": 2, "entity": 2})``, held after
   phase 3 to its unsharded fit (fixed-effect coefficients, its and the
   model's validation scores within MESH_FIT_ATOL, the gaps printed, the
   AUC beside phase 3's), kernel 1's launches = 2 blocks x the fixed
   effect's evaluations; (b) ``{"entity": 4}`` solves of phase 3's widest
   and head ``perUser`` buckets equal to the unsharded solves bit for bit,
   coefficients and scores; (c) in phase 6, on 4 slots at 200k x 1024
   f32, at phase 15 (a)'s coefficients and direction: the data-axis
   and the feature-axis objectives' value, gradient and Hvp against the
   unsharded kernels within KERNEL_RTOL, and one sharded L-BFGS solve at
   lambda 1 against the unsharded one (the f64 objectives within
   OBJECTIVE_RTOL); (d) after phase 13, ``train_game --mesh
   data=1,entity=1`` at SMALL's 20k rows: records and AUC equal the run
   without ``--mesh``, and ``--mesh data=2`` refused ("needs 2 devices,
   have 1"); (e) in phase 14 (c), phase 8's ``perSong`` index spread over
   ``{"entity": 4}`` ranks the 32 users with ids and scores equal to the
   unsharded index's. Each part's launches are counted around it.
21. the port's lint: ``python -m photon_ml_tpu_torch.analysis --json``
   over the checkout as shipped, in a process of its own on the card's
   host (``photon_ml_tpu_torch/`` and the root scripts, every rule): it
   must exit 0 (no finding); the files, rules and suppressions it counted
   and its wall are printed. It launches no kernel.

``python3 chip_smoke.py --mp-gap-seeds 0,1,2`` runs phase 15 (b) alone
over seeds of phase 6's problem and prints its gaps.

Any failure exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the ``kernels``
summary. Data and coefficients are random, made from fixed seeds.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
#: kernel vs plain version: both sum the same f32 products, in another order
KERNEL_RTOL = 1e-5
#: kernels 3 and 4 with a bf16 design vs their plain versions: both round
#: d2w·t (kernel 3) or wt·d1 (kernel 4) to bf16, and where the kernel's and
#: the plain version's f32 inputs to that rounding differ in the last bit
#: (another summation order of the margin) the term lands on the other bf16
#: neighbour, 2^-8 apart; at 5*10^4-10^5 rows such flips moved a gradient
#: by up to 1.4e-5 of its scale on an H100.
BF16_RTOL = 1e-4
#: kernel 4's lanes vs kernel 1 with a bf16 design: the two kernels sum a
#: margin in different orders, so their wt·d1 roundings flip the same way;
#: at 10^5 rows such flips moved a lane by 1.40e-5, 1.59e-5 and 2.08e-5 of
#: its gradient's scale on an H100 (PERF.md §2), about half this limit.
#: With an f32 design the lanes are held to kernel 1 at KERNEL_RTOL.
K4_VS_K1_BF16_RTOL = 4e-5
GLM = dict(rows=200_000, valid_rows=20_000, dim=1024, nnz=64)
GLM_LAMBDAS = [100.0, 10.0, 1.0, 0.1, 0.01]
GLM_TRON_MAX_ITER = 80
GLM_LBFGS_MAX_ITER = 50
GLM_SMALL = dict(rows=20_000, valid_rows=4_000, dim=128, nnz=8)
GLM_SMALL_TOLERANCE = 1e-4
#: card vs CPU at 20k x 128: the f64 objective at the two devices'
#: coefficients, relative — where both solves converged, and where either
#: stopped on the iteration cap or the radius rule, which lets the two f32
#: trajectories drift apart (set from the readings recorded in PERF.md: at
#: most 1.5e-7 and 1.2e-4 on an H100)
OBJECTIVE_RTOL = {True: 1e-6, False: 5e-4}
E2E = dict(rows=1_000_000, users=40_000, songs=15_000, valid_rows=100_000)
E2E_MAX_ITER = 25
SMALL = dict(rows=20_000, users=40_000, songs=15_000, valid_rows=5_000)
SMALL_MAX_ITER = 100


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------
# data: the end-to-end GLMix distribution, generated in memory
# --------------------------------------------------------------------------

def make_e2e(tg, rows, users, songs, valid_rows, seed=99, draw_seeds=None):
    """Music-shaped data: a global bag (6 of 32 features, plus an
    intercept column), an item bag (4 of 8 features), Zipf user and song
    ids, labels from a logistic model of planted fixed, per-user and
    per-song effects. Returns (train, validation) GameData, drawn from
    generators seeded ``draw_seeds`` (default ``seed + 1``, ``seed + 2``)."""
    prm = np.random.default_rng(seed)
    d_fixed, d_item = 32, 8
    w_fixed = prm.normal(size=d_fixed)
    uu = prm.normal(size=(users, d_item))
    us = 0.7 * prm.normal(size=(songs, d_item))
    pu = 1.0 / np.arange(1, users + 1)
    pu /= pu.sum()
    ps = 1.0 / np.arange(1, songs + 1)
    ps /= ps.sum()

    def draw(n, rng):
        user = rng.choice(users, size=n, p=pu)
        song = rng.choice(songs, size=n, p=ps)
        fi = rng.random((n, d_fixed)).argsort(axis=1)[:, :6]
        fv = rng.normal(size=(n, 6))
        ii = rng.random((n, d_item)).argsort(axis=1)[:, :4]
        iv = rng.normal(size=(n, 4))
        margin = ((w_fixed[fi] * fv).sum(1) / np.sqrt(6)
                  + (np.take_along_axis(uu[user], ii, 1) * iv).sum(1)
                  + (np.take_along_axis(us[song], ii, 1) * iv).sum(1))
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin)))
        # global shard: the 6 drawn features and the intercept (column 32)
        g_cols = np.concatenate([fi, np.full((n, 1), d_fixed)], axis=1)
        g_vals = np.concatenate([fv, np.ones((n, 1))], axis=1)
        rows7 = np.repeat(np.arange(n), 7)
        rows4 = np.repeat(np.arange(n), 4)
        shards = {
            "global": tg.FeatureShard.from_coo(
                rows7, g_cols.ravel(), g_vals.ravel(), n, d_fixed + 1),
            "item": tg.FeatureShard.from_coo(
                rows4, ii.ravel(), iv.ravel(), n, d_item),
        }
        return tg.GameData.build(labels=y.astype(np.float32), shards=shards,
                                 id_columns={"userId": user, "songId": song})

    s_train, s_valid = draw_seeds or (seed + 1, seed + 2)
    return draw(rows, np.random.default_rng(s_train)), \
        draw(valid_rows, np.random.default_rng(s_valid))


def e2e_estimator(tg, device, max_iter, sequence=("global", "perUser",
                                                  "perSong"), mesh=None):
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import TaskType

    opt = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=max_iter))

    def random(entity):
        return RandomEffectCoordinateConfig(
            dataset=tg.RandomEffectDatasetConfig(
                entity, "item", bucket_strategy="histogram",
                max_sample_buckets=4),
            optimization=opt, design_dtype="bfloat16")

    coords = {"global": FixedEffectCoordinateConfig(
        "global", opt, design_dtype="bfloat16"),
        "perUser": random("userId"), "perSong": random("songId")}
    return tg.GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={k: coords[k] for k in sequence},
        update_sequence=list(sequence), n_cd_iterations=1, device=device,
        mesh=mesh)


E2E_LAMBDAS = {"global": 0.001, "perUser": 1.0, "perSong": 1.0}
#: the CLI's AUC vs phase 3's in-memory fit of the same rows: only the
#: column order (the sorted index map) and the entity order (first-seen
#: vocabularies) differ, the limit of the GAME card-vs-CPU check
CLI_AUC_TOL = 1e-4
#: best/ reloaded and rescored vs the run's own validation AUC
RELOAD_AUC_TOL = 1e-6


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call over ``reps`` back-to-back calls, between
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns, reps=20):
    """{name: mean ms} for the callables of ``fns``, each timed by
    :func:`time_ms` in turns, in order and then in reverse (a, b, c, c, b,
    a), so drift of the shared host or the card's clocks falls on all."""
    out = {k: 0.0 for k in fns}
    for k in [*fns, *reversed(fns)]:
        out[k] += time_ms(fns[k], reps=reps) / 2
    return out


def captured(fn, calls=20):
    """``calls`` calls of ``fn`` captured in one CUDA graph; returns its
    replay. Replayed between CUDA events, it times the device work of a
    call without the host work around its launches (a wrapper's checks,
    allocations and ctypes call), which can exceed a short kernel."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def roofline_ms(nbytes, ops):
    """(least ms, what binds): bytes over the HBM rate or f32 operations
    over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_ms(n_live, n_rows, d, itemsize, n_out, lanes=1):
    """Least time for one evaluation of kernel 1, 2 or 4: the bytes and
    operations of ``ops/fused_glm.py::work`` (the count the telemetry
    plane sums per profiled call) over the HBM and f32 rates."""
    from photon_ml_tpu_torch.ops import fused_glm

    w = fused_glm.work(n_live, n_rows, d, itemsize, n_out, lanes=lanes)
    return roofline_ms(w.nbytes, w.ops)


def hvp_bound_ms(n_live, n_rows, d, itemsize):
    """Least time for one Hessian-vector product of kernel 3:
    ``ops/fused_hvp.py::work`` over the HBM and f32 rates."""
    from photon_ml_tpu_torch.ops import fused_hvp

    w = fused_hvp.work(n_live, n_rows, d, itemsize)
    return roofline_ms(w.nbytes, w.ops)


# --------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------------

def _labels(loss, shape, gen):
    if loss.name == "poisson":
        return torch.poisson(torch.full(shape, 1.5, device="cuda"),
                             generator=gen)
    if loss.name == "squared":
        return torch.randn(shape, device="cuda", generator=gen)
    return (torch.rand(shape, device="cuda", generator=gen) < 0.5).float()


def _max_err(got, want):
    """(max |kernel - plain|, the largest error relative to its own scale).
    The value is held against max(1, |plain value|), per entity for kernel
    2; the gradient against max(1, max |plain gradient|) over its row — the
    whole gradient for kernel 1, each entity's for kernel 2 — so a value of
    ~10^5 never hides a gradient error."""
    (gv, gg), (wv, wg) = got, want
    dv, dg = (gv - wv).abs(), (gg - wg).abs()
    rel_v = dv / wv.abs().clamp_min(1.0)
    rel_g = dg / wg.abs().amax(-1, keepdim=True).clamp_min(1.0)
    return (max(float(dv.max()), float(dg.max())),
            max(float(rel_v.max()), float(rel_g.max())))


#: (n, d, dtypes) of kernel 1 vs its plain version: the paths' widths (33,
#: 1024) with a ragged row count, and streamed rows (8192)
GLM_CHECK_SHAPES = [(1_000_000, 33, (torch.bfloat16, torch.float32)),
                    (1_000_003, 33, (torch.bfloat16,)),
                    (100_003, 1024, (torch.float32, torch.bfloat16)),
                    (20_011, 8192, (torch.float32,))]
#: the rest of kernel 1's bodies: narrow rows of other odd and even widths
#: (8, 64), and wide rows held in registers 8 columns a lane (phase 7's 20k
#: x 128; 100 columns, not a multiple of 32)
GLM_BODY_SHAPES = [(1_000_000, 8, (torch.bfloat16,)),
                   (200_003, 64, (torch.bfloat16,)),
                   (20_000, 128, (torch.float32, torch.bfloat16)),
                   (50_001, 100, (torch.float32,))]


def check_glm(fused_glm, losses, shapes, gen):
    """Kernel 1 vs its plain version at ``shapes`` ``(n, d, dtypes)``;
    returns the largest relative error (:func:`_max_err`)."""
    worst = 0.0
    for n, d, dtypes in shapes:
        for dt in dtypes:
            x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
            # margins of O(1) at every width
            w = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
            off = 0.1 * torch.randn(n, device="cuda", generator=gen)
            wt = torch.rand(n, device="cuda", generator=gen)
            wt[::9] = 0.0  # weight-0 (padding) rows
            x[9] = 300.0  # padded: exp() of its margin would overflow
            for loss in losses:
                y = _labels(loss, (n,), gen)
                args = (loss, x, w, y, off, wt)
                got = fused_glm.fused_value_and_grad(*args)
                again = fused_glm.fused_value_and_grad(*args)
                want = fused_glm.fused_value_and_grad_plain(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"kernel 1 not bit-identical on rerun: {n}x{d} {dt}"
                err, rel = _max_err(got, want)
                assert rel <= KERNEL_RTOL, (n, d, dt, loss.name, err, rel)
                assert all(torch.isfinite(t).all() for t in got)
                worst = max(worst, rel)
                log(f"  kernel1 n={n} d={d} {str(dt)[6:]} {loss.name}: "
                    f"max_abs_err={err:.3e} rel={rel:.2e} rerun identical")
            del x
    return worst


def check_re(fused_re, losses, shapes, gen):
    """Kernel 2 vs its plain version at every bucket shape; returns the
    largest relative error (:func:`_max_err`). With more than one entity
    the first is all weight-0; where the plan splits S, one whole chunk of
    the last entity is weight-0 too."""
    worst = 0.0
    for e, s, d in shapes:
        plan = fused_re.entity_plan(e, s, d)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(e, s, d, device="cuda", generator=gen).to(dt)
            w = torch.randn(e, d, device="cuda", generator=gen) / math.sqrt(d)
            off = 0.1 * torch.randn(e, s, device="cuda", generator=gen)
            wt = (torch.rand(e, s, device="cuda", generator=gen) > 0.3).float()
            if e > 1:
                wt[0] = 0.0  # an all-dead entity
            if plan.chunks > 1:  # a whole dead chunk
                wt[-1, plan.chunk_rows:2 * plan.chunk_rows] = 0.0
            x[-1, 0] = 300.0
            wt[-1, 0] = 0.0  # a padded row that would overflow exp()
            for loss in losses:
                y = _labels(loss, (e, s), gen)
                args = (loss, x, w, y, off, wt)
                got = fused_re.fused_entity_value_and_grad(*args)
                again = fused_re.fused_entity_value_and_grad(*args)
                want = fused_re.fused_entity_value_and_grad_plain(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"kernel 2 not bit-identical on rerun: {(e, s, d)} {dt}"
                if e > 1:
                    assert float(got[0][0]) == 0.0 and not got[1][0].any()
                err, rel = _max_err(got, want)
                assert rel <= KERNEL_RTOL, (e, s, d, dt, loss.name, err, rel)
                worst = max(worst, rel)
            log(f"  kernel2 E={e} S={s} D={d} {str(dt)[6:]} (chunks "
                f"{plan.chunks} x {plan.chunk_rows} rows, {plan.unit_threads}"
                f" threads a unit, {plan.blocks} blocks) 4 losses: last "
                f"max_abs_err={err:.3e} rel={rel:.2e}, rerun identical")
            del x
    return worst


#: kernel 2's plan paths beyond the e2e buckets: S split over blocks (E of
#: 1 and 3, S not a multiple of the chunk), many packed small-S entities,
#: and both bodies (D <= 16 one thread per row, wider the row groups)
RE_PLAN_SHAPES = ([(1, 100_003, 8), (3, 100_001, 8), (10_000, 1, 8),
                   (10_000, 3, 8)]
                  + [(3, 100_001, d) for d in (1, 7, 9, 16, 17, 64)]
                  + [(10_000, 3, d) for d in (1, 7, 9, 16, 17, 64)])


def glm_closed_form_library(loss, x, w, y, off, wt):
    """Two-pass PyTorch closed form (torch.mv), the yardstick the port never
    calls: margins, loss and derivative, then the transposed product."""
    m = torch.mv(x, w.to(x.dtype)).float() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    value = torch.where(live, wt * loss.loss(m, y), torch.zeros_like(m)).sum()
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return value, torch.mv(x.t(), dvec.to(x.dtype)).float()


def re_closed_form_library(loss, x, w, y, off, wt):
    """Two-pass PyTorch closed form (torch.bmm) for an entity bucket."""
    m = torch.bmm(x, w.to(x.dtype)[:, :, None])[:, :, 0].float() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    values = torch.where(live, wt * loss.loss(m, y),
                         torch.zeros_like(m)).sum(1)
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return values, torch.bmm(dvec.to(x.dtype)[:, None, :], x)[:, 0].float()


def time_glm(fused_glm, loss, x, w, labels, weights):
    """Kernel 1 at one of the main path's shapes (the e2e design, or the GLM
    design at a TRON solution): kernel, plain version and torch.mv two-pass
    form timed in turns."""
    n, d = x.shape
    off = torch.zeros(n, device="cuda")
    args = (loss, x, w, labels, off, weights)
    err, rel = _max_err(fused_glm.fused_value_and_grad(*args),
                        fused_glm.fused_value_and_grad_plain(*args))
    assert rel <= KERNEL_RTOL, ("kernel1 at a path's shape", n, d, err, rel)
    calls = 20
    t = time_turns({
        "ms": lambda: fused_glm.fused_value_and_grad(*args),
        "device_ms": captured(lambda: fused_glm.fused_value_and_grad(*args),
                              calls),
        "plain_ms": lambda: fused_glm.fused_value_and_grad_plain(*args),
        "library_ms": lambda: glm_closed_form_library(*args)})
    t["device_ms"] /= calls
    n_live = int((weights > 0).sum())
    b, by = bound_ms(n_live, n, d, x.element_size(), 1)
    log(f"  kernel1 {n}x{d} {str(x.dtype)[6:]}: kernel {t['ms']:.4f} ms "
        f"({t['device_ms']:.4f} ms of device time, in a CUDA graph), plain "
        f"{t['plain_ms']:.4f} ms, torch.mv two-pass {t['library_ms']:.4f} "
        f"ms, bound {b:.4f} ms ({by}); max_abs_err vs plain {err:.3e}")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} {str(x.dtype)[6:]}", **t)


def time_re(fused_re, loss, buckets):
    """Kernel 2 at every bucket of the main path (the e2e buckets of both
    random effects, as the solver uploads them): one evaluation of each,
    kernel, its device time (:func:`captured`), plain version and
    torch.bmm form timed in turns per bucket, then summed."""
    tot = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               library_ms=0.0, bound_ms=0.0, bound_by="bytes")
    for st in buckets:
        x = st.x
        e, s, d = x.shape
        w = 0.01 * torch.ones(e, d, device="cuda")
        off = torch.zeros(e, s, device="cuda")
        args = (loss, x, w, st.labels, off, st.weights)
        err, rel = _max_err(fused_re.fused_entity_value_and_grad(*args),
                            fused_re.fused_entity_value_and_grad_plain(*args))
        assert rel <= KERNEL_RTOL, ("kernel2 on an e2e bucket", err, rel)
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        calls = 20
        t = time_turns({
            "ms": lambda: fused_re.fused_entity_value_and_grad(*args),
            "device_ms": captured(
                lambda: fused_re.fused_entity_value_and_grad(*args), calls),
            "plain_ms": lambda: fused_re.fused_entity_value_and_grad_plain(
                *args),
            "library_ms": lambda: re_closed_form_library(*args)}, reps=10)
        t["device_ms"] /= calls
        n_live = int((st.weights > 0).sum())
        work = fused_re.work(n_live, e, s, d, x.element_size())
        b, by = roofline_ms(work.nbytes, work.ops)
        if by == "operations":
            tot["bound_by"] = by
        plan = fused_re.entity_plan(e, s, d)
        log(f"  kernel2 E={e} S={s} D={d} live rows={n_live} ({plan.chunks}"
            f" chunks, {plan.blocks} blocks): kernel {t['ms']:.4f} ms "
            f"({t['device_ms']:.4f} ms of device time, in a CUDA graph), "
            f"plain {t['plain_ms']:.4f} ms, torch.bmm closed form "
            f"{t['library_ms']:.4f} ms, bound {b:.5f} ms ({by})")
        t["bound_ms"] = b
        for k, v in t.items():
            tot[k] += v
    tot["shape"] = f"sum over {len(buckets)} e2e buckets"
    return tot


def sweep_reads(reads):
    """A :class:`Patched` wrap of ``RandomEffectSolver.train`` adding each
    call's host reads (``optimize/common.py::drive.reads``: one a device a
    round of the lockstep driver) to ``reads[coordinate]``."""
    from photon_ml_tpu_torch.optimize.common import drive

    def wrap(train):
        def wrapper(self, dataset, *a, **kw):
            r0 = drive.reads
            out = train(self, dataset, *a, **kw)
            cid = dataset.coordinate_id
            reads[cid] = reads.get(cid, 0) + drive.reads - r0
            return out
        return wrapper
    return wrap


def timed_warm(walls):
    """A :class:`Patched` wrap of ``RandomEffectSolver._warm_compile`` (the
    background build ``GameEstimator.prepare`` starts a thread for)
    recording its wall by coordinate."""
    def wrap(warm):
        def wrapper(self, dataset, *a, **kw):
            t0 = time.perf_counter()
            warm(self, dataset, *a, **kw)
            walls[dataset.coordinate_id] = time.perf_counter() - t0
        return wrapper
    return wrap


def compare_fused_looped(tg, est, datasets, train, valid, fused, evaluators,
                         fused_launches, fused_reads):
    """Phase 3's fit again on the same datasets through the per-bucket
    loop (the solver's fused path turned off for the call): coefficients,
    validation scores, AUC and kernel launches must equal the fused
    sweep's bit for bit; prints both random-effect walls and host reads
    per coordinate."""
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver

    reads = {}
    with Patched(RandomEffectSolver, "_fused_eligible",
                 lambda fn: lambda self, dataset: False), \
            Patched(RandomEffectSolver, "train", sweep_reads(reads)):
        looped, wall, launches = counted_call(lambda: est.fit(
            train, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
            validation=(valid, evaluators), datasets=datasets)[0])
    same = {}
    for cid, a in fused.model.coordinates.items():
        b = looped.model.coordinates[cid]
        if isinstance(a, tg.FixedEffectModel):
            same[cid] = _same_bits(a.model.coefficients.means,
                                   b.model.coefficients.means)
        else:
            same[cid] = (np.array_equal(a.keys, b.keys) and np.array_equal(
                a.coeffs.view(np.int32), b.coeffs.view(np.int32)))
    sf, sl = fused.model.score(valid), looped.model.score(valid)
    same_scores = np.array_equal(sf.view(np.int32), sl.view(np.int32))
    auc_f, auc_l = fused.evaluation.primary[1], looped.evaluation.primary[1]
    walls_f = {cid: sec for _, cid, sec in fused.step_seconds}
    walls_l = {cid: sec for _, cid, sec in looped.step_seconds}
    launches = {k: launches[k] for k in fused_launches}
    log(f"[3] the same fit through the per-bucket loop: {wall:.2f} s; "
        f"bit for bit: coefficients {same}, validation scores "
        f"{same_scores}, AUC {auc_l!r} ({auc_l == auc_f}); launches "
        f"{launches} (fused {fused_launches})")
    for cid in ("perUser", "perSong"):
        log(f"  {cid}: wall fused {walls_f[cid]:.3f} s, loop "
            f"{walls_l[cid]:.3f} s; host reads fused {fused_reads[cid]}, "
            f"loop {reads[cid]}")
    assert all(same.values()) and same_scores and auc_l == auc_f, (
        same, same_scores, auc_l, auc_f)
    assert launches == fused_launches, (launches, fused_launches)
    for cid in ("perUser", "perSong"):
        assert fused_reads[cid] < reads[cid], (cid, fused_reads, reads)


def compare_bucket_solves(tg, data, lam):
    """Card (kernel 2) vs CPU (plain version): one L-BFGS solve of every
    perUser bucket of ``data`` from zero, on identical inputs (zero
    offsets), the main path's bf16 design. A lane's objective f is strongly
    convex with modulus mu (the smallest eigenvalue of its Hessian over the
    lane's features, >= l2), so a lane that stopped at w lies within
    |grad f(w)| / mu of the optimum, and the devices' lanes within
    (|grad f(w_cuda)| + |grad f(w_cpu)|) / mu of each other. Gradients and
    Hessians are taken exactly, in f64 on the CPU; mu at the CPU's solution
    stands for the segment between the two (they end ~1e-4 apart, where
    the logistic curvature moves by less than the 1e-3 allowed for it).
    Asserts that per lane and prints the tightest lane's iterations, stop
    and gradient on both devices. Returns the largest bound: how far apart
    two f32 solves of one lane may end."""
    from photon_ml_tpu_torch.glm.problem import OptimizationProblem
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective

    est = e2e_estimator(tg, "cpu", SMALL_MAX_ITER, ("perUser",))
    cfg = est.coordinate_configs["perUser"].optimization
    problem = OptimizationProblem(GLMObjective(loss=LogisticLoss), cfg)
    l2 = cfg.regularization.l2_weight(lam)
    reach = worst = 0.0
    for b in est.prepare(data)["perUser"].buckets:
        e, s, d = b.tensor_shape

        def glm_data(device, dtype):
            # the main path's bf16 design; f64 holds its values exactly
            x = torch.as_tensor(b.x, device=device).to(torch.bfloat16)
            return GLMData(
                design=DenseDesign(x=x if dtype == torch.float32
                                   else x.to(dtype)),
                labels=torch.as_tensor(b.labels, device=device).to(dtype),
                offsets=torch.zeros((e, s), dtype=dtype, device=device),
                weights=torch.as_tensor(b.weights, device=device).to(dtype))

        res = {dev: problem.run(glm_data(dev, torch.float32),
                                torch.zeros((e, d), device=dev), lam)
               for dev in ("cuda", "cpu")}
        exact = glm_data("cpu", torch.float64)
        w = {dev: r.w.cpu().double() for dev, r in res.items()}
        gn = {dev: torch.linalg.vector_norm(problem.objective.value_and_grad(
            w[dev], exact, l2)[1], dim=-1) for dev in w}
        # the Hessian at w_cpu over the lane's kept features: padded
        # columns are 0 in both solutions, so they are left out
        x, live = exact.design.x, exact.weights > 0
        m = torch.where(live, torch.einsum("esd,ed->es", x, w["cpu"]), 0.0)
        d2w = torch.where(live, exact.weights * LogisticLoss.d2(
            m, exact.labels), 0.0)
        pad = torch.as_tensor(b.feature_index < 0).double()
        hess = (torch.einsum("es,esd,esf->edf", d2w, x, x)
                + torch.diag_embed(l2 + 1e30 * pad))
        mu = torch.linalg.eigvalsh(hess)[:, 0] * (1 - 1e-3)
        bound = (gn["cuda"] + gn["cpu"]) / mu
        gap = torch.linalg.vector_norm(w["cuda"] - w["cpu"], dim=-1)
        k = int((gap / bound.clamp_min(1e-300)).argmax())
        c, p = res["cuda"], res["cpu"]
        log(f"  bucket {e}x{s}x{d}: max |w_cuda - w_cpu| {float(gap.max()):.3e}"
            f", max bound {float(bound.max()):.3e}; tightest lane: gap "
            f"{float(gap[k]):.3e} <= {float(bound[k]):.3e}, iterations "
            f"{int(c.iterations[k])}/{int(p.iterations[k])}, converged "
            f"{bool(c.converged[k])}/{bool(p.converged[k])}, |grad f| "
            f"{float(gn['cuda'][k]):.2e}/{float(gn['cpu'][k]):.2e}, mu "
            f"{float(mu[k]):.3g} (cuda/cpu)")
        assert bool((gap <= bound).all()), (e, s, d)
        reach = max(reach, float(bound.max()))
        worst = max(worst, float(gap.max()))
    log(f"[4] per-bucket solves, card vs CPU: largest lane gap {worst:.3e}, "
        f"largest bound {reach:.3e}")
    return reach


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as integers)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int16 if a.element_size() == 2 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


STATICS_FIELDS = ("x", "labels", "weights", "gather_idx", "slots", "rows")


def check_compact_buckets(tg, est, datasets, train, device="cuda"):
    """Phase 3's random-effect buckets after the fit: still index maps
    only on the host; the native packer's index maps equal the numpy
    packer's at the full 1M rows; each bucket's statics, rebuilt on the
    card from the index maps, equal the numpy packer's host fill uploaded
    (the solver's other path) bit for bit, in the fit's bf16."""
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
    from photon_ml_tpu_torch.ops.objective import live_rows

    t0 = time.perf_counter()
    n_buckets = 0
    for cid in ("perUser", "perSong"):
        ds = datasets[cid]
        assert not any(b.materialized for b in ds.buckets), \
            (cid, "a resident bucket was filled on the host")
        cfg = est.coordinate_configs[cid]
        t1 = time.perf_counter()
        ref = tg.RandomEffectDataset.build(cid, train, cfg.dataset,
                                           use_native=False)
        numpy_s = time.perf_counter() - t1
        assert len(ref.buckets) == len(ds.buckets), cid
        assert np.array_equal(ref.passive_sample_idx, ds.passive_sample_idx)
        # the device as the fit's solver names it (its offsets' device)
        solver = RandomEffectSolver(
            task=est.task, config=cfg.optimization,
            design_dtype=cfg.design_dtype,
            device=(f"cuda:{torch.cuda.current_device()}"
                    if device == "cuda" else device))
        for i, (b, r) in enumerate(zip(ds.buckets, ref.buckets)):
            for field in ("entity_ids", "sample_idx", "feature_index"):
                assert np.array_equal(getattr(b, field), getattr(r, field)), \
                    (cid, i, field)
            e = b.tensor_shape[0]
            got = ds._device_cache[("bucket", i, cfg.design_dtype,
                                    str(solver.device), 0, e)]
            want = solver._statics_host(r, solver.device, 0, e)
            for field in STATICS_FIELDS:
                assert _same_bits(getattr(got, field), getattr(want, field)), \
                    (cid, i, field)
            assert live_rows(got.weights) == live_rows(want.weights)
            n_buckets += 1
        log(f"  {cid}: native index maps = numpy packer's ({len(ds.buckets)} "
            f"buckets; the numpy packer with host fills took {numpy_s:.2f} "
            f"s); statics rebuilt on the card = host fill, bit for bit "
            f"({cfg.design_dtype}); no bucket filled on the host")
        del ref
    log(f"[3] {n_buckets} buckets checked in {time.perf_counter() - t0:.1f} "
        f"s")


#: rows, entities and width of the duplicate-entry rebuild check
DUP = dict(rows=50_000, entities=500, dim=37)


def check_duplicate_rebuild(tg, device="cuda"):
    """Buckets whose rows hold the same feature several times: the card's
    dense image sums duplicates with a scatter-add (``index_put_(...,
    accumulate=True)``), the host fill in row order. Each bucket's statics
    rebuilt on the card against its host fill uploaded, in f32 and bf16:
    reports whether they are bit-equal, and holds x to the rounding of a
    reordered f32 sum of k terms ((k - 1) ulp of the sum of |values|)
    either way; the other statics are exact."""
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(21)
    n, dim = DUP["rows"], DUP["dim"]
    k = rng.integers(0, 9, size=n)
    rows = np.repeat(np.arange(n), k)
    # half the entries repeat the row's previous feature: runs of up to 4
    cols = rng.integers(0, dim, size=len(rows))
    rep = rng.uniform(size=len(rows)) < 0.5
    rep[np.r_[0, np.flatnonzero(np.diff(rows)) + 1]] = False
    for _ in range(3):
        cols = np.where(rep, np.r_[cols[:1], cols[:-1]], cols)
    vals = rng.normal(size=len(rows)).astype(np.float32)
    shard = tg.FeatureShard.from_coo(rows, cols, vals, n, dim)
    data = tg.GameData.build(
        labels=(rng.uniform(size=n) < 0.5).astype(np.float32),
        shards={"re": shard},
        weights=rng.uniform(0.5, 2.0, size=n).astype(np.float32),
        id_columns={"e": rng.integers(0, DUP["entities"], size=n)})
    pairs = rows * dim + cols
    most = int(np.unique(pairs, return_counts=True)[1].max())
    ds = tg.RandomEffectDataset.build(
        "dup", data, tg.RandomEffectDatasetConfig("e", "re"))
    abs_sum = torch.as_tensor(tg.FeatureShard.from_coo(
        rows, cols, np.abs(vals), n, dim).to_dense(), device=device)
    for dtype in ("float32", "bfloat16"):
        solver = RandomEffectSolver(
            task=TaskType.LOGISTIC_REGRESSION,
            config=GLMOptimizationConfiguration(), design_dtype=dtype,
            device=device)
        shared = solver._compact_shared(ds, solver.device)
        bit_equal, worst = True, 0.0
        for i, b in enumerate(ds.buckets):
            got = solver._statics_compact(ds, i, b, solver.device, shared)
            want = solver._statics_host(b, solver.device, 0,
                                        b.tensor_shape[0])
            for field in STATICS_FIELDS[1:]:
                assert _same_bits(getattr(got, field), getattr(want, field)), \
                    (dtype, i, field)
            bit_equal &= _same_bits(got.x, want.x)
            if dtype == "float32":
                # two orders of a sum of `most` terms part by at most
                # (most - 1) ulp of its sum of |values|
                fi = torch.as_tensor(b.feature_index, device=device)
                scale = abs_sum[got.gather_idx[:, :, None],
                                fi.clamp(min=0)[:, None, :]]
                gap = (got.x - want.x).abs()
                worst = max(worst, float(gap.max()))
                assert bool((gap <= max(most - 1, 1) * 2.0**-23
                             * scale).all()), i
        log(f"  duplicate entries (up to {most} of one feature in a row, "
            f"{len(ds.buckets)} buckets, {dtype}): statics rebuilt on the "
            f"card {'bit-equal to' if bit_equal else 'differ from'} the "
            f"host fill" + (f"; largest x gap {worst:.3e}, within "
                            f"{max(most - 1, 1)} ulp of each sum"
                            if dtype == "float32" else ""))
    data.clear_device_cache()


def check_forced_streaming(tg, small, small_valid, resident, evaluators,
                           device="cuda"):
    """The 20k-row fit on the card again with the resident cap lowered:
    both random effects turn to upload-and-drop streaming (host fills,
    nothing kept, the per-bucket loop) and the fit must equal the resident
    one (statics rebuilt on the card, the fused sweep) bit for bit."""
    from photon_ml_tpu_torch.game import data as gdata

    cap = gdata.RE_FAT_CACHE_MAX_BYTES
    gdata.RE_FAT_CACHE_MAX_BYTES = 1024
    try:
        est = e2e_estimator(tg, device, SMALL_MAX_ITER)
        t0 = time.perf_counter()
        ds = est.prepare(small)
        streamed = est.fit(small, [tg.GameOptimizationConfiguration(
            E2E_LAMBDAS)], validation=(small_valid, evaluators),
            datasets=ds)[0]
        wall = time.perf_counter() - t0
    finally:
        gdata.RE_FAT_CACHE_MAX_BYTES = cap
    for cid in ("perUser", "perSong"):
        assert not ds[cid].config.cache_device_buckets, cid
        assert ds[cid]._device_cache == {}, cid
    images = {k[1] for k in small._device_cache if k[0] == "dense_shard"}
    assert images == {"global"}, images  # the item image was evicted
    for cid, a in resident.model.coordinates.items():
        b = streamed.model.coordinates[cid]
        if isinstance(a, tg.FixedEffectModel):
            assert torch.equal(a.model.coefficients.means,
                               b.model.coefficients.means), cid
        else:
            assert np.array_equal(a.keys, b.keys), cid
            assert np.array_equal(a.coeffs, b.coeffs), cid
    assert resident.evaluation.primary == streamed.evaluation.primary
    log(f"[4] forced streaming (cap 1024 B): both random effects streamed "
        f"through the per-bucket loop, the item image evicted; prepare + fit "
        f"{wall:.2f} s; model and AUC bit-identical to the resident fit "
        f"(the fused sweep)")
    small.clear_device_cache()


# --------------------------------------------------------------------------
# phase 5: kernels 3 and 4 vs plain versions
# --------------------------------------------------------------------------

def _grad_err(got, want):
    """(max |kernel - plain|, that relative to max(1, max |plain|))."""
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


#: (n, d, dtypes) of kernel 3 vs its plain version: the GLM path's width
#: with a ragged n, the GAME fixed effect's width, streamed rows
HVP_CHECK_SHAPES = [(200_003, 1024, (torch.float32, torch.bfloat16)),
                    (5_001, 33, (torch.float32, torch.bfloat16)),
                    (20_011, 8192, (torch.float32, torch.bfloat16))]
#: the rest of kernel 3's bodies: narrow rows at the GAME fixed effect's
#: shape and at an even width (64), wide rows held in registers 8 columns a
#: lane (batched TRON's 20k x 128; 100 columns, not a multiple of 32); the
#: streamed rows at cuda_build.MAX_ROW_WIDTH are added in main()
HVP_BODY_SHAPES = [(1_000_000, 33, (torch.bfloat16,)),
                   (200_003, 64, (torch.float32, torch.bfloat16)),
                   (20_000, 128, (torch.float32, torch.bfloat16)),
                   (50_001, 100, (torch.float32,))]


def check_hvp(fused_hvp, shapes, gen):
    """Kernel 3 vs its plain version at ``shapes`` ``(n, d, dtypes)``;
    returns the largest relative error per design dtype. Every ninth row
    has no curvature and row 9 an x of 1e30, which must add exactly 0."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, d, dtypes in shapes:
        for dt in dtypes:
            x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
            v = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
            d2w = torch.rand(n, device="cuda", generator=gen)
            d2w[::9] = 0.0  # no curvature: padding, or a saturated row
            x[9] = 1e30  # such a row must add exactly 0, whatever its x
            got = fused_hvp.fused_hvp(x, v, d2w)
            again = fused_hvp.fused_hvp(x, v, d2w)
            want = fused_hvp.fused_hvp_plain(x, v, d2w)
            torch.cuda.synchronize()
            assert torch.equal(got, again), \
                f"kernel 3 not bit-identical on rerun: {n}x{d} {dt}"
            assert torch.isfinite(got).all(), (n, d, dt)
            err, rel = _grad_err(got, want)
            tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
            assert rel <= tol, (n, d, dt, err, rel)
            worst[dt] = max(worst[dt], rel)
            plan = fused_hvp.hvp_plan(n, d, x.element_size())
            log(f"  kernel3 n={n} d={d} {str(dt)[6:]} ({plan.body} body, "
                f"{plan.blocks} blocks of {plan.warps} warps): max_abs_err="
                f"{err:.3e} rel={rel:.2e}, rerun identical")
            del x
    return worst


def check_multi(fused_glm, cuda_build, losses, gen):
    """Kernel 4 vs its plain version (each lane's value and gradient to its
    own scale) and, lane by lane, vs kernel 1; returns the largest relative
    error vs the plain version and vs kernel 1 per design dtype."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0,
             ("kernel1", torch.float32): 0.0, ("kernel1", torch.bfloat16): 0.0}
    cases = [(100_003, 1024, m, dt) for m in (1, 2, 5, 8, 9, 11, 16)
             for dt in (torch.float32, torch.bfloat16)]
    # rows that are not 16-byte aligned (staged as granules, realigned);
    # rows of at most 128 columns (the narrow body), in two passes of
    # lanes, and with lanes too many for its accumulators (the wide body)
    cases += [(50_001, 33, m, dt) for m in (1, 5, 11)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(50_001, 128, 16, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(20_011, 128, 64, torch.float32)]
    cases += [(100_003, 1025, 5, dt) for dt in (torch.float32, torch.bfloat16)]
    # rows at the shared-memory limit of 5 and 11 lanes (streamed in
    # column chunks), and one column short of it (unaligned), in f32: with
    # few rows one bf16 rounding flip (BF16_RTOL) of a heavy Poisson row
    # weighs too much for any tolerance
    cases += [(3_001, cuda_build.max_row_width(m) - k, m, torch.float32)
              for m in (5, 11) for k in (0, 1)]
    for n, d, lanes, dt in cases:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        ws = torch.randn(lanes, d, device="cuda", generator=gen) / math.sqrt(d)
        off = 0.1 * torch.randn(n, device="cuda", generator=gen)
        wt = torch.rand(n, device="cuda", generator=gen)
        wt[::9] = 0.0  # weight-0 (padding) rows
        x[9] = 300.0  # padded: exp() of its margin would overflow
        line = []
        for loss in losses:
            y = _labels(loss, (n,), gen)
            args = (loss, x, ws, y, off, wt)
            got = fused_glm.fused_value_and_grad_multi(*args)
            again = fused_glm.fused_value_and_grad_multi(*args)
            want = fused_glm.fused_value_and_grad_plain(*args)
            one = [fused_glm.fused_value_and_grad(loss, x, ws[m], y, off, wt)
                   for m in range(lanes)]
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"kernel 4 not bit-identical on rerun: {n}x{d} M={lanes} {dt}"
            assert all(torch.isfinite(t).all() for t in got)
            err, rel = _max_err(got, want)
            tol = KERNEL_RTOL if dt == torch.float32 else BF16_RTOL
            assert rel <= tol, (n, d, lanes, dt, loss.name, err, rel)
            k1 = (torch.stack([v for v, _ in one]),
                  torch.stack([g for _, g in one]))
            _, rel1 = _max_err(got, k1)
            tol1 = KERNEL_RTOL if dt == torch.float32 else K4_VS_K1_BF16_RTOL
            assert rel1 <= tol1, (n, d, lanes, dt, loss.name, rel1)
            worst[dt] = max(worst[dt], rel)
            worst["kernel1", dt] = max(worst["kernel1", dt], rel1)
            line.append(f"{loss.name} {rel:.1e}/{rel1:.1e}")
        log(f"  kernel4 n={n} d={d} M={lanes} {str(dt)[6:]}: rel vs plain/"
            f"vs kernel1: {', '.join(line)}; reruns identical")
        del x
    return worst


def time_one_lane(fused_glm, loss, gen):
    """Kernel 4 at M = 1 against kernel 1 at the fixed-effect shapes of the
    two paths (1M x 33 bf16, 200k x 1024 f32), timed k1, k4, k4, k1 in one
    process. Returns {shape: (kernel 1 ms, kernel 4 ms)}."""
    out = {}
    for n, d, dt in [(1_000_000, 33, torch.bfloat16),
                     (200_000, 1024, torch.float32)]:
        x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
        w = torch.randn(d, device="cuda", generator=gen) / math.sqrt(d)
        y = _labels(loss, (n,), gen)
        off = torch.zeros(n, device="cuda")
        wt = torch.ones(n, device="cuda")

        def k1():
            return fused_glm.fused_value_and_grad(loss, x, w, y, off, wt)

        def k4():
            return fused_glm.fused_value_and_grad_multi(loss, x, w[None], y,
                                                        off, wt)

        a1, a4, b4, b1 = (time_ms(f) for f in (k1, k4, k4, k1))
        ms1, ms4 = (a1 + b1) / 2, (a4 + b4) / 2
        key = f"{n}x{d} {str(dt)[6:]}"
        out[key] = (ms1, ms4)
        log(f"  one lane {key}: kernel1 {ms1:.4f} ms, kernel4 (M=1) "
            f"{ms4:.4f} ms, ratio {ms4 / ms1:.3f}")
        del x
    return out


def hvp_closed_form_library(x, v, d2w):
    """Two-pass PyTorch form of kernel 3 (torch.mv), the yardstick the port
    never calls: X v, then the transposed product."""
    return torch.mv(x.t(), (d2w * torch.mv(x, v.to(x.dtype))).to(x.dtype))


def time_hvp(fused_hvp, x, w, loss, labels, gen):
    """Kernel 3 at one of the paths' shapes: the design and its curvature
    at ``w`` (as TRON's operator computes it), a random direction; kernel,
    plain version and torch.mv two-pass form timed in turns."""
    m = x.float() @ w
    d2w = loss.d2(m, labels)
    v = torch.randn(x.shape[1], device="cuda", generator=gen) / math.sqrt(
        x.shape[1])
    err, rel = _grad_err(fused_hvp.fused_hvp(x, v, d2w),
                         fused_hvp.fused_hvp_plain(x, v, d2w))
    tol = KERNEL_RTOL if x.dtype == torch.float32 else BF16_RTOL
    assert rel <= tol, ("kernel3 on a path's design", err, rel)
    calls = 20
    t = time_turns({
        "ms": lambda: fused_hvp.fused_hvp(x, v, d2w),
        "device_ms": captured(lambda: fused_hvp.fused_hvp(x, v, d2w), calls),
        "plain_ms": lambda: fused_hvp.fused_hvp_plain(x, v, d2w),
        "library_ms": lambda: hvp_closed_form_library(x, v, d2w)})
    t["device_ms"] /= calls
    n, d = x.shape
    b, by = hvp_bound_ms(int((d2w != 0).sum()), n, d, x.element_size())
    log(f"  kernel3 {n}x{d} {str(x.dtype)[6:]}: kernel {t['ms']:.4f} ms "
        f"({t['device_ms']:.4f} ms of device time, in a CUDA graph), plain "
        f"{t['plain_ms']:.4f} ms, torch.mv two-pass {t['library_ms']:.4f} "
        f"ms, bound {b:.4f} ms ({by}); max_abs_err vs plain {err:.3e}")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} {str(x.dtype)[6:]}", **t)


def multi_library(loss, x, ws, y, off, wt):
    """Two-pass PyTorch closed form (torch.mm) for M coefficient rows, the
    yardstick the port never calls."""
    m = ws.to(x.dtype) @ x.t() + off
    live = wt > 0
    m = torch.where(live, m, torch.zeros_like(m))
    values = torch.where(live, wt * loss.loss(m, y),
                         torch.zeros_like(m)).sum(-1)
    dvec = torch.where(live, wt * loss.d1(m, y), torch.zeros_like(m))
    return values, dvec.to(x.dtype) @ x


def time_multi(fused_glm, x, ws, loss, labels):
    """Kernel 4 at the GLM path's shape: the design and one coefficient row
    per lambda of the sweep; kernel, plain version and torch.mm form timed
    in turns."""
    n, d = x.shape
    off = torch.zeros(n, device="cuda")
    wt = torch.ones(n, device="cuda")
    args = (loss, x, ws, labels, off, wt)
    err, rel = _max_err(fused_glm.fused_value_and_grad_multi(*args),
                        fused_glm.fused_value_and_grad_plain(*args))
    # in bf16 a wt·d1 rounding flip on this design's 3 decades of column
    # scale outweighs BF16_RTOL; check_multi holds the bf16 kernel
    assert x.dtype != torch.float32 or rel <= KERNEL_RTOL, (
        "kernel4 on the GLM design", err, rel)
    t = time_turns({
        "ms": lambda: fused_glm.fused_value_and_grad_multi(*args),
        "plain_ms": lambda: fused_glm.fused_value_and_grad_plain(*args),
        "library_ms": lambda: multi_library(*args)})
    lanes = ws.shape[0]
    b, by = bound_ms(n, n, d, x.element_size(), lanes, lanes=lanes)
    log(f"  kernel4 {n}x{d} M={lanes} {str(x.dtype)[6:]}: kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.mm two-pass "
        f"{t['library_ms']:.4f} ms, bound {b:.4f} ms ({by}); max_abs_err vs "
        f"plain {err:.3e} (rel {rel:.2e})")
    return dict(max_abs_err=err, bound_ms=b, bound_by=by,
                shape=f"{n}x{d} M={lanes} {str(x.dtype)[6:]}", **t)


# --------------------------------------------------------------------------
# phases 6 and 7: the GLM sweeps
# --------------------------------------------------------------------------

def make_glm(rows, valid_rows, dim, nnz, seed=0):
    """The JAX package's bench GLM problem (bench.py::_make_problem):
    sparse-generated logistic data, densified, with log-uniform column
    scales over 3 decades; ``rows + valid_rows`` rows drawn, the last
    ``valid_rows`` held out. Returns host f32 arrays (x, y) of each part."""
    rng = np.random.default_rng(seed)
    n, d, k = rows + valid_rows, dim, nnz
    r = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = rng.integers(0, d, size=n * k, dtype=np.int32)
    col_scale = np.power(10.0, rng.uniform(-2.0, 1.0, size=d)).astype(
        np.float32)
    vals = (rng.normal(size=n * k).astype(np.float32) / np.sqrt(k)
            * col_scale[cols])
    x = np.zeros((n, d), np.float32)
    np.add.at(x, (r, cols), vals)
    w_true = rng.normal(size=d).astype(np.float32) / col_scale
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(
        np.float32)
    return (x[:rows], y[:rows]), (x[rows:], y[rows:])


def glm_configs(tolerance=1e-6):
    """The GLM path's two optimization settings: TRON and L-BFGS, L2, at
    the reference's relative gradient ``tolerance``."""
    from photon_ml_tpu_torch.glm import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType

    return (GLMOptimizationConfiguration(
                optimizer=OptimizerType.TRON,
                regularization=L2Regularization,
                optimizer_config=OptimizerConfig(
                    max_iterations=GLM_TRON_MAX_ITER, tolerance=tolerance)),
            GLMOptimizationConfiguration(
                optimizer=OptimizerType.LBFGS,
                regularization=L2Regularization,
                optimizer_config=OptimizerConfig(
                    max_iterations=GLM_LBFGS_MAX_ITER, tolerance=tolerance)))


def glm_sweeps(tolerance=1e-6, batched_tron=False):
    """(name, sweep, config) of the GLM path: TRON through
    ``train_glm_sweep``, L-BFGS through ``train_glm_sweep_batched`` and,
    with ``batched_tron``, TRON through ``train_glm_sweep_batched`` (kernel
    4 for the evaluations, kernel 3 once per lane for each CG product)."""
    from photon_ml_tpu_torch import glm

    tron, lbfgs = glm_configs(tolerance)
    out = [("tron", glm.train_glm_sweep, tron),
           ("batched", glm.train_glm_sweep_batched, lbfgs)]
    if batched_tron:
        out.append(("batched_tron", glm.train_glm_sweep_batched, tron))
    return out


def run_sweeps(train, valid, sweeps):
    """Each sweep of ``sweeps`` (:func:`glm_sweeps`) on ``train``'s device,
    followed by ``validate_and_select`` by AUC; the kernels' launch counts
    are set to 0 just before each sweep and read just after. Returns
    {name: (trained, best, seconds, launches)}."""
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.ops import fused_glm, fused_hvp
    from photon_ml_tpu_torch.types import TaskType

    counted = {"fused_glm": fused_glm.fused_value_and_grad,
               "fused_hvp": fused_hvp.fused_hvp,
               "fused_glm_multi": fused_glm.fused_value_and_grad_multi}
    cuda = train.design.x.is_cuda
    out = {}
    for name, sweep, cfg in sweeps:
        for fn in counted.values():
            fn.launches = 0
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = sweep(TaskType.LOGISTIC_REGRESSION, train, GLM_LAMBDAS,
                        cfg)
        if cuda:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        best, trained = glm.validate_and_select(
            trained, parse_evaluators(["AUC"]), valid)
        out[name] = (trained, best, sec, launches)
    return out


#: f32 unit roundoff
U32 = 2.0 ** -24


def check_gradients(label, train, trained):
    """Per lambda, in f64 on ``train``'s device, at the coefficients the
    sweep returned: the L2-regularized logistic objective f(w), the exact
    gradient, and its f32 rounding scale U32 * | |X|^T (|wt d1| + wt d2
    |X||w|) + lambda |w| | (every term of the gradient and of the margins
    it depends on, in absolute value). Asserts that the optimizer's own
    |grad| (f32, from the kernels on the card) matches the exact |grad f(w)|
    within that scale: a kernel that returns a wrong gradient, or a lane
    solved with another lane's lambda, reports a |grad| that f(w) does not
    have. Returns [(f(w), |grad f(w)|)] per lambda."""
    x = train.design.x.double()
    y, wt = train.labels.double(), train.weights.double()
    off = train.offsets.double()
    ax = x.abs()
    out = []
    for tm in trained:
        lam = tm.regularization_weight
        w = tm.model.coefficients.means.to(x.device).double()
        m = x @ w + off
        p = torch.sigmoid(m)
        g = x.t() @ (wt * (p - y)) + lam * w
        scale = ax.t() @ (wt * ((p - y).abs() + p * (1 - p) * (ax @ w.abs()))
                          ) + lam * w.abs()
        f = float((wt * (torch.nn.functional.softplus(m) - y * m)).sum()
                  + 0.5 * lam * (w @ w))
        gn = float(torch.linalg.vector_norm(g))
        eps = U32 * float(torch.linalg.vector_norm(scale))
        reported = float(tm.result.grad_norm)
        log(f"  {label} lambda={lam:g}: |grad f| f64 {gn:.6e} vs reported "
            f"{reported:.6e}: |diff| {abs(gn - reported):.3e} <= f32 scale "
            f"{eps:.3e}; f64 f(w) {f:.10e}")
        assert abs(gn - reported) <= eps, (label, lam, gn, reported, eps)
        out.append((f, gn))
    return out


def hold_to_bound(label, runs_a, runs_b, grads_a, grads_b):
    """Log every lambda's two solutions against (|grad f(w_a)| + |grad
    f(w_b)|) / lambda: each objective is lambda-strongly convex (L2, no
    intercept, no mask), so any iterate w lies within |grad f(w)| / lambda
    of the optimum. That holds for ANY two points, so it only catches a
    non-finite result; :func:`check_gradients` is what a wrong card path
    fails."""
    for lam, a, b, (_, g1), (_, g2) in zip(GLM_LAMBDAS, runs_a, runs_b,
                                           grads_a, grads_b):
        gap = float(torch.linalg.vector_norm(
            a.model.coefficients.means.cpu().double()
            - b.model.coefficients.means.cpu().double()))
        bound = (g1 + g2) / lam
        log(f"  {label} lambda={lam:g}: |w_a - w_b| {gap:.3e} <= bound "
            f"{bound:.3e} (|grad f| {g1:.2e} / {g2:.2e})")
        assert gap <= bound, (label, lam, gap, bound)


def log_sweep(name, trained, best, sec, launches):
    log(f"  {name} sweep: {sec:.3f} s; launches {launches}; best lambda "
        f"{trained[best].regularization_weight:g}")
    for tm in trained:
        r = tm.result
        log(f"    lambda={tm.regularization_weight:g}: iterations "
            f"{int(r.iterations)}, converged {bool(r.converged)}, value "
            f"{float(r.value):.6f}, |grad| {float(r.grad_norm):.3e}, AUC "
            f"{tm.evaluation.primary[1]:.6f}")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 8: the e2e CLI, Avro in, model directory out
# --------------------------------------------------------------------------

def e2e_records(data, first_uid=0):
    """TrainingExampleAvro records of one make_e2e GameData, laid out as
    ``bench.py::_write_e2e_file`` lays them out: the global shard's
    features as ``g.x{k}`` (its intercept column left to the reader), the
    item shard's as ``it.x{k}``, ``userId`` ``u{user}`` and ``songId``
    ``s{song}`` in the metadata map, null offsets and weights; uids count
    from ``first_uid``."""
    n = data.n_samples
    g, it = data.shards["global"], data.shards["item"]
    assert (np.diff(g.indptr) == 7).all() and (np.diff(it.indptr) == 4).all()
    intercept = g.dim - 1
    g_cols, g_vals = g.cols.reshape(n, 7).tolist(), g.vals.reshape(n, 7).tolist()
    i_cols, i_vals = it.cols.reshape(n, 4).tolist(), it.vals.reshape(n, 4).tolist()
    labels = data.labels.tolist()
    users = data.id_columns["userId"].tolist()
    songs = data.id_columns["songId"].tolist()
    for j in range(n):
        feats = [{"name": f"g.x{k}", "term": "", "value": v}
                 for k, v in zip(g_cols[j], g_vals[j]) if k != intercept]
        feats += [{"name": f"it.x{k}", "term": "", "value": v}
                  for k, v in zip(i_cols[j], i_vals[j])]
        yield {"uid": str(first_uid + j), "response": labels[j],
               "offset": None,
               "weight": None, "features": feats,
               "metadataMap": {"userId": f"u{users[j]}",
                               "songId": f"s{songs[j]}"}}


def cli_args(train, valid, out):
    """``bench.py::bench_end_to_end``'s arguments (bench.py:1191-1209),
    with the validation file and the AUC evaluator."""
    return [
        "--training-data", train, "--validation-data", valid,
        "--output-dir", out,
        "--feature-shards", "global=g|intercept,item=it|noIntercept",
        "--coordinates",
        f"global=fixed,shard=global,reg=L2,maxIter={E2E_MAX_ITER}",
        (f"perUser=random,entity=userId,shard=item,reg=L2,"
         f"maxIter={E2E_MAX_ITER},buckets=histogram,maxSampleBuckets=4"),
        (f"perSong=random,entity=songId,shard=item,reg=L2,"
         f"maxIter={E2E_MAX_ITER},buckets=histogram,maxSampleBuckets=4"),
        "--update-sequence", "global,perUser,perSong",
        "--cd-iterations", "1",
        "--grid", f"global={E2E_LAMBDAS['global']}",
        f"perUser={E2E_LAMBDAS['perUser']}",
        f"perSong={E2E_LAMBDAS['perSong']}",
        "--data-validation", "VALIDATE_DISABLED",
        "--design-dtype", "bfloat16",
        "--evaluators", "AUC",
    ]


#: phase 8's training rows go to this many contiguous part files, written
#: in parallel; read in name order they are the rows in the order one file
#: held them, so the model is the one-file model. The validation rows go to
#: one file (phases 10-14 read it) and to this many parts (phase 15's
#: multi-process scoring needs a file a process).
E2E_TRAIN_PARTS = 8
E2E_VALID_PARTS = 2


def _avro_long(n):
    """Avro's zigzag varint of a non-negative ``n``."""
    n <<= 1
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _avro_string(text):
    raw = text.encode()
    return _avro_long(len(raw)) + raw


def write_examples_part(path, indptr, cols, vals, labels, first_uid, names,
                        tails=None, sync=None):
    """One TrainingExampleAvro file (null codec) of CSR rows: row ``j``'s
    features are ``names[cols[k]]`` (each an encoded name and term) with
    value ``vals[k]``, no offset or weight, and ``tails[j]`` its encoded
    metadata map (an empty map without ``tails``). It encodes this record
    shape itself, byte for byte as ``data_reader.write_training_examples``
    does (blocks of 4,096 records; :func:`write_glm_files` and
    :func:`write_e2e_files` hold parts against it): each block's features
    are gathered into one buffer with numpy, and only the rows' heads are
    encoded in Python."""
    import struct

    from photon_ml_tpu_torch.io import avro
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    sync = os.urandom(avro.SYNC_SIZE) if sync is None else sync
    cols = np.asarray(cols, np.int64)
    indptr = np.asarray(indptr, np.int64)
    # every column's encoded name and term, laid end to end
    name_len = np.fromiter(map(len, names), np.int64, len(names))
    name_off = np.cumsum(name_len) - name_len
    table = np.frombuffer(b"".join(names), np.uint8)
    value_bytes = np.ascontiguousarray(vals, "<f8").view(np.uint8).reshape(
        -1, 8)
    labels = labels.tolist()
    with open(path, "wb") as f:
        f.write(avro.MAGIC)
        f.write(_avro_long(2))
        for key, value in (
                ("avro.schema",
                 json.dumps(TRAINING_EXAMPLE_AVRO).encode()),
                ("avro.codec", b"null")):
            f.write(_avro_long(len(key)) + key.encode())
            f.write(_avro_long(len(value)) + value)
        f.write(b"\x00" + sync)
        for lo in range(0, len(labels), 4096):
            hi = min(lo + 4096, len(labels))
            a0, b0 = int(indptr[lo]), int(indptr[hi])
            c = cols[a0:b0]
            lens = name_len[c]
            width = lens + 8
            ends = np.cumsum(width)
            starts = ends - width
            buf = np.empty(int(ends[-1]) if c.size else 0, np.uint8)
            # each feature's name and term, then its value
            within = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens)
            buf[np.repeat(starts, lens) + within] = table[
                np.repeat(name_off[c], lens) + within]
            buf[(starts + lens)[:, None] + np.arange(8)] = value_bytes[a0:b0]
            feats = buf.tobytes()
            row_at = np.concatenate([[0], ends])[indptr[lo:hi + 1] - a0]
            parts = []
            for j in range(lo, hi):
                uid = str(first_uid + j).encode()
                n = int(indptr[j + 1] - indptr[j])
                # uid (union branch 1), response, null offset and weight,
                # the features and their end, the metadata map
                parts.append(b"\x02" + _avro_long(len(uid)) + uid
                             + struct.pack("<d", labels[j]) + b"\x00\x00"
                             + (_avro_long(n) if n else b"")
                             + feats[row_at[j - lo]:row_at[j - lo + 1]]
                             + b"\x00"
                             + (b"\x02\x00" if tails is None else tails[j]))
            payload = b"".join(parts)
            f.write(_avro_long(hi - lo) + _avro_long(len(payload)))
            f.write(payload + sync)
    return os.path.getsize(path)


def write_e2e_part(path, data, first_uid, sync=None):
    """One TrainingExampleAvro file (null codec) of make_e2e rows, the
    records :func:`e2e_records` makes, through :func:`write_examples_part`.
    Runs in a worker process."""
    n = data.n_samples
    g, it = data.shards["global"], data.shards["item"]
    g_cols = g.cols.reshape(n, 7)
    keep = g_cols != g.dim - 1  # the intercept column stays the reader's
    assert (keep.sum(axis=1) == 6).all()
    cols = np.concatenate([g_cols[keep].reshape(n, 6),
                           it.cols.reshape(n, 4).astype(np.int64) + g.dim],
                          axis=1).reshape(-1)
    vals = np.concatenate([g.vals.reshape(n, 7)[keep].reshape(n, 6),
                           it.vals.reshape(n, 4)], axis=1).reshape(-1)
    names = ([_avro_string(f"g.x{k}") + b"\x00" for k in range(g.dim)]
             + [_avro_string(f"it.x{k}") + b"\x00" for k in range(it.dim)])
    user_key, song_key = _avro_string("userId"), _avro_string("songId")
    users = {u: _avro_string(f"u{u}")
             for u in np.unique(data.id_columns["userId"]).tolist()}
    songs = {v: _avro_string(f"s{v}")
             for v in np.unique(data.id_columns["songId"]).tolist()}
    # the map's branch, one block of two entries, its end
    tails = [b"\x02\x04" + user_key + users[u] + song_key + songs[v] + b"\x00"
             for u, v in zip(data.id_columns["userId"].tolist(),
                             data.id_columns["songId"].tolist())]
    return write_examples_part(path, np.arange(0, 10 * n + 1, 10), cols,
                               vals, data.labels, first_uid, names, tails,
                               sync=sync)


def write_e2e_part_plain(path, data, first_uid, sync=None):
    """:func:`write_e2e_part` through the port's generic Avro writer."""
    from photon_ml_tpu_torch.io import data_reader

    data_reader.write_training_examples(path, e2e_records(data, first_uid),
                                        codec="null", sync=sync)
    return os.path.getsize(path)


#: rows of phase 8's training set that write_e2e_files encodes with both
#: writers (two blocks of records)
E2E_WRITE_CHECK_ROWS = 4_200


def _rows_of(data, lo, hi):
    """Rows ``[lo, hi)`` of a host GameData."""
    from photon_ml_tpu_torch.game.multiprocess import _take_rows

    return _take_rows(data, np.arange(lo, hi))


def writer_context():
    """The Avro writers' process context: children forked from one server
    process, which imports this script once (a spawned child imports it,
    and torch, again), and which never touches the card."""
    import multiprocessing

    return multiprocessing.get_context("forkserver")


def write_e2e_files(root, train, valid):
    """Phase 8's files under ``root``: ``train/part-NNNNN.avro``
    (:data:`E2E_TRAIN_PARTS` contiguous parts), ``valid.avro`` and ``valid_parts/``
    (:data:`E2E_VALID_PARTS`), all at once over a pool of
    :func:`writer_context` processes. Returns (paths, {set: bytes})."""
    import concurrent.futures

    paths = {"train": os.path.join(root, "train"),
             "valid": os.path.join(root, "valid.avro"),
             "valid_parts": os.path.join(root, "valid_parts")}
    jobs = [(paths["valid"], valid, 0)]
    for key, data, parts in (("train", train, E2E_TRAIN_PARTS),
                             ("valid_parts", valid, E2E_VALID_PARTS)):
        os.makedirs(paths[key])
        cuts = np.linspace(0, data.n_samples, parts + 1).astype(np.int64)
        for k, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            jobs.append((os.path.join(paths[key], f"part-{k:05d}.avro"),
                         _rows_of(data, int(lo), int(hi)), int(lo)))
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 1, 8),
            mp_context=writer_context()) as pool:
        sizes = list(pool.map(write_e2e_part, *zip(*jobs)))
    # the encoder against the port's generic writer: the training set's
    # first rows, one sync marker, the same bytes
    check = os.path.join(root, "write_check.avro")
    cut = _rows_of(train, 0, min(E2E_WRITE_CHECK_ROWS, train.n_samples))
    encoded = []
    for writer in (write_e2e_part, write_e2e_part_plain):
        writer(check, cut, 0, sync=bytes(range(16)))
        with open(check, "rb") as f:
            encoded.append(f.read())
    assert encoded[0] == encoded[1], "the e2e encoder's bytes differ"
    os.remove(check)
    return paths, {"valid": sizes[0],
                   "train": sum(sizes[1:1 + E2E_TRAIN_PARTS])}


class Counted:
    """Wraps a module function and counts its calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def wrapper(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def run_cli_phase(tg, fused_glm, fused_re, auc_phase3, auc_fe, tmp):
    """Phase 8, in the directory ``tmp``, and phase 19 (a)'s check of the
    background saver's ``best/`` against a synchronous save of the model it
    published (held only until then); returns the kernels' launch counts of
    the CLI run and what phase 10 scores: the run directory, the validation
    file and ``best/``'s rescored AUC."""
    from photon_ml_tpu_torch import native
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.io import data_reader, model_io, pipeline
    from photon_ml_tpu_torch.io.index import IndexMap

    train, valid = make_e2e(tg, **E2E)
    t0 = time.perf_counter()
    paths, size = write_e2e_files(tmp, train, valid)
    log(f"[8] wrote phase 3's rows to Avro ({E2E['rows']} records in "
        f"{E2E_TRAIN_PARTS} part files, {E2E['valid_rows']} in one file "
        f"and again in {E2E_VALID_PARTS} parts; null codec, {size['train']}"
        f" + {size['valid']} bytes) in {time.perf_counter() - t0:.2f} s "
        "(writer processes, not in the wall below; the record "
        f"shape's encoder, its first {E2E_WRITE_CHECK_ROWS} rows "
        "byte-identical to the generic writer's)")
    del train, valid
    # the native library's g++ build happens once a checkout, outside
    # the wall
    t0 = time.perf_counter()
    assert native.available(), "the native decoder did not build"
    log(f"[8] built the native ingest library (g++) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = os.path.join(tmp, "run")
    fused_glm.fused_value_and_grad.launches = 0
    fused_re.fused_entity_value_and_grad.launches = 0
    saved = []
    with Counted(native, "decode_training_file") as nat, \
            Counted(data_reader, "iter_avro_file") as py, \
            Patched(pipeline, "save_game_model_atomic",
                    recorded_saves(saved)):
        t0 = time.perf_counter()
        result = train_game.run(cli_args(paths["train"], paths["valid"],
                                         out))
        wall = time.perf_counter() - t0
    launches = {"fused_glm": fused_glm.fused_value_and_grad.launches,
                "fused_re": fused_re.fused_entity_value_and_grad.launches}
    decoder = ("native" if nat.calls == E2E_TRAIN_PARTS + 1
               and py.calls == 0 else
               f"python ({py.calls} files; native {nat.calls})")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        stages = [json.loads(line) for line in f]
    auc = result["best_evaluation"]["AUC"]
    best = os.path.join(out, "best")
    model_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(best) for f in files)
    log(f"[8] train_game.run, Avro open to model on disk: {wall:.2f} s")
    for st in stages:
        if "seconds" in st:
            log(f"  {st['stage']}: {st['seconds']:.3f} s")
    log(f"  decoder: {decoder}")
    log(f"  launches: {launches}")
    log(f"  validation AUC {auc:.7f}; phase 3 {auc_phase3:.7f} "
        f"(|diff| {abs(auc - auc_phase3):.2e}, limit {CLI_AUC_TOL:g}); "
        f"fixed effect alone {auc_fe:.7f}")
    log(f"  best/: {model_bytes} bytes in "
        f"{sum(len(f) for _, _, f in os.walk(best))} files")
    assert decoder == "native", decoder
    assert launches["fused_glm"] > 0 and launches["fused_re"] > 0, \
        launches
    assert abs(auc - auc_phase3) <= CLI_AUC_TOL, (auc, auc_phase3)
    assert auc > auc_fe + 0.01, (auc, auc_fe)

    # best/ loaded again with the run's index maps and vocabularies
    t0 = time.perf_counter()
    shards = tuple(parse_feature_shard_config(s) for s in
                   ("global=g|intercept", "item=it|noIntercept"))
    maps = {c.shard_id: IndexMap.load(os.path.join(
        out, "feature-indexes", f"{c.shard_id}.json")) for c in shards}
    reader = data_reader.AvroDataReader(shard_configs=shards,
                                        index_maps=maps)
    ids = ("songId", "userId")
    _, _, vocabs = reader.read(paths["train"], id_columns=ids)
    vdata, _, _ = reader.read(paths["valid"], id_columns=ids,
                              entity_vocabs=vocabs)
    # (the lineage id from the same decode of best/'s records)
    model, lineage = model_io.load_warm_start_model(
        model_io.resolve_game_model_dir(out), maps, vocabs, device="cuda")
    reload_auc = parse_evaluators(["AUC"])[0].evaluate(
        model.score(vdata), vdata.labels, vdata.weights)
    log(f"  best/ reloaded and rescored in "
        f"{time.perf_counter() - t0:.2f} s: AUC {reload_auc:.7f} "
        f"(|diff| {abs(reload_auc - auc):.2e}, limit "
        f"{RELOAD_AUC_TOL:g})")
    assert abs(reload_auc - auc) <= RELOAD_AUC_TOL, (reload_auc, auc)
    del model, vdata
    (save,) = saved  # one configuration: best/ saved once, in the background
    assert os.path.normpath(save["path"]) == os.path.normpath(best), save
    check_background_save(save, best, lineage, tmp)
    del save, saved
    return launches, dict(run=out, train=paths["train"], valid=paths["valid"],
                          valid_parts=paths["valid_parts"], auc=reload_auc,
                          train_auc=auc, model_bytes=model_bytes, wall=wall)


# --------------------------------------------------------------------------
# phase 9: the GLM command, Avro in, model directory out
# --------------------------------------------------------------------------

#: phase 9's wide sparse file: 64 nonzeros a row over 100,000 columns (the
#: shape of the JAX package's ChunkedSparseDesign measurement,
#: photon_ml_tpu/ops/design.py:155-160), and its card-vs-CPU cut
WIDE = dict(rows=200_000, valid_rows=20_000, dim=100_000, nnz=64)
WIDE_SMALL = dict(rows=20_000, valid_rows=4_000, dim=50_000, nnz=64)
#: train_glm's runs: (name, data, arguments). (a)-(c) on phase 6's rows
#: without an intercept, as phase 6 solves them; (d) on the wide file with
#: train_glm's default intercept
GLM_CLI_RUNS = [
    ("tron", "dense", ["--no-intercept", "--optimizer", "TRON",
                       "--max-iterations", str(GLM_TRON_MAX_ITER)]),
    ("batched", "dense", ["--no-intercept", "--sweep-mode", "batched",
                          "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("owlqn", "dense", ["--no-intercept", "--optimizer", "OWLQN",
                        "--regularization-type", "ELASTIC_NET",
                        "--elastic-net-alpha", "0.5",
                        "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("owlqn_batched", "dense", ["--no-intercept", "--optimizer", "OWLQN",
                                "--regularization-type", "ELASTIC_NET",
                                "--elastic-net-alpha", "0.5",
                                "--sweep-mode", "batched",
                                "--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
    ("sparse", "wide", ["--max-iterations", str(GLM_LBFGS_MAX_ITER)]),
]
#: the kernels each run must launch (and the sparse run none)
GLM_CLI_KERNELS = {"tron": ("fused_glm", "fused_hvp"),
                   "batched": ("fused_glm_multi",),
                   "owlqn": ("fused_glm",),
                   "owlqn_batched": ("fused_glm_multi",),
                   "sparse": ()}


def make_wide(rows, valid_rows, dim, nnz, seed=2):
    """Sparse logistic rows of ``nnz`` distinct columns out of ``dim``
    (values N(0, 1/nnz), labels from planted N(0, 4) coefficients), as CSR
    (indptr, cols, vals, labels) of the ``rows`` training and the
    ``valid_rows`` held-out rows."""
    rng = np.random.default_rng(seed)
    n = rows + valid_rows
    cols = (np.sort(rng.integers(0, dim - nnz + 1, size=(n, nnz)), axis=1)
            + np.arange(nnz))
    vals = (rng.normal(size=(n, nnz)) / np.sqrt(nnz)).astype(np.float32)
    w_true = 2.0 * rng.normal(size=dim)
    m = (w_true[cols] * vals).sum(1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    indptr = np.arange(rows + 1, dtype=np.int64) * nnz
    vptr = np.arange(valid_rows + 1, dtype=np.int64) * nnz
    return ((indptr, cols[:rows].ravel(), vals[:rows].ravel(), y[:rows]),
            (vptr, cols[rows:].ravel(), vals[rows:].ravel(), y[rows:]))


def dense_csr(x, y):
    """The nonzeros of a dense ``x`` as CSR (indptr, cols, vals, labels)."""
    r, c = np.nonzero(x)
    indptr = np.zeros(len(x) + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=len(x)), out=indptr[1:])
    return indptr, c.astype(np.int32), x[r, c], y


def write_glm_part(path, indptr, cols, vals, labels, first_uid, sync=None):
    """One TrainingExampleAvro file (null codec) of CSR rows: features
    ``x{col}``, no offsets, weights or metadata, through
    :func:`write_examples_part`. Runs in a worker process."""
    cols = np.asarray(cols, np.int64)
    dim = int(cols.max()) + 1 if cols.size else 0
    names = [_avro_string(f"x{c}") + b"\x00" for c in range(dim)]
    return write_examples_part(path, indptr, cols, vals, labels, first_uid,
                               names, sync=sync)


def write_glm_part_plain(path, indptr, cols, vals, labels, first_uid,
                         sync=None):
    """:func:`write_glm_part` through the port's generic Avro writer."""
    from photon_ml_tpu_torch.io import data_reader

    cols, vals = cols.tolist(), vals.tolist()
    labels = labels.tolist()

    def records():
        for j, y in enumerate(labels):
            a, b = int(indptr[j]), int(indptr[j + 1])
            yield {"uid": str(first_uid + j), "response": y, "offset": None,
                   "weight": None,
                   "features": [{"name": f"x{c}", "term": "", "value": v}
                                for c, v in zip(cols[a:b], vals[a:b])],
                   "metadataMap": {}}

    data_reader.write_training_examples(path, records(), codec="null",
                                        sync=sync)
    return os.path.getsize(path)


#: rows of each set that write_glm_files encodes with both writers
GLM_WRITE_CHECK_ROWS = 100


def write_glm_files(root, sets, parts=4):
    """Write each CSR set of ``sets`` ({name: csr}) under ``root``: a
    directory of ``parts`` files, all sets at once over a pool of
    :func:`writer_context` processes. Returns ({name: path}, total bytes,
    records)."""
    import concurrent.futures

    jobs, paths = [], {}
    for name, (indptr, cols, vals, labels) in sets.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        paths[name] = d
        n = len(labels)
        cuts = np.linspace(0, n, min(parts, n) + 1).astype(np.int64)
        for k, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            a, b = indptr[lo], indptr[hi]
            jobs.append((os.path.join(d, f"part-{k:02d}.avro"),
                         indptr[lo:hi + 1] - a, cols[a:b], vals[a:b],
                         labels[lo:hi], int(lo)))
    workers = min(len(jobs), os.cpu_count() or 1, 8)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=writer_context()) as pool:
        sizes = list(pool.map(write_glm_part, *zip(*jobs)))
    # the encoder against the port's generic writer: each set's first
    # GLM_WRITE_CHECK_ROWS rows, one sync marker, the same bytes
    sync = bytes(range(16))
    check = os.path.join(root, "write_check.avro")
    for name, (indptr, cols, vals, labels) in sets.items():
        n = min(GLM_WRITE_CHECK_ROWS, len(labels))
        cut = (indptr[:n + 1], cols[:indptr[n]], vals[:indptr[n]],
               labels[:n], 0)
        encoded = []
        for writer in (write_glm_part, write_glm_part_plain):
            writer(check, *cut, sync=sync)
            with open(check, "rb") as f:
                encoded.append(f.read())
        assert encoded[0] == encoded[1], f"{name}: the encoder's bytes differ"
    os.remove(check)
    return paths, sum(sizes), sum(len(s[3]) for s in sets.values())


def glm_cli_args(train, valid, out, extra, device=None):
    args = ["--training-data", train, "--validation-data", valid,
            "--output-dir", out, "--evaluators", "AUC",
            "--regularization-weights",
            ";".join(f"{lam:g}" for lam in GLM_LAMBDAS)] + extra
    return args + (["--device", device] if device else [])


def read_run(out):
    """A train_glm run directory: its stage walls, per-lambda (reported
    |grad|, iterations, converged, AUC) and coefficients (host f64 arrays
    in the run's feature order), and its feature index."""
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.index import IndexMap

    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    imap = IndexMap.load(os.path.join(out, "feature-index.json"))
    lams = {}
    for m in lines:
        if m["stage"] == "train":
            lam = m["regularization_weight"]
            w = model_io.load_glm_model(
                os.path.join(out, "all", f"lambda-{lam:g}", "model.avro"),
                imap, device="cpu").coefficients.means
            lams[lam] = dict(grad_norm=m["grad_norm"],
                             iterations=m["iterations"],
                             converged=m["converged"],
                             w=w.double().numpy())
        elif m["stage"] == "validate":
            lams[m["regularization_weight"]]["auc"] = m["AUC"]
    stages = [(m["stage"], m["seconds"]) for m in lines if "seconds" in m]
    return stages, lams, imap


def read_glm_data(path, imap, device):
    """``path`` read with a run's feature index into train_glm's
    GLMData on ``device``."""
    from photon_ml_tpu_torch.cli import train_glm
    from photon_ml_tpu_torch.io import data_reader

    reader = data_reader.AvroDataReader(
        shard_configs=(data_reader.FeatureShardConfig(
            "global", feature_bags=None, has_intercept=imap.has_intercept),),
        index_maps={"global": imap})
    data, _, _ = reader.read(path)
    return train_glm._to_glm_data(data, "global", "float32", device)


class Contractions:
    """``X v``, ``Xᵀ g`` and their |X| versions in f64 for a GLMData's
    design, dense or chunked sparse (f32 values, f64 sums)."""

    def __init__(self, glm):
        from photon_ml_tpu_torch.ops.design import DenseDesign

        d = glm.design
        if isinstance(d, DenseDesign):
            x = d.x.double()
            ax = x.abs()
            self.mv, self.rmv = (lambda v: x @ v), (lambda g: x.t() @ g)
            self.amv, self.armv = (lambda v: ax @ v), (lambda g: ax.t() @ g)
        else:
            a = dataclasses.replace(d, rvals=d.rvals.abs(),
                                    cvals=d.cvals.abs())
            self.mv, self.rmv = d.matvec, d.rmatvec
            self.amv, self.armv = a.matvec, a.rmatvec
        self.y = glm.labels.double()
        self.wt = glm.weights.double()
        self.off = glm.offsets.double()


def elastic_net_objective(c, w, lam, alpha, mask):
    """f64 logistic objective + 0.5 (1-alpha) lam |mask w|^2 + alpha lam
    |w|_1 at host ``w``, with its exact (pseudo-)gradient and that
    gradient's f32 rounding scale (see :func:`check_gradients`).
    Returns (f(w), |pg|, scale)."""
    from photon_ml_tpu_torch.optimize.owlqn import pseudo_gradient

    dev = c.y.device
    w = torch.as_tensor(w, device=dev)
    mk = torch.ones_like(w) if mask is None else torch.as_tensor(
        mask, dtype=torch.float64, device=dev)
    l1, l2 = alpha * lam, (1.0 - alpha) * lam
    m = c.mv(w) + c.off
    p = torch.sigmoid(m)
    g = c.rmv(c.wt * (p - c.y)) + l2 * mk * w
    pg = pseudo_gradient(w, g, torch.full_like(w, l1))
    scale = (c.armv(c.wt * ((p - c.y).abs() + p * (1 - p) * c.amv(w.abs())))
             + l2 * mk * w.abs() + l1)
    f = float((c.wt * (torch.nn.functional.softplus(m) - c.y * m)).sum()
              + 0.5 * l2 * ((mk * w) ** 2).sum() + l1 * w.abs().sum())
    return (f, float(torch.linalg.vector_norm(pg)),
            U32 * float(torch.linalg.vector_norm(scale)))


def check_cli_gradients(label, c, lams, alpha, mask):
    """Phase 6's gradient check on a train_glm run's coefficients: the
    reported |grad| (the pseudo-gradient's under an L1 part) against the
    exact f64 one within its f32 rounding scale. Returns {lam: f(w)}."""
    out = {}
    for lam, r in sorted(lams.items(), reverse=True):
        f, gn, eps = elastic_net_objective(c, r["w"], lam, alpha, mask)
        log(f"  {label} lambda={lam:g}: |grad f| f64 {gn:.6e} vs reported "
            f"{r['grad_norm']:.6e}: |diff| {abs(gn - r['grad_norm']):.3e} "
            f"<= f32 scale {eps:.3e}; f64 f(w) {f:.10e}; iterations "
            f"{r['iterations']}, converged {r['converged']}; zeros "
            f"{int((r['w'] == 0).sum())}/{r['w'].size}; AUC "
            f"{r['auc']:.7f}")
        assert abs(gn - r["grad_norm"]) <= eps, (label, lam, gn, r, eps)
        out[lam] = f
    return out


def rescore(out, valid_glm, imap, auc):
    """``best/model.avro`` loaded with the run's feature index scores the
    validation rows to the run's AUC within RELOAD_AUC_TOL."""
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.io import model_io

    model = model_io.load_glm_model(os.path.join(out, "best", "model.avro"),
                                    imap, device=valid_glm.labels.device)
    scores = model.score(valid_glm.design).cpu().numpy()
    got = parse_evaluators(["AUC"])[0].evaluate(
        scores, valid_glm.labels.cpu().numpy())
    assert abs(got - auc) <= RELOAD_AUC_TOL, (out, got, auc)
    return got


def run_glm_cli_phase(fused_glm, fused_hvp, fused_re, phase6,
                      device="cuda", keep_dir=None):
    """Phase 9; ``phase6`` is {sweep: (best lambda, AUC)} of phase 6's
    in-memory sweeps. Returns each run's kernel launch counts and the Avro
    sets' paths. The full-width runs' checks run on ``device``. With
    ``keep_dir`` the files are written there and kept (phase 14 reads
    them), else in a temporary directory removed at the end."""
    from photon_ml_tpu_torch.cli import train_glm
    from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign

    counted = {"fused_glm": fused_glm.fused_value_and_grad,
               "fused_hvp": fused_hvp.fused_hvp,
               "fused_glm_multi": fused_glm.fused_value_and_grad_multi,
               "fused_re": fused_re.fused_entity_value_and_grad}
    tmp = keep_dir or tempfile.mkdtemp(prefix="chip_smoke_glm_")
    os.makedirs(tmp, exist_ok=True)
    try:
        t0 = time.perf_counter()
        (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM)
        (xs_tr, ys_tr), (xs_va, ys_va) = make_glm(**GLM_SMALL, seed=1)
        wide, wide_va = make_wide(**WIDE)
        wide_s, wide_s_va = make_wide(**WIDE_SMALL, seed=3)
        sets = {"dense": dense_csr(x_tr, y_tr),
                "dense_valid": dense_csr(x_va, y_va),
                "small": dense_csr(xs_tr, ys_tr),
                "small_valid": dense_csr(xs_va, ys_va),
                "wide": wide, "wide_valid": wide_va,
                "wide_small": wide_s, "wide_small_valid": wide_s_va}
        del x_tr, x_va
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        paths, nbytes, nrec = write_glm_files(tmp, sets)
        log(f"[9] generated the GLM rows in {gen_s:.1f} s and wrote them to "
            f"Avro ({nrec} records in {len(sets)} sets, null codec, {nbytes} "
            f"bytes) in {time.perf_counter() - t0:.2f} s (writer "
            "processes, not in the walls below)")
        del sets

        launches, runs = {}, {}
        for name, data, extra in GLM_CLI_RUNS:
            out = os.path.join(tmp, name)
            for fn in counted.values():
                fn.launches = 0
            t0 = time.perf_counter()
            result = train_glm.run(glm_cli_args(
                paths[data], paths[data + "_valid"], out, extra))
            wall = time.perf_counter() - t0
            launches[name] = {k: fn.launches for k, fn in counted.items()}
            stages, lams, imap = read_run(out)
            runs[name] = (result, lams, imap, out)
            log(f"[9] train_glm {name} ({' '.join(extra)}): {wall:.2f} s "
                f"from Avro open to models on disk; best lambda "
                f"{result['best_lambda']:g}, AUC "
                f"{result['best_evaluation']['AUC']:.7f}")
            for stage, sec in stages:
                log(f"  {stage}: {sec:.3f} s")
            log(f"  launches: {launches[name]}")
            for k in GLM_CLI_KERNELS[name]:
                assert launches[name][k] > 0, (name, launches[name])
            if name == "sparse":
                assert not any(launches[name].values()), launches[name]

        # (a) and (b) against phase 6's in-memory sweeps of the same rows
        for name in ("tron", "batched"):
            result = runs[name][0]
            lam6, auc6 = phase6[name]
            auc = result["best_evaluation"]["AUC"]
            log(f"  {name}: best lambda {result['best_lambda']:g} (phase 6 "
                f"{lam6:g}); AUC {auc:.7f} (phase 6 {auc6:.7f}, |diff| "
                f"{abs(auc - auc6):.2e}, limit {CLI_AUC_TOL:g})")
            assert result["best_lambda"] == lam6, (name, result, lam6)
            assert abs(auc - auc6) <= CLI_AUC_TOL, (name, auc, auc6)

        # every lambda's reported |grad| and the reloaded best models
        checks = {"dense": ("tron", "batched", "owlqn", "owlqn_batched"),
                  "wide": ("sparse",)}
        for data, names in checks.items():
            imap = runs[names[0]][2]
            train = read_glm_data(paths[data], imap, device)
            valid = read_glm_data(paths[data + "_valid"], imap, device)
            c = Contractions(train)
            for name in names:
                result, lams, imap_n, out = runs[name]
                assert imap_n.names() == imap.names(), name
                alpha = 0.5 if name.startswith("owlqn") else 0.0
                mask = cli_mask(imap)
                check_cli_gradients(name, c, lams, alpha, mask)
                auc = result["best_evaluation"]["AUC"]
                got = rescore(out, valid, imap, auc)
                log(f"  {name}: best/ reloaded and rescored: AUC "
                    f"{got:.7f} (|diff| {abs(got - auc):.2e}, limit "
                    f"{RELOAD_AUC_TOL:g})")
            if data == "dense":
                top = runs["owlqn"][1][max(GLM_LAMBDAS)]["w"]
                topb = runs["owlqn_batched"][1][max(GLM_LAMBDAS)]["w"]
                log(f"  elastic net at lambda={max(GLM_LAMBDAS):g}: "
                    f"{int((top == 0).sum())} (sequential), "
                    f"{int((topb == 0).sum())} (batched) of {top.size} "
                    "coefficients exactly 0")
                assert (top == 0).any() and (topb == 0).any()
            else:
                # the sparse contractions rerun bit for bit on the card
                d = train.design
                assert isinstance(d, ChunkedSparseDesign)
                gen = torch.Generator(device=device).manual_seed(97)
                w = torch.randn(d.dim, device=device, generator=gen)
                g = torch.randn(d.n_samples, device=device, generator=gen)
                reruns = [(d.matvec(w), d.rmatvec(g)) for _ in range(3)]
                same = all(torch.equal(a[0], reruns[0][0])
                           and torch.equal(a[1], reruns[0][1])
                           for a in reruns[1:])
                log(f"  sparse design {d.n_samples} x {d.dim}, "
                    f"{int((d.rvals != 0).sum())} stored values, chunks "
                    f"{tuple(d.rvals.shape)} rows / {tuple(d.cvals.shape)} "
                    f"columns: matvec and rmatvec bit-identical over 3 "
                    f"runs: {same}")
                assert same
            del train, valid, c
            if device == "cuda":
                torch.cuda.empty_cache()

        # (c) and (d) cut to size, on the card and on the CPU
        small_runs = [("owlqn", "small", GLM_CLI_RUNS[2][2]),
                      ("owlqn_batched", "small", GLM_CLI_RUNS[3][2]),
                      ("sparse", "wide_small", GLM_CLI_RUNS[4][2])]
        worst, worst_auc, held = 0.0, 0.0, 0
        for name, data, extra in small_runs:
            extra = extra + ["--tolerance", f"{GLM_SMALL_TOLERANCE:g}"]
            lams, objective = {}, {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, f"{name}_{data}_{device}")
                t0 = time.perf_counter()
                train_glm.run(glm_cli_args(paths[data],
                                           paths[data + "_valid"], out,
                                           extra, device=device))
                log(f"[9] train_glm {name} on {data} ({device}): "
                    f"{time.perf_counter() - t0:.2f} s")
                _, lams[device], imap = read_run(out)
                c = Contractions(read_glm_data(paths[data], imap, device))
                objective[device] = check_cli_gradients(
                    f"{device} {name}", c,
                    lams[device], 0.5 if name.startswith("owlqn") else 0.0,
                    cli_mask(imap))
            for lam in GLM_LAMBDAS:
                a, b = lams["cuda"][lam], lams["cpu"][lam]
                fa, fb = objective["cuda"][lam], objective["cpu"][lam]
                both = a["converged"] and b["converged"]
                rel = abs(fa - fb) / abs(fb)
                d_auc = abs(a["auc"] - b["auc"])
                worst = max(worst, rel)
                held += both
                worst_auc = max(worst_auc, d_auc)
                log(f"    {name} lambda={lam:g}: converged {a['converged']}"
                    f"/{b['converged']}; f64 f(w) relative |cuda - cpu| "
                    f"{rel:.3e} (limit {OBJECTIVE_RTOL[both]:g}); |AUC cuda "
                    f"- AUC cpu| {d_auc:.2e} (limit 1e-4)")
                assert rel <= OBJECTIVE_RTOL[both], (name, lam, rel)
                assert d_auc <= 1e-4, (name, lam, d_auc)
        log(f"[9] card vs CPU: f64 objectives within {worst:.3e} relative "
            f"({held} lambdas converged on both devices), AUCs within "
            f"{worst_auc:.2e}")
        return launches, paths
    finally:
        if keep_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def cli_mask(imap):
    """train_glm's L2 mask: 0 on the intercept, if the run has one."""
    from photon_ml_tpu_torch.types import INTERCEPT_KEY

    if not imap.has_intercept:
        return None
    mask = np.ones(len(imap))
    mask[imap.key_to_index[INTERCEPT_KEY]] = 0.0
    return mask


# --------------------------------------------------------------------------
# phase 10: scoring, batch (score_game) and online (engine, HTTP)
# --------------------------------------------------------------------------

#: score_game's AUC vs phase 8's rescored best/ (the same model and rows)
SCORE_AUC_TOL = 1e-6
#: the engine at serve_game's default max batch: buckets 1 .. 1024 are 11
#: CUDA graphs; ENGINE_RECORDS validation records in batches of seeded
#: random sizes from 1 to ENGINE_MAX_REQUEST (some chunked past 1024)
ENGINE_MAX_BATCH = 1024
ENGINE_CAPTURES = 11
ENGINE_RECORDS = 20_000
ENGINE_MAX_REQUEST = 1_500
#: quantized tables vs f32: each row held to the error its storage format
#: allows (:func:`quant_bounds`); the JAX package's gates relative to
#: max(|f32|, 1) (tests/test_serving.py: bf16 1e-2, int8 5e-2, set on a
#: 3-wide random effect) are printed beside them.
QUANT_RTOL = {"bfloat16": 1e-2, "int8": 5e-2}
#: table bytes a row of d coefficients: f32 4d, bf16 2d, int8 d plus its
#: f32 scale (so int8 is 4d / (d + 4) below f32: 2.67x at the 8-wide item
#: shard, 3.69x at the JAX package's 48-wide test table)
ROW_BYTES = {"float32": lambda d: 4 * d, "bfloat16": lambda d: 2 * d,
             "int8": lambda d: d + 4}
#: HTTP: client threads x single-record POSTs to /score, microbatch 64
HTTP_THREADS = 8
HTTP_REQUESTS = 250
HTTP_MICROBATCH = 64
E2E_SHARDS = "global=g|intercept,item=it|noIntercept"


def score_batch_phase(run, valid, auc_phase8, device="cuda"):
    """(a) ``score_game.run`` over phase 8's validation file with AUC and
    the breakdown; returns its scores (f32, file order)."""
    from photon_ml_tpu_torch import native
    from photon_ml_tpu_torch.cli import score_game
    from photon_ml_tpu_torch.game.model import sum_coordinate_margins
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    out = os.path.join(os.path.dirname(run), "scores")
    with Counted(native, "write_scoring_results") as nat, \
            Counted(score_game, "write_avro_file") as py:
        t0 = time.perf_counter()
        result = score_game.run([
            "--data", valid, "--model-dir", run, "--output-dir", out,
            "--feature-shards", E2E_SHARDS, "--evaluators", "AUC",
            "--score-breakdown", "--device", device])
        wall = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        stages = [json.loads(line) for line in f]
    auc = result["evaluation"]["AUC"]
    log(f"[10a] score_game.run, {result['n_scored']} records: {wall:.2f} s")
    for st in stages:
        if "seconds" in st:
            log(f"  {st['stage']}: {st['seconds']:.3f} s")
    log(f"  writer: native {nat.calls}, python {py.calls}; AUC "
        f"{auc:.7f}, phase 8 {auc_phase8:.7f} (|diff| "
        f"{abs(auc - auc_phase8):.2e}, limit {SCORE_AUC_TOL:g})")
    assert nat.calls == 1 and py.calls == 0, (nat.calls, py.calls)
    assert abs(auc - auc_phase8) <= SCORE_AUC_TOL, (auc, auc_phase8)
    t0 = time.perf_counter()
    scores = np.array([r["predictionScore"] for r in iter_avro_file(
        os.path.join(out, "scores.avro"))])
    with open(os.path.join(out, "score-breakdown.json")) as f:
        breakdown = json.load(f)
    # the validation records carry no offsets
    totals = sum_coordinate_margins(
        np.zeros(len(scores), np.float32),
        (np.asarray(breakdown[cid], np.float32)
         for cid in ("global", "perUser", "perSong")))
    assert list(breakdown) == ["global", "perUser", "perSong"], \
        list(breakdown)
    assert np.array_equal(totals.astype(np.float64), scores)
    assert np.array_equal(scores.astype(np.float32).astype(np.float64),
                          scores)
    log(f"  breakdown totals bit-identical to scores.avro "
        f"({time.perf_counter() - t0:.2f} s to read both)")
    return scores.astype(np.float32)


def _unseen(records):
    """The records with ids no model saw, and the same without ids."""
    named = [{**r, "metadataMap": {"userId": f"uNEVER{i}",
                                   "songId": f"sNEVER{i}"}}
             for i, r in enumerate(records)]
    return named, [{**r, "metadataMap": {}} for r in records]


def quant_bounds(sm, records):
    """Per record, the most its f32 score can move when its random-effect
    rows are stored in bf16 or int8: a bf16 row rounds each coefficient
    to 8 significant bits (|dw| <= 2^-8 |w|), an int8 row to a multiple
    of its scale max|w|/127 (|dw| <= scale/2); the f32 roundings of the
    margins and the total add 2^-22 (|total| + sum |margin|). ``sm`` is
    the f32 version."""
    return quant_bounds_batch(sm, sm.engine.pack(records))


def quant_bounds_batch(sm, batch):
    """:func:`quant_bounds` of an already packed batch."""
    total, margins = sm.engine.score_batch(batch, with_margins=True)
    slack = 2.0 ** -22 * (np.abs(total) + sum(np.abs(m) for m in margins))
    x_of = dict(zip(sm.engine._shard_order, batch.xs))
    bounds = {"bfloat16": slack.astype(np.float64),
              "int8": slack.astype(np.float64)}
    for cid, rows in zip(sm.engine._re_order, batch.rows):
        store = sm.stores[cid]
        w = np.abs(store.table.cpu().numpy().astype(np.float64))[rows]
        x = np.abs(x_of[store.feature_shard_id].astype(np.float64))
        bounds["bfloat16"] += 2.0 ** -8 * (x * w).sum(1)
        bounds["int8"] += 0.5 * w.max(1) / 127.0 * x.sum(1)
    return bounds


def serve_engine_phase(run, records, want, device="cuda"):
    """(b) the engine in each table format over ``records`` in batches of
    seeded random sizes; returns the f32 scores."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.serving import ModelRegistry, next_bucket
    from photon_ml_tpu_torch.serving import engine as serving_engine

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    sizes = []
    rng = np.random.default_rng(10)
    while sum(sizes) < len(records):
        sizes.append(int(rng.integers(1, ENGINE_MAX_REQUEST + 1)))
    sizes[-1] -= sum(sizes) - len(records)
    assert max(sizes) > ENGINE_MAX_BATCH, sizes
    latency = serving_engine._SCORE_LATENCY
    scores, table_bytes = {}, {}
    for dtype in ("float32", "bfloat16", "int8"):
        registry = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                                 table_dtype=dtype, device=device)
        t0 = time.perf_counter()
        sm = registry.load(run)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        captures = sm.engine.warmup()
        warm_s = time.perf_counter() - t0
        frozen = sm.engine.compile_count
        before = {b: latency.labels(bucket=str(b)).snapshot()[1:]
                  for b in (1 << k for k in range(ENGINE_CAPTURES))}
        per_bucket = {}
        out, lo = [], 0
        t0 = time.perf_counter()
        for n in sizes:
            t1 = time.perf_counter()
            batch = sm.engine.pack(records[lo:lo + n])
            t2 = time.perf_counter()
            out.append(sm.engine.score_batch(batch))
            t3 = time.perf_counter()
            b = next_bucket(min(n, ENGINE_MAX_BATCH))
            acc = per_bucket.setdefault(b, [0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += t2 - t1
            acc[2] += t3 - t2
            lo += n
        wall = time.perf_counter() - t0
        got = np.concatenate(out)
        scores[dtype] = got
        table_bytes[dtype] = sum(s.table_bytes for s in sm.stores.values())
        assert table_bytes[dtype] == sum(
            s.table.shape[0] * ROW_BYTES[dtype](s.dim)
            for s in sm.stores.values()), (dtype, table_bytes[dtype])
        log(f"[10b] engine {dtype} on {device}: load {load_s:.2f} s, "
            f"warmup {captures} captures {warm_s:.2f} s; {len(records)} "
            f"records in {len(sizes)} batches (sizes 1-{max(sizes)}) "
            f"{wall:.2f} s; captures after warmup "
            f"{sm.engine.compile_count - frozen}; tables {table_bytes[dtype]}"
            f" bytes")
        log("  bucket: batches, batch_assemble ms, execute ms (mean a "
            "batch; host clock), device leg ms (copy-in, replay, copy-out; "
            "mean a chunk)")
        for b in sorted(per_bucket):
            k, pack_s, exec_s = per_bucket[b]
            s0, c0 = before[b]
            _, s1, c1 = latency.labels(bucket=str(b)).snapshot()
            leg = 1e3 * (s1 - s0) / max(c1 - c0, 1)
            log(f"  {b:5d}: {k:3d}, {1e3 * pack_s / k:8.3f}, "
                f"{1e3 * exec_s / k:7.3f}, {leg:7.3f}")
        assert captures == ENGINE_CAPTURES, captures
        assert sm.engine.compile_count == frozen, sm.engine.compile_count
        named, anonymous = _unseen(records[:256])
        assert np.array_equal(sm.score(named), sm.score(anonymous)), dtype
        assert np.isfinite(got).all() and got.shape == (len(records),)
        if dtype == "float32":
            bounds = quant_bounds(sm, records)
        del registry, sm
    f32 = scores["float32"]
    mismatch = int(np.count_nonzero(f32 != want))
    log(f"  f32 vs score_game: {mismatch} of {len(f32)} scores differ "
        f"(bit parity)")
    assert mismatch == 0, mismatch
    for dtype, rtol in QUANT_RTOL.items():
        err = np.abs(scores[dtype].astype(np.float64) - f32)
        rel = err / np.maximum(np.abs(f32), 1.0)
        worst = float((err / bounds[dtype]).max())
        log(f"  {dtype} vs f32: |diff| at most {worst:.3f} of the format's "
            f"bound; relative to max(|f32|, 1): max {rel.max():.3e}, p99 "
            f"{np.percentile(rel, 99):.3e}, {int((rel > rtol).sum())} rows "
            f"above the JAX package's {rtol:g}; tables "
            f"{table_bytes['float32'] / table_bytes[dtype]:.2f}x below f32")
        assert worst <= 1.0, (dtype, worst)
    return f32


def serve_http_phase(run, records, want, device="cuda"):
    """(c) ``serve_game``'s server on port 0: HTTP_THREADS clients of at
    least HTTP_REQUESTS single-record POSTs each over loopback; a /reload
    of the same directory once a quarter of them are answered, the
    clients going on until it has answered."""
    import http.client
    import threading

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.telemetry import metrics

    n = HTTP_THREADS * HTTP_REQUESTS
    assert len(records) >= n
    t0 = time.perf_counter()
    server = serve_game.build_server([
        "--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
        "--microbatch", str(HTTP_MICROBATCH), "--device", device]).start()
    log(f"[10c] serve_game on {server.url}: up in "
        f"{time.perf_counter() - t0:.2f} s")
    host, port = server.url.rsplit("/", 1)[1].split(":")
    stage_hist = metrics.default_registry().get("photon_serving_stage_seconds")
    stages = ("parse", "queue_wait", "batch_assemble", "execute", "respond")
    before = {st: stage_hist.labels(stage=st).snapshot()[1:]
              for st in stages}
    replies = [[] for _ in range(HTTP_THREADS)]  # (record, score, seconds)
    failures, versions, answered = [], set(), [0]
    lock = threading.Lock()
    reload_at, reloaded = threading.Event(), threading.Event()

    def client(t):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            k = 0
            while k < HTTP_REQUESTS or not reloaded.is_set():
                i = t * HTTP_REQUESTS + k % HTTP_REQUESTS
                k += 1
                body = json.dumps({"record": records[i]})
                t1 = time.perf_counter()
                conn.request("POST", "/score", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = json.loads(resp.read())
                seconds = time.perf_counter() - t1
                if resp.status != 200:
                    failures.append((i, resp.status, data))
                    break
                replies[t].append((i, data["scores"][0], seconds))
                with lock:
                    versions.add(data["version"])
                    answered[0] += 1
                    if answered[0] == n // 4:
                        reload_at.set()
        except Exception as e:  # a failed request fails the phase
            failures.append((t, repr(e)))
        finally:
            conn.close()

    reload_out = {}

    def reloader():
        try:
            if not reload_at.wait(300):
                return
            conn = http.client.HTTPConnection(host, int(port), timeout=300)
            try:
                t1 = time.perf_counter()
                conn.request("POST", "/reload", "{}",
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                reload_out.update(status=resp.status,
                                  body=json.loads(resp.read()),
                                  seconds=time.perf_counter() - t1)
            finally:
                conn.close()
        finally:
            reloaded.set()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(HTTP_THREADS)]
    threads.append(threading.Thread(target=reloader))
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        n_batches = server.service.batcher.n_batches
        health = server.service.healthz()
    finally:
        server.stop()
    assert not any(th.is_alive() for th in threads)
    done = [r for rs in replies for r in rs]
    latency = np.array([sec for _, _, sec in done])
    p50, p99 = (1e3 * float(np.percentile(latency, q)) for q in (50, 99))
    log(f"  {len(done)} requests ({HTTP_THREADS} threads, at least "
        f"{HTTP_REQUESTS} each) in {wall:.2f} s ({len(done) / wall:.0f}/s); "
        f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; microbatcher "
        f"{n_batches} batches, mean {len(done) / max(n_batches, 1):.2f} "
        f"requests a batch; reload {reload_out.get('status')} in "
        f"{reload_out.get('seconds', 0):.2f} s (versions served "
        f"{sorted(versions)}); captures {health['compiles']}")
    parts = []
    for st in stages:
        s0, c0 = before[st]
        _, s1, c1 = stage_hist.labels(stage=st).snapshot()
        parts.append(f"{st} {1e3 * (s1 - s0) / max(c1 - c0, 1):.3f} ms "
                     f"x {c1 - c0}")
    log(f"  stages (mean ms x count; batch_assemble and execute a batch, "
        f"the rest a request): {', '.join(parts)}")
    assert not failures, failures[:5]
    assert reload_out.get("status") == 200, reload_out
    assert versions == {1, 2}, versions
    mismatch = sum(np.float32(score) != want[i] for i, score, _ in done)
    log(f"  replies vs the engine's f32 scores: {mismatch} of {len(done)} "
        f"differ")
    assert mismatch == 0, mismatch
    assert len(done) >= n and health["compiles"] == ENGINE_CAPTURES, health


def run_scoring_phase(e2e_run, device="cuda"):
    """Phase 10 on phase 8's best/ and validation file."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    t_start = time.perf_counter()
    batch = score_batch_phase(e2e_run["run"], e2e_run["valid"],
                              e2e_run["auc"], device)
    records = []
    for rec in iter_avro_file(e2e_run["valid"]):
        records.append(rec)
        if len(records) == ENGINE_RECORDS:
            break
    f32 = serve_engine_phase(e2e_run["run"], records,
                             batch[:ENGINE_RECORDS], device)
    serve_http_phase(e2e_run["run"], records, f32, device)
    log(f"[10] done in {time.perf_counter() - t_start:.1f} s")
    return records


# --------------------------------------------------------------------------
# phase 11: incremental training — refresh_game, a locked warm start,
# checkpoint and resume, the divergence guard
# --------------------------------------------------------------------------

#: day 2's new part file: rows of make_e2e's generator drawn from other seeds
DAY2_ROWS = 50_000
DAY2_SEEDS = (2026, 2027)
#: a refresh on unchanged data vs the same solve through train_game, and a
#: resumed run vs the uninterrupted one: the CLI's AUC limit
REFRESH_AUC_TOL = 1e-4
#: (d): tests/test_game.py::TestMidRunResume's limits for a resumed run
RESUME_TOL = dict(rtol=5e-3, atol=1e-3)
#: one NaN at the second coordinate step (perUser, sweep 0)
NAN_ON_PER_USER = {"seed": 0, "specs": [
    {"site": "optimizer.step", "at": [1], "mode": "nan"}]}


def kernel_counters():
    from photon_ml_tpu_torch.ops import fused_glm, fused_hvp, fused_re

    return {"fused_glm": fused_glm.fused_value_and_grad,
            "fused_re": fused_re.fused_entity_value_and_grad,
            "fused_hvp": fused_hvp.fused_hvp,
            "fused_glm_multi": fused_glm.fused_value_and_grad_multi}


def counted_call(fn, *args):
    """``fn(*args)`` with every kernel's launch count set to 0 just before
    and read just after: (result, wall seconds, launches)."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    result = fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, wall, {k: c.launches for k, c in counters.items()}


def flag_args(args, **flags):
    """``args`` with each ``--flag value`` of ``flags`` (underscores for
    dashes) replaced, appended when absent, dropped when None."""
    args = list(args)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if flag in args:
            i = args.index(flag)
            del args[i:i + 2]
        if value is not None:
            args += [flag, str(value)]
    return args


def refresh_args(prior, train, valid, out):
    """refresh_game with phase 8's shards, coordinates, grid and design
    dtype."""
    return flag_args(cli_args(train, valid, out), cd_iterations=None,
                     prior_dir=prior)


#: the (kind, coordinate id) of each coordinate of phase 8's model
MODEL_COORDINATES = (("fixed-effect", "global"),
                     ("random-effect", "perUser"),
                     ("random-effect", "perSong"))


def coefficient_records(model_dir, cid, kind="random-effect"):
    """raw model id -> the ``means`` of its coefficient record, of one
    coordinate of a model directory."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    return {r["modelId"]: r["means"] for r in iter_avro_file(os.path.join(
        model_dir, kind, cid, "coefficients", "part-00000.avro"))}


def same_records(a, b, coordinates=MODEL_COORDINATES):
    """Whether the model directories ``a`` and ``b`` hold the same
    coefficient records of each (kind, coordinate id) of ``coordinates``
    (by model id, as :func:`coefficient_records` compares them): a part
    file equal to the other's but for its sync markers holds the same
    records and decodes neither; any other pair is decoded and compared."""
    for kind, cid in coordinates:
        paths = [os.path.join(d, kind, cid, "coefficients", "part-00000.avro")
                 for d in (a, b)]
        if not (same_avro_content(*paths)
                or coefficient_records(a, cid, kind)
                == coefficient_records(b, cid, kind)):
            return False
    return True


def same_lineage(a, b):
    """``model_lineage_id(a) == model_lineage_id(b)`` for two model
    directories, decoding neither where their metadata agree but for the
    lineage fields and every part file equals the other's but for its sync
    markers (the same records in the same order)."""
    from photon_ml_tpu_torch.io import model_io

    metas = []
    for d in (a, b):
        with open(os.path.join(d, "model-metadata.json")) as f:
            meta = json.load(f)
        for field in model_io.LINEAGE_FIELDS:
            meta.pop(field, None)
        metas.append(meta)
    if metas[0] == metas[1] and all(
            same_avro_content(*(os.path.join(d, info["type"], cid,
                                              "coefficients",
                                              "part-00000.avro")
                                for d in (a, b)))
            for cid, info in metas[0]["coordinates"].items()):
        return True
    return model_io.model_lineage_id(a) == model_io.model_lineage_id(b)


def stages_of(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def log_run(label, wall, launches, out, auc=None):
    lines = stages_of(out)
    # metrics.jsonl appends: the stages of the run from its last read on
    first = max(i for i, m in enumerate(lines)
                if m.get("stage") == "Read training data")
    stages = ", ".join(f"{m['stage']} {m['seconds']:.3f}"
                       for m in lines[first:] if "seconds" in m)
    log(f"[11] {label}: {wall:.2f} s; launches {launches}; "
        + (f"AUC {auc:.7f}; " if auc is not None else "") + stages)


def write_day2(tg, train_path, root):
    """Day 2: phase 8's training parts and one new part file of DAY2_ROWS
    rows after them, in a directory. Returns (directory, the new part's
    raw user and song ids)."""
    from photon_ml_tpu_torch.io import data_reader

    day2 = os.path.join(root, "day2")
    os.makedirs(day2)
    parts = sorted(os.listdir(train_path))
    for name in parts:
        os.link(os.path.join(train_path, name), os.path.join(day2, name))
    new, _ = make_e2e(tg, DAY2_ROWS, E2E["users"], E2E["songs"], 1,
                      draw_seeds=DAY2_SEEDS)
    t0 = time.perf_counter()
    data_reader.write_training_examples(
        os.path.join(day2, f"part-{len(parts):05d}.avro"), e2e_records(new),
        codec="null")
    log(f"[11] wrote day 2's new part ({DAY2_ROWS} records) in "
        f"{time.perf_counter() - t0:.2f} s (pure Python, not in the walls)")
    ids = {"perUser": {f"u{u}" for u in new.id_columns["userId"].tolist()},
           "perSong": {f"s{s}" for s in new.id_columns["songId"].tolist()}}
    return day2, ids


def run_refresh_phase(tg, e2e_run, phase8_launches, tmp):
    """Phase 11 on phase 8's run directory and Avro; returns the kernels'
    launches of (b) the day-2 refresh and (c) the locked warm start, and
    (b)'s run directory (its merged model, ``best/``, and its patch)."""
    from photon_ml_tpu_torch.cli import refresh_game, train_game
    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.resilience import faults

    t_start = time.perf_counter()
    prior = e2e_run["run"]
    prior_best = os.path.join(prior, "best")
    day2, new_ids = write_day2(tg, e2e_run["train"], tmp)
    prior_re = {cid: coefficient_records(prior_best, cid)
                for cid in ("perUser", "perSong")}

    # (a) refresh on unchanged data: nothing solves and the fixed effect
    # retrains — against the random effects' scores, which phase 8's one
    # sweep trained it without, so its AUC is held to the same warm-started
    # solve through train_game with both random effects locked
    out_a = os.path.join(tmp, "refresh_same")
    res_a, wall, launches = counted_call(refresh_game.run, refresh_args(
        prior, e2e_run["train"], e2e_run["valid"], out_a))
    auc_a = res_a["evaluation"]["AUC"]
    log_run("(a) refresh_game on phase 8's data", wall, launches, out_a,
            auc_a)
    out_fe = os.path.join(tmp, "fixed_effect_only")
    res_fe, wall_fe, launches_fe = counted_call(train_game.run, cli_args(
        e2e_run["train"], e2e_run["valid"], out_fe) + [
        "--model-input-dir", prior,
        "--locked-coordinates", "perUser,perSong"])
    auc_fe = res_fe["best_evaluation"]["AUC"]
    log_run("(a) train_game --locked-coordinates perUser,perSong", wall_fe,
            launches_fe, out_fe, auc_fe)
    log(f"  touched {res_a['touched']} solved {res_a['solved']} carried "
        f"{res_a['carried']}; AUC |diff| from the locked run "
        f"{abs(auc_a - auc_fe):.2e} (limit {REFRESH_AUC_TOL:g}), from "
        f"phase 8 {auc_a - e2e_run['auc']:+.2e} (not gated)")
    assert res_a["solved"] == res_a["touched"] == {
        "global": 0, "perUser": 0, "perSong": 0}, res_a
    assert launches["fused_glm"] > 0 and launches["fused_re"] == 0, launches
    assert launches_fe["fused_re"] == 0, launches_fe
    assert (coefficient_records(os.path.join(out_a, "best"), "global",
                                "fixed-effect")
            == coefficient_records(os.path.join(out_fe, "best"), "global",
                                   "fixed-effect"))
    for cid in ("perUser", "perSong"):
        assert coefficient_records(os.path.join(out_a, "best"),
                                   cid) == prior_re[cid], cid
    assert abs(auc_a - auc_fe) <= REFRESH_AUC_TOL, (auc_a, auc_fe)

    # (b) refresh on day 2: exactly the new part's entities solve, every
    # other entity carries bit for bit, the patch holds the solved rows
    out_b = os.path.join(tmp, "refresh_day2")
    res_b, wall_b, launches_b = counted_call(refresh_game.run, refresh_args(
        prior, day2, e2e_run["valid"], out_b))
    auc_b = res_b["evaluation"]["AUC"]
    log_run("(b) refresh_game on day 2", wall_b, launches_b, out_b, auc_b)
    log(f"  touched {res_b['touched']} solved {res_b['solved']} carried "
        f"{res_b['carried']}")
    assert launches_b["fused_glm"] > 0 and launches_b["fused_re"] > 0
    merged_best = os.path.join(out_b, "best")
    patch = os.path.join(out_b, "patch")
    new_counts = {}
    for cid, touched in new_ids.items():
        merged = coefficient_records(merged_best, cid)
        patched = coefficient_records(patch, cid)
        new = touched - set(prior_re[cid])
        carried = set(prior_re[cid]) - touched
        changed = sum(merged[raw] != prior_re[cid][raw]
                      for raw in carried)
        log(f"  {cid}: {len(touched)} touched on the host, {len(patched)} "
            f"in the patch, {len(new)} new, {len(carried)} carried "
            f"({changed} not bit-identical)")
        assert res_b["touched"][cid] == res_b["solved"][cid] == len(touched)
        assert set(patched) == touched, cid
        assert new <= set(merged), cid
        assert changed == 0, cid
        assert set(merged) == set(prior_re[cid]) | touched, cid
        assert all(patched[raw] == merged[raw] for raw in patched), cid
        new_counts[cid] = len(new)
    # users day 1 never saw (songs: the draw may add none)
    assert new_counts["perUser"] > 0, new_counts
    assert (coefficient_records(patch, "global", "fixed-effect")
            == coefficient_records(merged_best, "global", "fixed-effect"))
    out_cold = os.path.join(tmp, "cold_day2")
    res_c, wall_c, launches_c = counted_call(train_game.run, cli_args(
        day2, e2e_run["valid"], out_cold))
    log_run("cold train_game on day 2 (for reference)", wall_c, launches_c,
            out_cold, res_c["best_evaluation"]["AUC"])

    # (c) a warm start from phase 8 with the fixed effect locked
    out_l = os.path.join(tmp, "locked_day2")
    res_l, wall_l, launches_l = counted_call(train_game.run, cli_args(
        day2, e2e_run["valid"], out_l) + [
        "--model-input-dir", prior, "--locked-coordinates", "global"])
    log_run("(c) train_game --model-input-dir --locked-coordinates global "
            "on day 2", wall_l, launches_l, out_l,
            res_l["best_evaluation"]["AUC"])
    log(f"  kernel-2 launches {launches_l['fused_re']} (phase 8: "
        f"{phase8_launches['fused_re']})")
    assert (coefficient_records(os.path.join(out_l, "best"), "global",
                                "fixed-effect")
            == coefficient_records(prior_best, "global", "fixed-effect"))
    assert launches_l["fused_glm"] == 0 and launches_l["fused_re"] > 0

    # (d) checkpoints over two sweeps; all but the earliest dropped; resume
    out_d = os.path.join(tmp, "checkpointed")
    args_d = flag_args(cli_args(e2e_run["train"], e2e_run["valid"], out_d),
                       cd_iterations=2) + ["--checkpoint"]
    res_d, wall_d, launches_d = counted_call(train_game.run, args_d)
    log_run("(d) train_game --checkpoint --cd-iterations 2", wall_d,
            launches_d, out_d, res_d["best_evaluation"]["AUC"])
    def records(cid):
        return coefficient_records(
            os.path.join(out_d, "best"), cid,
            "fixed-effect" if cid == "global" else "random-effect")

    full = {cid: records(cid) for cid in ("global", "perUser", "perSong")}
    ckpts = os.path.join(out_d, "checkpoints")
    steps = sorted(os.listdir(ckpts), key=lambda s: int(s.split("-")[1]))
    assert steps == ["step-4", "step-5", "step-6"], steps
    for s in steps[1:]:
        shutil.rmtree(os.path.join(ckpts, s))
    res_r, wall_r, launches_r = counted_call(train_game.run,
                                             args_d + ["--resume"])
    auc_d, auc_r = (res_d["best_evaluation"]["AUC"],
                    res_r["best_evaluation"]["AUC"])
    log_run("(d) the same, resumed from step 4", wall_r, launches_r, out_d,
            auc_r)
    # worst: the largest |diff|; ratio: the largest |diff| over its own
    # limit atol + rtol * |value| (the limit is met while it is <= 1)
    worst, ratio, at = 0.0, 0.0, None
    for cid, want in full.items():
        got = records(cid)
        assert set(got) == set(want), cid
        for raw, means in want.items():
            a = np.array([m["value"] for m in means])
            b = np.array([m["value"] for m in got[raw]])
            assert [m["name"] for m in means] == [m["name"]
                                                   for m in got[raw]]
            np.testing.assert_allclose(b, a, **RESUME_TOL)
            diff = np.abs(b - a)
            worst = max(worst, float(diff.max(initial=0.0)))
            r = diff / (RESUME_TOL["atol"] + RESUME_TOL["rtol"] * np.abs(a))
            if r.size and float(r.max()) > ratio:
                ratio, at = float(r.max()), (cid, raw)
    log(f"  resumed vs uninterrupted: max |coefficient diff| {worst:.2e}; "
        f"worst |diff| / (atol + rtol*|value|) {ratio:.3f} at {at}; "
        f"AUC |diff| {abs(auc_r - auc_d):.2e} (limit {REFRESH_AUC_TOL:g})")
    assert abs(auc_r - auc_d) <= REFRESH_AUC_TOL, (auc_r, auc_d)
    assert 0 < launches_r["fused_re"] < launches_d["fused_re"]

    # (e) one NaN at perUser's step under --on-divergence rollback, the
    # plan read from PHOTON_FAULT_PLAN; then under fail, in a process of
    # its own, which must exit non-zero
    plan_json = json.dumps(NAN_ON_PER_USER)
    events = []
    unsubscribe = GLOBAL_BUS.subscribe(lambda e: events.append(e))
    os.environ["PHOTON_FAULT_PLAN"] = plan_json
    try:
        faults._activate_from_env()
        out_e = os.path.join(tmp, "rollback")
        res_e, wall_e, launches_e = counted_call(train_game.run, cli_args(
            e2e_run["train"], e2e_run["valid"], out_e) + [
            "--on-divergence", "rollback"])
    finally:
        faults.deactivate()
        del os.environ["PHOTON_FAULT_PLAN"]
        unsubscribe()
    log_run("(e) train_game --on-divergence rollback, NaN at perUser",
            wall_e, launches_e, out_e, res_e["best_evaluation"]["AUC"])
    seen = [(e.name, e.payload.get("coordinate"), e.payload.get("reg_backoff"))
            for e in events if e.name in ("fault_injected",
                                          "divergence_detected",
                                          "coordinate_rollback",
                                          "coordinate_frozen")]
    (div,) = [m for m in stages_of(out_e) if m.get("stage") == "divergence"]
    log(f"  events {seen}; regularization after: {div['regularization']}")
    assert seen == [("fault_injected", "perUser", None),
                    ("divergence_detected", "perUser", None),
                    ("coordinate_rollback", "perUser", 10.0)], seen
    assert div["regularization"] == [{
        "global": E2E_LAMBDAS["global"],
        "perUser": 10 * E2E_LAMBDAS["perUser"],
        "perSong": E2E_LAMBDAS["perSong"]}], div
    t0 = time.perf_counter()
    failed = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch", "train_game"]
        + cli_args(e2e_run["train"], e2e_run["valid"],
                   os.path.join(tmp, "fail")) + ["--on-divergence", "fail"],
        env={**os.environ, "PHOTON_FAULT_PLAN": plan_json},
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    tail = failed.stderr.strip().splitlines()[-1:]
    log(f"[11] (e) --on-divergence fail in a process of its own: exit "
        f"{failed.returncode} in {time.perf_counter() - t0:.1f} s: {tail}")
    assert failed.returncode != 0 and "DivergenceError" in failed.stderr
    log(f"[11] done in {time.perf_counter() - t_start:.1f} s")
    return launches_b, launches_l, out_b


# --------------------------------------------------------------------------
# phase 12: the refresh -> serve loop — phase 11 (b)'s patch in serve_game
# --------------------------------------------------------------------------

#: the publish directory's poll interval (tests/test_continuous.py's
#: TestWatchDir polls at 0.2 s)
WATCH_POLL_S = 0.2
#: (b): replies naming the merged full model that the clients must read
#: after its activation before they stop, so version 3 is served under
#: load: a quarter of the clients' floor, the share phase 10 (c) serves
#: before its /reload
AFTER_FULL_REPLIES = HTTP_THREADS * HTTP_REQUESTS // 4
#: (d): the connection budget, and the connections held open to spend
#: it; any small budget shows the refusal, 4 keeps (d) to a few sockets
MAX_CONNECTIONS = 4


def table_rows(store, ids):
    """Each raw id's stored row, as the integers of its storage width
    (bit equality), and its int8 scale's bits (None for other formats);
    an id the store does not hold reads the fallback row."""
    rows = store.rows_for(ids)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[store.table.dtype]
    bits = store.table.view(view).cpu().numpy()[rows]
    scales = (None if store.scales is None
              else store.scales.view(torch.int32).cpu().numpy()[rows])
    return bits, scales


def split_line(sm):
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in sm.load_seconds.items())
    return f"{parts} (total {sum(sm.load_seconds.values()):.3f} s)"


def patch_tables_phase(run, patch, merged, records, device="cuda"):
    """(a) phase 8's best/ patched with phase 11 (b)'s patch, in each table
    format, against the merged model: tables equal row for row by raw id,
    bit for bit, scores equal, 11 captures a version at its warmup and
    none after. Returns the f32 scores of phase 8's model and of the
    merged one."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.serving import ModelRegistry, ScoringEngine
    from photon_ml_tpu_torch.serving.store import EntityCoefficientStore

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    full = None
    for dtype in ("float32", "bfloat16", "int8"):
        registry = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                                 warmup=True, table_dtype=dtype,
                                 device=device)
        parent = registry.load(run)
        if dtype == "float32":
            parent_f32 = parent.score(records)
        sm = registry.load_patch(patch)
        touched = {cid: len(s.row_of_id) - len(parent.stores[cid].row_of_id)
                   for cid, s in sm.stores.items()}
        log(f"[12a] {dtype}: phase 8's load: {split_line(parent)}; patch "
            f"activation (version {sm.version}): {split_line(sm)}; "
            f"captures {parent.engine.compile_count} + "
            f"{sm.engine.compile_count}; new entities {touched}")
        if dtype == "float32":
            full = registry.reload(merged)
            log(f"[12a] full /reload of the merged model (version "
                f"{full.version}): {split_line(full)}; captures "
                f"{full.engine.compile_count}")
            want = {cid: s for cid, s in full.stores.items()}
            engine = full.engine
        else:
            # the merged model's tables in this format: what a load does
            # after the decode, from the f32 load's model and vocabularies
            want = {cid: EntityCoefficientStore.build(
                cm, full.entity_vocabs[cm.random_effect_type],
                table_dtype=dtype, device=device)
                for cid, cm in full.model.coordinates.items()
                if cid in full.stores}
            engine = ScoringEngine(full.model, shards, full.index_maps,
                                   want, max_batch=ENGINE_MAX_BATCH,
                                   device=device)
            engine.warmup()
        for cid, store in sm.stores.items():
            ids = sorted(set(store.row_of_id) | set(want[cid].row_of_id))
            (a, sa), (b, sb) = table_rows(store, ids), \
                table_rows(want[cid], ids)
            mismatch = int((a != b).any(axis=1).sum())
            if sa is not None:
                mismatch += int((sa != sb).sum())
            log(f"  {cid}: {len(ids)} raw ids, {mismatch} rows differ from "
                f"the merged model's build")
            assert mismatch == 0, (dtype, cid, mismatch)
            assert store.n_entities == len(ids), (cid, store.n_entities)
        got = sm.score(records)
        ref = engine.score(records)
        differ = int(np.count_nonzero(got != ref))
        log(f"  {len(records)} records: {differ} patched scores differ from "
            f"the merged model's")
        assert differ == 0, (dtype, differ)
        assert np.isfinite(got).all() and got.shape == (len(records),)
        for version in (parent, sm):
            assert version.engine.compile_count == ENGINE_CAPTURES, \
                (dtype, version.version, version.engine.compile_count)
        if dtype == "float32":
            merged_f32 = got
            moved = int(np.count_nonzero(got != parent_f32))
            log(f"  the patch moved {moved} of {len(records)} scores")
            assert moved > 0
        del registry, parent, sm, want, engine
    return parent_f32, merged_f32


def publish(src, watch, name):
    """Hard-link ``src`` into ``watch/name`` as a publisher does: under a
    hidden name first, renamed into place."""
    staging = os.path.join(watch, f".{name}.tmp")
    shutil.copytree(src, staging, copy_function=os.link)
    os.rename(staging, os.path.join(watch, name))


def http_exchange(sock, method="GET", path="/healthz", body=None,
                  headers=None):
    """One keep-alive request on ``sock``: (status, headers, JSON body)."""
    data = b"" if body is None else json.dumps(body).encode()
    head = [f"{method} {path} HTTP/1.1", "Host: smoke",
            f"Content-Length: {len(data)}",
            "Content-Type: application/json"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed before a reply")
        buf += chunk
    raw, rest = buf.split(b"\r\n\r\n", 1)
    lines = raw.decode().split("\r\n")
    hdrs = dict(line.split(": ", 1) for line in lines[1:])
    while len(rest) < int(hdrs["Content-Length"]):
        rest += sock.recv(65536)
    return int(lines[0].split()[1]), hdrs, json.loads(rest)


def serve_loop_phase(run, patch, merged, records, want, tmp,
                     device="cuda"):
    """(b) serve_game with --watch-dir and --reqlog-dir under 8 client
    threads while a garbage entry, the patch and the merged model land in
    the watched directory; (c) two-phase /reload on the same server; the
    request log read back after it stops. ``want``: version -> the f32
    scores of ``records`` it must reply."""
    import socket
    import threading

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.serving import iter_reqlog

    watch = os.path.join(tmp, "publish")
    log_dir = os.path.join(tmp, "reqlog")
    os.makedirs(watch)
    t0 = time.perf_counter()
    server = serve_game.build_server([
        "--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
        "--microbatch", str(HTTP_MICROBATCH), "--device", device,
        "--watch-dir", watch, "--watch-poll-s", str(WATCH_POLL_S),
        "--reqlog-dir", log_dir, "--reqlog-sample", "1.0"]).start()
    log(f"[12b] serve_game --watch-dir --reqlog-dir on {server.url}: up in "
        f"{time.perf_counter() - t0:.2f} s")
    host, port = server.url.rsplit("/", 1)[1].split(":")
    registry = server.service.registry
    n = HTTP_THREADS * HTTP_REQUESTS
    replies = {}  # request id -> (record index, reply)
    failures, lock = [], threading.Lock()
    answered = {"all": 0, "after_full": 0}
    quarter, stop = threading.Event(), threading.Event()

    def client(t):
        sock = socket.create_connection((host, int(port)), timeout=120)
        try:
            k = 0
            while k < HTTP_REQUESTS or not stop.is_set():
                i = (t * HTTP_REQUESTS + k) % len(records)
                rid = f"c{t}-{k}"
                k += 1
                status, _, body = http_exchange(
                    sock, "POST", "/score", {"record": records[i]},
                    {"X-Photon-Request-Id": rid})
                if status != 200:
                    failures.append((rid, status, body))
                    return
                with lock:
                    replies[rid] = (i, body)
                    answered["all"] += 1
                    answered["after_full"] += body["version"] == 3
                    if answered["all"] == n // 4:
                        quarter.set()
        except Exception as e:  # a failed request fails the phase
            failures.append((t, repr(e)))
        finally:
            sock.close()

    def wait_for(pred, timeout_s=300.0):
        deadline = time.perf_counter() + timeout_s
        while not pred():
            if time.perf_counter() > deadline or failures:
                return False
            time.sleep(0.01)
        return True

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(HTTP_THREADS)]
    walls = {}
    try:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        assert quarter.wait(300), failures[:3]
        os.mkdir(os.path.join(watch, "a-garbage"))
        with open(os.path.join(watch, "a-garbage", "model-metadata.json"),
                  "w") as f:
            f.write("{ not json")
        t1 = time.perf_counter()
        publish(patch, watch, "b-patch")
        assert wait_for(lambda: registry.active_version == 2), \
            (registry.active_version, failures[:3])
        walls["patch"] = time.perf_counter() - t1
        mark = answered["all"]
        assert wait_for(lambda: answered["all"] >= mark + n // 4)
        t1 = time.perf_counter()
        publish(merged, watch, "c-full")
        assert wait_for(lambda: registry.active_version == 3), \
            (registry.active_version, failures[:3])
        walls["full"] = time.perf_counter() - t1
        assert wait_for(lambda: answered["after_full"] >= AFTER_FULL_REPLIES)
        stop.set()
        for th in threads:
            th.join(timeout=600)
        walls["traffic"] = time.perf_counter() - t0
        assert not any(th.is_alive() for th in threads)
        health = server.service.healthz()
        applied, rejected = server.watcher.n_applied, server.watcher.n_rejected
        captures = {v: registry.get(v).engine.compile_count
                    for v in registry.versions()}
        splits = {v: split_line(registry.get(v))
                  for v in registry.versions()}

        # (c) two-phase /reload on the same server
        two_phase = []
        sock = socket.create_connection((host, int(port)), timeout=300)
        try:
            def score_probe(tag):
                rid = f"probe-{tag}"
                status, _, body = http_exchange(
                    sock, "POST", "/score", {"record": records[0]},
                    {"X-Photon-Request-Id": rid})
                assert status == 200, body
                replies[rid] = (0, body)
                return body["version"]

            def reload(body):
                t1 = time.perf_counter()
                status, _, out = http_exchange(sock, "POST", "/reload", body)
                two_phase.append((body, status, out,
                                  time.perf_counter() - t1))
                return status, out

            status, out = reload({"model_dir": patch})
            assert status == 409 and "lineage" in out["error"], out
            assert out["version"] == 3 and score_probe("refused") == 3
            status, out = reload({"phase": "prepare", "model_dir": run})
            assert status == 200 and out["phase"] == "prepared", out
            assert out["version"] == 4 and out["previous"] == 3, out
            assert score_probe("prepared") == 3
            status, out = reload({"phase": "activate", "version": 4})
            assert status == 200 and out == {
                "version": 4, "previous": 3, "phase": "activated",
                "lineage": registry.get(4).lineage}, out
            assert score_probe("activated") == 4
            status, out = reload({"phase": "prepare", "model_dir": patch})
            assert status == 200 and out["version"] == 5, out
            assert score_probe("patch-prepared") == 4
            status, out = reload({"phase": "abort", "version": 5})
            assert status == 200 and out == {
                "version": 4, "retired": 5, "phase": "aborted"}, out
            assert registry.versions() == [1, 2, 3, 4]
            assert score_probe("aborted") == 4
        finally:
            sock.close()
        for v in registry.versions():
            captures.setdefault(v, registry.get(v).engine.compile_count)
    finally:
        server.stop()
    log(f"  {len(replies)} requests in {walls['traffic']:.2f} s; the "
        f"patch activated {walls['patch']:.2f} s after its publish, the "
        f"merged model {walls['full']:.2f} s after its; watcher applied "
        f"{applied}, rejected {rejected}; versions served "
        f"{sorted({b['version'] for _, b in replies.values()})}")
    for v, line in splits.items():
        log(f"  version {v}: {line}")
    for body, status, out, sec in two_phase:
        log(f"[12c] /reload {body} -> {status} in {sec:.2f} s: "
            f"{ {k: out[k] for k in out if k != 'error'} }")
    assert not failures, failures[:5]
    assert health["version"] == 3 and (applied, rejected) == (2, 1), \
        (health["version"], applied, rejected)
    assert all(c == ENGINE_CAPTURES for c in captures.values()), captures
    mismatch = [rid for rid, (i, body) in replies.items()
                if np.float32(body["scores"][0]) != want[body["version"]][i]]
    log(f"  replies vs their version's f32 scores: {len(mismatch)} of "
        f"{len(replies)} differ")
    assert not mismatch, mismatch[:5]

    t0 = time.perf_counter()
    logged = {e["requestId"]: e for e in iter_reqlog(log_dir)}  # photon-lint: disable=res-reqlog-read-home -- an audit of the log against the replies it answered, the reference's replay tool's read
    bad = [rid for rid, (_, body) in replies.items()
           if rid not in logged
           or logged[rid]["records"][0]["score"] != body["scores"][0]
           or logged[rid]["modelVersion"] != body["version"]
           or logged[rid]["modelLineage"] != body["lineage"]]
    log(f"[12b] request log: {len(logged)} records for {len(replies)} "
        f"answered requests ({time.perf_counter() - t0:.2f} s to read); "
        f"{len(bad)} disagree with their reply; health {health['reqlog']}")
    assert len(logged) == len(replies) and not bad, bad[:5]


def connection_budget_phase(run, device="cuda"):
    """(d) a second server with --max-connections 4: with 4 connections
    held open the next gets the typed 503, counted."""
    import socket

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.telemetry import metrics

    server = serve_game.build_server([
        "--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
        "--no-warmup", "--device", device,
        "--max-connections", str(MAX_CONNECTIONS)]).start()
    refused = metrics.default_registry().get(
        "photon_connections_refused_total")
    before = refused.value
    host, port = server.url.rsplit("/", 1)[1].split(":")
    held = []
    try:
        for _ in range(MAX_CONNECTIONS):
            sock = socket.create_connection((host, int(port)), timeout=60)
            held.append(sock)
            assert http_exchange(sock)[0] == 200
        extra = socket.create_connection((host, int(port)), timeout=60)
        try:
            status, headers, body = http_exchange(extra)
        finally:
            extra.close()
        _, _, ready = http_exchange(held[0], path="/readyz")
    finally:
        for sock in held:
            sock.close()
        server.stop()
    log(f"[12d] --max-connections {MAX_CONNECTIONS}: connection "
        f"{MAX_CONNECTIONS + 1} -> {status} {body}, Connection "
        f"{headers.get('Connection')}, Retry-After "
        f"{headers.get('Retry-After')}; refused counter +"
        f"{refused.value - before:g}; /readyz reasons {ready['reasons']}")
    assert status == 503 and body["reason"] == "connections", body
    assert headers.get("Connection") == "close" and "Retry-After" in headers
    assert refused.value - before == 1
    assert "connections_exhausted" in ready["reasons"]


def run_patch_serving_phase(e2e_run, refresh_run, records, tmp,
                            device="cuda"):
    """Phase 12 on phase 8's best/ and phase 11 (b)'s outputs."""
    t_start = time.perf_counter()
    run = e2e_run["run"]
    patch = os.path.join(refresh_run, "patch")
    parent_f32, merged_f32 = patch_tables_phase(run, patch, refresh_run,
                                                records, device)
    want = {1: parent_f32, 2: merged_f32, 3: merged_f32, 4: parent_f32}
    serve_loop_phase(run, patch, refresh_run, records, want,
                     os.path.join(tmp, "phase12"), device)
    connection_budget_phase(run, device)
    log(f"[12] done in {time.perf_counter() - t_start:.1f} s")


# --------------------------------------------------------------------------
# phase 13: the remaining GAME training options, through train_game
# --------------------------------------------------------------------------

#: phase 13 (a): elastic net with variances. The fixed effect's lambda
#: grows with the rows (its L1 half is what zeroes weak global features:
#: 3 of 33 at 20k rows and lambda 20, on the CPU)
OPTIONS_EN_LAMBDA = {"rows": 20_000, "global": 20.0}
#: a variance against 1 / its f64 Hessian diagonal (SIMPLE) at the saved
#: coefficients, the bf16 design rounded as the card used it: the f32
#: accumulation over up to 10^6 positive terms (blocked sums, ~log2(n)
#: roundings of 2^-24 each), with a margin of 30
OPTIONS_VAR_RTOL = 1e-4
#: FULL: the diagonal of the f64 pseudo-inverse, per entity within
#: 10 · D · 2^-23 · cond(H) relative (the f32 pseudo-inverse's rounding)
OPTIONS_FULL_RTOL_FACTOR = 10.0
#: entities whose variances are held to the f64 Hessian, per coordinate
OPTIONS_VAR_ENTITIES = 200
#: the saved back-projected model vs the in-memory projected one
OPTIONS_SCORE_TOL = 1e-6
#: phase 13 (d): fits per search
OPTIONS_TUNING_ITERATIONS = 4


def options_coords(kind, lam_global):
    """Phase 13's coordinate specs and grid: ``en`` (a), ``projected``
    (b)."""
    it = f"maxIter={E2E_MAX_ITER}"
    hist = "buckets=histogram,maxSampleBuckets=4"
    if kind == "en":
        coords = [
            f"global=fixed,shard=global,reg=ELASTIC_NET,alpha=0.5,"
            f"variance=SIMPLE,{it}",
            f"perUser=random,entity=userId,shard=item,reg=ELASTIC_NET,"
            f"alpha=0.7,variance=FULL,{it},{hist}",
            f"perSong=random,entity=songId,shard=item,reg=L2,"
            f"variance=SIMPLE,{it},{hist}"]
        grid = dict(E2E_LAMBDAS, **{"global": lam_global})
    else:
        coords = [
            f"global=fixed,shard=global,reg=L2,{it}",
            f"perUser=factored,entity=userId,shard=item,reg=L2,"
            f"projectedDim=2,factoredIterations=1,lamProjection=1,{it}",
            f"perSong=random,entity=songId,shard=item,reg=L2,"
            f"projector=RANDOM,projectedDim=4,{it},{hist}"]
        grid = dict(E2E_LAMBDAS)
    return coords, grid


def options_args(train, valid, out, coords, grid, dtype, device):
    return ["--training-data", train, "--validation-data", valid,
            "--output-dir", out, "--feature-shards", E2E_SHARDS,
            "--coordinates", *coords,
            "--update-sequence", "global,perUser,perSong",
            "--grid", *[f"{k}={v}" for k, v in grid.items()],
            "--data-validation", "VALIDATE_DISABLED",
            "--design-dtype", dtype, "--evaluators", "AUC",
            "--device", device]


class Patched:
    """``setattr(owner, name, wrap(original))`` for the ``with`` block (which
    gets the wrapper), the original restored after."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.wrap = wrap

    def __enter__(self):
        wrapper = self.wrap(self.fn)
        setattr(self.owner, self.name, wrapper)
        return wrapper

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def recorded_saves(saved):
    """A :class:`Patched` wrap of ``io/pipeline.py::save_game_model_atomic``
    (every GAME model directory the commands publish, the background
    saver's included) appending each save's arguments to ``saved``."""
    def record(save):
        def wrapper(path, model, *a, **kw):
            saved.append(dict(path=path, model=model, args=a, kwargs=kw))
            return save(path, model, *a, **kw)
        return wrapper
    return record


def options_run(train_game, label, args):
    """``train_game.run(args)`` with the kernels' launches counted around
    it; returns (result, launches, the saved in-memory model, AUC)."""
    from photon_ml_tpu_torch.io import pipeline

    saved = []
    with Patched(pipeline, "save_game_model_atomic", recorded_saves(saved)):
        res, wall, launches = counted_call(train_game.run, args)
    auc = res["best_evaluation"]["AUC"]
    out = args[args.index("--output-dir") + 1]
    stages = ", ".join(f"{m['stage']} {m['seconds']:.3f}"
                       for m in stages_of(out) if "seconds" in m)
    log(f"[13] {label}: {wall:.2f} s; launches {launches}; AUC {auc:.7f}; "
        + stages)
    return res, launches, (saved[-1]["model"] if saved else None), auc


def bf16_rounded(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def dense_f64(shard, bf16):
    x = np.zeros((shard.n_samples, shard.dim), np.float64)
    vals = bf16_rounded(shard.vals) if bf16 else shard.vals.astype(np.float64)
    np.add.at(x, (shard.rows(), shard.cols), vals)
    return x


def curvature(m):
    p = 1.0 / (1.0 + np.exp(-m))
    return p * (1.0 - p)


def check_variances(model, data, grid, tmp_best):
    """Phase 13 (a)'s variance checks on the in-memory model the run saved
    and the records it wrote: every coordinate's records carry variances
    in the reference layout, and each variance (the fixed effect's, and
    those of OPTIONS_VAR_ENTITIES sampled entities of each random effect)
    equals its f64 value at the saved coefficients. Returns the worst
    ratios |got - want| / limit."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    for kind, cid in (("fixed-effect", "global"),
                      ("random-effect", "perUser"),
                      ("random-effect", "perSong")):
        recs = list(iter_avro_file(os.path.join(
            tmp_best, kind, cid, "coefficients", "part-00000.avro")))
        assert recs, cid
        for r in recs:
            assert r["variances"] is not None, cid
            assert all(e["value"] > 0 for e in r["variances"]), cid
            means = [(e["name"], e["term"]) for e in r["means"]]
            var = [(e["name"], e["term"]) for e in r["variances"]]
            if kind == "fixed-effect":
                # the reference writes a fixed effect's variances for
                # every feature, its means above the sparsity threshold
                assert len(var) == 33 and set(means) <= set(var), cid
            else:
                assert means == var, cid
    worst = {}
    coords = model.coordinates
    xg = dense_f64(data.shards["global"], True)
    xi = dense_f64(data.shards["item"], True)
    fe = coords["global"].model.coefficients
    wg = fe.means.cpu().double().numpy()
    margins = xg @ wg
    diag = (xg * xg).T @ curvature(margins) + 0.5 * grid["global"]
    got = fe.variances.cpu().double().numpy()
    err = np.abs(got - 1.0 / diag) / (OPTIONS_VAR_RTOL / diag)
    worst["global"] = float(err.max())
    rng = np.random.default_rng(13)
    for cid, col, l2, full in (
            ("perUser", "userId", 0.3 * grid["perUser"], True),
            ("perSong", "songId", grid["perSong"], False)):
        m = coords[cid]
        ent_of = m.keys // m.dim
        ents = rng.choice(np.unique(ent_of), OPTIONS_VAR_ENTITIES,
                          replace=False)
        ids = data.id_columns[col]
        ratio = 0.0
        for e in ents:
            rows = np.flatnonzero(ids == e)
            sel = ent_of == e
            feats = m.keys[sel] % m.dim
            w = np.zeros(m.dim)
            w[feats] = m.coeffs[sel]
            x = xi[rows][:, feats]
            d2 = curvature(xi[rows] @ w + margins[rows])
            h = (x * d2[:, None]).T @ x + l2 * np.eye(len(feats))
            if full:
                want = np.diag(np.linalg.pinv(h))
                rtol = (OPTIONS_FULL_RTOL_FACTOR * len(feats) * 2.0 ** -23
                        * np.linalg.cond(h))
            else:
                want = 1.0 / np.diag(h)
                rtol = OPTIONS_VAR_RTOL
            ratio = max(ratio, float((np.abs(m.variances[sel] - want)
                                      / (rtol * np.abs(want))).max()))
        worst[cid] = ratio
        # the next coordinate's offsets: this one's margins on the bf16
        # design, as its buckets scored them
        item = data.shards["item"]
        rows = item.rows()
        w = m.lookup(ids[rows], item.cols).astype(np.float64)
        np.add.at(margins, rows, bf16_rounded(item.vals) * w)
    log(f"  variances vs f64 at the saved coefficients, worst |diff| / "
        f"limit: {worst}")
    assert all(v <= 1.0 for v in worst.values()), worst
    return worst


def read_run_data(run, train, valid):
    """The run's training and validation data, keyed by its index maps
    and the training file's entity vocabularies (as train_game keys
    them)."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.io import data_reader
    from photon_ml_tpu_torch.io.index import IndexMap

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    maps = {c.shard_id: IndexMap.load(os.path.join(
        run, "feature-indexes", f"{c.shard_id}.json")) for c in shards}
    reader = data_reader.AvroDataReader(shard_configs=shards,
                                        index_maps=maps)
    ids = ("songId", "userId")
    data, _, vocabs = reader.read(train, id_columns=ids)
    vdata, _, _ = reader.read(valid, id_columns=ids, entity_vocabs=vocabs)
    return data, vdata, maps, vocabs


def rescore_run(run, view, device):
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.io import model_io

    _, vdata, maps, vocabs = view
    model = model_io.load_game_model(model_io.resolve_game_model_dir(run),
                                     maps, vocabs, device=device)
    return parse_evaluators(["AUC"])[0].evaluate(
        model.score(vdata), vdata.labels, vdata.weights)


def small_files(tg, tmp):
    """SMALL's rows (phase 4's draw) written to Avro, for the card-vs-CPU
    runs."""
    from photon_ml_tpu_torch.io import data_reader

    train, valid = make_e2e(tg, **SMALL)
    paths = {}
    for name, data in (("train", train), ("valid", valid)):
        paths[name] = os.path.join(tmp, f"small_{name}.avro")
        data_reader.write_training_examples(paths[name], e2e_records(data),
                                            codec="null")
    return paths["train"], paths["valid"]


def run_options_phase(tg, e2e_run, auc_fe, tmp, device="cuda",
                      small_devices=("cuda", "cpu")):
    """Phase 13 on phase 8's Avro files; returns each run's kernel
    launches."""
    from photon_ml_tpu_torch import sampling
    from photon_ml_tpu_torch.cli import score_game, train_game
    from photon_ml_tpu_torch.io.avro import iter_avro_file
    from photon_ml_tpu_torch.ops import objective

    t_start = time.perf_counter()
    train, valid = e2e_run["train"], e2e_run["valid"]
    rows = E2E["rows"]
    lam_global = OPTIONS_EN_LAMBDA["global"] * rows / OPTIONS_EN_LAMBDA["rows"]
    launches = {}

    # (a) elastic net with variances, bf16 designs
    out_a = os.path.join(tmp, "options_en")
    coords, grid = options_coords("en", lam_global)
    _, launches["en"], model_a, auc_a = options_run(
        train_game, "(a) elastic net + variances, bf16", options_args(
            train, valid, out_a, coords, grid, "bfloat16", device))
    view = read_run_data(out_a, train, valid)
    data = view[0]
    zeros = {"global": int((model_a.coordinates["global"].model.coefficients
                            .means == 0).sum()),
             "perUser": int((model_a.coordinates["perUser"].coeffs
                             == 0).sum())}
    log(f"  exact zeros {zeros} (of 33 and "
        f"{len(model_a.coordinates['perUser'].coeffs)}); fixed-effect-only "
        f"AUC {auc_fe:.7f}")
    assert launches["en"]["fused_glm"] > 0 and launches["en"]["fused_re"] > 0
    assert all(z > 0 for z in zeros.values()), zeros
    assert auc_a > auc_fe, (auc_a, auc_fe)
    t0 = time.perf_counter()
    check_variances(model_a, data, grid, os.path.join(out_a, "best"))
    log(f"  variance checks in {time.perf_counter() - t0:.2f} s")
    del model_a, data

    # (b) the RANDOM projector and a factored coordinate, f32 designs
    out_b = os.path.join(tmp, "options_projected")
    coords, grid = options_coords("projected", lam_global)
    kernel2_d = set()

    def widths(kernel):
        def spy(loss, x, *args):
            kernel2_d.add(int(x.shape[-1]))
            return kernel(loss, x, *args)
        return spy

    with Patched(objective, "fused_entity_value_and_grad", widths):
        _, launches["projected"], model_b, auc_b = options_run(
            train_game, "(b) RANDOM projector + factored, f32", options_args(
                train, valid, out_b, coords, grid, "float32", device))
    for cid, d in (("perUser", 2), ("perSong", 4)):
        m = model_b.coordinates[cid]
        assert m.projector is not None and m.dim == d, cid
    in_memory = model_b.score(view[1])
    out_s = os.path.join(tmp, "options_projected_scores")
    score_game.run(["--data", valid, "--model-dir", out_b,
                    "--output-dir", out_s, "--feature-shards", E2E_SHARDS,
                    "--device", device])
    saved = np.array([r["predictionScore"] for r in iter_avro_file(
        os.path.join(out_s, "scores.avro"))])
    score_err = float((np.abs(saved - in_memory)
                       / (1.0 + np.abs(in_memory))).max())
    log(f"  kernel 2 ran on D = {sorted(kernel2_d)}; score_game on the "
        f"back-projected best/ vs the in-memory projected model: max "
        f"|diff| / (1 + |score|) {score_err:.2e} (limit "
        f"{OPTIONS_SCORE_TOL:g})")
    assert launches["projected"]["fused_re"] > 0, launches["projected"]
    assert kernel2_d == {2, 4}, kernel2_d
    assert score_err <= OPTIONS_SCORE_TOL, score_err
    assert auc_b > auc_fe, (auc_b, auc_fe)
    del model_b

    # (c) down-sampling: the fixed effect's weights over two sweeps
    out_c = os.path.join(tmp, "options_downsample")
    args_c = cli_args(train, valid, out_c)
    i = args_c.index("--coordinates") + 1
    args_c[i] += ",downsample=0.5"
    args_c = flag_args(args_c, cd_iterations=2, device=device)
    seen = []

    def weights_seen(kernel):
        def spy(loss, x, w, labels, offsets, weights):
            if not any(weights is s for _, s in seen):
                seen.append((labels, weights))
            return kernel(loss, x, w, labels, offsets, weights)
        return spy

    with Patched(objective, "fused_value_and_grad", weights_seen):
        _, launches["downsample"], _, _ = options_run(
            train_game, "(c) global downsample=0.5, 2 sweeps", args_c)
    sampler = sampling.BinaryClassificationDownSampler(rate=0.5)
    assert len(seen) == 2, len(seen)
    for sweep, (labels, weights) in enumerate(seen):
        y = labels.cpu().numpy()
        want = sampler.downsample(y, np.ones_like(y), sweep=sweep,
                                  uids=np.arange(y.size, dtype=np.int64))
        got = weights.cpu().numpy()
        log(f"  sweep {sweep}: {int((got > 0).sum())} of {y.size} rows "
            f"kept on the card, the host draw's exactly: "
            f"{bool(np.array_equal(got, want))}")
        assert np.array_equal(got, want), sweep
    assert launches["downsample"]["fused_glm"] > 0, launches["downsample"]
    del seen

    # (d) tuning, RANDOM and BAYESIAN: every fit's configuration and AUC
    def recorded(fit):
        fits = []

        def wrapper(est, *args, **kwargs):
            results = fit(est, *args, **kwargs)
            fits.extend((dict(r.configuration.regularization_weights),
                         r.evaluation.primary[1]) for r in results)
            return results

        wrapper.fits = fits
        return wrapper

    tuned = {}
    for mode, extra in (("RANDOM", []),
                        ("BAYESIAN", ["--tuning-range", "1e-3:1e3"])):
        out_d = os.path.join(tmp, f"options_tuning_{mode}")
        args_d = flag_args(cli_args(train, valid, out_d), device=device,
                           tuning=mode,
                           tuning_iterations=OPTIONS_TUNING_ITERATIONS) + extra
        with Patched(tg.GameEstimator, "fit", recorded) as fits:
            res, launches[f"tuning_{mode}"], _, auc = options_run(
                train_game, f"(d) --tuning {mode}", args_d)
        tuned[mode] = fits.fits
        best = max(fits.fits, key=lambda f: f[1])
        reload_auc = rescore_run(out_d, view, device)
        log(f"  fits {fits.fits}; best {res['best_config']}; best/ "
            f"rescored {reload_auc:.7f}")
        assert res["n_configurations"] == len(fits.fits) == \
            OPTIONS_TUNING_ITERATIONS
        assert res["best_config"] == best[0] and auc == best[1]
        assert abs(reload_auc - auc) <= RELOAD_AUC_TOL, (reload_auc, auc)
        if mode == "BAYESIAN":
            assert all(1e-3 <= v <= 1e3 for cfg, _ in fits.fits
                       for v in cfg.values()), fits.fits

    # (e) streaming buckets: bit for bit phase 8's cached run
    out_e = os.path.join(tmp, "options_streaming")
    args_e = cli_args(train, valid, out_e)
    i = args_e.index("--coordinates") + 2
    args_e[i] += ",cacheBuckets=false"
    res_e, launches["streaming"], _, auc_e = options_run(
        train_game, "(e) perUser cacheBuckets=false",
        flag_args(args_e, device=device))
    auc8 = next(m["AUC"] for m in stages_of(e2e_run["run"])
                if m.get("stage") == "best")
    same = same_lineage(os.path.join(out_e, "best"),
                        os.path.join(e2e_run["run"], "best"))
    log(f"  model records equal phase 8's: {same}; AUC {auc_e!r} vs phase "
        f"8's {auc8!r}")
    assert same and auc_e == auc8, (same, auc_e, auc8)

    # (a) and (b) at SMALL's size on the card and on the CPU
    s_train, s_valid = small_files(tg, tmp)
    lam_small = OPTIONS_EN_LAMBDA["global"] * SMALL["rows"] \
        / OPTIONS_EN_LAMBDA["rows"]
    small_auc = {}
    for kind, dtype in (("en", "bfloat16"), ("projected", "float32")):
        coords, grid = options_coords(kind, lam_small)
        for dev in small_devices:
            out = os.path.join(tmp, f"options_small_{kind}_{dev}")
            res, n, _, small_auc[kind, dev] = options_run(
                train_game, f"{SMALL['rows']}-row {kind} on {dev}",
                options_args(s_train, s_valid, out, coords, grid, dtype,
                             dev))
        if len(small_devices) == 2:
            d_auc = abs(small_auc[kind, "cuda"] - small_auc[kind, "cpu"])
            log(f"  |AUC cuda - AUC cpu| = {d_auc:.2e} (limit 1e-4)")
            assert d_auc < 1e-4, (kind, d_auc)
    # RANDOM's points do not depend on the fits: the CPU's are the card's
    out_r = os.path.join(tmp, "options_small_tuning_cpu")
    with Patched(tg.GameEstimator, "fit", recorded) as fits:
        options_run(train_game, "SMALL --tuning RANDOM on cpu", flag_args(
            cli_args(s_train, s_valid, out_r), device="cpu", tuning="RANDOM",
            tuning_iterations=OPTIONS_TUNING_ITERATIONS))
    lams_cpu = [cfg for cfg, _ in fits.fits]
    lams_card = [cfg for cfg, _ in tuned["RANDOM"]]
    log(f"  RANDOM's lambdas on the card equal the CPU run's bit for bit: "
        f"{lams_card == lams_cpu}")
    assert lams_card == lams_cpu, (lams_card, lams_cpu)
    log(f"[13] done in {time.perf_counter() - t_start:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 14: model quality and ranked retrieval
# --------------------------------------------------------------------------

#: (a): bootstrap replicates of train_glm --training-diagnostics (its
#: default), and the seeds of the draws injected into both devices' runs
QUALITY_REPLICATES = 16
QUALITY_DRAW_SEEDS = (0, 7)
#: (a): the f32 arithmetic of a chi-square from its 10 bins' sums (a few
#: roundings a term), relative, in check_hl_on_cpu's bound
HL_CHI_RTOL = 1e-6
#: (a) at 20k x 128: the lambda of the card-vs-CPU diagnostics runs
DIAG_SMALL_LAMBDA = 10.0
#: (c): ranked users, the k values, and the ranking engine's bounds (its
#: captures: user buckets 1 .. 8 times k buckets 1 .. 128)
RANK_USERS = 32
RANK_KS = (1, 10, 128)
RANK_MAX_K = 128
RANK_CAPTURES = 4 * 8
#: (c): /rank under HTTP_THREADS clients, this many GETs each
RANK_HTTP_REQUESTS = 100
#: (d): the canary's bound. A genuine refresh moves scores (the operator
#: widens --canary-bound for it, quality/canary.py); a negated item table
#: moves them by twice the item margin. Set between the two readings of a
#: CPU rehearsal of this phase at 20k rows with a day 2 of 1,000 rows (5
#: %, as here): the refresh's patch 1.247, the negated table 4.133
CANARY_BOUND = 2.5
CANARY_RESERVOIR_RECORDS = 1024
#: (e): serve_game's default --drift-threshold (PSI)
DRIFT_THRESHOLD = 0.25


class Recording:
    """An OptimizationProblem's stand-in that keeps each ``run``'s result
    (the diagnostics' lanes: per-lane |grad|, converged)."""

    def __init__(self, problem):
        self.problem, self.objective, self.results = (problem,
                                                      problem.objective, [])

    def run(self, data, w0, lam=0.0):
        result = self.problem.run(data, w0, lam)
        self.results.append(result)
        return result


def diagnostics_run(args):
    """``train_glm.run(args)`` (with ``--training-diagnostics``), its
    bootstrap and fitting curve fed draws from seeded CPU generators (so
    two devices' runs solve the same replicates) and recorded: each
    solve's result and the kernel launches inside it, the replicate
    weights, and the Hosmer–Lemeshow inputs. Returns (result, wall, run
    launches, seen)."""
    from photon_ml_tpu_torch import diagnostics
    from photon_ml_tpu_torch.cli import train_glm

    seen = {}
    real = (train_glm.bootstrap_coefficients, train_glm.fitting_curve,
            train_glm.hosmer_lemeshow)

    def launches_of(fn):
        counters = kernel_counters()
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        return out, {k: c.launches - before[k] for k, c in counters.items()}

    def boot(problem, data, w_point, lam=0.0, n_replicates=16, **kw):
        gen = torch.Generator().manual_seed(QUALITY_DRAW_SEEDS[0])
        weights = diagnostics.bootstrap_weights(
            data.weights.cpu(), n_replicates, gen).to(data.weights.device)
        rec = Recording(problem)
        report, n = launches_of(lambda: real[0](
            rec, data, w_point, lam, replicate_weights=weights, **kw))
        seen["boot"] = dict(report=report, weights=weights, lam=lam,
                            result=rec.results[0], launches=n)
        return report

    def fit(problem, train, validation, w0, lam=0.0, **kw):
        masks = diagnostics.portion_masks(
            train.n_samples, generator=torch.Generator().manual_seed(
                QUALITY_DRAW_SEEDS[1]))
        rec = Recording(problem)
        report, n = launches_of(lambda: real[1](
            rec, train, validation, w0, lam, masks=masks, **kw))
        seen["fit"] = dict(report=report, result=rec.results[0], launches=n)
        return report

    def hl(probs, labels, weights):
        report = real[2](probs, labels, weights)
        seen["hl"] = dict(report=report, probs=probs, labels=labels,
                          weights=weights)
        return report

    train_glm.bootstrap_coefficients, train_glm.fitting_curve, \
        train_glm.hosmer_lemeshow = boot, fit, hl
    try:
        # the run's launches as a difference: phase 14's own counts run on
        t0 = time.perf_counter()
        result, launches = launches_of(lambda: train_glm.run(args))
        wall = time.perf_counter() - t0
    finally:
        train_glm.bootstrap_coefficients, train_glm.fitting_curve, \
            train_glm.hosmer_lemeshow = real
    return result, wall, launches, seen


def check_replicate_gradients(label, c, seen):
    """Phase 9's gradient check on every bootstrap replicate: its reported
    |grad| against the exact f64 one, with the replicate's weights, within
    its f32 rounding scale. Returns [(f(w), |grad f(w)|)] per replicate."""
    boot = seen["boot"]
    result, lam = boot["result"], boot["lam"]
    base = c.wt
    out, worst = [], 0.0
    try:
        for b in range(result.w.shape[0]):
            c.wt = boot["weights"][b].double()
            w = result.w[b].double()
            f, gn, eps = elastic_net_objective(c, w, lam, 0.0, None)
            reported = float(result.grad_norm[b])
            assert abs(gn - reported) <= eps, (label, b, gn, reported, eps)
            worst = max(worst, abs(gn - reported) / eps)
            out.append((f, gn))
    finally:
        c.wt = base
    log(f"  {label}: {len(out)} replicates' reported |grad| match the f64 "
        f"|grad f| within their f32 scales (largest |diff| / scale "
        f"{worst:.3f}); iterations {result.iterations.tolist()}, converged "
        f"{[bool(v) for v in result.converged.tolist()]}")
    return out


def check_hl_on_cpu(label, seen):
    """The card's Hosmer–Lemeshow table against the CPU's on the same
    probabilities: the bins, counts and observed positives (sums of 0s and
    1s) equal; each bin's expected positives, an f32 sum of its n_b
    values w·p >= 0 added in another order on the card (atomics), within
    twice the recursive-summation bound (n_b - 1) 2^-24 Σ w·p; the
    chi-square within that bound carried through its partial derivatives
    in the expected positives, plus HL_CHI_RTOL for its own f32
    arithmetic."""
    from photon_ml_tpu_torch.diagnostics import hosmer_lemeshow

    card = seen["hl"]["report"]
    cpu = hosmer_lemeshow(*(seen["hl"][k].cpu() for k in
                            ("probs", "labels", "weights")))
    assert np.array_equal(card.bin_counts, cpu.bin_counts), label
    assert np.array_equal(card.observed_positives, cpu.observed_positives)
    n = cpu.bin_counts.astype(np.float64)
    obs = cpu.observed_positives.astype(np.float64)
    exp = cpu.expected_positives.astype(np.float64)
    bound = 2.0 * np.maximum(n - 1.0, 0.0) * U32 * exp
    d_exp = np.abs(card.expected_positives.astype(np.float64) - exp)
    assert (d_exp <= bound).all(), (label, d_exp, bound)
    # d chi2 / d E of (O - E)^2 / E + ((n - O) - (n - E))^2 / (n - E)
    neg = n - exp
    grad = (-2.0 * (obs - exp) / exp - (obs - exp) ** 2 / exp ** 2
            + 2.0 * (exp - obs) / neg + (exp - obs) ** 2 / neg ** 2)
    chi_bound = (float(np.sum(np.abs(grad) * bound))
                 + HL_CHI_RTOL * cpu.chi_square)
    d_chi = abs(card.chi_square - cpu.chi_square)
    log(f"  {label}: HL chi-square {card.chi_square:.6g} (p "
        f"{card.p_value:.4g}) on the card, {cpu.chi_square:.6g} on the CPU; "
        f"bins and observed positives equal; expected positives within "
        f"{float(np.max(d_exp / bound)):.3f} of their f32 summation bound, "
        f"chi-square |diff| {d_chi:.3e} <= {chi_bound:.3e}")
    assert d_chi <= chi_bound, (label, d_chi, chi_bound)


def diagnostics_phase(paths, lam, device="cuda",
                      small_devices=("cuda", "cpu")):
    """(a) ``train_glm --training-diagnostics`` on phase 9's 200k x 1024
    files with L-BFGS at phase 6's batched lambda on ``device``, and at
    20k x 128 with L-BFGS and TRON on each of ``small_devices`` (the card
    and the CPU), compared."""
    t0 = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(paths["dense"]), "diagnostics")
    args = ["--training-data", paths["dense"], "--validation-data",
            paths["dense_valid"], "--output-dir", out_dir,
            "--evaluators", "AUC", "--no-intercept",
            "--regularization-weights", f"{lam:g}",
            "--max-iterations", str(GLM_LBFGS_MAX_ITER),
            "--training-diagnostics", "--diagnostic-bootstrap-replicates",
            str(QUALITY_REPLICATES), "--device", device]
    result, wall, launches, seen = diagnostics_run(args)
    report = result["diagnostics_report"]
    with open(report) as f:
        doc = f.read()
    sections = [s.split("</h2>")[0] for s in doc.split("<h2>")[1:]]
    stages, _, imap = read_run(out_dir)
    log(f"[14a] train_glm --training-diagnostics (L-BFGS, lambda {lam:g}, "
        f"{QUALITY_REPLICATES} replicates) on {GLM['rows']} x {GLM['dim']}: "
        f"{wall:.2f} s; launches {launches}; report {len(doc)} bytes, "
        f"sections {sections}")
    for stage, sec in stages:
        log(f"  {stage}: {sec:.3f} s")
    for part in ("boot", "fit"):
        log(f"  {part} lanes: launches {seen[part]['launches']}")
        assert seen[part]["launches"]["fused_glm"] > 0, seen[part]
        assert seen[part]["launches"]["fused_glm_multi"] == 0, seen[part]
    assert launches["fused_glm_multi"] == 0, launches
    assert len(sections) == 6, sections
    train = read_glm_data(paths["dense"], imap, device)
    c = Contractions(train)
    check_replicate_gradients("200k x 1024", c, seen)
    if device == "cuda":
        check_hl_on_cpu("200k x 1024", seen)
    fit = seen["fit"]["report"]
    log(f"  fitting curve: portions {fit.portions.tolist()}, train "
        f"{fit.train_objective.tolist()}, validation "
        f"{fit.validation_objective.tolist()}")
    del train, c
    torch.cuda.empty_cache()

    # 20k x 128: L-BFGS and TRON (kernel 3), card vs CPU on the same draws
    worst_obj, worst_diag = 0.0, 0.0
    for optimizer in ("LBFGS", "TRON"):
        runs = []
        for i, device in enumerate(small_devices):
            out = os.path.join(os.path.dirname(paths["small"]),
                               f"diagnostics_{optimizer}_{i}_{device}")
            r, sec, n, sn = diagnostics_run([
                "--training-data", paths["small"], "--validation-data",
                paths["small_valid"], "--output-dir", out, "--evaluators",
                "AUC", "--no-intercept", "--regularization-weights",
                f"{DIAG_SMALL_LAMBDA:g}", "--optimizer", optimizer,
                "--tolerance", f"{GLM_SMALL_TOLERANCE:g}",
                "--training-diagnostics", "--device", device])
            _, lams, imap = read_run(out)
            c = Contractions(read_glm_data(paths["small"], imap, device))
            grads = check_replicate_gradients(
                f"{device} {optimizer}", c, sn)
            point = lams[DIAG_SMALL_LAMBDA]
            f_point, _, _ = elastic_net_objective(
                c, point["w"], DIAG_SMALL_LAMBDA, 0.0, None)
            runs.append((sn, grads, point, f_point))
            log(f"[14a] {optimizer} on {GLM_SMALL['rows']} x "
                f"{GLM_SMALL['dim']} ({device}): {sec:.2f} s; launches {n}")
            if device == "cuda":
                assert n["fused_glm"] > 0 and n["fused_glm_multi"] == 0, n
                assert optimizer != "TRON" or n["fused_hvp"] > 0, n
                check_hl_on_cpu(f"cuda {optimizer}", sn)
        (sa, ga, pa, fpa), (sb, gb, pb, fpb) = runs
        conv_a = sa["boot"]["result"].converged.tolist()
        conv_b = sb["boot"]["result"].converged.tolist()
        for b, ((fa, g1), (fb, g2)) in enumerate(zip(ga, gb)):
            both = bool(conv_a[b]) and bool(conv_b[b])
            rel = abs(fa - fb) / abs(fb)
            worst_obj = max(worst_obj, rel)
            assert rel <= OBJECTIVE_RTOL[both], (optimizer, b, rel, both)
            # each replicate's objective is lambda-strongly convex (no
            # intercept): both solutions lie within |grad| / lambda of
            # the optimum
            gap = float(np.linalg.norm(
                sa["boot"]["report"].coefficients[b].astype(np.float64)
                - sb["boot"]["report"].coefficients[b]))
            bound = (g1 + g2) / DIAG_SMALL_LAMBDA
            assert gap <= bound, (optimizer, b, gap, bound)
        # the fitting curve's lanes, and the point model, as phase 9 holds
        # a lambda: objectives within OBJECTIVE_RTOL, the AUC within
        # CLI_AUC_TOL where both converged
        fa_, fb_ = sa["fit"]["report"], sb["fit"]["report"]
        conv = [bool(a) and bool(b) for a, b in zip(
            sa["fit"]["result"].converged.tolist(),
            sb["fit"]["result"].converged.tolist())]
        for name in ("train_objective", "validation_objective"):
            rel = np.abs(getattr(fa_, name) - getattr(fb_, name)) \
                / np.abs(getattr(fb_, name))
            worst_diag = max(worst_diag, float(rel.max()))
            for p_, r_ in enumerate(rel):
                assert r_ <= OBJECTIVE_RTOL[conv[p_]], (optimizer, name, p_,
                                                        r_)
        both = bool(pa["converged"]) and bool(pb["converged"])
        rel = abs(fpa - fpb) / abs(fpb)
        assert rel <= OBJECTIVE_RTOL[both], (optimizer, rel, both)
        assert not both or abs(pa["auc"] - pb["auc"]) <= CLI_AUC_TOL, \
            (optimizer, pa["auc"], pb["auc"])
        # the HL statistic, a sum of squared bin residuals that moves with
        # the two f32 trajectories, is logged
        hla, hlb = sa["hl"]["report"], sb["hl"]["report"]
        rel_e = float(np.max(np.abs(hla.expected_positives
                                    - hlb.expected_positives)
                             / hlb.expected_positives))
        log(f"  {optimizer}: point model converged {pa['converged']} / "
            f"{pb['converged']}, f64 f(w) relative |diff| {rel:.3e}, AUC "
            f"{pa['auc']:.7f} / {pb['auc']:.7f}; fitting lanes converged "
            f"{conv}; HL chi-square "
            f"{hla.chi_square:.6g} / {hlb.chi_square:.6g}, expected "
            f"positives within {rel_e:.2e} relative")
    log(f"[14a] {' vs '.join(small_devices)} at {GLM_SMALL['rows']} x "
        f"{GLM_SMALL['dim']}: replicate f64 objectives within "
        f"{worst_obj:.3e} relative, fitting-curve objectives within "
        f"{worst_diag:.3e} (limits {OBJECTIVE_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")


def baseline_phase(run, valid):
    """(b) phase 8's quality-baseline.json against ``compute_baseline``
    recomputed on the CPU from phase 10 (a)'s saved scores and breakdown,
    with the labels, coverage and cold-start rates of the validation file
    read against the model's vocabularies."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.io.avro import iter_avro_file
    from photon_ml_tpu_torch.io.data_reader import AvroDataReader
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.io.model_io import game_model_entity_vocabs
    from photon_ml_tpu_torch.quality import (
        BASELINE_NAME,
        compute_baseline,
        load_baseline,
    )

    t0 = time.perf_counter()
    saved = load_baseline(os.path.join(run, BASELINE_NAME))
    assert saved is not None and saved.rank_probes is None
    scores_dir = os.path.join(os.path.dirname(run), "scores")
    scores = np.array([r["predictionScore"] for r in iter_avro_file(
        os.path.join(scores_dir, "scores.avro"))], np.float32)
    with open(os.path.join(scores_dir, "score-breakdown.json")) as f:
        margins = {cid: np.asarray(m, np.float32)
                   for cid, m in json.load(f).items()}
    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    maps = {c.shard_id: IndexMap.load(os.path.join(
        run, "feature-indexes", f"{c.shard_id}.json")) for c in shards}
    vocabs = game_model_entity_vocabs(os.path.join(run, "best"))
    data, _, _ = AvroDataReader(shard_configs=shards, index_maps=maps).read(
        valid, id_columns=("songId", "userId"), entity_vocabs=vocabs)
    cold = {cid: float(np.mean(data.id_columns[t] < 0))
            for cid, t in (("perUser", "userId"), ("perSong", "songId"))}
    coverage = {sid: sh.nnz / float(data.n_samples * sh.dim)
                for sid, sh in data.shards.items()}
    again = compute_baseline(
        scores, data.labels, data.weights, task=saved.task, margins=margins,
        cold_rates=cold, coverage=coverage, lineage=saved.lineage)
    same = again.to_dict() == saved.to_dict()
    log(f"[14b] quality-baseline.json of phase 8 ({saved.n_samples} "
        f"validation rows, AUC {saved.auc:.7f}, mean score "
        f"{saved.mean_score:.6f}, HL chi-square "
        f"{saved.calibration['chiSquare']:.6g}, cold rates {cold}) equals "
        f"compute_baseline on the CPU from the saved scores: {same} "
        f"({time.perf_counter() - t0:.2f} s)")
    assert same, (again.to_dict(), saved.to_dict())
    return saved


def pair_batch(engine, users, items):
    """The RequestBatch of every (user record, item id) pair, user-major:
    the users' own features and rows, the item rows of ``items``."""
    from photon_ml_tpu_torch.serving.engine import RequestBatch

    ub = engine.pack(users)
    n_i = len(items)
    item_cid = "perSong"
    item_rows = engine.stores[item_cid].rows_for(list(items))
    rows = []
    for cid, r in zip(engine._re_order, ub.rows):
        rows.append(np.tile(item_rows, len(users)) if cid == item_cid
                    else np.repeat(r, n_i))
    return RequestBatch(
        n=len(users) * n_i, offsets=np.repeat(ub.offsets, n_i),
        xs=tuple(np.repeat(x, n_i, axis=0) for x in ub.xs),
        rows=tuple(rows))


def brute_force(sm, users):
    """Every (user, item) pair through the version's scoring engine:
    (scores (users, items) f32, the stable descending order per user)."""
    items = sm.rank_engine.index.item_ids
    scores = sm.engine.score_batch(pair_batch(sm.engine, users, items))
    scores = scores.reshape(len(users), len(items))
    return scores, np.argsort(-scores, axis=1, kind="stable")


def check_ranks(label, sm, users, ks, want_scores=None, f32=None):
    """``sm.rank`` at each k against brute force through ``sm``'s engine:
    ids and scores equal. With ``f32`` (the f32 version) each returned
    pair's score is held to its format's bound against the f32 pair
    score. Returns the seconds of the rank calls."""
    scores, order = brute_force(sm, users)
    items = sm.rank_engine.index.item_ids
    sec, worst = 0.0, 0.0
    for k in ks:
        t0 = time.perf_counter()
        got = sm.rank(users, [k] * len(users))
        sec += time.perf_counter() - t0
        for u, (ids, vals) in enumerate(got):
            top = order[u, :k]
            assert ids == [items[j] for j in top], (label, k, u)
            assert np.array_equal(vals, scores[u, top]), (label, k, u)
    if f32 is not None:
        dtype = sm.rank_engine.index.table_dtype
        f32_scores, _ = brute_force(f32, users)
        k = max(ks)
        pairs_u = np.repeat(np.arange(len(users)), k)
        pairs_i = order[:, :k].ravel()
        batch = pair_batch(f32.engine, users, items)
        flat = pairs_u * len(items) + pairs_i
        sub = type(batch)(
            n=len(flat), offsets=batch.offsets[flat],
            xs=tuple(x[flat] for x in batch.xs),
            rows=tuple(r[flat] for r in batch.rows))
        bound = quant_bounds_batch(f32, sub)[dtype]
        diff = np.abs(scores[pairs_u, pairs_i].astype(np.float64)
                      - f32_scores[pairs_u, pairs_i])
        worst = float(np.max(diff / bound))
        assert worst <= 1.0, (label, worst)
    log(f"  {label}: {len(users)} users x k in {list(ks)}: ids and scores "
        f"equal to {len(users)} x {len(items)} pairs scored by the engine "
        f"and sorted stably"
        + (f"; each top-{max(ks)} score within {worst:.3f} of its format's "
           f"bound from the f32 pair score" if f32 is not None else "")
        + f" ({sec * 1e3:.1f} ms of rank calls)")
    return sec


def rank_http(run, users, device):
    """``serve_game --rank-item-coordinate perSong``: HTTP_THREADS
    clients of RANK_HTTP_REQUESTS ``GET /rank?user=...&k=10`` each;
    every reply equal to the server's own registry's ranking. Returns
    (p50, p99) milliseconds."""
    import http.client
    import threading

    from photon_ml_tpu_torch.cli import serve_game

    t0 = time.perf_counter()
    server = serve_game.build_server([
        "--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
        "--device", device, "--rank-item-coordinate", "perSong",
        "--rank-max-k", str(RANK_MAX_K)]).start()
    up = time.perf_counter() - t0
    host, port = server.url.split("//")[1].split(":")
    ids = [u["metadataMap"]["userId"] for u in users]
    lat, replies, errors = [], {}, []
    lock = threading.Lock()

    def client(t):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            for i in range(RANK_HTTP_REQUESTS):
                uid = ids[(t * RANK_HTTP_REQUESTS + i) % len(ids)]
                t1 = time.perf_counter()
                conn.request("GET", f"/rank?user={uid}&k=10")
                resp = conn.getresponse()
                body = json.loads(resp.read())
                ms = (time.perf_counter() - t1) * 1e3
                with lock:
                    if resp.status != 200:
                        errors.append((resp.status, body))
                    lat.append(ms)
                    replies.setdefault(uid, []).append(
                        (body.get("ids"), body.get("scores")))
        finally:
            conn.close()

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(HTTP_THREADS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t1
        sm = server.service.registry.active()
        want = sm.rank([{"features": [], "metadataMap": {"userId": u},
                         "offset": None} for u in replies],
                       [10] * len(replies))
        for uid, (w_ids, w_scores) in zip(replies, want):
            for got_ids, got_scores in replies[uid]:
                assert got_ids == w_ids, uid
                assert got_scores == [float(v) for v in w_scores], uid
        health = server.service.healthz()
        compiles = sm.rank_engine.compile_count
    finally:
        server.stop()
    p50, p99 = np.percentile(lat, [50, 99])
    log(f"[14c] serve_game /rank: up in {up:.2f} s; {len(lat)} GETs from "
        f"{HTTP_THREADS} clients in {wall:.2f} s ({len(lat) / wall:.0f} "
        f"requests/s), p50 {p50:.2f} ms, p99 {p99:.2f} ms; errors "
        f"{len(errors)}; every reply equal to the registry's ranking; "
        f"rank captures {compiles}; healthz rank {health['rank']}")
    assert not errors, errors[:3]
    assert compiles == RANK_CAPTURES, compiles
    return float(p50), float(p99)


def rank_phase(run, patch, records, device):
    """(c) ranking phase 8's perSong in f32, bf16 and int8; the patch's
    activation; /rank over HTTP. Returns (f32 registry, users)."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.serving import ModelRegistry

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    # RANK_USERS distinct users of phase 10's records, as user requests
    users, seen_ids = [], set()
    for r in records:
        uid = r["metadataMap"]["userId"]
        if uid not in seen_ids:
            seen_ids.add(uid)
            users.append({"features": r["features"],
                          "metadataMap": {"userId": uid},
                          "offset": r.get("offset")})
        if len(users) == RANK_USERS:
            break
    regs = {}
    for dtype in ("float32", "bfloat16", "int8"):
        t0 = time.perf_counter()
        reg = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH, warmup=True,
                            table_dtype=dtype, device=device,
                            rank_coordinate="perSong",
                            rank_max_k=RANK_MAX_K)
        sm = reg.load(run)
        eng = sm.rank_engine
        log(f"[14c] {dtype}: loaded with ranking in "
            f"{time.perf_counter() - t0:.2f} s ({split_line(sm)}); "
            f"{eng.index.n_items} items in a bucket of {eng.index.bucket}, "
            f"index {eng.index.matrix_bytes} bytes; rank captures "
            f"{eng.compile_count}, engine captures "
            f"{sm.engine.compile_count}")
        assert eng.compile_count == RANK_CAPTURES, eng.compile_count
        regs[dtype] = reg
        check_ranks(dtype, sm, users, RANK_KS,
                    f32=None if dtype == "float32"
                    else regs["float32"].active())
        assert eng.compile_count == RANK_CAPTURES, eng.compile_count
        if dtype != "float32":
            del reg, sm, eng
            regs.pop(dtype)
            torch.cuda.empty_cache()
    f32 = regs["float32"]
    parent = f32.active()
    t0 = time.perf_counter()
    sm = f32.load_patch(patch)
    log(f"[14c] phase 11 (b)'s patch activated in "
        f"{time.perf_counter() - t0:.2f} s ({split_line(sm)}); items "
        f"{parent.rank_engine.index.n_items} -> "
        f"{sm.rank_engine.index.n_items} (bucket "
        f"{sm.rank_engine.index.bucket}); rank captures "
        f"{sm.rank_engine.compile_count}")
    assert sm.rank_engine.compile_count == RANK_CAPTURES
    check_ranks("f32 patched", sm, users, (10,))
    check_ranks("f32 parent again", parent, users, (10,))
    assert sm.rank_engine.compile_count == RANK_CAPTURES
    p50, p99 = rank_http(run, users, device)
    return f32, parent, users, (p50, p99)


def negated_candidate(run, out):
    """Phase 8's best/ with its perSong table negated, as a run directory
    (the canary's corrupt candidate)."""
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.io.model_io import (
        load_serving_model,
        save_game_model,
    )

    index_dir = os.path.join(run, "feature-indexes")
    maps = {s: IndexMap.load(os.path.join(index_dir, f"{s}.json"))
            for s in ("global", "item")}
    model, vocabs, _ = load_serving_model(os.path.join(run, "best"), maps,
                                          device="cpu")
    song = model.coordinates["perSong"]
    model = dataclasses.replace(model, coordinates=dict(
        model.coordinates, perSong=dataclasses.replace(
            song, coeffs=-song.coeffs)))
    save_game_model(os.path.join(out, "best"), model, maps, vocabs)
    shutil.copytree(index_dir, os.path.join(out, "feature-indexes"))
    return out


def canary_phase(run, patch, records, tmp, device):
    """(d) a registry under the canary gate: the negated candidate refused
    (the incumbent's version, scores and captures unchanged), then phase
    11 (b)'s patch activated with its divergence recorded."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.quality import CanaryConfig, CanaryRejected
    from photon_ml_tpu_torch.serving import ModelRegistry, ServingService

    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    reg = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH, warmup=True,
                        device=device,
                        canary=CanaryConfig(gate=True, bound=CANARY_BOUND))
    sm = reg.load(run)
    service = ServingService(reg)
    feed = records[:CANARY_RESERVOIR_RECORDS]
    for lo in range(0, len(feed), 64):
        service.score({"records": feed[lo:lo + 64]})
    before = sm.engine.score(feed)
    captures = sm.engine.compile_count
    bad = negated_candidate(run, os.path.join(tmp, "negated"))
    events = []
    unsubscribe = reg.bus.subscribe(events.append)
    t0 = time.perf_counter()
    try:
        reg.reload(bad)
        raise AssertionError("the negated candidate was activated")
    except CanaryRejected as e:
        message = str(e)
    sec = time.perf_counter() - t0
    after = sm.engine.score(feed)
    verdict = [e.payload for e in events if e.name == "canary_evaluated"]
    log(f"[14d] canary gate (bound {CANARY_BOUND:g}, reservoir "
        f"{len(reg.reservoir)} of {len(feed)} requests): the negated "
        f"candidate refused in {sec:.2f} s: {message}; active version "
        f"{reg.active_version}, {len(feed)} scores bit-identical: "
        f"{np.array_equal(before, after)}; incumbent captures {captures} -> "
        f"{sm.engine.compile_count}")
    assert reg.active_version == 1 and reg.versions() == [1]
    assert np.array_equal(before, after)
    assert sm.engine.compile_count == captures
    assert verdict and verdict[-1]["verdict"] == "rejected", verdict
    t0 = time.perf_counter()
    patched = reg.reload(patch)
    unsubscribe()
    log(f"[14d] phase 11 (b)'s patch under the gate: active version "
        f"{reg.active_version} in {time.perf_counter() - t0:.2f} s, "
        f"canary {patched.canary}")
    assert reg.active_version == patched.version == 2
    assert patched.canary is not None \
        and patched.canary["verdict"] == "pass", patched.canary
    return patched.canary["divergence"], verdict[-1]["divergence"]


def shifted_records(records, model, imap, baseline):
    """``records`` with the fixed effect's heaviest feature moved by three
    baseline score deviations' worth (added where absent)."""
    from photon_ml_tpu_torch.types import INTERCEPT_KEY, NAME_TERM_DELIMITER

    w = model.coordinates["global"].model.coefficients.means.cpu().numpy()
    weight = np.abs(w.astype(np.float64))
    weight[imap.key_to_index[INTERCEPT_KEY]] = 0.0
    j = int(np.argmax(weight))
    name = imap.names()[j].split(NAME_TERM_DELIMITER)[0]
    shift = 3.0 * baseline.std_score / float(weight[j])
    out = []
    for r in records:
        feats = [dict(f) for f in r["features"]]
        hit = [f for f in feats if f["name"] == name]
        if hit:
            hit[0]["value"] += shift
        else:
            feats.append({"name": name, "term": "", "value": shift})
        out.append({**r, "features": feats})
    return out, name, shift


def drift_phase(reg, records):
    """(e) the drift evaluator over phase 10's records served through the
    engine, then the same records with one feature shifted."""
    from photon_ml_tpu_torch.quality import (
        TOTAL_COORDINATE,
        DriftEvaluator,
        QualityMonitor,
    )

    sm = reg.active()
    sm.engine.monitor = QualityMonitor(sm.baseline)
    ev = DriftEvaluator(reg, threshold=DRIFT_THRESHOLD, poll_s=3600)
    events = []
    unsubscribe = reg.bus.subscribe(events.append)
    try:
        for lo in range(0, len(records), ENGINE_MAX_BATCH):
            sm.score(records[lo:lo + ENGINE_MAX_BATCH])
        calm = ev.evaluate_once()
        fired_calm = [e for e in events if e.name == "quality_drift_detected"]
        shifted, name, shift = shifted_records(
            records, sm.model, sm.index_maps["global"], sm.baseline)
        sm.engine.monitor = QualityMonitor(sm.baseline)
        for lo in range(0, len(shifted), ENGINE_MAX_BATCH):
            sm.score(shifted[lo:lo + ENGINE_MAX_BATCH])
        drifted = ev.evaluate_once()
        fired = [e for e in events if e.name == "quality_drift_detected"]
    finally:
        unsubscribe()
    psi0 = calm[(TOTAL_COORDINATE, "psi")]
    psi1 = drifted[(TOTAL_COORDINATE, "psi")]
    log(f"[14e] drift over {len(records)} served records: PSI {psi0:.4f}, "
        f"KS {calm[(TOTAL_COORDINATE, 'ks')]:.4f}, rank overlap drift "
        f"{calm.get(('perSong', 'rank_overlap'))}; with {name} moved by "
        f"{shift:.3f}: PSI {psi1:.4f}, KS "
        f"{drifted[(TOTAL_COORDINATE, 'ks')]:.4f} (threshold "
        f"{DRIFT_THRESHOLD:g}); events {[e.payload for e in fired]}")
    assert psi0 < DRIFT_THRESHOLD and not fired_calm, (psi0, fired_calm)
    assert psi1 > DRIFT_THRESHOLD, psi1
    assert fired and fired[0].payload["kind"] == "psi", fired
    return psi0, psi1


def run_quality_phase(e2e_run, refresh_run, records, glm_paths, lam, tmp,
                      device="cuda", small_devices=("cuda", "cpu")):
    """Phase 14 on phase 8's run, phase 9's files, phase 10's records and
    phase 11 (b)'s patch."""
    t_start = time.perf_counter()
    run = e2e_run["run"]
    patch = os.path.join(refresh_run, "patch")
    diagnostics_phase(glm_paths, lam, device, small_devices)
    baseline_phase(run, e2e_run["valid"])
    f32, parent, users, http_ms = rank_phase(run, patch, records, device)
    # phase 20 (e): phase 8's index spread over entity slots
    mesh_e = mesh_index(parent, users, device)
    # (e) on phase 8's version of the f32 registry (the patch left it
    # registered, not active): activate it again
    f32.activate(parent.version)
    drift_phase(f32, records)
    del f32, parent
    torch.cuda.empty_cache()
    canary_phase(run, patch, records, tmp, device)
    log(f"[14] done in {time.perf_counter() - t_start:.1f} s")
    return http_ms, mesh_e


# --------------------------------------------------------------------------
# phase 15: multi-process training and scoring over torch.distributed
# --------------------------------------------------------------------------

#: ranks of phase 15's jobs: two processes sharing the one card over gloo
#: (NCCL refuses two ranks on one device: "Duplicate GPU detected")
MP_RANKS = 2
MP_TIMEOUT_S = 600
#: multi-process against one process: the JAX package's tolerances for
#: the same comparison (tests/test_multihost.py:326, :476)
MP_COEF_TOL = dict(atol=2e-3, rtol=2e-2)
MP_AUC_TOL = 5e-3
#: phase 15 (e): process 1 dies at the start of sweep 1, first launch only
MP_KILL_PLAN = {"seed": 0, "specs": [{"site": "worker.stall", "at": [1],
                                      "mode": "kill", "processes": [1],
                                      "attempts": [0]}]}
#: phase 15 (b)'s runs: (name, train_glm flags). The first two are phase
#: 9's: at its tolerance 1e-6 no f32 solve at 200k x 1024 converges (phase
#: 7), two f32 trajectories drift apart along flat directions, and only
#: their objectives are held. The "_loose" pair stops at tolerance 1e-3,
#: where lambda 100 converges on both sides for either optimizer (phase 6's
#: problem, seeds 0-2 of --mp-gap-seeds), and holds the coefficients to
#: MP_COEF_TOL; it ends at lambda 10, since a chain warm-started from
#: loosely converged solves drifts further at the small lambdas
MP_GLM_LOOSE = dict(tolerance="1e-3", regularization_weights="100;10")
MP_GLM_RUNS = [
    ("TRON", dict(optimizer="TRON", max_iterations=GLM_TRON_MAX_ITER)),
    ("LBFGS", dict(optimizer="LBFGS", max_iterations=GLM_LBFGS_MAX_ITER)),
    ("TRON_loose", dict(optimizer="TRON", max_iterations=GLM_TRON_MAX_ITER,
                        **MP_GLM_LOOSE)),
    ("LBFGS_loose", dict(optimizer="LBFGS",
                         max_iterations=GLM_LBFGS_MAX_ITER, **MP_GLM_LOOSE)),
]


def mp_glm_args(paths, out, flags, device):
    """A phase 15 (b) run's train_glm arguments on phase 9's dense files,
    less ``--multihost``."""
    return flag_args(glm_cli_args(paths["dense"], paths["dense_valid"], out,
                                  ["--no-intercept"], device=device),
                     **flags)


def mp_probe(d, device):
    """The coefficient and direction phase 15 (a) evaluates at (margins of
    O(1) on phase 6's column scales)."""
    rng = np.random.default_rng(15)
    return (torch.as_tensor(rng.normal(size=d).astype(np.float32) * 0.01,
                            device=device),
            torch.as_tensor(rng.normal(size=d).astype(np.float32),
                            device=device))


def _call_ms(fn, device):
    """Milliseconds a call: CUDA events on the card, the host clock on the
    CPU."""
    if torch.device(device).type == "cuda":
        return time_ms(fn)
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    return (time.perf_counter() - t0) / 5 * 1e3


def _rank_stages(out, rank):
    """A run's stage walls as the rank logged them."""
    if rank:
        out = os.path.join(out, "workers", f"proc-{rank}")
    return [(m["stage"], m["seconds"]) for m in stages_of(out)
            if "seconds" in m]


def _rank_objective(rank, arrays):
    """(a) in a rank: its contiguous share of phase 6's rows as its block,
    the distributed value, gradient and Hvp at :func:`mp_probe`, and the
    layer's times: an evaluation with its all_reduce, the rank's kernel
    call alone, and a host gather of 10^6 int64."""
    from photon_ml_tpu_torch.ops import losses as tl
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.parallel.distributed import (
        DistributedGLMObjective,
    )

    n_proc = multihost.process_count()
    x = np.load(arrays["x"], mmap_mode="r")
    y = np.load(arrays["y"], mmap_mode="r")
    cuts = np.linspace(0, len(y), n_proc + 1).astype(np.int64)
    lo, hi = int(cuts[rank]), int(cuts[rank + 1])
    block = multihost.global_glm_data_multihost(GLMData(
        design=DenseDesign(x=torch.from_numpy(np.array(x[lo:hi]))),
        labels=torch.from_numpy(np.array(y[lo:hi])),
        offsets=torch.zeros(hi - lo), weights=torch.ones(hi - lo)))
    local = GLMObjective(tl.LogisticLoss)
    dist = DistributedGLMObjective(local)
    device = block.labels.device
    w, v = mp_probe(x.shape[1], device)

    def evaluate():
        value, grad = dist.value_and_grad(w, block, 0.0)
        return value, grad, dist.hvp(w, v, block, 0.0)

    (value, grad, hv), wall, launches = counted_call(evaluate)
    gather = np.arange(1_000_000, dtype=np.int64)
    t0 = time.perf_counter()
    for _ in range(5):
        multihost.allgather_concat(gather)
    gather_ms = (time.perf_counter() - t0) / 5 * 1e3
    # the reduction alone, on the device and staged through the host's
    # gloo group, at an evaluation's size (value and gradient packed)
    packed = torch.zeros(x.shape[1] + 1, device=device)
    host = multihost._state.get("host_group")

    def host_reduce():
        t = packed.cpu()
        if host is not None:
            torch.distributed.all_reduce(t, group=host)
        return t.to(device)

    return dict(
        value=value.cpu(), grad=grad.cpu(), hvp=hv.cpu(), wall=wall,
        launches=launches, rows=(lo, hi), device=str(w.device),
        backend=multihost.backend(), world=n_proc,
        eval_ms=_call_ms(lambda: dist.value_and_grad(w, block, 0.0), device),
        kernel_ms=_call_ms(lambda: local.value_and_grad(w, block, 0.0),
                           device),
        reduce_ms=_call_ms(lambda: multihost.device_all_reduce(packed),
                           device),
        host_reduce_ms=_call_ms(host_reduce, device), gather_ms=gather_ms)


def _rank_glm(rank, paths, root, device, runs=None):
    """(b) in a rank: ``train_glm --multihost`` on phase 9's dense part
    files, each run of ``runs`` (default :data:`MP_GLM_RUNS`); each sweep's
    coefficients as the rank holds them."""
    from photon_ml_tpu_torch.cli import train_glm

    out = {}
    for name, flags in runs or MP_GLM_RUNS:
        seen = []
        sweep = train_glm.train_glm_sweep

        def capture(*a, **k):
            seen.extend(sweep(*a, **k))
            return seen

        train_glm.train_glm_sweep = capture
        run = os.path.join(root, f"glm_{name}")
        try:
            result, wall, launches = counted_call(train_glm.run, mp_glm_args(
                paths, run, flags, device) + ["--multihost"])
        finally:
            train_glm.train_glm_sweep = sweep
        out[name] = dict(result=result, wall=wall, launches=launches,
                         stages=_rank_stages(run, rank), run=run,
                         w={tm.regularization_weight:
                            tm.model.coefficients.means.cpu().numpy()
                            for tm in seen})
    return out


def _rank_game(rank, e2e_run, root, device):
    """(c) in a rank: ``train_game --multihost`` on phase 8's part files;
    the model arrays as the rank holds them."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.game import multiprocess

    seen = []
    fit = multiprocess.train_game_multiprocess

    def capture(*a, **k):
        seen.append(fit(*a, **k))
        return seen[-1]

    multiprocess.train_game_multiprocess = capture
    run = os.path.join(root, "game")
    try:
        result, wall, launches = counted_call(train_game.run, cli_args(
            e2e_run["train"], e2e_run["valid"], run) + [
                "--multihost", "--device", device])
    finally:
        multiprocess.train_game_multiprocess = fit
    model = seen[0].model.coordinates
    arrays = {"global": model["global"].model.coefficients.means.cpu()
              .numpy()}
    for cid in ("perUser", "perSong"):
        arrays[cid] = (model[cid].keys, model[cid].coeffs)
    return dict(result=result, wall=wall, launches=launches, run=run,
                stages=_rank_stages(run, rank), arrays=arrays,
                rows=len(seen[0].global_rows))


def _rank_score(rank, e2e_run, root, device):
    """(d) in a rank: ``score_game --multihost`` over phase 8's validation
    parts with phase 8's model."""
    from photon_ml_tpu_torch.cli import score_game

    out = os.path.join(root, "scores")
    result, wall, launches = counted_call(score_game.run, [
        "--data", e2e_run["valid_parts"], "--model-dir", e2e_run["run"],
        "--output-dir", out, "--feature-shards", E2E_SHARDS,
        "--evaluators", "AUC", "--multihost", "--device", device])
    return dict(result=result, wall=wall, launches=launches, run=out,
                stages=_rank_stages(out, rank))


def mp_rank(rank, jobs):
    """A phase-15 rank: each ``(name, function name, args)`` of ``jobs`` in
    turn; ``{name: result}``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return {name: globals()[fn](rank, *args) for name, fn, args in jobs}


def _log_ranks(label, outs, key):
    for r, o in enumerate(outs):
        o = o[key] if key else o
        stages = ", ".join(f"{s} {sec:.3f}" for s, sec in o.get("stages", ()))
        log(f"  {label} rank {r}: {o['wall']:.2f} s; launches "
            f"{o['launches']}" + (f"; {stages}" if stages else ""))


def _hold_objective(label, outs, ref):
    """(a)'s readings of every rank against the one-process kernels: the
    ranks bit-identical, each within the f32 summation bound."""
    ref_v, ref_g, ref_hv = ref
    worst = 0.0
    for r, o in enumerate(outs):
        _, rel = _max_err((o["value"], o["grad"]), (ref_v, ref_g))
        rel_h = float((o["hvp"] - ref_hv).abs().max()
                      / ref_hv.abs().max().clamp_min(1.0))
        worst = max(worst, rel, rel_h)
        log(f"  {label} rank {r} ({o['backend']}, world {o['world']}, "
            f"{o['device']}, rows {o['rows']}): {o['wall']:.3f} s; launches "
            f"{o['launches']}; value/gradient rel {rel:.2e}, Hvp rel "
            f"{rel_h:.2e} (limit {KERNEL_RTOL:g}); an evaluation "
            f"{o['eval_ms']:.3f} ms with its all_reduce, the rank's kernel "
            f"{o['kernel_ms']:.3f} ms, the all_reduce alone "
            f"{o['reduce_ms']:.3f} ms (staged through the host's gloo group "
            f"{o['host_reduce_ms']:.3f} ms); host gather of 10^6 int64 "
            f"{o['gather_ms']:.2f} ms")
        assert o["launches"]["fused_glm"] == 1, o["launches"]
        assert o["launches"]["fused_hvp"] == 1, o["launches"]
    for o in outs[1:]:
        assert all(torch.equal(o[k], outs[0][k])
                   for k in ("value", "grad", "hvp")), label
    assert worst <= KERNEL_RTOL, (label, worst)
    return worst


def _max_gap(got, want):
    """max |got - want| and the tolerance's use of it (|d| / (atol + rtol
    |want|), at most 1 to pass)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    use = d / (MP_COEF_TOL["atol"] + MP_COEF_TOL["rtol"] * np.abs(want))
    return float(d.max()) if d.size else 0.0, (float(use.max()) if d.size
                                               else 0.0)


def _records_by_key(model_dir, cid, kind):
    return {(mid, m["name"], m["term"]): m["value"]
            for mid, means in coefficient_records(model_dir, cid,
                                                  kind).items()
            for m in means}


def mp_glm_compare(label, ranks, paths, root, singles, device):
    """(b)'s comparison: each run of :data:`MP_GLM_RUNS` in ``ranks`` (the
    ranks' :func:`_rank_glm` results) against train_glm in one process on
    the same files with the same flags (``singles[name]`` where that run
    exists, else run here). The ranks' results and models must be
    bit-identical and every lambda's reported |grad| within its f32 scale
    of the exact f64 one. Returns {name: {lam: (both converged, largest
    coefficient gap, its use of MP_COEF_TOL, f64 objectives' relative
    gap)}}."""
    from photon_ml_tpu_torch.cli import train_glm

    contractions, rows = None, {}
    for name, flags in MP_GLM_RUNS:
        _log_ranks(f"{label} train_glm {name}", ranks, name)
        a = ranks[0][name]
        for b in ranks[1:]:
            assert a["result"] == b[name]["result"], (name, a["result"])
            assert a["w"].keys() == b[name]["w"].keys(), name
            for lam in a["w"]:
                assert np.array_equal(a["w"][lam], b[name]["w"][lam]), (
                    name, lam)
        single = singles.get(name)
        if single is None:
            single = os.path.join(root, f"glm_{name}_one")
            sec = time.perf_counter()
            train_glm.run(mp_glm_args(paths, single, flags, device))
            log(f"  {label} {name} in one process: "
                f"{time.perf_counter() - sec:.2f} s")
        _, lams_mp, imap_mp = read_run(a["run"])
        _, lams_one, imap_one = read_run(single)
        assert imap_mp.names() == imap_one.names()
        assert lams_mp.keys() == lams_one.keys() == a["w"].keys(), name
        for lam in lams_mp:
            assert np.array_equal(lams_mp[lam]["w"],
                                  a["w"][lam].astype(np.float64)), lam
        if contractions is None:
            contractions = Contractions(read_glm_data(paths["dense"],
                                                      imap_mp, device))
        f_mp = check_cli_gradients(f"{label} {name} multi-process",
                                   contractions, lams_mp, 0.0,
                                   cli_mask(imap_mp))
        rows[name] = {}
        for lam in sorted(lams_mp, reverse=True):
            f_one = elastic_net_objective(contractions, lams_one[lam]["w"],
                                          lam, 0.0, cli_mask(imap_one))[0]
            gap, use = _max_gap(lams_mp[lam]["w"], lams_one[lam]["w"])
            both = bool(lams_mp[lam]["converged"]
                        and lams_one[lam]["converged"])
            rel_f = abs(f_mp[lam] - f_one) / abs(f_one)
            log(f"  {label} {name} lambda={lam:g}: iterations "
                f"{lams_mp[lam]['iterations']}/{lams_one[lam]['iterations']}"
                f", converged {lams_mp[lam]['converged']}/"
                f"{lams_one[lam]['converged']}; largest |multi - one "
                f"process| coefficient gap {gap:.2e} ({100 * use:.1f} % of "
                f"atol {MP_COEF_TOL['atol']:g} + rtol {MP_COEF_TOL['rtol']:g}"
                + (")" if both else ", not held: unconverged)")
                + f"; f64 f(w) relative gap {rel_f:.2e} (limit "
                f"{OBJECTIVE_RTOL[both]:g})")
            rows[name][lam] = (both, gap, use, rel_f)
    return rows


def run_multiprocess_phase(e2e_run, glm_paths, phase9_dir, phase6, tmp,
                           device="cuda"):
    """Phase 15: (a) the distributed objective over 2 gloo ranks on the
    card against one process's kernels 1 and 3, and over NCCL at world
    size 1 (one rank a card where there are several); (b)-(d) train_glm,
    train_game and score_game --multihost in one 2-rank job at full width;
    (e) train_game --supervise 2 with a rank killed, on phase 8's files.
    Returns the per-rank launches."""
    from photon_ml_tpu_torch.cli import train_game, train_glm
    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.io.avro import iter_avro_file
    from photon_ml_tpu_torch.ops import losses as tl
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
    from photon_ml_tpu_torch.testing import run_ranks

    t_start = time.perf_counter()
    root = os.path.join(tmp, "mp")
    os.makedirs(root)
    launches = {}

    # (a) one process's kernels on the whole design, then the ranks
    (x, y), _ = make_glm(**GLM)
    arrays = {"x": os.path.join(root, "x.npy"),
              "y": os.path.join(root, "y.npy")}
    np.save(arrays["x"], x)
    np.save(arrays["y"], y)
    full = GLMData(design=DenseDesign(x=torch.as_tensor(x, device=device)),
                   labels=torch.as_tensor(y, device=device),
                   offsets=torch.zeros(len(y), device=device),
                   weights=torch.ones(len(y), device=device))
    del x
    obj = GLMObjective(tl.LogisticLoss)
    w, v = mp_probe(GLM["dim"], device)
    ref_v, ref_g = obj.value_and_grad(w, full, 0.0)
    ref = (ref_v.cpu(), ref_g.cpu(), obj.hvp(w, v, full, 0.0).cpu())
    del full
    if device == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    outs = run_ranks(mp_rank, MP_RANKS, [
        ("objective", "_rank_objective", (arrays,)),
        ("glm", "_rank_glm", (glm_paths, root, device)),
        ("game", "_rank_game", (e2e_run, root, device)),
        ("score", "_rank_score", (e2e_run, root, device))],
        backend="gloo", device=device, timeout_s=MP_TIMEOUT_S, threads=4)
    log(f"[15] {MP_RANKS} gloo ranks on the card, one job for (a)-(d): "
        f"{time.perf_counter() - t0:.1f} s")
    worst = _hold_objective("(a) gloo", [o["objective"] for o in outs], ref)
    launches["objective"] = [o["objective"]["launches"] for o in outs]
    n_dev = torch.cuda.device_count() if device == "cuda" else 0
    if n_dev:
        t0 = time.perf_counter()
        nccl = run_ranks(mp_rank, 1, [("objective", "_rank_objective",
                                       (arrays,))],
                         backend="nccl", device="cuda", timeout_s=300,
                         threads=4)[0]["objective"]
        same = all(torch.equal(a, nccl[k]) for a, k in
                   zip(ref, ("value", "grad", "hvp")))
        log(f"[15a] NCCL, world size 1: {time.perf_counter() - t0:.1f} s; "
            f"bit-identical to one process: {same}")
        assert same, "NCCL at world size 1 differs from one process"
        worst = max(worst, _hold_objective("(a) nccl", [nccl], ref))
    if n_dev >= 2:
        per_card = run_ranks(mp_rank, n_dev, [
            ("objective", "_rank_objective", (arrays,))], backend="nccl",
            device="cuda", timeout_s=300, threads=4)
        worst = max(worst, _hold_objective(
            f"(a) nccl {n_dev} cards", [o["objective"] for o in per_card],
            ref))
    else:
        log(f"[15a] NCCL one rank a card: not run ({n_dev} card)")
    os.unlink(arrays["x"])

    # (b) train_glm --multihost against phase 9 (TRON) and one process
    # (the other runs, sequential, the same arguments): ranks bit-identical,
    # every lambda's reported |grad| against the exact f64 one (the check a
    # wrong reduction fails), the f64 objectives within OBJECTIVE_RTOL as
    # phase 7 holds the card to the CPU, and the coefficients within the
    # JAX package's tolerance where both solves converged (in each "_loose"
    # run at least one lambda)
    rows = mp_glm_compare("(b)", [o["glm"] for o in outs], glm_paths, root,
                          {"TRON": os.path.join(phase9_dir, "tron")}, device)
    for name, flags in MP_GLM_RUNS:
        a = outs[0]["glm"][name]
        for lam, (both, gap, use, rel_f) in rows[name].items():
            assert rel_f <= OBJECTIVE_RTOL[both], (name, lam, rel_f)
            assert use <= 1.0 or not both, (name, lam, gap)
        assert a["launches"]["fused_glm"] > 0, a["launches"]
        if flags["optimizer"] == "TRON":
            assert a["launches"]["fused_hvp"] > 0, a["launches"]
        if "tolerance" in flags:
            held = [lam for lam, r in rows[name].items() if r[0]]
            log(f"  (b) {name}: coefficients held at lambda {held}")
            assert held, f"{name}: no lambda converged on both sides"
        else:
            best = a["result"]["best_lambda"]
            log(f"  (b) {name}: best lambda {best:g} (phase 9 "
                f"{phase6['tron'][0]:g}); AUC "
                f"{a['result']['best_evaluation']['AUC']:.7f}")
            assert best == phase6["tron"][0], (name, best, phase6)
        launches[f"glm_{name}"] = [o["glm"][name]["launches"] for o in outs]
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) train_game --multihost against phase 8
    _log_ranks("(c) train_game", outs, "game")
    a, b = (o["game"] for o in outs)
    assert a["result"] == b["result"]
    assert np.array_equal(a["arrays"]["global"], b["arrays"]["global"])
    for cid in ("perUser", "perSong"):
        for x_a, x_b in zip(a["arrays"][cid], b["arrays"][cid]):
            assert np.array_equal(x_a, x_b), cid
    assert a["launches"]["fused_glm"] > 0 and a["launches"]["fused_re"] > 0
    assert b["launches"]["fused_re"] > 0, b["launches"]
    auc = a["result"]["best_evaluation"]["AUC"]
    one = os.path.join(e2e_run["run"], "best")
    mine = os.path.join(a["run"], "best")
    for cid, kind in (("global", "fixed-effect"), ("perUser", "random-effect"),
                      ("perSong", "random-effect")):
        got = _records_by_key(mine, cid, kind)
        want = _records_by_key(one, cid, kind)
        assert got.keys() == want.keys(), (cid, len(got), len(want))
        keys = sorted(want)
        gap = _max_gap([got[k] for k in keys], [want[k] for k in keys])
        log(f"  (c) {cid}: {len(keys)} coefficients, keys equal phase 8's; "
            f"largest gap {gap[0]:.2e} ({100 * gap[1]:.1f} % of the "
            f"tolerance)")
        assert gap[1] <= 1.0, (cid, gap)
    log(f"  (c) AUC {auc:.7f}, phase 8 {e2e_run['train_auc']:.7f} (|diff| "
        f"{abs(auc - e2e_run['train_auc']):.2e}, limit {MP_AUC_TOL:g}); "
        f"rows owned {[o['game']['rows'] for o in outs]}; ranks "
        f"bit-identical")
    assert abs(auc - e2e_run["train_auc"]) <= MP_AUC_TOL
    launches["game"] = [o["game"]["launches"] for o in outs]

    # (d) score_game --multihost against phase 10 (a)
    _log_ranks("(d) score_game", outs, "score")
    parts = sorted(glob.glob(os.path.join(outs[0]["score"]["run"],
                                          "scores-part-*.avro")))
    got = [r["predictionScore"] for p in parts for r in iter_avro_file(p)]
    want = [r["predictionScore"] for r in iter_avro_file(os.path.join(
        os.path.dirname(e2e_run["run"]), "scores", "scores.avro"))]
    same = sum(g == w_ for g, w_ in zip(got, want))
    log(f"  (d) {len(parts)} parts, {len(got)} scores: {same} equal phase "
        f"10 (a)'s scores.avro row for row; AUC "
        f"{outs[0]['score']['result']['evaluation']['AUC']:.7f}")
    assert len(got) == len(want) == same, (len(got), len(want), same)
    launches["score"] = [o["score"]["launches"] for o in outs]

    # (e) train_game --supervise 2 on SMALL's rows (phase 4's draw) in
    # phase 8's file layout, two sweeps, rank 1 killed at the start of
    # sweep 1; the restart re-reads the rows and resumes from the sweep-0
    # checkpoints
    import photon_ml_tpu_torch.game as tg

    small_paths, _ = write_e2e_files(os.path.join(root, "small"),
                                     *make_e2e(tg, **SMALL))
    events = []
    unsub = GLOBAL_BUS.subscribe(
        lambda e: events.append((time.perf_counter(), e.name, e.payload))
        if e.name.startswith("supervisor_") else None)
    os.environ["PHOTON_DIST_BACKEND"] = "gloo"
    walls = {}
    try:
        for name in ("clean", "kill"):
            if name == "kill":
                os.environ["PHOTON_FAULT_PLAN"] = json.dumps(MP_KILL_PLAN)
            out = os.path.join(root, f"supervised_{name}")
            t0 = time.perf_counter()
            res = train_game.run(flag_args(
                cli_args(small_paths["train"], small_paths["valid"], out),
                cd_iterations="2", supervise=str(MP_RANKS),
                max_restarts="2", device=device))
            walls[name] = (time.perf_counter() - t0, res, out)
            os.environ.pop("PHOTON_FAULT_PLAN", None)
    finally:
        unsub()
        os.environ.pop("PHOTON_FAULT_PLAN", None)
        os.environ.pop("PHOTON_DIST_BACKEND", None)
    for name, (wall, res, out) in walls.items():
        per_rank = "; ".join(
            f"rank {r}: " + ", ".join(f"{s} {sec:.3f}"
                                      for s, sec in _rank_stages(out, r))
            for r in range(MP_RANKS))
        log(f"  (e) supervised {name}: {wall:.2f} s, restarts "
            f"{res['restarts']}, AUC {res['best_evaluation']['AUC']:.7f}; "
            f"{per_rank} (launches: not counted, the ranks are the "
            f"supervisor's subprocesses)")
    fault = [t for t, n, _ in events if n == "supervisor_fault_detected"]
    done = [t for t, n, _ in events if n == "supervisor_completed"]
    restart_s = done[-1] - fault[0] if fault else float("nan")
    kill_best, clean_best = (os.path.join(walls[k][2], "best")
                             for k in ("kill", "clean"))
    all_same = same_records(kill_best, clean_best)
    log(f"  (e) fault detected to fleet done {restart_s:.2f} s; the killed "
        f"run's wall - the clean run's {walls['kill'][0] - walls['clean'][0]:.2f}"
        f" s; best model records equal the uninterrupted run's: {all_same}")
    assert walls["clean"][1]["restarts"] == 0
    assert walls["kill"][1]["restarts"] >= 1
    assert all_same
    log(f"[15] done in {time.perf_counter() - t_start:.1f} s (worst "
        f"objective error {worst:.2e})")
    return launches


def mp_gap_seeds(seeds, device="cuda"):
    """``python3 chip_smoke.py --mp-gap-seeds 0,1,2``: phase 15 (b) alone,
    on phase 6's problem drawn from each seed (seed 0 is phase 9's data):
    every run of :data:`MP_GLM_RUNS` in 2 gloo ranks against one process,
    by lambda, as :func:`mp_glm_compare` reads it. Reads the headroom of
    (b)'s limits over data; prints the gaps as one JSON line."""
    from photon_ml_tpu_torch.ops import cuda_build
    from photon_ml_tpu_torch.testing import run_ranks

    cuda_build.build(["fused_glm", "fused_hvp"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_gaps_")
    gaps = {}
    try:
        for seed in seeds:
            root = os.path.join(tmp, f"seed{seed}")
            (x, y), (xv, yv) = make_glm(**GLM, seed=seed)
            paths, _, _ = write_glm_files(root, {
                "dense": dense_csr(x, y), "dense_valid": dense_csr(xv, yv)})
            del x, xv
            outs = run_ranks(mp_rank, MP_RANKS, [
                ("glm", "_rank_glm", (paths, root, device))],
                backend="gloo", device=device, timeout_s=MP_TIMEOUT_S,
                threads=4)
            rows = mp_glm_compare(f"[seed {seed}]", [o["glm"] for o in outs],
                                  paths, root, {}, device)
            gaps[seed] = {name: {f"{lam:g}": r for lam, r in by.items()}
                          for name, by in rows.items()}
            shutil.rmtree(root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"mp_gaps (both converged, gap, use, f gap)": gaps}))
    return 0


# --------------------------------------------------------------------------
# phase 16: the entity-sharded serving fleet — serve_fleet, per-host
# patches, the live reshard, replica groups
# --------------------------------------------------------------------------

#: hosts of phase 16's fleets; each packs ~1/FLEET_SHARDS of every table
FLEET_SHARDS = 4
#: records a /score request through the router carries
FLEET_BATCH = 500
#: records scored through one host at every bucket size (1 .. max batch)
FLEET_BUCKET_RECORDS = 2_048
#: records of the quantized fleets' checks and of the reshard's
FLEET_CHECK_RECORDS = 4_000
#: (c) /rank requests compared with the unsharded ranking, at this k
FLEET_RANK_RECORDS = 64
FLEET_RANK_K = 10
#: (e) buckets moved from shard 0 to shard 1, before a rebalance
FLEET_MOVED_BUCKETS = 64
#: (g) load: clients, single-record requests a second each, seconds
FLEET_CLIENTS = 8
FLEET_RATE = 25
FLEET_LOAD_S = 2.0


def fleet_request(url, method, path, payload=None, headers=None):
    """(status, JSON body, headers) of one request, refusals included."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url + path, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def fleet_scores(url, records, batch=FLEET_BATCH):
    """f32 scores of ``records`` through ``url``'s ``/score`` in requests
    of ``batch`` records, and how many records the router merged."""
    out, merged = [], 0
    for lo in range(0, len(records), batch):
        status, body, _ = fleet_request(url, "POST", "/score",
                                        {"records": records[lo:lo + batch]})
        assert status == 200, (status, body)
        out += body["scores"]
        merged += body.get("fanout", {}).get("merged", 0)
    return np.asarray(out, np.float32), merged


def engine_scores(sm, records, chunk=ENGINE_MAX_BATCH):
    """One version's f32 scores of ``records`` in calls of ``chunk``."""
    return np.concatenate([sm.engine.score(records[lo:lo + chunk])
                           for lo in range(0, len(records), chunk)])


def start_fleet(run, device, *flags):
    """``serve_fleet.build_fleet`` on ``run``: (fleet, seconds to up)."""
    from photon_ml_tpu_torch.cli import serve_fleet

    t0 = time.perf_counter()
    fleet = serve_fleet.build_fleet(
        ["--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
         "--device", device, *flags])
    return fleet, time.perf_counter() - t0


def host_ids(fleet, cid):
    """Each host's raw ids of coordinate ``cid``."""
    return [set(h.service.registry.active().stores[cid].row_of_id)
            for h in fleet.hosts]


def fleet_shard_views(fleet, single):
    """(a): disjoint host views whose union is the unsharded table, bit
    for bit; returns each host's table bytes over the unsharded ones."""
    hosts = [h.service.registry.active() for h in fleet.hosts]
    for cid in ("perUser", "perSong"):
        ids = host_ids(fleet, cid)
        union = set().union(*ids)
        assert sum(map(len, ids)) == len(union), cid  # disjoint
        assert union == set(single.stores[cid].row_of_id), cid
        for sm, mine in zip(hosts, ids):
            raws = sorted(mine)
            for a, b in zip(table_rows(sm.stores[cid], raws),
                            table_rows(single.stores[cid], raws)):
                assert (a is None and b is None) or np.array_equal(a, b)
        assert (sum(sm.stores[cid].table.shape[0] for sm in hosts)
                == single.stores[cid].table.shape[0] + len(hosts) - 1), cid
    full = sum(s.table_bytes for s in single.stores.values())
    return [sum(s.table_bytes for s in sm.stores.values()) / full
            for sm in hosts], full


def bucket_sweep(sm, records):
    """Scores of ``records`` through ``sm``'s engine in calls of every
    bucket size: each must equal the largest bucket's, bit for bit.
    Returns the sizes held."""
    ref = engine_scores(sm, records)
    sizes = []
    b = 1
    while b <= sm.engine.max_batch:
        got = engine_scores(sm, records, chunk=b)
        bad = int(np.count_nonzero(got != ref))
        assert bad == 0, (b, bad)
        sizes.append(b)
        b <<= 1
    return sizes


def fleet_latency(url, records):
    """(g): FLEET_CLIENTS clients, each sending single-record /score
    requests on a fixed schedule of FLEET_RATE a second for FLEET_LOAD_S
    seconds; latency from each request's scheduled time (so a stall
    delays the requests behind it). Returns (p50, p99, requests)."""
    import http.client
    import threading

    host, port = url.split("//")[1].split(":")
    lat, errors = [], []
    lock = threading.Lock()
    n = int(FLEET_RATE * FLEET_LOAD_S)
    start = time.perf_counter() + 0.2

    def client(t):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            for k in range(n):
                due = start + k / FLEET_RATE + t / (FLEET_RATE *
                                                    FLEET_CLIENTS)
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                rec = records[(t * n + k) % len(records)]
                conn.request("POST", "/score", json.dumps({"record": rec}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                ms = (time.perf_counter() - due) * 1e3
                with lock:
                    lat.append(ms)
                    if resp.status != 200:
                        errors.append((resp.status, body[:200]))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(FLEET_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors[:3]
    p50, p99 = np.percentile(lat, [50, 99])
    return float(p50), float(p99), len(lat)


def spawn_servers(commands, envs=None):
    """Start one ``python -m photon_ml_tpu_torch`` server process for each
    argument list in ``commands`` (each binding port 0; ``envs``, where
    given, adds variables to each one's environment). Returns the
    processes and a function that waits for their URLs, read from the line
    each prints once it serves, and the seconds each took to get there.
    The caller stops the processes."""
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    # one CPU thread each: they serve from the card, and load beside work
    # of this process
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch", *argv], cwd=root,
        env={**env, **(envs[i] if envs else {})}, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
        for i, argv in enumerate(commands)]
    urls, ready = [None] * len(procs), [None] * len(procs)

    def read_url(i):
        for line in procs[i].stdout:
            if line.startswith("serving GAME"):
                urls[i] = line.split(" on ", 1)[1].split()[0]
                ready[i] = time.perf_counter() - t0
                return

    readers = [threading.Thread(target=read_url, args=(i,), daemon=True)
               for i in range(len(procs))]
    for th in readers:
        th.start()

    def wait_urls(timeout_s=600):
        for th in readers:
            th.join(timeout=timeout_s)
        if None in urls:
            raise RuntimeError(f"a server did not start: {urls}")
        return list(urls), list(ready)

    return procs, wait_urls


def wait_lineage(url, lineage, timeout_s=300):
    """Poll a router's /healthz until every host serves ``lineage``."""
    limit = time.perf_counter() + timeout_s
    while True:
        _, body, _ = fleet_request(url, "GET", "/healthz")
        if {h.get("lineage") for h in body["hosts"]} == {lineage}:
            return
        if time.perf_counter() > limit:
            raise TimeoutError(f"{url}: hosts at {body['hosts']}")
        time.sleep(0.5)


def rank_model_args(train, valid, out):
    """Phase 8's arguments without the user-side perUser: the item
    coordinate is the only random effect, as fleet /rank requires."""
    args = [a for a in cli_args(train, valid, out)
            if not a.startswith("perUser=")]
    args[args.index("global,perUser,perSong")] = "global,perSong"
    return args


def replica_phase(rank_run, records, device):
    """(f) 2 shards x 2 replicas of the ranking model: a stopped replica
    is a retry; a ``fleet.replica`` fault that exhausts the group a typed
    503 ``reason=upstream`` with ``Retry-After``; a spent deadline a 429
    ``reason=deadline``."""
    from photon_ml_tpu_torch.fleet.sharding import (
        retry_jitter_s,
        shard_of_id,
        stable_hash_u32,
    )
    from photon_ml_tpu_torch.resilience import FaultPlan, injected
    from photon_ml_tpu_torch.telemetry.prometheus import parse_text, render

    def retries():
        return sum(v for labels, v in parse_text(render()).get(
            "photon_fleet_replica_retries_total", ()))

    fleet, up = start_fleet(rank_run, device, "--fleet-shards", "2",
                            "--replicas", "2", "--no-warmup")
    try:
        recs = records[:FLEET_BATCH]
        before, _ = fleet_scores(fleet.url, recs)
        r0 = retries()
        fleet.hosts[1].stop()  # shard 0, replica 1
        for i in range(8):
            status, body, _ = fleet_request(
                fleet.url, "POST", "/score", {"records": recs},
                headers={"X-Photon-Request-Id": f"stop-{i}"})
            assert status == 200, (status, body)
            assert np.array_equal(np.asarray(body["scores"], np.float32),
                                  before)
        n_retries = retries() - r0
        assert n_retries > 0
        ready = fleet_request(fleet.url, "GET", "/readyz")
        assert ready[0] == 200 and ready[1]["ready"], ready
        rid = next(r for r in (f"r{i}" for i in range(100))
                   if stable_hash_u32(f"replica:{r}") % 2 == 1)
        rec = next(r for r in records
                   if shard_of_id(r["metadataMap"]["songId"], 2) == 0)
        plan = FaultPlan.from_json({"seed": 0, "specs": [
            {"site": "fleet.replica", "at": [0]}]})
        with injected(plan):
            status, body, headers = fleet_request(
                fleet.url, "POST", "/score", {"record": rec},
                headers={"X-Photon-Request-Id": rid})
        assert (status, body.get("reason")) == (503, "upstream"), body
        retry_after = headers.get("Retry-After")
        assert retry_after == str(max(1, round(retry_jitter_s(rid)))), \
            headers
        status, body, headers = fleet_request(
            fleet.url, "POST", "/score", {"record": rec},
            headers={"X-Photon-Deadline-Ms": "0"})
        assert (status, body.get("reason")) == (429, "deadline"), body
        assert headers.get("Retry-After"), headers
    finally:
        fleet.stop()
    log(f"[16f] 2 shards x 2 replicas up in {up:.2f} s: shard 0's replica "
        f"1 stopped, 8 requests of {len(recs)} records all answered "
        f"bit-identically through {int(n_retries)} replica retries, "
        f"/readyz ready; a fleet.replica fault exhausting the group: 503 "
        f"reason=upstream, Retry-After {retry_after} s; a spent "
        f"deadline: 429 reason=deadline")


def reshard_phase(fleet, records):
    """(e) on ``fleet`` (the ranking model's): moves of
    FLEET_MOVED_BUCKETS buckets from shard 0 to 1, after a refusal
    injected at one host's prepare, then ``ShardMap.rebalanced``: only the
    moved buckets' rows move, scores bit for bit. Returns the two epochs'
    walls."""
    from photon_ml_tpu_torch.fleet.sharding import N_BUCKETS, bucket_of_id
    from photon_ml_tpu_torch.resilience import FaultPlan, injected

    router = fleet.router
    recs = records[:FLEET_CHECK_RECORDS]
    before, _ = fleet_scores(fleet.url, recs)
    incumbent = router.shard_map
    donors = [b for b in range(N_BUCKETS)
              if incumbent.buckets[b] == 0][:FLEET_MOVED_BUCKETS]
    moves = {str(b): 1 for b in donors}
    plan = FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "serving.reload", "at": [1]}]})
    with injected(plan):
        status, body, _ = fleet_request(fleet.url, "POST", "/reshard",
                                        {"moves": moves})
    assert status == 409 and "incumbent map" in body["error"], body
    assert router.shard_map is incumbent
    assert {h.service.registry.shard_map_hash for h in fleet.hosts} == \
        {incumbent.map_hash}
    after, _ = fleet_scores(fleet.url, recs)
    assert np.array_equal(after, before)
    walls = []
    for payload in ({"moves": moves}, None):
        old = router.shard_map
        if payload is None:
            payload = {"shard_map": old.rebalanced(FLEET_SHARDS).as_dict()}
        held = {cid: host_ids(fleet, cid)
                for cid in fleet.hosts[0].service.registry.active().stores}
        t0 = time.perf_counter()
        status, out, _ = fleet_request(fleet.url, "POST", "/reshard",
                                       payload)
        walls.append(time.perf_counter() - t0)
        assert status == 200, out
        new = router.shard_map
        moved = set(old.moved_buckets(new))
        assert out["moved_buckets"] == len(moved) == FLEET_MOVED_BUCKETS
        rows = 0
        for cid, was in held.items():
            now = host_ids(fleet, cid)
            everyone = set().union(*was)
            for i, (a, b) in enumerate(zip(was, now)):
                want = {r for r in everyone if bucket_of_id(r) in moved
                        and (old.shard_of(r) == i) != (new.shard_of(r) == i)}
                assert a ^ b == want, (cid, i)
            rows += sum(1 for r in everyone if bucket_of_id(r) in moved)
        got, _ = fleet_scores(fleet.url, recs)
        assert np.array_equal(got, before)
        log(f"[16e] /reshard {old.map_hash} -> {new.map_hash}: "
            f"{len(moved)} buckets, {rows} rows moved (hosts' moved "
            f"{out['moved']}), epoch {walls[-1]:.2f} s; "
            f"{len(recs)} scores bit-identical after")
    return walls


def run_fleet_phase(e2e_run, records, tmp, card, device="cuda"):
    """Phase 16 on phase 8's run, phase 10's records and phase 11's day-2
    data; returns the kernels' launches of ``refresh_game --fleet-shards``
    (d) and (g)'s latencies {setup: (p50, p99, requests)}. The processes of (g) (``serve_game --fleet-shard``) and of the
    quantized fleets (``serve_fleet --table-dtype``) start first and load
    while the in-process fleets run."""
    t_start = time.perf_counter()
    run, valid = e2e_run["run"], e2e_run["valid"]
    quantized = ("bfloat16", "int8")
    watch = {dtype: os.path.join(tmp, f"fleet_watch_{dtype}")
             for dtype in quantized}
    for d in watch.values():
        os.makedirs(d)
    base = ["--model-dir", run, "--feature-shards", E2E_SHARDS, "--port",
            "0", "--device", device]
    procs, wait_urls = spawn_servers(
        [["serve_game", *base, "--fleet-shard", str(i),
          "--fleet-shard-count", str(FLEET_SHARDS)]
         for i in range(FLEET_SHARDS)]
        + [["serve_fleet", *base, "--fleet-shards", str(FLEET_SHARDS),
            "--no-warmup", "--table-dtype", dtype, "--router-watch-dir",
            watch[dtype], "--router-watch-poll-s", "0.5",
            "--rank-item-coordinate", "perSong", "--rank-max-k", "8"]
           for dtype in quantized])
    try:
        launches, lat = _fleet_phase(e2e_run, records, tmp, card, device,
                                     quantized, watch, wait_urls)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=60)
    log(f"[16] done in {time.perf_counter() - t_start:.1f} s")
    return launches, lat


def _fleet_phase(e2e_run, records, tmp, card, device, quantized, watch,
                 wait_urls):
    """:func:`run_fleet_phase`'s checks, with its server processes
    started."""
    from photon_ml_tpu_torch.cli import refresh_game, train_game
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.fleet.router import FleetRouter, RouterServer
    from photon_ml_tpu_torch.fleet.sharding import ShardMap
    from photon_ml_tpu_torch.serving import (
        GameServer,
        MicroBatcher,
        ModelRegistry,
        ServingService,
    )

    run, valid = e2e_run["run"], e2e_run["valid"]
    shards = tuple(parse_feature_shard_config(s)
                   for s in E2E_SHARDS.split(","))
    single_reg = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                               device=device, warmup=True)
    single = single_reg.load(run)
    want = engine_scores(single, records)
    check = records[:FLEET_CHECK_RECORDS]

    # (a) shard views ------------------------------------------------------
    fleet, up = start_fleet(run, device, "--fleet-shards", str(FLEET_SHARDS))
    try:
        fractions, full = fleet_shard_views(fleet, single)
        captures = [h.service.registry.active().engine.compile_count
                    for h in fleet.hosts]
        log(f"[16a] serve_fleet --fleet-shards {FLEET_SHARDS} up in "
            f"{up:.2f} s ({card}); perUser and perSong rows disjoint across "
            f"hosts, union = the unsharded table bit for bit; table bytes a "
            f"host / unsharded ({full} bytes): "
            + ", ".join(f"{f:.4f}" for f in fractions)
            + f"; captures {captures}")
        assert all(0.2 < f < 0.3 for f in fractions), fractions
        assert captures == [ENGINE_CAPTURES] * FLEET_SHARDS, captures

        # (b) /score -------------------------------------------------------
        smap = ShardMap.default(FLEET_SHARDS)
        crossed = sum(
            smap.shard_of(r["metadataMap"]["userId"])
            != smap.shard_of(r["metadataMap"]["songId"]) for r in records)
        t0 = time.perf_counter()
        got, merged = fleet_scores(fleet.url, records)
        wall = time.perf_counter() - t0
        mismatch = int(np.count_nonzero(got != want))
        log(f"[16b] {len(records)} records through the router in "
            f"{wall:.2f} s ({len(records) // FLEET_BATCH} requests): "
            f"{merged} crossed shards (margin merge; {crossed} expected), "
            f"{mismatch} scores differ from the unsharded host's")
        assert merged == crossed > 0, (merged, crossed)
        assert mismatch == 0, mismatch
        sweep = records[:FLEET_BUCKET_RECORDS]
        t0 = time.perf_counter()
        sizes = bucket_sweep(single, sweep)
        bucket_sweep(fleet.hosts[0].service.registry.active(), sweep)
        log(f"  {len(sweep)} records through the unsharded engine and "
            f"host 0's at every bucket size {sizes[0]}-{sizes[-1]}: bit "
            f"for bit equal ({time.perf_counter() - t0:.2f} s)")

        # (c) /rank --------------------------------------------------------
        rank_run = os.path.join(tmp, "fleet_rank")
        res, rank_wall, rank_launches = counted_call(
            train_game.run, rank_model_args(e2e_run["train"], valid,
                                            rank_run))
        rank_reg = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                                 device=device, rank_coordinate="perSong",
                                 rank_max_k=16)
        rank_sm = rank_reg.load(rank_run)
        rank_fleet, rank_up = start_fleet(
            rank_run, device, "--fleet-shards", str(FLEET_SHARDS),
            "--no-warmup", "--rank-item-coordinate", "perSong",
            "--rank-max-k", "16")
        try:
            asked = records[:FLEET_RANK_RECORDS]
            ranked = rank_sm.rank(asked, [FLEET_RANK_K] * len(asked))
            for rec, (ids, scores) in zip(asked, ranked):
                status, body, _ = fleet_request(
                    rank_fleet.url, "POST", "/rank",
                    {"record": rec, "k": FLEET_RANK_K})
                assert status == 200, body
                assert body["ids"] == list(ids), rec["metadataMap"]
                assert body["scores"] == [float(v) for v in scores]
            # (e) the live reshard, on this fleet ---------------------------
            reshard_walls = reshard_phase(rank_fleet, records)
        finally:
            rank_fleet.stop()
        log(f"[16c] train_game global + perSong: {rank_wall:.2f} s "
            f"(launches {rank_launches}, AUC "
            f"{res['best_evaluation']['AUC']:.6f}); fleet of "
            f"{FLEET_SHARDS} ranking perSong up in {rank_up:.2f} s: "
            f"{len(asked)} /rank replies (k {FLEET_RANK_K}) equal the "
            f"unsharded ranking's ids and scores")
        del rank_reg, rank_sm

        # (d) per-host patches ---------------------------------------------
        day2 = os.path.join(tmp, "day2")
        assert os.path.isdir(day2), day2
        out_f = os.path.join(tmp, "refresh_fleet")
        res_f, refresh_wall, launches = counted_call(
            refresh_game.run, flag_args(refresh_args(run, day2, valid,
                                                     out_f),
                                        fleet_shards=FLEET_SHARDS))
        assert launches["fused_glm"] > 0 and launches["fused_re"] > 0
        dirs = res_f["shard_patch_dirs"]
        touched_hosts = []
        for cid in ("perUser", "perSong"):
            whole = set(coefficient_records(res_f["patch_dir"], cid))
            parts = [set(coefficient_records(d, cid)) for d in dirs]
            assert sum(map(len, parts)) == len(whole) == len(
                set().union(*parts)), cid
            assert set().union(*parts) == whole, cid
            for i, part in enumerate(parts):
                assert all(smap.shard_of(r) == i for r in part), cid
            touched_hosts.append([len(p) for p in parts])
        host0 = fleet.hosts[0]
        status, body, _ = fleet_request(host0.url, "POST", "/reload",
                                        {"model_dir": dirs[1]})
        assert status == 409 and "foreign shard" in body["error"], body
        parents = [h.service.registry.active().engine for h in fleet.hosts]
        t0 = time.perf_counter()
        status, out, _ = fleet_request(fleet.url, "POST", "/reload",
                                       {"model_dirs": dirs})
        epoch_wall = time.perf_counter() - t0
        assert status == 200, out
        lineages = {h.service.registry.active().lineage
                    for h in fleet.hosts}
        assert lineages == {out["lineage"]}, lineages
        # a version sharing its parent's programs counts the shared cache
        new_captures = []
        for h, parent in zip(fleet.hosts, parents):
            engine = h.service.registry.active().engine
            shared = engine._root is parent._root
            new_captures.append(engine.compile_count
                                - (parent.compile_count if shared else 0))
        for i, c in enumerate(new_captures):
            touched = any(t[i] for t in touched_hosts)
            assert c == (ENGINE_CAPTURES if touched else 0), (i, c)
        merged_reg = ModelRegistry(shards, max_batch=ENGINE_MAX_BATCH,
                                   device=device)
        merged_sm = merged_reg.load(os.path.join(out_f, "best"))
        assert merged_sm.lineage == out["lineage"]
        merged_want = engine_scores(merged_sm, check)
        got, _ = fleet_scores(fleet.url, check)
        mismatch = int(np.count_nonzero(got != merged_want))
        log(f"[16d] refresh_game --fleet-shards {FLEET_SHARDS} on day 2: "
            f"{refresh_wall:.2f} s, launches {launches}; rows per shard "
            f"patch (perUser, perSong): {touched_hosts}; host 0 refused "
            f"shard 1's patch; the two-phase /reload of the set "
            f"{epoch_wall:.2f} s, one lineage, captures per host "
            f"{new_captures}; {mismatch} of {len(check)} scores differ "
            f"from the merged model's unsharded")
        assert mismatch == 0, mismatch

        # (b, d) the bf16 and int8 fleets (serve_fleet processes) against
        # their formats' bounds, before and after the same patch set comes
        # through their --router-watch-dir
        urls, ready = wait_urls()
        bounds = [quant_bounds(single, check), quant_bounds(merged_sm, check)]
        f32 = [want[:len(check)], merged_want]
        for j, dtype in enumerate(quantized):
            url = urls[FLEET_SHARDS + j]
            worst = []
            for k in range(2):
                if k == 1:
                    t0 = time.perf_counter()
                    publish(out_f, watch[dtype], "refresh")
                    wait_lineage(url, out["lineage"])
                    watch_wall = time.perf_counter() - t0
                got, _ = fleet_scores(url, check)
                err = np.abs(got.astype(np.float64) - f32[k])
                worst.append(float((err / bounds[k][dtype]).max()))
            status, body, _ = fleet_request(url, "GET", "/rank?user=u1&k=3")
            log(f"[16b/d] python -m photon_ml_tpu_torch serve_fleet "
                f"--table-dtype {dtype}: up in {ready[FLEET_SHARDS + j]:.2f} "
                f"s (in the background); |diff| from f32 at most "
                f"{worst[0]:.3f} of the format's bound, {worst[1]:.3f} after "
                f"the patch set came through --router-watch-dir (published "
                f"to one lineage everywhere in {watch_wall:.2f} s); /rank "
                f"with perUser: {status} {body.get('error', '')[:72]}")
            assert max(worst) <= 1.0, (dtype, worst)
            assert status == 400 and "only random effect" in body["error"]

        # a version made from per-host patches refuses a reshard: its
        # model holds only its own shard's refreshed rows
        incumbent = fleet.router.shard_map
        status, body, _ = fleet_request(
            fleet.url, "POST", "/reshard",
            {"shard_map": incumbent.with_moves({0: 1}).as_dict()})
        assert status == 409 and "per-host patch" in body["error"], body
        assert fleet.router.shard_map is incumbent
        log(f"[16e] /reshard of the patched fleet: {status}, incumbent map "
            f"{incumbent.map_hash} kept ({body['error'][:120]})")

        # (g) latency: the router beside one host ---------------------------
        batcher = MicroBatcher(lambda recs: single_reg.active().score(recs),
                               max_batch=HTTP_MICROBATCH, max_wait_ms=2.0,
                               max_queue=1024)
        one = GameServer(ServingService(single_reg, batcher=batcher),
                         port=0).start()
        try:
            lat = {"router, hosts in its process": fleet_latency(
                       fleet.url, records),
                   "one host": fleet_latency(one.url, records)}
        finally:
            one.stop()
        # the same load through a router whose hosts are processes of
        # their own (serve_game --fleet-shard, phase 8's model): the share
        # of the gap the one interpreter lock makes
        apart = RouterServer(FleetRouter(urls[:FLEET_SHARDS])).start()
        try:
            got, _ = fleet_scores(apart.url, check)
            assert np.array_equal(got, want[:len(got)])
            lat["router, hosts apart"] = fleet_latency(apart.url, records)
        finally:
            apart.stop()
        log(f"[16g] {FLEET_CLIENTS} clients x {FLEET_RATE} single-record "
            f"/score a second for {FLEET_LOAD_S:g} s ({card}): "
            + "; ".join(f"{k} p50 {v[0]:.2f} ms, p99 {v[1]:.2f} ms "
                        f"({v[2]} requests)" for k, v in lat.items())
            + f" (the {FLEET_SHARDS} serve_game --fleet-shard processes up "
            f"in {max(ready[:FLEET_SHARDS]):.2f} s in the background, "
            f"{len(check)} scores through them the unsharded host's); "
            f"reshard epochs {reshard_walls[0]:.2f} and "
            f"{reshard_walls[1]:.2f} s")
    finally:
        fleet.stop()

    # (f) replica groups ---------------------------------------------------
    replica_phase(rank_run, records, device)
    return launches, lat


# --------------------------------------------------------------------------
# phase 17: the live telemetry plane
# --------------------------------------------------------------------------

#: the memory sampler's period in (a)
TELEMETRY_POLL_S = 0.5
#: the scraper's period while (a) trains
SCRAPE_PERIOD_S = 0.2
#: (d)'s records: a batch of this many, then single records
TELEMETRY_SERVE_RECORDS = 300
TELEMETRY_SERVE_SINGLES = 40


def read_telemetry(tel):
    """A telemetry directory: its span records (annotations dropped) and
    its parsed ``metrics.prom``."""
    from photon_ml_tpu_torch.telemetry.prometheus import parse_text

    with open(os.path.join(tel, "trace.jsonl")) as f:
        spans = [r for r in map(json.loads, f) if "t0" in r]
    with open(os.path.join(tel, "metrics.prom")) as f:
        return spans, parse_text(f.read())


def series(parsed, name, **labels):
    """The values of ``name``'s series whose labels include ``labels``."""
    return [v for lab, v in parsed.get(name, ())
            if all(lab.get(k) == w for k, w in labels.items())]


def check_span_tree(label, spans, root):
    """One root named ``root``, and every span inside its parent."""
    by_id = {s["span_id"]: s for s in spans}
    roots = [s["name"] for s in spans if s["parent_id"] is None]
    assert roots == [root], (label, roots)
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is not None:
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (label, s, p)


def scrape_while(url, fn, also=(), period_s=None):
    """``fn()`` while a thread scrapes ``url`` (then each URL of ``also``,
    in turns) every ``period_s`` (SCRAPE_PERIOD_S): (fn's result, the
    successful scrapes' texts)."""
    import itertools
    import threading
    import urllib.request

    texts, stop = [], threading.Event()
    urls = itertools.cycle((url, *also))

    def loop():
        while not stop.wait(period_s or SCRAPE_PERIOD_S):
            try:
                with urllib.request.urlopen(next(urls), timeout=5) as resp:
                    if resp.status == 200:
                        texts.append(resp.read().decode())
            except OSError:
                pass  # not listening yet, or already closed

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        return fn(), texts
    finally:
        stop.set()
        th.join()


def recorded_re_work(work):
    """A :class:`Patched` wrap of kernel 2's wrapper as the objective
    dispatch calls it, appending ``ops/fused_re.py::work`` of each call
    (the live rows from the count kept on the weights, no device read) to
    ``work``."""
    from photon_ml_tpu_torch.ops import fused_re
    from photon_ml_tpu_torch.ops.objective import live_rows

    def wrap(kernel):
        def wrapper(loss, x, ws, labels, offsets, weights, *a, **kw):
            e, s, d = x.shape
            work.append(fused_re.work(sum(live_rows(weights)), e, s, d,
                                      x.element_size()))
            return kernel(loss, x, ws, labels, offsets, weights, *a, **kw)
        return wrapper
    return wrap


def telemetry_train_game(e2e_run, phase8_launches, tmp, device="cuda"):
    """(a): phase 8's run again with the live plane on. Returns its kernel
    launches."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.ops import fused_glm, objective
    from photon_ml_tpu_torch.resilience.supervisor import _free_loopback_port

    out = os.path.join(tmp, "telemetry_game")
    tel = os.path.join(out, "telemetry")
    port = _free_loopback_port()
    args = cli_args(e2e_run["train"], e2e_run["valid"], out) + [
        "--telemetry-dir", tel, "--telemetry-poll-s", str(TELEMETRY_POLL_S),
        "--metrics-port", str(port), "--device", device]
    re_work = []
    with Patched(objective, "fused_entity_value_and_grad",
                 recorded_re_work(re_work)):
        (result, wall, launches), scrapes = scrape_while(
            f"http://127.0.0.1:{port}/metrics",
            lambda: counted_call(train_game.run, args))
    auc = result["best_evaluation"]["AUC"]
    log(f"[17] (a) train_game with --telemetry-dir --telemetry-poll-s "
        f"{TELEMETRY_POLL_S:g} --metrics-port: {wall:.2f} s (phase 8: "
        f"{e2e_run['wall']:.2f} s, difference {wall - e2e_run['wall']:+.2f} "
        f"s); launches {launches} (phase 8: {phase8_launches}); AUC "
        f"{auc!r} (phase 8: {e2e_run['train_auc']!r}); {len(scrapes)} "
        "scrapes of GET /metrics while it trained")
    assert scrapes and all("photon_" in t for t in scrapes), len(scrapes)
    assert auc == e2e_run["train_auc"], (auc, e2e_run["train_auc"])
    assert launches["fused_glm"] == phase8_launches["fused_glm"]
    assert launches["fused_re"] == phase8_launches["fused_re"]
    assert same_records(os.path.join(out, "best"),
                        os.path.join(e2e_run["run"], "best")), \
        "coefficients differ from phase 8's"
    spans, prom = read_telemetry(tel)
    check_span_tree("(a)", spans, "train_game")
    names = [s["name"] for s in spans]
    steps = sorted((s["sweep"], s["coordinate"]) for s in spans
                   if s["name"] == "cd.step")
    assert names.count("cd.sweep") == 1, names.count("cd.sweep")
    assert steps == [(0, "global"), (0, "perSong"), (0, "perUser")], steps
    timed_stages = {m["stage"] for m in stages_of(out) if "seconds" in m}
    span_stages = {s["name"] for s in spans if s.get("kind") == "stage"}
    histogrammed = {lab["stage"] for lab, _ in
                    prom.get("photon_stage_seconds_count", ())}
    assert timed_stages <= span_stages and timed_stages <= histogrammed, (
        timed_stages, span_stages, histogrammed)
    # the fixed effect's bytes: kernel 1's count (the same function the
    # bounds of phase 2 divide) summed over the run's kernel-1 launches,
    # all of them the fixed effect's: 1M live rows of 33 bf16 columns
    d = len(coefficient_records(os.path.join(out, "best"), "global",
                                "fixed-effect")["global"])
    per = fused_glm.work(E2E["rows"], E2E["rows"], d, 2, 1)
    (fe_bytes,) = series(prom, "photon_bytes_accessed_total",
                         fn="game.fixed_effect")
    (fe_ops,) = series(prom, "photon_flops_total", fn="game.fixed_effect")
    log(f"  photon_bytes_accessed_total{{fn=game.fixed_effect}} "
        f"{fe_bytes:.0f} = {launches['fused_glm']} launches x "
        f"{per.nbytes:.0f} bytes; photon_flops_total {fe_ops:.0f}")
    assert fe_bytes == launches["fused_glm"] * per.nbytes, (fe_bytes, per)
    assert fe_ops == launches["fused_glm"] * per.ops, (fe_ops, per)
    # the random effects' bytes: kernel 2's count summed over the run's
    # kernel-2 launches (recorded beside each launch, from the same
    # live-row counts), all of them inside the two fused sweeps
    (re_bytes,) = series(prom, "photon_bytes_accessed_total",
                         fn="game.re.sweep_fused")
    (re_ops,) = series(prom, "photon_flops_total", fn="game.re.sweep_fused")
    want_bytes = sum(w.nbytes for w in re_work)
    want_ops = sum(w.ops for w in re_work)
    log(f"  photon_bytes_accessed_total{{fn=game.re.sweep_fused}} "
        f"{re_bytes:.0f} = the sum of fused_re.work over {len(re_work)} "
        f"launches ({want_bytes:.0f}); photon_flops_total {re_ops:.0f} "
        f"({want_ops:.0f}); game.re.solve_bucket series: "
        f"{series(prom, 'photon_bytes_accessed_total', fn='game.re.solve_bucket')}")
    assert len(re_work) == launches["fused_re"] > 0, (len(re_work), launches)
    assert re_bytes == want_bytes and re_ops == want_ops, (
        re_bytes, want_bytes, re_ops, want_ops)
    in_use = series(prom, "photon_device_bytes_in_use")
    limit = series(prom, "photon_device_bytes_limit")
    peak = series(prom, "photon_peak_memory_bytes", fn="game.fixed_effect")
    log(f"  device bytes in use {in_use}, limit {limit}; peak over the "
        f"fixed-effect solve {peak}; host RSS "
        f"{series(prom, 'photon_host_rss_bytes')}; stages "
        f"{sorted(timed_stages)}")
    if device == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        log(f"  card memory {total} bytes")
        assert in_use and all(0 < v <= total for v in in_use), in_use
        assert limit and all(0 < v <= total for v in limit), limit
        assert peak and 0 < peak[0] <= total, peak
    assert series(prom, "photon_build_info"), "no photon_build_info"
    return launches


def telemetry_train_glm(glm_dir, glm_paths, tmp, device="cuda"):
    """(b): phase 9's TRON run again under --profile --debug-nans
    --telemetry-dir, at its first lambda (the largest, solved from zero,
    so the solve is phase 9's first): over the whole sweep the profiler's
    host events made "Train" 54.6 s and the trace 846 MB (NVIDIA H100 80GB
    HBM3, 700 W).
    Returns its kernel launches."""
    from photon_ml_tpu_torch.cli import train_glm

    name, data, extra = GLM_CLI_RUNS[0]
    assert name == "tron"
    lam = max(GLM_LAMBDAS)
    out = os.path.join(tmp, "telemetry_glm")
    tel = os.path.join(out, "telemetry")
    _, wall, launches = counted_call(train_glm.run, flag_args(glm_cli_args(
        glm_paths[data], glm_paths[data + "_valid"], out,
        extra + ["--profile", "--debug-nans", "--telemetry-dir", tel],
        device=device), regularization_weights=f"{lam:g}"))
    ref = os.path.join(glm_dir, "tron")
    _, lams, imap = read_run(out)
    _, lams9, _ = read_run(ref)
    same = np.array_equal(lams[lam]["w"], lams9[lam]["w"])
    log(f"[17] (b) train_glm TRON at lambda={lam:g} with --profile "
        f"--debug-nans --telemetry-dir: {wall:.2f} s; launches {launches}; "
        f"coefficients bit-identical to phase 9's: {same}")
    if not same:
        c = Contractions(read_glm_data(glm_paths[data], imap, device))
        mask = cli_mask(imap)
        f, _, _ = elastic_net_objective(c, lams[lam]["w"], lam, 0.0, mask)
        f9, _, _ = elastic_net_objective(c, lams9[lam]["w"], lam, 0.0, mask)
        both = lams[lam]["converged"] and lams9[lam]["converged"]
        rel = abs(f - f9) / abs(f9)
        log(f"  f64 f(w) relative |diff| {rel:.3e} (limit "
            f"{OBJECTIVE_RTOL[both]:g})")
        assert rel <= OBJECTIVE_RTOL[both], (lam, rel)
    assert launches["fused_glm"] > 0 and launches["fused_hvp"] > 0, launches
    spans, prom = read_telemetry(tel)
    check_span_tree("(b)", spans, "train_glm")
    assert series(prom, "photon_bytes_accessed_total",
                  fn="glm.sweep_solve")[0] > 0
    path = os.path.join(out, "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    on_device = [e for e in events if e.get("cat") == "kernel"]
    kernels = [e["name"] for e in on_device]
    # kernel 1's bodies take x, w, y, off and wt; kernel 3's x, v and d2w
    k1 = sum(1 for k in kernels if ("_kernel<" in k
                                    and k.count("const*") == 5))
    k3 = sum(1 for k in kernels if ("_kernel<" in k
                                    and k.count("const*") == 3))
    train_s = next(m["seconds"] for m in stages_of(out)
                   if m.get("stage") == "Train")
    busy_s = sum(e.get("dur", 0.0) for e in on_device) / 1e6
    log(f"  {path}: {os.path.getsize(path)} bytes, {len(kernels)} device "
        f"kernels, {k1} of csrc/fused_glm.cu (launches {launches['fused_glm']}"
        f"), {k3} of csrc/fused_hvp.cu (launches {launches['fused_hvp']}); "
        f"device busy {busy_s:.3f} s of the profiled Train stage's "
        f"{train_s:.3f} s ({100.0 * busy_s / train_s:.1f} %)")
    if device == "cuda":
        # one device event a launch of each kernel
        assert (k1, k3) == (launches["fused_glm"], launches["fused_hvp"]), (
            k1, k3, sorted(set(kernels))[:20])
    return launches


def telemetry_debug_nans(tg, tmp, device="cuda"):
    """(c): ``train_game --debug-nans`` at SMALL's 20k rows with a NaN at
    perUser's step fails fast and writes no best/; a NaN reaching each
    kernel's dispatch on the card raises naming the kernel."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.ops import losses as tl
    from photon_ml_tpu_torch.ops import objective
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.resilience import faults

    train = os.path.join(tmp, "small_train.avro")
    valid = os.path.join(tmp, "small_valid.avro")
    if not os.path.exists(train):  # phase 13 writes them
        train, valid = small_files(tg, tmp)
    out = os.path.join(tmp, "telemetry_nan")
    plan = faults.FaultPlan.from_json(json.dumps(NAN_ON_PER_USER))
    t0 = time.perf_counter()
    chain = []
    try:
        with faults.injected(plan):
            train_game.run(cli_args(train, valid, out)
                           + ["--debug-nans", "--device", device])
    except Exception as e:
        while e is not None:
            chain.append(e)
            e = e.__cause__
    wall = time.perf_counter() - t0
    log(f"[17] (c) train_game --debug-nans at {SMALL['rows']} rows with "
        f"a NaN at perUser's step: {wall:.2f} s, raised "
        + " <- ".join(f"{type(e).__name__}: {str(e)[:120]}" for e in chain))
    assert any(isinstance(e, FloatingPointError) for e in chain), chain
    assert not os.path.exists(os.path.join(out, "best"))
    assert not objective.debug_nans()
    gen = torch.Generator(device=device).manual_seed(1717)
    obj = objective.GLMObjective(tl.LogisticLoss)
    n, d, e_, s_ = 4_096, 33, 8, 64
    bad = {"fused_value_and_grad": (
               torch.zeros(d, device=device), objective.GLMData(
                   design=DenseDesign(x=torch.randn((n, d), device=device,
                                                    generator=gen)),
                   labels=torch.ones(n, device=device),
                   offsets=torch.full((n,), float("nan"), device=device),
                   weights=torch.ones(n, device=device))),
           "fused_entity_value_and_grad": (
               torch.zeros((e_, 8), device=device), objective.GLMData(
                   design=DenseDesign(x=torch.randn((e_, s_, 8),
                                                    device=device,
                                                    generator=gen)),
                   labels=torch.ones((e_, s_), device=device),
                   offsets=torch.full((e_, s_), float("nan"),
                                      device=device),
                   weights=torch.ones((e_, s_), device=device)))}
    # on the card the message names the kernel's wrapper, on the CPU its
    # plain version
    plain = "" if device == "cuda" else "_plain"
    objective.set_debug_nans(True)
    try:
        for name, (w, data) in bad.items():
            try:
                obj.value_and_grad(w, data)
            except FloatingPointError as err:
                log(f"  {err}")
                assert (f"{name}{plain} at shape "
                        f"{tuple(data.design.x.shape)}") in str(err), err
            else:
                raise AssertionError(f"{name}: no FloatingPointError")
        w, data = bad["fused_value_and_grad"]
        ok = dataclasses.replace(data, offsets=torch.zeros(
            n, device=device))
        try:
            obj.hvp_operator(w, ok)(torch.full((d,), float("nan"),
                                               device=device))
        except FloatingPointError as err:
            log(f"  {err}")
            assert f"fused_hvp{plain} at shape ({n}, {d})" in str(err), err
        else:
            raise AssertionError("fused_hvp: no FloatingPointError")
    finally:
        objective.set_debug_nans(False)


def telemetry_serve_game(e2e_run, records, tmp, device="cuda"):
    """(d): serve_game on phase 8's best/ with --telemetry-dir: the
    serving spans, no capture beyond warmup's, and the scores of a server
    without a trace bit for bit."""
    import urllib.request

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.serving.engine import SCORING_FN_LABEL
    from photon_ml_tpu_torch.telemetry import metrics

    def builds():
        fam = metrics.default_registry().get("photon_compiles_total")
        return sum(c.value for lab, c in (fam.children() if fam else ())
                   if lab == (SCORING_FN_LABEL,))

    def post(url, recs):
        req = urllib.request.Request(
            url + "/score", data=json.dumps({"records": recs}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())["scores"]

    recs = records[:TELEMETRY_SERVE_RECORDS]
    tel = os.path.join(tmp, "telemetry_serve")
    base = ["--model-dir", e2e_run["run"], "--feature-shards",
            "global=g|intercept,item=it|noIntercept", "--port", "0",
            "--microbatch", "64", "--max-batch", str(ENGINE_MAX_BATCH),
            "--device", device]
    got = {}
    for traced in (False, True):
        before = builds()
        t0 = time.perf_counter()
        server = serve_game.build_server(
            base + (["--telemetry-dir", tel] if traced else [])).start()
        load_s = time.perf_counter() - t0
        try:
            engine = server.service.registry.active().engine
            captured = builds() - before
            batch = post(server.url, recs)
            singles = [post(server.url, [r])[0]
                       for r in recs[:TELEMETRY_SERVE_SINGLES]]
            got[traced] = (batch, singles)
            after = engine.compile_count
        finally:
            server.stop()
            server.telemetry.close()
        log(f"[17] (d) serve_game{' --telemetry-dir' if traced else ''}: "
            f"loaded in {load_s:.2f} s, {captured:.0f} captures counted in "
            f"photon_compiles_total{{fn={SCORING_FN_LABEL}}}, engine "
            f"compile_count {after}")
        assert captured == after == ENGINE_CAPTURES, (captured, after)
    assert got[True] == got[False], "tracing changed a score"
    spans, prom = read_telemetry(tel)
    names = [s["name"] for s in spans]
    log(f"  spans: " + ", ".join(f"{n} {names.count(n)}"
                                 for n in sorted(set(names))))
    assert names.count("serving.score") == 1 + TELEMETRY_SERVE_SINGLES
    assert names.count("serving.request") == 1 + TELEMETRY_SERVE_SINGLES
    assert series(prom, "photon_build_info")


def run_telemetry_phase(tg, e2e_run, phase8_launches, glm_dir, glm_paths,
                        records, tmp, device="cuda"):
    """Phase 17. Returns (a)'s and (b)'s kernel launches."""
    t0 = time.perf_counter()
    launches = {"train_game": telemetry_train_game(e2e_run, phase8_launches,
                                                   tmp, device),
                "train_glm": telemetry_train_glm(glm_dir, glm_paths, tmp,
                                                 device)}
    telemetry_debug_nans(tg, tmp, device)
    telemetry_serve_game(e2e_run, records, tmp, device)
    log(f"[17] done in {time.perf_counter() - t0:.1f} s")
    return launches



# --------------------------------------------------------------------------
# phase 18: the retained telemetry plane
# --------------------------------------------------------------------------

#: (a) the plane's host: the ring's period and capacity (the ring holds the
#: host's whole life at this period, so its requests series sums to every
#: request the host answered) and the stall watchdog's timeout
RETAINED_PERIOD_S = 0.25
RETAINED_CAPACITY = 4_096
RETAINED_WATCHDOG_S = 120.0
#: (a) the requests: batches of these sizes, then single records sent by
#: RETAINED_CLIENTS threads
RETAINED_BATCHES = (1, 3, 17, 64, 250, 900)
RETAINED_SINGLES = 120
RETAINED_CLIENTS = 4
#: (a) the period of the /history and /metrics scrapes during the requests
RETAINED_SCRAPE_S = 0.05
#: (b) the stall a fault plan adds to every scoring call of one shard-0 host
HOT_STALL_S = 0.05
#: (b) requests through the router between two hand ticks, records each
HOT_REQUESTS = 6
HOT_RECORDS = 64


def fault_plan_env(*specs):
    """The environment that arms a fault plan in a server process."""
    return {"PHOTON_FAULT_PLAN": json.dumps({"seed": 0,
                                             "specs": list(specs)})}


def flight_dumps(d):
    """The published dumps in ``d``: {name: (header, records)}. Each must
    be whole: every line JSON, the header's ``retained`` = its records."""
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(d, name)) as f:
            lines = [json.loads(line) for line in f]
        header, records = lines[0], lines[1:]
        assert header["kind"] == "flight_header", (name, header)
        assert header["retained"] == len(records), (name, header)
        out[name] = (header, records)
    return out


def wait_dump(d, known, timeout_s=60):
    """The name and header of the first dump in ``d`` not in ``known``."""
    limit = time.perf_counter() + timeout_s
    while True:
        dumps = flight_dumps(d)
        new = sorted(set(dumps) - set(known))
        if new:
            return new[0], dumps[new[0]][0]
        if time.perf_counter() > limit:
            raise TimeoutError(f"no new flight dump in {d}: {sorted(dumps)}")
        time.sleep(0.05)


def postmortem_page(path):
    """``tools/postmortem.py`` on one dump, as an operator runs it."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "postmortem.py"), path],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("== photon flight postmortem =="), \
        out.stdout[:200]
    return out.stdout


def retained_manual_dump(run, records, tmp, device):
    """(a) in this process: serve_game with --flight-dir, a few requests
    and a ring tick, then a manual dump, rendered by tools/postmortem.py."""
    from photon_ml_tpu_torch.cli import serve_game

    d = os.path.join(tmp, "flight_manual")
    t0 = time.perf_counter()
    server = serve_game.build_server(
        ["--model-dir", run, "--feature-shards", E2E_SHARDS, "--port", "0",
         "--device", device, "--no-warmup", "--flight-dir", d]).start()
    try:
        for k in range(4):
            status, body, _ = fleet_request(
                server.url, "POST", "/score",
                {"records": records[8 * k:8 * k + 8]})
            assert status == 200, body
        server.history.sample()
        path = server.flight.dump("manual")
    finally:
        server.stop()
        server.telemetry.close()
    dumps = flight_dumps(d)
    assert sorted(os.listdir(d)) == [os.path.basename(path)]
    header, recs = dumps[os.path.basename(path)]
    assert header["reason"] == "manual" and header["source"] == "host"
    kinds = {r["kind"] for r in recs}
    assert {"span", "history"} <= kinds, kinds
    page = postmortem_page(path)
    assert "reason: manual" in page and "serving.score" in page, page[:800]
    log(f"[18a] in-process serve_game --flight-dir: a manual dump of "
        f"{len(recs)} records ({', '.join(sorted(kinds))}), rendered by "
        f"tools/postmortem.py ({time.perf_counter() - t0:.2f} s)")


def retained_host(proc, url, bare_url, records, run, flight_dir):
    """(a) against the plane's host process (its fault plan trips
    ``serving.reload``) and a host without the plane. Returns the plane
    host's latency (p50, p99, requests)."""
    import threading
    import urllib.request

    from photon_ml_tpu_torch.serving.engine import SCORING_FN_LABEL
    from photon_ml_tpu_torch.telemetry.prometheus import parse_text

    def builds():
        _, health, _ = fleet_request(url, "GET", "/healthz")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            text = resp.read().decode()
        return (health["compiles"],
                sum(series(parse_text(text), "photon_compiles_total",
                           fn=SCORING_FN_LABEL)))

    batches, lo = [], 0
    for n in RETAINED_BATCHES:
        batches.append(records[lo:lo + n])
        lo += n
    singles = records[lo:lo + RETAINED_SINGLES]

    def send(u):
        replies = [None] * (len(batches) + len(singles))
        for i, b in enumerate(batches):
            status, body, _ = fleet_request(u, "POST", "/score",
                                            {"records": b})
            assert status == 200, body
            replies[i] = body["scores"]

        def client(t):
            for j in range(t, len(singles), RETAINED_CLIENTS):
                status, body, _ = fleet_request(
                    u, "POST", "/score", {"record": singles[j]})
                if status == 200:
                    replies[len(batches) + j] = body["scores"]

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(RETAINED_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert None not in replies, "a single-record request failed"
        return replies

    before = builds()
    assert before == (ENGINE_CAPTURES, ENGINE_CAPTURES), before
    t0 = time.perf_counter()
    replies, scrapes = scrape_while(url + "/history", lambda: send(url),
                                    also=(url + "/metrics",),
                                    period_s=RETAINED_SCRAPE_S)
    traffic_s = time.perf_counter() - t0
    bare = send(bare_url)
    sent = len(replies)
    differ = sum(a != b for a, b in zip(replies, bare))
    after = builds()
    log(f"[18a] serve_game --history-capacity {RETAINED_CAPACITY} "
        f"--history-period-s {RETAINED_PERIOD_S:g} --flight-dir "
        f"--watchdog-timeout-s {RETAINED_WATCHDOG_S:g} (a process): {sent} "
        f"requests ({sum(map(len, batches))} records in "
        f"{len(batches)} batches, {len(singles)} singles from "
        f"{RETAINED_CLIENTS} threads) in {traffic_s:.2f} s under "
        f"{len(scrapes)} interleaved /history and /metrics scrapes; "
        f"{differ} replies differ from a host without the plane; captures "
        f"(/healthz, photon_compiles_total) {before} before, {after} after")
    kinds = {"history" if t.startswith("{") else "metrics" for t in scrapes}
    assert kinds == {"history", "metrics"}, (len(scrapes), kinds)
    assert differ == 0, differ
    assert after == before, (before, after)

    # the ring: every request it saw, in ticks on its own thread
    limit = time.perf_counter() + 30
    while True:
        _, hist, _ = fleet_request(url, "GET",
                                   "/history?series=requests,duty_cycle")
        rows = hist["snapshots"]
        total = sum(r["series"]["requests"] for r in rows)
        if total >= sent or time.perf_counter() > limit:
            break
        time.sleep(RETAINED_PERIOD_S)
    duty = [r["series"]["duty_cycle"] for r in rows]
    log(f"  the ring: {len(rows)} ticks (first {rows[0]['tick']}), "
        f"requests summed {total:g} of {sent}; duty_cycle max "
        f"{max(duty):.4f}, mean {sum(duty) / len(duty):.4f}")
    assert rows[0]["tick"] == 1, "the ring wrapped"
    assert total == sent, (total, sent)
    assert all(0.0 <= v <= 1.0 for v in duty), (min(duty), max(duty))
    assert max(duty) > 0.0, "the execute stage never showed in the ring"
    lat = fleet_latency(url, records)

    # the fault-site trip and SIGTERM: one whole dump each
    status, body, _ = fleet_request(url, "POST", "/reload",
                                    {"model_dir": run})
    assert status == 409 and "InjectedFault" in body["error"], body
    name, header = wait_dump(flight_dir, ())
    assert header["reason"] == "fault_site", header
    proc.terminate()
    rc = proc.wait(timeout=60)
    name2, header2 = wait_dump(flight_dir, (name,))
    assert header2["reason"] == "sigterm", header2
    assert rc == 128 + 15, rc
    left = sorted(os.listdir(flight_dir))
    assert left == sorted([name, name2]), left  # no .tmp, nothing else
    pages = [postmortem_page(os.path.join(flight_dir, n))
             for n in (name, name2)]
    assert "reason: fault_site" in pages[0], pages[0][:400]
    assert "reason: sigterm" in pages[1], pages[1][:400]
    log(f"  a faulted /reload (serving.reload): {status}, dump "
        f"{header['retained']} records; SIGTERM: exit {rc}, dump "
        f"{header2['retained']} records; both whole, no .tmp, both "
        "rendered by tools/postmortem.py")
    return lat


def retained_fleet(host_urls, hot_url, bare_url, records, tmp, card,
                   fleet_walls, host_lat):
    """(b) routers in this process, with the plane, over the shard host
    processes: the fold of the rings, the hot shard, the scores."""
    from photon_ml_tpu_torch.cli.config import RetainedConfig
    from photon_ml_tpu_torch.cli.serve_fleet import arm_router_plane
    from photon_ml_tpu_torch.fleet.observe import fold_fleet_snapshots
    from photon_ml_tpu_torch.fleet.router import FleetRouter, RouterServer
    from photon_ml_tpu_torch.telemetry.aggregate import aggregate_text

    check = records[:FLEET_CHECK_RECORDS]
    want, _ = fleet_scores(bare_url, check)
    flight = os.path.join(tmp, "flight_fleet")
    router = FleetRouter(host_urls)
    plane = arm_router_plane(router, RetainedConfig(
        history_capacity=64, flight_dir=flight))
    server = RouterServer(router).start()
    try:
        got, merged = fleet_scores(server.url, check)
        mismatch = int(np.count_nonzero(got != want))
        for k in range(plane.advisor.sustain_ticks):
            fleet_scores(server.url, records[k * 500:(k + 1) * 500])
            plane.history.sample()
        _, cool, _ = fleet_request(server.url, "GET", "/advisor")
        # the router's newest /history row against the metrics_fold
        # layout of the rings it folded: the router's ring as the root
        # metrics.prom, each host's newest snapshot under hosts/
        seen = {}
        scrape = router.observer.scrape_history

        def recorded():
            seen["rings"] = scrape()
            return seen["rings"]

        router.observer.scrape_history = recorded
        status, body, _ = fleet_request(server.url, "GET",
                                        "/history?raw=1&window=1")
        assert status == 200, body
        newest = body["snapshots"][-1]
        rings = seen["rings"]
        root = plane.history.snapshots()[-1]
        folded = fold_fleet_snapshots(
            aggregate_text([root["prom"]]),
            [(s, r, ring[-1]["prom"]) for s, r, ring in rings])
        lat = fleet_latency(server.url, records)
        dump = plane.flight.dump("manual")
        page = postmortem_page(dump)
    finally:
        plane.close()
        server.stop()
    log(f"[18b] a router with the plane over the {FLEET_SHARDS} shard "
        f"processes: {len(check)} scores, {merged} crossing shards, "
        f"{mismatch} off a host without the plane; after "
        f"{plane.advisor.sustain_ticks} cool hand ticks /advisor hot "
        f"{cool['hot']}, recommendation {cool['recommendation']}; newest "
        f"/history?raw=1 row (tick {newest['tick']}, "
        f"{len(newest['prom'])} bytes) "
        + ("equals" if newest["prom"] == folded else "DIFFERS from")
        + f" the metrics_fold layout of the {len(rings)} rings "
        f"(host ring lengths {[len(ring) for _, _, ring in rings]}); the "
        f"fleet's manual dump rendered ({len(page)} bytes)")
    assert mismatch == 0, mismatch
    assert cool["hot"] == [] and cool["recommendation"] is None, cool
    assert cool["ticks"] == plane.advisor.sustain_ticks, cool
    assert [(s, r) for s, r, _ in rings] == [
        (s, 0) for s in range(FLEET_SHARDS)], rings
    assert newest["tick"] == root["tick"], (newest["tick"], root["tick"])
    assert newest["prom"] == folded, "the fold differs from metrics_fold's"
    assert "source: fleet" in page and "fleet.request" in page, page[:800]

    # the hot shard: shard 0 served by the host whose scoring calls stall
    hot = FleetRouter([hot_url] + list(host_urls[1:]))
    hot_plane = arm_router_plane(hot, RetainedConfig(history_capacity=64))
    hot_server = RouterServer(hot).start()
    try:
        ticks = []
        for k in range(hot_plane.advisor.sustain_ticks):
            for j in range(HOT_REQUESTS):
                lo = (k * HOT_REQUESTS + j) * HOT_RECORDS
                status, body, _ = fleet_request(
                    hot_server.url, "POST", "/score",
                    {"records": records[lo:lo + HOT_RECORDS]})
                assert status == 200, body
            snap = hot_plane.history.sample()
            state = hot_plane.advisor.status()
            ticks.append((state["hot"], {
                s: v["skew"] for s, v in state["shards"].items()},
                snap["series"]["shard_p99"]))
        _, advice, _ = fleet_request(hot_server.url, "GET", "/advisor")
        smap = hot.shard_map
        target = smap.rebalanced(FLEET_SHARDS + 1)
        moves = {str(b): target.buckets[b]
                 for b in sorted(smap.moved_buckets(target))}
        got_hot, _ = fleet_scores(hot_server.url, check[:1_000])
    finally:
        hot_plane.close()
        hot_server.stop()
    rec = advice["recommendation"]
    log(f"[18b] shard 0 served by a host that stalls {HOT_STALL_S:g} s a "
        f"scoring call (a fault plan): {HOT_REQUESTS} requests of "
        f"{HOT_RECORDS} records between hand ticks; hot set, skew and "
        "shard p99 (s) by tick: "
        + "; ".join(f"{h} {sk} {p99}" for h, sk, p99 in ticks)
        + f"; /advisor recommends {rec and rec['n_moves']} bucket moves to "
        f"{rec and rec['n_shards']} shards, ShardMap.rebalanced "
        f"{len(moves)}")
    for k, (hot_set, _, _) in enumerate(ticks[:-1]):
        assert 0 not in hot_set, (k + 1, ticks)
    assert 0 in ticks[-1][0], ticks
    assert 0 in advice["hot"] and advice["detections"] >= 1, advice
    assert rec["n_shards"] == FLEET_SHARDS + 1, rec
    assert rec["moves"] == moves and rec["n_moves"] == len(moves), rec
    assert np.array_equal(got_hot, want[:len(got_hot)]), "hot fleet scores"
    log(f"[18] walls ({card}), {FLEET_CLIENTS} clients x {FLEET_RATE} "
        f"single-record /score a second for {FLEET_LOAD_S:g} s: with the "
        f"plane, one host p50 {host_lat[0]:.2f} ms, p99 {host_lat[1]:.2f} "
        f"ms; the router over host processes p50 {lat[0]:.2f} ms, p99 "
        f"{lat[1]:.2f} ms; phase 16 (no plane): "
        + "; ".join(f"{k} p50 {v[0]:.2f} ms, p99 {v[1]:.2f} ms"
                    for k, v in fleet_walls.items()))


def run_retained_phase(e2e_run, records, tmp, card, fleet_walls,
                       device="cuda"):
    """Phase 18 on phase 8's run and phase 10's records. Its server
    processes start first and load while (a)'s in-process server makes a
    manual dump: the plane's host (its fault plan trips
    ``serving.reload``), a host without the plane, the 4 shard hosts of
    (b) and one more shard-0 host whose scoring calls stall."""
    t_start = time.perf_counter()
    run = e2e_run["run"]
    base = ["--model-dir", run, "--feature-shards", E2E_SHARDS, "--port",
            "0", "--device", device]
    flight_dir = os.path.join(tmp, "flight_host")
    plane = ["--history-capacity", str(RETAINED_CAPACITY),
             "--history-period-s", str(RETAINED_PERIOD_S),
             "--flight-dir", flight_dir,
             "--watchdog-timeout-s", str(RETAINED_WATCHDOG_S)]

    def shard(i):
        return ["--fleet-shard", str(i), "--fleet-shard-count",
                str(FLEET_SHARDS), "--history-period-s",
                str(RETAINED_PERIOD_S)]

    commands = ([["serve_game", *base, *plane], ["serve_game", *base]]
                + [["serve_game", *base, *shard(i)]
                   for i in range(FLEET_SHARDS)]
                + [["serve_game", *base, *shard(0)]])
    envs = ([fault_plan_env({"site": "serving.reload", "at": [0]}), {}]
            + [{}] * FLEET_SHARDS
            + [fault_plan_env({"site": "serving.execute", "rate": 1.0,
                               "mode": "stall",
                               "stall_seconds": HOT_STALL_S})])
    procs, wait_urls = spawn_servers(commands, envs)
    try:
        retained_manual_dump(run, records, tmp, device)
        urls, ready = wait_urls()
        log(f"[18] {len(procs)} serve_game processes up in "
            f"{max(ready):.2f} s (in the background)")
        host_lat = retained_host(procs[0], urls[0], urls[1], records, run,
                                 flight_dir)
        retained_fleet(urls[2:2 + FLEET_SHARDS], urls[-1], urls[1],
                       records, tmp, card, fleet_walls, host_lat)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait(timeout=60)
    log(f"[18] done in {time.perf_counter() - t_start:.1f} s")


# --------------------------------------------------------------------------
# phase 19: background publication and the closed feedback loop
# --------------------------------------------------------------------------

#: (b)'s client-stamped one-record requests, every user and song of them on
#: shard 0 of 2
LOOP_REQUESTS = 64
#: (b)'s router watch-dir poll
LOOP_WATCH_POLL_S = 0.2
#: (b)'s limits: the refresh, the watcher's activation, the refusal
LOOP_REFRESH_TIMEOUT_S = 300
LOOP_ACTIVATE_TIMEOUT_S = 120
#: the spans a background span of phase 17 (a)'s trace may have as its
#: parent: the one it was submitted under, or (the tracer re-parents a span
#: that outlives its parent) the nearest ancestor still open at its end
BACKGROUND_PARENTS = {"io.save.model": {"Train (grid)", "train_game"},
                      "io.save.index": {"train_game"},
                      "io.save.manifest": {"train_game"},
                      "quality.baseline": {"train_game"},
                      "io.read.validation": {"train_game"}}


def same_avro_content(a, b):
    """Two Avro container files equal byte for byte but for their sync
    markers (each file's last 16 bytes)."""
    with open(a, "rb") as f:
        x = f.read()
    with open(b, "rb") as f:
        y = f.read()
    return x.split(x[-16:]) == y.split(y[-16:])


def stray_tmp(root):
    """The ``.tmp`` files and directories anywhere under ``root``."""
    return [os.path.join(d, n) for d, dirs, files in os.walk(root)
            for n in dirs + files if n.endswith(".tmp")]


def check_background_save(save, best, lineage, tmp):
    """(a)'s first check, made at the end of phase 8 while the model the
    background saver published is in memory: ``best/`` against a
    synchronous ``save_game_model`` of that model (``save``, the recorded
    arguments of its ``save_game_model_atomic``). The part files equal
    byte for byte but for their sync markers (the same records in the same
    blocks) and the metadata byte for byte, so the synchronous copy has
    ``lineage``, the id phase 8's reload computed from ``best/``'s
    records."""
    from photon_ml_tpu_torch.io import model_io

    sync_dir = os.path.join(tmp, "sync_best")
    kwargs = {k: v for k, v in save["kwargs"].items() if k != "executor"}
    t0 = time.perf_counter()
    model_io.save_game_model(sync_dir, save["model"], *save["args"],
                             **kwargs)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.path.join(best, "model-metadata.json"), "rb") as f:
        meta_bytes = f.read()
    with open(os.path.join(sync_dir, "model-metadata.json"), "rb") as f:
        assert f.read() == meta_bytes
    metadata = json.loads(meta_bytes)
    assert set(metadata["coordinates"]) == {"global", "perUser", "perSong"}
    sizes = {}
    for cid, info in metadata["coordinates"].items():
        paths = [os.path.join(d, info["type"], cid, "coefficients",
                              "part-00000.avro") for d in (best, sync_dir)]
        assert same_avro_content(*paths), cid
        sizes[cid] = os.path.getsize(paths[0])
    compare_s = time.perf_counter() - t0
    save_s = next(m["seconds"] for m in stages_of(os.path.dirname(best))
                  if m.get("stage") == "Save models")
    log(f"[19a] phase 8's best/ (background saver) = a synchronous "
        f"save_game_model of the same model: part files ("
        f"{', '.join(f'{c} {n} bytes' for c, n in sizes.items())}) equal "
        f"but for their sync markers, metadata byte for byte, lineage "
        f"{lineage} on both ({compare_s:.2f} s to compare); walls: phase "
        f"8's \"Save models\" (the join) {save_s:.3f} s, the synchronous "
        f"save of best/ alone {sync_s:.3f} s")
    shutil.rmtree(sync_dir)


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def io_overlap(spans):
    """The async I/O overlap of a trace, as ``tools/perf_report.py``'s
    section of that name defines it (a CPU test holds the two equal):
    per class (``save``: ``io.save.*``, ``read``: ``io.read.*``), the
    seconds of the I/O spans whose parent is not itself an I/O span, and
    the share of them inside the union of the train intervals (``cd.sweep``
    spans and ``Train*`` stages) of their process (0 where a span names
    none)."""
    spans = [{"process": 0, **s} for s in spans]
    by_id = {(s["process"], s["span_id"]): s for s in spans}
    train = {}
    for s in spans:
        if s["name"] == "cd.sweep" or (s.get("kind") == "stage"
                                       and str(s["name"]).startswith("Train")):
            train.setdefault(s["process"], []).append(
                (float(s["t0"]), float(s["t1"])))
    merged = {p: _merged(iv) for p, iv in train.items()}
    out = {}
    for cls in ("save", "read"):
        total = hidden = 0.0
        count = 0
        for s in spans:
            if not str(s["name"]).startswith(f"io.{cls}"):
                continue
            parent = by_id.get((s["process"], s.get("parent_id")))
            if parent is not None and str(parent["name"]).startswith("io."):
                continue
            lo, hi = float(s["t0"]), float(s["t1"])
            total += float(s["seconds"])
            hidden += sum(max(0.0, min(hi, b) - max(lo, a))
                          for a, b in merged.get(s["process"], []))
            count += 1
        if count:
            out[cls] = {"seconds": total, "hidden_seconds": hidden,
                        "spans": count,
                        "hidden_pct": (100.0 * hidden / total
                                       if total > 0 else 0.0)}
    if not out:
        return None
    out["train_wall_s"] = sum(hi - lo for iv in merged.values()
                              for lo, hi in iv)
    return out


def publication_phase(tg, tel, tmp, device="cuda"):
    """(a), past its first check (made in phase 8): the background spans
    of phase 17 (a)'s trace (phase 8's run with ``--telemetry-dir``) and
    their async I/O overlap; a ``train_game`` at SMALL's size under a
    ``PHOTON_FAULT_PLAN`` on ``io.model_save``."""
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.resilience import faults

    # the background spans of phase 8's run traced (phase 17 (a))
    spans, _ = read_telemetry(tel)
    by_id = {s["span_id"]: s for s in spans}
    for name, parent in BACKGROUND_PARENTS.items():
        got = [by_id[s["parent_id"]]["name"] for s in spans
               if s["name"] == name]
        assert got and set(got) <= parent, (name, got)
    parts = [by_id[s["parent_id"]]["name"] for s in spans
             if s["name"] == "io.save.part"]
    assert parts and set(parts) == {"io.save.model"}, parts
    assert any(s["name"] == "Read validation data" for s in spans)
    overlap = io_overlap(spans)
    assert overlap is not None and {"save", "read"} <= set(overlap), overlap
    (model_span,) = [s for s in spans if s["name"] == "io.save.model"]
    log(f"[19a] phase 17 (a)'s trace: io.save.model "
        f"({model_span['seconds']:.3f} s) under "
        f"\"{by_id[model_span['parent_id']]['name']}\", io.save.part under "
        "it, io.read.validation, io.save.index, io.save.manifest and "
        "quality.baseline under the train_game root; async I/O overlap "
        f"(tools/perf_report.py's section): train wall "
        f"{overlap['train_wall_s']:.3f} s; "
        + "; ".join(f"{c}: {overlap[c]['seconds']:.3f} s across "
                    f"{overlap[c]['spans']} span(s), "
                    f"{overlap[c]['hidden_pct']:.1f}% hidden"
                    for c in ("save", "read")))

    # a train_game under a fault on io.model_save at its first visit
    train = os.path.join(tmp, "small_train.avro")
    valid = os.path.join(tmp, "small_valid.avro")
    if not (os.path.exists(train) and os.path.exists(valid)):
        train, valid = small_files(tg, tmp)
    out = os.path.join(tmp, "model_save_fault")
    plan_json = json.dumps({"seed": 0, "specs": [
        {"site": "io.model_save", "at": [0]}]})
    os.environ["PHOTON_FAULT_PLAN"] = plan_json
    try:
        faults._activate_from_env()
        plan = faults.active_plan()
        res, wall, launches = counted_call(train_game.run, flag_args(
            cli_args(train, valid, out), device=device))
    finally:
        faults.deactivate()
        del os.environ["PHOTON_FAULT_PLAN"]
    fired = [r.site for r in plan.fired()]
    model = model_io.load_game_model(
        os.path.join(out, "best"),
        {c: IndexMap.load(os.path.join(out, "feature-indexes", f"{c}.json"))
         for c in ("global", "item")},
        model_io.game_model_entity_vocabs(os.path.join(out, "best")),
        device=device)
    log(f"[19a] train_game at {SMALL['rows']} rows under PHOTON_FAULT_PLAN "
        f"{plan_json}: {wall:.2f} s, fired {fired}, visits "
        f"{plan.visits('io.model_save')}, AUC "
        f"{res['best_evaluation']['AUC']:.7f}, best/ loaded "
        f"({sorted(model.coordinates)}), .tmp left: {stray_tmp(out)}")
    assert fired == ["io.model_save"], fired
    assert plan.visits("io.model_save") == 2
    assert sorted(model.coordinates) == ["global", "perSong", "perUser"]
    assert stray_tmp(out) == []
    return launches


def loop_records(records, n):
    """The first ``n`` of ``records`` whose user and song both live on
    shard 0 of a 2-shard fleet."""
    from photon_ml_tpu_torch.fleet.sharding import shard_of_id

    out = [r for r in records
           if shard_of_id(r["metadataMap"]["userId"], 2) == 0
           and shard_of_id(r["metadataMap"]["songId"], 2) == 0]
    assert len(out) >= n, len(out)
    return out[:n]


def wait_until(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def loop_phase(e2e_run, records, tmp, device="cuda"):
    """(b): the closed loop on phase 8's run: ``serve_fleet --fleet-shards
    2 --reqlog-dir --autopilot-config --router-watch-dir`` in this process,
    shard 0's traffic, a label CSV, a drift event on ``perUser``; then the
    ``join_feedback`` command over both hosts' logs. Returns the refresh's
    kernel launches and the freshness lag."""
    from photon_ml_tpu_torch.cli import join_feedback, score_game
    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.feedback import AutopilotConfig
    from photon_ml_tpu_torch.io import data_reader, model_io
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    run = e2e_run["run"]
    sent = loop_records(records, LOOP_REQUESTS)
    users = sorted({r["metadataMap"]["userId"] for r in sent})
    labels = os.path.join(tmp, "loop_labels.csv")
    with open(labels, "w") as f:
        f.write("request_id,label\n")
        for i, r in enumerate(sent):
            f.write(f"loop-{i:04d},{r['response']!r}\n")
        f.write("ghost,0,1.0\n")  # a label the log never saw: late
    publish = os.path.join(tmp, "loop_publish")
    args = cli_args(e2e_run["train"], e2e_run["valid"], "-")
    coords = args[args.index("--coordinates") + 1:
                  args.index("--update-sequence")]
    config = AutopilotConfig(
        prior_dir=run, publish_dir=publish, feature_shards=E2E_SHARDS,
        coordinates=tuple(coords),
        update_sequence=args[args.index("--update-sequence") + 1],
        grid=tuple(f"{c}={v}" for c, v in E2E_LAMBDAS.items()),
        labels=labels, evaluators="", data_validation="VALIDATE_DISABLED",
        min_rows=1, debounce_s=0.0, min_interval_s=0.0)
    config_path = os.path.join(tmp, "loop_autopilot.json")
    with open(config_path, "w") as f:
        json.dump(config.as_dict(), f)
    reqlog = os.path.join(tmp, "loop_reqlog")
    t0 = time.perf_counter()
    fleet, up_s = start_fleet(
        run, device, "--fleet-shards", "2", "--reqlog-dir", reqlog,
        "--reqlog-segment-records", "8", "--autopilot-config", config_path,
        "--router-watch-dir", publish,
        "--router-watch-poll-s", str(LOOP_WATCH_POLL_S))
    try:
        ap, watcher = fleet.autopilot, fleet.watcher
        assert ap.config.fleet_shards == 2 and ap.device == device
        t1 = time.perf_counter()
        for i, r in enumerate(sent):
            status, body, _ = fleet_request(
                fleet.url, "POST", "/score", {"records": [r]},
                {"X-Photon-Request-Id": f"loop-{i:04d}"})
            assert status == 200, (status, body)
        traffic_s = time.perf_counter() - t1
        health0 = [fleet_request(u, "GET", "/healthz")[1]
                   for u in fleet.host_urls()]
        incumbents = [h.service.registry.active() for h in fleet.hosts]

        # the drift event, the refresh, the activation fleet-wide
        counters = kernel_counters()
        for c in counters.values():
            c.launches = 0
        t_drift = time.perf_counter()
        GLOBAL_BUS.post("quality_drift_detected", version=1, kind="psi",
                        coordinate="perUser", drift=1.0, threshold=0.25,
                        rows=len(sent))
        wait_until(lambda: (ap.stats()["refreshes"] + ap.stats()["aborts"]
                            >= 1 and not ap.stats()["busy"]),
                   LOOP_REFRESH_TIMEOUT_S, "the autopilot's refresh")
        refresh_s = time.perf_counter() - t_drift
        launches = {k: c.launches for k, c in counters.items()}
        stats = ap.stats()
        last = stats["last"] or {}
        join = last.get("join")
        log(f"[19b] serve_fleet --fleet-shards 2 --reqlog-dir "
            f"--autopilot-config --router-watch-dir up in {up_s:.2f} s; "
            f"{len(sent)} one-record requests of {len(users)} users in "
            f"{traffic_s:.2f} s; drift -> refresh published in "
            f"{refresh_s:.2f} s; {stats['refreshes']} refresh, "
            f"{stats['aborts']} abort; join {join}; solved "
            f"{last.get('solved')}; the refresh's launches {launches}")
        assert (stats["refreshes"], stats["aborts"]) == (1, 0), stats
        assert (join["joined"], join["late"], join["unjoined"]) == \
            (len(sent), 1, 0), join
        assert last["solved"]["perUser"] == len(users), last["solved"]
        assert last["solved"]["perSong"] == 0, last["solved"]
        assert launches["fused_glm"] > 0 and launches["fused_re"] > 0, \
            launches

        # the operator's join over both hosts' logs, before more traffic
        t1 = time.perf_counter()
        report = join_feedback.run(
            [a for i in range(2)
             for a in ("--reqlog-dir", os.path.join(reqlog, f"host-{i}"))]
            + ["--labels", labels, "--output",
               os.path.join(tmp, "loop_joined.avro"),
               "--prior-dir", run, "--feature-shards", E2E_SHARDS,
               "--coordinates", *coords])
        log(f"[19b] join_feedback over both hosts' logs with --prior-dir "
            f"in {time.perf_counter() - t1:.2f} s: joined "
            f"{report['joined']}, late {report['late']}, unjoined "
            f"{report['unjoined']}, duplicates {report['duplicates']}; "
            f"delta {report['delta']}")
        for key in ("joined", "unjoined", "late", "duplicates", "requests"):
            assert report[key] == join[key], (key, report, join)
        assert report["delta"]["perUser"]["touched"] == len(users)

        wait_until(lambda: watcher.n_applied >= 1 or watcher.n_rejected,
                   LOOP_ACTIVATE_TIMEOUT_S, "the watcher's activation")
        versions0 = [h["version"] for h in health0]
        wait_until(lambda: all(
            fleet_request(u, "GET", "/healthz")[1]["version"] > v
            for u, v in zip(fleet.host_urls(), versions0)),
            LOOP_ACTIVATE_TIMEOUT_S, "both hosts active")
        lag_s = time.perf_counter() - t_drift
        health1 = [fleet_request(u, "GET", "/healthz")[1]
                   for u in fleet.host_urls()]
        assert (watcher.n_applied, watcher.n_rejected) == (1, 0), (
            watcher.n_applied, watcher.n_rejected)
        # a version whose tables are its parent's replays the parent's
        # graphs: it captured none
        active = [h.service.registry.active() for h in fleet.hosts]
        captured = [0 if a.engine._root is b.engine._root
                    else a.engine.compile_count
                    for a, b in zip(active, incumbents)]
        log(f"[19b] the watcher activated {last['entry']} fleet-wide: "
            f"versions {versions0} -> {[h['version'] for h in health1]}, "
            f"graphs captured by the new versions {captured} (host 1, "
            f"whose patch has no rows: none); freshness lag, drift event "
            f"-> both hosts active: {lag_s:.2f} s")
        assert captured[1] == 0, captured
        assert active[1].stores["perUser"].table is \
            incumbents[1].stores["perUser"].table

        # perSong carried bit for bit; the router's scores of the sent
        # records = score_game of the published run's model
        entry = last["entry"]
        for cid in ("perSong",):
            assert coefficient_records(os.path.join(entry, "best"), cid) \
                == coefficient_records(os.path.join(run, "best"), cid), cid
        status, body, _ = fleet_request(fleet.url, "POST", "/score",
                                        {"records": sent})
        assert status == 200, (status, body)
        routed = np.asarray(body["scores"], np.float64)
        data = os.path.join(tmp, "loop_sent.avro")
        data_reader.write_training_examples(data, sent, codec="null")
        scored = os.path.join(tmp, "loop_scores")
        score_game.run(["--data", data, "--model-dir", entry,
                        "--output-dir", scored, "--feature-shards",
                        E2E_SHARDS, "--device", device])
        batch = np.array([r["predictionScore"] for r in iter_avro_file(
            os.path.join(scored, "scores.avro"))])
        assert np.array_equal(routed, batch), float(
            np.abs(routed - batch).max())
        log(f"[19b] perSong carried bit for bit; the router's {len(sent)} "
            f"scores after activation = score_game of {entry} (f32, bit "
            f"for bit)")

        # a partial per-shard set is refused; the incumbent serves on
        probe = {"records": sent[:1]}
        probe0 = fleet_request(fleet.url, "POST", "/score", probe)[1]
        bad = os.path.join(publish, "zz-partial", "patch-shard-0")
        os.makedirs(bad)
        with open(os.path.join(bad, "model-metadata.json"), "w") as f:
            json.dump({"kind": model_io.PATCH_KIND, "fleetShard": 0,
                       "fleetShardCount": 2, "modelId": "m1",
                       "parentModel": "p0"}, f)
        wait_until(lambda: watcher.n_rejected >= 1,
                   LOOP_ACTIVATE_TIMEOUT_S, "the partial set refused")
        health2 = [fleet_request(u, "GET", "/healthz")[1]
                   for u in fleet.host_urls()]
        probe1 = fleet_request(fleet.url, "POST", "/score", probe)[1]
        log(f"[19b] a partial patch-shard-0 refused ({watcher.n_rejected}); "
            f"versions {[h['version'] for h in health2]}, probe "
            f"{probe1['scores']} (before {probe0['scores']})")
        assert [h["version"] for h in health2] == \
            [h["version"] for h in health1]
        assert probe1["scores"] == probe0["scores"]
        assert watcher.n_applied == 1
    finally:
        fleet.stop()
    log(f"[19b] done in {time.perf_counter() - t0:.1f} s")
    return launches, lag_s


def run_loop_phase(tg, e2e_run, records, tmp, device="cuda"):
    """Phase 19 on phase 8's run and files, phase 10's records and phase
    17 (a)'s trace; returns (a)'s and (b)'s kernel launches."""
    t_start = time.perf_counter()
    tel = os.path.join(tmp, "telemetry_game", "telemetry")
    fault_launches = publication_phase(tg, tel, tmp, device)
    launches, _ = loop_phase(e2e_run, records, tmp, device)
    log(f"[19] done in {time.perf_counter() - t_start:.1f} s")
    return {"fault": fault_launches, "loop": launches}


# --------------------------------------------------------------------------
# phase 20: one process over several slots (--mesh)
# --------------------------------------------------------------------------

#: (a): the mesh fit vs phase 3's unsharded fit, the fixed effect's
#: coefficients and the fixed effect's and the model's validation scores
#: (tests/test_game.py's mesh-fit atol). The random effects' part of the
#: gap is the fixed effect's: its two blocks' sums move its coefficients by
#: ~5e-8, and the random effects' lanes, stopped unconverged after 25
#: L-BFGS iterations, carry that into their residual offsets.
MESH_FIT_ATOL = 2e-3
#: (a): the mesh (data, entity); (b), (e): the entity slots; (c): slots
MESH_FIT_AXES = {"data": 2, "entity": 2}
MESH_SLOTS = 4


def slots(n, device="cuda"):
    """``n`` mesh slots, every one the card this script runs on (the CPU
    in a rehearsal)."""
    return [torch.device("cuda", 0) if device == "cuda"
            else torch.device("cpu")] * n


def mesh_fit(tg, est, datasets, train, valid, result3, evaluators,
             device="cuda"):
    """Phase 20 (a) and (b) on phase 3's data, datasets and fit. Returns
    {part: launches}."""
    from photon_ml_tpu_torch.parallel import distributed
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    out = {}
    mesh = make_mesh(MESH_FIT_AXES, devices=slots(MESH_SLOTS, device))
    est_m = dataclasses.replace(est, mesh=mesh)
    t0 = time.perf_counter()
    fe = tg.FixedEffectDataset.build(
        "global", train, "global", dtype="bfloat16", device=device,
        mesh=mesh)
    build_s = time.perf_counter() - t0
    blocks = fe.design.n_shards
    # the random effects' datasets do not depend on the mesh: phase 3's
    # serve, their lane slices placed per slot at the first solve
    mesh_sets = {"global": fe, "perUser": datasets["perUser"],
                 "perSong": datasets["perSong"]}
    evals = []

    def count(fn):
        def wrapper(self, *a, **kw):
            evals.append(1)
            return fn(self, *a, **kw)
        return wrapper

    with Patched(distributed.DistributedGLMObjective, "value_and_grad",
                 count):
        result, wall, launches = counted_call(
            lambda: est_m.fit(train, [tg.GameOptimizationConfiguration(
                E2E_LAMBDAS)], validation=(valid, evaluators),
                datasets=mesh_sets)[0])
    out["a"] = launches
    auc, auc3 = result.evaluation.primary[1], result3.evaluation.primary[1]
    fe_gap = float((result.model.coordinates["global"].model.coefficients
                    .means - result3.model.coordinates["global"].model
                    .coefficients.means).abs().max())
    t1 = time.perf_counter()
    gaps = {cid: float(np.abs(m.score(valid) - result3.model.coordinates[cid]
                              .score(valid)).max())
            for cid, m in result.model.coordinates.items()}
    by_cid = ", ".join(f"{cid} {g:.3e}" for cid, g in gaps.items())
    fe_s_gap = gaps["global"]
    s_gap = float(np.abs(result.model.score(valid)
                         - result3.model.score(valid)).max())
    score_s = time.perf_counter() - t1
    log(f"[20a] GameEstimator.fit on make_mesh({MESH_FIT_AXES}) of "
        f"{MESH_SLOTS} slots on {mesh.devices[0]}: {wall:.2f} s (the "
        f"sharded fixed effect built in {build_s:.2f} s: {blocks} blocks "
        f"of {fe.design.rows_per_shard} rows); AUC {auc:.6f}, phase 3 "
        f"{auc3:.6f} (|diff| {abs(auc - auc3):.2e}); max |fixed-effect "
        f"coefficient - phase 3's| {fe_gap:.3e}, its validation scores "
        f"{fe_s_gap:.3e}, the model's {s_gap:.3e} (limit "
        f"{MESH_FIT_ATOL:g}; by coordinate: {by_cid}; scored in "
        f"{score_s:.2f} s); launches "
        f"{launches}; fixed-effect evaluations {len(evals)} x {blocks} "
        f"blocks")
    for sweep, cid, sec in result.step_seconds:
        log(f"  sweep {sweep} {cid}: {sec:.3f} s")
    assert max(fe_gap, fe_s_gap, s_gap) <= MESH_FIT_ATOL, (fe_gap, fe_s_gap,
                                                           s_gap)
    assert launches["fused_glm"] == blocks * len(evals) > 0, (launches,
                                                               len(evals))
    assert launches["fused_re"] > 0, launches

    out.update(mesh_bucket(tg, est, datasets, train, device))
    return out


def mesh_bucket(tg, est, datasets, train, device="cuda"):
    """Phase 20 (b): one bucket, whole and over 4 entity slots, from zero,
    as a streaming dataset of the one bucket (the per-bucket loop, its lane
    slices one after another) and a resident one (the fused sweep, its
    members the whole bucket or the 4 lane slices), each with a cache of
    its own. Returns {part: launches}."""
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
    from photon_ml_tpu_torch.ops.fused_re import entity_plan
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    out = {}
    ds = datasets["perUser"]
    cfg = est.coordinate_configs["perUser"]
    widest = max(ds.buckets, key=lambda b: b.n_entities)
    head = max(ds.buckets, key=lambda b: b.tensor_shape[1])
    offsets = torch.zeros(train.n_samples, device=device)
    parts = {}
    for name, bucket in (("widest", widest), ("head", head)):
        e, s_rows, d = bucket.tensor_shape
        per = -(-e // MESH_SLOTS)
        runs = {}
        for path, resident in (("loop", False), ("fused", True)):
            one = dataclasses.replace(
                ds, buckets=[bucket], _device_cache={},
                config=dataclasses.replace(
                    ds.config, cache_device_buckets=resident))
            for m in (None, make_mesh({"entity": MESH_SLOTS},
                                      devices=slots(MESH_SLOTS, device))):
                solver = RandomEffectSolver(
                    task=est.task, config=cfg.optimization,
                    design_dtype=cfg.design_dtype, device=device, mesh=m)
                assert solver._fused_eligible(one) == resident
                (model, scores), _, launch = counted_call(
                    solver.train, one, offsets, E2E_LAMBDAS["perUser"],
                    None, train.shards["item"].dim)
                runs[path, m is not None] = (model, scores.cpu().numpy(),
                                             launch)
            del one
        out[f"b_{name}"] = {k: sum(r[2][k] for r in runs.values())
                            for k in runs["loop", False][2]}
        same = {}
        for path, members in (("loop", "one solve after another"),
                              ("fused", "one member vs 4")):
            (m0, s0, l0), (m1, s1, l1) = runs[path, False], runs[path, True]
            same_w = (np.array_equal(m0.keys, m1.keys)
                      and np.array_equal(m0.coeffs, m1.coeffs))
            same_s = np.array_equal(s0, s1)
            same[path] = same_w and same_s
            log(f"[20b] {name} perUser bucket {e}x{s_rows}x{d}, {path} "
                f"({members}): unsharded vs {{'entity': {MESH_SLOTS}}} "
                f"(slices of {per} lanes): bit for bit {same[path]} "
                f"(coefficients {same_w}, scores {same_s}), max |coefficient "
                f"gap| {float(np.abs(m0.coeffs - m1.coeffs).max()):.3e}, "
                f"|score gap| {float(np.abs(s0 - s1).max()):.3e}; launches "
                f"{l0['fused_re']} / {l1['fused_re']}")
        (mf, sf, _), (ml, sl, _) = runs["fused", False], runs["loop", False]
        same["fused=loop"] = (np.array_equal(mf.coeffs, ml.coeffs)
                              and np.array_equal(sf, sl))
        log(f"[20b] {name}: unsharded fused sweep = streaming loop, bit for "
            f"bit {same['fused=loop']}; kernel 2's chunks an entity "
            f"{entity_plan(e, s_rows, d).chunks} whole, "
            f"{entity_plan(per, s_rows, d, e).chunks} in a slice (the whole "
            f"bucket's plan; {entity_plan(per, s_rows, d).chunks} were the "
            f"slice's own)")
        parts[name] = same
    assert all(all(v.values()) for v in parts.values()), parts
    return out


def mesh_glm(train, lam, device="cuda"):
    """Phase 20 (c) on phase 6's 200k x 1024 f32 data (``train``, on the
    card), at phase 15 (a)'s coefficients and direction. Returns {part:
    launches}."""
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.ops import losses as tl
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
    from photon_ml_tpu_torch.parallel import distributed
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    obj = GLMObjective(loss=tl.LogisticLoss)
    l2 = lam
    w, v = mp_probe(train.dim, device)
    want_vg = obj.value_and_grad(w, train, l2)
    want_hv = obj.hvp(w, v, train, l2)
    out = {}
    t0 = time.perf_counter()
    data_mesh = make_mesh({"data": MESH_SLOTS},
                          devices=slots(MESH_SLOTS, device))
    sharded = distributed.shard_glm_data(train, MESH_SLOTS,
                                         device_put_mesh=data_mesh)
    feat_mesh = make_mesh({"feature": MESH_SLOTS},
                          devices=slots(MESH_SLOTS, device))
    cols, d_pad = distributed.shard_glm_data_features(
        train, MESH_SLOTS, device_put_mesh=feat_mesh)
    layout_s = time.perf_counter() - t0
    assert d_pad == w.shape[0], d_pad
    dist = distributed.DistributedGLMObjective(obj, mesh=data_mesh)
    tp = distributed.FeatureShardedGLMObjective(obj, feat_mesh)
    worst = 0.0
    for name, o, data in (("data", dist, sharded), ("feature", tp, cols)):
        (got_vg, got_hv), wall, launches = counted_call(
            lambda o=o, data=data: (o.value_and_grad(w, data, l2),
                                    o.hvp(w, v, data, l2)))
        _, err_vg = _max_err(got_vg, want_vg)
        _, err_hv = _grad_err(got_hv, want_hv)
        worst = max(worst, err_vg, err_hv)
        out[f"c_{name}"] = launches
        log(f"[20c] {name} axis on {MESH_SLOTS} slots: value+gradient "
            f"relative error {err_vg:.2e}, Hvp {err_hv:.2e} vs the unsharded "
            f"kernels (limit {KERNEL_RTOL:g}); launches {launches}")
        assert err_vg <= KERNEL_RTOL and err_hv <= KERNEL_RTOL, (
            name, err_vg, err_hv)
    # one L-BFGS solve at lambda, sharded over rows and whole
    cfg = glm_configs()[1]
    solves = {}
    for name, o, data in (("unsharded", obj, train),
                          ("data", dist, sharded)):
        res, wall, launches = counted_call(
            glm.OptimizationProblem(o, cfg).run, data,
            torch.zeros(w.shape[0], device=device), lam)
        solves[name] = (res, wall, launches)
    x64 = GLMData(design=DenseDesign(x=train.design.x.double()),
                  labels=train.labels.double(),
                  offsets=train.offsets.double(),
                  weights=train.weights.double())
    f64 = {k: float(obj.value(r.w[0].double(), x64,
                              cfg.regularization.l2_weight(lam)))
           for k, (r, _, _) in solves.items()}
    del x64
    both = all(bool(r.converged[0]) for r, _, _ in solves.values())
    rel = abs(f64["data"] - f64["unsharded"]) / abs(f64["unsharded"])
    gap = float((solves["data"][0].w - solves["unsharded"][0].w).abs().max())
    out["c_lbfgs"] = solves["data"][2]
    log(f"[20c] L-BFGS at lambda {lam:g}: sharded {solves['data'][1]:.2f} s "
        f"({int(solves['data'][0].iterations[0])} iterations, launches "
        f"{solves['data'][2]['fused_glm']}) vs unsharded "
        f"{solves['unsharded'][1]:.2f} s "
        f"({int(solves['unsharded'][0].iterations[0])}, "
        f"{solves['unsharded'][2]['fused_glm']}); f64 objective relative "
        f"gap {rel:.2e} (limit {OBJECTIVE_RTOL[both]:g}, converged {both}); "
        f"max |coefficient gap| {gap:.3e}; layouts built in {layout_s:.2f} s")
    assert rel <= OBJECTIVE_RTOL[both], rel
    del sharded, cols
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_cli(tmp, small_train, small_valid, device="cuda"):
    """Phase 20 (d): ``train_game --mesh data=1,entity=1`` against the same
    run without ``--mesh`` at SMALL's rows, and ``--mesh data=2`` refused
    on this one card. Returns {part: launches}."""
    from photon_ml_tpu_torch.cli import train_game

    runs = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh",
                                                 "data=1,entity=1"])):
        out = os.path.join(tmp, f"mesh_cli_{name}")
        res, wall, launches = counted_call(train_game.run, cli_args(
            small_train, small_valid, out) + extra + ["--device", device])
        runs[name] = (res, wall, launches, out)
    (r0, w0, l0, o0), (r1, w1, l1, o1) = runs["plain"], runs["mesh"]
    same = same_records(os.path.join(o0, "best"), os.path.join(o1, "best"))
    a0, a1 = r0["best_evaluation"]["AUC"], r1["best_evaluation"]["AUC"]
    log(f"[20d] train_game at {SMALL['rows']} rows: --mesh data=1,entity=1 "
        f"{w1:.2f} s (launches {l1}) vs without {w0:.2f} s (launches {l0}); "
        f"records equal {same}; AUC {a1!r} vs {a0!r}")
    assert same and a0 == a1 and l0 == l1, (same, a0, a1, l0, l1)
    if device != "cuda":
        # on the CPU every slot is the CPU: the refusal needs the card
        return {"d_plain": l0, "d_mesh": l1}
    try:
        train_game.run(cli_args(small_train, small_valid, os.path.join(
            tmp, "mesh_cli_refused")) + ["--mesh", "data=2"])
    except SystemExit as e:
        message = str(e)
    else:
        raise AssertionError("--mesh data=2 was not refused on one card")
    log(f"[20d] --mesh data=2 on {torch.cuda.device_count()} card(s): "
        f"refused: {message!r}")
    assert "needs 2 devices, have 1" in message, message
    return {"d_plain": l0, "d_mesh": l1}


def mesh_index(sm, users, device="cuda"):
    """Phase 20 (e): ``sm``'s perSong index (phase 8's model, f32) spread
    over ``{"entity": 4}`` slots, ranking ``users`` at RANK_KS against the
    unsharded index. It runs inside phase 14's count, so its launches are
    read as the counts' growth across it, none reset. Returns {part:
    launches}."""
    from photon_ml_tpu_torch.parallel.mesh import make_mesh
    from photon_ml_tpu_torch.retrieval import ItemIndex, RankingEngine

    def rank():
        index = ItemIndex.build(sm.stores["perSong"], "perSong",
                                mesh=make_mesh({"entity": MESH_SLOTS},
                                               devices=slots(MESH_SLOTS,
                                                             device)))
        engine = RankingEngine(sm.engine, index, max_k=RANK_MAX_K)
        worst, n = 0.0, 0
        for user in users:
            for k in RANK_KS:
                ((ids0, s0),) = sm.rank([user], [k])
                ((ids1, s1),) = engine.rank([user], [k])
                assert ids1 == ids0, (user["metadataMap"], k)
                worst = max(worst, float(np.abs(s1 - s0).max()))
                n += 1
        return index, engine, worst, n

    counters = kernel_counters()
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    index, engine, worst, n = rank()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    log(f"[20e] perSong index over {{'entity': {MESH_SLOTS}}}: "
        f"{index.n_items} items in a bucket of {index.bucket}, "
        f"{len(index.parts)} parts of {index.bucket // len(index.parts)}; "
        f"{n} rankings ({len(users)} users x k in {RANK_KS}) with ids equal "
        f"to the unsharded index's, max |score gap| {worst:.3e}; captures "
        f"{engine.compile_count}; {wall:.2f} s; launches {launches}")
    assert worst == 0.0, worst
    return {"e": launches}


LINT_TIMEOUT_S = 300


def run_lint_phase(root):
    """Phase 21: the port's lint over the checkout at ``root``, in a
    process of its own; any exit but 0 fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.analysis", root,
         "--json"], cwd=root, capture_output=True, text=True,
        timeout=LINT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-8000:], proc.stderr[-8000:])
        raise RuntimeError(f"[21] the lint exited {proc.returncode}")
    doc = json.loads(proc.stdout)
    counts = doc["counts"]
    assert counts["findings"] == 0, counts
    log(f"[21] python -m photon_ml_tpu_torch.analysis: exit 0 over "
        f"{counts['files']} files, {len(doc['rules'])} rules, "
        f"{counts['suppressed']} suppressions, wall {wall:.2f} s")
    return wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import photon_ml_tpu_torch.game as tg
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.convert import glm_data_from_arrays
    from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_hvp
    from photon_ml_tpu_torch.ops import fused_re
    from photon_ml_tpu_torch.ops import losses as tl
    from photon_ml_tpu_torch import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if "--mp-gap-seeds" in sys.argv:
        seeds = sys.argv[sys.argv.index("--mp-gap-seeds") + 1]
        return mp_gap_seeds([int(v) for v in seeds.split(",")])
    t_start = time.perf_counter()

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    report = cuda_build.build(["fused_glm", "fused_re", "fused_hvp",
                               "fused_glm_multi"])
    log(f"[1] built kernels in {time.perf_counter() - t0:.2f} s "
        + ", ".join(f"{k}: {'cached' if v['cached'] else 'nvcc'}"
                    for k, v in report.items()))

    # data and datasets of the main path (host bucketing) ------------------
    t0 = time.perf_counter()
    train, valid = make_e2e(tg, **E2E)
    log(f"[3] generated e2e data ({E2E}) in {time.perf_counter() - t0:.1f} s")
    est = e2e_estimator(tg, "cuda", E2E_MAX_ITER)
    assert native.available(), "the native library (bucket packer) failed"
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver

    t0 = time.perf_counter()
    warm_walls = {}
    # the threads bind the timed build as they start, inside the block
    with Patched(RandomEffectSolver, "_warm_compile", timed_warm(warm_walls)):
        datasets = est.prepare(train)
    log(f"[3] built coordinate datasets in {time.perf_counter() - t0:.2f} s "
        f"through the native bucket packer, index maps only (the numpy "
        f"packer with host fills took 3.4 s on an NVIDIA H100 80GB HBM3 at "
        f"700 W); the statics, joins and key orders build on a thread a "
        f"coordinate")
    shapes = []
    for cid in ("perUser", "perSong"):
        ds = datasets[cid]
        sh = [b.tensor_shape for b in ds.buckets]
        shapes += sh
        log(f"  {cid}: {ds.n_active_entities} entities, buckets {sh}")
        assert ds.config.cache_device_buckets and ds.source_data is train
        assert not any(b.materialized for b in ds.buckets), cid

    # 2. kernels vs plain versions -----------------------------------------
    losses = [tl.LogisticLoss, tl.SquaredLoss, tl.PoissonLoss,
              tl.SmoothedHingeLoss]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    err1 = check_glm(fused_glm, losses, GLM_CHECK_SHAPES, gen)
    # kernel 1's other bodies draw from their own generator, as the plan
    # paths below do
    err1 = max(err1, check_glm(
        fused_glm, losses, GLM_BODY_SHAPES,
        torch.Generator(device="cuda").manual_seed(8765)))
    e_ragged = shapes[-1][0] + 3 if shapes else 11
    # a ragged E, and rows too wide for 8 row groups' shared memory
    err2 = check_re(fused_re, losses, sorted(set(shapes))
                    + [(e_ragged, 37, 5), (3, 40, 8192)], gen)
    # the plan paths draw from their own generator, so the shared one
    # reaches phase 5 in the same state as before they were added (kernel
    # 3's readings stay comparable from run to run)
    err2 = max(err2, check_re(fused_re, losses, RE_PLAN_SHAPES,
                              torch.Generator(device="cuda").manual_seed(4321)))
    log(f"[2] kernels agree with their plain versions (rtol "
        f"{KERNEL_RTOL}): worst relative error kernel1 {err1:.2e}, kernel2 "
        f"{err2:.2e} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # 3. the main path -----------------------------------------------------
    evaluators = parse_evaluators(["AUC"])
    fused_glm.fused_value_and_grad.launches = 0
    fused_re.fused_entity_value_and_grad.launches = 0
    t0 = time.perf_counter()
    fused_reads = {}
    with Patched(RandomEffectSolver, "train", sweep_reads(fused_reads)):
        result = est.fit(train, [tg.GameOptimizationConfiguration(
            E2E_LAMBDAS)], validation=(valid, evaluators),
            datasets=datasets)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"fused_glm": fused_glm.fused_value_and_grad.launches,
                "fused_re": fused_re.fused_entity_value_and_grad.launches}
    auc = result.evaluation.primary[1]
    log(f"[3] GameEstimator.fit (1 sweep, maxIter={E2E_MAX_ITER}, bf16, "
        f"lambda {E2E_LAMBDAS}) in {fit_s:.2f} s; validation AUC {auc:.6f}")
    for sweep, cid, sec in result.step_seconds:
        log(f"  sweep {sweep} {cid}: {sec:.3f} s")
    log(f"  launches: {launches}; random effects through the fused sweep, "
        f"host reads {fused_reads}; the background builds took "
        + ", ".join(f"{cid} {sec:.3f} s" for cid, sec in
                    sorted(warm_walls.items())))
    assert launches["fused_glm"] > 0 and launches["fused_re"] > 0, launches
    assert set(warm_walls) == {"perUser", "perSong"}, warm_walls
    for cid, m in result.model.coordinates.items():
        c = (m.model.coefficients.means.cpu().numpy()
             if isinstance(m, tg.FixedEffectModel) else m.coeffs)
        assert c.size and np.all(np.isfinite(c)), cid
    fe_only = e2e_estimator(tg, "cuda", E2E_MAX_ITER, ("global",)).fit(
        train, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
        validation=(valid, evaluators),
        datasets={"global": datasets["global"]})[0]
    auc_fe = fe_only.evaluation.primary[1]
    log(f"  fixed-effect-only AUC {auc_fe:.6f}")
    assert auc > auc_fe + 0.01, (auc, auc_fe)
    compare_fused_looped(tg, est, datasets, train, valid, result, evaluators,
                         launches, fused_reads)
    check_compact_buckets(tg, est, datasets, train)
    check_duplicate_rebuild(tg)

    # kernel times at the main path's shapes -------------------------------
    ds = datasets["global"]
    w_game = 0.01 * torch.ones(ds.design.x.shape[1], device="cuda")
    t1 = time_glm(fused_glm, tl.LogisticLoss, ds.design.x, w_game,
                  ds.labels, ds.weights)
    # kernel 3 at the fixed effect's shape, as TRON would run it there (its
    # direction from a generator of its own: the shared one keeps its state)
    t3_game = time_hvp(fused_hvp, ds.design.x, w_game, tl.LogisticLoss,
                       ds.labels, torch.Generator(device="cuda").manual_seed(
                           2468))
    del ds
    # the bucket statics only, not the index maps they were rebuilt from
    buckets = [st for key, st in
               sorted(((k, v) for cid in ("perUser", "perSong")
                       for k, v in datasets[cid]._device_cache.items()
                       if k[0] == "bucket"),
                      key=lambda kv: str(kv[0]))]
    t2 = time_re(fused_re, tl.LogisticLoss, buckets)
    del buckets

    # 20 (a), (b). phase 3's fit over mesh slots ---------------------------
    t0 = time.perf_counter()
    mesh_launches = mesh_fit(tg, est, datasets, train, valid, result,
                             evaluators)
    log(f"[20ab] done in {time.perf_counter() - t0:.1f} s")
    del datasets, train, valid, result, fe_only
    torch.cuda.empty_cache()

    # 4. card vs CPU -------------------------------------------------------
    small, small_valid = make_e2e(tg, **SMALL)
    reach = compare_bucket_solves(tg, small, E2E_LAMBDAS["perUser"])
    fits = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fits[device] = e2e_estimator(tg, device, SMALL_MAX_ITER).fit(
            small, [tg.GameOptimizationConfiguration(E2E_LAMBDAS)],
            validation=(small_valid, evaluators))[0]
        log(f"[4] {SMALL['rows']}-row fit on {device} (maxIter="
            f"{SMALL_MAX_ITER}) in {time.perf_counter() - t0:.2f} s, AUC "
            f"{fits[device].evaluation.primary[1]:.6f}")
    gpu, cpu = fits["cuda"].model, fits["cpu"].model
    # the whole fit: lanes end anywhere within `reach` of their optimum (the
    # solves above), and each coordinate's residual offsets carry the
    # earlier coordinates' such differences — so 2 x reach, absolute
    atol = 2.0 * reach
    for cid in gpu.coordinates:
        a, b = gpu.coordinates[cid], cpu.coordinates[cid]
        if isinstance(a, tg.FixedEffectModel):
            ca = a.model.coefficients.means.cpu().numpy()
            cb = b.model.coefficients.means.numpy()
        else:
            assert np.array_equal(a.keys, b.keys), cid
            ca, cb = a.coeffs, b.coeffs
        diff = float(np.abs(ca - cb).max())
        log(f"  {cid}: max |cuda - cpu| coefficient = {diff:.3e} (limit "
            f"{atol:.3e})")
        assert diff <= atol, (cid, diff, atol)
    d_auc = abs(fits["cuda"].evaluation.primary[1]
                - fits["cpu"].evaluation.primary[1])
    log(f"  |AUC cuda - AUC cpu| = {d_auc:.2e}")
    # a few of the 5k validation rows may swap ranks
    assert d_auc < 1e-4, d_auc
    check_forced_streaming(tg, small, small_valid, fits["cuda"], evaluators)
    del small, small_valid, fits, gpu, cpu
    log(f"[1-4] done at {time.perf_counter() - t_start:.1f} s")

    # 5. kernels 3 and 4 vs plain versions ----------------------------------
    t0 = time.perf_counter()
    err3 = check_hvp(fused_hvp, HVP_CHECK_SHAPES, gen)
    # kernel 3's other bodies draw from their own generator, so kernel 4's
    # cases below keep their seeded draws
    err3b = check_hvp(fused_hvp, HVP_BODY_SHAPES + [
        (3_001, cuda_build.MAX_ROW_WIDTH, (torch.float32,))],
        torch.Generator(device="cuda").manual_seed(5678))
    err3 = {dt: max(err3[dt], err3b[dt]) for dt in err3}
    err4 = check_multi(fused_glm, cuda_build, losses, gen)
    time_one_lane(fused_glm, tl.LogisticLoss, gen)
    log(f"[5] kernels 3 and 4 agree with their plain versions: worst "
        f"relative error kernel3 f32 {err3[torch.float32]:.2e} bf16 "
        f"{err3[torch.bfloat16]:.2e}; kernel4 f32 {err4[torch.float32]:.2e} "
        f"bf16 {err4[torch.bfloat16]:.2e} (rtol {KERNEL_RTOL} f32, "
        f"{BF16_RTOL} bf16); kernel4 vs kernel1 f32 "
        f"{err4['kernel1', torch.float32]:.2e} bf16 "
        f"{err4['kernel1', torch.bfloat16]:.2e} (rtol {KERNEL_RTOL} f32, "
        f"{K4_VS_K1_BF16_RTOL} bf16) "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # 6. the GLM path at full width ----------------------------------------
    t0 = time.perf_counter()
    (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM)
    train = glm_data_from_arrays(x_tr, y_tr)
    valid = glm_data_from_arrays(x_va, y_va)
    del x_tr, x_va
    log(f"[6] generated the GLM data ({GLM}) in "
        f"{time.perf_counter() - t0:.1f} s")
    glm_runs = run_sweeps(train, valid, glm_sweeps())
    grads = {}
    for name, (trained, best, sec, n_launch) in glm_runs.items():
        log(f"[6] {name}:")
        log_sweep(name, trained, best, sec, n_launch)
        for tm in trained:
            c = tm.model.coefficients.means
            assert c.shape == (GLM["dim"],) and bool(torch.isfinite(c).all())
            assert tm.evaluation.primary[1] > 0.5, (name, tm.evaluation)
        grads[name] = check_gradients(name, train, trained)
    glm_launches = {k: v[3] for k, v in glm_runs.items()}
    assert glm_launches["tron"]["fused_glm"] > 0, glm_launches
    assert glm_launches["tron"]["fused_hvp"] > 0, glm_launches
    assert glm_launches["batched"]["fused_glm_multi"] > 0, glm_launches
    hold_to_bound("TRON vs batched L-BFGS", glm_runs["tron"][0],
                  glm_runs["batched"][0], grads["tron"], grads["batched"])

    # kernel times at the GLM path's shape, and their share of each sweep
    x = train.design.x
    w_mid = glm_runs["tron"][0][2].model.coefficients.means
    t1_glm = time_glm(fused_glm, tl.LogisticLoss, x, w_mid, train.labels,
                      torch.ones(x.shape[0], device="cuda"))
    t3 = time_hvp(fused_hvp, x, w_mid, tl.LogisticLoss, train.labels, gen)
    ws = torch.stack(
        [tm.model.coefficients.means for tm in glm_runs["batched"][0]])
    t4 = time_multi(fused_glm, x, ws, tl.LogisticLoss, train.labels)
    time_multi(fused_glm, x.to(torch.bfloat16), ws, tl.LogisticLoss,
               train.labels)
    for name, parts in (("tron", (("fused_glm", t1_glm["ms"]),
                                  ("fused_hvp", t3["ms"]))),
                        ("batched", (("fused_glm_multi", t4["ms"]),))):
        kern_s = sum(glm_launches[name][k] * ms for k, ms in parts) / 1e3
        sec = glm_runs[name][2]
        log(f"  {name} sweep: {sec:.3f} s wall, ~{kern_s:.3f} s of it in "
            f"its kernels (launches x time per launch, "
            f"{100 * kern_s / sec:.1f} %)")
    phase6 = {name: (trained[best].regularization_weight,
                     trained[best].evaluation.primary[1])
              for name, (trained, best, _, _) in glm_runs.items()}

    # 20 (c). the sharded GLM objectives at this shape ---------------------
    t0 = time.perf_counter()
    mesh_launches.update(mesh_glm(train, GLM_LAMBDAS[2]))
    log(f"[20c] done in {time.perf_counter() - t0:.1f} s")
    del train, valid, glm_runs, x, w_mid
    torch.cuda.empty_cache()

    # 7. the GLM sweeps, card vs CPU ----------------------------------------
    # at a tolerance that f32 solves reach: with values ~1.3e4 (an f32 ulp
    # of ~1e-3) TRON's reduction test stalls long before |grad f| reaches
    # 1e-6 of its start, so at phase 6's tolerance no lambda converges and
    # the AUC check below would hold none
    (x_tr, y_tr), (x_va, y_va) = make_glm(**GLM_SMALL, seed=1)
    runs, stats, datas = {}, {}, {}
    sweeps = glm_sweeps(GLM_SMALL_TOLERANCE, batched_tron=True)
    for device in ("cuda", "cpu"):
        datas[device] = glm_data_from_arrays(x_tr, y_tr, device=device)
        t0 = time.perf_counter()
        runs[device] = run_sweeps(
            datas[device], glm_data_from_arrays(x_va, y_va, device=device),
            sweeps)
        log(f"[7] {GLM_SMALL['rows']}x{GLM_SMALL['dim']} sweeps on {device} "
            f"(tolerance {GLM_SMALL_TOLERANCE:g}) in "
            f"{time.perf_counter() - t0:.2f} s")
        for name, (trained, best, sec, n_launch) in runs[device].items():
            log_sweep(f"{device} {name}", trained, best, sec, n_launch)
            stats[device, name] = check_gradients(
                f"{device} {name}", datas[device], trained)
    bt = runs["cuda"]["batched_tron"][3]
    assert bt["fused_glm_multi"] > 0 and bt["fused_hvp"] > 0, bt
    assert runs["cuda"]["tron"][3]["fused_glm"] > 0, runs["cuda"]["tron"][3]
    # kernel 1 at the TRON sweep's shape here, and kernel 3 at batched
    # TRON's, where it launches most
    t1_small = time_glm(fused_glm, tl.LogisticLoss, datas["cuda"].design.x,
                        runs["cuda"]["tron"][0][2].model.coefficients.means,
                        datas["cuda"].labels,
                        torch.ones(GLM_SMALL["rows"], device="cuda"))
    t3_small = time_hvp(fused_hvp, datas["cuda"].design.x,
                        runs["cuda"]["batched_tron"][0][2].model.coefficients
                        .means, tl.LogisticLoss, datas["cuda"].labels, gen)
    worst_f, n_auc, bad = 0.0, 0, []
    for name, _, _ in sweeps:
        hold_to_bound(f"{name} cuda vs cpu", runs["cuda"][name][0],
                      runs["cpu"][name][0], stats["cuda", name],
                      stats["cpu", name])
        for a, b, (fa, _), (fb, _) in zip(
                runs["cuda"][name][0], runs["cpu"][name][0],
                stats["cuda", name], stats["cpu", name]):
            rel_f = abs(fa - fb) / abs(fb)
            worst_f = max(worst_f, rel_f)
            d_auc = abs(a.evaluation.primary[1] - b.evaluation.primary[1])
            both = bool(a.result.converged) and bool(b.result.converged)
            n_auc += both
            log(f"    lambda={a.regularization_weight:g}: converged "
                f"{bool(a.result.converged)}/{bool(b.result.converged)}; f64 "
                f"f(w) relative |cuda - cpu| {rel_f:.3e} (limit "
                f"{OBJECTIVE_RTOL[both]:g}); |AUC cuda - AUC cpu| {d_auc:.2e}"
                + (" (limit 1e-4)" if both else " (not held)"))
            if rel_f > OBJECTIVE_RTOL[both] or (both and d_auc > 1e-4):
                bad.append((name, a.regularization_weight, rel_f, d_auc))
    log(f"[7] card vs CPU: f64 objectives within {worst_f:.3e} relative; "
        f"AUC held to 1e-4 at the {n_auc} lambdas where both devices "
        "converged")
    assert not bad, bad
    assert n_auc > 0, "no lambda converged on both devices"
    # SIMPLE variances at one point, the CPU's TRON solution at lambda 1
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.types import VarianceComputationType

    problem = glm.OptimizationProblem(
        GLMObjective(tl.LogisticLoss), dataclasses.replace(
            glm_configs()[0],
            variance_type=VarianceComputationType.SIMPLE))
    w_cpu = runs["cpu"]["tron"][0][2].model.coefficients.means
    var = {dev: problem.compute_variances(w_cpu.to(dev), datas[dev],
                                          GLM_LAMBDAS[2]).cpu()
           for dev in ("cuda", "cpu")}
    rel_var = float(((var["cuda"] - var["cpu"]).abs()
                     / var["cpu"].abs()).max())
    log(f"  SIMPLE variances at lambda={GLM_LAMBDAS[2]:g}: max relative "
        f"|cuda - cpu| {rel_var:.2e}")
    assert rel_var <= 1e-4, rel_var
    del datas, problem, var
    torch.cuda.empty_cache()

    e2e_tmp = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        # 8. the e2e CLI, Avro in and model directory out -------------------
        cli_launches, e2e_run = run_cli_phase(
            tg, fused_glm, fused_re, auc, auc_fe, e2e_tmp)

        # 9. the GLM command, Avro in and model directory out ---------------
        t0 = time.perf_counter()
        glm_cli, glm_paths = run_glm_cli_phase(
            fused_glm, fused_hvp, fused_re, phase6,
            keep_dir=os.path.join(e2e_tmp, "glm"))
        log(f"[9] done in {time.perf_counter() - t0:.1f} s")

        # 10. scoring phase 8's model: batch, engine, HTTP ------------------
        records = run_scoring_phase(e2e_run)

        # 11. incremental training on phase 8's run -------------------------
        refresh_launches, locked_launches, refresh_run = run_refresh_phase(
            tg, e2e_run, cli_launches, e2e_tmp)

        # 12. the refresh -> serve loop: phase 11 (b)'s patch served --------
        _, _, loop_launches = counted_call(
            run_patch_serving_phase, e2e_run, refresh_run, records, e2e_tmp)
        log(f"[12] kernel launches {loop_launches}")
        assert not any(loop_launches.values()), loop_launches

        # 13. the remaining GAME training options, on phase 8's files -------
        options_launches = run_options_phase(tg, e2e_run, auc_fe, e2e_tmp)

        # 20 (d). train_game --mesh on phase 13's SMALL files --------------
        t0 = time.perf_counter()
        mesh_launches.update(mesh_cli(
            e2e_tmp, os.path.join(e2e_tmp, "small_train.avro"),
            os.path.join(e2e_tmp, "small_valid.avro")))
        log(f"[20d] done in {time.perf_counter() - t0:.1f} s")

        # 14. model quality and ranked retrieval ----------------------------
        (rank_ms, mesh_e), _, quality_launches = counted_call(
            run_quality_phase, e2e_run, refresh_run, records, glm_paths,
            phase6["batched"][0], e2e_tmp)
        mesh_launches.update(mesh_e)
        log(f"[14] kernel launches {quality_launches}; /rank p50 "
            f"{rank_ms[0]:.2f} ms, p99 {rank_ms[1]:.2f} ms")
        assert quality_launches["fused_glm"] > 0, quality_launches
        assert quality_launches["fused_hvp"] > 0, quality_launches
        assert quality_launches["fused_glm_multi"] == 0, quality_launches

        # 15. multi-process training and scoring ----------------------------
        mp_launches = run_multiprocess_phase(
            e2e_run, glm_paths, os.path.join(e2e_tmp, "glm"), phase6,
            e2e_tmp)

        # 16. the entity-sharded serving fleet ------------------------------
        fleet_launches, fleet_walls = run_fleet_phase(e2e_run, records,
                                                      e2e_tmp, card)

        # 17. the live telemetry plane --------------------------------------
        telemetry_launches = run_telemetry_phase(
            tg, e2e_run, cli_launches, os.path.join(e2e_tmp, "glm"),
            glm_paths, records, e2e_tmp)

        # 18. the retained telemetry plane ----------------------------------
        _, _, retained_launches = counted_call(
            run_retained_phase, e2e_run, records, e2e_tmp, card, fleet_walls)
        log(f"[18] kernel launches {retained_launches}")
        assert not any(retained_launches.values()), retained_launches

        # 19. background publication and the closed feedback loop ----------
        loop_launches = run_loop_phase(tg, e2e_run, records, e2e_tmp)
        log(f"[19] kernel launches {loop_launches}")
        assert loop_launches["loop"]["fused_hvp"] == 0
        assert loop_launches["loop"]["fused_glm_multi"] == 0
    finally:
        shutil.rmtree(e2e_tmp, ignore_errors=True)

    def train_glm_launches(kernel):
        return {name: n[kernel] for name, n in glm_cli.items()}

    def options(kernel):
        return {name: n[kernel] for name, n in options_launches.items()}

    def multihost(kernel):
        """Phase 15's launches of ``kernel`` by run, one count a rank."""
        return {name: [n[kernel] for n in ranks]
                for name, ranks in mp_launches.items()}

    def telemetry(kernel):
        """Phase 17's launches of ``kernel``: (a) and (b)."""
        return {name: n[kernel] for name, n in telemetry_launches.items()}

    def loop(kernel):
        """Phase 19's launches of ``kernel``: the faulted train_game of (a)
        and the autopilot's refresh of (b)."""
        return {name: n[kernel] for name, n in loop_launches.items()}

    def mesh(kernel):
        """Phase 20's launches of ``kernel`` by part."""
        return {name: n[kernel] for name, n in mesh_launches.items()}

    log("[20] launches by part: " + "; ".join(
        f"{part} {n}" for part, n in mesh_launches.items()))
    for kernel in ("fused_glm", "fused_re", "fused_hvp"):
        assert sum(mesh(kernel).values()) > 0, (kernel, mesh_launches)

    # 21. the port's lint over the checkout --------------------------------
    run_lint_phase(root)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [
        dict(name="fused_value_and_grad", route="cuda", status="redesigned",
             source="photon_ml_tpu_torch/csrc/fused_glm.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:118",
             launches=launches["fused_glm"], **t1,
             e2e_cli=dict(launches=cli_launches["fused_glm"]),
             refresh=dict(launches=refresh_launches["fused_glm"]),
             locked=dict(launches=locked_launches["fused_glm"]),
             train_glm=dict(launches=train_glm_launches("fused_glm")),
             options=dict(launches=options("fused_glm")),
             quality=dict(launches=quality_launches["fused_glm"]),
             multihost=dict(launches=multihost("fused_glm")),
             fleet=dict(launches=fleet_launches["fused_glm"]),
             telemetry=dict(launches=telemetry("fused_glm")),
             retained=dict(launches=retained_launches["fused_glm"]),
             loop=dict(launches=loop("fused_glm")),
             mesh=dict(launches=mesh("fused_glm")),
             glm_path=dict(launches=glm_launches["tron"]["fused_glm"],
                           **t1_glm),
             glm_small=dict(launches=runs["cuda"]["tron"][3]["fused_glm"],
                            **t1_small)),
        dict(name="fused_entity_value_and_grad", route="cuda",
             status="redesigned",
             source="photon_ml_tpu_torch/csrc/fused_re.cu",
             replaces="photon_ml_tpu/ops/pallas_re.py:130",
             launches=launches["fused_re"], **t2,
             e2e_cli=dict(launches=cli_launches["fused_re"]),
             refresh=dict(launches=refresh_launches["fused_re"]),
             locked=dict(launches=locked_launches["fused_re"]),
             train_glm=dict(launches=train_glm_launches("fused_re")),
             options=dict(launches=options("fused_re")),
             quality=dict(launches=quality_launches["fused_re"]),
             multihost=dict(launches=multihost("fused_re")),
             fleet=dict(launches=fleet_launches["fused_re"]),
             telemetry=dict(launches=telemetry("fused_re")),
             retained=dict(launches=retained_launches["fused_re"]),
             loop=dict(launches=loop("fused_re")),
             mesh=dict(launches=mesh("fused_re"))),
        dict(name="fused_hvp", route="cuda", status="redesigned",
             source="photon_ml_tpu_torch/csrc/fused_hvp.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:447",
             launches=glm_launches["tron"]["fused_hvp"], **t3,
             batched_tron=dict(launches=bt["fused_hvp"], **t3_small),
             game_shape=t3_game,
             train_glm=dict(launches=train_glm_launches("fused_hvp")),
             refresh=dict(launches=refresh_launches["fused_hvp"]),
             locked=dict(launches=locked_launches["fused_hvp"]),
             options=dict(launches=options("fused_hvp")),
             quality=dict(launches=quality_launches["fused_hvp"]),
             multihost=dict(launches=multihost("fused_hvp")),
             fleet=dict(launches=fleet_launches["fused_hvp"]),
             telemetry=dict(launches=telemetry("fused_hvp")),
             retained=dict(launches=retained_launches["fused_hvp"]),
             loop=dict(launches=loop("fused_hvp")),
             mesh=dict(launches=mesh("fused_hvp"))),
        dict(name="fused_value_and_grad_multi", route="cuda",
             status="redesigned",
             source="photon_ml_tpu_torch/csrc/fused_glm_multi.cu",
             replaces="photon_ml_tpu/ops/pallas_glm.py:301",
             launches=glm_launches["batched"]["fused_glm_multi"], **t4,
             train_glm=dict(launches=train_glm_launches("fused_glm_multi")),
             refresh=dict(launches=refresh_launches["fused_glm_multi"]),
             locked=dict(launches=locked_launches["fused_glm_multi"]),
             options=dict(launches=options("fused_glm_multi")),
             quality=dict(launches=quality_launches["fused_glm_multi"]),
             fleet=dict(launches=fleet_launches["fused_glm_multi"]),
             telemetry=dict(launches=telemetry("fused_glm_multi")),
             retained=dict(launches=retained_launches["fused_glm_multi"]),
             loop=dict(launches=loop("fused_glm_multi")),
             mesh=dict(launches=mesh("fused_glm_multi"))),
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
            assert math.isfinite(k[key]), (k["name"], key)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
