#!/usr/bin/env python3
"""Smoke run of the PyTorch port (photon_ml_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the exit
code is non-zero:

1. device  — requires CUDA; the card's name and power limit (nvidia-smi)
             and the torch/CUDA versions.
2. build   — builds every kernel library from photon_ml_torch/csrc/,
             all nvcc processes at once, and beside them csrc/hot_pass.cu
             with HOT_PASS_TIMING_NO_TRANSPOSE for the hybrid phases.
3. kernels — holds serving_score against its plain PyTorch version on
             the card, at the shapes the serving path gives it and at
             the kernel-sweep shape, and times both with CUDA events: on
             the card alone (CUDA-graph replay, "ms") and per call from
             Python ("call_ms"). Beside them, the card's launch floor: one
             one-element Tensor.add_ in the same replay ("launch_floor_us").
4. serve   — the serving path: a config-4 (MovieLens-20M width) GAME
             model from a seed, written with save_game_model and served
             through cli.serve.create_server on port 0, answering
             concurrent HTTP clients; every score is checked against a
             float64 numpy oracle. serving_score's launch count and the
             service metrics are read around the HTTP traffic alone; a
             direct pass around HTTP (with a profiled repeat) comes after
             they are read.
5. train   — the training path: config 4 at full width and MovieLens-20M's
             20,000,263 rows from a seed (5% held out; generated by a
             child process that starts before build and runs beside the
             build, kernels and serve, "generate_seconds" the wait that
             is left), the three
             coordinates built as dev-scripts/flagship_movielens.py
             builds them, and a 2-iteration game.descent.run with the
             validation AUC after each update. The row movers' launch
             counts and the solver's host syncs are read around the
             descent alone and must equal 2 x the bucket waves.
6. kernels — holds re_rows' gather_rows and scatter_rows_ bit for bit
             against their plain versions at every wave shape the train
             phase gave them, on an all-padding wave and at a sweep
             shape, and times kernel, plain version and library call.
   train_resume — train's descent again over its coordinates with a
             CheckpointManager in a temporary directory, killed by a proxy
             that raises on the 5th train_model of 6, then resumed from the
             checkpoint with fresh proxies: the coefficient tables equal
             train's bit for bit, and so does the residual total (train's
             chain replayed from the checkpoint with train's models); the
             first leg's fixed effect equals train's (two descents, the
             same bits); re_rows launches on the resumed leg equal the
             remaining updates' waves; a third run makes no update. Each
             save's seconds and bytes; the dataset digest of the
             checkpoint's fingerprint, timed apart from the killed leg.
   train_bf16 — the same 20M rows with bfloat16 feature storage on the
             fixed effect and both random effects (the reference's
             flagship dtype), one outer iteration (cut, for time):
             descent seconds, peak memory and each update's validation
             AUC beside the float32 run's (within 5e-3), the stored
             dtypes, row-mover launches = the waves.
7. train_parity — the same descent at 300,000 rows (same widths and
             entity counts), one outer iteration (cut, for time), on the
             card and on the CPU in one process. Within 5e-3: the
             validation AUC after each update and the mean validation
             probability of the two runs; and each update of the card's
             run replayed on the CPU from the same offsets and warm
             start, the fixed effect's coefficients and those of every
             random-effect entity the data determines (16+ rows, both
             labels). train_bf16_parity: the same in bfloat16.
   game_cli_train — the GAME CLIs (slice 6 item 5), config 4 at full
             width: 1,000,000 rows from the seed (5% held out; cut from
             2,000,000, for time),
             written as two dataset directories (data/io.py) by a child
             process that starts after serve and runs beside the config-4
             phases (its write seconds, then this process's read
             seconds); game_train through run(build_parser().parse_args())
             with the flagship's three coordinates (L2 1.0, L-BFGS 25,
             1 outer iteration (cut from 2, for time), max_samples
             65,536 on per-user,
             AUC,AUC@userId), --trace-out, --metrics-dump, the ledger and
             checkpoints on; beside it GameEstimator.fit of the same rows
             and configuration. gather_rows = scatter_rows_ launches > 0,
             equal to the trace's re.fit_wave spans and the ledger's
             re_fit_wave rows; the last coordinate_update row's
             validation AUC above the first's; finite coefficients;
             cli/obs verify passes on the trace; summary.json has the
             reference's keys.
   game_cli_score — game_score on that model over the 950,000
             training rows, one-shot and with --batch-rows 262,144 (4
             chunks, the last one short; prefetch depth 2, a copy stream
             and a ring of 3 pinned buffers): the two
             within 1e-6 relative (and whether bit-identical), every score
             within 1e-4 of a float64 CPU oracle, batched peak memory
             under one-shot's and under (depth + 1) × chunk bytes + the
             model's + 64 MB, photon_scoring_rows_total = the rows
             scored; rows/s of each way on the rows in memory and, under
             torch.profiler, the batched copies' time hidden behind
             scoring kernels and the card's busy share. Then (beside
             game_cli_sparse's first fit) `python -m
             photon_ml_torch.cli.game_score` once as its own process
             without --device on the validation rows: on the card, the
             same scores as in this process (game_cli_score_process,
             printed in game_cli_sparse).
8. sparse_train — the config-5 path: Criteo-shaped sparse data from a
             seed (10,000,000 rows, d = 1,000,000, 32 slots, Zipf(1.3)
             columns; 5% held out; generated by a child process that
             starts after serve and runs beside the config-4 phases,
             "generate_seconds" the wait that is left), fitted through
             GameEstimator.fit with
             one ELL sparse fixed effect (hybrid=False, so ell_scatter
             gets all 9.5M training rows; L-BFGS, 60 iterations, L2 1.0)
             and validation AUC; then a TRON fit of the same coordinate.
             ell_rmatvec's launch count is read around each fit alone and
             must equal the solver's objective evaluations (TRON: plus its
             H·v products); scatter_rowterm, which reads (n, k) row terms,
             must not launch there. The staged bytes (batch and layout),
             each fit's peak device memory and one evaluation's
             milliseconds at the L-BFGS fit's final iterate (the ELL side
             of hybrid_bf16_train's layout comparison) are reported.
   sparse_down_sampled — sparse_train's staged ELL coordinate through
             with_optimization_config, down-sampled by the binary
             classification sampler at rate 0.5 (L-BFGS 60), two
             train_model calls: two different subsets, as the
             coordinate's draws return them, ell_rmatvec launches equal to
             each fit's evaluations, validation AUC above 0.5 beside the
             full fit's; the sampled rows, the seconds of the gather and
             the column layout a draw, each fit's peak memory.
9. kernels — holds ell_scatter's two routes against their plain versions
             on the card at the main path's shape (with the fit's own
             residual), at d = 512 and 2048, with uniform ids over d = 1M
             (short columns), bit for bit on integer-valued inputs, on an
             all-padding batch and with one column in every row: each
             column within 1e-5 · Σ|terms| of its exact (float64) sum,
             and the column check shown to reject sums of bfloat16-rounded
             row terms (ell_rmatvec: r rounded); two launches must give
             the same bits. ell_rmatvec (gradient, H·v and diagonal forms)
             must give the bits of scatter_rowterm over the materialised
             r ⊗ values (values²). Times, at the main shape, the generic
             kernel, its plain version and index_add_; ell_rmatvec, the
             old route (the multiply, then scatter_rowterm), its plain
             version and a CSR torch.mv of Xᵀ; and the bytes each route
             allocates a call.
10. stream_train — the row-streamed config-5 fixed effect: the first
             2,500,000 of those training rows (cut, for time) and the
             500,000 validation rows, fitted through
             GameEstimator(streaming=StreamingConfig(...)) in int8 chunks
             of 262,144 rows with 512 hot columns (10 chunks, the last
             one padded), 20 L-BFGS iterations. hot_margins,
             hot_rmatvec and ell_scatter launches are read around the fit
             alone and must equal the chunks times the passes that run
             them; two value-and-gradient passes at the final iterate
             must give the same bits, and one replayed on the CPU over
             the same staged chunks must agree (value within 1e-5
             relative, each gradient column within sparse_parity's
             allowance).
   stream_resume — stream_train's staged int8 coordinate fitted again
             with a bound StreamingStateStore whose save raises after
             iteration 10 of 20, then resumed from the store: stream_train's
             coefficients bit for bit; hot_margins, hot_rmatvec and
             scatter_rowterm launches on the resumed leg equal the chunks
             times its passes; each save's seconds and the state's bytes.
11. kernels — holds hot_margins and hot_rmatvec against their plain
             versions on the card at the streamed chunk (int8, and
             dequantised to float32 and bfloat16), on the padded tail
             chunk, at a ragged shape and bit for bit on integer inputs:
             each output within 1e-5 · Σ|terms| of its exact (float64)
             value, parity_rel within 1e-3, the same bits on two
             launches. Times kernel, plain version and library call(s)
             at the streamed chunk. Every float32 block on the route its
             shape picks (stream_fused.route): the main chunk and a
             1,003-row block (no multiple of a tile or of 512) on the
             ring, the main chunk copied 4 bytes off 16-byte alignment
             (hot_margins bit for bit the ring's), the ragged shape and a
             2,048 x 8,196 block direct; int8 and bfloat16 direct.
12. hybrid_train — config 5's one-device default, the hybrid hot/cold
             layout: the first 4,750,000 of those training rows (2,000,000
             where the host or the card cannot hold what staging needs;
             the reckoning is printed first) and the same validation rows,
             through GameEstimator.fit with a default
             FixedEffectDataConfiguration (L-BFGS, 60 iterations, L2 1.0).
             Staging is split into host layout, device fill and the cold
             scatter's layout. Launches are read around the fit alone:
             hot_value_and_gradient (one pass over the hot block an
             evaluation), cold_grad (one launch a pass over every class)
             and ell_scatter (plus the descent's two scoring passes) equal
             the evaluations; hot_margins runs only for those two scoring
             passes, hot_rmatvec and hot_hessian_vector not at all. At the
             fit's final iterate (and a direction from the seed) the
             fused passes hold z, the value and x·v bit for bit the
             two-kernel route's, every hot gradient column within 1e-5 ·
             Σ|terms| of its float64 sum, parity_rel within 1e-3 against
             the plain version, and the same bits on two launches; they
             are timed against the two- and three-kernel routes they
             replace, the plain versions and the library calls, with the
             tile ring's depth and the pass without its transposed
             product beside them.
             Then the same rows on the ELL layout in the same process
             (ell_rmatvec launches equal to its evaluations):
             milliseconds per evaluation of each layout and both AUCs. At
             the hybrid fit's final iterate the two objectives must agree
             (value within 1e-5 relative, each gradient column within
             sparse_parity's allowance), and two hybrid value-and-gradient
             passes must give the same bits.
13. kernels — holds cold_grad against its plain version on the card on
             every class of the main shape with the fit's own residual
             (all classes in one launch through cold_grad_classes, and
             each class alone through cold_grad), with squared values, on
             an all-padding class, on an L = 1 class and bit for bit on
             integer inputs: each column within 1e-5 · Σ|terms| of its
             exact (float64) sum, the check shown to reject
             bfloat16-rounded inputs, the same bits on two launches.
             Times kernel, plain version and a CSR torch.mv (per call from
             Python, and its device time from torch.profiler) over all
             classes of a gradient pass, and each class alone beside its
             bound.
   hybrid_bf16_train — config 5's default layout in bfloat16 at all
             9.5M training rows (not cut): a reckoning first (hot
             columns at the n/4096 threshold, block bytes, cold slots,
             the card's free memory; the phase fails where the block
             cannot fit), then GameEstimator.fit with
             FixedEffectDataConfiguration(feature_dtype="bfloat16"),
             L-BFGS 60, L2 1.0: staging (host layout, device fill, cold
             layout), block bytes, peak memory, ms an evaluation beside
             sparse_train's ELL evaluation at the same rows, the solve,
             both AUCs, hot_value_and_gradient launches = evaluations,
             two passes the same bits. The bfloat16 entry of hot_pass at
             this block (z and xv bit for bit stream_fused.hot_margins'
             route, each hot gradient column within 1e-5 · Σ|terms| of
             its float64 sum over the same rounded operands plus one
             bfloat16 step of r where r sits within its own resolution of
             a rounding midpoint, parity_rel within 1e-3 against the
             plain version over 65,536-row blocks, two launches the same
             bits), timed against the two- and three-kernel routes, the
             library route (torch.mm with a float32 output) and the
             plain version, beside its bound; both passes also at ring
             shapes 8x2, 8x4 and 4x4 and without their transposed
             product. Then a 5-iteration TRON solve on the staged block
             (sparse_problem.run_hybrid; no second staging): its seconds,
             hot_hessian_vector launches = H·v products, and its
             objective beside the L-BFGS fit's.
   stream_bf16_train — stream_train in bfloat16 chunks (X_hot and
             cold_vals) over the first 2,359,296 training rows (9 chunks;
             cut, for time): GB/s and bytes a pass, launches = chunks ×
             passes, two passes the same bits, the CPU replay, AUC.
14. sparse_parity — the same fit at 300,000 rows on the card and on the
             CPU in one process: every coefficient within 5e-3 after 10
             iterations; every objective evaluation of the card's
             60-iteration fit replayed on the CPU from the same iterate
             (value within 1e-5 relative, each gradient column within
             1e-5 of its Σ|r·x| plus 2^-21 of its Σ w·|x|, the row
             terms' own float32 resolution); and the 60-iteration fits'
             validation AUC within 5e-3 (their coefficients are
             reported; the CPU's own refit over reversed rows, which
             measured that spread, is left out for time).
   game_cli_sparse — config 5 through game_train from LIBSVM: those
             300,000 rows, written by the CLI data child as LIBSVM text
             (one-based, %.9g: every float32 exact) and read back there
             through game_train's own _load_dataset (for the API fits;
             each CLI run reads the files itself), row for row
             sparse_parity's;
             20 L-BFGS iterations, L2 1.0, with hybrid=auto
             (hot_value_and_gradient and cold_grad launches = gradient
             evaluations), hybrid=false (ell_rmatvec launches = gradient
             evaluations) and --streaming chunk_rows=65536,num_hot=512,
             dtype=int8 --trace-out (hot_margins and hot_rmatvec launch;
             cli/obs verify passes on the streamed trace). Each CLI fit's
             coefficients bit for bit GameEstimator.fit's with the same
             configuration over the dataset _load_dataset returns, with
             the same launches. game_cli_score_process runs beside
             the first fit.
15. stream_parity — those 300,000 rows streamed on the card in 65,536-row
             chunks, two of them pinned: float32 coefficients within
             5e-3 of the resident fit's after 10 iterations, every
             streamed evaluation replayed on the CPU, and int8 storage's
             validation AUC within 5e-3 of float32's after 20 iterations.
             hot_margins and hot_rmatvec launches read around the two
             float32 fits alone equal the chunks times their passes, all
             on the ring route.
16. hybrid_parity — those 300,000 rows in the hybrid layout on the card
             and on the CPU: every coefficient within 5e-3 after 10
             iterations, every card evaluation of that fit replayed on the
             CPU (sparse_parity's limits), and 5 TRON iterations on the
             card: hot_value_and_gradient launches equal to its gradient
             evaluations, hot_hessian_vector's to its H·v products,
             cold_grad's to both, and hot_rmatvec none.
   hybrid_bf16_parity — the same with a bfloat16 hot block.
   down_sampling_parity — down-sampled fits (rate 0.5, one seed, so the
             same subsets) on the card and on the CPU, 10 iterations:
             config 4's fixed effect at 300,000 rows and sparse_parity's
             rows on ELL and in the float32 hybrid layout; coefficients
             within 5e-3, ell_rmatvec launches equal to the ELL fit's
             evaluations, hot_value_and_gradient's and cold_grad's to the
             hybrid fit's, hot_hessian_vector's 0 on that L-BFGS fit.
17. glm_train — the GLM driver path, BASELINE configs 1–3, at the public
             datasets' shapes from seed 2026 (the datasets are not
             fetched). Config 1, logistic L-BFGS with L2 on a1a_like at
             a1a's shape (1,605 training rows, a1a.t's 30,956 validation
             rows, 123 binary features, ±1 labels), through the CLI
             (cli.train_glm) on LIBSVM files that write_libsvm writes, with
             a 3-point L2 grid, which must take the run_grid path. Config
             2, linear TRON with L2, and config 3, Poisson OWL-QN with L1
             and an offset column, at YearPredictionMSD's shape (90
             features, 463,715 training and 51,630 validation rows),
             through optim.problem.run; and each through the CLI (no
             offset) on LIBSVM files of the 51,630-row split. Every fit
             runs on the card and on the CPU (the CLI's MSD runs on the
             card only): the largest coefficient gap within 5e-3, finite
             metrics, AUC above 0.5, RMSE below the constant predictor's,
             and a saved model that load_glm reads back bit for bit. Fit
             seconds (synchronised), iterations, the solver's host syncs,
             the card's busy share under torch.profiler, peak memory, and
             the time split of a fit (parse, stage, solve, evaluate). One
             3-lane grid evaluation at MSD's shape must not copy X.
18. glm_gradient_step — BASELINE metric 1 at bench.py's
             bench_gradient_step shape (n = 2^19, d = 256, float32,
             logistic, X and y from np.random.default_rng(0)):
             ops.aggregators.value_and_gradient on the chain
             w ← w − 1e-9·g, timed with CUDA events as the slope between
             20 and 220 steps (minimum of 5 each); samples/s and the share
             of the two-read bound (X read twice at 3.35 TB/s); and its
             bfloat16 variant (bench.py:227–231, the same X rounded to
             bfloat16), which must allocate no float32 copy of X.

Observability (photon_ml_torch.obs) rides on phases that already run,
each with an "obs" line after its own ("on" names it); a failed check
raises:
   serve   — config (a) once more through cli.serve with --trace-out and
             --metrics-dump (written at shutdown as run writes them):
             serving.request spans = requests, serving.flush spans =
             flushes, each request's four stage spans summing to it
             within 1 µs, summarize --serving's p50 within 5% of the
             service's histogram's, the registry's lines on /metrics,
             photon_scoring_rows_total = the rows the service scored,
             serving_score two launches a flush. Then config (a)'s
             traffic through one more server, a warm round with tracing
             off and one with it on, then sixteen rounds in the order
             (u t t u) × 4: the p50 of all traced requests within
             OBS_SERVE_P50_RATIO of that of all untraced ones.
   sparse_train — the L-BFGS fit with GameEstimator(trace=, ledger_dir=,
             watchdog=): one estimator.fit root span, post-fit opt_iter
             rows = iterations + 1, a clean ledger closed "ok".
   train_resume — both legs traced, with a metrics registry and one run
             ledger (the killed leg leaves its flushed rows and no
             run_end): the ledger verifies, one run id, contiguous seq,
             one closing run_end, 6 coordinate_update rows; per leg,
             descent.update spans = updates started, re.fit_wave spans =
             waves, checkpoint.save spans = photon_checkpoint_writes_total
             = saves; cli/obs verify passes on the resumed leg's trace;
             its solver host syncs equal those of train's untraced
             updates 5-6.
   stream_resume — both legs traced, one ledger, the default watchdog
             armed: one live opt_iter row per accepted iteration of each
             leg (the resumed leg appending after the killed one),
             lbfgs.iteration, stream.pass and stream.chunk_transfer spans
             = iterations, passes and chunks × passes, cli/obs verify
             clean on the resumed leg's trace (each copy span, which
             times its enqueue and carries its device seconds, nested in
             its pass), the int8 transfer bytes = bytes moved, the
             in-flight peak ≤ 2, stream
             checkpoint writes = saves, no watchdog row, summarize's
             transfer share; a value-and-gradient pass traced against
             untraced, the medians of sixteen passes in turns after a
             warm one of each, within OBS_PASS_RATIO.

   sparse_re_train — the reference's flagship sparse random effect
             (dev-scripts/flagship_sparse_re.py: d = 1,000,000, 16-column
             pools an entity, 8 nonzeros a row, seed 7; rows and entities
             as SPARSE_RE_ROWS/SPARSE_RE_ENTITIES, made by a child process
             started before build) through RandomEffectCoordinate: a
             reckoning line first (the staged blocks' bytes), then cold
             staging into a staging cache under a tracer and a registry
             (the staging span, photon_staging_shards_total), a first and
             a steady train_model plus score, each under torch.profiler
             (the card's busy share) with re_rows' launches = waves =
             re.fit_wave spans, the AUC against the labels (bar 0.9), a
             SubspaceRandomEffectModel with no (E, d) table, peak memory;
             a second coordinate re-staged from the cache (every shard a
             hit, the waves bit for bit the cold ones), a third after two
             shards' commit markers were deleted (exactly those restage,
             the same bits), and the row movers held bit for bit at the
             subspace table's wave shape.
   sparse_re_parity — the same path at 300,000 rows and 30,000 entities
             on the card and on the CPU: staged waves bit-equal,
             coefficients within PARITY_TOL, one model's scores through
             both within 1e-5, AUCs within PARITY_TOL, launches = waves;
             then a dense projected coordinate (an intercept,
             STANDARDIZATION, features_to_samples_ratio 0.5) with its
             variances, card against CPU.

The phases run in the order of the main path's data: train, its
kernels, train_resume, train_bf16, the train parities, game_cli_train
and game_cli_score, sparse_train, its kernels, sparse_down_sampled,
stream_train, its kernels, stream_resume, hybrid_train, cold_grad's
kernels, hybrid_bf16_train, stream_bf16_train, then the sparse parity,
game_cli_sparse, the stream, hybrid, hybrid_bf16 and down-sampling
parities, the GLM phases, and the sparse random-effect phases. Each line
carries the seconds since the start ("at_seconds"); a "script" line after
the last phase gives the total and each line's seconds since the one
before it.

Then it prints the kernel table ({"kernels": [...]}; the hybrid block's
fused pass as hot_value_and_gradient and hot_hessian_vector, its
bfloat16 entry as hot_value_and_gradient_bf16 and
hot_hessian_vector_bf16), nvidia-smi's
"name, power.limit" line, and as its last line
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# queued_ms's spin ahead of the calls it times (about 5 ms at the H100's
# clocks).
QUEUE_SPIN_CYCLES = 10_000_000

# Config 4 at full width (dev-scripts/flagship_movielens.py: MovieLens-20M
# users and movies, d_global = 32, d_re = 8).
D_GLOBAL = 32
D_RE = 8
NUM_USERS = 138_493
NUM_ITEMS = 27_278
ZIPF_SKEW = 1.2
UNSEEN_FRAC = 0.02
SEED = 2026

# Config-4 training (dev-scripts/flagship_movielens.py): MovieLens-20M's
# rating count with 5% held out, L2 weight 1.0, 25 L-BFGS iterations,
# and at most 65,536 active rows per entity (numActiveDataPointsUpperBound).
TRAIN_ROWS = 20_000_263
PARITY_ROWS = 300_000
UPPER_BOUND = 65_536
DESCENT_ITERATIONS = 2
PARITY_TOL = 5e-3
# Random-effect entities with at least this many training rows (and both
# labels) have coefficients the data determines; train_parity holds those.
WELL_DETERMINED_ROWS = 16
SEQ = ["fixed", "per-user", "per-item"]

# Config 5 (BASELINE "Criteo-1TB CTR: 1M-feature sparse GAME logistic",
# in memory, fixed effect only): bench.py's bench_sparse width (d = 1M,
# 32 slots, data/sparse.synthetic_sparse's Zipf(1.3) columns) at the
# in-memory row scale of bench_host_staging (10M rows), fitted as
# examples/sparse_criteo_style.py fits it: L-BFGS, 60 iterations,
# tolerance 1e-7, L2 1.0.
SPARSE_ROWS = 10_000_000
SPARSE_DIM = 1_000_000
SPARSE_NNZ = 32
SPARSE_PARITY_ROWS = 300_000
SPARSE_ITERATIONS = 60
# TRON's outer iterations: each runs up to 20 CG steps, one H·v apiece.
TRON_ITERATIONS = 20
# sparse_parity holds every coefficient over this many iterations, before
# the card's and the CPU's line searches part (see phase_sparse_parity).
PARITY_EARLY_ITERATIONS = 10
# The docs/KERNELS.md gate: max |kernel − plain| / max |plain|.
PARITY_REL = 1e-3
# Each column on its own: the kernel's float32 sum may differ from the
# column's exact sum (the plain version in float64) by COLUMN_TOL ·
# Σ|terms| of that column (≈ 84 float32 epsilons; the form the
# serving_score check uses). A column of one entry must then match bit for
# bit, which a kernel that read its row terms in bfloat16 (2^-9 relative)
# could not; every real-valued fixture shows that it fails. The exact sum,
# not the float32 plain version, is the yardstick, because at the main
# shape the plain version's own error on the Zipf head (9.5M atomic adds in
# a varying order) is a third of this allowance and changes run to run.
COLUMN_TOL = 1e-5
# sparse_parity replays every card evaluation of the full fit on the CPU
# from the same iterate: the objective value within this relative gap, and
# each gradient column within COLUMN_TOL · Σ_i |r_i · x_ic| plus
# REPLAY_ROW_ABS · Σ_i w_i · |x_ic|. The second term is the row terms'
# own resolution: r_i = w_i · (σ(z_i) − y_i) comes from a float32
# probability, whose steps near 1 are 2^-24 apart. Margins that differ in
# their last bits (another summation order) and the card's and the CPU's
# sigmoid can land it a few steps apart (two, over reversed rows and
# slots on the CPU); where σ(z) is within 1e-4 of the label, one step is
# 6e-4 of r_i. The allowance is eight steps.
REPLAY_VALUE_RTOL = 1e-5
REPLAY_ROW_ABS = 2.0 ** -21

# The row-streamed config-5 fixed effect: the reference's StreamingConfig
# defaults (262,144-row chunks, 512 hot columns, two device buffers) with
# the flagship's int8 storage, 20 L-BFGS iterations over sparse_train's
# rows (37 chunks, the last one padded); stream_parity streams
# sparse_parity's rows in 65,536-row chunks, two of them pinned.
STREAM_CHUNK_ROWS = 262_144
STREAM_NUM_HOT = 512
STREAM_ITERATIONS = 20
STREAM_PARITY_CHUNK_ROWS = 65_536
# stream_fused outputs: each within TERM_TOL · Σ|terms| of its exact
# (float64) value, the serving_score check's form.
TERM_TOL = 1e-5

# The hybrid hot/cold layout, config 5's one-device default: the first
# HYBRID_ROWS of sparse_train's training rows. Its float32 hot block grows
# with the rows at ~1,800 columns (the default threshold is rows/2048):
# 68 GB at all 9.5M rows, which the 80 GB card cannot hold beside the rest,
# 34 GB at 4.75M. Where the host or the card cannot hold what staging
# needs, HYBRID_ROWS_CUT (a 14 GB block). Width, slots and skew are not cut.
HYBRID_ROWS = 4_750_000
HYBRID_ROWS_CUT = 2_000_000
# hybrid_parity's TRON run on the card.
TRON_PARITY_ITERATIONS = 5
# hybrid_bf16_train's TRON solve on the staged 9.5M-row bfloat16 block.
TRON_BF16_ITERATIONS = 5
# The int8 stream_train streams the first STREAM_ROWS training rows (10
# chunks, the last one padded); stream_bf16_train the first
# STREAM_BF16_ROWS (9 whole chunks). Both are cut for the script's time.
STREAM_ROWS = 2_500_000
STREAM_BF16_ROWS = 9 * STREAM_CHUNK_ROWS
# bfloat16 storage (the reference's flagship dtype): hybrid_bf16_train
# stages all of sparse_train's 9.5M training rows in the hybrid layout's
# bfloat16 hot block (n/4096 threshold, about 57 GB); its kernel checks
# sum the block in float64 over blocks of this many rows.
BF16_CHECK_ROWS = 65_536
# train_bf16 and both train parities run this many outer iterations
# (train runs DESCENT_ITERATIONS); cut for the script's time.
BF16_DESCENT_ITERATIONS = 1
PARITY_DESCENT_ITERATIONS = 1

# BASELINE configs 1-3 at the public datasets' shapes (not fetched):
# a1a (123 binary features, 1,605 training rows and a1a.t's 30,956
# validation rows) and YearPredictionMSD (90 features, 463,715 training and
# 51,630 validation rows). The CLI's MSD runs read LIBSVM files of the
# 51,630-row split, 80% to train on.
A1A_TRAIN = 1_605
A1A_VAL = 30_956
A1A_DIM = 123
A1A_GRID = "0.1,1,10"
MSD_TRAIN = 463_715
MSD_VAL = 51_630
MSD_DIM = 90
GLM_MAX_ITERATIONS = 100
GLM_TOLERANCE = 1e-7
MSD_L2 = 1.0
# Config 3's L1 weights sit near twice the noise features' gradient at
# zero (√(n·E[y]) ≈ 1,000 at 463,715 rows, ≈ 300 at the CLI's 41,304), so
# OWL-QN zeroes most of the 80 features the planted model leaves out.
MSD_L1 = 2000.0
MSD_CLI_L1 = 600.0
# A grid evaluation may allocate its (L, n) vectors, never a copy of X.
GRID_LANES = 3
GRID_PROFILED = 20
# bench.py's bench_gradient_step: n = 2^19, d = 256, float32 logistic; the
# slope between 20 and 220 chained steps, the minimum of 5 runs of each.
STEP_ROWS = 1 << 19
STEP_DIM = 256
STEP_SHORT = 20
STEP_LONG = 220
STEP_RUNS = 5
# Down-sampling and resume: the binary classification sampler's rate
# (examples/sparse_criteo_style.py's negative down-sampling), the update
# of train's 6 at which train_resume's first leg is killed, and the
# iteration of stream_train's 20 after which stream_resume's is.
DOWN_SAMPLING_RATE = 0.5
TRAIN_KILL_AT = 5
STREAM_KILL_AFTER = 10
# Observability's bars on the card: a traced streamed value-and-gradient
# pass against an untraced one (in turns, at the same iterate), and the
# traced serving request p50 against the untraced one (in turns, on one
# server).
OBS_PASS_RATIO = 1.05
OBS_SERVE_P50_RATIO = 1.10


_T0 = time.perf_counter()


_LINES: list = []  # (phase, at_seconds) of every line printed


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    at = time.perf_counter() - _T0
    _LINES.append((phase, at))
    print(json.dumps({"phase": phase, **fields, "at_seconds": at}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, reps: int = 21, inner: int = 50) -> float:
    """Per-call time of ``inner`` back-to-back calls from Python, median
    over ``reps`` CUDA-event windows (warm): what a caller pays, host
    launch overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_ms(torch, fn, reps: int = 21, inner: int = 100) -> float:
    """Per-call time on the card: ``inner`` calls captured once in a CUDA
    graph and replayed, median over ``reps`` CUDA-event windows. The
    host's launch overhead is out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def queued_ms(torch, fn, calls: int = 10, reps: int = 11) -> float:
    """Per-call time on the card of a call that a CUDA graph cannot
    capture: CUDA events around ``calls`` back-to-back calls, enqueued
    while the card spins (``torch.cuda._sleep``), so the host's own time
    per call is out of the window; median over ``reps``. Fails where the
    host took longer to enqueue the calls than the card spun."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if host_ms >= spin.elapsed_time(start):
            raise AssertionError(
                f"queued_ms: the host took {host_ms} ms to enqueue {calls} "
                f"calls, longer than the card's {spin.elapsed_time(start)} "
                f"ms spin")
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


# -- kernels ---------------------------------------------------------------

def _score_inputs(torch, rng, n, d, E, dtype):
    """Inputs at one shape. int8: integer features and power-of-two
    scales, so every partial sum is exact and kernel == plain bit for
    bit. The last row is the fallback row (zeros, scale 0). Slots mix
    in-range rows, the fallback row and out-of-range ids on both sides."""
    import numpy as np

    if dtype == "int8":
        mat = rng.integers(-4, 5, (n, d)).astype(np.float32)
        cache = rng.integers(-127, 128, (E, d)).astype(np.int8)
        scale = (2.0 ** rng.integers(-12, 3, E)).astype(np.float32)
        scale[E - 1] = 0.0
    else:
        mat = rng.normal(size=(n, d)).astype(np.float32)
        cache = rng.normal(size=(E, d)).astype(np.float32)
        scale = None
    cache[E - 1] = 0
    slots = rng.integers(0, E, n).astype(np.int32)
    slots[1::5] = E - 1
    slots[2::7] = E + 3
    slots[3::11] = -2
    dev = torch.device("cuda")
    put = (lambda a: None if a is None else torch.from_numpy(a).to(dev))
    return put(mat), put(slots), put(cache), put(scale)


def check_serving_score(torch, ss, rng, n, d, E, dtype) -> dict:
    mat, slots, cache, scale = _score_inputs(torch, rng, n, d, E, dtype)
    got = ss.score_rows(mat, slots, cache, scale)
    want = ss.score_rows_reference(mat, slots, cache, scale)
    torch.cuda.synchronize()
    s = torch.clamp(slots.long(), 0, E - 1)
    err = float((got - want).abs().max())
    if dtype == "int8":
        if not torch.equal(got, want):
            raise AssertionError(f"serving_score int8 n={n} d={d}: not "
                                 f"bit-exact (max |err| {err})")
    else:
        # A float32 sum's rounding error scales with the sum of its
        # terms' magnitudes, whatever the order of summation.
        mag = (mat * cache[s]).abs().sum(dim=1)
        bad = (got - want).abs() > 1e-5 * mag + 1e-30
        if bool(bad.any()):
            raise AssertionError(f"serving_score f32 n={n} d={d}: error "
                                 f"{err} beyond 1e-5 of sum |terms|")
    if bool((got[s == E - 1] != 0).any()):
        raise AssertionError("fallback-row scores are not exactly 0")
    kernel = (lambda: ss.score_rows(mat, slots, cache, scale))
    plain = (lambda: ss.score_rows_reference(mat, slots, cache, scale))
    # Bytes the call must move: features, each referenced cache row (and
    # its scale) once, slots, outputs. Its 2·n·d flops at the f32 rate.
    uniq = int(torch.unique(s).numel())
    b_cache = 1 if dtype == "int8" else 4
    nbytes = n * d * 4 + uniq * d * b_cache + n * 4 + n * 4 \
        + (uniq * 4 if scale is not None else 0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * n * d / PEAK_F32_FLOP_PER_S * 1e3
    return {"n": n, "d": d, "E": E, "cache": dtype, "max_abs_err": err,
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain),
            "call_ms": call_ms(torch, kernel),
            "plain_call_ms": call_ms(torch, plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def phase_kernels(torch, np) -> list[dict]:
    from photon_ml_torch.ops.kernels import serving_score as ss

    rng = np.random.default_rng(SEED)
    buckets = [2 ** k for k in range(7)]  # 1 … 64, the serving buckets
    # Cache rows (entities + the fallback row) each serve config gives
    # the kernel: a and c a 4096-entity f32 cache; b int8 caches holding
    # the whole userId and itemId tables.
    shapes = [("float32", 4097), ("int8", 4097),
              ("int8", NUM_USERS + 1), ("int8", NUM_ITEMS + 1)]
    rows = [check_serving_score(torch, ss, rng, n, D_RE, E, dtype)
            for dtype, E in shapes for n in buckets]
    for dtype in ("float32", "int8"):
        # The kernel-sweep shape (bench.py's kernel sweep).
        rows.append(check_serving_score(torch, ss, rng, 4096, 512, 8192,
                                        dtype))
    emit("kernels", kernel="serving_score", checks=len(rows),
         max_abs_err=max(r["max_abs_err"] for r in rows),
         within_tolerance=True)
    return rows


def launch_floor_us(torch) -> float:
    """The card's launch floor: one launch of a one-element
    Tensor.add_, in device_ms's CUDA-graph replay, in microseconds."""
    one = torch.zeros(1, device="cuda")
    floor = device_ms(torch, lambda: one.add_(1.0)) * 1e3
    emit("kernels", kernel="launch_floor", launch_floor_us=floor)
    return floor


# -- serve -----------------------------------------------------------------

def make_model(np, torch, rng):
    from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.types import TaskType

    w = (rng.normal(size=D_GLOBAL) * 0.5).astype(np.float32)
    W_u = (rng.normal(size=(NUM_USERS, D_RE)) * 0.7).astype(np.float32)
    W_i = (rng.normal(size=(NUM_ITEMS, D_RE)) * 0.7).astype(np.float32)
    model = GameModel(task=TaskType.LOGISTIC_REGRESSION, models={
        "fixed": FixedEffectModel("global",
                                  Coefficients(torch.from_numpy(w))),
        "per-user": RandomEffectModel("userId", "re_userId",
                                      torch.from_numpy(W_u)),
        "per-item": RandomEffectModel("itemId", "re_itemId",
                                      torch.from_numpy(W_i)),
    })
    return model, (w, W_u, W_i)


def make_traffic(np, rng, count: int) -> dict:
    """Requests with Zipf(1.2) user and item ids and 2% unseen ids."""
    def ids(E):
        p = 1.0 / np.arange(1, E + 1) ** ZIPF_SKEW
        e = rng.choice(E, size=count, p=p / p.sum()).astype(np.int64)
        unseen = rng.random(count) < UNSEEN_FRAC
        e[unseen] = E + rng.integers(0, 1000, int(unseen.sum()))
        return e

    return {"x_g": rng.normal(size=(count, D_GLOBAL)).astype(np.float32),
            "x_u": rng.normal(size=(count, D_RE)).astype(np.float32),
            "x_i": rng.normal(size=(count, D_RE)).astype(np.float32),
            "u": ids(NUM_USERS), "i": ids(NUM_ITEMS),
            "offset": (rng.normal(size=count) * 0.1).astype(np.float32)}


def oracle(np, traffic, tables, int8: bool):
    """float64 scores and per-request tolerances: 1e-4 for f32 caches;
    for int8, the per-row quantisation bound Σ|x|·scale/2 on top."""
    w, W_u, W_i = (t.astype(np.float64) for t in tables)
    score = traffic["offset"].astype(np.float64) \
        + traffic["x_g"].astype(np.float64) @ w
    tol = np.full(score.shape, 1e-4)
    for key, ids, W in (("x_u", traffic["u"], W_u),
                        ("x_i", traffic["i"], W_i)):
        x = traffic[key].astype(np.float64)
        seen = ids < W.shape[0]
        rows = np.where(seen[:, None], W[np.minimum(ids, W.shape[0] - 1)],
                        0.0)
        score += np.einsum("nd,nd->n", x, rows)
        if int8:
            row_scale = np.abs(rows).max(axis=1) / 127.0
            tol += np.abs(x).sum(axis=1) * row_scale / 2
    return score, tol


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def direct_pass(np, torch, svc, traffic, want, tol, label) -> dict:
    """The same traffic through the service's flush path with no HTTP
    threads in the process: per-flush assemble and device walls, then
    the same pass again under torch.profiler for the card's busy time
    (kernels and copies) against the pass's wall."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_torch.serving import ScoringRequest

    count = traffic["u"].shape[0]
    reqs = [ScoringRequest(
        features={"global": traffic["x_g"][k], "re_userId": traffic["x_u"][k],
                  "re_itemId": traffic["x_i"][k]},
        entity_ids={"userId": int(traffic["u"][k]),
                    "itemId": int(traffic["i"][k])},
        offset=float(traffic["offset"][k])) for k in range(count)]
    chunks = [reqs[i:i + svc.max_batch]
              for i in range(0, count, svc.max_batch)]
    assemble, device, got = [], [], []
    for chunk in chunks:
        out, (t_a0, t_d0, t_d1) = svc._score_chunk(chunk)
        got.append(out)
        assemble.append((t_d0 - t_a0) * 1e3)
        device.append((t_d1 - t_d0) * 1e3)
    got = np.concatenate(got)
    if not np.all(np.abs(got - want) <= tol):
        raise AssertionError(f"{label}: direct scores disagree with the "
                             "oracle")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for chunk in chunks:
            svc._score_chunk(chunk)
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in device_events(prof))
    return {"direct_flushes": len(chunks),
            "direct_assemble_p50_ms": float(np.median(assemble)),
            "direct_device_p50_ms": float(np.median(device)),
            "direct_rows_per_s": count / (sum(assemble) + sum(device))
            * 1e3,
            "profiled_device_busy_us_per_flush": busy_us / len(chunks),
            "profiled_device_busy_share": busy_us * 1e-6 / wall}


def serve_config(np, torch, ss, label, model_dir, extra, traffic, want,
                 tol, clients=4, per_post=4) -> dict:
    """One server configuration through cli.serve: ``extra`` arguments,
    the traffic over HTTP, the scores against the oracle. With
    ``--trace-out``/``--metrics-dump`` among them, observability is on
    for the session as cli.serve.run turns it on, and both files are
    written at shutdown as run writes them."""
    from photon_ml_torch import obs
    from photon_ml_torch.cli import serve

    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--port", "0", "--device", "cuda",
         *extra])
    traced = bool(args.trace_out or args.metrics_dump)
    if traced:
        obs.enable(trace=bool(args.trace_out), metrics=True)
    try:
        return _serve_config(np, torch, ss, serve, args, label, traffic,
                             want, tol, clients, per_post)
    finally:
        if traced:
            obs.disable()


def _serve_config(np, torch, ss, serve, args, label, traffic, want, tol,
                  clients, per_post) -> dict:
    server, svc = serve.create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for st in svc.store.random:
            if st.cache.device.type != "cuda" or (
                    st.cache_scale is not None
                    and st.cache_scale.device.type != "cuda"):
                raise AssertionError(f"{label}: cache of {st.cid} is not "
                                     "on the card")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        count = traffic["u"].shape[0]

        def body(lo, hi):
            return {"requests": [{
                "features": {"global": traffic["x_g"][k].tolist(),
                             "re_userId": traffic["x_u"][k].tolist(),
                             "re_itemId": traffic["x_i"][k].tolist()},
                "entity_ids": {"userId": int(traffic["u"][k]),
                               "itemId": int(traffic["i"][k])},
                "offset": float(traffic["offset"][k]), "uid": k}
                for k in range(lo, hi)]}

        ss.score_rows.launches = 0  # this config's main-path run starts
        warm = _post(url + "/score", body(0, 1))  # first flush: cold
        got = np.full(count, np.nan)
        got[0] = warm["scores"][0]
        posts = [(lo, min(lo + per_post, count))
                 for lo in range(1, count, per_post)]
        latencies = []
        lat_lock = threading.Lock()

        def client(chunk):
            for lo, hi in chunk:
                t0 = time.perf_counter()
                resp = _post(url + "/score", body(lo, hi))
                dt = time.perf_counter() - t0
                with lat_lock:
                    latencies.append(dt)
                    got[lo:hi] = resp["scores"]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            futures = [pool.submit(client, posts[c::clients])
                       for c in range(clients)]
            for f in futures:
                f.result()
        wall = time.perf_counter() - t0
        # The main path's counts end here: the direct pass below goes
        # around HTTP and the batcher, and is kept out of them.
        launches = ss.score_rows.launches
        snap = svc.metrics.snapshot()
        err = np.abs(got - want)
        if not np.all(err <= tol):
            k = int(np.argmax(err - tol))
            raise AssertionError(
                f"{label}: score {got[k]} vs oracle {want[k]} "
                f"(|err| {err[k]}, tolerance {tol[k]}) at request {k}")
        if launches < 2 * snap["batches_total"]:
            raise AssertionError(
                f"{label}: serving_score launched {launches} times for "
                f"{snap['batches_total']} flushes of two RE coordinates")
        metrics = _get(url + "/metrics").decode()
        if "photon_serving_rows_total" not in metrics:
            raise AssertionError(f"{label}: /metrics lacks rows_total")
        health = json.loads(_get(url + "/healthz"))
        if health.get("status") != "ok":
            raise AssertionError(f"{label}: /healthz said {health}")
        direct = direct_pass(np, torch, svc, traffic, want, tol, label)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=30)
        if args.trace_out or args.metrics_dump:
            serve._dump_observability(svc, args.trace_out,
                                      args.metrics_dump)
    lat_ms = np.asarray(latencies) * 1e3
    return {"config": label, "requests": count, "posts": len(posts) + 1,
            "clients": clients, "flushes": snap["batches_total"],
            "launches": launches,
            "batch_fill_ratio": snap["batch_fill_ratio"],
            "max_abs_err": float(err.max()),
            "post_p50_ms": float(np.percentile(lat_ms, 50)),
            "post_p99_ms": float(np.percentile(lat_ms, 99)),
            "rows_per_s": (count - 1) / wall,
            "request_p50_ms": snap["request_latency"]["p50_ms"],
            "request_p99_ms": snap["request_latency"]["p99_ms"],
            "flush_device_p50_ms": snap["batch_latency"]["p50_ms"],
            "stage_ms_mean": {
                k: v / snap["stage_requests_total"] * 1e3
                for k, v in snap["stage_seconds_total"].items()},
            "re_cache": snap["re_cache"], **direct,
            "rows_served": svc.metrics.rows_total,
            "metrics_text": metrics}


def phase_serve(np, torch, card: str) -> tuple[int, int]:
    from photon_ml_torch.models import io as model_io
    from photon_ml_torch.ops.kernels import serving_score as ss

    rng = np.random.default_rng(SEED)
    model, tables = make_model(np, torch, rng)
    traffic = make_traffic(np, rng, 641)
    want32, tol32 = oracle(np, traffic, tables, int8=False)
    want8, tol8 = oracle(np, traffic, tables, int8=True)
    mean_traffic = {k: v[:129] for k, v in traffic.items()}
    want_mean = 1.0 / (1.0 + np.exp(-want32[:129]))
    configs = [
        ("a: defaults (cache 4096, float32, max_batch 64)", [], traffic,
         want32, tol32),
        ("b: whole tables resident, int8",
         ["--cache-entities", str(NUM_USERS), "--cache-dtype", "int8"],
         traffic, want8, tol8),
        ("c: defaults, --as-mean", ["--as-mean"], mean_traffic, want_mean,
         tol32[:129]),
    ]
    with tempfile.TemporaryDirectory(prefix="photon-chip-smoke-") as tmp:
        model_dir = os.path.join(tmp, "model")
        model_io.save_game_model(model, model_dir)
        launches = flushes = 0
        for label, extra, tr, want, tol in configs:
            out = serve_config(np, torch, ss, label, model_dir, extra, tr,
                               want, tol)
            out.pop("metrics_text")
            launches += out["launches"]
            flushes += out["flushes"]
            emit("serve", card=card, **out)
            if label.startswith("a:"):
                untraced = out
        # Config (a) traced through cli.serve's --trace-out and
        # --metrics-dump, checked against the service's own counts.
        files = {"--trace-out": os.path.join(tmp, "serve-trace.json"),
                 "--metrics-dump": os.path.join(tmp, "serve-metrics.prom")}
        traced = serve_config(np, torch, ss, "a, traced", model_dir,
                              [a for kv in files.items() for a in kv],
                              traffic, want32, tol32)
        turns = overhead_turns(np, model_dir, traffic)
        check_serve_trace(card, files, traced, untraced, turns)
    return launches, flushes


def overhead_turns(np, model_dir, traffic, device="cuda", clients=4,
                   per_post=4, order="uttu" * 32, parts=4) -> dict:
    """Config (a)'s traffic through one cli.serve server, in rounds with
    tracing off (u) and on (t, a fresh tracer and registry), in the
    order given, after one warm round of each: the service's own latency
    of each request (its attribution's total_ms), each round's p50, and
    the p50 of all traced requests over that of all untraced ones.

    The traffic is cut into ``parts`` slices; rounds 2k and 2k + 1 send
    slice k mod ``parts``, so with order (u t t u)... each slice goes out
    as often traced as not. A round lasts a fraction of a second and its
    p50 moves by milliseconds with how the clients' posts fall into
    flushes and with any stall of the host: many short rounds in a
    balanced order, pooled, hold the comparison to the tracing's own
    cost."""
    from photon_ml_torch import obs
    from photon_ml_torch.cli import serve

    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--port", "0", "--device", device])
    server, svc = serve.create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/score"
    count = traffic["u"].shape[0]

    def body(lo, hi):
        return {"trace": True, "requests": [{
            "features": {"global": traffic["x_g"][k].tolist(),
                         "re_userId": traffic["x_u"][k].tolist(),
                         "re_itemId": traffic["x_i"][k].tolist()},
            "entity_ids": {"userId": int(traffic["u"][k]),
                           "itemId": int(traffic["i"][k])},
            "offset": float(traffic["offset"][k])}
            for k in range(lo, hi)]}

    def one_round(turn: str, part: int) -> list:
        totals, lock = [], threading.Lock()
        start, stop = part * count // parts, (part + 1) * count // parts
        posts = [(lo, min(lo + per_post, stop))
                 for lo in range(start, stop, per_post)]

        def client(chunk):
            for lo, hi in chunk:
                resp = _post(url, body(lo, hi))
                with lock:
                    totals.extend(a["total_ms"]
                                  for a in resp["attribution"])

        with contextlib.ExitStack() as stack:
            if turn == "t":
                stack.enter_context(obs.activated(obs.Tracer(),
                                                  obs.MetricsRegistry()))
            with ThreadPoolExecutor(clients) as pool:
                for f in [pool.submit(client, posts[c::clients])
                          for c in range(clients)]:
                    f.result()
        return totals

    totals = {"u": [], "t": []}
    p50 = {"u": [], "t": []}
    try:
        for turn in "ut":  # warm both paths on this server
            for part in range(parts):
                one_round(turn, part)
        for k, turn in enumerate(order):
            got = one_round(turn, k // 2 % parts)
            totals[turn].extend(got)
            p50[turn].append(float(np.percentile(got, 50)))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=30)
    pooled = {k: float(np.percentile(v, 50)) for k, v in totals.items()}
    return {"order": order, "untraced_p50_ms": p50["u"],
            "traced_p50_ms": p50["t"],
            "pooled_p50_ms": {"untraced": pooled["u"],
                              "traced": pooled["t"]},
            "ratio": pooled["t"] / pooled["u"]}


def check_serve_trace(card: str, files: dict, traced: dict,
                      untraced: dict, turns: dict) -> None:
    """The traced serving session's trace and metrics dump against the
    service's own counts: one serving.request span a request, one
    serving.flush span a flush, four stage spans summing to each request
    span within 1 µs, summarize --serving's p50 within 5% of the
    service's histogram's, the registry's lines on /metrics; and the
    traced requests' p50 against the untraced ones' in turns on one
    server (bar: OBS_SERVE_P50_RATIO)."""
    from photon_ml_torch import obs
    from photon_ml_torch.cli import obs as obs_cli

    trace = obs_cli.load_trace(files["--trace-out"])
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    counts = span_counts(trace)
    requests = [e for e in spans if e["name"] == "serving.request"]
    stages: dict = {}
    for e in spans:
        if e["name"] in ("serving.queue_wait", "serving.assemble",
                         "serving.device_score", "serving.respond"):
            stages.setdefault(e["args"]["parent_id"], []).append(e["dur"])
    worst_gap_us = max(abs(sum(stages.get(e["args"]["span_id"], []))
                           - e["dur"]) for e in requests)
    summary = obs_cli.summarize_serving(trace)
    own_p50 = traced["request_p50_ms"]
    metrics_text = traced.pop("metrics_text")
    dumped = obs.parse_prometheus_text(
        open(files["--metrics-dump"]).read())
    failures = []
    if len(requests) != traced["requests"]:
        failures.append(f"{len(requests)} serving.request spans for "
                        f"{traced['requests']} requests")
    if counts.get("serving.flush", {}).get("spans") != traced["flushes"]:
        failures.append(f"{counts.get('serving.flush')} serving.flush "
                        f"spans for {traced['flushes']} flushes")
    if any(len(stages.get(e["args"]["span_id"], [])) != 4
           for e in requests) or worst_gap_us > 1.0:
        failures.append(f"stage spans sum to their request within "
                        f"{worst_gap_us} us")
    if abs(summary["request_latency_ms"]["p50"] - own_p50) > 0.05 * own_p50:
        failures.append(f"summarize p50 {summary['request_latency_ms']} "
                        f"against the service's {own_p50}")
    if 'photon_boot_seconds{phase="total"}' not in metrics_text \
            or 'photon_boot_seconds{phase="total"}' not in dumped:
        failures.append("/metrics or the dump lacks the registry's lines")
    scored = obs.metric_value(dumped, "photon_scoring_rows_total")
    if scored != traced["rows_served"]:
        failures.append(f"photon_scoring_rows_total {scored} for "
                        f"{traced['rows_served']} rows served")
    if traced["launches"] != 2 * traced["flushes"] \
            or untraced["launches"] != 2 * untraced["flushes"]:
        failures.append("serving_score launches are not two a flush")
    if turns["ratio"] > OBS_SERVE_P50_RATIO:
        failures.append(f"traced request p50 {turns} above "
                        f"{OBS_SERVE_P50_RATIO} of the untraced one")
    if failures:
        raise AssertionError("obs serve: " + "; ".join(failures))
    emit("obs", on="serve", card=card, requests=len(requests),
         flushes=traced["flushes"], launches=traced["launches"],
         spans={k: v["spans"] for k, v in counts.items()},
         stage_sum_worst_gap_us=worst_gap_us,
         summarize_p50_ms=summary["request_latency_ms"]["p50"],
         request_p50_ms={"traced": own_p50,
                         "untraced": untraced["request_p50_ms"]},
         request_p99_ms={"traced": traced["request_p99_ms"],
                         "untraced": untraced["request_p99_ms"]},
         post_p50_ms={"traced": traced["post_p50_ms"],
                      "untraced": untraced["post_p50_ms"]},
         turns=turns, p50_ratio=turns["ratio"], boot=summary.get("boot"),
         scoring_rows_total=scored, rows_served=traced["rows_served"])


# -- train -----------------------------------------------------------------

def synthetic_train(np, rows: int):
    """Config 4's ``rows`` at full width from the seed."""
    from photon_ml_torch.data import synthetic

    return synthetic.game_data(
        np.random.default_rng(SEED), n=rows, d_global=D_GLOBAL,
        re_specs={"userId": (NUM_USERS, D_RE), "itemId": (NUM_ITEMS, D_RE)},
        task="logistic")


def make_train_data(np, rows: int, syn=None):
    """Config-4 data at full width from the seed, the last 5% held out
    for validation (as the flagship does). ``syn``: the rows already
    generated (collect_train_data), else they are made here."""
    from photon_ml_torch.data.game_data import from_synthetic

    ds = from_synthetic(syn if syn is not None else
                        synthetic_train(np, rows))
    n_val = max(rows // 20, 1)
    return (ds.subset(np.arange(rows - n_val)),
            ds.subset(np.arange(rows - n_val, rows)))


# Config 4's 20M rows are the longest host generation left on the path,
# so a child process makes them while the kernels build and serve runs:
# the same function and seed, so the same bits (send_arrays' format).
_TRAIN_CHILD = """\
import os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
syn = cs.synthetic_train(np, int(sys.argv[1]))
cs.send_arrays(np, sys.stdout.buffer, {
    "response": syn.response, "offsets": syn.offsets,
    "weights": syn.weights, "X_global": syn.X_global,
    **{"X_entity/" + k: v for k, v in syn.X_entity.items()},
    **{"entity_ids/" + k: v for k, v in syn.entity_ids.items()}})
"""


def send_arrays(np, out, arrays: dict) -> None:
    """Named numpy arrays down a binary stream: one JSON line (each
    array's name, dtype and shape), then their bytes in that order."""
    out.write((json.dumps([[k, a.dtype.str, list(a.shape)]
                           for k, a in arrays.items()]) + "\n").encode())
    for a in arrays.values():
        view = memoryview(np.ascontiguousarray(a)).cast("B")
        # One write(2) moves at most 2 GiB less a page; X_global is larger.
        for lo in range(0, len(view), 1 << 28):
            out.write(view[lo:lo + (1 << 28)])
    out.flush()


def receive_arrays(np, proc) -> dict:
    """The arrays a child process sent with send_arrays, each read from
    its pipe into place."""
    arrays = {}
    for name, dtype, shape in json.loads(proc.stdout.readline()):
        a = np.empty(shape, np.dtype(dtype))
        read_into(proc, a, name)
        arrays[name] = a
    return arrays


def start_child(code: str, *args):
    """A child Python process running ``code`` with ``args`` from the
    script's directory, its (binary) standard output piped back; stopped
    at exit if still running."""
    proc = subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            cwd=ROOT, stdout=subprocess.PIPE)

    def stop():
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.wait()

    atexit.register(stop)
    return proc


def read_into(proc, a, what: str):
    """Fill ``a`` from the child's standard output."""
    view, got = memoryview(a).cast("B"), 0
    while got < len(view):
        n = proc.stdout.readinto(view[got:])
        if not n:
            raise RuntimeError(f"the data child stopped after {got} bytes "
                               f"of {what} (exit {proc.wait()})")
        got += n


def start_train_data(rows: int):
    """Start generating config 4's ``rows`` in a child process;
    collect_train_data takes its arrays."""
    return start_child(_TRAIN_CHILD, rows)


def collect_train_data(np, proc):
    """The child's SyntheticGameData."""
    from photon_ml_torch.data import synthetic

    fields: dict = {"X_entity": {}, "entity_ids": {}}
    for name, a in receive_arrays(np, proc).items():
        group, _, key = name.partition("/")
        if key:
            fields[group][key] = a
        else:
            fields[group] = a
    if proc.wait() != 0:
        raise RuntimeError(f"the config-4 generator exited {proc.returncode}")
    return synthetic.SyntheticGameData(
        num_entities={"userId": NUM_USERS, "itemId": NUM_ITEMS}, **fields)


def build_coordinates(np, torch, train, device: str,
                      feature_dtype: str = "float32",
                      iterations: int = 25):
    """The three coordinates as the flagship builds them (L-BFGS
    ``iterations``), features stored in ``feature_dtype``, and each one's
    staging seconds (bucketing and the copies onto the device)."""
    from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                                  RandomEffectCoordinate)
    from photon_ml_torch.ops import losses
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)

    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))

    def random_effect(re_type):
        return RandomEffectCoordinate(
            train, re_type, f"re_{re_type}", losses.LOGISTIC, cfg,
            upper_bound=UPPER_BOUND, rng=np.random.default_rng(0),
            feature_dtype=feature_dtype, device=device)

    builders = (
        ("fixed", lambda: FixedEffectCoordinate(
            train, "global", losses.LOGISTIC, cfg,
            feature_dtype=feature_dtype, device=device)),
        ("per-user", lambda: random_effect("userId")),
        ("per-item", lambda: random_effect("itemId")))
    coords, seconds = {}, {}
    for cid, build in builders:
        t0 = time.perf_counter()
        coords[cid] = build()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[cid] = time.perf_counter() - t0
    return coords, seconds


def run_descent(torch, coords, val, device: str,
                iterations: int = DESCENT_ITERATIONS):
    """``iterations`` outer iterations over SEQ, with the validation AUC
    after each update; returns (model, history, seconds)."""
    from photon_ml_torch.evaluation.evaluators import auc
    from photon_ml_torch.game import descent
    from photon_ml_torch.optim import lbfgs
    from photon_ml_torch.types import TaskType

    y_val = torch.as_tensor(val.response, device=device)
    syncs: list = []

    def validation(model):
        # The solver's host syncs so far, read after each update (a
        # counter on the host: reading it syncs nothing).
        syncs.append(lbfgs.minimize.host_syncs)
        return {"auc": float(auc(model.score(val), y_val))}

    t0 = time.perf_counter()
    model, history = descent.run(
        TaskType.LOGISTIC_REGRESSION, coords,
        descent.CoordinateDescentConfig(SEQ, iterations=iterations),
        validation_fn=validation)
    history.host_syncs = syncs
    return model, history, time.perf_counter() - t0


def coefficient_tables(model) -> dict:
    return {"fixed": model.models["fixed"].coefficients.means,
            "per-user": model.models["per-user"].means,
            "per-item": model.models["per-item"].means}


def phase_train(np, torch, card: str, generator) -> dict:
    from photon_ml_torch.ops.kernels import re_rows as rr
    from photon_ml_torch.optim import lbfgs

    t0 = time.perf_counter()
    train, val = make_train_data(np, TRAIN_ROWS,
                                 collect_train_data(np, generator))
    generate_s = time.perf_counter() - t0
    coords, staging_s = build_coordinates(np, torch, train, "cuda")
    waves = {cid: coords[cid].num_waves for cid in SEQ[1:]}
    torch.cuda.reset_peak_memory_stats()
    rr.gather_rows.launches = 0  # the training path's run starts
    rr.scatter_rows_.launches = 0
    lbfgs.minimize.host_syncs = 0
    model, history, descent_s = run_descent(torch, coords, val, "cuda")
    gathers = rr.gather_rows.launches  # ... and ends here
    scatters = rr.scatter_rows_.launches
    syncs = lbfgs.minimize.host_syncs
    peak = torch.cuda.max_memory_allocated()
    expected = DESCENT_ITERATIONS * sum(waves.values())
    if gathers != expected or scatters != expected:
        raise AssertionError(
            f"train: {gathers} gathers and {scatters} scatters launched, "
            f"expected {expected} each ({waves} waves x "
            f"{DESCENT_ITERATIONS} iterations)")
    for cid, table in coefficient_tables(model).items():
        if table.device.type != "cuda" or not bool(
                torch.isfinite(table).all()):
            raise AssertionError(f"train: {cid} coefficients are not "
                                 "finite, or not on the card")
    aucs = [r["validation"]["auc"] for r in history.records]
    if not aucs[-1] > aucs[0]:
        raise AssertionError(f"train: final validation AUC {aucs[-1]} is "
                             f"not above the fixed-effect-only {aucs[0]}")
    emit("train", card=card, rows=train.num_rows, val_rows=val.num_rows,
         generate_seconds=generate_s, staging_seconds=staging_s,
         waves=waves,
         buckets={cid: [[b.capacity, b.num_entities]
                        for b in coords[cid].bucketing.buckets]
                  for cid in SEQ[1:]},
         updates=[{"iteration": r["iteration"],
                   "coordinate": r["coordinate"],
                   "train_seconds": r["train_seconds"],
                   "auc": r["validation"]["auc"]} for r in history.records],
         descent_seconds=descent_s,
         launches={"gather_rows": gathers, "scatter_rows_": scatters},
         solver_host_syncs=syncs, max_memory_allocated=peak)
    return {"coords": coords, "model": model, "gathers": gathers,
            "scatters": scatters, "train": train, "val": val,
            "aucs": aucs, "max_memory_allocated": peak,
            "descent_seconds": descent_s,
            "update_syncs": history.host_syncs}


def phase_train_bf16(np, torch, card: str, train, val, f32: dict) -> dict:
    """Config 4 with bfloat16 feature storage (the reference's flagship
    dtype) on the fixed effect and both random effects: train's rows,
    BF16_DESCENT_ITERATIONS outer iteration(s), beside train's float32
    run after as many updates."""
    from photon_ml_torch.data.batch import LabeledBatch
    from photon_ml_torch.ops import aggregators as agg
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops.kernels import re_rows as rr

    coords, staging_s = build_coordinates(np, torch, train, "cuda",
                                          "bfloat16")
    waves = {cid: coords[cid].num_waves for cid in SEQ[1:]}
    torch.cuda.reset_peak_memory_stats()
    rr.gather_rows.launches = 0  # the bfloat16 training run starts
    rr.scatter_rows_.launches = 0
    model, history, descent_s = run_descent(
        torch, coords, val, "cuda", BF16_DESCENT_ITERATIONS)
    launches = {"gather_rows": rr.gather_rows.launches,  # ... and ends
                "scatter_rows_": rr.scatter_rows_.launches}
    peak = torch.cuda.max_memory_allocated()
    expected = BF16_DESCENT_ITERATIONS * sum(waves.values())
    stored = {"fixed": coords["fixed"]._staged.features.dtype,
              **{cid: coords[cid]._waves[0].X.dtype for cid in SEQ[1:]}}
    aucs = [r["validation"]["auc"] for r in history.records]
    f32_aucs = f32["aucs"][:len(aucs)]
    # One evaluation over the largest per-user wave, its bfloat16 block
    # against a float32 copy of it: what the storage costs a solve step.
    wave = max(coords["per-user"]._waves, key=lambda x: x.X.numel())
    w0 = torch.full((wave.X.shape[0], wave.X.shape[2]), 0.01, device="cuda")
    wave_ms = {"shape": list(wave.X.shape)}
    for label, X in (("bfloat16", wave.X), ("float32", wave.X.float())):
        batch = LabeledBatch(X, wave.y, wave.w, torch.zeros_like(wave.y))

        def evaluation():
            return agg.value_and_gradient(losses.LOGISTIC, w0, batch)

        wave_ms[label] = {
            "ms": device_ms(torch, evaluation, reps=5, inner=10),
            "call_ms": call_ms(torch, evaluation, reps=5, inner=10)}
    del X, batch
    auc_diff = float(np.max(np.abs(np.subtract(aucs, f32_aucs))))
    emit("train_bf16", card=card, rows=train.num_rows,
         val_rows=val.num_rows, feature_dtype="bfloat16",
         stored={k: str(v) for k, v in stored.items()},
         iterations=BF16_DESCENT_ITERATIONS, staging_seconds=staging_s,
         updates=[{"iteration": r["iteration"],
                   "coordinate": r["coordinate"],
                   "train_seconds": r["train_seconds"],
                   "auc": r["validation"]["auc"]} for r in history.records],
         descent_seconds=descent_s, auc=aucs, float32_auc=f32_aucs,
         max_auc_diff=auc_diff, launches=launches,
         max_memory_allocated=peak,
         float32_max_memory_allocated=f32["max_memory_allocated"],
         wave_evaluation=wave_ms,
         tolerance=PARITY_TOL)
    for cid, table in coefficient_tables(model).items():
        if table.device.type != "cuda" or table.dtype != torch.float32 \
                or not bool(torch.isfinite(table).all()):
            raise AssertionError(f"train_bf16: {cid} coefficients are not "
                                 "finite float32 on the card")
    if set(stored.values()) != {torch.bfloat16} \
            or launches != {"gather_rows": expected,
                            "scatter_rows_": expected} \
            or not auc_diff <= PARITY_TOL:
        raise AssertionError(
            f"train_bf16: stored {stored}, launches {launches} (expected "
            f"{expected} each), AUC {aucs} against float32's {f32_aucs}")
    del coords, model
    return {"launches": launches}


# -- re_rows kernels -------------------------------------------------------

def check_re_rows(torch, rr, W, rows, label: str, timed: bool) -> dict:
    """gather_rows and scatter_rows_ against their plain versions, bit
    for bit, on one wave; with ``timed``, the times of kernel, plain
    version and library call too."""
    B, d, E = int(rows.shape[0]), int(W.shape[1]), int(W.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(B * 31 + E)
    vals = torch.randn((B, d), generator=gen, device="cuda")
    if not torch.equal(rr.gather_rows(W, rows),
                       rr.gather_rows_reference(W, rows)):
        raise AssertionError(f"gather_rows {label} B={B}: not bit-exact")
    got, want = W.clone(), W.clone()
    ptr = got.data_ptr()
    out = rr.scatter_rows_(got, rows, vals)
    rr.scatter_rows_reference(want, rows, vals)
    torch.cuda.synchronize()
    if out.data_ptr() != ptr or not torch.equal(got, want):
        raise AssertionError(f"scatter_rows_ {label} B={B}: not bit-exact "
                             "or not in place")
    valid_mask = rows >= 0
    valid = int(valid_mask.sum())
    row = {"wave": label, "B": B, "d": d, "E": E, "valid": valid,
           "max_abs_err": 0.0}
    if not timed:
        return row
    clamped = rows.clamp(min=0).long()
    idx, vals_valid = rows[valid_mask].long(), vals[valid_mask]

    def bound(nbytes):
        return nbytes / PEAK_BYTES_PER_S * 1e3

    # Bytes each call must move: every lane's row read and written (the
    # gather) or each valid lane's (the scatter), and the B ids.
    row["gather"] = {
        "ms": device_ms(torch, lambda: rr.gather_rows(W, rows)),
        "call_ms": call_ms(torch, lambda: rr.gather_rows(W, rows)),
        "plain_ms": device_ms(torch,
                              lambda: rr.gather_rows_reference(W, rows)),
        "plain_call_ms": call_ms(torch,
                                 lambda: rr.gather_rows_reference(W, rows)),
        "library_ms": device_ms(torch,
                                lambda: torch.index_select(W, 0, clamped)),
        "bound_ms": bound(2 * B * d * 4 + B * 4), "bound_by": "bytes"}
    # The plain scatter compacts its valid lanes with a device read, so
    # it cannot be captured in a graph: its time is per call only.
    row["scatter"] = {
        "ms": device_ms(torch, lambda: rr.scatter_rows_(got, rows, vals)),
        "call_ms": call_ms(torch, lambda: rr.scatter_rows_(got, rows, vals)),
        "plain_ms": None,
        "plain_call_ms": call_ms(
            torch, lambda: rr.scatter_rows_reference(got, rows, vals)),
        # With no valid lane the library call launches nothing to time.
        "library_ms": device_ms(
            torch, lambda: got.index_copy_(0, idx, vals_valid))
        if valid else None,
        "bound_ms": bound(2 * valid * d * 4 + B * 4), "bound_by": "bytes"}
    return row


def phase_re_rows(np, torch, trained: dict) -> list[dict]:
    from photon_ml_torch.ops.kernels import re_rows as rr

    rows_out = []
    for cid in SEQ[1:]:
        W = trained["model"].models[cid].means.contiguous()
        seen = set()
        for k, rows in enumerate(trained["coords"][cid].wave_rows):
            B = int(rows.shape[0])
            rows_out.append(check_re_rows(torch, rr, W, rows,
                                          f"{cid} wave {k}", B not in seen))
            seen.add(B)
        # An all-padding wave: the gather reads row 0, the scatter writes
        # nothing.
        pad = torch.full((4096,), -1, dtype=torch.int32, device="cuda")
        rows_out.append(check_re_rows(torch, rr, W, pad,
                                      f"{cid} all-padding", True))
    # The sweep shape: 8,192 lanes of a 65,536 x 512 table, 10% padding.
    rng = np.random.default_rng(SEED)
    W = torch.from_numpy(rng.normal(size=(65536, 512)).astype(
        np.float32)).cuda()
    ids = rng.permutation(65536)[:8192].astype(np.int32)
    ids[rng.random(8192) < 0.1] = -1
    rows_out.append(check_re_rows(torch, rr, W, torch.from_numpy(ids).cuda(),
                                  "sweep", True))
    timed = [r for r in rows_out if "gather" in r]
    emit("kernels", kernel="re_rows", checks=len(rows_out),
         bit_exact=True, timed_shapes=len(timed), shapes=timed)
    return rows_out


# -- train_parity ----------------------------------------------------------

class RecordedCoordinate:
    """A coordinate whose train_model calls are recorded: the offsets,
    the warm start and the trained model of each update."""

    def __init__(self, coord):
        self.coord = coord
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def train_model(self, offsets, initial=None):
        model = self.coord.train_model(offsets, initial=initial)
        self.calls.append((offsets.cpu(), initial, model))
        return model


def well_determined(np, coord):
    """(E,) entities whose coefficients the data pins down: at least
    WELL_DETERMINED_ROWS training rows, with both labels. At 300,000 rows
    most entities have one to three rows, and their intercept (not
    regularized, as in the reference) is not pinned where those rows are,
    or given the offsets look, separable: the solver drives it towards
    ±inf until max_iterations and stops at a point set by the last bits
    of every step. Two CPU runs that differ only in their thread count
    disagree on those entities as much as cuda and cpu do."""
    out = np.zeros(coord.num_entities, bool)
    y = coord.dataset.response
    for b in coord.bucketing.buckets:
        live = b.example_idx >= 0
        lab = y[np.maximum(b.example_idx, 0)]
        mixed = (live & (lab > 0.5)).any(1) & (live & (lab < 0.5)).any(1)
        ok = (b.entity_rows >= 0) & mixed & (b.counts >= WELL_DETERMINED_ROWS)
        out[b.entity_rows[ok]] = True
    return out


def bf16_step(np, a, b):
    """The bfloat16 step (one unit in the last place) of each model's
    largest coefficient: per row of a table, over the whole of a
    vector (the larger of a's and b's)."""
    top = np.max(np.maximum(np.abs(a), np.abs(b)), axis=-1, keepdims=True)
    _, exp = np.frexp(top)
    return np.ldexp(1.0, exp - 8)


def compare_update(np, coord, got, want, bf16: bool = False) -> dict:
    """Largest coefficient difference of one update: over the whole
    table ("all") and over what the check holds ("held"): the fixed
    effect in full, a random effect's well-determined entities; and the
    largest share of each coefficient's allowance ("held_ratio"):
    PARITY_TOL, plus under bfloat16 storage one bfloat16 step of the
    model's (the entity's) largest coefficient: the objective sees the
    coefficients only through their bfloat16 rounding, so every margin
    moves in steps of that size, and the other coefficients of the model
    settle wherever those steps leave them (ROADMAP §C)."""
    if hasattr(got, "coefficients"):
        a = got.coefficients.means.cpu().numpy()
        b = want.coefficients.means.cpu().numpy()
        held = np.ones(a.shape[0], bool)
    else:
        a, b = got.means.cpu().numpy(), want.means.cpu().numpy()
        held = well_determined(np, coord)
    diff = np.abs(a - b)
    allowed = PARITY_TOL + (bf16_step(np, a, b) if bf16 else 0.0)
    out = {"all": float(diff.max()), "held": float(diff[held].max()),
           "held_ratio": float((diff / allowed)[held].max())}
    if a.ndim > 1:
        out.update(held_entities=int(held.sum()),
                   trained_entities=int(
                       coord.bucketing.trained_entities.sum()))
    return out


def phase_train_parity(np, torch, card: str, train, val,
                       feature_dtype: str = "float32",
                       phase: str = "train_parity",
                       iterations: int = 25) -> None:
    """The descent (PARITY_DESCENT_ITERATIONS outer iterations, features
    in ``feature_dtype``, each solve L-BFGS ``iterations``) on the card
    and on the CPU. Each update of the card's run is replayed on the CPU
    from the same offsets and warm start and compared there: the two
    descents' own paths may part at entities the data does not
    determine, and every later update would inherit that. In bfloat16 the
    solves run PARITY_EARLY_ITERATIONS and each coefficient may also
    differ by one bfloat16 step of its model's largest coefficient
    (compare_update): rounding the coefficients to
    bfloat16 makes each objective a step function of them, and two
    correct solvers part after about 20 iterations (ROADMAP §C)."""
    cuda_coords, _ = build_coordinates(np, torch, train, "cuda",
                                       feature_dtype, iterations)
    recorded = {cid: RecordedCoordinate(c) for cid, c in cuda_coords.items()}
    cuda_model, cuda_hist, cuda_s = run_descent(
        torch, recorded, val, "cuda", PARITY_DESCENT_ITERATIONS)
    cpu_coords, _ = build_coordinates(np, torch, train, "cpu",
                                      feature_dtype, iterations)
    cpu_model, cpu_hist, cpu_s = run_descent(
        torch, cpu_coords, val, "cpu", PARITY_DESCENT_ITERATIONS)
    updates = []
    for cid in SEQ:
        for k, (offsets, initial, got) in enumerate(recorded[cid].calls):
            want = cpu_coords[cid].train_model(offsets, initial=initial)
            updates.append({"coordinate": cid, "iteration": k,
                            **compare_update(np, cpu_coords[cid], got,
                                             want, feature_dtype ==
                                             "bfloat16")})
    auc_cuda = [r["validation"]["auc"] for r in cuda_hist.records]
    auc_cpu = [r["validation"]["auc"] for r in cpu_hist.records]
    auc_diff = float(np.max(np.abs(np.subtract(auc_cuda, auc_cpu))))
    p_diff = (torch.sigmoid(cuda_model.score(val)).cpu()
              - torch.sigmoid(cpu_model.score(val)).cpu()).abs()
    emit(phase, card=card, rows=train.num_rows,
         feature_dtype=feature_dtype,
         iterations=PARITY_DESCENT_ITERATIONS,
         solver_iterations=iterations, updates=updates,
         auc_cuda=auc_cuda, auc_cpu=auc_cpu, max_auc_diff=auc_diff,
         val_probability_diff={"mean": float(p_diff.mean()),
                               "max": float(p_diff.max())},
         descent_seconds={"cuda": cuda_s, "cpu": cpu_s},
         tolerance=PARITY_TOL, well_determined_rows=WELL_DETERMINED_ROWS)
    bad = [u for u in updates if not u["held_ratio"] <= 1.0]
    if bad or not auc_diff <= PARITY_TOL \
            or not float(p_diff.mean()) <= PARITY_TOL:
        raise AssertionError(
            f"{phase}: cuda and cpu differ beyond {PARITY_TOL}: "
            f"updates {bad}, AUC {auc_diff}, mean validation probability "
            f"{float(p_diff.mean())}")


# -- sparse_train ----------------------------------------------------------

def make_sparse_data(np, rows: int, batch=None):
    """Config-5 data from the seed, the last 5% held out; the split is
    two row-slice views of the generated arrays. ``batch``: the rows
    already generated (collect_sparse_data), else they are made here."""
    from photon_ml_torch.data import sparse
    from photon_ml_torch.data.game_data import from_sparse_batch

    if batch is None:
        batch, _ = sparse.synthetic_sparse(
            n=rows, num_features=SPARSE_DIM, nnz_per_row=SPARSE_NNZ,
            seed=SEED)
    ds = from_sparse_batch(batch)
    n_val = max(rows // 20, 1)
    return (ds.subset(slice(0, rows - n_val)),
            ds.subset(slice(rows - n_val, rows)))


# Config 5's rows are the longest host generation here (mostly rng.zipf,
# which must stay the reference's draws), so a child process makes them
# beside the config-4 phases: the same function and seed, so the same
# bits. Its arrays come back over a pipe, in this order.
SPARSE_FIELDS = ("indices", "values", "labels", "weights", "offsets")
_SPARSE_CHILD = """\
import sys
import numpy as np
from photon_ml_torch.data import sparse
rows, dim, nnz, seed = map(int, sys.argv[1:])
batch, _ = sparse.synthetic_sparse(n=rows, num_features=dim,
                                   nnz_per_row=nnz, seed=seed)
out = sys.stdout.buffer
for name in %r:
    out.write(memoryview(np.ascontiguousarray(
        getattr(batch, name).numpy())).cast("B"))
out.flush()
""" % (SPARSE_FIELDS,)


def start_sparse_data(rows: int):
    """Start generating config 5's ``rows`` in a child process;
    collect_sparse_data takes its arrays."""
    return start_child(_SPARSE_CHILD, rows, SPARSE_DIM, SPARSE_NNZ, SEED)


def collect_sparse_data(np, torch, proc, rows: int):
    """The child's SparseBatch: each array read from its pipe into place."""
    from photon_ml_torch.data import sparse

    arrays = {}
    for name in SPARSE_FIELDS:
        shape = (rows, SPARSE_NNZ) if name in ("indices", "values") \
            else (rows,)
        a = np.empty(shape, np.int32 if name == "indices" else np.float32)
        read_into(proc, a, name)
        arrays[name] = torch.from_numpy(a)
    if proc.wait() != 0:
        raise RuntimeError(f"the config-5 generator exited {proc.returncode}")
    return sparse.SparseBatch(num_features=SPARSE_DIM, **arrays)


def sparse_estimator(device: str, optimizer: str = "LBFGS",
                     iterations: int = SPARSE_ITERATIONS, streaming=None,
                     hybrid=False, feature_dtype: str = "float32"):
    """GameEstimator with one sparse fixed effect "ctr", as
    examples/sparse_criteo_style.py builds it, on the ELL layout
    (hybrid=False, the sparse and streamed cells: ell_scatter then gets
    config 5's full 9.5M rows) or, with ``hybrid=None``, the default
    layout, which on one device is the hybrid hot/cold one (the hybrid
    cells); with ``streaming`` (a StreamingConfig) the row-streamed
    coordinate instead. ``feature_dtype`` "bfloat16" stores the hybrid
    hot block in bfloat16 (the ELL layout ignores it)."""
    from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                             FixedEffectDataConfiguration)
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.optim import OptimizerConfig, OptimizerType
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)
    from photon_ml_torch.types import TaskType

    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinates={"ctr": CoordinateConfiguration(
            data=FixedEffectDataConfiguration(
                "global", hybrid=hybrid, feature_dtype=feature_dtype),
            optimization=GLMOptimizationConfiguration(
                optimizer=OptimizerConfig(
                    optimizer_type=OptimizerType(optimizer),
                    max_iterations=iterations, tolerance=1e-7),
                regularization=RegularizationContext(
                    RegularizationType.L2, 1.0)))},
        update_sequence=["ctr"], device=device,
        validation_evaluators=["AUC"], streaming=streaming)


def timed_fit(torch, est, train, val, device: str) -> tuple:
    """One GameEstimator.fit and its seconds, ending with the device
    synchronized."""
    t0 = time.perf_counter()
    result = est.fit(train, validation_data=val)[0]
    if device == "cuda":
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def check_sparse_fit(torch, result, label: str) -> dict:
    means = result.model.models["ctr"].coefficients.means
    auc_val = result.evaluation.metrics["AUC"]
    if means.device.type != "cuda" or not bool(torch.isfinite(means).all()):
        raise AssertionError(f"{label}: coefficients are not finite, or not "
                             "on the card")
    if not 0.5 < auc_val <= 1.0:
        raise AssertionError(f"{label}: validation AUC {auc_val} is not "
                             "above 0.5")
    record = result.history.records[-1]
    return {"auc": auc_val, "train_seconds": record["train_seconds"],
            **record["solver"]}


def phase_sparse_train(np, torch, card: str, generator) -> dict:
    import copy

    from photon_ml_torch.ops import sparse_aggregators as sagg
    from photon_ml_torch.ops.kernels import ell_scatter

    from photon_ml_torch import obs
    from photon_ml_torch.cli import obs as obs_cli
    from photon_ml_torch.obs.ledger import read_rows, verify_ledger

    t0 = time.perf_counter()
    train, val = make_sparse_data(
        np, SPARSE_ROWS, collect_sparse_data(np, torch, generator,
                                             SPARSE_ROWS))
    generate_s = time.perf_counter() - t0  # what the config-4 phases left
    est = sparse_estimator("cuda")
    # The estimator's three observability parameters, at full width.
    tracer = obs.Tracer()
    est.trace, est.watchdog = tracer, obs.WatchdogConfig()
    with tempfile.TemporaryDirectory(prefix="photon-chip-smoke-") as tmp:
        est.ledger_dir = os.path.join(tmp, "ledger")
        torch.cuda.reset_peak_memory_stats()
        ell_scatter.ell_rmatvec.launches = 0  # the main path's run starts
        ell_scatter.scatter_rowterm.launches = 0
        result, fit_s = timed_fit(torch, est, train, val, "cuda")
        launches = ell_scatter.ell_rmatvec.launches  # ... and ends here
        generic = ell_scatter.scatter_rowterm.launches
        peak = torch.cuda.max_memory_allocated()
        ledger_problems = verify_ledger(est.ledger_dir)
        rows, _ = read_rows(est.ledger_dir)
    est.trace = est.ledger_dir = est.watchdog = None
    fit = check_sparse_fit(torch, result, "sparse_train")
    trace = tracer.chrome_trace()
    roots = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and e["name"] == "estimator.fit"
             and "parent_id" not in e["args"]]
    post_fit = [r for r in rows if r["kind"] == "opt_iter"
                and r.get("clock") == "post_fit"]
    problems = obs_cli.verify_trace(trace) + ledger_problems
    if len(roots) != 1 or len(post_fit) != fit["iterations"] + 1 \
            or problems or rows[-1].get("status") != "ok":
        raise AssertionError(
            f"obs sparse_train: {len(roots)} estimator.fit roots, "
            f"{len(post_fit)} post-fit opt_iter rows for "
            f"{fit['iterations']} iterations, problems {problems[:5]}, "
            f"last row {rows[-1]}")
    emit("obs", on="sparse_train", card=card, fit_seconds=fit_s,
         estimator_fit_root=True, post_fit_opt_iter_rows=len(post_fit),
         iterations=fit["iterations"], ledger_rows=len(rows),
         spans={k: v["spans"] for k, v in span_counts(trace).items()},
         ell_rmatvec_launches=launches,
         gradient_evaluations=fit["gradient_evaluations"])
    # Every scatter of the path forms its row terms in the kernel: none
    # goes through the generic route, which reads (n, k) row terms.
    if launches != fit["gradient_evaluations"] or generic:
        raise AssertionError(
            f"sparse_train: ell_rmatvec launched {launches} times for "
            f"{fit['gradient_evaluations']} gradient evaluations, "
            f"scatter_rowterm {generic} times")
    coord = est.coordinates["ctr"]
    batch = coord.staged
    layout = batch.layout
    # TRON on the same staged coordinate: the estimator's coordinate cache
    # swaps the optimization config, so nothing is staged again.
    tron_est = copy.copy(est)
    tron_est.coordinate_configs = sparse_estimator(
        "cuda", "TRON", TRON_ITERATIONS).coordinate_configs
    torch.cuda.reset_peak_memory_stats()
    ell_scatter.ell_rmatvec.launches = 0  # the TRON run starts
    ell_scatter.scatter_rowterm.launches = 0
    tron_result, tron_s = timed_fit(torch, tron_est, train, val, "cuda")
    tron_launches = ell_scatter.ell_rmatvec.launches  # ... and ends
    tron_generic = ell_scatter.scatter_rowterm.launches
    tron_peak = torch.cuda.max_memory_allocated()
    tron = check_sparse_fit(torch, tron_result, "sparse_train TRON")
    if tron_launches != tron["gradient_evaluations"] \
            + tron["hessian_vector_products"] or tron_generic:
        raise AssertionError(
            f"sparse_train TRON: ell_rmatvec launched {tron_launches} times "
            f"for {tron['gradient_evaluations']} gradient evaluations and "
            f"{tron['hessian_vector_products']} H.v products, "
            f"scatter_rowterm {tron_generic} times")
    # One evaluation at the L-BFGS fit's final iterate: the ELL side of
    # hybrid_bf16_train's layout comparison at the same 9.5M rows.
    w = result.model.models["ctr"].coefficients.means
    eval_ms = call_ms(torch, lambda: sagg.value_and_gradient(
        coord.loss, w, batch), reps=5, inner=3)
    col_len = layout.col_ptr[1:] - layout.col_ptr[:-1]
    staged = {name: t.numel() * t.element_size() for name, t in (
        ("indices", batch.indices), ("values", batch.values),
        ("labels", batch.labels), ("weights", batch.weights),
        ("offsets", batch.offsets))}
    emit("sparse_train", card=card, rows=train.num_rows,
         val_rows=val.num_rows, dim=SPARSE_DIM, slots=SPARSE_NNZ,
         valid_slots=layout.nnz, pieces=layout.num_pieces,
         staged_bytes={"batch": sum(staged.values()),
                       "layout": layout.nbytes, **staged},
         longest_column=int(col_len.max()),
         columns_over_32=int((col_len > 32).sum()),
         empty_columns=int((col_len == 0).sum()),
         generate_seconds=generate_s,
         staging_and_layout_seconds=coord.staging_seconds,
         fit_seconds=fit_s, lbfgs=fit, launches=launches,
         max_memory_allocated=peak,
         tron={**tron, "fit_seconds": tron_s, "launches": tron_launches,
               "max_memory_allocated": tron_peak},
         ms_per_evaluation=eval_ms)
    return {"coord": coord, "model": result.model, "launches": launches,
            "tron_launches": tron_launches, "train": train, "val": val,
            "ell": {"rows": train.num_rows, "eval_ms": eval_ms,
                    "auc": fit["auc"], "fit_seconds": fit_s,
                    "lbfgs": fit}}


# -- ell_scatter kernels ---------------------------------------------------

def column_ratio(torch, got, want, allowed) -> float:
    """max over columns of |got − want| / allowed: 1 is the limit, and a
    column allowed nothing must match exactly."""
    if got.numel() == 0:
        return 0.0
    excess = (got - want).abs()
    ratio = torch.where(excess == 0, torch.zeros_like(excess),
                        excess / allowed)
    return float(ratio.max())


def exact_sums(torch, indices, rv, dim):
    """The plain version in float64: each column's sum, exact to far below
    a float32 step."""
    out = torch.zeros(dim + 1, dtype=torch.float64, device=rv.device)
    out.index_add_(0, indices.reshape(-1).long().clamp(max=dim),
                   rv.reshape(-1).double())
    return out[:dim]


def check_ell_scatter(torch, es, indices, rv, dim, layout, label: str,
                      timed: bool, exact: bool = False) -> dict:
    """The kernel against its plain version at one shape: within
    PARITY_REL of it (bit for bit when ``exact``), each column within
    COLUMN_TOL · Σ|terms| of its exact sum, two launches with the same
    bits, and, on real-valued terms, the column check shown to reject the
    kernel's sums over the terms rounded to bfloat16; with ``timed``, the
    times of kernel, plain version and library call too."""
    got = es.scatter_rowterm(indices, rv, dim, layout=layout)
    again = es.scatter_rowterm(indices, rv, dim, layout=layout)
    want = es.scatter_rowterm_reference(indices, rv, dim)
    true = exact_sums(torch, indices, rv, dim)
    mag = exact_sums(torch, indices, rv.abs(), dim)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if dim else 0.0
    scale = float(want.abs().max()) if dim else 0.0
    rel = err / max(scale, 1e-9)
    ratio = column_ratio(torch, got.double(), true, COLUMN_TOL * mag)
    plain_ratio = column_ratio(torch, want.double(), true, COLUMN_TOL * mag)
    if not torch.equal(got, again):
        raise AssertionError(f"ell_scatter {label}: two launches differ")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"ell_scatter {label}: not bit-exact on "
                             f"integer row terms (max |err| {err})")
    if not (rel <= PARITY_REL and ratio <= 1.0):
        raise AssertionError(
            f"ell_scatter {label}: parity_rel {rel} (limit {PARITY_REL}), "
            f"worst column at {ratio} of {COLUMN_TOL} · Σ|terms|")
    bf16_ratio = None
    if not exact:
        coarse = es.scatter_rowterm(indices, rv.bfloat16().float(), dim,
                                    layout=layout)
        bf16_ratio = column_ratio(torch, coarse.double(), true,
                                  COLUMN_TOL * mag)
        del coarse
        if not bf16_ratio > 1.0:
            raise AssertionError(
                f"ell_scatter {label}: the column check would pass sums of "
                f"bfloat16 row terms (worst column at {bf16_ratio})")
    del want, true, mag, again
    n, k = (int(x) for x in indices.shape)
    row = {"shape": label, "n": n, "k": k, "dim": dim, "nnz": layout.nnz,
           "pieces": layout.num_pieces, "max_abs_err": err,
           "parity_rel": rel, "column_ratio": ratio,
           "plain_column_ratio": plain_ratio,
           "bf16_column_ratio": bf16_ratio, "bit_exact": err == 0.0}
    if not timed:
        return row
    flat_ids = indices.reshape(-1).long().clamp(max=dim)
    flat_rv = rv.reshape(-1)
    # Bytes the function must move: the ids and row terms read once, the
    # (dim,) sums written once (one add per slot: bytes bound it).
    nbytes = n * k * 8 + dim * 4
    row.update({
        "ms": device_ms(torch, lambda: es.scatter_rowterm(
            indices, rv, dim, layout=layout), reps=7, inner=10),
        "call_ms": call_ms(torch, lambda: es.scatter_rowterm(
            indices, rv, dim, layout=layout), reps=7, inner=10),
        "plain_ms": device_ms(torch, lambda: es.scatter_rowterm_reference(
            indices, rv, dim), reps=5, inner=3),
        "library_ms": device_ms(torch, lambda: torch.zeros(
            dim + 1, device="cuda").index_add_(0, flat_ids, flat_rv),
            reps=5, inner=3),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes})
    return row


def extra_bytes(torch, fn) -> int:
    """Device bytes one call of ``fn`` allocates above what was allocated
    before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return extra


def check_ell_rmatvec(torch, es, indices, values, r, dim, layout, generic,
                      label: str, square: bool = False, timed: bool = False,
                      exact: bool = False) -> dict:
    """ell_rmatvec at one shape: bit for bit scatter_rowterm over the
    materialised row terms r ⊗ values (values² under ``square``) and its
    ``generic`` layout, the same bits on two launches, within PARITY_REL
    of the plain version (bit for bit when ``exact``), each column within
    COLUMN_TOL · Σ|terms| of its exact sum, and, on real-valued inputs,
    the column check shown to reject the kernel's sums with ``r`` rounded
    to bfloat16; with ``timed``, the times of the kernel, the old route
    (the multiply, then scatter_rowterm), the plain version and a CSR
    torch.mv of Xᵀ, and the bytes each route allocates a call.

    Under ``square`` every term is positive, and the float32 plain
    version's atomic sum of the Zipf head (9.5M terms at the main shape)
    drifts from the exact sum by more than PARITY_REL; that form is held
    against the plain version in float64 (the exact sums) instead, and
    the float32 plain version's own gaps are reported beside it."""
    def fused(rr=r):
        return es.ell_rmatvec(indices, values, rr, dim, layout=layout,
                              square=square)

    def terms():
        return r[:, None] * (values * values if square else values)

    def old_route():
        return es.scatter_rowterm(indices, terms(), dim, layout=generic)

    got, again = fused(), fused()
    want = old_route()
    plain = es.ell_rmatvec_reference(indices, values, r, dim, square)
    rv = terms()
    true = exact_sums(torch, indices, rv, dim)
    mag = exact_sums(torch, indices, rv.abs(), dim)
    del rv
    torch.cuda.synchronize()

    def gap(want):
        err = float((got.double() - want.double()).abs().max()) if dim \
            else 0.0
        scale = float(want.abs().max()) if dim else 0.0
        return err, err / max(scale, 1e-9)

    plain32_err, plain32_rel = gap(plain)
    plain32_ratio = column_ratio(torch, plain.double(), true,
                                 COLUMN_TOL * mag)
    held_against = "float64 plain" if square else "float32 plain"
    err, rel = gap(true) if square else (plain32_err, plain32_rel)
    ratio = column_ratio(torch, got.double(), true, COLUMN_TOL * mag)
    if not torch.equal(got, again):
        raise AssertionError(f"ell_rmatvec {label}: two launches differ")
    if not torch.equal(got, want):
        raise AssertionError(
            f"ell_rmatvec {label}: not the bits of scatter_rowterm over the "
            f"materialised row terms (max |diff| "
            f"{float((got - want).abs().max())})")
    if exact and not torch.equal(got, plain):
        raise AssertionError(f"ell_rmatvec {label}: not bit-exact on "
                             f"integer inputs (max |err| {err})")
    if not (rel <= PARITY_REL and ratio <= 1.0):
        raise AssertionError(
            f"ell_rmatvec {label}: parity_rel {rel} against the "
            f"{held_against} version (limit {PARITY_REL}), worst column "
            f"at {ratio} of {COLUMN_TOL} · Σ|terms|")
    bf16_ratio = None
    if not exact:
        coarse = fused(r.bfloat16().float())
        bf16_ratio = column_ratio(torch, coarse.double(), true,
                                  COLUMN_TOL * mag)
        del coarse
        if not bf16_ratio > 1.0:
            raise AssertionError(
                f"ell_rmatvec {label}: the column check would pass sums "
                f"with r in bfloat16 (worst column at {bf16_ratio})")
    del want, plain, true, mag, again
    n, k = (int(x) for x in indices.shape)
    row = {"shape": label, "n": n, "k": k, "dim": dim, "square": square,
           "nnz": layout.nnz, "pieces": layout.num_pieces,
           "held_against": held_against, "max_abs_err": err,
           "parity_rel": rel, "column_ratio": ratio,
           "plain32_max_abs_err": plain32_err,
           "plain32_parity_rel": plain32_rel,
           "plain32_column_ratio": plain32_ratio,
           "bf16_column_ratio": bf16_ratio, "generic_bits": True,
           "bit_exact": plain32_err == 0.0}
    if not timed:
        return row
    # Xᵀ as a CSR matrix over the same layout: one library call of the
    # same function (cuSPARSE allocates inside it, so no graph capture).
    csr = torch.sparse_csr_tensor(layout.col_ptr, layout.rows,
                                  layout.sorted_values, size=(dim, n))
    lib_err = float((torch.mv(csr, r) - got).abs().max())
    # Bytes the function must move: each valid slot's id and value read
    # once, r read once and the (dim,) sums written once (one multiply and
    # one add a slot: bytes bound it).
    nbytes = layout.nnz * 8 + n * 4 + dim * 4
    row.update({
        "ms": device_ms(torch, fused, reps=7, inner=10),
        "call_ms": call_ms(torch, fused, reps=7, inner=10),
        "queued_ms": queued_ms(torch, fused),
        "old_route_ms": device_ms(torch, old_route, reps=7, inner=10),
        "old_route_call_ms": call_ms(torch, old_route, reps=7, inner=10),
        "plain_ms": device_ms(torch, lambda: es.ell_rmatvec_reference(
            indices, values, r, dim, square), reps=5, inner=3),
        "library_ms": call_ms(torch, lambda: torch.mv(csr, r), reps=7,
                              inner=10),
        "library_device_ms": queued_ms(torch, lambda: torch.mv(csr, r)),
        "library_call": "torch.mv on a CSR Xᵀ (dim x n) over the layout's "
                        "column pointer, rows and values; ms per call from "
                        "Python, library_device_ms queued behind a spin",
        "library_max_abs_diff": lib_err,
        # The gathers alone, in the kernel's column order, in one call.
        "gather_ms": device_ms(torch, lambda: r.index_select(
            0, layout.rows), reps=7, inner=10),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes,
        "extra_bytes": extra_bytes(torch, fused),
        "old_route_extra_bytes": extra_bytes(torch, old_route)})
    del csr
    return row


def phase_ell_scatter(np, torch, trained: dict) -> list[dict]:
    """ell_scatter's generic route (scatter_rowterm, the hybrid cold
    margins' and the streamed chunks' kernel) and its fused one
    (ell_rmatvec, the ELL objective's) at the main path's shape and at
    the fixtures below. Returns (generic rows, fused rows)."""
    from photon_ml_torch.data import sparse
    from photon_ml_torch.ops import sparse_aggregators as sagg
    from photon_ml_torch.ops.kernels import ell_scatter as es

    coord = trained["coord"]
    batch = coord.staged
    dim = batch.num_features
    # The generic route's layout (perm) of the same ids: the staged batch
    # carries only ell_rmatvec's (rows and values).
    generic = es.build_layout(batch.indices, dim)
    layouts = {"ell_rmatvec": batch.layout.nbytes,
               "scatter_rowterm": generic.nbytes}
    # The main path's row terms at the fitted coefficients: the gradient's
    # r = w·dl (exactly what the last gradient evaluation scattered), the
    # H·v product's w·d2l·(x·v) along a seeded direction v, and the
    # diagonal's w·d2l over values².
    means = trained["model"].models["ctr"].coefficients.means
    z = sagg.margins(batch, means)
    _, dl = coord.loss.loss_and_dz(z, batch.labels)
    d2 = coord.loss.d2z(z, batch.labels)

    def masked(t):
        return torch.where(batch.weights > 0, batch.weights * t,
                           torch.zeros_like(t))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    r = masked(dl)
    rv = r[:, None] * batch.values
    rows = [check_ell_scatter(torch, es, batch.indices, rv, dim, generic,
                              "main path", True)]
    rv_int = torch.randint(-8, 9, rv.shape, generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.float32)
    rows.append(check_ell_scatter(torch, es, batch.indices, rv_int, dim,
                                  generic, "main path, integer", False,
                                  exact=True))
    del rv, rv_int
    torch.cuda.empty_cache()
    direction = torch.randn(dim, generator=gen, device="cuda")
    xv = sagg.ell_matvec(batch.indices, batch.values, direction)
    fused = []
    for form, rr, square in (("gradient", r, False),
                             ("H·v", masked(d2) * xv, False),
                             ("diagonal", masked(d2), True)):
        fused.append(check_ell_rmatvec(
            torch, es, batch.indices, batch.values, rr, dim, batch.layout,
            generic, f"main path, {form}", square=square,
            timed=form == "gradient"))
    del z, dl, d2, xv, r
    # Integer r and values: every product and partial sum exact.
    ints = torch.randint(-4, 5, batch.values.shape, generator=gen,
                         device="cuda", dtype=torch.int32).to(torch.float32)
    r_int = torch.randint(-3, 4, (batch.num_rows,), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.float32)
    int_layout = es.build_layout(batch.indices, dim, ints)
    for square in (False, True):
        fused.append(check_ell_rmatvec(
            torch, es, batch.indices, ints, r_int, dim, int_layout, generic,
            "main path, integer", square=square, exact=True))
    try:
        es.ell_rmatvec(batch.indices, batch.values, r_int, dim)
    except ValueError:
        pass
    else:
        raise AssertionError("ell_rmatvec ran on CUDA tensors without a "
                             "layout")
    del ints, r_int, int_layout, generic
    torch.cuda.empty_cache()
    # The regime in which the JAX package runs its Pallas kernel.
    for small_dim in (512, 2048):
        b = sparse.synthetic_sparse(
            n=65_536, num_features=small_dim, nnz_per_row=SPARSE_NNZ,
            seed=SEED)[0].to("cuda")
        g = es.build_layout(b.indices, small_dim)
        r = torch.randn(b.num_rows, generator=gen, device="cuda")
        rows.append(check_ell_scatter(
            torch, es, b.indices, r[:, None] * b.values, small_dim, g,
            f"d={small_dim}", True))
        fused.append(check_ell_rmatvec(
            torch, es, b.indices, b.values, r, small_dim, b.layout, g,
            f"d={small_dim}", timed=True))
    # Uniform ids over d = 1M (short columns, most of one or two entries)
    # with normal row terms, which bfloat16 cannot hold.
    uni = torch.randint(0, dim, (65_536, SPARSE_NNZ), generator=gen,
                        device="cuda", dtype=torch.int32)
    uni[torch.rand(uni.shape, generator=gen, device="cuda") < 0.1] = dim
    uni_values = torch.randn(uni.shape, generator=gen, device="cuda")
    uni_layout = es.build_layout(uni, dim)
    rows.append(check_ell_scatter(
        torch, es, uni, torch.randn(uni.shape, generator=gen, device="cuda"),
        dim, uni_layout, "uniform ids, short columns", False))
    fused.append(check_ell_rmatvec(
        torch, es, uni, uni_values,
        torch.randn(uni.shape[0], generator=gen, device="cuda"), dim,
        es.build_layout(uni, dim, uni_values), uni_layout,
        "uniform ids, short columns"))
    # All padding: every slot at the sentinel, every column empty.
    pad = torch.full((4096, SPARSE_NNZ), dim, dtype=torch.int32,
                     device="cuda")
    pad_values = torch.randn(pad.shape, generator=gen, device="cuda")
    rows.append(check_ell_scatter(
        torch, es, pad, torch.randn(pad.shape, generator=gen, device="cuda"),
        dim, es.build_layout(pad, dim), "all padding", False, exact=True))
    fused.append(check_ell_rmatvec(
        torch, es, pad, pad_values,
        torch.randn(pad.shape[0], generator=gen, device="cuda"), dim,
        es.build_layout(pad, dim, pad_values), es.build_layout(pad, dim),
        "all padding", exact=True))
    # One column in every row (the Zipf head, alone): the longest segment.
    one = torch.randint(0, dim, (1_000_000, 8), generator=gen,
                        device="cuda", dtype=torch.int32)
    one[:, 0] = 7
    one[:, 1] = dim  # and a padding slot in every row
    one_values = torch.randn(one.shape, generator=gen, device="cuda")
    one_layout = es.build_layout(one, dim)
    rows.append(check_ell_scatter(
        torch, es, one, torch.randn(one.shape, generator=gen, device="cuda"),
        dim, one_layout, "one column in every row", False))
    fused.append(check_ell_rmatvec(
        torch, es, one, one_values,
        torch.randn(one.shape[0], generator=gen, device="cuda"), dim,
        es.build_layout(one, dim, one_values), one_layout,
        "one column in every row"))
    emit("kernels", kernel="ell_scatter", checks=len(rows), shapes=rows)
    emit("kernels", kernel="ell_rmatvec", checks=len(fused), shapes=fused,
         layout_bytes=layouts)
    return rows, fused


# -- sparse_parity ---------------------------------------------------------

class EvaluationLog:
    """Records every objective evaluation of the sparse fit while it is
    open: ``optim.sparse_problem`` calls
    ``ops.sparse_aggregators.value_and_gradient`` once per evaluation, and
    each (iterate, value, gradient) is kept on the host."""

    def __init__(self, sagg):
        self.sagg = sagg
        self.inner = sagg.value_and_gradient
        self.calls = []

    def __enter__(self):
        def recorded(loss, means, batch):
            value, grad = self.inner(loss, means, batch)
            self.calls.append((means.cpu(), value.cpu(), grad.cpu()))
            return value, grad

        self.sagg.value_and_gradient = recorded
        return self

    def __exit__(self, *exc):
        self.sagg.value_and_gradient = self.inner


def replay_on_cpu(torch, coord, calls) -> dict:
    """Each recorded card evaluation computed again on the CPU coordinate's
    staged batch from the same iterate: the value's relative gap and the
    worst gradient column against its allowance (REPLAY_ROW_ABS)."""
    from photon_ml_torch.ops import sparse_aggregators as sagg
    from photon_ml_torch.ops.kernels import ell_scatter as es

    batch, loss = coord.staged, coord.loss
    value_gap, column = 0.0, 0.0
    for w, value, grad in calls:
        v_cpu, g_cpu = sagg.value_and_gradient(loss, w, batch)
        _, dl = loss.loss_and_dz(sagg.margins(batch, w), batch.labels)
        r = torch.where(batch.weights > 0, batch.weights * dl,
                        torch.zeros_like(dl))
        w_pos = torch.where(batch.weights > 0, batch.weights,
                            torch.zeros_like(r))
        allowed = es.scatter_rowterm_reference(
            batch.indices, (COLUMN_TOL * r.abs() + REPLAY_ROW_ABS * w_pos)
            [:, None] * batch.values.abs(), batch.num_features)
        value_gap = max(value_gap, abs(float(value - v_cpu))
                        / abs(float(v_cpu)))
        column = max(column, column_ratio(torch, grad, g_cpu, allowed))
    return {"evaluations": len(calls), "value_rel_gap": value_gap,
            "gradient_column_ratio": column}


def phase_sparse_parity(np, torch, card: str) -> dict:
    """The config-5 fit at 300,000 rows on the card and on the CPU.

    With L2 every coefficient has one optimum, but 60 L-BFGS iterations
    do not reach it on this ill-conditioned problem (a column in every
    row, a tail of columns seen once), and where each run stops depends
    on the last bits of every line search (the CPU's own fit over the
    same rows in reverse order parts from it by tenths; PERF.md).
    So every coefficient is held within PARITY_TOL over the
    first PARITY_EARLY_ITERATIONS iterations, where the two paths have
    not parted; every objective evaluation of the card's full fit is
    replayed on the CPU from the same iterate and held within
    REPLAY_VALUE_RTOL (value) and each gradient column's allowance; and
    the full fits' validation AUCs are held within PARITY_TOL."""
    from photon_ml_torch.ops import sparse_aggregators as sagg

    train, val = make_sparse_data(np, SPARSE_PARITY_ROWS)

    def fit(device, data, iterations, log=None):
        est = sparse_estimator(device, iterations=iterations)
        if log is None:
            result, seconds = timed_fit(torch, est, data, val, device)
        else:
            with log:
                result, seconds = timed_fit(torch, est, data, val, device)
        return (result.model.models["ctr"].coefficients.means.cpu(),
                result.evaluation.metrics["AUC"],
                result.history.records[-1]["solver"], seconds,
                est.coordinates["ctr"])

    early = {d: fit(d, train, PARITY_EARLY_ITERATIONS)
             for d in ("cuda", "cpu")}
    log = EvaluationLog(sagg)
    full = {"cuda": fit("cuda", train, SPARSE_ITERATIONS, log),
            "cpu": fit("cpu", train, SPARSE_ITERATIONS)}
    replay = replay_on_cpu(torch, full["cpu"][4], log.calls)
    early_diff = float((early["cuda"][0] - early["cpu"][0]).abs().max())
    auc_diff = abs(full["cuda"][1] - full["cpu"][1])
    emit("sparse_parity", card=card, rows=train.num_rows,
         early_iterations=PARITY_EARLY_ITERATIONS,
         early_coefficient_max_diff=early_diff,
         full_coefficient_max_diff=float(
             (full["cuda"][0] - full["cpu"][0]).abs().max()),
         replay=replay, auc_diff=auc_diff,
         auc={k: v[1] for k, v in full.items()},
         solver={k: v[2] for k, v in full.items()},
         fit_seconds={k: v[3] for k, v in full.items()},
         tolerance=PARITY_TOL)
    if replay["evaluations"] != full["cuda"][2]["gradient_evaluations"]:
        raise AssertionError(
            f"sparse_parity: recorded {replay['evaluations']} card "
            f"evaluations, the solver reports "
            f"{full['cuda'][2]['gradient_evaluations']}")
    if not (early_diff <= PARITY_TOL and auc_diff <= PARITY_TOL
            and replay["value_rel_gap"] <= REPLAY_VALUE_RTOL
            and replay["gradient_column_ratio"] <= 1.0):
        raise AssertionError(
            f"sparse_parity: cuda and cpu differ: coefficients after "
            f"{PARITY_EARLY_ITERATIONS} iterations {early_diff} and "
            f"validation AUC {auc_diff} (limit {PARITY_TOL}); replayed "
            f"values {replay['value_rel_gap']} (limit "
            f"{REPLAY_VALUE_RTOL}), worst gradient column at "
            f"{replay['gradient_column_ratio']} of its limit")
    return {"train": train, "val": val, "early_cuda": early["cuda"][0]}


# -- stream_train ----------------------------------------------------------

def stream_config(feature_dtype: str, chunk_rows: int = STREAM_CHUNK_ROWS,
                  pin_chunks: int = 0):
    """The reference's StreamingConfig defaults with the flagship's int8
    storage (dev-scripts/flagship_criteo_stream.py)."""
    from photon_ml_torch.api.configs import StreamingConfig

    return StreamingConfig(chunk_rows=chunk_rows, num_hot=STREAM_NUM_HOT,
                           feature_dtype=feature_dtype, prefetch_depth=2,
                           pin_chunks=pin_chunks)


def host_rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def stream_replay(torch, chunked, loss, w, offsets=None) -> tuple:
    """One value-and-gradient pass over the staged host chunks on the
    CPU (the port's plain path, chunk by chunk), with each gradient
    column's allowance: COLUMN_TOL · Σ_i |r_i · x_ic| plus REPLAY_ROW_ABS ·
    Σ_i w_i · |x_ic| (the sparse_parity allowance; x dequantised), and
    on a bfloat16 hot tier one bfloat16 step of r on the rows bf16_flip
    marks."""
    import dataclasses

    from photon_ml_torch.ops import streaming_sparse as ss

    w = w.cpu()
    offsets = None if offsets is None else offsets.cpu()
    w_pad = ss._padded(w)
    value = torch.zeros((), dtype=torch.float64)
    grad = torch.zeros(chunked.dim)
    allowed = torch.zeros(chunked.dim)
    for i, ch in enumerate(chunked.chunks):
        z = ss._chunk_margins_of(ch, w_pad,
                                 ss._offsets_for(chunked, offsets, i, ch))
        l, dl = loss.loss_and_dz(z, ch.labels)
        value += float(torch.sum(ss._masked(ch.weights, l)))
        r = ss._masked(ch.weights, dl)
        grad += ss._chunk_rowterm_grad(ch, r)
        w_pos = torch.where(ch.weights > 0, ch.weights,
                            torch.zeros_like(r))
        magnitude = dataclasses.replace(ch, X_hot=ch.X_hot.abs(),
                                        cold_vals=ch.cold_vals.abs())
        allowed += ss._chunk_rowterm_grad(
            magnitude, COLUMN_TOL * r.abs() + REPLAY_ROW_ABS * w_pos)
        if ch.X_hot.dtype == torch.bfloat16:
            # The hot tier reads r rounded to bfloat16 (bf16_flip).
            allowed += ss._chunk_rowterm_grad(
                dataclasses.replace(magnitude, cold_vals=torch.zeros_like(
                    ch.cold_vals)), bf16_flip(torch, r, w_pos))
    return float(value), grad, allowed


def replay_gaps(torch, value, grad, replayed) -> dict:
    v_cpu, g_cpu, allowed = replayed
    return {"value_rel_gap": abs(float(value) - v_cpu) / abs(v_cpu),
            "gradient_column_ratio": column_ratio(torch, grad.cpu(), g_cpu,
                                                  allowed)}


def synced_seconds(torch, fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_stream_train(np, torch, card: str, train, val,
                       feature_dtype: str = "int8",
                       phase: str = "stream_train") -> dict:
    """Config 5's training rows (the first STREAM_ROWS, or what the caller
    passes), streamed in ``feature_dtype`` chunks through
    GameEstimator(streaming=...)."""
    import resource

    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_torch.ops.kernels import ell_scatter
    from photon_ml_torch.ops.kernels import stream_fused as sf

    est = sparse_estimator("cuda", iterations=STREAM_ITERATIONS,
                           streaming=stream_config(feature_dtype))
    rss0 = host_rss_bytes()
    torch.cuda.reset_peak_memory_stats()
    sf.hot_margins.launches = 0  # the streamed path's run starts
    sf.hot_rmatvec.launches = 0
    ell_scatter.scatter_rowterm.launches = 0
    result, fit_s = timed_fit(torch, est, train, val, "cuda")
    launches = {"hot_margins": sf.hot_margins.launches,  # ... and ends
                "hot_rmatvec": sf.hot_rmatvec.launches,
                "ell_scatter": ell_scatter.scatter_rowterm.launches}
    peak = torch.cuda.max_memory_allocated()
    fit = check_sparse_fit(torch, result, phase)
    coord = est.coordinates["ctr"]
    stream, chunked = coord.stream, coord.chunked
    chunks = chunked.num_chunks
    passes = dict(stream.passes)
    want = {"hot_margins": chunks * sum(passes.values()),
            "hot_rmatvec": chunks * passes["value_grad"],
            "ell_scatter": chunks * passes["value_grad"]}
    if launches != want or passes["value_grad"] != \
            fit["gradient_evaluations"] or passes["value"] != \
            fit["value_evaluations"] or passes["margins"] != 2:
        raise AssertionError(
            f"{phase}: launches {launches}, expected {want} for "
            f"{chunks} chunks and passes {passes} (solver: {fit})")
    pass_bytes = sum(ss._chunk_nbytes(ch) for ch in chunked.chunks)
    if stream.bytes_moved != pass_bytes * sum(passes.values()):
        raise AssertionError(f"{phase}: {stream.bytes_moved} bytes "
                             f"moved for {passes} passes of {pass_bytes}")
    # At the final iterate: two value-and-gradient passes (same bits),
    # a value-only pass, and the CPU replay of the first.
    w = result.model.models["ctr"].coefficients.means
    (v1, g1), vg_s = synced_seconds(torch, lambda: coord._vg(w))
    (v2, g2), _ = synced_seconds(torch, lambda: coord._vg(w))
    _, v_s = synced_seconds(torch, lambda: coord._v(w))
    if not (torch.equal(v1, v2) and torch.equal(g1, g2)):
        raise AssertionError(f"{phase}: two value-and-gradient passes at "
                             "the same iterate differ")
    t0 = time.perf_counter()
    replay = replay_gaps(torch, v1, g1,
                         stream_replay(torch, chunked, coord.loss, w))
    replay_s = time.perf_counter() - t0
    if not (replay["value_rel_gap"] <= REPLAY_VALUE_RTOL
            and replay["gradient_column_ratio"] <= 1.0):
        raise AssertionError(f"{phase}: the CPU replay differs: {replay}")
    # The copy engine alone: one chunk's payload host→device.
    host = chunked.chunks[1]
    dev = {k: torch.empty_like(t, device="cuda")
           for k, t in host.tensors().items()}

    def copy_chunk():
        for k, t in host.tensors().items():
            dev[k].copy_(t, non_blocking=True)

    copy_ms = call_ms(torch, copy_chunk, reps=5, inner=5)
    cold = dev["cold_cols"]
    layout_ms = call_ms(torch, lambda: ell_scatter.build_layout(
        cold, chunked.dim), reps=5, inner=5)
    del dev, cold
    record = result.history.records[-1]
    emit(phase, card=card, rows=train.num_rows,
         val_rows=val.num_rows, dim=chunked.dim, chunks=chunks,
         chunk_rows=chunked.chunk_rows, num_hot=STREAM_NUM_HOT,
         feature_dtype=feature_dtype,
         stored={"X_hot": str(chunked.chunks[0].X_hot.dtype),
                 "cold_vals": str(chunked.chunks[0].cold_vals.dtype)},
         staging_seconds=coord.staging_seconds,
         pin_seconds=coord.pin_seconds, fit_seconds=fit_s,
         train_seconds=record["train_seconds"], lbfgs=fit, passes=passes,
         bytes_per_pass=pass_bytes, bytes_moved=stream.bytes_moved,
         seconds_per_pass={"value_grad": vg_s, "value": v_s},
         stream_gb_per_s=pass_bytes / vg_s / 1e9,
         copy_ms_per_chunk=copy_ms,
         copy_gb_per_s=ss._chunk_nbytes(host) / copy_ms / 1e6,
         layout_ms_per_chunk=layout_ms,
         layout_share_of_value_grad_pass=chunks * layout_ms / 1e3 / vg_s,
         launches=launches, auc=fit["auc"], replay=replay,
         replay_seconds=replay_s, max_memory_allocated=peak,
         host_rss_bytes={"before": rss0, "after": host_rss_bytes(),
                         "process_peak": resource.getrusage(
                             resource.RUSAGE_SELF).ru_maxrss * 1024})
    return {"coord": coord, "w": w, "launches": launches,
            "passes": passes, "auc": fit["auc"],
            "train_seconds": record["train_seconds"]}


# -- stream_fused kernels ---------------------------------------------------

def _exact(torch, X, w, base=None):
    """float64 value and Σ|terms| of base + X·w (margins) or w·X
    (rmatvec, ``w`` the row terms, ``base`` None)."""
    Xd = X.double()
    if base is None:
        return w.double() @ Xd, w.double().abs() @ Xd.abs()
    return Xd @ w.double() + base.double(), \
        Xd.abs() @ w.double().abs() + base.double().abs()


def check_stream_kernel(torch, sf, name, X, vec, base, label: str,
                        timed: bool, exact: bool = False) -> dict:
    """One of the two kernels against its plain version at one shape:
    each output within TERM_TOL · Σ|terms| of its exact (float64) value,
    parity_rel within PARITY_REL, the same bits on two launches, and bit
    for bit (kernel, plain, float64) when ``exact``; with ``timed``, the
    times of kernel, plain version and library call(s) too."""
    if name == "hot_margins":
        kernel = (lambda: sf.hot_margins(X, vec, base))
        plain = (lambda: sf.hot_margins_reference(X, vec, base))
    else:
        kernel = (lambda: sf.hot_rmatvec(X, vec))
        plain = (lambda: sf.hot_rmatvec_reference(X, vec))
    got, again, want = kernel(), kernel(), plain()
    true, mag = _exact(torch, X, vec, base if name == "hot_margins"
                       else None)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    rel = err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-9)
    ratio = column_ratio(torch, got.double(), true, TERM_TOL * mag)
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {label}: two launches differ")
    if exact and not (torch.equal(got, want)
                      and torch.equal(got.double(), true)):
        raise AssertionError(f"{name} {label}: not bit-exact on integer "
                             f"inputs (max |err| {err})")
    if not (rel <= PARITY_REL and ratio <= 1.0):
        raise AssertionError(
            f"{name} {label}: parity_rel {rel} (limit {PARITY_REL}), worst "
            f"output at {ratio} of {TERM_TOL} · Σ|terms|")
    n, h = (int(x) for x in X.shape)
    dtype = str(X.dtype).replace("torch.", "")
    row = {"kernel": name, "shape": label, "n": n, "H": h, "dtype": dtype,
           "route": sf.route(X.contiguous()), "max_abs_err": err,
           "parity_rel": rel, "term_ratio": ratio, "bit_exact": err == 0.0}
    if not timed:
        return row
    # Bytes the function must move: X once, the (n,) and (H,) vectors
    # once, the output once; 2·n·H float32 operations.
    vectors = (h + 2 * n) if name == "hot_margins" else (n + h)
    nbytes = n * h * X.element_size() + vectors * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * n * h / PEAK_F32_FLOP_PER_S * 1e3
    if name == "hot_margins":
        library = (lambda: torch.addmv(base, X.float(), vec))
    else:
        library = (lambda: torch.mv(X.float().t(), vec))
    row.update({
        "ms": device_ms(torch, kernel),
        "call_ms": call_ms(torch, kernel),
        "plain_ms": device_ms(torch, plain, reps=11, inner=20),
        "library_ms": device_ms(torch, library, reps=11, inner=20),
        "library_call": (("torch.addmv" if name == "hot_margins" else
                          "torch.mv on X.t()") if dtype == "float32" else
                         ("two calls: Tensor.float(), then " +
                          ("torch.addmv" if name == "hot_margins" else
                           "torch.mv on X.t()"))),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes})
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def misaligned_copy(torch, X):
    """X copied 4 bytes into a larger buffer: contiguous, its base not on
    16 bytes, so stream_fused.route sends it direct."""
    buf = torch.empty(X.numel() + 4, dtype=X.dtype, device=X.device)
    view = buf[1:1 + X.numel()].view(X.shape)
    view.copy_(X)
    return view


def phase_stream_kernels(np, torch, trained: dict) -> list[dict]:
    """hot_margins and hot_rmatvec at the streamed chunk (the fit's own
    int8 chunk, and that chunk dequantised to float32 and bfloat16), on
    the padded tail chunk, at a ragged shape and on integer inputs. The
    float32 blocks on both routes: the main chunk on the ring and, copied
    off 16-byte alignment, on the direct route (hot_margins the same
    bits), ring blocks whose rows are no multiple of a tile or of 512 at
    widths that reach each of the ring kernels' instantiations (their
    hot_margins the bits of their misaligned copies), the ragged shape
    and a block wider than the ring takes, direct."""
    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_torch.ops.kernels import stream_fused as sf

    coord = trained["coord"]
    w_pad = ss._padded(trained["w"])

    def inputs(ch):
        """The chunk on the card with the fit's own kernel inputs: the
        scale-folded w_hot, the base (cold tier + zero offsets) and the
        row terms at the final iterate."""
        ch = ss._place(ch, torch.device("cuda"))
        w_hot = torch.index_select(w_pad, 0, ch.hot_cols) * ch.hot_scale
        w_cold = w_pad * ch.cold_scale
        k = ch.cold_cols.shape[1]
        base = ch.offsets + (torch.index_select(
            w_cold, 0, ch.cold_cols.reshape(-1)).reshape(-1, k)
            * ch.cold_vals.float()).sum(dim=1)
        z = sf.hot_margins_reference(ch.X_hot, w_hot, base)
        _, dl = coord.loss.loss_and_dz(z, ch.labels)
        return ch, w_hot, base, ss._masked(ch.weights, dl)

    rows = []
    main, w_hot, base, r = inputs(coord.chunked.chunks[0])
    # The same chunk dequantised: float32 values with unscaled weights.
    X32 = main.X_hot.float() * main.hot_scale
    w32 = torch.index_select(w_pad, 0, main.hot_cols)
    for X, w in ((main.X_hot, w_hot), (X32, w32), (X32.bfloat16(), w32)):
        for name, vec in (("hot_margins", w), ("hot_rmatvec", r)):
            rows.append(check_stream_kernel(torch, sf, name, X, vec, base,
                                            "main", True))
    # The same float32 chunk on the direct route: hot_margins keeps the
    # ring's bits.
    X32d = misaligned_copy(torch, X32)
    for name, vec in (("hot_margins", w32), ("hot_rmatvec", r)):
        rows.append(check_stream_kernel(torch, sf, name, X32d, vec, base,
                                        "main, misaligned copy", False))
    ring_m, direct_m = (sf.hot_margins(X, w32, base) for X in (X32, X32d))
    rows[-2]["bits_equal_ring_route"] = bool(torch.equal(ring_m, direct_m))
    del main, X32, X32d, ring_m, direct_m
    tail, w_hot, base, r = inputs(coord.chunked.chunks[-1])
    rows += [check_stream_kernel(torch, sf, name, tail.X_hot, vec, base,
                                 "tail chunk", False)
             for name, vec in (("hot_margins", w_hot), ("hot_rmatvec", r))]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # float32 off the main shape: ring rows no multiple of a tile or of
    # 512, at widths that reach each of the ring's rmatvec instantiations
    # (64, 96, 192: 8, 4 and 2 splits of a tile's rows; 516, 4000, 8192:
    # 2, 8 and 16 column vectors a thread; 512 and the hybrid block's
    # 1,772: 1 and 4), each hot_margins bit for bit its misaligned copy's
    # (direct route); and rows wider than the ring takes.
    for n, h, label in ((1003, STREAM_NUM_HOT, "ring, odd rows"),
                        (1003, 64, "ring, odd rows"),
                        (1003, 96, "ring, odd rows"),
                        (1030, 192, "ring, odd rows"),
                        (1030, 516, "ring, odd rows"),
                        (777, 4000, "ring, odd rows"),
                        (515, sf.MAX_COLUMNS, "ring, odd rows"),
                        (2048, sf.MAX_COLUMNS + 4, "wide")):
        X = torch.randn((n, h), generator=gen, device="cuda")
        X[torch.rand((n, h), generator=gen, device="cuda") < 0.6] = 0.0
        w, b, rr = (torch.randn(s, generator=gen, device="cuda")
                    for s in (h, n, n))
        rows.append(check_stream_kernel(torch, sf, "hot_margins", X, w, b,
                                        label, False))
        if label != "wide":
            rows[-1]["bits_equal_ring_route"] = bool(torch.equal(
                sf.hot_margins(misaligned_copy(torch, X), w, b),
                sf.hot_margins(X, w, b)))
        rows.append(check_stream_kernel(torch, sf, "hot_rmatvec", X, rr,
                                        None, label, False))
    for n, h, integer in ((1000, 37, False), (STREAM_CHUNK_ROWS // 4,
                                                STREAM_NUM_HOT, True)):
        lo, hi = (-8, 9) if integer else (-127, 128)
        codes = torch.randint(lo, hi, (n, h), generator=gen, device="cuda")
        codes[torch.rand((n, h), generator=gen, device="cuda") < 0.6] = 0
        if integer:
            vecs = [torch.randint(-4, 5, (s,), generator=gen,
                                  device="cuda").float() for s in (h, n, n)]
        else:
            vecs = [torch.randn(s, generator=gen, device="cuda")
                    for s in (h, n, n)]
        w, b, rr = vecs
        label = "integer" if integer else "ragged"
        for X in (codes.to(torch.int8), codes.float() * (1.0 if integer
                                                         else 0.01),
                  (codes.float() * (1.0 if integer else 0.01)).bfloat16()):
            rows.append(check_stream_kernel(torch, sf, "hot_margins", X, w,
                                            b, label, False, integer))
            rows.append(check_stream_kernel(torch, sf, "hot_rmatvec", X, rr,
                                            None, label, False, integer))
    emit("kernels", kernel="stream_fused", checks=len(rows), shapes=rows)
    # Each float32 block on the route its shape picks.
    want = {"main": "ring", "main, misaligned copy": "direct",
            "ring, odd rows": "ring", "ragged": "direct", "wide": "direct"}
    expected = [want.get(c["shape"]) if c["dtype"] == "float32"
                else "direct" for c in rows]
    wrong = [(c["kernel"], c["shape"], c["dtype"], c["route"])
             for c, e in zip(rows, expected) if e not in (None, c["route"])]
    if wrong or not all(c.get("bits_equal_ring_route", True)
                        for c in rows):
        raise AssertionError(
            f"stream_fused: float32 routes {wrong} (expected {want}); "
            f"hot_margins on the direct route the ring's bits: "
            f"{[c.get('bits_equal_ring_route') for c in rows]}")
    return rows


# -- stream_parity ---------------------------------------------------------

class StreamEvaluationLog:
    """Records every streamed value-and-gradient pass while it is open:
    the coordinate builds its pass with
    ``ops.streaming_sparse.make_value_and_gradient``, and each (iterate,
    offsets, value, gradient) is kept on the host."""

    def __init__(self, ss):
        self.ss = ss
        self.inner = ss.make_value_and_gradient
        self.calls = []

    def __enter__(self):
        def make(*args, **kwargs):
            vg = self.inner(*args, **kwargs)

            def recorded(w, offsets=None):
                value, grad = vg(w, offsets)
                self.calls.append((w.cpu(), None if offsets is None
                                   else offsets.cpu(), value.cpu(),
                                   grad.cpu()))
                return value, grad

            return recorded

        self.ss.make_value_and_gradient = make
        return self

    def __exit__(self, *exc):
        self.ss.make_value_and_gradient = self.inner


class RouteLog:
    """Counts the routes stream_fused's wrappers take while it is open:
    each wrapper asks ``route`` once a launch on the card."""

    def __init__(self, sf):
        self.sf = sf
        self.inner = sf.route
        self.counts = {}

    def __enter__(self):
        def counted(X):
            taken = self.inner(X)
            self.counts[taken] = self.counts.get(taken, 0) + 1
            return taken

        self.sf.route = counted
        return self

    def __exit__(self, *exc):
        self.sf.route = self.inner


def phase_stream_parity(np, torch, card: str, parity: dict) -> dict:
    """sparse_parity's 300,000 rows streamed on the card, in chunks of
    STREAM_PARITY_CHUNK_ROWS with two pinned: against the resident fit
    after PARITY_EARLY_ITERATIONS iterations (every coefficient within
    PARITY_TOL), every streamed evaluation replayed on the CPU, and int8
    storage's validation AUC against float32's. hot_margins and
    hot_rmatvec launches are read around the two float32 fits alone
    (chunks times passes, every one on the ring route); returns them."""
    from photon_ml_torch.ops import streaming_sparse as ss
    from photon_ml_torch.ops.kernels import stream_fused as sf

    train, val = parity["train"], parity["val"]

    def fit(dtype, iterations, log=None):
        est = sparse_estimator("cuda", iterations=iterations,
                               streaming=stream_config(
                                   dtype, STREAM_PARITY_CHUNK_ROWS, 2))
        if log is None:
            result, seconds = timed_fit(torch, est, train, val, "cuda")
        else:
            with log:
                result, seconds = timed_fit(torch, est, train, val, "cuda")
        return (result.model.models["ctr"].coefficients.means.cpu(),
                result.evaluation.metrics["AUC"],
                result.history.records[-1]["solver"], seconds,
                est.coordinates["ctr"])

    log = StreamEvaluationLog(ss)
    sf.hot_margins.launches = 0  # the float32 fits' run starts
    sf.hot_rmatvec.launches = 0
    with RouteLog(sf) as routes:
        early = fit("float32", PARITY_EARLY_ITERATIONS, log)
        full_f32 = fit("float32", STREAM_ITERATIONS)
    f32_launches = {"hot_margins": sf.hot_margins.launches,  # ... and ends
                    "hot_rmatvec": sf.hot_rmatvec.launches}
    want = {"hot_margins": 0, "hot_rmatvec": 0}
    for c in (early[4], full_f32[4]):
        want["hot_margins"] += c.chunked.num_chunks * sum(
            c.stream.passes.values())
        want["hot_rmatvec"] += c.chunked.num_chunks * \
            c.stream.passes["value_grad"]
    if f32_launches != want or routes.counts != {
            "ring": sum(want.values())}:
        raise AssertionError(
            f"stream_parity: float32 launches {f32_launches}, expected "
            f"{want} (chunks times passes); routes {routes.counts}, "
            f"expected all on the ring")
    coord = early[4]
    replays = [replay_gaps(torch, value, grad, stream_replay(
        torch, coord.chunked, coord.loss, w, offsets))
        for w, offsets, value, grad in log.calls]
    full = {"float32": full_f32, "int8": fit("int8", STREAM_ITERATIONS)}
    early_diff = float((early[0] - parity["early_cuda"]).abs().max())
    auc_diff = abs(full["int8"][1] - full["float32"][1])
    replay = {"evaluations": len(replays),
              "value_rel_gap": max(r["value_rel_gap"] for r in replays),
              "gradient_column_ratio": max(r["gradient_column_ratio"]
                                           for r in replays)}
    emit("stream_parity", card=card, rows=train.num_rows,
         chunks=coord.chunked.num_chunks,
         chunk_rows=STREAM_PARITY_CHUNK_ROWS, pinned_chunks=2,
         early_iterations=PARITY_EARLY_ITERATIONS,
         early_coefficient_max_diff_vs_resident=early_diff,
         replay=replay, auc={k: v[1] for k, v in full.items()},
         int8_auc_diff=auc_diff,
         solver={"early float32": early[2],
                 **{k: v[2] for k, v in full.items()}},
         fit_seconds={"early float32": early[3],
                      **{k: v[3] for k, v in full.items()}},
         float32_launches=f32_launches, float32_routes=routes.counts,
         tolerance=PARITY_TOL)
    if replay["evaluations"] != early[2]["gradient_evaluations"]:
        raise AssertionError(
            f"stream_parity: recorded {replay['evaluations']} streamed "
            f"evaluations, the solver reports "
            f"{early[2]['gradient_evaluations']}")
    if not (early_diff <= PARITY_TOL and auc_diff <= PARITY_TOL
            and replay["value_rel_gap"] <= REPLAY_VALUE_RTOL
            and replay["gradient_column_ratio"] <= 1.0):
        raise AssertionError(
            f"stream_parity: coefficients after {PARITY_EARLY_ITERATIONS} "
            f"iterations {early_diff} from the resident fit and int8 AUC "
            f"{auc_diff} from float32 (limit {PARITY_TOL}); replay "
            f"{replay}")
    return {"launches": f32_launches, "routes": routes.counts}


# -- hybrid_train ----------------------------------------------------------

def host_available_bytes() -> int:
    """MemAvailable from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def hybrid_reckoning(np, torch, train, rows: int,
                     feature_dtype=None) -> dict:
    """What staging the first ``rows`` rows in the hybrid layout needs,
    from the column counts (the layout's own rule: hot at max(8,
    rows/2048) entries for a float32 block, max(8, rows/4096) for a
    bfloat16 one, at most 4,096 columns; cold columns in power-of-two
    classes), beside the card's and the host's memory."""
    from photon_ml_torch.ops import hybrid_sparse as hs

    dtype = feature_dtype or torch.float32
    shard = train.feature_shards["global"]
    idx, val = shard.indices[:rows], shard.values[:rows]
    d = shard.num_features
    counts = np.bincount(idx[(idx < d) & (val != 0.0)], minlength=d)
    desc = np.sort(counts)[::-1]
    k = int(min(4096, (counts >= hs._default_hot_threshold(rows, dtype))
                .sum()))
    cold = desc[k:][desc[k:] > 0]
    cls = np.ceil(np.log2(np.maximum(cold, 1))).astype(np.int64)
    kinds, per = np.unique(cls, return_counts=True)
    align = hs.hot_align(dtype)
    k_pad = -(-k // align) * align
    itemsize = torch.empty((), dtype=dtype).element_size()
    free, total = torch.cuda.mem_get_info()
    return {
        "rows": rows, "feature_dtype": str(dtype).replace("torch.", ""),
        "num_hot": k, "hot_block_bytes": rows * k_pad * itemsize,
        "cold_classes": int(kinds.size),
        "cold_slots": int((per * (1 << kinds)).sum()),
        "cold_entries": int(cold.sum()), "live_entries": int(counts.sum()),
        # Host staging holds a few flat (rows·slots,) arrays at once (row
        # ids, permuted columns, masks), about 16 bytes a slot; the card
        # holds the hot block beside the ELL fit's batch and layout.
        "host_staging_bytes": rows * SPARSE_NNZ * 16,
        "device_bytes": rows * k_pad * itemsize + rows * SPARSE_NNZ * 16,
        "card_free_bytes": free, "card_total_bytes": total,
        "host_available_bytes": host_available_bytes()}


class StagingClock:
    """While open, times build_hybrid's device fill of the hot block and
    its scatter layout of the cold row ids (each ended by a device
    synchronize); the rest of staging is the host layout."""

    def __init__(self, torch, hs):
        self.torch, self.hs = torch, hs
        self.inner = (hs._fill_hot, hs._cold_layout)
        self.seconds = {"device_fill": 0.0, "cold_layout": 0.0}

    def _timed(self, key, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        self.hs._fill_hot = self._timed("device_fill", self.inner[0])
        self.hs._cold_layout = self._timed("cold_layout", self.inner[1])
        return self

    def __exit__(self, *exc):
        self.hs._fill_hot, self.hs._cold_layout = self.inner


def residual(torch, loss, z, batch):
    """The row terms w·dl of a gradient at margins ``z`` (zero weight →
    zero)."""
    _, dl = loss.loss_and_dz(z, batch.labels)
    return torch.where(batch.weights > 0, batch.weights * dl,
                       torch.zeros_like(dl))


def objective_gap(torch, hs, sagg, es, loss, hb, batch, w) -> dict:
    """The hybrid and ELL objectives at one original-space iterate ``w``:
    the value's relative gap, and the worst gradient column against
    COLUMN_TOL · Σ|r·x| + REPLAY_ROW_ABS · Σ w·|x| (sparse_parity's
    allowance), the hybrid gradient mapped back to original space."""
    v_h, g_h = hs.value_and_gradient(loss, hs.to_permuted_space(hb, w), hb)
    g_h = hs.to_original_space(hb, g_h)
    v_e, g_e = sagg.value_and_gradient(loss, w, batch)
    r = residual(torch, loss, sagg.margins(batch, w), batch)
    w_pos = torch.where(batch.weights > 0, batch.weights,
                        torch.zeros_like(r))
    allowed = es.scatter_rowterm_reference(
        batch.indices, (COLUMN_TOL * r.abs() + REPLAY_ROW_ABS * w_pos)
        [:, None] * batch.values.abs(), batch.num_features)
    gap = {"value_rel_gap": abs(float(v_h - v_e)) / abs(float(v_e)),
           "gradient_column_ratio": column_ratio(torch, g_h, g_e, allowed)}
    del r, allowed, g_h, g_e
    return gap


def phase_hybrid_train(np, torch, card: str, train, val) -> dict:
    """Config 5's default one-device layout: the first HYBRID_ROWS of the
    9.5M training rows (or HYBRID_ROWS_CUT, where the host or the card
    cannot hold what staging needs) through GameEstimator.fit with a
    default FixedEffectDataConfiguration, then the same rows on the ELL
    layout in the same process."""
    from photon_ml_torch.ops import hybrid_sparse as hs
    from photon_ml_torch.ops import sparse_aggregators as sagg
    from photon_ml_torch.ops.kernels import cold_grad as cg
    from photon_ml_torch.ops.kernels import ell_scatter as es
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.ops.kernels import stream_fused as sf

    t0 = time.perf_counter()
    plan = hybrid_reckoning(np, torch, train, HYBRID_ROWS)
    cut = None
    if plan["host_staging_bytes"] > plan["host_available_bytes"] \
            or plan["device_bytes"] > plan["card_free_bytes"]:
        cut = (f"{HYBRID_ROWS} rows need {plan['host_staging_bytes']} host "
               f"and {plan['device_bytes']} card bytes; "
               f"{plan['host_available_bytes']} and "
               f"{plan['card_free_bytes']} are free")
        plan = hybrid_reckoning(np, torch, train, HYBRID_ROWS_CUT)
    emit("hybrid_reckoning", card=card, **plan, cut=cut,
         seconds=time.perf_counter() - t0)
    rows = plan["rows"]
    data = train.subset(slice(0, rows))
    counters = {"hot_value_and_gradient": hp.hot_value_and_gradient,
                "hot_hessian_vector": hp.hot_hessian_vector,
                "hot_margins": sf.hot_margins, "hot_rmatvec": sf.hot_rmatvec,
                "cold_grad": cg.cold_grad,
                "ell_scatter": es.scatter_rowterm}
    est = sparse_estimator("cuda", hybrid=None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():  # the hybrid path's run starts
        fn.launches = 0
    with StagingClock(torch, hs) as clock:
        result, fit_s = timed_fit(torch, est, data, val, "cuda")
    launches = {k: fn.launches for k, fn in counters.items()}  # ... ends
    peak = torch.cuda.max_memory_allocated()
    fit = check_sparse_fit(torch, result, "hybrid_train")
    coord = est.coordinates["ctr"]
    hb = coord.staged
    classes = len(hb.cold_rowids)
    evals = fit["gradient_evaluations"]
    # Each evaluation is one hot_value_and_gradient pass over the hot
    # block, one cold_grad launch over every class and one ell_scatter
    # launch for the cold margins. The descent scores the coordinate twice
    # (before and after the update): two margins passes, each one
    # hot_margins and one ell_scatter launch.
    want = {"hot_value_and_gradient": evals, "hot_hessian_vector": 0,
            "hot_margins": 2, "hot_rmatvec": 0, "cold_grad": evals,
            "ell_scatter": evals + 2}
    if not coord.hybrid or hb.num_hot != plan["num_hot"] \
            or classes != plan["cold_classes"] or launches != want:
        raise AssertionError(
            f"hybrid_train: launches {launches}, expected {want} for "
            f"{evals} evaluations and {classes} classes (num_hot "
            f"{hb.num_hot}, reckoned {plan['num_hot']})")
    w = result.model.models["ctr"].coefficients.means
    w_perm = hs.to_permuted_space(hb, w)
    (v1, g1), _ = synced_seconds(
        torch, lambda: hs.value_and_gradient(coord.loss, w_perm, hb))
    (v2, g2), _ = synced_seconds(
        torch, lambda: hs.value_and_gradient(coord.loss, w_perm, hb))
    if not (torch.equal(v1, v2) and torch.equal(g1, g2)):
        raise AssertionError("hybrid_train: two value-and-gradient passes "
                             "at the same iterate differ")
    del g1, g2
    v_perm = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=hb.num_features).astype(np.float32)).cuda()
    fused = check_hot_pass(torch, hs, hp, coord.loss, hb, w_perm, v_perm)
    hybrid_eval_ms = call_ms(torch, lambda: hs.value_and_gradient(
        coord.loss, w_perm, hb), reps=5, inner=3)
    hybrid_hv_ms = call_ms(torch, lambda: hs.hessian_vector(
        coord.loss, w_perm, v_perm, hb), reps=5, inner=3)
    hot = hot_block_times(torch, hs, sf, hp, coord.loss, hb, w_perm, v_perm)

    # The same rows on the ELL layout, in this process.
    ell_est = sparse_estimator("cuda", hybrid=False)
    es.ell_rmatvec.launches = 0  # the ELL run starts
    es.scatter_rowterm.launches = 0
    ell_result, ell_fit_s = timed_fit(torch, ell_est, data, val, "cuda")
    ell_launches = es.ell_rmatvec.launches  # ... and ends
    ell_generic = es.scatter_rowterm.launches
    ell = check_sparse_fit(torch, ell_result, "hybrid_train, ELL")
    if ell_launches != ell["gradient_evaluations"] or ell_generic:
        raise AssertionError(
            f"hybrid_train ELL: ell_rmatvec launched {ell_launches} times "
            f"for {ell['gradient_evaluations']} gradient evaluations, "
            f"scatter_rowterm {ell_generic} times")
    batch = ell_est.coordinates["ctr"].staged
    ell_eval_ms = call_ms(torch, lambda: sagg.value_and_gradient(
        coord.loss, w, batch), reps=5, inner=3)
    gap = objective_gap(torch, hs, sagg, es, coord.loss, hb, batch, w)
    emit("hybrid_train", card=card, rows=rows, val_rows=val.num_rows,
         dim=hb.num_features, slots=SPARSE_NNZ, num_hot=hb.num_hot,
         hot_block_columns=int(hb.X_hot.shape[1]), cold_classes=classes,
         class_shapes=[list(r.shape) for r in hb.cold_rowids],
         cold_slots=int(hb.cold_flat_rowids.numel()),
         cold_present_columns=hb.num_cold_present,
         staging_seconds={
             "total": coord.staging_seconds,
             "host_layout": coord.staging_seconds
             - sum(clock.seconds.values()), **clock.seconds},
         fit_seconds=fit_s, lbfgs=fit, launches=launches,
         max_memory_allocated=peak,
         ms_per_evaluation={"hybrid": hybrid_eval_ms, "ell": ell_eval_ms},
         ms_per_hessian_vector={"hybrid": hybrid_hv_ms},
         hot_pass_checks=fused, hot_block=hot,
         ell={**ell, "fit_seconds": ell_fit_s, "launches": ell_launches},
         auc={"hybrid": fit["auc"], "ell": ell["auc"]},
         auc_diff=abs(fit["auc"] - ell["auc"]), objective_gap=gap)
    if not (gap["value_rel_gap"] <= REPLAY_VALUE_RTOL
            and gap["gradient_column_ratio"] <= 1.0):
        raise AssertionError(f"hybrid_train: the hybrid and ELL objectives "
                             f"differ at the final iterate: {gap}")
    return {"coord": coord, "w_perm": w_perm, "launches": launches,
            "ell_launches": ell_launches, "rows": rows, "hot": hot,
            "hot_pass_checks": fused}


def phase_hybrid_bf16_train(np, torch, card: str, train, val,
                            ell: dict) -> dict:
    """Config 5's one-device default layout in bfloat16 at full size: all
    of sparse_train's training rows (9.5M) through GameEstimator.fit with
    FixedEffectDataConfiguration(feature_dtype="bfloat16"), after a
    reckoning that fails the phase where the block cannot fit; beside it
    the ELL fit of the same rows (sparse_train's)."""
    from photon_ml_torch.ops import hybrid_sparse as hs
    from photon_ml_torch.ops.kernels import cold_grad as cg
    from photon_ml_torch.ops.kernels import ell_scatter as es
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.ops.kernels import stream_fused as sf

    t0 = time.perf_counter()
    rows = train.num_rows
    plan = hybrid_reckoning(np, torch, train, rows, torch.bfloat16)
    emit("hybrid_bf16_reckoning", card=card, **plan,
         seconds=time.perf_counter() - t0)
    if plan["host_staging_bytes"] > plan["host_available_bytes"] \
            or plan["device_bytes"] > plan["card_free_bytes"]:
        raise AssertionError(
            f"hybrid_bf16_train: {rows} rows need "
            f"{plan['host_staging_bytes']} host and {plan['device_bytes']} "
            f"card bytes; {plan['host_available_bytes']} and "
            f"{plan['card_free_bytes']} are free")
    counters = {"hot_value_and_gradient": hp.hot_value_and_gradient,
                "hot_hessian_vector": hp.hot_hessian_vector,
                "hot_margins": sf.hot_margins, "hot_rmatvec": sf.hot_rmatvec,
                "cold_grad": cg.cold_grad,
                "ell_scatter": es.scatter_rowterm}
    est = sparse_estimator("cuda", hybrid=None, feature_dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():  # the bfloat16 hybrid path's run starts
        fn.launches = 0
    with StagingClock(torch, hs) as clock:
        result, fit_s = timed_fit(torch, est, train, val, "cuda")
    launches = {k: fn.launches for k, fn in counters.items()}  # ... ends
    peak = torch.cuda.max_memory_allocated()
    fit = check_sparse_fit(torch, result, "hybrid_bf16_train")
    coord = est.coordinates["ctr"]
    hb = coord.staged
    evals = fit["gradient_evaluations"]
    want = {"hot_value_and_gradient": evals, "hot_hessian_vector": 0,
            "hot_margins": 2, "hot_rmatvec": 0, "cold_grad": evals,
            "ell_scatter": evals + 2}
    if not coord.hybrid or hb.X_hot.dtype != torch.bfloat16 \
            or hb.num_hot != plan["num_hot"] or launches != want:
        raise AssertionError(
            f"hybrid_bf16_train: launches {launches}, expected {want} for "
            f"{evals} evaluations (X_hot {hb.X_hot.dtype}, num_hot "
            f"{hb.num_hot}, reckoned {plan['num_hot']})")
    w = result.model.models["ctr"].coefficients.means
    w_perm = hs.to_permuted_space(hb, w)
    (v1, g1), _ = synced_seconds(
        torch, lambda: hs.value_and_gradient(coord.loss, w_perm, hb))
    (v2, g2), _ = synced_seconds(
        torch, lambda: hs.value_and_gradient(coord.loss, w_perm, hb))
    same_bits = bool(torch.equal(v1, v2) and torch.equal(g1, g2))
    del g1, g2
    v_perm = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=hb.num_features).astype(np.float32)).cuda()
    fused = check_hot_pass(torch, hs, hp, coord.loss, hb, w_perm, v_perm)
    eval_ms = call_ms(torch, lambda: hs.value_and_gradient(
        coord.loss, w_perm, hb), reps=5, inner=3)
    a = hot_pass_inputs(hs, hb, w_perm, v_perm)
    hot = fused_pass_times(torch, hs, sf, hp, coord.loss, hb, a)
    # What holds the pass back, in both modes: ring shapes and the pass
    # without its transposed product.
    for name, times in hot_pass_attribution(
            torch, hp, coord.loss, a, ((8, 2), (8, 4), (4, 4)),
            (False, True)).items():
        hot[name].update(times)
    del a
    tron = hybrid_bf16_tron(torch, coord, hb, w_perm, counters)
    emit("hybrid_bf16_train", card=card, rows=rows, val_rows=val.num_rows,
         dim=hb.num_features, slots=SPARSE_NNZ, feature_dtype="bfloat16",
         num_hot=hb.num_hot, hot_block_columns=int(hb.X_hot.shape[1]),
         hot_block_bytes=hb.X_hot.numel() * hb.X_hot.element_size(),
         cold_classes=len(hb.cold_rowids),
         cold_slots=int(hb.cold_flat_rowids.numel()),
         staging_seconds={
             "total": coord.staging_seconds,
             "host_layout": coord.staging_seconds
             - sum(clock.seconds.values()), **clock.seconds},
         fit_seconds=fit_s, lbfgs=fit, launches=launches,
         max_memory_allocated=peak, two_passes_same_bits=same_bits,
         ms_per_evaluation={"hybrid_bf16": eval_ms, "ell": ell["eval_ms"]},
         auc={"hybrid_bf16": fit["auc"], "ell": ell["auc"]},
         auc_diff=abs(fit["auc"] - ell["auc"]), ell=ell,
         hot_pass_checks=fused, hot_block=hot, tron=tron)
    if not same_bits:
        raise AssertionError("hybrid_bf16_train: two value-and-gradient "
                             "passes at the same iterate differ")
    del coord, hb, est, result
    return {"launches": launches, "rows": rows, "hot": hot,
            "hot_pass_checks": fused, "eval_ms": eval_ms, "tron": tron}


def hybrid_bf16_tron(torch, coord, hb, w_lbfgs, counters: dict) -> dict:
    """TRON_BF16_ITERATIONS TRON iterations on the staged bfloat16 block
    (sparse_problem.run_hybrid over coord.staged, from zero: a second
    9.5M-row block would not fit the card), with the launches read around
    the solve; its objective beside the L-BFGS fit's at that fit's final
    iterate ``w_lbfgs`` (permuted space)."""
    import dataclasses

    from photon_ml_torch.optim import sparse_problem, with_l2
    from photon_ml_torch.optim.problem import VarianceComputationType
    from photon_ml_torch.optim.regularization import intercept_mask

    cfg = dataclasses.replace(
        sparse_estimator(hb.device.type, "TRON", TRON_BF16_ITERATIONS)
        .coordinate_configs["ctr"].optimization,
        variance_computation=VarianceComputationType.NONE)
    stats = sparse_problem.SolveStats()
    torch.cuda.synchronize()
    for fn in counters.values():  # the TRON solve starts
        fn.launches = 0
    t0 = time.perf_counter()
    _, res = sparse_problem.run_hybrid(
        coord.loss, hb, cfg, intercept_index_permuted=coord._ii_perm,
        stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}  # ... ends
    evals, products = stats.gradient_evaluations, \
        stats.hessian_vector_products
    want = {"hot_value_and_gradient": evals, "hot_hessian_vector": products,
            "cold_grad": evals + products, "hot_rmatvec": 0}
    got = {k: launches[k] for k in want}
    mask = torch.as_tensor(intercept_mask(hb.num_features, coord._ii_perm),
                           device=hb.device)
    vg = with_l2(sparse_problem.make_value_and_gradient(coord.loss, hb),
                 cfg.regularization.l2_weight(), mask)
    lbfgs_value = float(vg(w_lbfgs[None])[0][0])
    out = {"iterations": int(res.iterations[0]),
           "gradient_evaluations": evals,
           "hessian_vector_products": products, "solve_seconds": seconds,
           "launches": launches, "objective": float(res.value[0]),
           "lbfgs_objective": lbfgs_value}
    if got != want or products == 0 or not math.isfinite(out["objective"]):
        raise AssertionError(f"hybrid_bf16_train TRON: launches {launches}, "
                             f"expected {want} ({out})")
    return out


def hot_pass_inputs(hs, hb, w_perm, v_perm) -> dict:
    """The hybrid block's hot_pass arguments at one iterate and direction
    (the cold margins computed as the objective computes them)."""
    return {"X": hb.X_hot, "w_hot": hs._hot_weights(hb, w_perm),
            "v_hot": hs._hot_weights(hb, v_perm),
            "cold_z": hs._cold_margins(hb, w_perm),
            "cold_zv": hs._cold_margins(hb, v_perm), "offsets": hb.offsets,
            "labels": hb.labels, "weights": hb.weights}


def bf16_flip(torch, r, w_pos):
    """(n,) the bfloat16 step of each r_i whose rounding to bfloat16 a
    move of REPLAY_ROW_ABS · w_i (the row terms' own resolution, as
    sparse_parity allows it) can change, else 0. Two computations of r
    that agree to that resolution round it to the same bfloat16 value
    except on these rows, where they may land one step apart."""
    rb = r.to(torch.bfloat16).float()
    top = torch.maximum(r.abs(), rb.abs())
    step = torch.ldexp(torch.ones_like(r),
                       torch.frexp(top).exponent - 8)
    to_midpoint = step / 2 - (r - rb).abs()
    near = (to_midpoint <= REPLAY_ROW_ABS * w_pos) & (top > 0) \
        & torch.isfinite(r)
    return torch.where(near, step, torch.zeros_like(r))


def exact_rmatvec(torch, X, r, block_rows: int = 262_144, extra=None):
    """float64 rᵀX and |r|ᵀ|X| (and extraᵀ|X|), in blocks of rows (the
    block is too large for a float64 copy)."""
    exact = torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    mag = torch.zeros_like(exact)
    more = torch.zeros_like(exact)
    for i0 in range(0, X.shape[0], block_rows):
        Xd = X[i0:i0 + block_rows].double()
        rd = r[i0:i0 + block_rows].double()
        exact += rd @ Xd
        Xd = Xd.abs_()
        mag += rd.abs() @ Xd
        if extra is not None:
            more += extra[i0:i0 + block_rows].double() @ Xd
        del Xd
    return exact, mag, more


def blocked_plain(torch, hp, args: tuple, hessian: bool,
                  block_rows: int):
    """The plain version of hot_value_and_gradient (or, ``hessian``,
    hot_hessian_vector) over row blocks of its (n, H) block, the hot
    gradients of the blocks added in order: where the whole block's
    float32 copy would not fit on the card."""
    X = args[0]
    n = X.shape[0]
    rows_at = (3, 4, 5, 6, 7) if hessian else (2, 3, 4, 5)
    g = None
    for i0 in range(0, n, block_rows):
        part = list(args)
        part[0] = X[i0:i0 + block_rows]
        for k in rows_at:
            if part[k] is not None:
                part[k] = part[k][i0:i0 + block_rows]
        fn = (hp.hot_hessian_vector_reference if hessian
              else hp.hot_value_and_gradient_reference)
        out = fn(*part)[-1]
        g = out if g is None else g + out
    return g


def check_hot_pass(torch, hs, hp, loss, hb, w_perm, v_perm) -> dict:
    """hot_pass on the hybrid block at one iterate and direction: z (and
    for H·v, xv) bit for bit the two-kernel route's (hybrid_sparse.margins
    and margins(v) − offsets, through stream_fused.hot_margins), the
    hybrid value bit for bit the value from that route's margins, every
    g_hot column within COLUMN_TOL · Σ|terms| of its float64 sum,
    parity_rel within PARITY_REL against the plain version, and the same
    bits on two launches. Over a bfloat16 block the float64 sums take the
    same rounded operands (w, v and r rounded to bfloat16), each column
    also allowing one bfloat16 step of r on the rows where r lies within
    its own resolution of a rounding midpoint (bf16_flip), and the plain
    version runs over blocks of BF16_CHECK_ROWS rows."""
    from photon_ml_torch.ops.kernels import stream_fused as sf

    a = hot_pass_inputs(hs, hb, w_perm, v_perm)
    bf16 = a["X"].dtype == torch.bfloat16
    block_rows = BF16_CHECK_ROWS if bf16 else 262_144
    vg = (a["X"], a["w_hot"], a["offsets"], a["cold_z"], a["labels"],
          a["weights"], loss)
    hv = (a["X"], a["w_hot"], a["v_hot"], a["offsets"], a["cold_z"],
          a["cold_zv"], a["labels"], a["weights"], loss)
    z_route = hs.margins(hb, w_perm)
    xv_route = hs.margins(hb, v_perm) - hb.offsets
    l, _ = loss.loss_and_dz(z_route, hb.labels)
    value_route = torch.sum(hs._masked(hb.weights, l))
    value, _ = hs.value_and_gradient(loss, w_perm, hb)
    r_g = residual(torch, loss, z_route, hb)
    r_h = hs._masked(hb.weights, loss.d2z(z_route, hb.labels)) * xv_route
    z1, g1 = hp.hot_value_and_gradient(*vg)
    z2, g2 = hp.hot_value_and_gradient(*vg)
    hz1, xv1, h1 = hp.hot_hessian_vector(*hv)
    hz2, xv2, h2 = hp.hot_hessian_vector(*hv)
    torch.cuda.synchronize()
    bits = {"z": torch.equal(z1, z_route) and torch.equal(z2, z_route),
            "value": torch.equal(value, value_route),
            "hessian_vector z": torch.equal(hz1, z_route)
            and torch.equal(hz2, z_route),
            "xv": torch.equal(xv1, xv_route) and torch.equal(xv2, xv_route),
            "two launches": torch.equal(g1, g2) and torch.equal(h1, h2)}
    del z1, z2, hz1, hz2, xv1, xv2, g2, h2, z_route, xv_route
    out = {"bits": bits}
    w_pos = torch.where(hb.weights > 0, hb.weights,
                        torch.zeros_like(hb.weights))
    for name, got, r, plain in (
            ("hot_value_and_gradient", g1, r_g,
             lambda: hp.hot_value_and_gradient_reference(*vg)[1]),
            ("hot_hessian_vector", h1, r_h,
             lambda: hp.hot_hessian_vector_reference(*hv)[2])):
        flip = bf16_flip(torch, r, w_pos) if bf16 else None
        exact, mag, more = exact_rmatvec(
            torch, a["X"], sf.rounded_like(a["X"], r), block_rows, flip)
        if bf16:
            want = blocked_plain(torch, hp, vg if name.endswith("gradient")
                                 else hv, name == "hot_hessian_vector",
                                 block_rows)
        else:
            want = plain()
        err = float((got - want).abs().max())
        out[name] = {
            "column_ratio": column_ratio(torch, got.double(), exact,
                                         COLUMN_TOL * mag + more),
            "max_abs_err": err,
            "parity_rel": err / max(float(want.abs().max()), 1e-9)}
        if bf16:
            out[name]["flip_rows"] = int((flip > 0).sum())
        del exact, mag, more, want
    if not all(bits.values()) or any(
            out[k]["column_ratio"] > 1.0 or out[k]["parity_rel"] > PARITY_REL
            for k in ("hot_value_and_gradient", "hot_hessian_vector")):
        raise AssertionError(f"hot_pass on the {a['X'].dtype} hybrid "
                             f"block: {out}")
    return out


# csrc/hot_pass.cu's timing builds, by define: the nvcc process started
# beside the package's build, then the loaded library.
_variants: dict = {}
TIMING_DEFINE = "HOT_PASS_TIMING_NO_TRANSPOSE"


def start_hot_pass_variant(define: str) -> None:
    """Start nvcc on csrc/hot_pass.cu with -D``define`` into the package's
    build directory, so it compiles while the package's kernels do."""
    from photon_ml_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, f"libhot_pass-{define}.so")
    _variants[define] = (lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-D{define}", "-o", lib,
         os.path.join(_build.SRC_DIR, "hot_pass.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


def stop_hot_pass_variants() -> None:
    """Ends any timing build still running (the script failed first)."""
    for entry in _variants.values():
        if isinstance(entry, tuple) and entry[1].poll() is None:
            entry[1].kill()
            entry[1].wait()


def hot_pass_variant(torch, hp, define: str, dtype):
    """The timing build of csrc/hot_pass.cu with ``define`` (started by
    start_hot_pass_variant), its C entry for ``dtype`` blocks typed as the
    package's."""
    import ctypes

    if isinstance(_variants[define], tuple):
        lib, proc = _variants[define]
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -D{define} csrc/hot_pass.cu failed "
                               f"(exit {proc.returncode}):\n{err}")
        _variants[define] = ctypes.CDLL(lib)
    hp.load()
    fn = getattr(_variants[define], hp.ENTRIES[dtype])
    entry = hp._launchers[dtype]
    fn.argtypes, fn.restype = entry.argtypes, entry.restype
    return fn


def raw_hot_pass(torch, hp, fn, a, loss, rows: int, stages: int,
                 hessian: bool = False):
    """One value-and-gradient (or, ``hessian``, H·v) launch through the C
    entry ``fn`` with the ring geometry given (the package picks it with
    ring_shape)."""
    X = a["X"]
    n, h = (int(x) for x in X.shape)
    z = torch.empty(n, dtype=torch.float32, device=X.device)
    xv = torch.empty(n, dtype=torch.float32, device=X.device) \
        if hessian else None
    groups = -(-n // hp.ROW_GROUP)
    partial = torch.empty((groups, h), dtype=torch.float32, device=X.device)
    g = torch.empty(h, dtype=torch.float32, device=X.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(X.data_ptr(), a["w_hot"].data_ptr(),
             ptr(a["v_hot"]) if hessian else None, a["offsets"].data_ptr(),
             ptr(a["cold_z"]), ptr(a["cold_zv"]) if hessian else None,
             a["labels"].data_ptr(), a["weights"].data_ptr(), z.data_ptr(),
             ptr(xv), partial.data_ptr(), g.data_ptr(), n, h, rows, stages,
             groups, hp.LOSSES.index(loss.name),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hot_pass ({rows} rows, {stages} stages): CUDA "
                           f"error {err}")
    return z, g


def hot_pass_attribution(torch, hp, loss, a: dict, shapes, modes) -> dict:
    """What holds the fused pass back at this block: each pass of
    ``modes`` (False: value and gradient, True: H·v) at each ring shape
    (rows, tiles) of ``shapes`` that fits a block, and at the package's
    shape without its transposed product (HOT_PASS_TIMING_NO_TRANSPOSE,
    a build of its own)."""
    X = a["X"]
    h = int(X.shape[1])
    itemsize = X.element_size()
    entry = hp._launchers[X.dtype]
    no_transpose = hot_pass_variant(torch, hp, TIMING_DEFINE, X.dtype)
    out = {}
    for hessian in modes:
        ring = {}
        for rows, stages in shapes:
            if hp.shared_bytes(h, rows, stages, hessian,
                               itemsize) <= hp.MAX_SHARED:
                ring[f"{rows}x{stages}"] = device_ms(
                    torch, lambda: raw_hot_pass(
                        torch, hp, entry, a, loss, rows, stages, hessian),
                    reps=5, inner=3)
        shape = hp.ring_shape(h, hessian, itemsize)
        out["hot_hessian_vector" if hessian else "hot_value_and_gradient"] = {
            "ring_ms": ring,
            "no_transpose_ms": device_ms(
                torch, lambda: raw_hot_pass(torch, hp, no_transpose, a, loss,
                                            *shape, hessian),
                reps=5, inner=3)}
    return out


def fused_pass_times(torch, hs, sf, hp, loss, hb, a: dict) -> dict:
    """The fused value-and-gradient pass and the fused H·v over the hot
    block (``a``: hot_pass_inputs), each against the two- and
    three-kernel routes they replace (old route, fused, fused, old route,
    in turns), the plain versions and the library route, beside its
    bound. The library route is torch.addmv and torch.mv on X.t() over a
    float32 block; over a bfloat16 one torch.mm with a float32 output, w,
    v and r rounded as the route rounds them, and the plain versions run
    over row blocks (the block's float32 copy does not fit the card).
    The library route's largest gap to the pass ("library_parity_rel")
    is reported: over a bfloat16 block an r rounded from margins summed
    in another order may land one bfloat16 step apart, which the kernel
    check allows and this ratio does not."""
    X, off, w_hot, v_hot = a["X"], a["offsets"], a["w_hot"], a["v_hot"]
    cz, czv, wt = a["cold_z"], a["cold_zv"], a["weights"]
    n, h = (int(x) for x in X.shape)
    bf16 = X.dtype == torch.bfloat16
    x_bytes = n * h * X.element_size()
    if bf16:
        def lib_margins(u):
            return torch.mm(X, u.to(torch.bfloat16)[:, None],
                            out_dtype=torch.float32)[:, 0] + off

        def lib_rmatvec(t):
            return torch.mm(t.to(torch.bfloat16)[None, :], X,
                            out_dtype=torch.float32)[0]

        lib_calls = ("torch.mm (float32 out)",
                     "torch.mm (float32 out) on the transpose")
    else:
        def lib_margins(u):
            return torch.addmv(off, X, u)

        def lib_rmatvec(t):
            return torch.mv(X.t(), t)

        lib_calls = ("torch.addmv", "torch.mv on X.t()")

    def gradient_route(margins_fn, rmatvec_fn):
        z = hs._plus(margins_fn(w_hot), cz)
        return rmatvec_fn(residual(torch, loss, z, hb))

    def hv_route(margins_fn, rmatvec_fn):
        z = hs._plus(margins_fn(w_hot), cz)
        xv = hs._plus(margins_fn(v_hot), czv) - off
        return rmatvec_fn(hs._masked(wt, loss.d2z(z, hb.labels)) * xv)

    # The route rounds r to bfloat16 over a bfloat16 block.
    kernels = (lambda u: sf.hot_margins(X, u, off),
               lambda t: sf.hot_rmatvec(X, sf.rounded_like(X, t)))
    library = (lib_margins, lib_rmatvec)
    vg = (X, w_hot, off, cz, a["labels"], wt, loss)
    hv = (X, w_hot, v_hot, off, cz, czv, a["labels"], wt, loss)
    out = {}
    # Bytes: X once and each (n,) and (H,) vector once (vg reads offsets,
    # cold_z, labels, weights and w and writes z and g; H·v also reads
    # cold_zv and v and writes xv); 4 n H (6 n H) float32 operations.
    for name, fused, old, lib, vectors, ops, hessian in (
            ("hot_value_and_gradient",
             lambda: hp.hot_value_and_gradient(*vg),
             lambda: gradient_route(*kernels),
             lambda: gradient_route(*library), 5 * n + 2 * h, 4 * n * h,
             False),
            ("hot_hessian_vector", lambda: hp.hot_hessian_vector(*hv),
             lambda: hv_route(*kernels), lambda: hv_route(*library),
             7 * n + 3 * h, 6 * n * h, True)):
        args = hv if hessian else vg
        nbytes = x_bytes + vectors * 4
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_FLOP_PER_S * 1e3
        got, want = fused()[-1], lib()
        parity = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-9)
        del got, want
        old_ms = [device_ms(torch, old, reps=5, inner=3)]
        fused_ms = [device_ms(torch, fused, reps=5, inner=3)
                    for _ in range(2)]
        old_ms.append(device_ms(torch, old, reps=5, inner=3))
        if bf16:
            plain_ms = 1e3 * synced_seconds(torch, lambda: blocked_plain(
                torch, hp, args, hessian, BF16_CHECK_ROWS))[1]
            plain_timing = (f"one call from Python, synchronised, over "
                            f"blocks of {BF16_CHECK_ROWS} rows")
        else:
            plain = (hp.hot_hessian_vector_reference if hessian
                     else hp.hot_value_and_gradient_reference)
            plain_ms = device_ms(torch, lambda: plain(*args), reps=5,
                                 inner=3)
            plain_timing = "graph replay"
        row = {"n": n, "H": h, "dtype": str(X.dtype).replace("torch.", ""),
               "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "ms": min(fused_ms), "ms_runs": fused_ms,
               "call_ms": call_ms(torch, fused, reps=5, inner=3),
               "old_route_ms": min(old_ms), "old_route_runs": old_ms,
               "old_route": ("hot_margins twice, the loss in torch, "
                             "hot_rmatvec" if hessian else
                             "hot_margins, the loss in torch, hot_rmatvec"),
               "plain_ms": plain_ms, "plain_timing": plain_timing,
               "library_ms": device_ms(torch, lib, reps=5, inner=3),
               "library_call": (f"{lib_calls[0]} twice + {lib_calls[1]}"
                                if hessian else
                                f"{lib_calls[0]} + {lib_calls[1]}"),
               "library_parity_rel": parity,
               "ring": dict(zip(("rows", "stages"), hp.ring_shape(
                   h, hessian, X.element_size())))}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out[name] = row
    return out


def hot_block_times(torch, hs, sf, hp, loss, hb, w_perm, v_perm) -> dict:
    """The hybrid fit's float32 hot block at its final iterate: the fused
    passes (fused_pass_times); hot_margins and hot_rmatvec alone (and the
    route they take) against torch.addmv and torch.mv on X.t(), each
    beside its bound; and, for what holds the pass back, the tile ring's
    depth against its time and the pass with its transposed product left
    out (a build of its own)."""
    a = hot_pass_inputs(hs, hb, w_perm, v_perm)
    X, off, w_hot = a["X"], a["offsets"], a["w_hot"]
    n, h = (int(x) for x in X.shape)
    x_bytes = n * h * 4
    r = residual(torch, loss, hs.margins(hb, w_perm), hb)
    out = {}
    for name, kernel, library, vectors in (
            ("hot_margins", lambda: sf.hot_margins(X, w_hot, off),
             lambda: torch.addmv(off, X, w_hot), h + 2 * n),
            ("hot_rmatvec", lambda: sf.hot_rmatvec(X, r),
             lambda: torch.mv(X.t(), r), n + h)):
        got, want = kernel(), library()
        nbytes = x_bytes + vectors * 4
        out[name] = {
            "n": n, "H": h, "route": sf.route(X),
            "parity_rel": float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-9),
            "ms": device_ms(torch, kernel, reps=5, inner=3),
            "library_ms": device_ms(torch, library, reps=5, inner=3),
            "library_call": ("torch.addmv" if name == "hot_margins"
                             else "torch.mv on X.t()"),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}
        del got, want
        if not out[name]["parity_rel"] <= PARITY_REL:
            raise AssertionError(f"hybrid_train {name}: parity_rel "
                                 f"{out[name]['parity_rel']} against "
                                 f"{out[name]['library_call']}")
    out.update(fused_pass_times(torch, hs, sf, hp, loss, hb, a))

    # What holds the pass back: the ring's depth, and the pass without
    # its transposed product (phase (c)), at this shape.
    times = hot_pass_attribution(
        torch, hp, loss, a, ((8, 2), (8, 3), (4, 2), (4, 4), (4, 6), (2, 8)),
        (False,))
    out["hot_value_and_gradient"].update(times["hot_value_and_gradient"])
    return out


# -- cold_grad kernels -----------------------------------------------------

def exact_cold(torch, r, rows, vals):
    """float64 value and Σ|terms| of each column of one class."""
    n = r.shape[0]
    g = torch.cat([r, r.new_zeros(1)]).double()[
        rows.long().clamp(min=0, max=n)]
    return (g * vals.double()).sum(1), (g * vals.double()).abs().sum(1)


def check_cold_grad(torch, cg, r, classes, label: str,
                    exact: bool = False, bf16: bool = False,
                    flat=None) -> dict:
    """The kernel against its plain version over ``classes`` [(rows,
    vals)]: one class through ``cold_grad``, several in one launch through
    ``cold_grad_classes`` over ``flat`` (rows, vals, table), the flat
    arrays they are views of (by default their concatenation). Within
    PARITY_REL of the plain version (bit for bit, and equal to the float64
    sum, when ``exact``), each column within COLUMN_TOL · Σ|terms| of its
    exact sum, the same bits on two launches; with ``bf16``, the column
    check shown to reject the kernel's sums over bfloat16-rounded inputs."""
    if len(classes) > 1 and flat is None:
        flat = (torch.cat([a.reshape(-1) for a, _ in classes]),
                torch.cat([b.reshape(-1) for _, b in classes]),
                cg.class_table([tuple(a.shape) for a, _ in classes]))

    def kernel(rr, cast=lambda v: v):
        if flat is None:
            return cg.cold_grad(rr, classes[0][0], cast(classes[0][1]))
        return cg.cold_grad_classes(rr, flat[0], cast(flat[1]), flat[2])

    got, again = kernel(r), kernel(r)
    want = torch.cat([cg.cold_grad_reference(r, a, b) for a, b in classes])
    true, mag = (torch.cat(t) for t in zip(
        *(exact_cold(torch, r, a, b) for a, b in classes)))
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    rel = err / max(float(want.abs().max()) if want.numel() else 0.0, 1e-9)
    ratio = column_ratio(torch, got.double(), true, COLUMN_TOL * mag)
    if not torch.equal(got, again):
        raise AssertionError(f"cold_grad {label}: two launches differ")
    if exact and not (torch.equal(got, want)
                      and torch.equal(got.double(), true)):
        raise AssertionError(f"cold_grad {label}: not bit-exact on integer "
                             f"inputs (max |err| {err})")
    if not (rel <= PARITY_REL and ratio <= 1.0):
        raise AssertionError(
            f"cold_grad {label}: parity_rel {rel} (limit {PARITY_REL}), "
            f"worst column at {ratio} of {COLUMN_TOL} · Σ|terms|")
    bf16_ratio = None
    if bf16:
        coarse = kernel(r.bfloat16().float(), lambda v: v.bfloat16().float())
        bf16_ratio = column_ratio(torch, coarse.double(), true,
                                  COLUMN_TOL * mag)
        if not bf16_ratio > 1.0:
            raise AssertionError(
                f"cold_grad {label}: the column check would pass sums of "
                f"bfloat16-rounded inputs (worst column at {bf16_ratio})")
    return {"shape": label, "classes": [list(a.shape) for a, _ in classes],
            "entry": "cold_grad" if flat is None else "cold_grad_classes",
            "max_abs_err": err, "parity_rel": rel, "column_ratio": ratio,
            "bf16_column_ratio": bf16_ratio, "bit_exact": err == 0.0}


def cold_bound(slots: int, columns: int, touched: int) -> dict:
    """The least time of a cold gradient over ``slots`` (C, L) slots,
    ``columns`` outputs and ``touched`` distinct live row ids: the ids
    and values read once (8 bytes a slot), each r it needs read once, the
    sums written once; one multiply-add a slot."""
    nbytes = slots * 8 + columns * 4 + touched * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * slots / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "slots": slots, "columns": columns,
            "rows_touched": touched}


def cold_class_time(torch, cg, r, rows, vals) -> dict:
    """One class of the main shape through the one-class entry on the
    card (graph replay), beside its own bound."""
    C, L = (int(x) for x in rows.shape)
    touched = int(torch.unique(rows[rows < r.shape[0]]).numel())
    return {"C": C, "L": L,
            "ms": device_ms(torch, lambda: cg.cold_grad(r, rows, vals),
                            reps=11, inner=20),
            **cold_bound(C * L, C, touched)}


def phase_cold_grad(np, torch, trained: dict) -> list[dict]:
    """cold_grad at the hybrid fit's main shape (every class, with the
    fit's own residual at its final iterate), with squared values, on an
    all-padding class, on L = 1 classes and on integer inputs; then timed
    over all classes of a gradient pass against the plain version and a
    CSR matrix-vector product."""
    from photon_ml_torch.ops import hybrid_sparse as hs
    from photon_ml_torch.ops.kernels import cold_grad as cg

    coord = trained["coord"]
    hb = coord.staged
    n = hb.num_rows
    r = residual(torch, coord.loss, hs.margins(hb, trained["w_perm"]), hb)
    main = list(zip(hb.cold_rowids, hb.cold_vals))
    flat = (hb.cold_flat_rowids, hb.cold_flat_vals, hb.cold_table)
    rows = [check_cold_grad(torch, cg, r, main, "main path", bf16=True,
                            flat=flat)]
    rows += [check_cold_grad(torch, cg, r, [c], f"main path, L={c[0].shape[1]}")
             for c in main]
    squared = hb.cold_flat_vals * hb.cold_flat_vals
    rows.append(check_cold_grad(
        torch, cg, r, list(zip(hb.cold_rowids,
                               cg.class_views(squared, hb.cold_table))),
        "main path, vals squared", flat=(flat[0], squared, flat[2])))
    del squared
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def synthetic(C, L, fill, integer):
        ids = torch.randint(0, n, (C, L), generator=gen, device="cuda",
                            dtype=torch.int32)
        vals = (torch.randint(-8, 9, (C, L), generator=gen, device="cuda")
                .float() if integer else
                torch.randn((C, L), generator=gen, device="cuda"))
        pad = torch.rand((C, L), generator=gen, device="cuda") >= fill
        return ids.masked_fill(pad, n), vals.masked_fill(pad, 0.0)

    rows.append(check_cold_grad(torch, cg, r, [synthetic(4096, 16, 0.0,
                                                         False)],
                                "all padding", exact=True))
    rows.append(check_cold_grad(torch, cg, r, [synthetic(200_000, 1, 1.0,
                                                         False)],
                                "L=1", bf16=True))
    r_int = torch.randint(-4, 5, (n,), generator=gen,
                          device="cuda").float()
    rows.append(check_cold_grad(
        torch, cg, r_int, [synthetic(C, L, 0.8, True) for C, L in (
            (100_000, 1), (20_000, 16), (500, 1024), (4, 4096))],
        "integer", exact=True))

    # All classes of one gradient pass: the kernel (one launch), the
    # plain version, and one CSR matrix-vector product over the same
    # (column, row id) entries.
    def kernel():
        return cg.cold_grad_classes(r, *flat)

    def plain():
        return cg.cold_grad_classes_reference(r, *flat)

    def policy_ms(slots_per_thread):
        """The pass under another threads-per-column policy: the same
        kernel over another table."""
        table = cg.class_table(hb.cold_table.shapes, slots_per_thread)
        return device_ms(torch, lambda: cg.cold_grad_classes(
            r, flat[0], flat[1], table), reps=5, inner=20)

    slots = sum(a.numel() for a, _ in main)
    columns = sum(a.shape[0] for a, _ in main)
    ids = torch.cat([a.reshape(-1) for a, _ in main]).long()
    vals = torch.cat([b.reshape(-1) for _, b in main])
    col = torch.repeat_interleave(
        torch.arange(columns, device="cuda"),
        torch.cat([torch.full((a.shape[0],), a.shape[1], device="cuda",
                              dtype=torch.long) for a, _ in main]))
    keep = ids < n
    csr = torch.sparse_coo_tensor(
        torch.stack([col[keep], ids[keep]]), vals[keep],
        (columns, n)).coalesce().to_sparse_csr()
    lib_err = float((torch.mv(csr, r) - kernel()).abs().max())
    live = ids[keep]
    touched = int(torch.unique(live).numel())
    del ids, vals, col, keep
    rows[0].update({
        "ms": device_ms(torch, kernel, reps=11, inner=20),
        "queued_ms": queued_ms(torch, kernel),
        "call_ms": call_ms(torch, kernel, reps=11, inner=20),
        "plain_ms": device_ms(torch, plain, reps=5, inner=5),
        # cuSPARSE may allocate inside the call, which a graph capture
        # would refuse: per call from Python, and the card's own time with
        # the calls queued behind a spin.
        "library_ms": call_ms(torch, lambda: torch.mv(csr, r), reps=11,
                              inner=20),
        "library_device_ms": queued_ms(torch, lambda: torch.mv(csr, r)),
        "library_call": "torch.mv on a CSR matrix (columns x rows); ms per "
                        "call from Python, device_ms queued behind a spin",
        # The random gathers alone: r at every live row id, one torch call.
        "gather_ms": device_ms(torch, lambda: r.index_select(0, live),
                               reps=11, inner=20),
        "gather_call": "r.index_select at the live row ids",
        "library_max_abs_diff": lib_err,
        **cold_bound(slots, columns, touched),
        "live_entries": int(csr.values().numel()), "n": n,
        "per_class": [cold_class_time(torch, cg, r, a, b) for a, b in main],
        "slots_per_thread_ms": {spt: policy_ms(spt)
                                for spt in (2, 4, 8, 16, 32, 64)}})
    del csr, live
    emit("kernels", kernel="cold_grad", checks=len(rows), shapes=rows)
    return rows


# -- hybrid_parity ---------------------------------------------------------

def hybrid_replay(torch, hs, sf, coord, calls) -> dict:
    """Each recorded card evaluation of the hybrid fit computed again on
    the CPU coordinate's staged layout from the same permuted iterate:
    the value's relative gap and the worst gradient column against
    COLUMN_TOL · Σ|r·x| + REPLAY_ROW_ABS · Σ w·|x|, in permuted space;
    over a bfloat16 hot block each hot column also allows one bfloat16
    step of r on the rows bf16_flip marks (the hot tier reads r rounded
    to bfloat16)."""
    import dataclasses

    hb, loss = coord.staged, coord.loss
    # |X| once, in float32: the plain products would upcast a bfloat16
    # block on every call.
    magnitude = dataclasses.replace(hb, X_hot=hb.X_hot.abs().float(),
                                    cold_flat_vals=hb.cold_flat_vals.abs())
    value_gap, column = 0.0, 0.0
    for w, value, grad in calls:
        v_cpu, g_cpu = hs.value_and_gradient(loss, w, hb)
        r = residual(torch, loss, hs.margins(hb, w), hb)
        w_pos = torch.where(hb.weights > 0, hb.weights, torch.zeros_like(r))
        base = COLUMN_TOL * r.abs() + REPLAY_ROW_ABS * w_pos
        hot_r = base
        if hb.X_hot.dtype == torch.bfloat16:
            hot_r = base + bf16_flip(torch, r, w_pos)
        g_hot = sf.hot_rmatvec(magnitude.X_hot, hot_r) if hb.num_hot \
            else None
        allowed = hs._assemble_grad(
            hb, g_hot, hs._cold_grad(hb, base, magnitude.cold_flat_vals))
        value_gap = max(value_gap, abs(float(value - v_cpu))
                        / abs(float(v_cpu)))
        column = max(column, column_ratio(torch, grad, g_cpu, allowed))
    return {"evaluations": len(calls), "value_rel_gap": value_gap,
            "gradient_column_ratio": column}


def phase_hybrid_parity(np, torch, card: str, parity: dict,
                        feature_dtype: str = "float32",
                        phase: str = "hybrid_parity") -> dict:
    """sparse_parity's 300,000 rows in the hybrid layout (the hot block in
    ``feature_dtype``), on the card and on the CPU: every coefficient
    within PARITY_TOL after PARITY_EARLY_ITERATIONS iterations (in
    bfloat16 plus one bfloat16 step of the largest coefficient, as
    compare_update allows), every card evaluation of that fit replayed on
    the CPU, and TRON_PARITY_ITERATIONS TRON iterations on the card with
    launches equal to its evaluations and H·v products."""
    from photon_ml_torch.ops import hybrid_sparse as hs
    from photon_ml_torch.ops.kernels import cold_grad as cg
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.ops.kernels import stream_fused as sf

    train, val = parity["train"], parity["val"]

    def fit(device, optimizer="LBFGS",
            iterations=PARITY_EARLY_ITERATIONS):
        est = sparse_estimator(device, optimizer, iterations, hybrid=None,
                               feature_dtype=feature_dtype)
        result, seconds = timed_fit(torch, est, train, val, device)
        return (result.model.models["ctr"].coefficients.means.cpu(),
                result.evaluation.metrics["AUC"],
                result.history.records[-1]["solver"], seconds,
                est.coordinates["ctr"])

    log = EvaluationLog(hs)
    with log:
        cuda = fit("cuda")
    cpu = fit("cpu")
    replay = hybrid_replay(torch, hs, sf, cpu[4], log.calls)
    diff = float((cuda[0] - cpu[0]).abs().max())
    # Under bfloat16 a coefficient may also differ by one bfloat16 step
    # of the model's largest coefficient (compare_update).
    limit = PARITY_TOL + (float(bf16_step(np, cuda[0].numpy(),
                                          cpu[0].numpy())[0])
                          if feature_dtype == "bfloat16" else 0.0)
    classes = len(cuda[4].staged.cold_rowids)
    counters = {"cold_grad": cg.cold_grad,
                "hot_value_and_gradient": hp.hot_value_and_gradient,
                "hot_hessian_vector": hp.hot_hessian_vector,
                "hot_rmatvec": sf.hot_rmatvec}
    for fn in counters.values():  # the TRON run starts
        fn.launches = 0
    tron = fit("cuda", "TRON", TRON_PARITY_ITERATIONS)
    tron_launches = {k: fn.launches  # ... and ends
                     for k, fn in counters.items()}
    evals = tron[2]["gradient_evaluations"]
    products = tron[2]["hessian_vector_products"]
    want = {"cold_grad": evals + products, "hot_value_and_gradient": evals,
            "hot_hessian_vector": products, "hot_rmatvec": 0}
    emit(phase, card=card, rows=train.num_rows,
         feature_dtype=feature_dtype,
         hot_block_dtype=str(cuda[4].staged.X_hot.dtype),
         num_hot=cuda[4].staged.num_hot, cold_classes=classes,
         iterations=PARITY_EARLY_ITERATIONS, coefficient_max_diff=diff,
         coefficient_limit=limit,
         replay=replay, auc={"cuda": cuda[1], "cpu": cpu[1],
                             "cuda TRON": tron[1]},
         solver={"cuda": cuda[2], "cpu": cpu[2], "cuda TRON": tron[2]},
         fit_seconds={"cuda": cuda[3], "cpu": cpu[3], "cuda TRON": tron[3]},
         tron_launches=tron_launches, tolerance=PARITY_TOL)
    if replay["evaluations"] != cuda[2]["gradient_evaluations"]:
        raise AssertionError(
            f"{phase}: recorded {replay['evaluations']} card "
            f"evaluations, the solver reports "
            f"{cuda[2]['gradient_evaluations']}")
    if tron_launches != want or products == 0 \
            or not bool(torch.isfinite(tron[0]).all()):
        raise AssertionError(f"{phase} TRON: launches {tron_launches},"
                             f" expected {want} (solver: {tron[2]})")
    if not (diff <= limit
            and replay["value_rel_gap"] <= REPLAY_VALUE_RTOL
            and replay["gradient_column_ratio"] <= 1.0):
        raise AssertionError(
            f"{phase}: coefficients after {PARITY_EARLY_ITERATIONS} "
            f"iterations {diff} apart (limit {limit}); replay {replay}")
    return tron_launches


# -- glm_train -------------------------------------------------------------

class _Messages(logging.Handler):
    """Collects a logger's messages."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def glm_cli(torch, argv: list, device: str) -> dict:
    """One run of the port's CLI (cli.train_glm.run): its summary, seconds
    (synchronised), peak device memory beyond what was allocated before
    it, seconds by stage (the CLI's log) and whether the run_grid path
    solved it."""
    from photon_ml_torch.cli import train_glm

    log = _Messages()
    logger = logging.getLogger("photon_ml_torch.cli")
    logger.addHandler(log)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        summary = train_glm.run(train_glm.build_parser().parse_args(
            argv + ["--device", device]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    stages = next(json.loads(m.split(": ", 1)[1]) for m in log.messages
                  if m.startswith("seconds by stage: "))
    return {"summary": summary, "seconds": seconds,
            "peak_bytes": (torch.cuda.max_memory_allocated() - base
                           if device == "cuda" else None),
            "stage_seconds": stages,
            "grid": any("reg grid" in m for m in log.messages)}


def cli_gap(model_io, out_a: str, out_b: str, count: int) -> float:
    """Largest coefficient gap between two CLI runs' saved models."""
    gaps = []
    for i in range(count):
        a = model_io.load_glm(os.path.join(out_a, f"model-{i}"))
        b = model_io.load_glm(os.path.join(out_b, f"model-{i}"))
        gaps.append(float((a.coefficients.means
                           - b.coefficients.means).abs().max()))
    return max(gaps)


def cli_report(run: dict, metric: str) -> dict:
    models = run["summary"]["models"]
    return {"cli_seconds": run["seconds"],
            "cli_stage_seconds": run["stage_seconds"],
            "cli_peak_bytes": run["peak_bytes"],
            "cli_iterations": [m["iterations"] for m in models],
            "cli_converged": [m["converged"] for m in models],
            f"cli_{metric}": [m[metric] for m in models],
            "cli_best_index": run["summary"]["best_index"]}


def glm_config1(np, torch, rng, tmp: str) -> dict:
    """Config 1 through the CLI at a1a's shape, on the card and the CPU,
    with a 3-point L2 grid (the run_grid path)."""
    from photon_ml_torch.data import synthetic
    from photon_ml_torch.data.libsvm import write_libsvm
    from photon_ml_torch.models import io as model_io

    X, y = synthetic.a1a_like(rng, n=A1A_TRAIN + A1A_VAL, d=A1A_DIM)
    labels = 2.0 * y - 1.0  # a1a ships ±1 labels
    tr, va = os.path.join(tmp, "a1a"), os.path.join(tmp, "a1a.t")
    write_libsvm(tr, X[:A1A_TRAIN], labels[:A1A_TRAIN])
    write_libsvm(va, X[A1A_TRAIN:], labels[A1A_TRAIN:])
    argv = ["--train", tr, "--validation", va,
            "--task", "LOGISTIC_REGRESSION", "--optimizer", "LBFGS",
            "--reg-type", "L2", "--reg-weights", A1A_GRID,
            "--max-iterations", str(GLM_MAX_ITERATIONS),
            "--tolerance", str(GLM_TOLERANCE), "--output-mode", "ALL"]
    outs = {d: os.path.join(tmp, f"a1a-{d}") for d in ("cuda", "cpu")}
    runs = {d: glm_cli(torch, argv + ["--output-dir", outs[d]], d)
            for d in ("cuda", "cpu")}
    for d, r in runs.items():
        if not r["grid"]:
            raise AssertionError(f"glm_train config 1 ({d}): the 3-point "
                                 "L2 grid did not take the run_grid path")
    lanes = len(A1A_GRID.split(","))
    gap = cli_gap(model_io, outs["cuda"], outs["cpu"], lanes)
    aucs = [m["AUC"] for m in runs["cuda"]["summary"]["models"]]
    if not all(np.isfinite(a) and a > 0.5 for a in aucs):
        raise AssertionError(f"glm_train config 1: AUCs {aucs}")
    if gap > PARITY_TOL:
        raise AssertionError(f"glm_train config 1: card-CPU coefficient "
                             f"gap {gap} > {PARITY_TOL}")
    return {"config": 1, "task": "LOGISTIC_REGRESSION", "solver": "LBFGS",
            "path": "cli (run_grid)", "rows": A1A_TRAIN,
            "validation_rows": A1A_VAL, "features": A1A_DIM,
            "reg_weights": A1A_GRID, **cli_report(runs["cuda"], "AUC"),
            "cpu_cli_seconds": runs["cpu"]["seconds"],
            "cpu_AUC": [m["AUC"] for m in runs["cpu"]["summary"]["models"]],
            "cpu_best_index": runs["cpu"]["summary"]["best_index"],
            "gap": gap}


def make_msd(np, rng) -> dict:
    """YearPredictionMSD's shape (90 features; 463,715 training and 51,630
    validation rows) through glm_classification's draws (its logistic
    labels unused), with a linear label, and a Poisson label over a
    log-exposure offset column from a model on 10 of the features; the
    CLI's Poisson label has no offset."""
    from photon_ml_torch.data import synthetic

    n = MSD_TRAIN + MSD_VAL
    # The last column is the intercept (1.0).
    X, _, w = synthetic.glm_classification(rng, n, MSD_DIM + 1,
                                           weight_scale=0.3)
    y_lin = (X @ w + rng.normal(size=n)).astype(np.float32)
    w_p = np.where(np.arange(MSD_DIM + 1) < 10, w, 0.0).astype(np.float32)
    w_p[-1] = 0.5
    offsets = (rng.normal(size=n) * 0.3).astype(np.float32)
    y_poi = rng.poisson(np.exp(X @ w_p + offsets)).astype(np.float32)
    y_poi_cli = rng.poisson(np.exp(X[MSD_TRAIN:] @ w_p)).astype(np.float32)
    return {"X": X, "linear": y_lin, "poisson": y_poi,
            "poisson_cli": y_poi_cli, "offsets": offsets}


def glm_api_fit(torch, problem, loss, batch, cfg, device: str) -> dict:
    """One optim.problem.run fit: coefficients, result, seconds
    (synchronised), the solver's host syncs and peak device memory beyond
    the staged batch and what else was allocated before it."""
    from photon_ml_torch.optim import lbfgs, tron

    lbfgs.minimize.host_syncs = tron.minimize.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (coef, result), seconds = synced_seconds(torch, lambda: problem.run(
        loss, batch, cfg, intercept_index=MSD_DIM))
    return {"coef": coef, "result": result, "seconds": seconds,
            "host_syncs": lbfgs.minimize.host_syncs
            + tron.minimize.host_syncs,
            "peak_bytes": (torch.cuda.max_memory_allocated() - base
                           if device == "cuda" else None)}


def device_events(prof) -> list:
    """The profile's events that ran on the card (kernels, copies and
    sets). An operator's own entry also carries the device time of the
    kernels it launched, so a sum over every entry counts them twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def busy_share(torch, fn) -> dict:
    """``fn`` again under torch.profiler: the card's busy time (kernels
    and copies) against the wall, and the launches on the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_seconds(torch, fn)
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    return {"profiled_seconds": wall, "device_busy_us": busy_us,
            "device_busy_share": busy_us * 1e-6 / wall,
            "device_launches": sum(e.count for e in events)}


def grid_eval(torch, agg, loss, batch, lanes: int) -> dict:
    """One value_and_gradient over ``lanes`` coefficient rows at once: the
    device bytes it allocates beyond its inputs, its time on the card and
    per call from Python, and the kernels it launches (by the profiler,
    over ``GRID_PROFILED`` calls; a window of one call recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    W = torch.zeros((lanes, batch.dim), device=batch.features.device)

    def evaluate():
        return agg.value_and_gradient(loss, W, batch)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    evaluate()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synced_seconds(torch, lambda: [evaluate()
                                       for _ in range(GRID_PROFILED)])
    return {"lanes": lanes, "extra_bytes": extra,
            "ms": device_ms(torch, evaluate, reps=11, inner=20),
            "call_ms": call_ms(torch, evaluate, reps=11, inner=20),
            "kernels_per_call": {
                e.key[:80]: e.count / GRID_PROFILED
                for e in device_events(prof)}}


def glm_api_config(np, torch, msd: dict, config: int) -> dict:
    """Config 2 (linear TRON, L2) or 3 (Poisson OWL-QN, L1, offsets)
    through optim.problem.run at MSD's shape, on the card and the CPU."""
    from photon_ml_torch.data.batch import LabeledBatch
    from photon_ml_torch.evaluation import evaluators as ev
    from photon_ml_torch.models import io as model_io
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.models.glm import GeneralizedLinearModel
    from photon_ml_torch.ops import aggregators as agg
    from photon_ml_torch.ops import losses
    from photon_ml_torch.optim import OptimizerConfig, OptimizerType
    from photon_ml_torch.optim import problem
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)
    from photon_ml_torch.types import TaskType

    linear = config == 2
    y = msd["linear" if linear else "poisson"]
    offsets = None if linear else msd["offsets"]
    task = (TaskType.LINEAR_REGRESSION if linear
            else TaskType.POISSON_REGRESSION)
    loss = losses.loss_for_task(task)
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(
            optimizer_type=OptimizerType.TRON if linear
            else OptimizerType.OWLQN,
            max_iterations=GLM_MAX_ITERATIONS, tolerance=GLM_TOLERANCE),
        regularization=RegularizationContext(
            RegularizationType.L2 if linear else RegularizationType.L1,
            MSD_L2 if linear else MSD_L1))
    tr = slice(0, MSD_TRAIN)

    def build(device):
        return LabeledBatch.build(
            msd["X"][tr], y[tr], offsets=None if linear else offsets[tr],
            device=device)

    batch, stage_s = synced_seconds(torch, lambda: build("cuda"))
    fits = {"cuda": glm_api_fit(torch, problem, loss, batch, cfg, "cuda"),
            "cpu": glm_api_fit(torch, problem, loss, build("cpu"), cfg,
                               "cpu")}
    profiled = busy_share(torch, lambda: problem.run(
        loss, batch, cfg, intercept_index=MSD_DIM))
    card = fits["cuda"]
    model = GeneralizedLinearModel(task, card["coef"])
    Xv = torch.from_numpy(msd["X"][MSD_TRAIN:]).cuda()
    yv = torch.from_numpy(y[MSD_TRAIN:]).cuda()
    ov = None if linear else torch.from_numpy(offsets[MSD_TRAIN:]).cuda()
    etype = ev.EvaluatorType.parse("RMSE" if linear else "POISSON_LOSS")
    metric, eval_s = synced_seconds(torch, lambda: float(ev.evaluate(
        etype, model.compute_score(Xv, ov), yv)))
    if linear:
        # The constant predictor: the training labels' mean.
        baseline = float(np.sqrt(np.mean(
            (y[MSD_TRAIN:] - np.mean(y[tr])) ** 2)))
        if not metric < baseline:
            raise AssertionError(f"glm_train config 2: RMSE {metric} not "
                                 f"below the constant predictor's "
                                 f"{baseline}")
    else:
        # The constant rate over the offsets: log(Σy / Σ e^offset).
        rate = np.log(np.sum(y[tr]) / np.sum(np.exp(offsets[tr])))
        s0 = rate + offsets[MSD_TRAIN:]
        baseline = float(np.mean(np.exp(s0) - y[MSD_TRAIN:] * s0))
    if not np.isfinite(metric):
        raise AssertionError(f"glm_train config {config}: metric {metric}")
    gap = float((card["coef"].means.cpu()
                 - fits["cpu"]["coef"].means).abs().max())
    if gap > PARITY_TOL:
        raise AssertionError(f"glm_train config {config}: card-CPU "
                             f"coefficient gap {gap} > {PARITY_TOL}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model-0")
        model_io.save_glm(model, path)
        back = model_io.load_glm(path, device="cuda")
    if not torch.equal(back.coefficients.means, card["coef"].means):
        raise AssertionError(f"glm_train config {config}: load_glm did not "
                             "read the saved model back bit for bit")
    out = {"config": config, "task": task.value,
           "solver": "TRON" if linear else "OWLQN",
           "path": "optim.problem.run", "rows": MSD_TRAIN,
           "validation_rows": MSD_VAL, "features": MSD_DIM,
           "reg": f"{'L2' if linear else 'L1'} {cfg.regularization.reg_weight}",
           "offsets": not linear,
           "fit_seconds": card["seconds"], "cpu_seconds": fits["cpu"]["seconds"],
           "stage_seconds": stage_s, "evaluate_seconds": eval_s,
           "iterations": int(card["result"].iterations[0]),
           "converged": bool(card["result"].converged[0]),
           "cpu_iterations": int(fits["cpu"]["result"].iterations[0]),
           "cpu_converged": bool(fits["cpu"]["result"].converged[0]),
           "host_syncs": card["host_syncs"],
           "cpu_host_syncs": fits["cpu"]["host_syncs"],
           "final_value": float(card["result"].value[0]),
           "cpu_final_value": float(fits["cpu"]["result"].value[0]),
           etype.name: metric, f"constant_{etype.name}": baseline,
           "nonzero_coefficients": int((card["coef"].means != 0).sum()),
           "peak_bytes": card["peak_bytes"], "gap": gap,
           "model_roundtrip_bits": True, **profiled}
    if linear:
        lane = {f"L{g['lanes']}": g for g in (
            grid_eval(torch, agg, loss, batch, 1),
            grid_eval(torch, agg, loss, batch, GRID_LANES))}
        x_bytes = batch.features.numel() * 4
        if lane[f"L{GRID_LANES}"]["extra_bytes"] >= x_bytes:
            raise AssertionError(
                f"a {GRID_LANES}-lane evaluation allocated "
                f"{lane[f'L{GRID_LANES}']['extra_bytes']} bytes, a copy of "
                f"X ({x_bytes} bytes)")
        out["grid_evaluation"] = {**lane, "x_bytes": x_bytes}
    return out


def glm_msd_cli(np, torch, msd: dict, tmp: str) -> tuple:
    """Configs 2 and 3 through the CLI on the card, on LIBSVM files of the
    51,630-row split (80% to train on); config 3's file carries no
    offsets."""
    from photon_ml_torch.data.libsvm import write_libsvm
    from photon_ml_torch.models import io as model_io

    X = msd["X"][MSD_TRAIN:, :MSD_DIM]  # the CLI adds its own intercept
    cut = int(0.8 * MSD_VAL)
    paths = {}
    for part, rows in (("tr", slice(0, cut)), ("va", slice(cut, MSD_VAL))):
        lin = os.path.join(tmp, f"msd.{part}")
        write_libsvm(lin, X[rows], msd["linear"][MSD_TRAIN:][rows])
        # The same rows with the Poisson label: only the label differs.
        poi = os.path.join(tmp, f"msd-poisson.{part}")
        with open(lin) as src, open(poi, "w") as dst:
            for label, line in zip(msd["poisson_cli"][rows].tolist(), src):
                dst.write(f"{label:g} {line.split(None, 1)[1]}"
                          if " " in line.strip() else f"{label:g} \n")
        paths[part] = (lin, poi)
    out = {}
    for config, k, flags, metric in (
            (2, 0, ["--task", "LINEAR_REGRESSION", "--optimizer", "TRON",
                    "--reg-type", "L2", "--reg-weights", str(MSD_L2)],
             "RMSE"),
            (3, 1, ["--task", "POISSON_REGRESSION", "--optimizer", "OWLQN",
                    "--reg-type", "L1", "--reg-weights", str(MSD_CLI_L1)],
             "POISSON_LOSS")):
        outdir = os.path.join(tmp, f"msd-{config}")
        run = glm_cli(torch, ["--train", paths["tr"][k],
                              "--validation", paths["va"][k],
                              "--output-dir", outdir,
                              "--max-iterations", str(GLM_MAX_ITERATIONS),
                              "--tolerance", str(GLM_TOLERANCE), *flags],
                      "cuda")
        value = run["summary"]["models"][0][metric]
        if not np.isfinite(value):
            raise AssertionError(f"glm_train config {config} (CLI): "
                                 f"{metric} {value}")
        if config == 2:
            yv = msd["linear"][MSD_TRAIN:]
            baseline = float(np.sqrt(np.mean(
                (yv[cut:] - np.mean(yv[:cut])) ** 2)))
            if not value < baseline:
                raise AssertionError(f"glm_train config 2 (CLI): RMSE "
                                     f"{value} not below {baseline}")
        model = model_io.load_glm(os.path.join(outdir, "model-0"),
                                  device="cuda")
        if not bool(torch.isfinite(model.coefficients.means).all()):
            raise AssertionError(f"glm_train config {config} (CLI): "
                                 "non-finite coefficients")
        out[config] = {"cli_rows": cut, "cli_validation_rows": MSD_VAL - cut,
                       **cli_report(run, metric)}
    return out[2], out[3]


def phase_glm_train(np, torch, card: str) -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        results.append(glm_config1(np, torch, rng, tmp))
        emit("glm_train", card=card, **results[-1])
        msd, gen_s = synced_seconds(torch, lambda: make_msd(np, rng))
        cli2, cli3 = glm_msd_cli(np, torch, msd, tmp)
        for config, cli in ((2, cli2), (3, cli3)):
            results.append({**glm_api_config(np, torch, msd, config), **cli,
                            "generation_seconds": gen_s})
            emit("glm_train", card=card, **results[-1])
        del msd
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit("glm_train", card=card, seconds=seconds,
         max_gap=max(r["gap"] for r in results))
    return {"configs": results, "seconds": seconds}


# -- glm_gradient_step -------------------------------------------------------

def gradient_step_rates(np, torch, X, y, feature_dtype: str) -> dict:
    """BASELINE metric 1 over X stored in ``feature_dtype``: the slope
    between STEP_SHORT and STEP_LONG chained steps, one step on the card
    alone and the host's enqueue of one, and the card's busy share."""
    from photon_ml_torch.data.batch import LabeledBatch
    from photon_ml_torch.ops import aggregators as agg
    from photon_ml_torch.ops import losses

    n, d = X.shape
    batch = LabeledBatch.build(X, y, feature_dtype=feature_dtype,
                               device="cuda")
    itemsize = batch.features.element_size()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def run(steps: int) -> float:
        w = torch.zeros((d,), device="cuda")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            _, g = agg.value_and_gradient(losses.LOGISTIC, w, batch)
            w = w - 1e-9 * g  # chain: the next step depends on this one
        end.record()
        end.synchronize()
        if not bool(torch.isfinite(w).all()) or w.dtype != torch.float32:
            raise AssertionError(f"glm_gradient_step ({feature_dtype}): "
                                 f"non-finite or {w.dtype} w")
        return start.elapsed_time(end) * 1e-3

    run(STEP_SHORT)  # warm-up
    # What a step allocates beside X: its (n,) and (d,) vectors; a float32
    # copy of X would be n·d·4 bytes.
    step_extra_bytes = torch.cuda.max_memory_allocated() - base
    short = [run(STEP_SHORT) for _ in range(STEP_RUNS)]
    long = [run(STEP_LONG) for _ in range(STEP_RUNS)]
    dt = (min(long) - min(short)) / (STEP_LONG - STEP_SHORT)
    # X read twice (margins, then Xᵀr): the unfused bound; X read once: the
    # bound of a pass that forms both from one read.
    two_read_ms = 2.0 * itemsize * n * d / PEAK_BYTES_PER_S * 1e3
    one_read_ms = 1.0 * itemsize * n * d / PEAK_BYTES_PER_S * 1e3
    # One step on the card alone (a CUDA-graph replay) and the host's
    # time to enqueue one: the chain's step is the larger of the two.
    w0 = torch.zeros((d,), device="cuda")

    def step():
        return agg.value_and_gradient(losses.LOGISTIC, w0, batch)

    step_device_ms = device_ms(torch, step, reps=11, inner=20)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)  # the card waits while we enqueue
    t_host = time.perf_counter()
    for _ in range(STEP_SHORT):
        step()
    enqueue_ms = (time.perf_counter() - t_host) * 1e3 / STEP_SHORT
    torch.cuda.synchronize()
    profiled = busy_share(torch, lambda: [step() for _ in range(STEP_SHORT)])
    del batch
    return {"n": n, "d": d, "dtype": feature_dtype,
            "samples_per_s": n / dt, "ms_per_step": dt * 1e3,
            "short_runs_s": short, "long_runs_s": long,
            "step_device_ms": step_device_ms,
            "step_enqueue_ms": enqueue_ms,
            "bound_ms": two_read_ms, "bound_share": two_read_ms / (dt * 1e3),
            "device_bound_share": two_read_ms / step_device_ms,
            "bound_samples_per_s": n / (two_read_ms * 1e-3),
            "one_read_bound_ms": one_read_ms,
            "step_extra_bytes": step_extra_bytes,
            "x_float32_copy_bytes": 4 * n * d,
            "profiled_steps": STEP_SHORT, **profiled}


def phase_glm_gradient_step(np, torch, card: str) -> dict:
    """BASELINE metric 1 (bench.py bench_gradient_step): the port's dense
    value_and_gradient on a chain w ← w − 1e-9·g, samples per second from
    the slope between STEP_SHORT and STEP_LONG steps; float32, and its
    bfloat16 variant (bench.py:227–231: the same X rounded to bfloat16)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(STEP_ROWS, STEP_DIM)).astype(np.float32)
    y = rng.integers(0, 2, size=STEP_ROWS).astype(np.float32)
    out = gradient_step_rates(np, torch, X, y, "float32")
    bf16 = gradient_step_rates(np, torch, X, y, "bfloat16")
    del X
    emit("glm_gradient_step", card=card, **out, bf16=bf16,
         seconds=time.perf_counter() - t0)
    if bf16["step_extra_bytes"] >= bf16["x_float32_copy_bytes"]:
        raise AssertionError(f"glm_gradient_step: a bfloat16 step allocates "
                             f"{bf16['step_extra_bytes']} bytes, a float32 "
                             f"copy of X")
    torch.cuda.empty_cache()
    return out


# -- down-sampling and resume (slice 6 items 3-4a) --------------------------

class Killed(Exception):
    """The simulated kill of a resume phase."""


class CountedCoordinate:
    """A coordinate whose train_model calls count in a counter shared by
    a descent's coordinates; call number ``kill_at`` raises Killed
    instead (0: never)."""

    def __init__(self, coord, counter: list, kill_at: int = 0):
        self.coord = coord
        self.counter = counter
        self.kill_at = kill_at

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def train_model(self, offsets, initial=None):
        self.counter[0] += 1
        if self.counter[0] == self.kill_at:
            raise Killed(f"killed at train_model call {self.kill_at}")
        return self.coord.train_model(offsets, initial=initial)


def counted(coords: dict, kill_at: int = 0) -> tuple:
    counter = [0]
    return ({cid: CountedCoordinate(c, counter, kill_at)
             for cid, c in coords.items()}, counter)


def timed_manager(directory: str, saves: list):
    """A CheckpointManager that appends each save's seconds and the
    bytes of the artifacts it rewrote (the ones whose CRC changed, and
    state.json) to ``saves``."""
    from photon_ml_torch.game.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def save(self, task, models, **kw):
            before = dict(self._crcs)
            t0 = time.perf_counter()
            super().save(task, models, **kw)
            seconds = time.perf_counter() - t0
            rewritten = [r for r, c in self._crcs.items()
                         if before.get(r) != c] + ["state.json"]
            saves.append({
                "done_steps": kw["done_steps"],
                "complete": kw.get("complete", False), "seconds": seconds,
                "bytes": sum(os.path.getsize(self._abs(r))
                             for r in rewritten)})

    return Timed(directory)


def span_counts(trace: dict) -> dict:
    """Closed spans of a Chrome trace by name (and how many carry an
    error tag)."""
    out: dict = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            c = out.setdefault(e["name"], {"spans": 0, "errors": 0})
            c["spans"] += 1
            c["errors"] += "error" in e.get("args", {})
    return out


def ledger_leg(directory: str, config: dict):
    """A run ledger opened (or resume-appended) under ``directory`` and
    installed process-wide; returns (ledger, the previous one)."""
    from photon_ml_torch import obs
    from photon_ml_torch.obs.ledger import build_manifest

    led = obs.RunLedger.resume(directory,
                               manifest=build_manifest(config=config))
    return led, obs.set_ledger(led)


def phase_train_resume(np, torch, card: str, trained: dict) -> dict:
    """train's descent again over its coordinates, with a checkpoint
    manager, killed at the TRAIN_KILL_AT-th update and resumed: the same
    bits as train's uninterrupted model. Both legs run traced, with a
    metrics registry and one run ledger (the killed leg leaves its rows
    flushed and no run_end, as a kill would); the resumed leg's solver
    host syncs equal those train's untraced descent made for the same
    updates."""
    from photon_ml_torch import obs
    from photon_ml_torch.cli import obs as obs_cli
    from photon_ml_torch.game import descent
    from photon_ml_torch.obs.ledger import (read_manifest, read_rows,
                                            verify_ledger)
    from photon_ml_torch.ops.kernels import re_rows as rr
    from photon_ml_torch.optim import lbfgs
    from photon_ml_torch.types import TaskType

    coords, want = trained["coords"], trained["model"]
    waves = {cid: coords[cid].num_waves for cid in SEQ[1:]}
    task = TaskType.LOGISTIC_REGRESSION
    cfg = descent.CoordinateDescentConfig(SEQ, iterations=DESCENT_ITERATIONS)
    updates = DESCENT_ITERATIONS * len(SEQ)
    saves: list = []
    # The fingerprint's dataset digest, timed apart from the killed leg,
    # which then reads it memoized on the dataset.
    ds = coords[SEQ[0]].dataset
    vars(ds).pop("_content_digest", None)
    t0 = time.perf_counter()
    descent._dataset_digest(ds)
    digest_s = time.perf_counter() - t0
    digest_bytes = sum(a.nbytes for a in (
        ds.response, ds.offsets, ds.weights, *ds.entity_ids.values(),
        *(a for x in ds.feature_shards.values()
          for a in ((x.indices, x.values) if hasattr(x, "indices")
                    else (x,)))))
    legs = {"killed": (obs.Tracer(), obs.MetricsRegistry()),
            "resumed": (obs.Tracer(), obs.MetricsRegistry())}
    with tempfile.TemporaryDirectory(prefix="photon-chip-smoke-") as tmp:
        path = os.path.join(tmp, "checkpoint")
        led_dir = os.path.join(tmp, "ledger")
        killed, counter = counted(coords, TRAIN_KILL_AT)
        led, prev = ledger_leg(led_dir, {"phase": "train_resume"})
        t0 = time.perf_counter()
        try:
            with obs.activated(*legs["killed"]):
                descent.run(task, killed, cfg,
                            checkpoint_manager=timed_manager(path, saves))
        except Killed:
            pass
        else:
            raise AssertionError("train_resume: the kill did not fire")
        finally:
            # A kill leaves the ledger's flushed rows and no run_end.
            led.flush()
            obs.set_ledger(prev)
        killed_s = time.perf_counter() - t0
        killed_saves = len(saves)
        killed_run = read_manifest(led_dir)["run_id"]
        state = timed_manager(path, []).load(device="cuda")
        done = TRAIN_KILL_AT - 1
        if state is None or state.done_steps != done or state.complete:
            raise AssertionError(f"train_resume: the checkpoint holds "
                                 f"{state and state.done_steps} steps, "
                                 f"expected {done}")
        # The premise of a bit-exact resume: the killed run's first
        # updates gave train's bits (its fixed effect's last update is
        # update 4 of both runs).
        if not torch.equal(state.models["fixed"].coefficients.means,
                           want.models["fixed"].coefficients.means):
            raise AssertionError("train_resume: a second descent over the "
                                 "same coordinates gave other bits")
        fresh, counter = counted(coords)
        led, prev = ledger_leg(led_dir, {"phase": "train_resume"})
        rr.gather_rows.launches = 0  # the resumed leg starts
        rr.scatter_rows_.launches = 0
        lbfgs.minimize.host_syncs = 0
        t0 = time.perf_counter()
        try:
            with obs.activated(*legs["resumed"]):
                model, history = descent.run(
                    task, fresh, cfg,
                    checkpoint_manager=timed_manager(path, saves))
        finally:
            led.close()
            obs.set_ledger(prev)
        resumed_s = time.perf_counter() - t0
        gathers = rr.gather_rows.launches  # ... and ends here
        scatters = rr.scatter_rows_.launches
        resumed_syncs = lbfgs.minimize.host_syncs
        resumed_calls = counter[0]
        final = timed_manager(path, []).load(device="cuda")
        third, counter = counted(coords)
        t0 = time.perf_counter()
        again, _ = descent.run(task, third, cfg,
                               checkpoint_manager=timed_manager(path, []))
        third_s = time.perf_counter() - t0
        third_calls = counter[0]
        ledger_problems = verify_ledger(led_dir)
        rows, row_problems = read_rows(led_dir)
        run_id = read_manifest(led_dir)["run_id"]
        trace_path = os.path.join(tmp, "resumed-trace.json")
        legs["resumed"][0].dump(trace_path)
        trace_problems = obs_cli.verify_trace(
            obs_cli.load_trace(trace_path))
    remaining = sum(waves[cid] for cid in SEQ[done % len(SEQ):])
    if resumed_calls != updates - done or gathers != remaining \
            or scatters != remaining:
        raise AssertionError(
            f"train_resume: the resumed leg made {resumed_calls} updates "
            f"and {gathers} gathers, {scatters} scatters; expected "
            f"{updates - done} and {remaining} ({waves} waves)")
    tables = coefficient_tables(model)
    for cid, table in coefficient_tables(want).items():
        if not torch.equal(tables[cid], table):
            raise AssertionError(f"train_resume: the resumed {cid} "
                                 "coefficients differ from train's")
    # The residual total: the resumed run's final one against train's
    # chain, replayed from the killed run's checkpoint with train's final
    # models (total + new − old, as the descent writes it).
    total = torch.from_numpy(state.residual_total).cuda()
    for cid in SEQ[done % len(SEQ):]:
        total = (total + coords[cid].score(want.models[cid])
                 - coords[cid].score(state.models[cid]))
    if not (final.complete and np.array_equal(
            final.residual_total.view(np.uint32),
            total.cpu().numpy().view(np.uint32))):
        raise AssertionError("train_resume: the resumed residual total is "
                             "not train's")
    if third_calls or not all(torch.equal(a, b) for a, b in zip(
            coefficient_tables(again).values(), tables.values())):
        raise AssertionError(f"train_resume: a third run made "
                             f"{third_calls} updates or other models")
    emit("train_resume", card=card, rows=coords["fixed"].dataset.num_rows,
         updates=updates, killed_at=TRAIN_KILL_AT, done_steps=done,
         killed_seconds=killed_s, resumed_seconds=resumed_s,
         short_circuit_seconds=third_s, resumed_updates=resumed_calls,
         launches={"gather_rows": gathers, "scatter_rows_": scatters},
         waves=waves, bit_identical=True,
         residual_bytes=int(state.residual_total.nbytes), saves=saves,
         digest_seconds=digest_s, digest_bytes=int(digest_bytes))
    # -- observability of the two legs ------------------------------------
    # The untraced descent of train made these updates too: its host
    # syncs for updates done+1 .. updates.
    cum = trained["update_syncs"]
    untraced_syncs = cum[updates - 1] - cum[done - 1]
    spans = {leg: span_counts(tr.chrome_trace())
             for leg, (tr, _) in legs.items()}
    writes = {leg: mx.counter("photon_checkpoint_writes_total",
                              kind="descent").value
              for leg, (_, mx) in legs.items()}
    refit = {leg: sum(mx.counter("photon_re_entities_refit_total",
                                 re_type=t).value
                      for t in ("userId", "itemId"))
             for leg, (_, mx) in legs.items()}
    kinds: dict = {}
    for r in rows:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    resumed_saves = len(saves) - killed_saves
    want_spans = {
        "killed": {"descent.update": TRAIN_KILL_AT,
                   "re.fit_wave": sum(waves[cid] for cid in SEQ[1:]),
                   "checkpoint.save": killed_saves},
        "resumed": {"descent.update": updates - done,
                    "re.fit_wave": remaining,
                    "checkpoint.save": resumed_saves}}
    got_spans = {leg: {k: spans[leg].get(k, {}).get("spans", 0)
                       for k in want_spans[leg]} for leg in legs}
    failures = []
    if ledger_problems or row_problems:
        failures.append(f"ledger problems {ledger_problems} "
                        f"{row_problems}")
    if run_id != killed_run or [r["seq"] for r in rows] != \
            list(range(len(rows))) or rows[-1]["kind"] != "run_end" \
            or kinds.get("run_end") != 1:
        failures.append("one run id, contiguous seq and one closing "
                        "run_end across the kill")
    if kinds.get("coordinate_update") != updates:
        failures.append(f"{kinds.get('coordinate_update')} "
                        f"coordinate_update rows, expected {updates}")
    if got_spans != want_spans:
        failures.append(f"spans {got_spans}, expected {want_spans}")
    if spans["killed"]["descent.update"]["errors"] != 1:
        failures.append("the killed update's span is not tagged")
    if writes != {"killed": killed_saves, "resumed": resumed_saves}:
        failures.append(f"checkpoint writes {writes}, saves "
                        f"{killed_saves} and {resumed_saves}")
    if trace_problems:
        failures.append(f"cli/obs verify: {trace_problems[:5]}")
    if resumed_syncs != untraced_syncs:
        failures.append(f"the traced resumed leg made {resumed_syncs} "
                        f"solver host syncs, train's untraced updates "
                        f"{untraced_syncs}")
    if failures:
        raise AssertionError("obs train_resume: " + "; ".join(failures))
    emit("obs", on="train_resume", card=card, ledger_rows=kinds,
         run_id=run_id, seq_contiguous=True, spans=got_spans,
         checkpoint_writes=writes, entities_refit=refit,
         solver_host_syncs={"traced_resumed_leg": resumed_syncs,
                            "untraced_train": untraced_syncs},
         verify="ok", bit_identical=True)
    return {"gathers": gathers, "scatters": scatters}


def phase_sparse_down_sampled(np, torch, card: str, trained: dict) -> dict:
    """sparse_train's staged ELL coordinate, down-sampled: the binary
    classification sampler at DOWN_SAMPLING_RATE, L-BFGS 60, two
    train_model calls (two draws). The subsets compared are the ones the
    coordinate drew, recorded as its draw returns them."""
    import dataclasses

    from photon_ml_torch.evaluation.evaluators import auc
    from photon_ml_torch.game.coordinates import sparse_fixed
    from photon_ml_torch.game.models import GameModel
    from photon_ml_torch.ops.kernels import ell_scatter
    from photon_ml_torch.types import TaskType

    train, val = trained["train"], trained["val"]
    cfg = dataclasses.replace(
        sparse_estimator("cuda").coordinate_configs["ctr"].optimization,
        down_sampling_rate=DOWN_SAMPLING_RATE)
    coord = trained["coord"].with_optimization_config(cfg)
    offsets = torch.zeros(train.num_rows, device="cuda")
    y_val = torch.as_tensor(val.response, device="cuda")
    draws, subsets = [], []
    draw = sparse_fixed.draw_down_sample

    def recording_draw(coordinate, rate):
        idx, mult = draw(coordinate, rate)
        subsets.append(idx.copy())
        return idx, mult

    sparse_fixed.draw_down_sample = recording_draw
    try:
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            ell_scatter.ell_rmatvec.launches = 0  # the fit starts
            ell_scatter.scatter_rowterm.launches = 0
            model, fit_s = synced_seconds(
                torch, lambda: coord.train_model(offsets))
            launches = ell_scatter.ell_rmatvec.launches  # ... and ends
            generic = ell_scatter.scatter_rowterm.launches
            peak = torch.cuda.max_memory_allocated()
            solve = dict(coord.last_solve)
            means = model.coefficients.means
            scores = GameModel(TaskType.LOGISTIC_REGRESSION,
                               {"ctr": model}).score(val)
            if launches != solve["gradient_evaluations"] or generic:
                raise AssertionError(
                    f"sparse_down_sampled: ell_rmatvec launched {launches} "
                    f"times for {solve['gradient_evaluations']} "
                    f"evaluations, scatter_rowterm {generic} times")
            if not bool(torch.isfinite(means).all()):
                raise AssertionError(f"sparse_down_sampled: {solve}")
            draws.append({**solve, "fit_seconds": fit_s,
                          "launches": launches,
                          "auc": float(auc(scores, y_val)),
                          "max_memory_allocated": peak, "means": means})
    finally:
        sparse_fixed.draw_down_sample = draw
    if len(subsets) != 2 or any(d["sampled_rows"] != len(i)
                                for d, i in zip(draws, subsets)):
        raise AssertionError(f"sparse_down_sampled: {len(subsets)} draws "
                             f"recorded for 2 fits, rows "
                             f"{[d['sampled_rows'] for d in draws]}")
    if np.array_equal(np.sort(subsets[0]), np.sort(subsets[1])) or \
            torch.equal(draws[0]["means"], draws[1]["means"]):
        raise AssertionError("sparse_down_sampled: the two train_model "
                             "calls drew the same subset")
    if not all(d["auc"] > 0.5 for d in draws):
        raise AssertionError(f"sparse_down_sampled: validation AUC "
                             f"{[d['auc'] for d in draws]} not above 0.5")
    staged = coord.staged
    emit("sparse_down_sampled", card=card, rows=train.num_rows,
         rate=DOWN_SAMPLING_RATE, positives=int((train.response > 0).sum()),
         staged_batch_bytes=sum(t.numel() * t.element_size() for t in (
             staged.indices, staged.values, staged.labels, staged.weights,
             staged.offsets)),
         staged_layout_bytes=staged.layout.nbytes,
         draws=[{k: v for k, v in d.items() if k != "means"}
                for d in draws],
         full_fit_auc=trained["ell"]["auc"],
         full_fit_seconds=trained["ell"]["fit_seconds"])
    return {"launches": sum(d["launches"] for d in draws)}


def phase_down_sampling_parity(np, torch, card: str, parity: dict) -> dict:
    """Down-sampled fits of the 300,000-row fixtures on the card and on
    the CPU from one seed (so the same subsets): the dense fixed effect
    (config 4's), ELL and the float32 hybrid layout (config 5's), each
    PARITY_EARLY_ITERATIONS iterations, coefficients within PARITY_TOL;
    the hybrid's fused-pass and cold_grad launches equal its
    evaluations, and its L-BFGS fit launches no H·v pass."""
    from photon_ml_torch.game.coordinates import (FixedEffectCoordinate,
                                                  SparseFixedEffectCoordinate)
    from photon_ml_torch.ops import losses
    from photon_ml_torch.ops.kernels import cold_grad as cg
    from photon_ml_torch.ops.kernels import ell_scatter
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)

    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=PARITY_EARLY_ITERATIONS,
                                  tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0),
        down_sampling_rate=DOWN_SAMPLING_RATE)
    dense, _ = make_train_data(np, PARITY_ROWS)
    sparse_train = parity["train"]
    builders = {
        "dense": (dense, lambda d: FixedEffectCoordinate(
            dense, "global", losses.LOGISTIC, cfg, device=d)),
        "ell": (sparse_train, lambda d: SparseFixedEffectCoordinate(
            sparse_train, "global", losses.LOGISTIC, cfg, hybrid=False,
            device=d)),
        "hybrid": (sparse_train, lambda d: SparseFixedEffectCoordinate(
            sparse_train, "global", losses.LOGISTIC, cfg, device=d))}
    counters = {"ell_rmatvec": ell_scatter.ell_rmatvec,
                "hot_value_and_gradient": hp.hot_value_and_gradient,
                "hot_hessian_vector": hp.hot_hessian_vector,
                "cold_grad": cg.cold_grad}
    out = {}
    for name, (data, build) in builders.items():
        fits = {}
        for device in ("cuda", "cpu"):
            coord = build(device)
            offsets = torch.zeros(data.num_rows, device=device)
            for fn in counters.values():  # the fit starts
                fn.launches = 0
            t0 = time.perf_counter()
            means = coord.train_model(offsets).coefficients.means
            if device == "cuda":
                torch.cuda.synchronize()
            launches = {k: fn.launches  # ... and ends
                        for k, fn in counters.items()}
            fits[device] = {"means": means.cpu(), "launches": launches,
                            "seconds": time.perf_counter() - t0,
                            "solve": getattr(coord, "last_solve", None)}
        diff = float((fits["cuda"]["means"] - fits["cpu"]["means"]).abs()
                     .max())
        out[name] = {"coefficient_max_diff": diff,
                     **{f"{d}_seconds": f["seconds"]
                        for d, f in fits.items()},
                     "launches": fits["cuda"]["launches"],
                     "solve": fits["cuda"]["solve"]}
        if not diff <= PARITY_TOL:
            raise AssertionError(f"down_sampling_parity {name}: cuda and "
                                 f"cpu coefficients {diff} apart")
    hybrid = out["hybrid"]
    evals = hybrid["solve"]["gradient_evaluations"]
    if not (hybrid["launches"]["hot_value_and_gradient"] == evals
            == hybrid["launches"]["cold_grad"]) \
            or hybrid["launches"]["hot_hessian_vector"] != 0 \
            or out["ell"]["launches"]["ell_rmatvec"] != \
            out["ell"]["solve"]["gradient_evaluations"]:
        raise AssertionError(f"down_sampling_parity: launches {out}")
    emit("down_sampling_parity", card=card, rows={
        "dense": dense.num_rows, "sparse": sparse_train.num_rows},
         rate=DOWN_SAMPLING_RATE, iterations=PARITY_EARLY_ITERATIONS,
         tolerance=PARITY_TOL, fits=out)
    return {k: v["launches"] for k, v in out.items()}


def phase_stream_resume(np, torch, card: str, trained: dict) -> dict:
    """stream_train's staged int8 coordinate fitted again with a bound
    step store whose save raises after iteration STREAM_KILL_AFTER, then
    resumed from the store: stream_train's bits. Both legs run traced,
    with a metrics registry, one run ledger and the default watchdog
    armed; then value-and-gradient passes at the final iterate, traced and
    untraced in turns."""
    from photon_ml_torch import obs
    from photon_ml_torch.cli import obs as obs_cli
    from photon_ml_torch.obs.ledger import (read_manifest, read_rows,
                                            verify_ledger)
    from photon_ml_torch.ops.kernels import ell_scatter
    from photon_ml_torch.ops.kernels import stream_fused as sf

    coord, want = trained["coord"], trained["w"]
    chunks = coord.chunked.num_chunks
    offsets = torch.zeros(coord.dataset.num_rows, device="cuda")
    saves = []
    legs = {"killed": (obs.Tracer(), obs.MetricsRegistry()),
            "resumed": (obs.Tracer(), obs.MetricsRegistry())}
    leg_passes, leg_bytes, leg_rows = {}, {}, {}
    prev_wd = obs.set_watchdog(obs.WatchdogConfig())
    try:
        with tempfile.TemporaryDirectory(prefix="photon-chip-smoke-") as tmp:
            led_dir = os.path.join(tmp, "ledger")
            coord.bind_step_checkpoint(os.path.join(tmp, "stream-step-1"),
                                       1)
            store = coord._ckpt_store
            save = store.save

            def killing_save(state, **kw):
                if int(state["it"]) > STREAM_KILL_AFTER:
                    raise Killed(
                        f"killed after iteration {STREAM_KILL_AFTER}")
                t0 = time.perf_counter()
                save(state, **kw)
                saves.append(time.perf_counter() - t0)

            store.save = killing_save
            led, prev = ledger_leg(led_dir, {"phase": "stream_resume"})
            before = dict(coord.stream.passes)
            bytes0 = coord.stream.bytes_moved
            t0 = time.perf_counter()
            try:
                with obs.activated(*legs["killed"]):
                    coord.train_model(offsets)
            except Killed:
                pass
            else:
                raise AssertionError("stream_resume: the kill did not fire")
            finally:
                led.flush()  # a kill leaves the flushed rows, no run_end
                obs.set_ledger(prev)
            killed_s = time.perf_counter() - t0
            leg_passes["killed"] = {k: coord.stream.passes[k] - before[k]
                                    for k in before}
            leg_bytes["killed"] = coord.stream.bytes_moved - bytes0
            leg_rows["killed"] = len(read_rows(led_dir)[0])
            store.save = save
            state_bytes = os.path.getsize(os.path.join(
                store.directory, "stream_state.npz"))
            before = dict(coord.stream.passes)
            bytes0 = coord.stream.bytes_moved
            counters = {"hot_margins": sf.hot_margins,
                        "hot_rmatvec": sf.hot_rmatvec,
                        "ell_scatter": ell_scatter.scatter_rowterm}
            led, prev = ledger_leg(led_dir, {"phase": "stream_resume"})
            for fn in counters.values():  # the resumed leg starts
                fn.launches = 0
            try:
                with obs.activated(*legs["resumed"]):
                    model, resumed_s = synced_seconds(
                        torch, lambda: coord.train_model(offsets))
            finally:
                led.close()
                obs.set_ledger(prev)
            launches = {k: fn.launches  # ... and ends here
                        for k, fn in counters.items()}
            coord.clear_step_checkpoint()
            passes = {k: coord.stream.passes[k] - before[k] for k in before}
            leg_passes["resumed"] = passes
            leg_bytes["resumed"] = coord.stream.bytes_moved - bytes0
            ledger_problems = verify_ledger(led_dir)
            rows, row_problems = read_rows(led_dir)
            run_id = read_manifest(led_dir)["run_id"]
            # Every copy of both legs has been read on the host by now.
            torch.cuda.synchronize()
            coord.stream.flush_timings()
            trace_path = os.path.join(tmp, "resumed-trace.json")
            legs["resumed"][0].dump(trace_path)
            summary = obs_cli.summarize_trace(
                obs_cli.load_trace(trace_path))
            # Every copy span nested in the pass that made it, though
            # the card runs a pass's copies after the host has closed it.
            verify_problems = obs_cli.verify_trace(
                obs_cli.load_trace(trace_path))
    finally:
        obs.set_watchdog(prev_wd)
    expect = {"hot_margins": chunks * (passes["value_grad"]
                                       + passes["value"]),
              "hot_rmatvec": chunks * passes["value_grad"],
              "ell_scatter": chunks * passes["value_grad"]}
    solve = coord.last_solve
    if launches != expect or not 0 < passes["value_grad"] \
            < trained["passes"]["value_grad"]:
        raise AssertionError(
            f"stream_resume: launches {launches}, expected {expect} for "
            f"{chunks} chunks and the resumed passes {passes}")
    if not torch.equal(model.coefficients.means, want):
        raise AssertionError("stream_resume: the resumed coefficients "
                             "differ from stream_train's")
    emit("stream_resume", card=card, rows=coord.dataset.num_rows,
         chunks=chunks, killed_after=STREAM_KILL_AFTER,
         iterations=solve["iterations"], killed_seconds=killed_s,
         resumed_seconds=resumed_s, resumed_passes=passes,
         uninterrupted_passes=trained["passes"], launches=launches,
         save_seconds=saves, state_bytes=state_bytes, bit_identical=True)
    # -- observability of the two legs ------------------------------------
    iterations = solve["iterations"]
    opt = [r for r in rows if r["kind"] == "opt_iter"]
    split = sum(r["kind"] == "opt_iter" for r in rows[:leg_rows["killed"]])
    killed_iters = [r["iteration"] for r in opt[:split]]
    resumed_iters = [r["iteration"] for r in opt[split:]]
    want_iters = {"killed": list(range(1, STREAM_KILL_AFTER + 2)),
                  "resumed": list(range(STREAM_KILL_AFTER + 1,
                                        iterations + 1))}
    spans = {leg: span_counts(tr.chrome_trace())
             for leg, (tr, _) in legs.items()}
    parsed = {leg: obs.parse_prometheus_text(mx.render_text())
              for leg, (_, mx) in legs.items()}
    failures = []
    if ledger_problems or row_problems:
        failures.append(f"ledger problems {ledger_problems} "
                        f"{row_problems}")
    if [r["seq"] for r in rows] != list(range(len(rows))) \
            or rows[-1]["kind"] != "run_end" \
            or sum(r["kind"] == "run_end" for r in rows) != 1:
        failures.append("contiguous seq and one closing run_end")
    if {"killed": killed_iters, "resumed": resumed_iters} != want_iters:
        failures.append(f"opt_iter iterations {killed_iters} then "
                        f"{resumed_iters}, expected {want_iters}")
    if any(r["kind"] == "watchdog" for r in rows):
        failures.append("a watchdog fired")
    for leg in legs:
        n_iter = len(want_iters[leg])
        got = {k: spans[leg].get(k, {}).get("spans", 0)
               for k in ("lbfgs.iteration", "stream.pass",
                         "stream.chunk_transfer")}
        want_leg = {"lbfgs.iteration": n_iter,
                    "stream.pass": sum(leg_passes[leg].values()),
                    "stream.chunk_transfer":
                        chunks * sum(leg_passes[leg].values())}
        if got != want_leg:
            failures.append(f"{leg} spans {got}, expected {want_leg}")
        p = parsed[leg]
        sent = p.get('photon_transfer_bytes_total{dtype="int8",'
                     'kind="stream"}')
        if sent != leg_bytes[leg]:
            failures.append(f"{leg}: {sent} transfer bytes counted, "
                            f"{leg_bytes[leg]} moved")
        if p.get("photon_stream_inflight_chunks_peak", 0) > 2:
            failures.append(f"{leg}: in-flight peak "
                            f"{p.get('photon_stream_inflight_chunks_peak')}"
                            " over prefetch_depth 2 (no pinned chunk)")
    writes = {leg: parsed[leg].get(
        'photon_checkpoint_writes_total{kind="stream"}', 0.0)
        for leg in legs}
    if writes != {"killed": len(saves), "resumed": len(want_iters[
            "resumed"])}:
        failures.append(f"stream checkpoint writes {writes}, saves "
                        f"{len(saves)} and one per resumed iteration")
    share = summary["attribution"]["transfer_fraction_of_stream"]
    if not 0.0 < share:
        failures.append(f"summarize: transfer share {share}")
    if verify_problems:
        failures.append(f"cli/obs verify on the resumed trace: "
                        f"{len(verify_problems)} problems, "
                        f"{verify_problems[:3]}")
    # The pass with and without the instrumentation at the final iterate
    # (the same chunks): one warm pass of each, then sixteen in turns
    # (untraced, traced, traced, untraced), the medians compared, so one
    # pass that a stall of the host lengthens moves neither.
    w = model.coefficients.means
    timed_turns = {"untraced": [], "traced": []}
    for k, turn in enumerate(("untraced", "traced")
                             + ("untraced", "traced", "traced",
                                "untraced") * 4):
        if turn == "traced":
            with obs.activated(obs.Tracer(), obs.MetricsRegistry()):
                _, sec = synced_seconds(torch, lambda: coord._vg(w))
        else:
            _, sec = synced_seconds(torch, lambda: coord._vg(w))
        if k >= 2:
            timed_turns[turn].append(sec)
    coord.stream.flush_timings()
    pass_ratio = statistics.median(timed_turns["traced"]) / \
        statistics.median(timed_turns["untraced"])
    if pass_ratio > OBS_PASS_RATIO:
        failures.append(f"a traced value-and-gradient pass took "
                        f"{pass_ratio} of an untraced one")
    if failures:
        raise AssertionError("obs stream_resume: " + "; ".join(failures))
    # The resumed leg's seconds a pass, its snapshot writes (one an
    # iteration, timed by their spans) taken out.
    ckpt_s = sum(e["dur"] for e in legs["resumed"][0].chrome_trace()[
        "traceEvents"] if e.get("name") == "checkpoint.stream_state") / 1e6
    resumed_per_pass = (resumed_s - ckpt_s) / sum(passes.values())
    # stream_train's update: its fit's passes and the descent's scoring
    # pass.
    untraced_fit = trained["train_seconds"] / (
        trained["passes"]["value_grad"] + trained["passes"]["value"] + 1)
    tp = parsed["resumed"]
    emit("obs", on="stream_resume", card=card, run_id=run_id,
         opt_iter_rows={"killed": len(killed_iters),
                        "resumed": len(resumed_iters)},
         spans={leg: {k: v["spans"] for k, v in spans[leg].items()}
                for leg in legs},
         transfer={
             "bytes": tp.get('photon_transfer_bytes_total{dtype="int8",'
                             'kind="stream"}'),
             "chunks": tp.get('photon_transfer_chunks_total{dtype="int8",'
                              'kind="stream"}'),
             "device_seconds": tp.get(
                 'photon_transfer_seconds_total{dtype="int8",'
                 'kind="stream"}'),
             "inflight_peak": tp.get("photon_stream_inflight_chunks_peak")},
         summarize=summary["attribution"], checkpoint_writes=writes,
         watchdog_alerts=0,
         seconds_per_pass={"traced_resumed_leg": resumed_per_pass,
                           "untraced_stream_train": untraced_fit,
                           "ratio": resumed_per_pass / untraced_fit,
                           "resumed_leg_snapshot_seconds": ckpt_s},
         value_grad_pass_turns=timed_turns,
         value_grad_pass_ratio=pass_ratio, verify="ok")
    return launches


# -- game_cli --------------------------------------------------------------

# Config 4's rows for the CLI phase (full width, 5% of MovieLens-20M's
# rows: cut from 2,000,000 when the script crossed its 600 s aim); the
# batched scoring's chunk (4 chunks of the 950,000 training rows) and its
# prefetch depth (GameTransformer's default).
CLI_ROWS = 1_000_000
# Its fits' outer iterations: 1, cut from the flagship's 2 for time (a
# config-4 descent is host-bound, ≈ 7 s an iteration at any row count).
CLI_DESCENT_ITERATIONS = 1
CLI_BATCH_ROWS = 262_144
CLI_PREFETCH_DEPTH = 2
CLI_SPARSE_ITERATIONS = 20
CLI_STREAMING = "chunk_rows=65536,num_hot=512,dtype=int8"
SCORE_REL = 1e-6  # batched against one-shot, relative to max(|s|, 1)
ORACLE_TOL = 1e-4  # every score against the float64 CPU oracle
SCORE_SLACK_BYTES = 64 << 20

# The CLI phases' input files are written by a child process that starts
# after serve and runs beside the config-4 phases: config 4's rows as two
# dataset directories (save_game_dataset), then sparse_parity's rows (the
# same function and seed, so the same bits) as two LIBSVM files, which it
# then reads back through game_train's own _load_dataset for the API fits
# (the same function on the same files, so the same arrays as the CLI
# runs read). It prints one JSON line when each pair is written, and
# sends the datasets it read (send_arrays).
_CLI_DATA_CHILD = """\
import json, os, sys, time
import numpy as np
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from photon_ml_torch.data.io import save_game_dataset
tmp = sys.argv[1]
t0 = time.perf_counter()
train, val = cs.make_train_data(np, cs.CLI_ROWS)
t1 = time.perf_counter()
save_game_dataset(train, os.path.join(tmp, "train4"))
save_game_dataset(val, os.path.join(tmp, "val4"))
t2 = time.perf_counter()
print(json.dumps({"generate_seconds": t1 - t0, "write_seconds": t2 - t1}),
      flush=True)
del train, val
train, val = cs.make_sparse_data(np, cs.SPARSE_PARITY_ROWS)
t3 = time.perf_counter()
cs.write_ell_libsvm(os.path.join(tmp, "train5.libsvm"), train)
cs.write_ell_libsvm(os.path.join(tmp, "val5.libsvm"), val)
t4 = time.perf_counter()
from photon_ml_torch.cli.game_train import _load_dataset
train = _load_dataset(os.path.join(tmp, "train5.libsvm"))
dim = train.shard_dim("global")
val = _load_dataset(os.path.join(tmp, "val5.libsvm"), num_features=dim)
print(json.dumps({"generate_seconds": t3 - t2, "write_seconds": t4 - t3,
                  "read_seconds": time.perf_counter() - t4}), flush=True)
cs.send_arrays(np, sys.stdout.buffer, {
    f"{part}/{name}": a for part, ds in (("train", train), ("val", val))
    for name, a in (("response", ds.response), ("offsets", ds.offsets),
                    ("weights", ds.weights),
                    ("indices", ds.feature_shards["global"].indices),
                    ("values", ds.feature_shards["global"].values),
                    ("num_features", np.asarray(dim)))})
"""


def write_ell_libsvm(path: str, ds) -> None:
    """A GameDataset's ELL 'global' shard as LIBSVM text: one-based, its
    valid slots in order, every float32 value to 9 significant digits (so
    it reads back exactly)."""
    import numpy as np

    shard = ds.feature_shards["global"]
    idx, val = np.asarray(shard.indices), np.asarray(shard.values)
    valid = idx < shard.num_features
    flat = [None] * (2 * int(valid.sum()))
    flat[0::2] = (idx[valid] + 1).tolist()
    flat[1::2] = val[valid].tolist()
    counts = valid.sum(axis=1).tolist()
    formats: dict = {}
    lines, lo = [], 0
    for label, k in zip(np.asarray(ds.response).tolist(), counts):
        fmt = formats.get(k)
        if fmt is None:
            fmt = formats[k] = "%g" + " %d:%.9g" * k + "\n"
        lines.append(fmt % (label, *flat[2 * lo: 2 * (lo + k)]))
        lo += k
    with open(path, "w") as f:
        f.write("".join(lines))


def start_cli_data(tmp: str):
    """Start writing the CLI phases' files under ``tmp``; cli_data_ready
    waits for each pair."""
    return {"proc": start_child(_CLI_DATA_CHILD, tmp), "tmp": tmp}


def cli_data_ready(files: dict) -> dict:
    """The child's next line: the seconds it took to make and write the
    next pair of files (waiting for them if need be)."""
    t0 = time.perf_counter()
    line = files["proc"].stdout.readline()
    if not line:
        raise RuntimeError(f"the CLI data writer stopped (exit "
                           f"{files['proc'].wait()})")
    return {**json.loads(line), "waited_seconds": time.perf_counter() - t0}


def kernel_counters() -> dict:
    """Every kernel wrapper of the training paths, by name."""
    from photon_ml_torch.ops.kernels import cold_grad as cg
    from photon_ml_torch.ops.kernels import ell_scatter as es
    from photon_ml_torch.ops.kernels import hot_pass as hp
    from photon_ml_torch.ops.kernels import re_rows as rr
    from photon_ml_torch.ops.kernels import stream_fused as sf

    return {"gather_rows": rr.gather_rows,
            "scatter_rows_": rr.scatter_rows_,
            "ell_rmatvec": es.ell_rmatvec,
            "scatter_rowterm": es.scatter_rowterm,
            "hot_margins": sf.hot_margins, "hot_rmatvec": sf.hot_rmatvec,
            "hot_value_and_gradient": hp.hot_value_and_gradient,
            "hot_hessian_vector": hp.hot_hessian_vector,
            "cold_grad": cg.cold_grad}


@contextlib.contextmanager
def counted_launches(torch, out: dict):
    """Every kernel's launches inside the block (counts set to 0 at its
    start and read at its end), and its seconds, synchronised."""
    from photon_ml_torch.optim import lbfgs

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0  # this run of the path starts
    lbfgs.minimize.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    yield out
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["solver_host_syncs"] = lbfgs.minimize.host_syncs
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base


def cli_run(torch, module, argv: list) -> dict:
    """One in-process run of a CLI (``run(build_parser().parse_args())``)
    with the launches, solver host syncs, seconds and peak memory beyond
    what was allocated before it."""
    out: dict = {}
    with counted_launches(torch, out):
        out["summary"] = module.run(module.build_parser().parse_args(argv))
    return out


def obs_verify(path: str) -> dict:
    """``python -m photon_ml_torch.cli.obs verify`` on a trace or ledger."""
    run = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.cli.obs", "verify", path],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    return {"rc": run.returncode,
            "output": (run.stdout + run.stderr).strip()[-600:]}


def cli4_argv(train: str, val: str) -> list:
    """Config 4 through game_train: the flagship's three coordinates,
    L2 1.0, L-BFGS 25, tolerance 1e-7, CLI_DESCENT_ITERATIONS outer
    iterations."""
    opt = "optimizer=LBFGS,reg=L2,reg_weight=1.0,max_iter=25,tolerance=1e-7"
    return ["--train", train, "--validation", val,
            "--coordinate", "name=fixed,type=fixed,shard=global",
            "--coordinate", f"name=per-user,type=random,shard=re_userId,"
                            f"re=userId,max_samples={UPPER_BOUND}",
            "--coordinate", "name=per-item,type=random,shard=re_itemId,"
                            "re=itemId",
            "--update-sequence", ",".join(SEQ),
            "--iterations", str(CLI_DESCENT_ITERATIONS),
            "--evaluators", "AUC,AUC@userId",
            *[a for cid in SEQ for a in ("--opt-config", f"{cid}:{opt}")]]


def cli4_estimator():
    """cli4_argv's configuration built through the API."""
    from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                             FixedEffectDataConfiguration,
                                             RandomEffectDataConfiguration)
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)
    from photon_ml_torch.types import TaskType

    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=25, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))
    data = {"fixed": FixedEffectDataConfiguration("global"),
            "per-user": RandomEffectDataConfiguration(
                "userId", "re_userId", active_data_upper_bound=UPPER_BOUND),
            "per-item": RandomEffectDataConfiguration("itemId",
                                                      "re_itemId")}
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinates={cid: CoordinateConfiguration(data[cid], opt)
                     for cid in SEQ},
        update_sequence=list(SEQ), device="cuda",
        descent_iterations=CLI_DESCENT_ITERATIONS,
        validation_evaluators=["AUC", "AUC@userId"])


def model_tables(model) -> dict:
    """Each coordinate's coefficient table of a GameModel."""
    return {cid: getattr(m, "coefficients", m).means
            for cid, m in model.models.items()}


def same_tables(torch, a: dict, b: dict) -> tuple:
    """(bit for bit, largest gap) of two models' tables."""
    gap = max(float((x.cpu() - b[k].cpu()).abs().max())
              for k, x in a.items())
    return (a.keys() == b.keys() and all(
        torch.equal(x.cpu(), b[k].cpu()) for k, x in a.items())), gap


def oracle_scores(np, model, ds):
    """Float64 CPU scores of a config-4 model: offsets + X_global·w +
    each random effect's row dot (zero for entities past its table)."""
    total = np.asarray(ds.offsets, np.float64).copy()
    for m in model.models.values():
        shard = np.asarray(ds.feature_shards[m.shard_id], np.float64)
        if hasattr(m, "coefficients"):
            total += shard @ m.coefficients.means.cpu().double().numpy()
            continue
        W = m.means.cpu().double().numpy()
        ids = np.asarray(ds.entity_ids[m.re_type], np.int64)
        seen = ids < W.shape[0]
        rows = W[np.where(seen, ids, 0)]
        total += np.where(seen, np.einsum("nd,nd->n", shard, rows), 0.0)
    return total


def dataset_row_bytes(ds) -> int:
    """Host bytes a row of a GameDataset holds, over all its arrays."""
    n = ds.num_rows
    arrays = [ds.response, ds.offsets, ds.weights,
              *ds.feature_shards.values(), *ds.entity_ids.values()]
    return sum(a.nbytes for a in arrays) // n


def _merged(spans: list) -> list:
    """Sorted, overlapping (start, end) intervals merged."""
    out: list = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def copy_overlap(torch, fn) -> dict:
    """``fn`` under torch.profiler: the card's host→device copy time, its
    kernel time, how much of the copy time ran while a kernel ran (the
    copy hidden behind scoring), and the share of the wall the card was
    busy with either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_seconds(torch, fn)
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    merged = _merged(kernels)
    copy_us = sum(t - s for s, t in copies)
    hidden_us = sum(max(0.0, min(t, mt) - max(s, ms))
                    for s, t in copies for ms, mt in merged)
    busy_us = sum(t - s for s, t in _merged(copies + kernels))
    return {"profiled_seconds": wall, "copies": len(copies),
            "copy_ms": copy_us / 1e3,
            "kernel_ms": sum(t - s for s, t in merged) / 1e3,
            "copy_hidden_ms": hidden_us / 1e3,
            "copy_hidden_share": (hidden_us / copy_us if copy_us
                                  else None),
            "device_busy_share": busy_us * 1e-6 / wall}


def phase_game_cli_train(np, torch, card: str, files: dict) -> dict:
    """Config 4 through the GAME CLIs at full width: game_train over a
    dataset directory, then game_score on its model, one-shot and in
    bounded batches, and once more as a separate process."""
    from photon_ml_torch import obs
    from photon_ml_torch.api.transformer import GameTransformer
    from photon_ml_torch.cli import game_score, game_train
    from photon_ml_torch.cli import obs as obs_cli
    from photon_ml_torch.data.io import load_game_dataset
    from photon_ml_torch.models import io as model_io
    from photon_ml_torch.obs.ledger import read_rows

    written = cli_data_ready(files)
    tmp = files["tmp"]
    train_dir, val_dir = (os.path.join(tmp, "train4"),
                          os.path.join(tmp, "val4"))
    t0 = time.perf_counter()
    train = load_game_dataset(train_dir)
    val = load_game_dataset(val_dir)
    read_s = time.perf_counter() - t0
    failures = []

    # The API fit of the same rows and configuration, as the CLI fits.
    est = cli4_estimator()
    api: dict = {}
    with counted_launches(torch, api):
        result = est.fit(train, val, checkpoint_dir=os.path.join(
            tmp, "api4-checkpoints"))[0]
    api_tables = model_tables(result.model)
    del est, result
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "out4")
    trace_path = os.path.join(tmp, "train4-trace.json")
    metrics_path = os.path.join(tmp, "train4-metrics.prom")
    fit = cli_run(torch, game_train, cli4_argv(train_dir, val_dir) + [
        "--output-dir", out, "--trace-out", trace_path,
        "--metrics-dump", metrics_path])
    summary = fit["summary"]
    with open(os.path.join(out, "summary.json")) as f:
        keys = sorted(json.load(f))
    trace = obs_cli.load_trace(trace_path)
    waves = span_counts(trace).get("re.fit_wave", {}).get("spans", 0)
    rows, row_problems = read_rows(os.path.join(out, "ledger"))
    ledger_waves = sum(r["kind"] == "re_fit_wave" for r in rows)
    updates = [r for r in rows if r["kind"] == "coordinate_update"]
    aucs = [r["validation"]["AUC"] for r in updates]
    verified = obs_verify(trace_path)
    best = model_io.load_game_model(os.path.join(out, "best"),
                                    device="cuda")
    tables = model_tables(best)
    bits, gap = same_tables(torch, tables, api_tables)
    gathers = fit["launches"]["gather_rows"]
    if not (gathers == fit["launches"]["scatter_rows_"] > 0
            and gathers == waves == ledger_waves):
        failures.append(f"gather_rows {gathers}, scatter_rows_ "
                        f"{fit['launches']['scatter_rows_']}, re.fit_wave "
                        f"spans {waves}, re_fit_wave rows {ledger_waves}")
    if row_problems or len(updates) != CLI_DESCENT_ITERATIONS * len(SEQ) \
            or not aucs[-1] > aucs[0]:
        failures.append(f"ledger: {row_problems}, {len(updates)} "
                        f"coordinate_update rows, validation AUC {aucs}")
    if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
        failures.append("a coefficient is not finite")
    if verified["rc"] != 0:
        failures.append(f"cli/obs verify: {verified['output']}")
    want_keys = sorted(["task", "model_digest", "candidates",
                        "best_metrics", "tuning", "ledger",
                        "wall_seconds"])
    if keys != want_keys or summary["model_digest"] != \
            model_io.game_model_digest(best):
        failures.append(f"summary.json keys {keys}, or a digest that is "
                        f"not the best model's")
    emit("game_cli_train", card=card, rows=train.num_rows,
         val_rows=val.num_rows, data=written, read_seconds=read_s,
         fit_seconds=fit["seconds"], api_fit_seconds=api["seconds"],
         launches=fit["launches"], api_launches=api["launches"],
         solver_host_syncs=fit["solver_host_syncs"],
         api_solver_host_syncs=api["solver_host_syncs"],
         max_memory_allocated=fit["peak_bytes"],
         api_max_memory_allocated=api["peak_bytes"],
         re_fit_wave_spans=waves, re_fit_wave_rows=ledger_waves,
         validation_auc=aucs, best_metrics=summary["best_metrics"],
         bit_identical_to_api=bits, api_max_coefficient_gap=gap,
         summary_keys=keys, verify="ok" if verified["rc"] == 0 else
         verified["output"], wall_seconds=summary["wall_seconds"])
    if failures:
        raise AssertionError("game_cli_train: " + "; ".join(failures))

    # -- game_score on that model ----------------------------------------
    best_dir = os.path.join(out, "best")
    score_runs = {}
    for way, extra in (("one_shot", []),
                       ("batched", ["--batch-rows", str(CLI_BATCH_ROWS)])):
        registry = obs.MetricsRegistry()
        with obs.activated(metrics_obj=registry):
            run = cli_run(torch, game_score, [
                "--data", train_dir, "--model-dir", best_dir,
                "--output-dir", os.path.join(tmp, f"scores-{way}"),
                *extra])
        dump = os.path.join(tmp, f"scores-{way}.prom")
        registry.dump(dump)
        run["rows_counted"] = obs.metric_value(obs.parse_prometheus_text(
            open(dump).read()), "photon_scoring_rows_total")
        run["scores"] = np.load(os.path.join(
            tmp, f"scores-{way}", "scores.npz"))["score"]
        score_runs[way] = run
    one, batched = (score_runs["one_shot"]["scores"],
                    score_runs["batched"]["scores"])
    oracle = oracle_scores(np, best, train)
    rel = float(np.max(np.abs(batched - one)
                       / np.maximum(np.abs(one), 1.0)))
    oracle_err = float(max(np.max(np.abs(one - oracle)),
                           np.max(np.abs(batched - oracle))))
    chunk_bytes = dataset_row_bytes(train) * CLI_BATCH_ROWS
    model_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    memory_bound = ((CLI_PREFETCH_DEPTH + 1) * chunk_bytes + model_bytes
                    + SCORE_SLACK_BYTES)
    peaks = {w: r["peak_bytes"] for w, r in score_runs.items()}
    counted = {w: r["rows_counted"] for w, r in score_runs.items()}

    # Rows a second of each way on the dataset in memory (the CLI's own
    # seconds hold the dataset's read and the scores' write): a warm run,
    # then three in turns, the median of each; and the batched way's
    # copies against its scoring.
    transformer = GameTransformer(best)
    ways = {"one_shot": lambda: transformer.transform(train),
            "batched": lambda: transformer.transform_batched(
                train, CLI_BATCH_ROWS)}
    runs: dict = {way: [] for way in ways}
    for way in ("one_shot", "batched", "batched", "one_shot") * 2:
        runs[way].append(synced_seconds(torch, ways[way])[1])
    rates = {way: {"seconds": sorted(r[1:])[1], "runs": r,
                   "rows_per_s": train.num_rows / sorted(r[1:])[1]}
             for way, r in runs.items()}
    overlap = copy_overlap(torch, lambda: transformer.transform_batched(
        train, CLI_BATCH_ROWS))

    # The validation rows scored in this process, for the module entry
    # point's own process (game_cli_sparse starts it beside its reads).
    here_out = os.path.join(tmp, "scores-val-here")
    game_score.run(game_score.build_parser().parse_args([
        "--data", val_dir, "--model-dir", best_dir, "--output-dir",
        here_out]))

    if not rel <= SCORE_REL:
        failures.append(f"batched scores {rel} from one-shot's (relative)")
    if not oracle_err <= ORACLE_TOL:
        failures.append(f"scores {oracle_err} from the float64 oracle")
    if not (peaks["batched"] < peaks["one_shot"]
            and peaks["batched"] <= memory_bound):
        failures.append(f"peak memory {peaks}, bound {memory_bound}")
    if any(v != train.num_rows for v in counted.values()):
        failures.append(f"photon_scoring_rows_total {counted} for "
                        f"{train.num_rows} rows")
    emit("game_cli_score", card=card, rows=train.num_rows,
         batch_rows=CLI_BATCH_ROWS,
         chunks=-(-train.num_rows // CLI_BATCH_ROWS),
         prefetch_depth=CLI_PREFETCH_DEPTH,
         cli_seconds={w: r["seconds"] for w, r in score_runs.items()},
         scoring=rates, batched_max_rel_diff=rel,
         bit_identical=bool(np.array_equal(one, batched)),
         oracle_max_abs_err=oracle_err, peak_bytes=peaks,
         chunk_bytes=chunk_bytes, model_bytes=model_bytes,
         memory_bound_bytes=memory_bound, rows_counted=counted,
         batched_copies=overlap)
    if failures:
        raise AssertionError("game_cli_score: " + "; ".join(failures))
    return {"launches": fit["launches"], "best_dir": best_dir,
            "val_dir": val_dir, "val_rows": val.num_rows,
            "val_scores": os.path.join(here_out, "scores.npz")}


def start_score_process(cli4: dict, out: str) -> dict:
    """``python -m photon_ml_torch.cli.game_score`` as a process of its
    own, without --device, on config 4's validation rows."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_torch.cli.game_score",
         "--data", cli4["val_dir"], "--model-dir", cli4["best_dir"],
         "--output-dir", out], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "out": out, "t0": time.perf_counter()}


def check_score_process(np, card: str, started: dict, cli4: dict) -> None:
    """The game_score process ran on the card and wrote the scores this
    process wrote for the same rows."""
    proc = started["proc"]
    _, err = proc.communicate(timeout=600)
    seconds = time.perf_counter() - started["t0"]
    same = proc.returncode == 0 and np.array_equal(
        np.load(os.path.join(started["out"], "scores.npz"))["score"],
        np.load(cli4["val_scores"])["score"])
    on_card = "rows on cuda" in err
    emit("game_cli_score_process", card=card, rows=cli4["val_rows"],
         seconds=seconds, rc=proc.returncode, on_card=on_card,
         same_scores=same)
    if not (same and on_card):
        raise AssertionError(f"game_score process: rc {proc.returncode}, on "
                             f"the card: {on_card}, same scores: {same}: "
                             f"{err[-600:]}")


def cli5_argv(train: str, val: str, coordinate: str) -> list:
    return ["--train", train, "--validation", val,
            "--coordinate", f"name=ctr,type=fixed,shard=global{coordinate}",
            "--update-sequence", "ctr", "--evaluators", "AUC",
            "--opt-config",
            f"ctr:optimizer=LBFGS,reg=L2,reg_weight=1.0,"
            f"max_iter={CLI_SPARSE_ITERATIONS},tolerance=1e-7"]


def canonical_rows(np, shard, width: int):
    """An ELL shard's rows with their valid slots sorted by column and
    padding last, under one sentinel, ``width`` slots a row: the rows
    whatever the slot order, the slots a row and the width of the
    feature space."""
    idx = np.asarray(shard.indices).astype(np.int64)
    val = np.asarray(shard.values)
    pad = idx >= shard.num_features
    idx = np.where(pad, np.iinfo(np.int64).max, idx)
    val = np.where(pad, 0.0, val).astype(np.float32)
    order = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    val = np.take_along_axis(val, order, axis=1)
    extra = width - idx.shape[1]
    return (np.pad(idx, ((0, 0), (0, extra)),
                   constant_values=np.iinfo(np.int64).max),
            np.pad(val, ((0, 0), (0, extra))))


def ell_dataset(arrays: dict, part: str):
    """The GameDataset of one ELL 'global' shard that receive_arrays gave
    as ``part``'s arrays."""
    from photon_ml_torch.data.game_data import GameDataset, SparseShard

    return GameDataset(
        response=arrays[f"{part}/response"],
        offsets=arrays[f"{part}/offsets"],
        weights=arrays[f"{part}/weights"],
        feature_shards={"global": SparseShard(
            indices=arrays[f"{part}/indices"],
            values=arrays[f"{part}/values"],
            num_features=int(arrays[f"{part}/num_features"]))},
        entity_ids={}, num_entities={}, intercept_index={})


def phase_game_cli_sparse(np, torch, card: str, files: dict,
                          parity: dict, cli4: dict) -> dict:
    """Config 5 through game_train from LIBSVM files of sparse_parity's
    rows: the hybrid layout, ELL and the int8 streamed path, each CLI fit
    bit for bit GameEstimator.fit's over the dataset the CLI loads (read
    by the data child through the same _load_dataset). game_cli_score's
    own process runs beside the first fit."""
    from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                             FixedEffectDataConfiguration,
                                             parse_streaming_config)
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.cli import game_train
    from photon_ml_torch.models import io as model_io
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)
    from photon_ml_torch.types import TaskType

    written = cli_data_ready(files)
    arrays = receive_arrays(np, files["proc"])
    train, val = (ell_dataset(arrays, part) for part in ("train", "val"))
    tmp = files["tmp"]
    scoring = start_score_process(cli4, os.path.join(tmp, "scores-val-sub"))
    train_path, val_path = (os.path.join(tmp, "train5.libsvm"),
                            os.path.join(tmp, "val5.libsvm"))
    failures = []
    for got, want, label in ((train, parity["train"], "training"),
                             (val, parity["val"], "validation")):
        a, b = got.feature_shards["global"], want.feature_shards["global"]
        width = max(a.indices.shape[1], b.indices.shape[1])
        same = np.array_equal(got.response, want.response) and all(
            np.array_equal(x, y) for x, y in zip(
                canonical_rows(np, a, width), canonical_rows(np, b, width)))
        if not same:
            failures.append(f"the LIBSVM {label} rows are not "
                            f"sparse_parity's")

    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=CLI_SPARSE_ITERATIONS,
                                  tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))
    modes = {
        "hybrid": (None, "", None),
        "ell": (False, ",hybrid=false", None),
        "stream": (None, "", CLI_STREAMING)}
    report = {}
    for mode, (hybrid, coordinate, streaming) in modes.items():
        est = GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION,
            coordinates={"ctr": CoordinateConfiguration(
                FixedEffectDataConfiguration("global", hybrid=hybrid),
                opt)},
            update_sequence=["ctr"], device="cuda",
            validation_evaluators=["AUC"],
            streaming=(parse_streaming_config(streaming)
                       if streaming else None))
        api: dict = {}
        with counted_launches(torch, api):
            result = est.fit(train, val, checkpoint_dir=os.path.join(
                tmp, f"api5-{mode}-checkpoints"))[0]
        solver = result.history.records[-1]["solver"]
        api_w = result.model.models["ctr"].coefficients.means.cpu()
        del est, result
        out = os.path.join(tmp, f"out5-{mode}")
        extra = ["--output-dir", out]
        trace_path = None
        if streaming:
            trace_path = os.path.join(tmp, "stream5-trace.json")
            extra += ["--streaming", streaming, "--trace-out", trace_path]
        fit = cli_run(torch, game_train,
                      cli5_argv(train_path, val_path, coordinate) + extra)
        w = model_io.load_game_model(os.path.join(out, "best"),
                                     device="cpu").models["ctr"]
        bits = torch.equal(w.coefficients.means, api_w)
        got = fit["launches"]
        evals = solver["gradient_evaluations"]
        entry = {"fit_seconds": fit["seconds"],
                 "api_fit_seconds": api["seconds"], "launches": got,
                 "api_launches": api["launches"], "solver": solver,
                 "auc": fit["summary"]["best_metrics"]["AUC"],
                 "bit_identical_to_api": bits,
                 "max_memory_allocated": fit["peak_bytes"]}
        if not bits:
            gap = float((w.coefficients.means - api_w).abs().max())
            failures.append(f"{mode}: the CLI's coefficients are not "
                            f"GameEstimator.fit's (largest gap {gap})")
        if got != api["launches"]:
            failures.append(f"{mode}: launches {got}, the API fit's "
                            f"{api['launches']}")
        if mode == "hybrid" and not (
                got["hot_value_and_gradient"] == evals
                and got["cold_grad"] == evals > 0):
            failures.append(f"hybrid: launches {got} for {evals} "
                            f"evaluations")
        if mode == "ell" and not got["ell_rmatvec"] == evals > 0:
            failures.append(f"ell: launches {got} for {evals} gradient "
                            f"evaluations")
        if mode == "stream":
            entry["verify"] = obs_verify(trace_path)
            if not (got["hot_margins"] > 0 and got["hot_rmatvec"] > 0):
                failures.append(f"stream: launches {got}")
            if entry["verify"]["rc"] != 0:
                failures.append(f"stream: cli/obs verify: "
                                f"{entry['verify']['output']}")
        report[mode] = entry
        if scoring is not None:
            # game_score's own process has run beside this first fit.
            check_score_process(np, card, scoring, cli4)
            scoring = None
    emit("game_cli_sparse", card=card, rows=train.num_rows,
         val_rows=val.num_rows, dim=train.shard_dim("global"),
         data=written, iterations=CLI_SPARSE_ITERATIONS, streaming=CLI_STREAMING,
         fits=report)
    if failures:
        raise AssertionError("game_cli_sparse: " + "; ".join(failures))
    return {m: r["launches"] for m, r in report.items()}


# -- sparse_re_train / sparse_re_parity -----------------------------------

# The reference's flagship sparse random effect
# (dev-scripts/flagship_sparse_re.py): per-entity 16-column pools over
# d = 1,000,000, 8 nonzeros a row, planted per-entity coefficients,
# min 2 rows an entity, L2 1.0, 12 L-BFGS iterations at tolerance 1e-6.
# Its 10,000,000 rows and 1,000,000 entities are cut to a quarter, 10
# rows an entity kept, d and the pools not cut: at full size the script
# took 708.9 s against its 600 s aim (PERF.md §4).
SPARSE_RE_ROWS = 2_500_000
SPARSE_RE_ENTITIES = 250_000
SPARSE_RE_DIM = 1_000_000
SPARSE_RE_POOL = 16
SPARSE_RE_NNZ = 8
SPARSE_RE_SEED = 7
SPARSE_RE_LOWER_BOUND = 2
SPARSE_RE_ITERATIONS = 12
SPARSE_RE_AUC_BAR = 0.9
# Staging-cache shards whose commit markers are deleted before the third
# coordinate: the second and the second-to-last.
SPARSE_RE_RESTAGE = (1, -2)
SPARSE_RE_PARITY_ROWS = 300_000
SPARSE_RE_PARITY_ENTITIES = 30_000
# The dense projected coordinate of sparse_re_parity: an intercept, the
# shard's STANDARDIZATION, the Pearson cap at ratio 0.5.
PROJECTED_ROWS = 20_000
PROJECTED_ENTITIES = 500
PROJECTED_DIM = 32
PROJECTED_RATIO = 0.5
SCORE_TOL = 1e-5


def make_sparse_re_arrays(np, rows: int, entities: int) -> dict:
    """The flagship's rows from the seed, made as the reference's script
    makes them."""
    d, pool, nnz = SPARSE_RE_DIM, SPARSE_RE_POOL, SPARSE_RE_NNZ
    rng = np.random.default_rng(SPARSE_RE_SEED)
    ids = rng.integers(0, entities, size=rows).astype(np.int32)
    pools = rng.integers(0, d, size=(entities, pool)).astype(np.int32)
    slot = rng.integers(0, pool, size=(rows, nnz))
    idx = np.sort(pools[ids[:, None], slot], axis=1)
    dup = np.zeros_like(idx, bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    vals = rng.normal(size=(rows, nnz)).astype(np.float32)
    idx[dup] = d
    vals[dup] = 0.0
    beta = rng.normal(0, 1.0, size=(entities, pool)).astype(np.float32)
    margin = (np.where(dup, 0.0, vals)
              * beta[ids[:, None], slot]).sum(axis=1)
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-margin))).astype(
        np.float32)
    return {"ids": ids, "indices": idx, "values": vals, "labels": y}


# The flagship's rows are made by a child process started before build,
# as config 4's are: the same function and seed, so the same bits.
_SPARSE_RE_CHILD = """\
import os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
cs.send_arrays(np, sys.stdout.buffer,
               cs.make_sparse_re_arrays(np, int(sys.argv[1]),
                                        int(sys.argv[2])))
"""


def start_sparse_re_data(rows: int, entities: int):
    return start_child(_SPARSE_RE_CHILD, rows, entities)


def collect_sparse_re_data(np, proc) -> dict:
    arrays = receive_arrays(np, proc)
    if proc.wait() != 0:
        raise RuntimeError(f"the sparse RE generator exited "
                           f"{proc.returncode}")
    return arrays


def sparse_re_dataset(np, arrays: dict, entities: int):
    from photon_ml_torch.data.game_data import GameDataset, SparseShard

    n = arrays["ids"].shape[0]
    return GameDataset(
        response=arrays["labels"], offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32),
        feature_shards={"re": SparseShard(arrays["indices"],
                                          arrays["values"], SPARSE_RE_DIM)},
        entity_ids={"userId": arrays["ids"]},
        num_entities={"userId": entities}, intercept_index={})


def sparse_re_config(iterations: int = SPARSE_RE_ITERATIONS):
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)

    return GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations,
                                  tolerance=1e-6),
        regularization=RegularizationContext(RegularizationType.L2, 1.0))


def sparse_re_coordinate(ds, device: str, cache_dir=None):
    from photon_ml_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_torch.ops import losses

    return RandomEffectCoordinate(
        ds, "userId", "re", losses.LOGISTIC, sparse_re_config(),
        lower_bound=SPARSE_RE_LOWER_BOUND, staging_cache_dir=cache_dir,
        device=device)


def staged_reckoning(np, ids, entities: int, width: int) -> dict:
    """The staged blocks' bytes before the run: every kept entity's
    capacity × ``width`` float32 features, beside its labels, weights and
    example ids (the bucketing's own capacities)."""
    counts = np.bincount(ids, minlength=entities)
    kept = counts[counts >= SPARSE_RE_LOWER_BOUND]
    caps = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(kept, 1))).astype(
        np.int64))
    slots = int(caps.sum())
    return {"entities": int(kept.size), "slots": slots,
            "block_bytes": slots * (width * 4 + 4 + 4 + 8),
            "table_bytes": entities * width * 4}


def same_waves(torch, a, b) -> bool:
    """Two coordinates' staged waves equal bit for bit (compared on the
    first one's device)."""
    if len(a._waves) != len(b._waves):
        return False
    for wa, wb in zip(a._waves, b._waves):
        for f in ("X", "y", "w", "ex", "rows", "cols"):
            x, y = getattr(wa, f), getattr(wb, f)
            if not torch.equal(x, y.to(x.device)):
                return False
    return True


class StagingEvents:
    """The staging events of a block of code (a listener on the default
    emitter for its duration)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        from photon_ml_torch.utils import events as ev

        ev.default_emitter.register(self.events.append)
        return self

    def __exit__(self, *exc):
        from photon_ml_torch.utils import events as ev

        ev.default_emitter.unregister(self.events.append)

    def of(self, kind: str) -> list:
        return [e for e in self.events if type(e).__name__ == kind]


def profiled(torch, fn, device: str = "cuda") -> tuple:
    """``fn()`` under torch.profiler, recording the card's activity only
    (a host-side record of a solver's many small operators costs minutes
    to reduce): its result, its wall seconds, and the card's busy time
    against that wall."""
    from torch.profiler import ProfilerActivity, profile

    if device != "cuda":
        out, wall = timed_call(torch, fn, device)
        return out, wall, {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall = synced_seconds(torch, fn)
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    return out, wall, {"device_busy_us": busy_us,
                       "device_busy_share": busy_us * 1e-6 / wall,
                       "device_launches": sum(e.count for e in events),
                       "profile_seconds": time.perf_counter() - t0 - wall}


def timed_call(torch, fn, device: str) -> tuple:
    if device == "cuda":
        return synced_seconds(torch, fn)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def reset_row_launches():
    from photon_ml_torch.ops.kernels import re_rows as rr

    rr.gather_rows.launches = rr.scatter_rows_.launches = 0


def row_launches() -> dict:
    from photon_ml_torch.ops.kernels import re_rows as rr

    return {"gather": rr.gather_rows.launches,
            "scatter": rr.scatter_rows_.launches}


def phase_sparse_re_train(np, torch, card: str, generator,
                          entities: int = SPARSE_RE_ENTITIES,
                          device: str = "cuda") -> dict:
    """The flagship sparse random effect through RandomEffectCoordinate:
    cold staging into a staging cache, a first and a steady train_model
    plus score, the AUC, the row movers' launches against the waves and
    the re.fit_wave spans, then a warm re-stage from the cache (the same
    bits) and a partial one (exactly the shards whose markers were
    deleted restage)."""
    from photon_ml_torch import obs
    from photon_ml_torch.evaluation.evaluators import auc
    from photon_ml_torch.game.models import SubspaceRandomEffectModel
    from photon_ml_torch.ops.kernels import re_rows as rr

    t0 = time.perf_counter()
    arrays = collect_sparse_re_data(np, generator)
    wait = time.perf_counter() - t0
    rows = arrays["ids"].shape[0]
    ds = sparse_re_dataset(np, arrays, entities)
    reckoning = staged_reckoning(np, arrays["ids"], entities,
                                 SPARSE_RE_POOL)
    emit("sparse_re_reckoning", card=card, rows=rows, entities=entities,
         dim=SPARSE_RE_DIM, nnz_per_row=SPARSE_RE_NNZ,
         generate_wait_seconds=wait,
         host_data_bytes=int(sum(a.nbytes for a in arrays.values())),
         dense_matrix_bytes=rows * SPARSE_RE_DIM * 4,
         dense_table_bytes=entities * SPARSE_RE_DIM * 4,
         staged_at_width_16=reckoning,
         card_free_bytes=(torch.cuda.mem_get_info()[0]
                          if device == "cuda" else None))
    cache = tempfile.mkdtemp(prefix="chip_smoke_re_cache_")
    atexit.register(shutil.rmtree, cache, True)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    tracer, metrics = obs.Tracer(), obs.MetricsRegistry()
    offsets = torch.zeros(rows, dtype=torch.float32, device=device)
    labels = torch.as_tensor(arrays["labels"], device=device)
    failures = []
    runs = {}
    with StagingEvents() as cold_events, obs.activated(tracer, metrics):
        t = time.perf_counter()
        coord = sparse_re_coordinate(ds, device, cache)
        init_seconds = time.perf_counter() - t
        waves = coord.num_waves
        for run in ("first", "steady"):
            reset_row_launches()
            spans_before = span_counts(tracer.chrome_trace()).get(
                "re.fit_wave", {"spans": 0})["spans"]
            model, fit_s, busy = profiled(
                torch, lambda: coord.train_model(offsets), device)
            launches = row_launches()
            scores, score_s = timed_call(torch, lambda: coord.score(model),
                                         device)
            spans = span_counts(tracer.chrome_trace())["re.fit_wave"][
                "spans"] - spans_before
            runs[run] = {"train_seconds": fit_s, "score_seconds": score_s,
                         "launches": launches, "fit_wave_spans": spans,
                         **busy}
            if device == "cuda" and not (
                    launches["gather"] == launches["scatter"] == waves
                    == spans):
                failures.append(f"{run}: re_rows launches {launches}, "
                                f"{spans} re.fit_wave spans, {waves} waves")
        t = time.perf_counter()
        coord.wait_staged()
        join_seconds = time.perf_counter() - t
    auc_value = float(auc(scores, labels))
    finish = cold_events.of("StagingFinish")
    shards = cold_events.of("StagingShard")
    table = coord.subspace_cols.shape
    peak = (torch.cuda.max_memory_allocated() - base
            if device == "cuda" else None)
    counters = {k: v for k, v in metrics.snapshot().items()
                if k.startswith("photon_staging")}
    if not isinstance(model, SubspaceRandomEffectModel):
        failures.append(f"model is {type(model).__name__}")
    if tuple(model.means.shape) != table or table[1] > 64:
        failures.append(f"table {tuple(model.means.shape)}")
    if auc_value <= SPARSE_RE_AUC_BAR:
        failures.append(f"AUC {auc_value} <= {SPARSE_RE_AUC_BAR}")
    if not (len(finish) == 1 and len(shards) == coord._stager.num_shards
            and all(e.source == "staged" for e in shards)):
        failures.append(f"cold staging events: {len(shards)} shards, "
                        f"{len(finish)} finishes")
    cold = {"init_seconds": init_seconds,
            "staging_wall_seconds": finish[0].wall_seconds if finish
            else None,
            "join_seconds": join_seconds, "shards": len(shards),
            "staging_spans": span_counts(tracer.chrome_trace()).get(
                "staging")}

    # A warm re-stage from the complete cache entry: the same bits.
    num_shards = coord._stager.num_shards
    with StagingEvents() as warm_events:
        t = time.perf_counter()
        warm = sparse_re_coordinate(ds, device, cache).wait_staged()
        warm_seconds = time.perf_counter() - t
    warm_start = warm_events.of("StagingStart")[0]
    warm_same = (same_waves(torch, coord, warm)
                 and np.array_equal(coord.subspace_cols, warm.subspace_cols)
                 and torch.equal(coord._sp_flatpos, warm._sp_flatpos))
    if warm_start.cached_shards != num_shards or not warm_same:
        failures.append(f"warm: {warm_start.cached_shards} of {num_shards} "
                        f"cached, bit-equal {warm_same}")
    del warm

    # Two shards' commit markers deleted: exactly they restage.
    (key,) = os.listdir(cache)
    victims = sorted({i % num_shards for i in SPARSE_RE_RESTAGE})
    for i in victims:
        os.remove(os.path.join(cache, key, f"s{i}.ok"))
    with StagingEvents() as part_events:
        t = time.perf_counter()
        part = sparse_re_coordinate(ds, device, cache).wait_staged()
        part_seconds = time.perf_counter() - t
    restaged = sorted(e.index for e in part_events.of("StagingShard")
                      if e.source == "staged")
    part_same = same_waves(torch, coord, part)
    if restaged != victims or not part_same:
        failures.append(f"partial: restaged {restaged}, deleted {victims}, "
                        f"bit-equal {part_same}")
    del part

    # The row movers at this path's wave shape (d = A), bit for bit.
    wave_rows = coord.wave_rows
    kernel_check = (check_re_rows(torch, rr, model.means.contiguous(),
                                  wave_rows[0], "sparse_re wave 0", True)
                    if device == "cuda" else None)
    emit("sparse_re_train", card=card, rows=rows, entities=entities,
         dim=SPARSE_RE_DIM, iterations=SPARSE_RE_ITERATIONS,
         buckets=[(b.capacity, b.num_entities)
                  for b in coord.bucketing.buckets],
         waves=waves, shards=num_shards, table=list(table),
         widths=sorted({int(w.cols.shape[1]) for w in coord._waves}),
         cold=cold, runs=runs, auc=auc_value,
         auc_bar=SPARSE_RE_AUC_BAR, peak_bytes=peak,
         staged_bytes=sum(sum(t.nbytes for t in (
             w.X, w.y, w.w, w.ex, w.rows, w.cols)) for w in coord._waves),
         staging_counters=counters,
         warm={"seconds": warm_seconds,
               "cached_shards": warm_start.cached_shards,
               "bit_equal": warm_same},
         partial={"seconds": part_seconds, "deleted": victims,
                  "restaged": restaged, "bit_equal": part_same},
         kernel_check=kernel_check)
    if failures:
        raise AssertionError("sparse_re_train: " + "; ".join(failures))
    return {"waves": waves, "launches": runs["first"]["launches"],
            "check": kernel_check}


def projected_dense_dataset(np):
    """A dense shard whose entities each use about half of its columns,
    an intercept at column 0, and its STANDARDIZATION."""
    from photon_ml_torch.data.game_data import GameDataset
    from photon_ml_torch.normalization import (NormalizationType,
                                               build_normalization)

    n, E, d = PROJECTED_ROWS, PROJECTED_ENTITIES, PROJECTED_DIM
    rng = np.random.default_rng(SPARSE_RE_SEED)
    ids = rng.integers(0, E, n).astype(np.int32)
    emask = rng.random((E, d)) < 0.5
    X = (rng.normal(1.0, 2.0, size=(n, d))
         * (rng.random((n, d)) < 0.6) * emask[ids]).astype(np.float32)
    X[:, 0] = 1.0
    beta = rng.normal(size=(E, d)) * 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(X * beta[ids]).sum(1)))
         ).astype(np.float32)
    ds = GameDataset(
        response=y, offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32), feature_shards={"re": X},
        entity_ids={"userId": ids}, num_entities={"userId": E},
        intercept_index={"re": 0})
    norm = build_normalization(
        NormalizationType.STANDARDIZATION, means=X.mean(0),
        variances=X.var(0), intercept_index=0)
    return ds, norm


def phase_sparse_re_parity(np, torch, card: str) -> dict:
    """sparse_re_train's path at 300,000 rows on the card and on the
    CPU: staged bits, coefficients, scores and AUC; then a dense
    projected coordinate with normalization and the Pearson cap."""
    from photon_ml_torch.evaluation.evaluators import auc
    from photon_ml_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_torch.ops import losses
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                               VarianceComputationType)
    from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                      RegularizationType)

    failures = []
    arrays = make_sparse_re_arrays(np, SPARSE_RE_PARITY_ROWS,
                                   SPARSE_RE_PARITY_ENTITIES)
    ds = sparse_re_dataset(np, arrays, SPARSE_RE_PARITY_ENTITIES)
    labels = torch.from_numpy(arrays["labels"])
    out = {}
    coords, models, scores = {}, {}, {}
    for k, dev in enumerate(("cuda", "cpu")):
        t = time.perf_counter()
        coords[dev] = sparse_re_coordinate(ds, dev).wait_staged()
        stage_s = time.perf_counter() - t
        off = torch.zeros(ds.num_rows, dtype=torch.float32, device=dev)
        reset_row_launches()
        models[dev], fit_s = timed_call(
            torch, lambda: coords[dev].train_model(off), dev)
        if k == 0:
            launches = row_launches()
        scores[dev] = coords[dev].score(models[dev]).cpu()
        out[dev] = {"stage_seconds": stage_s, "train_seconds": fit_s,
                    "auc": float(auc(scores[dev], labels))}
    waves = coords["cuda"].num_waves
    staged_same = same_waves(torch, coords["cuda"], coords["cpu"])
    coef = float((models["cuda"].means.cpu()
                  - models["cpu"].means).abs().max())
    # One model scored on both devices: the score paths alone.
    cross = float((coords["cuda"].score(models["cpu"]).cpu()
                   - scores["cpu"]).abs().max())
    auc_gap = abs(out["cuda"]["auc"] - out["cpu"]["auc"])
    if not (staged_same and coef <= PARITY_TOL and auc_gap <= PARITY_TOL
            and cross <= SCORE_TOL):
        failures.append(f"sparse: staged bit-equal {staged_same}, coef "
                        f"{coef}, AUC gap {auc_gap}, score {cross}")
    if not launches["gather"] == launches["scatter"] == waves:
        failures.append(f"sparse: re_rows launches {launches}, {waves} "
                        f"waves")
    del coords, models, scores

    ds_d, norm = projected_dense_dataset(np)
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=50, tolerance=1e-7),
        regularization=RegularizationContext(RegularizationType.L2, 1.0),
        variance_computation=VarianceComputationType.SIMPLE)
    dense = {}
    for dev in ("cuda", "cpu"):
        c = RandomEffectCoordinate(
            ds_d, "userId", "re", losses.LOGISTIC, cfg, lower_bound=2,
            norm=norm, features_to_samples_ratio=PROJECTED_RATIO,
            device=dev)
        off = torch.zeros(ds_d.num_rows, dtype=torch.float32, device=dev)
        m = c.train_model(off)
        m = c.compute_model_variances(m, off)
        dense[dev] = (c, m)
    (cc, mc), (_, mh) = dense["cuda"], dense["cpu"]
    dense_coef = float((mc.means.cpu() - mh.means).abs().max())
    dense_var = float(((mc.variances.cpu() - mh.variances).abs()
                       / mh.variances.abs().clamp(min=1.0)).max())
    dense_score = float((cc.score(mh).cpu()
                         - dense["cpu"][0].score(mh)).abs().max())
    if not (dense_coef <= PARITY_TOL and dense_var <= PARITY_TOL
            and dense_score <= SCORE_TOL and not cc.subspace
            and cc.projection):
        failures.append(f"dense projected: coef {dense_coef}, variances "
                        f"{dense_var}, score {dense_score}")
    emit("sparse_re_parity", card=card, rows=SPARSE_RE_PARITY_ROWS,
         entities=SPARSE_RE_PARITY_ENTITIES, dim=SPARSE_RE_DIM,
         devices=out, staged_bit_equal=staged_same, max_coef_gap=coef,
         auc_gap=auc_gap, cross_score_gap=cross, tol=PARITY_TOL,
         score_tol=SCORE_TOL, launches=launches, waves=waves,
         dense_projected={"rows": PROJECTED_ROWS,
                          "entities": PROJECTED_ENTITIES,
                          "dim": PROJECTED_DIM, "ratio": PROJECTED_RATIO,
                          "max_coef_gap": dense_coef,
                          "max_variance_gap": dense_var,
                          "cross_score_gap": dense_score})
    if failures:
        raise AssertionError("sparse_re_parity: " + "; ".join(failures))
    return {"launches": launches, "waves": waves}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import photon_ml_torch
    from photon_ml_torch.device import resolve_device
    from photon_ml_torch.ops.kernels import _build

    if os.path.dirname(os.path.dirname(photon_ml_torch.__file__)) != ROOT:
        raise ImportError(f"photon_ml_torch was imported from "
                          f"{photon_ml_torch.__file__}, not beside "
                          f"this script")
    resolve_device("cuda")
    train_generator = start_train_data(TRAIN_ROWS)
    sparse_re_generator = start_sparse_re_data(SPARSE_RE_ROWS,
                                               SPARSE_RE_ENTITIES)
    card = nvidia_smi_line()
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    atexit.register(stop_hot_pass_variants)
    start_hot_pass_variant(TIMING_DEFINE)
    built = _build.build()
    emit("build", seconds=time.perf_counter() - t0, built=built,
         sources=_build.sources())

    checks = phase_kernels(torch, np)
    floor_us = launch_floor_us(torch)
    launches, flushes = phase_serve(np, torch, card)
    sparse_generator = start_sparse_data(SPARSE_ROWS)
    cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    atexit.register(shutil.rmtree, cli_tmp, True)
    cli_files = start_cli_data(cli_tmp)
    trained = phase_train(np, torch, card, train_generator)
    re_checks = phase_re_rows(np, torch, trained)
    resumed = phase_train_resume(np, torch, card, trained)
    re_launches = {"gather": trained["gathers"],
                   "scatter": trained["scatters"]}
    train4, val4 = trained.pop("train"), trained.pop("val")
    f32_train = {k: trained[k] for k in ("aucs", "max_memory_allocated")}
    del trained
    torch.cuda.empty_cache()
    phase_train_bf16(np, torch, card, train4, val4, f32_train)
    del train4, val4
    torch.cuda.empty_cache()
    train4, val4 = make_train_data(np, PARITY_ROWS)
    phase_train_parity(np, torch, card, train4, val4)
    phase_train_parity(np, torch, card, train4, val4, "bfloat16",
                       "train_bf16_parity", PARITY_EARLY_ITERATIONS)
    del train4, val4
    torch.cuda.empty_cache()
    cli4 = phase_game_cli_train(np, torch, card, cli_files)
    torch.cuda.empty_cache()
    sparse_trained = phase_sparse_train(np, torch, card, sparse_generator)
    ell_checks, rmatvec_checks = phase_ell_scatter(np, torch,
                                                   sparse_trained)
    down_sampled = phase_sparse_down_sampled(np, torch, card, sparse_trained)
    sparse_launches = {"lbfgs": sparse_trained["launches"],
                       "tron": sparse_trained["tron_launches"]}
    train5, val5 = sparse_trained["train"], sparse_trained["val"]
    ell9 = sparse_trained["ell"]
    del sparse_trained
    torch.cuda.empty_cache()
    stream_trained = phase_stream_train(
        np, torch, card, train5.subset(slice(0, STREAM_ROWS)), val5)
    stream_checks = phase_stream_kernels(np, torch, stream_trained)
    stream_resumed = phase_stream_resume(np, torch, card, stream_trained)
    stream_launches = stream_trained["launches"]
    del stream_trained
    torch.cuda.empty_cache()
    hybrid_trained = phase_hybrid_train(np, torch, card, train5, val5)
    cold_checks = phase_cold_grad(np, torch, hybrid_trained)
    hybrid_launches = hybrid_trained["launches"]
    hybrid_ell_launches = hybrid_trained["ell_launches"]
    hybrid_rows = hybrid_trained["rows"]
    hybrid_hot = hybrid_trained["hot"]
    hot_pass_checks = hybrid_trained["hot_pass_checks"]
    del hybrid_trained
    torch.cuda.empty_cache()
    hybrid_bf16 = phase_hybrid_bf16_train(np, torch, card, train5, val5,
                                          ell9)
    torch.cuda.empty_cache()
    stream_bf16 = phase_stream_train(
        np, torch, card, train5.subset(slice(0, STREAM_BF16_ROWS)), val5,
        "bfloat16", "stream_bf16_train")
    del stream_bf16["coord"], train5, val5
    torch.cuda.empty_cache()
    parity = phase_sparse_parity(np, torch, card)
    cli5 = phase_game_cli_sparse(np, torch, card, cli_files, parity, cli4)
    torch.cuda.empty_cache()
    stream_parity_f32 = phase_stream_parity(np, torch, card, parity)
    tron_hybrid_launches = phase_hybrid_parity(np, torch, card, parity)
    tron_hybrid_bf16_launches = phase_hybrid_parity(
        np, torch, card, parity, "bfloat16", "hybrid_bf16_parity")
    ds_parity = phase_down_sampling_parity(np, torch, card, parity)
    phase_glm_train(np, torch, card)
    phase_glm_gradient_step(np, torch, card)
    torch.cuda.empty_cache()
    sparse_re = phase_sparse_re_train(np, torch, card, sparse_re_generator)
    torch.cuda.empty_cache()
    sparse_re_parity = phase_sparse_re_parity(np, torch, card)

    main_shape = next(c for c in checks if c["n"] == 64
                      and c["cache"] == "float32")
    table = [{
        "name": "serving_score", "route": "cuda",
        "source": "photon_ml_torch/csrc/serving_score.cu",
        "replaces": "photon_ml_tpu/ops/kernels/serving_score.py:45",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "call_ms": main_shape["call_ms"], "launch_floor_us": floor_us,
        "shape": "n=64 d=8 E=4097 float32 (serving, config a)",
        "flushes": flushes, "checks": checks}]
    # The re_rows entries report the largest per-user wave, the shape
    # that carries most of the training path's lanes.
    timed = [c for c in re_checks if "gather" in c]
    main_wave = max((c for c in timed if c["wave"].startswith("per-user")
                     and "padding" not in c["wave"]), key=lambda c: c["B"])
    shape = (f"B={main_wave['B']} d={main_wave['d']} E={main_wave['E']} "
             f"({main_wave['wave']}, {main_wave['valid']} valid lanes)")
    for name, key, line, plain_key in (
            ("re_gather_rows", "gather", 60, "plain_ms"),
            ("re_scatter_rows", "scatter", 90, "plain_call_ms")):
        m = main_wave[key]
        table.append({
            "name": name, "route": "cuda",
            "source": "photon_ml_torch/csrc/re_rows.cu",
            "replaces": f"photon_ml_tpu/ops/kernels/re_rows.py:{line}",
            "launches": re_launches[key],
            "resume_launches": resumed[key + "s"],
            "game_cli_launches": cli4["launches"][
                "gather_rows" if key == "gather" else "scatter_rows_"],
            "sparse_re_launches": sparse_re["launches"][key],
            "sparse_re_waves": sparse_re["waves"],
            "sparse_re_parity_launches": sparse_re_parity["launches"][key],
            "sparse_re_wave": {k: sparse_re["check"][key][k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "library_ms")},
            "sparse_re_shape": (f"B={sparse_re['check']['B']} "
                                f"d={sparse_re['check']['d']} "
                                f"E={sparse_re['check']['E']} (the "
                                f"subspace table's first wave)"),
            "max_abs_err": 0.0,
            "ms": m["ms"], "plain_ms": m[plain_key],
            "plain_timing": ("graph replay" if plain_key == "plain_ms" else
                             "per call from Python: the plain scatter reads "
                             "the device to compact its valid lanes"),
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "call_ms": m["call_ms"], "launch_floor_us": floor_us,
            "shape": shape, "checks": len(re_checks)})
    # The generic route's main paths are the streamed chunks' cold tier
    # and the hybrid cold margins; it is timed at the ELL main shape, over
    # the row terms that route would read there.
    main_ell = ell_checks[0]
    table.append({
        "name": "ell_scatter", "route": "cuda",
        "source": "photon_ml_torch/csrc/ell_scatter.cu",
        "replaces": "photon_ml_tpu/ops/kernels/ell_scatter.py:68",
        "launches": stream_launches["ell_scatter"],
        "hybrid_launches": hybrid_launches["ell_scatter"],
        "hybrid_bf16_launches": hybrid_bf16["launches"]["ell_scatter"],
        "stream_bf16_launches": stream_bf16["launches"]["ell_scatter"],
        "stream_resume_launches": stream_resumed["ell_scatter"],
        "game_cli_launches": {m: cli5[m]["scatter_rowterm"]
                              for m in ("hybrid", "stream")},
        "max_abs_err": max(c["max_abs_err"] for c in ell_checks),
        "parity_rel": max(c["parity_rel"] for c in ell_checks),
        "column_ratio": max(c["column_ratio"] for c in ell_checks),
        "ms": main_ell["ms"], "plain_ms": main_ell["plain_ms"],
        "bound_ms": main_ell["bound_ms"], "bound_by": main_ell["bound_by"],
        "library_ms": main_ell["library_ms"],
        "library_call": "Tensor.index_add_ (ids clamped outside)",
        "call_ms": main_ell["call_ms"],
        "shape": (f"n={main_ell['n']} k={main_ell['k']} "
                  f"dim={main_ell['dim']} (sparse_train gradient's row "
                  f"terms; launches from stream_train and hybrid_train)"),
        "checks": len(ell_checks)})
    main_fused = rmatvec_checks[0]
    table.append({
        "name": "ell_rmatvec", "route": "cuda",
        "source": "photon_ml_torch/csrc/ell_scatter.cu",
        "replaces": "photon_ml_tpu/ops/kernels/ell_scatter.py:68",
        "launches": sparse_launches["lbfgs"],
        "tron_launches": sparse_launches["tron"],
        "hybrid_ell_launches": hybrid_ell_launches,
        "down_sampled_launches": down_sampled["launches"],
        "down_sampling_parity_launches": ds_parity["ell"]["ell_rmatvec"],
        "game_cli_launches": cli5["ell"]["ell_rmatvec"],
        "max_abs_err": max(c["max_abs_err"] for c in rmatvec_checks),
        "parity_rel": max(c["parity_rel"] for c in rmatvec_checks),
        "column_ratio": max(c["column_ratio"] for c in rmatvec_checks),
        "ms": main_fused["ms"], "plain_ms": main_fused["plain_ms"],
        "bound_ms": main_fused["bound_ms"],
        "bound_by": main_fused["bound_by"],
        "library_ms": main_fused["library_ms"],
        "library_device_ms": main_fused["library_device_ms"],
        "library_call": main_fused["library_call"],
        "call_ms": main_fused["call_ms"],
        "queued_ms": main_fused["queued_ms"],
        "old_route_ms": main_fused["old_route_ms"],
        "old_route_call_ms": main_fused["old_route_call_ms"],
        "gather_ms": main_fused["gather_ms"],
        "extra_bytes": main_fused["extra_bytes"],
        "old_route_extra_bytes": main_fused["old_route_extra_bytes"],
        "shape": (f"n={main_fused['n']} k={main_fused['k']} "
                  f"dim={main_fused['dim']}, {main_fused['nnz']} valid "
                  f"slots (sparse_train gradient)"),
        "checks": len(rmatvec_checks)})
    # The stream_fused rows report the fit's own int8 chunk; the float32
    # (ring route) and bfloat16 timings of the same chunk ride beside
    # them, with the float32 launches of stream_parity's fits.
    for name, line in (("hot_margins", 61), ("hot_rmatvec", 112)):
        mine = [c for c in stream_checks if c["kernel"] == name]
        main8 = next(c for c in mine if c["shape"] == "main"
                     and c["dtype"] == "int8")
        main32 = next(c for c in mine if c["shape"] == "main"
                      and c["dtype"] == "float32")
        table.append({
            "name": name, "route": "cuda",
            "source": "photon_ml_torch/csrc/stream_fused.cu",
            "replaces": f"photon_ml_tpu/ops/kernels/stream_fused.py:{line}",
            "launches": stream_launches[name],
            "hybrid_launches": hybrid_launches[name],
            "stream_bf16_launches": stream_bf16["launches"][name],
            "hybrid_bf16_launches": hybrid_bf16["launches"][name],
            "stream_resume_launches": stream_resumed[name],
            "game_cli_launches": {m: cli5[m][name]
                                  for m in ("hybrid", "stream")},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "parity_rel": max(c["parity_rel"] for c in mine),
            "term_ratio": max(c["term_ratio"] for c in mine),
            "ms": main8["ms"], "plain_ms": main8["plain_ms"],
            "bound_ms": main8["bound_ms"], "bound_by": main8["bound_by"],
            "library_ms": main8["library_ms"],
            "library_call": main8["library_call"],
            "call_ms": main8["call_ms"],
            "shape": (f"n={main8['n']} H={main8['H']} int8 (stream_train "
                      f"chunk)"),
            "by_dtype": {c["dtype"]: {k: c[k] for k in (
                "ms", "call_ms", "plain_ms", "library_ms", "library_call",
                "bound_ms", "bound_share", "route")}
                for c in mine if c["shape"] == "main"},
            "float32": {k: main32[k] for k in (
                "ms", "library_ms", "bound_ms", "bound_share", "route")},
            "stream_parity_f32_launches":
                stream_parity_f32["launches"][name],
            "stream_parity_f32_routes": stream_parity_f32["routes"],
            "routes": {f"{c['shape']} {c['n']}x{c['H']} {c['dtype']}":
                       c["route"] for c in mine},
            "hybrid_block": hybrid_hot[name],
            "checks": len(mine)})
    # The hybrid block's fused pass (rows 5-6 of the table, redesigned):
    # timed and checked at hybrid_train's block; the H·v pass launches on
    # hybrid_parity's TRON fit.
    for name, launches_on in (
            ("hot_value_and_gradient", hybrid_launches),
            ("hot_hessian_vector", tron_hybrid_launches)):
        t = hybrid_hot[name]
        table.append({
            "name": name, "route": "cuda",
            "source": "photon_ml_torch/csrc/hot_pass.cu",
            "replaces": "photon_ml_tpu/ops/kernels/stream_fused.py:61",
            "also_replaces": "photon_ml_tpu/ops/kernels/stream_fused.py:112",
            "launches": launches_on[name],
            "launches_on": ("hybrid_train's L-BFGS fit"
                            if name == "hot_value_and_gradient" else
                            "hybrid_parity's TRON fit"),
            "down_sampling_parity_launches":
                ds_parity["hybrid"][name],
            "game_cli_launches": cli5["hybrid"][name],
            "max_abs_err": hot_pass_checks[name]["max_abs_err"],
            "parity_rel": hot_pass_checks[name]["parity_rel"],
            "column_ratio": hot_pass_checks[name]["column_ratio"],
            "bits": hot_pass_checks["bits"],
            **{k: t[k] for k in (
                "ms", "ms_runs", "call_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "library_ms", "library_call",
                "old_route_ms", "old_route_runs", "old_route")},
            **{k: t[k] for k in ("ring", "ring_ms", "no_transpose_ms")
               if k in t},
            "shape": (f"n={t['n']} H={t['H']} float32 (hybrid_train's hot "
                      f"block, {hybrid_rows} rows)")})
    # The bfloat16 entry of the same pass: checked, timed and launched at
    # hybrid_bf16_train's 9.5M-row block (the L-BFGS fit, then the TRON
    # solve on the same block); the launches on hybrid_bf16_parity's
    # 285,000-row TRON fit ride beside them.
    bf16_checks = hybrid_bf16["hot_pass_checks"]
    for name, launches_on, label in (
            ("hot_value_and_gradient", hybrid_bf16["launches"],
             "hybrid_bf16_train's L-BFGS fit"),
            ("hot_hessian_vector", hybrid_bf16["tron"]["launches"],
             f"hybrid_bf16_train's {TRON_BF16_ITERATIONS}-iteration TRON "
             f"solve")):
        t = hybrid_bf16["hot"][name]
        table.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "photon_ml_torch/csrc/hot_pass.cu",
            "replaces": "photon_ml_tpu/ops/kernels/stream_fused.py:61",
            "also_replaces": "photon_ml_tpu/ops/kernels/stream_fused.py:112",
            "launches": launches_on[name], "launches_on": label,
            "tron_launches": hybrid_bf16["tron"]["launches"][name],
            "parity_tron_launches": tron_hybrid_bf16_launches[name],
            "max_abs_err": bf16_checks[name]["max_abs_err"],
            "parity_rel": bf16_checks[name]["parity_rel"],
            "column_ratio": bf16_checks[name]["column_ratio"],
            "bits": bf16_checks["bits"],
            **{k: t[k] for k in (
                "ms", "ms_runs", "call_ms", "plain_ms", "plain_timing",
                "bound_ms", "bound_by", "bound_share", "library_ms",
                "library_call", "old_route_ms", "old_route_runs",
                "old_route", "ring", "ring_ms", "no_transpose_ms")},
            "shape": (f"n={t['n']} H={t['H']} bfloat16 (hybrid_bf16_train's "
                      f"hot block, {hybrid_bf16['rows']} rows)")})
    main_cold = cold_checks[0]
    table.append({
        "name": "cold_grad", "route": "cuda",
        "source": "photon_ml_torch/csrc/cold_grad.cu",
        "replaces": "dev-scripts/exp_cold_gather.py:58",
        "launches": hybrid_launches["cold_grad"],
        "hybrid_bf16_launches": hybrid_bf16["launches"]["cold_grad"],
        "down_sampling_parity_launches": ds_parity["hybrid"]["cold_grad"],
        "game_cli_launches": cli5["hybrid"]["cold_grad"],
        "max_abs_err": max(c["max_abs_err"] for c in cold_checks),
        "parity_rel": max(c["parity_rel"] for c in cold_checks),
        "column_ratio": max(c["column_ratio"] for c in cold_checks),
        "ms": main_cold["ms"], "plain_ms": main_cold["plain_ms"],
        "bound_ms": main_cold["bound_ms"], "bound_by": main_cold["bound_by"],
        "library_ms": main_cold["library_ms"],
        "library_device_ms": main_cold["library_device_ms"],
        "library_call": main_cold["library_call"],
        "call_ms": main_cold["call_ms"],
        "queued_ms": main_cold["queued_ms"],
        "gather_ms": main_cold["gather_ms"],
        "shape": (f"all {len(main_cold['classes'])} classes of a hybrid "
                  f"gradient pass in one launch, n={main_cold['n']} "
                  f"({hybrid_rows} hybrid_train rows), "
                  f"{main_cold['columns']} columns, "
                  f"{main_cold['slots']} slots"),
        "per_class": main_cold["per_class"],
        "checks": len(cold_checks)})
    # The script's seconds, and each line's since the one before it.
    emit("script", seconds=time.perf_counter() - _T0, line_seconds=[
        [p, round(at - before, 3)]
        for (p, at), (_, before) in zip(_LINES, [("", 0.0)] + _LINES)])
    # Every TPU kernel of the repo has its port (ROADMAP.md §B).
    to_port = []
    print(json.dumps({"kernels": table, "to_port": to_port}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
