#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hfrep_tpu_torch``) on one card.

    python3 chip_smoke.py [--out results.json]

Imports nothing of JAX or of the JAX package.  Phases, each of which
exits non-zero on failure:

1. build   — every ``hfrep_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
             one process per source, started together; prints ptxas's
             registers and spills per kernel (and fails if an lstm_fwd
             kernel, the lstm_bwd or lstm_adj register layout, a
             stack_fwd / stack_bwd / stack_adj cluster-layout
             instantiation or a weight sum spills, or if lstm_adj's
             pre-pass or post-pass did not build), the forward's, the
             backward's and the adjoint's launch rules at H=100 and at
             their wide widths, the stack forward's,
             backward's and adjoint's launch rules by B and how many of
             their two-block clusters can be resident at once, the
             dynamic shared memory each LSTM kernel (single-layer and
             fused stack) asks for at H=100, and the weight sums' tiles
             and cluster sizes at the epoch's shapes;
2. parity  — the forward kernel (primal mode) against its plain PyTorch
             version on the card, at the serving shapes (W, F) in
             {(48, 35), (168, 36)}, H=100, B in {8, 64}, activations
             sigmoid/tanh/linear, float32 and bf16 operand streams; bars:
             f32 atol 2e-5 (the dot sums in another order than
             torch.matmul), bf16 atol 1e-2 (an h that rounds differently to
             bf16 feeds the next step);
   layout  — the forward kernel's four modes (primal, with_cs, carry
             primal, carry with_cs) in its register layout at H=100,
             B=133 (two batch rows a block) and in its wide layout
             (H=120 f32, H=160 bf16; B 8 and 133), every activation,
             against the plain version at the bars below, each launched
             twice and bit-equal; then the backward kernel's modes
             (plain, dcs, with_carries, carry0, all three) in its register
             layout at H=100, B=133 and its wide layout (H=117 f32, H=160
             bf16; B 8 and 133), every activation, the same way; then the
             adjoint kernel's two modes (carry-free; carry from a nonzero
             carry, with mu0 and with a null mu0) in its register layout
             (pre-pass, sweep, post-pass) at H=100, B=133 and its wide
             layout at the same widths and batches, the same way;
   grad    — the forward kernel's with_cs mode, the backward kernel (plain,
             dcs and with_carries modes) and the adjoint kernel against
             their plain versions, at the epoch's shapes W in {48, 168},
             H=100, B in {32, 64}, every activation, float32 and bf16; the
             error is max|kernel - plain| / max(1, max|plain|) over every
             output; bars: f32 1e-4 (drec and urec are sums over up to
             W*B = 10,752 rows, taken in another order), bf16 1e-2 (as the
             forward);
   carry   — (a) the carry modes of the single-layer kernels (forward
             carry primal and carry with_cs; backward carry0 alone, with
             dcs and with the per-step carries, each with dc_fin; adjoint
             carry with mu0) against their plain versions from a nonzero
             (h0, c0), at the grad phase's shapes, activations, dtypes and
             bars; (b) the carry path at full width: the W=168, B=32
             window as four chunks of 42 passing (h, c) through
             ``lstm_seq_carry``, forward, first order and the gp_like
             second order against the whole window (``lstm_seq`` from a
             zero start, the plain carry forward from a nonzero one) at
             the JAX suite's bars, with the launch counts set to 0 just
             before the chunked runs and exactly the four carry modes
             launched;
   stack   — the fused two-layer stack's kernels: the forward (primal and
             with_res), the backward (plain, direct cotangents,
             with_carries) and the adjoint against their plain versions,
             at the same shapes, activations, dtypes and bars; then the
             forward's, the backward's and the adjoint's two layouts (the
             cluster layout at H=100 with three batch rows a cluster, the
             wide one at H=117 f32 / 160 bf16; the three sweeps must pick
             the same one), every mode, each launched twice and bit-equal;
   sums    — the weight sums alone (``weight_sum.cu``) at each launch
             shape of the main path (one pair, two pairs, three of each,
             the column sum) at R = W*B in {1536, 5376, 10752} against
             their plain version (scaled 1e-4), launched twice and
             bit-equal, and timed by the profiler beside the plain
             version, their bound and one PyTorch call computing the same
             function (``torch.matmul``/``bmm``/``sum``, TF32 off);
3. server  — the main path: ``ReplicationServer`` on ``cuda`` with an AE
             head at ``AEConfig()`` widths (Keras-default init, 22 factors)
             and the ``mtss_wgan_gp`` generator, then the
             ``mtss_wgan_gp_prod`` one: start, ``warm_server`` (the program
             grid plus one real batch per path), 64 requests through
             ``drive_load(..., sample_every=2)``, drain.  Launch counts
             are set to 0 just before each and read just after; every
             request must end in a result, every answer be finite and
             shaped, the kernel must have launched, and answers must agree
             with the same models run through the plain path on the CPU.
             Every bucket must come up as a loaded ``torch.export`` program
             (``ServeConfig()``'s ``via_export``, its LSTM layers the
             ``hfrep::lstm_fwd`` op); a second server over the same models
             with ``via_export=False`` warms, and each bucket's exported
             program equals its eager one bit for bit on the same
             operands; warm seconds with export on and off are printed;
4. timing  — CUDA events over many launches after warm-up, at the shapes
             the server gives the kernel, beside its bound (bytes over
             3.35 TB/s, operations over the card's peak for their type),
             the plain version and cuDNN's LSTM (``library_ms``: tanh,
             same weights, input projection included; timed here only,
             never called by the port);
5. train   — the training paths: for ``mtss_wgan_gp`` and
             ``mtss_wgan_gp_prod`` at full width (H=100), float32, batch
             32, n_critic 5, on a seeded uniform dataset of 1,000 windows,
             the critic on its default route (the fused stack, slice 3's
             main path): ``init_gan_state`` then ``make_multi_step`` for 3
             epochs, with every launch count set to 0 just before and read
             just after; the losses must be finite, exactly the route's
             kernels must have launched (``ROUTE_KERNELS``), and the weight
             sums, as their C launcher counts them, as often as those
             kernels launch them (``SUM_LAUNCHES``), 44 an epoch.  Then 3 more epochs timed (host clock
             around synchronised work), one epoch
             under ``torch.profiler``, and one epoch on the card against
             the same epoch — same state, same draws — through the plain
             path on the CPU: d_loss and g_loss rtol 1e-4, every param
             atol 1e-5 + rtol 1e-4 (the JAX package's bar for its
             kernel-vs-scan epoch).  The same for ``mtss_wgan_gp`` with
             the critic on the chained route (slice 2's path, which runs
             the single-layer adjoint);
5a. precision — the bf16 policy: (a) 3 counted bf16 epochs a route
             (fused ``mtss_wgan_gp`` and ``mtss_wgan_gp_prod``, chained
             ``mtss_wgan_gp``) launching exactly the float32 route's
             kernels an epoch and 44 weight sums, one profiled epoch whose
             recurrence kernels are all ``__nv_bfloat16`` instantiations,
             and one epoch against the CPU plain path from the same state
             and draws, its optimizer slots zeroed: losses rtol 5e-2 (the
             JAX package's bf16 bar), every param |card - CPU| <= 1e-2
             max(1, max|CPU|), the update p1 - p0 per param within 0.25
             in relative L2 and every optimizer slot within 0.2 max|CPU|
             (the gradients' size); (b)
             ``train-gan --dtype bfloat16`` at ``mtss_wgan_gp_prod`` for 5
             epochs with a checkpoint and samples: the float32 route's
             launches, a checkpoint whose floating leaves are all float32
             and finite, a run of 2 epochs resumed to 5 bit for bit the
             straight run, and the verb's trainer in this process: a
             finite history and the same state; (c) ``sweep --dtype
             bfloat16`` real only at ``AEConfig()``'s 21 latents, the
             epochs cut to 200: every file written and finite, no kernel
             launched; the engine's bf16 lane sweep on the card against
             the CPU from the same draws, over the epochs before any lane
             stops, losses within rtol 5e-2 atol 1e-4 (the JAX package's
             AE bf16 bar); its best OOS R² mean and stop epochs printed
             beside the float32 sweep phase's, not gated;
5b. trainer — the training loop (``GanTrainer``) on the committed panel
             (``results/rederived_cleaned`` through ``load_panel`` and
             ``build_gan_dataset``): ``mtss_wgan_gp`` at (48, 35) for 12
             epochs at 5 a block (two blocks, checkpoints after 5 and 10,
             two remainder epochs) on the fused route, with the launch
             counts set to 0 just before and read just after: the history
             covers epochs 0-11 with finite losses, and the epochs launched
             exactly the train phase's per-epoch counts, 44 weight sums an
             epoch; its ``steps_per_sec`` beside the train phase's
             ms/epoch, and the same loop's with no checkpoint to write
             (15 epochs); a checkpoint saved and restored (timed); a fresh
             trainer restored from ``ckpt_5`` and trained on to 12 is bit
             for bit the straight run (every param and slot, the history
             from epoch 5, the draw stream); the newest checkpoint
             truncated, ``restore_checkpoint()`` falls back to ``ckpt_5``;
             ``generate_block(3, 64)`` twice is bit-equal and finite.  Then
             the ``train-gan`` verb in this process at
             ``mtss_wgan_gp_prod`` (168, 36) for 5 epochs with a checkpoint
             and samples, and ``serve --gan-checkpoint`` on that checkpoint
             with 32 requests, every other one a sample: each must end in a
             result;
5c. sweep  — the replication engine on the committed panel: (a) the
             chunked sweep of 21 latent lanes, 40 epochs at 10 a chunk, on
             the card and on the CPU from the same init and permutations
             (drawn on the CPU): losses rtol 1e-4, params atol 1e-5 + rtol
             1e-4, stop epochs equal; then ``sweep_evaluate`` of those
             params on both: fit metrics |card - CPU| <= 1e-6 + 1e-4
             |CPU| (allclose's rtol 1e-4, atol 1e-6), the
             pseudo-inverse's outputs (ante, post, turnover, Sharpe) 1e-3
             scaled by max(1, max|CPU|); the device's busy share of a
             profiled 10-epoch drive at the real (168) and the augmented
             (1,848) rows.  (b) ``python -m hfrep_tpu_torch sweep`` as
             three subprocesses started together once the second
             checkpoint is trained, each counting its kernel
             launches into its own stream, at ``AEConfig()`` (1000-epoch
             cap, early stopping),
             latents 1:21, ``--stats``: real only; from the trainer phase's
             ``mtss_wgan_gp_prod`` checkpoint (the dense augmented path);
             from it and a second ``train-gan`` checkpoint (the padded
             multi path).  Each run: every file written and every number
             finite, epochs dispatched >= the largest stop epoch, overshoot
             <= 1, ``lstm_fwd`` launched exactly twice a checkpoint and no
             other kernel; the real-only best OOS R² mean within the JAX
             package's 24-seed envelopes on this panel (its TPU run and
             its CPU run, each) widened by 0.05 a
             side; wall seconds, epochs and chunks dispatched recorded;
5d. eval   — the metrics: ``train-gan --eval`` at ``mtss_wgan_gp`` for 2
             epochs with a checkpoint and 500 samples (launches: the train
             phase's per-epoch counts twice, and 2 lstm_fwd for the samples
             and 2 for the eval's 500, exactly), then ``eval-gan`` on those
             samples: exit 0 and 12 finite metrics in ``--out``; then
             ``GanEval`` on the card and on the CPU over the same cubes — the
             first 500 real windows of the committed panel at both presets
             against 500 fakes of that checkpoint (W=48) and of the trainer
             phase's ``train-gan`` checkpoint (W=168) — held at the CPU
             tests' bars (``metric_check``: FID 1e-5 scaled by max(1, tr S1 +
             tr S2), the MMDs 1e-5 scaled by their kernel means,
             R2_relative_error 1e-3 scaled, kl/js rtol 1e-5 and the
             Inception score through its log, the rest rtol 1e-6); the
             fakes launch 2 lstm_fwd each and GanEval no kernel;
5e. scenario — the scenario factory on the committed panel: (a) the
             conditional mtss_wgan_gp epoch (W=24, 22 factors + 3 regimes,
             n_critic 1, B=32) for 3 counted epochs on each critic route,
             its launches exactly ``COND_ROUTE_LAUNCHES`` an epoch and 12
             weight sums, then one epoch against the CPU plain path on the
             same draws (d_loss, g_loss rtol 1e-4; params atol 1e-5 + rtol
             1e-4); (b) ``scenario bank --family mtss_wgan_gp
             --train-epochs 30`` twice into fresh dirs: 12 blocks written,
             the fused route's counts for 30 epochs and 2 lstm_fwd a block,
             every block digest of the second run the first's; (c)
             ``scenario walkforward`` on the panel and ``scenario
             universe`` at its defaults (64 funds, 360 months, 22 factors;
             both 24 windows x latents 1:8, 1000-epoch cap): every file
             written, every number finite, no kernel launched; the
             walk-forward grid (6 windows x 8 latents x 20 epochs) on the
             card against the CPU from the same draws at the sweep phase's
             bars;
5f. pipeline — the actor fabric through ``python -m hfrep_tpu_torch
             pipeline --device cuda``, every run's AE cut to 100 epochs
             (``PIPE_EPOCHS``; ``AEConfig()``'s cap is 1000), (a), (b)'s
             first run and (c) side by side, (b)'s resume as soon as its
             first run has exited and (c)'s item computed here meanwhile:
             (a) one
             generator actor sampling the trainer phase's W=168
             ``train-gan`` checkpoint (2 blocks of 10 windows) into 2
             consumer actors running the augmented 21-latent sweep at
             ``AEConfig()`` widths: exit 0, ``pipeline.json``
             assembled, the generator's own stream showing exactly 4
             ``lstm_fwd`` launches (2 a block) and no other kernel, the
             consumers' none; (b) the same plan under
             ``HFREP_FAULTS=sigterm@item=1`` exits 75 and ``--resume`` gives
             a ``pipeline.json`` byte-equal to (a)'s; (c) 2 fixture sources
             (22 factors, 168 rows, 2 blocks, 2 consumers, items taking 1 s)
             under ``HFREP_FAULTS=kill@actor=1``: exit 0, at least one
             restart, and one item's ``sweep.npz`` equal bit for bit to
             ``sweep_item_arrays`` on the same panel and seed in this
             process; each run's wall seconds, restarts and queue depth
             over time (the parent's stream) printed;
5g. health — the in-step health block (``HFREP_HEALTH``): ``GanTrainer``
             at ``mtss_wgan_gp`` on the committed panel, 15 epochs at 5 a
             block on the fused route and 5 on the chained route, each
             with health off and then on from the same draws under an obs
             session, launch counts set to 0 just before each run and read
             just after: both runs bit-equal (every param and slot, the
             history), each launching exactly the train phase's per-epoch
             counts and 44 weight sums an epoch, the five health values
             finite, the ``mfu`` gauge finite; health's cost as the median
             of 24 pairs of steady blocks, off and on back to back; a NaN
             planted in one generator parameter under the armed tripwire
             raises ``NumericFault`` with a forensic dump; the
             chunked AE drive (21 lanes, 40 epochs at 10 a chunk) bit-equal
             with health off and on, its ``health/ae_*`` gauges written;
             ``train-gan --profile-dir`` for 2 epochs: one trace, linked
             in ``run.json``, holding the hand kernels' device events;
5h. serve_drain — ``python -m hfrep_tpu_torch serve --device cuda`` from the
             trainer phase's W=168 checkpoint, every other query a sample,
             waves of 32: undisturbed (256 queries) it exits 0 with the
             same set of traces admitted and completed in its stream, one
             a request, the serve events, one ``serve_load`` ledger window and
             ``lstm_fwd`` launched in its own stream, its stderr's
             ``export=on`` and every program a loaded export; sent SIGTERM
             after its "offering" line (4,000 queries) it exits 75 and its
             drained document has ``terminal == submitted``;
5i. obs_tier — the obs analysis tier (``python -m hfrep_tpu_torch.obs``,
             its verbs run in this process) over the run dirs the phases
             above wrote: ``report``, ``gate``, ``timeline`` and ``slo
             --self-test`` exit 0; ``report --format json`` of the trainer
             phase's ``train-gan`` run reads backend ``cuda``, a finite
             ``steps_per_sec`` and ``mfu`` and the launch counters the
             phase counted; a 12-epoch ``train-gan`` at ``mtss_wgan_gp``
             under ``HFREP_OBS_ROTATE_BYTES`` rotates its live stream
             into at least 2 ``rollup/chunk-*.jsonl`` while the kernels
             run (its stream's launch counters: the fused route's
             kernels, a whole number a epoch, 44 weight sums an epoch),
             every chunk parsing whole, and after ``compact`` its
             report (but ``run_dir``) and ledger are unchanged; three such
             runs ingested into a fresh history share one key with backend
             ``cuda``, and ``gate --min-runs 3`` of a fourth gives a
             well-formed verdict on ``steps_per_sec`` (baseline median,
             MAD), the same on a second gate (pass or fail is recorded,
             not required); ``report --trace`` renders admit, dispatch and
             complete for a trace of ``serve_drain``'s undisturbed run and
             every admitted trace has a terminal event; ``export`` gives
             the ``serve/*`` gauges as Prometheus text, ``tail --once``
             one frame, ``slo`` over both serve runs as replicas a
             well-formed result;
5j. forensics — the analysis tier's second part on the card's runs:
             ``obs profile`` digests the ``health`` phase's ``train-gan
             --profile-dir`` trace (every hand kernel that run launched
             with device busy time > 0, the union of device busy time
             within the traced wall); that run's ``run.json`` ``programs``
             name every kernel library it had loaded, each digest the
             sha256 of its ``.so``; two 12-epoch ``train-gan`` runs carry
             finite ``attrib/*`` gauges and the ledger's ``unattributed``
             share of their steady windows is recorded; ``explain`` of the
             two gives no ``program`` finding, and of a copy of one with
             one library digest changed, a finding naming that kernel;
             ``crash-drill --device cuda`` exits 0; the ``ae_sweep`` chaos
             subject drained on the card (``preempt@chunk=1``) exits 75
             with a crash bundle that ``verify_bundle`` and the checkpoint
             checksum accept and ``report --crash`` renders (those two
             subprocesses run beside the rest of the phase);
5k. chaos  — ``python -m hfrep_tpu_torch.resilience`` on the card,
             at once: ``drives --check`` exits 0 with every spec
             registered; ``selftest --device cuda`` exits 0 with the
             JAX selftest's keys; the corpus (each entry a ``chaos
             --replay`` process, four at a time, the slowest subject's
             first; all nine entries,
             ``006`` the ``ae_mesh`` subject, none skipped) and a seeded soak
             over the fast subjects (2 schedules) end with no violation;
             the ``_planted`` canary is found and shrunk to
             ``io_fail@result_save=1``; the
             ``gan_ckpt`` subject's own stream carries the fused route's
             kernel launches;
5l. mesh   — data parallelism on the one card (``hfrep_tpu_torch.parallel``):
             the four training kernels (lstm_bwd, lstm_adj, stack_bwd,
             stack_adj) at a rank's B=16 against their plain versions at
             the grad bars; (a) the train phase's mtss_wgan_gp block (3
             epochs, fused, B=32) on a one-device mesh bit-equal to the
             meshless block from the same state and draws (params,
             metrics), the fused route's launches an epoch, no collective;
             (b) the same block as two processes (gloo, CUDA tensors,
             cuda:0 each, 16 rows a rank): each rank within 1e-5 of the
             single-device block, the ranks bit-equal, each rank's own
             launches the fused route's; (c) ``train-gan --coordinator``
             as two ranks on the committed panel (5 epochs): exit 0,
             rank 0 alone writes checkpoints and prints, the generator
             within 1e-5 of one process's, ``--resume`` from ``ckpt_2``
             bit-equal to the straight run, SIGTERM to rank 1 drains
             both into exit 75 with a checkpoint; (d) the padded (20
             lanes) and multi (2 datasets) lane drives, 40 epochs, on a
             lane mesh bit-equal to the meshless drives at dp=1 and as
             two processes at dp=2; (e) ``MultiSeedTrainer`` (K=2) in turn
             and on a two-rank seed mesh, each member bit-equal to its
             standalone ``GanTrainer``; ms per epoch meshless, dp=1 and
             dp=2 and the reduction's ms per epoch (CUDA events around
             each all_reduce) printed (each block
             timed with nothing else on the card); the window and layer
             axes in the same two rank processes (ROADMAP queue 1 item
             9b), each one epoch at full width from the block's state and
             first draws against the single-device epoch: (f) pp=2 (two
             stages, 2 microbatches; rtol 1e-4, atol 1e-5; forwards 2e-5),
             each rank launching exactly the chained single-layer kernels
             its stage runs and no stack kernel; (g) sp=2 (the window in
             two chunks, carries handed on; atol 1e-4; forwards 2e-5),
             each rank launching exactly the carry-mode kernels; the
             ranks within rtol 1e-6; ``train-gan --dp-sp 1x2
             --coordinator`` (3 epochs) exits 0 with rank 0 alone writing
             and printing, and ``--resume`` from ``ckpt_1`` is bit-equal
             to the straight run; the hidden-unit axis (item 9c): (h)
             tp=2 in the same rank processes (each rank its units' gate
             columns, h gathered each step; atol 1e-4; forwards 2e-5),
             no hand kernel and no weight sum launched, each rank's
             all_reduces exactly ``tp_reduces``, the ranks bit-equal;
             (i) ``train-gan --dp-tp 1x2 --coordinator`` (2 epochs) as
             ``--dp-sp``'s, resumed from ``ckpt_1``, run beside the
             analysis phase (``DpTpVerb``; its wall is ``mesh_dp_tp``);
             (j), dp×sp×tp 1×2×2 as four rank processes, is
             ``phase_tile``, which ``tools/torch_mesh_phase.py`` runs,
             not this script; the configurations PR 26 lifted (items
             9d–9f), in the same rank processes: (h)'s tp=2 epoch with
             health on (its five values against the single-device
             health-on epoch's, still ``tp_reduces`` all_reduces) and
             then a bf16 tp=2 epoch at the bf16 bars; (g) one sp=2 epoch
             of each other family at sp's bars with its derived launches
             and one bf16 sp=2 epoch (``__nv_bfloat16`` kernels only);
             (d) the dp=2 padded drive with health on, its gauges the
             meshless health-on drive's; (i)'s straight run under
             ``HFREP_HEALTH=abort``, rank 0 alone setting the gauges; then
             the rank processes' (d) and (e), the verb runs and this
             process's checks side by side (the drained run signalled
             once (d) is done, each resume started as soon as the run it
             resumes has ended); a rank that fails or overruns is
             reported with the part it was in, by name, and every rank's
             stderr;
5m. analysis — the port's static analyzer and its shape contracts
             (``hfrep_tpu_torch.analysis``, ROADMAP queue 1 items 10a and
             10b): ``rules`` lists exactly the carried ids; the gate
             ``python -m hfrep_tpu_torch.analysis check hfrep_tpu_torch
             tools/torch_*.py tests/test_torch_*.py --no-cache`` and the
             program audit ``audit --device cuda --no-cache --format
             sarif`` run side by side in two subprocesses, each to exit 0
             with no finding and none baselined, the audit tracing every
             registry row with no skip note (its serve rows exported on
             the card, its other rows traced on the host; walls
             recorded); meanwhile ``serve:sample`` at full width, each
             preset at the server's first bucket, built on the card by
             the audit's factory: mode export, exactly two
             ``hfrep.lstm_fwd`` nodes and two forward-kernel launches a
             call, bit-equal to the eager server path and within
             ``torch.allclose`` at atol 1e-5 of the plain version; the
             seeded defects built on the card, exactly one JPX002 and
             one JPX004; then each function that carries a contract, on
             card tensors at full width: ``sample_windows`` on the
             committed panel at both presets, ``rolling_ols_beta``,
             ``_window_stack``,
             ``expanding_minmax_scale`` and ``ols_beta`` at the sweep's
             shapes with 21 lanes, ``sqrtm_product_trace`` on the eval
             phase's GanEval covariances (both presets), ``mfu_series``:
             the output with contracts on bit-equal to the output with
             ``HFREP_CONTRACTS=0``, a wrong rank (and, with two inputs, a
             mismatched T or F) raising ``ContractError``, and the
             check's median cost a call (on minus off, µs) recorded;
6. timing  — CUDA events for each kernel at the served shapes, beside its
             bound, its plain version and ``library_ms`` (the backward and
             the adjoint also by the profiler's device time of every kernel
             of a call, the adjoint's split into its pre-pass, sweep,
             post-pass and weight sum; cuDNN's LSTM at
             tanh: the forward in training mode for with_cs, backward =
             forward-and-backward minus forward for lstm_bwd; none for the
             adjoint: no PyTorch call computes it, the cuDNN RNN has no
             double backward); each carry mode at W=48, B=32 beside its
             carry-free mode, its bound, its plain version and cuDNN's
             LSTM called with hx=(h0, c0) (the adjoint's carry mode also
             by device time, split into its passes); each stack kernel
             also beside
             the chained single-layer pair it replaces, its library the
             two-layer cuDNN LSTM, with the profiler's device time of the
             kernel, the pair and cuDNN;
7. profile — ``torch.profiler`` over 20 sample dispatches per preset,
             through the loaded export program a server runs and then
             the export-off server's eager one: device time by kernel
             name and the device's busy share.

Before ``[done]`` a ``[walls]`` line gives every phase's wall seconds.
The last lines are the card's name and power limit, one JSON object
listing each ported kernel (and each weight-sum launch shape), and
``{"ok": true, "device": {...}}``.
TF32 is off for matmuls and cuDNN, so every float32 product is full
float32.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
SHAPES = ((48, 35), (168, 36))                  # (W, F): headline, production
HIDDEN = 100
BARS = {"float32": 2e-5, "bfloat16": 1e-2}
GRAD_BARS = {"float32": 1e-4, "bfloat16": 1e-2}   # scaled by max(1, max|plain|)
ACTS = ("sigmoid", "tanh", "linear")
TPU_KERNEL = "hfrep_tpu/ops/pallas_lstm.py:168"
TPU_KERNELS = {"lstm_fwd": TPU_KERNEL, "lstm_fwd_cs": TPU_KERNEL,
               "lstm_bwd": "hfrep_tpu/ops/pallas_lstm.py:263",
               "lstm_adj": "hfrep_tpu/ops/pallas_lstm.py:415",
               "lstm_fwd_carry": TPU_KERNEL,
               "lstm_bwd_carry": "hfrep_tpu/ops/pallas_lstm.py:263",
               "lstm_adj_carry": "hfrep_tpu/ops/pallas_lstm.py:415",
               "stack_fwd": "hfrep_tpu/ops/pallas_lstm_stack.py:71",
               "stack_bwd": "hfrep_tpu/ops/pallas_lstm_stack.py:134",
               "stack_adj": "hfrep_tpu/ops/pallas_lstm_stack.py:250"}
SOURCES = {"lstm_fwd": "lstm_fwd.cu", "lstm_fwd_cs": "lstm_fwd.cu",
           "lstm_bwd": "lstm_bwd.cu", "lstm_adj": "lstm_adj.cu",
           "lstm_fwd_carry": "lstm_fwd.cu", "lstm_bwd_carry": "lstm_bwd.cu",
           "lstm_adj_carry": "lstm_adj.cu",
           "stack_fwd": "lstm_stack_fwd.cu", "stack_bwd": "lstm_stack_bwd.cu",
           "stack_adj": "lstm_stack_adj.cu"}
TRAIN_PRESETS = ("mtss_wgan_gp", "mtss_wgan_gp_prod")
#: batches whose forward layout the build phase prints; 133 is two rows a block
FWD_BATCHES = (8, 16, 32, 64, 133)
#: (H, dtype) of the forward's wide layout: widths the register file cannot hold
WIDE_CASES = ((120, "float32"), (160, "bfloat16"))
#: (H, dtype) of the stack forward's wide layout: widths past the cluster
#: layout's 100, within stack_fits
STACK_WIDE_CASES = ((117, "float32"), (160, "bfloat16"))
#: the weight sums' launch shapes on the main path: (name, sums a launch,
#: pairs, M) — lstm_bwd's drec, lstm_adj's urec, stack_bwd's three products,
#: stack_adj's three, and the bias sums (db2, ub2) — and their rows R = W*B
#: at the epoch's shapes (W=48 B=32, W=168 B=32, W=168 B=64)
SUM_SHAPES = (("1 pair", 1, 1, HIDDEN), ("2 pairs", 1, 2, HIDDEN),
              ("3 x 1 pair", 3, 1, HIDDEN), ("3 x 2 pairs", 3, 2, HIDDEN),
              ("column", 1, 1, 1))
SUM_ROWS = (1536, 5376, 10752)
#: where each TPU kernel forms the sums of that shape in its own body
SUM_REPLACES = {"1 pair": "hfrep_tpu/ops/pallas_lstm.py:336",
                "2 pairs": "hfrep_tpu/ops/pallas_lstm.py:520",
                "3 x 1 pair": "hfrep_tpu/ops/pallas_lstm_stack.py:176",
                "3 x 2 pairs": "hfrep_tpu/ops/pallas_lstm_stack.py:357",
                "column": "hfrep_tpu/ops/pallas_lstm_stack.py:178"}
#: the kernels whose one launch makes one weight-sum launch of each shape
#: (the C launcher counts the sums, cuda_lstm.weight_sum_launches; the
#: wrappers count the kernels), and the weight-sum launches of an epoch on
#: either critic route: 2 + 16 + 5 + 21 fused, 34 + 10 chained
SUM_LAUNCHES_PER_EPOCH = 44
SUM_LAUNCHES = {"1 pair": ("lstm_bwd", "lstm_bwd_carry"), "2 pairs": ("lstm_adj", "lstm_adj_carry"),
                "3 x 1 pair": ("stack_bwd",), "3 x 2 pairs": ("stack_adj",),
                "column": ("stack_bwd", "stack_adj")}
TRAIN_EPOCHS = 3
TRAIN_BATCHES = (32, 64)        # penalty and generator passes; critic scores (2B)
#: the grad and stack timing phases time B=32 only (cut from TRAIN_BATCHES:
#: the kernels line reads W=48 B=32; B=64's times are PERF.md's, PRs 1-11)
TIMING_BATCHES = (32,)
MESH_BATCH = 16                 # a rank's rows at dp=2: its penalty and generator passes
#: the kernels each critic route's epoch must launch, and no others: the
#: generator's single-layer kernels, then the critic's fused stack
#: ("auto", slice 3) or its two chained single-layer LSTMs (slice 2)
ROUTE_KERNELS = {
    "auto": {"lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "stack_fwd_res", "stack_bwd",
             "stack_adj"},
    "chained": {"lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "lstm_adj"},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str = "") -> None:
    print(msg, flush=True)


def card_line(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def traced(torch, warm, run):
    """``torch.profiler`` (host and device) over ``run()`` alone: ``warm()``
    runs first in the profiler's warm-up step, which starts the tracer and
    drops its events.  Without it, in this program's long process, the
    first kernels of a window went unrecorded (a call's first one or two
    kernels, or the first calls of a one-kernel call)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    return prof


def device_events(prof) -> list:
    """``(name, count, device us)`` of each kernel in a profile, from the
    device's own events only: a CPU-side op (``aten::mul``, an autograd
    node) also reports the device time of the kernels it launched, and
    summing both counts them twice; the profiler's step markers
    (``ProfilerStep#``, listed as device events under a schedule) are left
    out."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or ev.key.startswith("ProfilerStep")):
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        out.append((ev.key, ev.count, t))
    return out


def device_ms(torch, fn, iters: int, match="lstm_fwd", tries: int = 5) -> float:
    """Device time, in ms, of one call of ``fn``: the profiler's device
    events, over ``iters`` calls (:func:`traced`), of the kernels whose name
    holds ``match`` (a string, or a tuple of strings of which one must
    match; "" every kernel), summed and divided by ``iters``.  A window the
    profiler did not record whole — no such event, or a kernel seen a
    number of times that is not a multiple of ``iters`` — is profiled
    again, up to ``tries`` windows in all; after that the result is nan,
    and the last window's counts that were not whole are printed.  A
    kernel shorter than its wrapper's host time leaves the card idle
    between back-to-back launches, and ``time_ms`` then measures the host."""
    names = (match,) if isinstance(match, str) else tuple(match)

    def run():
        for _ in range(iters):
            fn()

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        us, torn = 0.0, []
        for key, count, t in device_events(traced(torch, fn, run)):
            if not any(n in key for n in names):
                continue
            us += t
            if count % iters:
                torn.append(f"{key[:48]} x{count}")
        if us and not torn:
            return us / iters / 1e3
    say(f"[profiler] no whole window of {iters} calls in {tries} (match {match!r}): "
        + ("; ".join(torn) or "no event"))
    return float("nan")


# ------------------------------------------------------------------ phases
#: the bool template flags of each kernel, in order
KERNEL_FLAGS = {"lstm_fwd": ("with_cs", "carry"), "lstm_bwd": ("carry",),
                "lstm_adj": ("carry",), "stack_fwd": ("with_res",),
                "stack_bwd": ("directs", "carries"), "stack_gates": ("adjoint",)}


def entry_name(mangled: str) -> str:
    """A readable name for a kernel's mangled entry: base<dtype,act,modes>."""
    m = re.search(r"(((?:lstm|stack)_(?:fwd|bwd|adj|gates))(?:_wide|_cluster|_post)?_kernel)"
                  r"I(f|13__nv_bfloat16)"
                  r"(?:Li(\d)E)?((?:Lb\dE)*)", mangled)
    if m:
        flags = re.findall(r"Lb(\d)E", m.group(5))
        mode = "" if m.group(4) is None else f",act={m.group(4)}"
        for k, (name, on) in enumerate(zip(KERNEL_FLAGS.get(m.group(2), ()), flags)):
            if on == "1":
                mode += f",{name}"
            elif k == 0 and m.group(2).endswith("fwd"):
                mode += ",primal"
        return f"{m.group(1)}<{'f32' if m.group(3) == 'f' else 'bf16'}{mode}>"
    m = re.search(r"weight_sum_kernelILi(\d)E", mangled)
    if m:
        return f"weight_sum<{'float4' if m.group(1) == '4' else 'scalar'}>"
    m = re.search(r"col_sum_kernelILi(\d)E", mangled)
    if m:
        return f"col_sum<{'float4' if m.group(1) == '4' else 'scalar'}>"
    return mangled


def no_spill(source: str, entry: str) -> bool:
    """The instantiations the build phase holds to no spills: every
    lstm_fwd kernel, the register layouts of lstm_bwd and lstm_adj, the
    stack sweeps' cluster layouts and the weight sums."""
    return (source == "lstm_fwd" or "_cluster_" in entry
            or entry.startswith(("lstm_bwd_kernel<", "lstm_adj_kernel<", "weight_sum<",
                                 "col_sum<")))


def phase_build(torch, _build, cuda_lstm, cuda_lstm_stack) -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(sorted(logs))}")
    spilled, entries = [], {}
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = entry_name(m.group(1))
                entries.setdefault(name, []).append(entry)
            elif "registers" in line or "spill" in line:
                say(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if (no_spill(name, entry or "") and m
                        and (int(m.group(1)) or int(m.group(2)))):
                    spilled.append(entry)
    if spilled:
        fail(f"a register-layout kernel or a weight sum spills registers in {spilled}")
    # the adjoint's register layout: its pre-pass (the gates kernel with the
    # v-stream products), its sweep and its post-pass, in both types
    adj_entries = entries.get("lstm_adj", [])
    for kind in ("stack_gates_kernel<f32", "stack_gates_kernel<bf16", "lstm_adj_kernel<f32",
                 "lstm_adj_kernel<bf16", "lstm_adj_post_kernel<f32", "lstm_adj_post_kernel<bf16"):
        if not any(e.startswith(kind) and ("gates" not in kind or "adjoint" in e)
                   for e in adj_entries):
            fail(f"lstm_adj.cu built no {kind}...> kernel: {adj_entries}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        plans = {b: cuda_lstm.fwd_layout(HIDDEN, dt, b, sms, limit) for b in FWD_BATCHES}
        say(f"[build] lstm_fwd layout at H={HIDDEN} {n} (layout, threads, rows a block) by B: "
            + ", ".join(f"B={b} {p}" for b, p in plans.items())
            + f"; {cuda_lstm.smem_bytes(HIDDEN, dt)} B of shared memory (KS={cuda_lstm.FWD_KS}, "
            f"{cuda_lstm.FWD_KEEP} rows in registers); no spills")
    for h, name in WIDE_CASES:
        dt = getattr(torch, name)
        say(f"[build] lstm_fwd layout at H={h} {name}, B=133: "
            f"{cuda_lstm.fwd_layout(h, dt, 133, sms, limit)}, "
            f"{cuda_lstm.smem_bytes(h, dt, -(-133 // sms))} B of shared memory")
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        plans = {b: cuda_lstm.bwd_layout(HIDDEN, dt, b, sms, limit) for b in FWD_BATCHES}
        say(f"[build] lstm_bwd layout at H={HIDDEN} {n} (layout, threads, rows a block) by B: "
            + ", ".join(f"B={b} {p}" for b, p in plans.items())
            + f"; {cuda_lstm.reg_bwd_smem_bytes(HIDDEN, dt)} B of shared memory "
            f"({cuda_lstm.BWD_KEEP[dt]} of {cuda_lstm.FWD_KS} chunks in registers); no spills")
    for h, name in STACK_WIDE_CASES:
        say(f"[build] lstm_bwd layout at H={h} {name}, B=133: "
            f"{cuda_lstm.bwd_layout(h, getattr(torch, name), 133, sms, limit)}")
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        plans = {b: cuda_lstm.adj_layout(HIDDEN, dt, b, sms, limit) for b in FWD_BATCHES}
        say(f"[build] lstm_adj layout at H={HIDDEN} {n} (layout, threads, rows a block) by B: "
            + ", ".join(f"B={b} {p}" for b, p in plans.items())
            + f"; {cuda_lstm.reg_adj_smem_bytes(HIDDEN, dt)} B of shared memory "
            f"({cuda_lstm.ADJ_KEEP[dt]} of {cuda_lstm.FWD_KS} rows in registers); no spills")
    for h, name in STACK_WIDE_CASES:
        say(f"[build] lstm_adj layout at H={h} {name}, B=133: "
            f"{cuda_lstm.adj_layout(h, getattr(torch, name), 133, sms, limit)}")
    for kernel in ("lstm_bwd", "lstm_adj"):
        sm = {n: cuda_lstm.smem_bytes(HIDDEN, dt, 1, kernel)
              for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        say(f"[build] {kernel} (wide layout): dynamic "
            f"shared memory at H={HIDDEN}, one row a block: "
            f"{sm['f32']} B f32, {sm['bf16']} B bf16 (+{cuda_lstm.smem_bytes(HIDDEN, torch.float32, 2, kernel) - sm['f32']} B a further row)")
    for shape, nsum, npair, m in SUM_SHAPES:
        plans = {r: cuda_lstm.sum_plan(nsum, npair, r, m, 4 * HIDDEN, sms) for r in SUM_ROWS}
        say(f"[build] weight sums {shape} (tiles, pieces, blocks a tile) by R = W*B: "
            + ", ".join(f"R={r} {p}" for r, p in plans.items()))
    cls = cuda_lstm_stack
    for kernel, rule, cluster_bytes in (("stack_fwd", cls.stack_fwd_layout, cls.cluster_smem_bytes),
                                        ("stack_bwd", cls.stack_bwd_layout,
                                         cls.cluster_bwd_smem_bytes),
                                        ("stack_adj", cls.stack_adj_layout,
                                         cls.cluster_adj_smem_bytes)):
        resident = getattr(cls._lib(f"lstm_{kernel}"), f"hfrep_{kernel}_clusters")
        for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            plans = {b: rule(HIDDEN, dt, b, sms, limit) for b in FWD_BATCHES}
            clusters = resident(HIDDEN, int(n == "bf16"), 0)
            if clusters < 1:
                fail(f"{kernel} cluster layout: no cluster can be resident ({clusters})")
            say(f"[build] {kernel} layout at H={HIDDEN} {n} (layout, threads, rows a cluster) "
                "by B: " + ", ".join(f"B={b} {p}" for b, p in plans.items())
                + f"; {cluster_bytes(HIDDEN, dt)} B of shared memory a block; {clusters} "
                f"clusters of 2 resident at once (cudaOccupancyMaxActiveClusters); no spills")
        for h, name in STACK_WIDE_CASES:
            say(f"[build] {kernel} layout at H={h} {name}, B=133: "
                f"{rule(h, getattr(torch, name), 133, sms, limit)}")
    rows = [cuda_lstm_stack.stack_rows(b, HIDDEN, torch.float32, sms, limit)
            for b in (MESH_BATCH,) + TRAIN_BATCHES]
    for kernel in ("stack_fwd", "stack_bwd", "stack_adj"):
        sm = {n: cuda_lstm_stack.stack_smem_bytes(HIDDEN, dt, 1, kernel)
              for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        extra = cuda_lstm_stack.stack_smem_bytes(HIDDEN, torch.float32, 2, kernel) - sm["f32"]
        say(f"[build] {kernel} (wide layout): dynamic shared memory at H={HIDDEN}, one row a block: "
            f"{sm['f32']} B f32, {sm['bf16']} B bf16 (+{extra} B a further row); "
            f"{limit} B allowed; rows a block at B={(MESH_BATCH,) + TRAIN_BATCHES}: {rows}")


def lstm_inputs(torch, w, f, b, act, dtype, seed):
    """xz and rec as the server makes them: a Keras-initialised layer's
    projection of standard-normal noise."""
    from hfrep_tpu_torch.ops.lstm import KerasLSTM

    g = torch.Generator()
    g.manual_seed(seed)
    layer = KerasLSTM(f, HIDDEN, activation=act, device="cuda", generator=g)
    x = torch.randn((b, w, f), generator=g).cuda()
    with torch.no_grad():
        xz = (x.reshape(b * w, f) @ layer.kernel + layer.bias).reshape(b, w, 4 * HIDDEN)
        xz = xz.transpose(0, 1).contiguous().to(dtype)
        rec = layer.recurrent_kernel.detach().to(dtype).contiguous()
    return layer, x, xz, rec


def phase_parity(torch, cuda_lstm) -> dict:
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for w, f in SHAPES:
        for b in (8, 64):
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype,
                                                seed=w + b)
                    with torch.no_grad():
                        hs = cuda_lstm.lstm_fwd_cuda(xz, rec, act)
                        ref = cuda_lstm.lstm_seq_plain(xz, rec, act)
                    torch.cuda.synchronize()
                    if hs.shape != ref.shape or not torch.isfinite(hs).all():
                        fail(f"kernel output not finite/shaped at W={w} B={b} {act} {name}")
                    err = float((hs - ref).abs().max())
                    worst[name] = max(worst[name], err)
                    say(f"[parity] lstm_fwd W={w:3d} B={b:2d} {act:7s} {name:8s} "
                        f"max|kernel-plain| = {err:.3e} (limit {BARS[name]:.0e})")
                    if not err <= BARS[name]:
                        fail(f"kernel disagrees with its plain version: {err} > "
                             f"{BARS[name]} at W={w} B={b} {act} {name}")
    return worst


#: the forward's four modes: (name, with_cs, carried)
FWD_MODES = (("lstm_fwd", False, False), ("lstm_fwd_cs", True, False),
             ("lstm_fwd_carry", False, True), ("lstm_fwd_cs_carry", True, True))


def phase_fwd_layouts(torch, cuda_lstm) -> dict:
    """The forward kernel's four modes in both layouts against the plain
    version: the register layout at H=100 with B=133 (two batch rows a
    block), the wide layout at ``WIDE_CASES`` with B in {8, 133}; W=48,
    every activation, seeded inputs (xz 0.5 N(0,1), rec N(0,1)/sqrt(H),
    carry 0.5 N(0,1)).  Bars: the primal abs f32 2e-5 / bf16 1e-2, the
    other modes scaled by max(1, max|plain|), f32 1e-4 / bf16 1e-2.  Each
    mode launched twice must give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    cases = [(HIDDEN, "float32", 133), (HIDDEN, "bfloat16", 133)]
    cases += [(h, name, b) for h, name in WIDE_CASES for b in (8, 133)]
    worst = {}
    for h, name, b in cases:
        dtype = getattr(torch, name)
        layout = cuda_lstm.fwd_layout(h, dtype, b, sms, limit)[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(h + b)
        xz = (0.5 * torch.randn((48, b, 4 * h), generator=g, device="cuda")).to(dtype)
        rec = (torch.randn((h, 4 * h), generator=g, device="cuda") / h ** 0.5).to(dtype)
        carry = tuple(0.5 * torch.randn((b, h), generator=g, device="cuda") for _ in range(2))
        line = []
        for act in ACTS:
            for mode, with_cs, carried in FWD_MODES:
                c = carry if carried else None
                with torch.no_grad():
                    got = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs, c)
                    again = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs, c)
                    ref = cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs, c)
                torch.cuda.synchronize()
                got, again, ref = ((x,) if torch.is_tensor(x) else x for x in (got, again, ref))
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"{mode} ({layout}) not finite/shaped at H={h} B={b} {act} {name}")
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"{mode} ({layout}): two launches differ at H={h} B={b} {act} {name}")
                if mode == "lstm_fwd":
                    err, bar = float((got[0] - ref[0]).abs().max()), BARS[name]
                else:
                    err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                key = f"{layout} {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"{mode} {err:.2e}")
                if not err <= bar:
                    fail(f"{mode} ({layout}) disagrees with its plain version: {err} > {bar} "
                         f"at H={h} B={b} {act} {name}")
        say(f"[layout] lstm_fwd {layout} H={h} W=48 B={b} {name}: every mode within its bar "
            f"and bitwise repeatable; tanh errors: {', '.join(line)}")
    return worst


def scaled_err(got, ref) -> float:
    """max|got - ref| / max(1, max|ref|)."""
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))


def phase_grad_parity(torch, cuda_lstm, shapes=SHAPES, batches=TRAIN_BATCHES,
                      tag: str = "grad") -> dict:
    """Kernel 1 with_cs, kernel 2 (plain, dcs, with_carries) and kernel 3
    against their plain versions on the same inputs: the forward's from
    ``lstm_inputs``, hs and cs from the kernel, seeded cotangents; at
    ``shapes`` x ``batches``."""
    names = ("lstm_fwd_cs", "lstm_bwd", "lstm_adj")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    h = HIDDEN
    for w, f in shapes:
        for b in batches:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype, seed=w + b + 1)
                    g = torch.Generator(device="cuda")
                    g.manual_seed(w * b)
                    rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                    with torch.no_grad():
                        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs=True)
                        errs = {"lstm_fwd_cs": list(zip(
                            (hs, cs), cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs=True)))}
                        dhs, dcs = rnd(w, b, h), rnd(w, b, h)
                        errs["lstm_bwd"] = []
                        for dcs_, carries in ((None, False), (dcs, False), (None, True)):
                            errs["lstm_bwd"] += list(zip(
                                cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, dcs_, act, carries),
                                cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, dhs, dcs_, act, carries)))
                        _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None,
                                                                 act, True)
                        u, v = rnd(w, b, 4 * h), rnd(h, 4 * h)
                        errs["lstm_adj"] = list(zip(
                            cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, u, v, act),
                            cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, u, v, act)))
                    torch.cuda.synchronize()
                    line = []
                    for k, pairs in errs.items():
                        for got, ref in pairs:
                            if got.shape != ref.shape or not torch.isfinite(got).all():
                                fail(f"{k} output not finite/shaped at W={w} B={b} {act} {name}")
                        err = max(scaled_err(a, r) for a, r in pairs)
                        worst[k][name] = max(worst[k][name], err)
                        worst_abs[k][name] = max(worst_abs[k][name], max(
                            float((a - r).abs().max()) for a, r in pairs))
                        line.append(f"{k} {err:.2e}")
                        if not err <= GRAD_BARS[name]:
                            fail(f"{k} disagrees with its plain version: {err} > "
                                 f"{GRAD_BARS[name]} at W={w} B={b} {act} {name}")
                    say(f"[{tag}] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
                        f"{', '.join(line)} (limit {GRAD_BARS[name]:.0e})")
    return {"scaled": worst, "abs": worst_abs}


def stack_inputs(torch, w, f, b, act, dtype, seed):
    """xz1, rec1, k2, b2 and rec2 as the critic makes them: two
    Keras-initialised layers (F -> H, H -> H) and layer 1's projection of
    standard-normal windows; also the layers and the windows."""
    from hfrep_tpu_torch.ops.lstm import KerasLSTM

    g = torch.Generator()
    g.manual_seed(seed)
    l0 = KerasLSTM(f, HIDDEN, activation=act, device="cuda", generator=g)
    l1 = KerasLSTM(HIDDEN, HIDDEN, activation=act, device="cuda", generator=g)
    x = torch.randn((b, w, f), generator=g).cuda()
    with torch.no_grad():
        xz1 = (x.reshape(b * w, f) @ l0.kernel + l0.bias).reshape(b, w, 4 * HIDDEN)
        weights = (xz1.transpose(0, 1).contiguous(), l0.recurrent_kernel, l1.kernel,
                   l1.bias, l1.recurrent_kernel)
        weights = tuple(t.detach().to(dtype).contiguous() for t in weights)
    return (l0, l1), x, weights


def phase_stack_parity(torch, cuda_lstm_stack, shapes=SHAPES, batches=TRAIN_BATCHES,
                       tag: str = "stack") -> dict:
    """Kernels 4 (primal, with_res), 5 (plain, directs, with_carries) and
    6 against their plain versions on the same inputs: the forward's from
    ``stack_inputs``, the residuals from the kernel, seeded cotangents; at
    ``shapes`` x ``batches``."""
    cls = cuda_lstm_stack
    names = ("stack_fwd", "stack_bwd", "stack_adj")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    h = HIDDEN
    for w, f in shapes:
        for b in batches:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, wts = stack_inputs(torch, w, f, b, act, dtype, seed=w + b + 2)
                    g = torch.Generator(device="cuda")
                    g.manual_seed(w * b + 1)
                    rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                    with torch.no_grad():
                        res = cls.stack_fwd_cuda(*wts, act, with_res=True)
                        errs = {"stack_fwd": [(cls.stack_fwd_cuda(*wts, act),
                                               cls.stack_seq_plain(*wts, act))]
                                + list(zip(res, cls.stack_seq_plain(*wts, act, True)))}
                        dhs2 = rnd(w, b, h)
                        directs = (rnd(w, b, h), rnd(w, b, h), rnd(w, b, h))
                        errs["stack_bwd"] = []
                        for d, carries in ((None, False), (directs, False), (None, True)):
                            errs["stack_bwd"] += list(zip(
                                cls.stack_bwd_cuda(*wts, *res, dhs2, d, act, carries),
                                cls.stack_bwd_plain(*wts, *res, dhs2, d, act, carries)))
                        carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, act, True)[5:]
                        cots = (rnd(w, b, 4 * h), rnd(h, 4 * h), rnd(h, 4 * h), rnd(4 * h),
                                rnd(h, 4 * h))
                        errs["stack_adj"] = list(zip(
                            cls.stack_adj_cuda(*wts, *res, *carried, *cots, act),
                            cls.stack_adj_plain(*wts, *res, *carried, *cots, act)))
                    torch.cuda.synchronize()
                    line = []
                    for k, pairs in errs.items():
                        for got, ref in pairs:
                            if got.shape != ref.shape or not torch.isfinite(got).all():
                                fail(f"{k} output not finite/shaped at W={w} B={b} {act} {name}")
                        err = max(scaled_err(a, r) for a, r in pairs)
                        worst[k][name] = max(worst[k][name], err)
                        worst_abs[k][name] = max(worst_abs[k][name], max(
                            float((a - r).abs().max()) for a, r in pairs))
                        line.append(f"{k} {err:.2e}")
                        if not err <= GRAD_BARS[name]:
                            fail(f"{k} disagrees with its plain version: {err} > "
                                 f"{GRAD_BARS[name]} at W={w} B={b} {act} {name}")
                    say(f"[{tag}] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
                        f"{', '.join(line)} (limit {GRAD_BARS[name]:.0e})")
    return {"scaled": worst, "abs": worst_abs}


def phase_stack_layouts(torch, cuda_lstm_stack) -> dict:
    """The stack forward's two modes, the backward's three (plain, direct
    cotangents, with the carries) and the adjoint in both layouts against
    the plain versions: the cluster layouts at H=100 with B=133 (three
    batch rows a cluster), the wide layouts at ``STACK_WIDE_CASES`` with B
    in {8, 133}; W=48, every activation, seeded inputs (xz1 and b2 0.3
    N(0,1), matrices 0.5 N(0,1)/sqrt(H), as the card tests; the backward on
    the forward kernel's residuals, the adjoint on those and the backward
    kernel's carries, with seeded cotangents).  Bars: the primal abs f32
    2e-5 / bf16 1e-2, every other mode scaled by max(1, max|plain|), f32
    1e-4 / bf16 1e-2.  Each mode launched twice must give the same bits;
    the three sweeps' launch rules must pick the same layout."""
    cls = cuda_lstm_stack
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm_stack.cuda_lstm._lib().hfrep_max_smem_optin(0)
    cases = [(HIDDEN, "float32", 133), (HIDDEN, "bfloat16", 133)]
    cases += [(h, name, b) for h, name in STACK_WIDE_CASES for b in (8, 133)]
    worst = {}
    for h, name, b in cases:
        dtype = getattr(torch, name)
        layout = cls.stack_fwd_layout(h, dtype, b, sms, limit)[0]
        if {cls.stack_bwd_layout(h, dtype, b, sms, limit)[0],
                cls.stack_adj_layout(h, dtype, b, sms, limit)[0]} != {layout}:
            fail(f"stack_fwd, stack_bwd and stack_adj pick different layouts at H={h} B={b} "
                 f"{name}")
        g = torch.Generator(device="cuda")
        g.manual_seed(h + b + 7)
        rnd = lambda s, *shape: s * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        m = 0.5 / h ** 0.5
        wts = (rnd(0.3, 48, b, 4 * h).to(dtype), rnd(m, h, 4 * h).to(dtype),
               rnd(m, h, 4 * h).to(dtype), rnd(0.3, 4 * h).to(dtype),
               rnd(m, h, 4 * h).to(dtype))
        line = []
        for act in ACTS:
            for with_res in (False, True):
                mode = "with_res" if with_res else "primal"
                with torch.no_grad():
                    got = cls.stack_fwd_cuda(*wts, act, with_res)
                    again = cls.stack_fwd_cuda(*wts, act, with_res)
                    ref = cls.stack_seq_plain(*wts, act, with_res)
                torch.cuda.synchronize()
                got, again, ref = ((x,) if torch.is_tensor(x) else x for x in (got, again, ref))
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"stack_fwd {mode} ({layout}) not finite/shaped at H={h} B={b} "
                             f"{act} {name}")
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"stack_fwd {mode} ({layout}): two launches differ at H={h} B={b} "
                         f"{act} {name}")
                if with_res:
                    err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                else:
                    err, bar = float((got[0] - ref[0]).abs().max()), BARS[name]
                key = f"{layout} stack_fwd {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"{mode} {err:.2e}")
                if not err <= bar:
                    fail(f"stack_fwd {mode} ({layout}) disagrees with its plain version: "
                         f"{err} > {bar} at H={h} B={b} {act} {name}")
            dhs2 = rnd(0.3, 48, b, h)
            directs = (rnd(0.3, 48, b, h), rnd(0.3, 48, b, h), rnd(0.3, 48, b, h))
            for mode, d, carries in (("plain", None, False), ("directs", directs, False),
                                     ("carries", None, True)):
                with torch.no_grad():
                    res = cls.stack_fwd_cuda(*wts, act, True)
                    got = cls.stack_bwd_cuda(*wts, *res, dhs2, d, act, carries)
                    again = cls.stack_bwd_cuda(*wts, *res, dhs2, d, act, carries)
                    ref = cls.stack_bwd_plain(*wts, *res, dhs2, d, act, carries)
                torch.cuda.synchronize()
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"stack_bwd {mode} ({layout}) not finite/shaped at H={h} B={b} "
                             f"{act} {name}")
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"stack_bwd {mode} ({layout}): two launches differ at H={h} B={b} "
                         f"{act} {name}")
                err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                key = f"{layout} stack_bwd {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"bwd {mode} {err:.2e}")
                if not err <= bar:
                    fail(f"stack_bwd {mode} ({layout}) disagrees with its plain version: "
                         f"{err} > {bar} at H={h} B={b} {act} {name}")
            cots = (rnd(0.3, 48, b, 4 * h), rnd(0.3, h, 4 * h), rnd(0.3, h, 4 * h),
                    rnd(0.3, 4 * h), rnd(0.3, h, 4 * h))
            with torch.no_grad():
                res = cls.stack_fwd_cuda(*wts, act, True)
                carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, act, True)[5:]
                got = cls.stack_adj_cuda(*wts, *res, *carried, *cots, act)
                again = cls.stack_adj_cuda(*wts, *res, *carried, *cots, act)
                ref = cls.stack_adj_plain(*wts, *res, *carried, *cots, act)
            torch.cuda.synchronize()
            for a, r in zip(got, ref):
                if a.shape != r.shape or not torch.isfinite(a).all():
                    fail(f"stack_adj ({layout}) not finite/shaped at H={h} B={b} {act} {name}")
            if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                fail(f"stack_adj ({layout}): two launches differ at H={h} B={b} {act} {name}")
            err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
            key = f"{layout} stack_adj {name}"
            worst[key] = max(worst.get(key, 0.0), err)
            if act == "tanh":
                line.append(f"adj {err:.2e}")
            if not err <= bar:
                fail(f"stack_adj ({layout}) disagrees with its plain version: {err} > {bar} at "
                     f"H={h} B={b} {act} {name}")
        say(f"[stack] layout {layout} H={h} W=48 B={b} {name}: stack_fwd, stack_bwd and "
            f"stack_adj within their bars and bitwise repeatable; tanh errors: {', '.join(line)}")
    return worst


#: the backward's modes: (name, dcs, with_carries, carry0)
BWD_MODES = (("plain", False, False, False), ("dcs", True, False, False),
             ("carries", False, True, False), ("carry0", False, False, True),
             ("carry0 dcs carries", True, True, True))


def phase_bwd_layouts(torch, cuda_lstm) -> dict:
    """The backward kernel's modes in both layouts against the plain
    version: the register layout at H=100 with B=133 (two batch rows a
    block), the wide layout at ``STACK_WIDE_CASES`` (H=117 f32, H=160 bf16)
    with B in {8, 133}; W=48, every activation, on the forward kernel's
    residuals, seeded inputs (xz 0.3 N(0,1), rec 0.5 N(0,1)/sqrt(H), carry
    0.5 N(0,1), cotangents 0.3 N(0,1)).  Bars scaled by max(1, max|plain|),
    f32 1e-4 / bf16 1e-2.  Each mode launched twice must give the same
    bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    cases = [(HIDDEN, "float32", 133), (HIDDEN, "bfloat16", 133)]
    cases += [(h, name, b) for h, name in STACK_WIDE_CASES for b in (8, 133)]
    worst = {}
    for h, name, b in cases:
        dtype = getattr(torch, name)
        layout = cuda_lstm.bwd_layout(h, dtype, b, sms, limit)[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(h + b + 11)
        rnd = lambda s, *shape: s * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        xz, rec = rnd(0.3, 48, b, 4 * h).to(dtype), rnd(0.5 / h ** 0.5, h, 4 * h).to(dtype)
        carry = (rnd(0.5, b, h), rnd(0.5, b, h))
        dhs, dcs, dc_fin = rnd(0.3, 48, b, h), rnd(0.3, 48, b, h), rnd(0.3, b, h)
        line = []
        for act in ACTS:
            for mode, with_dcs, carries, carried in BWD_MODES:
                c = carry if carried else None
                with torch.no_grad():
                    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, c)
                    args = (xz, rec, hs, cs, dhs, dcs if with_dcs else None, act, carries, c,
                            dc_fin if carried else None)
                    got = cuda_lstm.lstm_bwd_cuda(*args)
                    again = cuda_lstm.lstm_bwd_cuda(*args)
                    ref = cuda_lstm.lstm_bwd_plain(*args)
                torch.cuda.synchronize()
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"lstm_bwd {mode} ({layout}) not finite/shaped at H={h} B={b} "
                             f"{act} {name}")
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"lstm_bwd {mode} ({layout}): two launches differ at H={h} B={b} "
                         f"{act} {name}")
                err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                key = f"{layout} lstm_bwd {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"{mode} {err:.2e}")
                if not err <= bar:
                    fail(f"lstm_bwd {mode} ({layout}) disagrees with its plain version: "
                         f"{err} > {bar} at H={h} B={b} {act} {name}")
        say(f"[layout] lstm_bwd {layout} H={h} W=48 B={b} {name}: every mode within its bar "
            f"and bitwise repeatable; tanh errors: {', '.join(line)}")
    return worst


#: the adjoint's modes: (name, carry, mu0)
ADJ_MODES = (("carry-free", False, False), ("carry", True, True),
             ("carry, null mu0", True, False))


def phase_adj_layouts(torch, cuda_lstm) -> dict:
    """The adjoint kernel's modes in both layouts against the plain
    version: the register layout at H=100 with B=133 (two batch rows a
    block), the wide layout at ``STACK_WIDE_CASES`` (H=117 f32, H=160 bf16)
    with B in {8, 133}; W=48, every activation, on the forward kernel's
    residuals and the backward kernel's carries, seeded inputs (xz 0.3
    N(0,1), rec 0.5 N(0,1)/sqrt(H), carry 0.5 N(0,1), cotangents and mu0
    0.3 N(0,1)); the carry mode from a nonzero carry with mu0 and with a
    null mu0.  Bars scaled by max(1, max|plain|), f32 1e-4 / bf16 1e-2.
    Each mode launched twice must give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    cases = [(HIDDEN, "float32", 133), (HIDDEN, "bfloat16", 133)]
    cases += [(h, name, b) for h, name in STACK_WIDE_CASES for b in (8, 133)]
    worst = {}
    for h, name, b in cases:
        dtype = getattr(torch, name)
        layout = cuda_lstm.adj_layout(h, dtype, b, sms, limit)[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(h + b + 13)
        rnd = lambda s, *shape: s * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        xz, rec = rnd(0.3, 48, b, 4 * h).to(dtype), rnd(0.5 / h ** 0.5, h, 4 * h).to(dtype)
        carry = (rnd(0.5, b, h), rnd(0.5, b, h))
        dhs, dc_fin = rnd(0.3, 48, b, h), rnd(0.3, b, h)
        u, v, mu0 = rnd(0.3, 48, b, 4 * h), rnd(0.3, h, 4 * h), (rnd(0.3, b, h), rnd(0.3, b, h))
        line = []
        for act in ACTS:
            for mode, carried, with_mu in ADJ_MODES:
                c = carry if carried else None
                with torch.no_grad():
                    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, c)
                    dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None, act, True, c,
                                                       dc_fin if carried else None)[2:4]
                    args = (xz, rec, hs, cs, dhT, dcT, u, v, act, c, mu0 if with_mu else None)
                    got = cuda_lstm.lstm_adj_cuda(*args)
                    again = cuda_lstm.lstm_adj_cuda(*args)
                    ref = cuda_lstm.lstm_adj_plain(*args)
                torch.cuda.synchronize()
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"lstm_adj {mode} ({layout}) not finite/shaped at H={h} B={b} "
                             f"{act} {name}")
                if len(got) != len(ref) or not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"lstm_adj {mode} ({layout}): two launches differ at H={h} B={b} "
                         f"{act} {name}")
                err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                key = f"{layout} lstm_adj {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"{mode} {err:.2e}")
                if not err <= bar:
                    fail(f"lstm_adj {mode} ({layout}) disagrees with its plain version: "
                         f"{err} > {bar} at H={h} B={b} {act} {name}")
        say(f"[layout] lstm_adj {layout} H={h} W=48 B={b} {name}: every mode within its bar "
            f"and bitwise repeatable; tanh errors: {', '.join(line)}")
    return worst


def sum_case(torch, g, nsum, npair, r, m):
    """Seeded operands of a weight-sum launch: ``nsum`` sums of ``npair``
    pairs over ``r`` rows, shift 32 (the epoch's B), no heads; A and B
    N(0,1) (A None for the column sum)."""
    return [([(None if m == 1 else torch.randn((r, m), generator=g, device="cuda"),
               torch.randn((r, 4 * HIDDEN), generator=g, device="cuda"), None)
              for _ in range(npair)], 32) for _ in range(nsum)]


def sum_bound_ms(nsum, npair, r, m) -> tuple:
    """Least time of a weight-sum launch: 2 * R * M * N operations a pair
    and a sum over 67 TFLOP/s float32, against each A and B read once and
    each C written once over 3.35 TB/s (a column sum reads no A)."""
    n = 4 * HIDDEN
    ops = 2.0 * nsum * npair * r * m * n
    nbytes = 4.0 * (nsum * npair * r * ((m if m > 1 else 0) + n) + nsum * m * n)
    t_ops = ops / PEAK_OPS_PER_S["float32"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_sums(torch, cuda_lstm) -> list:
    """The weight sums alone (``weight_sums_cuda``) at each shape the main
    path gives them (``SUM_SHAPES`` at ``SUM_ROWS``) against
    ``weight_sum_plain`` on the same inputs (scaled bar 1e-4: up to 2 x
    10,752 rows summed in another order), each launched twice and
    bit-equal; then timed by the profiler's device time beside the plain
    version, the bound and one PyTorch call computing the same function
    (``library_ms``, float32, TF32 off): ``torch.matmul`` of the shifted
    A^T and B (two pairs stacked along the rows), ``torch.bmm`` for three
    sums, ``torch.sum`` for the column sum."""
    rows = []
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    for r in SUM_ROWS:
        for shape, nsum, npair, m in SUM_SHAPES:
            sums = sum_case(torch, g, nsum, npair, r, m)
            with torch.no_grad():
                got = cuda_lstm.weight_sums_cuda(sums)
                again = cuda_lstm.weight_sums_cuda(sums)
                ref = [cuda_lstm.weight_sum_plain(t, sh) for t, sh in sums]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"weight sum {shape} R={r}: two launches differ")
            for a, b in zip(got, ref):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    fail(f"weight sum {shape} R={r}: not finite/shaped")
            err = max(scaled_err(a, b) for a, b in zip(got, ref))
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            if not err <= GRAD_BARS["float32"]:
                fail(f"weight sum {shape} R={r} disagrees with its plain version: {err}")
            if m == 1:
                col = torch.cat([b for _, b, _ in sums[0][0]])
                library = lambda: torch.sum(col, 0)  # noqa: E731
            else:
                a_t = torch.stack([torch.cat([torch.cat([torch.zeros((sh, m), device="cuda"),
                                                         a[:r - sh]]) for a, _, _ in t])
                                   for t, sh in sums])
                b_t = torch.stack([torch.cat([b for _, b, _ in t]) for t, _ in sums])
                if nsum == 1:
                    a0, b0 = a_t[0].T, b_t[0]
                    library = lambda: torch.matmul(a0, b0)  # noqa: E731
                else:
                    a_tt = a_t.transpose(1, 2)
                    library = lambda: torch.bmm(a_tt, b_t)  # noqa: E731
            with torch.no_grad():
                ms = device_ms(torch, lambda: cuda_lstm.weight_sums_cuda(sums), 20,
                               match="hfrep::ws::")
                events = time_ms(torch, lambda: cuda_lstm.weight_sums_cuda(sums), 50)
                plain = device_ms(torch, lambda: [cuda_lstm.weight_sum_plain(t, sh)
                                                  for t, sh in sums], 10, match="")
                lib_ms = device_ms(torch, library, 20, match="")
            bnd, by = sum_bound_ms(nsum, npair, r, m)
            splits = cuda_lstm.sum_plan(nsum, npair, r, m, 4 * HIDDEN,
                                        torch.cuda.get_device_properties(0).multi_processor_count)[2]
            rows.append({"shape": shape, "R": r, "sums": nsum, "pairs": npair, "M": m,
                         "N": 4 * HIDDEN, "blocks_a_tile": splits, "max_abs_err": abs_err,
                         "max_scaled_err": err, "ms": ms, "events_ms": events,
                         "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bnd,
                         "bound_by": by})
            say(f"[sums] {shape:11s} R={r:5d}: scaled err {err:.2e}, bit-equal; device "
                f"{ms:.4f} ms ({splits} blocks a tile; CUDA events {events:.4f}), plain "
                f"{plain:.4f} ms, torch {lib_ms:.4f} ms, bound {bnd:.5f} ms ({by})")
    return rows


def check_answers(torch, np, srv, futures, panels, preset_cfg) -> None:
    """Every answer finite and shaped; a few held against the plain path
    of the same models on the CPU."""
    from hfrep_tpu_torch.serve import aot

    w, f = preset_cfg.window, preset_cfg.features
    n_rep = 0
    for j, fut in enumerate(futures):
        value = fut.result().value
        if "windows" in value:
            win = value["windows"]
            if win.shape != (1, w, f) or not np.isfinite(win).all():
                fail(f"sample answer {j}: shape {win.shape}, finite "
                     f"{bool(np.isfinite(win).all())}")
        else:
            rec = value["reconstruction"]
            p = panels[j % len(panels)]
            if rec.shape != p.shape or not np.isfinite(rec).all():
                fail(f"replicate answer {j}: shape {rec.shape}")
            n_rep += 1
    # replicate: the served answer against the head run on the CPU
    ae_cpu = aot.AEServeModel(cfg=srv.ae_model.cfg,
                              module=copy.deepcopy(srv.ae_model.module).cpu(),
                              decoder_host=srv.ae_model.decoder_host)
    for j in (0, 2):
        p = panels[j % len(panels)]
        x, n = aot.pad_panel_batch([p], 1, aot.bucket_for(p.shape[0], srv.cfg.row_buckets),
                                   p.shape[1], device="cpu")
        recon, _ = aot.ae_batch_fn(ae_cpu)(ae_cpu.params, x, n,
                                           aot.full_mask(ae_cpu.cfg, device="cpu"))
        got = futures[j].result().value["reconstruction"]
        err = float(np.max(np.abs(got - recon[0, : p.shape[0]].numpy())))
        if not err <= 1e-5:
            fail(f"replicate answer {j} differs from the CPU head by {err}")
    # sample: the generator on the card (kernel) and on the CPU (plain)
    gen_cpu = aot.GenServeModel(cfg=srv.gen_model.cfg,
                                module=copy.deepcopy(srv.gen_model.module).cpu())
    g = torch.Generator()
    g.manual_seed(11)
    noise = torch.randn((8, w, f), generator=g)
    on_card = aot.gen_batch_fn(srv.gen_model)(srv.gen_model.params, noise.cuda()).cpu()
    on_cpu = aot.gen_batch_fn(gen_cpu)(gen_cpu.params, noise)
    err = float((on_card - on_cpu).abs().max())
    say(f"[server] {preset_cfg.family} W={w}: {n_rep} replicate answers checked; "
        f"generator on card vs CPU plain path max|diff| = {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        fail(f"generator on the card differs from the CPU plain path by {err}")


def export_against_eager(torch, srv, panels) -> dict:
    """A second server over ``srv``'s models with ``via_export=False``: its
    warm seconds, the same load as ``srv``'s (its p50, p95 and qps, to set
    beside the exported server's), and every bucket's program of ``srv``
    (a loaded ``torch.export`` program) against the second server's (the
    eager one) on the same operands, every output bit for bit.  A served
    answer is its bucket program's output, sliced."""
    from hfrep_tpu_torch.serve import aot
    from hfrep_tpu_torch.serve.fixture import fixture_server, warm_server
    from hfrep_tpu_torch.serve.loadgen import drive_load
    from hfrep_tpu_torch.serve.server import ServeConfig

    ae, gen = srv.ae_model, srv.gen_model
    off = fixture_server(ServeConfig(via_export=False), preset=None, gen_model=gen,
                         ae_model=ae, device="cuda")
    try:
        t0 = time.perf_counter()
        off.warm()
        torch.cuda.synchronize()
        warm_off = time.perf_counter() - t0
        warm_server(off, panels)
        load = drive_load(off, 64, panels, sample_every=2, timeout_ms=30000)
        if load["results"] != 64:
            fail(f"server: the export-off server answered {load['results']} of 64 ({load})")
        on, eager = srv.cache.programs(), off.cache.programs()
        if set(on) != set(eager) or off.stats()["cache"]["modes"] != {"compiled": len(eager)}:
            fail(f"server: the export-off server's programs {sorted(eager, key=str)} "
                 f"({off.stats()['cache']['modes']}) against {sorted(on, key=str)}")
        g = torch.Generator(device="cuda")
        g.manual_seed(17)
        mask = aot.full_mask(ae.cfg, device="cuda")
        outputs = n_diff = 0
        for key in sorted(on, key=str):
            if key[0] == "replicate":
                _, bsz, rows = key
                fits = [p for p in panels if p.shape[0] <= rows]
                x, n = aot.pad_panel_batch([fits[i % len(fits)] for i in range(bsz)], bsz,
                                           rows, ae.cfg.n_factors, device="cuda")
                args = (ae.params, x, n, mask)
            else:
                args = (gen.params, torch.randn((key[1], gen.cfg.window, gen.cfg.features),
                                                generator=g, device="cuda"))
            a, b = on[key](*args), eager[key](*args)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            outputs += len(a)
            n_diff += sum(not torch.equal(x, y) for x, y in zip(a, b))
        torch.cuda.synchronize()
    finally:
        off.stop()
    return {"warm_off_s": warm_off, "programs": len(on), "outputs": outputs, "n_diff": n_diff,
            "p50_ms": load["p50_ms"], "p95_ms": load["p95_ms"], "qps": load["qps"]}


def phase_server(torch, np, cuda_lstm) -> dict:
    from hfrep_tpu_torch.config import AEConfig, get_preset
    from hfrep_tpu_torch.serve.fixture import fixture_server, init_ae_model, warm_server
    from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
    from hfrep_tpu_torch.serve.server import ServeConfig

    # the AE head: AEConfig() widths (the paper's 22 factors), Keras-default init
    panels = make_panels(0, 22, (12, 48, 96, 200))
    out = {"launches": 0, "runs": []}
    say("[server] AE head: AEConfig() widths (22 factors, latent 21), Keras-default init")
    for preset in ("mtss_wgan_gp", "mtss_wgan_gp_prod"):
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        srv = fixture_server(ServeConfig(), preset=preset, device="cuda",
                             ae_model=init_ae_model(AEConfig(), device="cuda"))
        t_warm = time.perf_counter()
        srv.warm()                              # the program grid, each bucket exported
        torch.cuda.synchronize()
        warm_on = time.perf_counter() - t_warm
        programs = warm_server(srv, panels)     # the grid resident + one batch per path
        report = drive_load(srv, 64, panels, sample_every=2, timeout_ms=30000,
                            keep_futures=True)
        doc = srv.drain(timeout=60)
        torch.cuda.synchronize()
        launches = cuda_lstm.launches
        wall = time.perf_counter() - t0
        futures = report.pop("futures")
        say(f"[server] {preset}: {programs} programs warmed; submitted "
            f"{report['submitted']}, terminal {report['terminal']}, results "
            f"{report['results']}, worker faults {doc['worker_faults']}; "
            f"p50 {report['p50_ms']:.3f} ms, p95 {report['p95_ms']:.3f} ms, "
            f"{report['qps']} req/s; lstm_fwd launches {launches}; {wall:.1f} s")
        if not (report["terminal"] == report["submitted"] == 64
                and doc["terminal"] == doc["submitted"]):
            fail(f"{preset}: terminal != submitted ({report}, {doc})")
        if report["results"] != 64 or doc["results"] != doc["submitted"]:
            fail(f"{preset}: not every request got a result ({report}, {doc})")
        if launches < 1:
            fail(f"{preset}: the server ran no lstm_fwd kernel")
        modes = srv.stats()["cache"]["modes"]
        if modes != {"export": programs}:
            fail(f"{preset}: with via_export on, the {programs} programs came up as {modes}")
        check_answers(torch, np, srv, futures, panels, get_preset(preset).model)
        exp = export_against_eager(torch, srv, panels)
        say(f"[server] {preset}: every bucket a loaded torch.export program ({modes}); "
            f"warm {warm_on:.2f} s with export on, {exp['warm_off_s']:.2f} s off "
            f"({exp['programs']} programs); each bucket's program against the export-off "
            f"server's on the same operands: {exp['outputs'] - exp['n_diff']} of "
            f"{exp['outputs']} outputs bit-equal; the same load export on / off: p50 "
            f"{report['p50_ms']:.3f} / {exp['p50_ms']:.3f} ms, p95 {report['p95_ms']:.3f} / "
            f"{exp['p95_ms']:.3f} ms, {report['qps']} / {exp['qps']} req/s")
        if exp["n_diff"]:
            fail(f"{preset}: {exp['n_diff']} outputs of the exported programs differ from "
                 f"the eager ones")
        out["launches"] += launches
        out["runs"].append({"preset": preset, "launches": launches, "modes": modes,
                            "warm_export_s": warm_on, "warm_eager_s": exp["warm_off_s"],
                            "p50_ms": report["p50_ms"], "p95_ms": report["p95_ms"],
                            "qps": report["qps"], "results": report["results"],
                            "eager_p50_ms": exp["p50_ms"], "eager_p95_ms": exp["p95_ms"],
                            "eager_qps": exp["qps"]})
    return out


def device_time_by_name(prof) -> dict:
    """Device time by kernel name (:func:`device_events`)."""
    by_name = {}
    for key, _, dev_us in device_events(prof):
        if dev_us > 0:
            by_name[key] = by_name.get(key, 0.0) + dev_us
    return by_name


def profile_epoch(torch, step, state, draws) -> dict:
    """One epoch under ``torch.profiler`` (:func:`traced`, an epoch in its
    warm-up step): device time by kernel name and the device's busy share
    of the epoch's wall time."""
    wall = []

    def run():
        t0 = time.perf_counter()
        step(state, draws)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)

    torch.cuda.synchronize()
    prof = traced(torch, lambda: step(state, draws), run)
    wall_us = wall[0]
    by_name = device_time_by_name(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "busy_share": busy_us / wall_us if busy_us else None,
            "top": [{"name": k[:80], "us": v} for k, v in top], "names": sorted(by_name)}


def zero_slots(torch, slots: dict) -> dict:
    """Optimizer slots like ``slots``, zeroed: a fresh RMSprop ``nu`` or
    Adam ``mu``/``nu`` with count 0."""
    return {k: ({n: torch.zeros_like(t) for n, t in v.items()} if isinstance(v, dict) else 0)
            for k, v in slots.items()}


def update_errs(p0: dict, card, cpu) -> dict:
    """How far one epoch's update on the card is from the CPU's, both from
    the same params ``p0`` (``{"g": {name: tensor}, "d": ...}``) and from
    zeroed slots: per parameter the update's direction, |Δcard - ΔCPU|_2
    / |ΔCPU|_2 with Δ = p1 - p0, and the slots, |card - CPU| / max|CPU|
    (RMSprop's ν holds (1 - decay) g² after the first update, so a slot
    is the gradient's size; Adam's μ its sign as well).  The worst of each
    and where."""
    out = {"update_rel_l2": 0.0, "update_at": None, "slot_scaled_err": 0.0, "slot_at": None}
    for net, a_state, b_state in (("g", card.generator, cpu.generator),
                                  ("d", card.discriminator, cpu.discriminator)):
        a_opt, b_opt = (card.g_opt, cpu.g_opt) if net == "g" else (card.d_opt, cpu.d_opt)
        for (n, a), (_, b) in zip(a_state.named_parameters(), b_state.named_parameters()):
            da = a.detach().cpu().double() - p0[net][n].double()
            db = b.detach().double() - p0[net][n].double()
            rel = float((da - db).norm() / db.norm().clamp_min(1e-30))
            if rel >= out["update_rel_l2"]:
                out["update_rel_l2"], out["update_at"] = rel, f"{net}.{n}"
            for slot in ("mu", "nu"):
                if slot in b_opt:
                    x, y = a_opt[slot][n].detach().cpu().double(), b_opt[slot][n].double()
                    err = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                    if err >= out["slot_scaled_err"]:
                        out["slot_scaled_err"], out["slot_at"] = err, f"{net}.{n}.{slot}"
    return out


def epoch_parity(torch, step_on, state, draws, bf16: bool = False) -> dict:
    """One epoch on the card and the same epoch — a copy of the state (its
    critic route included), the same draws — through the plain path on
    the CPU.  ``step_on(device)`` builds the epoch step on ``"cuda"`` or
    ``"cpu"``.  Bars: float32 losses rtol 1e-4 and every param atol 1e-5
    + rtol 1e-4; with ``bf16`` the epoch starts from zeroed optimizer
    slots, and the losses are held at rtol BF16_LOSS_RTOL, every param at
    |card - CPU| <= BF16_PARAM_BAR max(1, max|CPU|), and the update the
    gradients decide (:func:`update_errs`) at BF16_UPDATE_BAR and
    BF16_SLOT_BAR."""
    from hfrep_tpu_torch.train import Draws

    if bf16:
        state = dataclasses.replace(state, g_opt=zero_slots(torch, state.g_opt),
                                    d_opt=zero_slots(torch, state.d_opt))
    cpu_state = state.to("cpu")
    p0 = {"g": {n: p.detach().clone() for n, p in cpu_state.generator.named_parameters()},
          "d": {n: p.detach().clone() for n, p in cpu_state.discriminator.named_parameters()}}
    cpu_draws = Draws(*(None if t is None else t.cpu()
                        for t in (draws.idx, draws.noises, draws.alphas)))
    state, m = step_on("cuda")(state, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu_state, mc = step_on("cpu")(cpu_state, cpu_draws)
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(float(m[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-30)
           for k in ("d_loss", "g_loss")}
    worst, worst_at, max_diff, scaled = 0.0, None, 0.0, 0.0
    for net, card_mod, cpu_mod in (("g", state.generator, cpu_state.generator),
                                   ("d", state.discriminator, cpu_state.discriminator)):
        for (n, a), (_, r) in zip(card_mod.named_parameters(), cpu_mod.named_parameters()):
            diff = (a.detach().cpu() - r.detach()).abs()
            ratio = float((diff / (1e-5 + 1e-4 * r.detach().abs())).max())
            err = float(diff.max()) / max(1.0, float(r.detach().abs().max()))
            max_diff = max(max_diff, float(diff.max()))
            if (err > scaled) if bf16 else (ratio > worst):
                worst_at = f"{net}.{n}"
            worst, scaled = max(worst, ratio), max(scaled, err)
    upd = update_errs(p0, state, cpu_state) if bf16 else {}
    ok = (all(v <= BF16_LOSS_RTOL for v in rel.values()) and scaled <= BF16_PARAM_BAR
          and upd["update_rel_l2"] <= BF16_UPDATE_BAR and upd["slot_scaled_err"] <= BF16_SLOT_BAR
          if bf16 else all(v <= 1e-4 for v in rel.values()) and worst <= 1.0)
    return {"d_loss": float(m["d_loss"]), "d_loss_cpu": float(mc["d_loss"]),
            "g_loss": float(m["g_loss"]), "g_loss_cpu": float(mc["g_loss"]),
            "loss_rel_diff": rel, "param_max_abs_diff": max_diff,
            "param_worst_ratio": worst, "param_scaled_err": scaled,
            "param_worst_at": worst_at, **upd, "cpu_epoch_s": cpu_s, "ok": ok}


def phase_train(torch, cuda_lstm, route: str, presets=TRAIN_PRESETS) -> list:
    """The training path on one critic route: ``auto`` (the fused stack,
    slice 3's main path) or ``chained`` (two single-layer LSTMs, slice
    2's), each preset with every launch count set to 0 just before its
    counted epochs and read just after."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import (init_gan_state, make_multi_step,
                                       make_train_step, sample_draws)

    out = []
    tag = f"[train:{route}]"
    for k, preset in enumerate(presets):
        cfg = get_preset(preset)
        mcfg = cfg.model
        tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5,
                                   steps_per_call=TRAIN_EPOCHS)
        w = mcfg.window
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + k)
        dataset = torch.rand((1000, w, mcfg.features), generator=g, device="cuda")
        pair = build_gan(mcfg, device="cuda")
        state = init_gan_state(k, mcfg, device="cuda")
        state.discriminator.stack = route
        multi = make_multi_step(pair, tcfg, dataset)
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        state, metrics = multi(state, generator=g)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = cuda_lstm.launch_counts()
        by_key = cuda_lstm.weight_sum_launches()
        sum_launches = {name: by_key[(nsum, npair, m == 1)]
                        for name, nsum, npair, m in SUM_SHAPES}
        d_loss, g_loss = metrics["d_loss"].cpu(), metrics["g_loss"].cpu()
        if d_loss.shape != (TRAIN_EPOCHS,) or not (torch.isfinite(d_loss).all()
                                                   and torch.isfinite(g_loss).all()):
            fail(f"{preset}: losses not finite/shaped: {d_loss}, {g_loss}")
        launched = {n for n, c in launches.items() if c > 0}
        if launched != ROUTE_KERNELS[route]:
            fail(f"{preset} ({route} route): the epochs launched {sorted(launched)}, "
                 f"expected {sorted(ROUTE_KERNELS[route])} ({launches})")
        by_shape = {k: sum(launches[n] for n in names) for k, names in SUM_LAUNCHES.items()}
        if (sum_launches != by_shape or sum(by_key.values()) != sum(sum_launches.values())
                or sum(by_key.values()) != SUM_LAUNCHES_PER_EPOCH * TRAIN_EPOCHS):
            fail(f"{preset} ({route} route): weight-sum launches {sum_launches} (of "
                 f"{sum(by_key.values())}), expected {by_shape} from the kernels' launches, "
                 f"{SUM_LAUNCHES_PER_EPOCH} an epoch")
        per_epoch = {n: c / TRAIN_EPOCHS for n, c in launches.items() if c}
        say(f"{tag} {preset} W={w}: {TRAIN_EPOCHS} epochs in {first_s:.2f} s; d_loss "
            f"{[round(float(x), 5) for x in d_loss]}, g_loss {[round(float(x), 5) for x in g_loss]}; "
            f"launches per epoch: " + ", ".join(f"{n} {c:g}" for n, c in per_epoch.items())
            + f"; weight sums {sum(sum_launches.values()) / TRAIN_EPOCHS:g}")
        t0 = time.perf_counter()
        state, _ = multi(state, generator=g)
        torch.cuda.synchronize()
        ms_epoch = (time.perf_counter() - t0) / TRAIN_EPOCHS * 1e3
        one = dataclasses.replace(tcfg, steps_per_call=1)
        prof = profile_epoch(torch, make_train_step(pair, one, dataset), state,
                             sample_draws(g, pair, one, dataset))
        cpu_pair = build_gan(mcfg, device="cpu")
        parity = epoch_parity(
            torch, lambda dev: make_train_step(pair if dev == "cuda" else cpu_pair, one,
                                               dataset.to(dev)),
            state, sample_draws(g, pair, one, dataset))
        busy = ("not measured" if not prof["device_busy_us"] else
                f"device busy {prof['device_busy_us']:.0f} of {prof['wall_us']:.0f} us "
                f"({100 * prof['busy_share']:.1f}%)")
        say(f"{tag} {preset} W={w}: {ms_epoch:.2f} ms/epoch over {TRAIN_EPOCHS} epochs "
            f"(host clock, synchronised); profiled epoch: {busy}")
        for row in prof["top"]:
            share = 100 * row["us"] / prof["device_busy_us"]
            say(f"{tag}   {row['us']:9.1f} us  {share:5.1f}%  {row['name']}")
        say(f"{tag} {preset} W={w}: one epoch, card vs CPU plain path: d_loss "
            f"{parity['d_loss']:.7g} vs {parity['d_loss_cpu']:.7g} (rel {parity['loss_rel_diff']['d_loss']:.2e}), "
            f"g_loss {parity['g_loss']:.7g} vs {parity['g_loss_cpu']:.7g} "
            f"(rel {parity['loss_rel_diff']['g_loss']:.2e}; limit 1e-4); params max|diff| "
            f"{parity['param_max_abs_diff']:.2e}, worst |diff|/(1e-5+1e-4|cpu|) "
            f"{parity['param_worst_ratio']:.3f} at {parity['param_worst_at']} (limit 1); "
            f"CPU epoch {parity['cpu_epoch_s']:.1f} s")
        if not parity["ok"]:
            fail(f"{preset}: the card's epoch differs from the CPU plain path: {parity}")
        out.append({"route": route, "preset": preset, "W": w, "F": mcfg.features,
                    "launches": launches, "weight_sum_launches": sum_launches,
                    "launches_per_epoch": per_epoch, "d_loss": d_loss.tolist(),
                    "g_loss": g_loss.tolist(), "first_epochs_s": first_s,
                    "ms_per_epoch": ms_epoch, "profile": prof, "parity": parity})
    return out


#: the precision phase: one bf16 epoch a route against the CPU plain path
#: (fused at both presets, chained at W=48), the bf16 ``train-gan`` verb at
#: W=168 with a resume, and the bf16 ``sweep`` verb real only, its AE cut
#: to PRECISION_SWEEP_EPOCHS epochs
PRECISION_SWEEP_EPOCHS = 200
PRECISION_ROUTES = (("mtss_wgan_gp", "auto"), ("mtss_wgan_gp_prod", "auto"),
                    ("mtss_wgan_gp", "chained"))
BF16_LOSS_RTOL, BF16_PARAM_BAR = 5e-2, 1e-2       # JAX's bf16 bar; chip_smoke's bf16 bar
#: one bf16 epoch's update against the CPU's (:func:`update_errs`): the
#: bars tests/test_torch_precision.py holds the port's bf16 epoch to
#: against JAX's, where a gradient of the wrong sign gives 2.0 on the
#: update and a penalty with no gradient about 1.0 on the critic's slots
BF16_UPDATE_BAR, BF16_SLOT_BAR = 0.25, 0.2
#: JAX's bf16 loss bar's atol (``tests/test_precision.py:111-112``, rtol
#: and atol 5e-2): the losses' bar across critic routes (:func:`bf16_doc_errs`)
BF16_JAX_LOSS_ATOL = 5e-2
BF16_AE_RTOL, BF16_AE_ATOL = 5e-2, 1e-4            # JAX's AE bf16 bar
PRECISION_CLI_EPOCHS, PRECISION_RESUME_AT = 5, 2


def recurrence_kernels(names) -> dict:
    """The recurrence kernels (``lstm_*`` / ``stack_*``) among profiler
    kernel names, by readable name, split by operand type: ``{"bf16":
    [...], "other": [...]}``."""
    out = {"bf16": [], "other": []}
    for n in names:
        if ("lstm_" in n or "stack_" in n) and "kernel" in n:
            out["bf16" if "__nv_bfloat16" in n else "other"].append(entry_name(n))
    return out


def float_leaves(tree) -> list:
    """Every floating-point tensor of a checkpoint tree, in tree order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in float_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in float_leaves(v)]
    return [tree] if hasattr(tree, "is_floating_point") and tree.is_floating_point() else []


#: the bf16 products of the policy at their shapes: the AE lanes' two
#: (21 lanes, a batch of 48 rows, 22 factors, latent 21) and the LSTM
#: input projections (B*W rows of F or H columns onto 4H)
GEMM_PROBES = (("AE encode, 21 lanes", (21, 48, 22), (21, 22, 21)),
               ("AE decode, 21 lanes", (21, 48, 21), (21, 21, 22)),
               ("LSTM input projection, W=48", (1536, 35), (35, 400)),
               ("LSTM input projection, W=168", (5376, 36), (36, 400)),
               ("LSTM layer-2 projection, W=168", (5376, 100), (100, 400)))


def bf16_gemm_probe(torch) -> list:
    """What cuBLAS gives the policy's bf16 products: each product with
    PyTorch's reduced-precision bf16 reduction allowed and refused
    (``allow_bf16_reduced_precision_reduction``, which importing the
    package turns off), and each against the float32 product of the same bf16
    values rounded once to bf16; entries that differ."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    rows = []
    try:
        for name, sa, sb in GEMM_PROBES:
            a = torch.randn(sa, generator=g, device="cuda").to(torch.bfloat16)
            b = torch.randn(sb, generator=g, device="cuda").to(torch.bfloat16)
            ref = (a.float() @ b.float()).to(torch.bfloat16)
            got = {}
            for allow in (True, False):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow
                got[allow] = a @ b
            rows.append({"name": name, "a": list(sa), "b": list(sb), "entries": ref.numel(),
                         "allowed_vs_refused": int((got[True] != got[False]).sum()),
                         "refused_vs_f32_rounded": int((got[False] != ref).sum()),
                         "allowed_vs_f32_rounded": int((got[True] != ref).sum())})
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return rows


def phase_precision(torch, np, cuda_lstm, train, train_chained, keep: str) -> dict:
    """The bf16 policy on the card: (a) a bf16 epoch a route, its launches,
    its kernels' instantiations and one epoch against the CPU plain path;
    (b) ``train-gan --dtype bfloat16`` at W=168 with checkpoints and a
    resume; (c) ``sweep --dtype bfloat16``, real only, and the engine's
    bf16 lane sweep on the card against the CPU from the same draws."""
    from hfrep_tpu_torch.config import AEConfig, get_preset
    from hfrep_tpu_torch.core import scaler
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.experiments.cli import _make_trainer
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.replication import engine
    from hfrep_tpu_torch.train import (init_gan_state, make_multi_step, make_train_step,
                                       sample_draws)
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    tag = "[precision]"
    t_phase = time.perf_counter()
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    f32 = {(r["preset"], r["route"]): r for r in train + train_chained}
    out = {"epochs": [], "gemm_probe": bf16_gemm_probe(torch)}
    for r in out["gemm_probe"]:
        say(f"{tag} bf16 GEMM {r['name']} {r['a']} @ {r['b']}: of {r['entries']} entries, "
            f"{r['allowed_vs_refused']} differ between reduced-precision reduction allowed "
            f"and refused; against the float32 product rounded once, {r['refused_vs_f32_rounded']}"
            f" refused, {r['allowed_vs_f32_rounded']} allowed")

    # (a) one bf16 epoch a route, from the f32 train phase's shapes
    for k, (preset, route) in enumerate(PRECISION_ROUTES):
        cfg = get_preset(preset)
        mcfg = dataclasses.replace(cfg.model, dtype="bfloat16")
        tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5,
                                   steps_per_call=TRAIN_EPOCHS)
        w = mcfg.window
        g = torch.Generator(device="cuda")
        g.manual_seed(300 + k)
        dataset = torch.rand((1000, w, mcfg.features), generator=g, device="cuda")
        pair = build_gan(mcfg, device="cuda")
        state = init_gan_state(k, mcfg, device="cuda")
        state.discriminator.stack = route
        multi = make_multi_step(pair, tcfg, dataset)
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        state, metrics = multi(state, generator=g)
        torch.cuda.synchronize()
        launches = cuda_lstm.launch_counts()
        sums = sum_launches_by_shape(cuda_lstm)
        per_epoch = {n: c / TRAIN_EPOCHS for n, c in launches.items() if c}
        want = f32[(preset, route)]["launches_per_epoch"]
        losses = torch.stack([metrics["d_loss"], metrics["g_loss"]]).cpu()
        if not bool(torch.isfinite(losses).all()) or losses.dtype != torch.float32:
            fail(f"precision: {preset} ({route}) bf16 losses {losses}")
        if per_epoch != want or sum(sums.values()) != SUM_LAUNCHES_PER_EPOCH * TRAIN_EPOCHS:
            fail(f"precision: {preset} ({route}) bf16 launches per epoch {per_epoch}, the "
                 f"float32 route's {want}; weight sums {sums}")
        t0 = time.perf_counter()
        state, _ = multi(state, generator=g)
        torch.cuda.synchronize()
        ms_epoch = (time.perf_counter() - t0) / TRAIN_EPOCHS * 1e3
        one = dataclasses.replace(tcfg, steps_per_call=1)
        prof = profile_epoch(torch, make_train_step(pair, one, dataset), state,
                             sample_draws(g, pair, one, dataset))
        kernels = recurrence_kernels(prof["names"])
        if not kernels["bf16"] or kernels["other"]:
            fail(f"precision: {preset} ({route}) bf16 epoch ran recurrence kernels "
                 f"{kernels}: only __nv_bfloat16 instantiations belong there")
        cpu_pair = build_gan(mcfg, device="cpu")
        parity = epoch_parity(
            torch, lambda dev: make_train_step(pair if dev == "cuda" else cpu_pair, one,
                                               dataset.to(dev)),
            state, sample_draws(g, pair, one, dataset), bf16=True)
        busy = ("not measured" if not prof["device_busy_us"] else
                f"device busy {prof['device_busy_us']:.0f} of {prof['wall_us']:.0f} us "
                f"({100 * prof['busy_share']:.1f}%)")
        say(f"{tag} (a) {preset} W={w} {route} bf16: launches per epoch as the float32 "
            f"route's ({', '.join(f'{n} {c:g}' for n, c in per_epoch.items())}; weight sums "
            f"{sum(sums.values()) / TRAIN_EPOCHS:g}); {ms_epoch:.2f} ms/epoch (host clock, "
            f"float32 {f32[(preset, route)]['ms_per_epoch']:.2f} in this run); profiled "
            f"epoch {busy} (float32 {f32[(preset, route)]['profile']['device_busy_us']:.0f} "
            f"us); recurrence kernels {sorted(set(kernels['bf16']))}")
        say(f"{tag} (a) {preset} W={w} {route} bf16, card vs CPU plain path: d_loss "
            f"{parity['d_loss']:.7g} vs {parity['d_loss_cpu']:.7g} (rel "
            f"{parity['loss_rel_diff']['d_loss']:.2e}), g_loss {parity['g_loss']:.7g} vs "
            f"{parity['g_loss_cpu']:.7g} (rel {parity['loss_rel_diff']['g_loss']:.2e}; limit "
            f"{BF16_LOSS_RTOL:g}); params max scaled err {parity['param_scaled_err']:.3g} at "
            f"{parity['param_worst_at']} (limit {BF16_PARAM_BAR:g}); from zeroed slots, the "
            f"update's rel L2 err {parity['update_rel_l2']:.3g} at {parity['update_at']} "
            f"(limit {BF16_UPDATE_BAR:g}), slots' scaled err {parity['slot_scaled_err']:.3g} "
            f"at {parity['slot_at']} (limit {BF16_SLOT_BAR:g}); CPU epoch "
            f"{parity['cpu_epoch_s']:.1f} s")
        if not parity["ok"]:
            fail(f"precision: {preset} ({route}) bf16 epoch differs from the CPU's: {parity}")
        out["epochs"].append({"preset": preset, "route": route, "W": w, "launches": launches,
                              "weight_sum_launches": sums, "launches_per_epoch": per_epoch,
                              "ms_per_epoch": ms_epoch, "profile": prof,
                              "recurrence_kernels": sorted(set(kernels["bf16"])),
                              "parity": parity})

    # (b) train-gan --dtype bfloat16 at W=168: straight, and resumed
    preset = "mtss_wgan_gp_prod"
    per_epoch = f32[(preset, "auto")]["launches_per_epoch"]
    dirs = {n: os.path.join(keep, f"bf16_{n}") for n in ("straight", "resumed")}
    base = ["train-gan", "--preset", preset, "--dtype", "bfloat16", "--cleaned-dir",
            cleaned, "--quiet", "--n-samples", "10"]
    cuda_lstm.reset_launches()
    t0 = time.perf_counter()
    rc, text = run_cli(base + ["--epochs", str(PRECISION_CLI_EPOCHS), "--checkpoint-dir",
                               dirs["straight"], "--samples-out",
                               os.path.join(dirs["straight"], "s.npy")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = cuda_lstm.launch_counts()
    cli_sums = sum_launches_by_shape(cuda_lstm)
    want = {n: round(c * PRECISION_CLI_EPOCHS) + (2 if n == "lstm_fwd" else 0)
            for n, c in per_epoch.items()}
    if rc != 0 or f"trained mtss_wgan_gp for {PRECISION_CLI_EPOCHS} epochs (" not in text:
        fail(f"precision: train-gan --dtype bfloat16 exited {rc}: {text[-1000:]}")
    if {n: c for n, c in cli_launches.items() if c} != want:
        fail(f"precision: train-gan --dtype bfloat16 launched {cli_launches}, expected {want} "
             f"(the float32 route's per-epoch counts, and 2 lstm_fwd for the samples)")
    rc2, _ = run_cli(base + ["--epochs", str(PRECISION_RESUME_AT), "--checkpoint-dir",
                             dirs["resumed"]])
    rc3, text3 = run_cli(base + ["--resume", "--epochs", str(PRECISION_CLI_EPOCHS),
                                 "--checkpoint-dir", dirs["resumed"], "--samples-out",
                                 os.path.join(dirs["resumed"], "s.npy")])
    if rc2 or rc3 or f"resumed from {dirs['resumed']}/ckpt_{PRECISION_RESUME_AT}" not in text3:
        fail(f"precision: the bf16 resume exited {rc2}, {rc3}: {text3[-1000:]}")
    trees = {n: ckpt.restore(os.path.join(d, f"ckpt_{PRECISION_CLI_EPOCHS}"))
             for n, d in dirs.items()}
    leaves = {n: float_leaves(t) for n, t in trees.items()}
    dtypes = sorted({str(t.dtype) for t in leaves["straight"]})
    finite = all(bool(torch.isfinite(t).all()) for t in leaves["straight"])
    n_diff = sum(not torch.equal(a, b) for a, b in zip(leaves["straight"], leaves["resumed"]))
    cubes = [np.load(os.path.join(d, "s.npy")) for d in dirs.values()]
    # the verb's trainer in this process: its history, and the same state
    tr, _ = _make_trainer(preset, cleaned, quiet=True, device="cuda", dtype="bfloat16")
    tr.train(PRECISION_CLI_EPOCHS)
    hist_finite = all(np.isfinite(h["d_loss"]) and np.isfinite(h["g_loss"]) for h in tr.history)
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in
               zip(leaves["straight"], float_leaves(tr._ckpt_tree())))
    say(f"{tag} (b) train-gan --dtype bfloat16 at {preset}, {PRECISION_CLI_EPOCHS} epochs: "
        f"exit 0 in {cli_s:.1f} s, launches {', '.join(f'{n} {c}' for n, c in want.items())} "
        f"(the float32 route's per epoch, + 2 lstm_fwd for 10 samples), weight sums "
        f"{sum(cli_sums.values())}; checkpoint floating leaves {len(leaves['straight'])}, "
        f"dtypes {dtypes}, finite {finite}; resumed from ckpt_{PRECISION_RESUME_AT}: "
        f"{len(leaves['straight']) - n_diff} of {len(leaves['straight'])} leaves bit-equal, "
        f"samples equal {bool(np.array_equal(*cubes))}; the verb's trainer in process: "
        f"history of {len(tr.history)} epochs finite {hist_finite}, state equal {same}")
    if (dtypes != ["torch.float32"] or not finite or n_diff or not np.array_equal(*cubes)
            or not hist_finite or not same or len(tr.history) != PRECISION_CLI_EPOCHS):
        fail("precision: train-gan --dtype bfloat16's checkpoint, resume or history failed")
    out["train_gan"] = {"wall_s": cli_s, "launches": cli_launches,
                        "weight_sum_launches": cli_sums, "dtypes": dtypes,
                        "leaves": len(leaves["straight"]), "resume_bit_equal": True,
                        "d_loss": [h["d_loss"] for h in tr.history]}

    # (c) the bf16 sweep verb, real only, and the lane sweep card against CPU
    dest = os.path.join(keep, "sweep_bf16")
    cuda_lstm.reset_launches()
    t0 = time.perf_counter()
    rc, text = run_cli(["sweep", "--dtype", "bfloat16", "--cleaned-dir", cleaned, "--latents",
                        "1:21", "--epochs", str(PRECISION_SWEEP_EPOCHS), "--out", dest])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    if rc != 0 or any(cuda_lstm.launch_counts().values()):
        fail(f"precision: sweep --dtype bfloat16 exited {rc}, launched "
             f"{cuda_lstm.launch_counts()}")
    checked = sweep_outputs(np, dest, False)
    best = checked["summary"]["best_oos_r2"]
    panel = load_panel(cleaned, device="cpu")
    x_train = panel.train_test_split()[0]
    xs = scaler.fit_transform(x_train)[1]
    lanes = (len(SWEEP_LATENTS),)
    cfg = AEConfig(epochs=PRECISION_SWEEP_EPOCHS, chunk_epochs=SWEEP_CMP_CHUNK,
                   dtype="bfloat16")
    g = torch.Generator()
    g.manual_seed(SWEEP_SEED)
    init = engine.keras_init_params(g, lanes, xs.shape[1], max(SWEEP_LATENTS), "cpu")
    perms = engine.PermStream(SWEEP_SEED, lanes, int(xs.shape[0] * 0.75),
                              torch.device("cpu"))
    runs, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        runs[dev], _ = engine.sweep_autoencoders_chunked(
            0, xs, cfg, SWEEP_LATENTS, init_params=init, device=dev,
            perm_source=lambda pos, n, dev=dev: perms(pos, n).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    cpu, gpu = runs["cpu"], runs["cuda"]
    first = int(min(cpu.stop_epoch.min(), gpu.stop_epoch.cpu().min()))
    err = 0.0
    for k in ("train_loss", "val_loss"):
        got, ref = getattr(gpu, k).cpu()[:, :first], getattr(cpu, k)[:, :first]
        err = max(err, float(((got - ref).abs() / (BF16_AE_ATOL + BF16_AE_RTOL * ref.abs()))
                             .max()) if first else 0.0)
    say(f"{tag} (c) sweep --dtype bfloat16, real only, 21 latents x "
        f"{PRECISION_SWEEP_EPOCHS} epochs: exit 0 in {sweep_s:.1f} s, every file finite, no "
        f"kernel launched; best OOS R2 latent {best['latent']} mean {best['mean']:.4f}; stop "
        f"epochs "
        f"{checked['stop_epochs']}")
    say(f"{tag} (c) the bf16 lane sweep, card against CPU from the same draws, over the "
        f"{first} epochs before any lane stops: losses max |card - CPU| / ({BF16_AE_ATOL:g} "
        f"+ {BF16_AE_RTOL:g} |CPU|) {err:.3g} (<= 1 passes); stop epochs card "
        f"{gpu.stop_epoch.tolist()}, CPU {cpu.stop_epoch.tolist()}; card {secs['cuda']:.2f} s, "
        f"CPU {secs['cpu']:.2f} s")
    if first < 1 or err > 1.0:
        fail(f"precision: the bf16 lane sweep on the card differs from the CPU's ({err} over "
             f"{first} epochs)")
    out["sweep"] = {"wall_s": sweep_s, "epochs": PRECISION_SWEEP_EPOCHS, "best_oos_r2": best,
                    "stop_epochs": checked["stop_epochs"], "compared_epochs": first,
                    "loss_allclose_ratio": err, "card_s": secs["cuda"], "cpu_s": secs["cpu"],
                    "card_stop_epochs": gpu.stop_epoch.tolist(),
                    "cpu_stop_epochs": cpu.stop_epoch.tolist()}
    out["wall_s"] = time.perf_counter() - t_phase
    out["reduced_precision_reduction_after"] = (
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    say(f"{tag} phase wall {out['wall_s']:.1f} s; cuBLAS bf16 reduced-precision reduction "
        f"allowed after the bf16 runs: {out['reduced_precision_reduction_after']}")
    if out["reduced_precision_reduction_after"]:
        fail("precision: cuBLAS's reduced-precision bf16 reduction is on after the bf16 runs")
    return out


#: the trainer phase: the committed panel, (a) mtss_wgan_gp for 12 epochs at
#: 5 a block (two blocks, checkpoints after 5 and 10, two remainder epochs),
#: (b) the train-gan verb at mtss_wgan_gp_prod, then serve --gan-checkpoint
CLEANED_DIR = "results/rederived_cleaned"
TRAINER_EPOCHS, TRAINER_SPC, TRAINER_RESUME_AT = 12, 5, 5
BARE_EPOCHS = 15            # three blocks: a warm one, then two pipelined
CLI_EPOCHS, CLI_REQUESTS = 5, 32


def state_tensors(tr) -> list:
    """Every tensor of a trainer's state: params, then optimizer slots."""
    out = [t for m in (tr.state.generator, tr.state.discriminator)
           for t in m.state_dict().values()]
    for slots in (tr.state.g_opt, tr.state.d_opt):
        for k in sorted(slots):
            if isinstance(slots[k], dict):
                out += [slots[k][n] for n in sorted(slots[k])]
    return out


def run_cli(argv) -> tuple:
    """``hfrep_tpu_torch.experiments.cli.main(argv)`` in this process, its
    standard output captured and echoed."""
    import contextlib
    import io

    from hfrep_tpu_torch.experiments.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def phase_trainer(torch, np, cuda_lstm, train, keep: str) -> dict:
    """The port's training loop on the committed panel (``GanTrainer``
    through ``load_panel`` and ``build_gan_dataset``), its resume, its
    checkpoint fall-back and ``generate_block``; then the ``train-gan``
    and ``serve --gan-checkpoint`` verbs, ``train-gan`` writing its
    checkpoint under ``keep`` for the sweep phase."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.train.trainer import GanTrainer

    tag = "[trainer]"
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    per_epoch = next(r for r in train if r["preset"] == "mtss_wgan_gp")["launches_per_epoch"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) mtss_wgan_gp at (48, 35) on the fused route
        base = get_preset("mtss_wgan_gp")
        ck = os.path.join(tmp, "ck")
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, steps_per_call=TRAINER_SPC, checkpoint_every=TRAINER_SPC,
            checkpoint_dir=ck))
        t0 = time.perf_counter()
        panel = load_panel(cleaned, device="cuda")
        ds = build_gan_dataset(cfg.data, cfg.data.seed, panel)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if tuple(ds.windows.shape) != (cfg.data.n_sample, 48, 35) or ds.windows.device.type != "cuda":
            fail(f"trainer: dataset {tuple(ds.windows.shape)} on {ds.windows.device}")
        tr = GanTrainer(cfg, ds, device="cuda")
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        tr.train(TRAINER_EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_lstm.launch_counts()
        by_key = cuda_lstm.weight_sum_launches()
        sum_launches = {name: by_key[(nsum, npair, m == 1)] for name, nsum, npair, m in SUM_SHAPES}
        epochs = [h["epoch"] for h in tr.history]
        if epochs != list(range(TRAINER_EPOCHS)) or not all(
                np.isfinite(h["d_loss"]) and np.isfinite(h["g_loss"]) for h in tr.history):
            fail(f"trainer: history epochs {epochs}, losses {tr.history}")
        launched = {n for n, c in launches.items() if c > 0}
        want = {n: round(per_epoch[n] * TRAINER_EPOCHS) for n in ROUTE_KERNELS["auto"]}
        if launched != ROUTE_KERNELS["auto"] or any(launches[n] != c for n, c in want.items()):
            fail(f"trainer: the epochs launched {launches}, expected {want} "
                 f"(the train phase's per-epoch counts times {TRAINER_EPOCHS})")
        by_shape = {k: sum(launches[n] for n in names) for k, names in SUM_LAUNCHES.items()}
        if (sum_launches != by_shape
                or sum(by_key.values()) != SUM_LAUNCHES_PER_EPOCH * TRAINER_EPOCHS):
            fail(f"trainer: weight-sum launches {sum_launches} (of {sum(by_key.values())}), "
                 f"expected {by_shape}, {SUM_LAUNCHES_PER_EPOCH} an epoch")
        sps = tr.steps_per_sec
        samples = [{"steps": n, "s": s, "warmup": w} for n, s, w in tr.timer.samples]
        train_ms = next(r for r in train if r["preset"] == "mtss_wgan_gp")["ms_per_epoch"]
        say(f"{tag} mtss_wgan_gp W=48 on the committed panel ({panel.n_months} months, "
            f"load and dataset {load_s:.3f} s): {TRAINER_EPOCHS} epochs at {TRAINER_SPC} a "
            f"block in {wall:.2f} s; d_loss {[round(h['d_loss'], 5) for h in tr.history]}; "
            f"launches per epoch as the train phase's: " + ", ".join(
                f"{n} {launches[n] / TRAINER_EPOCHS:g}" for n in sorted(want))
            + f"; weight sums {sum(by_key.values()) / TRAINER_EPOCHS:g}")
        say(f"{tag} steps_per_sec {sps:.3f} ({1e3 / sps:.2f} ms/epoch, host clock, "
            f"steady windows synchronised) against the train phase's {train_ms:.2f} ms/epoch "
            f"in this run; timer samples {[(s['steps'], round(s['s'], 4), s['warmup']) for s in samples]}")
        # the loop alone: the same schedule's blocks with no checkpoint
        # to write (the staged write runs on the host, in the steady window)
        bare = GanTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=None)), ds, device="cuda")
        bare.train(BARE_EPOCHS)
        bare_sps = bare.steps_per_sec
        say(f"{tag} the loop without checkpoints, {BARE_EPOCHS} epochs at {TRAINER_SPC} a "
            f"block: steps_per_sec {bare_sps:.3f} ({1e3 / bare_sps:.2f} ms/epoch); timer "
            f"samples {[(n, round(t, 4), w) for n, t, w in bare.timer.samples]}")
        # checkpoint save and restore, timed apart from the loop
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = tr.save_checkpoint(os.path.join(tmp, "timed", f"ckpt_{tr.epoch}"))
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(timed, f)) for f in os.listdir(timed))
        probe = GanTrainer(cfg, ds, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.restore_checkpoint(timed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(state_tensors(tr), state_tensors(probe))):
            fail("trainer: a restored checkpoint differs from the state saved")
        # resume from ckpt_5: bit for bit the straight run's
        resumed = GanTrainer(cfg, ds, device="cuda")
        at = resumed.restore_checkpoint(os.path.join(ck, f"ckpt_{TRAINER_RESUME_AT}"))
        resumed.train(TRAINER_EPOCHS - TRAINER_RESUME_AT)
        torch.cuda.synchronize()
        pairs = list(zip(state_tensors(tr), state_tensors(resumed)))
        n_diff = sum(not torch.equal(a, b) for a, b in pairs)
        hist_equal = resumed.history == tr.history[TRAINER_RESUME_AT:]
        gen_equal = torch.equal(resumed.gen.get_state(), tr.gen.get_state())
        say(f"{tag} resumed from {os.path.basename(at)} to epoch {resumed.epoch}: "
            f"{len(pairs) - n_diff} of {len(pairs)} state tensors bit-equal to the straight run, "
            f"history from epoch {TRAINER_RESUME_AT} equal {hist_equal}, draw stream equal "
            f"{gen_equal}; checkpoint ({ckpt_bytes} bytes) save {save_s * 1e3:.1f} ms, restore "
            f"{restore_s * 1e3:.1f} ms")
        if n_diff or not hist_equal or not gen_equal or resumed.epoch != TRAINER_EPOCHS:
            fail(f"trainer: the resumed run differs from the straight run ({n_diff} tensors, "
                 f"history equal {hist_equal}, draw stream equal {gen_equal})")
        # a torn newest checkpoint: the walk falls back to the previous good one
        newest = os.path.join(ck, f"ckpt_{TRAINER_EPOCHS - TRAINER_EPOCHS % TRAINER_SPC}",
                              "checkpoint.pt")
        os.truncate(newest, os.path.getsize(newest) // 2)
        fallback = GanTrainer(cfg, ds, device="cuda")
        got = fallback.restore_checkpoint()
        say(f"{tag} newest checkpoint truncated: restore_checkpoint() fell back to "
            f"{os.path.basename(got)} (epoch {fallback.epoch})")
        if os.path.basename(got) != f"ckpt_{TRAINER_RESUME_AT}" or fallback.epoch != TRAINER_RESUME_AT:
            fail(f"trainer: the fall-back restored {got!r}, not ckpt_{TRAINER_RESUME_AT}")
        # generate_block: pure in (stream_seed, seq)
        a = tr.generate_block(3, 64)
        b = tr.generate_block(3, 64)
        if a.shape != (64, 48, 35) or not torch.isfinite(a).all() or not torch.equal(a, b):
            fail(f"trainer: generate_block(3, 64) shape {tuple(a.shape)}, finite "
                 f"{bool(torch.isfinite(a).all())}, repeatable {bool(torch.equal(a, b))}")
        say(f"{tag} generate_block(seq=3, 64) twice: bit-equal, finite, shape {tuple(a.shape)}")
        out.update(preset="mtss_wgan_gp", W=48, F=35, epochs=TRAINER_EPOCHS,
                   steps_per_call=TRAINER_SPC, launches=launches,
                   weight_sum_launches=sum_launches, steps_per_sec=sps, ms_per_epoch=1e3 / sps,
                   train_phase_ms_per_epoch=train_ms, timer_samples=samples, wall_s=wall,
                   load_s=load_s, d_loss=[h["d_loss"] for h in tr.history],
                   g_loss=[h["g_loss"] for h in tr.history], checkpoint_save_ms=save_s * 1e3,
                   checkpoint_restore_ms=restore_s * 1e3, checkpoint_bytes=ckpt_bytes,
                   no_checkpoint_steps_per_sec=bare_sps,
                   no_checkpoint_timer_samples=[list(x) for x in bare.timer.samples])

        # (b) the train-gan verb at mtss_wgan_gp_prod (168, 36), then serve
        prod = os.path.join(keep, "prod")
        samples_out = os.path.join(tmp, "s.npy")
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        cli_obs = os.path.join(keep, "prod_obs")
        rc, text = run_cli(["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs",
                            str(CLI_EPOCHS), "--cleaned-dir", cleaned, "--checkpoint-dir", prod,
                            "--samples-out", samples_out, "--obs-dir", cli_obs])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        out["cli_launches"] = cuda_lstm.launch_counts()
        by_key = cuda_lstm.weight_sum_launches()
        out["cli_weight_sum_launches"] = {name: by_key[(nsum, npair, m == 1)]
                                          for name, nsum, npair, m in SUM_SHAPES}
        for line in text.splitlines():
            say(f"{tag} train-gan: {line}")
        ckpt_path = os.path.join(prod, f"ckpt_{CLI_EPOCHS}")
        cube = np.load(samples_out) if os.path.exists(samples_out) else None
        if (rc != 0 or f"trained mtss_wgan_gp for {CLI_EPOCHS} epochs (" not in text
                or not os.path.isdir(ckpt_path) or cube is None
                or cube.shape != (10, 168, 36) or not np.isfinite(cube).all()):
            fail(f"trainer: train-gan rc {rc}, checkpoint {os.path.isdir(ckpt_path)}, "
                 f"samples {None if cube is None else cube.shape}")
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        rc, text = run_cli(["serve", "--preset", "mtss_wgan_gp_prod", "--cleaned-dir", cleaned,
                            "--gan-checkpoint", ckpt_path, "--requests", str(CLI_REQUESTS),
                            "--sample-every", "2", "--timeout-ms", "30000"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        out["serve_launches"] = cuda_lstm.launch_counts()
        report = json.loads(text)["report"] if rc == 0 else {}
        say(f"{tag} serve --gan-checkpoint {os.path.basename(ckpt_path)}: rc {rc}; submitted "
            f"{report.get('submitted')}, terminal {report.get('terminal')}, results "
            f"{report.get('results')}; p50 {report.get('p50_ms')} ms; lstm_fwd launches "
            f"{out['serve_launches']['lstm_fwd']}; train-gan {cli_s:.1f} s, serve {serve_s:.1f} s")
        if (rc != 0 or not report["submitted"] == report["terminal"] == report["results"]
                == CLI_REQUESTS or out["serve_launches"]["lstm_fwd"] < 1):
            fail(f"trainer: serve --gan-checkpoint rc {rc}, report {report}")
        out.update(cli_s=cli_s, serve_s=serve_s, cli_checkpoint=ckpt_path, cli_obs_dir=cli_obs,
                   serve={k: report[k] for k in ("submitted", "terminal", "results",
                                                 "p50_ms", "p95_ms", "qps")})
    return out


#: the sweep phase: the committed panel's 21 latent lanes; (a) at a cut
#: depth against the CPU from the same draws, (b) the verb at full depth
SWEEP_LATENTS = list(range(1, 22))
SWEEP_CMP_EPOCHS, SWEEP_CMP_CHUNK, SWEEP_SEED = 40, 10, 11
SWEEP_PROFILE_EPOCHS = 10
SWEEP_SECOND_CKPT_EPOCHS = 2
SWEEP_TIMEOUT_S = 600
ENVELOPE = "results/seed_envelope_rederived/envelope.json"
#: the same 24 seeds of the JAX package run on the CPU
#: (``tools/seed_envelope.py --seeds 24 --cleaned-dir results/rederived_cleaned``):
#: the platform moves the envelope, so the sweep is held to both
CPU_ENVELOPE = "results/seed_envelope_rederived_cpu/envelope.json"
COMMITTED_SWEEP = "results/sweep_real_rederived/summary.json"
ENVELOPE_MARGIN = 0.05
PINV_OUTPUTS = ("ante", "post", "turnover", "sharpe_ante", "sharpe_post")
FIT_RTOL, FIT_ATOL = 1e-4, 1e-6          # the fit metrics, card against CPU


def csv_numbers(path: str) -> list:
    """Every cell of a CSV written by the sweep (header and index column
    apart) as a float; an empty cell (a NaN) fails."""
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    try:
        return [float(c) for r in rows[1:] for c in r[1:]]
    except ValueError as e:
        fail(f"sweep: {path} has a cell that is not a number ({e})")


def sweep_outputs(np, out_dir: str, stats: bool) -> dict:
    """Check one dataset's sweep outputs: every file written, every number
    finite.  Returns its fit metrics' stop epochs and its summary."""
    import csv

    names = ["fit_metrics.csv", "sharpe_ante.csv", "sharpe_post.csv", "turnover.csv",
             "summary.json", "ante.npy", "post.npy", "train_loss.npy", "val_loss.npy"]
    if stats:
        names += [f"stats_{n}.csv" for n in ("replication", "replication_ante", "benchmark")]
    missing = [n for n in names if not os.path.isfile(os.path.join(out_dir, n))]
    if missing:
        fail(f"sweep: {out_dir} lacks {missing}")
    for n in names:
        path = os.path.join(out_dir, n)
        if n.endswith(".csv"):
            vals = csv_numbers(path)
        elif n.endswith(".npy"):
            vals = np.load(path)
            if n.endswith("loss.npy"):          # NaN after a lane's stop, by design
                vals = vals[:, :1]
        else:
            continue
        if not np.all(np.isfinite(vals)):
            fail(f"sweep: {path} has a number that is not finite")
    with open(os.path.join(out_dir, "fit_metrics.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(out_dir, "summary.json")) as fh:
        summary = json.load(fh)
    return {"stop_epochs": [int(r["stop_epoch"]) for r in rows], "summary": summary}


def profile_drive(torch, engine, cfg, xs) -> dict:
    """``torch.profiler`` over a short lane-sweep drive on the card (its
    warm-up step the same drive): the device's busy share of the window.
    The profiler's own host cost lengthens the window."""
    def drive():
        engine.sweep_autoencoders_chunked(1, xs, cfg, SWEEP_LATENTS, device="cuda")

    wall = []

    def run():
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e6)

    by_name = device_time_by_name(traced(torch, drive, run))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"rows": int(xs.shape[0]), "epochs": cfg.epochs, "wall_us": wall[0],
            "device_busy_us": busy, "busy_share": busy / wall[0] if busy else None,
            "top": [{"name": k[:80], "us": v} for k, v in top]}


def phase_sweep(torch, np, cuda_lstm, keep: str, gan_checkpoint: str) -> dict:
    """The replication engine and the ``sweep`` verb on the committed panel:
    (a) the chunked 21-lane sweep on the card against the CPU from the
    same draws, and its evaluation; (b) the verb at full width and depth,
    real only, from the trainer phase's checkpoint, and from two
    checkpoints (the padded multi path), each checked and timed."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.core import scaler
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.replication import engine

    tag = "[sweep]"
    root = os.path.dirname(os.path.abspath(__file__))
    cleaned = os.path.join(root, CLEANED_DIR)
    out = {}

    # (a) the card against the CPU, the same init and permutations
    panel = load_panel(cleaned, device="cpu")
    x_train, x_test, _, y_test = panel.train_test_split()
    xs = scaler.fit_transform(x_train)[1]
    n_train = int(xs.shape[0] * 0.75)
    cfg = AEConfig(epochs=SWEEP_CMP_EPOCHS, chunk_epochs=SWEEP_CMP_CHUNK)
    g = torch.Generator()
    g.manual_seed(SWEEP_SEED)
    lanes = (len(SWEEP_LATENTS),)
    init = engine.keras_init_params(g, lanes, xs.shape[1], max(SWEEP_LATENTS), "cpu")
    perms = engine.PermStream(SWEEP_SEED, lanes, n_train, torch.device("cpu"))
    runs, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        runs[dev] = engine.sweep_autoencoders_chunked(
            0, xs, cfg, SWEEP_LATENTS, init_params=init, device=dev,
            perm_source=lambda pos, n, dev=dev: perms(pos, n).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    (cpu, cstats), (gpu, gstats) = runs["cpu"], runs["cuda"]
    stop_equal = torch.equal(cpu.stop_epoch, gpu.stop_epoch.cpu())
    loss_err = max(float(torch.nan_to_num((getattr(gpu, k).cpu() - getattr(cpu, k)).abs()
                                          / getattr(cpu, k).abs(), 0.0).max())
                   for k in ("train_loss", "val_loss"))
    nan_equal = all(torch.equal(getattr(gpu, k).cpu().isnan(), getattr(cpu, k).isnan())
                    for k in ("train_loss", "val_loss"))
    param_excess = max(float(((gpu.params[k].cpu() - cpu.params[k]).abs()
                              - (1e-5 + 1e-4 * cpu.params[k].abs())).max())
                       for k in cpu.params)
    say(f"{tag} (a) {len(SWEEP_LATENTS)} lanes x {SWEEP_CMP_EPOCHS} epochs at "
        f"{SWEEP_CMP_CHUNK} a chunk, the same draws: card {secs['cuda']:.2f} s "
        f"({1e3 * secs['cuda'] / gstats.epochs_dispatched:.2f} ms/epoch, host clock), CPU "
        f"{secs['cpu']:.2f} s; losses max rel err {loss_err:.3g} (bar 1e-4), NaNs equal "
        f"{nan_equal}; params max excess over atol 1e-5 + rtol 1e-4 {param_excess:.3g} "
        f"(<= 0 passes); stop epochs equal {stop_equal} {gpu.stop_epoch.tolist()}")
    if not (stop_equal and nan_equal and loss_err <= 1e-4 and param_excess <= 0
            and cstats == gstats):
        fail(f"sweep: the card's lane sweep differs from the CPU's (losses {loss_err}, "
             f"params {param_excess}, stops {gpu.stop_epoch.tolist()} against "
             f"{cpu.stop_epoch.tolist()}, stats {gstats} against {cstats})")
    masks = torch.stack([engine.latent_mask(d, max(SWEEP_LATENTS), device="cpu")
                         for d in SWEEP_LATENTS])
    rf = panel.rf[x_train.shape[0]:]
    ecfg = AEConfig(latent_dim=max(SWEEP_LATENTS))
    evs, ev_s = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        evs[dev] = {k: v.cpu() for k, v in engine.sweep_evaluate(
            ecfg, xs.to(dev), x_test.to(dev), y_test.to(dev), rf.to(dev),
            panel.factors.to(dev), {k: v.to(dev) for k, v in cpu.params.items()},
            masks.to(dev)).items()}
        ev_s[dev] = time.perf_counter() - t0
    errs = {}
    for k, want in evs["cpu"].items():
        got = evs["cuda"][k]
        if not bool(torch.isfinite(got).all()):
            fail(f"sweep: the card's {k} is not finite")
        if k in PINV_OUTPUTS:
            errs[k] = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        else:
            # allclose's measure: a per-prefix R² near 0 has no relative precision
            errs[k] = float(((got - want).abs() / (FIT_ATOL + FIT_RTOL * want.abs())).max())
    fit_err = max(v for k, v in errs.items() if k not in PINV_OUTPUTS)
    pinv_err = max(errs[k] for k in PINV_OUTPUTS)
    say(f"{tag} (a) sweep_evaluate on the card against the CPU: fit metrics max "
        f"|card - CPU| / ({FIT_ATOL:g} + {FIT_RTOL:g} |CPU|) {fit_err:.3g} (<= 1 passes), the "
        f"pseudo-inverse's outputs max scaled err {pinv_err:.3g} (bar 1e-3); by output "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; card {ev_s['cuda']:.2f} s, CPU {ev_s['cpu']:.2f} s")
    if fit_err > 1.0 or pinv_err > 1e-3:
        fail(f"sweep: sweep_evaluate on the card differs from the CPU's (fit {fit_err}, "
             f"pseudo-inverse outputs {pinv_err})")
    out["card_vs_cpu"] = {
        "lanes": len(SWEEP_LATENTS), "epochs": SWEEP_CMP_EPOCHS, "chunk_epochs": SWEEP_CMP_CHUNK,
        "card_s": secs["cuda"], "cpu_s": secs["cpu"],
        "card_ms_per_epoch": 1e3 * secs["cuda"] / gstats.epochs_dispatched,
        "loss_max_rel_err": loss_err, "param_max_excess": param_excess,
        "stop_epochs": gpu.stop_epoch.tolist(), "fit_max_allclose_ratio": fit_err,
        "err_by_output": errs,
        "pinv_max_scaled_err": pinv_err, "eval_card_s": ev_s["cuda"], "eval_cpu_s": ev_s["cpu"]}

    # the device's busy share of a short drive, at the real and the augmented rows
    pcfg = AEConfig(epochs=SWEEP_PROFILE_EPOCHS, chunk_epochs=SWEEP_PROFILE_EPOCHS)
    synth = torch.rand((10 * 168, xs.shape[1]), generator=g)
    out["profile"] = []
    for rows in (xs, torch.cat([synth, xs])):
        prof = profile_drive(torch, engine, pcfg, rows.to("cuda"))
        out["profile"].append(prof)
        share = prof["busy_share"]
        say(f"{tag} profile: {prof['rows']} rows, {prof['epochs']} epochs of 21 lanes: "
            f"{prof['wall_us'] / 1e3:.1f} ms under the profiler, device busy "
            f"{prof['device_busy_us'] / 1e3:.2f} ms ("
            + (f"{100 * share:.1f}%" if share else "not measured") + "); top: "
            + ", ".join(f"{t['name'][:40]} {t['us']:.0f} us" for t in prof["top"][:3]))

    # (b) the verb at full width and depth, the three runs side by side as
    # subprocesses, each counting its launches into its own stream, once
    # this process has trained the multi run's second checkpoint
    second = os.path.join(keep, "prod_b", f"ckpt_{SWEEP_SECOND_CKPT_EPOCHS}")
    rc, text = run_cli(["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs",
                        str(SWEEP_SECOND_CKPT_EPOCHS), "--cleaned-dir", cleaned,
                        "--checkpoint-dir", os.path.join(keep, "prod_b"), "--quiet"])
    if rc != 0 or not os.path.isdir(second):
        fail(f"sweep: the second train-gan run failed (rc {rc})")
    plan = (("real", []), ("augmented", [gan_checkpoint]), ("multi", [gan_checkpoint, second]))
    procs = {}
    try:
        for name, ckpts in plan:
            argv = ["sweep", "--cleaned-dir", cleaned, "--latents", "1:21", "--out",
                    os.path.join(keep, f"sweep_{name}"), "--stats", "--preset",
                    "mtss_wgan_gp_prod", "--obs-dir", os.path.join(keep, f"sweep_{name}_obs")]
            for c in ckpts:
                argv += ["--gan-checkpoint", c]
            procs[name] = start_module("hfrep_tpu_torch", argv)
        done = {name: finish_module(procs[name], SWEEP_TIMEOUT_S) for name, _ in plan}
    finally:
        # a failed check exits: no run outlives the script
        for proc, _ in procs.values():
            if proc.poll() is None:
                kill_tree(proc)
                proc.communicate()
    with open(os.path.join(root, ENVELOPE)) as fh:
        envelope = json.load(fh)["envelope"]
    with open(os.path.join(root, COMMITTED_SWEEP)) as fh:
        committed = json.load(fh)
    lo = envelope["best_oos_mean"]["min"] - ENVELOPE_MARGIN
    hi = envelope["best_oos_mean"]["max"] + ENVELOPE_MARGIN
    with open(os.path.join(root, CPU_ENVELOPE)) as fh:
        cpu_envelope = json.load(fh)["envelope"]
    cpu_lo = cpu_envelope["best_oos_mean"]["min"] - ENVELOPE_MARGIN
    cpu_hi = cpu_envelope["best_oos_mean"]["max"] + ENVELOPE_MARGIN
    runs_b = {}
    for name, ckpts in plan:
        dest = os.path.join(keep, f"sweep_{name}")
        rc, text, err, wall = done[name]
        if rc != 0:
            fail(f"sweep: the {name} run exited {rc}: {err[-2000:]}")
        launches = stream_launches(stream_records(dest + "_obs"))
        launches["lstm_fwd"] = launches.get("lstm_fwd", 0)
        with open(os.path.join(dest, "chunk_stats.json")) as fh:
            cs = json.load(fh)
        sets = (["real"] + [d for d in sorted(os.listdir(dest)) if d.startswith("gen_")]
                if len(ckpts) > 1 else [None])
        checked = {s: sweep_outputs(np, dest if s is None else os.path.join(dest, s), True)
                   for s in sets}
        max_stop = max(e for c in checked.values() for e in c["stop_epochs"])
        others = {k: v for k, v in launches.items()
                  if k != "lstm_fwd" and not k.startswith("weight_sum") and v}
        row = {"checkpoints": len(ckpts), "wall_s": wall, "chunk_stats": cs,
               "max_stop_epoch": max_stop, "lstm_fwd_launches": launches["lstm_fwd"],
               "ms_per_dispatched_epoch": 1e3 * wall / cs["epochs_dispatched"],
               "summaries": {str(s): c["summary"]["best_oos_r2"] for s, c in checked.items()},
               "stop_epochs": {str(s): c["stop_epochs"] for s, c in checked.items()}}
        runs_b[name] = row
        say(f"{tag} (b) sweep {name} ({len(ckpts)} checkpoint(s)): {wall:.1f} s, "
            f"{cs['epochs_dispatched']} epochs in {cs['chunks_dispatched']} chunks "
            f"({row['ms_per_dispatched_epoch']:.2f} ms an epoch of the verb's wall), "
            f"{cs['lanes']} lanes, {cs['lanes_stopped']} stopped, overshoot "
            f"{cs['overshoot_chunks']}, largest stop epoch {max_stop}; lstm_fwd launches "
            f"{launches['lstm_fwd']}; best OOS R2 " + ", ".join(
                f"{s}: latent {v['latent']} mean {v['mean']:.4f}"
                for s, v in row["summaries"].items()))
        if (cs["epochs_dispatched"] < max_stop or cs["overshoot_chunks"] > 1
                or cs["epochs_total"] != 1000):
            fail(f"sweep: {name}'s chunk stats {cs} against the largest stop epoch {max_stop}")
        if launches["lstm_fwd"] != 2 * len(ckpts) or others:
            fail(f"sweep: {name} launched lstm_fwd {launches['lstm_fwd']} times (expected "
                 f"{2 * len(ckpts)}) and {others}")
    best = runs_b["real"]["summaries"]["None"]
    say(f"{tag} real only: best OOS R2 mean {best['mean']:.4f} at latent {best['latent']}; "
        f"the JAX package's 24 seeds {envelope['best_oos_mean']['min']:.4f}.."
        f"{envelope['best_oos_mean']['max']:.4f} (gate {lo:.4f}..{hi:.4f}), best latents "
        f"{envelope['best_oos_latent_counts']}; the committed sweep's latent "
        f"{committed['best_oos_r2']['latent']} mean {committed['best_oos_r2']['mean']:.4f}; "
        f"the same 24 seeds on the CPU {cpu_envelope['best_oos_mean']['min']:.4f}.."
        f"{cpu_envelope['best_oos_mean']['max']:.4f} (gate {cpu_lo:.4f}..{cpu_hi:.4f})")
    if not lo <= best["mean"] <= hi:
        fail(f"sweep: the real-only best OOS R2 mean {best['mean']} is outside {lo}..{hi}")
    if not cpu_lo <= best["mean"] <= cpu_hi:
        fail(f"sweep: the real-only best OOS R2 mean {best['mean']} is outside the CPU "
             f"envelope's {cpu_lo}..{cpu_hi}")
    out["runs"] = runs_b
    out["envelope_gate"] = [lo, hi]
    out["cpu_envelope_gate"] = [cpu_lo, cpu_hi]
    out["sweep_gan_checkpoint_launches"] = (runs_b["augmented"]["lstm_fwd_launches"]
                                            + runs_b["multi"]["lstm_fwd_launches"])
    return out


def sum_launches_by_shape(cuda_lstm) -> dict:
    """The weight sums' launches since the last reset, by launch shape."""
    by_key = cuda_lstm.weight_sum_launches()
    return {name: by_key[(nsum, npair, m == 1)] for name, nsum, npair, m in SUM_SHAPES}


def check_route_launches(what: str, launches: dict, sums: dict, per_epoch: dict,
                         epochs: int, extra_fwd: int = 0) -> None:
    """Fail unless exactly ``per_epoch`` times ``epochs`` launched (plus
    ``extra_fwd`` lstm_fwd sampling launches) and the weight sums as often
    as those kernels launch them."""
    want = {k: c * epochs for k, c in per_epoch.items()}
    want["lstm_fwd"] = want.get("lstm_fwd", 0) + extra_fwd
    got = {k: c for k, c in launches.items() if c}
    if got != {k: c for k, c in want.items() if c}:
        fail(f"{what}: launched {got}, expected exactly {want}")
    by_shape = {k: sum(launches[n] for n in names) for k, names in SUM_LAUNCHES.items()}
    if sums != by_shape:
        fail(f"{what}: weight-sum launches {sums}, expected {by_shape} from the kernels' "
             "launches")


#: the eval phase: 500 fakes against the first 500 real windows, as
#: train-gan --eval scores them; train-gan --eval for 2 epochs
EVAL_N, EVAL_CLI_EPOCHS = 500, 2


def metric_check(np, name: str, got: float, want: float, real, fake) -> float:
    """|card - CPU| over the CPU tests' bar for metric ``name``
    (``tests/test_torch_metrics.py``); <= 1 passes.  FID: 1e-5 scaled by
    max(1, tr S1 + tr S2); the MMDs: 1e-5 scaled by max(1, the kernel
    means' magnitudes); R2_relative_error: 1e-3 scaled by max(1, |CPU|);
    kl_div, js_div: rtol 1e-5, atol 1e-7; Inception_score through its log
    at that bar (two infinities agree); the rest rtol 1e-6, atol 1e-7."""
    import math

    if name == "Inception_score":
        if math.isinf(got) and math.isinf(want):
            return 0.0
        got, want = math.log(got), math.log(want)
    d = abs(got - want)
    r = real.reshape(-1, real.shape[-1]).astype(np.float64)
    f = fake.reshape(-1, fake.shape[-1]).astype(np.float64)
    if name == "FID":
        scale = max(1.0, np.trace(np.cov(r, rowvar=False)) + np.trace(np.cov(f, rowvar=False)))
        return d / (1e-5 * scale)
    if name.endswith("MMD"):
        a, b = real.mean(axis=0).astype(np.float64), fake.mean(axis=0).astype(np.float64)

        def k(x, y):
            if name == "linear_MMD":
                return x @ y.T
            if name == "poly_MMD":
                return (x @ y.T) ** 2
            sq = (x * x).sum(1)[:, None] + (y * y).sum(1)[None] - 2 * x @ y.T
            return np.exp(-np.maximum(sq, 0))

        scale = max(1.0, abs(k(a, a).mean()) + abs(k(b, b).mean()) + 2 * abs(k(a, b).mean()))
        return d / (1e-5 * scale)
    if name == "R2_relative_error":
        return d / (1e-3 * max(1.0, abs(want)))
    if name in ("kl_div", "js_div", "Inception_score"):
        return d / (1e-7 + 1e-5 * abs(want))
    return d / (1e-7 + 1e-6 * abs(want))


def phase_eval(torch, np, cuda_lstm, train, keep: str, gan_checkpoint: str) -> dict:
    """The metrics on the card: (a) ``train-gan --eval`` at mtss_wgan_gp for
    2 epochs with a checkpoint and 500 samples, its launches gated
    exactly, then ``eval-gan`` on those samples: exit 0 and 12 finite
    metrics in ``--out``; (b) GanEval on the card and on the CPU over the
    same cubes — the first 500 real windows of the committed panel at
    both presets against 500 fakes of the (a) checkpoint and of the
    trainer phase's ``train-gan`` checkpoint — held at the CPU tests'
    bars (:func:`metric_check`)."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.metrics import gan_eval
    from hfrep_tpu_torch.metrics.gan_eval import GanEval
    from hfrep_tpu_torch.train.trainer import GanTrainer

    tag = "[eval]"
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    per_epoch = next(r for r in train if r["preset"] == "mtss_wgan_gp")["launches_per_epoch"]
    out = {}
    # (a) train-gan --eval, then eval-gan on its samples
    ck = os.path.join(keep, "eval48")
    cube_path = os.path.join(keep, "eval_cube.npy")
    cuda_lstm.reset_launches()
    t0 = time.perf_counter()
    rc, text = run_cli(["train-gan", "--preset", "mtss_wgan_gp", "--epochs",
                        str(EVAL_CLI_EPOCHS), "--cleaned-dir", cleaned, "--checkpoint-dir", ck,
                        "--samples-out", cube_path, "--n-samples", str(EVAL_N), "--quiet",
                        "--eval"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches, sums = cuda_lstm.launch_counts(), sum_launches_by_shape(cuda_lstm)
    doc = json.loads(text[text.index("{"):]) if rc == 0 and "{" in text else {}
    say(f"{tag} train-gan --eval, mtss_wgan_gp, {EVAL_CLI_EPOCHS} epochs: rc {rc}, {cli_s:.1f} s; "
        f"metrics {doc}")
    if rc != 0 or len(doc) != 12 or not all(np.isfinite(v) for v in doc.values()):
        fail(f"eval: train-gan --eval rc {rc}, metrics {doc}")
    # the epochs, then 2 lstm_fwd for the samples and 2 for the eval's 500
    check_route_launches("eval: train-gan --eval", launches, sums, per_epoch,
                         EVAL_CLI_EPOCHS, extra_fwd=4)
    out.update(cli_eval_metrics=doc, cli_eval_s=cli_s, launches=launches,
               weight_sum_launches=sums)
    eval_out = os.path.join(keep, "eval.json")
    t0 = time.perf_counter()
    rc, text = run_cli(["eval-gan", "--samples", cube_path, "--preset", "mtss_wgan_gp",
                        "--cleaned-dir", cleaned, "--out", eval_out])
    eval_s = time.perf_counter() - t0
    got = {}
    if rc == 0 and os.path.isfile(eval_out):
        with open(eval_out) as fh:
            got = json.load(fh)
    say(f"{tag} eval-gan on the {EVAL_N}-window cube: rc {rc}, {eval_s:.1f} s; --out {got}")
    if rc != 0 or len(got) != 12 or not all(np.isfinite(v) for v in got.values()):
        fail(f"eval: eval-gan rc {rc}, metrics {got}")
    out.update(eval_gan_metrics=got, eval_gan_s=eval_s)

    # (b) GanEval on the card against the CPU over the same cubes
    out["card_vs_cpu"] = []
    covs = {}
    panel = load_panel(cleaned, device="cuda")
    for preset, ckpt_path in (("mtss_wgan_gp", os.path.join(ck, f"ckpt_{EVAL_CLI_EPOCHS}")),
                              ("mtss_wgan_gp_prod", gan_checkpoint)):
        cfg = get_preset(preset)
        ds = build_gan_dataset(cfg.data, cfg.data.seed, panel)
        tr = GanTrainer(cfg, ds, device="cuda")
        tr.restore_checkpoint(ckpt_path)
        g = torch.Generator(device="cuda")
        g.manual_seed(11)
        cuda_lstm.reset_launches()
        fake = tr.generate(EVAL_N, generator=g, unscale=False)
        torch.cuda.synchronize()
        fake_launches = cuda_lstm.launch_counts()
        for k, c in fake_launches.items():
            launches[k] += c
        real = ds.windows[:EVAL_N]
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        card = GanEval(real, fake, ds.windows).run_all()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        eval_launches = {k: c for k, c in cuda_lstm.launch_counts().items() if c}
        t0 = time.perf_counter()
        cpu = GanEval(real.cpu(), fake.cpu(), ds.windows.cpu()).run_all()
        cpu_s = time.perf_counter() - t0
        rn, fn = real.cpu().numpy(), fake.cpu().numpy()
        ratios = {k: metric_check(np, k, card[k], cpu[k], rn, fn) for k in cpu}
        worst = max(ratios, key=ratios.get)
        say(f"{tag} {preset} W={cfg.model.window}: GanEval of {EVAL_N} fakes "
            f"({os.path.basename(ckpt_path)}) on the card {card_s:.2f} s, CPU {cpu_s:.2f} s; "
            f"card vs CPU |diff| / bar, <= 1 passes: "
            + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
            + f"; card {card}")
        if (fake_launches["lstm_fwd"] != 2 or sum(fake_launches.values()) != 2
                or eval_launches):
            fail(f"eval: {preset}: the fakes launched {fake_launches} (2 lstm_fwd), "
                 f"GanEval {eval_launches} (none)")
        if ratios[worst] > 1.0 or list(card) != list(cpu):
            fail(f"eval: {preset}: GanEval on the card differs from the CPU's at {worst} "
                 f"({card[worst]} against {cpu[worst]}, {ratios[worst]:.3g} of its bar)")
        # the covariances GanEval's FID builds (``gan_eval.fid``), for the
        # analysis phase's sqrtm_product_trace
        covs[preset] = tuple(gan_eval._cov(gan_eval._flatten_rows(c)) for c in (real, fake))
        out["card_vs_cpu"].append({"preset": preset, "W": cfg.model.window,
                                   "checkpoint": os.path.basename(ckpt_path), "card": card,
                                   "cpu": cpu, "ratio_to_bar": ratios, "card_s": card_s,
                                   "cpu_s": cpu_s})
    out["launches"] = launches
    return out, covs


#: the scenario phase: the conditional mtss_wgan_gp epoch (W=24, the
#: panel's 22 factors + 3 regimes, n_critic 1, B=32) on each critic route.
#: Per epoch: the unconditional epoch's counts (2/2/2/11/16/5 fused,
#: 2/24/34/10 chained: the fake pass, 5 critic iterations, the generator
#: update) less 4 critic iterations (fused stack_fwd_res 2, stack_bwd 3,
#: stack_adj 1 each; chained lstm_fwd_cs 4, lstm_bwd 6, lstm_adj 2 each);
#: the weight sums 2 + 4 + 1 + 5 fused, 10 + 2 chained
COND_ROUTE_LAUNCHES = {
    "auto": {"lstm_fwd": 2, "lstm_fwd_cs": 2, "lstm_bwd": 2, "stack_fwd_res": 3,
             "stack_bwd": 4, "stack_adj": 1},
    "chained": {"lstm_fwd": 2, "lstm_fwd_cs": 8, "lstm_bwd": 10, "lstm_adj": 2},
}
COND_SUM_LAUNCHES_PER_EPOCH = 12
COND_W, COND_REGIMES, COND_EPOCHS = 24, 3, 3
BANK_EPOCHS, BANK_BLOCKS, BANK_BLOCK_SIZE = 30, 4, 16
#: the walk-forward and universe verbs at their defaults (start 120, 24
#: windows, horizon 36, latents 1:8: 192 lanes, the AE's 1000-epoch cap);
#: the grid's card against CPU cut to WF_CMP_WINDOWS windows and
#: WF_CMP_EPOCHS epochs (the CPU's time)
WF_EPOCHS = 1000
WF_CMP_WINDOWS, WF_CMP_EPOCHS, WF_CMP_CHUNK, WF_SEED = 6, 20, 10, 13
WF_LATENTS = list(range(1, 9))


def walkforward_outputs(np, out_dir: str, windows: int, latents: int) -> dict:
    """Check a walk-forward's files: every one written, every number
    finite; returns the manifest."""
    names = ["walkforward.csv", "walkforward_ante.csv", "walkforward.json"]
    missing = [n for n in names if not os.path.isfile(os.path.join(out_dir, n))]
    if missing:
        fail(f"scenario: {out_dir} lacks {missing}")
    for n in names[:2]:
        vals = csv_numbers(os.path.join(out_dir, n))
        if len(vals) != windows * latents or not np.all(np.isfinite(vals)):
            fail(f"scenario: {n} has {len(vals)} cells or one not finite")
    with open(os.path.join(out_dir, "walkforward.json")) as fh:
        manifest = json.load(fh)
    if len(manifest["windows"]) != windows:
        fail(f"scenario: {out_dir} manifest lists {len(manifest['windows'])} windows")
    for name in manifest["windows"]:
        with np.load(os.path.join(out_dir, "windows", name, "scores.npz")) as z:
            if not all(np.all(np.isfinite(z[k])) for k in ("sharpe_ante", "sharpe_post")):
                fail(f"scenario: {name}'s scores are not finite")
    return manifest


def phase_scenario(torch, np, cuda_lstm, keep: str) -> dict:
    """The scenario factory on the committed panel: (a) the conditional
    mtss_wgan_gp epoch on the card, each critic route, its launches gated
    exactly, one epoch against the CPU plain path on the same draws;
    (b) ``scenario bank --family mtss_wgan_gp --train-epochs 30``, twice:
    the bank written, every block digest reproduced; (c) ``scenario
    walkforward`` on the panel and ``scenario universe`` at its defaults
    (64 funds, 360 months, 22 factors), every file written and every
    number finite, and the walk-forward grid's training on the card
    against the CPU's from the same draws."""
    from hfrep_tpu_torch.config import AEConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.core import scaler
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.replication import engine
    from hfrep_tpu_torch.scenario import regimes as reg
    from hfrep_tpu_torch.scenario import walkforward
    from hfrep_tpu_torch.scenario.conditional import _pair_of, sliding_windows
    from hfrep_tpu_torch.train import (init_conditional_state, make_conditional_step,
                                       make_multi_step, sample_draws)

    tag = "[scenario]"
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    panel = load_panel(cleaned, device="cpu")
    out = {"epochs": []}

    # (a) the conditional epoch on each critic route
    x = panel.factors.numpy()
    labels = reg.label_regimes(x, 12, COND_REGIMES)
    windows = sliding_windows(scaler.fit_transform(panel.factors)[1].numpy(), COND_W)
    conds = reg.window_conditions(labels, COND_W, COND_REGIMES)
    ds, cond = torch.from_numpy(windows).cuda(), torch.from_numpy(conds).cuda()
    mcfg = ModelConfig(family="mtss_wgan_gp", features=x.shape[1], window=COND_W)
    tcfg = TrainConfig(batch_size=32, n_critic=1, steps_per_call=COND_EPOCHS)
    one = dataclasses.replace(tcfg, steps_per_call=1)
    for k, route in enumerate(("auto", "chained")):
        state = init_conditional_state(200 + k, mcfg, COND_REGIMES, device="cuda")
        state.discriminator.body.stack = route
        pair = _pair_of(state, mcfg)
        multi = make_multi_step(pair, tcfg, ds, step=make_conditional_step(pair, tcfg, ds, cond))
        g = torch.Generator(device="cuda")
        g.manual_seed(300 + k)
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        state, metrics = multi(state, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sums = cuda_lstm.launch_counts(), sum_launches_by_shape(cuda_lstm)
        d_loss, g_loss = metrics["d_loss"].cpu(), metrics["g_loss"].cpu()
        if not (torch.isfinite(d_loss).all() and torch.isfinite(g_loss).all()):
            fail(f"scenario: {route} conditional losses not finite: {d_loss}, {g_loss}")
        check_route_launches(f"scenario: the conditional epochs ({route} route)", launches,
                             sums, COND_ROUTE_LAUNCHES[route], COND_EPOCHS)
        if sum(sums.values()) != COND_SUM_LAUNCHES_PER_EPOCH * COND_EPOCHS:
            fail(f"scenario: {route}: {sum(sums.values())} weight-sum launches, expected "
                 f"{COND_SUM_LAUNCHES_PER_EPOCH} an epoch")
        cpu_pair = _pair_of(state.to("cpu"), mcfg)
        parity = epoch_parity(
            torch, lambda dev: make_conditional_step(pair if dev == "cuda" else cpu_pair, one,
                                                     ds.to(dev), cond.to(dev)),
            state, sample_draws(g, pair, one, ds))
        say(f"{tag} (a) conditional mtss_wgan_gp W={COND_W} F={x.shape[1]}+{COND_REGIMES} "
            f"({len(windows)} windows), {route} route: {COND_EPOCHS} epochs in {wall:.2f} s, "
            f"d_loss {[round(float(v), 5) for v in d_loss]}; launches per epoch "
            + ", ".join(f"{n} {c / COND_EPOCHS:g}" for n, c in launches.items() if c)
            + f", weight sums {sum(sums.values()) / COND_EPOCHS:g}; one epoch card vs CPU: "
            f"d_loss rel {parity['loss_rel_diff']['d_loss']:.2e}, g_loss rel "
            f"{parity['loss_rel_diff']['g_loss']:.2e} (limit 1e-4), params worst "
            f"|diff|/(1e-5+1e-4|cpu|) {parity['param_worst_ratio']:.3f} at "
            f"{parity['param_worst_at']} (limit 1)")
        if not parity["ok"]:
            fail(f"scenario: the card's conditional epoch ({route}) differs from the CPU "
                 f"plain path: {parity}")
        out["epochs"].append({"route": route, "W": COND_W, "F": x.shape[1],
                              "regimes": COND_REGIMES, "launches": launches,
                              "weight_sum_launches": sums, "wall_s": wall,
                              "d_loss": d_loss.tolist(), "g_loss": g_loss.tolist(),
                              "parity": parity})

    # (b) the bank verb, twice with the same seed
    banks = []
    for i in range(2):
        dest = os.path.join(keep, f"bank{i}")
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        rc, text = run_cli(["scenario", "bank", "--family", "mtss_wgan_gp", "--train-epochs",
                            str(BANK_EPOCHS), "--cleaned-dir", cleaned, "--out", dest])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sums = cuda_lstm.launch_counts(), sum_launches_by_shape(cuda_lstm)
        if rc != 0 or not os.path.isfile(os.path.join(dest, "bank.json")):
            fail(f"scenario: bank run {i} rc {rc}")
        with open(os.path.join(dest, "bank.json")) as fh:
            manifest = json.load(fh)
        n_blocks = COND_REGIMES * BANK_BLOCKS
        for name in manifest["block_digests"]:
            arr = np.load(os.path.join(dest, "blocks", name, "samples.npy"))
            if arr.shape != (BANK_BLOCK_SIZE, COND_W, x.shape[1]) or not np.isfinite(arr).all():
                fail(f"scenario: bank block {name} shape {arr.shape} or not finite")
        if len(manifest["block_digests"]) != n_blocks:
            fail(f"scenario: the bank holds {len(manifest['block_digests'])} blocks")
        # the epochs on the fused route, then 2 lstm_fwd a block
        check_route_launches(f"scenario: bank run {i}", launches, sums,
                             COND_ROUTE_LAUNCHES["auto"], BANK_EPOCHS, extra_fwd=2 * n_blocks)
        banks.append({"wall_s": wall, "launches": launches, "weight_sum_launches": sums,
                      "aggregate_digest": manifest["aggregate_digest"],
                      "block_digests": manifest["block_digests"]})
    same = banks[0]["block_digests"] == banks[1]["block_digests"]
    say(f"{tag} (b) scenario bank --family mtss_wgan_gp --train-epochs {BANK_EPOCHS}: "
        f"{COND_REGIMES * BANK_BLOCKS} blocks of {BANK_BLOCK_SIZE}, {banks[0]['wall_s']:.1f} s "
        f"and {banks[1]['wall_s']:.1f} s; a second run reproduces every block digest: {same} "
        f"(aggregate {banks[0]['aggregate_digest'][:16]}); launches "
        + ", ".join(f"{n} {c}" for n, c in banks[0]["launches"].items() if c))
    if not same or banks[0]["aggregate_digest"] != banks[1]["aggregate_digest"]:
        fail("scenario: the second bank run's digests differ from the first's")
    out["bank"] = banks[0]
    out["bank_second_wall_s"] = banks[1]["wall_s"]

    # (c) the walk-forward and universe verbs, then the grid against the CPU
    out["verbs"] = {}
    for mode, extra in (("walkforward", ["--cleaned-dir", cleaned]), ("universe", [])):
        dest = os.path.join(keep, mode)
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        rc, text = run_cli(["scenario", mode, "--out", dest, "--epochs", str(WF_EPOCHS)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: c for k, c in cuda_lstm.launch_counts().items() if c}
        if rc != 0:
            fail(f"scenario: {mode} rc {rc}")
        doc = json.loads(text[:text.index("\nsurface: ")])
        manifest = walkforward_outputs(np, dest, 24, len(WF_LATENTS))
        st = doc["stats"]
        say(f"{tag} (c) scenario {mode} ({st['funds']} funds, {st['months']} months): "
            f"{wall:.1f} s, {st['lanes']} lanes, pad waste {st['pad_waste_frac']:.4f}, train "
            f"{st['train_secs']} s, eval {st['eval_secs']} s, {st['windows_per_sec']} windows/s; "
            f"chunks {st['chunk_stats']}; mean Sharpe post "
            f"{manifest['summary']['mean_sharpe_post']}; kernels launched {launched}")
        if launched:
            fail(f"scenario: {mode} launched {launched}: the AE path has no hand kernel")
        out["verbs"][mode] = {"wall_s": wall, "stats": st,
                              "mean_sharpe_post": manifest["summary"]["mean_sharpe_post"]}
    spec = walkforward.WalkForwardSpec(start=120, n_windows=WF_CMP_WINDOWS, horizon=36)
    cfg = AEConfig(epochs=WF_CMP_EPOCHS, chunk_epochs=WF_CMP_CHUNK,
                   latent_dim=max(WF_LATENTS))
    lanes = (WF_CMP_WINDOWS, len(WF_LATENTS))
    gen = torch.Generator()
    gen.manual_seed(WF_SEED)
    init = engine.keras_init_params(gen, lanes, x.shape[1], max(WF_LATENTS), "cpu")
    n_train = int(spec.train_rows(WF_CMP_WINDOWS - 1) * (1.0 - cfg.val_split))
    perms = engine.PermStream(WF_SEED, lanes, n_train, torch.device("cpu"))
    runs, secs = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        runs[dev] = walkforward._train_grid(
            0, x, spec, cfg, WF_LATENTS, init_params=init, device=dev,
            perm_source=lambda pos, n, dev=dev: perms(pos, n).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    (cpu, cstats, _), (gpu, gstats, _) = runs["cpu"], runs["cuda"]
    stop_equal = torch.equal(cpu.stop_epoch, gpu.stop_epoch.cpu())
    loss_err = max(float(torch.nan_to_num((getattr(gpu, k).cpu() - getattr(cpu, k)).abs()
                                          / getattr(cpu, k).abs(), 0.0).max())
                   for k in ("train_loss", "val_loss"))
    nan_equal = all(torch.equal(getattr(gpu, k).cpu().isnan(), getattr(cpu, k).isnan())
                    for k in ("train_loss", "val_loss"))
    param_excess = max(float(((gpu.params[k].cpu() - cpu.params[k]).abs()
                              - (1e-5 + 1e-4 * cpu.params[k].abs())).max())
                       for k in cpu.params)
    say(f"{tag} (c) the walk-forward grid, {WF_CMP_WINDOWS} windows x {len(WF_LATENTS)} "
        f"latents x {WF_CMP_EPOCHS} epochs, the same draws: card {secs['cuda']:.2f} s, CPU "
        f"{secs['cpu']:.2f} s; losses max rel err {loss_err:.3g} (bar 1e-4), NaNs equal "
        f"{nan_equal}; params max excess over atol 1e-5 + rtol 1e-4 {param_excess:.3g} "
        f"(<= 0 passes); stop epochs equal {stop_equal}")
    if not (stop_equal and nan_equal and loss_err <= 1e-4 and param_excess <= 0
            and cstats == gstats):
        fail(f"scenario: the card's walk-forward grid differs from the CPU's (losses "
             f"{loss_err}, params {param_excess}, stats {gstats} against {cstats})")
    out["grid_card_vs_cpu"] = {"windows": WF_CMP_WINDOWS, "latents": len(WF_LATENTS),
                               "epochs": WF_CMP_EPOCHS, "card_s": secs["cuda"],
                               "cpu_s": secs["cpu"], "loss_max_rel_err": loss_err,
                               "param_max_excess": param_excess}
    return out


#: the pipeline phase: the verb on the trainer phase's W=168 checkpoint, the
#: AE at AEConfig() widths, latents 1-21 (the paper's sweep); (c) fixture
#: items at the committed panel's 22 factors and 168 training months
PIPE_BLOCKS, PIPE_GEN_WINDOWS, PIPE_CONSUMERS = 2, 10, 2
PIPE_FIXTURE = ["--fixture-sources", "2", "--fixture-feats", "22", "--fixture-rows", "168"]
#: seconds a fixture item takes in (c), the sampling latency the kill needs
#: its producer alive for (the bytes do not depend on it)
PIPE_GEN_DELAY = 1.0
#: AE epochs of the phase's runs, cut from AEConfig()'s 1000-epoch cap to
#: hold the phase near 2 minutes (at full depth it took 172.9 s on the
#: H100, tools/torch_pipeline_phase.py), then from 200 to 100: (b)'s
#: drained run and its resume, in turn, are the phase's longest leg
PIPE_EPOCHS = 100
PIPE_TIMEOUT_S = 420


def actor_streams(run_dir: str) -> dict:
    """Every actor's event records under ``<run_dir>/actors``, each
    incarnation's stream (a restarted member rotates its earlier one to
    ``events-<n>.jsonl``) in order, the live one with the chunks its
    writer rotated aside (``report.iter_event_files``, ``load_events``)."""
    from hfrep_tpu_torch.obs import report

    out = {}
    root = os.path.join(run_dir, "actors")
    for name in sorted(os.listdir(root)):
        recs = []
        for f in report.iter_event_files([os.path.join(root, name)]):
            recs += (report.load_events(f.parent) if f.name == report.EVENTS_NAME
                     else report.load_jsonl(f, report.parse_event))
        out[name] = recs
    return out


def stream_launches(records: list) -> dict:
    """The hand kernels' launches an actor wrote into its stream as
    ``launches/<kernel>`` counters (the sum of their deltas)."""
    counts = {}
    for r in records:
        if r.get("type") == "metric" and str(r.get("name", "")).startswith("launches/"):
            k = r["name"][len("launches/"):]
            counts[k] = counts.get(k, 0) + int(r["delta"])
    return counts


def start_pipeline_verb(args: list, env_extra: dict) -> tuple:
    """``python -m hfrep_tpu_torch pipeline ARGS`` from the checkout's root
    on the card, started: ``(process, start time)`` for
    :func:`finish_pipeline_verb`."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **env_extra)
    proc = subprocess.Popen([sys.executable, "-m", "hfrep_tpu_torch", "pipeline", "--device",
                             "cuda"] + args, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    return proc, time.perf_counter()


def finish_pipeline_verb(started: tuple) -> tuple:
    """Wait for a :func:`start_pipeline_verb` run: (exit code, wall seconds,
    stdout, stderr); past PIPE_TIMEOUT_S it is killed and the phase fails."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(
            timeout=max(1.0, PIPE_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        kill_tree(proc)
        proc.communicate()
        fail(f"pipeline {' '.join(proc.args[5:7])}: overran {PIPE_TIMEOUT_S} s")
    return proc.returncode, time.perf_counter() - t0, stdout, stderr


def pipeline_report(name: str, rc: int, wall: float, stdout: str, stderr: str,
                    obs_dir: str) -> dict:
    """The parent stream's restarts and queue depth over time, printed."""
    recs = stream_records(obs_dir)
    depth = [(round(r["t"], 2), r["value"]) for r in recs
             if r.get("name") == "orchestrate/queue_depth"]
    restarts = sum(1 for r in recs if r.get("name") == "actor_restart")
    say(f"[pipeline] {name}: exit {rc} in {wall:.1f} s; restarts {restarts}; queue depth "
        f"(t s, items) {depth}")
    for line in stderr.splitlines():
        if "preempted" in line or "Error" in line or "error" in line:
            say(f"[pipeline] {name} stderr: {line}")
    return {"rc": rc, "wall_s": wall, "restarts": restarts, "queue_depth": depth}


def phase_pipeline(torch, np, keep: str, gan_checkpoint: str, epochs=PIPE_EPOCHS) -> dict:
    """The actor fabric through ``python -m hfrep_tpu_torch pipeline`` on the
    card, (a), (b)'s first run and (c) side by side: (a) the undisturbed run
    (one generator actor sampling the trainer phase's W=168 checkpoint, 2
    blocks of 10 windows, 2 consumers running the augmented 21-latent
    sweep at ``AEConfig()``): exit 0, every
    result published, ``pipeline.json`` assembled, the generator's stream
    showing exactly 4 ``lstm_fwd`` launches and no other kernel, the
    consumers' none; (b) the same plan under ``HFREP_FAULTS=sigterm@item=1``
    exits 75, ``--resume`` then exits 0 with ``pipeline.json`` byte-equal to
    (a)'s; (c) 2 fixture sources (22 factors, 168 rows) under
    ``HFREP_FAULTS=kill@actor=1``: exit 0, at least one restart, and an
    item's ``sweep.npz`` equal to ``sweep_item_arrays`` on the same panel
    and seed in this process, bit for bit.  ``epochs`` caps the AE epochs
    of every run (None: ``AEConfig()``'s 1000)."""
    import concurrent.futures

    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.orchestrate.actors import _fixture_panel, result_name
    from hfrep_tpu_torch.replication import engine
    from hfrep_tpu_torch.train.trainer import seed_mix

    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    gan = ["--gan-checkpoint", gan_checkpoint, "--preset", "mtss_wgan_gp_prod", "--blocks",
           str(PIPE_BLOCKS), "--n-gen-windows", str(PIPE_GEN_WINDOWS), "--consumers",
           str(PIPE_CONSUMERS), "--latents", "1:21", "--cleaned-dir", cleaned,
           "--drain-timeout", "120"]
    depth = [] if epochs is None else ["--epochs", str(epochs)]
    gan += depth
    out = {"epochs": epochs}

    # (a), (b)'s drained run and (c) at once, each in its own dirs; (b)'s
    # resume as soon as its drained run has exited, beside (a) and (c); the
    # item (c) is held to computed here meanwhile
    a_out, a_obs = os.path.join(keep, "pipe_a"), os.path.join(keep, "pipe_a_obs")
    b_out = os.path.join(keep, "pipe_b")
    c_out, c_obs = os.path.join(keep, "pipe_c"), os.path.join(keep, "pipe_c_obs")
    t_runs = time.perf_counter()
    runs = {"a": start_pipeline_verb(gan + ["--out", a_out, "--obs-dir", a_obs], {}),
            "b": start_pipeline_verb(
                gan + ["--out", b_out, "--obs-dir", os.path.join(keep, "pipe_b_obs")],
                {"HFREP_FAULTS": "sigterm@item=1"}),
            "c": start_pipeline_verb(
                PIPE_FIXTURE + depth + ["--blocks", str(PIPE_BLOCKS), "--consumers",
                                        str(PIPE_CONSUMERS), "--latents", "1:21", "--gen-delay",
                                        str(PIPE_GEN_DELAY), "--out", c_out, "--obs-dir", c_obs],
                {"HFREP_FAULTS": "kill@actor=1"})}
    cfg = dataclasses.replace(AEConfig(), n_factors=22, latent_dim=21)
    if epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=epochs)
    source_idx, seq = 1, PIPE_BLOCKS - 1
    with concurrent.futures.ThreadPoolExecutor(len(runs) + 1) as pool:
        try:                            # each waited for on its own thread: its own wall
            futures = {k: pool.submit(finish_pipeline_verb, v) for k, v in runs.items()}
            t0 = time.perf_counter()
            direct = engine.sweep_item_arrays(seed_mix(cfg.seed, source_idx, seq),
                                              _fixture_panel(0, source_idx, seq, 168, 22), cfg,
                                              list(range(1, 22)), device="cuda")
            direct_s = time.perf_counter() - t0
            if futures["b"].result()[0] == 75:
                runs["b2"] = start_pipeline_verb(
                    gan + ["--out", b_out, "--resume", "--obs-dir",
                           os.path.join(keep, "pipe_b2_obs")], {})
                futures["b2"] = pool.submit(finish_pipeline_verb, runs["b2"])
            done = {k: f.result() for k, f in futures.items()}
        finally:
            # a failed run exits: no pipeline outlives the script
            for proc, _ in runs.values():
                if proc.poll() is None:
                    kill_tree(proc)
    out["runs_wall_s"] = time.perf_counter() - t_runs
    say(f"[pipeline] (a), (b)'s drained run and (c) side by side, (b)'s resume once its "
        f"drained run exited: {out['runs_wall_s']:.1f} s")

    # (a) undisturbed
    rc, wall, stdout, stderr = done["a"]
    out["a"] = pipeline_report("(a) undisturbed", rc, wall, stdout, stderr, a_obs)
    if rc != 0 or not os.path.isfile(os.path.join(a_out, "pipeline.json")):
        fail(f"pipeline (a): exit {rc}\n{stderr[-3000:]}")
    with open(os.path.join(a_out, "pipeline.json"), "rb") as fh:
        want = fh.read()
    doc = json.loads(want)
    items = doc["sources"]["g0"]["items"]
    if sorted(items) != [f"{i:05d}" for i in range(PIPE_BLOCKS)]:
        fail(f"pipeline (a): items {sorted(items)}")
    for seq in range(PIPE_BLOCKS):
        summary = os.path.join(a_out, "results", result_name("g0", seq), "summary.json")
        with open(summary) as fh:
            best = json.load(fh)["best_oos_r2"]["mean"]
        if not np.isfinite(best):
            fail(f"pipeline (a): item {seq}'s best OOS R2 is {best}")
    streams = actor_streams(a_obs)
    launches = {name: stream_launches(recs) for name, recs in streams.items()}
    say(f"[pipeline] (a) launches by actor, from their streams: {launches}")
    gen = launches.get("gen_g0", {})
    if gen != {"lstm_fwd": 2 * PIPE_BLOCKS} or any(launches.get(f"cons{c}")
                                                     for c in range(PIPE_CONSUMERS)):
        fail(f"pipeline (a): launches {launches}; expected lstm_fwd "
             f"{2 * PIPE_BLOCKS} from gen_g0 and nothing else")
    out["a"].update(launches=launches, items=items)

    # (b) drained at the generator's first item boundary, then resumed
    rc, wall, stdout, stderr = done["b"]
    out["b_drained"] = pipeline_report("(b) sigterm@item=1", rc, wall, stdout, stderr,
                                       os.path.join(keep, "pipe_b_obs"))
    if rc != 75:
        fail(f"pipeline (b): the drained run exited {rc}, not 75\n{stderr[-3000:]}")
    rc, wall, stdout, stderr = done["b2"]
    out["b_resumed"] = pipeline_report("(b) --resume", rc, wall, stdout, stderr,
                                       os.path.join(keep, "pipe_b2_obs"))
    with open(os.path.join(b_out, "pipeline.json"), "rb") as fh:
        same = fh.read() == want
    say(f"[pipeline] (b) the resumed pipeline.json equals (a)'s byte for byte: {same}")
    if rc != 0 or not same:
        fail(f"pipeline (b): resume exit {rc}, pipeline.json equal {same}\n{stderr[-3000:]}")

    # (c) a killed producer, and one item against this process
    rc, wall, stdout, stderr = done["c"]
    out["c"] = pipeline_report("(c) kill@actor=1", rc, wall, stdout, stderr, c_obs)
    if rc != 0 or out["c"]["restarts"] < 1:
        fail(f"pipeline (c): exit {rc}, restarts {out['c']['restarts']}\n{stderr[-3000:]}")
    with np.load(os.path.join(c_out, "results", result_name(f"f{source_idx}", seq),
                              "sweep.npz")) as z:
        published = {k: z[k] for k in z.files}
    bitwise = (sorted(published) == sorted(direct)
               and all(published[k].dtype == direct[k].dtype
                       and published[k].tobytes() == direct[k].tobytes() for k in direct))
    say(f"[pipeline] (c) item f{source_idx}/{seq}: the published sweep.npz equals "
        f"sweep_item_arrays in this process bit for bit: {bitwise} (stop epochs "
        f"{direct['stop_epoch'].tolist()}, {int(direct['chunks_dispatched'])} chunks, "
        f"{direct_s:.1f} s here)")
    if not bitwise:
        fail("pipeline (c): the published item differs from sweep_item_arrays here")
    out["c"].update(item_bitwise=bitwise, direct_s=direct_s,
                    launches={n: stream_launches(r) for n, r in actor_streams(c_obs).items()})
    return out


#: the health phase: the trainer phase's preset on the committed panel,
#: 15 epochs at 5 a block on the fused route (a warm block, two steady
#: ones), one block on the chained route, each with health off and on;
#: the chunked AE drive at 40 epochs
HEALTH_SPC, HEALTH_FUSED_EPOCHS = 5, 15
HEALTH_AE_EPOCHS, HEALTH_AE_CHUNK = 40, 10
#: health's cost: steady blocks of HEALTH_SPC epochs, alternated off and on
HEALTH_COST_PAIRS = 24
#: ``train-gan --profile-dir``: epochs captured
PROFILE_EPOCHS = 2
#: the hand kernels' names, as the profiler's trace spells them
HAND_KERNELS = ("lstm_fwd_", "lstm_bwd_", "lstm_adj_", "stack_fwd_", "stack_bwd_",
                "stack_adj_", "stack_gates_", "weight_sum_", "col_sum_")


def stream_records(run_dir: str) -> list:
    """A run dir's records, the chunks a rotation moved aside included."""
    from hfrep_tpu_torch.obs import report
    return report.load_events(run_dir)


def profiled_train_gan(torch, cuda_lstm, keep: str, cleaned: str, tag: str) -> dict:
    """``train-gan --profile-dir --obs-dir`` for :data:`PROFILE_EPOCHS`
    epochs on the card: one trace with the hand kernels' device events,
    linked in ``run.json``; both dirs stay under ``keep``."""
    # the capture and its run dir stay under ``keep`` for the forensics phase
    from hfrep_tpu_torch.ops import _build
    prof_root = tempfile.mkdtemp(prefix="health_profile_", dir=keep)
    prof_dir, run_dir = os.path.join(prof_root, "prof"), os.path.join(prof_root, "obs")
    cuda_lstm.reset_launches()
    rc, text = run_cli(["train-gan", "--preset", "mtss_wgan_gp", "--epochs",
                        str(PROFILE_EPOCHS), "--cleaned-dir", cleaned, "--device", "cuda",
                        "--profile-dir", prof_dir, "--obs-dir", run_dir, "--quiet"])
    torch.cuda.synchronize()
    launched = sum(cuda_lstm.launch_counts().values())
    traces = sorted(glob.glob(os.path.join(prof_dir, "trace-*.json")))
    events = []
    if traces:
        with open(traces[0]) as f:
            events = json.load(f).get("traceEvents", [])
    ours = collections.Counter(
        next(n for n in HAND_KERNELS if n in e.get("name", "")) for e in events
        if e.get("cat") == "kernel" and any(n in e.get("name", "") for n in HAND_KERNELS))
    with open(os.path.join(run_dir, "run.json")) as f:
        linked = json.load(f).get("traces", [])
    if rc != 0 or len(traces) != 1 or not ours or not launched or len(linked) != 1:
        fail(f"health: train-gan --profile-dir exited {rc}, traces {traces}, hand kernels "
             f"in the trace {dict(ours)}, {launched} launches, run.json traces {linked}")
    say(f"{tag} train-gan --profile-dir, {PROFILE_EPOCHS} epochs: one trace "
        f"({os.path.getsize(traces[0])} bytes, linked in run.json), the hand kernels' "
        f"device events in it {dict(sorted(ours.items()))}; {launched} launches counted")
    return {"trace_bytes": os.path.getsize(traces[0]), "kernels": dict(ours),
            "launches": launched, "run_dir": run_dir, "prof_dir": prof_dir,
            "libraries": _build.loaded_paths()}


def phase_health(torch, np, cuda_lstm, train, train_chained, keep: str) -> dict:
    """The in-step health block on the card (``hfrep_tpu_torch.obs.health``):
    the same trainer run from the same draws with health off and on must
    end bit-equal, launch the route's kernels exactly as the train phase
    counted them an epoch, and carry five finite health values and a
    finite ``mfu`` gauge; a NaN planted in a parameter trips
    ``NumericFault`` under the armed tripwire with a forensic dump; the
    chunked AE drive ends bit-equal with health off and on.  Health's cost
    is the median of pairs of steady blocks run back to back, off and on;
    ``train-gan --profile-dir`` leaves one trace with the hand kernels in
    it."""
    import contextlib

    import hfrep_tpu_torch.obs as obs_pkg
    from hfrep_tpu_torch.config import AEConfig, get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.obs import health
    from hfrep_tpu_torch.replication.engine import sweep_autoencoders_chunked
    from hfrep_tpu_torch.train.trainer import GanTrainer
    from hfrep_tpu_torch.utils.fixture_data import scaled_panel

    tag = "[health]"
    t_phase = time.perf_counter()
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    base = get_preset("mtss_wgan_gp")
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, steps_per_call=HEALTH_SPC, checkpoint_dir=None))
    ds = build_gan_dataset(cfg.data, cfg.data.seed, load_panel(cleaned, device="cuda"))
    out = {"routes": {}}
    try:
        for route, runs, epochs in (("auto", train, HEALTH_FUSED_EPOCHS),
                                    ("chained", train_chained, HEALTH_SPC)):
            per_epoch = next(r for r in runs if r["preset"] == "mtss_wgan_gp")[
                "launches_per_epoch"]
            want = {n: round(per_epoch[n] * epochs) for n in ROUTE_KERNELS[route]}
            runs_by = {}
            for on in (False, True):
                health.configure(health.HealthConfig() if on else None)
                with tempfile.TemporaryDirectory() as run_dir:
                    with obs_pkg.session(run_dir, command="chip_smoke health"):
                        tr = GanTrainer(cfg, ds, device="cuda")
                        tr.state.discriminator.stack = route
                        torch.cuda.synchronize()
                        cuda_lstm.reset_launches()
                        tr.train(epochs)
                        torch.cuda.synchronize()
                        launches = cuda_lstm.launch_counts()
                        by_key = cuda_lstm.weight_sum_launches()
                        sums = sum(by_key.values())
                    mfu = [r["value"] for r in stream_records(run_dir)
                           if r.get("type") == "metric" and r.get("name") == "mfu"]
                launched = {n for n, c in launches.items() if c > 0}
                if (launched != ROUTE_KERNELS[route]
                        or any(launches[n] != c for n, c in want.items())
                        or sums != SUM_LAUNCHES_PER_EPOCH * epochs):
                    fail(f"health ({route}, health {'on' if on else 'off'}): launched "
                         f"{launches} and {sums} weight sums, expected {want} and "
                         f"{SUM_LAUNCHES_PER_EPOCH * epochs}")
                runs_by[on] = {"trainer": tr, "tensors": state_tensors(tr),
                               "history": tr.history,
                               "sps": tr.steps_per_sec, "launches": launches,
                               "weight_sums": sums, "mfu": mfu,
                               "by_shape": {name: by_key[(nsum, npair, m == 1)]
                                            for name, nsum, npair, m in SUM_SHAPES},
                               "samples": [(n, round(s, 4), w) for n, s, w in tr.timer.samples]}
            off, on = runs_by[False], runs_by[True]
            n_diff = sum(not torch.equal(a, b) for a, b in zip(off["tensors"], on["tensors"]))
            hist_same = all(a[k] == b[k] for a, b in zip(off["history"], on["history"])
                            for k in a)
            last = {k: v for k, v in on["history"][-1].items() if k.startswith("health_")}
            if n_diff or not hist_same or len(off["history"]) != epochs:
                fail(f"health ({route}): health on changed the run: {n_diff} tensors differ, "
                     f"history equal {hist_same}")
            if sorted(last) != sorted(health.STEP_KEYS) or not all(
                    np.isfinite(v) for v in last.values()) or last["health_nonfinite"] != 0:
                fail(f"health ({route}): the health values {last}")
            if len(on["mfu"]) != 1 or not np.isfinite(on["mfu"][0]) or not on["mfu"][0] > 0:
                fail(f"health ({route}): the mfu gauge {on['mfu']}")
            # the cost: steady blocks, off and on alternated (on first in every
            # other pair), each timed to the card's end
            walls = {False: [], True: []}
            for i in range(HEALTH_COST_PAIRS):
                for side in ((False, True) if i % 2 == 0 else (True, False)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs_by[side]["trainer"].train(HEALTH_SPC)
                    torch.cuda.synchronize()
                    walls[side].append(time.perf_counter() - t0)
            med_off, med_on = (float(np.median(walls[k])) for k in (False, True))
            # each pair's blocks ran back to back, on one state of the host
            ratios = [b / a - 1.0 for a, b in zip(walls[False], walls[True])]
            overhead = float(np.median(ratios))
            q1, q3 = (float(q) for q in np.percentile(ratios, (25, 75)))
            say(f"{tag} {route} route, mtss_wgan_gp W=48, {epochs} epochs at {HEALTH_SPC} a "
                f"block, health off then on from the same draws: every param and slot "
                f"bit-equal, history equal; launches as the train phase's "
                + ", ".join(f"{n} {launches[n] / epochs:g}" for n in sorted(want))
                + f" an epoch and {sums // epochs} weight sums, both runs; health "
                + ", ".join(f"{k[7:]} {v:.6g}" for k, v in sorted(last.items()))
                + f"; steps_per_sec off {off['sps']:.3f}, on {on['sps']:.3f} (samples off "
                f"{off['samples']}, on {on['samples']}); mfu {on['mfu'][0]:.6g} of the BF16 "
                f"peak; cost over {HEALTH_COST_PAIRS} alternated pairs of {HEALTH_SPC}-epoch "
                f"blocks: median block {1e3 * med_off:.3f} ms off, {1e3 * med_on:.3f} ms on "
                f"(health costs {100 * overhead:.2f}% as the median pair, quartiles "
                f"{100 * q1:.2f}% and {100 * q3:.2f}%, pairs {100 * min(ratios):.2f}% to "
                f"{100 * max(ratios):.2f}%) on {card_line(torch)}")
            out["routes"][route] = {
                "epochs": epochs, "launches": on["launches"], "weight_sums": on["weight_sums"],
                "weight_sum_launches": on["by_shape"],
                "launches_off": off["launches"], "health": last,
                "steps_per_sec_off": off["sps"], "steps_per_sec_on": on["sps"],
                "block_s_off": walls[False], "block_s_on": walls[True],
                "overhead": overhead, "overhead_quartiles": [q1, q3],
                "pair_overheads": ratios, "mfu": on["mfu"][0]}
        # the tripwire: a NaN in one parameter under HFREP_HEALTH=abort
        with tempfile.TemporaryDirectory() as dump_dir:
            health.configure(health.HealthConfig(abort_on_nonfinite=True, dump_dir=dump_dir))
            tr = GanTrainer(cfg, ds, device="cuda")
            with torch.no_grad():
                next(tr.state.generator.parameters()).view(-1)[0] = float("nan")
            try:
                tr.train(HEALTH_SPC)
                fail("health: a NaN parameter did not trip NumericFault")
            except health.NumericFault as e:
                dump = e.dump
                dumped = bool(dump) and os.path.exists(os.path.join(dump, "carry.npz"))
                if not dumped or not e.nonfinite:
                    fail(f"health: NumericFault {e} without a forensic dump")
                say(f"{tag} tripwire: a NaN in one generator parameter raised NumericFault "
                    f"at site {e.site}, epoch {e.epoch}, {int(e.nonfinite)} nonfinite; "
                    f"forensic dump {os.path.basename(dump)} written")
                out["tripwire"] = {"site": e.site, "epoch": e.epoch, "nonfinite": e.nonfinite}
        # the chunked AE drive, health off and on
        xs = scaled_panel(168, 22, seed=3)
        ae_cfg = dataclasses.replace(AEConfig(), epochs=HEALTH_AE_EPOCHS,
                                     chunk_epochs=HEALTH_AE_CHUNK)
        results = {}
        for on in (False, True):
            health.configure(health.HealthConfig() if on else None)
            with tempfile.TemporaryDirectory() as run_dir:
                with obs_pkg.session(run_dir, command="chip_smoke health"):
                    res, stats = sweep_autoencoders_chunked(7, xs, ae_cfg, list(range(1, 22)),
                                                            device="cuda")
                    torch.cuda.synchronize()
                gauges = {r["name"]: r["value"] for r in stream_records(run_dir)
                          if r.get("type") == "metric"
                          and str(r.get("name", "")).startswith("health/ae_")}
            results[on] = (res, stats, gauges)
        (a, sa, _), (b, sb, gauges) = results[False], results[True]
        same = (all(torch.equal(a.params[k], b.params[k]) for k in a.params)
                and torch.equal(a.stop_epoch, b.stop_epoch)
                and all(torch.equal(torch.nan_to_num(x, nan=-1.0), torch.nan_to_num(y, nan=-1.0))
                        for x, y in ((a.train_loss, b.train_loss), (a.val_loss, b.val_loss))))
        if not same or sa.epochs_dispatched != sb.epochs_dispatched:
            fail("health: the chunked AE drive differs with health on")
        if sorted(gauges) != ["health/ae_grad_norm", "health/ae_nonfinite",
                              "health/ae_param_norm"] or gauges["health/ae_nonfinite"] != 0:
            fail(f"health: the AE drive's gauges {gauges}")
        say(f"{tag} chunked AE drive, 21 lanes, {HEALTH_AE_EPOCHS} epochs at "
            f"{HEALTH_AE_CHUNK} a chunk: health on = off bit for bit ({sb.epochs_dispatched} "
            f"epochs dispatched); last gauges {gauges}")
        out["ae"] = {"gauges": gauges, "epochs_dispatched": sb.epochs_dispatched}
    finally:
        health.configure(None)
    # train-gan --profile-dir: a torch.profiler capture around the hand kernels
    out["profile"] = profiled_train_gan(torch, cuda_lstm, keep, cleaned, tag)
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


#: the serve_drain phase: the serve verb as a subprocess on the card
SERVE_REQUESTS, SERVE_WAVE, SERVE_DRAIN_REQUESTS = 256, 32, 4000
SERVE_TIMEOUT_S = 300


def run_serve_verb(args: list, sigterm: bool) -> tuple:
    """``python -m hfrep_tpu_torch serve --device cuda ARGS`` from the
    checkout's root; with ``sigterm`` a SIGTERM once it prints its
    "offering" line.  (exit code, wall seconds, stdout, stderr)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "hfrep_tpu_torch", "serve", "--device",
                             "cuda"] + args, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    err = []
    try:
        if sigterm:
            for line in proc.stderr:
                err.append(line)
                if "offering" in line:
                    proc.send_signal(signal.SIGTERM)
                    break
        stdout, rest = proc.communicate(timeout=SERVE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            kill_tree(proc)
            proc.wait()
    return proc.returncode, time.perf_counter() - t0, stdout, "".join(err) + rest


def phase_serve_drain(torch, np, keep: str, gan_checkpoint: str) -> dict:
    """The ``serve`` verb on the card from the trainer phase's W=168
    checkpoint, every other query a sample: undisturbed it exits 0 with
    the same traces admitted and completed in its stream, one a request,
    the serve events and one ``serve_load`` window and ``lstm_fwd`` launched; sent SIGTERM after its "offering"
    line it drains into exit 75 with ``terminal == submitted``.  The two
    runs go side by side (the undisturbed run's latencies, recorded and
    not gated, are then taken beside the other server)."""
    import concurrent.futures

    tag = "[serve_drain]"
    t_phase = time.perf_counter()
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    common = ["--gan-checkpoint", gan_checkpoint, "--preset", "mtss_wgan_gp_prod",
              "--cleaned-dir", cleaned, "--sample-every", "2", "--wave", str(SERVE_WAVE)]
    out = {}
    run_a, run_b = (os.path.join(keep, f"serve_obs_{k}") for k in ("a", "b"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    drain = pool.submit(run_serve_verb, common + [
        "--requests", str(SERVE_DRAIN_REQUESTS), "--max-queue", "100000", "--timeout-ms",
        "600000", "--obs-dir", run_b], True)
    try:
        out = serve_drain_checks(tag, common, run_a, run_b, drain)
    finally:
        pool.shutdown(wait=True)
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


def serve_drain_checks(tag: str, common: list, run_a: str, run_b: str, drain) -> dict:
    """The undisturbed run in this thread, then the checks of both."""
    out = {}
    rc, wall, stdout, stderr = run_serve_verb(
        common + ["--requests", str(SERVE_REQUESTS), "--timeout-ms", "30000",
                  "--obs-dir", run_a], sigterm=False)
    if rc != 0:
        fail(f"serve_drain: the undisturbed run exited {rc}: {stderr[-2000:]}")
    doc = json.loads(stdout)
    report, stats = doc["report"], doc["stats"]
    modes = stats["cache"]["modes"]
    if ("(export=on)" not in stderr or "torch.export round trip failed" in stderr
            or set(modes) != {"export"}):
        fail(f"serve_drain: the verb's programs {modes}, its stderr {stderr[-2000:]}")
    recs = stream_records(run_a)
    names = {r.get("name") for r in recs if r.get("type") == "event"}
    windows = [r for r in recs if r.get("name") == "timeline_window"
               and r.get("drive") == "serve_load"]
    launches = stream_launches(recs)
    # every request the server took, the warm-up's included, has one
    # trace admitted and completed
    admitted = {r.get("trace") for r in recs if r.get("name") == "serve_admit"}
    completed = {r.get("trace") for r in recs if r.get("name") == "serve_complete"}
    if (not report["submitted"] == report["terminal"] == report["results"] == SERVE_REQUESTS
            or admitted != completed or len(admitted) != stats["submitted"]
            or stats["terminal"] != stats["submitted"]
            or not {"serve_admit", "serve_dispatch", "serve_complete"} <= names
            or len(windows) != 1 or launches.get("lstm_fwd", 0) < 1):
        fail(f"serve_drain: undisturbed report {report}, {len(admitted)} traces admitted, "
             f"{len(completed)} completed, {len(admitted ^ completed)} not in both, events "
             f"{sorted(names)}, {len(windows)} serve_load windows, launches {launches}")
    say(f"{tag} undisturbed: export=on, programs {modes}; exit 0 in {wall:.1f} s; "
        f"{report['submitted']} submitted, "
        f"{report['results']} results; {len(admitted)} traces admitted, each completed "
        f"in the stream ({stats['submitted']} requests with the warm-up's); p50 "
        f"{report['p50_ms']} ms, p95 {report['p95_ms']} ms, qps "
        f"{report['qps']}; one serve_load window ({windows[0]['wall_ms']} ms, categories "
        f"{windows[0]['cat_ms']}); the member's launches {launches}")
    out["a"] = {"rc": rc, "wall_s": wall, "launches": launches, "report": report}
    rc, wall, stdout, stderr = drain.result()
    try:
        doc = json.loads(stdout[stdout.index("{"):stdout.rindex("}") + 1])
    except ValueError:
        doc = {}
    drained = doc.get("drained", {})
    if (rc != 75 or drained.get("reason") != "SIGTERM"
            or drained.get("terminal") != drained.get("submitted")
            or "(export=on)" not in stderr):
        fail(f"serve_drain: the SIGTERM run exited {rc}, drained {drained}: {stderr[-2000:]}")
    drain_events = [r for r in stream_records(run_b) if r.get("name") == "serve_drain"]
    say(f"{tag} SIGTERM after the offering line: exit 75 in {wall:.1f} s; drained "
        f"{drained['submitted']} submitted = {drained['terminal']} terminal "
        f"({drained['results']} results, flushed {drained['flushed']}); serve_drain events "
        f"{len(drain_events)}; launches {stream_launches(stream_records(run_b))}")
    out["b"] = {"rc": rc, "wall_s": wall, "drained": drained}
    return out


#: the obs_tier phase: ``train-gan`` at mtss_wgan_gp, 12 epochs (its
#: preset's 50-epoch blocks leave 12 one-epoch blocks of ~14 records,
#: ~2.2 KiB), with the live stream rotated past 4 KiB (the writer checks
#: its size every 32 records); four such runs, three into the history
OBS_EPOCHS, OBS_ROTATE_BYTES, OBS_RUNS = 12, 4096, 4


def run_obs(argv) -> tuple:
    """``python -m hfrep_tpu_torch.obs ARGV`` in this process: (exit code,
    standard output); a refusal of argparse comes back as its exit code."""
    import contextlib
    import io

    from hfrep_tpu_torch.obs.report import main as obs_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = obs_main([str(a) for a in argv])
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def without_run_dir(text: str) -> dict:
    doc = json.loads(text)
    doc.pop("run_dir", None)
    return doc


def phase_obs_tier(torch, np, keep: str, cli_obs: str, cli_launches: dict) -> dict:
    """The obs analysis tier over the run dirs the earlier phases wrote
    (module docstring, 5i)."""
    from hfrep_tpu_torch.obs import report, rollup
    from hfrep_tpu_torch.ops import cuda_lstm

    tag = "[obs_tier]"
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    # (a) the self-tests, on the port's copies of the committed fixtures
    for verb in ("report", "gate", "timeline", "slo"):
        rc, text = run_obs([verb, "--self-test"])
        if rc != 0:
            fail(f"obs_tier: {verb} --self-test exited {rc}: {text[-2000:]}")
    say(f"{tag} report, gate, timeline and slo --self-test: exit 0")

    # (b) the trainer phase's train-gan run (W=168) as the report reads it
    rc, text = run_obs(["report", "--format", "json", cli_obs])
    doc = json.loads(text) if rc == 0 else {}
    counted = {k[len("launches/"):]: v for k, v in doc.get("counters", {}).items()
               if k.startswith("launches/")}
    want = {k: v for k, v in cli_launches.items() if v}
    if (rc != 0 or doc["backend"] != "cuda" or not np.isfinite(doc["steps_per_sec"])
            or not np.isfinite(doc["mfu"]) or not doc["mfu"] > 0
            or any(counted.get(k) != v for k, v in want.items())):
        fail(f"obs_tier: report of the train-gan run: rc {rc}, backend {doc.get('backend')}, "
             f"steps/s {doc.get('steps_per_sec')}, mfu {doc.get('mfu')}, launch counters "
             f"{counted} against the phase's {want}")
    say(f"{tag} report of train-gan (mtss_wgan_gp_prod): backend cuda, "
        f"{doc['steps_per_sec']} steps/s, mfu {doc['mfu']} of the BF16 peak, launch "
        f"counters {counted}")
    out["train_gan"] = {k: doc[k] for k in ("backend", "steps_per_sec", "mfu", "n_events")}
    out["train_gan"]["launches"] = counted

    # (c) live rotation: train-gan runs under HFREP_OBS_ROTATE_BYTES
    cleaned = os.path.join(root, CLEANED_DIR)
    prior = os.environ.get("HFREP_OBS_ROTATE_BYTES")
    os.environ["HFREP_OBS_ROTATE_BYTES"] = str(OBS_ROTATE_BYTES)
    runs, walls = [], []
    try:
        for i in range(OBS_RUNS):
            run_dir = os.path.join(keep, f"obs_rot_{i}")
            # the verb writes this process's launch counts into its stream
            cuda_lstm.reset_launches()
            t0 = time.perf_counter()
            rc, text = run_cli(["train-gan", "--preset", "mtss_wgan_gp", "--epochs",
                                str(OBS_EPOCHS), "--cleaned-dir", cleaned, "--obs-dir", run_dir,
                                "--quiet"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if rc != 0:
                fail(f"obs_tier: train-gan with rotation, run {i}: rc {rc}: {text[-2000:]}")
            runs.append(run_dir)
    finally:
        if prior is None:
            os.environ.pop("HFREP_OBS_ROTATE_BYTES", None)
        else:
            os.environ["HFREP_OBS_ROTATE_BYTES"] = prior
    run0 = runs[0]
    chunks = rollup.chunk_files(run0)
    chunk_recs = [report.load_jsonl(c, report.parse_event, strict=True) for c in chunks]
    all_recs = report.load_events(run0, strict=True)
    launched = stream_launches(all_recs)
    kernels = {k: v for k, v in launched.items() if not k.startswith("weight_sum")}
    sums = sum(v for k, v in launched.items() if k.startswith("weight_sum"))
    if (len(chunks) < 2 or not any(r.get("name") == "block" for r in chunk_recs[0])
            or set(kernels) != ROUTE_KERNELS["auto"]
            or any(v % OBS_EPOCHS for v in kernels.values())
            or sums != SUM_LAUNCHES_PER_EPOCH * OBS_EPOCHS):
        fail(f"obs_tier: rotation at {OBS_ROTATE_BYTES} B left {len(chunks)} chunk(s) "
             f"({[len(r) for r in chunk_recs]} records), launches {launched}")
    raw_bytes = sum(os.path.getsize(c) for c in chunks) + os.path.getsize(
        os.path.join(run0, report.EVENTS_NAME))
    rc_a, before = run_obs(["report", "--format", "json", run0])
    rc_l, ledger_before = run_obs(["timeline", "--format", "json", run0])
    rc_c, text = run_obs(["compact", run0, "--format", "json"])
    rc_b, after = run_obs(["report", "--format", "json", run0])
    rc_m, ledger_after = run_obs(["timeline", "--format", "json", run0])
    compacted = json.loads(text)[0] if rc_c == 0 else {}
    disk_after = rollup.disk_footprint(run0)
    if (rc_a != 0 or rc_b != 0 or rc_c != 0 or rc_l != rc_m
            or without_run_dir(before) != without_run_dir(after)
            or ledger_before != ledger_after or rollup.chunk_files(run0)
            or len(compacted.get("compacted", [])) != len(chunks)):
        fail(f"obs_tier: compaction changed the reading: report rc {rc_a}/{rc_b}, timeline "
             f"rc {rc_l}/{rc_m}, compact rc {rc_c} {compacted}; reports equal "
             f"{rc_a == rc_b == 0 and without_run_dir(before) == without_run_dir(after)}, "
             f"ledgers equal {ledger_before == ledger_after}")
    say(f"{tag} chunks rotated: {len(chunks)} at {OBS_ROTATE_BYTES} B "
        f"({[len(r) for r in chunk_recs]} records, {len(all_recs)} in all; launches "
        f"{launched}); train-gan walls {[round(w, 2) for w in walls]} s")
    say(f"{tag} bytes before compaction {raw_bytes}, after {disk_after} "
        f"({compacted['records_compacted']} records compacted); report and ledger equal")
    out["rotation"] = {"chunks": len(chunks), "chunk_records": [len(r) for r in chunk_recs],
                       "records": len(all_recs), "bytes_before": raw_bytes,
                       "bytes_after": disk_after, "train_gan_walls_s": walls}
    rc, text = run_obs(["report", cli_obs, run0])
    if rc != 0:
        fail(f"obs_tier: report A B exited {rc}")
    for line in text.splitlines():
        say(f"{tag} report diff: {line}")

    # (d) the history: three runs ingested, the fourth gated twice
    hist = os.path.join(keep, "history.jsonl")
    keys = []
    for run_dir in runs[1:]:
        rc, text = run_obs(["ingest", run_dir, "--history", hist])
        rec = json.loads(text) if rc == 0 else {}
        if rc != 0 or not rec.get("ingested"):
            fail(f"obs_tier: ingest {run_dir}: rc {rc} {text[-500:]}")
        keys.append(rec["key"])
    if any(k != keys[0] for k in keys) or keys[0]["backend"] != "cuda":
        fail(f"obs_tier: the ingested runs' keys {keys}")
    gates = [run_obs(["gate", run0, "--history", hist, "--min-runs", "3", "--format", "json"])
             for _ in range(2)]
    verdict = json.loads(gates[0][1]) if gates[0][0] in (0, 1) else {}
    spc = [c for c in verdict.get("checks", []) if c["metric"] == "steps_per_sec"]
    if (gates[0] != gates[1] or len(spc) != 1 or spc[0]["status"] not in ("ok", "regression")
            or spc[0]["baseline"] is None or spc[0]["mad"] is None
            or verdict["n_comparable"] != 3):
        fail(f"obs_tier: gate: rc {gates[0][0]} / {gates[1][0]}, same "
             f"{gates[0] == gates[1]}, verdict {gates[0][1][-3000:]}")
    say(f"{tag} history key {keys[0]}")
    say(f"{tag} gate verdict (rc {gates[0][0]}, the same on a second gate): "
        + json.dumps(verdict, separators=(",", ":")))
    out["gate"] = {"rc": gates[0][0], "ok": verdict["ok"], "regressions": verdict["regressions"],
                   "drifts": verdict["drifts"], "steps_per_sec": spc[0], "key": keys[0]}

    # (e) --trace over serve_drain's undisturbed stream
    serve_a, serve_b = os.path.join(keep, "serve_obs_a"), os.path.join(keep, "serve_obs_b")
    idx = report.trace_index([serve_a])
    admitted = sorted(t for t, recs in idx.items()
                      if any(r.get("name") == "serve_admit" for r in recs))
    orphans = [t for t in admitted if not report.has_terminal(idx[t])]
    trace = admitted[len(admitted) // 2] if admitted else ""
    rc, text = run_obs(["report", "--trace", trace, serve_a])
    hops = [text.find(f" {n} ") for n in ("serve_admit", "serve_dispatch", "serve_complete")]
    if (not admitted or orphans or rc != 0 or min(hops) < 0 or hops != sorted(hops)
            or "terminal: yes" not in text):
        fail(f"obs_tier: --trace: {len(admitted)} admitted, {len(orphans)} without a "
             f"terminal event; {trace}: rc {rc}\n{text[-2000:]}")
    for line in text.splitlines():
        say(f"{tag} trace: {line}")
    say(f"{tag} {len(admitted)} traces admitted in serve_obs_a, each with a terminal event")
    out["trace"] = {"admitted": len(admitted), "orphans": len(orphans), "shown": trace}

    # (f) the live and fleet views
    rc_e, prom = run_obs(["export", serve_a])
    rc_t, frame = run_obs(["tail", serve_a, "--once"])
    fleet = os.path.join(keep, "fleet")
    shutil.copytree(serve_a, os.path.join(fleet, "replica_a"))
    shutil.copytree(serve_b, os.path.join(fleet, "replica_b"))
    rc_s, text = run_obs(["slo", fleet, "--format", "json"])
    slo = json.loads(text) if rc_s in (0, 1) else {}
    serve_gauges = [ln for ln in prom.splitlines()
                    if ln.startswith("hfrep_serve_") and not ln.startswith("# ")]
    if (rc_e != 0 or not serve_gauges or "# TYPE hfrep_serve_" not in prom or rc_t != 0
            or not frame.startswith("flight recorder") or rc_s not in (0, 1)
            or slo.get("evaluated") != 3 or slo.get("fleet", {}).get("replicas") != 2):
        fail(f"obs_tier: export rc {rc_e} ({len(serve_gauges)} serve/* lines), tail rc {rc_t}, "
             f"slo rc {rc_s}: {text[-2000:]}")
    say(f"{tag} export: {len(prom.splitlines())} lines, {len(serve_gauges)} serve/* "
        f"samples; tail --once: {len(frame.splitlines())} lines")
    for line in frame.splitlines():
        say(f"{tag} tail: {line}")
    say(f"{tag} slo over serve_obs_a and serve_obs_b (rc {rc_s}): " + json.dumps(
        {"slos": [{k: row[k] for k in ("name", "target", "fast", "slow", "breach")}
                  for row in slo["slos"]], "fleet": slo["fleet"]}, separators=(",", ":")))
    out["slo"] = {"rc": rc_s, "breaches": slo["breaches"], "worst_burn": slo["worst_burn"],
                  "ledger": slo["fleet"]["ledger"]}
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


#: the forensics phase: two ``train-gan`` runs at mtss_wgan_gp, 12 epochs
#: each (cut from 5000, as ``obs_tier``'s), and the chaos subject drained
FORENSICS_EPOCHS = 12
#: the chaos phase: the soak's seed and its fixed number of schedules (cut
#: from one a fast subject, 7, to 3, then to 2: the script's time limit),
#: the corpus entries' ``chaos --replay`` processes side by side, four at a
#: time (six gave the same phase wall: every leg slowed by a quarter), the
#: ``gan_ckpt`` subject's entries (the slowest, 90-130 s each) first (one
#: process's ``--replay-corpus`` was the phase's longest leg), and the
#: spawned legs' time limits
CHAOS_SEED, CHAOS_SCHEDULES, CORPUS_LANES = 11, 2, 4
CHAOS_TIMEOUT_S, SELFTEST_TIMEOUT_S = 600, 420


def start_module(module: str, args: list, env_extra=None) -> tuple:
    """``python -m MODULE ARGS`` from the checkout's root, started as a
    subprocess: ``(process, start time)`` for :func:`finish_module`."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_FAULTS", "HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_HEALTH")}
    env["PYTHONPATH"] = root
    env.update(env_extra or {})
    proc = subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=root,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    return proc, time.perf_counter()


def kill_tree(proc) -> None:
    """SIGKILL a running process the script started and every process it
    started in turn (a soak's subjects, a pipeline's actors): each leads
    a session of its own (``start_new_session``), whose group holds its
    descendants."""
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def finish_module(started: tuple, timeout: float) -> tuple:
    """Wait for a :func:`start_module` process: (exit code, stdout,
    stderr, wall seconds); past ``timeout`` it is killed and the phase
    fails."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        kill_tree(proc)
        proc.communicate()
        fail(f"{' '.join(proc.args[2:5])} overran {timeout} s")
    return proc.returncode, out, err, time.perf_counter() - t0


class CorpusReplay:
    """The committed chaos corpus replayed on the card, each entry its own
    ``chaos --replay SCHEDULE`` process, :data:`CORPUS_LANES` at a time
    (threads that only start and wait; the checks run in the caller), the
    ``gan_ckpt`` subject's entries first: they take the longest, so the
    lanes finish closer together.
    Entries whose subject the port does not register are skipped, named,
    as ``--replay-corpus`` skips them.  :meth:`results` waits for every
    entry: ``(file, exit code, the report, stderr, wall seconds)`` in
    corpus order, exit code None past the time limit; :meth:`stop`
    kills what still runs."""

    def __init__(self, keep: str):
        import concurrent.futures

        from hfrep_tpu_torch.resilience import chaos

        entries = chaos.corpus_entries()
        self.skipped = [{"corpus": e["_file"], "subject": e["_schedule"].subject}
                        for e in entries if e["_schedule"].subject not in chaos.SUBJECTS]
        self._procs: list = []
        self._stopped = False
        self._pool = concurrent.futures.ThreadPoolExecutor(CORPUS_LANES)
        runnable = [(i, e) for i, e in enumerate(entries)
                    if e["_schedule"].subject in chaos.SUBJECTS]
        runnable.sort(key=lambda ie: ie[1]["_schedule"].subject != "gan_ckpt")
        self._futures = [
            self._pool.submit(self._replay, e["_file"], e["_schedule"].encode(),
                              os.path.join(keep, f"chaos_corpus_{i}"))
            for i, e in runnable]

    def _replay(self, name: str, schedule: str, out: str) -> tuple:
        proc, t0 = start_module("hfrep_tpu_torch.resilience",
                                ["chaos", "--replay", schedule, "--device", "cuda", "--out", out])
        self._procs.append(proc)
        if self._stopped:
            kill_tree(proc)
        try:
            text, err = proc.communicate(timeout=CHAOS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            kill_tree(proc)
            text, err = proc.communicate()
            return name, None, {}, err, time.perf_counter() - t0
        doc = json.loads(text.strip().splitlines()[-1]) if text.strip() else {}
        return name, proc.returncode, doc, err, time.perf_counter() - t0

    def results(self) -> list:
        return sorted((f.result() for f in self._futures), key=lambda r: r[0])

    def stop(self) -> None:
        self._stopped = True
        for f in self._futures:
            f.cancel()
        for proc in list(self._procs):
            if proc.poll() is None:
                kill_tree(proc)
        self._pool.shutdown(wait=True)


def window_shares(records: list) -> dict:
    """The ledger's category shares over a run's steady ``gan_block``
    windows: ``{category: ms / wall ms}``."""
    wins = [r for r in records if r.get("name") == "timeline_window"
            and r.get("drive") == "gan_block" and not r.get("warmup")]
    wall = sum(w["wall_ms"] for w in wins)
    if not wins or not wall > 0:
        return {}
    cats = collections.Counter()
    for w in wins:
        cats.update(w["cat_ms"])
    return {c: v / wall for c, v in sorted(cats.items())} | {"windows": len(wins),
                                                             "wall_ms": wall}


def phase_forensics(torch, np, cuda_lstm, keep: str, health: dict) -> dict:
    """The analysis tier's second part on the card's runs: the profile
    digest of the ``health`` phase's capture, the kernel-library
    fingerprints in its manifest, the dispatch attribution and the ledger
    of two steady ``train-gan`` runs, ``explain`` of them (unchanged, then
    with one library digest changed), ``crash-drill`` and a drained chaos
    subject's crash bundle."""
    tag = "[forensics]"
    t_phase = time.perf_counter()
    # (e)'s two subprocesses run beside (a)-(d)
    subj = os.path.join(keep, "forensics_drained")
    legs = {"drill": start_module("hfrep_tpu_torch.obs", ["crash-drill", "--device", "cuda"]),
            "drained": start_module("hfrep_tpu_torch.resilience",
                                    ["chaos-subject", "ae_sweep", "--out", subj, "--device",
                                     "cuda"], {"HFREP_FAULTS": "preempt@chunk=1"})}
    try:
        out = forensics_parts(torch, cuda_lstm, keep, health, legs, subj)
    finally:
        # a failed check exits: no leg outlives the script
        for proc, _ in legs.values():
            if proc.poll() is None:
                kill_tree(proc)
                proc.communicate()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


def forensics_parts(torch, cuda_lstm, keep: str, health: dict, legs: dict, subj: str) -> dict:
    """:func:`phase_forensics`' checks, with (e)'s crash-drill and drained
    subject started in ``legs``."""
    import hashlib

    from hfrep_tpu_torch.obs import crash
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    tag = "[forensics]"
    out: dict = {}
    prof = health["profile"]
    # (a) the profile digest of the capture
    rc, text = run_obs(["profile", prof["run_dir"], "--format", "json", "--top", "0"])
    doc = json.loads(text) if rc == 0 else {}
    caps = [c for c in doc.get("captures", []) if "error" not in c]
    if rc != 0 or len(caps) != 1:
        fail(f"forensics: obs profile exited {rc} with captures {doc.get('captures')}")
    cap = caps[0]
    busy = {k: sum(r["total_s"] for r in cap["ops"] if k in r["op"]) for k in prof["kernels"]}
    if not all(v > 0 for v in busy.values()) or not cap["busy_s"] <= cap["wall_s"]:
        fail(f"forensics: kernel busy {busy}, union {cap['busy_s']} s of a traced wall "
             f"{cap['wall_s']} s")
    say(f"{tag} obs profile: {cap['n_events']} device events, busy {cap['busy_s'] * 1e3:.3f} ms "
        f"(interval union) of {cap['wall_s'] * 1e3:.3f} ms traced; each hand kernel's busy ms "
        + ", ".join(f"{k.rstrip('_')} {v * 1e3:.3f}" for k, v in sorted(busy.items()))
        + "; regions " + ", ".join(f"{r['region']} {r['busy_s'] * 1e3:.3f}"
                                   for r in cap["regions"]))
    out["profile"] = {"busy_s": cap["busy_s"], "wall_s": cap["wall_s"],
                      "n_events": cap["n_events"], "kernel_busy_s": busy,
                      "regions": cap["regions"]}
    # (b) the manifest's program fingerprints: every library loaded
    with open(os.path.join(prof["run_dir"], "run.json")) as f:
        programs = json.load(f).get("programs", {})
    # each compile boundary of the run (``compile:<step>``) names every
    # library loaded by its first call: ``compile:<step>:<library>``
    boundaries = sorted({k.rsplit(":", 1)[0] for k in programs if k.count(":") == 2})
    if not boundaries:
        fail(f"forensics: no kernel-library fingerprint in run.json programs {sorted(programs)}")
    prefix = boundaries[-1] + ":"
    named = {k[len(prefix):]: v for k, v in programs.items() if k.startswith(prefix)}
    if set(named) != set(prof["libraries"]):
        fail(f"forensics: run.json programs {sorted(named)} against the loaded libraries "
             f"{sorted(prof['libraries'])}")
    for lib, path in prof["libraries"].items():
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if [p["hlo_sha256"] for p in named[lib]] != [digest]:
            fail(f"forensics: {lib}'s recorded digest {named[lib]} is not its .so's {digest}")
    say(f"{tag} run.json programs at {boundaries}: {len(named)} kernel libraries, each "
        f"digest its .so's "
        f"sha256 ({', '.join(sorted(named))}); registers max "
        + ", ".join(f"{k} {v[0]['memory']['registers_max']}" for k, v in sorted(named.items())
                    if v[0].get("memory")))
    out["libraries"] = {k: v[0] for k, v in named.items()}
    # (c) attribution and the ledger over two steady runs
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    runs = []
    for name in ("a", "b"):
        run_dir = os.path.join(keep, f"forensics_{name}")
        cuda_lstm.reset_launches()
        rc, _ = run_cli(["train-gan", "--preset", "mtss_wgan_gp", "--epochs",
                         str(FORENSICS_EPOCHS), "--cleaned-dir", cleaned, "--device", "cuda",
                         "--obs-dir", run_dir, "--quiet"])
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"forensics: train-gan {name} exited {rc}")
        runs.append(run_dir)
    recs = stream_records(runs[0])
    gauges = [r for r in recs if r.get("type") == "metric"
              and str(r.get("name", "")).startswith("attrib/")]
    frac = [g["value"] for g in gauges if g["name"] == "attrib/dispatch_frac"]
    if not gauges or not all(isinstance(g["value"], (int, float)) and math.isfinite(g["value"])
                             for g in gauges) or not all(0.0 <= v <= 1.0 for v in frac):
        fail(f"forensics: attrib gauges {gauges[:6]}")
    shares = window_shares(recs)
    if not shares:
        fail("forensics: no steady gan_block ledger window")
    last = {g["name"]: g["value"] for g in gauges}
    say(f"{tag} train-gan x2, {FORENSICS_EPOCHS} epochs: {len(gauges)} finite attrib gauges, "
        f"last dispatch {last['attrib/dispatch_ms']} ms / compute {last['attrib/compute_ms']} "
        f"ms / frac {last['attrib/dispatch_frac']}; the ledger over {shares['windows']} steady "
        f"windows ({shares['wall_ms']:.1f} ms): unattributed {shares['unattributed']:.4f}, "
        f"dispatch {shares['dispatch']:.4f}, device_compute {shares['device_compute']:.4f}, "
        f"obs_self {shares['obs_self']:.4f}")
    out["attrib"] = {"gauges": len(gauges), "last": last, "window_shares": shares}
    # (d) explain: unchanged, then one library digest changed in a copy
    rc, text = run_obs(["explain", runs[0], runs[1], "--format", "json"])
    same = json.loads(text) if rc == 0 else {}
    if rc != 0 or any(f["kind"] == "program" for f in same.get("findings", [])):
        fail(f"forensics: explain of two unchanged runs exited {rc}: {same.get('findings')}")
    edited = os.path.join(keep, "forensics_b_edited")
    shutil.copytree(runs[1], edited)
    with open(os.path.join(runs[1], "run.json")) as f:
        b_programs = json.load(f)["programs"]
    victim = next(k for k in sorted(b_programs) if k.endswith(":lstm_stack_bwd"))
    forged = "f" * 64
    for path in [os.path.join(edited, "run.json")] + sorted(
            glob.glob(os.path.join(edited, "**", "events*.jsonl"), recursive=True)):
        with open(path) as f:
            body = f.read()
        old_digest = b_programs[victim][0]["hlo_sha256"]
        with open(path, "w") as f:
            f.write(body.replace(old_digest, forged))
    rc, text = run_obs(["explain", runs[0], edited, "--format", "json"])
    diff = json.loads(text) if rc == 0 else {}
    hits = [f for f in diff.get("findings", []) if f["kind"] == "program"
            and f["detail"].get("program") == victim]
    if rc != 0 or not hits:
        fail(f"forensics: explain missed the changed {victim}: {diff.get('findings')}")
    say(f"{tag} explain: unchanged runs give {len(same['findings'])} finding(s), no program "
        f"finding; one library digest changed gives rank {hits[0]['rank']}: "
        f"{hits[0]['summary'][:110]}")
    out["explain"] = {"unchanged_findings": [f["kind"] for f in same["findings"]],
                      "changed": hits[0]["summary"]}
    # (e) crash-drill on the card, and a drained subject's bundle
    rc, text, err, wall = finish_module(legs["drill"], 300)
    drill = json.loads(text.strip().splitlines()[-1]) if rc == 0 and text.strip() else {}
    if rc != 0 or drill.get("self_check") != "ok":
        fail(f"forensics: crash-drill --device cuda exited {rc}: {text[-800:]} {err[-1500:]}")
    say(f"{tag} crash-drill --device cuda: exit 0 in {wall:.1f} s, bundled "
        f"{drill['bundled_exception']}, {drill['rendered_lines']} rendered lines")
    rc, text, err, wall = finish_module(legs["drained"], 300)
    bundle = crash.find_bundle(os.path.join(subj, "obs"))
    if rc != 75 or bundle is None or crash.verify_bundle(bundle):
        fail(f"forensics: the drained ae_sweep subject exited {rc} with bundle {bundle}: "
             f"{err[-1500:]}")
    ckpt.verify(bundle)
    rc, text = run_obs(["report", "--crash", os.path.join(subj, "obs")])
    if rc != 0 or "Preempted" not in text:
        fail(f"forensics: report --crash exited {rc}: {text[-800:]}")
    say(f"{tag} ae_sweep subject drained on the card (preempt@chunk=1): exit 75 in {wall:.1f} s, "
        f"bundle {os.path.basename(bundle)} complete and checksummed; report --crash renders "
        f"{text.count(chr(10)) + 1} lines")
    out["drained_subject_wall_s"] = wall
    return out


#: the fused critic route's kernels (the ``gan_ckpt`` subject trains mtss_wgan_gp)
FUSED_KERNELS = ("lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "stack_fwd_res", "stack_bwd",
                 "stack_adj")


def phase_chaos(torch, np, keep: str) -> dict:
    """The chaos layer on the card: the registry gate, the kill→resume
    selftest, a seeded soak with the corpus replayed, the canary, and the
    ``gan_ckpt`` subject's own launches."""
    tag = "[chaos]"
    t_phase = time.perf_counter()
    out: dict = {}
    mod = "hfrep_tpu_torch.resilience"
    # the registry gate, the selftest, the corpus (each entry its own
    # process, CORPUS_LANES at a time), the soak and the canary run at
    # once, each in its own dirs
    soak_dir = os.path.join(keep, "chaos_soak")
    t_legs = time.perf_counter()
    legs = {"drives": start_module(mod, ["drives", "--check", "--format", "json"]),
            "selftest": start_module(mod, ["selftest", "--device", "cuda"]),
            "soak": start_module(mod, ["chaos", "--seed", CHAOS_SEED, "--budget-secs", 0,
                                       "--min-schedules", CHAOS_SCHEDULES, "--device", "cuda",
                                       "--out", soak_dir]),
            "planted": start_module(mod, ["chaos", "--seed", 2, "--budget-secs", 0,
                                          "--min-schedules", 1, "--subjects", "_planted",
                                          "--device", "cuda", "--out",
                                          os.path.join(keep, "chaos_planted")])}
    corpus = CorpusReplay(keep)
    try:
        rc, text, err, _ = finish_module(legs["drives"], 120)
        doc = json.loads(text) if text.strip() else {}
        problems = doc.get("problems", ["unreadable"])
        if rc != 0 or problems:
            fail(f"chaos: drives --check exited {rc}: {problems} {err[-800:]}")
        say(f"{tag} drives --check: {len(doc['drives'])} specs, exit {rc}, problems {problems}")
        out["drives"] = {"rc": rc, "problems": problems}
        rc, text, err, wall = finish_module(legs["selftest"], SELFTEST_TIMEOUT_S)
        st = json.loads(text.strip().splitlines()[-1]) if text.strip() else {}
        want = ("checkpoint_cycle", "lanes21", "multi", "ensemble_kill", "ensemble_drain",
                "serving_chaos", "serving_drain")
        if (rc != 0 or st.get("selftest") != "ok" or any(st.get(k) != "ok" for k in want)
                or st.get("lanes21_lanes") != 21 or st.get("ensemble_kill_restarts", 0) < 1
                or st.get("serving_worker_kills", 0) < 1 or st.get("serving_deadline_misses", 0) < 1
                or st.get("serving_breaker_trips", 0) < 1 or st.get("device") != "cuda"):
            fail(f"chaos: selftest --device cuda exited {rc}: {text[-1500:]} {err[-2000:]}")
        say(f"{tag} selftest --device cuda: exit 0 in {wall:.1f} s ({st['secs']} s inside): "
            + ", ".join(f"{k} {v}" for k, v in st.items() if k not in ("selftest", "secs")))
        out["selftest"] = dict(st, wall_s=wall)
        replays = corpus.results()
        for name, rc, doc, err, wall in replays:
            if rc != 0 or not doc.get("ok") or doc.get("violations"):
                fail(f"chaos: corpus entry {name} (chaos --replay) exited {rc}: {doc} "
                     f"{err[-2000:]}")
        skipped = corpus.skipped
        runs = sum(len(doc["attempts"]) for _, _, doc, _, _ in replays)
        if len(replays) != 9 or skipped:
            fail(f"chaos: the corpus replayed {len(replays)} entries and skipped {skipped}")
        corpus_s = time.perf_counter() - t_legs
        say(f"{tag} the corpus on the card, each entry a chaos --replay process, "
            f"{CORPUS_LANES} at a time: every exit 0 within {corpus_s:.1f} s, "
            f"{len(replays)} entries replayed (skipped {[c['corpus'][:3] for c in skipped]}), "
            f"{runs} faulted subject legs, violations 0; entries "
            f"{[(n[:3], round(w, 1)) for n, _, _, _, w in replays]}")
        out["corpus"] = {"corpus_replayed": len(replays), "corpus_skipped": skipped,
                         "legs": runs, "violations": 0, "wall_s": corpus_s,
                         "entries": [{"corpus": n, "attempts": d["attempts"], "wall_s": w}
                                     for n, _, d, _, w in replays]}
        rc, text, err, wall = finish_module(legs["soak"], CHAOS_TIMEOUT_S)
        soak = json.loads(text.strip().splitlines()[-1]) if text.strip() else {}
        if rc != 0 or not soak.get("ok") or soak.get("violations") != 0 \
                or soak.get("schedules") != CHAOS_SCHEDULES:
            fail(f"chaos: the soak exited {rc}: {text[-2000:]} {err[-2000:]}")
        say(f"{tag} soak --seed {CHAOS_SEED} --min-schedules {CHAOS_SCHEDULES} on the card: "
            f"exit 0 in {soak['secs']} s, {soak['schedules']} schedules over "
            f"{soak['distinct_subjects']} subjects, {soak['preempted_runs']} drained legs, "
            f"{soak['runs']} subject runs at {soak['run_secs_mean']} s each, violations "
            f"{soak['violations']}")
        out["soak"] = {k: soak[k] for k in ("schedules", "distinct_subjects", "preempted_runs",
                                            "runs", "run_secs_mean", "violations", "secs")}
        out["soak"]["wall_s"] = wall
        # the gan_ckpt subject's undisturbed reference: its own stream's
        # launches (the soak's, else a corpus replay's: the soak's first
        # schedules cycle the fast subjects in registry order)
        refs = sorted(glob.glob(os.path.join(keep, "chaos_*", "ref_gan_ckpt_*", "obs")))
        if not refs:
            fail("chaos: no gan_ckpt reference run in the soak or the corpus replays")
        ref_obs = refs[0]
        counters = {}
        for r in stream_records(ref_obs):
            if r.get("type") == "metric" and str(r.get("name", "")).startswith("launches/"):
                counters[r["name"][len("launches/"):]] = r["value"]
        if not all(counters.get(k, 0) > 0 for k in FUSED_KERNELS) \
                or not any(k.startswith("weight_sum") for k in counters):
            fail(f"chaos: the gan_ckpt subject's stream launches {counters}")
        say(f"{tag} gan_ckpt subject (mtss_wgan_gp, 4 epochs, n_critic 1) launches in its own "
            f"stream: " + ", ".join(f"{k} {v}" for k, v in sorted(counters.items())))
        out["gan_ckpt_launches"] = counters
        # the canary: found and shrunk on the card's driver
        rc, text, err, wall = finish_module(legs["planted"], CHAOS_TIMEOUT_S)
        planted = json.loads(text.strip().splitlines()[-1]) if text.strip() else {}
        found = [f.get("schedule") for f in planted.get("findings", [])]
        if rc != 1 or found != ["_planted|0|io_fail@result_save=1"]:
            fail(f"chaos: the planted canary: exit {rc}, findings {found} {err[-1500:]}")
        say(f"{tag} the _planted canary found and shrunk to {found[0]} in "
            f"{planted['findings'][0]['shrink_runs']} shrink runs (alongside the soak)")
        out["planted"] = {"schedule": found[0],
                          "shrink_runs": planted["findings"][0]["shrink_runs"]}
        out["legs_wall_s"] = time.perf_counter() - t_legs
        say(f"{tag} selftest, corpus, soak and canary together: {out['legs_wall_s']:.1f} s")
    finally:
        # a failed check exits: no leg outlives the script
        corpus.stop()
        for proc, _ in legs.values():
            if proc.poll() is None:
                kill_tree(proc)
                proc.communicate()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


# ------------------------------------------------------------ the mesh phase
#: the mesh phase (ROADMAP queue 1 item 9a): dp=1 and dp=2 on the one card.
#: One block of MESH_EPOCHS epochs of the train phase's mtss_wgan_gp path
#: (fused critic, B=32, n_critic 5, its seeded windows); the train-gan verb
#: for MESH_CLI_EPOCHS on the committed panel, resumed from ckpt_2, and
#: drained; the lane mesh over MESH_LATENTS lanes (20: dp=2 divides them)
#: and two datasets, MESH_AE_EPOCHS epochs; MultiSeedTrainer over MESH_SEEDS
MESH_EPOCHS = 3
MESH_CLI_EPOCHS, MESH_RESUME_AT, MESH_DRAIN_EPOCHS = 5, 2, 2000
MESH_AE_EPOCHS, MESH_AE_CHUNK, MESH_AE_SEED = 40, 10, 31
MESH_LATENTS = tuple(range(1, 21))
MESH_SEEDS, MESH_SEED_EPOCHS = (11, 12), 3
MESH_DP_ATOL = 1e-5                     # JAX's dp-against-single bar
MESH_TIMEOUT_S = 300.0
#: the window and layer axes (ROADMAP queue 1 item 9b) in the same two
#: rank processes, after (b): one epoch of the block's first draws at full
#: width, then one more timed; pp runs M microbatches a pass.  The bars
#: are JAX's: the pp step against the plain step rtol 1e-4 atol 1e-5
#: (``tests/test_layer_pipeline.py:93-118``), sp against one device atol
#: 1e-4 and the ranks within rtol 1e-6 (``tests/test_distributed.py``),
#: the forwards 2e-5
MESH_PP_MICROBATCHES = 2
AXES_BARS = {"pp": (1e-5, 1e-4), "sp": (1e-4, 0.0)}
AXES_FWD_ATOL, RANKS_RTOL = 2e-5, 1e-6
#: ``train-gan --dp-sp 1x2 --coordinator``: a straight run, and one that
#: stops at MESH_SP_RESUME_AT and is resumed to the same end
MESH_SP_CLI_EPOCHS, MESH_SP_RESUME_AT = 3, 1
#: the hidden-unit axis (ROADMAP queue 1 item 9c) on the same card: (h)
#: tp=2 in the same two rank processes after (g), one epoch of the block's
#: first draws, timed; (i) ``train-gan --dp-tp 1x2 --coordinator``, a
#: straight run and one stopped at MESH_TP_RESUME_AT and resumed; (j)
#: dp×sp×tp 1×2×2 as four rank processes, one epoch (``phase_tile``).  The
#: epoch's bar is JAX's cross-process tp bar, atol 1e-4
#: (``tests/test_distributed.py:663-686``)
MESH_TP_ATOL = 1e-4
MESH_TP_CLI_EPOCHS, MESH_TP_RESUME_AT = 2, 1
MESH_TILE = {"dp": 1, "sp": 2, "tp": 2}
#: the refused configurations lifted (ROADMAP queue 1 items 9d, 9e, 9f), in
#: the same rank processes: (h)'s tp=2 epoch with health on, its five
#: values against the single-device health-on epoch's at the health
#: tests' bars (``tests/test_torch_health.py::test_health_values_match_jax``),
#: then one bf16 tp=2 epoch at the bf16 bars; (g)'s sp=2 epoch of every
#: other family at sp's bars and one bf16 epoch, within sp's bar of the
#: single-device chained bf16 epoch (the chunks run the layers singly, as
#: the chained route does) and at the bf16 bars of the fused one; (d)'s
#: dp=2 padded drive with health on, its gauges against one meshless
#: health-on drive's (the param norm within MESH_AE_PN_RTOL: a sum of the
#: ranks' squares in another order)
MESH_SP_FAMILIES = ("gan", "wgan", "wgan_gp", "mtss_gan", "mtss_wgan")
#: (g)'s bf16 epoch against the single-device chained bf16 epoch: a tenth
#: of the bf16 param bar (BF16_PARAM_BAR, the params being O(1)).  The
#: same layers in the same order, so only the kernels' bf16 rounding
#: differs: the carry and carry-free modes order a step's sums apart, and
#: an h or dz that rounds the other way is carried (the CPU's plain
#: versions, one order: 2.4e-5; sp's float32 bar, 1e-4, is float32's)
AXES_BF16_ATOL = 1e-3
STEP_HEALTH_GAUGES = ("health/g_grad_norm", "health/d_grad_norm", "health/update_norm",
                      "health/param_norm", "health/nonfinite")
HEALTH_ATOL, HEALTH_RTOL = 1e-5, 1e-4
MESH_AE_PN_RTOL = 1e-6
#: the parts of a rank process by the marker each rank writes when it
#: enters one, and the name a failure reports
RANK_PARTS = {"start": "start-up and the process group", "b": "(b) the dp=2 block",
              "f": "(f) pp=2", "g": "(g) sp=2", "h": "(h) tp=2", "d": "(d) the lane drives",
              "e": "(e) the seed mesh", "j": "(j) dp×sp×tp 1×2×2",
              "g2": "(g) sp=2's other families and bf16 epoch", "h16": "(h) tp=2's bf16 epoch",
              "saved": "done, results saved"}
_PORTS_GIVEN: set = set()


def free_port() -> int:
    """A port for a coordinator's store, below the kernel's ephemeral
    range (no outgoing connection is given one there, so the rank that
    binds it later cannot lose it to a gloo connection), free when
    checked, never the same twice in this script."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            low = int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random(os.getpid())
    for _ in range(500):
        port = rng.randrange(max(1024, low - 8000), low)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
    fail(f"no free port below the ephemeral range ({low})")


def mesh_gan_inputs(torch, family: str = "mtss_wgan_gp", dtype: str = "float32"):
    """The train phase's mtss_wgan_gp block: pair, config (B=32, n_critic
    5, MESH_EPOCHS a block), seeded windows, a fresh state and the block's
    draws, all on cuda:0 and the same in every process; ``family`` and
    ``dtype`` replace the model's at the same widths (the same windows,
    and for a WGAN-GP family the same draws)."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import init_gan_state, sample_draws

    cfg = get_preset(TRAIN_PRESETS[0])
    mcfg = dataclasses.replace(cfg.model, family=family, dtype=dtype)
    tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=MESH_EPOCHS)
    g = torch.Generator(device="cuda")
    g.manual_seed(100)
    dataset = torch.rand((1000, mcfg.window, mcfg.features), generator=g, device="cuda")
    pair = build_gan(mcfg, device="cuda")
    state = init_gan_state(0, mcfg, device="cuda")
    draws = [sample_draws(g, pair, tcfg, dataset) for _ in range(2 * MESH_EPOCHS)]
    return pair, tcfg, dataset, state, draws


def axes_inputs(draws, dataset) -> tuple:
    """The forwards' inputs of parts (f) and (g): the first critic
    iteration's noise and the first B windows."""
    z = draws[0].noises[0]
    return z, dataset[:z.shape[0]]


def axes_launches(kind: str, rank: int, n_critic: int, per_pass: int) -> dict:
    """One rank's launches in a pp or sp epoch.  Every pass makes
    ``per_pass`` launches of a kind on a rank (pp: its one layer on each
    of M microbatches; sp: its window chunk of both layers): the fakes'
    pass the primal forward; the 2·n_critic + 2 recorded passes (each
    critic iteration's scores and penalty, the generator update's
    generator and critic) the with_cs forward; backwards for the scores,
    the penalty's first order, its second order through the forward graph
    and the generator update's two passes, plus on the first rank of the
    chain the second order's boundary pass; the adjoint once a penalty.
    pp takes the single-layer kernels, sp their carry modes (the first
    rank from a zero carry)."""
    k, m = n_critic, per_pass
    bwd = (4 * k + 2 if rank == 0 else 3 * k + 2) * m
    names = (("lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "lstm_adj") if kind == "pp" else
             ("lstm_fwd_carry", "lstm_fwd_cs_carry", "lstm_bwd_carry", "lstm_adj_carry"))
    return dict(zip(names, (m, (2 * k + 2) * m, bwd, k * m)))


def sp_family_launches(family: str, rank: int, n_critic: int) -> dict:
    """One sp rank's launches in an epoch of ``family`` (its window chunk
    of both layers a pass, :func:`axes_launches`'s accounting): the
    flagship's :func:`axes_launches`; an MTSS family without a penalty
    has no second order, so every recorded pass has one backward and no
    adjoint runs: the fakes' primal pass, then WGAN's 2·n_critic + 2
    recorded passes (each critic iteration's real and fake scores, the
    generator update's generator and critic) or BCE's four (real, fake,
    the update's generator and critic); a Dense family launches no hand
    kernel."""
    if family == "mtss_wgan_gp":
        return axes_launches("sp", rank, n_critic, 2)
    if not family.startswith("mtss_"):
        return {}
    passes = 4 if family == "mtss_gan" else 2 * n_critic + 2
    return {"lstm_fwd_carry": 2, "lstm_fwd_cs_carry": 2 * passes, "lstm_bwd_carry": 2 * passes}


def tp_reduces(n_critic: int, wc: int, sp: int = 1, sp_rank: int = 0) -> int:
    """A rank's all_reduces in one WGAN-GP epoch of the tp step, two LSTM
    layers on a window (chunk) of ``wc`` steps: a pass gathers h once a
    step and layer; a backward all_reduces the cotangent of each F, one
    a recorded h product (none at a zero carry's first step) and one a
    layer input that needs a gradient; the penalty's second order gathers
    once a slice of its first order.  In a window chain (``sp`` > 1) the
    scores and the norms are summed over sp, the second order also
    reaches the penalty's input, and a rank with a next rank runs the
    boundary pass; the hook reduces once an update
    (``tests/test_torch_tensor.py::tp_reduces``)."""
    lay = 2
    chain = int(sp > 1)
    nxt = int(chain and sp_rank < sp - 1)
    gathers, hprod = lay * wc, lay * (wc - 1 + int(sp_rank > 0))
    critic = (2 * (gathers + chain)                  # the scores' and the penalty's passes
              + hprod + lay + chain                  # the penalty's first order (+ norms)
              + hprod + lay - 1                      # the scores' backward
              + gathers + hprod + lay - 1 + chain    # the second order
              + nxt * (hprod + lay)                  # its boundary pass
              + 1)                                   # the hook
    gen = (2 * gathers                               # the fakes; the update's generator
           + gathers + chain                         # the update's critic
           + hprod + lay                             # its backward (the fake input's F)
           + hprod + lay - 1                         # the generator's (the noise needs none)
           + 1)                                      # the hook
    return n_critic * critic + gen


@contextlib.contextmanager
def timed_host_collectives(torch):
    """Wrap ``send``, ``recv`` and ``all_reduce`` of ``torch.distributed``
    in this process with the host clock (under gloo each blocks the host
    until it ends); yields ``{name: [calls, seconds]}``."""
    import torch.distributed as dist

    spent = {n: [0, 0.0] for n in ("send", "recv", "all_reduce")}
    real = {n: getattr(dist, n) for n in spent}

    def wrap(name):
        def fn(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spent[name][0] += 1
                spent[name][1] += time.perf_counter() - t0
        return fn

    for n in spent:
        setattr(dist, n, wrap(n))
    try:
        yield spent
    finally:
        for n, f in real.items():
            setattr(dist, n, f)


def mesh_axes_part(torch, kind: str) -> dict:
    """(f) pp=2 or (g) sp=2 in a rank process: the forwards on the phase's
    inputs, then one epoch from the phase's state and first draws with its
    launches, weight sums and transfers counted, then a second epoch
    timed alone."""
    from hfrep_tpu_torch.ops import cuda_lstm
    from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, make_pp_train_step,
                                          make_sp_train_step, pp_critic, pp_generate,
                                          sp_critic, sp_generate)
    from hfrep_tpu_torch.parallel import rules

    pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch)
    mesh = build_mesh(MeshSpec(**{kind: 2}))
    z, x = axes_inputs(draws, dataset)
    with torch.no_grad():
        if kind == "pp":
            fwd = {"g": pp_generate(state.generator, z, mesh,
                                    microbatches=MESH_PP_MICROBATCHES),
                   "d": pp_critic(state.discriminator, x, mesh,
                                  microbatches=MESH_PP_MICROBATCHES)}
            step = make_pp_train_step(pair, tcfg, dataset, mesh,
                                      microbatches=MESH_PP_MICROBATCHES)
        else:
            fwd = {"g": sp_generate(state.generator, z, mesh),
                   "d": sp_critic(state.discriminator, x, mesh)}
            step = make_sp_train_step(pair, tcfg, dataset, mesh)
    out = {"coords": mesh.coords(), "fwd": {k: v.cpu() for k, v in fwd.items()}}
    torch.cuda.synchronize()
    cuda_lstm.reset_launches()
    rules.reset_collective_counts()
    with timed_host_collectives(torch) as spent:
        t0 = time.perf_counter()
        state, metrics = step(state, draws[0])
        torch.cuda.synchronize()
        out["first_ms"] = (time.perf_counter() - t0) * 1e3
    out.update(launches=cuda_lstm.launch_counts(), sums=sum_launches_by_shape(cuda_lstm),
               collectives=rules.collective_counts(),
               transfer_s={k: v[1] for k, v in spent.items()},
               params={n: p.detach().cpu().clone() for n, p in state_params(state).items()},
               metrics={k: v.cpu() for k, v in metrics.items()})
    t0 = time.perf_counter()
    step(state, draws[1])
    torch.cuda.synchronize()
    out["ms_per_epoch"] = (time.perf_counter() - t0) * 1e3
    return out


def epoch_doc(torch, state, metrics) -> dict:
    """An epoch's outcome on the host: every parameter by ``g.``/``d.``
    name, the optimizer slots, the metrics."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree

    return {"params": {n: p.detach().cpu().clone() for n, p in state_params(state).items()},
            "slots": host({"g": state.g_opt, "d": state.d_opt}),
            "metrics": {k: v.cpu() for k, v in metrics.items()}}


def counted_epoch(torch, step, state, draws, profiled: bool = False) -> dict:
    """One epoch with every launch, weight sum and collective counted from
    0, on the host clock; with ``profiled`` under ``torch.profiler``
    (:func:`traced`), its recurrence kernels by operand type."""
    from hfrep_tpu_torch.ops import cuda_lstm
    from hfrep_tpu_torch.parallel import rules

    got = {}

    def run():
        t0 = time.perf_counter()
        got["out"] = step(state, draws)
        torch.cuda.synchronize()
        got["ms"] = (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    cuda_lstm.reset_launches()
    rules.reset_collective_counts()
    if profiled:
        prof = traced(torch, lambda: torch.zeros(1, device="cuda").add_(1), run)
        kernels = recurrence_kernels(device_time_by_name(prof))
    else:
        run()
        kernels = None
    doc = epoch_doc(torch, *got["out"])
    doc.update(launches=cuda_lstm.launch_counts(), sums=sum_launches_by_shape(cuda_lstm),
               collectives=rules.collective_counts(), ms=got["ms"], kernels=kernels)
    return doc


def mesh_sp_more(torch, mesh) -> dict:
    """(g)'s other families and its bf16 epoch in a rank process: one sp=2
    epoch of each of MESH_SP_FAMILIES and one bf16 flagship epoch, each
    from the phase's seed state and first draws with its launches counted
    (the MTSS and bf16 epochs profiled for their kernels' operand type)."""
    from hfrep_tpu_torch.parallel import make_sp_train_step

    out = {}
    for family, dtype in [(f, "float32") for f in MESH_SP_FAMILIES] + [("mtss_wgan_gp",
                                                                       "bfloat16")]:
        pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch, family, dtype)
        step = make_sp_train_step(pair, tcfg, dataset, mesh)
        key = family if dtype == "float32" else "bf16"
        out[key] = counted_epoch(torch, step, state, draws[0],
                                 profiled=family.startswith("mtss_"))
    return out


def mesh_tp_bf16(torch, mesh) -> dict:
    """(h)'s bf16 epoch in a rank process: one tp=2 epoch of the bf16
    flagship from the phase's seed state and first draws."""
    from hfrep_tpu_torch.parallel import tensor

    pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch, "mtss_wgan_gp", "bfloat16")
    return counted_epoch(torch, tensor.make_tp_train_step(pair, tcfg, dataset, mesh), state,
                         draws[0])


def mesh_tp_part(torch, mesh, health_on: bool = False) -> dict:
    """(h) tp=2 or (j) dp×sp×tp in a rank process: the forwards on the
    phase's inputs (under sp the generator's window chunk), then one epoch
    from the phase's state and first draws (with ``health_on`` the step
    built with health on: the five ``health_*`` values in its metrics),
    timed, with its launches, weight sums and collectives counted and the
    collectives' host time (every torch op it runs was already run in the
    process: no first-call cost)."""
    from hfrep_tpu_torch.obs import health
    from hfrep_tpu_torch.ops import cuda_lstm
    from hfrep_tpu_torch.parallel import dp_sp_tp, rules, sequence, tensor
    from hfrep_tpu_torch.parallel.chain import Chain

    pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch)
    z, x = axes_inputs(draws, dataset)
    with torch.no_grad():
        if "sp" in mesh.axis_names:
            chain = Chain(mesh, "sp")
            g_apply, d_apply = dp_sp_tp.dp_sp_tp_apply_fns(pair, chain, Chain(mesh, "tp"))
            fwd = {"g": g_apply(state.generator, sequence._my_chunk(chain, z)),
                   "d": d_apply(state.discriminator, sequence._my_chunk(chain, x))}
            step = dp_sp_tp.make_dp_sp_tp_train_step(pair, tcfg, dataset, mesh)
        else:
            fwd = {"g": tensor.tp_generate(state.generator, z, mesh),
                   "d": tensor.tp_critic(state.discriminator, x, mesh)}
            health.configure(health.HealthConfig() if health_on else None)
            try:
                step = tensor.make_tp_train_step(pair, tcfg, dataset, mesh)
            finally:
                health.configure(None)
    out = {"coords": mesh.coords(), "fwd": {k: v.cpu() for k, v in fwd.items()}}
    torch.cuda.synchronize()
    cuda_lstm.reset_launches()
    rules.reset_collective_counts()
    with timed_host_collectives(torch) as spent:
        t0 = time.perf_counter()
        state, metrics = step(state, draws[0])
        torch.cuda.synchronize()
        out["first_ms"] = (time.perf_counter() - t0) * 1e3
    out.update(launches=cuda_lstm.launch_counts(), sums=sum_launches_by_shape(cuda_lstm),
               collectives=rules.collective_counts(),
               transfer_s={k: v[1] for k, v in spent.items()},
               params={n: p.detach().cpu().clone() for n, p in state_params(state).items()},
               metrics={k: v.cpu() for k, v in metrics.items()})
    return out


def mesh_tile_rank(rank: int, out_dir: str) -> None:
    """One rank of (j)'s four rank processes on the one card (gloo, a
    file store under ``out_dir``): the dp×sp×tp 1×2×2 part
    (:func:`mesh_tp_part`), written to ``out_dir/rank<rank>.pt``."""
    import torch

    from hfrep_tpu_torch.parallel import (initialize_distributed, make_mesh_3d,
                                          shutdown_distributed)

    part = rank_marker(out_dir, rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    part("start")
    n = math.prod(MESH_TILE.values())
    backend = initialize_distributed("file://" + os.path.join(out_dir, "store"), n, rank)
    try:
        part("j")
        out = mesh_tp_part(torch, make_mesh_3d(*MESH_TILE.values()))
        out["backend"] = backend
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        part("saved")
    finally:
        shutdown_distributed()


def rank_marker(out_dir: str, rank: int):
    """``part(name)``: write the part a rank process enters to
    ``out_dir/rank<rank>.part`` (a key of :data:`RANK_PARTS`)."""
    def part(name: str) -> None:
        with open(os.path.join(out_dir, f"rank{rank}.part"), "w") as fh:
            fh.write(name)
    return part


def mesh_ae_inputs(torch):
    """The lane drives' inputs: the committed panel's scaled train block,
    a ragged second dataset (24 rows shorter) for the multi drive, the
    config."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.core import scaler
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.replication import engine

    panel = load_panel(os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR),
                       device="cpu")
    xs = scaler.fit_transform(panel.train_test_split()[0])[1]
    stack, rows = engine.stack_padded([xs, xs[:xs.shape[0] - 24]])
    cfg = AEConfig(epochs=MESH_AE_EPOCHS, chunk_epochs=MESH_AE_CHUNK)
    return xs, stack, rows, cfg


def mesh_lane_drives(torch, meshes: dict) -> dict:
    """The padded lane drive and the multi drive on cuda:0, each on its
    mesh in ``meshes`` (None: meshless): each result's arrays on the host."""
    from hfrep_tpu_torch.replication import engine

    xs, stack, rows, cfg = mesh_ae_inputs(torch)
    out = {}
    for name, run in (("padded", lambda m: engine.sweep_autoencoders_padded(
                          MESH_AE_SEED, xs, xs.shape[0], cfg, MESH_LATENTS, device="cuda",
                          mesh=m)),
                      ("multi", lambda m: engine.sweep_autoencoders_multi(
                          MESH_AE_SEED, stack, rows, cfg, MESH_LATENTS, device="cuda",
                          mesh=m))):
        res, stats = run(meshes[name])
        arrays = {f"param_{k}": v.cpu() for k, v in res.params.items()}
        arrays.update(stop_epoch=res.stop_epoch.cpu(), train_loss=res.train_loss.cpu(),
                      val_loss=res.val_loss.cpu())
        out[name] = {"arrays": arrays, "chunks": stats.chunks_dispatched,
                     "epochs": stats.epochs_dispatched}
    return out


def mesh_health_drive(torch, mesh, obs_dir: str) -> dict:
    """(d)'s padded drive with health on, under a telemetry session at
    ``obs_dir``: its arrays on the host and the ``health/ae_*`` gauges its
    stream holds, ``(name, value, epoch)`` in order."""
    from hfrep_tpu_torch import obs as obs_pkg
    from hfrep_tpu_torch.obs import health
    from hfrep_tpu_torch.replication import engine

    xs, _, _, cfg = mesh_ae_inputs(torch)
    health.configure(health.HealthConfig())
    try:
        with obs_pkg.session(obs_dir, command="chip_smoke"):
            res, _ = engine.sweep_autoencoders_padded(MESH_AE_SEED, xs, xs.shape[0], cfg,
                                                      MESH_LATENTS, device="cuda", mesh=mesh)
    finally:
        health.configure(None)
    arrays = {f"param_{k}": v.cpu() for k, v in res.params.items()}
    arrays.update(stop_epoch=res.stop_epoch.cpu(), train_loss=res.train_loss.cpu(),
                  val_loss=res.val_loss.cpu())
    gauges = [(r["name"], r["value"], r["epoch"]) for r in stream_records(obs_dir)
              if r.get("kind") == "gauge" and r.get("name", "").startswith("health/ae_")]
    return {"arrays": arrays, "gauges": gauges}


def mesh_seed_members(torch, mesh) -> dict:
    """MultiSeedTrainer over MESH_SEEDS on the committed panel (W=48,
    spc 2, MESH_SEED_EPOCHS epochs: a block and a remainder epoch): the
    members this process holds, each's parameters on the host."""
    from hfrep_tpu_torch.train.multi_seed import MultiSeedTrainer

    cfg, ds = mesh_seed_config(torch)
    ms = MultiSeedTrainer(cfg, ds, MESH_SEEDS, mesh=mesh, device="cuda")
    ms.train(MESH_SEED_EPOCHS)
    return {i: {n: p.detach().cpu() for n, p in state_params(m.state).items()}
            for i, m in ms.members.items()}


def mesh_seed_config(torch):
    """The multi-seed check's preset (spc 2) and committed-panel dataset."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel

    cfg = get_preset(TRAIN_PRESETS[0])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps_per_call=2))
    panel = load_panel(os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR),
                       device="cuda")
    return cfg, build_gan_dataset(cfg.data, cfg.data.seed, panel)


def state_params(state) -> dict:
    """Every parameter of a GAN state by ``g.``/``d.`` name."""
    return {**{f"g.{n}": p for n, p in state.generator.named_parameters()},
            **{f"d.{n}": p for n, p in state.discriminator.named_parameters()}}


@contextlib.contextmanager
def timed_all_reduce(torch):
    """Wrap ``torch.distributed.all_reduce`` in this process so each call
    is bracketed by CUDA events on the current stream; yields the list of
    (start, end) event pairs, read after the caller synchronises."""
    import torch.distributed as dist

    spans, real = [], dist.all_reduce

    def all_reduce(tensor, *args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        work = real(tensor, *args, **kwargs)
        end.record()
        spans.append((start, end))
        return work

    dist.all_reduce = all_reduce
    try:
        yield spans
    finally:
        dist.all_reduce = real


def mesh_rank(rank: int, out_dir: str) -> None:
    """One rank of the mesh phase's two rank processes on the one card
    (gloo, a file store under ``out_dir``): (b) the dp=2 GAN block on its
    16 rows, its own launch counts and collectives, then a second block
    timed; (f) pp=2 and (g) sp=2 (:func:`mesh_axes_part`); (h) tp=2
    (:func:`mesh_tp_part`); (d) the lane drives on ``lane_mesh``; (e)
    MultiSeedTrainer on the two-rank seed mesh.  The part it is in goes to ``out_dir/rank<rank>.part``, every
    result to ``out_dir/rank<rank>.pt``, read by the parent."""
    import torch

    from hfrep_tpu_torch.ops import cuda_lstm
    from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                          lane_mesh, make_gan_multi_step,
                                          shutdown_distributed)
    from hfrep_tpu_torch.parallel import rules
    from hfrep_tpu_torch.train.multi_seed import seed_mesh

    part = rank_marker(out_dir, rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    part("start")
    backend = initialize_distributed("file://" + os.path.join(out_dir, "store"), 2, rank)
    try:
        part("b")
        mesh = build_mesh(MeshSpec(dp=2))
        pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch)
        block = make_gan_multi_step(pair, tcfg, dataset, mesh)
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        rules.reset_collective_counts()
        state, metrics = block(state, draws=draws[:MESH_EPOCHS])
        torch.cuda.synchronize()
        out = {"backend": backend, "device": str(mesh.device),
               "launches": cuda_lstm.launch_counts(),
               "sums": sum_launches_by_shape(cuda_lstm),
               "collectives": rules.collective_counts(),
               "params": {n: p.detach().cpu() for n, p in state_params(state).items()},
               "metrics": {k: v.cpu() for k, v in metrics.items()}}
        rules.reset_collective_counts()
        with timed_all_reduce(torch) as spans:
            t0 = time.perf_counter()
            block(state, draws=draws[MESH_EPOCHS:])
            torch.cuda.synchronize()
            out["ms_per_epoch"] = (time.perf_counter() - t0) / MESH_EPOCHS * 1e3
        out["reduce_ms_per_epoch"] = sum(a.elapsed_time(b) for a, b in spans) / MESH_EPOCHS
        out["reduces_per_epoch"] = rules.collective_counts()["all_reduce"] / MESH_EPOCHS
        for kind, name in (("pp", "f"), ("sp", "g")):
            part(name)
            out[kind] = mesh_axes_part(torch, kind)
        part("h")
        tp_mesh = build_mesh(MeshSpec(tp=2))
        out["tp"] = mesh_tp_part(torch, tp_mesh, health_on=True)
        # timed alone on the card: the parent starts the verb runs after this
        open(os.path.join(out_dir, f"rank{rank}.timed"), "w").close()
        part("d")
        lanes = {"padded": lane_mesh(len(MESH_LATENTS)), "multi": lane_mesh(2)}
        out["lane_dp"] = {k: m.shape["dp"] for k, m in lanes.items()}
        out["lanes"] = mesh_lane_drives(torch, lanes)
        out["lanes_health"] = mesh_health_drive(torch, lanes["padded"],
                                                os.path.join(out_dir, f"obs_rank{rank}"))
        part("e")
        seeds = seed_mesh(len(MESH_SEEDS))
        out["seed_mesh"] = None if seeds is None else seeds.shape
        out["members"] = mesh_seed_members(torch, seeds)
        part("g2")
        out["sp_more"] = mesh_sp_more(torch, build_mesh(MeshSpec(sp=2)))
        part("h16")
        out["tp_bf16"] = mesh_tp_bf16(torch, tp_mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        part("saved")
    finally:
        shutdown_distributed()


def start_ranks(out_dir: str, n: int = 2, entry: str = "mesh_rank") -> list:
    """``n`` rank processes running ``chip_smoke.<entry>``, started
    together (the mesh phase's two, or (j)'s four)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_FAULTS", "HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_HEALTH")}
    env["PYTHONPATH"] = root
    code = f"import sys, chip_smoke; chip_smoke.{entry}(int(sys.argv[1]), sys.argv[2])"
    return [(subprocess.Popen([sys.executable, "-c", code, str(r), out_dir],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, start_new_session=True),
             time.perf_counter())
            for r in range(n)]


def rank_part(out_dir: str, rank: int) -> str:
    """The name of the part a rank process last entered."""
    try:
        with open(os.path.join(out_dir, f"rank{rank}.part")) as fh:
            key = fh.read().strip() or "start"
    except OSError:
        return "before start"
    return RANK_PARTS.get(key, key)


def finish_ranks(ranks: list, out_dir: str, deadline: float) -> list:
    """Wait for the rank processes until ``deadline`` (perf_counter):
    ``[(exit code, stdout, stderr)]``.  On a failure or an overrun kill
    them all, then fail naming the part each rank was in and the tail of
    each one's stderr."""
    done = {}
    for r, (proc, _) in enumerate(ranks):
        try:
            text, err = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            break
        done[r] = (proc.returncode, text, err)
        if proc.returncode != 0:
            break
    if len(done) == len(ranks) and all(rc == 0 for rc, _, _ in done.values()):
        return [done[r] for r in range(len(ranks))]
    report = []
    for r, (proc, _) in enumerate(ranks):
        if r in done:
            rc, _, err = done[r]
            what = f"exit {rc}"
        else:
            overran = proc.poll() is None
            kill_tree(proc)
            _, err = proc.communicate()
            what = "killed at the deadline" if overran else f"exit {proc.returncode}"
        report.append(f"rank {r} ({what}, in part {rank_part(out_dir, r)}): stderr tail "
                      f"{err[-2500:]!r}")
    fail("mesh: the rank processes failed: " + "; ".join(report))


def start_cli_pair(args: list, obs_dir=None, env_extra=None) -> list:
    """``train-gan ARGS`` as two ranks over a fresh coordinator port."""
    port = free_port()
    extra = ["--obs-dir", obs_dir] if obs_dir else []
    return [start_module("hfrep_tpu_torch", ["train-gan", *args, *extra, "--coordinator",
                                             f"127.0.0.1:{port}", "--num-processes", 2,
                                             "--process-id", r], env_extra) for r in (0, 1)]


def ckpt_generator(torch, path: str) -> dict:
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    return {k: v.cpu() for k, v in ckpt.restore(path)["state"]["generator"].items()}


def tree_max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def tree_equal(torch, a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        torch.equal(torch.nan_to_num(a[k], nan=7.0), torch.nan_to_num(b[k], nan=7.0))
        if a[k].is_floating_point() else torch.equal(a[k], b[k]) for k in a)


def check_axes_part(torch, kind: str, docs: list, ref_fwd: dict, ref_p: dict, ref_m: dict,
                    n_critic: int, card: str) -> dict:
    """(f) or (g) read in the parent: each rank's forwards within
    AXES_FWD_ATOL of the single-device forwards (under sp its window chunk
    of the generator's), its epoch within the axis's bars of the
    single-device epoch, its launches exactly :func:`axes_launches` with
    the weight sums they make and no other kernel; the ranks within
    RANKS_RTOL of each other."""
    part = {"pp": "(f) pp=2", "sp": "(g) sp=2"}[kind]
    atol, rtol = AXES_BARS[kind]
    per_pass = MESH_PP_MICROBATCHES if kind == "pp" else 2      # sp: both layers' chunks
    diffs, fwd_errs = [], []
    for r, doc in enumerate(docs):
        g_ref = ref_fwd["g"]
        if kind == "sp":
            w = g_ref.shape[1] // 2
            g_ref = g_ref[:, doc["coords"]["sp"] * w:(doc["coords"]["sp"] + 1) * w]
        fwd_err = max(float((doc["fwd"]["g"] - g_ref).abs().max()),
                      float((doc["fwd"]["d"] - ref_fwd["d"]).abs().max()))
        if not fwd_err <= AXES_FWD_ATOL:
            fail(f"mesh {part}: rank {r}'s forwards are {fwd_err} from the single-device "
                 f"forwards (bar {AXES_FWD_ATOL})")
        err = max([allclose_err(doc["params"][n], ref_p[n], atol, rtol) for n in ref_p]
                  + [allclose_err(doc["metrics"][k], ref_m[k], atol, rtol) for k in ref_m])
        diff = max(tree_max_diff(doc["params"], ref_p), tree_max_diff(doc["metrics"], ref_m))
        if not err <= 1.0:
            fail(f"mesh {part}: rank {r}'s epoch is {diff} from the single-device epoch "
                 f"(bars atol {atol}, rtol {rtol}: {err} of the bar)")
        check_route_launches(f"mesh {part} rank {r}", doc["launches"], doc["sums"],
                             axes_launches(kind, r, n_critic, per_pass), 1)
        diffs.append(diff)
        fwd_errs.append(fwd_err)
    a, b = docs
    if not all(torch.allclose(b[t][k], a[t][k], rtol=RANKS_RTOL, atol=0)
               for t in ("params", "metrics") for k in a[t]):
        fail(f"mesh {part}: the ranks differ beyond rtol {RANKS_RTOL}")
    same = tree_equal(torch, a["params"], b["params"]) and tree_equal(torch, a["metrics"],
                                                                      b["metrics"])
    say(f"[mesh] {part}, two ranks on the one card, one epoch at full width (B=32, "
        f"n_critic {n_critic}, f32) from the phase's state and first draws: within "
        f"{max(diffs):.3g} of the single-device epoch (bars atol {atol}, rtol {rtol}), the "
        f"forwards within {max(fwd_errs):.3g} (bar {AXES_FWD_ATOL}), the ranks "
        + ("bit-equal" if same else f"within rtol {RANKS_RTOL}") + "; launches, each rank: "
        + "; ".join(", ".join(f"{n} {c}" for n, c in d["launches"].items() if c) for d in docs)
        + f"; weight sums {[sum(d['sums'].values()) for d in docs]}; transfers, each rank: "
        + "; ".join(", ".join(f"{n} {d['collectives'][n]} ({1e3 * d['transfer_s'][n]:.1f} ms)"
                              for n in ("send", "recv", "all_reduce")) for d in docs)
        + f" (host clock); epoch ms {[round(d['first_ms'], 1) for d in docs]} first, "
        f"{[round(d['ms_per_epoch'], 1) for d in docs]} the next (host clock) on {card}")
    return {"max_abs_diff": max(diffs), "fwd_max_abs_err": max(fwd_errs), "ranks_bit_equal": same,
            "launches": [d["launches"] for d in docs], "sums": [d["sums"] for d in docs],
            "collectives": [d["collectives"] for d in docs],
            "transfer_s": [d["transfer_s"] for d in docs],
            "first_ms": [d["first_ms"] for d in docs],
            "ms_per_epoch": [d["ms_per_epoch"] for d in docs]}


def check_tp_part(torch, part: str, docs: list, ref_fwd: dict, ref_p: dict, ref_m: dict,
                  n_critic: int, card: str) -> dict:
    """(h) or (j) read in the parent: each rank's forwards within
    AXES_FWD_ATOL of the single-device forwards (under sp its window chunk
    of the generator's), its epoch within MESH_TP_ATOL of the
    single-device epoch, no hand kernel and no weight sum launched, its
    all_reduces exactly :func:`tp_reduces` (and under sp the chain's
    transfers as sp's); the ranks of each tp group bit-equal, and every
    rank within RANKS_RTOL of the first."""
    diffs, fwd_errs = [], []
    for r, doc in enumerate(docs):
        coords = doc["coords"]
        sp, k = int(MESH_TILE["sp"] if "sp" in coords else 1), coords.get("sp", 0)
        g_ref = ref_fwd["g"]
        if sp > 1:
            w = g_ref.shape[1] // sp
            g_ref = g_ref[:, k * w:(k + 1) * w]
        fwd_err = max(float((doc["fwd"]["g"] - g_ref).abs().max()),
                      float((doc["fwd"]["d"] - ref_fwd["d"]).abs().max()))
        if not fwd_err <= AXES_FWD_ATOL:
            fail(f"mesh {part}: rank {r}'s forwards are {fwd_err} from the single-device "
                 f"forwards (bar {AXES_FWD_ATOL})")
        diff = max(tree_max_diff(doc["params"], ref_p),
                   tree_max_diff({k: doc["metrics"][k] for k in ref_m}, ref_m))
        if not diff <= MESH_TP_ATOL:
            fail(f"mesh {part}: rank {r}'s epoch is {diff} from the single-device epoch "
                 f"(bar atol {MESH_TP_ATOL})")
        if any(doc["launches"].values()) or any(doc["sums"].values()):
            fail(f"mesh {part}: rank {r} launched {doc['launches']}, weight sums "
                 f"{doc['sums']}: a tp rank runs no hand kernel")
        c = doc["collectives"]
        want = tp_reduces(n_critic, ref_fwd["g"].shape[1] // sp, sp, k)
        passes = 1 + 2 * n_critic + 2
        moves = passes + (2 * n_critic + 2) + 2 * n_critic if sp > 1 else 0
        if c["all_reduce"] != want or c["send"] + c["recv"] != moves:
            fail(f"mesh {part}: rank {r}'s collectives {c}, expected {want} all_reduces and "
                 f"{moves} sends and receives")
        diffs.append(diff)
        fwd_errs.append(fwd_err)
    a = docs[0]
    if not all(torch.allclose(d[t][k], a[t][k], rtol=RANKS_RTOL, atol=0)
               for d in docs[1:] for t in ("params", "metrics") for k in a[t]):
        fail(f"mesh {part}: the ranks differ beyond rtol {RANKS_RTOL}")
    groups: dict = {}
    for d in docs:
        groups.setdefault(tuple(v for n, v in d["coords"].items() if n != "tp"), []).append(d)
    for group in groups.values():
        for d in group[1:]:
            if not (tree_equal(torch, d["params"], group[0]["params"])
                    and tree_equal(torch, d["metrics"], group[0]["metrics"])):
                fail(f"mesh {part}: the ranks of one tp group differ")
    same = all(tree_equal(torch, d["params"], a["params"]) for d in docs[1:])
    say(f"[mesh] {part}, {len(docs)} ranks on the one card, one epoch at full width (B=32, "
        f"n_critic {n_critic}, H=100, f32) from the phase's state and first draws: within "
        f"{max(diffs):.3g} of the single-device epoch (bar atol {MESH_TP_ATOL}), the forwards "
        f"within {max(fwd_errs):.3g} (bar {AXES_FWD_ATOL}), the ranks "
        + ("bit-equal" if same else f"within rtol {RANKS_RTOL}, each tp group bit-equal")
        + "; no hand kernel, no weight sum; collectives, each rank: "
        + "; ".join(", ".join(f"{n} {d['collectives'][n]} ({1e3 * d['transfer_s'][n]:.1f} ms)"
                              for n in ("send", "recv", "all_reduce") if d["collectives"][n])
                    for d in docs)
        + f" (host clock); epoch ms {[round(d['first_ms'], 1) for d in docs]} (host clock) "
        f"on {card}")
    return {"max_abs_diff": max(diffs), "fwd_max_abs_err": max(fwd_errs), "ranks_bit_equal": same,
            "collectives": [d["collectives"] for d in docs],
            "transfer_s": [d["transfer_s"] for d in docs],
            "ms_per_epoch": [d["first_ms"] for d in docs]}


def check_axes_verb(torch, part: str, name: str, mesh: dict, dirs: dict, runs: dict,
                    resume: list, epochs: int, resume_at: int, card: str) -> dict:
    """``train-gan --dp-sp 1x2`` or ``--dp-tp 1x2`` with ``--coordinator``
    (runs ``<name>_straight``, ``<name>_half``): the straight run and the
    one stopped at ``resume_at`` exited 0 (checked with (c)'s), the resume
    exits 0, rank 0 alone prints and writes, the ranks' group is gloo over
    ``mesh``, and the resumed run's last checkpoint is bit-equal to the
    straight run's."""
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    straight, half = f"{name}_straight", f"{name}_half"
    resumed = [finish_module(p, MESH_TIMEOUT_S) for p in resume]
    if any(rc != 0 for rc, *_ in resumed):
        fail(f"mesh {part}: the --resume run exited "
             f"{[rc for rc, *_ in resumed]}: {[e[-1500:] for _, _, e, _ in resumed]}")
    if "resumed from" not in resumed[0][1] or resumed[1][1].strip():
        fail(f"mesh {part}: the resume printed {resumed[0][1][-300:]!r} on rank 0 and "
             f"{resumed[1][1][-300:]!r} on rank 1")
    last = f"ckpt_{epochs}"
    a = ckpt.restore(os.path.join(dirs[straight], last))["state"]
    b = ckpt.restore(os.path.join(dirs[half], last))["state"]
    for net in ("generator", "discriminator"):
        if not tree_equal(torch, {k: v.cpu() for k, v in a[net].items()},
                          {k: v.cpu() for k, v in b[net].items()}):
            fail(f"mesh {part}: the resumed run's {net} differs from the straight run's")
    writes = {}
    for r in (0, 1):
        recs = stream_records(os.path.join(dirs[straight] + "_obs", f"proc{r}"))
        writes[r] = sum(1 for x in recs if x.get("name") == "checkpoint"
                        and x.get("type") == "span")
        build = [x for x in recs if x.get("name") == "parallel_build"]
        if not build or build[0].get("backend") != "gloo" or build[0].get("mesh") != mesh:
            fail(f"mesh {part}: rank {r}'s parallel_build events {build}")
    if writes[0] < 1 or writes[1] != 0:
        fail(f"mesh {part}: checkpoint spans by rank {writes}: rank 0 alone must write")
    walls = {k: [round(w, 1) for *_, w in runs[k]] for k in (straight, half)}
    walls["resume"] = [round(w, 1) for *_, w in resumed]
    say(f"[mesh] {part} --coordinator, 2 ranks, {epochs} epochs on the committed panel: exit 0 "
        f"and 0, gloo over {mesh}, rank 0 alone wrote ({writes[0]} checkpoint spans, rank 1 "
        f"none) and printed; --resume from ckpt_{resume_at} bit-equal to the straight run "
        f"(generator and critic); walls {walls} s on {card}")
    return {"resume_bit_equal": True, "checkpoint_spans": writes, "walls_s": walls}


def phase_mesh(torch, np, cuda_lstm, train, keep: str) -> dict:
    """Data parallelism on the one card (ROADMAP queue 1 item 9a): the
    training kernels at a rank's B=16; (a) a one-device mesh block bit-equal
    to the meshless one, the fused route's launches, no collective; (b) dp=2
    as two processes (gloo) within MESH_DP_ATOL of the single-device block,
    the ranks bit-equal; (c) ``train-gan --coordinator`` as two ranks: exit
    0, rank 0 alone writing checkpoints and printing, within MESH_DP_ATOL of
    one process, a resume from ckpt_2 bit-equal, a SIGTERM to one rank
    draining both into exit 75 with a checkpoint; (d) the lane drives with a
    lane mesh bit-equal to the meshless ones at dp=1 and dp=2; (e)
    MultiSeedTrainer's members bit-equal to standalone GanTrainer runs, in
    turn and as a two-rank seed mesh.  The window and layer axes (item 9b)
    in the same rank processes: (f) pp=2 and (g) sp=2, one epoch each
    against the single-device epoch (:func:`check_axes_part`), and
    ``train-gan --dp-sp 1x2`` with its resume (:func:`check_axes_verb`).
    The hidden-unit axis (item 9c): (h) tp=2 in the same rank processes,
    one epoch against the single-device epoch (:func:`check_tp_part`);
    (i) is :class:`DpTpVerb` and (j) :func:`phase_tile`."""
    import signal

    from hfrep_tpu_torch.parallel import MeshSpec, build_mesh, lane_mesh, make_gan_multi_step
    from hfrep_tpu_torch.parallel import rules
    from hfrep_tpu_torch.train import make_multi_step
    from hfrep_tpu_torch.train.trainer import GanTrainer

    tag = "[mesh]"
    card = card_line(torch)
    t_phase = time.perf_counter()
    out: dict = {}
    ranks_dir = os.path.join(keep, "mesh_ranks")
    os.makedirs(ranks_dir)
    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    cli = ["--preset", TRAIN_PRESETS[0], "--cleaned-dir", cleaned, "--quiet"]
    dirs = {k: os.path.join(keep, f"mesh_cli_{k}")
            for k in ("single", "dp2", "half", "drain", "sp_straight", "sp_half")}
    procs: dict = {}
    try:
        # the four training kernels at a rank's rows, before any trajectory
        grad = phase_grad_parity(torch, cuda_lstm, shapes=SHAPES[:1], batches=(MESH_BATCH,),
                                 tag="mesh")
        from hfrep_tpu_torch.ops import cuda_lstm_stack
        stack = phase_stack_parity(torch, cuda_lstm_stack, shapes=SHAPES[:1],
                                   batches=(MESH_BATCH,), tag="mesh")
        out["kernels_b16"] = {"lstm_bwd": grad["scaled"]["lstm_bwd"],
                              "lstm_adj": grad["scaled"]["lstm_adj"],
                              "stack_bwd": stack["scaled"]["stack_bwd"],
                              "stack_adj": stack["scaled"]["stack_adj"]}
        say(f"{tag} B={MESH_BATCH} (a rank's rows at dp=2): lstm_bwd, lstm_adj, stack_bwd, "
            f"stack_adj within their bars against their plain versions (scaled max err "
            + ", ".join(f"{k} {v['float32']:.2e} / {v['bfloat16']:.2e}"
                        for k, v in out["kernels_b16"].items()) + " f32 / bf16)")

        # (a) the one-device mesh against the meshless block, same state and draws
        per_epoch = next(r for r in train if r["preset"] == TRAIN_PRESETS[0])["launches_per_epoch"]
        pair, tcfg, dataset, state0, draws = mesh_gan_inputs(torch)
        blocks = {"meshless": make_multi_step(pair, tcfg, dataset),
                  "dp1": make_gan_multi_step(pair, tcfg, dataset, build_mesh(MeshSpec(dp=1)))}
        results, ms = {}, {}
        for name, block in blocks.items():
            state = state0.to("cuda")
            torch.cuda.synchronize()
            cuda_lstm.reset_launches()
            rules.reset_collective_counts()
            state, metrics = block(state, draws=draws[:MESH_EPOCHS])
            torch.cuda.synchronize()
            launches, sums = cuda_lstm.launch_counts(), sum_launches_by_shape(cuda_lstm)
            collectives = rules.collective_counts()
            check_route_launches(f"mesh ({name})", launches, sums, per_epoch, MESH_EPOCHS)
            if sum(sums.values()) != SUM_LAUNCHES_PER_EPOCH * MESH_EPOCHS:
                fail(f"mesh ({name}): {sum(sums.values())} weight sums in {MESH_EPOCHS} epochs")
            if any(v for v in collectives.values()):
                fail(f"mesh ({name}): a one-device block ran collectives {collectives}")
            t0 = time.perf_counter()
            block(state.to("cuda"), draws=draws[MESH_EPOCHS:])
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) / MESH_EPOCHS * 1e3
            results[name] = ({n: p.detach().cpu() for n, p in state_params(state).items()},
                             {k: v.cpu() for k, v in metrics.items()}, launches, sums)
        single_p, single_m, _, _ = results["meshless"]
        if not (tree_equal(torch, results["dp1"][0], single_p)
                and tree_equal(torch, results["dp1"][1], single_m)):
            fail(f"mesh (a): the dp=1 block differs from the meshless one: params "
                 f"{tree_max_diff(results['dp1'][0], single_p)}, metrics "
                 f"{tree_max_diff(results['dp1'][1], single_m)}")
        say(f"{tag} (a) dp=1 mesh block ({MESH_EPOCHS} epochs) bit-equal to the meshless one "
            f"(params, metrics); launches per epoch the fused route's "
            + ", ".join(f"{n} {c / MESH_EPOCHS:g}" for n, c in results["dp1"][2].items() if c)
            + f", {SUM_LAUNCHES_PER_EPOCH} weight sums; collectives 0; ms/epoch meshless "
            f"{ms['meshless']:.2f}, dp=1 {ms['dp1']:.2f} (host clock) on {card}")
        out["a"] = {"bit_equal": True, "launches": results["dp1"][2],
                    "weight_sum_launches": results["dp1"][3], "ms_per_epoch": ms}

        # (f), (g)'s reference: the single-device epoch (fused route) and
        # the forwards from the phase's state and first draws
        ref_fwd, ref_p, ref_m, n_critic, more = mesh_reference(torch, more=True)

        # the rank processes; their dp=2 block, pp, sp and tp epochs are
        # timed before the verb runs start, with nothing else on the card
        procs["ranks"] = start_ranks(ranks_dir)
        rank_deadline = time.perf_counter() + MESH_TIMEOUT_S
        while not all(os.path.exists(os.path.join(ranks_dir, f"rank{r}.timed")) for r in (0, 1)):
            if time.perf_counter() > rank_deadline or any(p.poll() is not None
                                                          for p, _ in procs["ranks"]):
                break                   # the rank's exit is reported below
            time.sleep(0.25)
        procs["single"] = [start_module("hfrep_tpu_torch", [
            "train-gan", *cli, "--epochs", MESH_CLI_EPOCHS, "--checkpoint-dir", dirs["single"]])]
        procs["dp2"] = start_cli_pair([*cli, "--epochs", MESH_CLI_EPOCHS, "--checkpoint-dir",
                                       dirs["dp2"]], obs_dir=dirs["dp2"] + "_obs")
        procs["half"] = start_cli_pair([*cli, "--epochs", MESH_RESUME_AT, "--checkpoint-dir",
                                        dirs["half"]])
        procs["drain"] = start_cli_pair([*cli, "--epochs", MESH_DRAIN_EPOCHS,
                                         "--checkpoint-dir", dirs["drain"]],
                                        obs_dir=dirs["drain"] + "_obs")
        sp_cli = [*cli, "--dp-sp", "1x2"]
        procs["sp_straight"] = start_cli_pair(
            [*sp_cli, "--epochs", MESH_SP_CLI_EPOCHS, "--checkpoint-dir", dirs["sp_straight"]],
            obs_dir=dirs["sp_straight"] + "_obs")
        procs["sp_half"] = start_cli_pair([*sp_cli, "--epochs", MESH_SP_RESUME_AT,
                                           "--checkpoint-dir", dirs["sp_half"]])

        # (d) the lane drives at dp=1, in this process
        meshless = mesh_lane_drives(torch, {"padded": None, "multi": None})
        dp1 = mesh_lane_drives(torch, {"padded": lane_mesh(len(MESH_LATENTS)),
                                       "multi": lane_mesh(2)})
        for k in meshless:
            if not tree_equal(torch, dp1[k]["arrays"], meshless[k]["arrays"]):
                fail(f"mesh (d): the {k} drive on a dp=1 lane mesh differs from the meshless one")
        health_ref = mesh_health_drive(torch, None, os.path.join(keep, "mesh_health_obs"))
        say(f"{tag} (d) dp=1 lane mesh: padded ({len(MESH_LATENTS)} lanes) and multi (2 x "
            f"{len(MESH_LATENTS)} lanes), {MESH_AE_EPOCHS} epochs, bit-equal to the meshless "
            f"drives; chunks {meshless['padded']['chunks']} and {meshless['multi']['chunks']}")

        # the drain: SIGTERM to rank 1 once its trainer has annotated its run
        # (the drain handler is up from the drive envelope on), before the
        # 2000-epoch run competes with the rest of the phase
        manifest = os.path.join(dirs["drain"] + "_obs", "proc1", "run.json")
        deadline = time.perf_counter() + MESH_TIMEOUT_S
        while not (os.path.exists(manifest) and "mesh" in open(manifest).read()):
            if time.perf_counter() > deadline or procs["drain"][1][0].poll() is not None:
                fail("mesh (c): the drained run's rank 1 never started training")
            time.sleep(0.25)
        procs["drain"][1][0].send_signal(signal.SIGTERM)

        # (e) the members in turn against standalone trainers
        cfg, ds = mesh_seed_config(torch)
        alone = {}
        for i, seed in enumerate(MESH_SEEDS):
            tr = GanTrainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                               seed=seed)),
                            ds, device="cuda")
            tr.train(MESH_SEED_EPOCHS)
            alone[i] = {n: p.detach().cpu() for n, p in state_params(tr.state).items()}
        in_turn = mesh_seed_members(torch, None)
        if not all(tree_equal(torch, in_turn[i], alone[i]) for i in alone):
            fail("mesh (e): a MultiSeedTrainer member differs from its standalone GanTrainer")
        say(f"{tag} (e) MultiSeedTrainer K={len(MESH_SEEDS)} on one card ({MESH_SEED_EPOCHS} "
            f"epochs): each member bit-equal to GanTrainer(seed={list(MESH_SEEDS)}[k])")

        # (c)'s resumes, each as soon as the run it resumes has ended
        runs = {}
        for name, resume, argv, epochs in (
                ("half", "resume", cli, MESH_CLI_EPOCHS),
                ("sp_half", "sp_resume", sp_cli, MESH_SP_CLI_EPOCHS)):
            runs[name] = [finish_module(p, MESH_TIMEOUT_S) for p in procs[name]]
            if any(rc != 0 for rc, *_ in runs[name]):
                fail(f"mesh (c): train-gan ({name}) exited "
                     f"{[rc for rc, *_ in runs[name]]}: {[e[-1500:] for _, _, e, _ in runs[name]]}")
            procs[resume] = start_cli_pair([*argv, "--epochs", epochs, "--checkpoint-dir",
                                            dirs[name], "--resume"])

        # (b), (f), (g), (d) and (e): the two rank processes
        finish_ranks(procs["ranks"], ranks_dir, rank_deadline)
        ranks = [torch.load(os.path.join(ranks_dir, f"rank{r}.pt")) for r in (0, 1)]
        for r, doc in enumerate(ranks):
            if doc["backend"] != "gloo" or doc["device"] != "cuda:0":
                fail(f"mesh (b): rank {r} ran {doc['backend']} on {doc['device']}")
            check_route_launches(f"mesh (b) rank {r}", doc["launches"], doc["sums"], per_epoch,
                                 MESH_EPOCHS)
            if sum(doc["sums"].values()) != SUM_LAUNCHES_PER_EPOCH * MESH_EPOCHS:
                fail(f"mesh (b) rank {r}: weight sums {doc['sums']}")
            dp = max(tree_max_diff(doc["params"], single_p), tree_max_diff(doc["metrics"], single_m))
            if not dp <= MESH_DP_ATOL:
                fail(f"mesh (b): rank {r}'s dp=2 block is {dp} from the single-device block "
                     f"(bar {MESH_DP_ATOL})")
            doc["max_abs_diff"] = dp
        if not (tree_equal(torch, ranks[0]["params"], ranks[1]["params"])
                and tree_equal(torch, ranks[0]["metrics"], ranks[1]["metrics"])):
            fail("mesh (b): the two ranks' params or metrics differ")
        say(f"{tag} (b) dp=2 as two processes on the one card ({ranks[0]['backend']}, CUDA "
            f"tensors, {MESH_BATCH} rows a rank): after {MESH_EPOCHS} epochs every param and "
            f"metric within {max(d['max_abs_diff'] for d in ranks):.3g} of the single-device "
            f"block (bar {MESH_DP_ATOL}); the ranks bit-equal; launches per epoch, each rank: "
            + "; ".join(", ".join(f"{n} {c / MESH_EPOCHS:g}" for n, c in d["launches"].items() if c)
                        for d in ranks)
            + f"; {ranks[0]['reduces_per_epoch']:g} all_reduces an epoch; ms/epoch dp=2 "
            f"{[round(d['ms_per_epoch'], 2) for d in ranks]}, the reduction "
            f"{[round(d['reduce_ms_per_epoch'], 2) for d in ranks]} ms/epoch (ms/epoch host "
            f"clock, the reduction CUDA events around each all_reduce) on {card}")
        out["b"] = [{k: d[k] for k in ("backend", "launches", "sums", "collectives",
                                       "ms_per_epoch", "reduce_ms_per_epoch",
                                       "reduces_per_epoch", "max_abs_diff")} for d in ranks]
        lane_diffs = {}
        for r, doc in enumerate(ranks):
            if doc["lane_dp"] != {"padded": 2, "multi": 2}:
                fail(f"mesh (d): rank {r}'s lane meshes {doc['lane_dp']}")
            for k in meshless:
                a, b = doc["lanes"][k]["arrays"], meshless[k]["arrays"]
                if not tree_equal(torch, a, b):
                    lane_diffs[f"rank{r}.{k}"] = {n: float((a[n].double() - b[n].double())
                                                           .nan_to_num().abs().max()) for n in a}
        if lane_diffs:
            fail(f"mesh (d): the dp=2 lane drives differ from the meshless ones: {lane_diffs}")
        say(f"{tag} (d) dp=2 lane mesh, two processes: padded ({len(MESH_LATENTS) // 2} lanes a "
            f"rank) and multi (one dataset a rank) bit-equal to the meshless drives")
        for r, doc in enumerate(ranks):
            if doc["seed_mesh"] != {"seed": 2} or set(doc["members"]) != {r}:
                fail(f"mesh (e): rank {r} held members {sorted(doc['members'])} on "
                     f"{doc['seed_mesh']}")
            if not tree_equal(torch, doc["members"][r], alone[r]):
                fail(f"mesh (e): rank {r}'s member differs from GanTrainer(seed={MESH_SEEDS[r]})")
        say(f"{tag} (e) the two-rank seed mesh: each rank's member bit-equal to its standalone "
            "GanTrainer")
        out["d"] = {"bit_equal": True}
        out["e"] = {"bit_equal": True}
        for kind, name in (("pp", "f"), ("sp", "g")):
            out[name] = check_axes_part(torch, kind, [d[kind] for d in ranks], ref_fwd,
                                        ref_p, ref_m, n_critic, card)
        out["h"] = check_tp_part(torch, "(h) tp=2", [d["tp"] for d in ranks], ref_fwd, ref_p,
                                 ref_m, n_critic, card)
        out["h"]["health"] = check_tp_health(torch, [d["tp"] for d in ranks], more["health"],
                                             card)
        out["h_bf16"] = check_tp_bf16(torch, [d["tp_bf16"] for d in ranks], more, n_critic,
                                      ref_fwd["g"].shape[1], card)
        out["g_more"] = check_sp_more(torch, [d["sp_more"] for d in ranks], more, n_critic, card)
        out["d_health"] = check_lane_health(torch, ranks, meshless, health_ref, card)


        # (c) the verb: straight, single process, drained, then the resume
        for name in ("single", "dp2", "sp_straight"):
            runs[name] = [finish_module(p, MESH_TIMEOUT_S) for p in procs[name]]
            if any(rc != 0 for rc, *_ in runs[name]):
                fail(f"mesh (c): train-gan ({name}) exited "
                     f"{[rc for rc, *_ in runs[name]]}: {[e[-1500:] for _, _, e, _ in runs[name]]}")
        for name in ("dp2", "half", "sp_straight", "sp_half"):
            if runs[name][1][1].strip():
                fail(f"mesh (c): rank 1 of train-gan ({name}) printed {runs[name][1][1]!r}")
        drained = [finish_module(p, MESH_TIMEOUT_S) for p in procs["drain"]]
        ckpts = sorted(os.listdir(dirs["drain"])) if os.path.isdir(dirs["drain"]) else []
        if [rc for rc, *_ in drained] != [75, 75] or not ckpts:
            fail(f"mesh (c): SIGTERM to rank 1: exits {[rc for rc, *_ in drained]}, "
                 f"checkpoints {ckpts}: {[e[-1500:] for _, _, e, _ in drained]}")
        resumed = [finish_module(p, MESH_TIMEOUT_S) for p in procs["resume"]]
        if any(rc != 0 for rc, *_ in resumed):
            fail(f"mesh (c): train-gan --resume exited {[rc for rc, *_ in resumed]}: "
                 f"{[e[-1500:] for _, _, e, _ in resumed]}")
        last = f"ckpt_{MESH_CLI_EPOCHS}"
        g_single = ckpt_generator(torch, os.path.join(dirs["single"], last))
        g_dp2 = ckpt_generator(torch, os.path.join(dirs["dp2"], last))
        g_res = ckpt_generator(torch, os.path.join(dirs["half"], last))
        cli_diff = tree_max_diff(g_dp2, g_single)
        if not cli_diff <= MESH_DP_ATOL:
            fail(f"mesh (c): the dp=2 verb's generator is {cli_diff} from one process's")
        if not tree_equal(torch, g_res, g_dp2):
            fail(f"mesh (c): the resumed dp=2 run differs from the straight one: "
                 f"{tree_max_diff(g_res, g_dp2)}")
        writes = {}
        for r in (0, 1):
            recs = stream_records(os.path.join(dirs["dp2"] + "_obs", f"proc{r}"))
            writes[r] = sum(1 for x in recs if x.get("name") == "checkpoint"
                            and x.get("type") == "span")
            build = [x for x in recs if x.get("name") == "parallel_build"]
            if not build or build[0].get("backend") != "gloo" or build[0].get("mesh") != {"dp": 2}:
                fail(f"mesh (c): rank {r}'s parallel_build events {build}")
        if writes[0] < 1 or writes[1] != 0:
            fail(f"mesh (c): checkpoint spans by rank {writes}: rank 0 alone must write")
        say(f"{tag} (c) train-gan --coordinator, 2 ranks, {MESH_CLI_EPOCHS} epochs on the "
            f"committed panel: exit 0 and 0, gloo, rank 0 alone wrote ({writes[0]} checkpoint "
            f"spans, rank 1 none) and printed; generator within {cli_diff:.3g} of one process's "
            f"(bar {MESH_DP_ATOL}); --resume from ckpt_{MESH_RESUME_AT} bit-equal to the straight "
            f"run; SIGTERM to rank 1: exits 75 and 75, checkpoint {ckpts[-1]}; walls "
            f"{[round(w, 1) for *_, w in runs['dp2']]} s")
        out["c"] = {"generator_max_diff": cli_diff, "resume_bit_equal": True,
                    "drain_exits": [75, 75], "drain_checkpoint": ckpts[-1],
                    "checkpoint_spans": writes,
                    "walls_s": {k: [w for *_, w in v] for k, v in runs.items()
                                if not k.startswith("sp_")}}
        out["c_dp_sp"] = check_axes_verb(torch, "(c) dp-sp", "sp", {"dp": 1, "sp": 2}, dirs,
                                         runs, procs["sp_resume"], MESH_SP_CLI_EPOCHS,
                                         MESH_SP_RESUME_AT, card)
    finally:
        # a failed check exits: no process outlives the script
        for group in procs.values():
            for proc, _ in group:
                if proc.poll() is None:
                    kill_tree(proc)
                    proc.communicate()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card}")
    return out


class DpTpVerb:
    """(i) ``train-gan --dp-tp 1x2 --coordinator`` on the committed panel,
    started beside another phase: a straight run of MESH_TP_CLI_EPOCHS
    and one of MESH_TP_RESUME_AT, resumed (from a thread that only waits)
    as soon as it exits.  A tp rank's recurrence is a per-step exchange
    with its peer, so its epochs stretch when the host is oversubscribed:
    beside the mesh phase's dozen verb processes the 1-epoch run took
    83–120 s, beside the analysis phase's two host-bound subprocesses it
    has the cores it needs.  :meth:`finish` checks it
    (:func:`check_axes_verb`); :meth:`stop` kills what is left."""

    def __init__(self, keep: str):
        cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
        self.cli = ["--preset", TRAIN_PRESETS[0], "--cleaned-dir", cleaned, "--quiet",
                    "--dp-tp", "1x2"]
        self.dirs = {k: os.path.join(keep, f"mesh_cli_{k}") for k in ("tp_straight", "tp_half")}
        # the straight run with health on: its checkpoint must still be the
        # health-off resume's, bit for bit, and its gauges rank 0's alone
        self.procs = {
            "tp_straight": start_cli_pair([*self.cli, "--epochs", MESH_TP_CLI_EPOCHS,
                                           "--checkpoint-dir", self.dirs["tp_straight"]],
                                          obs_dir=self.dirs["tp_straight"] + "_obs",
                                          env_extra={"HFREP_HEALTH": "abort"}),
            "tp_half": start_cli_pair([*self.cli, "--epochs", MESH_TP_RESUME_AT,
                                       "--checkpoint-dir", self.dirs["tp_half"]])}
        self.half: list = []
        self.thread = threading.Thread(target=self._resume_after_half, daemon=True)
        self.thread.start()

    def _resume_after_half(self) -> None:
        for proc, t0 in self.procs["tp_half"]:
            try:
                out, err = proc.communicate(timeout=MESH_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                return                  # finish() reports the overrun
            self.half.append((proc.returncode, out, err, time.perf_counter() - t0))
        if all(rc == 0 for rc, *_ in self.half):
            self.procs["tp_resume"] = start_cli_pair([*self.cli, "--epochs", MESH_TP_CLI_EPOCHS,
                                                      "--checkpoint-dir", self.dirs["tp_half"],
                                                      "--resume"])

    def finish(self, torch) -> dict:
        card = card_line(torch)
        self.thread.join(timeout=MESH_TIMEOUT_S)
        runs = {"tp_straight": [finish_module(p, MESH_TIMEOUT_S)
                                for p in self.procs["tp_straight"]], "tp_half": self.half}
        for name, pair in runs.items():
            if len(pair) != 2 or any(rc != 0 for rc, *_ in pair):
                fail(f"mesh (i): train-gan ({name}) exited {[rc for rc, *_ in pair]} (of 2 "
                     f"ranks): {[e[-1500:] for _, _, e, _ in pair]}")
            if pair[1][1].strip():
                fail(f"mesh (i): rank 1 of train-gan ({name}) printed {pair[1][1]!r}")
        gauges = [{x["name"] for x in stream_records(os.path.join(
            self.dirs["tp_straight"] + "_obs", f"proc{r}")) if x.get("kind") == "gauge"
            and x.get("name", "").startswith("health/")} for r in (0, 1)]
        if len(gauges[0]) != len(STEP_HEALTH_GAUGES) or gauges[1]:
            fail(f"mesh (i): health gauges by rank {gauges}: rank 0 alone sets the five")
        out = check_axes_verb(torch, "(i) dp-tp", "tp", {"dp": 1, "tp": 2}, self.dirs, runs,
                              self.procs["tp_resume"], MESH_TP_CLI_EPOCHS, MESH_TP_RESUME_AT,
                              card)
        say(f"[mesh] (i) the straight run under HFREP_HEALTH=abort: rank 0 set "
            f"{sorted(gauges[0])}, rank 1 none; its last checkpoint bit-equal to the health-off "
            "resume's")
        out["health_gauges"] = sorted(gauges[0])
        return out

    def stop(self) -> None:
        for group in self.procs.values():
            for proc, _ in group:
                if proc.poll() is None:
                    kill_tree(proc)
                    proc.communicate()


def mesh_reference(torch, more: bool = False) -> tuple:
    """(f), (g), (h) and (j)'s reference: the single-device epoch (fused
    route) and the forwards from the phase's state and first draws, on
    the host; and n_critic.  With ``more``, also the lifted
    configurations' references (:func:`mesh_more_reference`)."""
    from hfrep_tpu_torch.train import make_train_step

    pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch)
    z, x = axes_inputs(draws, dataset)
    with torch.no_grad():
        ref_fwd = {"g": state.generator(z).cpu(), "d": state.discriminator(x).cpu()}
    state, metrics = make_train_step(pair, tcfg, dataset)(state, draws[0])
    ref = (ref_fwd, {n: p.detach().cpu() for n, p in state_params(state).items()},
           {k: v.cpu() for k, v in metrics.items()}, tcfg.n_critic)
    return ref + (mesh_more_reference(torch, ref[1]),) if more else ref


def mesh_more_reference(torch, ref_p: dict) -> dict:
    """The single-device epochs the lifted configurations are held to, from
    the phase's seed state and first draws: the flagship's with health on
    (its params bit-equal to the health-off epoch's ``ref_p``), every other
    family's, and the bf16 flagship's on the fused and the chained critic
    route with its starting params."""
    from hfrep_tpu_torch.obs import health
    from hfrep_tpu_torch.train import make_train_step

    pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch)
    health.configure(health.HealthConfig())
    try:
        step = make_train_step(pair, tcfg, dataset)
    finally:
        health.configure(None)
    state, metrics = step(state, draws[0])
    on = epoch_doc(torch, state, metrics)
    if not tree_equal(torch, on["params"], ref_p):
        fail(f"mesh: the single-device health-on epoch differs from the health-off one by "
             f"{tree_max_diff(on['params'], ref_p)}")
    out = {"health": {k: v for k, v in on["metrics"].items() if k.startswith("health_")},
           "families": {}, "bf16": {}}
    for family in MESH_SP_FAMILIES:
        pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch, family)
        out["families"][family] = epoch_doc(torch, *make_train_step(pair, tcfg, dataset)(
            state, draws[0]))
    for route in ("auto", "chained"):
        pair, tcfg, dataset, state, draws = mesh_gan_inputs(torch, "mtss_wgan_gp", "bfloat16")
        state.discriminator.stack = route
        out["bf16_p0"] = {n: p.detach().cpu().clone() for n, p in state_params(state).items()}
        out["bf16"][route] = epoch_doc(torch, *make_train_step(pair, tcfg, dataset)(
            state, draws[0]))
    return out


def bf16_doc_errs(got: dict, ref: dict, p0: dict, cross_route: bool = False) -> dict:
    """A bf16 epoch (:func:`epoch_doc`) against a reference one from the
    same params ``p0``, the bf16 bars' measures (:func:`epoch_parity`):
    each loss's relative error, the worst param |got - ref| / max(1,
    max|ref|), each update's |Δgot - Δref|_2 / |Δref|_2 (Δ = p1 - p0) and
    each optimizer slot's |got - ref| / max|ref|; ``ok`` when all four
    are inside BF16_LOSS_RTOL, BF16_PARAM_BAR, BF16_UPDATE_BAR and
    BF16_SLOT_BAR.  ``cross_route``: the reference runs the critic's two
    layers as the fused stack, which adds b2 in float32 where a single
    layer rounds ``h1.k2 + b2`` to bf16; a loss near zero (the generator's
    mean score) then differs by more than 5e-2 of itself, so the losses
    are held at JAX's whole bf16 bar, rtol 5e-2 and atol
    BF16_JAX_LOSS_ATOL (``tests/test_precision.py:111-112``)."""
    def loss_err(k):
        a, r = float(got["metrics"][k]), float(ref["metrics"][k])
        if cross_route:
            return abs(a - r) / (BF16_JAX_LOSS_ATOL + BF16_LOSS_RTOL * abs(r)) * BF16_LOSS_RTOL
        return abs(a - r) / max(abs(r), 1e-30)

    errs = {"loss": max(loss_err(k) for k in ("d_loss", "g_loss")),
            "param": 0.0, "update": 0.0, "slot": 0.0}
    for n, r in ref["params"].items():
        a, r, z = got["params"][n].double(), r.double(), p0[n].double()
        errs["param"] = max(errs["param"],
                            float((a - r).abs().max()) / max(1.0, float(r.abs().max())))
        errs["update"] = max(errs["update"],
                             float(((a - z) - (r - z)).norm() / (r - z).norm().clamp_min(1e-30)))
        net, name = n.split(".", 1)
        for slot in ("mu", "nu"):
            if slot in ref["slots"][net]:
                x = got["slots"][net][slot][name].double()
                y = ref["slots"][net][slot][name].double()
                errs["slot"] = max(errs["slot"],
                                   float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)))
    errs["ok"] = (errs["loss"] <= BF16_LOSS_RTOL and errs["param"] <= BF16_PARAM_BAR
                  and errs["update"] <= BF16_UPDATE_BAR and errs["slot"] <= BF16_SLOT_BAR)
    return errs


def plain_metrics(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if not k.startswith("health_")}


def check_tp_health(torch, docs: list, health_ref: dict, card: str) -> dict:
    """(h)'s health values: each rank's five within HEALTH_ATOL +
    HEALTH_RTOL of the single-device health-on epoch's, the ranks' bit
    for bit (the all_reduce count and the params are :func:`check_tp_part`'s)."""
    errs = []
    for r, doc in enumerate(docs):
        got = {k: v for k, v in doc["metrics"].items() if k.startswith("health_")}
        if set(got) != set(health_ref):
            fail(f"mesh (h): rank {r}'s health values {sorted(got)}, expected {sorted(health_ref)}")
        err = max(allclose_err(got[k], health_ref[k], HEALTH_ATOL, HEALTH_RTOL) for k in got)
        if not err <= 1.0:
            fail(f"mesh (h): rank {r}'s health values {got} against the single-device "
                 f"health-on epoch's {health_ref} ({err} of the bar atol {HEALTH_ATOL}, rtol "
                 f"{HEALTH_RTOL})")
        errs.append(err)
    if not tree_equal(torch, docs[0]["metrics"], docs[1]["metrics"]):
        fail("mesh (h): the two tp ranks' health values differ")
    say(f"[mesh] (h) tp=2 with health on: the five health values within {max(errs):.3g} of "
        f"the bar (atol {HEALTH_ATOL}, rtol {HEALTH_RTOL}) of the single-device health-on "
        f"epoch's, the ranks bit-equal: "
        + ", ".join(f"{k[7:]} {float(v):.6g}" for k, v in docs[0]["metrics"].items()
                    if k.startswith("health_")) + f" on {card}")
    return {"health": {k: float(v) for k, v in docs[0]["metrics"].items()
                       if k.startswith("health_")}, "bar_share": max(errs)}


def check_sp_more(torch, docs: list, more: dict, n_critic: int, card: str) -> dict:
    """(g)'s other families and bf16 epoch read in the parent: each
    family's rank epochs within sp's bars of the single-device epoch, the
    ranks within RANKS_RTOL, each rank's launches exactly
    :func:`sp_family_launches` (none for a Dense family) and float32
    recurrence kernels only; the bf16 epoch within sp's bars of the
    single-device chained bf16 epoch and at the bf16 bars of the fused
    one, its launches the flagship's and ``__nv_bfloat16`` recurrence
    kernels only."""
    out = {}
    for key in MESH_SP_FAMILIES + ("bf16",):
        atol, rtol = (AXES_BF16_ATOL, 0.0) if key == "bf16" else AXES_BARS["sp"]
        ref = more["bf16"]["chained"] if key == "bf16" else more["families"][key]
        family = "mtss_wgan_gp" if key == "bf16" else key
        diffs = []
        for r, doc in enumerate(d[key] for d in docs):
            err = max([allclose_err(doc["params"][n], ref["params"][n], atol, rtol)
                       for n in ref["params"]]
                      + [allclose_err(doc["metrics"][k], ref["metrics"][k], atol, rtol)
                         for k in ref["metrics"]])
            diff = max(tree_max_diff(doc["params"], ref["params"]),
                       tree_max_diff(doc["metrics"], ref["metrics"]))
            if not err <= 1.0:
                fail(f"mesh (g) sp=2 {key}: rank {r}'s epoch is {diff} from the single-device "
                     f"epoch{' (chained route)' if key == 'bf16' else ''} (bars atol {atol}, "
                     f"rtol {rtol})")
            check_route_launches(f"mesh (g) sp=2 {key} rank {r}", doc["launches"], doc["sums"],
                                 sp_family_launches(family, r, n_critic), 1)
            kernels = doc["kernels"]
            if kernels is not None and (kernels["other"] if key == "bf16" else kernels["bf16"]):
                fail(f"mesh (g) sp=2 {key}: rank {r} ran recurrence kernels {kernels}: "
                     + ("only __nv_bfloat16 instantiations belong in a bf16 epoch" if key == "bf16"
                        else "a float32 epoch runs no __nv_bfloat16 instantiation"))
            if kernels is not None and not (kernels["bf16"] if key == "bf16" else kernels["other"]):
                fail(f"mesh (g) sp=2 {key}: rank {r}'s profile shows no recurrence kernel")
            diffs.append(diff)
        a, b = (d[key] for d in docs)
        if not all(torch.allclose(b[t][k], a[t][k], rtol=RANKS_RTOL, atol=0)
                   for t in ("params", "metrics") for k in a[t]):
            fail(f"mesh (g) sp=2 {key}: the ranks differ beyond rtol {RANKS_RTOL}")
        out[key] = {"max_abs_diff": max(diffs), "ms": [d[key]["ms"] for d in docs],
                    "launches": [d[key]["launches"] for d in docs],
                    "kernels": [d[key]["kernels"] for d in docs]}
    fused = [bf16_doc_errs(d["bf16"], more["bf16"]["auto"], more["bf16_p0"], cross_route=True)
             for d in docs]
    if not all(e["ok"] for e in fused):
        fail(f"mesh (g) sp=2 bf16: against the single-device fused bf16 epoch {fused} (bars: "
             f"losses {BF16_LOSS_RTOL}, params {BF16_PARAM_BAR}, updates {BF16_UPDATE_BAR}, "
             f"slots {BF16_SLOT_BAR})")
    out["bf16"]["fused_errs"] = fused
    out["bf16"]["routes_apart"] = max(
        tree_max_diff(more["bf16"]["auto"]["params"], more["bf16"]["chained"]["params"]),
        tree_max_diff(more["bf16"]["auto"]["metrics"], more["bf16"]["chained"]["metrics"]))
    say(f"[mesh] (g) sp=2, every other family one epoch at full width from the phase's seed "
        f"state and first draws, within the single-device epoch by "
        + ", ".join(f"{k} {out[k]['max_abs_diff']:.3g}" for k in MESH_SP_FAMILIES)
        + f" (bars atol {AXES_BARS['sp'][0]}, rtol {AXES_BARS['sp'][1]}), the ranks within rtol "
        f"{RANKS_RTOL}, the launches derived (the Dense families none); bf16: within "
        f"{out['bf16']['max_abs_diff']:.3g} of the single-device chained bf16 epoch (bar atol "
        f"{AXES_BF16_ATOL}; the fused and chained single-device epochs "
        f"{out['bf16']['routes_apart']:.3g} apart), against the fused one losses "
        f"{max(e['loss'] for e in fused):.3g}, params {max(e['param'] for e in fused):.3g}, "
        f"updates {max(e['update'] for e in fused):.3g}, slots {max(e['slot'] for e in fused):.3g} "
        f"(bf16 bars), __nv_bfloat16 recurrence kernels only; epoch ms "
        + ", ".join(f"{k} {[round(x, 1) for x in out[k]['ms']]}" for k in out)
        + f" (host clock, beside the verb runs) on {card}")
    return out


def check_tp_bf16(torch, docs: list, more: dict, n_critic: int, window: int, card: str) -> dict:
    """(h)'s bf16 epoch read in the parent: each rank at the bf16 bars of
    the single-device chained bf16 epoch (a tp rank runs the layers
    singly, as that route does) and of the fused one (across routes,
    :func:`bf16_doc_errs`), no hand kernel launched, the all_reduces
    exactly :func:`tp_reduces`, the ranks bit-equal."""
    errs = []
    for r, doc in enumerate(docs):
        for route in ("chained", "auto"):
            e = bf16_doc_errs(doc, more["bf16"][route], more["bf16_p0"],
                              cross_route=route == "auto")
            if not e["ok"]:
                fail(f"mesh (h) tp=2 bf16: rank {r} against the single-device {route} bf16 "
                     f"epoch {e}")
            errs.append(dict(e, route=route))
        if any(doc["launches"].values()) or any(doc["sums"].values()):
            fail(f"mesh (h) tp=2 bf16: rank {r} launched {doc['launches']}")
        want = tp_reduces(n_critic, window)
        if doc["collectives"]["all_reduce"] != want:
            fail(f"mesh (h) tp=2 bf16: rank {r}'s collectives {doc['collectives']}, expected "
                 f"{want} all_reduces")
    if not (tree_equal(torch, docs[0]["params"], docs[1]["params"])
            and tree_equal(torch, docs[0]["metrics"], docs[1]["metrics"])):
        fail("mesh (h) tp=2 bf16: the ranks differ")
    say(f"[mesh] (h) tp=2 bf16, one epoch at full width (H=100, W=48) from the phase's seed "
        f"state and first draws against the single-device bf16 epochs (chained; fused across "
        f"routes): losses "
        f"{max(e['loss'] for e in errs):.3g}, params {max(e['param'] for e in errs):.3g}, "
        f"updates {max(e['update'] for e in errs):.3g}, slots {max(e['slot'] for e in errs):.3g} "
        f"(bf16 bars {BF16_LOSS_RTOL}, {BF16_PARAM_BAR}, {BF16_UPDATE_BAR}, {BF16_SLOT_BAR}); "
        f"no hand kernel, {docs[0]['collectives']['all_reduce']} all_reduces a rank, the ranks "
        f"bit-equal; epoch ms {[round(d['ms'], 1) for d in docs]} (host clock, beside the verb "
        f"runs) on {card}")
    return {"errs": errs, "ms": [d["ms"] for d in docs]}


def check_lane_health(torch, docs: list, meshless: dict, ref: dict, card: str) -> dict:
    """(d)'s dp=2 padded drive with health on: its arrays bit-equal to the
    meshless health-off drive's, rank 0's ``health/ae_*`` gauges those of
    one meshless health-on drive (grad norm and nonfinite count equal, the
    param norm within MESH_AE_PN_RTOL), rank 1's none."""
    for r, doc in enumerate(docs):
        if not tree_equal(torch, doc["lanes_health"]["arrays"], meshless["padded"]["arrays"]):
            fail(f"mesh (d): rank {r}'s health-on dp=2 padded drive differs from the meshless "
                 "health-off drive")
    got, want = docs[0]["lanes_health"]["gauges"], ref["gauges"]
    if [(n, e) for n, _, e in got] != [(n, e) for n, _, e in want] or not want:
        fail(f"mesh (d): rank 0's health gauges {got}, the meshless drive's {want}")
    pn = 0.0
    for (name, g, _), (_, w, _) in zip(got, want):
        if name == "health/ae_param_norm":
            pn = max(pn, abs(g - w) / abs(w))
        elif not (g == w or (math.isnan(g) and math.isnan(w))):
            fail(f"mesh (d): rank 0's {name} {g}, the meshless drive's {w}")
    if not pn <= MESH_AE_PN_RTOL:
        fail(f"mesh (d): rank 0's param norms {pn} (relative) from the meshless drive's")
    if docs[1]["lanes_health"]["gauges"]:
        fail(f"mesh (d): rank 1 set health gauges {docs[1]['lanes_health']['gauges']}")
    say(f"[mesh] (d) dp=2 padded drive with health on: bit-equal to the meshless health-off "
        f"drive; rank 0's {len(got)} health/ae_* gauges (every boundary and the drive's end) "
        f"the meshless health-on drive's, the grad norm and nonfinite count equal, the param "
        f"norm within {pn:.3g} (rtol bar {MESH_AE_PN_RTOL}); rank 1 none; on {card}")
    return {"gauges": len(got), "param_norm_rel": pn}


def phase_tile(torch, keep: str) -> dict:
    """(j) dp×sp×tp 1×2×2 as four rank processes on the one card, one
    epoch against the single-device epoch (:func:`check_tp_part`).  Not in
    :func:`main`'s run (four processes of the per-step recurrence doubled
    every verb run of the mesh phase beside them);
    ``tools/torch_mesh_phase.py`` runs it after the mesh phase."""
    card = card_line(torch)
    t_phase = time.perf_counter()
    tile_dir = os.path.join(keep, "mesh_tile")
    os.makedirs(tile_dir)
    procs = start_ranks(tile_dir, math.prod(MESH_TILE.values()), "mesh_tile_rank")
    try:
        ref_fwd, ref_p, ref_m, n_critic = mesh_reference(torch)
        finish_ranks(procs, tile_dir, time.perf_counter() + MESH_TIMEOUT_S)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                kill_tree(proc)
                proc.communicate()
    tile = [torch.load(os.path.join(tile_dir, f"rank{r}.pt")) for r in range(len(procs))]
    if any(d["backend"] != "gloo" for d in tile):
        fail(f"mesh (j): the tile ran {[d['backend'] for d in tile]}")
    out = check_tp_part(torch, "(j) dp×sp×tp 1×2×2", tile, ref_fwd, ref_p, ref_m, n_critic, card)
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[mesh] (j) phase wall {out['wall_s']:.1f} s on {card}")
    return out


# -------------------------------------------------------- the analysis phase
#: the port's gate (ROADMAP queue 1 item 10a), its paths as the shell would
#: give them, and the rule ids it carries
ANALYSIS_GATE = ("hfrep_tpu_torch", "tools/torch_*.py", "tests/test_torch_*.py")
ANALYSIS_RULES = ("JAX005", "JAX006", "HF001", "HF002", "HF003", "HF004", "HF006", "HF007",
                  "HF008", "HF009", "HF010", "HF011", "JPX002", "JPX003", "JPX004")
ANALYSIS_TIMEOUT_S = 300
#: the program audit (queue 1 item 10b) with the serve rows' programs built
#: on the card, beside the gate; one torch thread, so the contract checks'
#: host timings share the host with one busy core
ANALYSIS_AUDIT = ("audit", "--device", "cuda", "--no-cache", "--format", "sarif")
#: the full-width serve:sample program's hfrep.lstm_fwd nodes: one a
#: generator LSTM layer (models/generators.py, LSTMGenerator's lstm0 and
#: lstm1), each launching the forward kernel once a call
SAMPLE_LSTM_NODES = 2
#: the export against the plain version: torch.allclose at atol 1e-5 (its
#: rtol, 1e-5, as it comes)
SAMPLE_PLAIN_ATOL = 1e-5
#: pairs of calls of each decorated function, contracts on and off (the
#: order flipped every pair), for the check's median cost a call
CONTRACT_PAIRS = 25
#: calls timed of the check alone (around a function returning at once)
CHECK_ALONE_CALLS = 2000
SWEEP_LANES, OLS_WINDOW = 21, 24


def contract_cases(torch, np, covs: dict, train: list) -> dict:
    """Each function that carries a shape contract, on card tensors at the
    main path's shapes: ``{name: (function, good args, [(what, bad args)])}``."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core import sampling
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.obs import flops
    from hfrep_tpu_torch.ops import rolling, sqrtm

    cleaned = os.path.join(os.path.dirname(os.path.abspath(__file__)), CLEANED_DIR)
    panel = load_panel(cleaned, device="cuda")
    cases = {}
    for preset in TRAIN_PRESETS:
        cfg = get_preset(preset)
        data = build_gan_dataset(cfg.data, cfg.data.seed, panel).panel_scaled
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        n, w = cfg.data.n_sample, cfg.data.window
        starts = torch.randint(0, data.shape[0] - w + 1, (n,), generator=g, device="cuda")
        cases[f"sample_windows ({preset}, W={w})"] = (
            sampling.sample_windows, (data, n, w, None, starts),
            [("rank", (data[None], n, w, None, starts))])
    # the sweep's ex-ante shapes: the test block's returns, 21 lanes of factors
    _, x_test, _, y_test = panel.train_test_split()
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    factors = torch.randn((SWEEP_LANES, x_test.shape[0], SWEEP_LANES), generator=g,
                          device="cuda")
    cases["rolling_ols_beta"] = (
        rolling.rolling_ols_beta, (y_test, factors, OLS_WINDOW),
        [("T", (y_test[1:], factors, OLS_WINDOW)), ("rank", (y_test[None], factors, OLS_WINDOW))])
    cases["_window_stack"] = (rolling._window_stack, (factors, OLS_WINDOW),
                              [("rank", (factors[0, :, 0], OLS_WINDOW))])
    cases["expanding_minmax_scale"] = (rolling.expanding_minmax_scale, (x_test,),
                                       [("rank", (x_test[None],))])
    cases["ols_beta"] = (rolling.ols_beta, (y_test, factors[0], True),
                         [("T", (y_test, factors[0, 1:], True)),
                          ("rank", (y_test[:, 0], factors[0], True))])
    for preset, (s1, s2) in covs.items():
        cases[f"sqrtm_product_trace ({preset})"] = (
            sqrtm.sqrtm_product_trace, (s1, s2),
            [("F", (s1, s2[1:, 1:])), ("rank", (s1[0], s2))])
    step_s = np.array([r["ms_per_epoch"] / 1e3 for r in train], dtype=np.float64)
    cases["mfu_series"] = (flops.mfu_series, (step_s, 48, 35), [("rank", (step_s[None], 48, 35))])
    return cases


def same_bits(torch, np, a, b) -> bool:
    """Outputs equal bit for bit (NaNs included): tensors, arrays or tuples
    of them."""
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(same_bits(torch, np, x, y) for x, y in zip(a, b)))
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_analysis(torch, np, covs: dict, train: list) -> dict:
    """The static analyzer on the card machine: its gate and its program
    audit (the serve rows built on the card) in two subprocesses side by
    side, while this process builds ``serve:sample`` at full width and the
    seeded defects on the card and checks every shape contract on card
    tensors."""
    tag = "[analysis]"
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    paths = [p for pat in ANALYSIS_GATE for p in (sorted(glob.glob(pat, root_dir=root))
                                                  if "*" in pat else [pat])]
    rc, text, err, _ = finish_module(start_module("hfrep_tpu_torch.analysis", ["rules"]),
                                     ANALYSIS_TIMEOUT_S)
    ids = [line.split()[0] for line in text.splitlines() if line.strip()]
    if rc != 0 or tuple(ids) != ANALYSIS_RULES:
        fail(f"analysis: rules exited {rc} listing {ids}: {err[-1500:]}")
    gate = start_module("hfrep_tpu_torch.analysis",
                        ["check", *paths, "--no-cache", "--format", "json"])
    audit = start_module("hfrep_tpu_torch.analysis", list(ANALYSIS_AUDIT),
                         env_extra={"OMP_NUM_THREADS": "1"})
    try:
        out["serve_sample"] = audit_serve_sample(torch, tag)
        out["seeded"] = audit_seeded(tag)
        rc, text, err, wall = finish_module(gate, ANALYSIS_TIMEOUT_S)
        doc = json.loads(text) if rc in (0, 1) and text.strip() else {}
        if rc != 0 or doc.get("findings") != [] or doc.get("baselined") != 0:
            fail(f"analysis: the gate exited {rc}: {text[-3000:]} {err[-1500:]}")
        say(f"{tag} gate over {len(paths)} paths ({' '.join(ANALYSIS_GATE)}), cold "
            f"(--no-cache): exit 0, 0 findings, 0 baselined, {wall:.2f} s wall on the host; "
            f"rules {' '.join(ids)}")
        out["gate"] = {"rc": rc, "findings": 0, "paths": len(paths), "wall_s": wall,
                       "rules": ids}
        out["contracts"] = check_contracts(torch, np, covs, train, tag)
        out["audit"] = finish_audit(audit, tag)
    finally:
        for proc, _ in (gate, audit):
            if proc.poll() is None:
                kill_tree(proc)
                proc.communicate()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase wall {out['wall_s']:.1f} s on {card_line(torch)}")
    return out


def finish_audit(audit: tuple, tag: str) -> dict:
    """The audit subprocess's verdict: exit 0, no finding and nothing
    baselined, every registry row traced with no skip note, each serve
    row's program built on the card (a skip note is what an eager
    fallback gives)."""
    from hfrep_tpu_torch.analysis import programs

    rc, text, err, wall = finish_module(audit, ANALYSIS_TIMEOUT_S)
    try:
        run = json.loads(text)["runs"][0]
    except (ValueError, KeyError, IndexError):
        run = {}
    props = run.get("properties", {})
    labels = [b.label for b in programs.PROGRAM_BOUNDARIES]
    want_dev = {b.label: programs.boundary_device(b, "cuda") for b in programs.PROGRAM_BOUNDARIES}
    if (rc != 0 or run.get("results") != [] or props.get("baselined") != 0
            or props.get("traced") != labels or props.get("skipped") != {}
            or props.get("devices") != want_dev):
        fail(f"analysis: audit {' '.join(ANALYSIS_AUDIT)} exited {rc}: {text[-3000:]} "
             f"{err[-2000:]}")
    n_serve = sum(1 for d in want_dev.values() if d == "cuda")
    say(f"{tag} audit ({' '.join(ANALYSIS_AUDIT)}): exit 0, 0 findings, 0 baselined; "
        f"{len(labels)} of {len(labels)} registry rows traced, no skip note; the {n_serve} "
        f"serve rows' programs exported on the card (mode export), the "
        f"{len(labels) - n_serve} step, chunk and init rows traced on the host; "
        f"{wall:.2f} s wall on the host")
    return {"rc": rc, "findings": 0, "traced": len(labels), "skipped": 0,
            "serve_rows_on_card": n_serve, "wall_s": wall}


def audit_serve_sample(torch, tag: str) -> dict:
    """``serve:sample`` at the flagship's full width, each preset, at the
    server's first bucket, built on the card by the audit's own factory
    (``serve/aot.py``'s export round trip): mode export, exactly
    :data:`SAMPLE_LSTM_NODES` ``hfrep.lstm_fwd`` nodes, each launching
    the forward kernel once a call; its output bit for bit the eager
    server path's (``via_export=False``), and within
    :data:`SAMPLE_PLAIN_ATOL` of the plain version (a CPU copy of the same
    parameters on the same noise)."""
    from hfrep_tpu_torch.analysis import programs
    from hfrep_tpu_torch.analysis.rules.jpx_base import call_nodes, op_name
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.ops import cuda_lstm
    from hfrep_tpu_torch.serve import aot
    from hfrep_tpu_torch.serve.server import ServeConfig

    bucket = ServeConfig().sample_buckets[0]
    out = {"bucket": bucket, "runs": [], "launches": 0}
    for preset in TRAIN_PRESETS:
        mcfg = get_preset(preset).model
        t0 = time.perf_counter()
        built = programs.BOUNDARIES_BY_LABEL["serve:sample"].factory("cuda", mcfg, bucket)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if built.mode != "export":
            fail(f"analysis: serve:sample ({preset}) came back in mode {built.mode!r}")
        nodes = [n for n in call_nodes(built.program.exported.graph) if op_name(n) == "lstm_fwd"]
        if len(nodes) != SAMPLE_LSTM_NODES or mcfg.hidden != 100:
            fail(f"analysis: serve:sample ({preset}, H={mcfg.hidden}) holds {len(nodes)} "
                 f"hfrep.lstm_fwd nodes, predicted {SAMPLE_LSTM_NODES}")
        g = torch.Generator(device="cuda")
        g.manual_seed(21)
        noise = torch.randn((bucket, mcfg.window, mcfg.features), generator=g, device="cuda")
        params = built.model.params
        cuda_lstm.reset_launches()
        got = built.program(params, noise)
        torch.cuda.synchronize()
        launches = cuda_lstm.launch_counts()
        if launches["lstm_fwd"] != SAMPLE_LSTM_NODES or sum(launches.values()) != SAMPLE_LSTM_NODES:
            fail(f"analysis: one call of serve:sample ({preset}) launched {launches}")
        eager = aot.Program(aot.gen_batch_fn(built.model), "compiled")(params, noise)
        if not torch.equal(got, eager):
            fail(f"analysis: serve:sample ({preset}): the exported program differs from the "
                 f"eager server path by {float((got - eager).abs().max())}")
        cpu = aot.GenServeModel(cfg=mcfg, module=copy.deepcopy(built.model.module).cpu())
        plain = aot.gen_batch_fn(cpu)(cpu.params, noise.cpu())
        got = got.cpu()
        err = float((got - plain).abs().max())
        if (got.shape != (bucket, mcfg.window, mcfg.features)
                or not torch.isfinite(got).all()
                or not torch.allclose(got, plain, atol=SAMPLE_PLAIN_ATOL)):
            fail(f"analysis: serve:sample ({preset}) against the plain version: max|diff| "
                 f"{err} (allclose at atol {SAMPLE_PLAIN_ATOL})")
        out["launches"] += launches["lstm_fwd"]
        out["runs"].append({"preset": preset, "W": mcfg.window, "F": mcfg.features,
                            "H": mcfg.hidden, "export_s": build_s, "lstm_fwd_nodes": len(nodes),
                            "launches": launches["lstm_fwd"], "max_abs_err_plain": err})
        say(f"{tag} serve:sample {preset} (H={mcfg.hidden}, W={mcfg.window}, "
            f"F={mcfg.features}, bucket {bucket}): exported on the card in {build_s:.2f} s "
            f"(export, save, load, one run), mode export; {len(nodes)} hfrep.lstm_fwd nodes "
            f"(predicted {SAMPLE_LSTM_NODES}, one a generator layer), {launches['lstm_fwd']} "
            f"lstm_fwd launches a call; bit-equal to the eager server path; max|diff| "
            f"{err:.3e} to the plain version (allclose, atol {SAMPLE_PLAIN_ATOL})")
    return out


def audit_seeded(tag: str) -> dict:
    """The seeded defects (``programs.SEEDED_DEFECTS``), their programs
    built on the card: each gives exactly its one finding."""
    from hfrep_tpu_torch.analysis import programs

    t0 = time.perf_counter()
    rows = [b for b, _ in programs.SEEDED_DEFECTS]
    res = programs.audit_boundaries(boundaries=rows, device="cuda", use_cache=False)
    got = {}
    for b, rule in programs.SEEDED_DEFECTS:
        found = [f for f in res.findings if f.message.startswith(f"[{b.label}] ")]
        got[b.label] = [f"{f.rule}: {f.message}" for f in found]
        if (b.label in res.skipped or [f.rule for f in found] != [rule]
                or not found[0].message.startswith(f"[{b.label}] 1 ")):
            fail(f"analysis: seeded defect {b.label}: want exactly one {rule}, got "
                 f"{got[b.label]} (skipped: {res.skipped.get(b.label)})")
    wall = time.perf_counter() - t0
    say(f"{tag} seeded defects, programs built on the card: "
        + "; ".join(f"{label}: {msgs[0][:110]}" for label, msgs in got.items())
        + f" ({wall:.2f} s)")
    return {"findings": got, "wall_s": wall}


def check_contracts(torch, np, covs: dict, train: list, tag: str) -> dict:
    """Each function that carries a shape contract, on card tensors: on =
    off bit for bit, a bad shape refused, the check's cost a call."""
    from hfrep_tpu_torch.analysis.contracts import ContractError, contract

    cases = contract_cases(torch, np, covs, train)
    out = {}
    prior = os.environ.get("HFREP_CONTRACTS")
    try:
        for name, (fn, args, bad) in cases.items():
            os.environ.pop("HFREP_CONTRACTS", None)
            on = fn(*args)
            os.environ["HFREP_CONTRACTS"] = "0"
            off = fn(*args)
            torch.cuda.synchronize()
            if not same_bits(torch, np, on, off):
                fail(f"analysis: {name} with contracts on differs from contracts off")
            os.environ.pop("HFREP_CONTRACTS", None)
            refused = {}
            for what, bad_args in bad:
                try:
                    fn(*bad_args)
                except ContractError as e:
                    refused[what] = str(e)
                else:
                    fail(f"analysis: {name} took a bad shape ({what}) without a ContractError")
            times = {"on": [], "off": []}
            for i in range(CONTRACT_PAIRS):
                for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                    if mode == "on":
                        os.environ.pop("HFREP_CONTRACTS", None)
                    else:
                        os.environ["HFREP_CONTRACTS"] = "0"
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(*args)
                    torch.cuda.synchronize()
                    times[mode].append(time.perf_counter() - t0)
            med = {k: 1e6 * float(np.median(v)) for k, v in times.items()}
            # the check alone, contracts on: the same contract around a
            # function that returns the output at once, against it bare
            os.environ.pop("HFREP_CONTRACTS", None)
            bare = (lambda *a, _o=on: _o)
            alone = {}
            for mode, f in (("checked", contract(fn.__contract__)(bare)), ("bare", bare)):
                t0 = time.perf_counter()
                for _ in range(CHECK_ALONE_CALLS):
                    f(*args)
                alone[mode] = 1e6 * (time.perf_counter() - t0) / CHECK_ALONE_CALLS
            row = {"bit_equal": True, "refused": refused, "on_us": med["on"],
                   "off_us": med["off"], "check_us": med["on"] - med["off"],
                   "check_alone_us": alone["checked"] - alone["bare"]}
            out[name] = row
            say(f"{tag} {name}: on = off bit for bit; refused "
                + "; ".join(f"{k}: {v[:90]}" for k, v in refused.items())
                + f"; median call {med['on']:.1f} us on, {med['off']:.1f} us off: the check "
                f"{row['check_us']:+.1f} us a call ({CONTRACT_PAIRS} pairs), "
                f"{row['check_alone_us']:.2f} us alone ({CHECK_ALONE_CALLS} calls)")
    finally:
        if prior is None:
            os.environ.pop("HFREP_CONTRACTS", None)
        else:
            os.environ["HFREP_CONTRACTS"] = prior
    return out


def bound_ms(w, b, h, dtype_name) -> tuple:
    item = 4 if dtype_name == "float32" else 2
    nbytes = (w * b * 4 * h + h * 4 * h) * item + w * b * h * 4
    ops = 2 * w * b * h * 4 * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, cuda_lstm) -> list:
    rows = []
    for w, f in SHAPES:
        for b in (8, 64):
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                layer, x, xz, rec = lstm_inputs(torch, w, f, b, "sigmoid", dtype, seed=1)
                with torch.no_grad():
                    kernel = time_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "sigmoid"), 200)
                    # the same launch behind the dispatcher (hfrep::lstm_fwd),
                    # as the no-grad forward and the exported programs call it
                    op = time_ms(torch, lambda: cuda_lstm.lstm_fwd_op(xz, rec, "sigmoid", False),
                                 200)
                    dev = device_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "sigmoid"), 50)
                    plain = time_ms(torch, lambda: cuda_lstm.lstm_seq_plain(xz, rec, "sigmoid"), 5, 1)
                    kx = layer.kernel.to(dtype)
                    kb = layer.bias.to(dtype)
                    xd = x.to(dtype)

                    def with_projection():
                        z = (xd.reshape(b * w, f) @ kx + kb).reshape(b, w, 4 * HIDDEN)
                        cuda_lstm.lstm_fwd_cuda(z.transpose(0, 1).contiguous(), rec, "sigmoid")

                    kernel_proj = time_ms(torch, with_projection, 200)
                    library = library_dev = None
                    if name == "float32":
                        lstm = torch.nn.LSTM(f, HIDDEN).cuda()
                        lstm.weight_ih_l0.copy_(layer.kernel.T)
                        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
                        lstm.bias_ih_l0.copy_(layer.bias)
                        lstm.bias_hh_l0.zero_()
                        xt = x.transpose(0, 1).contiguous()
                        library = time_ms(torch, lambda: lstm(xt), 200)
                        library_dev = device_ms(torch, lambda: lstm(xt), 50, match="")
                bnd, by = bound_ms(w, b, HIDDEN, name)
                row = {"W": w, "F": f, "B": b, "dtype": name, "ms": kernel, "op_ms": op,
                       "us_per_step": kernel / w * 1e3, "device_ms": dev,
                       "ms_with_projection": kernel_proj, "plain_ms": plain,
                       "library_ms": library, "library_device_ms": library_dev,
                       "bound_ms": bnd, "bound_by": by}
                rows.append(row)
                lib_s = ("n/a" if library is None
                         else f"{library:.4f} (device {library_dev:.4f})")
                say(f"[timing] lstm_fwd W={w:3d} B={b:2d} {name:8s}: kernel {kernel:.4f} ms "
                    f"(through the op {op:.4f} ms; "
                    f"{kernel / w * 1e3:.3f} us a step; device {dev:.4f} ms, "
                    f"{dev / w * 1e3:.3f} us a step; +projection {kernel_proj:.4f}), "
                    f"plain {plain:.3f} ms, cuDNN LSTM {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def grad_work(w, b, h, dtype_name) -> dict:
    """{kernel: (bytes, seconds of operations)} for the single-layer
    kernels at (W, B, H): each input read once and each output written
    once; each product of 2*W*B*H*4H over the peak for its operands' type
    (products with rec are in the operand dtype, products with v and the
    drec/urec sums in float32).  The carry modes add their (B, H) arrays
    — forward: h0, c0 and c_fin (with_cs: h0, c0); backward: h0, c0,
    dc_fin, dh0, dc0; adjoint: h0, c0, mu_h0, mu_c0, cot(dc_fin),
    cot(h0), cot(c0) — and no operations: the step-0 products replace
    products with zero rows that the carry-free reckoning counts too."""
    item = 4 if dtype_name == "float32" else 2
    seq, g32, st = w * b * h * 4, w * b * 4 * h * 4, b * h * 4
    xzb, recb, mat32 = w * b * 4 * h * item, 4 * h * h * item, 4 * h * h * 4
    prod = 2 * w * b * h * 4 * h
    peak, f32 = PEAK_OPS_PER_S[dtype_name], PEAK_OPS_PER_S["float32"]
    work = {"lstm_fwd": (xzb + recb + seq, prod / peak),
            "lstm_fwd_cs": (xzb + recb + 2 * seq, prod / peak),
            "lstm_bwd": (xzb + recb + 3 * seq + g32 + mat32, 2 * prod / peak + prod / f32),
            "lstm_adj": (xzb + recb + mat32 + 4 * seq + 2 * g32 + 3 * seq + mat32,
                         3 * prod / peak + 4 * prod / f32)}
    for k, extra in (("lstm_fwd", 3), ("lstm_fwd_cs", 2), ("lstm_bwd", 5), ("lstm_adj", 7)):
        nbytes, t_ops = work[k]
        work[f"{k}_carry"] = (nbytes + extra * st, t_ops)
    return work


def grad_bounds(w, b, h, dtype_name) -> dict:
    """Least time for each kernel and mode of :func:`grad_work` at
    (W, B, H): the larger of its bytes over 3.35 TB/s and its operations'
    time, in ms, with which of the two bounds it."""
    out = {}
    for k, (nbytes, t_ops) in grad_work(w, b, h, dtype_name).items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


#: the passes of an lstm_adj call in its register layout, by kernel name
ADJ_PASSES = (("pre-pass", "stack_gates"), ("sweep", "lstm_adj_kernel"),
              ("post-pass", "lstm_adj_post"), ("sum", "hfrep::ws::"))


def adj_passes(torch, call) -> dict:
    """The profiler's device time, in ms, of each pass of one ``lstm_adj``
    call (:data:`ADJ_PASSES`), each by :func:`device_ms`."""
    return {k: device_ms(torch, call, 20, match=m) for k, m in ADJ_PASSES}


def passes_text(parts: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in parts.items()) + " us"


def phase_grad_timing(torch, cuda_lstm) -> list:
    rows = []
    h = HIDDEN
    for w, f in SHAPES:
        for b in TIMING_BATCHES:
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                layer, x, xz, rec = lstm_inputs(torch, w, f, b, "tanh", dtype, seed=3)
                g = torch.Generator(device="cuda")
                g.manual_seed(4)
                with torch.no_grad():
                    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs=True)
                    dhs = 0.3 * torch.randn((w, b, h), generator=g, device="cuda")
                    _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None,
                                                             "tanh", True)
                    u = 0.3 * torch.randn((w, b, 4 * h), generator=g, device="cuda")
                    v = 0.3 * torch.randn((h, 4 * h), generator=g, device="cuda")
                    calls = {
                        "lstm_fwd_cs": (
                            lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs=True),
                            lambda: cuda_lstm.lstm_seq_plain(xz, rec, "tanh", with_cs=True)),
                        "lstm_bwd": (
                            lambda: cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None, "tanh"),
                            lambda: cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, dhs, None, "tanh")),
                        "lstm_adj": (
                            lambda: cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, u, v, "tanh"),
                            lambda: cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, u, v,
                                                             "tanh"))}
                    times = {k: (time_ms(torch, kern, 50), time_ms(torch, plain, 2, 1))
                             for k, (kern, plain) in calls.items()}
                    # the primal at the same shape and activation, beside with_cs
                    primal = time_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh"), 50)
                    dev = {"lstm_fwd_cs": device_ms(torch, calls["lstm_fwd_cs"][0], 30),
                           "primal": device_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(
                               xz, rec, "tanh"), 30),
                           # every kernel of a call: pre-pass, sweep, weight sum
                           "lstm_bwd": device_ms(torch, calls["lstm_bwd"][0], 30, match=""),
                           "lstm_adj": device_ms(torch, calls["lstm_adj"][0], 20, match="")}
                    adj_split = adj_passes(torch, calls["lstm_adj"][0])
                library = {"lstm_fwd_cs": None, "lstm_bwd": None, "lstm_adj": None}
                if name == "float32":
                    lstm = torch.nn.LSTM(f, h).cuda()
                    with torch.no_grad():
                        lstm.weight_ih_l0.copy_(layer.kernel.T)
                        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
                        lstm.bias_ih_l0.copy_(layer.bias)
                        lstm.bias_hh_l0.zero_()
                    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
                    gout = torch.randn((w, b, h), generator=g, device="cuda")

                    def fwd_bwd():
                        out, _ = lstm(xt)
                        out.backward(gout)

                    fwd = time_ms(torch, lambda: lstm(xt), 50)
                    library["lstm_fwd_cs"] = fwd
                    library["lstm_bwd"] = time_ms(torch, fwd_bwd, 50) - fwd
                    dev["library"] = device_ms(torch, lambda: lstm(xt), 30, match="")
                bounds = grad_bounds(w, b, h, name)
                for k, (ms, plain) in times.items():
                    bnd, by = bounds[k]
                    rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": name,
                                 "ms": ms, "plain_ms": plain, "library_ms": library[k],
                                 "bound_ms": bnd, "bound_by": by})
                    lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
                    extra = ""
                    if k == "lstm_fwd_cs":
                        rows[-1].update(primal_ms=primal, us_per_step=ms / w * 1e3,
                                        device_ms=dev[k], primal_device_ms=dev["primal"],
                                        library_device_ms=dev.get("library"))
                        extra = (f" ({ms / w * 1e3:.3f} us a step; device {dev[k]:.4f} ms, "
                                 f"{dev[k] / w * 1e3:.3f} us a step; primal, same tanh: "
                                 f"{primal:.4f}, device {dev['primal']:.4f})")
                        if "library" in dev:
                            lib_s += f" (device {dev['library']:.4f})"
                    else:
                        rows[-1]["device_ms"] = dev[k]
                        extra = f" (device {dev[k]:.4f}, every kernel of a call)"
                        if k == "lstm_adj":
                            rows[-1]["device_ms_by_pass"] = adj_split
                            extra = (f" (device {dev[k]:.4f}, every kernel of a call: "
                                     f"{passes_text(adj_split)})")
                    say(f"[timing] {k:11s} W={w:3d} B={b:2d} {name:8s}: kernel {ms:.4f} ms{extra}, "
                        f"plain {plain:.3f} ms, cuDNN {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def carry_draws(torch, w, b, seed):
    """A nonzero carry (h0, c0) at chip_check_carry's 0.5 scale and seeded
    cotangents at the grad phase's 0.3: dhs, dcs, dc_fin, u, v and mu0."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rnd = lambda s, *shape: s * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    h = HIDDEN
    carry = (rnd(0.5, b, h), rnd(0.5, b, h))
    cots = dict(dhs=rnd(0.3, w, b, h), dcs=rnd(0.3, w, b, h), dc_fin=rnd(0.3, b, h),
                u=rnd(0.3, w, b, 4 * h), v=rnd(0.3, h, 4 * h),
                mu0=(rnd(0.3, b, h), rnd(0.3, b, h)))
    return carry, cots


def carry_calls(cuda_lstm, xz, rec, act, carry, c, kernel: bool) -> dict:
    """{row: [outputs of each mode]}: the kernel wrappers (``kernel``) or
    the plain versions, every carry mode on the same inputs."""
    fwd = cuda_lstm.lstm_fwd_cuda if kernel else cuda_lstm.lstm_seq_plain
    bwd = cuda_lstm.lstm_bwd_cuda if kernel else cuda_lstm.lstm_bwd_plain
    adj = cuda_lstm.lstm_adj_cuda if kernel else cuda_lstm.lstm_adj_plain
    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, carry)    # the residuals, as the path
    _, _, dhT, dcT, _, _ = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], None, act, True,
                                                   carry, c["dc_fin"])
    return {"lstm_fwd_carry": [fwd(xz, rec, act, False, carry), fwd(xz, rec, act, True, carry)],
            "lstm_bwd_carry": [bwd(xz, rec, hs, cs, c["dhs"], dcs, act, carries, carry,
                                   c["dc_fin"])
                               for dcs, carries in ((None, False), (c["dcs"], False),
                                                    (None, True))],
            "lstm_adj_carry": [adj(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act, carry,
                                   c["mu0"])]}


def phase_carry_parity(torch, cuda_lstm) -> dict:
    """(a) Each carry mode of kernels 1–3 against its plain version on the
    same inputs, at the grad phase's shapes, activations, dtypes and
    scaled bars: the forward's carry primal and with_cs modes, the
    backward's carry0 mode alone, with dcs and with the per-step carries
    (each with dc_fin), the adjoint's carry mode (with mu0)."""
    names = ("lstm_fwd_carry", "lstm_bwd_carry", "lstm_adj_carry")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    t0 = time.perf_counter()
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype, seed=w + b + 3)
                    carry, c = carry_draws(torch, w, b, seed=w * b + 3)
                    with torch.no_grad():
                        got = carry_calls(cuda_lstm, xz, rec, act, carry, c, True)
                        ref = carry_calls(cuda_lstm, xz, rec, act, carry, c, False)
                    torch.cuda.synchronize()
                    line = []
                    for k in names:
                        pairs = [(a, r) for g_, r_ in zip(got[k], ref[k]) for a, r in zip(g_, r_)]
                        for a, r in pairs:
                            if a.shape != r.shape or not torch.isfinite(a).all():
                                fail(f"{k} output not finite/shaped at W={w} B={b} {act} {name}")
                        err = max(scaled_err(a, r) for a, r in pairs)
                        worst[k][name] = max(worst[k][name], err)
                        worst_abs[k][name] = max(worst_abs[k][name], max(
                            float((a - r).abs().max()) for a, r in pairs))
                        line.append(f"{k} {err:.2e}")
                        if not err <= GRAD_BARS[name]:
                            fail(f"{k} disagrees with its plain version: {err} > "
                                 f"{GRAD_BARS[name]} at W={w} B={b} {act} {name}")
                    say(f"[carry] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
                        f"{', '.join(line)} (limit {GRAD_BARS[name]:.0e})")
    seconds = time.perf_counter() - t0
    say(f"[carry] parity in {seconds:.1f} s")
    return {"scaled": worst, "abs": worst_abs, "seconds": seconds}


def allclose_err(got, ref, atol, rtol) -> float:
    """max |got - ref| / (atol + rtol |ref|): at most 1 within the bar."""
    return float(((got.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max())


def phase_carry_path(torch, cuda_lstm) -> dict:
    """(b) The carry path at full width: the W=168, B=32, H=100 window in
    float32 as four chunks of 42 that pass (h, c) on through
    ``lstm_seq_carry``, against the whole window, for sigmoid and tanh.

    From a zero start the whole window is ``lstm_seq`` (the carry-free
    kernels): hs, the final c (``lstm_seq``'s residual cs at W-1), the
    gradients of xz and rec under a loss on hs, and the ``gp_like``
    second order (the input-gradient penalty of sum(hs)) in xz and rec.
    From chip_check_carry's nonzero (h0, c0) the whole window is the
    plain carry forward, differentiated by torch: hs and the final c,
    the gradients of xz, rec, h0 and c0 under chip_check_carry's loss
    (hs·wts + c_fin·u), and its ``gp_like`` in all four.  Bars: the JAX
    suite's, forward atol 1e-5, gradients atol 1e-5 + rtol 1e-4, second
    order atol 2e-4 + rtol 1e-4.  Every whole-window reference is formed
    first; then every launch count is set to 0, the chunked runs go, and
    exactly the four carry modes must have launched."""
    h, w, f, b, cut = HIDDEN, 168, 36, 32, 42
    t_phase = time.perf_counter()
    bars = {"forward": (1e-5, 0.0), "first": (1e-5, 1e-4), "second": (2e-4, 1e-4)}

    def chunked(xz, rec, h0, c0, act):
        hs, hh, cc = [], h0, c0
        for k in range(0, w, cut):
            hs_k, cc = cuda_lstm.lstm_seq_carry(xz[k:k + cut], rec, hh, cc, act)
            hs.append(hs_k)
            hh = hs_k[-1]
        return torch.cat(hs), cc

    def gp_like(fn, args, wrt, act):
        hs, c_fin = fn(*args, act)
        gr = torch.autograd.grad(hs.sum() + (0 if c_fin is None else c_fin.sum()),
                                 [args[i] for i in wrt], create_graph=True)
        pen = (1.0 - torch.sqrt(sum((t ** 2).sum() for t in gr) + 1e-12)) ** 2
        return torch.autograd.grad(pen, args)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    cases, refs = [], []
    for act in ("sigmoid", "tanh"):
        _, _, xz, rec = lstm_inputs(torch, w, f, b, act, torch.float32, seed=168)
        g = torch.Generator(device="cuda")
        g.manual_seed(42)
        h0, c0 = (0.5 * torch.randn((b, h), generator=g, device="cuda") for _ in range(2))
        wts = torch.randn((w, b, h), generator=g, device="cuda")
        u = torch.randn((b, h), generator=g, device="cuda")
        zero = torch.zeros((b, h), device="cuda")
        cases.append((act, xz, rec, h0, c0, wts, u, zero))
        # zero start: the whole window through lstm_seq's kernels
        ref = {}
        with torch.no_grad():
            ref["zero hs"], cs = cuda_lstm.lstm_fwd(xz, rec, act, with_cs=True)
            ref["zero c_fin"] = cs[-1]
        args = leaves(xz, rec)
        ref["zero first"] = torch.autograd.grad((cuda_lstm.lstm_seq(*args, act) * wts).sum(),
                                                args)
        ref["zero second"] = gp_like(lambda x, r, a: (cuda_lstm.lstm_seq(x, r, a), None),
                                     leaves(xz, rec), (0,), act)
        # nonzero start: the whole window through the plain carry forward
        def plain(x, r, a, b_, act_):
            return cuda_lstm.lstm_seq_plain(x, r, act_, carry=(a, b_))
        with torch.no_grad():
            ref["carry hs"], ref["carry c_fin"] = plain(xz, rec, h0, c0, act)
        args = leaves(xz, rec, h0, c0)
        hs_p, cf_p = plain(*args, act)
        ref["carry first"] = torch.autograd.grad((hs_p * wts).sum() + (cf_p * u).sum(), args)
        ref["carry second"] = gp_like(plain, leaves(xz, rec, h0, c0), (0, 2, 3), act)
        refs.append(ref)
    torch.cuda.synchronize()

    cuda_lstm.reset_launches()
    t0 = time.perf_counter()
    gots = []
    for act, xz, rec, h0, c0, wts, u, zero in cases:
        got = {}
        with torch.no_grad():
            got["zero hs"], got["zero c_fin"] = chunked(xz, rec, zero, zero, act)
            got["carry hs"], got["carry c_fin"] = chunked(xz, rec, h0, c0, act)
        args = leaves(xz, rec, zero, zero)
        got["zero first"] = torch.autograd.grad((chunked(*args, act)[0] * wts).sum(),
                                                args[:2])
        args = leaves(xz, rec, zero, zero)
        got["zero second"] = gp_like(lambda x, r, a, c_, act_: (chunked(x, r, a, c_, act_)[0],
                                                                None),
                                     args, (0,), act)[:2]
        args = leaves(xz, rec, h0, c0)
        hs_c, cf_c = chunked(*args, act)
        got["carry first"] = torch.autograd.grad((hs_c * wts).sum() + (cf_c * u).sum(), args)
        got["carry second"] = gp_like(chunked, leaves(xz, rec, h0, c0), (0, 2, 3), act)
        gots.append(got)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lstm.launch_counts()
    launched = {k for k, n in launches.items() if n}
    want = {"lstm_fwd_carry", "lstm_fwd_cs_carry", "lstm_bwd_carry", "lstm_adj_carry"}
    if launched != want:
        fail(f"the carry path launched {sorted(launched)}, expected exactly {sorted(want)} "
             f"({launches})")
    worst = {}
    for (act, *_), got, ref in zip(cases, gots, refs):
        line = []
        for key in got:
            order = key.split()[-1] if key.split()[-1] in bars else "forward"
            atol, rtol = bars[order]
            outs = got[key] if isinstance(got[key], (tuple, list)) else [got[key]]
            refs_ = ref[key] if isinstance(ref[key], (tuple, list)) else [ref[key]]
            err = 0.0
            for a, r in zip(outs, refs_):
                if a.shape != r.shape or not torch.isfinite(a).all():
                    fail(f"carry path {act} {key}: not finite/shaped")
                err = max(err, allclose_err(a.detach(), r.detach(), atol, rtol))
            worst[f"{act} {key}"] = err
            line.append(f"{key} {err:.3f}")
            if not err <= 1.0:
                fail(f"carry path {act}: {key} differs from the whole window "
                     f"({err:.3f} of the bar atol {atol:g} + rtol {rtol:g})")
        say(f"[carry] path W={w} as {w // cut} chunks of {cut}, B={b}, {act}: error as a share "
            f"of the bar: {', '.join(line)}")
    seconds = time.perf_counter() - t_phase
    say("[carry] path launches: " + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
        + f"; chunked runs {wall:.2f} s, phase {seconds:.1f} s")
    return {"launches": launches, "worst_share_of_bar": worst, "chunked_s": wall,
            "seconds": seconds}


def phase_carry_timing(torch, cuda_lstm) -> list:
    """(c) CUDA events for each carry mode at W=48, B=32, H=100, float32,
    tanh, beside the same kernel's carry-free mode, its bound
    (``grad_bounds``), its plain version and ``library_ms``: cuDNN's LSTM
    called with hx=(h0, c0) — under no_grad for the carry primal forward,
    in training mode for the carry with_cs forward, forward and backward
    (h0 and c0 needing a gradient) minus forward for the backward; none
    for the adjoint."""
    w, f, b, h = 48, 35, 32, HIDDEN
    layer, x, xz, rec = lstm_inputs(torch, w, f, b, "tanh", torch.float32, seed=3)
    carry, c = carry_draws(torch, w, b, seed=4)
    with torch.no_grad():
        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", True, carry)
        dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], None, "tanh", True,
                                           carry, c["dc_fin"])[2:4]
        args = {"fwd": (xz, rec, "tanh"), "bwd": (xz, rec, hs, cs, c["dhs"], None, "tanh"),
                "adj": (xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], "tanh")}
        calls = {   # carry mode, its carry-free mode, the plain carry version
            "lstm_fwd_carry": (lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], False, carry),
                               lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], False),
                               lambda: cuda_lstm.lstm_seq_plain(*args["fwd"], False, carry)),
            "lstm_fwd_cs_carry": (lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], True, carry),
                                  lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], True),
                                  lambda: cuda_lstm.lstm_seq_plain(*args["fwd"], True, carry)),
            "lstm_bwd_carry": (
                lambda: cuda_lstm.lstm_bwd_cuda(*args["bwd"], False, carry, c["dc_fin"]),
                lambda: cuda_lstm.lstm_bwd_cuda(*args["bwd"]),
                lambda: cuda_lstm.lstm_bwd_plain(*args["bwd"], False, carry, c["dc_fin"])),
            "lstm_adj_carry": (lambda: cuda_lstm.lstm_adj_cuda(*args["adj"], carry, c["mu0"]),
                               lambda: cuda_lstm.lstm_adj_cuda(*args["adj"]),
                               lambda: cuda_lstm.lstm_adj_plain(*args["adj"], carry, c["mu0"]))}
        times = {k: (time_ms(torch, kern, 50), time_ms(torch, free, 50), time_ms(torch, plain, 2, 1))
                 for k, (kern, free, plain) in calls.items()}
        dev = {k: (device_ms(torch, calls[k][0], 30), device_ms(torch, calls[k][1], 30))
               for k in ("lstm_fwd_carry", "lstm_fwd_cs_carry")}
        # the adjoint's carry mode: every kernel of a call, and its passes
        dev["lstm_adj_carry"] = tuple(device_ms(torch, calls["lstm_adj_carry"][i], 20, match="")
                                      for i in (0, 1))
        adj_split = adj_passes(torch, calls["lstm_adj_carry"][0])
    lstm = torch.nn.LSTM(f, h).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(layer.kernel.T)
        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
        lstm.bias_ih_l0.copy_(layer.bias)
        lstm.bias_hh_l0.zero_()
    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
    hx = tuple(t[None].clone().requires_grad_(True) for t in carry)
    gout = torch.randn((w, b, h), device="cuda")

    def fwd_bwd():
        out, _ = lstm(xt, hx)
        out.backward(gout)

    with torch.no_grad():
        lib_primal = time_ms(torch, lambda: lstm(xt, hx), 50)
        lib_dev = {"lstm_fwd_carry": device_ms(torch, lambda: lstm(xt, hx), 30, match="")}
    fwd = time_ms(torch, lambda: lstm(xt, hx), 50)
    lib_dev["lstm_fwd_cs_carry"] = device_ms(torch, lambda: lstm(xt, hx), 30, match="")
    library = {"lstm_fwd_carry": lib_primal, "lstm_fwd_cs_carry": fwd,
               "lstm_bwd_carry": time_ms(torch, fwd_bwd, 50) - fwd, "lstm_adj_carry": None}
    bounds = grad_bounds(w, b, h, "float32")
    rows = []
    for k, (ms, free_ms, plain) in times.items():
        bnd, by = bounds[k]
        rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": "float32", "ms": ms,
                     "us_per_step": ms / w * 1e3,
                     "carry_free_ms": free_ms, "plain_ms": plain, "library_ms": library[k],
                     "bound_ms": bnd, "bound_by": by})
        lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
        say(f"[timing] {k:17s} W={w} B={b} float32: kernel {ms:.4f} ms ({ms / w * 1e3:.3f} "
            f"us a step; carry-free {free_ms:.4f}, {100 * (ms / free_ms - 1):+.1f}%), plain "
            f"{plain:.3f} ms, cuDNN with hx {lib_s} ms, bound {bnd:.5f} ms ({by})")
        if k in dev:
            rows[-1].update(device_ms=dev[k][0], carry_free_device_ms=dev[k][1],
                            library_device_ms=lib_dev.get(k))
            lib_s = "n/a" if k not in lib_dev else f"{lib_dev[k]:.4f}"
            say(f"[timing] {k:17s} W={w} B={b} float32: device {dev[k][0]:.4f} ms "
                f"({dev[k][0] / w * 1e3:.3f} us a step; carry-free {dev[k][1]:.4f}), "
                f"cuDNN with hx device {lib_s} ms")
        if k == "lstm_adj_carry":
            rows[-1]["device_ms_by_pass"] = adj_split
            say(f"[timing] {k:17s} W={w} B={b} float32: device by pass {passes_text(adj_split)}")
    return rows


def stack_bounds(w, b, h, dtype_name) -> dict:
    """Least time for each stack kernel at (W, B, H), as ``grad_bounds``
    reckons: each input read once and each output written once (the
    sweeps' workspaces are not counted) over 3.35 TB/s; each product of
    2*W*B*H*4H over the peak for its operands' type — products with an
    operand-dtype matrix in that dtype, products with a v-stream and the
    W*B-row sums in float32.  Forward: 3 products; backward: 6 + 3 sums;
    adjoint: 9 + 12."""
    item = 4 if dtype_name == "float32" else 2
    seq, g32 = w * b * h * 4, w * b * 4 * h * 4
    xzb, mat, vec = w * b * 4 * h * item, 4 * h * h * item, 4 * h * item
    mat32, vec32 = 4 * h * h * 4, 4 * h * 4
    weights = xzb + 3 * mat + vec
    prod = 2 * w * b * h * 4 * h
    peak, f32 = PEAK_OPS_PER_S[dtype_name], PEAK_OPS_PER_S["float32"]
    work = {"stack_fwd": (weights + 4 * seq, 3 * prod / peak),
            "stack_bwd": (weights + 5 * seq + g32 + 3 * mat32 + vec32,
                          6 * prod / peak + 3 * prod / f32),
            "stack_adj": (weights + 8 * seq + g32 + 3 * mat32 + vec32
                          + g32 + 3 * mat32 + vec32 + 5 * seq,
                          9 * prod / peak + 12 * prod / f32)}
    out = {}
    for k, (nbytes, t_ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_stack_timing(torch, cuda_lstm, cuda_lstm_stack) -> list:
    """CUDA events for each stack kernel in the mode the epoch runs it
    (forward with_res, plain backward, adjoint), beside its bound, its
    plain version, ``library_ms`` and the chained pair it replaces: the
    two single-layer kernels of the same mode at the same shape, with the
    layer-2 projection matmul between the forwards and the dz2 . k2^T
    matmul between the backwards (the adjoints: the two kernels alone).
    The library is ``torch.nn.LSTM(F, H, num_layers=2)`` at tanh with the
    same weights: its forward in training mode (input projection
    included, so the kernel's "+projection" time stands beside it) for
    the forward, forward-and-backward minus forward for the backward,
    none for the adjoint (the cuDNN RNN has no double backward)."""
    cls = cuda_lstm_stack
    rows = []
    h = HIDDEN
    for w, f in SHAPES:
        for b in TIMING_BATCHES:
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                (l0, l1), x, wts = stack_inputs(torch, w, f, b, "tanh", dtype, seed=5)
                xz1, rec1, k2, b2, rec2 = wts
                g = torch.Generator(device="cuda")
                g.manual_seed(6)
                rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                with torch.no_grad():
                    res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                    hs1, cs1, hs2, cs2 = res
                    dhs2 = rnd(w, b, h)
                    carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", True)[5:]
                    cots = (rnd(w, b, 4 * h), rnd(h, 4 * h), rnd(h, 4 * h), rnd(4 * h),
                            rnd(h, 4 * h))
                    xz2 = ((hs1.reshape(w * b, h).to(dtype) @ k2 + b2)
                           .reshape(w, b, 4 * h).contiguous())
                    hs2c, cs2c = cuda_lstm.lstm_fwd_cuda(xz2, rec2, "tanh", with_cs=True)
                    _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dhs2, None,
                                                             "tanh", True)
                    u, v = cots[0], cots[1]

                    def chained_fwd():
                        h1, _ = cuda_lstm.lstm_fwd_cuda(xz1, rec1, "tanh", with_cs=True)
                        z2 = (h1.reshape(w * b, h).to(dtype) @ k2 + b2).reshape(w, b, 4 * h)
                        cuda_lstm.lstm_fwd_cuda(z2.contiguous(), rec2, "tanh", with_cs=True)

                    def chained_bwd():
                        dxz2, _ = cuda_lstm.lstm_bwd_cuda(xz2, rec2, hs2c, cs2c, dhs2, None,
                                                          "tanh")
                        dh1 = (dxz2.reshape(w * b, 4 * h) @ k2.float().T).reshape(w, b, h)
                        cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dh1.contiguous(), None,
                                                "tanh")

                    def chained_adj():
                        cuda_lstm.lstm_adj_cuda(xz1, rec1, hs1, cs1, dhT, dcT, u, v, "tanh")
                        cuda_lstm.lstm_adj_cuda(xz2, rec2, hs2c, cs2c, dhT, dcT, u, v, "tanh")

                    calls = {
                        "stack_fwd": (lambda: cls.stack_fwd_cuda(*wts, "tanh", with_res=True),
                                      lambda: cls.stack_seq_plain(*wts, "tanh", with_res=True),
                                      chained_fwd),
                        "stack_bwd": (lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh"),
                                      lambda: cls.stack_bwd_plain(*wts, *res, dhs2, None, "tanh"),
                                      chained_bwd),
                        "stack_adj": (lambda: cls.stack_adj_cuda(*wts, *res, *carried, *cots,
                                                                 "tanh"),
                                      lambda: cls.stack_adj_plain(*wts, *res, *carried, *cots,
                                                                  "tanh"),
                                      chained_adj)}
                    times = {k: (time_ms(torch, kern, 30), time_ms(torch, plain, 2, 1),
                                 time_ms(torch, pair, 30))
                             for k, (kern, plain, pair) in calls.items()}
                    # the profiler's device time: the kernel (and, for the
                    # sweeps, their reductions and transposed copies), and
                    # every kernel of the chained pair
                    dev = {k: (device_ms(torch, kern, 20,
                                         match="stack_fwd" if k == "stack_fwd" else ""),
                               device_ms(torch, pair, 20, match=""))
                           for k, (kern, _, pair) in calls.items()}
                    xd = x.to(dtype)
                    k1, bb1 = l0.kernel.detach().to(dtype), l0.bias.detach().to(dtype)

                    def with_projection():
                        z = (xd.reshape(b * w, f) @ k1 + bb1).reshape(b, w, 4 * h)
                        cls.stack_fwd_cuda(z.transpose(0, 1).contiguous(), rec1, k2, b2, rec2,
                                           "tanh", with_res=True)

                    fwd_proj = time_ms(torch, with_projection, 30)
                library = {"stack_fwd": None, "stack_bwd": None, "stack_adj": None}
                library_dev = {}
                if name == "float32":
                    lstm = torch.nn.LSTM(f, h, num_layers=2).cuda()
                    with torch.no_grad():
                        for layer, mod in enumerate((l0, l1)):
                            getattr(lstm, f"weight_ih_l{layer}").copy_(mod.kernel.T)
                            getattr(lstm, f"weight_hh_l{layer}").copy_(mod.recurrent_kernel.T)
                            getattr(lstm, f"bias_ih_l{layer}").copy_(mod.bias)
                            getattr(lstm, f"bias_hh_l{layer}").zero_()
                    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
                    gout = torch.randn((w, b, h), generator=g, device="cuda")

                    def fwd_bwd():
                        out, _ = lstm(xt)
                        out.backward(gout)

                    fwd = time_ms(torch, lambda: lstm(xt), 30)
                    library["stack_fwd"] = fwd
                    library["stack_bwd"] = time_ms(torch, fwd_bwd, 30) - fwd
                    fwd_dev = device_ms(torch, lambda: lstm(xt), 20, match="")
                    library_dev = {"stack_fwd": fwd_dev,
                                   "stack_bwd": device_ms(torch, fwd_bwd, 20, match="") - fwd_dev}
                bounds = stack_bounds(w, b, h, name)
                for k, (ms, plain, pair) in times.items():
                    bnd, by = bounds[k]
                    rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": name,
                                 "ms": ms, "plain_ms": plain, "library_ms": library[k],
                                 "chained_ms": pair, "bound_ms": bnd, "bound_by": by,
                                 "device_ms": dev[k][0], "chained_device_ms": dev[k][1],
                                 "library_device_ms": library_dev.get(k)})
                    extra = ""
                    if k == "stack_fwd":
                        rows[-1]["ms_with_projection"] = fwd_proj
                        extra = f" (+projection {fwd_proj:.4f})"
                    lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
                    if k in library_dev:
                        lib_s += f" (device {library_dev[k]:.4f})"
                    say(f"[timing] {k:9s} W={w:3d} B={b:2d} {name:8s}: kernel {ms:.4f} ms{extra}, "
                        f"device {dev[k][0]:.4f} ms ({dev[k][0] / w * 1e3:.3f} us a step); "
                        f"chained pair {pair:.4f} ms (device {dev[k][1]:.4f}), plain {plain:.3f} "
                        f"ms, cuDNN 2-layer {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def phase_profile(torch) -> list:
    """``torch.profiler`` over 20 sample dispatches at the served batch
    (bucket 8), per preset, through the programs a server runs on the
    model's resident weights: the bucket's loaded ``torch.export``
    program (``aot_compile``, mode ``"export"``, what serving runs), then
    the export-off server's eager one (mode ``"compiled"``) in the same
    call.  Device time by kernel name and the device's busy share of the
    window (:func:`traced`, a dispatch in its warm-up step)."""
    from hfrep_tpu_torch.serve import aot
    from hfrep_tpu_torch.serve.fixture import fixture_gen_model

    out = []
    for preset in ("mtss_wgan_gp", "mtss_wgan_gp_prod"):
        model = fixture_gen_model(preset, device="cuda")
        w, f = model.cfg.window, model.cfg.features
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        noises = [torch.randn((8, w, f), generator=g, device="cuda") for _ in range(20)]
        for via_export in (True, False):
            program, mode = aot.aot_compile(aot.gen_batch_fn(model), model.params, noises[0],
                                            via_export=via_export)
            if mode != ("export" if via_export else "compiled"):
                fail(f"profile: {preset}'s bucket program came up {mode!r}")

            def fn(z, program=program, params=model.params):
                return program(params, z)

            for z in noises[:3]:
                fn(z).cpu()
            torch.cuda.synchronize()
            wall = []

            def run(fn=fn, wall=wall):
                t0 = time.perf_counter()
                for z in noises:
                    fn(z).cpu()                  # the server copies each answer out
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e6)

            prof = traced(torch, lambda fn=fn: fn(noises[0]).cpu(), run)
            wall_us = wall[0]
            by_name = device_time_by_name(prof)
            busy_us = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            out.append({"preset": preset, "program": mode, "dispatches": len(noises),
                        "wall_us": wall_us, "device_busy_us": busy_us,
                        "busy_share": busy_us / wall_us if busy_us else None,
                        "top": [{"name": k[:80], "us": v} for k, v in top]})
            if not busy_us:
                say(f"[profile] {preset} ({mode}): the profiler reported no device time "
                    f"(not measured)")
                continue
            say(f"[profile] {preset}: 20 dispatches of the {mode} bucket program at B=8 in "
                f"{wall_us:.0f} us, device busy {busy_us:.0f} us "
                f"({100 * busy_us / wall_us:.1f}% of the window)")
            if via_export:
                for k, v in top:
                    say(f"[profile]   {v:9.1f} us  {100 * v / busy_us:5.1f}%  {k[:80]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hfrep_tpu_torch.ops import _build, cuda_lstm, cuda_lstm_stack
    except ImportError as e:
        fail(f"the port (hfrep_tpu_torch) is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(torch)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say("TF32 off for matmuls and cuDNN: every float32 product is full float32")

    t0 = time.perf_counter()
    walls: dict = {}

    def phase(name: str, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[name] = time.perf_counter() - t

    phase("build", phase_build, torch, _build, cuda_lstm, cuda_lstm_stack)
    worst = phase("parity", phase_parity, torch, cuda_lstm)
    layouts = phase("fwd_layouts", phase_fwd_layouts, torch, cuda_lstm)
    bwd_layouts = phase("bwd_layouts", phase_bwd_layouts, torch, cuda_lstm)
    adj_layouts = phase("adj_layouts", phase_adj_layouts, torch, cuda_lstm)
    grad = phase("grad_parity", phase_grad_parity, torch, cuda_lstm)
    carry = phase("carry_parity", phase_carry_parity, torch, cuda_lstm)
    carry_path = phase("carry_path", phase_carry_path, torch, cuda_lstm)
    stack = phase("stack_parity", phase_stack_parity, torch, cuda_lstm_stack)
    stack_layouts = phase("stack_layouts", phase_stack_layouts, torch, cuda_lstm_stack)
    sums = phase("sums", phase_sums, torch, cuda_lstm)
    server = phase("server", phase_server, torch, np, cuda_lstm)
    train = phase("train", phase_train, torch, cuda_lstm, "auto")
    train_chained = phase("train_chained", phase_train, torch, cuda_lstm, "chained",
                          TRAIN_PRESETS[:1])
    keep = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        precision = phase("precision", phase_precision, torch, np, cuda_lstm, train,
                          train_chained, keep)
        trainer = phase("trainer", phase_trainer, torch, np, cuda_lstm, train, keep)
        sweep = phase("sweep", phase_sweep, torch, np, cuda_lstm, keep,
                      trainer["cli_checkpoint"])
        f32_best = sweep["runs"]["real"]["summaries"]["None"]
        say(f"[precision] the bf16 sweep ({PRECISION_SWEEP_EPOCHS} epochs) beside the float32 "
            f"sweep phase's real-only run (1000-epoch cap): best OOS R2 mean "
            f"{precision['sweep']['best_oos_r2']['mean']:.4f} at latent "
            f"{precision['sweep']['best_oos_r2']['latent']} against {f32_best['mean']:.4f} at "
            f"latent {f32_best['latent']}; stop epochs {precision['sweep']['stop_epochs']} "
            f"against {sweep['runs']['real']['stop_epochs']['None']} (recorded, not gated)")
        evaluation, fid_covs = phase("eval", phase_eval, torch, np, cuda_lstm, train, keep,
                                     trainer["cli_checkpoint"])
        scenario = phase("scenario", phase_scenario, torch, np, cuda_lstm, keep)
        pipeline = phase("pipeline", phase_pipeline, torch, np, keep, trainer["cli_checkpoint"])
        health = phase("health", phase_health, torch, np, cuda_lstm, train, train_chained, keep)
        serve_drain = phase("serve_drain", phase_serve_drain, torch, np, keep,
                            trainer["cli_checkpoint"])
        obs_tier = phase("obs_tier", phase_obs_tier, torch, np, keep, trainer["cli_obs_dir"],
                         trainer["cli_launches"])
        forensics = phase("forensics", phase_forensics, torch, np, cuda_lstm, keep, health)
        chaos = phase("chaos", phase_chaos, torch, np, keep)
        mesh = phase("mesh", phase_mesh, torch, np, cuda_lstm, train, keep)
        # (i) of the mesh phase beside the analysis phase (DpTpVerb)
        dp_tp = DpTpVerb(keep)
        try:
            analysis = phase("analysis", phase_analysis, torch, np, fid_covs, train)
            mesh["i"] = phase("mesh_dp_tp", dp_tp.finish, torch)
        finally:
            dp_tp.stop()
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    timing = phase("timing", phase_timing, torch, cuda_lstm)
    grad_timing = phase("grad_timing", phase_grad_timing, torch, cuda_lstm)
    carry_timing = phase("carry_timing", phase_carry_timing, torch, cuda_lstm)
    stack_timing = phase("stack_timing", phase_stack_timing, torch, cuda_lstm, cuda_lstm_stack)
    profiled = phase("profile", phase_profile, torch)
    say("[walls] phase walls (s, host clock): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s on {card}")

    # launches on the main paths: the fused epochs (slice 3), the chained
    # ones (slice 2), the trainer's 12 epochs on the committed panel and the
    # train-gan verb (slice 12), the metrics' train-gan --eval and fakes, the
    # conditional epochs on both routes and the first bank run (slice 14),
    # each read just after its own run
    by_route = {}
    for route, runs in (("train_fused", [r["launches"] for r in train]),
                        ("train_chained", [r["launches"] for r in train_chained]),
                        ("trainer", [trainer["launches"]]),
                        ("train_gan_cli", [trainer["cli_launches"]]),
                        ("eval", [evaluation["launches"]]),
                        ("scenario_epoch", [r["launches"] for r in scenario["epochs"]]),
                        ("scenario_bank", [scenario["bank"]["launches"]]),
                        ("health_fused", [health["routes"]["auto"]["launches"]]),
                        ("health_chained", [health["routes"]["chained"]["launches"]]),
                        ("bf16_fused", [r["launches"] for r in precision["epochs"]
                                        if r["route"] == "auto"]),
                        ("bf16_chained", [r["launches"] for r in precision["epochs"]
                                          if r["route"] == "chained"]),
                        ("bf16_train_gan_cli", [precision["train_gan"]["launches"]]),
                        ("mesh_dp1", [mesh["a"]["launches"]]),
                        ("mesh_dp2_rank0", [mesh["b"][0]["launches"]]),
                        ("mesh_dp2_rank1", [mesh["b"][1]["launches"]]),
                        ("mesh_pp_rank0", [mesh["f"]["launches"][0]]),
                        ("mesh_pp_rank1", [mesh["f"]["launches"][1]]),
                        ("mesh_sp_rank0", [mesh["g"]["launches"][0]]),
                        ("mesh_sp_rank1", [mesh["g"]["launches"][1]]),
                        *((f"mesh_sp_{k}_rank{r}", [mesh["g_more"][k]["launches"][r]])
                          for k in MESH_SP_FAMILIES + ("bf16",) for r in (0, 1))):
        counts = {k: sum(r[k] for r in runs) for k in cuda_lstm.launch_counts()}
        counts["stack_fwd"] += counts.pop("stack_fwd_res")
        by_route[route] = counts
    trained = {k: sum(c[k] for c in by_route.values()) for k in by_route["train_fused"]}
    head = next(r for r in timing if r["W"] == 48 and r["B"] == 8 and r["dtype"] == "float32")
    rows = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "hfrep_tpu_torch/csrc/lstm_fwd.cu", "replaces": TPU_KERNEL,
        "launches": (server["launches"] + trained["lstm_fwd"]
                     + analysis["serve_sample"]["launches"]
                     + trainer["serve_launches"]["lstm_fwd"]
                     + sweep["sweep_gan_checkpoint_launches"]
                     + pipeline["a"]["launches"]["gen_g0"]["lstm_fwd"]
                     + serve_drain["a"]["launches"]["lstm_fwd"]),
        "launches_by_path": {"serve": server["launches"],
                             "analysis_serve_sample": analysis["serve_sample"]["launches"],
                             "serve_drain": serve_drain["a"]["launches"]["lstm_fwd"],
                             "serve_gan_checkpoint": trainer["serve_launches"]["lstm_fwd"],
                             "sweep_gan_checkpoint": sweep["sweep_gan_checkpoint_launches"],
                             "pipeline": pipeline["a"]["launches"]["gen_g0"]["lstm_fwd"],
                             **{p: c["lstm_fwd"] for p, c in by_route.items()}},
        "max_abs_err": worst["float32"], "max_abs_err_bf16": worst["bfloat16"],
        "max_err_by_layout": layouts, "us_per_step": head["us_per_step"],
        "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
        "ms": head["ms"], "op_ms": head["op_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": "W=48 B=8 H=100 float32"}]
    for k in ("lstm_fwd_cs", "lstm_bwd", "lstm_adj"):
        r = next(x for x in grad_timing if x["kernel"] == k and x["W"] == 48
                 and x["B"] == 32 and x["dtype"] == "float32")
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": trained[k],
            "launches_by_path": {p: c[k] for p, c in by_route.items()},
            "max_abs_err": grad["abs"][k]["float32"],
            "max_abs_err_bf16": grad["abs"][k]["bfloat16"],
            "max_scaled_err": grad["scaled"][k]["float32"],
            "max_scaled_err_bf16": grad["scaled"][k]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "W=48 B=32 H=100 float32"})
        if "device_ms" in r:
            rows[-1].update(device_ms=r["device_ms"],
                            library_device_ms=r.get("library_device_ms"))
    rows[-2]["layouts"] = {"registers": "H <= 100: every preset, the main path's; a gate "
                                        "pre-pass, the quad sweep and the weight sum",
                           "wide": "100 < H within one block's shared memory"}
    rows[-2]["max_err_by_layout"] = bwd_layouts
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    rows[-1]["layouts"] = {"registers": "H <= 100: every preset, the main path's; a gates and "
                                        "v-product pre-pass, the quad sweep, the transposed "
                                        "post-pass and the weight sum",
                           "wide": "100 < H within one block's shared memory"}
    rows[-1]["max_err_by_layout"] = adj_layouts
    rows[-1]["device_ms_by_pass"] = next(
        x for x in grad_timing if x["kernel"] == "lstm_adj" and x["W"] == 48 and x["B"] == 32
        and x["dtype"] == "float32")["device_ms_by_pass"]
    # the carry modes: launches from the carry path's run (phase_carry_path)
    # and from the main paths (the sp ranks' chunks)
    timed = {r["kernel"]: r for r in carry_timing}
    path_launches = carry_path["launches"]
    for k, modes in (("lstm_fwd_carry", ("lstm_fwd_carry", "lstm_fwd_cs_carry")),
                     ("lstm_bwd_carry", ("lstm_bwd_carry",)),
                     ("lstm_adj_carry", ("lstm_adj_carry",))):
        r = timed["lstm_fwd_cs_carry" if k == "lstm_fwd_carry" else k]
        carry_by_path = {"carry_path": sum(path_launches[m] for m in modes),
                         **{p: sum(c[m] for m in modes) for p, c in by_route.items()}}
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": sum(carry_by_path.values()),
            "launches_by_path": carry_by_path,
            "launches_by_mode": {m: path_launches[m] + sum(c[m] for c in by_route.values())
                                 for m in modes},
            "max_abs_err": carry["abs"][k]["float32"],
            "max_abs_err_bf16": carry["abs"][k]["bfloat16"],
            "max_scaled_err": carry["scaled"][k]["float32"],
            "max_scaled_err_bf16": carry["scaled"][k]["bfloat16"],
            "ms": r["ms"], "carry_free_ms": r["carry_free_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": "W=48 B=32 H=100 float32"})
        if "device_ms" in r:
            rows[-1].update(device_ms=r["device_ms"], library_device_ms=r["library_device_ms"])
        if "device_ms_by_pass" in r:
            rows[-1]["device_ms_by_pass"] = r["device_ms_by_pass"]
    primal = timed["lstm_fwd_carry"]
    rows[-3]["mode"] = "with_cs carry (the differentiable path's); launches count both modes"
    rows[-3]["primal_carry"] = {k: primal[k] for k in ("ms", "device_ms", "carry_free_ms",
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "library_device_ms")}
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    for k in ("stack_fwd", "stack_bwd", "stack_adj"):
        r = next(x for x in stack_timing if x["kernel"] == k and x["W"] == 48
                 and x["B"] == 32 and x["dtype"] == "float32")
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": trained[k],
            "launches_by_path": {p: c[k] for p, c in by_route.items()},
            "max_abs_err": stack["abs"][k]["float32"],
            "max_abs_err_bf16": stack["abs"][k]["bfloat16"],
            "max_scaled_err": stack["scaled"][k]["float32"],
            "max_scaled_err_bf16": stack["scaled"][k]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "chained_ms": r["chained_ms"], "device_ms": r["device_ms"],
            "chained_device_ms": r["chained_device_ms"],
            "library_device_ms": r["library_device_ms"], "shape": "W=48 B=32 H=100 float32"})
    rows[-3]["mode"] = "with_res (the epoch's); launches count both modes"
    rows[-3]["layouts"] = {"cluster": "H <= 100: every preset, the main path's",
                           "wide": "100 < H within stack_fits"}
    rows[-3]["max_err_by_layout"] = {k: v for k, v in stack_layouts.items() if "stack_fwd" in k}
    rows[-2]["mode"] = "plain (the epoch's timed mode); launches count every mode"
    rows[-2]["layout"] = "cluster, after the gate-recompute pre-pass; its time is every kernel of one call"
    rows[-2]["layouts"] = {"cluster": "H <= 100: every preset, the main path's",
                           "wide": "100 < H within stack_fits"}
    rows[-2]["max_err_by_layout"] = {k: v for k, v in stack_layouts.items() if "stack_bwd" in k}
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    rows[-1]["layout"] = ("cluster: the gates and v-stream pre-pass, the sweep, the transposed "
                          "post-pass; its time is every kernel of one call")
    rows[-1]["layouts"] = {"cluster": "H <= 100: every preset, the main path's",
                           "wide": "100 < H within stack_fits"}
    rows[-1]["max_err_by_layout"] = {k: v for k, v in stack_layouts.items() if "stack_adj" in k}
    # the weight sums, one row a launch shape at W=48 B=32 (R=1536); their
    # launches as the C launcher counted them in the main path's runs
    sum_runs = (("train_fused", train), ("train_chained", train_chained),
                ("trainer", [trainer]),
                ("train_gan_cli", [{"weight_sum_launches": trainer["cli_weight_sum_launches"]}]),
                ("eval", [evaluation]), ("scenario_epoch", scenario["epochs"]),
                ("scenario_bank", [scenario["bank"]]),
                ("health_fused", [health["routes"]["auto"]]),
                ("health_chained", [health["routes"]["chained"]]),
                ("bf16_fused", [r for r in precision["epochs"] if r["route"] == "auto"]),
                ("bf16_chained", [r for r in precision["epochs"] if r["route"] == "chained"]),
                ("bf16_train_gan_cli",
                 [{"weight_sum_launches": precision["train_gan"]["weight_sum_launches"]}]),
                ("mesh_dp1", [mesh["a"]]),
                ("mesh_dp2_rank0", [{"weight_sum_launches": mesh["b"][0]["sums"]}]),
                ("mesh_dp2_rank1", [{"weight_sum_launches": mesh["b"][1]["sums"]}]),
                *((f"mesh_{kind}_rank{r}", [{"weight_sum_launches": mesh[part]["sums"][r]}])
                  for kind, part in (("pp", "f"), ("sp", "g")) for r in (0, 1)))
    by_path = {shape: {p: sum(run["weight_sum_launches"][shape] for run in runs)
                       for p, runs in sum_runs} for shape, _, _, _ in SUM_SHAPES}
    for shape, nsum, npair, m in SUM_SHAPES:
        at = {r["R"]: r for r in sums if r["shape"] == shape}
        r = at[SUM_ROWS[0]]
        rows.append({
            "name": f"weight_sum ({shape})", "route": "cuda",
            "source": "hfrep_tpu_torch/csrc/weight_sum.cuh", "replaces": SUM_REPLACES[shape],
            "launches": sum(by_path[shape].values()),
            "launches_by_path": by_path[shape],
            "max_abs_err": max(x["max_abs_err"] for x in at.values()),
            "max_scaled_err": max(x["max_scaled_err"] for x in at.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": "torch.sum" if m == 1 else "torch.bmm" if nsum > 1 else "torch.matmul",
            "shape": f"{nsum} sum(s) of {npair} pair(s), R=1536 M={m} N={4 * HIDDEN} float32",
            "by_rows": {str(x["R"]): {k: x[k] for k in ("ms", "library_ms", "bound_ms",
                                                         "plain_ms", "blocks_a_tile")}
                        for x in at.values()}})
    kernels = {"kernels": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": rows, "server": server, "train": train,
                       "train_chained": train_chained, "precision": precision,
                       "trainer": trainer, "sweep": sweep,
                       "eval": evaluation, "scenario": scenario, "pipeline": pipeline,
                       "health": health, "serve_drain": serve_drain, "obs_tier": obs_tier,
                       "forensics": forensics, "chaos": chaos, "mesh": mesh,
                       "analysis": analysis,
                       "timing": timing,
                       "grad_timing": grad_timing, "stack_timing": stack_timing,
                       "carry_parity": carry, "carry_path": carry_path,
                       "carry_timing": carry_timing,
                       "parity_max_abs_err": worst, "fwd_layouts": layouts,
                       "bwd_layouts": bwd_layouts, "adj_layouts": adj_layouts, "sums": sums,
                       "grad_parity": grad,
                       "stack_parity": stack, "stack_layouts": stack_layouts,
                       "profile": profiled}, fh, indent=1)
    say(card)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
