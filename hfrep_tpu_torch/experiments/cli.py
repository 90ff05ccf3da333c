"""``python -m hfrep_tpu_torch``: the port's CLI (``hfrep_tpu/experiments/cli.py``).

    clean       raw vendor files → cleaned_data/ (needs pandas)
    train-gan   train a GAN preset on the cleaned panel, checkpoint, sample;
                --eval scores 500 samples with the 12 metrics
    eval-gan    12-metric eval of a saved sample cube against real windows
    sweep       latent-dim sweep (real only, or GAN-augmented via
                --gan-checkpoint), tables, summary and --stats
    pipeline    the async actor fabric: generator actors streaming sample
                blocks (or fixture panels) into AE sweep consumers over a
                bounded spool queue, supervised (restart on loss, a
                coordinated drain on SIGTERM)
    serve       the replication-server drill, optionally sampling a
                trained generator from a checkpoint (--gan-checkpoint)
    scenario    the scenario factory: conditional stress banks (bank),
                walk-forward sweeps (walkforward), synthetic universes
                (universe)
    sample-h5   sample a reference Keras .h5 generator into an
                inverse-scaled cube (needs h5py)

Every verb runs on the card unless ``--device cpu`` is given.
``train-gan``, ``sweep``, ``pipeline``, ``serve`` and ``scenario`` run in
the drive envelope (:func:`~hfrep_tpu_torch.resilience.drive.run_drive`):
a SIGTERM drains at the next safe boundary into exit 75, re-run with
``--resume`` to continue (``sweep --resume`` keeps chunk snapshots under
``<out>/_resume``); a storage error that outlasts the retry policy exits
74; ``--obs-dir`` (or ``HFREP_OBS_DIR``) writes the telemetry stream.
The Keras and plotting extras (``sample-h5``, ``train-gan --export-h5``,
``sweep --h5-generator`` and ``--plots``, ``eval-gan --eyeball``) import
h5py, TensorFlow and matplotlib inside themselves: they run where those
are installed, never on the card's path.  ``train-gan --dtype bfloat16``
and ``sweep --dtype bfloat16`` run the precision policy (bf16 compute over
float32 master weights and slots, float32 accumulation).

``train-gan --mesh`` trains data-parallel over every rank of the process
group (one process a rank; with no group, the one-device mesh);
``--coordinator host:port --num-processes N --process-id I`` joins the
group first (``--coordinator`` implies ``--mesh``): every process runs
the same command with its own id, gloo when ranks share a card or run on
the CPU, NCCL when each has its own.  Only rank 0 prints, checkpoints
and writes samples; each rank's telemetry goes to ``<obs-dir>/proc<I>``.
``--sp-mesh`` shards the window over every rank instead, ``--dp-sp DPxSP``
the batch over dp and the window over sp at once
(:mod:`hfrep_tpu_torch.parallel.sequence`); ``--tp-mesh N`` the hidden
units over N ranks, ``--dp-tp DPxTP`` the batch and the hidden units
(:mod:`hfrep_tpu_torch.parallel.tensor`), ``--dp-sp-tp DPxSPxTP`` all
three (:mod:`hfrep_tpu_torch.parallel.dp_sp_tp`); the window and
hidden-unit meshes run the flagship ``mtss_wgan_gp`` only.  With
``--coordinator`` the named mesh spans the group.  The mesh flags are
mutually exclusive.  ``--sp-microbatches`` and ``--sp-remat`` are JAX's
retired knobs: accepted, validated and threaded to ``TrainConfig``, then
ignored.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from hfrep_tpu_torch.config import DataConfig


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hfrep_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("clean", help="re-derive cleaned_data/ from raw vendor files")
    c.add_argument("--raw-dir", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--validate-against", default=None,
                   help="reference cleaned_data/ to diff against")

    t = sub.add_parser("train-gan", help="train a GAN preset")
    t.add_argument("--preset", default="mtss_wgan_gp")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--resume", action="store_true",
                   help="restore the latest good checkpoint in --checkpoint-dir "
                        "and complete the original schedule")
    t.add_argument("--samples-out", default=None, help="write generated cube (.npy)")
    t.add_argument("--n-samples", type=int, default=10)
    t.add_argument("--nan-guard", action="store_true",
                   help="roll back a block whose metrics go non-finite, "
                        "reseed and retry")
    t.add_argument("--max-recoveries", type=int, default=3,
                   help="consecutive rollbacks before giving up (with --nan-guard)")
    t.add_argument("--quiet", action="store_true")
    t.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="precision policy for the hot loop: bfloat16 = "
                        "bf16 compute over fp32 master weights (README "
                        "'Mixed precision'); default is the preset's "
                        "(float32, reproduction-exact)")
    t.add_argument("--eval", action="store_true", help="run the 12-metric suite after training")
    t.add_argument("--export-h5", default=None,
                   help="also write the trained generator as a reference-compatible "
                        "Keras .h5 (loads in the notebook's cell 42; needs tensorflow)")
    t.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the first two blocks here "
                        "(linked into run.json under --obs-dir)")
    t.add_argument("--obs-dir", default=None,
                   help="telemetry run dir: the train span, block ledger windows, "
                        "checkpoint spans, metric gauges")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.add_argument("--mesh", action="store_true",
                   help="data-parallel over every rank of the process group (the batch "
                        "split over dp, the gradients reduced to the global mean)")
    t.add_argument("--sp-mesh", action="store_true",
                   help="sequence-parallel: the window cut into one chunk a rank of the "
                        "process group, carries handed on between ranks "
                        "(parallel/sequence.py; flagship mtss_wgan_gp only)")
    t.add_argument("--dp-sp", default=None, metavar="DPxSP",
                   help="composed 2-D mesh, e.g. 1x2: batch sharded over dp AND window "
                        "over sp in one step (parallel/dp_sp.py)")
    t.add_argument("--tp-mesh", type=int, default=None, metavar="N",
                   help="tensor-parallel: every LSTM layer's hidden units (its gate "
                        "columns) over N ranks, h gathered each step (parallel/tensor.py; "
                        "hidden width must divide; flagship mtss_wgan_gp only)")
    t.add_argument("--dp-tp", default=None, metavar="DPxTP",
                   help="composed 2-D mesh, e.g. 1x2: batch sharded over dp AND hidden "
                        "units over tp in one step (parallel/tensor.py)")
    t.add_argument("--dp-sp-tp", default=None, metavar="DPxSPxTP",
                   help="full 3-D mesh, e.g. 1x2x2: batch over dp, window over sp, hidden "
                        "units over tp in one step (parallel/dp_sp_tp.py)")
    t.add_argument("--sp-remat", action="store_true",
                   help="RETIRED knob, accepted for compatibility: validated (--sp-mesh or "
                        "--dp-sp only), threaded to TrainConfig, ignored by the steps")
    t.add_argument("--sp-microbatches", type=int, default=None, metavar="M",
                   help="RETIRED knob, accepted for compatibility: validated (M >= 1, a "
                        "window-sharded mesh), threaded to TrainConfig, ignored by the steps")
    t.add_argument("--coordinator", default=None,
                   help="multi-process: coordinator address host:port; every process runs "
                        "this same command with its own --process-id; implies --mesh "
                        "unless another mesh flag is given")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)

    e = sub.add_parser("eval-gan", help="score a saved sample cube")
    e.add_argument("--samples", required=True, help=".npy cube, inverse-scaled returns")
    e.add_argument("--preset", default="mtss_wgan_gp")
    e.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    e.add_argument("--out", default=None, help="write metrics JSON here")
    e.add_argument("--eyeball", default=None,
                   help="write the ECDF 'eyeball' grid plot here (.png; needs matplotlib)")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    s = sub.add_parser("sweep", help="latent-dim sweep (cells 5-33 / 51-69)")
    s.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    s.add_argument("--latents", default="1:21", help="'lo:hi' inclusive, or comma list")
    s.add_argument("--out", required=True)
    src = s.add_mutually_exclusive_group()
    src.add_argument("--gan-checkpoint", action="append", default=None,
                     help="generator checkpoint: run the GAN-augmented sweep.  "
                          "Repeatable: K checkpoints train the real and the K "
                          "augmented sets as one (K+1)-dataset lane grid with the "
                          "padded semantics (weighted validation mean, padded "
                          "batch stream)")
    src.add_argument("--h5-generator", action="append", default=None,
                     help="reference Keras .h5 generator artifact: run the "
                          "GAN-augmented sweep from it (notebook cell 42; needs h5py).  "
                          "Repeatable, batched as --gan-checkpoint")
    s.add_argument("--preset", default="mtss_wgan_gp_prod",
                   help="preset the checkpoints were trained with")
    s.add_argument("--n-gen-windows", type=int, default=10)
    s.add_argument("--epochs", type=int, default=None, help="AE epochs override")
    s.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="AE precision policy (AEConfig.dtype): bfloat16 "
                        "runs the sweep's matmuls at tensor-core rate with "
                        "fp32 master weights + fp32 loss accumulation")
    s.add_argument("--chunk-epochs", type=int, default=None,
                   help="epochs a chunk of the early-exit drive (0 = one "
                        "chunk; the results are the same either way)")
    s.add_argument("--resume", action="store_true",
                   help="preemption-safe sweep: snapshot the lane state at every "
                        "chunk boundary under <out>/_resume, drain on SIGTERM (exit "
                        "75), and resume from the last completed chunk of a killed "
                        "run with results bit-identical to an uninterrupted one")
    s.add_argument("--plots", action="store_true",
                   help="cumulative-return, AE loss and Omega-curve charts of the best "
                        "latent (.png; needs matplotlib)")
    s.add_argument("--stats", action="store_true",
                   help="the stats battery of the best latent (cell 25): "
                        "Omega/Sharpe/cVaR/CEQ/skew/kurt, FF3F/FF5F alphas, "
                        "HK+GRS spanning of each HF index vs its replication")
    s.add_argument("--ff3", default="/root/reference/data/F-F_Research_Data_Factors_daily.CSV")
    s.add_argument("--ff5",
                   default="/root/reference/data/F-F_Research_Data_5_Factors_2x3_daily.CSV")
    s.add_argument("--obs-dir", default=None,
                   help="telemetry run dir: chunk stats, snapshot and drain events")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pl = sub.add_parser(
        "pipeline",
        help="async actor fabric: GAN synthesis streaming into AE sweep consumers "
             "over a bounded queue (survives losing any member, drains pod-wide on "
             "SIGTERM into exit 75)")
    pl.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    pl.add_argument("--preset", default="mtss_wgan_gp_prod",
                    help="preset the --gan-checkpoint was trained with")
    plsrc = pl.add_mutually_exclusive_group(required=True)
    plsrc.add_argument("--gan-checkpoint", action="append", default=None,
                       help="generator checkpoint; repeatable — one generator actor per "
                            "checkpoint, each streaming --blocks sample blocks; "
                            "consumers run the GAN-augmented sweep per block")
    plsrc.add_argument("--fixture-sources", type=int, default=None, metavar="K",
                       help="K deterministic synthetic generator actors (no cleaned "
                            "data or checkpoint needed)")
    plsrc.add_argument("--scenario-sources", type=int, default=None, metavar="K",
                       help="K conditional scenario-bank generator actors: source k "
                            "streams regime k mod --scenario-regimes")
    pl.add_argument("--scenario-regimes", type=int, default=3,
                    help="regime count for --scenario-sources")
    pl.add_argument("--blocks", type=int, default=4,
                    help="sample blocks per generator actor, streamed item-wise with "
                         "a sub-block snapshot after every item")
    pl.add_argument("--n-gen-windows", type=int, default=10,
                    help="windows per sample block (gan sources)")
    pl.add_argument("--latents", default="1:21", help="'lo:hi' inclusive, or comma list")
    pl.add_argument("--consumers", type=int, default=1,
                    help="AE sweep consumer actors pulling from the queue")
    pl.add_argument("--queue-capacity", type=int, default=4,
                    help="spool bound: generators block (backpressure) while this "
                         "many items are unclaimed")
    pl.add_argument("--epochs", type=int, default=None, help="AE epochs override")
    pl.add_argument("--chunk-epochs", type=int, default=None,
                    help="AEConfig.chunk_epochs override")
    pl.add_argument("--fixture-rows", type=int, default=120,
                    help="panel rows per fixture item")
    pl.add_argument("--fixture-feats", type=int, default=16,
                    help="panel features per fixture item (the AE input width)")
    pl.add_argument("--gen-delay", type=float, default=0.0,
                    help="seconds a fixture item takes to produce, the latency of "
                         "real GAN sampling (wall clock only; the bytes are the same)")
    pl.add_argument("--stream-seed", type=int, default=0,
                    help="seed of the item streams: every item is a pure function "
                         "of (seed, source, seq)")
    pl.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds the coordinated drain barrier waits for every "
                         "member before escalating stragglers with SIGKILL")
    pl.add_argument("--out", required=True)
    pl.add_argument("--resume", action="store_true",
                    help="continue a killed/drained pipeline: orphaned claims are "
                         "requeued, generators fast-forward via their snapshots, "
                         "consumers skip published results")
    pl.add_argument("--obs-dir", default=None,
                    help="telemetry run dir: actor lifecycle events, queue depth "
                         "gauge, restart counters (each actor streams into "
                         "<dir>/actors/<name>, its kernel launches among them)")
    pl.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    sv = sub.add_parser("serve", help="replication-server drill; SIGTERM drains (stop "
                                      "admitting, flush in-flight) into exit 75")
    sv.add_argument("--requests", type=int, default=2000, help="queries to offer")
    sv.add_argument("--wave", type=int, default=256,
                    help="queries offered per wave; the drain flag is polled between waves")
    sv.add_argument("--timeout-ms", type=float, default=None,
                    help="per-request deadline (default: the envelope's)")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--batch-window-ms", type=float, default=5.0)
    sv.add_argument("--max-queue", type=int, default=256)
    sv.add_argument("--workers", type=int, default=2)
    sv.add_argument("--fixture-feats", type=int, default=16,
                    help="width of the fixture replication head (trained at start-up; "
                         "no cleaned data needed)")
    sv.add_argument("--sample-every", type=int, default=0,
                    help="every Nth query samples the generator (needs "
                         "--gan-checkpoint)")
    sv.add_argument("--gan-checkpoint", default=None,
                    help="also serve `sample` queries from this trained "
                         "generator checkpoint")
    sv.add_argument("--preset", default="mtss_wgan_gp_prod",
                    help="preset the --gan-checkpoint was trained with")
    sv.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    sv.add_argument("--obs-dir", default=None, help="telemetry run dir")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    sc = sub.add_parser(
        "scenario",
        help="scenario factory: conditional stress banks, walk-forward regime "
             "sweeps, synthetic-universe drives (a re-run reuses the state "
             "that verifies)")
    sc.add_argument("mode", choices=["bank", "walkforward", "universe"])
    sc.add_argument("--out", required=True)
    sc.add_argument("--resume", action="store_true",
                    help="continue an interrupted run: bank blocks and window scores "
                         "that verify are kept, as is a trained walk-forward grid")
    sc.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    sc.add_argument("--fixture", action="store_true",
                    help="run on the deterministic fabricated panel instead of "
                         "cleaned data (no data files needed)")
    # bank knobs
    sc.add_argument("--family", default="gan", help="conditional GAN family (bank mode)")
    sc.add_argument("--n-regimes", type=int, default=3,
                    help="vol-state regimes the labeler bins the panel into "
                         "(= condition vector width)")
    sc.add_argument("--regime-window", type=int, default=12,
                    help="trailing months the vol-state labeler looks at")
    sc.add_argument("--regimes", default=None,
                    help="comma list of regimes to bank (default: all)")
    sc.add_argument("--blocks", type=int, default=4, help="sample blocks per regime")
    sc.add_argument("--block-size", type=int, default=16, help="windows per block")
    sc.add_argument("--stream-seed", type=int, default=0)
    sc.add_argument("--train-epochs", type=int, default=30,
                    help="conditional GAN training epochs before banking "
                         "(0 = the initialised generator)")
    sc.add_argument("--gan-window", type=int, default=24,
                    help="window length of the conditional training windows / bank samples")
    # walk-forward / universe knobs
    sc.add_argument("--latents", default="1:8", help="'lo:hi' inclusive, or comma list")
    sc.add_argument("--start", type=int, default=120,
                    help="training months of the first walk-forward window")
    sc.add_argument("--step", type=int, default=1,
                    help="months the training window grows per roll")
    sc.add_argument("--windows", type=int, default=24,
                    help="walk-forward windows (lanes = windows x latents)")
    sc.add_argument("--horizon", type=int, default=36,
                    help="OOS months scored per window")
    sc.add_argument("--epochs", type=int, default=None, help="AE epochs override")
    sc.add_argument("--chunk-epochs", type=int, default=None,
                    help="AEConfig.chunk_epochs override")
    sc.add_argument("--ols-window", type=int, default=None,
                    help="AEConfig.ols_window override")
    # universe knobs
    sc.add_argument("--funds", type=int, default=64, help="synthetic hedge funds (universe mode)")
    sc.add_argument("--months", type=int, default=360, help="synthetic months (universe mode)")
    sc.add_argument("--n-factors", type=int, default=22,
                    help="synthetic factor columns (universe mode)")
    sc.add_argument("--seed", type=int, default=0)
    sc.add_argument("--obs-dir", default=None, help="telemetry run dir")
    sc.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    h = sub.add_parser("sample-h5", help="sample a reference Keras .h5 generator into an "
                                         "inverse-scaled cube (.npy; needs h5py)")
    h.add_argument("--h5", required=True, help="trained_generator/*.h5 artifact")
    h.add_argument("--out", required=True, help="output .npy path")
    h.add_argument("--n-windows", type=int, default=10)
    h.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    h.add_argument("--seed", type=int, default=0)
    h.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cmd_clean(args) -> int:
    from hfrep_tpu_torch.core import cleaning     # pandas: only this verb
    res = cleaning.run_cleaning(args.raw_dir, out_dir=args.out_dir)
    print(f"wrote cleaned panel ({res.hfd.shape[0]} months) to {args.out_dir}")
    if args.validate_against:
        rep = cleaning.validate_against(res, args.validate_against)
        print(json.dumps(rep, indent=2))
    return 0


def _dims(flag: str, value: str, form: str, example: str) -> tuple:
    """``value`` of ``flag`` as ``form`` (``DPxSP``, ...) → ints, or JAX's
    error for the flag."""
    try:
        dims = tuple(int(v) for v in value.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) != form.count("x") + 1:
        raise SystemExit(f"{flag} wants {form} (e.g. {example}), got {value!r}")
    return dims


def _build_device_mesh(mesh: bool, sp_mesh: bool, dp_sp: Optional[str],
                       tp_mesh: Optional[int], dp_tp: Optional[str],
                       dp_sp_tp: Optional[str], sp_microbatches: Optional[int],
                       sp_remat: bool, device: str):
    """The mesh the flags name (``None``: no mesh), after the flags'
    checks: they exclude each other, the retired knobs need a
    window-sharded mesh (``--sp-remat`` one without tp), and each value
    parses, with JAX's messages."""
    if sum(map(bool, (mesh, sp_mesh, dp_sp, tp_mesh is not None, dp_tp, dp_sp_tp))) > 1:
        raise SystemExit("--mesh, --sp-mesh, --dp-sp, --tp-mesh, --dp-tp and --dp-sp-tp "
                         "are mutually exclusive")
    if sp_remat and not (sp_mesh or dp_sp):
        raise SystemExit("--sp-remat requires --sp-mesh or --dp-sp (the tp-composed chunk "
                         "scan is not time-blocked; dp×sp×tp refuses)")
    if sp_microbatches is not None:
        if sp_microbatches < 1:
            raise SystemExit(f"--sp-microbatches wants M >= 1, got {sp_microbatches}")
        if not (sp_mesh or dp_sp or dp_sp_tp):
            raise SystemExit("--sp-microbatches requires a window-sharded mesh (--sp-mesh, "
                             "--dp-sp or --dp-sp-tp)")
    if tp_mesh is not None and tp_mesh < 1:
        raise SystemExit(f"--tp-mesh wants N >= 1 devices, got {tp_mesh}")
    dev = None if device == "cuda" else device
    from hfrep_tpu_torch.config import MeshConfig
    from hfrep_tpu_torch.parallel import make_mesh, make_mesh_2d, make_mesh_3d
    if mesh:
        return make_mesh(device=dev)
    if sp_mesh:
        return make_mesh(MeshConfig(axis_name="sp"), device=dev)
    if dp_sp:
        return make_mesh_2d(*_dims("--dp-sp", dp_sp, "DPxSP", "2x4"), device=dev)
    if tp_mesh is not None:
        return make_mesh(MeshConfig(dp=tp_mesh, axis_name="tp"), device=dev)
    if dp_tp:
        return make_mesh_2d(*_dims("--dp-tp", dp_tp, "DPxTP", "2x4"), device=dev,
                            axis_names=("dp", "tp"))
    if dp_sp_tp:
        return make_mesh_3d(*_dims("--dp-sp-tp", dp_sp_tp, "DPxSPxTP", "2x2x2"), device=dev)
    return None


def _make_trainer(preset: str, cleaned_dir: str, checkpoint_dir: Optional[str] = None,
                  quiet: bool = False, nan_guard: bool = False,
                  max_recoveries: int = 3, device: str = "cuda",
                  dtype: Optional[str] = None, mesh: bool = False, sp_mesh: bool = False,
                  dp_sp: Optional[str] = None, tp_mesh: Optional[int] = None,
                  dp_tp: Optional[str] = None, dp_sp_tp: Optional[str] = None,
                  sp_microbatches: Optional[int] = None, sp_remat: bool = False):
    """The mesh the flags name (``mesh``: dp over every rank of the
    process group; ``sp_mesh``, ``dp_sp``: the window sharded; ``tp_mesh``,
    ``dp_tp``: the hidden units; ``dp_sp_tp``: both), then the
    preset (its model's precision policy set to ``dtype`` if given, the
    retired sp knobs threaded), then panel, then dataset, then logger,
    then trainer."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.obs.metriclog import MetricLogger
    from hfrep_tpu_torch.train.trainer import GanTrainer

    # before the panel load: a bad flag, a too-small process group or a
    # batch dp does not divide must not pay for it first
    device_mesh = _build_device_mesh(mesh, sp_mesh, dp_sp, tp_mesh, dp_tp, dp_sp_tp,
                                     sp_microbatches, sp_remat, device)
    if device_mesh is not None:
        device = device_mesh.device
    cfg = get_preset(preset)
    if dtype:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    if checkpoint_dir:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=checkpoint_dir))
    if sp_microbatches is not None or sp_remat:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, sp_microbatches=sp_microbatches, sp_remat=sp_remat))
    panel = load_panel(cleaned_dir, device=device)
    ds = build_gan_dataset(cfg.data, cfg.data.seed, panel)
    style = {"gan": "gan", "mtss_gan": "gan", "wgan": "wgan", "mtss_wgan": "wgan"}.get(
        cfg.model.family, "wgan_gp")
    logger = MetricLogger(echo=not quiet, echo_style=style)
    trainer = GanTrainer(cfg, ds, logger=logger, nan_guard=nan_guard,
                         max_recoveries=max_recoveries, device=device, mesh=device_mesh)
    return trainer, cfg


def _obs_dir(args) -> Optional[str]:
    return args.obs_dir or os.environ.get("HFREP_OBS_DIR")


def _drive(name: str, impl, args, **kw) -> int:
    """Run a verb's body in the drive envelope of the registered spec
    ``name``: exit 75 on a drain, 74 on a persistent storage error."""
    from hfrep_tpu_torch.resilience.drive import DRIVE_REGISTRY, run_drive
    return run_drive(DRIVE_REGISTRY[name], lambda: impl(args), obs_dir=_obs_dir(args),
                     session_meta={"command": args.cmd}, **kw)


def cmd_train_gan(args) -> int:
    if (args.num_processes is not None or args.process_id is not None) \
            and not args.coordinator:
        raise SystemExit("--num-processes and --process-id go with --coordinator")
    if not args.coordinator:
        return _drive("gan_ckpt", _cmd_train_gan_impl, args)
    # multi-process: join the group before any device or telemetry use
    from hfrep_tpu_torch.parallel import initialize_distributed, shutdown_distributed
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           device=None if args.device == "cuda" else args.device)
    if not (args.sp_mesh or args.dp_sp or args.tp_mesh is not None or args.dp_tp
            or args.dp_sp_tp):
        args.mesh = True
    obs_dir = _obs_dir(args)
    if obs_dir and args.num_processes > 1:
        # one run dir a process: two processes must not append to one stream
        args.obs_dir = os.path.join(obs_dir, f"proc{args.process_id}")
    try:
        return _drive("gan_ckpt", _cmd_train_gan_impl, args)
    finally:
        shutdown_distributed()


def _cmd_train_gan_impl(args) -> int:
    leader = not args.coordinator or args.process_id == 0
    trainer, cfg = _make_trainer(
        args.preset, args.cleaned_dir, args.checkpoint_dir, args.quiet or not leader,
        nan_guard=args.nan_guard, max_recoveries=args.max_recoveries,
        device=args.device, dtype=args.dtype, mesh=args.mesh, sp_mesh=args.sp_mesh,
        dp_sp=args.dp_sp, tp_mesh=args.tp_mesh, dp_tp=args.dp_tp, dp_sp_tp=args.dp_sp_tp,
        sp_microbatches=args.sp_microbatches, sp_remat=args.sp_remat)
    say = print if leader else (lambda *a, **k: None)
    target = args.epochs if args.epochs is not None else cfg.train.epochs
    if args.resume:
        from hfrep_tpu_torch.utils.checkpoint import latest
        path = latest(args.checkpoint_dir) if args.checkpoint_dir else None
        if path is None:
            say("no checkpoint to resume from; training from scratch")
        else:
            # a corrupt newest checkpoint falls back to the previous good
            # one (report the path actually restored); when every
            # candidate is corrupt, a clean fresh start
            path = trainer.restore_checkpoint()
            if path:
                say(f"resumed from {path} (epoch {trainer.epoch})")
                # recovery completes the original schedule, not epochs on top
                target = max(0, target - trainer.epoch)
            else:
                say("no restorable checkpoint (all candidates corrupt); "
                    "training from scratch")
    if args.profile_dir and target:
        from hfrep_tpu_torch.obs import trace_capture

        # a bounded window (the first block, which builds the kernels, and
        # one steady block): a trace of a whole run would not open
        traced = min(target, 2 * cfg.train.steps_per_call)
        with trace_capture(args.profile_dir, epochs=traced):
            trainer.train(epochs=traced)
        say(f"profile: {args.profile_dir} (first {traced} epochs)")
        trainer.train(epochs=target - traced)
    else:
        if args.profile_dir:
            say("no epochs to run; nothing to profile")
        trainer.train(epochs=target)
    rate = (f" ({trainer.steps_per_sec:.2f} steps/s)"
            if trainer.timer.samples else " (schedule already complete)")
    say(f"trained {cfg.model.family} for {trainer.epoch} epochs{rate}")
    if args.checkpoint_dir:
        say(f"checkpoint: {trainer.save_checkpoint()}")   # rank 0 writes
    if args.samples_out:
        import torch

        g = torch.Generator(device=trainer.device)
        g.manual_seed(9)
        cube = trainer.generate(args.n_samples, generator=g).cpu().numpy()
        if leader:
            np.save(args.samples_out, cube)
        say(f"samples: {args.samples_out} {tuple(cube.shape)}")
    if args.eval:
        _eval_trainer_samples(trainer, say)
    if args.export_h5 and leader:
        from hfrep_tpu_torch.utils.keras_export import export_keras_generator
        path = export_keras_generator(cfg.model, trainer.state.generator, args.export_h5)
        say(f"keras artifact: {path}")
    # the hand kernels' launches, as launches/<kernel> counters in the
    # run's stream (nothing without a telemetry dir)
    from hfrep_tpu_torch.obs import emit_launch_counts
    emit_launch_counts()
    return 0


def _eval_trainer_samples(trainer, say=print) -> dict:
    """The 12 metrics of 500 samples (scaler space) from the trained
    generator against the dataset's windows."""
    import torch

    from hfrep_tpu_torch.metrics.gan_eval import GanEval

    windows = trainer.windows
    n = min(500, windows.shape[0])
    g = torch.Generator(device=trainer.device)
    g.manual_seed(11)
    fake = trainer.generate(n, generator=g, unscale=False)
    res = GanEval(windows[:n], fake, windows).run_all()
    say(json.dumps(res, indent=2))
    return res


def cmd_eval_gan(args) -> int:
    import torch

    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core import scaler as mm
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.metrics.gan_eval import GanEval

    cfg = get_preset(args.preset)
    panel = load_panel(args.cleaned_dir, device=args.device)
    ds = build_gan_dataset(cfg.data, cfg.data.seed, panel)
    cube = np.load(args.samples)
    if cube.ndim != 3 or tuple(cube.shape[1:]) != tuple(ds.windows.shape[1:]):
        print(f"sample cube has shape {cube.shape} but preset "
              f"{args.preset!r} builds (N, {ds.windows.shape[1]}, "
              f"{ds.windows.shape[2]}) windows; pass the matching --preset "
              "((168, 36) production cubes need mtss_wgan_gp_prod)",
              file=sys.stderr)
        return 2
    # samples are stored inverse-scaled; move them back into scaler space
    flat = torch.from_numpy(np.asarray(cube, np.float32).reshape(-1, cube.shape[2]))
    fake = mm.transform(ds.scaler, flat.to(ds.windows.device)).reshape(cube.shape)
    n = min(cube.shape[0], ds.windows.shape[0])
    suite = GanEval(ds.windows[:n], fake[:n], ds.windows, model_name=[args.preset])
    res = suite.run_all()
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    if args.eyeball:
        suite.eyeball(args.eyeball)
        print(f"eyeball plot: {args.eyeball}")
    return 0


def _parse_latents(spec: str):
    if ":" in spec:
        lo, hi = spec.split(":")
        return list(range(int(lo), int(hi) + 1))
    return [int(x) for x in spec.split(",")]


def _sample_augmentations(args, panel):
    """Sample every ``--gan-checkpoint`` or ``--h5-generator`` source; a
    source's output subdir and its sampling draws follow its artifact's
    stem, not the flag's position."""
    from hfrep_tpu_torch.experiments.augment import (sample_generator,
                                                     sample_keras_generator, source_labels,
                                                     source_sample_key)

    augs, names = [], []
    if args.gan_checkpoint:
        trainer, _ = _make_trainer(args.preset, args.cleaned_dir, quiet=True,
                                   device=args.device)
        for ckpt, label in zip(args.gan_checkpoint, source_labels(args.gan_checkpoint)):
            trainer.restore_checkpoint(ckpt)
            augs.append(sample_generator(trainer, source_sample_key(label,
                                                                    device=trainer.device),
                                         n_windows=args.n_gen_windows))
            names.append(f"gen_{label}")
    elif args.h5_generator:
        for h5, label in zip(args.h5_generator, source_labels(args.h5_generator)):
            augs.append(sample_keras_generator(
                h5, source_sample_key(label, device=args.device), panel,
                n_windows=args.n_gen_windows, device=args.device))
            names.append(f"gen_{label}")
    return augs, names


def _write_chunk_stats(stats, out_dir: str) -> dict:
    doc = dict(stats._asdict(), epochs_saved=stats.epochs_saved)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chunk_stats.json"), "w") as f:
        json.dump(doc, f, indent=2)
    return doc


def cmd_sweep(args) -> int:
    # only the --resume path has a snapshot to come back to
    hint = ("re-run the same command to resume from the last chunk" if args.resume else
            "no snapshot was kept (run with --resume to make the sweep resumable)")
    return _drive("ae_sweep", _cmd_sweep_impl, args, drain_hint=hint)


def _cmd_sweep_impl(args) -> int:
    rc = _sweep_body(args)
    # the hand kernels' launches (a checkpoint's samples), as
    # launches/<kernel> counters in the run's stream (nothing without one)
    from hfrep_tpu_torch.obs import emit_launch_counts
    emit_launch_counts()
    return rc


def _sweep_body(args) -> int:
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.experiments.augment import (augment_training_set,
                                                     augment_training_sets)
    from hfrep_tpu_torch.experiments.sweep import run_sweep, run_sweep_multi

    panel = load_panel(args.cleaned_dir, device=args.device)
    x_train, x_test, y_train, y_test = panel.train_test_split()
    rf_test = panel.rf[x_train.shape[0]:]
    cfg = AEConfig()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.chunk_epochs is not None:
        cfg = dataclasses.replace(cfg, chunk_epochs=args.chunk_epochs)
    latents = _parse_latents(args.latents)
    resume_dir = os.path.join(args.out, "_resume") if args.resume else None

    augs, gen_names = _sample_augmentations(args, panel)
    if len(augs) > 1:
        # K generators: the real and the K augmented training sets as one
        # (K+1) x L lane grid, padded to the longest
        multi = run_sweep_multi(
            augment_training_sets(x_train, y_train, augs), x_test, y_test, rf_test,
            panel.factors, cfg, latents, strategy_names=panel.hf_names,
            dataset_names=["real"] + gen_names, device=args.device, resume_dir=resume_dir)
        multi.save(args.out)
        doc = {name: res.summary() for name, res in zip(multi.dataset_names, multi.results)}
        doc["chunk_stats"] = _write_chunk_stats(multi.chunk_stats, args.out)
        print(json.dumps(doc, indent=2, default=str))
        rc = 0
        for name, res in zip(multi.dataset_names, multi.results):
            rc |= _sweep_outputs(args, res, os.path.join(args.out, name), panel, y_test,
                                 rf_test)
        return rc

    if augs:
        x_train, y_train = augment_training_set(x_train, y_train, augs[0])
        print(f"augmented training set: {x_train.shape[0]} rows "
              f"({augs[0].factors.shape[0]} synthetic)")
    result = run_sweep(x_train, y_train, x_test, y_test, rf_test, panel.factors, cfg,
                       latents, strategy_names=panel.hf_names, device=args.device,
                       resume_dir=resume_dir)
    result.save(args.out)
    if result.chunk_stats is not None:
        _write_chunk_stats(result.chunk_stats, args.out)
    print(json.dumps(result.summary(), indent=2, default=str))
    return _sweep_outputs(args, result, args.out, panel, y_test, rf_test)


def _sweep_outputs(args, result, out_dir, panel, y_test, rf_test) -> int:
    from hfrep_tpu_torch.experiments import report

    os.makedirs(out_dir, exist_ok=True)
    if not (args.stats or args.plots):
        return 0
    i_best = int(np.argmax(result.oos_r2_mean))
    p = result.post[i_best]
    actual = y_test.cpu().numpy()[-p.shape[0]:]
    if args.plots:
        # ex-ante, ex-post and real a strategy (Autoencoder_encapsulate.py:226-243)
        for path in (
                report.multiplot(p, actual, panel.hf_names,
                                 os.path.join(out_dir, "cumulative_returns.png"),
                                 labels=("replication (ex-post)", "actual"),
                                 ante=result.ante[i_best]),
                report.ae_loss_curves(result.train_loss, result.val_loss,
                                      result.latent_dims,
                                      os.path.join(out_dir, "ae_loss_curves.png")),
                report.omega_curve_grid(p, actual, panel.hf_names,
                                        os.path.join(out_dir, "omega_curves.png"))):
            print(f"plot: {path}")
    if not args.stats:
        return 0
    rf_aligned = rf_test.cpu().numpy().reshape(-1)[-p.shape[0]:]
    # the spanning set is the factor/ETF universe, as the notebook's
    # data_analysis(..., span=factor_etf_data) (cells 25/28); OOS stats
    # window 2010-05 to 2022-04 (cell 25)
    span_set = panel.factors.cpu().numpy()[-p.shape[0]:]
    start, end = "2010-05-31", "2022-04-30"
    for flag, path in (("--ff3", args.ff3), ("--ff5", args.ff5)):
        if not os.path.exists(path):
            print(f"warning: {flag} file {path} not found — "
                  "FF alpha columns will be omitted", file=sys.stderr)
    # post (cell 25 second loop), ante (cells 31/65), actual HF (cell 28)
    for name, returns in (("replication", p), ("replication_ante", result.ante[i_best]),
                          ("benchmark", actual)):
        table = report.stats_table(returns, panel.hf_names, rf=rf_aligned,
                                   ff3_path=args.ff3, ff5_path=args.ff5, span=span_set,
                                   start=start, end=end)
        path = os.path.join(out_dir, f"stats_{name}.csv")
        table.to_csv(path)
        print(f"stats: {path}")
    return 0


def cmd_pipeline(args) -> int:
    return _drive("pipeline", _cmd_pipeline_impl, args)


def _cmd_pipeline_impl(args) -> int:
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.orchestrate import (PipelinePlan, PipelineStateError, SourceSpec,
                                             run_pipeline)

    cfg = AEConfig()
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.chunk_epochs is not None:
        cfg = dataclasses.replace(cfg, chunk_epochs=args.chunk_epochs)
    if args.gan_checkpoint:
        sources = [SourceSpec(name=f"g{i}", mode="gan",
                              params={"preset": args.preset, "checkpoint": ck,
                                      "n_gen_windows": args.n_gen_windows})
                   for i, ck in enumerate(args.gan_checkpoint)]
        consume_mode = "augment"
    else:
        cfg = dataclasses.replace(cfg, n_factors=args.fixture_feats,
                                  latent_dim=min(cfg.latent_dim, args.fixture_feats))
        consume_mode = "direct"
        if args.scenario_sources:
            sources = [SourceSpec(name=f"s{i}", mode="scenario",
                                  params={"rows": args.fixture_rows,
                                          "feats": args.fixture_feats,
                                          "regime": i % args.scenario_regimes,
                                          "n_regimes": args.scenario_regimes})
                       for i in range(args.scenario_sources)]
        else:
            params = {"rows": args.fixture_rows, "feats": args.fixture_feats}
            if args.gen_delay:
                params["gen_delay"] = args.gen_delay
            sources = [SourceSpec(name=f"f{i}", mode="fixture", params=dict(params))
                       for i in range(args.fixture_sources)]
    plan = PipelinePlan(
        out_dir=args.out, sources=sources, blocks=args.blocks, consumers=args.consumers,
        capacity=args.queue_capacity, ae_cfg=cfg, latent_dims=_parse_latents(args.latents),
        consume_mode=consume_mode, cleaned_dir=args.cleaned_dir,
        stream_seed=args.stream_seed, device=args.device,
        drain_timeout=args.drain_timeout, timeout=None)
    try:
        out = run_pipeline(plan, resume=args.resume)
    except PipelineStateError as e:
        print(f"pipeline: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"sources": sorted(out["summary"]["sources"]), "blocks": args.blocks,
                      "consumers": args.consumers, **out["stats"]}, indent=2))
    print(f"assembled: {os.path.join(args.out, 'pipeline.json')}")
    return 0


def cmd_serve(args) -> int:
    return _drive("serve_load", _cmd_serve_impl, args)


def _cmd_serve_impl(args) -> int:
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.obs import emit_launch_counts, get_obs
    from hfrep_tpu_torch.serve.aot import GenServeModel
    from hfrep_tpu_torch.serve.fixture import fixture_ae_model, fixture_server, warm_server
    from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
    from hfrep_tpu_torch.serve.server import ServeConfig

    if args.sample_every and not args.gan_checkpoint:
        raise SystemExit("--sample-every needs --gan-checkpoint")
    gen_model = None
    if args.gan_checkpoint:
        trainer, cfg = _make_trainer(args.preset, args.cleaned_dir, quiet=True,
                                     device=args.device)
        trainer.restore_checkpoint(args.gan_checkpoint)
        module = copy.deepcopy(trainer.state.generator).eval().requires_grad_(False)
        gen_model = GenServeModel(cfg=cfg.model, module=module)
    scfg = ServeConfig(max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
                       max_queue=args.max_queue, workers=args.workers,
                       # the drill's panels top out at 96 rows
                       row_buckets=(32, 64, 128))
    timeout_ms = (args.timeout_ms if args.timeout_ms is not None
                  else scfg.request_timeout_ms)
    obs = get_obs()
    obs.annotate(config={"serve": {"max_batch": scfg.max_batch, "deadline_ms": timeout_ms,
                                   "max_queue": scfg.max_queue, "workers": scfg.workers}})
    panels = make_panels(23, args.fixture_feats, (32, 64, 96), variants=8)
    with resilience.graceful_drain():
        # the fixture head, trained at start-up
        server = fixture_server(scfg, preset=None, gen_model=gen_model, device=args.device,
                                ae_model=fixture_ae_model(feats=args.fixture_feats,
                                                          device=args.device))
        try:
            n_programs = warm_server(server, panels)
            print(f"serving: {n_programs} AOT programs resident "
                  f"(export={'on' if server.cfg.via_export else 'off'}); "
                  f"offering {args.requests} queries (deadline {timeout_ms:.0f}ms)",
                  file=sys.stderr)

            def on_wave(done: int) -> None:
                if resilience.drain_requested():
                    doc = server.drain(reason="SIGTERM", timeout=30.0)
                    print(json.dumps({"drained": doc, "stats": server.stats()},
                                     indent=2, default=str))
                    raise resilience.Preempted(site="serve", reason="drain requested",
                                               epoch=done)

            report = drive_load(server, args.requests, panels, timeout_ms=timeout_ms,
                                sample_every=args.sample_every, wave=args.wave,
                                on_wave=on_wave)
            # a drain requested after the last wave (every future already
            # awaited) still stops, flushes and exits 75
            on_wave(args.requests)
            for name, value in (("serve/qps", report["qps"]),
                                ("serve/p50_ms", report["p50_ms"]),
                                ("serve/p95_ms", report["p95_ms"]),
                                ("serve/shed_rate", report["shed_rate"])):
                if value is not None:
                    obs.gauge(name).set(float(value))
            print(json.dumps({"report": report, "stats": server.stats()}, indent=2,
                             default=str))
            ledger = server.outcomes.as_dict()
            if ledger["terminal"] != ledger["submitted"]:
                print(f"serve: OUTCOME LEAK: {ledger}", file=sys.stderr)
                return 1
            return 0
        finally:
            server.stop()
            emit_launch_counts()


def _scenario_panel(args):
    """The panel of the bank and walk-forward modes: the cleaned panel, or
    under ``--fixture`` the fabricated one, built once in a private tmp
    dir and published with one rename (a killed first run leaves no
    half-written dir; a concurrent loser discards its copy)."""
    import shutil
    import tempfile

    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.utils.fixture_data import write_cleaned_fixture

    d = args.cleaned_dir
    if args.fixture:
        d = os.path.join(tempfile.gettempdir(), f"hfrep_torch_scenario_fixture_{os.getuid()}")
        if not os.path.isdir(d):
            tmp = f"{d}.tmp-{os.getpid()}"
            write_cleaned_fixture(tmp)
            try:
                os.replace(tmp, d)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
                if not os.path.isdir(d):
                    raise
    return load_panel(d, device="cpu")


def cmd_scenario(args) -> int:
    # one verb, two registered drives: the bank is the conditional-GAN
    # drive; walkforward and universe ride the walkforward spec
    return _drive("scenario_bank" if args.mode == "bank" else "walkforward",
                  _cmd_scenario_impl, args)


def _cmd_scenario_impl(args) -> int:
    from hfrep_tpu_torch.config import AEConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.scenario import regimes as reg
    from hfrep_tpu_torch.scenario.walkforward import WalkForwardSpec, run_walkforward

    if args.mode == "bank":
        from hfrep_tpu_torch.core import scaler as mm
        from hfrep_tpu_torch.scenario.conditional import (generate_bank, sliding_windows,
                                                          train_conditional)
        panel = _scenario_panel(args)
        x = panel.factors.numpy()
        labels = reg.label_regimes(x, window=args.regime_window, n_regimes=args.n_regimes)
        _, scaled = mm.fit_transform(panel.factors)
        windows = sliding_windows(scaled.numpy(), args.gan_window)
        conds = reg.window_conditions(labels, args.gan_window, args.n_regimes)
        mcfg = ModelConfig(family=args.family, features=x.shape[1], window=args.gan_window)
        tcfg = TrainConfig(n_critic=1, seed=args.seed,
                           steps_per_call=min(50, max(1, args.train_epochs)))
        bundle = train_conditional(mcfg, tcfg, windows, conds, args.train_epochs,
                                   seed=args.seed, device=args.device)
        regimes = [int(v) for v in args.regimes.split(",")] if args.regimes else None
        manifest = generate_bank(bundle, args.out, regimes=regimes, blocks=args.blocks,
                                 block_size=args.block_size, stream_seed=args.stream_seed)
        print(json.dumps({
            "aggregate_digest": manifest["aggregate_digest"],
            "blocks": len(manifest["block_digests"]),
            "generated": manifest["generated"],
            "regime_months": reg.regime_counts(labels, args.n_regimes).tolist()}, indent=2))
        print(f"bank: {os.path.join(args.out, 'bank.json')}")
        return 0

    cfg = AEConfig(seed=args.seed)
    for field, value in (("epochs", args.epochs), ("chunk_epochs", args.chunk_epochs),
                         ("ols_window", args.ols_window)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{field: value})
    latents = _parse_latents(args.latents)
    spec = WalkForwardSpec(start=args.start, n_windows=args.windows, horizon=args.horizon,
                           step=args.step)
    if args.mode == "walkforward":
        panel = _scenario_panel(args)
        res = run_walkforward(panel.factors.numpy(), panel.hf.numpy(), panel.rf.numpy(),
                              spec, cfg, latents, args.out, resume=args.resume,
                              device=args.device)
    else:                                             # universe
        from hfrep_tpu_torch.scenario.universe import UniverseSpec, drive_universe
        uspec = UniverseSpec(funds=args.funds, months=args.months,
                             n_factors=args.n_factors, seed=args.seed)
        res = drive_universe(uspec, spec, cfg, latents, args.out, resume=args.resume,
                             device=args.device)
    print(json.dumps({"stats": res["stats"], "summary": res["manifest"]["summary"]},
                     indent=2, default=str))
    print(f"surface: {os.path.join(args.out, 'walkforward.csv')}")
    return 0


def cmd_sample_h5(args) -> int:
    import torch

    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.experiments.augment import sample_keras_generator
    from hfrep_tpu_torch.train.trainer import seed_mix

    panel = load_panel(args.cleaned_dir, device=args.device)
    g = torch.Generator(device=panel.factors.device)
    g.manual_seed(seed_mix(args.seed))
    aug = sample_keras_generator(args.h5, g, panel, n_windows=args.n_windows,
                                 device=args.device)
    cube = aug.raw_windows.cpu().numpy()
    np.save(args.out, cube)
    print(f"samples: {args.out} {tuple(cube.shape)}")
    return 0


COMMANDS = {"clean": cmd_clean, "train-gan": cmd_train_gan, "eval-gan": cmd_eval_gan,
            "sweep": cmd_sweep, "pipeline": cmd_pipeline, "serve": cmd_serve,
            "scenario": cmd_scenario, "sample-h5": cmd_sample_h5}
#: the verbs that open their own telemetry session in the drive envelope
DRIVES = ("train-gan", "sweep", "pipeline", "serve", "scenario")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from hfrep_tpu_torch import obs

    args = _build_parser().parse_args(argv)
    if args.cmd not in DRIVES:
        obs.maybe_enable_from_env()      # HFREP_OBS_DIR opt-in for the others
    try:
        return COMMANDS[args.cmd](args)
    finally:
        obs.disable()                    # no-op unless something enabled obs
