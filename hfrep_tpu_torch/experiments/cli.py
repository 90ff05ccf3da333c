"""``python -m hfrep_tpu_torch``: the port's CLI (``hfrep_tpu/experiments/cli.py``).

    clean       raw vendor files → cleaned_data/ (needs pandas)
    train-gan   train a GAN preset on the cleaned panel, checkpoint, sample
    sweep       latent-dim sweep (real only, or GAN-augmented via
                --gan-checkpoint), tables, summary and --stats
    serve       the replication-server drill, optionally sampling a
                trained generator from a checkpoint (--gan-checkpoint)

Every verb runs on the card unless ``--device cpu`` is given.  Not
offered yet (ROADMAP): the mesh flags, ``--profile-dir``, ``--obs-dir``,
``--eval``, ``--export-h5``, ``--dtype``, ``sweep``'s ``--h5-generator``,
``--resume`` and ``--plots``, and the verbs ``eval-gan``, ``pipeline``,
``scenario`` and ``sample-h5``.
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
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    s = sub.add_parser("sweep", help="latent-dim sweep (cells 5-33 / 51-69)")
    s.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    s.add_argument("--latents", default="1:21", help="'lo:hi' inclusive, or comma list")
    s.add_argument("--out", required=True)
    s.add_argument("--gan-checkpoint", action="append", default=None,
                   help="generator checkpoint: run the GAN-augmented sweep.  "
                        "Repeatable: K checkpoints train the real and the K "
                        "augmented sets as one (K+1)-dataset lane grid with the "
                        "padded semantics (weighted validation mean, padded "
                        "batch stream)")
    s.add_argument("--preset", default="mtss_wgan_gp_prod",
                   help="preset the checkpoints were trained with")
    s.add_argument("--n-gen-windows", type=int, default=10)
    s.add_argument("--epochs", type=int, default=None, help="AE epochs override")
    s.add_argument("--chunk-epochs", type=int, default=None,
                   help="epochs a chunk of the early-exit drive (0 = one "
                        "chunk; the results are the same either way)")
    s.add_argument("--stats", action="store_true",
                   help="the stats battery of the best latent (cell 25): "
                        "Omega/Sharpe/cVaR/CEQ/skew/kurt, FF3F/FF5F alphas, "
                        "HK+GRS spanning of each HF index vs its replication")
    s.add_argument("--ff3", default="/root/reference/data/F-F_Research_Data_Factors_daily.CSV")
    s.add_argument("--ff5",
                   default="/root/reference/data/F-F_Research_Data_5_Factors_2x3_daily.CSV")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    sv = sub.add_parser("serve", help="replication-server drill")
    sv.add_argument("--requests", type=int, default=2000, help="queries to offer")
    sv.add_argument("--timeout-ms", type=float, default=None,
                    help="per-request deadline (default: the envelope's)")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--batch-window-ms", type=float, default=5.0)
    sv.add_argument("--max-queue", type=int, default=256)
    sv.add_argument("--workers", type=int, default=2)
    sv.add_argument("--sample-every", type=int, default=0,
                    help="every Nth query samples the generator (needs "
                         "--gan-checkpoint)")
    sv.add_argument("--gan-checkpoint", default=None,
                    help="also serve `sample` queries from this trained "
                         "generator checkpoint")
    sv.add_argument("--preset", default="mtss_wgan_gp_prod",
                    help="preset the --gan-checkpoint was trained with")
    sv.add_argument("--cleaned-dir", default=DataConfig.cleaned_dir)
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cmd_clean(args) -> int:
    from hfrep_tpu_torch.core import cleaning     # pandas: only this verb
    res = cleaning.run_cleaning(args.raw_dir, out_dir=args.out_dir)
    print(f"wrote cleaned panel ({res.hfd.shape[0]} months) to {args.out_dir}")
    if args.validate_against:
        rep = cleaning.validate_against(res, args.validate_against)
        print(json.dumps(rep, indent=2))
    return 0


def _make_trainer(preset: str, cleaned_dir: str, checkpoint_dir: Optional[str] = None,
                  quiet: bool = False, nan_guard: bool = False,
                  max_recoveries: int = 3, device: str = "cuda"):
    """Preset, then panel, then dataset, then logger, then trainer."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.obs.metriclog import MetricLogger
    from hfrep_tpu_torch.train.trainer import GanTrainer

    cfg = get_preset(preset)
    if checkpoint_dir:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=checkpoint_dir))
    panel = load_panel(cleaned_dir, device=device)
    ds = build_gan_dataset(cfg.data, cfg.data.seed, panel)
    style = {"gan": "gan", "mtss_gan": "gan", "wgan": "wgan", "mtss_wgan": "wgan"}.get(
        cfg.model.family, "wgan_gp")
    logger = MetricLogger(echo=not quiet, echo_style=style)
    trainer = GanTrainer(cfg, ds, logger=logger, nan_guard=nan_guard,
                         max_recoveries=max_recoveries, device=device)
    return trainer, cfg


def cmd_train_gan(args) -> int:
    trainer, cfg = _make_trainer(
        args.preset, args.cleaned_dir, args.checkpoint_dir, args.quiet,
        nan_guard=args.nan_guard, max_recoveries=args.max_recoveries,
        device=args.device)
    target = args.epochs if args.epochs is not None else cfg.train.epochs
    if args.resume:
        from hfrep_tpu_torch.utils.checkpoint import latest
        path = latest(args.checkpoint_dir) if args.checkpoint_dir else None
        if path is None:
            print("no checkpoint to resume from; training from scratch")
        else:
            # a corrupt newest checkpoint falls back to the previous good
            # one (report the path actually restored); when every
            # candidate is corrupt, a clean fresh start
            path = trainer.restore_checkpoint()
            if path:
                print(f"resumed from {path} (epoch {trainer.epoch})")
                # recovery completes the original schedule, not epochs on top
                target = max(0, target - trainer.epoch)
            else:
                print("no restorable checkpoint (all candidates corrupt); "
                      "training from scratch")
    trainer.train(epochs=target)
    rate = (f" ({trainer.steps_per_sec:.2f} steps/s)"
            if trainer.timer.samples else " (schedule already complete)")
    print(f"trained {cfg.model.family} for {trainer.epoch} epochs{rate}")
    if args.checkpoint_dir:
        print(f"checkpoint: {trainer.save_checkpoint()}")
    if args.samples_out:
        import torch

        g = torch.Generator(device=trainer.device)
        g.manual_seed(9)
        cube = trainer.generate(args.n_samples, generator=g).cpu().numpy()
        np.save(args.samples_out, cube)
        print(f"samples: {args.samples_out} {tuple(cube.shape)}")
    return 0


def _parse_latents(spec: str):
    if ":" in spec:
        lo, hi = spec.split(":")
        return list(range(int(lo), int(hi) + 1))
    return [int(x) for x in spec.split(",")]


def _sample_augmentations(args):
    """Sample every ``--gan-checkpoint``; a source's output subdir and its
    sampling draws follow its checkpoint's stem, not the flag's position."""
    from hfrep_tpu_torch.experiments.augment import (sample_generator, source_labels,
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
    return augs, names


def _write_chunk_stats(stats, out_dir: str) -> dict:
    doc = dict(stats._asdict(), epochs_saved=stats.epochs_saved)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chunk_stats.json"), "w") as f:
        json.dump(doc, f, indent=2)
    return doc


def cmd_sweep(args) -> int:
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.experiments.augment import (augment_training_set,
                                                     augment_training_sets)
    from hfrep_tpu_torch.experiments.sweep import run_sweep, run_sweep_multi

    panel = load_panel(args.cleaned_dir, device=args.device)
    x_train, x_test, y_train, y_test = panel.train_test_split()
    rf_test = panel.rf[x_train.shape[0]:]
    cfg = AEConfig()
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.chunk_epochs is not None:
        cfg = dataclasses.replace(cfg, chunk_epochs=args.chunk_epochs)
    latents = _parse_latents(args.latents)

    augs, gen_names = _sample_augmentations(args)
    if len(augs) > 1:
        # K generators: the real and the K augmented training sets as one
        # (K+1) x L lane grid, padded to the longest
        multi = run_sweep_multi(
            augment_training_sets(x_train, y_train, augs), x_test, y_test, rf_test,
            panel.factors, cfg, latents, strategy_names=panel.hf_names,
            dataset_names=["real"] + gen_names, device=args.device)
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
                       latents, strategy_names=panel.hf_names, device=args.device)
    result.save(args.out)
    if result.chunk_stats is not None:
        _write_chunk_stats(result.chunk_stats, args.out)
    print(json.dumps(result.summary(), indent=2, default=str))
    return _sweep_outputs(args, result, args.out, panel, y_test, rf_test)


def _sweep_outputs(args, result, out_dir, panel, y_test, rf_test) -> int:
    from hfrep_tpu_torch.experiments import report

    os.makedirs(out_dir, exist_ok=True)
    if not args.stats:
        return 0
    i_best = int(np.argmax(result.oos_r2_mean))
    p = result.post[i_best]
    actual = y_test.cpu().numpy()[-p.shape[0]:]
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


def cmd_serve(args) -> int:
    from hfrep_tpu_torch.serve.aot import GenServeModel
    from hfrep_tpu_torch.serve.fixture import fixture_server, warm_server
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
    # the fixture AE head is at AEConfig() widths: 22 factors
    panels = make_panels(23, 22, (32, 64, 96), variants=8)
    server = fixture_server(scfg, preset=None, gen_model=gen_model, device=args.device)
    try:
        n_programs = warm_server(server, panels)
        print(f"serving: {n_programs} programs resident; offering "
              f"{args.requests} queries (deadline {timeout_ms:.0f}ms)", file=sys.stderr)
        report = drive_load(server, args.requests, panels, timeout_ms=timeout_ms,
                            sample_every=args.sample_every)
        print(json.dumps({"report": report, "stats": server.stats()}, indent=2,
                         default=str))
        ledger = server.outcomes.as_dict()
        if ledger["terminal"] != ledger["submitted"]:
            print(f"serve: OUTCOME LEAK: {ledger}", file=sys.stderr)
            return 1
        return 0
    finally:
        server.stop()


COMMANDS = {"clean": cmd_clean, "train-gan": cmd_train_gan, "sweep": cmd_sweep,
            "serve": cmd_serve}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)
