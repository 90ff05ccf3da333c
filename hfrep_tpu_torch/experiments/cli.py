"""``python -m hfrep_tpu_torch``: the port's CLI (``hfrep_tpu/experiments/cli.py``).

    clean       raw vendor files → cleaned_data/ (needs pandas)
    train-gan   train a GAN preset on the cleaned panel, checkpoint, sample
    serve       the replication-server drill, optionally sampling a
                trained generator from a checkpoint (--gan-checkpoint)

Every verb runs on the card unless ``--device cpu`` is given.  Not
offered yet (ROADMAP): the mesh flags, ``--profile-dir``, ``--obs-dir``,
``--eval``, ``--export-h5``, ``--dtype``, and the verbs ``eval-gan``,
``sweep``, ``pipeline``, ``scenario`` and ``sample-h5``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
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


COMMANDS = {"clean": cmd_clean, "train-gan": cmd_train_gan, "serve": cmd_serve}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    return COMMANDS[args.cmd](args)
