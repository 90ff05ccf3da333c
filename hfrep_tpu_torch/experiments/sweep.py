"""Latent-dimension sweep, the dissertation's core experiment
(``hfrep_tpu/experiments/sweep.py``; ``autoencoder_v4.ipynb`` cells 5-33
real only, 51-69 GAN-augmented).

Per latent width d in 1..21 the reference trains ``AE(X_train, Y_train,
X_test, Y_test, d)``, records IS/OOS R² and RMSE, builds the replication
strategy (``ante``), charges its costs (``post``), computes turnover and
tabulates the statistics; ``res_sort`` then picks each strategy's best
latent by Sharpe (cell 27).  Here every width is a lane of one training
grid (:func:`~hfrep_tpu_torch.replication.engine.sweep_autoencoders_chunked`)
and one batched evaluation
(:func:`~hfrep_tpu_torch.replication.engine.sweep_evaluate`).

:meth:`SweepResult.save` writes the JAX package's files with ``csv`` and
``numpy``, not pandas: for the same arrays the bytes are the same.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core.device import DeviceLike
from hfrep_tpu_torch.models.autoencoder import latent_mask
from hfrep_tpu_torch.replication import perf_stats
from hfrep_tpu_torch.replication.engine import (ChunkStats, PermSource, ReplicationEngine,
                                                emit_chunk_stats, stack_padded,
                                                sweep_autoencoders,
                                                sweep_autoencoders_chunked,
                                                sweep_autoencoders_multi, sweep_evaluate)


def _cells(col) -> List[str]:
    """A column's cells as pandas' ``to_csv`` prints them: each value's
    shortest repr in its own dtype (float32 as float32), NaN empty."""
    arr = np.asarray(col)
    cells = arr.astype(str).tolist()
    if arr.dtype.kind == "f":
        cells = ["" if np.isnan(v) else c for v, c in zip(arr.tolist(), cells)]
    return cells


def write_table(path: str, index_name: Optional[str], index: Sequence,
                columns: Dict[str, np.ndarray]) -> None:
    """A table in pandas' ``DataFrame.to_csv`` layout: a header of the
    index name (empty when None) and the column names, then one line a
    row, ``\\n``-terminated."""
    cols = [_cells(v) for v in columns.values()]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["" if index_name is None else index_name] + list(columns))
        for i, name in enumerate(index):
            w.writerow([str(name)] + [c[i] for c in cols])


@dataclasses.dataclass
class SweepResult:
    """Everything the notebook's result cells tabulate, per latent width."""

    latent_dims: List[int]
    strategy_names: List[str]
    is_r2: np.ndarray           # (L,)
    is_rmse: np.ndarray         # (L,)
    oos_r2_mean: np.ndarray     # (L,)  mean over expanding windows (cell 13)
    oos_r2_max: np.ndarray      # (L,)
    oos_rmse_mean: np.ndarray   # (L,)
    ante: np.ndarray            # (L, P, S) ex-ante replication returns
    post: np.ndarray            # (L, P, S) ex-post (net of costs)
    turnover: np.ndarray        # (L, S) annualized
    sharpe_ante: np.ndarray     # (L, S)
    sharpe_post: np.ndarray     # (L, S)
    stop_epoch: np.ndarray      # (L,) early-stopping epoch per training
    train_loss: Optional[np.ndarray] = None   # (L, epochs), NaN after stop
    val_loss: Optional[np.ndarray] = None     # (L, epochs)
    chunk_stats: Optional[ChunkStats] = None  # the training drive's accounting

    def best_by_sharpe(self, ex_post: bool = True) -> Dict[str, dict]:
        """``res_sort`` (cell 27): the best latent per strategy by Sharpe."""
        mat = self.sharpe_post if ex_post else self.sharpe_ante
        by_latent = {d: mat[i] for i, d in enumerate(self.latent_dims)}
        return perf_stats.res_sort(by_latent, self.strategy_names)

    def summary(self) -> dict:
        best = self.best_by_sharpe()
        i_best = int(np.argmax(self.oos_r2_mean))
        return {
            "best_oos_r2": {"latent": self.latent_dims[i_best],
                            "mean": float(self.oos_r2_mean[i_best]),
                            "max": float(self.oos_r2_max[i_best])},
            "best_oos_rmse": float(np.min(self.oos_rmse_mean)),
            "best_latent_by_strategy": best,
        }

    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        write_table(os.path.join(out_dir, "fit_metrics.csv"), "latent_dim", self.latent_dims,
                    {"IS_R2": self.is_r2, "IS_RMSE": self.is_rmse,
                     "OOS_R2_mean": self.oos_r2_mean, "OOS_R2_max": self.oos_r2_max,
                     "OOS_RMSE_mean": self.oos_rmse_mean, "stop_epoch": self.stop_epoch})
        for name, arr in [("sharpe_ante", self.sharpe_ante),
                          ("sharpe_post", self.sharpe_post),
                          ("turnover", self.turnover)]:
            write_table(os.path.join(out_dir, f"{name}.csv"), "latent_dim", self.latent_dims,
                        {s: np.asarray(arr)[:, j] for j, s in enumerate(self.strategy_names)})
        np.save(os.path.join(out_dir, "ante.npy"), self.ante)
        np.save(os.path.join(out_dir, "post.npy"), self.post)
        if self.train_loss is not None:
            np.save(os.path.join(out_dir, "train_loss.npy"), self.train_loss)
            np.save(os.path.join(out_dir, "val_loss.npy"), self.val_loss)
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(self.summary(), f, indent=2, default=str)


def run_sweep(x_train, y_train, x_test, y_test, rf_test, factor_full,
              cfg: Optional[AEConfig] = None,
              latent_dims: Sequence[int] = tuple(range(1, 22)),
              seed: Optional[int] = None,
              strategy_names: Optional[Sequence[str]] = None,
              init_params: Optional[dict] = None,
              perm_source: Optional[PermSource] = None,
              device: DeviceLike = None, resume_dir: Optional[str] = None,
              mesh=None) -> SweepResult:
    """Train every latent width as one lane grid, then evaluate it.

    ``x_train``/``y_train`` may be GAN-augmented (synthetic rows above the
    real ones); ``x_test``/``y_test``/``rf_test`` are the real OOS panels
    and ``factor_full`` the full factor panel the costs draw their
    covariance windows from.  ``init_params``/``perm_source`` are the
    engine's draw seams (lane-leading).  ``resume_dir`` keeps the chunked
    drive's snapshots there and resumes from them (chunked drive only).
    ``mesh`` (a ``('dp',)`` mesh, e.g.
    :func:`~hfrep_tpu_torch.parallel.rules.lane_mesh`) splits the lanes
    over its ranks, bit for bit the meshless drive (chunked drive only)."""
    cfg = cfg or AEConfig()
    seed = cfg.seed if seed is None else seed
    latent_dims = list(latent_dims)
    cfg = dataclasses.replace(cfg, latent_dim=max(latent_dims))
    engine = ReplicationEngine(x_train, y_train, x_test, y_test, cfg, device=device)
    stats = None
    if resume_dir is not None and not (cfg.chunk_epochs and cfg.chunk_epochs > 0):
        raise ValueError("resume_dir requires the chunked drive (cfg.chunk_epochs > 0): "
                         "a monolithic sweep has no chunk boundary to resume from")
    if cfg.chunk_epochs and cfg.chunk_epochs > 0:
        swept, stats = sweep_autoencoders_chunked(seed, engine.x_train, cfg, latent_dims,
                                                  init_params, perm_source, engine.device,
                                                  resume_dir=resume_dir, mesh=mesh)
        emit_chunk_stats(stats)
    else:
        if mesh is not None:
            raise ValueError("mesh requires the chunked drive (cfg.chunk_epochs > 0)")
        swept = sweep_autoencoders(seed, engine.x_train, cfg, latent_dims, init_params,
                                   perm_source, engine.device)
    res = _evaluate_sweep(engine, cfg, rf_test, factor_full, swept.params, latent_dims,
                          strategy_names, stop_epoch=swept.stop_epoch,
                          train_loss=swept.train_loss, val_loss=swept.val_loss)
    res.chunk_stats = stats
    return res


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _evaluate_sweep(engine, cfg, rf_test, factor_full, params, latent_dims,
                    strategy_names, *, stop_epoch, train_loss, val_loss) -> SweepResult:
    """The one sweep evaluation and :class:`SweepResult` assembly, shared by
    the single- and the multi-dataset paths."""
    masks = torch.stack([latent_mask(d, cfg.latent_dim, device=engine.device)
                         for d in latent_dims])
    ev = {k: _host(v) for k, v in sweep_evaluate(
        cfg, engine.x_train, engine.x_test, engine.y_test, rf_test, factor_full,
        params, masks).items()}
    names = list(strategy_names) if strategy_names is not None else [
        f"strategy_{j}" for j in range(ev["ante"].shape[2])]
    return SweepResult(
        latent_dims=list(latent_dims), strategy_names=names,
        is_r2=ev["is_r2"], is_rmse=ev["is_rmse"],
        oos_r2_mean=ev["oos_r2"].mean(axis=1),
        oos_r2_max=ev["oos_r2"].max(axis=1),
        oos_rmse_mean=ev["oos_rmse"].mean(axis=1),
        ante=ev["ante"], post=ev["post"], turnover=ev["turnover"],
        sharpe_ante=ev["sharpe_ante"], sharpe_post=ev["sharpe_post"],
        stop_epoch=_host(stop_epoch), train_loss=_host(train_loss),
        val_loss=_host(val_loss))


@dataclasses.dataclass
class MultiSweepResult:
    """One batched cross-dataset sweep: a :class:`SweepResult` per dataset
    and the grid's dispatch accounting."""

    dataset_names: List[str]
    results: List[SweepResult]          # aligned with dataset_names
    chunk_stats: Optional[ChunkStats]

    def __getitem__(self, name: str) -> SweepResult:
        return self.results[self.dataset_names.index(name)]

    def save(self, out_dir: str) -> None:
        for name, res in zip(self.dataset_names, self.results):
            res.save(os.path.join(out_dir, name))


def run_sweep_multi(datasets, x_test, y_test, rf_test, factor_full,
                    cfg: Optional[AEConfig] = None,
                    latent_dims: Sequence[int] = tuple(range(1, 22)),
                    seed: Optional[int] = None,
                    strategy_names: Optional[Sequence[str]] = None,
                    dataset_names: Optional[Sequence[str]] = None,
                    init_params: Optional[dict] = None,
                    perm_source: Optional[PermSource] = None,
                    device: DeviceLike = None,
                    resume_dir: Optional[str] = None, mesh=None) -> MultiSweepResult:
    """K+1 training sets × L latent widths as one (K+1, L) lane grid.

    ``datasets`` holds ``(x_train, y_train)`` pairs (the real set and K
    augmented ones, of different row counts).  Each is MinMax-scaled with
    its own train-set params, padded to the longest
    (:func:`~hfrep_tpu_torch.replication.engine.stack_padded`) and trained
    with the padded semantics, whose sample weights hide the padding;
    each is then evaluated on its unpadded panel.  ``resume_dir`` as in
    :func:`run_sweep`; ``mesh`` splits the (K+1) datasets over its ranks,
    bit for bit the meshless drive."""
    cfg = cfg or AEConfig()
    seed = cfg.seed if seed is None else seed
    latent_dims = list(latent_dims)
    cfg = dataclasses.replace(cfg, latent_dim=max(latent_dims))
    names = (list(dataset_names) if dataset_names is not None
             else [f"dataset_{d}" for d in range(len(datasets))])
    if len(names) != len(datasets):
        raise ValueError(f"{len(datasets)} datasets but {len(names)} names")
    engines = [ReplicationEngine(x, y, x_test, y_test, cfg, device=device)
               for x, y in datasets]
    x_stack, n_rows = stack_padded([e.x_train for e in engines])
    swept, stats = sweep_autoencoders_multi(seed, x_stack, n_rows, cfg, latent_dims,
                                            init_params, perm_source, engines[0].device,
                                            resume_dir=resume_dir, mesh=mesh)
    emit_chunk_stats(stats)
    results = [
        _evaluate_sweep(engine, cfg, rf_test, factor_full,
                        {k: v[d] for k, v in swept.params.items()}, latent_dims,
                        strategy_names, stop_epoch=swept.stop_epoch[d],
                        train_loss=swept.train_loss[d], val_loss=swept.val_loss[d])
        for d, engine in enumerate(engines)]
    return MultiSweepResult(dataset_names=names, results=results, chunk_stats=stats)
