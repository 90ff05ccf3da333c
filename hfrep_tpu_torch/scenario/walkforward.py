"""Walk-forward regime sweeps: the AE sweep rolled forward in time
(``hfrep_tpu/scenario/walkforward.py``).

Window *w* trains on the first ``start + w·step`` months and is scored
out of sample on the next ``horizon`` months; every (window × latent)
training is a lane of ONE padded grid
(:func:`~hfrep_tpu_torch.replication.engine.sweep_autoencoders_multi`
over :func:`~hfrep_tpu_torch.replication.engine.stack_padded`): the
ragged row counts of the expanding windows are what the padded grid's
per-dataset split is for.  Each window's lanes are scored in one batched
evaluation at the fixed horizon.

Resume: the trained lane grid is persisted once as an atomic artifact,
so a run killed while scoring never retrains, and each window's scores
publish atomically, so a re-run scores only the gap; state from another
(spec, cfg, data) is refused by its fingerprint.  Not ported yet
(ROADMAP): the engine's chunk snapshots (``resume_dir``), so a drain
during training does not resume mid-training, and the resilience
layer's drain and the wall-clock ledger (named no-op stubs below).

Artifacts under ``out_dir``::

    windows/w_<i>/scores.npz     per-window Sharpe surfaces (atomic)
    walkforward.json             spec + per-window digests + summary
    walkforward.csv              sharpe_post surface (window × latent)
    walkforward_ante.csv         sharpe_ante surface
    _resume/                     the trained-grid artifact (cleared on completion)

The CSVs are written with the ``csv`` module, byte for byte what the
JAX package's pandas ``to_csv`` writes for the same surfaces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.replication.engine import AEResult, PermSource

TRAINED_GRID = "trained_grid"
MANIFEST = "walkforward.json"


# ------------------------------------------------- hooks of later layers
def _graceful_drain():
    """Stub of ``resilience.graceful_drain``: the SIGTERM handler's scope."""
    return contextlib.nullcontext()


def _boundary(site: str) -> None:
    """Stub of ``resilience.boundary``: a requested drain exits here."""


@dataclasses.dataclass(frozen=True)
class WalkForwardSpec:
    """The roll schedule.  ``start``: training months of the first
    window; ``step``: months the training window grows per roll;
    ``horizon``: fixed OOS months scored per window."""

    start: int
    n_windows: int
    horizon: int
    step: int = 1

    def train_rows(self, w: int) -> int:
        return self.start + w * self.step


def validate_spec(spec: WalkForwardSpec, cfg: AEConfig, total_months: int) -> None:
    """Refuse schedules the padded semantics would silently corrupt, in
    particular a window shorter than its own validation split (zero fit
    or zero validation rows), which would train a lane on nothing."""
    if spec.start < 1 or spec.n_windows < 1 or spec.step < 1:
        raise ValueError(f"degenerate walk-forward spec {spec}")
    if spec.horizon < cfg.ols_window + 2:
        raise ValueError(
            f"horizon {spec.horizon} too short: the ex-ante strategy "
            f"needs > ols_window + 1 = {cfg.ols_window + 1} OOS months "
            "(rolling betas plus one realized month)")
    need = spec.train_rows(spec.n_windows - 1) + spec.horizon
    if need > total_months:
        raise ValueError(
            f"walk-forward needs {need} months (last window "
            f"{spec.train_rows(spec.n_windows - 1)} train + "
            f"{spec.horizon} horizon) but the panel has {total_months}")
    for w in (0, spec.n_windows - 1):
        rows = spec.train_rows(w)
        n_fit = int(rows * (1.0 - cfg.val_split))
        if n_fit < 1 or rows - n_fit < 1:
            raise ValueError(
                f"window {w} has {rows} training months — shorter than "
                f"its own validation split (val_split={cfg.val_split} "
                f"leaves fit={n_fit}, val={rows - n_fit}); walk-forward "
                "refuses rather than truncating the split")


def digest_arrays(*arrays) -> str:
    """Order-sensitive sha256 over dtype, shape and bytes of arrays
    (``hfrep_tpu/resilience/snapshot.py``'s, for flat arrays); ``None``
    hashes as a marker."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        arr = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _fingerprint(spec: WalkForwardSpec, cfg: AEConfig, latent_dims: Sequence[int],
                 x, y, rf) -> dict:
    return {"spec": list(dataclasses.astuple(spec)),
            "cfg": [str(v) for v in dataclasses.astuple(cfg)],
            "latent_dims": [int(d) for d in latent_dims],
            "data": digest_arrays(x, y, rf)}


def _train_grid(seed: int, x, spec: WalkForwardSpec, cfg: AEConfig,
                latent_dims: Sequence[int], init_params: Optional[dict] = None,
                perm_source: Optional[PermSource] = None, device: DeviceLike = None):
    """Train every (window, latent) lane as one padded grid.

    Expanding prefixes are MinMax-scaled each with its own train-set
    params (ReplicationEngine semantics), stacked ragged and driven
    through the multi-dataset grid.  ``init_params`` / ``perm_source``
    are the engine's draw seams, with the grid's (n_windows, L) leading
    dims.  Returns ``(AEResult, ChunkStats, n_rows)``, the result's arrays
    leading ``(n_windows, L)``."""
    from hfrep_tpu_torch.core import scaler as mm
    from hfrep_tpu_torch.replication.engine import stack_padded, sweep_autoencoders_multi

    x = torch.as_tensor(np.asarray(x, np.float32))
    prefixes = [mm.fit_transform(x[:spec.train_rows(w)])[1] for w in range(spec.n_windows)]
    x_stack, n_rows = stack_padded(prefixes)
    res, stats = sweep_autoencoders_multi(seed, x_stack, n_rows, cfg, list(latent_dims),
                                          init_params=init_params, perm_source=perm_source,
                                          device=device)
    return res, stats, n_rows


def _save_grid(path, res: AEResult, fingerprint: dict) -> None:
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    arrays = {f"param_{k}": v.detach().cpu().numpy() for k, v in sorted(res.params.items())}
    for k in ("stop_epoch", "train_loss", "val_loss"):
        arrays[k] = getattr(res, k).detach().cpu().numpy()

    def writer(tmp: Path) -> None:
        np.savez(tmp / "grid.npz", **arrays)

    ckpt.write_atomic(path, writer, metadata={"fingerprint": fingerprint},
                      io_site="snapshot_save", fault_site="snapshot")


def _load_grid(path, fingerprint: dict, device: torch.device) -> Optional[AEResult]:
    """The persisted trained lane grid on ``device``, or None when absent,
    corrupt or of another (spec, cfg, data): never trust a foreign one."""
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    p = Path(path)
    if not (p / ckpt.META_NAME).exists():
        return None
    try:
        meta = ckpt.verify(p)
    except ckpt.CheckpointCorrupt:
        return None
    if meta is None or meta.get("fingerprint") != fingerprint:
        return None
    with np.load(p / "grid.npz") as z:
        arrays = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    params = {k[len("param_"):]: arrays[k] for k in arrays if k.startswith("param_")}
    return AEResult(params=params, stop_epoch=arrays["stop_epoch"],
                    train_loss=arrays["train_loss"], val_loss=arrays["val_loss"])


def _make_window_eval(cfg: AEConfig):
    """``fn(params, masks, x_test, y_test, rf_t, factor_tail) ->
    (sharpe_ante (L, S), sharpe_post (L, S))``: one window's latent lanes
    scored in one batched evaluation at the fixed horizon."""
    from hfrep_tpu_torch.core import costs
    from hfrep_tpu_torch.replication import perf_stats
    from hfrep_tpu_torch.replication.engine import ante_weights

    window = cfg.ols_window

    @torch.no_grad()
    def fn(params, masks, x_test, y_test, rf_t, factor_tail):
        ante, weights = ante_weights(cfg, params, masks, x_test, y_test, rf_t, window)
        post = costs.ex_post_return(ante, window, weights.movedim(-1, -3), factor_tail)
        p = ante.shape[-2]
        rf_tail = rf_t.reshape(-1)[-p:]
        return (perf_stats.annualized_sharpe(ante.movedim(-2, 0), rf_tail),
                perf_stats.annualized_sharpe(post.movedim(-2, 0), rf_tail))

    return fn


def run_walkforward(x, y, rf, spec: WalkForwardSpec, cfg: AEConfig,
                    latent_dims: Sequence[int], out_dir, resume: bool = False,
                    device: DeviceLike = None) -> dict:
    """The whole drive on ``device`` (``None``: the card): the padded
    training grid, then each window's scores, then the surfaces.  Returns
    ``{"surface_post", "surface_ante", "manifest", "stats"}``.  A re-run
    reuses the trained grid and the window scores of the same fingerprint
    and refuses foreign ones; ``resume`` is accepted for the CLI's
    symmetry.  The grid's draws come from ``cfg.seed`` (the seams for
    other draws are :func:`_train_grid`'s)."""
    from hfrep_tpu_torch.models.autoencoder import latent_mask
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    latent_dims = [int(d) for d in latent_dims]
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    rf = np.asarray(rf, np.float32).reshape(-1)
    validate_spec(spec, cfg, x.shape[0])
    if y.shape[0] != x.shape[0] or rf.shape[0] != x.shape[0]:
        raise ValueError(f"x/y/rf months disagree: {x.shape[0]}, "
                         f"{y.shape[0]}, {rf.shape[0]}")
    cfg = dataclasses.replace(cfg, n_factors=int(x.shape[1]), latent_dim=max(latent_dims))
    out = Path(out_dir)
    windows_dir = out / "windows"
    windows_dir.mkdir(parents=True, exist_ok=True)
    resume_root = out / "_resume"
    fingerprint = _fingerprint(spec, cfg, latent_dims, x, y, rf)

    t0 = time.perf_counter()
    grid = _load_grid(resume_root / TRAINED_GRID, fingerprint, dev)
    stats = None
    if grid is None:
        resume_root.mkdir(parents=True, exist_ok=True)
        grid, stats, _ = _train_grid(cfg.seed, x, spec, cfg, latent_dims, device=dev)
        try:
            _save_grid(resume_root / TRAINED_GRID, grid, fingerprint)
        except OSError as e:
            # the persisted grid only saves a retrain after a kill while
            # scoring; a failed write must not fail a trained drive
            print(f"warning: trained grid not persisted ({e}); a kill while "
                  "scoring will retrain", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_secs = time.perf_counter() - t0

    masks = torch.stack([latent_mask(d, cfg.latent_dim, device=dev) for d in latent_dims])
    eval_fn = _make_window_eval(cfg)
    horizon, ols = spec.horizon, cfg.ols_window
    p_months = horizon - ols - 1
    digests: Dict[str, str] = {}
    surface_post = np.empty((spec.n_windows, len(latent_dims), y.shape[1]), np.float32)
    surface_ante = np.empty_like(surface_post)
    t1 = time.perf_counter()
    x_d, y_d, rf_d = (torch.from_numpy(a).to(dev) for a in (x, y, rf))
    with _graceful_drain():
        for w in range(spec.n_windows):
            name = f"w_{w:04d}"
            dst = windows_dir / name
            meta = None
            if (dst / ckpt.META_NAME).exists():
                try:
                    meta = ckpt.verify(dst)
                except ckpt.CheckpointCorrupt:
                    meta = None
                if meta is not None and meta.get("fingerprint") != fingerprint:
                    raise ValueError(
                        f"{dst} holds scores from a DIFFERENT walk-forward (spec/cfg/data "
                        "differ) — remove the out dir or use a fresh one")
            if meta is None:
                e = spec.train_rows(w)
                params_w = {k: v[w] for k, v in grid.params.items()}
                sa, sp = eval_fn(params_w, masks, x_d[e:e + horizon], y_d[e:e + horizon],
                                 rf_d[e:e + horizon],
                                 x_d[e + horizon - (p_months + ols):e + horizon])
                sa = sa.cpu().numpy().astype(np.float32)
                sp = sp.cpu().numpy().astype(np.float32)
                stop = grid.stop_epoch[w].cpu().numpy()

                def writer(tmp: Path, a=sa, p=sp, s=stop) -> None:
                    np.savez(tmp / "scores.npz", sharpe_ante=a, sharpe_post=p, stop_epoch=s)

                ckpt.write_atomic(dst, writer,
                                  metadata={"fingerprint": fingerprint, "window": w,
                                            "train_rows": int(e)},
                                  io_site="snapshot_save", fault_site="snapshot")
                meta = ckpt.read_meta(dst)
            with np.load(dst / "scores.npz") as z:
                surface_ante[w] = z["sharpe_ante"]
                surface_post[w] = z["sharpe_post"]
            digests[name] = meta["checksum"]["digest"]
            # the window boundary: a requested drain exits here with every
            # published score intact (a re-run scores the gap)
            _boundary("window")
    eval_secs = time.perf_counter() - t1

    manifest = _assemble(out, spec, cfg, latent_dims, digests, surface_post, surface_ante)
    shutil.rmtree(resume_root, ignore_errors=True)
    lanes = spec.n_windows * len(latent_dims)
    rows = [spec.train_rows(w) for w in range(spec.n_windows)]
    run_stats = {
        "funds": int(y.shape[1]),
        "months": int(x.shape[0]),
        "lanes": lanes,
        "pad_waste_frac": float(1.0 - (sum(rows) / (len(rows) * max(rows)))),
        "train_secs": round(train_secs, 3),
        "eval_secs": round(eval_secs, 3),
        "windows_per_sec": round(spec.n_windows / max(train_secs + eval_secs, 1e-9), 3),
        "chunk_stats": stats._asdict() if stats is not None else None,
    }
    return {"surface_post": surface_post, "surface_ante": surface_ante,
            "manifest": manifest, "stats": run_stats}


def _assemble(out: Path, spec: WalkForwardSpec, cfg: AEConfig, latent_dims: List[int],
              digests: Dict[str, str], surface_post: np.ndarray,
              surface_ante: np.ndarray) -> dict:
    """The deterministic outputs: mean-over-strategy Sharpe surfaces as CSV
    (window-start rows × latent columns, pandas' ``to_csv`` layout) and
    the digest-indexed ``walkforward.json``, byte-stable across resumes."""
    from hfrep_tpu_torch.experiments.sweep import write_table
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    idx = [spec.train_rows(w) for w in range(spec.n_windows)]
    cols = [f"latent_{d}" for d in latent_dims]
    for fname, surf in (("walkforward.csv", surface_post),
                        ("walkforward_ante.csv", surface_ante)):
        mean = surf.mean(axis=2)
        write_table(str(out / fname), "train_rows", idx,
                    {c: mean[:, j] for j, c in enumerate(cols)})
    mean_post = surface_post.mean(axis=2)
    best = [{"train_rows": int(idx[w]),
             "latent": int(latent_dims[int(np.argmax(mean_post[w]))]),
             "sharpe_post": round(float(np.max(mean_post[w])), 9)}
            for w in range(spec.n_windows)]
    manifest = {
        "spec": dataclasses.asdict(spec),
        "latent_dims": latent_dims,
        "ols_window": cfg.ols_window,
        "windows": digests,
        "aggregate_digest": ckpt.aggregate_digest(digests),
        "summary": {"best_latent_by_window": best,
                    "mean_sharpe_post": round(float(mean_post.mean()), 9)},
    }
    tmp = out / f".{MANIFEST}.tmp-{os.getpid()}"
    tmp.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    os.replace(tmp, out / MANIFEST)
    return manifest
