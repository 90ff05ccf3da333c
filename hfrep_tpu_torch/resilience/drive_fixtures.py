"""Chaos fixture bindings for every registered drive
(``hfrep_tpu/resilience/drive_fixtures.py``).

Each ``run_*`` function is one end-to-end drive at fixture shapes, a pure
function of ``(fixture_seed, schedule)`` on a given device: fixed fixture
data derived from the seed, fixed configs, every artifact written
deterministically.  The :class:`~hfrep_tpu_torch.resilience.drive.
DriveSpec` registry binds them lazily (``"module:function"``), the chaos
engine spawns them as ``python -m hfrep_tpu_torch.resilience
chaos-subject`` subprocesses under the one :func:`~hfrep_tpu_torch.
resilience.drive.run_drive` envelope, and the shared oracles judge the
wreckage (:mod:`hfrep_tpu_torch.resilience.chaos_oracles`).

Contract of a fixture ``run(out, fixture_seed, resume, device)``:

* final outputs land under ``<out>/artifacts`` through the atomic
  writers; scratch state (checkpoints, resume snapshots, queues) under
  ``<out>/scratch``;
* ``deterministic`` specs produce bit-identical ``artifacts/`` for any
  faulted-then-resumed run and an undisturbed reference run of the same
  ``fixture_seed`` on the same device;
* ``device`` is where the drive's tensors live (``"cuda"`` or
  ``"cpu"``), passed explicitly to each subprocess leg; the rollup and
  canary drives touch no tensor and ignore it;
* heavy imports (torch, the training stacks) stay inside the functions,
  so the registry lists without them.

The shapes are the JAX fixtures', but for ``gan_ckpt``: the JAX fixture
trains the ``gan`` family; the port's trains ``mtss_wgan_gp`` at H=100
(window 8, four features) so that its run launches the fused critic's
kernels, the training path the hand kernels serve.  ``_planted`` is the
engine's canary: a deliberate swallowed-EIO silent drop that the search
must find and shrink to one directive (tier ``test``, never soaked).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


# ------------------------------------------------------------- helpers
def _panel(rows: int, feats: int, fixture_seed: int, salt: int):
    from hfrep_tpu_torch.utils.fixture_data import scaled_panel
    return scaled_panel(rows, feats, seed=1000 + 31 * fixture_seed + salt)


def _numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else v


def _write_npz_artifact(out: Path, name: str, arrays: dict) -> None:
    """Publish ``arrays`` as ``<out>/artifacts/<name>/data.npz`` through the
    one crash-consistent writer (``result_save``/``result`` fault sites:
    the artifact-publication boundary of every subject)."""
    import numpy as np

    from hfrep_tpu_torch.utils import checkpoint as ckpt

    def writer(tmp: Path) -> None:
        np.savez(tmp / "data.npz", **{k: _numpy(v) for k, v in arrays.items()})

    ckpt.write_atomic(out / "artifacts" / name, writer, metadata={"subject": name},
                      io_site="result_save", fault_site="result")


def _result_arrays(res) -> dict:
    """An AEResult (params and traces) as a flat npz-ready dict."""
    arrays = {f"p_{k}": v for k, v in sorted(res.params.items())}
    arrays["train_loss"] = res.train_loss
    arrays["val_loss"] = res.val_loss
    arrays["stop_epoch"] = res.stop_epoch
    return arrays


# ------------------------------------------------------------- fixtures
def run_ae_sweep(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The paper's latent sweep at fixture shape, chunked with resume:
    kill→resume stays bit-identical."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication.engine import sweep_autoencoders_chunked

    xs = _panel(32, 4, fixture_seed, salt=1)
    cfg = AEConfig(n_factors=4, latent_dim=3, epochs=4, batch_size=16, patience=2,
                   seed=fixture_seed, chunk_epochs=2)
    res, stats = sweep_autoencoders_chunked(fixture_seed, xs, cfg, [1, 2, 3], device=device,
                                            resume_dir=str(out / "scratch" / "resume"))
    _write_npz_artifact(out, "sweep", _result_arrays(res))
    return {"chunks": int(stats.chunks_dispatched)}


def run_ae_multi(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The padded multi-dataset fabric (ragged rows through the row
    counts) under the same kill→resume contract."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication.engine import stack_padded, sweep_autoencoders_multi

    a = _panel(36, 4, fixture_seed, salt=2)
    stack, rows = stack_padded([a, a[:28]])
    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16, patience=2,
                   seed=fixture_seed, chunk_epochs=2)
    res, stats = sweep_autoencoders_multi(fixture_seed + 1, stack, rows, cfg, [1, 2],
                                          device=device,
                                          resume_dir=str(out / "scratch" / "resume"))
    _write_npz_artifact(out, "multi", _result_arrays(res))
    return {"chunks": int(stats.chunks_dispatched)}


def run_ae_mesh(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The padded multi-dataset fabric dispatched through the lane mesh on
    a 1×1 ``('dp',)`` mesh of the subject's device, under the same
    kill→resume / exit-contract / atomic-artifact oracles as the plain
    drive.  A one-device mesh runs the meshless drive itself, so the
    oracle reference stays the undisturbed run."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.parallel.rules import MeshSpec, build_mesh
    from hfrep_tpu_torch.replication.engine import stack_padded, sweep_autoencoders_multi

    a = _panel(36, 4, fixture_seed, salt=2)
    stack, rows = stack_padded([a, a[:28]])
    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16, patience=2,
                   seed=fixture_seed, chunk_epochs=2)
    res, stats = sweep_autoencoders_multi(fixture_seed + 1, stack, rows, cfg, [1, 2],
                                          resume_dir=str(out / "scratch" / "resume"),
                                          mesh=build_mesh(MeshSpec(dp=1), device=device))
    _write_npz_artifact(out, "multi", _result_arrays(res))
    return {"chunks": int(stats.chunks_dispatched)}


def run_gan_ckpt(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """GAN train→checkpoint→resume: periodic checkpoints, a drain at a
    block boundary, restore walking past torn and corrupt checkpoints,
    including the all-candidates-corrupt fresh start (which a fresh
    deterministic retrain makes bit-identical again)."""
    import numpy as np
    import torch

    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.train.trainer import GanTrainer

    epochs = 4
    cfg = ExperimentConfig(
        model=ModelConfig(features=4, window=8, hidden=100, family="mtss_wgan_gp"),
        train=TrainConfig(epochs=epochs, batch_size=4, n_critic=1, steps_per_call=2,
                          seed=fixture_seed, checkpoint_dir=str(out / "scratch" / "ckpts"),
                          checkpoint_every=2))
    rng = np.random.default_rng(2000 + fixture_seed)
    ds = torch.from_numpy(rng.standard_normal((12, 8, 4)).astype(np.float32))
    tr = GanTrainer(cfg, ds, device=device)
    if resume:
        try:
            path = tr.restore_checkpoint()
        except FileNotFoundError:
            path = ""           # nothing persisted yet: a clean fresh start
        if not path:
            print("gan_ckpt: no restorable checkpoint, fresh start", file=sys.stderr)
    remaining = epochs - tr.epoch
    if remaining > 0:
        tr.train(epochs=remaining)
    g = tr.state.generator.state_dict()
    _write_npz_artifact(out, "gan", {f"g_{k}": v for k, v in sorted(g.items())})
    return {"epochs": int(tr.epoch)}


def run_serve_load(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """Serving chaos load: a real server over a really-trained tiny AE
    head under whatever the schedule throws at it.  Not bit-identical
    (thread timing decides sheds and deadlines): the oracles here are the
    ledger (terminal == submitted) and the exit-code contract.  A resumed
    leg is a fresh load run."""
    from concurrent.futures import wait

    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication.engine import train_autoencoder_chunked
    from hfrep_tpu_torch.serve.aot import AEServeModel
    from hfrep_tpu_torch.serve.loadgen import make_panels
    from hfrep_tpu_torch.serve.server import ReplicationServer, ServeConfig

    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=6, batch_size=16, patience=2,
                   seed=fixture_seed, chunk_epochs=3)
    res, _ = train_autoencoder_chunked(fixture_seed, _panel(36, 4, fixture_seed, 3), cfg,
                                       device=device)
    model = AEServeModel.create(cfg, {k: _numpy(v) for k, v in res.params.items()},
                                device=device)
    scfg = ServeConfig(max_batch=4, batch_window_ms=5.0, request_timeout_ms=2000.0,
                       max_queue=16, workers=1, row_buckets=(16, 32), breaker_failures=2,
                       breaker_cooldown_s=0.2, compile_storm=64)
    server = ReplicationServer(scfg, ae_model=model).start()
    panels = make_panels(fixture_seed + 1, 4, (12, 20), variants=3)
    try:
        with resilience.graceful_drain():
            futs = []
            try:
                for _ in range(2):
                    futs += [server.replicate(panels[i % len(panels)], timeout_ms=2000.0)
                             for i in range(8)]
                    wait(futs, timeout=30)
                    # the drive boundary: injected sigterm/preempt land here
                    # and drain the server as the CLI would
                    resilience.boundary("serve_drive")
            except resilience.Preempted:
                server.drain(reason="chaos drain", timeout=30.0)
                wait(futs, timeout=30)
                raise
        wait(futs, timeout=30)
    finally:
        ledger = server.outcomes.as_dict()
        server.stop()
    return {"submitted": int(ledger["submitted"]), "terminal": int(ledger["terminal"])}


def run_walkforward(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The scenario factory's walk-forward sweep at fixture shape:
    chunk-snapshot training, window-granular scoring, resume
    byte-identical."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.scenario.walkforward import WalkForwardSpec, run_walkforward
    from hfrep_tpu_torch.utils.fixture_data import universe_arrays

    x, y, rf = universe_arrays(3000 + fixture_seed, funds=6, months=48, n_factors=4)
    spec = WalkForwardSpec(start=24, n_windows=2, horizon=10, step=2)
    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16, patience=2,
                   seed=fixture_seed, chunk_epochs=2, ols_window=8)
    doc = run_walkforward(x, y, rf, spec, cfg, [1, 2], out / "scratch" / "wf",
                          resume=resume, device=device)
    _write_npz_artifact(out, "walkforward", {"surface_post": doc["surface_post"],
                                             "surface_ante": doc["surface_ante"]})
    return {"windows": int(spec.n_windows)}


def run_scenario_bank(out: Path, fixture_seed: int, resume: bool,
                      device: str = "cuda") -> dict:
    """The scenario factory's bank drive (CLI ``scenario bank``): a tiny
    conditional GAN trained on the fixture panel, then a deterministic
    regime-conditioned sample bank published block by block.  Drain
    points: ``gan_block`` between training dispatches, ``bank_block``
    after each published block; a resumed run completes only the gap,
    bit-identical because the deterministic retrain rebuilds the same
    generator."""
    import numpy as np

    from hfrep_tpu_torch.config import ModelConfig, TrainConfig
    from hfrep_tpu_torch.scenario import regimes as reg
    from hfrep_tpu_torch.scenario.conditional import (
        generate_bank,
        sliding_windows,
        train_conditional,
    )

    feats, window, n_regimes = 4, 8, 2
    panel = np.asarray(_numpy(_panel(40, feats, fixture_seed, salt=4)))
    labels = reg.label_regimes(panel, window=window, n_regimes=n_regimes)
    windows = sliding_windows(panel, window)
    conds = reg.window_conditions(labels, window, n_regimes)
    mcfg = ModelConfig(family="gan", features=feats, window=window, hidden=8)
    # steps_per_call=1: a gan_block boundary between every training dispatch
    tcfg = TrainConfig(batch_size=8, n_critic=1, seed=fixture_seed, steps_per_call=1)
    bundle = train_conditional(mcfg, tcfg, windows, conds, epochs=2, seed=fixture_seed,
                               device=device)
    manifest = generate_bank(bundle, out / "artifacts" / "bank", blocks=2, block_size=4,
                             stream_seed=100 + fixture_seed)
    return {"blocks": len(manifest["block_digests"]), "generated": int(manifest["generated"])}


def run_rollup(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The telemetry plane's retention loop under fire: a compressed-time
    soak that appends deterministic event batches to a synthetic run dir,
    rotates the live stream at a byte threshold and compacts every cycle.
    A kill or EIO mid-segment (``rollup_publish``) or mid-compaction must
    resume from the durable cursor with no event lost or counted twice.

    Events are raw JSONL with seed-derived times (never through ``Obs``,
    whose clock is the wall's); rotation is byte-driven and in the same
    guarded step as the append; per-batch progress is published after
    append and rotate and before compaction.  ``items`` (records the final
    state folded) must equal ``expected_items`` (records written)."""
    import hashlib
    import json as _json

    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.obs import rollup
    from hfrep_tpu_torch.utils.checkpoint import atomic_text

    batches, rotate_bytes, bucket_secs = 24, 2048, 60.0
    run = out / "scratch" / "soak_run"
    run.mkdir(parents=True, exist_ok=True)
    live = run / "events.jsonl"
    progress_path = out / "scratch" / "progress.json"

    def batch_lines(k: int) -> list:
        base_t = k * 37.0
        rnd = hashlib.sha256(f"{fixture_seed}:{k}".encode()).digest()
        recs = []
        for i in range(10):
            recs.append({"v": 1, "t": base_t + i * 0.31, "type": "metric", "kind": "gauge",
                         "name": "soak/depth", "value": rnd[i] % 17})
        for i in range(8):
            recs.append({"v": 1, "t": base_t + 3.1 + i * 0.17, "type": "metric",
                         "kind": "histogram", "name": "serve/latency_ms",
                         "value": 1.0 + (rnd[10 + i] % 50)})
        for i in range(4):
            recs.append({"v": 1, "t": base_t + 5.0 + i * 0.13, "type": "metric",
                         "kind": "counter", "name": "soak/requests",
                         "value": k * 4 + i + 1, "delta": 1})
        for i in range(5):
            recs.append({"v": 1, "t": base_t + 6.0 + i * 0.11, "type": "span", "name": "work",
                         "dur": 0.01 * (1 + rnd[18 + i] % 9), "depth": 0})
        recs.append({"v": 1, "t": base_t + 9.0, "type": "event", "name": "batch_end",
                     "batch": k})
        return [_json.dumps(r, sort_keys=True) for r in recs]

    per_batch = len(batch_lines(0))
    done = 0
    if resume:
        try:
            done = int(_json.loads(progress_path.read_text())["batches"])
        except (OSError, ValueError, KeyError):
            done = 0
        print(f"rollup: resuming after batch {done}", file=sys.stderr)

    for k in range(done, batches):
        # kills and preempts land here: between cycles, never mid-append
        resilience.boundary("item")
        data = "".join(ln + "\n" for ln in batch_lines(k))
        with open(live, "a") as fh:
            fh.write(data)
        rollup.rotate_live(run, rotate_bytes)
        atomic_text(progress_path, _json.dumps({"batches": k + 1}))
        # one EIO is absorbed by a single retry against the idempotent
        # ledger; a persistent burst propagates as the typed exit 74
        try:
            rollup.compact(run, bucket_secs=bucket_secs)
        except OSError:
            rollup.compact(run, bucket_secs=bucket_secs)

    # drain the tail, then normalise the cursors to the empty live stream
    rollup.compact(run, bucket_secs=bucket_secs, force_rotate=True)
    state, _ = rollup.ingest(run, bucket_secs=bucket_secs, persist=True)

    art = out / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    atomic_text(art / "rollup_state.json", _json.dumps(state, indent=2, sort_keys=True))
    comp = rollup.load_compact(run) or {}
    atomic_text(art / "rollup_compact.json", _json.dumps(comp, indent=2, sort_keys=True))
    pinned_digests = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                      for p in rollup.pinned_files(run)}
    atomic_text(art / "pinned_digests.json",
                _json.dumps(pinned_digests, indent=2, sort_keys=True))
    return {"items": rollup.n_records(state), "expected_items": batches * per_batch,
            "chunk_cycles": len((comp.get("chunks") or {})),
            "disk_bytes": rollup.disk_footprint(run)}


def run_pipeline(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The actor fabric end to end (spawned members over the spool queue,
    each on ``device``).  Slow tier; the artifact digest manifest is the
    fabric's determinism contract."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.orchestrate.pipeline import PipelinePlan, SourceSpec, run_pipeline
    from hfrep_tpu_torch.utils.checkpoint import atomic_text

    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=6, batch_size=16, patience=2, seed=0,
                   chunk_epochs=3)
    plan = PipelinePlan(
        out_dir=str(out / "scratch" / "pipe"),
        sources=[SourceSpec(name="s0", mode="fixture", params={"rows": 32, "feats": 4})],
        blocks=2, consumers=1, capacity=1, ae_cfg=cfg, latent_dims=[1, 2],
        consume_mode="direct", stream_seed=10 + fixture_seed, device=device,
        drain_timeout=60.0, timeout=180.0)
    doc = run_pipeline(plan, resume=resume)
    digests = {name: src["items"] for name, src in doc["summary"]["sources"].items()}
    art = out / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    atomic_text(art / "pipeline_digests.json", json.dumps(digests, indent=2, sort_keys=True))
    n_items = sum(len(v) for v in digests.values())
    return {"items": n_items, "expected_items": plan.blocks,
            "restarts": int(doc["stats"]["restarts"])}


def run_planted(out: Path, fixture_seed: int, resume: bool, device: str = "cuda") -> dict:
    """The engine's canary: a drive with a deliberate silent-drop bug.

    It writes its one artifact with a plain non-atomic write and swallows
    an injected EIO at the publication site, so ``io_fail@result_save=1``
    makes the artifact vanish while the run still exits 0.  The search
    must catch the digest mismatch against the reference and the shrinker
    must reduce any schedule holding that directive to it alone."""
    import hashlib

    from hfrep_tpu_torch import resilience

    payload = hashlib.sha256(f"planted:{fixture_seed}".encode()).hexdigest()
    with resilience.graceful_drain():
        for _ in range(3):
            resilience.boundary("item")
        art = out / "artifacts" / "planted"
        art.mkdir(parents=True, exist_ok=True)
        try:
            resilience.io_point("result_save")
            (art / "result.json").write_text(json.dumps({"payload": payload}))
        except OSError:
            pass    # the planted bug: a swallowed publish EIO = silent drop
    return {"items": 3}
