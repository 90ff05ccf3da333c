"""Actor worker processes: the code that runs inside a fabric member
(``hfrep_tpu/orchestrate/actors.py``).

Each member is an OS process (``multiprocessing`` spawn context — a
fresh interpreter, the only start method CUDA tolerates) executing
:func:`actor_main` with a role and a picklable payload dict; the
payload's ``device`` is where the member computes, resolved through
:func:`~hfrep_tpu_torch.core.device.resolve_device`, so a member asked
for ``cuda`` on a machine without a card raises:

* **generator** — streams its block of ``(source, seq)`` items into the
  spool queue.  Every item is a pure function of
  ``(stream_seed, source_idx, seq)``, so a restarted member regenerates
  exactly what the killed one would have produced; after every put it
  persists a sub-block :class:`~hfrep_tpu_torch.resilience.snapshot.
  ProgressSnapshot`, so the restart *resumes mid-block*.  Its ``gan``
  mode samples a trained generator through
  :meth:`~hfrep_tpu_torch.train.trainer.GanTrainer.generate_block`
  (``lstm_fwd`` on the card).
* **consumer** — claims items, runs the AE sweep for each, publishes
  the result artifact atomically under ``results/r_<source>_<seq>``,
  then acks.  Results are keyed by ``(source, seq)`` and are a pure
  function of the item, so reprocessing after a crash (or a duplicate
  delivery) skips work it finds already published.

Drain contract: SIGTERM (forwarded member-wise by the supervisor's
barrier) sets the drain flag through the member's own
:func:`~hfrep_tpu_torch.resilience.graceful_drain` handler — never in
the middle of a CUDA call; the loops honour it at their **item
boundary**, then cross the ``drain_barrier`` fault site and exit
:data:`EXIT_DRAINED` (75).  A consumer that proves the stream
complete-with-gaps exits :data:`EXIT_GAP`.

The hand kernels' launch counts are per process: each member with a
telemetry dir writes its counts into its own stream as
``launches/<kernel>`` counters when it exits, where ``chip_smoke.py``
reads them.
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

EXIT_DRAINED = 75        # EX_TEMPFAIL: drained at a safe boundary, resumable
EXIT_GAP = 3             # stream complete but items are missing — fatal

RESULT_PREFIX = "r_"


def result_name(source: str, seq: int) -> str:
    return f"{RESULT_PREFIX}{source}_{seq:05d}"


class QueueGap(RuntimeError):
    """Every source hit eof and the spool is empty, yet results for some
    ``(source, seq)`` pairs are missing."""


# --------------------------------------------------------------- payloads
def _fixture_panel(stream_seed: int, source_idx: int, seq: int,
                   rows: int, feats: int, rank: int = 3) -> np.ndarray:
    """Deterministic low-rank scaled panel for the fixture source (the
    stand-in for GAN synthesis), the JAX package's bit for bit."""
    from hfrep_tpu_torch.utils.fixture_data import keyed_scaled_panel
    return keyed_scaled_panel(stream_seed, source_idx, seq, rows, feats, rank=rank)


def _make_generator(payload: dict):
    """``fn(seq) -> {name: array}`` for the payload's source mode."""
    mode = payload["mode"]
    stream_seed = int(payload.get("stream_seed", 0))
    source_idx = int(payload["source_idx"])
    device = payload["device"]
    if mode == "fixture":
        rows, feats = int(payload["rows"]), int(payload["feats"])
        # models the latency of real GAN sampling: wall clock only
        gen_delay = float(payload.get("gen_delay", 0.0))

        def gen(seq: int) -> Dict[str, np.ndarray]:
            if gen_delay > 0.0:
                time.sleep(gen_delay)
            return {"panel": _fixture_panel(stream_seed, source_idx, seq, rows, feats)}
        return gen
    if mode == "scenario":
        # each source streams ONE regime's conditional blocks
        from hfrep_tpu_torch.scenario.conditional import scenario_item_panel

        rows, feats = int(payload["rows"]), int(payload["feats"])
        regime = int(payload["regime"])
        n_regimes = int(payload.get("n_regimes", 3))
        window = int(payload.get("scenario_window", 12))

        def gen(seq: int) -> Dict[str, np.ndarray]:
            return {"panel": scenario_item_panel(
                stream_seed, source_idx, seq, regime=regime, n_regimes=n_regimes,
                rows=rows, feats=feats, window=window, device=device)}
        return gen
    if mode == "gan":
        # built once a process: a restart pays one rebuild
        from hfrep_tpu_torch.experiments.cli import _make_trainer
        trainer, _ = _make_trainer(payload["preset"], payload["cleaned_dir"], quiet=True,
                                   device=device)
        trainer.restore_checkpoint(payload["checkpoint"])
        n_windows = int(payload["n_gen_windows"])

        def gen(seq: int) -> Dict[str, np.ndarray]:
            cube = trainer.generate_block(seq, n_windows,
                                          stream_seed=stream_seed + 1009 * source_idx)
            return {"cube": cube.cpu().numpy()}
        return gen
    raise ValueError(f"unknown generator mode {mode!r}")


def _make_consumer(payload: dict):
    """``fn(source_idx, seq, arrays, tmp_dir) -> None`` writing the item's
    result artifact into ``tmp_dir`` (published atomically around it)."""
    from hfrep_tpu_torch.replication import engine as eng
    from hfrep_tpu_torch.train.trainer import seed_mix

    cfg = payload["ae_cfg"]
    latent_dims = list(payload["latent_dims"])
    mode = payload["consume_mode"]
    device = payload["device"]
    if mode == "direct":

        def consume(source_idx: int, seq: int, arrays, tmp_dir: Path) -> None:
            out = eng.sweep_item_arrays(seed_mix(cfg.seed, source_idx, seq),
                                        arrays["panel"], cfg, latent_dims, device=device)
            np.savez(tmp_dir / "sweep.npz", **out)
        return consume
    if mode == "augment":
        import torch

        from hfrep_tpu_torch.core.data import load_panel
        from hfrep_tpu_torch.experiments.augment import augment_training_set, split_cube
        from hfrep_tpu_torch.experiments.sweep import run_sweep

        panel = load_panel(payload["cleaned_dir"], device=device)
        x_train, x_test, y_train, y_test = panel.train_test_split()
        rf_test = panel.rf[x_train.shape[0]:]

        def consume(source_idx: int, seq: int, arrays, tmp_dir: Path) -> None:
            aug = split_cube(torch.from_numpy(arrays["cube"]).to(panel.factors.device),
                             n_factors=x_train.shape[1], n_hf=y_train.shape[1])
            x_aug, y_aug = augment_training_set(x_train, y_train, aug)
            res = run_sweep(x_aug, y_aug, x_test, y_test, rf_test, panel.factors, cfg,
                            latent_dims, strategy_names=panel.hf_names, device=device)
            res.save(str(tmp_dir))
        return consume
    raise ValueError(f"unknown consume mode {mode!r}")


# ------------------------------------------------------------- the loops
def _generator_loop(name: str, payload: dict) -> None:
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.orchestrate.queue import SpoolQueue, item_trace_id
    from hfrep_tpu_torch.resilience.snapshot import ProgressSnapshot

    q = SpoolQueue(payload["queue_dir"], capacity=int(payload["capacity"]))
    source, blocks = payload["source"], int(payload["blocks"])
    stream_seed = int(payload.get("stream_seed", 0))
    snap = ProgressSnapshot(
        payload["snapshot_dir"],
        fingerprint={"source": source, "blocks": blocks, "mode": payload["mode"],
                     "stream_seed": stream_seed},
        name=f"gen_{source}")
    state = snap.load()
    start = int(state.get("next", 0)) if state is not None else 0
    gen = _make_generator(payload)
    for seq in range(start, blocks):
        # the trace ID is a pure function of the item coordinate: a
        # restarted member's replayed item carries the SAME id
        extra = {"source_idx": int(payload["source_idx"]),
                 "trace": item_trace_id(stream_seed, source, seq)}
        q.put(source, seq, gen(seq), extra_meta=extra)
        snap.save({"next": seq + 1})
        # the sub-block boundary: injected faults fire here, and a
        # requested drain raises with the snapshot already on disk
        resilience.boundary("item")
    q.put_eof(source, blocks)
    snap.save({"next": blocks, "eof": True})


def _missing_results(eofs: Dict[str, int], results_dir: Path) -> List[str]:
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    return [result_name(source, seq)
            for source, count in sorted(eofs.items()) for seq in range(count)
            if not (results_dir / result_name(source, seq) / ckpt.META_NAME).exists()]


def _consumer_loop(name: str, payload: dict) -> None:
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.obs import get_obs
    from hfrep_tpu_torch.orchestrate.queue import SpoolQueue
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    q = SpoolQueue(payload["queue_dir"], capacity=int(payload["capacity"]))
    results_dir = Path(payload["results_dir"])
    results_dir.mkdir(parents=True, exist_ok=True)
    sources = list(payload["sources"])
    consume = _make_consumer(payload)
    while True:
        item = q.claim(name)
        if item is None:
            if q.drained(sources):
                missing = _missing_results(q.eof_counts(), results_dir)
                if missing:
                    raise QueueGap(
                        f"stream complete but {len(missing)} results missing: "
                        f"{', '.join(missing[:5])}" + ("..." if len(missing) > 5 else ""))
                return
            # the idle poll is also a safe boundary — nothing is claimed
            resilience.boundary("idle")
            time.sleep(q.poll)
            continue
        res_dir = results_dir / result_name(item.source, item.seq)
        trace = item.meta.get("trace")
        # skip only a result that VERIFIES: a duplicate delivery whose
        # published artifact rotted in the meantime is recomputed
        published = (res_dir / ckpt.META_NAME).exists()
        if published:
            try:
                ckpt.verify(res_dir)
            except ckpt.CheckpointCorrupt:
                shutil.rmtree(res_dir, ignore_errors=True)
                published = False
        if not published:
            arrays = item.arrays()
            source_idx = int(item.meta.get("source_idx", 0))
            obs = get_obs()
            with obs.span("item_sweep", trace=trace, source=item.source, seq=item.seq):
                ckpt.write_atomic(
                    res_dir, lambda tmp: consume(source_idx, item.seq, arrays, tmp),
                    metadata={"source": item.source, "seq": item.seq, "trace": trace},
                    io_site="result_save", fault_site="result")
            obs.event("result_publish", trace=trace, source=item.source, seq=item.seq)
            obs.flush()      # item-granular durability (see queue)
        q.ack(item)
        # the item boundary: result published + claim acked = the common
        # checkpoint boundary every member drains at
        resilience.boundary("item")


def _emit_launch_counts() -> None:
    """The hand kernels' launches of this process (the wrappers' counts and
    the weight sums as their C launcher counts them), as counters in the
    member's own stream; nothing without a telemetry dir."""
    from hfrep_tpu_torch.obs import get_obs
    from hfrep_tpu_torch.ops import cuda_lstm

    obs = get_obs()
    if not obs.enabled:
        return
    counts = dict(cuda_lstm.launch_counts())
    counts.update({f"weight_sum ({k})": v
                   for k, v in cuda_lstm.weight_sum_launches().items()})
    for kernel, n in sorted(counts.items()):
        if n:
            obs.counter(f"launches/{kernel}").inc(int(n), kernel=kernel)
    obs.flush()


# ------------------------------------------------------------- bootstrap
def actor_main(name: str, role: str, payload: dict) -> None:
    """Entry point of a spawned member process: resolves the member's
    device (raising when ``cuda`` is asked for and no card is present),
    opens a per-actor obs session when the supervisor handed one down,
    and maps the drain contract onto exit codes."""
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.core.device import resolve_device
    from hfrep_tpu_torch.resilience.drive import DRIVE_REGISTRY, run_drive

    resolve_device(payload["device"])

    def work() -> int:
        try:
            if role == "generator":
                _generator_loop(name, payload)
            elif role == "consumer":
                _consumer_loop(name, payload)
            else:
                raise ValueError(f"unknown actor role {role!r}")
        except QueueGap as e:
            print(f"{name}: {e}", file=sys.stderr)
            return EXIT_GAP
        finally:
            _emit_launch_counts()
        return 0

    def on_preempt(e) -> None:
        from hfrep_tpu_torch.obs import get_obs
        get_obs().event("actor_drained", actor=name)
        # the barrier crossing: an injected stall@drain_barrier hangs
        # HERE, driving the supervisor's timeout/escalation path
        resilience.tick("drain_barrier")

    # run_drive maps Preempted to EXIT_DRAINED (75) for the supervisor;
    # the session opens inside graceful_drain, so a SIGTERM during the
    # member's bring-up drains instead of killing it raw
    sys.exit(run_drive(DRIVE_REGISTRY["pipeline"], work,
                       obs_dir=payload.get("obs_dir"),
                       session_meta={"command": f"actor:{role}", "actor": name},
                       drain_hint="", watchdog_name=f"actor {name}",
                       on_preempt=on_preempt))
