"""``python -m hfrep_tpu_torch.resilience selftest``: the kill→resume gate
(``hfrep_tpu/resilience/selftest.py``).

Drives real training through the failure modes the package exists for,
at the JAX package's fixture shapes, on one device (``--device``, the
card by default), and asserts the recovery contracts hold bit for bit:

1. **Checkpoint cycle** — atomic save (embedded checksummed
   ``meta.json``), verified restore, injected *corrupt* and *torn*
   checkpoints detected (:class:`~hfrep_tpu_torch.utils.checkpoint.
   CheckpointCorrupt`) and ``restore_latest_good`` falling back to the
   previous good one.  (The JAX package also round-trips its msgpack
   format here; the port has one payload format, which is torn instead.)
2. **Kill→resume, 21-lane sweep** — a real SIGTERM (``sigterm@chunk=2``)
   lands mid-sweep; the drain turns it into a chunk-boundary
   :class:`~hfrep_tpu_torch.resilience.Preempted` with state
   snapshotted; a re-run resumes from the last chunk and must equal an
   uninterrupted run bit for bit (params, loss traces, stop epochs).
3. **Kill→resume, multi-dataset sweep** — the same contract for the
   padded (D, L) grid, through the signal-free ``preempt`` injection.
4. **Ensemble: SIGKILL one actor of a running fabric** — a real
   multi-process pipeline (two generator actors into an AE sweep
   consumer over the bounded spool queue, every member on the device);
   ``kill@actor`` makes the supervisor SIGKILL a generator mid-stream,
   and the run must still complete with every artifact bit-identical to
   the reference computed in this process from the same pure functions;
   every item's trace reconstructs across the restart.
5. **Ensemble: coordinated pod drain → resume** — ``preempt@actor=2``
   triggers the supervisor's drain barrier; the resumed pipeline
   completes bit-identical to the reference.
6. **Serving chaos** — a real :class:`~hfrep_tpu_torch.serve.
   ReplicationServer` over a trained AE head under ``kill@serve_worker``,
   ``io_fail@serve_result``, a ``stall@batcher`` deadline storm and an
   overload burst: every submitted request reaches exactly one terminal
   outcome; sheds and deadline misses are typed; the circuit breaker
   trips, serves stale last-good answers, and closes after cooldown; a
   real SIGTERM drains the server.

Every scenario runs under its own watchdog
(:func:`hfrep_tpu_torch.resilience.watchdog`).  Exit 0 with one JSON line
on stdout; a violated contract raises and exits 1.
"""

from __future__ import annotations

import contextlib
import os
import signal
import tempfile
import time
from pathlib import Path

import numpy as np

from hfrep_tpu_torch.resilience import WatchdogTimeout, watchdog

#: the scenario watchdog is the shared :func:`hfrep_tpu_torch.resilience.watchdog`
ScenarioTimeout = WatchdogTimeout


@contextlib.contextmanager
def _scenario_timeout(name: str, secs: float):
    with watchdog(secs, f"scenario {name}"):
        yield


def _fixture_panel(rows: int = 90, feats: int = 6):
    # seed 11 is this selftest's pinned stream (the JAX package's)
    from hfrep_tpu_torch.utils.fixture_data import scaled_panel
    return scaled_panel(rows, feats, seed=11)


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    import torch
    a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and bool(torch.equal(torch.isnan(a), torch.isnan(b))
                                       and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _assert_results_identical(a, b, what: str) -> None:
    assert sorted(a.params) == sorted(b.params) and all(
        _same(a.params[k], b.params[k]) for k in a.params), \
        f"{what}: resumed params differ from the uninterrupted run"
    for field in ("stop_epoch", "train_loss", "val_loss"):
        assert _same(getattr(a, field), getattr(b, field)), \
            f"{what}: resumed {field} differs from the uninterrupted run"


def _check_checkpoint_cycle(td: str) -> dict:
    import torch

    from hfrep_tpu_torch.resilience import faults
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    d = os.path.join(td, "ckpts")
    t1 = {"w": torch.arange(8.0), "step": 3}
    t2 = {"w": torch.arange(8.0) * 2.0, "step": 6}
    ckpt.save(os.path.join(d, "ckpt_1"), t1, metadata={"epoch": 1})
    p2 = ckpt.save(os.path.join(d, "ckpt_2"), t2, metadata={"epoch": 2})
    meta = ckpt.read_meta(p2)
    assert meta and "checksum" in meta and "epoch" in meta, \
        "meta.json (metadata + checksum) must live inside the checkpoint"

    restored = ckpt.restore(p2)
    assert torch.equal(restored["w"], torch.arange(8.0) * 2.0)

    # corrupt the newest payload: detected, and the fallback lands on ckpt_1
    faults.corrupt_file(faults._payload_file(Path(p2)))
    try:
        ckpt.restore(p2)
        raise AssertionError("corrupted checkpoint restored without error")
    except ckpt.CheckpointCorrupt:
        pass
    good, path = ckpt.restore_latest_good(d)
    assert path.endswith("ckpt_1") and torch.equal(good["w"], torch.arange(8.0)), \
        "fallback must restore the previous good checkpoint"

    # a torn payload: detected, and the fallback skips it
    p3 = ckpt.save(os.path.join(d, "ckpt_3"), t1)
    assert torch.equal(ckpt.restore(p3)["w"], torch.arange(8.0))
    faults.tear_file(Path(p3) / ckpt.PAYLOAD_NAME)
    try:
        ckpt.restore(p3)
        raise AssertionError("torn checkpoint restored without error")
    except ckpt.CheckpointCorrupt:
        pass
    good, path = ckpt.restore_latest_good(d)
    assert path.endswith("ckpt_1"), "fallback must skip the torn checkpoint"
    return {"checkpoint_cycle": "ok"}


def _kill_resume(td: str, name: str, spec: str, run) -> dict:
    """``run(resume_dir)`` once uninterrupted (resume_dir=None), once
    under the fault ``spec`` (must raise Preempted), once resuming: the
    resumed results must be bit-identical."""
    import hfrep_tpu_torch.resilience as res

    base, base_stats = run(None)
    rd = os.path.join(td, name)
    res.install_plan(res.FaultPlan.parse(spec))
    try:
        run(rd)
        raise AssertionError(f"{name}: injected fault {spec!r} did not preempt the sweep")
    except res.Preempted as e:
        assert e.snapshot, f"{name}: drain must report the persisted snapshot"
    finally:
        res.clear_plan()
    resumed, stats = run(rd)
    _assert_results_identical(base, resumed, name)
    assert not os.path.exists(os.path.join(rd, "chunk_snapshot")), \
        f"{name}: snapshot must be cleared after a completed drive"
    return {name: "ok", f"{name}_chunks": int(stats.chunks_dispatched),
            f"{name}_lanes": int(stats.lanes)}


def _ensemble_plan(out_dir: str, device: str):
    """The tiny fixture pipeline of the ensemble scenarios: 2 generator
    actors × 2 blocks, 1 consumer, capacity-1 backpressure (so a producer
    is reliably alive or blocked when the injected kill lands)."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.orchestrate.pipeline import PipelinePlan, SourceSpec

    rows, feats = 32, 4
    cfg = AEConfig(n_factors=feats, latent_dim=2, epochs=6, batch_size=16, patience=2,
                   seed=0, chunk_epochs=3)
    sources = [SourceSpec(name=f"s{i}", mode="fixture", params={"rows": rows, "feats": feats})
               for i in range(2)]
    return PipelinePlan(out_dir=out_dir, sources=sources, blocks=2, consumers=1, capacity=1,
                        ae_cfg=cfg, latent_dims=[1, 2], consume_mode="direct",
                        stream_seed=11, device=device, drain_timeout=60.0, timeout=240.0)


def _expected_digests(plan) -> dict:
    """The undisturbed reference, computed in this process with no
    actors: every item is a pure function of (stream_seed, source, seq)
    and every result a pure function of its item, on the plan's device."""
    import hashlib
    import io

    from hfrep_tpu_torch.orchestrate.actors import _fixture_panel as item_panel
    from hfrep_tpu_torch.replication.engine import sweep_item_arrays
    from hfrep_tpu_torch.train.trainer import seed_mix
    from hfrep_tpu_torch.utils import checkpoint as ckpt_mod

    out = {}
    for idx, src in enumerate(plan.sources):
        items = {}
        for seq in range(plan.blocks):
            panel = item_panel(plan.stream_seed, idx, seq, src.params["rows"],
                               src.params["feats"])
            arrays = sweep_item_arrays(seed_mix(plan.ae_cfg.seed, idx, seq), panel,
                                       plan.ae_cfg, plan.latent_dims, device=plan.device)
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            # the aggregate digest the artifact's meta.json embeds (one
            # payload file: sweep.npz)
            items[f"{seq:05d}"] = ckpt_mod.aggregate_digest(
                {"sweep.npz": hashlib.sha256(buf.getvalue()).hexdigest()})
        out[src.name] = items
    return out


def _summary_digests(summary: dict) -> dict:
    return {name: doc["items"] for name, doc in summary["sources"].items()}


def _check_ensemble(td: str, device: str) -> dict:
    import hfrep_tpu_torch.obs as obs_pkg
    import hfrep_tpu_torch.resilience as res
    from hfrep_tpu_torch.orchestrate.pipeline import run_pipeline

    expected = _expected_digests(_ensemble_plan(os.path.join(td, "unused"), device))

    # scenario 4: a real SIGKILL of a generator actor mid-stream; the
    # supervisor restarts it from its sub-block snapshot and the run
    # completes bit-identical, under a real obs session so the trace
    # reconstruction across processes and the restart is asserted too
    kill_plan = _ensemble_plan(os.path.join(td, "ens_kill"), device)
    obs_dir = os.path.join(td, "obs_ens_kill")
    res.install_plan(res.FaultPlan.parse("kill@actor=1"))
    try:
        with obs_pkg.session(obs_dir, command="selftest-ensemble"):
            out = run_pipeline(kill_plan)
    finally:
        res.clear_plan()
    assert out["stats"]["restarts"] >= 1, \
        "ensemble kill: the SIGKILL did not land on a live member"
    assert _summary_digests(out["summary"]) == expected, \
        "ensemble kill: artifacts differ from the undisturbed reference"
    _check_trace_continuity(kill_plan, obs_dir)

    # scenario 5: a pod-wide drain at the 2nd observed item → the barrier
    # (every member checkpoints at its item boundary) → the resume
    # completes bit-identical
    drain_out = os.path.join(td, "ens_drain")
    res.install_plan(res.FaultPlan.parse("preempt@actor=2"))
    try:
        run_pipeline(_ensemble_plan(drain_out, device))
        raise AssertionError("ensemble drain: injected pod drain did not preempt the pipeline")
    except res.Preempted:
        pass
    finally:
        res.clear_plan()
    resumed = run_pipeline(_ensemble_plan(drain_out, device), resume=True)
    assert _summary_digests(resumed["summary"]) == expected, \
        "ensemble drain: resumed artifacts differ from the reference"
    return {"ensemble_kill": "ok",
            "ensemble_kill_restarts": int(out["stats"]["restarts"]),
            "ensemble_kill_traces": "ok",
            "ensemble_drain": "ok"}


def _check_trace_continuity(plan, obs_dir: str) -> None:
    """Every pipeline item's trace reconstructs end to end (queue_put →
    ... → result_publish) across the producer's and the consumer's
    processes, and spans the restart: the killed incarnation's rotated
    stream contributes the pre-kill hop under the same trace ID."""
    from hfrep_tpu_torch.obs.report import trace_index
    from hfrep_tpu_torch.orchestrate.queue import item_trace_id

    tids = [item_trace_id(plan.stream_seed, src.name, seq)
            for src in plan.sources for seq in range(plan.blocks)]
    index = trace_index([obs_dir], tids)
    all_records = []
    for src in plan.sources:
        for seq in range(plan.blocks):
            tid = item_trace_id(plan.stream_seed, src.name, seq)
            recs = index.get(tid, [])
            names = {r.get("name") for r in recs}
            assert "queue_put" in names, f"trace {tid}: producer hop (queue_put) missing"
            assert "result_publish" in names, \
                f"trace {tid}: terminal hop (result_publish) missing"
            assert len({r["_dir"] for r in recs}) >= 2, \
                f"trace {tid}: events do not span producer + consumer processes ({names})"
            all_records.extend(recs)
    assert any(r["_rotated"] and r.get("name") == "queue_put" for r in all_records), \
        "no pre-kill (rotated-stream) queue_put found: the reconstruction does not " \
        "span the restart"


def _serving_fixture_server(device: str, workers: int = 1):
    """A real server over a really-trained (tiny) AE replication head."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication.engine import train_autoencoder_chunked
    from hfrep_tpu_torch.serve import AEServeModel, ReplicationServer, ServeConfig

    cfg = AEConfig(n_factors=6, latent_dim=3, epochs=8, batch_size=16, patience=2, seed=0,
                   chunk_epochs=4)
    res, _ = train_autoencoder_chunked(3, _fixture_panel(40, 6), cfg, device=device)
    model = AEServeModel.create(cfg, {k: v.detach().cpu().numpy() for k, v in res.params.items()},
                                device=device)
    scfg = ServeConfig(max_batch=4, batch_window_ms=5.0, request_timeout_ms=3000.0,
                       max_queue=32, workers=workers, row_buckets=(32, 64),
                       breaker_failures=2, breaker_cooldown_s=0.3, compile_storm=64)
    return ReplicationServer(scfg, ae_model=model).start()


def _await_all(futures) -> None:
    from concurrent.futures import wait
    wait(futures, timeout=60)
    undone = [f for f in futures if not f.done()]
    assert not undone, (f"serving: {len(undone)} requests never reached a "
                        "terminal outcome (silent drop / hang)")


def _check_serving(td: str, device: str) -> dict:
    """Scenario 6 runs under a REAL obs session so the flight recorder's
    request tracing is asserted against the same chaos the envelope
    takes: the settle probe threads an explicit trace ID and its
    admit → dispatch → complete path must reconstruct with per-hop
    durations via ``report --trace`` machinery."""
    import hfrep_tpu_torch.obs as obs_pkg

    obs_dir = os.path.join(td, "obs_serve")
    with obs_pkg.session(obs_dir, command="selftest-serving"):
        return _serving_scenario(td, obs_dir, device)


def _serving_scenario(td: str, obs_dir: str, device: str) -> dict:
    import hfrep_tpu_torch.resilience as res
    from hfrep_tpu_torch.resilience import faults
    from hfrep_tpu_torch.serve import Overloaded
    from hfrep_tpu_torch.serve.loadgen import classify, make_panels

    server = _serving_fixture_server(device, workers=1)
    panels = make_panels(5, 6, (16, 28), variants=4)
    try:
        # warm the (batch-bucket, row-bucket) programs outside the fault
        # plan so the chaos phase measures the envelope, not first builds
        for n in (1, 2, 4):
            _await_all([server.replicate(panels[i % len(panels)],
                                         timeout_ms=30000)
                        for i in range(n)])

        # --- chaos: worker killed mid-batch + result-publish EIO + a
        # wedged batcher manufacturing a deadline storm, plus an
        # overload burst past the admission bound — every submitted
        # request must land in exactly one typed terminal outcome
        res.install_plan(res.FaultPlan.parse(
            "kill@serve_worker=2;io_fail@serve_result=5;stall@batcher=3"))
        prev_stall, faults.STALL_SECS = faults.STALL_SECS, 0.3
        try:
            futs = []
            for i in range(40):
                tight = i % 5 == 4
                futs.append(server.replicate(
                    panels[i % len(panels)],
                    timeout_ms=25.0 if tight else 5000.0))
                if i % 8 == 7:
                    time.sleep(0.01)
            # burst: 2x the admission bound at once — the excess must
            # shed typed, immediately
            futs += [server.replicate(panels[0], timeout_ms=5000.0)
                     for _ in range(2 * server.cfg.max_queue)]
            _await_all(futs)
        finally:
            faults.STALL_SECS = prev_stall
            res.clear_plan()
        chaos = classify(futs)
        ledger = server.outcomes.as_dict()
        assert ledger["terminal"] == ledger["submitted"], \
            f"serving chaos: silent drops — ledger {ledger}"
        assert ledger["worker_kills"] >= 1, \
            "serving chaos: the injected worker kill never landed"
        assert ledger["requeues"] >= 1, \
            "serving chaos: the killed batch was not failed over"
        assert ledger["worker_faults"] >= 1, \
            "serving chaos: the injected result EIO produced no typed fault"
        assert ledger["deadline_missed"] >= 1, \
            "serving chaos: the stall produced no deadline miss"
        assert chaos["shed"] >= 1, \
            "serving chaos: the overload burst was not shed"
        assert chaos["results"] >= 1, \
            "serving chaos: nothing was actually served"
        assert chaos["errors"] == 0, \
            f"serving chaos: untyped outcomes: {chaos}"

        # settle: the chaos faults may have left the breaker open — wait
        # out the cooldown and let one clean probe close it, so the
        # breaker phase below observes its own trip, not the chaos one's
        time.sleep(server.cfg.breaker_cooldown_s + 0.1)
        settle = server.replicate(panels[0], timeout_ms=5000.0,
                                  trace_id="st-settle")
        _await_all([settle])
        assert server.breaker.state == "closed", \
            f"breaker did not settle closed: {server.breaker.state}"

        # flight recorder: the settle probe's critical path must
        # reconstruct — admit → (batch-wait) dispatch → complete — with
        # per-hop durations attributed
        from hfrep_tpu_torch.obs import get_obs
        from hfrep_tpu_torch.obs.report import trace_events
        get_obs().flush()
        recs = trace_events([obs_dir], "st-settle")
        names = [r.get("name") for r in recs]
        for hop in ("serve_admit", "serve_dispatch", "serve_complete"):
            assert hop in names, \
                f"serve trace missing hop {hop}: {names}"
        (done,) = [r for r in recs if r.get("name") == "serve_complete"]
        assert done.get("queue_ms") is not None \
            and done.get("exec_ms") is not None, \
            f"serve trace lacks per-hop durations: {done}"

        # --- breaker: every publish fails → consecutive faults trip it
        # OPEN; submits then get last-good DEGRADED answers flagged
        # stale; cooldown + one good probe close it again
        res.install_plan(res.FaultPlan.parse("io_fail@serve_result=1x50"))
        try:
            faulted = 0
            for _ in range(4):
                f = server.replicate(panels[0], timeout_ms=5000.0)
                _await_all([f])
                if f.exception() is not None:
                    faulted += 1
                if server.breaker.state == "open":
                    break
            assert server.breaker.state == "open" and faulted >= 2, \
                (f"serving breaker: {faulted} faults did not trip it "
                 f"(state {server.breaker.state})")
            degraded = server.replicate(panels[1], timeout_ms=5000.0)
            _await_all([degraded])
            out = degraded.result()
            assert out.stale, "breaker-open answer must be flagged stale"
        finally:
            res.clear_plan()
        time.sleep(server.cfg.breaker_cooldown_s + 0.1)
        probe = server.replicate(panels[0], timeout_ms=5000.0)
        _await_all([probe])
        assert probe.exception() is None and not probe.result().stale, \
            "post-cooldown probe must serve fresh"
        assert server.breaker.state == "closed", \
            f"breaker did not close after a good probe: {server.breaker.state}"

        # --- drain: a REAL SIGTERM through graceful_drain stops
        # admission, flushes in-flight work, and preempts at the next
        # boundary (the CLI maps this to exit 75)
        with res.graceful_drain():
            inflight = [server.replicate(panels[i % len(panels)],
                                         timeout_ms=10000.0)
                        for i in range(6)]
            os.kill(os.getpid(), signal.SIGTERM)
            assert res.drain_requested(), \
                "SIGTERM did not set the drain flag"
            doc = server.drain(reason="selftest SIGTERM", timeout=30.0)
            assert doc["flushed"], f"drain did not flush in-flight: {doc}"
            _await_all(inflight)
            for f in inflight:
                err = f.exception()
                assert err is None or isinstance(err, Overloaded) or \
                    getattr(err, "code", "") in ("draining", "deadline"), \
                    f"drain left an untyped outcome: {err!r}"
            late = server.replicate(panels[0])
            _await_all([late])
            assert getattr(late.exception(), "code", None) in (
                "draining", "closed"), \
                "post-drain admission must be a typed rejection"
            try:
                res.boundary("serve_drive")
                raise AssertionError(
                    "drain flag set but boundary did not preempt")
            except res.Preempted:
                pass
        ledger = server.outcomes.as_dict()
        assert ledger["terminal"] == ledger["submitted"], \
            f"serving drain: silent drops — ledger {ledger}"
        return {"serving_chaos": "ok",
                "serving_submitted": ledger["submitted"],
                "serving_sheds": ledger["shed"],
                "serving_deadline_misses": ledger["deadline_missed"],
                "serving_worker_kills": ledger["worker_kills"],
                "serving_breaker_trips": server.breaker.trips,
                "serving_drain": "ok"}
    finally:
        server.stop()


#: per-scenario watchdog budgets (seconds): generous multiples of the
#: measured CPU fixture times, tight enough that a wedge fails loudly
SCENARIO_BUDGETS = {
    "checkpoint_cycle": 60.0,
    "lanes21": 120.0,
    "multi": 120.0,
    "ensemble": 300.0,
    "serving": 120.0,
}


def run_selftest(device: str = "cuda") -> dict:
    import dataclasses

    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.core.device import resolve_device
    from hfrep_tpu_torch.replication.engine import (
        stack_padded,
        sweep_autoencoders_chunked,
        sweep_autoencoders_multi,
    )

    device = str(resolve_device(device))
    xs = _fixture_panel()
    doc: dict = {"device": device}
    with tempfile.TemporaryDirectory(prefix="hfrep_resilience_") as td:
        with _scenario_timeout("checkpoint_cycle", SCENARIO_BUDGETS["checkpoint_cycle"]):
            doc.update(_check_checkpoint_cycle(td))

        # the paper's 21-lane latent sweep, cut to fixture epochs, killed
        # by a real SIGTERM
        cfg = AEConfig(n_factors=6, latent_dim=21, epochs=24, batch_size=16, patience=3,
                       seed=0, chunk_epochs=6)
        dims = list(range(1, 22))
        with _scenario_timeout("lanes21", SCENARIO_BUDGETS["lanes21"]):
            doc.update(_kill_resume(
                td, "lanes21", "sigterm@chunk=2",
                lambda rd: sweep_autoencoders_chunked(0, xs, cfg, dims, device=device,
                                                      resume_dir=rd)))

        # the padded multi-dataset grid (2 datasets × 3 lanes)
        mcfg = dataclasses.replace(cfg, latent_dim=4)
        stack, rows = stack_padded([xs, xs[:70]])
        with _scenario_timeout("multi", SCENARIO_BUDGETS["multi"]):
            doc.update(_kill_resume(
                td, "multi", "preempt@chunk=1",
                lambda rd: sweep_autoencoders_multi(0, stack, rows, mcfg, [1, 2, 3],
                                                    device=device, resume_dir=rd)))

        # the actor fabric: a real SIGKILL of a running member, then a
        # coordinated pod drain and resume, both bit-identical
        with _scenario_timeout("ensemble", SCENARIO_BUDGETS["ensemble"]):
            doc.update(_check_ensemble(td, device))

        # serving: kill/EIO/deadline storm/overload, breaker and degraded
        # answers, SIGTERM drain, no silent drop
        with _scenario_timeout("serving", SCENARIO_BUDGETS["serving"]):
            doc.update(_check_serving(td, device))
    return doc
