"""The port's actor fabric (``hfrep_tpu_torch/orchestrate``) against the JAX
package's: the spool queue's semantics (JAX's ``tests/test_orchestrate.py``
cases on the port) and its on-disk format (each package claims the
other's items), the supervisor's restart/abort/drain logic, the fixture
items (bitwise JAX's), the consumers' ``sweep_item_arrays`` (on JAX's own
draws, at the engine bars), and the pipeline end to end on the CPU:
undisturbed, with a member SIGKILLed, and drained then resumed, all three
``pipeline.json`` byte-equal.  Members are spawned processes on
``device="cpu"``."""

from __future__ import annotations

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hfrep_tpu.resilience as jres
import hfrep_tpu_torch.resilience as res
from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.orchestrate import actors as jactors
from hfrep_tpu.orchestrate import queue as jqueue
from hfrep_tpu.replication import engine as jengine
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.orchestrate import (ActorSpec, OrchestrationError, PipelinePlan,
                                         PipelineStateError, SourceSpec, SpoolQueue,
                                         Supervisor, run_pipeline)
from hfrep_tpu_torch.orchestrate import actors
from hfrep_tpu_torch.orchestrate import pipeline as pl
from hfrep_tpu_torch.orchestrate import queue as q_mod
from hfrep_tpu_torch.orchestrate.actors import EXIT_GAP, _missing_results, result_name
from hfrep_tpu_torch.replication import engine
from hfrep_tpu_torch.resilience import FaultPlan, Preempted, faults
from hfrep_tpu_torch.resilience.snapshot import ProgressSnapshot
from hfrep_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _pristine_fault_state(monkeypatch):
    for mod in (res, jres):
        mod.clear_plan()
        monkeypatch.setattr(mod, "_env_consumed", False)
    monkeypatch.delenv(res.ENV_FAULTS, raising=False)
    # spawned CPU members: one thread each, the same in every run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    for mod in (res, jres):
        mod.clear_plan()
        mod._DRAIN.requested = False
        mod._DRAIN.reason = None


def _arrays(seed: int = 0):
    g = np.random.default_rng(seed)
    return {"panel": g.normal(size=(8, 3)).astype(np.float32)}


# --------------------------------------------------------------- queue
class TestSpoolQueue:
    """JAX's spool-queue cases, on the port."""

    def test_put_claim_ack_roundtrip(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        assert q.put("s0", 0, _arrays(), extra_meta={"source_idx": 0})
        assert q.depth() == 1
        item = q.claim("consA")
        assert (item.source, item.seq) == ("s0", 0)
        assert item.meta["source_idx"] == 0
        assert item.meta["checksum"]["files"]["payload.npz"]
        np.testing.assert_array_equal(item.arrays()["panel"], _arrays()["panel"])
        q.ack(item)
        assert q.depth() == 0 and not q.claimed_names()

    def test_duplicate_put_is_skipped(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        assert q.put("s0", 1, _arrays())
        assert not q.put("s0", 1, _arrays())        # still ready
        item = q.claim("c")
        assert not q.put("s0", 1, _arrays())        # claimed, still spooled
        q.ack(item)
        assert q.put("s0", 1, _arrays())            # acked: re-offer allowed

    def test_claim_order_and_contention(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=8)
        for seq in (1, 0, 2):
            q.put("s0", seq, _arrays(seq))
        assert (q.claim("A").seq, q.claim("B").seq) == (0, 1)

    def test_corrupt_item_discarded_on_claim(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        q.put("s0", 0, _arrays())
        faults.corrupt_file(tmp_path / q_mod.READY / q_mod.item_name("s0", 0) / "payload.npz")
        assert q.claim("c") is None and q.depth() == 0

    def test_requeue_orphaned_claims(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        q.put("s0", 0, _arrays())
        q.put("s0", 1, _arrays(1))
        q.claim("dead")
        q.claim("alive")
        assert q.requeue_claims("dead") == [q_mod.item_name("s0", 0)]
        assert q.depth() == 1
        assert q.requeue_claims(None) == [q_mod.item_name("s0", 1)]
        assert q.depth() == 2

    def test_blocked_put_aborts_on_drain(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=1, poll=0.001)
        q.put("s0", 0, _arrays())
        res.request_drain("test")
        with pytest.raises(Preempted) as ei:
            q.put("s0", 1, _arrays(1))
        assert ei.value.site == "queue_put"

    def test_eof_and_drained(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        q.put("s0", 0, _arrays())
        q.put_eof("s0", 1)
        q.put_eof("s1", 0)
        assert q.eof_counts() == {"s0": 1, "s1": 0}
        assert not q.drained(["s0", "s1"])
        item = q.claim("c")
        assert not q.drained(["s0", "s1"])
        q.ack(item)
        assert q.drained(["s0", "s1"]) and not q.drained(["s0", "s1", "s2"])

    def test_gap_detection(self, tmp_path):
        results = tmp_path / "results"
        (results / result_name("s0", 0)).mkdir(parents=True)
        (results / result_name("s0", 0) / ckpt.META_NAME).write_text("{}")
        assert _missing_results({"s0": 2, "s1": 1}, results) == [
            result_name("s0", 1), result_name("s1", 0)]

    def test_injected_queue_io_faults_bite(self, tmp_path):
        q = SpoolQueue(tmp_path, capacity=4)
        res.install_plan(FaultPlan.parse("io_fail@queue_get=1"))
        with pytest.raises(OSError):
            q.claim("c")
        res.install_plan(FaultPlan.parse("io_fail@queue_put=1"))
        assert q.put("s0", 0, _arrays())           # one EIO is retried

    def test_the_put_hop_is_on_disk_before_the_item_is_visible(self, tmp_path, monkeypatch):
        """A producer SIGKILLed the moment its item shows in ready/ (the
        supervisor's ``kill@actor``) has already recorded its queue_put
        hop. The reference records it after publication, a window such a
        kill can land in, and its trace then misses the pre-kill hop."""
        import hfrep_tpu_torch.obs as obs_pkg
        from hfrep_tpu_torch.obs.report import trace_index

        q = SpoolQueue(tmp_path / "q", capacity=4)
        run = tmp_path / "obs"
        on_disk = []
        publish = q_mod.ckpt.write_atomic

        def write_atomic(path, *args, **kwargs):
            on_disk.append([r.get("name") for r in trace_index([run], ["t0"])["t0"]])
            return publish(path, *args, **kwargs)

        monkeypatch.setattr(q_mod.ckpt, "write_atomic", write_atomic)
        with obs_pkg.session(run, command="test"):
            assert q.put("s0", 0, _arrays(), extra_meta={"trace": "t0"})
        assert on_disk == [["queue_put"]] and q.depth() == 1

    def test_item_names_and_trace_ids_are_jax_s(self, tmp_path):
        for source, seq in (("a_b", 7), ("g0", 0), ("f12", 99999)):
            assert q_mod.item_name(source, seq) == jqueue.item_name(source, seq)
            assert q_mod.item_trace_id(5, source, seq) == jqueue.item_trace_id(5, source, seq)
            assert q_mod._parse_item_name(q_mod.item_name(source, seq)) == (source, seq)
            assert actors.result_name(source, seq) == jactors.result_name(source, seq)
        assert q_mod._parse_item_name("garbage") is None
        q = SpoolQueue(tmp_path, capacity=4)
        (q.ready / "not_an_item").mkdir()
        assert q.depth() == 0 and q.claim("c") is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_claims_the_other_s_items(tmp_path, writer):
    mine, theirs = SpoolQueue(tmp_path, capacity=4), jqueue.SpoolQueue(tmp_path, capacity=4)
    put, claim = (mine, theirs) if writer == "port" else (theirs, mine)
    assert put.put("s0", 3, _arrays(3), extra_meta={"source_idx": 1, "trace": "t0-s0-00003"})
    put.put_eof("s0", 4)
    item = claim.claim("c0")
    assert (item.source, item.seq) == ("s0", 3) and item.meta["trace"] == "t0-s0-00003"
    np.testing.assert_array_equal(item.arrays()["panel"], _arrays(3)["panel"])
    assert claim.eof_counts() == {"s0": 4}
    claim.ack(item)
    assert put.depth() == 0 and not put.claimed_names()


# ------------------------------------------------ supervisor (spawn-free)
def _dummy_specs(n_consumers: int = 1):
    return [ActorSpec(name="gen_s0", role="generator", payload={"source": "s0"})] + [
        ActorSpec(name=f"cons{c}", role="consumer", payload={}) for c in range(n_consumers)]


def _fake_proc(exitcode):
    return types.SimpleNamespace(is_alive=lambda: False, exitcode=exitcode, pid=4242,
                                 kill=lambda: None, join=lambda timeout=None: None)


class TestSupervisorLogic:
    """JAX's spawn-free supervisor cases, on the port, and the port's
    member-drained rule."""

    def _sup(self, tmp_path, **kw):
        kw.setdefault("backoff_rng", lambda: 1.0)
        kw.setdefault("backoff_base", 30.0)
        return Supervisor(_dummy_specs(), SpoolQueue(tmp_path / "q"), **kw)

    def test_crash_schedules_jittered_restart_and_requeues(self, tmp_path):
        sup = self._sup(tmp_path)
        sup.queue.put("s0", 0, _arrays())
        sup.queue.claim("cons0")
        m = sup._members["cons0"]
        m.proc = _fake_proc(-9)
        sup._poll_members()
        assert m.restarts == 1 and sup.total_restarts == 1 and m.restart_at is not None
        assert sup.queue.depth() == 1

    def test_restart_budget_exhaustion_raises(self, tmp_path):
        sup = self._sup(tmp_path)
        m = sup._members["gen_s0"]
        m.spec.max_restarts = 2
        for _ in range(2):
            m.proc = _fake_proc(1)
            sup._poll_members()
            m.restart_at = None
        m.proc = _fake_proc(1)
        with pytest.raises(OrchestrationError, match="restart budget"):
            sup._poll_members()

    def test_gap_exit_aborts_the_run(self, tmp_path):
        sup = self._sup(tmp_path)
        sup._members["cons0"].proc = _fake_proc(EXIT_GAP)
        with pytest.raises(OrchestrationError, match="gap"):
            sup._poll_members()

    def test_clean_and_drained_exits_mark_members(self, tmp_path):
        sup = self._sup(tmp_path)
        sup._members["gen_s0"].proc = _fake_proc(0)
        sup._members["cons0"].proc = _fake_proc(75)
        sup._poll_members(draining=True)
        assert sup._members["gen_s0"].done and sup._members["cons0"].drained
        assert not res.drain_requested()

    def test_a_member_drained_alone_drains_the_pod(self, tmp_path):
        sup = self._sup(tmp_path)
        sup._members["gen_s0"].proc = _fake_proc(75)
        sup._poll_members()
        assert sup._members["gen_s0"].drained and res.drain_requested()

    def test_duplicate_actor_names_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="duplicate"):
            Supervisor([ActorSpec("a", "consumer", {}), ActorSpec("a", "generator", {})],
                       SpoolQueue(tmp_path / "q"))

    def test_kill_directive_fires_on_observed_item(self, tmp_path):
        res.install_plan(FaultPlan.parse("kill@actor=2"))
        sup = self._sup(tmp_path)
        killed = []
        sup._members["gen_s0"].proc = types.SimpleNamespace(
            is_alive=lambda: True, pid=4242, exitcode=None,
            kill=lambda: killed.append("gen_s0"), join=lambda timeout=None: None)
        sup.queue.put("s0", 0, _arrays())
        sup._observe_items()
        assert killed == []
        sup.queue.put("s0", 1, _arrays(1))
        sup._observe_items()
        assert killed == ["gen_s0"]

    def test_an_item_claimed_within_a_poll_is_still_observed(self, tmp_path):
        res.install_plan(FaultPlan.parse("kill@actor=1"))
        sup = self._sup(tmp_path)
        killed = []
        sup._members["gen_s0"].proc = types.SimpleNamespace(
            is_alive=lambda: True, pid=4242, exitcode=None,
            kill=lambda: killed.append("gen_s0"), join=lambda timeout=None: None)
        sup.queue.put("s0", 0, _arrays())
        sup.queue.claim("cons0")                 # claimed before the supervisor polled
        sup._observe_items()
        assert killed == ["gen_s0"]


# ------------------------------------------------------------ the items
@pytest.mark.parametrize("coord", [(0, 0, 0), (7, 1, 3), (123, 4, 99)])
def test_fixture_items_are_jax_s_bitwise(coord):
    mine = actors._fixture_panel(*coord, rows=40, feats=6)
    theirs = jactors._fixture_panel(*coord, rows=40, feats=6)
    assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()


def _lane_draws(keys, f: int, m: int, epochs: int, n_train: int):
    """JAX's draws of each lane key: Keras-default init and the epochs'
    permutations (as ``tests/test_torch_replication.py`` derives them)."""
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=f, latent_dim=m).init(init_key, jnp.zeros((1, f)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    return ({"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)},
            torch.from_numpy(np.stack(perms)))


ITEM_CFG = dict(n_factors=6, latent_dim=4, epochs=12, chunk_epochs=5, batch_size=16,
                patience=2, lr=0.02, seed=0)


def test_sweep_item_arrays_matches_jax_on_its_draws():
    """One queue item's sweep: the port on JAX's init and permutations
    against JAX's ``sweep_item_arrays``: same keys and dtypes, params
    atol 1e-5 + rtol 1e-4, losses rtol 1e-4, stop epochs equal."""
    panel = actors._fixture_panel(0, 1, 2, rows=64, feats=6)
    latents = [1, 2, 4]
    key = jax.random.PRNGKey(17)
    want = jengine.sweep_item_arrays(key, panel, JaxAEConfig(**ITEM_CFG), latents)
    init, perms = _lane_draws(jax.random.split(key, len(latents)), 6, 4, ITEM_CFG["epochs"],
                              int(64 * 0.75))
    got = engine.sweep_item_arrays(0, panel, AEConfig(**ITEM_CFG), latents, init_params=init,
                                   perm_source=lambda pos, n: perms[..., pos:pos + n, :],
                                   device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["stop_epoch"], want["stop_epoch"])
    assert int(got["chunks_dispatched"]) == int(want["chunks_dispatched"])
    for k in ("param_decoder_kernel", "param_encoder_kernel"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_sweep_item_arrays_is_pure():
    panel = actors._fixture_panel(0, 0, 0, rows=48, feats=6)
    a = engine.sweep_item_arrays(5, panel, AEConfig(**ITEM_CFG), [1, 3], device="cpu")
    b = engine.sweep_item_arrays(5, panel, AEConfig(**ITEM_CFG), [1, 3], device="cpu")
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


# ------------------------------------------------------- pipeline state
def _tiny_plan(out_dir, **kw):
    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=6, batch_size=16, patience=2, seed=0,
                   chunk_epochs=3)
    defaults = dict(
        out_dir=str(out_dir),
        sources=[SourceSpec(name=f"f{i}", mode="fixture", params={"rows": 32, "feats": 4})
                 for i in range(2)],
        blocks=2, consumers=2, capacity=2, ae_cfg=cfg, latent_dims=[1, 2],
        consume_mode="direct", stream_seed=7, device="cpu", drain_timeout=30.0,
        timeout=240.0)
    defaults.update(kw)
    return PipelinePlan(**defaults)


class TestPipelineState:
    def test_fresh_run_refuses_leftover_results_and_dirty_work(self, tmp_path):
        plan = _tiny_plan(tmp_path / "p")
        (Path(plan.out_dir) / "results" / result_name("f0", 0)).mkdir(parents=True)
        with pytest.raises(PipelineStateError, match="previous pipeline"):
            run_pipeline(plan)
        plan = _tiny_plan(tmp_path / "q")
        (Path(plan.out_dir) / "_work").mkdir(parents=True)
        with pytest.raises(PipelineStateError, match="resume"):
            run_pipeline(plan)

    def test_plan_marker_refuses_foreign_plan(self, tmp_path):
        plan_a = _tiny_plan(tmp_path / "p")
        paths = pl._paths(plan_a)
        paths["results"].mkdir(parents=True)
        pl._check_plan_marker(plan_a, paths)
        pl._check_plan_marker(plan_a, paths)
        with pytest.raises(PipelineStateError, match="DIFFERENT"):
            pl._check_plan_marker(_tiny_plan(tmp_path / "p", stream_seed=99), paths)

    def test_resume_heals_corrupt_result_and_replays_block(self, tmp_path):
        plan = _tiny_plan(tmp_path / "p")
        paths = pl._paths(plan)
        for key in ("queue", "snapshots", "results"):
            paths[key].mkdir(parents=True)
        def writer(tmp):
            (tmp / "sweep.npz").write_bytes(b"x" * 64)

        for seq in range(plan.blocks):
            ckpt.write_atomic(paths["results"] / result_name("f0", seq), writer,
                              metadata={"source": "f0", "seq": seq})
        faults.corrupt_file(paths["results"] / result_name("f0", 1) / "sweep.npz")
        snap = ProgressSnapshot(paths["snapshots"], fingerprint={}, name="gen_f0")
        snap.save({"next": plan.blocks, "eof": True})
        queue = SpoolQueue(paths["queue"], capacity=2)
        queue.put_eof("f0", plan.blocks)
        assert pl._heal_corrupt_results(plan, paths, queue) == [result_name("f0", 1)]
        assert (paths["results"] / result_name("f0", 0)).exists()
        assert snap.load() is None and queue.eof_counts() == {}

    def test_members_asked_for_a_missing_card_raise(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: cuda rightly runs there")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_pipeline(_tiny_plan(tmp_path / "p", device="cuda"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            actors.actor_main("gen_f0", "generator", {"device": "cuda"})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_pipeline(_tiny_plan(tmp_path / "q", device=None))


# ------------------------------------------------- the pipeline, spawned
def test_pipeline_undisturbed_killed_and_drained_assemble_the_same_bytes(tmp_path, capsys):
    """Two fixture sources, two consumers: the undisturbed run through the
    CLI, a run whose first observed item's producer is SIGKILLed, and a
    run drained at the first observed item then resumed give one
    ``pipeline.json``, byte for byte; the actors' streams carry their
    launch counters (none on the CPU) and the queue's depth."""
    from hfrep_tpu_torch.experiments.cli import main

    base = ["pipeline", "--device", "cpu", "--fixture-sources", "2", "--fixture-rows", "32",
            "--fixture-feats", "4", "--blocks", "2", "--consumers", "2", "--latents", "1:2",
            "--epochs", "6", "--chunk-epochs", "3", "--stream-seed", "7",
            "--queue-capacity", "2"]
    a = tmp_path / "a"
    assert main(base + ["--out", str(a), "--obs-dir", str(tmp_path / "obs")]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[:out.index("\nassembled: ")])["restarts"] == 0
    want = (a / "pipeline.json").read_bytes()
    doc = json.loads(want)
    assert sorted(doc["sources"]) == ["f0", "f1"] and doc["consume_mode"] == "direct"
    assert all(len(s["items"]) == 2 for s in doc["sources"].values())
    records = [json.loads(line) for line in
               (tmp_path / "obs" / "events.jsonl").read_text().splitlines()]
    assert any(r.get("name") == "orchestrate/queue_depth" for r in records)
    assert {r["name"] for r in records if r["type"] == "event"} >= {
        "actor_start", "actor_exit", "pipeline_complete", "drive_exit"}
    assert sorted(p.name for p in (tmp_path / "obs" / "actors").iterdir()) == [
        "cons0", "cons1", "gen_f0", "gen_f1"]
    item = np.load(a / "results" / result_name("f1", 1) / "sweep.npz")
    cfg = AEConfig(n_factors=4, latent_dim=4, epochs=6, chunk_epochs=3)   # the verb's
    from hfrep_tpu_torch.train.trainer import seed_mix
    direct = engine.sweep_item_arrays(seed_mix(cfg.seed, 1, 1),
                                      actors._fixture_panel(7, 1, 1, rows=32, feats=4), cfg,
                                      [1, 2], device="cpu")
    assert all(item[k].tobytes() == direct[k].tobytes() for k in direct)

    # a SIGKILLed producer restarts and rejoins mid-block; its items take
    # 0.5 s (the bytes do not change), so it is alive when its first lands
    plan = _tiny_plan(tmp_path / "b", ae_cfg=cfg, sources=[
        SourceSpec(name=f"f{i}", mode="fixture",
                   params={"rows": 32, "feats": 4, "gen_delay": 0.5}) for i in range(2)])
    res.install_plan(FaultPlan.parse("kill@actor=1"))
    killed = run_pipeline(plan)
    res.clear_plan()
    assert killed["stats"]["restarts"] >= 1
    assert (tmp_path / "b" / "pipeline.json").read_bytes() == want

    # a pod drain at the first observed item, then the resume
    plan = _tiny_plan(tmp_path / "c", ae_cfg=cfg)
    res.install_plan(FaultPlan.parse("preempt@actor=1"))
    with pytest.raises(Preempted, match="drain_barrier"):
        run_pipeline(plan)
    res.clear_plan()
    assert not (tmp_path / "c" / "pipeline.json").exists()
    with pytest.raises(PipelineStateError):
        run_pipeline(plan)                               # dirty without resume
    run_pipeline(plan, resume=True)
    assert (tmp_path / "c" / "pipeline.json").read_bytes() == want
    assert not (tmp_path / "c" / "_work").exists()
