"""The orchestrated pipeline: GAN synthesis streaming into AE sweeps
(``hfrep_tpu/orchestrate/pipeline.py``).

Sequentially, the paper's flow is *generate every synthetic panel, then
sweep every dataset* — two phases whose hardware profiles (sampling a
generator vs training 21 AE lanes) serialize for no reason.  Here the
phases run as decoupled actor pools over the spool queue: generator
members stream ``(source, seq)`` panels in while consumer members pull
and sweep them, so phase 2 starts seconds into phase 1 and a lost
member costs one item, not the pipeline (the highly-parallel-GAN
producer/consumer split of arxiv 2111.04628 + the Podracer supervision
of arxiv 2104.06272).

Determinism contract — the whole point of the plumbing: every item is a
pure function of ``(stream_seed, source, seq)``, every result a pure
function of its item, every artifact atomically published and keyed by
``(source, seq)``.  Therefore ANY interleaving of members, restarts,
kills and resumes assembles the same bytes: the undisturbed, the killed
and the drained-and-resumed runs give one ``pipeline.json`` (the tests
and ``chip_smoke.py`` hold them byte-equal).

On ``cuda`` the parent builds every hand kernel (``_build.build_all``)
before it spawns a member, so members that start together never race a
cold ``nvcc`` against the supervisor's timeouts.

Layout under ``plan.out_dir``::

    _work/queue/        the spool (ready/, claimed/, eof markers)
    _work/snapshots/    generator sub-block ProgressSnapshots
    results/r_<source>_<seq>/   per-item artifacts (atomic dirs)
    pipeline.json       the assembled summary (sources, digests, stats)

Resume: run the same plan with ``resume=True`` — orphaned claims are
requeued, producers fast-forward via their snapshots, consumers skip
published results.  Without ``resume`` a dirty ``_work/`` refuses to
run (mixing two pipelines' state would be silent corruption).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core.device import resolve_device
from hfrep_tpu_torch.obs import get_obs
from hfrep_tpu_torch.orchestrate.actors import RESULT_PREFIX, result_name
from hfrep_tpu_torch.orchestrate.queue import SpoolQueue
from hfrep_tpu_torch.orchestrate.supervisor import ActorSpec, Supervisor
from hfrep_tpu_torch.resilience.snapshot import ProgressSnapshot
from hfrep_tpu_torch.utils import checkpoint as ckpt

WORK_DIR = "_work"
PLAN_MARKER = "plan.json"        # under results/: which plan produced them


class PipelineStateError(RuntimeError):
    """Dirty state without ``resume=True``, or state belonging to a
    different plan — refuse rather than guess (mixing two pipelines'
    artifacts would be silent corruption)."""


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One generator member's stream: ``mode`` "fixture" (deterministic
    synthetic panels — tests and drills), "gan" (sample a trained
    checkpoint) or "scenario" (one regime's conditional bank blocks —
    the scenario factory fanning a bank out across the actor pool);
    ``params`` feeds the worker's ``_make_generator``."""

    name: str
    mode: str = "fixture"
    params: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Everything :func:`run_pipeline` needs, picklable end to end."""

    out_dir: str
    sources: Sequence[SourceSpec]
    blocks: int                      # items per source
    consumers: int = 1
    capacity: int = 4                # spool bound (backpressure)
    ae_cfg: AEConfig = AEConfig()
    latent_dims: Sequence[int] = tuple(range(1, 22))
    consume_mode: str = "direct"     # "direct" | "augment"
    cleaned_dir: Optional[str] = None
    stream_seed: int = 0
    device: Optional[str] = None     # the members' device; None = the card
    drain_timeout: float = 30.0
    max_restarts: int = 3
    timeout: Optional[float] = 600.0


def _actor_specs(plan: PipelinePlan, paths: dict, device: str,
                 obs_root: Optional[Path]) -> List[ActorSpec]:
    common = {"queue_dir": str(paths["queue"]), "capacity": plan.capacity,
              "device": device, "stream_seed": plan.stream_seed}
    specs: List[ActorSpec] = []
    for idx, src in enumerate(plan.sources):
        payload = dict(common)
        payload.update(src.params or {})
        payload.update({"mode": src.mode, "source": src.name,
                        "source_idx": idx, "blocks": plan.blocks,
                        "snapshot_dir": str(paths["snapshots"]),
                        "cleaned_dir": plan.cleaned_dir})
        if obs_root is not None:
            payload["obs_dir"] = str(obs_root / f"gen_{src.name}")
        specs.append(ActorSpec(name=f"gen_{src.name}", role="generator",
                               payload=payload,
                               max_restarts=plan.max_restarts))
    for c in range(plan.consumers):
        payload = dict(common)
        payload.update({"results_dir": str(paths["results"]),
                        "sources": [s.name for s in plan.sources],
                        "ae_cfg": plan.ae_cfg,
                        "latent_dims": list(plan.latent_dims),
                        "consume_mode": plan.consume_mode,
                        "cleaned_dir": plan.cleaned_dir})
        if obs_root is not None:
            payload["obs_dir"] = str(obs_root / f"cons{c}")
        specs.append(ActorSpec(name=f"cons{c}", role="consumer",
                               payload=payload,
                               max_restarts=plan.max_restarts))
    return specs


def _paths(plan: PipelinePlan) -> dict:
    out = Path(plan.out_dir)
    work = out / WORK_DIR
    return {"out": out, "work": work, "queue": work / "queue",
            "snapshots": work / "snapshots", "results": out / "results"}


def _plan_fingerprint(plan: PipelinePlan) -> dict:
    """Everything that determines the artifact BYTES (member counts and
    timeouts deliberately excluded — they change scheduling, not
    results), JSON-normalized for stable comparison."""
    doc = {"sources": [[s.name, s.mode, s.params or {}]
                       for s in plan.sources],
           "blocks": plan.blocks,
           "ae_cfg": list(dataclasses.astuple(plan.ae_cfg)),
           "latent_dims": list(plan.latent_dims),
           "consume_mode": plan.consume_mode,
           "cleaned_dir": plan.cleaned_dir,
           "stream_seed": plan.stream_seed}
    return json.loads(json.dumps(doc, default=str))


def _result_dirs(paths: dict) -> list:
    res = paths["results"]
    if not res.exists():
        return []
    return sorted(p for p in res.iterdir()
                  if p.is_dir() and p.name.startswith(RESULT_PREFIX))


def _check_plan_marker(plan: PipelinePlan, paths: dict) -> None:
    """Write-or-verify ``results/plan.json``: existing artifacts may only
    be reused (consumers skip published ``(source, seq)`` results by
    name) when they came from THIS plan — a different stream seed or AE
    config silently assembling the previous run's bytes is exactly the
    corruption the resume path must refuse."""
    marker = paths["results"] / PLAN_MARKER
    fp = _plan_fingerprint(plan)
    if marker.exists():
        try:
            have = json.loads(marker.read_text())
        except (OSError, json.JSONDecodeError):
            have = None
        if have != fp:
            raise PipelineStateError(
                f"{paths['results']} holds artifacts from a DIFFERENT "
                "pipeline plan (stream seed / sources / AE config "
                "differ) — remove the out dir or use a fresh one")
        return
    tmp = marker.with_name(marker.name + f".tmp-{os.getpid()}")
    tmp.write_text(json.dumps(fp, indent=2, sort_keys=True))
    os.replace(tmp, marker)


def _heal_corrupt_results(plan: PipelinePlan, paths: dict,
                          queue: SpoolQueue) -> List[str]:
    """Resume-time self-repair: a published result that no longer
    verifies (torn write that survived a crash, bit rot) is deleted and
    its source's block replayed — eof marker and sub-block snapshot
    cleared, so the producer re-delivers every item of the block;
    consumers skip the intact results idempotently and recompute only
    the damaged ones.  Without this a rotted artifact would wedge the
    pipeline permanently (consumers skip by existence, ``assemble``
    raises forever)."""
    healed: List[str] = []
    for src in plan.sources:
        replay = False
        for seq in range(plan.blocks):
            res = paths["results"] / result_name(src.name, seq)
            if not res.exists():
                continue
            try:
                ckpt.verify(res)
            except ckpt.CheckpointCorrupt:
                shutil.rmtree(res, ignore_errors=True)
                healed.append(res.name)
                replay = True
        if replay:
            ProgressSnapshot(paths["snapshots"], fingerprint={},
                             name=f"gen_{src.name}").clear()
            queue.clear_eof(src.name)
    if healed:
        get_obs().event("result_healed", items=healed)
    return healed


def assemble(plan: PipelinePlan) -> Dict[str, dict]:
    """Verify completeness + integrity of every per-item result and write
    the deterministic ``pipeline.json`` summary (per-item content
    digests, sorted keys — byte-stable across any member interleaving).
    Raises on gaps or corrupt artifacts: an incomplete pipeline must
    never assemble silently."""
    paths = _paths(plan)
    doc: Dict[str, dict] = {}
    for src in plan.sources:
        items = {}
        for seq in range(plan.blocks):
            res = paths["results"] / result_name(src.name, seq)
            meta = ckpt.verify(res)      # raises CheckpointCorrupt on rot
            if meta is None:
                raise PipelineStateError(
                    f"missing result {res.name} — the stream has a gap")
            items[f"{seq:05d}"] = meta["checksum"]["digest"]
        doc[src.name] = {"mode": src.mode, "blocks": plan.blocks,
                         "items": items}
    summary = {"sources": doc, "consume_mode": plan.consume_mode,
               "latent_dims": list(plan.latent_dims)}
    (paths["out"] / "pipeline.json").write_text(
        json.dumps(summary, indent=2, sort_keys=True))
    return summary


def run_pipeline(plan: PipelinePlan, resume: bool = False) -> dict:
    """Drive the fabric end to end; returns ``{"summary", "stats"}``.

    Raises :class:`~hfrep_tpu_torch.resilience.Preempted` on a pod drain
    (the CLI maps it to exit 75; re-run with ``resume=True`` to continue)
    and :class:`~hfrep_tpu_torch.orchestrate.supervisor.OrchestrationError`
    when the fabric cannot make progress.
    """
    device = str(resolve_device(plan.device))
    paths = _paths(plan)
    if not resume and (paths["work"].exists() or _result_dirs(paths)):
        raise PipelineStateError(
            f"{plan.out_dir} holds previous pipeline state (_work/ or "
            "published results) — resume=True to continue it, or remove "
            "the out dir for a fresh start")
    for key in ("queue", "snapshots", "results"):
        paths[key].mkdir(parents=True, exist_ok=True)
    _check_plan_marker(plan, paths)

    queue = SpoolQueue(paths["queue"], capacity=plan.capacity)
    if resume:
        # claims orphaned by the killed pod go back on the spool before
        # any member can conclude the stream is complete, and results
        # that no longer verify are deleted with their block scheduled
        # for replay
        queue.requeue_claims(None)
        _heal_corrupt_results(plan, paths, queue)

    if device.startswith("cuda"):
        from hfrep_tpu_torch.ops import _build
        _build.build_all()
    obs = get_obs()
    obs_root = (Path(obs.run_dir) / "actors") if obs.enabled else None
    sup = Supervisor(_actor_specs(plan, paths, device, obs_root), queue,
                     drain_timeout=plan.drain_timeout, timeout=plan.timeout)
    with obs.span("pipeline", sources=len(plan.sources),
                  blocks=plan.blocks, consumers=plan.consumers):
        stats = sup.run()
    summary = assemble(plan)
    # a finished pipeline leaves no live state behind: stale snapshots or
    # eof markers must not fast-forward an unrelated later run
    shutil.rmtree(paths["work"], ignore_errors=True)
    if obs.enabled:
        obs.event("pipeline_complete", restarts=stats["restarts"],
                  secs=stats["secs"])
    return {"summary": summary, "stats": stats}
