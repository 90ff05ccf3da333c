"""Run manifests: ``<run_dir>/run.json`` (``hfrep_tpu/obs/manifest.py``).

One JSON document per run answering "what exactly produced these
events?" — git SHA (+dirty flag), torch/numpy/CUDA versions, host and
device inventory (:func:`hfrep_tpu_torch.obs.device.device_facts`), and
(merged in later by the trainer via ``Obs.annotate``) the experiment
config.  The layout and :data:`REQUIRED_KEYS` are the JAX package's, so
its report reads a port run dir.
"""

from __future__ import annotations

import dataclasses
import getpass
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

MANIFEST_NAME = "run.json"

#: manifest schema: v2 adds the optional ``traces`` list (profiler
#: capture links appended by :func:`add_trace_link` /
#: :func:`hfrep_tpu_torch.obs.trace_capture`).
SCHEMA_VERSION = 2

#: keys :func:`write_manifest` always emits (the completeness test and
#: the report's self-test check against this list)
REQUIRED_KEYS = ("schema_version", "run_id", "created_unix", "created",
                 "git", "versions", "host", "devices", "argv")


def _git_info(cwd: Optional[str] = None) -> dict:
    def run(*args):
        try:
            out = subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                                 text=True, timeout=10)
            return out.stdout.strip() if out.returncode == 0 else None
        except (OSError, subprocess.TimeoutExpired):
            return None

    sha = run("rev-parse", "HEAD")
    status = run("status", "--porcelain")
    return {"sha": sha,
            "dirty": bool(status) if status is not None else None,
            "branch": run("rev-parse", "--abbrev-ref", "HEAD")}


def _versions() -> dict:
    v = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        try:
            v[mod] = __import__(mod).__version__
        except Exception:
            v[mod] = None
    try:
        import torch
        v["cuda"] = torch.version.cuda
    except Exception:
        v["cuda"] = None
    return v


def _devices() -> dict:
    from hfrep_tpu_torch.obs.device import device_facts
    return device_facts()


def _host() -> dict:
    try:
        user = getpass.getuser()
    except Exception:
        user = None
    return {"hostname": platform.node(), "platform": platform.platform(),
            "user": user, "pid": os.getpid(),
            "cwd": os.getcwd()}


def config_dict(cfg) -> dict:
    """An ``ExperimentConfig`` (or any dataclass / mapping) as plain data."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return dataclasses.asdict(cfg)
    if isinstance(cfg, dict):
        return cfg
    return {"repr": repr(cfg)}


def write_manifest(run_dir, extra: Optional[dict] = None,
                   repo_root: Optional[str] = None) -> Path:
    """Write ``run.json``; returns its path.  ``extra`` merges at top
    level (used by :func:`hfrep_tpu_torch.obs.enable` for caller context)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    now = time.time()
    doc = {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_dir.name,
        "created_unix": now,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(now)),
        "git": _git_info(repo_root or os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))),
        "versions": _versions(),
        "host": _host(),
        "devices": _devices(),
        "argv": list(sys.argv),
    }
    if extra:
        doc.update(extra)
    path = run_dir / MANIFEST_NAME
    _write_with_retry(path, json.dumps(doc, indent=2, default=str) + "\n")
    return path


def _write_with_retry(path: Path, text: str) -> None:
    """Manifest writes go through the bounded I/O retry policy: a
    flaky-storage blip must not take down ``enable()`` — nor go
    unrecorded (each retry is an ``io_retry`` event + counter).  The
    ``manifest`` fault-injection site lives inside the retried call."""
    from hfrep_tpu_torch import resilience

    def _write():
        resilience.io_point("manifest")
        path.write_text(text)

    resilience.retry_io(_write, what="manifest")


def _update_manifest(run_dir, mutate) -> None:
    """Best-effort read-mutate-write of ``run.json`` (an empty doc when
    absent or corrupt, write failures swallowed): the one durability
    policy every post-hoc manifest writer shares — telemetry must never
    fail the run it describes."""
    path = Path(run_dir) / MANIFEST_NAME
    try:
        doc = json.loads(path.read_text()) if path.exists() else {}
    except (OSError, json.JSONDecodeError):
        doc = {}
    mutate(doc)
    try:
        _write_with_retry(path, json.dumps(doc, indent=2, default=str) + "\n")
    except OSError:
        pass


def annotate(run_dir, fields: dict) -> None:
    """Merge fields into an existing ``run.json`` (write one if absent —
    annotation must not be order-coupled to :func:`write_manifest`)."""
    _update_manifest(run_dir, lambda doc: doc.update(fields))


def add_trace_link(run_dir, trace_dir, **extra) -> None:
    """Append one profiler capture link to the manifest's ``traces`` list
    (schema v2) — best-effort like :func:`annotate`: linkage must never
    fail the profiled run."""
    _update_manifest(
        run_dir,
        lambda doc: doc.setdefault("traces", []).append(
            {"path": str(trace_dir), **extra}))
