"""Crash forensics: the flight recorder's black box
(``hfrep_tpu/obs/crash.py``).

When a run dies — a :class:`~hfrep_tpu_torch.resilience.Preempted`
drain, a typed ``WorkerFault`` / :class:`~hfrep_tpu_torch.obs.health.
NumericFault`, or any exception escaping :func:`hfrep_tpu_torch.obs.
session` — :func:`write_crash_bundle` writes, atomically, what the
system was doing:

``<run_dir>/crash_<run_id>/``
    ``crash.json``        exception type and message, its typed fields
                          (site, epoch, snapshot, dump...), unix time,
                          pid, argv
    ``traceback.txt``     the full traceback (when one is live)
    ``events_tail.jsonl`` the last :data:`TAIL_EVENTS` lines of every
                          ``events*.jsonl`` of the run dir (rotated
                          streams included)
    ``env.json``          the process environment, secret-shaped values
                          redacted
    ``run.json``          a copy of the run manifest

The file set and ``meta.json`` are the JAX package's, so either package's
:func:`verify_bundle` and checkpoint ``verify`` read the other's bundle.
Published through :func:`hfrep_tpu_torch.utils.checkpoint.write_atomic`
(checksummed meta, one rename; a second crash in the same run dir keeps
the previous bundle as the ``.prev`` sibling), with a stdlib tmp-dir and
``os.replace`` fallback, and strictly best-effort: forensics must never
mask the failure they describe.  ``python -m hfrep_tpu_torch.obs report
--crash <run_dir>`` reads it back; ``crash-drill`` proves the loop under
injected ``io_fail`` and nonfinite faults.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import traceback
from pathlib import Path
from typing import List, Optional

CRASH_PREFIX = "crash_"
TAIL_EVENTS = 200

#: env keys whose VALUES are redacted in the bundle (the keys survive:
#: knowing a credential was set is diagnostic, its value is not)
_SECRET_RE = re.compile(r"(key|token|secret|passw|credential|auth)", re.IGNORECASE)


def _redacted_env() -> dict:
    return {k: ("<redacted>" if _SECRET_RE.search(k) else v)
            for k, v in sorted(os.environ.items())}


def _tail_lines(path: Path, n: int) -> List[str]:
    try:
        with open(path, errors="replace") as fh:
            return fh.readlines()[-n:]
    except OSError:
        return []


def _exc_doc(exc: BaseException) -> dict:
    doc = {"type": type(exc).__name__, "message": str(exc)}
    # typed exceptions (Preempted, NumericFault, WorkerFault...) carry
    # their context as attributes: dump the JSON-safe ones
    for k, v in sorted(getattr(exc, "__dict__", {}).items()):
        if isinstance(v, (str, int, float, bool)) or v is None:
            doc[k] = v
    return doc


def write_crash_bundle(obs, exc: BaseException,
                       tail_events: int = TAIL_EVENTS) -> Optional[str]:
    """Bundle the run's last moments next to its telemetry; returns the
    bundle path (None when nothing could be written).  Never raises."""
    try:
        run_dir = Path(obs.run_dir)
        try:
            obs.event("crash_bundle", exception=type(exc).__name__)
            obs.flush()
        except Exception:
            pass
        run_id = run_dir.name
        bundle = run_dir / f"{CRASH_PREFIX}{run_id}"

        from hfrep_tpu_torch.obs.report import is_stream_file
        streams = sorted(f for f in run_dir.glob("events*.jsonl") if is_stream_file(f))
        tails: List[str] = []
        for stream in streams:
            if len(streams) > 1:
                tails.append(f"# stream: {stream.name}\n")
            tails.extend(_tail_lines(stream, tail_events))
        crash_doc = json.dumps(
            {"v": 1, **_exc_doc(exc), "time_unix": round(time.time(), 3),
             "pid": os.getpid(), "argv": list(sys.argv), "run_id": run_id},
            indent=2, default=str)
        tb = ("".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
              or f"{type(exc).__name__}: {exc}\n")
        env_doc = json.dumps(_redacted_env(), indent=2, default=str)
        try:
            manifest = (run_dir / "run.json").read_text()
        except OSError:
            manifest = "{}"

        def writer(tmp: Path) -> None:
            (tmp / "crash.json").write_text(crash_doc)
            (tmp / "traceback.txt").write_text(tb)
            (tmp / "events_tail.jsonl").write_text("".join(tails))
            (tmp / "env.json").write_text(env_doc)
            (tmp / "run.json").write_text(manifest)

        path = _publish(bundle, writer, exc)
        if path is not None:
            print(f"crash bundle: {path} "
                  f"(python -m hfrep_tpu_torch.obs report --crash {run_dir})",
                  file=sys.stderr)
        return path
    except Exception:
        return None


def _publish(bundle: Path, writer, exc: BaseException) -> Optional[str]:
    """Atomic publication: the checkpoint writer when importable, else a
    stdlib tmp-dir and one ``os.replace``."""
    try:
        from hfrep_tpu_torch.utils import checkpoint as ckpt
    except Exception:
        ckpt = None
    if ckpt is not None:
        ckpt.write_atomic(bundle, writer,
                          metadata={"kind": "crash_bundle", "exception": type(exc).__name__},
                          keep_prev=True)
        return str(bundle)
    import shutil
    tmp = bundle.with_name(f".{bundle.name}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    writer(tmp)
    shutil.rmtree(bundle, ignore_errors=True)
    os.replace(tmp, bundle)
    return str(bundle)


def bundle_if_enabled(exc: BaseException) -> Optional[str]:
    """The drives' exit-75/74 hook: land a crash bundle for a drain or a
    persistent storage failure the handler is about to turn into an exit
    code, when telemetry is on (an escaped exception is bundled by the
    session itself; this covers drains that end the run without
    escaping)."""
    try:
        from hfrep_tpu_torch.obs import get_obs
        obs = get_obs()
        if obs.enabled:
            return write_crash_bundle(obs, exc)
    except Exception:
        pass
    return None


# ---------------------------------------------------------------- reading
def find_bundle(path) -> Optional[Path]:
    """``path`` is a bundle dir, or a run dir holding one (newest wins)."""
    p = Path(path)
    if (p / "crash.json").exists():
        return p
    candidates = sorted((d for d in p.glob(f"{CRASH_PREFIX}*") if (d / "crash.json").exists()),
                        key=lambda d: d.stat().st_mtime)
    return candidates[-1] if candidates else None


def render_bundle(bundle: Path, tb_lines: int = 25, tail_lines: int = 5) -> str:
    """Human rendering for ``report --crash``: the exception, its typed
    context, the traceback tail and the last few events."""
    try:
        doc = json.loads((bundle / "crash.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable crash bundle {bundle}: {e}"
    when = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(doc.get("time_unix") or 0))
    lines = [f"crash bundle {bundle}",
             f"  run {doc.get('run_id')}  pid {doc.get('pid')}  {when}",
             f"  {doc.get('type')}: {doc.get('message')}"]
    extras = {k: v for k, v in doc.items()
              if k not in ("v", "type", "message", "time_unix", "pid", "argv", "run_id")
              and v is not None}
    if extras:
        lines.append("  context: " + ", ".join(f"{k}={v}" for k, v in sorted(extras.items())))
    tb = _tail_lines(bundle / "traceback.txt", tb_lines)
    if tb:
        lines.append("  traceback (tail):")
        lines.extend("    " + ln.rstrip("\n") for ln in tb)
    tail = [ln for ln in _tail_lines(bundle / "events_tail.jsonl", tail_lines)
            if not ln.startswith("#")]
    if tail:
        lines.append(f"  last events ({len(tail)} of the bundled tail):")
        lines.extend("    " + ln.rstrip("\n") for ln in tail)
    return "\n".join(lines)


REQUIRED_FILES = ("crash.json", "traceback.txt", "events_tail.jsonl", "env.json", "run.json")


def verify_bundle(bundle: Path) -> List[str]:
    """Missing-piece list (empty = complete): the drill's assertion."""
    return [f for f in REQUIRED_FILES if not (Path(bundle) / f).exists()]


# ------------------------------------------------------------------ drill
def drill(device: str = "cuda") -> int:
    """``python -m hfrep_tpu_torch.obs crash-drill``: a real obs session
    drives a real (tiny) chunked AE training on NaN data on ``device``
    with the health tripwire armed and ``io_fail@obs_append`` faults in
    the event stream; the :class:`~hfrep_tpu_torch.obs.health.
    NumericFault` must land a complete, checksum-verifying crash bundle
    and the forensic dump, and ``report --crash`` must render it.  One
    JSON line on stdout; exit 0 = every assertion held."""
    import tempfile

    import hfrep_tpu_torch.obs as obs_pkg
    from hfrep_tpu_torch import resilience as res
    from hfrep_tpu_torch.obs import health as health_mod

    problems: List[str] = []
    doc: dict = {"metric": "crash_drill", "device": str(device)}
    health_mod.configure(health_mod.HealthConfig(abort_on_nonfinite=True))
    with tempfile.TemporaryDirectory(prefix="hfrep_crash_drill_") as td:
        run_dir = Path(td) / "run"
        # the append-stream fault hook resolves at sink construction, so
        # the plan must be live before the session opens: two injected
        # EIOs land mid-stream and the bundle must still publish whole
        res.install_plan(res.FaultPlan.parse("io_fail@obs_append=2x2"))
        caught: Optional[BaseException] = None
        try:
            try:
                with obs_pkg.session(run_dir, command="crash-drill"):
                    import numpy as np

                    from hfrep_tpu_torch.config import AEConfig
                    from hfrep_tpu_torch.replication.engine import train_autoencoder_chunked

                    xs = np.full((40, 4), np.nan, np.float32)
                    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16,
                                   patience=2, chunk_epochs=2)
                    train_autoencoder_chunked(0, xs, cfg, device=device)
            except health_mod.NumericFault as e:
                caught = e
        finally:
            res.clear_plan()
            health_mod.configure(None)

        if caught is None:
            problems.append("NumericFault never fired on NaN data")
        elif not caught.dump or not Path(caught.dump).exists():
            problems.append(f"forensic dump missing: {caught.dump!r}")
        bundle = find_bundle(run_dir)
        if bundle is None:
            problems.append("no crash bundle under the run dir")
        else:
            missing = verify_bundle(bundle)
            if missing:
                problems.append(f"bundle incomplete: missing {missing}")
            try:
                from hfrep_tpu_torch.utils import checkpoint as ckpt
                ckpt.verify(bundle)
            except Exception as e:
                problems.append(f"bundle failed verification: {e}")
            try:
                crash_doc = json.loads((bundle / "crash.json").read_text())
                if crash_doc.get("type") != "NumericFault":
                    problems.append(f"bundle recorded {crash_doc.get('type')!r}, "
                                    "expected NumericFault")
                doc["bundled_exception"] = crash_doc.get("type")
            except (OSError, json.JSONDecodeError) as e:
                problems.append(f"unreadable crash.json: {e}")
            if (bundle / "events_tail.jsonl").exists() and not (
                    bundle / "events_tail.jsonl").read_text().strip():
                problems.append("bundled event tail is empty")
            rendered = render_bundle(bundle)
            if "NumericFault" not in rendered:
                problems.append("report --crash rendering lacks the fault")
            doc["rendered_lines"] = rendered.count("\n") + 1

    doc["self_check"] = "ok" if not problems else "; ".join(problems)
    print(json.dumps(doc))
    if problems:
        print(f"crash-drill FAILED: {'; '.join(problems)}", file=sys.stderr)
        return 1
    return 0
